#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port (the counterpart of
`bench.py`): collision checks per second through the fused kernel (K1) on
the hard dataset, gated against its float64 tags, on one CUDA card.

    python3 scripts/torch_bench.py

Legs, in bench.py's order and with its protocol (`bench.py:81-233`):
  * hard: hard100k if `data/hard_confs100,000.conf` exists
    (`scripts/torch_make_datasets.py` writes it), else hard10k; one warm-up
    `check_valid_resolved`, the golden gate (mismatches against the row
    tags; -1, with a warning on stderr, for a file whose tags disagree with
    its header), then the best of 5 host-clock runs, transfers included;
  * baseline: the float64 CPU oracle (native, built with make when missing)
    on the first 1,024 rows (200 with the NumPy oracle), cached under
    `build/` keyed on the oracle kind, the dataset, the rows and the sha256
    of the loaded native library: a cache whose key differs is recomputed;
  * latency: one 2,048-row batch, one warm call, 101 timed calls; p50 is
    sorted[50], p99 the nearest rank sorted[99], against a 50 ms budget;
  * clearance: the clearance engine (K3) on bench.py's scene, the refine-4
    alpha robot (133,902 vertices) against the obstacle, 256 queries (seed
    5); one warm call, stats reset, one timed call; the native float64 BVH
    on the same 256 queries (`clearance_vs_native`), where no engine answer
    may exceed the BVH's;
  * easy: easy100k in a fresh process (``--leg easy``), warm-up and best of
    5, only when that file exists; the presort leg below on its rows too;
  * device: K1 alone over the dataset's pose rows in one launch, as
    `check_valid` launches it, and in launches of CHUNK (16,384) rows, the
    launch size before one launch a call, by CUDA events;
  * presort: `check_valid` with presort off and on, best of 5 each; the
    verdicts must be identical (bit 0 on every row and the byte on valid
    rows; a colliding row's bits 1-2 follow the kernel's run-time order).
stdout is one JSON line with bench.py's `result` keys; stderr one JSON line
with its `extra` keys and this script's (`backend: "cuda"`, the card's
`nvidia-smi` name and power limit, the device and presort legs, the
native clearance rate, the library's sha256, the kernels' launches: K1,
the front end's K2 and K5, and K3). A leg
that fails ends the run non-zero. Imports neither JAX nor the JAX package.
"""
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from robocheck_tpu_torch import MegaKernelChecker, load_obj, read_conf_file  # noqa: E402
from robocheck_tpu_torch.io import assets  # noqa: E402
from robocheck_tpu_torch.kernels import front  # noqa: E402
from robocheck_tpu_torch.kernels import megakernel as mk  # noqa: E402
from robocheck_tpu_torch.planner.clearance import (  # noqa: E402
    clearance_queries, native_min_distances)
from robocheck_tpu_torch.runtime import native  # noqa: E402

# A planner step's batch through check_valid_resolved: 50 ms is a 20 Hz
# replanning loop (`bench.py:24-29`).
LATENCY_BUDGET_MS = 50.0
LATENCY_BATCH = 2048
LATENCY_CALLS = 101
RUNS = 5  # timed runs of each throughput leg; the best counts
CHUNK = 16384  # rows per launch of the device leg's chunked side
BASELINE_CACHE = REPO / "build" / "torch_bench_baseline.json"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def golden_mismatches(ds, valid: np.ndarray, name: str) -> int:
    """Mismatches of ``valid`` against the row tags of ``ds``; -1 where the
    tags disagree with the file's header (stale tags: warned on stderr) or
    the file is untagged (`bench.py:99-113`)."""
    if ds.valid is not None and ds.tags_match_header is not False:
        return int((valid != ds.valid).sum())
    if ds.tags_match_header is False:
        print(f"warning: {name} row tags disagree with its header ({ds.num_valid} tagged "
              f"valid vs header {ds.header_valid}); skipping the golden mismatch gate",
              file=sys.stderr)
    return -1


def best_of(fn, runs: int, device: torch.device) -> list[float]:
    """Host-clock seconds of ``runs`` calls of ``fn``, each ended by a sync."""
    times = []
    for _ in range(runs):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return times


def hard_leg(checker, ds, name: str, runs: int = RUNS) -> dict:
    """Warm-up, golden gate and the best of ``runs`` `check_valid_resolved`
    calls on all rows of ``ds``."""
    valid = checker.check_valid_resolved(ds.confs)
    mism = golden_mismatches(ds, valid, name)
    times = best_of(lambda: checker.check_valid_resolved(ds.confs), runs, checker.device)
    n = len(ds.confs)
    return {"dataset": name, "n_confs": n, "times_s": times, "best_time_s": min(times),
            "checks_per_s": n / min(times), "golden_mismatches": mism}


def oracle_so_sha256() -> str | None:
    """sha256 of the native library `oracle.check_configs` loads, or None."""
    path = native.library_path()
    return None if path is None else hashlib.sha256(path.read_bytes()).hexdigest()


def baseline(robot, obstacle, confs: np.ndarray, dataset: str, cache: Path,
             so_sha256: str | None) -> dict:
    """Checks/s of the float64 CPU oracle on the first 1,024 rows (200 with
    the NumPy oracle). Read from ``cache`` only where its key (oracle kind,
    dataset, rows, ``so_sha256``) is this run's; else measured and written
    there."""
    from robocheck_tpu_torch.oracle import check_configs

    kind = "native" if native.available() else "numpy"
    rows = min(1024 if kind == "native" else 200, len(confs))
    key = {"oracle": kind, "dataset": dataset, "rows": rows, "so_sha256": so_sha256}
    rec = {"cpu_oracle_kind": kind, "cpu_oracle_so_sha256": so_sha256, "cpu_oracle_rows": rows}
    if cache.exists():
        stored = json.loads(cache.read_text())
        if stored.get("key") == key:
            return {**rec, "cpu_oracle_baseline_checks_per_s": stored["checks_per_s"],
                    "cpu_oracle_cached": True}
    t0 = time.perf_counter()
    check_configs(robot, obstacle, confs[:rows])
    cps = rows / (time.perf_counter() - t0)
    cache.parent.mkdir(parents=True, exist_ok=True)
    cache.write_text(json.dumps({"key": key, "checks_per_s": cps}))
    return {**rec, "cpu_oracle_baseline_checks_per_s": cps, "cpu_oracle_cached": False}


def percentiles(samples) -> tuple[float, float]:
    """(p50, p99) of the samples: sorted[n // 2] and the nearest rank
    sorted[round(0.99 (n - 1))] (indices 50 and 99 of 101)."""
    s = sorted(samples)
    return s[len(s) // 2], s[int(round(0.99 * (len(s) - 1)))]


def latency_leg(checker, confs: np.ndarray, n: int = LATENCY_BATCH,
                calls: int = LATENCY_CALLS) -> dict:
    """Round-trip ms of one ``n``-row `check_valid_resolved` batch: one warm
    call, then ``calls`` timed ones (`bench.py:154-172`)."""
    batch = confs[:n]
    checker.check_valid_resolved(batch)
    lats = []
    for _ in range(calls):
        t0 = time.perf_counter()
        checker.check_valid_resolved(batch)
        lats.append(time.perf_counter() - t0)
    p50, p99 = percentiles(lats)
    return {"latency_batch": len(batch), "p50_batch_latency_ms": p50 * 1e3,
            "p99_batch_latency_ms": p99 * 1e3, "latency_budget_ms": LATENCY_BUDGET_MS,
            "latency_margin_ms": LATENCY_BUDGET_MS - p50 * 1e3}


def clearance_leg(engine, confs: np.ndarray) -> dict:
    """`min_distances` on ``confs``: one warm call, the engine's stats reset,
    one timed call (`bench.py:191-198`). Also returns the distances."""
    engine.min_distances(confs)
    for key in engine.stats:
        engine.stats[key] = 0 if isinstance(engine.stats[key], int) else 0.0
    _sync(engine.device)
    t0 = time.perf_counter()
    dist = engine.min_distances(confs)
    _sync(engine.device)
    dt = time.perf_counter() - t0
    return {"clearance_configs_per_s": len(confs) / dt,
            "clearance_pairs_run": int(engine.stats["pairs"]), "clearance_s": dt,
            "distances": dist}


def native_clearance_leg(robot_verts, obstacle, confs: np.ndarray,
                         engine_dist: np.ndarray) -> dict:
    """The native float64 BVH on the same queries: its rate, and the number
    of queries where the engine's lower bound exceeds it (must be 0)."""
    t0 = time.perf_counter()
    truth = native_min_distances(robot_verts, obstacle, confs)
    dt = time.perf_counter() - t0
    above = int((engine_dist > truth).sum())
    if above:
        raise RuntimeError(f"the clearance engine exceeds the float64 BVH on {above} queries")
    return {"native_clearance_configs_per_s": len(confs) / dt, "native_clearance_s": dt,
            "clearance_above_native": above}


def device_leg(checker, confs: np.ndarray, reps: int = 20) -> dict:
    """K1 alone over the pose rows of ``confs``, in one launch as
    `check_valid` launches it, and in launches of CHUNK rows
    (``device_chunked_ms``): device ms by CUDA events, mean of ``reps``
    passes. Needs a CUDA device."""
    from robocheck_tpu_torch.profiling.timers import event_ms

    if checker.device.type != "cuda":
        raise RuntimeError("the device leg needs a CUDA device")
    poses = mk.poses_from_confs(torch.from_numpy(confs).to(checker.device))
    n = len(confs)

    def chunked():
        for lo in range(0, n, CHUNK):
            mk.check_poses_cuda(poses[lo : lo + CHUNK], checker.tables)

    ms = event_ms(lambda: mk.check_poses_cuda(poses, checker.tables), reps)
    return {"device_ms": ms, "device_us_per_config": ms * 1e3 / n,
            "device_checks_per_s": n / (ms * 1e-3), "device_chunked_ms": event_ms(chunked, reps)}


def presort_leg(checker, confs: np.ndarray, runs: int = RUNS) -> dict:
    """`check_valid` with presort off and on, best of ``runs`` each after a
    warm call; raises unless the verdicts are identical (bit 0 on every row,
    the byte on valid rows)."""
    plain = checker.check_packed(confs)
    ordered = checker.check_packed(confs, presort=True)
    valid = (plain & 1) == 1
    same = bool(np.array_equal(plain & 1, ordered & 1)
                and np.array_equal(plain[valid], ordered[valid]))
    if not same:
        raise RuntimeError("presort changes a verdict byte")
    t = {}
    for p in (False, True):
        checker.check_valid(confs, presort=p)
        t[p] = min(best_of(lambda p=p: checker.check_valid(confs, presort=p), runs,
                           checker.device))
    return {"check_valid_checks_per_s": len(confs) / t[False],
            "presort_checks_per_s": len(confs) / t[True], "presort_verdicts_identical": same,
            "presort_bytes_identical": bool(np.array_equal(plain, ordered))}


def zero_launches() -> None:
    """Set the launch counters of K1 and of the front end (K2, K5) to 0."""
    mk.check_poses_cuda.launches = 0
    front.poses_from_confs_cuda.launches = 0
    front.robot_bounds_cuda.launches = 0


def launches() -> dict:
    """Launches of K1 and of the front end's K2 and K5 since zero_launches."""
    return {"megakernel": mk.check_poses_cuda.launches,
            "pose_rows": front.poses_from_confs_cuda.launches,
            "robot_bounds": front.robot_bounds_cuda.launches}


def easy_leg() -> None:
    """The easy leg's process (``--leg easy``): easy100k, warm-up, golden
    gate, best of RUNS (`bench.py:32-62`), then the presort leg on the same
    rows; prints one JSON line."""
    from robocheck_tpu_torch.kernels import _build

    eds = read_conf_file(assets.dataset_path("easy100k"))
    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    _build.build()
    checker = MegaKernelChecker(robot, obstacle, device="cuda")
    zero_launches()
    rec = hard_leg(checker, eds, "easy100k")
    pre = presort_leg(checker, eds.confs)
    print(json.dumps({"n": rec["n_confs"], "times_s": rec["times_s"],
                      "mismatches": rec["golden_mismatches"],
                      "presort": {f"easy100k_{k}": v for k, v in pre.items()},
                      "launches": launches()}))


def easy_record() -> dict:
    """Run the easy leg in a fresh process where easy100k exists; its
    record, all None without the file (`bench.py:202-233`). Raises if the
    process fails."""
    keys = ("easy100k_checks_per_s", "easy100k_times_s", "easy100k_mismatches")
    try:
        assets.dataset_path("easy100k")
    except FileNotFoundError:
        return {**dict.fromkeys(keys), "easy100k_launches": {}}
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--leg", "easy"],
                          capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"easy-leg process rc={proc.returncode}: {proc.stderr[-2000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    return dict(zip(keys, (rec["n"] / min(rec["times_s"]), rec["times_s"],
                           rec["mismatches"])), **rec["presort"],
                easy100k_launches=rec["launches"])


def report(rec: dict) -> tuple[dict, dict]:
    """(result, extra) of the merged leg records: bench.py's `result` keys
    (`bench.py:235-243`), and everything else for stderr."""
    extra = dict(rec)
    cps = extra.pop("checks_per_s")
    result = {"metric": f"collision_checks_per_s_{rec['dataset']}", "value": cps,
              "unit": "checks/s/chip",
              "vs_baseline": cps / rec["cpu_oracle_baseline_checks_per_s"]}
    for key in ("p50_batch_latency_ms", "latency_budget_ms", "latency_margin_ms"):
        result[key] = extra.pop(key)
    extra["clearance_vs_native"] = (rec["clearance_configs_per_s"]
                                    / rec["native_clearance_configs_per_s"])
    return result, extra


def main() -> int:
    from robocheck_tpu_torch.kernels import _build
    from robocheck_tpu_torch.kernels import clearance as kc
    from robocheck_tpu_torch.planner.ccd import subdivide_mesh
    from robocheck_tpu_torch.planner.clearance import ClearanceEngine
    from robocheck_tpu_torch.profiling.timers import card_line

    if not torch.cuda.is_available():
        raise SystemExit("torch_bench: no CUDA device")
    card = card_line()
    device = torch.device("cuda", 0)
    make = None if native.available() else native.start_build()
    _build.build()
    if make is not None:
        native.finish_build(make)

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    try:
        name, ds = "hard100k", read_conf_file(assets.dataset_path("hard100k"))
    except FileNotFoundError:
        name, ds = "hard10k", read_conf_file(assets.dataset_path("hard10k"))
    checker = MegaKernelChecker(robot, obstacle, device=device)
    zero_launches()
    kc.pair_min_cuda.launches = 0

    rec = {**hard_leg(checker, ds, name),
           **baseline(robot, obstacle, ds.confs, name, BASELINE_CACHE, oracle_so_sha256()),
           **latency_leg(checker, ds.confs)}
    rob4 = subdivide_mesh(robot, 4)
    engine = ClearanceEngine(rob4.vertices, obstacle, device=device)
    queries = clearance_queries(obstacle)
    clear = clearance_leg(engine, queries)
    rec.update(native_clearance_leg(rob4.vertices, obstacle, queries, clear.pop("distances")),
               **clear)
    rec.update(easy_record())
    rec.update(device_leg(checker, ds.confs), **presort_leg(checker, ds.confs))
    torch.cuda.synchronize()
    easy = rec.pop("easy100k_launches")
    rec.update(backend="cuda", card=card, kernel_launches={
        **{k: n + easy.get(k, 0) for k, n in launches().items()},
        "clearance": kc.pair_min_cuda.launches})
    result, extra = report(rec)
    print(json.dumps(result))
    print(json.dumps(extra), file=sys.stderr)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--leg", "easy"]:
        easy_leg()
    else:
        raise SystemExit(main())
