"""Where the time of the port's main path goes, on one CUDA card.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/torch_profile.py [--dataset hard10k easy10k] [--runs 10]
        [--out build/torch_profile]

The port's counterpart of `scripts/profile_kernel.py` (its `--dataset`,
`--runs` and `--out`). For the alpha-1.0 pair over each dataset named (any
key of `io.assets.DATASET_FILES`; hard100k and easy100k are written by
`scripts/torch_make_datasets.py`) it prints:
  * layers: host time of each step of `MegaKernelChecker.check_valid_resolved`
    (validate, upload, pose: K2's one launch, kernel, fetch, resolve), each
    ended by `torch.cuda.synchronize()`, the kernel (one launch per chunk of
    `STREAM_CHUNK` rows, as `check_packed` launches it) also with CUDA
    events, and the whole call unbroken; beside them `broad`, the pass that
    `check_valid(presort=True)` adds (`mesh_broad`: K5 over every row), by
    host clock and by CUDA events; median, min and max of `--runs` runs
    after a warm-up;
  * trace: `--runs` calls under `torch.profiler`; the device's busy time per
    call (union of its kernel and copy intervals in the trace), the profiled
    call's wall time, and the busy time over the unprofiled median call;
  * batch: the kernel's CUDA-event time on the first dataset's first n rows
    for growing n;
  * chunk: the kernel's CUDA-event time on all of each dataset's rows in one
    launch, and in launches of `STREAM_CHUNK` rows as `check_packed` makes
    them;
  * fma: the kernel built with -fmad=true against the shipped -fmad=false
    build on the same poses: verdict bytes that differ, and the time of each
    (means of `--runs` launches, in the order false, true, true, false).
Every line carries the card's name and power limit. The traces go to
`--out/<set>/trace.json`.
Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from robocheck_tpu_torch import MegaKernelChecker, load_obj, read_conf_file  # noqa: E402
from robocheck_tpu_torch.core.types import validate_confs  # noqa: E402
from robocheck_tpu_torch.io import assets  # noqa: E402
from robocheck_tpu_torch.kernels import _build  # noqa: E402
from robocheck_tpu_torch.kernels import megakernel as mk  # noqa: E402
from robocheck_tpu_torch.oracle import resolve_coplanar  # noqa: E402
from robocheck_tpu_torch.profiling import timers  # noqa: E402
from robocheck_tpu_torch.profiling.timers import card_line, event_ms  # noqa: E402



def host_ms(fn):
    """(host ms of fn() up to a device sync, its result)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def spread(xs) -> str:
    return f"median {statistics.median(xs)} (min {min(xs)}, max {max(xs)})"


def layers(checker, confs, runs: int) -> dict:
    """Host ms of each step of check_valid_resolved, as that method runs them
    (a launch per chunk of STREAM_CHUNK rows; the chunks' bytes are joined
    outside the kernel step's host and event spans), and of the whole call."""
    chunk = checker.STREAM_CHUNK
    steps = {k: [] for k in ("validate", "upload", "pose", "broad", "broad_events", "kernel",
                             "kernel_events", "fetch", "resolve", "end_to_end")}
    for i in range(runs + 1):
        ms = {}
        ms["validate"], c = host_ms(
            lambda: validate_confs(confs) if np.isfinite(confs).all() else None)
        ms["upload"], dev = host_ms(lambda: torch.from_numpy(c).to(checker.device))
        ms["pose"], poses = host_ms(lambda: mk.poses_from_confs(dev))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ms["broad"], _ = host_ms(lambda: mk.mesh_broad(poses, checker.tables))
        end.record()
        end.synchronize()
        ms["broad_events"] = start.elapsed_time(end)
        start.record()
        ms["kernel"], outs = host_ms(lambda: [
            mk.check_poses_cuda(poses[lo : lo + chunk], checker.tables)
            for lo in range(0, len(poses), chunk)])
        end.record()
        end.synchronize()
        ms["kernel_events"] = start.elapsed_time(end)
        packed = torch.cat(outs)  # joins the chunks outside the timed spans
        ms["fetch"], packed = host_ms(lambda: packed.cpu().numpy())
        valid, flagged = (packed & 1).astype(bool), (packed & 6).astype(bool)
        ms["resolve"], _ = host_ms(lambda: resolve_coplanar(
            checker.robot, checker.obstacle, confs, valid, flagged))
        ms["end_to_end"], _ = host_ms(lambda: checker.check_valid_resolved(confs))
        if i:  # the first run is the warm-up
            for k, v in ms.items():
                steps[k].append(v)
    return steps


def busy(checker, confs, runs: int, log_dir: Path) -> dict:
    """Device busy ms per call from a trace of `runs` calls, written to
    `log_dir/trace.json`."""
    checker.check_valid_resolved(confs)
    torch.cuda.synchronize()
    with timers.trace(str(log_dir)) as path:
        t0 = time.perf_counter()
        for _ in range(runs):
            checker.check_valid_resolved(confs)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / runs
    spans = timers.device_intervals(path, ("kernel", "gpu_memcpy", "gpu_memset"))
    return {"device_busy_ms": timers.busy_us(spans) / 1e3 / runs, "profiled_wall_ms": wall,
            "device_events": len(spans)}


@contextlib.contextmanager
def nvcc_flags(flags):
    """Build and launch the kernel with other nvcc flags inside the block."""
    saved = _build.NVCC_FLAGS
    _build.NVCC_FLAGS = tuple(flags)
    _build.build.cache_clear()
    _build.library.cache_clear()
    try:
        yield
    finally:
        _build.NVCC_FLAGS = saved
        _build.build.cache_clear()
        _build.library.cache_clear()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", nargs="+", default=["hard10k", "easy10k"],
                    choices=sorted(assets.DATASET_FILES))
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--out", type=Path, default=REPO / "build" / "torch_profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: no CUDA device")
    args.out.mkdir(parents=True, exist_ok=True)
    card = card_line()
    device = torch.device("cuda", 0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    checker = MegaKernelChecker(robot, obstacle, device=device)
    keys = list(dict.fromkeys(args.dataset))
    data = {k: read_conf_file(assets.dataset_path(k)).confs for k in keys}
    report = {"card": card}

    for key in keys:
        steps = layers(checker, data[key], args.runs)
        tr = busy(checker, data[key], args.runs, args.out / key)
        e2e = statistics.median(steps["end_to_end"])
        tr["busy_over_unprofiled_median"] = tr["device_busy_ms"] / e2e
        report[key] = {"layers_ms": steps, "trace": tr}
        print(f"[layers] [{card}] {key}: host ms, {args.runs} runs after a warm-up")
        for name, xs in steps.items():
            print(f"  {name}: {spread(xs)}")
        print(f"[trace] [{card}] {key}: device busy {tr['device_busy_ms']} ms per call "
              f"({tr['device_events']} device events in {args.runs} calls); profiled "
              f"call {tr['profiled_wall_ms']} ms; busy over the unprofiled median call "
              f"{tr['busy_over_unprofiled_median']}")

    first = mk.poses_from_confs(torch.from_numpy(data[keys[0]]).to(device))
    report["batch_ms"] = {}
    for n in sorted({min(n, len(first)) for n in (1024, 2048, 4096, 10000, 16384)}):
        rows = first[:n].contiguous()
        ms = event_ms(lambda: mk.check_poses_cuda(rows, checker.tables), args.runs)
        report["batch_ms"][n] = ms
        print(f"[batch] [{card}] kernel on {keys[0]}[:{n}]: {ms} ms")

    report["chunked_ms"] = {}
    for key in keys:
        poses = mk.poses_from_confs(torch.from_numpy(data[key]).to(device))
        chunk = checker.STREAM_CHUNK

        def chunked():
            for lo in range(0, len(poses), chunk):
                mk.check_poses_cuda(poses[lo : lo + chunk], checker.tables)

        one = event_ms(lambda: mk.check_poses_cuda(poses, checker.tables), args.runs)
        many = event_ms(chunked, args.runs)
        report["chunked_ms"][key] = {"one_launch": one, "chunks": many}
        print(f"[chunk] [{card}] kernel on all of {key} {list(poses.shape)}: one launch {one} "
              f"ms, {-(-len(poses) // chunk)} launches of {chunk} rows {many} ms")

    fma = [f.replace("-fmad=false", "-fmad=true") for f in _build.NVCC_FLAGS]
    with nvcc_flags(fma):
        _, log = _build.build()["megakernel"]
    print("[fma] -fmad=true ptxas: " + "; ".join(
        ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln))
    report["fma"] = {}
    for key in keys:
        poses = mk.poses_from_confs(torch.from_numpy(data[key]).to(device))
        outs, times = {}, {"false": [], "true": []}
        for mode in ("false", "true", "true", "false"):
            with nvcc_flags(_build.NVCC_FLAGS if mode == "false" else fma):
                times[mode].append(event_ms(
                    lambda: mk.check_poses_cuda(poses, checker.tables), args.runs))
                outs[mode] = mk.check_poses_cuda(poses, checker.tables).cpu().numpy()
        diff = int((outs["false"] != outs["true"]).sum())
        t_off, t_on = statistics.mean(times["false"]), statistics.mean(times["true"])
        report["fma"][key] = {"bytes_differ": diff, "fmad_false_ms": t_off,
                              "fmad_true_ms": t_on}
        print(f"[fma] [{card}] {key}: {diff} verdict bytes differ; kernel "
              f"-fmad=false {t_off} ms, -fmad=true {t_on} ms")

    (args.out / "report.json").write_text(json.dumps(report, indent=1))
    print(f"report: {args.out / 'report.json'}")


if __name__ == "__main__":
    main()
