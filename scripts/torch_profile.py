"""Where the time of the port's main path goes, on one CUDA card.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/torch_profile.py [--dataset hard10k easy10k] [--runs 10]
        [--out build/torch_profile]

The port's counterpart of `scripts/profile_kernel.py` (its `--dataset`,
`--runs` and `--out`). For the alpha-1.0 pair over each dataset named (any
key of `io.assets.DATASET_FILES`; hard100k and easy100k are written by
`scripts/torch_make_datasets.py`) it prints:
  * layers: the self time of each of the program's spans (`rc.check` and
    its steps: validate, upload, pose: K2's one launch, kernel: K1's one
    launch, fetch, resolve; `profiling.timers.span`) in each
    of `--runs` unfenced `check_valid_resolved` calls under
    `torch.profiler`, after a warm-up: a span's time less its child spans';
    median, min and max over the calls;
  * trace: from the same trace, the device's busy time per call (the union
    of its kernels, copies and fills, `timers.device_busy`: a trace that
    lost a record is taken again), the profiled call's wall time, and the
    busy time over the median unprofiled call (`--runs` calls by the host
    clock);
  * batch: the kernel's CUDA-event time on the first dataset's first n rows
    for growing n;
  * chunk: the kernel's CUDA-event time on all of each dataset's rows in one
    launch, as `check_packed` makes it, and in launches of CHUNK (16,384)
    rows, the launch size `check_packed` used before one launch a call;
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
from collections import defaultdict
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from robocheck_tpu_torch import MegaKernelChecker, load_obj, read_conf_file  # noqa: E402
from robocheck_tpu_torch.io import assets  # noqa: E402
from robocheck_tpu_torch.kernels import _build  # noqa: E402
from robocheck_tpu_torch.kernels import megakernel as mk  # noqa: E402
from robocheck_tpu_torch.profiling import timers  # noqa: E402
from robocheck_tpu_torch.profiling.timers import card_line, event_ms  # noqa: E402

# Rows per launch of the `[chunk]` line's chunked side.
CHUNK = 16384

def spread(xs) -> str:
    return f"median {statistics.median(xs)} (min {min(xs)}, max {max(xs)})"


def layers(path: Path) -> dict:
    """{span name: [self ms in each call]} of the program's spans in the
    trace at ``path``: a span's time less the time of the spans directly
    inside it. A call is a span that opens with no span open."""
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"].startswith("rc.")),
                   key=lambda s: (s[0], -s[1]))
    calls, open_spans = [], []
    for lo, hi, name in spans:
        while open_spans and open_spans[-1][1] <= lo:
            open_spans.pop()
        if open_spans:
            calls[-1][open_spans[-1][2]] -= hi - lo
        else:
            calls.append(defaultdict(float))
        calls[-1][name] += hi - lo
        open_spans.append((lo, hi, name))
    names = sorted(set().union(*calls))
    return {name: [c.get(name, 0.0) / 1e3 for c in calls] for name in names}


def traced(checker, confs, runs: int, log_dir: Path) -> tuple[dict, dict]:
    """(each span's self ms per call, the device's busy time) of ``runs``
    unfenced calls in one trace, kept at `log_dir/trace.json`, after a
    warm-up call; beside them the median unprofiled call."""
    checker.check_valid_resolved(confs)
    busy_s, records, wall_s = timers.device_busy(
        lambda: checker.check_valid_resolved(confs), runs, str(log_dir))
    steps = layers(log_dir / "trace.json")
    unprofiled = []
    for _ in range(runs):
        t0 = time.perf_counter()
        checker.check_valid_resolved(confs)
        unprofiled.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(unprofiled)
    return steps, {"device_busy_ms": busy_s * 1e3, "profiled_wall_ms": wall_s * 1e3,
                   "device_events": records, "unprofiled_median_ms": median,
                   "busy_over_unprofiled_median": busy_s * 1e3 / median}


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
        steps, tr = traced(checker, data[key], args.runs, args.out / key)
        report[key] = {"layers_ms": steps, "trace": tr}
        print(f"[layers] [{card}] {key}: self ms of each span, {args.runs} traced calls "
              f"after a warm-up")
        for name, xs in steps.items():
            print(f"  {name}: {spread(xs)}")
        print(f"[trace] [{card}] {key}: device busy {tr['device_busy_ms']} ms per call "
              f"({tr['device_events']} device records in {args.runs} calls); profiled "
              f"call {tr['profiled_wall_ms']} ms; unprofiled median call "
              f"{tr['unprofiled_median_ms']} ms; busy over it "
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

        def chunked():
            for lo in range(0, len(poses), CHUNK):
                mk.check_poses_cuda(poses[lo : lo + CHUNK], checker.tables)

        one = event_ms(lambda: mk.check_poses_cuda(poses, checker.tables), args.runs)
        many = event_ms(chunked, args.runs)
        report["chunked_ms"][key] = {"one_launch": one, "chunks": many}
        print(f"[chunk] [{card}] kernel on all of {key} {list(poses.shape)}: one launch {one} "
              f"ms, {-(-len(poses) // CHUNK)} launches of {CHUNK} rows {many} ms")

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
