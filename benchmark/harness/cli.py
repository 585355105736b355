"""One run of one cell: set-up, the measured window, the check of every
answer, and one JSON line of results.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The window is a closed loop: one caller sends the next call when the last
returns, cycling through the pool of inputs that set-up made from the seed.
With ``--trace 1`` a slice of calls before the window runs under
`torch.profiler`, and the run reports the per-layer metrics instead of the
end-to-end ones. ``--control`` (a driver's name for it) puts the control
in the program's place; ``--device cpu`` skips the look for a card and runs
the program's CPU twins (tests only).
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import tempfile
import time
import traceback

from . import spec

# Seconds of calls the traced slice holds.
TRACE_SECONDS = 2.0
# Traces of the slice taken before a run gives up on lost records.
TRACE_TRIES = 3
# Tiny kernels launched before the slice: a trace's first records are the
# ones it loses (`profiling/timers.py` in the program).
PRIME_KERNELS = 64
FORBIDDEN = ("jax", "jaxlib", "flax", "robocheck_tpu")


class Refused(RuntimeError):
    """The run cannot measure here (no card, too few cards, no such control)."""


class Context:
    """What a driver's set-up and check are given."""

    def __init__(self, cell, seed: int, device: str, control: str | None):
        import numpy as np

        self.root = spec.ROOT
        self.config, self.traffic = cell.config, cell.traffic
        self.generator = cell.generator()
        self.seed, self.device, self.control = seed, device, control
        self.rng = np.random.default_rng(seed % (1 << 64))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def _set_env() -> None:
    """One thread to each numeric library: the load is one process's. (The
    program builds into ``build/`` inside the checkout by itself.)"""
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def _loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


class Calls:
    """Each call's batch, start and end (host clock) and answer, in arrays
    and a list that hold no container the collector tracks, so the window
    grows no work for it."""

    def __init__(self):
        self.batch, self.t0, self.t1, self.answer = [], [], [], []

    def __len__(self):
        return len(self.batch)

    def add(self, k: int, t0: float, t1: float, answer) -> None:
        self.batch.append(k)
        self.t0.append(t0)
        self.t1.append(t1)
        self.answer.append(answer)


def _loop(session, seconds: float, calls: Calls, failed: list, mark=None) -> None:
    """Calls back to back for ``seconds``, cycling through the pool."""
    pool = len(session.pool)
    k = 0
    t_end = time.perf_counter() + seconds
    while True:
        t0 = time.perf_counter()
        if t0 >= t_end:
            return
        try:
            if mark is None:
                answer = session.call(k % pool)
            else:
                with mark("bench.call"):
                    answer = session.call(k % pool)
        except Exception:  # a failed call is counted and reported, not fatal
            if not failed:
                traceback.print_exc()
            failed.append(k % pool)
            answer = None
        calls.add(k % pool, t0, time.perf_counter(), answer)
        k += 1


def _traced_slice(session, device: str, seconds: float, calls: Calls, failed: list):
    """(slice reading, (its first call's index, its last's + 1)) of a traced
    slice of calls; retaken where the trace lost records."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    for attempt in range(TRACE_TRIES):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            with profile(activities=acts) as prof:
                primer = torch.zeros(1, device=device)
                for _ in range(PRIME_KERNELS):
                    primer.add_(1.0)
                _sync(device)
                first = len(calls)
                with record_function(trace.MARK):
                    _loop(session, seconds, calls, failed, mark=record_function)
                    _sync(device)
            prof.export_chrome_trace(path)
            try:
                return trace.read_file(path), (first, len(calls))
            except trace.LostRecords as e:
                print(f"trace {attempt + 1} of {TRACE_TRIES} refused: {e}", file=sys.stderr)
    raise trace.LostRecords(f"{TRACE_TRIES} traces of the slice lost records")


def _card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "not read"


def run(args, t_start: float) -> dict:
    _set_env()
    cell = spec.load_cell(args.workload)
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{cell.name} needs {cell.chips} cards, "
                          f"{torch.cuda.device_count()} present")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(spec.ROOT))
    driver = cell.driver()
    ctx = Context(cell, args.seed, args.device, args.control)
    if args.control is not None and args.control not in driver.CONTROLS:
        raise Refused(f"no control {args.control!r}: {driver.CONTROLS}")

    session = driver.Session(ctx)  # set-up: builds, tables, the pool, warm-up
    _sync(args.device)
    calls, failed = Calls(), []
    sliced = None
    if args.trace:
        sliced = _traced_slice(session, args.device, min(TRACE_SECONDS, args.seconds),
                               calls, failed)
    first = len(calls)
    before = session.counters()
    # What set-up made stays out of the collector's passes in the window.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    if args.control is None:
        _loop(session, args.seconds, calls, failed)
    else:  # a control's answers repeat batch for batch: one pass over the pool
        for k in range(len(session.pool)):
            t0 = time.perf_counter()
            answer = session.call(k)
            calls.add(k, t0, time.perf_counter(), answer)
    after = session.counters()
    gc.unfreeze()
    window = range(first, len(calls))
    peak = torch.cuda.max_memory_allocated() if args.device == "cuda" else 0
    later = session.after_window() if args.trace else {}
    pool = session.pool
    session.close()
    del session
    gc.collect()
    if args.device == "cuda":
        torch.cuda.empty_cache()

    answered = [(k, a) for k, a in zip(calls.batch, calls.answer) if a is not None]
    t_verify = time.perf_counter()
    compared, counts = driver.verify(ctx, pool, answered)
    print(f"seconds: set-up {setup_s:.3f}, window {args.seconds}, check "
          f"{time.perf_counter() - t_verify:.3f}; calls {len(calls)}", file=sys.stderr)
    if len(window):
        import numpy as np

        ms = np.array([calls.t1[i] - calls.t0[i] for i in window]) * 1e3
        slow = np.array([calls.batch[i] for i in window])[ms > 2 * np.median(ms)]
        print("call ms p50 p90 p95 p99 max: " + " ".join(
            f"{v:.4f}" for v in np.percentile(ms, [50, 90, 95, 99, 100]))
              + f"; over twice the median: {len(slow)} calls, batches "
              f"{np.unique(slow)[:12].tolist()}", file=sys.stderr)
    correct = not failed and all(v <= lim for v, lim in compared.values())

    record = {
        "unit": driver.UNIT, "setup_s": setup_s,
        "window": {"seconds": calls.t1[-1] - calls.t0[first] if window else 0.0,
                   "units": sum(len(pool[calls.batch[i]]) for i in window
                                if calls.answer[i] is not None),
                   "call_s": [calls.t1[i] - calls.t0[i] for i in window],
                   "batches": [calls.batch[i] for i in window]},
        "counters": {"start": before, "end": after},
        "after": later, "counts": counts, "card": _card_line() if args.device == "cuda" else "",
        "slice": None,
    }
    device = {"platform": "gpu" if args.device == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(peak),
              "power_limit": record["card"]}
    result = {"correct": bool(correct), "attempted": len(calls), "failed": len(failed)}
    if sliced is not None:
        from . import trace

        sl, (lo, hi) = sliced
        record["slice"] = {"trace": sl, "calls": hi - lo, "batches": calls.batch[lo:hi]}
        device["busy_s"] = trace.busy_us(sl["device"]) / 1e6
        device["window_s"] = (sl["hi"] - sl["lo"]) / 1e6
        result["breakdown"] = trace.breakdown(sl)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = spec.metric_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device
    # A number that is not finite (an answer of the wrong shape) is written as
    # a string: JSON has no infinity.
    result["compared"] = {name: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                          for name, (v, lim) in compared.items()}
    return result


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    try:
        result = run(args, t_start)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    # The last step before the result: every reader has been loaded and run.
    found = _loaded_forbidden()
    if found:
        print(f"refused: modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
        return 2
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
