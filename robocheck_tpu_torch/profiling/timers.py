"""Timing and profiling kit (the port of `robocheck_tpu.profiling.timers`).

  * ``StageTimer``: wall-clock time per named stage, each fenced with
    ``torch.cuda.synchronize()`` (PyTorch returns before the card finishes,
    so an unfenced host clock measures the enqueue).
  * ``trace``: a context manager around ``torch.profiler`` that writes a
    Chrome trace (open it in Perfetto or chrome://tracing).
  * ``benchmark``: best of ``runs`` after ``warmup`` calls, each synchronised
    (the reference report's protocol, section 4.2: minimum of 5 runs); in a
    rank of a process group every rank starts and ends each call together.
  * ``event_ms``: a call's device time by CUDA events (back-to-back calls,
    so a kernel shorter than its launch's host overhead reads as that
    overhead); ``kernel_ms``: the summed durations of the kernels a call
    launches, from a ``trace`` (the device's own time, with no gaps; a trace
    that lost a record of one of them is taken again, never summed);
    ``device_intervals``: the device spans of a written trace, which both
    ``kernel_ms`` and ``busy_us`` (the union of the spans: the device's busy
    time) read;
    ``card_line``: the card's name and power limit, which every device
    number carries.

Where no CUDA device is present the fence is a no-op, so the same code
times CPU runs (whose numbers are host times, never device metrics).
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import tempfile
import time
from collections import defaultdict

import torch


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        torch.distributed.barrier()


class StageTimer:
    """Accumulates wall-clock time per named stage."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync: bool = True):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                _sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name}: {t * 1e3:.2f} ms total, {n} calls, "
                         f"{t / n * 1e3:.3f} ms/call")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region (CPU, and CUDA where a card is present)
    and write ``<log_dir>/trace.json``; yields that path."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with torch.profiler.profile(activities=acts) as prof:
        yield path
        _sync()
    prof.export_chrome_trace(path)


def benchmark(fn, *args, runs: int = 5, warmup: int = 1) -> float:
    """Best of ``runs`` host-clock seconds after ``warmup`` calls; each call
    is synchronised, so device time is fully counted."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    best = float("inf")
    _sync()
    for _ in range(runs):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best


def event_ms(fn, reps: int = 20) -> float:
    """Mean device ms of one ``fn()`` over ``reps`` back-to-back calls, by
    CUDA events, after one warm-up call. Needs a CUDA device."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_intervals(path: str, cats=("kernel",)) -> list[tuple[float, float]]:
    """Sorted (start, end) µs of the trace events at ``path`` whose category
    is one of ``cats`` (``kernel``, ``gpu_memcpy``, ``gpu_memset``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in cats)


def busy_us(spans: list[tuple[float, float]]) -> float:
    """µs covered by the union of sorted (start, end) device spans: the
    device's busy time (overlapping spans count once)."""
    total, end = 0.0, float("-inf")
    for lo, hi in spans:
        total += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return total


# Tiny kernels launched at the start of every `kernel_ms` trace: late in a
# long process every other trace on an H100 missed its first records
# (padding the window with idle time did not help), so the measured calls
# come after these.
_PRIME_KERNELS = 64
_MARK = "kernel_ms"
# Traces `kernel_ms` takes of a call before it gives up.
_TRIES = 3


def _marked_kernels(path: str) -> tuple[list[tuple[float, float]], int, int]:
    """(sorted (start, end) µs of the kernels launched inside the trace's
    `_MARK` span, the kernel launches made inside it, the records lost
    there) in the trace at ``path``. Launches and kernels match by
    correlation id, wherever the kernel's record lies on the trace's clock.
    Lost: a launch in the span without its kernel record, and a kernel
    record in the span whose launch is nowhere in the trace (a kernel
    launched before the span, such as a primer, is not the span's)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == _MARK and e.get("cat") in ("user_annotation", "cpu_op")]
    lo, hi = marks[0] if marks else (float("inf"), float("-inf"))
    launch_ts = {e.get("args", {}).get("correlation"): e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime"
                 and ("LaunchKernel" in e.get("name", "")
                      or "LaunchCooperativeKernel" in e.get("name", ""))}
    launches = {c for c, ts in launch_ts.items() if lo <= ts <= hi}
    kernels = {e.get("args", {}).get("correlation"): (e["ts"], e["ts"] + e["dur"])
               for e in events if e.get("cat") == "kernel"}
    spans = sorted(kernels[c] for c in launches & kernels.keys())
    orphans = [c for c, (ts, _) in kernels.items() if lo <= ts <= hi and c not in launch_ts]
    return spans, len(launches), len(launches - kernels.keys()) + len(orphans)


def kernel_ms(fn, reps: int = 20) -> float:
    """Mean summed duration (ms) of the device kernels one ``fn()`` launches,
    over ``reps`` calls under ``trace`` after one warm-up call. Needs a CUDA
    device.

    Each trace first launches `_PRIME_KERNELS` tiny kernels, then marks the
    measured calls and a synchronize with a `record_function` span: every
    kernel launch in the span must have its kernel's record (matched by
    correlation id), every kernel record in the span a launch in the trace,
    and the launches must be a multiple of ``reps``. A trace that fails
    this (``kernel_ms.lost`` counts them) is taken again, up to `_TRIES`
    times, then this raises rather than under-read."""
    fn()
    torch.cuda.synchronize()
    for _ in range(_TRIES):
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp) as path:
                primer = torch.empty((1,), device="cuda")
                for _ in range(_PRIME_KERNELS):
                    primer.fill_(0.0)
                torch.cuda.synchronize()
                with torch.profiler.record_function(_MARK):
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
            spans, launched, lost = _marked_kernels(path)
        if launched and not lost and launched % reps == 0:
            return sum(hi - lo for lo, hi in spans) / 1e3 / reps
        kernel_ms.lost += 1
    raise RuntimeError(f"kernel_ms: {_TRIES} traces of {reps} calls each lost records "
                       f"(the last: {launched} launches, {lost} without their counterpart)")


kernel_ms.lost = 0


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
