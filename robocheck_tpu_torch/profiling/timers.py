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
    launches, from a ``trace`` (the device's own time, with no gaps);
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


def kernel_ms(fn, reps: int = 20) -> float:
    """Mean summed duration (ms) of the device kernels one ``fn()`` launches,
    over ``reps`` calls under ``trace`` after one warm-up call. Needs a CUDA
    device."""
    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as path:
            for _ in range(reps):
                fn()
        spans = device_intervals(path)
    return sum(hi - lo for lo, hi in spans) / 1e3 / reps


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
