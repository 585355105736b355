"""Timing and profiling kit (the port of `robocheck_tpu.profiling.timers`).

  * ``span``: a named host range (``record_function``) while a profiler is
    recording, else one shared no-op context: the program marks its layer
    boundaries with it at no cost when nothing traces. The ranges land in
    the profiler's own trace, on the clock of its device records.
  * ``trace``: a context manager around ``torch.profiler`` that writes a
    Chrome trace (open it in Perfetto or chrome://tracing).
  * ``benchmark``: best of ``runs`` after ``warmup`` calls, each synchronised
    (the reference report's protocol, section 4.2: minimum of 5 runs); in a
    rank of a process group every rank starts and ends each call together.
  * ``event_ms``: a call's device time by CUDA events (back-to-back calls,
    so a kernel shorter than its launch's host overhead reads as that
    overhead); ``kernel_ms``: the summed durations of the kernels a call
    launches, from a ``trace`` (the device's own time, with no gaps);
    ``device_busy``: the device's busy time over a call (the union of its
    kernels, copies and fills), from a ``trace``. Both take a trace again
    where it lost a record, never read it short;
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

import torch


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        torch.distributed.barrier()


# True while a profiler records this thread's host events.
_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks the enclosed host code as ``name`` in the trace
    of a running profiler (``torch.profiler.record_function``); with none
    running, a shared no-op that enters nothing (a ``record_function``
    costs microseconds even then)."""
    if _recording():
        return torch.profiler.record_function(name)
    return _OFF


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


def busy_us(spans: list[tuple[float, float]]) -> float:
    """µs covered by the union of sorted (start, end) device spans: the
    device's busy time (overlapping spans count once)."""
    total, end = 0.0, float("-inf")
    for lo, hi in spans:
        total += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return total


# Tiny kernels launched at the start of every traced call: late in a long
# process every other trace on an H100 missed its first records (padding the
# window with idle time did not help), so the measured calls come after these.
_PRIME_KERNELS = 64
_MARK = "kernel_ms"
# Traces taken of a call before a reader gives up.
_TRIES = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Runtime calls whose work appears as a device record of the category.
_RUNTIME = {"kernel": ("LaunchKernel", "LaunchCooperativeKernel"),
            "gpu_memcpy": ("Memcpy",), "gpu_memset": ("Memset",)}


def _marked_kernels(path: str, cats=("kernel",)) -> tuple[list[tuple[float, float]], int, int]:
    """(sorted (start, end) µs of the device records of the categories
    ``cats`` (kernels, copies, fills) whose runtime call was made inside the
    trace's `_MARK` span, those calls, the records lost there) in the trace
    at ``path``. Calls and records match by correlation id, wherever the
    record lies on the trace's clock. Lost: a call in the span without its
    record, and a record in the span whose call is nowhere in the trace (a
    kernel launched before the span, such as a primer, is not the span's)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == _MARK and e.get("cat") in ("user_annotation", "cpu_op")]
    lo, hi = marks[0] if marks else (float("inf"), float("-inf"))
    spans, launched, lost = [], 0, 0
    for cat in cats:
        call_ts = {e.get("args", {}).get("correlation"): e["ts"] for e in events
                   if e.get("cat") == "cuda_runtime"
                   and any(n in e.get("name", "") for n in _RUNTIME[cat])}
        calls = {c for c, ts in call_ts.items() if lo <= ts <= hi}
        records = {e.get("args", {}).get("correlation"): (e["ts"], e["ts"] + e["dur"])
                   for e in events if e.get("cat") == cat}
        spans += [records[c] for c in calls & records.keys()]
        orphans = [c for c, (ts, _) in records.items() if lo <= ts <= hi and c not in call_ts]
        launched += len(calls)
        lost += len(calls - records.keys()) + len(orphans)
    return sorted(spans), launched, lost


def _traced(fn, reps: int, cats, log_dir: str | None):
    """(records, calls, lost, host seconds) of ``reps`` calls of ``fn()``
    and a synchronize, marked after `_PRIME_KERNELS` tiny kernels in one
    trace (written to ``log_dir``, else to a temporary folder)."""
    with contextlib.ExitStack() as stack:
        tmp = log_dir or stack.enter_context(tempfile.TemporaryDirectory())
        with trace(tmp) as path:
            primer = torch.empty((1,), device="cuda")
            for _ in range(_PRIME_KERNELS):
                primer.fill_(0.0)
            torch.cuda.synchronize()
            with torch.profiler.record_function(_MARK):
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        return (*_marked_kernels(path, cats), wall)


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
        spans, launched, lost, _ = _traced(fn, reps, ("kernel",), None)
        if launched and not lost and launched % reps == 0:
            return sum(hi - lo for lo, hi in spans) / 1e3 / reps
        kernel_ms.lost += 1
    raise RuntimeError(f"kernel_ms: {_TRIES} traces of {reps} calls each lost records "
                       f"(the last: {launched} launches, {lost} without their counterpart)")


kernel_ms.lost = 0


def device_busy(fn, reps: int = 1, log_dir: str | None = None) -> tuple[float, int, float]:
    """(device busy seconds, device records, profiled host seconds), each
    per call, of ``reps`` calls of ``fn()`` under ``trace``: the union of
    the kernels, copies and fills they issue, held to `kernel_ms`'s guard
    (every such call in the marked span has its record, every record there
    its call; a trace that fails it is taken again, up to `_TRIES` times,
    and counted in ``kernel_ms.lost``, then this raises). No warm-up call. With ``log_dir`` the last trace is
    kept at ``<log_dir>/trace.json``. Needs a CUDA device."""
    for _ in range(_TRIES):
        spans, launched, lost, wall = _traced(fn, reps, DEVICE_CATS, log_dir)
        if not lost:
            return busy_us(spans) / 1e6 / reps, len(spans), wall / reps
        kernel_ms.lost += 1
    raise RuntimeError(f"device_busy: {_TRIES} traces of {reps} calls each lost records "
                       f"(the last: {launched} calls, {lost} without their counterpart)")


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
