"""Reading a `torch.profiler` trace of a slice of the window.

The slice is marked by a `record_function` span (``MARK``) around its calls
and a final synchronize. The guard is a copy of the program's
`profiling/timers._marked_kernels`: every kernel launch made inside the
span must have its kernel record, matched by correlation id, and every
kernel record inside the span must have its launch somewhere in the trace.
Copies and fills are held to the same rule. A slice that lost a record is
refused (``LostRecords``), never read short: a lost kernel would read as
idle time.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

MARK = "bench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Runtime calls whose work appears as a device record of the category.
_RUNTIME = {"kernel": ("LaunchKernel", "LaunchCooperativeKernel"),
            "gpu_memcpy": ("Memcpy",), "gpu_memset": ("Memset",)}
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")
# Host events before a gap searched for the one it began in.
_LOOK_BACK = 512


class LostRecords(RuntimeError):
    """The traced slice lost a launch's device record or the reverse."""


def _corr(e):
    return e.get("args", {}).get("correlation")


def read_slice(events: list) -> dict:
    """What the slice inside ``MARK`` holds: its span (µs), the device
    records inside it by category and name, and the host events. Raises
    LostRecords where the guard fails."""
    marks = [e for e in events if e.get("name") == MARK
             and e.get("cat") in ("user_annotation", "cpu_op")]
    if not marks:
        raise LostRecords(f"no {MARK} span in the trace")
    lo = marks[0]["ts"]
    hi = lo + marks[0]["dur"]
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    lost = {}
    for cat, names in _RUNTIME.items():
        calls = {_corr(e): e["ts"] for e in runtime
                 if any(n in e.get("name", "") for n in names)}
        inside = {c for c, ts in calls.items() if lo <= ts <= hi}
        records = {_corr(e): e["ts"] for e in device if e.get("cat") == cat}
        orphans = [c for c, ts in records.items() if lo <= ts <= hi and c not in calls]
        missing = inside - records.keys()
        if missing or orphans:
            lost[cat] = (len(missing), len(orphans))
    if lost:
        raise LostRecords(f"records lost in the slice, (launches without a record, "
                          f"records without a launch) by kind: {lost}")
    spans = [(max(e["ts"], lo), min(e["ts"] + e["dur"], hi), e["cat"], e.get("name", ""))
             for e in device if e["ts"] < hi and e["ts"] + e["dur"] > lo]
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("dur") is not None
            and e["ts"] < hi and e["ts"] + e["dur"] > lo and e.get("name") != MARK]
    return {"lo": lo, "hi": hi, "device": sorted(spans), "host": host}


def read_file(path) -> dict:
    with open(path) as f:
        return read_slice(json.load(f)["traceEvents"])


def busy_us(spans) -> float:
    """µs covered by the union of sorted (start, end, ...) spans."""
    total, end = 0.0, float("-inf")
    for lo, hi, *_ in spans:
        total += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return total


def idle_gaps(sl: dict) -> list[tuple[float, float]]:
    """(start, end) µs of the slice's intervals with no device record."""
    gaps, end = [], sl["lo"]
    for lo, hi, *_ in sl["device"]:
        if lo > end:
            gaps.append((end, lo))
        end = max(end, hi)
    if sl["hi"] > end:
        gaps.append((end, sl["hi"]))
    return gaps


def kernel_us(sl: dict, names) -> float:
    """Summed µs of the slice's kernels whose name contains one of ``names``."""
    return sum(hi - lo for lo, hi, cat, name in sl["device"]
               if cat == "kernel" and any(n in name for n in names))


def breakdown(sl: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by what
    the host was doing when each gap began (its innermost host event; "host,
    between calls" where none), in seconds, at most ``top`` of each."""
    ops = defaultdict(float)
    for lo, hi, _, name in sl["device"]:
        ops[name] += (hi - lo) / 1e6
    host = sorted(sl["host"], key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    idle = defaultdict(float)
    for lo, hi in idle_gaps(sl):
        at = bisect.bisect_right(starts, lo)
        inner = [e for e in host[max(0, at - _LOOK_BACK):at] if lo < e["ts"] + e["dur"]]
        label = min(inner, key=lambda e: e["dur"])["name"] if inner else "host, between calls"
        idle[label] += (hi - lo) / 1e6
    def most(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": most(ops), "idle_gaps": most(idle)}
