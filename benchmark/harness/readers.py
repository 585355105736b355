"""Readers that several metrics share: each metric's own file in
`benchmark/metrics/` names one of these, or reads the record itself.

A reader takes the run's record (`harness/cli.py`) and returns a number, or
None where the run holds nothing for it to read.
"""
from __future__ import annotations

import numpy as np

from . import trace, work

# Kernels by the names of their functions in the program's CUDA sources.
K1 = ("megakernel",)
K3 = ("plan_kernel", "task_kernel", "finish_kernel", "nocull_kernel")


def units_per_s(record):
    """All answers of all calls completed in the window, over its seconds."""
    w = record["window"]
    return w["units"] / w["seconds"] if w["seconds"] > 0 else None


def call_ms(record, q):
    """The ``q``-th percentile of every call's round trip in the untraced
    window, in ms."""
    times = record["window"]["call_s"]
    return float(np.percentile(times, q)) * 1e3 if times else None


def device_idle_pct(record):
    """100 - the share of the traced slice's span that the union of its
    kernels, copies and fills covers."""
    sl = record["slice"]
    if sl is None:
        return None
    t = sl["trace"]
    return 100.0 - 100.0 * trace.busy_us(t["device"]) / (t["hi"] - t["lo"])


def kernel_ms_per_call(record, names):
    sl = record["slice"]
    if sl is None or not sl["calls"]:
        return None
    us = trace.kernel_us(sl["trace"], names)
    return us / 1e3 / sl["calls"] if us > 0 else None


def k1_roofline(record):
    """K1's least time per call (`harness/work.py`, from the plain
    reference's counts of the slice's batches) over its device time per call
    in the traced slice, in %."""
    ms = kernel_ms_per_call(record, K1)
    counts = record["counts"]
    if ms is None or "pairs" not in counts:
        return None
    least = [work.least_seconds(*work.check_work(
        counts["robot_vertices"], counts["robot_triangles"], counts["obstacle_triangles"],
        counts["valid"][k], counts["broad"][k], counts["pairs"][k]))
        for k in record["slice"]["batches"]]
    return 100.0 * float(np.mean(least)) * 1e3 / ms


def resolve_rows_per_call(record):
    """Rows the float64 resolution takes, averaged over the window's calls."""
    rows = record["after"].get("resolve_rows")
    batches = record["window"]["batches"]
    if rows is None or not batches:
        return None
    return float(np.mean([rows[k] for k in batches]))


def counter_ms_per_call(record, key):
    """Host seconds of an engine counter per call over the window, in ms."""
    c0, c1 = record["counters"]["start"], record["counters"]["end"]
    calls = c1.get("calls", 0) - c0.get("calls", 0)
    if key not in c1 or calls <= 0:
        return None
    return (c1[key] - c0[key]) / calls * 1e3
