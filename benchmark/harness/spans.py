"""Reading the program's own spans in a traced slice.

The program marks its layers with host ranges whose names start with
``rc.`` (`robocheck_tpu_torch/profiling/timers.span`): ``rc.check`` and its
steps in the batch checker, ``rc.clearance`` and its phases in the
clearance engine. The profiler puts them on the clock of its device
records, so an idle gap of the device (`trace.idle_gaps`) can be charged to
the program's layer that the host was in. Only host ranges count: not their
device-side copies (``gpu_user_annotation``), nor the harness's ``bench.*``
spans. A span's interval holds its descendants', so idle time under a span
counts what its children spent too.
"""
from __future__ import annotations

from collections import defaultdict

from . import trace

PREFIX = "rc."
OUTSIDE = "outside the program"

CHECK_IO = ("rc.check.validate", "rc.check.upload", "rc.check.fetch")
CHECK_RESOLVE = ("rc.check.resolve",)
CHECK_LAUNCH = ("rc.check.pose", "rc.check.kernel")
CLEARANCE_BOUNDS = ("rc.clearance.bounds",)
CLEARANCE_EXACT = ("rc.clearance.exact",)


def program_spans(sl: dict) -> list[tuple[float, float, str]]:
    """(start, end, name) µs of the slice's host ``rc.*`` ranges, clipped to
    the slice (those left empty dropped), outer before inner (by start, the
    longer first)."""
    spans = [(max(e["ts"], sl["lo"]), min(e["ts"] + e["dur"], sl["hi"]), e["name"])
             for e in sl["host"] if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(PREFIX)]
    return sorted((s for s in spans if s[1] > s[0]), key=lambda s: (s[0], -s[1]))


def _union(intervals) -> list[tuple[float, float]]:
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _cross(gaps, pieces):
    """(µs, label) of each overlap of two sorted lists of disjoint
    intervals: ``gaps`` (lo, hi) and ``pieces`` (lo, hi, label)."""
    i = j = 0
    while i < len(gaps) and j < len(pieces):
        lo = max(gaps[i][0], pieces[j][0])
        hi = min(gaps[i][1], pieces[j][1])
        if hi > lo:
            yield hi - lo, pieces[j][2]
        if gaps[i][1] <= pieces[j][1]:
            i += 1
        else:
            j += 1


def _readable(record):
    """The traced slice's trace, or None where it holds nothing to read: no
    slice or no call, no device record (a CPU run), no ``rc.`` span (a
    program without them)."""
    sl = record["slice"]
    if sl is None or not sl["calls"]:
        return None
    t = sl["trace"]
    if not t["device"] or not program_spans(t):
        return None
    return t


def idle_ms_per_call(record, names) -> float | None:
    """ms of the traced slice's device idle time that falls inside the
    union of the spans named ``names`` (with their descendants), per call of
    the slice."""
    t = _readable(record)
    if t is None:
        return None
    union = _union((lo, hi) for lo, hi, name in program_spans(t) if name in names)
    us = sum(d for d, _ in _cross(trace.idle_gaps(t), [(lo, hi, None) for lo, hi in union]))
    return us / 1e3 / record["slice"]["calls"]


def _innermost(sl: dict) -> list[tuple[float, float, str]]:
    """Pieces (lo, hi, name) that cover the slice, each labelled with the
    innermost ``rc.`` span open over it (the latest started), or
    ``OUTSIDE``."""
    spans = program_spans(sl)
    marks = sorted([(lo, 1, i) for i, (lo, _, _) in enumerate(spans)]
                   + [(hi, 0, i) for i, (_, hi, _) in enumerate(spans)])
    pieces, opened, at = [], [], sl["lo"]
    for t, starts, i in marks:  # at one instant, ends before starts
        if t > at:
            pieces.append((at, t, spans[opened[-1]][2] if opened else OUTSIDE))
            at = t
        if starts:
            opened.append(i)
        else:
            opened.remove(i)
    if sl["hi"] > at:
        pieces.append((at, sl["hi"], OUTSIDE))
    return pieces


def idle_by_span(sl: dict) -> dict[str, float]:
    """µs of the slice's device idle time charged to the innermost ``rc.``
    span open at each µs, or to ``OUTSIDE`` where none is: the charges sum
    to the slice's idle time. ``sl`` is a slice's trace (`trace.read_slice`)."""
    charges = defaultdict(float)
    for us, name in _cross(trace.idle_gaps(sl), _innermost(sl)):
        charges[name] += us
    return dict(charges)
