"""The readers of the program's spans charge a slice's idle gaps to the
``rc.`` spans open during them, and find nothing where there is nothing to
read."""
import pytest

from harness import spans, spec, trace


def _events(program: bool = True, device: bool = True):
    """A 100 µs slice: kernels at 20-30 and 60-70 (idle 0-20, 30-60, 70-100),
    one check call's spans, and host ranges that are not the program's."""
    ev = [{"name": trace.MARK, "cat": "user_annotation", "ts": 0.0, "dur": 100.0},
          {"name": "bench.call", "cat": "user_annotation", "ts": 1.0, "dur": 98.0},
          {"name": "rc.check.fetch", "cat": "gpu_user_annotation", "ts": 0.0, "dur": 100.0}]
    if device:
        for c, ts in ((1, 20.0), (2, 60.0)):
            ev.append({"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": ts - 3,
                       "dur": 1.0, "args": {"correlation": c}})
            ev.append({"name": f"k{c}", "cat": "kernel", "ts": ts, "dur": 10.0,
                       "args": {"correlation": c}})
    if program:
        for name, lo, hi in (("rc.check", 5, 95), ("rc.check.validate", 5, 15),
                             ("rc.check.upload", 15, 25), ("rc.check.kernel", 25, 50),
                             ("rc.check.fetch", 50, 65), ("rc.check.resolve", 65, 90)):
            ev.append({"name": name, "cat": "user_annotation", "ts": float(lo),
                       "dur": float(hi - lo)})
    return ev


def _record(events, calls: int = 1, counters=None):
    sl = trace.read_slice(events)
    return {"slice": {"trace": sl, "calls": calls, "batches": [0] * calls},
            "counters": counters or {"start": {}, "end": {}}}


def test_idle_inside_the_union_of_the_named_spans():
    rec = _record(_events(), calls=2)
    # (5, 20) under validate and upload, (50, 60) under fetch: 25 µs over 2 calls.
    assert spans.idle_ms_per_call(rec, spans.CHECK_IO) == pytest.approx(25e-3 / 2)
    assert spans.idle_ms_per_call(rec, spans.CHECK_RESOLVE) == pytest.approx(20e-3 / 2)
    assert spans.idle_ms_per_call(rec, spans.CHECK_LAUNCH) == pytest.approx(20e-3 / 2)


def test_a_span_counts_with_its_descendants():
    # The root holds every step: all idle time from 5 to 95.
    assert spans.idle_ms_per_call(_record(_events()), ("rc.check",)) == pytest.approx(70e-3)
    # A fetch inside the bounds phase counts as the phase's.
    ev = _events(program=False) + [
        {"name": "rc.clearance.bounds", "cat": "user_annotation", "ts": 10.0, "dur": 30.0},
        {"name": "rc.clearance.fetch", "cat": "user_annotation", "ts": 32.0, "dur": 8.0}]
    rec = _record(ev)
    assert spans.idle_ms_per_call(rec, spans.CLEARANCE_BOUNDS) == pytest.approx(20e-3)
    assert spans.idle_by_span(rec["slice"]["trace"])["rc.clearance.fetch"] == 8.0


def test_bench_spans_and_device_copies_of_spans_are_not_the_programs():
    sl = trace.read_slice(_events(program=False))
    assert spans.program_spans(sl) == []
    assert spans.idle_by_span(sl) == {spans.OUTSIDE: 80.0}
    assert [s[2] for s in spans.program_spans(trace.read_slice(_events()))] == [
        "rc.check", "rc.check.validate", "rc.check.upload", "rc.check.kernel",
        "rc.check.fetch", "rc.check.resolve"]


@pytest.mark.parametrize("case", ["no slice", "no call", "no device record", "no rc span"])
def test_nothing_to_read_is_none(case):
    rec = _record(_events(program=case != "no rc span", device=case != "no device record"),
                  calls=0 if case == "no call" else 1)
    if case == "no slice":
        rec["slice"] = None
    assert spans.idle_ms_per_call(rec, spans.CHECK_IO) is None


def test_idle_by_span_charges_the_innermost_span_and_sums_to_the_idle_time():
    sl = trace.read_slice(_events())
    got = spans.idle_by_span(sl)
    assert got == {spans.OUTSIDE: 10.0, "rc.check.validate": 10.0, "rc.check.upload": 5.0,
                   "rc.check.kernel": 20.0, "rc.check.fetch": 10.0,
                   "rc.check.resolve": 20.0, "rc.check": 5.0}
    idle = (sl["hi"] - sl["lo"]) - trace.busy_us(sl["device"])
    assert sum(got.values()) == pytest.approx(idle)


NEW = ("idle_io_ms_per_call.checks", "idle_resolve_ms_per_call.checks",
       "idle_io_ms_per_call.step", "idle_launch_ms_per_call.step",
       "idle_bounds_ms_per_call.clearance", "idle_exact_ms_per_call.clearance")


@pytest.mark.parametrize("name", NEW)
def test_each_idle_metric_reads_a_slice_with_spans_and_skips_one_without(name):
    ev = _events() + [
        {"name": "rc.clearance.bounds", "cat": "user_annotation", "ts": 5.0, "dur": 10.0},
        {"name": "rc.clearance.exact", "cat": "user_annotation", "ts": 50.0, "dur": 20.0}]
    read = spec.metric_reader(name)
    assert read(_record(ev)) > 0
    assert read(_record(_events(device=False))) is None
    assert read(_record(_events(program=False))) is None


def test_waves_per_call_reads_the_engines_counters():
    read = spec.metric_reader("waves_per_call.clearance")
    rec = _record(_events(), counters={"start": {"calls": 3, "waves": 7},
                                       "end": {"calls": 7, "waves": 19}})
    assert read(rec) == 3.0
    # A program without the counter, or a window without calls.
    assert read(_record(_events(), counters={"start": {"calls": 3},
                                             "end": {"calls": 7}})) is None
    assert read(_record(_events(), counters={"start": {"calls": 3, "waves": 7},
                                             "end": {"calls": 3, "waves": 7}})) is None
