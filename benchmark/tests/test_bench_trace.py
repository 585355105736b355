"""The trace reader refuses a slice that lost a record."""
import pytest

from harness import trace


def _trace(drop_kernel: bool = False, orphan: bool = False):
    ev = [{"name": trace.MARK, "cat": "user_annotation", "ts": 100.0, "dur": 100.0}]
    for i, (ts, dur) in enumerate([(110, 10), (130, 20), (170, 10)]):
        ev.append({"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": ts - 5, "dur": 2,
                   "args": {"correlation": i}})
        if not (drop_kernel and i == 1):
            ev.append({"name": f"k{i}", "cat": "kernel", "ts": ts, "dur": dur,
                       "args": {"correlation": i}})
    ev.append({"name": "cudaMemcpyAsync", "cat": "cuda_runtime", "ts": 180, "dur": 2,
               "args": {"correlation": 9}})
    ev.append({"name": "Memcpy DtoH", "cat": "gpu_memcpy", "ts": 185, "dur": 5,
               "args": {"correlation": 9}})
    if orphan:
        ev.append({"name": "k7", "cat": "kernel", "ts": 150, "dur": 1,
                   "args": {"correlation": 77}})
    return ev


def test_an_intact_slice_reads_its_busy_time_and_gaps():
    sl = trace.read_slice(_trace())
    assert trace.busy_us(sl["device"]) == 10 + 20 + 10 + 5
    assert trace.idle_gaps(sl) == [(100, 110), (120, 130), (150, 170), (180, 185), (190, 200)]
    assert trace.kernel_us(sl, ["k1"]) == 20
    b = trace.breakdown(sl)
    assert b["device_ops"][0] == ["k1", 20e-6]
    assert sum(s for _, s in b["idle_gaps"]) == pytest.approx(55e-6)


def test_a_slice_with_a_kernel_record_missing_is_refused():
    with pytest.raises(trace.LostRecords):
        trace.read_slice(_trace(drop_kernel=True))


def test_a_kernel_record_without_its_launch_is_refused():
    with pytest.raises(trace.LostRecords):
        trace.read_slice(_trace(orphan=True))
