"""The engine's bounds phase per call in the window: its `stats["bounds_s"]`
over `stats["calls"]`, in ms (host clock; the phase ends in a fetch)."""
from harness.readers import counter_ms_per_call


def read(record):
    return counter_ms_per_call(record, "bounds_s")
