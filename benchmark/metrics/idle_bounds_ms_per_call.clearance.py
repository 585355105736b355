"""Device idle ms per clearance call in the traced slice while the engine is
in its bounds phase: the span `rc.clearance.bounds` (the region that
`stats["bounds_s"]` times), its fetch included."""
from harness.spans import CLEARANCE_BOUNDS, idle_ms_per_call


def read(record):
    return idle_ms_per_call(record, CLEARANCE_BOUNDS)
