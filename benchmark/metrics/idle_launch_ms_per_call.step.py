"""Device idle ms per planner step in the traced slice while the program
issues its launches: the spans `rc.check.pose` (K2) and `rc.check.kernel`
(K1 in chunks and their join)."""
from harness.spans import CHECK_LAUNCH, idle_ms_per_call


def read(record):
    return idle_ms_per_call(record, CHECK_LAUNCH)
