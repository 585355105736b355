"""Device idle ms per check call in the traced slice while the program
resolves flagged rows in float64 on the host: the span `rc.check.resolve`."""
from harness.spans import CHECK_RESOLVE, idle_ms_per_call


def read(record):
    return idle_ms_per_call(record, CHECK_RESOLVE)
