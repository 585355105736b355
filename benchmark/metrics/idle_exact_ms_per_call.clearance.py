"""Device idle ms per clearance call in the traced slice while the engine runs
its exact waves: the spans `rc.clearance.exact` (the region that
`stats["exact_s"]` times), their fetches and scatter-min included."""
from harness.spans import CLEARANCE_EXACT, idle_ms_per_call


def read(record):
    return idle_ms_per_call(record, CLEARANCE_EXACT)
