"""Device idle ms per clearance call in the traced slice while the engine
runs its representatives: the span `rc.clearance.reps` (their launches and
their fetch, inside `rc.clearance.bounds`). None where the program has no
such span."""
from harness.spans import idle_ms_per_call, program_spans

REPS = ("rc.clearance.reps",)


def read(record):
    sl = record["slice"]
    if sl is None or not any(name in REPS for _, _, name in program_spans(sl["trace"])):
        return None
    return idle_ms_per_call(record, REPS)
