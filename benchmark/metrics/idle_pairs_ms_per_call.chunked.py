"""Device idle ms per check call in the traced slice while the chunked
checker runs its chunk pairs: the span `rc.chunked.pairs` (each chunk
pair's `rc.check.*` steps and the host combine), with what it holds. None
where the program has no such span."""
from harness.spans import idle_ms_per_call, program_spans

PAIRS = ("rc.chunked.pairs",)


def read(record):
    sl = record["slice"]
    if sl is None or not any(name in PAIRS for _, _, name in program_spans(sl["trace"])):
        return None
    return idle_ms_per_call(record, PAIRS)
