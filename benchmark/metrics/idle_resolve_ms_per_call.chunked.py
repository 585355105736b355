"""Device idle ms per check call in the traced slice while the chunked
checker uploads the combined bytes and the batch and issues the float64
resolution: the span `rc.chunked.resolve`. None where the program has no
such span."""
from harness.spans import idle_ms_per_call, program_spans

RESOLVE = ("rc.chunked.resolve",)


def read(record):
    sl = record["slice"]
    if sl is None or not any(name in RESOLVE for _, _, name in program_spans(sl["trace"])):
        return None
    return idle_ms_per_call(record, RESOLVE)
