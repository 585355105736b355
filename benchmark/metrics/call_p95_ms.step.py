"""The 95th percentile of every call's round trip in the untraced window,
in ms (host clock): the tail that host stalls put on a planner's step."""
from harness.readers import call_ms


def read(record):
    return call_ms(record, 95)
