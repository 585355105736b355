"""A planner step's round trip: the window's seconds over the calls
completed in it, in ms (host clock, numpy in, verdicts out; every slow call
counts in full)."""


def read(record):
    w = record["window"]
    n = len(w["call_s"])
    return w["seconds"] / n * 1e3 if n else None
