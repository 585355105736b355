"""The exact phase's waves (one fetch each) per clearance call over the
untraced window: the engine's `stats["waves"]` over `stats["calls"]`."""


def read(record):
    c0, c1 = record["counters"]["start"], record["counters"]["end"]
    calls = c1.get("calls", 0) - c0.get("calls", 0)
    if "waves" not in c1 or calls <= 0:
        return None
    return (c1["waves"] - c0["waves"]) / calls
