"""The exact phase's (pair, vertex unit, obstacle group) scans that K3's
cull kept, as a share of all of them, over the untraced window, in %: the
engine's `counters()` "scans_kept" over "scans". None where the engine has
no such counters or the window made no scan."""


def read(record):
    c0, c1 = record["counters"]["start"], record["counters"]["end"]
    if "scans_kept" not in c1 or "scans_kept" not in c0:
        return None
    scans = c1["scans"] - c0["scans"]
    if scans <= 0:
        return None
    return 100.0 * (c1["scans_kept"] - c0["scans_kept"]) / scans
