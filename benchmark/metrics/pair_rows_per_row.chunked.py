"""Rows handed to K1 per row answered, over the untraced window: the chunked
checker's ``counters()["pair_rows"]`` (summed over its chunk pairs) over the
window's answered rows. The number of chunk pairs with ``compact`` off; a
dispatch that culls rows per chunk pair lowers it. None where the checker
has no such counter."""


def read(record):
    c0, c1 = record["counters"]["start"], record["counters"]["end"]
    rows = record["window"]["units"]
    if "pair_rows" not in c1 or "pair_rows" not in c0 or rows <= 0:
        return None
    return (c1["pair_rows"] - c0["pair_rows"]) / rows
