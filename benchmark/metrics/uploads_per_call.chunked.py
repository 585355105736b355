"""Copies of the batch from the host to the card per check call, over the
untraced window: the chunked checker's ``counters()["batch_uploads"]`` over
the window's calls. One where the chunk pairs share one upload; one a chunk
pair run (plus the broad phase's and the resolution's) where each pair
uploads its own. None where the checker has no such counter, or where no K1
launch was counted (the CPU twins: no batch reaches a card)."""


def read(record):
    c0, c1 = record["counters"]["start"], record["counters"]["end"]
    calls = len(record["window"]["batches"])
    if ("batch_uploads" not in c1 or "batch_uploads" not in c0 or calls <= 0
            or c1.get("k1_launches") == c0.get("k1_launches")):
        return None
    return (c1["batch_uploads"] - c0["batch_uploads"]) / calls
