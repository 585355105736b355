"""K1's launches per check call over the untraced window: the driver's
``k1_launches`` counter (`megakernel.check_poses_cuda.launches`) over the
window's calls. None where no K1 launch was counted (the CPU twin)."""


def read(record):
    c0, c1 = record["counters"]["start"], record["counters"]["end"]
    calls = len(record["window"]["batches"])
    if "k1_launches" not in c1 or calls <= 0 or c1["k1_launches"] == c0["k1_launches"]:
        return None
    return (c1["k1_launches"] - c0["k1_launches"]) / calls
