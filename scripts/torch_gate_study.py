#!/usr/bin/env python3
"""Counts of the fused kernel's gates on real configurations: the port's
counterpart of `scripts/gate_study.py`, for the CUDA kernel's tiling.

    python3 scripts/torch_gate_study.py [--dataset hard100k ...] [--n 10000] [--device cpu]

For the alpha-1.0 pair and each ``--dataset`` (default hard100k, as
`gate_study.py:51`; any of `io.assets.DATASET_FILES`, a missing 100k set
raising with the command that makes it; the first ``--n`` rows), with the
twins' torch ops (`kernels/megakernel.py`) on ``--device`` (default the
card; it raises without one, ``--device cpu`` runs them on the host), it
prints one JSON line with, per broad-phase hit:
  * gated tile pairs (32-triangle robot tile box x 128-triangle obstacle
    group box);
  * obstacle rows surviving the two-sided gate (row box against the robot
    tile's box, within each gated tile pair), which the kernel sweeps one
    warp-wide step each;
  * box-overlapping pairs (real robot triangle), which it queues;
and, over all rows, the rows with packed bit 2 (uncertain) set, valid and
colliding, and the most box-overlapping pairs on one valid row. These are
counts, not times: the twins compute every pair, with no any-hit exit.
Imports neither JAX nor the JAX package.
"""
import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from robocheck_tpu_torch import MegaKernelChecker, load_obj, read_conf_file  # noqa: E402
from robocheck_tpu_torch.io import assets  # noqa: E402
from robocheck_tpu_torch.kernels import megakernel as mk  # noqa: E402

CHUNK = 256  # rows per step (bounds the [rows, tiles, obstacle rows] masks)


def gate_counts(poses: torch.Tensor, tables: mk.MegaKernelPrep) -> dict:
    """Per-row counts of gated tile pairs and of obstacle rows that survive
    the two-sided gate, on broad-phase hits (0 elsewhere)."""
    rob, obs, groups = tables.rob_base, tables.obs, tables.obs_groups
    real = rob[9] > 0.0
    n_tiles, n_groups = rob.shape[1] // mk.ROB_TILE, obs.shape[0] // mk.GROUP
    f = mk._posed_robot(poses, rob)
    broad = mk.mesh_broad(poses, tables)
    b = poses.shape[0]
    t_lo = torch.stack([torch.where(real, f[f"lo{k}"], mk._BIG)
                        .view(b, n_tiles, mk.ROB_TILE).amin(-1) for k in range(3)], -1)
    t_hi = torch.stack([torch.where(real, f[f"hi{k}"], -mk._BIG)
                        .view(b, n_tiles, mk.ROB_TILE).amax(-1) for k in range(3)], -1)
    gate = ((t_lo[:, :, None] <= groups[:, 3:]) & (groups[:, :3] <= t_hi[:, :, None])).all(-1)
    o_lo, o_hi = obs[:, mk._O_LO : mk._O_LO + 3], obs[:, mk._O_HI : mk._O_HI + 3]
    touch = ((t_lo[:, :, None] <= o_hi) & (o_lo <= t_hi[:, :, None])).all(-1)
    rows = touch.view(b, n_tiles, n_groups, mk.GROUP).sum(-1) * gate
    return {"broad": broad, "gated": gate.sum((1, 2)) * broad,
            "survivors": rows.sum((1, 2)) * broad}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", nargs="+", default=["hard100k"],
                    choices=sorted(assets.DATASET_FILES))
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_gate_study: no CUDA device")
    checker = MegaKernelChecker(load_obj(assets.alpha_robot_path()),
                                load_obj(assets.alpha_obstacle_path()), device=device)
    tables = checker.tables
    for key in dict.fromkeys(args.dataset):
        confs = read_conf_file(assets.dataset_path(key)).confs[: args.n]
        poses = mk.poses_from_confs(torch.from_numpy(confs).to(device))
        sums = dict.fromkeys(("broad", "gated", "survivors", "pairs", "unc_valid",
                              "unc_colliding"), 0)
        max_valid_pairs = 0
        for lo in range(0, len(confs), CHUNK):
            p = poses[lo : lo + CHUNK]
            g = gate_counts(p, tables)
            stats = mk.check_poses_stats_reference(p, tables)
            packed = mk.check_poses_reference(p, tables)
            valid, unc = (packed & 1) == 1, (packed & 4) > 0
            sums["broad"] += int(g["broad"].sum())
            sums["gated"] += int(g["gated"].sum())
            sums["survivors"] += int(g["survivors"].sum())
            sums["pairs"] += int(stats[:, 2].sum())
            sums["unc_valid"] += int((unc & valid).sum())
            sums["unc_colliding"] += int((unc & ~valid).sum())
            if valid.any():
                max_valid_pairs = max(max_valid_pairs, int(stats[valid, 2].max()))
        bh = max(sums["broad"], 1)
        print(json.dumps({
            "set": key, "n": len(confs), "device": str(device), "broad_hits": sums["broad"],
            "gated_tile_pairs_per_hit": sums["gated"] / bh,
            "surviving_rows_per_hit": sums["survivors"] / bh,
            "surviving_rows_per_gated_tile_pair": sums["survivors"] / max(sums["gated"], 1),
            "box_pairs_per_hit": sums["pairs"] / bh,
            "max_box_pairs_on_a_valid_row": max_valid_pairs,
            "uncertain_valid_rows": sums["unc_valid"],
            "uncertain_colliding_rows": sums["unc_colliding"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
