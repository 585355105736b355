#!/usr/bin/env python3
"""One rank of a multi-process collision-check job on the PyTorch port (the
counterpart of `scripts/multihost_worker.py`).

`runtime.distributed.initialize_from_env` joins the process group
(COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID; any scheduler works),
`shard_bounds` picks this rank's contiguous rows of the dataset, and
`ShardedChecker.check_valid_distributed` checks only those:

    python3 scripts/torch_multihost_worker.py --dataset hard10k --n 256 --out v.npy
    python3 scripts/torch_multihost_worker.py --device cpu ...   # the kernels' twins

Writes this rank's verdicts to --out (np.save, bool) and prints one JSON
line. ``--scenes PATH`` also runs the sharded paths on small scenes and
saves every rank-independent result to PATH (.npz): the sphere scene of
`tests/test_sharding.py` through `check`, `check_block` and
`check_packed`; the clearance engine's distances on a three-block robot;
SQP constraint blocks, penalty total and a two-round plan on the box/ball
scene of `__graft_entry__.py`. Imports neither JAX nor the JAX package.
"""
import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# The small scenes of --scenes (tests/test_torch_sharding.py builds the same).
SPHERE_SEED, SPHERE_ROWS = 9, 64
ENGINE_SEED, ENGINE_QUERIES = 3, 16
SQP_WAYPOINTS = 7
SQP_START = np.array([-2.0, 0, 0, 0, 0, 0], np.float32)
SQP_GOAL = np.array([2.0, 0, 0, 0, 0, 0], np.float32)


def sphere_scene():
    """`tests/test_sharding.py`'s sphere world and its 64 rows."""
    from robocheck_tpu_torch.models.shapes import icosphere

    rng = np.random.default_rng(SPHERE_SEED)
    c = rng.uniform(-2, 2, size=(SPHERE_ROWS, 6)).astype(np.float32)
    c[:, 3:6] = rng.uniform(-np.pi, np.pi, (SPHERE_ROWS, 3)).astype(np.float32)
    return icosphere(1, 1.0, name="robot"), icosphere(1, 1.5, name="obstacle"), c


def engine_scene():
    """A 2,562-vertex robot (three blocks) near a 320-triangle ball."""
    from robocheck_tpu_torch.models.shapes import icosphere

    rng = np.random.default_rng(ENGINE_SEED)
    q = np.zeros((ENGINE_QUERIES, 6), np.float32)
    q[:, 0:3] = rng.uniform(-2.2, 2.2, (ENGINE_QUERIES, 3))
    q[:, 3:6] = rng.uniform(-np.pi, np.pi, (ENGINE_QUERIES, 3))
    return icosphere(4, 0.6).vertices, icosphere(2, 1.5, name="obstacle"), q


def sqp_scene(device, mesh=None):
    """The box/ball SQP of `__graft_entry__.py:120-140` and its straight-line
    init (with the seeded jitter of `SQPOptimizer.plan`)."""
    from robocheck_tpu_torch.models.shapes import box, icosphere
    from robocheck_tpu_torch.planner.sqp import SQPConfig, SQPOptimizer

    cfg = SQPConfig(num_waypoints=SQP_WAYPOINTS, max_outer=2, max_penalty_rounds=2,
                    subproblem_iters=10, grid_resolution=16, num_surface_samples=32)
    opt = SQPOptimizer(box(extent=(0.3, 0.3, 0.3), name="p-robot"),
                       icosphere(1, radius=0.6, name="p-ball"), cfg, device=device, mesh=mesh)
    t = np.linspace(0, 1, SQP_WAYPOINTS)[:, None]
    q = ((1 - t) * SQP_START[None] + t * SQP_GOAL[None]).astype(np.float32)
    q[1:-1, :3] += np.random.default_rng(cfg.seed + 1).normal(
        scale=1e-2, size=(SQP_WAYPOINTS - 2, 3)).astype(np.float32)
    return opt, q


def run_scenes(mesh, device) -> dict:
    """Every small-scene result of ``--scenes`` under ``mesh``."""
    from robocheck_tpu_torch.parallel.sharding import ShardedChecker
    from robocheck_tpu_torch.planner.clearance import ClearanceEngine

    robot, obstacle, confs = sphere_scene()
    sharded = ShardedChecker(robot, obstacle, mesh, device=device)
    out = {}
    (out["sphere_valid"], out["sphere_coplanar"], out["sphere_num_pairs"],
     out["sphere_broad"]) = sharded.check(confs, two_phase=False)
    block, totals = sharded.check_block(confs)
    out["sphere_block"], out["sphere_totals"] = block.numpy(), totals.numpy()
    out["sphere_packed37"] = sharded.check_packed(confs[:37])
    verts, obs, queries = engine_scene()
    eng = ClearanceEngine(verts, obs, device=device, mesh=mesh)
    out["engine_dist"] = eng.min_distances(queries)
    out["engine_pairs"] = np.int64(eng.stats["pairs"])
    opt, q = sqp_scene(device, mesh)
    qt = torch.from_numpy(q).to(opt.device)
    g, J, tot = opt._constraint_blocks(qt)
    out["sqp_g"], out["sqp_J"] = g.cpu().numpy(), J.cpu().numpy()
    out["sqp_total"], out["sqp_penalty"] = np.float64(tot), np.float64(opt._penalty_total(qt))
    res = opt.plan(SQP_START, SQP_GOAL)
    out["sqp_traj"], out["sqp_outer"] = res.trajectory, np.int64(res.outer_iters)
    out["sqp_merit"], out["sqp_certified"] = np.float64(res.merit), np.bool_(res.certified)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="hard10k")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the CUDA kernels; cpu: their PyTorch twins")
    ap.add_argument("--backend", default="gloo", help="the process group's backend")
    ap.add_argument("--scenes", help="also run the small scenes and save them here (.npz)")
    args = ap.parse_args()

    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.io.conf import read_conf_file
    from robocheck_tpu_torch.io.obj import load_obj
    from robocheck_tpu_torch.parallel.sharding import ShardedChecker, make_mesh
    from robocheck_tpu_torch.runtime.distributed import initialize_from_env, shard_bounds

    initialize_from_env(args.backend)
    mesh = make_mesh(device=args.device,
                     backend=args.backend if torch.distributed.is_initialized() else None)
    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    # Per-rank data loading: only this rank's contiguous rows.
    lo, hi = shard_bounds(args.n)
    local_confs = read_conf_file(assets.dataset_path(args.dataset)).confs[lo:hi]
    checker = ShardedChecker(robot, obstacle, mesh, device=args.device)
    valid, _ = checker.check_valid_distributed(local_confs, args.n)
    np.save(args.out, valid)
    if args.scenes:
        np.savez(args.scenes, **run_scenes(mesh, args.device))
    print(json.dumps({"process": mesh.rank, "process_count": mesh.size,
                      "devices": mesh.size, "local_devices": 1, "device": str(mesh.device),
                      "backend": mesh.backend, "rows": [int(lo), int(hi)],
                      "valid": int(valid.sum())}), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
