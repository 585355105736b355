"""Entry points of the PyTorch port (the counterpart of
`__graft_entry__.py`).

``entry()``             -- (fn, example_args): fn(confs[B,6]) -> [B,8] int32
                           counter block (col 0 = valid) of the fused kernel
                           on the card.
``dryrun_multichip(n)`` -- the sharded step over n ranks (spawned processes,
                           one gloo process group): a tagged-golden hard10k
                           slice through `ShardedChecker.check_block`, the
                           packed path with a chunk smaller than the batch,
                           one waypoint-sharded SQP outer step and the
                           sharded `certify_multires` on a box/ball scene.

    python3 torch_graft_entry.py            # on the card; DRYRUN_DEVICES ranks
    python3 torch_graft_entry.py --cpu      # the kernels' twins, on the CPU

Imports neither JAX nor the JAX package.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _alpha_or_synthetic():
    """The benchmark meshes if present, otherwise synthetic stand-ins."""
    try:
        from robocheck_tpu_torch.io import assets
        from robocheck_tpu_torch.io.obj import load_obj

        return load_obj(assets.alpha_robot_path()), load_obj(assets.alpha_obstacle_path())
    except FileNotFoundError:
        from robocheck_tpu_torch.models.shapes import icosphere

        return icosphere(2, radius=1.0, name="robot"), icosphere(2, radius=1.5, name="obstacle")


def entry(device: str = "cuda"):
    """Returns (fn, example_args): fn(confs[B,6]) -> [B,8] int32 counter rows
    (col 0 = valid) of the fused kernel on ``device``."""
    from robocheck_tpu_torch.kernels.megakernel import MegaKernelChecker

    robot, obstacle = _alpha_or_synthetic()
    checker = MegaKernelChecker(robot, obstacle, device=device)

    def forward(confs):
        return checker.check_block(confs)

    confs = np.zeros((64, 6), dtype=np.float32)
    confs[:, 0] = np.linspace(-100, 100, 64, dtype=np.float32)
    return forward, (confs,)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _dryrun_rank(n_devices: int, device: str) -> dict:
    """One rank of ``dryrun_multichip``; returns its record."""
    from robocheck_tpu_torch.kernels import clearance as kc
    from robocheck_tpu_torch.kernels import megakernel as mk
    from robocheck_tpu_torch.kernels.megakernel import MegaKernelChecker
    from robocheck_tpu_torch.models.shapes import box, icosphere
    from robocheck_tpu_torch.parallel.sharding import ShardedChecker, make_mesh
    from robocheck_tpu_torch.planner.ccd import certify_multires
    from robocheck_tpu_torch.planner.sqp import SQPConfig, SQPOptimizer

    mesh = make_mesh(n_devices, device, backend="gloo")
    robot, obstacle = _alpha_or_synthetic()
    checker = ShardedChecker(robot, obstacle, mesh, device=device)
    b = 256 * n_devices  # the JAX dryrun's batch: 8 programs of 32 rows a device
    golden = None
    try:
        # A tagged-golden slice of the hard set through the whole sharded
        # step: any verdict that moves under sharding fails the dryrun.
        from robocheck_tpu_torch.io import assets
        from robocheck_tpu_torch.io.conf import read_conf_file

        ds = read_conf_file(assets.dataset_path("hard10k"))
        if ds.valid is None:
            raise FileNotFoundError("dataset untagged")
        confs, golden = ds.confs[:b], ds.valid[:b]
    except FileNotFoundError:
        confs = np.random.default_rng(0).uniform(-2, 2, size=(b, 6)).astype(np.float32)

    out, totals = checker.check_block(confs)
    valid = out[:, 0].numpy().astype(bool)
    totals = totals.numpy()
    _check(totals[0] + totals[1] == b, f"totals {totals} do not add up to {b}")
    _check(totals[0] == valid.sum(), f"valid total {totals[0]} != {valid.sum()}")
    mismatches = None
    if golden is not None:
        mismatches = int((valid != golden).sum())
        _check(mismatches == 0, f"sharded verdicts diverge from the goldens: {mismatches}/{b}")
        # The packed path, with a chunk smaller than the batch.
        v2, _ = checker.check_valid(confs, chunk=b // 4)
        _check(bool((v2 == valid).all()), "the packed sharded path diverges")

    # One SQP outer step with waypoint-sharded constraint blocks and
    # certification through the sharded checker.
    p_robot = box(extent=(0.3, 0.3, 0.3), name="p-robot")
    p_obs = icosphere(1, radius=0.6, name="p-ball")
    opt = SQPOptimizer(p_robot, p_obs,
                       SQPConfig(num_waypoints=n_devices * 2, max_outer=1, max_penalty_rounds=1,
                                 subproblem_iters=10, grid_resolution=16,
                                 num_surface_samples=32),
                       device=device, mesh=mesh)
    start = np.array([-2.0, 0, 0, 0, 0, 0], np.float32)
    goal = np.array([2.0, 0, 0, 0, 0, 0], np.float32)
    res = opt.plan(start, goal)
    _check(res.trajectory.shape == (n_devices * 2, 6), "SQP trajectory shape")

    # The continuous certifier with the engine's exact pairs sharded; the
    # path dodges the ball above z=0, so it must not be refuted.
    c_checker = MegaKernelChecker(p_robot, p_obs, device=mesh.device)
    c_path = np.array([[-2.0, 0, 0, 0, 0, 0], [0.0, 0, 1.6, 0, 0, 0], [2.0, 0, 0, 0, 0, 0]],
                      np.float32)
    sw = certify_multires(p_robot, p_obs, c_path, c_checker, levels=((0, 4), (1, 6)),
                          backend="engine", mesh=mesh)
    _check(not sw.collision, "the CCD leg refuted a clear path")
    on_card = mesh.device.type == "cuda"
    return {"rank": mesh.rank, "world": mesh.size, "rows": b, "valid": int(totals[0]),
            "colliding": int(totals[1]), "mismatches": mismatches,
            "sqp_outer_iters": int(res.outer_iters), "ccd_certified": bool(sw.certified),
            "launches": {"megakernel": mk.check_poses_cuda.launches if on_card else 0,
                         "megakernel_stats": mk.check_poses_stats_cuda.launches
                         if on_card else 0,
                         "clearance": kc.pair_min_cuda.launches if on_card else 0}}


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout: float = 600.0) -> list:
    """Run the sharded step over ``n_devices`` spawned ranks (gloo) on
    ``device``; raises if a rank fails. Returns the ranks' records."""
    from robocheck_tpu_torch.runtime.distributed import launch

    if device == "cuda":
        from robocheck_tpu_torch.kernels import _build
        from robocheck_tpu_torch.runtime.device import resolve

        resolve(device)  # raises without a card
        _build.build()  # once, here: the ranks find the libraries built
    recs = launch(_dryrun_rank, n_devices, (n_devices, device), backend="gloo",
                  timeout=timeout)
    r0 = recs[0]
    print(f"dryrun_multichip({n_devices}): ok - {r0['rows']} confs, {r0['valid']} valid / "
          f"{r0['colliding']} colliding, golden="
          f"{'checked' if r0['mismatches'] is not None else 'n/a'}, planner_step=sharded-ok, "
          f"ccd={'sharded-ok' if r0['ccd_certified'] else 'sharded-ran'}, ranks={n_devices}, "
          f"device={device}", flush=True)
    return recs


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="the kernels' twins on the CPU")
    args = ap.parse_args()
    dev = "cpu" if args.cpu else "cuda"
    fn, fn_args = entry(dev)
    out = fn(*fn_args)
    print("entry ok:", tuple(out.shape), out[:4, 0].tolist(), flush=True)
    default_n = 2 if args.cpu else torch.cuda.device_count()
    dryrun_multichip(int(os.environ.get("DRYRUN_DEVICES", default_n)), dev)
