#!/usr/bin/env python3
"""Certify the stored alpha-1.0 paths continuously on the card, and with
``--smooth`` SQP-smooth the RRT path and certify the result: the port's
counterpart of `scripts/certify_alpha.py`.

    python3 scripts/torch_certify_alpha.py [--backend native] [--legs raw,smoothed] [--smooth]
        [--raw-levels 2:8,4:10,6:12,7:14] [--smooth-levels 2:8,4:10,6:12]
        [--record build/torch_alpha_ccd.json]

Legs: `data/alpha_certified_path.npy` (the RRT-Connect path) on
``--raw-levels`` and `data/alpha_smoothed_path.npy` on ``--smooth-levels``
(defaults those of LEGS and `certify_alpha.py:33-34`), each through
`certify_multires` with the fused check (`make_checker`) on the card. The
clearance backend is the engine on the card (default) or the native float64
BVH on the host (``--backend native``, the cross-check). ``--smooth`` runs
SQP as `certify_alpha.py:104-128` does (48 waypoints, max_outer 12, 3
penalty rounds, grid 96, margin 1.0, certify step 0.1 x the norm of the
robot's box extent, init `resample(path, 48)` of the RRT path), prints its
certificate, wall time (the 96^3 grid's own, ``grid_s``, inside
construction), outer iterations and merit, writes the smoothed trajectory to
``--out`` (`build/torch_sqp_smoothed_path.npy`) and certifies it on
``--smooth-levels`` as the leg "sqp".

Prints the card's name and power limit, the level reports, then one JSON
line per leg: certified, collision, num_checks (beside the JAX package's
count in `ALPHA_CCD.json` where it has one), min_clearance, min_seen_clearance,
method_floor, uncertified_steps, wall_s, backend, the engine's stats summed
over the levels (with ``kernel_s``, the scan kernel's device seconds by CUDA
events: the representatives' ``rep_kernel_s`` plus the exact phase's
``exact_kernel_s``), the kernel's share of the wall time, and each kernel's
launches. ``--record`` gets them as one JSON object, with
`certify_alpha.py`'s keys (raw_rrt_path, sqp_smoothed_path,
sqp_smooth_wall_s, sqp_smooth_certified; the stored smoothed file's leg as
smoothed_path), the SQP record (sqp) and the card. `ALPHA_CCD.json` is the
JAX package's receipt on a TPU and is never written.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LEGS = {"raw": ("data/alpha_certified_path.npy", "2:8,4:10,6:12,7:14"),
        "smoothed": ("data/alpha_smoothed_path.npy", "2:8,4:10,6:12"),
        "sqp": (None, "2:8,4:10,6:12")}
# The record's key of each leg (`certify_alpha.py`'s where it has the leg).
RECORD_KEYS = {"raw": "raw_rrt_path", "smoothed": "smoothed_path", "sqp": "sqp_smoothed_path"}
# The JAX package's counts on a TPU (ALPHA_CCD.json). "raw": the same file.
# "sqp": 1,390 is the count of the trajectory the TPU run's own SQP made
# inside `certify_alpha.py --smooth` (`sqp_smoothed_path`), the same
# procedure as the "sqp" leg here on another device's rounding. The stored
# `data/alpha_smoothed_path.npy` has no JAX count.
REFERENCE_CHECKS = {"raw": 1196, "smoothed": None, "sqp": 1390}
REFERENCE_OF = {"raw": "the same file", "smoothed": None,
                "sqp": "another run's trajectory: the TPU run's own SQP output"}
# The SQP settings of `certify_alpha.py:112-118` (certify_step is set from
# the robot's box in `smooth_alpha`).
SQP_SETTINGS = dict(num_waypoints=48, max_outer=12, max_penalty_rounds=3, grid_resolution=96,
                    margin=1.0)


def parse_levels(spec: str) -> tuple:
    """"2:8,4:10" -> ((2, 8), (4, 10)); ValueError unless every part is two
    integers."""
    levels = tuple(tuple(int(x) for x in part.split(":")) for part in spec.split(","))
    if any(len(level) != 2 for level in levels):
        raise ValueError(f"levels {spec!r}: each part must be refine:depth")
    return levels


def smooth_alpha(robot, obstacle, checker, mesh=None):
    """SQP smoothing of the alpha RRT path on the card, as
    `certify_alpha.py:104-128` runs it, from `resample` of
    `data/alpha_certified_path.npy` to 48 waypoints (its constraint blocks
    sharded over the ranks of ``mesh`` where one is given). Returns (the
    SQPResult, the optimizer, its record: certificate, wall time split into
    construction and `plan`, the 96^3 grid's build inside construction
    (``grid_s``), outer iterations, merit)."""
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.io.parasol import read_query
    from robocheck_tpu_torch.planner import SQPConfig, SQPOptimizer, build_distance_grid, resample

    query = read_query(assets.find_asset("models/alpha1.0/alpha.query"))
    ext = float(np.linalg.norm(robot.aabb[3:] - robot.aabb[:3]))
    cfg = SQPConfig(certify_step=0.1 * ext, **SQP_SETTINGS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # The grid SQPOptimizer would build, built here to time it alone.
    grid = build_distance_grid(obstacle, cfg.grid_resolution,
                               device="cuda" if mesh is None else mesh.device)
    torch.cuda.synchronize()
    t_grid = time.perf_counter()
    opt = SQPOptimizer(robot, obstacle, cfg, grid=grid, checker=checker, mesh=mesh)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    init = resample(np.load(assets.find_asset(LEGS["raw"][0])), 48, opt.cfg.rot_scale)
    res = opt.plan(query[0], query[1], init=init)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rec = {"sqp_smooth_certified": bool(res.certified), "sqp_smooth_wall_s": t2 - t0,
           "construct_s": t1 - t0, "grid_s": t_grid - t0, "plan_s": t2 - t1,
           "outer_iters": int(res.outer_iters),
           "merit": float(res.merit)}
    return res, opt, rec


def certify_leg(name: str, robot, obstacle, checker, backend: str = "engine",
                verbose: bool = True, path: np.ndarray | None = None, mesh=None,
                levels: str | None = None) -> dict:
    """Certify leg ``name`` (a key of LEGS) on the card; returns its
    record. ``path``: the trajectory of a leg without a file ("sqp");
    ``mesh``: shard the engine's exact pairs over its ranks; ``levels``: a
    spec as "2:8,4:10" (default the leg's in LEGS)."""
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.kernels import clearance as kc
    from robocheck_tpu_torch.kernels import megakernel as mk
    from robocheck_tpu_torch.planner.ccd import certify_multires

    rel, default_levels = LEGS[name]
    levels = levels or default_levels
    if path is None:
        path = np.load(assets.find_asset(rel))
    k1_before, kc_before = mk.check_poses_cuda.launches, kc.pair_min_cuda.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = certify_multires(robot, obstacle, path, checker, levels=parse_levels(levels),
                           verbose=verbose, backend=backend, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernel_s = res.engine_stats["kernel_s"] if res.engine_stats is not None else None
    return {
        "leg": name, "waypoints": len(path), "levels": levels, "backend": backend,
        "certified": bool(res.certified), "collision": bool(res.collision),
        "num_checks": int(res.num_checks), "reference_num_checks": REFERENCE_CHECKS[name],
        "reference_of": REFERENCE_OF[name],
        "min_clearance": float(res.min_clearance),
        "min_seen_clearance": float(res.min_seen_clearance),
        "method_floor": float(res.method_floor), "uncertified_steps": int(res.uncertified_steps),
        "wall_s": wall, "engine_stats": res.engine_stats,
        "clearance_kernel_share": None if kernel_s is None else kernel_s / wall,
        "k1_launches": mk.check_poses_cuda.launches - k1_before,
        "clearance_launches": kc.pair_min_cuda.launches - kc_before,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="engine", choices=("engine", "native"))
    ap.add_argument("--legs", default="raw,smoothed")
    ap.add_argument("--smooth", action="store_true",
                    help="also SQP-smooth the RRT path and certify the result")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "torch_sqp_smoothed_path.npy"),
                    help="where --smooth writes the smoothed trajectory")
    ap.add_argument("--raw-levels", default=LEGS["raw"][1],
                    help="levels of the raw leg, as refine:depth pairs")
    ap.add_argument("--smooth-levels", default=LEGS["smoothed"][1],
                    help="levels of the smoothed and sqp legs")
    ap.add_argument("--record", default=os.path.join(ROOT, "build", "torch_alpha_ccd.json"),
                    help="where the legs' records are written as one JSON object")
    args = ap.parse_args()
    if "sqp" in args.legs.split(","):
        ap.error("the sqp leg is the --smooth output; pass --smooth")
    levels = {"raw": args.raw_levels, "smoothed": args.smooth_levels,
              "sqp": args.smooth_levels}
    for spec in set(levels.values()):
        try:
            parse_levels(spec)
        except ValueError:
            ap.error(f"levels {spec!r} are not refine:depth pairs joined by commas")
    if not torch.cuda.is_available():
        raise SystemExit("torch_certify_alpha: no CUDA device")

    from robocheck_tpu_torch import load_obj, make_checker
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.kernels import _build
    from robocheck_tpu_torch.profiling.timers import card_line
    from robocheck_tpu_torch.runtime import native

    t0 = time.perf_counter()
    proc = native.start_build()
    card = card_line()
    print(card, flush=True)
    for name in _build.build():
        _build.library(name)
    native.finish_build(proc)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    checker = make_checker(robot, obstacle)
    record = {"description": (
        "Continuous certificates of the alpha-1.0 paths by the PyTorch/CUDA port "
        "(scripts/torch_certify_alpha.py), with certify_alpha.py's keys per leg"),
        "card": card, "backend": args.backend}

    def run(name, path=None):
        print(f"{name} leg, backend {args.backend}", flush=True)
        rec = certify_leg(name, robot, obstacle, checker, args.backend, path=path,
                          levels=levels[name])
        print(json.dumps(rec), flush=True)
        record[RECORD_KEYS[name]] = rec

    for name in args.legs.split(","):
        run(name)
    failed = None
    if args.smooth:
        res, _, rec = smooth_alpha(robot, obstacle, checker)
        print(f"SQP smoothing: certified={res.certified} after {res.outer_iters} outer "
              f"iterations in {rec['sqp_smooth_wall_s']} s (merit {res.merit})", flush=True)
        print(json.dumps(rec), flush=True)
        record.update(sqp=rec, sqp_smooth_wall_s=rec["sqp_smooth_wall_s"],
                      sqp_smooth_certified=rec["sqp_smooth_certified"])
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        np.save(args.out, res.trajectory)
        print(f"wrote {args.out}", flush=True)
        if res.certified:
            run("sqp", path=res.trajectory)
        else:
            failed = "torch_certify_alpha: the SQP-smoothed path is not certified"
    os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
    with open(args.record, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {args.record}", flush=True)
    if failed:
        raise SystemExit(failed)


if __name__ == "__main__":
    main()
