#!/usr/bin/env python3
"""Certify the stored alpha-1.0 paths continuously on the card: the port's
counterpart of `scripts/certify_alpha.py`.

    python3 scripts/torch_certify_alpha.py [--backend native] [--legs raw,smoothed]

Legs: `data/alpha_certified_path.npy` (the RRT-Connect path) with levels
2:8,4:10,6:12,7:14 and `data/alpha_smoothed_path.npy` with 2:8,4:10,6:12,
each through `certify_multires` with the fused check (`make_checker`) on the
card. The clearance backend is the engine on the card (default) or the
native float64 BVH on the host (``--backend native``, the cross-check).

Prints the card's name and power limit, the level reports, then one JSON
line per leg: certified, collision, num_checks (beside the JAX package's
count in `ALPHA_CCD.json`), min_clearance, min_seen_clearance,
method_floor, uncertified_steps, wall_s, the engine's stats summed over the
levels (with ``kernel_s``, the scan kernel's device seconds by CUDA events:
the representatives' ``rep_kernel_s`` plus the exact phase's
``exact_kernel_s``), the kernel's share of the wall time, and each kernel's
launches.
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
        "smoothed": ("data/alpha_smoothed_path.npy", "2:8,4:10,6:12")}
# The JAX package's counts for the same legs (ALPHA_CCD.json).
REFERENCE_CHECKS = {"raw": 1196, "smoothed": 1390}


def parse_levels(spec: str) -> tuple:
    return tuple(tuple(int(x) for x in part.split(":")) for part in spec.split(","))


def certify_leg(name: str, robot, obstacle, checker, backend: str = "engine",
                verbose: bool = True) -> dict:
    """Certify leg ``name`` (a key of LEGS) on the card; returns its
    record."""
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.kernels import clearance as kc
    from robocheck_tpu_torch.kernels import megakernel as mk
    from robocheck_tpu_torch.planner.ccd import certify_multires

    rel, levels = LEGS[name]
    path = np.load(assets.find_asset(rel))
    k1_before, kc_before = mk.check_poses_cuda.launches, kc.pair_min_cuda.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = certify_multires(robot, obstacle, path, checker, levels=parse_levels(levels),
                           verbose=verbose, backend=backend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernel_s = res.engine_stats["kernel_s"] if res.engine_stats is not None else None
    return {
        "leg": name, "waypoints": len(path), "levels": levels, "backend": backend,
        "certified": bool(res.certified), "collision": bool(res.collision),
        "num_checks": int(res.num_checks), "reference_num_checks": REFERENCE_CHECKS[name],
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_certify_alpha: no CUDA device")

    from robocheck_tpu_torch import load_obj, make_checker
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.kernels import _build
    from robocheck_tpu_torch.profiling.timers import card_line
    from robocheck_tpu_torch.runtime import native

    t0 = time.perf_counter()
    proc = native.start_build()
    print(card_line(), flush=True)
    for name in _build.build():
        _build.library(name)
    native.finish_build(proc)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    checker = make_checker(robot, obstacle)
    for name in args.legs.split(","):
        print(f"{name} leg, backend {args.backend}", flush=True)
        print(json.dumps(certify_leg(name, robot, obstacle, checker, args.backend)), flush=True)


if __name__ == "__main__":
    main()
