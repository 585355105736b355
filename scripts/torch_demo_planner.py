#!/usr/bin/env python3
"""Planner demo of the PyTorch/CUDA port on the alpha-1.0 puzzle: batch
validation of the `alpha.query` endpoints, then batched RRT-Connect
(``--rrt``) and/or batch PRM (``--plan``) over the fused checker, each path
certified discretely.

    python3 scripts/torch_demo_planner.py --alpha --rrt --plan [--samples 4096]

The port's counterpart of `scripts/demo_planner.py` `alpha_demo`, without
its ``--ccd`` and ``--smooth`` legs (continuous certification and SQP are not
ported yet). ``--samples`` is PRM's roadmap size and sets RRT's iterations
(samples // 256, as there). For each planner it prints the checks, the
host-clock wall time and checks/s, the wall time split between the checker's
calls (`check_valid_resolved`, each ending in its fetch) and the host work
around them (sampling, kNN, the edge dict, Dijkstra, tree bookkeeping), and
the path's certificate: every row of `densify(path)` valid under
`check_valid_resolved` at 0.5x and 0.1x the robot's smallest box extent.
The last line is one JSON object of those numbers with the card's
`nvidia-smi` name and power limit. Runs on the card unless ``--device cpu``.
Imports neither JAX nor the JAX package.
"""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402


class TimedChecker:
    """A checker's ``check_valid_resolved``, timed on the host clock: calls,
    rows and seconds."""

    def __init__(self, checker):
        self.checker = checker
        self.calls = self.rows = 0
        self.seconds = 0.0

    def check_valid_resolved(self, confs):
        t0 = time.perf_counter()
        out = self.checker.check_valid_resolved(confs)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.rows += len(confs)
        return out


def certify(checker, path: np.ndarray, ext: float) -> dict:
    """Densify ``path`` at 0.5x and 0.1x ``ext`` and check every row."""
    from robocheck_tpu_torch.planner import densify

    out = {}
    for frac in (0.5, 0.1):
        dense, _ = densify(path, step=frac * ext)
        dv = checker.check_valid_resolved(dense)
        print(f"  densified at {frac}x robot extent ({len(dense)} samples): "
              f"{int(dv.sum())}/{len(dv)} collision-free"
              + ("" if dv.all() else " -> NOT certified"))
        out[f"{frac}x"] = [int(dv.sum()), len(dv)]
    return out


def run_planner(name: str, planner, query: np.ndarray, ext: float) -> dict:
    """Plan with ``planner`` (its checker a TimedChecker) and certify."""
    timed = planner.checker
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = planner.plan(query[0], query[1])
    wall = time.perf_counter() - t0
    checks = res.num_confs_checked
    rec = {"planner": name, "checks": checks, "wall_s": wall, "checks_per_s": checks / wall,
           "checker_s": timed.seconds, "host_s": wall - timed.seconds,
           "checker_calls": timed.calls, "found": res.path is not None}
    if name == "rrt":
        rec.update(nodes=res.num_nodes, iters=res.iters)
        print(f"RRT-Connect: {res.num_nodes} nodes / {res.iters} batched iters")
    else:
        rec.update(vertices=res.num_vertices, edges=res.num_edges_checked,
                   closest_to_goal=res.closest_to_goal)
        print(f"PRM: {res.num_vertices} valid vertices, {res.num_edges_checked} edges")
    print(f"  {checks} checks in {wall} s ({checks / wall} checks/s): checker "
          f"{timed.seconds} s in {timed.calls} calls, host work {wall - timed.seconds} s")
    if res.path is None:
        print("  no path")
        return rec
    rec["waypoints"] = len(res.path)
    print(f"  path with {len(res.path)} waypoints")
    rec["certified"] = certify(timed.checker, res.path, ext)
    return rec


def alpha_demo(device: str, plan: bool, samples: int, rrt: bool) -> list[dict]:
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.io.obj import load_obj
    from robocheck_tpu_torch.io.parasol import read_query
    from robocheck_tpu_torch.kernels.chunked import make_checker
    from robocheck_tpu_torch.planner import (PRMConfig, PRMPlanner, RRTConfig,
                                             RRTConnectPlanner, densify)

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    query = read_query(assets.find_asset("models/alpha1.0/alpha.query"))
    print(f"alpha query: start={query[0]}, goal={query[1]}")
    checker = make_checker(robot, obstacle, device)
    valid = checker.check_valid_resolved(query)
    print(f"start valid: {bool(valid[0])}, goal valid: {bool(valid[1])}")
    dense, _ = densify(query, step=2.0)
    dvalid = checker.check_valid_resolved(dense)
    print(f"straight-line sweep: {int(dvalid.sum())}/{len(dvalid)} samples collision-free")
    ext = float((robot.aabb[3:] - robot.aabb[:3]).min())
    records = []
    if rrt:
        planner = RRTConnectPlanner(
            robot, obstacle,
            RRTConfig(max_iters=samples // 256 or 1, batch=256, step=0.35 * ext,
                      edge_resolution=48, surface_bias=0.6),
            checker=TimedChecker(checker))
        records.append(run_planner("rrt", planner, query, ext))
    if plan:
        planner = PRMPlanner(robot, obstacle,
                             PRMConfig(num_samples=samples, k_neighbors=12, edge_resolution=32),
                             checker=TimedChecker(checker))
        records.append(run_planner("prm", planner, query, ext))
    return records


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--alpha", action="store_true", required=True,
                    help="the alpha-1.0 puzzle (the only scene of this port's demo)")
    ap.add_argument("--rrt", action="store_true", help="batched RRT-Connect")
    ap.add_argument("--plan", action="store_true", help="batch PRM")
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from robocheck_tpu_torch.profiling.timers import card_line

    card = card_line() if args.device == "cuda" else "cpu"
    print(f"device: {card}")
    records = alpha_demo(args.device, args.plan, args.samples, args.rrt)
    ok = all(r["found"] and all(v == n for v, n in r["certified"].values())
             for r in records)
    print(json.dumps({"card": card, "samples": args.samples, "planners": records, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
