#!/usr/bin/env python3
"""Planner demo of the PyTorch/CUDA port (the counterpart of
`scripts/demo_planner.py`).

    python3 scripts/torch_demo_planner.py [--wall] [--ccd]
    python3 scripts/torch_demo_planner.py --alpha --rrt --plan [--smooth] [--samples 4096]

The wall scene (the default, `demo_planner.py:19-56`): `plan_and_smooth`,
PRM (512 samples, 10 neighbours, 8 checks per edge) seeding the trajectory
optimizer (24 waypoints, 150 Adam steps a round, 4 rounds, margin 0.25),
certified discretely and, with ``--ccd``, continuously (`swept_certify`).

The alpha-1.0 puzzle (``--alpha``, `alpha_demo`): batch validation of the
`alpha.query` endpoints, then batched RRT-Connect (``--rrt``) and/or batch
PRM (``--plan``) over the fused checker, each path certified discretely;
with ``--rrt --smooth`` SQP smooths the RRT path (`demo_planner.py:158-185`:
48 waypoints, max_outer 12, 3 penalty rounds, grid 96, margin 1.0, certify
step 0.1 x the robot's smallest box extent) and the exact checker
re-certifies it. The alpha ``--ccd`` report is `scripts/torch_certify_alpha.py`.
``--samples`` is PRM's roadmap size and sets RRT's iterations (samples //
256, as there). For each planner it prints the checks, the host-clock wall
time and checks/s, the wall time split between the checker's calls
(`check_valid_resolved`, each ending in its fetch) and the host work around
them (sampling, kNN, the edge dict, Dijkstra, tree bookkeeping), and the
path's certificate: every row of `densify(path)` valid under
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


def run_planner(name: str, planner, query: np.ndarray, ext: float):
    """Plan with ``planner`` (its checker a TimedChecker) and certify;
    returns (its record, the path or None)."""
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
        return rec, None
    rec["waypoints"] = len(res.path)
    print(f"  path with {len(res.path)} waypoints")
    rec["certified"] = certify(timed.checker, res.path, ext)
    return rec, res.path


def wall_demo(device: str, ccd: bool = False) -> dict:
    """`plan_and_smooth` on the wall scene; returns its record."""
    from robocheck_tpu_torch.models.shapes import box, icosphere
    from robocheck_tpu_torch.planner import PRMConfig, TrajOptConfig, plan_and_smooth

    robot = icosphere(1, radius=0.3, name="robot")
    obstacle = box(extent=(0.5, 3.0, 3.0), name="wall")
    start = np.array([-3, 0, 0, 0, 0, 0], np.float32)
    goal = np.array([3, 0, 0, 0, 0, 0], np.float32)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = plan_and_smooth(
        robot, obstacle, start, goal,
        prm_config=PRMConfig(num_samples=512, k_neighbors=10, edge_resolution=8),
        opt_config=TrajOptConfig(num_waypoints=24, iters_per_round=150, max_rounds=4,
                                 margin=0.25, swept_certify=ccd),
        device=device)
    wall = time.perf_counter() - t0
    rec = {"scene": "wall", "found": res is not None, "wall_s": wall}
    if res is None:
        print("wall scene: no path found")
        return rec
    rec.update(certified=bool(res.certified), rounds=res.rounds, final_cost=res.final_cost)
    print(f"wall scene: planned in {wall} s: certified={res.certified}, rounds={res.rounds}, "
          f"cost={res.final_cost}")
    if res.swept is not None:
        sw = res.swept
        rec["swept"] = {"certified": bool(sw.certified), "collision": bool(sw.collision),
                        "min_clearance": sw.min_clearance, "method_floor": sw.method_floor,
                        "num_steps": sw.num_steps, "num_checks": sw.num_checks}
        print(f"  continuous certificate: certified={sw.certified} (min clearance "
              f"{sw.min_clearance} vs method floor {sw.method_floor}, {sw.num_steps} steps, "
              f"{sw.num_checks} exact checks)")
    np.set_printoptions(precision=2, suppress=True)
    print("  trajectory (x, y, z):")
    print(res.trajectory[:, :3])
    rec["ok"] = bool(res.certified and (not ccd or (res.swept is not None
                                                    and res.swept.certified)))
    return rec


def smooth_demo(robot, obstacle, checker, query: np.ndarray, path: np.ndarray,
                ext: float) -> dict:
    """SQP smoothing of the certified RRT path (`demo_planner.py:158-185`);
    returns its record."""
    from robocheck_tpu_torch.planner import SQPConfig, SQPOptimizer, resample

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt = SQPOptimizer(robot, obstacle,
                       SQPConfig(num_waypoints=48, max_outer=12, max_penalty_rounds=3,
                                 grid_resolution=96, margin=1.0, certify_step=0.1 * ext),
                       checker=checker, device=checker.device)
    res = opt.plan(query[0], query[1], init=resample(path, 48, opt.cfg.rot_scale))
    wall = time.perf_counter() - t0
    print(f"SQP smoothing: certified={res.certified} after {res.outer_iters} outer "
          f"iterations in {wall} s (merit {res.merit})")
    if not res.certified:
        print("  -> keeping the certified RRT path (the distance grid's cells cannot "
              "represent the passage clearance; guarantees stay with the exact checker)")
    return {"planner": "sqp", "certified_smooth": bool(res.certified), "wall_s": wall,
            "outer_iters": int(res.outer_iters), "merit": float(res.merit)}


def alpha_demo(device: str, plan: bool, samples: int, rrt: bool,
               smooth: bool = False) -> list[dict]:
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
        rec, path = run_planner("rrt", planner, query, ext)
        records.append(rec)
        if smooth and path is not None and all(v == n for v, n in rec["certified"].values()):
            records.append(smooth_demo(robot, obstacle, checker, query, path, ext))
    if plan:
        planner = PRMPlanner(robot, obstacle,
                             PRMConfig(num_samples=samples, k_neighbors=12, edge_resolution=32),
                             checker=TimedChecker(checker))
        records.append(run_planner("prm", planner, query, ext)[0])
    return records


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    scene = ap.add_mutually_exclusive_group()
    scene.add_argument("--wall", action="store_true", help="the wall scene (the default)")
    scene.add_argument("--alpha", action="store_true", help="the alpha-1.0 puzzle")
    ap.add_argument("--ccd", action="store_true",
                    help="wall scene: continuous (swept-volume) certificate")
    ap.add_argument("--rrt", action="store_true", help="alpha: batched RRT-Connect")
    ap.add_argument("--plan", action="store_true", help="alpha: batch PRM")
    ap.add_argument("--smooth", action="store_true",
                    help="with --alpha --rrt: SQP-smooth the RRT path and re-certify")
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from robocheck_tpu_torch.profiling.timers import card_line

    card = card_line() if args.device == "cuda" else "cpu"
    print(f"device: {card}")
    if not args.alpha:
        rec = wall_demo(args.device, args.ccd)
        print(json.dumps({"card": card, **rec}))
        return 0 if rec.get("ok") else 1
    records = alpha_demo(args.device, args.plan, args.samples, args.rrt, args.smooth)
    # A smoothing that does not certify keeps the RRT path and fails nothing.
    ok = all(r["found"] and all(v == n for v, n in r["certified"].values())
             for r in records if r["planner"] != "sqp")
    print(json.dumps({"card": card, "samples": args.samples, "planners": records, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
