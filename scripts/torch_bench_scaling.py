#!/usr/bin/env python3
"""Checks/s of the sharded checker, and configurations/s of the sharded
clearance engine, at 1, 2, 4, ... ranks (the counterpart of
`scripts/bench_scaling.py`).

Each world size is a fresh set of spawned ranks in one gloo process group
(`runtime.distributed.launch`). On the card every rank shares the one
machine's cards (rank % device count); with one H100 the 2-rank run shows
the cost of sharding on one card, not scaling. ``--cpu-mesh N`` runs N gloo
ranks on the CPU with the kernels' twins (the program's structure only; the
times are not the card's).

    python3 scripts/torch_bench_scaling.py                  # 1 and 2 ranks on the card
    python3 scripts/torch_bench_scaling.py --clearance      # also the engine
    python3 scripts/torch_bench_scaling.py --cpu-mesh 2     # 2 gloo ranks on the CPU

Prints one line per world size, then one JSON line with the card's name and
power limit. Imports neither JAX nor the JAX package.
"""
import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# The clearance leg's workload, `scripts/bench_scaling.py`'s: the refine-2
# alpha robot, 64 queries.
CLEARANCE_REFINE, CLEARANCE_QUERIES = 2, 64


def check_rank(dataset: str, per_rank: int, runs: int, device: str) -> float:
    """One rank: best seconds of `ShardedChecker.check_valid` on per_rank x
    world-size rows of ``dataset`` (the ranks start and end each run
    together)."""
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.io.conf import read_conf_file
    from robocheck_tpu_torch.io.obj import load_obj
    from robocheck_tpu_torch.parallel.sharding import ShardedChecker, make_mesh
    from robocheck_tpu_torch.profiling.timers import benchmark

    mesh = make_mesh(device=device, backend="gloo")
    checker = ShardedChecker(load_obj(assets.alpha_robot_path()),
                             load_obj(assets.alpha_obstacle_path()), mesh, device=device)
    confs = np.resize(read_conf_file(assets.dataset_path(dataset)).confs,
                      (mesh.size * per_rank, 6)).astype(np.float32)
    return benchmark(checker.check_valid, confs, runs=runs)


def clearance_rank(runs: int, device: str) -> float:
    """One rank: best seconds of the sharded engine's `min_distances` on the
    refine-2 alpha robot (64 queries, seed 5, as `scripts/bench_scaling.py`)."""
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.io.obj import load_obj
    from robocheck_tpu_torch.parallel.sharding import make_mesh
    from robocheck_tpu_torch.planner.ccd import subdivide_mesh
    from robocheck_tpu_torch.planner.clearance import ClearanceEngine
    from robocheck_tpu_torch.profiling.timers import benchmark

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    queries = CLEARANCE_QUERIES
    rng = np.random.default_rng(5)
    cl = rng.uniform(-np.pi, np.pi, (queries, 6)).astype(np.float32)
    center = 0.5 * (obstacle.aabb[:3] + obstacle.aabb[3:])
    ext = obstacle.aabb[3:] - obstacle.aabb[:3]
    cl[:, 0:3] = center + rng.uniform(-0.5, 0.5, (queries, 3)) * ext
    eng = ClearanceEngine(subdivide_mesh(robot, CLEARANCE_REFINE).vertices, obstacle,
                          device=device, mesh=make_mesh(device=device, backend="gloo"))
    return benchmark(eng.min_distances, cl, runs=runs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu-mesh", type=int, default=0,
                    help="N gloo ranks on the CPU with the kernels' twins (0 = the card)")
    ap.add_argument("--dataset", default="hard10k")
    ap.add_argument("--confs-per-device", type=int, default=4096)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--clearance", action="store_true",
                    help="also scale the clearance engine's exact pair batches")
    ap.add_argument("--clearance-only", action="store_true", help="skip the checker legs")
    args = ap.parse_args()

    from robocheck_tpu_torch.profiling.timers import card_line
    from robocheck_tpu_torch.runtime.distributed import launch

    device = "cpu" if args.cpu_mesh else "cuda"
    if device == "cuda":
        from robocheck_tpu_torch.kernels import _build
        from robocheck_tpu_torch.runtime.device import resolve

        resolve(device)  # raises without a card
        _build.build()  # once, here, before the ranks start
        card = card_line()
        top = max(2, torch.cuda.device_count())
    else:
        card = "cpu (no card)"
        top = args.cpu_mesh
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= top]

    results = {}
    for n in ([] if args.clearance_only else sizes):
        secs = launch(check_rank, n, (args.dataset, args.confs_per_device, args.runs, device))
        cps = n * args.confs_per_device / max(secs)
        eff = cps / (results[1]["checks_per_s"] * n) if 1 in results else 1.0
        results[n] = {"checks_per_s": cps, "scaling_efficiency": eff}
        print(f"{n} rank(s): {cps:,.0f} checks/s, efficiency {eff:.1%} [{card}]", flush=True)

    clear = {}
    if args.clearance or args.clearance_only:
        for n in sorted({1, sizes[-1]}):
            secs = launch(clearance_rank, n, (args.runs, device))
            cps = CLEARANCE_QUERIES / max(secs)
            eff = cps / (clear[1]["clearance_configs_per_s"] * n) if 1 in clear else 1.0
            clear[n] = {"clearance_configs_per_s": cps, "scaling_efficiency": eff}
            print(f"clearance {n} rank(s): {cps:,.1f} configs/s, efficiency {eff:.1%} "
                  f"[{card}]", flush=True)

    print(json.dumps({"devices": results, "clearance_devices": clear or None,
                      "backend": device, "process_group": "gloo", "dataset": args.dataset,
                      "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
