#!/usr/bin/env python3
"""Where the culled clearance scan's time goes, on the card.

    python3 scripts/torch_clearance_study.py

On bench.py's clearance scene (refine-4 alpha robot, 256 near-contact
queries, seed 5; `chip_smoke.py` phase 9), prints the card's name and power
limit, then for the survivor dispatch (the first 1,024 pairs that
`min_distances` launches), by CUDA events, in turns (culled, nocull, all,
g0, g0, all, nocull, culled):
  * culled: the scan as the engine runs it (slack 2 x err_bound);
  * nocull: every triangle, the instance without groups;
  * all: the culled instance with slack +inf, which keeps every group: the
    plan and task machinery at the full scan's work;
  * g0: the culled instance with slack -inf, which keeps only g0 (pass 1):
    the plan kernel's fixed cost.
The last two change which groups are scanned, so their answers are not the
scan's; they only time it. Then the culled kernel on the first 256, 1,024
and 4,096 survivor pairs (µs a pair), which tells the near pairs' latency
from throughput.
"""
from __future__ import annotations

import json
import os
import runpy
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_clearance_study: no CUDA device")
    from robocheck_tpu_torch import load_obj
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.kernels import clearance as kc
    from robocheck_tpu_torch.planner.ccd import subdivide_mesh
    from robocheck_tpu_torch.planner.clearance import PAIR_CHUNK, ClearanceEngine
    from robocheck_tpu_torch.profiling.timers import card_line, event_ms

    smoke = runpy.run_path(os.path.join(ROOT, "chip_smoke.py"), run_name="imported")
    print(card_line(), flush=True)
    device = torch.device("cuda", 0)
    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    eng = ClearanceEngine(subdivide_mesh(robot, 4).vertices, obstacle)
    confs = smoke["clearance_queries"](obstacle)
    rows, ids, slack = smoke["survivor_dispatch"](eng, confs, PAIR_CHUNK, device)

    def culled(s):
        return lambda: kc.pair_min_cuda(rows, ids, eng._blocks, eng._tab, eng._groups, s)

    runs = {"culled": culled(slack), "all": culled(float("inf")), "g0": culled(-float("inf")),
            "nocull": lambda: kc.pair_min_cuda(rows, ids, eng._blocks, eng._tab)}
    times = {name: [] for name in runs}
    for name in ("culled", "nocull", "all", "g0", "g0", "all", "nocull", "culled"):
        times[name].append(event_ms(runs[name], 10))
    print(json.dumps({"survivor_dispatch_ms": times}), flush=True)
    per_pair = {}
    for n in (256, 1024, 4096):
        r, i, s = smoke["survivor_dispatch"](eng, confs, n, device)
        ms = event_ms(lambda: kc.pair_min_cuda(r, i, eng._blocks, eng._tab, eng._groups, s), 10)
        per_pair[len(r)] = {"ms": ms, "us_a_pair": 1e3 * ms / len(r)}
    print(json.dumps({"culled_by_pairs": per_pair}), flush=True)


if __name__ == "__main__":
    main()
