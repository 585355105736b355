#!/usr/bin/env python3
"""Full-integration run of the PyTorch port: check a configuration file
end to end with `MegaKernelChecker.check` (the stats path), or with
`--xla` the dense reference pipeline `CollisionWorld.check`, and diff
against its tags. The port of `scripts/run_integration.py` (the reference's
`Full-Integration-Test`, `test/full-integration-test.cu:652-732`, with its
FP/FN triage and the red KERNEL BROKEN banner).

    python3 scripts/torch_run_integration.py data/hard_confs10,000.conf
    python3 scripts/torch_run_integration.py --xla ...     # CollisionWorld
    python3 scripts/torch_run_integration.py --oracle ...   # re-tag with the CPU oracle
    python3 scripts/torch_run_integration.py --device cpu ...  # the kernels' twins

Prints `CheckStats.report()`, the verdict diff and one JSON line with the
card's name and power limit; exits 1 on a mismatch. Imports neither JAX nor
the JAX package.
"""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from robocheck_tpu_torch import (CollisionWorld, MegaKernelChecker, load_obj,  # noqa: E402
                                 read_conf_file)
from robocheck_tpu_torch.io import assets  # noqa: E402
from robocheck_tpu_torch.profiling.counters import CheckStats, verdict_diff  # noqa: E402
from robocheck_tpu_torch.profiling.timers import card_line  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("conf_file")
    ap.add_argument("--oracle", action="store_true",
                    help="recompute ground truth with the CPU oracle instead "
                         "of trusting the file's tags")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the CUDA kernels; cpu: their PyTorch twins")
    ap.add_argument("--xla", action="store_true",
                    help="the dense reference pipeline (CollisionWorld) instead of the "
                         "fused kernel")
    args = ap.parse_args()

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    ds = read_conf_file(args.conf_file)
    print(f"read {len(ds.confs)} configurations from {args.conf_file}")

    golden = ds.valid
    if golden is not None and ds.tags_match_header is False:
        # Stale tags (the reference's 10,000samples.conf: header counts from
        # an FCL run that was never written back to the rows).
        print(f"warning: row tags disagree with the header ({ds.num_valid} tagged "
              f"valid vs header {ds.header_valid}); treating the file as untagged "
              "and re-tagging with the oracle")
        golden = None
    if args.oracle or golden is None:
        from robocheck_tpu_torch.oracle import check_configs

        t0 = time.perf_counter()
        golden = check_configs(robot, obstacle, ds.confs)
        print(f"CPU oracle: {time.perf_counter() - t0:.2f}s")

    card = card_line() if args.device == "cuda" else "cpu (no card)"
    if args.xla:
        world = CollisionWorld(robot, obstacle, device=args.device)
        world.check(ds.confs[:64])  # warm-up
        if args.device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        valid, res = world.check(ds.confs, return_result=True)
        elapsed = time.perf_counter() - t0
        coplanar, num_pairs, broad_hit = res.coplanar, res.num_pairs, ~res.broad_valid
    else:
        checker = MegaKernelChecker(robot, obstacle, device=args.device)
        checker.check(ds.confs)  # builds and loads the kernels
        if args.device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        valid, coplanar, num_pairs, broad_hit = checker.check(ds.confs)
        elapsed = time.perf_counter() - t0

    stats = CheckStats.from_check(valid, coplanar, num_pairs, broad_hit, elapsed)
    print(stats.report())
    diff = verdict_diff(valid, golden)
    print(f"verdict diff: {diff['mismatches']} mismatches "
          f"({diff['false_positives']} FP / {diff['false_negatives']} FN)")
    print(json.dumps({"conf_file": str(args.conf_file), "device": args.device,
                      "pipeline": "xla" if args.xla else "megakernel",
                      "card": card, "n": stats.num_confs, "valid": stats.num_valid,
                      "broad_culled": stats.broad_culled,
                      "coplanar_flagged": stats.coplanar_flagged,
                      "mean_pairs_surviving": stats.mean_pairs_surviving,
                      "elapsed_s": elapsed, "checks_per_s": stats.checks_per_s,
                      "mismatches": diff["mismatches"]}))
    if diff["mismatches"]:
        print(f"  FP indices: {diff['fp_indices']}")
        print(f"  FN indices: {diff['fn_indices']}")
        print("\033[31mKERNEL BROKEN\033[0m")
        return 1
    print("all verdicts match")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
