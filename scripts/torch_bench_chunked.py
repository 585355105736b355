#!/usr/bin/env python3
"""Oversized-mesh benchmark of the PyTorch/CUDA port: the chunked checker
with compaction on and off, on `scripts/bench_chunked.py`'s scenes and seed.

    python3 scripts/torch_bench_chunked.py [--n 8192] [--big] [--device cuda]

The default scene is an 81,920-triangle icosphere obstacle against the
80-triangle icosphere robot; ``--big`` is 20,480 triangles on both sides.
Rows: seed 7, translations uniform in [-4, 4]^3, angles uniform. For
``compact`` True and False (`ChunkedMegaKernelChecker.check_valid`, stream
chunks of 4,096 rows) it prints one JSON line: the best of 3 host-clock
times after a warm-up call (each call ends in its fetch), checks/s, valid
rows and the kernel launches of one call; then whether the two verdicts
are equal (the script fails if not), and the card's `nvidia-smi` name and
power limit. Imports neither JAX nor the JAX package.
"""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402


def scene(big: bool, n: int):
    """bench_chunked.py's meshes and rows."""
    from robocheck_tpu_torch.models.shapes import icosphere

    if big:
        robot = icosphere(5, radius=0.3, name="robot-20k")  # 20,480 triangles
        obstacle = icosphere(5, radius=1.5, name="obstacle-20k")  # 20,480
    else:
        robot = icosphere(1, radius=0.3, name="robot")  # 80
        obstacle = icosphere(6, radius=1.5, name="big-obstacle")  # 81,920
    rng = np.random.default_rng(7)
    confs = np.zeros((n, 6), np.float32)
    confs[:, 0:3] = rng.uniform(-4, 4, (n, 3))
    confs[:, 3:6] = rng.uniform(-np.pi, np.pi, (n, 3))
    return robot, obstacle, confs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--big", action="store_true",
                    help="20,480-triangle robot x 20,480-triangle obstacle")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from robocheck_tpu_torch.kernels import megakernel as mk
    from robocheck_tpu_torch.kernels.chunked import ChunkedMegaKernelChecker, make_checker
    from robocheck_tpu_torch.profiling.timers import card_line

    robot, obstacle, confs = scene(args.big, args.n)
    checker = make_checker(robot, obstacle, args.device)
    assert isinstance(checker, ChunkedMegaKernelChecker), type(checker)
    print(json.dumps({"chunk_pairs": checker.num_chunk_pairs,
                      "rob_tris": robot.num_triangles, "obs_tris": obstacle.num_triangles}),
          flush=True)
    results = {}
    for compact in (True, False):
        mk.check_poses_cuda.launches = 0
        v, _ = checker.check_valid(confs, chunk=4096, compact=compact)
        launches = mk.check_poses_cuda.launches
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            checker.check_valid(confs, chunk=4096, compact=compact)
            times.append(time.perf_counter() - t0)
        results[compact] = v
        print(json.dumps({"compact": compact, "checks_per_s": args.n / min(times),
                          "best_s": min(times), "valid": int(v.sum()),
                          "launches": launches}), flush=True)
    equal = bool((results[True] == results[False]).all())
    print(json.dumps({"verdicts_equal": equal,
                      "card": card_line() if args.device == "cuda" else "cpu"}))
    return 0 if equal else 1


if __name__ == "__main__":
    raise SystemExit(main())
