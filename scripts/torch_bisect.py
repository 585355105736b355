#!/usr/bin/env python3
"""Bisect the port's fused kernel with its probe kernels P1-P3 on one CUDA
card: the port of `scripts/bisect_stage{1,2,3}.py`.

    python3 scripts/torch_bisect.py --stage 1|2|3

Stage 1 runs K1's stage 1 one piece at a time (pose load, corner transforms,
mesh box and broad flag, the 19 posed fields written field-major, and the
same fields written triangle-major); stage 2 an empty K1-shaped grid with
tables, shared memory, batch and configurations per block toggled; stage 3
an invariant table by cp.async into shared memory, from constant memory, or
by __ldg per configuration. Pieces carry the JAX scripts' names and inputs
(`robocheck_tpu_torch.profiling.probes.stage_pieces`). One JSON line per
piece: device µs per configuration and per block step (`cpb`
configurations) by CUDA events (mean of REPS back-to-back launches, which
for a kernel of a few µs per block measures the host's launch rate), the
kernel's own time per configuration and per block step from a
`torch.profiler` trace (`kernel_*`), the plain PyTorch version's µs per
configuration (CUDA events, mean of 2 calls), whether the two outputs are
equal, and the card's name and power limit. Exits 1 if a
probe differs from its plain version. Imports neither JAX nor the JAX
package.
"""
import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from robocheck_tpu_torch import load_obj  # noqa: E402
from robocheck_tpu_torch.io import assets  # noqa: E402
from robocheck_tpu_torch.kernels.megakernel import MegaKernelPrep  # noqa: E402
from robocheck_tpu_torch.profiling import probes  # noqa: E402
from robocheck_tpu_torch.profiling.timers import card_line, event_ms, kernel_ms  # noqa: E402

REPS = 20  # launches per CUDA-event mean and per traced mean


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", type=int, choices=(1, 2, 3), required=True)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("torch_bisect: no CUDA device")
    card = card_line()
    device = torch.device("cuda", 0)
    rob_base = None
    if args.stage == 1:
        prep = MegaKernelPrep.build(load_obj(assets.alpha_robot_path()),
                                    load_obj(assets.alpha_obstacle_path())).to(device)
        rob_base = prep.rob_base

    failed = 0
    for piece in probes.stage_pieces(args.stage, device, rob_base):
        ms = event_ms(piece.kernel, REPS)
        k_ms = kernel_ms(piece.kernel, REPS)
        plain_ms = event_ms(piece.plain, 2)
        equal = bool(torch.equal(piece.kernel(), piece.plain()))
        failed += not equal
        blocks = -(-piece.n // piece.cpb)
        print(json.dumps({"piece": piece.name, "us_per_conf": ms * 1e3 / piece.n,
                          "us_per_block": ms * 1e3 / blocks,
                          "kernel_us_per_conf": k_ms * 1e3 / piece.n,
                          "kernel_us_per_block": k_ms * 1e3 / blocks,
                          "n": piece.n, "cpb": piece.cpb,
                          "plain_us_per_conf": plain_ms * 1e3 / piece.n,
                          "equal_to_plain": equal, "card": card}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
