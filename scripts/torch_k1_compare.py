#!/usr/bin/env python3
"""Time two designs of the fused kernel K1 in turns, in one process on one
CUDA card: the package's `csrc/megakernel.cu` against another copy of that
source (an earlier revision), both built with the package's nvcc flags.

    mkdir -p build/k1_old
    git show <rev>:robocheck_tpu_torch/csrc/megakernel.cu > build/k1_old/megakernel.cu
    python3 scripts/torch_k1_compare.py --old build/k1_old/megakernel.cu

For the alpha-1.0 pair, at the main path's shape (10,000 pose rows in one
launch), on hard10k, easy10k, allmiss (x = 1e9: every row ends at the broad
phase) and allhit (identity translation, rotations from default_rng(0):
2,590 rows collide), it
  * checks that both designs give the same `valid` on every row without
    bit 2 in the package's design, that no row valid in the other design is
    colliding in the package's, and the same coplanar bit where both are
    valid (an older design may lack bit 2 or the interval-tie test, which
    turns a row whose only hits are ties valid with bit 2; such rows are
    counted);
  * times them by CUDA events (mean of REPS launches each) in the order old,
    new, new, old, and prints one JSON line per set with the four times, the
    new design's speed-up (old mean / new mean) and each design's share of
    the bound of the set's work (`profiling.bounds`, from the package's
    counter kernel on the same rows);
  * prints the ptxas lines (registers, spills, shared memory) of both builds
    and the package's resident blocks per SM.
Every line carries the card's name and power limit. Imports neither JAX nor
the JAX package.
"""
import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from robocheck_tpu_torch import MegaKernelChecker, load_obj, read_conf_file  # noqa: E402
from robocheck_tpu_torch.io import assets  # noqa: E402
from robocheck_tpu_torch.kernels import _build  # noqa: E402
from robocheck_tpu_torch.kernels import megakernel as mk  # noqa: E402
from robocheck_tpu_torch.profiling import bounds  # noqa: E402
from robocheck_tpu_torch.profiling.timers import card_line, event_ms  # noqa: E402

REPS = 20  # launches per CUDA-event mean


def launch(lib, poses: torch.Tensor, t: mk.MegaKernelPrep) -> torch.Tensor:
    """`rc_megakernel_check` of ``lib`` on the current stream: [B] uint8 (with
    the row counter and a null non-finite row counter where ``lib`` takes
    them)."""
    n, tr, to = poses.shape[0], t.rob_base.shape[1], t.obs.shape[0]
    out = torch.empty((n,), dtype=torch.uint8, device=poses.device)
    scratch = [torch.empty((1,), dtype=torch.int32, device=poses.device).data_ptr(), None]
    err = lib.rc_megakernel_check(poses.data_ptr(), n, t.rob_base.data_ptr(), tr,
                                  t.obs.data_ptr(), to, t.obs_mesh.data_ptr(),
                                  t.obs_groups.data_ptr(), to // mk.GROUP, out.data_ptr(),
                                  *scratch[: lib.takes_work + lib.takes_nonfinite],
                                  torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rc_megakernel_check: {lib.rc_error_string(err).decode()}")
    return out


def ptxas_lines(log: str) -> list[str]:
    return [line.strip() for line in log.splitlines()
            if any(w in line for w in ("Compiling entry", "registers", "spill"))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, help="the other copy of megakernel.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_compare: no CUDA device")
    card = card_line()
    device = torch.device("cuda", 0)

    def emit(**kw):
        print(json.dumps({**kw, "card": card}), flush=True)

    new_lib = _build.library()
    old_lib, old_log = _build.copy_library(args.old)
    emit(measure="build", old=ptxas_lines(old_log),
         new=ptxas_lines(_build.build()["megakernel"][1]),
         old_smem_bytes=int(old_lib.rc_megakernel_smem_bytes(1024, 8)),
         new_smem_bytes=int(new_lib.rc_megakernel_smem_bytes(1024, 8)),
         new_blocks_per_sm=int(new_lib.rc_megakernel_blocks_per_sm(1024, 8)))

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    checker = MegaKernelChecker(robot, obstacle, device=device)
    tables = checker.tables
    rob_np = tables.rob_base.cpu().numpy()
    n = 10000
    rng = np.random.default_rng(0)
    far = np.zeros((n, 6), np.float32)
    far[:, 0] = 1.0e9
    hit = np.zeros((n, 6), np.float32)
    hit[:, 3:6] = rng.uniform(-np.pi, np.pi, (n, 3)).astype(np.float32)
    sets = {"hard10k": read_conf_file(assets.dataset_path("hard10k")).confs,
            "easy10k": read_conf_file(assets.dataset_path("easy10k")).confs,
            "allmiss": far, "allhit": hit}
    for name, confs in sets.items():
        poses = mk.poses_from_confs(torch.from_numpy(confs[:n]).to(device))
        old = launch(old_lib, poses, tables).cpu().numpy()
        new = launch(new_lib, poses, tables).cpu().numpy()
        valid, new_valid = (old & 1) == 1, (new & 1) == 1
        # A row whose only hits the new design finds to be interval ties
        # turns valid with bit 2; every other row keeps its verdict.
        tie_free = (new & 4) == 0
        both = valid & new_valid
        same = bool(np.array_equal(valid[tie_free], new_valid[tie_free])
                    and not (valid & ~new_valid).any()
                    and np.array_equal((old[both] >> 1) & 1, (new[both] >> 1) & 1))
        if not same:
            raise SystemExit(f"torch_k1_compare: the designs disagree on {name}")
        times = []
        for lib in (old_lib, new_lib, new_lib, old_lib):
            times.append(event_ms(lambda lib=lib: launch(lib, poses, tables), REPS))
        old_ms, new_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        rows = checker.check_block(confs[:n]).cpu().numpy()
        b_ms, b_by = bounds.bound_ms(*bounds.check_work(
            rob_np, tables.obs.shape[0], tables.obs_groups.shape[0], rows))
        emit(measure=f"k1_{name}", shape=list(poses.shape), valid=int(valid.sum()),
             uncertain_valid=int(((new[new_valid] >> 2) & 1).sum()),
             turned_valid=int((new_valid & ~valid).sum()),
             ms_old_new_new_old=times, old_ms=old_ms, new_ms=new_ms, speedup=old_ms / new_ms,
             bound_ms=b_ms, bound_by=b_by, old_share_of_bound=b_ms / old_ms,
             new_share_of_bound=b_ms / new_ms)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
