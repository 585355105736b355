#!/usr/bin/env python3
"""Stage decomposition of the port's fused kernel on one CUDA card: the port
of `scripts/roofline.py`, with its `--chunk` and `--skip-counters`.

    python3 scripts/torch_roofline.py [--dataset hard100k easy100k] [--chunk 16384]
                                      [--skip-counters]

For the alpha-1.0 pair and each ``--dataset`` (default hard100k and
easy100k, the sets `roofline.py:73-87` measures; any of
`io.assets.DATASET_FILES`, a missing 100k set raising with the command that
makes it) it prints one JSON line per measurement, each with the card's name
and power limit. C is ``--chunk`` (default 16,384, `roofline.py:54`) and
FIRST the first dataset:
  * throughput_{dataset}: `check_valid` in launches of C rows, best of 5
    after a warm-up (host clock, synchronised), and its mismatches against
    the tags;
  * device_{FIRST,allmiss,allhit}: the packed kernel's device µs per
    configuration (CUDA events, mean of REPS launches) on FIRST's first C
    rows, on C rows at x = 1e9 (every row ends at the broad phase) and on C
    rows at the identity translation with random rotations from
    default_rng(0);
  * device_FIRST_{full,pose,nosweep,maskonly,planesonly,nodiv}: on FIRST's
    first C rows, the packed kernel, the pose stage alone (the packed
    kernel on the same rows moved 1e9 along x, so every row ends after the
    pose pass and the mesh-box broad phase) and the kernel's
    stage-isolating variants (`STAGES`); FIRST_decomposition: µs per
    configuration of pose, gate (nosweep - pose), mask (maskonly - nosweep:
    two-sided gate, box tests and compaction), planes (planesonly -
    maskonly: the plane stage and the uncertain test of queued pairs),
    interval (full - planesonly) and its divide share (full - nodiv);
  * the same on the valid rows of those C alone (device_FIRST_valid_*,
    FIRST_valid_decomposition): the variants never take the any-hit exit,
    so on colliding rows they visit tile pairs the full kernel skips, while
    on valid rows every one of them visits every gated tile pair;
  * hard_counters (unless ``--skip-counters``): the counter kernel over
    FIRST's first C rows, with the keys of `roofline.py`'s line (tile
    counts are this port's 32 x 128 tile pairs).
Imports neither JAX nor the JAX package.
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
from robocheck_tpu_torch.kernels import megakernel as mk  # noqa: E402
from robocheck_tpu_torch.profiling.timers import benchmark, card_line, event_ms  # noqa: E402

REPS = 20  # launches per CUDA-event mean


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", nargs="+", default=["hard100k", "easy100k"],
                    choices=sorted(assets.DATASET_FILES))
    ap.add_argument("--chunk", type=int, default=16384,
                    help="rows per check_valid launch and of the device measures")
    ap.add_argument("--skip-counters", action="store_true",
                    help="skip the counter kernel's pass")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_roofline: no CUDA device")
    card = card_line()
    device = torch.device("cuda", 0)

    def emit(**kw):
        print(json.dumps({**kw, "card": card}), flush=True)

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    sets = {k: read_conf_file(assets.dataset_path(k)) for k in dict.fromkeys(args.dataset)}
    checker = MegaKernelChecker(robot, obstacle, device=device)
    tables = checker.tables
    C = args.chunk

    for name, ds in sets.items():
        v, _ = checker.check_valid(ds.confs, C)
        best = benchmark(checker.check_valid, ds.confs, C)
        emit(measure=f"throughput_{name}", checks_per_s=len(ds.confs) / best,
             best_s=best, mismatches=int((v != ds.valid).sum()), chunk=C)

    first, ds = next(iter(sets.items()))
    confs, valid = ds.confs[:C], ds.valid[:C]
    n = len(confs)
    rng = np.random.default_rng(0)
    far = np.zeros((n, 6), np.float32)
    far[:, 0] = 1.0e9  # broad-phase miss: stage 1 and the epilogue only
    hit = np.zeros((n, 6), np.float32)  # identity translation: the meshes interlock
    hit[:, 3:6] = rng.uniform(-np.pi, np.pi, (n, 3)).astype(np.float32)

    def poses_of(rows):
        return mk.poses_from_confs(torch.from_numpy(rows).to(device))

    first_poses = poses_of(confs)
    for name, poses in ((first, first_poses), ("allmiss", poses_of(far)),
                        ("allhit", poses_of(hit))):
        ms = event_ms(lambda: mk.check_poses_cuda(poses, tables), REPS)
        emit(measure=f"device_{name}", n=n, checks_per_s=n / ms * 1e3, us_per_conf=ms * 1e3 / n)

    valid_rows = torch.from_numpy(valid).to(device)
    for tag, poses in ((first, first_poses), (f"{first}_valid", first_poses[valid_rows])):
        m = poses.shape[0]
        far_poses = poses.clone()
        far_poses[:, 3] += 1.0e9
        runs = {"full": lambda: mk.check_poses_cuda(poses, tables),
                "pose": lambda: mk.check_poses_cuda(far_poses, tables)}
        runs.update({stage: lambda s=stage: mk.check_poses_stage_cuda(poses, tables, s)
                     for stage in mk.STAGES})
        t = {name: event_ms(fn, REPS) * 1e3 / m for name, fn in runs.items()}
        for name, v in t.items():
            emit(measure=f"device_{tag}_{name}", n=m, us_per_conf=v)
        emit(measure=f"{tag}_decomposition", unit="us_per_conf", n=m, pose=t["pose"],
             gate=t["nosweep"] - t["pose"], mask=t["maskonly"] - t["nosweep"],
             planes=t["planesonly"] - t["maskonly"], interval=t["full"] - t["planesonly"],
             divide=t["full"] - t["nodiv"], full=t["full"])

    if not args.skip_counters:
        out = checker.check_block(confs).cpu().numpy()
        bh = out[:, 3] > 0
        emit(measure="hard_counters", set=first, n=n,
             broad_hit_rate=float(bh.mean()),
             valid_rate=float(out[:, 0].mean()),
             mean_pairs_given_bh=float(out[bh, 2].mean()),
             mean_boxtest_tiles_given_bh=float((out[bh, 4] + out[bh, 5]).mean()),
             mean_plane_tiles_given_bh=float(out[bh, 4].mean()),
             mean_interval_tiles_given_bh=float(out[bh, 6].mean()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
