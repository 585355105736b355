#!/usr/bin/env python3
"""Bisect the port's fused kernel with its probe kernels P1-P3 on one CUDA
card: the port of `scripts/bisect_stage{1,2,3}.py`.

    python3 scripts/torch_bisect.py --stage 1|2|3
    mkdir -p build/probes_old
    git show 73328fc:robocheck_tpu_torch/csrc/stage_probes.cu > build/probes_old/stage_probes.cu
    python3 scripts/torch_bisect.py --stage 1|2|3 --old build/probes_old/stage_probes.cu

Stage 1 runs K1's pose pass one piece at a time on K1's launch shape (pose
load, corner transforms, tile boxes, mesh box and broad flag, c0x of every
triangle stored in K1's padded slots, the same stores with stride 32); stage
2 an empty kernel of K1's launch shape with tables, shared memory, batch and
rows per warp toggled; stage 3, on the same shape, an invariant table
bulk-copied into shared memory once per block, read from constant memory, or
read through the read-only path, one read a row. Pieces carry
the JAX scripts' names and inputs
(`robocheck_tpu_torch.profiling.probes.stage_pieces`). One JSON line per
piece: device µs per configuration by CUDA events (mean of REPS
back-to-back launches, which for a kernel of a few µs measures the host's
launch rate), the kernel's own time from a `torch.profiler` trace
(`kernel_*`, the figure to compare), the plain PyTorch version's µs per
configuration (CUDA events, mean of 2 calls), whether the two outputs are
equal, the piece's launch shape (block, shared memory, blocks per SM,
grid, registers, local bytes), P3's bound (`profiling/bounds.py`) and share,
and the card's name and power limit. Stage 1
also prints K1 and P1 level 2 on 16,384 rows at x = 1e9 (every K1 row ends
at the broad phase: what P1 level 2 does), by trace; stage 3 each P3 mode
in turns with P2's `pose_only_scratch` (K1's skeleton), whose difference is
the bulk copy's cost a launch (`manual_dma_rob`) or a row's table read.

``--old`` builds a copy of `csrc/stage_probes.cu` with the C interface of
its first design (73328fc: 256-thread blocks, one configuration a block
step, a grid-stride loop, K1's first design's shared memory; P3's
`manual_dma` on 2 x SM-count blocks copying with per-thread cp.async), with
the package's nvcc flags, and times old and new by trace in turns (old, new,
new, old) on each piece, with the old launch's shape and both builds'
ptxas lines. Exits 1 if a probe differs from its plain version. Imports
neither JAX nor the JAX package.
"""
import argparse
import ctypes
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from robocheck_tpu_torch import load_obj  # noqa: E402
from robocheck_tpu_torch.io import assets  # noqa: E402
from robocheck_tpu_torch.kernels import _build  # noqa: E402
from robocheck_tpu_torch.kernels import megakernel as mk  # noqa: E402
from robocheck_tpu_torch.profiling import bounds, probes  # noqa: E402
from robocheck_tpu_torch.profiling.timers import card_line, event_ms, kernel_ms  # noqa: E402

REPS = 20  # launches per CUDA-event mean and per traced mean
_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def ptxas_lines(log: str, names=("pose_probe", "empty_probe", "invariant")) -> list[str]:
    """The register and spill lines of the instances of ``names`` in an
    nvcc -Xptxas -v log."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            keep = any(n in line for n in names)
            if keep:
                lines.append(line.split("'")[1] if "'" in line else line.strip())
        elif keep and ("spill" in line or "registers" in line):
            lines.append(line.strip())
    return lines


def old_library(source: Path) -> tuple[ctypes.CDLL, str]:
    """The first design's probes built from ``source`` (its C interface
    bound) and the nvcc log."""
    _build.build_copies([source])
    path = _build.copy_path(source.resolve())
    lib = ctypes.CDLL(str(path))
    lib.rc_pose_probe_smem_bytes.restype = _I64
    lib.rc_pose_probe_smem_bytes.argtypes = [_I32]
    # poses, n, rob_base, tr, level, rt_false, out, smem, stream
    lib.rc_pose_probe.restype = _I32
    lib.rc_pose_probe.argtypes = [_PTR, _I64, _PTR, _I32, _I32, _I32, _PTR, _I64, _PTR]
    # poses, n, rob, rob_floats, obs, obs_floats, groups, groups_floats,
    # scratch_floats, cpb, out, stream
    lib.rc_empty_probe.restype = _I32
    lib.rc_empty_probe.argtypes = [_PTR, _I64, _PTR, _I32, _PTR, _I32, _PTR, _I32, _I32, _I32,
                                   _PTR, _PTR]
    # poses, n, table, table_floats, mode, out, smem, stream
    lib.rc_invariant_probe.restype = _I32
    lib.rc_invariant_probe.argtypes = [_PTR, _I64, _PTR, _I32, _I32, _PTR, _I64, _PTR]
    return lib, path.with_suffix(".log").read_text()


def old_call(lib: ctypes.CDLL, piece: probes.Piece):
    """(launch, shape): a piece through the first design's wrapper (one
    256-thread block per configuration step, `grid_for`'s cap of 65,535
    blocks, K1's first design's 79,936 bytes of shared memory; P3's
    `manual_dma` on 2 x SM-count blocks)."""
    a, n = piece.args, piece.n
    poses = a["poses"]
    out = torch.empty((n, probes.PROBE_COLS), dtype=torch.int32, device=poses.device)
    first_design = probes.FIRST_DESIGN_SMEM
    if piece.probe == "invariant":
        table, mode, smem = a["table"], a["mode"], first_design
        sms = torch.cuda.get_device_properties(poses.device).multi_processor_count
        blocks = min(2 * sms, n) if mode == "manual_dma" else n

        def launch():
            return lib.rc_invariant_probe(poses.data_ptr(), n, table.data_ptr(), table.numel(),
                                          probes.INVARIANT_MODES[mode], out.data_ptr(), smem,
                                          torch.cuda.current_stream().cuda_stream)
    elif piece.probe == "pose":
        rob = a["rob_base"]
        tr = rob.shape[1]
        smem = max(int(lib.rc_pose_probe_smem_bytes(tr)), first_design)
        code = 4 if a["level"] == "transposed" else a["level"]
        blocks = n

        def launch():
            return lib.rc_pose_probe(poses.data_ptr(), n, rob.data_ptr(), tr, code, 0,
                                     out.data_ptr(), smem,
                                     torch.cuda.current_stream().cuda_stream)
    else:
        tabs = [a["tables"][k] for k in ("rob", "obs", "groups") if k in a["tables"]]
        ptrs = [t.data_ptr() for t in tabs] + [None] * (3 - len(tabs))
        sizes = [t.numel() for t in tabs] + [0] * (3 - len(tabs))
        scratch = first_design // 4 // 4 * 4 if a["scratch"] else 0
        smem = 4 * (scratch + sum(sizes))
        blocks = -(-n // a["cpb"])

        def launch():
            return lib.rc_empty_probe(poses.data_ptr(), n, ptrs[0], sizes[0], ptrs[1], sizes[1],
                                      ptrs[2], sizes[2], scratch, a["cpb"], out.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)

    def run():
        err = launch()
        if err:
            raise RuntimeError(f"old {piece.name}: cudaError {err}")
        return out

    return run, {"block": 256, "smem": smem, "grid": min(blocks, 65535)}


def k1_allmiss(device, prep, card: str) -> dict:
    """K1 and P1 level 2 on 16,384 rows at x = 1e9 (`torch_roofline.py`'s
    all-miss rows) of the alpha tables, device ms by trace."""
    far = np.zeros((probes.PROBE_BATCH, 6), np.float32)
    far[:, 0] = 1.0e9
    poses = mk.poses_from_confs(torch.from_numpy(far).to(device))
    n_groups = prep.obs_groups.shape[0]
    k1 = kernel_ms(lambda: mk.check_poses_cuda(poses, prep), REPS)
    p1 = kernel_ms(lambda: probes.pose_probe_cuda(poses, prep.rob_base, 2, n_groups), REPS)
    return {"measure": "k1_allmiss_vs_mini_level2", "n": probes.PROBE_BATCH,
            "k1_kernel_ms": k1, "mini_level2_kernel_ms": p1, "card": card}


def p3_split(device, pieces, card: str) -> list[dict]:
    """Each P3 mode against P2's ``pose_only_scratch`` (K1's skeleton at K1's
    shared memory) in turns (scratch, mode, mode, scratch), device ms by
    trace: the difference is what the mode's table costs a launch, its bulk
    copy for ``manual_dma_rob``, a row's read for the other two."""
    scratch = next(p for p in probes.stage_pieces(2, device) if p.name == "pose_only_scratch")
    lines = []
    for piece in pieces:
        turns = [kernel_ms(f, REPS) for f in (scratch.kernel, piece.kernel, piece.kernel,
                                                 scratch.kernel)]
        mode, base = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        lines.append({"measure": "p3_minus_pose_only_scratch", "piece": piece.name,
                      "turns_ms_scratch_mode_mode_scratch": turns, "mode_ms": mode,
                      "scratch_ms": base, "difference_us": (mode - base) * 1e3, "card": card})
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", type=int, choices=(1, 2, 3), required=True)
    ap.add_argument("--old", type=Path, default=None,
                    help="a stage_probes.cu with the first design's C interface")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("torch_bisect: no CUDA device")
    card = card_line()
    device = torch.device("cuda", 0)
    rob_base, prep, n_groups = None, None, probes.PROBE_TR // mk.GROUP
    if args.stage == 1:
        prep = mk.MegaKernelPrep.build(load_obj(assets.alpha_robot_path()),
                                       load_obj(assets.alpha_obstacle_path())).to(device)
        rob_base, n_groups = prep.rob_base, prep.obs_groups.shape[0]
    old = old_library(args.old) if args.old is not None else None
    if old is not None:
        print(json.dumps({"ptxas_new": ptxas_lines(_build.build()["stage_probes"][1]),
                          "ptxas_old": ptxas_lines(old[1]), "card": card}), flush=True)

    failed = 0
    pieces = probes.stage_pieces(args.stage, device, rob_base, n_groups=n_groups)
    for piece in pieces:
        ms = event_ms(piece.kernel, REPS)
        k_ms = kernel_ms(piece.kernel, REPS)
        plain_ms = event_ms(piece.plain, 2)
        plain = piece.plain()
        equal = bool(torch.equal(piece.kernel(), plain))
        failed += not equal
        line = {"piece": piece.name, "us_per_conf": ms * 1e3 / piece.n,
                "kernel_us_per_conf": k_ms * 1e3 / piece.n, "kernel_ms": k_ms,
                "n": piece.n, "cpb": piece.cpb,
                "plain_us_per_conf": plain_ms * 1e3 / piece.n, "equal_to_plain": equal}
        line["shape"] = probes.launch_shape(piece)
        if piece.probe == "invariant":
            line["bound_ms"], line["bound_by"] = bounds.bound_ms(
                *bounds.probe_work(piece.name, piece.n))
            line["share"] = line["bound_ms"] / k_ms
        if old is not None:
            run_old, line["old_shape"] = old_call(old[0], piece)
            turns = [kernel_ms(f, REPS) for f in (run_old, piece.kernel, piece.kernel, run_old)]
            old_equal = bool(torch.equal(run_old(), plain))
            failed += not old_equal
            line.update(turns_ms_old_new_new_old=turns, old_kernel_ms=(turns[0] + turns[3]) / 2,
                        new_kernel_ms=(turns[1] + turns[2]) / 2, old_equal_to_plain=old_equal)
        line["card"] = card
        print(json.dumps(line), flush=True)
    if args.stage == 1:
        print(json.dumps(k1_allmiss(device, prep, card)), flush=True)
    if args.stage == 3:
        for line in p3_split(device, pieces, card):
            print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
