"""Stage-isolating probes of the fused check: P1-P3.

The counterparts of the Pallas probe kernels in the JAX package's
`scripts/bisect_stage1.py` (P1), `bisect_stage2.py` (P2) and
`bisect_stage3.py` (P3), which bisect the fused kernel's fixed and per-stage
costs. Each probe has

  * a CUDA kernel in `csrc/stage_probes.cu`, launched by a ``*_cuda``
    wrapper (CUDA tensors only; it raises on anything else) that counts its
    launches in ``<wrapper>.launches``;
  * a plain PyTorch version, ``*_reference`` (any device), that computes the
    same float32 operations, so the two agree exactly.

Every probe writes int32 [B, 128] (`PROBE_COLS`), as the TPU probes do, with
casts that truncate toward zero (``.to(torch.int32)``, C's ``int(x)``).

``stage_pieces(stage, ...)`` builds the pieces each JAX script runs, under
the script's names, on the same inputs drawn from the same numpy seeds;
`scripts/torch_bisect.py` times them and `chip_smoke.py` holds each kernel
against its plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..kernels.megakernel import GROUP, poses_from_confs

PROBE_COLS = 128
# Batch and table width of the TPU probe scripts.
PROBE_BATCH = 16384
PROBE_TR = 1024
# P1 levels: 0-3 as `bisect_stage1.py:73-115`, and the triangle-major writes
# of `mini_kernel_t` (`:117-138`), code 4 in the CUDA source.
POSE_LEVELS = (0, 1, 2, 3, "transposed")
# P3 modes (`bisect_stage3.py:55-115`), by their code in the CUDA source.
INVARIANT_MODES = {"manual_dma": 0, "smem_invariant": 1, "auto": 2}
_BIG = 3.0e38


# --------------------------------------------------------------------------
# Plain PyTorch versions.
# --------------------------------------------------------------------------

def _corners(poses: torch.Tensor, rob_base: torch.Tensor) -> list[torch.Tensor]:
    """The 9 posed corner coordinates [B, Tr], c0x, c0y, ..., c2z, in the
    fused kernel's operation order (`megakernel.py:389-396`)."""
    p = [poses[:, k : k + 1] for k in range(12)]
    out = []
    for c in range(3):
        X, Y, Z = rob_base[3 * c], rob_base[3 * c + 1], rob_base[3 * c + 2]
        for k in range(3):
            out.append(p[4 * k] * X + p[4 * k + 1] * Y + p[4 * k + 2] * Z + p[4 * k + 3])
    return out


def pose_probe_acc(poses: torch.Tensor, rob_base: torch.Tensor, level) -> torch.Tensor:
    """P1's float accumulator [B, 128] before the int32 cast
    (`bisect_stage1.py:78-112, 136`). ``level`` is one of POSE_LEVELS."""
    if level not in POSE_LEVELS:
        raise ValueError(f"level must be one of {POSE_LEVELS}, got {level!r}")
    b = poses.shape[0]
    acc = poses[:, 0:1].expand(b, PROBE_COLS)
    if level == 0:
        return acc.contiguous()
    c = _corners(poses, rob_base)
    c0x = c[0][:, :PROBE_COLS]
    if level == "transposed":
        return c0x + c0x  # corners[0] + the field read back (`:136`)
    acc = acc + c0x
    if level >= 2:
        real = rob_base[9] > 0.0
        broad = torch.ones(b, dtype=torch.bool, device=poses.device)
        for k in range(3):
            lo = torch.minimum(torch.minimum(c[k], c[3 + k]), c[6 + k])
            hi = torch.maximum(torch.maximum(c[k], c[3 + k]), c[6 + k])
            mesh_lo = torch.where(real, lo, _BIG).amin(dim=1)
            mesh_hi = torch.where(real, hi, -_BIG).amax(dim=1)
            broad &= (mesh_lo <= 1.0) & (-1.0 <= mesh_hi)
        acc = acc + broad.to(acc.dtype)[:, None]
    if level >= 3:
        acc = acc + c0x  # field 0 of the first 128 triangles, read back
    return acc


def pose_probe_reference(poses: torch.Tensor, rob_base: torch.Tensor,
                         level) -> torch.Tensor:
    """P1, plain: int32 [B, 128]."""
    return pose_probe_acc(poses, rob_base, level).to(torch.int32)


def empty_probe_reference(poses: torch.Tensor) -> torch.Tensor:
    """P2, plain: int(pose0) across each row (`bisect_stage2.py:67-71`)."""
    return poses[:, 0:1].to(torch.int32).expand(poses.shape[0], PROBE_COLS).contiguous()


def invariant_probe_reference(poses: torch.Tensor, table: torch.Tensor,
                              mode: str) -> torch.Tensor:
    """P3, plain: int(pose0 * tab[0][l]) (``manual_dma``, ``auto``) or
    int(pose0 * tab[0][0]) (``smem_invariant``) (`bisect_stage3.py:56-103`)."""
    if mode not in INVARIANT_MODES:
        raise ValueError(f"mode must be one of {sorted(INVARIANT_MODES)}, got {mode!r}")
    row = table[0, 0:1] if mode == "smem_invariant" else table[0, :PROBE_COLS]
    out = (poses[:, 0:1] * row).to(torch.int32)
    return out.expand(poses.shape[0], PROBE_COLS).contiguous()


# --------------------------------------------------------------------------
# CUDA wrappers.
# --------------------------------------------------------------------------

def _require(t: torch.Tensor, name: str, device: torch.device, shape=None) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _poses(poses: torch.Tensor) -> torch.device:
    if not poses.is_cuda:
        raise ValueError(f"poses must be a CUDA tensor, got {poses.device}")
    _require(poses, "poses", poses.device, (poses.shape[0], 16))
    return poses.device


def k1_smem_bytes(tr: int = PROBE_TR, n_groups: int = PROBE_TR // GROUP) -> int:
    """Dynamic shared memory per block of the fused kernel's first design,
    whose launch shape the probes keep (`csrc/stage_probes.cu`): 19 posed
    fields per robot triangle, tile boxes, the gate's work list and
    reduction scratch, for these tables (79,936 bytes for the alpha-1.0
    pair)."""
    n_tiles = tr // 32
    return 4 * (19 * tr + 6 * n_tiles + 8 * 6 + 8 + 16 + n_tiles * n_groups + 8)


def _call(entry: str, dev: torch.device, *args) -> None:
    """Launch the C entry ``entry`` of `csrc/stage_probes.cu` on the current
    stream of ``dev``; raise on a refused launch."""
    from ..kernels import _build

    lib = _build.library("stage_probes")
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = _build.library("megakernel").rc_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} (cudaError {err})")


def _out(poses: torch.Tensor) -> torch.Tensor:
    return torch.empty((poses.shape[0], PROBE_COLS), dtype=torch.int32, device=poses.device)


def pose_probe_cuda(poses: torch.Tensor, rob_base: torch.Tensor, level) -> torch.Tensor:
    """P1 on the card: [B,16] poses, rob_base [10, Tr] -> int32 [B, 128], as
    ``pose_probe_reference``. One block per configuration with the larger of
    ``k1_smem_bytes`` and the probe's own shared memory."""
    from ..kernels import _build

    if level not in POSE_LEVELS:
        raise ValueError(f"level must be one of {POSE_LEVELS}, got {level!r}")
    dev = _poses(poses)
    tr = rob_base.shape[1]
    _require(rob_base, "rob_base", dev, (10, tr))
    if tr < PROBE_COLS or tr % GROUP:
        raise ValueError(f"rob_base needs a multiple of {GROUP} columns, got {tr}")
    need = int(_build.library("stage_probes").rc_pose_probe_smem_bytes(tr))
    smem = max(need, k1_smem_bytes(tr))
    code = 4 if level == "transposed" else level
    n, out = poses.shape[0], _out(poses)
    if n:
        _call("rc_pose_probe", dev, poses.data_ptr(), n, rob_base.data_ptr(), tr, code, 0,
              out.data_ptr(), smem)
        pose_probe_cuda.launches[level] += 1
    return out


def empty_probe_cuda(poses: torch.Tensor, tables=(), scratch: bool = False,
                     cpb: int = 1) -> torch.Tensor:
    """P2 on the card: int(pose0) across each row, after copying each table
    of ``tables`` (contiguous float32 CUDA tensors, at most three, sizes
    multiples of 4 floats) into shared memory per block step. ``scratch``
    adds ``k1_smem_bytes`` of shared memory, unused; ``cpb`` is 1 or 8
    configurations per block (one warp each)."""
    dev = _poses(poses)
    if cpb not in (1, 8):
        raise ValueError(f"cpb must be 1 or 8, got {cpb}")
    if len(tables) > 3:
        raise ValueError("at most three tables")
    ptrs, sizes = [0, 0, 0], [0, 0, 0]
    for i, t in enumerate(tables):
        _require(t, f"tables[{i}]", dev)
        if t.numel() % 4:
            raise ValueError(f"tables[{i}] must hold a multiple of 4 floats")
        ptrs[i], sizes[i] = t.data_ptr(), t.numel()
    scratch_floats = k1_smem_bytes() // 4 // 4 * 4 if scratch else 0
    n, out = poses.shape[0], _out(poses)
    if n:
        _call("rc_empty_probe", dev, poses.data_ptr(), n, ptrs[0], sizes[0], ptrs[1],
              sizes[1], ptrs[2], sizes[2], scratch_floats, cpb, out.data_ptr())
        empty_probe_cuda.launches += 1
    return out


def invariant_probe_cuda(poses: torch.Tensor, table: torch.Tensor, mode: str) -> torch.Tensor:
    """P3 on the card: as ``invariant_probe_reference``. ``manual_dma`` runs
    2 x SM-count persistent blocks that copy the whole table into shared
    memory once (cp.async); ``smem_invariant`` reads the 8 x 8 table from
    constant memory; ``auto`` reads row 0 with __ldg per configuration.
    All take 256-thread blocks and ``k1_smem_bytes`` of shared memory."""
    if mode not in INVARIANT_MODES:
        raise ValueError(f"mode must be one of {sorted(INVARIANT_MODES)}, got {mode!r}")
    dev = _poses(poses)
    _require(table, "table", dev)
    if mode == "smem_invariant" and tuple(table.shape) != (8, 8):
        raise ValueError(f"smem_invariant takes an 8 x 8 table, got {tuple(table.shape)}")
    if mode != "smem_invariant" and (table.dim() != 2 or table.shape[1] < PROBE_COLS):
        raise ValueError(f"table must be [rows, >={PROBE_COLS}], got {tuple(table.shape)}")
    smem = k1_smem_bytes()
    if mode == "manual_dma" and 4 * table.numel() > smem:
        raise ValueError(f"table of {4 * table.numel()} bytes exceeds {smem} bytes")
    n, out = poses.shape[0], _out(poses)
    if n:
        _call("rc_invariant_probe", dev, poses.data_ptr(), n, table.data_ptr(),
              table.numel(), INVARIANT_MODES[mode], out.data_ptr(), smem)
        invariant_probe_cuda.launches[mode] += 1
    return out


pose_probe_cuda.launches = dict.fromkeys(POSE_LEVELS, 0)
empty_probe_cuda.launches = 0
invariant_probe_cuda.launches = dict.fromkeys(INVARIANT_MODES, 0)


def reset_launches() -> None:
    pose_probe_cuda.launches = dict.fromkeys(POSE_LEVELS, 0)
    empty_probe_cuda.launches = 0
    invariant_probe_cuda.launches = dict.fromkeys(INVARIANT_MODES, 0)


# --------------------------------------------------------------------------
# The pieces of the three bisection scripts, on their inputs.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Piece:
    """One probe run: ``kernel()`` launches the CUDA probe, ``plain()`` runs
    its plain version on the same inputs; ``n`` configurations, ``cpb`` per
    block step (for the per-block time)."""

    name: str
    kernel: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    n: int
    cpb: int = 1


def stage1_confs(n: int = PROBE_BATCH) -> np.ndarray:
    """P1's configurations, `bisect_stage1.py:41-42`."""
    rng = np.random.default_rng(0)
    return rng.uniform(-1, 1, (PROBE_BATCH, 6)).astype(np.float32)[:n]


def stage_pieces(stage: int, device, rob_base: torch.Tensor | None = None,
                 n: int = PROBE_BATCH) -> list[Piece]:
    """The pieces of `scripts/bisect_stage{stage}.py`, with its names and on
    its inputs, as tensors on ``device``. Stage 1 poses the fused kernel's
    ``rob_base`` table (the alpha-1.0 pair's, [10, 1024]) over ``n`` rows of
    its configurations; stages 2 and 3 draw their tables and poses from
    ``default_rng(0)`` in the scripts' order (`bisect_stage2.py:32-35, 83`,
    `bisect_stage3.py:34-37`), in this package's table layout."""
    device = torch.device(device)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    if stage == 1:
        if rob_base is None:
            raise ValueError("stage 1 poses the fused kernel's rob_base table")
        poses = poses_from_confs(dev(stage1_confs(n)))
        pieces = []
        for level in POSE_LEVELS:
            name = "mini_writes_transposed" if level == "transposed" else f"mini_level{level}"
            pieces.append(Piece(
                name, lambda lv=level: pose_probe_cuda(poses, rob_base, lv),
                lambda lv=level: pose_probe_reference(poses, rob_base, lv), n))
        return pieces
    if stage == 2:
        rng = np.random.default_rng(0)
        # The script's rob_base [16, Tr], obs_t [Tr, 24] and obs_rows [6, Tr],
        # cut to this package's rob_base [10, Tr], obs [To, 20] and
        # obs_groups [To / GROUP, 6] (the last from obs_rows' first columns).
        rob = dev(rng.normal(size=(16, PROBE_TR))[:10])
        obs = dev(rng.normal(size=(PROBE_TR, 24))[:, :20])
        groups = dev(rng.normal(size=(6, PROBE_TR))[:, : PROBE_TR // GROUP].T)
        runs = [("pose_only", PROBE_BATCH, (), False, 1),
                ("pose_only_scratch", PROBE_BATCH, (), True, 1),
                ("pose+rob", PROBE_BATCH, (rob,), False, 1),
                ("pose+obs", PROBE_BATCH, (obs,), False, 1),
                ("pose+rows", PROBE_BATCH, (groups,), False, 1),
                ("all_inputs", PROBE_BATCH, (rob, obs, groups), True, 1),
                ("pose_only_B65536", 65536, (), False, 1),
                ("pose_only_B4096", 4096, (), False, 1),
                ("pose_only_cpb8", PROBE_BATCH, (), False, 8)]
        pieces = []
        for name, b, tables, scratch, cpb in runs:
            poses = dev(rng.normal(size=(b, 16)))  # drawn in the script's order
            pieces.append(Piece(
                name, lambda p=poses, t=tables, s=scratch, c=cpb: empty_probe_cuda(p, t, s, c),
                lambda p=poses: empty_probe_reference(p), b, cpb))
        return pieces
    if stage == 3:
        rng = np.random.default_rng(0)
        table = dev(rng.normal(size=(16, PROBE_TR)))
        small = dev(rng.normal(size=(8, 8)))
        poses = dev(rng.normal(size=(PROBE_BATCH, 16)))
        runs = [("manual_dma_rob", table, "manual_dma"),
                ("smem_invariant", small, "smem_invariant"),
                ("auto_invariant_vmem", table, "auto")]
        return [Piece(name, lambda t=t, m=m: invariant_probe_cuda(poses, t, m),
                      lambda t=t, m=m: invariant_probe_reference(poses, t, m), PROBE_BATCH)
                for name, t, m in runs]
    raise ValueError(f"stage must be 1, 2 or 3, got {stage!r}")
