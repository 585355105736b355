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

P1-P3 run on the launch shape of the fused kernel K1 as it is built today
(512-thread blocks of 4 teams, a persistent grid, a row counter, K1's
shared-memory layout and blocks per SM; P3's layout puts its table at float
0 and moves K1's team slots past its end). Each wrapper takes its shared
memory from ``probe_smem_bytes``; ``probe_map`` replays the probes'
shared-memory maps, which ``compiled_map`` reads from the built source, and
``launch_shape`` reads a piece's launch shape on the card.

``stage_pieces(stage, ...)`` builds the pieces each JAX script runs, under
the script's names, on the same inputs drawn from the same numpy seeds;
`scripts/torch_bisect.py` times them and `chip_smoke.py` holds each kernel
against its plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from ..kernels.megakernel import GROUP, ROB_TILE, SMEM_LIMIT, poses_from_confs, smem_bytes

PROBE_COLS = 128
# Batch and table width of the TPU probe scripts.
PROBE_BATCH = 16384
PROBE_TR = 1024
# P1 levels: 0-3 as `bisect_stage1.py:73-115`, and the triangle-major writes
# of `mini_kernel_t` (`:117-138`), code 4 in the CUDA source.
POSE_LEVELS = (0, 1, 2, 3, "transposed")
# P3 modes (`bisect_stage3.py:55-115`), by their code in the CUDA source.
INVARIANT_MODES = {"manual_dma": 0, "smem_invariant": 1, "auto": 2}
# Rows of P3's table (the script's rob_base [16, Tr]), which its map holds.
INVARIANT_ROWS = 16
# The shared memory of K1's first design on the probes' tables (19 posed
# fields a robot triangle, tile boxes, the gate's work list and reduction
# scratch): what the first design's P1, P2 and P3 allocated, and what
# `scripts/torch_bisect.py --old` gives them.
FIRST_DESIGN_SMEM = 4 * (19 * PROBE_TR + 6 * (PROBE_TR // ROB_TILE) + 8 * 6 + 8 + 16
                         + (PROBE_TR // ROB_TILE) * (PROBE_TR // GROUP) + 8)
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


# K1's shared-memory layout (`Layout` in csrc/megakernel.cu), in floats: the
# block's 4 teams of 4 warps, each team's control words, and the 32 x 33-float
# tile blocks of the transposed robot table.
_K1_TEAMS = _K1_WARPS = 4
_K1_CTL_WORDS = 11
_TILE_BLOCK = ROB_TILE * 33
# The probes' map codes in csrc/stage_probes.cu, and the bit of each table.
_PROBE_CODES = {"pose": 0, "empty": 1, "invariant": 2}
_TABLE_BITS = {"rob": 1, "obs": 2, "groups": 4}


def _k1_layout(tr: int, to: int, n_groups: int) -> dict:
    """K1's `Layout` for ``tr`` robot and ``to`` obstacle rows: the field
    stride ``fs``, the table offsets and each team's offsets (``ctl[t]``,
    ``pose[t]``, ...; ``ctl[4]`` is the layout's end)."""
    n_tiles = tr // ROB_TILE
    fs = -(-n_tiles // 32) * _TILE_BLOCK
    obox = 9 * fs
    gbox = obox + 6 * to
    realw = gbox + 6 * n_groups
    row = (_K1_CTL_WORDS + 16 + 6 * n_tiles + n_tiles * n_groups
           + max(_K1_WARPS * 6 * 32, _K1_WARPS * 2 * 64))
    ctl = [realw + n_tiles + t * row for t in range(_K1_TEAMS + 1)]
    pose = [c + _K1_CTL_WORDS for c in ctl]
    tile_box = [p + 16 for p in pose]
    scratch = [b + 6 * n_tiles + n_tiles * n_groups for b in tile_box]
    return {"n_tiles": n_tiles, "fs": fs, "obox": obox, "gbox": gbox, "realw": realw,
            "ctl": ctl, "pose": pose, "tile_box": tile_box, "scratch": scratch}


def _invariant_layout(tr: int, n_groups: int) -> tuple[dict, int, int]:
    """K1's layout for P3's tables, the floats of P3's table region and how
    far P3 moves K1's team slots: the table's overhang over K1's tables."""
    L = _k1_layout(tr, n_groups * GROUP, n_groups)
    table = INVARIANT_ROWS * tr
    return L, table, max(0, table - L["ctl"][0])


def _empty_rows(cpb: int) -> int:
    """Rows in flight a block of P2: a team of 4 warps a row (cpb 1), or a
    warp a row (cpb 8)."""
    return 16 if cpb == 8 else _K1_TEAMS


def probe_map(probe: str, tr: int = PROBE_TR, n_groups: int = PROBE_TR // GROUP,
              to: int | None = None, tables=(), scratch: bool = False,
              cpb: int = 1) -> list[tuple[str, int, int]]:
    """The regions (name, first float, floats) of a probe's shared memory,
    in the order `rc_probe_map` of `csrc/stage_probes.cu` lists them.

    ``pose`` (P1): K1's layout for (``tr``, ``n_groups``): the robot table
    in K1's padded slots and the real bits, and per team its row word, pose,
    tile boxes and partial-box scratch where K1 keeps them, and its c0x field
    (one padded field) in the space of K1's obstacle and group boxes, which
    P1 does not stage. ``empty`` (P2): the ``tables`` staged (of ``rob``,
    ``obs``, ``groups``; at K1's offsets with ``scratch``, else packed in
    that order), then per row in flight its row word and pose (K1's team
    slots with ``scratch``). ``invariant`` (P3): the [16, ``tr``] table at
    float 0, the bulk copy's mbarrier (8 bytes of team 0's control words,
    past its row word), and per team its row word and pose: K1's team slots
    for (``tr``, ``n_groups``), moved past the table's end."""
    if probe == "invariant":
        L, table, shift = _invariant_layout(tr, n_groups)
        ctl = [c + shift for c in L["ctl"]]
        regions = [("table", 0, table), ("bar", (ctl[0] + 3) // 2 * 2, 2)]
        for t in range(_K1_TEAMS):
            regions += [(f"ctl{t}", ctl[t], 1), (f"pose{t}", L["pose"][t] + shift, 16)]
        return regions
    to = n_groups * GROUP if to is None else to
    L = _k1_layout(tr, to, n_groups)
    if probe == "pose":
        regions = [("rob", 0, 9 * L["fs"]), ("realw", L["realw"], L["n_tiles"])]
        for t in range(_K1_TEAMS):
            regions += [(f"ctl{t}", L["ctl"][t], 1), (f"pose{t}", L["pose"][t], 16),
                        (f"tile_box{t}", L["tile_box"][t], 6 * L["n_tiles"]),
                        (f"part{t}", L["scratch"][t], _K1_WARPS * 6 * 32),
                        (f"c0x{t}", L["obox"] + t * L["fs"], L["fs"])]
        return regions
    if probe != "empty":
        raise ValueError(f"probe must be 'pose', 'empty' or 'invariant', got {probe!r}")
    staged = [("rob", 0, 9 * L["fs"]), ("realw", L["realw"], L["n_tiles"]),
              ("obs", L["obox"], 6 * to), ("groups", L["gbox"], 6 * n_groups)]
    regions, at = [], 0
    for name, start, floats in staged:
        if ("rob" if name == "realw" else name) in tables:
            regions.append((name, start if scratch else at, floats))
            at += floats
    for r in range(_empty_rows(cpb)):
        slot, pose = (L["ctl"][r], L["pose"][r]) if scratch else (at + 17 * r, at + 17 * r + 1)
        regions += [(f"ctl{r}", slot, 1), (f"pose{r}", pose, 16)]
    return regions


def probe_smem_bytes(probe: str, tr: int = PROBE_TR, n_groups: int = PROBE_TR // GROUP,
                     to: int | None = None, tables=(), scratch: bool = False,
                     cpb: int = 1) -> int:
    """Dynamic shared memory a probe's wrapper allocates: K1's
    (`kernels/megakernel.smem_bytes`) for P1 and P2's ``scratch`` pieces, so
    that their blocks per SM are K1's; the end of `probe_map` for the other
    P2 pieces (their tables and row slots only); for P3 (``invariant``) K1's
    plus the overhang of its [16, ``tr``] table over K1's tables (85,424
    bytes on the probes' tables), the end of its map. Raises where a probe's
    map does not fit, and P3's past the card's opt-in shared memory a block
    (`megakernel.SMEM_LIMIT`)."""
    if probe == "invariant":
        L, table, shift = _invariant_layout(tr, n_groups)
        need = 4 * (L["ctl"][_K1_TEAMS] + shift)
        if need > SMEM_LIMIT:
            raise ValueError(f"P3's table of {4 * table} bytes needs {need} bytes of shared "
                             f"memory a block, past the opt-in {SMEM_LIMIT}")
        return need
    if probe == "empty" and not scratch:
        return 4 * max(start + floats
                       for _, start, floats in probe_map(probe, tr, n_groups, to, tables,
                                                         scratch, cpb))
    if probe == "empty" and (cpb != 1 or to not in (None, n_groups * GROUP)):
        raise ValueError("scratch runs K1's layout, whose slots hold 4 rows of "
                         f"{n_groups * GROUP} obstacle rows: cpb 1 and to {n_groups * GROUP} "
                         f"(got cpb {cpb}, to {to})")
    L = _k1_layout(tr, n_groups * GROUP, n_groups)
    if probe == "pose" and L["obox"] + _K1_TEAMS * L["fs"] > L["realw"]:
        raise ValueError(f"P1's c0x fields of {tr} robot triangles do not fit K1's obstacle "
                         f"boxes of {n_groups} groups")
    if probe not in ("pose", "empty"):
        raise ValueError(f"probe must be 'pose', 'empty' or 'invariant', got {probe!r}")
    return smem_bytes(tr, n_groups)


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


@functools.cache
def _k1_resident(index: int, tr: int, n_groups: int) -> int:
    """K1's resident blocks an SM on card ``index`` for these tables
    (`rc_megakernel_blocks_per_sm`): the residency P1 and P2's ``scratch``
    pieces are held to."""
    from ..kernels import _build

    with torch.cuda.device(index):
        per_sm = _build.library("megakernel").rc_megakernel_blocks_per_sm(tr, n_groups)
    if per_sm < 1:
        raise RuntimeError(f"K1 fits no block on an SM for {tr} robot triangles and "
                           f"{n_groups} obstacle groups ({per_sm})")
    return per_sm


def _work(dev: torch.device) -> torch.Tensor:
    """One int32 of device scratch: the row counter the launch zeroes."""
    return torch.empty((1,), dtype=torch.int32, device=dev)


def pose_probe_cuda(poses: torch.Tensor, rob_base: torch.Tensor, level,
                    n_groups: int = PROBE_TR // GROUP) -> torch.Tensor:
    """P1 on the card: [B,16] poses, rob_base [10, Tr] -> int32 [B, 128], as
    ``pose_probe_reference``. K1's launch shape and shared memory for
    (Tr, ``n_groups``) (`probe_smem_bytes`) and K1's blocks per SM: a team
    of 4 warps a row, lane l posing robot tile l of each block of 32 tiles
    from the table staged once per block, 4 rows in flight a block."""
    if level not in POSE_LEVELS:
        raise ValueError(f"level must be one of {POSE_LEVELS}, got {level!r}")
    dev = _poses(poses)
    tr = rob_base.shape[1]
    _require(rob_base, "rob_base", dev, (10, tr))
    if tr < PROBE_COLS or tr % GROUP:
        raise ValueError(f"rob_base needs a multiple of {GROUP} columns, got {tr}")
    smem = probe_smem_bytes("pose", tr, n_groups)
    code = 4 if level == "transposed" else level
    n, out = poses.shape[0], _out(poses)
    if n:
        _call("rc_pose_probe", dev, poses.data_ptr(), n, rob_base.data_ptr(), tr, n_groups,
              code, 0, out.data_ptr(), _work(dev).data_ptr(), smem,
              _k1_resident(dev.index, tr, n_groups))
        pose_probe_cuda.launches[level] += 1
    return out


def _empty_tables(tables) -> tuple[int, int, int]:
    """(tr, to, n_groups) of P2's layout: from the tables passed, else the
    probe scripts' widths (PROBE_TR robot and obstacle rows)."""
    n_groups = (tables["groups"].shape[0] if "groups" in tables
                else tables["obs"].shape[0] // GROUP if "obs" in tables else PROBE_TR // GROUP)
    tr = tables["rob"].shape[1] if "rob" in tables else PROBE_TR
    to = tables["obs"].shape[0] if "obs" in tables else n_groups * GROUP
    return tr, to, n_groups


def empty_probe_cuda(poses: torch.Tensor, tables=None, scratch: bool = False,
                     cpb: int = 1) -> torch.Tensor:
    """P2 on the card: int(pose0) across each row, with K1's launch shape.
    ``tables`` maps any of ``rob`` ([10, Tr] rob_base), ``obs`` ([To, 20])
    and ``groups`` ([To / 128, 6]), contiguous float32 CUDA tensors, to be
    staged once per block as K1 stages them (the robot corners transposed
    into 33-float slots, the obstacle boxes as a structure of arrays, the
    group boxes). ``scratch`` allocates K1's whole shared memory
    (`probe_smem_bytes`) and holds K1's blocks per SM, else only the tables
    and row slots, as many blocks as fit. ``cpb`` 1: a
    team of 4 warps a row, 4 rows in flight a block (K1's mapping); 8: a
    warp a row, 16 rows in flight (the mapping `csrc/megakernel.cu` measured
    and rejected)."""
    dev = _poses(poses)
    tables = dict(tables or {})
    if cpb not in (1, 8):
        raise ValueError(f"cpb must be 1 or 8, got {cpb}")
    if not set(tables) <= set(_TABLE_BITS):
        raise ValueError(f"tables are {sorted(_TABLE_BITS)}, got {sorted(tables)}")
    tr, to, n_groups = _empty_tables(tables)
    shapes = {"rob": (10, tr), "obs": (to, 20), "groups": (n_groups, 6)}
    for name, t in tables.items():
        _require(t, f"tables[{name!r}]", dev, shapes[name])
    if tr % ROB_TILE:
        raise ValueError(f"rob needs a multiple of {ROB_TILE} columns, got {tr}")
    smem = probe_smem_bytes("empty", tr, n_groups, to, tuple(tables), scratch, cpb)
    ptrs = [tables[k].data_ptr() if k in tables else None for k in ("rob", "obs", "groups")]
    n, out = poses.shape[0], _out(poses)
    if n:
        resident = _k1_resident(dev.index, tr, n_groups) if scratch else 0
        _call("rc_empty_probe", dev, poses.data_ptr(), n, ptrs[0], tr, ptrs[1], to, ptrs[2],
              n_groups, int(scratch), cpb, out.data_ptr(), _work(dev).data_ptr(), smem,
              resident)
        empty_probe_cuda.launches += 1
    return out


def invariant_probe_cuda(poses: torch.Tensor, table: torch.Tensor, mode: str) -> torch.Tensor:
    """P3 on the card: as ``invariant_probe_reference``, on K1's launch shape
    over P2's skeleton, with one table read a row. ``manual_dma`` bulk-copies
    the whole table (at most [16, PROBE_TR]) into shared memory once per
    block and reads row 0 from there; ``smem_invariant`` reads the 8 x 8
    table's first word from constant memory; ``auto`` reads row 0 through
    the read-only path. Every mode allocates ``probe_smem_bytes("invariant")``
    (the table at float 0, K1's team slots after it, K1's layout for the
    probes' tables) and holds K1's blocks per SM for those tables."""
    if mode not in INVARIANT_MODES:
        raise ValueError(f"mode must be one of {sorted(INVARIANT_MODES)}, got {mode!r}")
    dev = _poses(poses)
    _require(table, "table", dev)
    if mode == "smem_invariant" and tuple(table.shape) != (8, 8):
        raise ValueError(f"smem_invariant takes an 8 x 8 table, got {tuple(table.shape)}")
    if mode != "smem_invariant" and (table.dim() != 2 or table.shape[1] < PROBE_COLS):
        raise ValueError(f"table must be [rows, >={PROBE_COLS}], got {tuple(table.shape)}")
    tr, n_groups = PROBE_TR, PROBE_TR // GROUP
    smem = probe_smem_bytes("invariant", tr, n_groups)
    if mode == "manual_dma" and (table.numel() > INVARIANT_ROWS * tr or table.numel() % 4):
        raise ValueError(f"manual_dma copies whole float4s of at most [{INVARIANT_ROWS}, {tr}], "
                         f"got {tuple(table.shape)}")
    n, out = poses.shape[0], _out(poses)
    if n:
        _call("rc_invariant_probe", dev, poses.data_ptr(), n, table.data_ptr(), table.numel(),
              INVARIANT_MODES[mode], tr, n_groups, out.data_ptr(), _work(dev).data_ptr(), smem,
              _k1_resident(dev.index, tr, n_groups))
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
    its plain version on the same inputs; ``n`` configurations, ``cpb`` the
    script's configurations per block step (P2's ``pose_only_cpb8``: 8);
    ``probe`` (``pose``, ``empty``, ``invariant``) and ``args`` (the
    wrapper's arguments, the poses among them) say what ``kernel`` calls."""

    name: str
    kernel: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    n: int
    cpb: int = 1
    probe: str = ""
    args: dict = dataclasses.field(default_factory=dict)


def piece_layout(piece: Piece) -> dict:
    """The keyword arguments of `probe_map` and `probe_smem_bytes` for a
    piece: its tables' widths and, for P2, its switches."""
    a = piece.args
    if piece.probe == "pose":
        return {"tr": a["rob_base"].shape[1], "n_groups": a["n_groups"]}
    if piece.probe == "invariant":
        return {"tr": PROBE_TR, "n_groups": PROBE_TR // GROUP}
    if piece.probe == "empty":
        tr, to, n_groups = _empty_tables(a["tables"])
        return {"tr": tr, "n_groups": n_groups, "to": to, "tables": tuple(a["tables"]),
                "scratch": a["scratch"], "cpb": a["cpb"]}
    raise ValueError(f"no K1-shaped launch for probe {piece.probe!r}")


def _piece_launch(piece: Piece) -> tuple[int, int, int, int]:
    """(map code, variant, shared-memory bytes, blocks an SM held to) of a
    piece's launch on its poses' card."""
    lay = piece_layout(piece)
    a = piece.args
    if piece.probe == "pose":
        variant = 4 if a["level"] == "transposed" else a["level"]
    elif piece.probe == "invariant":
        variant = INVARIANT_MODES[a["mode"]]
    else:
        variant = a["cpb"]
    held = piece.probe != "empty" or lay["scratch"]
    resident = _k1_resident(a["poses"].device.index, lay["tr"], lay["n_groups"]) if held else 0
    return _PROBE_CODES[piece.probe], variant, probe_smem_bytes(piece.probe, **lay), resident


def launch_shape(piece: Piece) -> dict:
    """A piece's launch shape on the current card, as its launch computes it
    (`rc_probe_shape`): block, shared memory, blocks per SM from the
    occupancy query (under the carveout that holds K1's residency, for P1,
    P3 and P2's ``scratch`` pieces), grid, and the instance's registers and
    local (spill and stack) bytes."""
    from ..kernels import _build

    code, variant, smem, resident = _piece_launch(piece)
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(piece.args["poses"].device):
        err = _build.library("stage_probes").rc_probe_shape(code, variant, piece.n, smem,
                                                            resident, out)
    if err:
        raise RuntimeError(f"rc_probe_shape failed for {piece.name} (cudaError {err})")
    return dict(zip(("block", "smem", "blocks_per_sm", "grid", "registers", "local_bytes"),
                    list(out)))


def compiled_map(piece: Piece) -> list[tuple[int, int]]:
    """The (first float, floats) regions of a piece's shared memory as the
    built `csrc/stage_probes.cu` lays them out (`rc_probe_map`), to
    hold against `probe_map`."""
    from ..kernels import _build

    lay = piece_layout(piece)
    bits = sum(_TABLE_BITS[k] for k in lay.get("tables", ()))
    cap = 64
    out = (ctypes.c_int * (2 * cap))()
    k = _build.library("stage_probes").rc_probe_map(
        _PROBE_CODES[piece.probe], lay["tr"], lay.get("to", 0), lay["n_groups"], bits,
        int(lay.get("scratch", False)), lay.get("cpb", 1), out, cap)
    if not 0 <= k <= cap:
        raise RuntimeError(f"rc_probe_map refused {piece.name} ({k})")
    return [(out[2 * i], out[2 * i + 1]) for i in range(k)]


def stage1_confs(n: int = PROBE_BATCH) -> np.ndarray:
    """P1's configurations, `bisect_stage1.py:41-42`."""
    rng = np.random.default_rng(0)
    return rng.uniform(-1, 1, (PROBE_BATCH, 6)).astype(np.float32)[:n]


def stage_pieces(stage: int, device, rob_base: torch.Tensor | None = None,
                 n: int = PROBE_BATCH, n_groups: int = PROBE_TR // GROUP) -> list[Piece]:
    """The pieces of `scripts/bisect_stage{stage}.py`, with its names and on
    its inputs, as tensors on ``device``. Stage 1 poses the fused kernel's
    ``rob_base`` table (the alpha-1.0 pair's, [10, 1024]) over ``n`` rows of
    its configurations, in K1's layout for ``n_groups`` obstacle groups (the
    alpha obstacle's 8); stages 2 and 3 draw their tables and poses from
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
                name, lambda lv=level: pose_probe_cuda(poses, rob_base, lv, n_groups),
                lambda lv=level: pose_probe_reference(poses, rob_base, lv), n, 1, "pose",
                {"poses": poses, "rob_base": rob_base, "level": level, "n_groups": n_groups}))
        return pieces
    if stage == 2:
        rng = np.random.default_rng(0)
        # The script's rob_base [16, Tr], obs_t [Tr, 24] and obs_rows [6, Tr],
        # cut to this package's rob_base [10, Tr], obs [To, 20] and
        # obs_groups [To / GROUP, 6] (the last from obs_rows' first columns).
        rob = dev(rng.normal(size=(16, PROBE_TR))[:10])
        obs = dev(rng.normal(size=(PROBE_TR, 24))[:, :20])
        groups = dev(rng.normal(size=(6, PROBE_TR))[:, : PROBE_TR // GROUP].T)
        runs = [("pose_only", PROBE_BATCH, {}, False, 1),
                ("pose_only_scratch", PROBE_BATCH, {}, True, 1),
                ("pose+rob", PROBE_BATCH, {"rob": rob}, False, 1),
                ("pose+obs", PROBE_BATCH, {"obs": obs}, False, 1),
                ("pose+rows", PROBE_BATCH, {"groups": groups}, False, 1),
                ("all_inputs", PROBE_BATCH, {"rob": rob, "obs": obs, "groups": groups}, True, 1),
                ("pose_only_B65536", 65536, {}, False, 1),
                ("pose_only_B4096", 4096, {}, False, 1),
                ("pose_only_cpb8", PROBE_BATCH, {}, False, 8)]
        pieces = []
        for name, b, tables, scratch, cpb in runs:
            poses = dev(rng.normal(size=(b, 16)))  # drawn in the script's order
            pieces.append(Piece(
                name, lambda p=poses, t=tables, s=scratch, c=cpb: empty_probe_cuda(p, t, s, c),
                lambda p=poses: empty_probe_reference(p), b, cpb, "empty",
                {"poses": poses, "tables": tables, "scratch": scratch, "cpb": cpb}))
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
                      lambda t=t, m=m: invariant_probe_reference(poses, t, m), PROBE_BATCH, 1,
                      "invariant", {"poses": poses, "table": t, "mode": m})
                for name, t, m in runs]
    raise ValueError(f"stage must be 1, 2 or 3, got {stage!r}")
