"""The clearance engine's exact scan: its CUDA kernel and its PyTorch twin.

For k (configuration, vertex block) pairs, each pair's distance is

    sqrt(min over the block's vertices v and every obstacle triangle T of
         d2(R v + t, T))

with d2 the squared point-to-triangle distance of
`robocheck_tpu.planner.clearance._point_tri_d2` (Ericson 5.1.5, branch-free
region classification; the sqrt after the min selects the same minimum).
The clearance engine (`planner/clearance.py`) runs its exact phase on
1,024-vertex blocks and its representative vertices as 1-vertex blocks.

  * ``pair_min_cuda`` launches the kernel of `csrc/clearance.cu` (tensors on
    a CUDA device only; it raises on a refused launch, with no fallback):
    with ``groups`` (a ``CullGroups``) the culled instance, which skips
    obstacle groups it proves too far to hold the minimum and returns the
    same float32 bits; without, the ``nocull`` instance, which scans every
    triangle;
  * ``pair_min_reference`` is its plain PyTorch twin (any device), in the
    kernel's operation order, which the CPU tests run and `chip_smoke.py`
    holds the kernel against on the card;
  * ``cull_plan`` says, from the same inputs, which (pair, vertex unit,
    group) scans the culled instance makes: the kernel's rule in the
    kernel's float32 operations;
  * ``pair_min_planned`` is the culled instance's twin: the distances of
    the scans a plan keeps, each the full twin's, so on ``cull_plan``'s
    plan the same float32 answers as ``pair_min_reference`` (the clearance
    engine's exact phase on the CPU);
  * ``region_counts`` counts, on the same inputs, the distances that end in
    each region of the classification (those of a plan only, given one): the
    work the kernel's early exits leave, from which `chip_smoke.py` works
    out the kernel's bound.

Inputs: pose rows [k, 12] float32 (``pose_rows``: R row-major from
`ops/transform.rotation_matrices`, then t), block ids [k] int32, the block
table [nb, block, 3] float32 and the obstacle triangles [nt, 9] float32
(corners a, b, c; no padding), which the kernel takes as their
``tri_table`` [nt, 18]. An id outside [0, nb) gives NaN.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.transform import rotation_matrices

# Elements (pair x vertex x triangle) the twin materialises per step.
_TWIN_BUDGET = 1 << 21
# Where the closest point of a triangle to a point lies, in the order the
# kernel tests them (`point_tri_region_parts`, `region_counts`).
REGIONS = ("vertex a", "vertex b", "vertex c", "edge ab", "edge ac", "edge bc", "face")
# The kernel's threads per block and vertices per thread (`csrc/clearance.cu`
# kThreads, kVpt): they fix how a block's vertices fall into units.
THREADS, VERTS_PER_THREAD = 256, 4
# A triangle is thin when its height over its longest edge is at most THIN
# of that edge (zero-area ones among them). A NaN distance needs a region's
# denominator to round to 0 (b = a gives one at most points), which rounding
# makes likely only for thin triangles; the group of a thin or non-finite
# triangle is always scanned, so the cull never drops such a NaN.
THIN = 2.0 ** -12


def pose_rows(confs: torch.Tensor) -> torch.Tensor:
    """[B,6] configurations -> [B,12] rows: R row-major (the port's
    `rotation_matrices`, so sin and cos are torch's on every path), then t."""
    R = rotation_matrices(confs)
    return torch.cat([R.reshape(-1, 9), confs[:, 0:3]], dim=1).contiguous()


def _dot(u, v):
    return (u[0] * v[0] + u[1] * v[1]) + u[2] * v[2]


def _cascade(p, a, b, c):
    """The region classification of `_point_tri_d2` (`clearance.py:89-146`)
    from components (3-lists of broadcastable tensors): the edges ab, ac,
    the dot products d1..d6, the determinants (va, vb, vc) and the region
    masks (in_a, in_b, in_c, on_ab, on_ac, on_bc), each 3-term sum as
    (x + y) + z, as the kernel computes it."""
    ab = [b[i] - a[i] for i in range(3)]
    ac = [c[i] - a[i] for i in range(3)]
    ap = [p[i] - a[i] for i in range(3)]
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = [p[i] - b[i] for i in range(3)]
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = [p[i] - c[i] for i in range(3)]
    d5, d6 = _dot(ab, cp), _dot(ac, cp)

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    vc = d1 * d4 - d3 * d2
    on_ab = ~in_a & ~in_b & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    vb = d5 * d2 - d1 * d6
    on_ac = ~in_a & ~in_c & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    va = d3 * d6 - d5 * d4
    on_bc = ~in_b & ~in_c & (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    return ab, ac, (d1, d2, d3, d4, d5, d6), (va, vb, vc), (in_a, in_b, in_c, on_ab, on_ac, on_bc)


def point_tri_d2_parts(p, a, b, c) -> torch.Tensor:
    """Squared point-to-triangle distance from components: ``p``, ``a``,
    ``b``, ``c`` are 3-lists of broadcastable tensors (point, corners). The
    branch-free cascade of `_point_tri_d2` (`clearance.py:89-146`) with each
    3-term sum as (x + y) + z, as the kernel computes it."""
    ab, ac, (d1, d2, d3, d4, d5, d6), (va, vb, vc), masks = _cascade(p, a, b, c)
    in_a, in_b, in_c, on_ab, on_ac, on_bc = masks

    v_ab = d1 / torch.where(on_ab, d1 - d3, 1.0)
    v_ac = d2 / torch.where(on_ac, d2 - d6, 1.0)
    w_bc = (d4 - d3) / torch.where(on_bc, (d4 - d3) + (d5 - d6), 1.0)
    denom = (va + vb) + vc
    v_in = vb / denom
    w_in = vc / denom

    out = None
    for i in range(3):
        q = (a[i] + v_in * ab[i]) + w_in * ac[i]
        q = torch.where(on_bc, b[i] + w_bc * (c[i] - b[i]), q)
        q = torch.where(on_ac, a[i] + v_ac * ac[i], q)
        q = torch.where(on_ab, a[i] + v_ab * ab[i], q)
        q = torch.where(in_c, c[i], q)
        q = torch.where(in_b, b[i], q)
        q = torch.where(in_a, a[i], q)
        d = p[i] - q
        out = d * d if out is None else out + d * d
    return out


def point_tri_region_parts(p, a, b, c) -> torch.Tensor:
    """The region each point's closest point lies in, as an index into
    REGIONS: the first of the kernel's tests that holds (vertex a, b, c,
    then edge ab, ac, bc, else the face)."""
    masks = _cascade(p, a, b, c)[4]
    region = torch.full(masks[0].shape, len(REGIONS) - 1, dtype=torch.int64,
                        device=masks[0].device)
    for i in reversed(range(len(masks))):
        region = torch.where(masks[i], i, region)
    return region


def point_tri_d2(points: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """Squared distances of ``points`` [..., 3] to triangles ``tri`` [..., 3,
    3] (corner, xyz), broadcast over the leading dims."""
    return point_tri_d2_parts([points[..., i] for i in range(3)],
                              *([tri[..., k, i] for i in range(3)] for k in range(3)))


def _posed(rows: torch.Tensor, ids: torch.Tensor, blocks: torch.Tensor) -> list:
    """The posed vertices of pairs (ids within the table) as 3 components
    [k, block]: ((r0 x + r1 y) + r2 z) + t per axis, the kernel's order."""
    verts = blocks[ids.long()]  # [k, block, 3]
    r = rows[:, :, None]  # [k, 12, 1]
    return [((r[:, 3 * i] * verts[..., 0] + r[:, 3 * i + 1] * verts[..., 1])
             + r[:, 3 * i + 2] * verts[..., 2]) + r[:, 9 + i] for i in range(3)]


def _twin_steps(rows: torch.Tensor, ids: torch.Tensor, blocks: torch.Tensor,
                tris: torch.Tensor):
    """The twin's loop over ``k`` pairs: per step (at most _TWIN_BUDGET pair
    x vertex x triangle elements), the pairs' slice, the triangles' slice,
    their posed vertices (3 components, [kc, block, 1]) and that chunk of
    the triangles' corners (3 x 3 components, [tc]). Ids are clamped into
    the table."""
    k, nb, block, nt = rows.shape[0], blocks.shape[0], blocks.shape[1], tris.shape[0]
    ids = ids.long().clamp(0, nb - 1)
    corners = [[tris[:, 3 * c + i] for i in range(3)] for c in range(3)]
    tc = max(1, min(nt, _TWIN_BUDGET // block))
    kc = max(1, _TWIN_BUDGET // (block * tc))
    for lo in range(0, k, kc):
        p = [x[..., None] for x in _posed(rows[lo : lo + kc], ids[lo : lo + kc], blocks)]
        for t0 in range(0, nt, tc):
            ts = slice(t0, t0 + tc)
            yield slice(lo, lo + kc), ts, p, [[x[ts] for x in corner] for corner in corners]


def pair_min_reference(rows: torch.Tensor, ids: torch.Tensor, blocks: torch.Tensor,
                       tris: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, on the device of its inputs: [k]
    float32 pair distances. NaN propagates through the min, as in the
    kernel."""
    k, nb, block = rows.shape[0], blocks.shape[0], blocks.shape[1]
    if k == 0:
        return torch.full((0,), float("inf"), dtype=torch.float32, device=rows.device)
    m = torch.full((k, block), float("inf"), dtype=torch.float32, device=rows.device)
    for sl, _, p, tri in _twin_steps(rows, ids, blocks, tris):
        m[sl] = torch.minimum(m[sl], point_tri_d2_parts(p, *tri).amin(dim=-1))
    out = torch.sqrt(m.amin(dim=-1))
    out[(ids < 0) | (ids >= nb)] = float("nan")
    return out


def tri_table(tris: torch.Tensor) -> torch.Tensor:
    """The kernel's obstacle table [nt, 18] from triangles [nt, 9]: corners
    a, b, c, then the edges b - a, c - a, c - b as the twin forms them (one
    float32 difference each), so kernel and twin use the same edges."""
    a, b, c = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    return torch.cat([tris, b - a, c - a, c - b], dim=1).contiguous()


@dataclasses.dataclass(frozen=True)
class CullGroups:
    """The obstacle's triangle groups as the culled kernel reads them: group
    g holds triangles [g * size, (g + 1) * size) of the table.

    Attributes:
      boxes: [ng, 6] float32, conservative boxes (lo xyz, hi xyz).
      always: [ng] uint8, 1 where the group is scanned whatever its box says
        (it holds a triangle that can give NaN: non-finite, or thin by THIN).
      size: triangles per group.
    """

    boxes: torch.Tensor
    always: torch.Tensor
    size: int


def always_visit(tris: np.ndarray, size: int) -> np.ndarray:
    """uint8 [ceil(nt / size)]: 1 for each group of ``size`` triangles
    ([nt, 9] float32 corners) holding a non-finite triangle or one whose
    doubled area is at most THIN x its longest edge squared (in float64)."""
    t = np.asarray(tris, np.float64).reshape(-1, 3, 3)
    ab, ac, bc = t[:, 1] - t[:, 0], t[:, 2] - t[:, 0], t[:, 2] - t[:, 1]
    with np.errstate(invalid="ignore", over="ignore"):
        area2 = (np.cross(ab, ac) ** 2).sum(axis=1)
        edge2 = np.max([(e * e).sum(axis=1) for e in (ab, ac, bc)], axis=0)
        thin = ~(area2 > (THIN * THIN) * edge2 * edge2)  # a NaN counts as thin
    bad = thin | ~np.isfinite(t).all(axis=(1, 2))
    ng = math.ceil(len(t) / size)
    return np.pad(bad, (0, ng * size - len(t))).reshape(ng, size).any(axis=1).astype(np.uint8)


def make_groups(tris: torch.Tensor, size: int = 32) -> CullGroups:
    """Groups of ``size`` consecutive triangles of ``tris`` ([nt, 9] float32)
    on its device: each group's box from its corners in float64, the last
    group padded with the last triangle, inflated by what the float32
    conversion can lose (the reference engine's `_glo` / `_ghi`), and its
    ``always_visit`` flag."""
    tri = tris.detach().cpu().numpy().astype(np.float64).reshape(-1, 3, 3)
    ng = math.ceil(len(tri) / size)
    pad = np.broadcast_to(tri[-1:], (ng * size - len(tri), 3, 3))
    trig = np.concatenate([tri, pad]).reshape(ng, -1, 3)
    glo, ghi = trig.min(axis=1), trig.max(axis=1)
    infl = np.maximum(np.abs(glo), np.abs(ghi)) * (4 * float(np.finfo(np.float32).eps)) + 1e-12
    boxes = np.concatenate([glo - infl, ghi + infl], axis=1).astype(np.float32)
    return CullGroups(torch.from_numpy(boxes).to(tris.device),
                      torch.from_numpy(always_visit(tri.reshape(-1, 9), size)).to(tris.device),
                      size)


def unit_vertices(block: int) -> int:
    """Vertices of a unit, the run of a block that one team of the kernel
    holds: min(lanes, 32) x VERTS_PER_THREAD, where a pair takes ``lanes``
    threads, the least power of two holding the block VERTS_PER_THREAD to a
    thread, at most THREADS (the kernel's `lanes_for`)."""
    lanes = 1
    while lanes * VERTS_PER_THREAD < block and lanes < THREADS:
        lanes *= 2
    return min(lanes, 32) * VERTS_PER_THREAD


def _box_d2(lo, hi, glo, ghi) -> torch.Tensor:
    """Squared box distances, broadcast over the leading dims of ``lo``,
    ``hi`` ([..., 3]) and the group boxes ``glo``, ``ghi`` ([ng, 3]): the
    kernel's `box_d2`, each gap term x where x > 0 else 0."""
    def gap(x):
        return torch.where(x > 0, x, torch.zeros_like(x))

    g = gap(glo - hi) + gap(lo - ghi)
    return (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]


def cull_plan(rows: torch.Tensor, ids: torch.Tensor, blocks: torch.Tensor,
              tris: torch.Tensor, groups: CullGroups, slack: float) -> torch.Tensor:
    """The scans of the culled kernel on these inputs: bool [k, units, ng],
    True where the vertices of unit u (vertices [u x unit, (u + 1) x unit)
    of the block, ``unit_vertices``) are measured against group g's
    triangles. The kernel's rule in its float32 operations: g0, the group
    nearest the pair's box of posed vertices (the first on ties), is scanned
    by every unit (pass 1, m0 its minimum); then each unit scans every other
    group that is ``always`` or whose box distance to the unit's box is not
    above sqrt(m0) + slack (a NaN distance scans). NaN coordinates stay out
    of the boxes. Pairs whose id is outside the table scan nothing."""
    k, nb, block = rows.shape[0], blocks.shape[0], blocks.shape[1]
    nt, ng, size = tris.shape[0], groups.boxes.shape[0], groups.size
    unit = unit_vertices(block)
    units = -(-block // unit)
    plan = torch.zeros((k, units, ng), dtype=torch.bool, device=rows.device)
    if k == 0 or ng == 0:
        return plan
    glo, ghi = groups.boxes[:, 0:3], groups.boxes[:, 3:6]
    always = groups.always.bool()
    slack32 = torch.tensor(slack, dtype=torch.float32, device=rows.device)
    good = (ids >= 0) & (ids < nb)
    ids = ids.long().clamp(0, nb - 1)
    offs = torch.arange(size, device=rows.device)
    kc = max(1, _TWIN_BUDGET // (block * size))
    for lo in range(0, k, kc):
        sl = slice(lo, lo + kc)
        p = _posed(rows[sl], ids[sl], blocks)  # 3 x [kc, block]
        pts = torch.stack(p, dim=-1)  # [kc, block, 3]
        pad = torch.full((pts.shape[0], units * unit - block, 3), float("nan"),
                         device=rows.device)
        pts = torch.cat([pts, pad], dim=1).view(-1, units, unit, 3)
        inf = torch.full_like(pts, float("inf"))
        ulo = torch.where(torch.isnan(pts), inf, pts).amin(dim=2)  # [kc, units, 3]
        uhi = torch.where(torch.isnan(pts), -inf, pts).amax(dim=2)
        g0 = _box_d2(ulo.amin(dim=1)[:, None], uhi.amax(dim=1)[:, None], glo, ghi).argmin(dim=1)
        t = g0[:, None] * size + offs  # [kc, size]: g0's triangles, past nt masked
        tri = tris[t.clamp(max=nt - 1)]  # [kc, size, 9]
        d = point_tri_d2_parts([x[..., None] for x in p],
                               *([tri[:, None, :, 3 * c + i] for i in range(3)]
                                 for c in range(3)))  # [kc, block, size]
        d = torch.where((t < nt)[:, None, :], d, torch.full_like(d, float("inf")))
        thr = torch.sqrt(d.amin(dim=(1, 2))) + slack32  # torch.amin keeps a NaN
        scan = always | ~(torch.sqrt(_box_d2(ulo[:, :, None], uhi[:, :, None], glo, ghi))
                          > thr[:, None, None])
        scan[torch.arange(len(g0), device=rows.device), :, g0] = True
        plan[sl] = scan & good[sl, None, None]
    return plan


def pair_min_planned(rows: torch.Tensor, ids: torch.Tensor, blocks: torch.Tensor,
                     tris: torch.Tensor, plan: torch.Tensor, group_size: int) -> torch.Tensor:
    """Twin of the culled instance, on the device of its inputs: [k] float32
    pair distances over the (pair, unit, group) scans that ``plan`` keeps
    (``cull_plan``'s, for groups of ``group_size``), each distance in the
    kernel's operations. The min is exact and NaN-sticky, as the kernel's
    atomic min and NaN flag make it; an id outside the table gives NaN. On
    ``cull_plan``'s plan it equals ``pair_min_reference`` bit for bit, as
    the kernel does, and costs what the plan keeps."""
    k, nb, block, nt = rows.shape[0], blocks.shape[0], blocks.shape[1], tris.shape[0]
    dev = rows.device
    unit = unit_vertices(block)
    m = torch.full((k,), float("inf"), dtype=torch.float32, device=dev)
    nan = torch.zeros((k,), dtype=torch.bool, device=dev)
    good = (ids >= 0) & (ids < nb)
    cells = (plan & good[:, None, None]).nonzero()  # [n, 3]: pair, unit, group
    blk = ids.long().clamp(0, nb - 1)
    v_offs = torch.arange(unit, device=dev)
    t_offs = torch.arange(group_size, device=dev)
    step = max(1, _TWIN_BUDGET // (unit * group_size))
    for lo in range(0, len(cells), step):
        pair, u, g = cells[lo : lo + step].unbind(dim=1)
        v = u[:, None] * unit + v_offs  # [n, unit]
        verts = blocks[blk[pair][:, None], v.clamp(max=block - 1)]  # [n, unit, 3]
        r = rows[pair][:, :, None]  # [n, 12, 1]
        p = [((r[:, 3 * i] * verts[..., 0] + r[:, 3 * i + 1] * verts[..., 1])
              + r[:, 3 * i + 2] * verts[..., 2]) + r[:, 9 + i] for i in range(3)]
        t = g[:, None] * group_size + t_offs  # [n, size]
        tri = tris[t.clamp(max=nt - 1)]  # [n, size, 9]
        d = point_tri_d2_parts([x[..., None] for x in p],
                               *([tri[:, None, :, 3 * c + i] for i in range(3)]
                                 for c in range(3)))  # [n, unit, size]
        d = torch.where((v < block)[:, :, None] & (t < nt)[:, None, :], d,
                        torch.full_like(d, float("inf")))
        nan[pair[torch.isnan(d).flatten(1).any(dim=1)]] = True
        d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
        m.scatter_reduce_(0, pair, d.flatten(1).amin(dim=1), "amin")
    out = torch.sqrt(m)
    out[nan | ~good] = float("nan")
    return out


def region_counts(rows: torch.Tensor, ids: torch.Tensor, blocks: torch.Tensor,
                  tris: torch.Tensor, plan: torch.Tensor | None = None,
                  group_size: int = 32) -> torch.Tensor:
    """How many (pair, vertex, triangle) distances of a launch on these
    inputs end in each region of REGIONS: int64 [len(REGIONS)] on the
    device of the inputs. With ``plan`` (``cull_plan``'s, for groups of
    ``group_size``) only the distances the culled kernel takes are counted.
    Pairs whose id is outside the table do no work and are not counted.
    `profiling/bounds.clearance_work` charges each region what it needs."""
    good = (ids >= 0) & (ids < blocks.shape[0])
    counts = torch.zeros(len(REGIONS), dtype=torch.int64, device=rows.device)
    block = blocks.shape[1]
    if plan is not None:
        plan = plan[good][:, torch.arange(block, device=rows.device) // unit_vertices(block)]
    for sl, ts, p, tri in _twin_steps(rows[good], ids[good], blocks, tris):
        region = point_tri_region_parts(p, *tri)  # [kc, block, tc]
        if plan is not None:
            t = torch.arange(ts.start, ts.start + region.shape[-1], device=rows.device)
            region = region[plan[sl][..., t // group_size]]
        counts += torch.bincount(region.flatten(), minlength=len(REGIONS))
    return counts


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d tensor, got {tuple(t.shape)}")


def pair_min_cuda(rows: torch.Tensor, ids: torch.Tensor, blocks: torch.Tensor,
                  tris: torch.Tensor, groups: CullGroups | None = None, slack: float = 0.0,
                  visits: torch.Tensor | None = None,
                  kept: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel of `csrc/clearance.cu` on the current stream: [k]
    float32 pair distances, as ``pair_min_reference``'s.

    ``tris`` is the obstacle's ``tri_table`` [nt, 18], which the engine
    forms once. With ``groups`` the culled instance runs with ``slack``
    (the engine's 2 x err_bound) and, given ``visits`` (int32 [k]), adds to
    it each pair's count of (unit, group) scans, which is ``cull_plan``'s;
    given ``kept`` (one int64 on the device), adds to it the launch's count,
    the sum of ``cull_plan``'s plan, in the last of its launches. With
    ``groups=None`` the nocull instance scans every triangle. Raises on
    inputs the kernel does not take and on a refused launch."""
    from . import _build

    _require(rows, "rows", torch.float32, 2)
    _require(ids, "ids", torch.int32, 1)
    _require(blocks, "blocks", torch.float32, 3)
    _require(tris, "tris", torch.float32, 2)
    k, (nb, block, three), (nt, cols) = rows.shape[0], blocks.shape, tris.shape
    if rows.shape[1] != 12 or ids.shape[0] != k or three != 3:
        raise ValueError(f"shapes rows {tuple(rows.shape)}, ids {tuple(ids.shape)}, blocks "
                         f"{tuple(blocks.shape)} are not [k,12], [k], [nb,block,3]")
    if nb == 0 or block == 0:
        raise ValueError("the block table is empty")
    tensors = [rows, ids, blocks, tris]
    if groups is not None:
        _require(groups.boxes, "groups.boxes", torch.float32, 2)
        _require(groups.always, "groups.always", torch.uint8, 1)
        ng = math.ceil(nt / groups.size) if groups.size > 0 else -1
        if ng < 0 or groups.boxes.shape != (ng, 6) or groups.always.shape != (ng,):
            raise ValueError(f"groups of {groups.size} over {nt} triangles need boxes [{ng}, 6] "
                             f"and always [{ng}], got {tuple(groups.boxes.shape)} and "
                             f"{tuple(groups.always.shape)}")
        tensors += [groups.boxes, groups.always]
    if visits is not None:
        if groups is None:
            raise ValueError("visits counts the culled instance's scans: pass groups")
        _require(visits, "visits", torch.int32, 1)
        if visits.shape[0] != k:
            raise ValueError(f"visits must be [{k}], got {tuple(visits.shape)}")
        tensors.append(visits)
    if kept is not None:
        if groups is None:
            raise ValueError("kept counts the culled instance's scans: pass groups")
        if kept.dtype != torch.int64 or kept.numel() != 1:
            raise ValueError(f"kept must be one int64, got {kept.dtype} {tuple(kept.shape)}")
        tensors.append(kept)
    dev = rows.device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"every input must be a CUDA tensor on one device, got {t.device}")
    if cols != 18:
        raise ValueError(f"tris must be the [nt, 18] tri_table, got {tuple(tris.shape)}")
    tab = tris if tris.data_ptr() % 16 == 0 else tris.clone()  # copied 16 bytes at a time
    out = torch.empty((k,), dtype=torch.float32, device=dev)
    if k == 0:
        return out
    lib = _build.library("clearance")
    if groups is None:
        gbox = always = tasks = visits_ptr = kept_ptr = None
        ng = size = 0
        scratch = torch.empty((1,), dtype=torch.int32, device=dev)  # the pair counter
    else:
        gbox, always, size = groups.boxes.data_ptr(), groups.always.data_ptr(), groups.size
        visits_ptr = None if visits is None else visits.data_ptr()
        kept_ptr = None if kept is None else kept.data_ptr()
        units = -(-block // unit_vertices(block))
        # Room for every (pair, unit, group) scan, and the counters, pair
        # minima and NaN flags of the kernel's three launches.
        task_list = torch.empty((max(k * units * ng, 1), 2), dtype=torch.int32, device=dev)
        tasks = task_list.data_ptr()
        scratch = torch.empty((4 + 2 * k,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.rc_clearance_pair_min(
            rows.data_ptr(), ids.data_ptr(), k, blocks.data_ptr(), nb, block, tab.data_ptr(), nt,
            gbox, always, ng, size, float(slack), out.data_ptr(), visits_ptr, kept_ptr, tasks,
            scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rc_clearance_pair_min launch failed: "
                           f"{lib.rc_clearance_error_string(err).decode()} (cudaError {err})")
    pair_min_cuda.launches += 1
    return out


pair_min_cuda.launches = 0
