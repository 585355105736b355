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
    a CUDA device only; it raises on a refused launch, with no fallback);
  * ``pair_min_reference`` is its plain PyTorch twin (any device), in the
    kernel's operation order, which the CPU tests run and `chip_smoke.py`
    holds the kernel against on the card;
  * ``region_counts`` counts, on the same inputs, the distances that end in
    each region of the classification: the work the kernel's early exits
    leave, from which `chip_smoke.py` works out the kernel's bound.

Inputs: pose rows [k, 12] float32 (``pose_rows``: R row-major from
`ops/transform.rotation_matrices`, then t), block ids [k] int32, the block
table [nb, block, 3] float32 and the obstacle triangles [nt, 9] float32
(corners a, b, c; no padding). An id outside [0, nb) gives NaN.
"""
from __future__ import annotations

import torch

from ..ops.transform import rotation_matrices

# Elements (pair x vertex x triangle) the twin materialises per step.
_TWIN_BUDGET = 1 << 21
# Where the closest point of a triangle to a point lies, in the order the
# kernel tests them (`point_tri_region_parts`, `region_counts`).
REGIONS = ("vertex a", "vertex b", "vertex c", "edge ab", "edge ac", "edge bc", "face")


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


def _twin_steps(rows: torch.Tensor, ids: torch.Tensor, blocks: torch.Tensor,
                tris: torch.Tensor):
    """The twin's loop over ``k`` pairs: per step (at most _TWIN_BUDGET pair
    x vertex x triangle elements), the pairs' slice, their posed vertices
    (3 components, [kc, block, 1]) and one chunk of the triangles' corners
    (3 x 3 components, [tc]). Ids are clamped into the table."""
    k, nb, block, nt = rows.shape[0], blocks.shape[0], blocks.shape[1], tris.shape[0]
    ids = ids.long().clamp(0, nb - 1)
    corners = [[tris[:, 3 * c + i] for i in range(3)] for c in range(3)]
    tc = max(1, min(nt, _TWIN_BUDGET // block))
    kc = max(1, _TWIN_BUDGET // (block * tc))
    for lo in range(0, k, kc):
        verts = blocks[ids[lo : lo + kc]]  # [kc, block, 3]
        r = rows[lo : lo + kc, :, None]  # [kc, 12, 1]
        # ((r0 x + r1 y) + r2 z) + t per axis, the kernel's order: [kc, block, 1].
        p = [(((r[:, 3 * i] * verts[..., 0] + r[:, 3 * i + 1] * verts[..., 1])
               + r[:, 3 * i + 2] * verts[..., 2]) + r[:, 9 + i])[..., None] for i in range(3)]
        for t0 in range(0, nt, tc):
            yield slice(lo, lo + kc), p, [[x[t0 : t0 + tc] for x in corner] for corner in corners]


def pair_min_reference(rows: torch.Tensor, ids: torch.Tensor, blocks: torch.Tensor,
                       tris: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, on the device of its inputs: [k]
    float32 pair distances. NaN propagates through the min, as in the
    kernel."""
    k, nb, block = rows.shape[0], blocks.shape[0], blocks.shape[1]
    if k == 0:
        return torch.full((0,), float("inf"), dtype=torch.float32, device=rows.device)
    m = torch.full((k, block), float("inf"), dtype=torch.float32, device=rows.device)
    for sl, p, tri in _twin_steps(rows, ids, blocks, tris):
        m[sl] = torch.minimum(m[sl], point_tri_d2_parts(p, *tri).amin(dim=-1))
    out = torch.sqrt(m.amin(dim=-1))
    out[(ids < 0) | (ids >= nb)] = float("nan")
    return out


def region_counts(rows: torch.Tensor, ids: torch.Tensor, blocks: torch.Tensor,
                  tris: torch.Tensor) -> torch.Tensor:
    """How many (pair, vertex, triangle) distances of a launch on these
    inputs end in each region of REGIONS: int64 [len(REGIONS)] on the
    device of the inputs. Pairs whose id is outside the table do no work
    and are not counted. `profiling/bounds.clearance_work` charges each
    region what it needs."""
    good = (ids >= 0) & (ids < blocks.shape[0])
    counts = torch.zeros(len(REGIONS), dtype=torch.int64, device=rows.device)
    for _, p, tri in _twin_steps(rows[good], ids[good], blocks, tris):
        counts += torch.bincount(point_tri_region_parts(p, *tri).flatten(),
                                 minlength=len(REGIONS))
    return counts


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
             device: torch.device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d tensor, got {tuple(t.shape)}")


def pair_min_cuda(rows: torch.Tensor, ids: torch.Tensor, blocks: torch.Tensor,
                  tris: torch.Tensor) -> torch.Tensor:
    """Launch the kernel of `csrc/clearance.cu` on the current stream: [k]
    float32 pair distances, as ``pair_min_reference``'s. Raises on inputs the
    kernel does not take and on a refused launch."""
    from . import _build

    if not rows.is_cuda:
        raise ValueError(f"rows must be a CUDA tensor, got {rows.device}")
    dev = rows.device
    _require(rows, "rows", torch.float32, 2, dev)
    _require(ids, "ids", torch.int32, 1, dev)
    _require(blocks, "blocks", torch.float32, 3, dev)
    _require(tris, "tris", torch.float32, 2, dev)
    k, (nb, block, three), nt = rows.shape[0], blocks.shape, tris.shape[0]
    if rows.shape[1] != 12 or ids.shape[0] != k or three != 3 or tris.shape[1] != 9:
        raise ValueError(f"shapes rows {tuple(rows.shape)}, ids {tuple(ids.shape)}, blocks "
                         f"{tuple(blocks.shape)}, tris {tuple(tris.shape)} are not [k,12], "
                         f"[k], [nb,block,3], [nt,9]")
    if nb == 0 or block == 0:
        raise ValueError("the block table is empty")
    out = torch.empty((k,), dtype=torch.float32, device=dev)
    if k == 0:
        return out
    lib = _build.library("clearance")
    with torch.cuda.device(dev):
        err = lib.rc_clearance_pair_min(
            rows.data_ptr(), ids.data_ptr(), k, blocks.data_ptr(), nb, block,
            tris.data_ptr(), nt, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rc_clearance_pair_min launch failed: "
                           f"{lib.rc_clearance_error_string(err).decode()} (cudaError {err})")
    pair_min_cuda.launches += 1
    return out


pair_min_cuda.launches = 0
