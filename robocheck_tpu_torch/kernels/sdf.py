"""The gradient planners' distance grid (K4): its CUDA kernel and its PyTorch
twin.

For every node p of the lattice ax x ay x az (node (i, j, k) at
(i * ny + j) * nz + k), the grid's value is

    sqrt(min over every obstacle triangle T of d2(p, T)),

negated where a ray from p along RAY_DIR crosses the mesh an odd number of
times (``signed``): the JAX package's `_grid_distances` and `_grid_inside`
(`robocheck_tpu/planner/sdf.py:127-178`), with d2 the squared
point-to-triangle distance of `kernels/clearance.point_tri_d2` (the clearance
scan's, K3) and the Moller-Trumbore test along the ray.

  * ``grid_order`` puts the obstacle's triangles in the Morton order of
    their centroids, and ``grid_table`` forms their per-triangle terms with
    torch ops on their device: `kernels/clearance.tri_table`'s corners and
    edges, pvec = RAY_DIR x (c - a), the determinant's inverse (0 where
    flat) and the flat flag. No order moves a bit of the grid: the min and
    the parity's XOR are order-free. ``grid_cull`` cuts the rows into
    groups of GROUP (boxes and `always` flags, `kernels/clearance.
    make_groups`) with the cull's slacks, once per obstacle: ``grid_slack``
    (2 x err_bound, the clearance engine's rule) for the distance, and per
    group ``grid_ray_slack``, which adds ``ray_error``'s bound on how far
    from its triangle the rounded ray test can declare a crossing;
  * ``sdf_grid_cuda`` launches `rc_sdf_grid` of `csrc/clearance.cu` (tensors
    on a CUDA device only; it raises on a refused launch, with no fallback),
    which skips a (warp brick, group) scan for the distance where the
    group's box is farther than every node's running min by more than the
    slack, and for the ray where the brick's sweep misses the box grown by
    its ray slack;
  * ``grid_values_reference`` is its plain PyTorch twin (any device), the
    full scan in the kernel's operation order, which
    `planner/sdf.build_distance_grid` runs on a CPU device, the CPU tests
    hold against JAX, and `chip_smoke.py` holds the kernel against on the
    card, bit for bit;
  * ``grid_values`` runs the kernel for CUDA tensors and the twin for CPU
    ones;
  * ``grid_cull_plan`` says, from the same inputs, which (warp brick, group)
    scans the kernel makes, for the distance and for the ray: its rules in
    its float32 operations; ``grid_values_planned`` is the twin restricted
    to a plan's scans, which must give the full twin's bits;
  * ``grid_work_counts`` counts, on the same inputs (a plan's scans only,
    given one), how far each node-triangle pair goes (its distance's
    region, its ray test's stages): the work from which
    `profiling/bounds.grid_work` gives the kernel's bound.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.morton import morton_argsort
from .clearance import (REGIONS, _box_d2, _dot, _require, make_groups,
                        point_tri_d2_parts, point_tri_region_parts, tri_table)

# A slightly skewed ray direction: axis-aligned rays through a regular grid
# hit mesh edges and vertices exactly; this direction makes such
# degeneracies measure-zero in practice (`sdf.py:142-145`).
RAY_DIR = np.array([0.8775825, 0.33879128, 0.33946234], dtype=np.float32)
# Its componentwise inverse in float32, as `rc_sdf_grid` forms it (1.f / d).
RAY_INV = np.float32(1.0) / RAY_DIR
# Columns of a grid-table row: the scan table's 18 (a, b, c, ab, ac, bc),
# pvec (3), inv_det, flat and a zero, so a row is six 16-byte loads.
ROW = 24
# |det| below this is a triangle parallel to the ray (`sdf.py:163`).
FLAT = 1e-12
# Node x triangle elements the twin materialises per step.
_TWIN_BUDGET = 1 << 21
# The ray test's stages (`grid_work_counts`): pairs of a triangle that is not
# flat (u formed), pairs with u >= 0 (qvec and v formed), pairs that also
# pass v >= 0 and u + v <= 1 (t formed).
RAY_STAGES = ("u", "v", "t")
# Triangles a group (`csrc/clearance.cu` kGroup), and the kernel's bricks of
# lattice nodes: a block's (kBx, kBy, kBz) and a warp's (kWx, kWy, kWz).
GROUP = 32
BRICK = ((8, 4, 8), (2, 4, 4))
_F32_EPS = float(np.finfo(np.float32).eps)


def _cross(u, v) -> list:
    """u x v of 3-lists of broadcastable tensors, written out (no matmul)."""
    return [u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2], u[0] * v[1] - u[1] * v[0]]


def _ray(device) -> list:
    """RAY_DIR as three 0-d float32 tensors on ``device``."""
    d = torch.as_tensor(RAY_DIR).to(device)
    return [d[i] for i in range(3)]


def grid_table(tris: torch.Tensor) -> torch.Tensor:
    """The kernel's table [nt, ROW] from triangles [nt, 9] (corners a, b, c):
    `tri_table`'s 18 columns, pvec = RAY_DIR x (c - a), det = (b - a) . pvec
    with each 3-term sum as (x + y) + z, inv_det = 1 / det where |det| >=
    FLAT else 0, flat (1.0 where |det| < FLAT) and a zero column."""
    tab = tri_table(tris)
    e1 = [tab[:, 9 + i] for i in range(3)]
    e2 = [tab[:, 12 + i] for i in range(3)]
    pvec = _cross(_ray(tris.device), e2)
    det = _dot(e1, pvec)
    flat = det.abs() < FLAT
    inv_det = torch.where(flat, 0.0, 1.0 / torch.where(flat, 1.0, det))
    return torch.cat([tab, torch.stack(pvec, dim=1), inv_det[:, None], flat.float()[:, None],
                      torch.zeros_like(inv_det)[:, None]], dim=1).contiguous()


def grid_points(axes) -> torch.Tensor:
    """The lattice's nodes [nx * ny * nz, 3] from its three axes, node
    (i, j, k) at (i * ny + j) * nz + k (numpy's meshgrid, indexing "ij")."""
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)


def _columns(table: torch.Tensor):
    """The table's corners (3 x 3-lists), edges ab and ac, pvec, inv_det and
    flat mask, as columns of its leading dims ([nt] for an [nt, ROW] table)."""
    col = [table[..., i] for i in range(ROW)]
    return (col[0:3], col[3:6], col[6:9]), col[9:12], col[12:15], col[18:21], col[21], col[22] != 0


def _crossings(p, corners, e1, e2, pvec, inv_det, flat, d):
    """The twin's ray test of points ``p`` (3 x [C, 1]) against the table's
    triangles: bool [C, nt] crossing, and its stages (u >= 0, then also
    v >= 0 and u + v <= 1)."""
    tv = [p[i] - corners[0][i] for i in range(3)]
    u = _dot(tv, pvec) * inv_det
    q = _cross(tv, e1)
    v = _dot(q, d) * inv_det
    t = _dot(q, e2) * inv_det
    pass_u = ~flat & (u >= 0.0)
    pass_v = pass_u & (v >= 0.0) & (u + v <= 1.0)
    return pass_v & (t > 0.0), pass_u, pass_v


def grid_values_reference(points: torch.Tensor, table: torch.Tensor,
                          signed: bool = True) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, on the device of its inputs: [N]
    float32 values of ``points`` [N, 3] against the ``grid_table`` [nt, ROW].
    The min of the squared distances, then one sqrt (NaN propagates through
    the min, as in the kernel); where ``signed``, negated on an odd count of
    crossings."""
    n, nt = points.shape[0], table.shape[0]
    corners, e1, e2, pvec, inv_det, flat = _columns(table)
    d = _ray(points.device)
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    chunk = max(1, _TWIN_BUDGET // max(nt, 1))
    for lo in range(0, n, chunk):
        p = [points[lo : lo + chunk, i, None] for i in range(3)]
        dist = torch.sqrt(point_tri_d2_parts(p, *corners).amin(dim=1))
        if signed:
            crossing = _crossings(p, corners, e1, e2, pvec, inv_det, flat, d)[0]
            dist = torch.where(crossing.sum(dim=1) % 2 == 1, -dist, dist)
        out[lo : lo + chunk] = dist
    return out


def grid_order(tris: torch.Tensor) -> torch.Tensor:
    """The triangles [nt, 9] in the Morton order of their centroids (a
    non-finite centroid counts as the origin), on their device: the order
    the clearance engine scans in (`planner/clearance.py`), so that the
    groups of GROUP consecutive rows are compact. The order moves no bit of
    the grid: the min and the parity's XOR are order-free. Formed in numpy,
    with no CPU torch op: with torch's CPU ops here, the SQP loop's backward
    passes on the card ran ~50% slower afterwards unless OMP_NUM_THREADS=1
    (PERF.md, section 6)."""
    host = tris.detach().cpu().numpy()
    cent = host.astype(np.float64).reshape(-1, 3, 3).mean(axis=1)
    order = morton_argsort(np.nan_to_num(cent, nan=0.0, posinf=0.0, neginf=0.0))
    return torch.from_numpy(np.ascontiguousarray(host[order])).to(tris.device)


@dataclasses.dataclass(frozen=True)
class GridCull:
    """What K4's cull reads besides the table (``grid_cull``): group g holds
    rows [g x size, (g + 1) x size) of the table.

    Attributes:
      boxes: [ng, 6] float32, conservative boxes (lo xyz, hi xyz).
      always: [ng] uint8, 1 where the group is measured and tested whatever
        its box says (a thin or non-finite triangle,
        `kernels/clearance.always_visit`).
      ray_slack: [ng] float32, what the ray cull grows the group's box by
        (``grid_ray_slack``; inf where nothing bounds it).
      slack: the distance cull's slack (``grid_slack``).
      size: triangles a group.
    """

    boxes: torch.Tensor
    always: torch.Tensor
    ray_slack: torch.Tensor
    slack: float
    size: int


def grid_cull(axes, table: torch.Tensor, size: int = GROUP) -> GridCull:
    """K4's cull of the lattice over ``axes`` against ``table`` (the
    ``grid_table`` of ``grid_order``'s triangles), formed once per obstacle
    on the host and put on the table's device: `kernels/clearance.
    make_groups`' boxes (from the corners in float64, grown by what the
    float32 conversion can lose) and `always` flags of groups of ``size``,
    ``grid_slack`` and ``grid_ray_slack``."""
    host = table.detach().cpu()
    groups = make_groups(host[:, :9], size)
    slack = grid_slack(axes, host[:, :9])
    ray = torch.from_numpy(grid_ray_slack(axes, host, size, slack))
    dev = table.device
    return GridCull(groups.boxes.to(dev), groups.always.to(dev), ray.to(dev), slack, size)


def grid_slack(axes, tris: torch.Tensor) -> float:
    """The cull's slack, 2 x err_bound: err_bound is 128 float32 ulp (eps) x
    max(1, the largest finite |coordinate| of the lattice's axes and of the
    triangles), the clearance engine's rule (`planner/clearance.
    ClearanceEngine.err_bound`, whose cull takes 2 x it) on the grid's own
    scene. A box distance more than this above sqrt(M) cannot hide a
    triangle nearer than M once rounded."""
    scale = 1.0
    for t in (*axes, tris):
        x = np.abs(t.detach().cpu().numpy().astype(np.float64))
        x = x[np.isfinite(x)]
        if x.size:
            scale = max(scale, float(x.max()))
    return 2.0 * 128.0 * _F32_EPS * scale


def ray_error(axes, table: torch.Tensor) -> np.ndarray:
    """float64 [nt]: how far from its triangle the rounded ray test of
    ``_crossings`` (the kernel's `ray_crosses`) can declare a crossing, for
    any node of the lattice over ``axes``: 0 for a flat row (it never
    crosses), inf where the bound below does not hold.

    With u = 2^-24 (float32's unit roundoff, every operation rounded once),
    a = the first corner, E1 = b - a, E2 = c - a, D = E1 . (RAY_DIR x E2)
    (the exact determinant), T = p - a (|T| <= R, the farthest corner of
    the lattice's box from a), the standard bounds on rounded sums,
    products and dot products give, to first order, |det - D| <= eD =
    10 u |E1||E2|, and with D' = |D| - eD and B = eD / D' + 2u the rounded
    u, v and t of the test within
        du = 2 (10 u R |E2| / D' + B),  dv = 2 (10 u R |E1| / D' + B),
        dt = 11 u R |E1||E2| / D' + tmax (eD / D' + 2u)
    of the exact ones where the test passes (then |u|, |v| <= 1 + du, dv,
    and |t| <= tmax = R + (1 + du)|E1| + (1 + dv)|E2|; the factors 2 need
    B <= 1/2). A declared crossing puts a + u E1 + v E2 in the triangle, so
    the exact ray's meeting with its plane (t >= 0) or the node itself (t <
    0, |t| < dt) lies within du |E1| + dv |E2| + dt of the triangle. The
    bound is that, doubled for the terms of second order. It grows as the
    triangle turns parallel to the ray (D' -> 0): a thin triangle's or a
    grazing one's crossings can lie far outside its box."""
    t = table[:, :9].detach().cpu().numpy().astype(np.float64).reshape(-1, 3, 3)
    flat = table[:, 22].detach().cpu().numpy() != 0
    d = RAY_DIR.astype(np.float64)
    a, e1, e2 = t[:, 0], t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]
    lo = np.array([float(x.min()) for x in axes], np.float64)
    hi = np.array([float(x.max()) for x in axes], np.float64)
    u = 2.0 ** -24
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        n1, n2 = np.linalg.norm(e1, axis=1), np.linalg.norm(e2, axis=1)
        e_d = 10 * u * n1 * n2
        dp = np.abs((e1 * np.cross(d, e2)).sum(axis=1)) - e_d
        r = np.sqrt(np.maximum((lo - a) ** 2, (hi - a) ** 2).sum(axis=1))
        b = e_d / dp + 2 * u
        du = 2 * (10 * u * r * n2 / dp + b)
        dv = 2 * (10 * u * r * n1 / dp + b)
        tmax = r + (1 + du) * n1 + (1 + dv) * n2
        dt = 11 * u * r * n1 * n2 / dp + tmax * (e_d / dp + 2 * u)
        err = 2 * (du * n1 + dv * n2 + dt)
        bad = ~(dp > 0) | ~(b <= 0.5) | ~np.isfinite(err)
    return np.where(flat, 0.0, np.where(bad, np.inf, err))


def grid_ray_slack(axes, table: torch.Tensor, size: int, slack: float) -> np.ndarray:
    """float32 [ceil(nt / size)]: what the ray cull grows each group box of
    ``size`` rows of ``table`` by: ``slack`` (which covers the float32 slab
    test) plus the largest ``ray_error`` of the group's triangles, rounded
    up to float32 (inf where unbounded). A node whose sweep along +RAY_DIR
    misses the grown box cannot have a crossing declared by any of them."""
    err = ray_error(axes, table)
    ng = -(-len(err) // size)
    worst = np.pad(err, (0, ng * size - len(err))).reshape(ng, size).max(axis=1) + slack
    out = worst.astype(np.float32)
    return np.where(out < worst, np.nextafter(out, np.float32(np.inf)), out)


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """The scans of the culled K4 on one lattice (``grid_cull_plan``): warp
    w, the brick of nodes one warp holds (warp bricks in the lattice's
    order, the last along an axis cut by its edge), against group g.

    Attributes:
      dist: bool [nw, ng], the warp measures its nodes' distances to g's
        triangles.
      ray: bool [nw, ng], the warp tests g's triangles for crossings (a
        signed grid's; an unsigned one tests none).
      nodes: int64 [nw, 32], each lane's node (flat index); a lane past the
        lattice repeats the edge's node.
      real: bool [nw, 32], the lane's node is its own, not such a repeat.
      size: triangles a group.
    """

    dist: torch.Tensor
    ray: torch.Tensor
    nodes: torch.Tensor
    real: torch.Tensor
    size: int

    def pairs(self, nt: int) -> tuple[int, int]:
        """(node-triangle pairs measured, pairs tested for crossings) over
        ``nt`` triangles, each node once."""
        ng = self.dist.shape[1]
        rows = (nt - torch.arange(ng, device=self.dist.device) * self.size).clamp(max=self.size)
        per = self.real.sum(dim=1)[:, None] * rows[None]
        return int((per * self.dist).sum()), int((per * self.ray).sum())


def _warp_lanes(shape, warp, device):
    """The warp bricks of ``warp`` nodes over a lattice of ``shape``: (each
    lane's node int64 [nw, 32], whether it is its own [nw, 32], each warp's
    brick index along the three axes, 3 x [nw]). Lane l of a brick is node
    (l // (wy wz), l // wz % wy, l % wz) of it (the kernel's order, z
    fastest); past the edge it repeats the edge's node."""
    n = [-(-s // w) for s, w in zip(shape, warp)]
    lane = torch.arange(warp[0] * warp[1] * warp[2], device=device)
    off = (lane // (warp[1] * warp[2]), lane // warp[2] % warp[1], lane % warp[2])
    at = [x.reshape(-1) for x in torch.meshgrid(
        *(torch.arange(k, device=device) for k in n), indexing="ij")]
    idx = [at[c][:, None] * warp[c] + off[c] for c in range(3)]
    real = (idx[0] < shape[0]) & (idx[1] < shape[1]) & (idx[2] < shape[2])
    cl = [idx[c].clamp(max=shape[c] - 1) for c in range(3)]
    return (cl[0] * shape[1] + cl[1]) * shape[2] + cl[2], real, at


def _sweep_meets(lo, hi, glo, ghi, slack, inv) -> torch.Tensor:
    """The kernel's `sweep_meets`, broadcast: whether the sweep of boxes
    [lo, hi] ([..., 1, 3]) along +RAY_DIR (s >= 0) meets the group boxes
    [glo, ghi] ([ng, 3]) grown by ``slack`` ([ng, 1]): bool [..., ng]. Per
    axis the sweep is in the slab for s in [a, b], a = ((glo - slack) - hi)
    x inv, b = ((ghi + slack) - lo) x inv (``inv`` = RAY_INV); it meets
    where every b >= 0 and every a <= every b, a NaN meeting."""
    a = ((glo - slack) - hi) * inv
    b = ((ghi + slack) - lo) * inv
    miss = (0.0 > b).any(dim=-1) | (a[..., :, None] > b[..., None, :]).flatten(-2).any(dim=-1)
    return ~miss


def _warp_runs(nw: int, nt: int) -> list:
    """Slices of ``nw`` warps that keep a step of the twins near
    _TWIN_BUDGET node-triangle pairs (32 lanes x ``nt`` triangles a
    warp)."""
    step = max(1, _TWIN_BUDGET // (32 * max(nt, 1)))
    return [slice(lo, min(lo + step, nw)) for lo in range(0, nw, step)]


def grid_cull_plan(axes, table: torch.Tensor, cull: GridCull, brick=BRICK) -> GridPlan:
    """The scans of the culled kernel on the lattice over ``axes`` against
    ``table`` (the ``grid_table`` of ``grid_order``'s triangles) and its
    ``cull`` (``grid_cull``), for blocks and warps of ``brick`` = (block
    brick, warp brick) nodes: the kernel's rules in its float32 operations,
    on the device of the inputs.

    Boxes: a warp's is the min / max of its nodes' coordinates, a block's of
    its warps' (NaN coordinates stay out). Each block orders the groups by
    the squared distance of their boxes to its box (ties to the lower
    index). Each warp then takes them in that order: it measures group g if
    g is ``always`` or sqrt(box_d2(warp box, g)) is not above thr, where thr
    = sqrt(M) + slack, M the largest running min of its nodes (inf before
    any; a NaN node left out, 0 with none else); a scan lowers its nodes'
    minima and thr. It tests g for crossings if g is ``always`` or g's box
    grown by its ray slack meets the sweep of the warp's box along
    +RAY_DIR (``_sweep_meets``). The kernel's scans are the plan's whichever groups
    its blocks stage: a block stages every group some warp's test could
    pass."""
    block, warp = brick
    shape = tuple(int(a.shape[0]) for a in axes)
    dev = table.device
    nodes, real, at = _warp_lanes(shape, warp, dev)
    p = grid_points(axes)[nodes]  # [nw, 32, 3]
    inf = torch.full_like(p, float("inf"))
    wlo = torch.where(torch.isnan(p), inf, p).amin(dim=1)
    whi = torch.where(torch.isnan(p), -inf, p).amax(dim=1)
    per = [block[c] // warp[c] for c in range(3)]
    nb = [-(-shape[c] // block[c]) for c in range(3)]
    blk = ((at[0] // per[0]) * nb[1] + at[1] // per[1]) * nb[2] + at[2] // per[2]
    into = blk[:, None].expand(-1, 3)
    blo = torch.full((nb[0] * nb[1] * nb[2], 3), float("inf"), device=dev)
    blo = blo.scatter_reduce(0, into, wlo, "amin")
    bhi = torch.full_like(blo, -float("inf")).scatter_reduce(0, into, whi, "amax")
    glo, ghi = cull.boxes[:, 0:3], cull.boxes[:, 3:6]
    always = cull.always.bool()
    slack32 = torch.tensor(cull.slack, dtype=torch.float32, device=dev)
    order = torch.sort(_box_d2(blo[:, None], bhi[:, None], glo, ghi), dim=1,
                       stable=True).indices[blk]  # [nw, ng]
    box = torch.sqrt(_box_d2(wlo[:, None], whi[:, None], glo, ghi))
    ray = always | _sweep_meets(wlo[:, None], whi[:, None], glo, ghi, cull.ray_slack[:, None],
                                torch.as_tensor(RAY_INV).to(dev))
    nw, ng = box.shape
    nt, size = table.shape[0], cull.size
    # Each lane's min over each group's triangles (NaN for NaN), once.
    corners = _columns(table)[0]
    group_min = torch.empty((nw, nodes.shape[1], ng), device=dev)
    for sl in _warp_runs(nw, nt):
        d2 = point_tri_d2_parts([p[sl][..., i, None] for i in range(3)], *corners)
        d2 = torch.cat([d2, d2.new_full((*d2.shape[:2], ng * size - nt), float("inf"))], dim=2)
        group_min[sl] = d2.view(*d2.shape[:2], ng, size).amin(dim=3)
    dist = torch.zeros((nw, ng), dtype=torch.bool, device=dev)
    m = torch.full(nodes.shape, float("inf"), device=dev)
    thr = torch.full((nw,), float("inf"), device=dev)
    w = torch.arange(nw, device=dev)
    for step in range(ng):
        g = order[:, step]
        keep = always[g] | ~(box[w, g] > thr)
        dist[w, g] = keep
        m = torch.where(keep[:, None], torch.minimum(m, group_min[w, :, g]), m)
        top = torch.where(torch.isnan(m), torch.zeros_like(m), m).amax(dim=1)
        thr = torch.where(keep, torch.sqrt(top) + slack32, thr)
    return GridPlan(dist, ray, nodes, real, cull.size)


def grid_values_planned(axes, table: torch.Tensor, plan: GridPlan,
                        signed: bool = True) -> torch.Tensor:
    """The twin restricted to ``plan``'s scans: the grid [nx, ny, nz] whose
    node takes the min over the triangles of the groups its warp measures
    and the parity over those of the groups it tests, in the twin's
    operations; ``grid_cull_plan``'s plan gives ``grid_values_reference``'s
    bits."""
    shape = tuple(int(a.shape[0]) for a in axes)
    pts = grid_points(axes)
    p = pts[plan.nodes]
    nw, nt = plan.nodes.shape[0], table.shape[0]
    corners, e1, e2, pvec, inv_det, flat = _columns(table)
    d = _ray(pts.device)
    group = torch.arange(nt, device=pts.device) // plan.size
    m = torch.empty(plan.nodes.shape, dtype=torch.float32, device=pts.device)
    odd = torch.zeros(plan.nodes.shape, dtype=torch.bool, device=pts.device)
    for sl in _warp_runs(nw, nt):
        q = [p[sl][..., i, None] for i in range(3)]
        d2 = point_tri_d2_parts(q, *corners)
        m[sl] = torch.where(plan.dist[sl][:, None, group], d2,
                            torch.full_like(d2, float("inf"))).amin(dim=2)
        if signed:
            cross = _crossings(q, corners, e1, e2, pvec, inv_det, flat, d)[0]
            odd[sl] = (cross & plan.ray[sl][:, None, group]).sum(dim=2) % 2 == 1
    val = torch.sqrt(m)
    val = torch.where(odd, -val, val)
    out = torch.empty(pts.shape[0], dtype=torch.float32, device=pts.device)
    out[plan.nodes[plan.real]] = val[plan.real]
    return out.view(shape)


def grid_work_counts(points: torch.Tensor, table: torch.Tensor,
                     plan: GridPlan | None = None) -> tuple[np.ndarray, np.ndarray]:
    """How far the node-triangle pairs of ``points`` [N, 3] against
    ``table`` go in the kernel: (int64 [len(REGIONS)] distances by the region
    they end in, int64 [len(RAY_STAGES)] pairs reaching each stage of the ray
    test). With ``plan`` (``grid_cull_plan``'s for the lattice whose
    ``grid_points`` are ``points``) only its scans count, each node once.
    `profiling/bounds.grid_work` charges each what it needs."""
    regions = torch.zeros(len(REGIONS), dtype=torch.int64, device=points.device)
    stages = torch.zeros(len(RAY_STAGES), dtype=torch.int64, device=points.device)
    if plan is not None:
        p = points[plan.nodes]
        nw, nt = plan.nodes.shape[0], table.shape[0]
        corners, e1, e2, pvec, inv_det, flat = _columns(table)
        group = torch.arange(nt, device=points.device) // plan.size
        for sl in _warp_runs(nw, nt):
            q = [p[sl][..., i, None] for i in range(3)]
            own = plan.real[sl][:, :, None]
            region = point_tri_region_parts(q, *corners)
            region = region[own & plan.dist[sl][:, None, group]]
            regions += torch.bincount(region, minlength=len(REGIONS))
            _, pass_u, pass_v = _crossings(q, corners, e1, e2, pvec, inv_det, flat,
                                           _ray(points.device))
            tested = own & plan.ray[sl][:, None, group]
            stages += torch.stack([(x & tested).sum() for x in (~flat, pass_u, pass_v)])
        return regions.cpu().numpy(), stages.cpu().numpy()
    n, nt = points.shape[0], table.shape[0]
    corners, e1, e2, pvec, inv_det, flat = _columns(table)
    d = _ray(points.device)
    chunk = max(1, _TWIN_BUDGET // max(nt, 1))
    for lo in range(0, n, chunk):
        p = [points[lo : lo + chunk, i, None] for i in range(3)]
        region = point_tri_region_parts(p, *corners)
        regions += torch.bincount(region.flatten(), minlength=len(REGIONS))
        _, pass_u, pass_v = _crossings(p, corners, e1, e2, pvec, inv_det, flat, d)
        stages += torch.stack([(~flat).sum() * region.shape[0], pass_u.sum(), pass_v.sum()])
    return regions.cpu().numpy(), stages.cpu().numpy()


def sdf_grid_cuda(axes, table: torch.Tensor, cull: GridCull, signed: bool = True,
                  counts: torch.Tensor | None = None) -> torch.Tensor:
    """Launch K4 (`rc_sdf_grid` of `csrc/clearance.cu`) on the current
    stream: the grid [nx, ny, nz] over ``axes`` (three 1-d float32 tensors)
    against the ``grid_table`` [nt, ROW] of ``grid_order``'s triangles,
    culled by its ``cull`` (``grid_cull``, groups of GROUP), as
    ``grid_values_reference`` of ``grid_points(axes)``. Given ``counts``
    (int32 [2]), adds to it the kept (warp, group) distance scans and ray
    scans, which are ``grid_cull_plan``'s. A block keeps the groups' boxes,
    flags, distances and order in shared memory (38 bytes a group) where
    they fit, and otherwise in device scratch this allocates
    (`rc_sdf_grid_scratch_bytes`), launched in as many waves as that takes:
    any number of triangles. Raises on inputs the kernel does not take and
    on a refused launch."""
    ax, ay, az = axes
    for name, t in (("ax", ax), ("ay", ay), ("az", az)):
        _require(t, name, torch.float32, 1)
        if t.shape[0] == 0:
            raise ValueError(f"{name} is empty")
    _require(table, "table", torch.float32, 2)
    nt = table.shape[0]
    if table.shape[1] != ROW or nt == 0:
        raise ValueError(f"table must be a non-empty [nt, {ROW}] grid_table, got "
                         f"{tuple(table.shape)}")
    _require(cull.boxes, "cull.boxes", torch.float32, 2)
    _require(cull.always, "cull.always", torch.uint8, 1)
    _require(cull.ray_slack, "cull.ray_slack", torch.float32, 1)
    ng = -(-nt // GROUP)
    if (cull.size != GROUP or cull.boxes.shape != (ng, 6) or cull.always.shape != (ng,)
            or cull.ray_slack.shape != (ng,)):
        raise ValueError(f"the kernel reads groups of {GROUP} over {nt} triangles: boxes [{ng}, "
                         f"6], always and ray_slack [{ng}], got {cull.size}, "
                         f"{tuple(cull.boxes.shape)}, {tuple(cull.always.shape)} and "
                         f"{tuple(cull.ray_slack.shape)}")
    tensors = [ax, ay, az, table, cull.boxes, cull.always, cull.ray_slack]
    if counts is not None:
        _require(counts, "counts", torch.int32, 1)
        if counts.shape[0] != 2:
            raise ValueError(f"counts must be [2], got {tuple(counts.shape)}")
        tensors.append(counts)
    dev = table.device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"every input must be a CUDA tensor on one device, got {t.device}")
    tab = table if table.data_ptr() % 16 == 0 else table.clone()  # copied 16 bytes at a time
    nx, ny, nz = ax.shape[0], ay.shape[0], az.shape[0]
    out = torch.empty((nx, ny, nz), dtype=torch.float32, device=dev)
    from . import _build

    lib = _build.library("clearance")
    with torch.cuda.device(dev):
        need = lib.rc_sdf_grid_scratch_bytes(nx, ny, nz, ng)
        if need < 0:
            raise RuntimeError(f"rc_sdf_grid_scratch_bytes failed: "
                               f"{lib.rc_clearance_error_string(-need).decode()} (cudaError "
                               f"{-need})")
        scratch = torch.empty(need, dtype=torch.uint8, device=dev) if need else None
        err = lib.rc_sdf_grid(ax.data_ptr(), ay.data_ptr(), az.data_ptr(), nx, ny, nz,
                              tab.data_ptr(), nt, cull.boxes.data_ptr(), cull.always.data_ptr(),
                              cull.ray_slack.data_ptr(), ng, float(cull.slack),
                              int(bool(signed)), *(float(x) for x in RAY_DIR), out.data_ptr(),
                              None if counts is None else counts.data_ptr(),
                              None if scratch is None else scratch.data_ptr(), need,
                              torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rc_sdf_grid launch failed: "
                           f"{lib.rc_clearance_error_string(err).decode()} (cudaError {err})")
    sdf_grid_cuda.launches += 1
    return out


sdf_grid_cuda.launches = 0


def grid_values(axes, table: torch.Tensor, cull: GridCull, signed: bool = True) -> torch.Tensor:
    """The grid [nx, ny, nz] over ``axes`` against ``table``: K4, culled by
    ``cull``, for CUDA tensors; the full twin for CPU ones (the same
    bits)."""
    if table.is_cuda:
        return sdf_grid_cuda(axes, table, cull, signed)
    shape = tuple(a.shape[0] for a in axes)
    return grid_values_reference(grid_points(axes), table, signed).reshape(shape)
