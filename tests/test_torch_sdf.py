"""The port's distance grid (`robocheck_tpu_torch.planner.sdf`) against the
JAX package's `robocheck_tpu.planner.sdf`, on the CPU, and K4's twin
(`robocheck_tpu_torch.kernels.sdf`): its hoisted per-triangle table and its
single sqrt against the per-pair route, the kernel's cull rule
(`grid_cull_plan`) against the full scan, and the C entry it is bound to."""
import dataclasses
import functools
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from robocheck_tpu.core.types import Mesh as JMesh
from robocheck_tpu.io.obj import load_obj as j_load_obj
from robocheck_tpu.models.shapes import box as j_box
from robocheck_tpu.models.shapes import icosphere as j_icosphere
from robocheck_tpu.planner import sdf as j_sdf
from robocheck_tpu_torch.core.types import Mesh
from robocheck_tpu_torch.io import assets
from robocheck_tpu_torch.kernels import _build
from robocheck_tpu_torch.kernels import sdf as ks
from robocheck_tpu_torch.kernels.clearance import _cascade, _dot
from robocheck_tpu_torch.models.shapes import icosphere
from robocheck_tpu_torch.planner.sdf import (build_distance_grid, grid_axes, grid_from_arrays,
                                             point_triangle_distance)
from robocheck_tpu_torch.profiling import bounds

REPO = Path(__file__).resolve().parents[1]


def _mesh(m):
    return Mesh(m.vertices, m.triangles, m.name)


def _degenerate_box(collinear: bool = False):
    """box(0.4, 2, 1) with a zero-area triangle and one whose edge c - a is
    the ray's direction (det exactly 0), both on the flat path of the ray
    test (the JAX package's Mesh). The zero-area triangle is a point (three
    equal corners) or, with ``collinear``, three distinct corners on a line:
    there each region test rests on a difference of two equal rounded
    products, which a fused multiply-add (XLA's, on the CPU) leaves a few
    ulp off 0."""
    b = j_box(extent=(0.4, 2.0, 1.0), name="o")
    zero = ([[0.0, -0.5, 0.0], [0.125, -0.5, 0.0], [0.25, -0.5, 0.0]] if collinear
            else [[0.0, -0.5, 0.0]] * 3)
    extra = np.array([*zero, [0.0, 0.0, 0.0], [0.0, 0.3, 0.1], list(0.125 * ks.RAY_DIR)],
                     np.float32)
    n = len(b.vertices)
    tris = np.concatenate([b.triangles, [[n, n + 1, n + 2], [n + 3, n + 4, n + 5]]])
    return JMesh(np.concatenate([b.vertices, extra]), tris.astype(np.int32), "degenerate")


def _scene(name):
    if name == "icosphere":
        return j_icosphere(2, radius=1.0, name="o")
    if name == "box":
        return j_box(extent=(0.4, 2.0, 1.0), name="o")
    if name == "alpha":
        return j_load_obj(str(assets.alpha_obstacle_path()))
    return _degenerate_box(collinear=name == "collinear")


def _tris(mesh) -> torch.Tensor:
    return torch.from_numpy(np.asarray(mesh.triangle_vertices, np.float32).reshape(-1, 9))


def test_point_triangle_distance_matches_jax():
    rng = np.random.default_rng(6)
    p = rng.normal(size=(2048, 3)).astype(np.float32) * 2
    tri = rng.normal(size=(64, 3, 3)).astype(np.float32)
    got = point_triangle_distance(torch.from_numpy(p)[:, None], torch.from_numpy(tri)[None])
    want = np.asarray(j_sdf.point_triangle_distance(p[:, None], tri[None]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scene", ["icosphere", "box", "alpha", "degenerate"])
def test_grid_matches_jax(scene):
    res = 12 if scene == "alpha" else 16
    obstacle = _scene(scene)
    mine = build_distance_grid(_mesh(obstacle), resolution=res, device="cpu")
    ref = j_sdf.build_distance_grid(obstacle, resolution=res)
    got, want = mine.values.numpy(), np.asarray(ref.values)
    scale = float(np.abs(obstacle.vertices).max())
    assert got.shape == want.shape == (res, res, res)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    assert (got < 0).any() and (got > 0).any()  # both inside and outside nodes
    np.testing.assert_array_equal(mine.origin.numpy(), np.asarray(ref.origin))
    np.testing.assert_array_equal(mine.spacing.numpy(), np.asarray(ref.spacing))
    unsigned = build_distance_grid(_mesh(obstacle), resolution=res, signed=False, device="cpu")
    np.testing.assert_array_equal(unsigned.values.numpy(), np.abs(got))


def test_collinear_triangle_grid_is_the_float64_distance():
    # A zero-area triangle of three collinear corners: the port's grid (each
    # multiply and add rounded on its own) classifies it as the segment it
    # is, so every node's unsigned value is the float64 distance to the
    # mesh, rounded, and never farther from it than JAX's grid, whose fused
    # multiply-adds leave the region tests a few ulp off 0 there.
    mesh = _degenerate_box(collinear=True)
    got = build_distance_grid(_mesh(mesh), resolution=16, signed=False, device="cpu").values
    pts = ks.grid_points(grid_axes(_mesh(mesh), 16)[0]).double()
    tris = torch.from_numpy(np.asarray(mesh.triangle_vertices, np.float64))
    truth = point_triangle_distance(pts[:, None], tris[None]).amin(dim=1).reshape(got.shape)
    np.testing.assert_allclose(got.numpy(), truth.numpy(), rtol=0, atol=1e-6)
    jax_grid = np.asarray(j_sdf.build_distance_grid(mesh, resolution=16, signed=False).values)
    err, jax_err = np.abs(got.numpy() - truth.numpy()), np.abs(jax_grid - truth.numpy())
    assert (err <= jax_err + 1e-7).all()
    tab = ks.grid_table(_tris(mesh))
    assert tab[-2:, 22].tolist() == [1.0, 1.0]  # both degenerate triangles are flat


@pytest.mark.parametrize("scene", ["alpha", "collinear"])
def test_one_sqrt_of_the_min_is_the_min_of_the_distances(scene):
    # The twin (and K4) take the sqrt once, of each node's min squared
    # distance: bit for bit the min of the per-pair distances, NaN for NaN
    # (a triangle with a = b != c, added to each mesh, gives 0 / 0 on part of
    # its edge region).
    mesh = _scene(scene)
    tris = _tris(mesh)
    nan_tri = torch.tensor([[0.1, 0.0, 0.0, 0.1, 0.0, 0.0, 0.1, 0.4, 0.0]])
    tris = torch.cat([tris, nan_tri])
    rng = np.random.default_rng(12)
    lo, hi = mesh.vertices.min(0), mesh.vertices.max(0)
    pts = torch.from_numpy(rng.uniform(lo - 0.3 * (hi - lo), hi + 0.3 * (hi - lo),
                                       (3000, 3)).astype(np.float32))
    pts = torch.cat([pts, ks.grid_points(grid_axes(_mesh(mesh), 10)[0])])
    got = ks.grid_values_reference(pts, ks.grid_table(tris), signed=False)
    want = point_triangle_distance(pts[:, None], tris.view(-1, 3, 3)[None]).amin(dim=1)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert bool(nan.any())
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def test_grid_table_is_what_the_per_pair_route_computes():
    # The table's terms, formed once per triangle, are the values the pair
    # pass would form for every (node, triangle): the distance's edges ab,
    # ac (clearance._cascade), and the ray test's e1, e2, pvec, det, inv_det
    # and flat flag, each broadcast over the nodes; so is the parity.
    mesh = _scene("alpha")
    tris = _tris(mesh)[::7]
    tab = ks.grid_table(tris)
    pts = ks.grid_points(grid_axes(_mesh(mesh), 8)[0])
    p = [pts[:, i, None] for i in range(3)]
    corner = [[tris[:, 3 * c + i] for i in range(3)] for c in range(3)]
    ab, ac = _cascade(p, *corner)[:2]
    d = [torch.tensor(x) for x in ks.RAY_DIR]
    e1 = [(corner[1][i] - corner[0][i]).expand(len(pts), -1) for i in range(3)]
    e2 = [(corner[2][i] - corner[0][i]).expand(len(pts), -1) for i in range(3)]
    pvec = [d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
            d[0] * e2[1] - d[1] * e2[0]]
    det = _dot(e1, pvec)
    flat = det.abs() < 1e-12
    inv_det = torch.where(flat, 0.0, 1.0 / torch.where(flat, 1.0, det))
    for col, pair in [*zip(range(9, 15), [*ab, *ac]), *zip(range(9, 15), [*e1, *e2]),
                      *zip(range(18, 21), pvec), (21, inv_det), (22, flat.float())]:
        assert torch.equal(tab[:, col].expand(len(pts), -1), pair.expand(len(pts), -1)), col
    assert torch.equal(tab[:, 23], torch.zeros(len(tris)))
    tv = [p[i] - corner[0][i] for i in range(3)]
    q = [tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
         tv[0] * e1[1] - tv[1] * e1[0]]
    u, v, t = _dot(tv, pvec) * inv_det, _dot(q, d) * inv_det, _dot(q, e2) * inv_det
    cross = ~flat & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    signed = ks.grid_values_reference(pts, tab)
    assert torch.equal(torch.signbit(signed), cross.sum(dim=1) % 2 == 1)
    assert cross.any() and not cross.all()


def test_grid_work_counts_follow_the_pairs():
    mesh = _scene("collinear")
    tris = _tris(mesh)
    pts = ks.grid_points(grid_axes(_mesh(mesh), 6)[0])
    regions, ray = ks.grid_work_counts(pts, ks.grid_table(tris))
    pairs = len(pts) * len(tris)
    assert regions.sum() == pairs and len(regions) == len(ks.REGIONS)
    # Two of the 14 triangles are flat; the stages only narrow.
    assert ray[0] == len(pts) * 12 and ray[0] >= ray[1] >= ray[2] > 0


def test_grid_from_arrays_query_matches_jax():
    ref = j_sdf.build_distance_grid(j_icosphere(1, radius=1.0), resolution=16)
    mine = grid_from_arrays(np.asarray(ref.values), np.asarray(ref.origin),
                            np.asarray(ref.spacing), device="cpu")
    rng = np.random.default_rng(8)
    pts = rng.uniform(-2.0, 2.0, (4096, 3)).astype(np.float32)  # some outside: clamped
    got = mine.query(torch.from_numpy(pts)).numpy()
    want = np.asarray(ref.query(pts))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_query_is_differentiable():
    grid = build_distance_grid(icosphere(1, radius=1.0), resolution=16, device="cpu")
    pts = torch.tensor([[1.3, 0.1, -0.2], [0.0, 0.0, 0.0]], requires_grad=True)
    grid.query(pts).sum().backward()
    g = pts.grad
    assert torch.isfinite(g).all()
    # Outside the sphere (inside the grid) the distance grows outward along x.
    assert g[0, 0] > 0.5


def test_build_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card error")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_distance_grid(icosphere(1), resolution=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        grid_from_arrays(np.zeros((2, 2, 2)), np.zeros(3), np.ones(3))


def test_cpu_grids_never_reach_the_build():
    # A fresh interpreter: a grid on the CPU runs the twin and never imports
    # the nvcc build module; the wrapper refuses CPU tensors.
    code = (
        "import sys, torch\n"
        "from robocheck_tpu_torch.kernels import sdf as ks\n"
        "from robocheck_tpu_torch.models.shapes import icosphere\n"
        "from robocheck_tpu_torch.planner.sdf import build_distance_grid, grid_axes\n"
        "build_distance_grid(icosphere(1), resolution=6, device='cpu')\n"
        "axes = grid_axes(icosphere(1), 4)[0]\n"
        "tab = ks.grid_table(ks.grid_order(torch.zeros((1, 9))))\n"
        "try:\n"
        "    ks.sdf_grid_cuda(axes, tab, ks.grid_cull(axes, tab))\n"
        "    raise SystemExit('a CPU tensor reached the kernel')\n"
        "except ValueError as e:\n"
        "    assert 'CUDA' in str(e)\n"
        "assert ks.sdf_grid_cuda.launches == 0\n"
        "assert 'robocheck_tpu_torch.kernels._build' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_clearance_cu_declares_the_grid_entry():
    # Every entry `kernels/sdf.py` and `kernels/clearance.py` call is bound
    # in `_build.library` and declared in `csrc/clearance.cu` with as many
    # parameters as its argtypes; K4's in this order.
    src = _build.SOURCES["clearance"].read_text()
    extern = src[src.index('extern "C" {'):]
    declared = {name: len([a for a in args.split(",") if a.strip()])
                for name, args in re.findall(
                    r"\n(?:int|int64_t|const char\*) (rc_\w+)\(([^)]*)\)", extern)}
    build_src = Path(_build.__file__).read_text()
    block = build_src[build_src.index('elif name == "clearance":'):]
    block = block[:block.index('elif name == "front":')]
    bound = {name: len([a for a in args.split(",") if a.strip()])
             for name, args in re.findall(r"_bind\(lib\.(rc_\w+), [\w.]+,\s*\[([^\]]*)\]",
                                          block)}
    callers = (Path(ks.__file__).read_text()
               + (REPO / "robocheck_tpu_torch" / "kernels" / "clearance.py").read_text())
    called = set(re.findall(r"lib\.(rc_\w+)", callers))
    assert "rc_sdf_grid" in called and called <= set(bound)
    assert bound == declared
    params = re.search(r"\nint rc_sdf_grid\(([^)]*)\)", extern).group(1)
    names = [a.split()[-1].lstrip("*") for a in params.split(",")]
    assert names == ["ax", "ay", "az", "nx", "ny", "nz", "gtab", "nt", "gbox", "always",
                     "rslack", "ng", "slack", "signed_", "dx", "dy", "dz", "out", "counts",
                     "scratch", "scratch_bytes", "stream"]
    assert re.search(r"\nconstexpr int kGridRow = " + str(ks.ROW) + ";", src)


# ---- K4's cull: `grid_cull_plan` reproduces the kernel's (warp brick,
# group) scans; the twin restricted to them must give the full twin's bits.

def _nan_box():
    """box(0.4, 2, 1) with an a = b != c triangle: 0 / 0 on part of its edge
    region, so some nodes read NaN (the JAX package's Mesh)."""
    b = j_box(extent=(0.4, 2.0, 1.0), name="o")
    extra = np.array([[0.1, 0.0, 0.0], [0.1, 0.0, 0.0], [0.1, 0.4, 0.0]], np.float32)
    n = len(b.vertices)
    tris = np.concatenate([b.triangles, [[n, n + 1, n + 2]]]).astype(np.int32)
    return JMesh(np.concatenate([b.vertices, extra]), tris, "a = b != c")


def _far_sphere():
    """icosphere(2) moved 10^3 extents from the origin: the slack grows with
    the coordinates."""
    s = j_icosphere(2, radius=1.0, name="o")
    return JMesh((s.vertices + np.float32(2000.0)).astype(np.float32), s.triangles, "far")


def _grazing_sliver():
    """A well-shaped triangle (not thin by THIN, |det| ~2.4e-7, not flat)
    whose plane holds two lattice directions and nearly RAY_DIR, so that
    the 16^3 lattice's nodes in that plane, outside the triangle and past
    its box, get rounded crossings; two small triangles at the corners of
    [0, 10] x [0, 10] x [0, 10 d_z / d_y] fix the lattice (spacing 1 along
    x and y). A box grown by the distance slack alone would skip two such
    nodes' crossings."""
    d = ks.RAY_DIR.astype(np.float64)
    hi = np.array([10.0, 10.0, 10.0 * d[2] / d[1] * (1 + 1e-7)])
    anchors = np.float32([[0, 0, 0], [0.2, 0, 0], [0, 0.2, 0], hi, hi - [0.2, 0, 0],
                          hi - [0, 0.2, 0]])
    lattice = grid_axes(Mesh(anchors, np.array([[0, 1, 2], [3, 4, 5]], np.int32), "a"), 16)[0]
    a, b, c = ([float(x[n]) for x, n in zip(lattice, ijk)]
               for ijk in ((4, 4, 4), (8, 4, 4), (4, 8, 8)))
    verts = np.concatenate([np.float32([a, b, c]), anchors])
    return JMesh(verts, np.arange(9, dtype=np.int32).reshape(3, 3), "grazing sliver")


# (scene, nodes per axis, group size): the kernel's groups of 32, and groups
# of 4 (1 for the sliver) where a mesh has few triangles, so that the rule
# culls there too.
_CULL_SCENES = {
    "alpha": (lambda: _scene("alpha"), 24, ks.GROUP),
    "icosphere": (lambda: _scene("icosphere"), 16, ks.GROUP),
    "icosphere-g4": (lambda: _scene("icosphere"), 16, 4),
    "box": (lambda: _scene("box"), 16, ks.GROUP),
    "box-g4": (lambda: _scene("box"), 16, 4),
    "degenerate-g4": (lambda: _degenerate_box(collinear=True), 16, 4),
    "nan-g4": (_nan_box, 16, 4),
    "box222": (lambda: j_box(extent=(2.0, 2.0, 2.0), name="o"), 25, 4),
    "far": (_far_sphere, 16, 4),
    "sliver-g1": (_grazing_sliver, 16, 1),
}


@functools.cache
def _culled(name):
    """(mesh, axes, ordered table, cull, plan) of a cull scene (the file's
    tests share them and change none)."""
    make, res, size = _CULL_SCENES[name]
    mesh = make()
    axes = grid_axes(_mesh(mesh), res)[0]
    table = ks.grid_table(ks.grid_order(_tris(mesh)))
    cull = ks.grid_cull(axes, table, size)
    return mesh, axes, table, cull, ks.grid_cull_plan(axes, table, cull)


@functools.cache
def _full_twin(name, signed):
    """The full twin's grid of a cull scene (shared like ``_culled``'s)."""
    _, axes, table, *_ = _culled(name)
    shape = tuple(len(a) for a in axes)
    return ks.grid_values_reference(ks.grid_points(axes), table, signed).view(shape)


def _same_bits(a, b):
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("name", list(_CULL_SCENES))
def test_planned_twin_is_the_full_twin(name):
    # Restricted to the plan's scans, the twin gives the full scan's float32
    # bits, signed and unsigned: NaN nodes, -0.0 nodes, bricks the lattice's
    # edge cuts and the far scene's slack included.
    mesh, axes, table, cull, plan = _culled(name)
    shape = tuple(len(a) for a in axes)
    for signed in (False, True):
        full = _full_twin(name, signed)
        assert _same_bits(ks.grid_values_planned(axes, table, plan, signed), full), signed
    if name.startswith("nan"):
        assert bool(full.isnan().any())
    if name == "box222":
        assert bool(((full == 0) & torch.signbit(full)).any())
        assert any(n % w for n, w in zip(shape, ks.BRICK[1]))  # an edge cuts a warp brick
    if name in ("alpha", "icosphere-g4", "far", "sliver-g1"):  # the rule culls here
        assert not bool(plan.dist.all()) and not bool(plan.ray.all())
    if name == "sliver-g1":
        # The sliver's boxes grown by the distance slack alone lose crossings
        # the full scan counts; its ray slack keeps them.
        flat = dataclasses.replace(cull, ray_slack=torch.full_like(cull.ray_slack, cull.slack))
        lost = ks.grid_values_planned(axes, table, ks.grid_cull_plan(axes, table, flat))
        assert not _same_bits(lost, full)
        assert bool(torch.isinf(cull.ray_slack).any())


@pytest.mark.parametrize("name", ["alpha", "icosphere", "box"])
def test_planned_twin_matches_jax(name):
    # The restricted twin against JAX's `_grid_distances` / `_grid_inside`
    # (its build_distance_grid), at `test_grid_matches_jax`'s tolerance.
    mesh, axes, table, cull, plan = _culled(name)
    res = len(axes[0])
    got = ks.grid_values_planned(axes, table, plan).numpy()
    want = np.asarray(j_sdf.build_distance_grid(mesh, resolution=res).values)
    scale = float(np.abs(mesh.vertices).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


@pytest.mark.parametrize("name", ["alpha", "degenerate-g4", "nan-g4"])
def test_morton_order_keeps_the_bits(name):
    # `grid_order` permutes the triangles; the min and the parity's XOR are
    # order-free, so the full twin's bits do not move.
    mesh, axes, table, *_ = _culled(name)
    pts = ks.grid_points(axes)
    raw = ks.grid_table(_tris(mesh))
    assert not torch.equal(table, raw) or name != "alpha"
    for signed in (True, False):
        assert _same_bits(_full_twin(name, signed).flatten(),
                          ks.grid_values_reference(pts, raw, signed))


@pytest.mark.parametrize("name", ["alpha", "icosphere-g4", "box222"])
def test_plan_work_is_at_most_the_full_scan(name):
    # The kept pairs, their regions and ray stages never exceed the full
    # scan's, and the culled-work bound over them is at most the full-scan
    # bound; the pairs the plan names are its counts'.
    mesh, axes, table, cull, plan = _culled(name)
    pts = ks.grid_points(axes)
    nodes, nt = len(pts), len(table)
    d_pairs, r_pairs = plan.pairs(nt)
    regions, ray = ks.grid_work_counts(pts, table, plan)
    f_regions, f_ray = ks.grid_work_counts(pts, table)
    assert regions.sum() == d_pairs <= f_regions.sum() == nodes * nt
    assert ray[0] <= r_pairs <= nodes * nt
    assert (ray <= f_ray).all() and (ray[1:] <= ray[:-1]).all()
    culled = bounds.grid_work(nodes, nt, True, regions, ray, r_pairs)
    full = bounds.grid_work(nodes, nt, True, f_regions, f_ray)
    assert culled[1] <= full[1]
    assert bounds.bound_ms(*culled)[0] <= bounds.bound_ms(*full)[0]
    with_groups = bounds.grid_work(nodes, nt, True, regions, ray, r_pairs,
                                   cull.boxes.shape[0])
    assert with_groups == (culled[0] + 29 * cull.boxes.shape[0], culled[1])


@pytest.mark.parametrize("flag", ["always", "nan box"])
def test_always_and_nan_groups_are_kept(flag):
    # An `always` group and a group whose box is NaN are measured and tested
    # by every warp, however far they are; the bits still hold.
    _, axes, table, cull, plan = _culled("alpha")
    far = int(torch.argmin(plan.dist.sum(dim=0)))  # the group fewest warps measure
    assert not bool(plan.dist[:, far].all())
    boxes, always = cull.boxes.clone(), cull.always.clone()
    if flag == "always":
        always[far] = 1
    else:
        boxes[far] = float("nan")
    marked = dataclasses.replace(cull, boxes=boxes, always=always)
    plan2 = ks.grid_cull_plan(axes, table, marked)
    assert bool(plan2.dist[:, far].all()) and bool(plan2.ray[:, far].all())
    assert _same_bits(ks.grid_values_planned(axes, table, plan2), _full_twin("alpha", True))


def test_grid_slack_is_the_engines_rule_on_the_grid_scene():
    # 2 x err_bound, err_bound = 128 float32 eps x the largest finite
    # |coordinate| of the axes and triangles, at least 1.
    eps = float(np.finfo(np.float32).eps)
    far = _far_sphere()
    axes = grid_axes(_mesh(far), 8)[0]
    tri = _tris(far)
    scale = max(float(tri.abs().max()), *(float(a.abs().max()) for a in axes))
    assert ks.grid_slack(axes, tri) == 2 * 128 * eps * scale
    small = [torch.tensor([0.0, 0.5]), torch.tensor([0.25]), torch.tensor([-0.5])]
    tri = torch.tensor([[0.1, 0.2, 0.3, float("inf"), 0.0, float("nan"), 0.0, 0.0, 0.0]])
    assert ks.grid_slack(small, tri) == 2 * 128 * eps


def test_grid_constants_match_the_kernel():
    # The plan's group size and bricks are the kernel's build-time defaults,
    # and RAY_INV is the float32 1 / RAY_DIR the launcher forms.
    src = _build.SOURCES["clearance"].read_text()

    def default(name):
        return int(re.search(r"#ifndef RC_GRID_" + name + r"\n#define RC_GRID_" + name
                             + r" (\d+)\n", src).group(1))

    assert re.search(r"\nconstexpr int kGroup = " + str(ks.GROUP) + ";", src)
    assert ks.BRICK == (tuple(default(n) for n in ("BX", "BY", "BZ")),
                        tuple(default(n) for n in ("WX", "WY", "WZ")))
    np.testing.assert_array_equal(ks.RAY_INV, (np.float32(1) / ks.RAY_DIR).astype(np.float32))
    assert (ks.RAY_DIR > 0).all()  # the sweep's slab test needs every component positive


def _sweep_meets64(p, lo, hi):
    """Whether the ray from each point of ``p`` [N, 3] along +RAY_DIR meets
    the box [lo, hi], in float64."""
    d = ks.RAY_DIR.astype(np.float64)
    a, b = (lo - p) / d, (hi - p) / d
    return (b.min(axis=1) >= 0) & (a.max(axis=1) <= b.min(axis=1))


@pytest.mark.parametrize("tilt", [1.0, 1e-2, 1e-4, 1e-6, 1e-7, "thin"])
def test_ray_error_bounds_every_declared_crossing(tilt):
    # Points whose rays pass near a triangle, from one facing the ray to one
    # nearly parallel to it (|det| ~ tilt) and a thin one: wherever the
    # rounded test declares a crossing, the ray meets the triangle's box
    # grown by `ray_error` (float64). At a tilt of 1e-7 the distance slack
    # alone does not cover them.
    rng = np.random.default_rng(13)
    d = ks.RAY_DIR.astype(np.float64)
    w = np.cross(d, [0.0, 0.0, 1.0])
    w /= np.linalg.norm(w)
    n = np.cross(d, w)
    a = np.array([0.1, 0.2, 0.3])
    if tilt == "thin":
        verts = np.stack([a, a + w, a + 2 * w + 1e-5 * n])
    else:
        verts = np.stack([a, a + (tilt * n + (1 - tilt) * d), a + w])
    verts = verts.astype(np.float32)
    table = ks.grid_table(torch.from_numpy(verts.reshape(1, 9)))
    m = 200_000
    uv = rng.uniform(-20, 20, size=(m, 2))
    v64 = verts.astype(np.float64)
    x = v64[0] + uv[:, :1] * (v64[1] - v64[0]) + uv[:, 1:] * (v64[2] - v64[0])
    p = (x - rng.uniform(0, 10, size=(m, 1)) * d).astype(np.float32)
    axes = [torch.tensor([float(p[:, c].min()), float(p[:, c].max())]) for c in range(3)]
    corners, e1, e2, pvec, inv_det, flat = ks._columns(table)
    pt = torch.from_numpy(p)
    cross = ks._crossings([pt[:, c, None] for c in range(3)], corners, e1, e2, pvec, inv_det,
                          flat, ks._ray("cpu"))[0][:, 0].numpy()
    err = float(ks.ray_error(axes, table)[0])
    assert cross.sum() > 0
    lo, hi = v64.min(axis=0), v64.max(axis=0)
    p64 = p.astype(np.float64)
    assert not (cross & ~_sweep_meets64(p64, lo - err, hi + err)).any()
    slack = ks.grid_slack(axes, table[:, :9])
    lost = (cross & ~_sweep_meets64(p64, lo - slack, hi + slack)).sum()
    assert (lost > 0) == (tilt == 1e-7), lost


def test_grid_ray_slack_rounds_up_and_bounds_flat_and_parallel_rows():
    # A flat row never crosses (error 0); a row whose determinant the bound
    # cannot tell from 0 is unbounded (inf); a group takes its worst row
    # plus the slack, rounded up to float32.
    d = ks.RAY_DIR
    a = np.float32([0.1, 0.2, 0.3])
    tris = np.stack([np.stack([a, a + np.float32([1, 0, 0]), a + np.float32([0, 1, 0])]),
                     np.stack([a, a + d, a + 2 * d]),                      # flat
                     np.stack([a, a + np.float32([1, 0, 0]), a + d])]).astype(np.float32)
    tris[2, 2] += np.float32(1e-6) * np.float32([0, 1, -1])  # |det| ~ 1e-6, nearly flat
    table = ks.grid_table(torch.from_numpy(tris.reshape(3, 9)))
    axes = [torch.tensor([-1.0, 2.0])] * 3
    err = ks.ray_error(axes, table)
    assert bool(table[1, 22]) and err[1] == 0
    assert 0 < err[0] < 1e-3 and err[2] > 100 * err[0]
    slack = ks.grid_slack(axes, table[:, :9])
    for size in (1, 2, 3):
        got = ks.grid_ray_slack(axes, table, size, slack)
        want = np.pad(err, (0, -len(err) % size)).reshape(-1, size).max(axis=1) + slack
        assert got.dtype == np.float32 and (got.astype(np.float64) >= want).all()
        assert (np.nextafter(got, np.float32(0)).astype(np.float64) < want).all()
    huge = tris.copy()
    huge[2, 2] = a + d + np.float32(1e-7) * np.float32([0, 1, -1])
    table = ks.grid_table(torch.from_numpy(huge.reshape(3, 9)))
    assert not bool(table[2, 22])  # |det| ~ 1e-7: the kernel tests it
    assert np.isinf(ks.ray_error([torch.tensor([-1e3, 1e3])] * 3, table)[2])
