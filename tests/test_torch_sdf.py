"""The port's distance grid (`robocheck_tpu_torch.planner.sdf`) against the
JAX package's `robocheck_tpu.planner.sdf`, on the CPU, and K4's twin
(`robocheck_tpu_torch.kernels.sdf`): its hoisted per-triangle table and its
single sqrt against the per-pair route, and the C entry it is bound to."""
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
        "tab = ks.grid_table(torch.zeros((1, 9)))\n"
        "try:\n"
        "    ks.sdf_grid_cuda(axes, tab)\n"
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
    assert names == ["ax", "ay", "az", "nx", "ny", "nz", "gtab", "nt", "signed_", "dx", "dy",
                     "dz", "out", "stream"]
    assert re.search(r"\nconstexpr int kGridRow = " + str(ks.ROW) + ";", src)
