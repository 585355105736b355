"""The port's distance grid (`robocheck_tpu_torch.planner.sdf`) against the
JAX package's `robocheck_tpu.planner.sdf`, on the CPU."""
import numpy as np
import pytest
import torch

from robocheck_tpu.models.shapes import box as j_box
from robocheck_tpu.models.shapes import icosphere as j_icosphere
from robocheck_tpu.planner import sdf as j_sdf
from robocheck_tpu_torch.core.types import Mesh
from robocheck_tpu_torch.models.shapes import icosphere
from robocheck_tpu_torch.planner.sdf import (build_distance_grid, grid_from_arrays,
                                             point_triangle_distance)


def _mesh(m):
    return Mesh(m.vertices, m.triangles, m.name)


def test_point_triangle_distance_matches_jax():
    rng = np.random.default_rng(6)
    p = rng.normal(size=(2048, 3)).astype(np.float32) * 2
    tri = rng.normal(size=(64, 3, 3)).astype(np.float32)
    got = point_triangle_distance(torch.from_numpy(p)[:, None], torch.from_numpy(tri)[None])
    want = np.asarray(j_sdf.point_triangle_distance(p[:, None], tri[None]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scene", ["icosphere", "box"])
def test_grid_matches_jax(scene):
    obstacle = (j_icosphere(2, radius=1.0, name="o") if scene == "icosphere"
                else j_box(extent=(0.4, 2.0, 1.0), name="o"))
    mine = build_distance_grid(_mesh(obstacle), resolution=16, device="cpu")
    ref = j_sdf.build_distance_grid(obstacle, resolution=16)
    got, want = mine.values.numpy(), np.asarray(ref.values)
    scale = float(np.abs(obstacle.vertices).max())
    assert got.shape == want.shape == (16, 16, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    assert (got < 0).any() and (got > 0).any()  # both inside and outside nodes
    np.testing.assert_array_equal(mine.origin.numpy(), np.asarray(ref.origin))
    np.testing.assert_array_equal(mine.spacing.numpy(), np.asarray(ref.spacing))
    unsigned = build_distance_grid(_mesh(obstacle), resolution=16, signed=False, device="cpu")
    np.testing.assert_array_equal(unsigned.values.numpy(), np.abs(got))


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
