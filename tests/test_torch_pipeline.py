"""The port's dense reference pipeline (`robocheck_tpu_torch.ops.pipeline`),
its narrow-phase helpers and `PaddedMesh`, against the JAX package's on the
CPU (JAX's side jitted on the CPU).

Tolerances: booleans exactly; floats within rtol 1e-6 and atol 1e-6 x the
inputs' scale (the largest magnitude among a helper's inputs). Both sides
compute in float32; XLA on the CPU may fuse a multiply and an add where the
port rounds each (the 3-vector cross product of `intersect_line`), which
moves a value by a few ulp of the products' scale. `CollisionWorld`'s
verdicts and `CheckResult` fields are held to JAX's `CollisionWorld`
exactly, and to the tagged goldens as `tests/test_pipeline_golden.py` does.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robocheck_tpu.io.obj import load_obj as j_load_obj
from robocheck_tpu.models import shapes as j_shapes
from robocheck_tpu.ops import narrow as j_nar
from robocheck_tpu.ops import pipeline as j_pipe
from robocheck_tpu_torch import CheckResult, CollisionWorld, PaddedMesh, PipelineConfig
from robocheck_tpu_torch.core.constants import TOL
from robocheck_tpu_torch.io import assets
from robocheck_tpu_torch.io.conf import write_conf_file
from robocheck_tpu_torch.io.obj import load_obj
from robocheck_tpu_torch.models import shapes
from robocheck_tpu_torch.ops import narrow as nar

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-6, 1e-6  # atol in units of the inputs' scale


def _tris(rng, n):
    return rng.normal(size=(n, 3, 3)).astype(np.float32)


def _segments(rng, n=256):
    """Segment pairs: crossing in a shared plane, touching at an end,
    parallel, collinear-overlapping, zero-length, and random skew ones."""
    p1, p2 = rng.normal(size=(2, n, 3)).astype(np.float32)
    mid = 0.5 * (p1 + p2)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    cross = (mid - d, mid + d)
    touch = (p2, p2 + d)
    parallel = (p1 + d, p2 + d)
    collinear = (p1 + 0.25 * (p2 - p1), p2 + 0.25 * (p2 - p1))
    zero = (p1, p1)
    skew = tuple(rng.normal(size=(2, n, 3)).astype(np.float32))
    out = [np.concatenate(x) for x in zip(*[(p1, p2) + c for c in
                                            (cross, touch, parallel, collinear, zero, skew)])]
    return out  # p1, p2, p3, p4, each [6n, 3]


def _coplanar_pairs(rng, n=128):
    """Coplanar triangle pairs (z = 0): crossing, one inside the other,
    disjoint; and random non-coplanar pairs."""
    a = rng.uniform(-1, 1, (n, 3, 3)).astype(np.float32)
    a[..., 2] = 0.0
    inside = 0.2 * a + a.mean(axis=1, keepdims=True) * 0.8
    shifted = a + np.float32([0.3, 0.1, 0.0])
    far = a + np.float32([10.0, 0.0, 0.0])
    rnd = rng.normal(size=(n, 3, 3)).astype(np.float32)
    return (np.concatenate([a, a, a, rng.normal(size=(n, 3, 3)).astype(np.float32)]),
            np.concatenate([shifted, inside, far, rnd]))


def _la_inputs(rng, n=512):
    """Random 2x2 systems, with a1 exactly 0, inside the TOL band, at its
    edge, and a zero system (whose unguarded divisions give inf / NaN on
    both sides alike)."""
    a = [rng.normal(size=n).astype(np.float32) for _ in range(6)]
    a[0][: n // 8] = 0.0
    a[0][n // 8 : n // 4] = np.float32(TOL / 2)
    a[0][n // 4 : 3 * n // 8] = np.float32(TOL)
    for x in a:
        x[-1] = 0.0
    return a


def _plane_inputs(rng, n=512):
    n1, n2 = rng.normal(size=(2, n, 3)).astype(np.float32)
    d1, d2 = rng.normal(size=(2, n)).astype(np.float32)
    n2[: n // 8] = 3.0 * n1[: n // 8]  # parallel planes: D = 0
    n2[n // 8 : n // 4, 2] = 0.0  # D along z only where n1 also has no z
    n1[n // 8 : n // 4, 2] = 0.0
    d2[: n // 16] = 3.0 * d1[: n // 16]  # the same plane
    return n1, d1, n2, d2


def _call(name, rng):
    """(port outputs, JAX outputs, inputs' scale) of helper ``name`` on
    seeded inputs."""
    t, j = torch.from_numpy, jnp.asarray
    if name == "isclose":
        v1 = rng.normal(size=512).astype(np.float32) * np.float32(1e3)
        v2 = (v1 * (1 + rng.normal(size=512) * 1e-6)).astype(np.float32)
        v2[:64] = rng.normal(size=64).astype(np.float32) * 1e-7
        args = (v1, v2)
        return nar.isclose(*map(t, args)), j_nar.isclose(*map(j, args)), 1e3
    if name == "compute_plane":
        tri = _tris(rng, 512)
        return nar.compute_plane(t(tri)), j_nar.compute_plane(j(tri)), np.abs(tri).max() ** 2
    if name == "signed_dists":
        tri, other = _tris(rng, 512), _tris(rng, 512)
        other[:64] = tri[:64]  # on the plane: inside the band
        n, d = nar.compute_plane(t(tri))
        jn, jd = j_nar.compute_plane(j(tri))
        mine = nar.signed_dists(n, d, t(other))
        ref = j_nar.signed_dists(jn, jd, j(other))
        return ((mine, nar.no_overlap(mine)), (ref, j_nar.no_overlap(ref)),
                np.abs(tri).max() ** 3)
    if name == "la_solve":
        a = _la_inputs(rng)
        return nar.la_solve(*map(t, a)), j_nar.la_solve(*map(j, a)), 1.0
    if name == "intersect_line":
        p = _plane_inputs(rng)
        return nar.intersect_line(*map(t, p)), j_nar.intersect_line(*map(j, p)), 1.0
    if name == "canonicalize":
        tri = _tris(rng, 512)
        dists = rng.choice(np.float32([-1.0, 0.0, 1.0, TOL / 2]), size=(512, 3))
        dists = dists.astype(np.float32)
        return (nar.canonicalize(t(tri), t(dists)), j_nar.canonicalize(j(tri), j(dists)),
                np.abs(tri).max())
    if name == "is_coplanar":
        n1, d1, n2, d2 = _plane_inputs(rng)
        n2[-64:], d2[-64:] = n1[-64:] * 2.0, d1[-64:] * 2.0
        n1[:32, 0] = 0.0  # a zero component on one side only
        args = (n1, d1, n2, d2)
        return nar.is_coplanar(*map(t, args)), j_nar.is_coplanar(*map(j, args)), 1.0
    if name == "_d_mnop":
        p = _segments(rng)
        return nar._d_mnop(*map(t, p)), j_nar._d_mnop(*map(j, p)), np.abs(p).max() ** 2
    if name == "segments_intersect":
        p = _segments(rng)
        return nar.segments_intersect(*map(t, p)), j_nar.segments_intersect(*map(j, p)), 1.0
    if name == "coplanar_intersects":
        a, b = _coplanar_pairs(rng)
        return (nar.coplanar_intersects(t(a), t(b)), j_nar.coplanar_intersects(j(a), j(b)),
                1.0)
    raise AssertionError(name)


def _flat(x):
    return [x] if isinstance(x, (torch.Tensor, jnp.ndarray)) else [y for v in x for y in _flat(v)]


# One case per class of tests/test_narrow_helpers.py (TestIsclose, TestPlane,
# TestSignedDistsNoOverlap, TestIntersectLine, TestCanonicalize,
# TestIsCoplanar, TestCoplanarPath) and the helpers under them.
HELPERS = ["isclose", "compute_plane", "signed_dists", "la_solve", "intersect_line",
           "canonicalize", "is_coplanar", "_d_mnop", "segments_intersect",
           "coplanar_intersects"]


@pytest.mark.parametrize("name", HELPERS)
def test_narrow_helper_matches_jax(name):
    mine, ref, scale = _call(name, np.random.default_rng(HELPERS.index(name) + 11))
    for m, r in zip(_flat(mine), _flat(ref), strict=True):
        m, r = m.numpy(), np.asarray(r)
        assert m.shape == r.shape and m.dtype == r.dtype
        if m.dtype == bool:
            np.testing.assert_array_equal(m, r)
        else:
            np.testing.assert_allclose(m, r, rtol=RTOL, atol=ATOL * max(scale, 1.0))


def test_segment_and_coplanar_cases_reach_both_verdicts():
    # The seeded inputs above exercise both answers of each boolean helper.
    rng = np.random.default_rng(HELPERS.index("segments_intersect") + 11)
    hits = nar.segments_intersect(*map(torch.from_numpy, _segments(rng)))
    assert 0 < int(hits.sum()) < hits.numel()
    rng = np.random.default_rng(HELPERS.index("coplanar_intersects") + 11)
    a, b = _coplanar_pairs(rng)
    cop = nar.coplanar_intersects(torch.from_numpy(a), torch.from_numpy(b))
    assert 0 < int(cop.sum()) < cop.numel()


def test_guarded_divisions_stay_finite():
    # The divisions the JAX code guards (a1 in la_solve, bad_a / bad_b in
    # segments_intersect) never make inf or NaN: a1 = 0 with a solvable
    # system gives finite answers, and parallel or zero-length segments a
    # plain False.
    one = torch.ones(4)
    zero = torch.zeros(4)
    x1, x2 = nar.la_solve(zero, 2 * one, 3 * one, 5 * one, 4 * one, 7 * one)
    assert torch.isfinite(x1).all() and torch.isfinite(x2).all()
    torch.testing.assert_close(x2, 2 * one)
    p = torch.tensor([[0.0, 0, 0]])
    q = torch.tensor([[1.0, 0, 0]])
    up = torch.tensor([[0.0, 1, 0]])
    assert not nar.segments_intersect(p, q, p + up, q + up).any()  # parallel
    assert not nar.segments_intersect(p, q, up, up).any()  # zero length
    assert nar.segments_intersect(p, q, torch.tensor([[0.5, -1, 0]]),
                                  torch.tensor([[0.5, 1, 0]])).all()


@pytest.mark.parametrize("lane", [128, 32])
def test_padded_mesh_matches_jax(lane):
    robot, ref = (load_obj(assets.alpha_robot_path()), j_load_obj(assets.alpha_robot_path()))
    for mine, want in ((robot.padded(lane), ref.padded(lane)),
                       (shapes.icosphere(1).padded(lane), j_shapes.icosphere(1).padded(lane))):
        assert isinstance(mine, PaddedMesh) and mine.num_triangles == want.num_triangles
        for field in ("vertices", "triangles", "tri_mask", "triangle_vertices"):
            a, b = getattr(mine, field), getattr(want, field)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        pad = ~mine.tri_mask
        assert pad.sum() == len(mine.triangles) - mine.num_triangles
        np.testing.assert_array_equal(mine.triangles[pad], 0)  # repeats vertex 0


def _worlds(robot_path_or_meshes, block=64, max_pairs=8192):
    cfg = dict(batch_block=block, narrow_chunk=8, max_pairs=max_pairs)
    if isinstance(robot_path_or_meshes, str):
        r, o = load_obj(assets.alpha_robot_path()), load_obj(assets.alpha_obstacle_path())
        jr, jo = j_load_obj(assets.alpha_robot_path()), j_load_obj(assets.alpha_obstacle_path())
    else:
        (r, o), (jr, jo) = robot_path_or_meshes
    return (CollisionWorld(r, o, PipelineConfig(**cfg), device="cpu"),
            j_pipe.CollisionWorld(jr, jo, j_pipe.PipelineConfig(**cfg)))


def _shapes_scene():
    rng = np.random.default_rng(21)
    confs = np.zeros((64, 6), np.float32)
    confs[:, 0:3] = rng.uniform(-2.0, 2.0, (64, 3))
    confs[:, 3:6] = rng.uniform(-np.pi, np.pi, (64, 3))
    meshes = ((shapes.icosphere(2, 0.5), shapes.box((2.0, 0.4, 2.0))),
              (j_shapes.icosphere(2, 0.5), j_shapes.box((2.0, 0.4, 2.0))))
    return meshes, confs


@pytest.mark.parametrize("scene", ["hard10k", "easy10k", "samples10k", "shapes"])
def test_collision_world_matches_jax(scene, request):
    if scene == "shapes":
        meshes, confs = _shapes_scene()
        mine, ref = _worlds(meshes)
    else:
        mine, ref = _worlds("alpha")
        confs = request.getfixturevalue(scene).confs[:64]
    for resolve in (True, False):
        cfg = dict(resolve_coplanar=resolve)
        mine.config = PipelineConfig(**{**mine.config.__dict__, **cfg})
        ref.config = j_pipe.PipelineConfig(**{**ref.config.__dict__, **cfg})
        v, res = mine.check(confs, return_result=True)
        jv, jres = ref.check(confs, return_result=True)
        assert isinstance(res, CheckResult)
        np.testing.assert_array_equal(v, jv)
        for field in ("valid", "broad_valid", "coplanar", "num_pairs"):
            a, b = getattr(res, field), np.asarray(getattr(jres, field))
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert not res.overflow.any()
    assert 0 < int(v.sum()) < len(v) or scene == "easy10k"


def test_collision_world_goldens_and_pieces(hard10k, easy10k):
    # 64-row slices against the tagged goldens; a tiny max_pairs splits the
    # narrow phase into many pieces and changes no verdict, no count, and
    # overflows nothing.
    world, _ = _worlds("alpha")
    small = CollisionWorld(world.robot, world.obstacle,
                           PipelineConfig(batch_block=48, max_pairs=16), device="cpu")
    for ds in (hard10k, easy10k):
        confs = ds.confs[:64]
        v, res = world.check(confs, return_result=True)
        np.testing.assert_array_equal(v, ds.valid[:64])
        v2, res2 = small.check(confs, return_result=True)
        np.testing.assert_array_equal(v2, v)
        np.testing.assert_array_equal(res2.num_pairs, res.num_pairs)
        assert not res2.overflow.any()
    idx = np.flatnonzero(~easy10k.valid)
    lo = (int(idx[0]) // 64) * 64
    np.testing.assert_array_equal(world.check(easy10k.confs[lo : lo + 64]),
                                  easy10k.valid[lo : lo + 64])
    assert world.check(np.zeros((0, 6), np.float32)).shape == (0,)


def test_collision_world_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card error")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CollisionWorld(shapes.icosphere(1), shapes.icosphere(1))
    assert PipelineConfig().narrow_chunk == j_pipe.PipelineConfig().narrow_chunk == 8


def test_run_integration_xla(tmp_path, hard10k):
    # The script's --xla switch on a 48-row tagged file, on the CPU.
    conf = tmp_path / "slice.conf"
    write_conf_file(conf, hard10k.confs[:48], hard10k.valid[:48])
    out = subprocess.run([sys.executable, str(REPO / "scripts" / "torch_run_integration.py"),
                          str(conf), "--xla", "--device", "cpu"],
                         capture_output=True, text=True, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "all verdicts match" in out.stdout
    assert '"pipeline": "xla"' in out.stdout


@pytest.mark.slow
@pytest.mark.parametrize("key", ["hard10k", "easy10k"])
def test_full_file_goldens(key, request):
    ds = request.getfixturevalue(key)
    world = CollisionWorld(load_obj(assets.alpha_robot_path()),
                           load_obj(assets.alpha_obstacle_path()),
                           PipelineConfig(batch_block=256), device="cpu")
    np.testing.assert_array_equal(world.check(ds.confs), ds.valid)


@pytest.mark.slow
def test_samples10k_header_count(samples10k):
    world = CollisionWorld(load_obj(assets.alpha_robot_path()),
                           load_obj(assets.alpha_obstacle_path()),
                           PipelineConfig(batch_block=256), device="cpu")
    assert int(world.check(samples10k.confs).sum()) == samples10k.header_valid
