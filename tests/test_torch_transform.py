"""Ops of the PyTorch port against the JAX package on the same inputs: pose
transform (`ops/transform.py`, `poses_from_confs`), AABBs (`ops/aabb.py`) and
the narrow phase (`ops/narrow.py`).

Continuous values are compared with a stated tolerance, verdicts exactly:
torch and XLA differ by an ulp in sin/cos, and jitted XLA fuses the
multiply-adds that eager torch rounds one by one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robocheck_tpu.kernels.megakernel import poses_from_confs as j_poses
from robocheck_tpu.ops import aabb as j_aabb
from robocheck_tpu.ops import narrow as j_narrow
from robocheck_tpu.ops import transform as j_transform
from robocheck_tpu_torch.io import assets
from robocheck_tpu_torch.io.obj import load_obj
from robocheck_tpu_torch.kernels.megakernel import _pair_flags, poses_from_confs
from robocheck_tpu_torch.ops import aabb, narrow, transform

# Pose entries: rotation entries are products of sin/cos, which torch and XLA
# round to within an ulp of each other; measured max 1.64e-7 (hard10k[:4096]
# and the seeded rows, jitted JAX against eager torch). 3e-7 ~ 2.5 ulp at 1.
POSE_ATOL = 3e-7


def _confs(hard10k):
    rng = np.random.default_rng(508)
    rand = np.concatenate([rng.uniform(-50, 50, (1024, 3)),
                           rng.uniform(-10, 10, (1024, 3))], axis=1)
    return np.concatenate([hard10k.confs[:4096], rand.astype(np.float32)])


def test_poses_from_confs_matches_jax(hard10k):
    confs = _confs(hard10k)
    ref = np.asarray(jax.jit(j_poses)(jnp.asarray(confs)))
    got = poses_from_confs(torch.from_numpy(confs)).numpy()
    assert got.shape == (len(confs), 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=POSE_ATOL)
    # Translations and the zero pad are copied, not computed.
    for col in (3, 7, 11, 12, 13, 14, 15):
        np.testing.assert_array_equal(got[:, col], ref[:, col])


def test_rotation_matrices_match_jax(hard10k):
    confs = _confs(hard10k)
    ref = np.asarray(j_transform.rotation_matrices(jnp.asarray(confs)))
    got = transform.rotation_matrices(torch.from_numpy(confs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=POSE_ATOL)
    # Orthonormal to float32 rounding.
    eye = np.einsum("nij,nkj->nik", got.astype(np.float64), got.astype(np.float64))
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-6)


def test_apply_pose_bit_identical_given_same_rotations(hard10k):
    # With the same R and t, the multiply-add order is the JAX one exactly.
    base = load_obj(assets.alpha_robot_path()).vertices
    confs = hard10k.confs[:128]
    R = transform.rotation_matrices(torch.from_numpy(confs))
    got = transform.apply_pose(R, torch.from_numpy(confs[:, :3]),
                               torch.from_numpy(base)).numpy()
    ref = np.asarray(j_transform.apply_pose(jnp.asarray(R.numpy()),
                                            jnp.asarray(confs[:, :3]),
                                            jnp.asarray(base)))
    np.testing.assert_array_equal(got, ref)


def test_transform_vertices_matches_jax(hard10k):
    base = load_obj(assets.alpha_robot_path()).vertices
    confs = _confs(hard10k)[::16]
    ref = np.asarray(jax.jit(j_transform.transform_vertices)(
        jnp.asarray(confs), jnp.asarray(base)))
    got = transform.transform_vertices(torch.from_numpy(confs),
                                       torch.from_numpy(base)).numpy()
    assert got.shape == (len(confs), len(base), 3)
    # Each posed coordinate sums three R-entry x base products: R's 3e-7
    # bound times |base| per term, plus two ulps of the result's magnitude.
    atol = 3 * POSE_ATOL * np.abs(base).max() + 2 * np.spacing(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def test_aabb_ops_match_jax(rng):
    tris = rng.normal(size=(4, 64, 3, 3)).astype(np.float32)
    verts = tris.reshape(4, -1, 3)
    np.testing.assert_array_equal(
        aabb.vertices_aabb(torch.from_numpy(verts)).numpy(),
        np.asarray(j_aabb.vertices_aabb(jnp.asarray(verts))))
    boxes = aabb.triangle_aabbs(torch.from_numpy(tris)).numpy()
    np.testing.assert_array_equal(boxes,
                                  np.asarray(j_aabb.triangle_aabbs(jnp.asarray(tris))))
    a, b = boxes[:, :, None], boxes[:, None, :]
    np.testing.assert_array_equal(
        aabb.aabb_overlap(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(j_aabb.aabb_overlap(jnp.asarray(a), jnp.asarray(b))))
    # Closed intervals: touching boxes overlap.
    t = torch.tensor([[0.0, 0, 0, 1, 1, 1]])
    assert aabb.aabb_overlap(t, t + torch.tensor([1.0, 0, 0, 1, 0, 0])).item()


def _pairs(rng, n=4096):
    """Seeded random pairs plus degenerate ones: identical, coplanar shifted,
    shared edge, shared vertex, zero-area, touching within the TOL band, and
    mismatched scales (last 64). Returns (a, b, tie): ``tie`` marks the
    identical and shared-vertex pairs, whose verdict is a tie that float32
    rounding noise decides (the coplanar flag of a pair with itself;
    intervals that touch at the shared vertex)."""
    t1 = rng.normal(size=(n, 3, 3)).astype(np.float32)
    t2 = (t1 + rng.normal(scale=0.7, size=(n, 3, 3))).astype(np.float32)
    base = rng.normal(size=(64, 3, 3)).astype(np.float32)
    e1 = base[:, 1] - base[:, 0]
    coplanar = base + (0.3 * e1)[:, None, :]
    shared_edge = base.copy()
    shared_edge[:, 2] = base[:, 2] + rng.normal(size=(64, 3)).astype(np.float32)
    shared_vertex = rng.normal(size=(64, 3, 3)).astype(np.float32)
    shared_vertex[:, 0] = base[:, 0]
    zero_area = np.repeat(base[:, :1], 3, axis=1)
    n_b = np.cross(e1, base[:, 2] - base[:, 1])
    touch = base + (1e-7 * n_b / np.linalg.norm(n_b, axis=1, keepdims=True))[:, None]
    # A unit triangle through the plane of a 1e4-scale one: every plane
    # coefficient ratio is below TOL, which the ratio test calls coplanar
    # (the mismatched-scale case of tests/test_megakernel.py).
    big = np.float32(1e4) * np.array([[0, 1, 2], [0, 2, 0], [2, 2, 2]], np.float32)
    small = big.mean(axis=0) + rng.normal(size=(64, 3, 3)).astype(np.float32)
    a = np.concatenate([t1, base, base, base, base, base, base, small])
    b = np.concatenate([t2, base, coplanar, shared_edge, shared_vertex, zero_area,
                        touch.astype(np.float32), np.broadcast_to(big, small.shape)])
    tie = np.zeros(len(a), dtype=bool)
    tie[n : n + 64] = True  # identical
    tie[n + 192 : n + 256] = True  # shared vertex
    return a, b, tie


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_intersects_matches_jax_verdicts(seed):
    # Verdict for verdict, except on the rounding-decided ties: over seeds
    # 0-39, 0 of 163,840 random pairs and 0 of the other degenerate blocks
    # differed, while about 1 in 64 tie pairs did (XLA on the CPU fuses
    # multiply-adds that eager torch rounds one by one).
    a, b, tie = _pairs(np.random.default_rng(seed))
    ref = j_narrow.pair_intersects(jnp.asarray(a), jnp.asarray(b))
    got = narrow.pair_intersects(torch.from_numpy(a), torch.from_numpy(b))
    exact = ~tie
    np.testing.assert_array_equal(got.collides.numpy()[exact],
                                  np.asarray(ref.collides)[exact])
    np.testing.assert_array_equal(got.coplanar.numpy()[exact],
                                  np.asarray(ref.coplanar)[exact])
    # A triangle never collides with itself in either package.
    n = len(a) - 448
    assert not got.collides[n : n + 64].any()
    assert not np.asarray(ref.collides)[n : n + 64].any()
    # Where a tie pair's verdicts differ, the fused check's twin flags the
    # pair coplanar or uncertain (packed bit 1 or 2), so its row goes to the
    # float64 oracle. Over seeds 0-39: 2 identical pairs differ (seeds 1 and
    # 32; a plane-stage tie) and 46 of 2,560 shared-vertex pairs (intervals
    # touching at the vertex: an interval-stage tie); all are flagged.
    differ = ((got.collides.numpy() != np.asarray(ref.collides))
              | (got.coplanar.numpy() != np.asarray(ref.coplanar)))
    fields = []
    for tri in (a, b):
        t = torch.from_numpy(np.ascontiguousarray(tri))
        nrm, d = narrow.compute_plane(t)
        f = {f"c{c}{ax}": t[:, c, k] for c in range(3) for k, ax in enumerate("xyz")}
        f.update(nx=nrm[:, 0], ny=nrm[:, 1], nz=nrm[:, 2], d=d)
        fields.append(f)
    flags = _pair_flags(*fields)
    flagged = (flags.coplanar | flags.uncertain).numpy()
    assert flagged[differ].all()
    assert not (flags.hit & flags.uncertain).any()  # a tie is never a hit
    assert differ[n : n + 64].any() == (seed == 1)
    assert differ[n + 192 : n + 256].any() == (seed != 1)  # 2 and 4 pairs at seeds 0, 2
    # Both outcomes occur, and the mismatched-scale block is flagged.
    assert got.collides.any() and (~got.collides).any()
    assert got.coplanar[-64:].any()


def test_pair_intersects_precomputed_planes():
    a, b, _ = _pairs(np.random.default_rng(1), n=256)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    plain = narrow.pair_intersects(ta, tb)
    given = narrow.pair_intersects(ta, tb, narrow.compute_plane(ta),
                                   narrow.compute_plane(tb))
    assert torch.equal(plain.collides, given.collides)
    assert torch.equal(plain.coplanar, given.coplanar)


def test_narrow_helpers_match_jax():
    rng = np.random.default_rng(2)
    a, b, _ = _pairs(rng, n=1024)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    n, d = narrow.compute_plane(ta)
    jn, jd = j_narrow.compute_plane(jnp.asarray(a))
    scale = np.abs(np.asarray(jn)).max() + 1.0
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), rtol=0, atol=4e-7 * scale)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=4e-6 * scale)

    # Given the same plane, the rest compares exactly.
    dist = narrow.signed_dists(n, d, tb)
    jdist = j_narrow.signed_dists(jnp.asarray(n.numpy()), jnp.asarray(d.numpy()),
                                  jnp.asarray(b))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(narrow.no_overlap(dist).numpy(),
                                  np.asarray(j_narrow.no_overlap(jnp.asarray(dist.numpy()))))
    ctri, cd = narrow.canonicalize(tb, dist)
    jctri, jcd = j_narrow.canonicalize(jnp.asarray(b), jnp.asarray(dist.numpy()))
    np.testing.assert_array_equal(ctri.numpy(), np.asarray(jctri))
    np.testing.assert_array_equal(cd.numpy(), np.asarray(jcd))

    v1 = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
    v2 = v1 * (1 + torch.from_numpy(rng.normal(scale=1e-6, size=4096).astype(np.float32)))
    v2[:64] = 0.0
    v1[64:128] = 1e-7
    np.testing.assert_array_equal(
        narrow.isclose(v1, v2).numpy(),
        np.asarray(j_narrow.isclose(jnp.asarray(v1.numpy()), jnp.asarray(v2.numpy()))))
    np.testing.assert_array_equal(
        narrow.iszero(v1).numpy(), np.asarray(j_narrow.iszero(jnp.asarray(v1.numpy()))))

    nb, db = narrow.compute_plane(tb)
    args = [x.numpy() for x in (n, d, nb, db)]
    np.testing.assert_array_equal(
        narrow.is_coplanar(n, d, nb, db).numpy(),
        np.asarray(j_narrow.is_coplanar(*map(jnp.asarray, args))))
    D = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32))
    t01 = narrow.parametric_t(ctri[:64, 0], ctri[:64, 1], cd[:64, 0], cd[:64, 1], D)
    jt01 = j_narrow.parametric_t(jctri[:64, 0], jctri[:64, 1], jcd[:64, 0],
                                 jcd[:64, 1], jnp.asarray(D.numpy()))
    np.testing.assert_allclose(t01.numpy(), np.asarray(jt01), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("origin", [False, True])
def test_project_vertex_matches_jax(rng, origin):
    v, D, O = (rng.normal(size=(256, 3)).astype(np.float32) for _ in range(3))
    got = narrow.project_vertex(torch.from_numpy(v), torch.from_numpy(D),
                                torch.from_numpy(O) if origin else None)
    ref = j_narrow.project_vertex(jnp.asarray(v), jnp.asarray(D),
                                  jnp.asarray(O) if origin else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
