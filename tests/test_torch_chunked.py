"""The port's oversized-mesh path (`robocheck_tpu_torch.kernels.chunked`, and
`megakernel.robot_bounds` / `smem_bytes`) against the JAX package's
`kernels.chunked`, run in interpret mode as tests/test_chunked.py runs it,
and against the port's own unchunked checker.

On the CPU every chunk pair runs the kernel's PyTorch twin; `chip_smoke.py`
phase 7 runs the same path through the CUDA kernel. Verdicts are compared
exactly; the coplanar bit on valid rows (a colliding row's flags depend on
which pairs the any-hit exit visited).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robocheck_tpu.kernels import chunked as jchunked
from robocheck_tpu.kernels import megakernel as jmk
from robocheck_tpu.models.shapes import icosphere as j_icosphere
from robocheck_tpu.models.shapes import triangle_soup as j_triangle_soup
from robocheck_tpu.oracle import cpu_oracle as j_oracle
from robocheck_tpu_torch.core.types import Mesh
from robocheck_tpu_torch.io import assets
from robocheck_tpu_torch.io.datagen import alpha_bot_configurations
from robocheck_tpu_torch.io.obj import load_obj
from robocheck_tpu_torch.kernels import chunked
from robocheck_tpu_torch.kernels import megakernel as mk
from robocheck_tpu_torch.kernels import resolve as rs
from robocheck_tpu_torch.planner.ccd import subdivide_mesh

# Pose entries (tests/test_torch_transform.py): torch and XLA round sin/cos
# to within an ulp of each other.
POSE_ATOL = 3e-7


def _mesh(m):
    return Mesh(m.vertices, m.triangles, m.name)


def _spheres():
    # tests/test_chunked.py: 80 robot x 320 obstacle triangles, 24 rows.
    rng = np.random.default_rng(41)
    c = rng.uniform(-2.5, 2.5, size=(24, 6)).astype(np.float32)
    c[:, 3:6] = rng.uniform(-np.pi, np.pi, (24, 3)).astype(np.float32)
    return (j_icosphere(1, radius=1.0, name="robot"), j_icosphere(2, radius=1.5, name="obstacle"),
            c, {"max_rob_tris": 64, "max_obs_tris": 128})


def _soup():
    # After tests/test_chunked.py::test_chunked_oversized_end_to_end: a
    # 1000-triangle soup in 4 obstacle chunks, a smaller robot.
    rng = np.random.default_rng(508)
    soup = j_triangle_soup(rng, 1000, extent=2.0)
    confs = rng.uniform(-3, 3, size=(16, 6)).astype(np.float32)
    return j_icosphere(1, radius=0.3, name="robot"), soup, confs, {"max_obs_tris": 256}


SCENES = {"spheres": _spheres, "soup": _soup}


@pytest.mark.parametrize("cap", [100, 128, 320, 1000])
def test_split_mesh_matches_jax(cap):
    mesh = j_icosphere(2, radius=1.5, name="obstacle")
    mine, ref = chunked.split_mesh(_mesh(mesh), cap), jchunked.split_mesh(mesh, cap)
    assert len(mine) == len(ref) == -(-mesh.num_triangles // cap)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.triangles, b.triangles)
        np.testing.assert_array_equal(a.vertices, b.vertices)
        assert a.name == b.name and a.num_triangles <= cap


def test_robot_bounds_is_the_kernel_broad_phase(hard10k):
    robot = load_obj(assets.alpha_robot_path())
    prep = mk.MegaKernelPrep.build(robot, load_obj(assets.alpha_obstacle_path())).to("cpu")
    rng = np.random.default_rng(3)
    far = rng.uniform(-400, 400, (256, 6)).astype(np.float32)
    confs = np.concatenate([hard10k.confs[:512], far])
    poses = mk.poses_from_confs(torch.from_numpy(confs))
    bounds = mk.robot_bounds(poses, prep)
    assert bounds.shape == (len(confs), 6) and bounds.dtype == torch.float32
    # Bit for bit the twin's (and so the kernel's) stage-1 comparison, for
    # the obstacle's box and for shifted boxes that cut through the rows'.
    broad = mk.mesh_broad(poses, prep)
    assert broad.any() and not broad.all()
    boxes = torch.stack([prep.obs_mesh, prep.obs_mesh + 7.5, bounds[0], bounds[600]])
    hits = mk.boxes_overlap(bounds, boxes)
    assert torch.equal(hits[0], broad)
    for k in range(4):
        shifted = dataclasses.replace(prep, obs_mesh=boxes[k])
        assert torch.equal(hits[k], mk.mesh_broad(poses, shifted))
    # The JAX package's `_robot_bounds` on the same corner table, within
    # the pose tolerance times the corners' magnitude.
    rb = prep.rob_base.numpy()
    pts = rb[0:9].T.reshape(-1, 3)
    lo, hi = jax.jit(jmk._robot_bounds)(jnp.asarray(confs), jnp.asarray(pts),
                                        jnp.asarray(np.repeat(rb[9] > 0, 3)))
    ref = np.concatenate([np.asarray(lo), np.asarray(hi)], axis=1)
    atol = 3 * POSE_ATOL * np.abs(pts).max() + 2 * np.spacing(np.abs(ref).max())
    np.testing.assert_allclose(bounds.numpy(), ref, rtol=0, atol=atol)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_chunked_matches_jax_and_unchunked(scene):
    robot, obstacle, confs, caps = SCENES[scene]()
    ck = chunked.ChunkedMegaKernelChecker(_mesh(robot), _mesh(obstacle), device="cpu", **caps)
    jck = jchunked.ChunkedMegaKernelChecker(robot, obstacle, interpret=True, **caps)
    assert ck.num_chunk_pairs == jck.num_chunk_pairs > 1
    plain = mk.MegaKernelChecker(_mesh(robot), _mesh(obstacle), device="cpu")
    valid, cop = ck.check_valid(confs)
    j_valid, j_cop = jck.check_valid(confs, chunk=32)
    p_valid, p_cop = plain.check_valid(confs)
    np.testing.assert_array_equal(valid, j_valid)
    np.testing.assert_array_equal(valid, p_valid)
    np.testing.assert_array_equal(cop[valid], j_cop[valid])
    np.testing.assert_array_equal(cop[valid], p_cop[valid])
    np.testing.assert_array_equal(valid, j_oracle.check_configs(robot, obstacle, confs))
    assert valid.any() and not valid.all()
    # The packed byte combines the chunk pairs' bytes: bit 0 by AND, bits 1
    # and 2 by OR, kept on valid rows.
    parts = np.stack([c.check_packed(confs) for c in ck.checkers])
    and0 = np.bitwise_and.reduce(parts & 1, axis=0)
    want = and0 | np.bitwise_or.reduce(parts & 6, axis=0) * and0
    np.testing.assert_array_equal(ck.check_packed(confs), want)
    # The stats path combines the same way: valid ANDs, broad ORs.
    c_valid, _, c_pairs, c_broad = ck.check(confs)
    np.testing.assert_array_equal(c_valid, valid)
    assert not (c_broad & ~plain.check(confs)[3]).any()  # chunk boxes lie inside
    assert (c_pairs[c_valid] >= 0).all()


def _moved(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_compact_on_and_off_identical(scene):
    """The default route (the chunk pairs' K1 on shared pose rows, the bytes
    combined on the device) and ``compact=True`` (each chunk pair's checker
    on its broad-phase hits, combined on the host) give the same bytes, and
    both give the unchunked twin's with its flags kept on valid rows; the
    counters count each route's chunk pairs, rows and uploads."""
    robot, obstacle, confs, caps = SCENES[scene]()
    ck = chunked.ChunkedMegaKernelChecker(_mesh(robot), _mesh(obstacle), device="cpu", **caps)
    far = confs.copy()
    far[::3, 0] += 50.0  # every third row misses every chunk
    far[5, 2] = np.nan  # a non-finite row is invalid either way
    c0 = ck.counters()
    off = ck.check_packed(far, chunk=8)
    c1 = ck.counters()
    on = ck.check_packed(far, chunk=8, compact=True)
    c2 = ck.counters()
    np.testing.assert_array_equal(off, on)
    twin = mk.MegaKernelChecker(_mesh(robot), _mesh(obstacle), device="cpu").check_packed(far)
    np.testing.assert_array_equal(off, (twin & 1) | (twin & 6) * (twin & 1))
    assert on[5] == 0 and (on[::3][on[::3] > 0] == 1).all()
    hits = ck._broad_multi(far)
    assert hits.shape == (ck.num_chunk_pairs, len(far)) and hits.any() and not hits.all()
    assert hits[:, 5].all()  # the non-finite row reaches K1 in every chunk pair
    pairs, run = ck.num_chunk_pairs, int(hits.any(axis=1).sum())
    # One upload a call by default; with compact one a chunk pair run and
    # the broad phase's. The non-finite row is counted once a chunk pair.
    assert _moved(c0, c1) == {"pair_launches": pairs, "pair_rows": pairs * len(far),
                              "batch_uploads": 1, "nonfinite_rows": pairs,
                              "resolved_rows": 0, "resolved_colliding": 0}
    assert _moved(c1, c2) == {"pair_launches": run, "pair_rows": int(hits.sum()),
                              "batch_uploads": run + 1, "nonfinite_rows": pairs,
                              "resolved_rows": 0, "resolved_colliding": 0}
    c3 = ck.counters()
    on = ck.check_valid_resolved(far, compact=True)
    c4 = ck.counters()
    off = ck.check_valid_resolved(far)
    c5 = ck.counters()
    np.testing.assert_array_equal(on, off)
    # Plus the resolution's upload with compact; none on the default route.
    assert _moved(c3, c4)["batch_uploads"] == run + 2 > 1
    assert _moved(c4, c5)["batch_uploads"] == 1


def test_bit2_in_one_chunk_pair_resolves_against_the_full_pair():
    """TestCoplanarResolution's pair (JAX package) at the identity pose:
    the port's twin finds it uncertain (bit 2) and the float64 oracle says
    colliding. With nine far triangles added to the obstacle and one
    triangle per obstacle chunk, only one chunk pair flags the row; its
    byte must still reach the float64 oracle of the whole pair."""
    rt = np.array([[-88.58568, -287.5827, -148.07309], [-105.54053, -122.13013, -65.34459],
                   [9.788717, -353.9158, -98.061005]], np.float32)
    ot = np.array([[-163.90807, -449.27316, -312.38596], [55.186058, -181.60817, 45.36783],
                   [-9.889383, -480.09338, -190.76962]], np.float32)
    far = [ot + np.float32(2000.0 * (k + 1)) for k in range(9)]
    robot = Mesh(rt, np.array([[0, 1, 2]], np.int32), "r")
    obstacle = Mesh(np.concatenate([ot, *far]), np.arange(30, dtype=np.int32).reshape(10, 3),
                    "o")
    ck = chunked.ChunkedMegaKernelChecker(robot, obstacle, device="cpu", max_obs_tris=1)
    assert ck.num_chunk_pairs == 10
    zero = np.zeros((1, 6), np.float32)
    parts = [int(c.check_packed(zero)[0]) for c in ck.checkers]
    assert sorted(parts) == [1] * 9 + [0b101]
    assert ck.check_packed(zero)[0] == 0b101
    assert ck.check_valid(zero)[0][0]  # valid as computed ...
    assert not ck.check_valid_resolved(zero)[0]  # ... colliding once resolved
    assert not j_oracle.check_configs(robot, obstacle, zero)[0]


@pytest.mark.parametrize("compact", [False, True])
def test_flags_of_a_row_that_another_chunk_pair_finds_colliding_are_dropped(compact):
    """The previous test's pair at the identity pose, whose one chunk pair
    flags the row (0b101), with a triangle in a chunk of its own that
    pierces the robot triangle: that chunk pair finds the row colliding, so
    the combined byte is 0 on either route, not the flags alone."""
    rt = np.array([[-88.58568, -287.5827, -148.07309], [-105.54053, -122.13013, -65.34459],
                   [9.788717, -353.9158, -98.061005]], np.float32)
    ot = np.array([[-163.90807, -449.27316, -312.38596], [55.186058, -181.60817, 45.36783],
                   [-9.889383, -480.09338, -190.76962]], np.float32)
    c = rt.mean(0)
    n = np.cross(rt[1] - rt[0], rt[2] - rt[0])
    n /= np.linalg.norm(n)
    u = (rt[1] - rt[0]) / np.linalg.norm(rt[1] - rt[0])
    pierce = np.stack([c - 10 * n + 5 * u, c - 10 * n - 5 * u, c + 10 * n]).astype(np.float32)
    robot = Mesh(rt, np.array([[0, 1, 2]], np.int32), "r")
    obstacle = Mesh(np.concatenate([ot, pierce]), np.arange(6, dtype=np.int32).reshape(2, 3), "o")
    ck = chunked.ChunkedMegaKernelChecker(robot, obstacle, device="cpu", max_obs_tris=1)
    zero = np.zeros((1, 6), np.float32)
    assert sorted(int(c.check_packed(zero)[0]) for c in ck.checkers) == [0, 0b101]
    assert ck.check_packed(zero, compact=compact)[0] == 0
    assert not ck.check_valid_resolved(zero, compact=compact)[0]
    assert not j_oracle.check_configs(robot, obstacle, zero)[0]


def test_band_hidden_contacts_resolve_colliding():
    """Two rows of scripts/bench_chunked.py's first scene (seed 7, rows 2110
    and 7896): the robot sphere pokes through the 81,920-triangle sphere by
    less than TOL / |n| of its small triangles, so no pair is live under the
    +-TOL band, in the JAX package's narrow phase as in the port; the float64
    oracle says colliding. The port flags the rows uncertain (bit 2), so
    they resolve colliding."""
    from robocheck_tpu.ops import narrow as j_narrow

    rows = np.array([[0.8576694, -0.8420993, 0.14767459, 0.7203785, 3.0436065, 2.2627144],
                     [0.9153341, 1.5401433, -0.13083363, 1.2929987, 3.1224608, 2.1998174]],
                    np.float32)
    robot, obstacle = j_icosphere(1, radius=0.3), j_icosphere(6, radius=1.5)
    ck = chunked.make_checker(_mesh(robot), _mesh(obstacle), device="cpu")
    packed = ck.check_packed(rows)
    np.testing.assert_array_equal(packed, [0b101, 0b101])
    assert not ck.check_valid_resolved(rows).any()
    assert not j_oracle.check_configs(robot, obstacle, rows).any()
    # The JAX package's narrow phase on the posed box-overlapping pairs.
    poses = mk.poses_from_confs(torch.from_numpy(rows)).numpy()
    obs_tri = obstacle.vertices[obstacle.triangles]
    for p in poses:
        rv = robot.vertices @ p[[0, 1, 2, 4, 5, 6, 8, 9, 10]].reshape(3, 3).T + p[[3, 7, 11]]
        rt = rv.astype(np.float32)[robot.triangles]
        ri, oi = np.nonzero(((rt.min(1)[:, None] <= obs_tri.max(1)[None])
                             & (obs_tri.min(1)[None] <= rt.max(1)[:, None])).all(-1))
        assert len(ri) > 400
        got = j_narrow.pair_intersects(jnp.asarray(rt[ri]), jnp.asarray(obs_tri[oi]))
        assert not np.asarray(got.collides).any() and not np.asarray(got.coplanar).any()


def test_make_checker_dispatch():
    robot = load_obj(assets.alpha_robot_path())
    plain = chunked.make_checker(robot, load_obj(assets.alpha_obstacle_path()), device="cpu")
    assert type(plain) is mk.MegaKernelChecker
    # bench_chunked.py's first scene: 80 robot triangles against 81,920.
    small, big = j_icosphere(1, radius=0.3), j_icosphere(6, radius=1.5)
    with pytest.raises(mk.SharedMemoryBudgetError, match="232448"):
        mk.MegaKernelChecker(_mesh(small), _mesh(big), device="cpu")
    ck = chunked.make_checker(_mesh(small), _mesh(big), device="cpu")
    assert isinstance(ck, chunked.ChunkedMegaKernelChecker)
    assert ck.num_chunk_pairs == 14
    for c in ck.checkers:
        tr, to = c.prep.rob_base.shape[1], c.prep.obs.shape[0]
        assert mk.smem_bytes(tr, to // mk.GROUP) <= mk.SMEM_LIMIT
    rows = np.random.default_rng(7).uniform(-4, 4, (4, 6)).astype(np.float32)
    rows[0, :3] = 10.0  # outside the obstacle's box
    packed = ck.check_packed(rows, compact=True)
    assert packed[0] == 1


def test_make_checker_routes_the_alpha_obstacle_at_three_rounds_to_eleven_chunk_pairs():
    """The benchmark's sub3 check configuration: the alpha robot against
    the obstacle cut to 64,512 triangles goes through 1 robot chunk x 11
    obstacle chunks, each within one block's shared memory (built only)."""
    robot = load_obj(assets.alpha_robot_path())
    obstacle = subdivide_mesh(load_obj(assets.alpha_obstacle_path()), 3)
    assert obstacle.num_triangles == 64512
    ck = chunked.make_checker(robot, obstacle, device="cpu")
    assert isinstance(ck, chunked.ChunkedMegaKernelChecker)
    assert ck.num_chunk_pairs == 11 and ck._n_obs_chunks == 11
    assert sum(c.obstacle.num_triangles for c in ck.checkers) == 64512
    for c in ck.checkers:
        assert c.robot.num_triangles == robot.num_triangles
        tr, to = c.prep.rob_base.shape[1], c.prep.obs.shape[0]
        assert mk.smem_bytes(tr, to // mk.GROUP) <= mk.SMEM_LIMIT


def test_chunked_alpha_pair_equals_the_unchunked_twin_and_counts_its_pairs(monkeypatch):
    """The alpha robot against the obstacle at one round (4,032 triangles)
    in 4 obstacle chunks of 1,008: the resolved verdicts of 64 hard rows
    equal the unchunked twin's row for row (K1's twin over the whole pair,
    then the float64 resolution against it), and ``counters`` advances by 4
    chunk pairs, 4 x 64 rows, one upload and the resolved rows. The call
    poses the batch once and runs K1 once a chunk pair on those pose rows,
    calling no chunk pair's ``check_packed``."""
    robot = load_obj(assets.alpha_robot_path())
    obstacle = subdivide_mesh(load_obj(assets.alpha_obstacle_path()), 1)
    ck = chunked.ChunkedMegaKernelChecker(robot, obstacle, device="cpu", max_obs_tris=1024)
    assert ck.num_chunk_pairs == 4
    confs = alpha_bot_configurations(robot, 64, hard=True, seed=2718281828)
    calls = {"pose": [], "k1": []}

    def counted(name, fn):
        def wrapped(x, *rest):
            calls[name].append(x.data_ptr())
            return fn(x, *rest)
        return wrapped

    def refuse(*args, **kwargs):
        raise AssertionError("a chunk pair's check_packed was called")

    monkeypatch.setattr(chunked, "poses_from_confs", counted("pose", chunked.poses_from_confs))
    monkeypatch.setattr(mk, "check_poses", counted("k1", mk.check_poses))
    monkeypatch.setattr(mk.MegaKernelChecker, "check_packed", refuse)
    before = ck.counters()
    got = ck.check_valid_resolved(confs)
    after = ck.counters()
    monkeypatch.undo()
    assert len(calls["pose"]) == 1 and len(calls["k1"]) == 4
    assert len(set(calls["k1"])) == 1  # the same pose rows for every chunk pair
    prep = mk.MegaKernelPrep.build(robot, obstacle).to("cpu")
    packed = mk.check_poses_reference(mk.poses_from_confs(torch.from_numpy(confs)), prep)
    counts = torch.zeros((2,), dtype=torch.int64)
    want = rs.resolve_rows_reference(packed, torch.from_numpy(confs),
                                     rs.ResolveTables.build(robot, obstacle, "cpu"), counts)
    np.testing.assert_array_equal(got, want.numpy().view(bool))
    assert got.any() and not got.all()
    # Valid rows keep the whole pair's flags, so the same rows resolve.
    np.testing.assert_array_equal(ck.check_packed(confs)[got], packed.numpy()[got])
    delta = {k: after[k] - before[k] for k in after}
    assert delta == {"pair_launches": 4, "pair_rows": 4 * 64, "batch_uploads": 1,
                     "nonfinite_rows": 0, "resolved_rows": int(counts[0]),
                     "resolved_colliding": int(counts[1])}


def test_smem_bytes_pinned():
    # `Layout::bytes()` of csrc/megakernel.cu, worked by hand from its
    # constants; chip_smoke.py phase 7 holds it against the compiled one.
    assert mk.smem_bytes(1024, 8) == 82800  # the alpha-1.0 tables
    assert mk.smem_bytes(4096, 8) == 218736
    assert mk.smem_bytes(96, 48) == 201948
    assert mk.smem_bytes(96, 64) == 252252 > mk.SMEM_LIMIT
    assert mk.smem_bytes(chunked.MAX_ROB_TRIS, chunked.MAX_OBS_TRIS // mk.GROUP) == 227120
    assert mk.smem_bytes(chunked.MAX_ROB_TRIS, chunked.MAX_OBS_TRIS // mk.GROUP + 2) > (
        mk.SMEM_LIMIT)


def test_row_limit_refused_on_every_device():
    # Fits shared memory per the formula's tables only in rows: the
    # launcher packs robot and obstacle indices into 16 bits each.
    tri = np.array([[0, 1, 2]], np.int32)
    big = Mesh(np.random.default_rng(1).normal(size=(3, 3)).astype(np.float32),
               np.repeat(tri, mk.ROW_LIMIT, axis=0))
    with pytest.raises(mk.SharedMemoryBudgetError, match="rows below 65536"):
        mk.MegaKernelChecker(big, Mesh(big.vertices, tri), device="cpu")


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card error")
    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    for make in (mk.MegaKernelChecker, chunked.make_checker,
                 chunked.ChunkedMegaKernelChecker):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(robot, obstacle)
