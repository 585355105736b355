"""The port's clearance engine (`robocheck_tpu_torch.planner.clearance`) and
its scan's PyTorch twin (`kernels/clearance.py`) against the JAX package's
`TpuClearanceEngine`, float64 brute force and the native BVH.

The engine must give a sound lower bound on the true min posed-vertex to
obstacle-surface distance, within twice its stated error bound of the truth
and of the JAX engine; its tables must equal the JAX engine's bit for bit.
The port runs on the CPU here (the twin); `chip_smoke.py` phase 9 holds the
CUDA kernel against the twin on the card. Tests ported from
`tests/test_clearance.py` keep their names (the sharded one is not ported).
"""
import numpy as np
import pytest
import torch

from robocheck_tpu.kernels.megakernel import MegaKernelChecker as JChecker
from robocheck_tpu.models.shapes import box as j_box
from robocheck_tpu.models.shapes import icosphere as j_icosphere
from robocheck_tpu.planner import ccd as j_ccd
from robocheck_tpu.planner.clearance import TpuClearanceEngine
from robocheck_tpu.planner.clearance import _point_tri_d2 as j_point_tri_d2
from robocheck_tpu_torch.core.types import Mesh
from robocheck_tpu_torch.io import assets
from robocheck_tpu_torch.io.obj import load_obj
from robocheck_tpu_torch.kernels.clearance import (REGIONS, pair_min_cuda, pair_min_reference,
                                                   point_tri_d2, point_tri_region_parts,
                                                   pose_rows, region_counts)
from robocheck_tpu_torch.kernels.megakernel import MegaKernelChecker
from robocheck_tpu_torch.models.shapes import box, icosphere
from robocheck_tpu_torch.ops.transform import rotation_matrices
from robocheck_tpu_torch.planner.ccd import (SweptCertifier, certify_multires, subdivide_mesh,
                                             subdivide_vertices)
from robocheck_tpu_torch.planner.clearance import ClearanceEngine
from robocheck_tpu_torch.profiling import bounds
from robocheck_tpu_torch.runtime import native
from robocheck_tpu_torch.runtime.device import resolve as resolve_device


def _mesh(m):
    return Mesh(m.vertices, m.triangles, m.name)


def _truth(robot_verts, obstacle, confs):
    """float64 brute-force min vertex -> surface distance per configuration,
    by the JAX package's distance in float64 (independent of the port's
    arithmetic); R from the port's float32 rotation."""
    import jax
    import jax.numpy as jnp

    from robocheck_tpu.planner.sdf import point_triangle_distance as j_distance

    R = rotation_matrices(torch.from_numpy(np.asarray(confs, np.float32))).double().numpy()
    v = np.asarray(robot_verts, np.float64)
    out = np.empty(len(confs))
    with jax.enable_x64(True):
        tri = jnp.asarray(np.asarray(obstacle.triangle_vertices, np.float64))
        for i in range(len(confs)):
            pts = jnp.asarray(v @ R[i].T + np.asarray(confs[i][0:3], np.float64))
            out[i] = float(jnp.min(j_distance(pts[:, None, :], tri[None])))
    return out


def _rand_confs(rng, n, tmax):
    confs = rng.uniform(-np.pi, np.pi, (n, 6)).astype(np.float32)
    confs[:, 0:3] = rng.uniform(-tmax, tmax, (n, 3))
    return confs


def _native_ready():
    return native.available() and native.has_point_mesh_dist()


def test_soundness_and_tightness_synthetic():
    robot = icosphere(2, radius=0.4, name="r")
    obstacle = icosphere(1, radius=1.0, name="o")
    eng = ClearanceEngine(robot.vertices, obstacle, device="cpu")
    confs = _rand_confs(np.random.default_rng(3), 24, 2.5)
    d = eng.min_distances(confs)
    diff = _truth(robot.vertices, obstacle, confs) - d
    err = eng.err_bound(confs)
    assert (diff >= 0).all(), f"not a lower bound: {diff.min()}"
    assert diff.max() <= 2 * err, (diff.max(), err)


def _multi_block_pair():
    # icosphere(2) subdivided twice: 2,562 vertices, 3 blocks of 1,024.
    robot = j_ccd.subdivide_mesh(j_icosphere(2, radius=0.4, name="r"), 2)
    return robot, j_icosphere(1, radius=1.0, name="o")


def test_engine_tables_identical_to_jax():
    robot, obstacle = _multi_block_pair()
    mine = ClearanceEngine(robot.vertices, _mesh(obstacle), device="cpu")
    ref = TpuClearanceEngine(robot.vertices, obstacle)
    assert (mine.num_blocks, mine.num_groups) == (ref.num_blocks, ref.num_groups) == (3, 3)
    for name in ("_blocks", "_bcent", "_bhalf", "_glo", "_ghi"):
        got, want = getattr(mine, name).numpy(), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype == np.float32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    confs = _rand_confs(np.random.default_rng(9), 4, 2.0)
    assert mine.err_bound(confs) == ref.err_bound(confs)


def test_min_distances_match_jax_and_bound_truth():
    robot, obstacle = _multi_block_pair()
    mine = ClearanceEngine(robot.vertices, _mesh(obstacle), device="cpu")
    ref = TpuClearanceEngine(robot.vertices, obstacle)
    confs = _rand_confs(np.random.default_rng(21), 16, 2.0)
    d, d_jax = mine.min_distances(confs), ref.min_distances(confs)
    err = mine.err_bound(confs)
    assert np.abs(d - d_jax).max() <= 2 * err, (np.abs(d - d_jax).max(), err)
    truth = _truth(robot.vertices, obstacle, confs)
    assert (d <= truth).all(), (truth - d).min()
    assert mine.stats["pairs"] == ref.stats["pairs"]
    assert mine.stats["calls"] == 1 and mine.stats["configs"] == 16
    assert mine.stats["kernel_s"] == 0.0  # the twin ran: no kernel time


@pytest.mark.slow
def test_soundness_near_contact_alpha():
    # Refined robot, distances well below one grid cell, translations near
    # the obstacle surface.
    robot = subdivide_mesh(load_obj(assets.alpha_robot_path()), 2)
    obstacle = load_obj(assets.alpha_obstacle_path())
    eng = ClearanceEngine(robot.vertices, obstacle, device="cpu")
    confs = _rand_confs(np.random.default_rng(7), 12, 1.0)
    confs[:, 0:3] += obstacle.aabb[:3] * 0.5 + obstacle.aabb[3:] * 0.5
    d = eng.min_distances(confs)
    diff = _truth(robot.vertices, obstacle, confs) - d
    err = eng.err_bound(confs)
    assert (diff >= 0).all(), f"not a lower bound: {diff.min()}"
    assert diff.max() <= 2 * err, (diff.max(), err)


@pytest.mark.slow
def test_matches_native_bvh():
    # The engine's answer must bracket the native float64 BVH answer from
    # below within twice the stated bound.
    if not _native_ready():
        pytest.skip("native library not built")
    robot = subdivide_mesh(load_obj(assets.alpha_robot_path()), 1)
    obstacle = load_obj(assets.alpha_obstacle_path())
    eng = ClearanceEngine(robot.vertices, obstacle, device="cpu")
    confs = _rand_confs(np.random.default_rng(11), 16, 30.0)
    d = eng.min_distances(confs)
    R = rotation_matrices(torch.from_numpy(confs)).double().numpy()
    verts = robot.vertices.astype(np.float64)
    ref = np.array([native.point_mesh_dist(obstacle.vertices, obstacle.triangles,
                                           verts @ R[i].T + confs[i, 0:3]).min()
                    for i in range(len(confs))])
    err = eng.err_bound(confs)
    diff = ref - d
    assert (diff >= 0).all() and diff.max() <= 2 * err, (diff.min(), diff.max(), err)


def test_single_block_and_tiny_meshes():
    # num_blocks == 1 runs every configuration as one pair, no culling.
    robot = box(extent=(0.2, 0.2, 0.2), name="r")
    obstacle = box(extent=(1.0, 1.0, 1.0), name="o")
    eng = ClearanceEngine(robot.vertices, obstacle, device="cpu")
    assert eng.num_blocks == 1
    confs = np.zeros((3, 6), np.float32)
    confs[:, 0] = [0.0, 1.5, 4.0]
    d = eng.min_distances(confs)
    ref = _truth(robot.vertices, obstacle, confs)
    err = eng.err_bound(confs)
    assert ((ref - d) >= 0).all() and (ref - d).max() <= 2 * err
    assert eng.min_distances(np.zeros((0, 6), np.float32)).shape == (0,)


@pytest.mark.parametrize("empty", ["robot", "obstacle"])
def test_empty_input_raises_value_error(empty):
    # The reference raises IndexError on either (`clearance.py:182,200`).
    verts = np.zeros((0, 3), np.float32) if empty == "robot" else box().vertices
    obstacle = (Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
                if empty == "obstacle" else box())
    with pytest.raises(ValueError, match=f"the {empty} has no"):
        ClearanceEngine(verts, obstacle, device="cpu")


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card error")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClearanceEngine(box().vertices, box())


def test_point_tri_d2_matches_jax():
    rng = np.random.default_rng(4)
    p = rng.normal(size=(4096, 3)).astype(np.float32) * 3
    tri = rng.normal(size=(4096, 3, 3)).astype(np.float32)
    tri[:64, 2] = tri[:64, 1]  # degenerate (zero-area) triangles
    got = point_tri_d2(torch.from_numpy(p), torch.from_numpy(tri)).numpy()
    want = np.asarray(j_point_tri_d2(p, tri))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # Against float64: the float32 answer is within the rounding of
    # coordinate-scale terms.
    exact = point_tri_d2(torch.from_numpy(p).double(), torch.from_numpy(tri).double()).numpy()
    ok = np.isfinite(got)
    np.testing.assert_allclose(got[ok], exact[ok], rtol=1e-4, atol=1e-4)


def test_pair_min_reference_is_min_over_block_and_triangles():
    rng = np.random.default_rng(12)
    blocks = torch.from_numpy(rng.normal(size=(5, 37, 3)).astype(np.float32))
    tris = torch.from_numpy(rng.normal(size=(29, 9)).astype(np.float32) * 2)
    confs = torch.from_numpy(_rand_confs(rng, 7, 3.0))
    rows = pose_rows(confs)
    ids = torch.tensor([0, 4, 2, 2, 1, 3, 0], dtype=torch.int32)
    got = pair_min_reference(rows, ids, blocks, tris)
    R = rotation_matrices(confs)
    for i in range(7):
        v = blocks[ids[i].item()]
        pts = (R[i][None, :, 0] * v[:, 0:1] + R[i][None, :, 1] * v[:, 1:2]
               + R[i][None, :, 2] * v[:, 2:3]) + confs[i, 0:3]
        want = point_tri_d2(pts[:, None, :], tris.view(1, -1, 3, 3)).min().sqrt()
        assert abs(got[i].item() - want.item()) <= 1e-6 * (1 + want.item())
    # An id outside the table gives NaN, as the kernel does.
    bad = pair_min_reference(rows[:2], torch.tensor([5, -1], dtype=torch.int32), blocks, tris)
    assert torch.isnan(bad).all()
    # 1-vertex blocks: the representative scan.
    reps = blocks[:, 0:1, :].contiguous()
    one = pair_min_reference(rows[:1].repeat(5, 1), torch.arange(5, dtype=torch.int32),
                             reps, tris)
    assert one.shape == (5,) and torch.isfinite(one).all()


# One point in each region of the unit right triangle a=(0,0,0), b=(1,0,0),
# c=(0,1,0), in REGIONS order.
_REGION_POINTS = [[-1.0, -1.0, 0.2], [2.0, -0.1, 0.0], [-0.1, 2.0, -0.3], [0.5, -1.0, 0.0],
                  [-1.0, 0.5, 0.4], [1.0, 1.0, 0.0], [0.2, 0.2, 1.0]]
_UNIT_TRI = [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0]


def test_region_of_each_point_and_counts():
    pts = torch.tensor(_REGION_POINTS)
    tri = torch.tensor(_UNIT_TRI).view(3, 3)
    region = point_tri_region_parts([pts[:, i] for i in range(3)],
                                    *([tri[k, i] for i in range(3)] for k in range(3)))
    assert region.tolist() == list(range(len(REGIONS)))
    # Through the launch's inputs: identity pose rows, the points as one
    # block; a pair with an id outside the table does no work.
    rows = pose_rows(torch.zeros((3, 6)))
    ids = torch.tensor([0, 0, 1], dtype=torch.int32)
    counts = region_counts(rows, ids, pts[None], torch.tensor([_UNIT_TRI]))
    assert counts.tolist() == [2] * len(REGIONS)


def test_region_counts_cover_every_distance():
    rng = np.random.default_rng(31)
    blocks = torch.from_numpy(rng.normal(size=(3, 16, 3)).astype(np.float32))
    tris = torch.from_numpy(rng.normal(size=(11, 9)).astype(np.float32))
    rows = pose_rows(torch.from_numpy(_rand_confs(rng, 5, 2.0)))
    counts = region_counts(rows, torch.tensor([0, 2, 1, 1, 0], dtype=torch.int32), blocks, tris)
    assert counts.sum().item() == 5 * 16 * 11 and (counts > 0).sum() >= 4


def test_clearance_bound_charges_each_region():
    # Vertex a costs the least work, the face the most; posing is per vertex.
    assert bounds.REGION_OPS[0] == min(bounds.REGION_OPS) == 21
    assert bounds.REGION_OPS[-1] == max(bounds.REGION_OPS) == 79
    n_bytes, n_ops = bounds.clearance_work(2, 4, 3, 1, [1, 0, 0, 0, 0, 0, 2])
    assert n_bytes == 2 * 56 + 4 * 12 + 3 * 36
    assert n_ops == 2 * 4 * bounds.POSE_VERTEX_OPS + 21 + 2 * 79


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_cuda_wrapper_refuses_cpu_tensors():
    rows = torch.zeros((2, 12))
    with pytest.raises(ValueError, match="CUDA tensor"):
        pair_min_cuda(rows, torch.zeros(2, dtype=torch.int32), torch.zeros((1, 4, 3)),
                      torch.zeros((1, 9)))


def test_certifier_engine_backend_certifies_wall_gap():
    # The exact engine backend certifies a clearance below the grid's floor;
    # a tunneling path is still refuted through the subdivision checks.
    robot = box(extent=(0.1, 0.1, 0.1), name="r")
    wall = box(extent=(0.4, 4.0, 4.0), name="wall")
    checker = MegaKernelChecker(robot, wall, device="cpu")
    cert = SweptCertifier(robot, wall, refine=2, exact=True, device="cpu")
    path = np.zeros((3, 6), np.float32)
    path[:, 0] = 0.05 + 0.2 + 0.08
    path[:, 1] = [-1.0, 0.0, 1.0]
    res = cert.certify(path, checker, max_depth=6)
    assert res.certified and not res.collision
    tun = np.zeros((2, 6), np.float32)
    tun[0, 0], tun[1, 0] = -2.0, 2.0
    res2 = certify_multires(robot, wall, tun, checker, levels=((0, 6), (2, 8)), device="cpu")
    assert res2.collision and not res2.certified


def test_subdivide_vertices_matches_mesh_subdivision():
    # subdivide_vertices is exactly subdivide_mesh's vertex array (same set,
    # same order) at every chained level, and the JAX package's.
    base = icosphere(1, radius=0.7, name="m")
    j_base = j_icosphere(1, radius=0.7, name="m")
    for lv in (1, 2, 3):
        a = subdivide_mesh(base, lv).vertices
        b = subdivide_vertices(base, lv)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, j_ccd.subdivide_vertices(j_base, lv))


def test_batched_multires_matches_per_segment():
    # A level's segments batched into one masked certify call give what
    # certifying each segment alone gives.
    robot = box(extent=(0.1, 0.1, 0.1), name="r")
    wall = box(extent=(0.4, 4.0, 4.0), name="wall")
    checker = MegaKernelChecker(robot, wall, device="cpu")
    cert = SweptCertifier(robot, wall, refine=1, exact=True, device="cpu")
    segs = []
    for x in (-1.5, 1.5):
        s = np.zeros((3, 6), np.float32)
        s[:, 0] = x
        s[:, 1] = [-1.0, 0.0, 1.0]
        segs.append(s)
    concat = np.concatenate(segs)
    mask = np.ones(len(concat) - 1, bool)
    mask[len(segs[0]) - 1] = False
    batched = cert.certify(concat, checker, max_depth=5, step_mask=mask)
    singles = [cert.certify(s, checker, max_depth=5) for s in segs]
    assert batched.certified == all(s.certified for s in singles)
    assert not batched.collision
    if batched.certified:
        np.testing.assert_allclose(batched.min_clearance,
                                   min(s.min_clearance for s in singles), rtol=1e-9)


def test_multires_backend_verdict_agreement():
    # The engine and native exact backends agree on certified / collision
    # over random scenes (the engine's haircut can cost depth, not flip an
    # outcome at these clearances).
    if not _native_ready():
        pytest.skip("native library not built")
    rng = np.random.default_rng(13)
    robot = box(extent=(0.12, 0.12, 0.12), name="r")
    for trial in range(3):
        wall = box(extent=(0.4, 3.0, 3.0), name="wall")
        checker = MegaKernelChecker(robot, wall, device="cpu")
        path = np.zeros((4, 6), np.float32)
        path[:, 0] = 0.26 + 0.06 + rng.uniform(0.0, 0.3)
        path[:, 1] = np.linspace(-1.2, 1.2, 4)
        path[1:3, 2] += rng.uniform(-0.3, 0.3, 2).astype(np.float32)
        results = {}
        for backend in ("engine", "native"):
            res = certify_multires(robot, wall, path, checker, levels=((0, 5), (2, 7)),
                                   backend=backend, device="cpu")
            results[backend] = (res.certified, res.collision)
        assert results["engine"] == results["native"], (trial, results)


def test_certify_step_mask_junctions_ignored():
    # Two certifiable segments joined by a junction step through the wall:
    # masked out, the batch certifies; real, it does not.
    robot = box(extent=(0.1, 0.1, 0.1), name="r")
    wall = box(extent=(0.4, 4.0, 4.0), name="wall")
    checker = MegaKernelChecker(robot, wall, device="cpu")
    cert = SweptCertifier(robot, wall, refine=1, exact=True, device="cpu")
    left = np.zeros((2, 6), np.float32)
    left[:, 0] = -1.5
    left[:, 1] = [-0.5, 0.5]
    right = left.copy()
    right[:, 0] = 1.5
    concat = np.concatenate([left, right])
    res = cert.certify(concat, checker, step_mask=np.array([True, False, True]), max_depth=4)
    assert res.certified and not res.collision
    assert not cert.certify(concat, checker, max_depth=4).certified


def test_wall_gap_certificate_matches_jax(monkeypatch):
    # The same exact certificate through both packages: JAX's engine with its
    # kernel in interpret mode, the port's with the twins on the CPU. JAX's
    # engine runs 32 pairs a dispatch, not 1,024: the same distances (the
    # rest is padding) at a fraction of the CPU time.
    monkeypatch.setattr(TpuClearanceEngine, "_pair_chunk", lambda self: 32)
    robot, wall = j_box(extent=(0.1, 0.1, 0.1), name="r"), j_box(extent=(0.4, 4.0, 4.0))
    path = np.zeros((3, 6), np.float32)
    path[:, 0] = 0.05 + 0.2 + 0.08
    path[:, 1] = [-1.0, 0.0, 1.0]
    mine = SweptCertifier(_mesh(robot), _mesh(wall), refine=2, exact=True, device="cpu")
    ref = j_ccd.SweptCertifier(robot, wall, refine=2, exact=True, backend="tpu")
    got = mine.certify(path, MegaKernelChecker(_mesh(robot), _mesh(wall), device="cpu"),
                       max_depth=6)
    want = ref.certify(path, JChecker(robot, wall, interpret=True), max_depth=6)
    assert (got.certified, got.collision, got.uncertified_steps) == (
        want.certified, want.collision, want.uncertified_steps)
    assert got.num_checks == want.num_checks
    assert mine.r_cov == ref.r_cov and mine.floor() == ref.floor()
    np.testing.assert_allclose(got.min_clearance, want.min_clearance,
                               atol=4 * mine._engine.err_bound(path))
