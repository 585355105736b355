"""The port's sampling planners (`robocheck_tpu_torch.planner`: kNN, PRM,
RRT-Connect and the path helpers) against the JAX package's
`robocheck_tpu.planner`, on the same scenes and seeds.

The host parts (kNN, interpolation, the path helpers) are numpy in both
packages and must agree exactly. The planners differ only in their checker:
the port's runs the kernel's PyTorch twin on the CPU, JAX's its Pallas kernel
in interpret mode; on these scenes the two give the same verdicts, so the
same seed must give the same path and counts. `chip_smoke.py` phase 8 runs
the port's planners through the CUDA kernel on the alpha-1.0 pair.
"""
import numpy as np
import pytest
import torch

from robocheck_tpu.core.types import Mesh as JMesh
from robocheck_tpu.models.shapes import box as j_box
from robocheck_tpu.models.shapes import icosphere as j_icosphere
from robocheck_tpu.planner import knn as j_knn
from robocheck_tpu.planner import prm as j_prm
from robocheck_tpu.planner import rrt as j_rrt
from robocheck_tpu.planner import trajopt as j_trajopt
from robocheck_tpu_torch.core.types import Mesh
from robocheck_tpu_torch.io import assets
from robocheck_tpu_torch.io.obj import load_obj
from robocheck_tpu_torch.io.parasol import read_query
from robocheck_tpu_torch.kernels.megakernel import MegaKernelChecker
from robocheck_tpu_torch.planner import (PRMConfig, PRMPlanner, RRTConfig, RRTConnectPlanner,
                                         densify, knn, prm, resample, snap_endpoint_branch,
                                         unwrap_path)


def _mesh(m):
    return Mesh(m.vertices, m.triangles, m.name)


def _confs(rng, n, spread=3.0):
    c = np.empty((n, 6), np.float32)
    c[:, :3] = rng.uniform(-spread, spread, (n, 3))
    c[:, 3:] = rng.uniform(-np.pi, np.pi, (n, 3))
    return c


@pytest.mark.parametrize("rot_scale", [0.5, 20.0])
def test_conf_knn_matches_jax(rot_scale):
    rng = np.random.default_rng(11)
    verts = _confs(rng, 700)
    verts[:50, :3] = verts[0, :3]  # rotation-only neighbours: the dense rescan
    nbrs, d = knn.conf_knn(verts, 12, rot_scale)
    j_nbrs, j_d = j_knn.conf_knn(verts, 12, rot_scale)
    np.testing.assert_array_equal(nbrs, j_nbrs)
    np.testing.assert_array_equal(d, j_d)
    np.testing.assert_array_equal(knn.chord_embed(verts, rot_scale),
                                  j_knn.chord_embed(verts, rot_scale))
    a, b = verts[:64].astype(np.float64), verts[64:128].astype(np.float64)
    np.testing.assert_array_equal(knn.conf_distance(a.copy(), b, rot_scale),
                                  j_knn.conf_distance(a.copy(), b, rot_scale))
    assert knn.conf_knn(verts[:1], 4, rot_scale)[0].shape == (1, 0)


def test_incremental_nearest_matches_jax():
    rng = np.random.default_rng(12)
    mine, ref = knn.IncrementalNearest(1.5), j_knn.IncrementalNearest(1.5)
    for n in (1, 7, 300, 40, 900, 5):  # crosses the rebuild threshold twice
        batch = _confs(rng, n)
        mine.add(batch)
        ref.add(batch)
        q = _confs(rng, 257)
        i, d = mine.nearest(q)
        ji, jd = ref.nearest(q)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_array_equal(d, jd)
        assert len(mine) == len(ref)
    np.testing.assert_array_equal(mine.nodes, ref.nodes)


@pytest.mark.parametrize("helper", ["unwrap_path", "interpolate", "densify", "resample",
                                    "snap_endpoint_branch"])
def test_path_helpers_identical(helper):
    rng = np.random.default_rng(13)
    path = _confs(rng, 9)
    path[3, 3:] = [3.1, -3.1, 3.0]  # across the +-pi seam
    path[4, 3:] = [-3.1, 3.1, -3.0]
    if helper == "unwrap_path":
        got, want = unwrap_path(path), j_prm.unwrap_path(path)
    elif helper == "interpolate":
        a, b = _confs(rng, 33), _confs(rng, 33)
        got, want = prm._interpolate_many(a, b, 8), j_prm._interpolate_many(a, b, 8)
        np.testing.assert_array_equal(prm._interpolate(a[0], b[0], 5),
                                      j_prm._interpolate(a[0], b[0], 5))
    elif helper == "densify":
        got, want = densify(path, 0.25, 5.0), j_trajopt.densify(path, 0.25, 5.0)
        np.testing.assert_array_equal(got[1], want[1])
        got, want = got[0], want[0]
    elif helper == "resample":
        got, want = resample(path, 31, 4.0), j_trajopt.resample(path, 31, 4.0)
    else:
        end = np.array([1, 2, 3, 9.0, -9.0, 0.1], np.float32)
        got = snap_endpoint_branch(end, path[2])
        want = j_trajopt.snap_endpoint_branch(end, path[2])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _gap_world():
    # tests/test_planner.py::TestRRTConnect: two wall slabs with a gap of
    # ~1.2 robot diameters.
    robot = j_icosphere(1, radius=0.25, name="robot")
    top = j_box(extent=(0.4, 3.0, 2.6), center=(0.0, 0.0, 1.65))
    bot = j_box(extent=(0.4, 3.0, 2.6), center=(0.0, 0.0, -1.65))
    return robot, JMesh.merge([top, bot], name="gap-wall")


def _wall_world():
    # scripts/demo_planner.py's wall scene.
    return j_icosphere(1, radius=0.3, name="robot"), j_box(extent=(0.5, 3.0, 3.0), name="wall")


START = np.array([-2.5, 0, 0, 0, 0, 0], np.float32)
GOAL = np.array([2.5, 0, 0, 0, 0, 0], np.float32)


def test_gap_wall_rrt_matches_jax():
    robot, wall = _gap_world()
    cfg = dict(max_iters=30, batch=64, edge_resolution=8, seed=2)
    mine = RRTConnectPlanner(_mesh(robot), _mesh(wall), RRTConfig(**cfg),
                             device="cpu").plan(START, GOAL)
    ref = j_rrt.RRTConnectPlanner(robot, wall, j_rrt.RRTConfig(**cfg),
                                  interpret=True).plan(START, GOAL)
    assert mine.path is not None and ref.path is not None
    np.testing.assert_array_equal(mine.path, ref.path)
    assert (mine.num_nodes, mine.num_confs_checked, mine.iters) == (
        ref.num_nodes, ref.num_confs_checked, ref.iters)
    checker = MegaKernelChecker(_mesh(robot), _mesh(wall), device="cpu")
    assert checker.check_valid_resolved(densify(mine.path, step=0.1)[0]).all()


def test_wall_prm_matches_jax():
    robot, wall = _wall_world()
    cfg = dict(num_samples=512, k_neighbors=10, edge_resolution=8)
    start, goal = START.copy(), GOAL.copy()
    start[0], goal[0] = -3.0, 3.0
    mine = PRMPlanner(_mesh(robot), _mesh(wall), PRMConfig(**cfg),
                      device="cpu").plan(start, goal)
    ref = j_prm.PRMPlanner(robot, wall, j_prm.PRMConfig(**cfg),
                           interpret=True).plan(start, goal)
    assert mine.path is not None and ref.path is not None
    np.testing.assert_array_equal(mine.path, ref.path)
    assert mine[1:] == ref[1:]  # vertices, edges, checks, closest_to_goal


@pytest.mark.parametrize("planner", ["rrt", "prm"])
def test_invalid_endpoint_returns_no_path(planner):
    robot, wall = _gap_world()
    inside = np.array([0.0, 0.0, 1.65, 0, 0, 0], np.float32)  # in the top slab
    if planner == "rrt":
        res = RRTConnectPlanner(_mesh(robot), _mesh(wall), RRTConfig(max_iters=2, batch=16),
                                device="cpu").plan(inside, GOAL)
        assert res.path is None and res.num_nodes == 0 and res.num_confs_checked == 2
    else:
        res = PRMPlanner(_mesh(robot), _mesh(wall), PRMConfig(num_samples=64),
                         device="cpu").plan(inside, GOAL)
        assert res.path is None and res.num_vertices == 0 and res.num_confs_checked == 66


@pytest.mark.parametrize("planner", [PRMPlanner, RRTConnectPlanner])
def test_planners_default_to_the_card(planner):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card error")
    robot, wall = _gap_world()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        planner(_mesh(robot), _mesh(wall))


@pytest.fixture(scope="module")
def alpha():
    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    query = read_query(assets.find_asset("models/alpha1.0/alpha.query"))
    return robot, obstacle, query, MegaKernelChecker(robot, obstacle, device="cpu")


@pytest.mark.slow
def test_alpha_rrt_finds_a_certified_path(alpha):
    # scripts/torch_demo_planner.py --alpha --rrt (chip_smoke.py phase 8).
    robot, obstacle, query, checker = alpha
    ext = float((robot.aabb[3:] - robot.aabb[:3]).min())
    res = RRTConnectPlanner(robot, obstacle,
                            RRTConfig(max_iters=16, batch=256, step=0.35 * ext,
                                      edge_resolution=48, surface_bias=0.6),
                            checker=checker).plan(query[0], query[1])
    assert res.path is not None
    assert checker.check_valid_resolved(densify(res.path, step=0.1 * ext)[0]).all()


@pytest.mark.slow
def test_alpha_prm_runs(alpha):
    # A small roadmap on the alpha pair: counts consistent with the config.
    robot, obstacle, query, checker = alpha
    res = PRMPlanner(robot, obstacle, PRMConfig(num_samples=256, k_neighbors=6,
                                                edge_resolution=8),
                     checker=checker).plan(query[0], query[1])
    assert res.num_confs_checked == 258 + 8 * res.num_edges_checked
    assert 0 < res.num_vertices <= 258
