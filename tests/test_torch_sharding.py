"""The port's batch sharding (`robocheck_tpu_torch.parallel.sharding`) and
runtime (`robocheck_tpu_torch.runtime.distributed`) in one process, a world
of 1 on the CPU: `ShardedChecker` gives `MegaKernelChecker`'s (its CPU
twin's) verdicts byte for byte, its totals equal the rows' counts, and the
`mesh=` arguments of the checkers, planners, engine and SQP give the
unsharded answers exactly. The two-rank runs are in
`tests/test_torch_distributed.py`; the sphere scene is
`tests/test_sharding.py`'s."""
import numpy as np
import pytest
import torch

from robocheck_tpu_torch.kernels.chunked import ChunkedMegaKernelChecker, make_checker
from robocheck_tpu_torch.kernels.megakernel import MegaKernelChecker
from robocheck_tpu_torch.models.shapes import box, icosphere
from robocheck_tpu_torch.parallel.sharding import ProcessMesh, ShardedChecker, make_mesh
from robocheck_tpu_torch.planner import (PRMPlanner, RRTConnectPlanner, SQPConfig,
                                         SQPOptimizer, TrajectoryOptimizer, TrajOptConfig)
from robocheck_tpu_torch.planner.ccd import certify_multires
from robocheck_tpu_torch.planner.clearance import ClearanceEngine
from robocheck_tpu_torch.runtime import distributed
from robocheck_tpu_torch.runtime.distributed import initialize_from_env, shard_bounds


@pytest.fixture(scope="module")
def sphere_world():
    return icosphere(1, 1.0, name="robot"), icosphere(1, 1.5, name="obstacle")


@pytest.fixture(scope="module")
def confs():
    rng = np.random.default_rng(9)
    c = rng.uniform(-2, 2, size=(64, 6)).astype(np.float32)
    c[:, 3:6] = rng.uniform(-np.pi, np.pi, (64, 3)).astype(np.float32)
    return c


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(device="cpu")


def test_world_of_one_mesh(mesh):
    assert (mesh.group, mesh.rank, mesh.size, mesh.backend) == (None, 0, 1, None)
    assert mesh.device == torch.device("cpu")
    assert make_mesh(1, device="cpu") == mesh
    x = torch.arange(6.0)
    assert mesh.all_gather(x) is x and mesh.all_reduce_sum(x) is x


def test_sharded_matches_single_checker(sphere_world, confs, mesh):
    robot, obstacle = sphere_world
    sharded = ShardedChecker(robot, obstacle, mesh, device="cpu")
    single = MegaKernelChecker(robot, obstacle, device="cpu")
    np.testing.assert_array_equal(sharded.check_packed(confs), single.check_packed(confs))
    for a, b in zip(sharded.check_valid(confs), single.check_valid(confs)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sharded.check_valid_resolved(confs),
                                  single.check_valid_resolved(confs))
    for two_phase in (True, False):
        for a, b in zip(sharded.check(confs, two_phase), single.check(confs, two_phase)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sharded.broad_block(confs),
                                  single.broad_block(confs).numpy())
    assert 0 < sharded.check_valid(confs)[0].sum() < len(confs)


def test_totals(sphere_world, confs, mesh):
    robot, obstacle = sphere_world
    out, totals = ShardedChecker(robot, obstacle, mesh, device="cpu").check_block(confs)
    single = MegaKernelChecker(robot, obstacle, device="cpu").check_block(confs)
    np.testing.assert_array_equal(out.numpy(), single.numpy())
    assert totals.tolist() == [int(out[:, 0].sum()), int((1 - out[:, 0]).sum()),
                               int(out[:, 1].sum())]
    assert totals[0] + totals[1] == len(confs)


def test_batch_not_divisible(sphere_world, confs):
    robot, obstacle = sphere_world
    # A mesh of 2 ranks that is never asked to communicate: check_block
    # refuses a batch its world size does not divide before any collective.
    two = ProcessMesh(None, 0, 2, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="multiple of 2"):
        ShardedChecker(robot, obstacle, two, device="cpu").check_block(confs[:37])
    assert two.shard(64) == (0, 32)
    sharded = ShardedChecker(robot, obstacle, device="cpu")
    v, *_ = sharded.check(confs[:37])
    assert v.shape == (37,)
    assert sharded._padded(confs[:37]).shape == (37, 6)


def test_check_valid_chunked_nondivisible(sphere_world, confs, mesh):
    sharded = ShardedChecker(*sphere_world, mesh, device="cpu")
    v, c = sharded.check_valid(confs[:55], chunk=16)
    v_ref, *_ = sharded.check(confs[:55], two_phase=False)
    np.testing.assert_array_equal(v, v_ref)
    big = np.concatenate([confs] * 4)[:200]
    v2, _ = sharded.check_valid(big, chunk=64)
    np.testing.assert_array_equal(v2, sharded.check(big)[0])


def test_check_valid_nonfinite(sphere_world, confs, mesh):
    sharded = ShardedChecker(*sphere_world, mesh, device="cpu")
    bad = confs[:16].copy()
    bad[3, 0] = np.nan
    bad[7, 5] = np.inf
    packed = sharded.check_packed(bad)
    assert packed[3] == 0 and packed[7] == 0
    assert sharded._checker.counters()["nonfinite_rows"] == 2  # K1 answered them
    good = np.delete(np.arange(16), [3, 7])
    np.testing.assert_array_equal(packed[good], sharded.check_packed(confs[:16][good]))
    v, c, p, b = sharded.check(bad)
    assert not v[3] and not v[7] and b[3] and p[7] == 0


def test_check_valid_distributed_world_of_one(sphere_world, confs, mesh):
    sharded = ShardedChecker(*sphere_world, mesh, device="cpu")
    v, c = sharded.check_valid_distributed(confs, len(confs))
    np.testing.assert_array_equal(v, sharded.check_valid(confs)[0])
    with pytest.raises(ValueError, match="owns rows"):
        sharded.check_valid_distributed(confs[:10], len(confs))


def test_shard_bounds_cover_exactly():
    total = 1003
    seen = [shard_bounds(total, pid, 4) for pid in range(4)]
    assert seen[0][0] == 0 and seen[-1][1] == total
    for (a, b), (c, d) in zip(seen, seen[1:]):
        assert b == c
    assert shard_bounds(10) == (0, 10)  # no group: a world of 1
    assert shard_bounds(3, 3, 4) == (3, 3)  # a rank past the rows gets none


def test_initialize_from_env_without_variables(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    initialize_from_env("gloo")
    assert not torch.distributed.is_initialized()


def test_mesh_arguments_are_checked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card error")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(ValueError, match="no process group"):
        make_mesh(device="cpu", backend="gloo")
    with pytest.raises(ValueError, match="asked for on a mesh"):
        ShardedChecker(icosphere(1), icosphere(1), make_mesh(device="cpu"))


def test_launch_fails_when_a_rank_fails():
    # int("x") raises in every spawned rank: the launch raises, and stops
    # every rank.
    with pytest.raises(RuntimeError, match="failed"):
        distributed.launch(int, 2, ("x",), timeout=120.0)


def test_make_checker_with_mesh(sphere_world, confs, mesh):
    robot, obstacle = sphere_world
    assert isinstance(make_checker(robot, obstacle, "cpu", mesh=mesh), ShardedChecker)
    # Oversized pairs compose with the mesh: every chunk pair sharded.
    plain = ChunkedMegaKernelChecker(robot, obstacle, "cpu", max_rob_tris=30, max_obs_tris=40)
    sharded = ChunkedMegaKernelChecker(robot, obstacle, "cpu", max_rob_tris=30,
                                       max_obs_tris=40, mesh=mesh)
    assert sharded.num_chunk_pairs == plain.num_chunk_pairs > 1
    assert all(isinstance(ck, ShardedChecker) for ck in sharded.checkers)
    for compact in (False, True):
        np.testing.assert_array_equal(sharded.check_packed(confs, compact=compact),
                                      plain.check_packed(confs, compact=compact))
    for a, b in zip(sharded.check(confs), plain.check(confs)):
        np.testing.assert_array_equal(a, b)


def test_planners_take_a_mesh(sphere_world, mesh):
    robot, obstacle = sphere_world
    for planner in (PRMPlanner(robot, obstacle, device="cpu", mesh=mesh),
                    RRTConnectPlanner(robot, obstacle, device="cpu", mesh=mesh)):
        assert isinstance(planner.checker, ShardedChecker)
    opt = TrajectoryOptimizer(robot, obstacle, TrajOptConfig(grid_resolution=8),
                              device="cpu", mesh=mesh)
    assert isinstance(opt.checker, ShardedChecker)


def test_engine_and_certifier_world_of_one(mesh):
    # A mesh of 1 changes no distance and no certificate.
    verts, obstacle = icosphere(4, 0.6).vertices, icosphere(2, 1.5)
    q = np.random.default_rng(3).uniform(-2.2, 2.2, (8, 6)).astype(np.float32)
    d = ClearanceEngine(verts, obstacle, device="cpu", mesh=mesh).min_distances(q)
    np.testing.assert_array_equal(d, ClearanceEngine(verts, obstacle, device="cpu")
                                  .min_distances(q))
    robot, ball = box(extent=(0.3, 0.3, 0.3)), icosphere(1, radius=0.6)
    path = np.array([[-2.0, 0, 0, 0, 0, 0], [0.0, 0, 1.6, 0, 0, 0], [2.0, 0, 0, 0, 0, 0]],
                    np.float32)
    checker = MegaKernelChecker(robot, ball, device="cpu")
    runs = [certify_multires(robot, ball, path, checker, levels=((0, 4), (1, 6)),
                             device="cpu", mesh=m) for m in (None, mesh)]
    assert runs[0].certified and runs[1].certified
    assert runs[0].num_checks == runs[1].num_checks


def test_sqp_world_of_one(mesh):
    robot, ball = box(extent=(0.3, 0.3, 0.3)), icosphere(1, radius=0.6)
    cfg = SQPConfig(num_waypoints=6, max_outer=2, max_penalty_rounds=2, subproblem_iters=10,
                    grid_resolution=16, num_surface_samples=32)
    start = np.array([-2.0, 0, 0, 0, 0, 0], np.float32)
    goal = np.array([2.0, 0, 0, 0, 0, 0], np.float32)
    a = SQPOptimizer(robot, ball, cfg, device="cpu").plan(start, goal)
    opt = SQPOptimizer(robot, ball, cfg, device="cpu", mesh=mesh)
    assert opt.mesh is None and isinstance(opt.checker, ShardedChecker)
    b = opt.plan(start, goal)
    np.testing.assert_array_equal(a.trajectory, b.trajectory)
    assert (a.certified, a.outer_iters, a.merit) == (b.certified, b.outer_iters, b.merit)
