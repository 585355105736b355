"""The port's trajectory optimizer (`robocheck_tpu_torch.planner.trajopt`)
and `plan_and_smooth` against the JAX package's, on the CPU.

The surface samples are numpy in both packages and must be equal. The cost
and its gradient are held against a JAX cost assembled from
`robocheck_tpu.planner.trajopt._pose_points` and the JAX grid's `query` as
`trajopt.py:198-219` writes it, on the same grid (carried across by
`grid_from_arrays`): XLA on the CPU fuses multiply-adds and eager torch does
not, so they agree to float32 tolerance, not bit for bit. Optimized
trajectories are compared by their certificates. Tests ported from
`tests/test_planner.py` keep their class and test names; those JAX marks
slow are slow here too.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robocheck_tpu.io.obj import load_obj as j_load_obj
from robocheck_tpu.models.shapes import box as j_box
from robocheck_tpu.models.shapes import icosphere as j_icosphere
from robocheck_tpu.planner import sdf as j_sdf
from robocheck_tpu.planner import trajopt as j_trajopt
from robocheck_tpu_torch.core.types import Mesh
from robocheck_tpu_torch.io import assets
from robocheck_tpu_torch.models.shapes import box, icosphere
from robocheck_tpu_torch.planner import (PRMConfig, TrajectoryOptimizer, TrajOptConfig,
                                         densify, grid_from_arrays, plan_and_smooth)
from robocheck_tpu_torch.planner import trajopt

START = np.array([-3, 0, 0, 0, 0, 0], np.float32)
GOAL = np.array([3, 0, 0, 0, 0, 0], np.float32)


def _mesh(m):
    return Mesh(m.vertices, m.triangles, m.name)


def _grids(obstacle, resolution):
    """The JAX grid of ``obstacle`` and the same arrays as the port's."""
    ref = j_sdf.build_distance_grid(obstacle, resolution)
    mine = grid_from_arrays(np.asarray(ref.values), np.asarray(ref.origin),
                            np.asarray(ref.spacing), device="cpu")
    return ref, mine


def _jax_cost(cfg, grid, samples):
    """`trajopt.py:198-219` of the JAX package, over its own `_pose_points`
    and grid query."""
    scale = jnp.asarray([1.0, 1.0, 1.0, cfg.rot_scale, cfg.rot_scale, cfg.rot_scale],
                        dtype=jnp.float32)
    samples = jnp.asarray(samples)

    def cost(free, endpoints, w_collision):
        q = jnp.concatenate([endpoints[0][None], free, endpoints[1][None]], axis=0)
        dq = (q[1:] - q[:-1]) * scale
        smooth = jnp.sum(dq * dq)
        k = cfg.penalty_subsamples
        s = jnp.linspace(0.0, 1.0, k, endpoint=False)
        qd = q[:-1, None, :] + s[None, :, None] * (q[1:, None, :] - q[:-1, None, :])
        qd = jnp.concatenate([qd.reshape(-1, 6), q[-1:, :]], axis=0)
        d = grid.query(j_trajopt._pose_points(qd, samples))
        pen = jnp.maximum(cfg.margin - d, 0.0)
        return cfg.smooth_weight * smooth + w_collision * jnp.sum(pen * pen) / k

    return jax.jit(jax.value_and_grad(cost))


def _wiggly(start, goal, n, seed, spread=0.2):
    """A straight line from start to goal with perturbed interior waypoints
    and random angles."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, n)[:, None]
    q = (1 - t) * start[None] + t * goal[None]
    q[1:-1, :3] += rng.normal(scale=spread, size=(n - 2, 3))
    q[:, 3:] += rng.uniform(-1.0, 1.0, (n, 3))
    return q.astype(np.float32)


@pytest.mark.parametrize("scene,num,seed", [("icosphere", 64, 0), ("box", 37, 5),
                                             ("alpha", 256, 3)])
def test_sample_surface_points_identical(scene, num, seed):
    if scene == "icosphere":
        mesh = j_icosphere(1, radius=0.3)
    elif scene == "box":
        mesh = j_box(extent=(0.3, 0.5, 0.7))
    else:
        mesh = j_load_obj(assets.alpha_robot_path())
    got = trajopt._sample_surface_points(_mesh(mesh), num, seed)
    want = j_trajopt._sample_surface_points(mesh, num, seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_pose_points_matches_jax():
    rng = np.random.default_rng(4)
    confs = rng.uniform(-np.pi, np.pi, (33, 6)).astype(np.float32)
    confs[:, :3] *= 10.0
    pts = rng.normal(size=(50, 3)).astype(np.float32) * 5.0
    got = trajopt._pose_points(torch.from_numpy(confs), torch.from_numpy(pts)).numpy()
    want = np.asarray(j_trajopt._pose_points(jnp.asarray(confs), jnp.asarray(pts)))
    assert got.shape == (33, 50, 3)
    # float32 rounding of coordinates up to ~40: a few ulp.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k", [1, 3, 4, 6, 7, 13])
def test_penalty_fractions_equal_jax_linspace(k):
    opt = TrajectoryOptimizer(icosphere(1, radius=0.3), icosphere(1, radius=1.0),
                              TrajOptConfig(penalty_subsamples=k, grid_resolution=8,
                                            num_surface_samples=4),
                              checker=object(), device="cpu")
    np.testing.assert_array_equal(opt._s.numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, k, endpoint=False)))


@pytest.mark.parametrize("w", [10.0, 640.0])
def test_cost_and_gradient_match_jax(w):
    robot, ball = j_icosphere(1, radius=0.3), j_icosphere(2, radius=1.0)
    ref_grid, grid = _grids(ball, 24)
    cfg = TrajOptConfig(num_waypoints=12, margin=0.4, num_surface_samples=64, seed=2)
    opt = TrajectoryOptimizer(_mesh(robot), _mesh(ball), cfg, grid=grid, checker=object(),
                              device="cpu")
    q = _wiggly(START * 0.7, GOAL * 0.7, 12, seed=3)
    c_ref, g_ref = _jax_cost(cfg, ref_grid, j_trajopt._sample_surface_points(robot, 64, 2))(
        jnp.asarray(q[1:-1]), (jnp.asarray(q[0]), jnp.asarray(q[-1])), jnp.float32(w))
    free = torch.from_numpy(q[1:-1].copy()).requires_grad_(True)
    c = opt.cost(free, (torch.from_numpy(q[0]), torch.from_numpy(q[-1])), w)
    c.backward()
    g_ref = np.asarray(g_ref)
    assert float(c_ref) > 100.0  # the line crosses the ball: the penalty is live
    np.testing.assert_allclose(float(c.detach()), float(c_ref), rtol=1e-5)
    # float32 sums of ~10^4 terms: tolerance relative to the largest component.
    np.testing.assert_allclose(free.grad.numpy(), g_ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(g_ref).max()))


def test_cost_and_gradient_match_jax_on_alpha():
    # The alpha-1.0 pair at grid 32: the stored RRT path resampled to 48
    # waypoints, with a margin of 1.0 that some samples are inside.
    robot = j_load_obj(assets.alpha_robot_path())
    obstacle = j_load_obj(assets.alpha_obstacle_path())
    ref_grid, grid = _grids(obstacle, 32)
    cfg = TrajOptConfig(num_waypoints=48, margin=1.0, num_surface_samples=128)
    opt = TrajectoryOptimizer(_mesh(robot), _mesh(obstacle), cfg, grid=grid, checker=object(),
                              device="cpu")
    q = trajopt.resample(np.load(assets.find_asset("data/alpha_certified_path.npy")), 48)
    fn = _jax_cost(cfg, ref_grid, j_trajopt._sample_surface_points(robot, 128, 0))
    ends = (jnp.asarray(q[0]), jnp.asarray(q[-1]))
    c_ref, g_ref = fn(jnp.asarray(q[1:-1]), ends, jnp.float32(10.0))
    assert float(c_ref) > float(fn(jnp.asarray(q[1:-1]), ends, jnp.float32(0.0))[0])
    free = torch.from_numpy(q[1:-1].copy()).requires_grad_(True)
    c = opt.cost(free, (torch.from_numpy(q[0]), torch.from_numpy(q[-1])), 10.0)
    c.backward()
    g_ref = np.asarray(g_ref)
    np.testing.assert_allclose(float(c.detach()), float(c_ref), rtol=1e-5)
    np.testing.assert_allclose(free.grad.numpy(), g_ref, rtol=1e-4,
                               atol=1e-5 * float(np.abs(g_ref).max()))


def test_adam_round_matches_optax():
    # A few Adam steps on a scene where no gradient component is tiny (the
    # first step is ~lr * sign(g), so a component near 0 could step either
    # way in either package).
    import optax

    robot, ball = j_icosphere(1, radius=0.3), j_icosphere(2, radius=1.0)
    ref_grid, grid = _grids(ball, 24)
    cfg = TrajOptConfig(num_waypoints=10, margin=0.4, num_surface_samples=32, iters_per_round=5)
    opt = TrajectoryOptimizer(_mesh(robot), _mesh(ball), cfg, grid=grid, checker=object(),
                              device="cpu")
    q = _wiggly(START * 0.7, GOAL * 0.7, 10, seed=8)
    ends = (jnp.asarray(q[0]), jnp.asarray(q[-1]))
    fn = _jax_cost(cfg, ref_grid, j_trajopt._sample_surface_points(robot, 32, 0))
    free_j = jnp.asarray(q[1:-1])
    assert float(np.abs(np.asarray(fn(free_j, ends, jnp.float32(40.0))[1])).min()) > 1e-2
    adam = optax.adam(cfg.lr)
    state = adam.init(free_j)
    costs = []
    for _ in range(cfg.iters_per_round):
        c, g = fn(free_j, ends, jnp.float32(40.0))
        upd, state = adam.update(g, state)
        free_j = free_j + upd
        costs.append(float(c))
    free, cost = opt.optimize_round(torch.from_numpy(q[1:-1].copy()),
                                    (torch.from_numpy(q[0]), torch.from_numpy(q[-1])), 40.0)
    assert not free.requires_grad
    np.testing.assert_allclose(free.numpy(), np.asarray(free_j), rtol=0, atol=1e-5)
    # The round's cost is the one before its last update (optax's costs[-1]).
    np.testing.assert_allclose(float(cost), costs[-1], rtol=1e-5)


@pytest.mark.parametrize("entry", ["optimizer", "plan_and_smooth"])
def test_defaults_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card error")
    robot, ball = icosphere(1, radius=0.3), icosphere(1, radius=1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "optimizer":
            TrajectoryOptimizer(robot, ball, TrajOptConfig(grid_resolution=8))
        else:
            plan_and_smooth(robot, ball, START, GOAL)


@pytest.mark.slow
class TestTrajOpt:
    def test_plans_around_sphere(self):
        # A ball at the origin; the distance-field gradient bends the path
        # around it (pure local optimization, no global planner needed).
        robot = icosphere(1, radius=0.3, name="robot")
        obstacle = icosphere(2, radius=1.0, name="ball")
        opt = TrajectoryOptimizer(
            robot, obstacle,
            TrajOptConfig(num_waypoints=16, iters_per_round=200, max_rounds=6, margin=0.35,
                          grid_resolution=40, num_surface_samples=64),
            device="cpu")
        # Straight-line init passes through the ball.
        init_valid = opt.checker.check_valid_resolved(opt.initial_trajectory(START, GOAL))
        assert not init_valid.all()
        res = opt.plan(START, GOAL)
        assert res.certified, f"not certified after {res.rounds} rounds"
        assert res.valid.all()
        np.testing.assert_allclose(res.trajectory[0], START, atol=1e-6)
        np.testing.assert_allclose(res.trajectory[-1], GOAL, atol=1e-6)
        # The path must have moved off the straight line to clear the ball.
        assert np.abs(res.trajectory[4:-4, 1:3]).max() > 0.5

    def test_wall_needs_global_planner(self):
        # A pure local optimizer has no lateral gradient mid-slab and must
        # not claim a certificate it does not have.
        robot = icosphere(1, radius=0.3, name="robot")
        obstacle = box(extent=(0.5, 4.0, 4.0), name="wall")
        opt = TrajectoryOptimizer(
            robot, obstacle,
            TrajOptConfig(num_waypoints=12, iters_per_round=60, max_rounds=2, margin=0.3,
                          grid_resolution=32, num_surface_samples=32),
            device="cpu")
        res = opt.plan(START, GOAL)
        dense, _ = densify(res.trajectory, 0.3)
        assert res.certified == bool(opt.checker.check_valid_resolved(dense).all())


@pytest.mark.slow
class TestPipeline:
    def test_prm_seeded_optimization_through_wall(self):
        res = plan_and_smooth(
            icosphere(1, radius=0.3, name="robot"), box(extent=(0.5, 3.0, 3.0), name="wall"),
            START, GOAL,
            prm_config=PRMConfig(num_samples=256, k_neighbors=8, edge_resolution=8),
            opt_config=TrajOptConfig(num_waypoints=16, iters_per_round=100, max_rounds=4,
                                     margin=0.25, grid_resolution=32, num_surface_samples=32),
            device="cpu")
        assert res is not None, "PRM found no path"
        assert res.certified


class TestPlannerCoplanarCertify:
    def test_certify_rejects_coplanar_contact(self):
        # A trajectory resting at a near-coplanar face-on-face contact (the
        # fixture of tests/test_megakernel.py::TestCoplanarResolution) must
        # NOT be certified. The port's kernel reports this rounding-decided
        # tie as valid and uncertain (packed byte 5: bits 0 and 2, where the
        # JAX kernel sets bit 1); the planner path resolves it in float64.
        from tests.test_megakernel import TestCoplanarResolution as F

        tris = np.array([[0, 1, 2]], np.int32)
        opt = TrajectoryOptimizer(
            Mesh(F.RT, tris, name="r"), Mesh(F.OT, tris, name="o"),
            TrajOptConfig(num_waypoints=4, iters_per_round=1, max_rounds=1, grid_resolution=8,
                          num_surface_samples=8),
            device="cpu")
        assert opt.checker.check_packed(np.zeros((1, 6), np.float32))[0] == 0b101
        waypoint_valid, certified, _ = opt._certify(np.zeros((3, 6), np.float32))
        assert not certified
        assert not waypoint_valid.all()
