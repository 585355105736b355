"""The port's SQP optimizer (`robocheck_tpu_torch.planner.sqp`) and
checkpoints (`robocheck_tpu_torch.runtime.checkpoint`) against the JAX
package's, on the CPU.

The constraint blocks (residuals g, Jacobians J, penalty total) and one
subproblem solve are held against `robocheck_tpu.planner.sqp.SQPOptimizer`'s
jitted functions on the same grid (carried across by `grid_from_arrays`) and
the same numpy surface samples. Tolerances: JAX's own between two XLA
compilations (`tests/test_planner.py:330-333`), rtol 2e-5 / atol 1e-6 on g
and rtol 2e-4 / atol 1e-5 on J, with the absolute terms in units of the
scene's coordinate scale (the largest posed coordinate) where it exceeds 1:
float32 rounding of a posed point grows with its magnitude. The planning
loop is held against JAX's by giving both packages one scripted checker:
the same verdicts must give the same outer iterations, certificate and
checkpoints. Tests ported from `tests/test_planner.py::TestSQP` keep their
names and JAX's slow mark.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robocheck_tpu.io.obj import load_obj as j_load_obj
from robocheck_tpu.models.shapes import icosphere as j_icosphere
from robocheck_tpu.planner import sdf as j_sdf
from robocheck_tpu.planner import sqp as j_sqp
from robocheck_tpu.runtime import checkpoint as j_checkpoint
from robocheck_tpu_torch.core.types import Mesh
from robocheck_tpu_torch.io import assets
from robocheck_tpu_torch.models.shapes import icosphere
from robocheck_tpu_torch.planner import SQPConfig, SQPOptimizer, grid_from_arrays, resample
from robocheck_tpu_torch.planner.trajopt import _pose_points
from robocheck_tpu_torch.runtime import checkpoint

START = np.array([-3, 0, 0, 0, 0, 0], np.float32)
GOAL = np.array([3, 0, 0, 0, 0, 0], np.float32)


def _mesh(m):
    return Mesh(m.vertices, m.triangles, m.name)


def _pair(robot, obstacle, resolution, checker=None, **cfg):
    """The JAX and the port's optimizer on one grid and one config."""
    ref_grid = j_sdf.build_distance_grid(obstacle, resolution)
    grid = grid_from_arrays(np.asarray(ref_grid.values), np.asarray(ref_grid.origin),
                            np.asarray(ref_grid.spacing), device="cpu")
    ref = j_sqp.SQPOptimizer(robot, obstacle, j_sqp.SQPConfig(grid_resolution=resolution, **cfg),
                             grid=ref_grid, checker=checker or object())
    mine = SQPOptimizer(_mesh(robot), _mesh(obstacle), SQPConfig(grid_resolution=resolution,
                                                                  **cfg),
                        grid=grid, checker=checker or object(), device="cpu")
    return ref, mine


@pytest.fixture(scope="module")
def ball():
    robot, ball = j_icosphere(1, radius=0.3), j_icosphere(2, radius=1.0)
    ref, mine = _pair(robot, ball, 24, num_waypoints=12, top_k=4, margin=0.4,
                      num_surface_samples=64, seed=1)
    rng = np.random.default_rng(3)
    q = np.zeros((12, 6), np.float32)
    q[:, 0] = np.linspace(-2.0, 2.0, 12)
    q[1:-1, :3] += rng.normal(scale=0.2, size=(10, 3)).astype(np.float32)
    q[:, 3:] = rng.uniform(-1.0, 1.0, (12, 3))
    return ref, mine, q


@pytest.fixture(scope="module")
def alpha():
    # certify_alpha.py's SQP settings at grid 32, on its init: the stored
    # RRT path resampled to 48 waypoints.
    robot = j_load_obj(assets.alpha_robot_path())
    obstacle = j_load_obj(assets.alpha_obstacle_path())
    ext = float(np.linalg.norm(robot.aabb[3:] - robot.aabb[:3]))
    ref, mine = _pair(robot, obstacle, 32, num_waypoints=48, max_outer=12,
                      max_penalty_rounds=3, margin=1.0, certify_step=0.1 * ext)
    q = resample(np.load(assets.find_asset("data/alpha_certified_path.npy")), 48)
    return ref, mine, q


def _scale(opt, q) -> float:
    """The scene's coordinate scale: the largest posed sample coordinate."""
    pts = _pose_points(torch.from_numpy(q), opt._samples)
    return max(1.0, float(pts.abs().max()))


@pytest.mark.parametrize("scene", ["ball", "alpha"])
def test_constraint_blocks_match_jax(scene, request):
    ref, mine, q = request.getfixturevalue(scene)
    g, J, tot = mine._constraint_blocks(torch.from_numpy(q))
    g_ref = np.asarray(ref._residuals(jnp.asarray(q)))
    J_ref = np.asarray(ref._jacobians(jnp.asarray(q)))
    # The K-th and (K+1)-th residuals are apart by far more than rounding,
    # so both packages pick the same samples.
    d = mine.grid.query(_pose_points(torch.from_numpy(q), mine._samples))
    top = torch.topk(mine.cfg.margin - d, mine.cfg.top_k + 1, dim=-1)[0]
    assert float((top[:, -2] - top[:, -1]).min()) > 1e-3
    assert (g_ref > 0).any()  # some residuals are live
    s = _scale(mine, q)
    assert g.shape == g_ref.shape and J.shape == J_ref.shape == g_ref.shape + (6,)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=2e-5, atol=1e-6 * s)
    np.testing.assert_allclose(J.numpy(), J_ref, rtol=2e-4, atol=1e-5 * s)
    tot_ref = float(jnp.sum(jnp.maximum(g_ref, 0.0)))
    assert abs(tot - tot_ref) < 1e-4 * max(1.0, abs(tot_ref))
    assert abs(mine._penalty_total(torch.from_numpy(q)) - tot) == 0.0


@pytest.mark.parametrize("scene", ["ball", "alpha"])
@pytest.mark.parametrize("mu,delta", [(10.0, 0.5), (250.0, 0.05)])
def test_subproblem_matches_jax(scene, mu, delta, request):
    # One solve on JAX's own blocks; dq is clipped to +-delta, so the
    # tolerance is relative to delta.
    ref, mine, q = request.getfixturevalue(scene)
    qj = jnp.asarray(q)
    g0, J = ref._residuals(qj), ref._jacobians(qj)
    want = np.asarray(ref._solve_subproblem(qj, g0, J, jnp.float32(mu), jnp.float32(delta)))
    got = mine._solve_subproblem(torch.from_numpy(q), torch.from_numpy(np.array(g0)),
                                 torch.from_numpy(np.array(J)), mu, delta).numpy()
    assert np.abs(want).max() > 0.1 * delta  # the step moves
    np.testing.assert_array_equal(got[[0, -1]], 0.0)  # endpoints pinned
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * delta)
    for m in (0.0, mu):
        assert mine._merit(torch.from_numpy(q + got), m) == pytest.approx(
            ref._merit(jnp.asarray(q + want), m), rel=1e-5)


class ScriptedChecker:
    """A checker whose whole-path verdicts follow a script: call i returns
    all-valid iff ``script[i]`` (the last entry repeats)."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = 0

    def check_valid_resolved(self, confs):
        ok = self.script[min(self.calls, len(self.script) - 1)]
        self.calls += 1
        return np.full(len(confs), ok)


@pytest.mark.parametrize("script", [(True,), (False, True), (False, False, False)])
def test_plan_follows_jax_flow(script, tmp_path):
    # The speculative certification of round r is harvested at round r+1's
    # first iteration, and the escalated round's checkpoint is written only
    # then: with the same verdicts, both packages return the same iterate at
    # the same outer count and leave the same checkpoint.
    robot, ball = j_icosphere(1, radius=0.3), j_icosphere(2, radius=1.0)
    runs = {}
    for name in ("jax", "port"):
        checker = ScriptedChecker(script)
        ref, mine = _pair(robot, ball, 16, checker=checker, num_waypoints=10, top_k=4,
                          margin=0.35, num_surface_samples=32, max_outer=3,
                          max_penalty_rounds=3, subproblem_iters=20, checkpoint_every=2,
                          checkpoint_path=str(tmp_path / f"{name}.npz"))
        res = (ref if name == "jax" else mine).plan(START, GOAL)
        runs[name] = (res, checker.calls, *checkpoint.load(tmp_path / f"{name}.npz"))
    (ref_res, ref_calls, ref_arr, ref_meta), (res, calls, arr, meta) = runs["jax"], runs["port"]
    assert (res.certified, res.outer_iters) == (ref_res.certified, ref_res.outer_iters)
    assert res.certified == script[min(calls, len(script)) - 1]
    # When the last round fails too, JAX checks its trajectory a second time.
    assert ref_calls == calls + (not res.certified)
    np.testing.assert_allclose(res.trajectory, ref_res.trajectory, rtol=0, atol=1e-5)
    assert res.merit == pytest.approx(ref_res.merit, rel=1e-5)
    assert meta == pytest.approx(ref_meta, rel=1e-6)
    np.testing.assert_allclose(arr["q"], ref_arr["q"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_across_packages(writer, tmp_path):
    rng = np.random.default_rng(9)
    arrays = {"q": rng.normal(size=(16, 6)).astype(np.float32), "n": np.arange(3)}
    meta = {"mu": 50.0, "delta": 0.25, "outer": 7, "round": 1}
    path = tmp_path / "ckpt.npz"
    save, load = ((j_checkpoint.save, checkpoint.load) if writer == "jax"
                  else (checkpoint.save, j_checkpoint.load))
    save(path, arrays, meta=meta)
    assert checkpoint.exists(path) and j_checkpoint.exists(path)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt.meta.json", "ckpt.npz"]
    got, got_meta = load(path)
    assert got_meta == meta and sorted(got) == ["n", "q"]
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)
    save(path, {"q": arrays["q"][:2]})  # no meta: the old sidecar stays
    assert load(path)[0]["q"].shape == (2, 6)


@pytest.mark.parametrize("max_outer", [0, -1])
def test_max_outer_below_one_raises(max_outer):
    # The JAX package's sqp.py:358-371 drops a round's pending
    # certification when no outer iteration harvests it.
    with pytest.raises(ValueError, match="max_outer"):
        SQPConfig(max_outer=max_outer)
    assert SQPConfig(max_outer=1).max_outer == 1


def test_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card error")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SQPOptimizer(icosphere(1, radius=0.3), icosphere(1, radius=1.0),
                     SQPConfig(grid_resolution=8))


@pytest.mark.slow
class TestSQP:
    def test_sqp_around_sphere(self):
        opt = SQPOptimizer(
            icosphere(1, radius=0.3, name="robot"), icosphere(2, radius=1.0, name="ball"),
            SQPConfig(num_waypoints=16, max_outer=15, top_k=4, margin=0.35, grid_resolution=40,
                      num_surface_samples=64),
            device="cpu")
        res = opt.plan(START, GOAL)
        assert res.certified, f"not certified after {res.outer_iters} iters"
        np.testing.assert_allclose(res.trajectory[0], START, atol=1e-6)
        np.testing.assert_allclose(res.trajectory[-1], GOAL, atol=1e-6)
        # Deviates around the ball.
        assert np.abs(res.trajectory[4:-4, 1:3]).max() > 0.5

    def test_sqp_checkpoint_resume(self, tmp_path):
        path = str(tmp_path / "sqp.npz")
        cfg = SQPConfig(num_waypoints=16, max_outer=6, top_k=4, margin=0.35, grid_resolution=40,
                        num_surface_samples=64, max_penalty_rounds=1, checkpoint_path=path,
                        checkpoint_every=2)
        opt = SQPOptimizer(icosphere(1, radius=0.3, name="robot"),
                           icosphere(2, radius=1.0, name="ball"), cfg, device="cpu")
        opt.plan(START, GOAL)
        arrays, meta = checkpoint.load(path)
        assert arrays["q"].shape == (16, 6)
        assert meta["outer"] >= 2
        # Resume picks up the checkpointed trajectory (endpoints re-pinned).
        res2 = opt.plan(START, GOAL, resume=True)
        np.testing.assert_allclose(res2.trajectory[0], START, atol=1e-6)
        np.testing.assert_allclose(res2.trajectory[-1], GOAL, atol=1e-6)
