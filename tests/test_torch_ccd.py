"""The port's continuous certifier (`robocheck_tpu_torch.planner.ccd`)
against `robocheck_tpu.planner.ccd`, on the CPU.

Tests ported from `tests/test_ccd.py` keep their names. The certifier refutes
tunneling paths that discrete checks miss, certifies clearly free motion,
and reports near-floor clearances as unproven; on the same scenes the two
packages give the same verdicts.
"""
import numpy as np
import pytest

from robocheck_tpu.kernels.megakernel import MegaKernelChecker as JChecker
from robocheck_tpu.models.shapes import box as j_box
from robocheck_tpu.models.shapes import icosphere as j_icosphere
from robocheck_tpu.planner import ccd as j_ccd
from robocheck_tpu_torch.core.types import Mesh
from robocheck_tpu_torch.kernels.megakernel import MegaKernelChecker
from robocheck_tpu_torch.models.shapes import box, icosphere
from robocheck_tpu_torch.planner.ccd import (SweptCertifier, certify_multires,
                                             covering_radius, subdivide_mesh)
from robocheck_tpu_torch.runtime import native


def _mesh(m):
    return Mesh(m.vertices, m.triangles, m.name)


@pytest.fixture(scope="module")
def wall_world():
    robot = box(extent=(0.4, 0.4, 0.4), name="robot")
    wall = box(extent=(0.1, 6.0, 6.0), name="wall")
    checker = MegaKernelChecker(robot, wall, device="cpu")
    cert = SweptCertifier(robot, wall, resolution=64, device="cpu")
    return robot, wall, checker, cert


def test_subdivision_halves_covering_radius():
    m = icosphere(1, radius=1.0)
    r0 = covering_radius(m)
    m1 = subdivide_mesh(m, 1)
    assert m1.num_triangles == 4 * m.num_triangles
    assert abs(covering_radius(m1) - r0 / 2) < 1e-6


def test_refutes_tunneling_path(wall_world):
    # Both waypoints are free, the straight motion passes through the wall.
    robot, wall, checker, cert = wall_world
    path = np.zeros((2, 6), dtype=np.float32)
    path[0, 0], path[1, 0] = -2.0, 2.0
    assert checker.check_valid_resolved(path).all()
    res = cert.certify(path, checker)
    assert res.collision and not res.certified


def test_certifies_clearly_free_path(wall_world):
    robot, wall, checker, cert = wall_world
    path = np.zeros((3, 6), dtype=np.float32)
    path[:, 0] = 3.0
    path[:, 1] = [-2.0, 0.0, 2.0]
    path[2, 5] = 0.5  # roll along the way
    assert cert.floor() < 1.0
    res = cert.certify(path, checker)
    assert res.certified and not res.collision
    assert res.min_clearance > cert.floor()


def test_near_floor_clearance_is_unproven_not_lied_about(wall_world):
    robot, wall, checker, cert = wall_world
    gap = 0.5 * cert.floor()
    path = np.zeros((3, 6), dtype=np.float32)
    path[:, 0] = 0.05 + 0.2 + gap
    path[:, 1] = [-1.0, 0.0, 1.0]
    assert checker.check_valid_resolved(path).all()
    res = cert.certify(path, checker, max_depth=4)
    assert not res.certified and not res.collision
    assert res.uncertified_steps > 0
    assert res.min_seen_clearance < cert.floor()


def test_exact_mode_and_multires(wall_world):
    # Exact native distances: floor = r_cov alone, so a path the grid
    # certifier cannot decide certifies under escalation; tunneling is
    # still refuted.
    if not (native.available() and native.has_point_mesh_dist()):
        pytest.skip("native library not built")
    robot, wall, checker, cert_grid = wall_world
    gap = 0.6 * cert_grid.floor()
    path = np.zeros((3, 6), dtype=np.float32)
    path[:, 0] = 0.05 + 0.2 + gap
    path[:, 1] = [-1.0, 0.0, 1.0]
    assert checker.check_valid_resolved(path).all()
    res_grid = cert_grid.certify(path, checker, max_depth=4)
    assert not res_grid.certified and not res_grid.collision
    res = certify_multires(robot, wall, path, checker, levels=((0, 6), (2, 8)),
                           backend="native")
    assert res.certified and not res.collision
    tun = np.zeros((2, 6), dtype=np.float32)
    tun[0, 0], tun[1, 0] = -2.0, 2.0
    res2 = certify_multires(robot, wall, tun, checker, levels=((0, 6), (2, 8)),
                            backend="native")
    assert res2.collision and not res2.certified


def test_trajopt_swept_certificate():
    # End to end: the optimizer's certificate upgrades to continuous when
    # swept_certify is on (the grid certifier on the CPU).
    from robocheck_tpu_torch.planner import TrajectoryOptimizer, TrajOptConfig

    opt = TrajectoryOptimizer(
        box(extent=(0.3, 0.3, 0.3), name="robot"), icosphere(1, radius=0.6, name="ball"),
        TrajOptConfig(num_waypoints=12, iters_per_round=60, max_rounds=3, grid_resolution=32,
                      swept_certify=True, seed=3),
        device="cpu")
    start = np.array([-2.0, 0, 0, 0, 0, 0], np.float32)
    goal = np.array([2.0, 0, 0, 0, 0, 0], np.float32)
    res = opt.plan(start, goal)
    assert res.certified
    assert res.swept is not None and not res.swept.collision
    # The sphere world is wide open: the continuous certificate succeeds
    # outright here.
    assert res.swept.certified


@pytest.mark.parametrize("levels", [0, 1, 2, 3])
def test_subdivision_and_covering_radius_equal_jax(levels):
    mine, ref = icosphere(1, radius=0.7, name="m"), j_icosphere(1, radius=0.7, name="m")
    got, want = subdivide_mesh(mine, levels), j_ccd.subdivide_mesh(ref, levels)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.triangles, want.triangles)
    assert covering_radius(got) == j_ccd.covering_radius(want)


@pytest.mark.parametrize("case", ["gap", "tunnel"])
def test_multires_matches_jax(case, monkeypatch):
    # certify_multires on the wall scene of tests/test_clearance.py: the same
    # certified / collision / uncertified_steps through both packages (JAX:
    # its engine, its kernel in interpret mode).
    from robocheck_tpu.planner.clearance import TpuClearanceEngine

    # 32 pairs a dispatch, not 1,024: the same distances (the rest is
    # padding) at a fraction of the CPU time.
    monkeypatch.setattr(TpuClearanceEngine, "_pair_chunk", lambda self: 32)
    robot, wall = j_box(extent=(0.1, 0.1, 0.1), name="r"), j_box(extent=(0.4, 4.0, 4.0))
    if case == "gap":
        path = np.zeros((3, 6), np.float32)
        path[:, 0] = 0.05 + 0.2 + 0.08
        path[:, 1] = [-1.0, 0.0, 1.0]
    else:
        path = np.zeros((2, 6), np.float32)
        path[0, 0], path[1, 0] = -2.0, 2.0
    levels = ((0, 6), (2, 8))
    got = certify_multires(_mesh(robot), _mesh(wall), path,
                           MegaKernelChecker(_mesh(robot), _mesh(wall), device="cpu"),
                           levels=levels, device="cpu")
    want = j_ccd.certify_multires(robot, wall, path, JChecker(robot, wall, interpret=True),
                                  levels=levels, backend="tpu")
    assert (got.certified, got.collision, got.uncertified_steps) == (
        want.certified, want.collision, want.uncertified_steps)
    assert got.certified == (case == "gap") and got.collision == (case == "tunnel")
    # The tunneling path refutes at refine 0 in the port, at refine 2 in
    # JAX (test below), so only the gap's check counts agree.
    assert (got.num_checks, want.num_checks) == ((68, 68) if case == "gap" else (9, 31))


def test_touching_contact_resolves_colliding():
    # The tunneling path x = -2 -> 2 through the wall above: its midpoints
    # at x = +-0.25 put the 0.1 box's face on the 0.4 wall's face. The port
    # flags them (packed bit 2) and the float64 oracle resolves them
    # colliding, so the port's certificate refutes at refine 0; the JAX
    # kernel reports them valid, and JAX refutes at refine 2.
    from robocheck_tpu_torch.oracle import check_configs

    robot, wall = j_box(extent=(0.1, 0.1, 0.1), name="r"), j_box(extent=(0.4, 4.0, 4.0))
    confs = np.zeros((2, 6), np.float32)
    confs[:, 0] = [0.25, -0.25]
    port = MegaKernelChecker(_mesh(robot), _mesh(wall), device="cpu")
    assert (port.check_packed(confs) == 0b101).all()
    assert not port.check_valid_resolved(confs).any()
    assert not check_configs(_mesh(robot), _mesh(wall), confs).any()
    assert JChecker(robot, wall, interpret=True).check_valid_resolved(confs).all()


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        SweptCertifier(box(), box(), exact=True, backend="tpu", device="cpu")
