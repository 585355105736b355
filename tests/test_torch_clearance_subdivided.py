"""The clearance engine against a subdivided obstacle (the benchmark's
`alpha1.0-sub3-clearance` configuration at CPU sizes): the engine's twins
against the benchmark's plain float64 reference
(`benchmark/ref/blocked_clearance.py`, which derives the subdivided
obstacle itself), that reference against the unsubdivided obstacle, the
engine's kept-scan counter against `cull_plan`, and the benchmark's mixed
check traffic."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from robocheck_tpu_torch.io import assets
from robocheck_tpu_torch.io.obj import load_obj
from robocheck_tpu_torch.kernels import clearance as kc
from robocheck_tpu_torch.models.shapes import icosphere
from robocheck_tpu_torch.planner.ccd import subdivide_mesh
from robocheck_tpu_torch.planner.clearance import ClearanceEngine

sys.path.append(str(Path(__file__).resolve().parents[1] / "benchmark"))
from gen import alpha_bot, alpha_mixed, clearance_queries  # noqa: E402
from ref.blocked_clearance import BlockedClearance, subdivided_mesh  # noqa: E402
from ref.clearance import Clearance  # noqa: E402
from ref.mesh import read_obj, subdivided_vertices  # noqa: E402

ROBOT = read_obj(assets.alpha_robot_path())
OBSTACLE = read_obj(assets.alpha_obstacle_path())


def _queries(n: int, seed: int) -> np.ndarray:
    (confs,) = clearance_queries.batches(np.random.default_rng(seed), OBSTACLE,
                                         {"rows": n, "pool": 1, "reach": 0.6})
    return confs


@pytest.mark.parametrize("levels", [1, 2])
def test_engine_is_at_or_below_the_plain_truth_on_a_subdivided_obstacle(levels):
    robot = subdivide_mesh(load_obj(assets.alpha_robot_path()), 1)
    obstacle = subdivide_mesh(load_obj(assets.alpha_obstacle_path()), levels)
    eng = ClearanceEngine(robot.vertices, obstacle, device="cpu")
    assert eng.num_triangles == 1008 * 4 ** levels and eng.num_blocks == 3
    confs = _queries(4, 2100 + levels)
    d = eng.min_distances(confs)
    truth = BlockedClearance(subdivided_vertices(*ROBOT, 1),
                             subdivided_mesh(*OBSTACLE, levels), "cpu").distances(confs)
    err = eng.err_bound(confs)
    assert (d <= truth).all(), (truth - d).min()
    assert (truth - d <= 2 * err).all(), ((truth - d).max(), err)
    counted = eng.counters()
    assert 0 < counted["scans_kept"] < counted["scans"]


def test_plain_reference_on_the_subdivided_obstacle_is_the_published_ones_to_rounding():
    """Subdivision keeps the surface: the distances move only by the
    float32 rounding of each round's midpoints (at most half a float32 ulp
    of the largest coordinate per axis a round); on the published obstacle
    the blocked reference is `ref/clearance.py`'s, culled otherwise."""
    points = ROBOT[0]
    confs = _queries(4, 2110)
    plain = Clearance(points, OBSTACLE, "cpu").distances(confs)
    np.testing.assert_allclose(BlockedClearance(points, OBSTACLE, "cpu").distances(confs),
                               plain, rtol=1e-12, atol=0)
    ulp = float(np.spacing(np.abs(OBSTACLE[0]).max()))
    for levels in (1, 2):
        sub = subdivided_mesh(*OBSTACLE, levels)
        assert len(sub[1]) == 1008 * 4 ** levels
        got = BlockedClearance(points, sub, "cpu").distances(confs)
        assert np.abs(got - plain).max() <= levels * 0.5 * np.sqrt(3) * ulp
    # The reference's tessellation is the program's, triangle for triangle.
    mine = subdivide_mesh(load_obj(assets.alpha_obstacle_path()), 2)
    sub = subdivided_mesh(*OBSTACLE, 2)

    def triangles(v, t):
        return {tuple(sorted(map(tuple, tri))) for tri in np.asarray(v)[np.asarray(t)].tolist()}

    assert triangles(mine.vertices, mine.triangles) == triangles(*sub)


def test_kept_scans_are_cull_plans_count():
    """The engine's counters: the kept (pair, unit, group) scans equal the
    sum of `cull_plan` over its exact launches, all scans k x units x
    groups a launch."""
    rng = np.random.default_rng(21)
    points = rng.uniform(-0.3, 0.3, (3 * 1024, 3)).astype(np.float32)
    eng = ClearanceEngine(points, icosphere(2, radius=1.0, name="o"), device="cpu")
    launches = []
    scan = eng._scan

    def recorded(phase, rows, ids, table, slack=None):
        if slack is not None:
            launches.append((rows, ids, table, slack))
        return scan(phase, rows, ids, table, slack)

    eng._scan = recorded
    confs = rng.uniform(-np.pi, np.pi, (6, 6)).astype(np.float32)
    confs[:, 0:3] = rng.uniform(-0.8, 0.8, (6, 3))
    assert eng.counters() == {"scans_kept": 0, "scans": 0}
    for part in (confs[:4], confs[4:]):
        eng.min_distances(part)
    assert launches
    want = sum(int(kc.cull_plan(r, i, t, eng._tris, eng._groups, s).sum())
               for r, i, t, s in launches)
    units = -(-1024 // kc.unit_vertices(1024))
    assert eng.counters() == {"scans_kept": want,
                              "scans": sum(len(i) for _, i, _, _ in launches) * units
                              * eng.num_groups}
    assert 0 < want < eng.counters()["scans"]


def test_mixed_rows_interleave_hard_and_easy_half_and_half():
    params = {"rows": 10001, "pool": 2}
    pool = alpha_mixed.batches(np.random.default_rng(8), ROBOT[0], params)
    again = alpha_mixed.batches(np.random.default_rng(8), ROBOT[0], params)
    assert all((a == b).all() for a, b in zip(pool, again)) and not (pool[0] == pool[1]).all()
    extent = ROBOT[0].max(0).astype(np.float64) - ROBOT[0].min(0)
    for confs in pool:
        assert confs.dtype == np.float32 and confs.shape == (10001, 6)
        hard = (np.abs(confs[:, :3]) <= extent * alpha_bot.SCALE["hard"] * (1 + 1e-6)).all(1)
        easy = (np.abs(confs[:, :3]) <= extent * alpha_bot.SCALE["easy"] * (1 + 1e-6)).all(1)
        assert hard[0::2].all() and easy.all()
        assert hard[1::2].mean() < 0.01  # an easy row falls in the hard box ~1e-8 of the time
        assert (np.abs(confs[:, 3:]) <= np.pi + 1e-6).all()
