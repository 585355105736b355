"""The frozen generators draw what the reference's do."""
import numpy as np

from gen import alpha_bot, clearance_queries
from ref.mesh import read_obj
from conftest import BENCH

ROBOT = read_obj(BENCH / "data/alpha1.0/robot.obj")
OBSTACLE = read_obj(BENCH / "data/alpha1.0/obstacle.obj")
EXTENT = ROBOT[0].max(0).astype(np.float64) - ROBOT[0].min(0)


def test_hard_and_easy_boxes_are_utils_rai_ranges():
    """`Utils_rai.cu:111-136`: translations within +-extent/200 (hard) and
    +-10 x extent (easy) per axis, every angle uniform in [-pi, pi]."""
    for box, scale in (("hard", 1 / 200), ("easy", 10.0)):
        (confs,) = alpha_bot.batches(np.random.default_rng(1), ROBOT[0],
                                     {"box": box, "rows": 20000, "pool": 1})
        assert confs.dtype == np.float32 and confs.shape == (20000, 6)
        half = EXTENT * scale
        assert (np.abs(confs[:, :3]) <= half * (1 + 1e-6)).all()
        assert (np.abs(confs[:, :3]).max(0) > 0.99 * half).all()  # the box is filled
        assert (np.abs(confs[:, 3:]) <= np.pi + 1e-6).all()
        assert (np.abs(confs[:, 3:]).max(0) > 0.99 * np.pi).all()


def test_the_seed_fixes_the_pool():
    params = {"box": "hard", "rows": 1000, "pool": 3}
    a = alpha_bot.batches(np.random.default_rng(7), ROBOT[0], params)
    b = alpha_bot.batches(np.random.default_rng(7), ROBOT[0], params)
    assert len(a) == 3 and all((x == y).all() for x, y in zip(a, b))
    assert not (a[0] == a[1]).all()


def test_clearance_queries_are_the_bench_scene():
    """`bench.py:186-190`: translations within 0.6 x the obstacle's extent of
    its box's centre, angles uniform."""
    (q,) = clearance_queries.batches(np.random.default_rng(5), OBSTACLE,
                                     {"rows": 5000, "pool": 1, "reach": 0.6})
    lo, hi = OBSTACLE[0].min(0), OBSTACLE[0].max(0)
    centre, ext = (lo + hi) / 2, hi - lo
    assert (np.abs(q[:, :3] - centre) <= 0.6 * ext * (1 + 1e-5)).all()
    assert (np.abs(q[:, 3:]) <= np.pi + 1e-6).all()

