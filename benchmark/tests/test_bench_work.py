"""The least work of K1 that ``k1_roofline`` divides by."""
import numpy as np

from harness import work


def test_colliding_rows_are_charged_no_pair_work():
    valid = np.array([True, False, True, True])
    broad = np.array([True, True, False, True])
    pairs = np.array([10, 1000, 0, 5])
    n_bytes, ops = work.check_work(792, 1008, 1008, valid, broad, pairs)
    assert ops == 4 * (792 * work.VERTEX_OPS + 1008 * work.BOX_OPS) + 15 * work.PLANE_OPS
    _, ops_free = work.check_work(792, 1008, 1008, valid, broad, np.array([10, 0, 0, 5]))
    assert ops_free == ops  # the colliding row's 1000 pairs cost nothing
    assert n_bytes == 4 * work.ROW_BYTES + 2016 * work.TRIANGLE_BYTES


def test_least_time_is_the_larger_bound():
    assert work.least_seconds(3.35e12, 0) == 1.0
    assert work.least_seconds(0, 67e12) == 1.0
    assert work.least_seconds(3.35e12, 2 * 67e12) == 2.0


def test_a_shared_vertex_is_posed_once():
    """The alpha robot's 1,008 triangles use 792 distinct vertices: a row's
    least posing work is 792 vertices and 1,008 boxes, not 1,008 x 3
    corners."""
    from conftest import BENCH
    from ref.mesh import read_obj

    _, tris = read_obj(BENCH / "data/alpha1.0/robot.obj")
    assert (len(np.unique(tris)), len(tris)) == (792, 1008)
    none = np.zeros(1, bool)
    _, ops = work.check_work(792, 1008, 1008, none, none, np.zeros(1))
    assert ops == 792 * 18 + 1008 * 18
