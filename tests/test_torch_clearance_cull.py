"""The culled clearance scan's plain side (`robocheck_tpu_torch.kernels.clearance`):
``cull_plan``, the counts and bound it feeds, the engine's table and
always-scan flags, and the wrapper's refusals.

The culled kernel skips only obstacle groups it proves too far to hold a
pair's minimum, so the min over the distances ``cull_plan`` keeps must equal
the full scan (``pair_min_reference``) bit for bit, NaN included. These
tests hold that on the CPU; `chip_smoke.py` phase 9 (a) holds the kernel's
output and its scan count against the twin and ``cull_plan`` on the card.
The JAX package has no culled scan: the engine's answers are held against
its `TpuClearanceEngine` in `tests/test_torch_clearance.py`.
"""
import numpy as np
import pytest
import torch

from robocheck_tpu.planner.clearance import TpuClearanceEngine
from robocheck_tpu_torch.core.types import Mesh
from robocheck_tpu_torch.io import assets
from robocheck_tpu_torch.io.obj import load_obj
from robocheck_tpu_torch.kernels import clearance as kc
from robocheck_tpu_torch.models.shapes import icosphere
from robocheck_tpu_torch.planner.ccd import subdivide_mesh
from robocheck_tpu_torch.planner.clearance import ClearanceEngine
from robocheck_tpu_torch.profiling import bounds


def _planned_min(rows, ids, blocks, tris, plan, size):
    """What the culled kernel returns: sqrt of the NaN-sticky min over the
    distances ``plan`` keeps; NaN for an id outside the table."""
    nb, block = blocks.shape[:2]
    good = (ids >= 0) & (ids < nb)
    keep = plan[:, torch.arange(block) // kc.unit_vertices(block)]  # [k, block, ng]
    m = torch.full((len(rows), block), float("inf"))
    for sl, ts, p, tri in kc._twin_steps(rows, ids, blocks, tris):
        d = kc.point_tri_d2_parts(p, *tri)
        t = torch.arange(ts.start, ts.start + d.shape[-1])
        d = torch.where(keep[sl][..., t // size], d, torch.full_like(d, float("inf")))
        m[sl] = torch.minimum(m[sl], d.amin(dim=-1))
    out = torch.sqrt(m.amin(dim=-1))
    out[~good] = float("nan")
    return out


def _same_bits(got, want):
    return bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())


def _confs(rng, n, lo, hi):
    confs = rng.uniform(-np.pi, np.pi, (n, 6)).astype(np.float32)
    confs[:, 0:3] = rng.uniform(lo, hi, (n, 3))
    return confs


def _random_scene(seed):
    """A random block table and triangle soup with a count no multiple of 32,
    a zero-area triangle (b = a, whose distances are often NaN, for even
    seeds; c = b, never NaN, for odd ones) and ids outside the table."""
    rng = np.random.default_rng(seed)
    block, nt = ((1, 45), (16, 70), (37, 33), (200, 97), (1100, 40))[seed]
    tris = (rng.normal(size=(nt, 9)) * 2.0).astype(np.float32)
    if seed % 2:
        tris[nt // 2, 6:9] = tris[nt // 2, 3:6]
    else:
        tris[nt // 2, 3:6] = tris[nt // 2, 0:3]
    blocks = (rng.normal(size=(4, block, 3)) * 0.4).astype(np.float32)
    confs = _confs(rng, 12, -4.0, 4.0)
    ids = rng.integers(0, 4, 12).astype(np.int32)
    ids[[3, 7]] = [-1, 4]
    return (kc.pose_rows(torch.from_numpy(confs)), torch.from_numpy(ids),
            torch.from_numpy(blocks), torch.from_numpy(tris))


def _alpha_scene(refine):
    """The alpha pair (refine 0 or 1), 3 configurations near the obstacle's
    center, every block."""
    robot = subdivide_mesh(load_obj(assets.alpha_robot_path()), refine)
    obstacle = load_obj(assets.alpha_obstacle_path())
    eng = ClearanceEngine(robot.vertices, obstacle, device="cpu")
    rng = np.random.default_rng(40 + refine)
    confs = _confs(rng, 3, -0.4, 0.4)
    confs[:, 0:3] += (obstacle.aabb[:3] + obstacle.aabb[3:]) / 2
    nb = eng.num_blocks
    rows = kc.pose_rows(torch.from_numpy(confs)).repeat_interleave(nb, 0)
    ids = torch.arange(nb, dtype=torch.int32).repeat(3)
    return rows, ids, eng._blocks, eng._tris, eng._groups, 2 * eng.err_bound(confs)


@pytest.mark.parametrize("case", ["random-0", "random-1", "random-2", "random-3", "random-4",
                                  "alpha-refine-0", "alpha-refine-1", "alpha-representatives"])
def test_planned_min_equals_full_scan(case):
    kind, _, arg = case.rpartition("-")
    if kind == "random":
        rows, ids, blocks, tris = _random_scene(int(arg))
        groups, slack = kc.make_groups(tris, 32), 1e-3
        assert groups.always.sum() >= 1  # the zero-area triangle's group
    else:
        rows, ids, blocks, tris, groups, slack = _alpha_scene(int(arg) if arg.isdigit() else 0)
        if arg == "representatives":
            blocks = blocks[:, 0:1, :].contiguous()  # 1-vertex blocks
    plan = kc.cull_plan(rows, ids, blocks, tris, groups, slack)
    want = kc.pair_min_reference(rows, ids, blocks, tris)
    got = _planned_min(rows, ids, blocks, tris, plan, groups.size)
    assert _same_bits(got, want), (got, want)
    # The culled instance's twin (the engine's exact phase on the CPU) takes
    # only the planned scans and gives the same bits.
    assert _same_bits(kc.pair_min_planned(rows, ids, blocks, tris, plan, groups.size), want)
    good = (ids >= 0) & (ids < blocks.shape[0])
    if kind == "random":
        # NaN from the b = a triangle is kept, never culled away.
        assert torch.isnan(want[good]).any() == (int(arg) % 2 == 0)
    assert not plan[~good].any() and plan[good].any(dim=(1, 2)).all()
    # Every unit scans g0 and every always-scan group.
    assert (plan[good][..., groups.always.bool()]).all()
    assert plan[good].all(dim=1).any(dim=1).all()


def test_plan_picks_nearest_group_first_on_ties_and_keeps_nan():
    # Two unit triangles at x = +-3 in groups 0 and 1 (size 1), one vertex at
    # the origin: equal box distances, g0 = 0; with slack 0 group 1's box is
    # at sqrt(m0) exactly, so it is scanned (not above the threshold).
    tris = torch.tensor([[3.0, 0, 0, 3, 1, 0, 3, 0, 1], [-3.0, 0, 0, -3, 1, 0, -3, 0, 1],
                         [40.0, 0, 0, 40, 1, 0, 40, 0, 1]])
    groups = kc.make_groups(tris, 1)
    rows = kc.pose_rows(torch.zeros((1, 6)))
    blocks = torch.zeros((1, 1, 3))
    ids = torch.zeros(1, dtype=torch.int32)
    plan = kc.cull_plan(rows, ids, blocks, tris, groups, 0.0)
    assert plan[0, 0].tolist() == [True, True, False]
    # A non-finite triangle's group is always scanned; a NaN pose scans all.
    bad = tris.clone()
    bad[2, 0] = float("nan")
    groups = kc.make_groups(bad, 1)
    assert groups.always.tolist() == [0, 0, 1]
    assert kc.cull_plan(rows, ids, blocks, bad, groups, 0.0)[0, 0].tolist() == [True] * 3
    nan_rows = rows.clone()
    nan_rows[0, 9] = float("nan")
    assert kc.cull_plan(nan_rows, ids, blocks, tris, kc.make_groups(tris, 1), 0.0).all()
    assert _same_bits(_planned_min(nan_rows, ids, blocks, tris,
                                   kc.cull_plan(nan_rows, ids, blocks, tris,
                                                kc.make_groups(tris, 1), 0.0), 1),
                      kc.pair_min_reference(nan_rows, ids, blocks, tris))


def test_units_follow_the_kernels_lanes():
    # min(lanes, 32) x 4 vertices, lanes the least power of two holding the
    # block 4 to a thread, at most 256.
    assert [kc.unit_vertices(b) for b in (1, 4, 5, 37, 100, 128, 129, 1024, 1100)] == [
        4, 4, 8, 64, 128, 128, 128, 128, 128]


def _far_scene():
    """A sphere robot far beside a larger sphere obstacle: most groups are
    far from most units."""
    robot = subdivide_mesh(icosphere(2, radius=0.5, name="r"), 2)
    obstacle = icosphere(2, radius=1.0, name="o")
    eng = ClearanceEngine(robot.vertices, obstacle, device="cpu")
    confs = np.zeros((2, 6), np.float32)
    confs[:, 0] = [1.8, 2.5]
    confs[1, 3:6] = [0.3, -0.2, 1.1]
    nb = eng.num_blocks
    rows = kc.pose_rows(torch.from_numpy(confs)).repeat_interleave(nb, 0)
    ids = torch.arange(nb, dtype=torch.int32).repeat(2)
    return eng, rows, ids, 2 * eng.err_bound(confs)


def test_region_counts_under_a_plan():
    eng, rows, ids, slack = _far_scene()
    plan = kc.cull_plan(rows, ids, eng._blocks, eng._tris, eng._groups, slack)
    full = kc.region_counts(rows, ids, eng._blocks, eng._tris)
    part = kc.region_counts(rows, ids, eng._blocks, eng._tris, plan, eng._groups.size)
    assert (part <= full).all()
    # The kept distances: each scan is its unit's vertices x its group's
    # triangles.
    unit, size, nt = kc.unit_vertices(1024), eng._groups.size, eng.num_triangles
    in_unit = torch.full((plan.shape[1],), unit)
    in_group = torch.tensor([min(size, nt - g * size) for g in range(plan.shape[2])])
    kept = (plan.long() * in_unit[None, :, None] * in_group[None, None, :]).sum()
    assert part.sum() == kept
    assert 0 < part.sum() / full.sum() < 0.5, part.sum() / full.sum()
    # The twin's answer is the planned one.
    assert _same_bits(_planned_min(rows, ids, eng._blocks, eng._tris, plan, size),
                      kc.pair_min_reference(rows, ids, eng._blocks, eng._tris))


def test_clearance_work_charges_culling():
    eng, rows, ids, slack = _far_scene()
    plan = kc.cull_plan(rows, ids, eng._blocks, eng._tris, eng._groups, slack)
    regions = kc.region_counts(rows, ids, eng._blocks, eng._tris, plan, eng._groups.size)
    k, (_, units, ng) = len(rows), plan.shape
    b0, o0 = bounds.clearance_work(k, 1024, eng.num_triangles, eng.num_blocks, regions)
    b1, o1 = bounds.clearance_work(k, 1024, eng.num_triangles, eng.num_blocks, regions,
                                   plan.numpy())
    assert b1 - b0 == ng * 25
    # Every pair scans: the boxes of its posed vertices, g0's choice over
    # every group (pass 1) and the cull test of every unit and group.
    assert o1 - o0 == k * (1024 * bounds.BOX_VERTEX_OPS + ng * bounds.BOX_DIST_OPS
                           + units * ng * bounds.CULL_TEST_OPS)


def test_engine_table_and_flags():
    # A zero-area triangle and a needle among the obstacle's triangles: their
    # groups are always scanned; the table's edges are the twin's b - a,
    # c - a, c - b bit for bit, and the group boxes stay the reference's.
    obstacle = icosphere(2, radius=1.0, name="o")
    v = np.concatenate([obstacle.vertices,
                        np.array([[5, 0, 0], [6, 0, 0], [7, 0, 0], [5, 5, 5], [9, 5, 5],
                                  [5, 5, 5 + 1e-5]], np.float32)])
    n = len(obstacle.vertices)
    t = np.concatenate([obstacle.triangles, [[n, n + 1, n + 2], [n + 3, n + 4, n + 5]]])
    mesh = Mesh(v, t.astype(np.int32), "o+thin")
    robot = icosphere(1, radius=0.3, name="r")
    eng = ClearanceEngine(robot.vertices, mesh, device="cpu")
    tris = eng._tris
    a, b, c = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    assert torch.equal(eng._tab, torch.cat([tris, b - a, c - a, c - b], dim=1))
    assert torch.equal(eng._tab, kc.tri_table(tris))
    flags = kc.always_visit(tris.numpy(), 32)
    thin = [i for i in range(len(tris)) if tris[i, 0] >= 5]
    assert len(thin) == 2
    assert eng._groups.always.tolist() == flags.tolist()
    assert sorted(np.flatnonzero(flags).tolist()) == sorted({i // 32 for i in thin})
    ref = TpuClearanceEngine(robot.vertices, mesh)
    np.testing.assert_array_equal(eng._glo.numpy(), np.asarray(ref._glo))
    np.testing.assert_array_equal(eng._ghi.numpy(), np.asarray(ref._ghi))
    # The engine's stats split the kernel's time by phase (0 on the CPU).
    eng.min_distances(np.zeros((2, 6), np.float32))
    assert eng.stats["kernel_s"] == eng.stats["rep_kernel_s"] + eng.stats["exact_kernel_s"] == 0


@pytest.mark.parametrize("fault", ["cpu", "boxes", "always", "size", "visits", "kept",
                                   "kept-dtype"])
def test_pair_min_cuda_refuses(fault):
    rows, ids = torch.zeros((2, 12)), torch.zeros(2, dtype=torch.int32)
    blocks, tris = torch.zeros((1, 4, 3)), torch.zeros((40, 9))
    groups, tab = kc.make_groups(tris, 32), kc.tri_table(tris)
    kwargs = {"groups": groups}
    if fault == "boxes":
        kwargs["groups"] = kc.CullGroups(torch.zeros((3, 6)), groups.always, 32)
    elif fault == "always":
        kwargs["groups"] = kc.CullGroups(groups.boxes, groups.always.float(), 32)
    elif fault == "size":
        kwargs["groups"] = kc.CullGroups(groups.boxes, groups.always, 0)
    elif fault == "visits":
        kwargs = {"visits": torch.zeros(2, dtype=torch.int32)}
    elif fault == "kept":
        kwargs = {"kept": torch.zeros((), dtype=torch.int64)}
    elif fault == "kept-dtype":
        kwargs["kept"] = torch.zeros((), dtype=torch.int32)
    match = {"cpu": "CUDA tensor", "boxes": "need boxes", "always": "uint8",
             "size": "need boxes", "visits": "pass groups", "kept": "pass groups",
             "kept-dtype": "one int64"}[fault]
    with pytest.raises(ValueError, match=match):
        kc.pair_min_cuda(rows, ids, blocks, tab, **kwargs)
