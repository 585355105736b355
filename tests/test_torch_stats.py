"""The port's stats path (`MegaKernelChecker.check`, `check_block`,
`broad_block`, `check_valid(presort=True)`) and its profiling counters,
against the JAX package run as its own tests run it (interpret mode on the
CPU) and against the port itself.

On the CPU the checker runs the kernels' PyTorch twins; `chip_smoke.py`
holds the CUDA kernels against those twins on the card. The JAX side takes
its own pose rows (XLA on the CPU fuses multiply-adds, the port does not), so
verdicts and counts are compared exactly and a box test that such rounding
decided differently would be a fault to log, not a tolerance to widen.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robocheck_tpu.core.types import Mesh as JMesh
from robocheck_tpu.kernels import megakernel as jmk
from robocheck_tpu.models.shapes import box as j_box
from robocheck_tpu.models.shapes import icosphere as j_icosphere
from robocheck_tpu.models.shapes import tetrahedron as j_tetrahedron
from robocheck_tpu.oracle import cpu_oracle as j_oracle
from robocheck_tpu.profiling import counters as j_counters
from robocheck_tpu_torch.core.types import Mesh
from robocheck_tpu_torch.io import assets
from robocheck_tpu_torch.io.obj import load_obj
from robocheck_tpu_torch.kernels import megakernel as mk
from robocheck_tpu_torch.profiling import bounds, counters, timers
from robocheck_tpu_torch.profiling.timers import benchmark, busy_us, trace


def _mesh(m):
    return Mesh(m.vertices, m.triangles, m.name)


def _spheres():
    # tests/test_megakernel.py:20-41: deep overlap, shell-crossing, near-miss, far.
    rng = np.random.default_rng(77)
    confs = np.zeros((16, 6), dtype=np.float32)
    confs[:, 0] = np.concatenate([
        rng.uniform(0.0, 0.4, 4), rng.uniform(0.4, 2.6, 6),
        rng.uniform(2.6, 2.7, 2), rng.uniform(5.0, 50.0, 4)]).astype(np.float32)
    confs[:, 3:6] = rng.uniform(-np.pi, np.pi, (16, 3)).astype(np.float32)
    return j_icosphere(1, radius=1.0, name="robot"), j_icosphere(1, radius=1.5,
                                                                  name="obstacle"), confs


def _tetrahedra():
    # tests/test_megakernel.py:65-84: collide at the identity, clear at +100x.
    robot = j_tetrahedron()
    obstacle = JMesh(np.array([[1, 0.1, 0], [1.5, 1, 2.2], [1, 2.4, 0], [3.3, 2, 2]],
                              np.float32), robot.triangles, "obs-tetra")
    confs = np.zeros((2, 6), np.float32)
    confs[1, 0] = 100.0
    return robot, obstacle, confs


def _mismatched_scale():
    # A unit box on the faces of a 1e4-scale tetrahedron (every plane ratio
    # below TOL: the ratio test flags coplanar).
    confs = np.zeros((8, 6), dtype=np.float32)
    confs[:, 0:3] = np.array([
        [6.0e3, 1.8e4, 1.0e4], [6.0e3 + 0.5, 1.8e4, 1.0e4],
        [2.0e4 - 10.0, 1.9e4, 1.99e4], [0.0, 1.99e4, 5.0],
        [6.0e3, 1.8e4, 1.0e4 - 2.0], [0.0, 5.0e3, 5.0e3],
        [1.0, 5.0e3, 5.0e3], [9.0e5, 9.0e5, 9.0e5]], dtype=np.float32)
    confs[:, 3:6] = np.random.default_rng(3).uniform(-np.pi, np.pi, (8, 3)).astype(np.float32)
    return j_box(extent=(2.0, 2.0, 2.0)), j_tetrahedron(scale=1.0e4), confs


SCENES = {"spheres": _spheres, "tetrahedra": _tetrahedra,
          "mismatched-scale": _mismatched_scale}


@pytest.fixture(scope="module")
def jax_checks():
    """JAX interpret-mode `check` of each scene, both two_phase values."""
    out = {}
    for name, make in SCENES.items():
        robot, obstacle, confs = make()
        ck = jmk.MegaKernelChecker(robot, obstacle, interpret=True)
        for tp in (True, False):
            out[name, tp] = ck.check(confs, two_phase=tp)
    return out


@pytest.fixture(scope="module")
def sphere_checker():
    robot, obstacle, _ = _spheres()
    return mk.MegaKernelChecker(_mesh(robot), _mesh(obstacle), device="cpu")


@pytest.fixture(scope="module")
def alpha_checker():
    return mk.MegaKernelChecker(load_obj(assets.alpha_robot_path()),
                                load_obj(assets.alpha_obstacle_path()), device="cpu")


@pytest.mark.parametrize("two_phase", [True, False])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_check_matches_jax_check(scene, two_phase, jax_checks):
    robot, obstacle, confs = SCENES[scene]()
    ck = mk.MegaKernelChecker(_mesh(robot), _mesh(obstacle), device="cpu")
    valid, cop, pairs, broad = ck.check(confs, two_phase=two_phase)
    j_valid, j_cop, j_pairs, j_broad = jax_checks[scene, two_phase]
    assert valid.dtype == cop.dtype == broad.dtype == bool and pairs.dtype == np.int32
    np.testing.assert_array_equal(valid, j_valid)
    np.testing.assert_array_equal(broad, j_broad)
    # A valid row visits every gated tile in both packages, so its pair count
    # does not depend on visiting order.
    np.testing.assert_array_equal(cop[valid], j_cop[valid])
    np.testing.assert_array_equal(pairs[valid], j_pairs[valid])
    if scene == "tetrahedra":
        np.testing.assert_array_equal(valid, [False, True])
        np.testing.assert_array_equal(broad, [True, False])
    if scene == "mismatched-scale":
        assert cop[valid].any()
    if scene == "spheres":
        assert valid.any() and not valid.all() and (pairs[valid & broad] > 0).any()


class TestCheckAgainstCheckValid:
    """tests/test_megakernel.py::TestCheckValid, with the port's `check`."""

    def test_matches_check_and_oracle_mixed(self, sphere_checker):
        robot, obstacle, confs = _spheres()
        v_stream, c_stream = sphere_checker.check_valid(confs)
        v_check, c_check, _, _ = sphere_checker.check(confs)
        np.testing.assert_array_equal(v_stream, v_check)
        np.testing.assert_array_equal(c_stream, c_check)
        np.testing.assert_array_equal(v_check,
                                      j_oracle.check_configs(robot, obstacle, confs))

    @pytest.mark.parametrize("two_phase", [True, False])
    def test_non_divisible_multi_chunk(self, sphere_checker, two_phase):
        confs = np.random.default_rng(3).uniform(-2.0, 2.0, (19, 6)).astype(np.float32)
        v_stream, c_stream = sphere_checker.check_valid(confs, chunk=8)
        v_check, c_check, _, broad = sphere_checker.check(confs, two_phase=two_phase)
        np.testing.assert_array_equal(v_stream, v_check)
        np.testing.assert_array_equal(c_stream, c_check)
        assert v_check.any() and not v_check.all() and broad.any()

    def test_nonfinite_rows(self, sphere_checker):
        confs = np.zeros((6, 6), np.float32)
        confs[0, 0] = np.nan
        confs[2, 3] = np.inf
        confs[4, 0] = 100.0  # far away -> valid
        v, c, p, b = sphere_checker.check(confs)
        assert not v[0] and not v[2] and v[4]
        assert not c[0] and not c[2] and p[0] == p[2] == 0
        assert b[0] and b[2] and not b[4]  # a non-finite row reports broad
        np.testing.assert_array_equal(v, sphere_checker.check_valid(confs)[0])
        robot, obstacle, _ = _spheres()
        jv, _, _, jb = jmk.MegaKernelChecker(robot, obstacle, interpret=True).check(confs)
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(b, jb)

    def test_all_miss_and_all_hit(self, sphere_checker):
        far = np.zeros((8, 6), np.float32)
        far[:, 0] = 1000.0
        near = np.zeros((8, 6), np.float32)
        near[:, 0] = 1.0  # shells cross at |t| in (0.5, 2.5)
        for tp in (True, False):
            v, c, p, b = sphere_checker.check(np.concatenate([far, near]), two_phase=tp)
            assert v[:8].all() and not v[8:].any()
            assert not b[:8].any() and b[8:].all()
            assert not p[:8].any() and (p[8:] > 0).all()

    def test_empty_batch(self, sphere_checker):
        for tp in (True, False):
            out = sphere_checker.check(np.zeros((0, 6), np.float32), two_phase=tp)
            assert [a.shape for a in out] == [(0,)] * 4
        assert tuple(sphere_checker.check_block(np.zeros((0, 6), np.float32)).shape) == (
            0, mk.OUT_COLS)


def _presort_confs():
    # tests/test_megakernel.py::test_presort_matches_plain: 25 hits, 15 misses.
    rng = np.random.default_rng(3)
    confs = np.zeros((40, 6), np.float32)
    confs[:, 0] = rng.permutation(np.concatenate([rng.uniform(0.0, 2.4, 25),
                                                  rng.uniform(50.0, 90.0, 15)]))
    confs[:, 3:6] = rng.uniform(-np.pi, np.pi, (40, 3))
    return confs


@pytest.mark.parametrize("chunk", [8, 64])
def test_presort_matches_plain(sphere_checker, chunk):
    confs = _presort_confs()
    v0, c0 = sphere_checker.check_valid(confs, chunk=chunk, presort=False)
    v1, c1 = sphere_checker.check_valid(confs, chunk=chunk, presort=True)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(c0, c1)
    assert v0.any() and not v0.all()


def test_presort_matches_jax_presort(sphere_checker):
    robot, obstacle, _ = _spheres()
    confs = _presort_confs()
    jv, jc = jmk.MegaKernelChecker(robot, obstacle, interpret=True).check_valid(
        confs, chunk=8, presort=True)
    v, c = sphere_checker.check_valid(confs, chunk=8, presort=True)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(c[v], jc[jv])


def test_presort_edge_batches(sphere_checker):
    # All misses (no chunk launched), all hits, non-finite rows mixed in.
    far = np.zeros((5, 6), np.float32)
    far[:, 0] = 1000.0
    near = np.zeros((5, 6), np.float32)
    near[:, 0] = 1.0
    for confs in (far, near, np.concatenate([near, far])):
        for chunk in (2, 16):
            np.testing.assert_array_equal(
                sphere_checker.check_valid(confs, chunk=chunk, presort=True)[0],
                sphere_checker.check_valid(confs, chunk=chunk)[0])
    mixed = np.concatenate([near, far])
    mixed[3, 1] = np.nan
    v, c = sphere_checker.check_valid(mixed, chunk=4, presort=True)
    assert not v[3] and not c[3]
    np.testing.assert_array_equal(v, sphere_checker.check_valid(mixed, chunk=4)[0])


@pytest.mark.parametrize("key", ["hard10k", "easy10k"])
def test_broad_block_is_the_twin_broad_column(key, alpha_checker, request):
    confs = request.getfixturevalue(key).confs[:64]
    broad = alpha_checker.broad_block(confs)
    assert broad.dtype == torch.bool and tuple(broad.shape) == (64,)
    rows = mk.check_poses_stats_reference(
        mk.poses_from_confs(torch.from_numpy(confs)), alpha_checker.tables)
    np.testing.assert_array_equal(broad.numpy(), rows[:, 3].numpy().astype(bool))
    if key == "hard10k":
        assert broad.any() and not broad.all()


@pytest.mark.parametrize("key", ["hard10k", "easy10k"])
def test_stats_twin_rows_on_alpha(key, alpha_checker, request):
    ds = request.getfixturevalue(key)
    poses = mk.poses_from_confs(torch.from_numpy(ds.confs[:64]))
    rows = mk.check_poses_stats_reference(poses, alpha_checker.tables).numpy()
    packed = mk.check_poses_reference(poses, alpha_checker.tables).numpy()
    assert rows.dtype == np.int32 and rows.shape == (64, mk.OUT_COLS)
    np.testing.assert_array_equal(rows[:, 0], packed & 1)
    np.testing.assert_array_equal(rows[:, 1], (packed >> 1) & 1)
    np.testing.assert_array_equal(rows[:, 0].astype(bool), ds.valid[:64])
    assert not rows[:, 7].any()
    broad = rows[:, 3] == 1
    assert not rows[~broad][:, [1, 2, 4, 5, 6]].any()  # misses count nothing
    assert (rows[:, 6] <= rows[:, 4]).all()  # a live pair needs a box overlap
    assert (rows[rows[:, 0] == 0, 6] >= 1).all()  # a hit needs a live pair
    if key == "hard10k":
        assert (rows[broad, 4] + rows[broad, 5] > 0).any()


def test_stats_counters_by_hand_on_tetrahedra():
    robot, obstacle, confs = _tetrahedra()
    ck = mk.MegaKernelChecker(_mesh(robot), _mesh(obstacle), device="cpu")
    rows = ck.check_block(confs).numpy()
    # Pairs by hand: triangle boxes at the identity pose (row 0) overlap on
    # closed intervals; row 1 is a broad-phase miss.
    rt = robot.vertices[robot.triangles]
    ot = obstacle.vertices[obstacle.triangles]
    lo_r, hi_r, lo_o, hi_o = rt.min(1), rt.max(1), ot.min(1), ot.max(1)
    overlap = ((lo_r[:, None] <= hi_o[None]) & (lo_o[None] <= hi_r[:, None])).all(-1)
    # One real robot tile (4 triangles padded to 128 = 4 tiles of 32) and one
    # obstacle group: the gate passes for that tile pair only.
    tile_lo, tile_hi = lo_r.min(0), hi_r.max(0)
    gated = int(((tile_lo <= ot.max((0, 1))) & (ot.min((0, 1)) <= tile_hi)).all())
    assert gated == 1
    np.testing.assert_array_equal(rows[1], [1, 0, 0, 0, 0, 0, 0, 0])
    assert rows[0, 0] == 0 and rows[0, 3] == 1
    assert rows[0, 2] == overlap.sum() > 0
    assert rows[0, 4] + rows[0, 5] == gated
    assert rows[0, 4] == 1 and rows[0, 6] == 1


def _jax_coplanar_fixture():
    """tests/test_megakernel.py::TestCoplanarResolution's triangle pair
    (lines 295-300) and one identity-pose row, padded with far rows to the
    JAX kernel's whole program."""
    rt = np.array([[-88.58568, -287.5827, -148.07309], [-105.54053, -122.13013, -65.34459],
                   [9.788717, -353.9158, -98.061005]], dtype=np.float32)
    ot = np.array([[-163.90807, -449.27316, -312.38596], [55.186058, -181.60817, 45.36783],
                   [-9.889383, -480.09338, -190.76962]], dtype=np.float32)
    tris = np.array([[0, 1, 2]], np.int32)
    confs = np.zeros((jmk.CONFS_PER_PROGRAM, 6), np.float32)
    confs[1:, 0] = 1.0e9
    return rt, ot, tris, confs


def test_coplanar_fixture_pinned_against_jax():
    """ROADMAP Queue 3, fault 1: TestCoplanarResolution's fixture at the
    identity pose. The JAX kernel (interpret mode, XLA on the CPU, fused
    multiply-adds) finds the pair live and flags it coplanar, and the float64
    oracle then says it collides. This test holds what rounding does not
    decide: JAX's row, the oracle's verdict and the port's box-overlap count.
    The port's resolved verdict is held to the oracle's by the test below."""
    rt, ot, tris, confs = _jax_coplanar_fixture()
    jck = jmk.MegaKernelChecker(JMesh(rt, tris, "r"), JMesh(ot, tris, "o"), interpret=True)
    jax_row = np.asarray(jck.check_block(jnp.asarray(confs)))[0]
    ck = mk.MegaKernelChecker(Mesh(rt, tris, "r"), Mesh(ot, tris, "o"), device="cpu")
    port_row = ck.check_block(confs[:1]).numpy()[0]
    # (valid, coplanar, num_pairs, nrest)
    assert tuple(jax_row[[0, 1, 2, 6]]) == (1, 1, 1, 1)
    assert not j_oracle.check_configs(JMesh(rt, tris, "r"), JMesh(ot, tris, "o"),
                                      confs[:1])[0]
    assert port_row[2] == jax_row[2] == 1 and port_row[3] == 1 and port_row[4] == 1
    # The JAX kernel's ngate column counts every visited gated tile (its cond
    # operand carries ngate + 1, `megakernel.py:811-814`); the port's counts
    # only gated tile pairs without a box-overlapping pair.
    assert jax_row[5] == 1 and port_row[5] == 0


def test_coplanar_fixture_port_reports_collision():
    """The port, rounding each multiply and add on its own, finds the pair's
    signed distances inside the +-TOL band (not live, coplanar bit 0), but
    within their rounding bounds of straddling it: the pair is uncertain
    (bit 2), so the row goes to the float64 oracle, which says colliding."""
    rt, ot, tris, confs = _jax_coplanar_fixture()
    ck = mk.MegaKernelChecker(Mesh(rt, tris, "r"), Mesh(ot, tris, "o"), device="cpu")
    row = ck.check_block(confs[:1]).numpy()[0]
    assert tuple(row[[0, 1, 2, 6]]) == (1, 0, 1, 0)  # the counter row is unchanged
    assert ck.check_packed(confs[:1])[0] == 0b101
    valid = ck.check_valid_resolved(confs[:1])[0]
    assert not valid, (f"port row (valid, coplanar, num_pairs, nrest) = "
                       f"{tuple(int(v) for v in row[[0, 1, 2, 6]])}; resolved valid {valid}; "
                       f"the float64 oracle says colliding")


class TestProfilingCounters:
    """tests/test_aux.py::TestCounters, against the JAX package's module."""

    def test_from_check_and_report_match_jax(self):
        rng = np.random.default_rng(5)
        valid = rng.random(64) > 0.3
        cop = rng.random(64) > 0.9
        pairs = rng.integers(0, 500, 64).astype(np.int32)
        broad = rng.random(64) > 0.4
        mine = counters.CheckStats.from_check(valid, cop, pairs, broad, 0.25)
        ref = j_counters.CheckStats.from_check(valid, cop, pairs, broad, 0.25)
        assert mine.report() == ref.report()
        assert (mine.checks_per_s, mine.broad_cull_rate) == (ref.checks_per_s,
                                                            ref.broad_cull_rate)
        none = counters.CheckStats.from_check(valid, cop, pairs, np.zeros(64, bool), 0.0)
        assert none.mean_pairs_surviving == 0.0 and none.checks_per_s == 0.0

    def test_verdict_diff_matches_jax(self):
        rng = np.random.default_rng(6)
        pred, gold = rng.random(100) > 0.5, rng.random(100) > 0.5
        assert counters.verdict_diff(pred, gold) == j_counters.verdict_diff(pred, gold)
        d = counters.verdict_diff(np.array([1, 1, 0, 0], bool), np.array([1, 0, 1, 0], bool))
        assert (d["mismatches"], d["false_positives"], d["false_negatives"]) == (2, 1, 1)
        assert d["fp_indices"] == [1] and d["fn_indices"] == [2]


def test_stage_timer_benchmark_and_trace(tmp_path):
    calls = []
    best = benchmark(lambda x: calls.append(x), 7, runs=4, warmup=2)
    assert best >= 0 and calls == [7] * 6
    with trace(str(tmp_path / "tr")) as path:
        with torch.profiler.record_function(timers._MARK):
            torch.ones(8).sum()
    assert (tmp_path / "tr" / "trace.json").exists() and path.endswith("trace.json")
    # On the CPU the trace holds host ops only: the guarded reader finds no
    # device record, no runtime call and nothing lost inside the marked span.
    assert timers._marked_kernels(path, timers.DEVICE_CATS) == ([], 0, 0)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == timers._MARK for e in events)


@pytest.mark.parametrize("spans,want", [
    ([], 0.0), ([(0.0, 2.0)], 2.0), ([(0.0, 2.0), (1.0, 3.0)], 3.0),
    ([(0.0, 4.0), (1.0, 2.0), (5.0, 6.5)], 5.5), ([(1.0, 1.0), (2.0, 3.0)], 1.0)])
def test_busy_us_counts_overlaps_once(spans, want):
    assert busy_us(spans) == want


def _tile_counts_by_hand(prep, poses):
    """Columns 4-6 of the counter rows in numpy, float32 in the twin's
    operation order: gated tile pairs with and without a box-overlapping pair
    (real robot triangle), and tile pairs with a live pair."""
    rb, obs, groups, mesh = (np.asarray(x) for x in (prep.rob_base, prep.obs,
                                                     prep.obs_groups, prep.obs_mesh))
    real = rb[9] > 0
    rows = []
    for p in np.asarray(poses, np.float32):
        c = np.stack([p[4 * k] * rb[3 * cc] + p[4 * k + 1] * rb[3 * cc + 1]
                      + p[4 * k + 2] * rb[3 * cc + 2] + p[4 * k + 3]
                      for cc in range(3) for k in range(3)])  # [9, Tr]
        lo = np.stack([np.minimum(np.minimum(c[k], c[3 + k]), c[6 + k]) for k in range(3)], 1)
        hi = np.stack([np.maximum(np.maximum(c[k], c[3 + k]), c[6 + k]) for k in range(3)], 1)
        lo_r = np.where(real[:, None], lo, np.float32(3e38))
        hi_r = np.where(real[:, None], hi, np.float32(-3e38))
        if not ((lo_r.min(0) <= mesh[3:]).all() and (mesh[:3] <= hi_r.max(0)).all()):
            rows.append((0, 0, 0))
            continue
        t_lo, t_hi = lo_r.reshape(-1, 32, 3).min(1), hi_r.reshape(-1, 32, 3).max(1)
        gate = ((t_lo[:, None] <= groups[None, :, 3:]).all(-1)
                & (groups[None, :, :3] <= t_hi[:, None]).all(-1))
        ri, oi = np.nonzero(((lo[:, None] <= obs[None, :, 16:19]).all(-1)
                             & (obs[None, :, 13:16] <= hi[:, None]).all(-1)) & real[:, None])
        e1, e2 = c[3:6] - c[0:3], c[6:9] - c[3:6]
        n = np.stack([e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
                      e1[0] * e2[1] - e1[1] * e2[0]])
        d = -(n[0] * c[0] + n[1] * c[1] + n[2] * c[2])
        oc = obs[oi]
        dist_o = np.stack([n[0, ri] * oc[:, 3 * k] + n[1, ri] * oc[:, 3 * k + 1]
                           + n[2, ri] * oc[:, 3 * k + 2] + d[ri] for k in range(3)], 1)
        dist_r = np.stack([oc[:, 9] * c[3 * k, ri] + oc[:, 10] * c[3 * k + 1, ri]
                           + oc[:, 11] * c[3 * k + 2, ri] + oc[:, 12] for k in range(3)], 1)
        tol = np.float32(1e-6)

        def straddle(x):
            return (x >= tol).any(1) & (x <= -tol).any(1)

        live = straddle(dist_o) & straddle(dist_r)
        cells = set(zip(ri // 32, oi // 128))
        rows.append((len(cells), int(gate.sum()) - len(cells),
                     len(set(zip(ri[live] // 32, oi[live] // 128)))))
    return np.array(rows, np.int32)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_stats_tile_columns_by_hand(scene):
    robot, obstacle, confs = SCENES[scene]()
    ck = mk.MegaKernelChecker(_mesh(robot), _mesh(obstacle), device="cpu")
    rows = ck.check_block(confs).numpy()
    poses = mk.poses_from_confs(torch.from_numpy(confs)).numpy()
    np.testing.assert_array_equal(rows[:, 4:7], _tile_counts_by_hand(ck.tables, poses))
    assert (rows[:, 6] <= rows[:, 4]).all() and (rows[rows[:, 3] == 1, 4:6].sum(1) > 0).all()


def test_bounds_of_the_check_and_the_probes():
    rob = np.zeros((10, 128), np.float32)
    rob[9, :100] = 1.0
    rows = np.array([[1, 0, 10, 1, 2, 1, 1, 0], [1, 0, 0, 0, 0, 0, 0, 0]])
    n_bytes, n_ops = bounds.check_work(rob, 128, 1, rows)
    assert n_bytes == 2 * 64 + 4 * (rob.size + 20 * 128 + 6 + 6) + 2
    pose = 2 * 100 * bounds.POSE_OPS
    assert n_ops == pose + 4 * 1 * 6 + 10 * (bounds.BOX_OPS + bounds.PLANE_OPS)
    assert bounds.check_work(rob, 128, 1, rows, "nosweep")[1] == pose + 24
    assert bounds.check_work(rob, 128, 1, rows, "maskonly")[1] == pose + 24 + 10 * bounds.BOX_OPS
    assert bounds.bound_ms(3.35e9, 1.0) == (1.0, "bytes")
    assert bounds.bound_ms(1.0, 67e9) == (1.0, "operations")
    assert bounds.probe_work("pose_only", 10) == (10 * 576.0, 0.0)
    assert bounds.probe_work("mini_level3", 1, tr=128)[1] == 128 * bounds.POSE_OPS
    with pytest.raises(ValueError, match="probe piece"):
        bounds.probe_work("all_inputs", 10)
    # K5: the vertex bound rotates each distinct vertex once a row and adds
    # the translation once a row; the corner bound poses every real triangle.
    n_bytes, n_ops = bounds.robot_bounds_work(rob, 2, True, nv=7)
    assert n_bytes == 2 * (64 + 24) + 12 * 7 + 24 + 2
    assert n_ops == 2 * 7 * (bounds.ROTATE_VERTEX_OPS + bounds.BOX_VERTEX_OPS) + 2 * 6 + 2 * 6
    assert bounds.robot_bounds_work(rob, 2, False, nv=0)[1] == 0
    assert bounds.robot_bounds_work(rob, 2, True)[1] == pose + 2 * 6


def test_bounds_of_the_grid():
    # K4: 36 bytes a triangle read, 4 a node written; per pair its
    # distance's region and the ray test's stages it reaches, per node the
    # sqrt and the sign.
    assert bounds.grid_work(10, 3, False) == (3 * 36 + 40.0, 30 * 21 + 10.0)
    assert bounds.grid_work(10, 3, True)[1] == 30 * (21 + 1 + 7) + 20
    regions = [5, 0, 0, 0, 0, 0, 25]
    ray = [24, 10, 4]  # 6 pairs of a flat triangle stop at the flat test
    n_ops = 5 * bounds.REGION_OPS[0] + 25 * bounds.REGION_OPS[6]
    assert bounds.grid_work(10, 3, False, regions)[1] == n_ops + 10
    assert bounds.grid_work(10, 3, True, regions, ray)[1] == (
        n_ops + 30 * bounds.RAY_FLAT_OPS + 24 * 7 + 10 * 18 + 4 * 8 + 20)
    assert bounds.RAY_STAGE_OPS == (7, 18, 8) and min(bounds.REGION_OPS) == 21
    # The alpha obstacle's 96^3 grid: bytes are not what bounds it.
    assert bounds.bound_ms(*bounds.grid_work(96 ** 3, 1008, True))[1] == "operations"


@pytest.mark.parametrize("launched,kernels,lost", [
    ((1, 2, 3), (1, 2, 3, 7), 0), ((1, 2, 3), (1, 3), 1), ((1, 2, 3), (), 3),
    ((2, 3), (1, 2, 3), 1)])
def test_kernel_trace_counts_lost_kernels(tmp_path, launched, kernels, lost):
    # `kernel_ms` sums the kernels inside its marked span (7, a primer before
    # it, is not counted) only if launches and kernel records there match by
    # correlation id: a lost kernel record or a lost launch record shows.
    events = [{"cat": "user_annotation", "name": timers._MARK, "ts": 5.0, "dur": 40.0}]
    events += [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10.0 * c, "dur": 1.0,
                "args": {"correlation": c}} for c in launched]
    events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1.0, "dur": 1.0,
                   "args": {"correlation": 7}})
    events.append({"cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 36.0,
                   "dur": 1.0, "args": {"correlation": 9}})
    events += [{"cat": "kernel", "name": "k", "ts": 10.0 * c + 2 if c != 7 else 2.0,
                "dur": 4.0, "args": {"correlation": c}} for c in kernels]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    spans, got_launched, got_lost = timers._marked_kernels(str(path))
    assert got_launched == len(launched) and got_lost == lost
    assert spans == [(10.0 * c + 2, 10.0 * c + 6) for c in kernels if c in launched]


def test_kernel_trace_ignores_kernels_launched_before_its_span(tmp_path):
    # A kernel launched before the marked span (a primer) whose record lands
    # inside it on the trace's clock is not counted and is not lost; a
    # measured kernel whose record lands just before the span still is.
    events = [{"cat": "user_annotation", "name": timers._MARK, "ts": 5.0, "dur": 40.0}]
    events += [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1.0,
                "args": {"correlation": c}} for c, ts in ((7, 1.0), (1, 6.0), (2, 20.0))]
    events += [{"cat": "kernel", "name": "k", "ts": ts, "dur": 4.0, "args": {"correlation": c}}
               for c, ts in ((7, 6.0), (1, 4.5), (2, 22.0))]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert timers._marked_kernels(str(path)) == ([(4.5, 8.5), (22.0, 26.0)], 2, 0)


@pytest.mark.parametrize("cats,drop_copy,stray_fill,lost", [
    (timers.DEVICE_CATS, False, False, 0), (timers.DEVICE_CATS, True, False, 1),
    (timers.DEVICE_CATS, False, True, 1), (("kernel",), True, True, 0)])
def test_device_trace_matches_copies_and_fills(tmp_path, cats, drop_copy, stray_fill, lost):
    # `device_busy` holds copies and fills to the kernels' rule: each call in
    # the marked span has its record, each record there its call.
    events = [{"cat": "user_annotation", "name": timers._MARK, "ts": 5.0, "dur": 40.0}]
    for c, call, cat, ts in ((1, "cudaLaunchKernel", "kernel", 10.0),
                             (2, "cudaMemcpyAsync", "gpu_memcpy", 20.0),
                             (3, "cudaMemsetAsync", "gpu_memset", 30.0)):
        events.append({"cat": "cuda_runtime", "name": call, "ts": ts, "dur": 1.0,
                       "args": {"correlation": c}})
        if not (drop_copy and cat == "gpu_memcpy"):
            events.append({"cat": cat, "name": "r", "ts": ts + 2, "dur": 3.0,
                           "args": {"correlation": c}})
    if stray_fill:
        events.append({"cat": "gpu_memset", "name": "r", "ts": 40.0, "dur": 1.0,
                       "args": {"correlation": 8}})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    spans, calls, got_lost = timers._marked_kernels(str(path), cats)
    assert got_lost == lost and calls == len(cats)
    want = [(12.0, 15.0), (22.0, 25.0), (32.0, 35.0)]
    assert spans == [w for w, cat in zip(want, timers.DEVICE_CATS)
                     if cat in cats and not (drop_copy and cat == "gpu_memcpy")]
