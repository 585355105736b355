"""The port's fused check (`robocheck_tpu_torch.kernels.megakernel`) against
the JAX package's Pallas kernel, run in interpret mode as
tests/test_megakernel.py runs it.

On the CPU the checker runs the kernel's PyTorch twin; the CUDA kernel is
held against that twin on the card by `chip_smoke.py`. The two packages are
compared on identical tables (`prep_from_arrays`) and, where the kernel is
compared, on the JAX pose rows: `valid` must be equal, and `coplanar` equal
where valid (a colliding configuration's coplanar bit depends on the order in
which the kernel visits tiles).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robocheck_tpu.kernels import megakernel as jmk
from robocheck_tpu.models.shapes import box as j_box
from robocheck_tpu.models.shapes import icosphere as j_icosphere
from robocheck_tpu.models.shapes import tetrahedron as j_tetrahedron
from robocheck_tpu.oracle import cpu_oracle as j_oracle
from robocheck_tpu_torch.core.types import Mesh
from robocheck_tpu_torch.io import assets
from robocheck_tpu_torch.io.datagen import near_coplanar_pairs as _near_coplanar_pairs
from robocheck_tpu_torch.io.datagen import touching_interval_pairs as _touching_interval_pairs
from robocheck_tpu_torch.io.obj import load_obj
from robocheck_tpu_torch.kernels import megakernel as mk
from robocheck_tpu_torch.oracle import check_configs


def _mesh(m):
    """A JAX-package Mesh as this package's Mesh (same arrays)."""
    return Mesh(m.vertices, m.triangles, m.name)


def _sphere_scene():
    robot = j_icosphere(1, radius=1.0, name="robot")  # 80 triangles
    obstacle = j_icosphere(1, radius=1.5, name="obstacle")
    rng = np.random.default_rng(77)
    confs = np.zeros((16, 6), dtype=np.float32)
    # Deep overlap, shell-crossing, near-miss and far-away rows.
    confs[:, 0] = np.concatenate([
        rng.uniform(0.0, 0.4, 4), rng.uniform(0.4, 2.6, 6),
        rng.uniform(2.6, 2.7, 2), rng.uniform(5.0, 50.0, 4)]).astype(np.float32)
    confs[:, 3:6] = rng.uniform(-np.pi, np.pi, (16, 3)).astype(np.float32)
    return robot, obstacle, confs


def _tetra_scene():
    # Interlocking tetrahedra collide at the identity and clear at +100x
    # (`test-narrow-phase.cu:628-686`).
    robot = j_tetrahedron()
    obstacle = type(robot)(np.array([[1, 0.1, 0], [1.5, 1, 2.2], [1, 2.4, 0],
                                     [3.3, 2, 2]], np.float32), robot.triangles,
                           "obs-tetra")
    confs = np.zeros((2, 6), np.float32)
    confs[1, 0] = 100.0
    return robot, obstacle, confs


def _mismatched_scale_scene():
    # A unit box on the faces of a 1e4-scale tetrahedron: every plane ratio is
    # below TOL, so the ratio test flags coplanar (tests/test_megakernel.py::
    # test_mismatched_scale_coplanar_precheck).
    robot = j_box(extent=(2.0, 2.0, 2.0))
    obstacle = j_tetrahedron(scale=1.0e4)
    confs = np.zeros((8, 6), dtype=np.float32)
    confs[:, 0:3] = np.array([
        [6.0e3, 1.8e4, 1.0e4], [6.0e3 + 0.5, 1.8e4, 1.0e4],
        [2.0e4 - 10.0, 1.9e4, 1.99e4], [0.0, 1.99e4, 5.0],
        [6.0e3, 1.8e4, 1.0e4 - 2.0], [0.0, 5.0e3, 5.0e3],
        [1.0, 5.0e3, 5.0e3], [9.0e5, 9.0e5, 9.0e5]], dtype=np.float32)
    confs[:, 3:6] = np.random.default_rng(3).uniform(
        -np.pi, np.pi, (8, 3)).astype(np.float32)
    return robot, obstacle, confs


@pytest.fixture(scope="module")
def port_alpha():
    return (load_obj(assets.alpha_robot_path()),
            load_obj(assets.alpha_obstacle_path()))


@pytest.fixture(scope="module")
def cpu_checker(port_alpha):
    return mk.MegaKernelChecker(*port_alpha, device="cpu")


@pytest.fixture(scope="module")
def sphere_checker():
    robot, obstacle, _ = _sphere_scene()
    return mk.MegaKernelChecker(_mesh(robot), _mesh(obstacle), device="cpu")


def _assert_tables_equal(a: mk.MegaKernelPrep, b: mk.MegaKernelPrep):
    for name in ("rob_base", "obs", "obs_mesh", "obs_groups"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype == np.float32, name
        assert x.shape == y.shape, name
        # Bitwise, +-inf padding and signed zeros included.
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32), name)


@pytest.mark.parametrize("scene", ["alpha", "icospheres", "icospheres-no-morton"])
def test_prep_build_bit_identical_to_jax(scene, alpha_meshes):
    if scene == "alpha":
        robot, obstacle = alpha_meshes
    else:
        robot, obstacle = j_icosphere(2, 1.0), j_icosphere(1, 1.5)
    morton = scene != "icospheres-no-morton"
    ref = jmk.MegaKernelPrep.build(robot, obstacle, morton=morton)
    mine = mk.MegaKernelPrep.build(_mesh(robot), _mesh(obstacle), morton=morton)
    _assert_tables_equal(mine, mk.prep_from_arrays(
        ref.rob_base, ref.obs_t, ref.obs_mesh_aabb, ref.obs_group_aabbs))
    assert mine.obs.shape[0] // mk.GROUP == ref.num_obs_tiles


def test_prep_layout(port_alpha):
    prep = mk.MegaKernelPrep.build(*port_alpha)
    assert prep.rob_base.shape == (10, 1024) and prep.obs.shape == (1024, 20)
    assert prep.rob_base[9, :1008].all() and not prep.rob_base[9, 1008:].any()
    assert not prep.rob_base[:9, 1008:].any()  # padding corners are zeros
    assert np.all(prep.obs[1008:, 13:16] == np.inf)
    assert np.all(prep.obs[1008:, 16:19] == -np.inf)
    assert prep.obs_groups.shape == (8, 6)
    dev = prep.to("cpu")
    assert all(isinstance(t, torch.Tensor) and t.is_contiguous()
               for t in (dev.rob_base, dev.obs, dev.obs_mesh, dev.obs_groups))


def _jax_scene_verdicts(robot, obstacle, confs):
    """JAX interpret-mode kernel verdicts and the JAX pose rows it used."""
    ck = jmk.MegaKernelChecker(robot, obstacle, interpret=True)
    valid, cop = ck.check_valid(confs, chunk=64)
    poses = np.array(jax.jit(jmk.poses_from_confs)(jnp.asarray(confs)))
    return ck.prep, poses, valid, cop


@pytest.mark.parametrize("scene", ["spheres", "tetrahedra", "mismatched-scale",
                                   "hard10k[:64]"])
def test_twin_matches_interpret_kernel(scene, alpha_meshes, hard10k):
    if scene == "hard10k[:64]":
        (robot, obstacle), confs = alpha_meshes, hard10k.confs[:64]
    else:
        robot, obstacle, confs = {"spheres": _sphere_scene,
                                  "tetrahedra": _tetra_scene,
                                  "mismatched-scale": _mismatched_scale_scene}[scene]()
    jprep, poses, valid, cop = _jax_scene_verdicts(robot, obstacle, confs)
    prep = mk.prep_from_arrays(jprep.rob_base, jprep.obs_t, jprep.obs_mesh_aabb,
                               jprep.obs_group_aabbs).to("cpu")
    packed = mk.check_poses_reference(torch.from_numpy(poses), prep).numpy()
    assert packed.dtype == np.uint8 and packed.shape == (len(confs),)
    t_valid, t_cop = (packed & 1).astype(bool), ((packed >> 1) & 1).astype(bool)
    np.testing.assert_array_equal(t_valid, valid)
    np.testing.assert_array_equal(t_cop[valid], cop[valid])
    if scene == "tetrahedra":
        np.testing.assert_array_equal(t_valid, [False, True])
    if scene == "mismatched-scale":
        assert t_cop[t_valid].any()  # the fixture reaches the coplanar flag
    if scene == "hard10k[:64]":
        np.testing.assert_array_equal(t_valid, hard10k.valid[:64])


@pytest.mark.parametrize("key", ["hard10k", "easy10k"])
def test_check_valid_resolved_matches_tags(key, cpu_checker, request):
    ds = request.getfixturevalue(key)
    valid = cpu_checker.check_valid_resolved(ds.confs[:512])
    assert valid.dtype == bool
    np.testing.assert_array_equal(valid, ds.valid[:512])


def test_checker_matches_jax_checker_on_spheres(sphere_checker):
    robot, obstacle, confs = _sphere_scene()
    v, c = sphere_checker.check_valid(confs)
    jv, jc = jmk.MegaKernelChecker(robot, obstacle, interpret=True).check_valid(confs)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(c[v], jc[jv])
    np.testing.assert_array_equal(v, j_oracle.check_configs(robot, obstacle, confs))


class TestCheckValid:
    """Chunking, non-finite rows and chunk-uniform batches
    (tests/test_megakernel.py::TestCheckValid)."""

    def test_non_divisible_multi_chunk(self, sphere_checker):
        confs = np.random.default_rng(3).uniform(-2.0, 2.0, (19, 6)).astype(np.float32)
        v8, c8 = sphere_checker.check_valid(confs, chunk=8)
        v, c = sphere_checker.check_valid(confs)
        np.testing.assert_array_equal(v8, v)
        np.testing.assert_array_equal(c8, c)
        robot, obstacle, _ = _sphere_scene()
        np.testing.assert_array_equal(v8, j_oracle.check_configs(robot, obstacle, confs))
        assert v8.any() and not v8.all()

    def test_nonfinite_rows(self, sphere_checker):
        confs = np.zeros((6, 6), np.float32)
        confs[0, 0] = np.nan
        confs[2, 3] = np.inf
        confs[4, 0] = 100.0  # far away -> valid
        v, c = sphere_checker.check_valid(confs, chunk=8)
        assert not v[0] and not v[2]  # non-finite poses are never valid
        assert v[4]
        assert not c[0] and not c[2]
        robot, obstacle, _ = _sphere_scene()
        jv, _ = jmk.MegaKernelChecker(robot, obstacle, interpret=True).check_valid(confs)
        np.testing.assert_array_equal(v, jv)

    def test_all_miss_and_all_hit_chunks(self, sphere_checker):
        far = np.zeros((8, 6), np.float32)
        far[:, 0] = 1000.0
        near = np.zeros((8, 6), np.float32)
        near[:, 0] = 1.0  # shells cross at |t| in (0.5, 2.5)
        v, c = sphere_checker.check_valid(np.concatenate([far, near]), chunk=8)
        assert v[:8].all() and not v[8:].any()
        assert not c[:8].any()

    def test_empty_batch(self, sphere_checker):
        v, c = sphere_checker.check_valid(np.zeros((0, 6), np.float32))
        assert v.shape == c.shape == (0,)


class TestCoplanarResolution:
    """Face-on-face contact that float32 flags coplanar and float64 resolves
    as colliding (tests/test_megakernel.py::TestCoplanarResolution). The
    fixture, two triangles in one tilted plane at ~300-unit coordinates, was
    found by search under this package's arithmetic, which rounds each
    multiply and add on its own. The JAX test's fixture is not flagged here:
    its signed distances are rounding noise (|n.c| ~ 1e7, where a float32
    ulp is 1) that XLA on the CPU computes with fused multiply-adds."""

    RT = np.array([[-172.35173, 118.57849, -337.86478],
                   [-168.62619, 71.0307, -215.03616],
                   [-280.98154, 165.06941, -53.021297]], dtype=np.float32)
    OT = np.array([[-148.91972, 43.489243, -211.57489],
                   [-222.59364, 145.73175, -222.42876],
                   [-204.12267, 60.86192, -48.782146]], dtype=np.float32)

    def _checker(self):
        tris = np.array([[0, 1, 2]], np.int32)
        return mk.MegaKernelChecker(Mesh(self.RT, tris, "r"), Mesh(self.OT, tris, "o"),
                                    device="cpu")

    def test_flagged_then_resolved_colliding(self):
        ck = self._checker()
        confs = np.zeros((1, 6), np.float32)
        valid, cop = ck.check_valid(confs)
        assert valid[0] and cop[0], "fixture must be flagged-but-unresolved"
        assert not ck.check_valid_resolved(confs)[0], "exact geometry collides"
        assert not check_configs(ck.robot, ck.obstacle, confs)[0]

    def test_far_rows_not_flagged(self):
        ck = self._checker()
        confs = np.zeros((4, 6), np.float32)
        confs[:, 0] = 1e5
        valid, cop = ck.check_valid(confs)
        assert valid.all() and not cop.any()
        assert ck.check_valid_resolved(confs).all()


def test_mismatched_scale_resolved_matches_oracle():
    robot, obstacle, confs = _mismatched_scale_scene()
    ck = mk.MegaKernelChecker(_mesh(robot), _mesh(obstacle), device="cpu")
    _, cop = ck.check_valid(confs)
    assert cop.any()
    np.testing.assert_array_equal(ck.check_valid_resolved(confs),
                                  j_oracle.check_configs(robot, obstacle, confs))


def test_morton_off_same_verdicts(sphere_checker):
    robot, obstacle, confs = _sphere_scene()
    plain = mk.MegaKernelChecker(_mesh(robot), _mesh(obstacle), device="cpu",
                                 morton=False)
    np.testing.assert_array_equal(plain.check_valid(confs)[0],
                                  sphere_checker.check_valid(confs)[0])


def test_cuda_device_raises_without_a_card(port_alpha):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card error")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mk.MegaKernelChecker(*port_alpha, device="cuda")


def test_unsupported_device_raises(port_alpha):
    with pytest.raises(ValueError, match="unsupported device"):
        mk.MegaKernelChecker(*port_alpha, device="meta")


def test_cuda_wrapper_refuses_cpu_tensors(cpu_checker):
    poses = mk.poses_from_confs(torch.zeros((4, 6)))
    launches = mk.check_poses_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        mk.check_poses_cuda(poses, cpu_checker.tables)
    assert mk.check_poses_cuda.launches == launches
    # A CPU checker runs the twin and never reaches the kernel's wrapper.
    valid, _ = cpu_checker.check_valid(np.zeros((4, 6), np.float32))
    assert valid.shape == (4,)
    assert mk.check_poses_cuda.launches == launches


def test_twin_broad_miss_and_padding_rows(cpu_checker):
    # Far rows end at the mesh-box broad phase (byte 1); a row posed at the
    # origin of the obstacle's frame must not collide through the zero
    # corners of the robot table's padding triangles.
    confs = np.zeros((3, 6), np.float32)
    confs[0, 0] = 1.0e9
    confs[1, 0] = -1.0e9
    poses = mk.poses_from_confs(torch.from_numpy(confs))
    out = mk.check_poses_reference(poses, cpu_checker.tables).numpy()
    assert out[0] == 1 and out[1] == 1
    real_only = mk.MegaKernelPrep(
        cpu_checker.tables.rob_base[:, :1008], cpu_checker.tables.obs,
        cpu_checker.tables.obs_mesh, cpu_checker.tables.obs_groups)
    assert out[2] == mk.check_poses_reference(poses, real_only).numpy()[2]


@pytest.mark.slow
@pytest.mark.parametrize("key", ["hard10k", "easy10k", "samples10k"])
def test_full_dataset_golden(key, cpu_checker, request):
    ds = request.getfixturevalue(key)
    valid = cpu_checker.check_valid_resolved(ds.confs)
    if key == "samples10k":
        assert int(valid.sum()) == ds.header_valid == 7296
    else:
        np.testing.assert_array_equal(valid, ds.valid)


def _straddles64(d, tol):
    return (d >= tol).any() and (d <= -tol).any()


def test_near_coplanar_contacts_set_bit2():
    """Bit 2 wherever the float64 evaluation of the port's own float32
    inputs (posed corners and planes) calls a pair live and the port does not
    (its counter row's nrest is 0): then the row goes to the float64 oracle."""
    tol = float(np.float32(1e-6))
    one = np.array([[0, 1, 2]], np.int32)
    zero = torch.zeros((1, 16))
    zero[0, [0, 5, 10]] = 1.0  # the identity pose row: posing is exact
    n_tie = 0
    for r, o in _near_coplanar_pairs(np.random.default_rng(2024)):
        prep = mk.MegaKernelPrep.build(Mesh(r, one), Mesh(o, one)).to("cpu")
        packed = int(mk.check_poses_reference(zero, prep)[0])
        port_live = int(mk.check_poses_stats_reference(zero, prep)[0, 6]) == 1
        rc = prep.rob_base[:9, 0].numpy().reshape(3, 3)  # posed corners, exact
        e1, e2 = rc[1] - rc[0], rc[2] - rc[1]  # the twin's float32 plane
        rn = np.array([e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
                       e1[0] * e2[1] - e1[1] * e2[0]], np.float32)
        rd = -(rn[0] * rc[0, 0] + rn[1] * rc[0, 1] + rn[2] * rc[0, 2])
        ob = prep.obs[0].numpy().astype(np.float64)
        oc, on, od = ob[:9].reshape(3, 3), ob[9:12], ob[12]
        live64 = (_straddles64(oc @ rn.astype(np.float64) + np.float64(rd), tol)
                  and _straddles64(rc.astype(np.float64) @ on + od, tol))
        if live64 and not port_live:
            n_tie += 1
            assert packed & 4, f"pair not flagged uncertain: byte {packed}"
        if not packed & 1:
            assert port_live  # a hit needs a live pair
    assert n_tie >= 5  # the fixture reaches the rounding-decided case


def _interval64(p, d):
    """The kernel's canonical permutation and interval ends, in float64."""
    c01, c02 = d[0] * d[1] > 0, d[0] * d[2] > 0
    order = (0, 2, 1) if c01 else (0, 1, 2) if c02 else (1, 0, 2)
    q, e = p[list(order)], d[list(order)]

    def end(i, j):
        dd = e[i] - e[j]
        return q[i] + (q[j] - q[i]) * (e[i] / (dd if dd != 0 else 1.0))

    return sorted((end(0, 1), end(1, 2)))


def test_near_touching_intervals_set_bit2():
    """Bit 2 wherever a float64 evaluation of the interval test on the
    port's own float32 inputs (posed corners and planes) disagrees with the
    port's float32 verdict (the counter row, which counts a tie as the hit or
    miss it computes); and a flagged tie is never a hit."""
    one = np.array([[0, 1, 2]], np.int32)
    zero = torch.zeros((1, 16))
    zero[0, [0, 5, 10]] = 1.0  # the identity pose row: posing is exact
    n_differ = n_flagged = 0
    for r, o in _touching_interval_pairs(np.random.default_rng(2025)):
        prep = mk.MegaKernelPrep.build(Mesh(r, one), Mesh(o, one)).to("cpu")
        packed = int(mk.check_poses_reference(zero, prep)[0])
        row = mk.check_poses_stats_reference(zero, prep)[0].numpy()
        assert row[6] == 1 and row[1] == 0  # live, not coplanar: an interval test
        rc = prep.rob_base[:9, 0].numpy().reshape(3, 3)
        e1, e2 = rc[1] - rc[0], rc[2] - rc[1]  # the twin's float32 plane
        rn = np.array([e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
                       e1[0] * e2[1] - e1[1] * e2[0]], np.float32)
        rd = -(rn[0] * rc[0, 0] + rn[1] * rc[0, 1] + rn[2] * rc[0, 2])
        ob = prep.obs[0].numpy().astype(np.float64)
        oc, on, od = ob[:9].reshape(3, 3), ob[9:12], ob[12]
        rn64, rc64 = rn.astype(np.float64), rc.astype(np.float64)
        D = np.cross(rn64, on)
        lo_r, hi_r = _interval64(rc64 @ D, rc64 @ on + od)
        lo_o, hi_o = _interval64(oc @ D, oc @ rn64 + np.float64(rd))
        hit64 = not (lo_r >= hi_o or lo_o >= hi_r)
        if hit64 != (row[0] == 0):
            n_differ += 1
            assert packed & 4, f"tie not flagged uncertain: byte {packed}"
        if packed & 4:
            n_flagged += 1
            assert packed & 1  # a tie is not a hit
    assert n_differ >= 5  # the fixture reaches the rounding-decided case
    assert n_flagged < 128  # and the bound does not flag every pair


def test_far_and_separated_rows_never_set_bit2(cpu_checker, hard10k):
    far = hard10k.confs[:64].copy()
    far[:, 0] += 1.0e4
    assert (cpu_checker.check_packed(far) == 1).all()
    # Parallel triangles 1% of their size apart: boxes overlap, planes are
    # separated by far more than the rounding bound.
    rng = np.random.default_rng(7)
    one = np.array([[0, 1, 2]], np.int32)
    for _ in range(32):
        r = rng.normal(scale=50.0, size=(3, 3)).astype(np.float32)
        normal = np.cross(r[1] - r[0], r[2] - r[1])
        o = (r + 0.01 * 50.0 * normal / np.linalg.norm(normal)).astype(np.float32)
        ck = mk.MegaKernelChecker(Mesh(r, one), Mesh(o, one), device="cpu")
        rows = ck.check_block(np.zeros((1, 6), np.float32)).numpy()
        assert rows[0, 2] == 1  # the boxes overlap
        assert ck.check_packed(np.zeros((1, 6), np.float32))[0] == 1


def test_check_packed_bits_and_nonfinite_rows(sphere_checker):
    _, _, confs = _sphere_scene()
    confs = confs.copy()
    confs[3, 1] = np.nan
    packed = sphere_checker.check_packed(confs)
    assert packed.dtype == np.uint8 and packed[3] == 0
    valid, cop = sphere_checker.check_valid(confs)
    np.testing.assert_array_equal(valid, (packed & 1).astype(bool))
    np.testing.assert_array_equal(cop, ((packed >> 1) & 1).astype(bool))
    assert not (packed >> 3).any()


def _recorded_launches(monkeypatch) -> list:
    """Stub ``megakernel.check_poses`` with a recorder that answers every
    row with the byte 1; returns the list of each call's row count."""
    calls = []

    def record(poses, prep, nonfinite=None):
        calls.append(poses.shape[0])
        return torch.ones((poses.shape[0],), dtype=torch.uint8, device=poses.device)

    monkeypatch.setattr(mk, "check_poses", record)
    return calls


def _launch_rows(n: int, step: int) -> list:
    return [min(step, n - lo) for lo in range(0, n, step)]


def _sphere_rows(n: int) -> np.ndarray:
    """``n`` sphere-scene rows from overlap to far away (seed 24)."""
    rng = np.random.default_rng(24)
    confs = np.zeros((n, 6), np.float32)
    confs[:, 0] = rng.uniform(0.0, 6.0, n)
    confs[:, 3:6] = rng.uniform(-np.pi, np.pi, (n, 3))
    return confs


@pytest.mark.parametrize("chunk", [None, 16384, 7000, 40000, 1 << 20])
def test_check_packed_launches_k1_once_unless_a_chunk_is_given(monkeypatch, sphere_checker,
                                                               chunk):
    """40,000 rows are one K1 call over all of them; ``chunk=k`` makes
    ceil(N / k) calls of k rows, the last one short."""
    confs = _sphere_rows(40_000)
    calls = _recorded_launches(monkeypatch)
    assert (sphere_checker.check_packed(confs, chunk=chunk) == 1).all()
    assert calls == _launch_rows(len(confs), chunk or len(confs))


@pytest.mark.parametrize("chunk", [None, 1000])
def test_presort_launches_k1_on_the_hits_alone(monkeypatch, sphere_checker, chunk):
    """``presort=True`` makes one K1 call over the broad-phase hits (or
    ceil(hits / k) with ``chunk=k``) and answers the misses with the byte 1."""
    confs = _sphere_rows(40_000)
    confs[5, 2] = np.nan  # a non-finite row counts as a hit
    hits = int(sphere_checker.broad_block(confs).sum()) + 1
    assert 1000 < hits < len(confs) - 1000
    calls = _recorded_launches(monkeypatch)
    assert (sphere_checker.check_packed(confs, chunk=chunk, presort=True) == 1).all()
    assert calls == _launch_rows(hits, chunk or hits)


def test_one_launch_and_chunks_give_equal_bytes(cpu_checker, hard10k):
    """On the twin, 320 alpha rows (one non-finite, at a boundary of the
    chunks) give the same bytes in one launch as in launches of 64 rows,
    and count the non-finite row once each."""
    confs = hard10k.confs[:320].copy()
    confs[64, 4] = np.inf
    before = cpu_checker.counters()["nonfinite_rows"]
    one = cpu_checker.check_packed(confs)
    split = cpu_checker.check_packed(confs, chunk=64)
    np.testing.assert_array_equal(one, split)
    assert one[64] == 0 and 0 < (one & 1).sum() < len(confs) - 1
    assert cpu_checker.counters()["nonfinite_rows"] == before + 2


@pytest.mark.parametrize("twin", ["check_poses_reference", "check_poses_stats_reference"])
def test_twins_pose_their_rows_in_blocks(monkeypatch, cpu_checker, hard10k, twin):
    """A twin poses and tests ``TWIN_ROWS`` rows at a time, so that its
    memory does not grow with the batch: 100 alpha rows (one non-finite, in
    the second block) posed in blocks of 40 give the rows of one block,
    count the non-finite row once each, and ``check_packed`` of the batch
    gives the bytes of ``chunk=40``."""
    confs = hard10k.confs[:100].copy()
    confs[60, 2] = np.nan
    poses = mk.poses_from_confs(torch.from_numpy(confs))
    fn, count = getattr(mk, twin), torch.zeros((), dtype=torch.int64)
    whole = fn(poses, cpu_checker.tables, count)
    posed, seen = mk._posed_robot, []
    monkeypatch.setattr(mk, "_posed_robot", lambda p, base: seen.append(len(p)) or posed(p, base))
    monkeypatch.setattr(mk, "TWIN_ROWS", 40)
    blocks = fn(poses, cpu_checker.tables, count)
    assert seen == [40, 40, 20]
    assert torch.equal(whole, blocks) and int(count) == 2
    if twin == "check_poses_reference":
        assert 0 < (whole & 1).sum() < len(confs) - 1
        np.testing.assert_array_equal(cpu_checker.check_packed(confs), whole.numpy())
        np.testing.assert_array_equal(cpu_checker.check_packed(confs, chunk=40), whole.numpy())


# Rows of a 19-row batch checked in chunks of 8 that get a non-finite value:
# the first and last rows of chunks, and both sides of each chunk boundary.
_PLANTED = [0, 7, 8, 15, 16, 18]


def _nonfinite_batch(value, column):
    """The sphere scene's 16 rows and 3 more, with ``value`` planted in
    ``column`` of the _PLANTED rows (every row for column None)."""
    _, _, confs = _sphere_scene()
    confs = np.concatenate([confs, confs[:3] + np.float32(0.05)])
    bad = np.zeros(len(confs), bool)
    bad[_PLANTED if column is not None else slice(None)] = True
    confs[bad, column if column is not None else 0] = value
    return confs, bad


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf], ids=["nan", "+inf", "-inf"])
@pytest.mark.parametrize("column", [0, 1, 2, 3, 4, 5, None],
                         ids=["x", "y", "z", "rx", "ry", "rz", "all-rows"])
def test_kernel_answers_nonfinite_rows(sphere_checker, value, column):
    confs, bad = _nonfinite_batch(value, column)
    before = sphere_checker.counters()["nonfinite_rows"]
    packed = sphere_checker.check_packed(confs, chunk=8)
    assert sphere_checker.counters()["nonfinite_rows"] == before + bad.sum()
    assert not packed[bad].any()
    if (~bad).any():
        # The finite rows' bytes are those of the finite rows checked alone.
        alone = sphere_checker.check_packed(confs[~bad], chunk=8)
        np.testing.assert_array_equal(packed[~bad], alone)
        assert (alone & 1).any() and not (alone & 1).all()
    before = sphere_checker.counters()["nonfinite_rows"]
    np.testing.assert_array_equal(sphere_checker.check_packed(confs, chunk=8, presort=True),
                                  packed)
    assert sphere_checker.counters()["nonfinite_rows"] == before + bad.sum()
    # The counter instance's twin: all-zero rows, counted alike.
    before = sphere_checker.counters()["nonfinite_rows"]
    rows = sphere_checker.check_block(confs).numpy()
    assert sphere_checker.counters()["nonfinite_rows"] == before + bad.sum()
    assert not rows[bad].any()
    np.testing.assert_array_equal(rows[~bad][:, 0], packed[~bad] & 1)


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf, 3.4e38, -3.4e38, 1e-45, 0.0],
                         ids=["nan", "+inf", "-inf", "+3.4e38", "-3.4e38", "denormal", "zero"])
def test_pose_row_nonfinite_exactly_when_the_configuration_is(value):
    rng = np.random.default_rng(19)
    confs = rng.uniform(-np.pi, np.pi, (6, 6)).astype(np.float32)
    confs[np.arange(6), np.arange(6)] = value  # the value in every column, a row each
    poses = mk.poses_from_confs_reference(torch.from_numpy(confs)).numpy()
    np.testing.assert_array_equal(np.isfinite(poses[:, :12]).all(1),
                                  np.isfinite(confs).all(1))
    assert not poses[:, 12:].any()


def test_megakernel_cu_entries_take_what_the_bindings_pass():
    # Each entry bound by `_build._bind_megakernel` is declared in
    # `csrc/megakernel.cu` with as many parameters as its argtypes, the
    # non-finite row counter right after the row counter.
    import re
    import types

    from robocheck_tpu_torch.kernels import _build

    src = _build.SOURCES["megakernel"].read_text()
    extern = src[src.index('extern "C" {'):]
    found = re.findall(r"\n(?:int|int64_t|const char\*) (rc_\w+)\(([^)]*)\)", extern)
    declared = {name: [a.split()[-1].lstrip("*") for a in args.split(",") if a.strip()]
                for name, args in found}
    lib = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in declared})
    _build._bind_megakernel(lib)
    assert lib.takes_work and lib.takes_nonfinite
    for name in declared:
        if hasattr(getattr(lib, name), "argtypes"):
            assert len(getattr(lib, name).argtypes) == len(declared[name]), name
    for entry in ("rc_megakernel_check", "rc_megakernel_check_stats",
                  "rc_megakernel_check_stage"):
        params = declared[entry]
        assert params[params.index("work") + 1] == "nonfinite", entry


def test_resolve_cu_entries_take_what_the_bindings_pass():
    # Each entry bound by `_build._bind_resolve` is declared in
    # `csrc/resolve.cu` with as many parameters as its argtypes; no name in
    # the source holds "megakernel", which the benchmark's readers take for
    # K1's kernels.
    import re
    import types

    from robocheck_tpu_torch.kernels import _build

    src = _build.SOURCES["resolve"].read_text()
    assert "megakernel" not in src.lower()
    extern = src[src.index('extern "C" {'):]
    found = re.findall(r"\n(?:int|int64_t|const char\*) (rc_\w+)\(([^)]*)\)", extern)
    declared = {name: [a.split()[-1].lstrip("*") for a in args.split(",") if a.strip()]
                for name, args in found}
    assert set(declared) == {"rc_resolve", "rc_resolve_error_string"}
    lib = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in declared})
    _build._bind_resolve(lib)
    for name in declared:
        assert len(getattr(lib, name).argtypes) == len(declared[name]), name
    assert declared["rc_resolve"][-3:] == ["out", "counts", "stream"]


# --------------------------------------------------------------------------
# The float64 resolution (`kernels.resolve`): the twin against the oracles.
# --------------------------------------------------------------------------

def _oracles():
    """(name, check_configs) of the float64 oracles: the NumPy one, and the
    native one where its library is built."""
    from robocheck_tpu_torch.runtime import native

    out = [("numpy", lambda r, o, c: check_configs(r, o, c, prefer_native=False))]
    if native.available():
        out.append(("native", lambda r, o, c: native.oracle_check(
            r.vertices, r.triangles, o.vertices, o.triangles, c)))
    return out


def _face_on_face():
    tris = np.array([[0, 1, 2]], np.int32)
    return (Mesh(TestCoplanarResolution.RT, tris, "r"), Mesh(TestCoplanarResolution.OT, tris, "o"),
            np.zeros((1, 6), np.float32))


def _assert_resolution_matches_oracles(robot, obstacle, confs):
    """The resolution's float64 verdict (``resolve_row_reference``) of every
    row is the oracles'; check_valid_resolved (K1's twin, then the
    resolution's twin) gives it on the rows K1 calls valid and flags, K1's
    bit 0 elsewhere (a row K1 calls colliding stays so). Returns (K1's
    bytes, the resolved verdicts)."""
    from robocheck_tpu_torch.kernels.resolve import resolve_row_reference

    ck = mk.MegaKernelChecker(robot, obstacle, device="cpu")
    packed = ck.check_packed(confs)
    got = ck.check_valid_resolved(confs)
    assert got.dtype == bool and got.shape == (len(confs),)
    exact = np.array([resolve_row_reference(c, ck.resolve_tables)
                      for c in torch.from_numpy(confs)])
    for name, oracle in _oracles():
        np.testing.assert_array_equal(exact, oracle(robot, obstacle, confs), name)
    flagged = ((packed & 1) == 1) & ((packed & 6) != 0)
    np.testing.assert_array_equal(got, np.where(flagged, exact, (packed & 1) == 1))
    return packed, got


def test_resolution_twin_turns_the_face_on_face_row_colliding():
    packed, got = _assert_resolution_matches_oracles(*_face_on_face())
    assert packed[0] & 1 and packed[0] & 6  # valid and flagged in float32
    assert not got[0]


@pytest.mark.parametrize("fixture", ["near-coplanar", "touching-intervals"])
def test_resolution_twin_matches_oracles_on_single_pairs(fixture):
    """Each pair of `_near_coplanar_pairs` / `_touching_interval_pairs` at
    the identity pose: the resolved verdict is the oracles', on flagged rows
    (some of which float64 overturns) and on the rest alike."""
    make = {"near-coplanar": _near_coplanar_pairs,
            "touching-intervals": _touching_interval_pairs}[fixture]
    seed = {"near-coplanar": 2024, "touching-intervals": 2025}[fixture]
    one = np.array([[0, 1, 2]], np.int32)
    zero = np.zeros((1, 6), np.float32)
    n_flagged = 0
    for r, o in make(np.random.default_rng(seed)):
        packed, _ = _assert_resolution_matches_oracles(Mesh(r, one), Mesh(o, one), zero)
        n_flagged += bool(packed[0] & 1 and packed[0] & 6)
    assert n_flagged >= 5


def test_resolution_twin_matches_oracles_on_the_mismatched_scale_scene():
    robot, obstacle, confs = _mismatched_scale_scene()
    packed, _ = _assert_resolution_matches_oracles(_mesh(robot), _mesh(obstacle), confs)
    assert ((packed & 1) & ((packed & 6) > 0)).any()


def test_band_hidden_contacts_resolve_colliding_through_the_twin():
    """`test_torch_chunked.py::test_band_hidden_contacts_resolve_colliding`'s
    rows: K1's bytes (valid, bit 2) through the resolution's twin over the
    whole mesh pair (81,920 obstacle triangles, past one K1 block) resolve
    colliding, as the oracles say."""
    from robocheck_tpu_torch.kernels import chunked
    from robocheck_tpu_torch.kernels.resolve import ResolveTables, resolve_rows_reference

    rows = np.array([[0.8576694, -0.8420993, 0.14767459, 0.7203785, 3.0436065, 2.2627144],
                     [0.9153341, 1.5401433, -0.13083363, 1.2929987, 3.1224608, 2.1998174]],
                    np.float32)
    robot, obstacle = _mesh(j_icosphere(1, radius=0.3)), _mesh(j_icosphere(6, radius=1.5))
    packed = chunked.make_checker(robot, obstacle, device="cpu").check_packed(rows)
    np.testing.assert_array_equal(packed, [0b101, 0b101])
    counts = torch.zeros(2, dtype=torch.int64)
    got = resolve_rows_reference(torch.from_numpy(packed), torch.from_numpy(rows),
                                 ResolveTables.build(robot, obstacle, "cpu"), counts)
    np.testing.assert_array_equal(got.numpy(), [0, 0])
    assert counts.tolist() == [2, 2]
    for name, oracle in _oracles():
        assert not oracle(robot, obstacle, rows).any(), name


def test_resolution_counters_count_flagged_and_overturned_rows():
    robot, obstacle, confs = _mismatched_scale_scene()
    ck = mk.MegaKernelChecker(_mesh(robot), _mesh(obstacle), device="cpu")
    face = mk.MegaKernelChecker(*_face_on_face()[:2], device="cpu")
    batch = np.concatenate([confs, confs])
    packed = ck.check_packed(batch)
    flagged = ((packed & 1) == 1) & ((packed & 6) != 0)
    before = ck.counters()
    assert before == {"nonfinite_rows": 0, "resolved_rows": 0, "resolved_colliding": 0}
    valid = ck.check_valid_resolved(batch)
    after = ck.counters()
    assert after["resolved_rows"] == int(flagged.sum()) > 0
    assert after["resolved_colliding"] == int((flagged & ~valid).sum())
    # check_packed alone resolves nothing.
    ck.check_packed(batch)
    assert ck.counters() == after
    # The face-on-face row: one row re-checked, one overturned, each call.
    face.check_valid_resolved(np.zeros((3, 6), np.float32))
    assert face.counters() == {"nonfinite_rows": 0, "resolved_rows": 3,
                               "resolved_colliding": 3}


@pytest.mark.parametrize("kind", ["plain", "chunked", "sharded"])
def test_check_valid_resolved_calls_no_host_oracle(monkeypatch, kind):
    """Every checker resolves on its device, with no oracle on the host,
    and leaves a non-finite row to K1 (the byte 0)."""
    from robocheck_tpu_torch import oracle
    from robocheck_tpu_torch.kernels.chunked import ChunkedMegaKernelChecker
    from robocheck_tpu_torch.oracle import cpu_oracle
    from robocheck_tpu_torch.parallel.sharding import ShardedChecker, make_mesh
    from robocheck_tpu_torch.runtime import native

    robot, obstacle, confs = _face_on_face()
    ck = {"plain": lambda: mk.MegaKernelChecker(robot, obstacle, device="cpu"),
          "chunked": lambda: ChunkedMegaKernelChecker(robot, obstacle, device="cpu",
                                                      max_obs_tris=1),
          "sharded": lambda: ShardedChecker(robot, obstacle, make_mesh(device="cpu"),
                                            device="cpu")}[kind]()

    def refuse(*args, **kwargs):
        raise AssertionError("a host oracle was called")

    for module, name in ((oracle, "check_configs"), (oracle, "resolve_coplanar"),
                         (cpu_oracle, "check_configs"), (native, "oracle_check")):
        monkeypatch.setattr(module, name, refuse)
    assert not ck.check_valid_resolved(confs)[0]
    with_nan = np.concatenate([confs, np.full((1, 6), np.nan, np.float32)])
    assert ck.check_packed(with_nan)[1] == 0
    assert ck.check_valid_resolved(with_nan).tolist() == [False, False]
    assert ck.check_valid_resolved(np.zeros((0, 6), np.float32)).shape == (0,)


def test_resolve_tables_float32_boxes_hold_the_float64_ones(port_alpha):
    """The kernel's prefilter boxes (float32, rounded outward) hold each
    obstacle triangle's float64 box, and each group box its triangles';
    ``outward_f32`` holds boxes that float32 cannot hold exactly, within one
    float32 step."""
    from robocheck_tpu_torch.kernels.resolve import GROUP, ResolveTables, outward_f32

    tables = ResolveTables.build(*port_alpha, "cpu")
    nto = tables.obs_tri.shape[0]
    box, b32 = tables.obs_box.numpy(), tables.boxes32.numpy().astype(np.float64)
    assert b32.shape == (nto + -(-nto // GROUP), 6)
    assert (b32[:nto, :3] <= box[:, :3]).all() and (b32[:nto, 3:] >= box[:, 3:]).all()
    for g in range(-(-nto // GROUP)):
        members = box[g * GROUP:(g + 1) * GROUP]
        assert (b32[nto + g, :3] <= members[:, :3]).all()
        assert (b32[nto + g, 3:] >= members[:, 3:]).all()
    corners = tables.obs_tri.numpy().reshape(nto, 3, 3)
    np.testing.assert_array_equal(box, np.concatenate([corners.min(1), corners.max(1)], 1))
    rng = np.random.default_rng(8)
    boxes = rng.normal(scale=300.0, size=(4096, 6))
    boxes[:, 3:] = boxes[:, :3] + np.abs(rng.normal(size=(4096, 3)))
    out = outward_f32(boxes)
    assert out.dtype == np.float32
    assert (out[:, :3] <= boxes[:, :3]).all() and (out[:, 3:] >= boxes[:, 3:]).all()
    assert (np.nextafter(out[:, :3], np.float32(np.inf)) > boxes[:, :3]).all()
    assert (np.nextafter(out[:, 3:], np.float32(-np.inf)) < boxes[:, 3:]).all()


def test_resolve_cuda_wrapper_refuses_cpu_tensors():
    from robocheck_tpu_torch.kernels import resolve

    robot, obstacle, confs = _face_on_face()
    tables = resolve.ResolveTables.build(robot, obstacle, "cpu")
    launches = resolve.resolve_rows_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        resolve.resolve_rows_cuda(torch.tensor([5], dtype=torch.uint8), torch.from_numpy(confs),
                                  tables, torch.zeros(2, dtype=torch.int64))
    assert resolve.resolve_rows_cuda.launches == launches
