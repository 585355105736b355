"""The port's probe kernels P1-P3 (`robocheck_tpu_torch.profiling.probes`):
their plain PyTorch versions against the JAX package's probes, the CUDA
wrappers' refusal of CPU tensors, and P1's and P2's shared-memory maps and
sizes against K1's layout (`kernels/megakernel.smem_bytes`).

The TPU probes live inside `main()` of `scripts/bisect_stage{1,2,3}.py` and
cannot be imported without editing those scripts, so P1's computation is
restated here in jnp, with the lines it restates, on the JAX package's
`poses_from_confs` and `MegaKernelPrep.build(...).rob_base`. The CUDA
probes are held against the plain versions on the card by `chip_smoke.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robocheck_tpu.kernels import megakernel as jmk
from robocheck_tpu_torch.io import assets
from robocheck_tpu_torch.io.obj import load_obj
from robocheck_tpu_torch.kernels import megakernel as mk
from robocheck_tpu_torch.profiling import probes

B = 64
LANE = 128


def _jax_mini(pose, rob, level):
    """`bisect_stage1.py:78-112` (`mini_kernel`) and `:122-138`
    (`mini_kernel_t`, level "transposed") on whole arrays: the float
    accumulator before the int32 cast."""
    def pcol(k):
        return pose[:, k : k + 1]

    corners = []
    for c in range(3):
        X, Y, Z = rob[3 * c : 3 * c + 1], rob[3 * c + 1 : 3 * c + 2], rob[3 * c + 2 : 3 * c + 3]
        corners += [pcol(0) * X + pcol(1) * Y + pcol(2) * Z + pcol(3),
                    pcol(4) * X + pcol(5) * Y + pcol(6) * Z + pcol(7),
                    pcol(8) * X + pcol(9) * Y + pcol(10) * Z + pcol(11)]
    if level == "transposed":
        return corners[0][:, :LANE] + corners[0][:, :LANE]
    acc = pose[:, 0:1] * jnp.ones((pose.shape[0], LANE), jnp.float32)
    if level >= 1:
        acc = acc + corners[0][:, :LANE]
    if level >= 2:
        tri_valid = rob[9:10] > 0.0
        broad = None
        for k in range(3):
            lo = jnp.minimum(jnp.minimum(corners[k], corners[3 + k]), corners[6 + k])
            hi = jnp.maximum(jnp.maximum(corners[k], corners[3 + k]), corners[6 + k])
            mesh_lo = jnp.min(jnp.where(tri_valid, lo, 3.0e38), axis=1, keepdims=True)
            mesh_hi = jnp.max(jnp.where(tri_valid, hi, -3.0e38), axis=1, keepdims=True)
            ax = (mesh_lo <= 1.0) & (-1.0 <= mesh_hi)
            broad = ax if broad is None else broad & ax
        acc = acc + broad.astype(jnp.float32)
    if level >= 3:
        acc = acc + corners[0][:, :LANE]  # rob_d[:, 0, :LANE] read back
    return acc


@pytest.fixture(scope="module")
def stage1_inputs(alpha_meshes):
    confs = probes.stage1_confs(B)
    j_poses = jax.jit(jmk.poses_from_confs)(jnp.asarray(confs))
    j_rob = jnp.asarray(jmk.MegaKernelPrep.build(*alpha_meshes).rob_base)
    prep = mk.MegaKernelPrep.build(load_obj(assets.alpha_robot_path()),
                                   load_obj(assets.alpha_obstacle_path())).to("cpu")
    poses = mk.poses_from_confs(torch.from_numpy(confs))
    return j_poses, j_rob, poses, prep.rob_base


@pytest.mark.parametrize("level", probes.POSE_LEVELS)
def test_pose_probe_plain_matches_jax(level, stage1_inputs):
    j_poses, j_rob, poses, rob_base = stage1_inputs
    want = np.asarray(jax.jit(_jax_mini, static_argnums=2)(j_poses, j_rob, level))
    acc = probes.pose_probe_acc(poses, rob_base, level).numpy()
    out = probes.pose_probe_reference(poses, rob_base, level).numpy()
    assert acc.shape == out.shape == (B, LANE) and out.dtype == np.int32
    # XLA on the CPU fuses the multiply-adds and moves coordinates of ~300
    # by ~1e-4; the two sides agree within 1e-3.
    np.testing.assert_allclose(acc, want, rtol=0, atol=1e-3)
    # The int32 outputs agree wherever the float is not within 1e-3 of an
    # integer (truncation toward zero on both sides).
    far = np.abs(want - np.round(want)) > 1e-3
    assert far.mean() > 0.9
    np.testing.assert_array_equal(out[far], want.astype(np.int32)[far])
    np.testing.assert_array_equal(out, np.trunc(acc).astype(np.int32))


def test_pose_probe_levels_build_on_each_other(stage1_inputs):
    _, _, poses, rob_base = stage1_inputs
    acc = {lv: probes.pose_probe_acc(poses, rob_base, lv) for lv in probes.POSE_LEVELS}
    c0x = acc[1] - acc[0]
    # Level 2 adds the broad flag, 0 or 1 per row (up to the rounding of the
    # sum): the alpha robot sits ~300 units from its origin, so few rotations
    # bring its box onto the [-1,1] cube.
    broad = acc[2] - acc[1]
    flag = broad.round()
    torch.testing.assert_close(broad, flag, rtol=0, atol=1e-5)
    assert set(flag.unique().tolist()) <= {0.0, 1.0}
    assert (flag == flag[:, :1]).all()
    torch.testing.assert_close(acc[3] - acc[2], c0x, rtol=0, atol=1e-3)
    torch.testing.assert_close(acc["transposed"], 2 * c0x, rtol=0, atol=1e-3)


def _stage2_numpy():
    """`bisect_stage2.py:32-35, 83-96`: tables, then each piece's poses, from
    one default_rng(0) in the script's order."""
    rng = np.random.default_rng(0)
    rng.normal(size=(16, 1024)), rng.normal(size=(1024, 24)), rng.normal(size=(6, 1024))
    return [rng.normal(size=(b, 16)).astype(np.float32)
            for b in (16384,) * 6 + (65536, 4096, 16384)]


def test_empty_probe_plain_matches_numpy():
    pieces = probes.stage_pieces(2, "cpu")
    assert [p.name for p in pieces] == [
        "pose_only", "pose_only_scratch", "pose+rob", "pose+obs", "pose+rows",
        "all_inputs", "pose_only_B65536", "pose_only_B4096", "pose_only_cpb8"]
    assert [p.cpb for p in pieces] == [1] * 8 + [8]
    for piece, poses in zip(pieces, _stage2_numpy()):
        want = np.broadcast_to((poses[:, 0:1] * np.ones((1, LANE), np.float32))
                               .astype(np.int32), (len(poses), LANE))
        out = piece.plain().numpy()
        assert piece.n == len(poses)
        np.testing.assert_array_equal(out, want)


def test_invariant_probe_plain_matches_numpy():
    rng = np.random.default_rng(0)  # `bisect_stage3.py:34-37`
    rob_base = rng.normal(size=(16, 1024)).astype(np.float32)
    tab = rng.normal(size=(8, 8)).astype(np.float32)
    poses = rng.normal(size=(16384, 16)).astype(np.float32)
    want = {"manual_dma_rob": (poses[:, 0:1] * rob_base[0:1, :LANE]).astype(np.int32),
            "smem_invariant": (poses[:, 0:1] * np.full((1, LANE), tab[0, 0])).astype(np.int32),
            "auto_invariant_vmem": (poses[:, 0:1] * rob_base[0:1, :LANE]).astype(np.int32)}
    pieces = probes.stage_pieces(3, "cpu")
    assert [p.name for p in pieces] == list(want)
    for piece in pieces:
        np.testing.assert_array_equal(piece.plain().numpy(), want[piece.name])
    with pytest.raises(ValueError, match="mode"):
        probes.invariant_probe_reference(torch.zeros((1, 16)), torch.zeros((1, 128)), "vmem")


def test_stage_pieces_names_and_errors(stage1_inputs):
    _, _, _, rob_base = stage1_inputs
    pieces = probes.stage_pieces(1, "cpu", rob_base, n=B)
    assert [p.name for p in pieces] == ["mini_level0", "mini_level1", "mini_level2",
                                        "mini_level3", "mini_writes_transposed"]
    assert all(p.n == B and tuple(p.plain().shape) == (B, LANE) for p in pieces)
    with pytest.raises(ValueError, match="rob_base"):
        probes.stage_pieces(1, "cpu")
    with pytest.raises(ValueError, match="stage"):
        probes.stage_pieces(4, "cpu")
    with pytest.raises(ValueError, match="level"):
        probes.pose_probe_reference(torch.zeros((1, 16)), rob_base, 5)


def _cpu_calls(prep):
    poses = mk.poses_from_confs(torch.zeros((4, 6)))
    table = torch.zeros((16, 1024))
    return {
        "check_poses_stats_cuda": lambda: mk.check_poses_stats_cuda(poses, prep),
        "check_poses_stage_cuda": lambda: mk.check_poses_stage_cuda(poses, prep, "nosweep"),
        "pose_probe_cuda": lambda: probes.pose_probe_cuda(poses, prep.rob_base, 3),
        "empty_probe_cuda": lambda: probes.empty_probe_cuda(poses, (table,), True),
        "invariant_probe_cuda": lambda: probes.invariant_probe_cuda(poses, table, "auto"),
    }


@pytest.mark.parametrize("wrapper", ["check_poses_stats_cuda", "check_poses_stage_cuda",
                                     "pose_probe_cuda", "empty_probe_cuda",
                                     "invariant_probe_cuda"])
def test_cuda_wrappers_refuse_cpu_tensors(wrapper, stage1_inputs):
    prep = mk.MegaKernelPrep.build(load_obj(assets.alpha_robot_path()),
                                   load_obj(assets.alpha_obstacle_path())).to("cpu")
    fn = getattr(mk, wrapper, None) or getattr(probes, wrapper)
    before = repr(fn.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cpu_calls(prep)[wrapper]()
    assert repr(fn.launches) == before


def test_cpu_checker_never_reaches_the_counter_kernel():
    prep_launches = mk.check_poses_stats_cuda.launches
    ck = mk.MegaKernelChecker(load_obj(assets.alpha_robot_path()),
                              load_obj(assets.alpha_obstacle_path()), device="cpu")
    far = np.zeros((3, 6), np.float32)
    far[:, 0] = 1.0e9
    assert ck.check(far)[0].all() and ck.check(far, two_phase=False)[0].all()
    assert mk.check_poses_stats_cuda.launches == prep_launches
    with pytest.raises(ValueError, match="stage"):
        mk.check_poses_stage_cuda(mk.poses_from_confs(torch.zeros((1, 6))), ck.tables, "full")


@pytest.mark.parametrize("stage", sorted(mk.STAGES))
def test_stage_variants_refuse_cpu_tensors_and_unknown_stages(stage):
    prep = mk.MegaKernelPrep.build(load_obj(assets.alpha_robot_path()),
                                   load_obj(assets.alpha_obstacle_path())).to("cpu")
    poses = mk.poses_from_confs(torch.zeros((4, 6)))
    before = dict(mk.check_poses_stage_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mk.check_poses_stage_cuda(poses, prep, stage)
    with pytest.raises(ValueError, match="stage"):
        mk.check_poses_stage_cuda(poses, prep, stage.upper())
    assert mk.check_poses_stage_cuda.launches == before
    # The codes of `rc_megakernel_check_stage` in csrc/megakernel.cu.
    assert mk.STAGES[stage] == {"nosweep": 1, "maskonly": 2, "planesonly": 3, "nodiv": 4}[stage]


def _disjoint_inside(regions, floats):
    """Whether the (name, start, size) regions lie inside [0, floats) and
    overlap none of the others."""
    spans = sorted((start, start + size) for _, start, size in regions)
    return (spans[0][0] >= 0 and spans[-1][1] <= floats
            and all(a[1] <= b[0] for a, b in zip(spans, spans[1:])))


@pytest.mark.parametrize("tables", ["alpha", "probe_tr"])
def test_pose_probe_smem_map_lies_inside_k1s(tables):
    if tables == "alpha":
        prep = mk.MegaKernelPrep.build(load_obj(assets.alpha_robot_path()),
                                       load_obj(assets.alpha_obstacle_path()))
        tr, n_groups = prep.rob_base.shape[1], prep.obs_groups.shape[0]
    else:
        tr, n_groups = probes.PROBE_TR, probes.PROBE_TR // mk.GROUP
    regions = probes.probe_map("pose", tr, n_groups)
    k1_bytes = mk.smem_bytes(tr, n_groups)
    assert _disjoint_inside(regions, k1_bytes // 4)
    size = {name: floats for name, _, floats in regions}
    # 32 tiles of 32 triangles: K1's padded slots, 9 fields of 32 x 33 floats.
    assert size["rob"] == 9 * 1056 and size["realw"] == 32
    for t in range(4):
        assert (size[f"ctl{t}"], size[f"pose{t}"], size[f"tile_box{t}"], size[f"c0x{t}"],
                size[f"part{t}"]) == (1, 16, 192, 1056, 768)
    # The c0x fields take the space of K1's obstacle and group boxes, which
    # P1 does not stage; the rest sits where K1 keeps it, up to K1's end.
    start = {name: first for name, first, _ in regions}
    assert start["c0x0"] == 9 * 1056 and start["c0x3"] + 1056 <= 9 * 1056 + 6 * 128 * n_groups
    assert max(first + floats for _, first, floats in regions) * 4 == k1_bytes
    assert probes.probe_smem_bytes("pose", tr, n_groups) == k1_bytes


def test_probe_smem_bytes_is_k1s_for_p1_and_scratch_pieces(stage1_inputs):
    _, _, _, rob_base = stage1_inputs
    k1_bytes = mk.smem_bytes(probes.PROBE_TR, probes.PROBE_TR // mk.GROUP)
    for piece in probes.stage_pieces(1, "cpu", rob_base, n=B):
        a = piece.args
        assert piece.probe == "pose" and a["n_groups"] == 8
        assert probes.probe_smem_bytes("pose", a["rob_base"].shape[1], a["n_groups"]) == k1_bytes
    for piece in probes.stage_pieces(2, "cpu"):
        a = piece.args
        assert piece.probe == "empty" and a["poses"].shape == (piece.n, 16)
        smem = probes.probe_smem_bytes("empty", tables=tuple(a["tables"]),
                                       scratch=a["scratch"], cpb=a["cpb"])
        regions = probes.probe_map("empty", tables=tuple(a["tables"]), scratch=a["scratch"],
                                   cpb=a["cpb"])
        assert _disjoint_inside(regions, smem // 4)
        rows = 16 if a["cpb"] == 8 else 4
        assert [n for n, _, _ in regions if n.startswith("pose")] == [
            f"pose{r}" for r in range(rows)]
        staged = {n for n, _, _ in regions if not n[-1].isdigit()}
        assert staged == set(a["tables"]) | ({"realw"} if "rob" in a["tables"] else set())
        if a["scratch"]:
            assert smem == k1_bytes
        else:  # only the staged tables and the row slots
            assert smem == 4 * sum(f for _, _, f in regions) < k1_bytes
    assert probes.probe_smem_bytes("invariant") == 79936


def test_probe_smem_bytes_refuses_what_k1s_layout_cannot_hold():
    with pytest.raises(ValueError, match="cpb"):
        probes.probe_smem_bytes("empty", scratch=True, cpb=8)
    with pytest.raises(ValueError, match="obstacle rows"):
        probes.probe_smem_bytes("empty", to=256, tables=("obs",), scratch=True)
    # 2,048 robot triangles' c0x fields (4 x 2 x 1,056 floats) do not fit
    # one obstacle group's boxes.
    with pytest.raises(ValueError, match="do not fit"):
        probes.probe_smem_bytes("pose", 2048, 1)
    assert probes.probe_smem_bytes("pose", 2048, 16) == mk.smem_bytes(2048, 16)
    with pytest.raises(ValueError, match="probe"):
        probes.probe_smem_bytes("stage1")
