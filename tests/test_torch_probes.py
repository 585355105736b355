"""The port's probe kernels P1-P3 (`robocheck_tpu_torch.profiling.probes`):
their plain PyTorch versions against the JAX package's probes, the CUDA
wrappers' refusal of CPU tensors, and the probes' shared-memory maps and
sizes against K1's layout (`kernels/megakernel.smem_bytes`).

The TPU probes live inside `main()` of `scripts/bisect_stage{1,2,3}.py` and
cannot be imported without editing those scripts, so P1's computation is
restated here in jnp, with the lines it restates, on the JAX package's
`poses_from_confs` and `MegaKernelPrep.build(...).rob_base`. The CUDA
probes are held against the plain versions on the card by `chip_smoke.py`.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robocheck_tpu.kernels import megakernel as jmk
from robocheck_tpu_torch.io import assets
from robocheck_tpu_torch.io.obj import load_obj
from robocheck_tpu_torch.kernels import _build
from robocheck_tpu_torch.kernels import megakernel as mk
from robocheck_tpu_torch.profiling import bounds, probes

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


def _stage3_numpy():
    """`bisect_stage3.py:34-37` and each piece's output, by numpy."""
    rng = np.random.default_rng(0)
    rob_base = rng.normal(size=(16, 1024)).astype(np.float32)
    tab = rng.normal(size=(8, 8)).astype(np.float32)
    poses = rng.normal(size=(16384, 16)).astype(np.float32)
    return {"manual_dma_rob": (poses[:, 0:1] * rob_base[0:1, :LANE]).astype(np.int32),
            "smem_invariant": (poses[:, 0:1] * np.full((1, LANE), tab[0, 0])).astype(np.int32),
            "auto_invariant_vmem": (poses[:, 0:1] * rob_base[0:1, :LANE]).astype(np.int32)}


def test_invariant_probe_plain_matches_numpy():
    want = _stage3_numpy()
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
    # P3: K1's allocation plus its [16, 1024] table's overhang over K1's
    # tables (16,384 floats against K1's 15,728); the first design's 79,936
    # bytes stay under their own name for `torch_bisect.py --old`.
    assert probes.probe_smem_bytes("invariant") == k1_bytes + 4 * (16384 - 15728) == 85424
    assert probes.FIRST_DESIGN_SMEM == 79936


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


@pytest.mark.parametrize("tr,n_groups", [(1024, 8), (2048, 16), (128, 1)])
def test_invariant_probe_smem_map(tr, n_groups):
    regions = probes.probe_map("invariant", tr, n_groups)
    smem = probes.probe_smem_bytes("invariant", tr, n_groups)
    assert _disjoint_inside(regions, smem // 4)
    start = {name: first for name, first, _ in regions}
    size = {name: floats for name, _, floats in regions}
    # The whole [16, tr] table at float 0, the team slots clear of it.
    assert (start["table"], size["table"]) == (0, 16 * tr)
    slots = [r for r in regions if r[0] not in ("table", "bar")]
    assert [n for n, _, _ in slots] == [f"{k}{t}" for t in range(4) for k in ("ctl", "pose")]
    assert min(first for _, first, _ in slots) >= 16 * tr
    # K1's team slots (P2's scratch map), moved by the table's overhang over
    # K1's tables (none where the table is smaller), up to the end of K1's
    # allocation moved as far.
    k1 = {name: first for name, first, _ in probes.probe_map("empty", tr, n_groups,
                                                               scratch=True)}
    shift = max(0, 16 * tr - k1["ctl0"])
    assert all(start[f"{k}{t}"] == k1[f"{k}{t}"] + shift for t in range(4)
               for k in ("ctl", "pose"))
    assert smem == mk.smem_bytes(tr, n_groups) + 4 * shift
    # The map ends at the allocation's end: the last team's slot, as long as
    # K1's team slots (a team's row word 1 and pose 16 of them), ends there.
    assert start["ctl3"] + (start["ctl3"] - start["ctl2"]) == smem // 4
    # The mbarrier: 8 bytes, 8-byte aligned, in team 0's 11 control words
    # past its row word.
    assert size["bar"] == 2 and start["bar"] % 2 == 0
    assert start["ctl0"] < start["bar"] and start["bar"] + 2 <= start["ctl0"] + 11
    if (tr, n_groups) == (1024, 8):
        assert shift == 656 and smem == 85424


def test_invariant_probe_table_past_optin_raises():
    # 4,096 columns: a 262,144-byte table, past the H100's 232,448 bytes a
    # block; 2,048 fit (166,320 bytes).
    assert mk.SMEM_LIMIT == 232448
    with pytest.raises(ValueError, match="opt-in"):
        probes.probe_smem_bytes("invariant", 4096, 8)
    assert probes.probe_smem_bytes("invariant", 2048, 8) <= mk.SMEM_LIMIT


def test_stage3_pieces_keep_names_and_plain_outputs():
    want = _stage3_numpy()
    pieces = probes.stage_pieces(3, "cpu")
    assert [(p.name, p.probe, p.n, p.cpb, p.args["mode"]) for p in pieces] == [
        ("manual_dma_rob", "invariant", 16384, 1, "manual_dma"),
        ("smem_invariant", "invariant", 16384, 1, "smem_invariant"),
        ("auto_invariant_vmem", "invariant", 16384, 1, "auto")]
    for piece in pieces:
        # Every piece on the probes' tables, the layout its launch allocates.
        assert probes.piece_layout(piece) == {"tr": 1024, "n_groups": 8}
        assert tuple(piece.args["table"].shape) == ((8, 8) if piece.name == "smem_invariant"
                                                    else (16, 1024))
        out = piece.plain()
        assert out.dtype == torch.int32 and tuple(out.shape) == (16384, LANE)
        np.testing.assert_array_equal(out.numpy(), want[piece.name])


def test_invariant_probe_work():
    io = 16384 * (64 + 512)
    assert bounds.probe_work("manual_dma_rob", 16384) == (io + 4 * 16 * 1024, 16384 * 128)
    assert bounds.probe_work("smem_invariant", 16384) == (io + 256, 16384)
    assert bounds.probe_work("auto_invariant_vmem", 16384) == (io + 512, 16384 * 128)
    for piece in ("manual_dma_rob", "smem_invariant", "auto_invariant_vmem"):
        assert bounds.bound_ms(*bounds.probe_work(piece, 16384))[1] == "bytes"


def test_invariant_probe_entry_matches_its_binding():
    # `rc_invariant_probe` in csrc/stage_probes.cu takes as many parameters
    # as `_build.library` binds, the layout's tables among them.
    extern = _build.SOURCES["stage_probes"].read_text()
    extern = extern[extern.index('extern "C" {'):]
    params = re.search(r"\nint rc_invariant_probe\(([^)]*)\)", extern).group(1)
    names = [a.split()[-1].lstrip("*") for a in params.split(",")]
    assert names == ["poses", "n", "table", "table_floats", "mode", "tr", "n_groups", "out",
                     "work", "smem", "resident", "stream"]
    build_src = Path(_build.__file__).read_text()
    bound = re.search(r"_bind\(lib\.rc_invariant_probe, i32,\s*\[([^\]]*)\]", build_src)
    assert len([a for a in bound.group(1).split(",") if a.strip()]) == len(names)
