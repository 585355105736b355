"""GPU smoke check of the PyTorch/CUDA port (`robocheck_tpu_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:
  1. the card: name, and `nvidia-smi` name and power limit;
  2. build the CUDA sources `robocheck_tpu_torch/csrc/megakernel.cu` and
     `stage_probes.cu` (sm_90a, -fmad=false; one nvcc each, started
     together) and print the ptxas register / shared-memory / spill lines of
     every kernel instance, and the fused kernel's shared memory per block
     and resident blocks per SM for the alpha-1.0 tables;
  3. the kernel against its plain PyTorch twin on the card, on the same pose
     rows: alpha-1.0 meshes over hard10k[:2048] and easy10k[:2048], two
     icosphere scenes (one with a 2200-triangle soup obstacle), the
     tetrahedra fixture and two coplanar fixtures. `valid`
     must be identical on every row, `coplanar` (bit 1) and `uncertain`
     (bit 2) on every valid row (the tolerance is exact: both compute the
     same float32 operations);
  3b. the counter kernel against its twin on the same scenes and the JAX
     package's TestCoplanarResolution fixture: columns 0-6 identical on valid
     rows, columns 0 and 3 on every row; on colliding rows the kernel's
     columns 2 and 4-6 at most the twin's (its any-hit exit stops the
     counts), with nrest >= 1; the JAX fixture's row must carry bit 2 and
     resolve colliding through `check_valid_resolved` on the card;
  4. the main path, `MegaKernelChecker(..., device="cuda").check_valid_resolved`,
     on all 10,000 rows of hard10k and easy10k (0 golden mismatches each) and
     of 10,000samples (7296 valid, the file header's count), with the
     kernel's launch counter above 0, and the rows each set sends to float64
     resolution by bit 1 and by bit 2;
  5. times: end-to-end checks/s (best of 5 after a warm-up, each run ending
     in torch.cuda.synchronize()), and the kernel alone and its twin alone
     at the main path's shape, all 10,000 rows of hard10k and of easy10k in
     one launch (CUDA events); their outputs are held against each other as
     in phase 3;
  4b. the stats path: `checker.check` with two_phase True and False on all
     10,000 rows of hard10k and easy10k (`valid` equal to `check_valid`'s on
     every row; the counter kernel's broad column equal to `broad_block` on
     every row with two_phase False, and 1 on every survivor of
     `broad_block` with two_phase True), with the counter kernel's launch
     counter above 0; `check_valid(presort=True)` equal to presort=False on
     the three 10k sets; the counter kernel and its twin timed on hard10k and
     held against each other as in 3b;
  6. the stage-decomposition surface: every stage variant of the kernel on
     hard10k (`scripts/torch_roofline.py`; the byte 1 on every row, timed
     beside the full kernel) and every probe piece of P1-P3 at its script's
     shape (`scripts/torch_bisect.py`; equal to its plain version, tolerance
     0), each launched once with the launch counters set to 0 just before,
     then timed with its plain version by CUDA events.
The line before the last is the kernel table as JSON, each kernel with its
bound (`profiling.bounds`, from this run's inputs and counter rows); the
last line is the result as JSON. Without a CUDA device, or without the package beside it, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

REPLACES = "robocheck_tpu/kernels/megakernel.py:358"
SOURCE = "robocheck_tpu_torch/csrc/megakernel.cu"
PROBE_SOURCE = "robocheck_tpu_torch/csrc/stage_probes.cu"
# The JAX knob each stage variant replaces (robocheck_tpu/kernels/megakernel.py).
STAGE_REPLACES = {"nosweep": "robocheck_tpu/kernels/megakernel.py:625",
                  "maskonly": "robocheck_tpu/kernels/megakernel.py:761",
                  "planesonly": "robocheck_tpu/kernels/megakernel.py:770",
                  "nodiv": "robocheck_tpu/kernels/megakernel.py:775"}
# The probe pieces each kernel-table entry is timed on, and the pallas_calls.
PROBES = {1: ("P1_pose_probe", "mini_level3", "scripts/bisect_stage1.py:142,165"),
          2: ("P2_empty_probe", "pose_only", "scripts/bisect_stage2.py:73"),
          3: ("P3_invariant_probe", "auto_invariant_vmem",
              "scripts/bisect_stage3.py:66,86,105")}
# tests/test_megakernel.py::TestCoplanarResolution (JAX package), identity pose.
JAX_COPLANAR_RT = [[-88.58568, -287.5827, -148.07309], [-105.54053, -122.13013, -65.34459],
                   [9.788717, -353.9158, -98.061005]]
JAX_COPLANAR_OT = [[-163.90807, -449.27316, -312.38596], [55.186058, -181.60817, 45.36783],
                   [-9.889383, -480.09338, -190.76962]]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def compare_on_card(mk, name, robot, obstacle, confs, device, scenes):
    """Phase 3 for one scene: the kernel and its twin on the same pose rows.
    Appends the scene to `scenes` for phase 3b."""
    prep = mk.MegaKernelPrep.build(robot, obstacle).to(device)
    poses = mk.poses_from_confs(torch.from_numpy(confs).to(device))
    scenes.append((name, prep, poses))
    return compare_bits(name, mk.check_poses_cuda(poses, prep),
                        mk.check_poses_reference(poses, prep))


def compare_stats(name, got, want):
    """Counter rows of the kernel `got` against the twin's `want`: columns
    0-6 identical on valid rows, 0 and 3 on every row; on colliding rows the
    kernel's columns 2 and 4-6 at most the twin's and nrest >= 1. Returns the
    max abs difference of the compared entries."""
    got, want = got.cpu().numpy().astype(np.int64), want.cpu().numpy().astype(np.int64)
    valid = want[:, 0] == 1
    hit = ~valid
    err = max(int(np.abs(got[valid, :7] - want[valid, :7]).max(initial=0)),
              int(np.abs(got[:, [0, 3]] - want[:, [0, 3]]).max(initial=0)))
    print(f"  {name}: {len(got)} rows ({int(valid.sum())} valid), pairs kernel/twin "
          f"{int(got[:, 2].sum())}/{int(want[:, 2].sum())}, nfull "
          f"{int(got[:, 4].sum())}/{int(want[:, 4].sum())}, ngate "
          f"{int(got[:, 5].sum())}/{int(want[:, 5].sum())}, nrest "
          f"{int(got[:, 6].sum())}/{int(want[:, 6].sum())}, max abs err {err}")
    require(err == 0, f"{name}: counter rows differ from the twin")
    require(bool((got[hit][:, [2, 4, 5, 6]] <= want[hit][:, [2, 4, 5, 6]]).all()),
            f"{name}: a colliding row counts more than the twin")
    require(bool((got[hit, 6] >= 1).all()), f"{name}: a colliding row has nrest 0")
    require(not got[:, 7].any(), f"{name}: column 7 is not zero")
    return err


def compare_bits(name, got, want):
    """Kernel bytes `got` against twin bytes `want`: `valid` (bit 0) identical
    on every row, `coplanar` (bit 1) and `uncertain` (bit 2) on every valid
    row. Returns (max abs difference of the compared bits, valid rows,
    coplanar-flagged valid rows, uncertain-flagged valid rows)."""
    got, want = got.cpu().numpy().astype(int), want.cpu().numpy().astype(int)
    v_got, v_want = got & 1, want & 1
    valid = v_want == 1
    err = int(np.abs(v_got - v_want).max())
    flags = {}
    for bit, what in ((1, "coplanar"), (2, "uncertain")):
        f_got, f_want = (got[valid] >> bit) & 1, (want[valid] >> bit) & 1
        err = max(err, int(np.abs(f_got - f_want).max(initial=0)))
        flags[what] = (int(f_got.sum()), int(f_want.sum()))
    print(f"  {name}: {len(got)} rows, valid kernel/twin "
          f"{int(v_got.sum())}/{int(v_want.sum())}, on valid rows coplanar "
          f"{'/'.join(map(str, flags['coplanar']))}, uncertain "
          f"{'/'.join(map(str, flags['uncertain']))}, max abs err {err}")
    require(np.array_equal(v_got, v_want), f"{name}: valid differs from the twin")
    require(err == 0, f"{name}: bit 1 or bit 2 differs from the twin on valid rows")
    return err, int(valid.sum()), flags["coplanar"][1], flags["uncertain"][1]


def main() -> None:
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from robocheck_tpu_torch import MegaKernelChecker, load_obj, read_conf_file
    from robocheck_tpu_torch.core.types import Mesh
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.kernels import _build
    from robocheck_tpu_torch.kernels import megakernel as mk
    from robocheck_tpu_torch.models.shapes import box, icosphere, tetrahedron, triangle_soup
    from robocheck_tpu_torch.profiling import bounds, probes
    from robocheck_tpu_torch.profiling.timers import benchmark, card_line, event_ms
    from robocheck_tpu_torch.runtime import native

    require("jax" not in sys.modules and "robocheck_tpu" not in sys.modules,
            "the port imported JAX or the JAX package")
    device = torch.device("cuda", 0)

    # ---- 1. The card. ----
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[1] nvidia-smi name, power.limit: {card}")

    # ---- 2. Build. ----
    t0 = time.perf_counter()
    built = _build.build()
    for name in built:
        _build.library(name)
    print(f"[2] built {', '.join(p.name for p, _ in built.values())} in "
          f"{time.perf_counter() - t0:.1f} s ({' '.join(_build.NVCC_FLAGS)})")
    for name, (_, log) in built.items():
        print(f"  {name}:")
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "smem",
                                       "stack frame")):
                print(f"    {line.strip()}")
    lib = _build.library()
    per_sm = lib.rc_megakernel_blocks_per_sm(1024, 8)
    require(per_sm > 0, f"the fused kernel fits no block on an SM ({per_sm})")
    print(f"  fused kernel, alpha-1.0 tables [10,1024] / [1024,20]: "
          f"{lib.rc_megakernel_smem_bytes(1024, 8)} bytes of shared memory per block, "
          f"{per_sm} resident blocks per SM")

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    data = {key: read_conf_file(assets.dataset_path(key))
            for key in ("hard10k", "easy10k", "samples10k")}

    # ---- 3. Kernel against its twin, same pose rows. ----
    print("[3] kernel vs twin on the card (exact: valid on every row, "
          "coplanar and uncertain on valid rows)")
    max_err = 0
    scenes = []  # (name, tables, poses) for phase 3b
    for key in ("hard10k", "easy10k"):
        err, *_ = compare_on_card(mk, f"alpha {key}[:2048]", robot, obstacle,
                                  data[key].confs[:2048], device, scenes)
        max_err = max(max_err, err)
    rng = np.random.default_rng(77)
    sphere = np.zeros((256, 6), np.float32)
    sphere[:, 0] = rng.uniform(0.0, 3.0, 256)
    sphere[:, 3:6] = rng.uniform(-np.pi, np.pi, (256, 3))
    err, *_ = compare_on_card(mk, "icospheres r1.0/r1.5", icosphere(1, 1.0),
                              icosphere(1, 1.5), sphere, device, scenes)
    max_err = max(max_err, err)
    # 40 robot tiles x 18 obstacle groups: the gate's compaction takes
    # three rounds (the alpha pair fits one).
    soup = triangle_soup(np.random.default_rng(508), 2200, extent=1.0)
    soup_confs = np.random.default_rng(5).uniform(-1.5, 1.5, (512, 6)).astype(np.float32)
    err, n_valid, *_ = compare_on_card(mk, "icosphere(3) in a 2200-triangle soup",
                                       icosphere(3, 0.3), soup, soup_confs, device, scenes)
    require(0 < n_valid < len(soup_confs), "soup scene: expected both verdicts")
    max_err = max(max_err, err)
    tet = tetrahedron()
    tet_obs = Mesh(np.array([[1, 0.1, 0], [1.5, 1, 2.2], [1, 2.4, 0], [3.3, 2, 2]],
                            np.float32), tet.triangles, "obs-tetra")
    tet_confs = np.zeros((2, 6), np.float32)
    tet_confs[1, 0] = 100.0
    err, n_valid, *_ = compare_on_card(mk, "tetrahedra", tet, tet_obs, tet_confs, device,
                                       scenes)
    require(n_valid == 1, "tetrahedra: expected row 0 colliding, row 1 clear")
    max_err = max(max_err, err)
    cop_confs = np.zeros((8, 6), np.float32)
    cop_confs[:, 0:3] = [[6.0e3, 1.8e4, 1.0e4], [6.0e3 + 0.5, 1.8e4, 1.0e4],
                         [2.0e4 - 10.0, 1.9e4, 1.99e4], [0.0, 1.99e4, 5.0],
                         [6.0e3, 1.8e4, 1.0e4 - 2.0], [0.0, 5.0e3, 5.0e3],
                         [1.0, 5.0e3, 5.0e3], [9.0e5, 9.0e5, 9.0e5]]
    cop_confs[:, 3:6] = np.random.default_rng(3).uniform(-np.pi, np.pi, (8, 3))
    err, _, n_cop, _ = compare_on_card(mk, "unit box on 1e4 tetrahedron (coplanar)",
                                       box(extent=(2.0, 2.0, 2.0)),
                                       tetrahedron(scale=1.0e4), cop_confs, device, scenes)
    require(n_cop > 0, "coplanar fixture flagged no valid row coplanar")
    max_err = max(max_err, err)
    one = np.array([[0, 1, 2]], np.int32)
    face_r = np.array([[-172.35173, 118.57849, -337.86478], [-168.62619, 71.0307, -215.03616],
                       [-280.98154, 165.06941, -53.021297]], np.float32)
    face_o = np.array([[-148.91972, 43.489243, -211.57489], [-222.59364, 145.73175, -222.42876],
                       [-204.12267, 60.86192, -48.782146]], np.float32)
    err, _, n_cop, _ = compare_on_card(mk, "face on face (coplanar)", Mesh(face_r, one),
                                       Mesh(face_o, one), np.zeros((1, 6), np.float32),
                                       device, scenes)
    require(n_cop == 1, "face-on-face fixture not flagged coplanar")
    max_err = max(max_err, err)
    jax_rt = Mesh(np.array(JAX_COPLANAR_RT, np.float32), one)
    jax_ot = Mesh(np.array(JAX_COPLANAR_OT, np.float32), one)
    err, _, _, n_unc = compare_on_card(mk, "JAX TestCoplanarResolution fixture, identity pose",
                                       jax_rt, jax_ot, np.zeros((1, 6), np.float32), device,
                                       scenes)
    require(n_unc == 1, "the JAX coplanar fixture is not flagged uncertain")
    max_err = max(max_err, err)

    # ---- 3b. The counter kernel against its twin, same pose rows. ----
    print("[3b] counter kernel vs twin on the card (exact: columns 0-6 on valid rows, "
          "0 and 3 on every row; colliding rows count at most the twin's)")
    stats_err = 0
    for name, prep, poses in scenes:
        got = mk.check_poses_stats_cuda(poses, prep)
        stats_err = max(stats_err, compare_stats(
            name, got, mk.check_poses_stats_reference(poses, prep)))
    print(f"  JAX coplanar fixture, card row [valid, coplanar, num_pairs, broad, nfull, "
          f"ngate, nrest, 0] = {got[0].tolist()}")
    fixture = MegaKernelChecker(jax_rt, jax_ot, device="cuda")
    zero = np.zeros((1, 6), np.float32)
    f_packed, f_valid = fixture.check_packed(zero)[0], fixture.check_valid_resolved(zero)[0]
    print(f"  JAX coplanar fixture on the card: packed byte {int(f_packed)}, "
          f"check_valid_resolved {bool(f_valid)} (the float64 oracle says colliding)")
    require(f_packed == 0b101 and not f_valid,
            "the JAX coplanar fixture does not resolve colliding on the card")

    # ---- 4. The main path. ----
    checker = MegaKernelChecker(robot, obstacle, device="cuda")
    print(f"[4] main path: MegaKernelChecker(device='cuda').check_valid_resolved; "
          f"float64 resolution by the {'native' if native.available() else 'numpy'} oracle")
    mk.check_poses_cuda.launches = 0
    resolved = {key: checker.check_valid_resolved(ds.confs) for key, ds in data.items()}
    torch.cuda.synchronize()
    launches = mk.check_poses_cuda.launches
    require(launches > 0, "the main path launched no kernel")
    for key, ds in data.items():
        packed = checker.check_packed(ds.confs)
        valid = (packed & 1) == 1
        n_cop = int((valid & ((packed & 2) > 0)).sum())
        n_unc = int((valid & ((packed & 4) > 0)).sum())
        n_res = int((valid & ((packed & 6) > 0)).sum())
        n_valid = int(resolved[key].sum())
        msg = (f"  {key}: {len(ds.confs)} rows, {n_valid} valid, {n_res} rows to float64 "
               f"resolution ({n_cop} by bit 1 coplanar, {n_unc} by bit 2 uncertain)")
        if key == "samples10k":
            print(f"{msg}, header says {ds.header_valid} valid")
            require(n_valid == ds.header_valid, f"{key}: valid count off the header")
        else:
            mism = int((resolved[key] != ds.valid).sum())
            print(f"{msg}, {mism} golden mismatches")
            require(mism == 0, f"{key}: {mism} golden mismatches")
    print(f"  kernel launches in the main path: {launches}")

    # ---- 5. Times. ----
    print(f"[5] times on {card}")
    for key in ("hard10k", "easy10k"):
        confs = data[key].confs
        s = benchmark(checker.check_valid_resolved, confs)
        print(f"  [{card}] {key}: check_valid_resolved best of 5 {s * 1e3} ms, "
              f"{len(confs) / s} checks/s")
    # The kernel and its twin at the main path's shape (all rows of a set in
    # one launch, as check_valid gives them), timed and then held against
    # each other like phase 3.
    tables = checker.tables
    times = {}
    for key in ("hard10k", "easy10k"):
        poses = mk.poses_from_confs(torch.from_numpy(data[key].confs).to(device))
        k_ms = event_ms(lambda: mk.check_poses_cuda(poses, tables), 20)
        p_ms = event_ms(lambda: mk.check_poses_reference(poses, tables), 1)
        got = mk.check_poses_cuda(poses, tables)
        want = mk.check_poses_reference(poses, tables)
        times[key] = (k_ms, p_ms)
        print(f"  [{card}] kernel alone, {key} {list(poses.shape)} poses: {k_ms} ms; "
              f"twin: {p_ms} ms")
        err, *_ = compare_bits(f"alpha {key} {list(poses.shape)}, kernel vs twin",
                               got, want)
        max_err = max(max_err, err)
    kernel_ms, plain_ms = times["hard10k"]

    # ---- 4b. The stats path. ----
    print("[4b] stats path: MegaKernelChecker(device='cuda').check, broad_block, "
          "check_valid(presort=True)")
    mk.check_poses_stats_cuda.launches = 0
    mk.check_poses_cuda.launches = 0
    checks = {(key, tp): checker.check(data[key].confs, two_phase=tp)
              for key in ("hard10k", "easy10k") for tp in (True, False)}
    presorted = {key: checker.check_valid(ds.confs, presort=True)
                 for key, ds in data.items()}
    torch.cuda.synchronize()
    stats_launches = mk.check_poses_stats_cuda.launches
    presort_launches = mk.check_poses_cuda.launches
    require(stats_launches > 0, "the stats path launched no counter kernel")
    for (key, tp), (valid, cop, pairs, broad) in checks.items():
        ref_valid, _ = checker.check_valid(data[key].confs)
        ref_broad = checker.broad_block(data[key].confs).cpu().numpy()
        print(f"  check({key}, two_phase={tp}): {int(valid.sum())} valid, "
              f"{int(broad.sum())} broad, {int(cop.sum())} coplanar, mean pairs on broad "
              f"rows {float(pairs[broad].mean())}")
        require(np.array_equal(valid, ref_valid), f"check({key}, {tp}): valid != check_valid")
        if tp:
            # check() returns broad_block's own mask here; hold the counter
            # kernel's broad column on the survivors to it instead.
            surv = np.flatnonzero(ref_broad)
            col = checker.check_block(data[key].confs[surv])[:, 3].cpu().numpy()
            require(bool((col == 1).all()), f"check({key}, True): the counter kernel's "
                    "broad column is 0 on a broad_block survivor")
        else:
            require(np.array_equal(broad, ref_broad),
                    f"check({key}, False): the counter kernel's broad != broad_block")
    for key, (v_sorted, c_sorted) in presorted.items():
        v_plain, c_plain = checker.check_valid(data[key].confs)
        print(f"  check_valid({key}, presort=True): {int(v_sorted.sum())} valid")
        require(np.array_equal(v_sorted, v_plain) and np.array_equal(c_sorted, c_plain),
                f"{key}: presort changes a verdict")
    print(f"  counter-kernel launches in the stats path: {stats_launches}; kernel "
          f"launches under presort: {presort_launches}")
    hard_poses = mk.poses_from_confs(torch.from_numpy(data["hard10k"].confs).to(device))
    stats_ms = event_ms(lambda: mk.check_poses_stats_cuda(hard_poses, tables), 20)
    stats_plain_ms = event_ms(lambda: mk.check_poses_stats_reference(hard_poses, tables), 1)
    hard_rows = mk.check_poses_stats_cuda(hard_poses, tables)
    hard_rows_twin = mk.check_poses_stats_reference(hard_poses, tables)
    print(f"  [{card}] counter kernel alone, hard10k {list(hard_poses.shape)}: {stats_ms} ms; "
          f"twin: {stats_plain_ms} ms")
    stats_err = max(stats_err, compare_stats("alpha hard10k, counter kernel vs twin",
                                             hard_rows, hard_rows_twin))
    hard_rows, hard_rows_twin = hard_rows.cpu().numpy(), hard_rows_twin.cpu().numpy()

    # ---- 6. The stage-decomposition surface. ----
    print(f"[6] stage variants on hard10k {list(hard_poses.shape)} and probe pieces")
    mk.check_poses_stage_cuda.launches = dict.fromkeys(mk.STAGES, 0)
    probes.reset_launches()
    stage_out = {s: mk.check_poses_stage_cuda(hard_poses, tables, s) for s in mk.STAGES}
    pieces = {st: probes.stage_pieces(st, device, tables.rob_base) for st in (1, 2, 3)}
    piece_out = {p.name: p.kernel() for st in pieces for p in pieces[st]}
    torch.cuda.synchronize()
    stage_launches = dict(mk.check_poses_stage_cuda.launches)
    probe_launches = {1: sum(probes.pose_probe_cuda.launches.values()),
                      2: probes.empty_probe_cuda.launches,
                      3: sum(probes.invariant_probe_cuda.launches.values())}
    print(f"  launches: stage variants {stage_launches}; probes P1 "
          f"{probes.pose_probe_cuda.launches}, P2 {probe_launches[2]}, P3 "
          f"{probes.invariant_probe_cuda.launches}")
    # Bounds of this run's work on hard10k: the packed and counter kernels
    # from the counter kernel's rows (what their any-hit exit needed), the
    # stage variants (no exit) from the twin's.
    rob_np = tables.rob_base.cpu().numpy()
    n_obs, n_groups = tables.obs.shape[0], tables.obs_groups.shape[0]

    def bound(rows, stage="full", out_bytes=1):
        ms, by = bounds.bound_ms(*bounds.check_work(rob_np, n_obs, n_groups, rows, stage,
                                                    out_bytes))
        return {"bound_ms": ms, "bound_by": by}

    # No single PyTorch call computes any of these functions: library_ms null.
    entries = [
        {"name": "megakernel", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
         "ms": kernel_ms, "plain_ms": plain_ms, **bound(hard_rows), "library_ms": None},
        {"name": "megakernel_stats", "route": "cuda", "source": SOURCE,
         "replaces": "robocheck_tpu/kernels/megakernel.py:1126", "launches": stats_launches,
         "max_abs_err": stats_err, "ms": stats_ms, "plain_ms": stats_plain_ms,
         **bound(hard_rows, out_bytes=4 * mk.OUT_COLS), "library_ms": None}]
    full_ms = event_ms(lambda: mk.check_poses_cuda(hard_poses, tables), 20)
    for stage, out in stage_out.items():
        require(stage_launches[stage] > 0, f"stage variant {stage} was not launched")
        err = int((out.int() - 1).abs().max())
        s_ms = event_ms(lambda: mk.check_poses_stage_cuda(hard_poses, tables, stage), 20)
        p_ms = event_ms(lambda: torch.ones_like(out), 20)
        print(f"  [{card}] {stage}: {s_ms} ms (full kernel {full_ms} ms on the same rows); "
              f"plain (the byte 1) {p_ms} ms; max abs err {err}")
        require(err == 0, f"stage variant {stage}: a row is not the byte 1")
        entries.append({"name": f"megakernel_{stage}", "route": "cuda", "source": SOURCE,
                        "replaces": STAGE_REPLACES[stage], "launches": stage_launches[stage],
                        "max_abs_err": err, "ms": s_ms, "plain_ms": p_ms,
                        **bound(hard_rows_twin, stage), "library_ms": None})
    for st, (name, timed, replaces) in PROBES.items():
        require(probe_launches[st] > 0, f"probe {name} was not launched")
        worst, timing = 0, None
        for piece in pieces[st]:
            err = int((piece_out[piece.name].long() - piece.plain().long()).abs().max())
            k_ms = event_ms(piece.kernel, 20)
            p_ms = event_ms(piece.plain, 2)
            print(f"  [{card}] {name} {piece.name} [{piece.n}]: {k_ms} ms, plain {p_ms} ms, "
                  f"max abs err {err}")
            require(err == 0, f"{name} {piece.name}: differs from its plain version")
            worst = max(worst, err)
            if piece.name == timed:
                timing = (k_ms, p_ms, piece.n)
        b_ms, b_by = bounds.bound_ms(*bounds.probe_work(timed, timing[2]))
        entries.append({"name": name, "route": "cuda", "source": PROBE_SOURCE,
                        "replaces": replaces, "launches": probe_launches[st],
                        "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1],
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                        "piece": timed})

    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
