"""GPU smoke check of the PyTorch/CUDA port (`robocheck_tpu_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:
  1. the card: name, and `nvidia-smi` name and power limit;
  2. build the CUDA kernel from `robocheck_tpu_torch/csrc/megakernel.cu`
     (sm_90a, -fmad=false) and print the ptxas register / shared-memory /
     spill lines;
  3. the kernel against its plain PyTorch twin on the card, on the same pose
     rows: alpha-1.0 meshes over hard10k[:2048] and easy10k[:2048], two
     icosphere scenes (one with a 2200-triangle soup obstacle), the
     tetrahedra fixture and two coplanar fixtures. `valid`
     must be identical on every row, `coplanar` on every valid row (the
     tolerance is exact: both compute the same float32 operations);
  4. the main path, `MegaKernelChecker(..., device="cuda").check_valid_resolved`,
     on all 10,000 rows of hard10k and easy10k (0 golden mismatches each) and
     of 10,000samples (7296 valid, the file header's count), with the
     kernel's launch counter above 0;
  5. times: end-to-end checks/s (best of 5 after a warm-up, each run ending
     in torch.cuda.synchronize()), and the kernel alone and its twin alone
     at the main path's shape, all 10,000 rows of hard10k and of easy10k in
     one launch (CUDA events); their outputs are held against each other as
     in phase 3.
The line before the last is the kernel table as JSON; the last line is the
result as JSON. Without a CUDA device, or without the package beside it, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPLACES = "robocheck_tpu/kernels/megakernel.py:358"
SOURCE = "robocheck_tpu_torch/csrc/megakernel.cu"


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int):
    """(mean device time of one call over `reps` calls with CUDA events, the
    last call's result)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def best_seconds(fn, runs: int = 5) -> float:
    """Host time of the best of `runs` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def compare_on_card(mk, name, robot, obstacle, confs, device):
    """Phase 3 for one scene: the kernel and its twin on the same pose rows."""
    prep = mk.MegaKernelPrep.build(robot, obstacle).to(device)
    poses = mk.poses_from_confs(torch.from_numpy(confs).to(device))
    return compare_bits(name, mk.check_poses_cuda(poses, prep),
                        mk.check_poses_reference(poses, prep))


def compare_bits(name, got, want):
    """Kernel bytes `got` against twin bytes `want`: `valid` identical on every
    row, `coplanar` on every valid row. Returns (max abs difference of the
    compared bits, valid rows, coplanar-flagged valid rows)."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    v_got, v_want = got & 1, want & 1
    c_got, c_want = got >> 1, want >> 1
    valid = v_want == 1
    err = max(int(np.abs(v_got.astype(int) - v_want).max()),
              int(np.abs(c_got[valid].astype(int) - c_want[valid]).max(initial=0)))
    print(f"  {name}: {len(got)} rows, valid kernel/twin "
          f"{int(v_got.sum())}/{int(v_want.sum())}, coplanar on valid rows "
          f"{int(c_got[valid].sum())}/{int(c_want[valid].sum())}, max abs err {err}")
    require(np.array_equal(v_got, v_want), f"{name}: valid differs from the twin")
    require(np.array_equal(c_got[valid], c_want[valid]),
            f"{name}: coplanar differs from the twin on valid rows")
    return err, int(valid.sum()), int(c_want[valid].sum())


def main() -> None:
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from robocheck_tpu_torch import MegaKernelChecker, load_obj, read_conf_file
    from robocheck_tpu_torch.core.types import Mesh
    from robocheck_tpu_torch.io import assets
    from robocheck_tpu_torch.kernels import _build
    from robocheck_tpu_torch.kernels import megakernel as mk
    from robocheck_tpu_torch.models.shapes import box, icosphere, tetrahedron, triangle_soup
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
    path, log = _build.build()
    _build.library()
    print(f"[2] built {path.name} in {time.perf_counter() - t0:.1f} s "
          f"({' '.join(_build.NVCC_FLAGS)})")
    for line in log.splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "stack frame")):
            print(f"  {line.strip()}")

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    data = {key: read_conf_file(assets.dataset_path(key))
            for key in ("hard10k", "easy10k", "samples10k")}

    # ---- 3. Kernel against its twin, same pose rows. ----
    print("[3] kernel vs twin on the card (exact: valid on every row, "
          "coplanar on valid rows)")
    max_err = 0
    for key in ("hard10k", "easy10k"):
        err, _, _ = compare_on_card(mk, f"alpha {key}[:2048]", robot, obstacle,
                                    data[key].confs[:2048], device)
        max_err = max(max_err, err)
    rng = np.random.default_rng(77)
    sphere = np.zeros((256, 6), np.float32)
    sphere[:, 0] = rng.uniform(0.0, 3.0, 256)
    sphere[:, 3:6] = rng.uniform(-np.pi, np.pi, (256, 3))
    err, _, _ = compare_on_card(mk, "icospheres r1.0/r1.5", icosphere(1, 1.0),
                                icosphere(1, 1.5), sphere, device)
    max_err = max(max_err, err)
    # 40 robot tiles x 18 obstacle groups: the gate's compaction takes
    # three rounds (the alpha pair fits one).
    soup = triangle_soup(np.random.default_rng(508), 2200, extent=1.0)
    soup_confs = np.random.default_rng(5).uniform(-1.5, 1.5, (512, 6)).astype(np.float32)
    err, n_valid, _ = compare_on_card(mk, "icosphere(3) in a 2200-triangle soup",
                                      icosphere(3, 0.3), soup, soup_confs, device)
    require(0 < n_valid < len(soup_confs), "soup scene: expected both verdicts")
    max_err = max(max_err, err)
    tet = tetrahedron()
    tet_obs = Mesh(np.array([[1, 0.1, 0], [1.5, 1, 2.2], [1, 2.4, 0], [3.3, 2, 2]],
                            np.float32), tet.triangles, "obs-tetra")
    tet_confs = np.zeros((2, 6), np.float32)
    tet_confs[1, 0] = 100.0
    err, n_valid, _ = compare_on_card(mk, "tetrahedra", tet, tet_obs, tet_confs, device)
    require(n_valid == 1, "tetrahedra: expected row 0 colliding, row 1 clear")
    max_err = max(max_err, err)
    cop_confs = np.zeros((8, 6), np.float32)
    cop_confs[:, 0:3] = [[6.0e3, 1.8e4, 1.0e4], [6.0e3 + 0.5, 1.8e4, 1.0e4],
                         [2.0e4 - 10.0, 1.9e4, 1.99e4], [0.0, 1.99e4, 5.0],
                         [6.0e3, 1.8e4, 1.0e4 - 2.0], [0.0, 5.0e3, 5.0e3],
                         [1.0, 5.0e3, 5.0e3], [9.0e5, 9.0e5, 9.0e5]]
    cop_confs[:, 3:6] = np.random.default_rng(3).uniform(-np.pi, np.pi, (8, 3))
    err, _, n_cop = compare_on_card(mk, "unit box on 1e4 tetrahedron (coplanar)",
                                    box(extent=(2.0, 2.0, 2.0)),
                                    tetrahedron(scale=1.0e4), cop_confs, device)
    require(n_cop > 0, "coplanar fixture flagged no valid row coplanar")
    max_err = max(max_err, err)
    one = np.array([[0, 1, 2]], np.int32)
    face_r = np.array([[-172.35173, 118.57849, -337.86478], [-168.62619, 71.0307, -215.03616],
                       [-280.98154, 165.06941, -53.021297]], np.float32)
    face_o = np.array([[-148.91972, 43.489243, -211.57489], [-222.59364, 145.73175, -222.42876],
                       [-204.12267, 60.86192, -48.782146]], np.float32)
    err, _, n_cop = compare_on_card(mk, "face on face (coplanar)", Mesh(face_r, one),
                                    Mesh(face_o, one), np.zeros((1, 6), np.float32), device)
    require(n_cop == 1, "face-on-face fixture not flagged coplanar")
    max_err = max(max_err, err)

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
        valid, cop = checker.check_valid(ds.confs)
        n_res = int((valid & cop).sum())
        n_valid = int(resolved[key].sum())
        msg = (f"  {key}: {len(ds.confs)} rows, {n_valid} valid, "
               f"{n_res} rows to float64 resolution")
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
        s = best_seconds(lambda: checker.check_valid_resolved(confs))
        print(f"  [{card}] {key}: check_valid_resolved best of 5 {s * 1e3} ms, "
              f"{len(confs) / s} checks/s")
    # The kernel and its twin at the main path's shape (all rows of a set in
    # one launch, as check_valid gives them), timed and then held against
    # each other like phase 3.
    tables = checker.tables
    times = {}
    for key in ("hard10k", "easy10k"):
        poses = mk.poses_from_confs(torch.from_numpy(data[key].confs).to(device))
        k_ms, got = cuda_ms(lambda: mk.check_poses_cuda(poses, tables), reps=20)
        p_ms, want = cuda_ms(lambda: mk.check_poses_reference(poses, tables), reps=1)
        times[key] = (k_ms, p_ms)
        print(f"  [{card}] kernel alone, {key} {list(poses.shape)} poses: {k_ms} ms; "
              f"twin: {p_ms} ms")
        err, _, _ = compare_bits(f"alpha {key} {list(poses.shape)}, kernel vs twin",
                                 got, want)
        max_err = max(max_err, err)
    kernel_ms, plain_ms = times["hard10k"]

    print(json.dumps({"kernels": [{
        "name": "megakernel", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
