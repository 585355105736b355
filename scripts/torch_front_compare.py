#!/usr/bin/env python3
"""Time other builds of the check's front end, K2 (the pose rows) and K5 (the
robot box and mesh-box test), against the package's `csrc/front.cu`, in
turns, in one process on one CUDA card, every build with the package's nvcc
flags:
  * ``--old``: another copy of that source with the C interface before
    the vertex table (K5 over the corner table rob_base [10, Tr]);
  * ``--rows R ...``: copies of the package's source with K5's rows per warp
    defined as R (`RC_BOX_ROWS`, 1-4; the shipped build's is 3).

    mkdir -p build/front_old
    git show <rev>:robocheck_tpu_torch/csrc/front.cu > build/front_old/front.cu
    python3 scripts/torch_front_compare.py --old build/front_old/front.cu --rows 1 2 4

For the alpha-1.0 pair on the first 2,048, 16,384 and 100,000 rows of
hard100k (hard10k repeated where the 100k set has not been made), it
  * checks that every build's pose rows are bit-equal and its boxes equal
    as values (NaN for NaN) with identical hit bytes;
  * times each kernel by its device duration from a trace
    (`timers.kernel_ms`, the summed kernel spans of REPS calls): the old
    design in the order old, new, new, old, with the new design's speed-up
    (old mean / new mean) and each one's share of its bound
    (`profiling.bounds`; K5's vertex bound, with the corner bound beside
    it); the R copies of K5 in the order shipped, copies, copies reversed,
    shipped, with each one's mean and share of the vertex bound;
  * prints the ptxas lines (registers, spills, shared memory) of every build.
Every line carries the card's name and power limit. Imports neither JAX nor
the JAX package.
"""
import argparse
import ctypes
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from robocheck_tpu_torch import MegaKernelChecker, load_obj, read_conf_file  # noqa: E402
from robocheck_tpu_torch.io import assets  # noqa: E402
from robocheck_tpu_torch.kernels import _build, front  # noqa: E402
from robocheck_tpu_torch.kernels import megakernel as mk  # noqa: E402
from robocheck_tpu_torch.profiling import bounds  # noqa: E402
from robocheck_tpu_torch.profiling.timers import card_line, kernel_ms  # noqa: E402

REPS = 20  # calls per traced mean
SIZES = (2048, 16384, 100000)


def old_library(source: Path) -> tuple[ctypes.CDLL, str]:
    """The other copy of front.cu, built with the package's flags and bound
    with the corner-table signatures."""
    _build.build_copies([source])
    path = _build.copy_path(source.resolve())
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.rc_pose_rows.restype = i32
    lib.rc_pose_rows.argtypes = [ptr, i64, ptr, ptr]
    lib.rc_robot_bounds.restype = i32
    lib.rc_robot_bounds.argtypes = [ptr, i64, ptr, i32, ptr, ptr, ptr, ptr]
    return lib, path.with_suffix(".log").read_text()


def rows_libraries(rows: list[int]) -> dict[int, tuple[ctypes.CDLL, str]]:
    """Copies of the package's front.cu with RC_BOX_ROWS defined as each R,
    compiled at once, bound with the package's K5 signature."""
    out_dir = REPO / "build" / "front_rows"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = _build.SOURCES["front"].read_text()
    sources = {}
    for r in rows:
        if not 1 <= r <= 4:
            raise ValueError(f"--rows takes 1, 2, 3 or 4, got {r}")
        sources[r] = out_dir / f"front_r{r}.cu"
        sources[r].write_text(f"#define RC_BOX_ROWS {r}\n" + text)
    _build.build_copies(sources.values())
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    libs = {}
    for r, src in sources.items():
        path = _build.copy_path(src.resolve())
        lib = ctypes.CDLL(str(path))
        lib.rc_robot_bounds.restype = i32
        lib.rc_robot_bounds.argtypes = [ptr, i64, ptr, i32, i32, ptr, ptr, ptr, ptr]
        libs[r] = lib, path.with_suffix(".log").read_text()
    return libs


def ptxas_lines(log: str) -> list[str]:
    return [ln.strip() for ln in log.splitlines()
            if any(w in ln for w in ("Compiling entry", "registers", "spill"))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="a copy of front.cu with the corner-table C interface")
    ap.add_argument("--rows", type=int, nargs="+", default=[],
                    help="K5 rows per warp to build copies at (1-4)")
    args = ap.parse_args()
    if not (args.old or args.rows):
        ap.error("give --old, --rows or both")
    if not torch.cuda.is_available():
        print("torch_front_compare: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    old, old_log = old_library(Path(args.old)) if args.old else (None, "")
    copies = rows_libraries(args.rows)
    print(json.dumps({"card": card, "old": args.old, "old_ptxas": ptxas_lines(old_log),
                      "new_ptxas": ptxas_lines(_build.build()["front"][1]),
                      "rows_ptxas": {r: ptxas_lines(log) for r, (_, log) in copies.items()}}))
    checker = MegaKernelChecker(load_obj(assets.alpha_robot_path()),
                                load_obj(assets.alpha_obstacle_path()), device="cuda")
    t = checker.tables
    rob_np, nv = t.rob_base.cpu().numpy(), t.rob_verts.shape[1]
    try:
        rows, source = read_conf_file(assets.dataset_path("hard100k")).confs, "hard100k"
    except FileNotFoundError:
        rows = np.tile(read_conf_file(assets.dataset_path("hard10k")).confs, (10, 1))
        source = "hard10k x 10"
    stream = torch.cuda.current_stream

    def old_k2(x):
        out = torch.empty((x.shape[0], 16), dtype=torch.float32, device=x.device)
        if old.rc_pose_rows(x.data_ptr(), x.shape[0], out.data_ptr(), stream().cuda_stream):
            raise RuntimeError("the old rc_pose_rows failed")
        return out

    def old_k5(poses):
        n = poses.shape[0]
        box = torch.empty((n, 6), dtype=torch.float32, device=poses.device)
        hit = torch.empty((n,), dtype=torch.uint8, device=poses.device)
        if old.rc_robot_bounds(poses.data_ptr(), n, t.rob_base.data_ptr(), t.rob_base.shape[1],
                               t.obs_mesh.data_ptr(), box.data_ptr(), hit.data_ptr(),
                               stream().cuda_stream):
            raise RuntimeError("the old rc_robot_bounds failed")
        return box, hit.view(torch.bool)

    def copy_k5(lib, poses):
        n = poses.shape[0]
        box = torch.empty((n, 6), dtype=torch.float32, device=poses.device)
        hit = torch.empty((n,), dtype=torch.uint8, device=poses.device)
        if lib.rc_robot_bounds(poses.data_ptr(), n, t.rob_verts.data_ptr(), nv,
                               int(t.rob_padded), t.obs_mesh.data_ptr(), box.data_ptr(),
                               hit.data_ptr(), stream().cuda_stream):
            raise RuntimeError("a copy's rc_robot_bounds failed")
        return box, hit.view(torch.bool)

    def new_k5(poses):
        return front.robot_bounds_cuda(poses, t.rob_verts, t.obs_mesh, padded=t.rob_padded)

    def same_box(a, b):
        (ba, ha), (bb, hb) = a, b
        return bool(((ba == bb) | (ba.isnan() & bb.isnan())).all()) and torch.equal(ha, hb)

    for n in SIZES:
        x = torch.from_numpy(np.ascontiguousarray(rows[:n])).cuda()
        poses = mk.poses_from_confs_reference(x)
        vertex_b = bounds.bound_ms(*bounds.robot_bounds_work(rob_np, n, True, nv=nv))
        corner_b = bounds.bound_ms(*bounds.robot_bounds_work(rob_np, n, True))[0]
        if old is not None:
            same_k2 = torch.equal(old_k2(x).view(torch.int32),
                                  front.poses_from_confs_cuda(x).view(torch.int32))
            runs = {"pose_rows": (lambda: old_k2(x), lambda: front.poses_from_confs_cuda(x),
                                  same_k2, bounds.bound_ms(*bounds.pose_rows_work(n))),
                    "robot_bounds": (lambda: old_k5(poses), lambda: new_k5(poses),
                                     same_box(old_k5(poses), new_k5(poses)), vertex_b)}
            for name, (run_old, run_new, same, (b_ms, b_by)) in runs.items():
                turns = [kernel_ms(f, REPS) for f in (run_old, run_new, run_new, run_old)]
                old_ms, new_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                line = {"card": card, "kernel": name, "rows": n, "source": source,
                        "equal": same, "ms_old_new_new_old": turns,
                        "speedup": old_ms / new_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "share_old": b_ms / old_ms, "share_new": b_ms / new_ms}
                if name == "robot_bounds":
                    line["corner_bound_ms"] = corner_b
                print(json.dumps(line))
                if not same:
                    print(f"torch_front_compare: {name} differs between the designs on {n} "
                          "rows", file=sys.stderr)
                    return 1
        if copies:
            want = new_k5(poses)
            same = {r: same_box(copy_k5(lib, poses), want) for r, (lib, _) in copies.items()}
            order = [None, *copies, *reversed(copies), None]
            turns = [kernel_ms((lambda: new_k5(poses)) if r is None
                               else (lambda lib=copies[r][0]: copy_k5(lib, poses)), REPS)
                     for r in order]
            ms = {"shipped": (turns[0] + turns[-1]) / 2}
            for r in copies:
                ms[r] = sum(v for k, v in zip(order, turns) if k == r) / 2
            print(json.dumps({"card": card, "kernel": "robot_bounds", "rows": n,
                              "source": source, "equal": same, "order": order,
                              "ms_turns": turns, "ms_by_rows_per_warp": ms,
                              "bound_ms": vertex_b[0], "bound_by": vertex_b[1],
                              "share": {k: vertex_b[0] / v for k, v in ms.items()}}))
            if not all(same.values()):
                print(f"torch_front_compare: a copy's K5 differs on {n} rows", file=sys.stderr)
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
