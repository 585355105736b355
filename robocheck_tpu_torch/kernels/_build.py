"""Build the CUDA sources of `csrc/` with nvcc and bind them with ctypes.

Each source (`megakernel.cu`, the fused check; `stage_probes.cu`, its probe
kernels; `clearance.cu`, the clearance engine's exact scan and the distance
grid; `front.cu`, the check's pose rows and robot box; `resolve.cu`, the
float64 resolution of flagged rows) is compiled at first use into
``build/robocheck_tpu_torch/`` at the repository root,
all nvcc processes started together, under names keyed by
every source and the flags, so an edited source is never served from a stale
build. Plain ``extern "C"`` interfaces keep each build to seconds (no PyTorch
headers). ``copy_library`` builds another copy of `megakernel.cu` (an older
revision, or another block geometry, for timing two designs in one process)
the same way; ``build_copies`` compiles several at once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = {"megakernel": _CSRC / "megakernel.cu",
           "stage_probes": _CSRC / "stage_probes.cu",
           "clearance": _CSRC / "clearance.cu",
           "front": _CSRC / "front.cu",
           "resolve": _CSRC / "resolve.cu"}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "robocheck_tpu_torch"
# -fmad=false: the TOL-band math and the clearance scan round every multiply
# and add on its own, as their PyTorch twins do.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put nvcc on PATH")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _compile(todo: dict[str, tuple[Path, Path]]) -> None:
    """Run nvcc on each {name: (source, library)} at once; keeps each log
    beside its library. Raises if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, lib) in todo.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        src, lib = todo[name]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} with exit code "
                          f"{proc.returncode}:\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def build() -> dict[str, tuple[Path, str]]:
    """Compile every source not yet built; returns {name: (shared library,
    nvcc log with the -Xptxas -v register, shared-memory and spill lines)}."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(SOURCES):
        key.update(name.encode() + SOURCES[name].read_bytes())
    libs = {name: BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so" for name in SOURCES}
    todo = {name: (SOURCES[name], lib) for name, lib in libs.items() if not lib.exists()}
    if todo:
        _compile(todo)
    return {name: (lib, lib.with_suffix(".log").read_text()) for name, lib in libs.items()}


def _bind(fn, restype, argtypes) -> None:
    fn.restype = restype
    fn.argtypes = argtypes


def _bind_megakernel(lib: ctypes.CDLL) -> None:
    """Bind the fused kernel's entry points. ``lib.takes_work``: whether they
    take the row-counter scratch after ``out`` (copies built from sources
    older than `rc_megakernel_blocks_per_sm` do not); ``lib.takes_nonfinite``:
    whether they take the non-finite row counter after it (a null pointer
    counts nothing; copies older than `rc_megakernel_counts_nonfinite` do
    not)."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.takes_work = hasattr(lib, "rc_megakernel_blocks_per_sm")
    lib.takes_nonfinite = hasattr(lib, "rc_megakernel_counts_nonfinite")
    # poses, n, rob_base, tr, obs, to, obs_mesh, obs_groups, n_groups, out[,
    # work[, nonfinite]]
    check = ([ptr, i64, ptr, i32, ptr, i32, ptr, ptr, i32, ptr]
             + [ptr] * (lib.takes_work + lib.takes_nonfinite))
    _bind(lib.rc_megakernel_check, i32, check + [ptr])
    _bind(lib.rc_megakernel_check_stats, i32, check + [ptr])
    _bind(lib.rc_megakernel_check_stage, i32, check + [i32, i32, ptr])
    _bind(lib.rc_megakernel_smem_bytes, i64, [i32, i32])
    _bind(lib.rc_error_string, ctypes.c_char_p, [i32])
    if lib.takes_work:
        _bind(lib.rc_megakernel_blocks_per_sm, i32, [i32, i32])
    if hasattr(lib, "rc_smem_optin_bytes"):
        _bind(lib.rc_smem_optin_bytes, i32, [])


def _bind_resolve(lib: ctypes.CDLL) -> None:
    """Bind the resolution kernel's entry points (`csrc/resolve.cu`)."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # packed, confs, n, rob_verts, nrv, rob_tris, nrt, obs_tri, nto, boxes32, ng,
    # obs_mesh, out, counts, stream
    _bind(lib.rc_resolve, i32,
          [ptr, ptr, i64, ptr, i32, ptr, i32, ptr, i32, ptr, i32, ptr, ptr, ptr, ptr])
    _bind(lib.rc_resolve_error_string, ctypes.c_char_p, [i32])


@functools.cache
def library(name: str = "megakernel") -> ctypes.CDLL:
    """The built library ``name`` (a key of SOURCES), with its entry points'
    C signatures (pointers and the stream as c_void_p)."""
    path, _ = build()[name]
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    if name == "megakernel":
        _bind_megakernel(lib)
    elif name == "stage_probes":
        # probe, tr, to, n_groups, tables, scratch, cpb (, out, cap)
        _bind(lib.rc_probe_map, i32, [i32] * 7 + [ptr, i32])
        # probe, variant, n, smem, resident, out
        _bind(lib.rc_probe_shape, i32, [i32, i32, i64, i64, i32, ptr])
        # poses, n, rob_base, tr, n_groups, level, rt_false, out, work, smem,
        # resident, stream
        _bind(lib.rc_pose_probe, i32,
              [ptr, i64, ptr, i32, i32, i32, i32, ptr, ptr, i64, i32, ptr])
        # poses, n, rob, tr, obs, to, groups, n_groups, scratch, cpb, out,
        # work, smem, resident, stream
        _bind(lib.rc_empty_probe, i32,
              [ptr, i64, ptr, i32, ptr, i32, ptr, i32, i32, i32, ptr, ptr, i64, i32, ptr])
        # poses, n, table, table_floats, mode, tr, n_groups, out, work, smem,
        # resident, stream
        _bind(lib.rc_invariant_probe, i32,
              [ptr, i64, ptr, i32, i32, i32, i32, ptr, ptr, i64, i32, ptr])
    elif name == "clearance":
        # rows, ids, k, blocks, nb, block, tab, nt, gbox, always, ng, gsize,
        # slack, out, visits, kept, tasks, scratch, stream
        _bind(lib.rc_clearance_pair_min, i32,
              [ptr, ptr, i64, ptr, i32, i32, ptr, i32, ptr, ptr, i32, i32, ctypes.c_float,
               ptr, ptr, ptr, ptr, ptr, ptr])
        _bind(lib.rc_clearance_smem_bytes, i64, [i32])
        # ax, ay, az, nx, ny, nz, gtab, nt, gbox, always, rslack, ng, slack,
        # signed_, dx, dy, dz, out, counts, scratch, scratch_bytes, stream
        f32 = ctypes.c_float
        _bind(lib.rc_sdf_grid, i32,
              [ptr, ptr, ptr, i32, i32, i32, ptr, i32, ptr, ptr, ptr, i32, f32, i32, f32, f32,
               f32, ptr, ptr, ptr, i64, ptr])
        _bind(lib.rc_sdf_grid_scratch_bytes, i64, [i32, i32, i32, i32])
        _bind(lib.rc_clearance_error_string, ctypes.c_char_p, [i32])
    elif name == "front":
        # confs, n, out, stream; poses, n, verts, nv, padded, obs_box,
        # out_box, out_hit, stream
        _bind(lib.rc_pose_rows, i32, [ptr, i64, ptr, ptr])
        _bind(lib.rc_robot_bounds, i32, [ptr, i64, ptr, i32, i32, ptr, ptr, ptr, ptr])
        _bind(lib.rc_front_error_string, ctypes.c_char_p, [i32])
    elif name == "resolve":
        _bind_resolve(lib)
    return lib


def copy_path(src: Path) -> Path:
    """The library a copy of `megakernel.cu` at ``src`` is built into."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + src.read_bytes()).hexdigest()
    return BUILD_DIR / f"copy-{src.stem}-{key[:16]}.so"


def build_copies(sources) -> None:
    """Compile every copy of `megakernel.cu` in ``sources`` not yet built,
    all nvcc processes started together (``copy_library`` then loads them)."""
    todo = {}
    for source in sources:
        src = Path(source).resolve()
        if not copy_path(src).exists():
            todo[src.stem] = (src, copy_path(src))
    if todo:
        _compile(todo)


@functools.cache
def copy_library(source: str) -> tuple[ctypes.CDLL, str]:
    """Another copy of `megakernel.cu` at ``source`` (same C interface, at
    least `rc_megakernel_check`), built with NVCC_FLAGS under a name keyed by
    its content; returns (library, nvcc log)."""
    src = Path(source).resolve()
    lib = copy_path(src)
    if not lib.exists():
        _compile({src.stem: (src, lib)})
    out = ctypes.CDLL(str(lib))
    _bind_megakernel(out)
    return out, lib.with_suffix(".log").read_text()
