"""ctypes binding to the native float64 oracle (`native/robocheck_native.cpp`,
the same shared library the JAX package binds).

Build with ``make -C native`` (or ``start_build`` / ``finish_build``). The
library is an accelerator, not a dependency: `oracle.check_configs` falls
back to the NumPy oracle when
``available()`` is false. Bound here: the oracle, the point-to-mesh
distance query (`rc_point_mesh_dist`, the float64 BVH that the clearance
engine is held against and the certifier's ``native`` backend) and the
library's `.conf` / `.obj` parsers and `.conf` writer (``parse_conf``,
``write_conf``, ``parse_obj``), which read and write what `io.conf` and
`io.obj` do.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
# A user-supplied library (env var) always wins over the in-repo build.
_LIB_PATHS = [
    Path(os.environ.get("ROBOCHECK_NATIVE_LIB", "")) if os.environ.get(
        "ROBOCHECK_NATIVE_LIB") else None,
    _REPO_ROOT / "native" / "librobocheck_native.so",
]

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    for p in _LIB_PATHS:
        if p and p.exists():
            try:
                lib = ctypes.CDLL(str(p))
            except OSError:
                continue
            lib.rc_parse_conf.restype = ctypes.c_int64
            lib.rc_parse_conf.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64,
            ]
            lib.rc_write_conf.restype = ctypes.c_int64
            lib.rc_write_conf.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64,
            ]
            lib.rc_parse_obj.restype = ctypes.c_int64
            lib.rc_parse_obj.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.rc_oracle_check.restype = ctypes.c_int64
            lib.rc_oracle_check.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p,
            ]
            try:
                lib.rc_point_mesh_dist.restype = ctypes.c_int64
                lib.rc_point_mesh_dist.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_void_p,
                ]
            except AttributeError:
                pass  # a stale build without the distance query
            _lib = lib
            break
    return _lib


def available() -> bool:
    return _load() is not None


def library_path() -> Path | None:
    """The file of the loaded library, or None when none loads."""
    lib = _load()
    return None if lib is None else Path(lib._name)


def has_point_mesh_dist() -> bool:
    """False for a stale build of the library without the distance query."""
    lib = _load()
    return lib is not None and hasattr(lib, "rc_point_mesh_dist")


def start_build() -> subprocess.Popen:
    """Start ``make -C native`` (g++; the in-repo library) in the background;
    ``finish_build`` waits for it."""
    return subprocess.Popen(["make", "-C", str(_REPO_ROOT / "native")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_build(proc: subprocess.Popen) -> None:
    """Wait for ``start_build``'s make; raise if it failed, else bind the
    library anew."""
    global _lib, _tried
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"make -C native failed with exit code {proc.returncode}:\n{log}")
    _lib, _tried = None, False


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _require_lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built (make -C native)")
    return lib


def parse_conf(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """A `.conf` file -> (confs [N,6] f32, valid [N] bool, or None where the
    rows are untagged)."""
    lib = _require_lib()
    n = lib.rc_parse_conf(str(path).encode(), None, None, 0)
    if n < 0:
        raise FileNotFoundError(path)
    confs = np.empty((n, 6), dtype=np.float32)
    valid = np.empty((n,), dtype=np.int8)
    got = lib.rc_parse_conf(str(path).encode(), _ptr(confs), _ptr(valid), n)
    if got != n:
        raise RuntimeError(f"native parser read {got} of {n} rows of {path}")
    if n and (valid < 0).any():
        return confs, None
    return confs, valid.astype(bool)


def write_conf(path: str, confs: np.ndarray, valid: np.ndarray) -> None:
    """Write [N,6] configurations and their [N] tags as a `.conf` file (the
    header counts the valid rows)."""
    lib = _require_lib()
    confs = np.ascontiguousarray(confs, dtype=np.float32)
    valid = np.ascontiguousarray(valid, dtype=np.int8)
    if lib.rc_write_conf(str(path).encode(), _ptr(confs), _ptr(valid), confs.shape[0]) < 0:
        raise IOError(f"cannot write {path}")


def parse_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """A Wavefront `.obj` file -> (vertices [V,3] f32, triangles [T,3] i32)."""
    lib = _require_lib()
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    if lib.rc_parse_obj(str(path).encode(), None, None, 0, 0,
                        ctypes.byref(nv), ctypes.byref(nt)) < 0:
        raise FileNotFoundError(path)
    verts = np.empty((nv.value, 3), dtype=np.float32)
    tris = np.empty((nt.value, 3), dtype=np.int32)
    r = lib.rc_parse_obj(str(path).encode(), _ptr(verts), _ptr(tris), nv.value, nt.value,
                         ctypes.byref(nv), ctypes.byref(nt))
    if r < 0:
        raise IOError(f"failed parsing {path} ({r})")
    return verts, tris


def oracle_check(rob_verts: np.ndarray, rob_tris: np.ndarray,
                 obs_verts: np.ndarray, obs_tris: np.ndarray,
                 confs: np.ndarray) -> np.ndarray:
    """Native double-precision oracle; returns valid[N] bool."""
    lib = _require_lib()
    rv = np.ascontiguousarray(rob_verts, dtype=np.float64)
    rt = np.ascontiguousarray(rob_tris, dtype=np.int32)
    ov = np.ascontiguousarray(obs_verts, dtype=np.float64)
    ot = np.ascontiguousarray(obs_tris, dtype=np.int32)
    cf = np.ascontiguousarray(confs, dtype=np.float32)
    n = cf.shape[0]
    out = np.empty((n,), dtype=np.int8)
    got = lib.rc_oracle_check(
        _ptr(rv), _ptr(rt), rv.shape[0], rt.shape[0],
        _ptr(ov), _ptr(ot), ov.shape[0], ot.shape[0],
        _ptr(cf), n, _ptr(out),
    )
    if got != n:
        raise RuntimeError(f"native oracle checked {got} of {n} configurations")
    return out.astype(bool)


def point_mesh_dist(verts: np.ndarray, tris: np.ndarray,
                    points: np.ndarray) -> np.ndarray:
    """Exact unsigned min distance from each point to the mesh surface
    (native BVH, best-first, float64). Returns dist[N] f64."""
    lib = _load()
    if lib is None or not hasattr(lib, "rc_point_mesh_dist"):
        raise RuntimeError("native library not built (make -C native)")
    v = np.ascontiguousarray(verts, dtype=np.float64)
    t = np.ascontiguousarray(tris, dtype=np.int32)
    p = np.ascontiguousarray(points, dtype=np.float64).reshape(-1, 3)
    out = np.empty((p.shape[0],), dtype=np.float64)
    got = lib.rc_point_mesh_dist(_ptr(v), _ptr(t), v.shape[0], t.shape[0],
                                 _ptr(p), p.shape[0], _ptr(out))
    if got != p.shape[0]:
        raise RuntimeError(f"native distance query answered {got} of {p.shape[0]} points")
    return out
