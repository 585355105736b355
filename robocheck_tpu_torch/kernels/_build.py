"""Build `csrc/megakernel.cu` with nvcc and bind it with ctypes.

The kernel is compiled at first use into ``build/robocheck_tpu_torch/`` at
the repository root, under a name keyed by the source and the flags, so an
edited source is never served from a stale build. A plain ``extern "C"``
interface keeps the build to seconds (no PyTorch headers).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "megakernel.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "robocheck_tpu_torch"
# -fmad=false: the TOL-band math rounds every multiply and add on its own.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put nvcc on PATH")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


@functools.cache
def build() -> tuple[Path, str]:
    """Compile the kernel if needed; returns (shared library, nvcc log with
    the -Xptxas -v register, shared-memory and spill lines)."""
    key = hashlib.sha256(_SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"megakernel-{key.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                               f"{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return lib, log.read_text()


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, with its entry points' C signatures."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.rc_megakernel_check.restype = i32
    lib.rc_megakernel_check.argtypes = [ptr, i64, ptr, i32, ptr, i32, ptr, ptr,
                                        i32, ptr, ptr]
    lib.rc_megakernel_smem_bytes.restype = i64
    lib.rc_megakernel_smem_bytes.argtypes = [i32, i32]
    lib.rc_error_string.restype = ctypes.c_char_p
    lib.rc_error_string.argtypes = [i32]
    return lib
