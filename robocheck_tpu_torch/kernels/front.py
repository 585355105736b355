"""The check's front end on the card: the CUDA kernels of `csrc/front.cu`.

  * ``poses_from_confs_cuda`` (K2, the JAX package's `poses_from_confs`,
    `megakernel.py:1099`): [B,6] configurations -> [B,16] pose rows, bit
    for bit `megakernel.poses_from_confs_reference` on the same card;
  * ``robot_bounds_cuda`` (K5, `_robot_bounds` / `_broad_overlap`,
    `megakernel.py:1209-1248`): [B,16] pose rows and the robot's vertex
    table [3, nv] (`megakernel.robot_vertices`, built once per robot table
    by `MegaKernelPrep.to`) -> the [B,6] box (lo x,y,z, hi x,y,z) of the
    posed robot's real triangles and, given an obstacle box [6], the [B]
    bool closed-interval overlap with it; `robot_bounds_vertices_reference`
    and `robot_bounds_reference` / `mesh_broad_reference` as values (a min
    of -0.0 and +0.0 may be either zero), NaN for NaN. Nothing of size
    [B, nv] is stored.

Each takes CUDA tensors only: it raises on a CPU tensor, on inputs the
kernel does not take and on a refused launch, launches on the tensor's
device and the current stream, and counts its launches
(``poses_from_confs_cuda.launches``, ``robot_bounds_cuda.launches``).
`kernels.megakernel`'s ``poses_from_confs``, ``robot_bounds`` and
``mesh_broad`` take these for a CUDA tensor and their plain twins for a CPU
one.
"""
from __future__ import annotations

import torch


def _require(t: torch.Tensor, name: str, shape: tuple, device: torch.device,
             dtype: torch.dtype = torch.float32) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def _check(lib, entry: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{lib.rc_front_error_string(err).decode()} (cudaError {err})")


def poses_from_confs_cuda(confs: torch.Tensor) -> torch.Tensor:
    """Launch K2 on the current stream: [B,6] float32 configurations (a
    contiguous CUDA tensor) -> [B,16] float32 pose rows r00,r01,r02,tx,
    r10,...,ty, r20,...,tz, 0,0,0,0."""
    from . import _build

    if not confs.is_cuda:
        raise ValueError(f"confs must be a CUDA tensor, got {confs.device}")
    dev = confs.device
    n = confs.shape[0] if confs.dim() == 2 else -1
    _require(confs, "confs", (n, 6), dev)
    out = torch.empty((n, 16), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = _build.library("front")
    with torch.cuda.device(dev):
        err = lib.rc_pose_rows(confs.data_ptr(), n, out.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, "rc_pose_rows", err)
    poses_from_confs_cuda.launches += 1
    return out


def robot_bounds_cuda(poses: torch.Tensor, rob_verts: torch.Tensor,
                      obs_box: torch.Tensor | None = None, *, padded: bool):
    """Launch K5 on the current stream: [B,16] pose rows and the vertex
    table ``rob_verts`` [3, nv] (nv >= 0) of a corner table with or without
    padding columns (``padded``: the box folds in the 3.0e38 sentinel, as
    the corner twin's masked reduction does) -> [B,6] box; with ``obs_box``
    [6] (lo, hi) returns (box, [B] bool overlap), without it the box
    alone."""
    from . import _build

    if not poses.is_cuda:
        raise ValueError(f"poses must be a CUDA tensor, got {poses.device}")
    dev = poses.device
    n = poses.shape[0] if poses.dim() == 2 else -1
    nv = rob_verts.shape[1] if rob_verts.dim() == 2 else -1
    if nv < 0:
        raise ValueError(f"rob_verts must be [3, nv], got {tuple(rob_verts.shape)}")
    _require(poses, "poses", (n, 16), dev)
    _require(rob_verts, "rob_verts", (3, nv), dev)
    if obs_box is not None:
        _require(obs_box, "obs_box", (6,), dev)
    box = torch.empty((n, 6), dtype=torch.float32, device=dev)
    hit = None if obs_box is None else torch.empty((n,), dtype=torch.uint8, device=dev)
    if n:
        lib = _build.library("front")
        with torch.cuda.device(dev):
            err = lib.rc_robot_bounds(
                poses.data_ptr(), n, rob_verts.data_ptr(), nv, int(padded),
                None if obs_box is None else obs_box.data_ptr(), box.data_ptr(),
                None if hit is None else hit.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _check(lib, "rc_robot_bounds", err)
        robot_bounds_cuda.launches += 1
    return box if hit is None else (box, hit.view(torch.bool))


poses_from_confs_cuda.launches = 0
robot_bounds_cuda.launches = 0
