"""The fused collision check: host tables, its CUDA kernel and its PyTorch twin.

PyTorch port of `robocheck_tpu.kernels.megakernel` (the Pallas `_kernel` +
`_one_config`). One call checks a batch of pose rows against the obstacle:
pose the robot's pre-gathered triangle corners, per-triangle planes and
boxes, the mesh-box broad phase, the (robot tile x obstacle group) gate, and
the Moller interval test on every pair whose triangle boxes overlap, with an
any-hit exit. Each configuration yields one byte: bit 0 = valid (no
intersecting pair), bit 1 = some live pair was flagged coplanar (resolved in
float64 by `oracle.resolve_coplanar`).

Two implementations share the tables and the arithmetic order of the Pallas
kernel (not `ops.narrow`'s, which rounds the interval endpoint differently):

  * ``check_poses_cuda`` launches the hand-written kernel of
    `csrc/megakernel.cu` (tensors on a CUDA device only);
  * ``check_poses_reference`` is its plain PyTorch twin (any device), which
    the CPU tests run and the GPU smoke check holds the kernel against.

``MegaKernelChecker`` takes the kernel on a CUDA device and the twin on the
CPU, chosen once from its device.

Host tables (``MegaKernelPrep``), Morton-ordered like the JAX package's:
  * rob_base   [10, Tr]: rows 0-8 corner coordinates c0x,c0y,c0z,...,c2z,
                row 9 = 1 for a real triangle, 0 for padding (padding corners
                are zeros, which posing moves to the pose's translation, so
                they must be masked).
  * obs        [To, 20]: cols 0-8 corners, 9-11 plane normal, 12 plane d,
                13-15 box lo, 16-18 box hi, 19 zero (a row is five 16-byte
                vectors). Padding rows carry the empty box (+inf, -inf).
  * obs_mesh   [6]: box of the referenced obstacle vertices (lo, hi).
  * obs_groups [To / GROUP, 6]: box of each group of GROUP obstacle triangles.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.constants import LANE, round_up
from ..core.types import Mesh, validate_confs
from ..ops.narrow import is_coplanar, no_overlap
from ..ops.transform import rotation_matrices
from ..utils.morton import morton_argsort

# Obstacle table columns (the JAX obs_t's first 19 columns, same indices).
_O_C, _O_N, _O_D, _O_LO, _O_HI = 0, 9, 12, 13, 16
OBS_COLS = 20
# Obstacle triangles per group box; both tables pad their triangle count to
# a multiple of it (as the JAX tables do), so the two packages' tables are
# equal array for array.
GROUP = LANE
# Fill value of masked robot boxes in the mesh-box reduction (`megakernel.py:403`).
_BIG = 3.0e38
# Pair elements the twin materialises per step (bounds its memory).
_PAIR_BUDGET = 1 << 24


@dataclasses.dataclass(frozen=True)
class MegaKernelPrep:
    """Mesh-pair tables, as numpy arrays (``build``) or as tensors on one
    device (``to``)."""

    rob_base: np.ndarray | torch.Tensor  # [10, Tr] f32
    obs: np.ndarray | torch.Tensor  # [To, OBS_COLS] f32
    obs_mesh: np.ndarray | torch.Tensor  # [6] f32
    obs_groups: np.ndarray | torch.Tensor  # [To // GROUP, 6] f32

    @staticmethod
    def build(robot: Mesh, obstacle: Mesh, morton: bool = True) -> "MegaKernelPrep":
        """The JAX `MegaKernelPrep.build` (`megakernel.py:930-993`) in this
        layout: same Morton order, same float32 obstacle-plane op order."""

        def corners(mesh: Mesh) -> np.ndarray:
            tv = mesh.vertices[mesh.triangles].astype(np.float64)  # [T,3,3]
            if morton:
                tv = tv[morton_argsort(tv.mean(axis=1))]
            return tv

        rob_tv = corners(robot)
        tr = round_up(rob_tv.shape[0], GROUP)
        rob_base = np.zeros((10, tr), dtype=np.float32)
        rob_base[0:9, : rob_tv.shape[0]] = rob_tv.reshape(-1, 9).T.astype(np.float32)
        rob_base[9, : rob_tv.shape[0]] = 1.0

        obs_tv = corners(obstacle).astype(np.float32)
        nt = obs_tv.shape[0]
        to = round_up(nt, GROUP)
        obs = np.zeros((to, OBS_COLS), dtype=np.float32)
        obs[:nt, _O_C : _O_C + 9] = obs_tv.reshape(nt, 9)
        # Planes in f32, in the op order of `megakernel.py:952-956`.
        e1 = obs_tv[:, 1] - obs_tv[:, 0]
        e2 = obs_tv[:, 2] - obs_tv[:, 1]
        n = np.cross(e1, e2)
        d = -np.sum(n * obs_tv[:, 0], axis=-1)
        obs[:nt, _O_N : _O_N + 3] = n
        obs[:nt, _O_D] = d
        obs[:, _O_LO : _O_LO + 3] = np.inf
        obs[:, _O_HI : _O_HI + 3] = -np.inf
        obs[:nt, _O_LO : _O_LO + 3] = obs_tv.min(axis=1)
        obs[:nt, _O_HI : _O_HI + 3] = obs_tv.max(axis=1)

        obs_mesh = np.concatenate([obs_tv.reshape(-1, 3).min(axis=0),
                                   obs_tv.reshape(-1, 3).max(axis=0)])
        obs_groups = np.zeros((to // GROUP, 6), dtype=np.float32)
        obs_groups[:, 0:3] = np.inf
        obs_groups[:, 3:6] = -np.inf
        for g in range(to // GROUP):
            lo, hi = g * GROUP, min((g + 1) * GROUP, nt)
            if hi > lo:
                obs_groups[g, 0:3] = obs_tv[lo:hi].reshape(-1, 3).min(axis=0)
                obs_groups[g, 3:6] = obs_tv[lo:hi].reshape(-1, 3).max(axis=0)
        return MegaKernelPrep(rob_base, obs, obs_mesh.astype(np.float32),
                              obs_groups)

    def to(self, device: torch.device | str) -> "MegaKernelPrep":
        """The same tables as contiguous float32 tensors on ``device``."""
        return MegaKernelPrep(*(
            torch.as_tensor(np.asarray(a, np.float32)).to(device).contiguous()
            for a in (self.rob_base, self.obs, self.obs_mesh, self.obs_groups)
        ))


def prep_from_arrays(rob_base: np.ndarray, obs_t: np.ndarray,
                     obs_mesh_aabb: np.ndarray,
                     obs_group_aabbs: np.ndarray) -> MegaKernelPrep:
    """The tables of a JAX `MegaKernelPrep` (its `rob_base` [16, Tr], `obs_t`
    [To, 24], `obs_mesh_aabb` [1, 8] and `obs_group_aabbs` [G, 8] fields) in
    this package's layout, so both packages can run on identical tables."""
    def f32(a):
        return np.ascontiguousarray(a, dtype=np.float32)

    return MegaKernelPrep(f32(rob_base[:10]), f32(obs_t[:, :OBS_COLS]),
                          f32(obs_mesh_aabb[0, :6]), f32(obs_group_aabbs[:, :6]))


def poses_from_confs(confs: torch.Tensor) -> torch.Tensor:
    """[B,6] configurations -> [B,16] pose rows r00,r01,r02,tx, r10,...,ty,
    r20,...,tz, 0,0,0,0 (`megakernel.py:1099-1113`)."""
    R = rotation_matrices(confs)
    t = confs[:, 0:3]
    pad = torch.zeros((confs.shape[0], 4), dtype=confs.dtype, device=confs.device)
    return torch.cat([R[:, 0, :], t[:, 0:1], R[:, 1, :], t[:, 1:2],
                      R[:, 2, :], t[:, 2:3], pad], dim=1)


# --------------------------------------------------------------------------
# The plain PyTorch twin.
# --------------------------------------------------------------------------

def _posed_robot(poses: torch.Tensor, rob_base: torch.Tensor) -> dict:
    """Posed corners, planes and boxes, each [B, Tr], in the operation order
    of the Pallas kernel (`megakernel.py:393-395, 407-408, 454-462`)."""
    p = [poses[:, k : k + 1] for k in range(12)]
    f = {}
    for c in range(3):
        X, Y, Z = rob_base[3 * c], rob_base[3 * c + 1], rob_base[3 * c + 2]
        for k, ax in enumerate("xyz"):
            f[f"c{c}{ax}"] = (p[4 * k] * X + p[4 * k + 1] * Y
                              + p[4 * k + 2] * Z + p[4 * k + 3])
    e1 = [f[f"c1{ax}"] - f[f"c0{ax}"] for ax in "xyz"]
    e2 = [f[f"c2{ax}"] - f[f"c1{ax}"] for ax in "xyz"]
    f["nx"] = e1[1] * e2[2] - e1[2] * e2[1]
    f["ny"] = e1[2] * e2[0] - e1[0] * e2[2]
    f["nz"] = e1[0] * e2[1] - e1[1] * e2[0]
    f["d"] = -(f["nx"] * f["c0x"] + f["ny"] * f["c0y"] + f["nz"] * f["c0z"])
    for k, ax in enumerate("xyz"):
        f[f"lo{k}"] = torch.minimum(torch.minimum(f[f"c0{ax}"], f[f"c1{ax}"]),
                                    f[f"c2{ax}"])
        f[f"hi{k}"] = torch.maximum(torch.maximum(f[f"c0{ax}"], f[f"c1{ax}"]),
                                    f[f"c2{ax}"])
    return f


def _obstacle_fields(obs: torch.Tensor) -> dict:
    f = {}
    for c in range(3):
        for k, ax in enumerate("xyz"):
            f[f"c{c}{ax}"] = obs[:, _O_C + 3 * c + k]
    f["nx"], f["ny"], f["nz"] = obs[:, _O_N], obs[:, _O_N + 1], obs[:, _O_N + 2]
    f["d"] = obs[:, _O_D]
    for k in range(3):
        f[f"lo{k}"] = obs[:, _O_LO + k]
        f[f"hi{k}"] = obs[:, _O_HI + k]
    return f


def _interval(p, d3):
    """Canonical permutation and interval ends (`megakernel.py:194-213`)."""
    d0, d1, d2 = d3
    c01 = ((d0 > 0) & (d1 > 0)) | ((d0 < 0) & (d1 < 0))
    c02 = ((d0 > 0) & (d2 > 0)) | ((d0 < 0) & (d2 < 0))
    q0 = torch.where(c01, p[0], torch.where(c02, p[0], p[1]))
    q1 = torch.where(c01, p[2], torch.where(c02, p[1], p[0]))
    q2 = torch.where(c01, p[1], torch.where(c02, p[2], p[2]))
    e0 = torch.where(c01, d0, torch.where(c02, d0, d1))
    e1 = torch.where(c01, d2, torch.where(c02, d1, d0))
    e2 = torch.where(c01, d1, torch.where(c02, d2, d2))

    def endpoint(pa, pb, da, db):
        dd = da - db
        dd = torch.where(dd == 0.0, 1.0, dd)
        return pa + (pb - pa) * (da / dd)

    t01 = endpoint(q0, q1, e0, e1)
    t12 = endpoint(q1, q2, e1, e2)
    return torch.minimum(t01, t12), torch.maximum(t01, t12)


def _pair_flags(r: dict, o: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(hit, coplanar) of each pair, fields given as 1-D tensors: plane
    stage, interval stage and the exact ratio test (`megakernel.py:133-217,
    281-303`; the separation band and the ratio test are `ops.narrow`'s,
    whose arithmetic there is the kernel's). The kernel's conservative
    coplanarity precheck only skips the exact test where it cannot fire, so
    it is left out here."""
    dist_o = [r["nx"] * o[f"c{c}x"] + r["ny"] * o[f"c{c}y"]
              + r["nz"] * o[f"c{c}z"] + r["d"] for c in range(3)]
    dist_r = [o["nx"] * r[f"c{c}x"] + o["ny"] * r[f"c{c}y"]
              + o["nz"] * r[f"c{c}z"] + o["d"] for c in range(3)]
    live = (~no_overlap(torch.stack(dist_o, dim=-1))
            & ~no_overlap(torch.stack(dist_r, dim=-1)))

    axx, bxx = r["ny"] * o["nz"], r["nz"] * o["ny"]
    axy, bxy = r["nz"] * o["nx"], r["nx"] * o["nz"]
    axz, bxz = r["nx"] * o["ny"], r["ny"] * o["nx"]
    Dx, Dy, Dz = axx - bxx, axy - bxy, axz - bxz

    def proj(s):
        return [Dx * s[f"c{c}x"] + Dy * s[f"c{c}y"] + Dz * s[f"c{c}z"]
                for c in range(3)]

    min_r, max_r = _interval(proj(r), dist_r)
    min_o, max_o = _interval(proj(o), dist_o)
    isect = ~((min_r >= max_o) | (min_o >= max_r)) & live
    coplanar = is_coplanar(torch.stack([r["nx"], r["ny"], r["nz"]], dim=-1), r["d"],
                           torch.stack([o["nx"], o["ny"], o["nz"]], dim=-1),
                           o["d"]) & live
    return isect & ~coplanar, coplanar


def check_poses_reference(poses: torch.Tensor,
                          prep: MegaKernelPrep) -> torch.Tensor:
    """Plain PyTorch twin of the CUDA kernel: [B,16] pose rows -> [B] uint8
    (bit 0 = valid, bit 1 = coplanar seen), on the device of its inputs.

    A pair counts where the robot triangle is real and the two triangle boxes
    overlap on closed intervals (`megakernel.py:736-739`); the twin finds
    those pairs with ``nonzero`` and tests all of them, so its coplanar bit
    of a colliding configuration may differ from the kernel's (whose any-hit
    exit depends on visiting order). Valid rows agree bit for bit."""
    rob_base, obs = prep.rob_base, prep.obs
    f = _posed_robot(poses, rob_base)
    real = rob_base[9] > 0.0
    broad = torch.ones(poses.shape[0], dtype=torch.bool, device=poses.device)
    for k in range(3):
        mesh_lo = torch.where(real, f[f"lo{k}"], _BIG).amin(dim=1)
        mesh_hi = torch.where(real, f[f"hi{k}"], -_BIG).amax(dim=1)
        broad &= (mesh_lo <= prep.obs_mesh[3 + k]) & (prep.obs_mesh[k] <= mesh_hi)

    out = torch.ones(poses.shape[0], dtype=torch.uint8, device=poses.device)
    o = _obstacle_fields(obs)
    tr, to = rob_base.shape[1], obs.shape[0]
    step = max(1, _PAIR_BUDGET // (tr * to))
    for rows in broad.nonzero()[:, 0].split(step):
        fb = {key: v[rows] for key, v in f.items()}
        # x axis on the dense [b, Tr, To] grid, then y and z on survivors.
        m = ((fb["lo0"][:, :, None] <= o["hi0"]) & (o["lo0"] <= fb["hi0"][:, :, None])
             & real[:, None])
        bi, ri, oi = m.nonzero(as_tuple=True)
        keep = ((fb["lo1"][bi, ri] <= o["hi1"][oi]) & (o["lo1"][oi] <= fb["hi1"][bi, ri])
                & (fb["lo2"][bi, ri] <= o["hi2"][oi]) & (o["lo2"][oi] <= fb["hi2"][bi, ri]))
        bi, ri, oi = bi[keep], ri[keep], oi[keep]
        hit, cop = _pair_flags({key: v[bi, ri] for key, v in fb.items()},
                               {key: v[oi] for key, v in o.items()})
        any_hit = torch.zeros(len(rows), dtype=torch.bool, device=poses.device)
        any_cop = torch.zeros_like(any_hit)
        any_hit[bi[hit]] = True
        any_cop[bi[cop]] = True
        out[rows] = (~any_hit).to(torch.uint8) | (any_cop.to(torch.uint8) << 1)
    return out


# --------------------------------------------------------------------------
# The CUDA kernel's wrapper.
# --------------------------------------------------------------------------

def _require(t: torch.Tensor, name: str, shape: tuple, device: torch.device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def check_poses_cuda(poses: torch.Tensor, prep: MegaKernelPrep) -> torch.Tensor:
    """Launch the kernel of `csrc/megakernel.cu` on the current stream:
    [B,16] pose rows -> [B] uint8, same bits as ``check_poses_reference``.
    Raises on inputs the kernel does not take and on a refused launch."""
    from . import _build

    if not poses.is_cuda:
        raise ValueError(f"poses must be a CUDA tensor, got {poses.device}")
    dev = poses.device
    tr, to = prep.rob_base.shape[1], prep.obs.shape[0]
    n_groups = to // GROUP
    if tr % GROUP or to % GROUP:
        raise ValueError(f"table rows must be multiples of {GROUP}: {tr}, {to}")
    _require(poses, "poses", (poses.shape[0], 16), dev)
    _require(prep.rob_base, "rob_base", (10, tr), dev)
    _require(prep.obs, "obs", (to, OBS_COLS), dev)
    _require(prep.obs_mesh, "obs_mesh", (6,), dev)
    _require(prep.obs_groups, "obs_groups", (n_groups, 6), dev)
    if prep.obs.data_ptr() % 16:
        raise ValueError("obs must be 16-byte aligned (it is read as float4)")
    n = poses.shape[0]
    out = torch.empty((n,), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rc_megakernel_check(
            poses.data_ptr(), n, prep.rob_base.data_ptr(), tr,
            prep.obs.data_ptr(), to, prep.obs_mesh.data_ptr(),
            prep.obs_groups.data_ptr(), n_groups, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            f"megakernel launch failed: {lib.rc_error_string(err).decode()} "
            f"(cudaError {err}; {lib.rc_megakernel_smem_bytes(tr, n_groups)} "
            f"bytes of shared memory for {tr} robot triangles)")
    check_poses_cuda.launches += 1
    return out


check_poses_cuda.launches = 0


class MegaKernelChecker:
    """Batched collision verdicts for one robot/obstacle mesh pair on one
    device: the CUDA kernel on a CUDA device, its PyTorch twin on the CPU.
    There is no automatic choice and no fallback between the two."""

    # Configurations per kernel launch in ``check_valid``.
    STREAM_CHUNK = 16384

    def __init__(self, robot: Mesh, obstacle: Mesh, device: torch.device | str,
                 morton: bool = True):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for, but no CUDA "
                               "device is available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        # The kernel launches or raises; the twin runs only on the CPU.
        self._check_poses = (check_poses_cuda if self.device.type == "cuda"
                             else check_poses_reference)
        self.robot = robot
        self.obstacle = obstacle
        self.prep = MegaKernelPrep.build(robot, obstacle, morton=morton)
        self.tables = self.prep.to(self.device)

    def check_valid(self, confs: np.ndarray, chunk: int | None = None):
        """[N,6] configurations -> (valid[N], coplanar[N]) numpy bools.

        Uploads the batch once, poses it on the device, checks it in chunks
        of ``chunk`` rows (the last may be short) and fetches the verdict
        bytes once. Non-finite rows are reported invalid
        (`megakernel.py:1341-1352`)."""
        confs = validate_confs(confs)
        n = confs.shape[0]
        finite = np.isfinite(confs).all(axis=1)
        if not finite.all():
            out_v = np.zeros((n,), dtype=bool)
            out_c = np.zeros((n,), dtype=bool)
            if finite.any():
                out_v[finite], out_c[finite] = self.check_valid(
                    confs[finite], chunk=chunk)
            return out_v, out_c
        if n == 0:
            return np.zeros((0,), dtype=bool), np.zeros((0,), dtype=bool)
        chunk = chunk or self.STREAM_CHUNK
        poses = poses_from_confs(torch.from_numpy(confs).to(self.device))
        packed = torch.cat([self._check_poses(poses[lo : lo + chunk], self.tables)
                            for lo in range(0, n, chunk)]).cpu().numpy()
        return (packed & 1).astype(bool), (packed >> 1).astype(bool)

    def check_valid_resolved(self, confs: np.ndarray,
                             chunk: int | None = None) -> np.ndarray:
        """``check_valid`` + exact float64 re-check of the valid rows flagged
        coplanar (`oracle.resolve_coplanar`). Returns valid[N] bool."""
        from ..oracle import resolve_coplanar

        valid, cop = self.check_valid(confs, chunk=chunk)
        return resolve_coplanar(self.robot, self.obstacle, confs, valid, cop)
