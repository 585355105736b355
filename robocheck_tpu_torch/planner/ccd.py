"""Conservative continuous-collision certification (PyTorch port of
`robocheck_tpu.planner.ccd`).

Discrete checks along a densified path can tunnel: a thin robot can pass
through a wall between two samples. This module proves the whole swept
volume clear instead. For the linear-in-configuration motion
q(s) = (1-s) q_a + s q_b every robot surface point p (body frame,
|p| <= r_max) stays inside a ball of radius

    delta = |dt| + (|dyaw| + |dpitch| + |droll|) * r_max

around its start (or end) position. If the robot surface's conservative
clearance at q_a (or q_b) exceeds delta, and both ends are valid, the step
is certified collision-free. The surface clearance at a pose is
lower-bounded by the min over posed robot VERTICES of a lower-bounded
distance (the clearance engine, the native float64 BVH, or a distance grid
minus its cell diagonal), minus the covering radius r_cov (every surface
point is within longest_edge / sqrt(3) of a vertex of its triangle).

Steps that fail are subdivided (with boolean checks on the midpoints); a
path certifies iff its true clearance exceeds the method floor e_g + r_cov,
which ``floor()`` reports. `certify_multires` escalates only the unproven
segments to finer surface refinements.
"""
from __future__ import annotations

import concurrent.futures as _cf
import dataclasses
import time as _time

import numpy as np
import torch

from ..core.types import Mesh
from ..ops.transform import apply_pose, rotation_matrices
from .sdf import DistanceGrid, build_distance_grid

_SQRT3 = float(np.sqrt(3.0))
BACKENDS = ("engine", "native")


def covering_radius(mesh: Mesh) -> float:
    """max over triangles of longest_edge/sqrt(3): every surface point is
    within this distance of some mesh vertex."""
    tv = mesh.triangle_vertices.astype(np.float64)
    e = np.stack([
        np.linalg.norm(tv[:, 1] - tv[:, 0], axis=1),
        np.linalg.norm(tv[:, 2] - tv[:, 1], axis=1),
        np.linalg.norm(tv[:, 0] - tv[:, 2], axis=1),
    ])
    return float(e.max() / _SQRT3)


# Subdivided meshes are pure functions of (base mesh, levels); a multires
# certificate walks a handful of levels, so they are cached. Values keep the
# base mesh alive, so the id() key stays valid. A full alpha ladder keeps
# ~0.5 GB; ``clear_subdivision_cache()`` releases it.
_SUBDIV_CACHE: dict = {}


def clear_subdivision_cache() -> None:
    """Release all cached subdivided meshes."""
    _SUBDIV_CACHE.clear()


def _remember(key, mesh: Mesh, out: Mesh) -> None:
    if len(_SUBDIV_CACHE) > 8:
        _SUBDIV_CACHE.clear()
    _SUBDIV_CACHE[key] = (mesh, out)


def _edge_midpoints(v: np.ndarray, f: np.ndarray):
    """(unique edge codes' midpoints [E,3] f64, each edge slot's unique
    index [3T]) of triangles ``f`` over vertices ``v``; edges deduplicated
    as scalar int64 codes."""
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    n = np.int64(len(v) + 1)
    uniq, inv = np.unique(e.min(axis=1) * n + e.max(axis=1), return_inverse=True)
    return (v[uniq // n] + v[uniq % n]) / 2.0, inv


def subdivide_mesh(mesh: Mesh, levels: int = 1) -> Mesh:
    """Loop-topology 1->4 triangle subdivision (midpoints, no smoothing):
    the same surface, 4x the triangles a level, ``covering_radius`` halved
    exactly a level. Chains through the cache level by level."""
    key = (id(mesh), levels)
    hit = _SUBDIV_CACHE.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    if levels > 1:
        out = subdivide_mesh(subdivide_mesh(mesh, levels - 1), 1)
        out = Mesh(out.vertices, out.triangles, name=f"{mesh.name}/sub")
        _remember(key, mesh, out)
        return out
    v = mesh.vertices.astype(np.float64)
    f = mesh.triangles.astype(np.int64)
    for _ in range(levels):
        t = len(f)
        mids, inv = _edge_midpoints(v, f)
        mid_idx = len(v) + inv.reshape(-1)  # [3T] midpoint vertex per edge slot
        v = np.concatenate([v, mids])
        ab, bc, ca = mid_idx[:t], mid_idx[t : 2 * t], mid_idx[2 * t :]
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        f = np.concatenate([
            np.stack([a, ab, ca], axis=1),
            np.stack([ab, b, bc], axis=1),
            np.stack([ca, bc, c], axis=1),
            np.stack([ab, bc, ca], axis=1),
        ])
    out = Mesh(v.astype(np.float32), f.astype(np.int32), name=f"{mesh.name}/sub")
    _remember(key, mesh, out)
    return out


def subdivide_vertices(mesh: Mesh, levels: int) -> np.ndarray:
    """The vertex array of ``subdivide_mesh(mesh, levels)`` without the final
    level's triangle list (the exact certifiers sample vertices only)."""
    if levels <= 0:
        return mesh.vertices
    prev = mesh if levels == 1 else subdivide_mesh(mesh, levels - 1)
    v = prev.vertices.astype(np.float64)
    mids, _ = _edge_midpoints(v, prev.triangles.astype(np.int64))
    return np.concatenate([v, mids]).astype(np.float32)


@dataclasses.dataclass
class SweptCertificate:
    """Result of a continuous certification attempt."""

    certified: bool  # whole path proven collision-free (continuous)
    collision: bool  # a boolean check failed (path definitely invalid)
    num_checks: int  # exact boolean checks spent
    num_steps: int  # final number of certified steps
    # The proof's worst certifying margin: min over proven steps of the
    # certifying endpoint's conservative surface clearance; NaN when nothing
    # was proven. Multi-level runs take the min over levels.
    min_clearance: float
    method_floor: float  # e_g + r_cov: clearances below this can't certify
    uncertified_steps: int  # steps still unproven at max depth
    # Worst conservative surface clearance seen at any sampled configuration
    # of this certifier's level (the measured gap of an uncertified result).
    min_seen_clearance: float = float("nan")
    # Final (subdivided) path and per-step proof mask, for a finer level.
    path: np.ndarray | None = None
    step_ok: np.ndarray | None = None
    # Which steps were real targets (False = junctions between segments).
    step_real: np.ndarray | None = None
    # certify_multires with the engine backend: its engines' ``stats``
    # summed over the levels run.
    engine_stats: dict | None = None


class SweptCertifier:
    """Continuous certification for piecewise-linear configuration paths.

    ``certify(path, checker)`` returns a :class:`SweptCertificate`;
    ``checker`` is any object with ``check_valid_resolved(confs)``.

    Clearance backends: with ``exact=True``, ``backend="engine"`` (the
    default) measures exact vertex distances with `ClearanceEngine` on
    ``device`` ("cuda" by default: the scan kernel; "cpu": its twin), and
    ``backend="native"`` with the float64 BVH of the native library on the
    host. Without ``exact`` a distance grid on ``device`` bounds them
    (``grid=`` shares one). ``mesh`` (a `parallel.sharding.ProcessMesh`)
    shards the engine's exact pairs over its ranks.
    """

    def __init__(self, robot: Mesh, obstacle: Mesh, grid: DistanceGrid | None = None,
                 resolution: int = 96, refine: int = 0, exact: bool = False,
                 backend: str = "engine", device: torch.device | str = "cuda", mesh=None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.device = torch.device(device)  # the engine's or the grid's
        if refine and exact:
            self.robot = robot
            self._exact_verts = subdivide_vertices(robot, refine)
        else:
            self.robot = subdivide_mesh(robot, refine) if refine else robot
            self._exact_verts = self.robot.vertices
        self.obstacle = obstacle
        self.exact = exact
        self._engine = None
        self._native = None
        if refine:
            # Midpoint subdivision halves every edge exactly; float32 vertex
            # storage perturbs each stored level by ~0.5 ulp of the
            # coordinate scale, hence the absolute term per level.
            coord_scale = float(np.abs(robot.vertices.astype(np.float64)).max(initial=1.0))
            f32_eps = float(np.finfo(np.float32).eps)
            self.r_cov = ((covering_radius(robot) / (2.0 ** refine)) * (1.0 + 1e-5)
                          + (refine + 1) * 4.0 * f32_eps * coord_scale)
            # Midpoints are convex combinations: the base's max |v| bounds them.
            self.r_max = float(np.linalg.norm(robot.vertices.astype(np.float64), axis=1).max())
        else:
            self.r_cov = covering_radius(self.robot)
            self.r_max = float(np.linalg.norm(
                self.robot.vertices.astype(np.float64), axis=1).max())
        self.grid = None
        self.e_g = 0.0
        if exact and backend == "engine":
            from .clearance import ClearanceEngine

            self._engine = ClearanceEngine(self._exact_verts, obstacle, device=self.device,
                                           mesh=mesh)
        elif exact:
            from ..runtime import native

            if not native.available():
                raise RuntimeError("exact clearance needs the native library (make -C native)")
            if not native.has_point_mesh_dist():
                raise RuntimeError("native library is stale (no rc_point_mesh_dist); "
                                   "rebuild with make -C native")
            self._native = native
            self._obs_v = np.ascontiguousarray(obstacle.vertices, dtype=np.float64)
            self._obs_t = np.ascontiguousarray(obstacle.triangles, dtype=np.int32)
        else:
            self.grid = grid if grid is not None else build_distance_grid(
                obstacle, resolution, device=self.device)
            # Trilinear error: the full cell diagonal (true distance is
            # 1-Lipschitz; a trilinear value mixes the cell's 8 nodes).
            spacing = self.grid.spacing.cpu().numpy().astype(np.float64)
            self.e_g = float(np.linalg.norm(spacing))
            origin = self.grid.origin.cpu().numpy().astype(np.float64)
            shape = np.asarray(self.grid.values.shape, dtype=np.float64)
            self._dom_lo = origin
            self._dom_hi = origin + (shape - 1.0) * spacing
            self._verts = torch.as_tensor(
                np.asarray(self._exact_verts, np.float32)).to(self.grid.values.device)
        self._obs_lo = obstacle.aabb[:3].astype(np.float64)
        self._obs_hi = obstacle.aabb[3:].astype(np.float64)

    def floor(self) -> float:
        """Minimum true clearance a path must have anywhere for this
        certifier to succeed (e_g + r_cov)."""
        return self.e_g + self.r_cov

    def step_bounds(self, path: np.ndarray) -> np.ndarray:
        """delta[j]: max surface-point displacement bound for step j."""
        p = path.astype(np.float64)
        dt = np.linalg.norm(p[1:, 0:3] - p[:-1, 0:3], axis=1)
        dang = np.abs(p[1:, 3:6] - p[:-1, 3:6]).sum(axis=1)
        return dt + dang * self.r_max

    def clearances(self, path: np.ndarray, chunk: int = 256) -> np.ndarray:
        """Conservative robot-surface clearance at each configuration: min
        over vertices of (lower-bounded distance) minus r_cov."""
        if self._engine is not None:
            # Already a sound lower bound (the engine subtracts its haircut).
            return self._engine.min_distances(path) - self.r_cov

        path32 = np.asarray(path, np.float32)
        out = np.empty(len(path32), dtype=np.float64)
        if self._native is not None:
            R = rotation_matrices(torch.from_numpy(path32)).numpy().astype(np.float64)
            verts = np.asarray(self._exact_verts, dtype=np.float64)
            t = path32[:, 0:3].astype(np.float64)
            # Up to ~2M posed points per native call.
            vb = max(1, 2_000_000 // len(verts))
            for lo in range(0, len(path32), vb):
                hi = min(lo + vb, len(path32))
                pts = np.einsum("bij,vj->bvi", R[lo:hi], verts) + t[lo:hi, None, :]
                d = self._native.point_mesh_dist(self._obs_v, self._obs_t, pts.reshape(-1, 3))
                out[lo:hi] = d.reshape(hi - lo, len(verts)).min(axis=1) - self.r_cov
            return out

        dev = self.grid.values.device
        for lo in range(0, len(path32), chunk):
            part = torch.from_numpy(path32[lo : lo + chunk]).to(dev)
            # apply_pose, not a matmul: posing error would not be covered by
            # e_g (which bounds interpolation only).
            pts = apply_pose(rotation_matrices(part), part[:, 0:3], self._verts)
            tril = self.grid.query(pts).cpu().numpy().astype(np.float64)
            p_np = pts.cpu().numpy().astype(np.float64)
            in_dom = ((p_np >= self._dom_lo).all(-1) & (p_np <= self._dom_hi).all(-1))
            # Outside the grid the obstacle's box distance is a true lower bound.
            gap = (np.maximum(self._obs_lo - p_np, 0.0) + np.maximum(p_np - self._obs_hi, 0.0))
            d_low = np.where(in_dom, tril - self.e_g, np.linalg.norm(gap, axis=-1))
            out[lo : lo + len(part)] = d_low.min(axis=1) - self.r_cov
        return out

    def certify(self, path: np.ndarray, checker, max_depth: int = 8,
                step_mask: np.ndarray | None = None) -> SweptCertificate:
        """Prove (or refute, or give up with a measured gap) that the
        piecewise-linear path is collision-free continuously. The path's own
        vertices are boolean-checked too.

        ``step_mask`` (bool, ``len(path)-1``) marks the real certification
        targets; False steps are junctions between independent segments
        concatenated into one call, never tested, split, frozen or
        reported."""
        path = np.asarray(path, dtype=np.float32)
        real = (np.ones(max(len(path) - 1, 0), dtype=bool) if step_mask is None
                else np.asarray(step_mask, dtype=bool).copy())
        valid = np.asarray(checker.check_valid_resolved(path), dtype=bool)
        num_checks = len(path)
        if not valid.all():
            return SweptCertificate(False, True, num_checks, len(path) - 1,
                                    float("nan"), self.floor(), 0)
        clear = self.clearances(path)
        min_seen = float(clear.min())

        def proven_margin(pairmax, proven):
            vals = pairmax[proven]
            return float(vals.min()) if len(vals) else float("nan")

        for _ in range(max_depth):
            delta = self.step_bounds(path)
            # A step certifies from either endpoint's clearance ball.
            pairmax = np.maximum(clear[:-1], clear[1:])
            ok = (pairmax > delta) | ~real
            if ok.all():
                return SweptCertificate(True, False, num_checks, int(real.sum()),
                                        proven_margin(pairmax, real), self.floor(), 0,
                                        min_seen_clearance=min_seen)
            # Hopeless steps (clearance <= 0 at both ends) can never certify
            # at this level: freeze them; a finer level re-examines them.
            frozen = (pairmax <= 0.0) & real
            if (ok | frozen).all():
                break
            bad = np.nonzero(~ok & ~frozen)[0]
            mids = (0.5 * (path[bad].astype(np.float64)
                           + path[bad + 1].astype(np.float64))).astype(np.float32)
            mvalid = np.asarray(checker.check_valid_resolved(mids), dtype=bool)
            num_checks += len(mids)
            if not mvalid.all():
                return SweptCertificate(False, True, num_checks, len(path) - 1,
                                        float("nan"), self.floor(), 0)
            mclear = self.clearances(mids)
            min_seen = min(min_seen, float(mclear.min()))
            new_path = np.empty((len(path) + len(bad), 6), dtype=np.float32)
            new_clear = np.empty(len(path) + len(bad), dtype=np.float64)
            ins = bad + 1 + np.arange(len(bad))
            keep = np.setdiff1d(np.arange(len(new_path)), ins)
            new_path[keep] = path
            new_clear[keep] = clear
            new_path[ins] = mids
            new_clear[ins] = mclear
            # A split step becomes two real steps; junctions are never bad.
            counts = np.ones(len(real), dtype=np.int64)
            counts[bad] = 2
            real = np.repeat(real, counts)
            path, clear = new_path, new_clear
        delta = self.step_bounds(path)
        pairmax = np.maximum(clear[:-1], clear[1:])
        ok = (pairmax > delta) | ~real
        return SweptCertificate(bool(ok.all()), False, num_checks, int(real.sum()),
                                proven_margin(pairmax, ok & real), self.floor(),
                                int((~ok).sum()), path=path, step_ok=ok, step_real=real,
                                min_seen_clearance=min_seen)


def _segments_of(res: SweptCertificate) -> list[np.ndarray]:
    """Runs of adjacent unproven real steps of ``res`` as path segments
    (junction steps are never unproven-real, so runs cannot cross them)."""
    p = res.path
    bad = np.nonzero(~res.step_ok & res.step_real)[0]
    if len(bad) == 0:
        return []
    cut = np.nonzero(np.diff(bad) > 1)[0]
    starts = np.concatenate([bad[:1], bad[cut + 1]])
    ends = np.concatenate([bad[cut], bad[-1:]])
    return [p[s : e + 2] for s, e in zip(starts, ends)]


def certify_multires(robot: Mesh, obstacle: Mesh, path: np.ndarray, checker,
                     levels=((0, 8), (2, 8), (4, 8), (7, 10)), verbose: bool = False,
                     backend: str = "engine", device: torch.device | str = "cuda",
                     prefetch: bool = True, mesh=None) -> SweptCertificate:
    """Multi-resolution continuous certification: each level is a
    ``(refine, max_depth)`` pair with exact surface distances (``backend``
    "engine" on ``device``, or "native"). Cheap levels certify what their
    floor allows; only the still-unproven segments go on to the next level,
    all of a level's segments in one batched ``certify`` call (concatenated,
    with junction steps masked out).

    With ``prefetch`` (default) the next level's certifier (subdivision,
    Morton blocking, table upload) is built on a worker thread while the
    current level certifies; the build synchronises its uploads before it
    returns, on the same device. If the current level proves everything,
    the speculative build finishes in the background.

    Returns a certificate with totals over levels; ``min_clearance`` is the
    min over levels of each level's own proven margin. Stops at the first
    refutation (collision=True).

    ``mesh`` (a `parallel.sharding.ProcessMesh`, whose device then replaces
    ``device``) shards each engine's exact pairs over its ranks; every rank
    calls this with the same path and gets the same certificate."""
    dev = torch.device(device) if mesh is None else mesh.device
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        # The worker thread's current device may differ: name it.
        dev = torch.device("cuda", torch.cuda.current_device())
    total_checks = 0
    min_clear = float("inf")
    segments = [np.asarray(path, np.float32)]
    last_floor = float("nan")
    last_seen = float("nan")
    pool = _cf.ThreadPoolExecutor(max_workers=1) if prefetch and len(levels) > 1 else None
    nxt = None
    stats = {} if backend == "engine" else None

    def _build(refine):
        cert = SweptCertifier(robot, obstacle, refine=refine, exact=True,
                              backend=backend, device=dev, mesh=mesh)
        if cert._engine is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)  # its uploads are done before it is used
        return cert

    def _certified(cert, res):
        return SweptCertificate(
            True, False, total_checks, len(path) - 1,
            min_clear if np.isfinite(min_clear) else float("nan"), cert.floor(), 0,
            min_seen_clearance=res.min_seen_clearance, engine_stats=stats)

    try:
        for li, (refine, max_depth) in enumerate(levels):
            t_level = _time.perf_counter()
            cert = nxt.result() if nxt is not None else _build(refine)
            nxt = (pool.submit(_build, levels[li + 1][0])
                   if pool is not None and li + 1 < len(levels) else None)
            t_built = _time.perf_counter() - t_level
            last_floor = cert.floor()
            concat = np.concatenate(segments, axis=0)
            real = np.ones(max(len(concat) - 1, 0), dtype=bool)
            real[np.cumsum([len(s) for s in segments[:-1]], dtype=np.int64) - 1] = False
            res = cert.certify(concat, checker, max_depth=max_depth, step_mask=real)
            total_checks += res.num_checks
            if stats is not None:
                for k, v in cert._engine.stats.items():
                    stats[k] = stats.get(k, 0) + v
            if np.isfinite(res.min_clearance):
                min_clear = min(min_clear, res.min_clearance)

            def _report(tag):
                if not verbose:
                    return
                eng = cert._engine
                es = (", engine[" + ", ".join(
                    f"{k}={v:.1f}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in eng.stats.items()) + "]" if eng is not None else "")
                print(f"  level {li} (refine={refine}, floor={cert.floor():.3f}): {tag}, "
                      f"{total_checks} checks so far, {_time.perf_counter() - t_level:.1f}s "
                      f"(build {t_built:.1f}s){es}", flush=True)

            if res.collision:
                _report("REFUTED")
                return SweptCertificate(False, True, total_checks, 0, float("nan"),
                                        cert.floor(), 0, engine_stats=stats)
            if res.certified:
                _report("all segments certified")
                return _certified(cert, res)
            segments = _segments_of(res)
            _report(f"{len(segments)} unproven segment(s) remain")
            if not segments:
                return _certified(cert, res)
            last_seen = res.min_seen_clearance
    finally:
        if pool is not None:
            # Never join a speculative build from the hot path.
            pool.shutdown(wait=False)
    return SweptCertificate(
        False, False, total_checks, len(path) - 1,
        min_clear if np.isfinite(min_clear) else float("nan"), last_floor,
        sum(len(s) - 1 for s in segments), min_seen_clearance=last_seen,
        engine_stats=stats)
