"""Path helpers of the trajectory layer (the numpy functions of
`robocheck_tpu.planner.trajopt`): arc-length resampling, arc-length-adaptive
densification for discrete certification, and endpoint branch snapping.
The optimizer itself is not ported yet."""
from __future__ import annotations

import numpy as np


def resample(path: np.ndarray, num_waypoints: int,
             rot_scale: float = 20.0) -> np.ndarray:
    """Arc-length-uniform resampling of a piecewise-linear path to a fixed
    waypoint count."""
    p = path.astype(np.float64)
    w = np.array([1, 1, 1, rot_scale, rot_scale, rot_scale], np.float64)
    seg = np.sqrt((((p[1:] - p[:-1]) * w) ** 2).sum(-1))
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    total = cum[-1] if cum[-1] > 0 else 1.0
    targets = np.linspace(0.0, total, num_waypoints)
    out = np.empty((num_waypoints, 6), np.float32)
    for i, s in enumerate(targets):
        k = min(np.searchsorted(cum, s, side="right") - 1, len(seg) - 1)
        f = (s - cum[k]) / seg[k] if seg[k] > 0 else 0.0
        out[i] = p[k] + f * (p[k + 1] - p[k])
    return out


def densify(traj: np.ndarray, step: float, rot_scale: float = 20.0,
            max_per_segment: int = 4096) -> tuple[np.ndarray, np.ndarray]:
    """Arc-length-adaptive interpolation: each segment gets enough samples
    that consecutive checks are at most ``step`` apart in the weighted
    configuration metric (rotations weighted by ``rot_scale``).

    Returns (dense configs [M, 6], segment index of each dense row [M]).
    """
    t = traj.astype(np.float32)
    d = t[1:] - t[:-1]
    w = np.array([1, 1, 1, rot_scale, rot_scale, rot_scale], np.float64)
    seg_len = np.sqrt(((d.astype(np.float64) * w) ** 2).sum(-1))
    out = []
    seg_idx = []
    for i in range(len(d)):
        n = int(min(max(np.ceil(seg_len[i] / step), 1), max_per_segment))
        s = np.linspace(0.0, 1.0, n, endpoint=False)[:, None]
        out.append(t[i][None] + s * d[i][None])
        seg_idx.append(np.full(n, i, dtype=np.int64))
    out.append(t[-1:])
    seg_idx.append(np.array([len(d) - 1], dtype=np.int64))
    return np.concatenate(out, axis=0), np.concatenate(seg_idx)


def snap_endpoint_branch(endpoint: np.ndarray,
                         like: np.ndarray) -> np.ndarray:
    """Shift an endpoint's angle coordinates by whole turns so they land on
    the same 2*pi branch as ``like`` (an adjacent waypoint of an
    angle-continuous path, see `prm.unwrap_path`). The returned endpoint
    denotes the identical pose (angles are periodic everywhere
    downstream)."""
    e = np.asarray(endpoint, np.float64).copy()
    ref = np.asarray(like, np.float64)
    e[3:6] += 2.0 * np.pi * np.round((ref[3:6] - e[3:6]) / (2.0 * np.pi))
    return e.astype(np.float32)
