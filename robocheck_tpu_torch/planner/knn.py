"""Nearest neighbours under the planners' weighted wrapped metric (a copy of
`robocheck_tpu.planner.knn`, with scipy required instead of optional).

The metric is

    d(a, b) = || (dx, dy, dz, w*wrap(dyaw), w*wrap(dpitch), w*wrap(droll)) ||

and both queries run a KD-tree on the 9-D CHORD embedding (x, y, z, w cos/sin
of each angle): chord = 2 sin(|wrap|/2) <= |wrap| <= (pi/2) * chord, so chord
order approximates arc order; candidates are oversampled in chord space and
re-ranked with the exact metric. Both are EXACT: exact >= chord, so a row
whose best exact distance exceeds the chord distance of the candidate
horizon is rescanned densely (``conf_knn``), and a query whose last fetched
candidate's chord distance is below its best exact distance falls back to a
dense scan (``IncrementalNearest``).
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def _wrap(d: np.ndarray) -> np.ndarray:
    return np.arctan2(np.sin(d), np.cos(d))


def conf_distance(a: np.ndarray, b: np.ndarray,
                  rot_scale: float) -> np.ndarray:
    """Weighted wrapped configuration distance, broadcast over leading
    dims (the planners' exact metric)."""
    d = a - b
    d[..., 3:] = _wrap(d[..., 3:])
    w = np.array([1, 1, 1, rot_scale, rot_scale, rot_scale], np.float64)
    return np.sqrt(((d * w) ** 2).sum(-1))


def chord_embed(confs: np.ndarray, rot_scale: float) -> np.ndarray:
    """[n, 6] -> [n, 9] Euclidean chord embedding."""
    c = confs.astype(np.float64)
    ang = c[:, 3:6]
    return np.concatenate(
        [c[:, 0:3], rot_scale * np.cos(ang), rot_scale * np.sin(ang)],
        axis=1,
    )


def conf_knn(verts: np.ndarray, k: int, rot_scale: float,
             oversample: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """k nearest neighbors of every row among all rows (self excluded).

    Returns (nbrs [n, k] int64, dists [n, k] float64), exact-metric ranked.
    O(n log n) build + O(n * k' log n) query.
    """
    n = len(verts)
    k = min(k, n - 1)
    if k <= 0:
        return (np.empty((n, 0), np.int64), np.empty((n, 0), np.float64))
    kq = min(n, oversample * k + 1)
    horizon = np.full(n, np.inf)
    emb = chord_embed(verts, rot_scale)
    cd, idx = cKDTree(emb).query(emb, k=kq)  # [n, kq], col 0 = self
    if kq < n:
        # Chord radius of the fetched candidate set: any point outside it
        # has chord >= horizon, hence exact >= horizon.
        horizon = cd[:, -1]
    cand = idx[:, :]  # includes self; exact rerank removes it
    d = conf_distance(verts[cand].astype(np.float64),
                      verts[:, None, :].astype(np.float64), rot_scale)
    d[cand == np.arange(n)[:, None]] = np.inf
    order = np.argsort(d, axis=1)[:, :k]
    nbrs = np.take_along_axis(cand, order, axis=1)
    dk = np.take_along_axis(d, order, axis=1)
    # A truly nearer neighbor can hide outside the chord candidate horizon
    # only if the row's k-th exact distance exceeds the horizon's chord
    # distance; rescan those rows densely.
    bad = np.nonzero(dk[:, -1] > horizon)[0]
    if len(bad):
        dd = conf_distance(verts[bad, None, :].astype(np.float64),
                           verts[None, :, :].astype(np.float64), rot_scale)
        dd[np.arange(len(bad)), bad] = np.inf
        o = np.argsort(dd, axis=1)[:, :k]
        nbrs[bad] = o
        dk[bad] = np.take_along_axis(dd, o, axis=1)
    return nbrs, dk


class IncrementalNearest:
    """Exact incremental 1-NN (batched queries) for RRT-style growing node
    sets: a KD-tree over the chord embedding, rebuilt amortized (when the
    un-indexed tail outgrows a fraction of the tree), with the tail scanned
    densely. Queries oversample in chord space and re-rank with the exact
    metric; a dense fallback runs for any query whose last fetched
    candidate's chord distance is still below the best exact distance."""

    def __init__(self, rot_scale: float, rebuild_frac: float = 0.25):
        self.rot_scale = rot_scale
        self.rebuild_frac = rebuild_frac
        self._nodes = np.zeros((0, 6), np.float32)
        self._tree = None
        self._tree_n = 0

    def __len__(self) -> int:
        return len(self._nodes)

    def add(self, confs: np.ndarray) -> None:
        confs = np.asarray(confs, np.float32).reshape(-1, 6)
        self._nodes = np.concatenate([self._nodes, confs], axis=0)
        tail = len(self._nodes) - self._tree_n
        if self._tree is None or tail > max(256, self.rebuild_frac * self._tree_n):
            self._tree = cKDTree(chord_embed(self._nodes, self.rot_scale))
            self._tree_n = len(self._nodes)

    @property
    def nodes(self) -> np.ndarray:
        return self._nodes

    def nearest(self, pts: np.ndarray, k_cand: int = 8):
        """(indices [m], exact distances [m]) of the nearest node for each
        query row."""
        pts = np.asarray(pts, np.float32).reshape(-1, 6)
        m = len(pts)
        n = len(self._nodes)
        assert n > 0
        kq = min(self._tree_n, k_cand)
        dd, idx = self._tree.query(chord_embed(pts, self.rot_scale), k=kq)
        if kq == 1:
            dd = dd[:, None]
            idx = idx[:, None]
        d = conf_distance(self._nodes[idx].astype(np.float64),
                          pts[:, None, :].astype(np.float64), self.rot_scale)
        j = np.argmin(d, axis=1)
        best_d = d[np.arange(m), j]
        best_i = idx[np.arange(m), j].astype(np.int64)
        # Every un-fetched node has chord distance >= dd[:, -1], and exact >=
        # chord: only where dd[:, -1] < best_d could one still beat the best
        # exact distance; dense-scan the tree range for those queries.
        risky = np.nonzero((kq < self._tree_n) & (dd[:, -1] < best_d))[0]
        for q in risky:
            d_all = conf_distance(self._nodes[: self._tree_n].astype(np.float64),
                                  pts[q].astype(np.float64), self.rot_scale)
            jj = int(np.argmin(d_all))
            if d_all[jj] < best_d[q]:
                best_d[q] = d_all[jj]
                best_i[q] = jj
        # Dense scan of the un-indexed tail.
        if self._tree_n < n:
            tail = self._nodes[self._tree_n :]
            d = conf_distance(tail[None, :, :].astype(np.float64),
                              pts[:, None, :].astype(np.float64), self.rot_scale)
            j = np.argmin(d, axis=1)
            dtail = d[np.arange(m), j]
            upd = dtail < best_d
            best_d = np.where(upd, dtail, best_d)
            best_i = np.where(upd, self._tree_n + j, best_i)
        return best_i, best_d
