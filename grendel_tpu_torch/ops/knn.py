"""K-nearest-neighbor distances for point-cloud initialization.

The port's own copy of grendel_tpu/ops/knn.py (host numpy and scipy): the
mean squared distance from each point to its 3 nearest neighbors, which
sets the initial log-scales once per training run. A scipy cKDTree where
scipy is installed, a chunked brute force otherwise.
"""

from __future__ import annotations

import numpy as np

try:
    from scipy.spatial import cKDTree

    _HAVE_SCIPY = True
except ImportError:  # pragma: no cover
    _HAVE_SCIPY = False


def mean_dist2_to_knn(points: np.ndarray, k: int = 3) -> np.ndarray:
    """(N,) float32 mean squared distance of each of ``points`` (N, 3) to
    its k nearest neighbors."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    if n <= 1:
        return np.full((n,), 1e-7, dtype=np.float32)
    kk = min(k, n - 1)
    if _HAVE_SCIPY:
        tree = cKDTree(points)
        # the query returns the point itself first
        d, _ = tree.query(points, k=kk + 1, workers=-1)
        return (d[:, 1:] ** 2).mean(axis=1).astype(np.float32)
    return _brute_force_knn(points, kk)


def _brute_force_knn(points: np.ndarray, k: int,
                     chunk: int = 4096) -> np.ndarray:
    """O(N^2) chunked version (numpy)."""
    n = points.shape[0]
    out = np.empty((n,), dtype=np.float32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        d2 = ((points[lo:hi, None, :] - points[None, :, :]) ** 2).sum(-1)
        # the k+1 smallest include the point itself (distance 0): drop it
        part = np.partition(d2, kth=k, axis=1)[:, 1:k + 1]
        out[lo:hi] = part.mean(axis=1)
    return out
