"""Nearest-neighbour distances for point-cloud initialisation.

Counterpart of `gaussianeditor_tpu/ops/knn.py::mean_sq_dist_to_3nn`
(its scipy route). It runs once at scene setup, on the host.
"""

from __future__ import annotations

import numpy as np


def mean_sq_dist_to_3nn(points: np.ndarray) -> np.ndarray:
    """Mean squared distance from each point to its 3 nearest neighbours."""
    from scipy.spatial import cKDTree

    points = np.asarray(points, dtype=np.float32)
    tree = cKDTree(points)
    # k=4: the first hit is the point itself at distance 0
    dists, _ = tree.query(points, k=min(4, len(points)))
    d = dists[:, 1:]
    return np.mean(d * d, axis=1).astype(np.float32)
