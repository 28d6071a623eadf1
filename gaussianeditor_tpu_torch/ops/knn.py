"""K-nearest-neighbour utilities.

Counterpart of `gaussianeditor_tpu/ops/knn.py`, standing in for the
reference's `simple_knn.cu` (distCUDA2: the mean squared distance to the
3 nearest neighbours, for point-cloud scale initialisation) and its
scipy `knn.py` (the shell search of `get_near_gaussians_by_mask`). Both
run once per scene or edit set-up, on the host; the first through the
native C++ route (`native/simple_knn.cpp`) when `g++` is there, else
scipy's KD-tree, with a warning. `knn_dist_brute` is the on-device
variant, a matrix product and a top-k on the input's device.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch


def mean_sq_dist_to_3nn(points: np.ndarray,
                        prefer_native: bool = True) -> np.ndarray:
    """Mean squared distance from each point to its 3 nearest neighbours,
    through the native library when `prefer_native` and it builds, else
    scipy's KD-tree."""
    points = np.asarray(points, dtype=np.float32)
    if prefer_native and len(points) > 4:
        from gaussianeditor_tpu_torch.native import mean_sq_dist_3nn_native

        out = mean_sq_dist_3nn_native(points)
        if out is not None:
            return out
        # shown once per process under Python's default warning filter
        warnings.warn("the native KNN library did not build (no g++?); "
                      "mean_sq_dist_to_3nn takes scipy's KD-tree")

    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    # k=4: the first hit is the point itself at distance 0
    dists, _ = tree.query(points, k=min(4, len(points)))
    d = dists[:, 1:]
    return np.mean(d * d, axis=1).astype(np.float32)


def k_nearest_neighbors(points: np.ndarray, queries: np.ndarray, k: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Distances [Q, k] float32 and indices [Q, k] int32 of the k nearest
    `points` of each query (exact, scipy's KD-tree; the reference's
    knn.py:6-22). Host-side."""
    from scipy.spatial import cKDTree

    tree = cKDTree(np.asarray(points, np.float32))
    dists, idx = tree.query(np.asarray(queries, np.float32), k=k)
    if k == 1:
        dists, idx = dists[:, None], idx[:, None]
    return dists.astype(np.float32), idx.astype(np.int32)


def knn_dist_brute(points: torch.Tensor, queries: torch.Tensor, k: int,
                   valid: Optional[torch.Tensor] = None,
                   chunk: int = 1024) -> torch.Tensor:
    """Squared distances [Q, k] from each query to its k nearest `points`,
    on the inputs' device: |q|^2 + |p|^2 - 2 q.p by a matrix product, then
    `torch.topk`, `chunk` queries at a time. `valid` [P] bool leaves out
    dead slots."""
    p_sq = torch.sum(points * points, dim=-1)
    if valid is not None:
        p_sq = torch.where(valid, p_sq, torch.inf)
    out = []
    for q in torch.split(queries, chunk):
        q_sq = torch.sum(q * q, dim=-1, keepdim=True)
        d2 = q_sq + p_sq[None, :] - 2.0 * (q @ points.T)
        neg_top, _ = torch.topk(-d2, k, dim=-1)
        out.append(torch.clamp_min(-neg_top, 0.0))
    if not out:
        return queries.new_zeros((0, k))
    return torch.cat(out)
