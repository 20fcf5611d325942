"""Chamfer distance between point sets (the port's copy of
``sample_surface``, ``nn_distances`` and ``chamfer`` of
``tools/eval_chamfer.py``): N points sampled uniformly by area on each
surface; d(P→Q) is the mean distance of P's samples to the nearest of Q's
(accuracy), d(Q→P) the completeness, Chamfer-L1 = (d(P→Q) + d(Q→P)) / 2.
"""

from __future__ import annotations

import numpy as np


def sample_surface(vertices: np.ndarray, faces: np.ndarray, n: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Area-weighted uniform surface sampling -> [n,3]."""
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("mesh has zero surface area")
    idx = rng.choice(len(faces), size=n, p=areas / total)
    r1 = np.sqrt(rng.random(n))
    r2 = rng.random(n)
    a, b, c = 1.0 - r1, r1 * (1.0 - r2), r1 * r2
    return (a[:, None] * v0[idx] + b[:, None] * v1[idx] + c[:, None] * v2[idx])


def nn_distances(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """For each src point, the distance to the nearest dst point."""
    from scipy.spatial import cKDTree
    d, _ = cKDTree(dst).query(src, k=1, workers=-1)
    return d


def chamfer(points_a: np.ndarray, points_b: np.ndarray,
            max_dist: float = np.inf) -> dict:
    d_ab = np.minimum(nn_distances(points_a, points_b), max_dist)
    d_ba = np.minimum(nn_distances(points_b, points_a), max_dist)
    return {
        "accuracy_mean": float(d_ab.mean()),
        "completeness_mean": float(d_ba.mean()),
        "chamfer_l1": float(0.5 * (d_ab.mean() + d_ba.mean())),
        "chamfer_l2": float(0.5 * ((d_ab ** 2).mean() + (d_ba ** 2).mean())),
        "accuracy_median": float(np.median(d_ab)),
        "completeness_median": float(np.median(d_ba)),
    }
