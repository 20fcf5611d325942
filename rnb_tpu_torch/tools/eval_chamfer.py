"""Chamfer-distance mesh evaluation (the port's copy of
``tools/eval_chamfer.py``), the DiLiGenT-MV protocol:

    python -m rnb_tpu_torch.tools.eval_chamfer PRED.ply GT.ply
        [--n_points 100000] [--scale 1.0] [--max_dist inf] [--seed 0] [--json]

N points sampled uniformly by area on each surface; d(P→Q) is the mean
distance of P's samples to the nearest of Q's (accuracy), d(Q→P) the
completeness, Chamfer-L1 = (d(P→Q) + d(Q→P)) / 2, in input units x
``--scale`` (DiLiGenT-MV meshes are in mm, so 1); ``--max_dist`` clips
outlier correspondences. The nearest-neighbour search is scipy's
``cKDTree`` on the host. PLY files are read with ``utils.io.read_ply``.
"""

from __future__ import annotations

import argparse
import json

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


def chamfer_between_meshes(pred_vf, gt_vf, n_points: int = 100000,
                           scale: float = 1.0, max_dist: float = np.inf,
                           seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    pa = sample_surface(np.asarray(pred_vf[0], np.float64) * scale,
                        np.asarray(pred_vf[1]), n_points, rng)
    pb = sample_surface(np.asarray(gt_vf[0], np.float64) * scale,
                        np.asarray(gt_vf[1]), n_points, rng)
    return chamfer(pa, pb, max_dist=max_dist)


def _load_mesh(path: str):
    """(vertices, faces) of a PLY file."""
    from rnb_tpu_torch.utils.io import read_ply
    v, f, _ = read_ply(path)
    return v, f


def main(argv=None):
    ap = argparse.ArgumentParser(description="Chamfer-distance mesh evaluation")
    ap.add_argument("pred")
    ap.add_argument("gt")
    ap.add_argument("--n_points", type=int, default=100000)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="unit scale applied to both meshes before measuring")
    ap.add_argument("--max_dist", type=float, default=np.inf,
                    help="clip correspondence distances (outlier robustness)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    res = chamfer_between_meshes(_load_mesh(args.pred), _load_mesh(args.gt),
                                 n_points=args.n_points, scale=args.scale,
                                 max_dist=args.max_dist, seed=args.seed)
    if args.json:
        print(json.dumps(res))
    else:
        for k, v in res.items():
            print(f"{k:22s} {v:.6f}")
    return res


if __name__ == "__main__":
    main()
