"""Scene normalization of an IDR case (the port's copy of
``preprocess/preprocess_cameras.py``):

    python -m rnb_tpu_torch.preprocess.preprocess_cameras --source_dir D
        [--use_linear_init] [--seed S] [--refine_visual_hull] [--dtu]
        [--device cuda|cpu]

From the per-view object masks and projections ``world_mat_i = K[R|t]``,
estimate a 4x4 ``scale_mat`` that puts the object inside the unit sphere
and write it back into ``cameras.npz`` for every view: mask pixels of view
0 are picked; each one's depth interval along its ray is cut by every
other view's silhouette near the epipolar line (fundamental-matrix
transfer and DLT triangulation); the picks seen in all views give the
interval end points, whose centroid and standard deviation are the
normalization. ``--refine_visual_hull`` then carves a lattice around that
estimate by the silhouettes and takes the kept points' centroid and 3x
their mean distance from it.

The geometry runs in float64 on ``--device`` (the card by default; no
silent fall back to the CPU): the picks of view 0 are batched against one
view at a time, the triangulations are batched 4x4 SVDs, and the hull
projects the whole lattice into one camera at a time. The picks come from
numpy's ``default_rng(seed)``, so the JAX package's tool picks the same
pixels. Masks are read with the port's PNG codec.
"""

from __future__ import annotations

import argparse
import os
import sys
from glob import glob

import numpy as np
import torch

from rnb_tpu_torch.utils import io

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
F64 = torch.float64
# picks x silhouette pixels a distance matrix may hold (128 MiB of float64)
_CHUNK = 1 << 24


def glob_imgs(path: str):
    imgs = []
    for ext in ("*.png", "*.jpg", "*.JPEG", "*.JPG"):
        imgs.extend(glob(os.path.join(path, ext)))
    return sorted(imgs)


def load_mask_points(masks_dir: str):
    """Per view: [3, N] float64 homogeneous foreground pixel coordinates,
    and the boolean masks [V, H, W] (host arrays)."""
    points_all, masks = [], []
    for path in glob_imgs(masks_dir):
        m = io.load_mask(path) > 0.5
        ys, xs = np.nonzero(m)
        points_all.append(
            np.stack([xs, ys, np.ones_like(xs)]).astype(np.float64))
        masks.append(m)
    return points_all, np.array(masks)


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), dtype=F64, device=device)


def camera_center(P: torch.Tensor) -> torch.Tensor:
    """Homogeneous right null vector of P [3, 4]."""
    _, _, vh = torch.linalg.svd(P)
    C = vh[-1]
    return C / C[3]


def fundamental_matrix(P1: torch.Tensor, P2: torch.Tensor) -> torch.Tensor:
    """F mapping points of camera 2's image to epipolar lines in camera 1's:
    F = [e]_x P1 P2^+ with e = P1 C2."""
    e = P1 @ camera_center(P2)
    z = torch.zeros((), dtype=F64, device=P1.device)
    ex = torch.stack([torch.stack([z, -e[2], e[1]]),
                      torch.stack([e[2], z, -e[0]]),
                      torch.stack([-e[1], e[0], z])])
    return ex @ P1 @ torch.linalg.pinv(P2)


def triangulate_dlt(P0: torch.Tensor, P1: torch.Tensor, x0: torch.Tensor,
                    x1: torch.Tensor) -> torch.Tensor:
    """Batched linear triangulation. x0 [2, N] (or [2]), x1 [2, N] ->
    X [4, N] (homogeneous, sign free)."""
    n = x1.shape[1]
    x0 = x0.reshape(2, -1).expand(2, n)
    A = torch.stack([x0[0][:, None] * P0[2] - P0[0],
                     x0[1][:, None] * P0[2] - P0[1],
                     x1[0][:, None] * P1[2] - P1[0],
                     x1[1][:, None] * P1[2] - P1[1]], dim=1)   # [N, 4, 4]
    _, _, vh = torch.linalg.svd(A)
    return vh[:, -1, :].T


def depth_intervals(xs: torch.Tensor, ys: torch.Tensor, P_j, sil_j, P_0,
                    F_j0):
    """Min/max depth wrt camera 0 of each reference pixel (xs, ys) [P],
    cut by view j's silhouette sil_j [3, N]: the silhouette pixels within
    0.7 px of the pixel's epipolar line, triangulated with it; depths that
    are not finite or are negative are dropped. A pixel left with none
    gets (0, 0). -> (dmin [P], dmax [P])."""
    P = xs.shape[0]
    dmin = torch.zeros(P, dtype=F64, device=xs.device)
    dmax = torch.zeros_like(dmin)
    step = max(1, _CHUNK // max(1, sil_j.shape[1]))
    for s in range(0, P, step):
        cx, cy = xs[s:s + step], ys[s:s + step]
        pix = torch.stack([cx, cy, torch.ones_like(cx)], dim=1)     # [p, 3]
        lines = pix @ F_j0.T
        lines = lines / torch.linalg.vector_norm(lines[:, :2], dim=1,
                                                 keepdim=True)
        near = (lines @ sil_j).abs() < 0.7                           # [p, N]
        pi, ci = torch.nonzero(near, as_tuple=True)
        if pi.numel() == 0:
            continue
        X = triangulate_dlt(P_0, P_j, torch.stack([cx[pi], cy[pi]]),
                            sil_j[:2, ci])
        depths = P_0[2] @ (X / X[3])
        ok = torch.isfinite(depths) & (depths >= 0)
        pi, depths = pi[ok], depths[ok]
        p = cx.shape[0]
        lo = torch.full((p,), float("inf"), dtype=F64, device=xs.device)
        hi = torch.full((p,), -float("inf"), dtype=F64, device=xs.device)
        lo = lo.scatter_reduce(0, pi, depths, "amin")
        hi = hi.scatter_reduce(0, pi, depths, "amax")
        seen = torch.bincount(pi, minlength=p) > 0
        dmin[s:s + step] = torch.where(seen, lo, 0.0)
        dmax[s:s + step] = torch.where(seen, hi, 0.0)
    return dmin, dmax


def depth_interval(curx: float, cury: float, P_j, sil_j, P_0, F_j0):
    """``depth_intervals`` of one reference pixel -> (dmin, dmax) floats."""
    dev = P_0.device
    dmin, dmax = depth_intervals(_t([curx], dev), _t([cury], dev), P_j, sil_j,
                                 P_0, F_j0)
    return float(dmin[0]), float(dmax[0])


def estimate_normalization(Ps, mask_points_all, n_points: int = 100,
                           seed: int = 0, device="cuda"):
    """Ps [V, 3, 4] and the per-view [3, N] mask points (host arrays) ->
    (scale_mat [4,4] float32, kept 3D points [M,3] float64), host arrays.
    A pick is kept when every other view gives it an interval with
    |dmin| >= 1e-5 and the intersection of the intervals is at least 1e-2
    deep; its two end points along its ray are kept."""
    Ps_t = _t(Ps, device)
    P0 = Ps_t[0]
    C0 = camera_center(P0)

    xs, ys = mask_points_all[0][0], mask_points_all[0][1]
    picks = np.random.default_rng(seed).permutation(xs.shape[0])[:n_points]
    px, py = _t(xs[picks], device), _t(ys[picks], device)

    min_all = torch.full_like(px, 1e-10)
    max_all = torch.full_like(px, 1e10)
    ok = torch.ones(px.shape, dtype=torch.bool, device=device)
    for j in range(1, len(Ps)):
        dmin, dmax = depth_intervals(px, py, Ps_t[j],
                                     _t(mask_points_all[j], device), P0,
                                     fundamental_matrix(Ps_t[j], P0))
        # the reference's loop over views stops a pick at its first failed
        # test; the running bounds only tighten, so testing every view's
        # interval and the final bounds keeps the same picks
        ok &= dmin.abs() >= 1e-5
        min_all = torch.maximum(min_all, dmin)
        max_all = torch.minimum(max_all, dmax)
    ok &= ~(max_all < min_all + 1e-2)

    if not bool(ok.any()):
        raise RuntimeError(
            "no mask point visible in all views; check masks/cameras")
    pix = torch.stack([px, py, torch.ones_like(px)], dim=1)[ok]      # [K, 3]
    direction = pix @ torch.linalg.inv(P0[:3, :3]).T
    ends = torch.stack([C0[:3] + direction * min_all[ok][:, None],
                        C0[:3] + direction * max_all[ok][:, None]], dim=1)
    pts = ends.reshape(-1, 3)                       # min, max of each pick
    print(f"Number of points: {len(pts) // 2}")
    centroid = pts.mean(dim=0).cpu().numpy()
    scale = float(pts.std(correction=0))

    normalization = np.eye(4, dtype=np.float32)
    normalization[:3, 3] = centroid
    normalization[0, 0] = normalization[1, 1] = normalization[2, 2] = scale
    return normalization, pts.cpu().numpy()


def refine_visual_hull(masks: np.ndarray, Ps, scale: float, center,
                       grid_size: int = 100, min_views: int | None = None,
                       device="cuda"):
    """Visual-hull refinement of the normalization estimate: carve a
    grid_size³ lattice spanning [-scale, scale]³ around ``center`` by
    projecting every lattice point into every camera and counting
    silhouette hits; keep the points inside >= min_views silhouettes
    (default ceil(0.9 * n_cam), at least 2; a point projecting outside a
    view's image is a miss there), then recentre on them and set the scale
    to 3x their mean distance from the centroid. Loops over cameras only.
    -> (centroid [3], scale, kept points [M,3]), host arrays."""
    n_cam, im_h, im_w = masks.shape[:3]
    if min_views is None:
        min_views = max(2, int(np.ceil(0.9 * n_cam)))
    lin = _t(np.linspace(-scale, scale, grid_size), device)
    xx, yy, zz = torch.meshgrid(lin, lin, lin, indexing="xy")
    points = torch.stack((xx.reshape(-1), yy.reshape(-1), zz.reshape(-1)))
    points = points + _t(center, device)[:, None]                   # [3, G]
    hom = torch.cat([points, torch.ones_like(points[:1])], dim=0)
    masks_t = torch.as_tensor(np.asarray(masks) > 0.5, device=device)
    Ps_t = _t(Ps, device)

    appears = torch.zeros(points.shape[1], dtype=torch.int64, device=device)
    for i in range(n_cam):
        proj = Ps_t[i][:3] @ hom
        depths = proj[2]
        front = depths > 0
        # a point behind (or on) the camera plane has no pixel: keep its
        # inf/NaN out of the integer cast; the clamp keeps far points off
        # the image as -1 or the image size, both rejected below
        safe = torch.where(front, depths, 1.0)
        px = torch.where(front, torch.round(proj[0] / safe), -1.0)
        py = torch.where(front, torch.round(proj[1] / safe), -1.0)
        px = px.clamp(-1, im_w).to(torch.int64)
        py = py.clamp(-1, im_h).to(torch.int64)
        inside = front & (px >= 0) & (px < im_w) & (py >= 0) & (py < im_h)
        hit = torch.zeros_like(inside)
        hit[inside] = masks_t[i][py[inside], px[inside]]
        appears += hit.to(torch.int64)

    kept = points[:, appears >= min_views]
    if kept.shape[1] == 0:
        raise RuntimeError(
            f"visual hull empty at min_views={min_views}; lower it or check "
            "masks/cameras")
    centroid = kept.mean(dim=1)
    rel = kept - centroid[:, None]
    new_scale = float(torch.sqrt((rel ** 2).sum(dim=0)).mean() * 3.0)
    return centroid.cpu().numpy(), new_scale, kept.T.cpu().numpy()


def get_normalization(source_dir: str, use_linear_init: bool = False,
                      seed: int = 0, refine_hull: bool = False,
                      device="cuda") -> np.ndarray:
    """Normalize ``source_dir`` in place: rewrite its ``cameras.npz`` (or
    ``cameras_linear_init.npz``) with the scale mat -> the scale mat."""
    print("Preprocessing", source_dir)
    n_points = 1000 if use_linear_init else 100
    cameras_filename = ("cameras_linear_init" if use_linear_init else "cameras")

    cameras = np.load(os.path.join(source_dir, cameras_filename + ".npz"))
    mask_points_all, masks_all = load_mask_points(
        os.path.join(source_dir, "mask"))
    n_cams = len(masks_all)
    Ps = np.array([cameras[f"world_mat_{i}"][:3, :].astype(np.float64)
                   for i in range(n_cams)])

    normalization, _ = estimate_normalization(Ps, mask_points_all, n_points,
                                              seed, device)
    if refine_hull:
        # carve over 3x the epipolar estimate's scale, so that a centroid
        # off the true centre does not clip the hull
        centroid, scale, _ = refine_visual_hull(
            masks_all, Ps, 3.0 * float(normalization[0, 0]),
            normalization[:3, 3], device=device)
        normalization = np.eye(4, dtype=np.float32)
        normalization[:3, 3] = centroid
        normalization[0, 0] = normalization[1, 1] = normalization[2, 2] = scale

    cameras_new = {}
    for i in range(n_cams):
        cameras_new[f"scale_mat_{i}"] = normalization
        cameras_new[f"world_mat_{i}"] = np.concatenate(
            [Ps[i], np.array([[0, 0, 0, 1.0]])], axis=0).astype(np.float32)
    np.savez(os.path.join(source_dir, cameras_filename + ".npz"), **cameras_new)
    print(normalization)
    return normalization


def main(argv=None):
    parser = argparse.ArgumentParser(description="scene normalization of an "
                                                 "IDR case")
    parser.add_argument("--source_dir", type=str, default="")
    parser.add_argument("--dtu", default=False, action="store_true",
                        help="apply to all data/DTU/scan* scenes of the repo")
    parser.add_argument("--use_linear_init", default=False, action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--refine_visual_hull", default=False,
                        action="store_true",
                        help="refine the estimate by silhouette carving")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    opt = parser.parse_args(argv)
    if opt.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu to run on the CPU")

    if opt.dtu:
        scenes = sorted(glob(os.path.join(ROOT, "data", "DTU", "scan*")))
    else:
        scenes = [opt.source_dir]
    for scene_dir in scenes:
        get_normalization(scene_dir, opt.use_linear_init, opt.seed,
                          opt.refine_visual_hull, opt.device)
    print("Done!")


if __name__ == "__main__":
    main()
