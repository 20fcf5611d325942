"""Camera model: IDR-convention projection-matrix decomposition and the
ray-vs-unit-sphere bounds (numpy; a copy of ``rnb_tpu/data/cameras.py`` so
the port needs no JAX).

Convention (IDR): pixel p=(x,y,1), camera dir = K^{-1} p, world dir =
R_c2w @ normalize(K^{-1} p); origin = camera center.
"""

from __future__ import annotations

import numpy as np


def decompose_projection(P: np.ndarray):
    """P [3,4] -> (intrinsics [4,4], pose_c2w [4,4]), as
    cv.decomposeProjectionMatrix plus the normalization K[2,2] = 1,
    pose[:3,:3] = R^T, pose[:3,3] = camera center."""
    P = np.asarray(P, dtype=np.float64)[:3, :4]
    M = P[:, :3]

    # RQ decomposition of M = K R from the QR of the flipped transpose
    flip = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    q, r = np.linalg.qr((flip @ M).T)
    K = flip @ r.T @ flip
    R = flip @ q.T

    # positive diagonal of K (cv2 convention)
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1.0
    S = np.diag(signs)
    K = K @ S
    R = S @ R
    if np.linalg.det(R) < 0:
        R = -R

    # camera center: right null vector of P
    _, _, vt = np.linalg.svd(P)
    C = vt[-1]
    C = C[:3] / C[3]

    K = K / K[2, 2]
    intrinsics = np.eye(4, dtype=np.float32)
    intrinsics[:3, :3] = K.astype(np.float32)

    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T.astype(np.float32)
    pose[:3, 3] = C.astype(np.float32)
    return intrinsics, pose


def near_far_from_sphere(rays_o, rays_d):
    """Ray-vs-unit-sphere chord bounds; numpy arrays or tensors."""
    a = (rays_d ** 2).sum(-1, keepdims=True)
    b = 2.0 * (rays_o * rays_d).sum(-1, keepdims=True)
    mid = 0.5 * (-b) / a
    return mid - 1.0, mid + 1.0
