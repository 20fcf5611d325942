"""Write a synthetic scene to disk in the IDR layout the loader reads:

    <out>/cameras.npz   (world_mat_i, scale_mat_i)
    <out>/normal/NNN.png, <out>/albedo/NNN.png, <out>/mask/NNN.png

    python -m rnb_tpu_torch.tools.make_synthetic_case --out data/sphere
        [--shape sphere|torus] [--radius R] [--n_views V] [--size S]
        [--degrade] [--seed N] [--width W --height H] [--center X Y Z]
        [--normalize [--device cuda|cpu]]

The port's copy of ``tools/make_synthetic_case.py`` (``write_case``,
``degrade_capture``): the scenes come from ``rnb_tpu_torch.data.dataset``
on the CPU, the PNGs from ``rnb_tpu_torch.utils.io``. ``--normalize``
writes the case un-normalized (identity scale mats), then normalizes it
with ``rnb_tpu_torch.preprocess.preprocess_cameras`` (visual-hull refined)
on ``--device``, the card by default.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from rnb_tpu_torch.data import dataset as ds
from rnb_tpu_torch.utils import io


def degrade_capture(normals: np.ndarray, albedos: np.ndarray,
                    masks: np.ndarray, world_mats: list, H: int, W: int,
                    normal_noise_deg: float = 3.0, mask_morph_px: int = 2,
                    focal_err: float = 0.002, seed: int = 1):
    """Degrade a clean capture the way photometric-stereo estimates differ
    from ground truth: per-pixel angular noise on the normals, mask
    erosion / dilation (alternating per view), a smooth ±5% multiplicative
    albedo residual, and a ±focal_err focal miscalibration of the stored
    cameras (the maps stay rendered with the true ones). 8-bit quantization
    comes from writing the PNGs at bit depth 8.
    -> degraded (normals, albedos, masks, world_mats)."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    V = masks.shape[0]
    normals = normals.copy()
    albedos = albedos.copy()
    masks_out = np.empty_like(masks)
    world_out = []

    sigma = np.deg2rad(normal_noise_deg)
    for v in range(V):
        n = normals[v]
        m = masks[v] > 0.5
        # normalize(n + tan(theta) t) rotates n by theta toward the tangent t
        t = rng.normal(size=n.shape)
        t -= (t * n).sum(-1, keepdims=True) * n
        t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
        theta = rng.normal(0.0, sigma, size=n.shape[:2] + (1,))
        n_noisy = n + np.tan(theta) * t
        n_noisy /= np.maximum(np.linalg.norm(n_noisy, axis=-1, keepdims=True),
                              1e-12)
        normals[v] = np.where(m[..., None], n_noisy, 0.0)

        r = int(rng.integers(1, mask_morph_px + 1))
        if v % 2 == 0:
            m_new = ndimage.binary_erosion(m, iterations=r)
        else:
            m_new = ndimage.binary_dilation(m, iterations=r)
        masks_out[v] = m_new.astype(masks.dtype)

        g = 1.0 + rng.normal(0.0, 0.05, size=(6, 6))
        field = np.asarray(io.resize_image(
            np.repeat(g[..., None], 3, axis=-1).astype(np.float32), W, H))
        albedos[v] = np.clip(albedos[v] * np.clip(field, 0.8, 1.2), 0.0, 1.0)

        # focal miscalibration of the stored projection: P' = K' K^-1 P
        eps = rng.uniform(-focal_err, focal_err)
        focal = 1.2 * max(H, W)
        K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1.0]])
        Kp = K.copy()
        Kp[0, 0] *= 1.0 + eps
        Kp[1, 1] *= 1.0 + eps
        wm = np.asarray(world_mats[v]).copy()
        wm[:3, :4] = Kp @ np.linalg.inv(K) @ wm[:3, :4]
        world_out.append(wm.astype(np.float32))

    return normals, albedos, masks_out, world_out


def write_case(out_dir: str, n_views: int = 8, H: int = 128, W: int = 128,
               radius: float = 0.4, seed: int = 0,
               shape: str = "sphere", degrade: bool = False,
               normal_noise_deg: float = 3.0, mask_morph_px: int = 2,
               focal_err: float = 0.002, center=(0.0, 0.0, 0.0),
               normalize: bool = False, device="cuda") -> str:
    """Write the scene: 16-bit maps for a clean capture, 8-bit degraded;
    with ``normalize``, then normalize it on ``device``."""
    if shape == "torus":
        scene = ds.make_torus_scene(n_views=n_views, H=H, W=W, center=center,
                                    device="cpu")
    else:
        scene = ds.make_sphere_scene(n_views=n_views, H=H, W=W, radius=radius,
                                     device="cpu")
    os.makedirs(out_dir, exist_ok=True)

    normals = scene.arrays.normals.numpy()
    albedos = scene.arrays.albedos.numpy()
    masks = scene.arrays.masks.numpy()
    world_mats = scene.world_mats_np
    bit_depth = 16
    if degrade:
        normals, albedos, masks, world_mats = degrade_capture(
            normals, albedos, masks, world_mats, H, W,
            normal_noise_deg=normal_noise_deg, mask_morph_px=mask_morph_px,
            focal_err=focal_err, seed=seed + 1)
        bit_depth = 8

    cams = {}
    for i in range(n_views):
        cams[f"world_mat_{i}"] = world_mats[i]
        cams[f"scale_mat_{i}"] = scene.scale_mats_np[i]
    np.savez(os.path.join(out_dir, "cameras.npz"), **cams)

    for i in range(n_views):
        io.save_normal(os.path.join(out_dir, "normal", f"{i:03d}.png"),
                       normals[i], bit_depth=bit_depth)
        io.save_image(os.path.join(out_dir, "albedo", f"{i:03d}.png"),
                      albedos[i], bit_depth=bit_depth)
        io.save_image(os.path.join(out_dir, "mask", f"{i:03d}.png"),
                      np.stack([masks[i]] * 3, axis=-1))

    if normalize:
        from rnb_tpu_torch.preprocess.preprocess_cameras import get_normalization
        # refine_hull: the epipolar estimate's scale (the std of the
        # interval end points) is ~0.5x a torus's radius, which would put
        # the object outside the unit sphere; the visual hull bounds it at
        # ~0.4-0.5 of the sphere
        get_normalization(out_dir, seed=seed, refine_hull=True, device=device)
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description="write a synthetic IDR case")
    ap.add_argument("--out", default="./data/sphere")
    ap.add_argument("--n_views", type=int, default=8)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--width", type=int, default=0,
                    help="image width (default: --size)")
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--center", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                    help="world-space object center (torus only)")
    ap.add_argument("--normalize", action="store_true",
                    help="write un-normalized, then run the scene "
                         "normalization (non-identity scale mats)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the normalization")
    ap.add_argument("--radius", type=float, default=0.4)
    ap.add_argument("--shape", default="sphere", choices=["sphere", "torus"])
    ap.add_argument("--degrade", action="store_true",
                    help="degrade the capture (normal noise, mask morphology, "
                         "8-bit maps, focal error)")
    ap.add_argument("--normal_noise_deg", type=float, default=3.0)
    ap.add_argument("--mask_morph_px", type=int, default=2)
    ap.add_argument("--focal_err", type=float, default=0.002)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.normalize and args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device for --normalize: pass --device cpu")
    path = write_case(args.out, args.n_views,
                      args.height or args.size, args.width or args.size,
                      args.radius, seed=args.seed, shape=args.shape,
                      degrade=args.degrade,
                      normal_noise_deg=args.normal_noise_deg,
                      mask_morph_px=args.mask_morph_px,
                      focal_err=args.focal_err, center=tuple(args.center),
                      normalize=args.normalize, device=args.device)
    print(f"wrote synthetic case to {path}"
          + (" (degraded capture)" if args.degrade else ""))


if __name__ == "__main__":
    main()
