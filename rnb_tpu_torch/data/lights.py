"""Virtual photometric-stereo lights on tensors.

The per-pixel light frame is a closed-form function of the normal: an
orthonormal completion whose third column is ±n̂ with a non-negative camera
z, built with a helper-axis cross product (no per-pixel SVD). Tilts
{0°,120°,240°}; slant 30° for the warm-up's fixed camera-space lights and
arctan(sqrt(2)) ≈ 54.74° for the per-pixel main lights; base dirs
``u = -[sinσ cosτ, sinσ sinτ, cosσ]``.
"""

from __future__ import annotations

import numpy as np
import torch

TILT_DEG = (0.0, 120.0, 240.0)
SLANT_WARMUP_DEG = 30.0
SLANT_MAIN_DEG = 54.74  # arctan(sqrt(2)), the photometric-stereo optimal slant
N_LIGHTS = 3


def base_light_dirs(slant_deg: float) -> np.ndarray:
    """[n_lights, 3] camera-space base dirs u_k = -[sinσcosτ, sinσsinτ, cosσ]."""
    tilt = np.radians(TILT_DEG)
    slant = np.radians(slant_deg)
    u = -np.stack([
        np.sin(slant) * np.cos(tilt),
        np.sin(slant) * np.sin(tilt),
        np.full_like(tilt, np.cos(slant)),
    ], axis=-1)
    return u.astype(np.float32)


def warmup_light_dirs_cam() -> np.ndarray:
    return base_light_dirs(SLANT_WARMUP_DEG)


def normal_frames(normals: torch.Tensor) -> torch.Tensor:
    """[..., 3] camera-space normals -> [..., 3, 3] rotations (columns
    b1, b2, b3) with b3 = ±n̂ chosen so b3_z ≥ 0, det = +1. A zero normal
    (background pixel) gets a finite arbitrary frame."""
    n = normals
    s = torch.where(n[..., 2:3] > 0, 1.0, -1.0)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    b3 = s * n / torch.clamp_min(norm, 1e-12)
    ez = n.new_tensor([0.0, 0.0, 1.0])
    b3 = torch.where(norm > 1e-8, b3, ez)

    use_y = b3[..., 0:1].abs() > 0.9
    h = torch.where(use_y, n.new_tensor([0.0, 1.0, 0.0]),
                    n.new_tensor([1.0, 0.0, 0.0]))
    b1 = torch.linalg.cross(h.expand_as(b3), b3)
    b1 = b1 / torch.clamp_min(torch.linalg.vector_norm(b1, dim=-1, keepdim=True),
                              1e-12)
    b2 = torch.linalg.cross(b3, b1)
    return torch.stack([b1, b2, b3], dim=-1)


def per_pixel_light_dirs_cam(normals: torch.Tensor) -> torch.Tensor:
    """[..., 3] normals -> [n_lights, ..., 3] per-pixel main lights
    l_k = R(n) u_k."""
    R = normal_frames(normals)
    u = torch.as_tensor(base_light_dirs(SLANT_MAIN_DEG), device=normals.device)
    return torch.einsum("...ij,lj->l...i", R, u)


def shade(normals: torch.Tensor, light_dirs: torch.Tensor,
          albedo: torch.Tensor | None) -> torch.Tensor:
    """Lambertian supervision: albedo ⊙ max(n·l, 0), or the shading tiled
    to RGB without albedo. normals [..., 3]; light_dirs [L, ..., 3] or
    [L, 3]; returns [L, ..., 3]."""
    if light_dirs.dim() == 2:
        shaded = torch.einsum("...c,lc->l...", normals, light_dirs)
    else:
        shaded = (normals[None] * light_dirs).sum(-1)
    shaded = torch.clamp_min(shaded, 0.0)[..., None]
    if albedo is None:
        return shaded.expand(*shaded.shape[:-1], 3)
    return albedo[None] * shaded
