"""The reference's inputs, worked out from the capture and the seed alone.

  * the maps decoded from the codes written to the files: normals
    ``2 c / 65535 - 1`` with y and z negated back to camera space, albedo
    ``c / 65535``, the mask ``c > 127``;
  * the virtual lights of RNb-NeuS (Brument et al., CVPR 2024): three
    lights at tilts 0, 120 and 240 degrees; in the warm-up phase at a slant
    of 30 degrees in camera space, after it at arctan(sqrt(2)) in the frame
    of each pixel's normal (third axis +-n with a non-negative camera z,
    completed by a cross product with the x axis, or the y axis where the
    normal lies within 0.9 of x); Lambertian targets ``albedo * max(n.l, 0)``;
  * the rays through pixel centres from the exact cameras, and the chord of
    the unit sphere ``mid -+ 1``;
  * the draws of the runner's documented scheme: step ``s`` takes the
    permutation of the views seeded by ``(seed, s // V, 0)`` at ``s % V``, and
    a generator on the device seeded by ``(seed, s, 3)`` for the pixels
    (x, then y), ``t_rand`` and ``t_out``; a render takes one draw seeded by
    ``(seed, 0, 4)`` for every chunk.

Plain float32 PyTorch; nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TILTS_DEG = (0.0, 120.0, 240.0)
SLANT_WARMUP_DEG = 30.0
SLANT_MAIN_DEG = 54.74


def decode(scene, device):
    """-> normals [V,H,W,3] (camera space), albedo [V,H,W,3], mask [V,H,W]
    as float32 on ``device``."""
    n = (scene.normal_codes.to(device, torch.float64) * (2.0 / 65535.0) - 1.0)
    n = (n * n.new_tensor([1.0, -1.0, -1.0])).float()
    a = (scene.albedo_codes.to(device, torch.float64) / 65535.0).float()
    m = (scene.mask_codes.to(device) > 127).float()
    return n, a, m


def base_lights(slant_deg: float, device) -> torch.Tensor:
    """[3, 3] u_k = -[sin s cos t, sin s sin t, cos s]."""
    s = math.radians(slant_deg)
    rows = [[-math.sin(s) * math.cos(math.radians(t)),
             -math.sin(s) * math.sin(math.radians(t)), -math.cos(s)]
            for t in TILTS_DEG]
    return torch.tensor(rows, dtype=torch.float32, device=device)


def normal_frame(n: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3], columns (b1, b2, b3), b3 = +-n/|n| with
    b3_z >= 0 (+z for a zero normal)."""
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    sign = torch.where(n[..., 2:3] > 0, 1.0, -1.0)
    b3 = torch.where(norm > 1e-8, sign * n / norm.clamp_min(1e-12),
                     n.new_tensor([0.0, 0.0, 1.0]))
    helper = torch.where(b3[..., 0:1].abs() > 0.9, n.new_tensor([0.0, 1.0, 0.0]),
                         n.new_tensor([1.0, 0.0, 0.0]))
    b1 = torch.linalg.cross(helper.expand_as(b3), b3)
    b1 = b1 / torch.linalg.vector_norm(b1, dim=-1, keepdim=True).clamp_min(1e-12)
    b2 = torch.linalg.cross(b3, b1)
    return torch.stack([b1, b2, b3], dim=-1)


def targets(n, a, R_c2w, warmup: bool):
    """(rgb [3,B,3], world light directions: [3,1,1,3] in warm-up, [3,B,1,3]
    after) for the pixels' normals n [B,3] and albedo a [B,3]."""
    if warmup:
        u = base_lights(SLANT_WARMUP_DEG, n.device)           # [3,3]
        rgb = a[None] * (n @ u.T).T.clamp_min(0.0)[..., None]
        return rgb, (u @ R_c2w.T).reshape(3, 1, 1, 3)
    u = base_lights(SLANT_MAIN_DEG, n.device)
    l_cam = torch.einsum("bij,lj->lbi", normal_frame(n), u)   # [3,B,3]
    rgb = a[None] * (n[None] * l_cam).sum(-1).clamp_min(0.0)[..., None]
    l_world = l_cam @ R_c2w.T
    return rgb, l_world[:, :, None, :]


def rays(scene, view: int, px, py, device):
    """World rays through the pixels (px, py) [B] of ``view`` -> (o, d)."""
    Kinv = torch.tensor(np.linalg.inv(scene.K), dtype=torch.float32, device=device)
    R_c2w = torch.tensor(scene.R_w2c[view].T, dtype=torch.float32, device=device)
    p = torch.stack([px.float(), py.float(), torch.ones_like(px, dtype=torch.float32)], -1)
    d = p @ Kinv.T
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    d = d @ R_c2w.T
    o = torch.tensor(scene.centers[view], dtype=torch.float32, device=device).expand_as(d)
    return o, d


def near_far(o, d):
    mid = -(o * d).sum(-1, keepdim=True) / (d * d).sum(-1, keepdim=True)
    return mid - 1.0, mid + 1.0


def view_of_step(seed: int, step: int, n_views: int) -> int:
    epoch = step // n_views
    return int(np.random.default_rng([seed, epoch, 0]).permutation(n_views)[step % n_views])


def step_draws(seed: int, step: int, bsz: int, H: int, W: int, n_outside: int,
               device):
    """(px, py, t_rand [B,1], t_out [B,n_outside] or None) of step ``step``."""
    g = torch.Generator(device=device).manual_seed(
        int(np.random.default_rng([seed, step, 3]).integers(2 ** 62)))
    px = torch.randint(0, W, (bsz,), generator=g, device=device)
    py = torch.randint(0, H, (bsz,), generator=g, device=device)
    t_rand = torch.rand((bsz, 1), generator=g, device=device) - 0.5
    t_out = (torch.rand((bsz, n_outside), generator=g, device=device)
             if n_outside > 0 else None)
    return px, py, t_rand, t_out


def render_draws(seed: int, bsz: int, n_outside: int, device):
    """(t_rand [B,1], t_out or None) shared by every chunk of a render."""
    g = torch.Generator(device=device).manual_seed(
        int(np.random.default_rng([seed, 0, 4]).integers(2 ** 62)))
    t_rand = torch.rand((bsz, 1), generator=g, device=device) - 0.5
    t_out = (torch.rand((bsz, n_outside), generator=g, device=device)
             if n_outside > 0 else None)
    return t_rand, t_out


def _quat(Rm: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) of a rotation matrix."""
    w = math.sqrt(max(0.0, 1.0 + Rm[0, 0] + Rm[1, 1] + Rm[2, 2])) / 2
    x = math.sqrt(max(0.0, 1.0 + Rm[0, 0] - Rm[1, 1] - Rm[2, 2])) / 2
    y = math.sqrt(max(0.0, 1.0 - Rm[0, 0] + Rm[1, 1] - Rm[2, 2])) / 2
    z = math.sqrt(max(0.0, 1.0 - Rm[0, 0] - Rm[1, 1] + Rm[2, 2])) / 2
    x = math.copysign(x, Rm[2, 1] - Rm[1, 2])
    y = math.copysign(y, Rm[0, 2] - Rm[2, 0])
    z = math.copysign(z, Rm[1, 0] - Rm[0, 1])
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def _rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def slerp(R0: np.ndarray, R1: np.ndarray, t: float) -> np.ndarray:
    q0, q1 = _quat(R0), _quat(R1)
    dot = float(q0 @ q1)
    if dot < 0:
        q1, dot = -q1, -dot
    ang = math.acos(min(1.0, dot))
    if ang < 1e-12:
        return R0.copy()
    q = (math.sin((1 - t) * ang) * q0 + math.sin(t * ang) * q1) / math.sin(ang)
    return _rot(q / np.linalg.norm(q))


def rays_between(scene, v0: int, v1: int, ratio: float, level: int, H: int,
                 W: int, device):
    """Rays [H/l * W/l, 3] of the camera between views v0 and v1 at
    ``ratio``: the world-to-camera rotation by spherical interpolation, its
    translation blended linearly, view 0's intrinsics (NeuS's
    ``gen_rays_between``)."""
    tx = np.linspace(0, W - 1, W // level)
    ty = np.linspace(0, H - 1, H // level)
    px, py = np.meshgrid(tx, ty, indexing="xy")
    p = np.stack([px, py, np.ones_like(px)], axis=-1)
    d = p @ np.linalg.inv(scene.K).T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    t0 = -scene.R_w2c[v0] @ scene.centers[v0]
    t1 = -scene.R_w2c[v1] @ scene.centers[v1]
    Rw2c = slerp(scene.R_w2c[v0], scene.R_w2c[v1], ratio)
    tw2c = (1.0 - ratio) * t0 + ratio * t1
    R_c2w = Rw2c.T
    center = -R_c2w @ tw2c
    d = d @ R_c2w.T
    o = np.broadcast_to(center, d.shape)

    def put(x):
        return torch.tensor(np.asarray(x, np.float32).reshape(-1, 3), device=device)

    return put(o), put(d)
