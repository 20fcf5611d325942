"""The synthetic capture of a run, in DiLiGenT-MV's layout, made from the seed.

DiLiGenT-MV (Li et al., IEEE TIP 2020), the benchmark that RNb-NeuS
evaluates on, holds 20 views of 612x512 pixels taken on a turntable, with a
normal map, an albedo map and a mask a view, and cameras in IDR's
``cameras.npz`` (``world_mat_i``, ``scale_mat_i``). The real captures are
not in the repository, so each run writes one of that layout from its seed:

  * the object: a star-shaped solid ``|p| = r(p/|p|)`` in the normalized
    space of the cameras, ``r`` a radius with six seeded bumps, inside the
    unit sphere, traced on the device in float64 (the normals by autograd of
    the implicit function);
  * the cameras: a ring of ``n_views`` cameras at one elevation around the
    origin, each looking at it, with one intrinsic matrix; ``scale_mat`` maps
    the normalized space to a world in millimetres (a seeded scale and
    offset), and ``world_mat = K [R | -R C] scale_mat^-1``;
  * the maps: camera-space normals stored as DiLiGenT does (y and z
    negated, 16-bit), a seeded smooth albedo texture (16-bit), the mask as an
    8-bit grey image.

Every number of the layout comes from the configuration's ``data`` block
(``n_views``, ``height``, ``width``, ``focal``, ``cam_dist``,
``elevation_deg``). ``Scene`` keeps the codes written to the files and the
exact cameras; the plain reference reads those, never what the program
loaded.
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct
import zlib

import numpy as np
import torch

N_BUMPS = 6


@dataclasses.dataclass
class Scene:
    """What the capture was made from: the stored codes (``normal_codes``
    [V, H, W, 3] as written, y and z negated; ``albedo_codes``
    [V, H, W, 3], 16-bit codes; ``mask_codes`` uint8 [V, H, W], 0 or 255) on the device,
    and the exact cameras in normalized space (float64 numpy: ``K`` [3, 3],
    ``R_w2c`` [V, 3, 3], ``centers`` [V, 3]) with the ``scale_mat`` [4, 4]."""
    normal_codes: torch.Tensor          # int32 tensors holding the codes
    albedo_codes: torch.Tensor
    mask_codes: torch.Tensor
    K: np.ndarray
    R_w2c: np.ndarray
    centers: np.ndarray
    scale_mat: np.ndarray

    @property
    def n_views(self) -> int:
        return int(self.mask_codes.shape[0])


def scene_params(seed: int) -> dict:
    """The seeded shape, texture, camera-ring phase and world frame."""
    rng = np.random.default_rng([seed, 101])
    dirs = rng.normal(size=(N_BUMPS, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return {
        "r0": rng.uniform(0.55, 0.68),
        "bump_amp": rng.uniform(0.02, 0.05, N_BUMPS),
        "bump_freq": dirs * rng.integers(2, 5, N_BUMPS)[:, None],
        "bump_phase": rng.uniform(0, 2 * np.pi, N_BUMPS),
        "albedo_base": rng.uniform(0.35, 0.85, 3),
        "albedo_freq": rng.normal(size=(2, 3)) * 4.0,
        "albedo_phase": rng.uniform(0, 2 * np.pi, 2),
        "azimuth0": rng.uniform(0, 2 * np.pi),
        "scale": rng.uniform(80.0, 160.0),
        "offset": rng.uniform(-50.0, 50.0, 3),
    }


def _radius(prm: dict, u: torch.Tensor) -> torch.Tensor:
    """r(u) for unit directions u [..., 3]."""
    f = torch.as_tensor(prm["bump_freq"], dtype=u.dtype, device=u.device)
    a = torch.as_tensor(prm["bump_amp"], dtype=u.dtype, device=u.device)
    ph = torch.as_tensor(prm["bump_phase"], dtype=u.dtype, device=u.device)
    return prm["r0"] * (1.0 + (a * torch.sin(u @ f.T + ph)).sum(-1))


def implicit(prm: dict, p: torch.Tensor) -> torch.Tensor:
    """|p| - r(p/|p|): negative inside the object."""
    n = torch.linalg.vector_norm(p, dim=-1).clamp_min(1e-9)
    return n - _radius(prm, p / n[..., None])


def look_at_origin(C: np.ndarray) -> np.ndarray:
    """World-to-camera rotation (rows x, y, z) of a camera at C whose z
    axis points at the origin."""
    z = -C / np.linalg.norm(C)
    up = np.array([0.0, 0.0, 1.0])
    x = np.cross(z, up)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z])


def cameras(data: dict, prm: dict):
    """(K [3,3], R_w2c [V,3,3], centers [V,3]) in normalized space."""
    V, H, W = data["n_views"], data["height"], data["width"]
    K = np.array([[data["focal"], 0.0, W / 2.0],
                  [0.0, data["focal"], H / 2.0],
                  [0.0, 0.0, 1.0]])
    el = math.radians(data["elevation_deg"])
    rots, centers = [], []
    for v in range(V):
        az = prm["azimuth0"] + 2 * math.pi * v / V
        C = data["cam_dist"] * np.array([math.cos(az) * math.cos(el),
                                         math.sin(az) * math.cos(el),
                                         math.sin(el)])
        rots.append(look_at_origin(C))
        centers.append(C)
    return K, np.stack(rots), np.stack(centers)


def _trace_view(prm, K, R, C, H, W, device, iters=120):
    """Sphere-trace one view in float64 -> (hit [H,W] bool, p [H,W,3])."""
    dt = torch.float64
    px, py = torch.meshgrid(torch.arange(W, dtype=dt, device=device),
                            torch.arange(H, dtype=dt, device=device),
                            indexing="xy")
    pix = torch.stack([px, py, torch.ones_like(px)], dim=-1)
    d_cam = pix @ torch.as_tensor(np.linalg.inv(K).T, device=device)
    d_cam = d_cam / torch.linalg.vector_norm(d_cam, dim=-1, keepdim=True)
    d = d_cam @ torch.as_tensor(R, device=device)        # rows of R: cam axes
    o = torch.as_tensor(C, device=device)
    dist = float(np.linalg.norm(C))
    t = torch.full((H, W), dist - 1.0, dtype=dt, device=device)
    for _ in range(iters):
        t = t + 0.5 * implicit(prm, o + t[..., None] * d)
    p = o + t[..., None] * d
    hit = (implicit(prm, p).abs() < 1e-6) & (t < dist + 1.0)
    return hit, p


def _normals_world(prm, p: torch.Tensor) -> torch.Tensor:
    p = p.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(implicit(prm, p).sum(), p)
    return g / torch.linalg.vector_norm(g, dim=-1, keepdim=True).clamp_min(1e-12)


def _albedo(prm, p: torch.Tensor) -> torch.Tensor:
    f = torch.as_tensor(prm["albedo_freq"], dtype=p.dtype, device=p.device)
    ph = torch.as_tensor(prm["albedo_phase"], dtype=p.dtype, device=p.device)
    tex = torch.sin(p @ f.T + ph)                           # [..., 2]
    base = torch.as_tensor(prm["albedo_base"], dtype=p.dtype, device=p.device)
    shade = 0.75 + 0.2 * tex[..., :1] + 0.05 * tex[..., 1:]
    return (base * shade).clamp(0.0, 1.0)


def make_scene(seed: int, data: dict, device) -> Scene:
    """The seeded capture of the configuration's layout, on ``device``."""
    prm = scene_params(seed)
    V, H, W = data["n_views"], data["height"], data["width"]
    K, R, C = cameras(data, prm)
    n_codes = torch.empty((V, H, W, 3), dtype=torch.int32, device=device)
    a_codes = torch.empty_like(n_codes)
    m_codes = torch.empty((V, H, W), dtype=torch.uint8, device=device)
    for v in range(V):
        hit, p = _trace_view(prm, K, R[v], C[v], H, W, device)
        n_cam = _normals_world(prm, p) @ torch.as_tensor(R[v].T, device=device)
        n_cam = torch.where(hit[..., None], n_cam, torch.zeros_like(n_cam))
        stored = n_cam * n_cam.new_tensor([1.0, -1.0, -1.0])
        n_codes[v] = torch.round((stored + 1.0) * 0.5 * 65535.0).to(torch.int32)
        alb = torch.where(hit[..., None], _albedo(prm, p), torch.zeros_like(p))
        a_codes[v] = torch.round(alb * 65535.0).to(torch.int32)
        m_codes[v] = hit.to(torch.uint8) * 255
    S = np.eye(4)
    S[:3, :3] *= prm["scale"]
    S[:3, 3] = prm["offset"]
    return Scene(normal_codes=n_codes, albedo_codes=a_codes, mask_codes=m_codes,
                 K=K, R_w2c=R, centers=C, scale_mat=S)


# ---------------------------------------------------------------------------
# the files
# ---------------------------------------------------------------------------

def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray) -> None:
    """uint8 or uint16 [H,W] (grey) or [H,W,3] (RGB) -> PNG, filter 0."""
    depth = 16 if arr.dtype == np.uint16 else 8
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    rows = np.ascontiguousarray(arr.astype(">u2" if depth == 16 else np.uint8))
    rows = rows.reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, 0 if c == 1 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
                + _chunk(b"IEND", b""))


def write_case(scene: Scene, out_dir: str) -> str:
    """``cameras.npz``, ``normal/``, ``albedo/`` and ``mask/`` PNGs in the
    IDR layout of RNb-NeuS's confs."""
    for sub in ("normal", "albedo", "mask"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    cams = {}
    for v in range(scene.n_views):
        P = np.eye(4)
        P[:3, :4] = scene.K @ np.concatenate(
            [scene.R_w2c[v], -(scene.R_w2c[v] @ scene.centers[v])[:, None]], axis=1)
        cams[f"world_mat_{v}"] = (P @ np.linalg.inv(scene.scale_mat)).astype(np.float32)
        cams[f"scale_mat_{v}"] = scene.scale_mat.astype(np.float32)
    np.savez(os.path.join(out_dir, "cameras.npz"), **cams)
    normals = scene.normal_codes.cpu().numpy().astype(np.uint16)
    albedos = scene.albedo_codes.cpu().numpy().astype(np.uint16)
    masks = scene.mask_codes.cpu().numpy()
    for v in range(scene.n_views):
        write_png(os.path.join(out_dir, "normal", f"{v:03d}.png"), normals[v])
        write_png(os.path.join(out_dir, "albedo", f"{v:03d}.png"), albedos[v])
        write_png(os.path.join(out_dir, "mask", f"{v:03d}.png"), masks[v])
    return out_dir
