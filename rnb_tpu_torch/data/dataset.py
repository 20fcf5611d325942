"""Device-resident dataset with on-the-fly virtual-light supervision.

Only the source maps (normals, albedo, masks) live on the device as
``[V, H, W(,3)]`` tensors. The per-pixel lights, the warm-up and main
supervision colours, the rays and near/far are computed in the train step
from the sampled pixel indices (``rnb_tpu_torch.data.lights`` has the
closed-form frames): no per-step host-to-device traffic.

Pixel draws are inputs (``sample_rays_on_all_lights`` takes ``px``, ``py``;
``draw_pixels`` makes them from a ``torch.Generator``), so the tests can
feed the JAX package's draws.

``Dataset.from_conf`` loads the IDR layout from disk: ``cameras.npz`` with
``world_mat_i`` / ``scale_mat_i``, ``mask/*.png``, ``normal/*.png`` and
optionally ``albedo/*.png`` (``albedo_dir = ''`` means no albedo). As in
the JAX package, the maps go to the device quantized (normals and albedo
as uint16, masks as uint8) and are decoded there, to the JAX package's
float32 values bit for bit (``upload_quantized``, ``decode_maps``).
"""

from __future__ import annotations

import os
from glob import glob
from typing import NamedTuple

import numpy as np
import torch

from rnb_tpu_torch.data import cameras as cam
from rnb_tpu_torch.data import lights
from rnb_tpu_torch.utils import io, trace


class DataArrays(NamedTuple):
    normals: torch.Tensor          # [V, H, W, 3] camera-space
    albedos: torch.Tensor          # [V, H, W, 3] (ones when no_albedo)
    masks: torch.Tensor            # [V, H, W]
    intrinsics_inv: torch.Tensor   # [V, 4, 4]
    pose_all: torch.Tensor         # [V, 4, 4] cam-to-world
    lights_warmup_world: torch.Tensor  # [V, L, 3]


class RayBatch(NamedTuple):
    rays_o: torch.Tensor           # [B, 3]
    rays_d: torch.Tensor           # [B, 3]
    mask: torch.Tensor             # [B, 1]
    rgb_warmup: torch.Tensor       # [L, B, 3]
    rgb: torch.Tensor              # [L, B, 3]
    lights_warmup: torch.Tensor    # [L, 3]    world, per-view
    lights: torch.Tensor           # [L, B, 3] world, per-pixel
    near: torch.Tensor             # [B, 1]
    far: torch.Tensor              # [B, 1]
    pixels_x: torch.Tensor         # [B]
    pixels_y: torch.Tensor         # [B]


def draw_pixels(gen: torch.Generator, batch_size: int, H: int, W: int):
    """Uniform pixel indices (px in [0, W), py in [0, H)) on the
    generator's device."""
    px = torch.randint(0, W, (batch_size,), generator=gen, device=gen.device)
    py = torch.randint(0, H, (batch_size,), generator=gen, device=gen.device)
    return px, py


def _rays_from_pixels(arrays: DataArrays, view_idx, px, py):
    """Unproject pixel centers to world rays."""
    p = torch.stack([px.float(), py.float(), torch.ones_like(px, dtype=torch.float32)],
                    dim=-1)
    Kinv = arrays.intrinsics_inv[view_idx, :3, :3]
    pose = arrays.pose_all[view_idx]
    d_cam = p @ Kinv.T
    d_cam = d_cam / torch.linalg.vector_norm(d_cam, dim=-1, keepdim=True)
    rays_d = d_cam @ pose[:3, :3].T
    rays_o = pose[:3, 3].expand_as(rays_d)
    return rays_o, rays_d


def sample_rays_on_all_lights(arrays: DataArrays, view_idx, px, py) -> RayBatch:
    """Rays, supervision under all lights, and the lights themselves for
    the pixels (px, py) of one view."""
    n = arrays.normals[view_idx, py, px]          # [B,3] camera space
    a = arrays.albedos[view_idx, py, px]          # [B,3]
    m = arrays.masks[view_idx, py, px][:, None]   # [B,1]
    pose_r = arrays.pose_all[view_idx, :3, :3]

    # warm-up: fixed camera-space lights
    u_warm = torch.as_tensor(lights.warmup_light_dirs_cam(), device=n.device)
    rgb_warmup = lights.shade(n, u_warm, a)                  # [L,B,3]
    lights_warmup_world = arrays.lights_warmup_world[view_idx]

    # main: per-pixel closed-form frames
    l_cam = lights.per_pixel_light_dirs_cam(n)               # [L,B,3]
    rgb_main = lights.shade(n, l_cam, a)
    l_world = torch.einsum("ij,lbj->lbi", pose_r, l_cam)

    rays_o, rays_d = _rays_from_pixels(arrays, view_idx, px, py)
    near, far = cam.near_far_from_sphere(rays_o, rays_d)
    return RayBatch(rays_o=rays_o, rays_d=rays_d, mask=m,
                    rgb_warmup=rgb_warmup, rgb=rgb_main,
                    lights_warmup=lights_warmup_world, lights=l_world,
                    near=near, far=far, pixels_x=px, pixels_y=py)


def gen_rays_at(arrays: DataArrays, view_idx: int, resolution_level: int = 1):
    """Full-view ray grid: pixels at linspace(0, W-1, W//l) ->
    (rays_o, rays_d [H', W', 3], float pixel grids px, py [H', W'])."""
    _, H, W, _ = arrays.normals.shape
    l = resolution_level
    dev = arrays.normals.device
    tx = torch.linspace(0, W - 1, W // l, device=dev)
    ty = torch.linspace(0, H - 1, H // l, device=dev)
    py, px = torch.meshgrid(ty, tx, indexing="ij")   # [H', W']
    p = torch.stack([px, py, torch.ones_like(px)], dim=-1)
    Kinv = arrays.intrinsics_inv[view_idx, :3, :3]
    pose = arrays.pose_all[view_idx]
    d_cam = p @ Kinv.T
    d_cam = d_cam / torch.linalg.vector_norm(d_cam, dim=-1, keepdim=True)
    rays_d = d_cam @ pose[:3, :3].T
    rays_o = pose[:3, 3].expand_as(rays_d)
    return rays_o, rays_d, px, py


def lights_at_pixels(arrays: DataArrays, view_idx, light_idx, px, py):
    """World main-light directions [N,3] of light ``light_idx`` at integer
    pixels px, py [N]."""
    n = arrays.normals[view_idx, py, px]
    l_cam = lights.per_pixel_light_dirs_cam(n)[light_idx]
    pose_r = arrays.pose_all[view_idx, :3, :3]
    return l_cam @ pose_r.T


def synth_images(arrays: DataArrays, view_idx):
    """Warm-up and main supervision images of one view under every light
    -> ([L,H,W,3], [L,H,W,3])."""
    n = arrays.normals[view_idx]
    a = arrays.albedos[view_idx]
    u_warm = torch.as_tensor(lights.warmup_light_dirs_cam(), device=n.device)
    img_warm = lights.shade(n, u_warm, a)
    img_main = lights.shade(n, lights.per_pixel_light_dirs_cam(n), a)
    return img_warm, img_main


# The JAX package's decode of the quantized maps as XLA compiles it on the
# CPU: each division folded into a product by an f32 constant, the normals'
# product and shift fused into one multiply-add. In float64 a 16-bit code
# times a 24-bit constant, and that product less 1, are exact, so one
# rounding to float32 gives the same bits on any device.
_INV16 = float(np.float32(1.0) / np.float32(65535.0))


def encode_maps(normals_np, albedos_np, masks_np):
    """Host side of the quantized upload, as the JAX package does it:
    ``rint(clip((n + 1) / 2, 0, 1) * 65535)`` and ``rint(clip(a, 0, 1) *
    65535)`` as uint16, ``mask > 0.5`` as uint8."""
    n16 = np.rint(np.clip((np.asarray(normals_np) + 1.0) * 0.5, 0, 1)
                  * 65535.0).astype(np.uint16)
    a16 = np.rint(np.clip(np.asarray(albedos_np), 0, 1)
                  * 65535.0).astype(np.uint16)
    m8 = (np.asarray(masks_np) > 0.5).astype(np.uint8)
    return n16, a16, m8


def decode_maps(n16: torch.Tensor, a16: torch.Tensor, m8: torch.Tensor):
    """Device side: ``n / 65535 * 2 - 1``, ``a / 65535`` and the mask as
    float32, on the tensors' device."""
    n = (n16.to(torch.float64) * (2.0 * _INV16) - 1.0).to(torch.float32)
    a = (a16.to(torch.float64) * _INV16).to(torch.float32)
    return n, a, m8.to(torch.float32)


class Dataset:
    """Owns the device tensors, the host camera matrices and the mesh bbox.

    ``upload_quantized`` ships the maps to the device as uint16 (normals,
    albedo) and uint8 (masks) and decodes them there (``decode_maps``), as
    the JAX package's loader does; ``from_conf`` turns it on. Off, the
    float32 maps go as they are."""

    def __init__(self, normals_np, albedos_np, masks_np, world_mats, scale_mats,
                 object_scale_mat=None, no_albedo: bool = False, device="cuda",
                 upload_quantized: bool = False):
        self.no_albedo = bool(no_albedo or albedos_np is None)
        self.n_images, self.H, self.W = masks_np.shape[:3]
        self.n_lights = lights.N_LIGHTS
        self.device = torch.device(device)

        self.world_mats_np = [np.asarray(w, np.float32) for w in world_mats]
        self.scale_mats_np = [np.asarray(s, np.float32) for s in scale_mats]
        intrinsics_list, pose_list = [], []
        for world_mat, scale_mat in zip(self.world_mats_np, self.scale_mats_np):
            intr, pose = cam.decompose_projection((world_mat @ scale_mat)[:3, :4])
            intrinsics_list.append(intr)
            pose_list.append(pose)
        intrinsics_all = np.stack(intrinsics_list)
        pose_all = np.stack(pose_list)

        # warm-up lights rotated to world per view
        u_warm = lights.warmup_light_dirs_cam()
        lights_warmup_world = np.einsum("vij,lj->vli", pose_all[:, :3, :3], u_warm)

        if self.no_albedo:
            albedos_np = np.ones_like(normals_np)

        def put(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        if upload_quantized:
            normals, albedos, masks = decode_maps(*(
                torch.as_tensor(a, device=self.device)
                for a in encode_maps(normals_np, albedos_np, masks_np)))
        else:
            normals, albedos, masks = map(put, (normals_np, albedos_np, masks_np))
        self.arrays = DataArrays(
            normals=normals,
            albedos=albedos,
            masks=masks,
            intrinsics_inv=put(np.linalg.inv(intrinsics_all)),
            pose_all=put(pose_all),
            lights_warmup_world=put(lights_warmup_world),
        )
        self.intrinsics_all = intrinsics_all
        self.pose_all_np = pose_all
        self.focal = float(intrinsics_all[0, 0, 0])

        # mesh ROI bbox
        if object_scale_mat is None:
            object_scale_mat = self.scale_mats_np[0]
        bbox_min = np.array([-1.01, -1.01, -1.01, 1.0])
        bbox_max = np.array([1.01, 1.01, 1.01, 1.0])
        inv0 = np.linalg.inv(self.scale_mats_np[0])
        self.object_bbox_min = (inv0 @ object_scale_mat @ bbox_min[:, None])[:3, 0]
        self.object_bbox_max = (inv0 @ object_scale_mat @ bbox_max[:, None])[:3, 0]

    @classmethod
    def from_conf(cls, conf, no_albedo: bool = False, device="cuda",
                  view_subset: list[int] | None = None) -> "Dataset":
        """Load the IDR layout named by a ``dataset`` conf section; the
        maps go to the device quantized (``upload_quantized``).

        ``view_subset`` loads only these global view indices, in order,
        repeats allowed (the view-sharded path: ``parallel/data.py`` gives
        each rank its list); the files of a view not listed are never read.
        ``global_view_indices`` and ``n_images_global`` record the choice."""
        data_dir = conf.get_string("data_dir")
        normal_dir = conf.get_string("normal_dir", default="normal")
        albedo_dir = conf.get_string("albedo_dir", default="")
        mask_dir = conf.get_string("mask_dir", default="mask")
        render_cameras_name = conf.get_string("render_cameras_name")
        object_cameras_name = conf.get_string("object_cameras_name")
        if albedo_dir == "":
            no_albedo = True

        camera_dict = np.load(os.path.join(data_dir, render_cameras_name))
        mask_files = sorted(glob(os.path.join(data_dir, mask_dir, "*.png")))
        normal_files = sorted(glob(os.path.join(data_dir, normal_dir, "*.png")))
        if not mask_files or len(normal_files) != len(mask_files):
            raise FileNotFoundError(
                f"{data_dir}: {len(mask_files)} masks and {len(normal_files)} "
                "normal maps (need the same number, at least one)")
        sel = (list(view_subset) if view_subset is not None
               else list(range(len(mask_files))))
        masks_np = np.stack([io.load_mask(mask_files[i]) for i in sel])
        normals_np = np.stack([io.load_normal(normal_files[i]) for i in sel])
        albedos_np = None
        if not no_albedo:
            albedo_files = sorted(glob(os.path.join(data_dir, albedo_dir, "*.png")))
            albedos_np = np.stack([io.load_image(albedo_files[i]) for i in sel])

        world_mats = [camera_dict[f"world_mat_{i}"].astype(np.float32)
                      for i in sel]
        scale_mats = [camera_dict[f"scale_mat_{i}"].astype(np.float32)
                      for i in sel]
        object_scale_mat = np.load(
            os.path.join(data_dir, object_cameras_name))["scale_mat_0"]
        ds = cls(normals_np, albedos_np, masks_np, world_mats, scale_mats,
                 object_scale_mat=object_scale_mat, no_albedo=no_albedo,
                 device=device, upload_quantized=True)
        ds.normal_files = [normal_files[i] for i in sel]
        ds.global_view_indices = sel
        ds.n_images_global = len(mask_files)
        return ds

    # -- validation helpers ---------------------------------------------------

    def near_far_from_sphere(self, rays_o, rays_d):
        return cam.near_far_from_sphere(rays_o, rays_d)

    def image_at_ps(self, idv: int, idl: int, resolution_level: int = 1):
        """(warm-up, main) supervision image of a view and light, resized
        by 1/resolution_level, as host arrays."""
        img_warm, img_main = synth_images(self.arrays, idv)
        w, h = self.W // resolution_level, self.H // resolution_level
        return (io.resize_image(img_warm[idl].cpu().numpy(), w, h),
                io.resize_image(img_main[idl].cpu().numpy(), w, h))

    def normal_at(self, idv: int, resolution_level: int = 1):
        """World-space supervision normal map, resized, as a host array."""
        n = self.arrays.normals[idv].cpu().numpy().reshape(-1, 3)
        pose = self.pose_all_np[idv]
        n_world = (pose[:3, :3] @ n.T).T.reshape(self.H, self.W, 3)
        return io.resize_image(n_world, self.W // resolution_level,
                               self.H // resolution_level)

    def gen_rays_between(self, idx_0: int, idx_1: int, ratio: float,
                         resolution_level: int = 1):
        """Rays of a camera between views idx_0 and idx_1: the rotation by
        spherical interpolation (scipy ``Slerp``), the centre blended
        linearly, the intrinsics of view 0. The pose is computed on the
        host; -> (rays_o, rays_d [H/l, W/l, 3]) on the dataset's device."""
        from scipy.spatial.transform import Rotation, Slerp

        l = resolution_level
        tx = np.linspace(0, self.W - 1, self.W // l)
        ty = np.linspace(0, self.H - 1, self.H // l)
        px, py = np.meshgrid(tx, ty, indexing="xy")
        p = np.stack([px, py, np.ones_like(px)], axis=-1)
        Kinv = np.linalg.inv(self.intrinsics_all[0])[:3, :3]
        d_cam = p @ Kinv.T
        d_cam = d_cam / np.linalg.norm(d_cam, axis=-1, keepdims=True)

        pose_0 = np.linalg.inv(self.pose_all_np[idx_0])
        pose_1 = np.linalg.inv(self.pose_all_np[idx_1])
        rots = Rotation.from_matrix(np.stack([pose_0[:3, :3], pose_1[:3, :3]]))
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = Slerp([0, 1], rots)(ratio).as_matrix()
        pose[:3, 3] = ((1.0 - ratio) * pose_0 + ratio * pose_1)[:3, 3]
        pose = np.linalg.inv(pose)

        rays_d = d_cam @ pose[:3, :3].T
        rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape)

        def put(a):
            a = np.asarray(a, np.float32)
            trace.count("bytes_to_card", a.nbytes)
            return torch.tensor(a, device=self.device)

        return put(rays_o), put(rays_d)


# ---------------------------------------------------------------------------
# synthetic scenes (test fixtures / demos)
# ---------------------------------------------------------------------------

def _look_at_origin(C):
    """World-to-camera rotation (rows x, y, z) of a camera at C looking at
    the origin, z toward the origin."""
    z = -C / np.linalg.norm(C)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(z, up)) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    x = np.cross(z, up)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z])


def _world_mat(K, R_w2c, C):
    t = -R_w2c @ C
    world_mat = np.eye(4, dtype=np.float32)
    world_mat[:3, :4] = K @ np.concatenate([R_w2c, t[:, None]], axis=1)
    return world_mat


def _pixel_dirs_world(K, R_w2c, H, W):
    px, py = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    p = np.stack([px + 0.0, py + 0.0, np.ones_like(px, np.float64)], axis=-1)
    d_cam = p @ np.linalg.inv(K).T
    d_cam /= np.linalg.norm(d_cam, axis=-1, keepdims=True)
    return d_cam @ R_w2c          # rows are axes => cam->world is R^T


def torus_sdf(p: np.ndarray, R: float = 0.5, r: float = 0.22) -> np.ndarray:
    """Signed distance to a z-axis torus (exact point-to-surface distance)."""
    rho = np.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    return np.sqrt((rho - R) ** 2 + p[..., 2] ** 2) - r


def _torus_normal(p: np.ndarray, R: float = 0.5) -> np.ndarray:
    rho = np.maximum(np.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2), 1e-12)
    g = np.stack([p[..., 0] * (rho - R) / rho,
                  p[..., 1] * (rho - R) / rho,
                  p[..., 2]], axis=-1)
    return g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)


def make_torus_scene(n_views: int = 8, H: int = 128, W: int = 128,
                     R: float = 0.5, r: float = 0.22, cam_dist: float = 3.0,
                     albedo_rgb=(0.7, 0.55, 0.35),
                     center=(0.0, 0.0, 0.0), device="cuda") -> Dataset:
    """Analytic torus scene rendered by sphere tracing: a non-convex,
    genus-1 fixture. ``center`` moves the torus off the origin while the
    cameras still ring the origin."""
    center = np.asarray(center, np.float64)
    normals_np = np.zeros((n_views, H, W, 3), np.float32)
    albedos_np = np.zeros((n_views, H, W, 3), np.float32)
    masks_np = np.zeros((n_views, H, W), np.float32)
    world_mats, scale_mats = [], []
    focal = 1.2 * max(H, W)
    K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1.0]])

    for v in range(n_views):
        theta = 2 * np.pi * v / n_views
        # tilt the ring so some views look into the hole
        phi = 0.9 * np.sin(theta * 2 + 1.0)
        C = cam_dist * np.array([np.cos(theta) * np.cos(phi),
                                 np.sin(theta) * np.cos(phi),
                                 np.sin(phi)])
        R_w2c = _look_at_origin(C)
        world_mats.append(_world_mat(K, R_w2c, C))
        scale_mats.append(np.eye(4, dtype=np.float32))
        d_world = _pixel_dirs_world(K, R_w2c, H, W)

        # sphere-trace; start and far bound widen with |center|
        c_norm = np.linalg.norm(center)
        t_far = cam_dist + 1.2 + c_norm
        t_ray = np.full((H, W), cam_dist - 1.2 - c_norm)
        alive = np.ones((H, W), bool)
        for _ in range(160):
            p = C[None, None] + t_ray[..., None] * d_world
            d = torus_sdf(p - center, R, r)
            t_ray = np.where(alive, t_ray + d, t_ray)
            alive = alive & (d > 1e-5) & (t_ray < t_far)
        p = C[None, None] + t_ray[..., None] * d_world
        hit = (np.abs(torus_sdf(p - center, R, r)) < 1e-3) & (t_ray < t_far)

        n_cam = _torus_normal(p - center, R) @ R_w2c.T
        normals_np[v] = np.where(hit[..., None], n_cam, 0.0)
        masks_np[v] = hit.astype(np.float32)
        tex = 0.5 + 0.5 * np.sin(6 * np.pi * p[..., 0]) * np.cos(
            6 * np.pi * p[..., 2])
        albedos_np[v] = np.where(
            hit[..., None],
            np.asarray(albedo_rgb)[None, None] * (0.5 + 0.5 * tex[..., None]),
            0.0)

    return Dataset(normals_np, albedos_np, masks_np, world_mats, scale_mats,
                   device=device)


def make_sphere_scene(n_views: int = 8, H: int = 64, W: int = 64,
                      radius: float = 0.5, cam_dist: float = 3.0,
                      albedo_rgb=(0.8, 0.5, 0.3),
                      device="cuda") -> Dataset:
    """Analytic textured sphere with known normals, albedo and masks."""
    focal = 1.2 * max(H, W)
    K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1.0]])

    normals_np = np.zeros((n_views, H, W, 3), np.float32)
    albedos_np = np.zeros((n_views, H, W, 3), np.float32)
    masks_np = np.zeros((n_views, H, W), np.float32)
    world_mats, scale_mats = [], []

    for v in range(n_views):
        theta = 2 * np.pi * v / n_views
        phi = 0.3 * np.sin(theta * 2 + 1.0)
        C = cam_dist * np.array([np.cos(theta) * np.cos(phi),
                                 np.sin(theta) * np.cos(phi),
                                 np.sin(phi)])
        R_w2c = _look_at_origin(C)
        world_mats.append(_world_mat(K, R_w2c, C))
        scale_mats.append(np.eye(4, dtype=np.float32))

        d_world = _pixel_dirs_world(K, R_w2c, H, W)
        oc = C[None, None, :]
        b = 2 * (d_world * oc).sum(-1)
        c = (oc * oc).sum(-1) - radius ** 2
        disc = b ** 2 - 4 * c
        hit = disc > 0
        t_hit = (-b - np.sqrt(np.maximum(disc, 0))) / 2.0
        pts = oc + t_hit[..., None] * d_world
        n_world = pts / np.maximum(np.linalg.norm(pts, axis=-1, keepdims=True), 1e-12)
        normals_np[v] = np.where(hit[..., None], n_world @ R_w2c.T, 0.0)
        masks_np[v] = hit.astype(np.float32)
        tex = 0.5 + 0.5 * np.sin(4 * np.pi * pts[..., 0]) * np.cos(4 * np.pi * pts[..., 1])
        albedos_np[v] = np.where(
            hit[..., None],
            np.asarray(albedo_rgb)[None, None] * (0.5 + 0.5 * tex[..., None]),
            0.0)

    return Dataset(normals_np, albedos_np, masks_np, world_mats, scale_mats,
                   device=device)
