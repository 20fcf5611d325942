"""The disk loader's quantized upload against the JAX package on the CPU.

Both loaders read the maps to float32 on the host, encode them as uint16
(normals, albedo) and uint8 (masks), and decode them on the device; the
port's decoded maps must equal the JAX package's bit for bit, on a case
with 16-bit normals and 8-bit albedo, for every 16-bit code and through the
view-sharded loader. The constructor's default (float32 maps as given)
stays as it was.
"""

import os

import jax
import numpy as np
import pytest
import torch

from rnb_tpu import config as jconfig
from rnb_tpu.data import dataset as jds
from rnb_tpu_torch import config as tconfig
from rnb_tpu_torch.data import dataset as tds
from rnb_tpu_torch.parallel import data as tpdata
from rnb_tpu_torch.utils import io as tio

torch.set_num_threads(1)

MAPS = ("normals", "albedos", "masks")

CONF = """
dataset {{
    data_dir = {data_dir}
    normal_dir = normal
    albedo_dir = albedo
    mask_dir = mask
    render_cameras_name = cameras.npz
    object_cameras_name = cameras.npz
}}
"""


def _cameras(n_views):
    scene = tds.make_sphere_scene(n_views=n_views, H=8, W=8, device="cpu")
    return scene.world_mats_np, scene.scale_mats_np


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """4 views of 20x28 random unit normals (16-bit PNG), random albedo
    (8-bit PNG) and masks, with the sphere fixture's cameras."""
    out = str(tmp_path_factory.mktemp("upload") / "case")
    rng = np.random.default_rng(0)
    n_views, H, W = 4, 20, 28
    world_mats, scale_mats = _cameras(n_views)
    os.makedirs(out)
    np.savez(os.path.join(out, "cameras.npz"),
             **{f"world_mat_{i}": world_mats[i] for i in range(n_views)},
             **{f"scale_mat_{i}": scale_mats[i] for i in range(n_views)})
    for i in range(n_views):
        n = rng.standard_normal((H, W, 3))
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        tio.save_normal(os.path.join(out, "normal", f"{i:03d}.png"), n,
                        bit_depth=16)
        tio.save_image(os.path.join(out, "albedo", f"{i:03d}.png"),
                       rng.random((H, W, 3)), bit_depth=8)
        m = (rng.random((H, W)) > 0.3).astype(np.float64)
        tio.save_image(os.path.join(out, "mask", f"{i:03d}.png"),
                       np.stack([m] * 3, axis=-1))
    return out


def _assert_maps_equal(t_arrays, j_arrays):
    for k in MAPS:
        got, want = getattr(t_arrays, k).numpy(), np.asarray(getattr(j_arrays, k))
        assert got.dtype == want.dtype == np.float32, k
        assert np.array_equal(got, want), \
            f"{k}: {np.sum(got != want)} of {got.size} values differ"


def test_from_conf_maps_equal_jax(case):
    """The decoded maps of ``Dataset.from_conf``, bit for bit the JAX
    package's (the float32 maps the loaders read differ from them in about
    half the 16-bit codes, by up to 6e-8)."""
    text = CONF.format(data_dir=case)
    jd = jds.Dataset.from_conf(jconfig.parse_string(text)["dataset"])
    td = tds.Dataset.from_conf(tconfig.parse_string(text)["dataset"],
                               device="cpu")
    _assert_maps_equal(td.arrays, jd.arrays)
    assert not np.array_equal(td.arrays.normals.numpy(), np.stack(
        [tio.load_normal(f) for f in td.normal_files])), \
        "the case does not tell the decode from the float32 maps"


def test_view_sharded_loader_decodes_alike(case):
    """Rank 1 of 2 loads its views through ``from_conf``: the JAX loader's
    maps of the same views, bit for bit."""
    text = CONF.format(data_dir=case)
    td = tpdata.load_view_sharded_dataset(
        tconfig.parse_string(text)["dataset"], 1, 2, device="cpu")
    jd = jds.Dataset.from_conf(jconfig.parse_string(text)["dataset"],
                               view_subset=td.global_view_indices)
    assert td.global_view_indices == [2, 3]
    _assert_maps_equal(td.arrays, jd.arrays)


def test_every_code_decodes_as_jax():
    """All 65,536 16-bit codes of each normal channel and of the albedo,
    and both mask values, through both constructors' quantized upload."""
    codes = np.arange(65536, dtype=np.float64).reshape(1, 256, 256, 1)
    normals = np.repeat(codes / 65535.0 * 2.0 - 1.0, 3, axis=-1)
    albedos = np.repeat(codes / 65535.0, 3, axis=-1)
    masks = (codes[..., 0] % 2).astype(np.float32)
    world_mats, scale_mats = _cameras(1)
    args = (normals.astype(np.float32), albedos.astype(np.float32), masks,
            world_mats, scale_mats)
    jd = jds.Dataset(*args, upload_quantized=True)
    td = tds.Dataset(*args, device="cpu", upload_quantized=True)
    _assert_maps_equal(td.arrays, jd.arrays)
    n16, _, _ = tds.encode_maps(*args[:3])
    assert np.array_equal(n16[0, ..., 0].reshape(-1), np.arange(65536))


def test_default_upload_is_the_float_maps():
    """Without ``upload_quantized`` the maps go to the device as given."""
    rng = np.random.default_rng(1)
    normals = rng.uniform(-1, 1, (2, 6, 5, 3)).astype(np.float32)
    albedos = rng.random((2, 6, 5, 3)).astype(np.float32)
    masks = (rng.random((2, 6, 5)) > 0.5).astype(np.float32)
    td = tds.Dataset(normals, albedos, masks, *_cameras(2), device="cpu")
    for k, want in zip(MAPS, (normals, albedos, masks)):
        assert np.array_equal(getattr(td.arrays, k).numpy(), want), k
    jd = jds.Dataset(normals, albedos, masks, *_cameras(2))
    _assert_maps_equal(td.arrays, jax.device_get(jd.arrays))
