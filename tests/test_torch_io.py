"""The port's disk formats against the JAX package's, on the CPU: PNG maps
(8- and 16-bit, every row filter), bilinear resize, PLY meshes, npz
checkpoints both ways, the IDR-layout loader (``Dataset.from_conf``) with
its validation helpers, and the synthetic-case writer.

The JAX side reads and writes PNGs through OpenCV; the port through its
own zlib codec. Tolerances: PNG pixels and checkpoints exact; resize 1e-5;
maps, cameras and the validation helpers 1e-6 / 1e-5 (the JAX loader
re-quantizes the maps to uint16 and decodes them on the device, the port
loads float32 directly: about one ulp apart)."""

import os
import struct
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnb_tpu import config as jconfig
from rnb_tpu.data import dataset as jds
from rnb_tpu.models import fields as jfields
from rnb_tpu.train import step as jstep
from rnb_tpu.utils import checkpoint as jckpt
from rnb_tpu.utils import io as jio
from rnb_tpu_torch import config as tconfig
from rnb_tpu_torch.data import dataset as tds
from rnb_tpu_torch.models import fields as tfields
from rnb_tpu_torch.tools import make_synthetic_case as tcase
from rnb_tpu_torch.train import step as tstep
from rnb_tpu_torch.utils import bridge
from rnb_tpu_torch.utils import checkpoint as tckpt
from rnb_tpu_torch.utils import io as tio
from test_runner import CONF_TMPL

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import make_synthetic_case as jcase  # noqa: E402

torch.set_num_threads(1)


def _conf_text(tmp_path, data_dir, n_outside=0):
    return CONF_TMPL.format(exp_dir=str(tmp_path / "exp"), data_dir=data_dir,
                            end_iter=12, warm_up_iter=8, save_freq=6,
                            val_freq=10, val_mesh_freq=10, mask_weight=0.1,
                            n_outside=n_outside)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _img(rng, h=19, w=23):
    return rng.random((h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("kind,bit_depth", [("image", 8), ("image", 16),
                                            ("normal", 8), ("normal", 16),
                                            ("mask", 8)])
def test_png_written_by_jax_loads_in_port(tmp_path, kind, bit_depth):
    rng = np.random.default_rng(bit_depth)
    path = str(tmp_path / "a.png")
    if kind == "image":
        jio.save_image(path, _img(rng), bit_depth=bit_depth)
        got, want = tio.load_image(path), jio.load_image(path)
    elif kind == "normal":
        n = rng.normal(size=(19, 23, 3))
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        jio.save_normal(path, n, bit_depth=bit_depth)
        got, want = tio.load_normal(path), jio.load_normal(path)
    else:
        m = (rng.random((19, 23)) > 0.5).astype(np.float32)
        jio.save_image(path, np.stack([m] * 3, axis=-1))
        got, want = tio.load_mask(path), jio.load_mask(path)
        np.testing.assert_array_equal(got, m)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bit_depth", [8, 16])
@pytest.mark.parametrize("kind", ["image", "normal", "mask"])
def test_png_written_by_port_loads_in_jax(tmp_path, kind, bit_depth):
    rng = np.random.default_rng(10 + bit_depth)
    path = str(tmp_path / "a.png")
    if kind == "image":
        tio.save_image(path, _img(rng), bit_depth=bit_depth)
        got, want = jio.load_image(path), tio.load_image(path)
    elif kind == "normal":
        n = rng.normal(size=(19, 23, 3))
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        tio.save_normal(path, n, bit_depth=bit_depth)
        got, want = jio.load_normal(path), tio.load_normal(path)
    else:
        m = (rng.random((19, 23)) > 0.5).astype(np.float32)
        tio.save_image(path, np.stack([m] * 3, axis=-1), bit_depth=bit_depth)
        got, want = jio.load_mask(path), tio.load_mask(path)
    np.testing.assert_array_equal(got, want)


def _filtered_png(path, arr, ftype):
    """Encode ``arr`` (uint8/uint16, [H,W] or [H,W,C]) with row filter
    ``ftype`` on every row (the PNG specification's filter definitions)."""
    depth = 16 if arr.dtype == np.uint16 else 8
    a3 = arr[..., None] if arr.ndim == 2 else arr
    h, w, c = a3.shape
    bpp = c * depth // 8
    rows = np.ascontiguousarray(a3.astype(">u2" if depth == 16 else np.uint8))
    rows = rows.reshape(h, -1).view(np.uint8).astype(np.int64)
    out = bytearray()
    prior = np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        x = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ftype == 0:
            f = x
        elif ftype == 1:
            f = x - left
        elif ftype == 2:
            f = x - prior
        elif ftype == 3:
            f = x - (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
            f = x - pred
        out += bytes([ftype]) + bytes((f % 256).astype(np.uint8))
        prior = x
    ctype = {1: 0, 3: 2, 4: 6}[c]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(out)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_row_filters(tmp_path, ftype, dtype):
    """Every row filter at both depths and every colour type decodes to
    the pixels OpenCV reads (in RGB order), and load_image agrees with the
    JAX loader on the file."""
    import cv2

    rng = np.random.default_rng(ftype)
    top = np.iinfo(dtype).max
    for c in (1, 3, 4):
        arr = (rng.random((7, 11, c)) * top).astype(dtype)
        # smooth ramps make the predictors matter, noise makes them wrap
        arr[:3] = np.linspace(0, top, 11).astype(dtype)[None, :, None]
        arr = arr[..., 0] if c == 1 else arr
        path = str(tmp_path / f"f{c}.png")
        _filtered_png(path, arr, ftype)
        got = tio.read_png(path)
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if want.ndim == 3:
            want = want[..., [2, 1, 0, 3][:want.shape[2]]]
        np.testing.assert_array_equal(got, want)
        if c == 1:
            np.testing.assert_array_equal(got, arr)
        np.testing.assert_array_equal(tio.load_image(path), jio.load_image(path))


@pytest.mark.parametrize("shape,wh", [((64, 64, 3), (16, 16)),
                                      ((64, 48, 3), (32, 24)),
                                      ((6, 6, 3), (37, 29)),
                                      ((33, 17), (8, 5)),
                                      ((7, 9, 3), (20, 3))])
def test_resize_matches_jax(shape, wh):
    img = np.random.default_rng(0).random(shape).astype(np.float32)
    got = tio.resize_image(img, *wh)
    want = jio.resize_image(img, *wh)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("colors", [False, True])
def test_ply_both_ways(tmp_path, colors):
    rng = np.random.default_rng(3)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    f = rng.integers(0, 50, size=(70, 3)).astype(np.int32)
    c = rng.random((50, 3)) if colors else None
    for write, read in ((jio.write_ply, tio.read_ply), (tio.write_ply, jio.read_ply)):
        path = str(tmp_path / "m.ply")
        write(path, v, f, vertex_colors=c)
        v2, f2, c2 = read(path)
        np.testing.assert_array_equal(v2, v)
        np.testing.assert_array_equal(f2, f)
        if colors:
            np.testing.assert_array_equal(
                c2, np.clip(c * 255.0, 0, 255).astype(np.uint8))
        else:
            assert c2 is None


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _statics_and_tcfg(tmp_path):
    text = _conf_text(tmp_path, str(tmp_path))
    jconf, tconf = jconfig.parse_string(text), tconfig.parse_string(text)
    return (jfields.statics_from_conf(jconf["model"]), jstep.train_conf(jconf),
            tfields.statics_from_conf(tconf["model"]))


def _random_jax_state(jstatics, jtcfg, seed):
    """A JAX TrainState whose every leaf (params, moments, counts, step)
    is drawn at random."""
    state = jstep.init_train_state(
        jfields.init_model_bundle(jax.random.PRNGKey(seed), jstatics), jtcfg)
    leaves, treedef = jax.tree_util.tree_flatten(state)
    rng = np.random.default_rng(seed)
    new = [rng.integers(1, 1000, size=np.shape(l)).astype(np.asarray(l).dtype)
           if np.issubdtype(np.asarray(l).dtype, np.integer)
           else rng.normal(size=np.shape(l)).astype(np.asarray(l).dtype)
           for l in leaves]
    new[-1] = new[-2].copy()    # schedule count == step, as training keeps them
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in new])


def _port_state(tstatics):
    return tstep.init_train_state(tfields.init_model_bundle(
        torch.Generator().manual_seed(0), tstatics, "cpu"))


def _assert_state_equals_leaves(tstate, leaves):
    p = len(bridge.tree_leaves(tstate.params))
    assert len(leaves) == 3 * p + 3
    for t, want in zip(bridge.tree_leaves(tstate.params), leaves[:p]):
        np.testing.assert_array_equal(t.detach().numpy(), want)
    mu, nu, count = bridge.adam_state_to_numpy(tstate.optimizer, tstate.params)
    assert count == int(leaves[p])
    for got, want in zip(bridge.tree_leaves(mu), leaves[p + 1:2 * p + 1]):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(bridge.tree_leaves(nu), leaves[2 * p + 1:3 * p + 1]):
        np.testing.assert_array_equal(got, want)
    assert tstate.step == int(leaves[-1])


def test_jax_checkpoint_loads_in_port(tmp_path):
    jstatics, jtcfg, tstatics = _statics_and_tcfg(tmp_path)
    jstate = _random_jax_state(jstatics, jtcfg, 1)
    path = str(tmp_path / "ckpt_000005.npz")
    jckpt.save_checkpoint(path, jstate)
    tstate = tckpt.load_checkpoint(path, _port_state(tstatics))
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(jstate)]
    _assert_state_equals_leaves(tstate, leaves)
    # and written back, the file holds the same leaves, dtypes included
    path2 = str(tmp_path / "again.npz")
    tckpt.save_checkpoint(path2, tstate)
    with np.load(path) as a, np.load(path2) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_checkpoint_loads_in_jax(tmp_path):
    jstatics, jtcfg, tstatics = _statics_and_tcfg(tmp_path)
    jtemplate = _random_jax_state(jstatics, jtcfg, 2)
    src = _random_jax_state(jstatics, jtcfg, 3)
    # a port state holding src's values, written by the port
    tmp = str(tmp_path / "src.npz")
    jckpt.save_checkpoint(tmp, src)
    tstate = tckpt.load_checkpoint(tmp, _port_state(tstatics))
    path = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(path, tstate)
    loaded = jckpt.load_checkpoint(path, jtemplate)
    assert (jax.tree_util.tree_structure(loaded)
            == jax.tree_util.tree_structure(jtemplate))
    _assert_state_equals_leaves(
        tstate, [np.asarray(l) for l in jax.tree_util.tree_leaves(loaded)])
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(src)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_mismatch_raises(tmp_path):
    _, _, tstatics = _statics_and_tcfg(tmp_path)
    tstate = _port_state(tstatics)
    leaves = tckpt.state_leaves(tstate)
    path = str(tmp_path / "short.npz")
    tckpt.save_checkpoint(path, leaves[:-1])
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load_checkpoint(path, tstate)
    bad = list(leaves)
    bad[0] = np.zeros(bad[0].shape[:-1] + (bad[0].shape[-1] + 1,), np.float32)
    tckpt.save_checkpoint(path, bad)
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_checkpoint(path, tstate)


def test_latest_checkpoint(tmp_path):
    for s in (3, 12, 7):
        tckpt.save_checkpoint(tckpt.checkpoint_path(str(tmp_path), s), [np.zeros(1)])
    tckpt.save_checkpoint(tckpt.checkpoint_path(str(tmp_path), 99, "nan_dump_"),
                          [np.zeros(1)])
    assert tckpt.latest_checkpoint(str(tmp_path)).endswith("ckpt_000012.npz")
    assert tckpt.latest_checkpoint(str(tmp_path), 10).endswith("ckpt_000007.npz")
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


# ---------------------------------------------------------------------------
# the IDR-layout loader and its helpers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("io_case")
    case = str(tmp / "sphere")
    jcase.write_case(case, n_views=3, H=24, W=32, radius=0.4)
    text = _conf_text(tmp, case)
    jd = jds.Dataset.from_conf(jconfig.parse_string(text)["dataset"])
    td = tds.Dataset.from_conf(tconfig.parse_string(text)["dataset"], device="cpu")
    return jd, td


@pytest.fixture(scope="module")
def same_maps(loaded):
    """The port's Dataset on the JAX loader's own maps. The two loaders'
    background normals (-1.5e-5 after the 16-bit round trip) differ by one
    ulp of 1, and the per-pixel light frame of so short a normal is
    ill-conditioned; the helpers are compared on identical maps."""
    jd, _ = loaded
    with np.load(os.path.join(os.path.dirname(jd.normal_files[0]), "..",
                              "cameras.npz")) as c:
        obj = c["scale_mat_0"]
    td = tds.Dataset(np.array(jd.arrays.normals), np.array(jd.arrays.albedos),
                     np.array(jd.arrays.masks), jd.world_mats_np,
                     jd.scale_mats_np, object_scale_mat=obj, device="cpu")
    return jd, td


def test_from_conf_agrees(loaded):
    jd, td = loaded
    ja, ta = jd.arrays, td.arrays
    assert (td.n_images, td.H, td.W, td.no_albedo) == (jd.n_images, jd.H, jd.W, False)
    np.testing.assert_allclose(ta.normals.numpy(), np.asarray(ja.normals), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ta.albedos.numpy(), np.asarray(ja.albedos), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ta.masks.numpy(), np.asarray(ja.masks))
    for k in ("intrinsics_inv", "pose_all", "lights_warmup_world"):
        np.testing.assert_allclose(getattr(ta, k).numpy(), np.asarray(getattr(ja, k)),
                                   rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(td.intrinsics_all, jd.intrinsics_all, rtol=1e-6)
    np.testing.assert_array_equal(td.object_bbox_min, jd.object_bbox_min)
    np.testing.assert_array_equal(td.object_bbox_max, jd.object_bbox_max)
    np.testing.assert_array_equal(np.stack(td.scale_mats_np), np.stack(jd.scale_mats_np))


@pytest.mark.parametrize("level", [1, 4])
def test_validation_helpers_agree(same_maps, level):
    jd, td = same_maps
    tol = dict(rtol=0, atol=1e-5)
    for idv in range(td.n_images):
        got = tds.gen_rays_at(td.arrays, idv, level)
        want = jds.gen_rays_at(jd.arrays, idv, level)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
        gw, gm = tds.synth_images(td.arrays, idv)
        ww, wm = jds.synth_images(jd.arrays, idv)
        np.testing.assert_allclose(gw.numpy(), np.asarray(ww), **tol)
        np.testing.assert_allclose(gm.numpy(), np.asarray(wm), **tol)
        rng = np.random.default_rng(idv)
        px, py = rng.integers(0, td.W, 40), rng.integers(0, td.H, 40)
        for idl in range(td.n_lights):
            np.testing.assert_allclose(
                tds.lights_at_pixels(td.arrays, idv, idl, torch.tensor(px),
                                     torch.tensor(py)).numpy(),
                np.asarray(jds.lights_at_pixels(jd.arrays, idv, idl,
                                                jnp.asarray(px), jnp.asarray(py))),
                **tol)
            for g, w in zip(td.image_at_ps(idv, idl, level),
                            jd.image_at_ps(idv, idl, level)):
                np.testing.assert_allclose(g, w, **tol)
        np.testing.assert_allclose(td.normal_at(idv, level), jd.normal_at(idv, level),
                                   **tol)
        o = torch.tensor(rng.normal(size=(9, 3)), dtype=torch.float32)
        d = torch.tensor(rng.normal(size=(9, 3)), dtype=torch.float32)
        for g, w in zip(td.near_far_from_sphere(o, d),
                        jd.near_far_from_sphere(jnp.asarray(o.numpy()),
                                                jnp.asarray(d.numpy()))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


# ---------------------------------------------------------------------------
# the synthetic-case writer
# ---------------------------------------------------------------------------

def _read_case(path):
    maps = {}
    for sub, load in (("normal", tio.read_png), ("albedo", tio.read_png),
                      ("mask", tio.read_png)):
        files = sorted(os.listdir(os.path.join(path, sub)))
        maps[sub] = np.stack([load(os.path.join(path, sub, f)) for f in files])
    with np.load(os.path.join(path, "cameras.npz")) as c:
        maps.update({k: c[k] for k in c.files})
    return maps


def test_write_case_clean_sphere_equals_jax(tmp_path):
    jcase.write_case(str(tmp_path / "j"), n_views=3, H=20, W=28, radius=0.35)
    tcase.write_case(str(tmp_path / "t"), n_views=3, H=20, W=28, radius=0.35)
    got, want = _read_case(str(tmp_path / "t")), _read_case(str(tmp_path / "j"))
    assert sorted(got) == sorted(want)
    assert got["normal"].dtype == np.uint16 and got["mask"].dtype == np.uint8
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_write_case_degraded_torus_within_one_level(tmp_path):
    kw = dict(n_views=2, H=24, W=24, shape="torus", degrade=True, seed=0)
    jcase.write_case(str(tmp_path / "j"), **kw)
    tcase.write_case(str(tmp_path / "t"), **kw)
    got, want = _read_case(str(tmp_path / "t")), _read_case(str(tmp_path / "j"))
    assert got["normal"].dtype == np.uint8
    for k in want:
        diff = np.abs(got[k].astype(np.int64) - want[k].astype(np.int64))
        if k.endswith(tuple("0123456789")):       # cameras
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert diff.max() <= 1, (k, diff.max())
