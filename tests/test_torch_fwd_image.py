"""The forwards of the tensor-core routes as they read their weights, on the
CPU: a plain forward that reads only the packed weight image
(``wg.pack_weights``) and the ``wg_layout`` offsets, in the order the bf16
kernels do (``albedo_fwd_wg_kernel``, ``nerf_fwd_wg_kernel`` in
``rnb_tpu_torch/csrc``), held against the plain version of the op and
against the JAX package's Pallas kernel in interpret mode. And the op packs
that image once a forward-plus-backward, for both kernels.

The layout read here: every layer a [pad16(in), pad16(out)] tile of 8x8
cores; the albedo net's 310 -> 320 input and its 3-wide head as one N = 8
product; the NeRF's skip input held as [h, e] (W_5's rows alike), the fused
[W_f | W_a] tile with the alpha column at ``of`` (256 at the shipped conf),
the views input [rnd(feat), PE(views)] padded 283 -> 288 and the rgb tile
128 x 16.

Tolerances: at f32 the image holds the weights unrounded (``dtype``
float32), so image forward and plain version differ only by summation
order: rtol 2e-5, atol 2e-6 (the albedo's sigmoid output) and 2e-5 (the
NeRF's raw heads), as tests/test_torch_albedo.py and test_torch_nerf.py
hold the plain versions to the Pallas kernels. At bf16 both round the same
activations; a summation-order difference can flip the bf16 rounding of an
activation (one ulp, 2^-8 relative), so they are held to 1e-3 of the
output's norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnb_tpu.models import fields as jfields
from rnb_tpu.ops import pallas_albedo as jalb
from rnb_tpu.ops import pallas_nerf as jnerf
from rnb_tpu_torch.models import fields
from rnb_tpu_torch.models.fields import round_to
from rnb_tpu_torch.ops import albedo, nerf, wg
from rnb_tpu_torch.utils import bridge

torch.set_num_threads(1)

DTYPES = (torch.float32, torch.bfloat16)


def _tile(image, lay, l):
    """Layer l's padded [kp, np] tile, read from the image at w_off[l]."""
    kp, np_, off = lay["kp"][l], lay["np"][l], lay["w_off"][l]
    t = image[off:off + kp * np_].reshape(kp // 8, np_ // 8, 8, 8)
    return t.permute(0, 2, 1, 3).reshape(kp, np_).float()


def _pad(x, width):
    return torch.nn.functional.pad(x, (0, width - x.shape[1]))


def _bias(bflat, lay, l):
    off = sum(lay["out_dims"][:l])
    return bflat[off:off + lay["out_dims"][l]]


def albedo_fwd_from_image(cfg, pts, nrm, feat, image, bflat, lay, dtype):
    """The albedo forward from the image: x0 padded to kp[0]; each hidden
    layer a product over the padded tile, bias and ReLU in f32, rounded to
    the op dtype; the head's N = 8 product, sigmoid of its first d_out
    columns."""
    x = round_to(_pad(torch.cat([albedo._pe(cfg.multires_view, pts),
                                 albedo._pe(cfg.multires_view, nrm), feat], -1),
                      lay["kp"][0]), dtype)
    L = len(lay["in_dims"])
    for l in range(L):
        out = lay["out_dims"][l]
        z = x @ _tile(image, lay, l)
        z = z + _pad(_bias(bflat, lay, l)[None], lay["np"][l])
        if l < L - 1:
            x = round_to(torch.relu(z), dtype)
    return albedo._sigmoid(z[:, :8][:, :out])


def nerf_fwd_from_image(cfg, pts, views, image, bflat, lay, dtype):
    """The NeRF forward from the image layers: the trunk with a skip input
    as [h, e]; the fused head's product, feature block [:of] and alpha at
    column of; the views input [rnd(feat), PE(views)] padded; the rgb
    head's N = 8 product."""
    D, of = cfg.D, lay["of"]
    e = round_to(albedo._pe(cfg.multires, pts), dtype)
    v = round_to(albedo._pe(cfg.multires_view, views), dtype)
    x = _pad(e, lay["kp"][0])
    for l in range(D):
        z = x @ _tile(image, lay, l) + _pad(_bias(bflat, lay, l)[None],
                                            lay["np"][l])
        h = round_to(torch.relu(z), dtype)[:, :lay["out_dims"][l]]
        x = _pad(torch.cat([h, e], -1) if lay["skip"][l + 1] else h,
                 lay["kp"][l + 1])
    z = x @ _tile(image, lay, D)
    b = _bias(bflat, lay, D)
    alpha = z[:, of:of + 8][:, :lay["out_dims"][D] - of] + b[of:]
    feat = round_to(z[:, :of] + b[:of], dtype)
    x = _pad(torch.cat([feat, v], -1), lay["kp"][D + 1])
    z = x @ _tile(image, lay, D + 1) + _pad(_bias(bflat, lay, D + 1)[None],
                                            lay["np"][D + 1])
    x = round_to(torch.relu(z), dtype)[:, :lay["kp"][D + 2]]
    rgb = (x @ _tile(image, lay, D + 2))[:, :8][:, :lay["out_dims"][D + 2]]
    return alpha, rgb + _bias(bflat, lay, D + 2)


def _albedo_image(ws, bs, dtype):
    lay = albedo.wg_layout(ws)
    image = wg.pack_weights(ws, lay, dtype)
    return image, torch.cat([b.reshape(-1) for b in bs]), lay


def _nerf_image(cfg, ws, bs, dtype):
    lay = nerf.wg_layout(cfg, ws)
    iw, ib = nerf.wg_weights(cfg, ws, bs)
    return wg.pack_weights(iw, lay, dtype), torch.cat([b.reshape(-1) for b in ib]), lay


def _close(got, want, dtype):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)
        else:
            assert (g - w).norm() <= 1e-3 * w.norm(), ((g - w).norm(), w.norm())


# --- the albedo net ---------------------------------------------------------

ALB_SMALL = dict(d_feature=32, d_hidden=32, n_layers=2, multires_view=4)


def _albedo_inputs(cfg, n, seed):
    rng = np.random.default_rng(seed)
    pts = torch.tensor(rng.uniform(-0.8, 0.8, (n, 3)), dtype=torch.float32)
    nrm = torch.nn.functional.normalize(
        torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32), dim=-1)
    feat = torch.tensor(0.3 * rng.normal(size=(n, cfg.d_feature)),
                        dtype=torch.float32)
    return pts, nrm, feat


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kw", [{}, ALB_SMALL], ids=["shipped", "small"])
def test_albedo_image_forward_matches_plain(kw, dtype):
    cfg = fields.RenderingConfig(**kw)
    params = fields.init_rendering_network(torch.Generator().manual_seed(3), cfg,
                                           device="cpu")
    ws = [fields.fold_weight_norm(l).detach() for l in params]
    bs = [l["b"].detach() for l in params]
    pts, nrm, feat = _albedo_inputs(cfg, 37, seed=4)
    got = albedo_fwd_from_image(cfg, pts, nrm, feat, *_albedo_image(ws, bs, dtype),
                                dtype)
    _close([got], [albedo.albedo_fwd_plain(cfg, pts, nrm, feat, ws, bs, dtype)],
           dtype)


def test_albedo_image_forward_matches_pallas():
    """At f32, a small net and a count ragged against the 64-point tile and
    the Pallas blocks (203 points)."""
    jcfg = jfields.RenderingConfig(**ALB_SMALL)
    cfg = fields.RenderingConfig(**ALB_SMALL)
    params = jfields.init_rendering_network(jax.random.PRNGKey(5), jcfg)
    pts, nrm, feat = _albedo_inputs(cfg, 203, seed=6)
    want = jalb.albedo_apply_fused(jcfg, params, pts.numpy(), nrm.numpy(),
                                   feat.numpy(), interpret=True, dtype=jnp.float32)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                  device="cpu")
    ws = [fields.fold_weight_norm(l).detach() for l in tp]
    bs = [l["b"].detach() for l in tp]
    got = albedo_fwd_from_image(cfg, pts, nrm, feat,
                                *_albedo_image(ws, bs, torch.float32), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)


# --- the background NeRF ----------------------------------------------------

NERF_SMALL = dict(D=8, W=64, skips=(4,))


def _nerf_inputs(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    pts = np.concatenate([x / np.linalg.norm(x, axis=-1, keepdims=True),
                          rng.uniform(0.1, 1.0, (n, 1))], axis=-1)
    v = rng.normal(size=(n, 3))
    views = v / np.linalg.norm(v, axis=-1, keepdims=True)
    return (torch.tensor(pts, dtype=torch.float32),
            torch.tensor(views, dtype=torch.float32))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kw", [{}, NERF_SMALL], ids=["shipped", "small"])
def test_nerf_image_forward_matches_plain(kw, dtype):
    cfg = fields.NeRFConfig(**kw)
    ws, bs = nerf.flatten_params(fields.init_nerf(
        torch.Generator().manual_seed(7), cfg, device="cpu"))
    ws, bs = [w.detach() for w in ws], [b.detach() for b in bs]
    pts, views = _nerf_inputs(37, seed=8)
    image, bflat, lay = _nerf_image(cfg, ws, bs, dtype)
    if not kw:   # the shipped layout: alpha at column 256, views 283 -> 288
        assert lay["of"] == 256 and lay["np"][cfg.D] == 272
        assert lay["kp"][cfg.D + 1] == 288 and lay["kp"][5] == 352
    got = nerf_fwd_from_image(cfg, pts, views, image, bflat, lay, dtype)
    want = nerf.nerf_fwd_plain(cfg, pts, views, ws, bs, dtype)
    if dtype == torch.float32:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)
    else:
        _close(got, want, dtype)


def test_nerf_image_forward_matches_pallas():
    """At f32, the NeRF of tests/test_torch_nerf.py (8 x 64, skip at 4) and
    203 points, ragged against the 64-point tile and the Pallas blocks."""
    jcfg, cfg = jfields.NeRFConfig(**NERF_SMALL), fields.NeRFConfig(**NERF_SMALL)
    params = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jax.device_get(jfields.init_nerf(jax.random.PRNGKey(9), jcfg)))
    pts, views = _nerf_inputs(203, seed=10)
    want = jnerf.nerf_apply_fused(jcfg, params, pts.numpy(), views.numpy(),
                                  interpret=True, dtype=jnp.float32)
    ws, bs = nerf.flatten_params(bridge.params_from_numpy(params, device="cpu"))
    ws, bs = [w.detach() for w in ws], [b.detach() for b in bs]
    got = nerf_fwd_from_image(cfg, pts, views,
                              *_nerf_image(cfg, ws, bs, torch.float32), torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)


# --- one image a forward-plus-backward --------------------------------------

def _spy(monkeypatch, module, name, seen):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        seen.append(args[-1])   # the packed weights, passed last
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)


def _count_packs(monkeypatch):
    made = []
    real = wg.pack_weights

    def counted(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]
    monkeypatch.setattr(wg, "pack_weights", counted)
    return made


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_albedo_packs_once_for_both_kernels(monkeypatch, dtype):
    """One _Albedo forward-plus-backward packs the weight image once at bf16
    (none at f32, whose kernels take flat weights), and the backward gets
    the forward's image."""
    cfg = fields.RenderingConfig(**ALB_SMALL)
    params = fields.init_rendering_network(torch.Generator().manual_seed(11), cfg,
                                           device="cpu")
    for p in bridge.tree_leaves(params):
        p.requires_grad_(True)
    pts, nrm, feat = _albedo_inputs(cfg, 40, seed=12)
    made, fwd, bwd = _count_packs(monkeypatch), [], []
    _spy(monkeypatch, albedo, "albedo_fwd", fwd)
    _spy(monkeypatch, albedo, "albedo_bwd", bwd)
    albedo.albedo_apply_fused(cfg, params, pts, nrm, feat, dtype).sum().backward()
    assert len(fwd) == len(bwd) == 1
    if dtype == torch.float32:
        assert made == [] and fwd[0] is None and bwd[0] is None
    else:
        assert len(made) == 1
        assert bwd[0] is fwd[0] and fwd[0][0] is made[0]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_nerf_packs_once_for_both_kernels(monkeypatch, dtype):
    cfg = fields.NeRFConfig(**NERF_SMALL)
    params = fields.init_nerf(torch.Generator().manual_seed(13), cfg, device="cpu")
    for p in bridge.tree_leaves(params):
        p.requires_grad_(True)
    pts, views = _nerf_inputs(40, seed=14)
    made, fwd, bwd = _count_packs(monkeypatch), [], []
    _spy(monkeypatch, nerf, "nerf_fwd", fwd)
    _spy(monkeypatch, nerf, "nerf_bwd", bwd)
    alpha, rgb = nerf.nerf_apply_fused(cfg, params, pts, views, dtype)
    (alpha.sum() + rgb.sum()).backward()
    assert len(fwd) == len(bwd) == 1
    if dtype == torch.float32:
        assert made == [] and fwd[0] is None and bwd[0] is None
    else:
        assert len(made) == 1
        assert bwd[0] is fwd[0] and fwd[0][0] is made[0]
