"""The albedo net's and the background NeRF's bf16 forwards
(``albedo_fwd_wg_kernel``, ``nerf_fwd_wg_kernel`` in ``rnb_tpu_torch/csrc``)
as their rings feed them, on the CPU: a forward whose every weight comes
from the stages of the forward phase table (``fwd_steps``), each box
emulated in numpy as TMA loads it from the packed image and taken in ring
order, with the kernels' epilogues (bias past a layer's width zero, ReLU
and rounding of every layer's output; the NeRF's feature block and alpha
column from the fused head's one product, PE(views) after rnd(feat); the
heads from an N = 8 product), held against the plain version of the op at
both op dtypes, and against the JAX package's Pallas kernel in interpret
mode at f32 with weights carried across by ``utils/bridge``.

Tolerances, as ``test_torch_fwd_image.py`` states them: at f32 (the image
unrounded) summation order only, rtol 2e-5 with atol 2e-6 (the albedo's
sigmoid output) and 2e-5 (the NeRF's raw heads); at bf16, 1e-3 of the
output's norm (a summation-order difference can flip the bf16 rounding of
an activation, one ulp).
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
from test_torch_fwd_image import (ALB_SMALL, DTYPES, NERF_SMALL, _albedo_image,
                                  _albedo_inputs, _bias, _close, _nerf_image,
                                  _nerf_inputs, _pad)
from test_torch_wg_bwd_sched import _box

torch.set_num_threads(1)


def _stage_products(mod, image, lay):
    """The B operand of every phase of ``mod``'s forward table, assembled
    from its ring stages in ring order: each stage a box {64, nb, 2} of the
    layer's tile (2 x nb cores, MN-major) read as TMA reads it, its 16 K
    rows stacked. -> [[K, 8nb] float32 tensor a phase]."""
    image = image.float().numpy()
    steps = iter(mod.fwd_steps(lay))
    out = []
    for (kind, l, box, _), nk in zip(mod.fwd_phases(lay),
                                     wg.phase_nks(lay, mod.fwd_phases(lay))):
        kp, np_ = lay["kp"][l], lay["np"][l]
        tile = image[lay["w_off"][l]:lay["w_off"][l] + kp * np_]
        rows = []
        for t in range(nk):
            skind, sl, sbox, coords = next(steps)
            assert (skind, sl, sbox, coords) == (kind, l, box, (0, 0, 2 * t))
            nb = box[1]
            got = _box(tile, (64, np_ // 8, kp // 8), box, coords)
            rows.append(got.reshape(2, nb, 8, 8).transpose(0, 2, 1, 3)
                        .reshape(16, 8 * nb))
        out.append(torch.tensor(np.concatenate(rows), dtype=torch.float32))
    assert next(steps, None) is None
    return out


def _epilogue(z, bflat, lay, l, dtype, relu=True):
    """A layer's epilogue over the product's columns: its bias (zero past
    its width), ReLU, rounded to the op dtype."""
    z = z + _pad(_bias(bflat, lay, l)[None], z.shape[1])
    return round_to(torch.relu(z) if relu else z, dtype)


def albedo_fwd_from_stages(cfg, pts, nrm, feat, image, bflat, lay, dtype):
    """The albedo forward from the ring's stages: x0 padded to kp[0], the
    hidden layers' N = 256 products, the head's N = 8 product."""
    B = _stage_products(albedo, image, lay)
    x = round_to(_pad(torch.cat([albedo._pe(cfg.multires_view, pts),
                                 albedo._pe(cfg.multires_view, nrm), feat], -1),
                      lay["kp"][0]), dtype)
    L = len(lay["in_dims"])
    for l in range(L - 1):
        x = _epilogue(x @ B[l], bflat, lay, l, dtype)[:, :lay["kp"][l + 1]]
    z = (x @ B[L - 1])[:, :8][:, :lay["out_dims"][-1]]
    return albedo._sigmoid(z + _bias(bflat, lay, L - 1))


def nerf_fwd_from_stages(cfg, pts, views, image, bflat, lay, dtype):
    """The NeRF forward from the ring's stages: the trunk's N = 256
    products (a skip input as [h, e]), the fused head's one product over
    all its output cores (the feature block [:of], the alpha column at
    of), the views layer's N = 128 product on [rnd(feat), PE(views)], the
    rgb head's N = 8 product."""
    B = _stage_products(nerf, image, lay)
    D, of = len(lay["in_dims"]) - 3, lay["of"]
    e = round_to(albedo._pe(cfg.multires, pts), dtype)
    v = round_to(albedo._pe(cfg.multires_view, views), dtype)
    x = _pad(e, lay["kp"][0])
    for l in range(D):
        h = _epilogue(x @ B[l], bflat, lay, l, dtype)[:, :lay["out_dims"][l]]
        x = _pad(torch.cat([h, e], -1) if lay["skip"][l + 1] else h,
                 lay["kp"][l + 1])
    z = x @ B[D]
    b = _bias(bflat, lay, D)
    alpha = z[:, of:of + 8][:, :lay["out_dims"][D] - of] + b[of:]
    feat = round_to(z[:, :of] + b[:of], dtype)
    x = _pad(torch.cat([feat, v], -1), lay["kp"][D + 1])
    x = _epilogue(x @ B[D + 1], bflat, lay, D + 1, dtype)[:, :lay["kp"][D + 2]]
    rgb = (x @ B[D + 2])[:, :8][:, :lay["out_dims"][D + 2]]
    return alpha, rgb + _bias(bflat, lay, D + 2)


def _albedo_net(kw, seed):
    cfg = fields.RenderingConfig(**kw)
    params = fields.init_rendering_network(torch.Generator().manual_seed(seed),
                                           cfg, device="cpu")
    return (cfg, [fields.fold_weight_norm(l).detach() for l in params],
            [l["b"].detach() for l in params])


def _nerf_net(kw, seed):
    cfg = fields.NeRFConfig(**kw)
    ws, bs = nerf.flatten_params(fields.init_nerf(
        torch.Generator().manual_seed(seed), cfg, device="cpu"))
    return cfg, [w.detach() for w in ws], [b.detach() for b in bs]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kw", [{}, ALB_SMALL], ids=["shipped", "small"])
def test_albedo_stage_forward_matches_plain(kw, dtype):
    """The shipped net (310 -> 256 -> 256 -> 3: 52 stages) and a narrow
    one, at 37 points, against ``albedo_fwd_plain``."""
    cfg, ws, bs = _albedo_net(kw, 3)
    pts, nrm, feat = _albedo_inputs(cfg, 37, seed=4)
    got = albedo_fwd_from_stages(cfg, pts, nrm, feat,
                                 *_albedo_image(ws, bs, dtype), dtype)
    _close([got], [albedo.albedo_fwd_plain(cfg, pts, nrm, feat, ws, bs, dtype)],
           dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kw", [{}, NERF_SMALL], ids=["shipped", "small"])
def test_nerf_stage_forward_matches_plain(kw, dtype):
    """The shipped net (166 stages; the fused head's 34-core boxes) and the
    8 x 64 one, at 37 points, against ``nerf_fwd_plain``."""
    cfg, ws, bs = _nerf_net(kw, 7)
    pts, views = _nerf_inputs(37, seed=8)
    image, bflat, lay = _nerf_image(cfg, ws, bs, dtype)
    if not kw:
        assert nerf.fwd_phases(lay)[cfg.D][2] == (64, 34, 2)
    got = nerf_fwd_from_stages(cfg, pts, views, image, bflat, lay, dtype)
    want = nerf.nerf_fwd_plain(cfg, pts, views, ws, bs, dtype)
    if dtype == torch.float32:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)
    else:
        _close(got, want, dtype)


def test_albedo_stage_forward_matches_pallas():
    """At f32, the small net and 203 points (ragged against the 64-point
    tile and the Pallas blocks)."""
    jcfg = jfields.RenderingConfig(**ALB_SMALL)
    cfg = fields.RenderingConfig(**ALB_SMALL)
    params = jfields.init_rendering_network(jax.random.PRNGKey(5), jcfg)
    pts, nrm, feat = _albedo_inputs(cfg, 203, seed=6)
    want = jalb.albedo_apply_fused(jcfg, params, pts.numpy(), nrm.numpy(),
                                   feat.numpy(), interpret=True,
                                   dtype=jnp.float32)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                  device="cpu")
    ws = [fields.fold_weight_norm(l).detach() for l in tp]
    bs = [l["b"].detach() for l in tp]
    got = albedo_fwd_from_stages(cfg, pts, nrm, feat,
                                 *_albedo_image(ws, bs, torch.float32),
                                 torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-6)


def test_nerf_stage_forward_matches_pallas():
    """At f32, the 8 x 64 NeRF (skip at 4) and 203 points."""
    jcfg, cfg = jfields.NeRFConfig(**NERF_SMALL), fields.NeRFConfig(**NERF_SMALL)
    params = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jax.device_get(jfields.init_nerf(jax.random.PRNGKey(9), jcfg)))
    pts, views = _nerf_inputs(203, seed=10)
    want = jnerf.nerf_apply_fused(jcfg, params, pts.numpy(), views.numpy(),
                                  interpret=True, dtype=jnp.float32)
    ws, bs = nerf.flatten_params(bridge.params_from_numpy(params, device="cpu"))
    ws, bs = [w.detach() for w in ws], [b.detach() for b in bs]
    got = nerf_fwd_from_stages(cfg, pts, views,
                               *_nerf_image(cfg, ws, bs, torch.float32),
                               torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)
