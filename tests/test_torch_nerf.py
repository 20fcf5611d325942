"""The background-NeRF op of the port (rnb_tpu_torch.ops.nerf) on the CPU,
where its wrappers run the plain versions of the CUDA kernels, against the
Pallas kernel in interpret mode (rnb_tpu.ops.pallas_nerf, f32 operands) and
against plain autodiff through rnb_tpu.models.fields.nerf_apply.

Same weights (the JAX init, carried by the bridge) and the same numpy
inputs on both sides. Tolerances are those of tests/test_pallas_nerf.py:
forward rtol/atol 2e-5, loss value rtol 1e-5, gradients rtol 5e-4 and
atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnb_tpu.models import fields as jfields
from rnb_tpu.ops import pallas_nerf as pn
from rnb_tpu_torch.models import fields as tfields
from rnb_tpu_torch.ops import nerf as tnerf
from rnb_tpu_torch.utils import bridge

torch.set_num_threads(1)


def _relu_decondition(cfg, params, pts, views, tau=2e-5, delta=1e-4):
    """Nudge the bias of every unit whose pre-activation lies within tau of
    0 for some row, as tests/test_pallas_nerf.py:15 does: there a
    summation-order difference between two paths flips the ReLU mask, an
    O(|bar·x|) jump in dW that is a property of ReLU at 0."""
    pe = np.asarray(pn._pe(cfg.multires, jnp.asarray(pts)))
    pe_v = np.asarray(pn._pe(cfg.multires_view, jnp.asarray(views)))
    for _ in range(4):
        moved = False
        h = pe
        for i, layer in enumerate(params["pts_layers"]):
            z = h @ layer["w"] + layer["b"]
            bad = np.unique(np.nonzero(np.abs(z) < tau)[1])
            if bad.size:
                layer["b"][bad] += delta
                z = h @ layer["w"] + layer["b"]
                moved = True
            h = np.maximum(z, 0.0)
            if i in cfg.skips:
                h = np.concatenate([pe, h], axis=-1)
        feature = h @ params["feature_layer"]["w"] + params["feature_layer"]["b"]
        z_v = (np.concatenate([feature, pe_v], axis=-1) @ params["views_layer"]["w"]
               + params["views_layer"]["b"])
        bad = np.unique(np.nonzero(np.abs(z_v) < tau)[1])
        if bad.size:
            params["views_layer"]["b"][bad] += delta
            moved = True
        if not moved:
            break
    return params


def _setup(n=200, D=8, W=64, skips=(4,)):
    kw = dict(D=D, W=W, skips=skips)
    jcfg, tcfg = jfields.NeRFConfig(**kw), tfields.NeRFConfig(**kw)
    params = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jax.device_get(jfields.init_nerf(jax.random.PRNGKey(21), jcfg)))
    rng = np.random.default_rng(22)
    pts = rng.uniform(-1.0, 1.0, (n, 4)).astype(np.float32)
    views = rng.normal(size=(n, 3)).astype(np.float32)
    views /= np.linalg.norm(views, axis=-1, keepdims=True)
    params = _relu_decondition(jcfg, params, pts, views)
    # cotangents of the size the loss of tests/test_pallas_nerf.py gives
    # (1e-2 softplus' on alpha, 2 s^2 (1-s) on rgb); at O(1) cotangents the
    # Pallas and XLA references themselves differ by ~1e-4 in dW
    cots = (0.01 * rng.normal(size=(n, 1)).astype(np.float32),
            0.1 * rng.normal(size=(n, 3)).astype(np.float32))
    return jcfg, tcfg, params, pts, views, cots


def _pallas(cfg, params, pts, views):
    return pn.nerf_apply_fused(cfg, params, pts, views, interpret=True,
                               dtype=jnp.float32)


def _wb(params):
    """(ws, bs) tensors in the kernels' order, outside autograd."""
    ws, bs = tnerf.flatten_params(bridge.params_from_numpy(params, device="cpu"))
    return [w.detach() for w in ws], [b.detach() for b in bs]


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


CASES = {"skip": dict(), "no_skip": dict(D=3, skips=())}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    jcfg, tcfg, params, pts, views, _ = _setup(**CASES[case])
    tp = bridge.params_from_numpy(params, device="cpu")
    ws, bs = _wb(params)
    x, v = torch.tensor(pts), torch.tensor(views)
    ports = {
        "nerf_fwd": tnerf.nerf_fwd(tcfg, x, v, ws, bs, torch.float32),
        "nerf_apply_fused": tnerf.nerf_apply_fused(tcfg, tp, x, v, torch.float32),
        "fields.nerf_apply": tfields.nerf_apply(tcfg, tp, x, v),
    }
    refs = {"pallas": _pallas(jcfg, params, pts, views),
            "xla": jfields.nerf_apply(jcfg, params, pts, views)}
    for pname, got in ports.items():
        for rname, want in refs.items():
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                           rtol=2e-5, atol=2e-5,
                                           err_msg=f"{pname} vs {rname}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_plain_matches_pallas_vjp(case):
    """nerf_bwd's plain version against the Pallas VJP for general
    (nonzero) cotangents of both heads."""
    jcfg, tcfg, params, pts, views, (ca, cr) = _setup(**CASES[case])
    _, vjp = jax.vjp(lambda p: _pallas(jcfg, p, pts, views), params)
    (want,) = vjp((jnp.asarray(ca), jnp.asarray(cr)))
    ws, bs = _wb(params)
    dws, dbs = tnerf.nerf_bwd(tcfg, torch.tensor(pts), torch.tensor(views),
                              ws, bs, torch.tensor(ca), torch.tensor(cr),
                              torch.float32)
    got = tnerf.unflatten_grads(params, [d.numpy() for d in dws],
                                [d.numpy() for d in dbs])
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-5)


def _loss_t(a, r):
    return (tfields.softplus(a).sum() * 1e-2 + (torch.sigmoid(r) ** 2).sum())


def _loss_j(a, r):
    return jax.nn.softplus(a).sum() * 1e-2 + (jax.nn.sigmoid(r) ** 2).sum()


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_through_autograd_matches_jax(case):
    """d loss / d params through the render-style output activations, the
    port's fused op against the Pallas op and against XLA autodiff."""
    jcfg, tcfg, params, pts, views, _ = _setup(**CASES[case])
    tp = bridge.params_from_numpy(params, device="cpu")
    val = _loss_t(*tnerf.nerf_apply_fused(tcfg, tp, torch.tensor(pts),
                                          torch.tensor(views), torch.float32))
    val.backward()
    got = [p.grad.numpy() for p in bridge.tree_leaves(tp)]
    for fn in (lambda p: _pallas(jcfg, p, pts, views),
               lambda p: jfields.nerf_apply(jcfg, p, pts, views)):
        vx, gx = jax.value_and_grad(lambda p: _loss_j(*fn(p)))(params)
        np.testing.assert_allclose(val.item(), float(vx), rtol=1e-5)
        want = _leaves(gx)
        assert len(want) == len(got)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-5)


def test_ragged_split_sums_to_whole():
    """A ragged N (not a multiple of the 16-point tile or of the Pallas
    block): dW over N equals the sum of dW over two ragged parts, and
    matches the Pallas op, which pads."""
    jcfg, tcfg, params, pts, views, (ca, cr) = _setup(n=203, D=3, W=32,
                                                      skips=(1,))
    ws, bs = _wb(params)
    t = [torch.tensor(a) for a in (pts, views, ca, cr)]

    def bwd(sl):
        x, v, a, r = (u[sl] for u in t)
        return tnerf.nerf_bwd(tcfg, x, v, ws, bs, a, r, torch.float32)

    whole = bwd(slice(None))
    parts = [bwd(slice(None, 117)), bwd(slice(117, None))]
    for i in range(2):
        for w, a, b in zip(whole[i], parts[0][i], parts[1][i]):
            np.testing.assert_allclose(w.numpy(), (a + b).numpy(),
                                       rtol=1e-4, atol=1e-6)
    _, vjp = jax.vjp(lambda p: _pallas(jcfg, p, pts, views), params)
    (want,) = vjp((jnp.asarray(ca), jnp.asarray(cr)))
    got = tnerf.unflatten_grads(params, [d.numpy() for d in whole[0]],
                                [d.numpy() for d in whole[1]])
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-5)


def test_supported_and_skip_refusal():
    assert tnerf.supported(tfields.NeRFConfig())
    assert not tnerf.supported(tfields.NeRFConfig(multires=0))
    assert not tnerf.supported(tfields.NeRFConfig(skips=(7,)))
    cfg = tfields.NeRFConfig(D=3, W=16, skips=(2,))
    params = tfields.init_nerf(torch.Generator().manual_seed(0),
                               tfields.NeRFConfig(D=3, W=16, skips=(1,)), device="cpu")
    with pytest.raises(ValueError, match="D-1"):
        tfields.nerf_apply(cfg, params, torch.zeros(4, 4), torch.zeros(4, 3))


def test_bf16_plain_rounds_operands():
    """At bf16 the plain forward differs from f32 by operand rounding only:
    within a few bf16 ulps of the output scale, and not equal."""
    _, tcfg, params, pts, views, _ = _setup(D=3, skips=())
    ws, bs = _wb(params)
    x, v = torch.tensor(pts), torch.tensor(views)
    f32 = tnerf.nerf_fwd(tcfg, x, v, ws, bs, torch.float32)
    b16 = tnerf.nerf_fwd(tcfg, x, v, ws, bs, torch.bfloat16)
    for a, b in zip(b16, f32):
        err = (a - b).norm() / b.norm()
        assert 0 < err.item() < 2e-2
