"""The port's albedo op (rnb_tpu_torch.ops.albedo) against the JAX
package's Pallas kernel in interpret mode at f32 operands: outputs, and the
gradients w.r.t. params (incl. weight norm), normals and features.

On the CPU the op runs its plain PyTorch version of the kernels' algorithm;
tests/test_torch_kernels.py compares the CUDA kernels with it.
Tolerances are those of tests/test_pallas_albedo.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnb_tpu.models import fields as jfields
from rnb_tpu.ops import pallas_albedo as jalb
from rnb_tpu_torch.models import fields as tfields
from rnb_tpu_torch.ops import albedo
from rnb_tpu_torch.utils import bridge

torch.set_num_threads(1)

SMALL = dict(d_feature=32, d_hidden=32, n_layers=2, multires_view=4)


def _dense(layer):
    v = np.asarray(layer["v"])
    return v * (np.asarray(layer["g"])[None] /
                np.maximum(np.linalg.norm(v, axis=0, keepdims=True), 1e-12))


def _push_off_relu_boundary(params, x0, tau=2e-5, delta=1e-4):
    """Nudge the biases of hidden units whose pre-activation sits within tau
    of 0 for some row (as tests/test_pallas_nerf.py does): ReLU's gradient
    jumps there, and a summation-order difference between the two packages
    could flip the unit's mask — a property of ReLU at 0, not a defect."""
    params = jax.tree_util.tree_map(np.array, params)
    for _ in range(4):
        h, moved = x0, False
        for l, layer in enumerate(params[:-1]):
            z = h @ _dense(layer) + layer["b"]
            bad = np.unique(np.nonzero(np.abs(z) < tau)[1])
            if bad.size:
                layer["b"][bad] += delta
                z = h @ _dense(layer) + layer["b"]
                moved = True
            h = np.maximum(z, 0.0)
        if not moved:
            break
    return params


def _setup(n=200, **over):
    kw = {**SMALL, **over}
    jcfg, tcfg = jfields.RenderingConfig(**kw), tfields.RenderingConfig(**kw)
    params = jfields.init_rendering_network(jax.random.PRNGKey(11), jcfg)
    rng = np.random.default_rng(12)
    pts = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    feat = (rng.normal(size=(n, kw["d_feature"])) * 0.3).astype(np.float32)
    x0 = np.asarray(jnp.concatenate([jalb._pe(4, pts), jalb._pe(4, nrm), feat], -1))
    params = _push_off_relu_boundary(params, x0)
    return jcfg, tcfg, params, pts, nrm, feat


@pytest.mark.parametrize("n_layers", [2, 4])
def test_forward_matches_pallas(n_layers):
    jcfg, tcfg, params, pts, nrm, feat = _setup(n_layers=n_layers)
    oj = jalb.albedo_apply_fused(jcfg, params, pts, nrm, feat, interpret=True,
                                 dtype=jnp.float32)
    tp = bridge.params_from_numpy(params, device="cpu")
    ot = albedo.albedo_apply_fused(tcfg, tp, torch.tensor(pts),
                                   torch.tensor(nrm), torch.tensor(feat),
                                   dtype=torch.float32)
    np.testing.assert_allclose(ot.detach().numpy(), oj, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("n", [200, 1029])
def test_backward_params_normals_feat(n):
    """d loss / d {params, normals, features} (the 1029 case is ragged
    against the Pallas blocks)."""
    jcfg, tcfg, params, pts, nrm, feat = _setup(n=n)
    tgt = np.random.default_rng(13).uniform(size=(n, 3)).astype(np.float32)

    def fj(p, g, fv):
        out = jalb.albedo_apply_fused(jcfg, p, pts, g, fv, interpret=True,
                                      dtype=jnp.float32)
        return jnp.abs(out - tgt).sum() + (out ** 2).mean()

    lj, (gpj, gnj, gfj) = jax.value_and_grad(fj, argnums=(0, 1, 2))(
        params, nrm, feat)

    tp = bridge.params_from_numpy(params, device="cpu")
    tn = torch.tensor(nrm, requires_grad=True)
    tf = torch.tensor(feat, requires_grad=True)
    out = albedo.albedo_apply_fused(tcfg, tp, torch.tensor(pts), tn, tf,
                                    dtype=torch.float32)
    lt = (out - torch.tensor(tgt)).abs().sum() + (out ** 2).mean()
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    got = [p.grad.numpy() for p in bridge.tree_leaves(tp)] + [
        tn.grad.numpy(), tf.grad.numpy()]
    want = jax.tree_util.tree_leaves(gpj) + [gnj, gfj]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-5)


def test_plain_matches_rendering_apply():
    """The op's forward equals the field's plain rendering_apply."""
    _, tcfg, params, pts, nrm, feat = _setup()
    tp = bridge.params_from_numpy(params, device="cpu")
    a = albedo.albedo_apply_fused(tcfg, tp, torch.tensor(pts),
                                  torch.tensor(nrm), torch.tensor(feat),
                                  dtype=torch.float32)
    b = tfields.rendering_apply(tcfg, tp, torch.tensor(pts), torch.tensor(nrm),
                                None, torch.tensor(feat))
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               rtol=2e-5, atol=2e-6)

