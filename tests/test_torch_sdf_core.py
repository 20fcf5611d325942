"""The port's SDF core op (rnb_tpu_torch.ops.sdf_core) against the JAX
package's Pallas kernel in interpret mode at f32 operands.

On the CPU the op runs its plain PyTorch version of the kernels' algorithm
(the forward with its reverse sweep, the collapsed single-slab backward);
tests/test_torch_kernels.py compares the CUDA kernels with that version.
Tolerances are those of tests/test_pallas_sdf_core.py: the two sides differ
only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnb_tpu.models import fields as jfields
from rnb_tpu.ops import pallas_sdf_core as jcore
from rnb_tpu_torch.models import fields as tfields
from rnb_tpu_torch.ops import _build, sdf_core
from rnb_tpu_torch.utils import bridge

torch.set_num_threads(1)

SMALL = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)


def _setup(n=200, seed=3, **over):
    kw = {**SMALL, **over}
    jcfg, tcfg = jfields.SDFConfig(**kw), tfields.SDFConfig(**kw)
    params = jfields.init_sdf_network(jax.random.PRNGKey(seed), jcfg)
    pts = np.random.default_rng(seed).uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    return jcfg, tcfg, params, pts


def _port(tcfg, params, pts):
    tp = bridge.params_from_numpy(jax.device_get(params), device="cpu")
    return tp, sdf_core.sdf_value_feat_grad_fused(
        tcfg, tp, torch.tensor(pts), dtype=torch.float32)


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_forward_matches_pallas(scale):
    jcfg, tcfg, params, pts = _setup(scale=scale)
    sj, fj, gj = jcore.sdf_value_feat_grad_fused(
        jcfg, params, jnp.asarray(pts), interpret=True, dtype=jnp.float32)
    _, (st, ft, gt) = _port(tcfg, params, pts)
    np.testing.assert_allclose(st.detach().numpy(), sj, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ft.detach().numpy(), fj, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(gt.detach().numpy(), gj, rtol=2e-4, atol=2e-5)


def _grads_match(jcfg, tcfg, params, pts, loss_j, loss_t, rtol=5e-4, atol=5e-6):
    def fj(p):
        return loss_j(*jcore.sdf_value_feat_grad_fused(
            jcfg, p, jnp.asarray(pts), interpret=True, dtype=jnp.float32))

    lj, gj = jax.value_and_grad(fj)(params)
    tp, outs = _port(tcfg, params, pts)
    lt = loss_t(*outs)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    flat_j = jax.tree_util.tree_leaves(gj)
    flat_t = [p.grad.numpy() for p in bridge.tree_leaves(tp)]
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_t, flat_j):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_backward_second_order():
    """A loss on sdf, feat AND grad (the eikonal second-order case)."""
    jcfg, tcfg, params, pts = _setup()
    cw = np.random.default_rng(5).normal(size=(200, SMALL["d_out"] - 1)
                                         ).astype(np.float32) * 0.1

    def loss_j(sdf, feat, grad):
        eik = ((jnp.linalg.norm(grad, axis=-1) - 1.0) ** 2).mean()
        return sdf.sum() * 1e-2 + (feat * cw).mean() + eik

    def loss_t(sdf, feat, grad):
        eik = ((torch.linalg.vector_norm(grad, dim=-1) - 1.0) ** 2).mean()
        return sdf.sum() * 1e-2 + (feat * torch.tensor(cw)).mean() + eik

    _grads_match(jcfg, tcfg, params, pts, loss_j, loss_t)


def test_backward_no_skip_arch():
    jcfg, tcfg, params, pts = _setup(skip_in=(), n_layers=3)
    _grads_match(jcfg, tcfg, params, pts,
                 lambda s, f, g: s.mean() + (g ** 2).sum() * 1e-2,
                 lambda s, f, g: s.mean() + (g ** 2).sum() * 1e-2)


def test_ragged_n():
    """A point count that is not a multiple of the Pallas block (the JAX
    side pads, the port masks nothing on the CPU): same grads."""
    jcfg, tcfg, params, pts = _setup(n=jcore.BLOCK + 7, seed=7)
    _grads_match(jcfg, tcfg, params, pts,
                 lambda s, f, g: s.sum() + (g ** 2).sum(),
                 lambda s, f, g: s.sum() + (g ** 2).sum(),
                 rtol=1e-4, atol=1e-5)


def test_plain_matches_port_autograd():
    """The plain kernel algorithm at f32 equals plain autograd of the field
    (sdf_apply + create_graph ∇SDF) — the port's own two paths agree."""
    _, tcfg, params, pts = _setup()
    tp = bridge.params_from_numpy(jax.device_get(params), device="cpu")
    x = torch.tensor(pts)
    s1, f1, g1 = sdf_core.sdf_value_feat_grad_fused(tcfg, tp, x, torch.float32)
    s2, f2, g2 = tfields.sdf_value_feat_grad(tcfg, tp, x)
    for a, b in ((s1, s2), (f1, f2), (g1, g2)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-4, atol=2e-5)


def test_cpu_path_launches_no_kernel():
    _, tcfg, params, pts = _setup(n=16)
    before = dict(_build.launches)
    tp, outs = _port(tcfg, params, pts)
    sum(o.sum() for o in outs).backward()
    assert _build.launches == before

