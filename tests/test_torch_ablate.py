"""The plain versions of the SDF-core forward's ablation variants
(rnb_tpu_torch.ops.sdf_ablate) against what must not change.

The TPU variants are closures inside tools/ablate_kernel.py:main and their
numerics are wrong by design, so there is no JAX output to compare with.
What holds: ``full`` is the production forward (and that one matches the
Pallas kernel, tests/test_torch_sdf_core.py), ``primal_only`` gives the
same sdf and feature with a zero gradient, and each stripped variant
differs from ``full`` only where it strips. On the CPU the wrapper runs the
plain version; on the card tests/test_torch_kernels.py holds each CUDA
variant against it.
"""

import numpy as np
import pytest
import torch

from rnb_tpu_torch.models import fields
from rnb_tpu_torch.ops import sdf_core
from rnb_tpu_torch.ops.sdf_ablate import (MODES, sdf_fwd_ablate,
                                          sdf_fwd_ablate_plain)

torch.set_num_threads(1)

CFG = fields.SDFConfig(d_out=17, d_hidden=32, n_layers=4, skip_in=(2,),
                       multires=4)


def _setup(n=133):
    gen = torch.Generator().manual_seed(5)
    params = fields.init_sdf_network(gen, CFG, device="cpu")
    for layer in params:
        layer["v"] = layer["v"] + 0.05 * torch.randn(layer["v"].shape, generator=gen)
    ws = [fields.fold_weight_norm(l).detach() for l in params]
    bs = [l["b"].detach() for l in params]
    pts = torch.tensor(np.random.default_rng(0).uniform(-0.8, 0.8, (n, 3)),
                       dtype=torch.float32)
    return ws, bs, pts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_is_the_production_forward(dtype):
    ws, bs, pts = _setup()
    got = sdf_fwd_ablate("full", CFG, pts, ws, bs, dtype)
    want = sdf_core.sdf_core_fwd_plain(CFG, pts, ws, bs, dtype)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_primal_only_keeps_sdf_and_feature(dtype):
    ws, bs, pts = _setup()
    sdf, feat, grad = sdf_fwd_ablate_plain("primal_only", CFG, pts, ws, bs, dtype)
    want = sdf_core.sdf_core_fwd_plain(CFG, pts, ws, bs, dtype)
    assert torch.equal(sdf, want[0]) and torch.equal(feat, want[1])
    assert grad.shape == (pts.shape[0], 3) and not grad.any()


def test_stripped_variants_keep_shapes_and_differ():
    """no_pe and no_act keep full's shapes, stay finite and differ from it;
    no_pe's gradient is the same on the three axes (its tangent basis is
    one broadcast)."""
    ws, bs, pts = _setup()
    full = sdf_fwd_ablate_plain("full", CFG, pts, ws, bs, torch.float32)
    for mode in ("no_pe", "no_act"):
        out = sdf_fwd_ablate_plain(mode, CFG, pts, ws, bs, torch.float32)
        for a, b in zip(out, full):
            assert a.shape == b.shape and torch.isfinite(a).all()
        assert not torch.allclose(out[0], full[0])
    grad = sdf_fwd_ablate_plain("no_pe", CFG, pts, ws, bs, torch.float32)[2]
    assert torch.equal(grad[:, 0], grad[:, 1]) and torch.equal(grad[:, 0], grad[:, 2])


def test_no_act_reverse_sweep_is_the_vjp_of_its_chain():
    """no_act's activation has the value zb/4 and, in the sweep, the slope
    zb/2 (the TPU variant's pair): its gradient is autograd's through a
    chain built with that value and that slope."""
    ws, bs, pts = _setup(n=17)
    x = pts.clone().requires_grad_(True)
    e, _ = sdf_core._pe_parts(CFG, x)
    h = e
    for l in range(len(ws)):
        if l in CFG.skip_in:
            h = torch.cat([h, e], dim=-1) / np.sqrt(2.0)
        zb = h @ ws[l] + bs[l]
        if l < len(ws) - 1:
            q = zb * zb * 0.25
            h = (zb * 0.25).detach() + q - q.detach()
    (g,) = torch.autograd.grad(zb[:, 0].sum(), x)
    got = sdf_fwd_ablate_plain("no_act", CFG, pts, ws, bs, torch.float32)[2]
    np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=1e-4, atol=1e-5)


def test_unknown_mode_is_refused():
    ws, bs, pts = _setup(n=4)
    with pytest.raises(ValueError):
        sdf_fwd_ablate("no_sweep", CFG, pts, ws, bs)
    assert MODES == ("full", "no_pe", "no_act", "primal_only")
