"""The port's CUDA kernels against their plain PyTorch versions on the card.

This file imports neither JAX nor the JAX package, so it also runs where
only the port is installed:  python -m pytest --noconftest
tests/test_torch_kernels.py. Every test needs a CUDA device and skips
without one (a CUDA kernel has no CPU mode).

Full widths (8x256 SDF net, 310→256→256→3 albedo net) at a point count that
is not a multiple of the 16-point tile. Tolerances, relative to the norm of
the plain result: 1e-4 at f32 operands (summation order only), 1e-2 at bf16
operands (a different summation order can flip the bf16 rounding of an
activation, one bf16 ulp = 2^-8 relative).
"""

import pytest
import torch

from rnb_tpu_torch.models import fields
from rnb_tpu_torch.ops import _build, albedo, sdf_core

N = 1037
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        err = (a - b).norm().item()
        assert err <= tol * b.norm().item() + 1e-6, (err, b.norm().item())


def _sdf_setup(dev, n=N):
    cfg = fields.SDFConfig()
    gen = torch.Generator().manual_seed(0)
    params = fields.init_sdf_network(gen, cfg, dev)
    # move off the exact geometric init so every layer carries signal
    for layer in params:
        layer["v"] = layer["v"] + 0.02 * torch.randn(
            layer["v"].shape, generator=gen).to(dev)
    ws = [fields.fold_weight_norm(l) for l in params]
    bs = [l["b"] for l in params]
    pts = (torch.rand(n, 3, generator=gen) * 1.6 - 0.8).to(dev)
    cots = (torch.randn(n, generator=gen).to(dev),
            0.1 * torch.randn(n, cfg.d_out - 1, generator=gen).to(dev),
            torch.randn(n, 3, generator=gen).to(dev))
    return cfg, ws, bs, pts, cots


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sdf_core_kernels(cuda, dtype):
    cfg, ws, bs, pts, cots = _sdf_setup(cuda)
    n0 = dict(_build.launches)
    _close(sdf_core.sdf_core_fwd(cfg, pts, ws, bs, dtype),
           sdf_core.sdf_core_fwd_plain(cfg, pts, ws, bs, dtype), TOL[dtype])
    gw, gb = sdf_core.sdf_core_bwd(cfg, pts, ws, bs, *cots, dtype)
    rw, rb = sdf_core.sdf_core_bwd_plain(cfg, pts, ws, bs, *cots, dtype)
    _close(gw + gb, rw + rb, TOL[dtype])
    torch.cuda.synchronize()
    assert _build.launches["sdf_core_fwd"] == n0["sdf_core_fwd"] + 1
    assert _build.launches["sdf_core_bwd"] == n0["sdf_core_bwd"] + 1


def test_sdf_core_ragged_rows_add_nothing(cuda):
    """dW over N points equals the sum of dW over two ragged parts."""
    cfg, ws, bs, pts, cots = _sdf_setup(cuda)
    k = 517
    full = sdf_core.sdf_core_bwd(cfg, pts, ws, bs, *cots, torch.float32)
    a = sdf_core.sdf_core_bwd(cfg, pts[:k], ws, bs, *(c[:k] for c in cots),
                              torch.float32)
    b = sdf_core.sdf_core_bwd(cfg, pts[k:], ws, bs, *(c[k:] for c in cots),
                              torch.float32)
    _close(full[0] + full[1], [x + y for x, y in zip(a[0] + a[1], b[0] + b[1])],
           1e-5)


def _albedo_setup(dev, n=N):
    cfg = fields.RenderingConfig()
    gen = torch.Generator().manual_seed(1)
    params = fields.init_rendering_network(gen, cfg, dev)
    ws = [fields.fold_weight_norm(l) for l in params]
    bs = [l["b"] for l in params]
    pts = (torch.rand(n, 3, generator=gen) * 1.6 - 0.8).to(dev)
    nrm = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen),
                                        dim=-1).to(dev)
    feat = (0.3 * torch.randn(n, cfg.d_feature, generator=gen)).to(dev)
    c_out = torch.randn(n, cfg.d_out, generator=gen).to(dev)
    return cfg, ws, bs, pts, nrm, feat, c_out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_albedo_kernels(cuda, dtype):
    cfg, ws, bs, pts, nrm, feat, c_out = _albedo_setup(cuda)
    _close([albedo.albedo_fwd(cfg, pts, nrm, feat, ws, bs, dtype)],
           [albedo.albedo_fwd_plain(cfg, pts, nrm, feat, ws, bs, dtype)],
           TOL[dtype])
    g = albedo.albedo_bwd(cfg, pts, nrm, feat, ws, bs, c_out, dtype)
    r = albedo.albedo_bwd_plain(cfg, pts, nrm, feat, ws, bs, c_out, dtype)
    _close(g[0] + g[1] + [g[2], g[3]], r[0] + r[1] + [r[2], r[3]], TOL[dtype])


def test_wrappers_reject_bad_input(cuda):
    cfg, ws, bs, pts, cots = _sdf_setup(cuda, n=32)
    with pytest.raises(ValueError):
        sdf_core.sdf_core_fwd(cfg, pts.double(), ws, bs)
    with pytest.raises(ValueError):
        sdf_core.sdf_core_fwd(cfg, pts[:, :2], ws, bs)
