"""The port's CUDA kernels against their plain PyTorch versions on the card.

This file imports neither JAX nor the JAX package, so it also runs where
only the port is installed:  python -m pytest --noconftest
tests/test_torch_kernels.py. Every test needs a CUDA device and skips
without one (a CUDA kernel has no CPU mode).

Full widths (8x256 SDF net, 310→256→256→3 albedo net, the 8x256 background
NeRF with its 84-wide PE, 340-wide skip input and 283-wide views layer) at a
point count that is not a multiple of the 16-point tile of the CUDA-core
kernels nor of the 64-point tile of the tensor-core ones. The SDF core and
the albedo and NeRF forwards and backwards run both of their routes: bf16
on the tensor cores, f32 on the CUDA cores. Tolerances, relative to the norm of
the plain result: 1e-4 at f32 operands (summation order only), 1e-2 at bf16
operands (a different summation order can flip the bf16 rounding of an
activation, one bf16 ulp = 2^-8 relative). The grouped dW product
(``wg.dw_products``, csrc/dw_gemm.cu) is held within 1e-5 of the f32
product (bf16 operands: only the order of f32 sums differs), its TMA
boxes one piece at a time and each shipped backward's layers in one
launch, bit for bit from call to call. The tile sweep's library
(``_build.library("tune")``: the SDF core's sweeps at ring depths 3-6) is
held bit for bit against the production kernels at every depth (the depth
changes no sum's order), and against the plain version. The bf16 backward
sweep (TMA-fed) repeats bit for bit, and the ``full`` instance of its
timing split is the production sweep.
"""

import pytest
import torch

from rnb_tpu_torch.models import fields
from rnb_tpu_torch.ops import _build, albedo, nerf, sdf_ablate, sdf_core, wg

N = 1037
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _moved(before):
    """The launch counters that moved since ``before``, by how much."""
    return {k: _build.launches[k] - before[k] for k in _build.launches
            if _build.launches[k] != before[k]}


def _close(got, want, tol):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        err = (a - b).norm().item()
        assert err <= tol * b.norm().item() + 1e-6, (err, b.norm().item())


def _close_joint(got, want, tol):
    """As _close, over the tensors taken together (the norm of all errors
    against the norm of the whole result)."""
    for a, b in zip(got, want):
        assert a.shape == b.shape
    err = sum((a - b).pow(2).sum().item() for a, b in zip(got, want)) ** 0.5
    ref = sum(b.pow(2).sum().item() for b in want) ** 0.5
    assert err <= tol * ref + 1e-6, (err, ref)


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


# the counters of each route: bf16 runs the tensor-core kernels (and one
# grouped dW launch a backward), f32 the CUDA-core kernels
ROUTE = {torch.bfloat16: {"sdf_core_fwd": 1, "sdf_core_bwd": 1,
                          "sdf_dw_gemm": 1},
         torch.float32: {"sdf_core_fwd_f32": 1, "sdf_core_bwd_f32": 1}}


@pytest.mark.parametrize("n", [N, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sdf_core_kernels(cuda, dtype, n):
    """Both routes against the plain version, at a ragged count and at one
    tile of 64 points that is mostly padding; the launch counters show
    which route ran."""
    cfg, ws, bs, pts, cots = _sdf_setup(cuda, n)
    n0 = dict(_build.launches)
    _close(sdf_core.sdf_core_fwd(cfg, pts, ws, bs, dtype),
           sdf_core.sdf_core_fwd_plain(cfg, pts, ws, bs, dtype), TOL[dtype])
    gw, gb = sdf_core.sdf_core_bwd(cfg, pts, ws, bs, *cots, dtype)
    rw, rb = sdf_core.sdf_core_bwd_plain(cfg, pts, ws, bs, *cots, dtype)
    _close(gw + gb, rw + rb, TOL[dtype])
    torch.cuda.synchronize()
    assert _moved(n0) == ROUTE[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sdf_core_ragged_rows_add_nothing(cuda, dtype):
    """dW over N points equals the sum of dW over two ragged parts (517 and
    520 points: neither a multiple of the 16- or the 64-point tile)."""
    cfg, ws, bs, pts, cots = _sdf_setup(cuda)
    k = 517
    full = sdf_core.sdf_core_bwd(cfg, pts, ws, bs, *cots, dtype)
    a = sdf_core.sdf_core_bwd(cfg, pts[:k], ws, bs, *(c[:k] for c in cots),
                              dtype)
    b = sdf_core.sdf_core_bwd(cfg, pts[k:], ws, bs, *(c[k:] for c in cots),
                              dtype)
    _close(full[0] + full[1], [x + y for x, y in zip(a[0] + a[1], b[0] + b[1])],
           1e-5)


def test_dw_gemm_matches_plain(cuda):
    """The tensor-core dW product at the ragged widths of the net (39 -> 48
    inputs, 257 -> 272 outputs) over a row count that is not a multiple of
    its 64-row stage; deterministic from call to call."""
    gen = torch.Generator().manual_seed(4)
    a = torch.randn(1037, 48, generator=gen).to(torch.bfloat16).to(cuda)
    b = torch.randn(1037, 272, generator=gen).to(torch.bfloat16).to(cuda)
    got = sdf_core.dw_gemm(a, b, 39, 257)
    _close([got], [sdf_core.dw_gemm_plain(a, b, 39, 257)], 1e-5)
    assert torch.equal(got, sdf_core.dw_gemm(a, b, 39, 257))


@pytest.mark.parametrize("k,m,n,lda,ldb", [
    (64, 64, 64, 64, 64),      # one 64x64 box of each operand, one stage
    (64, 64, 256, 64, 256),    # B: four boxes along N (the LBO stride)
    (64, 128, 64, 128, 64),    # A: both consumer warpgroups
    (200, 256, 257, 256, 272), # the SDF head: a 256 tile and a 64 tile
    (130, 310, 3, 320, 16)])   # three m-tiles, the last 54 rows; n = 3
def test_dw_gemm_boxes(cuda, k, m, n, lda, ldb):
    """The swizzled TMA boxes and their wgmma descriptors, one piece at a
    time from a single box up, against the plain product."""
    gen = torch.Generator().manual_seed(6)
    a = torch.randn(k, lda, generator=gen).to(torch.bfloat16).to(cuda)
    b = torch.randn(k, ldb, generator=gen).to(torch.bfloat16).to(cuda)
    _close([wg.dw_gemm(a, b, m, n, counter="sdf_dw_gemm")],
           [wg.dw_gemm_plain(a, b, m, n)], 1e-5)


def _shipped_layout(which, rows):
    if which == "sdf":
        cfg = fields.SDFConfig()
        ws = [fields.fold_weight_norm(l) for l in fields.init_sdf_network(
            torch.Generator().manual_seed(0), cfg, "cpu")]
        return sdf_core.wg_layout(cfg, ws, rows // 2), "sdf_dw_gemm"
    if which == "albedo":
        ws = [fields.fold_weight_norm(l) for l in fields.init_rendering_network(
            torch.Generator().manual_seed(1), fields.RenderingConfig(), "cpu")]
        return albedo.wg_layout(ws, rows), "albedo_dw_gemm"
    cfg = fields.NeRFConfig()
    ws, _ = nerf.flatten_params(fields.init_nerf(
        torch.Generator().manual_seed(2), cfg, device="cpu"))
    return nerf.wg_layout(cfg, ws, rows), "nerf_dw_gemm"


@pytest.mark.parametrize("rows", [1037, 517, 520, 7])
@pytest.mark.parametrize("which", ["sdf", "albedo", "nerf"])
def test_dw_products_match_plain(cuda, which, rows):
    """The grouped dW kernel over every layer of a shipped layout (one
    launch, counted once) against dw_gemm_plain a layer, at ragged row
    counts and one under a 64-row stage (the SDF core's rows come in
    primal and tangent pairs: 1036 for 1037); two calls equal bit for
    bit."""
    rows -= rows % 2 if which == "sdf" else 0
    lay, counter = _shipped_layout(which, rows)
    gen = torch.Generator().manual_seed(7)
    abuf = torch.randn(lay["a_len"], generator=gen).to(torch.bfloat16).to(cuda)
    bbuf = torch.randn(lay["b_len"], generator=gen).to(torch.bfloat16).to(cuda)
    n0 = dict(_build.launches)
    got = wg.dw_products(abuf, bbuf, lay, rows, counter)
    torch.cuda.synchronize()
    assert _moved(n0) == {counter: 1}
    want = wg.dw_products(abuf.cpu(), bbuf.cpu(), lay, rows, counter)
    _close(got, [w.to(cuda) for w in want], 1e-5)
    again = wg.dw_products(abuf, bbuf, lay, rows, counter)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


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


# the albedo and NeRF counters of each route
ALB_ROUTE = {torch.bfloat16: {"albedo_fwd": 1, "albedo_bwd": 1,
                              "albedo_dw_gemm": 1},
             torch.float32: {"albedo_fwd_f32": 1, "albedo_bwd_f32": 1}}
NERF_ROUTE = {torch.bfloat16: {"nerf_fwd": 1, "nerf_bwd": 1,
                               "nerf_dw_gemm": 1},
              torch.float32: {"nerf_fwd_f32": 1, "nerf_bwd_f32": 1}}


@pytest.mark.parametrize("n", [N, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_albedo_kernels(cuda, dtype, n):
    """Both routes of forward and backward against the plain version, at a
    ragged count and at one mostly padded tile; the counters show which
    route ran."""
    cfg, ws, bs, pts, nrm, feat, c_out = _albedo_setup(cuda, n)
    n0 = dict(_build.launches)
    _close([albedo.albedo_fwd(cfg, pts, nrm, feat, ws, bs, dtype)],
           [albedo.albedo_fwd_plain(cfg, pts, nrm, feat, ws, bs, dtype)],
           TOL[dtype])
    g = albedo.albedo_bwd(cfg, pts, nrm, feat, ws, bs, c_out, dtype)
    r = albedo.albedo_bwd_plain(cfg, pts, nrm, feat, ws, bs, c_out, dtype)
    _close(g[0] + g[1] + [g[2], g[3]], r[0] + r[1] + [r[2], r[3]], TOL[dtype])
    torch.cuda.synchronize()
    assert _moved(n0) == ALB_ROUTE[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_albedo_ragged_rows_add_nothing(cuda, dtype):
    """dW, db over N points equal the sums over two ragged parts (517 and
    520 points), and the per-point cotangents are the parts' rows."""
    cfg, ws, bs, pts, nrm, feat, c_out = _albedo_setup(cuda)
    k = 517
    full = albedo.albedo_bwd(cfg, pts, nrm, feat, ws, bs, c_out, dtype)
    a = albedo.albedo_bwd(cfg, pts[:k], nrm[:k], feat[:k], ws, bs, c_out[:k],
                          dtype)
    b = albedo.albedo_bwd(cfg, pts[k:], nrm[k:], feat[k:], ws, bs, c_out[k:],
                          dtype)
    _close(full[0] + full[1],
           [x + y for x, y in zip(a[0] + a[1], b[0] + b[1])], 1e-5)
    _close(full[2:], [torch.cat([x, y]) for x, y in zip(a[2:], b[2:])], 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_albedo_forward_ragged_parts(cuda, dtype):
    """The forward over N points is the rows of the forwards over two
    ragged parts (517 and 520 points)."""
    cfg, ws, bs, pts, nrm, feat, _ = _albedo_setup(cuda)
    k = 517
    full = albedo.albedo_fwd(cfg, pts, nrm, feat, ws, bs, dtype)
    a = albedo.albedo_fwd(cfg, pts[:k], nrm[:k], feat[:k], ws, bs, dtype)
    b = albedo.albedo_fwd(cfg, pts[k:], nrm[k:], feat[k:], ws, bs, dtype)
    _close([full], [torch.cat([a, b])], 1e-6)


def _nerf_setup(dev, n=N):
    """The shipped background NeRF on points drawn as render_core_outside
    feeds them ([x/r, 1/r], |x| = 1, 1/r in (0.1, 1]), kept where every
    ReLU pre-activation is at least 2e-5 from 0 at both op dtypes
    (nerf.relu_margin: nearer, the summation noise of ~1e-6 can flip a mask
    between kernel and plain version)."""
    cfg = fields.NeRFConfig()
    gen = torch.Generator().manual_seed(2)
    ws, bs = nerf.flatten_params(fields.init_nerf(gen, cfg, device="cpu"))
    m = 3 * n
    x = torch.nn.functional.normalize(torch.randn(m, 3, generator=gen), dim=-1)
    r = torch.rand(m, 1, generator=gen) * 0.9 + 0.1
    pts = torch.cat([x, r], dim=-1)
    views = torch.nn.functional.normalize(torch.randn(m, 3, generator=gen), dim=-1)
    keep = ((nerf.relu_margin(cfg, pts, views, ws, bs) >= 2e-5)
            & (nerf.relu_margin(cfg, pts, views, ws, bs, torch.bfloat16) >= 2e-5))
    assert keep.sum() >= n
    pts, views = pts[keep][:n].to(dev), views[keep][:n].to(dev)
    cots = (torch.randn(n, 1, generator=gen).to(dev),
            torch.randn(n, 3, generator=gen).to(dev))
    return cfg, [w.to(dev) for w in ws], [b.to(dev) for b in bs], pts, views, cots


@pytest.mark.parametrize("n", [N, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nerf_kernels(cuda, dtype, n):
    """At bf16 the backward is held to the norm of all its tensors together:
    db of a trunk layer sums O(1) cotangents of random sign over the points
    and cancels to a small norm, where a one-ulp bf16 flip of an activation
    weighs ~1e-2 even between two plain versions (CPU and cuBLAS). The
    counters show which route of forward and backward ran."""
    cfg, ws, bs, pts, views, cots = _nerf_setup(cuda, n)
    n0 = dict(_build.launches)
    _close(nerf.nerf_fwd(cfg, pts, views, ws, bs, dtype),
           nerf.nerf_fwd_plain(cfg, pts, views, ws, bs, dtype), TOL[dtype])
    gw, gb = nerf.nerf_bwd(cfg, pts, views, ws, bs, *cots, dtype)
    rw, rb = nerf.nerf_bwd_plain(cfg, pts, views, ws, bs, *cots, dtype)
    (_close if dtype == torch.float32 else _close_joint)(gw + gb, rw + rb,
                                                         TOL[dtype])
    torch.cuda.synchronize()
    assert _moved(n0) == NERF_ROUTE[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nerf_ragged_rows_add_nothing(cuda, dtype):
    """dW over N points equals the sum of dW over two ragged parts."""
    cfg, ws, bs, pts, views, cots = _nerf_setup(cuda)
    k = 517
    full = nerf.nerf_bwd(cfg, pts, views, ws, bs, *cots, dtype)
    a = nerf.nerf_bwd(cfg, pts[:k], views[:k], ws, bs, *(c[:k] for c in cots),
                      dtype)
    b = nerf.nerf_bwd(cfg, pts[k:], views[k:], ws, bs, *(c[k:] for c in cots),
                      dtype)
    _close(full[0] + full[1], [x + y for x, y in zip(a[0] + a[1], b[0] + b[1])],
           1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nerf_forward_ragged_parts(cuda, dtype):
    """alpha and rgb over N points are the rows of those over two ragged
    parts."""
    cfg, ws, bs, pts, views, _ = _nerf_setup(cuda)
    k = 517
    full = nerf.nerf_fwd(cfg, pts, views, ws, bs, dtype)
    a = nerf.nerf_fwd(cfg, pts[:k], views[:k], ws, bs, dtype)
    b = nerf.nerf_fwd(cfg, pts[k:], views[k:], ws, bs, dtype)
    _close(full, [torch.cat([x, y]) for x, y in zip(a, b)], 1e-6)


@pytest.mark.parametrize("mode", sdf_ablate.MODES)
def test_sdf_ablation_variants(cuda, mode):
    cfg, ws, bs, pts, _ = _sdf_setup(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        n0 = _build.launches["sdf_fwd_ablate"]
        got = sdf_ablate.sdf_fwd_ablate(mode, cfg, pts, ws, bs, dtype)
        want = sdf_ablate.sdf_fwd_ablate_plain(mode, cfg, pts, ws, bs, dtype)
        torch.cuda.synchronize()
        assert _build.launches["sdf_fwd_ablate"] == n0 + 1
        _close(got, want, TOL[dtype])


def test_ablation_full_is_the_production_kernel(cuda):
    """At bf16 the ablation tool's full mode is the tensor-core forward of
    the main path, bit for bit."""
    cfg, ws, bs, pts, _ = _sdf_setup(cuda)
    got = sdf_ablate.sdf_fwd_ablate("full", cfg, pts, ws, bs, torch.bfloat16)
    want = sdf_core.sdf_core_fwd(cfg, pts, ws, bs, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_wrappers_reject_bad_input(cuda):
    cfg, ws, bs, pts, cots = _sdf_setup(cuda, n=32)
    with pytest.raises(ValueError):
        sdf_core.sdf_core_fwd(cfg, pts.double(), ws, bs)
    with pytest.raises(ValueError):
        sdf_core.sdf_core_fwd(cfg, pts[:, :2], ws, bs)
    ncfg, nws, nbs, npts, views, _ = _nerf_setup(cuda, n=32)
    with pytest.raises(ValueError):
        nerf.nerf_fwd(ncfg, npts.double(), views, nws, nbs)
    with pytest.raises(ValueError):
        nerf.nerf_fwd(ncfg, npts[:, :3], views, nws, nbs)
    with pytest.raises(ValueError):
        nerf.nerf_fwd(ncfg, npts, views[:16], nws, nbs)
    # widths the tensor-core forwards and backwards do not take: they
    # raise, never fall back to the CUDA-core route
    n0 = dict(_build.launches)
    gen = torch.Generator().manual_seed(5)
    for W in (512, 128):   # the bf16 NeRF trunk is exactly 256 wide
        other = fields.NeRFConfig(W=W)
        ww, wb = nerf.flatten_params(fields.init_nerf(gen, other, device=cuda))
        with pytest.raises(ValueError):
            nerf.nerf_fwd(other, npts, views, ww, wb)
        with pytest.raises(ValueError):
            nerf.nerf_bwd(other, npts, views, ww, wb,
                          torch.zeros(32, 1, device=cuda),
                          torch.zeros(32, 3, device=cuda))
    acfg = fields.RenderingConfig(d_hidden=512)
    aparams = fields.init_rendering_network(gen, acfg, cuda)
    aw = [fields.fold_weight_norm(l) for l in aparams]
    ab = [l["b"] for l in aparams]
    apts, anrm = npts[:, :3], torch.nn.functional.normalize(npts[:, :3], dim=-1)
    afeat = torch.zeros(32, acfg.d_feature, device=cuda)
    with pytest.raises(ValueError):
        albedo.albedo_fwd(acfg, apts, anrm, afeat, aw, ab)
    with pytest.raises(ValueError):
        albedo.albedo_bwd(acfg, apts, anrm, afeat, aw, ab,
                          torch.zeros(32, 3, device=cuda))
    assert _moved(n0) == {}


def test_tune_library_depth4_is_production(cuda):
    """The tile sweep's library at the forward's production ring depth (4)
    runs the production forward; the backward sweep at depth 4 (production:
    16) gives the production backward's bits: forward and backward equal
    bit for bit."""
    cfg, ws, bs, pts, cots = _sdf_setup(cuda)
    bf16 = torch.bfloat16
    n0 = dict(_build.launches)
    got = sdf_core.sdf_core_fwd_tune(cfg, pts, ws, bs, 4)
    want = sdf_core.sdf_core_fwd(cfg, pts, ws, bs, bf16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    gw, gb = sdf_core.sdf_core_bwd_tune(cfg, pts, ws, bs, *cots, 4)
    rw, rb = sdf_core.sdf_core_bwd(cfg, pts, ws, bs, *cots, bf16)
    assert all(torch.equal(a, b) for a, b in zip(gw + gb, rw + rb))
    torch.cuda.synchronize()
    assert _moved(n0) == {"sdf_core_fwd_rs4": 1, "sdf_core_bwd_rs4": 1,
                          "sdf_core_fwd": 1, "sdf_core_bwd": 1,
                          "sdf_dw_gemm": 2}


@pytest.mark.parametrize("n", [N, 37])
def test_sdf_bwd_sweep_repeats_bit_for_bit(cuda, n):
    """Two calls of the bf16 backward sweep give the same dW operand rows
    and db, and two backwards the same dW and db (no atomics, fixed
    sums)."""
    cfg, ws, bs, pts, cots = _sdf_setup(cuda, n)
    packed = sdf_core.wg_pack(cfg, ws, bs)
    a = sdf_core.bwd_sweep(cfg, pts, ws, bs, *cots, packed)
    b = sdf_core.bwd_sweep(cfg, pts, ws, bs, *cots, packed)
    lay = a[3]
    rows = 2 * n
    for buf_a, buf_b, offs, widths in ((a[0], b[0], lay["a_off"], lay["kp"]),
                                       (a[1], b[1], lay["bb_off"], lay["np"])):
        for off, w in zip(offs, widths):
            assert torch.equal(buf_a[off:off + rows * w], buf_b[off:off + rows * w])
    assert torch.equal(a[2], b[2])
    gw, gb = sdf_core.sdf_core_bwd(cfg, pts, ws, bs, *cots, torch.bfloat16)
    hw, hb = sdf_core.sdf_core_bwd(cfg, pts, ws, bs, *cots, torch.bfloat16)
    assert all(torch.equal(x, y) for x, y in zip(gw + gb, hw + hb))


def test_sdf_bwd_split_full_is_production(cuda):
    """The timing split's ``full`` instance (tune library) is the
    production sweep bit for bit; every other instance launches, counted
    once, and fills buffers of the production shapes."""
    cfg, ws, bs, pts, cots = _sdf_setup(cuda)
    packed = sdf_core.wg_pack(cfg, ws, bs)
    want = sdf_core.bwd_sweep(cfg, pts, ws, bs, *cots, packed)
    for split in sdf_core.BWD_SPLIT:
        n0 = dict(_build.launches)
        got = sdf_core.sdf_bwd_split(split, cfg, pts, ws, bs, *cots, packed)
        torch.cuda.synchronize()
        assert _moved(n0) == {"sdf_bwd_split": 1}
        assert [t.shape for t in got[:3]] == [t.shape for t in want[:3]]
        if split == "full":
            assert torch.equal(got[2], want[2])
            for buf_g, buf_w, offs, widths in (
                    (got[0], want[0], want[3]["a_off"], want[3]["kp"]),
                    (got[1], want[1], want[3]["bb_off"], want[3]["np"])):
                for off, w in zip(offs, widths):
                    sl = slice(off, off + 2 * N * w)
                    assert torch.equal(buf_g[sl], buf_w[sl])


@pytest.mark.parametrize("depth", [d for d in _build.TUNE_DEPTHS
                                   if d != wg.RING_DEPTH])
def test_tune_library_other_depths(cuda, depth):
    """The sweep's other ring depths: bit for bit the production kernels
    (a stale ring stage in a few tiles would hide under the tolerance), and
    against the plain version at the bf16 tolerance."""
    cfg, ws, bs, pts, cots = _sdf_setup(cuda)
    bf16 = torch.bfloat16
    got = sdf_core.sdf_core_fwd_tune(cfg, pts, ws, bs, depth)
    want = sdf_core.sdf_core_fwd(cfg, pts, ws, bs, bf16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    _close(got, sdf_core.sdf_core_fwd_plain(cfg, pts, ws, bs, bf16), TOL[bf16])
    gw, gb = sdf_core.sdf_core_bwd_tune(cfg, pts, ws, bs, *cots, depth)
    pw, pb = sdf_core.sdf_core_bwd(cfg, pts, ws, bs, *cots, bf16)
    assert all(torch.equal(a, b) for a, b in zip(gw + gb, pw + pb))
    rw, rb = sdf_core.sdf_core_bwd_plain(cfg, pts, ws, bs, *cots, bf16)
    _close(gw + gb, rw + rb, TOL[bf16])


@pytest.mark.parametrize("depth", [min(_build.TUNE_DEPTHS) - 1,
                                   max(_build.TUNE_DEPTHS) + 1])
def test_tune_library_refuses_unbuilt_depths(cuda, depth):
    """A depth the tune library holds no instance of comes back as a CUDA
    error that the wrapper raises; nothing is counted."""
    cfg, ws, bs, pts, cots = _sdf_setup(cuda, n=64)
    n0 = dict(_build.launches)
    with pytest.raises(RuntimeError, match="rnb_sdf_fwd_wg_tune"):
        sdf_core.sdf_core_fwd_tune(cfg, pts, ws, bs, depth)
    with pytest.raises(RuntimeError, match="rnb_sdf_bwd_wg_tune"):
        sdf_core.sdf_core_bwd_tune(cfg, pts, ws, bs, *cots, depth)
    assert _moved(n0) == {}


@pytest.mark.parametrize("splits", [1, 2, 7])
def test_dw_gemm_split_counts(cuda, splits):
    """dw_gemm at a split count of the sweep's (the grouped kernel's row
    splits) against the plain product."""
    gen = torch.Generator().manual_seed(4)
    a = torch.randn(1037, 48, generator=gen).to(torch.bfloat16).to(cuda)
    b = torch.randn(1037, 272, generator=gen).to(torch.bfloat16).to(cuda)
    _close([sdf_core.dw_gemm(a, b, 39, 257, splits=splits)],
           [sdf_core.dw_gemm_plain(a, b, 39, 257)], 1e-5)
