"""The fused albedo (rendering) network with a hand-derived VJP, as a
``torch.autograd.Function`` around a CUDA kernel pair.

Replaces ``rnb_tpu/ops/pallas_albedo.py`` (``_fwd_kernel`` :85,
``_bwd_kernel`` :101); the kernels are in ``csrc/albedo.cu``. Forward and
backward have two routes by op dtype: bf16 (the training step's) on the
tensor cores (``albedo_fwd_wg_kernel``; ``albedo_bwd_wg_kernel`` +
``wg.dw_products``), both reading one bf16 weight image that the op packs
once a forward-plus-backward (``wg_pack``); f32 on the CUDA cores. Spans
(``utils/trace.py``): ``albedo.pack``, ``albedo.fwd``, ``albedo.bwd`` and
its ``albedo.dw``, and ``fields.fold`` around the weight-norm fold.

    forward:   x0 = [PE(p), PE(n), feat];  z_l = x_l @ W_l + b_l;
               x_{l+1} = relu(z_l);  out = sigmoid(z_last)
    backward:  bar_z_last = c_out ⊙ s(1-s);
               dW_l = x_lᵀ @ bar_z_l,  db_l = Σ bar_z_l,
               bar_x_l = bar_z_l @ W_lᵀ,  bar_z_{l-1} = bar_x ⊙ [z>0];
               c_feat  = bar_x0[:, 2E:]
               c_normal_d = bar_n_d + Σ_k 2^k (cos(2^k n_d)·bar_sin_{k,d}
                                               − sin(2^k n_d)·bar_cos_{k,d})

c_normals matters: the normal input IS ∇SDF, so autograd adds this
cotangent to the eikonal and shading cotangents that flow into the SDF
core's backward. Points get no gradient. Mode ``no_view_dir`` with
``multires_view > 0`` and the sigmoid squeeze only (the shipped confs);
other modes take ``fields.rendering_apply``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch.autograd.function import once_differentiable

from rnb_tpu_torch.models.fields import (RenderingConfig, fold_weight_norm,
                                         round_to)
from rnb_tpu_torch.ops import _build, wg
from rnb_tpu_torch.utils import trace


def supported(cfg: RenderingConfig) -> bool:
    return (cfg.mode == "no_view_dir" and cfg.multires_view > 0
            and cfg.squeeze_out)


# ---------------------------------------------------------------------------
# plain PyTorch version of the kernels' algorithm
# ---------------------------------------------------------------------------

def _pe(multires: int, x):
    """[x, sin(f0 x), cos(f0 x), ...] by the double-angle recurrence."""
    parts = [x]
    s, c = torch.sin(x), torch.cos(x)
    for k in range(multires):
        parts += [s, c]
        if k + 1 < multires:
            s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
    return torch.cat(parts, dim=-1)


def _sigmoid(z):
    t = torch.exp(-z.abs())
    inv = 1.0 / (1.0 + t)
    return torch.where(z >= 0, inv, t * inv)


def _chain(cfg, pts, nrm, feat, w16, bs, dtype):
    x0 = round_to(torch.cat([_pe(cfg.multires_view, pts),
                             _pe(cfg.multires_view, nrm), feat], dim=-1), dtype)
    h, recs = x0, []
    for l in range(len(w16)):
        z = h @ w16[l] + bs[l]
        recs.append(z)
        if l < len(w16) - 1:
            h = round_to(torch.relu(z), dtype)
    return x0, recs


def albedo_fwd_plain(cfg: RenderingConfig, pts, nrm, feat,
                     ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                     dtype=torch.bfloat16):
    w16 = [round_to(w, dtype) for w in ws]
    _, recs = _chain(cfg, pts, nrm, feat, w16, bs, dtype)
    return _sigmoid(recs[-1])


def albedo_bwd_plain(cfg: RenderingConfig, pts, nrm, feat, ws, bs, c_out,
                     dtype=torch.bfloat16):
    """-> (dws, dbs, c_normals, c_feat)."""
    L = len(ws)
    w16 = [round_to(w, dtype) for w in ws]
    x0, recs = _chain(cfg, pts, nrm, feat, w16, bs, dtype)
    s = _sigmoid(recs[-1])
    bar_z = c_out * s * (1.0 - s)
    dws: List[torch.Tensor] = [None] * L
    dbs: List[torch.Tensor] = [None] * L
    bar_x = None
    for l in range(L - 1, -1, -1):
        h_l = x0 if l == 0 else round_to(torch.relu(recs[l - 1]), dtype)
        bz16 = round_to(bar_z, dtype)
        dws[l] = h_l.T @ bz16
        dbs[l] = bar_z.sum(dim=0)
        bar_x = bz16 @ w16[l].T
        if l > 0:
            bar_x = torch.where(recs[l - 1] > 0.0, bar_x,
                                torch.zeros_like(bar_x))
            bar_z = bar_x
    E = 3 * (1 + 2 * cfg.multires_view)
    c_feat = bar_x[:, 2 * E:]
    bar_pe_n = bar_x[:, E:2 * E]
    cn = bar_pe_n[:, 0:3]
    sk, ck = torch.sin(nrm), torch.cos(nrm)
    for k in range(cfg.multires_view):
        f = 2.0 ** k
        cn = cn + f * (ck * bar_pe_n[:, 3 + 6 * k:6 + 6 * k]
                       - sk * bar_pe_n[:, 6 + 6 * k:9 + 6 * k])
        if k + 1 < cfg.multires_view:
            sk, ck = 2.0 * sk * ck, 1.0 - 2.0 * sk * sk
    return dws, dbs, cn, c_feat


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_args(cfg, pts, nrm, feat, ws, bs):
    if not supported(cfg):
        raise ValueError(f"albedo kernel supports mode no_view_dir with "
                         f"multires_view>0 and squeeze_out; got {cfg}")
    n = pts.shape[0]
    if (pts.shape != (n, 3) or nrm.shape != (n, 3) or feat.dim() != 2
            or feat.shape[0] != n or n == 0):
        raise ValueError("albedo: pts/normals must be [N>0,3], feat [N,F]")
    for t in (pts, nrm, feat, *ws, *bs):
        if t.device != pts.device or t.dtype != torch.float32:
            raise ValueError(f"albedo: all tensors must be float32 on "
                             f"{pts.device}")
    if len(ws) > 16:
        raise ValueError("albedo kernel takes at most 16 layers")
    E = 3 * (1 + 2 * cfg.multires_view)
    if ws[0].shape[0] != 2 * E + feat.shape[1]:
        raise ValueError("albedo: layer 0 width does not match the input")


@trace.spanned("albedo.fwd")
def albedo_fwd(cfg: RenderingConfig, pts, nrm, feat, ws, bs,
               dtype=torch.bfloat16, packed=None):
    """Forward kernel for CUDA tensors, plain version for CPU tensors.
    -> [N, d_out]. The op dtype names the route, never a failure: bf16
    launches the tensor-core kernel (``rnb_albedo_fwd_wg``) on ``packed``
    (``wg_pack``; packed here when None), f32 the CUDA-core kernel
    (``rnb_albedo_fwd``)."""
    if not pts.is_cuda:
        return albedo_fwd_plain(cfg, pts, nrm, feat, ws, bs, dtype)
    if _build.bf16_flag(dtype):
        out = fwd_wg(cfg, pts, nrm, feat, ws, bs, packed)
        _build.launches["albedo_fwd"] += 1
    else:
        out = _fwd_f32(cfg, pts, nrm, feat, ws, bs)
        _build.launches["albedo_fwd_f32"] += 1
    return out


def _fwd_f32(cfg, pts, nrm, feat, ws, bs):
    _check_args(cfg, pts, nrm, feat, ws, bs)
    lib = _build.library()
    pts, nrm, feat = (t.detach().contiguous() for t in (pts, nrm, feat))
    n, L = pts.shape[0], len(ws)
    wflat, _, bflat, in_dims, out_dims = _build.flat_params(ws, bs,
                                                            torch.float32)
    out = torch.empty(n, out_dims[-1], device=pts.device)
    with torch.cuda.device(pts.device):
        rc = lib.rnb_albedo_fwd(
            pts.data_ptr(), nrm.data_ptr(), feat.data_ptr(), n, feat.shape[1],
            wflat.data_ptr(), bflat.data_ptr(), _build.int_array(in_dims),
            _build.int_array(out_dims), L, cfg.multires_view, out.data_ptr(),
            torch.cuda.current_stream(pts.device).cuda_stream)
    _build.check(rc, "rnb_albedo_fwd")
    return out


@trace.spanned("albedo.bwd")
def albedo_bwd(cfg: RenderingConfig, pts, nrm, feat, ws, bs, c_out,
               dtype=torch.bfloat16, packed=None):
    """Backward kernels for CUDA tensors, plain version for CPU tensors.
    -> (dws, dbs, c_normals, c_feat). The op dtype names the route, never a
    failure: bf16 runs the tensor-core sweep (``rnb_albedo_bwd_wg``) on
    ``packed`` (as for ``albedo_fwd``) and one ``wg.dw_products`` launch, f32
    the CUDA-core sweep and split-K reduction (``rnb_albedo_bwd``)."""
    if not pts.is_cuda:
        return albedo_bwd_plain(cfg, pts, nrm, feat, ws, bs, c_out, dtype)
    if _build.bf16_flag(dtype):
        out = _bwd_wg(cfg, pts, nrm, feat, ws, bs, c_out, packed)
        _build.launches["albedo_bwd"] += 1
    else:
        out = _bwd_f32(cfg, pts, nrm, feat, ws, bs, c_out)
        _build.launches["albedo_bwd_f32"] += 1
    return out


def _cotangent(c_out, n, d_out):
    c_out = c_out.detach().float().contiguous()
    if c_out.shape != (n, d_out):
        raise ValueError("albedo backward: cotangent shape does not match")
    return c_out


def wg_layout(ws, n: int = 0) -> dict:
    """The tensor-core route's weight image and dW row offsets
    (``wg.offsets``, n rows a layer)."""
    return wg.offsets([w.shape[0] for w in ws], [w.shape[1] for w in ws], n)


@trace.spanned("albedo.pack")
def wg_pack(ws, bs):
    """The bf16 route's weights: (the bf16 weight image of ``wg_layout``,
    the biases flat in layer order). The op builds them once a
    forward-plus-backward; both kernels read them."""
    image = wg.pack_weights(ws, wg_layout(ws))
    return image, torch.cat([b.detach().reshape(-1) for b in bs]).contiguous()


def _check_feat(feat):
    if feat.shape[1] % 4:
        raise ValueError("the bf16 albedo kernels read the features as "
                         f"float4: a width that is a multiple of 4, got "
                         f"{feat.shape[1]}")


def _check_wg(lay: dict):
    ins, outs = lay["in_dims"], lay["out_dims"]
    if (len(ins) < 2 or lay["kp"][0] > 320 or max(outs[:-1]) > 256
            or outs[-1] > 8):
        raise ValueError(
            "the bf16 albedo kernel takes 2-16 layers, an input <= 320 wide "
            "after padding, hidden layers <= 256 wide and a head <= 8 wide; "
            f"got in {ins}, out {outs}")


# The forward's ring (csrc/albedo.cu albedo_fwd_params; csrc/wg_sweep.cuh
# WbCursor walks it), as (kind, layer, box, c2): the hidden layers forward
# at N = 256 (32 output cores), the head forward at N = 8 (2 cores, its
# N = 8 product reads the first): the backward's recompute phases. One
# block a pair of 64-point tiles (wg.pair_blocks); each tile's area: the A
# tile [64][320] bf16 and the bias, f32.
FWD_TILE_BYTES = 64 * 320 * 2 + 256 * 4


def fwd_phases(lay: dict) -> list:
    """The forward's phase table, in the products' order."""
    L = len(lay["in_dims"])
    return ([("fwd", l, (64, 32, 2), 0) for l in range(L - 1)]
            + [("fwd", L - 1, (64, 2, 2), 0)])


def fwd_steps(lay: dict) -> list:
    """The forward's ring stages in the order its products take them:
    (kind, layer, box, coordinates); both tiles of a block read each."""
    return wg.phase_steps(lay, fwd_phases(lay))


def fwd_smem_bytes(depth: int = wg.ALBEDO_FWD_RING_DEPTH) -> int:
    """The forward's shared memory at ring ``depth``."""
    return wg.ring_smem_bytes(depth, FWD_TILE_BYTES)


def fwd_wg(cfg, pts, nrm, feat, ws, bs, packed=None, tune=None):
    """The bf16 forward kernel alone (CUDA tensors): ``rnb_albedo_fwd_wg``,
    or the tune library's instance ``tune`` = (entry, leading arguments)
    that ``wg.fwd_tune`` names; on ``packed`` (``wg_pack``; packed here
    when None). Counts nothing. -> [N, d_out]."""
    _check_args(cfg, pts, nrm, feat, ws, bs)
    pts, nrm, feat = (t.detach().contiguous() for t in (pts, nrm, feat))
    n, L = pts.shape[0], len(ws)
    lay = wg_layout(ws)
    _check_wg(lay)
    _check_feat(feat)
    if feat.data_ptr() % 16:   # the kernel reads the feature rows as float4
        feat = feat.clone()
    entry, lead = tune or ("rnb_albedo_fwd_wg", ())
    kind = "tune" if tune else "main"
    image, bflat = packed or wg_pack(ws, bs)
    out = torch.empty(n, lay["out_dims"][-1], device=pts.device)
    with torch.cuda.device(pts.device):
        rc = getattr(_build.library(kind), entry)(
            *lead, pts.data_ptr(), nrm.data_ptr(), feat.data_ptr(), n,
            feat.shape[1], image.data_ptr(), bflat.data_ptr(),
            _build.int_array(lay["in_dims"]), _build.int_array(lay["out_dims"]),
            _build.ll_array(lay["w_off"]), L, cfg.multires_view, out.data_ptr(),
            torch.cuda.current_stream(pts.device).cuda_stream)
    _build.check(rc, entry, kind)
    return out


# The backward sweep's ring (csrc/albedo.cu albedo_bwd_params;
# csrc/wg_sweep.cuh WbCursor walks it), as (kind, layer, box, c2): the hidden
# layers forward at N = 256 (32 output cores), the head forward at N = 8 (2
# cores, its N = 8 product reads the first); the head and the hidden
# layers but layer 0 reverse at N = 256 (32 input cores); layer 0's
# reverse (320 wide, past wgmma's N = 256) as two passes over the same
# K-steps, input cores 34..39 (N = 48: c_feat) then 2..33 (N = 256: PE(n)'s
# cotangent and c_feat; columns 0..15 hold PE(p), which gets no
# cotangent). One block a pair of 64-point tiles (wg.pair_blocks); each
# tile's area: the A tile [64][320] bf16, two hidden layers' ReLU masks (a
# uint4 a thread), the column sums [4][256] and the bias, f32.
BWD_TILE_BYTES = 64 * 320 * 2 + 2 * 128 * 16 + 4 * 256 * 4 + 256 * 4


def bwd_phases(lay: dict) -> list:
    """The backward sweep's phase table, in the products' order."""
    L = len(lay["in_dims"])
    ph = [("fwd", l, (64, 32, 2), 0) for l in range(L - 1)]
    ph.append(("fwd", L - 1, (64, 2, 2), 0))
    ph += [("rev", l, (64, 2, 32), 0) for l in range(L - 1, 0, -1)]
    ph += [("rev", 0, (64, 2, 6), 34), ("rev", 0, (64, 2, 32), 2)]
    return ph


def bwd_steps(lay: dict) -> list:
    """The backward sweep's ring stages in the order its products take
    them: (kind, layer, box, coordinates); both tiles of a block read
    each."""
    return wg.phase_steps(lay, bwd_phases(lay))


def bwd_smem_bytes(depth: int = wg.ALBEDO_BWD_RING_DEPTH) -> int:
    """The backward sweep's shared memory at ring ``depth``."""
    return wg.ring_smem_bytes(depth, BWD_TILE_BYTES)


def bwd_sweep(cfg, pts, nrm, feat, ws, bs, c_out, packed=None, tune=None):
    """The bf16 backward sweep alone (CUDA tensors): ``rnb_albedo_bwd_wg``,
    or the tune library's instance ``tune`` = (entry, leading arguments)
    that ``wg.bwd_tune`` names; on ``packed`` (``wg_pack``; packed here when
    None). Counts nothing. -> (abuf, bbuf, db, c_normals, c_feat, lay): the
    bf16 dW operand rows of ``wg_layout(ws, n)`` and db flat."""
    _check_args(cfg, pts, nrm, feat, ws, bs)
    pts, nrm, feat = (t.detach().contiguous() for t in (pts, nrm, feat))
    n, L, F = pts.shape[0], len(ws), feat.shape[1]
    lay = wg_layout(ws, n)
    _check_wg(lay)
    _check_feat(feat)
    if L > 3 or (lay["in_dims"][0] - F) // 2 < 16:
        raise ValueError(
            "the bf16 albedo backward takes at most two hidden layers and a "
            "PE of the normals at least 16 wide; got in "
            f"{lay['in_dims']}, out {lay['out_dims']}")
    c_out = _cotangent(c_out, n, lay["out_dims"][-1])
    if feat.data_ptr() % 16:   # the sweep reads the feature rows as float4
        feat = feat.clone()
    entry, lead = tune or ("rnb_albedo_bwd_wg", ())
    kind = "tune" if tune else "main"
    lib = _build.library(kind)
    dev = pts.device
    image, bflat = packed or wg_pack(ws, bs)
    abuf = torch.empty(lay["a_len"], dtype=torch.bfloat16, device=dev)
    bbuf = torch.empty(lay["b_len"], dtype=torch.bfloat16, device=dev)
    dbp = torch.empty(-(-n // wg.TILE) * bflat.numel(), device=dev)
    db = torch.empty(bflat.numel(), device=dev)
    cnrm = torch.empty(n, 3, device=dev)
    cfeat = torch.empty(n, F, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            *lead, pts.data_ptr(), nrm.data_ptr(), feat.data_ptr(), n, F,
            image.data_ptr(), bflat.data_ptr(),
            _build.int_array(lay["in_dims"]), _build.int_array(lay["out_dims"]),
            _build.ll_array(lay["w_off"]), _build.ll_array(lay["a_off"]),
            _build.ll_array(lay["bb_off"]), L, cfg.multires_view,
            c_out.data_ptr(), abuf.data_ptr(), bbuf.data_ptr(), dbp.data_ptr(),
            db.data_ptr(), cnrm.data_ptr(), cfeat.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, entry, kind)
    return abuf, bbuf, db, cnrm, cfeat, lay


def _bwd_wg(cfg, pts, nrm, feat, ws, bs, c_out, packed):
    abuf, bbuf, db, cnrm, cfeat, lay = bwd_sweep(cfg, pts, nrm, feat, ws, bs,
                                                 c_out, packed)
    with trace.span("albedo.dw"):
        dws = wg.dw_products(abuf, bbuf, lay, pts.shape[0], "albedo_dw_gemm")
    return dws, _build.unflat(db, [tuple(b.shape) for b in bs]), cnrm, cfeat


def _bwd_f32(cfg, pts, nrm, feat, ws, bs, c_out):
    _check_args(cfg, pts, nrm, feat, ws, bs)
    lib = _build.library()
    pts, nrm, feat = (t.detach().contiguous() for t in (pts, nrm, feat))
    n, L, F = pts.shape[0], len(ws), feat.shape[1]
    wflat, wtflat, bflat, in_dims, out_dims = _build.flat_params(
        ws, bs, torch.float32)
    c_out = _cotangent(c_out, n, out_dims[-1])
    dev = pts.device
    rec_ld = max(out_dims[:-1], default=1)
    rec = torch.empty(max(L - 1, 1) * n * rec_ld, device=dev)
    abuf = torch.empty(n * sum(in_dims), device=dev)
    bbuf = torch.empty(n * sum(out_dims), device=dev)
    splits = _build.splits_for(max(in_dims), max(out_dims), n)
    partial = torch.empty(splits * max(i * o for i, o in zip(in_dims, out_dims)),
                          device=dev)
    dw = torch.empty(wflat.numel(), device=dev)
    db = torch.empty(bflat.numel(), device=dev)
    cnrm = torch.empty(n, 3, device=dev)
    cfeat = torch.empty(n, F, device=dev)
    with torch.cuda.device(dev):
        rc = lib.rnb_albedo_bwd(
            pts.data_ptr(), nrm.data_ptr(), feat.data_ptr(), n, F,
            wflat.data_ptr(), wtflat.data_ptr(), bflat.data_ptr(),
            _build.int_array(in_dims), _build.int_array(out_dims), L,
            cfg.multires_view, c_out.data_ptr(), rec.data_ptr(), rec_ld,
            abuf.data_ptr(), bbuf.data_ptr(), partial.data_ptr(), splits,
            dw.data_ptr(), db.data_ptr(), cnrm.data_ptr(), cfeat.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rnb_albedo_bwd")
    return (_build.unflat(dw, [tuple(w.shape) for w in ws]),
            _build.unflat(db, [tuple(b.shape) for b in bs]), cnrm, cfeat)


class _Albedo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, dtype, pts, nrm, feat, *wb):
        L = len(wb) // 2
        ctx.cfg, ctx.dtype = cfg, dtype
        # the bf16 route's weight image, packed once for both kernels
        ctx.packed = (wg_pack(wb[:L], wb[L:]) if dtype == torch.bfloat16
                      else None)
        ctx.save_for_backward(pts, nrm, feat, *wb)
        return albedo_fwd(cfg, pts, nrm, feat, wb[:L], wb[L:], dtype,
                          ctx.packed)

    @staticmethod
    @once_differentiable
    def backward(ctx, c_out):
        pts, nrm, feat, *wb = ctx.saved_tensors
        L = len(wb) // 2
        dws, dbs, cnrm, cfeat = albedo_bwd(ctx.cfg, pts, nrm, feat, wb[:L],
                                           wb[L:], c_out, ctx.dtype,
                                           ctx.packed)
        return (None, None, None, cnrm, cfeat, *dws, *dbs)


def albedo_apply_fused(cfg: RenderingConfig, params, points, normals,
                       feature_vectors, dtype=torch.bfloat16):
    """Drop-in for ``fields.rendering_apply`` in mode 'no_view_dir':
    [N,3],[N,3],[N,F] -> albedo [N,d_out], differentiable w.r.t. params
    (incl. weight norm), normals and features."""
    with trace.span("fields.fold"):
        ws = [fold_weight_norm(layer) for layer in params]
    bs = [layer["b"] for layer in params]
    return _Albedo.apply(cfg, dtype, points, normals, feature_vectors,
                         *ws, *bs)
