"""The fused differentiable SDF core: value + feature + ∇SDF with a
hand-derived VJP, as a ``torch.autograd.Function`` around a CUDA kernel pair.

Replaces ``rnb_tpu/ops/pallas_sdf_core.py`` (``_fwd_kernel`` :169,
``_bwd_kernel`` :232); the kernels are in ``csrc/sdf_core.cu``, whose header
says what bounds them on the H100 and how they keep per-point state.

The algorithm is the TPU kernel's:

FORWARD: ∇SDF is a vector-Jacobian product of ONE output channel, so the
kernel runs the primal chain, keeps the biased pre-activations, and sweeps
back once with a seed of ``W_last[:, 0]``. ∇SDF is a *primal output* of the
op, so a loss on it (the eikonal term) stays first-order.

BACKWARD: the cotangent of ∇SDF enters only through
Σ_d c_grad_d ∂(∇SDF_d)/∂W; tangent propagation is linear in the tangent input
and cotangent propagation linear in the seed, so the three per-axis tangent
slabs collapse into ONE directional slab ``T' = Σ_d c_grad_d ∂e/∂u_d`` with a
unit seed on the sdf column. Per layer (rows X = [a; T'], Z = X W; primal
rows get +b and softplus100, tangent rows σ'(z)⊙):

    dW_l = a_lᵀ bar_z_l + T'_lᵀ bar_T'_l        db_l = Σ bar_z_l
    bar_z_l = bar_h ⊙ σ'(z_l) + (bar_Th' ⊙ Tz'_l) ⊙ σ''(z_l)
    bar_Tz' = bar_Th' ⊙ σ'(z_l)
    σ' = sigmoid(100 z), σ'' = 100 s (1 - s)

with the skip concat at l ∈ skip_in contributing bar/√2 to its inputs.
Matmul operands are rounded to the op dtype (bf16 on the main path, f32 in
the comparisons) with f32 accumulation. pts gets no gradient: sample points
never require one in this framework.

``sdf_core_fwd`` / ``sdf_core_bwd`` launch the kernel for a CUDA tensor (or
raise) and run the plain PyTorch version, ``*_plain``, for a CPU tensor.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
from torch.autograd.function import once_differentiable

from rnb_tpu_torch.models.fields import SDFConfig, fold_weight_norm, round_to
from rnb_tpu_torch.ops import _build


def supported(cfg: SDFConfig) -> bool:
    return cfg.multires > 0 and cfg.d_in == 3 and 0 not in cfg.skip_in


def _c16(dtype) -> float:
    """1/√2 as the op dtype holds it (the skip concat is scaled in it)."""
    return float(torch.tensor(1.0 / math.sqrt(2.0)).to(dtype))


# ---------------------------------------------------------------------------
# plain PyTorch version of the kernels' algorithm
# ---------------------------------------------------------------------------

def _pe_parts(cfg: SDFConfig, pts):
    """(e [N,E], tc [N,E]) for u = pts*scale: the positional encoding by the
    double-angle recurrence, and per channel c the tangent ∂e_c/∂u_{c%3}
    (each channel depends on its own coordinate only)."""
    u = pts * cfg.scale
    e_parts, t_parts = [u], [torch.ones_like(u)]
    s, c = torch.sin(u), torch.cos(u)
    for k in range(cfg.multires):
        f = 2.0 ** k
        e_parts += [s, c]
        t_parts += [f * c, -f * s]
        if k + 1 < cfg.multires:
            s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
    return torch.cat(e_parts, dim=-1), torch.cat(t_parts, dim=-1)


def _softplus100_pair(z):
    t = torch.exp(-100.0 * z.abs())
    inv = 1.0 / (1.0 + t)
    s = torch.where(z >= 0, inv, t * inv)
    h = torch.clamp_min(z, 0.0) + torch.log1p(t) * 0.01
    return s, h


def sdf_core_fwd_plain(cfg: SDFConfig, pts, ws: Sequence[torch.Tensor],
                       bs: Sequence[torch.Tensor], dtype=torch.bfloat16):
    """[N,3] -> (sdf [N], feat [N,d_out-1], grad [N,3]), the forward
    kernel's algorithm on whole tensors."""
    L = len(ws)
    w16 = [round_to(w, dtype) for w in ws]
    c16 = _c16(dtype)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    e, tc = _pe_parts(cfg, pts)
    e16 = round_to(e, dtype)
    h, recs, z = e16, [], None
    for l in range(L):
        if l in cfg.skip_in:
            h = round_to(torch.cat([h, e16], dim=-1) * c16, dtype)
        z = h @ w16[l]
        if l < L - 1:
            zb = z + bs[l]
            recs.append(zb)
            h = round_to(_softplus100_pair(zb)[1], dtype)
    z8 = z + bs[L - 1]
    sdf, feat = z8[:, 0] / cfg.scale, z8[:, 1:]

    bar_e = torch.zeros_like(e)
    bar_h = None
    for l in range(L - 1, -1, -1):
        if l == L - 1:
            bar_x = w16[l][:, 0].expand(pts.shape[0], -1)
        else:
            s, _ = _softplus100_pair(recs[l])
            bar_x = round_to(bar_h * s, dtype) @ w16[l].T
        if l in cfg.skip_in:
            hd = bar_x.shape[-1] - e.shape[-1]
            bar_e = bar_e + bar_x[:, hd:] * inv_sqrt2
            bar_h = bar_x[:, :hd] * inv_sqrt2
        else:
            bar_h = bar_x
    bar_e = bar_e + bar_h
    grad = (bar_e * tc).reshape(pts.shape[0], -1, 3).sum(dim=1)
    return sdf, feat, grad


def sdf_core_bwd_plain(cfg: SDFConfig, pts, ws, bs, c_sdf, c_feat, c_grad,
                       dtype=torch.bfloat16):
    """-> (dws, dbs): the backward kernel's collapsed single-slab sweep."""
    L = len(ws)
    w16 = [round_to(w, dtype) for w in ws]
    c16 = _c16(dtype)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    e, tc = _pe_parts(cfg, pts)
    tdir = c_grad.repeat(1, e.shape[-1] // 3) * tc
    e16, t16 = round_to(e, dtype), round_to(tdir, dtype)

    xs, recs = [], []
    h, th = e16, t16
    for l in range(L):
        if l in cfg.skip_in:
            h = round_to(torch.cat([h, e16], dim=-1) * c16, dtype)
            th = round_to(torch.cat([th, t16], dim=-1) * c16, dtype)
        xs.append((h, th))
        if l < L - 1:
            zb = h @ w16[l] + bs[l]
            tz = th @ w16[l]
            recs.append((zb, tz))
            s, hh = _softplus100_pair(zb)
            h, th = round_to(hh, dtype), round_to(tz * s, dtype)

    bar_z = torch.cat([c_sdf[:, None] / cfg.scale, c_feat], dim=-1)
    bar_t = torch.zeros_like(bar_z)
    bar_t[:, 0] = 1.0
    dws: List[torch.Tensor] = [None] * L
    dbs: List[torch.Tensor] = [None] * L
    for l in range(L - 1, -1, -1):
        h16, th16 = xs[l]
        bz16, bt16 = round_to(bar_z, dtype), round_to(bar_t, dtype)
        dws[l] = h16.T @ bz16 + th16.T @ bt16
        dbs[l] = bar_z.sum(dim=0)
        if l == 0:
            break
        bar_h, bar_th = bz16 @ w16[l].T, bt16 @ w16[l].T
        if l in cfg.skip_in:
            hd = bar_h.shape[-1] - e.shape[-1]
            bar_h, bar_th = bar_h[:, :hd] * inv_sqrt2, bar_th[:, :hd] * inv_sqrt2
        zp, tzp = recs[l - 1]
        s, _ = _softplus100_pair(zp)
        bar_z = bar_h * s + (bar_th * tzp) * (100.0 * s * (1.0 - s))
        bar_t = bar_th * s
    return dws, dbs


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_args(cfg: SDFConfig, pts, ws, bs):
    if not supported(cfg):
        raise ValueError(f"sdf core kernel needs d_in=3, multires>0 and no "
                         f"skip at layer 0; got {cfg}")
    if pts.dim() != 2 or pts.shape[1] != 3 or pts.shape[0] == 0:
        raise ValueError(f"pts must be [N>0, 3], got {tuple(pts.shape)}")
    for t in (pts, *ws, *bs):
        if t.device != pts.device or t.dtype != torch.float32:
            raise ValueError("sdf core: all tensors must be float32 on "
                             f"{pts.device}")
    if len(ws) > 16:
        raise ValueError("sdf core kernel takes at most 16 layers")
    if ws[0].shape[0] != cfg.input_ch:
        raise ValueError(f"layer 0 takes {ws[0].shape[0]} inputs, the "
                         f"encoding gives {cfg.input_ch}")


def sdf_core_fwd(cfg: SDFConfig, pts, ws, bs, dtype=torch.bfloat16):
    """Forward kernel (``rnb_sdf_fwd``) for a CUDA tensor, plain version
    for a CPU tensor."""
    if not pts.is_cuda:
        return sdf_core_fwd_plain(cfg, pts, ws, bs, dtype)
    out = launch_fwd(cfg, pts, ws, bs, dtype)
    _build.launches["sdf_core_fwd"] += 1
    return out


def launch_fwd(cfg: SDFConfig, pts, ws, bs, dtype, entry="rnb_sdf_fwd",
               lead=()):
    """Check the CUDA tensors, allocate the outputs and the pre-activation
    record, and launch the C entry ``entry`` with the arguments ``lead``
    followed by ``rnb_sdf_fwd``'s. -> (sdf, feat, grad)."""
    _check_args(cfg, pts, ws, bs)
    bf = _build.bf16_flag(dtype)
    lib = _build.library()
    pts = pts.detach().contiguous()
    n, L = pts.shape[0], len(ws)
    wflat, wtflat, bflat, in_dims, out_dims = _build.flat_params(ws, bs, dtype)
    rec_ld = max(out_dims[:-1], default=1)
    dev = pts.device
    rec = torch.empty(max(L - 1, 1) * n * rec_ld, device=dev)
    sdf = torch.empty(n, device=dev)
    feat = torch.empty(n, out_dims[-1] - 1, device=dev)
    grad = torch.empty(n, 3, device=dev)
    skip = [int(l in cfg.skip_in) for l in range(L)]
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            *lead, pts.data_ptr(), n, wflat.data_ptr(), wtflat.data_ptr(),
            bflat.data_ptr(), _build.int_array(in_dims),
            _build.int_array(out_dims), _build.int_array(skip), L,
            cfg.multires, cfg.scale, bf, _c16(dtype), rec.data_ptr(), rec_ld,
            sdf.data_ptr(), feat.data_ptr(), grad.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, entry)
    return sdf, feat, grad


def sdf_core_bwd(cfg: SDFConfig, pts, ws, bs, c_sdf, c_feat, c_grad,
                 dtype=torch.bfloat16):
    """Backward kernel (``rnb_sdf_bwd``: sweep + dW/db reduction) for a
    CUDA tensor, plain version for a CPU tensor. -> (dws, dbs)."""
    if not pts.is_cuda:
        return sdf_core_bwd_plain(cfg, pts, ws, bs, c_sdf, c_feat, c_grad,
                                  dtype)
    _check_args(cfg, pts, ws, bs)
    bf = _build.bf16_flag(dtype)
    lib = _build.library()
    pts = pts.detach().contiguous()
    n, L = pts.shape[0], len(ws)
    wflat, wtflat, bflat, in_dims, out_dims = _build.flat_params(ws, bs, dtype)
    cots = [t.detach().float().contiguous() for t in (c_sdf, c_feat, c_grad)]
    if (cots[0].shape != (n,) or cots[1].shape != (n, out_dims[-1] - 1)
            or cots[2].shape != (n, 3)):
        raise ValueError("sdf core backward: cotangent shapes do not match")
    rec_ld = max(out_dims[:-1], default=1)
    dev = pts.device
    rec_z = torch.empty(max(L - 1, 1) * n * rec_ld, device=dev)
    rec_t = torch.empty_like(rec_z)
    abuf = torch.empty(2 * n * sum(in_dims), device=dev)
    bbuf = torch.empty(2 * n * sum(out_dims), device=dev)
    splits = _build.splits_for(max(in_dims), max(out_dims), 2 * n)
    partial = torch.empty(splits * max(i * o for i, o in zip(in_dims, out_dims)),
                          device=dev)
    dw = torch.empty(wflat.numel(), device=dev)
    db = torch.empty(bflat.numel(), device=dev)
    skip = [int(l in cfg.skip_in) for l in range(L)]
    with torch.cuda.device(dev):
        rc = lib.rnb_sdf_bwd(
            pts.data_ptr(), n, wflat.data_ptr(), wtflat.data_ptr(),
            bflat.data_ptr(), _build.int_array(in_dims),
            _build.int_array(out_dims), _build.int_array(skip), L,
            cfg.multires, cfg.scale, bf, _c16(dtype), cots[0].data_ptr(),
            cots[1].data_ptr(), cots[2].data_ptr(), rec_z.data_ptr(),
            rec_t.data_ptr(), rec_ld, abuf.data_ptr(), bbuf.data_ptr(),
            partial.data_ptr(), splits, dw.data_ptr(), db.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rnb_sdf_bwd")
    _build.launches["sdf_core_bwd"] += 1
    return (_build.unflat(dw, [tuple(w.shape) for w in ws]),
            _build.unflat(db, [tuple(b.shape) for b in bs]))


class _SDFCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, dtype, pts, *wb):
        L = len(wb) // 2
        ctx.cfg, ctx.dtype = cfg, dtype
        ctx.save_for_backward(pts, *wb)
        return sdf_core_fwd(cfg, pts, wb[:L], wb[L:], dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, c_sdf, c_feat, c_grad):
        pts, *wb = ctx.saved_tensors
        L = len(wb) // 2
        dws, dbs = sdf_core_bwd(ctx.cfg, pts, wb[:L], wb[L:], c_sdf, c_feat,
                                c_grad, ctx.dtype)
        return (None, None, None, *dws, *dbs)


def sdf_value_feat_grad_fused(cfg: SDFConfig, params, pts,
                              dtype=torch.bfloat16):
    """[N,3] -> (sdf [N], feat [N,F], grad [N,3]), differentiable w.r.t.
    params (weight norm folded outside the kernel, so autograd carries dW
    back to {v, g}) in one reverse pass."""
    ws = [fold_weight_norm(layer) for layer in params]
    bs = [layer["b"] for layer in params]
    return _SDFCore.apply(cfg, dtype, pts, *ws, *bs)
