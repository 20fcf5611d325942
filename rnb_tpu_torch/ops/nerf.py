"""The fused background NeRF (NeRF++ inverted-sphere net) with a
hand-derived VJP over the parameters, as a ``torch.autograd.Function``
around a CUDA kernel pair.

Replaces ``rnb_tpu/ops/pallas_nerf.py`` (``_fwd_kernel`` :105,
``_bwd_kernel`` :122); the kernels are in ``csrc/nerf.cu``, whose header
says what bounds them on the H100.

    forward:   e = PE(pts), v = PE(views) (double-angle recurrence);
               trunk z_i = x_i @ W_i + b_i, h_i = relu(z_i),
               x_{i+1} = [e, h_i] after a skip (PE first, unscaled);
               alpha = h @ W_a + b_a;  feat = h @ W_f + b_f;
               rgb = relu([feat, v] @ W_v + b_v) @ W_rgb + b_rgb
    backward:  bar_z_v = (c_rgb @ W_rgbᵀ) ⊙ [z_v > 0];
               bar_feat = (bar_z_v @ W_vᵀ)[:, :W];
               bar_h = bar_feat @ W_fᵀ + c_alpha @ W_aᵀ;
               trunk bar_z_i = bar_h ⊙ [z_i > 0], the PE slice of a skip
               input dropped;  dW_l = x_lᵀ @ rnd(bar_z_l), db_l = Σ bar_z_l

The outputs are raw (softplus on the density and sigmoid on the colour stay
in ``render_core_outside``). Every input is a stop-gradient sample position
or view direction, so pts and views get no gradient. Matmul operands are
rounded to the op dtype where the TPU kernel casts them (bf16 on the main
path, f32 in the comparisons) with f32 accumulation.

Weight layout: NeRF layers are plain ``{w [in,out], b [out]}`` (no weight
norm), flattened in the order ``[pts_layers..., alpha, feature, views,
rgb]``.
"""

from __future__ import annotations

from typing import List

import torch
from torch.autograd.function import once_differentiable

from rnb_tpu_torch.models.fields import NeRFConfig, round_to
from rnb_tpu_torch.ops import _build
from rnb_tpu_torch.ops.albedo import _pe

_HEADS = ("alpha_layer", "feature_layer", "views_layer", "rgb_layer")


def supported(cfg: NeRFConfig) -> bool:
    return (cfg.use_viewdirs and cfg.multires > 0 and cfg.multires_view > 0
            and not (cfg.skips and max(cfg.skips) >= cfg.D - 1))


def flatten_params(params):
    """The params dict -> (ws, bs) lists in the kernels' order."""
    layers = list(params["pts_layers"]) + [params[k] for k in _HEADS]
    return [l["w"] for l in layers], [l["b"] for l in layers]


def unflatten_grads(params, dws, dbs):
    """(dws, dbs) in the kernels' order -> a dict shaped like ``params``."""
    D = len(params["pts_layers"])
    out = {"pts_layers": [{"w": dws[i], "b": dbs[i]} for i in range(D)]}
    for j, name in enumerate(_HEADS):
        out[name] = {"w": dws[D + j], "b": dbs[D + j]}
    return out


# ---------------------------------------------------------------------------
# plain PyTorch version of the kernels' algorithm
# ---------------------------------------------------------------------------

def _trunk(cfg: NeRFConfig, pe16, w16, bs, dtype, recs=None):
    """The skip-concat ReLU chain -> trunk output h (op dtype); appends the
    pre-activations to ``recs`` when given."""
    h = pe16
    for i in range(cfg.D):
        z = h @ w16[i] + bs[i]
        if recs is not None:
            recs.append(z)
        h = round_to(torch.relu(z), dtype)
        if i in cfg.skips:
            h = torch.cat([pe16, h], dim=-1)
    return h


def _inputs(cfg: NeRFConfig, pts, views, ws, dtype):
    w16 = [round_to(w, dtype) for w in ws]
    pe16 = round_to(_pe(cfg.multires, pts), dtype)
    pev16 = round_to(_pe(cfg.multires_view, views), dtype)
    return w16, pe16, pev16


def nerf_fwd_plain(cfg: NeRFConfig, pts, views, ws, bs,
                   dtype=torch.bfloat16):
    """-> (alpha_raw [N,1], rgb_raw [N,3]), the forward kernel's algorithm
    on whole tensors."""
    D = cfg.D
    w16, pe16, pev16 = _inputs(cfg, pts, views, ws, dtype)
    h = _trunk(cfg, pe16, w16, bs, dtype)
    alpha = h @ w16[D] + bs[D]
    feature = h @ w16[D + 1] + bs[D + 1]
    h2 = torch.cat([round_to(feature, dtype), pev16], dim=-1)
    hv = round_to(torch.relu(h2 @ w16[D + 2] + bs[D + 2]), dtype)
    return alpha, hv @ w16[D + 3] + bs[D + 3]


def relu_margin(cfg: NeRFConfig, pts, views, ws, bs, dtype=torch.float32):
    """Per point, the least |pre-activation| over the ReLU layers (trunk
    and views layer) of the plain forward. Where it lies within the
    summation noise of 0, two summation orders (kernel and plain version)
    can disagree on the ReLU mask, and that point's dW below the layer then
    differs by its whole contribution: a property of ReLU at 0, not of
    either version. Comparisons of the two draw points with a margin."""
    D = cfg.D
    w16, pe16, pev16 = _inputs(cfg, pts, views, ws, dtype)
    recs: List[torch.Tensor] = []
    h = _trunk(cfg, pe16, w16, bs, dtype, recs)
    feature = h @ w16[D + 1] + bs[D + 1]
    z_v = torch.cat([round_to(feature, dtype), pev16], dim=-1) @ w16[D + 2] + bs[D + 2]
    return torch.stack([z.abs().amin(dim=-1) for z in recs + [z_v]]).amin(dim=0)


def nerf_bwd_plain(cfg: NeRFConfig, pts, views, ws, bs, c_alpha, c_rgb,
                   dtype=torch.bfloat16):
    """-> (dws, dbs): the backward kernel's recompute and reverse sweep."""
    D = cfg.D
    w16, pe16, pev16 = _inputs(cfg, pts, views, ws, dtype)
    recs: List[torch.Tensor] = []
    h = _trunk(cfg, pe16, w16, bs, dtype, recs)
    feature = h @ w16[D + 1] + bs[D + 1]
    h2 = torch.cat([round_to(feature, dtype), pev16], dim=-1)
    z_v = h2 @ w16[D + 2] + bs[D + 2]
    hv = round_to(torch.relu(z_v), dtype)

    dws: List[torch.Tensor] = [None] * (D + 4)
    dbs: List[torch.Tensor] = [None] * (D + 4)

    def grads(l, x, bar):
        dws[l] = x.T @ round_to(bar, dtype)
        dbs[l] = bar.sum(dim=0)

    def relu_mask(z):
        return (z > 0.0).float()

    grads(D + 3, hv, c_rgb)
    bar_zv = (round_to(c_rgb, dtype) @ w16[D + 3].T) * relu_mask(z_v)
    grads(D + 2, h2, bar_zv)
    bar_feature = (round_to(bar_zv, dtype) @ w16[D + 2].T)[:, :feature.shape[-1]]
    grads(D + 1, h, bar_feature)
    grads(D, h, c_alpha)
    bar_h = (round_to(bar_feature, dtype) @ w16[D + 1].T
             + round_to(c_alpha, dtype) @ w16[D].T)
    E = pe16.shape[-1]
    for i in range(D - 1, -1, -1):
        if i in cfg.skips:
            bar_h = bar_h[:, E:]               # the concat put PE first
        bar_z = bar_h * relu_mask(recs[i])
        if i == 0:
            x = pe16
        else:
            x = round_to(torch.relu(recs[i - 1]), dtype)
            if i - 1 in cfg.skips:
                x = torch.cat([pe16, x], dim=-1)
        grads(i, x, bar_z)
        if i > 0:
            bar_h = round_to(bar_z, dtype) @ w16[i].T
    return dws, dbs


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _skip_mask(cfg: NeRFConfig) -> int:
    return sum(1 << i for i in set(cfg.skips))


def _check_args(cfg: NeRFConfig, pts, views, ws, bs):
    if not supported(cfg):
        raise ValueError(f"nerf kernel needs use_viewdirs, multires>0, "
                         f"multires_view>0 and skips < D-1; got {cfg}")
    n = pts.shape[0]
    if pts.dim() != 2 or n == 0 or views.shape != (n, 3):
        raise ValueError("nerf: pts must be [N>0, C], views [N, 3]")
    for t in (pts, views, *ws, *bs):
        if t.device != pts.device or t.dtype != torch.float32:
            raise ValueError(f"nerf: all tensors must be float32 on "
                             f"{pts.device}")
    D = cfg.D
    if len(ws) != D + 4 or len(bs) != D + 4 or len(ws) > 16:
        raise ValueError("nerf kernel takes D trunk layers + 4 heads, at "
                         "most 16 layers")
    E = pts.shape[1] * (1 + 2 * cfg.multires)
    ins = [E] + [ws[i - 1].shape[1] + (E if i - 1 in cfg.skips else 0)
                 for i in range(1, D)]
    W = ws[D - 1].shape[1]
    ins += [W, W, ws[D + 1].shape[1] + cfg.input_ch_view, ws[D + 2].shape[1]]
    if [w.shape[0] for w in ws] != ins:
        raise ValueError("nerf: layer widths do not match the inputs and "
                         "the skips")


def nerf_fwd(cfg: NeRFConfig, pts, views, ws, bs, dtype=torch.bfloat16):
    """Forward kernel (``rnb_nerf_fwd``) for CUDA tensors, plain version
    for CPU tensors. -> (alpha_raw [N,1], rgb_raw [N,3])."""
    if not pts.is_cuda:
        return nerf_fwd_plain(cfg, pts, views, ws, bs, dtype)
    _check_args(cfg, pts, views, ws, bs)
    bf = _build.bf16_flag(dtype)
    lib = _build.library()
    pts, views = (t.detach().contiguous() for t in (pts, views))
    n, L, dev = pts.shape[0], len(ws), pts.device
    wflat, _, bflat, in_dims, out_dims = _build.flat_params(ws, bs, dtype)
    alpha = torch.empty(n, out_dims[cfg.D], device=dev)
    rgb = torch.empty(n, out_dims[-1], device=dev)
    with torch.cuda.device(dev):
        rc = lib.rnb_nerf_fwd(
            pts.data_ptr(), views.data_ptr(), n, pts.shape[1],
            wflat.data_ptr(), bflat.data_ptr(), _build.int_array(in_dims),
            _build.int_array(out_dims), L, _skip_mask(cfg), cfg.multires,
            cfg.multires_view, bf, alpha.data_ptr(), rgb.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rnb_nerf_fwd")
    _build.launches["nerf_fwd"] += 1
    return alpha, rgb


def nerf_bwd(cfg: NeRFConfig, pts, views, ws, bs, c_alpha, c_rgb,
             dtype=torch.bfloat16):
    """Backward kernel (``rnb_nerf_bwd``: sweep + dW/db reduction) for CUDA
    tensors, plain version for CPU tensors. -> (dws, dbs)."""
    if not pts.is_cuda:
        return nerf_bwd_plain(cfg, pts, views, ws, bs, c_alpha, c_rgb, dtype)
    _check_args(cfg, pts, views, ws, bs)
    bf = _build.bf16_flag(dtype)
    lib = _build.library()
    pts, views = (t.detach().contiguous() for t in (pts, views))
    n, L, dev, D = pts.shape[0], len(ws), pts.device, cfg.D
    wflat, wtflat, bflat, in_dims, out_dims = _build.flat_params(ws, bs, dtype)
    c_alpha, c_rgb = (t.detach().float().contiguous() for t in (c_alpha, c_rgb))
    if c_alpha.shape != (n, out_dims[D]) or c_rgb.shape != (n, out_dims[-1]):
        raise ValueError("nerf backward: cotangent shapes do not match")
    # ReLU pre-activations of the trunk layers and of the views layer
    rec_ld = max(out_dims[:D] + [out_dims[D + 2]])
    rec = torch.empty((D + 1) * n * rec_ld, device=dev)
    abuf = torch.empty(n * sum(in_dims), device=dev)
    bbuf = torch.empty(n * sum(out_dims), device=dev)
    splits = _build.splits_for(max(in_dims), max(out_dims), n)
    partial = torch.empty(splits * max(i * o for i, o in zip(in_dims, out_dims)),
                          device=dev)
    dw = torch.empty(wflat.numel(), device=dev)
    db = torch.empty(bflat.numel(), device=dev)
    with torch.cuda.device(dev):
        rc = lib.rnb_nerf_bwd(
            pts.data_ptr(), views.data_ptr(), n, pts.shape[1],
            wflat.data_ptr(), wtflat.data_ptr(), bflat.data_ptr(),
            _build.int_array(in_dims), _build.int_array(out_dims), L,
            _skip_mask(cfg), cfg.multires, cfg.multires_view, bf,
            c_alpha.data_ptr(), c_rgb.data_ptr(), rec.data_ptr(), rec_ld,
            abuf.data_ptr(), bbuf.data_ptr(), partial.data_ptr(), splits,
            dw.data_ptr(), db.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rnb_nerf_bwd")
    _build.launches["nerf_bwd"] += 1
    return (_build.unflat(dw, [tuple(w.shape) for w in ws]),
            _build.unflat(db, [tuple(b.shape) for b in bs]))


class _NeRF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, dtype, pts, views, *wb):
        L = len(wb) // 2
        ctx.cfg, ctx.dtype = cfg, dtype
        ctx.save_for_backward(pts, views, *wb)
        return nerf_fwd(cfg, pts, views, wb[:L], wb[L:], dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, c_alpha, c_rgb):
        pts, views, *wb = ctx.saved_tensors
        L = len(wb) // 2
        dws, dbs = nerf_bwd(ctx.cfg, pts, views, wb[:L], wb[L:], c_alpha,
                            c_rgb, ctx.dtype)
        return (None, None, None, None, *dws, *dbs)


def nerf_apply_fused(cfg: NeRFConfig, params, pts, views,
                     dtype=torch.bfloat16):
    """Drop-in for ``fields.nerf_apply``: ([N,d_in], [N,3]) ->
    (density_raw [N,1], rgb_raw [N,3]), differentiable w.r.t. params in one
    fused reverse pass."""
    ws, bs = flatten_params(params)
    return _NeRF.apply(cfg, dtype, pts, views, *ws, *bs)
