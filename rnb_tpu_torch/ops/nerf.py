"""The fused background NeRF (NeRF++ inverted-sphere net) with a
hand-derived VJP over the parameters, as a ``torch.autograd.Function``
around a CUDA kernel pair.

Replaces ``rnb_tpu/ops/pallas_nerf.py`` (``_fwd_kernel`` :105,
``_bwd_kernel`` :122); the kernels are in ``csrc/nerf.cu``, whose notes
say what bounds them on the H100. Forward and backward have two routes by
op dtype: bf16 (the training step's) on the tensor cores
(``nerf_fwd_wg_kernel``; ``nerf_bwd_wg_kernel`` + ``wg.dw_products``), both
over the image layers of ``wg_weights`` in one bf16 weight image that the
op packs once a forward-plus-backward (``wg_pack``); f32 on the CUDA cores.

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
from rnb_tpu_torch.ops import _build, wg
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


def nerf_fwd(cfg: NeRFConfig, pts, views, ws, bs, dtype=torch.bfloat16,
             packed=None):
    """Forward kernel for CUDA tensors, plain version for CPU tensors.
    -> (alpha_raw [N,1], rgb_raw [N,3]). The op dtype names the route, never
    a failure: bf16 launches the tensor-core kernel (``rnb_nerf_fwd_wg``) on
    ``packed`` (``wg_pack``; packed here when None), f32 the CUDA-core
    kernel (``rnb_nerf_fwd``)."""
    if not pts.is_cuda:
        return nerf_fwd_plain(cfg, pts, views, ws, bs, dtype)
    if _build.bf16_flag(dtype):
        out = fwd_wg(cfg, pts, views, ws, bs, packed)
        _build.launches["nerf_fwd"] += 1
    else:
        out = _fwd_f32(cfg, pts, views, ws, bs)
        _build.launches["nerf_fwd_f32"] += 1
    return out


def _fwd_f32(cfg, pts, views, ws, bs):
    _check_args(cfg, pts, views, ws, bs)
    lib = _build.library()
    pts, views = (t.detach().contiguous() for t in (pts, views))
    n, L, dev = pts.shape[0], len(ws), pts.device
    wflat, _, bflat, in_dims, out_dims = _build.flat_params(ws, bs,
                                                            torch.float32)
    alpha = torch.empty(n, out_dims[cfg.D], device=dev)
    rgb = torch.empty(n, out_dims[-1], device=dev)
    with torch.cuda.device(dev):
        rc = lib.rnb_nerf_fwd(
            pts.data_ptr(), views.data_ptr(), n, pts.shape[1],
            wflat.data_ptr(), bflat.data_ptr(), _build.int_array(in_dims),
            _build.int_array(out_dims), L, _skip_mask(cfg), cfg.multires,
            cfg.multires_view, alpha.data_ptr(), rgb.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rnb_nerf_fwd")
    return alpha, rgb


def nerf_bwd(cfg: NeRFConfig, pts, views, ws, bs, c_alpha, c_rgb,
             dtype=torch.bfloat16, packed=None):
    """Backward kernels for CUDA tensors, plain version for CPU tensors.
    -> (dws, dbs). The op dtype names the route, never a failure: bf16 runs
    the tensor-core sweep (``rnb_nerf_bwd_wg``) on ``packed`` (as for
    ``nerf_fwd``) and one ``wg.dw_products`` launch over the image layers,
    f32 the CUDA-core sweep and split-K reduction (``rnb_nerf_bwd``)."""
    if not pts.is_cuda:
        return nerf_bwd_plain(cfg, pts, views, ws, bs, c_alpha, c_rgb, dtype)
    if _build.bf16_flag(dtype):
        out = _bwd_wg(cfg, pts, views, ws, bs, c_alpha, c_rgb, packed)
        _build.launches["nerf_bwd"] += 1
    else:
        out = _bwd_f32(cfg, pts, views, ws, bs, c_alpha, c_rgb)
        _build.launches["nerf_bwd_f32"] += 1
    return out


def _cotangents(c_alpha, c_rgb, n, oa, orr):
    c_alpha, c_rgb = (t.detach().float().contiguous() for t in (c_alpha, c_rgb))
    if c_alpha.shape != (n, oa) or c_rgb.shape != (n, orr):
        raise ValueError("nerf backward: cotangent shapes do not match")
    return c_alpha, c_rgb


# ---------------------------------------------------------------------------
# the bf16 route's image layers (csrc/nerf.cu, "bf16 route")
# ---------------------------------------------------------------------------

def _skip_input(cfg: NeRFConfig, i: int) -> bool:
    """Trunk layer i takes the skip concat [e, h] as its input."""
    return i < cfg.D and i - 1 in cfg.skips


def wg_weights(cfg: NeRFConfig, ws, bs):
    """The image layers of the tensor-core kernel, as (ws, bs): the trunk
    with a skip layer's rows [e; h] held as [h; e], the fused head
    [W_f | W_a] (bias [b_f, b_a]), the views and rgb layers."""
    D, E = cfg.D, ws[0].shape[0]
    iw = [torch.cat([w[E:], w[:E]]) if _skip_input(cfg, i) else w
          for i, w in enumerate(ws[:D])]
    iw += [torch.cat([ws[D + 1], ws[D]], dim=1), ws[D + 2], ws[D + 3]]
    ib = list(bs[:D]) + [torch.cat([bs[D + 1], bs[D]]), bs[D + 2], bs[D + 3]]
    return iw, ib


def from_image(cfg: NeRFConfig, dws, dbs, E: int, of: int):
    """The image layers' (dW, db) -> the 12 layers' in the kernels' order:
    a skip layer's rows back to [e; h], the fused head split into alpha
    and feature."""
    D = cfg.D
    out_w = [torch.cat([d[d.shape[0] - E:], d[:d.shape[0] - E]])
             if _skip_input(cfg, i) else d for i, d in enumerate(dws[:D])]
    out_w += [dws[D][:, of:], dws[D][:, :of], dws[D + 1], dws[D + 2]]
    out_b = list(dbs[:D]) + [dbs[D][of:], dbs[D][:of], dbs[D + 1], dbs[D + 2]]
    return out_w, out_b


def wg_layout(cfg: NeRFConfig, ws, n: int = 0) -> dict:
    """Shapes and offsets of the image layers (``wg.offsets``, n rows a
    layer), with ``skip[l]`` (trunk layer l takes [h, e]), ``E`` the PE
    width and ``of`` the feature head's width (the fused head's alpha
    columns start there)."""
    D = cfg.D
    ins = [w.shape[0] for w in ws[:D]] + [ws[D].shape[0], ws[D + 2].shape[0],
                                          ws[D + 3].shape[0]]
    outs = [w.shape[1] for w in ws[:D]] + [ws[D + 1].shape[1] + ws[D].shape[1],
                                           ws[D + 2].shape[1], ws[D + 3].shape[1]]
    return dict(wg.offsets(ins, outs, n),
                skip=[int(_skip_input(cfg, i)) for i in range(D + 3)],
                E=int(ws[0].shape[0]), of=int(ws[D + 1].shape[1]))


def _check_wg(cfg: NeRFConfig, lay: dict):
    D, ins, outs, kp = cfg.D, lay["in_dims"], lay["out_dims"], lay["kp"]
    if (lay["E"] > 96 or max(kp[:D]) > 352 or set(outs[:D]) != {256}
            or lay["of"] != 256 or outs[D] > 264 or kp[D + 1] > 352
            or outs[D + 1] > 128 or outs[D + 2] > 8
            or 3 * (1 + 2 * cfg.multires_view) > 32):
        raise ValueError(
            "the bf16 nerf kernels take a PE <= 96 wide, trunk layers and a "
            "feature head of exactly 256 (skip inputs <= 352 after padding), "
            "an alpha head <= 8 wide, a views PE <= 32, a views layer "
            f"<= 128 wide and an rgb head <= 8 wide; got in {ins}, out {outs}")


def wg_pack(cfg: NeRFConfig, ws, bs):
    """The bf16 route's weights: (the bf16 image of the image layers of
    ``wg_weights`` at ``wg_layout``'s offsets, their biases flat in image
    order). The op builds them once a forward-plus-backward; both kernels
    read them."""
    iw, ib = wg_weights(cfg, [w.detach() for w in ws], [b.detach() for b in bs])
    image = wg.pack_weights(iw, wg_layout(cfg, ws))
    return image, torch.cat([b.reshape(-1) for b in ib]).contiguous()


# The backward sweep's ring (csrc/nerf.cu nerf_bwd_params; csrc/wg_sweep.cuh
# WbCursor walks it): each phase one product of a layer's tile of the weight
# image, a 3-D TMA box a K-step, as (kind, image layer, box, c2): the trunk
# and the feature head forward at N = 256 (32 output cores), the views layer
# forward at N = 128 (16); the rgb head reverse at N = 128 (16 input cores),
# the views layer reverse over its feature rows (32), the fused head's and
# the trunk's reverse over their h rows (32). One block a pair of 64-point
# tiles (wg.pair_blocks); each tile's area: the A tile [64][384] bf16 (six
# swizzled blocks of 64 columns: the 352-wide skip input), the nine ReLU
# masks (a uint4 a thread), the column sums [4][256] and the bias, f32.
BWD_TILE_BYTES = 64 * 384 * 2 + 9 * 128 * 16 + 4 * 256 * 4 + 256 * 4


def bwd_phases(lay: dict) -> list:
    """The backward sweep's phase table, in the products' order."""
    D = len(lay["in_dims"]) - 3
    ph = [("fwd", l, (64, 32, 2), 0) for l in range(D + 1)]
    ph += [("fwd", D + 1, (64, 16, 2), 0), ("rev", D + 2, (64, 2, 16), 0)]
    ph += [("rev", l, (64, 2, 32), 0) for l in range(D + 1, 0, -1)]
    return ph


def bwd_steps(lay: dict) -> list:
    """The backward sweep's ring stages in the order its products take
    them: (kind, image layer, box, coordinates); both tiles of a block
    read each."""
    return wg.phase_steps(lay, bwd_phases(lay))


def bwd_smem_bytes(depth: int = wg.NERF_BWD_RING_DEPTH) -> int:
    """The backward sweep's shared memory at ring ``depth``."""
    return wg.ring_smem_bytes(depth, BWD_TILE_BYTES)


# The forward's ring (csrc/nerf.cu nerf_fwd_params; csrc/wg_sweep.cuh
# WbCursor walks it), as (kind, image layer, box, c2): the trunk forward at
# N = 256 (32 output cores); the fused head's every output core, 34 at the
# shipped conf (its feature block's N = 256 product reads the first 32,
# its alpha column's N = 8 product core of / 8), in slots of
# FWD_STAGE_BYTES; the views layer at N = 128 (16); the rgb head at N = 8
# (2 cores, its product reads the first). One block a pair of 64-point
# tiles (wg.pair_blocks); each tile's area: the A tile [64][384] bf16 and
# the bias, f32.
FWD_STAGE_BYTES = 2 * 34 * 128
FWD_TILE_BYTES = 64 * 384 * 2 + 256 * 4


def fwd_phases(lay: dict) -> list:
    """The forward's phase table, in the products' order."""
    D = len(lay["in_dims"]) - 3
    return ([("fwd", l, (64, 32, 2), 0) for l in range(D)]
            + [("fwd", D, (64, lay["np"][D] // 8, 2), 0),
               ("fwd", D + 1, (64, 16, 2), 0), ("fwd", D + 2, (64, 2, 2), 0)])


def fwd_steps(lay: dict) -> list:
    """The forward's ring stages in the order its products take them:
    (kind, image layer, box, coordinates); both tiles of a block read
    each."""
    return wg.phase_steps(lay, fwd_phases(lay))


def fwd_smem_bytes(depth: int = wg.NERF_FWD_RING_DEPTH) -> int:
    """The forward's shared memory at ring ``depth``."""
    return wg.ring_smem_bytes(depth, FWD_TILE_BYTES, FWD_STAGE_BYTES)


def fwd_wg(cfg, pts, views, ws, bs, packed=None, tune=None):
    """The bf16 forward kernel alone (CUDA tensors): ``rnb_nerf_fwd_wg``, or
    the tune library's instance ``tune`` = (entry, leading arguments) that
    ``wg.fwd_tune`` names; on ``packed`` (``wg_pack``; packed here when
    None). Counts nothing. -> (alpha_raw, rgb_raw)."""
    _check_args(cfg, pts, views, ws, bs)
    pts, views = (t.detach().contiguous() for t in (pts, views))
    n, D, dev = pts.shape[0], cfg.D, pts.device
    lay = wg_layout(cfg, ws)
    _check_wg(cfg, lay)
    entry, lead = tune or ("rnb_nerf_fwd_wg", ())
    kind = "tune" if tune else "main"
    image, bflat = packed or wg_pack(cfg, ws, bs)
    alpha = torch.empty(n, ws[D].shape[1], device=dev)
    rgb = torch.empty(n, ws[-1].shape[1], device=dev)
    with torch.cuda.device(dev):
        rc = getattr(_build.library(kind), entry)(
            *lead, pts.data_ptr(), views.data_ptr(), n, pts.shape[1],
            image.data_ptr(), bflat.data_ptr(),
            _build.int_array(lay["in_dims"]), _build.int_array(lay["out_dims"]),
            _build.int_array(lay["skip"]), _build.ll_array(lay["w_off"]),
            len(lay["in_dims"]), lay["of"], cfg.multires, cfg.multires_view,
            alpha.data_ptr(), rgb.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, entry, kind)
    return alpha, rgb


def bwd_sweep(cfg, pts, views, ws, bs, c_alpha, c_rgb, packed=None,
              tune=None):
    """The bf16 backward sweep alone (CUDA tensors): ``rnb_nerf_bwd_wg``, or
    the tune library's instance ``tune`` = (entry, leading arguments) that
    ``wg.bwd_tune`` names; on ``packed`` (``wg_pack``; packed here when
    None). Counts nothing. -> (abuf, bbuf, db, lay): the bf16 dW operand
    rows of ``wg_layout(cfg, ws, n)`` and db flat, in image order."""
    _check_args(cfg, pts, views, ws, bs)
    pts, views = (t.detach().contiguous() for t in (pts, views))
    n, D, dev = pts.shape[0], cfg.D, pts.device
    lay = wg_layout(cfg, ws, n)
    _check_wg(cfg, lay)
    c_alpha, c_rgb = _cotangents(c_alpha, c_rgb, n, ws[D].shape[1],
                                 ws[-1].shape[1])
    entry, lead = tune or ("rnb_nerf_bwd_wg", ())
    kind = "tune" if tune else "main"
    lib = _build.library(kind)
    image, bflat = packed or wg_pack(cfg, ws, bs)
    abuf = torch.empty(lay["a_len"], dtype=torch.bfloat16, device=dev)
    bbuf = torch.empty(lay["b_len"], dtype=torch.bfloat16, device=dev)
    dbp = torch.empty(-(-n // wg.TILE) * bflat.numel(), device=dev)
    db = torch.empty(bflat.numel(), device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            *lead, pts.data_ptr(), views.data_ptr(), n, pts.shape[1],
            image.data_ptr(), bflat.data_ptr(),
            _build.int_array(lay["in_dims"]), _build.int_array(lay["out_dims"]),
            _build.int_array(lay["skip"]), _build.ll_array(lay["w_off"]),
            _build.ll_array(lay["a_off"]), _build.ll_array(lay["bb_off"]),
            len(lay["in_dims"]), lay["of"], cfg.multires, cfg.multires_view,
            c_alpha.data_ptr(), c_rgb.data_ptr(), abuf.data_ptr(),
            bbuf.data_ptr(), dbp.data_ptr(), db.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, entry, kind)
    return abuf, bbuf, db, lay


def _bwd_wg(cfg, pts, views, ws, bs, c_alpha, c_rgb, packed):
    abuf, bbuf, db, lay = bwd_sweep(cfg, pts, views, ws, bs, c_alpha, c_rgb,
                                    packed)
    n = pts.shape[0]
    dws = wg.dw_products(abuf, bbuf, lay, n, "nerf_dw_gemm")
    dbs = _build.unflat(db, [(o,) for o in lay["out_dims"]])
    return from_image(cfg, dws, dbs, lay["E"], lay["of"])


def _bwd_f32(cfg, pts, views, ws, bs, c_alpha, c_rgb):
    _check_args(cfg, pts, views, ws, bs)
    lib = _build.library()
    pts, views = (t.detach().contiguous() for t in (pts, views))
    n, L, dev, D = pts.shape[0], len(ws), pts.device, cfg.D
    wflat, wtflat, bflat, in_dims, out_dims = _build.flat_params(
        ws, bs, torch.float32)
    c_alpha, c_rgb = _cotangents(c_alpha, c_rgb, n, out_dims[D], out_dims[-1])
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
            _skip_mask(cfg), cfg.multires, cfg.multires_view,
            c_alpha.data_ptr(), c_rgb.data_ptr(), rec.data_ptr(), rec_ld,
            abuf.data_ptr(), bbuf.data_ptr(), partial.data_ptr(), splits,
            dw.data_ptr(), db.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rnb_nerf_bwd")
    return (_build.unflat(dw, [tuple(w.shape) for w in ws]),
            _build.unflat(db, [tuple(b.shape) for b in bs]))


class _NeRF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, dtype, pts, views, *wb):
        L = len(wb) // 2
        ctx.cfg, ctx.dtype = cfg, dtype
        # the bf16 route's weight image, packed once for both kernels
        ctx.packed = (wg_pack(cfg, wb[:L], wb[L:]) if dtype == torch.bfloat16
                      else None)
        ctx.save_for_backward(pts, views, *wb)
        return nerf_fwd(cfg, pts, views, wb[:L], wb[L:], dtype, ctx.packed)

    @staticmethod
    @once_differentiable
    def backward(ctx, c_alpha, c_rgb):
        pts, views, *wb = ctx.saved_tensors
        L = len(wb) // 2
        dws, dbs = nerf_bwd(ctx.cfg, pts, views, wb[:L], wb[L:], c_alpha,
                            c_rgb, ctx.dtype, ctx.packed)
        return (None, None, None, None, *dws, *dbs)


def nerf_apply_fused(cfg: NeRFConfig, params, pts, views,
                     dtype=torch.bfloat16):
    """Drop-in for ``fields.nerf_apply``: ([N,d_in], [N,3]) ->
    (density_raw [N,1], rgb_raw [N,3]), differentiable w.r.t. params in one
    fused reverse pass."""
    ws, bs = flatten_params(params)
    return _NeRF.apply(cfg, dtype, pts, views, *ws, *bs)
