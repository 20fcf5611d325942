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

``sdf_core_fwd`` / ``sdf_core_bwd`` launch the kernels for a CUDA tensor (or
raise) and run the plain PyTorch version, ``*_plain``, for a CPU tensor. On
the card the op dtype picks one of two routes, never by failure: bf16 (the
training step's) runs the tensor-core kernels (wgmma; weights as a padded
bf16 image, ``pack_weights`` / ``wg_layout``), f32 the CUDA-core kernels.
The no-grad up-sampling sweeps have an op of their own beside it,
``sdf_value_fused``: the same forward kernel in its value-only mode
(``sdf_fwd_wg_kernel<SDF_VALUE>``: the primal chain and the head's sdf
column, bf16 operands, no record, feature or gradient) on weights folded
and packed once an up-sampling call (``value_weights``); its plain version
``sdf_value_plain`` runs for CPU tensors.

Spans (``utils/trace.py``): ``sdf_core.pack``, ``sdf_core.fwd``,
``sdf_core.bwd`` and its ``sdf_core.dw``, ``sdf_core.value``, and
``fields.fold`` around the weight-norm fold.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence

import torch
from torch.autograd.function import once_differentiable

from rnb_tpu_torch.models.fields import SDFConfig, fold_weight_norm, round_to
from rnb_tpu_torch.ops import _build, wg
from rnb_tpu_torch.utils import trace


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


def _primal_plain(cfg: SDFConfig, e16, w16, bs, dtype):
    """The primal chain up to the head: (the head's input, rounded to
    ``dtype``, the hidden layers' biased pre-activations)."""
    L, c16 = len(w16), _c16(dtype)
    h, recs = e16, []
    for l in range(L):
        if l in cfg.skip_in:
            h = round_to(torch.cat([h, e16], dim=-1) * c16, dtype)
        if l == L - 1:
            return h, recs
        recs.append(h @ w16[l] + bs[l])
        h = round_to(_softplus100_pair(recs[-1])[1], dtype)


def sdf_core_fwd_plain(cfg: SDFConfig, pts, ws: Sequence[torch.Tensor],
                       bs: Sequence[torch.Tensor], dtype=torch.bfloat16):
    """[N,3] -> (sdf [N], feat [N,d_out-1], grad [N,3]), the forward
    kernel's algorithm on whole tensors."""
    L = len(ws)
    w16 = [round_to(w, dtype) for w in ws]
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    e, tc = _pe_parts(cfg, pts)
    h, recs = _primal_plain(cfg, round_to(e, dtype), w16, bs, dtype)
    z8 = h @ w16[L - 1] + bs[L - 1]
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


def sdf_value_plain(cfg: SDFConfig, pts, ws, bs, dtype=torch.bfloat16):
    """[N,3] -> sdf [N], the value kernel's algorithm on whole tensors: the
    forward's primal chain, the head cut to its sdf column."""
    w16 = [round_to(w, dtype) for w in ws[:-1]]
    w16.append(round_to(ws[-1][:, :1], dtype))
    e, _ = _pe_parts(cfg, pts)
    h, _ = _primal_plain(cfg, round_to(e, dtype), w16, bs, dtype)
    return (h @ w16[-1] + bs[-1][:1])[:, 0] / cfg.scale


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


@trace.spanned("sdf_core.fwd")
def sdf_core_fwd(cfg: SDFConfig, pts, ws, bs, dtype=torch.bfloat16,
                 packed=None):
    """Forward kernel for a CUDA tensor, plain version for a CPU tensor.
    The op dtype names the route: bf16 launches the tensor-core kernel
    (``rnb_sdf_fwd_wg``) on ``packed`` (``wg_pack``; packed here when None),
    f32 the CUDA-core kernel (``rnb_sdf_fwd``)."""
    if not pts.is_cuda:
        return sdf_core_fwd_plain(cfg, pts, ws, bs, dtype)
    if _build.bf16_flag(dtype):
        out = launch_fwd_wg(cfg, pts, ws, bs, packed=packed)
        _build.launches["sdf_core_fwd"] += 1
    else:
        out = launch_fwd(cfg, pts, ws, bs)
        _build.launches["sdf_core_fwd_f32"] += 1
    return out


def launch_fwd(cfg: SDFConfig, pts, ws, bs, entry="rnb_sdf_fwd", lead=()):
    """f32 route: check the CUDA tensors, allocate the outputs and the
    pre-activation record, and launch the C entry ``entry`` with the
    arguments ``lead`` followed by ``rnb_sdf_fwd``'s. -> (sdf, feat, grad)."""
    _check_args(cfg, pts, ws, bs)
    dtype = torch.float32
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
            cfg.multires, cfg.scale, _c16(dtype), rec.data_ptr(), rec_ld,
            sdf.data_ptr(), feat.data_ptr(), grad.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, entry)
    return sdf, feat, grad


# ---------------------------------------------------------------------------
# the bf16 route's operand layout (csrc/sdf_core.cu, "bf16 route"; the
# shared pieces in ops/wg.py)
# ---------------------------------------------------------------------------

TILE, pack_weights = wg.TILE, wg.pack_weights
dw_gemm_plain = wg.dw_gemm_plain
# the SDF core's dW products count under sdf_dw_gemm
dw_gemm = functools.partial(wg.dw_gemm, counter="sdf_dw_gemm")


def wg_layout(cfg: SDFConfig, ws, n: int = 0) -> dict:
    """Shapes and offsets the tensor-core kernels take, per layer l:
    ``hd[l]`` the input column where the skip layer's e starts (in_l for a
    layer without skip), ``w_off[l]`` the bf16 weight image's tile
    ([pad16(in), pad16(out)]), ``a_off[l]`` / ``bb_off[l]`` the layer's A rows
    ([2n, pad16(in)]) and B rows ([2n, pad16(out)]) in the bf16 dW scratch."""
    in_dims = [int(w.shape[0]) for w in ws]
    out_dims = [int(w.shape[1]) for w in ws]
    L, E = len(ws), in_dims[0]
    skip = [int(l in cfg.skip_in) for l in range(L)]
    hd = [i - E if s else i for i, s in zip(in_dims, skip)]
    return dict(wg.offsets(in_dims, out_dims, 2 * n), skip=skip, hd=hd)


# The backward sweep's weight ring (csrc/sdf_core.cu: sdf_sweep_params
# encodes the maps, SwCursor walks the stages): layer l's tile of the weight
# image is a 3-D TMA tensor map of its 8x8 cores, dims (64 core elements,
# npc output cores, kpc input cores) innermost first; a ring stage (8 KB)
# is one box of it, a K-step of 16: the forward's K-step t two rows of
# input cores at (0, 0, 2t), the reverse's (the Wᵀ read) two columns of
# output cores at (0, 2t, 0). Boxes past the layer's width read zeros.
SWEEP_BOX = {"fwd": (64, 32, 2), "rev": (64, 2, 32)}


def sweep_map(lay: dict, l: int):
    """Layer l's tensor map as the sweep encodes it: (dims innermost first,
    byte strides of dims 1 and 2)."""
    npc, kpc = lay["np"][l] // 8, lay["kp"][l] // 8
    return (64, npc, kpc), (128, npc * 128)


def sweep_steps(lay: dict) -> list:
    """The ring's stages in the order the sweep's products take them, as
    (kind, layer, box coordinates): one product a layer (both slabs read
    each stage), the forward layers 0..L-2 over pad16(in)/16 K-steps, then
    the reverse layers L-1..1 over pad16(out)/16."""
    L, steps = len(lay["in_dims"]), []
    for l in range(L - 1):
        steps += [("fwd", l, (0, 0, 2 * t)) for t in range(lay["kp"][l] // 16)]
    for l in range(L - 1, 0, -1):
        steps += [("rev", l, (0, 2 * t, 0)) for t in range(lay["np"][l] // 16)]
    return steps


def _check_wg(lay: dict):
    L, ins, outs = len(lay["in_dims"]), lay["in_dims"], lay["out_dims"]
    if (L < 2 or ins[0] > 48 or lay["skip"][-1] or max(ins) > 256
            or max(outs[:-1]) > 256 or outs[-1] > 264):
        raise ValueError(
            "the bf16 sdf core kernels take 2-16 layers, <= 48 PE channels, "
            "inputs and hidden outputs <= 256 wide, a last layer <= 264 wide "
            f"and no skip at the last layer; got in {ins}, out {outs}")


@trace.spanned("sdf_core.pack")
def wg_pack(cfg: SDFConfig, ws, bs):
    """The bf16 route's weights: (the bf16 weight image of ``wg_layout``,
    the biases flat), packed once a forward-plus-backward by ``_SDFCore``
    for both kernels."""
    image = wg.pack_weights(ws, wg_layout(cfg, ws))
    return image, torch.cat([b.detach().reshape(-1) for b in bs]).contiguous()


# The forward's weight ring (csrc/sdf_core.cu: sdf_fwd_params encodes the
# maps, SfCursor walks the stages): the same tensor maps as the backward
# sweep's (sweep_map), one box a K-step, in the forward at N = 256 (33
# output cores at the head: its column 256), in the reverse at N = 256 (6
# input cores at layer 0: its 48 PE channels).
# A stage slot holds the largest box (8,448 B); two 64-point tiles a block
# (wg.pair_blocks) take every stage, each on its own A tile and PE area.
FWD_STAGE_BYTES, FWD_PE_BYTES, FWD_BIAS = 8448, 12288, 272


def fwd_box(lay: dict, kind: str, l: int) -> tuple:
    """The box of layer l's ``kind`` ("fwd" or "rev") stages: 33 output
    cores at the head (its N = 8 product reads core 32), 6 input cores in
    layer 0's reverse."""
    if kind == "fwd":
        return (64, 33 if l == len(lay["in_dims"]) - 1 else 32, 2)
    return (64, 2, 6 if l == 0 else 32)


def fwd_steps(lay: dict, primal_only: bool = False) -> list:
    """The forward's ring stages in the order its products take them, as
    (kind, layer, box coordinates): layers 0..L-1 forward over
    pad16(in)/16 K-steps, then (but in the primal-only ablation) layers
    L-2..0 reverse over pad16(out)/16; both tiles of a block read each."""
    L, steps = len(lay["in_dims"]), []
    for l in range(L):
        steps += [("fwd", l, (0, 0, 2 * t)) for t in range(lay["kp"][l] // 16)]
    if not primal_only:
        for l in range(L - 2, -1, -1):
            steps += [("rev", l, (0, 2 * t, 0)) for t in range(lay["np"][l] // 16)]
    return steps


def fwd_smem_bytes(depth: int = wg.FWD_RING_DEPTH) -> int:
    """The forward's shared memory at ring ``depth`` (sf_smem_bytes): two A
    tiles of 64 x 256 bf16, ``depth`` stages, two PE areas, the ring's
    full and empty barriers, the two consumers' turn barriers, a bias area
    of 272 floats a tile and the reverse seed's 256."""
    return (2 * TILE * 256 * 2 + depth * FWD_STAGE_BYTES + 2 * FWD_PE_BYTES
            + (2 * depth + 2) * 8 + (2 * FWD_BIAS + 256) * 4)


# the forward's timing split (the tune library's rnb_sdf_fwd_wg_split;
# index = its split): the production kernel, then without the record's
# traffic, the softplus arithmetic, everything but the weight ring and its
# barriers, and both the record and the arithmetic
FWD_SPLIT = ("full", "no_record", "no_epilogue", "k_loops_only",
             "products_only")

# two of the C SdfModes (csrc/sdf_core.cu): the ablation's primal-only
# forward and the value-only forward of the no-grad sweeps
SDF_PRIMAL_ONLY, SDF_VALUE = 3, 4


def launch_fwd_wg(cfg: SDFConfig, pts, ws, bs, mode: int = 0,
                  depth: int | None = None, packed=None,
                  split: str | None = None):
    """bf16 route: launch ``rnb_sdf_fwd_wg`` (``mode``: the C SdfMode, 0 =
    the production kernel), or one of the tune library's forwards: at ring
    ``depth`` (``rnb_sdf_fwd_wg_tune``; a depth it was not built for
    raises) or the timing ``split`` (a ``FWD_SPLIT`` name,
    ``rnb_sdf_fwd_wg_split``), both mode 0; on ``packed`` (``wg_pack``;
    packed here when None). -> (sdf, feat, grad); sdf alone in
    ``SDF_VALUE``, which allocates nothing else. The record is allocated
    only for the modes that write it."""
    _check_args(cfg, pts, ws, bs)
    lay = wg_layout(cfg, ws)
    _check_wg(lay)
    if split is not None:
        entry, lead = "rnb_sdf_fwd_wg_split", FWD_SPLIT.index(split)
    elif depth is not None:
        entry, lead = "rnb_sdf_fwd_wg_tune", depth
    else:
        entry, lead = "rnb_sdf_fwd_wg", mode
    kind = "main" if entry == "rnb_sdf_fwd_wg" else "tune"
    if kind == "tune" and mode != 0:
        raise ValueError("the tune library's forward runs mode 0 only")
    lib = _build.library(kind)
    pts = pts.detach().contiguous()
    n, L = pts.shape[0], len(ws)
    dev = pts.device
    image, bflat = packed or wg_pack(cfg, ws, bs)
    tiles = -(-n // TILE)
    empty = lambda *shape: torch.empty(*shape, device=dev)
    value = mode == SDF_VALUE
    rec = (None if mode in (SDF_PRIMAL_ONLY, SDF_VALUE)
           else empty(tiles * (L - 1) * TILE * 256))
    sdf = empty(n)
    feat = None if value else empty(n, lay["out_dims"][-1] - 1)
    grad = None if value else empty(n, 3)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            lead, pts.data_ptr(), n, image.data_ptr(), bflat.data_ptr(),
            _build.int_array(lay["in_dims"]), _build.int_array(lay["out_dims"]),
            _build.int_array(lay["skip"]), _build.int_array(lay["hd"]),
            _build.ll_array(lay["w_off"]), L, cfg.multires, cfg.scale,
            _c16(torch.bfloat16), ptr(rec), sdf.data_ptr(), ptr(feat),
            ptr(grad), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, entry, kind)
    return sdf if value else (sdf, feat, grad)


def sdf_fwd_split(split: str, cfg: SDFConfig, pts, ws, bs, packed=None):
    """One launch of the forward's timing split ``split`` (a ``FWD_SPLIT``
    name) from the tune library, CUDA tensors only; counts under
    ``sdf_fwd_split``. Its numerics are wrong by design but for ``full``.
    -> (sdf, feat, grad)."""
    if split not in FWD_SPLIT:
        raise ValueError(f"split must be one of {FWD_SPLIT}, got {split!r}")
    out = launch_fwd_wg(cfg, pts, ws, bs, packed=packed, split=split)
    _build.launches["sdf_fwd_split"] += 1
    return out


@trace.spanned("sdf_core.bwd")
def sdf_core_bwd(cfg: SDFConfig, pts, ws, bs, c_sdf, c_feat, c_grad,
                 dtype=torch.bfloat16, packed=None):
    """Backward kernels for a CUDA tensor, plain version for a CPU tensor.
    -> (dws, dbs). bf16: the tensor-core sweep (``rnb_sdf_bwd_wg``) on
    ``packed`` (as for ``sdf_core_fwd``) and one ``wg.dw_products`` launch
    over the layers; f32: the CUDA-core sweep and split-K reduction
    (``rnb_sdf_bwd``)."""
    if not pts.is_cuda:
        return sdf_core_bwd_plain(cfg, pts, ws, bs, c_sdf, c_feat, c_grad,
                                  dtype)
    if _build.bf16_flag(dtype):
        out = _bwd_wg(cfg, pts, ws, bs, c_sdf, c_feat, c_grad, packed=packed)
        _build.launches["sdf_core_bwd"] += 1
    else:
        out = _bwd_f32(cfg, pts, ws, bs, c_sdf, c_feat, c_grad)
        _build.launches["sdf_core_bwd_f32"] += 1
    return out


def _cotangents(pts, c_sdf, c_feat, c_grad, d_feat):
    n = pts.shape[0]
    cots = [t.detach().float().contiguous() for t in (c_sdf, c_feat, c_grad)]
    if (cots[0].shape != (n,) or cots[1].shape != (n, d_feat)
            or cots[2].shape != (n, 3)):
        raise ValueError("sdf core backward: cotangent shapes do not match")
    return cots


# the backward sweep's timing split (the tune library's
# rnb_sdf_bwd_wg_split; index = its mode): the production sweep, then
# without the record's traffic, the epilogue's arithmetic, the dW operand
# rows, and all three
BWD_SPLIT = ("full", "no_record", "no_epilogue", "no_rows", "products_only")


def bwd_sweep(cfg, pts, ws, bs, c_sdf, c_feat, c_grad, packed=None,
              depth=None, split=None):
    """The bf16 backward sweep alone (CUDA tensors): ``rnb_sdf_bwd_wg``, or
    the tune library's ``rnb_sdf_bwd_wg_tune`` at ring ``depth`` or
    ``rnb_sdf_bwd_wg_split`` in mode ``split`` (a ``BWD_SPLIT`` name).
    -> (abuf, bbuf, db, lay): the bf16 dW operand rows of ``wg_layout(cfg,
    ws, n)`` and db flat."""
    _check_args(cfg, pts, ws, bs)
    pts = pts.detach().contiguous()
    n, L = pts.shape[0], len(ws)
    lay = wg_layout(cfg, ws, n)
    _check_wg(lay)
    kind = "main" if depth is None and split is None else "tune"
    lib = _build.library(kind)
    cots = _cotangents(pts, c_sdf, c_feat, c_grad, lay["out_dims"][-1] - 1)
    dev = pts.device
    image, bflat = packed or wg_pack(cfg, ws, bs)
    tiles = -(-n // TILE)
    rec_z = torch.empty(tiles * (L - 1) * TILE * 256, device=dev)
    rec_t = torch.empty_like(rec_z)
    abuf = torch.empty(lay["a_len"], dtype=torch.bfloat16, device=dev)
    bbuf = torch.empty(lay["b_len"], dtype=torch.bfloat16, device=dev)
    dbp = torch.empty(tiles * bflat.numel(), device=dev)
    db = torch.empty(bflat.numel(), device=dev)
    if split is not None:
        entry, lead = "rnb_sdf_bwd_wg_split", (BWD_SPLIT.index(split),)
    elif depth is not None:
        entry, lead = "rnb_sdf_bwd_wg_tune", (depth,)
    else:
        entry, lead = "rnb_sdf_bwd_wg", ()
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            *lead, pts.data_ptr(), n, image.data_ptr(), bflat.data_ptr(),
            _build.int_array(lay["in_dims"]), _build.int_array(lay["out_dims"]),
            _build.int_array(lay["skip"]), _build.int_array(lay["hd"]),
            _build.ll_array(lay["w_off"]), _build.ll_array(lay["a_off"]),
            _build.ll_array(lay["bb_off"]), L, cfg.multires, cfg.scale,
            _c16(torch.bfloat16), cots[0].data_ptr(), cots[1].data_ptr(),
            cots[2].data_ptr(), rec_z.data_ptr(), rec_t.data_ptr(),
            abuf.data_ptr(), bbuf.data_ptr(), dbp.data_ptr(), db.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, entry, kind)
    return abuf, bbuf, db, lay


def _bwd_wg(cfg, pts, ws, bs, c_sdf, c_feat, c_grad, depth=None,
            packed=None):
    abuf, bbuf, db, lay = bwd_sweep(cfg, pts, ws, bs, c_sdf, c_feat, c_grad,
                                    packed, depth)
    with trace.span("sdf_core.dw"):
        dws = wg.dw_products(abuf, bbuf, lay, 2 * pts.shape[0], "sdf_dw_gemm")
    return dws, _build.unflat(db, [tuple(b.shape) for b in bs])


def sdf_bwd_split(split: str, cfg, pts, ws, bs, c_sdf, c_feat, c_grad,
                  packed=None):
    """One launch of the backward sweep's timing split ``split`` (a
    ``BWD_SPLIT`` name) from the tune library, CUDA tensors only; counts
    under ``sdf_bwd_split``. Its numerics are wrong by design but for
    ``full``. -> (abuf, bbuf, db, lay) as ``bwd_sweep``."""
    if split not in BWD_SPLIT:
        raise ValueError(f"split must be one of {BWD_SPLIT}, got {split!r}")
    out = bwd_sweep(cfg, pts, ws, bs, c_sdf, c_feat, c_grad, packed,
                    split=split)
    _build.launches["sdf_bwd_split"] += 1
    return out


def _bwd_f32(cfg, pts, ws, bs, c_sdf, c_feat, c_grad):
    _check_args(cfg, pts, ws, bs)
    lib = _build.library()
    pts = pts.detach().contiguous()
    n, L = pts.shape[0], len(ws)
    dtype = torch.float32
    wflat, wtflat, bflat, in_dims, out_dims = _build.flat_params(ws, bs, dtype)
    cots = _cotangents(pts, c_sdf, c_feat, c_grad, out_dims[-1] - 1)
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
            cfg.multires, cfg.scale, _c16(dtype), cots[0].data_ptr(),
            cots[1].data_ptr(), cots[2].data_ptr(), rec_z.data_ptr(),
            rec_t.data_ptr(), rec_ld, abuf.data_ptr(), bbuf.data_ptr(),
            partial.data_ptr(), splits, dw.data_ptr(), db.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rnb_sdf_bwd")
    return (_build.unflat(dw, [tuple(w.shape) for w in ws]),
            _build.unflat(db, [tuple(b.shape) for b in bs]))


def sdf_core_fwd_tune(cfg: SDFConfig, pts, ws, bs, depth: int):
    """The bf16 forward at ring depth ``depth``, from the tune library (the
    tile sweep's; CUDA tensors only). Counts under
    ``sdf_core_fwd_rs{depth}``."""
    out = launch_fwd_wg(cfg, pts, ws, bs, depth=depth)
    _build.launches[f"sdf_core_fwd_rs{depth}"] += 1
    return out


def sdf_core_bwd_tune(cfg: SDFConfig, pts, ws, bs, c_sdf, c_feat, c_grad,
                      depth: int):
    """The bf16 backward sweep at ring depth ``depth``, from the tune
    library, then the production dW products. Counts under
    ``sdf_core_bwd_rs{depth}``. -> (dws, dbs)."""
    out = _bwd_wg(cfg, pts, ws, bs, c_sdf, c_feat, c_grad, depth)
    _build.launches[f"sdf_core_bwd_rs{depth}"] += 1
    return out


class _SDFCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, dtype, pts, *wb):
        L = len(wb) // 2
        ctx.cfg, ctx.dtype = cfg, dtype
        # the bf16 route's weight image, packed once for both kernels
        ctx.packed = (wg_pack(cfg, wb[:L], wb[L:])
                      if dtype == torch.bfloat16 else None)
        ctx.save_for_backward(pts, *wb)
        return sdf_core_fwd(cfg, pts, wb[:L], wb[L:], dtype, ctx.packed)

    @staticmethod
    @once_differentiable
    def backward(ctx, c_sdf, c_feat, c_grad):
        pts, *wb = ctx.saved_tensors
        L = len(wb) // 2
        dws, dbs = sdf_core_bwd(ctx.cfg, pts, wb[:L], wb[L:], c_sdf, c_feat,
                                c_grad, ctx.dtype, ctx.packed)
        return (None, None, None, *dws, *dbs)


def sdf_value_feat_grad_fused(cfg: SDFConfig, params, pts,
                              dtype=torch.bfloat16):
    """[N,3] -> (sdf [N], feat [N,F], grad [N,3]), differentiable w.r.t.
    params (weight norm folded outside the kernel, so autograd carries dW
    back to {v, g}) in one reverse pass."""
    with trace.span("fields.fold"):
        ws = [fold_weight_norm(layer) for layer in params]
    bs = [layer["b"] for layer in params]
    return _SDFCore.apply(cfg, dtype, pts, *ws, *bs)


# ---------------------------------------------------------------------------
# the value-only op of the no-grad up-sampling sweeps
# ---------------------------------------------------------------------------

def value_weights(cfg: SDFConfig, params):
    """(ws, bs, packed) for ``sdf_value_fused``: the folded weights, and on
    the card their bf16 image (``wg_pack``; None on the CPU). Made once for
    the sweeps of one up-sampling call."""
    with trace.span("fields.fold"):
        ws = [fold_weight_norm(layer).detach() for layer in params]
    bs = [layer["b"].detach() for layer in params]
    return ws, bs, wg_pack(cfg, ws, bs) if ws[0].is_cuda else None


@trace.spanned("sdf_core.value")
def sdf_value_fused(cfg: SDFConfig, params, pts, weights=None):
    """[N,3] -> sdf [N], no gradient: the value-only forward
    (``sdf_fwd_wg_kernel<SDF_VALUE>``, bf16 operands, f32 sums) for a CUDA
    tensor, its plain version for a CPU tensor; on ``weights``
    (``value_weights``; made here when None). Counts under
    ``sdf_value_wg``."""
    ws, bs, packed = weights or value_weights(cfg, params)
    if not pts.is_cuda:
        return sdf_value_plain(cfg, pts, ws, bs)
    sdf = launch_fwd_wg(cfg, pts, ws, bs, SDF_VALUE, packed=packed)
    _build.launches["sdf_value_wg"] += 1
    return sdf
