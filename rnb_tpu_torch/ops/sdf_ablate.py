"""Ablation variants of the SDF-core forward kernel, for timing only.

Counterpart of the variants in ``tools/ablate_kernel.py`` (``make_kernel``
:62), which time stripped copies of the TPU forward kernel to split its
time. Here they are instantiations of the production CUDA kernel of the
op dtype's route (``csrc/sdf_core.cu``: ``sdf_fwd_wg_kernel<MODE>``, the
tensor-core kernel, at bf16; ``sdf_fwd_kernel<MODE>``, the CUDA-core
kernel, at f32), each stripping one part and keeping the rest:

    full         the production kernel (``sdf_core.sdf_core_fwd``'s)
    no_pe        every PE channel holds the raw first coordinate, and the
                 tangent basis is that broadcast: grad_d = Σ_c bar_e_c e_c
                 (strips the sin/cos ladder and the tangents)
    no_act       h = zb/4 instead of softplus(100 zb)/100, s = zb/2 instead
                 of sigmoid(100 zb) (strips the transcendentals only)
    primal_only  no reverse sweep and no pre-activation record; grad = 0
                 (strips the ∇SDF sweep: the shape of an inference kernel)

Their numerics are wrong by design, except ``full`` and the sdf and
feature of ``primal_only``. ``sdf_fwd_ablate_plain`` is the plain PyTorch
version of each variant, against which the CUDA variant is held on the card.
"""

from __future__ import annotations

import math

import torch

from rnb_tpu_torch.models.fields import SDFConfig, round_to
from rnb_tpu_torch.ops import _build
from rnb_tpu_torch.ops.sdf_core import (_c16, _pe_parts, _softplus100_pair,
                                        launch_fwd, launch_fwd_wg,
                                        sdf_core_fwd_plain)

MODES = ("full", "no_pe", "no_act", "primal_only")   # index = the C SdfMode


def sdf_fwd_ablate_plain(mode: str, cfg: SDFConfig, pts, ws, bs,
                         dtype=torch.bfloat16):
    """The variant ``mode`` of the forward kernel's algorithm on whole
    tensors. -> (sdf [N], feat [N,d_out-1], grad [N,3])."""
    if mode not in MODES:
        raise ValueError(f"ablation mode must be one of {MODES}, got {mode!r}")
    if mode == "full":
        return sdf_core_fwd_plain(cfg, pts, ws, bs, dtype)
    L, n = len(ws), pts.shape[0]
    w16 = [round_to(w, dtype) for w in ws]
    c16 = _c16(dtype)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    if mode == "no_pe":
        e = tc = pts[:, :1].expand(n, cfg.input_ch)
    else:
        e, tc = _pe_parts(cfg, pts)
    e16 = round_to(e, dtype)

    def act(zb):   # -> (s, h)
        if mode == "no_act":
            return zb * 0.5, zb * 0.25
        return _softplus100_pair(zb)

    h, recs, z = e16, [], None
    for l in range(L):
        if l in cfg.skip_in:
            h = round_to(torch.cat([h, e16], dim=-1) * c16, dtype)
        z = h @ w16[l]
        if l < L - 1:
            zb = z + bs[l]
            recs.append(zb)
            h = round_to(act(zb)[1], dtype)
    z8 = z + bs[L - 1]
    sdf, feat = z8[:, 0] / cfg.scale, z8[:, 1:]
    if mode == "primal_only":
        return sdf, feat, torch.zeros(n, 3, device=pts.device)

    bar_e = torch.zeros_like(e)
    bar_h = None
    for l in range(L - 1, -1, -1):
        if l == L - 1:
            bar_x = w16[l][:, 0].expand(n, -1)
        else:
            bar_x = round_to(bar_h * act(recs[l])[0], dtype) @ w16[l].T
        if l in cfg.skip_in:
            hd = bar_x.shape[-1] - e.shape[-1]
            bar_e = bar_e + bar_x[:, hd:] * inv_sqrt2
            bar_h = bar_x[:, :hd] * inv_sqrt2
        else:
            bar_h = bar_x
    bar_e = bar_e + bar_h
    if mode == "no_pe":
        return sdf, feat, (bar_e * e).sum(dim=-1, keepdim=True).expand(n, 3)
    return sdf, feat, (bar_e * tc).reshape(n, -1, 3).sum(dim=1)


def sdf_fwd_ablate(mode: str, cfg: SDFConfig, pts, ws, bs,
                   dtype=torch.bfloat16):
    """The variant ``mode`` of the forward kernel of the dtype's route
    (``rnb_sdf_fwd_wg`` at bf16, ``rnb_sdf_fwd_ablate`` at f32) for a CUDA
    tensor, its plain version for a CPU tensor."""
    if not pts.is_cuda:
        return sdf_fwd_ablate_plain(mode, cfg, pts, ws, bs, dtype)
    if mode not in MODES:
        raise ValueError(f"ablation mode must be one of {MODES}, got {mode!r}")
    if _build.bf16_flag(dtype):
        out = launch_fwd_wg(cfg, pts, ws, bs, MODES.index(mode))
    else:
        out = launch_fwd(cfg, pts, ws, bs, entry="rnb_sdf_fwd_ablate",
                         lead=(MODES.index(mode),))
    _build.launches["sdf_fwd_ablate"] += 1
    return out
