"""Host side of the tensor-core (bf16) routes of ``sdf_core``, ``albedo``
and ``nerf``: the padded bf16 weight image that their wgmma sweep kernels
stream (``csrc/wg_pipe.cuh``), the offsets of the bf16 dW operand rows the
sweeps write, and the split-K dW product ``dw_gemm`` (``rnb_dw_gemm`` in
``csrc/sdf_core.cu``) that sums those rows into dW.

Each sweep writes, per layer l of [in_l, out_l], the layer's A rows (its
input, [rows, pad16(in_l)]) and B rows (its rounded pre-activation
cotangent, [rows, pad16(out_l)]) as bf16; dW_l = A_lᵀ B_l is then one
``dw_gemm`` over all rows: deterministic, no atomics.
"""

from __future__ import annotations

from typing import Sequence

import torch

from rnb_tpu_torch.ops import _build

TILE = 64            # points per block of the tensor-core sweep kernels
DW_ROWS = 64         # rows per stage of the dW product


def _pad16(x: int) -> int:
    return -(-x // 16) * 16


def offsets(in_dims: Sequence[int], out_dims: Sequence[int],
            rows: int) -> dict:
    """Per layer l: ``kp[l]`` / ``np[l]`` its widths padded to 16,
    ``w_off[l]`` its tile ([kp, np]) in the bf16 weight image, ``a_off[l]``
    / ``bb_off[l]`` its A rows ([rows, kp]) and B rows ([rows, np]) in the
    bf16 dW scratch; ``w_len``, ``a_len``, ``b_len`` the three sizes."""
    in_dims, out_dims = [int(i) for i in in_dims], [int(o) for o in out_dims]
    kp, np_ = [_pad16(i) for i in in_dims], [_pad16(o) for o in out_dims]
    w_off, a_off, bb_off = [0], [0], [0]
    for l in range(len(in_dims) - 1):
        w_off.append(w_off[-1] + kp[l] * np_[l])
        a_off.append(a_off[-1] + rows * kp[l])
        bb_off.append(bb_off[-1] + rows * np_[l])
    return dict(in_dims=in_dims, out_dims=out_dims, kp=kp, np=np_,
                w_off=w_off, a_off=a_off, bb_off=bb_off,
                w_len=w_off[-1] + kp[-1] * np_[-1],
                a_len=a_off[-1] + rows * kp[-1],
                b_len=bb_off[-1] + rows * np_[-1])


def pack_weights(ws, lay: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """The bf16 weight image: W_l rounded to bf16, zero-padded to
    [pad16(in), pad16(out)] and stored as 8x8 cores, core (i/8, o/8) at
    lay["w_off"][l] + ((i/8)·pad16(out)/8 + o/8)·64, 8 consecutive o a row.
    (``dtype`` float32 gives the same layout unrounded, for comparisons.)"""
    parts = []
    for w, kp, np_ in zip(ws, lay["kp"], lay["np"]):
        pad = torch.zeros(kp, np_, dtype=dtype, device=w.device)
        pad[:w.shape[0], :w.shape[1]] = w.detach().to(dtype)
        parts.append(pad.reshape(kp // 8, 8, np_ // 8, 8).permute(0, 2, 1, 3)
                     .reshape(-1))
    return torch.cat(parts)


def dw_gemm_plain(a, b, m: int, n: int):
    """dW = a[:, :m]ᵀ · b[:, :n] in f32 over all rows (bf16 operands)."""
    return a[:, :m].float().T @ b[:, :n].float()


def dw_gemm_splits(m: int, n: int, k: int):
    """(splits, rows per split) of the dW product: about two blocks an SM on
    the card's 132 SMs, each split a multiple of 64 rows."""
    tiles = -(-m // 128) * -(-n // 128)
    splits = max(1, min(-(-264 // tiles), -(-k // (8 * DW_ROWS))))
    chunk = -(-k // splits)
    chunk = -(-chunk // DW_ROWS) * DW_ROWS
    return -(-k // chunk), chunk


def dw_gemm(a, b, m: int, n: int, partial=None, *, counter: str):
    """dW [m, n] = a[:, :m]ᵀ · b[:, :n] summed over the rows of the [K, lda]
    and [K, ldb] bf16 operands (lda, ldb multiples of 8): the tensor-core
    split-K kernel (``rnb_dw_gemm``) for CUDA tensors, deterministic, which
    adds one to ``_build.launches[counter]``; ``dw_gemm_plain`` for CPU
    tensors. ``partial`` is an optional f32 scratch of at least
    splits·m·n floats."""
    if not a.is_cuda:
        return dw_gemm_plain(a, b, m, n)
    if (a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or a.dim() != 2
            or b.dim() != 2 or a.shape[0] != b.shape[0] or a.shape[1] % 8
            or b.shape[1] % 8 or m > a.shape[1] or n > b.shape[1]
            or not a.is_contiguous() or not b.is_contiguous()):
        raise ValueError("dw_gemm takes two contiguous [K, 8j] bf16 matrices "
                         "of the same row count")
    k = a.shape[0]
    splits, chunk = dw_gemm_splits(m, n, k)
    if partial is None or partial.numel() < splits * m * n:
        partial = torch.empty(splits * m * n, device=a.device)
    dw = torch.empty(m, n, device=a.device)
    with torch.cuda.device(a.device):
        rc = _build.library().rnb_dw_gemm(
            a.data_ptr(), a.shape[1], b.data_ptr(), b.shape[1], k, m, n, chunk,
            splits, partial.data_ptr(), dw.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "rnb_dw_gemm")
    _build.launches[counter] += 1
    return dw


def dw_products(abuf, bbuf, lay: dict, rows: int, counter: str):
    """dW_l = A_lᵀ B_l for every layer of ``lay`` from the bf16 dW scratch
    a sweep filled (``rows`` rows a layer), one ``dw_gemm`` each."""
    dev = abuf.device
    pairs = list(zip(lay["in_dims"], lay["out_dims"]))
    partial = torch.empty(max(dw_gemm_splits(i, o, rows)[0] * i * o
                              for i, o in pairs), device=dev)
    dws = []
    for l, (i, o) in enumerate(pairs):
        kp, np_ = lay["kp"][l], lay["np"][l]
        a = abuf[lay["a_off"][l]:lay["a_off"][l] + rows * kp].view(rows, kp)
        b = bbuf[lay["bb_off"][l]:lay["bb_off"][l] + rows * np_].view(rows, np_)
        dws.append(dw_gemm(a, b, i, o, partial, counter=counter))
    return dws
