"""Host side of the tensor-core (bf16) routes of ``sdf_core``, ``albedo``
and ``nerf``: the padded bf16 weight image that their wgmma sweep kernels
stream by TMA (``csrc/tma.cuh``, ``csrc/wg_sweep.cuh``), the offsets of the
bf16 dW operand rows the sweeps write, and the grouped dW product
(``rnb_dw_products`` in ``csrc/dw_gemm.cu``) that sums those rows into dW.

Each sweep writes, per layer l of [in_l, out_l], the layer's A rows (its
input, [rows, pad16(in_l)]) and B rows (its rounded pre-activation
cotangent, [rows, pad16(out_l)]) as bf16; dW_l = A_lᵀ B_l for every layer
is then one launch over a work list of units (layer, m-tile, n-tile, row
split) and one fixed-order sum of the row splits: deterministic, no atomics.
"""

from __future__ import annotations

from typing import Sequence

import torch

from rnb_tpu_torch.ops import _build

TILE = 64            # points per tile of the tensor-core sweep kernels
ALBEDO_FWD_RING_DEPTH = 18   # the albedo forward's TMA ring, AF_RS of
                             # csrc/albedo.cu
ALBEDO_BWD_RING_DEPTH = 16   # the albedo backward sweep's, AB_RS
NERF_FWD_RING_DEPTH = 15     # the NeRF forward's, NF_RS of csrc/nerf.cu
NERF_BWD_RING_DEPTH = 10     # the NeRF backward sweep's, NB_RS
SWEEP_RING_DEPTH = 16   # the SDF core's backward sweep's TMA ring, SW_RS of
                        # csrc/sdf_core.cu
FWD_RING_DEPTH = 16     # the SDF core's forward's TMA ring, SF_RS of
                        # csrc/sdf_core.cu
DW_ROWS = 64         # rows per stage of the dW product (a TMA box)
DW_TILE_M = 128      # rows of dW a unit sums (two consumer warpgroups)
DW_SMS = 132         # the H100 SXM's SMs: about one dW unit each


# The albedo and NeRF forwards and backward sweeps (csrc/wg_sweep.cuh): one
# block a pair of 64-point tiles, a ring of STAGE_BYTES slots (the NeRF
# forward's are larger, nerf.FWD_STAGE_BYTES), each stage one 3-D TMA box
# of a layer's tile of the weight image; the backward sweeps' timing split
# (the tune library; index = the C WgSplit): the production sweep, then the
# ring and its barriers alone, the products without epilogue arithmetic or
# operand rows, without the operand-row stores, and without the bias, ReLU
# and mask work.
STAGE_BYTES = 8192
SMEM_LIMIT = 232448   # the H100's shared memory a block can have
WG_BWD_SPLIT = ("full", "k_loops_only", "products_only", "no_rows",
                "no_epilogue")


# The forwards' timing split (the tune library; the C WgSplit of each
# name): the production kernel, then the ring and its barriers alone, the
# products alone (neither the A tile nor an output written), and the
# products with the accumulators rounded straight into the A tile and the
# heads written raw (no bias, ReLU or sigmoid).
WG_FWD_SPLIT = ("full", "k_loops_only", "products_only", "no_epilogue")


def _tune(fn, args, pas: str, splits, depths, split, depth):
    op = fn.__module__.rsplit(".", 1)[-1]
    if (split is None) == (depth is None):
        raise ValueError("give one of split and depth")
    if split is not None:
        if split not in splits:
            raise ValueError(f"split must be one of {splits}, got {split!r}")
        tune = (f"rnb_{op}_{pas}_wg_split", (WG_BWD_SPLIT.index(split),))
        key = f"{op}_{pas}_split"
    else:
        if depth not in depths[op]:
            raise ValueError(f"depth must be one of {depths[op]}, got {depth}")
        tune = (f"rnb_{op}_{pas}_wg_tune", (depth,))
        key = f"{op}_{pas}_rs{depth}"
    out = fn(*args, tune=tune)
    _build.launches[key] += 1
    return out


def bwd_tune(sweep, *args, split: str | None = None,
             depth: int | None = None):
    """One launch of an albedo or NeRF backward sweep from the tune library
    (CUDA tensors only): ``sweep`` is ``ops.albedo.bwd_sweep`` or
    ``ops.nerf.bwd_sweep``, called on ``args`` as the production sweep is,
    either in the timing ``split`` (a ``WG_BWD_SPLIT`` name; only "full"
    computes the function), counted under ``{op}_bwd_split``, or at ring
    ``depth`` (one of ``_build.BWD_TUNE_DEPTHS[op]``), counted under
    ``{op}_bwd_rs{depth}``. -> as ``sweep``."""
    return _tune(sweep, args, "bwd", WG_BWD_SPLIT, _build.BWD_TUNE_DEPTHS,
                 split, depth)


def fwd_tune(fwd, *args, split: str | None = None,
             depth: int | None = None):
    """As ``bwd_tune``, for the albedo or NeRF bf16 forward: ``fwd`` is
    ``ops.albedo.fwd_wg`` or ``ops.nerf.fwd_wg``; ``split`` a
    ``WG_FWD_SPLIT`` name, counted under ``{op}_fwd_split``, or ``depth``
    one of ``_build.WG_FWD_TUNE_DEPTHS[op]``, counted under
    ``{op}_fwd_rs{depth}``. -> as ``fwd``."""
    return _tune(fwd, args, "fwd", WG_FWD_SPLIT, _build.WG_FWD_TUNE_DEPTHS,
                 split, depth)


def pair_blocks(n: int) -> list:
    """The blocks of a sweep that runs one block a pair of 64-point tiles:
    block b runs tiles 2b and 2b + 1, the second only where it holds a
    point. -> [[tile, ...] a block]."""
    tiles = -(-n // TILE)
    return [[t for t in (2 * b, 2 * b + 1) if t < tiles]
            for b in range(-(-tiles // 2))]


def handoff(nk: int, depth: int) -> int:
    """The K-step of a product phase after whose issue a consumer hands the
    turn to the other tile of its pair (RnbTurns, csrc/tma.cuh): its last
    at a ring as deep as the phase, else the ring's reach."""
    return min(nk, depth) - 1


def ring_smem_bytes(depth: int, tile_bytes: int,
                    stage: int = STAGE_BYTES) -> int:
    """wb_smem_bytes of csrc/wg_sweep.cuh: two tiles' areas of
    ``tile_bytes``, ``depth`` ring slots of ``stage`` bytes, the ring's
    full and empty barriers and the two turn barriers."""
    return 2 * tile_bytes + depth * stage + (2 * depth + 2) * 8


def sidx(p: int, k: int) -> int:
    """Element (p, k) of the albedo and NeRF sweeps' A tile (wb_sidx of
    csrc/wg_sweep.cuh): K-major in wgmma's 128-byte swizzle, blocks of 64
    columns (4096 elements), each 64 rows of 64, the 8-element chunk c of
    row p at chunk c ^ (p % 8)."""
    chunk = ((k >> 3) & 7) ^ (p & 7)
    return ((k >> 6) << 12) + (p << 6) + (chunk << 3) + (k & 7)


def store_boxes(kw: int, n0: int) -> list:
    """The TMA stores that write a tile's first ``kw`` columns as operand
    rows (wb_rows_out of csrc/wg_sweep.cuh): per block kc of 64 columns, the
    tile's 8 KB at element 4096·kc as the box {64, 64} in the 128-byte
    swizzle at (column 64kc, row n0) of the [n, ld] rows; columns past ld
    and rows past n are not written."""
    return [(kc << 12, (64 * kc, n0)) for kc in range(-(-kw // 64))]


def phase_steps(lay: dict, phases) -> list:
    """The ring stages of a phase table ([(kind, layer, box, c2)], as
    WbCursor walks it), as (kind, layer, box, coordinates): a forward
    phase over pad16(in)/16 K-steps at (0, 0, 2t), a reverse one over
    pad16(out)/16 at (0, 2t, c2)."""
    steps = []
    for kind, l, box, c2 in phases:
        if kind == "fwd":
            steps += [(kind, l, box, (0, 0, 2 * t))
                      for t in range(lay["kp"][l] // 16)]
        else:
            steps += [(kind, l, box, (0, 2 * t, c2))
                      for t in range(lay["np"][l] // 16)]
    return steps


def phase_nks(lay: dict, phases) -> list:
    """The K-steps of each phase of a table, in order."""
    return [(lay["kp"] if kind == "fwd" else lay["np"])[l] // 16
            for kind, l, _, _ in phases]


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


def dw_tiles(m: int, n: int) -> list:
    """The (m0, n0, bn) tiles of one [m, n] dW: 128 rows of m (the two
    consumer warpgroups' 64 each) by bn columns, bn 256, or 128 or 64 for
    the last columns (the narrowest that covers them); the m-tiles of one
    n-tile are neighbours."""
    ns, n0 = [], 0
    while n0 < n:
        rem = n - n0
        bn = 256 if rem > 128 else 128 if rem > 64 else 64
        ns.append((n0, bn))
        n0 += bn
    return [(m0, n0, bn) for n0, bn in ns for m0 in range(0, m, DW_TILE_M)]


def dw_splits(shapes: Sequence, k: int, splits: int | None = None):
    """(splits, rows per split) of the dW products of ``shapes`` ([(m, n)]
    a layer) over k rows: by default about one unit an SM of the H100's
    132 (a function of the shapes alone, never of the card the call runs
    on), each split a multiple of 64 rows. A given ``splits`` (the tile
    sweep's) replaces that count; its chunk is rounded up to 64 rows the
    same way, so fewer splits may result."""
    if splits is None:
        tiles = sum(len(dw_tiles(m, n)) for m, n in shapes)
        splits = max(1, min(DW_SMS // tiles, -(-k // DW_ROWS)))
    elif splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    chunk = -(-max(k, 1) // splits)
    chunk = -(-chunk // DW_ROWS) * DW_ROWS
    return max(1, -(-k // chunk)), chunk


def dw_work(shapes: Sequence, k: int, splits: int | None = None):
    """The work list of the grouped dW kernel: (units, splits, chunk), each
    unit (layer, m0, n0, bn, split), layer by layer, split by split, the
    tiles of ``dw_tiles`` within. Every element (i, j) of every layer's dW
    lies in exactly one tile, which each split sums once over its rows."""
    splits, chunk = dw_splits(shapes, k, splits)
    units = [(l, m0, n0, bn, s) for l, (m, n) in enumerate(shapes)
             for s in range(splits) for m0, n0, bn in dw_tiles(m, n)]
    return units, splits, chunk


_WORK = {}   # (shapes, k, splits, device) -> (int32 units [U, 4], splits, chunk)


def _work_on(shapes, k: int, splits, dev):
    """``dw_work`` as the kernel reads it, a [U, 4] int32 tensor of (layer |
    bn << 8, m0, n0, split) on ``dev``, built once per shape and cached."""
    key = (tuple(shapes), k, splits, str(dev))
    if key not in _WORK:
        if len(_WORK) >= 64:   # a few shapes a run; never grows unbounded
            _WORK.clear()
        units, s, chunk = dw_work(shapes, k, splits)
        rows = [(l | bn << 8, m0, n0, sp) for l, m0, n0, bn, sp in units]
        _WORK[key] = (torch.tensor(rows, dtype=torch.int32, device=dev), s, chunk)
    return _WORK[key]


def _dw_launch(a, b, shapes, lds_a, lds_b, a_off, b_off, k: int,
               counter: str, splits):
    """The grouped kernel over the layers of ``shapes`` (A_l at a[a_off[l]:]
    as [k, lds_a[l]], B_l likewise): one launch and its fixed-order split
    sum, one count under ``counter``. -> [dW_l]"""
    units, splits, chunk = _work_on(shapes, k, splits, a.device)
    sizes = [m * n for m, n in shapes]
    partial = torch.empty(splits * sum(sizes), device=a.device)
    dw = torch.empty(sum(sizes), device=a.device)
    with torch.cuda.device(a.device):
        rc = _build.library().rnb_dw_products(
            a.data_ptr(), b.data_ptr(), len(shapes),
            _build.int_array([m for m, _ in shapes]),
            _build.int_array([n for _, n in shapes]),
            _build.int_array(lds_a), _build.int_array(lds_b),
            _build.ll_array(a_off), _build.ll_array(b_off), k, chunk, splits,
            units.data_ptr(), units.shape[0], partial.data_ptr(),
            dw.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "rnb_dw_products")
    _build.launches[counter] += 1
    return [t.view(m, n) for t, (m, n) in zip(dw.split(sizes), shapes)]


def _check_operands(a, b, what: str):
    if (a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16
            or not a.is_contiguous() or not b.is_contiguous()
            or a.data_ptr() % 16 or b.data_ptr() % 16
            or a.device != b.device):
        raise ValueError(f"{what} takes contiguous, 16-byte aligned bf16 "
                         "operands on one device")


def dw_gemm(a, b, m: int, n: int, *, counter: str,
            splits: int | None = None):
    """dW [m, n] = a[:, :m]ᵀ · b[:, :n] summed over the rows of the [K, lda]
    and [K, ldb] bf16 operands (lda, ldb multiples of 8): the grouped
    kernel (``rnb_dw_products``) on a one-layer list for CUDA tensors,
    deterministic, which adds one to ``_build.launches[counter]``;
    ``dw_gemm_plain`` for CPU tensors. ``splits`` as ``dw_splits`` takes it
    (None: the production choice)."""
    if not a.is_cuda:
        return dw_gemm_plain(a, b, m, n)
    _check_operands(a, b, "dw_gemm")
    if (a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]
            or a.shape[1] % 8 or b.shape[1] % 8 or not 0 < m <= a.shape[1]
            or not 0 < n <= b.shape[1]):
        raise ValueError("dw_gemm takes two [K, 8j] bf16 matrices of the "
                         "same row count, m and n within their widths")
    return _dw_launch(a, b, [(m, n)], [a.shape[1]], [b.shape[1]], [0], [0],
                      a.shape[0], counter, splits)[0]


def dw_products(abuf, bbuf, lay: dict, rows: int, counter: str,
                splits: int | None = None):
    """dW_l = A_lᵀ B_l for every layer of ``lay`` from the bf16 dW scratch
    a sweep filled (``rows`` rows a layer): one grouped launch for CUDA
    tensors (counted once under ``counter``), ``dw_gemm_plain`` a layer
    for CPU tensors. ``splits`` as ``dw_splits`` takes it."""
    shapes = list(zip(lay["in_dims"], lay["out_dims"]))
    if not abuf.is_cuda:
        return [dw_gemm_plain(
            abuf[ao:ao + rows * kp].view(rows, kp),
            bbuf[bo:bo + rows * np_].view(rows, np_), i, o)
            for (i, o), kp, np_, ao, bo in zip(
                shapes, lay["kp"], lay["np"], lay["a_off"], lay["bb_off"])]
    _check_operands(abuf, bbuf, "dw_products")
    if (abuf.dim() != 1 or bbuf.dim() != 1
            or abuf.numel() < lay["a_off"][-1] + rows * lay["kp"][-1]
            or bbuf.numel() < lay["bb_off"][-1] + rows * lay["np"][-1]):
        raise ValueError("dw_products takes the flat dW scratch that "
                         "wg.offsets lays out")
    return _dw_launch(abuf, bbuf, shapes, lay["kp"], lay["np"], lay["a_off"],
                      lay["bb_off"], rows, counter, splits)
