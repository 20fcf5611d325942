"""The numbers that decide ``correct``, each a gap between what the timed
path produced and the plain reference, and the verdict against the cell's
limits (``cells/<cell>.json``).

Training (the first three steps of the window's own call), each leaf's
gap taken over the larger of the reference's norm of that leaf and of the
median leaf:
  * ``loss_gap``: the largest |L_program - L_reference| / |L_reference| of
    the three steps' losses;
  * ``grad_median_gap``: for the first gradient as Adam got it (its first
    moment after one step, over 1 - 0.9), a leaf's gap is
    |(|g_program| - |g_reference|)|; the number is the median leaf's. The
    worst leaf's is not steady from seed to seed: the SDF head's bias
    gathers a sum over every point that nearly cancels where the gradient
    is small (the womask conf's first step), and its bf16 rounding reads
    0.05-0.07 on some seeds and 0.002 on others (``worst_leaf`` reports
    it);
  * ``grad_diff_gap``: the same first gradient, a leaf's gap
    |g_program - g_reference|, by the worst weight matrix (the leaves of two
    dimensions). A gap of norms cannot see a gradient that turned: half of
    the batch gives a gradient of about the same norm in another direction.
    A bias, a gain or the variance is a short vector of sums over every
    point that nearly cancel, whose bf16 rounding reads up to 0.066 on some
    seeds and 0.007 on others; a matrix's difference gathers many such
    sums and reads alike from seed to seed;
  * ``change_gap``: by the worst leaf, the gap of norms for the change of
    each leaf over the three steps (a leaf left unmoved, or moved double,
    reads 1).
  Leaves whose reference gradient is under a thousandth of the median
  leaf's (the background NeRF's heads, which the RNb render never reads,
  and the whole NeRF without a background) are left out of the gradient's
  and the change's numbers.
Novel views: ``frame_gap``, the largest over the sampled frames of the mean
over pixels of what |p + 0.5 - 255 clip(c)| exceeds half a level by, in
8-bit levels: the program writes floor(255 clip(c)), whose own rounding
stays within half a level of p + 0.5, so an exact frame reads 0.
The mesh: ``grid_gap``, the largest |grid - (-sdf)| at the sampled grid
points within ``band`` of the surface; ``vertex_gap``, the largest |sdf| of
the reference at the sampled vertices taken back to normalized space.
"""

from __future__ import annotations

import numpy as np
import torch


def _median(xs):
    xs = [x for x in xs if x > 0]
    return float(np.median(xs)) if xs else 0.0


def _leaf_gaps(prog: dict, ref: dict, counted) -> list:
    med = _median(ref[k] for k in counted)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in counted]


def _counted(g_ref: dict) -> list:
    med = _median(g_ref.values())
    return [k for k, v in g_ref.items() if v >= 1e-3 * med]


def _diff_gaps(prog: dict, ref: dict, norms: dict, counted) -> list:
    med = _median(norms[k] for k in counted)
    return [float(torch.linalg.vector_norm(prog[k].double() - ref[k].double()))
            / max(norms[k], med, 1e-30) for k in counted]


def training_gaps(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"losses": [..3], "grads": {leaf: g1 on the
    host}, "change_norms": {leaf: |p3 - p0|}}."""
    g_ref = leaf_norms(ref["grads"].items())
    counted = _counted(g_ref)
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]) or not np.all(
            np.isfinite(prog["losses"])):
        loss = float("inf")
    diff = _diff_gaps(prog["grads"], ref["grads"], g_ref, counted)
    return {"loss_gap": loss,
            "grad_median_gap": float(np.median(_leaf_gaps(
                leaf_norms(prog["grads"].items()), g_ref, counted) or [0.0])),
            "grad_diff_gap": max((d for d, k in zip(diff, counted)
                                  if ref["grads"][k].dim() == 2), default=0.0),
            "change_gap": max(_leaf_gaps(prog["change_norms"], ref["change_norms"],
                                         counted), default=0.0)}


def worst_leaf(prog: dict, ref: dict) -> dict:
    """{"norm": (gap, leaf), "diff": (gap, leaf)}: the first gradient's worst
    leaf by the gap of norms and by the norm of the difference (a
    diagnostic)."""
    g_ref = leaf_norms(ref["grads"].items())
    counted = _counted(g_ref)
    norm = _leaf_gaps(leaf_norms(prog["grads"].items()), g_ref, counted)
    diff = _diff_gaps(prog["grads"], ref["grads"], g_ref, counted)
    return {"norm": max(zip(norm, counted), default=(0.0, "")),
            "diff": max(zip(diff, counted), default=(0.0, ""))}


def leaf_norms(named) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in named}


def frame_gap(frame_u8: np.ndarray, ref: torch.Tensor) -> float:
    """Mean over the frame of max(0, |p + 0.5 - 255 clip(ref)| - 0.5), in
    levels."""
    p = torch.as_tensor(frame_u8.astype(np.float64)).reshape(-1, 3)
    r = ref.detach().double().cpu().reshape(-1, 3).clamp(0.0, 1.0) * 255.0
    return float(((p + 0.5 - r).abs() - 0.5).clamp_min(0.0).mean())


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) over the cell's limits: each number
    with a limit is compared; a limit without its number is not correct. A
    number without a limit is not compared (``cells/<cell>.json`` says why)."""
    rows, ok = [], bool(limits)
    for name in sorted(limits):
        value, limit = numbers.get(name), limits[name]
        good = value is not None and bool(np.isfinite(value)) and value <= limit
        ok = ok and good
        rows.append((name, value, limit))
    return ok, rows
