"""Operations and bytes of the program's work, from the conf's widths.

A frozen copy of the port's arithmetic (``tools/bench.py``
``analytic_step_flops``, the ``model`` count; ``chip_smoke.py`` phase 1's
least multiply-adds per point of each op), so that the yardstick does not
move with the program's tools. Shapes come from ``rnbbench.weights.dims``:
each layer an [in, out] matrix.

  * SDF forward (value, feature and gradient): the primal chain and its
    reverse sweep through every layer but the last, which the seed
    W_last[:, 0] replaces;
  * SDF backward: the tangent slab through every layer but the last, the
    primal and tangent slabs back through every layer but the first (a skip
    layer only through its h rows), and dW over both;
  * NeRF forward: every layer; backward: the reverse through rgb, views (to
    its feature rows), alpha, feature and the trunk but layer 0 (a skip
    layer only through its h rows), and dW over all layers;

  Each product of an op is counted once, whatever implements it: a backward
  that runs the forward again (the kernels rebuild the primal activations)
  does that work beyond the op's least, so the backward's counts leave the
  recompute out and an op's count is its forward's plus its backward's;
  * a main-phase training step's ``model`` FLOPs (recompute-free): the
    points of the core ``B (n_samples + n_importance)`` at 6 SDF and 3 albedo
    passes, the up-sampling sweeps' points at one SDF-only pass, the
    background's ``B (core + n_outside)`` points at 3 NeRF passes.
"""

from __future__ import annotations

from rnbbench.weights import dims

F32 = 4


def chain(shapes) -> int:
    return sum(i * o for i, o in shapes)


def nerf_shapes(d: dict) -> list:
    """pts layers, then alpha, feature, views, rgb."""
    n = d["nerf"]
    return n["pts_layers"] + [n["alpha_layer"], n["feature_layer"],
                              n["views_layer"], n["rgb_layer"]]


def sdf_fwd_macs(model: dict) -> int:
    s = dims(model)["sdf"]
    return chain(s) + chain(s[:-1])


def sdf_bwd_macs(model: dict) -> int:
    """The backward without the primal slab the forward already made."""
    d = dims(model)
    s, e = d["sdf"], d["e_sdf"]
    skip = model["sdf_network"]["skip_in"]
    rev = sum((i - e if l in skip else i) * o for l, (i, o) in enumerate(s) if l > 0)
    return chain(s[:-1]) + 2 * rev + 2 * chain(s)


def sdf_only_macs(model: dict) -> int:
    """One value-only pass (the head cut to the sdf column)."""
    s = dims(model)["sdf"]
    return chain(s[:-1]) + s[-1][0]


def albedo_macs(model: dict) -> int:
    return chain(dims(model)["color"])


def nerf_macs(model: dict) -> int:
    return chain(nerf_shapes(dims(model)))


def nerf_bwd_macs(model: dict) -> int:
    """The backward without the forward it runs again."""
    d = dims(model)
    ws = nerf_shapes(d)
    D = model["nerf"]["D"]
    e = ws[0][0]
    skips = model["nerf"]["skips"]
    rev = (chain([ws[D], ws[D + 1], ws[D + 3]]) + ws[D + 1][1] * ws[D + 2][1]
           + sum((i - e if l - 1 in skips else i) * o
                 for l, (i, o) in enumerate(ws[:D]) if l > 0))
    return rev + chain(ws)


def param_bytes(shapes) -> int:
    return sum(i * o + o for i, o in shapes) * F32


def core_points(conf: dict) -> int:
    """Core samples a ray."""
    r = conf["model"]["neus_renderer"]
    return r["n_samples"] + r["n_importance"] if r["n_importance"] > 0 else r["n_samples"]


def upsample_points(conf: dict) -> int:
    """SDF-only queries a ray in the up-sampling (the last round queries
    none)."""
    r = conf["model"]["neus_renderer"]
    if r["n_importance"] <= 0:
        return 0
    per = r["n_importance"] // r["up_sample_steps"]
    return r["n_samples"] + per * (r["up_sample_steps"] - 1)


def step_model_flops(conf: dict) -> float:
    """FLOPs of one training step, recompute-free (``model``)."""
    m = conf["model"]
    bsz = conf["train"]["batch_size"]
    n_core = bsz * core_points(conf)
    f_sdf = 2.0 * chain(dims(m)["sdf"])
    f_alb = 2.0 * albedo_macs(m)
    flops = n_core * (6.0 * f_sdf + 3.0 * f_alb) + bsz * upsample_points(conf) * 2.0 * sdf_only_macs(m)
    n_out = m["neus_renderer"]["n_outside"]
    if n_out > 0:
        flops += bsz * (core_points(conf) + n_out) * 3.0 * 2.0 * nerf_macs(m)
    return flops


def render_ray_flops(conf: dict) -> float:
    """Forward FLOPs of one novel-view ray: the up-sampling sweeps, the SDF
    value, feature and gradient, the albedo (and, with a background, the
    NeRF on the core and outside samples)."""
    m = conf["model"]
    f = (upsample_points(conf) * 2.0 * sdf_only_macs(m)
         + core_points(conf) * 2.0 * (sdf_fwd_macs(m) + albedo_macs(m)))
    n_out = m["neus_renderer"]["n_outside"]
    if n_out > 0:
        f += (core_points(conf) + n_out) * 2.0 * nerf_macs(m)
    return f


def sdf_op_bytes(model: dict, n: int, backward: bool) -> int:
    """Inputs read once and outputs written once at the op's boundary, f32:
    forward pts, weights -> sdf, feature, gradient; backward pts, weights
    and the three cotangents -> dW, db."""
    s = dims(model)["sdf"]
    feat = s[-1][1] - 1
    fwd = n * 3 * F32 + param_bytes(s) + n * (1 + feat + 3) * F32
    if not backward:
        return fwd
    return fwd + n * 3 * F32 + 2 * param_bytes(s) + n * (1 + feat + 3) * F32


def nerf_op_bytes(model: dict, n: int) -> int:
    """Forward pts [n,4], views [n,3], weights -> alpha, rgb; backward pts,
    views, weights, the two cotangents -> dW, db."""
    ws = nerf_shapes(dims(model))
    io = n * (4 + 3) * F32
    outs = n * (1 + 3) * F32
    return (io + param_bytes(ws) + outs) + (io + 2 * param_bytes(ws) + outs)


def bound_s(macs: float, nbytes: float, peak_flops: float, peak_bytes: float) -> float:
    """The least time: the larger of the multiply-adds at the peak and the
    bytes at the memory rate."""
    return max(2.0 * macs / peak_flops, nbytes / peak_bytes)
