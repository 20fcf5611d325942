"""NeuS volume renderer for the RNb training step and novel views, on tensors.

Counterpart of ``rnb_tpu/models/renderer.py``:

  * ``sample_pdf``: inverse-CDF importance sampling with
    ``torch.searchsorted(cdf, u, right=True)`` (the count of cdf entries
    ≤ u).
  * ``up_sample`` / ``cat_z_vals`` / ``upsampled_z_vals``: the no-grad
    hierarchical up-sampling, 4 rounds at inv_s = 64·2^i. The merge of the
    sorted z list with the new one is a *stable* sort of cat([z, new]), so
    ties keep z entries first.
  * ``render_core_outside``: the NeRF++ inverted-sphere background
    (``n_outside > 0``, the womask confs): the background NeRF on
    ``[x/r, 1/r]`` with r = |x| clipped to [1, 1e10], from the fused NeRF op
    (``ops.nerf``; the plain ``fields.nerf_apply`` off the 'pallas' route),
    softplus density and sigmoid colour.
  * ``render_core_mvps``: sigmoid-SDF alpha, cos annealing, transmittance,
    the eikonal error over the relaxed sphere; outside the unit sphere the
    background alpha takes the place of the SDF alpha. SDF value, feature
    and ∇SDF and the albedo come from the route ``core_impl`` names:
    'pallas' the fused kernel ops (``ops.sdf_core``, ``ops.albedo``;
    ``ops.nerf`` for the background), 'vjp' the plain fields with ∇SDF by
    autograd, differentiated again for the eikonal term, 'fwdmode' the
    plain fields with ∇SDF from forward-mode tangents. ``remat`` runs the
    SDF and albedo nets under ``torch.utils.checkpoint``, so the backward
    recomputes them, as ``jax.checkpoint`` does in the JAX package.
  * ``render_rnb``: per-light Lambertian compositing of the first
    ``n_samples`` weights; ReLU on the shading in warm-up only.
  * ``render``: the vanilla NeuS render of novel views, the albedo
    composited by the weights, with the background NeRF's alpha and colour
    mixed in outside the unit sphere when ``n_outside > 0``.

The stratified perturbations are inputs, so the tests can feed the JAX
package's draws: ``t_rand`` [B,1] (uniform − 0.5) and, with a background,
``t_out`` [B,n_outside] (uniform in [0,1)). Parity epsilons kept: alpha
guards 1e-5, cumprod 1e-7, sample_pdf weight floor 1e-5 and denominator
floor 1e-5, cos clip [-1e3, 0], inv_s clip [1e-6, 1e6].

Mesh extraction's front half: ``extract_fields`` evaluates −SDF on a dense
grid in 64³-point chunks (a ragged last one), with the points made on the
device from the bounds (``grid_chunk_points``), the f32 ``fields.sdf_only``
with TF32 off, and the values cast to float16 on the device before the one
fetch, as the JAX package does.

Spans (``utils/trace.py``): ``renderer.upsample``, ``renderer.outside`` and
``renderer.core`` around the stages of ``render_rnb`` and ``render``;
``renderer.grid_query`` around the grid's chunk loop and
``renderer.grid_fetch`` around its copy to the host and float32 conversion,
with ``renderer.grid_fetch.wait`` the wait for the grid query.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.utils.checkpoint

from rnb_tpu_torch.models import fields
from rnb_tpu_torch.models.fields import ModelStatics
from rnb_tpu_torch.ops import albedo as albedo_op
from rnb_tpu_torch.ops import nerf as nerf_op
from rnb_tpu_torch.ops import sdf_core
from rnb_tpu_torch.utils import trace

_KERNEL_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


CORE_IMPLS = ("pallas", "vjp", "fwdmode")


def check_core_impl(section: str, core_impl: str) -> None:
    """Raise ValueError, naming the key and its value, for a ``core_impl``
    that is not a route (the JAX package runs any other value as 'vjp')."""
    if core_impl not in CORE_IMPLS:
        raise ValueError(f"{section}.core_impl = {core_impl!r} is not a route "
                         f"of rnb_tpu_torch (one of {CORE_IMPLS})")


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    """The ``model.neus_renderer`` conf section plus the precision knobs:

      upsample_prec   'bf16' | 'f32': matmul operands of the no-grad
                      up-sampling SDF sweeps (sample placement only);
                      ``train.apply_runtime_flags`` sets it from
                      ``train.upsample_precision``, as the JAX package does
      kernel_prec     'bf16' | 'f32': op dtype of the fused SDF-core,
                      albedo and background-NeRF kernels (bf16 operands with f32 accumulation
                      on the main path; f32 to compare against a reference);
                      the port's own knob
      core_impl       'pallas' | 'vjp' | 'fwdmode': the differentiable
                      core's route. 'pallas' (default) the fused SDF-core,
                      albedo and NeRF kernel ops (their plain versions on
                      the CPU; never another route); 'vjp' the plain fields
                      with ∇SDF by reverse-mode autograd, differentiated
                      again for the eikonal term; 'fwdmode' the plain
                      fields with ∇SDF from forward-mode tangents. Another
                      value is refused by name (``check_core_impl``)
      remat           run the SDF and albedo closures under
                      ``torch.utils.checkpoint`` (the backward recomputes
                      them), on every route
    """
    n_samples: int = 64
    n_importance: int = 64
    n_outside: int = 0
    up_sample_steps: int = 4
    perturb: float = 1.0
    upsample_prec: str = "bf16"
    kernel_prec: str = "bf16"
    remat: bool = False
    core_impl: str = "pallas"

    def __post_init__(self):
        check_core_impl("neus_renderer", self.core_impl)

    @property
    def total_samples(self) -> int:
        return self.n_samples + self.n_importance


def renderer_conf(conf_model) -> RendererConfig:
    if "neus_renderer" not in conf_model:
        return RendererConfig()
    return RendererConfig(**dict(conf_model["neus_renderer"].as_dict()))


# ---------------------------------------------------------------------------
# importance sampling
# ---------------------------------------------------------------------------

def sample_pdf(bins: torch.Tensor, weights: torch.Tensor,
               n_samples: int) -> torch.Tensor:
    """Deterministic (midpoint-stratified) inverse-CDF sampling. bins [B,N],
    weights [B,N-1] -> samples [B,n_samples]."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)   # [B,N]

    u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                       device=bins.device)
    u = u.expand(*cdf.shape[:-1], n_samples).contiguous()
    N = cdf.shape[-1]
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, N - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def _exclusive_cumprod_transmittance(alpha: torch.Tensor) -> torch.Tensor:
    """weights = alpha * cumprod(1 - alpha + 1e-7)[exclusive]."""
    shifted = torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7],
                        dim=-1)
    return alpha * torch.cumprod(shifted, dim=-1)[:, :-1]


# ---------------------------------------------------------------------------
# hierarchical up-sampling (no grad)
# ---------------------------------------------------------------------------

def up_sample(rays_o, rays_d, z_vals, sdf, n_importance: int,
              inv_s: float) -> torch.Tensor:
    """One NeuS up-sampling round at fixed inv_s."""
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., :, None]
    radius = torch.linalg.vector_norm(pts, dim=-1)
    inside_sphere = (radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0)

    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)

    # min(cos, prev_cos): robust against local SDF dips
    prev_cos = torch.cat([torch.zeros_like(cos_val[:, :1]), cos_val[:, :-1]],
                         dim=-1)
    cos_val = torch.minimum(prev_cos, cos_val)
    cos_val = torch.clamp(cos_val, -1e3, 0.0) * inside_sphere

    dist = next_z - prev_z
    prev_esti = mid_sdf - cos_val * dist * 0.5
    next_esti = mid_sdf + cos_val * dist * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    weights = _exclusive_cumprod_transmittance(alpha)
    return sample_pdf(z_vals, weights, n_importance)


def _sdf_infer(statics: ModelStatics, params, pts_flat, prec: str = "bf16"):
    """No-grad SDF sweep (sample placement only)."""
    if prec == "bf16":
        return fields.sdf_only_lowp(statics.sdf, params["sdf"], pts_flat)
    return fields.sdf_only(statics.sdf, params["sdf"], pts_flat)


def _merge_sorted(z, new, *vals):
    """Merge per-row sorted z [B,W1] and new [B,W2]: a stable sort of
    cat([z, new]), so ties keep z entries first. Extra (v_z, v_new) pairs
    go through the same permutation."""
    z_sorted, order = torch.sort(torch.cat([z, new], dim=-1), dim=-1,
                                 stable=True)
    out = [z_sorted]
    for v_z, v_new in vals:
        out.append(torch.gather(torch.cat([v_z, v_new], dim=-1), -1, order))
    return out


def cat_z_vals(statics: ModelStatics, params, rays_o, rays_d, z_vals,
               new_z_vals, sdf, last: bool, prec: str = "bf16"):
    """Merge new z-values in; query the SDF at them unless final round."""
    if last:
        (z_sorted,) = _merge_sorted(z_vals, new_z_vals)
        return z_sorted, sdf
    batch_size = z_vals.shape[0]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * new_z_vals[..., :, None]
    new_sdf = _sdf_infer(statics, params, pts.reshape(-1, 3), prec)
    new_sdf = new_sdf.reshape(batch_size, new_z_vals.shape[-1])
    return _merge_sorted(z_vals, new_z_vals, (sdf, new_sdf))


@torch.no_grad()
def upsampled_z_vals(statics: ModelStatics, rcfg: RendererConfig, params,
                     rays_o, rays_d, z_vals) -> torch.Tensor:
    """The no-grad up-sample loop: ``up_sample_steps`` rounds with
    inv_s = 64·2^i."""
    if rcfg.n_importance <= 0:
        return z_vals
    batch_size = z_vals.shape[0]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., :, None]
    sdf = _sdf_infer(statics, params, pts.reshape(-1, 3), rcfg.upsample_prec)
    sdf = sdf.reshape(batch_size, rcfg.n_samples)
    per_round = rcfg.n_importance // rcfg.up_sample_steps
    for i in range(rcfg.up_sample_steps):
        new_z = up_sample(rays_o, rays_d, z_vals, sdf, per_round, 64 * 2 ** i)
        z_vals, sdf = cat_z_vals(statics, params, rays_o, rays_d, z_vals, new_z,
                                 sdf, last=(i + 1 == rcfg.up_sample_steps),
                                 prec=rcfg.upsample_prec)
    return z_vals


# ---------------------------------------------------------------------------
# core integrators
# ---------------------------------------------------------------------------

def render_core_outside(statics: ModelStatics, rcfg: RendererConfig, params,
                        rays_o, rays_d, z_vals,
                        sample_dist) -> Dict[str, torch.Tensor]:
    """NeRF++ inverted-sphere background over z_vals [B,S]."""
    batch_size, n_samples = z_vals.shape
    dists = torch.cat([z_vals[..., 1:] - z_vals[..., :-1],
                       torch.full_like(z_vals[:, :1], sample_dist)], dim=-1)
    mid_z = z_vals + dists * 0.5
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., :, None]

    dis_to_center = torch.clamp(
        torch.linalg.vector_norm(pts, dim=-1, keepdim=True), 1.0, 1e10)
    pts4 = torch.cat([pts / dis_to_center, 1.0 / dis_to_center], dim=-1)
    dirs = rays_d[:, None, :].expand(batch_size, n_samples, 3)

    d_in = 3 + int(rcfg.n_outside > 0)
    pts_in, dirs_in = pts4.reshape(-1, 4)[:, :d_in], dirs.reshape(-1, 3)
    if rcfg.core_impl == "pallas" and nerf_op.supported(statics.nerf):
        density, color_raw = nerf_op.nerf_apply_fused(
            statics.nerf, params["nerf"], pts_in, dirs_in,
            _KERNEL_DTYPES[rcfg.kernel_prec])
    else:
        density, color_raw = fields.nerf_apply(statics.nerf, params["nerf"],
                                               pts_in, dirs_in)
    sampled_color = torch.sigmoid(color_raw).reshape(batch_size, n_samples, 3)
    alpha = 1.0 - torch.exp(
        -fields.softplus(density.reshape(batch_size, n_samples)) * dists)
    weights = _exclusive_cumprod_transmittance(alpha)
    color = (weights[:, :, None] * sampled_color).sum(dim=1)
    return {"color": color, "sampled_color": sampled_color, "alpha": alpha,
            "weights": weights}


def sdf_feat_grad(statics: ModelStatics, params, pts, kernel_prec: str = "bf16",
                  core_impl: str = "pallas"):
    """(sdf [N], feature [N,F], ∇SDF [N,3]) at pts [N,3] by the route
    ``core_impl`` (``RendererConfig``): the fused SDF-core op at the op
    dtype ``kernel_prec`` ('pallas', for a net the kernels take),
    forward-mode tangents ('fwdmode'), else the plain field by autograd."""
    if core_impl == "pallas" and sdf_core.supported(statics.sdf):
        return sdf_core.sdf_value_feat_grad_fused(
            statics.sdf, params["sdf"], pts, _KERNEL_DTYPES[kernel_prec])
    if core_impl == "fwdmode":
        return fields.sdf_value_feat_grad_fwd(statics.sdf, params["sdf"], pts)
    return fields.sdf_value_feat_grad(statics.sdf, params["sdf"], pts)


def albedo_at(statics: ModelStatics, params, pts, normals, dirs, feature,
              kernel_prec: str = "bf16", core_impl: str = "pallas"):
    """Albedo [N, d_out] by the route ``core_impl``: the fused albedo op
    (mode ``no_view_dir``, which drops ``dirs``) at the op dtype
    ``kernel_prec`` ('pallas', for a net the kernel takes), else the plain
    field."""
    if core_impl == "pallas" and albedo_op.supported(statics.color):
        return albedo_op.albedo_apply_fused(
            statics.color, params["color"], pts, normals, feature,
            _KERNEL_DTYPES[kernel_prec])
    return fields.rendering_apply(statics.color, params["color"], pts, normals,
                                  dirs, feature)


def _checkpointed(fn):
    """``fn`` under ``torch.utils.checkpoint``: the activations of its ops
    (the parameters it reads included) are not kept for the backward, which
    runs it again (``jax.checkpoint``'s remat)."""
    return lambda *args: torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False)


def render_core_mvps(statics: ModelStatics, params, rays_o, rays_d, z_vals,
                     sample_dist, cos_anneal_ratio, background_alpha=None,
                     need_albedo: bool = True,
                     kernel_prec: str = "bf16", core_impl: str = "pallas",
                     remat: bool = False) -> Dict[str, torch.Tensor]:
    """The training integrator. Returns per-sample albedo and normals for
    the light compositing. ``background_alpha`` [B,S+n_outside] (from
    ``render_core_outside``) replaces the alpha outside the unit sphere and
    appends the outside samples; ``alpha_raw`` is the SDF alpha before.
    ``core_impl`` and ``remat`` as in ``RendererConfig``."""
    batch_size, n_samples = z_vals.shape
    dists = torch.cat([z_vals[..., 1:] - z_vals[..., :-1],
                       torch.full_like(z_vals[:, :1], sample_dist)], dim=-1)
    mid_z = z_vals + dists * 0.5
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., :, None]
    dirs = rays_d[:, None, :].expand(pts.shape)
    pts_flat = pts.reshape(-1, 3)
    dirs_flat = dirs.reshape(-1, 3)

    def svfg(x):
        return sdf_feat_grad(statics, params, x, kernel_prec, core_impl)

    def color(x, g, d, f):
        return albedo_at(statics, params, x, g, d, f, kernel_prec, core_impl)

    if remat:
        svfg, color = _checkpointed(svfg), _checkpointed(color)

    sdf, feature, gradients = svfg(pts_flat)
    sdf = sdf[:, None]

    if need_albedo:
        sampled_albedo = color(pts_flat, gradients, dirs_flat, feature).reshape(
            batch_size, n_samples, statics.color.d_out)
    else:
        sampled_albedo = torch.ones(batch_size, n_samples, statics.color.d_out,
                                    device=z_vals.device)

    inv_s = torch.clamp(fields.variance_inv_s(params["variance"]), 1e-6, 1e6)

    true_cos = (dirs_flat * gradients).sum(-1, keepdim=True)
    # annealed non-positive cos
    iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                 + torch.relu(-true_cos) * cos_anneal_ratio)

    dists_flat = dists.reshape(-1, 1)
    est_next = sdf + iter_cos * dists_flat * 0.5
    est_prev = sdf - iter_cos * dists_flat * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    alpha = torch.clamp(alpha.reshape(batch_size, n_samples), 0.0, 1.0)

    pts_norm = torch.linalg.vector_norm(pts_flat, dim=-1).reshape(
        batch_size, n_samples).detach()
    inside_sphere = (pts_norm < 1.0).float()
    relax_inside_sphere = (pts_norm < 1.2).float()

    alpha_raw = alpha
    if background_alpha is not None:
        alpha = (alpha * inside_sphere
                 + background_alpha[:, :n_samples] * (1.0 - inside_sphere))
        alpha = torch.cat([alpha, background_alpha[:, n_samples:]], dim=-1)

    weights = _exclusive_cumprod_transmittance(alpha)
    sampled_normals = gradients.reshape(batch_size, n_samples, 3)

    grad_norm = torch.linalg.vector_norm(sampled_normals, dim=-1)
    gradient_error_num = (relax_inside_sphere * (grad_norm - 1.0) ** 2).sum()
    gradient_error_den = relax_inside_sphere.sum()
    gradient_error = gradient_error_num / (gradient_error_den + 1e-5)

    return {
        "sdf": sdf,
        "dists": dists,
        "gradients": sampled_normals,
        "s_val": (1.0 / inv_s).expand(batch_size, n_samples),
        "mid_z_vals": mid_z,
        "alpha_raw": alpha_raw,
        "weights": weights,
        "cdf": prev_cdf.reshape(batch_size, n_samples),
        "gradient_error": gradient_error,
        "gradient_error_num": gradient_error_num,
        "gradient_error_den": gradient_error_den,
        "inside_sphere": inside_sphere,
        "sampled_albedo": sampled_albedo,
        "sampled_normal": sampled_normals,
    }


# ---------------------------------------------------------------------------
# z-value initialization and the RNb render
# ---------------------------------------------------------------------------

def init_z_vals(rcfg: RendererConfig, near, far, t_rand=None):
    """Uniform z init plus the stratified shift ``t_rand`` [B,1] (uniform −
    0.5; ignored when perturb is 0)."""
    z = torch.linspace(0.0, 1.0, rcfg.n_samples, device=near.device)
    z_vals = near + (far - near) * z[None, :]
    if rcfg.perturb > 0:
        z_vals = z_vals + t_rand * 2.0 / rcfg.n_samples
    return z_vals


def _outside_z_vals(rcfg: RendererConfig, far, t_out=None):
    """The n_outside background depths beyond ``far``: stratified by
    ``t_out`` [B,n_outside] (uniform in [0,1); ignored when perturb is 0),
    inverted and shifted by one sample spacing."""
    n = rcfg.n_outside
    z_out = torch.linspace(1e-3, 1.0 - 1.0 / (n + 1.0), n, device=far.device)
    if rcfg.perturb > 0:
        mids = 0.5 * (z_out[1:] + z_out[:-1])
        upper = torch.cat([mids, z_out[-1:]])
        lower = torch.cat([z_out[:1], mids])
        z_out = lower[None, :] + (upper - lower)[None, :] * t_out
    else:
        z_out = z_out.expand(far.shape[0], n)
    return far / torch.flip(z_out, dims=[-1]) + 1.0 / rcfg.n_samples


def render_rnb(statics: ModelStatics, rcfg: RendererConfig, params,
               rays_o, rays_d, near, far, lights_dir, t_rand, t_out=None,
               cos_anneal_ratio=1.0, no_albedo: bool = False,
               warmup: bool = False) -> Dict[str, torch.Tensor]:
    """RNb rendering. lights_dir broadcasts against [n_lights, batch,
    n_samples, 3]: [L,1,1,3] in warm-up (fixed per-view world lights),
    [L,B,1,3] in the main phase (per-pixel world lights). warmup=True
    applies ReLU to the shading; the main phase does not, because the
    per-pixel lights keep n·l > 0 on valid pixels. With ``n_outside > 0``
    the background NeRF fills the alpha outside the unit sphere; only the
    first ``n_samples`` weights are composited."""
    sample_dist = 2.0 / rcfg.n_samples
    z_vals = init_z_vals(rcfg, near, far, t_rand)
    with trace.span("renderer.upsample"):
        z_vals = upsampled_z_vals(statics, rcfg, params, rays_o, rays_d, z_vals)
    n_samples = rcfg.total_samples if rcfg.n_importance > 0 else rcfg.n_samples

    background_alpha = None
    if rcfg.n_outside > 0:
        with trace.span("renderer.outside"):
            z_out = _outside_z_vals(rcfg, far, t_out)
            z_feed, _ = torch.sort(torch.cat([z_vals, z_out], dim=-1), dim=-1)
            background_alpha = render_core_outside(
                statics, rcfg, params, rays_o, rays_d, z_feed, sample_dist)["alpha"]

    with trace.span("renderer.core"):
        ret = render_core_mvps(statics, params, rays_o, rays_d, z_vals,
                               sample_dist, cos_anneal_ratio,
                               background_alpha=background_alpha,
                               need_albedo=not no_albedo,
                               kernel_prec=rcfg.kernel_prec,
                               core_impl=rcfg.core_impl, remat=rcfg.remat)
    albedo = ret["sampled_albedo"]
    normal = ret["sampled_normal"]
    weights = ret["weights"]

    shading = (normal[None] * lights_dir).sum(dim=-1, keepdim=True)  # [L,B,S,1]
    if warmup:
        shading = torch.relu(shading)
    w = weights[None, :, :n_samples, None]
    color_fine = (albedo[None] * w * shading).sum(dim=2)              # [L,B,C]

    return {
        "color_fine": color_fine,
        "s_val": ret["s_val"].mean(dim=-1, keepdim=True),
        "cdf_fine": ret["cdf"],
        "weight_sum": weights.sum(dim=-1, keepdim=True),
        "weight_max": weights.max(dim=-1, keepdim=True).values,
        "gradients": ret["gradients"],
        "weights": weights,
        "gradient_error": ret["gradient_error"],
        "gradient_error_num": ret["gradient_error_num"],
        "gradient_error_den": ret["gradient_error_den"],
        "inside_sphere": ret["inside_sphere"],
    }


def render(statics: ModelStatics, rcfg: RendererConfig, params,
           rays_o, rays_d, near, far, t_rand, t_out=None,
           cos_anneal_ratio=1.0, background_rgb=None) -> Dict[str, torch.Tensor]:
    """Vanilla NeuS render for novel views: the albedo field's colour
    composited by the weights. ``t_rand=None`` renders without the
    stratified perturbations. With ``n_outside > 0`` the SDF alpha and
    colour hold inside the unit sphere, the background NeRF's outside it,
    the extra outside samples are appended and the weights rebuilt; with
    ``background_rgb`` [1,3] the rest of the transmittance shows it."""
    if t_rand is None:
        rcfg = dataclasses.replace(rcfg, perturb=0.0)
    sample_dist = 2.0 / rcfg.n_samples
    z_vals = init_z_vals(rcfg, near, far, t_rand)
    with trace.span("renderer.upsample"):
        z_vals = upsampled_z_vals(statics, rcfg, params, rays_o, rays_d, z_vals)

    with trace.span("renderer.core"):
        core = render_core_mvps(statics, params, rays_o, rays_d, z_vals,
                                sample_dist, cos_anneal_ratio, need_albedo=True,
                                kernel_prec=rcfg.kernel_prec,
                                core_impl=rcfg.core_impl, remat=rcfg.remat)
    sampled_color = core["sampled_albedo"][..., :3]
    inside = core["inside_sphere"]
    if rcfg.n_outside > 0:
        with trace.span("renderer.outside"):
            z_out = _outside_z_vals(rcfg, far, t_out)
            z_feed, _ = torch.sort(torch.cat([z_vals, z_out], dim=-1), dim=-1)
            bg = render_core_outside(statics, rcfg, params, rays_o, rays_d,
                                     z_feed, sample_dist)
        n = core["alpha_raw"].shape[1]
        alpha = core["alpha_raw"] * inside + bg["alpha"][:, :n] * (1.0 - inside)
        alpha = torch.cat([alpha, bg["alpha"][:, n:]], dim=-1)
        bg_color = bg["sampled_color"]
        sampled_color = (sampled_color * inside[:, :, None]
                         + bg_color[:, :n] * (1.0 - inside)[:, :, None])
        sampled_color = torch.cat([sampled_color, bg_color[:, n:]], dim=1)
        weights = _exclusive_cumprod_transmittance(alpha)
    else:
        weights = core["weights"]

    weights_sum = weights.sum(dim=-1, keepdim=True)
    color = (sampled_color * weights[:, :sampled_color.shape[1], None]).sum(dim=1)
    if background_rgb is not None:
        color = color + background_rgb * (1.0 - weights_sum)
    return {
        "color_fine": color,
        "s_val": core["s_val"].mean(dim=-1, keepdim=True),
        "cdf_fine": core["cdf"],
        "weight_sum": weights_sum,
        "weight_max": weights.max(dim=-1, keepdim=True).values,
        "gradients": core["gradients"],
        "weights": weights,
        "gradient_error": core["gradient_error"],
        "inside_sphere": inside,
    }


# ---------------------------------------------------------------------------
# SDF grid evaluation (mesh extraction front half)
# ---------------------------------------------------------------------------

def make_grid_points(bound_min, bound_max, resolution: int, device="cuda"):
    """[R, R, R, 3] grid coordinates (x, y, z in "ij" order)."""
    axes = [torch.linspace(float(bound_min[i]), float(bound_max[i]), resolution,
                           device=device) for i in range(3)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def sdf_grid_query(sdf_cfg, sdf_params, pts, negate: bool = True):
    """The SDF evaluation of grid extraction: f32 ``fields.sdf_only``."""
    v = fields.sdf_only(sdf_cfg, sdf_params, pts)
    return -v if negate else v


def grid_chunk_points(start: int, n: int, bound_min, bound_max,
                      resolution: int, device="cuda"):
    """[n, 3] coordinates of the grid points with flat indices
    [start, start + n), computed on the device from the bounds."""
    idx = start + torch.arange(n, device=device, dtype=torch.int64)
    bmin = torch.tensor([float(x) for x in bound_min], dtype=torch.float32,
                        device=device)
    bmax = torch.tensor([float(x) for x in bound_max], dtype=torch.float32,
                        device=device)
    r = resolution
    ix, rem = idx // (r * r), idx % (r * r)
    iy, iz = rem // r, rem % r
    f = (bmax - bmin) / (r - 1)
    return torch.stack([bmin[0] + ix.float() * f[0], bmin[1] + iy.float() * f[1],
                        bmin[2] + iz.float() * f[2]], dim=-1)


def extract_fields(statics: ModelStatics, params, bound_min, bound_max,
                   resolution: int, chunk: int = 64 ** 3, negate: bool = True):
    """(−)SDF on a dense ``resolution``³ grid -> float32 numpy [R, R, R].
    Runs on the device of the parameters; fetched once, as float16."""
    import numpy as np

    sdf_params = params["sdf"]
    dev = sdf_params[0]["b"].device
    bmin = [float(x) for x in np.asarray(bound_min).reshape(-1)]
    bmax = [float(x) for x in np.asarray(bound_max).reshape(-1)]
    total = resolution ** 3
    out = torch.empty(total, dtype=torch.float16, device=dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad(), trace.span("renderer.grid_query"):
            for start in range(0, total, chunk):
                n = min(chunk, total - start)
                pts = grid_chunk_points(start, n, bmin, bmax, resolution, dev)
                out[start:start + n] = sdf_grid_query(
                    statics.sdf, sdf_params, pts, negate).to(torch.float16)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    with trace.span("renderer.grid_fetch"):
        trace.wait("renderer.grid_fetch.wait", dev)
        host = out.cpu()
        trace.count("bytes_to_host", host.numel() * host.element_size())
        return host.numpy().astype(np.float32).reshape(
            resolution, resolution, resolution)
