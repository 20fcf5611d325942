"""The RNb training step.

One step per phase program (warm-up or main; the host switches between the
two, as the JAX package does):

  pixel sampling + supervision synthesis (rnb_tpu_torch.data.dataset)
  -> z init + hierarchical up-sampling (no grad)
  -> with n_outside > 0 (womask), the background NeRF (fused NeRF kernel)
  -> render_core_mvps (fused SDF-core kernel with ∇SDF, fused albedo kernel;
     the plain fields by autograd on the 'vjp' and 'fwdmode' routes)
  -> per-light shading and compositing
  -> 3-term loss: L1 colour / (mask_sum * n_lights) + igr_weight * eikonal
     + mask_weight * BCE(clip(weight_sum))
  -> one backward pass (the eikonal term's second-order part enters the SDF
     core's backward as the cotangent of ∇SDF; autograd's double backward
     on 'vjp') -> Adam.

``torch.optim.Adam`` over the leaves of the whole bundle equals
``optax.adam``: betas (0.9, 0.999), eps 1e-8 outside the sqrt, the same bias
correction, and the learning rate set to ``schedule(count)`` before each
update. Leaves the loss does not reach (the background NeRF at
n_outside = 0, and its feature, views and rgb heads always, since the RNb
render uses the background alpha only; the albedo net with no_albedo) get a
zero gradient, as under optax, so their moments stay
zero and their step count advances with the others.

The state is updated in place (parameters, moments, step); the step
returns it with a dict of 0-d metric tensors and does not synchronise with
the device. Its phases are spans (``utils/trace.py``): ``step.draws``,
``step.batch`` (the rays and the phase's targets), ``step.zero_grad``,
``step.forward`` (render and loss terms), ``step.backward`` and
``step.optimizer`` (``apply_update``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any

import torch

from rnb_tpu_torch.data import dataset as ds
from rnb_tpu_torch.models import renderer as rnd
from rnb_tpu_torch.models.fields import ModelStatics
from rnb_tpu_torch.models.renderer import RendererConfig
from rnb_tpu_torch.train import schedules
from rnb_tpu_torch.utils import trace
from rnb_tpu_torch.utils.bridge import tree_leaves


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The ``train`` conf section, with the JAX package's runtime knobs
    under the same names and defaults (``resolve_runtime_flags``: RNB_*
    environment variables override the conf)."""
    learning_rate: float = 5e-4
    learning_rate_alpha: float = 0.05
    end_iter: int = 300000
    warm_up_iter: int = 200000
    batch_size: int = 512
    validate_resolution_level: int = 4
    warm_up_end: float = 5000
    anneal_end: float = 0.0
    use_white_bkgd: bool = False
    save_freq: int = 10000
    val_freq: int = 5000
    val_mesh_freq: int = 25000
    report_freq: int = 500
    igr_weight: float = 0.1
    mask_weight: float = 0.1
    # runtime knobs
    matmul_precision: str = "high"      # carried and recorded, not applied
    upsample_precision: str = "bf16"    # 'bf16' | 'f32' no-grad sweeps
    remat: bool = False                 # checkpoint the SDF and albedo nets
    core_impl: str = "pallas"           # 'pallas' | 'vjp' | 'fwdmode'
    view_shard: bool = False            # the view-sharded step at world > 1

    def __post_init__(self):
        rnd.check_core_impl("train", self.core_impl)


def train_conf(conf) -> TrainConfig:
    """The resolved ``train`` section (conf, then RNB_* overrides)."""
    if "train" not in conf:
        return resolve_runtime_flags(TrainConfig())
    d = dict(conf["train"].as_dict())
    known = {f.name for f in dataclasses.fields(TrainConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        logging.getLogger(__name__).warning(
            "ignoring unknown train conf keys %s (not in the TrainConfig "
            "schema — check for typos)", unknown)
    return resolve_runtime_flags(
        TrainConfig(**{k: v for k, v in d.items() if k in known}))


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    return default if v is None else v not in ("0", "false", "off", "")


def resolve_runtime_flags(tcfg: TrainConfig) -> TrainConfig:
    """The conf's runtime knobs with the RNB_* environment overrides of the
    JAX package on top (the environment wins)."""
    return dataclasses.replace(
        tcfg,
        matmul_precision=os.environ.get("RNB_MATMUL_PRECISION",
                                        tcfg.matmul_precision),
        upsample_precision=os.environ.get("RNB_UPSAMPLE_PREC",
                                          tcfg.upsample_precision),
        remat=_env_bool("RNB_REMAT", tcfg.remat),
        core_impl=os.environ.get("RNB_CORE_IMPL", tcfg.core_impl),
        view_shard=_env_bool("RNB_VIEW_SHARD", tcfg.view_shard),
    )


def apply_runtime_flags(rcfg: RendererConfig, tcfg: TrainConfig) -> RendererConfig:
    """Copy the resolved runtime knobs into the RendererConfig, which is
    what the render functions read: ``upsample_precision``, ``remat`` and
    ``core_impl`` overwrite the renderer's, as in the JAX package.
    ``matmul_precision`` is
    carried and recorded (``runtime_flags_dict``), not applied: no global
    torch state changes, and the port's plain matmuls stay in full f32."""
    return dataclasses.replace(rcfg, upsample_prec=tcfg.upsample_precision,
                               remat=tcfg.remat, core_impl=tcfg.core_impl)


def runtime_flags_dict(tcfg: TrainConfig) -> dict:
    """The resolved runtime knobs as a JSON-able dict."""
    return {
        "matmul_precision": tcfg.matmul_precision,
        "upsample_precision": tcfg.upsample_precision,
        "remat": tcfg.remat,
        "core_impl": tcfg.core_impl,
        "view_shard": tcfg.view_shard,
    }


@dataclasses.dataclass
class TrainState:
    params: Any
    optimizer: torch.optim.Adam
    step: int = 0


def init_train_state(params) -> TrainState:
    """Adam (torch defaults = optax.adam's) over ``tree_leaves(params)``;
    the learning rate is set per step from the schedule."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(params=params, optimizer=opt)


def draws(generator: torch.Generator | None, bsz: int, H: int, W: int,
          n_outside: int, px=None, py=None, t_rand=None, t_out=None):
    """A step's random draws, each taken from ``generator`` (on the data's
    device) unless given, in this order: pixel indices px, py [bsz], the
    stratified shift t_rand [bsz,1] (uniform − 0.5) and, when
    n_outside > 0, the background strata t_out [bsz,n_outside] (uniform in
    [0,1))."""
    if px is None or py is None:
        px, py = ds.draw_pixels(generator, bsz, H, W)
    if t_rand is None:
        t_rand = torch.rand((bsz, 1), generator=generator,
                            device=generator.device) - 0.5
    if t_out is None and n_outside > 0:
        t_out = torch.rand((bsz, n_outside), generator=generator,
                           device=generator.device)
    return px, py, t_rand, t_out


def phase_targets(batch: ds.RayBatch, warmup: bool, bsz: int):
    """(supervision colours [L,B,3], light directions) of the phase."""
    if warmup:
        return batch.rgb_warmup, batch.lights_warmup.reshape(-1, 1, 1, 3)
    return batch.rgb, batch.lights.reshape(-1, bsz, 1, 3)


def render_batch(statics: ModelStatics, rcfg: RendererConfig,
                 tcfg: TrainConfig, params, batch: ds.RayBatch, lights_dir,
                 t_rand, t_out, step: int, warmup: bool, no_albedo: bool):
    """-> (render outputs, loss mask [B,1]: the mask, or ones when
    mask_weight is 0)."""
    if tcfg.mask_weight > 0.0:
        mask = (batch.mask > 0.5).float()
    else:
        mask = torch.ones_like(batch.mask)
    out = rnd.render_rnb(
        statics, rcfg, params, batch.rays_o, batch.rays_d, batch.near,
        batch.far, lights_dir, t_rand, t_out,
        cos_anneal_ratio=schedules.cos_anneal_ratio(step, tcfg.anneal_end),
        no_albedo=no_albedo, warmup=warmup)
    return out, mask


def apply_update(state: TrainState, sched) -> float:
    """One Adam update with the gradients in place (a leaf the loss did not
    reach gets a zero gradient, as under optax) at the schedule's learning
    rate; advances the step. -> the learning rate."""
    opt = state.optimizer
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    lr = sched(state.step)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    state.step += 1
    return lr


def _loss_terms(statics: ModelStatics, rcfg: RendererConfig, tcfg: TrainConfig,
                params, batch: ds.RayBatch, true_rgb, lights_dir, t_rand,
                t_out, step: int, warmup: bool, no_albedo: bool):
    out, mask = render_batch(statics, rcfg, tcfg, params, batch, lights_dir,
                             t_rand, t_out, step, warmup, no_albedo)
    mask_sum = mask.sum() + 1e-5

    n_lights = true_rgb.shape[0]
    color_error = (out["color_fine"] - true_rgb) * mask[None]
    color_loss = color_error.abs().sum() / (mask_sum * n_lights)

    eikonal_loss = out["gradient_error"]

    w = torch.clamp(out["weight_sum"], 1e-3, 1.0 - 1e-3)
    mask_loss = -(mask * torch.log(w) + (1.0 - mask) * torch.log(1.0 - w)).mean()

    loss = (color_loss + eikonal_loss * tcfg.igr_weight
            + mask_loss * tcfg.mask_weight)

    with torch.no_grad():
        mse = (((out["color_fine"] - true_rgb) ** 2 * mask[None]).sum()
               / (mask_sum * 3.0 * n_lights))
        metrics = {
            "loss": loss.detach(),
            "color_loss": color_loss.detach(),
            "eikonal_loss": eikonal_loss.detach(),
            "mask_loss": mask_loss.detach(),
            "s_val": out["s_val"].mean(),
            "cdf": (out["cdf_fine"][:, :1] * mask).sum() / mask_sum,
            "weight_max": (out["weight_max"] * mask).sum() / mask_sum,
            "psnr": 20.0 * torch.log10(
                1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12))),
        }
    return loss, metrics


def make_train_step(statics: ModelStatics, rcfg: RendererConfig,
                    tcfg: TrainConfig, warmup: bool, no_albedo: bool,
                    batch_size: int | None = None):
    """Build the step of one phase:
    ``(state, arrays, view_idx, generator, px=None, py=None, t_rand=None,
    t_out=None) -> (state, metrics)``. Draws come from ``generator`` unless
    given (``draws``)."""
    sched = schedules.make_lr_schedule(tcfg.learning_rate, tcfg.warm_up_end,
                                       tcfg.end_iter, tcfg.learning_rate_alpha)
    bsz = batch_size or tcfg.batch_size

    def step_fn(state: TrainState, arrays: ds.DataArrays, view_idx: int,
                generator: torch.Generator | None = None, px=None, py=None,
                t_rand=None, t_out=None):
        _, H, W, _ = arrays.normals.shape
        with trace.span("step.draws"):
            px, py, t_rand, t_out = draws(generator, bsz, H, W, rcfg.n_outside,
                                          px, py, t_rand, t_out)
        with trace.span("step.batch"):
            batch = ds.sample_rays_on_all_lights(arrays, view_idx, px, py)
            true_rgb, lights_dir = phase_targets(batch, warmup, bsz)

        with trace.span("step.zero_grad"):
            state.optimizer.zero_grad(set_to_none=False)
        with trace.span("step.forward"):
            loss, metrics = _loss_terms(statics, rcfg, tcfg, state.params, batch,
                                        true_rgb, lights_dir, t_rand, t_out,
                                        state.step, warmup, no_albedo)
        with trace.span("step.backward"):
            loss.backward()
        with trace.span("step.optimizer"):
            metrics["lr"] = torch.tensor(apply_update(state, sched))
        return state, metrics

    return step_fn
