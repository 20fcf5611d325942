"""Data-parallel training over the ranks of a process group, with the exact
global loss.

Every ray is independent, so the ray batch is the axis to split: each of
the ``world`` ranks renders ``B/world`` rays. The loss is normalized by
global denominators (the mask sum, the eikonal count, the ray count), so
the ranks first all-reduce their ten partial sums, detached and packed in
one f32 vector, and only then normalize. Rank r's share of the loss,

    abs_err_r / (mask_g·L) + igr·eik_num_r / (eik_den_g + 1e-5)
        + mask_weight·bce_r / count_g,

has denominators that do not depend on the parameters, so the shares sum
over the ranks to the global loss, and the SUM of the ranks' gradients (one
all-reduce of one flat buffer) is the gradient of the global loss: the
one-rank step's arithmetic, up to the order of its sums. DDP would average
the gradients of losses normalized on each rank, which is another gradient
whenever the ranks' mask sums differ; it is not used here.

Two numbers differ from the JAX package's sharded steps, which the port
does not copy: there the gradient is ``world`` times the exact one (the
loss is psum'd inside the differentiated function, and psum transposes to
psum under ``shard_map(check_vma=False)``; Adam's update hides the scale
but for its eps), and ``s_val`` is divided by the samples a ray once more
than the one-device step's (the render returns a per-ray mean). Here both
are the one-rank step's.

Every rank starts from the same parameters (the runner seeds them on a CPU
generator) and applies the same Adam update to the same summed gradient,
so the parameters stay equal bit for bit across the ranks. The metrics are
the global ones, the same on every rank.

Two placements, as in the JAX package (``rnb_tpu/parallel/train.py``):
``make_sharded_train_step`` reads replicated data; ``make_view_sharded_
train_step`` reads each rank's own views (``parallel/data.py``) and samples
rank r's rays from its local view ``view_slot % V_local``. Both keep the
signature of ``train.step.make_train_step``; the draws, given or taken from
the generator, are this rank's B/world local ones.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from rnb_tpu_torch.data import dataset as ds
from rnb_tpu_torch.models.fields import ModelStatics
from rnb_tpu_torch.models.renderer import RendererConfig
from rnb_tpu_torch.train import schedules
from rnb_tpu_torch.train import step as steplib
from rnb_tpu_torch.train.step import TrainConfig, TrainState

# the partial sums every rank all-reduces, in their order in the vector
SUMS = ("abs_err", "sq_err", "mask", "eik_num", "eik_den", "bce", "count",
        "s_val", "cdf", "weight_max")


def _local_share(statics, rcfg, tcfg, params, batch, true_rgb, lights_dir,
                 t_rand, t_out, step, warmup, no_albedo, group):
    """Render this rank's rays, all-reduce the partial sums, -> (this rank's
    share of the global loss, the global metrics)."""
    out, mask = steplib.render_batch(statics, rcfg, tcfg, params, batch,
                                     lights_dir, t_rand, t_out, step, warmup,
                                     no_albedo)
    n_lights = true_rgb.shape[0]
    abs_err = ((out["color_fine"] - true_rgb) * mask[None]).abs().sum()
    w = torch.clamp(out["weight_sum"], 1e-3, 1.0 - 1e-3)
    bce = -(mask * torch.log(w) + (1.0 - mask) * torch.log(1.0 - w)).sum()
    eik_num = out["gradient_error_num"]
    with torch.no_grad():
        local = torch.stack([
            abs_err, ((out["color_fine"] - true_rgb) ** 2 * mask[None]).sum(),
            mask.sum(), eik_num, out["gradient_error_den"], bce,
            torch.tensor(float(mask.shape[0]), device=mask.device),
            out["s_val"].sum(), (out["cdf_fine"][:, :1] * mask).sum(),
            (out["weight_max"] * mask).sum()]).float()
        dist.all_reduce(local, group=group)
        g = dict(zip(SUMS, local.unbind()))
        mask_sum = g["mask"] + 1e-5
    share = (abs_err / (mask_sum * n_lights)
             + eik_num / (g["eik_den"] + 1e-5) * tcfg.igr_weight
             + bce / g["count"] * tcfg.mask_weight)
    with torch.no_grad():
        color_loss = g["abs_err"] / (mask_sum * n_lights)
        eikonal_loss = g["eik_num"] / (g["eik_den"] + 1e-5)
        mask_loss = g["bce"] / g["count"]
        mse = g["sq_err"] / (mask_sum * 3.0 * n_lights)
        metrics = {
            "loss": (color_loss + eikonal_loss * tcfg.igr_weight
                     + mask_loss * tcfg.mask_weight),
            "color_loss": color_loss,
            "eikonal_loss": eikonal_loss,
            "mask_loss": mask_loss,
            "s_val": g["s_val"] / g["count"],
            "cdf": g["cdf"] / mask_sum,
            "weight_max": g["weight_max"] / mask_sum,
            "psnr": 20.0 * torch.log10(
                1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12))),
        }
    return share, metrics


def _sum_grads(state: TrainState, group) -> None:
    """Replace every gradient by its sum over the ranks: one all-reduce of
    one flat buffer (a leaf the loss did not reach counts as zero)."""
    leaves = [p for g in state.optimizer.param_groups for p in g["params"]]
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in leaves])
    dist.all_reduce(flat, group=group)
    for p, part in zip(leaves, flat.split([p.numel() for p in leaves])):
        p.grad.copy_(part.view_as(p.grad))


def _make_step(statics: ModelStatics, rcfg: RendererConfig, tcfg: TrainConfig,
               warmup: bool, no_albedo: bool, batch_size: int | None, group,
               view_sharded: bool):
    sched = schedules.make_lr_schedule(tcfg.learning_rate, tcfg.warm_up_end,
                                       tcfg.end_iter, tcfg.learning_rate_alpha)
    world = dist.get_world_size(group)
    global_bsz = batch_size or tcfg.batch_size
    if global_bsz % world:
        raise ValueError(f"batch size {global_bsz} does not divide by the "
                         f"world size {world}")
    bsz = global_bsz // world

    def step_fn(state: TrainState, arrays: ds.DataArrays, view: int,
                generator: torch.Generator | None = None, px=None, py=None,
                t_rand=None, t_out=None):
        n_local, H, W, _ = arrays.normals.shape
        if view_sharded:
            view = view % n_local
        px, py, t_rand, t_out = steplib.draws(generator, bsz, H, W,
                                              rcfg.n_outside, px, py, t_rand,
                                              t_out)
        batch = ds.sample_rays_on_all_lights(arrays, view, px, py)
        true_rgb, lights_dir = steplib.phase_targets(batch, warmup, bsz)

        state.optimizer.zero_grad(set_to_none=False)
        share, metrics = _local_share(statics, rcfg, tcfg, state.params, batch,
                                      true_rgb, lights_dir, t_rand, t_out,
                                      state.step, warmup, no_albedo, group)
        share.backward()
        _sum_grads(state, group)
        metrics["lr"] = torch.tensor(steplib.apply_update(state, sched))
        return state, metrics

    return step_fn


def make_sharded_train_step(statics: ModelStatics, rcfg: RendererConfig,
                            tcfg: TrainConfig, warmup: bool, no_albedo: bool,
                            batch_size: int | None = None, group=None):
    """The data-parallel step over replicated data:
    ``(state, arrays, view_idx, generator=None, px=None, py=None,
    t_rand=None, t_out=None) -> (state, metrics)``, every rank on the same
    view, each on its own B/world rays (the global batch ``batch_size`` or
    ``tcfg.batch_size`` must divide by the world size of ``group``)."""
    return _make_step(statics, rcfg, tcfg, warmup, no_albedo, batch_size,
                      group, view_sharded=False)


def make_view_sharded_train_step(statics: ModelStatics, rcfg: RendererConfig,
                                 tcfg: TrainConfig, warmup: bool,
                                 no_albedo: bool, batch_size: int | None = None,
                                 group=None):
    """The data-parallel step over view-sharded data: ``arrays`` hold this
    rank's views only, and the third argument is a view slot; each rank
    trains its B/world rays on its local view ``slot % V_local``, so a step
    sees ``world`` views. Otherwise as ``make_sharded_train_step``."""
    return _make_step(statics, rcfg, tcfg, warmup, no_albedo, batch_size,
                      group, view_sharded=True)
