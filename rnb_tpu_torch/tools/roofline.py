"""Per-region times of the training step on one CUDA card, beside the
card's bf16 peak (the port's counterpart of ``tools/roofline.py``).

    python -m rnb_tpu_torch.tools.roofline [--iters 60] [--batch 512]
        [--json OUT] [--device cuda|cpu]

Each region runs as its own call on the bench fixture
(``rnb_tpu_torch.tools.bench``: the sphere scene, random weights from seed
0) at the shipped ``confs/wmask_rnb.conf``, N = batch·(64+64) core points:

    region                what runs
    step_main             the whole main-phase train step (the bench row)
    step_warm             the warm-up-phase step
    core_fwd              the SDF core op forward (ops.sdf_core) at N points
    core_fwd_bwd          + the backward of the scalar contraction
                          sdf·1e-3 + mean(feat·cw) + eikonal
    upsample_render_fwd   render_rnb under torch.no_grad: z init, the 4
                          up-sampling rounds, the core forward, compositing
    color_fwd             the albedo op forward at N points
    adam                  train.step.apply_update on fixed gradients
    data_sample           the step's draws and ray / supervision sampling

Each region: one call to warm up, then three turns of ``--iters`` calls on
the host clock, each ended by ``torch.cuda.synchronize()``: the median
turn's ms a call, with the min and max. ``residual`` is the JAX tool's:
step_main − (core_fwd_bwd + (upsample_render_fwd − core_fwd) + 3·color_fwd
+ adam + data_sample); the regions overlap, so it is approximate.
``step_main`` carries the analytic executed FLOPs of
``bench.analytic_step_flops`` and their share of the card's bf16 peak
(``bench.PEAK_BF16_FLOPS``) in place of XLA's cost analysis; no byte
count exists (``"bytes": "not counted"``). ``env`` names the sweep
kernels' tile (64 points) and the TMA ring depths of the albedo and NeRF
forwards and backward sweeps (``wg.ALBEDO_FWD_RING_DEPTH`` 18,
``NERF_FWD_RING_DEPTH`` 15, ``ALBEDO_BWD_RING_DEPTH`` 16,
``NERF_BWD_RING_DEPTH`` 10).

Prints one JSON line of every region, with the card (nvidia-smi's name and
power limit). Without a CUDA device it exits non-zero unless given
``--device cpu`` (control flow only: its line says ``"device": "cpu"`` and
holds no peak share).
"""

from __future__ import annotations

import argparse
import json

import torch

from rnb_tpu_torch.data import dataset as ds
from rnb_tpu_torch.models import renderer as rnd
from rnb_tpu_torch.ops import sdf_core, wg
from rnb_tpu_torch.tools import bench
from rnb_tpu_torch.train import schedules
from rnb_tpu_torch.train import step as steplib

# the TMA ring depths of the albedo and NeRF sweep kernels
RING_DEPTHS = {"albedo_fwd": wg.ALBEDO_FWD_RING_DEPTH,
               "nerf_fwd": wg.NERF_FWD_RING_DEPTH,
               "albedo_bwd": wg.ALBEDO_BWD_RING_DEPTH,
               "nerf_bwd": wg.NERF_BWD_RING_DEPTH}
from rnb_tpu_torch.utils.bridge import tree_leaves


def timed(fn, iters: int, dev) -> dict:
    """ms a call of ``fn``: one warm call, then three turns of ``iters``
    calls on the host clock, each ended by a synchronise."""
    s = bench.spread([t / iters * 1e3 for t in bench.turns(fn, iters, 1, dev)])
    return {"ms": s["median"], "min": s["min"], "max": s["max"],
            "turns": s["turns"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--json", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = bench.device_or_exit("roofline", args.device)
    peak = (bench.peak_bf16_flops(torch.cuda.get_device_name(dev))
            if dev.type == "cuda" else None)

    statics, rcfg, tcfg = bench.load(bench.CONF, batch=args.batch)
    B = args.batch
    n_pts = B * rcfg.total_samples
    scene = ds.make_sphere_scene(n_views=6, H=256, W=256, radius=0.4, device=dev)
    params0 = bench.init_params(statics, dev)
    gen = bench.draw_generator(dev)
    cpu = torch.Generator().manual_seed(1)
    results = {}

    # --- full step programs (each on a state of its own) ---
    for name, warmup in (("step_main", False), ("step_warm", True)):
        fn = steplib.make_train_step(statics, rcfg, tcfg, warmup=warmup,
                                     no_albedo=False)
        state = bench.fresh_state(params0)
        results[name] = timed(lambda: fn(state, scene.arrays, 0, gen),
                              args.iters, dev)
    params = bench.fresh_state(params0).params

    # --- the SDF core op ---
    pts = (torch.rand(n_pts, 3, generator=cpu) * 1.6 - 0.8).to(dev)
    cw = (torch.randn(n_pts, statics.sdf.d_out - 1, generator=cpu) * 0.01).to(dev)

    def core_fwd():
        with torch.no_grad():
            return sdf_core.sdf_value_feat_grad_fused(statics.sdf, params["sdf"],
                                                      pts)

    results["core_fwd"] = dict(timed(core_fwd, args.iters, dev), n_pts=n_pts)
    sdf_leaves = tree_leaves(params["sdf"])

    def core_fwd_bwd():
        sdf, feat, grad = sdf_core.sdf_value_feat_grad_fused(
            statics.sdf, params["sdf"], pts)
        eik = ((torch.linalg.vector_norm(grad, dim=-1) - 1.0) ** 2).mean()
        loss = sdf.sum() * 1e-3 + (feat * cw).mean() + eik
        return torch.autograd.grad(loss, sdf_leaves)

    results["core_fwd_bwd"] = dict(timed(core_fwd_bwd, args.iters, dev),
                                   n_pts=n_pts)

    # --- render forward (up-sampling + core fwd + compositing, no grad) ---
    rays_o = torch.zeros(B, 3, device=dev) + torch.tensor([0.0, 0.0, -2.5],
                                                          device=dev)
    d = (torch.randn(B, 3, generator=cpu) * 0.05).to(dev) + torch.tensor(
        [0.0, 0.0, 1.0], device=dev)
    rays_d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    a = (rays_d ** 2).sum(-1, keepdim=True)
    b2 = 2.0 * (rays_o * rays_d).sum(-1, keepdim=True)
    mid = 0.5 * (-b2) / a
    near, far = mid - 1.0, mid + 1.0
    lights = torch.nn.functional.normalize(
        torch.randn(3, B, 1, 3, generator=cpu), dim=-1).to(dev)
    t_rand = (torch.rand(B, 1, generator=cpu) - 0.5).to(dev)
    t_out = (torch.rand(B, max(rcfg.n_outside, 1), generator=cpu).to(dev)
             if rcfg.n_outside > 0 else None)

    def render():
        with torch.no_grad():
            return rnd.render_rnb(statics, rcfg, params, rays_o, rays_d, near,
                                  far, lights, t_rand, t_out,
                                  cos_anneal_ratio=1.0, warmup=False)

    results["upsample_render_fwd"] = timed(render, args.iters, dev)

    # --- the albedo op ---
    feat = (torch.randn(n_pts, statics.color.d_feature, generator=cpu) * 0.1).to(dev)
    grad = torch.randn(n_pts, 3, generator=cpu).to(dev)

    def color_fwd():
        with torch.no_grad():
            return rnd.albedo_at(statics, params, pts, grad, grad, feat,
                                 rcfg.kernel_prec)

    results["color_fwd"] = dict(timed(color_fwd, args.iters, dev), n_pts=n_pts)

    # --- Adam on fixed gradients ---
    adam_state = bench.fresh_state(params0)
    for p in tree_leaves(adam_state.params):
        p.grad = p.detach() * 1e-3
    sched = schedules.make_lr_schedule(tcfg.learning_rate, tcfg.warm_up_end,
                                       tcfg.end_iter, tcfg.learning_rate_alpha)
    results["adam"] = timed(lambda: steplib.apply_update(adam_state, sched),
                            args.iters, dev)

    # --- the step's draws and ray / supervision sampling ---
    _, H, W, _ = scene.arrays.normals.shape

    def data_sample():
        px, py, _, _ = steplib.draws(gen, B, H, W, rcfg.n_outside)
        batch = ds.sample_rays_on_all_lights(scene.arrays, 0, px, py)
        return steplib.phase_targets(batch, False, B)

    results["data_sample"] = timed(data_sample, args.iters, dev)

    # --- the analytic FLOPs of the step, in place of XLA's cost analysis ---
    step_ms = results["step_main"]["ms"]
    flops = bench.analytic_step_flops(params0, statics, rcfg, B)["executed"]
    results["step_main"].update({
        "analytic_flops_executed": flops, "bytes": "not counted",
        "peak_bf16_flops": peak,
        "pct_bf16_peak": (flops / (step_ms / 1e3) / peak * 100
                          if peak is not None else None)})

    # residual: the step minus its separately timed regions (they overlap,
    # so this is approximate; a large positive residual is launch and host
    # overhead worth chasing)
    accounted = (results["core_fwd_bwd"]["ms"]
                 + (results["upsample_render_fwd"]["ms"]
                    - results["core_fwd"]["ms"])   # render includes a core fwd
                 + results["color_fwd"]["ms"] * 3  # fwd+bwd ~ 3x fwd
                 + results["adam"]["ms"] + results["data_sample"]["ms"])
    results["residual"] = {
        "ms": step_ms - accounted, "accounted_ms": accounted,
        "comment": ("step_main - (core fwd+bwd, up-sample+compositing, "
                    "~color fwd+bwd, adam, sampling); overlap makes this "
                    "approximate")}
    results["env"] = {
        "flags": steplib.runtime_flags_dict(tcfg), "batch": B,
        "tile": wg.TILE, "ring_depth": RING_DEPTHS, "n_devices": 1,
        "rays_per_s": B / step_ms * 1000.0, "iters": args.iters,
        "card": bench.card_line(dev), "device": dev.type}
    print(json.dumps(results), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
