"""Training throughput of the port on one CUDA card: rays/s and MFU of a
shipped conf's step (the port's counterpart of the root ``bench.py``).

    python -m rnb_tpu_torch.tools.bench [--conf confs/wmask_rnb.conf]
        [--set key=value ...] [--device cuda|cpu]

Full width on the sphere fixture of ``bench.py``
(``make_sphere_scene(n_views=6, H=256, W=256, radius=0.4)``), random
weights from seed 0 (a CPU generator), draws from a generator seeded 0 on
the device, as ``profile_step`` seeds them. Rows:

  * main-phase rays/s at the conf's batch (512 rays, 64+64 samples, 3
    lights on the shipped wmask conf): the headline ``value``;
  * warm-up-phase rays/s;
  * view-sharded rays/s: ``parallel.train.make_view_sharded_train_step`` on
    a one-rank process group started in-process (NCCL on the card, gloo on
    the CPU), as ``bench.py`` runs it on a one-device mesh; skipped by
    ``RNB_BENCH_VIEW_SHARD=0``;
  * the batch curve at 2048 and 8192 rays, main phase, each with its peak
    device memory; skipped by ``RNB_BENCH_BATCH_CURVE=0``.

Each row is three turns of ``RNB_BENCH_ITERS`` steps (default 120; the
view-sharded row max(20, iters/2), a curve row max(8, iters·512/batch))
after warm-up steps, each turn timed on the host clock and ended by
``torch.cuda.synchronize()``; the row reports the median turn, with the
min and max beside it (``turns``): the walls move between and within calls.

MFU: ``analytic_step_flops`` (the root ``bench.py``'s FLOP model, on the
port's parameter tree, plus the background NeRF when ``n_outside > 0``)
over the median main step, against the bf16 dense peak of the card by its
name (``PEAK_BF16_FLOPS``; an unknown card exits non-zero). Prints one
JSON line with the root tool's names plus ``card`` (nvidia-smi's name and
power limit), ``device`` and the peak device memory. Without a CUDA device
it exits non-zero unless given ``--device cpu``, which runs the control
flow at whatever size the conf says: its line says ``"device": "cpu"`` and
holds no MFU share (a CPU time is no device metric).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time

import numpy as np
import torch

from rnb_tpu_torch import config
from rnb_tpu_torch.data import dataset as ds
from rnb_tpu_torch.models import fields, renderer
from rnb_tpu_torch.tools.ablate_kernel import card
from rnb_tpu_torch.train import step as steplib
from rnb_tpu_torch.utils.bridge import tree_map

# the shipped wmask conf, from the repository root
CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "confs", "wmask_rnb.conf")
REFERENCE_RAYS_PER_S = 2816.0   # the root bench.py's CUDA-reference baseline
# bf16 dense tensor-core peak (no sparsity) by torch.cuda.get_device_name(),
# from NVIDIA's H100 and H200 data sheets
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,   # SXM5
    "NVIDIA H100 SXM5 80GB": 989e12,
    "NVIDIA H100 NVL": 835e12,
    "NVIDIA H100 PCIe": 756e12,
    "NVIDIA H200": 989e12,
}
CURVE_BATCHES = (2048, 8192)
TURNS = 3


def peak_bf16_flops(name: str) -> float:
    """The card's bf16 dense peak; an unknown card exits non-zero naming it
    (no default peak)."""
    if name not in PEAK_BF16_FLOPS:
        raise SystemExit(f"no bf16 peak known for the card {name!r}; add it "
                         "to rnb_tpu_torch.tools.bench.PEAK_BF16_FLOPS from "
                         "its data sheet")
    return PEAK_BF16_FLOPS[name]


def analytic_step_flops(params, statics, rcfg, bsz: int) -> dict:
    """Analytic FLOPs of one main-phase train step from the weight shapes
    (the root ``bench.py``'s model, unchanged in its arithmetic):

    executed: what the production kernels run —
      SDF core  8 passes/pt (fwd: primal + reverse grad sweep; bwd:
                primal+tangent recompute, dW, bar propagation x2 slabs)
      albedo    4 passes/pt (fwd; bwd: recompute, dW, bar)
      up-sample 1 inference pass over the no-grad sweep points
    model: the recompute-free minimum (core 6, albedo 3).

    With ``n_outside > 0`` the background NeRF runs on every ray's core
    and outside samples, bsz·(core samples + n_outside) points (67,584 at
    the womask conf): executed 4 passes (fwd; the params-only bwd:
    recompute, dW, bar), model 3. The root tool counts no NeRF; with
    ``n_outside = 0`` the result equals its own."""
    def pass_flops(layer_list):
        return 2.0 * sum(np.prod(_w_shape(l)) for l in layer_list)

    def _w_shape(layer):
        return tuple((layer["v"] if "v" in layer else layer["w"]).shape)

    f_sdf = pass_flops(params["sdf"])
    # sdf_only slices the head to 1 column
    last = _w_shape(params["sdf"][-1])
    f_sdf_only = f_sdf - 2.0 * last[0] * (last[1] - 1)
    f_alb = pass_flops(params["color"])

    n_core = bsz * (rcfg.total_samples if rcfg.n_importance > 0
                    else rcfg.n_samples)
    if rcfg.n_importance > 0:
        per_round = rcfg.n_importance // max(rcfg.up_sample_steps, 1)
        n_up = bsz * rcfg.n_samples + bsz * per_round * max(
            rcfg.up_sample_steps - 1, 0)
    else:
        n_up = 0   # the renderer skips up-sampling entirely

    executed = n_core * (8.0 * f_sdf + 4.0 * f_alb) + n_up * f_sdf_only
    model = n_core * (6.0 * f_sdf + 3.0 * f_alb) + n_up * f_sdf_only
    if rcfg.n_outside > 0:
        nerf = params["nerf"]
        f_nerf = pass_flops([*nerf["pts_layers"], nerf["alpha_layer"],
                             nerf["feature_layer"], nerf["views_layer"],
                             nerf["rgb_layer"]])
        n_bg = n_core + bsz * rcfg.n_outside
        executed += n_bg * 4.0 * f_nerf
        model += n_bg * 3.0 * f_nerf
    return {"executed": executed, "model": model}


# ---------------------------------------------------------------------------
# shared by the measuring tools (bench_step, roofline, bench_scaling)
# ---------------------------------------------------------------------------

def device_or_exit(tool: str, name: str = "cuda",
                   cpu_flag: bool = True) -> torch.device:
    """The device to run on: ``cuda`` needs a CUDA device, else the tool
    exits non-zero; ``cpu`` only where asked for (``cpu_flag``: the tool
    takes ``--device cpu``)."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device; it times the card"
                         + (" (--device cpu runs its control flow only)"
                            if cpu_flag else ""))
    return torch.device(name)


def card_line(dev: torch.device):
    """nvidia-smi's name and power limit of the card, None on the CPU."""
    return card() if dev.type == "cuda" else None


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def load(conf_path: str, sets=(), batch: int | None = None):
    """(statics, renderer config, train config) of a conf with ``--set``
    overrides, the runtime flags applied; ``batch`` replaces the batch."""
    conf = config.load_conf(conf_path)
    for o in sets:
        config.apply_override(conf, o)
    tcfg = steplib.train_conf(conf)
    if batch is not None:
        tcfg = dataclasses.replace(tcfg, batch_size=batch)
    rcfg = steplib.apply_runtime_flags(renderer.renderer_conf(conf["model"]), tcfg)
    return fields.statics_from_conf(conf["model"]), rcfg, tcfg


def init_params(statics, dev: torch.device):
    """Random weights from seed 0 (a CPU generator), on ``dev``."""
    return fields.init_model_bundle(torch.Generator().manual_seed(0), statics,
                                    dev)


def fresh_state(params0):
    """A train state on a copy of ``params0`` (the step updates in place)."""
    return steplib.init_train_state(tree_map(lambda t: t.detach().clone(),
                                             params0))


def draw_generator(dev: torch.device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def spread(values) -> dict:
    """Median, min and max of the turns, and the turns."""
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values), "turns": list(values)}


def turns(fn, iters: int, warm: int, dev: torch.device) -> list:
    """Seconds of each of TURNS turns of ``iters`` calls of ``fn`` on the
    host clock, after ``warm`` calls; each turn ends in a synchronise."""
    for _ in range(warm):
        fn()
    sync(dev)
    secs = []
    for _ in range(TURNS):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync(dev)
        secs.append(time.perf_counter() - t0)
    return secs


def step_turns(fn, state, arrays, n_images: int, gen, iters: int, warm: int,
               dev: torch.device) -> tuple:
    """``turns`` of a step function over the views in turn. -> (seconds a
    turn, the last loss)."""
    i, last = 0, {}

    def one():
        nonlocal i
        _, last["metrics"] = fn(state, arrays, i % n_images, gen)
        i += 1

    secs = turns(one, iters, warm, dev)
    return secs, float(last["metrics"]["loss"])


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_mem_gb(dev: torch.device):
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None


# ---------------------------------------------------------------------------
# the rows
# ---------------------------------------------------------------------------

def rays_row(fn, params0, scene, dev, bsz: int, iters: int, warm: int) -> dict:
    """rays/s of one step program: the spread over the turns and the last
    loss."""
    state = fresh_state(params0)
    secs, loss = step_turns(fn, state, scene.arrays, scene.n_images,
                            draw_generator(dev), iters, warm, dev)
    return dict(spread([iters * bsz / s for s in secs]), loss=loss)


def view_shard_row(statics, rcfg, tcfg, params0, scene, dev, iters: int) -> dict:
    """The view-sharded step on a one-rank process group started here (and
    ended here), unless the process is in a group already."""
    import torch.distributed as dist

    from rnb_tpu_torch.parallel.data import shard_views
    from rnb_tpu_torch.parallel.train import make_view_sharded_train_step
    from rnb_tpu_torch.tools.multinode_smoke import free_port

    started = not dist.is_initialized()
    if started:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
    try:
        arrays = shard_views(scene.arrays, dist.get_rank(), dist.get_world_size())
        fn = make_view_sharded_train_step(statics, rcfg, tcfg, warmup=False,
                                          no_albedo=False)
        state = fresh_state(params0)
        n3 = max(20, iters // 2)
        secs, loss = step_turns(fn, state, arrays, arrays.normals.shape[0],
                                draw_generator(dev), n3, 3, dev)
        return dict(spread([n3 * tcfg.batch_size / s / dist.get_world_size()
                            for s in secs]), loss=loss, iters=n3)
    finally:
        if started:
            dist.destroy_process_group()


def mfu_block(fl: dict, step_ms: float, peak) -> dict:
    """The root tool's ``mfu`` block on one device; the shares need the
    card's peak (None on the CPU)."""
    out = {"step_ms": step_ms, "analytic_flops_executed_per_chip": fl["executed"],
           "analytic_flops_model_per_chip": fl["model"],
           "peak_bf16_flops": peak, "mfu_executed_pct": None,
           "mfu_model_pct": None, "flops_ideal_ms": None,
           "pct_of_flops_ideal": None}
    if peak is not None:
        ideal_ms = fl["executed"] / peak * 1e3
        out.update(mfu_executed_pct=fl["executed"] / (step_ms * 1e-3) / peak * 100,
                   mfu_model_pct=fl["model"] / (step_ms * 1e-3) / peak * 100,
                   flops_ideal_ms=ideal_ms, pct_of_flops_ideal=step_ms / ideal_ms)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--conf", default=CONF)
    ap.add_argument("--set", action="append", default=[],
                    help="a conf override key=value (repeatable)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = device_or_exit("bench", args.device)
    peak = (peak_bf16_flops(torch.cuda.get_device_name(dev))
            if dev.type == "cuda" else None)
    iters = int(os.environ.get("RNB_BENCH_ITERS", "120"))

    statics, rcfg, tcfg = load(args.conf, args.set)
    bsz = tcfg.batch_size
    scene = ds.make_sphere_scene(n_views=6, H=256, W=256, radius=0.4, device=dev)
    params0 = init_params(statics, dev)

    def step(warmup, t=tcfg):
        return steplib.make_train_step(statics, rcfg, t, warmup=warmup,
                                       no_albedo=False)

    reset_peak(dev)
    main_row = rays_row(step(False), params0, scene, dev, bsz, iters, 3)
    main_mem = peak_mem_gb(dev)
    warm_row = rays_row(step(True), params0, scene, dev, bsz, iters, 3)
    view_row = None
    if os.environ.get("RNB_BENCH_VIEW_SHARD", "1") == "1":
        view_row = view_shard_row(statics, rcfg, tcfg, params0, scene, dev,
                                  iters)

    batch_curve = []
    if os.environ.get("RNB_BENCH_BATCH_CURVE", "1") == "1":
        for b in CURVE_BATCHES:
            t2 = dataclasses.replace(tcfg, batch_size=b)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            reset_peak(dev)
            n2 = max(8, (iters * 512) // b)
            row = rays_row(step(False, t2), params0, scene, dev, b, n2, 2)
            batch_curve.append({"batch": b, "rays_per_s_per_chip": row["median"],
                                "min": row["min"], "max": row["max"],
                                "iters": n2, "peak_mem_gb": peak_mem_gb(dev),
                                "loss": row["loss"]})

    step_ms = bsz / main_row["median"] * 1000.0
    fl = analytic_step_flops(params0, statics, rcfg, bsz)
    samples = rcfg.total_samples if rcfg.n_importance > 0 else rcfg.n_samples
    res = {
        "metric": "train_rays_per_s_per_chip",
        "value": main_row["median"],
        "unit": (f"rays/s/chip (main phase, batch {bsz}, {samples} samples, "
                 "3 lights)"),
        "vs_baseline": main_row["median"] / REFERENCE_RAYS_PER_S,
        "warmup_phase_rays_per_s_per_chip": warm_row["median"],
        "view_shard_rays_per_s_per_chip": view_row and view_row["median"],
        "mfu": mfu_block(fl, step_ms, peak),
        "batch_curve": batch_curve,
        "flags": steplib.runtime_flags_dict(tcfg),
        "n_devices": 1,
        "turns": {"main": main_row, "warmup": warm_row, "view_shard": view_row},
        "iters": iters,
        "peak_mem_gb": main_mem,
        "card": card_line(dev),
        "device": dev.type,
        "conf": args.conf, "set": args.set,
    }
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
