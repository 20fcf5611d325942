"""Where the time of one training step goes, on one CUDA card.

    python -m rnb_tpu_torch.tools.profile_step [--conf confs/wmask_rnb.conf]
        [--set model.neus_renderer.n_outside=4] [--warm 3] [--steps 5]

Full width on the sphere fixture (``make_sphere_scene(n_views=6, H=256,
W=256, radius=0.4)``), random weights from seed 0, main phase. Wall time:
host clock around 10 unprofiled steps ending in ``torch.cuda.synchronize``.
Device time: ``torch.profiler`` over ``--steps`` steps after ``--warm``,
self device time of the device-side events (kernels, copies) by name.
Prints one JSON line: the card (nvidia-smi name and power limit), ms per
step of the ``--top`` largest kernels and of everything else, the device
total, the wall time, the idle share (1 - device / wall) and the peak
device memory. Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from rnb_tpu_torch import config
from rnb_tpu_torch.data import dataset as ds
from rnb_tpu_torch.models import fields, renderer
from rnb_tpu_torch.tools.ablate_kernel import card
from rnb_tpu_torch.train import step as steplib


def device_ms_by_name(prof, runs: int, top: int):
    """(device ms per run, {name: ms per run} of the ``top`` largest and
    "everything else") from a finished ``torch.profiler.profile``: the self
    device time of its device-side events (kernels, copies), annotation
    ranges left out since they overlap the kernels."""
    from torch.autograd import DeviceType

    per = {}
    for ev in prof.key_averages():
        if (ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
                and not ev.is_user_annotation):
            name = ev.key.split("(")[0].replace("void ", "")[:60]
            per[name] = per.get(name, 0.0) + ev.self_device_time_total / 1e3 / runs
    ranked = sorted(per.items(), key=lambda kv: -kv[1])
    out = dict(ranked[:top])
    out["everything else"] = sum(v for _, v in ranked[top:])
    return sum(per.values()), out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--conf", default="confs/wmask_rnb.conf")
    ap.add_argument("--set", action="append", default=[],
                    help="a conf override key=value (repeatable)")
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=12,
                    help="kernels listed by name; the rest are summed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device; it times the card")
    from torch.profiler import ProfilerActivity, profile

    conf = config.load_conf(args.conf)
    for o in args.set:
        config.apply_override(conf, o)
    statics = fields.statics_from_conf(conf["model"])
    tcfg = steplib.train_conf(conf)
    rcfg = steplib.apply_runtime_flags(renderer.renderer_conf(conf["model"]), tcfg)
    fn = steplib.make_train_step(statics, rcfg, tcfg, warmup=False,
                                 no_albedo=False)
    scene = ds.make_sphere_scene(n_views=6, H=256, W=256, radius=0.4)
    state = steplib.init_train_state(
        fields.init_model_bundle(torch.Generator().manual_seed(0), statics))
    gen = torch.Generator(device="cuda").manual_seed(0)
    i = 0

    def run(k):
        nonlocal state, i
        for _ in range(k):
            state, _ = fn(state, scene.arrays, i % scene.n_images, gen)
            i += 1

    run(args.warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(10)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(args.steps)
        torch.cuda.synchronize()
    device, top = device_ms_by_name(prof, args.steps, args.top)
    res = {"card": card(), "conf": args.conf, "set": args.set,
           "flags": steplib.runtime_flags_dict(tcfg),
           "steps": args.steps, "wall_ms_per_step": wall,
           "device_ms_per_step": device, "idle_share": 1.0 - device / wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "kernels_ms_per_step": top}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
