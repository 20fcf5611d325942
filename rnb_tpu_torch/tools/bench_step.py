"""Sweep of the training step on one CUDA card: ms a step and rays/s at
several ray batches, with and without remat (the port's counterpart of
``tools/bench_step.py``).

    [RNB_SWEEP_BATCHES=512,1024,2048,4096] [RNB_SWEEP_REMAT=0,1] \\
        [RNB_SWEEP_ITERS=60] [RNB_CORE_IMPL=pallas|vjp|fwdmode] \\
        python -m rnb_tpu_torch.tools.bench_step

``confs/wmask_rnb.conf`` on the bench fixture (``rnb_tpu_torch.tools.bench``:
the sphere scene, random weights from seed 0), main phase, on the route the
conf and ``RNB_CORE_IMPL`` resolve to. Per remat setting and batch: a fresh
state, three steps whose seconds are ``compile_s`` (on the first row of a
process they include the first-use nvcc build of the kernels, some 45 s on
an H100) and whose last loss is ``loss3``, then three turns of
``RNB_SWEEP_ITERS`` steps on the host clock, each ended by
``torch.cuda.synchronize()``: the median turn's ``ms_per_step`` and
``rays_per_s``, with the turns' min and max. Prints one JSON line a row,
each with ``remat``, ``core_impl``, the card (nvidia-smi's name and power
limit) and the peak device memory; a row that runs out of device memory
says so (``oom``) and the sweep goes on. Without a CUDA device the tool
exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from rnb_tpu_torch.data import dataset as ds
from rnb_tpu_torch.tools import bench
from rnb_tpu_torch.train import step as steplib

def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    dev = bench.device_or_exit("bench_step", cpu_flag=False)
    iters = int(os.environ.get("RNB_SWEEP_ITERS", "60"))
    batches = [int(b) for b in os.environ.get(
        "RNB_SWEEP_BATCHES", "512,1024,2048,4096").split(",")]
    remats = [v == "1" for v in
              os.environ.get("RNB_SWEEP_REMAT", "0,1").split(",")]
    card = bench.card_line(dev)
    scene = ds.make_sphere_scene(n_views=6, H=256, W=256, radius=0.4, device=dev)

    rows = []
    params0 = None
    for remat in remats:
        for bsz in batches:
            statics, rcfg, tcfg = bench.load(bench.CONF, batch=bsz)
            tcfg = dataclasses.replace(tcfg, remat=remat)
            rcfg = steplib.apply_runtime_flags(rcfg, tcfg)
            if params0 is None:
                params0 = bench.init_params(statics, dev)
            row = {"batch": bsz, "remat": remat, "core_impl": tcfg.core_impl,
                   "iters": iters, "card": card, "device": dev.type}
            torch.cuda.empty_cache()
            bench.reset_peak(dev)
            try:
                row.update(_timed_row(statics, rcfg, tcfg, params0, scene,
                                      iters, dev))
            except torch.cuda.OutOfMemoryError as e:
                row.update(oom=str(e).splitlines()[0],
                           peak_mem_gb=bench.peak_mem_gb(dev))
            rows.append(row)
            print(json.dumps(row), flush=True)
    return {"rows": rows, "flags": steplib.runtime_flags_dict(tcfg),
            "card": card}


def _timed_row(statics, rcfg, tcfg, params0, scene, iters, dev) -> dict:
    fn = steplib.make_train_step(statics, rcfg, tcfg, warmup=False,
                                 no_albedo=False)
    state = bench.fresh_state(params0)
    gen = bench.draw_generator(dev)
    t_c = time.perf_counter()
    for i in range(3):
        _, metrics = fn(state, scene.arrays, i % scene.n_images, gen)
    loss3 = float(metrics["loss"])
    compile_s = time.perf_counter() - t_c
    secs, loss = bench.step_turns(fn, state, scene.arrays, scene.n_images,
                                  gen, iters, 0, dev)
    ms = bench.spread([s / iters * 1e3 for s in secs])
    return {"ms_per_step": ms["median"], "ms_per_step_min": ms["min"],
            "ms_per_step_max": ms["max"], "ms_turns": ms["turns"],
            "rays_per_s": tcfg.batch_size / ms["median"] * 1e3,
            "compile_s": compile_s, "loss3": loss3, "loss": loss,
            "peak_mem_gb": bench.peak_mem_gb(dev)}


if __name__ == "__main__":
    main()
