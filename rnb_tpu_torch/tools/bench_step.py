"""Batch sweep of the training step on one CUDA card: ms a step and rays/s
at several ray batches (the port's counterpart of ``tools/bench_step.py``).

    [RNB_SWEEP_BATCHES=512,1024,2048,4096] [RNB_SWEEP_ITERS=60] \\
        python -m rnb_tpu_torch.tools.bench_step

``confs/wmask_rnb.conf`` on the bench fixture (``rnb_tpu_torch.tools.bench``:
the sphere scene, random weights from seed 0), main phase. Per batch: a fresh state, three steps
whose seconds are ``compile_s`` (on the first row of a process they include
the first-use nvcc build of the kernels, some 45 s on an H100) and whose
last loss is ``loss3``, then three turns of ``RNB_SWEEP_ITERS`` steps on
the host clock, each ended by ``torch.cuda.synchronize()``: the median
turn's ``ms_per_step`` and ``rays_per_s``, with the turns' min and max.
Prints one JSON line a batch, each with the card (nvidia-smi's name and
power limit) and the peak device memory.

The JAX tool also sweeps ``remat``; the port refuses ``remat = true`` by
name (``models/renderer.py`` ``refuse_unsupported``), so
``RNB_SWEEP_REMAT`` with a 1 in it exits non-zero saying so. Without a
CUDA device the tool exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from rnb_tpu_torch.data import dataset as ds
from rnb_tpu_torch.tools import bench
from rnb_tpu_torch.train import step as steplib

def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if "1" in os.environ.get("RNB_SWEEP_REMAT", "0").split(","):
        raise SystemExit("bench_step: RNB_SWEEP_REMAT asks for remat = true, "
                         "which the port refuses (models/renderer.py "
                         "refuse_unsupported); sweep batches only")
    dev = bench.device_or_exit("bench_step", cpu_flag=False)
    iters = int(os.environ.get("RNB_SWEEP_ITERS", "60"))
    batches = [int(b) for b in os.environ.get(
        "RNB_SWEEP_BATCHES", "512,1024,2048,4096").split(",")]
    card = bench.card_line(dev)
    scene = ds.make_sphere_scene(n_views=6, H=256, W=256, radius=0.4, device=dev)

    rows = []
    params0 = None
    for bsz in batches:
        statics, rcfg, tcfg = bench.load(bench.CONF, batch=bsz)
        if params0 is None:
            params0 = bench.init_params(statics, dev)
        fn = steplib.make_train_step(statics, rcfg, tcfg, warmup=False,
                                     no_albedo=False)
        state = bench.fresh_state(params0)
        gen = bench.draw_generator(dev)
        torch.cuda.empty_cache()
        bench.reset_peak(dev)
        t_c = time.perf_counter()
        for i in range(3):
            _, metrics = fn(state, scene.arrays, i % scene.n_images, gen)
        loss3 = float(metrics["loss"])
        compile_s = time.perf_counter() - t_c
        secs, loss = bench.step_turns(fn, state, scene.arrays, scene.n_images,
                                      gen, iters, 0, dev)
        ms = bench.spread([s / iters * 1e3 for s in secs])
        rows.append({"batch": bsz, "ms_per_step": ms["median"],
                     "ms_per_step_min": ms["min"], "ms_per_step_max": ms["max"],
                     "ms_turns": ms["turns"],
                     "rays_per_s": bsz / ms["median"] * 1e3,
                     "compile_s": compile_s, "loss3": loss3, "loss": loss,
                     "iters": iters, "peak_mem_gb": bench.peak_mem_gb(dev),
                     "card": card, "device": dev.type})
        print(json.dumps(rows[-1]), flush=True)
        del state
    return {"rows": rows, "flags": steplib.runtime_flags_dict(tcfg),
            "card": card}


if __name__ == "__main__":
    main()
