"""Accuracy of a precision setting (the port's copy of
``tools/validate_precision.py``): train the synthetic sphere (radius 0.35,
not the geometric init's 0.5, so training has to move the surface) through
the port's step at full width, extract a mesh, report the radius error and
the losses.

    python -m rnb_tpu_torch.tools.validate_precision [--device cuda|cpu]
        [--seed S]
    RNB_UPSAMPLE_PREC=f32 python -m rnb_tpu_torch.tools.validate_precision

The conf's runtime knobs come through ``resolve_runtime_flags`` (the
``RNB_*`` environment variables win) and ``apply_runtime_flags``;
``RNB_VALIDATE_STEPS`` sets the step count (400). ``--seed S`` seeds the
initial weights with S and the ray draws with 42 + S (0: the JAX tool's
keys), so that a setting can be read over several seeds. Prints one JSON line:
the effective flags and the accuracy numbers. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="accuracy of a precision setting")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    steps = int(os.environ.get("RNB_VALIDATE_STEPS", "400"))
    radius = 0.35

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu to run on the CPU")

    from rnb_tpu_torch.data import dataset as ds
    from rnb_tpu_torch.models import fields, renderer
    from rnb_tpu_torch.models.renderer import RendererConfig
    from rnb_tpu_torch.ops import marching_cubes as mc
    from rnb_tpu_torch.train import step as train_step

    dev = args.device
    scene = ds.make_sphere_scene(n_views=6, H=64, W=64, radius=radius,
                                 device=dev)
    statics = fields.ModelStatics(sdf=fields.SDFConfig(),
                                  color=fields.RenderingConfig(),
                                  nerf=fields.NeRFConfig())
    tcfg = train_step.resolve_runtime_flags(
        train_step.TrainConfig(end_iter=steps, warm_up_end=50, batch_size=512))
    rcfg = train_step.apply_runtime_flags(RendererConfig(), tcfg)
    state = train_step.init_train_state(fields.init_model_bundle(
        torch.Generator().manual_seed(args.seed), statics, dev))
    fn = train_step.make_train_step(statics, rcfg, tcfg, warmup=True,
                                    no_albedo=False)
    gen = torch.Generator(device=dev).manual_seed(42 + args.seed)
    first_loss = None
    t0 = time.perf_counter()
    for i in range(steps):
        state, m = fn(state, scene.arrays, i % scene.n_images, gen)
        if i == 0:
            first_loss = float(m["loss"])
            t0 = time.perf_counter()   # the first step's build excluded
    last_loss = float(m["loss"])
    psnr = float(m["psnr"])
    dt = time.perf_counter() - t0

    with torch.no_grad():
        grid = renderer.extract_fields(statics, state.params, [-1.01] * 3,
                                       [1.01] * 3, 96)
    v, _ = mc.extract_geometry(grid, [-1.01] * 3, [1.01] * 3, 0.0)
    r = np.linalg.norm(v, axis=-1)
    flags = train_step.runtime_flags_dict(tcfg)
    print(json.dumps({
        "matmul_precision": flags["matmul_precision"],
        "upsample_prec": flags["upsample_precision"],
        "remat": flags["remat"],
        "kernel_prec": rcfg.kernel_prec,
        "device": dev,
        "seed": args.seed,
        "steps": steps,
        "first_loss": first_loss,
        "last_loss": last_loss,
        "psnr": psnr,
        "radius_err_mean": float(abs(r.mean() - radius)),
        "radius_std": float(r.std()),
        "steps_per_s": (steps - 1) / dt if steps > 1 else None,
    }))


if __name__ == "__main__":
    main()
