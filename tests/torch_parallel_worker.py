"""Rank worker of tests/test_torch_parallel.py: the port's parallel path in
one rank of a gloo group on the CPU. It imports torch, numpy and the port,
never JAX.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/torch_parallel_worker.py IN.npz OUT_DIR

IN.npz holds the parameter leaves (``param/<i>``, ``tree_leaves`` order) and,
for every case of CASES, this rank's draws of each step
(``<case>/<rank>/<step>/<px|py|t_rand|t_out>``). The rank writes
OUT_DIR/rank<r>.npz: each case's metrics by step, its final parameters and
Adam moments, and the sharded grid of GRID.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from rnb_tpu_torch.data import dataset as tds
from rnb_tpu_torch.models import fields as tfields
from rnb_tpu_torch.models.renderer import RendererConfig
from rnb_tpu_torch.parallel import mesh as meshlib
from rnb_tpu_torch.parallel import train as ptrain
from rnb_tpu_torch.parallel.data import shard_views
from rnb_tpu_torch.parallel.grid import extract_fields_sharded
from rnb_tpu_torch.train import step as tstep
from rnb_tpu_torch.utils import bridge

WORLD = 2
B = 64     # the global batch: 32 rays a rank
SCENE = dict(n_views=3, H=32, W=32, radius=0.4)
SDF = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)
COLOR = dict(d_feature=32, d_hidden=32, n_layers=2, multires_view=2)
NERF = dict(D=4, W=32, multires=4, multires_view=2, skips=(1,))
RENDER = dict(n_samples=12, n_importance=12, up_sample_steps=2,
              upsample_prec="f32")
TRAIN = dict(end_iter=300, warm_up_end=20, batch_size=B)
GRID = dict(resolution=24, chunk=4096, bound=1.0)
DRAWS = ("px", "py", "t_rand", "t_out")
METRICS = ("loss", "color_loss", "eikonal_loss", "mask_loss", "s_val", "cdf",
           "weight_max", "psnr", "lr")
# case: (step, n_outside, warmup, steps); "sharded" and "view" are the
# replicated-data and view-sharded steps; "one_vs_two" runs the sharded
# step on rows of one global draw, for the one-process comparison
CASES = {
    "wmask_warmup": ("sharded", 0, True, 2),
    "wmask_main": ("sharded", 0, False, 2),
    "womask_warmup": ("sharded", 4, True, 2),
    "womask_main": ("sharded", 4, False, 2),
    "view_sharded": ("view", 0, True, 2),
    "one_vs_two": ("sharded", 0, False, 3),
}


def statics(mod):
    return mod.ModelStatics(sdf=mod.SDFConfig(**SDF),
                            color=mod.RenderingConfig(**COLOR),
                            nerf=mod.NeRFConfig(**NERF))


def configs(renderer_cls, train_cls, n_outside: int, **render_kw):
    """(renderer config, train config) of a case: womask cases run at
    mask_weight 0, as the shipped womask conf."""
    return (renderer_cls(**RENDER, n_outside=n_outside, **render_kw),
            train_cls(**TRAIN, mask_weight=0.0 if n_outside else 0.1))


def view_of(case: str, s: int) -> int:
    """The view (or, view-sharded, the slot) of step s."""
    return s if CASES[case][0] == "view" else s % SCENE["n_views"]


def load_params(inp, st):
    params = tfields.init_model_bundle(torch.Generator().manual_seed(0), st, "cpu")
    with torch.no_grad():
        for i, p in enumerate(bridge.tree_leaves(params)):
            p.copy_(torch.from_numpy(inp[f"param/{i}"]))
    return params


def main(inp_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    assert meshlib.maybe_initialize_distributed("cpu")
    rank, world = meshlib.rank(), meshlib.world()
    assert world == WORLD, world
    inp = np.load(inp_path)
    st = statics(tfields)
    scene = tds.make_sphere_scene(**SCENE, device="cpu")
    out = {}
    for case, (kind, n_outside, warmup, steps) in CASES.items():
        rcfg, tcfg = configs(RendererConfig, tstep.TrainConfig, n_outside,
                             kernel_prec="f32")
        make = (ptrain.make_view_sharded_train_step if kind == "view"
                else ptrain.make_sharded_train_step)
        fn = make(st, rcfg, tcfg, warmup=warmup, no_albedo=False)
        arrays = (shard_views(scene, rank, world) if kind == "view"
                  else scene.arrays)
        state = tstep.init_train_state(load_params(inp, st))
        for s in range(steps):
            draws = {k: torch.from_numpy(inp[f"{case}/{rank}/{s}/{k}"])
                     for k in DRAWS if f"{case}/{rank}/{s}/{k}" in inp}
            state, m = fn(state, arrays, view_of(case, s), **draws)
            out[f"{case}/metrics/{s}"] = np.array([float(m[k]) for k in METRICS])
        mu, nu, _ = bridge.adam_state_to_numpy(state.optimizer, state.params)
        for name, tree in (("param", bridge.params_to_numpy(state.params)),
                           ("mu", mu), ("nu", nu)):
            for i, a in enumerate(bridge.tree_leaves(tree)):
                out[f"{case}/{name}/{i}"] = a
    params = load_params(inp, st)
    out["grid"] = extract_fields_sharded(
        st, params, [-GRID["bound"]] * 3, [GRID["bound"]] * 3,
        GRID["resolution"], chunk=GRID["chunk"])
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
