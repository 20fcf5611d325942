#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rnb_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the four CUDA kernels from rnb_tpu_torch/csrc with nvcc (sm_90a),
then:
  1. checks each kernel against its plain PyTorch version on the card, at
     the main path's point count (512 rays x 128 samples = 65,536) and at a
     ragged one (65,573); f32 operands within 1e-4 and bf16 operands within
     1e-2 of the plain result's norm; times kernel and plain version with
     CUDA events;
  2. drives the training step of confs/wmask_rnb.conf at full width (8x256
     SDF net, 2x256 albedo net, batch 512, 64+64 samples, 3 lights) on the
     sphere fixture: 10 warm-up steps and 10 main-phase steps, every loss
     finite, every kernel's launch count above zero;
  3. runs one main step of 64 rays on the CPU (plain versions) and on the
     card (kernels, f32 operands) from the same params and draws, and
     compares loss, gradients and updated params;
  4. trains 200 warm-up steps on a sphere of radius 0.35: the mean loss of
     the last 20 steps must be below that of the first 20.
It prints the card (nvidia-smi name and power limit), a JSON line of the
kernels, and last {"ok": true, "device": {...}}. Any failed check raises;
there is no fallback: without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

F32_TOL, BF16_TOL = 1e-4, 1e-2
MAIN_N, RAGGED_N = 512 * 128, 65573
CONF = "confs/wmask_rnb.conf"

KERNELS = {
    "sdf_core_fwd": ("rnb_tpu_torch/csrc/sdf_core.cu",
                     "rnb_tpu/ops/pallas_sdf_core.py:169"),
    "sdf_core_bwd": ("rnb_tpu_torch/csrc/sdf_core.cu",
                     "rnb_tpu/ops/pallas_sdf_core.py:232"),
    "albedo_fwd": ("rnb_tpu_torch/csrc/albedo.cu",
                   "rnb_tpu/ops/pallas_albedo.py:85"),
    "albedo_bwd": ("rnb_tpu_torch/csrc/albedo.cu",
                   "rnb_tpu/ops/pallas_albedo.py:101"),
}


def log(msg):
    print(msg, flush=True)


def rel_err(got, want):
    """(max abs error, error norm / reference norm) over tensor lists."""
    mx, num, den = 0.0, 0.0, 0.0
    for a, b in zip(got, want):
        assert a.shape == b.shape, (a.shape, b.shape)
        d = (a - b).float()
        mx = max(mx, d.abs().max().item())
        num += d.pow(2).sum().item()
        den += b.float().pow(2).sum().item()
    return mx, (num ** 0.5) / max(den ** 0.5, 1e-30)


def cuda_ms(fn, iters=10, warm=2):
    for _ in range(warm):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_checks(dev):
    from rnb_tpu_torch.models import fields
    from rnb_tpu_torch.ops import albedo, sdf_core

    gen = torch.Generator().manual_seed(0)
    scfg, acfg = fields.SDFConfig(), fields.RenderingConfig()
    sdf_p = fields.init_sdf_network(gen, scfg, dev)
    for layer in sdf_p:   # off the exact geometric init: every layer carries signal
        layer["v"] = layer["v"] + 0.02 * torch.randn(layer["v"].shape, generator=gen).to(dev)
    alb_p = fields.init_rendering_network(gen, acfg, dev)
    sw = [fields.fold_weight_norm(l).detach() for l in sdf_p]
    sb = [l["b"].detach() for l in sdf_p]
    aw = [fields.fold_weight_norm(l).detach() for l in alb_p]
    ab = [l["b"].detach() for l in alb_p]

    results = {k: {} for k in KERNELS}
    for n in (MAIN_N, RAGGED_N):
        pts = (torch.rand(n, 3, generator=gen) * 1.6 - 0.8).to(dev)
        nrm = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1).to(dev)
        feat = (0.3 * torch.randn(n, acfg.d_feature, generator=gen)).to(dev)
        cs = torch.randn(n, generator=gen).to(dev)
        cf = (0.1 * torch.randn(n, scfg.d_out - 1, generator=gen)).to(dev)
        cg = torch.randn(n, 3, generator=gen).to(dev)
        co = torch.randn(n, acfg.d_out, generator=gen).to(dev)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            calls = {
                "sdf_core_fwd": (
                    lambda: list(sdf_core.sdf_core_fwd(scfg, pts, sw, sb, dtype)),
                    lambda: list(sdf_core.sdf_core_fwd_plain(scfg, pts, sw, sb, dtype))),
                "sdf_core_bwd": (
                    lambda: sum(sdf_core.sdf_core_bwd(scfg, pts, sw, sb, cs, cf, cg, dtype), []),
                    lambda: sum(sdf_core.sdf_core_bwd_plain(scfg, pts, sw, sb, cs, cf, cg, dtype), [])),
                "albedo_fwd": (
                    lambda: [albedo.albedo_fwd(acfg, pts, nrm, feat, aw, ab, dtype)],
                    lambda: [albedo.albedo_fwd_plain(acfg, pts, nrm, feat, aw, ab, dtype)]),
                "albedo_bwd": (
                    lambda: _flat_alb(albedo.albedo_bwd(acfg, pts, nrm, feat, aw, ab, co, dtype)),
                    lambda: _flat_alb(albedo.albedo_bwd_plain(acfg, pts, nrm, feat, aw, ab, co, dtype))),
            }
            for name, (kern, plain) in calls.items():
                got = kern()
                torch.cuda.synchronize()
                want = plain()
                mx, rel = rel_err(got, want)
                tag = f"{name} n={n} {str(dtype).split('.')[-1]}"
                log(f"[kernel] {tag}: max_abs_err={mx:.3e} rel_err={rel:.3e} (tol {tol:g})")
                assert rel <= tol, f"{tag}: rel err {rel} > {tol}"
                if n == MAIN_N and dtype == torch.bfloat16:
                    k_ms, p_ms = cuda_ms(kern), cuda_ms(plain)
                    results[name].update(max_abs_err=mx, rel_err=rel, ms=k_ms,
                                         plain_ms=p_ms)
                    log(f"[time] {tag}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
                del got, want
        del pts, nrm, feat, cs, cf, cg, co
        torch.cuda.empty_cache()
    return results


def _flat_alb(r):
    dws, dbs, cn, cfeat = r
    return list(dws) + list(dbs) + [cn, cfeat]


# ---------------------------------------------------------------------------
# phase 2: the training step of the shipped conf
# ---------------------------------------------------------------------------

def slice_run(dev):
    from rnb_tpu_torch import config
    from rnb_tpu_torch.data import dataset as ds
    from rnb_tpu_torch.models import fields, renderer
    from rnb_tpu_torch.ops import _build
    from rnb_tpu_torch.train import step as steplib

    conf = config.load_conf(CONF)
    statics = fields.statics_from_conf(conf["model"])
    rcfg = renderer.renderer_conf(conf["model"])
    tcfg = steplib.train_conf(conf)
    assert (rcfg.total_samples, rcfg.n_outside, tcfg.batch_size) == (128, 0, 512)
    scene = ds.make_sphere_scene(n_views=6, H=256, W=256, radius=0.4, device=dev)
    params = fields.init_model_bundle(torch.Generator().manual_seed(0), statics, dev)
    state = steplib.init_train_state(params)
    gen = torch.Generator(device=dev).manual_seed(0)
    phases = {}
    for k in _build.launches:
        _build.launches[k] = 0
    for warmup in (True, False):
        fn = steplib.make_train_step(statics, rcfg, tcfg, warmup=warmup, no_albedo=False)
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(10):
            if i == 1:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            state, m = fn(state, scene.arrays, i % scene.n_images, gen)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        losses = torch.stack(losses).cpu()
        name = "warmup" if warmup else "main"
        assert torch.isfinite(losses).all(), f"{name}: non-finite loss {losses}"
        phases[name] = {"first_step_ms": (t1 - t0) * 1e3,
                        "ms_per_step": (t2 - t1) * 1e3 / 9,
                        "loss_first": losses[0].item(), "loss_last": losses[-1].item()}
        log(f"[slice] {name}: {phases[name]}")
    counts = dict(_build.launches)
    log(f"[slice] launches in the 20 steps: {counts}")
    for k, v in counts.items():
        assert v > 0, f"kernel {k} was not launched by the main path"
    return phases, counts


# ---------------------------------------------------------------------------
# phase 3: one step on the CPU (plain versions) vs on the card (kernels)
# ---------------------------------------------------------------------------

def slice_parity(dev):
    from rnb_tpu_torch import config
    from rnb_tpu_torch.data import dataset as ds
    from rnb_tpu_torch.models import fields, renderer
    from rnb_tpu_torch.train import step as steplib
    from rnb_tpu_torch.utils import bridge

    conf = config.load_conf(CONF)
    statics = fields.statics_from_conf(conf["model"])
    rcfg = dataclasses.replace(renderer.renderer_conf(conf["model"]),
                               upsample_prec="f32", kernel_prec="f32")
    # warm_up_end=0: the first update already has the full LR
    tcfg = dataclasses.replace(steplib.train_conf(conf), warm_up_end=0)
    B = 64
    scene = ds.make_sphere_scene(n_views=6, H=256, W=256, radius=0.4)
    params = fields.init_model_bundle(torch.Generator().manual_seed(1), statics)
    rng = np.random.default_rng(2)
    px = torch.tensor(rng.integers(0, 256, B))
    py = torch.tensor(rng.integers(0, 256, B))
    t_rand = torch.tensor(rng.uniform(size=(B, 1)) - 0.5, dtype=torch.float32)

    out = {}
    for where in ("cpu", dev):
        p = bridge.params_from_numpy(bridge.params_to_numpy(params), where)
        arrays = ds.DataArrays(*(a.to(where) for a in scene.arrays))
        state = steplib.init_train_state(p)
        fn = steplib.make_train_step(statics, rcfg, tcfg, warmup=False,
                                     no_albedo=False, batch_size=B)
        state, m = fn(state, arrays, 2, px=px.to(where), py=py.to(where),
                      t_rand=t_rand.to(where))
        leaves = bridge.tree_leaves(state.params)
        out[str(where)] = (m["loss"].item(), [x.grad.detach().cpu() for x in leaves],
                           [x.detach().cpu() for x in leaves])
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out[str(dev)]
    lr = tcfg.learning_rate
    _, grad_rel = rel_err(gg, gc)
    worst = max(((a - b).norm() / max(b.norm(), 1e-30)).item()
                for a, b in zip(gg, gc) if b.norm() > 0)
    dparam = max((a - b).abs().max().item() for a, b in zip(pg, pc))
    log(f"[parity] loss cpu={lc:.7f} gpu={lg:.7f}; grads rel_err={grad_rel:.3e} "
        f"(worst leaf {worst:.3e}); max |param diff|={dparam:.3e} (lr {lr:g})")
    assert abs(lg - lc) <= 1e-4 * abs(lc), "loss differs"
    assert worst <= 1e-3, "gradients differ"
    # Adam's first update is ≈ lr·sign(g): a near-zero gradient may flip it
    assert dparam <= 2 * lr + 1e-6, "updated params differ"
    return {"loss_cpu": lc, "loss_gpu": lg, "grad_rel_err": grad_rel,
            "grad_worst_leaf_rel_err": worst, "max_param_diff": dparam}


# ---------------------------------------------------------------------------
# phase 4: training moves
# ---------------------------------------------------------------------------

def training_moves(dev):
    from rnb_tpu_torch import config
    from rnb_tpu_torch.data import dataset as ds
    from rnb_tpu_torch.models import fields, renderer
    from rnb_tpu_torch.train import step as steplib

    conf = config.load_conf(CONF)
    statics = fields.statics_from_conf(conf["model"])
    rcfg = renderer.renderer_conf(conf["model"])
    tcfg = dataclasses.replace(steplib.train_conf(conf), end_iter=400, warm_up_end=50)
    scene = ds.make_sphere_scene(n_views=6, H=64, W=64, radius=0.35, device=dev)
    state = steplib.init_train_state(
        fields.init_model_bundle(torch.Generator().manual_seed(0), statics, dev))
    gen = torch.Generator(device=dev).manual_seed(42)
    fn = steplib.make_train_step(statics, rcfg, tcfg, warmup=True, no_albedo=False)
    losses = []
    t0 = time.perf_counter()
    for i in range(200):
        state, m = fn(state, scene.arrays, i % scene.n_images, gen)
        losses.append(m["loss"])
    losses = torch.stack(losses).cpu().numpy()
    secs = time.perf_counter() - t0
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    log(f"[train] 200 warm-up steps in {secs:.1f} s: mean loss first 20 "
        f"{first:.5f}, last 20 {last:.5f}")
    assert np.isfinite(losses).all() and last < first, "training did not move"
    return {"loss_first20": first, "loss_last20": last, "seconds": secs}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke runs only on a GPU")
    from rnb_tpu_torch.ops import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({_build.build_info['path']})")

    kern = kernel_checks(dev)
    phases, counts = slice_run(dev)
    parity = slice_parity(dev)
    moves = training_moves(dev)

    summary = {"card": card, "slice": phases, "parity": parity, "train": moves}
    log("[summary] " + json.dumps(summary))
    log(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[k], "max_abs_err": kern[k]["max_abs_err"],
         "ms": kern[k]["ms"], "plain_ms": kern[k]["plain_ms"]}
        for k, (src, rep) in KERNELS.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
