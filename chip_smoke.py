#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rnb_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

(``chip_smoke.py --grid-worker CASE EXP OUT`` is one rank of phase 8's grid
check; the smoke starts it under torch.distributed.run itself.)

Builds the CUDA kernels from rnb_tpu_torch/csrc with nvcc (sm_90a), then:
  1. checks each kernel against its plain PyTorch version on the card, at
     its main path's point count and at a ragged one: the SDF core and
     albedo at 512 rays x 128 samples = 65,536 and 65,573, the background
     NeRF at 512 x (128 + 4) = 67,584 and 67,617 (the SDF core and the
     albedo and NeRF forwards and backwards on both routes: bf16 on the
     tensor cores, f32 on the CUDA cores), the four SDF-forward ablation
     variants of both routes at 65,536, the bf16 backwards' grouped dW
     product (csrc/dw_gemm.cu) for one 256x256 layer over 2 x 65,536 rows
     and for every layer of each backward in one launch (the SDF core's 9
     over 2 x 65,536 rows, the albedo's 3 over 65,536, the NeRF's 11 over
     67,584); f32 operands within 1e-4 and bf16 operands within 1e-2 of
     the plain result's norm, the bf16 SDF backward (the TMA-fed sweep
     and its dW products) also bit for bit from call to call; times kernel
     and plain version with CUDA events (and torch.matmul beside each dW
     product, one a layer, as its yardstick);
  2. drives the training step at full width (8x256 SDF net, 2x256 albedo
     net, batch 512, 64+64 samples, 3 lights) on the sphere fixture, for
     confs/wmask_rnb.conf and for confs/womask_rnb.conf with n_outside=4
     (the 8x256 background NeRF on 4 outside samples, mask_weight 0): 10
     warm-up and 10 main-phase steps each, every loss finite, each kernel
     of the path launched, every op with two routes on its bf16
     (tensor-core) kernels only, one dW launch a bf16 backward (counts set
     to 0 before each path, read after; phases 6, 8, 9 and 10 hold their
     runs' counts to the same);
  3. runs one main step of 64 rays on the CPU (plain versions) and on the
     card (kernels, f32 operands: the f32 routes) from the same params and
     draws, for each of the two confs, and compares loss, gradients and
     updated params;
  4. trains 200 warm-up steps of each conf on a sphere of radius 0.35: the
     mean loss of the last 20 steps must be below that of the first 20;
  5. runs the kernel-ablation entry point
     (python -m rnb_tpu_torch.tools.ablate_kernel) and checks that it went
     through the ablation kernel;
  6. drives the runner path as a user would, in subprocesses: writes a
     sphere case (radius 0.35, 6 views, 256x256) with
     python -m rnb_tpu_torch.tools.make_synthetic_case, trains
     confs/wmask_rnb.conf on it for 400 steps (300 warm-up) with
     python -m rnb_tpu_torch.cli --mode train_rnb at full width, and checks
     the checkpoints at 200 and 400, the validation and normal images, the
     mesh at 400 (vertex radius 0.35 +- 0.02, std < 0.02), a falling and
     finite loss, the training kernels' launches in that run, the port's
     acceptance gate (Chamfer-L1 <= 0.02), and a resume from the step-200
     checkpoint whose step-201 loss equals the first run's within 1e-6
     relative; then times the grid query and marching cubes at 128^3 and
     512^3 on the trained weights;
  7. drives the inference path on that experiment, in subprocesses of the
     CLI: --mode validate_mesh_texture at 128^3 (vertex colours in [0, 1],
     radius 0.35 +- 0.02, mean colour R > G > B as the case's albedo),
     --mode validate_image_ps (3 PNGs, the PSNR of render against
     supervision through rnb_tpu_torch.tools.compare_images, finite) and
     --mode interpolate_0_1 (120 frames of 64x64 read back, frame k equal
     to frame 119 - k; the time a frame and rays/s); each launches the SDF
     core's and albedo's bf16 forwards and nothing else. Then a Runner on
     confs/womask_rnb.conf with n_outside=4, random weights, renders a
     novel view on the card through the bf16 NeRF forward too (finite);
     a frame of each conf is timed with the weight norm folded once a
     render and by every op call (in turns, equal frames) and profiled, and
     one 64-ray chunk of `render` on the card
     at f32 operands (the f32 routes) is held within 1e-4 of the CPU's for
     each conf;
  8. drives the parallel path on phase 6's case, the CLI launched by
     python -m torch.distributed.run --standalone (subprocesses; any rank's
     failure fails the smoke): (1) confs/wmask_rnb.conf at full width on
     two ranks sharing the card (RNB_DIST_BACKEND=gloo), global batch 512,
     40 steps (20 warm-up) and a 128^3 mesh through the sharded grid,
     against the same 40 steps in one process without a group: per-step
     losses within 1e-3 relative (bf16 kernels; the dW sums run over other
     row counts), the ranks' parameter digests equal, each rank's own
     counters showing the four wmask bf16 kernels and their dW products,
     and the sharded grid at 128^3 (chip_smoke.py --grid-worker under two
     ranks) within 1e-3 of the one-process extract_fields on the same
     weights; (2) the same run with train.view_shard=true: each rank loads
     only its 3 views, finite losses, one scalars.jsonl and one checkpoint
     set; (3) confs/womask_rnb.conf with n_outside=4, 10 steps, two ranks
     against one process within 1e-3 (the NeRF kernels under the group);
     (4) one rank with RNB_DIST_BACKEND=nccl (world 1: the collective path
     on NCCL), 10 steps against the one-process run within 1e-5. It prints
     each run's wall and ms a step beside the card; two ranks on one card
     are not a scaling figure;
  9. runs phases 2-3 for confs/wmask_rnb_noalbedo.conf and
     confs/womask_rnb_noalbedo.conf (n_outside=4) with no_albedo: finite
     losses, the card step within 1e-4 of the CPU's, no albedo kernel
     launched on either route, the SDF core (and NeRF) as often as in the
     albedo confs' steps; writes a 612x512, 8-view degraded torus at
     (0.15, -0.1, 0.08) with make_synthetic_case --normalize (the
     normalization on the card), normalizes un-normalized copies of it
     in-process on the card and on the CPU and through python -m
     rnb_tpu_torch.preprocess.preprocess_cameras: all four scale mats
     within 1e-9 of the CPU's relative to its norm, scale != 1, centre
     within 0.05 of the world centre; trains the wmask no-albedo conf on
     it through the CLI for 400 steps (300 warm-up): no albedo kernel
     launched, the colour net of the last checkpoint bit-identical to its
     initial value and the SDF net moved; writes the world-space mesh with
     --mode validate_mesh at 128^3 (bounding-box centre within 0.05 of the
     world centre), runs python -m rnb_tpu_torch.tools.eval_chamfer on it
     against the analytic torus (finite) and
     python -m rnb_tpu_torch.tools.inspect_cameras on the case (8 views);
 10. drives the resume-and-launch tools as a user would, in subprocesses,
     in three lanes at once on the one card, on phase 6's case (the gate
     tool writes a copy of its own): python -m
     rnb_tpu_torch.tools.run_e2e at a cut
     schedule (600 steps, 400 warm-up, a checkpoint every 200, SIGTERM to
     the trainer once ckpt_000200.npz exists, the resume from it with
     "Find checkpoint" logged, a 128^3 mesh, the sphere gate at 0.02);
     rnb_tpu_torch/jobs/train_h100.sh with N_ITERATIONS=20 (20 logged
     steps, the tee'd log); rnb_tpu_torch/jobs/train_h100_multi.sh with
     two ranks sharing the card (gloo by the backend rule, 20 steps,
     equal parameter digests); python -m
     rnb_tpu_torch.tools.multinode_smoke with one rank a node on the
     card (RNB_DIST_BACKEND=gloo; frozen parameters): two nodes within
     1e-5 of one process, view sharding, a two-node resume within 1e-6;
     each run that ends launches the wmask bf16 kernels and no f32 route;
 11. runs the measuring tools through their main(argv) in this process, at
     a cut depth: rnb_tpu_torch.tools.bench (RNB_BENCH_ITERS=10, the
     view-sharded row on a one-rank NCCL group, the batch curve at 2048
     and 8192 with its peak memory; MFU in (0, 100]), bench_step at
     batches 512 and 2048, roofline at --iters 10 (every region, the
     residual, the share of the bf16 peak), tune_kernel at ring depths 3
     and 4 and split counts 64 and 32 (the tune library, built beside
     phases 1-10: both depths bit for bit the production kernels and
     within 1e-2 of the plain version), bench_scaling at width 1 (one
     torchrun rank on NCCL, no efficiency figure), and consolidate_parity
     on phase 10's directory (the cut e2e gate's row passes, the other
     five gates are missing rows); every time finite and positive, every
     line with the card. At the build it holds the production SDF-core
     kernels' ptxas lines against the note in csrc/sdf_core.cu and the dW
     kernel's against csrc/dw_gemm.cu, and checks that the production
     library holds no tune instance.
It prints the card (nvidia-smi name and power limit), a JSON line of the
kernels, and last {"ok": true, "device": {...}}. In that line `launches`
counts each kernel's launches on its path (the wmask step for the SDF core's
bf16 route, its dW product and albedo, the wmask parity step for the f32
routes of the SDF core and albedo, the womask step for the NeRF and the
womask parity step for its f32 route, the ablation run for the ablation
variants) plus its launches in every rank of phase 8's group runs, in
phase 9 (the no-albedo steps, parity steps and CLI run), in phase 10's
runs that end (the killed leg prints none) and in phase 11's tools; the
tune instances phase 11 launched (sdf_core_fwd_rs3, ...: the SDF core's
sweeps at ring depth 3 and 4 from the tune library) follow, with the
sweep's own error and CUDA-event time and the plain time and bound of the
production kernel whose work they do; `ms` /
`plain_ms` are at the main-path shape with the
route's operands (bf16 unless named f32; the bf16 albedo and NeRF kernels
on the weight image their op packs once a step; for the ablation kernel:
one launch of each of its four variants), `bound_ms` is the larger of the
least bytes (inputs read once, outputs written once) over 3.35 TB/s and the
least multiply-adds over the peak of their type (989 TFLOP/s bf16 on the
tensor cores, 67 TFLOP/s f32 on the CUDA cores), from this run's shapes,
and `library_ms` the time of torch.matmul on the dW product's operands
(null where no single PyTorch call computes the kernel's function). The
summary line's `dw_products` holds the three backwards' dW groups (one
launch each: the SDF core's 9 products over 131,072 rows, the albedo's 3
over 65,536, the NeRF's 11 over 67,584), each held against its plain
products and timed beside one torch.matmul a product.
Any failed check raises; there is no fallback: without a CUDA device it
exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch

F32_TOL, BF16_TOL = 1e-4, 1e-2
MAIN_N, RAGGED_N = 512 * 128, 65573
NERF_N, NERF_RAGGED_N = 512 * (128 + 4), 67617
WMASK = ("confs/wmask_rnb.conf", ())
WOMASK = ("confs/womask_rnb.conf", ("model.neus_renderer.n_outside=4",))
WMASK_NOALB = ("confs/wmask_rnb_noalbedo.conf", ())
WOMASK_NOALB = ("confs/womask_rnb_noalbedo.conf",
                ("model.neus_renderer.n_outside=4",))
WMASK_KERNELS = ("sdf_core_fwd", "sdf_core_bwd", "sdf_dw_gemm", "albedo_fwd",
                 "albedo_bwd", "albedo_dw_gemm")
WOMASK_KERNELS = WMASK_KERNELS + ("nerf_fwd", "nerf_bwd", "nerf_dw_gemm")
# one grouped dW launch (ops/wg.py dw_products) a bf16 backward
DW_OF_BWD = {"sdf_dw_gemm": "sdf_core_bwd", "albedo_dw_gemm": "albedo_bwd",
             "nerf_dw_gemm": "nerf_bwd"}
# phase 1's dW groups: every product of one backward, timed beside
# torch.matmul
DW_GROUPS = ("sdf_dw_products", "albedo_dw_products", "nerf_dw_products")
# the f32 routes' kernels (CUDA cores): launched by the f32 parity step of
# each conf, never by the bf16 training step
WMASK_F32 = ("sdf_core_fwd_f32", "sdf_core_bwd_f32", "albedo_fwd_f32",
             "albedo_bwd_f32")
WOMASK_F32 = WMASK_F32 + ("nerf_fwd_f32", "nerf_bwd_f32")
F32_ROUTE = WOMASK_F32
# no_albedo: the albedo net is never run, on either route
ALBEDO_KERNELS = ("albedo_fwd", "albedo_bwd", "albedo_dw_gemm",
                  "albedo_fwd_f32", "albedo_bwd_f32")
WMASK_NOALB_KERNELS = tuple(k for k in WMASK_KERNELS if k not in ALBEDO_KERNELS)
WOMASK_NOALB_KERNELS = tuple(k for k in WOMASK_KERNELS if k not in ALBEDO_KERNELS)
WMASK_NOALB_F32 = tuple(k for k in WMASK_F32 if k not in ALBEDO_KERNELS)
WOMASK_NOALB_F32 = tuple(k for k in WOMASK_F32 if k not in ALBEDO_KERNELS)
CENTER = (0.15, -0.1, 0.08)        # phase 9's off-origin torus
ROOT = Path(__file__).resolve().parent
PEAK_BF16, PEAK_F32, HBM = 989e12, 67e12, 3.35e12   # H100 SXM data sheet

KERNELS = {
    "sdf_core_fwd": ("rnb_tpu_torch/csrc/sdf_core.cu",
                     "rnb_tpu/ops/pallas_sdf_core.py:169"),
    "sdf_core_bwd": ("rnb_tpu_torch/csrc/sdf_core.cu",
                     "rnb_tpu/ops/pallas_sdf_core.py:232"),
    "sdf_dw_gemm": ("rnb_tpu_torch/csrc/dw_gemm.cu",
                    "rnb_tpu/ops/pallas_sdf_core.py:232"),
    "sdf_core_fwd_f32": ("rnb_tpu_torch/csrc/sdf_core.cu",
                         "rnb_tpu/ops/pallas_sdf_core.py:169"),
    "sdf_core_bwd_f32": ("rnb_tpu_torch/csrc/sdf_core.cu",
                         "rnb_tpu/ops/pallas_sdf_core.py:232"),
    "albedo_fwd": ("rnb_tpu_torch/csrc/albedo.cu",
                   "rnb_tpu/ops/pallas_albedo.py:85"),
    "albedo_bwd": ("rnb_tpu_torch/csrc/albedo.cu",
                   "rnb_tpu/ops/pallas_albedo.py:101"),
    "albedo_fwd_f32": ("rnb_tpu_torch/csrc/albedo.cu",
                       "rnb_tpu/ops/pallas_albedo.py:85"),
    "albedo_bwd_f32": ("rnb_tpu_torch/csrc/albedo.cu",
                       "rnb_tpu/ops/pallas_albedo.py:101"),
    "nerf_fwd": ("rnb_tpu_torch/csrc/nerf.cu",
                 "rnb_tpu/ops/pallas_nerf.py:105"),
    "nerf_bwd": ("rnb_tpu_torch/csrc/nerf.cu",
                 "rnb_tpu/ops/pallas_nerf.py:122"),
    "nerf_fwd_f32": ("rnb_tpu_torch/csrc/nerf.cu",
                     "rnb_tpu/ops/pallas_nerf.py:105"),
    "nerf_bwd_f32": ("rnb_tpu_torch/csrc/nerf.cu",
                     "rnb_tpu/ops/pallas_nerf.py:122"),
    "sdf_fwd_ablate": ("rnb_tpu_torch/csrc/sdf_core.cu",
                       "tools/ablate_kernel.py:62"),
}


def log(msg):
    print(msg, flush=True)


def check_dw_launches(counts, where):
    """Each bf16 backward of a path launched its dW products once (one
    grouped launch, ops/wg.py dw_products)."""
    for dw, bwd in DW_OF_BWD.items():
        assert counts.get(dw, 0) == counts.get(bwd, 0), \
            f"{where}: {counts.get(dw, 0)} {dw} launches for " \
            f"{counts.get(bwd, 0)} {bwd}"


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


def load(conf_spec):
    """(statics, renderer config, train config) of a (path, overrides)."""
    from rnb_tpu_torch import config
    from rnb_tpu_torch.models import fields, renderer
    from rnb_tpu_torch.train import step as steplib

    path, overrides = conf_spec
    conf = config.load_conf(path)
    for o in overrides:
        config.apply_override(conf, o)
    tcfg = steplib.train_conf(conf)
    return (fields.statics_from_conf(conf["model"]),
            steplib.apply_runtime_flags(renderer.renderer_conf(conf["model"]), tcfg),
            tcfg)


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def chain_macs(ws):
    """Multiply-adds per point of one pass through a chain of [in, out]
    matrices."""
    return sum(w.shape[0] * w.shape[1] for w in ws)


def sdf_macs(cfg, ws, backward):
    """Least multiply-adds per point of the SDF core: the forward runs the
    primal chain and its reverse sweep (every layer but the last, which the
    seed W_last[:, 0] replaces); the backward runs the primal and tangent
    slabs through every layer but the last, both back through every layer
    but the first (only the h part of a skip input), and dW over both rows
    of every layer."""
    L, E = len(ws), ws[0].shape[0]
    io = [(w.shape[0], w.shape[1]) for w in ws]
    if not backward:
        return chain_macs(ws) + sum(i * o for i, o in io[:-1])
    rev = sum((i - E if l in cfg.skip_in else i) * o
              for l, (i, o) in enumerate(io) if l > 0)
    return 2 * sum(i * o for i, o in io[:-1]) + 2 * rev + 2 * chain_macs(ws)


def albedo_bwd_macs(cfg, ws):
    """Least multiply-adds per point of the albedo backward: the forward
    (the head too: its sigmoid feeds bar_z), the reverse through every
    layer, layer 0's only to its PE(n) and feat rows (pts gets no
    cotangent), and dW over every layer."""
    E = 3 * (1 + 2 * cfg.multires_view)
    rev = (ws[0].shape[0] - E) * ws[0].shape[1] + chain_macs(ws[1:])
    return 2 * chain_macs(ws) + rev


def nerf_bwd_macs(cfg, ws):
    """Least multiply-adds per point of the NeRF backward: the forward
    without the alpha and rgb heads (their outputs are not needed), the
    reverse through the rgb, views (to its feature rows), alpha, feature
    and trunk layers but layer 0 (a skip layer only to its h rows), and dW
    over all layers."""
    D, E = cfg.D, ws[0].shape[0]
    io = [(w.shape[0], w.shape[1]) for w in ws]
    trunk = sum(i * o for i, o in io[:D])
    fwd = trunk + chain_macs([ws[D + 1], ws[D + 2]])
    rev = (chain_macs([ws[D], ws[D + 1], ws[D + 3]])
           + io[D + 1][1] * io[D + 2][1]
           + sum((i - E if l - 1 in cfg.skips else i) * o
                 for l, (i, o) in enumerate(io[:D]) if l > 0))
    return fwd + rev + chain_macs(ws)


def check_kernel(results, name, n, dtype, kern, plain, timed, ins=(),
                 macs=0.0, library=None, repeat=False):
    """Hold one kernel call against its plain version (and, with
    ``repeat``, a second call bit for bit); when ``timed``, time both (and
    ``library``, one PyTorch call of the same function) and bound the
    kernel: ``ins`` its input tensors, ``macs`` its least multiply-adds at
    the operand dtype's peak."""
    from rnb_tpu_torch.tools.ablate_kernel import cuda_ms

    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    got = kern()
    torch.cuda.synchronize()
    want = plain()
    mx, rel = rel_err(got, want)
    tag = f"{name} n={n} {str(dtype).split('.')[-1]}"
    log(f"[kernel] {tag}: max_abs_err={mx:.3e} rel_err={rel:.3e} (tol {tol:g})")
    assert rel <= tol, f"{tag}: rel err {rel} > {tol}"
    if repeat:
        assert all(torch.equal(a, b) for a, b in zip(got, kern())), \
            f"{tag}: two calls differ"
        log(f"[kernel] {tag}: two calls bit-identical")
    r = results.setdefault(name, {"max_abs_err": 0.0, "library_ms": None})
    r["max_abs_err"] = max(r["max_abs_err"], mx)
    if timed:
        k_ms, p_ms = cuda_ms(kern), cuda_ms(plain)
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        t_ops, t_bytes = 2 * macs / peak * 1e3, nbytes(list(ins) + list(got)) / HBM * 1e3
        r["ms"], r["plain_ms"] = r.get("ms", 0.0) + k_ms, r.get("plain_ms", 0.0) + p_ms
        r["bound_ms"] = r.get("bound_ms", 0.0) + max(t_ops, t_bytes)
        r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        if library is not None:
            r["library_ms"] = cuda_ms(library)
        log(f"[time] {tag}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
            f"{max(t_ops, t_bytes):.3f} ms ({r['bound_by']})"
            + (f", library {r['library_ms']:.3f} ms" if library is not None else ""))


def check_dw_products(results, name, counter, lay, gen):
    """Every dW product of one bf16 backward (``wg.dw_products`` on the
    layers of ``lay``: one grouped launch, counter ``counter``) against the
    plain products, timed beside one torch.matmul a layer on the same bf16
    operand rows; ``gen`` a card generator (the SDF core's rows are 1.1
    GB)."""
    from rnb_tpu_torch.ops import wg

    rows = (lay["a_len"] - lay["a_off"][-1]) // lay["kp"][-1]
    dev = gen.device
    a = torch.randn(lay["a_len"], generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn(lay["b_len"], generator=gen, device=dev).to(torch.bfloat16)
    ops = [(a[ao:ao + rows * kp].view(rows, kp), b[bo:bo + rows * np_].view(rows, np_),
            i, o) for ao, bo, kp, np_, i, o in zip(
                lay["a_off"], lay["bb_off"], lay["kp"], lay["np"],
                lay["in_dims"], lay["out_dims"])]
    check_kernel(results, name, rows, torch.bfloat16,
                 lambda: wg.dw_products(a, b, lay, rows, counter),
                 lambda: [wg.dw_gemm_plain(x, y, i, o) for x, y, i, o in ops],
                 True, [t for x, y, i, o in ops for t in (x[:, :i], y[:, :o])],
                 sum(rows * i * o for _, _, i, o in ops),
                 library=lambda: [torch.matmul(x[:, :i].T, y[:, :o])
                                  for x, y, i, o in ops])
    results[name]["products"] = len(ops)
    results[name]["splits"] = wg.dw_splits(
        list(zip(lay["in_dims"], lay["out_dims"])), rows)[0]


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_checks(dev):
    from rnb_tpu_torch.models import fields
    from rnb_tpu_torch.ops import albedo, nerf, sdf_ablate, sdf_core

    gen = torch.Generator().manual_seed(0)
    scfg, acfg, ncfg = fields.SDFConfig(), fields.RenderingConfig(), fields.NeRFConfig()
    sdf_p = fields.init_sdf_network(gen, scfg, dev)
    for layer in sdf_p:   # off the exact geometric init: every layer carries signal
        layer["v"] = layer["v"] + 0.02 * torch.randn(layer["v"].shape, generator=gen).to(dev)
    alb_p = fields.init_rendering_network(gen, acfg, dev)
    sw = [fields.fold_weight_norm(l).detach() for l in sdf_p]
    sb = [l["b"].detach() for l in sdf_p]
    aw = [fields.fold_weight_norm(l).detach() for l in alb_p]
    ab = [l["b"].detach() for l in alb_p]
    nw, nb = nerf.flatten_params(fields.init_nerf(gen, ncfg, dev))

    results = {}
    dtypes = (torch.float32, torch.bfloat16)
    sdf_w = [*sw, *sb]
    alb_w = [*aw, *ab]
    # the bf16 albedo and NeRF kernels take the weight image their op packs
    # once a step for forward and backward (ops/albedo.py, ops/nerf.py
    # wg_pack); they are checked and timed on it, as the step calls them
    packs = {torch.bfloat16: (albedo.wg_pack(aw, ab), nerf.wg_pack(ncfg, nw, nb)),
             torch.float32: (None, None)}
    for n in (MAIN_N, RAGGED_N):
        pts = (torch.rand(n, 3, generator=gen) * 1.6 - 0.8).to(dev)
        nrm = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1).to(dev)
        feat = (0.3 * torch.randn(n, acfg.d_feature, generator=gen)).to(dev)
        cs = torch.randn(n, generator=gen).to(dev)
        cf = (0.1 * torch.randn(n, scfg.d_out - 1, generator=gen)).to(dev)
        cg = torch.randn(n, 3, generator=gen).to(dev)
        co = torch.randn(n, acfg.d_out, generator=gen).to(dev)
        for dtype in dtypes:
            route = "" if dtype == torch.bfloat16 else "_f32"
            apk = packs[dtype][0]
            calls = {
                "sdf_core_fwd" + route: (
                    lambda: list(sdf_core.sdf_core_fwd(scfg, pts, sw, sb, dtype)),
                    lambda: list(sdf_core.sdf_core_fwd_plain(scfg, pts, sw, sb, dtype)),
                    [pts, *sdf_w], n * sdf_macs(scfg, sw, False)),
                "sdf_core_bwd" + route: (
                    lambda: sum(sdf_core.sdf_core_bwd(scfg, pts, sw, sb, cs, cf, cg, dtype), []),
                    lambda: sum(sdf_core.sdf_core_bwd_plain(scfg, pts, sw, sb, cs, cf, cg, dtype), []),
                    [pts, *sdf_w, cs, cf, cg], n * sdf_macs(scfg, sw, True)),
                "albedo_fwd" + route: (
                    lambda: [albedo.albedo_fwd(acfg, pts, nrm, feat, aw, ab, dtype, apk)],
                    lambda: [albedo.albedo_fwd_plain(acfg, pts, nrm, feat, aw, ab, dtype)],
                    [pts, nrm, feat, *alb_w], n * chain_macs(aw)),
                "albedo_bwd" + route: (
                    lambda: _flat_alb(albedo.albedo_bwd(acfg, pts, nrm, feat, aw, ab, co, dtype, apk)),
                    lambda: _flat_alb(albedo.albedo_bwd_plain(acfg, pts, nrm, feat, aw, ab, co, dtype)),
                    [pts, nrm, feat, *alb_w, co], n * albedo_bwd_macs(acfg, aw)),
            }
            if n == MAIN_N:   # the ablation variants at the main path's count
                for mode in sdf_ablate.MODES:
                    macs = n * (sdf_macs(scfg, sw, False) if mode != "primal_only"
                                else chain_macs(sw))
                    calls[f"sdf_fwd_ablate:{mode}"] = (
                        lambda m=mode: list(sdf_ablate.sdf_fwd_ablate(m, scfg, pts, sw, sb, dtype)),
                        lambda m=mode: list(sdf_ablate.sdf_fwd_ablate_plain(m, scfg, pts, sw, sb, dtype)),
                        [pts, *sdf_w], macs)
            for name, (kern, plain, ins, macs) in calls.items():
                base = name.split(":")[0]
                timed = n == MAIN_N and (dtype == torch.bfloat16 or base in F32_ROUTE)
                check_kernel(results, base, n, dtype, kern, plain, timed, ins, macs,
                             repeat=name == "sdf_core_bwd")
        del pts, nrm, feat, cs, cf, cg, co
        torch.cuda.empty_cache()

    # the bf16 backward's dW product for one 256x256 layer over both rows of
    # the main path's points, beside torch.matmul on the same operands
    k = 2 * MAIN_N
    a = torch.randn(k, 256, generator=gen).to(dev, torch.bfloat16)
    b = torch.randn(k, 256, generator=gen).to(dev, torch.bfloat16)
    check_kernel(results, "sdf_dw_gemm", k, torch.bfloat16,
                 lambda: [sdf_core.dw_gemm(a, b, 256, 256)],
                 lambda: [sdf_core.dw_gemm_plain(a, b, 256, 256)], True,
                 [a, b], 256 * 256 * k, library=lambda: torch.matmul(a.T, b))
    del a, b

    # the dW products of the SDF core's (9, over 2 x 65,536 rows), the
    # albedo's (3) and the NeRF's (11) bf16 backward at their layers'
    # shapes over the main path's rows, one grouped launch each, beside one
    # torch.matmul a layer on the same operands (their sum is library_ms)
    dgen = torch.Generator(device=dev).manual_seed(1)
    for name, counter, lay in (
            ("sdf_dw_products", "sdf_dw_gemm", sdf_core.wg_layout(scfg, sw, MAIN_N)),
            ("albedo_dw_products", "albedo_dw_gemm", albedo.wg_layout(aw, MAIN_N)),
            ("nerf_dw_products", "nerf_dw_gemm", nerf.wg_layout(ncfg, nw, NERF_N))):
        check_dw_products(results, name, counter, lay, dgen)
        torch.cuda.empty_cache()

    for n in (NERF_N, NERF_RAGGED_N):
        # pts4 = [x/r, 1/r] with |x| > 1, as render_core_outside feeds it,
        # kept where every ReLU pre-activation lies at least 2e-5 from 0 at
        # both op dtypes: nearer, summation noise flips a mask between the
        # two versions (nerf.relu_margin); about half the points pass both
        m = 3 * n
        x = torch.nn.functional.normalize(torch.randn(m, 3, generator=gen), dim=-1)
        inv_r = torch.rand(m, 1, generator=gen) * 0.9 + 0.1
        pts4 = torch.cat([x, inv_r], dim=-1).to(dev)
        views = torch.nn.functional.normalize(torch.randn(m, 3, generator=gen), dim=-1).to(dev)
        margin = torch.minimum(
            *(nerf.relu_margin(ncfg, pts4, views, nw, nb, dt) for dt in dtypes))
        keep = torch.nonzero(margin >= 2e-5)[:, 0]
        assert keep.numel() >= n, f"only {keep.numel()} of {m} points off the ReLU boundary"
        log(f"[kernel] nerf: {keep.numel()} of {m} drawn points lie off the ReLU boundary")
        pts4, views = pts4[keep[:n]], views[keep[:n]]
        ca = torch.randn(n, 1, generator=gen).to(dev)
        cr = torch.randn(n, 3, generator=gen).to(dev)
        for dtype in dtypes:
            timed = n == NERF_N
            route = "" if dtype == torch.bfloat16 else "_f32"
            npk = packs[dtype][1]
            check_kernel(results, "nerf_fwd" + route, n, dtype,
                         lambda: list(nerf.nerf_fwd(ncfg, pts4, views, nw, nb, dtype, npk)),
                         lambda: list(nerf.nerf_fwd_plain(ncfg, pts4, views, nw, nb, dtype)),
                         timed, [pts4, views, *nw, *nb], n * chain_macs(nw))
            check_kernel(results, "nerf_bwd" + route, n, dtype,
                         lambda: sum(nerf.nerf_bwd(ncfg, pts4, views, nw, nb, ca, cr, dtype, npk), []),
                         lambda: sum(nerf.nerf_bwd_plain(ncfg, pts4, views, nw, nb, ca, cr, dtype), []),
                         timed, [pts4, views, *nw, *nb, ca, cr],
                         n * nerf_bwd_macs(ncfg, nw))
        del pts4, views, ca, cr
        torch.cuda.empty_cache()
    return results


def _flat_alb(r):
    dws, dbs, cn, cfeat = r
    return list(dws) + list(dbs) + [cn, cfeat]


# ---------------------------------------------------------------------------
# phase 2: the training step of a shipped conf
# ---------------------------------------------------------------------------

def _scene_arrays(scene, no_albedo):
    """The scene's arrays; with no_albedo its albedos are ones, as the
    loader gives them."""
    if not no_albedo:
        return scene.arrays
    return scene.arrays._replace(albedos=torch.ones_like(scene.arrays.albedos))


def slice_run(dev, conf_spec, kernels, no_albedo=False):
    from rnb_tpu_torch.data import dataset as ds
    from rnb_tpu_torch.models import fields
    from rnb_tpu_torch.ops import _build
    from rnb_tpu_torch.train import step as steplib

    statics, rcfg, tcfg = load(conf_spec)
    assert (rcfg.total_samples, tcfg.batch_size) == (128, 512)
    arrays = _scene_arrays(ds.make_sphere_scene(
        n_views=6, H=256, W=256, radius=0.4, device=dev), no_albedo)
    params = fields.init_model_bundle(torch.Generator().manual_seed(0), statics, dev)
    state = steplib.init_train_state(params)
    gen = torch.Generator(device=dev).manual_seed(0)
    phases = {}
    for k in _build.launches:
        _build.launches[k] = 0
    for warmup in (True, False):
        fn = steplib.make_train_step(statics, rcfg, tcfg, warmup=warmup,
                                     no_albedo=no_albedo)
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(10):
            if i == 1:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            state, m = fn(state, arrays, i % 6, gen)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        losses = torch.stack(losses).cpu()
        name = "warmup" if warmup else "main"
        assert torch.isfinite(losses).all(), f"{name}: non-finite loss {losses}"
        phases[name] = {"first_step_ms": (t1 - t0) * 1e3,
                        "ms_per_step": (t2 - t1) * 1e3 / 9,
                        "loss_first": losses[0].item(), "loss_last": losses[-1].item()}
        log(f"[slice {conf_spec[0]} n_outside={rcfg.n_outside}] {name}: {phases[name]}")
    counts = dict(_build.launches)
    log(f"[slice] launches in the 20 steps: {counts}")
    for k in kernels:
        assert counts[k] > 0, f"kernel {k} was not launched by the main path"
    check_dw_launches(counts, f"the main path of {conf_spec[0]}")
    for k in F32_ROUTE:   # the step runs bf16: the tensor-core routes only
        assert counts[k] == 0, f"the main path launched the f32 route ({k})"
    if no_albedo:
        for k in ALBEDO_KERNELS:
            assert counts[k] == 0, f"a no-albedo step launched {k}"
    return phases, counts


# ---------------------------------------------------------------------------
# phase 3: one step on the CPU (plain versions) vs on the card (kernels)
# ---------------------------------------------------------------------------

def slice_parity(dev, conf_spec, f32_kernels, no_albedo=False):
    from rnb_tpu_torch.data import dataset as ds
    from rnb_tpu_torch.models import fields
    from rnb_tpu_torch.ops import _build
    from rnb_tpu_torch.train import step as steplib
    from rnb_tpu_torch.utils import bridge

    statics, rcfg, tcfg = load(conf_spec)
    rcfg = dataclasses.replace(rcfg, upsample_prec="f32", kernel_prec="f32")
    # warm_up_end=0: the first update already has the full LR
    tcfg = dataclasses.replace(tcfg, warm_up_end=0)
    B = 64
    scene = ds.make_sphere_scene(n_views=6, H=256, W=256, radius=0.4, device="cpu")
    params = fields.init_model_bundle(torch.Generator().manual_seed(1), statics, "cpu")
    rng = np.random.default_rng(2)
    px = torch.tensor(rng.integers(0, 256, B))
    py = torch.tensor(rng.integers(0, 256, B))
    t_rand = torch.tensor(rng.uniform(size=(B, 1)) - 0.5, dtype=torch.float32)
    t_out = torch.tensor(rng.uniform(size=(B, rcfg.n_outside)), dtype=torch.float32)

    out = {}
    for k in _build.launches:
        _build.launches[k] = 0
    for where in ("cpu", dev):
        p = bridge.params_from_numpy(bridge.params_to_numpy(params), where)
        arrays = ds.DataArrays(*(a.to(where) for a in
                                 _scene_arrays(scene, no_albedo)))
        state = steplib.init_train_state(p)
        fn = steplib.make_train_step(statics, rcfg, tcfg, warmup=False,
                                     no_albedo=no_albedo, batch_size=B)
        state, m = fn(state, arrays, 2, px=px.to(where), py=py.to(where),
                      t_rand=t_rand.to(where), t_out=t_out.to(where))
        leaves = bridge.tree_leaves(state.params)
        out[str(where)] = (m["loss"].item(), [x.grad.detach().cpu() for x in leaves],
                           [x.detach().cpu() for x in leaves])
    counts = {k: _build.launches[k] for k in f32_kernels}
    log(f"[parity] f32-route launches in the card step: {counts}")
    assert all(counts.values()), "the f32 step did not run the f32 routes"
    if no_albedo:
        for k in ALBEDO_KERNELS:
            assert _build.launches[k] == 0, f"a no-albedo step launched {k}"
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out[str(dev)]
    lr = tcfg.learning_rate
    _, grad_rel = rel_err(gg, gc)
    worst = max(((a - b).norm() / max(b.norm(), 1e-30)).item()
                for a, b in zip(gg, gc) if b.norm() > 0)
    dparam = max((a - b).abs().max().item() for a, b in zip(pg, pc))
    log(f"[parity {conf_spec[0]} n_outside={rcfg.n_outside}] loss cpu={lc:.7f} "
        f"gpu={lg:.7f}; grads rel_err={grad_rel:.3e} (worst leaf {worst:.3e}); "
        f"max |param diff|={dparam:.3e} (lr {lr:g})")
    assert abs(lg - lc) <= 1e-4 * abs(lc), "loss differs"
    assert worst <= 1e-3, "gradients differ"
    # Adam's first update is ≈ lr·sign(g): a near-zero gradient may flip it
    assert dparam <= 2 * lr + 1e-6, "updated params differ"
    return {"loss_cpu": lc, "loss_gpu": lg, "grad_rel_err": grad_rel,
            "grad_worst_leaf_rel_err": worst, "max_param_diff": dparam}, counts


# ---------------------------------------------------------------------------
# phase 4: training moves
# ---------------------------------------------------------------------------

def training_moves(dev, conf_spec):
    from rnb_tpu_torch.data import dataset as ds
    from rnb_tpu_torch.models import fields
    from rnb_tpu_torch.train import step as steplib

    statics, rcfg, tcfg = load(conf_spec)
    tcfg = dataclasses.replace(tcfg, end_iter=400, warm_up_end=50)
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
    log(f"[train {conf_spec[0]} n_outside={rcfg.n_outside}] 200 warm-up steps in "
        f"{secs:.1f} s: mean loss first 20 {first:.5f}, last 20 {last:.5f}")
    assert np.isfinite(losses).all() and last < first, "training did not move"
    return {"loss_first20": first, "loss_last20": last, "seconds": secs}


# ---------------------------------------------------------------------------
# phase 5: the kernel-ablation entry point
# ---------------------------------------------------------------------------

def ablation_run():
    from rnb_tpu_torch.ops import _build
    from rnb_tpu_torch.tools import ablate_kernel

    for k in _build.launches:
        _build.launches[k] = 0
    res = ablate_kernel.main([])
    count = _build.launches["sdf_fwd_ablate"]
    log(f"[ablate] sdf_fwd_ablate launches: {count}")
    assert count > 0, "the ablation entry point did not launch its kernel"
    return res, count


# ---------------------------------------------------------------------------
# phase 6: the runner path through the command line
# ---------------------------------------------------------------------------

def _sub(args, timeout, ok_rcs=(0,), cwd=ROOT, env=None,
         run=(sys.executable, "-m")):
    """Run ``python -m <args>`` (``run`` + ``args``) in ``cwd``, with
    ``env`` added to this process's environment; -> (its output, its
    seconds), its return code checked against ``ok_rcs``."""
    t0 = time.perf_counter()
    proc = subprocess.run([*run, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout,
                          env={**os.environ, **env} if env else None)
    secs = time.perf_counter() - t0
    tail = "\n".join(proc.stdout.splitlines()[-12:])
    log(f"[runner] {' '.join(run)} {args[0]} ... rc={proc.returncode} in "
        f"{secs:.1f} s\n{tail}")
    if proc.returncode not in ok_rcs:
        raise RuntimeError(f"{' '.join([*run, *args])} exited {proc.returncode}:"
                           f"\n{proc.stdout[-8000:]}\n{proc.stderr[-8000:]}")
    return proc.stdout, secs


def _losses(exp):
    """The per-step losses of the one process that wrote ``exp``'s stream."""
    from rnb_tpu_torch.tools.run_e2e import loss_segments

    (seg,) = loss_segments(os.path.join(exp, "logs", "scalars.jsonl"))
    return seg


def runner_path(dev, card, tmp):
    """Phase 6 in ``tmp``; -> (result, launches, the CLI's --set list)."""
    from rnb_tpu_torch.models import renderer as rnd
    from rnb_tpu_torch.ops import marching_cubes as mc
    from rnb_tpu_torch.train.runner import Runner

    case, exp = os.path.join(tmp, "sphere"), os.path.join(tmp, "exp")
    _sub(["rnb_tpu_torch.tools.make_synthetic_case", "--out", case,
          "--shape", "sphere", "--radius", "0.35", "--n_views", "6",
          "--size", "256"], 300)
    sets = [f"dataset.data_dir={case}", f"general.base_exp_dir={exp}",
            "train.end_iter=400", "train.warm_up_iter=300",
            "train.warm_up_end=50", "train.save_freq=200",
            "train.val_freq=200", "train.val_mesh_freq=400",
            "train.report_freq=100"]
    cli = ["rnb_tpu_torch.cli", "--mode", "train_rnb", "--conf",
           WMASK[0]]
    # the launch counts of this run start at 0 in the new process and
    # are printed by it at its end
    out, run_secs = _sub(cli + ["--mesh_resolution", "128"]
                         + [a for s in sets for a in ("--set", s)], 900)
    counts = json.loads(next(l for l in out.splitlines()
                             if l.startswith('{"launches"')))["launches"]
    log(f"[runner] launches in the CLI run: {counts}")
    for k in WMASK_KERNELS:
        assert counts[k] > 0, f"kernel {k} was not launched by the runner path"
    check_dw_launches(counts, "the runner path")
    for k in F32_ROUTE:
        assert counts[k] == 0, f"the runner path launched the f32 route ({k})"
    wall = next(l for l in out.splitlines() if l.startswith("trained "))
    steps, secs = int(wall.split()[1]), float(wall.split()[4])
    assert steps == 400, wall

    for rel in ("checkpoints/ckpt_000200.npz", "checkpoints/ckpt_000400.npz",
                "meshes/00000400.ply"):
        assert os.path.isfile(os.path.join(exp, rel)), f"missing {rel}"
    for sub in ("validations_fine", "normals"):
        pngs = [f for f in os.listdir(os.path.join(exp, sub)) if f.endswith(".png")]
        assert len(pngs) == 2, f"{sub}: {pngs}"
    losses = _losses(exp)
    assert sorted(losses) == list(range(1, 401)), "logged steps"
    ls = np.array([losses[s] for s in range(1, 401)])
    first, last = float(ls[:20].mean()), float(ls[-20:].mean())
    assert np.isfinite(ls).all() and last < first, (first, last)

    from rnb_tpu_torch.utils.io import read_ply
    v, f, _ = read_ply(os.path.join(exp, "meshes", "00000400.ply"))
    r = np.linalg.norm(v, axis=-1)
    log(f"[runner] loss first 20 {first:.5f}, last 20 {last:.5f}; mesh "
        f"{len(v)} vertices, {len(f)} faces, radius mean {r.mean():.5f} "
        f"std {r.std():.5f}")
    assert abs(r.mean() - 0.35) < 0.02 and r.std() < 0.02, "mesh radius"

    acc_out, _ = _sub(["rnb_tpu_torch.tools.acceptance", exp, "--shape",
                       "sphere", "--radius", "0.35", "--threshold", "0.02"],
                      300)
    acceptance = json.loads(acc_out.strip().splitlines()[-1])
    log("[runner] acceptance " + json.dumps(acceptance))

    # resume from the step-200 checkpoint in a fresh directory
    exp2 = os.path.join(tmp, "exp_resume")
    os.makedirs(os.path.join(exp2, "checkpoints"))
    shutil.copy(os.path.join(exp, "checkpoints", "ckpt_000200.npz"),
                os.path.join(exp2, "checkpoints"))
    sets2 = [s for s in sets if not s.startswith(("general.", "train.end_iter"))]
    _sub(cli + ["--is_continue", "--mesh_resolution", "64",
                "--set", f"general.base_exp_dir={exp2}",
                "--set", "train.end_iter=201"]
         + [a for s in sets2 for a in ("--set", s)], 600)
    resumed = _losses(exp2)
    assert sorted(resumed) == [201], sorted(resumed)
    rel = abs(resumed[201] - losses[201]) / abs(losses[201])
    log(f"[runner] step 201 loss: straight {losses[201]!r}, resumed "
        f"{resumed[201]!r}, rel diff {rel:.3e}")
    assert rel <= 1e-6, "the resumed step differs"

    # grid query and marching cubes on the trained weights
    runner = Runner(WMASK[0], "validate_mesh", is_continue=True,
                    overrides=sets, device=dev)
    assert runner.iter_step == 400
    ds_ = runner.dataset
    # least work of the query: the f32 multiply-adds of the SDF chain
    # with its head cut to the sdf column, at the f32 peak
    sdf_ws = [l["v"] for l in runner.state.params["sdf"]]
    macs = sum(w.shape[0] * w.shape[1] for w in sdf_ws[:-1]) + sdf_ws[-1].shape[0]
    extraction = {}
    for res in (128, 512):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = rnd.extract_fields(runner.statics, runner.state.params,
                                  ds_.object_bbox_min, ds_.object_bbox_max, res)
        t1 = time.perf_counter()
        verts, tris = mc.extract_geometry(grid, ds_.object_bbox_min,
                                          ds_.object_bbox_max)
        t2 = time.perf_counter()
        extraction[res] = {"grid_query_s": t1 - t0,
                           "grid_query_bound_s": 2 * macs * res ** 3 / PEAK_F32,
                           "marching_cubes_s": t2 - t1,
                           "vertices": len(verts), "faces": len(tris)}
        rr = np.linalg.norm(verts, axis=-1)
        assert abs(rr.mean() - 0.35) < 0.02 and rr.std() < 0.02, res
        log(f"[runner] extraction {res}^3 ({card}): {extraction[res]}")
    log(f"[runner] marching cubes built by {mc.build_info['compiler']}")
    result = {"train_400_steps_s": secs, "rays_per_s": 400 * 512 / secs,
              "cli_process_s": run_secs, "loss_first20": first,
              "loss_last20": last, "mesh_radius_mean": float(r.mean()),
              "mesh_radius_std": float(r.std()),
              "chamfer_l1": acceptance["chamfer_l1"],
              "step201_rel_diff": rel, "extraction": extraction}
    log(f"[runner] {card}: wall of 400 steps {secs:.3f} s "
        f"({result['rays_per_s']:.0f} rays/s, checkpoints and validation "
        "included)")
    return result, counts, sets


# ---------------------------------------------------------------------------
# phase 7: the inference path
# ---------------------------------------------------------------------------

# the kernels of a forward-only render on the bf16 routes; every other
# counter must stay at 0 there (no backward, no dW product, no f32 route)
INFER_KERNELS = ("sdf_core_fwd", "albedo_fwd")


def _check_infer_counts(counts, where, kernels):
    log(f"[infer] launches in {where}: {counts}")
    for k in kernels:
        assert counts[k] > 0, f"{where}: kernel {k} was not launched"
    for k, v in counts.items():
        if k not in kernels:
            assert v == 0, f"{where}: launched {k} {v} times (forward only, bf16)"


def _mode(mode, sets, extra=()):
    """One inference mode of the CLI on phase 6's experiment; -> (stdout,
    its launch counts)."""
    out, _ = _sub(["rnb_tpu_torch.cli", "--mode", mode, "--conf", WMASK[0], *extra]
                  + [a for s in sets for a in ("--set", s)], 600)
    counts = json.loads(next(l for l in out.splitlines()
                             if l.startswith('{"launches"')))["launches"]
    _check_infer_counts(counts, mode, INFER_KERNELS)
    return out, counts


def _frame_profile(runner, card, frames=5):
    """One 64x64 novel view of ``runner`` (after a warm one): the wall per
    frame (host clock over ``frames`` frames, each ending in its fetch) with
    the weight norm folded once a render, as the runner does, and folded by
    each op call, in turns (each way three times; the median counts); the
    frames must be equal. Then from ``torch.profiler`` over one more frame
    the device time by kernel and the idle share (1 - device / wall)."""
    from torch.profiler import ProfilerActivity, profile

    from rnb_tpu_torch.models import fields
    from rnb_tpu_torch.tools.profile_step import device_ms_by_name

    ways = {"folded_once": fields.fold_params, "per_call": lambda params: params}

    def timed(way):
        with mock.patch.object(fields, "fold_params", ways[way]):
            img = runner.render_novel_image(0, 1, 0.5, 4)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(frames):
                runner.render_novel_image(0, 1, 0.5, 4)
            return img, (time.perf_counter() - t0) * 1e3 / frames

    walls = {w: [] for w in ways}
    imgs = {}
    for way in ("per_call", "folded_once") * 3:
        imgs[way], ms = timed(way)
        walls[way].append(ms)
    assert (imgs["per_call"] == imgs["folded_once"]).all(), \
        "folding once moved the frame"
    wall = float(np.median(walls["folded_once"]))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner.render_novel_image(0, 1, 0.5, 4)
        torch.cuda.synchronize()
    device, top = device_ms_by_name(prof, 1, 10)
    res = {"wall_ms": wall, "wall_ms_runs": walls, "device_ms": device,
           "idle_share": 1.0 - device / wall,
           "rays_per_s": 64 * 64 / wall * 1e3, "kernels_ms": top}
    log(f"[infer] {card}: {runner.conf_path} n_outside={runner.rcfg.n_outside} "
        f"novel view 64x64: {json.dumps(res)}")
    return res


def _render_parity(dev, conf_spec, f32_kernels):
    """One chunk of ``render`` (64 rays, no perturbation) on the CPU (plain
    versions) and on the card at kernel_prec=f32 (the f32 routes), from the
    same params and rays: the colour within F32_TOL of its norm."""
    from rnb_tpu_torch.data import dataset as ds
    from rnb_tpu_torch.models import fields, renderer as rnd
    from rnb_tpu_torch.ops import _build
    from rnb_tpu_torch.utils import bridge

    statics, rcfg, _ = load(conf_spec)
    rcfg = dataclasses.replace(rcfg, upsample_prec="f32", kernel_prec="f32")
    scene = ds.make_sphere_scene(n_views=6, H=256, W=256, radius=0.4, device="cpu")
    params = bridge.params_to_numpy(
        fields.init_model_bundle(torch.Generator().manual_seed(3), statics, "cpu"))
    rng = np.random.default_rng(4)
    px, py = (torch.tensor(rng.integers(64, 192, 64)) for _ in range(2))
    rays = ds.sample_rays_on_all_lights(scene.arrays, 1, px, py)
    out = {}
    for k in _build.launches:
        _build.launches[k] = 0
    for where in ("cpu", dev):
        p = bridge.params_from_numpy(params, where)
        with torch.no_grad():
            r = rnd.render(statics, rcfg, p, *(t.to(where) for t in (
                rays.rays_o, rays.rays_d, rays.near, rays.far)), None)
        out[str(where)] = r["color_fine"].cpu()
    counts = {k: _build.launches[k] for k in f32_kernels}
    assert all(counts.values()), f"the f32 render did not run the f32 routes: {counts}"
    mx, rel = rel_err([out[str(dev)]], [out["cpu"]])
    log(f"[infer parity {conf_spec[0]} n_outside={rcfg.n_outside}] render colour "
        f"max_abs_err={mx:.3e} rel_err={rel:.3e} (tol {F32_TOL:g}); f32 launches {counts}")
    assert torch.isfinite(out[str(dev)]).all() and rel <= F32_TOL, "render differs"
    return {"max_abs_err": mx, "rel_err": rel, "f32_launches": counts}


def inference_path(dev, card, tmp, sets):
    """Phase 7 on phase 6's 400-step experiment in ``tmp``."""
    from rnb_tpu_torch.models import renderer as rnd
    from rnb_tpu_torch.ops import _build
    from rnb_tpu_torch.tools import compare_images
    from rnb_tpu_torch.train.runner import Runner
    from rnb_tpu_torch.utils import io

    exp = next(s.split("=", 1)[1] for s in sets if s.startswith("general.base_exp_dir"))
    result, launches = {}, {}

    _, launches["validate_mesh_texture"] = _mode(
        "validate_mesh_texture", sets, ["--mesh_resolution", "128"])
    v, f, c = io.read_ply(os.path.join(exp, "meshes", "00000400.ply"))
    assert c is not None and c.shape == (len(v), 3), "no vertex colours"
    col = c.astype(np.float64) / 255.0
    r = np.linalg.norm(v, axis=-1)
    mean = col.mean(axis=0)
    log(f"[infer] textured mesh: {len(v)} vertices, radius {r.mean():.5f} +- "
        f"{r.std():.5f}, mean colour RGB {mean.round(4).tolist()}")
    assert np.isfinite(v).all() and 0 <= col.min() and col.max() <= 1
    assert abs(r.mean() - 0.35) < 0.02, "textured mesh radius"
    assert mean[0] > mean[1] > mean[2], "vertex colours are not ordered R > G > B"
    result["mesh_texture"] = {"vertices": len(v), "radius_mean": float(r.mean()),
                              "mean_rgb": mean.tolist()}

    _, launches["validate_image_ps"] = _mode("validate_image_ps", sets)
    ps_dir = os.path.join(exp, "validations_ps")
    pngs = sorted(os.listdir(ps_dir))
    assert len(pngs) == 3, pngs
    psnr = []
    for name in pngs:
        img = io.load_image(os.path.join(ps_dir, name))
        h = img.shape[0] // 2
        psnr.append(compare_images.mse_psnr(img[:h], img[h:])[1])
    log(f"[infer] validate_image_ps: render vs supervision PSNR {psnr} dB "
        "(compare_images)")
    assert np.isfinite(psnr).all()
    result["image_ps_psnr"] = psnr

    out, launches["interpolate_0_1"] = _mode("interpolate_0_1", sets)
    frames = io.read_avi(os.path.join(exp, "render", "00000400_0_1.avi"))
    assert frames.shape == (120, 64, 64, 3), frames.shape
    assert (frames == frames[::-1]).all(), "frame k differs from frame 119 - k"
    line = next(l for l in out.splitlines() if l.startswith("rendered "))
    frame_ms = float(line.split("(")[1].split()[0])
    rays_s = float(line.split(", ")[-1].split()[0])
    log(f"[infer] {card}: novel views {line}")
    result["interpolate"] = {"frame_ms": frame_ms, "rays_per_s": rays_s}

    # the frame in-process: the trained wmask weights, and womask (the
    # background NeRF on the novel-view path) with random weights at full
    # width on phase 6's case
    wm = Runner(WMASK[0], "validate_mesh", is_continue=True, overrides=sets,
                device=dev)
    assert wm.iter_step == 400
    result["frame_wmask"] = _frame_profile(wm, card)
    del wm
    wo_sets = [s for s in sets if s.startswith("dataset.")] + [
        f"general.base_exp_dir={os.path.join(tmp, 'exp_womask')}", *WOMASK[1]]
    runner = Runner(WOMASK[0], "validate_mesh", overrides=wo_sets, device=dev)
    assert runner.rcfg.n_outside == 4 and runner.rcfg.kernel_prec == "bf16"
    for k in _build.launches:
        _build.launches[k] = 0
    img = runner.render_novel_image(0, 1, 0.5, 4)
    launches["womask_render_novel_image"] = dict(_build.launches)
    _check_infer_counts(launches["womask_render_novel_image"],
                        "womask render_novel_image", INFER_KERNELS + ("nerf_fwd",))
    rays_o, rays_d = runner.dataset.gen_rays_between(0, 1, 0.5, 4)
    o, d = rays_o.reshape(-1, 3)[:512], rays_d.reshape(-1, 3)[:512]
    with torch.no_grad():
        chunk = rnd.render(runner.statics, runner.rcfg, runner.state.params, o, d,
                           *runner.dataset.near_far_from_sphere(o, d), None)
    assert img.shape == (64, 64, 3) and torch.isfinite(chunk["color_fine"]).all()
    result["frame_womask"] = _frame_profile(runner, card)
    del runner

    result["parity"] = {
        "wmask": _render_parity(dev, WMASK, ("sdf_core_fwd_f32", "albedo_fwd_f32")),
        "womask": _render_parity(dev, WOMASK, ("sdf_core_fwd_f32", "albedo_fwd_f32",
                                               "nerf_fwd_f32"))}
    return result, launches


# ---------------------------------------------------------------------------
# phase 8: the parallel path (torch.distributed.run) through the command line
# ---------------------------------------------------------------------------

PAR_STEPS, PAR_WARM = 40, 20


def _launch(name, ranks, conf_spec, sets, env=None, mesh_resolution=64,
            timeout=600):
    """``--mode train_rnb`` of the CLI on ``ranks`` processes of
    torch.distributed.run (0: one process, no group) from the repository
    root, with ``env`` added to the environment; any rank's failure raises
    (torchrun exits non-zero). -> (its output with the errors, the per-rank
    JSON lines, the chief's seconds and steps of training, and its rays/s
    over the last report window, which leaves out the first steps)."""
    from rnb_tpu_torch.tools.run_e2e import result_lines

    launch = ([] if ranks == 0 else
              ["torch.distributed.run", "--standalone", "--nproc_per_node",
               str(ranks), "-m"])
    args = [sys.executable, "-m", *launch, "rnb_tpu_torch.cli", "--mode",
            "train_rnb", "--conf", conf_spec[0], "--mesh_resolution",
            str(mesh_resolution),
            *(a for o in (*conf_spec[1], *sets) for a in ("--set", o))]
    t0 = time.perf_counter()
    proc = subprocess.run(args, cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="2",
                                                   **(env or {})),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(args[2:])} exited {proc.returncode}:\n"
                           f"{proc.stdout[-12000:]}")
    lines = result_lines(proc.stdout)
    assert len(lines) == max(ranks, 1), f"{len(lines)} result lines"
    wall = next(l for l in proc.stdout.splitlines() if l.startswith("trained "))
    window = re.findall(r"iter:\s*\d+ .*? rays/s=(\d+)", proc.stdout)[-1]
    log(f"[parallel] {name}: {ranks or 'one'} rank(s), rc 0 in {secs:.1f} s "
        f"with start-up; {wall}")
    return (proc.stdout, lines, float(wall.split()[4]), int(wall.split()[1]),
            float(window))


def _par_sets(case, exp, steps, warm):
    return [f"dataset.data_dir={case}", f"general.base_exp_dir={exp}",
            f"train.end_iter={steps}", f"train.warm_up_iter={warm}",
            "train.warm_up_end=50", f"train.save_freq={steps}",
            "train.val_freq=100000", "train.val_mesh_freq=100000",
            "train.report_freq=5"]


def _check_ranks(lines, kernels, where):
    """Every rank launched each kernel of ``kernels`` (its own counters),
    no f32 route, and the ranks' parameters are equal bit for bit."""
    for line in lines:
        c = line["launches"]
        log(f"[parallel] {where} rank {line['rank']} of {line['world']}: "
            f"params {line['params_sha256'][:16]}, launches {c}")
        for k in kernels:
            assert c[k] > 0, f"{where}: rank {line['rank']} did not launch {k}"
        check_dw_launches(c, f"{where} rank {line['rank']}")
        for k in F32_ROUTE:
            assert c[k] == 0, f"{where}: rank {line['rank']} launched {k}"
    assert len({l["params_sha256"] for l in lines}) == 1, \
        f"{where}: the ranks' parameters differ"


def _losses_close(got, ref, tol, where, steps=None):
    """Per-step relative differences of two runs' losses, logged; those of
    ``steps`` (all by default) held within ``tol``. -> their maximum."""
    assert sorted(got) == sorted(ref)[:len(got)], (where, sorted(got))
    diffs = {s: abs(got[s] - ref[s]) / abs(ref[s]) for s in sorted(got)}
    held = [diffs[s] for s in (steps or diffs)]
    log(f"[parallel] {where}: max rel diff {max(held):.3e} over steps "
        f"{steps or 'all'} (tol {tol:g}); by step "
        + " ".join(f"{d:.1e}" for d in diffs.values()))
    assert np.isfinite(list(got.values())).all() and max(held) <= tol, where
    return max(held)


def _moments_close(exp, ref_exp, step, tol, where):
    """Adam's moments in the two runs' step-``step`` checkpoints within
    ``tol`` of the reference's norm: the moments average every step's
    gradient, so the all-reduced gradient equals the one-rank gradient."""
    name = f"checkpoints/ckpt_{step:06d}.npz"
    with np.load(os.path.join(exp, name)) as a, \
            np.load(os.path.join(ref_exp, name)) as b:
        n = int(a["__n_leaves__"])
        P = (n - 3) // 3       # params, count, mu, nu, count, step
        err = {}
        for key, lo in (("params", 0), ("mu", P + 1), ("nu", 2 * P + 1)):
            got = [a[f"leaf_{i:06d}"] for i in range(lo, lo + P)]
            want = [b[f"leaf_{i:06d}"] for i in range(lo, lo + P)]
            err[key] = rel_err([torch.from_numpy(x) for x in got],
                               [torch.from_numpy(x) for x in want])[1]
    log(f"[parallel] {where}: step-{step} checkpoints, norm-relative error "
        f"{err} (tol {tol:g}; frozen parameters must be equal)")
    assert err["params"] == 0.0 and max(err.values()) <= tol, where
    return err


def _runner_on(case, exp, device):
    """A Runner on the newest checkpoint of ``exp`` (wmask conf)."""
    from rnb_tpu_torch.train.runner import Runner

    return Runner(WMASK[0], "validate_mesh", is_continue=True, device=device,
                  overrides=[f"dataset.data_dir={case}",
                             f"general.base_exp_dir={exp}"])


def grid_worker(case, exp, out_path):
    """One rank of phase 8's grid check: the sharded grid query at 128³ on
    the trained weights of ``exp``; the chief saves it to ``out_path``. Run
    under torch.distributed.run (``chip_smoke.py --grid-worker``)."""
    from rnb_tpu_torch.parallel import mesh as meshlib
    from rnb_tpu_torch.parallel.grid import extract_fields_sharded

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    if not meshlib.maybe_initialize_distributed("cuda"):
        raise SystemExit("chip_smoke --grid-worker: run it under "
                         "torch.distributed.run")
    runner = _runner_on(case, exp, meshlib.rank_device("cuda"))
    ds_ = runner.dataset
    grid = extract_fields_sharded(runner.statics, runner.state.params,
                                  ds_.object_bbox_min, ds_.object_bbox_max, 128)
    if meshlib.is_chief():
        np.save(out_path, grid)
    torch.distributed.destroy_process_group()


def parallel_path(dev, card, tmp):
    """Phase 8 on phase 6's case in ``tmp``; -> (result, the launches of
    every rank of the group runs, summed)."""
    from rnb_tpu_torch.models import renderer as rnd

    case = os.path.join(tmp, "sphere")
    gloo = {"RNB_DIST_BACKEND": "gloo"}   # two ranks share the one card
    result, launches = {}, {}

    def add(lines):
        for line in lines:
            for k, v in line["launches"].items():
                launches[k] = launches.get(k, 0) + v

    def timing(name, secs, steps, rays_s, ranks):
        steady = 512 / rays_s * 1e3      # the confs' batch of 512 rays
        result[name] = {"train_s": secs, "steps": steps,
                        "ms_per_step": secs / steps * 1e3,
                        "last5_ms_per_step": steady, "ranks": ranks}
        log(f"[parallel] {card}: {name}: {steps} steps in {secs:.3f} s "
            f"({secs / steps * 1e3:.2f} ms a step with the first), "
            f"{steady:.2f} ms a step over the last 5, {ranks} rank(s)"
            + (" sharing the one card" if ranks > 1 else ""))

    # 8.1 replicated data, two ranks: the training run, against one
    # process; the parameters are the same in both at steps 1 and 2 (the
    # learning rate of step 0 is 0), after which the bf16 kernels amplify
    # the sums' order (their operands round the weights)
    exp1, exp0 = os.path.join(tmp, "par_rep"), os.path.join(tmp, "par_one")
    _, lines, secs, n, rps = _launch("replicated", 2, WMASK,
                                _par_sets(case, exp1, PAR_STEPS, PAR_WARM),
                                gloo, mesh_resolution=128)
    _check_ranks(lines, WMASK_KERNELS, "replicated")
    add(lines)
    timing("replicated_2", secs, n, rps, 2)
    assert os.listdir(os.path.join(exp1, "meshes")) == [f"{PAR_STEPS:08d}.ply"]
    _, _, secs, n, rps = _launch("replicated, reference", 0, WMASK,
                            _par_sets(case, exp0, PAR_STEPS, PAR_WARM))
    timing("one_process", secs, n, rps, 1)
    result["replicated_rel_diff_steps_1_2"] = _losses_close(
        _losses(exp1), _losses(exp0), 1e-5, "2 ranks vs one process", steps=[1, 2])
    result["replicated_drift"] = {
        s: abs(_losses(exp1)[s] - v) / abs(v) for s, v in _losses(exp0).items()}
    out = os.path.join(tmp, "grid128.npy")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", str(ROOT / "chip_smoke.py"), "--grid-worker",
         case, exp1, out], cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="2", **gloo),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-8000:]
    sharded = np.load(out)
    runner = _runner_on(case, exp1, dev)
    serial = rnd.extract_fields(runner.statics, runner.state.params,
                                runner.dataset.object_bbox_min,
                                runner.dataset.object_bbox_max, 128)
    grid_err = float(np.abs(sharded - serial).max())
    log(f"[parallel] sharded grid 128^3 (2 ranks, {time.perf_counter() - t0:.1f} s "
        f"with start-up) vs one process: max abs diff {grid_err:.3e} (tol 1e-3)")
    assert grid_err <= 1e-3, "the sharded grid differs"
    result["grid_max_abs_diff"] = grid_err

    # 8.1' the exact global loss, step by step: frozen parameters
    # (learning rate 0), so every step's loss and gradient are taken at the
    # same parameters in both runs and differ only by the order of the sums
    frozen = ["train.learning_rate=0"]
    exp_f2, exp_f1 = os.path.join(tmp, "par_frozen"), os.path.join(tmp, "par_frozen_one")
    _, lines, secs, n, rps = _launch("frozen", 2, WMASK, _par_sets(
        case, exp_f2, PAR_STEPS, PAR_WARM) + frozen, gloo)
    _check_ranks(lines, WMASK_KERNELS, "frozen")
    add(lines)
    timing("frozen_2", secs, n, rps, 2)
    _, _, secs, n, rps = _launch("frozen, reference", 0, WMASK, _par_sets(
        case, exp_f1, PAR_STEPS, PAR_WARM) + frozen)
    timing("frozen_one_process", secs, n, rps, 1)
    frozen_one = _losses(exp_f1)
    result["frozen_rel_diff"] = _losses_close(_losses(exp_f2), frozen_one, 1e-5,
                                              "frozen, 2 ranks vs one process")
    result["frozen_moments"] = _moments_close(exp_f2, exp_f1, PAR_STEPS, 1e-4,
                                              "frozen, 2 ranks vs one process")

    # 8.2 view-sharded, two ranks: each reads only its 3 of the 6 views
    exp2 = os.path.join(tmp, "par_views")
    text, lines, secs, n, rps = _launch("view-sharded", 2, WMASK,
                                   _par_sets(case, exp2, PAR_STEPS, PAR_WARM)
                                   + ["train.view_shard=true"], gloo)
    _check_ranks(lines, WMASK_KERNELS, "view-sharded")
    add(lines)
    timing("view_sharded_2", secs, n, rps, 2)
    loaded = sorted(re.findall(r"rank \d of 2 loads global views \[[\d, ]*\] "
                               r"of \d+", text))
    log(f"[parallel] view-sharded: {loaded}")
    assert loaded == ["rank 0 of 2 loads global views [0, 1, 2] of 6",
                      "rank 1 of 2 loads global views [3, 4, 5] of 6"], loaded
    views = _losses(exp2)
    assert sorted(views) == list(range(1, PAR_STEPS + 1))
    assert np.isfinite(list(views.values())).all()
    assert os.listdir(os.path.join(exp2, "logs")).count("scalars.jsonl") == 1
    assert sorted(os.listdir(os.path.join(exp2, "checkpoints"))) == [
        f"ckpt_{PAR_STEPS:06d}.npz"]

    # 8.3 womask, two ranks against one process, frozen: the NeRF kernels
    # under the group
    exp3, exp3_one = os.path.join(tmp, "par_womask"), os.path.join(tmp, "par_womask_one")
    _, lines, secs, n, rps = _launch("womask", 2, WOMASK,
                                _par_sets(case, exp3, 10, 5) + frozen, gloo)
    _check_ranks(lines, WOMASK_KERNELS, "womask")
    add(lines)
    timing("womask_2", secs, n, rps, 2)
    _, _, secs, n, rps = _launch("womask, reference", 0, WOMASK,
                            _par_sets(case, exp3_one, 10, 5) + frozen)
    timing("womask_one_process", secs, n, rps, 1)
    result["womask_rel_diff"] = _losses_close(_losses(exp3), _losses(exp3_one),
                                              1e-5, "womask, frozen, 2 ranks vs one process")
    result["womask_moments"] = _moments_close(exp3, exp3_one, 10, 1e-4,
                                              "womask, frozen, 2 ranks vs one process")

    # 8.4 NCCL at world 1: the collective path on the card's own backend,
    # against the frozen one-process run's first 10 steps
    exp4 = os.path.join(tmp, "par_nccl")
    text, lines, secs, n, rps = _launch("nccl", 1, WMASK,
                                   _par_sets(case, exp4, 10, PAR_WARM) + frozen,
                                   {"RNB_DIST_BACKEND": "nccl"})
    assert "backend nccl" in text, "the group did not start on NCCL"
    _check_ranks(lines, WMASK_KERNELS, "nccl")
    add(lines)
    timing("nccl_1", secs, n, rps, 1)
    result["nccl_rel_diff"] = _losses_close(_losses(exp4), frozen_one, 1e-5,
                                            "NCCL world 1 vs one process")
    return result, launches


# ---------------------------------------------------------------------------
# phase 9: scene normalization, a no-albedo run on the normalized non-square
# case through the command line, the Chamfer and camera tools
# ---------------------------------------------------------------------------

def _scale_mat(case):
    with np.load(os.path.join(case, "cameras.npz")) as c:
        return np.asarray(c["scale_mat_0"], np.float64)


def _unnormalized_copy(src, dst):
    """``src`` with identity scale mats: the case as it was written before
    its normalization (which rewrites only the scale mats)."""
    shutil.copytree(src, dst)
    with np.load(os.path.join(src, "cameras.npz")) as c:
        cams = {k: (np.eye(4, dtype=c[k].dtype) if k.startswith("scale_mat")
                    else c[k]) for k in c.files}
    np.savez(os.path.join(dst, "cameras.npz"), **cams)


def _torus_ply(path, center, R=0.5, r=0.22, n_u=400, n_v=160):
    """The analytic torus as a triangle mesh (a u x v grid of quads)."""
    from rnb_tpu_torch.utils.io import write_ply

    u, v = np.meshgrid(np.linspace(0, 2 * np.pi, n_u, endpoint=False),
                       np.linspace(0, 2 * np.pi, n_v, endpoint=False),
                       indexing="ij")
    verts = np.stack([(R + r * np.cos(v)) * np.cos(u),
                      (R + r * np.cos(v)) * np.sin(u), r * np.sin(v)],
                     -1).reshape(-1, 3) + np.asarray(center)
    i, j = np.meshgrid(np.arange(n_u), np.arange(n_v), indexing="ij")
    a, b = i * n_v + j, ((i + 1) % n_u) * n_v + j
    c, d = ((i + 1) % n_u) * n_v + (j + 1) % n_v, i * n_v + (j + 1) % n_v
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    write_ply(path, verts.astype(np.float32), faces.astype(np.int32))


def normalized_noalbedo_path(dev, card, tmp):
    """Phase 9 in ``tmp``; -> (result, the CLI run's launches)."""
    from rnb_tpu_torch.preprocess.preprocess_cameras import get_normalization
    from rnb_tpu_torch.train.runner import Runner
    from rnb_tpu_torch.utils.bridge import tree_leaves
    from rnb_tpu_torch.utils.io import read_ply

    t_phase = time.perf_counter()
    result = {}
    where_dev = torch.device(dev).type
    on = ["--device", where_dev]
    # (1) the 612x512 capture, written un-normalized and normalized on the
    # card by the case writer's --normalize; then the same normalization
    # in-process, on the card and on the CPU, of un-normalized copies
    case = os.path.join(tmp, "torus_ns")
    _, secs = _sub(["rnb_tpu_torch.tools.make_synthetic_case", "--out", case,
                    "--shape", "torus", "--degrade", "--n_views", "8",
                    "--width", "612", "--height", "512", "--center",
                    *map(str, CENTER), "--normalize", *on], 600)
    result["write_and_normalize_s"] = secs
    s_tool = _scale_mat(case)
    mats = {}
    for label, where in (("card", where_dev), ("cpu", "cpu")):
        copy = os.path.join(tmp, f"torus_ns_{label}")
        _unnormalized_copy(case, copy)
        assert np.array_equal(_scale_mat(copy), np.eye(4))
        t0 = time.perf_counter()
        get_normalization(copy, refine_hull=True, device=where)
        result[f"normalize_{label}_s"] = time.perf_counter() - t0
        mats[label] = _scale_mat(copy)
    # the CLI of the normalization itself, on the card, on a third copy
    copy = os.path.join(tmp, "torus_ns_cli")
    _unnormalized_copy(case, copy)
    _sub(["rnb_tpu_torch.preprocess.preprocess_cameras", "--source_dir", copy,
          "--refine_visual_hull", *on], 300)
    mats["cli"] = _scale_mat(copy)
    norm = np.linalg.norm(mats["cpu"])
    diffs = {k: float(np.linalg.norm(m - mats["cpu"]) / norm)
             for k, m in (("tool", s_tool), ("card", mats["card"]),
                          ("cli", mats["cli"]))}
    scale, t = float(s_tool[0, 0]), s_tool[:3, 3]
    log(f"[normalize] 612x512, 8 views ({card}): card {result['normalize_card_s']:.3f} s, "
        f"CPU {result['normalize_cpu_s']:.3f} s in-process; scale {scale!r}, "
        f"t {t.tolist()}; relative differences to the CPU's: {diffs}")
    assert max(diffs.values()) <= 1e-9, "card and CPU normalizations differ"
    assert abs(scale - 1.0) > 0.05 and np.abs(t).max() > 0.05, "not normalized"
    assert np.abs(t - np.asarray(CENTER)).max() < 0.05, "normalization centre"
    result.update(scale=scale, t=t.tolist(), rel_diff_to_cpu=diffs)

    # (2) 400 steps of the no-albedo conf on it through the CLI
    exp = os.path.join(tmp, "exp_ns")
    sets = [f"dataset.data_dir={case}", f"general.base_exp_dir={exp}",
            "train.end_iter=400", "train.warm_up_iter=300",
            "train.warm_up_end=50", "train.save_freq=200",
            "train.val_freq=200", "train.val_mesh_freq=400",
            "train.report_freq=100"]
    setargs = [a for x in sets for a in ("--set", x)]
    cli = ["rnb_tpu_torch.cli", "--conf", WMASK_NOALB[0], *on]
    out, run_secs = _sub(cli + ["--mode", "train_rnb", "--mesh_resolution",
                                "64"] + setargs, 900)
    counts = json.loads(next(l for l in out.splitlines()
                             if l.startswith('{"launches"')))["launches"]
    log(f"[noalbedo] launches in the CLI run: {counts}")
    for k in WMASK_NOALB_KERNELS:
        assert counts[k] > 0, f"kernel {k} was not launched by the no-albedo run"
    check_dw_launches(counts, "the no-albedo run")
    for k in ALBEDO_KERNELS + F32_ROUTE:
        assert counts[k] == 0, f"the no-albedo run launched {k}"
    wall = next(l for l in out.splitlines() if l.startswith("trained "))
    steps, secs = int(wall.split()[1]), float(wall.split()[4])
    assert steps == 400, wall
    ls = np.array([v for _, v in sorted(_losses(exp).items())])
    assert len(ls) == 400 and np.isfinite(ls).all(), "no-albedo losses"

    # the colour net as initialised (the runner's seed), bit for bit
    init = Runner(WMASK_NOALB[0], "validate_mesh", overrides=sets[:1] + [
        f"general.base_exp_dir={os.path.join(tmp, 'exp_ns_init')}"], device=dev)
    trained = Runner(WMASK_NOALB[0], "validate_mesh", is_continue=True,
                     overrides=sets, device=dev)
    assert trained.iter_step == 400
    assert trained.no_albedo and init.no_albedo
    for a, b in zip(tree_leaves(trained.state.params["color"]),
                    tree_leaves(init.state.params["color"])):
        assert torch.equal(a, b), "the colour net moved in a no-albedo run"
    moved = sum(int(not torch.equal(a, b)) for a, b in zip(
        tree_leaves(trained.state.params["sdf"]),
        tree_leaves(init.state.params["sdf"])))
    assert moved > 0, "the SDF net did not move"
    del init, trained

    # (3) the world-space mesh at 128^3 through --mode validate_mesh
    _sub(cli + ["--mode", "validate_mesh", "--mesh_resolution", "128"]
         + setargs, 300)
    mesh = os.path.join(exp, "meshes", "00000400.ply")
    v, f, _ = read_ply(mesh)
    centre = (v.min(0) + v.max(0)) / 2
    log(f"[noalbedo] world-space mesh: {len(v)} vertices, bbox centre "
        f"{centre.tolist()} (object at {CENTER})")
    assert np.abs(centre - np.asarray(CENTER)).max() < 0.05, "mesh centre"

    # (4) the Chamfer CLI against the analytic torus, the camera tool
    gt = os.path.join(tmp, "torus_gt.ply")
    _torus_ply(gt, CENTER)
    ch_out, _ = _sub(["rnb_tpu_torch.tools.eval_chamfer", mesh, gt,
                      "--n_points", "20000", "--json"], 300)
    chamfer = json.loads(ch_out.strip().splitlines()[-1])
    assert all(np.isfinite(x) for x in chamfer.values()), chamfer
    cams_out, _ = _sub(["rnb_tpu_torch.tools.inspect_cameras",
                        os.path.join(case, "cameras.npz")], 120)
    assert "8 views" in cams_out.splitlines()[0], cams_out

    result.update(steps=steps, train_s=secs, cli_process_s=run_secs,
                  loss_first20=float(ls[:20].mean()),
                  loss_last20=float(ls[-20:].mean()),
                  mesh_bbox_centre=centre.tolist(),
                  chamfer_l1=chamfer["chamfer_l1"],
                  wall_s=time.perf_counter() - t_phase)
    log(f"[phase 9] {card}: {result}")
    return result, counts


# ---------------------------------------------------------------------------
# phase 10: the kill-and-resume gate, the launch scripts, two nodes
# ---------------------------------------------------------------------------

E2E_STEPS, E2E_WARM, E2E_KILL = 600, 400, 200


def _p10_env(extra=None):
    """Phase 10's tools run in its work directory: the package importable,
    this interpreter first on PATH (the launch scripts call ``python``),
    two host threads a process (three lanes share the host)."""
    return {"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2",
            "PATH": os.path.dirname(sys.executable) + os.pathsep + os.environ["PATH"],
            **(extra or {})}


def _check_counts(counts, where):
    """The wmask path's bf16 kernels each launched, no f32 route."""
    log(f"[phase 10] {where}: launches {counts}")
    for k in WMASK_KERNELS:
        assert counts[k] > 0, f"{where}: {k} was not launched"
    check_dw_launches(counts, where)
    for k in F32_ROUTE:
        assert counts[k] == 0, f"{where}: the f32 route launched ({k})"


def _e2e_lane(card, work):
    """10.1 the kill-and-resume gate at a cut schedule on a 256x256 sphere
    of its own (phase 6's): SIGTERM once the step-200 checkpoint exists, a
    resume to 600 (crossing the warm-up end at 400) with a 128^3 mesh, the
    sphere gate at phase 6's 0.02. -> (result, launch counts)."""
    out, secs = _sub([
        "rnb_tpu_torch.tools.run_e2e",
        "--kill_at_ckpt", str(E2E_KILL), "--iters", str(E2E_STEPS),
        "--warmup", str(E2E_WARM), "--case", "sphere_e2e", "--shape", "sphere",
        "--radius", "0.35", "--n_views", "6", "--size", "256",
        "--mesh_resolution", "128", "--threshold", "0.02",
        "--set", f"train.save_freq={E2E_KILL}"], 600, cwd=work, env=_p10_env())
    rec = json.loads(out.strip().splitlines()[-1])
    log(f"[phase 10] run_e2e record: {json.dumps(rec)}")
    assert rec["accepted"] and rec["card"] == card, rec["failures"]
    assert rec["leg1"]["rc"] == -15, "the first leg did not end by SIGTERM"
    assert rec["resumed_from"] == rec["find_checkpoint"] == E2E_KILL
    assert rec["resumed_steps"] == [E2E_KILL + 1, E2E_STEPS]
    assert rec["resumed_crosses_warmup"] and rec["kill_inside_warmup"]
    _check_counts(rec["launches"], "run_e2e, the resumed leg")
    return {"s": secs, "chamfer_l1": rec["chamfer_l1"],
            "resumed_from": rec["resumed_from"],
            "killed_after_step": rec["killed_after_step"],
            "overlap": rec["overlap"], "leg1_s": rec["leg1"]["wall_s"],
            "leg2_s": rec["leg2"]["wall_s"]}, [rec["launches"]]


def _scripts_lane(work):
    """10.2 the one-card launch script, 20 steps (10 warm-up) mapped from
    the environment, its log tee'd under the current directory; 10.3 the
    multi-card script with two ranks sharing the card (gloo by the backend
    rule: two local ranks, one card). -> (result, launch counts)."""
    from rnb_tpu_torch.tools.multinode_smoke import free_port
    from rnb_tpu_torch.tools.run_e2e import loss_segments, result_lines

    def steps(exp):
        (seg,) = loss_segments(os.path.join(work, exp, "logs", "scalars.jsonl"))
        return sorted(seg)

    jobs = ROOT / "rnb_tpu_torch" / "jobs"
    sets = ["--mesh_resolution", "64", "--set", "train.report_freq=10"]
    env = {"N_ITERATIONS": "20", "WARM_UP_ITER": "10"}
    result, counts = {}, []
    out, result["train_h100_s"] = _sub([
        str(jobs / "train_h100.sh"), "sphere", str(ROOT / WMASK[0]),
        *sets, "--set", "general.base_exp_dir=exp/one_card"], 600, cwd=work,
        env=_p10_env(env), run=("bash",))
    (line,) = result_lines(out)
    _check_counts(line["launches"], "train_h100.sh")
    counts.append(line["launches"])
    assert steps("exp/one_card") == list(range(1, 21))
    (tee,) = os.listdir(os.path.join(work, "exp", "sphere", "logs_launch"))
    assert "trained 20 steps" in open(os.path.join(
        work, "exp", "sphere", "logs_launch", tee)).read()

    out, result["train_h100_multi_s"] = _sub([
        str(jobs / "train_h100_multi.sh"), "sphere", str(ROOT / WMASK[0]),
        *sets, "--set", "general.base_exp_dir=exp/multi_card"], 600, cwd=work,
        env=_p10_env(dict(env, NPROC_PER_NODE="2", MASTER_PORT=str(free_port()))),
        run=("bash",))
    lines = result_lines(out)
    assert sorted((l["rank"], l["world"]) for l in lines) == [(0, 2), (1, 2)]
    assert lines[0]["params_sha256"] == lines[1]["params_sha256"]
    for l in lines:
        _check_counts(l["launches"], f"train_h100_multi.sh rank {l['rank']}")
        counts.append(l["launches"])
    assert steps("exp/multi_card") == list(range(1, 21))
    return result, counts


def _multinode_lane(work):
    """10.4 two nodes of one rank each on the one card. Each node counts
    one local rank, so the backend rule would pick NCCL, which refuses two
    ranks on one device: gloo is set. The tool compares two nodes with one
    process at frozen parameters on the card (at the conf's rate the bf16
    runs drift from step 3, as in phase 8), and the stopped-and-resumed
    nodes with a straight two-node run at the conf's rate.
    -> (result, launch counts)."""
    out, secs = _sub(["rnb_tpu_torch.tools.multinode_smoke", "--case",
                      "data/sphere"], 900, cwd=work,
                     env=_p10_env({"RNB_DIST_BACKEND": "gloo"}))
    res = json.loads(out.strip().splitlines()[-1])
    counts = res.pop("launches")
    _check_counts(counts, "multinode_smoke, all ranks")
    assert res["two_vs_one"] <= 1e-5 and res["resume_vs_straight"] <= 1e-6, res
    return dict(res, s=secs), [counts]


def resume_launch_path(card, tmp):
    """Phase 10 in ``tmp``, on phase 6's sphere case; -> (result, the
    launches of its CLI runs that ran to their end, summed). Its three
    lanes run at once, each in processes of its own on the one card, so
    the phase takes its longest lane's time; their walls are walls on a
    shared card and host."""
    from concurrent.futures import ThreadPoolExecutor

    work = os.path.join(tmp, "p10")
    os.makedirs(os.path.join(work, "data"))
    os.symlink(os.path.join(tmp, "sphere"), os.path.join(work, "data", "sphere"))
    t_phase = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        lanes = {"e2e": pool.submit(_e2e_lane, card, work),
                 "scripts": pool.submit(_scripts_lane, work),
                 "multinode": pool.submit(_multinode_lane, work)}
        done = {name: f.result() for name, f in lanes.items()}
    result = {name: r for name, (r, _) in done.items()}
    launches = {}
    for _, counts in done.values():
        for c in counts:
            for k, v in c.items():
                launches[k] = launches.get(k, 0) + v
    result["wall_s"] = time.perf_counter() - t_phase
    log(f"[phase 10] {card}: {json.dumps(result)}")
    return result, launches


# ---------------------------------------------------------------------------
# phase 11: the measuring tools
# ---------------------------------------------------------------------------

# the tune instances phase 11 launches: (counter, kernel of phase 1 whose
# work it does, its TPU kernel)
SMOKE_DEPTHS = (3, 4)
TUNE_KERNELS = {f"sdf_core_{d}_rs{rs}": (f"sdf_core_{d}", KERNELS[f"sdf_core_{d}"][1])
                for rs in SMOKE_DEPTHS for d in ("fwd", "bwd")}


def _positive(x, what):
    assert isinstance(x, float) and np.isfinite(x) and x > 0, f"{what}: {x}"


def measuring_tools(card, tune_build, work):
    """Phase 11: the six measuring tools through their main(argv), in this
    process (each start would cost 15-25 s), at a cut depth; consolidate_
    parity on ``work``, phase 10's directory with the cut e2e gate's
    record. -> (result, the tune rows by counter)."""
    from rnb_tpu_torch.ops import _build
    from rnb_tpu_torch.tools import (bench, bench_scaling, bench_step,
                                     consolidate_parity, roofline,
                                     tune_kernel)

    result, t_phase = {}, time.perf_counter()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, RNB_BENCH_ITERS="10"):
        r = bench.main([])
    assert r["card"] == card
    for k in ("value", "warmup_phase_rays_per_s_per_chip",
              "view_shard_rays_per_s_per_chip"):
        _positive(r[k], f"bench {k}")
    assert 0 < r["mfu"]["mfu_executed_pct"] <= 100, r["mfu"]
    assert [b["batch"] for b in r["batch_curve"]] == [2048, 8192]
    for b in r["batch_curve"]:
        _positive(b["rays_per_s_per_chip"], f"bench batch {b['batch']}")
        _positive(b["peak_mem_gb"], f"bench batch {b['batch']} memory")
    result["bench"] = {"s": time.perf_counter() - t0, "rays_per_s": r["value"],
                       "warmup": r["warmup_phase_rays_per_s_per_chip"],
                       "view_shard": r["view_shard_rays_per_s_per_chip"],
                       "mfu_executed_pct": r["mfu"]["mfu_executed_pct"],
                       "batch_curve": r["batch_curve"],
                       "peak_mem_gb": r["peak_mem_gb"]}

    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, RNB_SWEEP_BATCHES="512,2048",
                         RNB_SWEEP_ITERS="10"):
        r = bench_step.main([])
    assert [row["batch"] for row in r["rows"]] == [512, 2048]
    for row in r["rows"]:
        assert row["card"] == card
        for k in ("ms_per_step", "rays_per_s", "compile_s", "loss3"):
            _positive(row[k], f"bench_step {row['batch']} {k}")
    result["bench_step"] = {"s": time.perf_counter() - t0, "ms_per_step": {
        row["batch"]: row["ms_per_step"] for row in r["rows"]}}

    t0 = time.perf_counter()
    r = roofline.main(["--iters", "10"])
    assert r["env"]["card"] == card and r["env"]["ring_depth"] == 4
    for k in ("step_main", "step_warm", "core_fwd", "core_fwd_bwd",
              "upsample_render_fwd", "color_fwd", "adam", "data_sample"):
        _positive(r[k]["ms"], f"roofline {k}")
    assert np.isfinite(r["residual"]["ms"])
    assert 0 < r["step_main"]["pct_bf16_peak"] <= 100, r["step_main"]
    result["roofline"] = {"s": time.perf_counter() - t0,
                          **{k: v["ms"] for k, v in r.items() if "ms" in v}}

    t0 = time.perf_counter()
    tune_build.result()   # the tune library, built beside phase 1 onwards
    tune_ptxas = _build.ptxas_summary("sdf_", kind="tune")
    for name, rep in tune_ptxas.items():
        log(f"[ptxas tune] {name}: {rep}")
    for name, want in PTXAS_NOTE.items():   # the same production instances
        assert not tune_ptxas or _ptxas_numbers(tune_ptxas[name]) == want, name
    r = tune_kernel.main(["--iters", "10", "--fwd_rs", *map(str, SMOKE_DEPTHS),
                          "--bwd_rs", *map(str, SMOKE_DEPTHS)])
    assert not r["failed"], r["failed"]
    assert r["card"] == card
    tune_rows = {}
    splits = [row["splits"] for row in r["rows"] if row["axis"] == "splits"]
    assert splits == tune_kernel.split_axis(r["production"]["splits"]), splits
    for row in r["rows"]:
        if row["axis"] == "splits":
            _positive(row["ms"], f"tune splits {row['splits']}")
            continue
        d = "fwd" if row["axis"] == "fwd" else "bwd"
        tune_rows[f"sdf_core_{d}_rs{row['rs']}"] = dict(
            row, ms=row["ms"] if d == "fwd" else row["bwd_ms"])
        assert row["rel_err"] <= BF16_TOL, row
        assert row["bitwise_equal_production"], row
    for k in TUNE_KERNELS:
        _positive(tune_rows[k]["ms"], f"tune {k}")
    result["tune_kernel"] = {"s": time.perf_counter() - t0,
                             "fastest": r["fastest"], "ms": r["ms"],
                             "dw_matmul_ms": r["dw_matmul_ms"]}

    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, RNB_SCALING_ITERS="10"):
        r = bench_scaling.main([])
    assert r["widths"] == [1] and r["scaling_efficiency_vs_1dev"] is None, r
    row = r["rows"][0]
    assert row["card"] == card and row["backend"] == "nccl", row
    _positive(row["rays_per_s"], "bench_scaling width 1")
    assert np.isfinite(row["loss"])
    result["bench_scaling"] = {"s": time.perf_counter() - t0,
                               "rays_per_s": row["rays_per_s"],
                               "note": r["note"]}

    t0 = time.perf_counter()
    here = os.getcwd()
    os.chdir(work)
    try:
        r = consolidate_parity.main([])
        with open(os.path.join("exp", "e2e.json")) as f:
            e2e = json.load(f)
    finally:
        os.chdir(here)
    rows = {g["gate"]: g for g in r["gates"]}
    assert rows["e2e"]["status"] == "pass" and rows["e2e"]["card"] == card
    assert rows["e2e"]["chamfer_l1"] == e2e["chamfer_l1"]
    assert rows["e2e"]["threshold"] == e2e["acceptance"]["threshold"]
    assert r["missing"] == [g for g in rows if g != "e2e"]
    assert not r["all_accepted"]
    result["consolidate_parity"] = {"s": time.perf_counter() - t0,
                                    "e2e": rows["e2e"]["chamfer_l1"],
                                    "missing": r["missing"]}
    result["wall_s"] = time.perf_counter() - t_phase
    log(f"[phase 11] {card}: {json.dumps(result)}")
    return result, tune_rows


# ptxas's report of the production SDF-core kernels (the note in
# csrc/sdf_core.cu): the tensor-core sweeps exactly, the f32 ones no worse;
# the grouped dW kernel's (the note in csrc/dw_gemm.cu) exactly, in the
# production library only
PTXAS_NOTE = {"sdf_fwd_wg_kernel<0, 4>": (128, 80, 84),
              "sdf_bwd_sweep_kernel<16, 0>": (128, 0, 0)}
PTXAS_DW = {"rnb_dw_products_kernel": (168, 0, 0)}
PTXAS_F32 = {"sdf_fwd_kernel<0>": (128, 72), "sdf_bwd_kernel": (72, 0)}


def _ptxas_numbers(rep):
    return tuple(int(x) for x in re.findall(r"(\d+) (?:registers|B)", rep))


def check_ptxas(report):
    """Log the production build's ptxas lines and hold the SDF core's
    against the source's note; the production library holds no instance
    at another ring depth."""
    for name, rep in report.items():
        log(f"[ptxas] {name}: {rep}")
    if not report:
        log("[ptxas] the library was built before this process: no report")
        return
    for name, want in {**PTXAS_NOTE, **PTXAS_DW}.items():
        assert _ptxas_numbers(report[name]) == want, (name, report[name])
    for name, (regs, spill) in PTXAS_F32.items():
        got = _ptxas_numbers(report[name])
        assert got[0] <= regs and max(got[1:]) <= spill, (name, report[name])
    other = [n for n in report if re.match(r"sdf_fwd_wg_kernel<.*\b[356]>", n)
             or (n.startswith("sdf_bwd_sweep_kernel<") and n not in PTXAS_NOTE)]
    assert not other, f"tune instances in the production library: {other}"


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
    # phase 11's tune library builds beside the production one and phases 1-10
    tune_pool = ThreadPoolExecutor(1)
    tune_build = tune_pool.submit(_build.library, "tune")
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({_build.build_info['main']['path']})")
    check_ptxas(_build.ptxas_summary("sdf_", "dw_products", "albedo_", "nerf_"))
    assert not hasattr(_build.library(), "rnb_sdf_fwd_wg_tune"), \
        "the production library holds the tune entries"

    kern = kernel_checks(dev)
    summary = {"card": card, "dw_products": {
        k: kern[k] for k in DW_GROUPS}}
    counts = {}
    for label, spec, kernels, f32_kernels in (
            ("wmask", WMASK, WMASK_KERNELS, WMASK_F32),
            ("womask", WOMASK, WOMASK_KERNELS, WOMASK_F32)):
        phases, run_counts = slice_run(dev, spec, kernels)
        counts.update({k: run_counts[k] for k in kernels if k not in counts})
        parity, f32_counts = slice_parity(dev, spec, f32_kernels)
        counts.update({k: v for k, v in f32_counts.items() if k not in counts})
        summary[label] = {"slice": phases, "parity": parity,
                          "train": training_moves(dev, spec),
                          "launches": run_counts}
    # phase 9's no-albedo steps: phases 2-3 of the two no-albedo confs; the
    # SDF core (and NeRF) launch as in the albedo confs' steps, the albedo
    # kernels never
    noalb_launches = {}
    for label, spec, kernels, f32_kernels, ref in (
            ("wmask_noalbedo", WMASK_NOALB, WMASK_NOALB_KERNELS,
             WMASK_NOALB_F32, "wmask"),
            ("womask_noalbedo", WOMASK_NOALB, WOMASK_NOALB_KERNELS,
             WOMASK_NOALB_F32, "womask")):
        phases, run_counts = slice_run(dev, spec, kernels, no_albedo=True)
        for k in kernels:
            assert run_counts[k] == summary[ref]["launches"][k], (label, k)
        parity, f32_counts = slice_parity(dev, spec, f32_kernels, no_albedo=True)
        summary[label] = {"slice": phases, "parity": parity}
        for c in (run_counts, f32_counts):
            for k, n in c.items():
                noalb_launches[k] = noalb_launches.get(k, 0) + n
    summary["ablation"], counts["sdf_fwd_ablate"] = ablation_run()
    tmp = tempfile.mkdtemp(prefix="rnb_smoke_")
    try:
        summary["runner"], summary["runner_launches"], sets = runner_path(dev, card, tmp)
        summary["inference"], summary["inference_launches"] = inference_path(
            dev, card, tmp, sets)
        summary["parallel"], summary["parallel_launches"] = parallel_path(
            dev, card, tmp)
        summary["normalized_noalbedo"], noalb_cli = normalized_noalbedo_path(
            dev, card, tmp)
        summary["resume_launch"], p10 = resume_launch_path(card, tmp)
        for k in _build.launches:
            _build.launches[k] = 0
        summary["measuring_tools"], tune_rows = measuring_tools(
            card, tune_build, os.path.join(tmp, "p10"))
        p11 = dict(_build.launches)
        log(f"[phase 11] launches {p11}")
        for k in (*WMASK_KERNELS, *TUNE_KERNELS):
            assert p11[k] > 0, f"phase 11 did not launch {k}"
        assert all(p11[k] == 0 for k in F32_ROUTE), p11
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        tune_pool.shutdown()

    log("[summary] " + json.dumps(summary))
    rows = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": (counts[k] + summary["parallel_launches"].get(k, 0)
                      + noalb_launches.get(k, 0) + noalb_cli.get(k, 0)
                      + p10.get(k, 0) + p11[k]),
         "max_abs_err": kern[k]["max_abs_err"],
         "ms": kern[k]["ms"], "plain_ms": kern[k]["plain_ms"],
         "bound_ms": kern[k]["bound_ms"], "bound_by": kern[k]["bound_by"],
         "library_ms": kern[k]["library_ms"]}
        for k, (src, rep) in KERNELS.items()]
    # the tune instances (phase 11): the work of the production kernel they
    # stand for, so its plain time and bound; their time and error from the
    # sweep's own check and timing in this run
    rows += [
        {"name": k, "route": "cuda", "source": KERNELS[base][0], "replaces": rep,
         "launches": p11[k], "max_abs_err": tune_rows[k]["max_abs_err"],
         "ms": tune_rows[k]["ms"], "plain_ms": kern[base]["plain_ms"],
         "bound_ms": kern[base]["bound_ms"], "bound_by": kern[base]["bound_by"],
         "library_ms": None}
        for k, (base, rep) in TUNE_KERNELS.items()]
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--grid-worker"]:
        grid_worker(*sys.argv[2:5])
    else:
        main()
