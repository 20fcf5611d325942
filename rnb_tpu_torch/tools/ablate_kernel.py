"""Split the time of the SDF-core forward kernel by timing its ablation
variants (``rnb_tpu_torch.ops.sdf_ablate``: full, no_pe, no_act,
primal_only) and their plain PyTorch versions, on one CUDA card; with
``--fwd_split``, split the bf16 forward by what it does instead; with
``--bwd``, split the bf16 backward sweep; with ``--wg_bwd`` or
``--wg_fwd``, the albedo or NeRF backward sweep or bf16 forward.

    python -m rnb_tpu_torch.tools.ablate_kernel [--n 65536] [--iters 50]
    python -m rnb_tpu_torch.tools.ablate_kernel --fwd_split [--n 65536] [--iters 20]
    python -m rnb_tpu_torch.tools.ablate_kernel --bwd [--n 65536] [--iters 20]
    python -m rnb_tpu_torch.tools.ablate_kernel --wg_bwd nerf [--n 67584] [--iters 20]
    python -m rnb_tpu_torch.tools.ablate_kernel --wg_bwd albedo [--n 65536]
    python -m rnb_tpu_torch.tools.ablate_kernel --wg_fwd {albedo,nerf} [--n N] [--iters 20]

Shipped SDF net (8x256, geometric init from seed 3), N points uniform in
[-0.8, 0.8]^3 (numpy seed 0), bf16 operands; each variant timed with CUDA
events over ``--iters`` launches after 3 warm-up launches. Prints one JSON
line: the card (nvidia-smi name and power limit) and ms per mode for the
kernel and for the plain version.

``--fwd_split`` times the bf16 forward's split instances from the tune
library (``sdf_core.sdf_fwd_split``, ``sdf_core.FWD_SPLIT``: the
production kernel, then without the record's traffic, the softplus /
sigmoid arithmetic, everything but the weight ring and its barriers, and
both the record and the arithmetic) on the weight image packed once, on
``bench_sdf_fwd``'s net and points: the median of three turns of
``--iters`` launches, with min and max. The ``full`` instance is held bit
for bit against the production forward first.

``--bwd`` times the backward sweep's split instances from the tune library
(``sdf_core.sdf_bwd_split``, ``sdf_core.BWD_SPLIT``: the production sweep,
then without the record's traffic, the epilogue's arithmetic, the dW
operand rows, and all three), the sweep alone (no dW products) on the
weight image packed once, on ``bench_sdf_bwd``'s net, points and
cotangents: the median of three turns of ``--iters`` launches, with min
and max. The ``full`` instance is held bit for bit against the production
sweep first. Only ``full`` computes the function; the others are for
timing.

``--wg_bwd {albedo,nerf}`` times, from the tune library, the timing split
(``wg.WG_BWD_SPLIT``: the production sweep, then the ring and its
barriers alone, the products without epilogue arithmetic or operand rows,
without the row stores, and without the bias, ReLU and mask work) of the
production sweep (``split``), and the production sweep at each ring depth
the tune library builds (``depths``), all through ``wg.bwd_tune``: the
sweep alone (no dW products) on the weight image packed once, on
``bench_wg_bwd``'s net and inputs (``--n`` default 65,536 albedo, 67,584
NeRF): the median of three turns of ``--iters`` launches, with min and
max. The ``full`` instance and every depth are held bit for bit against
the production sweep first.

``--wg_fwd {albedo,nerf}`` does the same for the albedo or NeRF bf16
forward (``wg.fwd_tune`` on ``fwd_wg``, the tune library's
``rnb_{albedo,nerf}_fwd_wg_split`` and ``_tune``): its timing split
(``wg.WG_FWD_SPLIT``: the production kernel, then the ring and its
barriers alone, the products alone with neither the A tile nor an output
written, and the products with the accumulators rounded straight into the
A tile and the heads written raw) and its ring depths
(``_build.WG_FWD_TUNE_DEPTHS``), on the weight image packed once.

Without a CUDA device it exits non-zero and prints no timing.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from rnb_tpu_torch.models import fields
from rnb_tpu_torch.ops.sdf_ablate import (MODES, sdf_fwd_ablate,
                                          sdf_fwd_ablate_plain)


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, iters=10, warm=2) -> float:
    """Mean ms per call of ``fn`` on the current CUDA stream (CUDA events
    around ``iters`` calls after ``warm`` calls)."""
    for _ in range(warm):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bwd_split(n: int, iters: int) -> dict:
    """The backward sweep's split (``--bwd``), on bench_sdf_bwd's inputs."""
    from rnb_tpu_torch.ops import _build, sdf_core
    from rnb_tpu_torch.tools.bench_sdf_bwd import setup, turns

    _build.library("tune")
    cfg, ws, bs, pts, cots = setup(n, torch.device("cuda"))
    packed = sdf_core.wg_pack(cfg, ws, bs)
    prod = sdf_core.bwd_sweep(cfg, pts, ws, bs, *cots, packed)[:3]
    full = sdf_core.sdf_bwd_split("full", cfg, pts, ws, bs, *cots, packed)[:3]
    torch.cuda.synchronize()
    res = {"card": card(), "n": n, "iters": iters, "dtype": "bf16",
           "full_bitwise_production": all(torch.equal(a, b)
                                          for a, b in zip(full, prod)),
           "production_sweep": turns(
               lambda: sdf_core.bwd_sweep(cfg, pts, ws, bs, *cots, packed),
               iters),
           "split": {}}
    for split in sdf_core.BWD_SPLIT:
        res["split"][split] = turns(
            lambda s=split: sdf_core.sdf_bwd_split(s, cfg, pts, ws, bs, *cots,
                                                   packed), iters)
    return res


def fwd_split(n: int, iters: int) -> dict:
    """The bf16 forward's split (``--fwd_split``), on bench_sdf_fwd's
    inputs."""
    from rnb_tpu_torch.ops import _build, sdf_core
    from rnb_tpu_torch.tools.bench_sdf_bwd import setup, turns

    _build.library("tune")
    cfg, ws, bs, pts, _ = setup(n, torch.device("cuda"))
    packed = sdf_core.wg_pack(cfg, ws, bs)
    prod = sdf_core.launch_fwd_wg(cfg, pts, ws, bs, packed=packed)
    full = sdf_core.sdf_fwd_split("full", cfg, pts, ws, bs, packed)
    torch.cuda.synchronize()
    res = {"card": card(), "n": n, "iters": iters, "dtype": "bf16",
           "full_bitwise_production": all(torch.equal(a, b)
                                          for a, b in zip(full, prod)),
           "production": turns(
               lambda: sdf_core.launch_fwd_wg(cfg, pts, ws, bs,
                                              packed=packed), iters),
           "split": {}}
    for split in sdf_core.FWD_SPLIT:
        res["split"][split] = turns(
            lambda s=split: sdf_core.sdf_fwd_split(s, cfg, pts, ws, bs,
                                                   packed), iters)
    return res


def wg_split(op: str, pas: str, n: int | None, iters: int) -> dict:
    """The albedo or NeRF backward sweep's split (``--wg_bwd``, ``pas``
    "bwd") or bf16 forward's (``--wg_fwd``, "fwd"), on bench_wg_bwd's
    inputs."""
    from rnb_tpu_torch.ops import _build, albedo, nerf, wg
    from rnb_tpu_torch.tools.bench_sdf_bwd import turns
    from rnb_tpu_torch.tools.bench_wg_bwd import N_DEFAULT, setup

    _build.library("tune")
    n = n or N_DEFAULT[op]
    mod = albedo if op == "albedo" else nerf
    cfg, ws, bs, ins, cots = setup(op, n, torch.device("cuda"))
    packed = (albedo.wg_pack(ws, bs) if op == "albedo"
              else nerf.wg_pack(cfg, ws, bs))
    if pas == "bwd":
        fn, tune, args = mod.bwd_sweep, wg.bwd_tune, (cfg, *ins, ws, bs, *cots,
                                                     packed)
        splits, depths = wg.WG_BWD_SPLIT, _build.BWD_TUNE_DEPTHS[op]
    else:
        fn, tune, args = mod.fwd_wg, wg.fwd_tune, (cfg, *ins, ws, bs, packed)
        splits, depths = wg.WG_FWD_SPLIT, _build.WG_FWD_TUNE_DEPTHS[op]
    split = lambda s: tune(fn, *args, split=s)
    depth = lambda rs: tune(fn, *args, depth=rs)

    def parts(out):   # the outputs (a backward's operand rows, db, ...)
        out = out if isinstance(out, (tuple, list)) else (out,)
        return [t for t in out if isinstance(t, torch.Tensor)]

    prod = parts(fn(*args))
    same = lambda out: all(torch.equal(a, b) for a, b in zip(parts(out), prod))
    res = {"card": card(), "op": op, "pass": pas, "n": n, "iters": iters,
           "dtype": "bf16",
           "split_full_bitwise_production": same(split("full")),
           "depth_bitwise_production": {rs: same(depth(rs)) for rs in depths},
           ("production_sweep" if pas == "bwd" else "production"):
               turns(lambda: fn(*args), iters),
           "split": {}, "depths": {}}
    torch.cuda.synchronize()
    for s in splits:
        res["split"][s] = turns(lambda s=s: split(s), iters)
    for rs in depths:
        res["depths"][rs] = turns(lambda rs=rs: depth(rs), iters)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=None,
                    help="points (default 65,536; 67,584 with --wg_bwd or "
                         "--wg_fwd nerf)")
    ap.add_argument("--iters", type=int, default=None,
                    help="launches a timing (default 50; 20 with --bwd, "
                         "--fwd_split, --wg_bwd or --wg_fwd)")
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--fwd_split", action="store_true",
                       help="split the bf16 forward by what it does")
    which.add_argument("--bwd", action="store_true",
                       help="split the bf16 backward sweep instead")
    which.add_argument("--wg_bwd", choices=("albedo", "nerf"),
                       help="split the albedo or NeRF backward sweep")
    which.add_argument("--wg_fwd", choices=("albedo", "nerf"),
                       help="split the albedo or NeRF bf16 forward")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_kernel: no CUDA device; the kernels run only "
                         "on a GPU")
    if args.wg_bwd or args.wg_fwd:
        pas = "bwd" if args.wg_bwd else "fwd"
        res = wg_split(args.wg_bwd or args.wg_fwd, pas, args.n,
                       args.iters or 20)
        print(json.dumps(res), flush=True)
        return res
    args.n = args.n or 65536
    if args.bwd or args.fwd_split:
        res = (bwd_split if args.bwd else fwd_split)(args.n, args.iters or 20)
        print(json.dumps(res), flush=True)
        return res
    args.iters = args.iters or 50
    dev = torch.device("cuda")
    cfg = fields.SDFConfig()
    params = fields.init_sdf_network(torch.Generator().manual_seed(3), cfg, dev)
    ws = [fields.fold_weight_norm(l).detach() for l in params]
    bs = [l["b"].detach() for l in params]
    pts = torch.tensor(np.random.default_rng(0).uniform(-0.8, 0.8, (args.n, 3)),
                       dtype=torch.float32, device=dev)
    dtype = torch.bfloat16
    res = {"card": card(), "n": args.n, "iters": args.iters, "dtype": "bf16",
           "kernel_ms": {}, "plain_ms": {}}
    for mode in MODES:
        res["kernel_ms"][mode] = cuda_ms(
            lambda: sdf_fwd_ablate(mode, cfg, pts, ws, bs, dtype), args.iters, 3)
        res["plain_ms"][mode] = cuda_ms(
            lambda: sdf_fwd_ablate_plain(mode, cfg, pts, ws, bs, dtype),
            args.iters, 3)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
