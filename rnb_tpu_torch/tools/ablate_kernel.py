"""Split the time of the SDF-core forward kernel by timing its ablation
variants (``rnb_tpu_torch.ops.sdf_ablate``: full, no_pe, no_act,
primal_only) and their plain PyTorch versions, on one CUDA card.

    python -m rnb_tpu_torch.tools.ablate_kernel [--n 65536] [--iters 50]

Shipped SDF net (8x256, geometric init from seed 3), N points uniform in
[-0.8, 0.8]^3 (numpy seed 0), bf16 operands; each variant timed with CUDA
events over ``--iters`` launches after 3 warm-up launches. Prints one JSON
line: the card (nvidia-smi name and power limit) and ms per mode for the
kernel and for the plain version. Without a CUDA device it exits non-zero
and prints no timing.
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_kernel: no CUDA device; the kernels run only "
                         "on a GPU")
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
