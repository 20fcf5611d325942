"""The SDF core's bf16 backward on one CUDA card: the whole backward
(``sdf_core.sdf_core_bwd``: the sweep, its db sum and the grouped dW
products) and, where the tree exposes it (``sdf_core.bwd_sweep``), the
sweep alone.

    python -m rnb_tpu_torch.tools.bench_sdf_bwd [--n 65536] [--iters 20]
    python -m rnb_tpu_torch.tools.bench_sdf_bwd --device cpu --n 100

The shipped SDF net (8x256; geometric init from seed 3, its ``v`` moved by
0.02·N(0, 1) so that every layer carries signal), ``--n`` points uniform
in [-0.8, 0.8]³ (numpy seed 4), cotangents from numpy seed 5 (c_sdf N(0,
1), c_feat 0.1·N(0, 1), c_grad N(0, 1)). It holds the backward against
its plain version (``rel_err``, relative to the plain result's norm) and
against a second call (``bitwise_repeat``), prints the sha256 of its
result's bytes (``digest``: two trees whose backwards give the same bits
print the same), then times it with CUDA
events over ``--iters`` calls after 3 warm-up calls, the median of three
turns with min and max; ``launches`` are the counts one call adds. It
uses only what every tree of the port offers (the sweep alone only where
present, else null), so two trees are compared by running it with each
on PYTHONPATH in one call, in turns. Prints one JSON line with the card
(nvidia-smi's name and power limit). Without a CUDA device it exits
non-zero; ``--device cpu`` runs the plain path's control flow and times
nothing.
"""

from __future__ import annotations

import argparse
import hashlib
import json

import numpy as np
import torch

from rnb_tpu_torch.models import fields
from rnb_tpu_torch.ops import _build, sdf_core
from rnb_tpu_torch.tools.ablate_kernel import card, cuda_ms


def setup(n: int, dev):
    """(cfg, ws, bs, pts, cotangents) of the shipped net at ``n`` points."""
    cfg = fields.SDFConfig()
    gen = torch.Generator().manual_seed(3)
    params = fields.init_sdf_network(gen, cfg, dev)
    for layer in params:
        layer["v"] = layer["v"] + 0.02 * torch.randn(layer["v"].shape,
                                                     generator=gen).to(dev)
    ws = [fields.fold_weight_norm(l).detach() for l in params]
    bs = [l["b"].detach() for l in params]
    pts = torch.tensor(np.random.default_rng(4).uniform(-0.8, 0.8, (n, 3)),
                       dtype=torch.float32, device=dev)
    rng = np.random.default_rng(5)
    cots = [torch.tensor(s * rng.standard_normal(shape), dtype=torch.float32,
                         device=dev)
            for shape, s in (((n,), 1.0), ((n, cfg.d_out - 1), 0.1),
                             ((n, 3), 1.0))]
    return cfg, ws, bs, pts, cots


def turns(fn, iters: int) -> dict:
    t = sorted(cuda_ms(fn, iters, 3) for _ in range(3))
    return {"ms": t[1], "ms_min": t[0], "ms_max": t[2]}


def rel_err(got, want) -> float:
    num = sum((a - b).float().pow(2).sum().item() for a, b in zip(got, want))
    den = sum(b.float().pow(2).sum().item() for b in want)
    return (num ** 0.5) / max(den ** 0.5, 1e-30)


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_sdf_bwd: no CUDA device; it times the card "
                         "(--device cpu runs its control flow only)")
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg, ws, bs, pts, cots = setup(args.n, dev)
    bf16 = torch.bfloat16

    def bwd():
        dws, dbs = sdf_core.sdf_core_bwd(cfg, pts, ws, bs, *cots, bf16)
        return list(dws) + list(dbs)

    before = dict(_build.launches)
    got = bwd()
    if on_card:
        torch.cuda.synchronize()
    launches = {k: v - before.get(k, 0) for k, v in _build.launches.items()
                if v != before.get(k, 0)}
    want = [t for part in sdf_core.sdf_core_bwd_plain(cfg, pts, ws, bs, *cots,
                                                      bf16) for t in part]
    out = {"card": card() if on_card else None, "device": dev.type,
           "n": args.n, "iters": args.iters, "dtype": "bf16",
           "launches": launches, "rel_err": rel_err(got, want),
           "bitwise_repeat": all(torch.equal(a, b)
                                 for a, b in zip(got, bwd())),
           "digest": digest(got),
           "bwd": None, "sweep": None}
    if on_card:
        out["bwd"] = turns(bwd, args.iters)
        if hasattr(sdf_core, "bwd_sweep"):
            out["sweep"] = turns(
                lambda: sdf_core.bwd_sweep(cfg, pts, ws, bs, *cots), args.iters)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
