"""The SDF core's bf16 forward on one CUDA card (``sdf_core.sdf_core_fwd``:
sdf, feature and ∇SDF in one kernel), the forward's counterpart of
``bench_sdf_bwd``.

    python -m rnb_tpu_torch.tools.bench_sdf_fwd [--n 65536] [--iters 20]
    python -m rnb_tpu_torch.tools.bench_sdf_fwd --device cpu --n 100

``bench_sdf_bwd``'s net and points (``setup``). It holds the forward
against its plain version (``rel_err``, relative to the plain result's
norm, over sdf, feat and grad together) and against a second call
(``bitwise_repeat``), prints the sha256 of sdf, feat and grad's bytes
(``digest``: two trees whose forwards give the same bits print the same),
then times it with CUDA events over ``--iters`` calls after 3 warm-up
calls, the median of three turns with min and max, on the weight image
packed once where the tree's ``sdf_core_fwd`` takes one (``packed``),
else packing it each call (``packed_once`` says which); ``launches`` are
the counts one call adds. It calls nothing but ``sdf_core_fwd``, which
every tree of the port offers, so two trees are compared by running it
with each on PYTHONPATH in one call, in turns. Prints one JSON line with
the card (nvidia-smi's name and power limit). Without a CUDA device it
exits non-zero; ``--device cpu`` runs the plain path's control flow and
times nothing.
"""

from __future__ import annotations

import argparse
import inspect
import json

import torch

from rnb_tpu_torch.ops import _build, sdf_core
from rnb_tpu_torch.tools.ablate_kernel import card
from rnb_tpu_torch.tools.bench_sdf_bwd import digest, rel_err, setup, turns


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_sdf_fwd: no CUDA device; it times the card "
                         "(--device cpu runs its control flow only)")
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg, ws, bs, pts, _ = setup(args.n, dev)
    bf16 = torch.bfloat16
    extra = {}
    if on_card and "packed" in inspect.signature(sdf_core.sdf_core_fwd).parameters:
        extra["packed"] = sdf_core.wg_pack(cfg, ws, bs)

    def fwd():
        return list(sdf_core.sdf_core_fwd(cfg, pts, ws, bs, bf16, **extra))

    before = dict(_build.launches)
    got = fwd()
    if on_card:
        torch.cuda.synchronize()
    launches = {k: v - before.get(k, 0) for k, v in _build.launches.items()
                if v != before.get(k, 0)}
    want = list(sdf_core.sdf_core_fwd_plain(cfg, pts, ws, bs, bf16))
    out = {"card": card() if on_card else None, "device": dev.type,
           "n": args.n, "iters": args.iters, "dtype": "bf16",
           "launches": launches, "rel_err": rel_err(got, want),
           "bitwise_repeat": all(torch.equal(a, b)
                                 for a, b in zip(got, fwd())),
           "digest": digest(got), "packed_once": bool(extra), "fwd": None}
    if on_card:
        out["fwd"] = turns(fwd, args.iters)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
