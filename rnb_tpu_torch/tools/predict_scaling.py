"""A weak-scaling model of the port's data-parallel step over NCCL on
NVLink (the port's counterpart of ``tools/predict_scaling.py``, whose model
was of a TPU's ICI):

    python -m rnb_tpu_torch.tools.predict_scaling --step_ms T
        [--bw 4.5e11] [--latency_us 20] [--out PATH]

A MODEL, not a measurement: the port has been timed on one card only.
Weak scaling: every card keeps the one-card step's work (a global
``train.batch_size`` of 512·N at N cards), so the step grows only by what
the ranks exchange (``parallel/train.py``), two all-reduces a step:

  * the ten partial sums of the loss, 40 bytes, between the forward and
    the backward, after a wait for the device before it (``SYNC_MS``);
  * the gradient, one flat f32 buffer of every parameter (a leaf the loss
    does not reach, such as the background NeRF of a wmask conf, sends
    zeros), counted exactly from the port's parameter tree at the shipped
    ``confs/wmask_rnb.conf``.

Each all-reduce is a ring, ``2(N-1)/N · bytes / bw + latency``, and

    t_comm(N) = [ring(40) + SYNC_MS + ring(grad bytes)] for N > 1, else 0,
    eff(N)    = t_step / (t_step + t_comm(N)).

``--step_ms`` is the one-card step time and is required: pass the
``wall_ms_per_step`` of ``python -m rnb_tpu_torch.tools.profile_step`` on
the same card. The defaults of ``--bw`` (450 GB/s, the H100 SXM's NVLink 4
rate in one direction, NVIDIA's data sheet: 900 GB/s both ways) and
``--latency_us`` (20 µs, a round figure of the order NCCL's own tests
report for a small all-reduce within one NVLink host) are assumptions, not
numbers of this repository. Prints one JSON line, the model at N = 1, 2,
4 and 8 cards, and writes it to ``--out`` too when given.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from rnb_tpu_torch import config as cfglib
from rnb_tpu_torch.models import fields
from rnb_tpu_torch.tools.run_parity_matrix import ROOT
from rnb_tpu_torch.utils.bridge import tree_leaves

CONF = os.path.join(ROOT, "confs", "wmask_rnb.conf")
PARTIAL_SUMS_BYTES = 10 * 4
# The wait for the device before the partial sums' all-reduce, beyond the
# collective itself: 0 on NCCL, which queues the collective on the stream
# behind the forward, so the host does not wait for the device there.
SYNC_MS = 0.0
N_CARDS = (1, 2, 4, 8)


def param_bytes(statics: fields.ModelStatics) -> dict:
    """f32 bytes of the parameter tree by net, and their ``total``: the
    gradient all-reduce's payload."""
    params = fields.init_model_bundle(torch.Generator().manual_seed(0),
                                      statics, device="cpu")
    out = {name: sum(p.numel() * 4 for p in tree_leaves(sub))
           for name, sub in params.items()}
    out["total"] = sum(out.values())
    return out


def ring_ms(nbytes: float, n: int, bw: float, latency_us: float) -> float:
    """One ring all-reduce of ``nbytes`` over ``n`` ranks, in ms."""
    return (2.0 * (n - 1) / n * nbytes / bw + latency_us * 1e-6) * 1e3


def model(step_ms: float, grad_bytes: int, n: int, bw: float,
          latency_us: float) -> dict:
    """The predicted communication time a step and efficiency at ``n``."""
    comm = 0.0 if n == 1 else (ring_ms(PARTIAL_SUMS_BYTES, n, bw, latency_us)
                               + SYNC_MS + ring_ms(grad_bytes, n, bw, latency_us))
    return {"n_cards": n, "t_comm_ms": comm,
            "efficiency": step_ms / (step_ms + comm)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--step_ms", type=float, required=True,
                    help="the one-card step time (ms), measured on the card")
    ap.add_argument("--bw", type=float, default=4.5e11,
                    help="all-reduce bus bandwidth a card, B/s")
    ap.add_argument("--latency_us", type=float, default=20.0,
                    help="fixed time of one all-reduce, µs")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    pb = param_bytes(fields.statics_from_conf(cfglib.load_conf(CONF)["model"]))
    rows = [model(args.step_ms, pb["total"], n, args.bw, args.latency_us)
            for n in N_CARDS]
    out = {"note": ("a model, not a measurement: one card measures no "
                    "scaling; weak scaling, two ring all-reduces a step"),
           "conf": os.path.relpath(CONF, ROOT), "param_bytes": pb,
           "grad_allreduce_bytes": pb["total"],
           "partial_sums_bytes": PARTIAL_SUMS_BYTES,
           "step_ms": args.step_ms, "bw_B_per_s": args.bw,
           "latency_us": args.latency_us, "sync_ms": SYNC_MS,
           "predicted": rows}
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
