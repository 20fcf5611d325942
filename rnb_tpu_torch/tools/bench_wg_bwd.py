"""The albedo net's or the background NeRF's backward on one CUDA card: the
whole backward (``albedo.albedo_bwd`` / ``nerf.nerf_bwd``: the sweep, its
db sum and the grouped dW products) and, where the tree exposes it
(``bwd_sweep``), the sweep alone; with ``--pass fwd``, the forward
(``albedo.albedo_fwd`` / ``nerf.nerf_fwd``) instead.

    python -m rnb_tpu_torch.tools.bench_wg_bwd --op nerf [--n 67584] [--iters 20]
    python -m rnb_tpu_torch.tools.bench_wg_bwd --op albedo --pass fwd [--n 65536]
    python -m rnb_tpu_torch.tools.bench_wg_bwd --op albedo [--n 65536]
    python -m rnb_tpu_torch.tools.bench_wg_bwd --op nerf --n 1037 --dtype f32 --repeat 200
    python -m rnb_tpu_torch.tools.bench_wg_bwd --op albedo --device cpu --n 100

The shipped nets (``fields.init_rendering_network`` / ``fields.init_nerf``
from torch seed 1 / 2) and numpy-seeded inputs: albedo points uniform in
[-0.8, 0.8]³, unit normals, features 0.3·N(0, 1), c_out N(0, 1) (seed 6);
NeRF points as ``render_core_outside`` feeds them ([x/r, 1/r], |x| = 1, 1/r
in (0.1, 1]), unit view directions, c_alpha and c_rgb N(0, 1) (seed 7),
the points kept where every ReLU pre-activation lies at least 2e-5 from 0
at both op dtypes (``nerf.relu_margin``: nearer, the summation noise of
two versions can flip a mask). At ``--dtype`` (bf16, the main path's, or
f32) it holds the backward against its plain version (``rel_err``, the
error's norm over the plain result's, all tensors together) and a second
call (``bitwise_repeat``), and the sweep alone (its dW from its operand
rows by the plain product, and its db) against the plain version
(``sweep_rel_err``); prints the sha256 of the result's bytes (``digest``:
two trees whose backwards give the same bits print the same), then times
the backward and the sweep with CUDA events over ``--iters`` calls after 3
warm-up calls, the median of three turns with min and max; ``launches``
are the counts one call adds. ``--repeat N`` calls the backward N more
times, each held bit for bit against the first and within the tolerance
of a plain version computed anew (1e-4 at f32, 1e-2 at bf16), and checks
that nothing turned TF32 on between calls: ``repeat`` counts the calls,
the calls that differed, those past the tolerance, and the largest error.
``host_us`` is the host's µs a call: the host clock around 100 calls
with no synchronisation, the median of five turns with min and max.
``--pass fwd`` does the same for the forward on the weight image packed
once (as the op packs it once a step): ``rel_err``, ``bitwise_repeat``,
``digest`` (of alpha and rgb, or of the albedo), ``fwd`` (CUDA events) and
``host_us``.
It uses only what every tree of the port offers (the sweep alone only
where present, else null; the forward only through ``albedo_fwd`` /
``nerf_fwd``), so two trees are compared by running it with each on
PYTHONPATH in one call, in turns. Prints one JSON line with the card
(nvidia-smi's name and power limit). Without a CUDA device it exits
non-zero; ``--device cpu`` runs the plain path's control flow and times
nothing.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from rnb_tpu_torch.models import fields
from rnb_tpu_torch.ops import _build, albedo, nerf, wg
from rnb_tpu_torch.tools.ablate_kernel import card
from rnb_tpu_torch.tools.bench_sdf_bwd import digest, rel_err, turns

N_DEFAULT = {"albedo": 65536, "nerf": 67584}
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def setup(op: str, n: int, dev):
    """(cfg, ws, bs, inputs, cotangents) of the shipped net of ``op`` at
    ``n`` points on ``dev``."""
    if op == "albedo":
        cfg = fields.RenderingConfig()
        params = fields.init_rendering_network(torch.Generator().manual_seed(1),
                                               cfg, dev)
        ws = [fields.fold_weight_norm(l).detach() for l in params]
        bs = [l["b"].detach() for l in params]
        rng = np.random.default_rng(6)
        nrm = rng.standard_normal((n, 3))
        arrays = (rng.uniform(-0.8, 0.8, (n, 3)),
                  nrm / np.linalg.norm(nrm, axis=1, keepdims=True),
                  0.3 * rng.standard_normal((n, cfg.d_feature)))
        cots = (rng.standard_normal((n, cfg.d_out)),)
    else:
        cfg = fields.NeRFConfig()
        ws, bs = nerf.flatten_params(
            fields.init_nerf(torch.Generator().manual_seed(2), cfg, device=dev))
        ws, bs = [w.detach() for w in ws], [b.detach() for b in bs]
        rng = np.random.default_rng(7)
        m = 3 * n
        x = rng.standard_normal((m, 3))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        v = rng.standard_normal((m, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        pts4 = torch.tensor(np.concatenate([x, rng.uniform(0.1, 1.0, (m, 1))],
                                           axis=1), dtype=torch.float32,
                            device=dev)
        views = torch.tensor(v, dtype=torch.float32, device=dev)
        margin = torch.minimum(*(nerf.relu_margin(cfg, pts4, views, ws, bs, dt)
                                 for dt in (torch.float32, torch.bfloat16)))
        keep = torch.nonzero(margin >= 2e-5)[:, 0]
        if keep.numel() < n:
            raise RuntimeError(f"only {keep.numel()} of {m} points lie off "
                               "the ReLU boundary")
        arrays = (pts4[keep[:n]].cpu().numpy(), views[keep[:n]].cpu().numpy())
        cots = (rng.standard_normal((n, 1)), rng.standard_normal((n, 3)))
    ins = [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrays]
    cots = [torch.tensor(c, dtype=torch.float32, device=dev) for c in cots]
    return cfg, ws, bs, ins, cots


def calls(op: str, cfg, ws, bs, ins, cots, dtype):
    """(backward, plain, sweep or None) of ``op``: each -> a flat list of
    tensors; the sweep alone's dW from its operand rows by the plain
    product."""
    if op == "albedo":
        def flat(r):
            dws, dbs, cn, cf = r
            return list(dws) + list(dbs) + [cn, cf]
        bwd = lambda: flat(albedo.albedo_bwd(cfg, *ins, ws, bs, *cots, dtype))
        plain = lambda: flat(albedo.albedo_bwd_plain(cfg, *ins, ws, bs, *cots,
                                                     dtype))
        mod = albedo
    else:
        bwd = lambda: sum(nerf.nerf_bwd(cfg, *ins, ws, bs, *cots, dtype), [])
        plain = lambda: sum(nerf.nerf_bwd_plain(cfg, *ins, ws, bs, *cots,
                                                dtype), [])
        mod = nerf
    if not hasattr(mod, "bwd_sweep") or dtype != torch.bfloat16:
        return bwd, plain, None
    packed = (albedo.wg_pack(ws, bs) if op == "albedo"
              else nerf.wg_pack(cfg, ws, bs))
    sweep = lambda: mod.bwd_sweep(cfg, *ins, ws, bs, *cots, packed)
    return bwd, plain, sweep


def fwd_calls(op: str, cfg, ws, bs, ins, dtype):
    """(forward, plain) of ``op``: each -> a flat list of tensors; the
    forward on the weight image packed once, as the op packs it once a
    step (bf16 on a card; the f32 route and the CPU take none)."""
    packed = None
    if dtype == torch.bfloat16 and ins[0].is_cuda:
        packed = (albedo.wg_pack(ws, bs) if op == "albedo"
                  else nerf.wg_pack(cfg, ws, bs))
    if op == "albedo":
        return (lambda: [albedo.albedo_fwd(cfg, *ins, ws, bs, dtype, packed)],
                lambda: [albedo.albedo_fwd_plain(cfg, *ins, ws, bs, dtype)])
    return (lambda: list(nerf.nerf_fwd(cfg, *ins, ws, bs, dtype, packed)),
            lambda: list(nerf.nerf_fwd_plain(cfg, *ins, ws, bs, dtype)))


def host_us(fn, calls: int = 100, turns: int = 5) -> dict:
    """The host's µs a call of ``fn``: the host clock around ``calls``
    calls with no synchronisation (the card drained before), the median of
    ``turns`` turns with min and max."""
    t = []
    for _ in range(turns):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    t.sort()
    return {"us": t[turns // 2], "us_min": t[0], "us_max": t[-1]}


def sweep_parts(op: str, cfg, out, n: int):
    """The sweep's result as the backward's tensors: dW of every layer by
    the plain product of its rows, then db (and for the albedo the
    per-point cotangents), in the plain version's order."""
    abuf, bbuf, db = out[:3]
    lay = out[-1]
    dws = [wg.dw_gemm_plain(abuf[ao:ao + n * kp].view(n, kp),
                            bbuf[bo:bo + n * np_].view(n, np_), i, o)
           for i, o, kp, np_, ao, bo in zip(
               lay["in_dims"], lay["out_dims"], lay["kp"], lay["np"],
               lay["a_off"], lay["bb_off"])]
    dbs = _build.unflat(db, [(o,) for o in lay["out_dims"]])
    if op == "albedo":
        return list(dws) + list(dbs) + [out[3], out[4]]
    w, b = nerf.from_image(cfg, dws, dbs, lay["E"], lay["of"])
    return list(w) + list(b)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--op", required=True, choices=("albedo", "nerf"))
    ap.add_argument("--pass", dest="pas", default="bwd", choices=("bwd", "fwd"),
                    help="time the backward (default) or the forward")
    ap.add_argument("--n", type=int, default=None,
                    help="points (default 65,536 albedo, 67,584 NeRF)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f32"))
    ap.add_argument("--repeat", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_wg_bwd: no CUDA device; it times the card "
                         "(--device cpu runs its control flow only)")
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    n = args.n or N_DEFAULT[args.op]
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    cfg, ws, bs, ins, cots = setup(args.op, n, dev)
    if args.pas == "bwd":
        call, plain, sweep = calls(args.op, cfg, ws, bs, ins, cots, dtype)
    else:
        (call, plain), sweep = fwd_calls(args.op, cfg, ws, bs, ins, dtype), None

    before = dict(_build.launches)
    got = call()
    if on_card:
        torch.cuda.synchronize()
    launches = {k: v - before.get(k, 0) for k, v in _build.launches.items()
                if v != before.get(k, 0)}
    want = plain()
    out = {"card": card() if on_card else None, "device": dev.type,
           "op": args.op, "pass": args.pas, "n": n, "iters": args.iters,
           "dtype": args.dtype,
           "launches": launches, "rel_err": rel_err(got, want),
           "bitwise_repeat": all(torch.equal(a, b)
                                 for a, b in zip(got, call())),
           "digest": digest(got), "sweep_rel_err": None,
           args.pas: None, "sweep": None, "host_us": None, "repeat": None}
    if sweep is not None and on_card:
        out["sweep_rel_err"] = rel_err(
            sweep_parts(args.op, cfg, sweep(), n), want)
    if args.repeat:
        differ, past, worst, tf32 = 0, 0, 0.0, []
        for _ in range(args.repeat):
            again = call()
            differ += not all(torch.equal(a, b) for a, b in zip(got, again))
            err = rel_err(again, plain())
            past += err > TOL[dtype]
            worst = max(worst, err)
            tf32.append(torch.backends.cuda.matmul.allow_tf32
                        or torch.get_float32_matmul_precision() != "highest")
        out["repeat"] = {"calls": args.repeat, "differ": differ,
                         "past_tol": past, "max_rel_err": worst,
                         "tol": TOL[dtype], "tf32_seen": any(tf32)}
    if on_card:
        out[args.pas] = turns(call, args.iters)
        out["host_us"] = host_us(call)
        if sweep is not None:
            out["sweep"] = turns(sweep, args.iters)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
