"""The dW products of the three bf16 backwards on one CUDA card, each
beside torch.matmul on the same operands.

    python -m rnb_tpu_torch.tools.bench_dw [--iters 30]

For each backward at the main path's rows (the SDF core's 9 layers over
2 x 65,536 rows, the albedo's 3 over 65,536, the NeRF's 11 image layers
over 67,584; the layouts of ``sdf_core.wg_layout``, ``albedo.wg_layout``
and ``nerf.wg_layout`` of the shipped nets), and for one 256x256 layer
over 131,072 rows, it fills the bf16 operand rows with N(0, 1) from a card
generator (seed 0), holds ``ops.wg.dw_products`` (``ops.wg.dw_gemm`` for
the one layer) against the f32 product of the same operands, and times
it and one torch.matmul a layer: CUDA events over ``--iters`` calls after
3 warm-up calls, the median of three turns with min and max. ``bound_ms``
is the least bytes (each operand column read once, each dW written once)
over 3.35 TB/s; ``launches`` the launch counts one call adds. It uses
only what every version of the port's dW product offers, so two trees are
compared by running it with each on PYTHONPATH in one call. Prints one
JSON line with the card (nvidia-smi's name and power limit); without a
CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import json

import torch

from rnb_tpu_torch.models import fields
from rnb_tpu_torch.ops import _build, albedo, nerf, sdf_core, wg
from rnb_tpu_torch.tools.ablate_kernel import card, cuda_ms

HBM = 3.35e12        # H100 SXM, bytes/s
MAIN_N, NERF_N = 512 * 128, 512 * (128 + 4)


def layouts() -> dict:
    """{group: (layout, rows, counter)} of the shipped nets at the main
    path's rows."""
    scfg, ncfg = fields.SDFConfig(), fields.NeRFConfig()
    gen = torch.Generator().manual_seed(0)
    sw = [fields.fold_weight_norm(l).detach()
          for l in fields.init_sdf_network(gen, scfg, "cpu")]
    aw = [fields.fold_weight_norm(l).detach() for l in
          fields.init_rendering_network(gen, fields.RenderingConfig(), "cpu")]
    nw, _ = nerf.flatten_params(fields.init_nerf(gen, ncfg, device="cpu"))
    return {"sdf": (sdf_core.wg_layout(scfg, sw, MAIN_N), 2 * MAIN_N,
                    "sdf_dw_gemm"),
            "albedo": (albedo.wg_layout(aw, MAIN_N), MAIN_N, "albedo_dw_gemm"),
            "nerf": (nerf.wg_layout(ncfg, nw, NERF_N), NERF_N, "nerf_dw_gemm")}


def turns(fn, iters: int) -> dict:
    t = sorted(cuda_ms(fn, iters, 3) for _ in range(3))
    return {"ms": t[1], "ms_min": t[0], "ms_max": t[2]}


def measure(run, ops, iters: int, counter: str) -> dict:
    """One dW function ``run`` over the (A, B) column views ``ops``."""
    before = _build.launches[counter]
    got = run()
    torch.cuda.synchronize()
    launches = _build.launches[counter] - before
    want = [x.float().T @ y.float() for x, y in ops]
    err = max(((g - w).norm() / w.norm()).item() for g, w in zip(got, want))
    again = run()
    nbytes = sum(x.numel() + y.numel() for x, y in ops) * 2 + sum(
        w.numel() for w in want) * 4
    return {"layers": len(ops), "rows": ops[0][0].shape[0],
            "launches": launches, "rel_err": err,
            "bitwise_repeat": all(torch.equal(a, b) for a, b in zip(got, again)),
            **turns(run, iters),
            "matmul_ms": turns(lambda: [torch.matmul(x.T, y) for x, y in ops],
                               iters)["ms"],
            "bound_ms": nbytes / HBM * 1e3}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_dw: no CUDA device; it times the card's kernels")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"card": card(), "iters": args.iters}
    for name, (lay, rows, counter) in layouts().items():
        a = torch.randn(lay["a_len"], generator=gen, device=dev).to(torch.bfloat16)
        b = torch.randn(lay["b_len"], generator=gen, device=dev).to(torch.bfloat16)
        ops = [(a[ao:ao + rows * kp].view(rows, kp)[:, :i],
                b[bo:bo + rows * np_].view(rows, np_)[:, :o])
               for ao, bo, kp, np_, i, o in zip(
                   lay["a_off"], lay["bb_off"], lay["kp"], lay["np"],
                   lay["in_dims"], lay["out_dims"])]
        out[name] = measure(lambda: wg.dw_products(a, b, lay, rows, counter),
                            ops, args.iters, counter)
        del a, b, ops
        torch.cuda.empty_cache()
    a = torch.randn(2 * MAIN_N, 256, generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn(2 * MAIN_N, 256, generator=gen, device=dev).to(torch.bfloat16)
    out["one_layer"] = measure(
        lambda: [wg.dw_gemm(a, b, 256, 256, counter="sdf_dw_gemm")], [(a, b)],
        args.iters, "sdf_dw_gemm")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
