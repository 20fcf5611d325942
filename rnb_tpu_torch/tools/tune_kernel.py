"""Tile sweep of the SDF core's tensor-core kernels on one CUDA card: the
ring depth of the forward sweep (cp.async) and the backward sweep (TMA),
and the row-split count of the grouped dW product (the port's counterpart
of ``tools/tune_kernel.py``, which swept the Pallas block sizes).

    python -m rnb_tpu_torch.tools.tune_kernel [--n 65536] [--iters 30]
        [--fwd_rs 3 4 5 6] [--bwd_rs 3 4 5 6] [--splits S ...]

Shipped SDF net (8x256; geometric init from seed 3, its ``v`` moved by
0.02·N(0, 1) so that every layer carries signal), ``--n`` points uniform in
[-0.8, 0.8]³ (numpy seed 4), cotangents from numpy seed 5. Axes:

  fwd       the forward (``sdf_core_fwd_tune``) at each depth of ``--fwd_rs``;
  fwd_bwd   forward plus backward (``sdf_core_bwd_tune``, then the
            production dW products) at each depth of ``--bwd_rs``, both at
            that depth (``ms``), and the backward alone (``bwd_ms``);
  splits    ``ops.wg.dw_products`` over the SDF core's 9 layers
            (``sdf_core.wg_layout``) on 2·``--n`` rows of bf16 operands
            (N(0, 1) from a card generator, seed 6) at each count of
            ``--splits`` (default ``split_axis``: today's choice
            ``dw_splits``, its half and double, and 1), beside one
            torch.matmul a layer of the same operands.

The depth instances come from the tune library (``_build.library("tune")``,
built only here: ``build/kernels/librnb_kernels_tune_<hash>.so``). The
depth changes when a weight tile is loaded, not the order of any sum, so
every depth is held bit for bit against the production library's kernels
(the forward's production depth is ``WG_RS`` = 4, the backward sweep's
``SW_RS`` = 16, ``production`` in the summary); a stale or
overwritten ring stage shows there even where it corrupts too few tiles to
move the error norm. Every instance is also held against the plain
version (bf16 operands, within 1e-2 of its norm) before it is timed; one
that fails to launch or to match is a failed row with its error, never a
time. A time is the median of three turns of CUDA events over ``--iters``
launches after 3 warm-up launches, with the turns' min and max. Prints one JSON line a row and a summary line: the fastest
setting of each axis beside today's, the card (nvidia-smi's name and power
limit). Exits 1 when a row failed; without a CUDA device it exits
non-zero. The production choice does not change here.
"""

from __future__ import annotations

import argparse
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from rnb_tpu_torch.models import fields
from rnb_tpu_torch.ops import _build, sdf_core, wg
from rnb_tpu_torch.tools.ablate_kernel import card, cuda_ms
from rnb_tpu_torch.tools.bench import device_or_exit

TOL = 1e-2          # bf16 operands, relative to the plain result's norm


def split_axis(prod: int) -> list:
    """The split counts the sweep times by default: today's, its half and
    double, and 1."""
    return [prod, max(prod // 2, 1), 2 * prod, 1]


def rel_err(got, want) -> tuple:
    """(max abs error, error norm / reference norm) over tensor lists."""
    mx, num, den = 0.0, 0.0, 0.0
    for a, b in zip(got, want):
        d = (a - b).float()
        mx = max(mx, d.abs().max().item())
        num += d.pow(2).sum().item()
        den += b.float().pow(2).sum().item()
    return mx, (num ** 0.5) / max(den ** 0.5, 1e-30)


def checked_row(row: dict, run, plain, iters: int, production=None,
                timed=None) -> dict:
    """Run an instance once, hold it against ``plain`` (and bit for bit
    against ``production``, where given), then time ``timed`` (default
    ``run``). A launch error or a failed check makes a failed row with no
    time."""
    try:
        got = run()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return dict(row, ok=False, error=str(e).splitlines()[0])
    mx, rel = rel_err(got, plain)
    row.update(max_abs_err=mx, rel_err=rel)
    errors = []
    if not rel <= TOL:
        errors.append(f"rel err {rel:.3e} > {TOL:g} against the plain version")
    if production is not None:
        row["bitwise_equal_production"] = all(
            torch.equal(a, b) for a, b in zip(got, production))
        if not row["bitwise_equal_production"]:
            errors.append("differs from the production kernel")
    if errors:
        return dict(row, ok=False, error="; ".join(errors))
    return dict(row, ok=True, **event_turns(timed or run, iters))


def event_turns(fn, iters: int, key: str = "ms") -> dict:
    """The median of three turns of CUDA events over ``iters`` launches
    (after 3 warm-up launches each), with their min and max."""
    t = sorted(cuda_ms(fn, iters, 3) for _ in range(3))
    return {key: t[1], f"{key}_min": t[0], f"{key}_max": t[2]}


def fastest(rows, axis: str, key: str):
    ok = [r for r in rows if r["axis"] == axis and r["ok"]]
    return min(ok, key=lambda r: r["ms"])[key] if ok else None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--fwd_rs", type=int, nargs="*", default=list(_build.TUNE_DEPTHS))
    ap.add_argument("--bwd_rs", type=int, nargs="*", default=list(_build.TUNE_DEPTHS))
    ap.add_argument("--splits", type=int, nargs="*", default=None)
    args = ap.parse_args(argv)
    dev = device_or_exit("tune_kernel", cpu_flag=False)
    with ThreadPoolExecutor(2) as pool:   # the two nvcc builds at once
        list(pool.map(_build.library, ("main", "tune")))

    cfg = fields.SDFConfig()
    gen = torch.Generator().manual_seed(3)
    params = fields.init_sdf_network(gen, cfg, dev)
    for layer in params:
        layer["v"] = layer["v"] + 0.02 * torch.randn(layer["v"].shape,
                                                     generator=gen).to(dev)
    ws = [fields.fold_weight_norm(l).detach() for l in params]
    bs = [l["b"].detach() for l in params]
    pts = torch.tensor(np.random.default_rng(4).uniform(-0.8, 0.8, (args.n, 3)),
                       dtype=torch.float32, device=dev)
    rng = np.random.default_rng(5)

    def draw(*shape, scale=1.0):
        return torch.tensor(scale * rng.standard_normal(shape),
                            dtype=torch.float32, device=dev)

    cs, cf, cg = draw(args.n), draw(args.n, cfg.d_out - 1, scale=0.1), draw(args.n, 3)
    bf16 = torch.bfloat16
    prod_rs = wg.RING_DEPTH

    fwd_plain = list(sdf_core.sdf_core_fwd_plain(cfg, pts, ws, bs, bf16))
    fwd_prod = list(sdf_core.sdf_core_fwd(cfg, pts, ws, bs, bf16))
    bwd_plain = sum(sdf_core.sdf_core_bwd_plain(cfg, pts, ws, bs, cs, cf, cg,
                                                bf16), [])
    bwd_prod = sum(sdf_core.sdf_core_bwd(cfg, pts, ws, bs, cs, cf, cg, bf16), [])
    torch.cuda.synchronize()

    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for rs in args.fwd_rs:
        emit(checked_row(
            {"axis": "fwd", "rs": rs, "n": args.n},
            lambda rs=rs: list(sdf_core.sdf_core_fwd_tune(cfg, pts, ws, bs, rs)),
            fwd_plain, args.iters, fwd_prod))
    for rs in args.bwd_rs:
        def bwd(rs=rs):
            return sum(sdf_core.sdf_core_bwd_tune(cfg, pts, ws, bs, cs, cf, cg,
                                                  rs), [])

        def fwd_bwd(rs=rs):
            sdf_core.sdf_core_fwd_tune(cfg, pts, ws, bs, rs)
            return bwd(rs)

        row = checked_row({"axis": "fwd_bwd", "rs": rs, "n": args.n}, bwd,
                          bwd_plain, args.iters, bwd_prod, timed=fwd_bwd)
        if row["ok"]:
            row.update(event_turns(bwd, args.iters, "bwd_ms"))
        emit(row)
    del fwd_plain, fwd_prod, bwd_plain, bwd_prod

    rows_k = 2 * args.n
    lay = sdf_core.wg_layout(cfg, ws, args.n)
    shapes = list(zip(lay["in_dims"], lay["out_dims"]))
    dgen = torch.Generator(device=dev).manual_seed(6)   # 1.1 GB: on the card
    abuf = torch.randn(lay["a_len"], generator=dgen, device=dev).to(bf16)
    bbuf = torch.randn(lay["b_len"], generator=dgen, device=dev).to(bf16)
    ops = [(abuf[ao:ao + rows_k * kp].view(rows_k, kp)[:, :i],
            bbuf[bo:bo + rows_k * np_].view(rows_k, np_)[:, :o])
           for ao, bo, kp, np_, (i, o) in zip(lay["a_off"], lay["bb_off"],
                                              lay["kp"], lay["np"], shapes)]
    prod_splits = wg.dw_splits(shapes, rows_k)[0]
    dw_plain = [x.float().T @ y.float() for x, y in ops]
    for s in args.splits or split_axis(prod_splits):
        eff, chunk = wg.dw_splits(shapes, rows_k, s)
        emit(checked_row(
            {"axis": "splits", "splits": s, "effective_splits": eff,
             "chunk": chunk, "rows": rows_k, "layers": len(shapes)},
            lambda s=s: wg.dw_products(abuf, bbuf, lay, rows_k, "sdf_dw_gemm",
                                       splits=s),
            dw_plain, args.iters))
    matmul_ms = event_turns(lambda: [torch.matmul(x.T, y) for x, y in ops],
                            args.iters)["ms"]

    summary = {
        "n": args.n, "iters": args.iters, "card": card(),
        "fastest": {"fwd_rs": fastest(rows, "fwd", "rs"),
                    "fwd_bwd_rs": fastest(rows, "fwd_bwd", "rs"),
                    "splits": fastest(rows, "splits", "splits")},
        "production": {"rs": prod_rs, "bwd_rs": wg.SWEEP_RING_DEPTH,
                       "splits": prod_splits},
        "ms": {f"{r['axis']}:{r.get('rs', r.get('splits'))}": r.get("ms")
               for r in rows},
        "dw_matmul_ms": matmul_ms,
        "failed": [r for r in rows if not r["ok"]],
    }
    print(json.dumps(summary), flush=True)
    return dict(summary, rows=rows)


if __name__ == "__main__":
    raise SystemExit(1 if main()["failed"] else 0)
