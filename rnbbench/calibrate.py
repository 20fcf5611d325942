"""The readings the limits of a cell's check are set from, in one process.

    python3 -m rnbbench.calibrate --workload <name> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--seconds 0.1] [--set key=<json value> ...]

For each of ``--seeds`` a whole run of the cell (set-up, a window of
``--seconds``, the check) gives the program's numbers: the lower readings.
For each of ``--control-seeds`` the reference stands in the program's place
and is compared with itself in float32:

  * ``control``: the reference in the next precision below what the
    configuration states (``fp8`` operands where the program runs bf16
    operands; ``tf32`` for the mesh's float32 grid query, cast to float16
    as the program fetches it);
  * training, ``half_batch``: the first half of each step's rays alone,
    the mean taken over them;
  * novel views, ``half_chunks``: every other chunk of a frame left black.

A state left unchanged reads 1 on ``grad_diff_gap`` and ``change_gap`` by
their definition and needs no run. Prints one JSON line a reading and, last,
the largest program reading and the smallest of each stand-in by number.
``--set`` runs the program with a conf override after the traffic's (a
baseline such as ``train.core_impl="vjp"``; not a cell).
Needs a CUDA card (the tests call ``calibrate`` and ``_control_readings``
on the CPU at a tiny size).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from rnbbench import compare, harness, scene as scenelib
from rnbbench import run as runmod


def _control_readings(cell, seed: int, device) -> dict:
    """{stand-in: {number: value}} for one seed, no program involved."""
    mode = cell.traffic["mode"]
    drv = harness.driver(mode)
    conf = cell.conf
    sc = scenelib.make_scene(seed, cell.config["data"], device)
    t = cell.traffic
    out = {}
    if mode == "train":
        ref = drv.reference(conf, sc, seed, device, t, "f32")
        low = drv.reference(conf, sc, seed, device, t, "fp8")
        half = _half_batch(drv, conf, sc, seed, device, t)
        out["control"] = compare.training_gaps(low, ref)
        out["half_batch"] = compare.training_gaps(half, ref)
        out["worst_leaf"] = {"control": compare.worst_leaf(low, ref),
                             "half_batch": compare.worst_leaf(half, ref)}
    elif mode == "render":
        picks = drv._ratios(t["n_frames"])[:t["check_frames"]]
        ref = drv.reference_frames(conf, sc, seed, device, t, picks, "f32")
        low = drv.reference_frames(conf, sc, seed, device, t, picks, "fp8")
        out["control"] = {"frame_gap": max(
            compare.frame_gap(_as_u8(c), r) for c, r in zip(low, ref))}
        bsz = conf["train"]["batch_size"]
        out["half_chunks"] = {"frame_gap": max(
            compare.frame_gap(_as_u8(_drop_chunks(r, bsz)), r) for r in ref)}
    elif mode == "mesh":
        r = t["resolution"]
        rng = np.random.default_rng([seed, 23])
        flat = rng.choice(r ** 3, size=min(t["check_points"], r ** 3), replace=False)
        ref, _ = drv.reference(conf, sc, seed, device, t, flat, np.zeros((0, 3)), "f32")
        low, _ = drv.reference(conf, sc, seed, device, t, flat, np.zeros((0, 3)), "tf32")
        low = low.float().half().double()
        band = ref.abs() < t["band"]
        out["control"] = {"grid_gap": float((low[band] - ref[band]).abs().max()),
                          "vertex_gap": _control_vertex_gap(drv, conf, sc, seed,
                                                            device, t, "tf32")}
    return out


def _control_vertex_gap(drv, conf, sc, seed, device, t, prec, n_slabs=8) -> float:
    """The largest reference |sdf| at the vertices that a grid computed in
    ``prec`` (and fetched as float16) puts on the grid's edges, by linear
    interpolation as marching cubes does, in ``n_slabs`` pairs of adjacent
    x-slabs drawn from the seed."""
    from rnbbench import weights
    from rnbbench.reference import neus
    r = t["resolution"]
    cfg = neus.config(conf)
    P = weights.make(conf["model"], seed, device)
    lo, hi = drv.BBOX
    step = (hi[0] - lo[0]) / (r - 1)
    rng = np.random.default_rng([seed, 29])
    verts = []
    with neus.exact_f32():
        for ix in rng.choice(r - 1, size=n_slabs, replace=False):
            idx = torch.arange(2 * r * r, device=device) + int(ix) * r * r
            pts = drv.grid_points(idx, r, lo, hi)
            g = torch.cat([-neus.sdf_values(cfg, P, pts[s:s + 262144], prec)
                           for s in range(0, len(pts), 262144)])
            g = g.half().double().reshape(2, r, r)
            base = pts.double().reshape(2, r, r, 3)
            for axis, (a, b) in enumerate([(g[0, :-1], g[0, 1:]), (g[0, :, :-1], g[0, :, 1:]),
                                           (g[0], g[1])]):
                cross = (a > 0) != (b > 0)
                frac = a[cross] / (a[cross] - b[cross])
                p0 = (base[0, :-1] if axis == 0 else base[0, :, :-1] if axis == 1
                      else base[0])[cross]
                d = torch.zeros(3, dtype=torch.float64, device=device)
                d[[1, 2, 0][axis]] = step
                verts.append(p0 + frac[:, None] * d)
        v = torch.cat(verts).float()
        sdf = torch.cat([neus.sdf_values(cfg, P, v[s:s + 262144], "f32")
                         for s in range(0, len(v), 262144)])
    return float(sdf.abs().max())


def _half_batch(drv, conf, sc, seed, device, t) -> dict:
    from rnbbench import weights
    from rnbbench.reference import neus
    P = weights.make(conf["model"], seed, device)
    p0 = {k: v.detach().clone() for k, v in neus.leaves(P)}
    half = slice(0, conf["train"]["batch_size"] // 2)
    losses, g1 = neus.train_steps(neus.config(conf), P, sc, seed, t["check_steps"],
                                  "f32", device, block=t["ref_block"], keep=half)
    return {"losses": losses, "grads": {k: v.float().cpu() for k, v in g1.items()},
            "change_norms": compare.leaf_norms(
                (k, v.detach() - p0[k]) for k, v in neus.leaves(P))}


def _as_u8(colour: torch.Tensor) -> np.ndarray:
    """The program's 8-bit frame of a colour image."""
    c = colour.detach().float().cpu().clamp(0.0, 1.0).numpy()
    return (c * 255).astype(np.uint8)


def _drop_chunks(colour: torch.Tensor, bsz: int) -> torch.Tensor:
    flat = colour.reshape(-1, 3).clone()
    for s in range(bsz, flat.shape[0], 2 * bsz):
        flat[s:s + bsz] = 0.0
    return flat.reshape(colour.shape)


def calibrate(cell, seeds, control_seeds, seconds, device, emit=print) -> dict:
    program = []
    for s in seeds:
        nums = {}
        res = runmod.run_cell(cell, s, seconds, False, device, log=lambda _: None,
                              numbers_out=nums)
        program.append(nums)
        emit(json.dumps({"seed": s, "program": nums, "metrics": res["metrics"],
                         "memory_peak_bytes": res["device"]["memory_peak_bytes"]}))
        harness.free(device)
    stand_ins = {}
    for s in control_seeds:
        for kind, nums in _control_readings(cell, s, device).items():
            stand_ins.setdefault(kind, []).append(nums)
            emit(json.dumps({"seed": s, kind: nums}))
        harness.free(device)
    summary = {"lower": {k: max(p[k] for p in program) for k in (program[0] if program else {})}}
    for kind, rows in stand_ins.items():
        if kind != "worst_leaf":
            summary[kind] = {k: min(r[k] for r in rows) for k in rows[0]}
    emit(json.dumps({"summary": summary}))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.1)
    ap.add_argument("--set", action="append", default=[],
                    help="a conf override key=<json value> after the traffic's "
                         "(repeatable), e.g. train.core_impl=\"vjp\"")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    cell = harness.load_cell(args.workload)
    cell.traffic["sets"] = list(cell.traffic.get("sets", [])) + args.set
    calibrate(cell, ints(args.seeds), ints(args.control_seeds), args.seconds, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
