"""Weak or strong scaling of the data-parallel training step over the
cards of one host (the port's counterpart of ``tools/bench_scaling.py``).

    [RNB_SCALING_MODE=weak|strong] [RNB_SCALING_BATCH=512]
    [RNB_SCALING_ITERS=40] [RNB_SCALING_VIEW_SHARD=0|1] \\
        python -m rnb_tpu_torch.tools.bench_scaling [--device cuda|cpu]

For each width W of 1, 2, 4, 8, ... up to the cards present, one
``python -m torch.distributed.run --standalone --nproc_per_node W`` launch
of this module's worker, one rank a card (NCCL by the backend rule of
``parallel/mesh.py``), times ``parallel.train.make_sharded_train_step`` (or,
with ``RNB_SCALING_VIEW_SHARD=1``, ``make_view_sharded_train_step`` on each
rank's views) at the shipped ``confs/wmask_rnb.conf`` on the sphere scene
of the JAX tool (8 views of 128x128, radius 0.4), random weights from
seed 0. ``weak`` runs
``RNB_SCALING_BATCH`` rays a rank (the global batch grows with W),
``strong`` that global batch split over the ranks (a width it does not
divide is skipped). Each rank: 3 steps, then three turns of
``RNB_SCALING_ITERS`` steps on the host clock, each ended by a
synchronise; rank 0 prints the median turn's rays/s with the min and max
and the last loss.

Prints one JSON line a width and a summary with
``scaling_efficiency_vs_1dev`` (rays/s at W over W times rays/s at 1). With
one card only width 1 runs, and the summary says so and gives no
efficiency: ranks that share a card measure gloo, not scaling. With
``--device cpu`` widths 1 and 2 run over gloo on the CPU, for the semantics
only: no efficiency. Without a CUDA device and without ``--device cpu`` it
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WIDTHS = (1, 2, 4, 8, 16, 32)


def settings() -> dict:
    env = os.environ.get
    return {"mode": env("RNB_SCALING_MODE", "weak"),
            "view_sharded": env("RNB_SCALING_VIEW_SHARD", "0") == "1",
            "batch": int(env("RNB_SCALING_BATCH", "512")),
            "iters": int(env("RNB_SCALING_ITERS", "40"))}


def worker(args) -> None:
    """One rank of a width's group, launched by torch.distributed.run."""
    import torch.distributed as dist

    from rnb_tpu_torch.data import dataset as ds
    from rnb_tpu_torch.parallel import mesh
    from rnb_tpu_torch.parallel.data import shard_views
    from rnb_tpu_torch.parallel.train import (make_sharded_train_step,
                                              make_view_sharded_train_step)
    from rnb_tpu_torch.tools import bench

    s = settings()
    mesh.maybe_initialize_distributed(args.device)
    dev = mesh.rank_device(args.device)
    rank, world = mesh.rank(), mesh.world()
    gbsz = s["batch"] * world if s["mode"] == "weak" else s["batch"]
    statics, rcfg, tcfg = bench.load(bench.CONF, batch=gbsz)
    scene = ds.make_sphere_scene(n_views=8, H=128, W=128, radius=0.4, device=dev)
    make = (make_view_sharded_train_step if s["view_sharded"]
            else make_sharded_train_step)
    arrays = (shard_views(scene.arrays, rank, world) if s["view_sharded"]
              else scene.arrays)
    fn = make(statics, rcfg, tcfg, warmup=False, no_albedo=False)
    state = bench.fresh_state(bench.init_params(statics, dev))
    secs, loss = bench.step_turns(fn, state, arrays, arrays.normals.shape[0],
                                  bench.draw_generator(dev, rank), s["iters"],
                                  3, dev)
    rps = bench.spread([s["iters"] * gbsz / t for t in secs])
    if rank == 0:
        print(json.dumps({
            "n_devices": world, "global_batch": gbsz,
            "rays_per_s": rps["median"], "rays_per_s_min": rps["min"],
            "rays_per_s_max": rps["max"],
            "ms_per_step": 1e3 * gbsz / rps["median"], "loss": loss,
            "backend": dist.get_backend(), "device": dev.type,
            "card": bench.card_line(dev)}), flush=True)
    dist.destroy_process_group()


def launch(width: int, args) -> dict:
    """One width: torch.distributed.run of ``width`` workers -> rank 0's
    line. A failed launch raises."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(width), "-m",
           "rnb_tpu_torch.tools.bench_scaling", "--worker",
           "--device", args.device]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH", "")) if p)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=1800)
    if proc.returncode != 0:
        raise SystemExit(f"bench_scaling: width {width} exited "
                         f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    row = json.loads([l for l in proc.stdout.splitlines()
                      if l.startswith('{"n_devices"')][-1])
    row["launch_s"] = time.perf_counter() - t0
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args)
        return {}
    from rnb_tpu_torch.tools.bench import device_or_exit

    dev = device_or_exit("bench_scaling", args.device)
    s = settings()
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    widths = ([1, 2] if dev.type == "cpu"
              else [w for w in WIDTHS if w <= n_cards])
    rows = []
    for w in widths:
        if s["mode"] == "strong" and s["batch"] % w:
            continue
        rows.append(launch(w, args))
        print(json.dumps(rows[-1]), flush=True)
    eff, note = None, "hardware"
    if dev.type == "cpu":
        note = "CPU over gloo: semantics only, not hardware scaling"
    elif len(rows) < 2:
        note = ("one card: width 1 only, no scaling figure (ranks that share "
                "a card measure gloo, not scaling)")
    else:
        base = rows[0]["rays_per_s"]
        eff = {r["n_devices"]: r["rays_per_s"] / (base * r["n_devices"])
               for r in rows}
    summary = {"mode": s["mode"], "view_sharded": s["view_sharded"],
               "batch": s["batch"], "iters": s["iters"], "device": dev.type,
               "widths": [r["n_devices"] for r in rows],
               "backend": sorted({r["backend"] for r in rows}),
               "scaling_efficiency_vs_1dev": eff, "note": note}
    print(json.dumps(summary), flush=True)
    return dict(summary, rows=rows)


if __name__ == "__main__":
    main()
