"""End-to-end acceptance gate: Chamfer-L1 of the newest mesh against the
analytic ground-truth surface, and training-log sanity; exit 1 on failure
(the port's copy of ``tools/acceptance.py``):

    python -m rnb_tpu_torch.tools.acceptance EXP_DIR --shape torus
        [--threshold 0.005] [--warm_up_iter N]

  1. the newest mesh in EXP_DIR/meshes: the accuracy side is the
     closed-form distance (|sdf| of each mesh sample), the completeness side
     samples the true surface and queries the mesh samples;
  2. EXP_DIR/logs/scalars.jsonl: every logged loss finite, the loss falls,
     and with --warm_up_iter the run crossed the warm-up boundary.

Prints one JSON line; exit 0 = accepted, 1 = a gate failed.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from rnb_tpu_torch.data.dataset import torus_sdf
from rnb_tpu_torch.tools.eval_chamfer import nn_distances, sample_surface
from rnb_tpu_torch.utils.io import read_ply


def sample_torus_surface(n: int, R: float = 0.5, r: float = 0.22,
                         seed: int = 0) -> np.ndarray:
    """Area-weighted uniform samples of the analytic torus (rejection on
    the (R + r cos v) area factor)."""
    rng = np.random.default_rng(seed)
    pts = []
    while sum(len(p) for p in pts) < n:
        u = rng.uniform(0, 2 * np.pi, n)
        v = rng.uniform(0, 2 * np.pi, n)
        keep = rng.random(n) < (R + r * np.cos(v)) / (R + r)
        u, v = u[keep], v[keep]
        pts.append(np.stack([(R + r * np.cos(v)) * np.cos(u),
                             (R + r * np.cos(v)) * np.sin(u),
                             r * np.sin(v)], axis=-1))
    return np.concatenate(pts)[:n]


def sphere_sdf(p: np.ndarray, radius: float) -> np.ndarray:
    return np.linalg.norm(p, axis=-1) - radius


def sample_sphere_surface(n: int, radius: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    return radius * v / np.linalg.norm(v, axis=-1, keepdims=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description="end-to-end acceptance gate")
    ap.add_argument("exp_dir")
    ap.add_argument("--shape", choices=["torus", "sphere"], default="torus")
    ap.add_argument("--radius", type=float, default=0.35,
                    help="sphere radius (shape=sphere)")
    ap.add_argument("--R", type=float, default=0.5)
    ap.add_argument("--r", type=float, default=0.22)
    ap.add_argument("--threshold", type=float, default=0.005,
                    help="max allowed Chamfer-L1 (scene units)")
    ap.add_argument("--center", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                    help="world-space center of the analytic surface")
    ap.add_argument("--warm_up_iter", type=int, default=None,
                    help="if set, require logged steps on both sides")
    ap.add_argument("--n_points", type=int, default=200000)
    args = ap.parse_args(argv)

    failures = []

    meshes = sorted(glob.glob(os.path.join(args.exp_dir, "meshes", "*.ply")))
    if not meshes:
        raise SystemExit(f"no meshes under {args.exp_dir}/meshes")
    v, f, _ = read_ply(meshes[-1])
    rng = np.random.default_rng(0)
    mesh_pts = sample_surface(np.asarray(v, np.float64), np.asarray(f),
                              args.n_points, rng)
    center = np.asarray(args.center, np.float64)
    if args.shape == "torus":
        acc = np.abs(torus_sdf(mesh_pts - center, args.R, args.r))
        gt_pts = sample_torus_surface(args.n_points, args.R, args.r) + center
    else:
        acc = np.abs(sphere_sdf(mesh_pts - center, args.radius))
        gt_pts = sample_sphere_surface(args.n_points, args.radius) + center
    comp = nn_distances(gt_pts, mesh_pts)
    chamfer_l1 = 0.5 * (acc.mean() + comp.mean())
    if chamfer_l1 > args.threshold:
        failures.append(f"chamfer {chamfer_l1:.5f} > {args.threshold}")

    log = {}
    scal = os.path.join(args.exp_dir, "logs", "scalars.jsonl")
    if os.path.exists(scal):
        losses, steps = [], []
        with open(scal) as fh:
            for line in fh:
                rec = json.loads(line)
                if "Loss/loss" in rec:
                    losses.append(rec["Loss/loss"])
                    steps.append(rec["step"])
        if losses:
            head = float(np.mean(losses[:50])) if len(losses) > 50 else losses[0]
            tail = float(np.mean(losses[-50:]))
            log = {"first_loss": round(head, 5), "last_loss": round(tail, 5),
                   "max_step": max(steps), "n_logged": len(losses)}
            if not np.all(np.isfinite(losses)):
                failures.append("non-finite loss logged")
            if tail >= head:
                failures.append(f"loss did not decrease ({head}->{tail})")
            if args.warm_up_iter is not None:
                if not (min(steps) <= args.warm_up_iter <= max(steps)
                        and any(s > args.warm_up_iter for s in steps)):
                    failures.append("run never crossed the warm-up boundary")
        else:
            failures.append("scalars.jsonl has no loss records")
    else:
        failures.append("no scalars.jsonl")

    print(json.dumps({
        "mesh": os.path.basename(meshes[-1]),
        "n_vertices": int(len(v)),
        "chamfer_l1": round(float(chamfer_l1), 6),
        "accuracy_mean": round(float(acc.mean()), 6),
        "completeness_mean": round(float(comp.mean()), 6),
        "accuracy_p95": round(float(np.quantile(acc, 0.95)), 6),
        "threshold": args.threshold,
        **log,
        "failures": failures,
        "accepted": not failures,
    }))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
