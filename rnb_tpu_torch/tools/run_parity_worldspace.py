"""World-space gate on a non-square, self-normalized capture (the port's
copy of ``tools/run_parity_worldspace.py``):

    python -m rnb_tpu_torch.tools.run_parity_worldspace [--iters 30000]
        [--warmup 20000] [--width 612 --height 512] [--n_views 8]
        [--mesh_resolution 512] [--out exp/parity_worldspace.json]
        [--skip_existing] [--device cuda|cpu]

  1. a DiLiGenT-MV-shaped capture: 612x512, a degraded torus centred off
     the origin at (0.15, -0.1, 0.08), written un-normalized (identity
     scale mats) by ``make_synthetic_case``;
  2. the port's scene normalization (``preprocess_cameras``, visual-hull
     refined, on ``--device``) writes non-identity scale mats;
  3. ``confs/wmask_rnb.conf`` trains on the compressed 30k/20k schedule
     through the CLI, whose ``train_rnb`` ends by writing the mesh in world
     space (vertices x scale + t of the first scale mat);
  4. the gate: Chamfer-L1 against the analytic torus at its world centre,
     in world units, at 0.004 (the torus is the square case's one,
     translated; the scale mat changes the training's internal frame, not
     the object's size).

Training and gating are ``run_parity_matrix``'s, with the case and the
record under the current directory. The record holds the scale mat; exit
0 when accepted.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from rnb_tpu_torch.tools.ablate_kernel import card
from rnb_tpu_torch.tools.run_parity_matrix import (make_case, run_variant,
                                                   write_record)

CENTER = (0.15, -0.1, 0.08)
SPEC = {"conf": "confs/wmask_rnb.conf", "threshold": 0.004, "extra": [],
        "center": CENTER}


def main(argv=None):
    ap = argparse.ArgumentParser(description="world-space parity gate")
    ap.add_argument("--case", default="torus_ns")
    ap.add_argument("--iters", type=int, default=30000)
    ap.add_argument("--warmup", type=int, default=20000)
    ap.add_argument("--width", type=int, default=612)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--n_views", type=int, default=8)
    ap.add_argument("--mesh_resolution", type=int, default=512)
    ap.add_argument("--out", default="exp/parity_worldspace.json")
    ap.add_argument("--skip_existing", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    make_case(args.case, ["--n_views", str(args.n_views),
                          "--width", str(args.width),
                          "--height", str(args.height),
                          "--center", *[str(c) for c in CENTER],
                          "--normalize", "--device", args.device])
    with np.load(os.path.join("data", args.case, "cameras.npz")) as cams:
        scale_mat = cams["scale_mat_0"]
    scale = float(scale_mat[0, 0])
    if not (abs(scale - 1.0) > 0.05 or np.abs(scale_mat[:3, 3]).max() > 0.05):
        raise SystemExit("the case is not normalized: its scale mats look "
                         "like the identity")

    rec = run_variant("wmask_rnb", SPEC, args.case, args)
    return write_record(args.out, {
        "protocol": (f"{args.width}x{args.height} non-square degraded torus "
                     f"at world centre {CENTER}, normalized by "
                     "rnb_tpu_torch.preprocess.preprocess_cameras (scale "
                     f"{scale:.6f}, t {scale_mat[:3, 3].tolist()}), "
                     f"{args.iters} iters ({args.warmup} warm-up), "
                     f"{args.mesh_resolution}^3 world-space extraction, "
                     "Chamfer-L1 in world units vs the clean analytic torus; "
                     f"rnb_tpu_torch on {args.device}"),
        "scale_mat_scale": scale,
        "scale_mat_t": [float(x) for x in scale_mat[:3, 3]],
        "threshold_world": SPEC["threshold"],
        "card": "cpu" if args.device == "cpu" else card(),
        "wmask_rnb": rec,
        "all_accepted": bool(rec.get("accepted")),
    })


if __name__ == "__main__":
    raise SystemExit(main())
