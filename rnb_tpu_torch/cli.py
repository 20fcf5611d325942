"""Command line of the port, with the JAX package's modes and flags:

    python -m rnb_tpu_torch.cli --mode {train_rnb, validate_mesh,
            validate_mesh_texture, validate_image_ps, interpolate_<i>_<j>}
        --conf CONF --case CASE [--mcube_threshold T] [--is_continue]
        [--no_albedo] [--shard auto|off|1] [--set PATH=VALUE ...]
        [--mesh_resolution R] [--device cuda|cpu]

``train_rnb`` trains from the conf (resuming with ``--is_continue``), then
writes a world-space mesh at ``--mesh_resolution``. The other modes load
the newest checkpoint: ``validate_mesh`` writes the mesh,
``validate_mesh_texture`` the mesh with albedo vertex colours,
``validate_image_ps`` one view under every light, and
``interpolate_<i>_<j>`` a video of novel views from camera i to camera j.
The run is on the CUDA card unless ``--device cpu`` is given; without a
card the command exits non-zero rather than carry on on the CPU. At the end
it prints one JSON line of the kernel launches it made,
``{"launches": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

MODES = ("train_rnb", "validate_mesh", "validate_mesh_texture",
         "validate_image_ps")


def _interpolate_views(mode: str):
    """(i, j) of ``interpolate_<i>_<j>``; exits naming the form otherwise."""
    parts = mode.split("_")
    if len(parts) != 3 or not all(p.isdigit() for p in parts[1:]):
        sys.exit(f"mode {mode!r}: write interpolate_<i>_<j> with two view "
                 "indices, e.g. interpolate_0_1")
    return int(parts[1]), int(parts[2])


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="[%(filename)s:%(lineno)s - %(funcName)20s() ] %(message)s")
    parser = argparse.ArgumentParser(description="rnb_tpu_torch experiment runner")
    parser.add_argument("--conf", type=str, default="./confs/wmask_rnb.conf")
    parser.add_argument("--mode", type=str, default="train_rnb")
    parser.add_argument("--mcube_threshold", type=float, default=0.0)
    parser.add_argument("--is_continue", default=False, action="store_true")
    parser.add_argument("--case", type=str, default="")
    parser.add_argument("--no_albedo", default=False, action="store_true")
    parser.add_argument("--shard", type=str, default="auto",
                        help="'auto', 'off' or 1: one device")
    parser.add_argument("--set", dest="overrides", action="append", default=[],
                        metavar="PATH=VALUE",
                        help="conf override, e.g. --set train.end_iter=1000 "
                             "(repeatable)")
    parser.add_argument("--mesh_resolution", type=int, default=512,
                        help="marching-cubes grid resolution of the mesh")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    views = None
    if args.mode.startswith("interpolate"):
        views = _interpolate_views(args.mode)
    elif args.mode not in MODES:
        sys.exit(f"unknown mode {args.mode!r}")
    if args.shard not in ("auto", "off", "1"):
        sys.exit(f"--shard {args.shard}: rnb_tpu_torch runs on one device; "
                 "several come with ROADMAP.md, queue 1, item 13")

    import torch

    if args.device not in ("cuda", "cpu"):
        sys.exit(f"--device must be 'cuda' or 'cpu', got {args.device!r}")
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: rnb_tpu_torch runs on the card; pass "
                 "--device cpu to run on the CPU")
    if os.environ.get("RNB_DEBUG_NANS", "0") == "1":
        torch.autograd.set_detect_anomaly(True)

    from rnb_tpu_torch.ops import _build
    from rnb_tpu_torch.train.runner import Runner

    runner = Runner(args.conf, args.mode, args.case,
                    is_continue=args.is_continue or args.mode != "train_rnb",
                    no_albedo=args.no_albedo, overrides=args.overrides,
                    device=args.device)
    mesh = dict(world_space=True, resolution=args.mesh_resolution,
                threshold=args.mcube_threshold)
    if args.mode == "train_rnb":
        runner.train_rnb()
        runner.validate_mesh(**mesh)
    elif args.mode == "validate_mesh":
        runner.validate_mesh(**mesh)
    elif args.mode == "validate_mesh_texture":
        runner.validate_mesh_texture(**mesh)
    elif args.mode == "validate_image_ps":
        runner.validate_image_ps()
    else:
        runner.interpolate_view(*views)
    print(json.dumps({"launches": dict(_build.launches)}), flush=True)


if __name__ == "__main__":
    main()
