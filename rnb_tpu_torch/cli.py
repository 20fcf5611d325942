"""Command line of the port, with the JAX package's modes and flags:

    python -m rnb_tpu_torch.cli --mode {train_rnb, validate_mesh,
            validate_mesh_texture, validate_image_ps, interpolate_<i>_<j>}
        --conf CONF --case CASE [--mcube_threshold T] [--is_continue]
        [--no_albedo] [--shard auto|off|N] [--set PATH=VALUE ...]
        [--mesh_resolution R] [--device cuda|cpu]

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m rnb_tpu_torch.cli ...      # N ranks train one model together

``train_rnb`` trains from the conf (resuming with ``--is_continue``), then
writes a world-space mesh at ``--mesh_resolution``. The other modes load
the newest checkpoint: ``validate_mesh`` writes the mesh,
``validate_mesh_texture`` the mesh with albedo vertex colours,
``validate_image_ps`` one view under every light, and
``interpolate_<i>_<j>`` a video of novel views from camera i to camera j.
The run is on the CUDA card unless ``--device cpu`` is given; without a
card the command exits non-zero rather than carry on on the CPU.

Launched as N processes by ``torch.distributed.run``, the ranks join one
process group (``parallel/mesh.py`` picks the backend: NCCL with a card a
rank, gloo on the CPU or when ranks share a card, ``RNB_DIST_BACKEND``
first) and train one model with the one-rank numbers (``parallel/``);
``--shard N`` checks that N ranks were launched (``auto``, the default,
takes what was launched; ``off`` means one). The chief writes; the mesh
modes split the grid query over the ranks.

At the end every rank prints one JSON line of the kernel launches it made,
with its rank, the world size and a digest of its final parameters,
``{"launches": {...}, "rank": r, "world": w, "params_sha256": "..."}``.
"""

from __future__ import annotations

import argparse
import hashlib
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


def _shard(value: str) -> str:
    """``auto``, ``off`` or a positive rank count."""
    if value in ("auto", "off") or (value.isdigit() and int(value) > 0):
        return value
    raise argparse.ArgumentTypeError(
        f"{value!r}: write auto, off or a positive number of ranks")


def params_sha256(params) -> str:
    """Digest of the parameter leaves' bytes, in ``tree_leaves`` order:
    equal across ranks when the parameters are equal bit for bit."""
    from rnb_tpu_torch.utils.bridge import tree_leaves

    h = hashlib.sha256()
    for p in tree_leaves(params):
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


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
    parser.add_argument("--shard", type=_shard, default="auto",
                        help="'auto' (the ranks launched), 'off' (one) or the "
                             "number of ranks launched")
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

    import torch

    if args.device not in ("cuda", "cpu"):
        sys.exit(f"--device must be 'cuda' or 'cpu', got {args.device!r}")
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: rnb_tpu_torch runs on the card; pass "
                 "--device cpu to run on the CPU")
    if os.environ.get("RNB_DEBUG_NANS", "0") == "1":
        torch.autograd.set_detect_anomaly(True)

    from rnb_tpu_torch.ops import _build
    from rnb_tpu_torch.parallel import mesh as meshlib
    from rnb_tpu_torch.train.runner import Runner

    group = meshlib.maybe_initialize_distributed(args.device)
    try:
        runner = Runner(args.conf, args.mode, args.case,
                        is_continue=args.is_continue or args.mode != "train_rnb",
                        no_albedo=args.no_albedo, overrides=args.overrides,
                        device=meshlib.rank_device(args.device),
                        shard=args.shard)
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
        # one write: ranks launched by torch.distributed.run share the
        # stream unbuffered, and print() writes the line and its end apart
        sys.stdout.write(json.dumps({
            "launches": dict(_build.launches), "rank": runner.rank,
            "world": runner.world,
            "params_sha256": params_sha256(runner.state.params)}) + "\n")
        sys.stdout.flush()
    finally:
        if group:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
