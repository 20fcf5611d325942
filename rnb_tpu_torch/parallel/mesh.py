"""The process group of the parallel path.

The JAX package lays a 1-D ``ray`` mesh over its devices and shards the
ray batch along it. Here that mesh is a torch process group of ``world``
ranks, one process and one device a rank, launched by
``python -m torch.distributed.run`` (torchrun):

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m rnb_tpu_torch.cli --mode train_rnb ...

``maybe_initialize_distributed`` joins the group when torchrun's
``WORLD_SIZE`` is set, or when ``RNB_DISTRIBUTED=1`` as in the JAX package
(then ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` come
from the caller). The backend is chosen once, by rule, before the group
starts, never after a failure, and logged:

  * ``RNB_DIST_BACKEND`` wins when it is set;
  * gloo on the CPU;
  * gloo when the ranks of a host share a card (more local ranks than
    cards): NCCL refuses two ranks on one device, and this is the only way
    to run two ranks on one card;
  * NCCL otherwise, every rank on a card of its own.

NCCL asked for while ranks share a card raises, naming
``RNB_DIST_BACKEND=gloo``. Without a group, ``world()`` is 1 and the
caller is the chief.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# a rank that hangs fails the run after this long in a collective
TIMEOUT = timedelta(minutes=5)


def _local_world() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))


def choose_backend(device_kind: str) -> str:
    """The backend by the rules of the module docstring."""
    shared = device_kind == "cuda" and _local_world() > torch.cuda.device_count()
    asked = os.environ.get("RNB_DIST_BACKEND", "")
    if asked == "nccl" and (device_kind != "cuda" or shared):
        where = ("on the CPU" if device_kind != "cuda" else
                 f"with {_local_world()} ranks on {torch.cuda.device_count()} "
                 "card(s)")
        raise ValueError(f"RNB_DIST_BACKEND=nccl {where}: NCCL needs a card of "
                         "its own for every rank; set RNB_DIST_BACKEND=gloo")
    if asked:
        return asked
    return "gloo" if device_kind != "cuda" or shared else "nccl"


def maybe_initialize_distributed(device_kind: str = "cuda") -> bool:
    """Join the process group when launched as one (see the module
    docstring); -> whether a group exists. ``device_kind`` is the device
    every rank runs on, ``"cuda"`` or ``"cpu"``."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ and os.environ.get("RNB_DISTRIBUTED", "0") != "1":
        return False
    backend = choose_backend(device_kind)
    if device_kind == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
    dist.init_process_group(backend, timeout=TIMEOUT)
    logger.info("process group: rank %d of %d, backend %s, device %s",
                dist.get_rank(), dist.get_world_size(), backend,
                rank_device(device_kind))
    return True


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_chief() -> bool:
    return rank() == 0


def rank_device(device_kind: str) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}``, or the CPU
    when ``device_kind`` is ``"cpu"``."""
    if device_kind == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def shard_width(shard, n_ranks: int) -> int:
    """The width ``--shard`` asks for, checked against the group's:
    ``auto`` is the group's world size, ``off`` and 1 one rank, N must be
    the world size. Raises ValueError naming both otherwise."""
    want = n_ranks if shard == "auto" else 1 if shard == "off" else int(shard)
    if want < 1 or want != n_ranks:
        raise ValueError(f"--shard {shard} asks for {want} rank(s), but this run "
                         f"has a world size of {n_ranks}: launch "
                         f"{max(want, 1)} process(es) with python -m "
                         "torch.distributed.run --nproc_per_node N, or pass "
                         "--shard auto")
    return want
