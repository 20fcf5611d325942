"""Atomic npz checkpoints of a training state, in the JAX package's layout.

A checkpoint is an npz of ``leaf_%06d`` arrays plus ``__n_leaves__``,
written to a temp file and then ``os.replace``d (atomic on POSIX), so a
crash mid-write never leaves a truncated file that a resume would pick up.
The leaves follow the flatten order of the JAX package's ``TrainState``
(params, optax adam state, schedule state, step), so a checkpoint written by
either package loads in the other:

  * the P parameter leaves (dict keys sorted, ``bridge.tree_leaves``)
  * Adam's update count (int32)
  * the P first moments, then the P second moments
  * the schedule's update count (int32)
  * the step (int32)

For the shipped confs P = 61, so 186 leaves. A leaf-count or shape mismatch
with the state loaded into raises.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from rnb_tpu_torch.utils import bridge, trace


def state_leaves(state) -> list:
    """The state's leaves as host numpy arrays of their own, in the layout
    above: a snapshot that later steps leave alone (for a CPU tensor
    ``.cpu().numpy()`` shares its memory, and Adam updates in place)."""
    params = [p.detach().cpu().numpy().copy()
              for p in bridge.tree_leaves(state.params)]
    mu, nu, count = bridge.adam_state_to_numpy(state.optimizer, state.params)
    step = np.asarray(state.step, np.int32)
    leaves = (params + [np.asarray(count, np.int32)] + bridge.tree_leaves(mu)
              + bridge.tree_leaves(nu) + [step, step])
    if trace.active():
        trace.count("bytes_to_host", sum(np.asarray(a).nbytes for a in leaves))
    return leaves


def save_checkpoint(path: str, state_or_leaves) -> None:
    """Write a state (or a list of leaves from ``state_leaves``) atomically."""
    leaves = (state_or_leaves if isinstance(state_or_leaves, list)
              else state_leaves(state_or_leaves))
    arrays = {f"leaf_{i:06d}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    arrays["__n_leaves__"] = np.asarray(len(leaves))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, state):
    """Load ``path`` into ``state`` in place (parameters, Adam moments and
    count, step) and return it."""
    with np.load(path) as data:
        n = int(data["__n_leaves__"])
        leaves = [data[f"leaf_{i:06d}"] for i in range(n)]
    params = bridge.tree_leaves(state.params)
    p = len(params)
    if n != 3 * p + 3:
        raise ValueError(f"checkpoint {path} has {n} leaves, the state has "
                         f"{3 * p + 3} (config mismatch?)")
    template = [tuple(t.shape) for t in params]
    for i, (saved, shape) in enumerate(zip(leaves[:p], template)):
        for off in (0, p + 1, 2 * p + 1):   # the param and its two moments
            if leaves[off + i].shape != shape:
                raise ValueError(f"checkpoint leaf shape {leaves[off + i].shape}"
                                 f" != template {shape}")
    with torch.no_grad():
        for t, saved in zip(params, leaves[:p]):
            t.copy_(torch.from_numpy(np.asarray(saved, np.float32)))
    # flat lists of moments line up with tree_leaves(params)
    bridge.adam_state_from_numpy(state.optimizer, state.params,
                                 leaves[p + 1:2 * p + 1],
                                 leaves[2 * p + 1:3 * p + 1], int(leaves[p]))
    state.step = int(leaves[-1])
    return state


CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")


def checkpoint_path(ckpt_dir: str, step: int, prefix: str = "ckpt_") -> str:
    """{prefix}{iter:06d}.npz."""
    return os.path.join(ckpt_dir, f"{prefix}{step:06d}.npz")


def latest_checkpoint(ckpt_dir: str, end_iter: int | None = None) -> str | None:
    """The newest ``ckpt_*.npz`` with step <= end_iter, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(ckpt_dir):
        m = CKPT_RE.search(name)
        if not m:
            continue
        step = int(m.group(1))
        if end_iter is not None and step > end_iter:
            continue
        if step > best_step:
            best, best_step = name, step
    return os.path.join(ckpt_dir, best) if best else None
