"""Weights and optimizer state carried across from the JAX package.

A parameter tree here has the JAX package's pytree structure (nested dicts
and lists, ``W`` as ``[in, out]``, weight-norm layers as ``{v, g, b}``), so
the bridge is a structural map over numpy arrays. ``tree_leaves`` orders
dict keys sorted, as ``jax.tree_util.tree_leaves`` does, so flat lists line
up between the two packages.
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch


def tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """JAX params pytree (numpy or array-like leaves) -> the port's params:
    float32 leaf tensors on ``device`` that require grad."""
    return tree_map(
        lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                               device=device).requires_grad_(True), tree)


def params_to_numpy(tree: Any) -> Any:
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def adam_state_from_numpy(optimizer: torch.optim.Adam, params: Any,
                          mu: Any, nu: Any, count: int) -> None:
    """Load optax ``ScaleByAdamState`` (mu, nu, count) into a
    ``torch.optim.Adam`` over ``tree_leaves(params)``: exp_avg = mu,
    exp_avg_sq = nu, step = count."""
    for p, m, v in zip(tree_leaves(params), tree_leaves(mu), tree_leaves(nu)):
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.tensor(np.asarray(m), dtype=torch.float32,
                                    device=p.device),
            "exp_avg_sq": torch.tensor(np.asarray(v), dtype=torch.float32,
                                       device=p.device),
        }


def adam_state_to_numpy(optimizer: torch.optim.Adam, params: Any):
    """(mu, nu, count) trees shaped like ``params``; a parameter Adam has
    not stepped yet reads as zero moments."""
    def moment(key):
        def get(p):
            st = optimizer.state.get(p, {})
            t = st.get(key)
            return (np.zeros(tuple(p.shape), np.float32) if t is None
                    else t.detach().cpu().numpy())
        return tree_map(get, params)

    steps = [int(optimizer.state[p]["step"]) for p in tree_leaves(params)
             if p in optimizer.state]
    return moment("exp_avg"), moment("exp_avg_sq"), max(steps, default=0)
