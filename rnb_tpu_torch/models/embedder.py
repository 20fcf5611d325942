"""NeRF-style positional encoding on tensors.

Layout ``[x, sin(f0·x), cos(f0·x), sin(f1·x), cos(f1·x), ...]`` with
``f_k = 2^k`` and the identity block first (the SDF geometric init relies on
the raw coordinates occupying the first ``input_dims`` channels).
"""

from __future__ import annotations

import torch


def embedder_out_dim(multires: int, input_dims: int = 3) -> int:
    if multires <= 0:
        return input_dims
    return input_dims * (1 + 2 * multires)


def make_embedder(multires: int, input_dims: int = 3):
    """Return ``(embed_fn, out_dim)``; ``embed_fn`` maps
    ``[..., input_dims] -> [..., out_dim]``."""
    if multires <= 0:
        return (lambda x: x), input_dims

    out_dim = embedder_out_dim(multires, input_dims)

    def embed(x: torch.Tensor) -> torch.Tensor:
        freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
        ang = x[..., None, :] * freqs[:, None]                 # [..., F, D]
        sc = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-2)
        sc = sc.reshape(*x.shape[:-1], 2 * multires * x.shape[-1])
        return torch.cat([x, sc], dim=-1)

    return embed, out_dim
