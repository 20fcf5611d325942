"""The SDF grid of mesh extraction, split over the ranks of a process group.

The 512³ extraction is ~134M evaluations of the SDF net. As in the serial
``models/renderer.py`` ``extract_fields``, the flat grid is walked in 64³
chunks whose points are made on the device; here each chunk is split into
``world`` contiguous slices and rank r evaluates slice r (f32 cuBLAS, TF32
off, as the serial query). Every rank then receives the whole chunk by one
all-reduce of a zero-filled chunk into which each rank wrote its own slice:
adding zeros is exact, and all-reduce runs on NCCL and gloo alike. The
grid is fetched once, as f16, as the serial query fetches it, so every rank
can polygonize it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from rnb_tpu_torch.models.fields import ModelStatics
from rnb_tpu_torch.models.renderer import grid_chunk_points, sdf_grid_query


def extract_fields_sharded(statics: ModelStatics, params, bound_min, bound_max,
                           resolution: int, group=None, chunk: int = 64 ** 3,
                           negate: bool = True) -> np.ndarray:
    """(−)SDF on a dense ``resolution``³ grid -> float32 numpy [R, R, R] on
    every rank of ``group``; a collective: every rank must call it."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    sdf_params = params["sdf"]
    dev = sdf_params[0]["b"].device
    bmin = [float(x) for x in np.asarray(bound_min).reshape(-1)]
    bmax = [float(x) for x in np.asarray(bound_max).reshape(-1)]
    total = resolution ** 3
    out = torch.empty(total, dtype=torch.float16, device=dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            for start in range(0, total, chunk):
                n = min(chunk, total - start)
                per = -(-n // world)
                lo, hi = min(rank * per, n), min((rank + 1) * per, n)
                vals = torch.zeros(n, dtype=torch.float32, device=dev)
                if hi > lo:
                    pts = grid_chunk_points(start + lo, hi - lo, bmin, bmax,
                                            resolution, dev)
                    vals[lo:hi] = sdf_grid_query(statics.sdf, sdf_params, pts,
                                                 negate)
                dist.all_reduce(vals, group=group)
                out[start:start + n] = vals.to(torch.float16)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out.cpu().numpy().astype(np.float32).reshape(
        resolution, resolution, resolution)
