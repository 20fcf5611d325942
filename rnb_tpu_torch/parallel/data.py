"""View-sharded data placement: each rank holds and reads only its views.

The maps (normals, albedos, masks) are the large tensors: ``[V, H, W, 3]``
f32 reaches tens of GB for real captures. Replicated, they cap a dataset
at one card's memory. Sharded, the view order is padded cyclically to a
multiple of the world size, and rank r owns block r of it (``V_local``
views). In a step, every rank samples its rays from its own view at one
slot, so a step sees ``world`` distinct views instead of one, and the
sampling moves no data between ranks: only the loss sums and gradients are
all-reduced. Camera matrices and light frames are small and come with each
rank's views.

The JAX package's ``assemble_from_host_shards`` (and its check that a
process's devices sit contiguously in the mesh) has no counterpart: in
torch no global array exists, and each rank holds its own block.
"""

from __future__ import annotations

import logging
import os
import re

import numpy as np
import torch

from rnb_tpu_torch.data.dataset import DataArrays, Dataset

logger = logging.getLogger(__name__)


def pad_views(n_views: int, world: int) -> list[int]:
    """Global view indices, cyclically padded to a multiple of ``world``
    (the padded entries repeat real views: harmless oversampling)."""
    total = ((n_views + world - 1) // world) * world
    return [i % n_views for i in range(total)]


def host_local_view_indices(n_views: int, rank: int, world: int) -> list[int]:
    """The global view indices rank ``rank`` owns: block ``rank`` of the
    padded order."""
    order = pad_views(n_views, world)
    v_local = len(order) // world
    return order[rank * v_local:(rank + 1) * v_local]


def shard_views(dataset_or_arrays, rank: int, world: int) -> DataArrays:
    """Rank ``rank``'s block of an in-memory dataset (a ``Dataset`` or its
    ``DataArrays``), every leaf indexed along its view axis."""
    arrays = getattr(dataset_or_arrays, "arrays", dataset_or_arrays)
    mine = host_local_view_indices(arrays.normals.shape[0], rank, world)
    idx = torch.tensor(mine, device=arrays.normals.device)
    return DataArrays(*[leaf[idx] for leaf in arrays])


def load_view_sharded_dataset(conf, rank: int, world: int,
                              no_albedo: bool = False, device="cuda") -> Dataset:
    """This rank's views of the IDR case named by a ``dataset`` conf
    section, read from disk without reading any other view's files. The
    global views are counted from ``cameras.npz`` (``world_mat_<i>`` keys by
    full match: IDR files may also carry keys such as
    ``world_mat_inv_0``)."""
    data_dir = conf.get_string("data_dir")
    cams = np.load(os.path.join(data_dir, conf.get_string("render_cameras_name")))
    n_views = len([k for k in cams.files if re.fullmatch(r"world_mat_\d+", k)])
    mine = host_local_view_indices(n_views, rank, world)
    logger.info("rank %d of %d loads global views %s of %d", rank, world, mine,
                n_views)
    return Dataset.from_conf(conf, no_albedo, device=device, view_subset=mine)
