"""The host-side pieces of the SDF core's bf16 backward sweep, on the CPU:
the TMA boxes of its weight ring against the cores the cp.async copies of
``csrc/wg_pipe.cuh`` (``wg_copy_fwd`` / ``wg_copy_rev``) put in a stage,
the order of the ring's stages against the products the sweep runs, and
its tiles.

The boxes are emulated in numpy as TMA loads them: a box of (b0, b1, b2)
elements at coordinates (c0, c1, c2) of a map of dims (d0, d1, d2), dim 0
fastest, written to shared memory in that order, elements past a dim read
as zero.
"""

import numpy as np
import pytest
import torch

from rnb_tpu_torch.models import fields
from rnb_tpu_torch.ops import sdf_core, wg

torch.set_num_threads(1)

# the shipped net, a narrow one (hidden 64: boxes run past npc and kpc) and
# one with a ragged PE and skip input
CFGS = {"shipped": fields.SDFConfig(),
        "narrow": fields.SDFConfig(d_hidden=64, n_layers=4, skip_in=(2,),
                                   multires=2),
        "ragged": fields.SDFConfig(d_hidden=40, n_layers=3, skip_in=(2,),
                                   multires=3, d_out=9)}


def _layout(cfg, n=0):
    gen = torch.Generator().manual_seed(2)
    ws = [fields.fold_weight_norm(l).detach()
          for l in fields.init_sdf_network(gen, cfg, "cpu")]
    return ws, sdf_core.wg_layout(cfg, ws, n)


def _image(ws, lay):
    """The packed image with every element distinct (its index + 1), so a
    misplaced core shows; zero where pack_weights pads."""
    ones = [torch.ones_like(w) for w in ws]
    mask = wg.pack_weights(ones, lay, torch.float32).numpy()
    return (np.arange(mask.size, dtype=np.float64) + 1) * mask


def _tma_box(tile, dims, box, coords):
    """One TMA load of a 3-D box from ``tile`` (flat, dims innermost
    first), zeros past the dims; the box flat, dim 0 fastest."""
    d0, d1, d2 = dims
    t = tile.reshape(d2, d1, d0)
    out = np.zeros((box[2], box[1], box[0]))
    for i2 in range(box[2]):
        for i1 in range(box[1]):
            for i0 in range(box[0]):
                a0, a1, a2 = coords[0] + i0, coords[1] + i1, coords[2] + i2
                if a0 < d0 and a1 < d1 and a2 < d2:
                    out[i2, i1, i0] = t[a2, a1, a0]
    return out.reshape(-1)


def _copy_fwd(w, npc, t, nb=32):
    """wg_copy_fwd: cores (kb, ob) of K-step t at (kb·nb + ob)·64, zero
    past npc."""
    st = np.zeros(2 * nb * 64)
    for kb in range(2):
        for ob in range(min(nb, npc)):
            src = ((2 * t + kb) * npc + ob) * 64
            st[(kb * nb + ob) * 64:(kb * nb + ob + 1) * 64] = w[src:src + 64]
    return st


def _copy_rev(w, npc, kpc, t, ibn=32):
    """wg_copy_rev: cores (ib, kb) of output K-step t at (ib·2 + kb)·64,
    zero past kpc."""
    st = np.zeros(ibn * 2 * 64)
    for ib in range(min(ibn, kpc)):
        for kb in range(2):
            src = (ib * npc + 2 * t + kb) * 64
            st[(ib * 2 + kb) * 64:(ib * 2 + kb + 1) * 64] = w[src:src + 64]
    return st


@pytest.mark.parametrize("name", sorted(CFGS))
def test_stage_boxes_are_the_copies(name):
    """Every stage the sweep's ring loads by TMA holds exactly the cores
    the cp.async copies put there (the forward at nb = 32, the reverse
    over 32 input cores), zero-filled past the layer's npc and kpc; a
    stage is 8 KB."""
    ws, lay = _layout(CFGS[name])
    image = _image(ws, lay)
    for kind, l, coords in sdf_core.sweep_steps(lay):
        dims, strides = sdf_core.sweep_map(lay, l)
        assert strides == (128, dims[1] * 128)
        box = sdf_core.SWEEP_BOX[kind]
        assert np.prod(box) * 2 == 8192
        tile = image[lay["w_off"][l]:lay["w_off"][l] + lay["kp"][l] * lay["np"][l]]
        got = _tma_box(tile, dims, box, coords)
        if kind == "fwd":
            want = _copy_fwd(tile, dims[1], coords[2] // 2)
        else:
            want = _copy_rev(tile, dims[1], dims[2], coords[1] // 2)
        np.testing.assert_array_equal(got, want, err_msg=f"{kind} {l} {coords}")


@pytest.mark.parametrize("name", sorted(CFGS))
def test_ring_order_is_the_products(name):
    """The ring's stages are the K-steps of the sweep's products in order:
    per forward layer l < L-1 one product (both slabs on each stage) of
    pad16(in_l)/16 steps, per reverse layer L-1..1 one of pad16(out_l)/16
    steps; every box lies inside the map's K extent."""
    ws, lay = _layout(CFGS[name])
    L = len(ws)
    steps = sdf_core.sweep_steps(lay)
    want = []
    for l in range(L - 1):
        want += [("fwd", l, t) for t in range(-(-ws[l].shape[0] // 16))]
    for l in range(L - 1, 0, -1):
        want += [("rev", l, t) for t in range(-(-ws[l].shape[1] // 16))]
    got = [(k, l, (c[2] if k == "fwd" else c[1]) // 2) for k, l, c in steps]
    assert got == want
    for kind, l, coords in steps:
        dims, _ = sdf_core.sweep_map(lay, l)
        k_axis = 2 if kind == "fwd" else 1
        assert coords[k_axis] + 2 <= dims[k_axis]


def test_ring_traffic_of_the_shipped_net():
    """The shipped net streams 242 stages of 8 KB a 64-point tile (115 in
    the forward: 3 + 7 x 16 K-steps; 127 in the reverse: 17 + 4 x 16 + 14
    + 2 x 16): 1.98 MB of weights a tile, 2.03 GB over the 1,024 tiles of
    65,536 points."""
    _, lay = _layout(CFGS["shipped"])
    steps = sdf_core.sweep_steps(lay)
    assert sum(k == "fwd" for k, _, _ in steps) == 115
    assert sum(k == "rev" for k, _, _ in steps) == 127
    assert len(steps) * 8192 * (65536 // wg.TILE) == 2_030_043_136


@pytest.mark.parametrize("n", [1, 37, 64, 517, 520, 1037, 65536])
def test_tiles_cover_every_point_once(n):
    """The sweep runs one block a 64-point tile, ceil(n/64) of them, each
    writing its own db partial: the tiles' rows partition [0, n)."""
    tiles = -(-n // wg.TILE)
    rows = np.concatenate([np.arange(t * wg.TILE, min((t + 1) * wg.TILE, n))
                           for t in range(tiles)])
    np.testing.assert_array_equal(rows, np.arange(n))


def test_split_names():
    """The timing split's instances are named in the C enum's order, and
    another name is refused before anything launches."""
    assert sdf_core.BWD_SPLIT == ("full", "no_record", "no_epilogue",
                                  "no_rows", "products_only")
    cfg = CFGS["narrow"]
    ws, _ = _layout(cfg)
    with pytest.raises(ValueError, match="split must be one of"):
        sdf_core.sdf_bwd_split("no_pe", cfg, torch.zeros(4, 3), ws,
                               [torch.zeros(w.shape[1]) for w in ws],
                               torch.zeros(4), torch.zeros(4, cfg.d_out - 1),
                               torch.zeros(4, 3))
