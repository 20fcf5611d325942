"""The host-side pieces of the SDF core's bf16 forward, on the CPU: the TMA
boxes of its weight ring against the stages its products read, written out
from the 8x8-core layout of the weight image (``_copy_fwd`` / ``_copy_rev``
of ``test_torch_sdf_bwd_sched``), the order of the ring's stages against
the products, the turns its two tiles take at the ring (simulated stage
by stage), the tiles its blocks cover, its shared memory, and the names
of its timing split.

The boxes are emulated in numpy as TMA loads them (the helpers of
``test_torch_sdf_bwd_sched``).
"""

import numpy as np
import pytest
import torch

from rnb_tpu_torch.ops import _build, sdf_core, wg
from rnb_tpu_torch.tools import ablate_kernel, bench_sdf_fwd
from test_torch_sdf_bwd_sched import (CFGS, _copy_fwd, _copy_rev, _image,
                                      _layout, _tma_box)

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_fwd_stage_boxes_are_the_copies(name):
    """Every stage the forward's ring loads by TMA holds exactly the cores
    of its K-step in the layout its product reads: the forward at 32
    output cores, 33 at the head (its N = 8 product reads core 32), the
    reverse over 32 input cores, 6 at layer 0 (its 48 PE channels); zero
    past the layer's npc and kpc; no box over a stage slot's 8,448 B."""
    ws, lay = _layout(CFGS[name])
    L = len(ws)
    image = _image(ws, lay)
    for kind, l, coords in sdf_core.fwd_steps(lay):
        dims, strides = sdf_core.sweep_map(lay, l)
        box = sdf_core.fwd_box(lay, kind, l)
        assert np.prod(box) * 2 <= sdf_core.FWD_STAGE_BYTES
        tile = image[lay["w_off"][l]:lay["w_off"][l] + lay["kp"][l] * lay["np"][l]]
        got = _tma_box(tile, dims, box, coords)
        if kind == "fwd":
            nb = 33 if l == L - 1 else 32
            assert box == (64, nb, 2)
            want = _copy_fwd(tile, dims[1], coords[2] // 2, nb)
        else:
            ibn = 6 if l == 0 else 32
            assert box == (64, 2, ibn)
            want = _copy_rev(tile, dims[1], dims[2], coords[1] // 2, ibn)
        np.testing.assert_array_equal(got, want, err_msg=f"{kind} {l} {coords}")


@pytest.mark.parametrize("name", sorted(CFGS))
def test_fwd_ring_order_is_the_products(name):
    """The ring's stages are the K-steps of the forward's products in
    order: layers 0..L-1 forward over pad16(in_l)/16 steps, then layers
    L-2..0 reverse over pad16(out_l)/16 (none in the primal-only
    ablation); every box lies inside the map's K extent."""
    ws, lay = _layout(CFGS[name])
    L = len(ws)
    steps = sdf_core.fwd_steps(lay)
    want = []
    for l in range(L):
        want += [("fwd", l, t) for t in range(-(-ws[l].shape[0] // 16))]
    primal = list(want)
    for l in range(L - 2, -1, -1):
        want += [("rev", l, t) for t in range(-(-ws[l].shape[1] // 16))]
    got = [(k, l, (c[2] if k == "fwd" else c[1]) // 2) for k, l, c in steps]
    assert got == want
    only = sdf_core.fwd_steps(lay, primal_only=True)
    assert [(k, l, c[2] // 2) for k, l, c in only] == primal
    for kind, l, coords in steps:
        dims, _ = sdf_core.sweep_map(lay, l)
        k_axis = 2 if kind == "fwd" else 1
        assert coords[k_axis] + 2 <= dims[k_axis]


def test_fwd_ring_of_the_shipped_net():
    """The shipped net takes 257 stages a tile pair (131 forward: 3 + 8 x
    16 K-steps; 126 reverse: 7 x 16 + 14), each read by both tiles: 2.00
    MB of weight stages a pair, 1.03 GB over the 512 pairs of 65,536
    points (half what one stream a tile reads). No product is longer than
    the production ring (16 stages)."""
    _, lay = _layout(CFGS["shipped"])
    steps = sdf_core.fwd_steps(lay)
    assert sum(k == "fwd" for k, _, _ in steps) == 131
    assert sum(k == "rev" for k, _, _ in steps) == 126
    size = sum(int(np.prod(sdf_core.fwd_box(lay, k, l))) * 2
               for k, l, _ in steps)
    assert size == 257 * 8192 + 16 * 256 - 16 * (8192 - 1536)
    assert size * len(wg.pair_blocks(65536)) == 1_025_507_328
    nks = [lay["kp"][l] // 16 for l in range(len(lay["kp"]))]
    nks += [lay["np"][l] // 16 for l in range(len(lay["np"]) - 1)]
    assert max(nks) == wg.FWD_RING_DEPTH


def _ping_pong(nks, depth, handoff):
    """Simulate the forward's ring stage by stage: one producer loading
    the stages in order into ``depth`` slots, each refilled once both
    consumers freed it; two consumers walking the same product phases
    (K-steps ``nks``), taking turns: a consumer starts a phase once the
    other handed it the turn, after issuing step ``handoff(nk)`` of its
    own phase (consumer 0 goes first). -> True if both finish."""
    total = sum(nks)
    starts = np.cumsum([0] + list(nks))
    done = [0, 0]          # stages each consumer has freed (in order)
    passed = [0, 0]        # turns handed to each consumer
    loaded = 0
    while min(done) < total:
        moved = False
        while loaded < total and loaded - depth < min(done):
            loaded += 1        # the producer: slot free in both
            moved = True
        for c in (0, 1):
            if done[c] == total:
                continue
            ph = int(np.searchsorted(starts, done[c], side="right")) - 1
            t = done[c] - starts[ph]
            if t == 0 and passed[c] < ph + (c == 1):
                continue       # not its turn yet
            if done[c] >= loaded:
                continue       # the stage has not arrived
            done[c] += 1
            if t == handoff(nks[ph]):
                passed[1 - c] += 1
            moved = True
        if not moved:
            return False
    return True


@pytest.mark.parametrize("depth", _build.FWD_TUNE_DEPTHS)
def test_fwd_turns_never_deadlock(depth):
    """At every depth the tune library builds, the two tiles of a block
    finish the shipped net's 17 product phases with the kernel's hand-off
    (after min(nk, depth) K-steps); handing over only at a phase's end
    deadlocks a ring shallower than the longest phase (16 K-steps), which
    is why the production ring holds 16."""
    _, lay = _layout(CFGS["shipped"])
    L = len(lay["kp"])
    nks = [lay["kp"][l] // 16 for l in range(L)]
    nks += [lay["np"][l] // 16 for l in range(L - 2, -1, -1)]
    assert _ping_pong(nks, depth, lambda nk: wg.handoff(nk, depth))
    at_end = _ping_pong(nks, depth, lambda nk: nk - 1)
    assert at_end == (depth >= max(nks))


@pytest.mark.parametrize("n", [1, 37, 64, 65, 129, 517, 520, 1037, 65536])
def test_fwd_blocks_cover_every_point_once(n):
    """The forward runs one block a pair of 64-point tiles (2b, 2b + 1),
    ceil(tiles / 2) blocks; a block whose second tile would hold no point
    runs its first alone. The tiles' rows partition [0, n)."""
    blocks = wg.pair_blocks(n)
    tiles = -(-n // wg.TILE)
    assert len(blocks) == -(-tiles // 2)
    assert all(len(b) == 2 for b in blocks[:-1])
    assert len(blocks[-1]) == (1 if tiles % 2 else 2)
    rows = np.concatenate([np.arange(t * wg.TILE, min((t + 1) * wg.TILE, n))
                           for b in blocks for t in b])
    np.testing.assert_array_equal(rows, np.arange(n))


def test_fwd_shared_memory_budget():
    """The production ring (16 stages) and every tune depth fit the
    H100's 232,448 B of shared memory a block; a 17th stage would not."""
    assert wg.FWD_RING_DEPTH == max(_build.FWD_TUNE_DEPTHS) == 16
    for depth in _build.FWD_TUNE_DEPTHS:
        assert sdf_core.fwd_smem_bytes(depth) <= wg.SMEM_LIMIT
    assert sdf_core.fwd_smem_bytes(16) == 228_752
    assert sdf_core.fwd_smem_bytes(17) > wg.SMEM_LIMIT


def test_fwd_split_names():
    """The timing split's instances are named in the C enum's order, and
    another name is refused before anything launches."""
    assert sdf_core.FWD_SPLIT == ("full", "no_record", "no_epilogue",
                                  "k_loops_only", "products_only")
    cfg = CFGS["narrow"]
    ws, _ = _layout(cfg)
    n0 = dict(_build.launches)
    with pytest.raises(ValueError, match="split must be one of"):
        sdf_core.sdf_fwd_split("no_pe", cfg, torch.zeros(4, 3), ws,
                               [torch.zeros(w.shape[1]) for w in ws])
    assert _build.launches == n0


def test_fwd_tools_without_a_card(monkeypatch, capsys):
    """Without a CUDA device ``ablate_kernel --fwd_split`` and
    ``bench_sdf_fwd`` exit non-zero, naming it; ``bench_sdf_fwd --device
    cpu`` runs the plain forward at the shipped widths: equal to the plain
    version and to a second call, nothing launched, nothing timed, no
    card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((ablate_kernel.main, ["--fwd_split"]),
                       (bench_sdf_fwd.main, [])):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(argv)
    res = bench_sdf_fwd.main(["--device", "cpu", "--n", "70"])
    assert res["device"] == "cpu" and res["card"] is None
    assert res["n"] == 70 and res["dtype"] == "bf16"
    assert res["rel_err"] == 0.0 and res["bitwise_repeat"]
    assert len(res["digest"]) == 64
    assert res["launches"] == {} and res["fwd"] is None
    assert not res["packed_once"]
