"""The host-side pieces of the albedo net's and the background NeRF's
bf16 backward sweeps and forwards (``csrc/wg_sweep.cuh``), on the CPU,
each check one test with a case per net and pass (the backward's cases
named by the net, the forward's ``<net>_fwd``): the TMA boxes of the
weight ring against the K-step slices of the matrices the products
multiply, the ring's order against the products, the turns the two tiles
of a block take (simulated stage by stage at every depth the tune library
builds), the tiles the blocks cover, the shared memory, the backward's
operand rows' TMA stores against the A tile's core layout, the timing
splits' names, and the tools without a card.

The shipped nets at full width. A box is emulated in numpy as TMA loads it:
a box of (b0, b1, b2) elements at coordinates (c0, c1, c2) of a map of
dims (d0, d1, d2), dim 0 fastest, written to shared memory in that order,
elements past a dim read as zero.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rnb_tpu_torch.models import fields
from rnb_tpu_torch.ops import _build, albedo, nerf, wg
from rnb_tpu_torch.tools import ablate_kernel, bench_wg_bwd
from test_torch_sdf_fwd_sched import _ping_pong

torch.set_num_threads(1)

OPS = ("albedo", "nerf")
CASES = OPS + ("albedo_fwd", "nerf_fwd")   # the backward's, the forward's
CSRC = Path(__file__).resolve().parents[1] / "rnb_tpu_torch" / "csrc"
DEPTHS = {**_build.BWD_TUNE_DEPTHS,
          **{f"{op}_fwd": d for op, d in _build.WG_FWD_TUNE_DEPTHS.items()}}
PROD = {"albedo": wg.ALBEDO_BWD_RING_DEPTH, "nerf": wg.NERF_BWD_RING_DEPTH,
        "albedo_fwd": wg.ALBEDO_FWD_RING_DEPTH,
        "nerf_fwd": wg.NERF_FWD_RING_DEPTH}
MOD = {"albedo": albedo, "nerf": nerf}


def _split(case):
    """(the net's module, "fwd" or "bwd") of a case."""
    op, _, fwd = case.partition("_")
    return MOD[op], fwd or "bwd"


def _phases(case, lay):
    mod, pas = _split(case)
    return getattr(mod, f"{pas}_phases")(lay)


def _steps(case, lay):
    mod, pas = _split(case)
    return getattr(mod, f"{pas}_steps")(lay)


def _net(case):
    """(cfg, the image layers' matrices as the kernels multiply them, the
    layout at 0 rows) of the net of a case."""
    gen = torch.Generator().manual_seed(4)
    if case.startswith("albedo"):
        cfg = fields.RenderingConfig()
        ws = [fields.fold_weight_norm(l).detach()
              for l in fields.init_rendering_network(gen, cfg, "cpu")]
        return cfg, ws, albedo.wg_layout(ws)
    cfg = fields.NeRFConfig()
    ws, bs = nerf.flatten_params(fields.init_nerf(gen, cfg, device="cpu"))
    iw, _ = nerf.wg_weights(cfg, ws, bs)
    return cfg, iw, nerf.wg_layout(cfg, ws)


def _box(tile, dims, box, coords):
    """One TMA load of a 3-D box from ``tile`` (flat, dims innermost
    first), zeros past the dims; -> [b2, b1, b0]."""
    d0, d1, d2 = dims
    t = np.zeros((d2 + box[2], d1 + box[1], d0 + box[0]))
    t[:d2, :d1, :d0] = tile.reshape(d2, d1, d0)
    c0, c1, c2 = coords
    return t[c2:c2 + box[2], c1:c1 + box[1], c0:c0 + box[0]]


def _padded(w, rows, cols):
    out = np.zeros((rows, cols))
    out[:w.shape[0], :w.shape[1]] = w
    return out


@pytest.mark.parametrize("op", CASES)
def test_bwd_stage_boxes_are_the_products(op):
    """Every stage the ring loads holds the K-step of the matrix its
    product multiplies: a forward box {64, nb, 2} at (0, 0, 2t) is W[16t:16t
    + 16, :8nb] as 2 x nb cores (MN-major B), a reverse box {64, 2, ib} at
    (0, 2t, c2) is Wᵀ[16t:16t + 16, 8c2:8(c2 + ib)] as ib x 2 cores
    (K-major B); zeros past the layer; no box over a ring slot (the NeRF
    forward's slot holds the fused head's 34 output cores)."""
    _, ws, lay = _net(op)
    image = wg.pack_weights(ws, lay, torch.float32).numpy()
    steps = _steps(op, lay)
    slot = nerf.FWD_STAGE_BYTES if op == "nerf_fwd" else wg.STAGE_BYTES
    for kind, l, box, coords in steps:
        assert np.prod(box) * 2 <= slot
        kp, np_ = lay["kp"][l], lay["np"][l]
        tile = image[lay["w_off"][l]:lay["w_off"][l] + kp * np_]
        got = _box(tile, (64, np_ // 8, kp // 8), box, coords)
        W = _padded(ws[l].numpy(), kp + 512, np_ + 512)
        if kind == "fwd":
            t, nb = coords[2] // 2, box[1]
            # [kb][ob][r][c] = W[(2t + kb)·8 + r, ob·8 + c]
            want = W[16 * t:16 * t + 16, :8 * nb]
            got = got.reshape(2, nb, 8, 8).transpose(0, 2, 1, 3).reshape(16, 8 * nb)
        else:
            t, c2, ib = coords[1] // 2, coords[2], box[2]
            # [ib'][kb][r][c] = W[(c2 + ib')·8 + r, (2t + kb)·8 + c]
            want = W[8 * c2:8 * (c2 + ib), 16 * t:16 * t + 16].T
            got = got.reshape(ib, 2, 8, 8).transpose(1, 3, 0, 2).reshape(16, 8 * ib)
        np.testing.assert_array_equal(got, want, err_msg=f"{kind} {l} {coords}")


def _products(op, lay):
    """The products of the plain version's backward (or forward) in order,
    as (kind, image layer, N columns first, N columns last): the kernel's
    recompute and reverse sweep (or forward) written out from the
    algorithm."""
    L = len(lay["in_dims"])
    if op == "albedo_fwd":
        return [("fwd", l, 0, 256) for l in range(L - 1)] + [("fwd", L - 1, 0, 8)]
    if op == "nerf_fwd":
        D = L - 3
        return ([("fwd", l, 0, 256) for l in range(D)]
                # the feature block and the alpha column, from one box
                + [("fwd", D, 0, lay["np"][D]), ("fwd", D + 1, 0, 128),
                   ("fwd", D + 2, 0, 8)])
    if op == "albedo":
        E = (lay["in_dims"][0] - 256) // 2
        prods = [("fwd", l, 0, 256) for l in range(L - 1)]
        prods.append(("fwd", L - 1, 0, 8))          # the sigmoid head
        prods += [("rev", l, 0, 256) for l in range(L - 1, 0, -1)]
        # layer 0's reverse: every column from PE(n) on (pts gets none)
        prods += [("rev", 0, 272, 320), ("rev", 0, 16, 272)]
        assert 16 <= E
        return prods
    D = L - 3
    prods = [("fwd", l, 0, 256) for l in range(D)]
    prods.append(("fwd", D, 0, 256))                # the feature block
    prods.append(("fwd", D + 1, 0, 128))            # the views layer
    prods.append(("rev", D + 2, 0, 128))            # c_rgb W_rgbᵀ
    prods.append(("rev", D + 1, 0, 256))            # its feature rows
    prods += [("rev", l, 0, 256) for l in range(D, 0, -1)]   # the h rows
    return prods


@pytest.mark.parametrize("op", CASES)
def test_bwd_ring_order_is_the_products(op):
    """The ring's stages are the K-steps of the sweep's products in order,
    each product over pad16(K)/16 steps (K the layer's inputs forward, its
    outputs in reverse), its box covering exactly its N columns; every box
    lies inside the map's K extent."""
    _, ws, lay = _net(op)
    steps = _steps(op, lay)
    want = []
    for kind, l, n0, n1 in _products(op, lay):
        nk = (lay["kp"] if kind == "fwd" else lay["np"])[l] // 16
        want += [(kind, l, t, n0, n1) for t in range(nk)]
    got = []
    for kind, l, box, c in steps:
        if kind == "fwd":
            got.append((kind, l, c[2] // 2, 0, 8 * box[1]))
            assert c[2] + 2 <= lay["kp"][l] // 8
        else:
            got.append((kind, l, c[1] // 2, 8 * c[2], 8 * (c[2] + box[2])))
            assert c[1] + 2 <= lay["np"][l] // 8
    # an N = 8 head's product reads the first of its box's two cores
    head = {"albedo": len(ws) - 1, "albedo_fwd": len(ws) - 1,
            "nerf_fwd": len(ws) - 1}.get(op)
    got = [g if g[:2] != ("fwd", head) else g[:4] + (8,) for g in got]
    assert got == want


@pytest.mark.parametrize("op", CASES)
def test_bwd_turns_never_deadlock(op):
    """At every depth the tune library builds, the two tiles of a block
    finish the sweep's product phases with the kernel's hand-off (after
    min(nk, depth) K-steps, wg.handoff); handing over only at a phase's end
    deadlocks any ring shallower than the longest phase. The forwards take
    52 (albedo) and 166 (NeRF) stages a pair."""
    _, _, lay = _net(op)
    nks = wg.phase_nks(lay, _phases(op, lay))
    assert sum(nks) == len(_steps(op, lay))
    if op.endswith("_fwd"):
        assert sum(nks) == {"albedo_fwd": 52, "nerf_fwd": 166}[op]
    for depth in DEPTHS[op]:
        assert _ping_pong(nks, depth, lambda nk: wg.handoff(nk, depth)), depth
        assert _ping_pong(nks, depth, lambda nk: nk - 1) == (depth >= max(nks))


@pytest.mark.parametrize("op", CASES)
def test_bwd_blocks_cover_every_point_once(op):
    """One block a pair of 64-point tiles (2b, 2b + 1, wg.pair_blocks),
    ceil(tiles / 2) blocks; an odd tile count leaves the last block one
    tile. The tiles' rows partition [0, n) at the sweep's main-path count,
    its ragged one and one tile (the forwards: also the card tests' ragged
    parts)."""
    counts = {"albedo": (65536, 65573, 37), "nerf": (67584, 67617, 37),
              "albedo_fwd": (65536, 65573, 37, 129, 517, 520),
              "nerf_fwd": (67584, 67617, 37, 129, 517, 520)}
    for n in counts[op]:
        blocks = wg.pair_blocks(n)
        tiles = -(-n // wg.TILE)
        assert len(blocks) == -(-tiles // 2)
        assert all(len(b) == 2 for b in blocks[:-1])
        assert len(blocks[-1]) == (1 if tiles % 2 else 2)
        rows = np.concatenate([np.arange(t * wg.TILE, min((t + 1) * wg.TILE, n))
                               for b in blocks for t in b])
        np.testing.assert_array_equal(rows, np.arange(n))


@pytest.mark.parametrize("op", CASES)
def test_bwd_shared_memory_budget(op):
    """The production ring (the source's NB_RS / AB_RS, NF_RS / AF_RS of
    the forwards) is the deepest tune depth and the deepest that fits the
    H100's 232,448 B a block; every tune depth fits; the tile area is the
    source's, 1 KB aligned, and so are the slots behind the tiles."""
    (mod, pas), depth = _split(op), PROD[op]
    src = (CSRC / f"{op.split('_')[0]}.cu").read_text()
    macro = {"albedo": "AB_RS", "nerf": "NB_RS", "albedo_fwd": "AF_RS",
             "nerf_fwd": "NF_RS"}[op]
    assert int(re.search(rf"#define {macro} (\d+)", src).group(1)) == depth
    assert depth == max(DEPTHS[op])
    smem = getattr(mod, f"{pas}_smem_bytes")
    for d in DEPTHS[op]:
        assert smem(d) <= wg.SMEM_LIMIT
    assert smem(depth + 1) > wg.SMEM_LIMIT
    assert smem() == {"albedo": 231_696, "nerf": 227_504,
                      "albedo_fwd": 231_728, "nerf_fwd": 231_168}[op]
    tile = getattr(mod, f"{pas.upper()}_TILE_BYTES")
    assert tile % 1024 == 0   # the A tiles stay 1 KB aligned
    if op == "nerf_fwd":      # the fused head's 34 cores a slot, TMA's 128 B
        assert nerf.FWD_STAGE_BYTES == 8704 and 8704 % 128 == 0
        assert int(re.search(r"#define NF_STAGE (\d+)", src).group(1)) == 8704


def _swizzled_box(tile, off):
    """A TMA box {64, 64} read from shared memory at element ``off`` in the
    128-byte swizzle: box element (r, c) at off + 64r + 8((c / 8) ^ (r % 8))
    + c % 8. -> [64, 64]."""
    r, c = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    return tile[off + 64 * r + 8 * ((c >> 3) ^ (r & 7)) + (c & 7)]


@pytest.mark.parametrize("op", OPS)
def test_bwd_row_stores_map_the_tile(op):
    """The stores of one tile's operand rows (wg.store_boxes) write its
    swizzled K-major layout (wg.sidx) as row-major [n, ld] rows: block kc's
    8 KB at element 4096·kc is the box {64, 64} at (64kc, n0); the columns
    past ld and, at a ragged last tile, the rows past n are not written.
    Every A and B width of the sweep; every element of the tile is a
    distinct place (the layout is a permutation)."""
    _, _, lay = _net(op)
    rng = np.random.default_rng(0)
    p_, k_ = np.meshgrid(np.arange(64), np.arange(384), indexing="ij")
    where = np.vectorize(wg.sidx)(p_, k_)
    assert np.unique(where).size == where.size == where.max() + 1
    for ld in sorted(set(lay["kp"]) | set(lay["np"])):
        for n, n0 in ((67617, 67584), (37, 0), (256, 128)):
            m = rng.standard_normal((64, ld))
            tile = np.zeros(64 * 64 * -(-ld // 64))
            tile[where[:, :ld]] = m
            rows = np.full((n, ld), np.nan)
            boxes = wg.store_boxes(ld, n0)
            assert len(boxes) == -(-ld // 64)
            for off, (c0, r0) in boxes:
                part = _swizzled_box(tile, off)
                live, cols = min(64, n - r0), min(64, ld - c0)
                rows[r0:r0 + live, c0:c0 + cols] = part[:live, :cols]
            live = min(64, n - n0)
            np.testing.assert_array_equal(rows[n0:n0 + live], m[:live])
            assert np.isnan(rows[:n0]).all()


@pytest.mark.parametrize("op", CASES)
def test_bwd_split_names(op):
    """The timing split's names are the C enum's (WgSplit), in order; the
    forwards' are four of them (no rows to leave out); ``wg.bwd_tune`` /
    ``wg.fwd_tune`` refuses another name, a depth the tune library was not
    built for, and a call naming both or neither, before anything
    launches."""
    src = (CSRC / "wg_sweep.cuh").read_text()
    names = re.findall(r"WB_([A-Z_]+) = (\d)", src)
    assert [(n.lower(), int(i)) for n, i in names] == [
        (s, i) for i, s in enumerate(wg.WG_BWD_SPLIT)]
    assert wg.WG_FWD_SPLIT == ("full", "k_loops_only", "products_only",
                               "no_epilogue")
    mod, pas = _split(op)
    fn, tune = ((mod.bwd_sweep, wg.bwd_tune) if pas == "bwd"
                else (mod.fwd_wg, wg.fwd_tune))
    n0 = dict(_build.launches)
    args = [None] * 8
    bad = "no_record" if pas == "bwd" else "no_rows"
    with pytest.raises(ValueError, match="split must be one of"):
        tune(fn, *args, split=bad)
    with pytest.raises(ValueError, match="depth must be one of"):
        tune(fn, *args, depth=5)
    for kw in ({}, {"split": "full", "depth": 4}):
        with pytest.raises(ValueError, match="one of split and depth"):
            tune(fn, *args, **kw)
    assert _build.launches == n0


@pytest.mark.parametrize("op", CASES)
def test_bwd_tools_without_a_card(op, monkeypatch):
    """Without a CUDA device ``ablate_kernel --wg_bwd`` / ``--wg_fwd`` and
    ``bench_wg_bwd`` exit non-zero, naming it; ``bench_wg_bwd --device
    cpu`` (``--pass fwd`` for the forward) runs the plain backward or
    forward at the shipped widths: equal to the plain version and to a
    second call (also under ``--repeat``), nothing launched, nothing
    timed, no card."""
    net, _, fwd = op.partition("_")
    pas = fwd or "bwd"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((ablate_kernel.main, [f"--wg_{pas}", net]),
                       (bench_wg_bwd.main, ["--op", net, "--pass", pas])):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(argv)
    res = bench_wg_bwd.main(["--op", net, "--pass", pas, "--device", "cpu",
                             "--n", "40", "--repeat", "2"])
    assert res["device"] == "cpu" and res["card"] is None
    assert res["op"] == net and res["n"] == 40 and res["dtype"] == "bf16"
    assert res["pass"] == pas
    assert res["rel_err"] == 0.0 and res["bitwise_repeat"]
    assert len(res["digest"]) == 64
    assert res["launches"] == {} and res[pas] is None and res["sweep"] is None
    assert res["host_us"] is None
    assert res["repeat"] == {"calls": 2, "differ": 0, "past_tol": 0,
                             "max_rel_err": 0.0, "tol": 1e-2,
                             "tf32_seen": False}
