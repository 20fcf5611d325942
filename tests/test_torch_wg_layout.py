"""The operand layout that the tensor-core kernels read (rnb_tpu_torch.ops.wg
and the wg_layout / pack_weights of sdf_core, albedo and nerf), on the CPU.

The kernels run only on the card (tests/test_torch_kernels.py); what the
wrappers build for them is checked here: the padded bf16 weight image
(K padded to a multiple of 16: 39 -> 48 inputs, 217 -> 224 and 257 -> 272
outputs; albedo 310 -> 320; the NeRF's 84 -> 96 PE, 340 -> 352 skip input
held as [h, e], 283 -> 288 views input and fused [feature | alpha] head of
256 x 257 -> 272) and its offsets, the column where the skip input's e
lands, the dW scratch offsets, the grouped dW kernel's work list (tiles,
row splits), and the NeRF's image layers mapped back to its 12 layers.
"""

import numpy as np
import pytest
import torch

from rnb_tpu_torch.models import fields
from rnb_tpu_torch.models.fields import round_to
from rnb_tpu_torch.ops import _build, albedo, nerf, sdf_core, wg

torch.set_num_threads(1)

SHIPPED = fields.SDFConfig()
SMALL = fields.SDFConfig(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,),
                         multires=4)


def _weights(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = fields.init_sdf_network(gen, cfg, device="cpu")
    return [fields.fold_weight_norm(l).detach() for l in params]


def _unpack(image, lay):
    """Inverse of pack_weights: the padded [pad16(in), pad16(out)] tiles."""
    out = []
    for off, kp, np_ in zip(lay["w_off"], lay["kp"], lay["np"]):
        t = image[off:off + kp * np_].reshape(kp // 8, np_ // 8, 8, 8)
        out.append(t.permute(0, 2, 1, 3).reshape(kp, np_))
    return out


def test_shipped_net_layout():
    ws = _weights(SHIPPED)
    lay = sdf_core.wg_layout(SHIPPED, ws, n=1000)
    assert lay["in_dims"] == [39, 256, 256, 256, 256, 256, 256, 256, 256]
    assert lay["out_dims"] == [256, 256, 256, 217, 256, 256, 256, 256, 257]
    assert lay["kp"] == [48] + [256] * 8
    assert lay["np"] == [256, 256, 256, 224, 256, 256, 256, 256, 272]
    # the skip input [h(217), e(39)]·c16 is exactly 256 wide, e at column 217
    assert lay["skip"] == [0, 0, 0, 0, 1, 0, 0, 0, 0]
    assert lay["hd"][4] == 217 == lay["out_dims"][3]
    assert lay["hd"][4] + lay["in_dims"][0] == lay["in_dims"][4] == 256
    assert [h for l, h in enumerate(lay["hd"]) if l != 4] == \
        [i for l, i in enumerate(lay["in_dims"]) if l != 4]
    sizes = [k * n for k, n in zip(lay["kp"], lay["np"])]
    assert lay["w_off"] == list(np.cumsum([0] + sizes[:-1]))
    assert lay["w_len"] == sum(sizes)
    assert lay["a_off"][1] == 2 * 1000 * 48
    assert lay["bb_off"][1] == 2 * 1000 * 256
    assert lay["a_len"] == 2 * 1000 * sum(lay["kp"])
    assert lay["b_len"] == 2 * 1000 * sum(lay["np"])
    # every operand row and tile starts on a 16-byte boundary
    assert all(o % 8 == 0 for o in lay["w_off"] + lay["a_off"] + lay["bb_off"])


@pytest.mark.parametrize("cfg", [SHIPPED, SMALL], ids=["shipped", "small"])
def test_pack_unpack_gives_back_the_bf16_weights(cfg):
    ws = _weights(cfg, seed=1)
    lay = sdf_core.wg_layout(cfg, ws)
    image = sdf_core.pack_weights(ws, lay)
    assert image.dtype == torch.bfloat16 and image.numel() == lay["w_len"]
    tiles = _unpack(image, lay)
    for w, t, kp, np_ in zip(ws, tiles, lay["kp"], lay["np"]):
        i, o = w.shape
        assert t.shape == (kp, np_)
        assert torch.equal(t[:i, :o].float(), round_to(w, torch.bfloat16))
        assert not t[i:].any() and not t[:, o:].any()


def test_pack_weights_core_order():
    """W[i, o] of layer l sits at w_off + ((i/8)·pad16(out)/8 + o/8)·64 +
    (i%8)·8 + o%8: 8x8 cores of 128 bytes, 8 consecutive outputs a row."""
    ws = _weights(SHIPPED, seed=2)
    lay = sdf_core.wg_layout(SHIPPED, ws)
    image = sdf_core.pack_weights(ws, lay).float()
    rng = np.random.default_rng(0)
    for l in (0, 3, 4, 8):
        w16 = round_to(ws[l], torch.bfloat16)
        npc = lay["np"][l] // 8
        for i, o in zip(rng.integers(0, w16.shape[0], 50),
                        rng.integers(0, w16.shape[1], 50)):
            at = (lay["w_off"][l] + ((i // 8) * npc + o // 8) * 64
                  + (i % 8) * 8 + o % 8)
            assert image[at] == w16[i, o]
        # the seed of the forward's reverse sweep: column 0 of W_last
        i = np.arange(w16.shape[0])
        assert torch.equal(image[lay["w_off"][l] + (i // 8) * npc * 64
                                 + (i % 8) * 8], w16[:, 0])


def test_unsupported_shapes_raise():
    wide = fields.SDFConfig(d_hidden=512)
    with pytest.raises(ValueError):
        sdf_core._check_wg(sdf_core.wg_layout(wide, _weights(wide)))
    last_skip = fields.SDFConfig(n_layers=4, skip_in=(4,))
    with pytest.raises(ValueError):
        sdf_core._check_wg(sdf_core.wg_layout(last_skip, _weights(last_skip)))
    sdf_core._check_wg(sdf_core.wg_layout(SHIPPED, _weights(SHIPPED)))


@pytest.mark.parametrize("m,n,k", [(256, 256, 2 * 65536), (39, 257, 2 * 65573),
                                   (256, 217, 100), (39, 257, 7)])
def test_dw_gemm_splits_cover_the_rows(m, n, k):
    """One product's row splits: multiples of 64 rows that cover the k rows
    with no empty split, and at most one unit (tile x split) an SM of the
    132 that the work list is sized for."""
    splits, chunk = wg.dw_splits([(m, n)], k)
    assert chunk % 64 == 0 and splits * chunk >= k > (splits - 1) * chunk
    units = len(wg.dw_tiles(m, n)) * splits
    assert units <= wg.DW_SMS or splits == 1


def test_dw_gemm_plain_on_the_cpu():
    """On CPU tensors dw_gemm is its plain version: a[:, :m]ᵀ b[:, :n]."""
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.normal(size=(70, 48)), dtype=torch.bfloat16)
    b = torch.tensor(rng.normal(size=(70, 272)), dtype=torch.bfloat16)
    got = sdf_core.dw_gemm(a, b, 39, 257)
    want = a.double()[:, :39].T @ b.double()[:, :257]
    assert got.shape == (39, 257) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)


def test_sdf_core_keeps_the_shared_pieces():
    """The layout, the image and the dW product moved to ops/wg.py; the
    SDF core still exposes them under their names, its dW product counting
    under sdf_dw_gemm."""
    assert sdf_core.pack_weights is wg.pack_weights
    assert sdf_core.dw_gemm_plain is wg.dw_gemm_plain
    assert sdf_core.dw_gemm.keywords == {"counter": "sdf_dw_gemm"}
    assert "sdf_dw_gemm" in _build.launches
    lay = sdf_core.wg_layout(SHIPPED, _weights(SHIPPED), n=10)
    assert lay["a_off"][1] == 2 * 10 * 48 and lay["hd"][4] == 217


def _albedo_weights(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = fields.init_rendering_network(gen, cfg, device="cpu")
    return [fields.fold_weight_norm(l).detach() for l in params]


def test_albedo_layout_and_image():
    cfg = fields.RenderingConfig()
    ws = _albedo_weights(cfg)
    lay = albedo.wg_layout(ws, n=1000)
    assert lay["in_dims"] == [310, 256, 256] and lay["out_dims"] == [256, 256, 3]
    assert lay["kp"] == [320, 256, 256] and lay["np"] == [256, 256, 16]
    assert lay["w_off"] == [0, 320 * 256, 320 * 256 + 256 * 256]
    assert lay["a_off"] == [0, 1000 * 320, 1000 * 576]
    assert lay["bb_off"] == [0, 1000 * 256, 1000 * 512]
    assert (lay["a_len"], lay["b_len"]) == (1000 * 832, 1000 * 528)
    assert all(o % 8 == 0 for o in lay["w_off"] + lay["a_off"] + lay["bb_off"])
    albedo._check_wg(lay)
    tiles = _unpack(wg.pack_weights(ws, lay), lay)
    for w, t in zip(ws, tiles):
        assert torch.equal(t[:w.shape[0], :w.shape[1]].float(),
                           round_to(w, torch.bfloat16))
        assert not t[w.shape[0]:].any() and not t[:, w.shape[1]:].any()
    with pytest.raises(ValueError):
        wide = fields.RenderingConfig(d_hidden=512)
        albedo._check_wg(albedo.wg_layout(_albedo_weights(wide)))


NERF_SHIPPED = fields.NeRFConfig()
NERF_SMALL = fields.NeRFConfig(D=4, W=32, skips=(1,), multires=3,
                               multires_view=2)


def _nerf_weights(cfg, seed=0):
    ws, bs = nerf.flatten_params(fields.init_nerf(
        torch.Generator().manual_seed(seed), cfg, device="cpu"))
    return [w.detach() for w in ws], [b.detach() for b in bs]


def test_nerf_image_layers():
    """Shipped net: 11 image layers (8 trunk, the fused head, views, rgb);
    the skip layer's tile holds W_5's rows as [h; e], the head's tile is
    [W_f | W_a] padded to 256 x 272."""
    cfg = NERF_SHIPPED
    ws, bs = _nerf_weights(cfg, seed=3)
    lay = nerf.wg_layout(cfg, ws, n=100)
    assert lay["in_dims"] == [84, 256, 256, 256, 256, 340, 256, 256, 256, 283, 128]
    assert lay["out_dims"] == [256] * 8 + [257, 128, 3]
    assert lay["kp"] == [96, 256, 256, 256, 256, 352, 256, 256, 256, 288, 128]
    assert lay["np"] == [256] * 8 + [272, 128, 16]
    assert lay["skip"] == [0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0]
    assert (lay["E"], lay["of"]) == (84, 256)
    assert lay["a_off"][1] == 100 * 96 and lay["bb_off"][9] == 100 * 256 * 8 + 100 * 272
    assert lay["a_len"] == 100 * 2656 and lay["b_len"] == 100 * 2464
    assert all(o % 8 == 0 for o in lay["w_off"] + lay["a_off"] + lay["bb_off"])
    nerf._check_wg(cfg, lay)
    iw, ib = nerf.wg_weights(cfg, ws, bs)
    tiles = _unpack(wg.pack_weights(iw, lay), lay)
    D = cfg.D
    w5 = round_to(ws[5], torch.bfloat16)
    assert torch.equal(tiles[5][:256].float(), w5[84:])
    assert torch.equal(tiles[5][256:340].float(), w5[:84])
    assert not tiles[5][340:].any()
    head = tiles[D].float()
    assert head.shape == (256, 272)
    assert torch.equal(head[:, :256], round_to(ws[D + 1], torch.bfloat16))
    assert torch.equal(head[:, 256], round_to(ws[D], torch.bfloat16)[:, 0])
    assert not head[:, 257:].any()
    assert torch.equal(ib[D], torch.cat([bs[D + 1], bs[D]]))
    for other in (fields.NeRFConfig(W=512), NERF_SMALL):   # trunk 256 only
        with pytest.raises(ValueError):
            nerf._check_wg(other, nerf.wg_layout(other, _nerf_weights(other)[0]))


def _nerf_sweep_rows(cfg, pts, views, ws, bs, c_alpha, c_rgb, lay):
    """The bf16 sweep's output from the plain version's pieces: the A rows
    (layer inputs, a skip input held as [h, e]) and B rows (rounded
    pre-activation cotangents, the head's as [bar_feat | c_alpha]) of every
    image layer at the layout's offsets, and db in image order."""
    dt, D, n = torch.bfloat16, cfg.D, pts.shape[0]
    w16, pe16, pev16 = nerf._inputs(cfg, pts, views, ws, dt)
    xs, recs, h = [], [], pe16
    for i in range(D):
        xs.append(h)
        z = h @ w16[i] + bs[i]
        recs.append(z)
        h = round_to(torch.relu(z), dt)
        if i in cfg.skips:
            h = torch.cat([pe16, h], dim=-1)
    of = ws[D + 1].shape[1]
    h2 = torch.cat([round_to(h @ w16[D + 1] + bs[D + 1], dt), pev16], dim=-1)
    z_v = h2 @ w16[D + 2] + bs[D + 2]
    a_rows = [torch.cat([x[:, pe16.shape[1]:], x[:, :pe16.shape[1]]], dim=-1)
              if lay["skip"][i] else x for i, x in enumerate(xs)]
    a_rows += [h, h2, round_to(torch.relu(z_v), dt)]
    bar_zv = (round_to(c_rgb, dt) @ w16[D + 3].T) * (z_v > 0)
    bar_feat = (round_to(bar_zv, dt) @ w16[D + 2].T)[:, :of]
    bar_h = (round_to(bar_feat, dt) @ w16[D + 1].T
             + round_to(c_alpha, dt) @ w16[D].T)
    bars = [None] * D
    for i in range(D - 1, -1, -1):
        if i in cfg.skips:
            bar_h = bar_h[:, pe16.shape[1]:]
        bars[i] = bar_h * (recs[i] > 0)
        bar_h = round_to(bars[i], dt) @ w16[i].T
    b_rows = bars + [torch.cat([bar_feat, c_alpha], dim=-1), bar_zv, c_rgb]
    abuf = torch.zeros(lay["a_len"], dtype=dt)
    bbuf = torch.zeros(lay["b_len"], dtype=dt)
    for l, (x, bar) in enumerate(zip(a_rows, b_rows)):
        kp, np_ = lay["kp"][l], lay["np"][l]
        abuf[lay["a_off"][l]:lay["a_off"][l] + n * kp].view(n, kp)[:, :x.shape[1]] = x
        bbuf[lay["bb_off"][l]:lay["bb_off"][l] + n * np_].view(n, np_)[:, :bar.shape[1]] = bar
    return abuf, bbuf, [bar.sum(dim=0) for bar in b_rows]


@pytest.mark.parametrize("cfg", [NERF_SHIPPED, NERF_SMALL], ids=["shipped", "small"])
def test_nerf_image_dw_maps_back(cfg):
    """dW of every image layer by dw_gemm_plain over the layout's rows,
    mapped back by from_image (the skip layer's rows to [e; h], the fused
    head's dW split into dW_alpha and dW_feat), equals nerf_bwd_plain's dW
    and db of the 12 layers."""
    ws, bs = _nerf_weights(cfg, seed=4)
    rng = np.random.default_rng(5)
    n = 40
    x = rng.normal(size=(n, 3))
    pts = torch.tensor(np.concatenate(
        [x / np.linalg.norm(x, axis=-1, keepdims=True),
         rng.uniform(0.1, 1.0, (n, 1))], axis=-1), dtype=torch.float32)
    v = rng.normal(size=(n, 3))
    views = torch.tensor(v / np.linalg.norm(v, axis=-1, keepdims=True),
                         dtype=torch.float32)
    ca = torch.tensor(rng.normal(size=(n, 1)), dtype=torch.float32)
    cr = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    lay = nerf.wg_layout(cfg, ws, n)
    abuf, bbuf, dbs = _nerf_sweep_rows(cfg, pts, views, ws, bs, ca, cr, lay)
    dws = wg.dw_products(abuf, bbuf, lay, n, "nerf_dw_gemm")
    got_w, got_b = nerf.from_image(cfg, dws, dbs, lay["E"], lay["of"])
    want_w, want_b = nerf.nerf_bwd_plain(cfg, pts, views, ws, bs, ca, cr,
                                         torch.bfloat16)
    for g, w in zip(got_w + got_b, want_w + want_b):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def _shipped_shapes(which):
    """[(in, out)] a layer of the dW products of a shipped backward."""
    if which == "sdf":
        lay = sdf_core.wg_layout(SHIPPED, _weights(SHIPPED))
    elif which == "albedo":
        lay = albedo.wg_layout(_albedo_weights(fields.RenderingConfig()))
    else:
        lay = nerf.wg_layout(NERF_SHIPPED, _nerf_weights(NERF_SHIPPED)[0])
    return list(zip(lay["in_dims"], lay["out_dims"]))


@pytest.mark.parametrize("rows", [2 * 65536, 67584, 2 * 65573, 1037, 7])
@pytest.mark.parametrize("which", ["sdf", "albedo", "nerf"])
def test_dw_work_covers_every_element_once(which, rows):
    """The grouped dW kernel's work list: every (layer, i, j, split) of the
    shipped layouts lies in exactly one unit, at the main path's rows and
    ragged ones; the splits cover the rows; tiles are 128 rows by 256, 128
    or 64 columns, the narrow ones only at a layer's last columns."""
    shapes = _shipped_shapes(which)
    units, splits, chunk = wg.dw_work(shapes, rows)
    assert chunk % wg.DW_ROWS == 0
    assert splits * chunk >= rows > (splits - 1) * chunk
    seen = [np.zeros((splits, -(-m // 128) * 128, -(-n // 64) * 64 + 256),
                     dtype=np.int32) for m, n in shapes]
    for l, m0, n0, bn, s in units:
        assert m0 % 128 == 0 and bn in (64, 128, 256) and n0 % 64 == 0
        assert bn == 256 or n0 + bn >= shapes[l][1]
        seen[l][s, m0:m0 + 128, n0:n0 + bn] += 1
    for (m, n), cover in zip(shapes, seen):
        assert (cover[:, :m, :n] == 1).all()
    # the m-tiles of one layer's split are neighbours in the list
    keys = [(l, s, n0) for l, _, n0, _, s in units]
    runs = [k for i, k in enumerate(keys) if i == 0 or keys[i - 1] != k]
    assert len(runs) == len(set(runs))


@pytest.mark.parametrize("which,splits,units", [("sdf", 6, 114),
                                                ("albedo", 18, 126),
                                                ("nerf", 5, 120)])
def test_dw_split_count_is_a_function_of_the_shapes(which, splits, units):
    """The split count at the main path's rows (2·65,536 for the SDF core,
    65,536 albedo, 67,584 NeRF): about one unit an SM of 132, the same in
    every call; a ragged row count within a 64-row stage of it keeps it."""
    shapes = _shipped_shapes(which)
    rows = {"sdf": 2 * 65536, "albedo": 65536, "nerf": 67584}[which]
    got = wg.dw_work(shapes, rows)
    assert (got[1], len(got[0])) == (splits, units)
    assert wg.dw_work(list(shapes), rows) == got
    assert wg.dw_splits(shapes, rows - 37)[0] == splits
