"""The operand layout that the SDF core's tensor-core kernels read
(rnb_tpu_torch.ops.sdf_core: wg_layout, pack_weights, dw_gemm), on the CPU.

The kernels run only on the card (tests/test_torch_kernels.py); what the
wrapper builds for them is checked here: the padded bf16 weight image
(K padded to a multiple of 16: 39 -> 48 inputs, 217 -> 224 and 257 -> 272
outputs) and its offsets, the column where the skip input's e lands, the
dW scratch offsets and the dW product's split of the rows.
"""

import numpy as np
import pytest
import torch

from rnb_tpu_torch.models import fields
from rnb_tpu_torch.models.fields import round_to
from rnb_tpu_torch.ops import sdf_core

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
    splits, chunk = sdf_core.dw_gemm_splits(m, n, k)
    assert chunk % 64 == 0 and splits * chunk >= k > (splits - 1) * chunk
    blocks = -(-m // 128) * -(-n // 128) * splits
    assert blocks <= 2 * 132 + 4 * 3 or splits == 1


def test_dw_gemm_plain_on_the_cpu():
    """On CPU tensors dw_gemm is its plain version: a[:, :m]ᵀ b[:, :n]."""
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.normal(size=(70, 48)), dtype=torch.bfloat16)
    b = torch.tensor(rng.normal(size=(70, 272)), dtype=torch.bfloat16)
    got = sdf_core.dw_gemm(a, b, 39, 257)
    want = a.double()[:, :39].T @ b.double()[:, :257]
    assert got.shape == (39, 257) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)
