"""The operation and byte counts of every metric file against hand sums of
the shipped confs' widths (the SDF net's 8 hidden layers of 256 and its
257-wide head, a skip at 4 and PE 6: nine products; the 2x256 albedo net on
310 inputs; the 8x256 NeRF with PE 10 / 4 and a skip at 4). An op's count
holds each of its products once: a backward's recompute of the forward is
not the op's work."""

import math

import pytest

from rnbbench import counts, harness
from rnbbench.harness import LayerRecord, Trace

W1, W2 = "wmask_rnb.train.b4096", "womask_rnb_bg32.train.b4096"
W3, W4 = "wmask_rnb.render.b4096", "wmask_rnb.mesh.r512"

# hand sums, each layer in * out
SDF = [39 * 256, 256 * 256, 256 * 256, 256 * 217, 256 * 256, 256 * 256,
       256 * 256, 256 * 256, 256 * 257]
SDF_CHAIN = 524_544
SDF_FWD = SDF_CHAIN + (SDF_CHAIN - 256 * 257)                    # 983,296
SDF_REV = (2 * 256 * 256 + 256 * 217 + (256 - 39) * 256 + 3 * 256 * 256
           + 256 * 257)
# the tangent slab, both slabs back, dW over both (not the primal slab again)
SDF_BWD = (SDF_CHAIN - 256 * 257) + 2 * SDF_REV + 2 * SDF_CHAIN
SDF_ONLY = SDF_CHAIN - 256 * 257 + 256
ALB = 310 * 256 + 256 * 256 + 256 * 3                             # 145,664
NERF_TRUNK = 84 * 256 + 4 * 256 * 256 + 340 * 256 + 2 * 256 * 256
NERF = NERF_TRUNK + 256 * 1 + 256 * 256 + 283 * 128 + 128 * 3     # 604,160
# the reverse sweep and dW (not the trunk, feature and views layers again)
NERF_BWD = ((256 + 256 * 256 + 128 * 3 + 256 * 128 + 6 * 256 * 256
             + (340 - 84) * 256)
            + NERF)


def conf(name):
    return harness.load_cell(name).conf


def test_hand_sums_are_the_widths():
    assert sum(SDF) == SDF_CHAIN and ALB == 145_664 and NERF == 604_160
    assert SDF_FWD == 983_296 and SDF_BWD == 2_516_992 and NERF_BWD == 1_161_856
    # the op at its boundary, each product once
    assert SDF_FWD + SDF_BWD == 3_500_288 and NERF + NERF_BWD == 1_766_016


@pytest.mark.parametrize("fn, want", [
    (counts.sdf_fwd_macs, SDF_FWD), (counts.sdf_bwd_macs, SDF_BWD),
    (counts.sdf_only_macs, SDF_ONLY), (counts.albedo_macs, ALB),
    (counts.nerf_macs, NERF), (counts.nerf_bwd_macs, NERF_BWD)])
def test_macs_a_point(fn, want):
    assert fn(conf(W2)["model"]) == want


def test_step_and_ray_flops():
    c1, c2 = conf(W1), conf(W2)
    core, up = 4096 * 128, 4096 * (64 + 16 * 3)
    wm = core * (6 * 2 * SDF_CHAIN + 3 * 2 * ALB) + up * 2 * SDF_ONLY
    assert counts.step_model_flops(c1) == wm
    assert math.isclose(wm, 4.179e12, rel_tol=1e-3)
    assert counts.step_model_flops(c2) == wm + 4096 * 160 * 3 * 2 * NERF
    ray = (64 + 48) * 2 * SDF_ONLY + 128 * 2 * (SDF_FWD + ALB)
    assert counts.render_ray_flops(conf(W3)) == ray


def test_op_bytes():
    n = 1000
    params = sum(SDF) + 256 * 7 + 217 + 257
    fwd = n * 12 + params * 4 + n * 257 * 4 + n * 12
    assert counts.sdf_op_bytes(conf(W1)["model"], n, False) == fwd
    assert counts.sdf_op_bytes(conf(W1)["model"], n, True) == 2 * fwd + params * 4
    nparams = NERF + 256 * 8 + 1 + 256 + 128 + 3
    assert counts.nerf_op_bytes(conf(W2)["model"], n) == (
        2 * (n * 28 + n * 16) + 3 * nparams * 4)


def bound(metric):
    return harness.metric_reader(metric).BOUNDARY


def record(name, units, rays, window_s, busy_s=0.5, ops=None, spans=None):
    """A record of the cell ``name``; ``ops`` and ``spans`` by the metric
    whose boundary they belong to."""
    c = harness.load_cell(name)
    tr = Trace(window_s=window_s, busy_s=busy_s, by_kernel={},
               op_device_s={bound(m): v for m, v in (ops or {}).items()},
               idle_by_host={})
    return c, LayerRecord(cell=name, conf=c.conf, peak_flops=989e12,
                          peak_bytes=3.35e12, units=units, rays_per_unit=rays,
                          trace=tr, spans={bound(m).range: v
                                           for m, v in (spans or {}).items()})


def test_every_metric_reads_its_count():
    c, rec = record(W2, units=2, rays=4096, window_s=1.0,
                    ops={"sdf_core_roofline.train": 0.05, "nerf_roofline.train": 0.02,
                         "upsample_ms.train": 0.03})
    got = harness.read_metrics(c, rec)
    step = counts.step_model_flops(c.conf)
    assert got["train_mfu"]["value"] == pytest.approx(100 * 2 * step / 989e12)
    assert got["upsample_ms.train"]["value"] == pytest.approx(15.0)
    n = 2 * 4096 * 128
    least = max(2 * n * (SDF_FWD + SDF_BWD) / 989e12,
                counts.sdf_op_bytes(c.conf["model"], n, True) / 3.35e12)
    assert got["sdf_core_roofline.train"]["value"] == pytest.approx(100 * least / 0.05)
    m = 2 * 4096 * 160
    least = max(2 * m * (NERF + NERF_BWD) / 989e12,
                counts.nerf_op_bytes(c.conf["model"], m) / 3.35e12)
    assert got["nerf_roofline.train"]["value"] == pytest.approx(100 * least / 0.02)
    assert got["idle_pct.train"]["value"] == pytest.approx(50.0)

    c, rec = record(W3, units=3, rays=153 * 128, window_s=0.6,
                    ops={"sdf_core_roofline.render": 0.02, "upsample_ms.render": 0.3})
    got = harness.read_metrics(c, rec)
    assert got["render_mfu"]["value"] == pytest.approx(
        100 * 3 * 153 * 128 * counts.render_ray_flops(c.conf) / 0.6 / 989e12)
    n = 3 * 5 * 4096 * 128
    assert got["sdf_core_roofline.render"]["value"] == pytest.approx(
        100 * max(2 * n * SDF_FWD / 989e12,
                  counts.sdf_op_bytes(c.conf["model"], n, False) / 3.35e12) / 0.02)
    assert got["upsample_ms.render"]["value"] == pytest.approx(100.0)

    c, rec = record(W4, units=1, rays=512 ** 3, window_s=12.0,
                    spans={"marching_cubes_s": [1.0, 3.0]})
    got = harness.read_metrics(c, rec)
    assert got["mesh_mfu"]["value"] == pytest.approx(
        100 * 2 * SDF_ONLY * 512 ** 3 / 12.0 / 989e12)
    assert got["marching_cubes_s"]["value"] == pytest.approx(2.0)
    assert got["idle_pct.mesh"]["value"] == pytest.approx(100 * (1 - 0.5 / 12))


def test_a_reader_with_nothing_to_read_returns_nothing():
    c, rec = record(W1, units=1, rays=4096, window_s=1.0)
    said = []
    got = harness.read_metrics(c, rec, log=said.append)
    # no op device time in the trace: no roofline and no up-sampling time,
    # and the run names each on standard error
    assert "sdf_core_roofline.train" not in got and "upsample_ms.train" not in got
    assert any("sdf_core_roofline.train" in s for s in said)
    assert any("upsample_ms.train" in s for s in said)
    assert "nerf_roofline.train" not in got          # not a metric of this cell
    assert not any("nerf_roofline.train" in s for s in said)
