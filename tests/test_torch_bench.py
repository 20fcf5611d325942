"""The port's measuring tools on the CPU: their counts and control flow, no
times (a CPU time is no device metric).

  * rnb_tpu_torch.tools.bench.analytic_step_flops against the root
    bench.py's on the same weights (carried across by
    bridge.params_from_numpy): equal at the wmask conf, and above it by
    exactly the background NeRF's passes at n_outside = 4;
  * the peak table refuses a card it does not know;
  * every timing tool exits non-zero without a CUDA device (bench_step also
    with RNB_SWEEP_REMAT=1), and bench and roofline with --device cpu print
    their whole JSON line, marked "cpu", with no peak share;
  * the dW products' split count on the plain path, its chunk rounding,
    and the tile sweep's split axis;
  * the tile sweep never times an instance that failed;
  * consolidate_parity's rows from hand-written records;
  * bench_scaling --device cpu at widths 1 and 2 over gloo.
"""

import importlib.util
import json
import math
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rnb_tpu.models import fields as jfields
from rnb_tpu_torch.ops import _build, wg
from rnb_tpu_torch.tools import (bench, bench_dw, bench_scaling, bench_sdf_bwd,
                                 bench_step,
                                 consolidate_parity, roofline, tune_kernel)
from rnb_tpu_torch.utils import bridge

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench as jax_bench  # noqa: E402  (the root tool, JAX)

TINY_CONF = """
train {
    learning_rate = 5e-4, learning_rate_alpha = 0.05, end_iter = 1000,
    warm_up_iter = 500, batch_size = 64, warm_up_end = 5, anneal_end = 0,
    igr_weight = 0.1, mask_weight = 0.1,
}
model {
    nerf { D = 2, d_in = 4, d_in_view = 3, W = 32, multires = 4,
           multires_view = 2, output_ch = 4, skips = [0], use_viewdirs = True }
    sdf_network { d_out = 17, d_in = 3, d_hidden = 16, n_layers = 3,
                  skip_in = [2], multires = 2, bias = 0.5, scale = 1.0,
                  geometric_init = True, weight_norm = True }
    variance_network { init_val = 0.3 }
    rendering_network { d_feature = 16, mode = no_view_dir, d_in = 6,
                        d_out = 3, d_hidden = 16, n_layers = 2,
                        weight_norm = True, multires_view = 2,
                        squeeze_out = True }
    neus_renderer { n_samples = 8, n_importance = 8, n_outside = 0,
                    up_sample_steps = 2, perturb = 1.0 }
}
"""


@pytest.fixture
def tiny_conf(tmp_path):
    path = tmp_path / "tiny.conf"
    path.write_text(TINY_CONF)
    return str(path)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the exit without a CUDA device")


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


# the background NeRF's pass at the shipped widths, by hand: an 84-wide PE,
# 8x256 trunk with a 340-wide skip input after layer 4, the 256-wide feature
# and 1-wide alpha heads, the 283 -> 128 views layer, the 128 -> 3 rgb head
NERF_PASS = 2 * (84 * 256 + 6 * 256 * 256 + 340 * 256 + 256 * 256 + 256
                 + 283 * 128 + 128 * 3)


@pytest.mark.parametrize("bsz,n_outside", [(512, 0), (2048, 0), (512, 4)],
                         ids=["wmask-512", "wmask-2048", "n_outside4-512"])
def test_analytic_flops_against_jax(bsz, n_outside):
    """The port's FLOP count on the JAX package's weights: equal to the root
    tool's at the wmask conf; with n_outside = 4 above it by exactly the
    NeRF's 4 executed / 3 model passes at bsz·(128 + 4) points."""
    from rnb_tpu.config import load_conf as jload_conf
    from rnb_tpu.models.renderer import renderer_conf as jrenderer_conf

    sets = [f"model.neus_renderer.n_outside={n_outside}"]
    statics, rcfg, _ = bench.load(str(ROOT / "confs/wmask_rnb.conf"), sets,
                                  batch=bsz)
    jconf = jload_conf(str(ROOT / "confs/wmask_rnb.conf"))
    jstatics = jfields.statics_from_conf(jconf["model"])
    jrcfg = jrenderer_conf(jconf["model"])
    jparams = jfields.init_model_bundle(jax.random.PRNGKey(0), jstatics)
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    assert rcfg.n_outside == n_outside

    got = bench.analytic_step_flops(params, statics, rcfg, bsz)
    want = jax_bench.analytic_step_flops(jparams, jstatics, jrcfg, bsz)
    n_bg = bsz * (128 + n_outside) if n_outside else 0
    assert got["executed"] == want["executed"] + n_bg * 4 * NERF_PASS
    assert got["model"] == want["model"] + n_bg * 3 * NERF_PASS
    # the pass counted from the port's own NeRF weights is the hand count
    nerf = params["nerf"]
    assert sum(2 * math.prod(l["w"].shape) for l in
               [*nerf["pts_layers"], nerf["alpha_layer"], nerf["feature_layer"],
                nerf["views_layer"], nerf["rgb_layer"]]) == NERF_PASS


def test_peak_table_refuses_an_unknown_card():
    assert bench.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(SystemExit, match="NVIDIA A100"):
        bench.peak_bf16_flops("NVIDIA A100-SXM4-80GB")


@pytest.mark.parametrize("tool", [bench, bench_step, roofline, tune_kernel,
                                  bench_scaling, bench_dw, bench_sdf_bwd],
                         ids=lambda t: t.__name__.split(".")[-1])
def test_tools_need_cuda(no_cuda, tool):
    """Without a CUDA device each timing tool exits non-zero, naming it,
    unless asked for the CPU; it never carries on there."""
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main([])


def test_bench_step_sweeps_remat_on_the_card_only(no_cuda, monkeypatch):
    """The JAX tool's default remat sweep is the port's too: without a
    card it exits on the missing device, not on the knob."""
    monkeypatch.setenv("RNB_SWEEP_REMAT", "0,1")
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench_step.main([])


BENCH_FIELDS = ("metric", "value", "unit", "vs_baseline",
                "warmup_phase_rays_per_s_per_chip",
                "view_shard_rays_per_s_per_chip", "mfu", "batch_curve",
                "flags", "n_devices", "card", "peak_mem_gb", "turns")
MFU_FIELDS = ("step_ms", "analytic_flops_executed_per_chip",
              "mfu_executed_pct", "mfu_model_pct", "flops_ideal_ms",
              "pct_of_flops_ideal")
REGIONS = ("step_main", "step_warm", "core_fwd", "core_fwd_bwd",
           "upsample_render_fwd", "color_fwd", "adam", "data_sample",
           "residual", "env")


def test_bench_cpu_line(tiny_conf, monkeypatch, capsys):
    """--device cpu runs every row at a tiny size and prints the root tool's
    fields, marked "cpu", with no MFU share and no card."""
    monkeypatch.setenv("RNB_BENCH_ITERS", "2")
    monkeypatch.setattr(bench, "CURVE_BATCHES", (128,))
    res = bench.main(["--conf", tiny_conf, "--device", "cpu"])
    line = _last_json(capsys.readouterr().out)
    assert line == json.loads(json.dumps(res))
    for k in BENCH_FIELDS:
        assert k in line, k
    for k in MFU_FIELDS:
        assert k in line["mfu"], k
    assert line["metric"] == "train_rays_per_s_per_chip"
    assert line["device"] == "cpu" and line["card"] is None
    assert line["mfu"]["mfu_executed_pct"] is None
    assert line["mfu"]["pct_of_flops_ideal"] is None
    assert line["mfu"]["analytic_flops_executed_per_chip"] > 0
    assert [r["batch"] for r in line["batch_curve"]] == [128]
    for row in ("main", "warmup", "view_shard"):
        t = line["turns"][row]
        assert len(t["turns"]) == 3 and t["min"] <= t["median"] <= t["max"]
        assert math.isfinite(t["loss"])
    assert line["value"] == line["turns"]["main"]["median"] > 0


def test_bench_sdf_bwd_cpu_line(capsys):
    """--device cpu runs the SDF core's backward on its plain path at the
    shipped widths: equal to the plain version and to a second call,
    nothing launched, nothing timed, no card."""
    res = bench_sdf_bwd.main(["--device", "cpu", "--n", "70"])
    line = _last_json(capsys.readouterr().out)
    assert line == json.loads(json.dumps(res))
    assert line["device"] == "cpu" and line["card"] is None
    assert line["n"] == 70 and line["dtype"] == "bf16"
    assert line["rel_err"] == 0.0 and line["bitwise_repeat"]
    assert len(line["digest"]) == 64
    assert line["launches"] == {}
    assert line["bwd"] is None and line["sweep"] is None


def test_roofline_cpu_line(capsys):
    """--device cpu times every region of the shipped conf at batch 64 and
    prints the residual, the analytic FLOPs, "bytes": "not counted" and no
    peak share."""
    res = roofline.main(["--device", "cpu", "--iters", "1", "--batch", "64"])
    line = _last_json(capsys.readouterr().out)
    assert line == json.loads(json.dumps(res))
    for k in REGIONS:
        assert k in line, k
    for k in REGIONS[:-2]:
        assert line[k]["min"] <= line[k]["ms"] <= line[k]["max"], k
    main = line["step_main"]
    assert main["bytes"] == "not counted" and main["pct_bf16_peak"] is None
    assert main["analytic_flops_executed"] > 0
    assert line["env"]["device"] == "cpu" and line["env"]["card"] is None
    assert line["env"]["tile"] == 64
    assert line["env"]["ring_depth"] == {"albedo_fwd": 18, "nerf_fwd": 15,
                                         "albedo_bwd": 16, "nerf_bwd": 10}
    acc = line["residual"]["accounted_ms"]
    assert line["residual"]["ms"] == pytest.approx(main["ms"] - acc)


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_dw_gemm_splits_on_the_plain_path(splits):
    """On the CPU dw_gemm and dw_products run their plain products whatever
    the split count, equal to the default's and launching nothing; on the
    card the count sets the grouped kernel's chunk, rounded up to 64 rows,
    so the splits cover every row and never exceed the count asked for.
    The tile sweep's default axis is the production count, its half and
    double, and 1."""
    gen = torch.Generator().manual_seed(4)
    a = torch.randn(1037, 48, generator=gen).to(torch.bfloat16)
    b = torch.randn(1037, 272, generator=gen).to(torch.bfloat16)
    before = dict(_build.launches)
    got = wg.dw_gemm(a, b, 39, 257, counter="sdf_dw_gemm", splits=splits)
    assert torch.equal(got, wg.dw_gemm(a, b, 39, 257, counter="sdf_dw_gemm"))
    lay = wg.offsets([39, 256], [256, 257], 1037)
    abuf = torch.randn(lay["a_len"], generator=gen).to(torch.bfloat16)
    bbuf = torch.randn(lay["b_len"], generator=gen).to(torch.bfloat16)
    got = wg.dw_products(abuf, bbuf, lay, 1037, "sdf_dw_gemm", splits=splits)
    want = wg.dw_products(abuf, bbuf, lay, 1037, "sdf_dw_gemm")
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert _build.launches == before
    shapes = [(39, 256), (256, 256), (256, 257)]
    for k in (1037, 131072):
        eff, chunk = wg.dw_splits(shapes, k, splits)
        assert chunk % wg.DW_ROWS == 0 and eff <= splits
        assert eff * chunk >= k > (eff - 1) * chunk
    assert wg.dw_splits([(256, 256)], 131072) == (64, 2048)
    assert tune_kernel.split_axis(6) == [6, 3, 12, 1]


def test_tune_never_times_a_failed_instance(monkeypatch):
    """An instance that raises or misses the plain version is a failed row
    with its error and no time; only a passing one is timed."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(tune_kernel, "cuda_ms", lambda fn, iters, warm: 1.5)
    want = [torch.ones(4)]

    def broken():
        raise RuntimeError("rnb_sdf_fwd_wg_tune: CUDA error 1 (invalid argument)")

    rows = [tune_kernel.checked_row({"rs": 7}, broken, want, 3),
            tune_kernel.checked_row({"rs": 3}, lambda: [torch.ones(4) * 1.1],
                                    want, 3),
            tune_kernel.checked_row({"rs": 4}, lambda: [torch.ones(4)], want,
                                    3, production=[torch.ones(4) * 1.001]),
            tune_kernel.checked_row({"rs": 5}, lambda: [torch.ones(4)], want, 3)]
    assert [r["ok"] for r in rows] == [False, False, False, True]
    assert "CUDA error" in rows[0]["error"] and "rel err" in rows[1]["error"]
    assert rows[2]["bitwise_equal_production"] is False
    assert [r.get("ms") for r in rows] == [None, None, None, 1.5]
    assert rows[3]["ms_min"] == rows[3]["ms_max"] == 1.5
    rows = [dict(r, axis="fwd") for r in rows]
    assert tune_kernel.fastest(rows, "fwd", "rs") == 5


def _matrix_row(chamfer, threshold):
    return {"chamfer_l1": chamfer, "threshold": threshold,
            "accepted": chamfer <= threshold,
            "failures": [] if chamfer <= threshold else ["chamfer"]}


def _torus_run(exp_dir):
    """A finished run's directory: the analytic torus as its mesh and a
    falling logged loss that crosses the 20k warm-up."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    os.makedirs(exp_dir / "meshes")
    os.makedirs(exp_dir / "logs")
    smoke._torus_ply(str(exp_dir / "meshes" / "00030000.ply"), (0, 0, 0),
                     n_u=200, n_v=80)
    with open(exp_dir / "logs" / "scalars.jsonl", "w") as f:
        for step in range(500, 30001, 500):
            f.write(json.dumps({"step": step, "Loss/loss": 1.0 / step}) + "\n")


def test_consolidate_parity_rows(tmp_path, monkeypatch, capsys):
    """Records give pass and fail rows with their thresholds, cards and the
    JAX numbers; a gate with no record and no run is a missing row, which
    never counts as a pass; a run without a record is re-gated."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("exp")
    with open("exp/parity_matrix.json", "w") as f:
        json.dump({"card": "NVIDIA H100 80GB HBM3, 700.00 W", "variants": {
            "wmask_rnb": _matrix_row(0.0015, 0.004),
            "womask_rnb": _matrix_row(0.0091, 0.008),
            "wmask_rnb_noalbedo": _matrix_row(0.0016, 0.004)}}, f)
    with open("exp/e2e.json", "w") as f:
        json.dump({"card": "cpu", "accepted": True, "chamfer_l1": 0.0113,
                   "failures": [], "acceptance": {"threshold": 0.02}}, f)
    _torus_run(tmp_path / "exp" / "torus_ns" / "wmask_rnb")
    out = consolidate_parity.main(["--out", "exp/merged.json"])
    line = _last_json(capsys.readouterr().out)
    assert line == out == json.load(open("exp/merged.json"))
    rows = {r["gate"]: r for r in out["gates"]}
    assert {g: r["status"] for g, r in rows.items()} == {
        "wmask": "pass", "womask": "fail", "wmask_noalbedo": "pass",
        "womask_noalbedo": "missing", "worldspace": "fail", "e2e": "pass"}
    assert out["missing"] == ["womask_noalbedo"] and not out["all_accepted"]
    assert rows["womask"]["threshold"] == 0.008
    assert rows["womask"]["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert rows["e2e"]["threshold"] == 0.02 and rows["e2e"]["card"] == "cpu"
    assert rows["womask_noalbedo"]["chamfer_l1"] is None
    assert {g: r["jax_chamfer_l1"] for g, r in rows.items()} == {
        "wmask": 0.001514, "womask": 0.001624, "wmask_noalbedo": 0.001461,
        "womask_noalbedo": 0.002046, "worldspace": 0.001725, "e2e": 0.001339}
    # the world-space run holds a torus at the origin, not at the gate's
    # centre: re-gated, it fails by its Chamfer distance
    ws = rows["worldspace"]
    assert ws["source"].startswith("re-gated") and ws["chamfer_l1"] > 0.004


def test_bench_scaling_cpu_widths(monkeypatch, capsys):
    """--device cpu launches widths 1 and 2 of the shipped conf over gloo
    with torchrun: finite losses, the global batch growing with the width
    (weak), and no efficiency figure."""
    monkeypatch.setenv("RNB_SCALING_BATCH", "64")
    monkeypatch.setenv("RNB_SCALING_ITERS", "2")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = bench_scaling.main(["--device", "cpu"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert [r["n_devices"] for r in out["rows"]] == [1, 2]
    assert [r["global_batch"] for r in out["rows"]] == [64, 128]
    for r in out["rows"]:
        assert math.isfinite(r["loss"]) and r["backend"] == "gloo"
        assert r["device"] == "cpu" and r["card"] is None
    assert out["scaling_efficiency_vs_1dev"] is None
    assert lines[-1]["scaling_efficiency_vs_1dev"] is None
    assert "semantics only" in lines[-1]["note"]
