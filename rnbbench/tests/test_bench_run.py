"""A whole run of a cell on the CPU at a tiny size: the result line's
schema with tracing off and on, the refusals of ``python -m rnbbench.run``
(no card; the program not beside the benchmark), and no module of JAX or of
the JAX package loaded by anything the harness runs."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from rnbbench.tests.conftest import tiny
from rnbbench import harness
from rnbbench import run as runmod

ROOT = harness.ROOT
SEED = 2 ** 31 + 977


def test_result_line_schema_untraced():
    res = runmod.run_cell(tiny("wmask_rnb.mesh.r512"), SEED, 0.2, False,
                          torch.device("cpu"), log=lambda s: None)
    assert list(res)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert set(res["metrics"]) == {"mesh_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["check"]) == {"grid_gap", "vertex_gap"}
    assert all(set(c) == {"value", "limit"} for c in res["check"].values())
    json.dumps(res)


@pytest.fixture
def short_slices():
    drv = harness.driver("train")
    ring = drv.RING
    drv.RING = 8
    yield drv.RING
    drv.RING = ring


@pytest.mark.parametrize("name, host_metric", [("wmask_rnb.mesh.r512", "marching_cubes_s"),
                                               ("wmask_rnb.train.b4096", "train_mfu")])
def test_result_line_schema_traced(name, host_metric, short_slices):
    cell = tiny(name)
    res = runmod.run_cell(cell, SEED, 0.2, True, torch.device("cpu"), log=lambda s: None)
    assert list(res)[-1] == "check" and "breakdown" in res
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert host_metric in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    for key in ("device_ops", "idle_gaps"):
        assert len(res["breakdown"][key]) <= 10
    if cell.traffic["mode"] == "train":
        # one whole slice of the window's, traced from a slice's start
        assert res["attempted"] == short_slices


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "-m", "rnbbench.run", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


def test_no_card_no_result():
    out = _run(["--workload", "wmask_rnb.mesh.r512", "--seed", str(SEED),
                "--seconds", "1", "--trace", "0"], ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "rnbbench"), tmp_path / "rnbbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(["--workload", "wmask_rnb.mesh.r512", "--seed", str(SEED),
                "--seconds", "1", "--trace", "0"], str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""


NO_JAX = r"""
import sys, torch
sys.path[:0] = [{root!r}]
torch.set_num_threads(2)
from rnbbench.tests.conftest import tiny
from rnbbench import calibrate, harness, run
from rnbbench.reference import data, neus
spec = harness.load_json(harness.ROOT, "BENCHMARK.json")
for w in spec["workloads"]:
    cell = harness.load_cell(w["name"])
    harness.driver(cell.traffic["mode"])
    for m in cell.per_layer:
        harness.metric_reader(m["name"])
run.run_cell(tiny("wmask_rnb.mesh.r512"), 5, 0.1, True, torch.device("cpu"),
             log=lambda s: None)
print(run.loaded_forbidden())
"""

REF_ALONE = r"""
import sys
sys.path[:0] = [{root!r}]
from rnbbench.reference import data, neus
print(sorted(m for m in sys.modules if m.split(".")[0] in ("rnb_tpu_torch", "rnb_tpu", "jax")))
"""


def test_nothing_loads_jax_or_the_jax_package():
    code = NO_JAX.format(root=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", REF_ALONE.format(root=ROOT)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


@pytest.mark.card
def test_a_cell_on_the_card(cuda):
    res = runmod.run_cell(harness.load_cell("wmask_rnb.render.b4096"), SEED, 2.0,
                          False, cuda, log=lambda s: None)
    assert res["correct"] and res["device"]["platform"] == "gpu"
