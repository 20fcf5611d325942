"""The port's launch scripts (``rnb_tpu_torch/jobs/train_h100.sh`` and
``train_h100_multi.sh``) with ``--device cpu`` on a 3-view 32x32 sphere at
the test widths of tests/test_runner.py, run from a directory of their own
(the conf's paths and the launch log are that directory's), and the scaling
model (``rnb_tpu_torch.tools.predict_scaling``) against the JAX tool's
parameter count."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from rnb_tpu_torch.models import fields
from rnb_tpu_torch.tools import predict_scaling
from rnb_tpu_torch.tools.make_synthetic_case import write_case
from rnb_tpu_torch.tools.multinode_smoke import free_port
from rnb_tpu_torch.tools.run_e2e import result_lines
from test_runner import CONF_TMPL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS = os.path.join(ROOT, "rnb_tpu_torch", "jobs")
CASE = "sphere_launch"


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch")
    write_case(str(d / "data" / CASE), n_views=3, H=32, W=32, radius=0.4)
    with open(d / "t.conf", "w") as f:
        f.write(CONF_TMPL.format(
            exp_dir="./exp/CASE_NAME/t", data_dir="./data/CASE_NAME/",
            end_iter=12, warm_up_iter=6, save_freq=100, val_freq=100,
            val_mesh_freq=100, mask_weight=0.1, n_outside=0))
    return d


def _script(name, work, env=(), extra=(), timeout=150):
    """A launch script in ``work``, with this interpreter first on PATH."""
    e = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
             PATH=os.path.dirname(sys.executable) + os.pathsep + os.environ["PATH"],
             **dict(env))
    return subprocess.run(["bash", os.path.join(JOBS, name), CASE, "t.conf", *extra],
                          cwd=work, env=e, capture_output=True, text=True,
                          timeout=timeout)


def _steps(exp):
    with open(os.path.join(exp, "logs", "scalars.jsonl")) as f:
        return sorted(r["step"] for r in map(json.loads, f) if "Loss/loss" in r)


def test_one_card_script_maps_env_and_tees_its_log(work):
    env = {"N_ITERATIONS": "2", "WARM_UP_ITER": "1", "BATCH_SIZE": "32",
           "LEARNING_RATE": "1e-4"}
    proc = _script("train_h100.sh", work, env,
                   ["--device", "cpu", "--mesh_resolution", "16",
                    "--set", "general.base_exp_dir=./exp/one"])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert _steps(work / "exp" / "one") == [1, 2]
    flags = json.load(open(work / "exp" / "one" / "recording" / "flags.json"))
    assert flags["overrides"] == [
        "train.end_iter=2", "train.warm_up_iter=1", "train.batch_size=32",
        "train.learning_rate=1e-4", "general.base_exp_dir=./exp/one"]
    (log,) = os.listdir(work / "exp" / CASE / "logs_launch")
    assert log.startswith("train_") and log.endswith(".log")
    text = open(work / "exp" / CASE / "logs_launch" / log).read()
    assert "trained 2 steps" in text and result_lines(text)[0]["world"] == 1
    assert not os.path.exists(os.path.join(ROOT, "exp", CASE))


def test_multi_card_script_runs_two_ranks(work):
    env = {"N_ITERATIONS": "2", "NPROC_PER_NODE": "2",
           "MASTER_PORT": str(free_port())}
    proc = _script("train_h100_multi.sh", work, env,
                   ["--device", "cpu", "--mesh_resolution", "16",
                    "--set", "general.base_exp_dir=./exp/multi"])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = result_lines(proc.stdout)
    assert sorted((l["rank"], l["world"]) for l in lines) == [(0, 2), (1, 2)]
    assert lines[0]["params_sha256"] == lines[1]["params_sha256"]
    assert _steps(work / "exp" / "multi") == [1, 2]


def test_multi_card_script_without_a_card_exits(work):
    proc = _script("train_h100_multi.sh", work, timeout=60)
    assert proc.returncode != 0
    assert "no card on this host; set NPROC_PER_NODE" in proc.stderr


def test_scaling_model_counts_the_jax_tools_bytes():
    """The gradient all-reduce's payload equals the JAX tool's
    ``param_bytes()`` (its default SDF, colour and NeRF statics), net by net."""
    spec = importlib.util.spec_from_file_location(
        "jax_predict_scaling", os.path.join(ROOT, "tools", "predict_scaling.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    statics = fields.ModelStatics(sdf=fields.SDFConfig(),
                                  color=fields.RenderingConfig(),
                                  nerf=fields.NeRFConfig())
    assert predict_scaling.param_bytes(statics) == jax_tool.param_bytes()


def test_scaling_model_cli():
    out = predict_scaling.main(["--step_ms", "20"])
    assert out["grad_allreduce_bytes"] == out["param_bytes"]["total"] == 5129468
    one, two, four, eight = out["predicted"]
    assert one == {"n_cards": 1, "t_comm_ms": 0.0, "efficiency": 1.0}
    # 2(N-1)/N of the gradient's and the partial sums' bytes over 450 GB/s,
    # and two 20 µs latencies
    want = 2 * 7 / 8 * (5129468 + 40) / 4.5e11 * 1e3 + 2 * 0.02
    assert eight["t_comm_ms"] == pytest.approx(want, rel=1e-12)
    assert eight["efficiency"] == pytest.approx(20 / (20 + want), rel=1e-12)
    assert 1.0 > two["efficiency"] > four["efficiency"] > eight["efficiency"] > 0.99
    # a tenth of the bandwidth and ten times the latency cost every N > 1
    slow = predict_scaling.main(["--step_ms", "20", "--bw", "4.5e10",
                                 "--latency_us", "200"])
    assert slow["predicted"][0]["efficiency"] == 1.0
    assert all(s["efficiency"] < p["efficiency"] for s, p in
               zip(slow["predicted"][1:], out["predicted"][1:]))
    with pytest.raises(SystemExit):
        predict_scaling.main([])          # no step time, no model
