"""Guards of the PyTorch port: it never pulls in JAX or the JAX package, and
chip_smoke.py refuses to run (non-zero exit, no result line) without a
CUDA device or without the package beside it, as the kernel-ablation tool
(rnb_tpu_torch.tools.ablate_kernel) does without a CUDA device."""

import importlib.util
import inspect
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import rnb_tpu_torch
from rnb_tpu_torch.data import dataset
from rnb_tpu_torch.models import fields
from rnb_tpu_torch.ops import nerf
from rnb_tpu_torch.train import runner
from rnb_tpu_torch.utils import bridge

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _run(args, cwd, timeout=120):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(cwd))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_no_jax():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        rnb_tpu_torch.__path__, prefix="rnb_tpu_torch."))
    for m in ("ops.sdf_core", "ops.nerf", "ops.sdf_ablate", "train.step",
              "tools.ablate_kernel", "train.runner", "cli", "utils.io",
              "utils.checkpoint", "utils.logging", "ops.marching_cubes",
              "tools.acceptance", "tools.eval_chamfer",
              "tools.make_synthetic_case", "tools.compare_images",
              "parallel.mesh", "parallel.data", "parallel.train",
              "parallel.grid"):
        assert f"rnb_tpu_torch.{m}" in mods, m
    code = ("import importlib, sys\n"
            f"for m in {['rnb_tpu_torch', *mods]!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'rnb_tpu' or m.startswith('rnb_tpu.'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    r = _run(["-c", code], ROOT)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr


def test_port_uses_no_ddp():
    """The parallel path all-reduces partial sums before it normalizes the
    loss; DDP's averaging of per-rank normalized losses is another gradient
    (rnb_tpu_torch/parallel/train.py)."""
    for path in Path(rnb_tpu_torch.__path__[0]).rglob("*.py"):
        assert "DistributedDataParallel" not in path.read_text(), path


@pytest.mark.parametrize("fn", [
    fields.init_sdf_network, fields.init_rendering_network, fields.init_nerf,
    fields.init_variance, fields.init_model_bundle, dataset.Dataset,
    dataset.make_torus_scene, dataset.make_sphere_scene,
    dataset.Dataset.from_conf, bridge.params_from_numpy, runner.Runner],
    ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    """The public constructors run on the card unless the caller asks for
    the CPU (the CPU tests pass device="cpu")."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cli_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    """Without a card the CLI exits non-zero before it reads anything; with
    --device cpu the same command gets past that point (and here stops at
    the missing conf file instead)."""
    conf = str(tmp_path / "missing.conf")
    r = _run(["-m", "rnb_tpu_torch.cli", "--conf", conf], ROOT)
    assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr
    r = _run(["-m", "rnb_tpu_torch.cli", "--conf", conf, "--device", "cpu"], ROOT)
    assert r.returncode != 0 and "no CUDA device" not in r.stderr
    assert "missing.conf" in r.stderr, r.stderr


@pytest.mark.parametrize("argv,needle", [
    (["--mode", "interpolate_0"], "write interpolate_<i>_<j>"),
    (["--shard", "2"], "--shard 2 asks for 2 rank(s), but this run has a "
                       "world size of 1"),
    (["--mode", "bogus"], "unknown mode 'bogus'"),
    (["--shard", "0"], "argument --shard: '0'"),
])
def test_cli_refuses_unported_modes_by_name(argv, needle):
    r = _run(["-m", "rnb_tpu_torch.cli", "--device", "cpu", *argv], ROOT)
    assert r.returncode != 0 and needle in r.stderr, r.stderr


@pytest.mark.parametrize("mode", ["validate_mesh_texture", "validate_image_ps",
                                  "interpolate_0_1"])
def test_cli_inference_modes_need_cuda(tmp_path, mode):
    """The inference modes run on the card too: without one they exit
    non-zero unless --device cpu is given."""
    r = _run(["-m", "rnb_tpu_torch.cli", "--mode", mode, "--conf",
              str(tmp_path / "missing.conf")], ROOT)
    assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr


def test_case_writer_refuses_normalize(tmp_path):
    r = _run(["-m", "rnb_tpu_torch.tools.make_synthetic_case", "--out",
              str(tmp_path / "c"), "--normalize"], ROOT)
    assert r.returncode != 0 and "--normalize" in r.stderr
    assert not (tmp_path / "c").exists()


def test_chip_smoke_fails_without_cuda():
    r = _run(["chip_smoke.py"], ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_ablate_kernel_fails_without_cuda():
    r = _run(["-m", "rnb_tpu_torch.tools.ablate_kernel", "--n", "64",
              "--iters", "1"], ROOT)
    assert r.returncode != 0
    assert "kernel_ms" not in r.stdout and "no CUDA device" in r.stderr


def test_chip_smoke_bounds_count_least_work():
    """The bound of each ReLU backward counts only the multiply-adds its
    function needs, at the shipped widths: NeRF forward without the alpha
    and rgb heads 603,520, reverse without layer 0 and the PE rows 557,696,
    dW 604,160; albedo forward 145,664, reverse with layer 0 over its
    PE(n) and feat rows only 138,752, dW 145,664."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    gen = torch.Generator().manual_seed(0)
    acfg, ncfg = fields.RenderingConfig(), fields.NeRFConfig()
    aw = [l["v"] for l in fields.init_rendering_network(gen, acfg, "cpu")]
    nw = nerf.flatten_params(fields.init_nerf(gen, ncfg, "cpu"))[0]
    assert smoke.albedo_bwd_macs(acfg, aw) == 145_664 + 138_752 + 145_664
    assert smoke.nerf_bwd_macs(ncfg, nw) == 603_520 + 557_696 + 604_160
