"""Guards of the PyTorch port: it never pulls in JAX, the JAX package, PIL
or OpenCV (the H100 machine has none of them), the offline scripts that
predate it run without them too, and chip_smoke.py refuses to run (non-zero exit, no result line) without a
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
from rnb_tpu_torch.preprocess import preprocess_cameras
from rnb_tpu_torch.tools import make_synthetic_case
from rnb_tpu_torch.train import runner
from rnb_tpu_torch.utils import bridge

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "rnb_tpu", "PIL", "cv2")


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
              "parallel.grid", "preprocess.preprocess_cameras",
              "tools.inspect_cameras", "tools.validate_precision",
              "tools.run_parity_matrix", "tools.run_parity_worldspace",
              "tools.run_e2e", "tools.multinode_smoke",
              "tools.predict_scaling", "tools.bench", "tools.bench_step",
              "tools.roofline", "tools.tune_kernel", "tools.bench_scaling",
              "tools.consolidate_parity", "tools.bench_dw",
              "tools.bench_sdf_bwd", "utils.trace"):
        assert f"rnb_tpu_torch.{m}" in mods, m
    code = ("import importlib, sys\n"
            f"for m in {['rnb_tpu_torch', *mods]!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {BLOCKED!r})\n"
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
    dataset.Dataset.from_conf, bridge.params_from_numpy, runner.Runner,
    preprocess_cameras.estimate_normalization,
    preprocess_cameras.refine_visual_hull, preprocess_cameras.get_normalization,
    make_synthetic_case.write_case],
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
    """--normalize runs the scene normalization on the card: without one
    the writer exits non-zero before it writes anything."""
    r = _run(["-m", "rnb_tpu_torch.tools.make_synthetic_case", "--out",
              str(tmp_path / "c"), "--normalize"], ROOT)
    assert r.returncode != 0 and "--normalize" in r.stderr
    assert not (tmp_path / "c").exists()


@pytest.mark.parametrize("argv", [
    ["-m", "rnb_tpu_torch.preprocess.preprocess_cameras", "--source_dir", "x"],
    ["-m", "rnb_tpu_torch.tools.validate_precision"],
], ids=["preprocess_cameras", "validate_precision"])
def test_offline_entry_points_need_cuda(argv):
    """The normalization and the precision check run on the card unless
    --device cpu is given: without one they exit non-zero."""
    r = _run(argv, ROOT)
    assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr
    assert "Preprocessing" not in r.stdout


@pytest.mark.parametrize("script", ["sdm2idr.py", "organize_data.py",
                                    "sfm_cameras_to_npz.py"])
def test_offline_scripts_run_without_jax_pil_cv2(script):
    """The L0 scripts before the port's normalization (SDM-UniPS output ->
    IDR layout, VisualSFM cameras -> cameras.npz) need numpy, scipy and the
    standard library only: their --help runs with jax, rnb_tpu, PIL and cv2
    refused by the import system."""
    code = ("import runpy, sys\n"
            "class Refuse:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            f"        if name.split('.')[0] in {BLOCKED!r}:\n"
            "            raise ImportError('refused: ' + name)\n"
            "sys.meta_path.insert(0, Refuse())\n"
            f"sys.argv = [{script!r}, '--help']\n"
            f"runpy.run_path({str(ROOT / 'preprocess' / script)!r}, "
            "run_name='__main__')\n")
    r = _run(["-c", code], ROOT)
    assert r.returncode == 0, r.stderr
    assert "usage" in r.stdout.lower(), r.stdout


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


def test_chip_smoke_holds_one_dw_launch_a_backward():
    """The smoke's launch checks hold each path to one grouped dW launch a
    bf16 backward: a count of one a layer (the design before the grouped
    kernel: 9 a SDF backward) fails."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.check_dw_launches({"sdf_core_bwd": 20, "sdf_dw_gemm": 20,
                             "albedo_bwd": 20, "albedo_dw_gemm": 20,
                             "nerf_fwd": 20}, "wmask")
    with pytest.raises(AssertionError, match="sdf_dw_gemm"):
        smoke.check_dw_launches({"sdf_core_bwd": 20, "sdf_dw_gemm": 180},
                                "per layer")
    with pytest.raises(AssertionError, match="nerf_dw_gemm"):
        smoke.check_dw_launches({"nerf_bwd": 20}, "no dW")
