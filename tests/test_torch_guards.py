"""Guards of the PyTorch port: it never pulls in JAX or the JAX package, and
chip_smoke.py refuses to run (non-zero exit, no result line) without a
CUDA device or without the package beside it."""

import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import rnb_tpu_torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _run(args, cwd, timeout=120):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(cwd))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_no_jax():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        rnb_tpu_torch.__path__, prefix="rnb_tpu_torch."))
    assert "rnb_tpu_torch.ops.sdf_core" in mods and "rnb_tpu_torch.train.step" in mods
    code = ("import importlib, sys\n"
            f"for m in {['rnb_tpu_torch', *mods]!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'rnb_tpu' or m.startswith('rnb_tpu.'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    r = _run(["-c", code], ROOT)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr


def test_chip_smoke_fails_without_cuda():
    r = _run(["chip_smoke.py"], ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
