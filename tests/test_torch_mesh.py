"""Mesh extraction of the port against the JAX package's, on the CPU: the
chunked SDF grid query, the host marching cubes, ``Runner.validate_mesh``
on weights trained by the JAX runner, and the acceptance gate's Chamfer-L1.

Tolerances: the grid 2e-3 (both packages fetch float16 values); marching
cubes exact on one grid; validate_mesh the same faces and vertices within
1e-4; the two gates the same Chamfer-L1."""

import contextlib
import io as pyio
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from rnb_tpu import config as jconfig
from rnb_tpu.models import fields as jfields
from rnb_tpu.models import renderer as jrnd
from rnb_tpu.ops import marching_cubes as jmc
from rnb_tpu.train.runner import Runner as JRunner
from rnb_tpu_torch import config as tconfig
from rnb_tpu_torch.models import fields as tfields
from rnb_tpu_torch.models import renderer as trnd
from rnb_tpu_torch.ops import marching_cubes as tmc
from rnb_tpu_torch.tools import acceptance as tacc
from rnb_tpu_torch.train.runner import Runner as TRunner
from rnb_tpu_torch.utils import bridge
from test_runner import CONF_TMPL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import acceptance as jacc  # noqa: E402
import make_synthetic_case as jcase  # noqa: E402

torch.set_num_threads(1)
BMIN, BMAX = [-1.01, -1.01, -1.01], [1.01, 1.01, 1.01]


def _write_conf(tmp, data_dir, **kw):
    d = dict(exp_dir=str(tmp / "exp"), data_dir=data_dir, end_iter=2,
             warm_up_iter=1, save_freq=2, val_freq=100, val_mesh_freq=100,
             mask_weight=0.1, n_outside=0)
    d.update(kw)
    path = str(tmp / "test.conf")
    with open(path, "w") as f:
        f.write(CONF_TMPL.format(**d))
    return path, d["exp_dir"]


def _params(seed=0):
    text = CONF_TMPL.format(exp_dir="x", data_dir="x", end_iter=1,
                            warm_up_iter=1, save_freq=1, val_freq=1,
                            val_mesh_freq=1, mask_weight=0.1, n_outside=0)
    jstatics = jfields.statics_from_conf(jconfig.parse_string(text)["model"])
    tstatics = tfields.statics_from_conf(tconfig.parse_string(text)["model"])
    jparams = jfields.init_model_bundle(jax.random.PRNGKey(seed), jstatics)
    tparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jstatics, jparams, tstatics, tparams


def test_extract_fields_agrees_ragged_chunks():
    """33³ = 35,937 points in chunks of 4,096: eight full and a ragged one."""
    jstatics, jparams, tstatics, tparams = _params()
    want = jrnd.extract_fields(jstatics, jparams, BMIN, BMAX, 33, chunk=4096)
    got = trnd.extract_fields(tstatics, tparams, BMIN, BMAX, 33, chunk=4096)
    assert got.shape == want.shape == (33, 33, 33) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert (got > 0).any() and (got < 0).any()
    # the default chunk (one 64³ chunk holds the whole grid) gives the same
    np.testing.assert_allclose(trnd.extract_fields(tstatics, tparams, BMIN, BMAX, 33),
                               got, rtol=0, atol=2e-3)


def test_grid_points_agree():
    got = trnd.make_grid_points(BMIN, [1.0, 0.5, 1.2], 7, device="cpu").numpy()
    want = np.asarray(jrnd.make_grid_points(BMIN, [1.0, 0.5, 1.2], 7))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    flat = trnd.grid_chunk_points(5, 300, BMIN, [1.0, 0.5, 1.2], 7,
                                  device="cpu").numpy()
    want_flat = np.asarray(jrnd.grid_chunk_points(5, 300, BMIN, [1.0, 0.5, 1.2], 7))
    np.testing.assert_array_equal(flat, want_flat)
    np.testing.assert_allclose(flat, got.reshape(-1, 3)[5:305], rtol=0, atol=1e-6)


@pytest.mark.parametrize("grid_kind", ["network", "noisy_torus"])
def test_marching_cubes_equals_jax_native(grid_kind):
    assert jmc.native_available()
    if grid_kind == "network":
        jstatics, jparams, _, _ = _params(1)
        grid = jrnd.extract_fields(jstatics, jparams, BMIN, BMAX, 29)
    else:
        ax = np.linspace(-1, 1, 26)
        p = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
        rho = np.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
        sdf = np.sqrt((rho - 0.5) ** 2 + p[..., 2] ** 2) - 0.22
        grid = (-sdf + 0.02 * np.random.default_rng(0).normal(size=sdf.shape))
        grid = grid.astype(np.float32)
    v, f = tmc.marching_cubes(grid, 0.0)
    jv, jf = jmc.marching_cubes(grid, 0.0)
    assert len(f) > 100
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    tv, tf = tmc.extract_geometry(grid, BMIN, BMAX, 0.01)
    jv2, jf2 = jmc.extract_geometry(grid, BMIN, BMAX, 0.01)
    np.testing.assert_array_equal(tv, jv2)
    np.testing.assert_array_equal(tf, jf2)


def test_marching_cubes_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises; no fallback runs."""
    bad = tmp_path / "marching_cubes.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tmc, "SOURCE", bad)
    monkeypatch.setattr(tmc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tmc, "_lib", None)
    with pytest.raises(RuntimeError, match="build failed"):
        tmc.marching_cubes(np.zeros((3, 3, 3), np.float32))
    assert tmc._lib is None
    monkeypatch.setenv("CXX", "")
    monkeypatch.setattr(tmc.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        tmc.library()


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Two steps of the JAX runner on a 3-view sphere, its checkpoint at 2
    and its object-space mesh at resolution 32."""
    tmp = tmp_path_factory.mktemp("mesh_run")
    case = str(tmp / "sphere")
    jcase.write_case(case, n_views=3, H=32, W=32, radius=0.4)
    conf, exp = _write_conf(tmp, case)
    runner = JRunner(conf, "train_rnb", shard="off")
    runner.train_rnb()
    jv, jt = runner.validate_mesh(resolution=32)
    return tmp, case, exp, jv, jt


def test_validate_mesh_on_jax_trained_weights(jax_run):
    tmp, case, exp, jv, jt = jax_run
    conf, exp2 = _write_conf(tmp, case, exp_dir=str(tmp / "exp_port"))
    os.makedirs(os.path.join(exp2, "checkpoints"))
    shutil.copy(os.path.join(exp, "checkpoints", "ckpt_000002.npz"),
                os.path.join(exp2, "checkpoints"))
    runner = TRunner(conf, "validate_mesh", is_continue=True, device="cpu")
    assert runner.iter_step == 2
    v, t = runner.validate_mesh(resolution=32)
    assert len(t) == len(jt) > 100
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-4)
    assert os.path.isfile(os.path.join(exp2, "meshes", "00000002.ply"))


def _gate_line(main, argv):
    buf = pyio.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("threshold", ["0.5", "0.0001"])
def test_acceptance_gates_agree(jax_run, threshold):
    _, _, exp, _, _ = jax_run
    argv = [exp, "--shape", "sphere", "--radius", "0.4", "--n_points", "20000",
            "--threshold", threshold, "--warm_up_iter", "1"]
    trc, tline = _gate_line(tacc.main, argv)
    jrc, jline = _gate_line(jacc.main, argv)
    assert tline == jline and trc == jrc
    assert tline["chamfer_l1"] > 0
    chamfer_failed = any(f.startswith("chamfer") for f in tline["failures"])
    assert chamfer_failed == (threshold == "0.0001"), tline
