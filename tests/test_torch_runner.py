"""The port's runner and command line on the CPU, on a 3-view sphere case
at the widths of tests/test_runner.py: the training loop with its
checkpoints, validation images and mesh (with and without the background
NeRF), the view order against the JAX runner's, a bit-identical resume, the
NaN guard, and a JAX-written checkpoint through both command lines."""

import functools
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rnb_tpu import cli as jcli
from rnb_tpu.train.runner import Runner as JRunner
from rnb_tpu.utils import checkpoint as jckpt
from rnb_tpu.utils import io as jio
from rnb_tpu_torch.train import step as tstep
from rnb_tpu_torch.train.runner import Runner as TRunner
from rnb_tpu_torch.utils import checkpoint as tckpt
from rnb_tpu_torch.utils.bridge import tree_leaves
from rnb_tpu_torch.utils import io as tio
from test_runner import CONF_TMPL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_synthetic_case as jcase  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("runner_data") / "sphere"
    jcase.write_case(str(d), n_views=3, H=32, W=32, radius=0.4)
    return str(d)


def _write_conf(tmp_path, case_dir, **kw):
    d = dict(exp_dir=str(tmp_path / "exp"), data_dir=case_dir, end_iter=12,
             warm_up_iter=8, save_freq=6, val_freq=10, val_mesh_freq=10,
             mask_weight=0.1, n_outside=0)
    d.update(kw)
    path = str(tmp_path / "test.conf")
    with open(path, "w") as f:
        f.write(CONF_TMPL.format(**d))
    return path, d["exp_dir"]


def _logged(exp_dir, key="Loss/loss"):
    out = {}
    with open(os.path.join(exp_dir, "logs", "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if key in rec:
                out[rec["step"]] = rec[key]
    return out


@pytest.mark.parametrize("n_outside", [0, 4])
def test_train_writes_checkpoints_images_mesh(tmp_path, case_dir, n_outside):
    conf, exp = _write_conf(tmp_path, case_dir, n_outside=n_outside,
                            mask_weight=0.0 if n_outside else 0.1)
    runner = TRunner(conf, "train_rnb", device="cpu")
    # the cadence's mesh (val_mesh_freq = 10) at a test-sized grid
    runner.validate_mesh = functools.partial(runner.validate_mesh, resolution=24)
    res = runner.train_rnb()
    assert res["steps"] == 12 and runner.iter_step == 12
    assert sorted(os.listdir(os.path.join(exp, "checkpoints"))) == [
        "ckpt_000006.npz", "ckpt_000012.npz"]
    losses = _logged(exp)
    assert sorted(losses) == list(range(1, 13))
    assert np.isfinite(list(losses.values())).all()
    assert sorted(_logged(exp, "Perf/rays_per_s")) == [4, 8, 12]
    keys = {k for line in open(os.path.join(exp, "logs", "scalars.jsonl"))
            for k in json.loads(line)}
    assert {"Loss/color_loss", "Loss/eikonal_loss", "Loss/mask_loss",
            "Statistics/s_val", "Statistics/cdf", "Statistics/weight_max",
            "Statistics/psnr", "lr", "meta"} <= keys
    # validation at 10 (main phase: warm_up_iter = 8) at level 8: 4x4
    (img,) = os.listdir(os.path.join(exp, "validations_fine"))
    assert img.startswith("00000010_0_")
    rgb = jio.load_image(os.path.join(exp, "validations_fine", img))
    assert rgb.shape == (8, 4, 3)
    (nrm,) = os.listdir(os.path.join(exp, "normals"))
    assert tio.load_normal(os.path.join(exp, "normals", nrm)).shape == (8, 4, 3)
    v, f, _ = jio.read_ply(os.path.join(exp, "meshes", "00000010.ply"))
    assert len(v) > 0 and len(f) > 0
    # an explicit mesh and the recording of the sources and flags
    v2, t2 = runner.validate_mesh(world_space=True)
    assert len(t2) > 0 and os.path.isfile(os.path.join(exp, "meshes", "00000012.ply"))
    flags = json.load(open(os.path.join(exp, "recording", "flags.json")))
    assert flags["flags"]["core_impl"] == "pallas"


def test_view_order_equals_jax(tmp_path, case_dir):
    conf, _ = _write_conf(tmp_path, case_dir)
    jr = JRunner(conf, "validate_mesh", shard="off", seed=3)
    tr = TRunner(conf, "validate_mesh", device="cpu", seed=3)
    n = tr.dataset.n_images
    its = list(range(3 * n)) + [7 * n + 1, 2, 40 * n]
    assert [tr._view_for_step(i) for i in its] == [jr._view_for_step(i) for i in its]
    assert sorted(tr._view_for_step(i) for i in range(n)) == list(range(n))


def test_resume_is_bit_identical(tmp_path, case_dir):
    """9 straight steps against 4, a resume from the step-4 checkpoint, and
    5 more: every logged loss equal bit for bit (the LR of steps 1-4 lies
    on the warm_up_end ramp, which does not depend on end_iter)."""
    common = dict(warm_up_iter=6, val_freq=100, val_mesh_freq=100)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    conf_a, exp_a = _write_conf(tmp_path / "a", case_dir, end_iter=9,
                                save_freq=100, **common)
    TRunner(conf_a, device="cpu").train_rnb()
    straight = _logged(exp_a)
    conf_b, exp_b = _write_conf(tmp_path / "b", case_dir, end_iter=4,
                                save_freq=4, **common)
    TRunner(conf_b, device="cpu").train_rnb()
    conf_b2, _ = _write_conf(tmp_path / "b", case_dir, end_iter=9,
                             save_freq=100, **common)
    rb = TRunner(conf_b2, is_continue=True, device="cpu")
    assert rb.iter_step == 4
    rb.train_rnb()
    resumed = _logged(exp_b)
    assert sorted(straight) == sorted(resumed) == list(range(1, 10))
    for s in straight:
        assert resumed[s] == straight[s], f"step {s} diverged after resume"


def test_nan_guard_raises_and_dumps(tmp_path, case_dir):
    conf, exp = _write_conf(tmp_path, case_dir, end_iter=3, save_freq=2,
                            val_freq=100, val_mesh_freq=100)
    runner = TRunner(conf, device="cpu")
    with torch.no_grad():
        runner.state.params["sdf"][1]["v"].fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="non-finite loss at iter 1"):
        runner.train_rnb()
    names = sorted(os.listdir(os.path.join(exp, "checkpoints")))
    # the save at 2 was skipped (non-finite params); the guard dumped the
    # live state and the snapshot taken when the loop started
    assert names == ["last_good_000000.npz", "nan_dump_000001.npz"], names


def _npz_leaves(path):
    with np.load(path) as data:
        return [data[f"leaf_{i:06d}"] for i in range(int(data["__n_leaves__"]))]


def test_nan_guard_last_good_is_the_step0_state(tmp_path, case_dir):
    """Parameters poisoned after step 2: the guard fires at iter 3 and its
    last_good_000000.npz holds the state the loop started from, all finite,
    leaf by leaf (as the JAX runner's host copy does), not the live state
    that Adam updates in place."""
    conf, exp = _write_conf(tmp_path, case_dir, end_iter=3, save_freq=100,
                            val_freq=100, val_mesh_freq=100)
    runner = TRunner(conf, device="cpu")
    step0 = [np.array(x, copy=True) for x in tckpt.state_leaves(runner.state)]
    get_step_fn, calls = runner._get_step_fn, []

    def poisoning(warmup):
        fn = get_step_fn(warmup)

        def step(*args):
            out = fn(*args)
            calls.append(1)
            if len(calls) == 2:
                with torch.no_grad():
                    runner.state.params["sdf"][1]["v"].fill_(float("nan"))
            return out
        return step

    runner._get_step_fn = poisoning
    with pytest.raises(FloatingPointError, match="non-finite loss at iter 3"):
        runner.train_rnb()
    good = _npz_leaves(os.path.join(exp, "checkpoints", "last_good_000000.npz"))
    assert len(good) == len(step0)
    assert all(np.isfinite(x).all() for x in good)
    for i, (a, b) in enumerate(zip(good, step0)):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


def test_state_leaves_is_a_snapshot():
    """An earlier state_leaves is unchanged by a later Adam update, here one
    with NaN gradients, on CPU tensors."""
    params = {"sdf": [{"b": torch.zeros(3), "v": torch.ones(4, 3)}],
              "variance": torch.full((1,), 0.3)}
    state = tstep.init_train_state(params)
    leaves = tree_leaves(params)
    for p in leaves:
        p.grad = torch.full_like(p, 0.5)
    tstep.apply_update(state, lambda step: 1e-2)   # moments exist from here
    snap = tckpt.state_leaves(state)
    before = [np.array(x, copy=True) for x in snap]
    for p in leaves:
        p.grad = torch.full_like(p, float("nan"))
    tstep.apply_update(state, lambda step: 1e-2)
    assert not torch.isfinite(params["sdf"][0]["v"]).any()
    assert len(snap) == 3 * len(leaves) + 3
    for i, (a, b) in enumerate(zip(snap, before)):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


def test_cli_validate_mesh_of_a_jax_checkpoint(tmp_path, case_dir):
    """A checkpoint written by the JAX runner gives the same mesh through
    ``python -m rnb_tpu_torch.cli --mode validate_mesh --device cpu`` as
    through ``rnb_tpu.cli``."""
    conf, exp = _write_conf(tmp_path, case_dir)
    jr = JRunner(conf, "validate_mesh", shard="off", seed=5)
    leaves, treedef = jax.tree_util.tree_flatten(jr.state)
    leaves[-1] = leaves[-2] = np.asarray(7, np.int32)     # step 7
    jckpt.save_checkpoint(os.path.join(exp, "checkpoints", "ckpt_000007.npz"),
                          jax.tree_util.tree_unflatten(treedef, leaves))
    exp2 = str(tmp_path / "exp_port")
    shutil.copytree(os.path.join(exp, "checkpoints"),
                    os.path.join(exp2, "checkpoints"))
    args = ["--mode", "validate_mesh", "--conf", conf, "--mesh_resolution", "28"]
    jcli.main(args + ["--shard", "off"])
    r = subprocess.run(
        [sys.executable, "-m", "rnb_tpu_torch.cli", *args, "--device", "cpu",
         "--set", f"general.base_exp_dir={exp2}"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1])["launches"]["sdf_core_fwd"] == 0
    jv, jf, _ = jio.read_ply(os.path.join(exp, "meshes", "00000007.ply"))
    tv, tf, _ = tio.read_ply(os.path.join(exp2, "meshes", "00000007.ply"))
    assert len(tf) == len(jf) > 100
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4)
