"""The no-albedo path of the port against the JAX package, on the CPU: the
loader of the two shipped no-albedo confs, and the gate drivers at a few
steps. The no-albedo training steps themselves (wmask and
womask, warm-up and main; the colour net bit-identical, the albedo op never
called) are cases of ``tests/test_torch_step.py`` and
``tests/test_torch_womask.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from rnb_tpu import config as jconfig
from rnb_tpu.data import dataset as jds
from rnb_tpu_torch import config as tconfig
from rnb_tpu_torch.data import dataset as tds
from rnb_tpu_torch.tools import make_synthetic_case as tcase
from rnb_tpu_torch.tools import run_parity_matrix, run_parity_worldspace

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOALBEDO_CONFS = ("confs/wmask_rnb_noalbedo.conf",
                  "confs/womask_rnb_noalbedo.conf")
# a small model for the CPU: the gates run the confs' own widths
SMALL = ["train.batch_size=32", "model.neus_renderer.n_samples=8",
         "model.neus_renderer.n_importance=8", "model.sdf_network.d_hidden=32",
         "model.sdf_network.multires=4", "model.sdf_network.d_out=33",
         "model.rendering_network.d_feature=32",
         "model.rendering_network.d_hidden=32", "model.nerf.W=32",
         "model.nerf.D=2", "model.nerf.skips=[]"]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("noalb") / "torus")
    tcase.write_case(d, n_views=3, H=24, W=28, shape="torus", degrade=True)
    return d


@pytest.mark.parametrize("conf_path", NOALBEDO_CONFS)
def test_from_conf_forces_no_albedo(case, conf_path):
    """The shipped no-albedo confs set no albedo_dir: both loaders force
    no_albedo and give albedos of ones, with equal maps."""
    with open(os.path.join(ROOT, conf_path)) as f:
        text = f.read().replace("./data/CASE_NAME/", case + "/")
    tconf = tconfig.parse_string(text)["dataset"]
    jconf = jconfig.parse_string(text)["dataset"]
    assert "albedo_dir" not in tconf
    got = tds.Dataset.from_conf(tconf, device="cpu")
    want = jds.Dataset.from_conf(jconf)
    assert got.no_albedo and want.no_albedo
    albedos = got.arrays.albedos.numpy()
    assert albedos.shape == np.asarray(want.arrays.albedos).shape
    assert (albedos == 1.0).all() and (np.asarray(want.arrays.albedos) == 1.0).all()
    for name in ("normals", "masks", "albedos"):
        np.testing.assert_allclose(getattr(got.arrays, name).numpy(),
                                   np.asarray(getattr(want.arrays, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def _small(spec):
    return {**spec, "extra": spec["extra"] + [a for kv in SMALL
                                              for a in ("--set", kv)]}


@pytest.mark.parametrize("driver", ["matrix", "worldspace"])
def test_gate_driver_records_a_failed_gate(tmp_path, monkeypatch, driver):
    """Each gate driver at 4 steps (2 warm-up) on a small model, in an
    empty directory: the case is written (the world-space one normalized
    on the CPU), the CLI trains and writes a mesh, the gate runs and fails
    (4 steps are far from the surface), and the record and the exit code
    say so."""
    monkeypatch.chdir(tmp_path)
    argv = ["--iters", "4", "--warmup", "2", "--n_views", "4",
            "--mesh_resolution", "32", "--device", "cpu"]
    if driver == "matrix":
        name, case = "wmask_rnb_noalbedo", "torus_deg"
        monkeypatch.setitem(run_parity_matrix.VARIANTS, name,
                            _small(run_parity_matrix.VARIANTS[name]))
        assert run_parity_matrix.main(
            argv + ["--variants", name, "--size", "32"]) == 1
        with open(tmp_path / "exp" / "parity_matrix.json") as f:
            out = json.load(f)
        rec = out["variants"][name]
    else:
        name, case = "wmask_rnb", "torus_ns"
        monkeypatch.setattr(run_parity_worldspace, "SPEC",
                            _small(run_parity_worldspace.SPEC))
        assert run_parity_worldspace.main(
            argv + ["--width", "40", "--height", "32"]) == 1
        with open(tmp_path / "exp" / "parity_worldspace.json") as f:
            out = json.load(f)
        rec = out[name]
        assert abs(out["scale_mat_scale"] - 1.0) > 0.05
    assert out["all_accepted"] is False and rec["accepted"] is False
    assert rec["variant"] == name
    assert rec["max_step"] == 4 and np.isfinite(rec["chamfer_l1"])
    assert any(m.startswith("chamfer") for m in rec["failures"]), rec
    assert os.path.isfile(tmp_path / "exp" / case / name / "meshes" /
                          "00000004.ply")
