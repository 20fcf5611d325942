"""The port's two-node smoke (``python -m rnb_tpu_torch.tools.multinode_smoke``)
with ``--device cpu`` on an 8-view 32x32 sphere at the test widths of
tests/test_runner.py: two ``torch.distributed.run --nnodes 2`` launchers on
localhost, one gloo rank each, against one process; view sharding; a stop
at step 3 and a resume of both nodes. The counterpart of
tests/test_multihost.py."""

import json
import os
import subprocess
import sys

import pytest

from rnb_tpu_torch.tools import multinode_smoke
from rnb_tpu_torch.tools.make_synthetic_case import write_case
from test_runner import CONF_TMPL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_nodes_match_one_process_and_resume(tmp_path):
    write_case(str(tmp_path / "sphere8"), n_views=8, H=32, W=32, radius=0.4)
    conf = tmp_path / "t.conf"
    conf.write_text(CONF_TMPL.format(
        exp_dir="unused", data_dir="unused", end_iter=1, warm_up_iter=1,
        save_freq=1, val_freq=1, val_mesh_freq=1, mask_weight=0.1, n_outside=0))
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "rnb_tpu_torch.tools.multinode_smoke",
         "--case", str(tmp_path / "sphere8"), "--conf", str(conf),
         "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["nodes"] == 2 and res["steps"] == 6 and res["device"] == "cpu"
    assert res["two_vs_one"] <= 1e-5 and res["resume_vs_straight"] <= 1e-6
    # rank r of 2 read only its block of the 8 views
    assert res["shard_views"] == {"0": [0, 1, 2, 3], "1": [4, 5, 6, 7]}
    # every run under the tool's --work, in the current directory
    assert sorted(os.listdir(tmp_path / "exp" / "multinode")) == [
        "one", "resume", "shard", "two"]


def test_a_failed_run_or_check_exits_non_zero(tmp_path):
    """A case that does not exist fails the first run, and the tool exits
    with its output; a difference beyond the bound fails the check."""
    proc = subprocess.run(
        [sys.executable, "-m", "rnb_tpu_torch.tools.multinode_smoke",
         "--device", "cpu", "--case", str(tmp_path / "none")], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and "one exited" in proc.stderr
    ref = {1: 0.5, 2: 0.25}
    assert multinode_smoke.rel_diff({1: 0.5, 2: 0.25 * (1 + 1e-7)}, ref, 1e-6, "x") \
        == pytest.approx(1e-7)
    with pytest.raises(SystemExit, match="relative loss difference 1.000e-05 > 1e-06"):
        multinode_smoke.rel_diff({1: 0.5, 2: 0.25 * (1 + 1e-5)}, ref, 1e-6, "x")
    with pytest.raises(SystemExit, match="steps"):
        multinode_smoke.rel_diff({1: 0.5}, ref, 1e-6, "x")
