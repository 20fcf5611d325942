"""The port's command line under ``torch.distributed.run``: two ranks with
gloo on the CPU (``--device cpu``) train one model on an 8-view 32x32
sphere case, at the test widths of tests/test_runner.py. The counterpart of
tests/test_multihost.py: the per-step losses equal one process's, a
kill-resume from a step-3 checkpoint equals the uninterrupted run, a
view-sharded run reads on each rank only its views, and the files are
written once, by the chief."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from rnb_tpu_torch.tools.make_synthetic_case import write_case
from test_runner import CONF_TMPL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6


@pytest.fixture(scope="module")
def conf(tmp_path_factory):
    d = tmp_path_factory.mktemp("multiprocess")
    write_case(str(d / "sphere8"), n_views=8, H=32, W=32, radius=0.4)
    path = str(d / "test.conf")
    with open(path, "w") as f:
        f.write(CONF_TMPL.format(
            exp_dir=str(d / "exp"), data_dir=str(d / "sphere8"),
            end_iter=STEPS, warm_up_iter=3, save_freq=3, val_freq=STEPS,
            val_mesh_freq=100, mask_weight=0.1, n_outside=0))
    return path


def _cli(conf, exp, ranks, extra=(), timeout=150):
    """The CLI on ``ranks`` processes (0: one process, no launcher); ->
    the completed process, its return code checked by the caller."""
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    launch = ([] if ranks == 0 else
              ["-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(ranks)])
    cmd = [sys.executable, *launch, "-m", "rnb_tpu_torch.cli", "--device", "cpu",
           "--conf", conf, "--mesh_resolution", "16",
           "--set", f"general.base_exp_dir={exp}", *extra]
    return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def _ok(proc):
    """The ranks' result objects of a run that must have succeeded."""
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    dec = json.JSONDecoder()
    return [dec.raw_decode(proc.stdout, m.start())[0]
            for m in re.finditer(r'\{"launches"', proc.stdout)]


def _losses(exp):
    with open(os.path.join(exp, "logs", "scalars.jsonl")) as f:
        recs = [json.loads(l) for l in f]
    return {r["step"]: r["Loss/loss"] for r in recs if "Loss/loss" in r}


@pytest.fixture(scope="module")
def straight(conf, tmp_path_factory):
    """One process, then two ranks, each straight through STEPS steps."""
    d = tmp_path_factory.mktemp("straight")
    one, two = str(d / "one"), str(d / "two")
    _ok(_cli(conf, one, 0))
    lines = _ok(_cli(conf, two, 2))
    return _losses(one), two, lines


def test_two_ranks_match_one_process(straight):
    ref, two, lines = straight
    got = _losses(two)
    assert sorted(got) == sorted(ref) == list(range(1, STEPS + 1))
    for s in ref:
        assert abs(got[s] - ref[s]) <= 1e-5 * abs(ref[s]), (s, got[s], ref[s])
    # one line a rank; the parameters equal bit for bit across the ranks
    assert sorted((l["rank"], l["world"]) for l in lines) == [(0, 2), (1, 2)]
    assert lines[0]["params_sha256"] == lines[1]["params_sha256"]
    # the chief's files, once: one scalar stream, the checkpoints, the mesh
    assert sorted(os.listdir(os.path.join(two, "checkpoints"))) == [
        "ckpt_000003.npz", f"ckpt_{STEPS:06d}.npz"]
    assert os.listdir(os.path.join(two, "meshes")) == [f"{STEPS:08d}.ply"]
    assert len(open(os.path.join(two, "logs", "scalars.jsonl")).readlines()) \
        == 1 + STEPS + 1   # meta, the steps, one rays/s row (report_freq 4)
    # replicated data: the chief alone validates
    assert [f.split("_")[1] for f in os.listdir(
        os.path.join(two, "validations_fine"))] == ["p0"]


def test_two_ranks_kill_resume(conf, straight, tmp_path):
    """Two ranks stopped at step 3 with a checkpoint, then a fresh pair
    with --is_continue: every rank loads the checkpoint and the resumed
    steps equal the straight run's."""
    ref = _losses(straight[1])
    exp = str(tmp_path / "exp")
    _ok(_cli(conf, exp, 2, ["--set", "train.end_iter=3"]))
    assert os.path.isfile(os.path.join(exp, "checkpoints", "ckpt_000003.npz"))
    lines = _ok(_cli(conf, exp, 2, ["--is_continue"]))
    assert lines[0]["params_sha256"] == lines[1]["params_sha256"] \
        == straight[2][0]["params_sha256"]
    got = _losses(exp)
    assert sorted(got) == sorted(ref)
    for s in ref:
        assert abs(got[s] - ref[s]) <= 1e-6 * abs(ref[s]), (s, got[s], ref[s])
    # an inference mode on both ranks: the grid split over them, one mesh
    os.remove(os.path.join(exp, "meshes", f"{STEPS:08d}.ply"))
    _ok(_cli(conf, exp, 2, ["--mode", "validate_mesh"]))
    assert sorted(os.listdir(os.path.join(exp, "meshes"))) == [
        "00000003.ply", f"{STEPS:08d}.ply"]


def test_view_sharded_run_reads_own_views(conf, tmp_path):
    exp = str(tmp_path / "exp")
    proc = _cli(conf, exp, 2, ["--set", "train.view_shard=true"])
    lines = _ok(proc)
    loaded = dict(re.findall(r"rank (\d) of 2 loads global views (\[[\d, ]*\])",
                             proc.stderr))
    assert {int(r): json.loads(v) for r, v in loaded.items()} == {
        0: [0, 1, 2, 3], 1: [4, 5, 6, 7]}
    assert lines[0]["params_sha256"] == lines[1]["params_sha256"]
    losses = _losses(exp)
    assert sorted(losses) == list(range(1, STEPS + 1))
    assert np.isfinite(list(losses.values())).all()
    assert sorted(os.listdir(os.path.join(exp, "checkpoints"))) == [
        "ckpt_000003.npz", f"ckpt_{STEPS:06d}.npz"]
    # each rank validates a view of its own shard, under its own tag
    tags = sorted((f.split("_")[1], int(f.split("_")[2]))
                  for f in os.listdir(os.path.join(exp, "validations_fine")))
    assert [t for t, _ in tags] == ["p0", "p1"]
    assert tags[0][1] in range(4) and tags[1][1] in range(4, 8)


def test_batch_that_does_not_divide_is_refused(conf, tmp_path):
    proc = _cli(conf, str(tmp_path / "exp"), 2, ["--set", "train.batch_size=63"])
    assert proc.returncode != 0
    assert "train.batch_size = 63 does not divide by the world size 2" in proc.stderr
