"""The port's kill-and-resume gate (``python -m rnb_tpu_torch.tools.run_e2e``)
on the CPU, on a 3-view 32x32 torus at the test widths of
tests/test_runner.py: a run killed at its step-2 checkpoint and resumed
logs the straight run's losses, a run killed before any checkpoint is a
failed gate, and the pieces the record is made of (the split of the scalar
stream at each process's ``meta`` record, the overlap, a stale ``.tmp``
checkpoint) hold on their own."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from rnb_tpu_torch.tools import run_e2e
from rnb_tpu_torch.utils import checkpoint as tckpt
from test_runner import CONF_TMPL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, WARM = 10, 5
CASE_FLAGS = ["--size", "32", "--n_views", "3", "--mesh_resolution", "16"]
SETS = ["--set", "train.save_freq=2", "--set", "train.report_freq=5",
        "--set", "train.warm_up_end=5"]


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
                PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _conf(d):
    path = str(d / "t.conf")
    with open(path, "w") as f:
        f.write(CONF_TMPL.format(
            exp_dir="./exp/CASE_NAME/t", data_dir="./data/CASE_NAME/",
            end_iter=STEPS, warm_up_iter=WARM, save_freq=2, val_freq=100,
            val_mesh_freq=100, mask_weight=0.1, n_outside=0))
    return path


def _gate(d, *flags):
    """The gate in ``d`` -> (exit code, its record)."""
    proc = subprocess.run(
        [sys.executable, "-m", "rnb_tpu_torch.tools.run_e2e", "--device", "cpu",
         "--conf", _conf(d), "--iters", str(STEPS), "--warmup", str(WARM),
         "--threshold", "1.0", *CASE_FLAGS, *SETS, *flags],
        cwd=d, env=_env(), capture_output=True, text=True, timeout=180)
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec == json.load(open(d / "exp" / "e2e.json"))
    return proc.returncode, rec


def test_killed_at_a_checkpoint_resumes_the_straight_run(tmp_path):
    (tmp_path / "straight").mkdir()
    (tmp_path / "killed").mkdir()
    # the straight run: the CLI, once, on the gate's case and schedule
    rc, _ = _gate(tmp_path / "straight", "--kill_after", "0")
    assert rc == 0
    straight = run_e2e.loss_segments(str(
        tmp_path / "straight" / "exp" / "torus_e2e" / "t" / "logs" / "scalars.jsonl"))
    assert len(straight) == 1 and sorted(straight[0]) == list(range(1, STEPS + 1))

    rc, rec = _gate(tmp_path / "killed", "--kill_at_ckpt", "2")
    assert rc == 0 and rec["accepted"] and rec["failures"] == [], rec
    assert rec["leg1"]["rc"] == -15          # SIGTERM, to the process itself
    assert rec["resumed_from"] == rec["find_checkpoint"] >= 2
    assert rec["kill_inside_warmup"] and rec["resumed_crosses_warmup"]
    assert rec["leg2"]["rc"] == 0 and rec["chamfer_l1"] > 0
    assert set(rec["launches"]) >= {"sdf_core_fwd", "albedo_bwd"}
    segs = run_e2e.loss_segments(str(
        tmp_path / "killed" / "exp" / "torus_e2e" / "t" / "logs" / "scalars.jsonl"))
    resumed = segs[-1]
    assert sorted(resumed) == list(range(rec["resumed_from"] + 1, STEPS + 1))
    for s, loss in resumed.items():
        assert abs(loss - straight[0][s]) <= 1e-6 * abs(straight[0][s]), s
    # the runner logs in blocks of 64 steps: the killed process logged none
    assert rec["killed_after_step"] is None and rec["overlap"]["steps"] == 0
    assert "blocks of 64" in rec["overlap"]["note"]


def test_a_kill_before_any_checkpoint_fails_the_gate(tmp_path):
    rc, rec = _gate(tmp_path, "--kill_after", "0.5")
    assert rc == 1 and not rec["accepted"]
    assert rec["leg1"]["checkpoints_at_kill"] == []
    assert len(rec["failures"]) == 1
    assert "no checkpoint existed when the kill landed" in rec["failures"][0]
    assert "leg2" not in rec        # nothing was resumed from step 0


def test_stale_tmp_checkpoint_is_ignored(tmp_path):
    """A kill inside save_checkpoint leaves ``ckpt_*.npz.tmp``: the resume
    takes the newest whole checkpoint."""
    for name in ("ckpt_000002.npz", "ckpt_000004.npz.tmp", "last_good_000006.npz"):
        (tmp_path / name).write_bytes(b"")
    assert tckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_000002.npz")
    assert tckpt.latest_checkpoint(str(tmp_path), end_iter=1) is None


def _write_stream(path, *processes):
    with open(path, "w") as f:
        for losses in processes:
            f.write(json.dumps({"meta": {}, "time": 0.0}) + "\n")
            for s, loss in losses.items():
                f.write(json.dumps({"step": s, "time": 0.0, "Loss/loss": loss}) + "\n")
                f.write(json.dumps({"step": s, "time": 0.0,
                                    "Perf/rays_per_s": 1.0}) + "\n")


@pytest.mark.parametrize("killed_to,diff,want_first", [
    (128, 0.0, 0.0),          # logged past the checkpoint: step 101 in both
    (128, 1e-3, 1e-3),
    (64, 0.0, None),          # killed less than 64 steps after it
])
def test_loss_segments_and_overlap(tmp_path, killed_to, diff, want_first):
    killed = {s: 1.0 / s for s in range(1, killed_to + 1)}
    resumed = {s: 1.0 / s * (1 + diff * (s == 101)) for s in range(101, 201)}
    path = str(tmp_path / "scalars.jsonl")
    _write_stream(path, killed, resumed)
    segs = run_e2e.loss_segments(path)
    assert segs == [killed, resumed]
    ov = run_e2e.overlap(segs[0], segs[1], 100)
    both = [s for s in range(101, 201) if s <= killed_to]
    assert ov["steps"] == len(both)
    if want_first is None:
        assert ov["first_step_rel_diff"] is None and ov["max_rel_diff"] is None
        assert "no step after step 100" in ov["note"]
    else:
        assert ov["first"] == 101 and ov["last"] == killed_to
        np.testing.assert_allclose(ov["first_step_rel_diff"], want_first, rtol=1e-9)
        np.testing.assert_allclose(ov["max_rel_diff"], want_first, rtol=1e-9)
        assert "note" not in ov


def test_result_lines_among_other_output():
    a = {"launches": {"sdf_core_fwd": 3}, "rank": 0, "world": 2, "params_sha256": "x"}
    b = {"launches": {"sdf_core_fwd": 4}, "rank": 1, "world": 2, "params_sha256": "x"}
    text = f"iter: 2 loss=0.1\n[rank1] log{json.dumps(b)}\ntrained\n{json.dumps(a)}\n"
    assert run_e2e.result_lines(text) == [b, a]
    assert run_e2e.result_lines("trained 2 steps\n") == []
