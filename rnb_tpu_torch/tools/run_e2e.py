"""The kill-and-resume end-to-end gate (the port's copy of
``tools/run_e2e.sh``):

    python -m rnb_tpu_torch.tools.run_e2e [--kill_after 240 | --kill_at_ckpt K]
        [--iters 30000] [--warmup 20000] [--threshold 0.005]
        [--case torus_e2e] [--shape torus|sphere] [--radius R]
        [--n_views 8] [--size 256] [--conf confs/wmask_rnb.conf]
        [--mesh_resolution 512] [--set PATH=VALUE ...] [--device cuda|cpu]

The protocol of the JAX script: write the clean analytic case with
``make_synthetic_case`` (the torus, 8 views of 256x256, by default), train
``confs/wmask_rnb.conf`` through ``python -m rnb_tpu_torch.cli`` on the
compressed schedule (``--iters`` steps, ``--warmup`` of them in warm-up,
``warm_up_end=500``, a checkpoint every 2000 steps, validation every
10000, a report every 500), send SIGTERM to the training process itself
after ``--kill_after`` seconds (0: no kill), resume it with
``--is_continue --mesh_resolution 512`` to the end, and gate the mesh with
``rnb_tpu_torch.tools.acceptance --warm_up_iter W --threshold T``.
``E2E_ITERS``, ``E2E_WARMUP`` and ``E2E_THRESHOLD`` set the defaults of
``--iters``, ``--warmup`` and ``--threshold``, as in the JAX script;
``--set`` flags come after the schedule's and win.

``--kill_at_ckpt K`` kills instead once ``checkpoints/ckpt_{K:06d}.npz``
exists (it is written atomically, so it is whole). A timed kill of a short
run is a race, with the process start and, on a fresh card machine, the
first-use kernel build inside the time; a kill at a checkpoint is not.

Where the JAX script printed, this tool checks. The gate fails, with a
record saying why, when no checkpoint existed when the kill landed (the
resume would silently restart from step 0), when the first process ended
before the kill, when the resumed process did not log ``Find checkpoint``
(or named another checkpoint), when a leg or the acceptance gate fails, or
when step ``resumed_from + 1``, logged by both processes, differs by more
than 1e-6 relative. ``logs/scalars.jsonl`` holds both processes' steps,
each process's after its ``meta`` record; the steps both logged (the
runner logs in blocks of 64 steps, so a kill less than 64 steps after the
checkpoint leaves none) are the overlap, whose largest difference is
reported and not gated.

``data/<case>``, ``exp/<case>/<conf name>``, the legs' logs
(``exp/<case>/e2e_leg{1,2}.log``) and the record (``exp/e2e.json``) lie
under the current directory, as the CLI's conf paths do. Prints the record as one
JSON line; exit 0 when the gate passed.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

from rnb_tpu_torch.tools.ablate_kernel import card
from rnb_tpu_torch.tools.run_parity_matrix import (ROOT, schedule_overrides,
                                                   subprocess_env)
from rnb_tpu_torch.utils.checkpoint import CKPT_RE, latest_checkpoint

RESUME_TOL = 1e-6       # relative, on the first step after the checkpoint
POLL_S = 0.02
RECORD = os.path.join("exp", "e2e.json")


def result_lines(text: str) -> list:
    """Every rank's ``{"launches": ...}`` object that the command line
    printed into ``text``, wherever another rank's output broke into it."""
    dec = json.JSONDecoder()
    return [dec.raw_decode(text, m.start())[0]
            for m in re.finditer(r'\{"launches"', text)]


def loss_segments(path: str) -> list:
    """The per-step losses of a ``scalars.jsonl``, one {step: loss} a
    process: each process writes a ``meta`` record first."""
    segs = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if "meta" in rec:
                segs.append({})
            elif "Loss/loss" in rec:
                segs[-1][rec["step"]] = rec["Loss/loss"]
    return segs


def overlap(killed: dict, resumed: dict, resumed_from: int) -> dict:
    """The steps both processes logged, with the relative loss difference
    at step ``resumed_from + 1`` and the largest over all of them."""
    both = sorted(set(killed) & set(resumed))
    rel = {s: abs(resumed[s] - killed[s]) / max(abs(killed[s]), 1e-30)
           for s in both}
    out = {"steps": len(both), "first": both[0] if both else None,
           "last": both[-1] if both else None,
           "first_step_rel_diff": rel.get(resumed_from + 1),
           "max_rel_diff": max(rel.values()) if rel else None}
    if resumed_from + 1 not in rel:
        out["note"] = (f"the killed process logged no step after step "
                       f"{resumed_from} (it logs in blocks of 64 steps)")
    return out


def _kill_leg(cmd, log_path, args, ckpt_dir):
    """Start the first leg and SIGTERM it at the kill -> (its record, the
    reason it failed or None)."""
    t0 = time.monotonic()
    target = (os.path.join(ckpt_dir, f"ckpt_{args.kill_at_ckpt:06d}.npz")
              if args.kill_at_ckpt else None)
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                env=subprocess_env())
        try:
            while proc.poll() is None:
                if (os.path.exists(target) if target
                        else time.monotonic() - t0 >= args.kill_after):
                    break
                time.sleep(POLL_S)
            ended = proc.poll() is not None
            if not ended:
                proc.send_signal(signal.SIGTERM)
            killed_at = time.monotonic() - t0
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    names = sorted(os.listdir(ckpt_dir)) if os.path.isdir(ckpt_dir) else []
    rec = {"wall_s": time.monotonic() - t0, "killed_at_s": killed_at, "rc": rc,
           "checkpoints_at_kill": [n for n in names if CKPT_RE.search(n)],
           "stale_tmp": [n for n in names if n.endswith(".tmp")]}
    if ended:
        return rec, (f"the first process ended (rc {rc}) before the kill: "
                     "nothing was resumed")
    if not rec["checkpoints_at_kill"]:
        return rec, ("no checkpoint existed when the kill landed after "
                     f"{killed_at:.1f} s: the resume would restart from step 0")
    return rec, None


def _accept(args, exp_dir) -> dict:
    cmd = [sys.executable, "-m", "rnb_tpu_torch.tools.acceptance", exp_dir,
           "--shape", args.shape, "--warm_up_iter", str(args.warmup),
           "--threshold", str(args.threshold)]
    if args.shape == "sphere":
        cmd += ["--radius", str(args.radius)]
    g = subprocess.run(cmd, capture_output=True, text=True, env=subprocess_env())
    try:
        return json.loads(g.stdout.strip().splitlines()[-1])
    except (json.JSONDecodeError, IndexError):
        return {"accepted": False,
                "failures": [f"gate crashed: {g.stderr[-400:]}"]}


def run_gate(args) -> dict:
    """The whole protocol -> its record."""
    case_dir = os.path.join("data", args.case)
    conf_name = os.path.splitext(os.path.basename(args.conf))[0]
    exp_dir = os.path.join("exp", args.case, conf_name)
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    subprocess.run([sys.executable, "-m", "rnb_tpu_torch.tools.make_synthetic_case",
                    "--out", case_dir, "--shape", args.shape, "--radius",
                    str(args.radius), "--n_views", str(args.n_views),
                    "--size", str(args.size)], check=True, env=subprocess_env())
    if os.path.isdir(exp_dir):
        shutil.rmtree(exp_dir)
    os.makedirs(exp_dir)
    cli = [sys.executable, "-m", "rnb_tpu_torch.cli", "--mode", "train_rnb",
           "--conf", args.conf, "--case", args.case, "--device", args.device,
           "--set", f"dataset.data_dir={case_dir}",
           "--set", f"general.base_exp_dir={exp_dir}",
           # the gates' compressed schedule with the JAX script's
           # checkpoint every 2000 steps (tools/run_e2e.sh:15-17)
           *schedule_overrides(args.iters, args.warmup),
           "--set", "train.save_freq=2000",
           *(a for s in args.overrides for a in ("--set", s))]
    kill = ({"at_ckpt": args.kill_at_ckpt} if args.kill_at_ckpt
            else {"after_s": args.kill_after} if args.kill_after else None)
    how = (f"killed at ckpt {args.kill_at_ckpt} and resumed" if args.kill_at_ckpt
           else f"killed after {args.kill_after:g} s and resumed" if kill
           else "not killed")
    rec = {"protocol": (f"clean analytic {args.shape}, {args.n_views} views "
                        f"of {args.size}^2, {args.conf}, {args.iters} steps "
                        f"({args.warmup} warm-up), {how}, "
                        f"{args.mesh_resolution}^3 mesh, Chamfer-L1 <= "
                        f"{args.threshold}"),
           "card": "cpu" if args.device == "cpu" else card(),
           "device": args.device, "kill": kill,
           "failures": []}
    logs = [os.path.join("exp", args.case, f"e2e_leg{i}.log") for i in (1, 2)]
    if kill:
        rec["leg1"], why = _kill_leg(cli, logs[0], args, ckpt_dir)
        if why:
            rec["failures"].append(why)
            return rec
        rec["resumed_from"] = int(CKPT_RE.search(
            latest_checkpoint(ckpt_dir, args.iters)).group(1))
    t0 = time.monotonic()
    with open(logs[1], "w") as log:
        rc = subprocess.run(cli + ["--is_continue", "--mesh_resolution",
                                   str(args.mesh_resolution)],
                            stdout=log, stderr=subprocess.STDOUT,
                            env=subprocess_env()).returncode
    rec["leg2"] = {"wall_s": time.monotonic() - t0, "rc": rc}
    if rc != 0:
        rec["failures"].append(f"the resumed process exited {rc}")
        return rec
    with open(logs[1]) as f:
        out = f.read()
    found = re.search(r"Find checkpoint: ckpt_(\d+)\.npz", out)
    rec["find_checkpoint"] = int(found.group(1)) if found else None
    rec["launches"] = result_lines(out)[0]["launches"]
    segs = loss_segments(os.path.join(exp_dir, "logs", "scalars.jsonl"))
    resumed = segs[-1]
    rec["resumed_steps"] = [min(resumed), max(resumed)] if resumed else None
    rec["resumed_crosses_warmup"] = bool(resumed) and (
        min(resumed) <= args.warmup < max(resumed))
    if kill:
        killed = segs[0] if len(segs) == 2 else {}
        rec["killed_after_step"] = max(killed) if killed else None
        rec["kill_inside_warmup"] = 0 < rec["resumed_from"] < args.warmup
        if found is None:
            rec["failures"].append("the resumed process did not log "
                                   "'Find checkpoint': it started afresh")
        elif rec["find_checkpoint"] != rec["resumed_from"]:
            rec["failures"].append(
                f"the resumed process loaded step {rec['find_checkpoint']}, "
                f"not the newest checkpoint at the kill ({rec['resumed_from']})")
        rec["overlap"] = overlap(killed, resumed, rec["resumed_from"])
        d = rec["overlap"]["first_step_rel_diff"]
        if d is not None and d > RESUME_TOL:
            rec["failures"].append(f"step {rec['resumed_from'] + 1}: relative "
                                   f"loss difference {d:.3e} > {RESUME_TOL:g}")
    rec["acceptance"] = _accept(args, exp_dir)
    rec["chamfer_l1"] = rec["acceptance"].get("chamfer_l1")
    rec["failures"] += [f"acceptance: {f}" for f in
                        rec["acceptance"].get("failures", [])]
    return rec


def main(argv=None):
    env = os.environ.get
    ap = argparse.ArgumentParser(description="kill-and-resume e2e gate")
    kill = ap.add_mutually_exclusive_group()
    kill.add_argument("--kill_after", type=float, default=240.0,
                      help="seconds until SIGTERM to the training process "
                           "(0: no kill)")
    kill.add_argument("--kill_at_ckpt", type=int, default=0,
                      help="SIGTERM once checkpoints/ckpt_{K:06d}.npz exists")
    ap.add_argument("--iters", type=int, default=int(env("E2E_ITERS", "30000")))
    ap.add_argument("--warmup", type=int, default=int(env("E2E_WARMUP", "20000")))
    ap.add_argument("--threshold", type=float,
                    default=float(env("E2E_THRESHOLD", "0.005")))
    ap.add_argument("--case", default="torus_e2e")
    ap.add_argument("--shape", default="torus", choices=["torus", "sphere"])
    ap.add_argument("--radius", type=float, default=0.4,
                    help="sphere radius (--shape sphere)")
    ap.add_argument("--n_views", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--conf", default=os.path.join(ROOT, "confs", "wmask_rnb.conf"))
    ap.add_argument("--mesh_resolution", type=int, default=512)
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="PATH=VALUE", help="conf override (repeatable)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    rec = run_gate(args)
    rec["accepted"] = not rec["failures"]
    with open(RECORD, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    return 0 if rec["accepted"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
