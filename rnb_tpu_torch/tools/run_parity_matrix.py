"""The conf matrix on a degraded synthetic torus, each variant gated by
Chamfer acceptance (the port's copy of ``tools/run_parity_matrix.py``):

    python -m rnb_tpu_torch.tools.run_parity_matrix [--variants ...]
        [--iters 30000] [--warmup 20000] [--size 256] [--n_views 8]
        [--mesh_resolution 512] [--out exp/parity_matrix.json]
        [--skip_existing] [--device cuda|cpu]

The case is the port's ``make_synthetic_case --shape torus --degrade``
(~3 deg normal noise, +/-2 px mask morphology, 8-bit maps, +/-0.2% focal
error); each variant trains through ``python -m rnb_tpu_torch.cli --mode
train_rnb`` on the compressed 30k/20k schedule, extracts a mesh, and is
gated by ``python -m rnb_tpu_torch.tools.acceptance`` against the clean
analytic torus:

    wmask_rnb            mask BCE 0.1, albedo supervision      <= 0.004
    wmask_rnb_noalbedo   mask BCE 0.1, shading only            <= 0.004
    womask_rnb           mask BCE 0, anneal_end 5000,
                         n_outside 4 (the background trains)   <= 0.008
    womask_rnb_noalbedo  both of the above                     <= 0.008

``data/<case>``, ``exp/<case>/<variant>`` and the record lie under the
current directory, as the CLI's conf paths do. Each record adds the
training wall and the median ms a warm-up and a main step (from the
runner's ``Perf/rays_per_s``); the record names the card (nvidia-smi's
name and power limit, or ``cpu``). Prints one JSON line a variant and a
summary; exit 0 when all are accepted.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

from rnb_tpu_torch.tools.ablate_kernel import card

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# keys are the conf base_exp_dir leaf names (exp/<case>/<key>)
VARIANTS = {
    "wmask_rnb": {
        "conf": "confs/wmask_rnb.conf", "threshold": 0.004, "extra": []},
    "wmask_rnb_noalbedo": {
        "conf": "confs/wmask_rnb_noalbedo.conf", "threshold": 0.004,
        "extra": []},
    "womask_rnb": {
        "conf": "confs/womask_rnb.conf", "threshold": 0.008,
        "extra": ["--set", "train.anneal_end=5000",
                  "--set", "model.neus_renderer.n_outside=4"]},
    "womask_rnb_noalbedo": {
        "conf": "confs/womask_rnb_noalbedo.conf", "threshold": 0.008,
        "extra": ["--set", "train.anneal_end=5000",
                  "--set", "model.neus_renderer.n_outside=4"]},
}


def schedule_overrides(iters: int, warmup: int) -> list:
    """The compressed schedule's ``--set`` flags (30k steps, 20k warm-up)."""
    return ["--set", f"train.end_iter={iters}",
            "--set", f"train.warm_up_iter={warmup}",
            "--set", "train.warm_up_end=500",
            "--set", "train.save_freq=5000",
            "--set", "train.val_freq=10000",
            "--set", "train.val_mesh_freq=10000",
            "--set", "train.report_freq=500"]


def subprocess_env() -> dict:
    """This environment with the package importable from any directory."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH", "")) if p)
    return env


def run(cmd, **kw):
    """Run a command in the current directory with the package importable."""
    print("+", " ".join(cmd), flush=True)
    return subprocess.run(cmd, env=subprocess_env(), **kw)


def make_case(case: str, flags: list) -> None:
    """Write ``data/<case>``, a degraded torus, unless it exists."""
    if not os.path.isdir(os.path.join("data", case)):
        run([sys.executable, "-m", "rnb_tpu_torch.tools.make_synthetic_case",
             "--out", f"data/{case}", "--shape", "torus", "--degrade", *flags],
            check=True)


def step_times(exp_dir: str, warmup: int, batch_size: int = 512) -> dict:
    """Median ms a warm-up and a main step from the logged rays/s."""
    phases = {"ms_per_step_warmup": [], "ms_per_step_main": []}
    path = os.path.join(exp_dir, "logs", "scalars.jsonl")
    if os.path.exists(path):
        with open(path) as fh:
            for line in fh:
                rec = json.loads(line)
                rps = rec.get("Perf/rays_per_s")
                if rps:
                    key = ("ms_per_step_warmup" if rec["step"] <= warmup
                           else "ms_per_step_main")
                    phases[key].append(1000.0 * batch_size / rps)
    return {k: float(np.median(v)) if v else None for k, v in phases.items()}


def gate(exp_dir: str, warmup: int, threshold: float, center=None) -> dict:
    """The acceptance record of ``exp_dir`` (a crash is a failed record)."""
    cmd = [sys.executable, "-m", "rnb_tpu_torch.tools.acceptance", exp_dir,
           "--shape", "torus", "--warm_up_iter", str(warmup),
           "--threshold", str(threshold)]
    if center is not None:
        cmd += ["--center", *[str(c) for c in center]]
    g = run(cmd, capture_output=True, text=True)
    try:
        return json.loads(g.stdout.strip().splitlines()[-1])
    except (json.JSONDecodeError, IndexError):
        return {"accepted": False,
                "failures": [f"gate crashed: {g.stderr[-400:]}"]}


def train(spec: dict, case: str, exp_dir: str, args) -> int:
    """Train one variant from scratch through the CLI -> its exit code."""
    if os.path.isdir(exp_dir):
        shutil.rmtree(exp_dir)
    cmd = [sys.executable, "-m", "rnb_tpu_torch.cli", "--mode", "train_rnb",
           "--conf", os.path.join(ROOT, spec["conf"]), "--case", case,
           "--mesh_resolution", str(args.mesh_resolution),
           "--device", args.device]
    return run(cmd + schedule_overrides(args.iters, args.warmup)
               + spec["extra"]).returncode


def run_variant(name: str, spec: dict, case: str, args) -> dict:
    """Train one variant (unless ``--skip_existing`` finds its mesh) and
    gate it -> its record, printed as one JSON line."""
    exp_dir = os.path.join("exp", case, name)
    t0 = time.time()
    trained = False
    if not (args.skip_existing
            and os.path.isdir(os.path.join(exp_dir, "meshes"))):
        rc = train(spec, case, exp_dir, args)
        if rc != 0:
            return {"accepted": False, "failures": [f"training rc={rc}"]}
        trained = True
    rec = gate(exp_dir, args.warmup, spec["threshold"], spec.get("center"))
    rec["variant"] = name
    rec["conf"] = spec["conf"]
    if trained:
        rec["train_wall_s"] = round(time.time() - t0, 3)
    rec.update(step_times(exp_dir, args.warmup))
    print(json.dumps(rec), flush=True)
    return rec


def write_record(path: str, out: dict) -> int:
    """Write the JSON record, print its summary -> the exit code."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"all_accepted": out["all_accepted"],
                      "out": os.path.abspath(path)}), flush=True)
    return 0 if out["all_accepted"] else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description="conf matrix parity gates")
    ap.add_argument("--case", default="torus_deg")
    ap.add_argument("--iters", type=int, default=30000)
    ap.add_argument("--warmup", type=int, default=20000)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--n_views", type=int, default=8)
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument("--out", default="exp/parity_matrix.json")
    ap.add_argument("--mesh_resolution", type=int, default=512)
    ap.add_argument("--skip_existing", action="store_true",
                    help="keep finished exp dirs (gate-only re-run)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    make_case(args.case, ["--n_views", str(args.n_views),
                          "--size", str(args.size)])
    records = {name: run_variant(name, VARIANTS[name], args.case, args)
               for name in args.variants}
    return write_record(args.out, {
        "protocol": ("degraded synthetic torus (3deg normal noise, +/-2px "
                     "mask morphology, 8-bit maps, +/-0.2% focal error), "
                     f"{args.iters} iters ({args.warmup} warm-up), "
                     f"{args.mesh_resolution}^3 extraction, Chamfer-L1 vs "
                     "CLEAN analytic surface; rnb_tpu_torch on "
                     f"{args.device}"),
        "card": "cpu" if args.device == "cpu" else card(),
        "all_accepted": all(r.get("accepted") for r in records.values()),
        "variants": records,
    })


if __name__ == "__main__":
    raise SystemExit(main())
