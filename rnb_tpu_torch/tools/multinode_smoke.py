"""Two-node run of the port's command line on one host (the port's
counterpart of ``tools/multihost_smoke.py`` and its launcher in
``tests/test_multihost.py``):

    python -m rnb_tpu_torch.tools.multinode_smoke --case DATA_DIR
        [--conf confs/wmask_rnb.conf] [--set PATH=VALUE ...]
        [--device cuda|cpu]

Each two-node run starts two ``torch.distributed.run --nnodes 2
--node_rank {0,1} --nproc_per_node 1`` launchers at once, with static
rendezvous on a free localhost port; each starts one rank of
``python -m rnb_tpu_torch.cli --mode train_rnb``. The runs, under
``exp/multinode`` in the current directory, and what is checked:

  * ``one``: one process, no group: the reference;
  * ``two``: two nodes on replicated data: every step's loss within 1e-5
    relative of ``one``'s, the ranks' ``params_sha256`` equal, and the
    chief's files once (one ``meta`` record and each step once in
    ``logs/scalars.jsonl``, the checkpoints, one mesh). On the card
    ``one`` and ``two`` run at learning rate 0: the kernels' bf16 operands
    round the weights, so two ranks, which sum the gradient in another
    order than one process, drift apart from step 3 at the conf's rate;
  * ``shard``: two nodes with ``train.view_shard=true`` at the conf's
    rate: each node's output holds the view-loading line of its own ranks
    only, each naming that rank's block of the views
    (``parallel/data.py``), the ranks' parameters equal;
  * ``resume``: ``shard`` stopped at step 3 with a checkpoint, then two
    fresh nodes with ``--is_continue`` to step 6: both nodes log
    ``Find checkpoint``, every step's loss within 1e-6 relative of
    ``shard``'s and the final parameters ``shard``'s bit for bit (the
    same ranks sum in the same order). Step 3 lies inside the conf's
    learning-rate ramp (``warm_up_end``), where the rate does not depend
    on ``end_iter``.

The schedule is 6 steps, 3 of them in warm-up, a checkpoint every 3
steps, no validation, a 16^3 mesh; ``--set`` flags come after it and win;
a run may take 300 s. Two
ranks that share a card need ``RNB_DIST_BACKEND=gloo``: each node counts one
local rank, so the backend rule (``parallel/mesh.py``) picks NCCL, which
refuses two ranks on one device. Prints one JSON line (the checks'
numbers, every rank's kernel launches summed); any failed check exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import socket
import subprocess
import sys

from rnb_tpu_torch.parallel.data import host_local_view_indices
from rnb_tpu_torch.tools.run_e2e import (loss_segments, result_lines,
                                          subprocess_env)
from rnb_tpu_torch.tools.run_parity_matrix import ROOT

TOL, RESUME_TOL = 1e-5, 1e-6
STEPS, SAVE, WORLD = 6, 3, 2
WORK = os.path.join("exp", "multinode")
RUN_TIMEOUT = 300.0
VIEWS_RE = re.compile(r"rank (\d+) of (\d+) loads global views (\[[\d, ]*\])")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Smoke:
    def __init__(self, args):
        self.args = args
        self.launches = {}

    def _cli(self, exp, extra):
        a = self.args
        sets = [f"dataset.data_dir={a.case}", f"general.base_exp_dir={exp}",
                f"train.end_iter={STEPS}", f"train.warm_up_iter={STEPS // 2}",
                f"train.save_freq={SAVE}", "train.val_freq=1000000",
                "train.val_mesh_freq=1000000", f"train.report_freq={STEPS}",
                *a.overrides]
        return ["-m", "rnb_tpu_torch.cli", "--mode", "train_rnb", "--conf",
                a.conf, "--device", a.device, "--mesh_resolution", "16",
                *(x for s in sets for x in ("--set", s)), *extra]

    def _done(self, procs, name):
        """Wait for ``procs`` -> their outputs; any failure raises."""
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=RUN_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, out in zip(procs, outs):
            if p.returncode != 0:
                raise SystemExit(f"multinode_smoke: {name} exited "
                                 f"{p.returncode}:\n{out[-6000:]}")
        for line in (l for out in outs for l in result_lines(out)):
            for k, v in line["launches"].items():
                self.launches[k] = self.launches.get(k, 0) + v
        return outs

    def one(self, name, extra=()):
        exp = os.path.join(WORK, name)
        p = subprocess.Popen([sys.executable, *self._cli(exp, list(extra))],
                             env=subprocess_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        self._done([p], name)
        return exp

    def two(self, name, extra=(), exp=None):
        """Two nodes on this host -> (the experiment, each node's output,
        every rank's result line)."""
        exp = exp or os.path.join(WORK, name)
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--nnodes", str(WORLD),
             "--node_rank", str(node), "--nproc_per_node", "1",
             "--master_addr", "localhost", "--master_port", str(port),
             *self._cli(exp, list(extra))],
            env=subprocess_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for node in range(WORLD)]
        outs = self._done(procs, name)
        lines = [l for out in outs for l in result_lines(out)]
        check(sorted(l["rank"] for l in lines) == list(range(WORLD))
              and {l["world"] for l in lines} == {WORLD},
              f"{name}: the result lines of {WORLD} ranks")
        check(len({l["params_sha256"] for l in lines}) == 1,
              f"{name}: the ranks' parameters differ")
        return exp, outs, lines


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"multinode_smoke: check failed: {what}")


def losses(exp) -> dict:
    """The one process's (or chief's) per-step losses; the stream must
    hold exactly one process's records."""
    segs = loss_segments(os.path.join(exp, "logs", "scalars.jsonl"))
    check(len(segs) == 1, f"{exp}: {len(segs)} writers of scalars.jsonl")
    return segs[0]


def rel_diff(got: dict, ref: dict, tol: float, what: str) -> float:
    check(sorted(got) == sorted(ref), f"{what}: steps {sorted(got)}")
    d = max(abs(got[s] - ref[s]) / max(abs(ref[s]), 1e-30) for s in ref)
    check(d <= tol, f"{what}: relative loss difference {d:.3e} > {tol:g}")
    return d


def run(args) -> dict:
    smoke = Smoke(args)
    steps = list(range(1, STEPS + 1))
    frozen = ["--set", "train.learning_rate=0"] if args.device == "cuda" else []
    ref = losses(smoke.one("one", frozen))
    check(sorted(ref) == steps, f"one: steps {sorted(ref)}")

    two, _, _ = smoke.two("two", frozen)
    res = {"two_vs_one": rel_diff(losses(two), ref, TOL, "two nodes vs one process")}
    with open(os.path.join(two, "logs", "scalars.jsonl")) as f:
        recs = [json.loads(l) for l in f]
    check(sum("meta" in r for r in recs) == 1
          and sorted(r["step"] for r in recs if "Loss/loss" in r) == steps,
          "two: one scalar stream, each step once")
    ckpts = sorted(os.listdir(os.path.join(two, "checkpoints")))
    want = sorted({f"ckpt_{s:06d}.npz" for s in steps if s % SAVE == 0}
                  | {f"ckpt_{STEPS:06d}.npz"})
    check(ckpts == want, f"two: checkpoints {ckpts}, not {want}")
    check(len(os.listdir(os.path.join(two, "meshes"))) == 1, "two: one mesh")

    shard = ["--set", "train.view_shard=true"]
    shard_exp, outs, lines = smoke.two("shard", shard)
    n_views = len(os.listdir(os.path.join(args.case, "normal")))
    views = {}
    for node, out in enumerate(outs):      # rank r is node r's one rank
        found = {int(r): json.loads(v) for r, _, v in VIEWS_RE.findall(out)}
        check(list(found) == [node],
              f"shard: node {node} logged the views of ranks {sorted(found)}")
        check(found[node] == host_local_view_indices(n_views, node, WORLD),
              f"shard: rank {node} loaded views {found[node]}")
        views.update(found)
    res["shard_views"] = views

    exp = os.path.join(WORK, "resume")
    smoke.two("resume_leg1", [*shard, "--set", f"train.end_iter={SAVE}"], exp)
    check(os.path.isfile(os.path.join(exp, "checkpoints", f"ckpt_{SAVE:06d}.npz")),
          f"resume: no step-{SAVE} checkpoint")
    _, outs, leg2 = smoke.two("resume_leg2", [*shard, "--is_continue"], exp)
    check(all(f"Find checkpoint: ckpt_{SAVE:06d}.npz" in out for out in outs),
          "resume: a node did not load the checkpoint")
    segs = loss_segments(os.path.join(exp, "logs", "scalars.jsonl"))
    check(len(segs) == 2 and sorted(segs[0]) == steps[:SAVE],
          "resume: one scalar stream a leg, the first to the checkpoint")
    res["resume_vs_straight"] = rel_diff(
        {**segs[0], **segs[1]}, losses(shard_exp), RESUME_TOL,
        "the stopped and resumed nodes vs the straight two-node run")
    check(leg2[0]["params_sha256"] == lines[0]["params_sha256"],
          "resume: final parameters differ from the straight run's")
    res["launches"] = smoke.launches
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description="two-node smoke of the port")
    ap.add_argument("--case", required=True, help="an IDR case directory")
    ap.add_argument("--conf", default=os.path.join(ROOT, "confs", "wmask_rnb.conf"))
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="PATH=VALUE", help="conf override (repeatable)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if os.path.isdir(WORK):
        shutil.rmtree(WORK)
    res = run(args)
    print(json.dumps({"nodes": WORLD, "device": args.device, "steps": STEPS,
                      **res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
