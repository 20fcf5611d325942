"""Training cells: ``Runner.train_rnb`` from step 0, in slices that end on
the runner's 64-step fetch of the step metrics, until the window ends.

Set-up builds the one runner of the run on the seeded capture and weights
and drives it through the traffic's ``check_steps`` first steps by the
window's own call (``train_rnb``) and feed (its own draws), keeping what
the check compares: the logged losses, Adam's first moment after step 1
and the parameters after the last check step. ``warm_steps`` more steps
follow; then the window runs whole slices until ``--seconds`` have passed
and ends on a synchronise. ``train_rays_per_s`` is every ray of every step
of the window over its seconds. The traced run first trains to the next
slice's start, then traces one whole slice, as the window runs it.

After the window the runner is freed and the reference trains the same
steps from the same weights and draws (``reference.neus.train_steps``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import torch

from rnbbench import compare, harness, weights
from rnbbench.reference import neus

RING = 64


@dataclasses.dataclass
class State:
    prog: harness.Program
    bsz: int
    step: int = 0
    losses: list = dataclasses.field(default_factory=list)
    grads: dict = dataclasses.field(default_factory=dict)
    change_norms: dict = dataclasses.field(default_factory=dict)


def _advance(state: State, to: int) -> None:
    """Train through step ``to`` by ``train_rnb``, which stops at
    ``end_iter``."""
    runner = state.prog.runner
    full = runner.tcfg
    runner.tcfg = dataclasses.replace(full, end_iter=to)
    try:
        runner.train_rnb()
    finally:
        runner.tcfg = full
    state.step = runner.iter_step


def setup(ctx) -> State:
    t = ctx.cell.traffic
    prog = harness.start_program(ctx.cell, ctx.seed, ctx.device, ctx.work_dir,
                                 "train_rnb")
    runner = prog.runner
    # the step functions take the learning-rate schedule of the conf's
    # end_iter: build them before the slices shorten it
    runner._get_step_fn(0 < runner.tcfg.warm_up_iter)
    state = State(prog=prog, bsz=runner.tcfg.batch_size)
    p0 = {k: v.detach().clone() for k, v in neus.leaves(runner.state.params)}

    _advance(state, 1)
    opt = runner.state.optimizer
    first = {}
    for k, p in neus.leaves(runner.state.params):
        m = opt.state.get(p, {}).get("exp_avg")
        first[k] = torch.zeros_like(p) if m is None else m.detach() / (1.0 - 0.9)
    state.grads = {k: v.float().cpu() for k, v in first.items()}
    _advance(state, t["check_steps"])
    state.change_norms = compare.leaf_norms(
        (k, v.detach() - p0[k]) for k, v in neus.leaves(runner.state.params))
    state.losses = _logged_losses(runner.base_exp_dir, t["check_steps"])
    del p0, first
    _advance(state, t["check_steps"] + t["warm_steps"])
    harness.synchronize(ctx.device)
    return state


def _logged_losses(exp_dir: str, n: int) -> list:
    """The losses of steps 1..n as the runner logged them."""
    out = {}
    with open(os.path.join(exp_dir, "logs", "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "Loss/loss" in rec and 1 <= rec["step"] <= n:
                out[rec["step"]] = rec["Loss/loss"]
    return [out.get(s, float("nan")) for s in range(1, n + 1)]


def _next_stop(step: int) -> int:
    return (step // RING + 1) * RING


def window(ctx, state: State) -> dict:
    start = state.step
    t0 = time.perf_counter()
    while True:
        _advance(state, _next_stop(state.step))
        harness.synchronize(ctx.device)
        secs = time.perf_counter() - t0
        if secs >= ctx.seconds:
            break
    steps = state.step - start
    return {"attempted": steps, "failed": 0,
            "metrics": {"train_rays_per_s": steps * state.bsz / secs}}


def traced_window(ctx, state: State, trace_path: str):
    _advance(state, _next_stop(state.step))
    start = state.step
    with harness.cell_spans(ctx.cell) as spans, harness.traced(ctx.device, trace_path) as info:
        _advance(state, _next_stop(state.step))
    return state.step - start, state.bsz, spans, info


def check(ctx, state: State) -> dict:
    """Free the program, train the reference and compare."""
    prog = {"losses": state.losses, "grads": state.grads,
            "change_norms": state.change_norms}
    scene, conf = state.prog.scene, state.prog.conf
    state.prog = None
    harness.free(ctx.device)
    ref = reference(conf, scene, ctx.seed, ctx.device, ctx.cell.traffic, "f32")
    for kind, (gap, leaf) in compare.worst_leaf(prog, ref).items():
        print(f"worst leaf of the first gradient by {kind}: {leaf} {gap}",
              file=sys.stderr, flush=True)
    return compare.training_gaps(prog, ref)


def reference(conf, scene, seed, device, traffic, prec) -> dict:
    """The reference's losses, first gradient and change norms."""
    P = weights.make(conf["model"], seed, device)
    p0 = {k: v.detach().clone() for k, v in neus.leaves(P)}
    losses, grad1 = neus.train_steps(neus.config(conf), P, scene, seed,
                                     traffic["check_steps"], prec, device,
                                     block=traffic["ref_block"])
    return {"losses": losses,
            "grads": {k: v.float().cpu() for k, v in grad1.items()},
            "change_norms": compare.leaf_norms(
                (k, v.detach() - p0[k]) for k, v in neus.leaves(P))}
