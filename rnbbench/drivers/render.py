"""Novel-view cells: ``Runner.render_novel_image`` frames back to back.

The frames follow ``interpolate_view``'s path between the traffic's two
views (``n_frames`` ratios on a sine ramp, then again from the first) at
its resolution level, each rendered in chunks of ``train.batch_size`` rays
with the last one padded, and fetched to the host as 8-bit. Set-up renders
``warm_frames`` frames. Each frame is timed from its call to its image on
the host; ``frame_ms`` is the window's seconds over its frames and
``frame_ms_p90`` the 90th percentile of the frame times.

After the window ``check_frames`` frames drawn from the seed among those
the window finished are rendered again by the reference and compared.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from rnbbench import compare, harness, weights
from rnbbench.reference import data as rdata
from rnbbench.reference import neus


@dataclasses.dataclass
class State:
    prog: harness.Program
    ratios: list
    frames: list = dataclasses.field(default_factory=list)   # (ratio, uint8 image)
    done: int = 0


def _ratios(n: int) -> list:
    return [float(np.sin(((i / n) - 0.5) * np.pi) * 0.5 + 0.5) for i in range(n)]


def _frame(ctx, state: State):
    t = ctx.cell.traffic
    ratio = state.ratios[state.done % len(state.ratios)]
    state.done += 1
    img = state.prog.runner.render_novel_image(t["views"][0], t["views"][1], ratio,
                                               t["resolution_level"])
    return ratio, img


def setup(ctx) -> State:
    t = ctx.cell.traffic
    prog = harness.start_program(ctx.cell, ctx.seed, ctx.device, ctx.work_dir, "render")
    state = State(prog=prog, ratios=_ratios(t["n_frames"]))
    for _ in range(t["warm_frames"]):
        _frame(ctx, state)
    state.done = 0
    harness.synchronize(ctx.device)
    return state


def window(ctx, state: State) -> dict:
    times = []
    t0 = time.perf_counter()
    while True:
        t1 = time.perf_counter()
        state.frames.append(_frame(ctx, state))
        t2 = time.perf_counter()
        times.append(t2 - t1)
        if t2 - t0 >= ctx.seconds:
            break
    secs = time.perf_counter() - t0
    return {"attempted": len(times), "failed": 0,
            "metrics": {"frame_ms": secs / len(times) * 1e3,
                        "frame_ms_p90": float(np.percentile(times, 90)) * 1e3}}


def traced_window(ctx, state: State, trace_path: str):
    n = ctx.cell.traffic["trace_frames"]
    with harness.cell_spans(ctx.cell) as spans, harness.traced(ctx.device, trace_path) as info:
        for _ in range(n):
            state.frames.append(_frame(ctx, state))
    rays = len(state.frames[-1][1].reshape(-1, 3))
    return n, rays, spans, info


def sampled(seed: int, n_done: int, k: int) -> list:
    rng = np.random.default_rng([seed, 17])
    return sorted(rng.choice(n_done, size=min(k, n_done), replace=False).tolist())


def check(ctx, state: State) -> dict:
    t = ctx.cell.traffic
    picks = [state.frames[i] for i in sampled(ctx.seed, len(state.frames),
                                              t["check_frames"])]
    scene, conf = state.prog.scene, state.prog.conf
    state.prog, state.frames = None, []
    harness.free(ctx.device)
    gaps = [compare.frame_gap(img, ref)
            for (ratio, img), ref in zip(picks, reference_frames(
                conf, scene, ctx.seed, ctx.device, t, [r for r, _ in picks], "f32"))]
    return {"frame_gap": max(gaps)}


def reference_frames(conf, scene, seed, device, traffic, ratios, prec) -> list:
    """The reference's colours [H', W', 3] of the frames at ``ratios``."""
    cfg = neus.config(conf)
    P = weights.make(conf["model"], seed, device)
    bsz = conf["train"]["batch_size"]
    t_rand, t_out = rdata.render_draws(seed, bsz, cfg["renderer"]["n_outside"], device)
    H, W = scene.mask_codes.shape[1:]
    level = traffic["resolution_level"]
    v0, v1 = traffic["views"]
    out = []
    with neus.exact_f32():
        for ratio in ratios:
            o, d = rdata.rays_between(scene, v0, v1, ratio, level, H, W, device)
            rows = torch.arange(o.shape[0], device=device) % bsz
            cols = []
            for s in range(0, o.shape[0], bsz):
                r = rows[s:s + bsz]
                cols.append(neus.render_rays(
                    cfg, P, o[s:s + bsz], d[s:s + bsz], t_rand[r],
                    None if t_out is None else t_out[r],
                    neus.cos_anneal(cfg["train"], 0), prec))
            out.append(torch.cat(cols).reshape(H // level, W // level, 3))
    return out
