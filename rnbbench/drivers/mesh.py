"""Mesh cells: ``Runner.validate_mesh`` at the traffic's resolution, in
world space, back to back.

Set-up extracts one mesh at ``warm_resolution`` (the grid query runs in
64^3-point chunks, so a 64^3 grid warms the one chunk shape, and the
marching-cubes library loads). The window starts whole extractions until
``--seconds`` have passed; ``mesh_s`` is their total time over their count.
The driver's span around the program's marching cubes keeps the last
grid; the last mesh's vertices are kept as the window got them.

After the window the reference evaluates the SDF at ``check_points`` grid
points drawn from the seed and at ``check_vertices`` vertices of the last
mesh, taken back to normalized space by the capture's scale matrix.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from rnbbench import harness, weights
from rnbbench.reference import neus


# the program's marching cubes, whose input grid the check reads
MARCHING_CUBES = harness.Boundary("rnb_tpu_torch.ops.marching_cubes", "extract_geometry")


@dataclasses.dataclass
class State:
    prog: harness.Program
    grid: object = None
    vertices: object = None


def _mesh(state: State, resolution: int, world_space: bool):
    with harness.Spans([MARCHING_CUBES], keep=[MARCHING_CUBES]) as spans:
        verts, _ = state.prog.runner.validate_mesh(world_space=world_space,
                                                   resolution=resolution)
    state.grid = spans.last[MARCHING_CUBES.range][0][0]
    state.vertices = verts
    return spans


def setup(ctx) -> State:
    t = ctx.cell.traffic
    prog = harness.start_program(ctx.cell, ctx.seed, ctx.device, ctx.work_dir, "mesh")
    state = State(prog=prog)
    _mesh(state, t["warm_resolution"], t["world_space"])
    harness.synchronize(ctx.device)
    return state


def window(ctx, state: State) -> dict:
    t = ctx.cell.traffic
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        _mesh(state, t["resolution"], t["world_space"])
        n += 1
    secs = time.perf_counter() - t0
    return {"attempted": n, "failed": 0, "metrics": {"mesh_s": secs / n}}


def traced_window(ctx, state: State, trace_path: str):
    t = ctx.cell.traffic
    n = t["trace_meshes"]
    spans = harness.cell_spans(ctx.cell, extra=[MARCHING_CUBES], keep=[MARCHING_CUBES])
    with spans, harness.traced(ctx.device, trace_path) as info:
        for _ in range(n):
            verts, _ = state.prog.runner.validate_mesh(
                world_space=t["world_space"], resolution=t["resolution"])
    state.grid, state.vertices = spans.last[MARCHING_CUBES.range][0][0], verts
    return n, t["resolution"] ** 3, spans, info


def grid_points(idx: torch.Tensor, resolution: int, bmin, bmax) -> torch.Tensor:
    """Coordinates of the flat grid indices ``idx`` ([x, y, z] "ij" order)."""
    r = resolution
    ijk = torch.stack([idx // (r * r), (idx // r) % r, idx % r], -1).double()
    lo = torch.tensor(bmin, dtype=torch.float64, device=idx.device)
    hi = torch.tensor(bmax, dtype=torch.float64, device=idx.device)
    return (lo + ijk * (hi - lo) / (r - 1)).float()


def check(ctx, state: State) -> dict:
    t = ctx.cell.traffic
    r = t["resolution"]
    grid, verts = np.asarray(state.grid), np.asarray(state.vertices)
    scene, conf = state.prog.scene, state.prog.conf
    state.prog = state.grid = state.vertices = None
    harness.free(ctx.device)
    rng = np.random.default_rng([ctx.seed, 23])
    flat = rng.choice(r ** 3, size=min(t["check_points"], r ** 3), replace=False)
    vsel = rng.choice(len(verts), size=min(t["check_vertices"], len(verts)),
                      replace=False) if len(verts) else np.zeros(0, np.int64)
    prog_vals = torch.as_tensor(grid.reshape(-1)[flat], dtype=torch.float64)
    ref_vals, ref_at_verts = reference(conf, scene, ctx.seed, ctx.device, t,
                                       flat, verts[vsel], "f32")
    band = ref_vals.abs() < t["band"]
    grid_gap = float((prog_vals[band] - ref_vals[band]).abs().max()) if band.any() else float("inf")
    vertex_gap = float(ref_at_verts.abs().max()) if len(vsel) else float("inf")
    return {"grid_gap": grid_gap, "vertex_gap": vertex_gap}


BBOX = ([-1.01, -1.01, -1.01], [1.01, 1.01, 1.01])


def reference(conf, scene, seed, device, traffic, flat, world_verts, prec):
    """(-sdf at the grid indices ``flat``, sdf at the world-space vertices
    taken back by the capture's scale matrix), float64 on the host."""
    cfg = neus.config(conf)
    P = weights.make(conf["model"], seed, device)
    idx = torch.as_tensor(flat, device=device)
    S = scene.scale_mat
    x = (np.asarray(world_verts, np.float64) - S[:3, 3]) / S[0, 0]
    out = []
    with neus.exact_f32():
        for pts in (grid_points(idx, traffic["resolution"], *BBOX),
                    torch.as_tensor(x, dtype=torch.float32, device=device)):
            vals = [neus.sdf_values(cfg, P, pts[s:s + 262144], prec)
                    for s in range(0, pts.shape[0], 262144)]
            out.append(torch.cat(vals).double().cpu() if vals else torch.zeros(0, dtype=torch.float64))
    return -out[0], out[1]
