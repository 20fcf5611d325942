"""The check fails what it must: the control (the reference in the
program's place, one precision below the configuration's) and a run of the
harness with the timed path broken underneath, once for each fault a cell
can have, each read against the cell's own limits at a tiny size on the
CPU. The look for a card is skipped; the rest of the run is the harness's.

Faults: a step that returns its state unchanged; half of the batch left
out, the mean taken over the rest; an answer altered where it is produced.
The exchange between chips has no fault here: every cell runs on one."""

import pytest
import torch

from rnbbench import calibrate, compare, harness
from rnbbench import run as runmod
from rnbbench.tests.conftest import tiny
from rnb_tpu_torch.models import renderer
from rnb_tpu_torch.ops import marching_cubes
from rnb_tpu_torch.train import step as steplib

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4242
TRAIN = ("wmask_rnb.train.b4096", "womask_rnb_bg32.train.b4096")


@pytest.fixture
def short_slices():
    drv = harness.driver("train")
    ring = drv.RING
    drv.RING = 8
    yield
    drv.RING = ring


def _run(name):
    res = runmod.run_cell(tiny(name), SEED, 0.1, False, CPU, log=lambda s: None)
    return res["correct"], {k: v["value"] > v["limit"] for k, v in res["check"].items()}


@pytest.mark.parametrize("name", list(TRAIN) + ["wmask_rnb.render.b4096",
                                                "wmask_rnb.mesh.r512"])
def test_the_control_fails(name):
    cell = tiny(name)
    got = calibrate._control_readings(cell, SEED, CPU)["control"]
    correct, _ = compare.verdict(got, cell.limits["limits"])
    assert not correct, got


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged(name, monkeypatch, short_slices):
    def no_update(state, sched):
        lr = sched(state.step)
        state.step += 1
        return lr
    monkeypatch.setattr(steplib, "apply_update", no_update)
    correct, over = _run(name)
    assert not correct and over["grad_diff_gap"] and over["change_gap"]


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch(name, monkeypatch, short_slices):
    full = steplib._loss_terms

    def half(statics, rcfg, tcfg, params, batch, true_rgb, lights_dir, t_rand,
             t_out, step, warmup, no_albedo):
        h = batch.rays_o.shape[0] // 2
        per_ray = ("rays_o", "rays_d", "mask", "near", "far", "pixels_x", "pixels_y")
        b = batch._replace(**{f: getattr(batch, f)[:h] for f in per_ray})
        lights = lights_dir if lights_dir.shape[1] == 1 else lights_dir[:, :h]
        return full(statics, rcfg, tcfg, params, b, true_rgb[:, :h], lights,
                    t_rand[:h], None if t_out is None else t_out[:h], step,
                    warmup, no_albedo)
    monkeypatch.setattr(steplib, "_loss_terms", half)
    correct, over = _run(name)
    # a gradient of about the same norm in another direction
    assert not correct and over["grad_diff_gap"]


def _every_other(fn, spoil):
    calls = {"n": 0}

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls["n"] += 1
        return spoil(out) if calls["n"] % 2 == 0 else out
    return wrapped


def test_render_half_the_chunks(monkeypatch):
    def black(out):
        return {**out, "color_fine": torch.zeros_like(out["color_fine"])}
    monkeypatch.setattr(renderer, "render", _every_other(renderer.render, black))
    correct, over = _run("wmask_rnb.render.b4096")
    assert not correct and over["frame_gap"]


def test_render_colour_altered(monkeypatch):
    def brighter(out):
        return {**out, "color_fine": out["color_fine"] + 0.02}
    monkeypatch.setattr(renderer, "render", _every_other(renderer.render, brighter))
    correct, over = _run("wmask_rnb.render.b4096")
    assert not correct and over["frame_gap"]


def test_mesh_half_the_grid(monkeypatch):
    query = renderer.sdf_grid_query

    def half(*args, **kwargs):
        v = query(*args, **kwargs).clone()
        v[v.shape[0] // 2:] = 0.0
        return v
    monkeypatch.setattr(renderer, "sdf_grid_query", half)
    correct, over = _run("wmask_rnb.mesh.r512")
    assert not correct and over["grid_gap"]


def test_mesh_vertices_altered(monkeypatch):
    def moved(out):
        verts, tris = out
        return verts * 1.01, tris
    geo = marching_cubes.extract_geometry
    monkeypatch.setattr(marching_cubes, "extract_geometry",
                        lambda *a, **k: moved(geo(*a, **k)))
    correct, over = _run("wmask_rnb.mesh.r512")
    assert not correct and over["vertex_gap"]
