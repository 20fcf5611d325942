"""The plain reference against the program's CPU path at a tiny size, with
the program's products in float32 (``kernel_prec`` and the up-sampling's
``upsample_precision``): what the reference computes again (the maps, the
lights and targets, the draws, the rays, the weight-norm fold, the renderer,
the loss, the gradients and Adam, the frame, the grid) is what the program
computes, to float32 rounding."""

import pytest
import torch

from rnbbench import harness
from rnbbench import run as runmod
from rnbbench.tests.conftest import tiny

F32 = ['model.neus_renderer.kernel_prec="f32"', 'train.upsample_precision="f32"']


def numbers(cell, seed):
    """Every number the cell's check computes, compared or not."""
    ctx = runmod.Ctx(cell, seed, 0.1, torch.device("cpu"), harness.run_dir())
    drv = harness.driver(cell.traffic["mode"])
    try:
        return drv.check(ctx, drv.setup(ctx))
    finally:
        harness.remove(ctx.work_dir)


@pytest.fixture
def short_slices():
    drv = harness.driver("train")
    ring = drv.RING
    drv.RING = 8
    yield
    drv.RING = ring


@pytest.mark.parametrize("name, change, diff", [
    ("wmask_rnb.train.b4096", 1e-4, 5e-4),
    ("womask_rnb_bg32.train.b4096", 2e-3, 5e-3)])
def test_training_steps(name, change, diff, short_slices):
    got = numbers(tiny(name, sets=F32), 31)
    # change: Adam's first updates are lr * m / (sqrt(v) + 1e-8) with lr
    # 1e-7 and 2e-7; a leaf's change of ~1e-7 sits a few float32 steps above
    # its values, so it reads the rounding of the parameters. diff: the
    # worst matrix's difference reads float32 summation order in a layer
    # whose gradient nearly cancels (a NeRF trunk layer without masks)
    assert got["loss_gap"] < 1e-5 and got["grad_median_gap"] < 1e-5
    assert got["grad_diff_gap"] < diff
    assert got["change_gap"] < change


def test_novel_view_frame():
    res = runmod.run_cell(tiny("wmask_rnb.render.b4096", sets=F32), 32, 0.1, False,
                          torch.device("cpu"), log=lambda s: None)
    # beyond the 8-bit frame's own rounding: float32 rounding alone
    assert res["check"]["frame_gap"]["value"] < 1e-3


def test_grid_and_mesh():
    res = runmod.run_cell(tiny("wmask_rnb.mesh.r512"), 33, 0.1, False,
                          torch.device("cpu"), log=lambda s: None)
    # float16 fetch of values within 0.05 of the surface; a 32^3 grid's
    # linear interpolation across a cell of 0.065
    assert res["check"]["grid_gap"]["value"] < 3e-5
    assert res["check"]["vertex_gap"]["value"] < 4e-3
