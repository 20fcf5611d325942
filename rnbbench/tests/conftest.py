"""Fixtures of the harness's CPU tests: cells of BENCHMARK.json cut to a size
the CPU runs in seconds (3 views of 48x40, 64 rays, a 32^3 grid), and the
card's fixture, which skips without CUDA."""

import pytest
import torch

from rnbbench import harness


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


def tiny(name: str, batch: int = 64, sets=()) -> harness.Cell:
    """The cell ``name`` with its capture, batch and check cut down; its
    widths, samples and limits as they are."""
    c = harness.load_cell(name)
    c.config["data"].update(n_views=3, height=40, width=48,
                            focal=c.config["data"]["focal"] * 48 / 612)
    c.traffic["sets"] = [s for s in c.traffic["sets"]
                         if not s.startswith("train.batch_size")]
    c.traffic["sets"] += [f"train.batch_size={batch}", *sets]
    mode = c.traffic["mode"]
    if mode == "mesh":
        c.traffic.update(resolution=32, warm_resolution=16, check_points=4096,
                         check_vertices=512)
    elif mode == "render":
        c.traffic.update(check_frames=2, trace_frames=1, warm_frames=1)
    elif mode == "train":
        c.traffic.update(ref_block=32)
    return c


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells time the card")
    return torch.device("cuda", 0)
