"""The port's parallel path against the JAX package's on the CPU.

The port runs in two ranks started by ``torch.distributed.run`` with gloo
(tests/torch_parallel_worker.py, which imports no JAX); JAX runs here on
two of the conftest's virtual CPU devices (``make_ray_mesh(2)``). Both
start from the same weights, and every rank gets the draws of its JAX
device, replayed from ``fold_in(fold_in(base_key, step), device)`` as
tests/test_torch_step.py replays the one-device step's. f32 everywhere:
the port's kernels run their plain versions.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rnb_tpu import config as jconfig
from rnb_tpu.data import dataset as jds
from rnb_tpu.models import fields as jfields
from rnb_tpu.models import renderer as jrnd
from rnb_tpu.parallel import data as jpdata
from rnb_tpu.parallel import mesh as jmesh
from rnb_tpu.parallel.grid import extract_fields_sharded as jextract_sharded
from rnb_tpu.parallel.train import (make_sharded_train_step,
                                    make_view_sharded_train_step)
from rnb_tpu.train import step as jstep
from rnb_tpu_torch import config as tconfig
from rnb_tpu_torch.data import dataset as tds
from rnb_tpu_torch.models import fields as tfields
from rnb_tpu_torch.models import renderer as trnd
from rnb_tpu_torch.parallel import data as tpdata
from rnb_tpu_torch.parallel import mesh as tmesh
from rnb_tpu_torch.train import step as tstep
from rnb_tpu_torch.utils import bridge

import torch_parallel_worker as wk

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
BASE_KEY = 42


def jax_device_draws(step, device, bsz, H, W, n_outside):
    """Device ``device``'s draws at ``step`` in the JAX sharded step: its
    key fold_in(fold_in(base_key, step), device) -> (k_ray, k_render);
    k_ray -> (kx, ky) pixels; k_render -> (kz, kout) -> t_rand, t_out."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(BASE_KEY),
                                                step), device)
    k_ray, k_render = jax.random.split(key)
    kx, ky = jax.random.split(k_ray)
    kz, kout = jax.random.split(k_render)
    d = {"px": np.asarray(jax.random.randint(kx, (bsz,), 0, W), np.int64),
         "py": np.asarray(jax.random.randint(ky, (bsz,), 0, H), np.int64),
         "t_rand": np.asarray(jax.random.uniform(kz, (bsz, 1)) - 0.5)}
    if n_outside:
        d["t_out"] = np.asarray(jax.random.uniform(kout, (bsz, n_outside)))
    return d


def global_draws(step):
    """The one_vs_two case's global draws: the port's generator, in the
    one-rank step's order, seeded by the step."""
    gen = torch.Generator().manual_seed(1000 + step)
    H, W = wk.SCENE["H"], wk.SCENE["W"]
    return dict(zip(("px", "py", "t_rand"), tstep.draws(gen, wk.B, H, W, 0)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's weights and draws in, the two ranks' results out."""
    d = tmp_path_factory.mktemp("parallel")
    params = jfields.init_model_bundle(jax.random.PRNGKey(0),
                                       wk.statics(jfields))
    inp = {f"param/{i}": np.asarray(a) for i, a in
           enumerate(bridge.tree_leaves(jax.device_get(params)))}
    H, W, bsz = wk.SCENE["H"], wk.SCENE["W"], wk.B // wk.WORLD
    for case, (_, n_outside, _, steps) in wk.CASES.items():
        for s in range(steps):
            for r in range(wk.WORLD):
                if case == "one_vs_two":
                    rows = slice(r * bsz, (r + 1) * bsz)
                    draws = {k: v[rows].numpy() for k, v in global_draws(s).items()}
                else:
                    draws = jax_device_draws(s, r, bsz, H, W, n_outside)
                for k, v in draws.items():
                    inp[f"{case}/{r}/{s}/{k}"] = v
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(wk.WORLD), WORKER, str(d / "in.npz"), str(d)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(wk.WORLD)]
    return params, ranks


def _leaves(out, case, name):
    return [out[f"{case}/{name}/{i}"] for i in range(
        sum(1 for k in out if k.startswith(f"{case}/{name}/")))]


def _ranks_bit_equal(ranks, case):
    """The parameters and moments stay equal bit for bit across ranks."""
    for name in ("param", "mu", "nu"):
        for a, b in zip(_leaves(ranks[0], case, name), _leaves(ranks[1], case, name)):
            np.testing.assert_array_equal(a, b, err_msg=f"{case} {name}")
    for s in range(wk.CASES[case][3]):
        np.testing.assert_array_equal(ranks[0][f"{case}/metrics/{s}"],
                                      ranks[1][f"{case}/metrics/{s}"])


def _state_close(out, case, jstate, lr):
    """Adam's moments within 5e-4 of JAX's, the parameters within 2·lr
    (where a gradient is ~0, a summation-order difference can flip an
    update of size lr), as tests/test_torch_step.py holds them.

    The JAX sharded steps differentiate a loss that is already psum'd
    inside ``shard_map(check_vma=False)``, where psum transposes to psum,
    and then psum the gradients again: their gradient is ``world`` times
    the exact one (Adam's update is invariant to that scale but for its
    eps). The port's is the exact gradient (``test_two_ranks_match_one_
    process``), so JAX's moments are held at mu/world and nu/world²."""
    w = wk.WORLD
    mu_j = jax.tree_util.tree_map(lambda m: m / w, jstate.opt_state[0].mu)
    nu_j = jax.tree_util.tree_map(lambda v: v / w ** 2, jstate.opt_state[0].nu)
    for a, b in zip(_leaves(out, case, "mu"), jax.tree_util.tree_leaves(mu_j)):
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-4 * scale)
    for a, b in zip(_leaves(out, case, "nu"), jax.tree_util.tree_leaves(nu_j)):
        np.testing.assert_allclose(np.sqrt(a), np.sqrt(b), rtol=5e-4,
                                   atol=5e-4 * (np.sqrt(b).max() + 1e-12))
    for a, b in zip(_leaves(out, case, "param"),
                    jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=2 * lr + 1e-7)


def _against_jax(run, case, make, arrays):
    params, ranks = run
    _, n_outside, warmup, steps = wk.CASES[case]
    rcfg, tcfg = wk.configs(jrnd.RendererConfig, jstep.TrainConfig, n_outside)
    fn = make(wk.statics(jfields), rcfg, tcfg, warmup=warmup, no_albedo=False,
              mesh=jmesh.make_ray_mesh(wk.WORLD), donate=False)
    jstate = jstep.init_train_state(params, tcfg)
    for s in range(steps):
        jstate, jm = fn(jstate, arrays, wk.view_of(case, s),
                        jax.random.PRNGKey(BASE_KEY))
        got = dict(zip(wk.METRICS, ranks[0][f"{case}/metrics/{s}"]))
        # JAX's sharded s_val divides the per-ray mean by the samples a ray
        # once more; the port's is the one-device step's
        got["s_val"] /= rcfg.n_samples + rcfg.n_importance
        for k in wk.METRICS:
            np.testing.assert_allclose(got[k], float(jm[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=f"{case} step {s} {k}")
    _state_close(ranks[0], case, jstate, float(jm["lr"]))
    _ranks_bit_equal(ranks, case)


@pytest.fixture(scope="module")
def jscene():
    return jds.make_sphere_scene(**wk.SCENE)


@pytest.mark.parametrize("n_views,world", [(3, 2), (5, 2), (8, 4), (7, 3), (6, 8)])
def test_view_blocks_equal_jax(n_views, world):
    """pad_views equals JAX's; the ranks' blocks, in rank order, equal the
    view list of JAX's one process owning every device, and tile the
    padded order."""
    order = tpdata.pad_views(n_views, world)
    assert order == jpdata.pad_views(n_views, world)
    blocks = [tpdata.host_local_view_indices(n_views, r, world)
              for r in range(world)]
    assert len({len(b) for b in blocks}) == 1
    assert sum(blocks, []) == order == jpdata.host_local_view_indices(
        n_views, jmesh.make_ray_mesh(world))
    assert set(order) == set(range(n_views))


@pytest.mark.parametrize("case", ["wmask_warmup", "wmask_main", "womask_warmup",
                                  "womask_main"])
def test_sharded_step_matches_jax(run, jscene, case):
    _against_jax(run, case, make_sharded_train_step, jscene.arrays)


def test_view_sharded_step_matches_jax(run, jscene):
    """3 views padded to 4: rank r trains its local view slot % 2 of block
    r of [0, 1, 2, 0]; JAX device r the same."""
    arrays = jpdata.shard_views(jscene.arrays, jmesh.make_ray_mesh(wk.WORLD))
    _against_jax(run, "view_sharded", make_view_sharded_train_step, arrays)


def test_shard_views_takes_the_rank_block():
    scene = tds.make_sphere_scene(**wk.SCENE, device="cpu")
    for r, block in enumerate(([0, 1], [2, 0])):
        got = tpdata.shard_views(scene, r, 2)
        for a, b in zip(got, scene.arrays):
            np.testing.assert_array_equal(a.numpy(), b[block].numpy())


def test_sharded_grid_matches_serial_and_jax(run):
    params, ranks = run
    g = wk.GRID
    bmin, bmax = np.array([-g["bound"]] * 3), np.array([g["bound"]] * 3)
    np.testing.assert_array_equal(ranks[0]["grid"], ranks[1]["grid"])
    tparams = bridge.params_from_numpy(jax.device_get(params), device="cpu")
    serial = trnd.extract_fields(wk.statics(tfields), tparams, bmin, bmax,
                                 g["resolution"])
    np.testing.assert_allclose(ranks[0]["grid"], serial, atol=1e-5)
    jgrid = jextract_sharded(wk.statics(jfields), params, bmin, bmax,
                             g["resolution"], jmesh.make_ray_mesh(wk.WORLD),
                             chunk=g["chunk"])
    # the JAX query keeps f32; the port's is fetched as f16
    np.testing.assert_allclose(ranks[0]["grid"], jgrid, atol=2e-3, rtol=1e-3)


def test_two_ranks_match_one_process(run):
    """The sharded step on rows [r·B/2, (r+1)·B/2) of a global draw against
    the one-rank step on all of it: the same numbers up to the order of the
    sums."""
    params, ranks = run
    _, n_outside, warmup, steps = wk.CASES["one_vs_two"]
    rcfg, tcfg = wk.configs(trnd.RendererConfig, tstep.TrainConfig, n_outside,
                            kernel_prec="f32")
    fn = tstep.make_train_step(wk.statics(tfields), rcfg, tcfg, warmup=warmup,
                               no_albedo=False)
    scene = tds.make_sphere_scene(**wk.SCENE, device="cpu")
    state = tstep.init_train_state(
        bridge.params_from_numpy(jax.device_get(params), device="cpu"))
    for s in range(steps):
        state, m = fn(state, scene.arrays, wk.view_of("one_vs_two", s),
                      **global_draws(s))
        got = ranks[0][f"one_vs_two/metrics/{s}"]
        want = np.array([float(m[k]) for k in wk.METRICS])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9,
                                   err_msg=f"step {s}")
    lr = float(m["lr"])
    for a, b in zip(_leaves(ranks[0], "one_vs_two", "param"),
                    bridge.tree_leaves(bridge.params_to_numpy(state.params))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=2 * lr + 1e-7)
    _ranks_bit_equal(ranks, "one_vs_two")


@pytest.mark.parametrize("device,local_world,cards,asked,want", [
    ("cpu", 2, 0, "", "gloo"),
    ("cuda", 2, 1, "", "gloo"),          # two ranks share the one card
    ("cuda", 2, 2, "", "nccl"),
    ("cuda", 2, 2, "gloo", "gloo"),
    ("cuda", 2, 1, "nccl", "RNB_DIST_BACKEND=gloo"),
    ("cpu", 1, 0, "nccl", "RNB_DIST_BACKEND=gloo"),
])
def test_backend_rule(monkeypatch, device, local_world, cards, asked, want):
    """RNB_DIST_BACKEND first; else NCCL with a card a rank, gloo on the
    CPU or when ranks share a card; NCCL asked for where it cannot run
    raises, naming the way out."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    monkeypatch.setenv("RNB_DIST_BACKEND", asked)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if want.startswith("RNB_"):
        with pytest.raises(ValueError, match=want):
            tmesh.choose_backend(device)
    else:
        assert tmesh.choose_backend(device) == want


def test_from_conf_view_subset_equals_jax(tmp_path):
    """Dataset.from_conf(view_subset=...) loads the listed views in order,
    repeats allowed, as the JAX package's, and records them."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_synthetic_case import write_case
    write_case(str(tmp_path / "c"), n_views=4, H=16, W=16, radius=0.4)
    text = (f"data_dir = {tmp_path / 'c'}\nnormal_dir = normal\n"
            "albedo_dir = albedo\nmask_dir = mask\n"
            "render_cameras_name = cameras.npz\nobject_cameras_name = cameras.npz\n")
    sub = [3, 1, 3]
    j = jds.Dataset.from_conf(jconfig.parse_string(text), view_subset=sub)
    t = tds.Dataset.from_conf(tconfig.parse_string(text), device="cpu",
                              view_subset=sub)
    assert t.global_view_indices == sub == j.global_view_indices
    assert t.n_images_global == 4 == j.n_images_global and t.n_images == 3
    for a, b in zip(t.arrays, j.arrays):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)
    assert t.normal_files == j.normal_files
