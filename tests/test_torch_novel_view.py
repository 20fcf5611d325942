"""The port's inference path against the JAX package on the CPU, at a small
width (SDF 4x64, albedo 2x32, NeRF 4x64) on 8x8 images: ``render`` with and
without the background NeRF and a background colour, ``gen_rays_between``,
and the runner's ``render_novel_image``, ``_vertex_albedo``,
``validate_mesh_texture`` and ``validate_image_ps`` on one disk case and one
checkpoint (each package loads the other's); the AVI writer and reader, the
three CLI modes on a 1-step case, the ``compare_images`` tool and the
training loop's trace window.

The port runs the plain versions of its kernels at f32 operands
(``kernel_prec = f32``), both packages up-sample at f32, and the runners
render at ``perturb = 0`` (JAX threefry and torch Philox never agree).
"""

import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rnb_tpu.data import cameras as jcam
from rnb_tpu.data import dataset as jds
from rnb_tpu.models import fields as jfields
from rnb_tpu.models import renderer as jrnd
from rnb_tpu.train.runner import Runner as JRunner
from rnb_tpu.utils import checkpoint as jckpt
from rnb_tpu_torch.models import fields as tfields
from rnb_tpu_torch.models import renderer as trnd
from rnb_tpu_torch.tools import compare_images as tcompare
from rnb_tpu_torch.train.runner import Runner as TRunner
from rnb_tpu_torch.utils import bridge
from rnb_tpu_torch.utils import io as tio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import compare_images as jcompare  # noqa: E402
import make_synthetic_case as jcase  # noqa: E402

torch.set_num_threads(1)

SDF = dict(d_out=65, d_hidden=64, n_layers=4, skip_in=(2,), multires=4)
COLOR = dict(d_feature=64, d_hidden=32, n_layers=2, multires_view=2)
NERF = dict(D=4, W=64, multires=4, multires_view=2, skips=(2,))

CONF = """
general {{
    base_exp_dir = {exp_dir}
    recording = []
}}
dataset {{
    data_dir = {data_dir}
    normal_dir = normal
    albedo_dir = albedo
    mask_dir = mask
    render_cameras_name = cameras.npz
    object_cameras_name = cameras.npz
}}
train {{
    learning_rate = 5e-4,
    learning_rate_alpha = 0.05,
    end_iter = {end_iter},
    warm_up_iter = {warm_up_iter},
    batch_size = 48,
    validate_resolution_level = 1,
    warm_up_end = 5,
    anneal_end = 0,
    use_white_bkgd = {white},
    save_freq = 100,
    val_freq = 100,
    val_mesh_freq = 100,
    report_freq = 4,
    igr_weight = 0.1,
    mask_weight = 0.0,
}}
model {{
    nerf {{ D = 4, d_in = 4, d_in_view = 3, W = 64, multires = 4,
           multires_view = 2, output_ch = 4, skips = [2], use_viewdirs = True }}
    sdf_network {{ d_out = 65, d_in = 3, d_hidden = 64, n_layers = 4,
                   skip_in = [2], multires = 4, bias = 0.5, scale = 1.0,
                   geometric_init = True, weight_norm = True }}
    variance_network {{ init_val = 0.3 }}
    rendering_network {{ d_feature = 64, mode = no_view_dir, d_in = 6,
                         d_out = 3, d_hidden = 32, n_layers = 2,
                         weight_norm = True, multires_view = 2,
                         squeeze_out = True }}
    neus_renderer {{ n_samples = 8, n_importance = 8, n_outside = 4,
                     up_sample_steps = 2, perturb = {perturb} }}
}}
"""
# the same numerics in both packages: f32 up-sampling, no perturbation
COMMON = ["train.upsample_precision=f32", "model.neus_renderer.perturb=0"]
PORT = COMMON + ["model.neus_renderer.kernel_prec=f32"]


def _statics(mod):
    return mod.ModelStatics(sdf=mod.SDFConfig(**SDF),
                            color=mod.RenderingConfig(**COLOR),
                            nerf=mod.NeRFConfig(**NERF))


# ---------------------------------------------------------------------------
# render
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def render_inputs():
    jstatics, tstatics = _statics(jfields), _statics(tfields)
    params = jax.device_get(
        jfields.init_model_bundle(jax.random.PRNGKey(0), jstatics))
    scene = jds.make_sphere_scene(n_views=3, H=8, W=8, radius=0.4)
    o, d, _, _ = jds.gen_rays_at(scene.arrays, 1, 1)
    o = np.asarray(o).reshape(-1, 3)
    d = np.asarray(d).reshape(-1, 3)
    near, far = jcam.near_far_from_sphere(o, d, xp=np)
    return jstatics, tstatics, params, (o, d, near, far)


@pytest.mark.parametrize("n_importance,rtol,atol", [(0, 1e-5, 1e-5),
                                                    (8, 2e-4, 2e-5)],
                         ids=["no_upsampling", "upsampled"])
@pytest.mark.parametrize("white", [False, True], ids=["no_bkgd", "white_bkgd"])
@pytest.mark.parametrize("n_outside", [0, 4])
def test_render_matches_jax(render_inputs, n_outside, white, n_importance,
                            rtol, atol):
    """render against the JAX package's with its own draws (t_rand, t_out).
    Without up-sampling to 1e-5; up-sampled to the bounds of
    tests/test_torch_render_data.py's test_render_rnb, because the z-values
    of the two samplers differ by ~1e-4 (summation order), which moves the
    weights by ~2e-5."""
    jstatics, tstatics, params, (o, d, near, far) = render_inputs
    kw = dict(n_samples=16, n_importance=n_importance, n_outside=n_outside,
              up_sample_steps=2, upsample_prec="f32")
    n = o.shape[0]
    key = jax.random.PRNGKey(2)
    kz, kout = jax.random.split(key)
    t_rand = torch.tensor(np.asarray(jax.random.uniform(kz, (n, 1)) - 0.5))
    t_out = torch.tensor(np.asarray(jax.random.uniform(kout, (n, n_outside))))
    jbg = np.ones((1, 3), np.float32) if white else None
    jrender = jax.jit(lambda *a: jrnd.render(
        jstatics, jrnd.RendererConfig(**kw), *a, background_rgb=jbg))
    jo = jrender(params, o, d, near, far, key)
    to = trnd.render(tstatics, trnd.RendererConfig(**kw, kernel_prec="f32"),
                     bridge.params_from_numpy(params, device="cpu"),
                     *(torch.tensor(a) for a in (o, d, near, far)),
                     t_rand, t_out,
                     background_rgb=torch.ones(1, 3) if white else None)
    assert to["weights"].shape == (n, 16 + n_importance + n_outside)
    assert set(to) == set(jo)
    for k in ("color_fine", "weights", "weight_sum", "gradients"):
        np.testing.assert_allclose(to[k].detach().numpy(), np.asarray(jo[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_render_without_draws_is_unperturbed(render_inputs):
    """t_rand=None renders as perturb = 0 does, also the outside depths."""
    _, tstatics, params, rays = render_inputs
    kw = dict(n_samples=16, n_importance=8, n_outside=4, up_sample_steps=2,
              upsample_prec="f32", kernel_prec="f32")
    tp = bridge.params_from_numpy(params, device="cpu")
    rays = [torch.tensor(a) for a in rays]
    a = trnd.render(tstatics, trnd.RendererConfig(**kw), tp, *rays, None)
    b = trnd.render(tstatics, trnd.RendererConfig(**kw, perturb=0.0), tp, *rays,
                    torch.full((rays[0].shape[0], 1), 0.3), torch.rand(64, 4))
    for k in ("color_fine", "weights"):
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


@pytest.mark.parametrize("kernel_prec", ["f32", "bf16"])
def test_fold_params_keeps_the_numbers(render_inputs, kernel_prec):
    """The weight norm folded once before the chunks renders bit for bit
    what the ops' own fold at each call renders."""
    _, tstatics, params, rays = render_inputs
    rcfg = trnd.RendererConfig(n_samples=16, n_importance=8, n_outside=4,
                               up_sample_steps=2, kernel_prec=kernel_prec)
    tp = bridge.params_from_numpy(params, device="cpu")
    folded = tfields.fold_params(tp)
    assert set(folded["sdf"][0]) == {"w", "b"} and "v" in tp["sdf"][0]
    assert not any(t.requires_grad for t in bridge.tree_leaves(folded))
    rays = [torch.tensor(a) for a in rays]
    with torch.no_grad():
        a = trnd.render(tstatics, rcfg, tp, *rays, None)
        b = trnd.render(tstatics, rcfg, folded, *rays, None)
    for k in ("color_fine", "weights", "gradients"):
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the runners on one disk case and checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("novel_view") / "sphere"
    jcase.write_case(str(d), n_views=3, H=8, W=8, radius=0.4)
    return str(d)


def _conf(tmp, case_dir, name="test.conf", **kw):
    d = dict(exp_dir=os.path.join(tmp, "exp"), data_dir=case_dir, end_iter=20,
             warm_up_iter=5, white="False", perturb=1.0)
    d.update(kw)
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        f.write(CONF.format(**d))
    return path


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.01 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), tree)


def _jax_checkpoint(conf, seed, step):
    """A JAX runner's params, moved off their init, saved at ``step``."""
    jr = JRunner(conf, "validate_mesh", shard="off", seed=seed, overrides=COMMON)
    state = jr.state._replace(params=_noisy(jax.device_get(jr.state.params), seed))
    leaves, treedef = jax.tree_util.tree_flatten(state)
    leaves[-1] = leaves[-2] = np.asarray(step, np.int32)
    jckpt.save_checkpoint(
        os.path.join(jr.base_exp_dir, "checkpoints", f"ckpt_{step:06d}.npz"),
        jax.tree_util.tree_unflatten(treedef, leaves))


def _torch_checkpoint(conf, seed, step):
    """A port runner's params, moved off their init, saved at ``step``."""
    tr = TRunner(conf, "validate_mesh", seed=seed, overrides=PORT, device="cpu")
    noisy = _noisy(bridge.params_to_numpy(tr.state.params), seed)
    with torch.no_grad():
        for p, a in zip(bridge.tree_leaves(tr.state.params),
                        bridge.tree_leaves(noisy)):
            p.copy_(torch.tensor(a))
    tr.state.step = step
    tr.save_checkpoint()


@functools.lru_cache(maxsize=None)
def _pair(tmp, case_dir, writer, white="False"):
    """(JAX runner, port runner) that both loaded the checkpoint ``writer``
    wrote, at step 9 (main phase: warm_up_iter = 5)."""
    conf = _conf(tmp, case_dir, f"{writer}_{white}.conf",
                 exp_dir=os.path.join(tmp, f"exp_{writer}_{white}"), white=white)
    (_jax_checkpoint if writer == "jax" else _torch_checkpoint)(conf, 5, 9)
    jr = JRunner(conf, "validate_mesh", is_continue=True, shard="off",
                 overrides=COMMON)
    tr = TRunner(conf, "validate_mesh", is_continue=True, overrides=PORT,
                 device="cpu")
    assert jr.iter_step == tr.iter_step == 9
    return jr, tr


@pytest.fixture(scope="module")
def pairs(tmp_path_factory, case_dir):
    tmp = str(tmp_path_factory.mktemp("pairs"))
    return functools.partial(_pair, tmp, case_dir)


def assert_uint8_close(got, want):
    """Equal, but for values within an ulp of a level boundary before the
    truncation: at most 1 level apart, on at most 0.1% of the pixels."""
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int)).max(axis=-1)
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).sum() <= int(0.001 * diff.size), (diff > 0).sum()


@pytest.mark.parametrize("idx", [(0, 1), (2, 0)])
@pytest.mark.parametrize("ratio", [0.0, 0.37, 1.0])
@pytest.mark.parametrize("level", [1, 4])
def test_gen_rays_between(pairs, idx, ratio, level):
    """Against the JAX package at the ends too (its pixel grid is
    linspace(0, W-1, W/l), not gen_rays_at's)."""
    jr, tr = pairs("jax")
    jo, jd = jr.dataset.gen_rays_between(*idx, ratio, level)
    to, td = tr.dataset.gen_rays_between(*idx, ratio, level)
    assert to.shape == td.shape == (8 // level, 8 // level, 3)
    assert to.dtype == torch.float32 and to.device.type == "cpu"
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


@pytest.mark.parametrize("writer,white", [("jax", "False"), ("torch", "False"),
                                          ("jax", "True")])
def test_render_novel_image_matches_jax(pairs, writer, white):
    """One checkpoint, written by either package, loaded by both: the novel
    view of 64 rays in chunks of 48 (the last padded) at ratio 0.37."""
    jr, tr = pairs(writer, white)
    want = jr.render_novel_image(0, 2, 0.37, 1)
    got = tr.render_novel_image(0, 2, 0.37, 1)
    assert got.shape == (8, 8, 3)
    assert want.std() > 0
    assert_uint8_close(got, want)


def test_vertex_albedo_matches_jax(pairs):
    """150 vertices in chunks of 64 (a ragged last one) within 1e-5."""
    jr, tr = pairs("jax")
    v = np.random.default_rng(3).uniform(-0.6, 0.6, (150, 3)).astype(np.float32)
    want = jr._vertex_albedo(v, chunk=64)
    got = tr._vertex_albedo(v, chunk=64)
    assert got.shape == (150, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert 0 <= got.min() and got.max() <= 1


def test_validate_mesh_texture_matches_jax(pairs):
    """The PLY of both packages at resolution 24, with a scale matrix that
    moves the world-space vertices: the albedo within 1e-5, the uint8
    vertex colours at most 1 level apart, the albedo the one at the
    normalized-space vertices. The vertices agree within 1e-4, the bound of
    tests/test_torch_runner.py's mesh test: both packages fetch the grid as
    float16, and an SDF value one f32 ulp apart can round to neighbouring
    float16 values (here 7 of 2,190 coordinates differ by up to 3.1e-5)."""
    jr, tr = pairs("jax")
    scale = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    scale[:3, 3] = [0.1, -0.2, 0.3]
    saved = jr.dataset.scale_mats_np, tr.dataset.scale_mats_np
    jr.dataset.scale_mats_np = tr.dataset.scale_mats_np = [scale]
    path = os.path.join(tr.base_exp_dir, "meshes", "00000009.ply")
    try:
        jv, jf, jalb = jr.validate_mesh_texture(resolution=24)
        _, _, jc = tio.read_ply(path)
        tv, tf, talb = tr.validate_mesh_texture(resolution=24)
        pv, pf, pc = tio.read_ply(path)
    finally:
        jr.dataset.scale_mats_np, tr.dataset.scale_mats_np = saved
    assert len(tf) > 50
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4)
    np.testing.assert_allclose(talb, jalb, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pv, tv.astype(np.float32))
    np.testing.assert_array_equal(pf, tf)
    assert pc.dtype == np.uint8 and pc.shape == (len(tv), 3)
    assert np.abs(pc.astype(int) - jc.astype(int)).max() <= 1
    np.testing.assert_allclose(
        tr._vertex_albedo((tv - scale[:3, 3]) / scale[0, 0]), talb, atol=1e-5)


@pytest.mark.parametrize("step,phase", [(9, "main"), (3, "warmup")])
def test_validate_image_ps_matches_jax(pairs, step, phase):
    """One image per light, equal to the JAX package's within 1e-5 before
    the PNG write; the files are render over supervision."""
    jr, tr = pairs("jax")
    jr._host_step = None
    try:   # step 3 is the warm-up phase of the same weights
        jr.state = jr.state._replace(step=np.asarray(step, np.int32))
        tr.state.step = step
        want = jr.validate_image_ps()
        got = tr.validate_image_ps()
    finally:
        jr.state = jr.state._replace(step=np.asarray(9, np.int32))
        tr.state.step = 9
    assert len(got) == len(want) == tr.dataset.n_lights == 3
    for g, w in zip(got, want):
        assert g.shape == (8, 8, 3)
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)
    out = os.path.join(tr.base_exp_dir, "validations_ps")
    names = sorted(n for n in os.listdir(out) if n.startswith(f"{step:08d}_"))
    assert len(names) == 3
    assert tio.load_image(os.path.join(out, names[0])).shape == (16, 8, 3)


# ---------------------------------------------------------------------------
# video, tools, trace window, command line
# ---------------------------------------------------------------------------

def _frames(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("h,w", [(8, 8), (6, 7)], ids=["square", "odd_width"])
def test_avi_round_trip(tmp_path, h, w):
    """write_avi -> read_avi gives the frames back; an odd width pads each
    row of 3·w bytes to a multiple of 4."""
    frames = _frames(5, h, w)
    path = str(tmp_path / "v.avi")
    tio.write_avi(path, frames, fps=30)
    np.testing.assert_array_equal(tio.read_avi(path), np.stack(frames))
    stride = (3 * w + 3) & ~3
    assert os.path.getsize(path) > 5 * stride * h


@pytest.mark.parametrize("h,w", [(8, 8), (6, 7)], ids=["square", "odd_width"])
def test_avi_reads_in_opencv(tmp_path, h, w):
    cv2 = pytest.importorskip("cv2")
    frames = _frames(4, h, w, seed=1)
    path = str(tmp_path / "v.avi")
    tio.write_avi(path, frames, fps=30)
    cap = cv2.VideoCapture(path)
    got = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        got.append(f[..., ::-1])
    assert cap.get(cv2.CAP_PROP_FPS) == 30
    cap.release()
    np.testing.assert_array_equal(np.stack(got), np.stack(frames))


def test_compare_images_equals_root_tool(tmp_path):
    rng = np.random.default_rng(4)
    a = rng.uniform(size=(9, 7, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    tio.save_image(str(tmp_path / "a.png"), a)
    tio.save_image(str(tmp_path / "b.png"), b)
    want = jcompare.compare_pair(str(tmp_path / "a.png"), str(tmp_path / "b.png"))
    got = tcompare.compare_pair(str(tmp_path / "a.png"), str(tmp_path / "b.png"),
                                str(tmp_path / "d.png"))
    assert got == want and 20 < got[1] < 40
    assert tio.load_image(str(tmp_path / "d.png")).shape == (9, 7, 3)


def test_trace_window_writes_a_trace_and_keeps_the_losses(
        tmp_path, case_dir, monkeypatch):
    """3 steps with a one-step window from step 1: a Chrome trace is
    written, and the losses equal those of a run without it."""
    losses = {}
    for traced in (False, True):
        sub = tmp_path / str(traced)
        sub.mkdir()
        conf = _conf(str(sub), case_dir, end_iter=3)
        if traced:
            monkeypatch.setenv("RNB_PROFILE_DIR", str(tmp_path / "trace"))
            monkeypatch.setenv("RNB_PROFILE_START", "1")
            monkeypatch.setenv("RNB_PROFILE_STEPS", "1")
        TRunner(conf, device="cpu").train_rnb()
        with open(os.path.join(str(sub), "exp", "logs", "scalars.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses[traced] = {r["step"]: r["Loss/loss"] for r in recs
                          if "Loss/loss" in r}
    assert sorted(losses[True]) == [1, 2, 3]
    assert losses[True] == losses[False]
    (trace,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / trace) as f:
        assert json.load(f)["traceEvents"]


@pytest.fixture(scope="module")
def one_step_exp(tmp_path_factory, case_dir):
    tmp = str(tmp_path_factory.mktemp("cli"))
    conf = _conf(tmp, case_dir, end_iter=1, warm_up_iter=1)
    runner = TRunner(conf, device="cpu")
    runner.train_rnb()
    runner.save_checkpoint()
    assert os.path.isfile(os.path.join(tmp, "exp", "checkpoints", "ckpt_000001.npz"))
    return conf, os.path.join(tmp, "exp")


@pytest.mark.parametrize("mode,written", [
    ("validate_mesh_texture", ["meshes/00000001.ply"]),
    ("validate_image_ps", [f"validations_ps/00000001_{i}_{l}.png"
                           for i in (0,) for l in range(3)]),
    ("interpolate_0_1", ["render/00000001_0_1.avi"]),
])
def test_cli_modes_on_the_cpu(one_step_exp, mode, written):
    conf, exp = one_step_exp
    r = subprocess.run(
        [sys.executable, "-m", "rnb_tpu_torch.cli", "--mode", mode, "--conf",
         conf, "--device", "cpu", "--mesh_resolution", "24"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "launches" in json.loads(r.stdout.strip().splitlines()[-1])
    if mode == "validate_image_ps":
        idv = int(np.random.default_rng([0, 1, 2]).integers(3))
        written = [w.replace("_0_", f"_{idv}_") for w in written]
    for rel in written:
        assert os.path.isfile(os.path.join(exp, rel)), rel
    if mode == "validate_mesh_texture":
        v, f, c = tio.read_ply(os.path.join(exp, written[0]))
        assert len(f) > 0 and c.shape == (len(v), 3)
    if mode.startswith("interpolate"):
        frames = tio.read_avi(os.path.join(exp, written[0]))
        assert frames.shape == (120, 2, 2, 3)
        np.testing.assert_array_equal(frames, frames[::-1])
        assert "ms a frame" in r.stdout
