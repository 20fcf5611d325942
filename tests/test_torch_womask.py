"""The womask path of the port (background NeRF, n_outside > 0) against the
JAX package on the CPU: the outside depths, render_core_outside,
render_rnb with n_outside=4, and two training steps at mask_weight=0.

The JAX side runs its XLA path on the CPU (fields.nerf_apply for the
background); the port runs the plain versions of its kernels, f32
operands. The draws are the JAX package's own (t_rand, t_out).
"""

import jax
import numpy as np
import pytest
import torch

from rnb_tpu.data import dataset as jds
from rnb_tpu.models import fields as jfields
from rnb_tpu.models import renderer as jrnd
from rnb_tpu.train import step as jstep
from rnb_tpu_torch.data import dataset as tds
from rnb_tpu_torch.models import fields as tfields
from rnb_tpu_torch.models import renderer as trnd
from rnb_tpu_torch.train import step as tstep
from rnb_tpu_torch.utils import bridge

torch.set_num_threads(1)

B = 64
SDF = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)
COLOR = dict(d_feature=32, d_hidden=32, n_layers=2, multires_view=2)
NERF = dict(D=4, W=32, multires=4, multires_view=2, skips=(1,))
RENDER = dict(n_samples=12, n_importance=12, n_outside=4, up_sample_steps=2,
              upsample_prec="f32")
TRAIN = dict(end_iter=300, warm_up_end=20, batch_size=B, mask_weight=0.0)


def _statics(mod):
    return mod.ModelStatics(sdf=mod.SDFConfig(**SDF),
                            color=mod.RenderingConfig(**COLOR),
                            nerf=mod.NeRFConfig(**NERF))


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def jax_draws(base_key, step, H, W):
    """The JAX step's key chain: fold_in(step) -> (k_ray, k_render);
    k_ray -> (kx, ky) pixel draws; k_render -> (kz, kout) -> t_rand and the
    background strata t_out."""
    key = jax.random.fold_in(base_key, step)
    k_ray, k_render = jax.random.split(key)
    kx, ky = jax.random.split(k_ray)
    px = jax.random.randint(kx, (B,), 0, W)
    py = jax.random.randint(ky, (B,), 0, H)
    kz, kout = jax.random.split(k_render)
    t_rand = jax.random.uniform(kz, (B, 1)) - 0.5
    t_out = jax.random.uniform(kout, (B, RENDER["n_outside"]))
    return (_t(px, torch.long), _t(py, torch.long), _t(t_rand), _t(t_out))


@pytest.fixture(scope="module")
def scenes():
    kw = dict(n_views=3, H=32, W=32, radius=0.4)
    return jds.make_sphere_scene(**kw), tds.make_sphere_scene(**kw, device="cpu")


@pytest.fixture(scope="module")
def model():
    jstatics, tstatics = _statics(jfields), _statics(tfields)
    params = jax.device_get(
        jfields.init_model_bundle(jax.random.PRNGKey(0), jstatics))
    return jstatics, tstatics, params


def _rays(scenes, n=B):
    jscene, tscene = scenes
    jb = jds.sample_rays_on_all_lights(jscene.arrays, 0, jax.random.PRNGKey(1), n)
    tb = tds.sample_rays_on_all_lights(tscene.arrays, 0, _t(jb.pixels_x, torch.long),
                                       _t(jb.pixels_y, torch.long))
    return jb, tb


@pytest.mark.parametrize("perturb", [1.0, 0.0])
def test_outside_z_vals(perturb):
    rng = np.random.default_rng(0)
    far = rng.uniform(1.5, 3.0, (B, 1)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jcfg = jrnd.RendererConfig(**RENDER, perturb=perturb)
    want = jrnd._outside_z_vals(jcfg, far, B, key, perturb)
    t_out = _t(jax.random.uniform(key, (B, RENDER["n_outside"])))
    got = trnd._outside_z_vals(trnd.RendererConfig(**RENDER, perturb=perturb),
                               torch.tensor(far), t_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_render_core_outside(scenes, model):
    jstatics, tstatics, params = model
    jb, tb = _rays(scenes)
    rng = np.random.default_rng(4)
    z = np.sort(rng.uniform(0.5, 8.0, (B, 20)), axis=-1).astype(np.float32)
    jo = jrnd.render_core_outside(jstatics, jrnd.RendererConfig(**RENDER),
                                  params, jb.rays_o, jb.rays_d, z, 2.0 / 12)
    to = trnd.render_core_outside(
        tstatics, trnd.RendererConfig(**RENDER, kernel_prec="f32"),
        bridge.params_from_numpy(params, device="cpu"), tb.rays_o, tb.rays_d,
        torch.tensor(z), 2.0 / 12)
    for k in ("color", "sampled_color", "alpha", "weights"):
        np.testing.assert_allclose(to[k].detach().numpy(), np.asarray(jo[k]),
                                   rtol=2e-5, atol=2e-6, err_msg=k)


@pytest.mark.parametrize("warmup", [True, False])
def test_render_rnb_with_background(scenes, model, warmup):
    """render_rnb with n_outside=4 to the tolerances of
    tests/test_torch_render_data.py's test_render_rnb. No up-sampling here:
    its z-values differ between the packages by ~1e-4 (summation order in
    the sampler), which the background's dists amplify past those bounds;
    given equal z-values the weights agree to ~1e-6. The step test below
    runs the up-sampled path."""
    jstatics, tstatics, params = model
    n = 96
    kw_r = dict(n_samples=32, n_importance=0, n_outside=4)
    jb, tb = _rays(scenes, n)
    if warmup:
        jl, tl = jb.lights_warmup.reshape(-1, 1, 1, 3), tb.lights_warmup.reshape(-1, 1, 1, 3)
    else:
        jl, tl = jb.lights.reshape(-1, n, 1, 3), tb.lights.reshape(-1, n, 1, 3)
    key = jax.random.PRNGKey(2)
    kz, kout = jax.random.split(key)
    t_rand = _t(jax.random.uniform(kz, (n, 1)) - 0.5)
    t_out = _t(jax.random.uniform(kout, (n, 4)))

    jrender = jax.jit(lambda *a: jrnd.render_rnb(
        jstatics, jrnd.RendererConfig(**kw_r), *a, warmup=warmup))
    jo = jrender(params, jb.rays_o, jb.rays_d, jb.near, jb.far, jl, key)
    to = trnd.render_rnb(tstatics, trnd.RendererConfig(**kw_r, kernel_prec="f32"),
                         bridge.params_from_numpy(params, device="cpu"), tb.rays_o, tb.rays_d,
                         tb.near, tb.far, tl, t_rand, t_out, warmup=warmup)
    assert to["weights"].shape == (n, 32 + 4)
    for k in ("color_fine", "weights", "weight_sum", "weight_max", "cdf_fine",
              "s_val", "gradients", "gradient_error"):
        np.testing.assert_allclose(to[k].detach().numpy(), np.asarray(jo[k]),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


def _step_pair(scenes, model, warmup, n_steps, check):
    jscene, tscene = scenes
    jstatics, tstatics, params = model
    jtcfg, ttcfg = jstep.TrainConfig(**TRAIN), tstep.TrainConfig(**TRAIN)
    jstate = jstep.init_train_state(params, jtcfg)
    jfn = jstep.make_train_step(jstatics, jrnd.RendererConfig(**RENDER), jtcfg,
                                warmup=warmup, no_albedo=False, donate=False)
    tstate = tstep.init_train_state(bridge.params_from_numpy(params, device="cpu"))
    tfn = tstep.make_train_step(tstatics, trnd.RendererConfig(**RENDER, kernel_prec="f32"),
                                ttcfg, warmup=warmup, no_albedo=False)
    base_key = jax.random.PRNGKey(42)
    for s in range(n_steps):
        view = s % jscene.n_images
        old = [p.detach().clone() for p in bridge.tree_leaves(tstate.params)]
        jstate, jm = jfn(jstate, jscene.arrays, view, base_key)
        px, py, t_rand, t_out = jax_draws(base_key, s, jscene.H, jscene.W)
        tstate, tm = tfn(tstate, tscene.arrays, view, px=px, py=py,
                         t_rand=t_rand, t_out=t_out)
        check(s, jstate, jm, tstate, tm, old)


@pytest.mark.parametrize("warmup", [True, False])
def test_two_womask_steps_match_jax(scenes, model, warmup):
    """Two steps at mask_weight=0 and n_outside=4, with the bounds of
    tests/test_torch_step.py."""
    def check(s, jstate, jm, tstate, tm, old):
        for k, v in jm.items():
            np.testing.assert_allclose(tm[k].item(), float(v), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        mu_j, nu_j = jstate.opt_state[0].mu, jstate.opt_state[0].nu
        mu_t, nu_t, count = bridge.adam_state_to_numpy(tstate.optimizer,
                                                        tstate.params)
        assert count == s + 1 == int(jstate.opt_state[0].count)
        for a, b in zip(bridge.tree_leaves(mu_t), jax.tree_util.tree_leaves(mu_j)):
            scale = np.abs(b).max() + 1e-12
            np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-4 * scale)
        for a, b in zip(bridge.tree_leaves(nu_t), jax.tree_util.tree_leaves(nu_j)):
            np.testing.assert_allclose(np.sqrt(a), np.sqrt(b), rtol=5e-4,
                                       atol=5e-4 * (np.sqrt(b).max() + 1e-12))
        lr = float(jm["lr"])
        new_t = [p.detach() for p in bridge.tree_leaves(tstate.params)]
        for o, a, b in zip(old, new_t, jax.tree_util.tree_leaves(jstate.params)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                       atol=2 * lr + 1e-7)
            du_t, du_j = a.numpy() - o.numpy(), b - o.numpy()
            assert np.abs(du_t - du_j).mean() <= 0.01 * lr + 1e-9

    _step_pair(scenes, model, warmup, 2, check)


def test_background_gradient_reaches_trunk_and_alpha_only(scenes, model):
    """The RNb render uses the background alpha and never its colour, so
    the NeRF's trunk and alpha head get a nonzero gradient and its feature,
    views and rgb heads exactly zero, in both packages."""
    def check(s, jstate, jm, tstate, tm, old):
        mu_j = jstate.opt_state[0].mu["nerf"]     # mu = 0.1 g after step 0
        grads_t = bridge.tree_map(lambda p: p.grad.numpy(), tstate.params["nerf"])
        for g in (mu_j, grads_t):
            for layer in g["pts_layers"] + [g["alpha_layer"]]:
                for leaf in layer.values():
                    assert np.abs(np.asarray(leaf)).max() > 0
            for name in ("feature_layer", "views_layer", "rgb_layer"):
                for leaf in g[name].values():
                    assert not np.asarray(leaf).any(), name

    _step_pair(scenes, model, False, 1, check)
