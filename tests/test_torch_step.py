"""Two training steps of the port against rnb_tpu.train.step on the CPU:
same params, same Adam state, the JAX package's own random draws, f32
everywhere (up-sampling sweeps and kernel operands).

The JAX side runs its XLA path on the CPU (batched vjp for ∇SDF, plain
rendering net); the port runs the plain versions of its kernels. The step
at warm_up_end > 0 starts with LR 0 (step 0), so two steps are taken.
"""

import jax
import numpy as np
import pytest
import torch

from rnb_tpu.data import dataset as jds
from rnb_tpu.models import fields as jfields
from rnb_tpu.models.renderer import RendererConfig as JRendererConfig
from rnb_tpu.train import step as jstep
from rnb_tpu_torch.data import dataset as tds
from rnb_tpu_torch.models import fields as tfields
from rnb_tpu_torch.models.renderer import RendererConfig as TRendererConfig
from rnb_tpu_torch.train import step as tstep
from rnb_tpu_torch.utils import bridge

torch.set_num_threads(1)

B = 64
SDF = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)
COLOR = dict(d_feature=32, d_hidden=32, n_layers=2, multires_view=2)
NERF = dict(D=2, W=32, multires=4, multires_view=2, skips=(0,))
RENDER = dict(n_samples=12, n_importance=12, up_sample_steps=2,
              upsample_prec="f32")
TRAIN = dict(end_iter=300, warm_up_end=20, batch_size=B)


def _statics(mod):
    return mod.ModelStatics(sdf=mod.SDFConfig(**SDF),
                            color=mod.RenderingConfig(**COLOR),
                            nerf=mod.NeRFConfig(**NERF))


def jax_draws(base_key, step, H, W):
    """The JAX step's key chain: fold_in(step) -> (k_ray, k_render);
    k_ray -> (kx, ky) pixel draws; k_render -> (kz, _) -> t_rand."""
    key = jax.random.fold_in(base_key, step)
    k_ray, k_render = jax.random.split(key)
    kx, ky = jax.random.split(k_ray)
    px = jax.random.randint(kx, (B,), 0, W)
    py = jax.random.randint(ky, (B,), 0, H)
    kz, _ = jax.random.split(k_render)
    t_rand = jax.random.uniform(kz, (B, 1)) - 0.5
    return (torch.tensor(np.asarray(px), dtype=torch.long),
            torch.tensor(np.asarray(py), dtype=torch.long),
            torch.tensor(np.asarray(t_rand)))


@pytest.fixture(scope="module")
def scenes():
    kw = dict(n_views=3, H=32, W=32, radius=0.4)
    return jds.make_sphere_scene(**kw), tds.make_sphere_scene(**kw, device="cpu")


@pytest.mark.parametrize("warmup", [True, False])
def test_two_steps_match_jax(scenes, warmup):
    jscene, tscene = scenes
    for a, b in zip(jscene.arrays, tscene.arrays):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)

    jstatics, tstatics = _statics(jfields), _statics(tfields)
    jtcfg = jstep.TrainConfig(**TRAIN)
    ttcfg = tstep.TrainConfig(**TRAIN)
    params = jfields.init_model_bundle(jax.random.PRNGKey(0), jstatics)
    jstate = jstep.init_train_state(params, jtcfg)
    jfn = jstep.make_train_step(jstatics, JRendererConfig(**RENDER), jtcfg,
                                warmup=warmup, no_albedo=False, donate=False)

    tstate = tstep.init_train_state(bridge.params_from_numpy(jax.device_get(params), device="cpu"))
    tfn = tstep.make_train_step(tstatics, TRendererConfig(**RENDER, kernel_prec="f32"),
                                ttcfg, warmup=warmup, no_albedo=False)

    base_key = jax.random.PRNGKey(42)
    for s in range(2):
        view = s % jscene.n_images
        old = [p.detach().clone() for p in bridge.tree_leaves(tstate.params)]
        jstate, jm = jfn(jstate, jscene.arrays, view, base_key)
        px, py, t_rand = jax_draws(base_key, s, jscene.H, jscene.W)
        tstate, tm = tfn(tstate, tscene.arrays, view, px=px, py=py, t_rand=t_rand)

        for k, v in jm.items():
            np.testing.assert_allclose(tm[k].item(), float(v), rtol=1e-4,
                                       atol=1e-7, err_msg=k)

        # grads through Adam's moments: mu = 0.1 g at step 0
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

        # updated params: Adam's early update is ≈ lr·sign(g), so where a
        # gradient is ~0 a summation-order difference can flip an update of
        # size lr; bound every entry by 2·lr and the mean difference tightly
        lr = float(jm["lr"])
        new_t = [p.detach() for p in bridge.tree_leaves(tstate.params)]
        for o, a, b in zip(old, new_t, jax.tree_util.tree_leaves(jstate.params)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                       atol=2 * lr + 1e-7)
            du_t, du_j = a.numpy() - o.numpy(), b - o.numpy()
            assert np.abs(du_t - du_j).mean() <= 0.01 * lr + 1e-9
