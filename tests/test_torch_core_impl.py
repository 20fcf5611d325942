"""The port's differentiable-core routes ``core_impl = 'vjp' | 'fwdmode'``
and ``remat`` against the JAX package on the CPU.

  * ``fields.sdf_value_feat_grad_fwd`` (∇SDF from forward-mode tangents)
    against the JAX package's, and against the port's own reverse-mode
    ``sdf_value_feat_grad``: outputs and the parameters' gradient of an
    eikonal-style loss.
  * One warm-up and one main training step on each route, wmask and womask
    (n_outside = 4), against ``rnb_tpu.train.step`` with the same knob, the
    same params and the JAX package's own draws, to the bounds of
    tests/test_torch_step.py; 'vjp' with remat against JAX's remat.
  * remat = true against remat = false on the port: the same step's
    gradients bit for bit on every route.
  * ``render`` on the 'vjp' route, under ``no_grad``, against JAX's.

Small nets (a 4x64 SDF net with the full encoding, multires 6, and a
skip), f32 everywhere.
"""

import collections

import jax
import numpy as np
import pytest
import torch

from rnb_tpu.data import dataset as jds
from rnb_tpu.data import cameras as jcam
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
# multires 6 encodes to 39 channels, and the layer before a skip outputs
# d_hidden - 39 of them: the narrowest such net with a skip is wider than 32
SDF = dict(d_out=65, d_hidden=64, n_layers=4, skip_in=(2,), multires=6)
COLOR = dict(d_feature=64, d_hidden=32, n_layers=2, multires_view=2)
NERF = dict(D=4, W=32, multires=4, multires_view=2, skips=(1,))
RENDER = dict(n_samples=12, n_importance=12, up_sample_steps=2,
              upsample_prec="f32")
TRAIN = dict(end_iter=300, warm_up_end=20, batch_size=B)
CONFS = {"wmask": ({}, {}),
         "womask": ({"n_outside": 4}, {"mask_weight": 0.0})}


def _statics(mod):
    return mod.ModelStatics(sdf=mod.SDFConfig(**SDF),
                            color=mod.RenderingConfig(**COLOR),
                            nerf=mod.NeRFConfig(**NERF))


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _perturbed(params, seed):
    """The params with N(0, 0.05) added to every leaf (the geometric init
    leaves the encoding's rows at zero, which would hide its tangents)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), params)


@pytest.fixture(scope="module")
def model():
    jstatics, tstatics = _statics(jfields), _statics(tfields)
    params = _perturbed(jax.device_get(
        jfields.init_model_bundle(jax.random.PRNGKey(0), jstatics)), 1)
    return jstatics, tstatics, params


@pytest.fixture(scope="module")
def scenes():
    kw = dict(n_views=3, H=32, W=32, radius=0.4)
    return jds.make_sphere_scene(**kw), tds.make_sphere_scene(**kw, device="cpu")


def _pts(n=256, seed=2):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# the forward-mode SDF field
# ---------------------------------------------------------------------------

def test_fwdmode_field_matches_jax(model):
    """Within 1e-6 of each output's norm (the two packages' sines and
    summation orders differ by an ulp, scaled by the encoding's top
    frequency, 32, in the tangents)."""
    jstatics, tstatics, params = model
    x = _pts()
    want = jax.jit(lambda p, x: jfields.sdf_value_feat_grad_fwd(
        jstatics.sdf, p, x))(params["sdf"], x)
    got = tfields.sdf_value_feat_grad_fwd(
        tstatics.sdf, bridge.params_from_numpy(params["sdf"], device="cpu"),
        torch.tensor(x))
    for name, g, w in zip(("sdf", "feature", "grad"), got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= 1e-6, f"{name}: error {err:.3g} of the norm"



def _eikonal_style(outs):
    sdf, feat, grad = outs
    return (((torch.linalg.vector_norm(grad, dim=-1) - 1.0) ** 2).mean()
            + sdf.abs().mean() + 0.1 * feat.square().mean())


def test_fwdmode_field_matches_vjp(model):
    """Outputs, and the gradient of a loss on (sdf, feature, ∇SDF) by the
    params: first-order through the tangents, second-order through the
    reverse sweep."""
    _, tstatics, params = model
    x = torch.tensor(_pts())
    got, want = [], []
    for fn, out in ((tfields.sdf_value_feat_grad_fwd, got),
                    (tfields.sdf_value_feat_grad, want)):
        p = bridge.params_from_numpy(params["sdf"], device="cpu")
        leaves = bridge.tree_leaves(p)
        for leaf in leaves:
            leaf.requires_grad_(True)
        outs = fn(tstatics.sdf, p, x)
        out.extend([o.detach() for o in outs])
        out.extend(torch.autograd.grad(_eikonal_style(outs), leaves))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()), err_msg=i)


# ---------------------------------------------------------------------------
# training steps against the JAX package
# ---------------------------------------------------------------------------

def jax_draws(base_key, step, H, W, n_outside):
    """The JAX step's key chain: fold_in(step) -> (k_ray, k_render);
    k_ray -> (kx, ky) pixel draws; k_render -> (kz, kout) -> t_rand and,
    with a background, t_out."""
    key = jax.random.fold_in(base_key, step)
    k_ray, k_render = jax.random.split(key)
    kx, ky = jax.random.split(k_ray)
    px = jax.random.randint(kx, (B,), 0, W)
    py = jax.random.randint(ky, (B,), 0, H)
    kz, kout = jax.random.split(k_render)
    t_rand = jax.random.uniform(kz, (B, 1)) - 0.5
    t_out = (_t(jax.random.uniform(kout, (B, n_outside))) if n_outside
             else None)
    return _t(px, torch.long), _t(py, torch.long), _t(t_rand), t_out


def _check_step(s, jstate, jm, tstate, tm, old):
    """tests/test_torch_step.py's bounds: metrics, Adam's moments (the
    gradients), updated params."""
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
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=2 * lr + 1e-7)
        du_t, du_j = a.numpy() - o.numpy(), b - o.numpy()
        assert np.abs(du_t - du_j).mean() <= 0.01 * lr + 1e-9


@pytest.mark.parametrize("core_impl,conf,remat", [
    ("vjp", "wmask", False), ("vjp", "womask", False),
    ("fwdmode", "wmask", False), ("fwdmode", "womask", False),
    ("vjp", "wmask", True)])
def test_steps_match_jax(scenes, model, core_impl, conf, remat):
    """A warm-up step (step 0, LR 0) then a main step (step 1), each
    against the JAX package's step with the same route and remat."""
    jscene, tscene = scenes
    jstatics, tstatics, params = model
    render_kw, train_kw = CONFS[conf]
    knobs = dict(core_impl=core_impl, remat=remat)
    jrcfg = jrnd.RendererConfig(**RENDER, **render_kw, **knobs)
    trcfg = trnd.RendererConfig(**RENDER, **render_kw, **knobs,
                                kernel_prec="f32")
    jtcfg = jstep.TrainConfig(**TRAIN, **train_kw, **knobs)
    ttcfg = tstep.TrainConfig(**TRAIN, **train_kw, **knobs)
    jstate = jstep.init_train_state(params, jtcfg)
    tstate = tstep.init_train_state(bridge.params_from_numpy(params, device="cpu"))
    base_key = jax.random.PRNGKey(42)
    for s, warmup in enumerate((True, False)):
        jfn = jstep.make_train_step(jstatics, jrcfg, jtcfg, warmup=warmup,
                                    no_albedo=False, donate=False)
        tfn = tstep.make_train_step(tstatics, trcfg, ttcfg, warmup=warmup,
                                    no_albedo=False)
        old = [p.detach().clone() for p in bridge.tree_leaves(tstate.params)]
        jstate, jm = jfn(jstate, jscene.arrays, s, base_key)
        px, py, t_rand, t_out = jax_draws(base_key, s, jscene.H, jscene.W,
                                          trcfg.n_outside)
        tstate, tm = tfn(tstate, tscene.arrays, s, px=px, py=py,
                         t_rand=t_rand, t_out=t_out)
        _check_step(s, jstate, jm, tstate, tm, old)


ROUTES = {"pallas-f32": ("pallas", "f32"), "pallas-bf16": ("pallas", "bf16"),
          "vjp": ("vjp", "f32"), "fwdmode": ("fwdmode", "f32")}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_remat_gradients_bit_for_bit(scenes, model, route, monkeypatch):
    """One main step with remat against the same step without: the loss,
    every gradient and every updated param bit for bit (the backward
    recomputes the SDF and albedo closures with the same arithmetic). The
    closures run once a step without remat; with it the backward runs each
    again, and on 'vjp' the inner ``autograd.grad`` recomputes the SDF
    closure once more in the forward."""
    _, tscene = scenes
    _, tstatics, params = model
    core_impl, prec = ROUTES[route]
    px, py, t_rand, t_out = jax_draws(jax.random.PRNGKey(5), 0, tscene.H,
                                      tscene.W, 4)
    calls = collections.Counter()
    for name in ("sdf_feat_grad", "albedo_at"):
        def counted(*a, _fn=getattr(trnd, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(trnd, name, counted)
    runs = {False: {"sdf_feat_grad": 1, "albedo_at": 1},
            True: {"sdf_feat_grad": 3 if core_impl == "vjp" else 2,
                   "albedo_at": 2}}
    out = []
    for remat in (False, True):
        calls.clear()
        rcfg = trnd.RendererConfig(**RENDER, n_outside=4, kernel_prec=prec,
                                   core_impl=core_impl, remat=remat)
        tcfg = tstep.TrainConfig(**{**TRAIN, "warm_up_end": 0},
                                 mask_weight=0.0, core_impl=core_impl,
                                 remat=remat)
        state = tstep.init_train_state(bridge.params_from_numpy(params,
                                                                device="cpu"))
        fn = tstep.make_train_step(tstatics, rcfg, tcfg, warmup=False,
                                   no_albedo=False)
        state, m = fn(state, tscene.arrays, 1, px=px, py=py, t_rand=t_rand,
                      t_out=t_out)
        assert calls == runs[remat], (remat, calls)
        leaves = bridge.tree_leaves(state.params)
        out.append((m["loss"], [p.grad for p in leaves],
                    [p.detach() for p in leaves]))
    (l0, g0, p0), (l1, g1, p1) = out
    assert torch.equal(l0, l1)
    assert any(g.any() for g in g0)
    for i, (a, b) in enumerate(zip(g0 + p0, g1 + p1)):
        assert torch.equal(a, b), i


# ---------------------------------------------------------------------------
# render (novel views) on the 'vjp' route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_outside", [0, 4])
def test_render_vjp_matches_jax(model, n_outside):
    """``render`` under ``no_grad`` on the 'vjp' route against JAX's, to
    the bounds of tests/test_torch_novel_view.py's up-sampled case, with
    its geometric-init weights (the up-sampled z-values of the two
    packages differ by ~1e-4, which the perturbed field's high frequencies
    would turn into larger differences of ∇SDF); the outputs carry no
    autograd graph."""
    jstatics, tstatics, _ = model
    params = jax.device_get(
        jfields.init_model_bundle(jax.random.PRNGKey(0), jstatics))
    scene = jds.make_sphere_scene(n_views=3, H=8, W=8, radius=0.4)
    o, d, _, _ = jds.gen_rays_at(scene.arrays, 1, 1)
    o = np.asarray(o).reshape(-1, 3)
    d = np.asarray(d).reshape(-1, 3)
    near, far = jcam.near_far_from_sphere(o, d, xp=np)
    kw = dict(n_samples=16, n_importance=8, n_outside=n_outside,
              up_sample_steps=2, upsample_prec="f32", core_impl="vjp")
    n = o.shape[0]
    key = jax.random.PRNGKey(2)
    kz, kout = jax.random.split(key)
    t_rand = torch.tensor(np.asarray(jax.random.uniform(kz, (n, 1)) - 0.5))
    t_out = torch.tensor(np.asarray(jax.random.uniform(kout, (n, n_outside))))
    jo = jax.jit(lambda *a: jrnd.render(jstatics, jrnd.RendererConfig(**kw),
                                        *a))(params, o, d, near, far, key)
    tp = bridge.params_from_numpy(params, device="cpu")
    for leaf in bridge.tree_leaves(tp):
        leaf.requires_grad_(True)
    with torch.no_grad():
        to = trnd.render(tstatics, trnd.RendererConfig(**kw, kernel_prec="f32"),
                         tp, *(torch.tensor(a) for a in (o, d, near, far)),
                         t_rand, t_out)
    for k in ("color_fine", "weights", "weight_sum", "gradients"):
        assert to[k].grad_fn is None and not to[k].requires_grad, k
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
