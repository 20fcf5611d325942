"""The port's fields (rnb_tpu_torch.models.fields, .embedder) against the
JAX package on the same weights (carried by utils.bridge), at small widths.
f32 tolerances as in tests/test_fields.py; sdf_only_lowp is compared at a
bf16 tolerance (both sides round the same operands to bf16, but a one-ulp
difference upstream can flip a rounding: one bf16 ulp is 2^-8 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnb_tpu.models import embedder as jemb
from rnb_tpu.models import fields as jfields
from rnb_tpu_torch import config as tconfig
from rnb_tpu_torch.models import embedder as temb
from rnb_tpu_torch.models import fields as tfields
from rnb_tpu_torch.utils import bridge

torch.set_num_threads(1)

SDF = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)


def _pts(n=300, seed=0):
    return np.random.default_rng(seed).uniform(-0.9, 0.9, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("multires", [0, 4, 6])
def test_embedder(multires):
    x = _pts()
    fj, dj = jemb.make_embedder(multires, 3)
    ft, dt = temb.make_embedder(multires, 3)
    assert dj == dt
    np.testing.assert_allclose(ft(torch.tensor(x)).numpy(), np.asarray(fj(x)),
                               rtol=1e-6, atol=1e-6)


def _sdf_setup(**over):
    kw = {**SDF, **over}
    jcfg, tcfg = jfields.SDFConfig(**kw), tfields.SDFConfig(**kw)
    params = jfields.init_sdf_network(jax.random.PRNGKey(1), jcfg)
    return jcfg, tcfg, params, bridge.params_from_numpy(jax.device_get(params), device="cpu")


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_sdf_apply_and_only(scale):
    jcfg, tcfg, jp, tp = _sdf_setup(scale=scale)
    x = _pts()
    np.testing.assert_allclose(
        tfields.sdf_apply(tcfg, tp, torch.tensor(x)).detach().numpy(),
        np.asarray(jfields.sdf_apply(jcfg, jp, x)), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        tfields.sdf_only(tcfg, tp, torch.tensor(x)).detach().numpy(),
        np.asarray(jfields.sdf_only(jcfg, jp, x)), rtol=2e-5, atol=2e-5)


def test_sdf_only_lowp_bf16():
    jcfg, tcfg, jp, tp = _sdf_setup()
    x = _pts()
    got = tfields.sdf_only_lowp(tcfg, tp, torch.tensor(x)).detach().numpy()
    want = np.asarray(jfields.sdf_only_lowp(jcfg, jp, x))
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    # and it is a bf16 approximation of the f32 field
    f32 = np.asarray(jfields.sdf_only(jcfg, jp, x))
    assert np.abs(got - f32).max() < 5e-2


def test_sdf_value_feat_grad_second_order():
    """Autograd ∇SDF with create_graph, differentiated again into params."""
    jcfg, tcfg, jp, tp = _sdf_setup()
    x = _pts(200)

    def lj(p):
        s, f, g = jfields.sdf_value_feat_grad(jcfg, p, x)
        return s.sum() * 1e-2 + ((jnp.linalg.norm(g, axis=-1) - 1) ** 2).mean()

    vj, gj = jax.value_and_grad(lj)(jp)
    s, f, g = tfields.sdf_value_feat_grad(tcfg, tp, torch.tensor(x))
    vt = s.sum() * 1e-2 + ((torch.linalg.vector_norm(g, dim=-1) - 1) ** 2).mean()
    vt.backward()
    np.testing.assert_allclose(vt.item(), float(vj), rtol=1e-5)
    for a, b in zip(bridge.tree_leaves(tp), jax.tree_util.tree_leaves(gj)):
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=5e-4, atol=5e-6)


@pytest.mark.parametrize("mode", ["no_view_dir", "idr"])
def test_rendering_apply(mode):
    kw = dict(d_feature=32, d_hidden=32, n_layers=2, multires_view=2, mode=mode,
              d_in=9 if mode == "idr" else 6)
    jcfg, tcfg = jfields.RenderingConfig(**kw), tfields.RenderingConfig(**kw)
    jp = jfields.init_rendering_network(jax.random.PRNGKey(2), jcfg)
    tp = bridge.params_from_numpy(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(3)
    p, n, v = (rng.normal(size=(100, 3)).astype(np.float32) for _ in range(3))
    f = rng.normal(size=(100, 32)).astype(np.float32)
    got = tfields.rendering_apply(tcfg, tp, *(torch.tensor(a) for a in (p, n, v, f)))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jfields.rendering_apply(jcfg, jp, p, n, v, f)),
                               rtol=2e-5, atol=2e-6)


def test_bundle_structure_matches_jax():
    """The port's init gives the JAX bundle's tree: same leaves, same shapes
    (so the bridge and the Adam state line up), and the SDF geometric init
    puts the zero level set near radius ``bias`` (init is matched in
    distribution, not in draws)."""
    conf = tconfig.load_conf("confs/wmask_rnb.conf")
    tstatics = tfields.statics_from_conf(conf["model"])
    from rnb_tpu import config as jconfig
    jstatics = jfields.statics_from_conf(jconfig.load_conf("confs/wmask_rnb.conf")["model"])
    assert tstatics.sdf.__dict__ == jstatics.sdf.__dict__
    assert tstatics.color.__dict__ == jstatics.color.__dict__
    shapes_j = jax.tree_util.tree_map(lambda a: a.shape, jax.eval_shape(
        lambda k: jfields.init_model_bundle(k, jstatics), jax.random.PRNGKey(0)))
    tp = tfields.init_model_bundle(torch.Generator().manual_seed(0), tstatics, device="cpu")
    assert [tuple(t.shape) for t in bridge.tree_leaves(tp)] == [
        tuple(s) for s in jax.tree_util.tree_leaves(
            shapes_j, is_leaf=lambda s: isinstance(s, tuple))]
    # the level set starts near radius 0.5: negative inside, positive out
    u = torch.nn.functional.normalize(
        torch.randn(256, 3, generator=torch.Generator().manual_seed(1)), dim=-1)
    mean = [tfields.sdf_only(tstatics.sdf, tp["sdf"], r * u).mean().item()
            for r in (0.3, 0.5, 0.7)]
    assert mean[0] < -0.05 and abs(mean[1]) < 0.1 and mean[2] > 0.05, mean
