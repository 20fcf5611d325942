"""The port's data and renderer modules against the JAX package: virtual
lights, rays and near/far, ray-batch synthesis from given pixels, the
inverse-CDF sampler, the tie-break of the sorted merge, and render_rnb in
both phases with the JAX package's own t_rand (f32 everywhere).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnb_tpu.data import cameras as jcam
from rnb_tpu.data import dataset as jds
from rnb_tpu.data import lights as jlights
from rnb_tpu.models import fields as jfields
from rnb_tpu.models import renderer as jrnd
from rnb_tpu_torch.data import cameras as tcam
from rnb_tpu_torch.data import dataset as tds
from rnb_tpu_torch.data import lights as tlights
from rnb_tpu_torch.models import fields as tfields
from rnb_tpu_torch.models import renderer as trnd
from rnb_tpu_torch.utils import bridge

torch.set_num_threads(1)


def _normals(n=500, seed=0):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v[:5] = 0.0                        # background pixels
    v[5] = [0.95, 0.3, 0.0]            # helper-axis switch
    return v


def test_lights():
    n = _normals()
    a = np.random.default_rng(1).uniform(size=n.shape).astype(np.float32)
    np.testing.assert_allclose(tlights.normal_frames(torch.tensor(n)).numpy(),
                               np.asarray(jlights.normal_frames(n)), atol=1e-6)
    l_t = tlights.per_pixel_light_dirs_cam(torch.tensor(n))
    l_j = jlights.per_pixel_light_dirs_cam(n)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=1e-6)
    np.testing.assert_allclose(
        tlights.shade(torch.tensor(n), l_t, torch.tensor(a)).numpy(),
        np.asarray(jlights.shade(n, l_j, a)), atol=1e-6)
    u = jlights.warmup_light_dirs_cam()
    np.testing.assert_allclose(
        tlights.shade(torch.tensor(n), torch.tensor(u), None).numpy(),
        np.asarray(jlights.shade(n, u, None)), atol=1e-6)


@pytest.fixture(scope="module")
def scenes():
    kw = dict(n_views=3, H=40, W=48, radius=0.4)
    return jds.make_sphere_scene(**kw), tds.make_sphere_scene(**kw, device="cpu")


def test_cameras_and_torus_fixture():
    P = np.random.default_rng(2).normal(size=(3, 4))
    for a, b in zip(tcam.decompose_projection(P), jcam.decompose_projection(P)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    jt = jds.make_torus_scene(n_views=2, H=24, W=24, center=(0.1, 0, 0))
    tt = tds.make_torus_scene(n_views=2, H=24, W=24, center=(0.1, 0, 0), device="cpu")
    for a, b in zip(tt.arrays, jt.arrays):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_ray_batch_from_pixels(scenes):
    jscene, tscene = scenes
    rng = np.random.default_rng(3)
    px = rng.integers(0, 48, 256)
    py = rng.integers(0, 40, 256)
    view = 1
    # the JAX sampler draws its own pixels: rebuild its batch from ours
    jb_rays = jds._rays_from_pixels(jscene.arrays, view, jnp.asarray(px),
                                    jnp.asarray(py))
    tb = tds.sample_rays_on_all_lights(tscene.arrays, view, torch.tensor(px),
                                       torch.tensor(py))
    np.testing.assert_allclose(tb.rays_o.numpy(), np.asarray(jb_rays[0]), atol=1e-6)
    np.testing.assert_allclose(tb.rays_d.numpy(), np.asarray(jb_rays[1]), atol=1e-6)
    near, far = jcam.near_far_from_sphere(*jb_rays, xp=jnp)
    np.testing.assert_allclose(tb.near.numpy(), np.asarray(near), atol=1e-5)
    np.testing.assert_allclose(tb.far.numpy(), np.asarray(far), atol=1e-5)

    # the whole batch, with the pixels the JAX sampler drew
    key = jax.random.PRNGKey(4)
    jb = jds.sample_rays_on_all_lights(jscene.arrays, view, key, 128)
    tb = tds.sample_rays_on_all_lights(
        tscene.arrays, view, torch.tensor(np.asarray(jb.pixels_x)),
        torch.tensor(np.asarray(jb.pixels_y)))
    for name in jb._fields:
        np.testing.assert_allclose(getattr(tb, name).numpy(),
                                   np.asarray(getattr(jb, name)), atol=1e-5,
                                   err_msg=name)


def test_sample_pdf():
    rng = np.random.default_rng(5)
    bins = np.sort(rng.uniform(1, 3, (64, 17)), axis=-1).astype(np.float32)
    w = rng.uniform(size=(64, 16)).astype(np.float32)
    w[:8] = 0.0                         # flat pdf rows
    w[8:16, 3:] = 0.0                   # mass in a few bins
    got = trnd.sample_pdf(torch.tensor(bins), torch.tensor(w), 9).numpy()
    want = np.asarray(jrnd.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 9))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_merge_keeps_z_first_on_ties():
    z = np.array([[0.0, 1.0, 2.0, 2.0]], np.float32)
    new = np.array([[1.0, 2.0, 3.0]], np.float32)
    vz = np.array([[10.0, 11.0, 12.0, 13.0]], np.float32)
    vn = np.array([[20.0, 21.0, 22.0]], np.float32)
    jz, jv = jrnd._merge_sorted(jnp.asarray(z), jnp.asarray(new),
                                (jnp.asarray(vz), jnp.asarray(vn)))
    tz, tv = trnd._merge_sorted(*(torch.tensor(a) for a in (z, new)),
                                (torch.tensor(vz), torch.tensor(vn)))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tv.numpy(), [[10, 11, 20, 12, 13, 21, 22]])


@pytest.mark.parametrize("warmup", [True, False])
def test_render_rnb(scenes, warmup):
    jscene, tscene = scenes
    kw_sdf = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)
    kw_col = dict(d_feature=32, d_hidden=32, n_layers=2, multires_view=2)
    kw_nerf = dict(D=2, W=32, multires=4, multires_view=2, skips=(0,))
    jstatics = jfields.ModelStatics(sdf=jfields.SDFConfig(**kw_sdf),
                                    color=jfields.RenderingConfig(**kw_col),
                                    nerf=jfields.NeRFConfig(**kw_nerf))
    tstatics = tfields.ModelStatics(sdf=tfields.SDFConfig(**kw_sdf),
                                    color=tfields.RenderingConfig(**kw_col),
                                    nerf=tfields.NeRFConfig(**kw_nerf))
    kw_r = dict(n_samples=16, n_importance=16, up_sample_steps=4,
                upsample_prec="f32")
    params = jfields.init_model_bundle(jax.random.PRNGKey(0), jstatics)
    tp = bridge.params_from_numpy(jax.device_get(params), device="cpu")

    jb = jds.sample_rays_on_all_lights(jscene.arrays, 0, jax.random.PRNGKey(1), 96)
    tb = tds.sample_rays_on_all_lights(
        tscene.arrays, 0, torch.tensor(np.asarray(jb.pixels_x)),
        torch.tensor(np.asarray(jb.pixels_y)))
    if warmup:
        jl, tl = jb.lights_warmup.reshape(-1, 1, 1, 3), tb.lights_warmup.reshape(-1, 1, 1, 3)
    else:
        jl, tl = jb.lights.reshape(-1, 96, 1, 3), tb.lights.reshape(-1, 96, 1, 3)
    key = jax.random.PRNGKey(2)
    kz, _ = jax.random.split(key)
    t_rand = torch.tensor(np.asarray(jax.random.uniform(kz, (96, 1)) - 0.5))

    jrender = jax.jit(lambda *a: jrnd.render_rnb(
        jstatics, jrnd.RendererConfig(**kw_r), *a, warmup=warmup))
    jo = jrender(params, jb.rays_o, jb.rays_d, jb.near, jb.far, jl, key)
    to = trnd.render_rnb(tstatics, trnd.RendererConfig(**kw_r, kernel_prec="f32"),
                         tp, tb.rays_o, tb.rays_d, tb.near, tb.far, tl, t_rand,
                         warmup=warmup)
    for k in ("color_fine", "weights", "weight_sum", "weight_max", "cdf_fine",
              "s_val", "gradients", "gradient_error"):
        np.testing.assert_allclose(to[k].detach().numpy(), np.asarray(jo[k]),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
