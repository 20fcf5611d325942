"""The port's offline stage and tools against the JAX package's, on the
CPU: scene normalization function by function
(``rnb_tpu_torch.preprocess.preprocess_cameras`` against
``preprocess/preprocess_cameras.py``, 1e-9 relative to the norm; the
written ``cameras.npz`` 1e-6), the ``--normalize`` case writer, the
world-space runner on the normalized non-square case, and the
``eval_chamfer`` and ``inspect_cameras`` command lines.

The case is the 76x56, 6-view torus centred off the origin of
``tests/test_worldspace.py``, written un-normalized by the JAX package's
``tools/make_synthetic_case.py``.
"""

import contextlib
import io as stdio
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from rnb_tpu import config as jconfig
from rnb_tpu.data import dataset as jds
from rnb_tpu_torch import config as tconfig
from rnb_tpu_torch.data import dataset as tds
from rnb_tpu_torch.preprocess import preprocess_cameras as tpre
from rnb_tpu_torch.tools import eval_chamfer as tchamfer
from rnb_tpu_torch.tools import inspect_cameras as tinspect
from rnb_tpu_torch.tools import make_synthetic_case as tcase
from rnb_tpu_torch.utils import bridge
from rnb_tpu_torch.utils import io as tio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "preprocess"))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import eval_chamfer as jchamfer  # noqa: E402
import inspect_cameras as jinspect  # noqa: E402
import make_synthetic_case as jcase  # noqa: E402
import preprocess_cameras as jpre  # noqa: E402

torch.set_num_threads(1)

CENTER = (0.15, -0.1, 0.08)
CASE = dict(n_views=6, H=56, W=76, shape="torus", center=CENTER)
CPU = "cpu"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def raw_case(tmp_path_factory):
    """The un-normalized case: (dir, Ps [V,3,4], mask points, masks)."""
    d = str(tmp_path_factory.mktemp("pre") / "torus_raw")
    jcase.write_case(d, **CASE)
    pts, masks = jpre.load_mask_points(os.path.join(d, "mask"))
    tpts, tmasks = tpre.load_mask_points(os.path.join(d, "mask"))
    for a, b in zip(pts, tpts):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(masks, tmasks)
    with np.load(os.path.join(d, "cameras.npz")) as cams:
        Ps = np.array([cams[f"world_mat_{i}"][:3].astype(np.float64)
                       for i in range(CASE["n_views"])])
    return d, Ps, pts, masks


def _t(a):
    return torch.tensor(np.asarray(a, np.float64), dtype=torch.float64)


def test_fundamental_matrix_and_centre(raw_case):
    _, Ps, _, _ = raw_case
    for j in range(1, len(Ps)):
        want = jpre.fundamental_matrix(Ps[j], Ps[0])
        got = tpre.fundamental_matrix(_t(Ps[j]), _t(Ps[0])).numpy()
        assert _rel(got, want) < 1e-9, j
    assert _rel(tpre.camera_center(_t(Ps[0])).numpy(),
                jpre.camera_center(Ps[0])) < 1e-12


def test_depth_interval(raw_case):
    """Single picks and the batched intervals against the reference's loop,
    including picks off the silhouette's epipolar band (0, 0)."""
    _, Ps, pts, _ = raw_case
    P0 = Ps[0]
    rng = np.random.default_rng(3)
    picks = rng.permutation(pts[0].shape[1])[:12]
    xs = np.concatenate([pts[0][0][picks], [0.0, 75.0]])
    ys = np.concatenate([pts[0][1][picks], [0.0, 55.0]])
    for j in range(1, len(Ps)):
        F = jpre.fundamental_matrix(Ps[j], P0)
        want = np.array([jpre.depth_interval(x, y, Ps[j], pts[j], P0, F)
                         for x, y in zip(xs, ys)])
        lo, hi = tpre.depth_intervals(_t(xs), _t(ys), _t(Ps[j]), _t(pts[j]),
                                      _t(P0), _t(F))
        got = np.stack([lo.numpy(), hi.numpy()], axis=1)
        assert (got == 0).sum() == (want == 0).sum(), j
        assert _rel(got, want) < 1e-9, j
        one = tpre.depth_interval(xs[0], ys[0], _t(Ps[j]), _t(pts[j]),
                                  _t(P0), _t(F))
        assert _rel(one, want[0]) < 1e-9


@pytest.mark.parametrize("seed", [0, 5])
def test_estimate_normalization(raw_case, seed):
    _, Ps, pts, _ = raw_case
    want, want_pts = jpre.estimate_normalization(Ps, pts, 100, seed)
    got, got_pts = tpre.estimate_normalization(Ps, pts, 100, seed, device=CPU)
    assert got.dtype == np.float32 and got_pts.shape == want_pts.shape
    assert _rel(got_pts, want_pts) < 1e-9
    assert _rel(got, want) < 1e-9


def test_refine_visual_hull(raw_case):
    _, Ps, pts, masks = raw_case
    norm, _ = jpre.estimate_normalization(Ps, pts, 100, 0)
    args = (masks, Ps, 3.0 * float(norm[0, 0]), norm[:3, 3])
    c_j, s_j, k_j = jpre.refine_visual_hull(*args, grid_size=60)
    c_t, s_t, k_t = tpre.refine_visual_hull(*args, grid_size=60, device=CPU)
    assert k_t.shape == k_j.shape
    assert _rel(c_t, c_j) < 1e-9 and _rel(s_t, s_j) < 1e-9
    assert _rel(k_t, k_j) < 1e-9


@pytest.mark.parametrize("refine", [False, True])
def test_get_normalization_writes_the_jax_cameras(raw_case, tmp_path, refine):
    """``get_normalization`` (and, refined, the command line) rewrite
    cameras.npz as the reference does."""
    src = raw_case[0]
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(src, j)
    shutil.copytree(src, t)
    want = jpre.get_normalization(j, seed=0, refine_hull=refine)
    if refine:
        tpre.main(["--source_dir", t, "--refine_visual_hull", "--device", CPU])
    else:
        tpre.get_normalization(t, seed=0, refine_hull=False, device=CPU)
    with np.load(os.path.join(j, "cameras.npz")) as a, \
            np.load(os.path.join(t, "cameras.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert b[k].dtype == a[k].dtype, k
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        assert _rel(b["scale_mat_0"], want) < 1e-6


def test_normalization_recovers_sphere(tmp_path):
    """As tests/test_preprocess.py: a sphere of radius 0.45 at the origin
    with identity scale mats; the estimate's centre is near 0 and its scale
    of the object's order, and the Dataset loads the normalized case."""
    case = str(tmp_path / "case")
    tcase.write_case(case, n_views=6, H=96, W=96, radius=0.45)
    norm = tpre.get_normalization(case, seed=0, device=CPU)
    assert np.abs(norm[:3, 3]).max() < 0.15
    assert 0.1 < norm[0, 0] < 1.5
    conf = tconfig.parse_string(
        f"data_dir = {case}\nrender_cameras_name = cameras.npz\n"
        "object_cameras_name = cameras.npz\nnormal_dir = normal\n"
        "albedo_dir = albedo\nmask_dir = mask\n")
    loaded = tds.Dataset.from_conf(conf, device=CPU)
    assert np.all(np.isfinite(loaded.object_bbox_min))
    assert np.all(loaded.object_bbox_max > loaded.object_bbox_min)


def test_dtu_flag_normalizes_the_repo_scans(tmp_path, monkeypatch):
    """``--dtu`` rewrites every ``data/DTU/scan*`` case of the repo, found
    from the package's root and not from the current directory: each
    gets the scale mat of a ``--source_dir`` run on it."""
    root, elsewhere = tmp_path / "repo", tmp_path / "elsewhere"
    elsewhere.mkdir()
    for name in ("scan1", "scan2"):
        tcase.write_case(str(root / "data" / "DTU" / name), n_views=3,
                         H=24, W=24, radius=0.3 + 0.1 * (name == "scan2"))
    want = {}
    for name in ("scan1", "scan2"):
        copy = str(tmp_path / name)
        shutil.copytree(root / "data" / "DTU" / name, copy)
        want[name] = tpre.get_normalization(copy, device=CPU)
    monkeypatch.setattr(tpre, "ROOT", str(root))
    monkeypatch.chdir(elsewhere)
    tpre.main(["--dtu", "--device", CPU])
    for name in ("scan1", "scan2"):
        with np.load(root / "data" / "DTU" / name / "cameras.npz") as c:
            np.testing.assert_array_equal(c["scale_mat_0"], want[name])
    assert not np.array_equal(want["scan1"], want["scan2"])


def test_visual_hull_refinement(tmp_path):
    """As tests/test_preprocess.py: carving the sphere case recovers its
    centre and a scale consistent with its radius, and an empty hull
    raises."""
    case = str(tmp_path / "case")
    tcase.write_case(case, n_views=6, H=96, W=96, radius=0.45)
    _, masks = tpre.load_mask_points(os.path.join(case, "mask"))
    with np.load(os.path.join(case, "cameras.npz")) as cams:
        Ps = np.array([cams[f"world_mat_{i}"][:3].astype(np.float64)
                       for i in range(6)])
    centroid, scale, pts = tpre.refine_visual_hull(
        masks, Ps, scale=1.0, center=np.zeros(3), grid_size=60, device=CPU)
    assert np.abs(centroid).max() < 0.1
    assert 0.6 < scale < 1.4
    assert np.linalg.norm(pts - centroid[None], axis=1).max() < 0.6
    with pytest.raises(RuntimeError):
        tpre.refine_visual_hull(masks, Ps, scale=1.0,
                                center=np.array([50.0, 0, 0]), grid_size=10,
                                device=CPU)


def test_hull_ignores_points_behind_cameras():
    """A lattice point on or behind a camera's plane (depth <= 0) is a miss
    for that camera, never a pixel: one camera at the origin looking down
    +z, a mask full of ones, a lattice straddling z = 0."""
    K = np.array([[10.0, 0, 4], [0, 10.0, 4], [0, 0, 1]])
    P = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    Ps = np.stack([P, P])
    masks = np.ones((2, 8, 8), bool)
    args = (masks, Ps, 0.5, np.zeros(3))
    c_j, s_j, k_j = jpre.refine_visual_hull(*args, grid_size=9)
    c_t, s_t, k_t = tpre.refine_visual_hull(*args, grid_size=9, device=CPU)
    assert k_t.shape == k_j.shape and (k_t[:, 2] > 0).all()
    assert _rel(c_t, c_j) < 1e-12 and _rel(s_t, s_j) < 1e-12


# ---------------------------------------------------------------------------
# the --normalize case, and world space on it
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ns_cases(tmp_path_factory):
    """The normalized case written by both packages' writers."""
    base = tmp_path_factory.mktemp("ns")
    j, t = str(base / "j" / "torus_ns"), str(base / "t" / "torus_ns")
    jcase.write_case(j, **CASE, degrade=True, normalize=True)
    tcase.write_case(t, **CASE, degrade=True, normalize=True, device=CPU)
    return j, t


@pytest.mark.parametrize("shape", ["torus", "sphere"])
def test_write_case_normalize_equals_jax(ns_cases, tmp_path, shape):
    """``write_case(normalize=True)``: cameras within 1e-6, the maps of the
    degraded torus within one 8-bit level and those of the clean sphere
    equal; the scale mats are not the identity, and the torus's put its
    off-centre object back near the origin."""
    if shape == "torus":
        j, t = ns_cases
        levels = 1
    else:
        kw = dict(n_views=4, H=40, W=48, radius=0.4, normalize=True)
        j, t = str(tmp_path / "j"), str(tmp_path / "t")
        jcase.write_case(j, **kw)
        tcase.write_case(t, **kw, device=CPU)
        levels = 0
    for sub in ("normal", "albedo", "mask"):
        assert sorted(os.listdir(os.path.join(t, sub))) == \
            sorted(os.listdir(os.path.join(j, sub)))
        for f in sorted(os.listdir(os.path.join(j, sub))):
            a = tio.read_png(os.path.join(j, sub, f)).astype(np.int64)
            b = tio.read_png(os.path.join(t, sub, f)).astype(np.int64)
            assert np.abs(a - b).max() <= levels, (sub, f)
    with np.load(os.path.join(j, "cameras.npz")) as a, \
            np.load(os.path.join(t, "cameras.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        s = b["scale_mat_0"]
    assert not np.array_equal(s, np.eye(4))
    if shape == "torus":
        assert abs(float(s[0, 0]) - 1.0) > 0.05
        assert np.abs(s[:3, 3] - np.asarray(CENTER)).max() < 0.15


def _conf_text(case_dir, exp_dir):
    return f"""
general {{ base_exp_dir = {exp_dir}
           recording = [] }}
dataset {{ data_dir = {case_dir}
           normal_dir = normal
           albedo_dir = albedo
           mask_dir = mask
           render_cameras_name = cameras.npz
           object_cameras_name = cameras.npz }}
train {{ learning_rate = 5e-4, learning_rate_alpha = 0.05, end_iter = 6,
        warm_up_iter = 4, batch_size = 64, validate_resolution_level = 8,
        warm_up_end = 5, anneal_end = 0, use_white_bkgd = False,
        save_freq = 100, val_freq = 100, val_mesh_freq = 100,
        report_freq = 4, igr_weight = 0.1, mask_weight = 0.1 }}
model {{
  nerf {{ D = 2, d_in = 4, d_in_view = 3, W = 32, multires = 4,
         multires_view = 2, output_ch = 4, skips = [0],
         use_viewdirs = True }}
  sdf_network {{ d_out = 65, d_in = 3, d_hidden = 64, n_layers = 4,
                 skip_in = [2], multires = 4, bias = 0.5, scale = 1.0,
                 geometric_init = True, weight_norm = True }}
  variance_network {{ init_val = 0.3 }}
  rendering_network {{ d_feature = 64, mode = no_view_dir, d_in = 6,
                       d_out = 3, d_hidden = 64, n_layers = 2,
                       weight_norm = True, multires_view = 2,
                       squeeze_out = True }}
  neus_renderer {{ n_samples = 8, n_importance = 8, n_outside = 0,
                   up_sample_steps = 2, perturb = 1.0 }}
}}
"""


def test_nonsquare_rays_hit_the_normalized_object(ns_cases):
    """As tests/test_worldspace.py: the port's rays of masked pixels pass
    near the normalized origin, its corner rays miss, and they equal the
    JAX loader's rays."""
    _, t = ns_cases
    text = ("data_dir = {}\nnormal_dir = normal\nalbedo_dir = albedo\n"
            "mask_dir = mask\nrender_cameras_name = cameras.npz\n"
            "object_cameras_name = cameras.npz\n").format(t)
    d = tds.Dataset.from_conf(tconfig.parse_string(text), device=CPU)
    jd = jds.Dataset.from_conf(jconfig.parse_string(text))
    assert d.W == 76 and d.H == 56
    rays_o, rays_d = tds.gen_rays_at(d.arrays, 0, 1)[:2]
    jo, jdir = jds.gen_rays_at(jd.arrays, 0, 1)[:2]
    np.testing.assert_allclose(rays_o.reshape(-1, 3).numpy(),
                               np.asarray(jo).reshape(-1, 3), atol=1e-5)
    np.testing.assert_allclose(rays_d.reshape(-1, 3).numpy(),
                               np.asarray(jdir).reshape(-1, 3), atol=1e-5)
    rays_o = rays_o.numpy().reshape(56, 76, 3)
    rays_d = rays_d.numpy().reshape(56, 76, 3)
    ys, xs = np.nonzero(d.arrays.masks[0].numpy() > 0.5)
    o, v = rays_o[ys, xs], rays_d[ys, xs]
    closest = np.linalg.norm(o - (o * v).sum(-1)[:, None] * v, axis=-1)
    scale = float(d.scale_mats_np[0][0, 0])
    assert np.quantile(closest, 0.9) < 0.85 / scale
    for (yy, xx) in ((0, 0), (0, 75), (55, 0), (55, 75)):
        o, v = rays_o[yy, xx], rays_d[yy, xx]
        assert np.linalg.norm(o - (o * v).sum() * v) > 0.5 / scale


def test_worldspace_mesh_equals_jax_runner(ns_cases, tmp_path, monkeypatch):
    """Both runners on the normalized non-square case with the JAX
    runner's initial weights bridged into the port's. The SDF grids agree
    to an f16 ulp, or 2.4e-7 near 0 (both fetch the grid as f16, and the
    f32 sums' order moves a value by ~1e-7, which can flip a rounding);
    on the JAX grid, the port's world-space mesh
    (v x scale + t of the first scale mat) is the JAX runner's within
    1e-5."""
    from rnb_tpu.train.runner import Runner as JRunner
    from rnb_tpu_torch.models import renderer as trnd
    from rnb_tpu_torch.train.runner import Runner as TRunner

    _, t = ns_cases
    jpath, tpath = str(tmp_path / "j.conf"), str(tmp_path / "t.conf")
    with open(jpath, "w") as f:
        f.write(_conf_text(t, tmp_path / "jexp"))
    with open(tpath, "w") as f:
        f.write(_conf_text(t, tmp_path / "texp"))
    jr = JRunner(jpath, "validate_mesh", shard="off")
    tr = TRunner(tpath, "validate_mesh", device=CPU, shard="off")
    tr.state = type(tr.state)(
        params=bridge.params_from_numpy(jax.device_get(jr.state.params),
                                        device=CPU),
        optimizer=tr.state.optimizer)
    s = tr.dataset.scale_mats_np[0]
    assert abs(float(s[0, 0]) - 1.0) > 0.05
    np.testing.assert_allclose(tr.dataset.object_bbox_min,
                               jr.dataset.object_bbox_min, rtol=1e-6)

    grid_j = jr._extract_grid(32)
    grid_t = trnd.extract_fields(tr.statics, tr.state.params,
                                 tr.dataset.object_bbox_min,
                                 tr.dataset.object_bbox_max, 32)
    np.testing.assert_allclose(grid_t, grid_j, rtol=2.0 ** -10, atol=2.0 ** -22)

    jv, jf = jr.validate_mesh(world_space=True, resolution=32)
    monkeypatch.setattr(trnd, "extract_fields", lambda *a, **k: grid_j)
    tv, tf = tr.validate_mesh(world_space=True, resolution=32)
    nv, _ = tr.validate_mesh(world_space=False, resolution=32)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv, nv * s[0, 0] + s[:3, 3], rtol=0, atol=1e-6)
    # the world-space mesh sits at the scale mat's centre, not at the origin
    assert np.abs(tv.mean(0) - s[:3, 3]).max() < 0.25 * s[0, 0]


# ---------------------------------------------------------------------------
# the tools' command lines
# ---------------------------------------------------------------------------

def _stdout(fn, argv):
    buf = stdio.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def _jax_stdout(fn, argv):
    old = sys.argv
    sys.argv = ["prog"] + argv
    try:
        buf = stdio.StringIO()
        with contextlib.redirect_stdout(buf):
            fn()
    finally:
        sys.argv = old
    return buf.getvalue()


def test_eval_chamfer_cli_equals_jax(tmp_path):
    """Two torus-like meshes written by the port's PLY writer; the same
    seed gives the same --json line and the same table."""
    from rnb_tpu_torch.ops import marching_cubes as mc
    from rnb_tpu_torch.data.dataset import torus_sdf

    lin = np.linspace(-1, 1, 40)
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    paths = []
    for k, (R, r) in enumerate(((0.5, 0.22), (0.52, 0.2))):
        v, f = mc.extract_geometry(-torus_sdf(g, R, r).astype(np.float32),
                                   [-1] * 3, [1] * 3, 0.0)
        paths.append(str(tmp_path / f"m{k}.ply"))
        tio.write_ply(paths[-1], v, f)
    argv = paths + ["--n_points", "5000", "--seed", "3", "--scale", "2",
                    "--max_dist", "0.05"]
    got = _stdout(tchamfer.main, argv + ["--json"])
    assert got == _stdout(jchamfer.main, argv + ["--json"])
    assert _stdout(tchamfer.main, argv) == _stdout(jchamfer.main, argv)


def test_inspect_cameras_equals_jax(ns_cases):
    j, t = ns_cases
    a, b = os.path.join(j, "cameras.npz"), os.path.join(t, "cameras.npz")
    got = _stdout(tinspect.main, [a])
    assert got == _jax_stdout(jinspect_main, [a])
    assert "6 views" in got
    assert (_stdout(tinspect.main, [a, "--compare", b])
            == _jax_stdout(jinspect_main, [a, "--compare", b]))


def jinspect_main():
    """The JAX tool's ``__main__`` block."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("npz")
    ap.add_argument("--compare", default=None)
    args = ap.parse_args()
    if args.compare:
        jinspect.compare(args.npz, args.compare)
    else:
        jinspect.describe(args.npz)
