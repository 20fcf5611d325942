"""The up-sampling sweeps' value-only SDF op (rnb_tpu_torch.ops.sdf_core:
``sdf_value_plain``, ``sdf_value_fused``) and its route in the renderer
(``renderer._sdf_infer``, ``upsampled_z_vals``) on the CPU.

The plain version of the value kernel is held against the port's
``fields.sdf_only_lowp`` and the JAX package's ``sdf_only_lowp`` on the
shipped SDF nets of both confs at 64, 1,000 (ragged) and 4,096 points, at
the bf16 tolerance tests/test_torch_fields.py gives ``sdf_only_lowp``
(rtol = atol = 1e-2: both sides round the same operands to bf16, but a
one-ulp difference upstream can flip a rounding). The route: the plain
fields on the CPU, at f32 operands, on the 'vjp' and 'fwdmode' routes and
for a net the kernels do not take; the kernel op where the tensors are on
the card (forced here, with the op stubbed), its weights made once a call,
and the points of each route counted. tests/test_torch_kernels.py holds
the CUDA kernel against the plain version on the card.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rnb_tpu import config as jconfig
from rnb_tpu.models import fields as jfields
from rnb_tpu_torch import config as tconfig
from rnb_tpu_torch.data import cameras
from rnb_tpu_torch.models import fields as tfields
from rnb_tpu_torch.models import renderer
from rnb_tpu_torch.ops import sdf_core
from rnb_tpu_torch.utils import bridge, trace

torch.set_num_threads(1)

CONFS = ("confs/wmask_rnb.conf", "confs/womask_rnb.conf")


def _nets(conf, seed=0):
    """(JAX cfg, port cfg, JAX params, port params): the conf's SDF net at
    its geometric init moved off it, so every layer carries signal."""
    jcfg = jfields.statics_from_conf(jconfig.load_conf(conf)["model"]).sdf
    tcfg = tfields.statics_from_conf(tconfig.load_conf(conf)["model"]).sdf
    jp = jax.device_get(jfields.init_sdf_network(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for layer in jp:
        layer["v"] = np.asarray(layer["v"]) + 0.02 * rng.standard_normal(
            layer["v"].shape).astype(np.float32)
    return jcfg, tcfg, jp, bridge.params_from_numpy(jp, device="cpu")


def _pts(n, seed=1):
    return np.random.default_rng(seed).uniform(-0.9, 0.9, (n, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=CONFS, ids=["wmask", "womask"])
def nets(request):
    return _nets(request.param)


@pytest.mark.parametrize("against", ["port", "jax"])
@pytest.mark.parametrize("n", [64, 1000, 4096])
def test_value_plain_matches_sdf_only_lowp(nets, n, against):
    jcfg, tcfg, jp, tp = nets
    x = _pts(n)
    ws = [tfields.fold_weight_norm(l) for l in tp]
    bs = [l["b"] for l in tp]
    got = sdf_core.sdf_value_plain(tcfg, torch.tensor(x), ws, bs).detach().numpy()
    if against == "port":
        want = tfields.sdf_only_lowp(tcfg, tp, torch.tensor(x)).detach().numpy()
    else:
        want = np.asarray(jfields.sdf_only_lowp(jcfg, jp, x))
    assert got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


def test_value_op_on_the_cpu_is_the_plain_version(nets):
    """``sdf_value_fused`` on CPU tensors: the plain version, on weights it
    folds itself or is given (no image: ``wg_pack`` is the card's)."""
    _, tcfg, _, tp = nets
    x = torch.tensor(_pts(200))
    weights = sdf_core.value_weights(tcfg, tp)
    assert weights[2] is None
    want = sdf_core.sdf_value_plain(tcfg, x, *weights[:2])
    assert torch.equal(sdf_core.sdf_value_fused(tcfg, tp, x), want)
    assert torch.equal(sdf_core.sdf_value_fused(tcfg, tp, x, weights), want)


# --- the route --------------------------------------------------------------

B = 24


def _scene(conf=CONFS[0]):
    statics = tfields.statics_from_conf(tconfig.load_conf(conf)["model"])
    params = {"sdf": _nets(conf)[3]}
    gen = torch.Generator().manual_seed(2)
    o = torch.nn.functional.normalize(torch.randn(B, 3, generator=gen), dim=-1) * 2.5
    target = 0.3 * (torch.rand(B, 3, generator=gen) - 0.5)
    d = torch.nn.functional.normalize(target - o, dim=-1)
    near, far = cameras.near_far_from_sphere(o, d)
    rcfg = renderer.RendererConfig()
    z = renderer.init_z_vals(rcfg, near, far, torch.rand(B, 1, generator=gen) - 0.5)
    return statics, params, rcfg, o, d, z


@pytest.fixture
def kernel_stub(monkeypatch):
    """The card forced (``renderer._on_card``) and the value op stubbed by
    its plain version; -> the list of (n, weights) of each call and of
    ``value_weights``'s calls."""
    calls = {"op": [], "weights": 0}
    make = sdf_core.value_weights

    def weights(cfg, params):
        calls["weights"] += 1
        return make(cfg, params)

    def op(cfg, params, pts, w=None):
        calls["op"].append((pts.shape[0], w))
        return sdf_core.sdf_value_plain(cfg, pts, *(w or make(cfg, params))[:2])

    monkeypatch.setattr(renderer, "_on_card", lambda t: True)
    monkeypatch.setattr(sdf_core, "value_weights", weights)
    monkeypatch.setattr(sdf_core, "sdf_value_fused", op)
    return calls


@pytest.mark.parametrize("case", ["cpu", "f32", "vjp", "fwdmode", "unsupported"])
def test_sdf_infer_keeps_the_plain_path(monkeypatch, case):
    """The plain fields wherever one condition of the kernel route fails;
    the value op (made to raise) is never called."""
    statics, params, _, _, _, _ = _scene()
    x = torch.tensor(_pts(150))
    prec, core_impl = "f32" if case == "f32" else "bf16", "pallas"
    if case in ("vjp", "fwdmode"):
        core_impl = case
    if case == "unsupported":   # no positional encoding: the kernels need it
        statics = dataclasses.replace(
            statics, sdf=dataclasses.replace(statics.sdf, multires=0))
        params = {"sdf": tfields.init_sdf_network(
            torch.Generator().manual_seed(0), statics.sdf, device="cpu")}
    if case != "cpu":
        monkeypatch.setattr(renderer, "_on_card", lambda t: True)

    def refuse(*a, **k):
        raise AssertionError("the value op ran")

    monkeypatch.setattr(sdf_core, "sdf_value_fused", refuse)
    got = renderer._sdf_infer(statics, params, x, prec, core_impl)
    field = tfields.sdf_only_lowp if prec == "bf16" else tfields.sdf_only
    assert torch.equal(got, field(statics.sdf, params["sdf"], x))


def test_sdf_infer_takes_the_kernel_on_the_card(kernel_stub):
    statics, params, _, _, _, _ = _scene()
    x = torch.tensor(_pts(150))
    got = renderer._sdf_infer(statics, params, x, "bf16", "pallas")
    assert [n for n, _ in kernel_stub["op"]] == [150]
    assert torch.equal(got, sdf_core.sdf_value_plain(
        statics.sdf, x, *sdf_core.value_weights(statics.sdf, params["sdf"])[:2]))


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_upsampled_z_vals_counts_its_points(kernel_stub, monkeypatch, route):
    """One call queries B x 112 points (64, then 16 in each of three
    rounds; the fourth queries none), all under the route's counter; the
    kernel route folds and packs its weights once for the four sweeps, and
    its z-values stay within a bf16 rounding's reach of the plain route's."""
    statics, params, rcfg, o, d, z = _scene()
    if route == "plain":
        monkeypatch.setattr(renderer, "_on_card", lambda t: False)
    with trace.recording():
        got = renderer.upsampled_z_vals(statics, rcfg, params, o, d, z)
        counters = trace.summary()["counters"]
    want = {f"upsample.{route}_points": B * 112}
    assert counters == want
    if route == "plain":
        assert not kernel_stub["op"] and kernel_stub["weights"] == 0
        return
    assert [n for n, _ in kernel_stub["op"]] == [B * 64] + [B * 16] * 3
    assert kernel_stub["weights"] == 1
    assert len({id(w) for _, w in kernel_stub["op"]}) == 1
    monkeypatch.setattr(renderer, "_on_card", lambda t: False)
    plain = renderer.upsampled_z_vals(statics, rcfg, params, o, d, z)
    f32 = renderer.upsampled_z_vals(
        statics, dataclasses.replace(rcfg, upsample_prec="f32"), params, o, d, z)
    assert got.shape == plain.shape == (B, 128)
    # the kernel's algorithm moves fewer samples off the plain bf16 sweeps'
    # than bf16 itself moves off f32, and lands as close to f32
    dz, bf = (got - plain).abs(), (plain - f32).abs()
    assert (dz > 1e-4).float().mean() < 0.25 * (bf > 1e-4).float().mean()
    assert (got - f32).abs().mean() <= 1.25 * bf.mean()
