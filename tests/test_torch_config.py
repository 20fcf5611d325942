"""The port reads a conf's numerics knobs as the JAX package does.

One conf text goes through both packages' parser, ``train_conf`` (the conf's
runtime knobs, then the RNB_* environment overrides) and
``apply_runtime_flags(renderer_conf(...), ...)``; the resolved runtime
fields and the renderer's ``upsample_prec`` must be equal, and so must the
route knobs ``core_impl`` and ``remat`` of the renderer before and after
the flags are applied. A ``core_impl`` that is not a route is refused by a
ValueError that names it (the JAX package runs it as 'vjp');
``view_shard`` parses as in the JAX package and selects the view-sharded
step of a process group.
"""

import re

import jax
import pytest

from rnb_tpu import config as jconfig
from rnb_tpu.models import renderer as jrenderer
from rnb_tpu.train import step as jstep
from rnb_tpu_torch import config as tconfig
from rnb_tpu_torch.models import renderer as trenderer
from rnb_tpu_torch.train import step as tstep

ENV = ("RNB_MATMUL_PRECISION", "RNB_UPSAMPLE_PREC", "RNB_REMAT",
       "RNB_CORE_IMPL", "RNB_VIEW_SHARD")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    """No RNB_* override from outside; the JAX package's global matmul
    precision (which its apply_runtime_flags sets) restored afterwards."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    before = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", before)


def _resolve(config, renderer, step, conf):
    tcfg = step.train_conf(conf)
    rcfg = step.apply_runtime_flags(renderer.renderer_conf(conf["model"]), tcfg)
    return step.runtime_flags_dict(tcfg), rcfg.upsample_prec


def _both(text):
    jax_side = _resolve(jconfig, jrenderer, jstep, jconfig.parse_string(text))
    port = _resolve(tconfig, trenderer, tstep, tconfig.parse_string(text))
    return jax_side, port


CASES = {
    # the train key sets the sweeps' precision in both packages
    "train_upsample_f32": ("train { upsample_precision = f32 }\n"
                           "model { neus_renderer { n_samples = 64 } }", "f32"),
    # the renderer's own key is overwritten by train.upsample_precision
    # (default bf16), as the JAX package does
    "renderer_upsample_f32_no_train_key": (
        "model { neus_renderer { upsample_prec = f32 } }", "bf16"),
    "renderer_and_train_keys": (
        "train { upsample_precision = f32, matmul_precision = highest }\n"
        "model { neus_renderer { upsample_prec = bf16, remat = false,"
        " core_impl = pallas } }", "f32"),
    "train_view_shard": ("train { view_shard = true }\nmodel { }", "bf16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_conf_knobs_resolve_alike(case):
    text, want = CASES[case]
    jax_side, port = _both(text)
    assert port == jax_side
    assert port[1] == want


def test_env_override_wins(monkeypatch):
    monkeypatch.setenv("RNB_UPSAMPLE_PREC", "f32")
    monkeypatch.setenv("RNB_MATMUL_PRECISION", "highest")
    text = "train { upsample_precision = bf16 }\nmodel { neus_renderer { } }"
    jax_side, port = _both(text)
    assert port == jax_side
    assert port[1] == "f32" and port[0]["matmul_precision"] == "highest"


@pytest.mark.parametrize("conf", ["confs/wmask_rnb.conf", "confs/womask_rnb.conf"])
def test_shipped_confs_unchanged(conf):
    jax_side = _resolve(jconfig, jrenderer, jstep, jconfig.load_conf(conf))
    port = _resolve(tconfig, trenderer, tstep, tconfig.load_conf(conf))
    assert port == jax_side
    assert port == (tstep.runtime_flags_dict(tstep.TrainConfig()), "bf16")


def _routes(renderer, step, conf):
    """(train flags, the renderer's (core_impl, remat) as the conf gives
    them, and after ``apply_runtime_flags``)."""
    tcfg = step.train_conf(conf)
    raw = renderer.renderer_conf(conf["model"])
    rcfg = step.apply_runtime_flags(raw, tcfg)
    return (step.runtime_flags_dict(tcfg), (raw.core_impl, raw.remat),
            (rcfg.core_impl, rcfg.remat))


def _both_routes(text):
    return (_routes(jrenderer, jstep, jconfig.parse_string(text)),
            _routes(trenderer, tstep, tconfig.parse_string(text)))


ROUTES = {   # case: (conf text, the renderer's knobs after the flags)
    "renderer_core_impl_vjp": (
        "model { neus_renderer { core_impl = vjp, remat = false } }",
        ("pallas", False)),
    "renderer_remat": ("model { neus_renderer { remat = true } }",
                       ("pallas", False)),
    "train_core_impl_fwdmode": ("train { core_impl = fwdmode, remat = true }"
                                "\nmodel { }", ("fwdmode", True)),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_knobs_resolve_alike(case):
    """The renderer section's knobs are the renderer's own until the train
    section's (default 'pallas', False) overwrite them, in both packages."""
    text, want = ROUTES[case]
    jax_side, port = _both_routes(text)
    assert port == jax_side
    assert port[2] == want


@pytest.mark.parametrize("var,value,want", [
    ("RNB_CORE_IMPL", "vjp", ("vjp", False)),
    ("RNB_REMAT", "1", ("pallas", True))])
def test_env_route_knobs_resolve_alike(monkeypatch, var, value, want):
    monkeypatch.setenv(var, value)
    jax_side, port = _both_routes("train { core_impl = pallas }\nmodel { }")
    assert port == jax_side
    assert port[2] == want


@pytest.mark.parametrize("where", ["conf", "env"])
def test_unknown_core_impl_is_refused_by_name(monkeypatch, where):
    """The JAX package runs an unknown value as 'vjp'; the port refuses it
    with a ValueError that names the key and the value, from the conf and
    from the environment."""
    text = "train { core_impl = pallas }\nmodel { }"
    if where == "conf":
        text = "train { core_impl = reverse }\nmodel { }"
    else:
        monkeypatch.setenv("RNB_CORE_IMPL", "reverse")
    _resolve(jconfig, jrenderer, jstep, jconfig.parse_string(text))
    with pytest.raises(ValueError,
                       match=re.escape("train.core_impl = 'reverse'")):
        _resolve(tconfig, trenderer, tstep, tconfig.parse_string(text))
    with pytest.raises(ValueError,
                       match=re.escape("neus_renderer.core_impl = 'reverse'")):
        trenderer.RendererConfig(core_impl="reverse")


def test_env_view_shard_resolves_alike(monkeypatch):
    monkeypatch.setenv("RNB_VIEW_SHARD", "1")
    jax_side, port = _both("train { view_shard = false }\nmodel { }")
    assert port == jax_side and port[0]["view_shard"] is True
