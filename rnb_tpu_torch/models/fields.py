"""Neural fields as plain functions over parameter trees of tensors.

Counterpart of ``rnb_tpu/models/fields.py``. A parameter tree is the JAX
package's pytree with tensors for leaves: nested dicts and lists, weight
``W`` stored ``[in, out]`` so that a layer is ``x @ W + b``, and weight-norm
layers stored as ``{v: [in, out], g: [out], b: [out]}`` with the effective
weight ``v * g / ||v||_col``. Keeping that layout lets the tests hand the
same weights to both packages (``rnb_tpu_torch.utils.bridge``).

  * SDF network: 8x256 MLP, skip concat at layer 4 divided by sqrt(2),
    softplus(beta=100), geometric init to a sphere of radius ``bias``,
    output ``[sdf/scale, feature]``.
  * Rendering (albedo) network: PE of points and normals, ReLU hidden
    layers, sigmoid squeeze.
  * Background NeRF (NeRF++ inverted-sphere net, evaluated only when
    n_outside > 0): PE of the 4-d point and of the view direction, a ReLU
    trunk whose skip after layer i concatenates ``[PE, h]`` (PE first,
    unscaled), alpha and feature heads, a views layer and an rgb head; raw
    outputs (softplus and sigmoid stay in the renderer).
  * Single-variance network: ``inv_s = exp(10 v)``.

The training path's default route (``core_impl = 'pallas'``) takes ∇SDF
from the fused kernel op (``rnb_tpu_torch.ops.sdf_core``) and the
background NeRF from ``rnb_tpu_torch.ops.nerf``; ``sdf_value_feat_grad``
(reverse mode, differentiable again through ``create_graph=True``),
``sdf_value_feat_grad_fwd`` (forward-mode tangents) and ``nerf_apply`` here
are the plain autograd forms that the ``'vjp'`` and ``'fwdmode'`` routes
run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from rnb_tpu_torch.models.embedder import make_embedder


# ---------------------------------------------------------------------------
# linear layers (with optional weight norm)
# ---------------------------------------------------------------------------

def fold_weight_norm(layer: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The effective ``[in, out]`` weight of a layer: ``v * g / ||v||`` for
    a weight-norm layer (norm per output column, floored at 1e-12), else
    ``w``. Differentiable, so autograd carries dW back to ``{v, g}``."""
    if "v" not in layer:
        return layer["w"]
    v = layer["v"]
    norm = torch.linalg.vector_norm(v, dim=0, keepdim=True)
    return v * (layer["g"][None, :] / torch.clamp_min(norm, 1e-12))


def fold_params(params):
    """``params`` detached, each weight-norm layer {v, g, b} replaced by
    {w, b} with w its folded weight: for a no-grad pass over many chunks,
    which would otherwise fold every layer again at each call (the same
    values, computed once)."""
    if isinstance(params, dict):
        if "v" in params:
            return {"w": fold_weight_norm(params).detach(),
                    "b": params["b"].detach()}
        return {k: fold_params(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(fold_params(v) for v in params)
    return params.detach()


def linear_apply(layer: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return x @ fold_weight_norm(layer) + layer["b"]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """Softplus in the stable form ``max(x,0) + log1p(e^-|x|)`` (the form
    jax.nn.softplus uses; torch's own switches to linear above a
    threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """Softplus with beta=100: ``softplus(100 x) / 100``."""
    return softplus(x * 100.0) / 100.0


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round a float32 tensor to ``dtype`` and back (identity for float32):
    the operand rounding of a matmul run in ``dtype`` with f32
    accumulation."""
    if dtype == torch.float32:
        return x
    return x.to(dtype).to(torch.float32)


# ---------------------------------------------------------------------------
# SDF network
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SDFConfig:
    d_in: int = 3
    d_out: int = 257
    d_hidden: int = 256
    n_layers: int = 8
    skip_in: Tuple[int, ...] = (4,)
    multires: int = 6
    bias: float = 0.5
    scale: float = 1.0
    geometric_init: bool = True
    weight_norm: bool = True
    inside_outside: bool = False

    @property
    def input_ch(self) -> int:
        return self.d_in * (1 + 2 * self.multires) if self.multires > 0 else self.d_in

    @property
    def dims(self) -> Tuple[int, ...]:
        return tuple([self.input_ch] + [self.d_hidden] * self.n_layers + [self.d_out])


def _torch_default_linear(gen, fan_in: int, fan_out: int, device):
    """torch.nn.Linear default init: U(±1/sqrt(fan_in)) for weight and bias."""
    bound = 1.0 / math.sqrt(fan_in)
    w = (torch.rand((fan_in, fan_out), generator=gen) * 2.0 - 1.0) * bound
    b = (torch.rand((fan_out,), generator=gen) * 2.0 - 1.0) * bound
    return {"w": w.to(device), "b": b.to(device)}


def _to_weight_norm(layer):
    """{w, b} -> {v, g, b} with w == v*g/||v|| (exact at init)."""
    w = layer["w"]
    return {"v": w, "g": torch.linalg.vector_norm(w, dim=0), "b": layer["b"]}


def init_sdf_network(gen: torch.Generator, cfg: SDFConfig,
                     device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Geometric init (matched to the JAX package in distribution; draws
    come from ``gen`` on the CPU and are moved to ``device``)."""
    dims = cfg.dims
    num_layers = len(dims)
    layers = []
    for l in range(num_layers - 1):
        out_dim = dims[l + 1] - dims[0] if (l + 1) in cfg.skip_in else dims[l + 1]
        fan_in = dims[l]
        if cfg.geometric_init:
            normal = torch.randn((fan_in, out_dim), generator=gen)
            b = torch.zeros((out_dim,))
            if l == num_layers - 2:
                mean = math.sqrt(math.pi) / math.sqrt(fan_in)
                b0 = -cfg.bias
                if cfg.inside_outside:
                    mean, b0 = -mean, cfg.bias
                w = mean + 1e-4 * normal
                b = torch.full((out_dim,), b0)
            elif cfg.multires > 0 and l == 0:
                # only raw-coordinate rows get signal; PE rows start at zero
                w = torch.zeros((fan_in, out_dim))
                w[:3, :] = math.sqrt(2.0) / math.sqrt(out_dim) * normal[:3]
            elif cfg.multires > 0 and l in cfg.skip_in:
                w = math.sqrt(2.0) / math.sqrt(out_dim) * normal
                w[-(dims[0] - 3):, :] = 0.0   # PE block of the skip input
            else:
                w = math.sqrt(2.0) / math.sqrt(out_dim) * normal
            layer = {"w": w.to(device), "b": b.to(device)}
        else:
            layer = _torch_default_linear(gen, fan_in, out_dim, device)
        if cfg.weight_norm:
            layer = _to_weight_norm(layer)
        layers.append(layer)
    return layers


def sdf_apply(cfg: SDFConfig, params, x: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., d_out]; channel 0 is the sdf (÷scale), the rest is
    the geometry feature."""
    embed_fn, _ = make_embedder(cfg.multires, cfg.d_in)
    inputs = embed_fn(x * cfg.scale)
    h = inputs
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for l, layer in enumerate(params):
        if l in cfg.skip_in:
            h = torch.cat([h, inputs], dim=-1) * inv_sqrt2
        h = linear_apply(layer, h)
        if l < len(params) - 1:
            h = softplus100(h)
    return torch.cat([h[..., :1] / cfg.scale, h[..., 1:]], dim=-1)


def _slice_sdf_head(layer):
    """The last layer cut to its sdf column (slicing commutes with the
    per-column weight norm)."""
    if "v" in layer:
        return {"v": layer["v"][:, :1], "g": layer["g"][:1], "b": layer["b"][:1]}
    return {"w": layer["w"][:, :1], "b": layer["b"][:1]}


def sdf_only(cfg: SDFConfig, params, x: torch.Tensor) -> torch.Tensor:
    """SDF channel only; skips the 256-wide feature head."""
    return sdf_apply(cfg, list(params[:-1]) + [_slice_sdf_head(params[-1])],
                     x)[..., 0]


def sdf_only_lowp(cfg: SDFConfig, params, x: torch.Tensor) -> torch.Tensor:
    """SDF channel with bf16 matmul operands and f32 accumulation, for the
    no-grad up-sampling sweeps (they only place samples). Weight-norm fold,
    positional encoding and softplus stay f32; activations are rounded to
    bf16 where the JAX package casts them."""
    bf = torch.bfloat16
    embed_fn, _ = make_embedder(cfg.multires, cfg.d_in)
    inputs = round_to(embed_fn(x * cfg.scale), bf)
    dense = [(fold_weight_norm(l), l["b"]) for l in params]
    w_last, b_last = dense[-1]
    dense = dense[:-1] + [(w_last[:, :1], b_last[:1])]
    inv_sqrt2_16 = float(torch.tensor(1.0 / math.sqrt(2.0)).to(bf))
    h = inputs
    for l, (w, b) in enumerate(dense):
        if l in cfg.skip_in:
            h = round_to(torch.cat([h, inputs], dim=-1) * inv_sqrt2_16, bf)
        h = round_to(h, bf) @ round_to(w, bf) + b
        if l < len(dense) - 1:
            h = round_to(softplus100(h), bf)
    return h[..., 0] / cfg.scale


def sdf_value_feat_grad(cfg: SDFConfig, params, pts: torch.Tensor):
    """sdf [N], feature [N,F], d sdf/d pts [N,3] by autograd (the
    ``core_impl = 'vjp'`` route). Where grad mode is on, the gradient keeps
    its graph (``create_graph=True``) so a loss on it differentiates again
    into the parameters (the second-order eikonal term); under ``no_grad``
    the outputs carry no graph."""
    keep = torch.is_grad_enabled()
    with torch.enable_grad():
        x = pts.detach().requires_grad_(True)
        out = sdf_apply(cfg, params, x)
        (grad,) = torch.autograd.grad(out[..., 0].sum(), x, create_graph=keep)
    if not keep:
        out = out.detach()
    return out[..., 0], out[..., 1:], grad


def sdf_value_feat_grad_fwd(cfg: SDFConfig, params, pts: torch.Tensor):
    """The outputs of ``sdf_value_feat_grad`` with ∇SDF from forward-mode
    tangents (the ``core_impl = 'fwdmode'`` route): beside each layer's
    activations h [N,C] their derivatives by the three input coordinates,
    Th [N,3,C], go through the same weights, so ∇SDF is a plain output of
    the chain and a loss on it is first-order in the parameters (autograd
    differentiates the chain once)."""
    n = pts.shape[0]
    u = pts * cfg.scale
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    # e = PE(u) [N, in] and T = de/du [N, 3, in]: d sin(f u_j)/d u_d =
    # f cos(f u_j) δ_jd, so each block is diagonal in (direction, channel)
    e_parts, t_parts = [u], [eye.expand(n, 3, 3)]
    for k in range(cfg.multires):
        f = 2.0 ** k
        s, c = torch.sin(u * f), torch.cos(u * f)
        e_parts += [s, c]
        t_parts += [f * c[:, None, :] * eye, -f * s[:, None, :] * eye]
    e = torch.cat(e_parts, dim=-1)
    t = torch.cat(t_parts, dim=-1)

    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    h, th = e, t
    for l, layer in enumerate(params):
        if l in cfg.skip_in:
            h = torch.cat([h, e], dim=-1) * inv_sqrt2
            th = torch.cat([th, t], dim=-1) * inv_sqrt2
        w = fold_weight_norm(layer)
        z = h @ w + layer["b"]
        tz = torch.einsum("ndi,io->ndo", th, w)
        if l < len(params) - 1:
            h = softplus100(z)
            th = tz * torch.sigmoid(z * 100.0)[:, None, :]
    # d sdf/d x: the 1/scale and the encoding's input scale cancel
    return z[:, 0] / cfg.scale, z[:, 1:], tz[:, :, 0]


# ---------------------------------------------------------------------------
# Rendering (albedo) network
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RenderingConfig:
    d_feature: int = 256
    mode: str = "no_view_dir"
    d_in: int = 6
    d_out: int = 3
    d_hidden: int = 256
    n_layers: int = 2
    weight_norm: bool = True
    multires_view: int = 4
    squeeze_out: bool = True

    @property
    def dims(self) -> Tuple[int, ...]:
        input_ch = 3 * (1 + 2 * self.multires_view) if self.multires_view > 0 else 3
        d0 = self.d_in + self.d_feature
        if self.multires_view > 0:
            if self.mode == "no_view_dir":
                d0 += 2 * (input_ch - 3)
            elif self.mode == "ps":
                d0 = input_ch
            elif self.mode == "idr":
                d0 += 3 * (input_ch - 3)
            elif self.mode == "no_normal":
                d0 += 2 * (input_ch - 3)
        return tuple([d0] + [self.d_hidden] * self.n_layers + [self.d_out])


def init_rendering_network(gen: torch.Generator, cfg: RenderingConfig,
                           device="cuda") -> List[Dict[str, torch.Tensor]]:
    dims = cfg.dims
    layers = []
    for l in range(len(dims) - 1):
        layer = _torch_default_linear(gen, dims[l], dims[l + 1], device)
        if cfg.weight_norm:
            layer = _to_weight_norm(layer)
        layers.append(layer)
    return layers


def rendering_apply(cfg: RenderingConfig, params, points, normals, view_dirs,
                    feature_vectors) -> torch.Tensor:
    if cfg.multires_view > 0:
        embed_fn, _ = make_embedder(cfg.multires_view, 3)
        points = embed_fn(points)
        normals = embed_fn(normals)
        if view_dirs is not None:
            view_dirs = embed_fn(view_dirs)
    if cfg.mode == "idr":
        h = torch.cat([points, view_dirs, normals, feature_vectors], dim=-1)
    elif cfg.mode == "no_view_dir":
        h = torch.cat([points, normals, feature_vectors], dim=-1)
    elif cfg.mode == "no_normal":
        h = torch.cat([points, view_dirs, feature_vectors], dim=-1)
    elif cfg.mode == "ps":
        h = points
    else:
        raise ValueError(f"unknown rendering mode {cfg.mode!r}")

    want = cfg.dims[0]
    if h.shape[-1] != want:
        raise ValueError(
            f"rendering_network input is {h.shape[-1]}-d but the conf implies "
            f"{want}-d (d_in={cfg.d_in}, mode={cfg.mode!r}, "
            f"multires_view={cfg.multires_view}, d_feature={cfg.d_feature}); "
            f"for mode 'no_view_dir' d_in must count points+normals only (6)")

    for l, layer in enumerate(params):
        h = linear_apply(layer, h)
        if l < len(params) - 1:
            h = torch.relu(h)
    if cfg.squeeze_out:
        h = torch.sigmoid(h)
    return h


# ---------------------------------------------------------------------------
# Background NeRF (inverted-sphere coords; only evaluated when n_outside>0)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    D: int = 8
    W: int = 256
    d_in: int = 4
    d_in_view: int = 3
    multires: int = 10
    multires_view: int = 4
    output_ch: int = 4
    skips: Tuple[int, ...] = (4,)
    use_viewdirs: bool = True

    @property
    def input_ch(self) -> int:
        return self.d_in * (1 + 2 * self.multires) if self.multires > 0 else self.d_in

    @property
    def input_ch_view(self) -> int:
        return (self.d_in_view * (1 + 2 * self.multires_view)
                if self.multires_view > 0 else self.d_in_view)


def init_nerf(gen: torch.Generator, cfg: NeRFConfig, device="cuda") -> Dict[str, Any]:
    pts_layers = [_torch_default_linear(gen, cfg.input_ch, cfg.W, device)]
    for i in range(cfg.D - 1):
        fan_in = cfg.W + cfg.input_ch if i in cfg.skips else cfg.W
        pts_layers.append(_torch_default_linear(gen, fan_in, cfg.W, device))
    return {
        "pts_layers": pts_layers,
        "views_layer": _torch_default_linear(gen, cfg.input_ch_view + cfg.W,
                                             cfg.W // 2, device),
        "feature_layer": _torch_default_linear(gen, cfg.W, cfg.W, device),
        "alpha_layer": _torch_default_linear(gen, cfg.W, 1, device),
        "rgb_layer": _torch_default_linear(gen, cfg.W // 2, 3, device),
    }


def nerf_apply(cfg: NeRFConfig, params, input_pts, input_views):
    """(density_raw [N,1], rgb_raw [N,3]). A skip at the final pts layer
    would feed W+input_ch channels into the heads, so it is refused here,
    when the net is evaluated, and not at init: a conf whose background net
    is never evaluated (n_outside = 0) still trains."""
    if cfg.skips and max(cfg.skips) >= cfg.D - 1:
        raise ValueError(
            f"nerf skips {cfg.skips} must be < D-1 = {cfg.D - 1} (a skip at "
            "the final pts layer breaks the alpha/feature head widths)")
    if not cfg.use_viewdirs:
        raise ValueError("the background NeRF needs use_viewdirs=True")
    if cfg.multires > 0:
        embed_fn, _ = make_embedder(cfg.multires, cfg.d_in)
        input_pts = embed_fn(input_pts)
    if cfg.multires_view > 0:
        embed_fn_view, _ = make_embedder(cfg.multires_view, cfg.d_in_view)
        input_views = embed_fn_view(input_views)

    h = input_pts
    for i, layer in enumerate(params["pts_layers"]):
        h = torch.relu(linear_apply(layer, h))
        if i in cfg.skips:
            h = torch.cat([input_pts, h], dim=-1)
    alpha = linear_apply(params["alpha_layer"], h)
    feature = linear_apply(params["feature_layer"], h)
    h = torch.relu(linear_apply(params["views_layer"],
                                torch.cat([feature, input_views], dim=-1)))
    rgb = linear_apply(params["rgb_layer"], h)
    return alpha, rgb


# ---------------------------------------------------------------------------
# Single-variance (deviation) network
# ---------------------------------------------------------------------------

def init_variance(init_val: float = 0.3, device="cuda") -> Dict[str, torch.Tensor]:
    return {"variance": torch.tensor(init_val, dtype=torch.float32, device=device)}


def variance_inv_s(params) -> torch.Tensor:
    """inv_s = exp(10*v); clipped at use sites to [1e-6, 1e6]."""
    return torch.exp(params["variance"] * 10.0)


# ---------------------------------------------------------------------------
# Model bundle (statics + params)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelStatics:
    sdf: SDFConfig
    color: RenderingConfig
    nerf: NeRFConfig
    variance_init: float = 0.3


def statics_from_conf(conf_model) -> ModelStatics:
    """Static net configs from a ``model`` conf section."""
    def kw(section, cls, listfields=()):
        if section not in conf_model:
            return cls()
        d = dict(conf_model[section].as_dict())
        for f in listfields:
            if f in d:
                d[f] = tuple(d[f])
        return cls(**d)

    var_init = 0.3
    if "variance_network" in conf_model:
        var_init = float(conf_model["variance_network"].get("init_val", 0.3))
    return ModelStatics(
        sdf=kw("sdf_network", SDFConfig, ("skip_in",)),
        color=kw("rendering_network", RenderingConfig),
        nerf=kw("nerf", NeRFConfig, ("skips",)),
        variance_init=var_init,
    )


def init_model_bundle(gen: torch.Generator, statics: ModelStatics,
                      device="cuda") -> Dict[str, Any]:
    return {
        "nerf": init_nerf(gen, statics.nerf, device),
        "sdf": init_sdf_network(gen, statics.sdf, device),
        "variance": init_variance(statics.variance_init, device),
        "color": init_rendering_network(gen, statics.color, device),
    }
