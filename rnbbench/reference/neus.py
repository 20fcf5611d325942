"""Plain float32 NeuS / RNb-NeuS mathematics: the benchmark's reference.

A frozen copy of the published method (NeuS, Wang et al., NeurIPS 2021;
RNb-NeuS, Brument et al., CVPR 2024), written with plain PyTorch
operations. It imports nothing of the program and takes nothing the
program made: the weights come from ``rnbbench.weights`` (the same seeded
tensors the harness copies into the program), the inputs from
``rnbbench.reference.data``.

  * fields: the SDF net (8x256, skip at 4 divided by sqrt 2, softplus with
    beta 100, weight norm), its gradient by autograd (kept for a second
    differentiation in training), the albedo net (mode ``no_view_dir``:
    PE(x), PE(n), feature; ReLU; sigmoid), the background NeRF++ net on
    ``[x/r, 1/r]`` and the single variance ``exp(10 v)``;
  * the renderer: stratified z values, four no-grad up-sampling rounds at
    inv_s = 64 * 2^i with midpoint inverse-CDF sampling, the background's
    inverted-sphere samples, the NeuS alpha with cos annealing, the
    transmittance, the eikonal term over the relaxed sphere, and the
    per-light Lambertian compositing (ReLU in warm-up);
  * the loss (L1 colour over mask sum and lights, 0.1 eikonal, mask BCE),
    its gradient and Adam (0.9, 0.999, 1e-8, bias-corrected), the learning
    rate ramped over ``warm_up_end`` steps;
  * the novel-view render (the albedo composited by the weights) and the
    grid's SDF values.

``prec`` picks the operands of every matrix product: ``f32`` (the
reference; TF32 off), ``tf32``, ``bf16`` or ``fp8`` (e4m3 with one scale a
tensor), rounded in the forward product and in the two products of its
backward. The last three serve as the controls of the correctness check.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch

from rnbbench.reference import data as rdata

SQRT_HALF = 1.0 / math.sqrt(2.0)


# ---------------------------------------------------------------------------
# precision of the products
# ---------------------------------------------------------------------------

@contextmanager
def exact_f32():
    """TF32 off for the products of the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


def _round(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "bf16":
        return x.to(torch.bfloat16).float()
    if prec == "tf32":           # 10 mantissa bits, to nearest
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)
    if prec == "fp8":
        scale = 440.0 / x.detach().abs().amax().clamp_min(1e-30)
        return (x * scale).to(torch.float8_e4m3fn).float() / scale
    raise ValueError(f"unknown precision {prec!r}")


def operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    """x rounded to ``prec`` on the forward path, the identity backward."""
    if prec == "f32":
        return x
    return x + (_round(x.detach(), prec) - x).detach()


class _Product(torch.autograd.Function):
    """x @ w with every operand of the forward and of the backward's two
    products (dx = dy w^T, dw = x^T dy) rounded to ``prec``; the backward is
    built of differentiable operations, so a second differentiation (the
    eikonal term's) runs through it."""

    @staticmethod
    def forward(ctx, x, w, prec):
        ctx.save_for_backward(x, w)
        ctx.prec = prec
        return _round(x, prec) @ _round(w, prec)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dyq = operand(dy, ctx.prec)
        return dyq @ operand(w, ctx.prec).T, operand(x, ctx.prec).T @ dyq, None


def linear(x, w, b, prec):
    if prec == "f32":
        return x @ w + b
    return _Product.apply(x, w, prec) + b


def fold(layer) -> torch.Tensor:
    """The [in, out] weight: v g / |v| (per column) with weight norm."""
    if "v" not in layer:
        return layer["w"]
    v = layer["v"]
    return v * (layer["g"] / torch.linalg.vector_norm(v, dim=0).clamp_min(1e-12))


def embed(x: torch.Tensor, multires: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(m-1) x), cos(2^(m-1) x)]."""
    parts = [x]
    for k in range(multires):
        parts += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(parts, dim=-1)


def softplus100(x):
    y = x * 100.0
    return (torch.clamp_min(y, 0.0) + torch.log1p(torch.exp(-y.abs()))) / 100.0


def softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------

def sdf_net(cfg, layers, x, prec, sdf_only=False):
    """[N,3] -> [N, 1 + feature] (sdf/scale first), or [N] with sdf_only."""
    e = embed(x * cfg["scale"], cfg["multires"])
    h = e
    last = len(layers) - 1
    for l, layer in enumerate(layers):
        if l in cfg["skip_in"]:
            h = torch.cat([h, e], dim=-1) * SQRT_HALF
        w, b = fold(layer), layer["b"]
        if l == last and sdf_only:
            w, b = w[:, :1], b[:1]
        h = linear(h, w, b, prec)
        if l < last:
            h = softplus100(h)
    if sdf_only:
        return h[:, 0] / cfg["scale"]
    return torch.cat([h[:, :1] / cfg["scale"], h[:, 1:]], dim=-1)


def sdf_value_feat_grad(cfg, layers, x, prec, create_graph):
    """(sdf [N], feature [N,F], gradient [N,3]) by autograd."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        out = sdf_net(cfg, layers, x, prec)
        (g,) = torch.autograd.grad(out[:, 0].sum(), x, create_graph=create_graph)
    if not create_graph:
        out, g = out.detach(), g.detach()
    return out[:, 0], out[:, 1:], g


def albedo_net(cfg, layers, pts, normals, feature, prec):
    h = torch.cat([embed(pts, cfg["multires_view"]),
                   embed(normals, cfg["multires_view"]), feature], dim=-1)
    for l, layer in enumerate(layers):
        h = linear(h, fold(layer), layer["b"], prec)
        if l < len(layers) - 1:
            h = torch.relu(h)
    return torch.sigmoid(h)


def nerf_net(cfg, P, pts4, dirs, prec):
    """(density_raw [N,1], rgb_raw [N,3])."""
    e = embed(pts4, cfg["multires"])
    ev = embed(dirs, cfg["multires_view"])
    h = e
    for i, layer in enumerate(P["pts_layers"]):
        h = torch.relu(linear(h, fold(layer), layer["b"], prec))
        if i in cfg["skips"]:
            h = torch.cat([e, h], dim=-1)
    alpha = linear(h, fold(P["alpha_layer"]), P["alpha_layer"]["b"], prec)
    feat = linear(h, fold(P["feature_layer"]), P["feature_layer"]["b"], prec)
    h = torch.relu(linear(torch.cat([feat, ev], dim=-1), fold(P["views_layer"]),
                          P["views_layer"]["b"], prec))
    rgb = linear(h, fold(P["rgb_layer"]), P["rgb_layer"]["b"], prec)
    return alpha, rgb


# ---------------------------------------------------------------------------
# the renderer
# ---------------------------------------------------------------------------

def transmittance_weights(alpha):
    shifted = torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-7], dim=-1)
    return alpha * torch.cumprod(shifted, dim=-1)[:, :-1]


def sample_pdf(bins, weights, n):
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    u = torch.linspace(0.5 / n, 1.0 - 0.5 / n, n, device=bins.device)
    u = u.expand(cdf.shape[0], n).contiguous()
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (idx - 1).clamp_min(0)
    above = idx.clamp_max(cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    b0, b1 = bins.gather(-1, below), bins.gather(-1, above)
    den = c1 - c0
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return b0 + (u - c0) / den * (b1 - b0)


def up_sample(o, d, z, sdf, n, inv_s):
    pts = o[:, None] + d[:, None] * z[..., None]
    r = torch.linalg.vector_norm(pts, dim=-1)
    inside = (r[:, :-1] < 1.0) | (r[:, 1:] < 1.0)
    mid = (sdf[:, :-1] + sdf[:, 1:]) * 0.5
    cos = (sdf[:, 1:] - sdf[:, :-1]) / (z[:, 1:] - z[:, :-1] + 1e-5)
    cos = torch.minimum(torch.cat([torch.zeros_like(cos[:, :1]), cos[:, :-1]], -1), cos)
    cos = cos.clamp(-1e3, 0.0) * inside
    dist = z[:, 1:] - z[:, :-1]
    prev_cdf = torch.sigmoid((mid - cos * dist * 0.5) * inv_s)
    next_cdf = torch.sigmoid((mid + cos * dist * 0.5) * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    return sample_pdf(z, transmittance_weights(alpha), n)


@torch.no_grad()
def z_values(cfg, P, o, d, near, far, t_rand, prec):
    """The 64 stratified and the 64 up-sampled depths, sorted [B,128]."""
    r = cfg["renderer"]
    ns = r["n_samples"]
    z = near + (far - near) * torch.linspace(0.0, 1.0, ns, device=o.device)[None]
    z = z + t_rand * 2.0 / ns
    sdf_cfg, layers = cfg["sdf"], P["sdf"]

    def sdf_at(zz):
        pts = o[:, None] + d[:, None] * zz[..., None]
        return sdf_net(sdf_cfg, layers, pts.reshape(-1, 3), prec,
                       sdf_only=True).reshape(zz.shape)

    sdf = sdf_at(z)
    steps = r["up_sample_steps"]
    per = r["n_importance"] // steps
    for i in range(steps):
        new = up_sample(o, d, z, sdf, per, 64.0 * 2 ** i)
        cat_z = torch.cat([z, new], -1)
        z, order = torch.sort(cat_z, dim=-1, stable=True)
        if i + 1 < steps:
            sdf = torch.cat([sdf, sdf_at(new)], -1).gather(-1, order)
    return z


def outside_z(cfg, far, t_out):
    n = cfg["renderer"]["n_outside"]
    z = torch.linspace(1e-3, 1.0 - 1.0 / (n + 1.0), n, device=far.device)
    mids = 0.5 * (z[1:] + z[:-1])
    upper = torch.cat([mids, z[-1:]])
    lower = torch.cat([z[:1], mids])
    z = lower[None] + (upper - lower)[None] * t_out
    return far / torch.flip(z, dims=[-1]) + 1.0 / cfg["renderer"]["n_samples"]


def background(cfg, P, o, d, z_feed, prec):
    """(alpha [B,S'], colour [B,S',3]) of the NeRF++ background."""
    B, S = z_feed.shape
    sample_dist = 2.0 / cfg["renderer"]["n_samples"]
    dists = torch.cat([z_feed[:, 1:] - z_feed[:, :-1],
                       torch.full_like(z_feed[:, :1], sample_dist)], -1)
    pts = o[:, None] + d[:, None] * (z_feed + dists * 0.5)[..., None]
    r = torch.linalg.vector_norm(pts, dim=-1, keepdim=True).clamp(1.0, 1e10)
    pts4 = torch.cat([pts / r, 1.0 / r], -1).reshape(-1, 4)
    dirs = d[:, None].expand(B, S, 3).reshape(-1, 3)
    density, rgb = nerf_net(cfg["nerf"], P["nerf"], pts4, dirs, prec)
    alpha = 1.0 - torch.exp(-softplus(density.reshape(B, S)) * dists)
    return alpha, torch.sigmoid(rgb).reshape(B, S, 3)


def core(cfg, P, o, d, z, cos_ratio, prec, create_graph):
    """The NeuS integrator over z [B,S] -> dict of per-sample tensors."""
    B, S = z.shape
    sample_dist = 2.0 / cfg["renderer"]["n_samples"]
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], sample_dist)], -1)
    pts = (o[:, None] + d[:, None] * (z + dists * 0.5)[..., None]).reshape(-1, 3)
    dirs = d[:, None].expand(B, S, 3).reshape(-1, 3)
    sdf, feat, grad = sdf_value_feat_grad(cfg["sdf"], P["sdf"], pts, prec, create_graph)
    albedo = albedo_net(cfg["color"], P["color"], pts, grad, feat, prec).reshape(B, S, -1)
    inv_s = torch.exp(P["variance"]["variance"] * 10.0).clamp(1e-6, 1e6)
    true_cos = (dirs * grad).sum(-1)
    iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_ratio)
                 + torch.relu(-true_cos) * cos_ratio)
    df = dists.reshape(-1)
    prev_cdf = torch.sigmoid((sdf - iter_cos * df * 0.5) * inv_s)
    next_cdf = torch.sigmoid((sdf + iter_cos * df * 0.5) * inv_s)
    alpha = ((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)).reshape(B, S).clamp(0.0, 1.0)
    r = torch.linalg.vector_norm(pts, dim=-1).reshape(B, S).detach()
    return {"alpha": alpha, "albedo": albedo, "grad": grad.reshape(B, S, 3),
            "inside": (r < 1.0).float(), "relax": (r < 1.2).float(),
            "cdf0": prev_cdf.reshape(B, S)[:, :1]}


def composite_alpha(cfg, P, o, d, z, far, t_out, c, prec):
    """The alpha over every sample: the background's outside the sphere and
    its extra samples appended, with n_outside > 0."""
    if cfg["renderer"]["n_outside"] <= 0:
        return c["alpha"], None
    z_feed, _ = torch.sort(torch.cat([z, outside_z(cfg, far, t_out)], -1), -1)
    bg_alpha, bg_rgb = background(cfg, P, o, d, z_feed, prec)
    S = z.shape[1]
    inside = c["inside"]
    alpha = c["alpha"] * inside + bg_alpha[:, :S] * (1.0 - inside)
    return torch.cat([alpha, bg_alpha[:, S:]], -1), bg_rgb


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def learning_rate(train, step: int) -> float:
    lr, wue = train["learning_rate"], train["warm_up_end"]
    if step < wue:
        return lr * step / wue
    prog = (step - wue) / max(train["end_iter"] - wue, 1e-8)
    a = train["learning_rate_alpha"]
    return lr * ((math.cos(math.pi * prog) + 1.0) * 0.5 * (1 - a) + a)


def cos_anneal(train, step: int) -> float:
    end = train["anneal_end"]
    return 1.0 if end == 0 else min(1.0, step / end)


def leaves(tree, prefix=""):
    """[(path, tensor)] of a weight tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def train_step_loss(cfg, P, inputs, step: int, prec: str, block: int):
    """Forward and backward of one training step in blocks of ``block``
    rays (the loss is a sum over rays with batch-wide normalizers: the mask
    sum, the count of relaxed-sphere samples and the batch size); the
    gradients accumulate in the leaves. -> the loss."""
    train = cfg["train"]
    o, d, near, far = inputs["o"], inputs["d"], inputs["near"], inputs["far"]
    rgb, lights, t_rand, t_out = (inputs["rgb"], inputs["lights"], inputs["t_rand"],
                                  inputs["t_out"])
    B = o.shape[0]
    warmup = inputs["warmup"]
    mask = ((inputs["mask"] > 0.5).float() if train["mask_weight"] > 0
            else torch.ones_like(inputs["mask"]))
    mask_sum = mask.sum() + 1e-5
    n_lights = rgb.shape[0]
    ns = cfg["renderer"]["n_samples"] + cfg["renderer"]["n_importance"]
    cos_ratio = cos_anneal(train, step)
    z = torch.cat([z_values(cfg, P, o[s:s + block], d[s:s + block], near[s:s + block],
                            far[s:s + block], t_rand[s:s + block], prec)
                   for s in range(0, B, block)])
    sample_dist = 2.0 / cfg["renderer"]["n_samples"]
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], sample_dist)], -1)
    r = torch.linalg.vector_norm(o[:, None] + d[:, None] * (z + dists * 0.5)[..., None], dim=-1)
    relax_count = (r < 1.2).float().sum() + 1e-5
    total = 0.0
    for s in range(0, B, block):
        sl = slice(s, s + block)
        c = core(cfg, P, o[sl], d[sl], z[sl], cos_ratio, prec, create_graph=True)
        alpha, _ = composite_alpha(cfg, P, o[sl], d[sl], z[sl], far[sl],
                                   None if t_out is None else t_out[sl], c, prec)
        w = transmittance_weights(alpha)
        shading = (c["grad"][None] * (lights if lights.shape[1] == 1 else lights[:, sl])).sum(-1, keepdim=True)
        if warmup:
            shading = torch.relu(shading)
        color = (c["albedo"][None] * w[None, :, :ns, None] * shading).sum(2)
        m = mask[sl]
        color_loss = ((color - rgb[:, sl]) * m[None]).abs().sum() / (mask_sum * n_lights)
        gnorm = torch.linalg.vector_norm(c["grad"], dim=-1)
        eik = (c["relax"] * (gnorm - 1.0) ** 2).sum() / relax_count
        ws = w.sum(-1, keepdim=True).clamp(1e-3, 1.0 - 1e-3)
        mask_loss = -(m * torch.log(ws) + (1.0 - m) * torch.log(1.0 - ws)).sum() / B
        loss = color_loss + eik * train["igr_weight"] + mask_loss * train["mask_weight"]
        loss.backward()
        total += float(loss.detach())
    return total


def adam_update(state, params, lr: float):
    """One bias-corrected Adam step of every leaf (a leaf without a
    gradient counts as a zero gradient)."""
    state["t"] += 1
    t = state["t"]
    b1, b2, eps = 0.9, 0.999, 1e-8
    with torch.no_grad():
        for name, p in params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            m = state["m"].setdefault(name, torch.zeros_like(p))
            v = state["v"].setdefault(name, torch.zeros_like(p))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
            p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def step_inputs(cfg, scene, maps, seed: int, step: int, device):
    """The draws, rays and targets of training step ``step``."""
    normals, albedo, mask = maps
    V, H, W = mask.shape
    bsz = cfg["train"]["batch_size"]
    view = rdata.view_of_step(seed, step, V)
    px, py, t_rand, t_out = rdata.step_draws(seed, step, bsz, H, W,
                                             cfg["renderer"]["n_outside"], device)
    o, d = rdata.rays(scene, view, px, py, device)
    near, far = rdata.near_far(o, d)
    warmup = step < cfg["train"]["warm_up_iter"]
    R_c2w = torch.tensor(scene.R_w2c[view].T, dtype=torch.float32, device=device)
    rgb, lights = rdata.targets(normals[view, py, px], albedo[view, py, px], R_c2w, warmup)
    return {"o": o, "d": d, "near": near, "far": far, "rgb": rgb, "lights": lights,
            "t_rand": t_rand, "t_out": t_out, "mask": mask[view, py, px][:, None],
            "warmup": warmup}


def _rows(key, v, keep):
    if not isinstance(v, torch.Tensor) or (key == "lights" and v.shape[1] == 1):
        return v
    return v[:, keep] if key in ("rgb", "lights") else v[keep]


def train_steps(cfg, P, scene, seed: int, n_steps: int, prec: str, device,
                block: int = 1024, keep=None):
    """``n_steps`` training steps from step 0 on the weights P, updated in
    place -> (the losses, {leaf: the first step's gradient}). ``keep``, a
    slice of the rays, trains on those rows alone (a fault of the checks'
    tests: part of the batch left out, the mean taken over the rest)."""
    maps = rdata.decode(scene, device)
    params = leaves(P)
    for _, p in params:
        p.requires_grad_(True)
    state = {"t": 0, "m": {}, "v": {}}
    losses, grad1 = [], None
    with exact_f32():
        for step in range(n_steps):
            for _, p in params:
                p.grad = None
            inputs = step_inputs(cfg, scene, maps, seed, step, device)
            if keep is not None:
                inputs = {k: _rows(k, v, keep) for k, v in inputs.items()}
            losses.append(train_step_loss(cfg, P, inputs, step, prec, block))
            if step == 0:
                grad1 = {n: (p.grad.detach().clone() if p.grad is not None
                             else torch.zeros_like(p)) for n, p in params}
            adam_update(state, params, learning_rate(cfg["train"], step))
    return losses, grad1


# ---------------------------------------------------------------------------
# novel views and the grid
# ---------------------------------------------------------------------------

@torch.no_grad()
def render_rays(cfg, P, o, d, t_rand, t_out, cos_ratio, prec):
    """NeuS's novel-view colour [B,3] (no background colour)."""
    near, far = rdata.near_far(o, d)
    z = z_values(cfg, P, o, d, near, far, t_rand, prec)
    c = core(cfg, P, o, d, z, cos_ratio, prec, create_graph=False)
    colour = c["albedo"][..., :3]
    alpha, bg_rgb = composite_alpha(cfg, P, o, d, z, far, t_out, c, prec)
    if bg_rgb is not None:
        S = z.shape[1]
        inside = c["inside"][..., None]
        colour = torch.cat([colour * inside + bg_rgb[:, :S] * (1.0 - inside),
                            bg_rgb[:, S:]], 1)
    w = transmittance_weights(alpha)
    return (colour * w[:, :colour.shape[1], None]).sum(1)


@torch.no_grad()
def sdf_values(cfg, P, pts, prec):
    return sdf_net(cfg["sdf"], P["sdf"], pts, prec, sdf_only=True)


def config(conf: dict) -> dict:
    """The widths and settings the reference reads, from a conf dict."""
    m = conf["model"]
    s, c, n, r = (m["sdf_network"], m["rendering_network"], m["nerf"],
                  m["neus_renderer"])
    return {"sdf": {"scale": float(s["scale"]), "multires": int(s["multires"]),
                    "skip_in": list(s["skip_in"])},
            "color": {"multires_view": int(c["multires_view"])},
            "nerf": {"multires": int(n["multires"]),
                     "multires_view": int(n["multires_view"]),
                     "skips": list(n["skips"])},
            "renderer": {k: int(r[k]) for k in ("n_samples", "n_importance",
                                                "up_sample_steps", "n_outside")},
            "train": conf["train"]}
