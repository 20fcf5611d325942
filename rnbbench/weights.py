"""The weights of a run, made on the device from the seed.

Two draws on one generator seeded with the run's seed, in the dtype they
are served in (float32): one standard normal buffer and one uniform buffer,
sliced into the layers. The layout is the one the program and the
reference both take (weights [in, out]):

  * the SDF net: NeuS's geometric init to a sphere of radius ``bias``
    (layer 0 reads only the raw coordinates, the skip layer's encoding rows
    start at zero, the last layer sqrt(pi)/sqrt(fan_in) + 1e-4 N and bias
    -``bias``, the others sqrt(2)/sqrt(fan_out) N), as weight norm
    ``{v, g = |v|, b}``;
  * the albedo net: PyTorch's ``nn.Linear`` default U(+-1/sqrt(fan_in)),
    weight-normed;
  * the background NeRF: the same default, ``{w, b}``;
  * the variance: ``init_val``.
"""

from __future__ import annotations

import math

import torch


def dims(model: dict) -> dict:
    """The layer shapes [(in, out), ...] of the conf's ``model`` section."""
    s, c, n = model["sdf_network"], model["rendering_network"], model["nerf"]
    e_sdf = s["d_in"] * (1 + 2 * s["multires"])
    width = [e_sdf] + [s["d_hidden"]] * s["n_layers"] + [s["d_out"]]
    sdf = [(width[l], width[l + 1] - e_sdf if l + 1 in s["skip_in"] else width[l + 1])
           for l in range(len(width) - 1)]
    e_view = 3 * (1 + 2 * c["multires_view"])
    c_in = c["d_in"] + c["d_feature"] + 2 * (e_view - 3)
    cw = [c_in] + [c["d_hidden"]] * c["n_layers"] + [c["d_out"]]
    color = [(cw[l], cw[l + 1]) for l in range(len(cw) - 1)]
    e_pts = n["d_in"] * (1 + 2 * n["multires"])
    e_dir = n["d_in_view"] * (1 + 2 * n["multires_view"])
    W = n["W"]
    pts = [(e_pts, W)] + [(W + e_pts if i in n["skips"] else W, W)
                          for i in range(n["D"] - 1)]
    nerf = {"pts_layers": pts, "alpha_layer": (W, 1), "feature_layer": (W, W),
            "views_layer": (W + e_dir, W // 2), "rgb_layer": (W // 2, 3)}
    return {"sdf": sdf, "color": color, "nerf": nerf, "e_sdf": e_sdf}


def make(model: dict, seed: int, device) -> dict:
    """The weight tree {nerf, sdf, variance, color} of the conf's model."""
    d = dims(model)
    s = model["sdf_network"]
    nerf_shapes = d["nerf"]["pts_layers"] + [d["nerf"][k] for k in (
        "views_layer", "feature_layer", "alpha_layer", "rgb_layer")]
    n_normal = sum(i * o for i, o in d["sdf"])
    n_uniform = sum(i * o + o for i, o in d["color"] + nerf_shapes)
    g = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(n_uniform, generator=g, device=device) * 2.0 - 1.0
    pos = {"n": 0, "u": 0}

    def take(buf, key, n):
        out = buf[pos[key]:pos[key] + n]
        pos[key] += n
        return out

    sdf = []
    last = len(d["sdf"]) - 1
    for l, (fi, fo) in enumerate(d["sdf"]):
        z = take(normal, "n", fi * fo).reshape(fi, fo)
        b = torch.zeros(fo, device=device)
        if l == last:
            w = math.sqrt(math.pi) / math.sqrt(fi) + 1e-4 * z
            b = torch.full((fo,), -float(s["bias"]), device=device)
        elif l == 0:
            w = torch.zeros_like(z)
            w[:3] = math.sqrt(2.0) / math.sqrt(fo) * z[:3]
        else:
            w = math.sqrt(2.0) / math.sqrt(fo) * z
            if l in s["skip_in"]:
                w[-(d["e_sdf"] - 3):] = 0.0
        sdf.append({"v": w, "g": torch.linalg.vector_norm(w, dim=0), "b": b})

    def default(fi, fo):
        bound = 1.0 / math.sqrt(fi)
        w = take(uniform, "u", fi * fo).reshape(fi, fo) * bound
        return {"w": w, "b": take(uniform, "u", fo) * bound}

    color = []
    for fi, fo in d["color"]:
        lay = default(fi, fo)
        color.append({"v": lay["w"], "g": torch.linalg.vector_norm(lay["w"], dim=0),
                      "b": lay["b"]})
    nerf = {"pts_layers": [default(fi, fo) for fi, fo in d["nerf"]["pts_layers"]]}
    for k in ("views_layer", "feature_layer", "alpha_layer", "rgb_layer"):
        nerf[k] = default(*d["nerf"][k])
    var = torch.tensor(float(model["variance_network"]["init_val"]), device=device)
    return {"nerf": nerf, "sdf": sdf, "variance": {"variance": var}, "color": color}


def copy_into(dst, src) -> None:
    """Copy the tree ``src`` into the program's parameter tree ``dst``,
    leaf by leaf in place (same structure and shapes, or ValueError)."""
    if isinstance(dst, dict):
        if sorted(dst) != sorted(src):
            raise ValueError(f"weight trees differ: {sorted(dst)} vs {sorted(src)}")
        for k in dst:
            copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        if len(dst) != len(src):
            raise ValueError("weight trees differ in length")
        for a, b in zip(dst, src):
            copy_into(a, b)
    else:
        if tuple(dst.shape) != tuple(src.shape):
            raise ValueError(f"leaf shape {tuple(dst.shape)} vs {tuple(src.shape)}")
        with torch.no_grad():
            dst.copy_(src)
