"""Build and load the package's CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` for ``sm_90a`` into ONE
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The build happens at first use, into
``build/kernels/`` at the repository root, keyed by a hash of the sources
and flags; a process that finds the library already built loads it.

Every C entry returns ``cudaGetLastError()`` after its launches;
``check`` raises on anything but 0. ``launches`` counts, per wrapper, the
launches of its kernel (each wrapper adds one where it launches).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

from rnb_tpu_torch.models.fields import round_to

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# sdf_core_fwd / sdf_core_bwd, albedo_fwd / albedo_bwd and nerf_fwd /
# nerf_bwd count the bf16 route (tensor-core kernels), the *_f32 keys the
# f32 route (CUDA-core kernels);
# sdf_dw_gemm, albedo_dw_gemm and nerf_dw_gemm count each bf16 backward's
# per-layer dW products (ops/wg.py dw_gemm).
launches = {"sdf_core_fwd": 0, "sdf_core_bwd": 0,
            "sdf_core_fwd_f32": 0, "sdf_core_bwd_f32": 0, "sdf_dw_gemm": 0,
            "albedo_fwd": 0, "albedo_bwd": 0, "albedo_fwd_f32": 0,
            "albedo_bwd_f32": 0, "albedo_dw_gemm": 0, "nerf_fwd": 0,
            "nerf_bwd": 0, "nerf_fwd_f32": 0, "nerf_bwd_f32": 0,
            "nerf_dw_gemm": 0, "sdf_fwd_ablate": 0}

# filled by the first library() call of the process
build_info = {"seconds": None, "path": None, "log": ""}

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_LLP = ctypes.POINTER(ctypes.c_longlong)

_SIGNATURES = {
    # pts, n, w, wt, b, in_dims, out_dims, skip, n_layers, multires, scale,
    # bf, c16, rec, rec_ld, sdf, feat, grad, stream
    "rnb_sdf_fwd": (_P, _LL, _P, _P, _P, _IP, _IP, _IP, _I, _I, _F, _I, _F,
                    _P, _I, _P, _P, _P, _P),
    # mode, then the arguments of rnb_sdf_fwd
    "rnb_sdf_fwd_ablate": (_I, _P, _LL, _P, _P, _P, _IP, _IP, _IP, _I, _I, _F,
                           _I, _F, _P, _I, _P, _P, _P, _P),
    # pts, n, w, wt, b, in_dims, out_dims, skip, n_layers, multires, scale,
    # bf, c16, csdf, cfeat, cgrad, rec_z, rec_t, rec_ld, abuf, bbuf, partial,
    # splits, dw, db, stream
    "rnb_sdf_bwd": (_P, _LL, _P, _P, _P, _IP, _IP, _IP, _I, _I, _F, _I, _F,
                    _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P),
    # mode, pts, n, w (bf16 image), b, in_dims, out_dims, skip, hd, w_off,
    # n_layers, multires, scale, c16, rec, sdf, feat, grad, stream
    "rnb_sdf_fwd_wg": (_I, _P, _LL, _P, _P, _IP, _IP, _IP, _IP, _LLP, _I, _I,
                       _F, _F, _P, _P, _P, _P, _P),
    # pts, n, w, b, in_dims, out_dims, skip, hd, w_off, a_off, bb_off,
    # n_layers, multires, scale, c16, csdf, cfeat, cgrad, rec_z, rec_t, abuf,
    # bbuf, dbp, db, stream
    "rnb_sdf_bwd_wg": (_P, _LL, _P, _P, _IP, _IP, _IP, _IP, _LLP, _LLP, _LLP,
                       _I, _I, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _P),
    # a, lda, b, ldb, K, M, N, kchunk, splits, partial, dw, stream
    "rnb_dw_gemm": (_P, _I, _P, _I, _LL, _I, _I, _LL, _I, _P, _P, _P),
    # pts, nrm, feat, n, F, w, b, in_dims, out_dims, n_layers, multires,
    # out, stream
    "rnb_albedo_fwd": (_P, _P, _P, _LL, _I, _P, _P, _IP, _IP, _I, _I, _P,
                       _P),
    # pts, nrm, feat, n, F, w (bf16 image), b, in_dims, out_dims, w_off,
    # n_layers, multires, out, stream
    "rnb_albedo_fwd_wg": (_P, _P, _P, _LL, _I, _P, _P, _IP, _IP, _LLP, _I,
                          _I, _P, _P),
    # pts, nrm, feat, n, F, w, wt, b, in_dims, out_dims, n_layers, multires,
    # cout, rec, rec_ld, abuf, bbuf, partial, splits, dw, db, cnrm, cfeat,
    # stream
    "rnb_albedo_bwd": (_P, _P, _P, _LL, _I, _P, _P, _P, _IP, _IP, _I, _I,
                       _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P),
    # pts, nrm, feat, n, F, w (bf16 image), b, in_dims, out_dims, w_off,
    # a_off, bb_off, n_layers, multires, cout, abuf, bbuf, dbp, db, cnrm,
    # cfeat, stream
    "rnb_albedo_bwd_wg": (_P, _P, _P, _LL, _I, _P, _P, _IP, _IP, _LLP, _LLP,
                          _LLP, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P),
    # pts, views, n, C, w, b, in_dims, out_dims, n_layers, skips, multires,
    # multires_view, alpha, rgb, stream
    "rnb_nerf_fwd": (_P, _P, _LL, _I, _P, _P, _IP, _IP, _I, _I, _I, _I, _P,
                     _P, _P),
    # pts, views, n, C, w (bf16 image), b, in_dims, out_dims, skip, w_off,
    # n_layers, of, multires, multires_view, alpha, rgb, stream
    "rnb_nerf_fwd_wg": (_P, _P, _LL, _I, _P, _P, _IP, _IP, _IP, _LLP, _I, _I,
                        _I, _I, _P, _P, _P),
    # pts, views, n, C, w, wt, b, in_dims, out_dims, n_layers, skips,
    # multires, multires_view, calpha, crgb, rec, rec_ld, abuf, bbuf,
    # partial, splits, dw, db, stream
    "rnb_nerf_bwd": (_P, _P, _LL, _I, _P, _P, _P, _IP, _IP, _I, _I, _I, _I,
                     _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P),
    # pts, views, n, C, w (bf16 image), b, in_dims, out_dims, skip, w_off,
    # a_off, bb_off, n_layers, of, multires, multires_view, calpha, crgb,
    # abuf, bbuf, dbp, db, stream
    "rnb_nerf_bwd_wg": (_P, _P, _LL, _I, _P, _P, _IP, _IP, _IP, _LLP, _LLP,
                        _LLP, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "rnb_tpu_torch are built from source at first use")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    srcs, hdrs = _sources()
    for f in srcs + hdrs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


def _load() -> ctypes.CDLL:
    out = BUILD_DIR / f"librnb_kernels_{_digest()}.so"
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        srcs, _ = _sources()
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{build_info['log']}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    lib.rnb_error_string.argtypes = [ctypes.c_int]
    lib.rnb_error_string.restype = ctypes.c_char_p
    build_info["seconds"] = time.perf_counter() - t0
    build_info["path"] = str(out)
    return lib


def ptxas_summary(*keys: str) -> dict:
    """ptxas's report (``-Xptxas -v``) of this process's build, for each
    kernel whose name holds one of ``keys``: {name: "R registers, S B spill
    stores, L B spill loads"}. Empty when the library was already built."""
    out = {}
    for m in re.finditer(r"Compiling entry function '(_Z(\d+)\w*)'(.*?)"
                         r"(?=Compiling entry function|\Z)",
                         build_info["log"], re.S):
        mangled, n, body = m.group(1), int(m.group(2)), m.group(3)
        head = len(m.group(2)) + 2
        name = mangled[head:head + n]
        mode = re.match(r"ILi(\d+)E", mangled[head + n:])
        name += f"<{mode.group(1)}>" if mode else ""
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        if any(k in name for k in keys) and regs and spill:
            out[name] = (f"{regs.group(1)} registers, {spill.group(1)} B spill "
                         f"stores, {spill.group(2)} B spill loads")
    return out


def check(rc: int, what: str) -> None:
    if rc != 0:
        msg = library().rnb_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def int_array(values) -> ctypes.Array:
    values = [int(v) for v in values]
    return (ctypes.c_int * len(values))(*values)


def ll_array(values) -> ctypes.Array:
    values = [int(v) for v in values]
    return (ctypes.c_longlong * len(values))(*values)


def splits_for(m: int, n: int, k: int) -> int:
    """Split-K factor of the dW reduction: enough blocks to cover the
    card's SMs a few times, each split at least 256 rows long."""
    tiles = ((m + 63) // 64) * ((n + 63) // 64)
    return max(1, min(-(-528 // tiles), -(-k // 256)))


def bf16_flag(dtype) -> int:
    """The C entries' op-dtype flag: 1 for bfloat16 operands, 0 for float32."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"op dtype must be bfloat16 or float32, got {dtype}")
    return int(dtype == torch.bfloat16)


def flat_params(ws, bs, dtype):
    """The C entries' weight layout: every W_l [in, out] rounded to the op
    dtype, concatenated flat; the same for every W_l^T [out, in]; every b_l
    concatenated. -> (w, wt, b, in_dims, out_dims)."""
    w16 = [round_to(w.detach(), dtype).contiguous() for w in ws]
    wflat = torch.cat([w.reshape(-1) for w in w16])
    wtflat = torch.cat([w.t().contiguous().reshape(-1) for w in w16])
    bflat = torch.cat([b.detach().reshape(-1) for b in bs]).contiguous()
    return (wflat, wtflat, bflat, [w.shape[0] for w in ws],
            [w.shape[1] for w in ws])


def unflat(flat, shapes):
    """Split a flat buffer laid out as ``flat_params`` lays out W or b."""
    out, off = [], 0
    for shp in shapes:
        size = math.prod(shp)
        out.append(flat[off:off + size].reshape(shp))
        off += size
    return out
