"""Build and load the package's CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` for ``sm_90a`` into ONE
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds): one ``nvcc -c`` a source, all started
together, then one link. The build happens at first use, into
``build/kernels/`` at the repository root, keyed by a hash of the sources
and flags; a process that finds the library already built loads it.

``library("tune")`` is a second library, for the tile sweep
(``rnb_tpu_torch.tools.tune_kernel``) and the timing splits
(``rnb_tpu_torch.tools.ablate_kernel --fwd_split``, ``--bwd``,
``--wg_bwd``, ``--wg_fwd``) only: ``csrc/sdf_core.cu``, ``csrc/albedo.cu``
and ``csrc/nerf.cu`` under ``-DRNB_TUNE``, which adds the SDF core's
tensor-core sweeps at other ring depths (``rnb_sdf_fwd_wg_tune``,
``rnb_sdf_bwd_wg_tune``) and the split instances of its forward and
backward sweep (``rnb_sdf_fwd_wg_split``, ``rnb_sdf_bwd_wg_split``), the
albedo and NeRF forwards and backward sweeps at other ring depths
(``rnb_{albedo,nerf}_{fwd,bwd}_wg_tune``) and in their timing splits
(``rnb_{albedo,nerf}_{fwd,bwd}_wg_split``), beside the production entries,
into ``librnb_kernels_tune_<hash>.so``. The production library never holds
those instances.

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
import threading
from pathlib import Path

import torch

from rnb_tpu_torch.models.fields import round_to

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the ring depths the tune library's instances take (csrc/sdf_core.cu,
# RNB_TUNE): the SDF core's backward sweep (production SW_RS = 16) and
# its forward (production SF_RS = 16, the deepest that fits)
TUNE_DEPTHS = (3, 4, 5, 6)
FWD_TUNE_DEPTHS = (4, 8, 12, 16)
# the albedo and NeRF backward sweeps' (production AB_RS = 16 and NB_RS =
# 10: the deepest that fit, csrc/albedo.cu and csrc/nerf.cu)
BWD_TUNE_DEPTHS = {"albedo": (4, 8, 12, 16), "nerf": (4, 8, 10)}
# the albedo and NeRF forwards' (production AF_RS = 18 and NF_RS = 15, the
# deepest that fit)
WG_FWD_TUNE_DEPTHS = {"albedo": (4, 8, 18), "nerf": (4, 8, 15)}

# sdf_core_fwd / sdf_core_bwd, albedo_fwd / albedo_bwd and nerf_fwd /
# nerf_bwd count the bf16 route (tensor-core kernels), the *_f32 keys the
# f32 route (CUDA-core kernels);
# sdf_dw_gemm, albedo_dw_gemm and nerf_dw_gemm count each bf16 backward's
# grouped dW launch (ops/wg.py dw_products; dw_gemm, a one-layer launch,
# counts under the counter its caller names).
# sdf_value_wg counts the value-only forward of the up-sampling sweeps.
launches = {"sdf_core_fwd": 0, "sdf_core_bwd": 0, "sdf_value_wg": 0,
            "sdf_core_fwd_f32": 0, "sdf_core_bwd_f32": 0, "sdf_dw_gemm": 0,
            "albedo_fwd": 0, "albedo_bwd": 0, "albedo_fwd_f32": 0,
            "albedo_bwd_f32": 0, "albedo_dw_gemm": 0, "nerf_fwd": 0,
            "nerf_bwd": 0, "nerf_fwd_f32": 0, "nerf_bwd_f32": 0,
            "nerf_dw_gemm": 0, "sdf_fwd_ablate": 0,
            # the tune library's timing splits of the SDF-core forward and
            # backward sweep, and of the albedo and NeRF forwards and
            # backward sweeps
            "sdf_fwd_split": 0, "sdf_bwd_split": 0, "albedo_bwd_split": 0,
            "nerf_bwd_split": 0, "albedo_fwd_split": 0, "nerf_fwd_split": 0,
            # the tune library's sweeps, by ring depth
            **{f"sdf_core_fwd_rs{rs}": 0 for rs in FWD_TUNE_DEPTHS},
            **{f"sdf_core_bwd_rs{rs}": 0 for rs in TUNE_DEPTHS},
            **{f"{op}_bwd_rs{rs}": 0
               for op, depths in BWD_TUNE_DEPTHS.items() for rs in depths},
            **{f"{op}_fwd_rs{rs}": 0
               for op, depths in WG_FWD_TUNE_DEPTHS.items() for rs in depths}}

# filled by the first library(kind) call of the process, per kind
build_info = {kind: {"path": None, "log": ""}
              for kind in ("main", "tune")}

_libs = {}
_locks = {"main": threading.Lock(), "tune": threading.Lock()}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_LLP = ctypes.POINTER(ctypes.c_longlong)

_SIGNATURES = {
    # pts, n, w, wt, b, in_dims, out_dims, skip, n_layers, multires, scale,
    # c16, rec, rec_ld, sdf, feat, grad, stream
    "rnb_sdf_fwd": (_P, _LL, _P, _P, _P, _IP, _IP, _IP, _I, _I, _F, _F,
                    _P, _I, _P, _P, _P, _P),
    # mode, then the arguments of rnb_sdf_fwd
    "rnb_sdf_fwd_ablate": (_I, _P, _LL, _P, _P, _P, _IP, _IP, _IP, _I, _I, _F,
                           _F, _P, _I, _P, _P, _P, _P),
    # pts, n, w, wt, b, in_dims, out_dims, skip, n_layers, multires, scale,
    # c16, csdf, cfeat, cgrad, rec_z, rec_t, rec_ld, abuf, bbuf, partial,
    # splits, dw, db, stream
    "rnb_sdf_bwd": (_P, _LL, _P, _P, _P, _IP, _IP, _IP, _I, _I, _F, _F,
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
    # a, b, n_layers, m, n, lda, ldb, a_off, b_off, k, chunk, splits, units,
    # n_units, partial, dw, stream
    "rnb_dw_products": (_P, _P, _I, _IP, _IP, _IP, _IP, _LLP, _LLP, _LL, _LL,
                        _I, _P, _I, _P, _P, _P),
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
    # the production forward's (0) or backward sweep's (1) dynamic shared
    # memory
    "rnb_albedo_wg_smem": (_I,),
    "rnb_nerf_wg_smem": (_I,),
}

# the tune library's entries: the depth or the split, then rnb_sdf_fwd_wg's
# arguments but the mode, or the production backward's
_TUNE_SIGNATURES = {
    "rnb_sdf_fwd_wg_tune": (_I, *_SIGNATURES["rnb_sdf_fwd_wg"][1:]),
    "rnb_sdf_fwd_wg_split": (_I, *_SIGNATURES["rnb_sdf_fwd_wg"][1:]),
    "rnb_sdf_bwd_wg_tune": (_I, *_SIGNATURES["rnb_sdf_bwd_wg"]),
    "rnb_sdf_bwd_wg_split": (_I, *_SIGNATURES["rnb_sdf_bwd_wg"]),
    **{f"rnb_{op}_{pas}_{kind}": (_I, *_SIGNATURES[f"rnb_{op}_{pas}_wg"])
       for op in ("albedo", "nerf") for pas in ("fwd", "bwd")
       for kind in ("wg_tune", "wg_split")},
}
# the production entries the tune library also exports
_TUNE_PRODUCTION = ("rnb_sdf_fwd_wg", "rnb_sdf_bwd_wg", "rnb_albedo_bwd_wg",
                    "rnb_nerf_bwd_wg")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "rnb_tpu_torch are built from source at first use")


def _sources(kind: str = "main"):
    """(sources, headers) of a library: every .cu for the production one,
    the three sweeps' for the tune one."""
    srcs = ([CSRC / f for f in ("albedo.cu", "nerf.cu", "sdf_core.cu")]
            if kind == "tune" else sorted(CSRC.glob("*.cu")))
    return srcs, sorted(CSRC.glob("*.cuh"))


def _flags(kind: str):
    return NVCC_FLAGS + (("-DRNB_TUNE",) if kind == "tune" else ())


def _digest(kind: str = "main") -> str:
    h = hashlib.sha256(" ".join(_flags(kind)).encode())
    srcs, hdrs = _sources(kind)
    for f in srcs + hdrs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library(kind: str = "main") -> ctypes.CDLL:
    """The kernel library (``"main"``, or the tile sweep's ``"tune"``),
    built on first use. Two kinds may build at once, from two threads."""
    if kind not in _locks:
        raise ValueError(f"no kernel library {kind!r}; main or tune")
    with _locks[kind]:
        if kind not in _libs:
            _libs[kind] = _load(kind)
    return _libs[kind]


def _load(kind: str) -> ctypes.CDLL:
    stem = "librnb_kernels_tune" if kind == "tune" else "librnb_kernels"
    out = BUILD_DIR / f"{stem}_{_digest(kind)}.so"
    info = build_info[kind]
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        srcs, _ = _sources(kind)
        nvcc, flags = _nvcc(), _flags(kind)
        # one compile a source, all at once, then the link
        jobs = []
        for src in srcs:
            obj = tmp.with_name(f"{tmp.stem}.{src.stem}.o")
            cmd = [nvcc, *flags, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], None
        for cmd, _, proc in jobs:
            logs.append(proc.communicate()[0])
            if proc.returncode != 0 and failed is None:
                failed = (proc.returncode, cmd)
        if failed is None:
            cmd = [nvcc, *flags[:2], "-shared", "-o", str(tmp),
                   *(str(obj) for _, obj, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed = (proc.returncode, cmd)
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
        info["log"] = "".join(logs)
        if failed is not None:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n"
                               f"{' '.join(failed[1])}\n{info['log']}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    sigs = dict(_SIGNATURES)
    if kind == "tune":
        sigs = {k: sigs[k] for k in _TUNE_PRODUCTION}
        sigs.update(_TUNE_SIGNATURES)
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    lib.rnb_error_string.argtypes = [ctypes.c_int]
    lib.rnb_error_string.restype = ctypes.c_char_p
    info["path"] = str(out)
    return lib


def ptxas_summary(*keys: str, kind: str = "main") -> dict:
    """ptxas's report (``-Xptxas -v``) of this process's build of library
    ``kind``, for each kernel whose name holds one of ``keys``: {name: "R
    registers, F B stack frame, S B spill stores, L B spill loads"} (a
    stack frame holds what did not fit in registers, spilled or not), the
    name with its integer template arguments
    (``sdf_fwd_wg_kernel<0, 16, 0>``). Empty when the library was already
    built."""
    out = {}
    for m in re.finditer(r"Compiling entry function '(_Z(\d+)\w*)'(.*?)"
                         r"(?=Compiling entry function|\Z)",
                         build_info[kind]["log"], re.S):
        mangled, n, body = m.group(1), int(m.group(2)), m.group(3)
        head = len(m.group(2)) + 2
        name = mangled[head:head + n]
        targs = re.match(r"I((?:Li\d+E)+)E", mangled[head + n:])
        if targs:
            name += "<" + ", ".join(re.findall(r"Li(\d+)E", targs.group(1))) + ">"
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", body)
        if any(k in name for k in keys) and regs and spill:
            out[name] = (f"{regs.group(1)} registers, {spill.group(1)} B stack "
                         f"frame, {spill.group(2)} B spill stores, "
                         f"{spill.group(3)} B spill loads")
    return out


def check(rc: int, what: str, kind: str = "main") -> None:
    if rc != 0:
        msg = library(kind).rnb_error_string(rc).decode()
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
