"""Marching cubes on the host: ``csrc/marching_cubes.cpp`` through ctypes.

The C++ source is built at first use with the host C++ compiler into
``build/native/`` at the repository root, keyed by a hash of the source,
the flags and the compiler, and loaded with ``ctypes``. The compiler is
looked for once, in this order: ``$CXX``, ``g++``, ``c++``, ``clang++``;
``build_info`` records which one built the library. A missing compiler or a
failed build raises: there is no slower fallback.

``extract_geometry`` polygonizes a grid and rescales the vertices from grid
index space into the bounding box, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "marching_cubes.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

# filled by the first library() call of the process
build_info = {"compiler": None, "path": None, "log": ""}

_lock = threading.Lock()
_lib = None


def find_compiler() -> str:
    """The path of the first host C++ compiler found."""
    for c in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        path = c and shutil.which(c)
        if path:
            return path
    raise RuntimeError("no host C++ compiler found ($CXX, g++, c++, clang++); "
                       f"marching cubes is built from {SOURCE} at first use")


def library() -> ctypes.CDLL:
    """The marching-cubes library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load()
        return _lib


def _load() -> ctypes.CDLL:
    compiler = find_compiler()
    h = hashlib.sha256(" ".join((compiler, *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libmarching_cubes_{h.hexdigest()[:16]}.so"
    build_info["compiler"] = compiler
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [compiler, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_info["log"] = f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        if proc.returncode != 0:
            raise RuntimeError(f"marching-cubes build failed ({proc.returncode}):"
                               f"\n{build_info['log']}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.mc_run.restype = ctypes.c_void_p
    lib.mc_run.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.mc_num_verts.restype = ctypes.c_long
    lib.mc_num_verts.argtypes = [ctypes.c_void_p]
    lib.mc_num_tris.restype = ctypes.c_long
    lib.mc_num_tris.argtypes = [ctypes.c_void_p]
    lib.mc_get.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                           ctypes.POINTER(ctypes.c_int32)]
    lib.mc_free.argtypes = [ctypes.c_void_p]
    build_info["path"] = str(out)
    return lib


def marching_cubes(grid: np.ndarray, isolevel: float = 0.0):
    """grid [X,Y,Z] float32 -> (vertices [N,3] in index space, faces [M,3]).
    Triangles wind so that normals point toward increasing values
    (grid = −sdf: outward)."""
    grid = np.ascontiguousarray(grid, dtype=np.float32)
    lib = library()
    h = lib.mc_run(grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                   grid.shape[0], grid.shape[1], grid.shape[2],
                   ctypes.c_float(isolevel))
    try:
        nv, nt = lib.mc_num_verts(h), lib.mc_num_tris(h)
        verts = np.empty((nv, 3), np.float32)
        tris = np.empty((nt, 3), np.int32)
        if nv:
            lib.mc_get(h, verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    finally:
        lib.mc_free(h)
    return verts, tris


def extract_geometry(grid: np.ndarray, bound_min, bound_max,
                     threshold: float = 0.0):
    """Polygonize, then rescale the vertices from index space into
    [bound_min, bound_max]."""
    resolution = grid.shape[0]
    vertices, triangles = marching_cubes(grid, threshold)
    b_min = np.asarray(bound_min, np.float32)
    b_max = np.asarray(bound_max, np.float32)
    if len(vertices):
        vertices = vertices / (resolution - 1.0) * (b_max - b_min)[None] + b_min[None]
    return vertices, triangles
