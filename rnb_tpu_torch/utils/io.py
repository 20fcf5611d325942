"""Image, normal-map and mesh I/O: the port's copy of ``rnb_tpu/utils/io.py``.

The loaders keep the JAX package's bit-depth handling and sign conventions:

  * images: uint8/uint16 PNG -> float32 [0,1] RGB
  * normal maps: image*2-1 with the y and z components negated (camera
    space, z pointing into the scene for valid pixels)
  * masks: the first channel of the file's BGR order (blue), /255,
    binarised at 0.5
  * the savers are the loaders' exact inverses

PNGs are read and written by a codec on ``zlib`` and ``struct`` alone (no
OpenCV, no PIL): 8- and 16-bit grey, RGB and RGBA, not interlaced, all
five row filters on read. ``resize_image`` is a numpy
bilinear with OpenCV's ``INTER_LINEAR`` rule (half-pixel centres, edges
clamped). The binary PLY writer and reader are copies of the JAX package's.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (0 grey, 2 RGB, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}


# ---------------------------------------------------------------------------
# PNG codec
# ---------------------------------------------------------------------------

def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray) -> None:
    """uint8 or uint16 [H,W] (grey) or [H,W,C] (C = 3: RGB, 4: RGBA) ->
    PNG, every row with filter 0."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint8:
        depth = 8
    elif arr.dtype == np.uint16:
        depth = 16
    else:
        raise ValueError(f"PNG needs uint8 or uint16 pixels, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(c)
    if ctype is None:
        raise ValueError(f"PNG needs 1, 3 or 4 channels, got {c}")
    rows = np.ascontiguousarray(arr.astype(">u2" if depth == 16 else np.uint8))
    rows = rows.reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _paeth_row(cur: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth)."""
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = data[pos]
        row = np.frombuffer(data, np.uint8, stride, pos + 1)
        pos += stride + 1
        if ftype == 0:
            cur = row.copy()
        elif ftype == 1:        # Sub: a running sum per byte of a pixel
            cur = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:        # Up
            cur = row + prior
        elif ftype == 3:        # Average
            cur = bytearray(row.tobytes())
            pb = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((a + pb[i]) >> 1)) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        elif ftype == 4:        # Paeth
            cur = bytearray(row.tobytes())
            _paeth_row(cur, prior.tobytes(), bpp)
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype} in row {y}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """PNG -> uint8/uint16 [H,W] (grey) or [H,W,C] in the file's channel
    order (RGB, RGBA)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIG:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth not in (8, 16) or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour "
                         f"type {ctype}, interlace {interlace}); supported: 8/16"
                         "-bit grey, RGB, RGBA, not interlaced")
    c = _CHANNELS[ctype]
    bpp = c * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    img = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    img = img.reshape(h, w, c)
    return img[..., 0] if c == 1 else img


# ---------------------------------------------------------------------------
# images, normal maps, masks
# ---------------------------------------------------------------------------

def load_image(path: str) -> np.ndarray:
    """-> float32 [H,W,3] RGB in [0,1]."""
    image = read_png(path)
    if image.dtype == np.uint8:
        denom = np.float32(2 ** 8 - 1)
    elif image.dtype == np.uint16:
        denom = np.float32(2 ** 16 - 1)
    else:
        raise ValueError(f"unsupported bit depth {image.dtype} for {path}")
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    return np.ascontiguousarray(image[..., :3], dtype=np.float32) / denom


def load_normal(path: str) -> np.ndarray:
    """-> float32 [H,W,3] camera-space normal in [-1,1], y and z negated."""
    normal = load_image(path) * 2.0 - 1.0
    normal[..., 1] = -normal[..., 1]
    normal[..., 2] = -normal[..., 2]
    return normal


def load_mask(path: str) -> np.ndarray:
    """-> float32 [H,W] binarised at 0.5; a colour mask is read from its
    blue channel (the first in OpenCV's BGR order)."""
    img = read_png(path)
    if img.ndim == 3:
        img = img[..., 2]
    img = img.astype(np.float64) / 255.0
    return np.where(img > 0.5, 1.0, 0.0).astype(np.float32)


def save_image(path: str, image: np.ndarray, bit_depth: int = 8) -> None:
    """[H,W,3] RGB float [0,1] -> PNG of ``bit_depth`` (8 or 16)."""
    arr = np.clip(np.asarray(image, np.float64) * (2 ** bit_depth - 1),
                  0, 2 ** bit_depth - 1)
    arr = arr.astype(np.uint8 if bit_depth == 8 else np.uint16)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png(path, arr)


def save_normal(path: str, normal: np.ndarray, bit_depth: int = 8) -> None:
    """Inverse of load_normal."""
    n = np.array(normal, copy=True)
    n[..., 1] = -n[..., 1]
    n[..., 2] = -n[..., 2]
    save_image(path, (n + 1.0) / 2.0, bit_depth=bit_depth)


def _linear_taps(n_in: int, n_out: int):
    """Source indices and weights of OpenCV's INTER_LINEAR along one axis:
    x = (d + 0.5) * n_in / n_out - 0.5, clamped to the edge pixels."""
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(x).astype(np.int64)
    f = x - i0
    f = np.where(i0 < 0, 0.0, f)
    f = np.where(i0 >= n_in - 1, 0.0, f)
    i0 = np.clip(i0, 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    return i0, i1, f


def resize_image(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Bilinear resize of [H,W] or [H,W,C] to [h,w](,C), keeping the dtype."""
    img = np.asarray(img)
    src = img.astype(np.float64)
    y0, y1, fy = _linear_taps(img.shape[0], h)
    x0, x1, fx = _linear_taps(img.shape[1], w)
    fy = fy.reshape((-1, 1) + (1,) * (img.ndim - 2))
    fx = fx.reshape((1, -1) + (1,) * (img.ndim - 2))
    top = src[y0][:, x0] * (1 - fx) + src[y0][:, x1] * fx
    bot = src[y1][:, x0] * (1 - fx) + src[y1][:, x1] * fx
    return (top * (1 - fy) + bot * fy).astype(img.dtype)


# ---------------------------------------------------------------------------
# PLY export (binary little-endian, optional per-vertex colour)
# ---------------------------------------------------------------------------

def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
              vertex_colors: np.ndarray | None = None) -> None:
    """Minimal binary PLY writer; vertex_colors float [0,1] or uint8."""
    vertices = np.asarray(vertices, dtype="<f4")
    faces = np.asarray(faces, dtype="<i4")
    n_v, n_f = len(vertices), len(faces)

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n_v}",
              "property float x", "property float y", "property float z"]
    if vertex_colors is not None:
        vc = np.asarray(vertex_colors)
        if vc.dtype != np.uint8:
            vc = np.clip(vc * 255.0, 0, 255).astype(np.uint8)
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [f"element face {n_f}", "property list uchar int vertex_indices",
               "end_header"]

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if vertex_colors is not None:
            vert_dt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec = np.empty(n_v, dtype=vert_dt)
            rec["xyz"] = vertices
            rec["rgb"] = vc
            rec.tofile(f)
        else:
            vertices.tofile(f)
        face_dt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
        rec = np.empty(n_f, dtype=face_dt)
        rec["n"] = 3
        rec["idx"] = faces
        rec.tofile(f)


def read_ply(path: str):
    """Reader for the files write_ply produces -> (verts, faces, colors)."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        n_v = n_f = 0
        has_color = False
        while True:
            line = f.readline().strip().decode()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element face"):
                n_f = int(line.split()[-1])
            elif line.startswith("property uchar red"):
                has_color = True
            elif line == "end_header":
                break
        if has_color:
            vert_dt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec = np.fromfile(f, dtype=vert_dt, count=n_v)
            verts, colors = rec["xyz"].copy(), rec["rgb"].copy()
        else:
            verts = np.fromfile(f, dtype="<f4", count=n_v * 3).reshape(n_v, 3)
            colors = None
        face_dt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
        faces = np.fromfile(f, dtype=face_dt, count=n_f)["idx"].copy()
    return verts, faces, colors


# ---------------------------------------------------------------------------
# uncompressed AVI video
# ---------------------------------------------------------------------------

def _riff(tag: bytes, data: bytes) -> bytes:
    return tag + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)


def _riff_list(kind: bytes, tag: bytes, data: bytes) -> bytes:
    return _riff(kind, tag + data)


def write_avi(path: str, frames, fps: int = 30) -> None:
    """uint8 RGB frames [H,W,3] (all one size) -> an uncompressed RIFF AVI:
    one video stream of 24-bit BGR DIB frames (``00db`` chunks, each row
    padded to 4 bytes), with an ``idx1`` index. Rows are stored top-down (a
    negative DIB height): OpenCV's FFmpeg reader crashes on the bottom-up
    form of such files."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("write_avi needs at least one frame")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.dtype != np.uint8 or f.shape != (h, w, 3):
            raise ValueError(f"frames must be uint8 [{h},{w},3], got "
                             f"{f.dtype} {f.shape}")
    stride = (3 * w + 3) & ~3
    size = stride * h
    n = len(frames)
    avih = struct.pack("<14I", 1_000_000 // fps, size * fps, 0, 0x10, n, 0, 1,
                       size, w, h, 0, 0, 0, 0)
    strh = (b"vids" + b"DIB " + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1, fps,
                                            0, n, size, 0xFFFFFFFF, 0)
            + struct.pack("<4h", 0, 0, w, h))
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, size, 0, 0, 0, 0)
    hdrl = _riff_list(b"LIST", b"hdrl", _riff(b"avih", avih) + _riff_list(
        b"LIST", b"strl", _riff(b"strh", strh) + _riff(b"strf", strf)))
    rows = np.zeros((h, stride), np.uint8)
    chunks, index = [], []
    offset = 4                                  # from the 'movi' tag
    for f in frames:
        rows[:, :3 * w] = f[:, :, ::-1].reshape(h, 3 * w)
        chunk = _riff(b"00db", rows.tobytes())
        index.append(b"00db" + struct.pack("<III", 0x10, offset, size))
        chunks.append(chunk)
        offset += len(chunk)
    movi = _riff_list(b"LIST", b"movi", b"".join(chunks))
    body = b"AVI " + hdrl + movi + _riff(b"idx1", b"".join(index))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def read_avi(path: str) -> np.ndarray:
    """Reader for the files write_avi produces -> uint8 RGB [N,H,W,3]."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path} is not an AVI file")
    w = h = None
    frames = []

    def walk(pos, end):
        nonlocal w, h
        while pos + 8 <= end:
            tag = data[pos:pos + 4]
            n = struct.unpack_from("<I", data, pos + 4)[0]
            body = pos + 8
            if tag == b"LIST":
                walk(body + 4, body + n)
            elif tag == b"strf":
                size, w, h, _, bits, comp = struct.unpack_from("<IiiHHI", data, body)
                if bits != 24 or comp != 0:
                    raise ValueError(f"{path}: only 24-bit uncompressed frames")
            elif tag == b"00db":
                stride = (3 * w + 3) & ~3
                rows = np.frombuffer(data, np.uint8, stride * abs(h), body)
                img = rows.reshape(abs(h), stride)[:, :3 * w].reshape(abs(h), w, 3)
                # a positive DIB height stores the rows bottom-up
                frames.append(img[::-1 if h > 0 else 1, :, ::-1])
            pos = body + n + (n & 1)

    walk(12, len(data))
    return np.stack(frames)
