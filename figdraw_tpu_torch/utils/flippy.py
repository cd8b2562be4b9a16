"""The .flippy mip-chain container, the alpha bleed and the sidecar disk
cache (figdraw_tpu/utils/flippy.py, copied: the port may not import the
JAX package).

A .flippy file is "flip" + u32 version (1) followed by one "mip!" record a
level: u32 width, u32 height, u32 compressed length, raw-Snappy-compressed
RGBA bytes (formatflippy.nim:77-149). png_to_flippy alpha-bleeds the
source and stores the full 2x mip chain (:101-112); read_image_cached keeps
a .flippy sidecar next to each source image, regenerated when the source is
newer (imgutils.nim:343-364). A sidecar written here equals figdraw_tpu's
for the same image byte for byte, and each package reads the other's.

The Snappy codec is the shared clean-room native/snappy.cpp, unchanged,
built with g++ into the package's `_build/` at first use (utils.gxx). There
is no fallback: a missing toolchain raises (figdraw_tpu writes literal-only
streams without one). `_py_uncompress` is the codec's plain Python decoder,
the tests' reference; no load path calls it. Sources decode through the
port's own decoders (utils/imagefile.py) where figdraw_tpu uses PIL.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from dataclasses import dataclass, field
from typing import List

import numpy as np

from . import gxx
from .imagefile import read_image

VERSION = 1
MAGIC = b"flip"
MIP_MAGIC = b"mip!"

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "snappy.cpp")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def load() -> ctypes.CDLL:
    """The Snappy library, built and bound at first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(gxx.build(_SRC, "figdraw_snappy", _FLAGS))
        lib.fd_snappy_max_compressed_length.argtypes = [ctypes.c_int]
        lib.fd_snappy_max_compressed_length.restype = ctypes.c_int
        lib.fd_snappy_compress.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.fd_snappy_compress.restype = ctypes.c_int
        lib.fd_snappy_uncompressed_length.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fd_snappy_uncompressed_length.restype = ctypes.c_int
        lib.fd_snappy_uncompress.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.fd_snappy_uncompress.restype = ctypes.c_int
        _lib = lib
        return _lib


# --- raw Snappy block codec ---------------------------------------------------


def snappy_compress(data: bytes) -> bytes:
    lib = load()
    src = np.frombuffer(data, dtype=np.uint8)
    cap = lib.fd_snappy_max_compressed_length(len(data))
    dst = np.empty(cap, dtype=np.uint8)
    n = lib.fd_snappy_compress(
        src.ctypes.data_as(ctypes.c_void_p) if len(data) else None,
        len(data),
        dst.ctypes.data_as(ctypes.c_void_p),
    )
    return dst[:n].tobytes()


def snappy_uncompress(data: bytes) -> bytes:
    lib = load()
    src = np.frombuffer(data, dtype=np.uint8)
    cap = lib.fd_snappy_uncompressed_length(src.ctypes.data_as(ctypes.c_void_p), len(data))
    if cap < 0:
        raise ValueError("malformed snappy stream")
    dst = np.empty(max(cap, 1), dtype=np.uint8)
    n = lib.fd_snappy_uncompress(
        src.ctypes.data_as(ctypes.c_void_p), len(data),
        dst.ctypes.data_as(ctypes.c_void_p), cap,
    )
    if n < 0:
        raise ValueError("malformed snappy stream")
    return dst[:n].tobytes()


def _py_uncompress(data: bytes) -> bytes:
    """Pure-Python raw-Snappy decoder: the C codec's plain version, for the
    tests only."""
    ip = 0
    expect = 0
    shift = 0
    while True:
        if ip >= len(data) or ip >= 5:
            raise ValueError("malformed snappy preamble")
        b = data[ip]
        ip += 1
        expect |= (b & 0x7F) << shift
        shift += 7
        if not (b & 0x80):
            break
    out = bytearray()
    n = len(data)
    while ip < n:
        tag = data[ip]
        ip += 1
        kind = tag & 3
        if kind == 0:
            ln = (tag >> 2) + 1
            if ln > 60:
                extra = ln - 60
                ln = int.from_bytes(data[ip : ip + extra], "little") + 1
                ip += extra
            out += data[ip : ip + ln]
            ip += ln
        else:
            if kind == 1:
                ln = ((tag >> 2) & 7) + 4
                offset = ((tag >> 5) << 8) | data[ip]
                ip += 1
            elif kind == 2:
                ln = (tag >> 2) + 1
                offset = int.from_bytes(data[ip : ip + 2], "little")
                ip += 2
            else:
                ln = (tag >> 2) + 1
                offset = int.from_bytes(data[ip : ip + 4], "little")
                ip += 4
            if offset <= 0 or offset > len(out):
                raise ValueError("malformed snappy copy")
            if offset >= ln:
                out += out[-offset : len(out) - offset + ln]
            else:
                for _ in range(ln):
                    out.append(out[-offset])
    if len(out) != expect:
        raise ValueError("snappy length mismatch")
    return bytes(out)


# --- image operators ------------------------------------------------------------


def _minify_by_2(img: np.ndarray) -> np.ndarray:
    """2x box filter, u8 RGBA in/out. Odd dimensions round UP with edge
    duplication — matching pixie's minifyBy2 so our mip chains have the same
    shape ladder as the reference's .flippy files (25→13, 7→4, …)."""
    h, w = img.shape[0], img.shape[1]
    if h % 2 or w % 2:
        img = np.pad(img, ((0, h % 2), (0, w % 2), (0, 0)), mode="edge")
    acc = (
        img[::2, ::2].astype(np.uint16)
        + img[1::2, ::2]
        + img[::2, 1::2]
        + img[1::2, 1::2]
    )
    return ((acc + 2) // 4).astype(np.uint8)


def _minify_by_2_alpha(img: np.ndarray) -> np.ndarray:
    """Opaque-pixel-only half-scale used by the bleed pyramid
    (formatflippy.nim:23-50): averages only a>0 texels; result is opaque
    where any contributor was, transparent black otherwise."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    q = np.stack(
        [
            img[: h2 * 2 : 2, : w2 * 2 : 2],
            img[1 : h2 * 2 : 2, : w2 * 2 : 2],
            img[: h2 * 2 : 2, 1 : w2 * 2 : 2],
            img[1 : h2 * 2 : 2, 1 : w2 * 2 : 2],
        ]
    ).astype(np.int64)
    opaque = q[..., 3] > 0
    count = opaque.sum(axis=0)
    rgb = (q[..., :3] * opaque[..., None]).sum(axis=0)
    out = np.zeros((h2, w2, 4), dtype=np.uint8)
    safe = np.maximum(count, 1)
    out[..., :3] = np.where(count[..., None] > 0, rgb // safe[..., None], 0).astype(np.uint8)
    out[..., 3] = np.where(count > 0, 255, 0).astype(np.uint8)
    return out


def alpha_bleed(img: np.ndarray) -> np.ndarray:
    """Bleed real colors into fully-transparent texels so minification never
    pulls black fringes out of a=0 areas (formatflippy.nim:18-75). Returns a
    new array; a=0 texels get the nearest coarser opaque color, alpha stays 0.
    """
    img = np.ascontiguousarray(img)
    out = img.copy()
    layers: List[np.ndarray] = []
    cur = _minify_by_2_alpha(img)
    while cur.shape[0] >= 2 and cur.shape[1] >= 2:
        layers.append(cur)
        cur = _minify_by_2_alpha(cur)
    if not layers:
        return out

    transparent = img[..., 3] == 0
    ys, xs = np.nonzero(transparent)
    if ys.size == 0:
        return out
    color = np.zeros((ys.size, 3), dtype=np.uint8)
    found = np.zeros(ys.size, dtype=bool)
    cy, cx = ys.copy(), xs.copy()
    for layer in layers:
        cy = np.minimum(cy // 2, layer.shape[0] - 1)
        cx = np.minimum(cx // 2, layer.shape[1] - 1)
        hit = (~found) & (layer[cy, cx, 3] > 0)
        color[hit] = layer[cy[hit], cx[hit], :3]
        found |= hit
    # not found anywhere → last layer's color (matches the walk ending on the
    # final layer's texel regardless of its alpha)
    if not found.all():
        rest = ~found
        color[rest] = layers[-1][cy[rest], cx[rest], :3]
    out[ys, xs, :3] = color
    out[ys, xs, 3] = 0
    return out


# --- the container ---------------------------------------------------------------


@dataclass
class Flippy:
    """Mip-chain image (formatflippy.nim:5-16)."""

    mipmaps: List[np.ndarray] = field(default_factory=list)

    @property
    def width(self) -> int:
        return self.mipmaps[0].shape[1]

    @property
    def height(self) -> int:
        return self.mipmaps[0].shape[0]

    def copy(self) -> "Flippy":
        return Flippy([m.copy() for m in self.mipmaps])


def save_flippy(flippy: Flippy, path: str) -> None:
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", VERSION))
        for mip in flippy.mipmaps:
            raw = np.ascontiguousarray(mip, dtype=np.uint8).tobytes()
            zipped = snappy_compress(raw)
            f.write(MIP_MAGIC)
            f.write(struct.pack("<III", mip.shape[1], mip.shape[0], len(zipped)))
            f.write(zipped)


def load_flippy(path: str) -> Flippy:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != MAGIC:
        raise IOError(f"Invalid Flippy header {path}.")
    (ver,) = struct.unpack_from("<I", data, 4)
    if ver != VERSION:
        raise IOError(f"Invalid Flippy version {path}.")
    pos = 8
    result = Flippy()
    while pos < len(data):
        if data[pos : pos + 4] != MIP_MAGIC:
            raise IOError(f"Invalid Flippy sub header {path}.")
        w, h, zlen = struct.unpack_from("<III", data, pos + 4)
        pos += 16
        raw = snappy_uncompress(data[pos : pos + zlen])
        pos += zlen
        mip = np.frombuffer(raw, dtype=np.uint8).reshape(h, w, 4)
        result.mipmaps.append(mip)
    return result


def image_to_flippy(img: np.ndarray, bleed: bool = True) -> Flippy:
    """Alpha-bleed + full 2x mip chain (formatflippy.nim pngToFlippy body)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3 + [np.full_like(img, 255)], axis=-1)
    if bleed:
        img = alpha_bleed(img)
    flippy = Flippy()
    mip = img
    while True:
        flippy.mipmaps.append(mip)
        if mip.shape[0] <= 1 or mip.shape[1] <= 1:
            break
        mip = _minify_by_2(mip)
    return flippy


def png_to_flippy(png_path: str, flippy_path: str) -> Flippy:
    """formatflippy.nim:101-112: read, bleed, chain, save."""
    flippy = image_to_flippy(read_image(png_path))
    save_flippy(flippy, flippy_path)
    return flippy


def read_image_cached(path: str) -> Flippy:
    """The loadImage disk cache (imgutils.nim:343-364): keep a .flippy sidecar
    next to the source, regenerated when the source is newer or when it
    cannot be read; a directory it cannot write to gives the chain in
    memory. The codec is loaded first, so a missing toolchain raises
    instead of reading as an unwritable directory."""
    load()
    flippy_path = path + ".flippy"
    try:
        if (
            os.path.exists(flippy_path)
            and os.path.getmtime(flippy_path) >= os.path.getmtime(path)
        ):
            return load_flippy(flippy_path)
    except (IOError, ValueError):
        pass  # stale/corrupt sidecar → regenerate
    flippy = image_to_flippy(read_image(path))
    try:
        save_flippy(flippy, flippy_path)
    except OSError:
        pass  # unwritable directory → the chain in memory
    return flippy
