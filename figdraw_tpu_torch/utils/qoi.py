"""The port's QOI decoder: a QOI file to (H, W, 4) uint8 RGBA, as PIL
12.1.0's QoiImagePlugin and `convert("RGBA")` return it. The op stream
(QOI_OP_INDEX, DIFF, LUMA, RUN, RGB, RGBA) runs in C++
(csrc/image_decode.cpp, fd_qoi_decode); `ops_plain` is its Python twin.

As PIL decodes it: the state starts at (0, 0, 0, 255) with an index of
64 zero pixels; every op but a run files its pixel in the index at
(3r + 5g + 7b + 11a) % 64 (a run files nothing); a three-channel file
tracks alpha the same way and reads opaque.
"""

from __future__ import annotations

import struct

import numpy as np

from . import image_lib

MAGIC = b"qoif"


def ops(data: bytes, n: int) -> np.ndarray:
    """n RGBA pixels from the op stream `data`, in C++."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty((n, 4), np.uint8)
    if image_lib.load().fd_qoi_decode(src.ctypes.data, len(data), out.ctypes.data, n) < 0:
        raise ValueError("truncated QOI file")
    return out


def ops_plain(data: bytes, n: int) -> np.ndarray:
    """ops in Python, op by op."""
    out = bytearray()
    index = [(0, 0, 0, 0)] * 64
    px, p = (0, 0, 0, 255), 0
    while len(out) < 4 * n:
        if p >= len(data):
            raise ValueError("truncated QOI file")
        b1 = data[p]
        p += 1
        if b1 == 0xFE:
            px = (*data[p: p + 3], px[3])
            p += 3
        elif b1 == 0xFF:
            px = tuple(data[p: p + 4])
            p += 4
        elif b1 >> 6 == 0:
            px = index[b1]
        elif b1 >> 6 == 1:
            px = ((px[0] + ((b1 >> 4) & 3) - 2) % 256, (px[1] + ((b1 >> 2) & 3) - 2) % 256,
                  (px[2] + (b1 & 3) - 2) % 256, px[3])
        elif b1 >> 6 == 2:
            b2, vg = data[p], (b1 & 63) - 32
            p += 1
            px = ((px[0] + vg - 8 + (b2 >> 4)) % 256, (px[1] + vg) % 256,
                  (px[2] + vg - 8 + (b2 & 15)) % 256, px[3])
        else:
            out += bytes(px) * ((b1 & 63) + 1)
            continue
        if len(px) != 4:
            raise ValueError("truncated QOI file")
        index[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64] = px
        out += bytes(px)
    return np.frombuffer(bytes(out[: 4 * n]), np.uint8).reshape(n, 4)


def decode_qoi(data: bytes, plain: bool = False) -> np.ndarray:
    """A QOI byte string to (H, W, 4) uint8 RGBA."""
    if data[:4] != MAGIC or len(data) < 14:
        raise ValueError("not a QOI file")
    w, h, channels = struct.unpack_from(">IIB", data, 4)
    px = (ops_plain if plain else ops)(data[14:], w * h).reshape(h, w, 4)
    if channels == 3:
        px = px.copy()
        px[..., 3] = 255
    return px
