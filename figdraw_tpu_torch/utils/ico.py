"""The port's ICO decoder: the entry PIL 12.1.0's IcoImagePlugin shows by
default, to (H, W, 4) uint8 RGBA as `Image.open(path).convert("RGBA")`
returns it.

PIL's choice, matched here: the directory entries sorted by colour depth
(the bpp field, else ceil(log2(colours)), else 256) and then, stably, by
area, largest first; the first entry is shown. A PNG entry (one that
starts with the PNG signature) decodes through utils.png.decode_png
without its tRNS chunk (PIL's ICO reader keeps the PNG's pixels and mode
but not its `transparency`). A DIB entry decodes through utils.bmp at half
its header's height, and its alpha comes, as PIL takes it:
- when the directory entry says 32 bpp, from every fourth byte of the
  first width * height * 4 bytes of the pixel data (bottom-up rows);
- otherwise from the AND mask that ends the entry (its offset + size):
  rows of width rounded up to 32 bits, bottom-up, a set bit transparent.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from . import bmp
from .png import SIGNATURE, decode_png


def _entries(data: bytes) -> list:
    if data[:4] != b"\x00\x00\x01\x00" or len(data) < 6:
        raise ValueError("not an ICO file")
    (count,) = struct.unpack_from("<H", data, 4)
    entries = []
    for i in range(count):
        if 6 + 16 * i + 16 > len(data):
            raise ValueError("truncated ICO directory")
        w, h, colors, _res, _planes, bpp, size, offset = struct.unpack_from(
            "<BBBBHHII", data, 6 + 16 * i)
        w, h = w or 256, h or 256
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256
        entries.append(dict(dim=(w, h), bpp=bpp, size=size, offset=offset, depth=depth))
    if not entries:
        raise ValueError("ICO file without an image")
    entries.sort(key=lambda e: e["depth"])
    entries.sort(key=lambda e: e["dim"][0] * e["dim"][1], reverse=True)
    return entries


def decode_ico(data: bytes) -> np.ndarray:
    """An ICO byte string to (H, W, 4) uint8 RGBA, as PIL's
    `Image.open(...).convert("RGBA")`."""
    e = _entries(data)[0]
    off = e["offset"]
    if data[off: off + 8] == SIGNATURE:
        return decode_png(data[off:], trns=False)
    b = bmp.read_header(data, off)
    h = int(b.height / 2)
    out = bmp.decode_bitmap(data, b, h)
    w = b.width
    if e["bpp"] == 32:
        raw = np.frombuffer(data, np.uint8, count=w * h * 4, offset=b.offset)
        alpha = raw[3::4].reshape(h, w)[::-1]
    else:
        pw = -(-w // 32) * 32
        total = pw * h // 8
        start = off + e["size"] - total
        if start < 0 or start + total > len(data):
            raise ValueError("truncated ICO file: the AND mask runs past the end")
        bits = np.unpackbits(np.frombuffer(data, np.uint8, total, start)).reshape(h, pw)
        alpha = np.where(bits[::-1, :w] == 1, 0, 255).astype(np.uint8)
    out[..., 3] = alpha
    return out
