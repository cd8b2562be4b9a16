"""The port's image decoder: PNG files to (H, W, 4) uint8 RGBA, as PIL's
`Image.open(path).convert("RGBA")` returns them (figdraw_tpu decodes through
PIL in resources.load_image and utils/flippy.py; the port may not import
PIL). zlib, struct and numpy, plus a small C++ unfilter.

Covered: colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and
6 (RGBA) at every bit depth the PNG spec allows for each (1, 2, 4, 8, 16);
`PLTE` with `tRNS`, `tRNS` on grey and on RGB; Adam7 interlace; any number
of IDAT chunks; the five row filters. Every chunk's CRC is checked; a bad
signature, a bad CRC, a truncated file or zlib stream, or a malformed
header raises ValueError. Ancillary chunks other than tRNS are ignored, as
PIL's RGBA conversion ignores them (gamma, colour profiles, text).

PIL's conversions, matched here quirks included (found by
tests/test_torch_png.py against PIL 12.1.0):
- grey of 1, 2 or 4 bits scales to 0..255 (x255, x85, x17);
- 16-bit grey opens as PIL's "I;16", whose RGBA conversion clips the
  sample at 255 instead of scaling it (a 16-bit sample of 256 or more is
  white);
- 16-bit RGB, grey + alpha and RGBA keep each sample's high byte;
- a tRNS colour (grey or RGB) makes alpha 0 where the converted 8-bit
  pixel equals the key's low byte (a 1-bit grey key scales to 0 or 255):
  PIL compares the pixel after conversion with the raw key cut to a
  byte, so a 2- or 4-bit grey key other than 0 and a 16-bit key never
  match the pixels they name, and a 16-bit key can match other pixels;
- a palette index past the end of PLTE is opaque black.

The row filters Sub, Average and Paeth read the reconstructed byte to the
left, so a row is sequential: `unfilter` runs them in C++
(csrc/png_unfilter.cpp, built with g++ at first use; a missing toolchain
raises). `unfilter_plain` is the same in numpy and Python, the tests'
reference.

The other formats decode in their own modules; utils/imagefile.py picks
the decoder by a file's leading bytes.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib

import numpy as np

from . import gxx

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# the bit depths each colour type allows, and its samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "png_unfilter.cpp")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None


def load() -> ctypes.CDLL:
    """The unfilter library, built and bound at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(gxx.build(_SRC, "figdraw_png", _FLAGS))
            lib.fd_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.fd_png_unfilter.restype = ctypes.c_int
            _lib = lib
        return _lib


def unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """h filtered scanlines (a filter byte and `stride` bytes each) to the
    (h, stride) uint8 rows, in C++."""
    src = np.frombuffer(data, np.uint8, count=h * (stride + 1))
    out = np.empty((h, stride), np.uint8)
    rc = load().fd_png_unfilter(src.ctypes.data, out.ctypes.data, h, stride, bpp)
    if rc < 0:
        raise ValueError(f"PNG row {-1 - rc} has an unknown filter type")
    return out


def unfilter_plain(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """unfilter in numpy (None, Sub and Up vectorised) and Python (Average
    and Paeth, byte by byte): the tests' reference."""
    src = np.frombuffer(data, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, row = int(src[y, 0]), src[y, 1:]
        if ft == 0:
            out[y] = row
        elif ft == 1:
            out[y] = (row.reshape(-1, bpp).astype(np.int64).cumsum(axis=0) % 256
                      ).reshape(-1)
        elif ft == 2:
            out[y] = row + prev
        elif ft in (3, 4):
            cur, line, up = bytearray(stride), row.tobytes(), prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                cur[i] = (line[i] + pred) & 0xFF
            out[y] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has an unknown filter type")
        prev = out[y]
    return out


def _chunks(data: bytes):
    """(IHDR fields, PLTE, tRNS, the IDAT stream) of a PNG byte string,
    every chunk's CRC checked, through IEND."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file: bad signature")
    pos, ihdr, plte, trns, idat = 8, None, None, None, []
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated PNG file: no IEND chunk")
        n, kind = struct.unpack_from(">I4s", data, pos)
        if pos + 12 + n > len(data):
            raise ValueError(f"truncated PNG file: chunk {kind!r} runs past the end")
        body = data[pos + 8: pos + 8 + n]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + n)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + n
        if ihdr is None and kind != b"IHDR":
            raise ValueError("PNG file does not start with IHDR")
        if kind == b"IHDR":
            if n != 13:
                raise ValueError("malformed PNG IHDR")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            return ihdr, plte, trns, b"".join(idat)
        elif not kind[0] & 0x20:  # an unknown critical chunk
            raise ValueError(f"PNG critical chunk {kind!r} is not supported")


def _unpack(rows: np.ndarray, w: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered (h, stride) rows to (h, w, channels) samples."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, : w * channels].reshape(h, w, channels)
    if depth == 16:
        return (rows[:, : w * channels * 2].reshape(h, w * channels, 2).astype(np.uint16)
                @ np.array([256, 1], np.uint16)).reshape(h, w, channels)
    bits = np.unpackbits(rows, axis=1)[:, : w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[..., None]


def decode_png(data: bytes, trns: bool = True) -> np.ndarray:
    """A PNG byte string to (H, W, 4) uint8 RGBA, as PIL's
    `Image.open(...).convert("RGBA")`. trns=False ignores a tRNS chunk (an
    ICO's PNG entry: PIL's ICO reader keeps no `transparency`)."""
    ihdr, plte, trns_chunk, stream = _chunks(data)
    trns = trns_chunk if trns else None
    w, h, depth, ct, method, filt, interlace = ihdr
    if ct not in _DEPTHS or depth not in _DEPTHS[ct]:
        raise ValueError(f"PNG colour type {ct} at bit depth {depth} is invalid")
    if method != 0 or filt != 0 or interlace not in (0, 1) or w == 0 or h == 0:
        raise ValueError("malformed PNG IHDR")
    if ct == 3 and plte is None:
        raise ValueError("palette PNG without a PLTE chunk")
    channels = _CHANNELS[ct]
    z = zlib.decompressobj()
    try:
        raw = z.decompress(stream)
    except zlib.error as exc:
        raise ValueError(f"corrupt PNG image data: {exc}") from None
    if not z.eof:
        raise ValueError("truncated PNG image data")
    bpp = max(1, channels * depth // 8)
    samples = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * channels * depth + 7) // 8
        size = ph * (stride + 1)
        if pos + size > len(raw):
            raise ValueError("truncated PNG image data")
        rows = unfilter(raw[pos: pos + size], ph, stride, bpp)
        pos += size
        samples[y0::dy, x0::dx] = _unpack(rows, pw, channels, depth)
    return _to_rgba(samples, ct, depth, plte, trns)


def _to_8bit(samples: np.ndarray, ct: int, depth: int) -> np.ndarray:
    """Samples at their bit depth to PIL's 8-bit values (grey's scale or
    clip, the other types' high byte)."""
    if depth == 16:
        if ct == 0:  # "I;16" to RGBA clips
            return np.minimum(samples, 255).astype(np.uint8)
        return (samples >> 8).astype(np.uint8)
    if depth < 8 and ct == 0:
        return samples * np.uint8(255 // ((1 << depth) - 1))
    return samples.astype(np.uint8)


def _to_rgba(samples, ct, depth, plte, trns) -> np.ndarray:
    h, w = samples.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    if ct == 3:
        n = len(plte) // 3
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        table[:n, :3] = np.frombuffer(plte[: n * 3], np.uint8).reshape(n, 3)
        if trns is not None:
            alpha = np.frombuffer(trns[:256], np.uint8)
            table[: len(alpha), 3] = alpha
        return table[samples[..., 0]]
    v = _to_8bit(samples, ct, depth)
    if ct in (0, 4):
        out[..., :3] = v[..., :1]
    else:
        out[..., :3] = v[..., :3]
    out[..., 3] = v[..., -1] if ct in (4, 6) else 255
    if trns is not None and ct in (0, 2):
        key = np.array(struct.unpack(f">{len(trns) // 2}H", trns[: len(trns) // 2 * 2]),
                       np.uint16)
        if len(key) == _CHANNELS[ct]:
            # PIL keeps the key's low byte (a 1-bit key scales to 0 or 255)
            key8 = (key * 255 if depth == 1 else key & 0xFF).astype(np.uint8)
            hit = (v[..., : _CHANNELS[ct]] == key8).all(axis=-1)
            out[hit, 3] = 0
    return out


def read_image(path: str) -> np.ndarray:
    """An image file as (H, W, 4) uint8 RGBA: utils.imagefile.read_image
    (PNG, JPEG, GIF, BMP, ICO and QOI), kept under this name."""
    from .imagefile import read_image as read_any

    return read_any(path)
