"""The port's GIF decoder: the first frame of a GIF87a or GIF89a file to
(H, W, 4) uint8 RGBA, as PIL 12.1.0's `Image.open(path).convert("RGBA")`
returns it (GifImagePlugin's first frame, "P" or "L", then its RGBA
conversion). The LZW decoding runs in C++ (csrc/image_decode.cpp,
fd_gif_lzw); `lzw_plain` is its Python twin, the tests' reference.

PIL's first frame, matched here:
- the canvas is the logical screen, grown to hold the frame if the frame
  reaches past it;
- its colours are the frame's local colour table, else the global one; a
  table that is the grey ramp (entry i = (i, i, i)) is dropped and the
  frame reads as "L" (an index is its grey); an index past a palette's
  end reads as black;
- the canvas outside the frame holds the graphic control extension's
  transparent index, or index 0 without one;
- with a transparent index t, every pixel of index t gets alpha 0 (and
  its palette colour); the others are opaque;
- an interlaced frame's rows come in the four passes (every 8th row from
  0, every 8th from 4, every 4th from 2, every 2nd from 1).
"""

from __future__ import annotations

import struct

import numpy as np

from . import image_lib


def lzw(data: bytes, min_size: int, n: int) -> np.ndarray:
    """The first n indices of an LZW stream (sub-blocks joined), in C++;
    indices the stream does not reach stay 0."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(n, np.uint8)
    got = image_lib.load().fd_gif_lzw(src.ctypes.data, len(data), min_size, out.ctypes.data, n)
    if got < 0:
        raise ValueError("corrupt GIF image data: an LZW code past the table")
    return out


def lzw_plain(data: bytes, min_size: int, n: int) -> np.ndarray:
    """lzw in Python, with the table as byte strings."""
    if not 1 <= min_size <= 11:
        raise ValueError("corrupt GIF image data")
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    first = [bytes([i]) for i in range(clear)] + [b"", b""]
    out, table, size, prev = bytearray(), list(first), min_size + 1, None
    acc = nbits = pos = 0
    while len(out) < n:
        while nbits < size and pos < len(data):
            acc |= data[pos] << nbits
            nbits += 8
            pos += 1
        if nbits < size:
            break
        code = acc & ((1 << size) - 1)
        acc >>= size
        nbits -= size
        if code == clear:
            table, size, prev = list(first), min_size + 1, None
            continue
        if code == eoi:
            break
        if prev is None:
            if code >= clear:
                raise ValueError("corrupt GIF image data: an LZW code past the table")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = table[prev] + table[prev][:1]
            else:
                raise ValueError("corrupt GIF image data: an LZW code past the table")
            if len(table) < 4096:
                table.append(table[prev] + entry[:1])
                if len(table) == (1 << size) and size < 12:
                    size += 1
        out += entry
        prev = code
    res = np.zeros(n, np.uint8)
    res[: min(n, len(out))] = np.frombuffer(bytes(out[:n]), np.uint8)
    return res


def _sub_blocks(data: bytes, pos: int):
    """The joined sub-blocks from pos, and the position after their
    terminator."""
    parts = []
    while True:
        if pos >= len(data):
            raise ValueError("truncated GIF file")
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(parts), pos
        parts.append(data[pos: pos + n])
        pos += n


def _ramp(table: bytes) -> bool:
    return all(table[i] == table[i + 1] == table[i + 2] == i // 3
               for i in range(0, len(table), 3))


def _deinterlace(pix: np.ndarray) -> np.ndarray:
    order = np.concatenate([np.arange(0, pix.shape[0], 8), np.arange(4, pix.shape[0], 8),
                            np.arange(2, pix.shape[0], 4), np.arange(1, pix.shape[0], 2)])
    out = np.empty_like(pix)
    out[order] = pix
    return out


def read_first_frame(data: bytes) -> dict:
    """The logical screen, the first image descriptor, its colour table
    (None for the grey ramp or none), the transparent index before it,
    and its LZW stream with the initial code size."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError("not a GIF file")
    sw, sh, flags = struct.unpack_from("<HHB", data, 6)
    pos = 13
    global_table = None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        global_table = data[pos: pos + n]
        pos += n
        if _ramp(global_table):
            global_table = None
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("GIF file without an image")
        kind = data[pos]
        if kind == 0x21:
            label = data[pos + 1]
            block, pos = _sub_blocks(data, pos + 2)
            if label == 0xF9 and len(block) >= 4:
                transparency = block[3] if block[0] & 1 else None
            continue
        if kind != 0x2C:
            pos += 1  # PIL skips a stray byte between blocks
            continue
        x0, y0, fw, fh, fflags = struct.unpack_from("<HHHHB", data, pos + 1)
        pos += 10
        table = global_table
        if fflags & 0x80:
            n = 3 << ((fflags & 7) + 1)
            local = data[pos: pos + n]
            pos += n
            table = None if _ramp(local) else local
        stream = _sub_blocks(data, pos + 1)[0]
        return dict(screen=(sw, sh), box=(x0, y0, fw, fh), interlaced=bool(fflags & 0x40),
                    table=table, transparency=transparency, min_size=data[pos],
                    stream=stream)


def decode_gif(data: bytes, plain: bool = False) -> np.ndarray:
    """A GIF byte string's first frame to (H, W, 4) uint8 RGBA, as PIL's
    `Image.open(...).convert("RGBA")`. plain=True decodes the LZW stream
    with lzw_plain."""
    f = read_first_frame(data)
    (sw, sh), (x0, y0, fw, fh) = f["screen"], f["box"]
    table, transparency = f["table"], f["transparency"]
    w, h = max(sw, x0 + fw), max(sh, y0 + fh)
    pix = (lzw_plain if plain else lzw)(f["stream"], f["min_size"], fw * fh).reshape(fh, fw)
    if f["interlaced"]:
        pix = _deinterlace(pix)
    canvas = np.full((h, w), transparency or 0, np.uint8)
    canvas[y0: y0 + fh, x0: x0 + fw] = pix
    if table is None:
        palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    else:
        palette = np.zeros((256, 3), np.uint8)
        k = min(len(table) // 3, 256)
        palette[:k] = np.frombuffer(table[: 3 * k], np.uint8).reshape(k, 3)
    out = np.empty((h, w, 4), np.uint8)
    out[..., :3] = palette[canvas]
    out[..., 3] = 255
    if transparency is not None:
        out[canvas == transparency, 3] = 0
    return out
