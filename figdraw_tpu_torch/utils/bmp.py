"""The port's BMP decoder: a BMP (or an ICO's DIB) to (H, W, 4) uint8
RGBA, as PIL 12.1.0's `Image.open(path).convert("RGBA")` returns it
(BmpImagePlugin), in numpy and struct.

Headers: BITMAPCOREHEADER (OS/2 1.x, 12 bytes: u16 sizes, 3-byte palette
entries), BITMAPINFOHEADER (40) and the V2 (52), V3 (56), OS/2 2.x (64),
V4 (108) and V5 (124) headers. Pixel formats: 1, 4 and 8 bits with a
palette, 16 (5-5-5 without BI_BITFIELDS), 24 and 32 bits; BI_RGB,
BI_BITFIELDS, RLE8 and RLE4; bottom-up, and top-down (a negative height).

PIL's choices, matched here (found against PIL 12.1.0):
- 32 bits BI_RGB is "BGRX": the fourth byte is dropped and alpha is 255
  (an ICO's 32-bit DIB gets its alpha from the ICO reader, utils.ico);
- BI_BITFIELDS reads only PIL's layouts: 32 bits with masks (R, G, B, A)
  of BGRX, XBGR, BGXR (opaque) or ABGR, RGBA, BGRA, BGAR and all-zero
  (alpha from the masked byte), 24 bits BGR, 16 bits 5-6-5 and 5-5-5;
  the masks follow a 40-byte header, or sit in a longer one (A from 56
  bytes on); another layout, ALPHABITFIELDS (compression 6) and the JPEG
  and PNG compressions raise ValueError, as PIL cannot read them;
- a 5-bit field scales as v * 255 // 31, a 6-bit one as v * 255 // 63;
- a palette whose first `colors` entries are the grey ramp (i, i, i) (or
  black and white for two colours) is dropped: the data reads as "1" or
  as 8-bit "L", so a 1- or 4-bit file with a grey-ramp palette reads one
  byte a pixel (PIL's raw decoder; a row wider than its stride fails
  there and raises here);
- a palette index past the palette reads as opaque black;
- `colors` 0 means 1 << bits; when the data offset is 14 + the header
  size, the palette's bytes are added to it;
- RLE as PIL's BmpRleDecoder: runs clipped at the row's end, end of line
  zero-fills the row, a delta skips two bytes and adds right + up * width
  zero pixels from the two after them, RLE4 absolute runs take n // 2
  bytes (2 pixels each), absolute runs realign to an even file offset;
  data that ends before the image does raises (PIL: not enough image
  data).
"""

from __future__ import annotations

import struct

import numpy as np

RAW, RLE8, RLE4, BITFIELDS = 0, 1, 2, 3

# (bits, masks) -> PIL's raw mode of a BI_BITFIELDS file
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_RAW_MODES = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}


class Bitmap:
    """A parsed bitmap header: size, bits, raw mode, palette (None when
    PIL drops it), data offset and row order."""


def read_header(data: bytes, pos: int, offset: int = 0) -> Bitmap:
    """The header at `pos` (BmpImagePlugin._bitmap); `offset` is the BMP
    file header's data offset, 0 for a DIB (the data follows the header
    and palette)."""
    if pos + 4 > len(data):
        raise ValueError("truncated BMP file")
    (size,) = struct.unpack_from("<I", data, pos)
    hd = data[pos + 4: pos + size]
    if len(hd) != size - 4:
        raise ValueError("truncated BMP file")
    b = Bitmap()
    b.top_down = False
    cur = pos + size
    masks = None
    if size == 12:
        b.width, b.height, _planes, b.bits = struct.unpack_from("<HHHH", hd)
        compression, pad, colors = RAW, 3, 0
    elif size in (40, 52, 56, 64, 108, 124):
        b.top_down = hd[7] == 0xFF
        b.width, height, _planes, b.bits, compression = struct.unpack_from("<IIHHI", hd)
        b.height = 2**32 - height if b.top_down else height
        (colors,) = struct.unpack_from("<I", hd, 28)
        pad = 4
        if compression == BITFIELDS:
            if len(hd) >= 48:
                n = 4 if len(hd) >= 52 else 3
                masks = struct.unpack_from(f"<{n}I", hd, 36) + ((0,) if n == 3 else ())
            else:
                masks = struct.unpack_from("<3I", data, cur) + (0,)
                cur += 12
    else:
        raise ValueError(f"unsupported BMP header size {size}")
    colors = colors or (1 << b.bits)
    if offset == 14 + size and b.bits <= 8:
        offset += 4 * colors
    if b.bits not in _RAW_MODES:
        raise ValueError(f"unsupported BMP pixel depth ({b.bits})")
    b.mode, b.rle = _RAW_MODES[b.bits], None
    if compression == BITFIELDS:
        key = (b.bits, masks if b.bits == 32 else masks[:3])
        if key not in _MASK_MODES:
            raise ValueError("unsupported BMP bitfields layout (PIL cannot read it either)")
        b.mode = _MASK_MODES[key]
    elif compression in (RLE8, RLE4):
        b.rle = compression
    elif compression != RAW:
        raise ValueError(f"unsupported BMP compression ({compression}) (PIL cannot read "
                         "it either)")
    b.palette = None
    if b.bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"unsupported BMP palette size ({colors})")
        raw = data[cur: cur + pad * colors]
        cur += pad * colors
        ramp = (0, 255) if colors == 2 else range(colors)
        grey = all(raw[i * pad: i * pad + 3] == bytes([v]) * 3 for i, v in enumerate(ramp))
        if grey:
            b.mode = "1" if colors == 2 else "L"
        else:
            n = len(raw) // pad
            b.palette = np.frombuffer(raw[: n * pad], np.uint8).reshape(n, pad)[:256, 2::-1]
    b.offset = offset or cur
    b.stride = ((b.width * b.bits + 31) >> 3) & ~3
    return b


def _scale(v, bits):
    return (v.astype(np.uint32) * 255 // ((1 << bits) - 1)).astype(np.uint8)


def _paletted(idx: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Indices through a palette (black past its end) to opaque RGBA."""
    table = np.zeros((256, 3), np.uint8)
    table[: len(palette)] = palette
    out = np.full(idx.shape + (4,), 255, np.uint8)
    out[..., :3] = table[idx]
    return out


def _unpack_rows(rows: np.ndarray, b: Bitmap) -> np.ndarray:
    """(h, stride) raw rows, top row first, to (h, w, 4) RGBA."""
    h, w = rows.shape[0], b.width
    out = np.full((h, w, 4), 255, np.uint8)
    mode = b.mode
    if mode in ("P;1", "P;4", "P", "1"):
        bits = {"P;1": 1, "1": 1, "P;4": 4, "P": 8}[mode]
        if bits == 8:
            idx = rows[:, :w]
        else:
            shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
            idx = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(h, -1)[:, :w]
        if mode == "1":
            out[..., :3] = (idx * 255)[..., None]
            return out
        return _paletted(idx, b.palette)
    if mode == "L":
        out[..., :3] = rows[:, :w, None]
        return out
    if mode in ("BGR;15", "BGR;16"):
        v = rows[:, : 2 * w].reshape(h, w, 2).astype(np.uint16)
        v = v[..., 0] | (v[..., 1] << 8)
        if mode == "BGR;15":
            r, g, bl = (v >> 10) & 31, (v >> 5) & 31, v & 31
            out[..., 0], out[..., 1], out[..., 2] = _scale(r, 5), _scale(g, 5), _scale(bl, 5)
        else:
            r, g, bl = (v >> 11) & 31, (v >> 5) & 63, v & 31
            out[..., 0], out[..., 1], out[..., 2] = _scale(r, 5), _scale(g, 6), _scale(bl, 5)
        return out
    n = 3 if mode == "BGR" else 4
    px = rows[:, : n * w].reshape(h, w, n)
    for ch, letter in enumerate("RGBA"):
        if letter in mode:
            out[..., ch] = px[..., mode.index(letter)]
    return out


def _rle(data: bytes, b: Bitmap) -> np.ndarray:
    """PIL's BmpRleDecoder: the index bytes in file row order."""
    w, total = b.width, b.width * b.height
    out, x, pos = bytearray(), 0, b.offset
    rle4 = b.rle == RLE4
    while len(out) < total:
        if pos + 2 > len(data):
            break
        n, byte = data[pos], data[pos + 1]
        pos += 2
        if n:
            n = min(n, max(0, w - x))
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * ((n + 1) // 2))[:n]
            else:
                out += bytes([byte]) * n
            x += n
        elif byte == 0:
            out += b"\x00" * ((-len(out)) % w)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            # PIL reads two bytes and then takes right and up from the two
            # after them
            if pos + 4 > len(data):
                raise ValueError("truncated BMP RLE delta")
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += b"\x00" * (right + up * w)
            x = len(out) % w
        else:
            count = byte // 2 if rle4 else byte
            chunk = data[pos: pos + count]
            pos += len(chunk)
            if rle4:
                out += bytes(v for c in chunk for v in (c >> 4, c & 15))
            else:
                out += chunk
            if len(chunk) < count:
                break
            x += byte
            if pos % 2:
                pos += 1
    return np.frombuffer(bytes(out), np.uint8)


def decode_bitmap(data: bytes, b: Bitmap, height: int = None) -> np.ndarray:
    """The pixels of a parsed header as (height, W, 4) RGBA (height: the
    rows to read, the header's by default)."""
    h, w = b.height if height is None else height, b.width
    if b.rle is not None:
        idx = _rle(data, b)
        if len(idx) < w * h:
            raise ValueError("BMP RLE data ends before the image does (PIL reads no "
                             "such file either: not enough image data)")
        rows = idx[: w * h].reshape(h, w)
        rows = rows if b.top_down else rows[::-1]
        if b.mode == "L":  # PIL's raw modes for RLE data: "L", else "P"
            out = np.full((h, w, 4), 255, np.uint8)
            out[..., :3] = rows[..., None]
            return out
        return _paletted(rows, b.palette if b.palette is not None else np.zeros((0, 3)))
    stride = b.stride
    if b.mode == "L" and b.bits < 8:
        if w > stride:
            raise ValueError("a BMP of a grey-ramp palette below 8 bits wider than its "
                             "row stride (PIL's raw decoder fails on it too)")
    need = stride * h
    raw = np.frombuffer(data, np.uint8, count=min(need, max(0, len(data) - b.offset)),
                        offset=min(b.offset, len(data)))
    if len(raw) < need:
        raise ValueError("truncated BMP file: the pixel data runs past the end")
    rows = raw.reshape(h, stride)
    return _unpack_rows(rows if b.top_down else rows[::-1], b)


def decode_bmp(data: bytes) -> np.ndarray:
    """A BMP byte string to (H, W, 4) uint8 RGBA, as PIL's
    `Image.open(...).convert("RGBA")`."""
    if data[:2] != b"BM" or len(data) < 14:
        raise ValueError("not a BMP file")
    (offset,) = struct.unpack_from("<I", data, 10)
    return decode_bitmap(data, read_header(data, 14, offset))
