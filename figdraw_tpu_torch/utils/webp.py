"""The port's WebP reader: a WebP file to (H, W, 4) uint8 RGBA, as PIL
12.1.0's `Image.open(path).convert("RGBA")` returns it (figdraw_tpu
decodes through PIL; the port may not import it). PIL reads every WebP,
still or animated, through libwebp 1.6.0's WebPAnimDecoder
(WebPImagePlugin.py:49) in MODE_RGBA, and takes its first frame; each step
is matched here.

The container: a simple lossy (`VP8 `) or lossless (`VP8L`) file, or an
extended one (`VP8X`: flags, the canvas size) holding an image (`ALPH`
then `VP8 `, or `VP8L`) or an animation (`ANIM`, then `ANMF` frames, each
at an offset on the canvas). `ICCP`, `EXIF`, `XMP ` and unknown chunks are
skipped: PIL applies neither the ICC profile nor the EXIF orientation to a
WebP. An odd chunk is padded to even. The first frame is decoded onto a
canvas of transparent black (0, 0, 0, 0), as WebPAnimDecoder does for a
key frame; the ANIM background colour and the frame's blend and dispose
bits do not touch frame 0. A file without alpha (a simple `VP8 `, a VP8L
whose header says no alpha, an animation or a lossy VP8X image whose flags
say none and that has no ALPH) opens in PIL as "RGB" (rawmode RGBX), so
its alpha reads 255 everywhere.

The stages, in C++ (csrc/webp_decode.cpp, built by utils/image_lib.py):
- fd_webp_vp8: a VP8 key frame (RFC 6386 as libwebp decodes it) to Y, U
  and V planes: the boolean decoder, the frame header (segments, the loop
  filter's type, level, sharpness and deltas, 1-8 token partitions, the
  quantisers, the probability updates), the intra modes, the tokens with
  their contexts, the inverse WHT and DCT (Transform_SSE2's 16-bit lanes,
  as PIL's x86-64 build runs it, and the C TransformAC3 and TransformDC),
  the predictions with libwebp's edge values (127 above, 129 left), and
  the simple and normal loop filters;
- fd_webp_upsample: libwebp's fancy upsampling of the 4:2:0 chroma
  (UpsampleRgbaLinePair) and its 14-bit fixed-point YUV -> RGB;
- fd_webp_vp8l: the lossless format (prefix codes simple and normal, the
  meta prefix codes, LZ77 with the 120 distance codes, the colour cache,
  and the predictor, cross-colour, subtract-green and colour-indexing
  transforms with pixel bundling) to ARGB;
- fd_webp_alpha_unfilter: the ALPH filters (none, horizontal, vertical,
  gradient).
`vp8_plain`, `upsample_plain`, `vp8l_plain` and `alpha_unfilter_plain` are
their Python twins, the tests' reference; nothing on the load path uses
them. The tables are libwebp's (utils/webp_tables.py, csrc/webp_tables.h).

Raises NotImplementedError for what is not ported (a VP8 inter frame, a
VP8L version other than 0, an ALPH compression other than none or
lossless) and ValueError for a malformed or truncated file.
"""

from __future__ import annotations

import struct

import numpy as np

from . import image_lib
from . import webp_tables as T

ALPHA_FLAG, ANIM_FLAG = 0x10, 0x02
VP8L_SIGNATURE = 0x2F

# the C++ entry points' error codes
ERRORS = {-1: "truncated data", -2: "a bad VP8 start code", -3: "bad VP8 partitions",
          -4: "a premature end of VP8 data", -5: "a bad VP8L stream", -6: "bad arguments"}


def _u24(b: bytes, i: int) -> int:
    return b[i] | (b[i + 1] << 8) | (b[i + 2] << 16)


# ------------------------------------------------------------- container ---

class Frame:
    """The first frame of a WebP file: where it lies on the canvas, its
    codec ("VP8" or "VP8L"), its bitstream and ALPH payload, and whether PIL
    opens the file with alpha."""

    def __init__(self, canvas, box, codec, stream, alph, has_alpha):
        self.canvas, self.box, self.codec = canvas, box, codec
        self.stream, self.alph, self.has_alpha = stream, alph, has_alpha


def _chunks(data: bytes, pos: int, end: int):
    """(fourcc, payload start, payload size) of the chunks in data[pos:end];
    a chunk whose padded payload runs past `end` raises."""
    while pos < end:
        if pos + 8 > end:
            raise ValueError("truncated WebP file: a chunk header past the end")
        tag = data[pos: pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        if pos + 8 + size + (size & 1) > end:
            raise ValueError(f"truncated WebP file: the {tag!r} chunk runs past the end")
        yield tag, pos + 8, size
        pos += 8 + size + (size & 1)


def _image(data: bytes, chunks: list, where: str):
    """An image's chunks (ALPH then VP8, or VP8L, as libwebp's demuxer's
    StoreFrame takes them): (codec, stream, header, alph). The stream runs
    on over the chunk's pad byte, as libwebp hands it to its decoders; the
    header is the chunk's payload alone."""
    alph = None
    for tag, start, size in chunks:
        if tag == b"ALPH" and alph is None:
            alph = data[start: start + size]
            continue
        if tag == b"VP8L" and alph is not None:
            raise ValueError(f"corrupt WebP file: an ALPH chunk before VP8L in {where}")
        if tag in (b"VP8 ", b"VP8L"):
            return (tag.strip().decode(), data[start: start + size + (size & 1)],
                    data[start: start + size], alph)
        break
    raise ValueError(f"corrupt WebP file: no VP8 or VP8L image in {where}")


def _anmf_frame(data: bytes, start: int, size: int, seen_anim: bool, canvas, first: bool):
    """(codec, stream, alph, box) of an ANMF frame, checked as libwebp's
    demuxer checks every frame of an animation before its first is drawn
    (ParseAnimationFrame, StoreFrame, IsValidExtendedFormat): the ANMF's
    own width and height only bounded in area (StoreFrame replaces them by
    the bitstream's), the bitstream's header read, the frame inside the
    canvas. A later frame's fault is a ValueError whatever it is."""
    try:
        if not seen_anim or size < 16:
            raise ValueError("corrupt WebP file: a bad ANMF chunk")
        x0, y0 = 2 * _u24(data, start), 2 * _u24(data, start + 3)
        if (_u24(data, start + 6) + 1) * (_u24(data, start + 9) + 1) >= 1 << 32:
            raise ValueError("corrupt WebP file: an ANMF frame of 2^32 pixels or more")
        sub = list(_chunks(data, start + 16, start + size))
        codec, stream, head, alph = _image(data, sub, "an ANMF frame")
        w, h, _a = bitstream_size(codec, head)
    except NotImplementedError as err:
        if first:
            raise
        raise ValueError(f"corrupt WebP file: a later ANMF frame: {err}") from None
    if x0 + w > canvas[0] or y0 + h > canvas[1]:
        raise ValueError("corrupt WebP file: an ANMF frame does not fit the canvas")
    return codec, stream, alph, (x0, y0, w, h)


def bitstream_size(codec: str, stream: bytes):
    """(width, height, has_alpha) from a VP8 or VP8L chunk's payload, as
    WebPGetFeatures reads it; raises as libwebp's VP8GetInfo and
    VP8LGetInfo refuse."""
    if codec == "VP8":
        if len(stream) < 10:
            raise ValueError("truncated VP8 frame header")
        bits = _u24(stream, 0)
        if bits & 1:
            raise NotImplementedError("a WebP VP8 inter frame is not decoded by "
                                      "figdraw_tpu_torch (WebP holds key frames only)")
        if ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1 or (bits >> 5) >= len(stream):
            raise ValueError("corrupt VP8 frame header")
        if stream[3:6] != b"\x9d\x01\x2a":
            raise ValueError("corrupt VP8 frame header: a bad start code")
        w = (stream[6] | (stream[7] << 8)) & 0x3FFF
        h = (stream[8] | (stream[9] << 8)) & 0x3FFF
        if not w or not h:
            raise ValueError("corrupt VP8 frame header: an empty image")
        return w, h, False
    if len(stream) < 5 or stream[0] != VP8L_SIGNATURE:
        raise ValueError("corrupt VP8L header")
    bits = struct.unpack_from("<I", stream, 1)[0]
    if bits >> 29:
        raise NotImplementedError(f"VP8L version {bits >> 29} is not decoded by "
                                  "figdraw_tpu_torch (only version 0 exists)")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool((bits >> 28) & 1)


def read_frame(data: bytes) -> Frame:
    """The container's first frame (ValueError for a malformed one)."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file")
    riff = struct.unpack_from("<I", data, 4)[0]
    if riff < 12:
        raise ValueError("corrupt WebP file: a RIFF size under 12")
    end = riff + 8
    if end > len(data):
        raise ValueError("truncated WebP file: shorter than its RIFF size")
    chunks = list(_chunks(data, 12, end))
    if not chunks:
        raise ValueError("corrupt WebP file: no chunk")
    tag0, s0, n0 = chunks[0]
    if tag0 != b"VP8X":
        codec, stream, head, _alph = _image(data, chunks[:1], "the file")
        w, h, has_alpha = bitstream_size(codec, head)
        return Frame((w, h), (0, 0, w, h), codec, stream, None, has_alpha)
    if n0 < 10:
        raise ValueError("corrupt WebP file: a short VP8X chunk")
    flags = data[s0]
    cw, ch = _u24(data, s0 + 4) + 1, _u24(data, s0 + 7) + 1
    rest = chunks[1:]
    if flags & ANIM_FLAG:
        if not any(t == b"ANIM" for t, _s, _n in rest):
            raise ValueError("corrupt WebP file: an animation without an ANIM chunk")
        seen_anim, first = False, None
        for tag, start, size in rest:
            if tag == b"ANIM":
                seen_anim = True
            elif tag == b"ANMF":
                frame = _anmf_frame(data, start, size, seen_anim, (cw, ch), first is None)
                first = first or frame
            elif tag in (b"ALPH", b"VP8 ", b"VP8L", b"VP8X"):
                raise ValueError(f"corrupt WebP file: a {tag!r} chunk outside ANMF in an "
                                 "animation")
        if first is None:
            raise ValueError("corrupt WebP file: an animation without frames")
        codec, stream, alph, box = first
        return Frame((cw, ch), box, codec, stream, alph, bool(flags & ALPHA_FLAG))
    for i, (tag, _s, _n) in enumerate(rest):
        if tag in (b"ALPH", b"VP8 ", b"VP8L"):
            codec, stream, head, alph = _image(data, rest[i:], "the file")
            break
        if tag in (b"ANIM", b"ANMF", b"VP8X"):
            raise ValueError(f"corrupt WebP file: a {tag!r} chunk in a still image")
    else:
        raise ValueError("corrupt WebP file: no image")
    w, h, bit = bitstream_size(codec, head)
    if (w, h) != (cw, ch):
        raise ValueError("corrupt WebP file: the image size differs from the canvas")
    if codec == "VP8L":
        return Frame((cw, ch), (0, 0, w, h), codec, stream, None, bit)
    # the demuxer drops an ALPH chunk when the VP8X flags say no alpha
    alpha = bool(flags & ALPHA_FLAG)
    return Frame((cw, ch), (0, 0, w, h), codec, stream, alph if alpha else None, alpha)


def decode_webp(data: bytes, plain: bool = False) -> np.ndarray:
    """A WebP file's first frame on its canvas as (H, W, 4) uint8 RGBA;
    plain=True runs the stages' Python twins."""
    f = read_frame(data)
    x0, y0, w, h = f.box
    if f.codec == "VP8L":
        argb = (vp8l_plain if plain else vp8l)(f.stream[5:], w, h)
        rgba = argb_to_rgba(argb)
    else:
        planes = (vp8_plain if plain else vp8)(f.stream)
        rgba = (upsample_plain if plain else upsample)(*planes)
        if f.alph is not None:
            rgba[..., 3] = decode_alpha(f.alph, w, h, plain)
    if (x0, y0, w, h) == (0, 0, *f.canvas):
        out = rgba
    else:
        out = np.zeros((f.canvas[1], f.canvas[0], 4), np.uint8)
        out[y0: y0 + h, x0: x0 + w] = rgba
    if not f.has_alpha:
        out[..., 3] = 255
    return out


def argb_to_rgba(argb: np.ndarray) -> np.ndarray:
    """(H, W) uint32 ARGB to (H, W, 4) uint8 RGBA."""
    b = argb.astype("<u4").view(np.uint8).reshape(*argb.shape, 4)
    return np.ascontiguousarray(b[..., [2, 1, 0, 3]])


def alpha_header(alph: bytes):
    """(compression, filter) of an ALPH chunk; raises as libwebp refuses."""
    if not alph:
        raise ValueError("corrupt WebP file: an empty ALPH chunk")
    method, filt, pre, rsrv = alph[0] & 3, (alph[0] >> 2) & 3, (alph[0] >> 4) & 3, alph[0] >> 6
    if method > 1:
        raise NotImplementedError(f"WebP ALPH compression {method} is not decoded by "
                                  "figdraw_tpu_torch (only 0, none, and 1, lossless, exist)")
    if pre > 1 or rsrv:
        raise ValueError("corrupt WebP file: a bad ALPH header")
    return method, filt


def alpha_deltas(alph: bytes, w: int, h: int, plain: bool = False) -> np.ndarray:
    """An ALPH chunk's filtered (H, W) uint8 values: raw, or the green of
    a VP8L stream without its header."""
    method, _filt = alpha_header(alph)
    if method == 0:
        if len(alph) - 1 < w * h:
            raise ValueError("truncated WebP ALPH data")
        return np.frombuffer(alph, np.uint8, w * h, 1).reshape(h, w).copy()
    argb = (vp8l_plain if plain else vp8l)(alph[1:], w, h, alpha=True)
    return ((argb >> 8) & 0xFF).astype(np.uint8)


def decode_alpha(alph: bytes, w: int, h: int, plain: bool = False) -> np.ndarray:
    """An ALPH chunk to its (H, W) uint8 alpha plane."""
    _method, filt = alpha_header(alph)
    deltas = alpha_deltas(alph, w, h, plain)
    return (alpha_unfilter_plain if plain else alpha_unfilter)(deltas, filt)


# ------------------------------------------------------- the C++ stages ---

def _check(code: int, what: str) -> None:
    if code < 0:
        raise ValueError(f"corrupt {what} stream: {ERRORS.get(code, code)}")


def vp8(stream: bytes):
    """A VP8 key frame to its (Y, U, V) uint8 planes (H x W and
    ceil(H/2) x ceil(W/2)), in C++."""
    w, h, _a = bitstream_size("VP8", stream)
    src = np.frombuffer(stream, np.uint8)
    y = np.empty((h, w), np.uint8)
    u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
    v = np.empty_like(u)
    _check(image_lib.load_webp().fd_webp_vp8(src.ctypes.data, len(stream), w, h, y.ctypes.data,
                                             u.ctypes.data, v.ctypes.data), "VP8")
    return y, u, v


def upsample(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Y, U, V planes to (H, W, 4) uint8 RGBA (alpha 255), in C++."""
    h, w = y.shape
    y, u, v = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
    if u.shape != ((h + 1) // 2, (w + 1) // 2) or v.shape != u.shape:
        raise ValueError("chroma planes of the wrong size")
    out = np.empty((h, w, 4), np.uint8)
    _check(image_lib.load_webp().fd_webp_upsample(y.ctypes.data, u.ctypes.data, v.ctypes.data,
                                                  w, h, out.ctypes.data), "YUV")
    return out


def vp8l(stream: bytes, w: int, h: int, alpha: bool = False) -> np.ndarray:
    """A VP8L image stream (after its 5-byte header, or an ALPH chunk's
    headerless one, alpha=True) of w x h pixels to (H, W) uint32 ARGB, in
    C++."""
    src = np.frombuffer(stream, np.uint8)
    out = np.empty((h, w), np.uint32)
    _check(image_lib.load_webp().fd_webp_vp8l(src.ctypes.data, len(stream), w, h, int(alpha),
                                              out.ctypes.data), "VP8L")
    return out


def alpha_unfilter(deltas: np.ndarray, filt: int) -> np.ndarray:
    """ALPH's unfiltering of (H, W) uint8 deltas by filter 0-3, in C++."""
    deltas = np.ascontiguousarray(deltas, np.uint8)
    h, w = deltas.shape
    out = np.empty_like(deltas)
    _check(image_lib.load_webp().fd_webp_alpha_unfilter(deltas.ctypes.data, w, h, filt,
                                                        out.ctypes.data), "ALPH")
    return out


# ---------------------------------------------------- the plain twins ---

def alpha_unfilter_plain(deltas: np.ndarray, filt: int) -> np.ndarray:
    """alpha_unfilter in Python (libwebp's filters.c unfilters: a row's
    first pixel predicted from the one above, the first row from the
    left, the first pixel of all from 0)."""
    d = deltas.astype(np.int64)
    h, w = d.shape
    out = np.zeros((h, w), np.int64)
    for y in range(h):
        prev = out[y - 1] if y else None
        if filt == 0:
            out[y] = d[y]
        elif filt == 1 or prev is None:
            pred = 0 if prev is None else int(prev[0])
            out[y] = (pred + np.cumsum(d[y])) & 0xFF
        elif filt == 2:
            out[y] = (prev + d[y]) & 0xFF
        else:
            left = top_left = int(prev[0])
            for x in range(w):
                top = int(prev[x])
                g = min(max(left + top - top_left, 0), 255)
                left = (int(d[y, x]) + g) & 0xFF
                top_left = top
                out[y, x] = left
    return out.astype(np.uint8)


def _yuv_to_rgb(y, u, v):
    """libwebp's VP8YuvToRgb (src/dsp/yuv.h, YUV_FIX2 = 6) on int arrays."""
    def mult_hi(a, c):
        return (a * c) >> 8

    def clip8(x):
        return np.where((x & ~16383) == 0, x >> 6, np.where(x < 0, 0, 255))

    yy = mult_hi(y, 19077)
    r = clip8(yy + mult_hi(v, 26149) - 14234)
    g = clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708)
    b = clip8(yy + mult_hi(u, 33050) - 17685)
    return r, g, b


def _upsample_row(top, cur, w):
    """One output row's chroma from the chroma rows `top` (nearer, weight
    3) and `cur`, libwebp's UpsampleRgbaLinePair per channel."""
    tl, t = top[:-1], top[1:]
    l, c = cur[:-1], cur[1:]
    out = np.empty(w, np.int64)
    out[0] = (3 * top[0] + cur[0] + 2) >> 2
    n = (w - 1) >> 1  # pixel pairs
    diag_12 = (tl + 3 * t + 3 * l + c + 8) >> 3
    diag_03 = (3 * tl + t + l + 3 * c + 8) >> 3
    out[1: 2 * n: 2] = (diag_12[:n] + tl[:n]) >> 1
    out[2: 2 * n + 1: 2] = (diag_03[:n] + t[:n]) >> 1
    if not w & 1:
        out[w - 1] = (3 * top[n] + cur[n] + 2) >> 2
    return out


def upsample_plain(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """upsample in numpy: row 0 from chroma row 0, rows 2k-1 and 2k from
    chroma rows k-1 and k (3:1 toward the nearer), an even height's last
    row from the last chroma row."""
    h, w = y.shape
    u, v = u.astype(np.int64), v.astype(np.int64)
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    for row in range(h):
        k = (row + 1) // 2
        if row == 0 or (row == h - 1 and not h & 1):
            near = far = k if row == 0 else k - 1
        elif row & 1:  # the top row of a pair leans on chroma row k - 1
            near, far = k - 1, k
        else:
            near, far = k, k - 1
        cu = _upsample_row(u[near], u[far], w)
        cv = _upsample_row(v[near], v[far], w)
        r, g, b = _yuv_to_rgb(y[row].astype(np.int64), cu, cv)
        out[row, :, 0], out[row, :, 1], out[row, :, 2] = r, g, b
    return out


_M64 = (1 << 64) - 1


class _BoolReader:
    """libwebp's VP8BitReader on a 64-bit host: range kept less one, an
    8-bit window at `bits` of a 64-bit value, seven bytes a load while
    eight are left, then one at a time, then one byte of zeros past the end
    (`eof`); the window is cut to 32 bits as libwebp cuts it, which only a
    corrupt stream reaches."""

    def __init__(self, data: bytes, start: int, end: int):
        self.buf, self.pos, self.end = data, start, end
        self.max = end - 7 if end - start >= 8 else start
        self.value, self.range, self.bits, self.eof = 0, 254, -8, False

    def _load(self):
        if self.pos < self.max:
            self.value = ((self.value << 56) | int.from_bytes(
                self.buf[self.pos: self.pos + 7], "big")) & _M64
            self.pos += 7
            self.bits += 56
        elif self.pos < self.end:
            self.bits += 8
            self.value = ((self.value << 8) | self.buf[self.pos]) & _M64
            self.pos += 1
        elif not self.eof:
            self.value = (self.value << 8) & _M64
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        rng, pos = self.range, self.bits
        split = (rng * prob) >> 8
        if ((self.value >> pos) & 0xFFFFFFFF) > split:
            rng -= split
            self.value = (self.value - ((split + 1) << pos)) & _M64
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = 7 ^ (rng.bit_length() - 1)
        self.bits -= shift
        self.range = (rng << shift) - 1
        return bit

    def signed_bit(self, v: int) -> int:
        """VP8GetSigned: v negated on a bit of probability 1/2."""
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = self.range >> 1
        win = (self.value >> pos) & 0xFFFFFFFF
        neg = ((split - win) & 0xFFFFFFFF) >= 0x80000000
        self.bits -= 1
        if neg:
            self.range = (self.range - 1) | 1
            self.value = (self.value - ((split + 1) << pos)) & _M64
            return -v
        self.range |= 1
        return v

    def value_of(self, n: int) -> int:
        v = 0
        while n > 0:
            n -= 1
            v |= self.bit(0x80) << n
        return v

    def signed(self, n: int) -> int:
        v = self.value_of(n)
        return -v if self.bit(0x80) else v


def vp8_header(stream: bytes) -> dict:
    """A VP8 key frame's header fields (the frame tag, then the first
    partition up to the token probabilities): sizes, colour space and
    clamping, the segment header, the filter header, the token partitions,
    the quantiser indices."""
    return _Vp8(stream).header


def _clip(v: int, m: int) -> int:
    return 0 if v < 0 else m if v > m else v


class _Vp8:
    """The plain VP8 key-frame decoder (libwebp's vp8_dec.c, tree_dec.c,
    quant_dec.c, frame_dec.c and dsp/dec.c in Python)."""

    def __init__(self, s: bytes):
        w, h, _a = bitstream_size("VP8", s)
        bits = _u24(s, 0)
        part0 = bits >> 5
        if 10 + part0 > len(s):
            raise ValueError("corrupt VP8 stream: " + ERRORS[-3])
        self.w, self.h = w, h
        self.mbw, self.mbh = (w + 15) >> 4, (h + 15) >> 4
        br = self.br = _BoolReader(s, 10, 10 + part0)
        hd = self.header = {"width": w, "height": h, "colorspace": br.bit(0x80),
                            "clamp": br.bit(0x80)}
        # segment header
        seg_q, seg_f, self.seg_p = [0] * 4, [0] * 4, [255, 255, 255]
        use_segment, update_map, absolute = br.bit(0x80), 0, 1
        if use_segment:
            update_map = br.bit(0x80)
            if br.bit(0x80):
                absolute = br.bit(0x80)
                seg_q = [br.signed(7) if br.bit(0x80) else 0 for _ in range(4)]
                seg_f = [br.signed(6) if br.bit(0x80) else 0 for _ in range(4)]
            if update_map:
                self.seg_p = [br.value_of(8) if br.bit(0x80) else 255 for _ in range(3)]
        hd.update(segments=use_segment, update_map=update_map, absolute=absolute,
                  segment_quant=seg_q, segment_filter=seg_f)
        # filter header
        simple, level, sharp = br.bit(0x80), br.value_of(6), br.value_of(3)
        ref_d, mode_d = [0] * 4, [0] * 4
        use_lf_delta = br.bit(0x80)
        if use_lf_delta and br.bit(0x80):
            for i in range(4):
                if br.bit(0x80):
                    ref_d[i] = br.signed(6)
            for i in range(4):
                if br.bit(0x80):
                    mode_d[i] = br.signed(6)
        self.filter_type = 0 if level == 0 else 1 if simple else 2
        hd.update(simple=simple, level=level, sharpness=sharp, use_lf_delta=use_lf_delta,
                  ref_lf_delta=ref_d, mode_lf_delta=mode_d, filter_type=self.filter_type)
        if br.eof:
            raise ValueError("corrupt VP8 stream: a truncated header")
        # token partitions
        nparts = 1 << br.value_of(2)
        pos, end = 10 + part0, len(s)
        if end - pos < 3 * (nparts - 1):
            raise ValueError("corrupt VP8 stream: " + ERRORS[-3])
        start = pos + 3 * (nparts - 1)
        self.parts = []
        for p in range(nparts - 1):
            size = min(_u24(s, pos + 3 * p), end - start)
            self.parts.append(_BoolReader(s, start, start + size))
            start += size
        self.parts.append(_BoolReader(s, start, end))
        if start >= end:
            raise ValueError("corrupt VP8 stream: " + ERRORS[-3])
        hd["partitions"] = nparts
        # quantisers
        q0 = br.value_of(7)
        dq = [br.signed(4) if br.bit(0x80) else 0 for _ in range(5)]
        y1dc, y2dc, y2ac, uvdc, uvac = dq
        hd.update(base_q=q0, quant_deltas=dq)
        self.dqm = []
        for i in range(4):
            if use_segment:
                q = seg_q[i] + (0 if absolute else q0)
            else:
                q = q0
            y2a = (int(T.AC_TABLE[_clip(q + y2ac, 127)]) * 101581) >> 16
            self.dqm.append((
                (int(T.DC_TABLE[_clip(q + y1dc, 127)]), int(T.AC_TABLE[_clip(q, 127)])),
                (int(T.DC_TABLE[_clip(q + y2dc, 127)]) * 2, max(y2a, 8)),
                (int(T.DC_TABLE[_clip(q + uvdc, 117)]), int(T.AC_TABLE[_clip(q + uvac, 127)]))))
        br.bit(0x80)  # refresh_entropy_probs, ignored
        proba = np.array(T.COEFFS_PROBA0, np.int64)
        for t in range(4):
            for b in range(8):
                for c in range(3):
                    for p in range(11):
                        if br.bit(int(T.COEFFS_UPDATE_PROBA[t, b, c, p])):
                            proba[t, b, c, p] = br.value_of(8)
        # by token position: [type][n] -> the band's [ctx][node]
        self.proba = [[proba[t, int(T.BANDS[n])].tolist() for n in range(17)]
                      for t in range(4)]
        self.skip_p = br.value_of(8) if br.bit(0x80) else None
        hd["skip_proba"] = self.skip_p
        # the loop filter's strengths by segment and i4x4
        self.fstrength = [[None, None] for _ in range(4)]
        for sg in range(4):
            base = (seg_f[sg] + (0 if absolute else level)) if use_segment else level
            for i4 in range(2):
                lv = base
                if use_lf_delta:
                    lv += ref_d[0] + (mode_d[0] if i4 else 0)
                lv = _clip(lv, 63)
                if lv > 0:
                    il = lv
                    if sharp > 0:
                        il >>= 2 if sharp > 4 else 1
                        il = min(il, 9 - sharp)
                    il = max(il, 1)
                    self.fstrength[sg][i4] = (2 * lv + il, il, 2 if lv >= 40 else 1 if lv >= 15
                                              else 0)
                else:
                    self.fstrength[sg][i4] = (0, 0, 0)

    # -- tokens --
    def _large(self, br, p):
        if not br.bit(p[3]):
            return 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
        if not br.bit(p[6]):
            if not br.bit(p[7]):
                return 5 + br.bit(159)
            v = 7 + 2 * br.bit(165)
            return v + br.bit(145)
        bit1 = br.bit(p[8])
        bit0 = br.bit(p[9 + bit1])
        cat = 2 * bit1 + bit0
        v = 0
        for pr in (T.CAT3, T.CAT4, T.CAT5, T.CAT6)[cat][:-1]:
            v += v + br.bit(int(pr))
        return v + 3 + (8 << cat)

    def _coeffs(self, br, prob, ctx, dq, n, out):
        """libwebp's GetCoeffs: tokens from position n into out (raster,
        int16 wrap); returns the position after the last non-zero one."""
        p = prob[n][ctx]
        while n < 16:
            if not br.bit(p[0]):
                return n
            while not br.bit(p[1]):
                n += 1
                if n == 16:
                    return 16
                p = prob[n][0]
            nxt = prob[n + 1]
            if not br.bit(p[2]):
                v, p = 1, nxt[1]
            else:
                v, p = self._large(br, p), nxt[2]
            x = (br.signed_bit(v) * dq[1 if n > 0 else 0]) & 0xFFFF
            out[int(T.ZIGZAG[n])] = x - 0x10000 if x & 0x8000 else x
            n += 1
        return 16

    def decode(self):
        """The frame's (Y, U, V) planes, cropped to its size."""
        mbw, mbh = self.mbw, self.mbh
        Y = np.zeros((mbh * 16, mbw * 16), np.int64)
        U = np.zeros((mbh * 8, mbw * 8), np.int64)
        V = np.zeros((mbh * 8, mbw * 8), np.int64)
        intra_t = [0] * (4 * mbw)
        nz_top = [[0, 0] for _ in range(mbw)]  # (nz bits, nz_dc)
        used = self.used = {"segments": set(), "i16": set(), "b_pred": set(), "uv": set(),
                            "skipped": 0, "i4x4": 0}
        finfo = np.zeros((mbh, mbw, 4), np.int64)  # limit, ilevel, hev, inner
        br = self.br
        for mby in range(mbh):
            intra_l = [0] * 4
            left = [0, 0]
            tbr = self.parts[mby & (len(self.parts) - 1)]
            for mbx in range(mbw):
                # -- the intra modes (first partition) --
                if self.header["update_map"]:
                    seg = (br.bit(self.seg_p[1]) if not br.bit(self.seg_p[0])
                           else br.bit(self.seg_p[2]) + 2)
                else:
                    seg = 0
                skip = br.bit(self.skip_p) if self.skip_p is not None else 0
                i4x4 = not br.bit(145)
                top = intra_t[4 * mbx: 4 * mbx + 4]
                if not i4x4:
                    ymode = ((1 if br.bit(128) else 3) if br.bit(156)
                             else (2 if br.bit(163) else 0))
                    imodes = [ymode]
                    top = [ymode] * 4
                    intra_l = [ymode] * 4
                else:
                    imodes = []
                    for yy in range(4):
                        ym = intra_l[yy]
                        for xx in range(4):
                            prob = T.BMODES_PROBA[top[xx], ym]
                            i = int(T.YMODES_INTRA4[br.bit(int(prob[0]))])
                            while i > 0:
                                i = int(T.YMODES_INTRA4[2 * i + br.bit(int(prob[i]))])
                            ym = -i
                            top[xx] = ym
                            imodes.append(ym)
                        intra_l[yy] = ym
                intra_t[4 * mbx: 4 * mbx + 4] = top
                uvmode = (0 if not br.bit(142) else 2 if not br.bit(114)
                          else 1 if br.bit(183) else 3)
                used["segments"].add(seg)
                used["b_pred" if i4x4 else "i16"].update(imodes)
                used["uv"].add(uvmode)
                used["skipped"] += skip
                used["i4x4"] += i4x4
                if br.eof:
                    raise ValueError("corrupt VP8 stream: " + ERRORS[-4])
                # -- the residuals (token partition) --
                coeffs = np.zeros(384, np.int64)
                mb = nz_top[mbx]
                nzy = nzuv = 0
                if not skip:
                    nzy, nzuv = self._residuals(tbr, mb, left, seg, i4x4, coeffs)
                    skip = not (nzy | nzuv)
                else:
                    left[0] = mb[0] = 0
                    if not i4x4:
                        left[1] = mb[1] = 0
                if tbr.eof:
                    raise ValueError("corrupt VP8 stream: " + ERRORS[-4])
                if self.filter_type:
                    lim, il, hev = self.fstrength[seg][1 if i4x4 else 0]
                    finfo[mby, mbx] = (lim, il, hev, 1 if (i4x4 or not skip) else 0)
                self._reconstruct(Y, U, V, mbx, mby, i4x4, imodes, uvmode, coeffs, nzy, nzuv)
        if self.filter_type:
            self._filter(Y, U, V, finfo)
        w, h = self.w, self.h
        cw, ch = (w + 1) // 2, (h + 1) // 2
        return (Y[:h, :w].astype(np.uint8), U[:ch, :cw].astype(np.uint8),
                V[:ch, :cw].astype(np.uint8))

    def _residuals(self, br, mb, left, seg, i4x4, coeffs):
        q_y1, q_y2, q_uv = self.dqm[seg]
        if not i4x4:
            dc = [0] * 16
            ctx = mb[1] + left[1]
            nz = self._coeffs(br, self.proba[1], ctx, q_y2, 0, dc)
            mb[1] = left[1] = 1 if nz > 0 else 0
            if nz > 1:
                _wht(dc, coeffs)
            else:
                dc0 = (dc[0] + 3) >> 3
                coeffs[0:256:16] = dc0
            first, ac = 1, self.proba[0]
        else:
            first, ac = 0, self.proba[3]
        tnz, lnz = mb[0] & 0x0F, left[0] & 0x0F
        nzy = 0
        blk = [0] * 16
        for y in range(4):
            l = lnz & 1
            nzc = 0
            for x in range(4):
                n = y * 4 + x
                blk[:] = coeffs[16 * n: 16 * n + 16].tolist()
                nz = self._coeffs(br, ac, l + (tnz & 1), q_y1, first, blk)
                coeffs[16 * n: 16 * n + 16] = blk
                l = 1 if nz > first else 0
                tnz = (tnz >> 1) | (l << 7)
                nzc = (nzc << 2) | (3 if nz > 3 else 2 if nz > 1 else int(blk[0] != 0))
            tnz >>= 4
            lnz = (lnz >> 1) | (l << 7)
            nzy = (nzy << 8) | nzc
        out_t, out_l = tnz, lnz >> 4
        nzuv = 0
        for ch in (0, 2):
            nzc = 0
            tnz, lnz = mb[0] >> (4 + ch), left[0] >> (4 + ch)
            for y in range(2):
                l = lnz & 1
                for x in range(2):
                    n = 16 + 2 * ch + y * 2 + x
                    blk[:] = [0] * 16
                    nz = self._coeffs(br, self.proba[2], l + (tnz & 1), q_uv, 0, blk)
                    coeffs[16 * n: 16 * n + 16] = blk
                    l = 1 if nz > 0 else 0
                    tnz = (tnz >> 1) | (l << 3)
                    nzc = (nzc << 2) | (3 if nz > 3 else 2 if nz > 1 else int(blk[0] != 0))
                tnz >>= 2
                lnz = (lnz >> 1) | (l << 5)
            nzuv |= nzc << (4 * ch)
            out_t |= (tnz << 4) << ch
            out_l |= (lnz & 0xF0) << ch
        mb[0], left[0] = out_t, out_l
        return nzy, nzuv

    def _reconstruct(self, Y, U, V, mbx, mby, i4x4, imodes, uvmode, coeffs, nzy, nzuv):
        # a work buffer as libwebp's: row 0 and column 0 hold the edges
        yb = np.zeros((17, 21), np.int64)
        y0, x0 = mby * 16, mbx * 16
        if mby > 0:
            yb[0, 1:17] = Y[y0 - 1, x0: x0 + 16]
            yb[0, 0] = Y[y0 - 1, x0 - 1] if mbx > 0 else 129
        else:
            yb[0, :] = 127
        yb[1:, 0] = Y[y0: y0 + 16, x0 - 1] if mbx > 0 else 129
        if i4x4:
            if mby > 0:
                yb[0, 17:21] = (Y[y0 - 1, x0 + 15] if mbx == self.mbw - 1
                                else Y[y0 - 1, x0 + 16: x0 + 20])
            for r in (4, 8, 12):
                yb[r, 17:21] = yb[0, 17:21]
            for n in range(16):
                r, c = 1 + 4 * (n >> 2), 1 + 4 * (n & 3)
                _pred4(yb, r, c, imodes[n])
                _transform(nzy >> (30 - 2 * n), coeffs[16 * n: 16 * n + 16], yb, r, c)
        else:
            _pred_big(yb, 16, _check_mode(mbx, mby, imodes[0]))
            for n in range(16):
                _transform(nzy >> (30 - 2 * n), coeffs[16 * n: 16 * n + 16], yb,
                           1 + 4 * (n >> 2), 1 + 4 * (n & 3))
        Y[y0: y0 + 16, x0: x0 + 16] = yb[1:17, 1:17]
        c0, cx = mby * 8, mbx * 8
        for plane, base, bits in ((U, 256, nzuv & 0xFF), (V, 320, (nzuv >> 8) & 0xFF)):
            cb = np.zeros((9, 9), np.int64)
            if mby > 0:
                cb[0, 1:] = plane[c0 - 1, cx: cx + 8]
                cb[0, 0] = plane[c0 - 1, cx - 1] if mbx > 0 else 129
            else:
                cb[0, :] = 127
            cb[1:, 0] = plane[c0: c0 + 8, cx - 1] if mbx > 0 else 129
            _pred_big(cb, 8, _check_mode(mbx, mby, uvmode))
            for n in range(4):
                # libwebp's DoUVTransform: all four blocks through the SSE2
                # transform when one has an AC coefficient, else the DCs
                _transform(3 if bits & 0xAA else 1, coeffs[base + 16 * n: base + 16 * n + 16],
                           cb, 1 + 4 * (n >> 1), 1 + 4 * (n & 1))
            plane[c0: c0 + 8, cx: cx + 8] = cb[1:, 1:]

    def _filter(self, Y, U, V, finfo):
        simple = self.filter_type == 1
        for mby in range(self.mbh):
            for mbx in range(self.mbw):
                limit, il, hev, inner = (int(v) for v in finfo[mby, mbx])
                if limit == 0:
                    continue
                y0, x0 = mby * 16, mbx * 16
                if simple:
                    if mbx > 0:
                        _simple_edge(Y, y0, x0, True, limit + 4)
                    if inner:
                        for k in (4, 8, 12):
                            _simple_edge(Y, y0, x0 + k, True, limit)
                    if mby > 0:
                        _simple_edge(Y, y0, x0, False, limit + 4)
                    if inner:
                        for k in (4, 8, 12):
                            _simple_edge(Y, y0 + k, x0, False, limit)
                    continue
                c0, cx = mby * 8, mbx * 8
                if mbx > 0:
                    _normal_edge(Y, y0, x0, True, 16, limit + 4, il, hev, True)
                    for P in (U, V):
                        _normal_edge(P, c0, cx, True, 8, limit + 4, il, hev, True)
                if inner:
                    for k in (4, 8, 12):
                        _normal_edge(Y, y0, x0 + k, True, 16, limit, il, hev, False)
                    for P in (U, V):
                        _normal_edge(P, c0, cx + 4, True, 8, limit, il, hev, False)
                if mby > 0:
                    _normal_edge(Y, y0, x0, False, 16, limit + 4, il, hev, True)
                    for P in (U, V):
                        _normal_edge(P, c0, cx, False, 8, limit + 4, il, hev, True)
                if inner:
                    for k in (4, 8, 12):
                        _normal_edge(Y, y0 + k, x0, False, 16, limit, il, hev, False)
                    for P in (U, V):
                        _normal_edge(P, c0 + 4, cx, False, 8, limit, il, hev, False)


def _wht(dc, out):
    """libwebp's TransformWHT: the Y2 block to the 16 Y blocks' DCs."""
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    for i in range(4):
        d = tmp[4 * i] + 3
        a0, a1 = d + tmp[4 * i + 3], tmp[4 * i + 1] + tmp[4 * i + 2]
        a2, a3 = tmp[4 * i + 1] - tmp[4 * i + 2], d - tmp[4 * i + 3]
        for k, v in enumerate(((a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3, (a3 - a2) >> 3)):
            x = v & 0xFFFF
            out[64 * i + 16 * k] = x - 0x10000 if x & 0x8000 else x


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _w16(v: int) -> int:
    v &= 0xFFFF
    return v - 0x10000 if v & 0x8000 else v


def _pass16(i0, i1, i2, i3, bias=0):
    """One pass of libwebp's Transform_SSE2 on a lane: 16-bit wrapping
    adds and _mm_mulhi_epi16 by 20091 and -30068 (35468 - 65536)."""
    a, b = _w16(_w16(i0 + bias) + i2), _w16(_w16(i0 + bias) - i2)
    c = _w16(_w16(i1 - i3) + _w16(((i1 * -30068) >> 16) - ((i3 * 20091) >> 16)))
    d = _w16(_w16(i1 + i3) + _w16(((i1 * 20091) >> 16) + ((i3 * -30068) >> 16)))
    return _w16(a + d), _w16(b + c), _w16(b - c), _w16(a - d)


def _transform(code, c, buf, r, col):
    """libwebp's DoTransform of a dequantised block into buf[r:r+4,
    col:col+4] by its non-zero code (the top two bits of `code`): 3 the
    full transform as PIL's build runs it (Transform_SSE2, 16-bit lanes),
    2 TransformAC3 and 1 TransformDC (C, int; equal to TransformOne_C on
    their blocks), 0 nothing. The 16-bit lanes differ from the C
    transform only on coefficients no encoder writes."""
    code &= 3
    if code == 0:
        return
    c = [int(v) for v in c]
    if code == 3:
        cols = [_pass16(c[i], c[4 + i], c[8 + i], c[12 + i]) for i in range(4)]
        for i in range(4):
            row = _pass16(cols[0][i], cols[1][i], cols[2][i], cols[3][i], 4)
            for k, v in enumerate(row):
                buf[r + i, col + k] = min(max(int(buf[r + i, col + k]) + (v >> 3), 0), 255)
        return
    tmp = [0] * 16
    for i in range(4):
        a, b = c[i] + c[8 + i], c[i] - c[8 + i]
        cc = _mul2(c[4 + i]) - _mul1(c[12 + i])
        d = _mul1(c[4 + i]) + _mul2(c[12 + i])
        tmp[4 * i: 4 * i + 4] = a + d, b + cc, b - cc, a - d
    for i in range(4):
        dc = tmp[i] + 4
        a, b = dc + tmp[8 + i], dc - tmp[8 + i]
        cc = _mul2(tmp[4 + i]) - _mul1(tmp[12 + i])
        d = _mul1(tmp[4 + i]) + _mul2(tmp[12 + i])
        for k, v in enumerate((a + d, b + cc, b - cc, a - d)):
            buf[r + i, col + k] = min(max(int(buf[r + i, col + k]) + (v >> 3), 0), 255)


def _check_mode(mbx, mby, mode):
    """libwebp's CheckMode: DC prediction without the missing edges."""
    if mode != 0:
        return mode
    if mbx == 0:
        return "dc_notopleft" if mby == 0 else "dc_noleft"
    return "dc_notop" if mby == 0 else 0


def _pred_big(buf, n, mode):
    """The 16x16 luma and 8x8 chroma predictions into buf[1:, 1:]: modes 0
    (DC), 1 (TM), 2 (V), 3 (H) and the DC forms without an edge."""
    top, left = buf[0, 1: n + 1], buf[1: n + 1, 0]
    sh = 5 if n == 16 else 4
    if mode == 0:
        buf[1: n + 1, 1: n + 1] = (int(top.sum() + left.sum()) + n) >> sh
    elif mode == "dc_notop":
        buf[1: n + 1, 1: n + 1] = (int(left.sum()) + n // 2) >> (sh - 1)
    elif mode == "dc_noleft":
        buf[1: n + 1, 1: n + 1] = (int(top.sum()) + n // 2) >> (sh - 1)
    elif mode == "dc_notopleft":
        buf[1: n + 1, 1: n + 1] = 128
    elif mode == 1:
        buf[1: n + 1, 1: n + 1] = np.clip(top[None, :] + left[:, None] - buf[0, 0], 0, 255)
    elif mode == 2:
        buf[1: n + 1, 1: n + 1] = top[None, :]
    else:
        buf[1: n + 1, 1: n + 1] = left[:, None]


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(buf, r, c, mode):
    """The ten 4x4 predictions of libwebp's dsp/dec.c into buf[r:r+4,
    c:c+4] (modes in libwebp's order: DC, TM, VE, HE, RD, VR, LD, VL, HD,
    HU)."""
    t = [int(v) for v in buf[r - 1, c - 1: c + 8]]  # X, A..H
    X, A, B, C, D, E, F, G, H = t
    I, J, K, L = (int(v) for v in buf[r: r + 4, c - 1])
    d = [[0] * 4 for _ in range(4)]  # d[y][x]

    def put(val, *xy):
        for x, y in xy:
            d[y][x] = val

    if mode == 0:
        dc = (A + B + C + D + I + J + K + L + 4) >> 3
        d = [[dc] * 4 for _ in range(4)]
    elif mode == 1:
        for y, lv in enumerate((I, J, K, L)):
            d[y] = [min(max(tv + lv - X, 0), 255) for tv in (A, B, C, D)]
    elif mode == 2:
        row = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        d = [list(row) for _ in range(4)]
    elif mode == 3:
        for y, v in enumerate((_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L))):
            d[y] = [v] * 4
    elif mode == 4:  # RD
        put(_avg3(J, K, L), (0, 3))
        put(_avg3(I, J, K), (1, 3), (0, 2))
        put(_avg3(X, I, J), (2, 3), (1, 2), (0, 1))
        put(_avg3(A, X, I), (3, 3), (2, 2), (1, 1), (0, 0))
        put(_avg3(B, A, X), (3, 2), (2, 1), (1, 0))
        put(_avg3(C, B, A), (3, 1), (2, 0))
        put(_avg3(D, C, B), (3, 0))
    elif mode == 5:  # VR
        put(_avg2(X, A), (0, 0), (1, 2))
        put(_avg2(A, B), (1, 0), (2, 2))
        put(_avg2(B, C), (2, 0), (3, 2))
        put(_avg2(C, D), (3, 0))
        put(_avg3(K, J, I), (0, 3))
        put(_avg3(J, I, X), (0, 2))
        put(_avg3(I, X, A), (0, 1), (1, 3))
        put(_avg3(X, A, B), (1, 1), (2, 3))
        put(_avg3(A, B, C), (2, 1), (3, 3))
        put(_avg3(B, C, D), (3, 1))
    elif mode == 6:  # LD
        put(_avg3(A, B, C), (0, 0))
        put(_avg3(B, C, D), (1, 0), (0, 1))
        put(_avg3(C, D, E), (2, 0), (1, 1), (0, 2))
        put(_avg3(D, E, F), (3, 0), (2, 1), (1, 2), (0, 3))
        put(_avg3(E, F, G), (3, 1), (2, 2), (1, 3))
        put(_avg3(F, G, H), (3, 2), (2, 3))
        put(_avg3(G, H, H), (3, 3))
    elif mode == 7:  # VL
        put(_avg2(A, B), (0, 0))
        put(_avg2(B, C), (1, 0), (0, 2))
        put(_avg2(C, D), (2, 0), (1, 2))
        put(_avg2(D, E), (3, 0), (2, 2))
        put(_avg3(A, B, C), (0, 1))
        put(_avg3(B, C, D), (1, 1), (0, 3))
        put(_avg3(C, D, E), (2, 1), (1, 3))
        put(_avg3(D, E, F), (3, 1), (2, 3))
        put(_avg3(E, F, G), (3, 2))
        put(_avg3(F, G, H), (3, 3))
    elif mode == 8:  # HD
        put(_avg2(I, X), (0, 0), (2, 1))
        put(_avg2(J, I), (0, 1), (2, 2))
        put(_avg2(K, J), (0, 2), (2, 3))
        put(_avg2(L, K), (0, 3))
        put(_avg3(A, B, C), (3, 0))
        put(_avg3(X, A, B), (2, 0))
        put(_avg3(I, X, A), (1, 0), (3, 1))
        put(_avg3(J, I, X), (1, 1), (3, 2))
        put(_avg3(K, J, I), (1, 2), (3, 3))
        put(_avg3(L, K, J), (1, 3))
    else:  # HU
        put(_avg2(I, J), (0, 0))
        put(_avg2(J, K), (2, 0), (0, 1))
        put(_avg2(K, L), (2, 1), (0, 2))
        put(_avg3(I, J, K), (1, 0))
        put(_avg3(J, K, L), (3, 0), (1, 1))
        put(_avg3(K, L, L), (3, 1), (1, 2))
        put(L, (3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))
    buf[r: r + 4, c: c + 4] = d


def _sclip1(v):  # [-1020, 1020] -> [-128, 127]
    return -128 if v < -128 else 127 if v > 127 else v


def _sclip2(v):  # [-112, 112] -> [-16, 15]
    return -16 if v < -16 else 15 if v > 15 else v


def _clip1(v):  # [-255, 511] -> [0, 255]
    return 0 if v < 0 else 255 if v > 255 else v


def _taps(y, x, vertical_edge, k):
    """The index of tap k (-4..3) across an edge at (y, x)."""
    return (y, x + k) if vertical_edge else (y + k, x)


def _filter2(P, y, x, ve):
    p1, p0, q0, q1 = (int(P[_taps(y, x, ve, k)]) for k in (-2, -1, 0, 1))
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
    P[_taps(y, x, ve, -1)] = _clip1(p0 + a2)
    P[_taps(y, x, ve, 0)] = _clip1(q0 - a1)


def _simple_edge(P, y0, x0, ve, thresh):
    """SimpleHFilter16 (ve: across a vertical edge) or SimpleVFilter16."""
    t2 = 2 * thresh + 1
    for i in range(16):
        y, x = (y0 + i, x0) if ve else (y0, x0 + i)
        p1, p0, q0, q1 = (int(P[_taps(y, x, ve, k)]) for k in (-2, -1, 0, 1))
        if 4 * abs(p0 - q0) + abs(p1 - q1) <= t2:
            _filter2(P, y, x, ve)


def _normal_edge(P, y0, x0, ve, n, thresh, ithresh, hev_t, mb_edge):
    """FilterLoop26 (a macroblock edge) or FilterLoop24 (an inner edge)
    along n pixels."""
    t2 = 2 * thresh + 1
    for i in range(n):
        y, x = (y0 + i, x0) if ve else (y0, x0 + i)
        p3, p2, p1, p0, q0, q1, q2, q3 = (int(P[_taps(y, x, ve, k)]) for k in range(-4, 4))
        if 4 * abs(p0 - q0) + abs(p1 - q1) > t2:
            continue
        if max(abs(p3 - p2), abs(p2 - p1), abs(p1 - p0), abs(q3 - q2), abs(q2 - q1),
               abs(q1 - q0)) > ithresh:
            continue
        if abs(p1 - p0) > hev_t or abs(q1 - q0) > hev_t:
            _filter2(P, y, x, ve)
        elif mb_edge:
            a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
            a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
            for k, v in ((-3, p2 + a3), (-2, p1 + a2), (-1, p0 + a1), (0, q0 - a1),
                         (1, q1 - a2), (2, q2 - a3)):
                P[_taps(y, x, ve, k)] = _clip1(v)
        else:
            a = 3 * (q0 - p0)
            a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
            a3 = (a1 + 1) >> 1
            for k, v in ((-2, p1 + a3), (-1, p0 + a2), (0, q0 - a1), (1, q1 - a3)):
                P[_taps(y, x, ve, k)] = _clip1(v)


def vp8_plain(stream: bytes):
    """vp8 in Python."""
    return _Vp8(stream).decode()


# --------------------------------------------------------- VP8L plain ---

class _LBits:
    """VP8L's LSB-first bit reader; as libwebp's, a stream shorter than 8
    bytes reads zeros up to 64 bits, and reading past that or past the
    end of a longer one raises."""

    def __init__(self, data: bytes):
        self.val = int.from_bytes(data, "little")
        self.pos, self.limit = 0, max(8 * len(data), 64)

    def read(self, n: int) -> int:
        if self.pos + n > self.limit:
            raise ValueError("corrupt VP8L stream: " + ERRORS[-1])
        v = (self.val >> self.pos) & ((1 << n) - 1)
        self.pos += n
        return v


class _WindowBits:
    """libwebp's VP8LBitReader as DecodeAlphaData reads it, from a bit
    position of _LBits on: its 64-bit window over the stream's last 8 bytes
    once they are loaded (`base`), a peek past the end that reads zeros up
    to the window's 64 bits and wraps to its start beyond (the shift is
    taken mod 64), and the end of stream found only where the window is
    refilled (VP8LFillBitWindow, VP8LReadBits) or the loop asks, which sets
    the position back to the window's start."""

    def __init__(self, br: _LBits):
        self.val, self.pos, self.limit, self.eos = br.val, br.pos, br.limit, False
        self.base = self.limit - 64
        self.window = (self.val >> self.base) & ((1 << 64) - 1)

    def peek(self) -> int:
        if self.pos < self.base:
            return (self.val >> self.pos) & 0xFFFFFFFF
        return (self.window >> ((self.pos - self.base) & 63)) & 0xFFFFFFFF

    def _shift(self) -> None:
        if self.eos or self.pos > self.limit:
            self.eos, self.pos = True, self.base

    def fill(self) -> None:
        if self.pos - self.base >= 32:
            self._shift()

    def read(self, n: int) -> int:
        if self.eos:
            self.pos = self.base
            return 0
        v = self.peek() & ((1 << n) - 1)
        self.pos += n
        self._shift()
        return v

    def symbol(self, code: "_Code") -> int:
        """ReadSymbol: the first 8 bits from one peek, the rest of a longer
        code from a second peek 8 bits on (libwebp's two-level table)."""
        if code.single is not None:
            return code.single
        low = self.peek()
        self.pos += 8
        high = self.peek()
        self.pos -= 8
        bits = (low & 0xFF) | (high << 8)
        sym, length = code.decode_bits(bits)
        self.pos += length
        return sym

    def at_end(self) -> bool:
        self.eos = self.eos or self.pos > self.limit
        return self.eos


class _Code:
    """A canonical prefix code decoded bit by bit (a single symbol reads
    no bit)."""

    def __init__(self, lengths):
        syms = [(ln, s) for s, ln in enumerate(lengths) if ln]
        if not syms:
            raise ValueError("corrupt VP8L stream: an empty prefix code")
        self.single = syms[0][1] if len(syms) == 1 else None
        if self.single is not None:
            return
        counts = [0] * 16
        for ln, _s in syms:
            counts[ln] += 1
        left = 1
        for ln in range(1, 16):
            left = 2 * left - counts[ln]
            if left < 0:
                raise ValueError("corrupt VP8L stream: an over-full prefix code")
        if left:
            raise ValueError("corrupt VP8L stream: an incomplete prefix code")
        self.counts = counts
        self.syms = [s for _ln, s in sorted(syms)]

    def read(self, br: _LBits) -> int:
        if self.single is not None:
            return self.single
        code = first = index = 0
        for ln in range(1, 16):
            code |= br.read(1)
            n = self.counts[ln]
            if code - first < n:
                return self.syms[index + code - first]
            index += n
            first = (first + n) << 1
            code <<= 1
        raise ValueError("corrupt VP8L stream: a bad prefix code")

    def decode_bits(self, bits: int) -> tuple:
        """(symbol, code length) of the code at the start of `bits` (LSB
        first)."""
        code = first = index = 0
        for ln in range(1, 16):
            code |= (bits >> (ln - 1)) & 1
            n = self.counts[ln]
            if code - first < n:
                return self.syms[index + code - first], ln
            index += n
            first = (first + n) << 1
            code <<= 1
        raise ValueError("corrupt VP8L stream: a bad prefix code")


def _read_code(br: _LBits, size: int, used: dict) -> _Code:
    """libwebp's ReadHuffmanCode: a simple or a normal code of `size`
    symbols."""
    lengths = [0] * max(size, 256)
    if br.read(1):
        used["simple_codes"] += 1
        two = br.read(1)
        lengths[br.read(8 if br.read(1) else 1)] = 1
        if two:
            lengths[br.read(8)] = 1
        return _Code(lengths[:size])
    cl = [0] * 19
    for i in range(br.read(4) + 4):
        cl[int(T.CODE_LENGTH_ORDER[i])] = br.read(3)
    lcode = _Code(cl)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > size:
            raise ValueError("corrupt VP8L stream: max_symbol past the alphabet")
    else:
        max_symbol = size
    sym, prev = 0, 8
    while sym < size:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = lcode.read(br)
        if c < 16:
            lengths[sym] = c
            sym += 1
            if c:
                prev = c
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
            rep = br.read(extra) + offset
            if sym + rep > size:
                raise ValueError("corrupt VP8L stream: a repeat past the alphabet")
            lengths[sym: sym + rep] = [prev if c == 16 else 0] * rep
            sym += rep
    return _Code(lengths[:size])


def _sub(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _add(a: int, b: int) -> int:
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | \
        (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _avg(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _chans(p: int):
    return (p >> 24) & 255, (p >> 16) & 255, (p >> 8) & 255, p & 255


def _pack(ch) -> int:
    return (ch[0] << 24) | (ch[1] << 16) | (ch[2] << 8) | ch[3]


def _predict(mode: int, L: int, T_: int, TL: int, TR: int) -> int:
    """The 14 VP8L predictors (and 14, 15 as 0: black)."""
    if mode == 1:
        return L
    if mode == 2:
        return T_
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _avg(_avg(L, TR), T_)
    if mode == 6:
        return _avg(L, TL)
    if mode == 7:
        return _avg(L, T_)
    if mode == 8:
        return _avg(TL, T_)
    if mode == 9:
        return _avg(T_, TR)
    if mode == 10:
        return _avg(_avg(L, TL), _avg(T_, TR))
    if mode == 11:
        s = sum(abs(b - c) - abs(a - c) for a, b, c in zip(_chans(T_), _chans(L), _chans(TL)))
        return T_ if s <= 0 else L
    if mode == 12:
        return _pack([min(max(a + b - c, 0), 255)
                      for a, b, c in zip(_chans(L), _chans(T_), _chans(TL))])
    if mode == 13:
        out = []
        for a, c in zip(_chans(_avg(L, T_)), _chans(TL)):
            d = a - c
            out.append(min(max(a + (d // 2 if d >= 0 else -((-d) // 2)), 0), 255))
        return _pack(out)
    return 0xFF000000


class _Vp8l:
    """The plain VP8L decoder (libwebp's vp8l_dec.c and lossless.c)."""

    def __init__(self, data: bytes, alpha: bool = False):
        self.br, self.alpha = _LBits(data), alpha
        self.used = {"transforms": set(), "bundling": set(), "cache": set(), "meta": 0,
                     "predictors": set(), "simple_codes": 0, "copies": 0}

    def image(self, xsize: int, ysize: int, level0: bool) -> list:
        br = self.br
        transforms = []
        if level0:
            seen = set()
            while br.read(1):
                kind = br.read(2)
                if kind in seen:
                    raise ValueError("corrupt VP8L stream: a transform twice")
                seen.add(kind)
                self.used["transforms"].add(kind)
                if kind in (0, 1):
                    bits = br.read(3) + 2
                    data = self.image(_sub(xsize, bits), _sub(ysize, bits), False)
                    transforms.append((kind, xsize, bits, data))
                    if kind == 0:
                        self.used["predictors"].update((p >> 8) & 0xF for p in data)
                elif kind == 3:
                    n = br.read(8) + 1
                    bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
                    pal = self.image(n, 1, False)
                    full = [0] * (1 << (8 >> bits))
                    full[0] = pal[0]
                    for i in range(1, n):
                        full[i] = _add(pal[i], full[i - 1])
                    transforms.append((kind, xsize, bits, full))
                    self.used["bundling"].add(bits)
                    xsize = _sub(xsize, bits)
                else:
                    transforms.append((kind, xsize, 0, None))
        cache_bits = 0
        if br.read(1):
            cache_bits = br.read(4)
            if not 1 <= cache_bits <= 11:
                raise ValueError("corrupt VP8L stream: bad colour cache bits")
            self.used["cache"].add(cache_bits)
        meta_bits, meta = 0, None
        if level0 and br.read(1):
            meta_bits = br.read(3) + 2
            img = self.image(_sub(xsize, meta_bits), _sub(ysize, meta_bits), False)
            meta = [(p >> 8) & 0xFFFF for p in img]
            self.used["meta"] += 1
        ngroups = max(meta) + 1 if meta else 1
        groups = []
        for _g in range(ngroups):
            sizes = (256 + 24 + ((1 << cache_bits) if cache_bits else 0), 256, 256, 256, 40)
            groups.append([_read_code(br, s, self.used) for s in sizes])
        if level0 and self.alpha and [t[0] for t in transforms] == [3] and not cache_bits \
                and all(c.single is not None for g in groups for c in g[1:4]):
            px = self.pixels_8b(xsize, ysize, groups, meta, meta_bits)
        else:
            px = self.pixels(xsize, ysize, groups, meta, meta_bits, cache_bits)
        for kind, width, bits, data in reversed(transforms):
            px = _inverse(kind, width, ysize, bits, data, px)
        return px

    def pixels(self, w, h, groups, meta, meta_bits, cache_bits):
        br = self.br
        n = w * h
        out = [0] * n
        cache = [0] * (1 << cache_bits) if cache_bits else None
        mw = _sub(w, meta_bits) if meta else 0
        pos = cached = 0

        def group_at(p):
            if meta is None:
                return groups[0]
            y, x = divmod(p, w)
            return groups[meta[(y >> meta_bits) * mw + (x >> meta_bits)]]

        while pos < n:
            g = group_at(pos)
            code = g[0].read(br)
            if code < 256:
                red, blue, alpha = g[1].read(br), g[2].read(br), g[3].read(br)
                out[pos] = (alpha << 24) | (red << 16) | (code << 8) | blue
                pos += 1
            elif code < 280:
                length = _prefix_value(code - 256, br)
                dist = _prefix_value(g[4].read(br), br)
                if dist > 120:
                    dist -= 120
                else:
                    c = int(T.CODE_TO_PLANE[dist - 1])
                    dist = max((c >> 4) * w + 8 - (c & 0xF), 1)
                if dist > pos or n - pos < length:
                    raise ValueError("corrupt VP8L stream: a copy out of the image")
                self.used["copies"] += 1
                for _k in range(length):
                    out[pos] = out[pos - dist]
                    pos += 1
            else:
                while cached < pos:
                    cache[((out[cached] * 0x1E35A7BD) & 0xFFFFFFFF) >> (32 - cache_bits)] = \
                        out[cached]
                    cached += 1
                out[pos] = cache[code - 280]
                pos += 1
            if cache is not None:
                while cached < pos:
                    cache[((out[cached] * 0x1E35A7BD) & 0xFFFFFFFF) >> (32 - cache_bits)] = \
                        out[cached]
                    cached += 1
        return out


    def pixels_8b(self, w, h, groups, meta, meta_bits):
        """libwebp's DecodeAlphaData: an ALPH stream of colour indices
        alone (no colour cache, red, blue and alpha of one symbol each),
        read through libwebp's bit window. The end of the stream is asked
        for only after each symbol and its copy, and the image fails only
        when the stream ended before its last pixel: the last symbols may
        be read past the end."""
        br = _WindowBits(self.br)
        n = w * h
        out = [0] * n
        mw = _sub(w, meta_bits) if meta else 0
        pos = 0
        while not br.eos and pos < n:
            y, x = divmod(pos, w)
            g = groups[meta[(y >> meta_bits) * mw + (x >> meta_bits)]] if meta else groups[0]
            br.fill()
            code = br.symbol(g[0])
            if code < 256:
                out[pos] = (g[3].single << 24) | (g[1].single << 16) | (code << 8) | g[2].single
                pos += 1
            elif code < 280:
                length = _prefix_value(code - 256, br)
                dsym = br.symbol(g[4])
                br.fill()
                dist = _prefix_value(dsym, br)
                if dist > 120:
                    dist -= 120
                else:
                    c = int(T.CODE_TO_PLANE[dist - 1])
                    dist = max((c >> 4) * w + 8 - (c & 0xF), 1)
                if dist > pos or n - pos < length:
                    raise ValueError("corrupt VP8L stream: a copy out of the image")
                self.used["copies"] += 1
                for _k in range(length):
                    out[pos] = out[pos - dist]
                    pos += 1
            else:
                raise ValueError("corrupt VP8L stream: a colour cache code without a cache")
            br.at_end()
        if br.at_end() and pos < n:
            raise ValueError("corrupt VP8L stream: " + ERRORS[-1])
        self.br.pos = br.pos
        return out


def _prefix_value(sym: int, br: _LBits) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _inverse(kind, w, h, bits, data, px):
    """One inverse transform of a w x h image's ARGB list."""
    if kind == 2:  # subtract green
        out = []
        for p in px:
            g = (p >> 8) & 0xFF
            out.append((p & 0xFF00FF00) | ((((p >> 16) + g) & 0xFF) << 16) | ((p + g) & 0xFF))
        return out
    if kind == 3:  # colour indexing
        bpp = 8 >> bits
        per, mask = 1 << bits, (1 << bpp) - 1
        pw = _sub(w, bits)
        out = []
        for y in range(h):
            for x in range(w):
                idx = (px[y * pw + (x >> bits)] >> 8) & 0xFF
                out.append(data[(idx >> (bpp * (x & (per - 1)))) & mask])
        return out
    tiles = _sub(w, bits)
    out = [0] * (w * h)
    for y in range(h):
        for x in range(w):
            i = y * w + x
            m = data[(y >> bits) * tiles + (x >> bits)]
            if kind == 0:  # predictor
                if y == 0:
                    pred = 0xFF000000 if x == 0 else out[i - 1]
                elif x == 0:
                    pred = out[i - w]
                else:
                    pred = _predict((m >> 8) & 0xF, out[i - 1], out[i - w], out[i - w - 1],
                                    out[i - w + 1])
                out[i] = _add(px[i], pred)
            else:  # cross colour
                p = px[i]
                g2r, g2b, r2b = m & 0xFF, (m >> 8) & 0xFF, (m >> 16) & 0xFF
                green = _s8((p >> 8) & 0xFF)
                red = ((p >> 16) + ((_s8(g2r) * green) >> 5)) & 0xFF
                blue = p + ((_s8(g2b) * green) >> 5) + ((_s8(r2b) * _s8(red)) >> 5)
                out[i] = (p & 0xFF00FF00) | (red << 16) | (blue & 0xFF)
    return out


def _s8(v: int) -> int:
    return v - 256 if v & 0x80 else v


def vp8l_plain(stream: bytes, w: int, h: int, alpha: bool = False) -> np.ndarray:
    """vp8l in Python."""
    px = _Vp8l(stream, alpha).image(w, h, True)
    return np.array(px, np.uint32).reshape(h, w)


def features(data: bytes) -> dict:
    """What a WebP file's first frame exercises, from its plain decode: the
    codec, the ALPH header, and for VP8 the header fields with the
    segments, modes and skips used, for VP8L (and a lossless ALPH) the
    transforms (0 predictor, 1 cross colour, 2 subtract green, 3 colour
    indexing), bundling bits, colour cache bits, meta codes, predictor
    modes, simple codes and LZ77 copies used."""
    f = read_frame(data)
    out = {"codec": f.codec, "box": f.box, "canvas": f.canvas, "has_alpha": f.has_alpha,
           "alph": alpha_header(f.alph) if f.alph is not None else None}
    if f.codec == "VP8":
        dec = _Vp8(f.stream)
        dec.decode()
        out["vp8"] = dict(dec.header, **dec.used)
        if f.alph is not None and out["alph"][0] == 1:
            lossless = _Vp8l(f.alph[1:], alpha=True)
            lossless.image(f.box[2], f.box[3], True)
            out["vp8l"] = lossless.used
    else:
        lossless = _Vp8l(f.stream[5:])
        lossless.image(f.box[2], f.box[3], True)
        out["vp8l"] = lossless.used
    return out


def stage_pairs(data: bytes, max_pixels: int = 20000):
    """The C++ stages beside their plain twins on the same input: yields
    (stage, C++ output, plain output). The bitstream decoders ("vp8",
    "vp8l") run whole on a frame of at most max_pixels pixels; upsampling
    runs on the frame's planes cut to at most 64x48 luma from the top left
    (the chroma cut with it), the ALPH unfilter on its filtered values cut
    likewise."""
    f = read_frame(data)
    w, h = f.box[2], f.box[3]
    small = w * h <= max_pixels
    if f.codec == "VP8L":
        if small:
            yield "vp8l", vp8l(f.stream[5:], w, h), vp8l_plain(f.stream[5:], w, h)
        return
    planes = vp8(f.stream)
    if small:
        yield "vp8", np.concatenate([p.ravel() for p in planes]), \
            np.concatenate([p.ravel() for p in vp8_plain(f.stream)])
    cw, ch = min(w, 64), min(h, 48)
    cut = (planes[0][:ch, :cw], planes[1][:(ch + 1) // 2, :(cw + 1) // 2],
           planes[2][:(ch + 1) // 2, :(cw + 1) // 2])
    yield "upsample", upsample(*cut), upsample_plain(*cut)
    if f.alph is not None:
        method, filt = alpha_header(f.alph)
        if method == 1 and small:
            yield "vp8l", vp8l(f.alph[1:], w, h, True), vp8l_plain(f.alph[1:], w, h, True)
        deltas = alpha_deltas(f.alph, w, h)[:48, :64]
        yield "alpha_unfilter", alpha_unfilter(deltas, filt), alpha_unfilter_plain(deltas, filt)
