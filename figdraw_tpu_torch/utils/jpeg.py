"""The port's JPEG decoder: a JPEG byte string to (H, W, 4) uint8 RGBA, as
PIL 12.1.0's `Image.open(path).convert("RGBA")` returns it through
libjpeg-turbo 3.1.3 (figdraw_tpu decodes through PIL; the port may not
import it). The markers are read here with struct; the entropy decoding,
the IDCT, the upsampling and the colour conversion run in C++
(csrc/image_decode.cpp, utils.image_lib), each beside its plain Python or
numpy twin in this module (`scan_plain`, `idct_plain`, `upsample_plain`,
`color_plain`), the tests' reference.

Read: SOI, APPn (APP0's JFIF and APP14's Adobe transform flag), DQT (8-
and 16-bit tables), SOF0/SOF1 (baseline and extended Huffman, 8-bit) and
SOF2 (progressive), DHT, DRI with RST0-7, SOS, EOI, COM; any number of
components (1, 3 or 4 decode to pixels) with any integral sampling
factors. Scans: sequential Huffman, interleaved or not, and progressive
(DC first and refine, AC first and refine, EOB runs, successive
approximation). Arithmetic coding (SOF9-11, SOF13-15), lossless (SOF3,
SOF7, SOF11, SOF15), hierarchical (SOF5-7) and 12-bit samples raise
NotImplementedError; a malformed file raises ValueError.

The pixel pipeline is libjpeg-turbo's integer arithmetic with PIL's
settings (JDCT_ISLOW, do_fancy_upsampling, no block smoothing: a complete
progressive file has every coefficient refined):
- dequantisation and jpeg_idct_islow as libjpeg-turbo runs it on x86-64
  (jsimd_idct_islow, jidctint-avx2.asm): jidctint.c's arithmetic in
  16-bit lanes (see fd_jpeg_idct_islow). It equals jidctint.c with its
  range-limit table whenever no intermediate leaves int16, which holds for
  every quantiser up to 8191; past that (16-bit tables PIL's own encoder
  cannot honour) the C code would differ from PIL by up to 255, and this
  arithmetic matches PIL there too;
- each component to the full grid (jdsample.c): h2v1 and h2v2 fancy
  upsampling when the component is more than 2 samples wide (h2v2 with
  its 8/7 bias and context rows), h1v2 fancy, box replication otherwise
  and for the other integral ratios; the component's edge samples stand
  in for the samples past its edges (the first/last column cases and
  jdmainct.c's context rows);
- YCbCr -> RGB with jdcolor.c's fixed-point tables (SCALEBITS 16);
  grayscale; RGB kept (Adobe transform 0, or component ids 'R' 'G' 'B');
- CMYK (Adobe transform 0, or four components without APP14) and YCCK
  (Adobe transform 2, or any other): YCCK -> CMYK as ycck_cmyk_convert;
  PIL reads every CMYK JPEG as Adobe-inverted ("CMYK;I": 255 - v) and
  converts CMYK to RGB as its Convert.c cmyk2rgb: with nk = 255 - K,
  each of R, G, B is nk - (X * nk + 128 + ((X * nk + 128) >> 8)) >> 8.
No EXIF orientation is applied (PIL's open does not apply it).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from . import image_lib

UNSUPPORTED = ("{} is not decoded by figdraw_tpu_torch: not ported yet "
               "(ROADMAP.md, module item 'Image formats other than PNG')")

# zigzag position -> natural (row-major) index; the 16 entries past 63
# absorb a corrupt run length (jutils.c jpeg_natural_order)
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63] + [63] * 16)

SEQUENTIAL, PROGRESSIVE = 0, 1
# upsampling methods (fd_jpeg_upsample)
BOX, H2V1, H2V2, H1V2 = 0, 1, 2, 3
# colour conversions (fd_jpeg_color)
YCC_RGB, YCC_INVERTED = 0, 1

_SOF_KIND = {0xC0: SEQUENTIAL, 0xC1: SEQUENTIAL, 0xC2: PROGRESSIVE}
_SOF_OTHER = {0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)",
              0xC6: "hierarchical (SOF6)", 0xC7: "hierarchical lossless (SOF7)",
              0xC9: "arithmetic-coded (SOF9)", 0xCA: "arithmetic-coded (SOF10)",
              0xCB: "arithmetic-coded lossless (SOF11)",
              0xCD: "hierarchical arithmetic-coded (SOF13)",
              0xCE: "hierarchical arithmetic-coded (SOF14)",
              0xCF: "hierarchical arithmetic-coded lossless (SOF15)"}


class Component:
    """One frame component: its sampling factors, quantisation table
    (latched at its first scan, as libjpeg does), its sample extent and
    its MCU-padded coefficient array."""

    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None  # 64 uint16 quantisers, natural order

    def place(self, w, hgt, hmax, vmax, mcux, mcuy):
        self.cw = -(-w * self.h // hmax)  # downsampled_width
        self.ch = -(-hgt * self.v // vmax)
        self.nbw, self.nbh = -(-self.cw // 8), -(-self.ch // 8)
        self.bw, self.bh = mcux * self.h, mcuy * self.v
        self.coefs = np.zeros((self.bh, self.bw, 64), np.int16)


class Frame:
    """The markers of a JPEG file read and its scans decoded into the
    components' coefficients."""

    def __init__(self):
        self.kind = None
        self.width = self.height = 0
        self.components = []
        self.jfif = False
        self.adobe = None  # APP14's transform flag
        self.restart = 0


def _segment(data: bytes, pos: int):
    if pos + 4 > len(data):
        raise ValueError("truncated JPEG file: a marker segment runs past the end")
    (n,) = struct.unpack_from(">H", data, pos + 2)
    if n < 2 or pos + 2 + n > len(data):
        raise ValueError("truncated JPEG file: a marker segment runs past the end")
    return data[pos + 4: pos + 2 + n], pos + 2 + n


def _read_dqt(seg: bytes, qtables: dict) -> None:
    i = 0
    while i < len(seg):
        pq, tq = seg[i] >> 4, seg[i] & 15
        n = 128 if pq else 64
        if pq > 1 or tq > 3 or i + 1 + n > len(seg):
            raise ValueError("malformed JPEG DQT segment")
        vals = np.frombuffer(seg, ">u2" if pq else np.uint8, 64, i + 1).astype(np.uint16)
        table = np.zeros(64, np.uint16)
        table[NATURAL[:64]] = vals
        qtables[tq] = table
        i += 1 + n


def _read_dht(seg: bytes, htables: dict) -> None:
    i = 0
    while i < len(seg):
        if i + 17 > len(seg):
            raise ValueError("malformed JPEG DHT segment")
        tc, th = seg[i] >> 4, seg[i] & 15
        counts = seg[i + 1: i + 17]
        n = sum(counts)
        if tc > 1 or th > 3 or n > 256 or i + 17 + n > len(seg):
            raise ValueError("malformed JPEG DHT segment")
        spec = np.zeros(272, np.uint8)
        spec[:16] = np.frombuffer(counts, np.uint8)
        spec[16: 16 + n] = np.frombuffer(seg, np.uint8, n, i + 17)
        htables[(tc, th)] = spec
        i += 17 + n


def _read_sof(seg: bytes, frame: Frame, kind: int) -> None:
    if len(seg) < 6:
        raise ValueError("malformed JPEG SOF segment")
    p, hgt, w, nc = struct.unpack_from(">BHHB", seg)
    if p != 8:
        raise NotImplementedError(UNSUPPORTED.format(f"a {p}-bit JPEG"))
    if hgt == 0:
        raise ValueError("JPEG with no height in its SOF (a DNL marker) is not supported")
    if w == 0 or nc == 0 or len(seg) < 6 + 3 * nc:
        raise ValueError("malformed JPEG SOF segment")
    frame.kind, frame.width, frame.height = kind, w, hgt
    for k in range(nc):
        cid, hv, tq = seg[6 + 3 * k: 9 + 3 * k]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
            raise ValueError("malformed JPEG SOF segment")
        frame.components.append(Component(cid, h, v, tq))
    hmax = max(c.h for c in frame.components)
    vmax = max(c.v for c in frame.components)
    frame.hmax, frame.vmax = hmax, vmax
    frame.mcux, frame.mcuy = -(-w // (8 * hmax)), -(-hgt // (8 * vmax))
    for c in frame.components:
        c.place(w, hgt, hmax, vmax, frame.mcux, frame.mcuy)


def _scan_args(seg: bytes, frame: Frame, qtables: dict, htables: dict):
    """The SOS header: the scan's components (their quantisation tables
    latched), the int32 rows and Huffman specs fd_jpeg_scan takes, and
    Ss, Se, Ah, Al."""
    if frame.kind is None:
        raise ValueError("JPEG SOS before a frame header")
    ns = seg[0] if seg else 0
    if not 1 <= ns <= 4 or len(seg) < 4 + 2 * ns:
        raise ValueError("malformed JPEG SOS segment")
    by_id = {c.id: c for c in frame.components}
    comps, rows, tabs = [], np.zeros((ns, 5), np.int32), np.zeros((ns, 544), np.uint8)
    ss, se, a = seg[1 + 2 * ns: 4 + 2 * ns]
    ah, al = a >> 4, a & 15
    for k in range(ns):
        cid, t = seg[1 + 2 * k: 3 + 2 * k]
        if cid not in by_id:
            raise ValueError("JPEG scan names a component the frame does not have")
        c = by_id[cid]
        if c.qt is None:
            if c.tq not in qtables:
                raise ValueError("JPEG component without a quantisation table")
            c.qt = qtables[c.tq].copy()
        comps.append(c)
        rows[k] = (c.h, c.v, c.bw, c.nbw, c.nbh)
        dc_needed = ss == 0 and (frame.kind == SEQUENTIAL or ah == 0)
        ac_needed = frame.kind == SEQUENTIAL or ss > 0
        for slot, key, needed in ((0, (0, t >> 4), dc_needed), (272, (1, t & 15), ac_needed)):
            if needed:
                if key not in htables:
                    raise ValueError("JPEG scan uses an undefined Huffman table")
                tabs[k, slot: slot + 272] = htables[key]
    if frame.kind == SEQUENTIAL:
        ss, se, ah, al = 0, 63, 0, 0
    elif (ss == 0) != (se == 0) or se > 63 or ss > se or (ss > 0 and ns != 1) or al > 13:
        raise ValueError("malformed JPEG progressive scan parameters")
    return comps, rows, tabs, (ss, se, ah, al)


def read_frame(data: bytes, plain: bool = False) -> Frame:
    """Read the markers of `data` and decode each scan into the components'
    coefficients (fd_jpeg_scan, or scan_plain when plain)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file: no SOI marker")
    frame, qtables, htables = Frame(), {}, {}
    pos, seen_eoi = 2, False
    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1  # libjpeg skips junk before a marker (with a warning)
            continue
        code = data[pos + 1] if pos + 1 < len(data) else 0
        if code == 0xFF:
            pos += 1
            continue
        if code == 0xD9:
            seen_eoi = True
            break
        if code == 0x00 or 0xD0 <= code <= 0xD8 or code == 0x01:
            pos += 2
            continue
        seg, nxt = _segment(data, pos)
        if code in _SOF_KIND or code in _SOF_OTHER:
            if frame.kind is not None:
                raise ValueError("JPEG file with two frame headers")
            if code in _SOF_OTHER:
                raise NotImplementedError(UNSUPPORTED.format(f"a {_SOF_OTHER[code]} JPEG"))
            _read_sof(seg, frame, _SOF_KIND[code])
        elif code == 0xC4:
            _read_dht(seg, htables)
        elif code == 0xCC:
            raise NotImplementedError(UNSUPPORTED.format("an arithmetic-coded JPEG (DAC)"))
        elif code == 0xDB:
            _read_dqt(seg, qtables)
        elif code == 0xDD:
            if len(seg) < 2:
                raise ValueError("malformed JPEG DRI segment")
            (frame.restart,) = struct.unpack_from(">H", seg)
        elif code == 0xDC:
            raise ValueError("JPEG DNL markers are not supported")
        elif code == 0xE0:
            frame.jfif = frame.jfif or (len(seg) >= 14 and seg[:5] == b"JFIF\x00")
        elif code == 0xEE:
            if len(seg) >= 12 and seg[:5] == b"Adobe":
                frame.adobe = seg[11]
        elif code == 0xDA:
            comps, rows, tabs, params = _scan_args(seg, frame, qtables, htables)
            scan = scan_plain if plain else scan_native
            nxt = scan(data, nxt, frame, comps, rows, tabs, params)
        pos = nxt
    if frame.kind is None:
        raise ValueError("JPEG file without a frame header")
    if not seen_eoi:
        raise ValueError("truncated JPEG file: no EOI marker")
    for c in frame.components:
        if c.qt is None:
            raise ValueError("JPEG component that no scan carries")
    return frame


def scan_native(data, pos, frame, comps, rows, tabs, params) -> int:
    """One scan's entropy-coded data from `pos` into the components'
    coefficients, in C++; returns the position of the marker after it."""
    ss, se, ah, al = params
    buf = np.frombuffer(data, np.uint8)
    ptrs = (ctypes.c_void_p * len(comps))(*[c.coefs.ctypes.data for c in comps])
    end = image_lib.load().fd_jpeg_scan(
        buf.ctypes.data, len(data), pos, len(comps), rows.ctypes.data, tabs.ctypes.data,
        ptrs, frame.mcux, frame.mcuy, frame.restart, ss, se, ah, al, frame.kind)
    if end < 0:
        raise ValueError(f"corrupt JPEG scan data (code {end})")
    return int(end)


class _PlainHuff:
    def __init__(self, spec):
        self.codes, code, k = {}, 0, 16
        for length in range(1, 17):
            for _ in range(int(spec[length - 1])):
                self.codes[(length, code)] = int(spec[k])
                code += 1
                k += 1
            code <<= 1


class _PlainBits:
    """jdhuff.c's bit reader: 0xFF 0x00 is a stuffed 0xFF; a marker stops
    the feed, which then gives zero bits."""

    def __init__(self, data, pos):
        self.data, self.pos, self.acc, self.n, self.marker = data, pos, 0, 0, False

    def _byte(self):
        d = self.data
        if self.marker or self.pos >= len(d):
            return 0
        c = d[self.pos]
        if c != 0xFF:
            self.pos += 1
            return c
        q = self.pos + 1
        while q < len(d) and d[q] == 0xFF:
            q += 1
        if q < len(d) and d[q] == 0:
            self.pos = q + 1
            return 0xFF
        self.marker, self.pos = True, q - 1
        return 0

    def bits(self, k):
        while self.n < k:
            self.acc = (self.acc << 8) | self._byte()
            self.n += 8
        self.n -= k
        v = self.acc >> self.n
        self.acc &= (1 << self.n) - 1
        return v

    def decode(self, huff):
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.bits(1)
            if (length, code) in huff.codes:
                return huff.codes[(length, code)]
        raise ValueError("corrupt JPEG scan data: a bad Huffman code")

    def restart(self, expect):
        d, q = self.data, self.pos
        self.acc = self.n = 0
        self.marker = False
        while q + 1 < len(d) and not (d[q] == 0xFF and d[q + 1] not in (0, 0xFF)):
            q += 1
        if q + 1 >= len(d) or d[q + 1] != 0xD0 + expect:
            raise ValueError("corrupt JPEG scan data: a restart marker is missing")
        self.pos = q + 2


def _extend(v, s):
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _int16(v):
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def scan_plain(data, pos, frame, comps, rows, tabs, params) -> int:
    """scan_native in Python, bit by bit (jdhuff.c decode_mcu, jdphuff.c's
    four decode_mcu_* kinds): the tests' reference."""
    ss, se, ah, al = params
    dc = [_PlainHuff(t[:272]) for t in tabs]
    ac = [_PlainHuff(t[272:]) for t in tabs]
    b = _PlainBits(data, pos)
    pred, eobrun = [0] * len(comps), 0
    if len(comps) == 1:
        per_row, total = comps[0].nbw, comps[0].nbw * comps[0].nbh
    else:
        per_row, total = frame.mcux, frame.mcux * frame.mcuy
    p1, m1 = 1 << al, -(1 << al)
    left, nxt = frame.restart, 0
    for m in range(total):
        if frame.restart:
            if left == 0:
                b.restart(nxt)
                nxt, left = (nxt + 1) & 7, frame.restart
                pred, eobrun = [0] * len(comps), 0
            left -= 1
        my, mx = divmod(m, per_row)
        for ci, c in enumerate(comps):
            hh, vv = (1, 1) if len(comps) == 1 else (c.h, c.v)
            for v in range(vv):
                for h in range(hh):
                    blk = c.coefs[my * vv + v, mx * hh + h]
                    if frame.kind == SEQUENTIAL:
                        s = b.decode(dc[ci])
                        pred[ci] += _extend(b.bits(s), s) if s else 0
                        blk[0] = _int16(pred[ci])
                        k = 1
                        while k < 64:
                            rs = b.decode(ac[ci])
                            r, s = rs >> 4, rs & 15
                            if s:
                                k += r
                                blk[NATURAL[k]] = _extend(b.bits(s), s)
                            elif r == 15:
                                k += 15
                            else:
                                break
                            k += 1
                    elif ss == 0:
                        if ah == 0:
                            s = b.decode(dc[ci])
                            pred[ci] += _extend(b.bits(s), s) if s else 0
                            blk[0] = _int16(pred[ci] << al)
                        elif b.bits(1):
                            blk[0] = _int16(int(blk[0]) | p1)
                    elif ah == 0:
                        if eobrun > 0:
                            eobrun -= 1
                            continue
                        k = ss
                        while k <= se:
                            rs = b.decode(ac[ci])
                            r, s = rs >> 4, rs & 15
                            if s:
                                k += r
                                blk[NATURAL[k]] = _int16(_extend(b.bits(s), s) << al)
                            elif r == 15:
                                k += 15
                            else:
                                eobrun = (1 << r) + (b.bits(r) if r else 0) - 1
                                break
                            k += 1
                    else:
                        k = ss
                        if eobrun == 0:
                            while k <= se:
                                rs = b.decode(ac[ci])
                                r, s = rs >> 4, rs & 15
                                if s:
                                    s = p1 if b.bits(1) else m1
                                elif r != 15:
                                    eobrun = (1 << r) + (b.bits(r) if r else 0)
                                    break
                                while k <= se:
                                    z = NATURAL[k]
                                    t = int(blk[z])
                                    if t != 0:
                                        if b.bits(1) and (t & p1) == 0:
                                            blk[z] = t + p1 if t >= 0 else t + m1
                                    else:
                                        r -= 1
                                        if r < 0:
                                            break
                                    k += 1
                                if s:
                                    blk[NATURAL[k]] = s
                                k += 1
                        if eobrun > 0:
                            while k <= se:
                                z = NATURAL[k]
                                t = int(blk[z])
                                if t != 0 and b.bits(1) and (t & p1) == 0:
                                    blk[z] = t + p1 if t >= 0 else t + m1
                                k += 1
                            eobrun -= 1
    q, d = b.pos, data
    while True:
        while q + 1 < len(d) and not (d[q] == 0xFF and d[q + 1] not in (0, 0xFF)):
            q += 1
        if q + 1 >= len(d):
            raise ValueError("truncated JPEG file: a scan runs past the end")
        if 0xD0 <= d[q + 1] <= 0xD7:
            q += 2
            continue
        return q


def idct(coefs: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(bh, bw, 64) int16 coefficients and 64 natural-order quantisers to
    the (bh * 8, bw * 8) uint8 samples, in C++ (fd_jpeg_idct_islow)."""
    coefs = np.ascontiguousarray(coefs, np.int16)
    qt = np.ascontiguousarray(qt, np.uint16)
    bh, bw = coefs.shape[:2]
    out = np.empty((bh * 8, bw * 8), np.uint8)
    image_lib.load().fd_jpeg_idct_islow(coefs.ctypes.data, bh, bw, qt.ctypes.data,
                                        out.ctypes.data)
    return out


def _wrap16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def _dodct(x, n):
    """jidctint-avx2.asm's butterfly along the last axis of int64 x (..., 8):
    16-bit sums in0 +- in4, in7 + in3, in5 + in1, the products regrouped
    as its pmaddwd pairs, descaled by n bits and saturated to int16."""
    x = [x[..., j] for j in range(8)]
    tmp3 = x[2] * (4433 + 6270) + x[6] * 4433
    tmp2 = x[2] * 4433 + x[6] * (4433 - 15137)
    tmp0, tmp1 = _wrap16(x[0] + x[4]) * 8192, _wrap16(x[0] - x[4]) * 8192
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    z3, z4 = _wrap16(x[7] + x[3]), _wrap16(x[5] + x[1])
    z3p = z3 * (9633 - 16069) + z4 * 9633
    z4p = z3 * 9633 + z4 * (9633 - 3196)
    t0 = x[7] * (2446 - 7373) + x[1] * -7373 + z3p
    t3 = x[7] * -7373 + x[1] * (12299 - 7373) + z4p
    t1 = x[5] * (16819 - 20995) + x[3] * -20995 + z4p
    t2 = x[5] * -20995 + x[3] * (25172 - 20995) + z3p
    o = np.stack([t10 + t3, t11 + t2, t12 + t1, t13 + t0,
                  t13 - t0, t12 - t1, t11 - t2, t10 - t3], -1)
    return np.clip((o + (1 << (n - 1))) >> n, -32768, 32767)


def idct_plain(coefs: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """idct in numpy, every block at once, in the same 16-bit lane
    arithmetic (the pass-1 shortcut for blocks whose rows 1-7 are zero)."""
    bh, bw = coefs.shape[:2]
    c = coefs.astype(np.int64).reshape(bh, bw, 8, 8)
    d = _wrap16(c * _wrap16(qt.astype(np.int64)).reshape(8, 8))
    cols = np.swapaxes(_dodct(np.swapaxes(d, -1, -2), 11), -1, -2)
    zero = (c[:, :, 1:, :] == 0).all(axis=(2, 3))
    ws = np.where(zero[..., None, None], _wrap16(d[:, :, :1, :] * 4), cols)
    out = (np.clip(_dodct(ws, 18), -128, 127) + 128).astype(np.uint8)
    return out.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)


def upsample_method(c: Component, hmax: int, vmax: int) -> tuple:
    """(method, hx, vy): jdsample.c jinit_upsampler's choice for component
    c with PIL's do_fancy_upsampling."""
    if hmax % c.h or vmax % c.v:
        raise ValueError("JPEG sampling factors that are not integral ratios are not "
                         "supported (libjpeg: fractional sampling not implemented)")
    hx, vy = hmax // c.h, vmax // c.v
    if (hx, vy) == (2, 1) and c.cw > 2:
        return H2V1, hx, vy
    if (hx, vy) == (1, 2):
        return H1V2, hx, vy
    if (hx, vy) == (2, 2) and c.cw > 2:
        return H2V2, hx, vy
    return BOX, hx, vy


def upsample(plane: np.ndarray, cw: int, ch: int, ow: int, oh: int, method: int,
             hx: int, vy: int) -> np.ndarray:
    """The (ch, cw) samples at the top left of `plane` to (oh, ow), in C++."""
    plane = np.ascontiguousarray(plane, np.uint8)
    out = np.empty((oh, ow), np.uint8)
    rc = image_lib.load().fd_jpeg_upsample(plane.ctypes.data, plane.shape[1], cw, ch,
                                           out.ctypes.data, ow, oh, hx, vy, method)
    if rc < 0:
        raise ValueError("empty JPEG component")
    return out


def upsample_plain(plane, cw, ch, ow, oh, method, hx, vy) -> np.ndarray:
    """upsample in numpy: clamped index arrays for the edges."""
    p = plane[:ch, :cw].astype(np.int32)
    y, x = np.arange(oh), np.arange(ow)
    r = np.minimum(y // vy, ch - 1)
    if method == BOX:
        return p[r][:, np.minimum(x // hx, cw - 1)].astype(np.uint8)
    c = np.minimum(x // 2 if method != H1V2 else x, cw - 1)
    odd_x, odd_y = (x & 1).astype(bool), (y & 1).astype(bool)
    if method == H2V1:
        cn = np.clip(np.where(odd_x, c + 1, c - 1), 0, cw - 1)
        rows = p[r]
        return ((rows[:, c] * 3 + rows[:, cn] + np.where(odd_x, 2, 1)) >> 2).astype(np.uint8)
    rn = np.clip(np.where(odd_y, r + 1, r - 1), 0, ch - 1)
    colsum = p[r] * 3 + p[rn]
    if method == H1V2:
        return ((colsum[:, c] + np.where(odd_y, 2, 1)[:, None]) >> 2).astype(np.uint8)
    cn = np.clip(np.where(odd_x, c + 1, c - 1), 0, cw - 1)
    return ((colsum[:, c] * 3 + colsum[:, cn] + np.where(odd_x, 7, 8)) >> 4).astype(np.uint8)


def color(y, cb, cr, kind: int) -> np.ndarray:
    """Three full-size planes to (H, W, 3) uint8, in C++ (fd_jpeg_color)."""
    y, cb, cr = (np.ascontiguousarray(a, np.uint8) for a in (y, cb, cr))
    out = np.empty(y.shape + (3,), np.uint8)
    image_lib.load().fd_jpeg_color(y.ctypes.data, cb.ctypes.data, cr.ctypes.data, y.size,
                                   out.ctypes.data, kind)
    return out


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


_X = np.arange(256, dtype=np.int64) - 128
CR_R = (_fix(1.40200) * _X + 32768) >> 16
CB_B = (_fix(1.77200) * _X + 32768) >> 16
CR_G = -_fix(0.71414) * _X
CB_G = -_fix(0.34414) * _X + 32768


def color_plain(y, cb, cr, kind: int) -> np.ndarray:
    """color in numpy, jdcolor.c's tables."""
    yy = y.astype(np.int64)
    rgb = np.stack([yy + CR_R[cr], yy + ((CB_G[cb] + CR_G[cr]) >> 16), yy + CB_B[cb]], -1)
    if kind == YCC_INVERTED:
        rgb = 255 - rgb
    return np.clip(rgb, 0, 255).astype(np.uint8)


def color_space(frame: Frame) -> str:
    """libjpeg's jpeg_color_space (jdapimin.c default_decompress_parms)."""
    n = len(frame.components)
    if n == 1:
        return "L"
    if n == 3:
        if frame.jfif:
            return "YCbCr"
        if frame.adobe is not None:
            return "RGB" if frame.adobe == 0 else "YCbCr"
        ids = tuple(c.id for c in frame.components)
        return "RGB" if ids == (82, 71, 66) else "YCbCr"
    if n == 4:
        if frame.adobe is not None:
            return "CMYK" if frame.adobe == 0 else "YCCK"
        return "CMYK"
    raise ValueError(f"a JPEG of {n} components has no pixel format (PIL reads 1, 3 or 4)")


def cmyk_to_rgba(cmyk: np.ndarray) -> np.ndarray:
    """libjpeg's CMYK samples as PIL reads them ("CMYK;I": inverted) and
    converts them to RGBA (Convert.c cmyk2rgb)."""
    inv = 255 - cmyk.astype(np.int32)
    nk = 255 - inv[..., 3:]
    t = inv[..., :3] * nk + 128
    rgb = np.clip(nk - (((t >> 8) + t) >> 8), 0, 255)
    out = np.full(cmyk.shape[:2] + (4,), 255, np.uint8)
    out[..., :3] = rgb
    return out


def _full_planes(frame: Frame, plain: bool) -> list:
    """Each component's samples, dequantised, transformed and upsampled to
    the frame's full (H, W) grid."""
    planes = []
    for c in frame.components:
        samples = (idct_plain if plain else idct)(c.coefs, c.qt)
        method, hx, vy = upsample_method(c, frame.hmax, frame.vmax)
        planes.append((upsample_plain if plain else upsample)(
            samples, c.cw, c.ch, frame.width, frame.height, method, hx, vy))
    return planes


def decode_abbreviated(stream: bytes, tables: bytes, ycbcr: bool, sampling: tuple,
                       plain: bool = False) -> np.ndarray:
    """A JPEG stream as a TIFF strip or tile holds it: its tables may come
    apart (JPEGTables, spliced in after the stream's SOI), and its colour
    space is the container's, not its markers'. (H, W, n) uint8 samples:
    YCbCr converted to RGB when ycbcr (libjpeg's JCS_YCbCr to JCS_RGB),
    else each component as coded (JCS_UNKNOWN). As libtiff checks, the
    first component's sampling factors must be `sampling` and the others'
    1, 1 (ValueError otherwise)."""
    if tables:
        if tables[:2] != b"\xff\xd8" or tables[-2:] != b"\xff\xd9":
            raise ValueError("malformed JPEG tables: no SOI or EOI marker")
        stream = tables[:-2] + stream[2:]
    frame = read_frame(stream, plain)
    factors = [(c.h, c.v) for c in frame.components]
    if factors[0] != tuple(sampling) or any(f != (1, 1) for f in factors[1:]):
        raise ValueError(f"JPEG sampling factors {factors} where the container names "
                         f"{tuple(sampling)} for the first component and 1, 1 for the others")
    planes = _full_planes(frame, plain)
    if ycbcr:
        if len(planes) != 3:
            raise ValueError(f"a YCbCr JPEG stream of {len(planes)} components")
        return (color_plain if plain else color)(*planes, YCC_RGB)
    return np.stack(planes, -1)


def decode_jpeg(data: bytes, plain: bool = False) -> np.ndarray:
    """A JPEG byte string to (H, W, 4) uint8 RGBA, as PIL's
    `Image.open(...).convert("RGBA")`. plain=True runs every stage's plain
    twin instead of the C++ helper (the tests' reference)."""
    frame = read_frame(data, plain)
    space = color_space(frame)
    w, h = frame.width, frame.height
    planes = _full_planes(frame, plain)
    out = np.full((h, w, 4), 255, np.uint8)
    if space == "L":
        out[..., :3] = planes[0][..., None]
        return out
    if space == "RGB":
        out[..., :3] = np.stack(planes, -1)
        return out
    conv = color_plain if plain else color
    if space == "YCbCr":
        out[..., :3] = conv(*planes, YCC_RGB)
        return out
    if space == "YCCK":
        cmy = conv(*planes[:3], YCC_INVERTED)
        return cmyk_to_rgba(np.concatenate([cmy, planes[3][..., None]], -1))
    return cmyk_to_rgba(np.stack(planes, -1))
