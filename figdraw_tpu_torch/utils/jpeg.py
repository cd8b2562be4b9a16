"""The port's JPEG decoder: a JPEG byte string to (H, W, 4) uint8 RGBA, as
PIL 12.1.0's `Image.open(path).convert("RGBA")` returns it through
libjpeg-turbo 3.1.3 (figdraw_tpu decodes through PIL; the port may not
import it). The markers are read here with struct; the entropy decoding,
the IDCT, the upsampling and the colour conversion run in C++
(csrc/image_decode.cpp, utils.image_lib), each beside its plain Python or
numpy twin in this module (`scan_plain`, `smooth_plain`, `idct_plain`,
`upsample_plain`, `color_plain`), the tests' reference.

Read: SOI, APPn (APP0's JFIF and APP14's Adobe transform flag), DQT (8-
and 16-bit tables), SOF0/SOF1 (baseline and extended Huffman, 8-bit),
SOF2 (progressive Huffman), SOF9 and SOF10 (sequential and progressive
arithmetic coding), SOF3 (lossless, Huffman-coded differences), DHT, DAC
(the arithmetic conditioning: DC L and U, AC Kx; libjpeg's defaults 0, 1
and 5 until a DAC sets them), DRI with RST0-7, SOS, EOI, COM; any number
of components (1, 3 or 4 decode to pixels) with any integral sampling
factors. Scans: sequential Huffman, interleaved or not, and progressive
(DC first and refine, AC first and refine, EOB runs, successive
approximation), read as jdhuff.c and jdphuff.c read them from the bytes
PIL hands libjpeg (`scan_plain`, fd_jpeg_scan: 57-bit fills, the fast
path while 512 bytes a block remain, a bad code as 0, zeros after a
marker; so a one-scan file without its EOI decodes exactly when PIL's
does, Annex K's tables standing in for a sequential file's missing
ones); the same processes arithmetic-coded (jdarith.c:
`arith_scan_plain`, fd_jpeg_arith_scan); lossless scans with predictors 1-7
and a point transform (jdlhuff.c, jddiffct.c, jdlossls.c:
`lossless_scan_plain`, fd_jpeg_lossless_scan). A restart marker out of
sequence is resynchronised as jpeg_resync_to_restart does. Arithmetic lossless (SOF11), hierarchical
(SOF5-7, SOF13-15) and 12-bit samples raise NotImplementedError (PIL
12.1.0 reads none of them); a malformed file raises ValueError.

The pixel pipeline is libjpeg-turbo's integer arithmetic with PIL's
settings (JDCT_ISLOW, do_fancy_upsampling, do_block_smoothing). Block
smoothing runs only on a progressive file whose scans leave one of the
first nine AC coefficients unrefined in some component (a scan lost,
cut short or changed): its still-zero low coefficients are estimated
from the 5x5 DC neighbourhood before the IDCT (jdcoefct.c's
decompress_smooth_data; `smoothing_latch`, `smooth`, `smooth_plain`). A
complete file refines every coefficient to Al 0, so it is never
smoothed and takes the same path as a sequential one. A lossless frame skips
the IDCT: its samples are upsampled by replication (libjpeg's fancy
upsamplers need a DCT scaling above 1) and keep their colour space, so
one that asks for a colour conversion (YCbCr, YCCK) raises ValueError as
libjpeg refuses it ("Unsupported color conversion request"). A DCT frame:
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

SEQUENTIAL, PROGRESSIVE, LOSSLESS = 0, 1, 2
# upsampling methods (fd_jpeg_upsample)
BOX, H2V1, H2V2, H1V2 = 0, 1, 2, 3
# colour conversions (fd_jpeg_color)
YCC_RGB, YCC_INVERTED = 0, 1

# SOF marker -> (kind, arithmetic-coded)
_SOF_KIND = {0xC0: (SEQUENTIAL, False), 0xC1: (SEQUENTIAL, False),
             0xC2: (PROGRESSIVE, False), 0xC3: (LOSSLESS, False),
             0xC9: (SEQUENTIAL, True), 0xCA: (PROGRESSIVE, True)}
_SOF_OTHER = {0xC5: "hierarchical (SOF5)",
              0xC6: "hierarchical (SOF6)", 0xC7: "hierarchical lossless (SOF7)",
              0xCB: "arithmetic-coded lossless (SOF11)",
              0xCD: "hierarchical arithmetic-coded (SOF13)",
              0xCE: "hierarchical arithmetic-coded (SOF14)",
              0xCF: "hierarchical arithmetic-coded lossless (SOF15)"}

# jaricom.c's jpeg_aritab: (Qe << 16) | (Next_Index_MPS << 8) |
# (Switch_MPS << 7) | Next_Index_LPS for the 113 states of Table D.2, and
# state 113, the fixed bin's non-adapting 0x5a1d
QE_TABLE = np.array([
    0x5A1D0181, 0x2586020E, 0x11140310, 0x080B0412, 0x03D80514, 0x01DA0617,
    0x00E50719, 0x006F081C, 0x0036091E, 0x001A0A21, 0x000D0B23, 0x00060C09,
    0x00030D0A, 0x00010D0C, 0x5A7F0F8F, 0x3F251024, 0x2CF21126, 0x207C1227,
    0x17B91328, 0x1182142A, 0x0CEF152B, 0x09A1162D, 0x072F172E, 0x055C1830,
    0x04061931, 0x03031A33, 0x02401B34, 0x01B11C36, 0x01441D38, 0x00F51E39,
    0x00B71F3B, 0x008A203C, 0x0068213E, 0x004E223F, 0x003B2320, 0x002C0921,
    0x5AE125A5, 0x484C2640, 0x3A0D2741, 0x2EF12843, 0x261F2944, 0x1F332A45,
    0x19A82B46, 0x15182C48, 0x11772D49, 0x0E742E4A, 0x0BFB2F4B, 0x09F8304D,
    0x0861314E, 0x0706324F, 0x05CD3330, 0x04DE3432, 0x040F3532, 0x03633633,
    0x02D43734, 0x025C3835, 0x01F83936, 0x01A43A37, 0x01603B38, 0x01253C39,
    0x00F63D3A, 0x00CB3E3B, 0x00AB3F3D, 0x008F203D, 0x5B1241C1, 0x4D044250,
    0x412C4351, 0x37D84452, 0x2FE84553, 0x293C4654, 0x23794756, 0x1EDF4857,
    0x1AA94957, 0x174E4A48, 0x14244B48, 0x119C4C4A, 0x0F6B4D4A, 0x0D514E4B,
    0x0BB64F4D, 0x0A40304D, 0x583251D0, 0x4D1C5258, 0x438E5359, 0x3BDD545A,
    0x34EE555B, 0x2EAE565C, 0x299A575D, 0x25164756, 0x557059D8, 0x4CA95A5F,
    0x44D95B60, 0x3E225C61, 0x38245D63, 0x32B45E63, 0x2E17565D, 0x56A860DF,
    0x4F466165, 0x47E56266, 0x41CF6367, 0x3C3D6468, 0x375E5D63, 0x52316669,
    0x4C0F676A, 0x4639686B, 0x415E6367, 0x56276AE9, 0x50E76B6C, 0x4B85676D,
    0x55976D6E, 0x504F6B6F, 0x5A106FEE, 0x55226D70, 0x59EB6FF0, 0x5A1D7171],
    np.int64)
DC_STAT_BINS, AC_STAT_BINS = 64, 256
# Annex K.3's tables (jstdhuff.c), which libjpeg's sequential Huffman
# decoder takes for DC and AC tables 0 and 1 a file leaves undefined (a
# progressive or lossless one does not): (class, id) -> counts and symbols
STD_HUFFMAN = {key: bytes.fromhex(h) for key, h in {
    (0, 0): "00010501010101010100000000000000000102030405060708090a0b",
    (0, 1): "00030101010101010101010000000000000102030405060708090a0b",
    (1, 0): "0002010303020403050504040000017d01020300041105122131410613516107227114328191a1"
            "082342b1c11552d1f02433627282090a161718191a25262728292a3435363738393a4344454647"
            "48494a535455565758595a636465666768696a737475767778797a838485868788898a92939495"
            "969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8"
            "d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa",
    (1, 1): "00020102040403040705040400010277000102031104052131061241510761711322328108144291"
            "a1b1c109233352f0156272d10a162434e125f11718191a262728292a35363738393a4344454647"
            "48494a535455565758595a636465666768696a737475767778797a82838485868788898a929394"
            "95969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7"
            "d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"}.items()}
MAX_BLOCKS_IN_MCU = 10  # D_MAX_BLOCKS_IN_MCU
# the DAC defaults (jdmarker.c get_soi): DC L and U, AC Kx, for each of 16 tables
DAC_DEFAULT = np.array([0] * 16 + [1] * 16 + [5] * 16, np.uint8)


class Component:
    """One frame component: its sampling factors, quantisation table
    (latched at its first scan, as libjpeg does), its sample extent and
    its MCU-padded coefficient array."""

    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None  # 64 uint16 quantisers, natural order

    def place(self, w, hgt, hmax, vmax, mcux, mcuy, lossless=False):
        self.cw = -(-w * self.h // hmax)  # downsampled_width
        self.ch = -(-hgt * self.v // vmax)
        self.scanned = False
        # libjpeg's coef_bits for a progressive frame, in zigzag order: the
        # Al of each coefficient's last scan (-1 before any), and the values
        # before the component's latest scan (its prev_coef_bits)
        self.coef_bits = np.full(64, -1, np.int32)
        self.prev_bits = np.zeros(64, np.int32)
        if lossless:
            # a lossless frame's data unit is one sample: its samples, (ch, cw)
            self.samples = np.zeros((self.ch, self.cw), np.uint8)
            return
        self.nbw, self.nbh = -(-self.cw // 8), -(-self.ch // 8)
        self.bw, self.bh = mcux * self.h, mcuy * self.v
        self.coefs = np.zeros((self.bh, self.bw, 64), np.int16)


class Frame:
    """The markers of a JPEG file read and its scans decoded into the
    components' coefficients."""

    def __init__(self):
        self.kind = None
        self.arith = False
        self.width = self.height = 0
        self.components = []
        self.jfif = False
        self.adobe = None  # APP14's transform flag
        self.restart = 0
        self.cond = DAC_DEFAULT.copy()  # DC L[16], DC U[16], AC Kx[16]
        self.multi = None  # more than one scan (set at the first)
        self.scans = 0  # scans started (libjpeg's input_scan_number)
        # the last iMCU row begun with data left in the last scan that ran
        # short (jdcoefct.c's last_good_iMCU_row); None: every row
        self.last_good = None


class _Truncated(ValueError):
    """The data ended inside a marker segment (libjpeg suspends there)."""


# markers libjpeg's read_markers takes: those with a segment, and those
# without one (RSTn and TEM are ignored between scans); any other code
# (DHP, EXP, JPGn, RESn, JPG) is a fatal error (JERR_UNKNOWN_MARKER)
_SEGMENT_MARKERS = (set(_SOF_KIND) | set(_SOF_OTHER) | {0xC4, 0xCC, 0xDA, 0xDB, 0xDC, 0xDD, 0xFE}
                    | set(range(0xE0, 0xF0)))


def _segment(data: bytes, pos: int, code: int):
    """The segment of the marker at `pos` and the position after it. An
    APPn, COM or DNL segment whose length is below 2 ends after its length
    field (libjpeg's skip_variable and get_interesting_appn read no data
    then)."""
    if pos + 4 > len(data):
        raise _Truncated("truncated JPEG file: a marker segment runs past the end")
    (n,) = struct.unpack_from(">H", data, pos + 2)
    if n < 2 and (0xE0 <= code <= 0xEF or code in (0xFE, 0xDC)):
        return b"", pos + 4
    if n < 2:
        raise ValueError("malformed JPEG marker segment: a length below 2")
    if pos + 2 + n > len(data):
        raise _Truncated("truncated JPEG file: a marker segment runs past the end")
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


def _read_dac(seg: bytes, cond: np.ndarray) -> None:
    """jdmarker.c get_dac: (index, value) pairs; index 0-15 sets DC table
    index's L (low nibble) and U (high nibble), 16-31 sets AC table
    index - 16's Kx."""
    if len(seg) % 2:
        raise ValueError("malformed JPEG DAC segment")
    for i in range(0, len(seg), 2):
        index, val = seg[i], seg[i + 1]
        if index >= 32:
            raise ValueError("malformed JPEG DAC segment: a table index past 31")
        if index >= 16:
            cond[32 + index - 16] = val
        else:
            if (val & 15) > (val >> 4):
                raise ValueError("malformed JPEG DAC segment: DC L above U")
            cond[index], cond[16 + index] = val & 15, val >> 4


def _read_sof(seg: bytes, frame: Frame, kind: int) -> None:
    if len(seg) < 6:
        raise ValueError("malformed JPEG SOF segment")
    p, hgt, w, nc = struct.unpack_from(">BHHB", seg)
    if p != 8:
        raise NotImplementedError(UNSUPPORTED.format(f"a {p}-bit JPEG"))
    if hgt == 0:
        raise ValueError("JPEG with no height in its SOF (a DNL marker) is not supported")
    if w == 0 or nc == 0 or len(seg) != 6 + 3 * nc:
        raise ValueError("malformed JPEG SOF segment")
    frame.kind, frame.width, frame.height = kind, w, hgt
    for k in range(nc):
        cid, hv, tq = seg[6 + 3 * k: 9 + 3 * k]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4):
            raise ValueError("malformed JPEG SOF segment")
        frame.components.append(Component(cid, h, v, tq))
    hmax = max(c.h for c in frame.components)
    vmax = max(c.v for c in frame.components)
    frame.hmax, frame.vmax = hmax, vmax
    unit = 1 if kind == LOSSLESS else 8
    frame.mcux, frame.mcuy = -(-w // (unit * hmax)), -(-hgt // (unit * vmax))
    for c in frame.components:
        c.place(w, hgt, hmax, vmax, frame.mcux, frame.mcuy, kind == LOSSLESS)


def _scan_component(frame: Frame, cid: int, k: int, earlier) -> Component:
    """jdmarker.c get_sos's search for the k-th scan component: the first of
    the frame's first four components with id cid whose index is not a scan
    slot already filled (libjpeg tests cur_comp_info[ci], so a scan lists
    its components in frame order), and not one the scan named before."""
    for ci in range(k, min(len(frame.components), 4)):
        c = frame.components[ci]
        if c.id == cid and not any(c is e for e in earlier):
            return c
        if c.id == cid:
            break
    raise ValueError("JPEG scan names a component the frame does not have, names one "
                     "twice, or names them out of frame order")


def _scan_args(seg: bytes, frame: Frame, qtables: dict, htables: dict):
    """The SOS header: the scan's components (their quantisation tables
    latched), the int32 rows and table specs its scan function takes, and
    Ss, Se, Ah, Al. Rows: Huffman DCT scans H, V, blocks_w, blocks across,
    blocks down (tables: each component's DC then AC Huffman spec);
    arithmetic scans the same and the DC and AC table numbers (no tables:
    the statistics start empty); lossless scans H, V, samples across,
    samples down (tables: each component's DC Huffman spec)."""
    if frame.kind is None:
        raise ValueError("JPEG SOS before a frame header")
    ns = seg[0] if seg else 0
    if not 1 <= ns <= 4 or len(seg) != 4 + 2 * ns:
        raise ValueError("malformed JPEG SOS segment")
    lossless = frame.kind == LOSSLESS
    width = 4 if lossless else 7 if frame.arith else 5
    comps, rows = [], np.zeros((ns, width), np.int32)
    tabs = np.zeros((ns, 272 if lossless else 544), np.uint8)
    ss, se, a = seg[1 + 2 * ns: 4 + 2 * ns]
    ah, al = a >> 4, a & 15
    for k in range(ns):
        cid, t = seg[1 + 2 * k: 3 + 2 * k]
        c = _scan_component(frame, cid, k, comps)
        c.scanned = True
        comps.append(c)
        if lossless:
            rows[k] = (c.h, c.v, c.cw, c.ch)
            if (0, t >> 4) not in htables:
                raise ValueError("JPEG scan uses an undefined Huffman table")
            tabs[k] = htables[(0, t >> 4)]
            check_huffman(tabs[k], True, 16)
            continue
        if c.qt is None:
            if c.tq not in qtables:
                raise ValueError("JPEG component without a quantisation table")
            c.qt = qtables[c.tq].copy()
        if frame.arith:
            rows[k] = (c.h, c.v, c.bw, c.nbw, c.nbh, t >> 4, t & 15)
            continue
        rows[k] = (c.h, c.v, c.bw, c.nbw, c.nbh)
        # a sequential scan builds both tables whatever its Ss (libjpeg
        # only warns of one that is not 0)
        dc_needed = frame.kind == SEQUENTIAL or (ss == 0 and ah == 0)
        ac_needed = frame.kind == SEQUENTIAL or ss > 0
        for slot, key, needed in ((0, (0, t >> 4), dc_needed), (272, (1, t & 15), ac_needed)):
            if needed:
                if key not in htables and frame.kind == SEQUENTIAL and key in STD_HUFFMAN:
                    htables[key] = np.frombuffer(STD_HUFFMAN[key].ljust(272, b"\0"), np.uint8)
                if key not in htables:
                    raise ValueError("JPEG scan uses an undefined Huffman table")
                tabs[k, slot: slot + 272] = htables[key]
                check_huffman(htables[key], slot == 0)
    if lossless:
        # jdlossls.c start_pass_lossless: Ss is the predictor, Al the point transform
        if not 1 <= ss <= 7 or se != 0 or ah != 0 or al >= 8:
            raise ValueError("malformed JPEG lossless scan parameters")
    elif frame.kind == SEQUENTIAL:
        ss, se, ah, al = 0, 63, 0, 0
    elif (ss == 0) != (se == 0) or se > 63 or ss > se or (ss > 0 and ns != 1) or al > 13:
        raise ValueError("malformed JPEG progressive scan parameters")
    elif ah != 0 and ah - 1 != al:
        raise ValueError("malformed JPEG progressive scan parameters")
    if ns > 1 and sum(c.h * c.v for c in comps) > MAX_BLOCKS_IN_MCU:
        raise ValueError("JPEG scan with more than 10 blocks in its MCU (libjpeg: "
                         "sampling factors too large for an interleaved scan)")
    return comps, rows, tabs, (ss, se, ah, al)


def _cut_segment_errors(code: int, data: bytes, pos: int, frame: Frame) -> None:
    """libjpeg reads a marker segment byte by byte, so in one that the end
    of the file cuts short it meets some errors before it runs out (after a
    file's only scan PIL keeps the image when it runs out first): get_dri's
    length, get_dqt's table numbers and length, get_dht's counts, table
    numbers and length, get_dac's indices and values, get_sos's length and
    components. Raises ValueError for those; returns when the bytes run out
    first."""
    if pos + 4 > len(data):
        return
    (n,) = struct.unpack_from(">H", data, pos + 2)
    body, left, i = data[pos + 4:], n - 2, 0
    bad = ValueError(f"malformed JPEG marker segment 0xFF{code:02X} (cut short by the end "
                     "of the file)")
    if code == 0xDD and n != 4:
        raise bad
    if code == 0xDB:
        while left > 0:
            if i >= len(body):
                return
            size = 1 + 64 * (2 if body[i] >> 4 else 1)
            if body[i] >> 4 > 1 or body[i] & 15 > 3:
                raise bad
            if i + size > len(body):
                return
            i, left = i + size, left - size
        raise bad
    if code == 0xC4:
        while left > 16:
            if i + 17 > len(body):
                return
            count, left = sum(body[i + 1: i + 17]), left - 17
            if count > 256 or count > left:
                raise bad
            if i + 17 + count > len(body):
                return
            if body[i] & 0xEF > 3:
                raise bad
            i, left = i + 17 + count, left - count
        raise bad
    if code == 0xCC:
        while left > 0:
            if i + 2 > len(body):
                return
            index, val = body[i], body[i + 1]
            if index >= 32 or (index < 16 and (val & 15) > (val >> 4)):
                raise bad
            i, left = i + 2, left - 2
        raise bad
    if code == 0xDA and body:
        ns = body[0]
        if n != 6 + 2 * ns or not 1 <= ns <= 4:
            raise bad
        named = []
        for k in range(min(ns, (len(body) - 1) // 2)):
            named.append(_scan_component(frame, body[1 + 2 * k], k, named))


def _track_progression(frame: Frame, comps, params) -> None:
    """start_pass_phuff_decoder's (and jdarith.c's) progression status:
    each scan component's prev_coef_bits for coefficients min(Ss, 1) to
    max(Se, 9) takes its coef_bits (0 in the file's first scan), then Ss to
    Se take Al."""
    ss, se, _ah, al = params
    for c in comps:
        lo, hi = min(ss, 1), max(se, 9)
        c.prev_bits[lo: hi + 1] = c.coef_bits[lo: hi + 1] if frame.scans > 1 else 0
        c.coef_bits[ss: se + 1] = al


def read_frame(data: bytes, plain: bool = False) -> Frame:
    """Read the markers of `data` and decode each scan into the components'
    coefficients (fd_jpeg_scan, fd_jpeg_arith_scan, fd_jpeg_lossless_scan,
    or their plain twins when plain).

    As PIL drives libjpeg: a file of several scans (progressive, or
    components in scans of their own) is read to its EOI before any row
    comes out, so one that ends first is truncated; a file of one scan has
    every row once that scan is decoded, and what follows is read only for
    its errors (data that runs out there is not one; a second SOS is)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file: no SOI marker")
    frame, qtables, htables = Frame(), {}, {}
    pos, seen_eoi, single_done = 2, False, False
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
        if code == 0x00 or 0xD0 <= code <= 0xD7 or code == 0x01:
            pos += 2
            continue
        if code == 0xD8:
            raise ValueError("JPEG file with a second SOI marker")
        if code not in _SEGMENT_MARKERS:
            raise ValueError(f"JPEG file with an unknown marker 0xFF{code:02X}")
        # the checks libjpeg makes before it reads a segment's length
        if code in _SOF_KIND or code in _SOF_OTHER:
            if frame.kind is not None:
                raise ValueError("JPEG file with two frame headers")
            if code in _SOF_OTHER:
                raise NotImplementedError(UNSUPPORTED.format(f"a {_SOF_OTHER[code]} JPEG"))
        if code == 0xDA and frame.kind is None:
            raise ValueError("JPEG SOS before a frame header")
        try:
            seg, nxt = _segment(data, pos, code)
        except _Truncated:
            if single_done:
                _cut_segment_errors(code, data, pos, frame)
                break
            raise
        if code in _SOF_KIND:
            kind, frame.arith = _SOF_KIND[code]
            _read_sof(seg, frame, kind)
        elif code == 0xC4:
            _read_dht(seg, htables)
        elif code == 0xCC:
            _read_dac(seg, frame.cond)
        elif code == 0xDB:
            _read_dqt(seg, qtables)
        elif code == 0xDD:
            if len(seg) != 2:
                raise ValueError("malformed JPEG DRI segment")
            (frame.restart,) = struct.unpack_from(">H", seg)
        elif code == 0xE0:
            frame.jfif = frame.jfif or (len(seg) >= 14 and seg[:5] == b"JFIF\x00")
        elif code == 0xEE:
            if len(seg) >= 12 and seg[:5] == b"Adobe":
                frame.adobe = seg[11]
        elif code == 0xDA:
            if single_done:
                raise ValueError("JPEG file with a scan after its only one (EOI expected)")
            comps, rows, tabs, params = _scan_args(seg, frame, qtables, htables)
            frame.scans += 1
            if frame.kind == PROGRESSIVE:
                _track_progression(frame, comps, params)
            if frame.multi is None:  # jdinput.c's has_multiple_scans, at the first scan
                frame.multi = frame.kind == PROGRESSIVE or len(comps) < len(frame.components)
            if frame.kind == LOSSLESS:
                scan = lossless_scan_plain if plain else lossless_scan_native
            elif frame.arith:
                scan = arith_scan_plain if plain else arith_scan_native
            else:
                scan = scan_plain if plain else scan_native
            nxt = scan(data, nxt, frame, comps, rows, tabs, params)
            single_done = not frame.multi
        pos = nxt
    if frame.kind is None:
        raise ValueError("JPEG file without a frame header")
    if not seen_eoi and not single_done:
        raise ValueError("truncated JPEG file: no EOI marker")
    for c in frame.components:
        if not c.scanned:
            raise ValueError("JPEG component that no scan carries")
    return frame


def scan_native(data, pos, frame, comps, rows, tabs, params) -> int:
    """One Huffman scan's entropy-coded data from `pos` into the components'
    coefficients, in C++ (fd_jpeg_scan), as libjpeg decodes it from the
    reads PIL hands over (an MCU read past them is read again with the
    next; past the file's end the file is truncated); returns the position
    of the marker after it, or the end of the data. Sets frame.last_good,
    the iMCU row of the scan's last MCU begun with data left (jdcoefct.c's
    last_good_iMCU_row)."""
    ss, se, ah, al = params
    buf = np.frombuffer(data, np.uint8)
    ptrs = (ctypes.c_void_p * len(comps))(*[c.coefs.ctypes.data for c in comps])
    last_good = np.zeros(1, np.int32)
    end = image_lib.load().fd_jpeg_scan(
        buf.ctypes.data, len(data), pos, len(comps), rows.ctypes.data, tabs.ctypes.data,
        ptrs, frame.mcux, frame.mcuy, frame.restart, ss, se, ah, al, frame.kind,
        last_good.ctypes.data)
    if end < 0:
        raise ValueError("truncated JPEG file: a scan runs past the end" if end == -6
                         else f"corrupt JPEG scan data (code {end})")
    frame.last_good = int(last_good[0])
    return int(end)


class _PlainHuff:
    """A Huffman table as jdhuff.c's jpeg_make_d_derived_tbl derives it:
    the 8-bit lookahead (HUFF_LOOKAHEAD: the length and symbol of each code
    of at most 8 bits, length 9 for any other byte) and maxcode /
    valoffset for longer codes (maxcode[17] the sentinel)."""

    def __init__(self, spec):
        self.maxcode, self.valoffset = [-1] * 18, [0] * 18
        self.vals = [int(v) for v in spec[16:]]
        self.look = [(9, 0)] * 256
        code, k = 0, 0
        for length in range(1, 17):
            count = int(spec[length - 1])
            if count:
                self.valoffset[length] = k - code
                self.maxcode[length] = code + count - 1
            for _ in range(count):
                if length <= 8:
                    base = code << (8 - length)
                    self.look[base: base + (1 << (8 - length))] = \
                        [(length, self.vals[k])] * (1 << (8 - length))
                code += 1
                k += 1
            code <<= 1
        self.maxcode[17] = 0xFFFFF

    def value(self, length: int, code: int) -> int:
        return self.vals[(code + self.valoffset[length]) & 0xFF]


def check_huffman(spec, dc: bool, top: int = 15) -> None:
    """jpeg_make_d_derived_tbl's checks: the counts fit in 256 symbols and
    make a code tree with no length overfull (and no code all ones); a DC
    table's symbols are categories 0 to `top` (15, or 16 for a lossless
    frame). ValueError otherwise, as libjpeg's JERR_BAD_HUFF_TABLE."""
    code, total = 0, 0
    for length in range(1, 17):
        total += int(spec[length - 1])
        code += int(spec[length - 1])
        if total > 256 or (int(spec[length - 1]) and code >= 1 << length):
            raise ValueError("malformed JPEG DHT segment: a bad Huffman table")
        code <<= 1
    if dc and (np.asarray(spec[16: 16 + total]) > top).any():
        raise ValueError("malformed JPEG DHT segment: a DC category past "
                         f"{top}")


def _extend(v, s):
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _int16(v):
    return ((v + 0x8000) & 0xFFFF) - 0x8000


# PIL hands libjpeg a file in reads of ImageFile.MAXBLOCK bytes; jdhuff.c's
# fast path needs BUFSIZE bytes a block of the MCU in the source buffer
CHUNK, FAST_BYTES = 65536, 512


def fed_end(pos: int, n: int) -> int:
    """The end of the bytes PIL has handed libjpeg when a scan's data starts
    at `pos` of an n-byte file: the reads that held its headers."""
    return min(n, max(CHUNK, -(-pos // CHUNK) * CHUNK))


def _mcu_blocks(frame, comps, m, per_row):
    my, mx = divmod(m, per_row)
    if len(comps) == 1:
        return [(0, comps[0].coefs[my, mx])]
    return [(ci, c.coefs[my * c.v + v, mx * c.h + h])
            for ci, c in enumerate(comps) for v in range(c.v) for h in range(c.h)]


def _sequential_mcu(b, blocks, dc, ac, pred, fast: bool) -> None:
    """decode_mcu_slow, or decode_mcu_fast when fast (the same codes read
    through FILL_BIT_BUFFER_FAST), on one MCU's blocks."""
    decode, bits = (b.fast_decode, b.fast_bits) if fast else (b.decode, b.bits)
    for ci, blk in blocks:
        s = decode(dc[ci])
        pred[ci] += _extend(bits(s), s) if s else 0
        blk[0] = _int16(pred[ci])
        k = 1
        while k < 64:
            rs = decode(ac[ci])
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                blk[NATURAL[k]] = _extend(bits(s), s)
            elif r == 15:
                k += 15
            else:
                break
            k += 1


def _progressive_mcu(b, blocks, dc, ac, pred, eob, params) -> None:
    """jdphuff.c's decode_mcu_DC_first, _DC_refine, _AC_first and
    _AC_refine on one MCU's blocks; eob is the EOB run, a list of one."""
    ss, se, ah, al = params
    p1, m1 = 1 << al, -(1 << al)
    for ci, blk in blocks:
        if ss == 0:
            if ah == 0:
                s = b.decode(dc[ci])
                pred[ci] += _extend(b.bits(s), s) if s else 0
                blk[0] = _int16(pred[ci] << al)
            elif b.bits(1):
                blk[0] = _int16(int(blk[0]) | p1)
        elif ah == 0:
            if eob[0] > 0:
                eob[0] -= 1
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
                    eob[0] = (1 << r) + (b.bits(r) if r else 0) - 1
                    break
                k += 1
        else:
            k = ss
            if eob[0] == 0:
                while k <= se:
                    rs = b.decode(ac[ci])
                    r, s = rs >> 4, rs & 15
                    if s:
                        s = p1 if b.bits(1) else m1
                    elif r != 15:
                        eob[0] = (1 << r) + (b.bits(r) if r else 0)
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
            if eob[0] > 0:
                while k <= se:
                    z = NATURAL[k]
                    t = int(blk[z])
                    if t != 0 and b.bits(1) and (t & p1) == 0:
                        blk[z] = t + p1 if t >= 0 else t + m1
                    k += 1
                eob[0] -= 1


def scan_plain(data, pos, frame, comps, rows, tabs, params) -> int:
    """scan_native in Python, bit by bit (jdhuff.c decode_mcu, jdphuff.c's
    four decode_mcu_* kinds, process_restart), fed as PIL feeds libjpeg: the
    tests' reference. Sets frame.last_good (see scan_native)."""
    progressive = frame.kind == PROGRESSIVE
    dc = [_PlainHuff(t[:272]) for t in tabs]
    ac = [_PlainHuff(t[272:]) for t in tabs]
    src = _Source(data, pos)
    fast_ok = not progressive and not frame.restart
    src.avail = fed_end(pos, len(data)) if fast_ok else len(data)
    b = _HuffBits(src)
    if len(comps) == 1:
        per_row, total, v = comps[0].nbw, comps[0].nbw * comps[0].nbh, comps[0].v
    else:
        per_row, total, v = frame.mcux, frame.mcux * frame.mcuy, 1
    refine_dc = progressive and params[0] == 0 and params[2] != 0
    pred, eob = [0] * len(comps), [0]
    left, nxt = frame.restart, 0
    for m in range(total):
        if not b.short:
            frame.last_good = m // per_row // v
        if frame.restart and left == 0:
            b.acc = b.n = 0  # the buffered bits are dropped
            src.read_restart(nxt)
            nxt, left = (nxt + 1) & 7, frame.restart
            pred, eob = [0] * len(comps), [0]
            if src.unread == 0:
                b.short = False
        blocks = _mcu_blocks(frame, comps, m, per_row)
        if not b.short or refine_dc:
            while True:  # an MCU that runs past the bytes PIL has handed over is read again
                saved = (src.pos, src.unread, b.acc, b.n, b.short, pred[:], eob[0],
                         [blk.copy() for _ci, blk in blocks])
                try:
                    if progressive:
                        _progressive_mcu(b, blocks, dc, ac, pred, eob, params)
                        break
                    if (fast_ok and src.unread == 0
                            and src.avail - src.pos >= FAST_BYTES * len(blocks)):
                        b.hit_marker = False
                        _sequential_mcu(b, blocks, dc, ac, pred, True)
                        if not b.hit_marker:
                            break
                        src.pos, src.unread, b.acc, b.n = saved[:4]
                        pred[:] = saved[5]
                    _sequential_mcu(b, blocks, dc, ac, pred, False)
                    break
                except _Suspend:
                    if src.avail >= len(data):
                        raise
                    src.pos, src.unread, b.acc, b.n, b.short, pred[:], eob[0] = saved[:7]
                    for (_ci, blk), old in zip(blocks, saved[7]):
                        blk[:] = old
                    src.avail = min(len(data), src.avail + CHUNK)
        if frame.restart:
            left -= 1
    src.avail = len(data)
    return src.end()


class _Suspend(ValueError):
    """libjpeg's source ran out of bytes (a suspension): past the end of the
    file PIL reports it truncated."""


class _Source:
    """libjpeg's data source as the entropy decoders see it (jdmarker.c):
    bytes from `pos`, the marker a decoder ran into (`unread`, 0 for none),
    next_marker, and read_restart_marker with jpeg_resync_to_restart.
    Reading at `avail` (the end of the bytes handed over so far; the file's
    end unless the Huffman scan sets it) raises _Suspend, a ValueError: PIL
    reports a file cut there as truncated."""

    def __init__(self, data, pos):
        self.data, self.pos, self.unread = data, pos, 0
        self.avail = len(data)

    def byte(self):
        if self.pos >= self.avail:
            raise _Suspend("truncated JPEG file: a scan runs past the end")
        self.pos += 1
        return self.data[self.pos - 1]

    def next_marker(self):
        while True:
            c = self.byte()
            while c != 0xFF:
                c = self.byte()
            c = self.byte()
            while c == 0xFF:
                c = self.byte()
            if c != 0:
                self.unread = c
                return

    def read_restart(self, expect: int) -> None:
        if self.unread == 0:
            self.next_marker()
        if self.unread == 0xD0 + expect:
            self.unread = 0
            return
        marker = self.unread
        while True:  # jpeg_resync_to_restart
            if marker < 0xC0:
                action = 2
            elif marker < 0xD0 or marker > 0xD7:
                action = 3
            elif marker in (0xD0 + ((expect + 1) & 7), 0xD0 + ((expect + 2) & 7)):
                action = 3
            elif marker in (0xD0 + ((expect - 1) & 7), 0xD0 + ((expect - 2) & 7)):
                action = 2
            else:
                action = 1
            if action == 1:
                self.unread = 0
                return
            if action == 3:
                return
            self.next_marker()
            marker = self.unread

    def end(self) -> int:
        """The position of the marker that ends the scan (its last 0xFF), or
        the end of the data when none follows (read_frame decides whether a
        file may end there)."""
        if self.unread == 0:
            try:
                self.next_marker()
            except ValueError:
                return len(self.data)
        return self.pos - 2


class _PlainArith:
    """jdarith.c's decoder: arith_decode with the C and A registers, the
    bit counter ct (-16 to fetch two bytes first, -1 after a bad code) and
    get_byte's 0xFF00 unstuffing; a marker feeds zeros from then on."""

    def __init__(self, src: _Source):
        self.src = src
        self.reset()

    def reset(self):
        self.c = self.a = 0
        self.ct = -16

    def decode(self, st: np.ndarray, i: int) -> int:
        while self.a < 0x8000:
            self.ct -= 1
            if self.ct < 0:
                src = self.src
                if src.unread:
                    data = 0
                else:
                    data = src.byte()
                    if data == 0xFF:
                        data = src.byte()
                        while data == 0xFF:
                            data = src.byte()
                        if data == 0:
                            data = 0xFF
                        else:
                            src.unread, data = data, 0
                self.c = (self.c << 8) | data
                self.ct += 8
                if self.ct < 0:
                    self.ct += 1
                    if self.ct == 0:
                        self.a = 0x8000
            self.a <<= 1
        sv = int(st[i])
        qe = int(QE_TABLE[sv & 0x7F])
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        temp = self.a - qe
        self.a = temp
        temp <<= self.ct
        if self.c >= temp:
            self.c -= temp
            if self.a < qe:
                self.a = qe
                st[i] = (sv & 0x80) ^ nm
            else:
                self.a = qe
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif self.a < 0x8000:
            if self.a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        return sv >> 7


def _arith_magnitude(d: _PlainArith, st: np.ndarray, i: int, x_bins):
    """Figures F.23 and F.24 after the sign: the magnitude category's
    decisions from bin i (for AC a second one at i, then the X bins from
    x_bins; for DC, x_bins None, the X bins from bin 20), then its bits 14
    bins past the last. Returns (v - 1, category), or None when the
    category overflows (JWRN_ARITH_BAD_CODE)."""
    m = d.decode(st, i)
    if m:
        if x_bins is None:
            i, more = 20, True
        else:
            more = d.decode(st, i)
            if more:
                m, i = m << 1, x_bins
        if more:
            while d.decode(st, i):
                m <<= 1
                if m == 0x8000:
                    return None
                i += 1
    v, cat = m, m
    i += 14
    m >>= 1
    while m:
        if d.decode(st, i):
            v |= m
        m >>= 1
    return v, cat


class _ArithState:
    """One arithmetic scan's statistics (a 64-bin DC and a 256-bin AC area
    for each of the 16 tables, and the fixed bin) and each scan
    component's DC prediction and context."""

    def __init__(self, frame, rows, params):
        self.ss, self.se, self.ah, self.al = params
        self.progressive = frame.kind == PROGRESSIVE
        self.cond = frame.cond
        self.dc_tbl = [int(r[5]) for r in rows]
        self.ac_tbl = [int(r[6]) for r in rows]
        self.dc_stats = np.zeros((16, DC_STAT_BINS), np.uint8)
        self.ac_stats = np.zeros((16, AC_STAT_BINS), np.uint8)
        self.fixed = np.array([113], np.uint8)

    def start(self, d: _PlainArith) -> None:
        """start_pass and process_restart: the scan's statistics areas
        zeroed, its predictions and contexts 0, the coder reset."""
        for k in range(len(self.dc_tbl)):
            if not self.progressive or (self.ss == 0 and self.ah == 0):
                self.dc_stats[self.dc_tbl[k]] = 0
            if not self.progressive or self.ss:
                self.ac_stats[self.ac_tbl[k]] = 0
        n = len(self.dc_tbl)
        self.last, self.context = [0] * n, [0] * n
        d.reset()

    def dc(self, d: _PlainArith, ci: int) -> bool:
        """Decode_DC_DIFF into last[ci], its context updated; False after a
        bad code."""
        t = self.dc_tbl[ci]
        st = self.dc_stats[t]
        s0 = self.context[ci]
        if d.decode(st, s0) == 0:
            self.context[ci] = 0
            return True
        sign = d.decode(st, s0 + 1)
        got = _arith_magnitude(d, st, s0 + 2 + sign, None)
        if got is None:
            return False
        v, m = got
        if m < (1 << int(self.cond[t])) >> 1:
            self.context[ci] = 0
        elif m > (1 << int(self.cond[16 + t])) >> 1:
            self.context[ci] = 12 + sign * 4
        else:
            self.context[ci] = 4 + sign * 4
        v += 1
        self.last[ci] = (self.last[ci] + (-v if sign else v)) & 0xFFFF
        return True

    def ac(self, d: _PlainArith, ci: int, blk, lo: int, hi: int, al: int) -> bool:
        """Decode_AC_coefficients lo..hi into blk, scaled by al; False after
        a bad code."""
        t = self.ac_tbl[ci]
        st = self.ac_stats[t]
        kx = int(self.cond[32 + t])
        k = lo
        while k <= hi:
            i = 3 * (k - 1)
            if d.decode(st, i):
                break
            while d.decode(st, i + 1) == 0:
                i += 3
                k += 1
                if k > hi:
                    return False
            sign = d.decode(self.fixed, 0)
            got = _arith_magnitude(d, st, i + 2, 189 if k <= kx else 217)
            if got is None:
                return False
            v = got[0] + 1
            blk[NATURAL[k]] = _int16((-v if sign else v) << al)
            k += 1
        return True

    def ac_refine(self, d: _PlainArith, ci: int, blk) -> bool:
        """decode_mcu_AC_refine on one block; False after a bad code."""
        st = self.ac_stats[self.ac_tbl[ci]]
        ss, se = self.ss, self.se
        p1, m1 = 1 << self.al, -(1 << self.al)
        kex = se
        while kex > 0 and not blk[NATURAL[kex]]:
            kex -= 1
        k = ss
        while k <= se:
            i = 3 * (k - 1)
            if k > kex and d.decode(st, i):
                break
            while True:
                z = NATURAL[k]
                t = int(blk[z])
                if t:
                    if d.decode(st, i + 2):
                        blk[z] = _int16(t + (m1 if t < 0 else p1))
                    break
                if d.decode(st, i + 1):
                    blk[z] = m1 if d.decode(self.fixed, 0) else p1
                    break
                i += 3
                k += 1
                if k > se:
                    return False
            k += 1
        return True

    def block(self, d: _PlainArith, ci: int, blk) -> bool:
        """One block of the scan's kind; False after a bad code."""
        if not self.progressive:
            if not self.dc(d, ci):
                return False
            blk[0] = _int16(self.last[ci])
            return self.ac(d, ci, blk, 1, 63, 0)
        if self.ss == 0:
            if self.ah:
                if d.decode(self.fixed, 0):
                    blk[0] = _int16(int(blk[0]) | (1 << self.al))
                return True
            if not self.dc(d, ci):
                return False
            blk[0] = _int16(self.last[ci] << self.al)
            return True
        if self.ah:
            return self.ac_refine(d, ci, blk)
        return self.ac(d, ci, blk, self.ss, self.se, self.al)


def arith_scan_plain(data, pos, frame, comps, rows, tabs, params) -> int:
    """arith_scan_native in Python, decision by decision (jdarith.c
    decode_mcu and its four progressive kinds, process_restart): the
    tests' reference."""
    src = _Source(data, pos)
    d = _PlainArith(src)
    state = _ArithState(frame, rows, params)
    state.start(d)
    ns = len(comps)
    if ns == 1:
        per_row, total = comps[0].nbw, comps[0].nbw * comps[0].nbh
    else:
        per_row, total = frame.mcux, frame.mcux * frame.mcuy
    left, nxt = frame.restart, 0
    for m in range(total):
        if frame.restart:
            if left == 0:
                src.read_restart(nxt)
                nxt, left = (nxt + 1) & 7, frame.restart
                state.start(d)
            left -= 1
        if d.ct == -1:
            continue  # after a bad code the interval decodes nothing
        my, mx = divmod(m, per_row)
        blocks = [(ci, c.coefs[my * vv + v, mx * hh + h])
                  for ci, c in enumerate(comps)
                  for hh, vv in [(1, 1) if ns == 1 else (c.h, c.v)]
                  for v in range(vv) for h in range(hh)]
        for ci, blk in blocks:
            if not state.block(d, ci, blk):
                d.ct = -1
                break
    return src.end()


def arith_scan_native(data, pos, frame, comps, rows, tabs, params) -> int:
    """One arithmetic-coded scan from `pos` into the components'
    coefficients, in C++ (fd_jpeg_arith_scan); returns the position of the
    marker after it."""
    ss, se, ah, al = params
    buf = np.frombuffer(data, np.uint8)
    ptrs = (ctypes.c_void_p * len(comps))(*[c.coefs.ctypes.data for c in comps])
    end = image_lib.load().fd_jpeg_arith_scan(
        buf.ctypes.data, len(data), pos, len(comps), rows.ctypes.data,
        frame.cond.ctypes.data, ptrs, frame.mcux, frame.mcuy, frame.restart, ss, se, ah,
        al, frame.kind)
    if end < 0:
        raise ValueError(f"corrupt JPEG scan data (code {end})")
    return int(end)


class _HuffBits:
    """jdhuff.c's bit reader as jdhuff.c, jdphuff.c and jdlhuff.c drive it:
    each fill loads bytes until 57 bits are buffered (MIN_GET_BITS), so it
    reads ahead of the bits used (data that ends first suspends the decode:
    _Suspend); a marker stops the feed and zero bits follow, `short` set
    once a fill needs bits past it (insufficient_data); HUFF_DECODE's 8-bit
    lookahead, and a bad code decodes as 0 after 17 bits (jpeg_huff_decode).
    The fast_* methods are decode_mcu_fast's: FILL_BIT_BUFFER_FAST loads six
    bytes once 16 bits or fewer remain, and an 0xFF not followed by 0 sets
    hit_marker (the MCU is then decoded again the slow way). The buffer
    holds n bits, acc < 1 << n."""

    def __init__(self, src: _Source):
        self.src = src
        self.acc = self.n = 0
        self.short = self.hit_marker = False

    def fill(self, need: int) -> None:
        src = self.src
        if not src.unread:
            while self.n < 57:
                c = src.byte()
                if c == 0xFF:
                    c = src.byte()
                    while c == 0xFF:
                        c = src.byte()
                    if c != 0:
                        src.unread = c
                        break
                    c = 0xFF
                self.acc = (self.acc << 8) | c
                self.n += 8
            else:
                return
        if need > self.n:
            self.short = True
            self.acc <<= 57 - self.n
            self.n = 57

    def bits(self, k: int) -> int:
        if self.n < k:
            self.fill(k)
        self.n -= k
        v = self.acc >> self.n
        self.acc &= (1 << self.n) - 1
        return v

    def decode(self, huff: _PlainHuff) -> int:
        if self.n < 8:
            self.fill(0)
        length = 1
        if self.n >= 8:
            length, sym = huff.look[self.acc >> (self.n - 8)]
            if length <= 8:
                self.bits(length)
                return sym
        code = self.bits(length)
        while code > huff.maxcode[length]:
            code = (code << 1) | self.bits(1)
            length += 1
        return 0 if length > 16 else huff.value(length, code)

    def fast_fill(self) -> None:
        if self.n > 16:
            return
        d, p = self.src.data, self.src.pos
        for _ in range(6):
            c0 = d[p] if p < len(d) else 0
            c1 = d[p + 1] if p + 1 < len(d) else 0
            p += 1
            self.acc = (self.acc << 8) | c0
            self.n += 8
            if c0 == 0xFF:
                p += 1
                if c1 != 0:  # a marker: zeros in its place, and the slow path
                    self.hit_marker = True
                    p -= 2
                    self.acc &= ~0xFF
        self.src.pos = p

    def fast_bits(self, k: int) -> int:
        self.fast_fill()
        return self.bits(k)

    def fast_decode(self, huff: _PlainHuff) -> int:
        self.fast_fill()
        length, sym = huff.look[self.acc >> (self.n - 8)]
        if length <= 8:
            self.bits(length)
            return sym
        code = self.bits(length)
        while code > huff.maxcode[length]:
            code = (code << 1) | self.bits(1)
            length += 1
        return 0 if length > 16 else huff.value(length, code)


def _lossless_geometry(frame, rows):
    """(interleaved, MCUs a row, iMCU rows, and per scan component its MCU
    width and height): jdinput.c per_scan_setup with a one-sample data
    unit."""
    if len(rows) > 1:
        return True, frame.mcux, frame.mcuy, [(int(r[0]), int(r[1])) for r in rows]
    return False, int(rows[0][2]), frame.mcuy, [(1, 1)]


def _predict(psv: int, ra: int, rb: int, rc: int) -> int:
    """jdlossls.c's predictors 1-7 (RIGHT_SHIFT is arithmetic)."""
    if psv == 1:
        return ra
    if psv == 2:
        return rb
    if psv == 3:
        return rc
    if psv == 4:
        return ra + rb - rc
    if psv == 5:
        return ra + ((rb - rc) >> 1)
    if psv == 6:
        return rb + ((ra - rc) >> 1)
    return (ra + rb) >> 1


def lossless_scan_plain(data, pos, frame, comps, rows, tabs, params) -> int:
    """lossless_scan_native in Python, sample by sample (jdlhuff.c
    decode_mcus, jddiffct.c decompress_data and process_restart, jdlossls.c
    undifferencing and scaling): the tests' reference."""
    psv, _se, _ah, pt = params
    src = _Source(data, pos)
    b = _HuffBits(src)
    huffs = [_PlainHuff(t) for t in tabs]
    interleaved, per_row, imcu_rows, units = _lossless_geometry(frame, rows)
    if frame.restart % per_row:
        raise ValueError("corrupt JPEG scan: a lossless restart interval that is not "
                         "a whole number of MCU rows")
    rows_per_restart = frame.restart // per_row
    to_go, nxt = rows_per_restart, 0
    first = [True] * len(comps)  # the first-row undifferencer, per component
    prev = [None] * len(comps)
    initial = 1 << (8 - pt - 1)
    for r in range(imcu_rows):
        last = r == imcu_rows - 1
        heights = []
        for c in comps:
            tail = c.ch % c.v or c.v
            heights.append(tail if last else c.v)
        mcu_rows = 1 if interleaved else heights[0]
        diff = [np.zeros((c.v if interleaved else mcu_rows, per_row * u[0]), np.int64)
                for c, u in zip(comps, units)]
        for y in range(mcu_rows):
            if frame.restart and to_go == 0:
                b.acc = b.n = 0  # the buffered bits are dropped
                src.read_restart(nxt)
                nxt = (nxt + 1) & 7
                if src.unread == 0:
                    b.short = False
                first = [True] * len(comps)
                to_go = rows_per_restart
            if b.short:
                first = [True] * len(comps)  # the rows decode as zeros
            else:
                for mx in range(per_row):
                    for ci, (mw, mh) in enumerate(units):
                        for yy in range(mh):
                            for xx in range(mw):
                                s = b.decode(huffs[ci])
                                if s == 16:
                                    v = 32768
                                elif s:
                                    v = _extend(b.bits(s), s)
                                else:
                                    v = 0
                                diff[ci][y + yy, mx * mw + xx] = v
            if frame.restart:
                to_go -= 1
        for ci, c in enumerate(comps):
            for y in range(heights[ci]):
                dr = diff[ci][y]
                out = np.zeros(c.cw, np.int64)
                if first[ci]:
                    ra = (int(dr[0]) + initial) & 0xFFFF
                    out[0] = ra
                    for x in range(1, c.cw):
                        ra = (int(dr[x]) + ra) & 0xFFFF
                        out[x] = ra
                    first[ci] = False
                else:
                    up = prev[ci]
                    ra = (int(dr[0]) + int(up[0])) & 0xFFFF
                    out[0] = ra
                    for x in range(1, c.cw):
                        ra = (int(dr[x]) + _predict(psv, ra, int(up[x]), int(up[x - 1]))) & 0xFFFF
                        out[x] = ra
                prev[ci] = out
                c.samples[r * c.v + y] = (out << pt) & 0xFF
    return src.end()


def lossless_scan_native(data, pos, frame, comps, rows, tabs, params) -> int:
    """One lossless scan from `pos` into the components' samples, in C++
    (fd_jpeg_lossless_scan); returns the position of the marker after it."""
    psv, _se, _ah, pt = params
    buf = np.frombuffer(data, np.uint8)
    ptrs = (ctypes.c_void_p * len(comps))(*[c.samples.ctypes.data for c in comps])
    end = image_lib.load().fd_jpeg_lossless_scan(
        buf.ctypes.data, len(data), pos, len(comps), rows.ctypes.data, tabs.ctypes.data,
        ptrs, frame.mcux, frame.mcuy, frame.restart, psv, pt)
    if end < 0:
        raise ValueError(f"corrupt JPEG scan data (code {end})")
    return int(end)


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
        # libjpeg-turbo 3 takes a lossless frame without markers for RGB
        return "RGB" if ids == (82, 71, 66) or frame.kind == LOSSLESS else "YCbCr"
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


# jdcoefct.c's block smoothing: the natural positions of zigzag
# coefficients 1-9 (Q01, Q10, Q20, Q11, Q02, Q03, Q12, Q21, Q30)
SMOOTH_NATURAL = (1, 8, 16, 9, 2, 3, 10, 17, 24)


def _rows5(*rows):
    return [list(r) for r in rows]


_Z = (0, 0, 0, 0, 0)
# decompress_smooth_data's estimates as weights on the 5x5 DC neighbourhood
# (rows two above to two below, columns two left to two right), for
# coefficients 1-9 and then DC: [0] the Annex K.8-like estimate of a
# component with AC data, [1] the DC interpolation of one without (only
# then are coefficients 6-9 and DC estimated)
SMOOTH_WEIGHTS = np.array([
    [_rows5(_Z, _Z, (-7, 50, 0, -50, 7), _Z, _Z),
     _rows5((0, 0, -7, 0, 0), (0, 0, 50, 0, 0), _Z, (0, 0, -50, 0, 0), (0, 0, 7, 0, 0)),
     _rows5((0, 0, -1, 0, 0), (0, 0, 13, 0, 0), (0, 0, -24, 0, 0), (0, 0, 13, 0, 0),
            (0, 0, -1, 0, 0)),
     _rows5((0, -1, 0, 1, 0), (-1, 10, 0, -10, 1), _Z, (1, -10, 0, 10, -1), (0, 1, 0, -1, 0)),
     _rows5(_Z, _Z, (-1, 13, -24, 13, -1), _Z, _Z),
     _rows5(_Z, _Z, _Z, _Z, _Z), _rows5(_Z, _Z, _Z, _Z, _Z), _rows5(_Z, _Z, _Z, _Z, _Z),
     _rows5(_Z, _Z, _Z, _Z, _Z), _rows5(_Z, _Z, _Z, _Z, _Z)],
    [_rows5((-1, -1, 0, 1, 1), (-3, 13, 0, -13, 3), (-3, 38, 0, -38, 3), (-3, 13, 0, -13, 3),
            (-1, -1, 0, 1, 1)),
     _rows5((-1, -3, -3, -3, -1), (-1, 13, 38, 13, -1), _Z, (1, -13, -38, -13, 1),
            (1, 3, 3, 3, 1)),
     _rows5((0, 0, 1, 0, 0), (0, 2, 7, 2, 0), (0, -5, -14, -5, 0), (0, 2, 7, 2, 0),
            (0, 0, 1, 0, 0)),
     _rows5((-1, 0, 0, 0, 1), (0, 9, 0, -9, 0), _Z, (0, -9, 0, 9, 0), (1, 0, 0, 0, -1)),
     _rows5(_Z, (0, 2, -5, 2, 0), (1, 7, -14, 7, 1), (0, 2, -5, 2, 0), _Z),
     _rows5(_Z, (0, 1, 0, -1, 0), (0, 2, 0, -2, 0), (0, 1, 0, -1, 0), _Z),
     _rows5(_Z, (0, 1, -3, 1, 0), _Z, (0, -1, 3, -1, 0), _Z),
     _rows5(_Z, (0, 1, 0, -1, 0), (0, -3, 0, 3, 0), (0, 1, 0, -1, 0), _Z),
     _rows5(_Z, (0, 1, 2, 1, 0), _Z, (0, -1, -2, -1, 0), _Z),
     _rows5((-2, -6, -8, -6, -2), (-6, 6, 42, 6, -6), (-8, 42, 152, 42, -8),
            (-6, 6, 42, 6, -6), (-2, -6, -8, -6, -2))]], np.int64)


def smoothing_latch(frame: Frame):
    """jdcoefct.c smoothing_ok as PIL reaches it, with every scan read: None
    when no block is smoothed (not progressive; a component whose DC no
    scan reached, or a zero among its DC and first nine AC quantisers; or
    coefficients 1-9 fully refined in every component), else each
    component's latches, int32 (2, 10): its coef_bits for DC and
    coefficients 1-9, and for 1-9 the values before its latest scan (-1
    after a file's first scan), which the iMCU rows past frame.last_good
    use. A complete progressive file refines every coefficient to Al 0, so
    it is never smoothed."""
    if frame.kind != PROGRESSIVE:
        return None
    latches = []
    for c in frame.components:
        if c.qt is None or (c.qt[[0, *SMOOTH_NATURAL]] == 0).any() or c.coef_bits[0] < 0:
            return None
        prev = c.prev_bits[:10] if frame.scans > 1 else np.full(10, -1, np.int32)
        latches.append(np.stack([c.coef_bits[:10], prev]).astype(np.int32))
    if not any((b[0, 1:] != 0).any() for b in latches):
        return None
    return latches


def smooth_geometry(c: Component, imcu_rows: int):
    """For each of the component's block rows and columns, the rows (two
    above to two below) and columns (two left to two right) whose DC values
    decompress_smooth_data reads, int32 (nbh, 5) and (nbw, 5). Columns are
    clamped to the picture. Rows: an iMCU row's block rows read their
    neighbours' rows, an edge's own row standing in past it, as libjpeg
    finds the edges: image_block_row counted with the iMCU row's own block
    count, so a short last iMCU row sees its edges where that count puts
    them, and a row two above the last full iMCU row may read a padding
    row."""
    v, nbh = c.v, c.nbh
    rows = np.zeros((nbh, 5), np.int32)
    for r in range(imcu_rows):
        count = v if r < imcu_rows - 1 else (nbh % v or v)
        for b in range(count):
            g, ibr, ibrs = r * v + b, r * count + b, count * imcu_rows
            p = g - 1 if ibr > 0 else g
            n = g + 1 if ibr < ibrs - 1 else g
            rows[g] = (g - 2 if ibr > 1 else p, p, g, n, g + 2 if ibr < ibrs - 2 else n)
    cols = np.clip(np.arange(c.nbw)[:, None] + np.arange(-2, 3), 0, c.nbw - 1)
    return rows, cols.astype(np.int32)


def smooth_args(frame: Frame, c: Component, bits: np.ndarray) -> tuple:
    """The arguments smooth and smooth_plain take for component c of frame
    with its latches `bits` (smoothing_latch)."""
    rows, cols = smooth_geometry(c, frame.mcuy)
    last_good = frame.mcuy if frame.last_good is None else frame.last_good
    return c.coefs, c.qt, bits, rows, cols, c.v, last_good


def smooth(coefs, qt, bits, rows, cols, v: int, last_good: int) -> np.ndarray:
    """The coefficients the IDCT reads for a component under block
    smoothing, in C++ (fd_jpeg_smooth): a copy of coefs (bh, bw, 64) whose
    blocks within (len(rows), len(cols)) have their still-zero low
    coefficients estimated, with bits[0] (smoothing_latch) in iMCU rows (v
    block rows each) up to last_good and bits[1] past it; the stored
    coefficients stay as they are."""
    coefs = np.ascontiguousarray(coefs, np.int16)
    out = np.empty_like(coefs)
    bh, bw = coefs.shape[:2]
    rows, cols = np.ascontiguousarray(rows, np.int32), np.ascontiguousarray(cols, np.int32)
    qt, bits = np.ascontiguousarray(qt, np.uint16), np.ascontiguousarray(bits, np.int32)
    image_lib.load().fd_jpeg_smooth(coefs.ctypes.data, bh, bw, len(rows), len(cols),
                                    rows.ctypes.data, cols.ctypes.data, qt.ctypes.data,
                                    bits.ctypes.data, v, last_good, out.ctypes.data)
    return out


def _estimate(num, q, al):
    """decompress_smooth_data's rounding of num / (q << 8), capped below
    1 << Al when Al > 0, the sign restored."""
    mag = ((q << 7) + np.abs(num)) // (q << 8)
    if al > 0:
        mag = np.minimum(mag, (1 << al) - 1)
    return np.where(num >= 0, mag, -mag)


def smooth_plain(coefs, qt, bits, rows, cols, v: int, last_good: int) -> np.ndarray:
    """smooth in numpy, the blocks of each latch at once."""
    nbh, nbw = len(rows), len(cols)
    out = coefs.copy()
    dc = coefs[:, :, 0].astype(np.int64)
    past = np.arange(nbh) // v > last_good
    q00 = int(qt[0])
    for latch, where in ((bits[0], ~past), (bits[1], past)):
        if not where.any():
            continue
        hood = dc[rows[where][:, None, :, None], cols[None, :, None, :]]  # (n, nbw, 5, 5)
        change_dc = bool((latch[1:10] == -1).all())
        weights = SMOOTH_WEIGHTS[int(change_dc)]
        ws = out[:nbh, :nbw][where]
        for k, pos in enumerate(SMOOTH_NATURAL[:9 if change_dc else 5]):
            al = int(latch[k + 1])
            if al == 0:
                continue
            num = q00 * np.einsum("hwij,ij->hw", hood, weights[k])
            pred = _estimate(num, int(qt[pos]), al)
            ws[..., pos] = np.where(ws[..., pos] == 0, _int16(pred), ws[..., pos])
        if change_dc:
            num = q00 * np.einsum("hwij,ij->hw", hood, weights[9])
            ws[..., 0] = _int16(_estimate(num, q00, 0))
        out[:nbh, :nbw][where] = ws
    return out


def _full_planes(frame: Frame, plain: bool) -> list:
    """Each component's samples, dequantised, transformed and upsampled to
    the frame's full (H, W) grid."""
    planes = []
    latch = smoothing_latch(frame)
    for i, c in enumerate(frame.components):
        if frame.kind == LOSSLESS:
            samples = c.samples
            _method, hx, vy = upsample_method(c, frame.hmax, frame.vmax)
            method = BOX  # replication: fancy upsampling needs a DCT scaling above 1
        else:
            coefs = c.coefs
            if latch is not None:
                coefs = (smooth_plain if plain else smooth)(*smooth_args(frame, c, latch[i]))
            samples = (idct_plain if plain else idct)(coefs, c.qt)
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
    if frame.kind == LOSSLESS and space in ("YCbCr", "YCCK"):
        raise ValueError(f"a lossless JPEG in {space}: libjpeg converts no colour space "
                         "of a lossless frame (Unsupported color conversion request)")
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
