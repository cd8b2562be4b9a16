"""The port's AV1 intra decoder for AVIF still images (utils/avif.py reads
the container): the OBUs, the sequence header and the frame header of a
shown key frame in Python, the tiles, the loop filter, CDEF, loop
restoration and film grain synthesis in C++ (csrc/av1_decode.cpp, built
by utils/image_lib.py), then YUV -> RGBA as libavif 1.3.0 converts it
for PIL 12.1.0 (libyuv's fixed point where it has constants for the
matrix and range, else libavif's own float conversion: `conversion`).

Decoded: profiles 0-2 at 8, 10 and 12 bits (planes of uint8 at 8 bits,
uint16 at 10 and 12), 4:2:0, 4:2:2 and 4:4:4 colour or monochrome (an
alpha item),
the reduced still-picture header or a full one with one shown key frame
(timing and decoder model info, operating points, frame ids, screen
content and order hint settings; a frame as one OBU_FRAME or an
OBU_FRAME_HEADER and its tile groups; OBU extension headers, dropped
outside the layers of the operating point dav1d decodes, as an item's
a1op picks it, and an item's lsel asking for a frame of its spatial
layer),
uniform and non-uniform tiles, segmentation, delta q and delta lf,
palettes, intra block copy (its vector stack, vectors and copies, the
inter transform sets and split transform sizes it brings) and filter
intra, coded-lossless frames (WHT), CDEF (its 64x64 indices, the
direction search, the primary and secondary taps) and loop restoration
(Wiener and self-guided units, switchable or not, over stripes of 64
luma rows), and film grain (film_grain_params, then the grain as dav1d
1.5.1 synthesises it before libavif receives the picture: the templates
from the LFSR and the Gaussian sequence with their autoregressive
filter, the scaling lookups, the noise of 32x32 blocks at random
offsets with their overlap; at every layout and depth). Refused with
NotImplementedError naming AVIF and the feature: superres and any frame
that is not a shown key frame. Quantiser matrices (aom's `enable-qm`)
are read. A malformed stream raises ValueError, as do a 4:2:2 partition
whose chroma block has no size and the film grain headers dav1d rejects
(more than 14 luma or 10 chroma points, points that do not increase,
4:2:0 points for one chroma plane only).

The C++ stages and their numpy twins here, the tests' reference (nothing
on the load path uses the twins unless `plain` is asked for):
- inv_txfm_plain: the inverse transforms (DCT 4-64, ADST 4-16, flipped
  ADST, identity, WHT) of csrc's inverse_transform;
- predict_plain, cfl_plain: the intra predictors with the edge filter and
  upsampling, CfL, filter intra;
- lf_edge_plain: the loop filter at one position of an edge;
- cdef_block_plain: CDEF of one 8x8 (its direction and variance for
  luma) or of its 4x4 chroma blocks, from the window the C++ read;
- wiener_plain, sgr_plain: the Wiener and self-guided filters of one
  restoration unit's part of a stripe, from the window the C++ read;
- scale_plain: libyuv's ScalePlane as libavif scales a frame to the size
  its item's ispe gives;
- to_rgba_plain: libyuv's chroma upsampling (4:2:2 across, 4:2:0
  bilinear) and fixed point, or libavif's float conversion, at the bit
  depth libavif converts at;
- film_grain_plain: the film grain of a frame's planes, from
  grain_templates_plain (the three templates), grain_scaling_plain (a
  plane's scaling lookup) and grain_offsets_plain (each block's random
  offset);
- alpha_range_plain: a limited-range alpha plane expanded to full range
  (libavif's avifLimitedToFullY);
- unattenuate_plain: premultiplied RGBA made straight (libyuv's x86
  ARGBUnattenuate rows).
Each stage's twin takes the bit depth (`bit_depth`, 8 by default; the
film grain's is in its parameters).
`decode(stream, plain=True)` decodes the tiles in C++ with a trace of each
prediction, transform, loop filter, CDEF and restoration call, checks
every traced call against its twin, holds the C++ film grain to
film_grain_plain, and converts with the plain conversion.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np

from . import av1_tables as T
from . import image_lib

NOT_PORTED = ("AVIF images with {} are not decoded by figdraw_tpu_torch ({}): not ported yet "
              "(ROADMAP.md, module item 'Image formats other than PNG')")

# the C++ entry points' error codes
ERRORS = {-2: "bad arguments", -3: "a Golomb code past 20 bits",
          -5: "a partition whose 4:2:2 chroma block has no size (dav1d rejects it)"}
SCALE_RATIO = -4  # fd_av1_scale: a 3/4 or 3/8 scale (not ported)

# OBU types read (temporal delimiters, metadata and padding are skipped)
OBU_SEQUENCE_HEADER, OBU_FRAME_HEADER, OBU_TILE_GROUP, OBU_FRAME = 1, 3, 4, 6

# the frame header as csrc/av1_decode.cpp reads it (H_* there)
(H_WIDTH, H_HEIGHT, H_MI_COLS, H_MI_ROWS, H_MONO, H_USE128, H_FILTER_INTRA, H_EDGE_FILTER,
 H_DISABLE_CDF_UPDATE, H_SCREEN_CONTENT, H_ALLOW_INTRABC, H_BASE_Q, H_DQ_Y_DC, H_DQ_U_DC,
 H_DQ_U_AC, H_DQ_V_DC, H_DQ_V_AC, H_SEG_ENABLED, H_SEG_PRE_SKIP, H_LAST_ACTIVE_SEG,
 H_DELTA_Q_PRESENT, H_DELTA_Q_RES, H_DELTA_LF_PRESENT, H_DELTA_LF_RES, H_DELTA_LF_MULTI,
 H_TX_MODE, H_REDUCED_TX_SET, H_LF_LEVEL0) = range(28)
H_SHARPNESS = H_LF_LEVEL0 + 4
H_LF_DELTA_ENABLED = H_SHARPNESS + 1
H_REF_DELTAS = H_LF_DELTA_ENABLED + 1
H_ROW_START = H_REF_DELTAS + 8
H_ROW_END, H_COL_START, H_COL_END = H_ROW_START + 1, H_ROW_START + 2, H_ROW_START + 3
H_FEATURE_ENABLED = H_COL_END + 1
H_FEATURE_DATA = H_FEATURE_ENABLED + 64
H_LOSSLESS = H_FEATURE_DATA + 64
H_STRIDE_Y = H_LOSSLESS + 8
H_STRIDE_UV = H_STRIDE_Y + 1
H_USING_QM, H_QM_Y, H_QM_U, H_QM_V = H_STRIDE_UV + 1, H_STRIDE_UV + 2, H_STRIDE_UV + 3, H_STRIDE_UV + 4
# CDEF: read_cdef reads, damping, cdef_bits, the strengths of each index
H_CDEF_READ, H_CDEF_DAMPING, H_CDEF_BITS = H_QM_V + 1, H_QM_V + 2, H_QM_V + 3
H_CDEF_Y_PRI = H_CDEF_BITS + 1
H_CDEF_Y_SEC = H_CDEF_Y_PRI + 8
H_CDEF_UV_PRI = H_CDEF_Y_SEC + 8
H_CDEF_UV_SEC = H_CDEF_UV_PRI + 8
# loop restoration: each plane's type, unit size, units down and across,
# and the units of a plane in fd_av1_tile's out-array
H_LR_TYPE = H_CDEF_UV_SEC + 8
H_LR_SIZE = H_LR_TYPE + 3
H_LR_ROWS = H_LR_SIZE + 3
H_LR_COLS = H_LR_ROWS + 3
H_LR_STRIDE = H_LR_COLS + 3
# the chroma planes' subsampling across and down (1 for monochrome), and
# BitDepth (8, 10 or 12)
H_SSX, H_SSY, H_BITDEPTH = H_LR_STRIDE + 1, H_LR_STRIDE + 2, H_LR_STRIDE + 3
H_SIZE = H_BITDEPTH + 1
RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE = range(4)
REMAP_LR_TYPE = (RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ)
# a restoration unit as fd_av1_tile writes it (L_* there): its type, the
# Wiener taps 0-2 of the vertical then the horizontal filter, the
# self-guided set and its two weights
L_TYPE, L_WIENER, L_SET, L_XQD, L_FIELDS = 0, 1, 7, 8, 10
# film_grain_params as fd_av1_film_grain takes them (G_* there): grain_seed,
# the luma points (x, scaling) and their count, chroma_scaling_from_luma,
# the Cb and Cr counts and points, scaling_shift (grain_scaling_minus_8 +
# 8), ar_coeff_lag, the AR coefficients (luma's 24; each chroma plane's 25,
# the luma term last), ar_coeff_shift, grain_scale_shift, each chroma
# plane's mult, luma_mult and offset, overlap_flag and
# clip_to_restricted_range; then the sequence's subsampling, monochrome,
# BitDepth and whether its matrix is the identity (the chroma clip's range)
G_SEED, G_NUM_Y, G_Y_POINTS = 0, 1, 2
G_CSFL = G_Y_POINTS + 28
G_NUM_UV = G_CSFL + 1
G_UV_POINTS = G_NUM_UV + 2
G_SCALING_SHIFT = G_UV_POINTS + 40
G_AR_LAG = G_SCALING_SHIFT + 1
G_AR_Y = G_AR_LAG + 1
G_AR_UV = G_AR_Y + 24
G_AR_SHIFT = G_AR_UV + 50
G_GRAIN_SCALE_SHIFT = G_AR_SHIFT + 1
G_UV_MULT = G_GRAIN_SCALE_SHIFT + 1
G_UV_LUMA_MULT = G_UV_MULT + 2
G_UV_OFFSET = G_UV_LUMA_MULT + 2
G_OVERLAP = G_UV_OFFSET + 2
G_CLIP, G_SSX, G_SSY, G_MONO, G_BITDEPTH, G_IS_ID = range(G_OVERLAP + 1, G_OVERLAP + 7)
G_FIELDS = G_IS_ID + 1
# the grain templates (luma; chroma 38 rows and 44 columns where subsampled)
GRAIN_H, GRAIN_W, SUB_GRAIN_H, SUB_GRAIN_W = 73, 82, 38, 44

# the per-4x4 block info csrc/av1_decode.cpp writes (M_* there)
(M_SIZE, M_SKIP, M_SEG, M_TX_Y, M_TX_UV, M_DLF0, M_DLF1, M_DLF2, M_DLF3, M_YMODE, M_UVMODE,
 M_INTER, M_MV_ROW, M_MV_COL, M_WRITTEN, M_FIELDS) = range(16)

# the specification's exit process requires SymbolMaxBits >= -14 at a
# tile's end (its symbols read at most 14 bits past the data); dav1d in
# PIL's libavif rejects a tile past that, and so does the port
# (tools/avif_fuzz_agreement.py --corrupt)
OVERREAD = -14

SEG_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
SEG_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)
SEG_MAX = (255, 63, 63, 63, 63, 7, 0, 0)


class Refused(NotImplementedError):
    """An AV1 or HEIF feature outside the slice; imagefile.decode_image
    names the path in its message."""

    def __init__(self, feature: str):
        self.feature = feature
        super().__init__(NOT_PORTED.format(feature, "bytes"))


def refuse(feature: str) -> Refused:
    return Refused(feature)


class BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.bit = data, pos * 8

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.bit >> 3
            if byte >= len(self.data):
                raise ValueError("AV1: a header runs past its OBU")
            v = (v << 1) | ((self.data[byte] >> (7 - (self.bit & 7))) & 1)
            self.bit += 1
        return v

    def su(self, n: int) -> int:
        v = self.f(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.f(1)

    def uvlc(self) -> int:
        zeros = 0
        while not self.f(1):
            zeros += 1
            if zeros >= 32:
                return (1 << 32) - 1
        return self.f(zeros) + (1 << zeros) - 1

    def align(self) -> None:
        self.bit = (self.bit + 7) & ~7


def leb128(data: bytes, pos: int) -> tuple:
    value = 0
    for i in range(8):
        if pos >= len(data):
            raise ValueError("AV1: a truncated leb128")
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            break
    return value, pos


def obus(data: bytes):
    """(type, payload bytes) of each OBU of a low-overhead stream."""
    for kind, _layer, payload in obu_layers(data):
        yield kind, payload


def obu_layers(data: bytes):
    """(type, (temporal id, spatial id) from its extension header or None,
    payload bytes) of each OBU of a low-overhead stream."""
    pos = 0
    while pos < len(data):
        head = data[pos]  # dav1d reads past a set forbidden bit (its default, not strict)
        kind = (head >> 3) & 15
        ext = (head >> 2) & 1
        has_size = (head >> 1) & 1
        layer = None
        if ext:
            if pos + 1 >= len(data):
                raise ValueError("AV1: a truncated OBU header")
            layer = (data[pos + 1] >> 5, (data[pos + 1] >> 3) & 3)
        pos += 1 + ext
        if has_size:
            size, pos = leb128(data, pos)
        else:
            size = len(data) - pos
        if pos + size > len(data):
            raise ValueError("AV1: an OBU runs past the stream")
        yield kind, layer, data[pos:pos + size]
        pos += size


class Sequence:
    pass


def parse_sequence(payload: bytes) -> Sequence:
    r = BitReader(payload)
    s = Sequence()
    s.profile = r.f(3)
    s.still = r.f(1)
    s.reduced = r.f(1)
    if s.reduced and not s.still:  # dav1d rejects the stream
        raise ValueError("AV1: a reduced still-picture header without still_picture")
    s.decoder_model = 0
    s.equal_picture_interval = 0
    s.op_idc = [0]
    s.decoder_model_present = [0]
    if s.reduced:
        r.f(5)
    else:
        timing = r.f(1)
        if timing:
            r.f(32)
            r.f(32)
            s.equal_picture_interval = r.f(1)
            if s.equal_picture_interval and r.uvlc() == (1 << 32) - 1:  # dav1d rejects it
                raise ValueError("AV1: num_ticks_per_picture past 32 bits")
            s.decoder_model = r.f(1)
            if s.decoder_model:
                s.buffer_delay_len = r.f(5) + 1
                r.f(32)
                s.removal_len = r.f(5) + 1
                s.presentation_len = r.f(5) + 1
        initial_delay = r.f(1)
        count = r.f(5) + 1
        s.op_idc, s.decoder_model_present = [], []
        for _ in range(count):
            s.op_idc.append(r.f(12))
            if s.op_idc[-1] and (not s.op_idc[-1] & 0xFF or not s.op_idc[-1] & 0xF00):
                raise ValueError("AV1: an operating point without a temporal or spatial layer")
            level = r.f(5)
            if level > 7:
                r.f(1)
            present = 0
            if s.decoder_model:
                present = r.f(1)
                if present:
                    n = s.buffer_delay_len
                    r.f(n)
                    r.f(n)
                    r.f(1)
            s.decoder_model_present.append(present)
            if initial_delay and r.f(1):
                r.f(4)
    if s.profile > 2:  # dav1d rejects the stream
        raise ValueError(f"AV1: profile {s.profile}")
    wbits, hbits = r.f(4) + 1, r.f(4) + 1
    s.max_width, s.max_height = r.f(wbits) + 1, r.f(hbits) + 1
    s.wbits, s.hbits = wbits, hbits
    s.frame_ids = 0 if s.reduced else r.f(1)
    if s.frame_ids:
        s.delta_frame_id_len = r.f(4) + 2
        s.frame_id_len = r.f(3) + 1 + s.delta_frame_id_len
    s.use128 = r.f(1)
    s.filter_intra = r.f(1)
    s.edge_filter = r.f(1)
    s.order_hint_bits = 0
    s.force_screen_content = 2
    s.force_integer_mv = 2
    if not s.reduced:
        r.f(1)  # interintra compound
        r.f(1)  # masked compound
        r.f(1)  # warped motion
        r.f(1)  # dual filter
        order_hint = r.f(1)
        if order_hint:
            r.f(1)
            r.f(1)
        if r.f(1):  # seq_choose_screen_content_tools
            s.force_screen_content = 2
        else:
            s.force_screen_content = r.f(1)
        if s.force_screen_content > 0:
            if r.f(1):
                s.force_integer_mv = 2
            else:
                s.force_integer_mv = r.f(1)
        if order_hint:
            s.order_hint_bits = r.f(3) + 1
    if r.f(1):
        raise refuse("superres")
    s.enable_cdef = r.f(1)
    s.enable_restoration = r.f(1)
    # color_config: profile 0 is 4:2:0 or monochrome, 1 is 4:4:4 (never
    # monochrome), 2 is 4:2:2 at 8 and 10 bits and codes its subsampling
    # at 12 (twelve_bit, read in profile 2 only)
    s.color_bit = r.bit
    high = r.f(1)
    s.bit_depth = 8 + 2 * high
    if s.profile == 2 and high:
        s.bit_depth += 2 * r.f(1)
    s.mono = 0 if s.profile == 1 else r.f(1)
    s.color_description = r.f(1)
    s.primaries, s.transfer, s.matrix = 2, 2, 2
    if s.color_description:
        s.primaries, s.transfer, s.matrix = r.f(8), r.f(8), r.f(8)
    s.ssx, s.ssy = (0, 0) if s.profile == 1 else ((1, 0) if s.profile == 2 else (1, 1))
    s.separate_uv_dq = s.chroma_position = 0
    if s.mono:
        s.ssx = s.ssy = 1
        s.full_range = r.f(1)
    else:
        if (s.primaries, s.transfer, s.matrix) == (1, 13, 0):  # sRGB: 4:4:4 full range, unread
            if s.profile != 1 and s.bit_depth != 12:  # dav1d rejects it elsewhere
                raise ValueError("AV1: sRGB identity colour outside profile 1 and 12 bits")
            s.ssx = s.ssy = 0
            s.full_range = 1
        else:
            s.full_range = r.f(1)
            if s.profile == 2 and s.bit_depth == 12:
                s.ssx = r.f(1)
                s.ssy = r.f(1) if s.ssx else 0
            if s.ssx and s.ssy:
                s.chroma_position = r.f(2)
        s.separate_uv_dq = r.f(1)
    s.film_grain = r.f(1)  # film_grain_params_present
    return s


class Frame:
    """A decoded frame: its planes (the padded decode buffers: Y, then U and
    V or None), their visible size, and the colour description."""

    def __init__(self, planes, width, height, full_range, matrix, mono, ssx=1, ssy=1,
                 primaries=2, bit_depth=8, transfer=2):
        self.planes, self.width, self.height = planes, width, height
        self.bit_depth = bit_depth  # 8 (uint8 planes), 10 or 12 (uint16)
        self.full_range, self.matrix, self.mono = full_range, matrix, mono
        self.ssx, self.ssy = ssx, ssy  # the chroma planes' subsampling
        self.primaries, self.transfer = primaries, transfer
        self.checked = None  # the stage calls checked against their twins (plain)
        self.mi = None  # the per-4x4 block info the tiles wrote (M_FIELDS int32 each)
        self.cdef = None  # each 64x64's CDEF index (-1: none read)
        self.lr = None  # the restoration units (3, H_LR_STRIDE, L_FIELDS)
        self.grain = None  # the film grain parameters (G_FIELDS), or None
        self.ms = {}  # host ms of each decode stage


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def parse_frame_header(r: BitReader, s: Sequence, layer=None) -> dict:
    """The uncompressed header of a shown key frame as an HDR array and
    its tile layout; `layer` is the (temporal id, spatial id) of its OBU's
    extension header (None: 0, 0), which picks the operating points whose
    buffer removal times it carries."""
    temporal, spatial = layer or (0, 0)
    hdr = np.zeros(H_SIZE, np.int32)
    if not s.reduced:
        if r.f(1):
            raise refuse("a shown existing frame")
        frame_type = r.f(2)
        show = r.f(1)
        if frame_type != 0 or not show:
            raise refuse("frames other than one shown key frame")
        if s.decoder_model and not s.equal_picture_interval:
            r.f(s.presentation_len)
    disable_cdf_update = r.f(1)
    screen = r.f(1) if s.force_screen_content == 2 else s.force_screen_content
    if screen and s.force_integer_mv == 2:
        r.f(1)
    if s.frame_ids:
        r.f(s.frame_id_len)
    override = 0 if s.reduced else r.f(1)
    r.f(s.order_hint_bits)
    if s.decoder_model:
        if r.f(1):
            for idc, present in zip(s.op_idc, s.decoder_model_present):
                if present and (idc == 0 or ((idc >> temporal) & 1 and (idc >> (spatial + 8)) & 1)):
                    r.f(s.removal_len)
    if override:
        width, height = r.f(s.wbits) + 1, r.f(s.hbits) + 1
    else:
        width, height = s.max_width, s.max_height
    if r.f(1):  # render_and_frame_size_different
        r.f(16)
        r.f(16)
    allow_intrabc = r.f(1) if screen else 0
    if not s.reduced and not disable_cdf_update:
        r.f(1)  # disable_frame_end_update_cdf (one frame: nothing to save)
    mi_cols, mi_rows = 2 * ((width + 7) >> 3), 2 * ((height + 7) >> 3)
    # tile info
    sb_cols = (mi_cols + 31) >> 5 if s.use128 else (mi_cols + 15) >> 4
    sb_rows = (mi_rows + 31) >> 5 if s.use128 else (mi_rows + 15) >> 4
    sb_shift = 5 if s.use128 else 4
    sb_size = sb_shift + 2
    max_tile_width_sb = 4096 >> sb_size
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size)
    min_log2_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_cols, _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    col_starts, row_starts = [], []
    if r.f(1):  # uniform
        cols_log2 = min_log2_cols
        while cols_log2 < max_log2_cols and r.f(1):
            cols_log2 += 1
        w_sb = (sb_cols + (1 << cols_log2) - 1) >> cols_log2
        col_starts = [sb << sb_shift for sb in range(0, sb_cols, w_sb)]
        rows_log2 = max(min_log2_tiles - cols_log2, 0)
        while rows_log2 < max_log2_rows and r.f(1):
            rows_log2 += 1
        h_sb = (sb_rows + (1 << rows_log2) - 1) >> rows_log2
        row_starts = [sb << sb_shift for sb in range(0, sb_rows, h_sb)]
    else:
        widest, start = 0, 0
        while start < sb_cols:
            col_starts.append(start << sb_shift)
            size = r.ns(min(sb_cols - start, max_tile_width_sb)) + 1
            widest = max(widest, size)
            start += size
        cols_log2 = _tile_log2(1, len(col_starts))
        area = (sb_rows * sb_cols) >> (min_log2_tiles + 1) if min_log2_tiles else sb_rows * sb_cols
        max_h = max(area // widest, 1)
        start = 0
        while start < sb_rows:
            row_starts.append(start << sb_shift)
            start += r.ns(min(sb_rows - start, max_h)) + 1
        rows_log2 = _tile_log2(1, len(row_starts))
    col_starts.append(mi_cols)
    row_starts.append(mi_rows)
    tile_size_bytes = 4
    if cols_log2 or rows_log2:
        r.f(rows_log2 + cols_log2)  # context_update_tile_id
        tile_size_bytes = r.f(2) + 1
    # quantisation
    base_q = r.f(8)

    def delta_q():
        return r.su(7) if r.f(1) else 0

    dq = [delta_q(), 0, 0, 0, 0]
    if not s.mono:
        diff = r.f(1) if s.separate_uv_dq else 0
        dq[1], dq[2] = delta_q(), delta_q()
        if diff:
            dq[3], dq[4] = delta_q(), delta_q()
        else:
            dq[3], dq[4] = dq[1], dq[2]
    using_qm = r.f(1)
    qm = [15, 15, 15]
    if using_qm:
        qm[0] = r.f(4)
        qm[1] = r.f(4)
        qm[2] = r.f(4) if s.separate_uv_dq else qm[1]
    # segmentation
    seg_enabled = r.f(1)
    fe = np.zeros((8, 8), np.int32)
    fd = np.zeros((8, 8), np.int32)
    if seg_enabled:
        for i in range(8):
            for j in range(8):
                if r.f(1):
                    fe[i, j] = 1
                    bits = SEG_BITS[j]
                    if SEG_SIGNED[j]:
                        fd[i, j] = max(-SEG_MAX[j], min(SEG_MAX[j], r.su(1 + bits)))
                    else:
                        fd[i, j] = min(SEG_MAX[j], r.f(bits))
    pre_skip, last_active = 0, 0
    for i in range(8):
        for j in range(8):
            if fe[i, j]:
                last_active = i
                if j >= 5:
                    pre_skip = 1
    # delta q / lf
    dq_present = dq_res = dlf_present = dlf_res = dlf_multi = 0
    if base_q > 0:
        dq_present = r.f(1)
    if dq_present:
        dq_res = r.f(2)
        dlf_present = 0 if allow_intrabc else r.f(1)
        if dlf_present:
            dlf_res = r.f(2)
            dlf_multi = r.f(1)
    lossless = np.zeros(8, np.int32)
    for seg in range(8):
        q = base_q
        if seg_enabled and fe[seg, 0]:
            q = max(0, min(255, base_q + fd[seg, 0]))
        lossless[seg] = int(q == 0 and not any(dq))
    coded_lossless = int(lossless.all())
    # loop filter
    levels = [0, 0, 0, 0]
    sharpness = 0
    ref_deltas = [1, 0, 0, 0, -1, 0, -1, -1]
    delta_enabled = 1
    if not coded_lossless and not allow_intrabc:  # else no loop filter
        levels[0], levels[1] = r.f(6), r.f(6)
        if not s.mono and (levels[0] or levels[1]):
            levels[2], levels[3] = r.f(6), r.f(6)
        sharpness = r.f(3)
        delta_enabled = r.f(1)
        if delta_enabled and r.f(1):
            for i in range(8):
                if r.f(1):
                    ref_deltas[i] = r.su(7)
            for i in range(2):  # the mode deltas, which no intra block reads
                if r.f(1):
                    r.su(7)
    # CDEF (cdef_params)
    cdef_read = int(not (coded_lossless or allow_intrabc or not s.enable_cdef))
    damping, cdef_bits = 3, 0
    strengths = np.zeros((4, 8), np.int32)  # y pri, y sec, uv pri, uv sec
    if cdef_read:
        damping = r.f(2) + 3
        cdef_bits = r.f(2)
        for i in range(1 << cdef_bits):
            strengths[0, i] = r.f(4)
            strengths[1, i] = r.f(2)
            if not s.mono:
                strengths[2, i] = r.f(4)
                strengths[3, i] = r.f(2)
        strengths[[1, 3]] += strengths[[1, 3]] == 3
    # loop restoration (lr_params; AllLossless is CodedLossless without superres)
    lr_type, lr_size = [RESTORE_NONE] * 3, [0, 0, 0]
    if not (coded_lossless or allow_intrabc or not s.enable_restoration):
        planes = 1 if s.mono else 3
        for i in range(planes):
            lr_type[i] = REMAP_LR_TYPE[r.f(2)]
        if any(lr_type):
            if s.use128:
                shift = r.f(1) + 1
            else:
                shift = r.f(1)
                if shift:
                    shift += r.f(1)
            size = 256 >> (2 - shift)
            uv_shift = r.f(1) if s.ssx and s.ssy and any(lr_type[1:]) else 0  # 4:2:0 only
            lr_size = [size, size >> uv_shift, size >> uv_shift]
    units = [(0, 0)] * 3
    for p in range(3):
        if lr_type[p]:
            sy, sx = (s.ssy, s.ssx) if p else (0, 0)
            # count_units_in_frame of the plane's rows and columns
            units[p] = tuple(max((((n + ss) >> ss) + (lr_size[p] >> 1)) // lr_size[p], 1)
                             for n, ss in ((height, sy), (width, sx)))
    # tx mode
    tx_mode = 0 if coded_lossless else (2 if r.f(1) else 1)
    reduced_tx_set = r.f(1)
    # an intra frame reads no global motion: film_grain_params end the header
    grain_bit = r.bit
    grain = parse_film_grain(r, s) if s.film_grain else None
    hdr[[H_WIDTH, H_HEIGHT, H_MI_COLS, H_MI_ROWS]] = width, height, mi_cols, mi_rows
    hdr[H_MONO] = s.mono
    hdr[H_USE128], hdr[H_FILTER_INTRA], hdr[H_EDGE_FILTER] = s.use128, s.filter_intra, s.edge_filter
    hdr[H_DISABLE_CDF_UPDATE], hdr[H_SCREEN_CONTENT] = disable_cdf_update, screen
    hdr[H_ALLOW_INTRABC], hdr[H_BASE_Q] = allow_intrabc, base_q
    hdr[H_DQ_Y_DC:H_DQ_V_AC + 1] = dq
    hdr[H_SEG_ENABLED], hdr[H_SEG_PRE_SKIP], hdr[H_LAST_ACTIVE_SEG] = seg_enabled, pre_skip, last_active
    hdr[H_DELTA_Q_PRESENT], hdr[H_DELTA_Q_RES] = dq_present, dq_res
    hdr[H_DELTA_LF_PRESENT], hdr[H_DELTA_LF_RES], hdr[H_DELTA_LF_MULTI] = dlf_present, dlf_res, dlf_multi
    hdr[H_TX_MODE], hdr[H_REDUCED_TX_SET] = tx_mode, reduced_tx_set
    hdr[H_LF_LEVEL0:H_LF_LEVEL0 + 4] = levels
    hdr[H_SHARPNESS], hdr[H_LF_DELTA_ENABLED] = sharpness, delta_enabled
    hdr[H_REF_DELTAS:H_REF_DELTAS + 8] = ref_deltas
    hdr[H_FEATURE_ENABLED:H_FEATURE_ENABLED + 64] = fe.reshape(-1)
    hdr[H_FEATURE_DATA:H_FEATURE_DATA + 64] = fd.reshape(-1)
    hdr[H_LOSSLESS:H_LOSSLESS + 8] = lossless
    hdr[H_USING_QM], hdr[H_QM_Y:H_QM_V + 1] = using_qm, qm
    hdr[H_CDEF_READ], hdr[H_CDEF_DAMPING], hdr[H_CDEF_BITS] = cdef_read, damping, cdef_bits
    for k, at in enumerate((H_CDEF_Y_PRI, H_CDEF_Y_SEC, H_CDEF_UV_PRI, H_CDEF_UV_SEC)):
        hdr[at:at + 8] = strengths[k]
    hdr[H_LR_TYPE:H_LR_TYPE + 3] = lr_type
    hdr[H_LR_SIZE:H_LR_SIZE + 3] = lr_size
    hdr[H_LR_ROWS:H_LR_ROWS + 3] = [u[0] for u in units]
    hdr[H_LR_COLS:H_LR_COLS + 3] = [u[1] for u in units]
    hdr[H_LR_STRIDE] = max(1, max(a * b for a, b in units))
    hdr[H_SSX], hdr[H_SSY], hdr[H_BITDEPTH] = s.ssx, s.ssy, s.bit_depth
    return {"hdr": hdr, "col_starts": col_starts, "row_starts": row_starts,
            "cols_log2": cols_log2, "rows_log2": rows_log2, "tile_size_bytes": tile_size_bytes,
            "grain": grain, "grain_bit": grain_bit}


def _grain_points(r: BitReader, g: np.ndarray, at: int, most: int, what: str) -> int:
    n = r.f(4)
    if n > most:  # dav1d rejects the header
        raise ValueError(f"AV1: film grain with {n} {what} points (at most {most})")
    for i in range(n):
        g[at + 2 * i] = r.f(8)
        if i and g[at + 2 * i] <= g[at + 2 * i - 2]:
            raise ValueError(f"AV1: film grain's {what} points do not increase")
        g[at + 2 * i + 1] = r.f(8)
    return n


def parse_film_grain(r: BitReader, s: Sequence):
    """film_grain_params (specification 5.9.30) of a shown key frame, as
    dav1d 1.5.1 reads them: None where apply_grain is clear, else the
    G_FIELDS array fd_av1_film_grain takes (update_grain is 1 for a key
    frame, so every field is read). Raises ValueError where dav1d rejects
    the header: more than 14 luma or 10 chroma points, points whose values
    do not increase, and at 4:2:0 Cb points without Cr points or the
    reverse."""
    if not r.f(1):  # apply_grain
        return None
    g = np.zeros(G_FIELDS, np.int32)
    g[G_SEED] = r.f(16)
    g[G_NUM_Y] = ny = _grain_points(r, g, G_Y_POINTS, 14, "luma")
    g[G_CSFL] = csfl = 0 if s.mono else r.f(1)
    if not (s.mono or csfl or (s.ssx and s.ssy and not ny)):
        for pl, what in enumerate(("Cb", "Cr")):
            g[G_NUM_UV + pl] = _grain_points(r, g, G_UV_POINTS + 20 * pl, 10, what)
    if s.ssx and s.ssy and bool(g[G_NUM_UV]) != bool(g[G_NUM_UV + 1]):
        raise ValueError("AV1: 4:2:0 film grain with points for one chroma plane only")
    g[G_SCALING_SHIFT] = r.f(2) + 8
    g[G_AR_LAG] = lag = r.f(2)
    num_pos = 2 * lag * (lag + 1)
    if ny:
        for i in range(num_pos):
            g[G_AR_Y + i] = r.f(8) - 128
    for pl in range(2):
        if g[G_NUM_UV + pl] or csfl:  # the luma term last, where there is luma grain
            for i in range(num_pos + int(ny > 0)):
                g[G_AR_UV + 25 * pl + i] = r.f(8) - 128
    g[G_AR_SHIFT] = r.f(2) + 6
    g[G_GRAIN_SCALE_SHIFT] = r.f(2)
    for pl in range(2):
        if g[G_NUM_UV + pl]:
            g[G_UV_MULT + pl] = r.f(8) - 128
            g[G_UV_LUMA_MULT + pl] = r.f(8) - 128
            g[G_UV_OFFSET + pl] = r.f(9) - 256
    g[G_OVERLAP] = r.f(1)
    g[G_CLIP] = r.f(1)
    g[G_SSX], g[G_SSY], g[G_MONO], g[G_BITDEPTH] = s.ssx, s.ssy, s.mono, s.bit_depth
    g[G_IS_ID] = int(s.matrix == 0)
    return g


def grain_applies(g) -> bool:
    """Whether dav1d grains a picture with these parameters (its has_grain:
    points for a plane, or chroma scaled from luma and clipped to the
    restricted range); else its output is the decoded picture."""
    return g is not None and bool(g[G_NUM_Y] or g[G_NUM_UV] or g[G_NUM_UV + 1]
                                  or (g[G_CLIP] and g[G_CSFL]))


def _tiles(data: bytes, pos: int, end: int, fh: dict) -> list:
    """(tile row, tile col, bytes) of a tile group OBU from byte `pos`."""
    ncols, nrows = len(fh["col_starts"]) - 1, len(fh["row_starts"]) - 1
    num = ncols * nrows
    r = BitReader(data, pos)
    start, last = 0, num - 1
    if num > 1 and r.f(1):
        bits = fh["cols_log2"] + fh["rows_log2"]
        start, last = r.f(bits), r.f(bits)
    r.align()
    p = r.bit >> 3
    out = []
    for t in range(start, last + 1):
        if t == last:
            size = end - p
        else:
            n = fh["tile_size_bytes"]
            if p + n > end:
                raise ValueError("AV1: a truncated tile size")
            size = int.from_bytes(data[p:p + n], "little") + 1
            p += n
        if size < 0 or p + size > end:
            raise ValueError("AV1: a tile runs past its OBU")
        out.append((t // ncols, t % ncols, data[p:p + size]))
        p += size
    return out


def _lib():
    return image_lib.load_av1()


def decode(stream: bytes, plain: bool = False, grain: bool = True, operating_point: int = 0,
           spatial_layer: int = None) -> Frame:
    """An AV1 stream (one shown key frame) to its decoded planes (with
    `grain` False, the planes before film grain; its parameters are in
    frame.grain all the same). As dav1d decodes for libavif: the OBUs with
    an extension header outside the layers of the operating point
    `operating_point` (the first where the sequence has fewer) are
    dropped; `spatial_layer` (an item's lsel) asks for a frame of that
    spatial layer, and a stream without one fails."""
    seq, fh, tiles, idc = None, None, [], 0
    for kind, layer, payload in obu_layers(stream):
        if kind == OBU_SEQUENCE_HEADER:
            seq = parse_sequence(payload)
            idc = seq.op_idc[operating_point if operating_point < len(seq.op_idc) else 0]
            continue
        if (layer is not None and idc and kind != 2  # the temporal delimiter stays
                and not ((idc >> layer[0]) & 1 and (idc >> (layer[1] + 8)) & 1)):
            continue
        if kind in (OBU_FRAME_HEADER, OBU_FRAME):
            if seq is None:
                raise ValueError("AV1: a frame before the sequence header")
            if fh is not None:
                raise refuse("more than one frame")
            r = BitReader(payload)
            fh = parse_frame_header(r, seq, layer)
            fh["spatial"] = layer[1] if layer else 0
            if kind == OBU_FRAME:
                r.align()
                tiles += _tiles(payload, r.bit >> 3, len(payload), fh)
        elif kind == OBU_TILE_GROUP:
            if fh is None:
                raise ValueError("AV1: a tile group before the frame header")
            tiles += _tiles(payload, 0, len(payload), fh)
    if fh is None:
        raise ValueError("AV1: no frame in the stream")
    if spatial_layer is not None and fh["spatial"] != spatial_layer:
        raise ValueError(f"AV1: no frame of spatial layer {spatial_layer} (libavif: Decoding of "
                         "the planes failed)")
    ncols, nrows = len(fh["col_starts"]) - 1, len(fh["row_starts"]) - 1
    if len(tiles) != ncols * nrows:
        raise ValueError("AV1: tiles missing from the frame")
    hdr = fh["hdr"]
    mi_cols, mi_rows = int(hdr[H_MI_COLS]), int(hdr[H_MI_ROWS])
    # planes of whole 128x128 superblocks: a transform block may run past
    # the frame's last 4x4
    ph, pw = (mi_rows * 4 + 127) & ~127, (mi_cols * 4 + 127) & ~127
    dtype = np.uint8 if seq.bit_depth == 8 else np.uint16
    y = np.zeros((ph, pw), dtype)
    u = v = None
    if not seq.mono:
        u = np.zeros((ph >> seq.ssy, pw >> seq.ssx), dtype)
        v = np.zeros((ph >> seq.ssy, pw >> seq.ssx), dtype)
    hdr[H_STRIDE_Y], hdr[H_STRIDE_UV] = pw, pw >> seq.ssx
    mi = np.zeros((mi_rows, mi_cols, M_FIELDS), np.int32)
    cdef = np.full(((mi_rows + 15) >> 4, (mi_cols + 15) >> 4), -1, np.int32)
    lr = np.zeros((3, int(hdr[H_LR_STRIDE]), L_FIELDS), np.int32)
    lib = _lib()
    null = ctypes.c_void_p(0)
    left = np.zeros(1, np.int64)
    trace = None
    if plain:
        trace = np.zeros(56 * y.size + (1 << 20), np.int32)
        lib.fd_av1_trace(trace.ctypes.data, trace.size)
    t0 = time.perf_counter()
    for trow, tcol, data in tiles:
        h = hdr.copy()
        h[H_ROW_START], h[H_ROW_END] = fh["row_starts"][trow], fh["row_starts"][trow + 1]
        h[H_COL_START], h[H_COL_END] = fh["col_starts"][tcol], fh["col_starts"][tcol + 1]
        buf = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
        rc = lib.fd_av1_tile(buf.ctypes.data, len(data), h.ctypes.data, y.ctypes.data,
                             u.ctypes.data if u is not None else null,
                             v.ctypes.data if v is not None else null, mi.ctypes.data,
                             left.ctypes.data, cdef.ctypes.data, lr.ctypes.data)
        if rc < 0:
            raise ValueError(f"AV1: {ERRORS.get(rc, rc)}")
        if left[0] < OVERREAD:
            raise ValueError("AV1: a tile's symbols run past its data")
    lib.fd_av1_deblock(hdr.ctypes.data, y.ctypes.data, u.ctypes.data if u is not None else null,
                       v.ctypes.data if v is not None else null, mi.ctypes.data)

    def ptrs(planes):
        return [p.ctypes.data if p is not None else null for p in planes]

    t1 = time.perf_counter()
    deblocked = (y, u, v)
    planes = deblocked
    if (cdef >= 0).any():
        planes = tuple(p.copy() if p is not None else None for p in deblocked)
        lib.fd_av1_cdef(hdr.ctypes.data, *ptrs(deblocked), *ptrs(planes), mi.ctypes.data,
                        cdef.ctypes.data)
    t2 = time.perf_counter()
    if hdr[H_LR_TYPE:H_LR_TYPE + 3].any():
        out = tuple(p.copy() if p is not None else None for p in planes)
        lib.fd_av1_lr(hdr.ctypes.data, *ptrs(deblocked), *ptrs(planes), *ptrs(out),
                      lr.ctypes.data)
        planes = out
    t3 = time.perf_counter()
    width, height = int(hdr[H_WIDTH]), int(hdr[H_HEIGHT])
    if grain and grain_applies(fh["grain"]):
        planes = film_grain(planes, width, height, fh["grain"], plain)
    t4 = time.perf_counter()
    frame = Frame(planes, width, height, seq.full_range, seq.matrix, seq.mono, seq.ssx, seq.ssy,
                  seq.primaries, seq.bit_depth, seq.transfer)
    frame.mi, frame.cdef, frame.lr = mi, cdef, lr
    frame.grain = fh["grain"]
    frame.ms = {"tiles + loop filter": (t1 - t0) * 1e3, "cdef": (t2 - t1) * 1e3,
                "loop restoration": (t3 - t2) * 1e3, "film grain": (t4 - t3) * 1e3}
    if plain:
        n = lib.fd_av1_trace(null, 0)
        if n < 0:
            raise RuntimeError("AV1: the stage trace overflowed")
        frame.checked = check_trace(trace[:n])
    return frame


def scale(plane: np.ndarray, width: int, height: int, dw: int, dh: int,
          plain: bool = False) -> np.ndarray:
    """The top-left width x height of a decoded plane scaled to dw x dh as
    libavif scales a frame to its item's ispe (fd_av1_scale; uint16 planes
    as libyuv's ScalePlane_16)."""
    src = np.ascontiguousarray(plane[:height, :width])
    out = np.zeros((dh, dw), src.dtype)
    rc = _lib().fd_av1_scale(src.ctypes.data, width, width, height, out.ctypes.data, dw, dw, dh,
                             src.itemsize)
    if rc == SCALE_RATIO:
        raise refuse(f"an AV1 frame of another size than ispe ({width}x{height} to {dw}x{dh}, "
                     "libyuv's 3/4 or 3/8 filter)")
    if rc < 0:
        raise ValueError(f"AV1: {ERRORS.get(rc, rc)}")
    if plain and not np.array_equal(out, scale_plain(src, dw, dh)):
        raise RuntimeError("fd_av1_scale differs from scale_plain")
    return out


def film_grain(planes, width: int, height: int, grain: np.ndarray, plain: bool = False) -> tuple:
    """A decoded frame's planes (Y, U, V or None) with film grain, as
    dav1d 1.5.1 grains a picture before libavif receives it
    (fd_av1_film_grain over the width x height samples; a plane without
    grain is a copy). `plain` holds the result to film_grain_plain."""
    dtype = np.uint8 if grain[G_BITDEPTH] == 8 else np.uint16
    for k, p in enumerate(planes[:1 if grain[G_MONO] else 3]):
        sx, sy = (int(grain[G_SSX]), int(grain[G_SSY])) if k else (0, 0)
        if (p is None or p.dtype != dtype or not p.flags.c_contiguous
                or p.shape[0] < (height + sy) >> sy or p.shape[1] < (width + sx) >> sx):
            raise ValueError(f"AV1: {ERRORS[-2]}")
    out = tuple(p.copy() if p is not None else None for p in planes)
    null = ctypes.c_void_p(0)

    def ptr(p):
        return p.ctypes.data if p is not None else null

    y, u, _v = planes
    rc = _lib().fd_av1_film_grain(grain.ctypes.data, width, height, *(ptr(p) for p in planes),
                                  y.shape[1], u.shape[1] if u is not None else 0,
                                  *(ptr(p) for p in out), null, null)
    if rc < 0:
        raise ValueError(f"AV1: {ERRORS.get(rc, rc)}")
    if plain:
        want = film_grain_plain(planes, width, height, grain)
        if not all(np.array_equal(a, b) for a, b in zip(out, want)):
            raise RuntimeError("fd_av1_film_grain differs from film_grain_plain")
    return out


# the conversion as fd_av1_to_rgb takes it (C_* there)
(C_ROUTE, C_SSX, C_SSY, C_FULL, C_MODE, C_KR, C_KB, C_YG, C_YB, C_UB, C_UG, C_VG, C_VR, C_DEPTH,
 C_DOWN, C_NEAREST, C_ALPHA_ROUND, C_FIELDS) = range(18)
ROUTE_LIBYUV, ROUTE_FLOAT = 0, 1
MODE_YUV, MODE_IDENTITY, MODE_YCGCO, MODE_YCGCO_RE = 0, 1, 2, 3
# libyuv's YuvConstants (row_common.cc) that libavif 1.3.0 picks: YG, YB,
# UB, UG, VG, VR of full-range BT.601 (JPEG), BT.709 and BT.2020, then of
# the limited ranges (UB capped at 128 there)
LIBYUV_CONSTANTS = {
    (1, "601"): (16320, 32, 113, 22, 46, 90), (1, "709"): (16320, 32, 119, 12, 30, 101),
    (1, "2020"): (16320, 32, 120, 11, 37, 94), (0, "601"): (18997, -1160, 128, 25, 52, 102),
    (0, "709"): (18997, -1160, 128, 14, 34, 115), (0, "2020"): (19003, -1160, 128, 12, 42, 107)}
# the matrices libyuv converts (getLibYUVConstants): BT.709, BT.601 (2, 5, 6)
# and BT.2020 NCL; 12 (chroma-derived NCL) by its primaries
LIBYUV_MATRIX = {1: "709", 2: "601", 5: "601", 6: "601", 9: "2020"}
LIBYUV_PRIMARIES = {1: "709", 2: "709", 5: "601", 6: "601", 9: "2020"}
# the matrices libavif converts at 8 bits (0 identity in 4:4:4 and 4:0:0
# only, 8 YCgCo at full range only; 15 takes its default kr and kb), and
# 16 (YCgCo-Re) of 10-bit full-range samples only, whose RGB has two bits
# fewer; its own kr, kb of the matrices that reach its float conversion
CONVERTED = {0, 1, 2, 4, 5, 6, 7, 8, 9, 12, 15}
YCGCO_RE = 16
KR_KB = {4: (0.30, 0.11), 7: (0.212, 0.087)}
KR_KB_DEFAULT = (0.299, 0.114)
# libavif's colour primaries (avifColorPrimariesGetValues: x, y of red,
# green, blue and white), BT.709's for any value not listed
PRIMARIES_XY = {
    4: (0.67, 0.33, 0.21, 0.71, 0.14, 0.08, 0.310, 0.316),
    5: (0.64, 0.33, 0.29, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    6: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    7: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    8: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049, 0.310, 0.316),
    9: (0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.3290),
    10: (1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.3333, 0.3333),
    11: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.314, 0.351),
    12: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.3127, 0.3290),
    22: (0.630, 0.340, 0.295, 0.605, 0.155, 0.077, 0.3127, 0.3290)}
BT709_XY = (0.64, 0.33, 0.3, 0.6, 0.15, 0.06, 0.3127, 0.329)


def kr_kb_from_primaries(primaries: int) -> tuple:
    """kr and kb (float32) of matrix 12 from the primaries, as libavif's
    calcYUVInfoFromCICP computes them (H.273 equations 32-37)."""
    rX, rY, gX, gY, bX, bY, wX, wY = (np.float32(v) for v in PRIMARIES_XY.get(primaries, BT709_XY))
    one = np.float32(1)
    rZ, gZ, bZ, wZ = one - (rX + rY), one - (gX + gY), one - (bX + bY), one - (wX + wY)
    den = wY * (rX * (gY * bZ - bY * gZ) + gX * (bY * rZ - rY * bZ) + bX * (rY * gZ - gY * rZ))
    kr = (rY * (wX * (gY * bZ - bY * gZ) + wY * (bX * gZ - gX * bZ) + wZ * (gX * bY - bX * gY))) / den
    kb = (bY * (wX * (rY * gZ - gY * rZ) + wY * (gX * rZ - rX * gZ) + wZ * (rX * gY - gX * rY))) / den
    return np.float32(kr), np.float32(kb)


def conversion(mono: int, ssx: int, ssy: int, full_range: int, matrix: int, primaries: int,
               alpha: bool, depth: int = 8) -> np.ndarray:
    """The YUV -> RGB conversion libavif 1.3.0's avifImageYUVToRGB makes for
    PIL (8-bit RGBA where the image has alpha, else RGB) as fd_av1_to_rgb
    takes it: libyuv's fixed point where getLibYUVConstants finds constants
    (colour, and 4:0:0 at limited range with alpha), else libavif's float
    conversion. At 10 and 12 bits, where libyuv has constants: its
    high-bit-depth functions where it has one for the case (10-bit colour
    with alpha, I010 / I210 / I410AlphaToARGBMatrixFilter: alpha >> 2;
    12-bit 4:2:0, I012ToARGBMatrix: each chroma sample for its 2x2, and
    libavif's rounded alpha), else the planes brought to 8 bits
    (Convert16To8Plane) and converted as an 8-bit image (a monochrome one
    with libavif's rounded alpha); a monochrome image without alpha and the
    matrices without constants take libavif's float conversion at the bit
    depth. Raises ValueError where libavif fails ("Reformat failed" in
    PIL)."""
    ycgco_re = matrix == YCGCO_RE and full_range and depth == 10
    if ((matrix not in CONVERTED and not ycgco_re) or (matrix == 8 and not full_range)
            or (matrix == 0 and not mono and (ssx or ssy))):
        raise ValueError(f"AVIF: libavif converts no {'full' if full_range else 'limited'}-range "
                         f"YUV of matrix coefficients {matrix} here (Reformat failed)")
    conv = np.zeros(C_FIELDS, np.int32)
    conv[C_SSX], conv[C_SSY], conv[C_FULL] = ssx, ssy, int(bool(full_range))
    m = 6 if (mono and matrix == 0) else matrix  # libavif's BT.601 for 4:0:0 identity
    family = LIBYUV_PRIMARIES.get(primaries) if m == 12 else LIBYUV_MATRIX.get(m)
    conv[C_DEPTH] = depth
    if depth > 8 and family and (not mono or alpha):
        conv[C_DOWN] = int(bool(mono or not alpha or (depth == 12 and not (ssx and ssy))))
        conv[C_NEAREST] = int(not conv[C_DOWN] and depth == 12)
        conv[C_ALPHA_ROUND] = int(bool(mono or conv[C_NEAREST]))
    elif depth > 8:
        conv[C_ALPHA_ROUND] = 1
    if family and (not mono or (alpha and not full_range)):
        conv[C_ROUTE] = ROUTE_LIBYUV
        conv[C_YG:C_VR + 1] = LIBYUV_CONSTANTS[(int(bool(full_range)), family)]
        return conv
    conv[C_ROUTE] = ROUTE_FLOAT
    conv[C_MODE] = {0: MODE_IDENTITY, 8: MODE_YCGCO, YCGCO_RE: MODE_YCGCO_RE}.get(matrix, MODE_YUV)
    kr, kb = kr_kb_from_primaries(primaries) if matrix == 12 else KR_KB.get(matrix, KR_KB_DEFAULT)
    conv[C_KR:C_KB + 1] = np.array([kr, kb], np.float32).view(np.int32)
    return conv


def to_rgba(frame: Frame, alpha, full_range: int, matrix: int, primaries: int = 2,
            plain: bool = False) -> np.ndarray:
    """A decoded colour frame (and alpha plane) to RGBA as libavif converts
    it for PIL."""
    conv = conversion(frame.mono, frame.ssx, frame.ssy, full_range, matrix, primaries,
                      alpha is not None, frame.bit_depth)
    w, h = frame.width, frame.height
    y, u, v = frame.planes
    out = np.zeros((h, w, 4), np.uint8)
    lib = _lib()
    a = np.ascontiguousarray(alpha) if alpha is not None else None
    null = ctypes.c_void_p(0)
    rc = lib.fd_av1_to_rgb(y.ctypes.data, y.shape[1], u.ctypes.data if u is not None else null,
                           v.ctypes.data if v is not None else null,
                           u.shape[1] if u is not None else 0,
                           a.ctypes.data if a is not None else null,
                           a.shape[1] if a is not None else 0, w, h, conv.ctypes.data,
                           out.ctypes.data)
    if rc < 0:
        raise ValueError(f"AV1: {ERRORS.get(rc, rc)}")
    if plain:
        want = to_rgba_plain(y, u, v, a, w, h, conv)
        if not np.array_equal(want, out):
            raise RuntimeError("fd_av1_to_rgb differs from to_rgba_plain")
    return out


def alpha_range(plane: np.ndarray, width: int, height: int, bit_depth: int,
                plain: bool = False) -> np.ndarray:
    """A copy of a limited-range alpha plane with its width x height
    samples expanded to full range as libavif 1.3.0 expands them
    (fd_av1_alpha_range); `plain` holds it to alpha_range_plain."""
    out = np.ascontiguousarray(plane).copy()
    if out.dtype != (np.uint8 if bit_depth == 8 else np.uint16) or out.shape[0] < height \
            or out.shape[1] < width:
        raise ValueError(f"AV1: {ERRORS[-2]}")
    rc = _lib().fd_av1_alpha_range(out.ctypes.data, out.shape[1], width, height, bit_depth)
    if rc < 0:
        raise ValueError(f"AV1: {ERRORS.get(rc, rc)}")
    if plain and not np.array_equal(out, alpha_range_plain(plane, width, height, bit_depth)):
        raise RuntimeError("fd_av1_alpha_range differs from alpha_range_plain")
    return out


def unattenuate(rgba: np.ndarray, plain: bool = False) -> np.ndarray:
    """(h, w, 4) uint8 premultiplied RGBA to straight alpha, a new array, as
    libavif 1.3.0 unpremultiplies it for PIL (fd_av1_unattenuate); `plain`
    holds it to unattenuate_plain."""
    if rgba.dtype != np.uint8 or rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"AV1: {ERRORS[-2]}")
    out = np.ascontiguousarray(rgba).copy()
    rc = _lib().fd_av1_unattenuate(out.ctypes.data, out.size // 4)
    if rc < 0:
        raise ValueError(f"AV1: {ERRORS.get(rc, rc)}")
    if plain and not np.array_equal(out, unattenuate_plain(rgba)):
        raise RuntimeError("fd_av1_unattenuate differs from unattenuate_plain")
    return out


# --------------------------------------------------------------- plain twins

def _round2(x, n: int):
    return x if n == 0 else (x + (1 << (n - 1))) >> n


def _cos128(angle: int) -> int:
    def look(i):
        return 0 if i == 64 else int(T.COS128[i])
    a = angle & 255
    if a <= 64:
        return look(a)
    if a <= 128:
        return -look(128 - a)
    if a <= 192:
        return -look(a - 128)
    return look(256 - a)


def _sin128(angle: int) -> int:
    return _cos128(angle - 64)


def _brev(n: int, x: int) -> int:
    return int(format(x, f"0{n}b")[::-1], 2)


class _Lanes:
    """The specification's 1D transform array T over a batch of lanes:
    t[i] is an int64 vector (one value a lane)."""

    def __init__(self, t: np.ndarray, r: int):
        self.t, self.r = t, r

    def clamp(self, v):
        return np.clip(v, -(1 << (self.r - 1)), (1 << (self.r - 1)) - 1)

    def B(self, a, b, angle, flip):
        t = self.t
        x = t[a] * _cos128(angle) - t[b] * _sin128(angle)
        y = t[a] * _sin128(angle) + t[b] * _cos128(angle)
        t[a], t[b] = _round2(x, 12), _round2(y, 12)
        if flip:
            t[[a, b]] = t[[b, a]]

    def H(self, a, b, flip):
        if flip:
            a, b = b, a
        t = self.t
        x, y = t[a].copy(), t[b].copy()
        t[a], t[b] = self.clamp(x + y), self.clamp(x - y)


def _dct_plain(L: _Lanes, n: int) -> None:
    L.t[: 1 << n] = L.t[[_brev(n, i) for i in range(1 << n)]]
    B, H = L.B, L.H
    if n == 6:
        for i in range(16):
            B(32 + i, 63 - i, 63 - 4 * _brev(4, i), 0)
    if n >= 5:
        for i in range(8):
            B(16 + i, 31 - i, 6 + (_brev(3, 7 - i) << 3), 0)
    if n == 6:
        for i in range(16):
            H(32 + i * 2, 33 + i * 2, i & 1)
    if n >= 4:
        for i in range(4):
            B(8 + i, 15 - i, 12 + (_brev(2, 3 - i) << 4), 0)
    if n >= 5:
        for i in range(8):
            H(16 + 2 * i, 17 + 2 * i, i & 1)
    if n == 6:
        for i in range(4):
            for j in range(2):
                B(62 - i * 4 - j, 33 + i * 4 + j, 60 - 16 * _brev(2, i) + 64 * j, 1)
    if n >= 3:
        for i in range(2):
            B(4 + i, 7 - i, 56 - 32 * i, 0)
    if n >= 4:
        for i in range(4):
            H(8 + 2 * i, 9 + 2 * i, i & 1)
    if n >= 5:
        for i in range(2):
            for j in range(2):
                B(30 - 4 * i - j, 17 + 4 * i + j, 24 + (j << 6) + ((1 - i) << 5), 1)
    if n == 6:
        for i in range(8):
            for j in range(2):
                H(32 + i * 4 + j, 35 + i * 4 - j, i & 1)
    for i in range(2):
        B(2 * i, 1 + 2 * i, 32 + 16 * i, 1 - i)
    if n >= 3:
        for i in range(2):
            H(4 + 2 * i, 5 + 2 * i, i)
    if n >= 4:
        for i in range(2):
            B(14 - i, 9 + i, 48 + 64 * i, 1)
    if n >= 5:
        for i in range(4):
            for j in range(2):
                H(16 + 4 * i + j, 19 + 4 * i - j, i & 1)
    if n == 6:
        for i in range(2):
            for j in range(4):
                B(61 - i * 8 - j, 34 + i * 8 + j, 56 - i * 32 + (j >> 1) * 64, 1)
    for i in range(2):
        H(i, 3 - i, 0)
    if n >= 3:
        B(6, 5, 32, 1)
    if n >= 4:
        for i in range(2):
            for j in range(2):
                H(8 + 4 * i + j, 11 + 4 * i - j, i)
    if n >= 5:
        for i in range(4):
            B(29 - i, 18 + i, 48 + (i >> 1) * 64, 1)
    if n == 6:
        for i in range(4):
            for j in range(4):
                H(32 + 8 * i + j, 39 + 8 * i - j, i & 1)
    if n >= 3:
        for i in range(4):
            H(i, 7 - i, 0)
    if n >= 4:
        for i in range(2):
            B(13 - i, 10 + i, 32, 1)
    if n >= 5:
        for i in range(2):
            for j in range(4):
                H(16 + i * 8 + j, 23 + i * 8 - j, i)
    if n == 6:
        for i in range(8):
            B(59 - i, 36 + i, 48 if i < 4 else 112, 1)
    if n >= 4:
        for i in range(8):
            H(i, 15 - i, 0)
    if n >= 5:
        for i in range(4):
            B(27 - i, 20 + i, 32, 1)
    if n == 6:
        for i in range(8):
            H(32 + i, 47 - i, 0)
        for i in range(8):
            H(48 + i, 63 - i, 1)
    if n >= 5:
        for i in range(16):
            H(i, 31 - i, 0)
    if n == 6:
        for i in range(8):
            B(55 - i, 40 + i, 32, 1)
        for i in range(32):
            H(i, 63 - i, 0)


def _adst_plain(L: _Lanes, n: int) -> None:
    t = L.t
    if n == 2:
        s = [int(v) for v in T.SINPI]
        s0, s1, s2 = s[1] * t[0], s[2] * t[0], s[3] * t[1]
        s3, s4, s5, s6 = s[4] * t[2], s[1] * t[2], s[2] * t[3], s[4] * t[3]
        b7 = t[0] - t[2] + t[3]
        s0, s1 = s0 + s3 + s5, s1 - s4 - s6
        s3, s2 = s2, s[3] * b7
        x0, x1, x2, x3 = s0 + s3, s1 + s3, s2, s0 + s1 - s3
        t[0], t[1], t[2], t[3] = (_round2(x, 12) for x in (x0, x1, x2, x3))
        return
    n0 = 1 << n
    t[:n0] = t[[(i - 1) if i & 1 else (n0 - i - 1) for i in range(n0)]]
    B, H = L.B, L.H
    if n == 3:
        for i in range(4):
            B(2 * i, 1 + 2 * i, 60 - 16 * i, 1)
        for i in range(4):
            H(i, 4 + i, 0)
        for i in range(2):
            B(4 + 3 * i, 5 + i, 48 - 32 * i, 1)
        for i in range(2):
            for j in range(2):
                H(4 * j + i, 2 + 4 * j + i, 0)
        for i in range(2):
            B(2 + 4 * i, 3 + 4 * i, 32, 1)
    else:
        for i in range(8):
            B(2 * i, 1 + 2 * i, 62 - 8 * i, 1)
        for i in range(8):
            H(i, 8 + i, 0)
        for i in range(2):
            B(8 + 2 * i, 9 + 2 * i, 56 - 32 * i, 1)
            B(13 + 2 * i, 12 + 2 * i, 8 + 32 * i, 1)
        for i in range(4):
            for j in range(2):
                H(8 * j + i, 4 + 8 * j + i, 0)
        for i in range(2):
            for j in range(2):
                B(4 + 8 * j + 3 * i, 5 + 8 * j + i, 48 - 32 * i, 1)
        for i in range(2):
            for j in range(4):
                H(4 * j + i, 2 + 4 * j + i, 0)
        for i in range(4):
            B(2 + 4 * i, 3 + 4 * i, 32, 1)
    out = t[:n0].copy()
    for i in range(n0):
        a, b = (i >> 3) & 1, ((i >> 2) & 1) ^ ((i >> 3) & 1)
        c, d = ((i >> 1) & 1) ^ ((i >> 2) & 1), (i & 1) ^ ((i >> 1) & 1)
        idx = ((d << 3) | (c << 2) | (b << 1) | a) >> (4 - n)
        out[i] = -t[idx] if i & 1 else t[idx]
    t[:n0] = out


def _identity_plain(L: _Lanes, n: int) -> None:
    t = L.t[: 1 << n]
    if n == 2:
        L.t[: 1 << n] = _round2(t * 5793, 12)
    elif n == 3:
        L.t[: 1 << n] = t * 2
    elif n == 4:
        L.t[: 1 << n] = _round2(t * 11586, 12)
    else:
        L.t[: 1 << n] = t * 4


def _wht_plain(t: np.ndarray, shift: int) -> None:
    a, c, d, b = (t[k] >> shift for k in range(4))
    a = a + c
    d = d - b
    e = (a - d) >> 1
    b = e - b
    c = e - c
    a = a - b
    d = d + c
    t[0], t[1], t[2], t[3] = a, b, c, d


TX_W = (4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64)
TX_H = (4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16)
ROW_SHIFT = (0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2)
# 1D types of each 2D type: 0 DCT, 1 ADST, 2 flipped ADST, 3 identity
COL_TYPE = (0, 1, 0, 1, 2, 0, 2, 1, 2, 3, 0, 3, 1, 3, 2, 3)
ROW_TYPE = (0, 0, 1, 1, 0, 2, 2, 2, 1, 3, 3, 0, 3, 1, 3, 2)


def _run_1d(L: _Lanes, kind: int, n: int) -> None:
    if kind == 0:
        _dct_plain(L, n)
    elif kind == 3:
        _identity_plain(L, n)
    else:
        _adst_plain(L, n)


def inv_txfm_plain(deq: np.ndarray, tx: int, tx_type: int, lossless: int,
                   bit_depth: int = 8) -> np.ndarray:
    """The 2D inverse transform of csrc's inverse_transform: deq is the
    64 x 64 Dequant (rows and columns past 32 zero), the result h x w; the
    rows clamp at bit_depth + 8 bits, the columns at Max(bit_depth + 6, 16)."""
    w, h = TX_W[tx], TX_H[tx]
    lw, lh = w.bit_length() - 1, h.bit_length() - 1
    row_shift, col_shift = (0, 0) if lossless else (ROW_SHIFT[tx], 4)
    t = np.zeros((64, h), np.int64)  # lanes are the rows
    t[: min(w, 32), : min(h, 32)] = deq[: min(h, 32), : min(w, 32)].T
    rt, ct = ROW_TYPE[tx_type], COL_TYPE[tx_type]
    if lossless:
        _wht_plain(t, 2)
    else:
        if abs(lw - lh) == 1:
            t[:w] = _round2(t[:w] * 2896, 12)
        L = _Lanes(t, bit_depth + 8)
        t[:w] = L.clamp(t[:w])
        _run_1d(L, rt, lw)
    col_clamp = max(bit_depth + 6, 16)
    rows = _round2(t[:w], row_shift).T  # h x w
    if rt == 2:
        rows = rows[:, ::-1]
    if not lossless:
        rows = np.clip(rows, -(1 << (col_clamp - 1)), (1 << (col_clamp - 1)) - 1)
    c = np.zeros((64, w), np.int64)  # lanes are the columns
    c[:h] = rows
    if lossless:
        _wht_plain(c, 0)
    else:
        _run_1d(_Lanes(c, col_clamp), ct, lh)
    out = _round2(c[:h], col_shift)
    if ct == 2:
        out = out[::-1]
    return out.astype(np.int32)


SM_OFFSET = {2: 0, 3: 4, 4: 12, 5: 28, 6: 60}


def _edge_strength(w, h, filter_type, delta):
    d, wh = abs(delta), w + h
    if filter_type == 0:
        table = ((8, ((56, 1),)), (12, ((40, 1),)), (16, ((40, 1),)),
                 (24, ((8, 1), (16, 2), (32, 3))), (32, ((1, 1), (4, 2), (32, 3))))
        last = ((1, 3),)
    else:
        table = ((8, ((40, 1), (64, 2))), (16, ((20, 1), (48, 2))), (24, ((4, 3),)))
        last = ((1, 3),)
    steps = last
    for limit, st in table:
        if wh <= limit:
            steps = st
            break
    strength = 0
    for thr, v in steps:
        if d >= thr:
            strength = v
    return strength


def _edge_filter(e: dict, sz: int, strength: int) -> None:
    if strength == 0:
        return
    edge = [e[i - 1] for i in range(sz)]
    k = T.INTRA_EDGE_KERNEL.reshape(3, 5)[strength - 1]
    for i in range(1, sz):
        s = sum(int(k[j]) * edge[min(max(i - 2 + j, 0), sz - 1)] for j in range(5))
        e[i - 1] = (s + 8) >> 4


def _upsample(e: dict, num: int, bit_depth: int) -> None:
    dup = [0] * (num + 3)
    dup[0] = e[-1]
    for i in range(-1, num):
        dup[i + 2] = e[i]
    dup[num + 2] = e[num - 1]
    e[-2] = dup[0]
    for i in range(num):
        s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3]
        e[2 * i - 1] = min(max(_round2(s, 4), 0), (1 << bit_depth) - 1)
        e[2 * i] = dup[i + 2]


def _samples(bit_depth: int):
    return np.uint8 if bit_depth == 8 else np.uint16


def predict_plain(params, above, left, bit_depth: int = 8) -> np.ndarray:
    """csrc's predict: params as fd_av1_predict takes them, above / left
    with the corner first; the prediction h x w (uint8 at 8 bits, else
    uint16)."""
    (mode, lw, lh, have_left, have_above, angle_delta, filter_type, edge_filter,
     use_filter, filter_mode, above_limit, left_limit) = (int(v) for v in params)
    w, h = 1 << lw, 1 << lh
    peak = (1 << bit_depth) - 1
    A = {i - 1: int(v) for i, v in enumerate(above)}
    Lf = {i - 1: int(v) for i, v in enumerate(left)}
    pred = np.zeros((h, w), np.int64)
    if use_filter:
        taps = T.FILTER_INTRA_TAPS.reshape(5, 8, 8)[filter_mode]
        for i2 in range(h >> 1):
            for j4 in range(w >> 2):
                p = []
                for i in range(7):
                    if i < 5:
                        if i2 == 0:
                            p.append(A[(j4 << 2) + i - 1])
                        elif j4 == 0 and i == 0:
                            p.append(Lf[(i2 << 1) - 1])
                        else:
                            p.append(int(pred[(i2 << 1) - 1, (j4 << 2) + i - 1]))
                    elif j4 == 0:
                        p.append(Lf[(i2 << 1) + i - 5])
                    else:
                        p.append(int(pred[(i2 << 1) + i - 5, (j4 << 2) - 1]))
                for i in range(8):
                    pr = sum(int(taps[i, j]) * p[j] for j in range(7))
                    v = _round2(pr, 4) if pr >= 0 else -_round2(-pr, 4)
                    pred[(i2 << 1) + (i >> 2), (j4 << 2) + (i & 3)] = min(max(v, 0), peak)
        return pred.astype(_samples(bit_depth))
    if 1 <= mode <= 8:
        p_angle = int(T.MODE_TO_ANGLE[mode]) + angle_delta * 3
        up_a = up_l = 0
        if edge_filter:
            if p_angle not in (90, 180):
                if 90 < p_angle < 180 and w + h >= 24:
                    A[-1] = Lf[-1] = _round2(Lf[0] * 5 + A[-1] * 6 + A[0] * 5, 4)
                if have_above:
                    _edge_filter(A, min(w, above_limit) + (h if p_angle < 90 else 0) + 1,
                                 _edge_strength(w, h, filter_type, p_angle - 90))
                if have_left:
                    _edge_filter(Lf, min(h, left_limit) + (w if p_angle > 180 else 0) + 1,
                                 _edge_strength(w, h, filter_type, p_angle - 180))

            def ups(delta):
                d = abs(delta)
                if d <= 0 or d >= 40:
                    return 0
                return int(w + h <= (16 if filter_type == 0 else 8))
            up_a = ups(p_angle - 90)
            if up_a:
                _upsample(A, w + (h if p_angle < 90 else 0), bit_depth)
            up_l = ups(p_angle - 180)
            if up_l:
                _upsample(Lf, h + (w if p_angle > 180 else 0), bit_depth)
        dr = T.DR_INTRA_DERIVATIVE
        dx = int(dr[p_angle]) if p_angle < 90 else (int(dr[180 - p_angle]) if 90 < p_angle < 180 else 0)
        dy = int(dr[p_angle - 90]) if 90 < p_angle < 180 else (int(dr[270 - p_angle]) if p_angle > 180 else 0)
        for i in range(h):
            for j in range(w):
                if p_angle < 90:
                    idx = (i + 1) * dx
                    base = (idx >> (6 - up_a)) + (j << up_a)
                    shift = ((idx << up_a) >> 1) & 0x1F
                    max_base = (w + h - 1) << up_a
                    v = (_round2(A[base] * (32 - shift) + A[base + 1] * shift, 5)
                         if base < max_base else A[max_base])
                elif 90 < p_angle < 180:
                    idx = (j << 6) - (i + 1) * dx
                    base = idx >> (6 - up_a)
                    if base >= -(1 << up_a):
                        shift = ((idx << up_a) >> 1) & 0x1F
                        v = _round2(A[base] * (32 - shift) + A[base + 1] * shift, 5)
                    else:
                        idx = (i << 6) - (j + 1) * dy
                        base = idx >> (6 - up_l)
                        shift = ((idx << up_l) >> 1) & 0x1F
                        v = _round2(Lf[base] * (32 - shift) + Lf[base + 1] * shift, 5)
                elif p_angle > 180:
                    idx = (j + 1) * dy
                    base = (idx >> (6 - up_l)) + (i << up_l)
                    shift = ((idx << up_l) >> 1) & 0x1F
                    v = _round2(Lf[base] * (32 - shift) + Lf[base + 1] * shift, 5)
                elif p_angle == 90:
                    v = A[j]
                else:
                    v = Lf[i]
                pred[i, j] = v
        return pred.astype(_samples(bit_depth))
    a = np.array([A[j] for j in range(w)], np.int64)
    lc = np.array([Lf[i] for i in range(h)], np.int64)
    sw = T.SM_WEIGHTS.astype(np.int64)
    wx, wy = sw[SM_OFFSET[lw]:SM_OFFSET[lw] + w], sw[SM_OFFSET[lh]:SM_OFFSET[lh] + h]
    if mode == 9:
        pred = _round2(wy[:, None] * a[None, :] + (256 - wy[:, None]) * lc[h - 1]
                       + wx[None, :] * lc[:, None] + (256 - wx[None, :]) * a[w - 1], 9)
    elif mode == 10:
        pred = _round2(wy[:, None] * a[None, :] + (256 - wy[:, None]) * lc[h - 1], 8) + 0 * wx[None, :]
    elif mode == 11:
        pred = _round2(wx[None, :] * lc[:, None] + (256 - wx[None, :]) * a[w - 1], 8) + 0 * wy[:, None]
    elif mode == 0:
        if have_left and have_above:
            avg = (int(a.sum() + lc.sum()) + ((w + h) >> 1)) // (w + h)
        elif have_left:
            avg = min(max((int(lc.sum()) + (h >> 1)) >> lh, 0), peak)
        elif have_above:
            avg = min(max((int(a.sum()) + (w >> 1)) >> lw, 0), peak)
        else:
            avg = 1 << (bit_depth - 1)
        pred = np.full((h, w), avg, np.int64)
    else:
        base = a[None, :] + lc[:, None] - A[-1]
        pl, pt, ptl = np.abs(base - lc[:, None]), np.abs(base - a[None, :]), np.abs(base - A[-1])
        pred = np.where((pl <= pt) & (pl <= ptl), lc[:, None] + 0 * a[None, :],
                        np.where(pt <= ptl, a[None, :] + 0 * lc[:, None], A[-1]))
    return pred.astype(_samples(bit_depth))


def cfl_plain(L: np.ndarray, alpha: int, pred: np.ndarray, bit_depth: int = 8) -> np.ndarray:
    """CfL on a DC prediction from the averaged luma L (h x w)."""
    h, w = pred.shape
    L = L.astype(np.int64)
    avg = _round2(int(L.sum()), (w.bit_length() - 1) + (h.bit_length() - 1))
    x = alpha * (L - avg)
    scaled = np.where(x >= 0, _round2(x, 6), -_round2(-x, 6))
    return np.clip(pred.astype(np.int64) + scaled, 0, (1 << bit_depth) - 1).astype(_samples(bit_depth))


def lf_edge_plain(s: np.ndarray, params, bit_depth: int = 8) -> np.ndarray:
    """csrc's lf_sample on a batch: s is (K, 16) with q0 at column 8; the
    limits (given at 8 bits) and the flatness threshold scale by
    bit_depth - 8, the narrow filter's lanes are bit_depth bits."""
    size, plane, limit, blimit, thresh = (int(v) for v in params)
    shift = bit_depth - 8
    limit, blimit, thresh, one = limit << shift, blimit << shift, thresh << shift, 1 << shift
    s = s.astype(np.int64).copy()
    q = [s[:, 8 + k] for k in range(8)]
    p = [s[:, 7 - k] for k in range(8)]
    hev = (np.abs(p[1] - p[0]) > thresh) | (np.abs(q[1] - q[0]) > thresh)
    length = 4 if size == 4 else (6 if plane else (8 if size == 8 else 16))
    mask = ((np.abs(p[1] - p[0]) <= limit) & (np.abs(q[1] - q[0]) <= limit)
            & (np.abs(p[0] - q[0]) * 2 + np.abs(p[1] - q[1]) // 2 <= blimit))
    if length >= 6:
        mask &= (np.abs(p[2] - p[1]) <= limit) & (np.abs(q[2] - q[1]) <= limit)
    if length >= 8:
        mask &= (np.abs(p[3] - p[2]) <= limit) & (np.abs(q[3] - q[2]) <= limit)
    flat = np.zeros_like(mask)
    flat2 = np.zeros_like(mask)
    if size >= 8:
        flat = ((np.abs(p[1] - p[0]) <= one) & (np.abs(q[1] - q[0]) <= one)
                & (np.abs(p[2] - p[0]) <= one) & (np.abs(q[2] - q[0]) <= one))
        if length >= 8:
            flat &= (np.abs(p[3] - p[0]) <= one) & (np.abs(q[3] - q[0]) <= one)
    if size >= 16:
        flat2 = np.ones_like(mask)
        for k in (4, 5, 6):
            flat2 &= (np.abs(p[k] - p[0]) <= one) & (np.abs(q[k] - q[0]) <= one)
    out = s.copy()
    narrow = mask & ((size == 4) | ~flat)

    def c(v):
        return np.clip(v, -(1 << (bit_depth - 1)), (1 << (bit_depth - 1)) - 1)
    mid = 0x80 << shift
    ps1, ps0, qs0, qs1 = p[1] - mid, p[0] - mid, q[0] - mid, q[1] - mid
    f = np.where(hev, c(ps1 - qs1), 0)
    f = c(f + 3 * (qs0 - ps0))
    f1, f2 = c(f + 4) >> 3, c(f + 3) >> 3
    oq0, op0 = c(qs0 - f1) + mid, c(ps0 + f2) + mid
    fr = _round2(f1, 1)
    oq1, op1 = c(qs1 - fr) + mid, c(ps1 + fr) + mid
    out[:, 8] = np.where(narrow, oq0, out[:, 8])
    out[:, 7] = np.where(narrow, op0, out[:, 7])
    out[:, 9] = np.where(narrow & ~hev, oq1, out[:, 9])
    out[:, 6] = np.where(narrow & ~hev, op1, out[:, 6])
    wide = mask & ~narrow
    for log2 in (3, 4):
        sel = wide & ((flat2 if log2 == 4 else ~flat2) if size >= 16 else (log2 == 3))
        if size == 8 and log2 == 4:
            continue
        n = 6 if log2 == 4 else (3 if plane == 0 else 2)
        n2 = 0 if (log2 == 3 and plane == 0) else 1
        for i in range(-n, n):
            t = 0
            for j in range(-n, n + 1):
                t = t + s[:, 8 + min(max(i + j, -(n + 1)), n)] * (2 if abs(j) <= n2 else 1)
            out[:, 8 + i] = np.where(sel, _round2(t, log2), out[:, 8 + i])
    return out.astype(np.int32)


def _fixed_div(num: int, div: int) -> int:
    return (num << 16) // div


def _centerstart(dx: int, s: int) -> int:
    return -((-dx >> 1) + s) if dx < 0 else (dx >> 1) + s


def _interp_rows(a, b, f: int):
    a, b = a.astype(np.int64), b.astype(np.int64)
    return a if f == 0 else (a * (256 - f) + b * f + 128) >> 8


def _filter_cols(row, dw: int, x: int, dx: int, wide: bool = False):
    """libyuv's column filter: x86's 7-bit fractions on 8-bit rows, the C
    filter's 16-bit ones on 16-bit rows (`wide`)."""
    row = np.concatenate([row.astype(np.int64), [0]])
    xs = x + dx * np.arange(dw, dtype=np.int64)
    if wide:
        xi, f = xs >> 16, xs & 0xFFFF
        a = row[xi]
        b = np.where(f > 0, row[np.minimum(xi + 1, len(row) - 1)], a)
        return a + ((f * (b - a) + 0x8000) >> 16)
    xi, f = xs >> 16, (xs >> 9) & 127
    return ((128 - f) * row[xi] + f * row[xi + 1] + 64) >> 7


def _up2_row(a, b, dw: int):
    """One row of libyuv's 2x upsamplers: b weighs 1/4 against a's 3/4
    (b = a: the linear one), the pixels between across 3:1."""
    out = np.zeros(dw, np.int64)
    out[0] = (3 * a[0] + b[0] + 2) >> 2
    n = ((dw - 1) & ~1) // 2
    s0, s1, t0, t1 = a[:n], a[1:n + 1], b[:n], b[1:n + 1]
    out[1:1 + 2 * n:2] = (s0 * 9 + s1 * 3 + t0 * 3 + t1 + 8) >> 4
    out[2:2 + 2 * n:2] = (s0 * 3 + s1 * 9 + t0 + t1 * 3 + 8) >> 4
    k = (dw - 1) // 2
    out[dw - 1] = (3 * a[k] + b[k] + 2) >> 2
    return out


def scale_plain(src: np.ndarray, dw: int, dh: int):
    """libyuv's ScalePlane with kFilterBox, as libavif 1.3.0's avifImageScale
    calls it (fd_av1_scale), or ScalePlane_16 for a uint16 plane (32-bit
    box sums, the C column filter): ScaleFilterReduce, then the path libyuv
    takes (csrc's scale::plane names them); None for the 3/4 and 3/8
    filters."""
    sh, sw = src.shape
    wide = src.dtype != np.uint8
    s = src.astype(np.int64)
    f = 3  # box
    if f == 3 and (dw * 2 >= sw or dh * 2 >= sh):
        f = 2
    if f == 2 and (sh == 1 or dh == sh or dh * 3 == sh):
        f = 1
    if f == 2 and sw == 1:
        f = 0
    if f == 1 and (sw == 1 or dw == sw or dw * 3 == sw):
        f = 0
    out = np.zeros((dh, dw), np.int64)
    if dw == sw and dh == sh:
        return src.copy()
    if dw == sw and f != 3:  # vertical
        dy = y = 0
        if dh <= sh:
            dy = _fixed_div(sh, dh)
            y = _centerstart(dy, -32768)
        elif sh > 1 and dh > 1:
            dy = ((sh << 16) - 0x10001) // (dh - 1)
        max_y = ((sh - 1) << 16) - 1 if sh > 1 else 0
        for j in range(dh):
            y = min(y, max_y)
            out[j] = _interp_rows(s[y >> 16], s[min((y >> 16) + 1, sh - 1)],
                                  ((y >> 8) & 255) if f else 0)
            y += dy
        return out.astype(src.dtype)
    if dw <= sw and dh <= sh:
        if (4 * dw == 3 * sw and 4 * dh == 3 * sh) or (8 * dw == 3 * sw and 8 * dh == 3 * sh):
            return None
        for k in (2, 4):
            if k * dw == sw and k * dh == sh:
                total = sum(s[a::k, b::k][:dh, :dw] for a in range(k) for b in range(k))
                return ((total + k * k // 2) >> (2 if k == 2 else 4)).astype(src.dtype)
    if f == 3 and dh * 2 < sh:  # box means (both sides below half: widths of 2 or more)
        dx, dy, y = _fixed_div(sw, dw), _fixed_div(sh, dh), 0
        if dx & 0xFFFF:  # widths of dx >> 16 or one more
            xs = (dx * np.arange(dw + 1, dtype=np.int64)) >> 16
            ix, bw = xs[:-1], xs[1:] - xs[:-1]
        else:
            bw = np.full(dw, dx >> 16)
            ix = np.arange(dw) * bw
        for j in range(dh):
            iy = y >> 16
            y = min(y + dy, sh << 16)
            bh = max(1, (y >> 16) - iy)
            row = s[iy:iy + bh].sum(0) & (0xFFFFFFFF if wide else 0xFFFF)  # libyuv's row sums
            sums = np.array([row[a:a + b].sum() for a, b in zip(ix, bw)], np.int64)
            out[j] = (sums * (65536 // (bw * bh))) >> 16
        return (out & (0xFFFF if wide else 0xFF)).astype(src.dtype)
    if (dw + 1) // 2 == sw and f == 1:  # 2x linear across
        if dh == 1:
            return _up2_row(s[(sh - 1) // 2], s[(sh - 1) // 2], dw)[None].astype(src.dtype)
        dy, y = _fixed_div(sh - 1, dh - 1), (1 << 15) - 1
        for j in range(dh):
            out[j] = _up2_row(s[y >> 16], s[y >> 16], dw)
            y += dy
        return out.astype(src.dtype)
    if (dh + 1) // 2 == sh and (dw + 1) // 2 == sw and f in (2, 3):  # 2x bilinear
        out[0] = _up2_row(s[0], s[0], dw)
        for k in range(sh - 1):
            out[1 + 2 * k] = _up2_row(s[k], s[k + 1], dw)
            if 2 + 2 * k < dh:
                out[2 + 2 * k] = _up2_row(s[k + 1], s[k], dw)
        if not dh & 1:
            out[dh - 1] = _up2_row(s[sh - 1], s[sh - 1], dw)
        return out.astype(src.dtype)
    if f:  # bilinear (ScaleSlope's steps, then rows and columns)
        x = y = dx = dy = 0
        if dw <= sw:
            dx = _fixed_div(sw, dw)
            x = _centerstart(dx, -32768)
        elif sw > 1 and dw > 1:
            dx = ((sw << 16) - 0x10001) // (dw - 1)
        if f == 1:
            dy = _fixed_div(sh, dh)
            y = dy >> 1
        elif dh <= sh:
            dy = _fixed_div(sh, dh)
            y = _centerstart(dy, -32768)
        elif sh > 1 and dh > 1:
            dy = ((sh << 16) - 0x10001) // (dh - 1)
        max_y = (sh - 1) << 16
        y = min(y, max_y)
        for j in range(dh):
            yi, yf = y >> 16, ((y >> 8) & 255) if f == 2 else 0
            below = s[min(yi + 1, sh - 1)]
            if dh > sh:  # columns of both rows, then the rows
                out[j] = _interp_rows(_filter_cols(s[yi], dw, x, dx, wide),
                                      _filter_cols(below, dw, x, dx, wide), yf)
            else:  # the rows, then the columns
                out[j] = _filter_cols(_interp_rows(s[yi], below, yf), dw, x, dx, wide)
            y = min(y + dy, max_y)
        return out.astype(src.dtype)
    dx, dy = _fixed_div(sw, dw), _fixed_div(sh, dh)  # point sampling
    x, y = _centerstart(dx, 0), _centerstart(dy, 0)
    xs = (np.arange(dw) >> 1) if (sw * 2 == dw and x < 0x8000) else \
        (x + dx * np.arange(dw, dtype=np.int64)) >> 16
    for j in range(dh):
        out[j] = s[(y + dy * j) >> 16][xs]
    return out.astype(src.dtype)


def _libyuv_chroma(c, ssx: int, ssy: int, w: int, h: int):
    """libyuv's chroma upsampling to h x w: none (4:4:4), across 3:1
    (4:2:2), the nearest rows 3:1 then across 3:1 (4:2:0)."""
    c = c.astype(np.int64)
    if not ssx:
        return c[:h, :w]
    cw = (w + 1) >> 1
    cols = np.arange(w)
    cx = (cols - 1) >> 1
    nx = np.where(cols & 1, cx, cx + 1)
    fx = np.where(cols & 1, cx + 1, cx)
    nx[0] = fx[0] = 0
    nx[w - 1] = fx[w - 1] = (w - 1) >> 1
    nx, fx = np.clip(nx, 0, cw - 1), np.clip(fx, 0, cw - 1)
    if not ssy:
        c = c[:h]
        return (3 * c[:, nx] + c[:, fx] + 2) >> 2
    ch = (h + 1) >> 1
    rows = np.arange(h)
    c0 = (rows - 1) >> 1
    near = np.where(rows & 1, c0, c0 + 1)
    far = np.where(rows & 1, c0 + 1, c0)
    near[0] = far[0] = 0
    near, far = np.clip(near, 0, ch - 1), np.clip(far, 0, ch - 1)
    return (9 * c[near][:, nx] + 3 * c[far][:, nx] + 3 * c[near][:, fx] + c[far][:, fx] + 8) >> 4


def _float_chroma(t, c, ssx: int, ssy: int, w: int, h: int):
    """libavif's float chroma: the table's values, 4:2:x upsampled on the
    floats (9/16 nearest, 3/16 the adjacent column and row, 1/16 the
    diagonal; 4:2:2's adjacent row is its own)."""
    if not ssx and not ssy:
        return t[c[:h, :w]]
    f32 = np.float32
    i, j = np.arange(w), np.arange(h)
    ci, cj = i >> ssx, j >> ssy
    adjc = np.where((i == 0) | ((i == w - 1) & (i % 2 != 0)), 0, np.where(i % 2 != 0, 1, -1))
    adjr = np.where((j == 0) | ((j == h - 1) & (j % 2 != 0)) | (not ssy), 0,
                    np.where(j % 2 != 0, 1, -1))
    c00, c10 = c[cj][:, ci], c[cj][:, ci + adjc]
    c01, c11 = c[cj + adjr][:, ci], c[cj + adjr][:, ci + adjc]
    return (((t[c00] * f32(9 / 16)) + (t[c10] * f32(3 / 16))) + (t[c01] * f32(3 / 16))
            + (t[c11] * f32(1 / 16)))


def to_rgba_plain(y, u, v, alpha, w: int, h: int, conv) -> np.ndarray:
    """fd_av1_to_rgb's twin: planes as decoded (padded), alpha h x w or
    None, `conv` from conversion()."""
    conv = np.asarray(conv)
    ssx, ssy, full = int(conv[C_SSX]), int(conv[C_SSY]), int(conv[C_FULL])
    depth = bit_depth = int(conv[C_DEPTH])
    if depth > 8 and conv[C_DOWN]:  # libyuv's Convert16To8Plane, then an 8-bit image
        y, u, v = (None if p is None else np.minimum(p.astype(np.int64) >> (depth - 8), 255)
                   for p in (y, u, v))
        depth = 8
    s = depth - 8
    out = np.zeros((h, w, 4), np.uint8)
    if conv[C_ROUTE] == ROUTE_LIBYUV:
        yg, yb, ub, ug, vg, vr = (int(x) for x in conv[C_YG:C_VR + 1])
        yy = y[:h, :w].astype(np.int64)
        y1 = (((yy << (16 - depth)) | (yy >> (2 * depth - 16))) * yg) >> 16
        if u is None:
            rgb = [(y1 + yb) >> 6] * 3
        else:
            if conv[C_NEAREST]:
                rows, cols = np.arange(h)[:, None] >> ssy, np.arange(w)[None, :] >> ssx
                uu, vv = u.astype(np.int64)[rows, cols], v.astype(np.int64)[rows, cols]
            else:
                uu, vv = _libyuv_chroma(u, ssx, ssy, w, h), _libyuv_chroma(v, ssx, ssy, w, h)
            uu, vv = np.minimum(uu >> s, 255), np.minimum(vv >> s, 255)
            rgb = [(y1 + vv * vr - (vr * 128 - yb)) >> 6,
                   (y1 + (ug * 128 + vg * 128 + yb) - (uu * ug + vv * vg)) >> 6,
                   (y1 + uu * ub - (ub * 128 - yb)) >> 6]
        for k in range(3):
            out[..., k] = np.clip(rgb[k], 0, 255)
    else:
        f32 = np.float32
        kr, kb = conv[C_KR:C_KB + 1].astype(np.int32).view(np.float32)
        kg = f32(1) - kr - kb
        mx = (1 << depth) - 1
        cp = np.arange(mx + 1, dtype=f32)
        ty = (cp - f32(0 if full else 16 << s)) / f32(mx if full else 219 << s)
        tuv = ty if conv[C_MODE] == MODE_IDENTITY else (cp - f32(128 << s)) / f32(mx if full else 224 << s)
        Y = ty[y[:h, :w]]
        if u is None:
            R = G = B = Y
        else:
            Cb, Cr = _float_chroma(tuv, u, ssx, ssy, w, h), _float_chroma(tuv, v, ssx, ssy, w, h)
            if conv[C_MODE] == MODE_YCGCO_RE:  # libavif's lifting of the rounded integers
                cg, co = (np.floor(c * f32(mx) + f32(0.5)).astype(np.int64) for c in (Cb, Cr))
                t = y[:h, :w].astype(np.int64) - (cg >> 1)
                g, b = np.clip(t + cg, 0, 255), np.clip(t - (co >> 1), 0, 255)
                for k, c in enumerate((np.clip(b + co, 0, 255), g, b)):
                    out[..., k] = c
            elif conv[C_MODE] == MODE_IDENTITY:
                G, B, R = Y, Cb, Cr
            elif conv[C_MODE] == MODE_YCGCO:
                t = Y - Cb
                G, B, R = Y + Cb, t - Cr, t + Cr
            else:
                R = Y + (f32(2) * (f32(1) - kr)) * Cr
                B = Y + (f32(2) * (f32(1) - kb)) * Cb
                G = Y - ((f32(2) * ((kr * (f32(1) - kr) * Cr) + (kb * (f32(1) - kb) * Cb))) / kg)
        if u is None or conv[C_MODE] != MODE_YCGCO_RE:
            for k, c in enumerate((R, G, B)):
                out[..., k] = (f32(0.5) + np.clip(c, f32(0), f32(1)) * f32(255)).astype(np.uint8)
    if alpha is None:
        out[..., 3] = 255
    elif bit_depth == 8:
        out[..., 3] = alpha[:h, :w]
    else:
        a, mx = alpha[:h, :w].astype(np.int64), (1 << bit_depth) - 1
        out[..., 3] = ((a * 255 + mx // 2) // mx if conv[C_ALPHA_ROUND]
                       else np.minimum(a >> (bit_depth - 8), 255))
    return out


def _constrain(diff, threshold: int, damping: int):
    if not threshold:
        return np.zeros_like(diff)
    adj = max(0, damping - (threshold.bit_length() - 1))
    val = np.minimum(np.abs(diff), np.maximum(0, threshold - (np.abs(diff) >> adj)))
    return np.sign(diff) * val


def cdef_direction_plain(b: np.ndarray, bit_depth: int = 8) -> tuple:
    """The direction search of 7.15.2 on an 8x8 (searched at 8 bits):
    (direction, variance)."""
    x = (b.astype(np.int64) >> (bit_depth - 8)) - 128
    i, j = np.mgrid[0:8, 0:8]
    lines = (i + j, i + j // 2, i, 3 + i - j // 2, 7 + i - j, 3 - i // 2 + j, j, i // 2 + j)
    partial = np.array([np.bincount(ln.ravel(), weights=x.ravel(), minlength=15)
                        for ln in lines]).astype(np.int64)
    div = T.CDEF_DIV_TABLE.astype(np.int64)
    cost = np.zeros(8, np.int64)
    cost[2] = (partial[2, :8] ** 2).sum() * div[8]
    cost[6] = (partial[6, :8] ** 2).sum() * div[8]
    for d in (0, 4):
        k = np.arange(7)
        cost[d] = ((partial[d, k] ** 2 + partial[d, 14 - k] ** 2) * div[k + 1]).sum()
        cost[d] += partial[d, 7] ** 2 * div[8]
    for d in (1, 3, 5, 7):
        cost[d] = (partial[d, 3:8] ** 2).sum() * div[8]
        k = np.arange(3)
        cost[d] += ((partial[d, k] ** 2 + partial[d, 10 - k] ** 2) * div[2 * k + 2]).sum()
    best = int(np.argmax(cost)) if cost.max() > 0 else 0
    return best, int(cost[best] - cost[(best + 4) & 7]) >> 10


def cdef_block_plain(win: np.ndarray, plane: int, pri: int, sec: int, damping: int,
                     ydir: int, bit_depth: int = 8) -> tuple:
    """CDEF (7.15) of one block from its window: (h + 4, w + 4) samples, the
    block at (2, 2), -1 outside the frame. Luma searches its direction
    (ydir is ignored) and adjusts `pri` by the variance; chroma takes the
    luma direction `ydir` through Cdef_Uv_Dir of its subsampling, which
    its size gives (8 >> ssx wide, 8 >> ssy tall). Returns (direction,
    variance, filtered h x w): for luma the search's direction and
    variance, for chroma the direction used and 0. The strengths and
    damping are the header's, shifted here by bit_depth - 8."""
    win = win.astype(np.int64)
    h, w = win.shape[0] - 4, win.shape[1] - 4
    shift = bit_depth - 8
    pri, sec, damping = pri << shift, sec << shift, damping + shift
    if plane == 0:
        ydir, var = cdef_direction_plain(win[2:10, 2:10], bit_depth)
        direction = ydir if pri else 0
        var_str = min((var >> 6).bit_length() - 1, 12) if var >> 6 else 0
        pri = (pri * (4 + var_str) + 8) >> 4 if var else 0
        result = ydir
    else:
        var = 0
        direction = int(T.CDEF_UV_DIR[int(w == 4), int(h == 4), ydir]) if pri else 0
        result = direction
    x = win[2:2 + h, 2:2 + w]
    total = np.zeros_like(x)
    hi, lo = x.copy(), x.copy()
    pri_taps, sec_taps = T.CDEF_PRI_TAPS[(pri >> shift) & 1], T.CDEF_SEC_TAPS[(pri >> shift) & 1]

    def tap(d, k, sign, strength, weight):
        nonlocal total, hi, lo
        dy, dx = (int(v) * sign for v in T.CDEF_DIRECTIONS[d, k])
        p = win[2 + dy:2 + dy + h, 2 + dx:2 + dx + w]
        ok = p >= 0
        total = total + np.where(ok, int(weight) * _constrain(p - x, strength, damping), 0)
        hi = np.where(ok, np.maximum(p, hi), hi)
        lo = np.where(ok, np.minimum(p, lo), lo)

    for k in range(2):
        for sign in (-1, 1):
            tap(direction, k, sign, pri, pri_taps[k])
            for off in (-2, 2):
                tap((direction + off) & 7, k, sign, sec, sec_taps[k])
    out = np.clip(x + ((8 + total - (total < 0)) >> 4), lo, hi)
    return result, var, out.astype(_samples(bit_depth))


def wiener_plain(win: np.ndarray, vtaps, htaps, bit_depth: int = 8) -> np.ndarray:
    """The Wiener filter (7.17.4) of a block from its window ((h + 6, w + 6),
    the block at (3, 3)): 7 taps each way, tap 3 = 128 - 2 (taps 0-2), the
    rounding of the bit depth (InterRound0 3 and InterRound1 11, 5 and 9 at
    12 bits) and the clip of the horizontal intermediate."""
    win = win.astype(np.int64)
    h, w = win.shape[0] - 6, win.shape[1] - 6

    def taps(t):
        t = [int(v) for v in t]
        return t + [128 - 2 * sum(t)] + t[::-1]
    hf, vf = taps(htaps), taps(vtaps)
    round0, round1 = (5, 9) if bit_depth == 12 else (3, 11)
    offset, limit = 1 << (bit_depth + 7 - round0 - 1), (1 << (bit_depth + 1 + 7 - round0)) - 1
    mid = sum(hf[t] * win[:, t:t + w] for t in range(7))
    mid = np.clip(_round2(mid, round0), -offset, limit - offset)
    out = sum(vf[t] * mid[t:t + h] for t in range(7))
    return np.clip(_round2(out, round1), 0, (1 << bit_depth) - 1).astype(_samples(bit_depth))


def _sgr_box_plain(win: np.ndarray, r: int, s: int, pass_: int, bit_depth: int) -> np.ndarray:
    h, w = win.shape[0] - 6, win.shape[1] - 6
    n = (2 * r + 1) ** 2
    a = np.zeros((h + 2, w + 2), np.int64)
    b = np.zeros((h + 2, w + 2), np.int64)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            c = win[2 + dy:2 + dy + h + 2, 2 + dx:2 + dx + w + 2]
            a += c * c
            b += c
    shift = bit_depth - 8
    p = np.maximum(0, _round2(a, 2 * shift) * n - _round2(b, shift) ** 2)
    z = _round2(p * s, 20)
    A = T.X_BY_XPLUS1.astype(np.int64)[np.minimum(z, 255)]
    B = _round2((256 - A) * b * int(T.ONE_BY_X[n - 1]), 12)
    fa = np.zeros((h, w), np.int64)
    fb = np.zeros((h, w), np.int64)
    rows = np.arange(h)[:, None]
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if pass_ == 0:
                weight = np.where((rows + dy) & 1, 6 if dx == 0 else 5, 0)
            else:
                weight = 4 if (dx == 0 or dy == 0) else 3
            fa += weight * A[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            fb += weight * B[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    shift = np.where((rows & 1) & (pass_ == 0), 4, 5)
    v = fa * win[3:3 + h, 3:3 + w] + fb
    return (v + (1 << (8 + shift - 4 - 1))) >> (8 + shift - 4)


def sgr_plain(win: np.ndarray, sgr_set: int, xqd, bit_depth: int = 8) -> np.ndarray:
    """The self-guided filter (7.17.3) of a block from its window (as
    wiener_plain's): the set's box passes at radius 2 (every other row) and
    1, then the projection with weights xqd."""
    win = win.astype(np.int64)
    h, w = win.shape[0] - 6, win.shape[1] - 6
    r0, r1, s0, s1 = (int(v) for v in T.SGR_PARAMS[sgr_set])
    u = win[3:3 + h, 3:3 + w] << 4
    w0, w1 = int(xqd[0]), int(xqd[1])
    w2 = (1 << 7) - w0 - w1
    v = w1 * u
    v = v + w0 * (_sgr_box_plain(win, r0, s0, 0, bit_depth) if r0 else u)
    v = v + w2 * (_sgr_box_plain(win, r1, s1, 1, bit_depth) if r1 else u)
    return np.clip(_round2(v, 11), 0, (1 << bit_depth) - 1).astype(_samples(bit_depth))


def alpha_range_plain(plane: np.ndarray, width: int, height: int, bit_depth: int) -> np.ndarray:
    """fd_av1_alpha_range's twin: a copy of the plane with its width x
    height samples v made ((v - lo) * full + (hi - lo) // 2) / (hi - lo),
    truncated towards zero and clamped to [0, full] (libavif's
    avifLimitedToFullY: lo, hi = 16, 235 at 8 bits, shifted left by
    bit_depth - 8)."""
    lo, hi, full = 16 << (bit_depth - 8), 235 << (bit_depth - 8), (1 << bit_depth) - 1
    out = np.array(plane, copy=True)
    num = (out[:height, :width].astype(np.int64) - lo) * full + (hi - lo) // 2
    q = np.abs(num) // (hi - lo) * np.sign(num)
    out[:height, :width] = np.clip(q, 0, full)
    return out


def unattenuate_plain(rgba: np.ndarray) -> np.ndarray:
    """fd_av1_unattenuate's twin: libyuv's x86 ARGBUnattenuate rows, each
    colour c of a pixel with alpha a made v = (c | c << 8) * ia >> 16 with
    ia the low half of fixed_invtbl8[a], packed by packuswb (v read as a
    signed 16-bit word: 0 from 32768 up, else min(v, 255)); alpha kept."""
    a = rgba[..., 3:].astype(np.uint32)
    ia = np.where(a == 0, 0, np.where(a == 1, 0xFFFF, np.where(a == 255, 0x100,
                                                                 0x10000 // np.maximum(a, 1))))
    v = (rgba[..., :3].astype(np.uint32) * 257 * ia) >> 16
    out = rgba.copy()
    out[..., :3] = np.where(v >= 32768, 0, np.minimum(v, 255))
    return out


def _grain_random(state: int, bits: int) -> tuple:
    """The specification's get_random_number: (value, new state)."""
    bit = (state ^ (state >> 1) ^ (state >> 3) ^ (state >> 12)) & 1
    state = (state >> 1) | (bit << 15)
    return (state >> (16 - bits)) & ((1 << bits) - 1), state


def _grain_round2(x, shift: int):
    return (x + ((1 << shift) >> 1)) >> shift


def _grain_range(bit_depth: int) -> tuple:
    return -(128 << (bit_depth - 8)), (128 << (bit_depth - 8)) - 1


def grain_templates_plain(g: np.ndarray) -> np.ndarray:
    """The grain templates (int16 (3, 73, 82), as fd_av1_film_grain's
    `templ`): the luma template always, a chroma one (38 x 44 where
    subsampled) where its plane takes grain, zeros elsewhere. Gaussian
    values by the LFSR, shifted by 12 - BitDepth + grain_scale_shift, then
    the autoregressive filter from row and column 3 on."""
    bd, lag = int(g[G_BITDEPTH]), int(g[G_AR_LAG])
    shift = 12 - bd + int(g[G_GRAIN_SCALE_SHIFT])
    gmin, gmax = _grain_range(bd)
    ar_shift, ny = int(g[G_AR_SHIFT]), int(g[G_NUM_Y])
    out = np.zeros((3, GRAIN_H, GRAIN_W), np.int16)
    taps = [(dy, dx) for dy in range(-lag, 1) for dx in range(-lag, lag + 1)][: 2 * lag * (lag + 1)]
    above = [(k, dy, dx) for k, (dy, dx) in enumerate(taps) if dy < 0]
    left = [(k, dx) for k, (dy, dx) in enumerate(taps) if dy == 0]
    for p in range(3):
        if p and (g[G_MONO] or not (g[G_NUM_UV + p - 1] or g[G_CSFL])):
            continue
        sx, sy = (int(g[G_SSX]), int(g[G_SSY])) if p else (0, 0)
        cw, ch = (SUB_GRAIN_W if sx else GRAIN_W), (SUB_GRAIN_H if sy else GRAIN_H)
        seed = int(g[G_SEED]) ^ (0, 0xB524, 0x49D8)[p]
        draws = []
        for _ in range(cw * ch):
            v, seed = _grain_random(seed, 11)
            draws.append(v)
        buf = _grain_round2(T.GAUSSIAN_SEQUENCE[draws].astype(np.int64), shift).reshape(ch, cw)
        coeff = [int(c) for c in (g[G_AR_UV + 25 * (p - 1):G_AR_UV + 25 * p] if p
                                  else g[G_AR_Y:G_AR_Y + 24])]
        xs = np.arange(3, cw - 3)
        luma = out[0].astype(np.int64) if p and ny else None  # the luma term's template
        for y in range(3, ch):
            known = np.zeros(len(xs), np.int64)  # the rows above, already final
            for k, dy, dx in above:
                known += coeff[k] * buf[y + dy, xs + dx]
            if luma is not None:
                lx, ly = ((xs - 3) << sx) + 3, ((y - 3) << sy) + 3
                total = sum(luma[ly + i, lx + j] for i in range(sy + 1) for j in range(sx + 1))
                known += _grain_round2(total, sx + sy) * coeff[len(taps)]
            row = buf[y]
            for i, x in enumerate(xs.tolist()):
                total = int(known[i]) + sum(coeff[k] * int(row[x + dx]) for k, dx in left)
                row[x] = min(max(int(row[x]) + _grain_round2(total, ar_shift), gmin), gmax)
        out[p, :ch, :cw] = buf
    return out


def grain_scaling_plain(points, num: int, bit_depth: int) -> np.ndarray:
    """A plane's scaling lookup (uint8, 1 << bit_depth entries) from its
    points ((x, scaling) pairs, x rising), as dav1d's generate_scaling:
    16.16 steps between the 8-bit points, the ends held, and at 10 and 12
    bits each run between spread points interpolated again."""
    shift, size = bit_depth - 8, 1 << bit_depth
    out = np.zeros(size, np.int64)
    if not num:
        return out.astype(np.uint8)
    pts = [(int(points[2 * i]), int(points[2 * i + 1])) for i in range(num)]
    out[:pts[0][0] << shift] = pts[0][1]
    for (bx, by), (ex, ey) in zip(pts, pts[1:]):
        dx = ex - bx
        delta = (ey - by) * ((0x10000 + (dx >> 1)) // dx)
        for x in range(dx):
            out[(bx + x) << shift] = (by + ((0x8000 + x * delta) >> 16)) & 0xFF
    out[pts[-1][0] << shift:] = pts[-1][1]
    if shift:
        pad, rnd = 1 << shift, 1 << (shift - 1)
        for (bx, _by), (ex, _ey) in zip(pts, pts[1:]):
            for x in range(bx << shift, ex << shift, pad):
                rng = int(out[x + pad] - out[x])
                for k in range(1, pad):
                    out[x + k] = (out[x] + ((rnd + k * rng) >> shift)) & 0xFF
    return out.astype(np.uint8)


def grain_offsets_plain(seed: int, rows: int, cols: int) -> np.ndarray:
    """Each block's random template offset (8 bits: x in the high nibble,
    y in the low), block row by block row, each row's LFSR seeded from
    grain_seed and the row."""
    out = np.zeros((rows, cols), np.int64)
    for r in range(rows):
        state = seed ^ ((((r * 37 + 178) & 0xFF) << 8) | ((r * 173 + 105) & 0xFF))
        for c in range(cols):
            out[r, c], state = _grain_random(state, 8)
    return out


# the overlap's weights of the old (left or above) and the new block by
# the position in the overlap: [subsampled][position]
GRAIN_BLEND_OLD, GRAIN_BLEND_NEW = ((27, 17), (23,)), ((17, 27), (22,))


def _grain_map(lut: np.ndarray, off: np.ndarray, pw: int, ph: int, sx: int, sy: int,
               overlap: int, bit_depth: int) -> np.ndarray:
    """The grain of each sample of a pw x ph plane: blocks of 32 (16 where
    subsampled) from the template at their offsets, the first columns and
    rows blended with the left and upper blocks' continuations under
    overlap_flag."""
    gmin, gmax = _grain_range(bit_depth)
    bsx, bsy = 32 >> sx, 32 >> sy
    out = np.zeros((ph, pw), np.int64)

    def part(rv, bxi, byi, h, w):
        x0 = 3 + (2 >> sx) * (3 + (int(rv) >> 4)) + bsx * bxi
        y0 = 3 + (2 >> sy) * (3 + (int(rv) & 15)) + bsy * byi
        return lut[y0:y0 + h, x0:x0 + w].astype(np.int64)

    def blend(old, new, s, axis):
        w_old = np.array(GRAIN_BLEND_OLD[s][:old.shape[axis]])
        w_new = np.array(GRAIN_BLEND_NEW[s][:old.shape[axis]])
        if axis == 0:
            w_old, w_new = w_old[:, None], w_new[:, None]
        return np.clip(_grain_round2(old * w_old + new * w_new, 5), gmin, gmax)

    for r in range(-(-ph // bsy)):
        y0 = r * bsy
        bh = min(bsy, ph - y0)
        ys = min(2 >> sy, bh) if overlap and r else 0
        for c in range(-(-pw // bsx)):
            x0 = c * bsx
            bw = min(bsx, pw - x0)
            xs = min(2 >> sx, bw) if overlap and c else 0
            cur = part(off[r, c], 0, 0, bh, bw)
            if xs:
                cur[:, :xs] = blend(part(off[r, c - 1], 1, 0, bh, xs), cur[:, :xs], sx, 1)
            if ys:
                top = part(off[r - 1, c], 0, 1, ys, bw)
                if xs:
                    top[:, :xs] = blend(part(off[r - 1, c - 1], 1, 1, ys, xs), top[:, :xs], sx, 1)
                cur[:ys] = blend(top, cur[:ys], sy, 0)
            out[y0:y0 + bh, x0:x0 + bw] = cur
    return out


def film_grain_plain(planes, width: int, height: int, g: np.ndarray) -> tuple:
    """fd_av1_film_grain's twin: the planes with film grain over the
    width x height samples (a plane without grain returned as it is)."""
    bd = int(g[G_BITDEPTH])
    bmax, bdm8 = (1 << bd) - 1, bd - 8
    lut = grain_templates_plain(g)
    csfl, shift = int(g[G_CSFL]), int(g[G_SCALING_SHIFT])
    off = grain_offsets_plain(int(g[G_SEED]), (height + 31) >> 5, ((width + 31) >> 5) + 1)
    out = list(planes)
    luma = planes[0].astype(np.int64)
    for p in range(1 if g[G_MONO] else 3):
        n = int(g[G_NUM_Y] if p == 0 else g[G_NUM_UV + p - 1])
        if not n and not (p and csfl):
            continue
        sx, sy = (int(g[G_SSX]), int(g[G_SSY])) if p else (0, 0)
        pw, ph = (width + sx) >> sx, (height + sy) >> sy
        if p and csfl:
            scaling = grain_scaling_plain(g[G_Y_POINTS:], int(g[G_NUM_Y]), bd)
        else:
            at = G_Y_POINTS if p == 0 else G_UV_POINTS + 20 * (p - 1)
            scaling = grain_scaling_plain(g[at:], n, bd)
        grain = _grain_map(lut[p], off, pw, ph, sx, sy, int(g[G_OVERLAP]), bd)
        src = planes[p][:ph, :pw].astype(np.int64)
        val = src
        if p:
            ly, lx = np.arange(ph) << sy, np.arange(pw) << sx
            avg = luma[ly][:, lx]
            if sx:  # the last column repeated past an odd width
                avg = (avg + luma[ly][:, np.minimum(lx + 1, width - 1)] + 1) >> 1
            val = avg
            if not csfl:
                mult, lmult = int(g[G_UV_MULT + p - 1]), int(g[G_UV_LUMA_MULT + p - 1])
                offset = int(g[G_UV_OFFSET + p - 1]) << bdm8
                val = np.clip(((avg * lmult + src * mult) >> 6) + offset, 0, bmax)
        lo, hi = 0, bmax
        if g[G_CLIP]:
            lo, hi = 16 << bdm8, (235 if p == 0 or g[G_IS_ID] else 240) << bdm8
        noise = _grain_round2(scaling[val].astype(np.int64) * grain, shift)
        plane = planes[p].copy()
        plane[:ph, :pw] = np.clip(src + noise, lo, hi)
        out[p] = plane
    return tuple(out)


def check_trace(buf: np.ndarray, limit: int = 0) -> dict:
    """Checks the traced stage calls against their twins; `limit` caps the
    calls checked of each kind (0: all). Returns the counts checked;
    raises RuntimeError at the first call that differs. A record of kind 8
    sets the bit depth of the records after it (8 until one does)."""
    counts = {"predict": 0, "cfl": 0, "txfm": 0, "lf": 0, "cdef": 0, "wiener": 0, "sgr": 0}
    lf_batches = {}
    pos, n, depth = 0, len(buf), 8
    while pos < n:
        kind = int(buf[pos])
        if kind == 8:
            depth = int(buf[pos + 1])
            pos += 2
        elif kind == 1:
            params = buf[pos + 1:pos + 13]
            m = int(buf[pos + 13])
            above = buf[pos + 14:pos + 14 + m]
            left = buf[pos + 14 + m:pos + 14 + 2 * m]
            w, h = 1 << int(params[1]), 1 << int(params[2])
            got = buf[pos + 14 + 2 * m:pos + 14 + 2 * m + w * h]
            pos += 14 + 2 * m + w * h
            if not limit or counts["predict"] < limit:
                want = predict_plain(params, above, left, depth)
                if not np.array_equal(want.reshape(-1), got):
                    raise RuntimeError(f"predict {params.tolist()} differs from predict_plain")
                counts["predict"] += 1
        elif kind == 2:
            w, h, alpha = (int(v) for v in buf[pos + 1:pos + 4])
            k = w * h
            L = buf[pos + 4:pos + 4 + k].reshape(h, w)
            dc = buf[pos + 4 + k:pos + 4 + 2 * k].reshape(h, w)
            got = buf[pos + 4 + 2 * k:pos + 4 + 3 * k]
            pos += 4 + 3 * k
            if not limit or counts["cfl"] < limit:
                if not np.array_equal(cfl_plain(L, alpha, dc, depth).reshape(-1), got):
                    raise RuntimeError("cfl differs from cfl_plain")
                counts["cfl"] += 1
        elif kind == 3:
            tx, ty, lossless, nnz = (int(v) for v in buf[pos + 1:pos + 5])
            pairs = buf[pos + 5:pos + 5 + 2 * nnz].reshape(-1, 2)
            w, h = TX_W[tx], TX_H[tx]
            got = buf[pos + 5 + 2 * nnz:pos + 5 + 2 * nnz + w * h]
            pos += 5 + 2 * nnz + w * h
            if not limit or counts["txfm"] < limit:
                deq = np.zeros(64 * 64, np.int64)
                deq[pairs[:, 0]] = pairs[:, 1]
                want = inv_txfm_plain(deq.reshape(64, 64), tx, ty, lossless, depth)
                if not np.array_equal(want.reshape(-1), got):
                    raise RuntimeError(f"inverse transform {tx} {ty} differs from inv_txfm_plain")
                counts["txfm"] += 1
        elif kind == 4:
            key = tuple(int(v) for v in buf[pos + 1:pos + 6]) + (depth,)
            lf_batches.setdefault(key, []).append(buf[pos + 6:pos + 38])
            pos += 38
        elif kind == 5:
            plane, w, h, pri, sec, damping, ydir = (int(v) for v in buf[pos + 1:pos + 8])
            k = (w + 4) * (h + 4)
            win = buf[pos + 8:pos + 8 + k].reshape(h + 4, w + 4)
            got_dir, got_var = (int(v) for v in buf[pos + 8 + k:pos + 10 + k])
            got = buf[pos + 10 + k:pos + 10 + k + w * h]
            pos += 10 + k + w * h
            if not limit or counts["cdef"] < limit:
                d, var, out = cdef_block_plain(win, plane, pri, sec, damping, ydir, depth)
                if (d, var) != (got_dir, got_var) or not np.array_equal(out.reshape(-1), got):
                    raise RuntimeError(f"CDEF of plane {plane} (strengths {pri}, {sec}) differs "
                                       "from cdef_block_plain")
                counts["cdef"] += 1
        elif kind in (6, 7):
            w, h = int(buf[pos + 1]), int(buf[pos + 2])
            params = buf[pos + 3:pos + 9]
            k = (w + 6) * (h + 6)
            win = buf[pos + 9:pos + 9 + k].reshape(h + 6, w + 6)
            got = buf[pos + 9 + k:pos + 9 + k + w * h]
            pos += 9 + k + w * h
            name = "wiener" if kind == 6 else "sgr"
            if not limit or counts[name] < limit:
                want = (wiener_plain(win, params[:3], params[3:], depth) if kind == 6
                        else sgr_plain(win, int(params[0]), params[1:3], depth))
                if not np.array_equal(want.reshape(-1), got):
                    raise RuntimeError(f"{'Wiener' if kind == 6 else 'self-guided'} filter "
                                       f"{params.tolist()} differs from {name}_plain")
                counts[name] += 1
        else:
            raise RuntimeError(f"a trace record of kind {kind}")
    for key, rows in lf_batches.items():
        rows = np.array(rows[:limit] if limit else rows)
        want = lf_edge_plain(rows[:, :16], key[:5], key[5])
        if not np.array_equal(want, rows[:, 16:]):
            raise RuntimeError(f"loop filter {key} differs from lf_edge_plain")
        counts["lf"] += len(rows)
    return counts
