"""Write the stored image files of figdraw_tpu_torch's decoders and their
references, from the repo's PNG fixture (tests/goldens/
render_3d_overlay_gaussian.png, 800x600 RGBA), with PIL on the CPU host:

- `figdraw_tpu_torch/reference/images/`: JPEGs (baseline 4:2:0 at q 90,
  progressive 4:2:2, 4:4:4 with a restart interval of one MCU row,
  grayscale, Adobe CMYK, a 797x599 crop, a 64x48 progressive crop with
  restarts), a GIF with a transparent index, BMPs of each header kind
  (crops: OS/2 core 8-bit, INFO 24-bit, INFO RLE8 and RLE4, INFO 1-bit,
  V2 16-bit 5-6-5 bitfields, V3 32-bit BGRA bitfields, V4 32-bit BI_RGB
  top-down, V5 4-bit), an ICO with a PNG entry and one with a DIB entry,
  a QOI, and TIFFs (`tiff_files`: the whole fixture as LZW + Predictor 2,
  and crops through each compression, layout and pixel kind;
  `fax_zstd_files`: the fixture as ZSTD + Predictor 2, a ZSTD float crop
  with Predictor 3, a fax page at TIFF-F resolution (`fax_page`) as Group
  4, Group 3 2D with fill bits, FillOrder 2 and MinIsWhite, and Modified
  Huffman, the fixture dithered to a Group 3 fax, Group 4 tiles;
  `libzstd_files`: a crop of the fixture in ZSTD tiles and libzstd's frames at
  levels 1 to 22 with a checksum, through PIL's libzstd), and WebPs
  (`webp_files`: the fixture lossy at q 90 and lossless, and crops: lossy
  at q 5, 50 and 100 with methods 0 and 6, 1x1 and 17x3, with ALPH at
  alpha qualities 100 and 30, lossless photo, grey and 2 to 200 colours
  (every pixel bundling),
  lossless `exact` with transparent pixels, an animation whose first frame
  is smaller than the canvas and offset in it; and through libwebp's own
  encoder, `libwebp_encode`, the options PIL's save does not set: the
  simple loop filter, no filter, sharpness 7, one and four segments, eight
  token partitions, raw ALPH and each ALPH filter, and lossless tiles that
  take all 14 predictor modes), and arithmetic-coded and lossless JPEGs
  (`arith_lossless_files`, through libjpeg-turbo's own encoder, which
  PIL's save does not reach: tools/jpeg_arith_lossless_writer.c, built by
  `arith_lossless_writer` with gcc and linked to PIL's libjpeg: the
  fixture as SOF9 and as SOF10 with restarts, crops with DAC conditioning
  other than the defaults, a grey and a CMYK crop, a 224x168 lossless crop
  and crops through each lossless predictor), and the files of libjpeg's
  and libtiff's quirks (`jpeg_repair_files`: progressive JPEGs whose scans
  leave coefficients unrefined, Huffman and arithmetic, and a one-scan
  JPEG without its EOI; `ccitt_repair_files`: RLE-W TIFFs, one with strips
  at odd offsets, and a T.6 strip with the extension code of uncompressed
  mode), and the fixture as an AVIF with PIL's default save (quality 75,
  speed 6, 4:2:0; PIL drops the opaque alpha) and at speed 2 with aom's
  CDEF on (`fixture_s2_cdef.avif`: CDEF and loop restoration), at 4:4:4
  (`fixture_444.avif`, AV1 profile 1, PIL's default otherwise) and at
  4:2:2, speed 0 with CDEF, marked limited-range BT.709
  (`fixture_422_limited_cdef.avif`, profile 2: 4:2:2's CDEF direction
  map, its Wiener and self-guided units, libyuv's limited BT.709), and three
  of those made 10- and 12-bit by rewriting their AV1 sequence headers
  (`avif_at_depth`: aom in PIL's libavif writes 8 bits only):
  `fixture_s2_cdef_10bit.avif`, `fixture_444_10bit.avif` (profile 1) and
  `fixture_422_12bit.avif` (profile 2, limited-range BT.709, CDEF and loop
  restoration at 12 bits), and two grid images, which PIL's save does not
  write, through libavif's own encoder (`avif_grid`): the fixture with a
  vignette alpha (`vignetted`) as 4x3 tiles of 200x200 with an alpha grid
  (`fixture_grid.avif`) and the fixture scaled to a 4032x3024 phone photo
  as 8x6 tiles of 512x512, the last column and row cropped by the grid
  (`photo_grid_4032x3024.avif`, quality 50, speed 10), and two files with
  film grain, written with aom's `film-grain-test` vectors
  (`AVIF_GRAIN_VECTORS`): the fixture with the grid's vignette alpha at
  quality 75 with vector 2 (`fixture_grain.avif`: luma and chroma points,
  AR lag 3, overlap; the alpha item takes grain too) and at 4:2:2 with
  vector 4 made 10-bit (`fixture_grain_422_10bit.avif`), and an image
  sequence (`sequence_prem_64x64.avif`: PIL's save_all of two 64x64 crops
  of the fixture with the vignette alpha at quality 50,
  `alpha_premultiplied=True`, its mvhd / tkhd / mdhd times set to 0 by
  `steady_times`). The card's machine has no PIL: chip_smoke.py decodes
  these, and makes four more files from the sequence by byte edits that
  keep every offset (`card_rewrites`: straight alpha, a limited-range
  alpha track, read as a still, an lsel on the still).
- `figdraw_tpu_torch/reference/image_formats.json`: under "files", each
  file's sha256 and the sha256 and shape of PIL's decode,
  `Image.open(p).convert("RGBA")`; under "rewrites", the same of each of
  the sequence's card_rewrites; under "sidecar", the sha256 of the
  .flippy sidecar figdraw_tpu's read_image_cached writes for the baseline
  JPEG, the TIFF fixture, the lossy WebP fixture, the ZSTD fixture, the
  Group 4 fax page, the SOF10 fixture, the SOF3 crop, the incomplete
  progressive JPEG, the RLE-W fixture, the seven AVIF fixtures, the
  two grids, the two film grain files and the sequence.
- `reference/example_image_file_{jpeg,tiff,webp,zstd,g3,arith,incomplete,rlew,avif,avif_cdef,avif_444,avif_422,avif_cdef10,avif_444_10,avif_422_12,avif_grid,avif_grain,avif_grain_422_10,avif_sequence,avif_sequence_limited}_1x_blocks8.npy`
  and `reference/photo_wall_{jpeg,tiff,webp,zstd,g4,lossless,incomplete,rlew,avif,avif_cdef,avif_444,avif_422,avif_cdef10,avif_444_10,avif_422_12,avif_grid,avif_grain,avif_grain_422_10,avif_sequence,avif_sequence_limited}_480x270_blocks8.npy`:
  8x8 block means of figdraw_tpu's frames of the image-file scene and of
  the photo wall at 480x270 (12 panels) with the baseline JPEG, the TIFF,
  WebP or ZSTD fixture, the dithered Group 3 fixture, the Group 4 page,
  the SOF10 fixture, the SOF3 crop, the incomplete progressive JPEG, the
  RLE-W fixture or an AVIF fixture (the grid, film grain and sequence
  files among them, and the sequence's limited-alpha rewrite) loaded
  by its load_image
  (FigRenderer(atlas_size=512, use_pallas=False), the page's from
  scenes.FAX_ATLAS; tests/torch_reference.py).

The BMP builders (`bmp_bytes`, `rle8`, `rle4`), the TIFF writer
(`tiff_bytes`, with `packbits`, `lzw`, `jpeg_parts` and the CCITT encoder
`fax_encode` with its bit writer `FaxBits`), the WebP writers
(`libwebp_encode`, `riff`, `anim_bytes`) and the AVIF ones (`avif_grid`,
`avif_at_depth`, `avif_with_grain`, which rewrites the film grain
parameters of every item, `Heif`, which edits a file's items and writes
it again, `Avis`, which does the same for an image sequence's tracks and
their sample tables in other layouts, `avis_at_depth`, `limited_alpha`,
`with_track_size` and `stream_variant`, which rewrites a sequence's
first sample with other sequence and frame header fields, a split frame
header or OBU extension headers) also serve the tests: PIL
writes only one BMP header kind, no TIFF tiles, planar or big-endian
files, FillOrder 2 or subsampled JPEG-in-TIFF, no hand-made fax strip,
sets none of libwebp's filter, segment, partition or alpha options, and
writes no AVIF grid, nothing past 8 bits, no film grain parameters
but aom's 16 test vectors, no limited-range alpha and no sequence header
but aom's.
The tests rerun `image_files` but never `libzstd_files`: they load no
libzstd.

    JAX_PLATFORMS=cpu python tools/make_image_formats.py   (~60 s)
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import io
import json
import lzma
import os
import shutil
import struct
import sys
import tempfile
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "goldens", "render_3d_overlay_gaussian.png")
OUT_DIR = os.path.join(REPO, "figdraw_tpu_torch", "reference", "images")
DIGESTS = os.path.join(REPO, "figdraw_tpu_torch", "reference", "image_formats.json")
BASELINE = "baseline_420_q90.jpg"
TIFF_FIXTURE = "fixture_lzw_pred2.tif"
WEBP_FIXTURE = "fixture_q90.webp"
AVIF_FIXTURE = "fixture_q75.avif"
AVIF_CDEF_FIXTURE = "fixture_s2_cdef.avif"
AVIF_444_FIXTURE = "fixture_444.avif"
AVIF_422_FIXTURE = "fixture_422_limited_cdef.avif"
# the three made 10- and 12-bit from the ones above (name: (source, bits))
AVIF_GRID_FIXTURE = "fixture_grid.avif"
AVIF_PHOTO = "photo_grid_4032x3024.avif"
AVIF_DEPTHS = {"fixture_s2_cdef_10bit.avif": (AVIF_CDEF_FIXTURE, 10),
               "fixture_444_10bit.avif": (AVIF_444_FIXTURE, 10),
               "fixture_422_12bit.avif": (AVIF_422_FIXTURE, 12)}
# film grain: aom's film-grain-test vectors (its grain_synthesis.c test
# vectors 1-16) of the two stored grain files. Vector 2: two luma points,
# two a chroma plane, AR lag 3, overlap_flag; vector 4: nine points a plane,
# lag 3, overlap_flag.
AVIF_GRAIN_FIXTURE = "fixture_grain.avif"
AVIF_GRAIN_422_10 = "fixture_grain_422_10bit.avif"
AVIF_GRAIN_VECTORS = {AVIF_GRAIN_FIXTURE: 2, AVIF_GRAIN_422_10: 4}
AVIF_SEQUENCE = "sequence_prem_64x64.avif"


def _pack_rows(pixels: np.ndarray, bits: int) -> np.ndarray:
    """(h, w) indices (bits <= 8), (h, w) uint16 (16) or (h, w, n) bytes to
    (h, stride) rows padded to 4 bytes."""
    h, w = pixels.shape[:2]
    if bits < 8:
        per = 8 // bits
        idx = np.zeros((h, -(-w // per) * per), np.uint8)
        idx[:, :w] = pixels
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        raw = (idx.reshape(h, -1, per) << shifts).sum(axis=2, dtype=np.uint8)
    elif bits == 16:
        raw = pixels.astype("<u2").view(np.uint8).reshape(h, 2 * w)
    else:
        raw = pixels.reshape(h, -1).astype(np.uint8)
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : raw.shape[1]] = raw
    return rows


def bmp_bytes(pixels: np.ndarray, bits: int, header: int = 40, palette=None,
              compression: int = 0, masks=None, top_down: bool = False,
              rle: bytes = None) -> bytes:
    """A BMP file: `pixels` as _pack_rows takes them (ignored when `rle`
    gives the compressed data), a palette of (n, 3) RGB entries, the
    header kind by its size (12, 40, 52, 56, 108, 124), BI_BITFIELDS
    masks (R, G, B[, A])."""
    h, w = pixels.shape[:2]
    if rle is not None:
        data = rle
    else:
        rows = _pack_rows(pixels, bits)
        data = (rows if top_down else rows[::-1]).tobytes()
    pal = b""
    if palette is not None:
        pal_rgb = np.asarray(palette, np.uint8)[:, ::-1]
        if header != 12:
            pal_rgb = np.concatenate([pal_rgb, np.zeros((len(pal_rgb), 1), np.uint8)], 1)
        pal = pal_rgb.tobytes()
    if header == 12:
        head = struct.pack("<IHHHH", 12, w, h, 1, bits)
        extra = b""
    else:
        ncolors = 0 if palette is None else len(palette)
        head = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                           compression, len(data), 2835, 2835, ncolors, 0)
        extra = b""
        if header == 40 and masks is not None:
            extra = struct.pack("<3I", *masks[:3])
        elif header > 40:
            m = tuple(masks or (0, 0, 0, 0)) + (0,) * 4
            head += struct.pack("<4I", *m[:4])[: min(16, header - 40)]
            head += b"\x00" * (header - len(head))
    offset = 14 + len(head) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset)
            + head + extra + pal + data)


def _literal_or_runs(row, pos, n, rle4):
    """RLE bytes of row[pos:pos+n] as an absolute run (n >= 3; RLE4 even n)
    or as encoded runs of one pixel."""
    vals = [int(v) for v in row[pos: pos + n]]
    if n >= 3 and (not rle4 or n % 2 == 0):
        if rle4:
            body = bytes((vals[i] << 4) | vals[i + 1] for i in range(0, n, 2))
        else:
            body = bytes(vals)
        return bytes([0, n]) + body + (b"\x00" if len(body) % 2 else b"")
    return b"".join(bytes([1, (v << 4) | v if rle4 else v]) for v in vals)


def _rle(indices: np.ndarray, rle4: bool) -> bytes:
    """Bottom-up RLE8 / RLE4 rows (runs of up to 255, absolute runs for
    stretches without repeats), end-of-line after each row, end of
    bitmap."""
    out = bytearray()
    for row in indices[::-1]:
        x, w = 0, len(row)
        while x < w:
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 2:
                v = int(row[x])
                out += bytes([run, (v << 4) | v if rle4 else v])
                x += run
                continue
            end = x + 1
            while end < w and end - x < 254 and row[end] != row[end - 1]:
                end += 1
            n = end - x if end == w else end - x - 1
            n = max(n, 1)
            out += _literal_or_runs(row, x, n, rle4)
            x += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def rle8(indices: np.ndarray) -> bytes:
    return _rle(indices, False)


def rle4(indices: np.ndarray) -> bytes:
    return _rle(indices, True)


# --- TIFF: a writer for the layouts PIL does not write ------------------------


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 to 128 equal bytes as (1 - n, byte), the rest as
    literals of up to 128 bytes."""
    out, lit, i, n = bytearray(), bytearray(), 0, len(data)

    def flush():
        while lit:
            chunk = lit[:128]
            out.append(len(chunk) - 1)
            out.extend(chunk)
            del lit[:128]

    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            flush()
            out += bytes([(257 - run) & 0xFF, data[i]])
            i += run
        else:
            lit.append(data[i])
            i += 1
    flush()
    return bytes(out)


def lzw(data: bytes) -> bytes:
    """TIFF LZW as libtiff's encoder writes it: codes MSB-first from 9 to 12
    bits, the width raised one code before the decoder's (the early change),
    ClearCode first and whenever the table reaches 4094, EOI last at the
    width the decoder expects after the last code's entry."""
    out, acc, nacc = bytearray(), 0, 0
    nbits = 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    put(256)
    table, free = {}, 258
    if data:
        ent = data[0]
        for c in data[1:]:
            key = (ent, c)
            if key in table:
                ent = table[key]
                continue
            put(ent)
            ent = c
            table[key] = free
            free += 1
            if free == 4094:
                put(256)
                table, free, nbits = {}, 258, 9
            elif free > (1 << nbits) - 1:
                nbits += 1
        put(ent)
        free += 1
        if free == 4094:
            put(256)
            nbits = 9
        elif free > (1 << nbits) - 1:
            nbits += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


class FaxBits:
    """A CCITT bit string written MSB first, with T.4's codes from
    figdraw_tpu_torch/utils/fax.py: runs, two-dimensional modes, EOLs."""

    def __init__(self):
        self.bits = []

    def put(self, code: str) -> "FaxBits":
        self.bits += [int(c) for c in code]
        return self

    def align(self, to: int = 8, before: int = 0) -> "FaxBits":
        """Zero bits until `before` bits from now end on a multiple of `to`."""
        self.bits += [0] * (-(len(self.bits) + before) % to)
        return self

    def run(self, span: int, black: bool) -> "FaxBits":
        """A run as libtiff's putspan codes it: 2560 make-ups while 2624 or
        more are left, one make-up, then the terminating code."""
        from figdraw_tpu_torch.utils import fax

        k = 2 if black else 1
        make = {c[0]: c[k] for c in fax.MAKE_UP}
        make.update(fax.EXTENDED_MAKE_UP)
        while span >= 2624:
            self.put(make[2560])
            span -= 2560
        if span >= 64:
            self.put(make[span // 64 * 64])
            span %= 64
        return self.put(fax.TERMINATING[span][k])

    def to_bytes(self) -> bytes:
        self.align()
        return np.packbits(np.array(self.bits, np.uint8)).tobytes() if self.bits else b""


def _changes(row: np.ndarray, start: int, colour: int) -> int:
    """The first index >= start whose bit is not `colour` (libtiff's finddiff)."""
    rest = np.flatnonzero(row[start:] != colour)
    return start + int(rest[0]) if len(rest) else len(row)


def fax_row_1d(out: FaxBits, row: np.ndarray) -> None:
    """Fax3Encode1DRow: alternating white and black runs (bit 1 black)."""
    x, black = 0, False
    while True:
        nxt = _changes(row, x, int(black))
        out.run(nxt - x, black)
        x = nxt
        if x >= len(row):
            return
        black = not black


_VCODES = {-3: "0000011", -2: "000011", -1: "011", 0: "1", 1: "010", 2: "000010",
           3: "0000010"}  # by b1 - a1


def fax_row_2d(out: FaxBits, row: np.ndarray, ref: np.ndarray) -> None:
    """Fax3Encode2DRow: the row coded against the reference row."""
    n = len(row)

    def px(buf, i):
        return int(buf[i]) if i < n else 0

    a0 = 0
    a1 = 0 if row[0] else _changes(row, 0, 0)
    b1 = 0 if ref[0] else _changes(ref, 0, 0)
    while True:
        b2 = _changes(ref, b1, px(ref, b1)) if b1 < n else n
        if b2 >= a1:
            d = b1 - a1
            if not -3 <= d <= 3:
                a2 = _changes(row, a1, px(row, a1)) if a1 < n else n
                out.put("001")
                first_black = not (a0 + a1 == 0 or px(row, a0) == 0)
                out.run(a1 - a0, first_black).run(a2 - a1, not first_black)
                a0 = a2
            else:
                out.put(_VCODES[d])
                a0 = a1
        else:
            out.put("0001")
            a0 = b2
        if a0 >= n:
            return
        c = px(row, a0)
        a1 = _changes(row, a0, c)
        b1 = _changes(ref, a0, 1 - c)
        b1 = _changes(ref, b1, c) if b1 < n else n


def fax_encode(bits: np.ndarray, compression: int, t4options: int = 0, k: int = 2,
               rtc: bool = True) -> bytes:
    """(rows, width) 0/1 bits (1 black) as one CCITT strip the way
    libtiff's encoder writes it: Modified Huffman (2) rows byte-aligned,
    RLE-W (32771) rows aligned to 16 bits of the strip;
    T.4 (3) an EOL before each row (fill bits before it with T4Options
    bit 2), one- or, with bit 0, two-dimensional with a 1D row every k
    rows and a tag bit after each EOL, and an RTC (six EOLs) at the end;
    T.6 (4) two-dimensional from an all-white reference, then EOFB."""
    out = FaxBits()
    two_d = compression == 4 or (compression == 3 and t4options & 1)
    ref = np.zeros(bits.shape[1], np.uint8)
    eol = "000000000001"
    for i, row in enumerate(bits.astype(np.uint8)):
        one_d = compression in (2, 32771) or (compression == 3 and (not two_d or i % k == 0))
        if compression == 3:
            if t4options & 4:
                out.align(8, 12)
            out.put(eol + ("1" if one_d else "0") * bool(two_d))
        if one_d:
            fax_row_1d(out, row)
        else:
            fax_row_2d(out, row, ref)
        if compression in (2, 32771):
            out.align(16 if compression == 32771 else 8)
        ref = row
    if compression == 3 and rtc:
        out.put((eol + "1" * bool(two_d)) * 6)
    elif compression == 4:
        out.put(eol * 2)
    return out.to_bytes()


def _sample_rows(block: np.ndarray, bits: int, order: str) -> np.ndarray:
    """(rows, cols, spp) samples to (rows, row bytes): sub-byte samples
    packed MSB-first with each row padded to a byte, wider ones in the
    file's byte order."""
    rows = block.shape[0]
    if bits < 8:
        flat = block.reshape(rows, -1).astype(np.uint8)
        per = 8 // bits
        pad = -flat.shape[1] % per
        flat = np.pad(flat, ((0, 0), (0, pad)))
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        return (flat.reshape(rows, -1, per) << shifts).sum(axis=2, dtype=np.uint8)
    dtype = block.dtype.newbyteorder(order) if block.dtype.itemsize > 1 else block.dtype
    return np.ascontiguousarray(block.astype(dtype)).view(np.uint8).reshape(rows, -1)


def _predict(block: np.ndarray, predictor: int, order: str) -> np.ndarray:
    """A chunk's samples (rows, cols, spp) encoded by libtiff's predictor to
    (rows, row bytes): 2 differences each sample from the one spp before it
    in its row, 3 splits each row into byte planes (most significant first)
    and differences the bytes spp apart."""
    rows, cols, spp = block.shape
    if predictor == 2:
        flat = block.reshape(rows, cols * spp)
        if flat.dtype.kind != "u":
            flat = flat.view(f"u{flat.dtype.itemsize}")
        diff = flat.copy()
        diff[:, spp:] = flat[:, spp:] - flat[:, :-spp]
        return _sample_rows(diff.reshape(block.shape), 8 * block.dtype.itemsize, order)
    nb = block.dtype.itemsize
    be = np.ascontiguousarray(block.astype(block.dtype.newbyteorder(">")))
    planes = be.view(np.uint8).reshape(rows, cols * spp, nb).transpose(0, 2, 1)
    b = planes.reshape(rows, -1).astype(np.int32)
    d = b.copy()
    d[:, spp:] = b[:, spp:] - b[:, :-spp]
    return (d & 0xFF).astype(np.uint8)


def _compress(raw: bytes, compression: int) -> bytes:
    if compression == 1:
        return raw
    if compression == 32773:
        return packbits(raw)
    if compression == 5:
        return lzw(raw)
    if compression in (8, 32946):
        return zlib.compress(raw, 6)
    if compression == 34925:
        return lzma.compress(raw, format=lzma.FORMAT_XZ, check=lzma.CHECK_NONE)
    if compression == 50000:
        return libzstd_compress(raw, 3, checksum=False)
    raise ValueError(f"no encoder for TIFF compression {compression}")


def jpeg_parts(stream: bytes) -> tuple:
    """A JPEG file split as TIFF keeps it: (the tables: SOI, DQT and DHT
    segments, EOI; the abbreviated stream: SOI, then every segment but the
    tables and APPn, from SOF to EOI)."""
    tables, rest, pos = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while True:
        code = stream[pos + 1]
        if code == 0xDA:
            rest += stream[pos:]
            return bytes(tables + b"\xff\xd9"), bytes(rest)
        (n,) = struct.unpack_from(">H", stream, pos + 2)
        seg = stream[pos: pos + 2 + n]
        if code in (0xDB, 0xC4):
            tables += seg
        elif not 0xE0 <= code <= 0xEF:
            rest += seg
        pos += 2 + n


_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8,
               13: 4, 16: 8, 17: 8, 18: 8}
_TYPE_CODES = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d", 13: "I",
               16: "Q", 17: "q", 18: "Q"}


def _field(order: str, ftype: int, values) -> bytes:
    if ftype in (2, 7) or (ftype == 1 and isinstance(values, bytes)):
        return bytes(values)
    if ftype in (5, 10):
        code = "I" if ftype == 5 else "i"
        return b"".join(struct.pack(order + code * 2, *v) for v in values)
    return struct.pack(order + _TYPE_CODES[ftype] * len(values), *values)


def tiff_bytes(samples: np.ndarray, photometric: int, bits: int = None, order: str = "<",
               big: bool = False, compression: int = 1, predictor: int = 1,
               planar: int = 1, rows_per_strip: int = None, tile: tuple = None,
               fill_order: int = 1, extra: tuple = (), sample_format: int = None,
               colormap: np.ndarray = None, jpeg_chunk=None, tags: dict = None,
               strip_counts: bool = True, codec=None, pad: bool = True) -> bytes:
    """A TIFF file of one image. samples: (h, w) or (h, w, spp) values (uint
    of bits <= 8 for sub-byte samples, else the dtype written). Strips of
    rows_per_strip rows (None: one strip, and no RowsPerStrip tag) or tiles
    of tile = (width, length), edge tiles padded past the image with zeros;
    planar 2 writes each sample's plane apart; fill_order 2 reverses the bits
    of every stored byte. jpeg_chunk(block) -> (tables, abbreviated stream)
    encodes a JPEG chunk (compression 7); codec(block) -> bytes any other
    compression (a CCITT one: fax_encode). tags: {tag: (type, values)}
    added or replacing the writer's own. pad=False stores each strip or
    tile right after the last (at an odd offset after an odd length; the
    IFD stays on a word)."""
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, spp = samples.shape
    bits = bits or 8 * samples.dtype.itemsize
    if sample_format is None:
        sample_format = 3 if samples.dtype.kind == "f" else 2 if samples.dtype.kind == "i" else 1
    planes = [samples[..., k: k + 1] for k in range(spp)] if planar == 2 else [samples]
    if tile:
        cw, ch = tile
    else:
        cw, ch = w, rows_per_strip or h
    chunks, tables = [], None
    for plane in planes:
        for y in range(0, h, ch):
            for x in range(0, w, cw):
                if tile:
                    block = np.zeros((ch, cw, plane.shape[2]), plane.dtype)
                    part = plane[y: y + ch, x: x + cw]
                    block[: part.shape[0], : part.shape[1]] = part
                else:
                    block = plane[y: y + ch]
                if compression == 7:
                    tables, data = jpeg_chunk(block)
                elif codec is not None:
                    data = codec(block)
                else:
                    if predictor in (2, 3):
                        rows = _predict(block, predictor, order)
                    else:
                        rows = _sample_rows(block, bits, order)
                    data = _compress(rows.tobytes(), compression)
                if fill_order == 2:
                    data = _REVERSED[np.frombuffer(data, np.uint8)].tobytes()
                chunks.append(data)
    off_type = 16 if big else 4
    fields = {256: (4, (w,)), 257: (4, (h,)), 258: (3, (bits,) * spp),
              259: (3, (compression,)), 262: (3, (photometric,)), 277: (3, (spp,)),
              284: (3, (planar,))}
    if fill_order != 1:
        fields[266] = (3, (fill_order,))
    if predictor != 1:
        fields[317] = (3, (predictor,))
    if extra:
        fields[338] = (3, tuple(extra))
    if sample_format != 1:
        fields[339] = (3, (sample_format,) * spp)
    if colormap is not None:
        fields[320] = (3, tuple(int(v) for v in np.asarray(colormap).T.reshape(-1)))
    if tables is not None:
        fields[347] = (7, tables)
    if tile:
        fields[322], fields[323] = (3, (cw,)), (3, (ch,))
        off_tag, count_tag = 324, 325
    else:
        if rows_per_strip:
            fields[278] = (4, (rows_per_strip,))
        off_tag, count_tag = 273, 279
    fields.update(tags or {})
    head = 16 if big else 8
    offsets, pos = [], head
    for data in chunks:
        offsets.append(pos)
        pos += len(data) + (len(data) & 1) * pad
    pos += pos & 1
    fields[off_tag] = (off_type, tuple(offsets))
    if strip_counts:
        fields[count_tag] = (off_type, tuple(len(d) for d in chunks))
    ifd_at = pos
    entry, inline = (20, 8) if big else (12, 4)
    n = len(fields)
    spill = ifd_at + (8 if big else 2) + n * entry + (8 if big else 4)
    entries, extra_data = bytearray(), bytearray()
    for tag in sorted(fields):
        ftype, values = fields[tag]
        raw = _field(order, ftype, values)
        count = len(raw) // _TYPE_SIZES[ftype]
        if len(raw) <= inline:
            value = raw + b"\0" * (inline - len(raw))
        else:
            value = struct.pack(order + ("Q" if big else "I"), spill + len(extra_data))
            extra_data += raw + b"\0" * (len(raw) & 1)
        entries += struct.pack(order + ("HHQ" if big else "HHI"), tag, ftype, count) + value
    if big:
        header = (b"II" if order == "<" else b"MM") + struct.pack(order + "HHHQ", 43, 8, 0, ifd_at)
        ifd = struct.pack(order + "Q", n) + entries + struct.pack(order + "Q", 0)
    else:
        header = (b"II" if order == "<" else b"MM") + struct.pack(order + "HI", 42, ifd_at)
        ifd = struct.pack(order + "H", n) + entries + struct.pack(order + "I", 0)
    body = b"".join(d + b"\0" * (len(d) & 1) * pad for d in chunks)
    return header + body + b"\0" * (len(body) & 1) + ifd + bytes(extra_data)


def _quantized(img, colors: int):
    """PIL's quantisation of an RGB image: (indices, (n, 3) palette)."""
    q = img.quantize(colors)
    pal = np.frombuffer(bytes(q.getpalette()[: 3 * colors]), np.uint8).reshape(-1, 3)
    return np.asarray(q), pal


def image_files() -> dict:
    """name -> bytes of every stored file."""
    from PIL import Image

    src = Image.open(FIXTURE).convert("RGBA")
    rgb = src.convert("RGB")
    files = {}

    def save(name, img, fmt, **kw):
        b = io.BytesIO()
        img.save(b, fmt, **kw)
        files[name] = b.getvalue()

    save(BASELINE, rgb, "JPEG", quality=90, subsampling="4:2:0")
    save("progressive_422.jpg", rgb, "JPEG", quality=90, subsampling="4:2:2",
         progressive=True)
    save("restart_444.jpg", rgb, "JPEG", quality=90, subsampling="4:4:4",
         restart_marker_rows=1)
    save("gray.jpg", rgb.convert("L"), "JPEG", quality=90)
    save("cmyk.jpg", rgb.convert("CMYK"), "JPEG", quality=90)
    save("crop_797x599.jpg", rgb.crop((2, 1, 799, 600)), "JPEG", quality=85)
    save("small_progressive_rst.jpg", rgb.crop((368, 276, 432, 324)), "JPEG", quality=75,
         progressive=True, restart_marker_blocks=2)
    centre = rgb.crop((240, 180, 560, 420))
    q = centre.quantize(64)
    save("transparent.gif", q, "GIF", transparency=int(np.asarray(q)[0, 0]))
    crop = rgb.crop((360, 270, 421, 317))  # 61x47: odd rows, padded strides
    px = np.asarray(crop)
    idx8, pal8 = _quantized(crop, 256)
    idx4, pal4 = _quantized(crop, 16)
    idx1, pal1 = _quantized(crop, 2)
    files["core_8bit.bmp"] = bmp_bytes(idx8, 8, 12, palette=pal8)
    files["info_24bit.bmp"] = bmp_bytes(px[..., ::-1], 24, 40)
    files["info_rle8.bmp"] = bmp_bytes(idx8, 8, 40, palette=pal8, compression=1,
                                       rle=rle8(idx8))
    files["info_rle4.bmp"] = bmp_bytes(idx4, 4, 40, palette=pal4, compression=2,
                                       rle=rle4(idx4))
    files["info_1bit.bmp"] = bmp_bytes(idx1, 1, 40, palette=pal1)
    v565 = ((px[..., 0].astype(np.uint16) >> 3) << 11) | ((px[..., 1].astype(np.uint16) >> 2)
                                                         << 5) | (px[..., 2] >> 3)
    files["v2_565.bmp"] = bmp_bytes(v565, 16, 52, compression=3,
                                    masks=(0xF800, 0x7E0, 0x1F))
    alpha = np.asarray(src.crop((360, 270, 421, 317)))[..., 3:].copy()
    alpha[::3, ::5] = 96
    bgra = np.concatenate([px[..., ::-1], alpha], -1)
    files["v3_bgra.bmp"] = bmp_bytes(bgra, 32, 56, compression=3,
                                     masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    files["v4_32bit_topdown.bmp"] = bmp_bytes(bgra, 32, 108, top_down=True)
    files["v5_4bit.bmp"] = bmp_bytes(idx4, 4, 124, palette=pal4)
    icon = src.crop((336, 236, 464, 364))
    save("png_entry.ico", icon, "ICO", sizes=[(64, 64)])
    save("dib_entry.ico", icon, "ICO", sizes=[(48, 48)], bitmap_format="bmp")
    save("image.qoi", src, "QOI")
    files.update(tiff_files(src))
    files.update(fax_zstd_files(src))
    files.update(webp_files(src))
    files.update(arith_lossless_files(src))
    files.update(jpeg_repair_files(src))
    files.update(ccitt_repair_files(src))
    save(AVIF_FIXTURE, src, "AVIF")
    save(AVIF_CDEF_FIXTURE, src, "AVIF", speed=2, advanced={"enable-cdef": "1"})
    save(AVIF_444_FIXTURE, src, "AVIF", subsampling="4:4:4")
    # aom turns every loop filter off on this smooth picture at limited
    # range: it is coded at full range (speed 0, CDEF on), then marked
    # limited-range BT.709, as camera and video files are
    save(AVIF_422_FIXTURE, src, "AVIF", subsampling="4:2:2", speed=0,
         advanced={"enable-cdef": "1"})
    files[AVIF_422_FIXTURE] = limited_bt709(files[AVIF_422_FIXTURE])
    for name, (source, depth) in AVIF_DEPTHS.items():
        files[name] = avif_at_depth(files[source], depth)
    files[AVIF_GRID_FIXTURE] = avif_grid(vignetted(np.asarray(src)), 4, 3, (200, 200))
    photo = np.asarray(rgb.resize((4032, 3024), Image.BILINEAR))
    files[AVIF_PHOTO] = avif_grid(photo, 8, 6, (512, 512), quality=50, speed=10)
    save(AVIF_GRAIN_FIXTURE, Image.fromarray(vignetted(np.asarray(src))), "AVIF",
         advanced={"film-grain-test": str(AVIF_GRAIN_VECTORS[AVIF_GRAIN_FIXTURE])})
    save(AVIF_GRAIN_422_10, src, "AVIF", subsampling="4:2:2",
         advanced={"film-grain-test": str(AVIF_GRAIN_VECTORS[AVIF_GRAIN_422_10])})
    files[AVIF_GRAIN_422_10] = avif_at_depth(files[AVIF_GRAIN_422_10], 10)
    px = np.asarray(src)
    frames = [Image.fromarray(vignetted(px[y:y + 64, x:x + 64])) for y, x in ((268, 368),
                                                                             (272, 372))]
    save(AVIF_SEQUENCE, frames[0], "AVIF", save_all=True, append_images=frames[1:], quality=50,
         alpha_premultiplied=True)
    files[AVIF_SEQUENCE] = steady_times(files[AVIF_SEQUENCE])
    return files


def card_rewrites(data: bytes) -> dict:
    """name -> bytes of the files chip_smoke.py makes on the card's host
    from the stored sequence (AVIF_SEQUENCE) by byte edits that keep every
    offset (no PIL there): "straight" (its prem references renamed, so
    that its alpha is straight), "limited alpha" (limited_alpha: the alpha
    track's color_range bit flipped), "still" (the major brand avif: the
    meta's primary item, which shares the first samples' bytes) and "lsel"
    (the still with the colour item's pixi renamed lsel, layer 0, and
    marked essential). tools/make_image_formats.py stores PIL's digest of
    each."""
    from figdraw_tpu_torch.utils import avif

    def edited(d: bytes, edits) -> bytes:
        out = bytearray(d)
        for at, value in edits:
            out[at:at + len(value)] = value
        return bytes(out)

    def boxes(d: bytes, kinds, start=0, end=None, into=(b"moov", b"trak", b"tref", b"meta",
                                                         b"iref", b"iprp", b"ipco")):
        for kind, s, e in avif._boxes(d, start, len(d) if end is None else end, top=start == 0):
            if kind in kinds:
                yield kind, s, e
            if kind in into:
                yield from boxes(d, kinds, s + (4 if kind in (b"meta", b"iref") else 0), e, into)

    straight = edited(data, [(s - 4, b"none") for _k, s, _e in boxes(data, (b"prem",))])
    still = edited(data, [(8, b"avif")])
    pixi = next(s for _k, s, _e in boxes(still, (b"pixi",)))
    _k, ps, pe = next(boxes(still, (b"ipma",)))
    ipma = still.index(b"\x00\x01\x04\x01\x02", ps, pe) + 4  # item 1: ispe, pixi (index 2)
    lsel = edited(still, [(pixi - 4, b"lsel"), (ipma, b"\x82")])
    return {"straight": straight, "limited alpha": limited_alpha(data), "still": still,
            "lsel": lsel}


def vignetted(rgba: np.ndarray) -> np.ndarray:
    """The pixels with an alpha that fades from 255 inside half the
    half-diagonal to 104 in the corners (the fixture's own is opaque)."""
    h, w = rgba.shape[:2]
    gy, gx = np.mgrid[0:h, 0:w]
    r = np.hypot((gx - (w - 1) / 2) / (w / 2), (gy - (h - 1) / 2) / (h / 2))
    out = rgba.copy()
    out[..., 3] = np.clip(255 - 150 * np.clip(r - 0.5, 0, None) / 0.91, 0, 255).astype(np.uint8)
    return out


def limited_bt709(data: bytes) -> bytes:
    """A PIL-written AVIF marked limited-range BT.709: the colr box's nclx
    (matrix 1, full_range_flag 0) and the AV1 sequence header's color_range
    bit wherever the header occurs (av1C's configOBUs and the item), which
    leave the decoded planes as they are."""
    from figdraw_tpu_torch.utils import av1, avif

    at = data.find(b"nclx") + 8
    data = data[:at] + (1).to_bytes(2, "big") + bytes([data[at + 2] & 0x7F]) + data[at + 3:]
    head = next(p for k, p in av1.obus(avif.parse(data).color) if k == av1.OBU_SEQUENCE_HEADER)
    return data.replace(head, _range_flipped(head))


def _range_flipped(head: bytes) -> bytes:
    """An AV1 sequence header OBU's payload with the one bit flipped that
    turns its full_range (color_range) alone."""
    from figdraw_tpu_torch.utils import av1

    seq = vars(av1.parse_sequence(head))
    for bit in range(len(head) * 8):
        flipped = bytearray(head)
        flipped[bit >> 3] ^= 0x80 >> (bit & 7)
        try:
            other = vars(av1.parse_sequence(bytes(flipped)))
        except (ValueError, NotImplementedError):
            continue
        if {k for k in seq if seq[k] != other[k]} == {"full_range"}:
            return bytes(flipped)
    raise ValueError("no color_range bit in the sequence header")


def limited_alpha(data: bytes) -> bytes:
    """A PIL-written AVIF (a still or a sequence) whose alpha is marked
    limited-range: the color_range bit of every sequence header of the
    alpha item's stream (and of the alpha track's samples) flipped, the
    file's length and offsets kept; the decoded alpha plane is as it was
    and libavif expands it to full range."""
    from figdraw_tpu_torch.utils import av1, avif

    still = avif.parse(data)
    head = next(p for k, p in av1.obus(still.alpha) if k == av1.OBU_SEQUENCE_HEADER)
    flipped = _range_flipped(head)
    out = bytearray(data)
    at = data.find(head)
    while at >= 0:
        if data[max(0, at - 2)] >> 3 == av1.OBU_SEQUENCE_HEADER or data[max(0, at - 3)] >> 3 \
                == av1.OBU_SEQUENCE_HEADER:
            out[at:at + len(head)] = flipped
        at = data.find(head, at + 1)
    out = bytes(out)
    if avif.parse(out).alpha == still.alpha:
        raise ValueError("the alpha stream's sequence header was not rewritten")
    return out


def _bits(data: bytes, start: int, end: int) -> list:
    return [(data[i >> 3] >> (7 - (i & 7))) & 1 for i in range(start, end)]


def sequence_header_at(head: bytes, depth: int) -> bytes:
    """An AV1 sequence header OBU's payload with its color_config rewritten
    to `depth` bits (high_bitdepth; at 12 bits profile 2 with twelve_bit and
    the stream's subsampling coded after color_range, a 4:2:0 stream keeping
    its chroma sample position); everything else is kept. The result is
    parsed back and held to the intended fields field by field (a bit
    slipped to the wrong place, such as the subsampling bits written after
    twelve_bit, parses as another stream: monochrome)."""
    from figdraw_tpu_torch.utils import av1

    seq = av1.parse_sequence(head)
    profile = 2 if depth == 12 else seq.profile
    ssx, ssy = seq.ssx, seq.ssy
    bits = [(profile >> 2) & 1, (profile >> 1) & 1, profile & 1] + _bits(head, 3, seq.color_bit)
    bits += [int(depth > 8)] + ([int(depth == 12)] if profile == 2 and depth > 8 else [])
    if profile != 1:
        bits.append(seq.mono)
    bits.append(seq.color_description)
    if seq.color_description:
        for v in (seq.primaries, seq.transfer, seq.matrix):
            bits += [(v >> (7 - k)) & 1 for k in range(8)]
    if seq.mono:
        bits.append(seq.full_range)
    else:
        if (seq.primaries, seq.transfer, seq.matrix) != (1, 13, 0):
            bits.append(seq.full_range)
            if profile == 2 and depth == 12:
                bits += [ssx] + ([ssy] if ssx else [])
            if ssx and ssy:
                bits += [(seq.chroma_position >> 1) & 1, seq.chroma_position & 1]
        bits.append(seq.separate_uv_dq)
    bits += [seq.film_grain, 1]  # film_grain_params_present, trailing_one_bit
    bits += [0] * (-len(bits) % 8)
    out = bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))
    check_rewrite(out, head, depth)
    return out


def check_rewrite(out: bytes, head: bytes, depth: int) -> None:
    """Raises ValueError unless the sequence header `out` parses, field by
    field, as `head` at `depth` bits (in profile 2 at 12 bits)."""
    from figdraw_tpu_torch.utils import av1

    seq = av1.parse_sequence(head)
    got, want = vars(av1.parse_sequence(out)), dict(vars(seq))
    want.update(profile=2 if depth == 12 else seq.profile, bit_depth=depth)
    if got != want:
        raise ValueError("AV1: the rewritten sequence header parses as "
                         f"{ {k: got[k] for k in got if got[k] != want.get(k)} }")


class _Bits:
    """An MSB-first bit reader (`read`) and writer (`put`) of AV1 headers."""

    def __init__(self, data: bytes = b""):
        self.data, self.pos, self.out = data, 0, []

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def uvlc(self) -> int:
        zeros = 0
        while not self.read(1):
            zeros += 1
        return self.read(zeros) + (1 << zeros) - 1

    def put(self, value: int, n: int) -> None:
        self.out += [(value >> (n - 1 - k)) & 1 for k in range(n)]

    def put_uvlc(self, value: int) -> None:
        n = (value + 1).bit_length() - 1
        self.put(0, n)
        self.put(value + 1, n + 1)

    def payload(self, rest: list = ()) -> bytes:
        """The bits written, then `rest`, then trailing_bits (a one, then
        zeros to a byte)."""
        bits = self.out + list(rest) + [1]
        bits += [0] * (-len(bits) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


def sequence_fields(head: bytes) -> dict:
    """Every field of a full (not reduced) AV1 sequence header OBU's payload
    up to color_config, by the specification's names, with "ops" a list of
    operating points (idc, level, tier, decoder model params or None,
    initial display delay or None) and "rest" the bits from color_config to
    the trailing one bit."""
    r = _Bits(head)
    f = {"profile": r.read(3), "still": r.read(1), "reduced": r.read(1)}
    assert not f["reduced"], "a reduced still-picture header"
    f["timing"] = r.read(1)
    if f["timing"]:
        f["units"], f["scale"], f["equal"] = r.read(32), r.read(32), r.read(1)
        if f["equal"]:
            f["ticks"] = r.uvlc()
        f["model"] = r.read(1)
        if f["model"]:
            f["delay_len"], f["decoding_tick"] = r.read(5) + 1, r.read(32)
            f["removal_len"], f["presentation_len"] = r.read(5) + 1, r.read(5) + 1
    f["display_delay"] = r.read(1)
    f["ops"] = []
    for _ in range(r.read(5) + 1):
        idc, level = r.read(12), r.read(5)
        tier = r.read(1) if level > 7 else 0
        model = None
        if f.get("model") and r.read(1):
            n = f["delay_len"]
            model = (r.read(n), r.read(n), r.read(1))
        delay = r.read(4) if f["display_delay"] and r.read(1) else None
        f["ops"].append((idc, level, tier, model, delay))
    f["wbits"], f["hbits"] = r.read(4) + 1, r.read(4) + 1
    f["max_w"], f["max_h"] = r.read(f["wbits"]), r.read(f["hbits"])
    f["frame_ids"] = r.read(1)
    if f["frame_ids"]:
        f["delta_id_len"], f["extra_id_len"] = r.read(4) + 2, r.read(3) + 1
    for name in ("use128", "filter_intra", "edge", "interintra", "masked", "warped", "dual",
                 "order_hint"):
        f[name] = r.read(1)
    if f["order_hint"]:
        f["jnt"], f["ref_mvs"] = r.read(1), r.read(1)
    f["choose_sct"] = r.read(1)
    f["sct"] = 2 if f["choose_sct"] else r.read(1)
    if f["sct"]:
        f["choose_imv"] = r.read(1)
        f["imv"] = 2 if f["choose_imv"] else r.read(1)
    if f["order_hint"]:
        f["hint_bits"] = r.read(3) + 1
    end = len(head) * 8 - 1
    while not (head[end >> 3] >> (7 - (end & 7))) & 1:
        end -= 1
    f["rest"] = _bits(head, r.pos, end)
    return f


def write_sequence(f: dict) -> bytes:
    """A sequence header OBU's payload from sequence_fields' dict."""
    w = _Bits()
    w.put(f["profile"], 3)
    w.put(f["still"], 1)
    w.put(0, 1)
    w.put(f["timing"], 1)
    if f["timing"]:
        w.put(f["units"], 32)
        w.put(f["scale"], 32)
        w.put(f["equal"], 1)
        if f["equal"]:
            w.put_uvlc(f["ticks"])
        w.put(f["model"], 1)
        if f["model"]:
            for key, n in (("delay_len", 5), ("decoding_tick", 32), ("removal_len", 5),
                           ("presentation_len", 5)):
                w.put(f[key] - (key != "decoding_tick"), n)
    w.put(f["display_delay"], 1)
    w.put(len(f["ops"]) - 1, 5)
    for idc, level, tier, model, delay in f["ops"]:
        w.put(idc, 12)
        w.put(level, 5)
        if level > 7:
            w.put(tier, 1)
        if f.get("model"):
            w.put(model is not None, 1)
            if model is not None:
                w.put(model[0], f["delay_len"])
                w.put(model[1], f["delay_len"])
                w.put(model[2], 1)
        if f["display_delay"]:
            w.put(delay is not None, 1)
            if delay is not None:
                w.put(delay, 4)
    w.put(f["wbits"] - 1, 4)
    w.put(f["hbits"] - 1, 4)
    w.put(f["max_w"], f["wbits"])
    w.put(f["max_h"], f["hbits"])
    w.put(f["frame_ids"], 1)
    if f["frame_ids"]:
        w.put(f["delta_id_len"] - 2, 4)
        w.put(f["extra_id_len"] - 1, 3)
    for name in ("use128", "filter_intra", "edge", "interintra", "masked", "warped", "dual",
                 "order_hint"):
        w.put(f[name], 1)
    if f["order_hint"]:
        w.put(f["jnt"], 1)
        w.put(f["ref_mvs"], 1)
    w.put(f["choose_sct"], 1)
    if not f["choose_sct"]:
        w.put(f["sct"], 1)
    if f["sct"]:
        w.put(f["choose_imv"], 1)
        if not f["choose_imv"]:
            w.put(f["imv"], 1)
    if f["order_hint"]:
        w.put(f["hint_bits"] - 1, 3)
    return w.payload(f["rest"])


def frame_prefix(payload: bytes, f: dict) -> tuple:
    """A shown key frame header's fields before frame_size (under the
    sequence's fields `f`): (the values read, the bit where the rest of the
    header starts)."""
    r = _Bits(payload)
    v = {"existing": r.read(1), "type": r.read(2), "show": r.read(1)}
    assert (v["existing"], v["type"], v["show"]) == (0, 0, 1), "not a shown key frame"
    if f.get("model") and not f["equal"]:
        r.read(f["presentation_len"])
    v["cdf"] = r.read(1)
    v["sct"] = r.read(1) if f["sct"] == 2 else f["sct"]
    if v["sct"] and f.get("imv") == 2:
        v["imv"] = r.read(1)
    if f["frame_ids"]:
        r.read(f["delta_id_len"] + f["extra_id_len"])
    v["override"] = r.read(1)
    r.read(f.get("hint_bits", 0) if f["order_hint"] else 0)
    if f.get("model") and r.read(1):
        for idc, _l, _t, model, _d in f["ops"]:
            if model is not None and (idc == 0 or (idc & 1 and idc & 0x100)):
                r.read(f["removal_len"])
    return v, r.pos


def write_frame_prefix(v: dict, f: dict, layer=(0, 0)) -> _Bits:
    """frame_prefix's fields written for the sequence `f`, a frame of the
    OBU layer (temporal id, spatial id): presentation time, frame id and
    order hint 0, the buffer removal times (0) of the operating points
    whose layers hold the frame."""
    w = _Bits()
    w.put(0, 1)
    w.put(0, 2)
    w.put(1, 1)
    if f.get("model") and not f["equal"]:
        w.put(0, f["presentation_len"])
    w.put(v["cdf"], 1)
    if f["sct"] == 2:
        w.put(v["sct"], 1)
    elif f["sct"] != v["sct"]:
        raise ValueError("the frame's screen content tools differ from the sequence's")
    if v["sct"] and f.get("imv") == 2:
        w.put(v.get("imv", 0), 1)
    if f["frame_ids"]:
        w.put(0, f["delta_id_len"] + f["extra_id_len"])
    w.put(v["override"], 1)
    w.put(0, f.get("hint_bits", 0) if f["order_hint"] else 0)
    if f.get("model"):
        w.put(1, 1)
        t, sp = layer
        for idc, _l, _t, model, _d in f["ops"]:
            if model is not None and (idc == 0 or ((idc >> t) & 1 and (idc >> (sp + 8)) & 1)):
                w.put(0, f["removal_len"])
    return w


def stream_variant(stream: bytes, split: bool = False, layer=None, **changes) -> bytes:
    """A sequence's first sample (temporal delimiter, a full sequence
    header, one OBU_FRAME of a shown key frame, as aom writes it) with its
    sequence header's fields changed (sequence_fields' names: `timing`,
    `equal`, `model`, `ops`, `frame_ids`, `choose_sct`, `sct`, `order_hint`,
    ...) and its frame header rewritten to match, every tile byte kept;
    `split` writes the frame as an OBU_FRAME_HEADER (with trailing bits)
    and an OBU_TILE_GROUP; `layer` (temporal id, spatial id) gives each OBU
    but the delimiter and the sequence header an extension header."""
    from figdraw_tpu_torch.utils import av1

    units = list(av1.obus(stream))
    head = next(p for k, p in units if k == av1.OBU_SEQUENCE_HEADER)
    old = sequence_fields(head)
    new = dict(old, **changes)
    seq_payload = write_sequence(new)
    out = b""
    for kind, payload in units:
        if kind == av1.OBU_SEQUENCE_HEADER:
            out += _obu(kind, seq_payload)
        elif kind == av1.OBU_FRAME:
            r = av1.BitReader(payload)
            av1.parse_frame_header(r, av1.parse_sequence(head))
            end, tiles = r.bit, payload[(r.bit + 7) >> 3:]
            v, at = frame_prefix(payload, old)
            w = write_frame_prefix(v, new, layer or (0, 0))
            rest = _bits(payload, at, end)
            if split:
                out += _obu_at(av1.OBU_FRAME_HEADER, w.payload(rest), layer)
                out += _obu_at(av1.OBU_TILE_GROUP, tiles, layer)
            else:
                bits = w.out + rest
                bits += [0] * (-len(bits) % 8)
                header = bytes(int("".join(map(str, bits[i:i + 8])), 2)
                               for i in range(0, len(bits), 8))
                out += _obu_at(kind, header + tiles, layer)
        else:
            out += _obu(kind, payload)
    return out


def _obu_at(kind: int, payload: bytes, layer=None) -> bytes:
    """An OBU with its size, and an extension header for `layer`
    (temporal id, spatial id) where one is given."""
    if layer is None:
        return _obu(kind, payload)
    plain = _obu(kind, payload)
    return bytes([plain[0] | 4, (layer[0] << 5) | (layer[1] << 3)]) + plain[1:]


def _obu(kind: int, payload: bytes) -> bytes:
    size, n = b"", len(payload)
    while True:
        size += bytes([(n & 0x7F) | (0x80 if n >> 7 else 0)])
        n >>= 7
        if not n:
            break
    return bytes([(kind << 3) | 2]) + size + payload


def stream_at(stream: bytes, depth: int) -> bytes:
    """An item's AV1 stream with each sequence header OBU rewritten by
    sequence_header_at (the OBUs re-sized; every tile symbol kept)."""
    from figdraw_tpu_torch.utils import av1

    out = b""
    for kind, payload in av1.obus(stream):
        if kind == av1.OBU_SEQUENCE_HEADER:
            payload = sequence_header_at(payload, depth)
        out += _obu(kind, payload)
    return out


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def avif_at_depth(data: bytes, depth: int, alpha_depth: int = None) -> bytes:
    """A libavif-written 8-bit AVIF (PIL's save, or avif_grid's) made a
    `depth`-bit one, as no encoder on this host writes one (aom in PIL's
    libavif has no high bit depth): the sequence header of every av01 item
    (the colour item or a grid's tiles, and the alpha item or its grid's
    tiles, at `alpha_depth`, the colour's by default) rewritten by
    stream_at, in the items and in each av1C's configOBUs, av1C's profile,
    high_bitdepth, twelve_bit and subsampling bits and pixi's depths (a
    grid item's too) set to match, and the boxes rebuilt around the longer
    streams (ftyp, meta: hdlr, pitm, iloc version 0 with 4-byte offsets and
    lengths, iinf, iref, iprp; then mdat). The tiles' symbols are kept:
    their samples are read at the new depth."""
    from figdraw_tpu_torch.utils import av1, avif

    alpha_depth = depth if alpha_depth is None else alpha_depth
    top = list(avif._boxes(data, 0, len(data), top=True))
    ftyp = next(data[s - 8:e] for k, s, e in top if k == b"ftyp")
    _k, ms, me = next(b for b in top if b[0] == b"meta")
    heif = Heif(data)
    parts, ipco, ipma, iloc = [], [], {}, {}
    for kind, s, e in avif._boxes(data, ms + 4, me):
        if kind == b"iloc":
            c = avif._Cursor(data, s, e)
            avif._parse_iloc(c, iloc := avif._Items())
        if kind == b"iprp":
            for pk, ps, pe in avif._boxes(data, s, e):
                if pk == b"ipco":
                    ipco = [(kk, data[a:b]) for kk, a, b in avif._boxes(data, ps, pe)]
                elif pk == b"ipma":
                    c = avif._Cursor(data, ps, pe)
                    _v, flags = c.full((0, 1))
                    for _ in range(c.uint(4)):
                        item = c.uint(2)
                        ipma[item] = [c.uint(2 if flags & 1 else 1) for _a in range(c.uint(1))]
        parts.append((kind, data[s - 8:e]))
    assert all(len(iloc[i].extents) == 1 for i in iloc)
    alpha = {f for k, f, to in heif.refs if k == b"auxl" and heif.primary in to}
    alpha |= {t for k, f, to in heif.refs if k == b"dimg" and f in alpha for t in to}
    ids = list(iloc)
    depths = {i: alpha_depth if i in alpha else depth for i in ids}
    streams = {i: stream_at(heif.items[i]["data"], depths[i])
               if heif.items[i]["type"] == b"av01" else heif.items[i]["data"] for i in ids}
    for i in ids:
        seq = None
        if heif.items[i]["type"] == b"av01":
            seq = av1.parse_sequence(next(p for k, p in av1.obus(streams[i])
                                          if k == av1.OBU_SEQUENCE_HEADER))
        for index in ipma[i]:
            kind, payload = ipco[(index & 0x7F) - 1]
            if kind == b"av1C" and seq is not None:
                b2 = (payload[2] & 0x83) | (int(seq.bit_depth > 8) << 6) | (
                    int(seq.bit_depth == 12) << 5) | (seq.mono << 4) | (seq.ssx << 3) | (seq.ssy << 2)
                config = stream_at(payload[4:], seq.bit_depth)
                payload = bytes([payload[0], (seq.profile << 5) | (payload[1] & 31), b2,
                                 payload[3]]) + config
            elif kind == b"pixi":
                payload = payload[:5] + bytes([depths[i]] * payload[4])
            ipco[(index & 0x7F) - 1] = (kind, payload)
    iprp_at = next(k for k, (kind, _b) in enumerate(parts) if kind == b"iprp")
    ipma_box = next(data[a - 8:b] for k, s, e in top if k == b"meta"
                    for kk, ss, ee in avif._boxes(data, ms + 4, me) if kk == b"iprp"
                    for kind, a, b in avif._boxes(data, ss, ee) if kind == b"ipma")
    parts[iprp_at] = (b"iprp", _box(b"iprp", _box(b"ipco", b"".join(_box(k, p) for k, p in ipco))
                                    + ipma_box))

    def build(base: int) -> bytes:
        body = struct.pack(">HH", 0x4400, len(ids))
        pos = base
        for i in ids:
            body += struct.pack(">HHHII", i, 0, 1, pos, len(streams[i]))
            pos += len(streams[i])
        iloc_box = _box(b"iloc", struct.pack(">I", 0) + body)
        return _box(b"meta", data[ms:ms + 4] + b"".join(
            iloc_box if kind == b"iloc" else raw for kind, raw in parts))

    base = len(ftyp) + len(build(0)) + 8
    return ftyp + build(base) + _box(b"mdat", b"".join(streams[i] for i in ids))


def _uint_bits(value: int, n: int) -> list:
    return [(value >> (n - 1 - k)) & 1 for k in range(n)]


def film_grain_bits(params, seq) -> list:
    """film_grain_params (AV1 specification 5.9.30) of a key frame of the
    sequence `seq` (av1.Sequence), as bits: apply_grain 0 for None, else
    every field of `params`, a dict of "seed" (16 bits), "y", "cb", "cr"
    (lists of (x, scaling) points; "cb" and "cr" written where the syntax
    reads them), "csfl" (chroma_scaling_from_luma), "scaling_shift" (8-11),
    "lag" (0-3), "ar_y", "ar_cb", "ar_cr" (the AR coefficients, -128..127,
    as many as the syntax reads), "ar_shift" (6-9), "grain_scale_shift"
    (0-3), "cb_mult", "cb_luma_mult" (-128..127), "cb_offset" (-256..255),
    the same for "cr_", "overlap" and "clip". Nothing is checked: a count
    past the syntax's limits is written as given (4 bits)."""
    if params is None:
        return [0]
    q = params
    bits = [1] + _uint_bits(q["seed"], 16)

    def points(pts):
        out = _uint_bits(len(pts), 4)
        for x, v in pts:
            out += _uint_bits(x, 8) + _uint_bits(v, 8)
        return out
    bits += points(q["y"])
    csfl = 0 if seq.mono else q.get("csfl", 0)
    if not seq.mono:
        bits.append(csfl)
    chroma = {"cb": [], "cr": []}
    if not (seq.mono or csfl or (seq.ssx and seq.ssy and not q["y"])):
        for name in ("cb", "cr"):
            chroma[name] = q.get(name, [])
            bits += points(chroma[name])
    bits += _uint_bits(q["scaling_shift"] - 8, 2) + _uint_bits(q["lag"], 2)
    num_pos = 2 * q["lag"] * (q["lag"] + 1)
    if q["y"]:
        bits += sum((_uint_bits(c + 128, 8) for c in q["ar_y"][:num_pos]), [])
    for name in ("cb", "cr"):
        if chroma[name] or csfl:
            count = num_pos + int(bool(q["y"]))
            bits += sum((_uint_bits(c + 128, 8) for c in q["ar_" + name][:count]), [])
    bits += _uint_bits(q["ar_shift"] - 6, 2) + _uint_bits(q["grain_scale_shift"], 2)
    for name in ("cb", "cr"):
        if chroma[name]:
            bits += (_uint_bits(q[name + "_mult"] + 128, 8) + _uint_bits(q[name + "_luma_mult"] + 128, 8)
                     + _uint_bits(q[name + "_offset"] + 256, 9))
    return bits + [q["overlap"], q["clip"]]


def stream_with_grain(stream: bytes, params) -> bytes:
    """An item's AV1 stream (a sequence header with film_grain_params_present
    and one OBU_FRAME, as aom writes a still) with the frame header's
    film_grain_params replaced by film_grain_bits(params): the header's
    bits before them kept, the new ones byte-aligned, the tile group's
    bytes kept, the OBU re-sized."""
    from figdraw_tpu_torch.utils import av1

    out, seq = b"", None
    for kind, payload in av1.obus(stream):
        if kind == av1.OBU_SEQUENCE_HEADER:
            seq = av1.parse_sequence(payload)
            if not seq.film_grain:
                raise ValueError("AV1: the sequence header has no film_grain_params_present")
        elif kind == av1.OBU_FRAME:
            r = av1.BitReader(payload)
            fh = av1.parse_frame_header(r, seq)
            grain = film_grain_bits(params, seq)
            bits = _bits(payload, 0, fh["grain_bit"]) + grain
            bits += [0] * (-len(bits) % 8)
            head = bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))
            payload = head + payload[(r.bit + 7) >> 3:]
            try:  # read back: the same bits where the parser takes the header
                r = av1.BitReader(payload)
                av1.parse_frame_header(r, seq)
            except ValueError:  # a header dav1d rejects, as asked
                pass
            else:
                if _bits(payload, fh["grain_bit"], r.bit) != grain:
                    raise ValueError("AV1: the rewritten film grain parameters read back otherwise")
        elif kind == av1.OBU_FRAME_HEADER:
            raise ValueError("AV1: a separate frame header OBU (not rewritten)")
        out += _obu(kind, payload)
    return out


def avif_with_grain(data: bytes, params) -> bytes:
    """An AVIF file written with film grain (aom's film-grain-test, so that
    its sequence headers set film_grain_params_present) whose every av01
    item (colour, alpha and grid tiles) takes the film grain parameters
    `params` (see film_grain_bits; None: apply_grain 0)."""
    heif = Heif(data)
    for item in heif.items.values():
        if item["type"] == b"av01":
            item["data"] = stream_with_grain(item["data"], params)
    return heif.write()


_LIBAVIF = []
AVIF_FORMATS = {"4:4:4": 1, "4:2:2": 2, "4:2:0": 3, "4:0:0": 4}  # avifPixelFormat


def _libavif():
    """PIL's libavif 1.3.0 (pillow.libs) through ctypes, for its encoder."""
    if not _LIBAVIF:
        from PIL import Image

        path = glob.glob(os.path.join(os.path.dirname(os.path.dirname(Image.__file__)),
                                      "pillow.libs", "libavif-*.so*"))[0]
        lib = ctypes.CDLL(path)
        for name, args, res in (
                ("avifEncoderCreate", [], _P), ("avifEncoderDestroy", [_P], None),
                ("avifImageCreate", [ctypes.c_uint32] * 3 + [ctypes.c_int], _P),
                ("avifImageDestroy", [_P], None), ("avifRGBImageSetDefaults", [_P, _P], None),
                ("avifImageRGBToYUV", [_P, _P], ctypes.c_int),
                ("avifEncoderAddImageGrid", [_P, ctypes.c_uint32, ctypes.c_uint32, _P,
                                             ctypes.c_int], ctypes.c_int),
                ("avifEncoderFinish", [_P, _P], ctypes.c_int), ("avifRWDataFree", [_P], None),
                ("avifResultToString", [ctypes.c_int], ctypes.c_char_p)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _LIBAVIF.append(lib)
    return _LIBAVIF[0]


def _poke(addr: int, off: int, value: int, n: int = 4) -> None:
    ctypes.memmove(addr + off, int(value).to_bytes(n, "little", signed=value < 0), n)


def avif_grid(pixels: np.ndarray, columns: int, rows: int, tile: tuple, quality: int = 75,
              speed: int = 6, subsampling: str = "4:2:0", full_range: bool = True,
              **aom) -> bytes:
    """An AVIF grid image of (h, w, 3 or 4) uint8 RGB(A) pixels through
    libavif's own encoder (PIL's save writes no grid): the pixels cut into
    columns x rows cells of `tile` (width, height), the last column and row
    narrower where the pixels end, each converted by avifImageRGBToYUV with
    the colour fields PIL's save sets (BT.709 primaries, sRGB transfer,
    BT.601 matrix, full range unless asked), then avifEncoderAddImageGrid
    (AVIF_ADD_IMAGE_FLAG_SINGLE) and avifEncoderFinish with aom at `speed`
    and `quality` (alpha too). libavif stores every cell at the tile size
    and writes the grid's output size; a non-opaque alpha channel becomes
    an alpha grid. `aom` sets aom's options by name (`enable_cdef="1"`
    for `enable-cdef`). libavif refuses a grid MIAF does not allow
    (ValueError with its message): cells under 64, odd sizes where chroma
    is subsampled."""
    lib = _libavif()
    px = np.ascontiguousarray(pixels, np.uint8)
    tw, th = tile
    cells, held = [], []
    enc = lib.avifEncoderCreate()
    out = (ctypes.c_uint8 * 16)()
    try:
        for r in range(rows):
            for c in range(columns):
                cell = np.ascontiguousarray(px[r * th:(r + 1) * th, c * tw:(c + 1) * tw])
                img = lib.avifImageCreate(cell.shape[1], cell.shape[0], 8,
                                          AVIF_FORMATS[subsampling])
                cells.append(img)
                _poke(img, 16, int(full_range))  # yuvRange
                for off, v in ((104, 1), (106, 13), (108, 6)):  # primaries, transfer, matrix
                    _poke(img, off, v, 2)
                rgb = ctypes.create_string_buffer(256)  # avifRGBImage
                lib.avifRGBImageSetDefaults(ctypes.addressof(rgb), img)
                _poke(ctypes.addressof(rgb), 12, 1 if px.shape[2] == 4 else 0)  # RGBA / RGB
                _poke(ctypes.addressof(rgb), 48, cell.ctypes.data, 8)
                _poke(ctypes.addressof(rgb), 56, cell.strides[0])
                held.append((rgb, cell))
                res = lib.avifImageRGBToYUV(img, ctypes.addressof(rgb))
                if res:
                    raise ValueError(f"avifImageRGBToYUV: {lib.avifResultToString(res).decode()}")
        for off, v in ((8, speed), (32, quality), (36, quality)):  # speed, quality, qualityAlpha
            _poke(enc, off, v)
        for key, value in aom.items():
            if lib.avifEncoderSetCodecSpecificOption(ctypes.c_void_p(enc),
                                                    key.replace("_", "-").encode(),
                                                    str(value).encode()):
                raise ValueError(f"aom option {key}")
        grid = (ctypes.c_void_p * len(cells))(*cells)
        res = lib.avifEncoderAddImageGrid(enc, columns, rows, grid, 2)
        if not res:
            res = lib.avifEncoderFinish(enc, ctypes.addressof(out))
        if res:
            raise ValueError(f"libavif: {lib.avifResultToString(res).decode()}")
        return ctypes.string_at(int.from_bytes(bytes(out[:8]), "little"),
                                int.from_bytes(bytes(out[8:]), "little"))
    finally:
        lib.avifRWDataFree(ctypes.addressof(out))
        lib.avifEncoderDestroy(enc)
        for img in cells:
            lib.avifImageDestroy(img)


class Heif:
    """An AVIF file's items, to edit and write again: `ftyp` (its payload),
    `primary`, `items` (id -> {"type", "flags", "name", "data", "props":
    [(ipco index, essential)]}, in iinf order), `ipco` [(kind, payload)]
    and `refs` [(kind, from, [to])]. `write` lays them out as libavif
    does: ftyp, then meta (hdlr, pitm, iloc version 0 with 4-byte offsets
    and lengths into one mdat, iinf, iref, iprp), then mdat."""

    def __init__(self, data: bytes):
        from figdraw_tpu_torch.utils import avif

        top = list(avif._boxes(data, 0, len(data), top=True))
        self.ftyp = next(data[s:e] for k, s, e in top if k == b"ftyp")
        _k, ms, me = next(b for b in top if b[0] == b"meta")
        self.items, self.ipco, self.refs, idat = {}, [], [], b""
        iloc = avif._Items()
        for kind, s, e in avif._boxes(data, ms + 4, me):
            c = avif._Cursor(data, s, e)
            if kind == b"pitm":
                c.full()
                self.primary = c.uint(2)
            elif kind == b"iloc":
                avif._parse_iloc(c, iloc)
            elif kind == b"idat":
                idat = data[s:e]
            elif kind == b"iinf":
                c.full()
                c.uint(2)
                for _ik, a, b in avif._boxes(data, c.pos, e):
                    ic = avif._Cursor(data, a, b)
                    _v, flags = ic.full((2,))
                    item_id = ic.uint(2)
                    ic.uint(2)
                    self.items[item_id] = {"type": ic.take(4), "flags": flags,
                                           "name": ic.cstring(), "data": b"", "props": []}
            elif kind == b"iref":
                c.full()
                for rk, a, b in avif._boxes(data, c.pos, e):
                    rc = avif._Cursor(data, a, b)
                    frm = rc.uint(2)
                    self.refs.append((rk, frm, [rc.uint(2) for _ in range(rc.uint(2))]))
            elif kind == b"iprp":
                for pk, ps, pe in avif._boxes(data, s, e):
                    pc = avif._Cursor(data, ps, pe)
                    if pk == b"ipco":
                        self.ipco = [(kk, data[a:b]) for kk, a, b in avif._boxes(data, ps, pe)]
                    elif pk == b"ipma":
                        _v, flags = pc.full()
                        for _ in range(pc.uint(4)):
                            item_id = pc.uint(2)
                            for _a in range(pc.uint(1)):
                                v = pc.uint(2 if flags & 1 else 1)
                                wide = 15 if flags & 1 else 7
                                self.items[item_id]["props"].append((v & ((1 << wide) - 1),
                                                                     v >> wide))
        for item_id, item in iloc.items():
            self.items[item_id]["data"] = avif._item_bytes(data, item, idat)

    def prop(self, item_id: int, kind: bytes):
        """The ipco index of an item's property of `kind`, or None."""
        return next((i for i, _e in self.items[item_id]["props"]
                     if self.ipco[i - 1][0] == kind), None)

    def set_prop(self, item_id: int, kind: bytes, payload: bytes, essential: int = 0) -> None:
        """Gives the item alone a property of `kind` (a new ipco entry in
        place of its own, if it had one)."""
        self.ipco.append((kind, payload))
        props = [(i, e) for i, e in self.items[item_id]["props"] if self.ipco[i - 1][0] != kind]
        self.items[item_id]["props"] = props + [(len(self.ipco), essential)]

    def tiles(self, grid_id: int) -> list:
        return next(to for k, f, to in self.refs if k == b"dimg" and f == grid_id)

    def write(self, offsets: dict = None) -> bytes:
        """The file; with `offsets` (item id -> file offset of its data),
        the meta box alone, its iloc pointing there."""
        ids = list(self.items)
        hdlr = _box(b"hdlr", bytes(8) + b"pict" + bytes(13))
        pitm = _box(b"pitm", bytes(4) + struct.pack(">H", self.primary))
        iinf = _box(b"iinf", bytes(4) + struct.pack(">H", len(ids)) + b"".join(
            _box(b"infe", struct.pack(">I", (2 << 24) | it["flags"]) + struct.pack(">HH", i, 0)
                 + it["type"] + it["name"] + b"\0") for i, it in self.items.items()))
        iref = _box(b"iref", bytes(4) + b"".join(
            _box(k, struct.pack(">HH", f, len(to)) + b"".join(struct.pack(">H", t) for t in to))
            for k, f, to in self.refs)) if self.refs else b""
        wide = len(self.ipco) > 127
        assoc = b"".join(struct.pack(">HB", i, len(it["props"])) + b"".join(
            struct.pack(">H", (e << 15) | x) if wide else bytes([(e << 7) | x])
            for x, e in it["props"]) for i, it in self.items.items())
        iprp = _box(b"iprp", _box(b"ipco", b"".join(_box(k, p) for k, p in self.ipco))
                    + _box(b"ipma", struct.pack(">II", int(wide), len(ids)) + assoc))

        def meta(base: int) -> bytes:
            body, pos = struct.pack(">HH", 0x4400, len(ids)), base
            for i in ids:
                at = pos if offsets is None else offsets[i]
                body += struct.pack(">HHHII", i, 0, 1, at, len(self.items[i]["data"]))
                pos += len(self.items[i]["data"])
            iloc = _box(b"iloc", bytes(4) + body)
            return _box(b"meta", bytes(4) + hdlr + pitm + iloc + iinf + iref + iprp)

        if offsets is not None:
            return meta(0)
        head = _box(b"ftyp", self.ftyp)
        base = len(head) + len(meta(0)) + 8
        return head + meta(base) + _box(b"mdat", b"".join(self.items[i]["data"] for i in ids))


class Avis:
    """An AVIF image sequence (PIL's save_all file) to edit and write again:
    `ftyp` (its payload), `heif` (a Heif of its meta box, or None), `mvhd`
    (the box) and `tracks`, each a dict of "tkhd" (payload), "tref"
    [(kind, [track ids])], "edts", "mdhd", "hdlr" (payloads, or None to
    leave the box out), "minf" (minf's boxes before stbl, as bytes), "entry"
    (the sample entry's format, its 78 VisualSampleEntry bytes and its
    children [(kind, payload)]), "samples" [bytes], "stts" and "stss"
    (payloads, or None). `write` lays them out as libavif does (ftyp, meta,
    moov, then one mdat: each track's samples in turn) with the layout
    options of the tests: `order` of the meta and moov boxes, `chunks`
    (samples per chunk of every track: one chunk each by default), `co64`
    (64-bit chunk offsets), `default_size` (every sample padded with a
    padding OBU to the largest size, and stsz's one size) and `share`
    (the meta items' extents on the first samples where their bytes are
    the same, as libavif writes them; else the items' own bytes first)."""

    def __init__(self, data: bytes):
        from figdraw_tpu_torch.utils import avif

        top = list(avif._boxes(data, 0, len(data), top=True))
        self.ftyp = next(data[s:e] for k, s, e in top if k == b"ftyp")
        self.heif = Heif(data) if any(k == b"meta" for k, _s, _e in top) else None
        _k, ms, me = next(b for b in top if b[0] == b"moov")
        self.tracks = []
        for kind, s, e in avif._boxes(data, ms, me):
            if kind == b"mvhd":
                self.mvhd = data[s - 8:e]
            elif kind == b"trak":
                self.tracks.append(self._track(data, s, e))

    @staticmethod
    def _track(data: bytes, start: int, end: int) -> dict:
        from figdraw_tpu_torch.utils import avif

        t = {"tref": [], "edts": None, "stss": None, "stts": None, "minf": b""}
        offsets, sizes, runs = [], [], []
        for kind, s, e in avif._boxes(data, start, end):
            if kind == b"tkhd":
                t["tkhd"] = data[s:e]
            elif kind == b"edts":
                t["edts"] = data[s:e]
            elif kind == b"tref":
                t["tref"] = [(rk, [int.from_bytes(data[i:i + 4], "big") for i in range(rs, re_, 4)])
                             for rk, rs, re_ in avif._boxes(data, s, e)]
            elif kind == b"mdia":
                for mk, ms, me in avif._boxes(data, s, e):
                    if mk in (b"mdhd", b"hdlr"):
                        t[mk.decode()] = data[ms:me]
                    elif mk == b"minf":
                        for nk, ns, ne in avif._boxes(data, ms, me):
                            if nk != b"stbl":
                                t["minf"] += data[ns - 8:ne]
                                continue
                            for bk, bs, be in avif._boxes(data, ns, ne):
                                c = avif._Cursor(data, bs + 4, be)
                                if bk in (b"stts", b"stss"):
                                    t[bk.decode()] = data[bs:be]
                                elif bk == b"stsd":
                                    _f, es, ee = next(avif._boxes(data, bs + 8, be))
                                    t["entry"] = (_f, data[es:es + 78], [
                                        (pk, data[ps:pe])
                                        for pk, ps, pe in avif._boxes(data, es + 78, ee)])
                                elif bk == b"stco":
                                    offsets += [c.uint(4) for _ in range(c.uint(4))]
                                elif bk == b"stsc":
                                    runs += [(c.uint(4), c.uint(4), c.uint(4)) for _ in range(c.uint(4))]
                                elif bk == b"stsz":
                                    assert c.uint(4) == 0
                                    sizes += [c.uint(4) for _ in range(c.uint(4))]
        assert len(offsets) == 1 and len(runs) == 1, "PIL writes one chunk a track"
        pos, t["samples"] = offsets[0], []
        for n in sizes:
            t["samples"].append(data[pos:pos + n])
            pos += n
        return t

    def track(self, track_id: int) -> dict:
        return next(t for t in self.tracks if struct.unpack(">I", t["tkhd"][12 if t["tkhd"][0]
                                                                            else 8:][:4])[0]
                    == track_id)

    def _moov(self, offsets: list, chunks, co64: bool, default_size: int) -> bytes:
        out = self.mvhd
        for t, base in zip(self.tracks, offsets):
            n = len(t["samples"])
            per = chunks or [n]
            assert sum(per) == n
            fmt, fields, props = t["entry"]
            entry = _box(fmt, fields + b"".join(_box(k, p) for k, p in props))
            sizes = [default_size or len(x) for x in t["samples"]]
            starts, pos, k = [], base, 0
            for m in per:
                starts.append(pos)
                pos += sum(sizes[k:k + m])
                k += m
            runs = [(i + 1, m) for i, m in enumerate(per) if i == 0 or m != per[i - 1]]
            stbl = (_box(b"stsd", struct.pack(">II", 0, 1) + entry)
                    + (_box(b"stts", t["stts"]) if t["stts"] is not None else b"")
                    + _box(b"stsc", struct.pack(">II", 0, len(runs)) + b"".join(
                        struct.pack(">III", f, m, 1) for f, m in runs))
                    + (_box(b"stsz", struct.pack(">III", 0, default_size, n)) if default_size
                       else _box(b"stsz", struct.pack(">III", 0, 0, n) + b"".join(
                           struct.pack(">I", x) for x in sizes)))
                    + (_box(b"co64", struct.pack(">II", 0, len(starts)) + b"".join(
                        struct.pack(">Q", x) for x in starts)) if co64
                       else _box(b"stco", struct.pack(">II", 0, len(starts)) + b"".join(
                           struct.pack(">I", x) for x in starts)))
                    + (_box(b"stss", t["stss"]) if t["stss"] is not None else b""))
            mdia = ((_box(b"mdhd", t["mdhd"]) if t.get("mdhd") is not None else b"")
                    + (_box(b"hdlr", t["hdlr"]) if t.get("hdlr") is not None else b"")
                    + _box(b"minf", t["minf"] + _box(b"stbl", stbl)))
            tref = _box(b"tref", b"".join(_box(k, b"".join(struct.pack(">I", i) for i in ids))
                                          for k, ids in t["tref"])) if t["tref"] else b""
            out += _box(b"trak", _box(b"tkhd", t["tkhd"]) + tref
                        + (_box(b"edts", t["edts"]) if t["edts"] is not None else b"")
                        + _box(b"mdia", mdia))
        return _box(b"moov", out)

    def write(self, order=(b"meta", b"moov"), chunks=None, co64: bool = False,
              default_size: bool = False, share: bool = True) -> bytes:
        samples = [list(t["samples"]) for t in self.tracks]
        size = 0
        if default_size:
            size = max(len(x) for xs in samples for x in xs) + 3
            samples = [[x + _padding(size - len(x)) for x in xs] for xs in samples]
        firsts = [xs[0] for xs in samples]
        items = {} if self.heif is None else self.heif.items
        own = [i for i, it in items.items() if not (share and it["data"] in firsts)]
        body = b"".join(items[i]["data"] for i in own) + b"".join(b"".join(xs) for xs in samples)

        def layout(base: int) -> tuple:
            pos, item_at = base, {}
            for i in own:
                item_at[i] = pos
                pos += len(items[i]["data"])
            track_at = []
            for xs in samples:
                track_at.append(pos)
                pos += sum(len(x) for x in xs)
            for i, it in items.items():
                if i not in item_at:
                    k = firsts.index(it["data"])
                    item_at[i] = track_at[k]
            boxes = {b"moov": self._moov(track_at, chunks, co64, size),
                     b"meta": self.heif.write(item_at) if self.heif is not None else b""}
            return b"".join(boxes[k] for k in order)

        head = _box(b"ftyp", self.ftyp)
        base = len(head) + len(layout(0)) + 8
        return head + layout(base) + _box(b"mdat", body)


def steady_times(data: bytes) -> bytes:
    """A PIL-written image sequence with the creation and modification
    times of its mvhd, tkhd and mdhd boxes (the clock at the save) set to
    0, so that a file written twice is the same bytes."""
    from figdraw_tpu_torch.utils import avif

    out = bytearray(data)

    def walk(start: int, end: int) -> None:
        for kind, s, e in avif._boxes(data, start, end):
            if kind in (b"moov", b"trak", b"mdia"):
                walk(s, e)
            elif kind in (b"mvhd", b"tkhd", b"mdhd"):
                n = 16 if data[s] == 1 else 8
                out[s + 4:s + 4 + n] = bytes(n)

    _k, ms, me = next(b for b in avif._boxes(data, 0, len(data), top=True) if b[0] == b"moov")
    walk(ms - 8, me)
    return bytes(out)


def with_track_size(data: bytes, width: int, height: int) -> bytes:
    """An image sequence with every track's tkhd width and height set (the
    size libavif scales each track's frames to), the file's length and
    offsets kept."""
    from figdraw_tpu_torch.utils import avif

    out = bytearray(data)
    _k, ms, me = next(b for b in avif._boxes(data, 0, len(data), top=True) if b[0] == b"moov")
    for kind, s, e in avif._boxes(data, ms, me):
        if kind == b"trak":
            for tk, ts, te in avif._boxes(data, s, e):
                if tk == b"tkhd":
                    out[te - 8:te] = struct.pack(">II", width << 16, height << 16)
    return bytes(out)


def _config_at(payload: bytes, seq) -> bytes:
    """An av1C payload set to the sequence header `seq` (profile,
    high_bitdepth, twelve_bit, monochrome, subsampling), its configOBUs
    rewritten to the same depth."""
    b2 = (payload[2] & 0x83) | (int(seq.bit_depth > 8) << 6) | (int(seq.bit_depth == 12) << 5) | (
        seq.mono << 4) | (seq.ssx << 3) | (seq.ssy << 2)
    return bytes([payload[0], (seq.profile << 5) | (payload[1] & 31), b2, payload[3]]) + \
        stream_at(payload[4:], seq.bit_depth)


def avis_at_depth(data: bytes, depth: int, alpha_depth: int = None) -> bytes:
    """A PIL-written image sequence made a `depth`-bit one as avif_at_depth
    makes a still: every sample of every track (the alpha track's at
    `alpha_depth`) and every av01 item rewritten by stream_at, the sample
    entries' and the items' av1C and the items' pixi set to match, the
    file written again by Avis.write."""
    from figdraw_tpu_torch.utils import av1

    alpha_depth = depth if alpha_depth is None else alpha_depth
    a = Avis(data)

    def seq_of(stream):
        return av1.parse_sequence(next(p for k, p in av1.obus(stream)
                                       if k == av1.OBU_SEQUENCE_HEADER))

    for t in a.tracks:
        d = alpha_depth if any(k == b"auxl" for k, _ids in t["tref"]) else depth
        t["samples"] = [stream_at(x, d) for x in t["samples"]]
        seq = seq_of(t["samples"][0])
        fmt, fields, props = t["entry"]
        t["entry"] = (fmt, fields, [(k, _config_at(p, seq) if k == b"av1C" else p)
                                    for k, p in props])
    h = a.heif
    alpha = {f for k, f, to in h.refs if k == b"auxl" and h.primary in to}
    for i, item in h.items.items():
        if item["type"] != b"av01":
            continue
        d = alpha_depth if i in alpha else depth
        item["data"] = stream_at(item["data"], d)
        seq = seq_of(item["data"])
        for index, essential in list(item["props"]):
            kind, payload = h.ipco[index - 1]
            if kind == b"av1C":
                h.set_prop(i, kind, _config_at(payload, seq), essential)
            elif kind == b"pixi":
                h.set_prop(i, kind, payload[:5] + bytes([d] * payload[4]), essential)
    return a.write()


def _padding(n: int) -> bytes:
    """An OBU_PADDING of n bytes in all (n >= 3), its size in two to four
    leb128 bytes."""
    for size_bytes in (2, 3, 4):
        k = n - 1 - size_bytes
        if 0 <= k < 1 << (7 * size_bytes):
            size = bytes(((k >> (7 * i)) & 0x7F) | (0x80 if i < size_bytes - 1 else 0)
                         for i in range(size_bytes))
            return bytes([15 << 3 | 2]) + size + bytes(k)
    raise ValueError(f"no padding OBU of {n} bytes")


def _jpeg_chunk(quality: int, subsampling: str):
    """jpeg_chunk for tiff_bytes: PIL's JPEG of a chunk of RGB samples,
    split as TIFF keeps it."""
    from PIL import Image

    def encode(block):
        b = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(block)).save(b, "JPEG", quality=quality,
                                                          subsampling=subsampling)
        return jpeg_parts(b.getvalue())
    return encode


def tiff_files(src) -> dict:
    """The stored TIFFs: the fixture as LZW + Predictor 2 (PIL), files PIL
    writes (uncompressed strips, PackBits, LZMA, float Deflate with
    Predictor 3, JPEG as RGB and as YCbCr, CMYK, an uncompressed BigTIFF)
    and files tiff_bytes builds for what PIL does not write (tiles with
    edge padding, planar, big-endian, FillOrder 2, strips that do not
    divide the height, associated alpha, an Orientation, JPEG at 2x2
    subsampling, a compressed BigTIFF), mostly of 61x47 crops."""
    from PIL import Image

    files = {}

    def save(name, img, **kw):
        b = io.BytesIO()
        img.save(b, "TIFF", **kw)
        files[name] = b.getvalue()

    save(TIFF_FIXTURE, src, compression="tiff_lzw", tiffinfo={317: 2})
    crop = src.crop((360, 270, 421, 317))  # 61x47
    px = np.asarray(crop)
    rgb = np.ascontiguousarray(px[..., :3])
    grey = np.asarray(crop.convert("L"))
    save("raw_rgb_strips.tif", crop.convert("RGB"), tiffinfo={278: 5})
    save("packbits_rgba.tif", crop, compression="packbits")
    save("lzma_pred2_grey.tif", crop.convert("L"), compression="lzma", tiffinfo={317: 2})
    ramp = (grey.astype(np.float32) * 1.25 - 30.5)
    ramp[0, :4] = (np.nan, np.inf, -np.inf, 254.99)
    save("deflate_pred3_float.tif", Image.fromarray(ramp, "F"),
         compression="tiff_adobe_deflate", tiffinfo={317: 3})
    wide = src.crop((320, 240, 448, 336))  # 128x96: six strips of 16 rows
    save("jpeg_rgb.tif", wide.convert("RGB"), compression="jpeg", quality=85,
         tiffinfo={278: 16})
    save("jpeg_ycbcr_1x1.tif", wide.convert("YCbCr"), compression="jpeg", quality=85,
         tiffinfo={278: 16})
    files["jpeg_ycbcr_2x2.tif"] = tiff_bytes(
        np.asarray(wide.convert("RGB")), 6, compression=7, rows_per_strip=32,
        jpeg_chunk=_jpeg_chunk(85, "4:2:0"), tags={530: (3, (2, 2))})
    save("cmyk_lzw.tif", crop.convert("CMYK"), compression="tiff_lzw")
    save("bigtiff_raw.tif", crop, big_tiff=True)  # PIL writes BigTIFF uncompressed only
    files["bigtiff_lzw_tiles.tif"] = tiff_bytes(px, 2, big=True, compression=5, predictor=2,
                                                extra=(2,), tile=(32, 32))
    files["tiles_deflate_pred2.tif"] = tiff_bytes(rgb, 2, compression=8, predictor=2,
                                                  tile=(32, 16))
    files["planar_lzw_rgba.tif"] = tiff_bytes(px, 2, compression=5, planar=2, extra=(2,),
                                              rows_per_strip=16)
    g16 = grey.astype(np.uint16) * 3 + np.arange(61, dtype=np.uint16)
    files["mm_packbits_grey16.tif"] = tiff_bytes(g16, 1, order=">", compression=32773,
                                                 rows_per_strip=8)
    files["mm_deflate_pred2_rgb16.tif"] = tiff_bytes(rgb.astype(np.uint16) * 257, 2,
                                                     order=">", compression=8, predictor=2)
    files["fill2_bilevel_lzw.tif"] = tiff_bytes((grey < 128).astype(np.uint8), 0, bits=1,
                                                compression=5, fill_order=2,
                                                rows_per_strip=10)
    idx4, pal4 = _quantized(crop.convert("RGB"), 16)
    cmap = pal4.astype(np.uint16) * 257 + np.arange(16, dtype=np.uint16)[:, None]
    files["palette4_uneven_strips.tif"] = tiff_bytes(idx4, 3, bits=4, compression=5,
                                                     rows_per_strip=6, colormap=cmap)
    alpha = px[..., 3:].astype(np.uint16)
    alpha[::3, ::5] = 96
    premul = np.concatenate([(rgb * alpha // 255).astype(np.uint8), alpha.astype(np.uint8)], -1)
    files["assoc_alpha_deflate.tif"] = tiff_bytes(premul, 2, compression=32946, extra=(1,))
    files["orientation6_lzw.tif"] = tiff_bytes(rgb, 2, compression=5,
                                               tags={274: (3, (6,))})
    return files


# --- CCITT fax and ZSTD -------------------------------------------------------

ZSTD_FIXTURE = "fixture_zstd_pred2.tif"
G3_FIXTURE = "fixture_dither_g3_2d.tif"
FAX_PAGE = "fax_page_g4.tif"
FAX_PAGE_SIZE = (1728, 1143)  # TIFF-F standard resolution: an A4 page at 204 x 98 dpi
FAX_DPI = (204, 98)
_ZSTD_LEVEL, _ZSTD_CHECKSUM = 100, 201  # ZSTD_cParameter values (zstd.h)


def _libzstd():
    """PIL's libzstd (pillow.libs) through ctypes."""
    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libzstd-*.so*"))[0])
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
    lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                                   ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    return lib


def libzstd_compress(data: bytes, level: int, checksum: bool = True) -> bytes:
    """One Zstandard frame of `data` from libzstd's ZSTD_compress2 at
    `level`, with or without the content checksum."""
    lib = _libzstd()
    cctx = lib.ZSTD_createCCtx()
    try:
        lib.ZSTD_CCtx_setParameter(cctx, _ZSTD_LEVEL, level)
        lib.ZSTD_CCtx_setParameter(cctx, _ZSTD_CHECKSUM, int(checksum))
        cap = lib.ZSTD_compressBound(len(data))
        out = ctypes.create_string_buffer(cap)
        n = lib.ZSTD_compress2(cctx, out, cap, data, len(data))
        if lib.ZSTD_isError(n):
            raise RuntimeError("ZSTD_compress2 failed")
        return out.raw[:n]
    finally:
        lib.ZSTD_freeCCtx(cctx)


def fax_page():
    """A page of text at TIFF-F standard resolution drawn by PIL with the
    bundled DejaVuSans: a mode "1" image, black text on white."""
    from PIL import Image, ImageDraw, ImageFont

    font_path = os.path.join(REPO, "figdraw_tpu_torch", "fonts", "DejaVuSans.ttf")
    page = Image.new("1", FAX_PAGE_SIZE, 1)
    draw = ImageDraw.Draw(page)
    draw.text((96, 60), "FACSIMILE TRANSMISSION", font=ImageFont.truetype(font_path, 56),
              fill=0)
    draw.line((96, 140, 1632, 140), fill=0, width=4)
    body = ImageFont.truetype(font_path, 30)
    words = ("the quick brown fox jumps over the lazy dog while five boxing wizards "
             "jump quickly and a sphinx of black quartz judges my vow").split()
    rng = np.random.default_rng(20)
    y = 180
    while y < FAX_PAGE_SIZE[1] - 120:
        line = " ".join(words[i] for i in rng.integers(0, len(words), 11))
        draw.text((96, y), line[:1].upper() + line[1:] + ".", font=body, fill=0)
        y += 44
    draw.rectangle((1320, 1020, 1632, 1090), outline=0, width=3)
    draw.text((1340, 1032), "Page 1 of 1", font=body, fill=0)
    return page


def fax_zstd_files(src) -> dict:
    """The stored CCITT and ZSTD TIFFs PIL and fax_encode write: the
    fixture as ZSTD + Predictor 2 in strips, a ZSTD float crop with
    Predictor 3 (PIL); the fax page (fax_page) as Group 4 and as Modified
    Huffman (PIL), and
    as Group 3 2D with fill bits, FillOrder 2 and MinIsWhite in strips of
    128 rows (fax_encode: libtiff's encoder, a 1D row every second at 98
    dpi); the fixture dithered to 1 bit as Group 3 2D (PIL); a crop of the
    page in Group 4 tiles (fax_encode)."""
    from PIL import Image

    files = {}

    def save(name, img, **kw):
        b = io.BytesIO()
        img.save(b, "TIFF", **kw)
        files[name] = b.getvalue()

    save(ZSTD_FIXTURE, src, compression="zstd", tiffinfo={317: 2})
    grey = np.asarray(src.convert("L"))[270:317, 360:421]
    ramp = grey.astype(np.float32) * 1.5 - 40.25
    save("zstd_pred3_float.tif", Image.fromarray(ramp, "F"), compression="zstd",
         tiffinfo={317: 3})
    page = fax_page()
    save(FAX_PAGE, page, compression="group4", dpi=FAX_DPI)
    bits = 1 - np.asarray(page, np.uint8)  # 1 black
    res = {282: (5, ((FAX_DPI[0], 1),)), 283: (5, ((FAX_DPI[1], 1),)), 296: (3, (2,)),
           292: (4, (5,))}
    # PIL's writer garbles a MinIsWhite page (it reads back all black): written here
    files["fax_page_g3_2d_fill_lsb_white.tif"] = tiff_bytes(
        bits, 0, bits=1, compression=3, rows_per_strip=128, fill_order=2, tags=res,
        codec=lambda b: fax_encode(b[..., 0], 3, 5, k=2 if FAX_DPI[1] <= 150 else 4))
    save("fax_page_mh.tif", page, compression="tiff_ccitt", dpi=FAX_DPI)
    save(G3_FIXTURE, src.convert("1"), compression="group3", tiffinfo={292: 1})
    crop = bits[40:240, 80:680]
    files["fax_tiles_g4.tif"] = tiff_bytes(crop, 0, bits=1, compression=4, tile=(128, 64),
                                           codec=lambda b: fax_encode(b[..., 0], 4))
    return files


RLEW_FIXTURE = "rlew_dither.tif"
RLEW_ODD = "rlew_odd_strips.tif"
UNCOMPRESSED_MODE = "ccitt_uncompressed_mode.tif"


def uncompressed_mode_strip(bits: np.ndarray) -> tuple:
    """(T.6 strip, the rows libtiff decodes from it) of (rows, width) 0/1
    bits (1 black): from the ninth row of every sixteen, the extension code
    that enters uncompressed mode (0000001111) in place of four rows. libtiff
    ends a row at the code's first seven bits (all white) and reads the
    three ones after them as vertical codes V0 on white references (three
    more white rows); coding goes on against a white reference."""
    out, ref = FaxBits(), np.zeros(bits.shape[1], np.uint8)
    decoded = bits.astype(np.uint8).copy()
    for i, row in enumerate(decoded):
        if i % 16 in (8, 9, 10, 11):
            if i % 16 == 8:
                out.put("0000001111")
            row[:] = 0
            ref = row
            continue
        fax_row_2d(out, row, ref)
        ref = row
    out.put("000000000001" * 2)
    return out.to_bytes(), decoded


def ccitt_repair_files(src) -> dict:
    """The stored RLE-W TIFFs and the fax strip in uncompressed mode: the
    fixture dithered to 1 bit, its centre (400x300) as RLE-W in strips of
    64 rows (PIL's
    `tiff_raw_16`, whose rows libtiff's decoder word-aligns otherwise than
    its encoder: the picture PIL reads back is not the one written), a
    200x120 crop of it as RLE-W in strips of 16 rows stored unpadded, each
    one byte off its word (fax_encode: the strips after the first start at
    odd offsets), and a 120x80 crop as one T.6 strip with the extension
    code of uncompressed mode every sixteen rows (uncompressed_mode_strip)."""
    files = {}
    dither = src.convert("1")
    b = io.BytesIO()
    dither.crop((200, 150, 600, 450)).save(b, "TIFF", compression="tiff_raw_16",
                                          tiffinfo={278: 64})
    files[RLEW_FIXTURE] = b.getvalue()
    bits = 1 - np.asarray(dither, np.uint8)  # 1 black

    def odd(block):
        data = fax_encode(block[..., 0], 32771)
        return data[:-1] if data[-1] == 0 else data + b"\0"

    files[RLEW_ODD] = tiff_bytes(bits[240:360, 300:500], 0, bits=1, compression=32771,
                                 rows_per_strip=16, codec=odd, pad=False)
    strip, _decoded = uncompressed_mode_strip(bits[260:340, 340:460])
    files[UNCOMPRESSED_MODE] = tiff_bytes(bits[260:340, 340:460], 0, bits=1, compression=4,
                                          codec=lambda _b: strip)
    return files


ARITH_FIXTURE = "arith_progressive_rst.jpg"
INCOMPLETE_HUFF = "progressive_incomplete_huff.jpg"
INCOMPLETE_ARITH = "progressive_incomplete_arith.jpg"
NO_EOI = "baseline_no_eoi.jpg"
LOSSLESS_FIXTURE = "lossless_crop_p1.jpg"
WRITER_SRC = os.path.join(REPO, "tools", "jpeg_arith_lossless_writer.c")
_WRITER = []


def _libjpeg_path() -> str:
    """PIL's libjpeg-turbo 3.1.3 (pillow.libs)."""
    import PIL

    libs = os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs")
    return os.path.realpath(glob.glob(os.path.join(libs, "libjpeg-*.so*"))[0])


def arith_lossless_writer(build_dir: str = None) -> str:
    """tools/jpeg_arith_lossless_writer.c built with gcc against the host's
    jpeglib.h and linked to PIL's libjpeg-turbo (once a process, in a
    temporary directory unless `build_dir` is given); its path."""
    import subprocess

    if build_dir is None and _WRITER:
        return _WRITER[1]
    if build_dir is None:  # removed when the process ends
        _WRITER.append(tempfile.TemporaryDirectory(prefix="jpeg_writer_"))
    exe = os.path.join(build_dir or _WRITER[0].name, "jpeg_arith_lossless_writer")
    lib = _libjpeg_path()
    subprocess.run(["gcc", "-O2", "-o", exe, WRITER_SRC, lib,
                    f"-Wl,-rpath,{os.path.dirname(lib)}"], check=True)
    if build_dir is None:
        _WRITER.append(exe)
    return exe


def arith_lossless_jpeg(pixels: np.ndarray, *options: str, writer: str = None) -> bytes:
    """(H, W), (H, W, 3) or (H, W, 4) uint8 pixels (gray, RGB or CMYK)
    written by the C writer with its options (`arith`, `progressive`,
    `lossless=P,T`, `quality=Q`, `space=S`, `sampling=HxV,...`,
    `restart=N`, `restart_rows=N`, `dc=T,L,U`, `ac=T,K`)."""
    import subprocess

    pixels = np.ascontiguousarray(pixels, np.uint8)
    h, w = pixels.shape[:2]
    inp = {2: "gray", 3: "rgb", 4: "cmyk"}[pixels.ndim if pixels.ndim == 2 else pixels.shape[2]]
    with tempfile.TemporaryDirectory() as td:
        raw, out = os.path.join(td, "in.raw"), os.path.join(td, "out.jpg")
        pixels.tofile(raw)
        subprocess.run([writer or arith_lossless_writer(), raw, out, str(w), str(h), inp,
                        *options], check=True, capture_output=True)
        with open(out, "rb") as fh:
            return fh.read()


def arith_lossless_files(src) -> dict:
    """The stored arithmetic-coded and lossless JPEGs (the C writer): the
    fixture as SOF9 (4:2:0 at q 90) and as SOF10 with a restart interval
    of 100 MCUs; SOF9 and SOF10 crops with DAC conditioning other than
    libjpeg's defaults (DC L and U, AC Kx in both tables), grey with
    restarts, and Adobe CMYK; a 224x168 lossless crop (predictor 1), and
    32x24 crops through each predictor 1-7 with point transforms 0-2, one
    with a restart every two rows, and a grey one. The crops but the
    224x168 one carry seeded noise."""
    rgb = np.asarray(src.convert("RGB"))
    files = {}
    files["arith_420_q90.jpg"] = arith_lossless_jpeg(rgb, "arith")
    files[ARITH_FIXTURE] = arith_lossless_jpeg(rgb, "arith", "progressive", "restart=100")
    files[LOSSLESS_FIXTURE] = arith_lossless_jpeg(rgb[216:384, 288:512], "lossless=1,0")
    # the crops with seeded noise, so that large differences and long
    # magnitude categories occur
    noise = np.random.default_rng(22).integers(-48, 49, rgb.shape)
    rgb = np.clip(rgb.astype(np.int64) + noise, 0, 255).astype(np.uint8)
    crop = rgb[250:290, 360:408]
    files["arith_dac_444_rst.jpg"] = arith_lossless_jpeg(
        crop, "arith", "quality=75", "sampling=1x1,1x1,1x1", "dc=0,2,6", "dc=1,1,3",
        "ac=0,20", "ac=1,2", "restart=3")
    files["arith_dac_progressive_420.jpg"] = arith_lossless_jpeg(
        rgb[300:340, 420:468], "arith", "progressive", "quality=85", "dc=0,3,4", "dc=1,0,0",
        "ac=0,40", "ac=1,1")
    files["arith_gray_progressive_rst.jpg"] = arith_lossless_jpeg(
        rgb[200:229, 300:337, 1], "arith", "progressive", "restart=2")
    cmyk = np.concatenate([255 - rgb[280:296, 380:404], rgb[280:296, 380:404, :1] // 2], -1)
    files["arith_cmyk.jpg"] = arith_lossless_jpeg(cmyk, "arith", "quality=80")
    for p in range(1, 8):
        files[f"lossless_p{p}_pt{p % 3}.jpg"] = arith_lossless_jpeg(
            rgb[300 + 4 * p: 324 + 4 * p, 400:432], f"lossless={p},{p % 3}")
    files["lossless_p4_rst2.jpg"] = arith_lossless_jpeg(
        rgb[260:284, 350:382], "lossless=4,0", "restart_rows=2")
    files["lossless_gray_p6.jpg"] = arith_lossless_jpeg(rgb[310:331, 420:447, 0], "lossless=6,1")
    return files


def jpeg_segments(data: bytes) -> list:
    """A JPEG file cut at its markers: [(code, bytes)] from SOI to EOI, each
    SOS segment with its entropy-coded data (restart markers included)."""
    out, pos = [(0xD8, data[:2])], 2
    while pos < len(data):
        code = data[pos + 1]
        if code == 0xD9:
            out.append((code, data[pos: pos + 2]))
            break
        end = pos + 2 + struct.unpack_from(">H", data, pos + 2)[0]
        if code == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0, 0xFF)
                       and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
        out.append((code, data[pos: end]))
        pos = end
    return out


def scan_params(segment: bytes) -> tuple:
    """(component ids, Ss, Se, Ah, Al) of an SOS segment."""
    ns = segment[4]
    ss, se, a = segment[5 + 2 * ns: 8 + 2 * ns]
    return tuple(segment[5: 5 + 2 * ns: 2]), ss, se, a >> 4, a & 15


def drop_scans(data: bytes, drop) -> bytes:
    """The JPEG file without the scans drop(index, last index, component
    ids, Ss, Se, Ah, Al) picks."""
    segs = jpeg_segments(data)
    scans = [i for i, (code, _s) in enumerate(segs) if code == 0xDA]
    return b"".join(seg for i, (code, seg) in enumerate(segs)
                    if code != 0xDA or not drop(scans.index(i), len(scans) - 1,
                                                *scan_params(seg)))


def final_refinement(k, last, ids, ss, se, ah, al) -> bool:
    """An AC scan that refines to Al 0: the scans libjpeg's progression
    ends with."""
    return ss > 0 and ah > 0 and al == 0


def jpeg_repair_files(src) -> dict:
    """The stored JPEGs that libjpeg reads with its output-side quirks: the
    fixture as PIL's Huffman progressive 4:2:0 at q 90 and a 200x150 crop
    as libjpeg-turbo's arithmetic progressive file, each without the AC
    scans that refine to Al 0 (the decoder then smooths the blocks), and a
    one-scan baseline crop whose EOI is replaced by three zero bytes (the
    fewest after which libjpeg's read-ahead stays in the file)."""
    rgb = src.convert("RGB")
    b = io.BytesIO()
    rgb.save(b, "JPEG", quality=90, subsampling="4:2:0", progressive=True)
    files = {INCOMPLETE_HUFF: drop_scans(b.getvalue(), final_refinement)}
    crop = np.asarray(rgb)[220:370, 300:500]
    files[INCOMPLETE_ARITH] = drop_scans(arith_lossless_jpeg(crop, "arith", "progressive"),
                                         final_refinement)
    b = io.BytesIO()
    rgb.crop((300, 220, 500, 370)).save(b, "JPEG", quality=85)
    files[NO_EOI] = b.getvalue()[:-2] + b"\0\0\0"
    return files


def libzstd_files(src) -> dict:
    """The stored ZSTD TIFFs libzstd writes (kept apart from image_files,
    which the tests rerun, since they never load libzstd): a 250x190 crop
    of the fixture (scenes.ZSTD_TILES_BOX) in 64x64 ZSTD tiles at
    libtiff's level, 3, the right and bottom ones partial; frames at levels
    1, 3, 19 and 22 with a checksum on random, constant and photo strips."""
    from figdraw_tpu_torch.scenes import ZSTD_TILES_BOX

    files = {"fixture_zstd_tiles.tif": tiff_bytes(np.asarray(src.crop(ZSTD_TILES_BOX)), 2,
                                                  compression=50000, extra=(2,), tile=(64, 64))}
    rng = np.random.default_rng(50000)
    photo = np.ascontiguousarray(np.asarray(src.convert("RGB"))[250:297, 340:401])
    strips = {"random": rng.integers(0, 256, photo.shape, dtype=np.uint8),
              "constant": np.full(photo.shape, 173, np.uint8), "photo": photo}
    for level in (1, 3, 19, 22):
        for kind, px in strips.items():
            files[f"zstd_l{level}_{kind}.tif"] = tiff_bytes(
                px, 2, compression=50000, rows_per_strip=16,
                codec=lambda b, level=level: libzstd_compress(b.tobytes(), level))
    return files


# --- WebP -----------------------------------------------------------------

_ABI = 0x0200  # libwebp's encoder ABI: its major version, 2, must match


class _WebPConfig(ctypes.Structure):
    """libwebp's WebPConfig (src/webp/encode.h)."""
    _fields_ = [(n, ctypes.c_float if n in ("quality", "target_PSNR") else ctypes.c_int)
                for n in ("lossless quality method image_hint target_size target_PSNR segments "
                          "sns_strength filter_strength filter_sharpness filter_type autofilter "
                          "alpha_compression alpha_filtering alpha_quality pass show_compressed "
                          "preprocessing partitions partition_limit emulate_jpeg_size "
                          "thread_level low_memory near_lossless exact use_delta_palette "
                          "use_sharp_yuv qmin qmax").split()]


_P = ctypes.c_void_p


class _WebPPicture(ctypes.Structure):
    """libwebp's WebPPicture (src/webp/encode.h)."""
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int), ("y", _P), ("u", _P),
                ("v", _P), ("y_stride", ctypes.c_int), ("uv_stride", ctypes.c_int), ("a", _P),
                ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2), ("argb", _P),
                ("argb_stride", ctypes.c_int), ("pad2", ctypes.c_uint32 * 3), ("writer", _P),
                ("custom_ptr", _P), ("extra_info_type", ctypes.c_int), ("extra_info", _P),
                ("stats", _P), ("error_code", ctypes.c_int), ("progress_hook", _P),
                ("user_data", _P), ("pad3", ctypes.c_uint32 * 3), ("pad4", _P), ("pad5", _P),
                ("pad6", ctypes.c_uint32 * 8), ("memory_", _P), ("memory_argb_", _P),
                ("pad7", _P * 2)]


class _WebPMemoryWriter(ctypes.Structure):
    _fields_ = [("mem", _P), ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                ("pad", ctypes.c_uint32)]


_LIBWEBP = []


def _libwebp():
    """PIL's libwebp through ctypes (libsharpyuv loaded first, globally)."""
    if not _LIBWEBP:
        from make_webp_tables import libwebp_path

        path = libwebp_path()
        sharp = glob.glob(os.path.join(os.path.dirname(path), "libsharpyuv-*.so*"))
        for dep in sharp:
            ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
        lib = ctypes.CDLL(path)
        for name, args, res in (
                ("WebPConfigInitInternal", [_P, ctypes.c_int, ctypes.c_float, ctypes.c_int],
                 ctypes.c_int),
                ("WebPValidateConfig", [_P], ctypes.c_int),
                ("WebPPictureInitInternal", [_P, ctypes.c_int], ctypes.c_int),
                ("WebPPictureImportRGBA", [_P, _P, ctypes.c_int], ctypes.c_int),
                ("WebPMemoryWriterInit", [_P], None), ("WebPMemoryWriterClear", [_P], None),
                ("WebPPictureFree", [_P], None), ("WebPEncode", [_P, _P], ctypes.c_int)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _LIBWEBP.append(lib)
    return _LIBWEBP[0]


def libwebp_encode(rgba: np.ndarray, quality: float = 75.0, **options) -> bytes:
    """A WebP file of (h, w, 4) uint8 RGBA from libwebp's WebPEncode with a
    WebPConfig of the default preset at `quality` and the given fields
    (filter_type, filter_strength, filter_sharpness, segments, partitions,
    method, alpha_compression, alpha_filtering, lossless, ...), validated
    by WebPValidateConfig."""
    lib = _libwebp()
    cfg = _WebPConfig()
    if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, quality, _ABI):
        raise RuntimeError("WebPConfigInit failed")
    for key, value in options.items():
        setattr(cfg, key, value)
    if not lib.WebPValidateConfig(ctypes.byref(cfg)):
        raise ValueError(f"libwebp refuses the config {options}")
    pic = _WebPPicture()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), _ABI):
        raise RuntimeError("WebPPictureInit failed")
    px = np.ascontiguousarray(rgba, np.uint8)
    pic.height, pic.width = px.shape[:2]
    pic.use_argb = 1 if cfg.lossless else 0
    writer = _WebPMemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    try:
        if not lib.WebPPictureImportRGBA(ctypes.byref(pic), px.ctypes.data, 4 * pic.width):
            raise RuntimeError("WebPPictureImportRGBA failed")
        pic.writer = ctypes.cast(lib.WebPMemoryWrite, _P).value
        pic.custom_ptr = ctypes.addressof(writer)
        if not lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)):
            raise RuntimeError(f"WebPEncode failed with error {pic.error_code}")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


def riff(chunks) -> bytes:
    """A RIFF WEBP file of (fourcc, payload) chunks, odd payloads padded."""
    body = b"WEBP" + b"".join(
        tag + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)
        for tag, data in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def webp_chunks(data: bytes) -> list:
    """A WebP file's top-level (fourcc, payload) chunks."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        size = struct.unpack_from("<I", data, pos + 4)[0]
        out.append((data[pos: pos + 4], data[pos + 8: pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _u24(v: int) -> bytes:
    return struct.pack("<I", v)[:3]


def _bitstream_size(tag: bytes, data: bytes):
    """(width, height) of a VP8 or VP8L chunk's bitstream."""
    if tag == b"VP8 ":
        w, h = struct.unpack_from("<HH", data, 6)
        return w & 0x3FFF, h & 0x3FFF
    bits = struct.unpack_from("<I", data, 1)[0]
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1


def anim_bytes(canvas, frames, alpha: bool = True, background=(0, 0, 0, 0),
               loops: int = 0) -> bytes:
    """An animated WebP: VP8X (the alpha flag as given), ANIM, and one ANMF
    a frame; frames are (x, y, still WebP file, duration ms, flags byte:
    bit 1 no blend, bit 0 dispose) and each takes its still file's image
    chunks (ALPH and VP8, or VP8L) at offset (x, y), both even."""
    w, h = canvas
    flags = 0x02 | (0x10 if alpha else 0)
    chunks = [(b"VP8X", bytes([flags, 0, 0, 0]) + _u24(w - 1) + _u24(h - 1)),
              (b"ANIM", bytes(background[2::-1]) + bytes([background[3]])
               + struct.pack("<H", loops))]
    for x, y, still, duration, bits in frames:
        image = [(t, d) for t, d in webp_chunks(still) if t in (b"ALPH", b"VP8 ", b"VP8L")]
        fw, fh = _bitstream_size(*image[-1])
        head = _u24(x // 2) + _u24(y // 2) + _u24(fw - 1) + _u24(fh - 1) + _u24(duration)
        sub = b"".join(t + struct.pack("<I", len(d)) + d + b"\0" * (len(d) & 1)
                       for t, d in image)
        chunks.append((b"ANMF", head + bytes([bits]) + sub))
    return riff(chunks)


def _pil_webp(img, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, "WEBP", **kw)
    return b.getvalue()


def alpha_patterns(h: int, w: int) -> dict:
    """Alpha planes on which libwebp's alpha encoder picks each filter:
    "wave" vertical (at alpha_filtering 1 and 2), "blobs" gradient and
    "half" horizontal (at alpha_filtering 2)."""
    yy, xx = np.mgrid[0:h, 0:w]
    return {"wave": (np.sin(xx / 3.0) * 60 + 128 + yy).astype(np.uint8),
            "blobs": ((np.sin(xx / 5.0) * np.cos(yy / 4.0) * 100) + 128).astype(np.uint8),
            "half": np.where(xx + yy < 50, 255, 0).astype(np.uint8)}


def predictor_tiles(seed: int = 26, size: int = 64, tile: int = 16) -> np.ndarray:
    """(size, size, 4) opaque tiles of ramps, products, noise and near-black
    noise, on which libwebp's lossless encoder at method 6 and quality 100
    picks each of the 14 predictor modes (seed 26)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    out = np.zeros((size, size, 4), np.int64)
    for i in range(size // tile):
        for j in range(size // tile):
            kind = rng.integers(0, 7)
            full = [xx + yy, xx - yy, xx * 2, yy * 3, rng.integers(0, 256, (size, size)),
                    (xx * yy) // 8, rng.integers(0, 6, (size, size))][kind]
            blk = full[i * tile: (i + 1) * tile, j * tile: (j + 1) * tile]
            for c in range(3):
                out[i * tile: (i + 1) * tile, j * tile: (j + 1) * tile, c] = (
                    blk + (40 * c if kind != 6 else 0) + rng.integers(0, 4, blk.shape)) % 256
    out[..., 3] = 255
    return out.astype(np.uint8)


def webp_files(src) -> dict:
    """The stored WebPs: the fixture at q 90 and lossless (PIL), crops PIL
    writes (lossy at three qualities and two methods, odd sizes, with
    ALPH, lossless of several kinds), an animation built from PIL's
    stills, and libwebp_encode's files for the options PIL does not set."""
    from PIL import Image

    files = {WEBP_FIXTURE: _pil_webp(src.convert("RGB"), quality=90),
             "fixture_lossless.webp": _pil_webp(src, lossless=True)}
    crop = src.crop((300, 200, 361, 247))  # 61x47 of detail
    rgb = crop.convert("RGB")
    for q in (5, 50, 100):
        for m in (0, 6):
            files[f"lossy_q{q}_m{m}.webp"] = _pil_webp(rgb, quality=q, method=m)
    files["lossy_1x1.webp"] = _pil_webp(rgb.crop((20, 20, 21, 21)), quality=80)
    files["lossy_17x3.webp"] = _pil_webp(rgb.crop((5, 9, 22, 12)), quality=80)
    px = np.asarray(crop)
    pats = alpha_patterns(*px.shape[:2])
    rgba = px.copy()
    rgba[..., 3] = pats["blobs"]
    for aq in (100, 30):
        files[f"alpha_aq{aq}.webp"] = _pil_webp(Image.fromarray(rgba), quality=50,
                                                alpha_quality=aq)
    files["lossless_photo.webp"] = _pil_webp(crop, lossless=True)
    files["lossless_grey.webp"] = _pil_webp(crop.convert("L"), lossless=True)
    for n in (2, 4, 16, 32, 200):
        files[f"lossless_{n}_colours.webp"] = _pil_webp(rgb.quantize(n).convert("RGB"),
                                                        lossless=True)
    clear = px.copy()
    clear[::3, ::2, 3] = 0
    files["lossless_exact.webp"] = _pil_webp(Image.fromarray(clear), lossless=True, exact=True)
    first = _pil_webp(Image.fromarray(rgba[4:34, 6:46]), quality=60)
    second = _pil_webp(crop, lossless=True)
    files["anim_offset_first.webp"] = anim_bytes(
        (61, 47), [(6, 4, first, 100, 0x02), (0, 0, second, 100, 0)],
        background=(200, 30, 60, 255), loops=3)
    # libwebp's encoder options, on the crop (with alpha where ALPH is meant)
    opaque = np.ascontiguousarray(px)
    files["vp8_simple_filter.webp"] = libwebp_encode(opaque, filter_type=0)
    files["vp8_no_filter.webp"] = libwebp_encode(opaque, filter_strength=0)
    files["vp8_sharpness7.webp"] = libwebp_encode(opaque, filter_sharpness=7)
    files["vp8_segments1.webp"] = libwebp_encode(opaque, segments=1)
    files["vp8_segments4.webp"] = libwebp_encode(opaque, segments=4, sns_strength=100)
    tall = np.asarray(src.crop((300, 100, 364, 260)))  # ten macroblock rows
    files["vp8_partitions8.webp"] = libwebp_encode(tall, partitions=3, method=0)
    files["lossless_predictors.webp"] = libwebp_encode(predictor_tiles(), quality=100,
                                                       lossless=1, method=6)
    files["alph_raw.webp"] = libwebp_encode(rgba, alpha_compression=0)
    for filt, pat in ((0, "blobs"), (1, "wave"), (2, "blobs"), (2, "half")):
        a = px.copy()
        a[..., 3] = pats[pat]
        files[f"alph_filtering{filt}_{pat}.webp"] = libwebp_encode(a, alpha_filtering=filt)
    return files


def digests(files: dict) -> dict:
    """Each file's sha256 and PIL's RGBA decode's sha256 and shape."""
    from PIL import Image

    out = {}
    for name, data in sorted(files.items()):
        rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        out[name] = {"sha256": hashlib.sha256(data).hexdigest(),
                     "decoded_sha256": hashlib.sha256(rgba.tobytes()).hexdigest(),
                     "shape": list(rgba.shape)}
    return out


def sidecar_digest(name: str) -> str:
    """The sha256 of figdraw_tpu's .flippy sidecar of the stored file `name`."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_reference import jax_flippy

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, name)
        shutil.copyfile(os.path.join(OUT_DIR, name), path)
        jax_flippy().read_image_cached(path)
        with open(path + ".flippy", "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()


def write_frames(names=None) -> None:
    """figdraw_tpu's block means of the image-file scene and the photo wall
    from the baseline JPEG, the TIFF fixture, the lossy WebP fixture and
    the ZSTD fixture, of the image-file scene from the dithered Group 3
    fixture and the SOF10 fixture, of the photo wall from the Group 4 fax
    page (its atlas started at scenes.FAX_ATLAS) and the SOF3 crop, and of
    both from the incomplete progressive JPEG, the RLE-W fixture, the
    seven AVIF fixtures, the grid fixture and the two film grain files;
    `names` limits it to those files."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_reference import block_means, jax_image_file_frame, jax_photo_wall_frame

    from figdraw_tpu_torch.scenes import (
        ARITH_FILE_REFERENCE, AVIF_422_FILE_REFERENCE, AVIF_422_WALL_REFERENCE,
        AVIF_422_12_FILE_REFERENCE, AVIF_422_12_WALL_REFERENCE, AVIF_444_10_FILE_REFERENCE,
        AVIF_444_10_WALL_REFERENCE, AVIF_444_FILE_REFERENCE, AVIF_444_WALL_REFERENCE,
        AVIF_CDEF10_FILE_REFERENCE, AVIF_CDEF10_WALL_REFERENCE, AVIF_CDEF_FILE_REFERENCE,
        AVIF_CDEF_WALL_REFERENCE, AVIF_FILE_REFERENCE, AVIF_GRAIN_422_10_FILE_REFERENCE,
        AVIF_GRAIN_422_10_WALL_REFERENCE, AVIF_GRAIN_FILE_REFERENCE, AVIF_GRAIN_WALL_REFERENCE,
        AVIF_GRID_FILE_REFERENCE, AVIF_SEQUENCE_FILE_REFERENCE,
        AVIF_SEQUENCE_LIMITED_FILE_REFERENCE, AVIF_SEQUENCE_LIMITED_WALL_REFERENCE,
        AVIF_SEQUENCE_WALL_REFERENCE,
        AVIF_GRID_WALL_REFERENCE, AVIF_WALL_REFERENCE, FAX_ATLAS, G3_FILE_REFERENCE,
        G4_WALL_REFERENCE,
        INCOMPLETE_FILE_REFERENCE, INCOMPLETE_WALL_REFERENCE, RLEW_FILE_REFERENCE,
        RLEW_WALL_REFERENCE,
        JPEG_FILE_REFERENCE, JPEG_WALL_REFERENCE, LOSSLESS_WALL_REFERENCE, PHOTO_WALL_SMALL,
        TIFF_FILE_REFERENCE, TIFF_WALL_REFERENCE, WEBP_FILE_REFERENCE, WEBP_WALL_REFERENCE,
        ZSTD_FILE_REFERENCE, ZSTD_WALL_REFERENCE,
    )

    for name, scene_ref, wall_ref, atlas in (
            (BASELINE, JPEG_FILE_REFERENCE, JPEG_WALL_REFERENCE, 512),
            (TIFF_FIXTURE, TIFF_FILE_REFERENCE, TIFF_WALL_REFERENCE, 512),
            (WEBP_FIXTURE, WEBP_FILE_REFERENCE, WEBP_WALL_REFERENCE, 512),
            (ZSTD_FIXTURE, ZSTD_FILE_REFERENCE, ZSTD_WALL_REFERENCE, 512),
            (G3_FIXTURE, G3_FILE_REFERENCE, None, 512),
            (FAX_PAGE, None, G4_WALL_REFERENCE, FAX_ATLAS),
            (ARITH_FIXTURE, ARITH_FILE_REFERENCE, None, 512),
            (LOSSLESS_FIXTURE, None, LOSSLESS_WALL_REFERENCE, 512),
            (INCOMPLETE_HUFF, INCOMPLETE_FILE_REFERENCE, INCOMPLETE_WALL_REFERENCE, 512),
            (RLEW_FIXTURE, RLEW_FILE_REFERENCE, RLEW_WALL_REFERENCE, 512),
            (AVIF_FIXTURE, AVIF_FILE_REFERENCE, AVIF_WALL_REFERENCE, 512),
            (AVIF_CDEF_FIXTURE, AVIF_CDEF_FILE_REFERENCE, AVIF_CDEF_WALL_REFERENCE, 512),
            (AVIF_444_FIXTURE, AVIF_444_FILE_REFERENCE, AVIF_444_WALL_REFERENCE, 512),
            (AVIF_422_FIXTURE, AVIF_422_FILE_REFERENCE, AVIF_422_WALL_REFERENCE, 512),
            ("fixture_s2_cdef_10bit.avif", AVIF_CDEF10_FILE_REFERENCE, AVIF_CDEF10_WALL_REFERENCE,
             512),
            ("fixture_444_10bit.avif", AVIF_444_10_FILE_REFERENCE, AVIF_444_10_WALL_REFERENCE, 512),
            ("fixture_422_12bit.avif", AVIF_422_12_FILE_REFERENCE, AVIF_422_12_WALL_REFERENCE,
             512),
            (AVIF_GRID_FIXTURE, AVIF_GRID_FILE_REFERENCE, AVIF_GRID_WALL_REFERENCE, 512),
            (AVIF_GRAIN_FIXTURE, AVIF_GRAIN_FILE_REFERENCE, AVIF_GRAIN_WALL_REFERENCE, 512),
            (AVIF_GRAIN_422_10, AVIF_GRAIN_422_10_FILE_REFERENCE,
             AVIF_GRAIN_422_10_WALL_REFERENCE, 512),
            (AVIF_SEQUENCE, AVIF_SEQUENCE_FILE_REFERENCE, AVIF_SEQUENCE_WALL_REFERENCE, 512),
            ("limited alpha", AVIF_SEQUENCE_LIMITED_FILE_REFERENCE,
             AVIF_SEQUENCE_LIMITED_WALL_REFERENCE, 512)):
        if names is not None and name not in names:
            continue
        with tempfile.TemporaryDirectory() as td:
            if name == "limited alpha":  # a card rewrite of the stored sequence
                path = os.path.join(td, "sequence_limited_alpha.avif")
                with open(os.path.join(OUT_DIR, AVIF_SEQUENCE), "rb") as fh:
                    data = card_rewrites(fh.read())[name]
                with open(path, "wb") as fh:
                    fh.write(data)
            else:
                path = os.path.join(td, name)
                shutil.copyfile(os.path.join(OUT_DIR, name), path)
            if scene_ref:
                np.save(scene_ref,
                        block_means(jax_image_file_frame(path, "1x")).astype(np.float32))
                print(f"wrote {scene_ref}")
            if wall_ref:
                w, h, n = PHOTO_WALL_SMALL
                np.save(wall_ref, block_means(jax_photo_wall_frame(path, w, h, n, atlas))
                        .astype(np.float32))
                print(f"wrote {wall_ref}")


def main() -> None:
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from PIL import Image

    files = image_files()
    files.update(libzstd_files(Image.open(FIXTURE).convert("RGBA")))
    os.makedirs(OUT_DIR, exist_ok=True)
    for name, data in files.items():
        with open(os.path.join(OUT_DIR, name), "wb") as fh:
            fh.write(data)
    stored = {"files": digests(files),
              "rewrites": {AVIF_SEQUENCE: digests(card_rewrites(files[AVIF_SEQUENCE]))},
              "sidecar": {name: sidecar_digest(name)
                          for name in (BASELINE, TIFF_FIXTURE, WEBP_FIXTURE, ZSTD_FIXTURE,
                                       FAX_PAGE, ARITH_FIXTURE, LOSSLESS_FIXTURE,
                                       INCOMPLETE_HUFF, RLEW_FIXTURE, AVIF_FIXTURE,
                                       AVIF_CDEF_FIXTURE, AVIF_444_FIXTURE, AVIF_422_FIXTURE,
                                       *AVIF_DEPTHS, AVIF_GRID_FIXTURE, AVIF_PHOTO,
                                       AVIF_GRAIN_FIXTURE, AVIF_GRAIN_422_10, AVIF_SEQUENCE)}}
    with open(DIGESTS, "w") as fh:
        json.dump(stored, fh, indent=1)
        fh.write("\n")
    total = sum(len(d) for d in files.values())
    print(f"wrote {len(files)} files ({total} bytes) to {OUT_DIR} and {DIGESTS}")
    write_frames()


if __name__ == "__main__":
    main()
