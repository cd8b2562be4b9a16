"""The port's TIFF reader: the first image of a TIFF or BigTIFF file to
(H, W, 4) uint8 RGBA, as PIL 12.1.0's `Image.open(path).convert("RGBA")`
returns it (figdraw_tpu decodes through PIL; the port may not import it).
PIL reads an uncompressed file with its own unpackers and every compressed
one through libtiff 4.7.1 (TiffImagePlugin.py:1559), then applies the
Orientation tag on load (`load_end`: ImageOps.exif_transpose) and converts
its mode to RGBA; each step is matched here.

Read: classic TIFF (II*, MM*) and BigTIFF (II+, MM+), the first IFD, every
field type; strips (RowsPerStrip need not divide the height, and may be
missing) and tiles (edge tiles padded past the image, cropped);
PlanarConfiguration 1 and 2; FillOrder 2 (every stored byte's bits
reversed before decoding, as libtiff and PIL's ";R" unpackers do).
Compression: none, PackBits, LZW, Adobe and old Deflate (stdlib zlib),
LZMA (stdlib lzma), ZSTD (utils/zstd.py: libtiff's reading of one
Zstandard frame a strip), each with the horizontal (Predictor 2, 8 to 64
bits a sample) or floating-point predictor (3) where libtiff applies one;
CCITT Modified Huffman (2), T.4 (3, one- and two-dimensional), T.6 (4)
and RLE-W (32771: Modified Huffman, each row word-aligned) on one 1-bit
sample (utils/fax.py, with libtiff's leniency: fax_context carries PIL's
strip buffer and libtiff's run arrays from strip to strip; the extension
code of uncompressed mode ends its row, as libtiff reads it);
and JPEG (7): each strip or tile an abbreviated stream completed by
JPEGTables and decoded by utils/jpeg.py in the colour space the
photometric tag names (YCbCr converted to RGB per strip, as libjpeg does
under Pillow's JPEGCOLORMODE_RGB; RGB, grey and CMYK samples kept).
PackBits, LZW, the predictors and CCITT run in C++ (csrc/image_decode.cpp:
fd_tiff_packbits, fd_tiff_lzw, fd_tiff_predict, fd_tiff_fax), Zstandard
too (csrc/zstd_decode.cpp: fd_zstd_decompress); `packbits_plain`,
`lzw_plain`, `predict_plain`, `fax_plain` and `zstd_plain` are their
twins, the tests' reference.

Pixels: the keys of PIL's OPEN_INFO (TiffImagePlugin.py:151) in FORMATS
below, each unpacked as PIL's rawmode and converted as PIL's Convert.c:
bilevel and 2/4/8-bit grey (MinIsBlack and MinIsWhite), LA, 16-bit grey
(clipped at 255), signed 16 and 32-bit and unsigned 32-bit grey (mode I,
clipped to 0..255), 32-bit float (mode F: truncated, clipped, NaN to 0),
palettes of 1-8 bits (the 16-bit ColorMap's high bytes), PA, RGB, RGBA,
RGBX and associated alpha (RGBa: un-premultiplied by truncating division)
at 8 bits and 16 (the high bytes), CMYK at 8 and 16 bits (Convert.c
cmyk2rgb). Two of PIL's quirks are kept: a compressed big-endian file of
signed or float samples reads byte-swapped (libtiff hands over host-order
samples that PIL's rawmode swaps again), and planar files of one sample
or with other extra samples than alpha raise (PIL misreads them).

Raises NotImplementedError naming what is not ported (old-style JPEG,
ThunderScan, WebP, JBIG, SGILog and other compressions; Lab, LogLuv and
other photometrics; YCbCr without JPEG, which libtiff reads through
TIFFRGBAImage; separated files with inks other than CMYK; a pixel key of
no test), and ValueError for a
malformed file (CCITT on samples of more than 1 bit among them, which
libtiff refuses).
"""

from __future__ import annotations

import lzma
import struct
import sys
import zlib

import numpy as np

from . import fax, image_lib, jpeg, zstd

# tags
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILL_ORDER = 256, 257, 258, 259, 262, 266
STRIP_OFFSETS, ORIENTATION, SAMPLES, ROWS_PER_STRIP, STRIP_COUNTS = 273, 274, 277, 278, 279
T4_OPTIONS, PLANAR, PREDICTOR, COLORMAP = 292, 284, 317, 320
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS = 322, 323, 324, 325
INK_SET, EXTRA_SAMPLES, SAMPLE_FORMAT, JPEG_TABLES = 332, 338, 339, 347
YCBCR_SUBSAMPLING = 530

# field type -> (bytes a value, struct code); 1, 2 and 7 are kept as bytes,
# rationals (5, 10) read as num / den
FIELD_TYPES = {1: (1, "B"), 2: (1, "B"), 3: (2, "H"), 4: (4, "I"), 5: (8, "II"),
               6: (1, "b"), 7: (1, "B"), 8: (2, "h"), 9: (4, "i"), 10: (8, "ii"),
               11: (4, "f"), 12: (8, "d"), 13: (4, "I"), 16: (8, "Q"), 17: (8, "q"),
               18: (8, "Q")}

NONE, LZW, JPEG, ADOBE_DEFLATE, PACKBITS, DEFLATE, LZMA = 1, 5, 7, 8, 32773, 32946, 34925
CCITT_MH, CCITT_T4, CCITT_T6, CCITT_RLEW, ZSTD = 2, 3, 4, 32771, 50000
FAX = (CCITT_MH, CCITT_T4, CCITT_T6, CCITT_RLEW)
COMPRESSIONS = (NONE, LZW, JPEG, ADOBE_DEFLATE, PACKBITS, DEFLATE, LZMA, ZSTD) + FAX
PREDICTED = (LZW, ADOBE_DEFLATE, DEFLATE, LZMA, ZSTD)  # the codecs libtiff runs a predictor in
NOT_PORTED_COMPRESSION = {
    6: "old-style JPEG", 32809: "ThunderScan",
    34661: "JBIG", 34676: "SGILog", 34677: "SGILog24", 50001: "WebP"}
NOT_PORTED_PHOTOMETRIC = {
    4: "transparency mask", 8: "CIE L*a*b*", 9: "ICC L*a*b*", 10: "ITU L*a*b*",
    32803: "colour filter array", 32844: "LogL", 32845: "LogLuv", 34892: "linear raw"}

_II, _MM = "<", ">"
_BOTH = (_II, _MM)
_NATIVE = "<" if sys.byteorder == "little" else ">"

# PIL 12.1.0's OPEN_INFO keys the port reads: (photometric, sample format,
# fill orders, bits a sample, extra samples, byte orders, mode); the mode
# names the unpacking (PIL's rawmode family) and the RGBA conversion.
_ROWS = [
    (0, (1,), (1, 2), (1,), (), _BOTH, "1;I"),
    (1, (1,), (1, 2), (1,), (), _BOTH, "1"),
    (0, (1,), (1, 2), (2,), (), _BOTH, "L;2I"),
    (1, (1,), (1, 2), (2,), (), _BOTH, "L;2"),
    (0, (1,), (1, 2), (4,), (), _BOTH, "L;4I"),
    (1, (1,), (1, 2), (4,), (), _BOTH, "L;4"),
    (0, (1,), (1, 2), (8,), (), _BOTH, "L;I"),
    (1, (1,), (1, 2), (8,), (), _BOTH, "L"),
    (1, (2,), (1,), (8,), (), _BOTH, "L"),
    (1, (1,), (1,), (8, 8), (2,), _BOTH, "LA"),
    (0, (1,), (1,), (16,), (), (_II,), "I;16"),
    (1, (1,), (1,), (16,), (), _BOTH, "I;16"),
    (1, (1,), (2,), (16,), (), (_II,), "I;16"),
    (1, (2,), (1,), (16,), (), _BOTH, "I;16S"),
    (0, (3,), (1,), (32,), (), _BOTH, "F"),
    (1, (3,), (1,), (32,), (), _BOTH, "F"),
    (1, (1,), (1,), (32,), (), (_II,), "I;32N"),
    (1, (2,), (1,), (32,), (), _BOTH, "I;32S"),
    (2, (1,), (1, 2), (8,) * 3, (), _BOTH, "RGB"),
    (2, (1,), (1,), (8,) * 4, (), _BOTH, "RGBA"),
    (2, (1,), (1,), (8,) * 4, (0,), _BOTH, "RGBX"),
    (2, (1,), (1,), (8,) * 5, (0, 0), _BOTH, "RGBX"),
    (2, (1,), (1,), (8,) * 6, (0, 0, 0), _BOTH, "RGBX"),
    (2, (1,), (1,), (8,) * 4, (1,), _BOTH, "RGBa"),
    (2, (1,), (1,), (8,) * 5, (1, 0), _BOTH, "RGBa"),
    (2, (1,), (1,), (8,) * 6, (1, 0, 0), _BOTH, "RGBa"),
    (2, (1,), (1,), (8,) * 4, (2,), _BOTH, "RGBA"),
    (2, (1,), (1,), (8,) * 5, (2, 0), _BOTH, "RGBA"),
    (2, (1,), (1,), (8,) * 6, (2, 0, 0), _BOTH, "RGBA"),
    (2, (1,), (1,), (8,) * 4, (999,), _BOTH, "RGBA"),
    (2, (1,), (1,), (16,) * 3, (), _BOTH, "RGB"),
    (2, (1,), (1,), (16,) * 4, (), _BOTH, "RGBA"),
    (2, (1,), (1,), (16,) * 4, (0,), _BOTH, "RGBX"),
    (2, (1,), (1,), (16,) * 4, (1,), _BOTH, "RGBa"),
    (2, (1,), (1,), (16,) * 4, (2,), _BOTH, "RGBA"),
    (3, (1,), (1, 2), (1,), (), _BOTH, "P"),
    (3, (1,), (1, 2), (2,), (), _BOTH, "P"),
    (3, (1,), (1, 2), (4,), (), _BOTH, "P"),
    (3, (1,), (1, 2), (8,), (), _BOTH, "P"),
    (3, (1,), (1,), (8, 8), (0,), _BOTH, "P"),
    (3, (1,), (1,), (8, 8), (2,), _BOTH, "PA"),
    (5, (1,), (1,), (8,) * 4, (), _BOTH, "CMYK"),
    (5, (1,), (1,), (8,) * 5, (0,), _BOTH, "CMYK"),
    (5, (1,), (1,), (8,) * 6, (0, 0), _BOTH, "CMYK"),
    (5, (1,), (1,), (16,) * 4, (), _BOTH, "CMYK"),
    (6, (1,), (1,), (8,) * 3, (), _BOTH, "RGB"),  # JPEG only: converted by libjpeg
]
FORMATS = {(order, photo, fmt, fill, bits, extra): mode
           for photo, fmt, fills, bits, extra, orders, mode in _ROWS
           for fill in fills for order in orders}
# the planar (PlanarConfiguration 2) keys PIL reads: (photometric, bits,
# extra samples) -> (mode uncompressed, mode through libtiff). Pillow's
# libtiff decoder un-premultiplies planes whose first extra sample is
# associated or unspecified (libtiff names a fourth sample without
# ExtraSamples unspecified); its own reader has no unpacker for a plane
# of associated alpha, and misplaces edge tiles without ExtraSamples.
_PLANAR = {(2, (8,) * 3, ()): ("RGB", "RGB"), (2, (8,) * 4, ()): (None, "RGBa"),
           (2, (8,) * 4, (1,)): (None, "RGBa"), (2, (8,) * 4, (2,)): ("RGBA", "RGBA")}
# (photometric, bits) whose FillOrder 2 PIL's own reader has no unpacker
# for ("L;IR", "P;1R", "P;2R", "P;4R"): uncompressed, they raise
_NO_REVERSED_RAW = ((0, 8), (3, 1), (3, 2), (3, 4))

REVERSED_BITS = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _unsupported(what: str):
    return NotImplementedError(jpeg.UNSUPPORTED.format(what))


# --- the IFD --------------------------------------------------------------------


def read_ifd(data: bytes) -> tuple:
    """(byte order "<" or ">", BigTIFF, {tag: value}) of the first IFD:
    types 1, 2 and 7 as bytes, the others as tuples of numbers (rationals
    as floats); entries of unknown types are skipped, as PIL skips them."""
    head = data[:4]
    if head in (b"II*\x00", b"MM\x00*"):
        big = False
    elif head in (b"II+\x00", b"MM\x00+"):
        big = True
    else:
        raise ValueError("not a TIFF file")
    o = _II if head[:2] == b"II" else _MM
    try:
        if big:
            size, _zero, at = struct.unpack_from(o + "HHQ", data, 4)
            if size != 8:
                raise ValueError("BigTIFF with an offset size other than 8")
            (n,) = struct.unpack_from(o + "Q", data, at)
            first, entry, inline, head_fmt = at + 8, 20, 8, "HHQ"
        else:
            (at,) = struct.unpack_from(o + "I", data, 4)
            (n,) = struct.unpack_from(o + "H", data, at)
            first, entry, inline, head_fmt = at + 2, 12, 4, "HHI"
        tags = {}
        for k in range(n):
            pos = first + k * entry
            tag, ftype, count = struct.unpack_from(o + head_fmt, data, pos)
            if ftype not in FIELD_TYPES:
                continue
            unit, code = FIELD_TYPES[ftype]
            size = unit * count
            where = pos + 8 if not big else pos + 12
            if size > inline:
                (where,) = struct.unpack_from(o + ("Q" if big else "I"), data, where)
            raw = data[where: where + size]
            if len(raw) < size:
                raise ValueError(f"TIFF tag {tag} runs past the end of the file")
            if ftype in (1, 2, 7):
                tags[tag] = bytes(raw)
            elif ftype in (5, 10):
                v = struct.unpack(o + code[0] * (2 * count), raw)
                tags[tag] = tuple(v[i] / v[i + 1] if v[i + 1] else float("nan")
                                  for i in range(0, len(v), 2))
            else:
                tags[tag] = struct.unpack(o + code * count, raw)
    except struct.error:
        raise ValueError("truncated TIFF file: the IFD runs past the end") from None
    return o, big, tags


# TIFFDataWidth: the bytes of one value of each field type (0: unknown)
_TYPE_WIDTH = {1: 1, 2: 1, 6: 1, 7: 1, 3: 2, 8: 2, 4: 4, 9: 4, 11: 4, 13: 4,
               5: 8, 10: 8, 12: 8, 16: 8, 17: 8, 18: 8}


def _directory_bytes(data: bytes, order: str, big: bool) -> int:
    """libtiff's EstimateStripByteCounts `space` before the file size: the
    header, the first IFD and every value stored outside it."""
    if big:
        (at,) = struct.unpack_from(order + "Q", data, 8)
        (n,) = struct.unpack_from(order + "Q", data, at)
        space, entry, inline, fmt = 16 + 8 + n * 20 + 8, 20, 8, "HHQ"
    else:
        (at,) = struct.unpack_from(order + "I", data, 4)
        (n,) = struct.unpack_from(order + "H", data, at)
        space, entry, inline, fmt = 8 + 2 + n * 12 + 4, 12, 4, "HHI"
    for k in range(n):
        _tag, ftype, count = struct.unpack_from(order + fmt, data, at + (8 if big else 2)
                                                + k * entry)
        width = _TYPE_WIDTH.get(ftype, 0)
        if width == 0:
            raise ValueError(f"TIFF tag of unknown type {ftype}: libtiff cannot estimate "
                             "the strip's byte count")
        size = width * count
        space += size if size > inline else 0
    return space


def _ints(tags: dict, tag: int, default=None) -> tuple:
    v = tags.get(tag)
    if v is None:
        return default
    return tuple(int(x) for x in v)


class Image:
    """The first IFD's image: geometry, its PIL key and mode, where its
    strips or tiles lie."""

    def __init__(self, order: str, tags: dict, data: bytes = None, big: bool = False):
        """data (the file's bytes) and big let a single strip's byte count
        be repaired as libtiff repairs it."""
        self.order, self.tags = order, tags
        self.compression = _ints(tags, COMPRESSION, (1,))[0]
        if self.compression in NOT_PORTED_COMPRESSION:
            raise _unsupported(f"a TIFF with {NOT_PORTED_COMPRESSION[self.compression]} "
                               f"compression ({self.compression})")
        if self.compression not in COMPRESSIONS:
            raise ValueError(f"TIFF compression {self.compression} is unknown (PIL reads "
                             "no such file)")
        self.photometric = photo = _ints(tags, PHOTOMETRIC, (0,))[0]
        if photo in NOT_PORTED_PHOTOMETRIC:
            raise _unsupported(f"a TIFF of photometric {NOT_PORTED_PHOTOMETRIC[photo]} "
                               f"({photo})")
        self.planar = _ints(tags, PLANAR, (1,))[0]
        if photo == 6 and not (self.compression == JPEG and self.planar == 1):
            raise _unsupported("a YCbCr TIFF without JPEG compression (libtiff's "
                               "TIFFRGBAImage path)")
        if photo == 5 and _ints(tags, INK_SET, (1,))[0] != 1:
            raise _unsupported("a separated TIFF with inks other than CMYK (InkSet 2)")
        try:
            self.width, self.height = tags[WIDTH][0], tags[LENGTH][0]
        except KeyError:
            raise ValueError("TIFF without ImageWidth or ImageLength") from None
        if self.width < 1 or self.height < 1:
            raise ValueError("TIFF of no pixels")
        fill = _ints(tags, FILL_ORDER, (1,))[0]
        fmt = _ints(tags, SAMPLE_FORMAT, (1,))
        if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
            fmt = (1,)
        bits = _ints(tags, BITS, (1,))
        extra = _ints(tags, EXTRA_SAMPLES, ())
        spp = _ints(tags, SAMPLES, (1,))[0]
        if spp > 6:
            raise ValueError("TIFF of more than 6 samples a pixel (PIL reads none)")
        if spp < len(bits):
            bits = bits[:spp]
        elif spp > len(bits) and len(bits) == 1:
            bits = bits * spp
        if len(bits) != spp:
            raise ValueError("TIFF whose BitsPerSample does not match SamplesPerPixel")
        if self.compression in FAX and (bits[0] != 1 or spp != 1 and self.planar == 1):
            raise ValueError(f"TIFF CCITT fax of {spp} sample(s) of {bits[0]} bits (libtiff: "
                             "\"Bits/sample must be 1 for Group 3/4 encoding/decoding\", "
                             "one sample unless planar)")
        self.t4options = _ints(tags, T4_OPTIONS, (0,))[0]
        key = (order, photo, fmt, fill, bits, extra)
        self.mode = FORMATS.get(key)
        if self.mode is None:
            raise _unsupported(f"a TIFF of pixel key {key} (byte order, photometric, "
                               "sample format, fill order, bits, extra samples)")
        self.fill, self.format, self.spp, self.extra = fill, fmt[0], spp, extra
        self.bits = bits[0]
        if fill == 2 and self.compression == NONE and (photo, self.bits) in _NO_REVERSED_RAW:
            raise _unsupported(f"an uncompressed TIFF of pixel key {key} (PIL has no "
                               "unpacker for its bit order)")
        if self.planar == 2 and spp > 1:
            modes = _PLANAR.get((photo, bits, extra))
            mode = modes and modes[self.compression != NONE]
            if mode is None:
                raise _unsupported(f"a planar TIFF of pixel key {key}")
            self.mode = mode
        elif self.planar == 2 and self.compression == NONE:
            raise _unsupported(f"an uncompressed planar TIFF of one sample, key {key}")
        elif self.planar not in (1, 2):
            raise ValueError(f"TIFF PlanarConfiguration {self.planar}")
        self.planes = spp if self.planar == 2 and spp > 1 else 1
        self.plane_spp = spp // self.planes
        self.predictor = _ints(tags, PREDICTOR, (1,))[0] if self.compression in PREDICTED else 1
        if self.predictor not in (1, 2, 3):
            raise ValueError(f"TIFF Predictor {self.predictor} (libtiff reads 1, 2, 3)")
        if self.predictor == 2 and self.bits not in (8, 16, 32, 64):
            raise ValueError(f"TIFF horizontal predictor on {self.bits}-bit samples")
        if self.predictor == 3 and (self.format != 3 or self.bits not in (16, 32, 64)):
            raise ValueError("TIFF floating-point predictor on samples that are not floats")
        if TILE_OFFSETS in tags:
            self.tiled = True
            self.cw, self.ch = _ints(tags, TILE_WIDTH, (0,))[0], _ints(tags, TILE_LENGTH, (0,))[0]
            offsets, counts = _ints(tags, TILE_OFFSETS), _ints(tags, TILE_COUNTS)
        elif STRIP_OFFSETS in tags:
            self.tiled = False
            rps = _ints(tags, ROWS_PER_STRIP, (self.height,))[0]
            self.cw, self.ch = self.width, min(rps, self.height)
            offsets, counts = _ints(tags, STRIP_OFFSETS), _ints(tags, STRIP_COUNTS)
        else:
            raise ValueError("TIFF without strips or tiles")
        if self.cw < 1 or self.ch < 1:
            raise ValueError("TIFF strips or tiles of no pixels")
        if self.tiled and self.cw * self.plane_spp * self.bits % 8:
            raise _unsupported("a TIFF whose tiles do not start on a byte")
        self.across = -(-self.width // self.cw)
        self.down = -(-self.height // self.ch)
        n = self.across * self.down * self.planes
        if len(offsets) < n:
            raise ValueError(f"TIFF with {len(offsets)} strip or tile offsets for {n}")
        if counts is None:
            if self.compression != NONE:
                raise ValueError("compressed TIFF without StripByteCounts or TileByteCounts")
            counts = tuple(self.chunk_bytes(self.ch) for _ in range(n))
        self.offsets, self.counts = offsets[:n], counts[:n]
        if data is not None and n == 1 and not self.tiled and self._count_looks_bad(len(data)):
            self.counts = (self._estimated_count(data, big),)
        self.row_bytes = (self.cw * self.plane_spp * self.bits + 7) // 8

    def _count_looks_bad(self, file_size: int) -> bool:
        """libtiff's ByteCountLooksBad (tif_dirread.c) for a single strip:
        a count of 0 beside a non-zero offset, or an uncompressed strip's
        count past the end of the file or short of its rows."""
        offset, count = self.offsets[0], self.counts[0]
        if offset == 0:
            return False
        if count == 0:
            return True
        if self.compression != NONE:
            return False
        if offset <= file_size and count > file_size - offset:
            return True
        return count < self.chunk_bytes(self.height)

    def _estimated_count(self, data: bytes, big: bool) -> int:
        """libtiff's EstimateStripByteCounts for a single strip: a
        compressed strip runs over what the header and the IFD leave of
        the file, cut at the end of the file; an uncompressed one holds
        its rows."""
        if self.compression == NONE:
            return self.chunk_bytes(self.height)
        file_size = len(data)
        space = max(file_size - _directory_bytes(data, self.order, big), 0)
        if self.planar == 2:
            space //= self.spp
        offset = self.offsets[0]
        if offset + space > file_size:
            space = max(file_size - offset, 0)
        return space

    def chunk_bytes(self, rows: int) -> int:
        return rows * ((self.cw * self.plane_spp * self.bits + 7) // 8)

    def chunks(self):
        """(plane, y, x, stored bytes) of every strip or tile, in file order."""
        k = 0
        for plane in range(self.planes):
            for j in range(self.down):
                for i in range(self.across):
                    yield plane, j * self.ch, i * self.cw, self.offsets[k], self.counts[k]
                    k += 1

    def chunk_rows(self, y: int) -> int:
        """The rows a strip or tile decodes to: a tile decodes whole, a
        strip to the image's last row; PIL's own reader of an uncompressed
        tile reads only the rows inside the image."""
        if self.tiled and self.compression != NONE:
            return self.ch
        return min(self.ch, self.height - y)


# --- the decompressors and the predictors -------------------------------------------


def packbits(data: bytes, n: int) -> np.ndarray:
    """The first n bytes a PackBits strip decodes to, in C++; ValueError if
    the data runs out first."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty(n, np.uint8)
    got = image_lib.load().fd_tiff_packbits(src.ctypes.data, len(data), out.ctypes.data, n)
    if got < n:
        raise ValueError("truncated TIFF PackBits data")
    return out


def packbits_plain(data: bytes, n: int) -> np.ndarray:
    """packbits in Python."""
    out, p = bytearray(), 0
    while len(out) < n and p < len(data):
        h = data[p]
        p += 1
        if h < 128:
            out += data[p: p + h + 1]
            p += h + 1
        elif h > 128 and p < len(data):
            out += bytes([data[p]]) * (257 - h)
            p += 1
    if len(out) < n:
        raise ValueError("truncated TIFF PackBits data")
    return np.frombuffer(bytes(out[:n]), np.uint8).copy()


def _old_lzw(data: bytes) -> bool:
    """libtiff's test for the old, LSB-first LZW codes (tif_lzw.c)."""
    return len(data) >= 2 and data[0] == 0 and data[1] & 1


def lzw(data: bytes, n: int) -> np.ndarray:
    """The first n bytes a TIFF LZW strip decodes to, in C++."""
    if _old_lzw(data):
        raise _unsupported("a TIFF of old-style (LSB-first) LZW codes")
    src = np.frombuffer(data, np.uint8)
    out = np.empty(n, np.uint8)
    got = image_lib.load().fd_tiff_lzw(src.ctypes.data, len(data), out.ctypes.data, n)
    if got < 0:
        raise ValueError("corrupt TIFF LZW data: a code past the table")
    if got < n:
        raise ValueError("truncated TIFF LZW data")
    return out


def lzw_plain(data: bytes, n: int) -> np.ndarray:
    """lzw in Python, with the table as byte strings."""
    if _old_lzw(data):
        raise _unsupported("a TIFF of old-style (LSB-first) LZW codes")
    first = [bytes([i]) for i in range(256)] + [b"", b""]
    out, table, size, prev = bytearray(), list(first), 9, None
    acc = nbits = pos = 0
    while len(out) < n:
        while nbits < size and pos < len(data):
            acc = (acc << 8) | data[pos]
            nbits += 8
            pos += 1
        if nbits < size:
            break
        nbits -= size
        code = acc >> nbits
        acc &= (1 << nbits) - 1
        if code == 256:
            table, size, prev = list(first), 9, None
            continue
        if code == 257:
            break
        if prev is None:
            if code > 256:
                raise ValueError("corrupt TIFF LZW data: a code past the table")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = table[prev] + table[prev][:1]
            else:
                raise ValueError("corrupt TIFF LZW data: a code past the table")
            if len(table) < 4096:
                table.append(table[prev] + entry[:1])
                if len(table) == (1 << size) - 1 and size < 12:
                    size += 1
        out += entry
        prev = code
    if len(out) < n:
        raise ValueError("truncated TIFF LZW data")
    return np.frombuffer(bytes(out[:n]), np.uint8).copy()


def inflate(data: bytes, n: int, compression: int) -> np.ndarray:
    """The first n bytes of a Deflate (zlib) or LZMA (xz) strip."""
    try:
        if compression == LZMA:
            out = lzma.LZMADecompressor(format=lzma.FORMAT_XZ).decompress(data, n)
        else:
            out = zlib.decompressobj().decompress(data, n)
    except (zlib.error, lzma.LZMAError) as exc:
        raise ValueError(f"corrupt TIFF compressed data: {exc}") from None
    if len(out) < n:
        raise ValueError("truncated TIFF compressed data")
    return np.frombuffer(out, np.uint8).copy()


def zstd_strip(data: bytes, n: int) -> np.ndarray:
    """The first n bytes a ZSTD strip decodes to, in C++ (utils/zstd.py),
    as libtiff's ZSTDDecode reads them: its first frame; ValueError for
    corrupt data or one that ends first."""
    return _enough(zstd.decompress(data, n), n)


def zstd_plain(data: bytes, n: int) -> np.ndarray:
    """zstd_strip in Python."""
    return _enough(zstd.decompress_plain(data, n), n)


def _enough(out: np.ndarray, n: int) -> np.ndarray:
    if len(out) < n:
        raise ValueError(f"truncated TIFF ZSTD data ({len(out)} of {n} bytes)")
    return out


def fax_context(img: "Image") -> tuple:
    """What PIL's libtiff decoder keeps across an image's strips or tiles:
    its strip buffer (rows the data never reaches keep the last strip's
    bytes there; the first strip's start as zeros) and libtiff's fax
    state (utils/fax.py: new_state)."""
    two_d = img.compression == CCITT_T6 or (img.compression == CCITT_T4
                                            and bool(img.t4options & fax.T4_2D))
    return (np.zeros((img.ch, img.row_bytes), np.uint8), fax.new_state(img.cw, two_d))


def fax_rows(data: bytes, img: "Image", rows: int, ctx: tuple, offset: int) -> np.ndarray:
    """A CCITT strip or tile of `rows` rows in C++ (csrc/image_decode.cpp:
    fd_tiff_fax) into the context's buffer: its rows x row_bytes bytes.
    offset: the strip's or tile's offset in the file (RLE-W aligns to its
    parity)."""
    out, state = ctx
    fax.decode(data, img.cw, rows, img.compression, img.t4options, out[:rows], state, img.tiled,
               bool(offset & 1))
    return out[:rows].reshape(-1).copy()


def fax_plain(data: bytes, img: "Image", rows: int, ctx: tuple, offset: int) -> np.ndarray:
    """fax_rows in Python."""
    out, state = ctx
    fax.decode_plain(data, img.cw, rows, img.compression, img.t4options, out[:rows], state,
                     img.tiled, bool(offset & 1))
    return out[:rows].reshape(-1).copy()


def predict(buf: np.ndarray, rows: int, row_bytes: int, spp: int, nbytes: int, kind: int,
            swap: bool) -> np.ndarray:
    """libtiff's predictor (kind 2 horizontal, 3 floating point) on a
    decoded strip or tile of rows x row_bytes bytes, in place, in C++: the
    samples come back in the host's byte order."""
    if buf.dtype != np.uint8 or not buf.flags.c_contiguous or buf.size < rows * row_bytes:
        raise ValueError("predict takes a contiguous uint8 buffer of rows x row_bytes")
    scratch = np.empty(row_bytes, np.uint8)
    rc = image_lib.load().fd_tiff_predict(buf.ctypes.data, rows, row_bytes, spp, nbytes, kind,
                                          int(swap), scratch.ctypes.data)
    if rc < 0:
        raise ValueError("TIFF predictor rows that are not whole samples")
    return buf


def predict_plain(buf: np.ndarray, rows: int, row_bytes: int, spp: int, nbytes: int,
                  kind: int, swap: bool) -> np.ndarray:
    """predict in numpy: a cumulative sum along each row (it wraps at the
    sample's width), then for kind 3 the byte planes interleaved."""
    if row_bytes % (nbytes * spp):
        raise ValueError("TIFF predictor rows that are not whole samples")
    if kind == 2:
        dt = np.dtype(f"u{nbytes}")
        file_order = (_MM if _NATIVE == _II else _II) if swap else _NATIVE
        vals = buf.reshape(rows, row_bytes).view(dt.newbyteorder(file_order))
        vals = vals.astype(dt).reshape(rows, -1, spp)
        out = np.cumsum(vals, axis=1, dtype=dt)
        buf[:] = out.reshape(-1).view(np.uint8)
        return buf
    b = buf.reshape(rows, -1, spp)
    acc = np.cumsum(b, axis=1, dtype=np.uint8).reshape(rows, nbytes, -1)
    native = acc.transpose(0, 2, 1)
    if _NATIVE == "<":
        native = native[..., ::-1]
    buf[:] = np.ascontiguousarray(native).reshape(-1)
    return buf


# --- strips and tiles to samples ----------------------------------------------------


def _stored(data: bytes, img: Image, offset: int, count: int) -> bytes:
    """A strip's or tile's stored bytes, their bits reversed for FillOrder 2."""
    stored = data[offset: offset + count]
    if len(stored) < count:
        raise ValueError("truncated TIFF file: a strip or tile runs past the end")
    if img.fill == 2:
        stored = REVERSED_BITS[np.frombuffer(stored, np.uint8)].tobytes()
    return stored


def _predictor_args(img: Image, rows: int) -> tuple:
    return (rows, img.row_bytes, img.plane_spp, img.bits // 8, img.predictor,
            img.order != _NATIVE)


def _chunk(data: bytes, img: Image, y: int, offset: int, count: int, plain: bool,
           ctx: tuple = None):
    """One strip or tile to (rows, cw, plane_spp) samples: unsigned ints of
    the sample's width in the host's byte order, or sub-byte values. ctx:
    a CCITT image's fax_context."""
    rows = img.chunk_rows(y)
    n = rows * img.row_bytes
    stored = _stored(data, img, offset, count)
    c = img.compression
    if c == NONE:
        if len(stored) < n:
            raise ValueError("truncated TIFF strip or tile")
        buf = np.frombuffer(stored, np.uint8, n).copy()
    elif c == PACKBITS:
        buf = (packbits_plain if plain else packbits)(stored, n)
    elif c == LZW:
        buf = (lzw_plain if plain else lzw)(stored, n)
    elif c in FAX:
        buf = (fax_plain if plain else fax_rows)(stored, img, rows, ctx, offset)
    elif c == ZSTD:
        buf = (zstd_plain if plain else zstd_strip)(stored, n)
    else:
        buf = inflate(stored, n, c)
    native = False
    if img.predictor != 1:
        (predict_plain if plain else predict)(buf, *_predictor_args(img, rows))
        native = True
    rows_bytes = buf.reshape(rows, img.row_bytes)
    if img.bits < 8:
        per = 8 // img.bits
        shifts = np.arange(8 - img.bits, -1, -img.bits, dtype=np.uint8)
        vals = (rows_bytes[:, :, None] >> shifts) & ((1 << img.bits) - 1)
        return vals.reshape(rows, -1)[:, : img.cw, None]
    order = _NATIVE if native else img.order
    dt = np.dtype(f"u{img.bits // 8}")
    vals = rows_bytes[:, : img.cw * img.plane_spp * img.bits // 8].view(dt.newbyteorder(order))
    return vals.astype(dt).reshape(rows, img.cw, img.plane_spp)


def stage_pairs(data: bytes):
    """Each strip's or tile's C++ stages beside their plain twins on the
    same input: yields (stage, C++ output, plain output) for the
    decompressor ("packbits": fd_tiff_packbits, "lzw": fd_tiff_lzw, "fax":
    fd_tiff_fax, "zstd": fd_zstd_decompress) and the predictor
    ("predict": fd_tiff_predict); nothing for a file that runs none."""
    order, big, tags = read_ifd(data)
    img = Image(order, tags, data, big)
    if img.compression not in (PACKBITS, LZW, ZSTD) + FAX and img.predictor == 1:
        return
    if img.compression in FAX:
        ctx, plain_ctx = fax_context(img), fax_context(img)
    for _plane, y, _x, offset, count in img.chunks():
        rows = img.chunk_rows(y)
        n = rows * img.row_bytes
        stored = _stored(data, img, offset, count)
        if img.compression == PACKBITS:
            buf = packbits(stored, n)
            yield "packbits", buf, packbits_plain(stored, n)
        elif img.compression == LZW:
            buf = lzw(stored, n)
            yield "lzw", buf, lzw_plain(stored, n)
        elif img.compression in FAX:
            yield ("fax", fax_rows(stored, img, rows, ctx, offset),
                   fax_plain(stored, img, rows, plain_ctx, offset))
            continue
        elif img.compression == ZSTD:
            buf = zstd_strip(stored, n)
            yield "zstd", buf, zstd_plain(stored, n)
        else:
            buf = inflate(stored, n, img.compression)
        if img.predictor != 1:
            args = _predictor_args(img, rows)
            yield "predict", predict(buf.copy(), *args), predict_plain(buf.copy(), *args)


def _samples(data: bytes, img: Image, plain: bool) -> np.ndarray:
    """Every strip or tile placed: (H, W, spp) samples in the host's order."""
    dt = np.uint8 if img.bits <= 8 else np.dtype(f"u{img.bits // 8}")
    out = np.zeros((img.height, img.width, img.spp), dt)
    ctx = fax_context(img) if img.compression in FAX else None
    for plane, y, x, offset, count in img.chunks():
        vals = _chunk(data, img, y, offset, count, plain, ctx)
        h, w = min(vals.shape[0], img.height - y), min(img.cw, img.width - x)
        k = plane * img.plane_spp
        out[y: y + h, x: x + w, k: k + img.plane_spp] = vals[:h, :w]
    return out


def _jpeg_samples(data: bytes, img: Image, plain: bool) -> np.ndarray:
    """A JPEG-compressed TIFF's strips or tiles, each an abbreviated JPEG
    stream completed by JPEGTables: (H, W, spp) uint8, YCbCr converted to
    RGB, other samples as coded."""
    if img.planes != 1 or img.bits != 8:
        raise _unsupported(f"a JPEG-compressed TIFF of pixel mode {img.mode} planar "
                           f"{img.planar}")
    tables = img.tags.get(JPEG_TABLES, b"")
    # libtiff's JPEGPreDecode: the first component's sampling factors are
    # YCbCrSubsampling's (default 2, 2) for YCbCr, else 1, 1
    sampling = _ints(img.tags, YCBCR_SUBSAMPLING, (2, 2)) if img.photometric == 6 else (1, 1)
    out = np.zeros((img.height, img.width, img.spp), np.uint8)
    for _plane, y, x, offset, count in img.chunks():
        stored = _stored(data, img, offset, count)
        px = jpeg.decode_abbreviated(stored, tables, img.photometric == 6,
                                     tuple(sampling[:2]), plain)
        if px.shape[2] != img.spp:
            raise ValueError(f"TIFF JPEG strip of {px.shape[2]} components for {img.spp} "
                             "samples")
        h, w = min(img.ch, img.height - y), min(img.cw, img.width - x)
        if px.shape[0] < h or px.shape[1] < w:
            raise ValueError("TIFF JPEG strip or tile smaller than its place")
        out[y: y + h, x: x + w] = px[:h, :w]
    return out


# --- PIL's modes to RGBA ----------------------------------------------------------------


def _high_bytes(s: np.ndarray) -> np.ndarray:
    return (s >> 8).astype(np.uint8) if s.dtype == np.uint16 else s


def _swapped(s: np.ndarray, img: Image) -> np.ndarray:
    """PIL's reading of a compressed big-endian file's signed or float
    samples: libtiff gives them in the host's order, and the rawmode
    ("I;16BS", "I;32BS", "F;32BF") swaps their bytes once more."""
    if img.compression != NONE and img.order == _MM:
        return s.byteswap()
    return s


def _palette(img: Image) -> np.ndarray:
    cmap = _ints(img.tags, COLORMAP)
    n = 1 << img.bits
    if cmap is None or len(cmap) != 3 * n:
        raise ValueError(f"palette TIFF without a ColorMap of {3 * n} entries")
    return (np.asarray(cmap, np.int64).reshape(3, n).T // 256).astype(np.uint8)


def to_rgba(s: np.ndarray, img: Image) -> np.ndarray:
    """(H, W, spp) samples in img.mode to (H, W, 4) uint8 as PIL unpacks
    them and converts the mode to RGBA."""
    mode = img.mode
    if mode == "RGBA" and s.dtype == np.uint8 and s.shape[2] == 4:
        return s
    out = np.empty(s.shape[:2] + (4,), np.uint8)
    out[..., 3] = 255
    v = s[..., 0]
    if mode in ("1", "1;I", "L;2", "L;2I", "L;4", "L;4I", "L", "L;I", "LA"):
        grey = v.astype(np.uint8) * np.uint8(255 // ((1 << img.bits) - 1))
        if mode.endswith("I"):
            grey = 255 - grey
        out[..., :3] = grey[..., None]
        if mode == "LA":
            out[..., 3] = s[..., 1]
    elif mode == "I;16":
        out[..., :3] = np.minimum(v, 255).astype(np.uint8)[..., None]
    elif mode in ("I;16S", "I;32S", "I;32N"):
        signed = _swapped(v, img) if mode != "I;32N" else v
        ints = signed.view(np.int16 if img.bits == 16 else np.int32)
        out[..., :3] = np.clip(ints, 0, 255).astype(np.uint8)[..., None]
    elif mode == "F":
        f = _swapped(v, img).view(np.float32)
        with np.errstate(invalid="ignore"):
            grey = np.where(f >= 255, 255, np.where(f > 0, f, 0))
        out[..., :3] = grey.astype(np.uint8)[..., None]
    elif mode in ("P", "PA"):
        out[..., :3] = _palette(img)[v]
        if mode == "PA":
            out[..., 3] = s[..., 1]
    elif mode.startswith("RGB"):
        c = _high_bytes(s)
        out[..., :3] = c[..., :3]
        if mode in ("RGBA", "RGBa"):
            out[..., 3] = c[..., 3]
        if mode == "RGBa":
            a = c[..., 3:4].astype(np.int32)
            rgb = np.minimum(c[..., :3].astype(np.int32) * 255 // np.maximum(a, 1), 255)
            rgb = np.where(a == 255, c[..., :3], np.where(a == 0, 0, rgb))
            out[..., :3] = rgb
    elif mode == "CMYK":
        out[:] = jpeg.cmyk_to_rgba(255 - _high_bytes(s)[..., :4])
    else:
        raise _unsupported(f"a TIFF of PIL mode {mode}")
    return out


# PIL's ImageOps.exif_transpose by Orientation value
def _orient(rgba: np.ndarray, orientation: int) -> np.ndarray:
    if orientation == 2:
        return rgba[:, ::-1]
    if orientation == 3:
        return rgba[::-1, ::-1]
    if orientation == 4:
        return rgba[::-1]
    if orientation == 5:
        return rgba.transpose(1, 0, 2)
    if orientation == 6:
        return rgba[::-1].transpose(1, 0, 2)
    if orientation == 7:
        return rgba[::-1, ::-1].transpose(1, 0, 2)
    if orientation == 8:
        return rgba[:, ::-1].transpose(1, 0, 2)
    return rgba


def decode_tiff(data: bytes, plain: bool = False) -> np.ndarray:
    """A TIFF or BigTIFF byte string's first image to (H, W, 4) uint8 RGBA,
    as PIL's `Image.open(...).convert("RGBA")`. plain=True runs the plain
    twins of the C++ stages (the tests' reference)."""
    order, big, tags = read_ifd(data)
    img = Image(order, tags, data, big)
    if img.compression == JPEG:
        s = _jpeg_samples(data, img, plain)
    else:
        s = _samples(data, img, plain)
    rgba = to_rgba(s, img)
    orientation = _ints(tags, ORIENTATION, (1,))[0]
    return np.ascontiguousarray(_orient(rgba, orientation))
