"""One place that decodes image files: a file's leading bytes pick the
port's decoder, and every decoder returns (H, W, 4) uint8 RGBA equal to
PIL 12.1.0's `Image.open(path).convert("RGBA")` (figdraw_tpu's decode in
resources.load_image and utils/flippy.py; the port may not import PIL).

Decoded: PNG (utils/png.py), JPEG (utils/jpeg.py), GIF's first frame
(utils/gif.py), BMP (utils/bmp.py), ICO (utils/ico.py), QOI
(utils/qoi.py), TIFF and BigTIFF's first image (utils/tiff.py, CCITT fax
and ZSTD through utils/fax.py and utils/zstd.py), WebP's first frame,
lossy, lossless or animated (utils/webp.py) and AVIF still images and
the first frame of AVIF image sequences, of AV1 profiles 0-2 at 8, 10 and
12 bits, 4:2:0, 4:2:2, 4:4:4 or 4:0:0, with an optional alpha item or
track, straight or premultiplied (utils/avif.py, utils/av1.py); their
sequential loops run in C++ (csrc/png_unfilter.cpp, csrc/image_decode.cpp,
csrc/zstd_decode.cpp, csrc/webp_decode.cpp, csrc/av1_decode.cpp, built
with g++ at first use; a missing toolchain
raises). PIL's other readers raise NotImplementedError naming the format,
the path and the ROADMAP item, as does a TIFF compression or photometric
not ported, a WebP inter frame, a VP8L version other than 0, an ALPH
compression other than none and lossless, or an AV1 or HEIF feature
outside the slice (utils/avif.py); bytes of no image format raise
ValueError.
"""

from __future__ import annotations

import numpy as np

from . import av1, avif, bmp, gif, ico, jpeg, png, qoi, tiff, webp

NOT_PORTED = ("{} images are not decoded by figdraw_tpu_torch ({}): not ported yet "
              "(ROADMAP.md, module item 'Image formats other than PNG')")

# leading bytes -> (format, decoder); a RIFF file is WebP only with the
# WEBP form type at byte 8, so AVI and WAV files do not reach it, and an
# ISO-BMFF file is AVIF when its ftyp box names an AVIF brand (is_avif)
DECODERS = (
    (png.SIGNATURE, "PNG", png.decode_png),
    (b"\xff\xd8\xff", "JPEG", jpeg.decode_jpeg),
    (b"GIF87a", "GIF", gif.decode_gif),
    (b"GIF89a", "GIF", gif.decode_gif),
    (b"BM", "BMP", bmp.decode_bmp),
    (b"\x00\x00\x01\x00", "ICO", ico.decode_ico),
    (qoi.MAGIC, "QOI", qoi.decode_qoi),
    (b"II*\x00", "TIFF", tiff.decode_tiff),
    (b"MM\x00*", "TIFF", tiff.decode_tiff),
    (b"II+\x00", "BigTIFF", tiff.decode_tiff),
    (b"MM\x00+", "BigTIFF", tiff.decode_tiff),
    (b"RIFF", "WebP", webp.decode_webp),
    (b"", "AVIF", avif.decode_avif),
)

AVIF_BRANDS = (b"avif", b"avis")
AVIF_MAJOR_BRANDS = (b"avif", b"avis", b"mif1", b"msf1")


def _matches(data: bytes, magic: bytes, name: str) -> bool:
    if name == "AVIF":
        return is_avif(data)
    return data.startswith(magic) and (name != "WebP" or data[8:12] == b"WEBP")


def is_avif(data: bytes) -> bool:
    """An ISO-BMFF file that PIL's AvifImagePlugin opens: a major brand it
    accepts (avif, avis, mif1 or msf1) and an AVIF brand, major or
    compatible, which libavif requires."""
    if len(data) < 16 or data[4:8] != b"ftyp" or data[8:12] not in AVIF_MAJOR_BRANDS:
        return False
    size = int.from_bytes(data[:4], "big")
    end = min(len(data), size if size >= 16 else 16)
    brands = [data[8:12]] + [data[i: i + 4] for i in range(16, end - 3, 4)]
    return any(b in AVIF_BRANDS for b in brands)

# leading bytes of the formats PIL reads that the port does not decode
OTHER_FORMATS = (
    (b"8BPS", "PSD"), (b"DDS ", "DDS"), (b"icns", "ICNS"),
    (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"), (b"\xff\x4f\xff\x51", "JPEG 2000"),
    (b"\x01\xda", "SGI"), (b"BLP1", "BLP"), (b"BLP2", "BLP"), (b"#define", "XBM"),
    (b"/* XPM */", "XPM"), (b"SIMPLE", "FITS"), (b"%!PS", "EPS"),
    (b"\xc5\xd0\xd3\xc6", "EPS"), (b"\x00\x00\x02\x00", "CUR or TGA"),
    (b"\xb1\x68\xde\x3a", "DCX"),
    (b"gimp xcf", "XCF"), (b"\x59\xa6\x6a\x95", "Sun raster"), (b"Image type", "IM"),
)


def format_of(data: bytes) -> str:
    """The format a byte string's leading bytes name, or "" for none."""
    for magic, name, _fn in DECODERS:
        if _matches(data, magic, name):
            return name
    for magic, name in OTHER_FORMATS:
        if data.startswith(magic):
            return name
    if len(data) > 2 and data[:1] == b"P" and data[1:2] in b"1234567" and data[2:3].isspace():
        return "PPM"
    if len(data) > 1 and data[0] == 10 and data[1] in (0, 2, 3, 5):
        return "PCX"
    return ""


def _decode(fn, data: bytes, where: str) -> np.ndarray:
    try:
        return fn(data)
    except av1.Refused as exc:  # an AV1 or HEIF feature outside the AVIF slice
        raise NotImplementedError(av1.NOT_PORTED.format(exc.feature, where)) from None
    except NotImplementedError as exc:  # a JPEG process, TIFF layout or WebP part not ported
        raise NotImplementedError(f"{exc} [{where}]") from None


def decode_image(data: bytes, where: str = "bytes") -> np.ndarray:
    """An image file's bytes to (H, W, 4) uint8 RGBA. `where` names the
    source in the errors (read_image passes the path)."""
    for magic, name, fn in DECODERS:
        if _matches(data, magic, name):
            return _decode(fn, data, where)
    name = format_of(data)
    if name:
        raise NotImplementedError(NOT_PORTED.format(name, where))
    raise ValueError(f"{where} is not an image file figdraw_tpu_torch reads "
                     "(PNG, JPEG, GIF, BMP, ICO, QOI, TIFF, WebP or AVIF)")


def read_image(path: str) -> np.ndarray:
    """The image file at `path` as (H, W, 4) uint8 RGBA."""
    with open(path, "rb") as fh:
        data = fh.read()
    return decode_image(data, path)
