"""One place that decodes image files: a file's leading bytes pick the
port's decoder, and every decoder returns (H, W, 4) uint8 RGBA equal to
PIL 12.1.0's `Image.open(path).convert("RGBA")` (figdraw_tpu's decode in
resources.load_image and utils/flippy.py; the port may not import PIL).

Decoded: PNG (utils/png.py), JPEG (utils/jpeg.py), GIF's first frame
(utils/gif.py), BMP (utils/bmp.py), ICO (utils/ico.py), QOI
(utils/qoi.py), TIFF and BigTIFF's first image (utils/tiff.py, CCITT fax
and ZSTD through utils/fax.py and utils/zstd.py) and WebP's first frame,
lossy, lossless or animated (utils/webp.py); their sequential loops run
in C++ (csrc/png_unfilter.cpp, csrc/image_decode.cpp, csrc/zstd_decode.cpp,
csrc/webp_decode.cpp, built with g++ at first use; a missing toolchain
raises). AVIF and PIL's other readers raise NotImplementedError naming the
format, the path and the ROADMAP item, as does a TIFF compression or
photometric not ported, a WebP inter frame, a VP8L version other than 0
or an ALPH compression other than none and lossless; bytes of no image
format raise ValueError.
"""

from __future__ import annotations

import numpy as np

from . import bmp, gif, ico, jpeg, png, qoi, tiff, webp

NOT_PORTED = ("{} images are not decoded by figdraw_tpu_torch ({}): not ported yet "
              "(ROADMAP.md, module item 'Image formats other than PNG')")

# leading bytes -> (format, decoder); a RIFF file is WebP only with the
# WEBP form type at byte 8 (is_webp), so AVI and WAV files do not reach it
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
)

AVIF_BRANDS = (b"avif", b"avis")


def _matches(data: bytes, magic: bytes, name: str) -> bool:
    return data.startswith(magic) and (name != "WebP" or data[8:12] == b"WEBP")


def is_avif(data: bytes) -> bool:
    """An ISO-BMFF file whose `ftyp` box names an AVIF brand, major or
    compatible (what PIL's AvifImagePlugin accepts)."""
    if len(data) < 16 or data[4:8] != b"ftyp":
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
    if is_avif(data):
        return "AVIF"
    if len(data) > 2 and data[:1] == b"P" and data[1:2] in b"1234567" and data[2:3].isspace():
        return "PPM"
    if len(data) > 1 and data[0] == 10 and data[1] in (0, 2, 3, 5):
        return "PCX"
    return ""


def decode_image(data: bytes, where: str = "bytes") -> np.ndarray:
    """An image file's bytes to (H, W, 4) uint8 RGBA. `where` names the
    source in the errors (read_image passes the path)."""
    for magic, name, fn in DECODERS:
        if _matches(data, magic, name):
            try:
                return fn(data)
            except NotImplementedError as exc:  # a JPEG process, TIFF layout or WebP part not ported
                raise NotImplementedError(f"{exc} [{where}]") from None
    name = format_of(data)
    if name:
        raise NotImplementedError(NOT_PORTED.format(name, where))
    raise ValueError(f"{where} is not an image file figdraw_tpu_torch reads "
                     "(PNG, JPEG, GIF, BMP, ICO, QOI, TIFF or WebP)")


def read_image(path: str) -> np.ndarray:
    """The image file at `path` as (H, W, 4) uint8 RGBA."""
    with open(path, "rb") as fh:
        data = fh.read()
    return decode_image(data, path)
