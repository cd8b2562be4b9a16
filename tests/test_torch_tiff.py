"""The port's TIFF reader (figdraw_tpu_torch/utils/tiff.py, its C++ stages in
csrc/image_decode.cpp) against PIL 12.1.0's `Image.open(...).convert("RGBA")`,
which reads uncompressed files with its own unpackers and compressed ones
through libtiff 4.7.1, as figdraw_tpu does: equal byte for byte on the
stored files (tools/make_image_formats.py) and on files built here, by PIL
or by the tool's writer where PIL writes no such file (tiles, planar,
big-endian, FillOrder 2, subsampled JPEG-in-TIFF): both byte orders,
classic and BigTIFF, strips (RowsPerStrip that does not divide the height,
or missing) and tiles, every compression ported with and without the
predictors, every pixel key ported, the Orientation tag. Each C++ stage
against its plain twin (PackBits, LZW across its width switches and a
ClearCode, both predictors at every sample width and byte order); PIL's
quirks (F, I;16, RGBa, the 16-bit ColorMap, byte-swapped compressed
big-endian samples); what is not ported raising NotImplementedError with
the ROADMAP title; load_image of the TIFF fixture against figdraw_tpu's
(image, mips, sidecar) and its frames against figdraw_tpu's block means.

PIL 12.1.0 cannot open a big-endian BigTIFF (its IFD reader takes byte 2
of the header, 0 there, for the version): the port reads one, checked
against its little-endian twin."""

import hashlib
import io
import json
import os
import shutil
import struct
import sys
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from figdraw_tpu_torch.scenes import (
    IMAGE_FIXTURE, IMAGE_FORMATS_DIR, IMAGE_FORMATS_REFERENCE, TIFF_FIXTURE,
)
from figdraw_tpu_torch.utils import image_lib, imagefile, tiff
from torch_reference import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
from make_image_formats import jpeg_parts, lzw as lzw_encode, packbits as packbits_encode  # noqa: E402
from make_image_formats import tiff_bytes  # noqa: E402

torch.set_num_threads(1)

ROADMAP_ITEM = "Image formats other than PNG"
STORED = sorted(n for n in os.listdir(IMAGE_FORMATS_DIR) if n.endswith(".tif"))
ORDERS = ["<", ">"]
# (compression, predictor): none, PackBits, LZW, Adobe Deflate, old Deflate, LZMA
CODECS = [(1, 1), (32773, 1), (5, 1), (5, 2), (8, 2), (32946, 1), (34925, 2)]
LAYOUTS = {"one strip": {}, "uneven strips": {"rows_per_strip": 5},
           "tiles": {"tile": (16, 32)}}


def _crop(w=61, h=47) -> np.ndarray:
    """RGBA from the fixture with seeded noise, so every code path sees detail."""
    base = np.asarray(Image.open(IMAGE_FIXTURE).convert("RGBA"))[200: 200 + h, 300: 300 + w]
    rng = np.random.default_rng(w * 100 + h)
    noisy = base.astype(int) + rng.integers(-20, 21, base.shape)
    return np.clip(noisy, 0, 255).astype(np.uint8)


def _pil(data: bytes) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _same(data: bytes, plain: bool = True) -> np.ndarray:
    """The port's decode (and its plain twins') equals PIL's."""
    want = _pil(data)
    got = imagefile.decode_image(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if plain:
        np.testing.assert_array_equal(tiff.decode_tiff(data, plain=True), want)
    return got


def _pil_save(img, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, "TIFF", **kw)
    return b.getvalue()


# --- the stored files ------------------------------------------------------------


@pytest.mark.parametrize("name", STORED)
def test_stored_tiffs_equal_pil_and_their_digests(name):
    with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
        data = fh.read()
    with open(IMAGE_FORMATS_REFERENCE) as fh:
        ref = json.load(fh)["files"][name]
    assert hashlib.sha256(data).hexdigest() == ref["sha256"]
    got = imagefile.read_image(os.path.join(IMAGE_FORMATS_DIR, name))
    assert hashlib.sha256(got.tobytes()).hexdigest() == ref["decoded_sha256"]
    assert list(got.shape) == ref["shape"]
    _same(data)


def test_the_stored_set_covers_the_layouts():
    """The stored files hold each layout the card is held to: LZW, PackBits,
    Deflate and LZMA with both predictors, JPEG (RGB, YCbCr 1x1 and 2x2),
    tiles, planar, big-endian, FillOrder 2, uneven strips, BigTIFF."""
    seen = set()
    for name in STORED:
        with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
            data = fh.read()
        order, big, tags = tiff.read_ifd(data)
        img = tiff.Image(order, tags)
        seen |= {("compression", img.compression), ("predictor", img.predictor),
                 ("order", order), ("big", big), ("tiled", img.tiled),
                 ("planar", img.planar), ("fill", img.fill),
                 ("photometric", img.photometric)}
        if img.compression == tiff.JPEG and img.photometric == 6:
            seen.add(("subsampling", tags.get(tiff.YCBCR_SUBSAMPLING)))
        if not img.tiled and img.height % img.ch:
            seen.add(("uneven strips", True))
    for want in [("compression", c) for c in tiff.COMPRESSIONS] + [
            ("predictor", 2), ("predictor", 3), ("order", ">"), ("big", True),
            ("tiled", True), ("planar", 2), ("fill", 2), ("subsampling", (1, 1)),
            ("subsampling", (2, 2)), ("uneven strips", True), ("photometric", 0),
            ("photometric", 3), ("photometric", 5)]:
        assert want in seen, want


# --- compressions, layouts and byte orders -------------------------------------------


@pytest.mark.parametrize("codec", CODECS, ids=lambda c: f"c{c[0]}p{c[1]}")
@pytest.mark.parametrize("order", ORDERS, ids=["II", "MM"])
def test_codecs_and_layouts_equal_pil(order, codec):
    """RGB, RGBA, grey and 16-bit RGB through each codec in one strip,
    strips that do not divide the height, and tiles with edge padding."""
    comp, pred = codec
    px = _crop()
    s16 = px.astype(np.uint16) * 257 + np.arange(px.shape[1], dtype=np.uint16)[:, None]
    for layout in LAYOUTS.values():
        kw = dict(order=order, compression=comp, predictor=pred, **layout)
        _same(tiff_bytes(px[..., :3], 2, **kw))
        _same(tiff_bytes(px, 2, extra=(2,), **kw))
        _same(tiff_bytes(px[..., 1], 1, **kw))
        _same(tiff_bytes(s16[..., :3], 2, **kw))


@pytest.mark.parametrize("codec", CODECS, ids=lambda c: f"c{c[0]}p{c[1]}")
@pytest.mark.parametrize("extra", [(), (1,), (2,)], ids=["none", "assoc", "unassoc"])
def test_planar_files_equal_pil(extra, codec):
    """PlanarConfiguration 2 in strips and tiles: RGB, and RGBA whose alpha
    is unassociated, associated or unnamed (un-premultiplied by libtiff's
    reader, as PIL's Pillow decoder does). PIL's own reader has no unpacker
    for an associated alpha plane and misplaces edge tiles of an unnamed
    one: the port raises there."""
    comp, pred = codec
    px = _crop()
    for layout in ({"rows_per_strip": 7}, {"tile": (32, 16)}):
        kw = dict(compression=comp, predictor=pred, planar=2, **layout)
        _same(tiff_bytes(px[..., :3], 2, **kw))
        data = tiff_bytes(px, 2, extra=extra, **kw)
        if comp == 1 and extra != (2,):
            with pytest.raises(NotImplementedError, match=ROADMAP_ITEM):
                tiff.decode_tiff(data)
        else:
            _same(data)


@pytest.mark.parametrize("big", [False, True], ids=["classic", "bigtiff"])
def test_pil_written_files_equal_pil(big):
    src = Image.fromarray(_crop())
    for comp in (None, "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "packbits", "lzma",
                 "jpeg"):
        kw = {"compression": comp} if comp else {}
        for img in (src, src.convert("RGB"), src.convert("L"), src.convert("LA"),
                    src.convert("P")):
            if comp == "jpeg" and img.mode in ("RGBA", "LA", "P"):
                continue  # libtiff writes no JPEG of these
            data = _pil_save(img, big_tiff=big, **kw)
            # PIL writes BigTIFF only uncompressed (libtiff's writer ignores it)
            assert data[2] == (43 if big and comp is None else 42)
            _same(data)


def test_big_endian_bigtiff_equals_its_little_endian_twin():
    """PIL 12.1.0 reads no MM BigTIFF ("cannot identify image file"): the
    port reads it as its II twin."""
    px = _crop()
    for kw in ({"compression": 5, "predictor": 2, "tile": (16, 16)},
               {"compression": 1, "rows_per_strip": 9}):
        mm = tiff_bytes(px, 2, order=">", big=True, extra=(2,), **kw)
        ii = tiff_bytes(px, 2, order="<", big=True, extra=(2,), **kw)
        with pytest.raises(Exception):
            _pil(mm)
        np.testing.assert_array_equal(imagefile.decode_image(mm), _same(ii))


def test_missing_rows_per_strip_and_byte_counts():
    """No RowsPerStrip: one strip; no StripByteCounts in an uncompressed
    file: PIL reads on from each offset, and so does the port."""
    px = _crop()
    data = tiff_bytes(px[..., :3], 2, strip_counts=False)
    order, _big, tags = tiff.read_ifd(data)
    assert tiff.ROWS_PER_STRIP not in tags and tiff.STRIP_COUNTS not in tags
    _same(data)
    with pytest.raises(ValueError, match="StripByteCounts"):
        tiff.decode_tiff(tiff_bytes(px[..., :3], 2, compression=5, strip_counts=False))


# --- pixel kinds ------------------------------------------------------------------


def _kinds(px: np.ndarray) -> dict:
    """name -> tiff_bytes keywords of each pixel key ported."""
    rng = np.random.default_rng(7)
    g = px[..., 1]
    s16 = px.astype(np.uint16) * 257 + rng.integers(0, 257, px.shape).astype(np.uint16)
    kinds = {}
    for photo in (0, 1):
        for bits in (1, 2, 4, 8):
            kinds[f"grey{bits} photometric {photo}"] = dict(
                samples=(g >> (8 - bits)).astype(np.uint8), photometric=photo, bits=bits)
    kinds["signed grey8"] = dict(samples=g.view(np.int8), photometric=1)
    kinds["LA"] = dict(samples=px[..., [1, 3]], photometric=1, extra=(2,))
    kinds["I;16 photometric 0"] = dict(samples=s16[..., 0] // 40, photometric=0)
    kinds["I;16"] = dict(samples=s16[..., 0] // 40, photometric=1)
    kinds["I;16S"] = dict(samples=((s16[..., 0].astype(np.int32) - 30000) // 60)
                          .astype(np.int16), photometric=1)
    u32 = s16[..., 0].astype(np.uint32) * 70001
    u32[0, :3] = (5, 300, 2 ** 31 + 5)
    kinds["I;32N"] = dict(samples=u32, photometric=1)
    kinds["I;32S"] = dict(samples=u32.view(np.int32), photometric=1)
    f = px[..., 0].astype(np.float32) * 1.3 - 40.25
    f[0, :6] = (np.nan, np.inf, -np.inf, 254.99, 0.9999, 1.0)
    kinds["F photometric 0"] = dict(samples=f, photometric=0)
    kinds["F"] = dict(samples=f, photometric=1)
    for bits in (1, 2, 4, 8):
        cmap = rng.integers(0, 65536, (1 << bits, 3))
        kinds[f"P{bits}"] = dict(samples=(g >> (8 - bits)).astype(np.uint8), photometric=3,
                                 bits=bits, colormap=cmap)
    cmap = rng.integers(0, 65536, (256, 3))
    kinds["PA"] = dict(samples=px[..., [1, 3]], photometric=3, extra=(2,), colormap=cmap)
    kinds["PX"] = dict(samples=px[..., [1, 3]], photometric=3, extra=(0,), colormap=cmap)
    for extra in ((), (0,), (1,), (2,), (999,)):
        kinds[f"RGBA extra {extra}"] = dict(samples=px, photometric=2, extra=extra)
    for extra in ((0, 0), (1, 0), (2, 0)):
        kinds[f"RGBA extra {extra}"] = dict(
            samples=np.concatenate([px, px[..., :1]], -1), photometric=2, extra=extra)
    for extra in ((0, 0, 0), (1, 0, 0), (2, 0, 0)):
        kinds[f"RGBA extra {extra}"] = dict(
            samples=np.concatenate([px, px[..., :2]], -1), photometric=2, extra=extra)
    kinds["RGB16"] = dict(samples=s16[..., :3], photometric=2)
    for extra in ((), (0,), (1,), (2,)):
        kinds[f"RGBA16 extra {extra}"] = dict(samples=s16, photometric=2, extra=extra)
    kinds["CMYK"] = dict(samples=px, photometric=5)
    kinds["CMYKX"] = dict(samples=np.concatenate([px, px[..., :1]], -1), photometric=5,
                          extra=(0,))
    kinds["CMYKXX"] = dict(samples=np.concatenate([px, px[..., :2]], -1), photometric=5,
                           extra=(0, 0))
    kinds["CMYK16"] = dict(samples=s16, photometric=5)
    return kinds


KINDS = list(_kinds(np.zeros((8, 8, 4), np.uint8)))


# keys PIL's OPEN_INFO has for little-endian files only
LITTLE_ENDIAN_ONLY = ("I;16 photometric 0", "I;32N")


@pytest.mark.parametrize("kind", KINDS)
def test_pixel_kinds_equal_pil(kind):
    """Each pixel key through PIL's own unpackers (uncompressed) and
    libtiff (PackBits, LZW with Predictor 2 where its samples allow, LZMA),
    both byte orders, strips and tiles. A key PIL has only for II files
    fails to open in PIL as MM, and raises in the port."""
    spec = _kinds(_crop())[kind]
    samples = spec.pop("samples")
    bits = spec.get("bits", 8 * samples.dtype.itemsize)
    codecs = [(1, 1), (32773, 1), (5, 2 if bits >= 8 else 1), (34925, 1)]
    if samples.dtype.kind == "f":
        codecs.append((8, 3))
    for order in ORDERS:
        for comp, pred in codecs:
            for layout in ({"rows_per_strip": 5}, {"tile": (16, 16)}):
                data = tiff_bytes(samples, order=order, compression=comp, predictor=pred,
                                  **layout, **spec)
                if order == ">" and kind in LITTLE_ENDIAN_ONLY:
                    with pytest.raises(Exception):
                        _pil(data)
                    with pytest.raises(NotImplementedError, match="pixel key"):
                        tiff.decode_tiff(data)
                else:
                    _same(data)


@pytest.mark.parametrize("kind", ["grey1 photometric 0", "grey1 photometric 1",
                                  "grey2 photometric 0", "grey4 photometric 1",
                                  "grey8 photometric 1", "P8", "RGB"])
@pytest.mark.parametrize("comp", [1, 5, 8])
def test_fill_order_2_equals_pil(kind, comp):
    """FillOrder 2: the bits of every stored byte reversed (before
    decompression in libtiff; PIL's ";R" rawmodes when uncompressed)."""
    kinds = _kinds(_crop())
    spec = kinds["RGBA extra ()"] if kind == "RGB" else kinds[kind]
    samples = spec.pop("samples")
    if kind == "RGB":
        samples, spec = samples[..., :3], {"photometric": 2}
    for order in ORDERS:
        if kind == "RGB" or order == "<" or comp != 1:
            _same(tiff_bytes(samples, order=order, compression=comp, fill_order=2,
                             rows_per_strip=10, **spec))


@pytest.mark.parametrize("kind", ["grey8 photometric 0", "P1", "P2", "P4"])
def test_fill_order_2_without_a_pil_unpacker_raises(kind):
    """Uncompressed, PIL has no unpacker for these keys' reversed bits
    ("L;IR", "P;1R", "P;2R", "P;4R"): PIL raises, the port too."""
    spec = _kinds(_crop())[kind]
    data = tiff_bytes(spec.pop("samples"), compression=1, fill_order=2, **spec)
    with pytest.raises(ValueError, match="unknown raw mode"):
        _pil(data)
    with pytest.raises(NotImplementedError, match=ROADMAP_ITEM):
        tiff.decode_tiff(data)


def test_float_truncates_and_clips():
    """Mode F to RGBA: truncated toward zero and clipped; NaN and -inf 0."""
    f = np.array([[0.9999, 1.0, 254.6, 300.0, np.nan, -3.5, 255.9, np.inf, -np.inf]],
                 np.float32)
    for comp, pred in ((1, 1), (8, 3), (5, 1)):
        got = _same(tiff_bytes(f, 1, compression=comp, predictor=pred))
        assert got[0, :, 0].tolist() == [0, 1, 254, 255, 0, 0, 255, 255, 0]


def test_sixteen_bit_grey_clips_at_255():
    v = np.array([[0, 1, 255, 256, 1000, 65535]], np.uint16)
    for order in ORDERS:
        got = _same(tiff_bytes(v, 1, order=order, compression=5))
        assert got[0, :, 0].tolist() == [0, 1, 255, 255, 255, 255]


def test_associated_alpha_is_unpremultiplied_as_pil():
    """RGBa: each colour * 255 // alpha (truncating), clipped; alpha 0
    gives black, alpha 255 the colour as stored."""
    px = np.array([[[10, 20, 30, 0], [10, 20, 30, 255], [10, 20, 200, 40],
                    [127, 128, 129, 128], [255, 255, 255, 1]]], np.uint8)
    for comp in (1, 5):
        got = _same(tiff_bytes(px, 2, compression=comp, extra=(1,)))
        assert got[0].tolist() == [[0, 0, 0, 0], [10, 20, 30, 255], [63, 127, 255, 40],
                                   [253, 255, 255, 128], [255, 255, 255, 1]]


def test_sixteen_bit_colormap_reduces_to_its_high_bytes():
    cmap = np.array([[0, 255, 256], [65535, 32767, 32768], [513, 1, 65280], [9, 9, 9]])
    idx = np.array([[0, 1, 2, 3]], np.uint8)
    got = _same(tiff_bytes(idx, 3, bits=2, compression=1, colormap=cmap))
    assert got[0, :, :3].tolist() == [[0, 0, 1], [255, 127, 128], [2, 0, 255], [0, 0, 0]]


@pytest.mark.parametrize("kind", ["I;16S", "I;32S", "F"])
def test_compressed_big_endian_signed_and_float_samples_read_swapped(kind):
    """libtiff hands PIL host-order samples and PIL's big-endian rawmode
    ("I;16BS", "I;32BS", "F;32BF") swaps them again: a compressed MM file
    of these keys reads byte-swapped, an uncompressed one right."""
    spec = _kinds(_crop())[kind]
    samples = spec.pop("samples")
    right = _same(tiff_bytes(samples, order=">", compression=1, **spec))
    swapped = _same(tiff_bytes(samples, order=">", compression=5, **spec))
    np.testing.assert_array_equal(right, _same(tiff_bytes(samples, order="<", compression=5,
                                                          **spec)))
    assert not np.array_equal(right, swapped)


@pytest.mark.parametrize("orientation", range(1, 10))
def test_orientation_is_applied_as_pil_applies_it(orientation):
    """PIL's TIFF reader transposes by the Orientation tag on load
    (ImageOps.exif_transpose); 9 is no orientation."""
    px = _crop()[..., :3]
    for comp in (1, 5):
        got = _same(tiff_bytes(px, 2, compression=comp, tags={274: (3, (orientation,))}))
        assert got.shape[:2] == (px.shape[:2][::-1] if orientation in (5, 6, 7, 8)
                                 else px.shape[:2])


# --- JPEG-in-TIFF ----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["RGB", "YCbCr", "L", "CMYK"])
@pytest.mark.parametrize("rows", [None, 8, 16])
def test_pil_written_jpeg_in_tiff_equals_pil(mode, rows):
    """PIL's JPEG-in-TIFF: photometric RGB (no colour transform), YCbCr at
    1x1 (libjpeg's YCbCr -> RGB), grey and CMYK, in one strip or many."""
    img = Image.fromarray(_crop(67, 45)).convert(mode)
    for q in (40, 90):
        kw = {"tiffinfo": {278: rows}} if rows else {}
        _same(_pil_save(img, compression="jpeg", quality=q, **kw))


def _jpeg_chunk(subsampling: str, quality: int = 85):
    def encode(block):
        b = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(block)).save(b, "JPEG", quality=quality,
                                                          subsampling=subsampling)
        return jpeg_parts(b.getvalue())
    return encode


@pytest.mark.parametrize("sub,factors", [("4:2:0", (2, 2)), ("4:2:2", (2, 1)),
                                         ("4:4:4", (1, 1))])
def test_subsampled_jpeg_in_tiff_equals_pil(sub, factors):
    """Strips and tiles whose streams PIL encodes at 4:2:0, 4:2:2 and 4:4:4,
    tagged YCbCr with YCbCrSubsampling: libjpeg upsamples (fancy) and
    converts each strip or tile on its own."""
    px = _crop(75, 53)[..., :3]
    for layout in ({"rows_per_strip": 16}, {"rows_per_strip": 32}, {"tile": (32, 16)}, {}):
        _same(tiff_bytes(px, 6, compression=7, jpeg_chunk=_jpeg_chunk(sub),
                         tags={530: (3, factors)}, **layout))


def test_jpeg_sampling_other_than_the_tags_raises():
    """libtiff refuses a strip whose first component's sampling factors are
    not YCbCrSubsampling's (or 1, 1 for photometric RGB): PIL raises a
    decoder error, the port ValueError."""
    px = _crop()[..., :3]
    for photo, tags in ((2, {}), (6, {530: (3, (1, 1))})):
        data = tiff_bytes(px, photo, compression=7, jpeg_chunk=_jpeg_chunk("4:2:0"),
                          rows_per_strip=16, tags=tags)
        with pytest.raises(OSError):
            _pil(data)
        with pytest.raises(ValueError, match="sampling factors"):
            tiff.decode_tiff(data)


# --- the IFD ---------------------------------------------------------------------


@pytest.mark.parametrize("big", [False, True], ids=["classic", "bigtiff"])
@pytest.mark.parametrize("order", ORDERS, ids=["II", "MM"])
def test_every_field_type_reads_as_pil_reads_it(order, big):
    """Private tags of every field type, inline and spilled: the values
    read_ifd gives against PIL's tag_v2 (BYTE and UNDEFINED as bytes,
    ASCII as bytes to its NUL, rationals as num / den)."""
    extra = {
        65000: (1, bytes([1, 2, 250])), 65001: (2, b"figdraw\x00"), 65002: (3, (7, 65535)),
        65003: (4, (1, 2 ** 32 - 1, 3)), 65004: (5, ((1, 3), (10, 4))),
        65005: (6, (-5, 7)), 65006: (7, b"\x00\x01\x02\x03\x04\x05\x06\x07\x08"),
        65007: (8, (-300, 300)), 65008: (9, (-70000,)), 65009: (10, ((-1, 3), (7, -2))),
        65010: (11, (1.5, -2.25)), 65011: (12, (3.125,)), 65012: (3, (9,)),
        65013: (4, tuple(range(40))), 65014: (2, b"ab\x00")}
    if big:
        extra[65015] = (16, (2 ** 40 + 1, 3))
    px = _crop()[..., :3]
    data = tiff_bytes(px, 2, order=order, big=big, compression=5, tags=extra)
    got_order, got_big, tags = tiff.read_ifd(data)
    assert (got_order, got_big) == (order, big)
    if order == ">" and big:  # PIL opens no MM BigTIFF: held to the II twin
        twin = tiff_bytes(px, 2, order="<", big=True, compression=5, tags=extra)
        assert tags == tiff.read_ifd(twin)[2]
        np.testing.assert_array_equal(tiff.decode_tiff(data), _same(twin))
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pil_tags = Image.open(io.BytesIO(data)).tag_v2
    for tag, (ftype, values) in extra.items():
        want = pil_tags[tag]
        got = tags[tag]
        if ftype == 2:
            assert got.split(b"\x00")[0].decode() == want, tag
        elif ftype in (1, 7):
            assert got == want, tag
        else:
            want = want if isinstance(want, tuple) else (want,)
            assert len(got) == len(want), tag
            for a, b in zip(got, want):
                assert a == pytest.approx(float(b)), tag
    _same(data)


def test_signed_eight_byte_fields_read():
    """SLONG8 (17), which PIL 12.1.0 skips as an unknown type."""
    data = tiff_bytes(_crop()[..., :3], 2, big=True, tags={65016: (17, (-(2 ** 40), 5))})
    assert tiff.read_ifd(data)[2][65016] == (-(2 ** 40), 5)
    _same(data)


def test_malformed_files_raise_value_error():
    """A header cut short, an IFD offset past the end, strips cut short (PIL
    writes the IFD before the data uncompressed, libtiff after it)."""
    img = Image.fromarray(_crop())
    raw, packed = _pil_save(img), _pil_save(img, compression="tiff_lzw")
    past = raw[:4] + struct.pack("<I", len(raw) + 8) + raw[8:]
    for bad in (raw[:6], past, raw[: len(raw) - 100], packed[:6],
                packed[: len(packed) // 2]):
        with pytest.raises(ValueError):
            tiff.decode_tiff(bad)


# --- the C++ stages against their plain twins ------------------------------------------


def _stream(seed: int, n: int) -> bytes:
    """Bytes with runs and noise: PackBits and LZW see every case."""
    rng = np.random.default_rng(seed)
    parts = []
    while sum(map(len, parts)) < n:
        k = int(rng.integers(1, 200))
        if rng.random() < 0.4:
            parts.append(bytes([int(rng.integers(0, 256))]) * k)
        else:
            parts.append(rng.integers(0, 4 if rng.random() < 0.5 else 256, k,
                                      dtype=np.uint8).tobytes())
    return b"".join(parts)[:n]


@pytest.mark.parametrize("seed", range(4))
def test_packbits_equals_packbits_plain(seed):
    raw = _stream(seed, 5000 + 997 * seed)
    enc = packbits_encode(raw) + b"\x80\x00"  # a trailing no-op and header
    got = tiff.packbits(enc, len(raw))
    assert got.tobytes() == raw
    np.testing.assert_array_equal(got, tiff.packbits_plain(enc, len(raw)))
    np.testing.assert_array_equal(tiff.packbits(enc, 100), tiff.packbits_plain(enc, 100))
    with pytest.raises(ValueError, match="truncated"):
        tiff.packbits(enc[: len(enc) // 2], len(raw))
    with pytest.raises(ValueError, match="truncated"):
        tiff.packbits_plain(enc[: len(enc) // 2], len(raw))


def _lzw_widths(enc: bytes) -> tuple:
    """(widths used, ClearCodes) of a TIFF LZW stream, by walking its codes."""
    pos, acc, nbits, size, nxt, prev, widths, clears = 0, 0, 0, 9, 258, None, set(), 0
    while True:
        while nbits < size and pos < len(enc):
            acc = (acc << 8) | enc[pos]
            nbits += 8
            pos += 1
        if nbits < size:
            return widths, clears
        nbits -= size
        code = (acc >> nbits) & ((1 << size) - 1)
        widths.add(size)
        if code == 256:
            clears += 1
            size, nxt, prev = 9, 258, None
            continue
        if code == 257:
            return widths, clears
        if prev is not None and nxt < 4096:
            nxt += 1
            if nxt == (1 << size) - 1 and size < 12:
                size += 1
        prev = code


@pytest.mark.parametrize("seed", range(3))
def test_lzw_equals_lzw_plain_across_widths_and_clears(seed):
    raw = _stream(seed, 60000)
    enc = lzw_encode(raw)
    widths, clears = _lzw_widths(enc)
    assert widths == {9, 10, 11, 12} and clears >= 2  # the first code and a full table
    got = tiff.lzw(enc, len(raw))
    assert got.tobytes() == raw
    np.testing.assert_array_equal(got, tiff.lzw_plain(enc, len(raw)))
    for cut in (1, 1000):
        np.testing.assert_array_equal(tiff.lzw(enc, cut), tiff.lzw_plain(enc, cut))
    for fn in (tiff.lzw, tiff.lzw_plain):
        with pytest.raises(ValueError, match="truncated"):
            fn(enc[: len(enc) // 3], len(raw))
        with pytest.raises(ValueError, match="past the table"):
            fn(b"\x80\x3f\xff\xff", 10)  # ClearCode, then a code past the table
        with pytest.raises(NotImplementedError, match="old-style"):
            fn(b"\x00\x01\x02", 10)


@pytest.mark.parametrize("nbytes", [1, 2, 4, 8])
@pytest.mark.parametrize("spp", [1, 3, 4])
@pytest.mark.parametrize("swap", [False, True])
def test_horizontal_predictor_equals_predict_plain(nbytes, spp, swap):
    rng = np.random.default_rng(nbytes * 10 + spp)
    rows, width = 5, 13
    buf = rng.integers(0, 256, rows * width * spp * nbytes, dtype=np.uint8)
    a, b = buf.copy(), buf.copy()
    tiff.predict(a, rows, width * spp * nbytes, spp, nbytes, 2, swap)
    tiff.predict_plain(b, rows, width * spp * nbytes, spp, nbytes, 2, swap)
    np.testing.assert_array_equal(a, b)
    # against the definition: per row, each sample plus the one spp before
    dt = np.dtype(f"u{nbytes}").newbyteorder(">" if swap else "<")
    vals = buf.view(dt).astype(np.uint64).reshape(rows, width, spp)
    want = (np.cumsum(vals, axis=1) % (1 << (8 * nbytes)) if nbytes < 8
            else np.cumsum(vals, axis=1, dtype=np.uint64))
    np.testing.assert_array_equal(a.view(f"<u{nbytes}").reshape(rows, width, spp), want)


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
@pytest.mark.parametrize("spp", [1, 3])
def test_floating_point_predictor_equals_predict_plain(dtype, spp):
    """Predictor 3 at 16, 32 and 64 bits: the writer's byte planes and
    differences undone by both stages give the samples back."""
    from make_image_formats import _predict

    rng = np.random.default_rng(spp)
    vals = (rng.standard_normal((6, 11, spp)) * 100).astype(dtype)
    enc = _predict(vals, 3, "<").reshape(-1)
    nb = np.dtype(dtype).itemsize
    a, b = enc.copy(), enc.copy()
    tiff.predict(a, 6, 11 * spp * nb, spp, nb, 3, False)
    tiff.predict_plain(b, 6, 11 * spp * nb, spp, nb, 3, False)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a.view(dtype).reshape(vals.shape), vals)
    with pytest.raises(ValueError, match="whole samples"):
        tiff.predict(enc.copy(), 1, 11 * spp * nb - 1, spp, nb, 3, False)


# --- what is not ported -----------------------------------------------------------------


def _tagged(compression=5, photometric=2, tags=None, samples=None) -> bytes:
    px = _crop()[..., :3] if samples is None else samples
    data = tiff_bytes(px, photometric, compression=5 if compression in (5, 7) else 1,
                      tags=tags)
    order, _big, _tags = tiff.read_ifd(data)
    if compression not in (1, 5):  # rewrite the Compression entry's value
        at = struct.unpack_from("<I", data, 4)[0]
        n = struct.unpack_from("<H", data, at)[0]
        for k in range(n):
            pos = at + 2 + 12 * k
            if struct.unpack_from("<H", data, pos)[0] == 259:
                data = data[: pos + 8] + struct.pack("<H", compression) + data[pos + 10:]
    return data


@pytest.mark.parametrize("code,what", [
    (6, "old-style JPEG"), (32809, "ThunderScan"), (34661, "JBIG"),
    (34676, "SGILog"), (34677, "SGILog24"), (50001, "WebP")])
def test_unported_compressions_raise(code, what, tmp_path):
    path = str(tmp_path / "x.tif")
    with open(path, "wb") as fh:
        fh.write(_tagged(code))
    with pytest.raises(NotImplementedError,
                       match=rf"{what}.*\({code}\).*{ROADMAP_ITEM}.*x\.tif"):
        imagefile.read_image(path)


@pytest.mark.parametrize("code", [2, 3, 4])
def test_ccitt_on_eight_bit_samples_raises(code, tmp_path):
    """libtiff refuses CCITT on samples of more than 1 bit (Fax3SetupState:
    "Bits/sample must be 1 for Group 3/4 encoding/decoding"), and PIL
    fails; the port raises ValueError."""
    for samples, photometric in ((_crop()[..., 0], 1), (_crop()[..., :3], 2)):
        data = _tagged(code, photometric, samples=samples)
        with pytest.raises(OSError):
            _pil(data)
        with pytest.raises(ValueError, match="Bits/sample must be 1"):
            imagefile.decode_image(data)


@pytest.mark.parametrize("code", [3, 4])
def test_uncompressed_mode_raises(code):
    """A two-dimensional row holding the extension code that enters
    uncompressed mode (0000001111): libtiff reports "Uncompressed data (not
    supported)", which raises nothing, ends the row there (EXPAND2D's
    S_Ext: its remaining width one white run) and reads the rest of the
    strip as codes, so PIL returns rows that are not the image; the port
    reads them as PIL does, through the C++ decoder and its plain twin."""
    from make_image_formats import FaxBits, fax_row_2d

    row = np.zeros(40, np.uint8)
    row[5:12] = 1
    bits = FaxBits()
    if code == 3:
        bits.put("000000000001" + "0")
    fax_row_2d(bits, row, np.zeros(40, np.uint8))
    if code == 3:
        bits.put("000000000001" + "0")
    bits.put("0000001111").put("0101000011").put("000000000001" * 2)
    data = tiff_bytes(np.zeros((3, 40), np.uint8), 0, bits=1, compression=code,
                      tags={292: (4, (1,))} if code == 3 else None,
                      codec=lambda _b: bits.to_bytes())
    want = _pil(data)
    assert want.shape == (3, 40, 4)
    np.testing.assert_array_equal(imagefile.decode_image(data), want)
    np.testing.assert_array_equal(tiff.decode_tiff(data, plain=True), want)
    assert (want[1, :, :3] == 255).all()  # the row the extension code ends is white


@pytest.mark.parametrize("photo,what,comp,tags", [
    (8, "CIE L\\*a\\*b\\*", 5, None), (9, "ICC L\\*a\\*b\\*", 5, None),
    (10, "ITU L\\*a\\*b\\*", 5, None), (32844, "LogL", 5, None),
    (32845, "LogLuv", 5, None), (6, "YCbCr TIFF without JPEG", 1, None),
    (6, "YCbCr TIFF without JPEG", 5, None),
    (5, "inks other than CMYK", 5, {332: (3, (2,))})])
def test_unported_photometrics_raise(photo, what, comp, tags, tmp_path):
    samples = _crop() if photo == 5 else None
    path = str(tmp_path / "x.tif")
    with open(path, "wb") as fh:
        fh.write(_tagged(comp, photo, tags, samples))
    with pytest.raises(NotImplementedError, match=rf"{what}.*{ROADMAP_ITEM}.*x\.tif"):
        imagefile.read_image(path)


def test_a_key_of_no_test_raises_naming_it():
    """12-bit grey (PIL's "I;12") and 16-bit MinIsBlack big-endian are keys
    the port leaves out; 64-bit floats PIL reads not at all."""
    for samples, kw in ((np.zeros((4, 4), np.uint16), {"bits": 12}),
                        (np.zeros((4, 4), np.uint16), {"order": ">", "photometric": 0}),
                        (np.zeros((4, 4), np.float64), {})):
        kw.setdefault("photometric", 1)
        data = tiff_bytes(samples, compression=1, **kw)
        with pytest.raises(NotImplementedError, match=r"pixel key .*" + ROADMAP_ITEM):
            tiff.decode_tiff(data)


def test_read_image_never_calls_pil(tmp_path, monkeypatch):
    path = str(tmp_path / "x.tif")
    data = tiff_bytes(_crop(), 2, compression=5, predictor=2, extra=(2,), tile=(16, 16))
    with open(path, "wb") as fh:
        fh.write(data)
    want = _pil(data)
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, name, None)
    np.testing.assert_array_equal(imagefile.read_image(path), want)


def test_a_failed_build_raises(monkeypatch):
    """The C++ helper does not build: the TIFF decode raises, never runs
    the plain twins."""
    import subprocess

    from figdraw_tpu_torch.utils import gxx

    def broken(*_a, **_k):
        raise subprocess.CalledProcessError(1, ["g++"], "", "error")

    monkeypatch.setattr(image_lib, "_lib", None)
    monkeypatch.setattr(gxx, "build", broken)
    with pytest.raises(subprocess.CalledProcessError):
        imagefile.decode_image(tiff_bytes(_crop(), 2, compression=5))


# --- against the JAX package: load_image, the sidecar and the frames ----------------


@pytest.fixture
def tiff_copies(tmp_path):
    """The stored TIFF fixture copied twice (each package writes its own
    sidecar beside its file)."""
    paths = []
    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub)
        paths.append(str(tmp_path / sub / os.path.basename(TIFF_FIXTURE)))
        shutil.copyfile(TIFF_FIXTURE, paths[-1])
    return paths


def test_load_image_gives_figdraw_tpus_image_mips_and_sidecar(tiff_copies):
    """Cold (decode, bleed, chain, sidecar) and warm (the sidecar) in both
    packages: the same pixels, mips and sidecar bytes, whose digest
    chip_smoke.py holds the card to."""
    import figdraw_tpu.resources as jres
    from torch_reference import jax_flippy

    from figdraw_tpu_torch import resources

    port_path, jax_path = tiff_copies
    jax_flippy()
    bus, jbus = resources.ImageMessageBus(), jres.ImageMessageBus()
    sub, jsub = bus.subscribe(), jbus.subscribe()
    for _ in range(2):
        ref, jref = resources.load_image(port_path, bus=bus), jres.load_image(jax_path, bus=jbus)
        a = [m for m in sub.drain() if m.kind == resources.ImageMsgKind.PutImage][0]
        b = [m for m in jsub.drain() if m.kind == jres.ImageMsgKind.PutImage][0]
        np.testing.assert_array_equal(a.image, np.asarray(b.image))
        np.testing.assert_array_equal(a.image, np.asarray(Image.open(IMAGE_FIXTURE)
                                                          .convert("RGBA")))
        assert len(a.mips) == len(b.mips) == 10
        for x, y in zip(a.mips, b.mips):
            np.testing.assert_array_equal(x, np.asarray(y))
        with open(port_path + ".flippy", "rb") as fh, open(jax_path + ".flippy", "rb") as jfh:
            sidecar = fh.read()
            assert sidecar == jfh.read()
        with open(IMAGE_FORMATS_REFERENCE) as fh:
            want = json.load(fh)["sidecar"][os.path.basename(TIFF_FIXTURE)]
        assert hashlib.sha256(sidecar).hexdigest() == want
        ref.close()
        jref.close()
        resources.clear_image_cache(bus=bus)
        jres.clear_image_cache(bus=jbus)


def test_image_file_scene_from_tiff_matches_jax(tiff_copies):
    """The image-file scene with the TIFF loaded: within 1e-5 of
    figdraw_tpu's block means, which the stored reference holds (chip_smoke.py
    holds the card to it), and within 1/255 of its frame."""
    import figdraw_tpu_torch as port
    from torch_reference import block_means, jax_image_file_frame

    from figdraw_tpu_torch.scenes import TIFF_FILE_REFERENCE, render_image_file

    port_path, jax_path = tiff_copies
    want = jax_image_file_frame(jax_path, "1x")
    _ren, frame, ref = render_image_file(
        lambda ps: port.FigRenderer(atlas_size=512, device="cpu", pixel_scale=ps),
        port_path, "1x")
    got = frame.numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(TIFF_FILE_REFERENCE)
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1e-5
    ref.close()


def test_photo_wall_from_tiff_matches_jax(tiff_copies):
    import figdraw_tpu_torch as port
    from torch_reference import block_means, jax_photo_wall_frame

    from figdraw_tpu_torch import resources
    from figdraw_tpu_torch.scenes import (
        PHOTO_WALL_SMALL, TIFF_WALL_REFERENCE, make_loaded_photo_wall,
    )

    port_path, jax_path = tiff_copies
    w, h, n = PHOTO_WALL_SMALL
    want = jax_photo_wall_frame(jax_path, w, h, n)
    ren = port.FigRenderer(atlas_size=512, device="cpu")
    bus = resources.ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    ref = resources.load_image(port_path, bus=bus)
    got = ren.render_frame(make_loaded_photo_wall(w, h, n, ref.id), port.vec2(w, h)).numpy()
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(TIFF_WALL_REFERENCE)
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1e-5
    ref.close()


# --- a single strip's byte count repaired as libtiff repairs it --------------------


def _set_strip_count(data: bytes, value: int) -> bytes:
    """The file with its one StripByteCounts value set to `value` (a
    writer that did not know the size leaves 0)."""
    order, big, _tags = tiff.read_ifd(data)
    fmt, entry, head = ("HHQ", 20, 8) if big else ("HHI", 12, 2)
    (at,) = struct.unpack_from(order + ("Q" if big else "I"), data, 8 if big else 4)
    (n,) = struct.unpack_from(order + ("Q" if big else "H"), data, at)
    out = bytearray(data)
    for k in range(n):
        pos = at + head + k * entry
        tag, ftype, count = struct.unpack_from(order + fmt, data, pos)
        if tag == tiff.STRIP_COUNTS:
            assert count == 1
            code = {3: "H", 4: "I", 16: "Q"}[ftype]
            struct.pack_into(order + code, out, pos + (12 if big else 8), value)
            return bytes(out)
    raise ValueError("no StripByteCounts")


ZERO_COUNT_CASES = ["none", "tiff_lzw", "packbits", "tiff_adobe_deflate", "tiff_deflate",
                    "zstd", "mm_lzw", "mm_none", "bigtiff_lzw", "bigtiff_none"]


def _one_strip(case: str) -> bytes:
    px = _crop()[..., :3]
    if case.startswith(("mm_", "bigtiff_")):
        kw = {"order": ">"} if case.startswith("mm_") else {"order": "<", "big": True}
        comp = 5 if case.endswith("lzw") else 1
        return tiff_bytes(px, 2, compression=comp, rows_per_strip=px.shape[0], **kw)
    kw = {} if case == "none" else {"compression": case}
    return _pil_save(Image.fromarray(px), rowsperstrip=px.shape[0], **kw)


@pytest.mark.parametrize("case", ZERO_COUNT_CASES)
def test_a_single_strip_of_count_zero_reads_as_pil(case):
    """libtiff's ByteCountLooksBad and EstimateStripByteCounts: a single
    strip whose StripByteCounts is 0 runs over what the header and the IFD
    leave of the file (compressed) or holds its rows (uncompressed), and
    PIL reads the image: so does the port, through load_image's decoder."""
    data = _set_strip_count(_one_strip(case), 0)
    order, big, tags = tiff.read_ifd(data)
    assert tags[tiff.STRIP_COUNTS] == (0,) and big == case.startswith("bigtiff")
    assert order == (">" if case.startswith("mm_") else "<")
    _same(data)


def test_uncompressed_single_strip_counts_that_look_bad_are_estimated():
    """An uncompressed single strip's count short of its rows or past the
    end of the file is estimated from its rows (ByteCountLooksBad); a
    compressed strip's non-zero count is kept, and a strip of a multi-strip
    file is never repaired: both packages then fail."""
    data = _one_strip("none")
    for value in (5, 10 ** 6):
        _same(_set_strip_count(data, value))
    short = _set_strip_count(_one_strip("tiff_lzw"), 40)
    with pytest.raises(Exception):
        _pil(short)
    with pytest.raises(ValueError):
        imagefile.decode_image(short)
    px = _crop()[..., :3]
    multi = bytearray(tiff_bytes(px, 2, compression=5, rows_per_strip=16))
    order, _big, tags = tiff.read_ifd(bytes(multi))
    where, n = _count_offsets(bytes(multi))
    struct.pack_into(order + "I", multi, where, 0)
    with pytest.raises(Exception):
        _pil(bytes(multi))
    with pytest.raises(ValueError):
        imagefile.decode_image(bytes(multi))


def _count_offsets(data: bytes) -> tuple:
    """(file offset of the first StripByteCounts value, the count) of a
    classic TIFF whose counts are LONGs stored outside the IFD."""
    order = "<" if data[:2] == b"II" else ">"
    (at,) = struct.unpack_from(order + "I", data, 4)
    (n,) = struct.unpack_from(order + "H", data, at)
    for k in range(n):
        tag, ftype, count, value = struct.unpack_from(order + "HHII", data, at + 2 + 12 * k)
        if tag == tiff.STRIP_COUNTS:
            assert ftype == 4 and count > 1
            return value, count
    raise ValueError("no StripByteCounts")
