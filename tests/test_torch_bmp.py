"""The port's BMP decoder (figdraw_tpu_torch/utils/bmp.py) against PIL
12.1.0's `Image.open(...).convert("RGBA")`: every header kind (OS/2 core,
INFO, V2, V3, OS/2 2.x, V4, V5) at 1, 4, 8, 16, 24 and 32 bits, BI_RGB,
BI_BITFIELDS (each layout PIL reads), RLE8 and RLE4 (deltas, odd
absolute runs), bottom-up and top-down, grey-ramp palettes, indices past
the palette, odd widths; files written here by tools/make_image_formats.py's
builder (PIL writes only INFO BI_RGB) and by PIL. What PIL cannot read
(ALPHABITFIELDS, other bitfield layouts) raises ValueError in both."""

import io
import os
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from figdraw_tpu_torch.scenes import IMAGE_FIXTURE
from figdraw_tpu_torch.utils import bmp, imagefile
from torch_reference import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
from make_image_formats import bmp_bytes, rle4, rle8  # noqa: E402

torch.set_num_threads(1)

HEADERS = [12, 40, 52, 56, 64, 108, 124]


def _rgb(w=37, h=23, seed=0):
    base = np.asarray(Image.open(IMAGE_FIXTURE).convert("RGB"))[250: 250 + h, 350: 350 + w]
    rng = np.random.default_rng(seed)
    return np.clip(base.astype(int) + rng.integers(-40, 41, base.shape), 0, 255).astype(np.uint8)


def _indexed(colors, w=37, h=23):
    q = Image.fromarray(_rgb(w, h, colors)).quantize(colors)
    pal = np.frombuffer(bytes(q.getpalette()[: 3 * colors]), np.uint8).reshape(-1, 3)
    return np.array(q), pal


def _same(data: bytes) -> None:
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    got = bmp.decode_bmp(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imagefile.decode_image(data), want)


# the core header has no signed height: no top-down form
ORDERS = [(h, td) for h in HEADERS for td in (False, True) if not (h == 12 and td)]


@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("header,top_down", ORDERS)
def test_palette_bitmaps_equal_pil(header, top_down, bits):
    idx, pal = _indexed(1 << bits)
    _same(bmp_bytes(idx, bits, header, palette=pal, top_down=top_down))


@pytest.mark.parametrize("header", HEADERS)
@pytest.mark.parametrize("bits", [16, 24, 32])
def test_rgb_bitmaps_equal_pil(bits, header):
    """BI_RGB: 16 bits 5-5-5, 24 BGR, 32 BGRX (the fourth byte dropped)."""
    px = _rgb(29, 17)
    if bits == 16:
        v = ((px[..., 0].astype(np.uint16) >> 3) << 10) | ((px[..., 1].astype(np.uint16) >> 3)
                                                           << 5) | (px[..., 2] >> 3)
        pixels = v | 0x8000
    elif bits == 24:
        pixels = px[..., ::-1]
    else:
        pixels = np.concatenate([px[..., ::-1], np.full(px.shape[:2] + (1,), 7, np.uint8)], -1)
    _same(bmp_bytes(pixels, bits, header))
    if header != 12:
        _same(bmp_bytes(pixels, bits, header, top_down=True))


_BITFIELDS = {
    "BGRX": (32, (0xFF0000, 0xFF00, 0xFF, 0x0)),
    "XBGR": (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)),
    "BGXR": (32, (0xFF000000, 0xFF00, 0xFF, 0x0)),
    "ABGR": (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)),
    "RGBA": (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
    "BGRA": (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    "BGAR": (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)),
    "zero": (32, (0, 0, 0, 0)),
    "BGR": (24, (0xFF0000, 0xFF00, 0xFF, 0)),
    "565": (16, (0xF800, 0x7E0, 0x1F, 0)),
    "555": (16, (0x7C00, 0x3E0, 0x1F, 0)),
}


@pytest.mark.parametrize("header", [40, 52, 56, 108, 124])
@pytest.mark.parametrize("layout", list(_BITFIELDS))
def test_bitfields_equal_pil(layout, header):
    """Each layout PIL reads; a 40-byte header carries three masks after
    it (no alpha), V2 three in it, V3 and later four."""
    bits, masks = _BITFIELDS[layout]
    rng = np.random.default_rng(bits)
    nbytes = bits // 8
    pixels = rng.integers(0, 256, (19, 13, nbytes), dtype=np.uint8)
    if bits == 16:
        pixels = pixels.view("<u2")[..., 0]
    data = bmp_bytes(pixels, bits, header, compression=3, masks=masks)
    try:
        Image.open(io.BytesIO(data)).load()
    except OSError:  # a 4-mask layout with its A mask dropped (40 and V2 headers)
        with pytest.raises(ValueError, match="bitfields"):
            bmp.decode_bmp(data)
        return
    _same(data)


@pytest.mark.parametrize("what", ["layout", "alphabitfields", "jpeg"])
def test_what_pil_cannot_read_raises(what):
    px = _rgb(8, 8)
    if what == "layout":
        data = bmp_bytes(px[..., ::-1], 24, 56, compression=3, masks=(0xFF, 0xFF00, 0xFF0000, 0))
    else:
        data = bmp_bytes(px[..., ::-1], 24, 124, compression=6 if what != "jpeg" else 4)
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(ValueError):
        bmp.decode_bmp(data)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("width", [37, 38, 255, 300])
def test_rle_equals_pil(bits, width):
    idx, pal = _indexed(1 << bits, width, 11)
    if width == 38:  # long runs
        idx[:, 3:30] = idx[0, 3]
    enc = rle8(idx) if bits == 8 else rle4(idx)
    _same(bmp_bytes(idx, bits, 40, palette=pal, compression=1 if bits == 8 else 2, rle=enc))


def _rle_file(bits, w, h, stream, palette):
    return bmp_bytes(np.zeros((h, w), np.uint8), bits, 40, palette=palette,
                     compression=1 if bits == 8 else 2, rle=stream)


@pytest.mark.parametrize("bits", [4, 8])
def test_rle_quirks_equal_pil(bits):
    """PIL's BmpRleDecoder on streams real encoders rarely write: a delta
    (PIL skips two bytes before its right and up), a run past the row's
    end, an odd absolute RLE4 run (PIL takes n // 2 bytes), a missing end
    of line; data that ends early fails in both."""
    _idx, pal = _indexed(16 if bits == 4 else 256, 12, 6)
    full = bytes([0, 0, 12, 0x11] * 6)  # end-of-line and a full row, six times
    streams = [
        bytes([3, 0x21, 0, 2, 9, 9, 2, 1, 4, 0x35, 0, 0, 20, 0x11, 0, 0]) + full,
        bytes([0, 5, 0x12, 0x34, 0x56, 0, 2, 0x77, 0, 0, 0, 3, 0x98, 0x76, 0x54, 0, 0, 0])
        + full,
        bytes([12, 0x42, 12, 0x24, 5, 0x66, 0, 0]) + full,
        bytes([6, 0x13, 6, 0x31, 6, 0x55, 66, 0x17]) + full,
    ]
    for s in streams:
        _same(_rle_file(bits, 12, 6, s, pal))
    short = _rle_file(bits, 12, 6, bytes([12, 0x42, 0, 1]), pal)
    with pytest.raises(ValueError, match="not enough image data"):
        Image.open(io.BytesIO(short)).load()
    with pytest.raises(ValueError, match="not enough image data"):
        bmp.decode_bmp(short)


def test_grey_ramp_palettes_read_as_pil_does():
    """8-bit with a grey-ramp palette reads "L"; 1-bit black and white
    reads "1"; 4-bit with the 16-entry ramp reads one byte a pixel, which
    PIL's raw decoder refuses for rows wider than the stride (it fails,
    and so does the port) and takes for narrow ones."""
    idx = np.random.default_rng(1).integers(0, 256, (9, 13), dtype=np.uint8)
    ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    _same(bmp_bytes(idx, 8, 40, palette=ramp))
    _same(bmp_bytes(idx & 1, 1, 40, palette=np.array([[0] * 3, [255] * 3], np.uint8)))
    narrow = bmp_bytes(idx[:, :4] & 15, 4, 40, palette=ramp[:16])
    _same(narrow)
    wide = bmp_bytes(idx & 15, 4, 40, palette=ramp[:16])
    with pytest.raises(OSError):
        Image.open(io.BytesIO(wide)).load()
    with pytest.raises(ValueError, match="stride"):
        bmp.decode_bmp(wide)


def test_indices_past_the_palette_equal_pil():
    idx = np.random.default_rng(2).integers(0, 256, (7, 11), dtype=np.uint8)
    pal = np.array([[10, 200, 30], [250, 5, 5], [0, 0, 255]], np.uint8)
    _same(bmp_bytes(idx, 8, 40, palette=pal))
    _same(bmp_bytes(idx, 8, 12, palette=pal))


def test_pil_written_bitmaps_equal_pil():
    for mode in ("RGB", "RGBA", "L", "P", "1"):
        img = Image.fromarray(_rgb(31, 21)).convert(mode)
        buf = io.BytesIO()
        img.save(buf, "BMP")
        _same(buf.getvalue())


def test_data_offset_fixup_and_colour_count():
    """A header whose data offset points at the palette (14 + header
    size) has the palette added to it; colours 0 means 1 << bits."""
    idx, pal = _indexed(16)
    data = bytearray(bmp_bytes(idx, 4, 40, palette=pal))
    data[10:14] = struct.pack("<I", 14 + 40)
    data[14 + 32: 14 + 36] = struct.pack("<I", 0)
    _same(bytes(data))


def test_truncated_and_not_bmp_raise():
    data = bmp_bytes(_rgb(8, 8)[..., ::-1], 24, 40)
    with pytest.raises(ValueError):
        bmp.decode_bmp(data[:-20])
    with pytest.raises(ValueError):
        bmp.decode_bmp(b"BM\x00")
