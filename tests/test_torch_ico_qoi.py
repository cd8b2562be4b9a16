"""The port's ICO and QOI decoders (figdraw_tpu_torch/utils/ico.py,
utils/qoi.py) against PIL 12.1.0's `Image.open(...).convert("RGBA")`.

ICO: files PIL writes (PNG entries, 32-bit DIB entries with alpha) and
files built here (8- and 24-bit DIB entries with AND masks, several
entries of which PIL shows the largest of the lowest colour depth, a
palette PNG entry with tRNS, whose transparency PIL's ICO reader drops).
QOI: RGB and RGBA files PIL writes from the fixture and from seeded
images, streams built here op by op (an opening run, an index of a slot
never filled), and the C++ op decoder against its plain Python twin."""

import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from figdraw_tpu_torch.scenes import IMAGE_FIXTURE
from figdraw_tpu_torch.utils import ico, imagefile, qoi
from torch_reference import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
from make_image_formats import _pack_rows  # noqa: E402

torch.set_num_threads(1)


def _rgba(w, h, seed=0):
    base = np.asarray(Image.open(IMAGE_FIXTURE).convert("RGBA"))[260: 260 + h, 340: 340 + w]
    rng = np.random.default_rng(seed)
    out = np.clip(base.astype(int) + rng.integers(-30, 31, base.shape), 0, 255).astype(np.uint8)
    out[..., 3] = rng.integers(0, 256, (h, w))
    return out


def _same(data: bytes, decode) -> None:
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    got = decode(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imagefile.decode_image(data), want)


def _save(img, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


# --- ICO ------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["png", "bmp"])
@pytest.mark.parametrize("sizes", [[(32, 32)], [(16, 16), (48, 48), (24, 24)]],
                         ids=["one", "three"])
def test_pil_written_icons_equal_pil(fmt, sizes):
    img = Image.fromarray(_rgba(64, 64))
    _same(_save(img, "ICO", sizes=sizes, bitmap_format=fmt), ico.decode_ico)


def _dib_entry(px, bits, mask, palette=None) -> bytes:
    """A DIB icon image: BITMAPINFOHEADER at twice the height, the XOR
    rows and the AND mask rows, bottom-up."""
    h, w = px.shape[:2]
    rows = _pack_rows(px, bits)[::-1].tobytes()
    pw = -(-w // 32) * 32
    m = np.zeros((h, pw), np.uint8)
    m[:, :w] = mask
    mask_rows = np.packbits(m, axis=1)[::-1].tobytes()
    pal = b""
    if palette is not None:
        pal = np.concatenate([palette[:, ::-1], np.zeros((len(palette), 1), np.uint8)],
                             1).astype(np.uint8).tobytes()
    head = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0,
                       0 if palette is None else len(palette), 0)
    return head + pal + rows + mask_rows


def _ico(entries) -> bytes:
    """entries: (w, h, bpp field, colours field, payload)."""
    out = struct.pack("<HHH", 0, 1, len(entries))
    offset = 6 + 16 * len(entries)
    body = b""
    for w, h, bpp, colors, payload in entries:
        out += struct.pack("<BBBBHHII", w % 256, h % 256, colors, 0, 1, bpp, len(payload),
                           offset + len(body))
        body += payload
    return out + body


@pytest.mark.parametrize("bits", [4, 8, 24, 32])
def test_dib_entries_with_and_masks_equal_pil(bits):
    """A 32-bpp entry takes alpha from its fourth bytes; the others from
    the AND mask at the end of the entry (a set bit transparent)."""
    rng = np.random.default_rng(bits)
    w, h = 20, 14
    mask = rng.integers(0, 2, (h, w)).astype(np.uint8)
    if bits <= 8:
        px = rng.integers(0, 1 << bits, (h, w)).astype(np.uint8)
        pal = rng.integers(0, 256, (1 << bits, 3)).astype(np.uint8)
        payload = _dib_entry(px, bits, mask, pal)
    elif bits == 24:
        payload = _dib_entry(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), 24, mask)
    else:
        payload = _dib_entry(rng.integers(0, 256, (h, w, 4), dtype=np.uint8), 32, mask)
    _same(_ico([(w, h, bits, 0, payload)]), ico.decode_ico)


def test_the_entry_pil_picks_equal_pil():
    """Entries of equal area: the lowest colour depth is shown; a larger
    one wins over any depth; a bpp field of 0 counts its colours."""
    rng = np.random.default_rng(5)
    mask = np.zeros((16, 16), np.uint8)
    e8 = _dib_entry(rng.integers(0, 256, (16, 16)).astype(np.uint8), 8, mask,
                    rng.integers(0, 256, (256, 3)).astype(np.uint8))
    e24 = _dib_entry(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8), 24, mask)
    e4 = _dib_entry(rng.integers(0, 16, (16, 16)).astype(np.uint8), 4, mask,
                    rng.integers(0, 256, (16, 3)).astype(np.uint8))
    for entries in ([(16, 16, 24, 0, e24), (16, 16, 8, 0, e8)],
                    [(16, 16, 8, 0, e8), (16, 16, 24, 0, e24)],
                    [(16, 16, 0, 16, e4), (16, 16, 24, 0, e24)]):
        _same(_ico(entries), ico.decode_ico)
    big = _dib_entry(rng.integers(0, 256, (24, 24, 3), dtype=np.uint8), 24,
                     np.zeros((24, 24), np.uint8))
    _same(_ico([(16, 16, 8, 0, e8), (24, 24, 24, 0, big)]), ico.decode_ico)


def _png(pixels, ct, plte=None, trns=None) -> bytes:
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    h, w = pixels.shape[:2]
    raw = b"".join(b"\x00" + row.tobytes() for row in pixels.reshape(h, -1))
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ct, 0, 0, 0))
    if plte is not None:
        out += chunk(b"PLTE", plte)
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def test_png_entries_drop_trns_as_pil_does():
    """A palette or grey PNG entry with tRNS: PIL's ICO reader keeps the
    pixels and mode but not the PNG's transparency."""
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 4, (12, 12)).astype(np.uint8)
    pal = rng.integers(0, 256, 12).astype(np.uint8).tobytes()
    for payload in (_png(idx, 3, pal, bytes([0, 128])), _png(idx * 60, 0, None, b"\x00\x3c"),
                    _png(rng.integers(0, 256, (12, 12, 4), dtype=np.uint8), 6)):
        _same(_ico([(12, 12, 32, 0, payload)]), ico.decode_ico)


def test_not_an_ico_raises():
    with pytest.raises(ValueError):
        ico.decode_ico(b"\x00\x00\x01\x00\x00\x00")


# --- QOI ------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("source", ["fixture", "noise", "flat"])
def test_pil_written_qoi_equals_pil(mode, source):
    if source == "fixture":
        img = Image.open(IMAGE_FIXTURE).convert(mode).crop((200, 150, 520, 390))
    elif source == "noise":
        img = Image.fromarray(_rgba(61, 37, 1)).convert(mode)
    else:
        a = np.zeros((30, 41, 4), np.uint8)
        a[..., 3] = 255
        a[5:20, 7:30] = (10, 20, 30, 200)
        img = Image.fromarray(a).convert(mode)
    data = _save(img, "QOI")
    for plain in (False, True):
        _same(data, lambda d: qoi.decode_qoi(d, plain=plain))


def _qoi(w, h, channels, ops: bytes) -> bytes:
    return b"qoif" + struct.pack(">IIBB", w, h, channels, 0) + ops + b"\x00" * 7 + b"\x01"


@pytest.mark.parametrize("channels", [3, 4])
def test_hand_built_streams_equal_pil(channels):
    """An opening run (PIL files nothing in the index for a run), an index
    of a slot never filled, each op, a run to the end."""
    h = (0 * 3 + 0 * 5 + 0 * 7 + 255 * 11) % 64  # the slot of the opening pixel
    ops = bytes([0xC0 | 2, h, 0xFE, 10, 20, 30, 0x40 | 0b111001, 0x80 | 40, 0x9A,
                 0xFF, 1, 2, 3, 4, 0x05, 0xC0 | 1, 0xFE, 200, 100, 50, 0xC0 | 61,
                 0xC0 | 61, 0xC0 | 8])  # 145 pixels
    data = _qoi(5, 29, channels, ops)
    for plain in (False, True):
        _same(data, lambda d: qoi.decode_qoi(d, plain=plain))


def test_ops_equal_ops_plain():
    rng = np.random.default_rng(11)
    for _ in range(3):
        img = Image.fromarray(rng.integers(0, 4, (40, 50, 4), dtype=np.uint8) * 60)
        data = _save(img, "QOI")[14:]
        np.testing.assert_array_equal(qoi.ops(data, 2000), qoi.ops_plain(data, 2000))


def test_truncated_qoi_raises():
    data = _save(Image.fromarray(_rgba(20, 20)), "QOI")
    for plain in (False, True):
        with pytest.raises(ValueError, match="truncated"):
            qoi.decode_qoi(data[: len(data) // 2], plain=plain)
