"""The port's GIF decoder (figdraw_tpu_torch/utils/gif.py) against PIL
12.1.0's `Image.open(...).convert("RGBA")` of the first frame: GIFs PIL
writes here from the repo's fixture and seeded numpy images (global and
local colour tables, a transparent index, interlace, grey frames, palettes
of 2 to 256 entries), and files edited here for what PIL's writer does not
produce (a frame smaller than the logical screen and offset in it, a frame
reaching past the screen, a local table, an edited grey table, GIF87a).
The C++ LZW decoder against its plain Python twin."""

import io

import numpy as np
import pytest
import torch
from PIL import Image

from figdraw_tpu_torch.scenes import IMAGE_FIXTURE
from figdraw_tpu_torch.utils import gif, imagefile

torch.set_num_threads(1)


def _rgb(w, h, seed=0):
    base = np.asarray(Image.open(IMAGE_FIXTURE).convert("RGB"))[200: 200 + h, 300: 300 + w]
    rng = np.random.default_rng(seed)
    return np.clip(base.astype(int) + rng.integers(-30, 31, base.shape), 0, 255).astype(np.uint8)


def _gif(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "GIF", **kw)
    return buf.getvalue()


def _same(data: bytes) -> None:
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    for plain in (False, True):
        got = gif.decode_gif(data, plain=plain)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imagefile.decode_image(data), want)


@pytest.mark.parametrize("colors", [2, 16, 64, 256])
@pytest.mark.parametrize("variant", ["plain", "transparent", "interlaced"])
def test_first_frame_equals_pil(colors, variant):
    q = Image.fromarray(_rgb(97, 61, colors)).quantize(colors)
    kw = {"plain": {}, "transparent": {"transparency": int(np.asarray(q)[3, 5])},
          "interlaced": {"interlace": True}}[variant]
    _same(_gif(q, **kw))


def test_grey_frame_equals_pil():
    _same(_gif(Image.fromarray(_rgb(50, 40)[..., 0])))
    _same(_gif(Image.fromarray(_rgb(50, 40)[..., 0]), transparency=7))


def test_animation_first_frame_equals_pil():
    frames = [Image.fromarray(_rgb(80, 60, s)).quantize(16) for s in range(3)]
    _same(_gif(frames[0], save_all=True, append_images=frames[1:], transparency=3,
               duration=40, loop=0))


def _descriptor(data: bytes) -> int:
    """The offset of the first image descriptor (after extensions)."""
    pos = 13 + (3 << ((data[10] & 7) + 1) if data[10] & 0x80 else 0)
    while data[pos] == 0x21:
        pos += 2
        while data[pos]:
            pos += data[pos] + 1
        pos += 1
    assert data[pos] == 0x2C
    return pos


@pytest.mark.parametrize("trns", [None, 4])
@pytest.mark.parametrize("place", ["inside", "past"])
def test_frame_placed_on_the_screen_as_pil_does(place, trns):
    """A frame at (5, 3) of a larger logical screen (the rest holds the
    transparent index, else index 0), or reaching past a smaller one (the
    canvas grows to hold it)."""
    q = Image.fromarray(_rgb(40, 30)).quantize(16)
    data = bytearray(_gif(q, **({} if trns is None else {"transparency": trns})))
    d = _descriptor(data)
    screen = (60, 50) if place == "inside" else (30, 20)
    data[6:10] = np.array(screen, "<u2").tobytes()
    data[d + 1: d + 5] = np.array((5, 3), "<u2").tobytes()
    _same(bytes(data))


def test_local_table_and_gif87a_equal_pil():
    """The global table moved into the frame's descriptor; a GIF87a header."""
    q = Image.fromarray(_rgb(33, 21)).quantize(8)
    data = _gif(q)
    flags = data[10]
    n = 3 << ((flags & 7) + 1)
    table = data[13: 13 + n]
    body = data[13 + n:]
    d = _descriptor(data) - n - 13
    moved = (data[:10] + bytes([flags & 0x7F]) + data[11:13] + body[: d + 9]
             + bytes([body[d + 9] | 0x80 | (flags & 7)]) + table + body[d + 10:])
    _same(moved)
    _same(b"GIF87a" + moved[6:])


def test_an_edited_grey_table_reads_as_a_palette():
    """A grey-ramp table reads as "L"; with two entries changed it is a
    palette again ("P")."""
    q = Image.fromarray(_rgb(24, 16)[..., 0]).convert("P")
    data = bytearray(_gif(q))
    assert data[10] & 0x80
    _same(bytes(data))
    data[13: 13 + 6] = bytes([200, 10, 10, 10, 200, 10])
    _same(bytes(data))


@pytest.mark.parametrize("seed", range(4))
def test_lzw_equals_lzw_plain(seed):
    """fd_gif_lzw against lzw_plain on the LZW streams of noise images
    (tables that fill to 4096 codes) and of a cropped stream."""
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (90, 120), dtype=np.uint8), "L")
    img = img.convert("P") if seed % 2 else img
    data = _gif(img)
    d = _descriptor(data)
    min_size = data[d + 10]
    stream, _ = gif._sub_blocks(data, d + 11)
    n = 90 * 120
    full = gif.lzw(stream, min_size, n)
    np.testing.assert_array_equal(full, gif.lzw_plain(stream, min_size, n))
    half = stream[: len(stream) // 2]
    np.testing.assert_array_equal(gif.lzw(half, min_size, n), gif.lzw_plain(half, min_size, n))


def test_not_a_gif_raises():
    with pytest.raises(ValueError):
        gif.decode_gif(b"GIF89a\x01")
