"""CCITT RLE-W TIFFs (compression 32771) in the port (utils/fax.py and its
C++ fd_tiff_fax in the RLEW mode; utils/tiff.py), against PIL 12.1.0's
`Image.open(...).convert("RGBA")`, which reads them through libtiff 4.7.1's
Fax3DecodeRLE as figdraw_tpu does: Modified Huffman rows, each word-aligned
by the decoder's rule (the buffered bits dropped to a multiple of 16, then
a byte skipped where the read pointer's address in the file's mapping is
odd). Equal byte for byte on files PIL writes (`tiff_raw_16`) at widths
whose rows take an odd and an even number of bytes, in one strip and in
several, and on files the tool's writer makes with strips at odd offsets
(where a reading aligned to the strip's start parts from PIL), in tiles,
and cut short; the C++ mode against its plain twin; the stored files; the
stored RLE-W fixture through load_image, the image-file scene and the
photo wall against figdraw_tpu's."""

import io
import os
import shutil
import struct
import sys
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from figdraw_tpu_torch.scenes import IMAGE_FIXTURE, IMAGE_FORMATS_DIR, RLEW_FIXTURE
from figdraw_tpu_torch.utils import fax, imagefile, tiff
from torch_reference import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
from make_image_formats import fax_encode, tiff_bytes, uncompressed_mode_strip  # noqa: E402
from tiff_fuzz_agreement import _count_entry  # noqa: E402

torch.set_num_threads(1)


def _pil(data: bytes):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    except Exception:  # noqa: BLE001 - any PIL failure is a refusal
        return None


def _same(data: bytes) -> np.ndarray:
    """The port's decode, C++ and plain, equals PIL's, or all refuse."""
    want = _pil(data)
    if want is None:
        with pytest.raises(ValueError):
            imagefile.decode_image(data)
        with pytest.raises(ValueError):
            tiff.decode_tiff(data, plain=True)
        return None
    got = imagefile.decode_image(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tiff.decode_tiff(data, plain=True), want)
    return got


def _dither(w: int, h: int, seed: int) -> Image.Image:
    rng = np.random.default_rng(seed)
    y, x = int(rng.integers(0, 600 - h)), int(rng.integers(0, 800 - w))
    return Image.open(IMAGE_FIXTURE).convert("L").crop((x, y, x + w, y + h)).convert("1")


def _pil_rlew(img: Image.Image, rows_per_strip=None) -> bytes:
    b = io.BytesIO()
    img.save(b, "TIFF", compression="tiff_raw_16",
             **({"tiffinfo": {278: rows_per_strip}} if rows_per_strip else {}))
    return b.getvalue()


def _odd_strips(bits: np.ndarray, rows_per_strip: int, tile=None) -> bytes:
    """RLE-W strips (fax_encode) stored unpadded, each one byte off its
    word: the strips after the first start at odd offsets."""
    def codec(block):
        data = fax_encode(block[..., 0], 32771)
        return data[:-1] if data[-1] == 0 else data + b"\0"

    return tiff_bytes(bits, 0, bits=1, compression=32771, rows_per_strip=rows_per_strip,
                      tile=tile, codec=codec, pad=False)


# widths whose rows take 1, 2, 3, 4, 5 and 13 bytes
WIDTHS = [7, 16, 17, 31, 33, 100]
# the files libtiff's decoder fails outright: its word alignment drops the
# bits it read ahead of a row's end, so it reads later rows from other
# bits than its encoder wrote them at, and the strip runs out
REFUSED = {(7, None), (7, 5), (17, None), (17, 5), (31, None), (31, 5), (9, 3)}


@pytest.mark.parametrize("rows_per_strip", [None, 1, 5])
@pytest.mark.parametrize("width", WIDTHS)
def test_pil_written_files_equal_pil(width, rows_per_strip):
    data = _pil_rlew(_dither(width, 23, width), rows_per_strip)
    assert tiff.read_ifd(data)[2][tiff.COMPRESSION] == (32771,)
    assert (_same(data) is None) == ((width, rows_per_strip) in REFUSED)


@pytest.mark.parametrize("rows_per_strip", [2, 3, 7])
@pytest.mark.parametrize("width", [9, 23, 40, 57])
def test_strips_at_odd_offsets_equal_pil(width, rows_per_strip):
    bits = 1 - np.asarray(_dither(width, 19, width + rows_per_strip), np.uint8)
    data = _odd_strips(bits, rows_per_strip)
    offsets = tiff.read_ifd(data)[2][tiff.STRIP_OFFSETS]
    assert any(o & 1 for o in offsets)
    assert (_same(data) is None) == ((width, rows_per_strip) in REFUSED)


def test_alignment_follows_the_address_not_the_strip_start():
    """libtiff word-aligns by the address of its read pointer in the file's
    mapping: reading each strip as if it started on a word parts from PIL
    on strips at odd offsets."""
    parted = 0
    for width in (9, 23, 40, 57):
        for rows_per_strip in (2, 3, 7):
            bits = 1 - np.asarray(_dither(width, 19, width + rows_per_strip), np.uint8)
            data = _odd_strips(bits, rows_per_strip)
            want = _pil(data)
            order, big, tags = tiff.read_ifd(data)
            img = tiff.Image(order, tags, data, big)
            ctx = tiff.fax_context(img)
            rows = []
            for _plane, y, _x, offset, count in img.chunks():
                n = img.chunk_rows(y)
                stored = data[offset: offset + count]
                try:
                    rows.append(tiff.fax_rows(stored, img, n, ctx, 0))
                except ValueError:
                    rows.append(None)
            parted += any(r is None for r in rows) or not np.array_equal(
                np.unpackbits(np.concatenate(rows)).reshape(19, -1)[:, :width],
                (want[..., 0] == 0).astype(np.uint8))
    assert parted > 0


def test_tiles_equal_pil():
    bits = 1 - np.asarray(_dither(70, 45, 3), np.uint8)
    assert _same(_odd_strips(bits, None, tile=(32, 16))) is not None


@pytest.mark.parametrize("cut", [0.2, 0.5, 0.9])
def test_cut_strips_equal_pil(cut):
    """A strip cut short: Fax3DecodeRLE's premature EOF fails the strip, and
    PIL and the port both refuse the file."""
    data = bytearray(_pil_rlew(_dither(40, 30, 8)))
    where, code, _n = _count_entry(bytes(data), tiff.STRIP_COUNTS)
    count = tiff.read_ifd(bytes(data))[2][tiff.STRIP_COUNTS][0]
    struct.pack_into(code, data, where, int(count * cut))
    _same(bytes(data))


def test_rlew_mode_equals_its_plain_twin():
    for name in ("rlew_dither.tif", "rlew_odd_strips.tif"):
        with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
            data = fh.read()
        pairs = list(tiff.stage_pairs(data))
        assert pairs and {p[0] for p in pairs} == {"fax"}
        for _stage, got, want in pairs:
            np.testing.assert_array_equal(got, want)


def test_decoder_word_alignment_is_libtiffs():
    """Rows coded word-aligned from the strip's start (fax_encode, as
    libtiff's encoder aligns its buffer) come back as written through the
    first rows only: the decoder drops the bits it read ahead of a row's
    end before it aligns (Fax3DecodeRLE), as PIL shows; Modified Huffman's
    byte alignment reads every row back."""
    bits = 1 - np.asarray(_dither(45, 12, 4), np.uint8)
    rows = {}
    for mode in (fax.RLEW, fax.MH):
        out = np.zeros((12, 6), np.uint8)
        fax.decode(fax_encode(bits, mode), 45, 12, mode, 0, out, fax.new_state(45, False))
        rows[mode] = (np.unpackbits(out, axis=1)[:, :45] == bits).all(axis=1)
    assert rows[fax.MH].all()
    assert rows[fax.RLEW][0] and not rows[fax.RLEW].all()
    data = tiff_bytes(bits, 0, bits=1, compression=32771,
                      codec=lambda b: fax_encode(b[..., 0], 32771))
    got = _same(data)
    assert (((got[..., 0] == 0) == bits.astype(bool)).all(axis=1) == rows[fax.RLEW]).all()


@pytest.mark.parametrize("name", ["rlew_dither.tif", "rlew_odd_strips.tif",
                                  "ccitt_uncompressed_mode.tif"])
def test_stored_files_equal_pil(name):
    with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
        assert _same(fh.read()) is not None


def test_extension_code_ends_its_row_white():
    """The extension code of uncompressed mode in place of four rows every
    sixteen of a T.6 strip: libtiff ends the row at its seven bits (one
    white run), reads the three ones after them as V0 on white references
    (three white rows), then the coding goes on; PIL's rows are those, and
    the port's."""
    bits = 1 - np.asarray(_dither(56, 40, 9), np.uint8)
    strip, rows = uncompressed_mode_strip(bits)
    data = tiff_bytes(bits, 0, bits=1, compression=4, codec=lambda _b: strip)
    got = _same(data)
    np.testing.assert_array_equal((got[..., 0] == 0).astype(np.uint8), rows)
    assert not rows[8:12].any() and rows[:8].any()


# --- against the JAX package: load_image, the image-file scene, the photo wall ----------


@pytest.fixture
def rlew_copies(tmp_path):
    paths = []
    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub)
        paths.append(str(tmp_path / sub / os.path.basename(RLEW_FIXTURE)))
        shutil.copyfile(RLEW_FIXTURE, paths[-1])
    return paths


def test_load_image_gives_figdraw_tpus_image_and_mips(rlew_copies):
    import figdraw_tpu.resources as jres
    from torch_reference import jax_flippy

    from figdraw_tpu_torch import resources

    port_path, jax_path = rlew_copies
    jax_flippy()
    bus, jbus = resources.ImageMessageBus(), jres.ImageMessageBus()
    sub, jsub = bus.subscribe(), jbus.subscribe()
    ref, jref = resources.load_image(port_path, bus=bus), jres.load_image(jax_path, bus=jbus)
    a = [m for m in sub.drain() if m.kind == resources.ImageMsgKind.PutImage][0]
    b = [m for m in jsub.drain() if m.kind == jres.ImageMsgKind.PutImage][0]
    np.testing.assert_array_equal(a.image, np.asarray(b.image))
    assert len(a.mips) == len(b.mips)
    for x, y in zip(a.mips, b.mips):
        np.testing.assert_array_equal(x, np.asarray(y))
    with open(port_path + ".flippy", "rb") as fh, open(jax_path + ".flippy", "rb") as jfh:
        assert fh.read() == jfh.read()
    ref.close()
    jref.close()


def test_image_file_scene_matches_jax(rlew_copies):
    """The image-file scene from each package's load_image: the same atlas
    bytes, the frames within 1/255, and the stored block means
    chip_smoke.py holds the card to."""
    from torch_reference import block_means, image_file_scene_pair

    from figdraw_tpu_torch.scenes import RLEW_FILE_REFERENCE

    got, want, atlas, jatlas, refs = image_file_scene_pair(*rlew_copies)
    assert atlas == jatlas
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(RLEW_FILE_REFERENCE)
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1e-5
    for r in refs:
        r.close()


def test_photo_wall_matches_jax(rlew_copies):
    import figdraw_tpu_torch as port
    from torch_reference import block_means, jax_photo_wall_frame

    from figdraw_tpu_torch import resources
    from figdraw_tpu_torch.scenes import (
        PHOTO_WALL_SMALL, RLEW_WALL_REFERENCE, make_loaded_photo_wall,
    )

    port_path, jax_path = rlew_copies
    w, h, n = PHOTO_WALL_SMALL
    want = jax_photo_wall_frame(jax_path, w, h, n)
    ren = port.FigRenderer(atlas_size=512, device="cpu")
    bus = resources.ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    ref = resources.load_image(port_path, bus=bus)
    got = ren.render_frame(make_loaded_photo_wall(w, h, n, ref.id), port.vec2(w, h)).numpy()
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(RLEW_WALL_REFERENCE)
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1.0 / 255.0
    ref.close()
