"""The port's Zstandard decoder (figdraw_tpu_torch/utils/zstd.py, its C++ in
csrc/zstd_decode.cpp: fd_zstd_decompress) behind load_image, against PIL
12.1.0's `Image.open(...).convert("RGBA")`, which reads TIFF compression
50000 through libtiff 4.7.1 and libzstd 1.5.7, as figdraw_tpu does: equal
byte for byte on the stored files (tools/make_image_formats.py: PIL's
writer at libtiff's level, and libzstd's frames at levels 1, 3, 19 and 22
with a checksum, which these tests do not make: they never load libzstd),
on files PIL writes here (every pixel kind ZSTD reaches, Predictors 1, 2
and 3, strips of 1 row to the whole image) and on frames built here byte
by byte (raw and RLE blocks, each Frame_Content_Size width, the window
descriptor, the checksum, big-endian files and tiles); what libtiff's
ZSTDDecode does with a strip of several frames, a skippable frame, bytes
after the frame, a dictionary, a bad checksum, cut or corrupted data
(ValueError where PIL raises OSError); the C++ decoder against its plain
twin on the stored strips and on corrupted copies of them; load_image of
the ZSTD fixture against figdraw_tpu's, and its image-file scene and photo
wall against figdraw_tpu's block means."""

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
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from figdraw_tpu_torch.scenes import (
    IMAGE_FIXTURE, IMAGE_FIXTURE_REFERENCE, IMAGE_FORMATS_DIR, IMAGE_FORMATS_REFERENCE,
    ZSTD_FIXTURE, ZSTD_TILES_BOX,
)
from figdraw_tpu_torch.utils import imagefile, tiff, zstd
from torch_reference import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
from make_image_formats import tiff_bytes  # noqa: E402

torch.set_num_threads(1)

STORED = sorted(n for n in os.listdir(IMAGE_FORMATS_DIR)
                if n.endswith(".tif") and "zstd" in n)
ROADMAP_ITEM = "Image formats other than PNG"


def _crop(w=61, h=47) -> np.ndarray:
    base = np.asarray(Image.open(IMAGE_FIXTURE).convert("RGBA"))[200: 200 + h, 300: 300 + w]
    rng = np.random.default_rng(w * 7 + h)
    return np.clip(base.astype(int) + rng.integers(-9, 10, base.shape), 0, 255).astype(np.uint8)


def _pil(data: bytes) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _same(data: bytes) -> np.ndarray:
    """The port's decode, its plain twins' and each stage's equal PIL's."""
    want = _pil(data)
    got = imagefile.decode_image(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tiff.decode_tiff(data, plain=True), want)
    for _stage, a, b in tiff.stage_pairs(data):
        np.testing.assert_array_equal(a, b)
    return got


def _pil_zstd(img, info: dict) -> bytes:
    b = io.BytesIO()
    img.save(b, "TIFF", compression="zstd", tiffinfo=info)
    return b.getvalue()


def _strips(data: bytes) -> list:
    """A TIFF's strips or tiles, as stored."""
    order, _big, tags = tiff.read_ifd(data)
    img = tiff.Image(order, tags)
    return [data[o: o + c] for _p, _y, _x, o, c in img.chunks()]


def frame(content: bytes, blocks=None, single: bool = True, fcs_bytes: int = None,
          checksum: bool = False, window_log: int = None, did: bytes = b"",
          rle: bool = False) -> bytes:
    """A Zstandard frame built byte by byte: raw blocks (RLE blocks of each
    run of one byte when rle) of at most `blocks` bytes, the content size in
    1, 2, 4 or 8 bytes (None: the smallest that holds it; 0: none, with a
    window descriptor of window_log), a dictionary ID, the checksum."""
    size = len(content)
    if fcs_bytes is None:
        fcs_bytes = 1 if size < 256 and single else 2 if 256 <= size < 65792 else 4
    flag = {0: 0, 1: 0, 2: 1, 4: 2, 8: 3}[fcs_bytes]
    did_flag = {0: 0, 1: 1, 2: 2, 4: 3}[len(did)]
    head = struct.pack("<I", zstd.MAGIC)
    head += bytes([flag << 6 | int(single) << 5 | int(checksum) << 2 | did_flag])
    if not single:
        head += bytes([((window_log or 17) - 10) << 3])
    head += did
    if fcs_bytes:
        head += (size - (256 if fcs_bytes == 2 else 0)).to_bytes(fcs_bytes, "little")
    out = bytearray(head)
    step = blocks or zstd.BLOCK_MAX
    pieces = []
    if rle:
        start = 0
        for i in range(1, size + 1):
            if i == size or content[i] != content[start] or i - start == step:
                pieces.append((1, content[start: i]))
                start = i
    else:
        pieces = [(0, content[i: i + step]) for i in range(0, size, step)] or [(0, b"")]
    for k, (kind, piece) in enumerate(pieces):
        last = k == len(pieces) - 1
        out += (len(piece) << 3 | kind << 1 | int(last)).to_bytes(3, "little")
        out += piece[:1] if kind == 1 else piece
    if checksum:
        out += struct.pack("<I", zstd.xxh64(content) & 0xFFFFFFFF)
    return bytes(out)


def _framed(px, photometric=2, strip_frame=None, **kw) -> bytes:
    """A ZSTD TIFF whose strips or tiles are frames built by `frame`."""
    order = kw.get("order", "<")

    def codec(block):
        dtype = block.dtype.newbyteorder(order) if block.dtype.itemsize > 1 else block.dtype
        raw = np.ascontiguousarray(block.astype(dtype)).tobytes()
        return (strip_frame or frame)(raw)
    return tiff_bytes(px, photometric, compression=50000, codec=codec, **kw)


# --- the stored files ---------------------------------------------------------------


@pytest.mark.parametrize("name", STORED)
def test_stored_zstd_files_equal_pil_and_their_digests(name):
    with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
        data = fh.read()
    with open(IMAGE_FORMATS_REFERENCE) as fh:
        ref = json.load(fh)["files"][name]
    got = _same(data)
    assert hashlib.sha256(got.tobytes()).hexdigest() == ref["decoded_sha256"]


@pytest.mark.parametrize("name", ["fixture_zstd_pred2.tif", "fixture_zstd_tiles.tif"])
def test_the_zstd_fixtures_decode_to_the_pngs_pixels(name):
    """The strips hold the PNG's pixels; the 64x64 tiles its crop
    ZSTD_TILES_BOX, partial tiles at the right and bottom."""
    got = imagefile.read_image(os.path.join(IMAGE_FORMATS_DIR, name))
    if name == "fixture_zstd_tiles.tif":
        x0, y0, x1, y1 = ZSTD_TILES_BOX
        assert (x1 - x0) % 64 and (y1 - y0) % 64
        png = np.asarray(Image.open(IMAGE_FIXTURE).convert("RGBA"))
        np.testing.assert_array_equal(got, png[y0:y1, x0:x1])
        return
    with open(IMAGE_FIXTURE_REFERENCE) as fh:
        want = json.load(fh)["decoded_sha256"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want


def test_the_stored_frames_cover_the_levels_and_the_checksum():
    """libzstd's frames at levels 1, 3, 19 and 22 carry the checksum; PIL's
    (libtiff's level) do not; Predictors 1, 2 and 3 and tiles are stored."""
    seen = set()
    for name in STORED:
        with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
            data = fh.read()
        _o, _b, tags = tiff.read_ifd(data)
        desc = _strips(data)[0][4]
        seen |= {("checksum", bool(desc & 4)), ("predictor", tags.get(317, (1,))[0]),
                 ("tiled", 324 in tags)}
        for level in (1, 3, 19, 22):
            if name.startswith(f"zstd_l{level}_"):
                seen.add(("level", level))
    for want in [("checksum", True), ("checksum", False), ("predictor", 1), ("predictor", 2),
                 ("predictor", 3), ("tiled", True)] + [("level", v) for v in (1, 3, 19, 22)]:
        assert want in seen, want


# --- files PIL writes ---------------------------------------------------------------------


# (PIL mode, predictor): libtiff runs Predictor 2 on whole samples of 8 bits
# or more and Predictor 3 on floats
MODES = [(m, 1) for m in ("RGBA", "RGB", "L", "I;16", "F", "1", "P")] + [
    (m, 2) for m in ("RGBA", "RGB", "L", "I;16", "F")] + [("F", 3)]


@pytest.mark.parametrize("mode,predictor", MODES, ids=lambda v: str(v).replace(";", ""))
@pytest.mark.parametrize("rows", [1, 7, None], ids=["rps1", "rps7", "whole"])
def test_pil_written_files_equal_pil(mode, predictor, rows):
    px = _crop()
    if mode == "I;16":
        img = Image.fromarray(px[..., 0].astype(np.uint16) * 200 + 7)  # mode I;16
    elif mode == "F":
        img = Image.fromarray(px[..., 1].astype(np.float32) * 1.75 - 60.5)  # mode F
    else:
        img = Image.fromarray(px).convert(mode)
    info = {317: predictor}
    if rows:
        info[278] = rows
    _same(_pil_zstd(img, info))


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 70), st.integers(1, 40), st.integers(0, 2 ** 32 - 1),
       st.sampled_from([1, 2]))
def test_random_rgba_round_trip(w, h, seed, predictor):
    rng = np.random.default_rng(seed)
    px = (rng.integers(0, 4, (h, w, 4)) * rng.integers(1, 64)).astype(np.uint8)
    got = _same(_pil_zstd(Image.fromarray(px), {317: predictor, 278: max(1, h // 4)}))
    np.testing.assert_array_equal(got, px)


# --- frames built here ----------------------------------------------------------------------


@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("predictor", [1, 2])
def test_built_frames_in_strips_and_tiles_equal_pil(order, layout, predictor):
    """Raw-block frames behind the writer's strips and tiles, big- and
    little-endian, with and without Predictor 2 (16-bit RGB)."""
    px = _crop()[..., :3].astype(np.uint16) * 257
    kw = {"tile": (32, 16)} if layout == "tiles" else {"rows_per_strip": 9}
    if predictor == 2:
        from make_image_formats import _predict

        data = tiff_bytes(px, 2, order=order, compression=50000, predictor=2,
                          codec=lambda b: frame(_predict(b, 2, order).tobytes()), **kw)
    else:
        data = _framed(px, order=order, **kw)
    got = _same(data)
    np.testing.assert_array_equal(got[..., :3], (px >> 8).astype(np.uint8))


@pytest.mark.parametrize("form", [
    {"single": True}, {"single": True, "fcs_bytes": 2}, {"single": True, "fcs_bytes": 4},
    {"single": True, "fcs_bytes": 8}, {"single": False, "fcs_bytes": 0},
    {"single": False, "fcs_bytes": 4, "window_log": 20}, {"checksum": True},
    {"rle": True}, {"blocks": 1000}, {"blocks": 1000, "rle": True, "checksum": True}],
    ids=lambda f: "-".join(f"{k}{v}" for k, v in f.items()))
def test_frame_header_and_block_forms_equal_pil(form):
    px = _crop()[..., :3] // 32 * 32  # runs for the RLE blocks
    data = _framed(px, strip_frame=lambda raw: frame(raw, **form), rows_per_strip=16)
    got = _same(data)
    np.testing.assert_array_equal(got[..., :3], px)


def test_xxh64_known_values():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999


# --- what libtiff's ZSTDDecode makes of odd strips -----------------------------------------


def _one_strip(raw_frame, px) -> bytes:
    return tiff_bytes(px, 2, compression=50000, codec=lambda _b: raw_frame)


def _odd_frame(case: str, c: bytes) -> bytes:
    half = len(c) // 2
    if case == "two frames":
        return frame(c[:half]) + frame(c[half:])
    if case == "skippable frame first":
        return struct.pack("<II", 0x184D2A53, 3) + b"abc" + frame(c)
    if case == "truncated":
        return frame(c)[:-20]
    if case == "bad checksum":
        return frame(c, checksum=True)[:-1] + b"\x00"
    if case == "a dictionary":
        return frame(c, did=b"\x07")
    f = bytearray(frame(c))  # magic, descriptor, 2 content-size bytes, block header
    if case == "reserved bit":
        f[4] |= 8
    elif case == "reserved block type":
        f[7] |= 6
    elif case == "content size short of the blocks":
        f[5:7] = (int.from_bytes(f[5:7], "little") - 1).to_bytes(2, "little")
    elif case == "window over 2^27":
        return frame(c, single=False, fcs_bytes=0, window_log=28)
    elif case == "block over its maximum":
        return frame(c, single=False, fcs_bytes=0, window_log=10, blocks=1100)
    return bytes(f)


@pytest.mark.parametrize("case", ["two frames", "skippable frame first", "truncated",
                                  "bad checksum", "a dictionary", "reserved bit",
                                  "window over 2^27", "block over its maximum",
                                  "reserved block type", "content size short of the blocks"])
def test_strips_pil_fails_on_raise_value_error(case):
    """libtiff's ZSTDDecode decodes the first frame only (a second frame, or
    one after a skippable frame, is never reached and the strip comes out
    short: "Not enough data"), and fails on every fault libzstd reports."""
    px = _crop(61, 20)[..., :3]
    data = _one_strip(_odd_frame(case, px.tobytes()), px)
    with pytest.raises(OSError):
        _pil(data)
    with pytest.raises(ValueError):
        imagefile.decode_image(data)
    with pytest.raises(ValueError):
        tiff.decode_tiff(data, plain=True)


@pytest.mark.parametrize("case", ["bytes after the frame", "a skippable frame after",
                                  "a frame longer than the strip"])
def test_what_follows_the_strips_bytes_is_not_read(case):
    px = _crop(20, 6)[..., :3]
    c = px.tobytes()
    raw = {
        "bytes after the frame": frame(c) + b"\x01\x02 not a frame",
        "a skippable frame after": frame(c) + struct.pack("<II", 0x184D2A50, 2) + b"zz",
        "a frame longer than the strip": frame(c + bytes(4000), blocks=len(c)),
    }[case]
    got = _same(_one_strip(raw, px))
    np.testing.assert_array_equal(got[..., :3], px)


def test_truncated_and_corrupted_stored_files_raise_where_pil_raises():
    """Seeded cuts and bit flips of each stored file's first strip: where
    PIL raises, the port raises ValueError; where it reads, they agree."""
    rng = np.random.default_rng(8)
    agree = fails = 0
    for name in STORED:  # libzstd's frames carry a checksum, PIL's do not
        if name == "fixture_zstd_tiles.tif":
            continue
        with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
            data = bytearray(fh.read())
        first = _strips(bytes(data))[0]
        at = bytes(data).index(first)
        for _ in range(6):
            bad = bytearray(data)
            if rng.integers(2):
                cut = int(rng.integers(0, len(first)))
                bad[at + cut: at + len(first)] = bytes(len(first) - cut)
            else:
                bad[at + int(rng.integers(0, len(first)))] ^= 1 << int(rng.integers(8))
            try:
                want = _pil(bytes(bad))
            except OSError:
                fails += 1
                with pytest.raises(ValueError):
                    imagefile.decode_image(bytes(bad))
                continue
            np.testing.assert_array_equal(imagefile.decode_image(bytes(bad)), want)
            agree += 1
    assert fails and agree


# --- C++ against the plain twin -----------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_fd_zstd_decompress_equals_decompress_plain(seed):
    """Each stored strip whole, cut and with bits flipped, at its own size
    and at sizes short of it: the same bytes, or ValueError from both."""
    rng = np.random.default_rng(seed)
    for name in STORED[seed::4]:
        with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
            strips = _strips(fh.read())
        for s in strips[:4]:
            n = len(zstd.decompress(s, 1 << 24))
            for trial in range(12):
                bad = bytearray(s)
                if trial % 3 == 1:
                    bad = bad[: rng.integers(1, len(bad))]
                elif trial % 3 == 2:
                    for _ in range(rng.integers(1, 4)):
                        bad[rng.integers(0, len(bad))] ^= 1 << rng.integers(8)
                limit = n if trial < 6 else int(rng.integers(1, n + 1))
                out = []
                for fn in (zstd.decompress, zstd.decompress_plain):
                    try:
                        out.append(fn(bytes(bad), limit).tobytes())
                    except ValueError:
                        out.append(None)
                assert out[0] == out[1], (name, trial)


# --- against the JAX package -------------------------------------------------------------


@pytest.fixture
def zstd_copies(tmp_path):
    paths = []
    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub)
        paths.append(str(tmp_path / sub / os.path.basename(ZSTD_FIXTURE)))
        shutil.copyfile(ZSTD_FIXTURE, paths[-1])
    return paths


def test_load_image_gives_figdraw_tpus_image_mips_and_sidecar(zstd_copies):
    import figdraw_tpu.resources as jres
    from torch_reference import jax_flippy

    from figdraw_tpu_torch import resources

    port_path, jax_path = zstd_copies
    jax_flippy()
    bus, jbus = resources.ImageMessageBus(), jres.ImageMessageBus()
    sub, jsub = bus.subscribe(), jbus.subscribe()
    ref, jref = resources.load_image(port_path, bus=bus), jres.load_image(jax_path, bus=jbus)
    a = [m for m in sub.drain() if m.kind == resources.ImageMsgKind.PutImage][0]
    b = [m for m in jsub.drain() if m.kind == jres.ImageMsgKind.PutImage][0]
    np.testing.assert_array_equal(a.image, np.asarray(b.image))
    np.testing.assert_array_equal(a.image, np.asarray(Image.open(IMAGE_FIXTURE).convert("RGBA")))
    assert len(a.mips) == len(b.mips) == 10
    for x, y in zip(a.mips, b.mips):
        np.testing.assert_array_equal(x, np.asarray(y))
    with open(port_path + ".flippy", "rb") as fh, open(jax_path + ".flippy", "rb") as jfh:
        sidecar = fh.read()
        assert sidecar == jfh.read()
    with open(IMAGE_FORMATS_REFERENCE) as fh:
        assert hashlib.sha256(sidecar).hexdigest() == \
            json.load(fh)["sidecar"][os.path.basename(ZSTD_FIXTURE)]
    ref.close()
    jref.close()


def test_image_file_scene_from_zstd_matches_jax(zstd_copies):
    import figdraw_tpu_torch as port
    from torch_reference import block_means, jax_image_file_frame

    from figdraw_tpu_torch.scenes import ZSTD_FILE_REFERENCE, render_image_file

    port_path, jax_path = zstd_copies
    want = jax_image_file_frame(jax_path, "1x")
    _ren, frame_, ref = render_image_file(
        lambda ps: port.FigRenderer(atlas_size=512, device="cpu", pixel_scale=ps),
        port_path, "1x")
    got = frame_.numpy()
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(ZSTD_FILE_REFERENCE)
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1e-5
    ref.close()


def test_photo_wall_from_zstd_matches_jax(zstd_copies):
    import figdraw_tpu_torch as port
    from torch_reference import block_means, jax_photo_wall_frame

    from figdraw_tpu_torch import resources
    from figdraw_tpu_torch.scenes import (
        PHOTO_WALL_SMALL, ZSTD_WALL_REFERENCE, make_loaded_photo_wall,
    )

    port_path, jax_path = zstd_copies
    w, h, n = PHOTO_WALL_SMALL
    want = jax_photo_wall_frame(jax_path, w, h, n)
    ren = port.FigRenderer(atlas_size=512, device="cpu")
    bus = resources.ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    ref = resources.load_image(port_path, bus=bus)
    got = ren.render_frame(make_loaded_photo_wall(w, h, n, ref.id), port.vec2(w, h)).numpy()
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(ZSTD_WALL_REFERENCE)
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1e-5
    ref.close()


def test_unported_compressions_still_name_the_roadmap_item():
    data = _framed(_crop()[..., :3])
    bad = data.replace(struct.pack("<HHIH", 259, 3, 1, 50000),
                       struct.pack("<HHIH", 259, 3, 1, 50001))
    assert bad != data
    with pytest.raises(NotImplementedError, match=rf"WebP.*{ROADMAP_ITEM}"):
        imagefile.decode_image(bad)
