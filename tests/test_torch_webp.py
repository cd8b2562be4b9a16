"""The port's WebP reader (figdraw_tpu_torch/utils/webp.py, its C++ stages
in csrc/webp_decode.cpp) against PIL 12.1.0's `Image.open(...).convert("RGBA")`,
which reads every WebP through libwebp 1.6.0's WebPAnimDecoder, as
figdraw_tpu does: equal byte for byte on the stored files
(tools/make_image_formats.py: PIL's files and libwebp's own encoder for the
options PIL does not set) and on files built here; the stored set covering
each part of the decoder; the constant tables found whole in the libwebp
binary PIL links; each C++ stage against its plain twin; the container
(ICC and EXIF ignored, an animation's first frame on its canvas, alpha by
PIL's mode rules, padding, unknown chunks); a fuzz of truncations and byte
flips that returns an image or raises, and the corrupt files where the
port and PIL once parted (tools/webp_fuzz_agreement.py's cases, libwebp's
checks and leniency copied); what is not ported raising
NotImplementedError with the ROADMAP title, AVIF among it; load_image of
the lossy fixture against figdraw_tpu's (image, mips, sidecar) and its
frames against figdraw_tpu's block means."""

import hashlib
import io
import json
import os
import re
import shutil
import struct
import sys

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st
from PIL import Image

from figdraw_tpu_torch.scenes import (
    IMAGE_FIXTURE, IMAGE_FIXTURE_REFERENCE, IMAGE_FORMATS_DIR, IMAGE_FORMATS_REFERENCE,
    WEBP_FIXTURE,
)
from figdraw_tpu_torch.utils import image_lib, imagefile, webp, webp_tables
from torch_reference import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
from make_image_formats import (  # noqa: E402
    alpha_patterns, anim_bytes, libwebp_encode, riff, webp_chunks,
)
from make_webp_tables import TABLES, libwebp_path, read_tables  # noqa: E402

torch.set_num_threads(1)

ROADMAP_ITEM = "Image formats other than PNG"
STORED = sorted(n for n in os.listdir(IMAGE_FORMATS_DIR) if n.endswith(".webp"))
TABLES_HEADER = os.path.join(REPO, "figdraw_tpu_torch", "csrc", "webp_tables.h")


def _stored(name: str) -> bytes:
    with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
        return fh.read()


def _crop(w=61, h=47, alpha=None) -> np.ndarray:
    """RGBA of the fixture's detailed middle, alpha 255 or the pattern."""
    px = np.asarray(Image.open(IMAGE_FIXTURE).convert("RGBA"))[200: 200 + h, 300: 300 + w].copy()
    if alpha is not None:
        px[..., 3] = alpha_patterns(h, w)[alpha]
    return px


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _pil_webp(img, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, "WEBP", **kw)
    return b.getvalue()


def _same(data: bytes, plain: bool = True) -> np.ndarray:
    """The port's decode (and its plain twins') equals PIL's."""
    want = _pil(data)
    got = imagefile.decode_image(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if plain:
        np.testing.assert_array_equal(webp.decode_webp(data, plain=True), want)
    return got


# --- the stored files ------------------------------------------------------------


@pytest.mark.parametrize("name", STORED)
def test_stored_webps_equal_pil_and_their_digests(name):
    data = _stored(name)
    with open(IMAGE_FORMATS_REFERENCE) as fh:
        ref = json.load(fh)["files"][name]
    assert hashlib.sha256(data).hexdigest() == ref["sha256"]
    got = imagefile.read_image(os.path.join(IMAGE_FORMATS_DIR, name))
    assert hashlib.sha256(got.tobytes()).hexdigest() == ref["decoded_sha256"]
    assert list(got.shape) == ref["shape"]
    _same(data)


def test_the_stored_set_covers_the_decoder():
    """The stored files exercise every part the card is held to, and the
    libwebp options each file was written with took (read from its
    header): VP8 with the normal, simple and no loop filter, sharpness 7,
    one and four segments, one and eight token partitions, skipped
    macroblocks, every intra mode, odd sizes; ALPH raw and lossless with
    each of the four filters; VP8L with every transform, each pixel
    bundling, the colour cache, meta codes, all 14 predictors, simple
    codes and LZ77; an animation's offset first frame."""
    seen = {}

    def add(key, values):
        seen.setdefault(key, set()).update(values)

    for name in STORED:
        f = webp.features(_stored(name))
        add("codec", {f["codec"]})
        add("size", {f["box"][2:]})
        if f["box"][:2] != (0, 0):
            add("offset", {True})
        if f["alph"] is not None:
            add("alph", {f["alph"]})
        if "vp8" in f:
            v = f["vp8"]
            add("filter", {v["filter_type"]})
            add("sharpness", {v["sharpness"]})
            add("segments", {len(v["segments"])})
            add("partitions", {v["partitions"]})
            add("skipped", {v["skipped"] > 0})
            add("i16", v["i16"])
            add("b_pred", v["b_pred"])
            add("uv", v["uv"])
        if "vp8l" in f:
            u = f["vp8l"]
            add("transforms", u["transforms"])
            add("bundling", u["bundling"])
            add("cache", {bool(u["cache"])})
            add("meta", {u["meta"] > 0})
            add("predictors", u["predictors"])
            add("simple codes", {u["simple_codes"] > 0})
            add("copies", {u["copies"] > 0})
    want = {"codec": {"VP8", "VP8L"}, "filter": {0, 1, 2}, "sharpness": {7},
            "segments": {1, 4}, "partitions": {1, 8}, "skipped": {True},
            "i16": set(range(4)), "b_pred": set(range(10)), "uv": set(range(4)),
            "alph": {(0, 0), (1, 0), (1, 1), (1, 2), (1, 3)}, "transforms": set(range(4)),
            "bundling": set(range(4)), "cache": {True}, "meta": {True},
            "predictors": set(range(14)), "simple codes": {True}, "copies": {True},
            "size": {(1, 1), (17, 3)}, "offset": {True}}
    for key, values in want.items():
        assert values <= seen.get(key, set()), (key, values - seen.get(key, set()))
    # the options each libwebp file was written with
    hd = {n: webp.vp8_header(webp.read_frame(_stored(n)).stream) for n in STORED
          if n.startswith("vp8_")}
    assert hd["vp8_simple_filter.webp"]["filter_type"] == 1
    assert hd["vp8_no_filter.webp"]["level"] == 0
    assert hd["vp8_sharpness7.webp"]["sharpness"] == 7
    assert not hd["vp8_segments1.webp"]["segments"]
    assert webp.features(_stored("vp8_segments4.webp"))["vp8"]["segments"] == {0, 1, 2, 3}
    assert hd["vp8_partitions8.webp"]["partitions"] == 8
    assert webp.alpha_header(webp.read_frame(_stored("alph_raw.webp")).alph)[0] == 0


def test_lossless_fixture_equals_the_png():
    with open(IMAGE_FIXTURE_REFERENCE) as fh:
        want = json.load(fh)["decoded_sha256"]
    got = imagefile.read_image(os.path.join(IMAGE_FORMATS_DIR, "fixture_lossless.webp"))
    assert hashlib.sha256(got.tobytes()).hexdigest() == want
    np.testing.assert_array_equal(got, np.asarray(Image.open(IMAGE_FIXTURE).convert("RGBA")))


# --- the tables ------------------------------------------------------------------


def _binary() -> bytes:
    path = libwebp_path()
    if not path:
        pytest.skip("no libwebp beside PIL (pillow.libs/libwebp-*.so*) to find the tables in")
    with open(path, "rb") as fh:
        return fh.read()


def _header_tables() -> dict:
    """name -> flat values of each table in csrc/webp_tables.h."""
    with open(TABLES_HEADER) as fh:
        text = fh.read()
    out = {}
    for m in re.finditer(r"static const \w+ k(\w+)(?:\[\d+\])+ = \{([^}]*)\};", text):
        out[m.group(1)] = [int(v) for v in m.group(2).replace("\n", " ").split(",") if v.strip()]
    return out


@pytest.mark.parametrize("name", list(TABLES))
def test_tables_occur_whole_in_libwebp(name):
    """Each table of utils/webp_tables.py and csrc/webp_tables.h occurs
    whole in the libwebp binary PIL links: uint8 as stored, the AC table
    as little-endian uint16, the mode tree as int8."""
    binary = _binary()
    dtype = TABLES[name][0]
    values = getattr(webp_tables, name)
    assert values.dtype == np.dtype(dtype) and values.shape == TABLES[name][1]
    assert values.astype(np.dtype(dtype).newbyteorder("<")).tobytes() in binary
    header = np.array(_header_tables()[name], dtype)
    assert header.astype(np.dtype(dtype).newbyteorder("<")).tobytes() in binary
    np.testing.assert_array_equal(header, values.reshape(-1))
    np.testing.assert_array_equal(read_tables(binary)[name], values)


# --- the C++ stages against their plain twins ------------------------------------


@pytest.mark.parametrize("name", STORED)
def test_cpp_stages_equal_their_plain_twins(name):
    stages = set()
    for stage, got, want in webp.stage_pairs(_stored(name), max_pixels=10 ** 6):
        np.testing.assert_array_equal(got, want, err_msg=stage)
        stages.add(stage)
    assert stages


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shape", [(48, 64), (47, 61), (1, 1), (2, 3), (17, 4)])
def test_upsample_equals_upsample_plain(shape, seed):
    """Random planes of even and odd sizes (the first and last rows and
    columns, one-pixel planes)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    y = rng.integers(0, 256, (h, w), np.uint8)
    u = rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), np.uint8)
    v = rng.integers(0, 256, u.shape, np.uint8)
    np.testing.assert_array_equal(webp.upsample(y, u, v), webp.upsample_plain(y, u, v))


@pytest.mark.parametrize("filt", range(4))
@pytest.mark.parametrize("seed", range(3))
def test_alpha_unfilter_equals_alpha_unfilter_plain(filt, seed):
    rng = np.random.default_rng(seed)
    deltas = rng.integers(0, 256, (48, 64), np.uint8)
    deltas[::5] = rng.integers(0, 4, (10, 64))
    np.testing.assert_array_equal(webp.alpha_unfilter(deltas, filt),
                                  webp.alpha_unfilter_plain(deltas, filt))


@pytest.mark.parametrize("opts", [
    {"quality": 100, "method": 6}, {"quality": 30, "filter_type": 0},
    {"quality": 70, "segments": 2, "filter_sharpness": 3},
    {"quality": 90, "partitions": 2, "method": 0}, {"quality": 60, "sns_strength": 0}],
    ids=lambda o: "-".join(f"{k}{v}" for k, v in o.items()))
def test_libwebp_lossy_options_equal_pil(opts):
    """Files of libwebp's encoder at options PIL's save does not set, on a
    64x160 crop (ten macroblock rows), through both decoders."""
    px = np.asarray(Image.open(IMAGE_FIXTURE).convert("RGBA"))[100:260, 300:364]
    _same(libwebp_encode(np.ascontiguousarray(px), **opts))


@pytest.mark.parametrize("seed", range(3))
def test_noisy_lossy_and_lossless_equal_pil(seed):
    """Seeded noise on the fixture: large coefficients, every token
    category, and lossless streams without transforms."""
    rng = np.random.default_rng(seed)
    base = _crop(64, 48).astype(int)
    noisy = np.clip(base + rng.integers(-60, 61, base.shape), 0, 255).astype(np.uint8)
    noisy[..., 3] = 255
    img = Image.fromarray(noisy).convert("RGB")
    for q in (5, 75, 100):
        _same(_pil_webp(img, quality=q))
    noisy[..., 3] = rng.integers(0, 256, noisy.shape[:2])
    _same(_pil_webp(Image.fromarray(noisy), quality=80))
    _same(_pil_webp(Image.fromarray(noisy), lossless=True))


# --- the container ---------------------------------------------------------------


def test_icc_and_exif_are_ignored():
    """PIL applies neither a WebP's ICC profile nor its EXIF orientation
    (WebPImageFile.load calls no exif_transpose): the pixels of the file
    without them."""
    from PIL import ImageCms

    profile = ImageCms.ImageCmsProfile(ImageCms.createProfile("LAB")).tobytes()
    exif = Image.Exif()
    exif[0x0112] = 6
    img = Image.fromarray(_crop()).convert("RGB")
    data = _pil_webp(img, quality=80, icc_profile=profile, exif=exif.tobytes())
    assert {b"ICCP", b"EXIF"} <= {t for t, _d in webp_chunks(data)}
    got = _same(data)
    np.testing.assert_array_equal(got, _pil(_pil_webp(img, quality=80)))


def test_rgb_files_read_alpha_255():
    """A simple VP8 file opens as PIL's "RGB"; a VP8X file without the alpha
    flag drops its ALPH chunk (libwebp's demuxer), and one with the flag
    and no ALPH reads opaque."""
    data = _pil_webp(Image.fromarray(_crop()).convert("RGB"), quality=80)
    assert webp.read_frame(data).codec == "VP8" and _same(data)[..., 3].min() == 255
    alpha = _pil_webp(Image.fromarray(_crop(alpha="blobs")), quality=80)
    chunks = webp_chunks(alpha)
    assert [t for t, _d in chunks] == [b"VP8X", b"ALPH", b"VP8 "]
    no_flag = riff([(b"VP8X", bytes([0]) + chunks[0][1][1:])] + chunks[1:])
    assert _same(no_flag)[..., 3].min() == 255
    flag_only = riff([chunks[0], chunks[2]])
    assert _same(flag_only)[..., 3].min() == 255


def test_unknown_and_odd_chunks_are_skipped():
    """An odd-sized unknown chunk (padded) and an XMP chunk before the image,
    and trailing chunks after it."""
    chunks = webp_chunks(_pil_webp(Image.fromarray(_crop(alpha="wave")), quality=70))
    data = riff([chunks[0], (b"XMP ", b"<x/>"), (b"ZZZZ", b"odd"), *chunks[1:],
                 (b"ZZZY", b"12345")])
    _same(data)


@pytest.mark.parametrize("alpha_flag", [True, False])
@pytest.mark.parametrize("first", ["lossy", "lossy alpha", "lossless"])
def test_animation_first_frame_on_its_canvas(first, alpha_flag):
    """The first ANMF frame, smaller than the canvas, at its offset on
    transparent black; the ANIM background and the frame's blend and
    dispose bits do not touch it; without the VP8X alpha flag PIL opens
    "RGB" and every alpha reads 255."""
    crop = _crop(alpha="blobs")
    sub = Image.fromarray(crop[6:36, 10:50])
    still = {"lossy": _pil_webp(sub.convert("RGB"), quality=60),
             "lossy alpha": _pil_webp(sub, quality=60),
             "lossless": _pil_webp(sub, lossless=True)}[first]
    second = _pil_webp(Image.fromarray(crop), lossless=True)
    for bits in (0, 1, 2, 3):
        data = anim_bytes((61, 47), [(10, 6, still, 80, bits), (0, 0, second, 80, 0)],
                          alpha=alpha_flag, background=(255, 0, 128, 255))
        got = _same(data)
        f = webp.read_frame(data)
        assert f.box == (10, 6, 40, 30) and f.canvas == (61, 47)
        if alpha_flag:
            assert not got[:6].any() and not got[:, :10].any()


def test_pil_written_animation_equals_pil():
    frames = [Image.fromarray(_crop(alpha="wave")), Image.fromarray(_crop()[::-1].copy())]
    b = io.BytesIO()
    frames[0].save(b, "WEBP", save_all=True, append_images=frames[1:], quality=60)
    _same(b.getvalue())


# --- corrupt streams -------------------------------------------------------------

FUZZ_FILES = [n for n in STORED if len(_stored(n)) < 6000]


@settings(max_examples=400, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.sampled_from(FUZZ_FILES), st.integers(0, 2), st.integers(0, 10 ** 9),
       st.lists(st.tuples(st.integers(0, 10 ** 9), st.integers(0, 7)), min_size=1,
                max_size=3))
def test_truncated_or_flipped_streams_return_or_raise(name, kind, cut, flips):
    """A truncation or one to three bit flips of a stored file: the C++ path
    returns (H, W, 4) uint8 or raises ValueError or NotImplementedError,
    and the process lives. PIL may answer otherwise on a corrupt stream:
    its agreement is recorded, not asserted."""
    data = bytearray(_stored(name))
    if kind == 0:
        data = data[: cut % len(data)]
    else:
        for at, bit in flips:
            data[at % len(data)] ^= 1 << bit
    try:
        got = imagefile.decode_image(bytes(data))
    except (ValueError, NotImplementedError):
        return
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 4


# the corrupt files on which tools/webp_fuzz_agreement.py (its default seeds)
# found the port and PIL parting before libwebp's checks were copied:
# (seed, index, what libwebp does)
WEBP_FUZZ_CASES = [
    (0, 224, "the demuxer checks every ANMF frame: a later one off the canvas"),
    (0, 1525, "DecodeAlphaData: the last alpha symbols read past the end"),
    (0, 2111, "DecodeAlphaData: the last alpha symbols read past the end"),
    (2, 375, "DecodeAlphaData: the last alpha symbols read past the end"),
    (2, 747, "DecodeAlphaData: the last alpha symbols read past the end"),
    (2, 1866, "DecodeAlphaData: the last alpha symbols read past the end"),
    (2, 1867, "the demuxer checks every ANMF frame: a later one off the canvas"),
    (2, 2177, "StoreFrame takes a frame's size from its bitstream, not its ANMF box"),
    (2, 2921, "the demuxer checks every ANMF frame: a later one of VP8L version 2"),
]


@pytest.mark.parametrize("case", WEBP_FUZZ_CASES, ids=[f"seed{c[0]}-{c[1]}" for c in WEBP_FUZZ_CASES])
def test_fuzz_cases_equal_pil(case):
    """Each case rebuilt from its seed and index: the port (C++ and plain)
    gives PIL's image byte for byte, or raises where PIL fails."""
    import webp_fuzz_agreement

    seed, index, _why = case
    _name, data = webp_fuzz_agreement.case(seed, index)
    want = webp_fuzz_agreement.pil_result(data)
    if want is None:
        for plain in (False, True):
            with pytest.raises(ValueError):
                webp.decode_webp(data, plain=plain)
        with pytest.raises(ValueError):
            imagefile.decode_image(data)
    else:
        _same(data)


def test_alpha_stream_read_past_its_end():
    """An ALPH chunk of colour indices (libwebp's DecodeAlphaData) whose
    last symbols are read past its end decodes as PIL does; cut by a few
    more bytes, the C++ and plain alpha decoders agree, on a plane or a
    failure."""
    import webp_fuzz_agreement

    _name, data = webp_fuzz_agreement.case(0, 1525)
    f = webp.read_frame(data)
    assert f.alph is not None and webp.alpha_header(f.alph)[0] == 1
    assert webp.features(data)["vp8l"]["transforms"] == {3}  # colour indexing alone
    _same(data)
    w, h = f.box[2], f.box[3]
    for cut in range(1, 12):
        got = []
        for plain in (False, True):
            try:
                got.append(webp.decode_alpha(f.alph[: len(f.alph) - cut], w, h, plain=plain))
            except ValueError:
                got.append(None)
        assert (got[0] is None) == (got[1] is None), cut
        if got[0] is not None:
            np.testing.assert_array_equal(got[0], got[1])


# --- what is not ported, and the dispatch ----------------------------------------


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(data)
    return path


def test_inter_frame_raises_not_implemented(tmp_path):
    data = bytearray(_pil_webp(Image.fromarray(_crop()).convert("RGB"), quality=80))
    data[20] |= 1  # the frame tag's key-frame bit: an inter frame
    path = _write(tmp_path, "inter.webp", bytes(data))
    with pytest.raises(NotImplementedError, match=r"inter frame.*inter\.webp"):
        imagefile.read_image(path)


def test_vp8l_version_raises_not_implemented(tmp_path):
    data = bytearray(_pil_webp(Image.fromarray(_crop()), lossless=True))
    data[24] |= 0x20  # the version bits of the VP8L header
    path = _write(tmp_path, "v1.webp", bytes(data))
    with pytest.raises(NotImplementedError, match=r"VP8L version 1.*v1\.webp"):
        imagefile.read_image(path)


@pytest.mark.parametrize("method", [2, 3])
def test_unknown_alph_compression_raises_not_implemented(method, tmp_path):
    chunks = webp_chunks(_pil_webp(Image.fromarray(_crop(alpha="blobs")), quality=80))
    alph = bytes([(chunks[1][1][0] & ~3) | method]) + chunks[1][1][1:]
    path = _write(tmp_path, "alph.webp", riff([chunks[0], (b"ALPH", alph), chunks[2]]))
    with pytest.raises(NotImplementedError, match=rf"ALPH compression {method}.*alph\.webp"):
        imagefile.read_image(path)


def test_avif_raises_not_implemented_naming_it(tmp_path):
    """An AVIF outside the port's slice (an image sequence, which PIL's
    save_all writes, whose tracks' size is 3/4 of its frames': libyuv's 3/4
    filter is not ported; the slice is tests/test_torch_avif.py's):
    NotImplementedError naming AVIF, the feature, the path and the ROADMAP
    item, never ValueError."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_image_formats import with_track_size

    path = str(tmp_path / "photo.avif")
    out = io.BytesIO()
    Image.fromarray(_crop(16, 16)).save(out, "AVIF", save_all=True,
                                        append_images=[Image.fromarray(_crop(16, 16)[::-1].copy())])
    with open(path, "wb") as fh:
        fh.write(with_track_size(out.getvalue(), 12, 12))
    with open(path, "rb") as fh:
        assert imagefile.format_of(fh.read()) == "AVIF"
    with pytest.raises(NotImplementedError,
                       match=rf"AVIF images with an AV1 frame of another size than ispe "
                             rf".*photo\.avif.*{ROADMAP_ITEM}"):
        imagefile.read_image(path)
    # an avif brand among the compatible ones only
    head = struct.pack(">I", 24) + b"ftypmif1" + b"\0\0\0\0" + b"mif1avif"
    assert imagefile.format_of(head + b"\0" * 16) == "AVIF"
    assert imagefile.format_of(struct.pack(">I", 20) + b"ftypisom\0\0\0\0mp41") == ""


@pytest.mark.parametrize("form", [b"AVI ", b"WAVE"])
def test_other_riff_files_are_no_image(form):
    data = b"RIFF" + struct.pack("<I", 16) + form + b"LIST" + struct.pack("<I", 4) + b"abcd"
    assert imagefile.format_of(data) == ""
    with pytest.raises(ValueError, match="not an image file .*WebP"):
        imagefile.decode_image(data)


def test_malformed_containers_raise_value_error():
    good = _stored("lossy_q50_m0.webp")
    for bad in (good[:11], good[:20], b"RIFF" + struct.pack("<I", 4) + b"WEBP",
                good[:4] + struct.pack("<I", len(good) + 10) + good[8:],
                riff([(b"ANIM", bytes(6))]),
                riff([(b"VP8X", bytes([0x02, 0, 0, 0]) + bytes(6)), (b"ANIM", bytes(6))])):
        with pytest.raises(ValueError):
            imagefile.decode_image(bad)


def test_read_image_never_calls_pil(tmp_path, monkeypatch):
    names = ("anim_offset_first.webp", "alpha_aq30.webp", "lossless_exact.webp")
    wants = {n: _pil(_stored(n)) for n in names}
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, name, None)
    for n in names:
        np.testing.assert_array_equal(
            imagefile.read_image(os.path.join(IMAGE_FORMATS_DIR, n)), wants[n])


def test_a_failed_build_raises(monkeypatch):
    """The C++ WebP library does not build: the decode raises, never runs
    the plain twins."""
    import subprocess

    from figdraw_tpu_torch.utils import gxx

    def broken(*_a, **_k):
        raise subprocess.CalledProcessError(1, ["g++"], "", "error")

    monkeypatch.setattr(image_lib, "_webp", None)
    monkeypatch.setattr(gxx, "build", broken)
    with pytest.raises(subprocess.CalledProcessError):
        imagefile.decode_image(_stored("lossy_q50_m0.webp"))


# --- against the JAX package: load_image, the sidecar and the frames ----------------


@pytest.fixture
def webp_copies(tmp_path):
    """The stored lossy fixture copied twice (each package writes its own
    sidecar beside its file)."""
    paths = []
    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub)
        paths.append(str(tmp_path / sub / os.path.basename(WEBP_FIXTURE)))
        shutil.copyfile(WEBP_FIXTURE, paths[-1])
    return paths


def test_load_image_gives_figdraw_tpus_image_mips_and_sidecar(webp_copies):
    """Cold (decode, bleed, chain, sidecar) and warm (the sidecar) in both
    packages: the same pixels, mips and sidecar bytes, whose digest
    chip_smoke.py holds the card to."""
    import figdraw_tpu.resources as jres
    from torch_reference import jax_flippy

    from figdraw_tpu_torch import resources

    port_path, jax_path = webp_copies
    jax_flippy()
    bus, jbus = resources.ImageMessageBus(), jres.ImageMessageBus()
    sub, jsub = bus.subscribe(), jbus.subscribe()
    for _ in range(2):
        ref, jref = resources.load_image(port_path, bus=bus), jres.load_image(jax_path, bus=jbus)
        a = [m for m in sub.drain() if m.kind == resources.ImageMsgKind.PutImage][0]
        b = [m for m in jsub.drain() if m.kind == jres.ImageMsgKind.PutImage][0]
        np.testing.assert_array_equal(a.image, np.asarray(b.image))
        np.testing.assert_array_equal(a.image, _pil(_stored(os.path.basename(WEBP_FIXTURE))))
        assert len(a.mips) == len(b.mips) == 10
        for x, y in zip(a.mips, b.mips):
            np.testing.assert_array_equal(x, np.asarray(y))
        with open(port_path + ".flippy", "rb") as fh, open(jax_path + ".flippy", "rb") as jfh:
            sidecar = fh.read()
            assert sidecar == jfh.read()
        with open(IMAGE_FORMATS_REFERENCE) as fh:
            want = json.load(fh)["sidecar"][os.path.basename(WEBP_FIXTURE)]
        assert hashlib.sha256(sidecar).hexdigest() == want
        ref.close()
        jref.close()
        resources.clear_image_cache(bus=bus)
        jres.clear_image_cache(bus=jbus)


def test_image_file_scene_from_webp_matches_jax(webp_copies):
    """The image-file scene with the WebP loaded: within 1e-5 of
    figdraw_tpu's block means, which the stored reference holds (chip_smoke.py
    holds the card to it), and within 1/255 of its frame."""
    import figdraw_tpu_torch as port
    from torch_reference import block_means, jax_image_file_frame

    from figdraw_tpu_torch.scenes import WEBP_FILE_REFERENCE, render_image_file

    port_path, jax_path = webp_copies
    want = jax_image_file_frame(jax_path, "1x")
    _ren, frame, ref = render_image_file(
        lambda ps: port.FigRenderer(atlas_size=512, device="cpu", pixel_scale=ps),
        port_path, "1x")
    got = frame.numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(WEBP_FILE_REFERENCE)
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1e-5
    ref.close()


def test_photo_wall_from_webp_matches_jax(webp_copies):
    import figdraw_tpu_torch as port
    from torch_reference import block_means, jax_photo_wall_frame

    from figdraw_tpu_torch import resources
    from figdraw_tpu_torch.scenes import (
        PHOTO_WALL_SMALL, WEBP_WALL_REFERENCE, make_loaded_photo_wall,
    )

    port_path, jax_path = webp_copies
    w, h, n = PHOTO_WALL_SMALL
    want = jax_photo_wall_frame(jax_path, w, h, n)
    ren = port.FigRenderer(atlas_size=512, device="cpu")
    bus = resources.ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    ref = resources.load_image(port_path, bus=bus)
    got = ren.render_frame(make_loaded_photo_wall(w, h, n, ref.id), port.vec2(w, h)).numpy()
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(WEBP_WALL_REFERENCE)
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1e-5
    ref.close()
