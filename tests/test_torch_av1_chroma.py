"""The port's AVIF reader on 4:4:4 (AV1 profile 1) and 4:2:2 (profile 2)
chroma and on every matrix and range libavif 1.3.0 converts at 8 bits,
against PIL 12.1.0 (which reads AVIF through libavif and dav1d, as
figdraw_tpu does): PIL-written files of 1x1 to 300x300 at speeds 0-10,
with and without alpha, full and limited range, with aom's CDEF, loop
restoration, palettes and intra block copy, equal byte for byte; files
whose colr box names each matrix (and, for matrix 12, each primaries)
equal to PIL or, where libavif fails ("Reformat failed"), refused with
ValueError; fd_av1_to_rgb and to_rgba_plain equal to libavif's own
avifImageYUVToRGB (PIL's libavif, through ctypes) on seeded planes of
each format, matrix and range, with and without alpha; the chroma
stages of 4:2:2 and 4:4:4 (CDEF's 4x8 and 8x8 chroma blocks and its
4:2:2 direction map, loop restoration at ssy 0) equal to their twins
through the stage trace and alone; av1C's and pixi's fields held to
each other as libavif holds them; and dav1d's rejection of the 4:2:2
partitions whose chroma block has no size."""

import ctypes
import io
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from figdraw_tpu_torch.scenes import AVIF_422_FIXTURE, AVIF_444_FIXTURE, IMAGE_FIXTURE
from figdraw_tpu_torch.utils import av1, avif, image_lib, imagefile
from torch_reference import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
import avif_fuzz_agreement as fuzz  # noqa: E402

torch.set_num_threads(1)

CDEF = {"enable-cdef": "1"}


def _fixture() -> np.ndarray:
    return np.asarray(Image.open(IMAGE_FIXTURE).convert("RGB"))


def _pil_avif(px: np.ndarray, **kw) -> bytes:
    out = io.BytesIO()
    Image.fromarray(px).save(out, "AVIF", **kw)
    return out.getvalue()


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _same(data: bytes) -> np.ndarray:
    want = _pil(data)
    got = imagefile.decode_image(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def _picture(w: int, h: int, seed: int, alpha: bool) -> np.ndarray:
    """A crop of the fixture (even seeds) or seeded noise, with a seeded
    alpha gradient."""
    rng = np.random.default_rng(seed)
    if seed % 2 == 0:
        fix = _fixture()
        y, x = int(rng.integers(0, 600 - h + 1)), int(rng.integers(0, 800 - w + 1))
        px = fix[y:y + h, x:x + w]
    else:
        px = rng.integers(0, 256, (h, w, 3), np.uint8)
    if alpha:
        a = (np.add.outer(np.arange(h) * 3, np.arange(w) * 5) + int(rng.integers(256))) % 256
        px = np.dstack([px, a.astype(np.uint8)])
    return np.ascontiguousarray(px)


def _grain(w: int, h: int) -> np.ndarray:
    """A gradient under seeded noise, which aom restores with Wiener and
    self-guided units at speed 2 in every format."""
    gy, gx = np.mgrid[0:h, 0:w]
    base = np.dstack([gx * 200 / w + 30, gy * 200 / h + 20, (gx + gy) * 100 / (w + h) + 80])
    return np.clip(base + np.random.default_rng(w).normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)


def _flat_ui() -> np.ndarray:
    ui = np.full((240, 320, 3), 245, np.uint8)
    ui[20:60, 20:300] = (30, 90, 200)
    ui[80:200, 40:150] = (220, 50, 50)
    ui[100:180, 180:290] = (40, 160, 70)
    ui[210:225, 20:300] = (10, 10, 10)
    return ui


def _tiles(w: int, h: int) -> np.ndarray:
    icon = np.random.default_rng(3).integers(0, 2, (12, 12)) * 200 + 20
    img = np.full((h, w, 3), 240, np.uint8)
    for y in range(8, h - 16, 20):
        for x in range(8, w - 16, 20):
            img[y:y + 12, x:x + 12] = icon[..., None]
    return img


# --- PIL-written files -------------------------------------------------------------

# (subsampling, width, height, speed, alpha, range, CDEF): odd and even
# sizes from 1x1 to 300x300, every speed, each format at both ranges
SIZES = [(1, 1), (2, 3), (17, 9), (3, 61), (33, 65), (64, 64), (65, 65), (127, 31), (130, 96),
         (257, 129), (300, 300), (299, 1), (1, 257), (200, 151)]
CORPUS = [(sub, w, h, (k * 3 + j) % 11, (k + j) % 3 == 0, ("full", "limited")[(k + j) % 2],
           (k + 2 * j) % 4 == 0)
          for j, sub in enumerate(("4:4:4", "4:2:2")) for k, (w, h) in enumerate(SIZES)]


def _corpus_id(case) -> str:
    sub, w, h, speed, alpha, rng, cdef = case
    return f"{sub}:{w}x{h}:s{speed}{':alpha' if alpha else ''}:{rng}{':cdef' if cdef else ''}"


@pytest.mark.parametrize("case", CORPUS, ids=[_corpus_id(c) for c in CORPUS])
def test_chroma_corpus_equals_pil(case):
    sub, w, h, speed, alpha, rng, cdef = case
    px = _picture(w, h, w * 1000 + h, alpha)
    data = _pil_avif(px, subsampling=sub, speed=speed, range=rng,
                     advanced=CDEF if cdef else {"enable-cdef": "0"})
    still = avif.parse(data)
    assert still.av1c[0] == (1 if sub == "4:4:4" else 2)
    assert _same(data).shape == (h, w, 4)


@pytest.mark.parametrize("sub", ["4:4:4", "4:2:2"])
@pytest.mark.parametrize("kind", ["ui:0", "ui:6", "icons:5", "icons:6", "icons:7", "grain:2"])
def test_screen_content_and_restoration_equal_pil(kind, sub):
    """Screen content (palettes on the flat UI picture, intra block copy on
    the icon grid, whose blocks are copies of earlier ones) and a noisy
    gradient that aom restores with CDEF, Wiener and self-guided units."""
    name, speed = kind.split(":")
    px = {"ui": _flat_ui, "icons": lambda: _tiles(257, 131), "grain": lambda: _grain(201, 77)}[name]()
    kw = {"advanced": CDEF} if name == "grain" else {}
    data = _pil_avif(px, subsampling=sub, speed=int(speed), **kw)
    _same(data)
    frame = av1.decode(avif.parse(data).color)
    if name == "icons":
        assert frame.mi[..., av1.M_INTER].sum() > 0
    if name == "grain":
        assert (frame.cdef >= 0).any() and frame.lr[1:, :, av1.L_TYPE].any()


# --- the colour description ------------------------------------------------------

FORMATS = {"4:4:4": (0, 0, 0), "4:2:2": (1, 0, 0), "4:2:0": (1, 1, 0), "4:0:0": (1, 1, 1)}
# the nclx matrices probed: libavif converts 1, 2, 4-7, 9, 12 and 15 at both
# ranges, 8 (YCgCo) at full range, 0 (identity) in 4:4:4 and 4:0:0, and
# fails on 3, 10, 11, 13, 14 and past 15
MATRICES = list(range(17)) + [255]
# the primaries matrix 12 derives its coefficients from (1, 5, 6, 9 reach
# libyuv's constants, the others libavif's float conversion)
PRIMARIES_12 = (1, 4, 5, 6, 7, 9, 10, 11, 12, 22)


def _with_nclx(data: bytes, primaries: int, matrix: int, full: int) -> bytes:
    at = data.find(b"nclx")
    return (data[:at + 4] + primaries.to_bytes(2, "big") + data[at + 6:at + 8]
            + matrix.to_bytes(2, "big") + bytes([0x80 if full else 0]) + data[at + 11:])


@pytest.mark.parametrize("full", [1, 0], ids=["full", "limited"])
@pytest.mark.parametrize("sub", sorted(FORMATS))
def test_every_nclx_matrix_equals_pil_or_both_raise(sub, full):
    """One file of each format with its colr box patched to each matrix
    and range (and matrix 12 to each primaries): equal to PIL where
    libavif converts, ValueError where it fails. 4:0:0 with alpha takes
    libyuv's limited-range constants, without alpha libavif's grey."""
    alpha = sub in ("4:2:2", "4:0:0")
    src = _pil_avif(_picture(37, 23, 4, alpha), subsampling=sub, speed=8)
    converted = failed = 0
    for matrix in MATRICES:
        for primaries in (PRIMARIES_12 if matrix == 12 else (1,)):
            data = _with_nclx(src, primaries, matrix, full)
            try:
                want = _pil(data)
            except Exception:  # noqa: BLE001 - libavif's "Reformat failed"
                with pytest.raises(ValueError, match="Reformat failed"):
                    imagefile.decode_image(data)
                failed += 1
                continue
            np.testing.assert_array_equal(imagefile.decode_image(data), want,
                                          err_msg=f"matrix {matrix} primaries {primaries}")
            converted += 1
    assert converted >= 9 + len(PRIMARIES_12) - 1 and failed >= 7


def _libavif():
    try:
        lib = fuzz.libavif()
    except FileNotFoundError:
        pytest.skip("no libavif beside PIL on this host")
    lib.avifImageCreate.restype = ctypes.c_void_p
    lib.avifImageCreate.argtypes = [ctypes.c_uint32] * 3 + [ctypes.c_int]
    lib.avifImageAllocatePlanes.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.avifImageDestroy.argtypes = [ctypes.c_void_p]
    lib.avifRGBImageSetDefaults.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.avifRGBImageAllocatePixels.argtypes = [ctypes.c_void_p]
    lib.avifRGBImageFreePixels.argtypes = [ctypes.c_void_p]
    lib.avifImageYUVToRGB.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.avifColorPrimariesGetValues.argtypes = [ctypes.c_uint16, ctypes.c_void_p]
    return lib


def _word(addr: int, off: int, n: int = 4) -> int:
    return int.from_bytes(bytes((ctypes.c_uint8 * n).from_address(addr + off)), "little")


def _put(addr: int, off: int, value: int, n: int = 4) -> None:
    ctypes.memmove(addr + off, int(value).to_bytes(n, "little", signed=value < 0), n)


def _avif_yuv_to_rgb(lib, planes, alpha, fmt: str, full: int, matrix: int, primaries: int,
                     depth: int = 8):
    """libavif 1.3.0's avifImageYUVToRGB as PIL calls it (avifRGBImage
    defaults, 8 bits, RGBA where there is alpha, else RGB) on an image of
    `depth` bits (uint16 samples past 8): the RGBA image or None where it
    fails. avifImage: width, height, depth, format, range (byte 16), the
    plane pointers at 24 and their row bytes at 48, alpha's at 64 and 72,
    primaries and matrix as uint16 at 104 and 108; avifRGBImage: depth at
    8, format at 12, pixels at 48, row bytes at 56."""
    y = planes[0]
    h, w = y.shape
    code = {"4:4:4": 1, "4:2:2": 2, "4:2:0": 3, "4:0:0": 4}[fmt]
    img = lib.avifImageCreate(w, h, depth, code)
    assert lib.avifImageAllocatePlanes(img, 1 | (2 if alpha is not None else 0)) == 0
    _put(img, 16, full)
    _put(img, 104, primaries, 2)
    _put(img, 108, matrix, 2)
    for k, p in enumerate(planes + ([alpha] if alpha is not None else [])):
        at_ptr, at_stride = (64, 72) if k == len(planes) else (24 + 8 * k, 48 + 4 * k)
        ptr, stride = _word(img, at_ptr, 8), _word(img, at_stride)
        p = np.ascontiguousarray(p, np.uint8 if depth == 8 else np.uint16)
        for r in range(p.shape[0]):
            ctypes.memmove(ptr + r * stride, p[r].ctypes.data, p.shape[1] * p.itemsize)
    rgb = ctypes.create_string_buffer(256)
    at = ctypes.addressof(rgb)
    lib.avifRGBImageSetDefaults(at, img)
    channels = 4 if alpha is not None else 3
    _put(at, 8, 8)
    _put(at, 12, 1 if alpha is not None else 0)
    assert lib.avifRGBImageAllocatePixels(at) == 0
    out = None
    if lib.avifImageYUVToRGB(img, at) == 0:
        ptr, stride = _word(at, 48, 8), _word(at, 56)
        raw = np.frombuffer(bytes((ctypes.c_uint8 * (stride * h)).from_address(ptr)), np.uint8)
        out = raw.reshape(h, stride)[:, :w * channels].reshape(h, w, channels)
        if channels == 3:
            out = np.dstack([out, np.full((h, w), 255, np.uint8)])
    lib.avifRGBImageFreePixels(at)
    lib.avifImageDestroy(img)
    return out


def test_primaries_table_is_libavifs():
    """PRIMARIES_XY (and BT.709's for the rest) as avifColorPrimariesGetValues
    gives them, to the float; matrix 12's kr and kb follow from them."""
    lib = _libavif()
    for p in list(range(0, 24)) + [255, 1000]:
        buf = (ctypes.c_float * 8)()
        lib.avifColorPrimariesGetValues(p, buf)
        want = np.array(av1.PRIMARIES_XY.get(p, av1.BT709_XY), np.float32)
        np.testing.assert_array_equal(np.array(list(buf), np.float32), want, err_msg=str(p))


@pytest.mark.parametrize("full", [1, 0], ids=["full", "limited"])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_to_rgb_and_its_twin_equal_libavifs_conversion(fmt, full):
    """fd_av1_to_rgb and to_rgba_plain against avifImageYUVToRGB on seeded
    planes (odd and even sizes from 1x1, padded as decoded) for every
    matrix, matrix 12's primaries, with and without alpha: equal where
    libavif converts, and `conversion` raises ValueError where it fails."""
    lib = _libavif()
    av1lib = image_lib.load_av1()
    ssx, ssy, mono = FORMATS[fmt]
    rng = np.random.default_rng(len(fmt) * 7 + full)
    null = ctypes.c_void_p(0)
    routes = set()
    for matrix in MATRICES:
        for primaries in (PRIMARIES_12 if matrix == 12 else (2,)):
            h, w = (int(v) for v in rng.integers(1, 30, 2))
            y = rng.integers(0, 256, (h, w), np.uint8)
            cshape = ((h + ssy) >> ssy, (w + ssx) >> ssx)
            u, v = (rng.integers(0, 256, cshape, np.uint8) for _ in range(2))
            for alpha in (None, rng.integers(0, 256, (h, w), np.uint8)):
                want = _avif_yuv_to_rgb(lib, [y] if mono else [y, u, v], alpha, fmt, full,
                                        matrix, primaries)
                if want is None:
                    with pytest.raises(ValueError, match="Reformat failed"):
                        av1.conversion(mono, ssx, ssy, full, matrix, primaries, alpha is not None)
                    continue
                conv = av1.conversion(mono, ssx, ssy, full, matrix, primaries, alpha is not None)
                routes.add(int(conv[av1.C_ROUTE]))

                def pad(p):
                    return np.ascontiguousarray(np.pad(p, ((0, 3), (0, 5))))
                yp = pad(y)
                up, vp = (None, None) if mono else (pad(u), pad(v))
                out = np.zeros((h, w, 4), np.uint8)
                rc = av1lib.fd_av1_to_rgb(yp.ctypes.data, yp.shape[1],
                                          up.ctypes.data if up is not None else null,
                                          vp.ctypes.data if vp is not None else null,
                                          up.shape[1] if up is not None else 0,
                                          alpha.ctypes.data if alpha is not None else null, w, w,
                                          h, conv.ctypes.data, out.ctypes.data)
                assert rc == 0
                msg = f"{fmt} full {full} matrix {matrix} primaries {primaries}"
                np.testing.assert_array_equal(out, want, err_msg=msg)
                np.testing.assert_array_equal(av1.to_rgba_plain(yp, up, vp, alpha, w, h, conv),
                                              want, err_msg=msg)
    # both routes reached (4:0:0 at full range is libavif's grey throughout)
    assert routes == ({av1.ROUTE_FLOAT} if mono and full else {av1.ROUTE_LIBYUV, av1.ROUTE_FLOAT})


# --- the stages --------------------------------------------------------------------

def _cdef_chroma_sizes(buf: np.ndarray) -> set:
    """(w, h) of the traced chroma CDEF blocks (the record layouts of
    av1.check_trace)."""
    sizes, pos = set(), 0
    while pos < len(buf):
        kind = int(buf[pos])
        if kind == 1:
            m, w, h = int(buf[pos + 13]), 1 << int(buf[pos + 2]), 1 << int(buf[pos + 3])
            pos += 14 + 2 * m + w * h
        elif kind == 2:
            pos += 4 + 3 * int(buf[pos + 1]) * int(buf[pos + 2])
        elif kind == 3:
            tx, nnz = int(buf[pos + 1]), int(buf[pos + 4])
            pos += 5 + 2 * nnz + av1.TX_W[tx] * av1.TX_H[tx]
        elif kind == 4:
            pos += 38
        elif kind == 5:
            plane, w, h = (int(v) for v in buf[pos + 1:pos + 4])
            if plane:
                sizes.add((w, h))
            pos += 10 + (w + 4) * (h + 4) + w * h
        else:
            w, h = int(buf[pos + 1]), int(buf[pos + 2])
            pos += 9 + (w + 6) * (h + 6) + w * h
    return sizes


@pytest.mark.parametrize("name", ["422 fixture", "444 grain", "422 grain", "444 ui"])
def test_plain_decode_checks_the_chroma_stages_against_their_twins(name):
    """decode(plain=True) of 4:2:2 and 4:4:4 files: every traced
    prediction, CfL, transform, loop-filter, CDEF (chroma blocks of 4x8 in
    4:2:2, 8x8 in 4:4:4, the 4:2:2 direction through Cdef_Uv_Dir), Wiener
    and self-guided call (chroma units at ssy 0) equal to its twin, and
    the plain conversion's image equal to PIL's."""
    sub, kind = name.split()
    if kind == "fixture":
        with open(AVIF_422_FIXTURE, "rb") as fh:
            data = fh.read()
    elif kind == "grain":
        data = _pil_avif(_grain(130, 96), subsampling=f"{sub[0]}:{sub[1]}:{sub[2]}", speed=2,
                         advanced=CDEF)
    else:
        data = _pil_avif(_flat_ui(), subsampling="4:4:4", speed=6)
    still = avif.parse(data)
    lib = image_lib.load_av1()
    buf = np.zeros(60 * 1024 * 1024 // 4, np.int32)
    lib.fd_av1_trace(buf.ctypes.data, buf.size)
    frame = av1.decode(still.color)
    n = lib.fd_av1_trace(ctypes.c_void_p(0), 0)
    assert n > 0
    counts = av1.check_trace(buf[:n])
    if kind != "ui":
        assert all(counts[k] > 0 for k in ("predict", "cfl", "txfm", "cdef", "wiener", "sgr")), counts
        assert _cdef_chroma_sizes(buf[:n]) == {(4, 8) if sub == "422" else (8, 8)}
        assert frame.lr[1:, :, av1.L_TYPE].any()  # chroma restoration units
    np.testing.assert_array_equal(avif.decode_avif(data, plain=True), _pil(data))


@pytest.mark.parametrize("w, h", [(4, 8), (8, 8), (4, 4)])
def test_chroma_cdef_block_equals_its_twin(w, h):
    """fd_av1_cdef_block on chroma blocks of each subsampling's size (4:2:2's
    4x8 maps the luma direction through Cdef_Uv_Dir[1][0]) against
    cdef_block_plain, with -1 (outside the frame) in the windows."""
    lib = image_lib.load_av1()
    rng = np.random.default_rng(w * 10 + h)
    for trial in range(60):
        win = rng.integers(0, 256, (h + 4, w + 4)).astype(np.int32)
        if trial % 3 == 0:
            win[:, : int(rng.integers(1, 3))] = -1
        pri, sec = int(rng.integers(0, 16)), int(rng.choice([0, 1, 2, 4]))
        damping, ydir = int(rng.integers(2, 6)), int(rng.integers(0, 8))
        out = np.zeros(w * h, np.uint16)
        dv = np.zeros(2, np.int32)
        assert lib.fd_av1_cdef_block(win.ctypes.data, w, h, 1, pri, sec, damping, ydir, 8,
                                     out.ctypes.data, dv.ctypes.data) == 0
        d, var, want = av1.cdef_block_plain(win, 1, pri, sec, damping, ydir)
        assert (int(dv[0]), int(dv[1])) == (d, var)
        assert d == (int(av1.T.CDEF_UV_DIR[int(w == 4), int(h == 4), ydir]) if pri else 0)
        np.testing.assert_array_equal(out.reshape(h, w), want)


@pytest.mark.parametrize("path, profile, ssx, ssy", [(AVIF_444_FIXTURE, 1, 0, 0),
                                                     (AVIF_422_FIXTURE, 2, 1, 0)])
def test_stored_chroma_fixtures_headers(path, profile, ssx, ssy):
    """The two stored files: 4:4:4 in profile 1 (no monochrome bit, no
    chroma sample position), 4:2:2 in profile 2 (no lr_uv_shift: chroma
    units as large as luma's), the colr box's matrix and range (BT.601 full
    range; BT.709 limited range, the sequence header's range bit too)."""
    with open(path, "rb") as fh:
        data = fh.read()
    still = avif.parse(data)
    head = next(p for k, p in av1.obus(still.color) if k == av1.OBU_SEQUENCE_HEADER)
    seq = av1.parse_sequence(head)
    assert (seq.profile, seq.ssx, seq.ssy, seq.mono) == (profile, ssx, ssy, 0)
    assert still.nclx == ((1, 13, 6, 1) if profile == 1 else (1, 13, 1, 0))
    assert seq.full_range == still.nclx[3]
    frame = av1.decode(still.color)
    assert frame.planes[1].shape == (frame.planes[0].shape[0] >> ssy,
                                     frame.planes[0].shape[1] >> ssx)
    if profile == 2:
        restored = [p for p in range(3) if frame.lr[p, :, av1.L_TYPE].any()]
        assert restored == [0, 1, 2]


# --- av1C, pixi and the stream ------------------------------------------------------

def _flip(data: bytes, box: bytes, offset: int, value=None, xor: int = 0) -> bytes:
    at = data.find(box) + 4 + offset
    out = bytearray(data)
    out[at] = value if value is not None else out[at] ^ xor
    return bytes(out)


AV1C_CASES = {
    # av1C's subsampling, monochrome and profile fields: libavif takes the
    # stream's, PIL decodes
    "av1C ssx": (lambda d: _flip(d, b"av1C", 2, xor=1 << 3), True),
    "av1C ssy": (lambda d: _flip(d, b"av1C", 2, xor=1 << 2), True),
    "av1C mono": (lambda d: _flip(d, b"av1C", 2, xor=1 << 4), True),
    "av1C profile": (lambda d: _flip(d, b"av1C", 1, xor=0x20), True),
    # av1C's depth against pixi's: a parse failure
    "av1C high bitdepth": (lambda d: _flip(d, b"av1C", 2, xor=1 << 6), False),
    "av1C twelve bit": (lambda d: _flip(d, b"av1C", 2, xor=1 << 5), False),
    # pixi's depths unequal, or none: libavif's "not implemented"
    "pixi mixed depths": (lambda d: _flip(d, b"pixi", 5, value=10), False),
    "pixi no depths": (lambda d: _flip(d, b"pixi", 4, value=0), False),
    # av1C and pixi agree on 10 bits over an 8-bit stream: decoded at 8
    "av1C and pixi 10 bits": (lambda d: _ten_bits(d), True),
    # the stream, av1C and pixi all at 10 or 12 bits: decoded at their depth
    "stream, av1C and pixi 10 bits": (lambda d: _at_depth(d, 10), True),
    "stream, av1C and pixi 12 bits": (lambda d: _at_depth(d, 12), True),
}


def _at_depth(data: bytes, depth: int) -> bytes:
    import make_image_formats

    return make_image_formats.avif_at_depth(data, depth)


def _ten_bits(data: bytes) -> bytes:
    data = _flip(data, b"av1C", 2, xor=1 << 6)
    for k in range(3):
        data = _flip(data, b"pixi", 5 + k, value=10)
    return data


@pytest.mark.parametrize("sub", ["4:4:4", "4:2:2"])
@pytest.mark.parametrize("case", sorted(AV1C_CASES))
def test_av1c_and_pixi_are_held_as_libavif_holds_them(case, sub):
    patch, decodes = AV1C_CASES[case]
    data = patch(_pil_avif(_picture(40, 24, 6, False), subsampling=sub, speed=9))
    if decodes:
        _same(data)
        return
    with pytest.raises(Exception):
        _pil(data)
    with pytest.raises(ValueError, match="pixi"):
        imagefile.decode_image(data)


def test_profile_past_two_is_rejected():
    """dav1d rejects a sequence header of profile 3-7 (PIL raises): the
    port raises ValueError, no longer NotImplementedError."""
    data = _pil_avif(_picture(40, 24, 6, False), subsampling="4:4:4", speed=9)
    still = avif.parse(data)
    head = next(p for k, p in av1.obus(still.color) if k == av1.OBU_SEQUENCE_HEADER)
    bad = bytes([head[0] | 0xE0]) + head[1:]
    data = data.replace(head, bad)
    with pytest.raises(Exception):
        _pil(data)
    with pytest.raises(ValueError, match="profile 7"):
        imagefile.decode_image(data)


@pytest.mark.parametrize("seed, index", [(3, 54), (3, 78)])
def test_a_4_2_2_partition_without_a_chroma_size_is_rejected(seed, index):
    """Corrupt 4:2:2 files (tools/avif_fuzz_agreement.py --corrupt
    --formats) whose tile codes a vertical partition (VERT, VERT_A,
    VERT_B or VERT_4) that leaves a block twice as tall as wide: 4:2:2 has
    no chroma size for it, dav1d rejects the frame and PIL raises; so does
    the port (without the rule it decodes these)."""
    options, data = fuzz.case(seed, index, corrupt=True, formats=True)
    assert options["subsampling"] == "4:2:2"
    with pytest.raises(Exception):
        _pil(data)
    with pytest.raises(ValueError, match="4:2:2 chroma block has no size"):
        imagefile.decode_image(data)
