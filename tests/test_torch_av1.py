"""The port's AV1 intra decoder (figdraw_tpu_torch/utils/av1.py, its C++ in
csrc/av1_decode.cpp) against PIL 12.1.0, which decodes AVIF through
libavif 1.3.0 and dav1d: the corpus PIL writes here (the fixture at
qualities 0-100, a 224x168 crop at speeds 0 and 10, seeded noise and crops
at 1x1 to 257x129, a gradient alpha, a flat UI picture at speeds 0 and 6,
4:0:0, tiles, a grid of repeated icons that aom codes with intra block
copy; with aom's CDEF on: the crop at speeds 0-8 and qualities 30-95,
64x64 and 128x128 superblocks, 2x2 tiles, noisy gradients of 1x1 to
257x129 whose restoration units and 8x8s meet the frame's edges, the
alpha item, 4:0:0; loop restoration at speeds 0-4; film grain, since it
was ported: tests/test_torch_av1_film_grain.py; PIL's image sequences,
since they were read: tests/test_torch_avif_sequence.py) equal byte for
byte or refused with the feature named (those sequences with their
tracks sized 3/4 of their frames); the headers of those
files (4:4:4, 4:2:2 and limited range since they were ported:
tests/test_torch_av1_chroma.py); the constant tables
(tools/make_av1_tables.py) pinned by sha256
and found whole in libaom's binary (the Gaussian sequence in dav1d's in
PIL's libavif too); each C++ stage (the inverse
transforms, the intra predictors with the edge filter and upsampling,
CfL, filter intra, one loop-filter position at each length, YUV -> RGB)
equal to its numpy twin on seeded inputs and, through the stage trace,
on the corpus (CDEF and the restoration filters too:
tests/test_torch_av1_postfilter.py holds them alone); seeded files of
tools/avif_fuzz_agreement.py; and no fallback when the C++ does not
build."""

import ctypes
import glob
import hashlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from figdraw_tpu_torch.scenes import (
    AVIF_422_FIXTURE, AVIF_444_FIXTURE, AVIF_CDEF_FIXTURE, AVIF_FIXTURE, IMAGE_FIXTURE,
)
from figdraw_tpu_torch.utils import av1, av1_tables, avif, image_lib, imagefile
from torch_reference import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
import avif_fuzz_agreement as fuzz  # noqa: E402
from make_av1_tables import CDFS, STORED, libaom_path, read_tables  # noqa: E402

torch.set_num_threads(1)

TABLES_HEADER = os.path.join(REPO, "figdraw_tpu_torch", "csrc", "av1_tables.h")


def _fixture() -> np.ndarray:
    return np.asarray(Image.open(IMAGE_FIXTURE).convert("RGB"))


def _pil_avif(px: np.ndarray, **kw) -> bytes:
    out = io.BytesIO()
    Image.fromarray(px).save(out, "AVIF", **kw)
    return out.getvalue()


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _flat_ui() -> np.ndarray:
    ui = np.full((240, 320, 3), 245, np.uint8)
    ui[20:60, 20:300] = (30, 90, 200)
    ui[80:200, 40:150] = (220, 50, 50)
    ui[100:180, 180:290] = (40, 160, 70)
    ui[210:225, 20:300] = (10, 10, 10)
    return ui


def _tiles(w: int, h: int) -> np.ndarray:
    """A flat picture of one seeded 12x12 icon repeated on a grid, which
    aom codes with intra block copy (screen content at speeds 5-7)."""
    icon = np.random.default_rng(3).integers(0, 2, (12, 12)) * 200 + 20
    img = np.full((h, w, 3), 240, np.uint8)
    for y in range(8, h - 16, 20):
        for x in range(8, w - 16, 20):
            img[y:y + 12, x:x + 12] = icon[..., None]
    return img


def _grain(w: int, h: int) -> np.ndarray:
    """A gradient under seeded noise (sigma 10), which aom restores with
    Wiener and self-guided units at speed 2, quality 70."""
    gy, gx = np.mgrid[0:h, 0:w]
    base = np.dstack([gx * 200 / w + 30, gy * 200 / h + 20, (gx + gy) * 100 / (w + h) + 80])
    return np.clip(base + np.random.default_rng(w).normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)


CDEF = {"enable-cdef": "1"}


def _corpus(name: str) -> bytes:
    fix = _fixture()
    rng = np.random.default_rng(7)
    kind, _, arg = name.partition(":")
    if kind == "cdef":  # the crop with CDEF at a speed (loop restoration at 0-4)
        return _pil_avif(np.ascontiguousarray(fix[100:268, 200:424]), speed=int(arg), advanced=CDEF)
    if kind == "cdefq":
        return _pil_avif(np.ascontiguousarray(fix[100:268, 200:424]), speed=2, quality=int(arg),
                         advanced=CDEF)
    if kind == "sb":
        return _pil_avif(np.ascontiguousarray(fix[:300, :520]), speed=2,
                         advanced=dict(CDEF, **{"sb-size": arg}))
    if kind == "lr":  # speed, quality: Wiener and self-guided units
        speed, quality = (int(v) for v in arg.split(","))
        return _pil_avif(np.ascontiguousarray(fix[:300, :520]), speed=speed, quality=quality,
                         advanced=CDEF)
    if kind == "lrtiles":
        return _pil_avif(np.ascontiguousarray(fix[:300, :520]), speed=2, quality=40, tile_cols=1,
                         tile_rows=1, advanced=CDEF)
    if kind == "grain":
        w, h = (int(v) for v in arg.split("x"))
        return _pil_avif(_grain(w, h), speed=2, quality=70, advanced=CDEF)
    if kind == "cdefalpha":  # the monochrome alpha item takes CDEF and Wiener units
        grain = _grain(200, 120)
        return _pil_avif(np.ascontiguousarray(np.dstack([grain, grain[..., 1]])), speed=2,
                         quality=50, advanced=CDEF)
    if kind == "cdefmono":  # 4:0:0 with CDEF and self-guided units
        return _pil_avif(_grain(257, 129), speed=0, quality=50, subsampling="4:0:0",
                         advanced=CDEF)
    if kind == "cdeflossless":  # both tools on in the sequence, off by coded lossless
        return _pil_avif(np.ascontiguousarray(fix[:65, :65]), quality=100, speed=2, advanced=CDEF)
    if kind == "cdeficons":  # CDEF on in the sequence, off by intra block copy
        return _pil_avif(_tiles(257, 131), speed=6, advanced=CDEF)
    if kind == "fixture":
        return _pil_avif(fix, quality=int(arg))
    if kind == "crop":
        return _pil_avif(np.ascontiguousarray(fix[100:268, 200:424]), speed=int(arg))
    if kind in ("noise", "fixcrop"):
        w, h = (int(v) for v in arg.split("x"))
        px = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8) if kind == "noise"
              else np.ascontiguousarray(fix[:h, :w]))
        return _pil_avif(px)
    if kind == "alpha":
        rgba = np.dstack([fix, np.tile(np.linspace(0, 255, 800).astype(np.uint8), (600, 1))])
        return _pil_avif(np.ascontiguousarray(rgba))
    if kind == "ui":
        return _pil_avif(_flat_ui(), speed=int(arg))
    if kind == "orient6":
        exif = Image.Exif()
        exif[0x0112] = 6
        return _pil_avif(np.ascontiguousarray(fix[:96, :130]), exif=exif.tobytes())
    if kind == "mono":
        return _pil_avif(np.ascontiguousarray(fix[:129, :257]), subsampling="4:0:0",
                         quality=int(arg))
    if kind == "tiles":
        return _pil_avif(np.ascontiguousarray(fix[:300, :520]), tile_cols=1, tile_rows=1)
    if kind == "lossless":
        return _pil_avif(np.ascontiguousarray(fix[:65, :65]), quality=100)
    if kind == "aom":  # aom options PIL's save passes through `advanced`
        options = dict(kv.split("=") for kv in arg.split(","))
        quality = int(options.pop("quality", 60))
        return _pil_avif(np.ascontiguousarray(fix[100:356, 150:470]), quality=quality,
                         advanced=options)
    if kind == "avis":  # PIL's save_all: that many frames of the crop, each moved a pixel
        crop = fix[100:196, 200:330]
        frames = [Image.fromarray(np.ascontiguousarray(np.roll(crop, k, 1)))
                  for k in range(int(arg))]
        out = io.BytesIO()
        frames[0].save(out, "AVIF", save_all=True, append_images=frames[1:])
        return out.getvalue()
    if kind == "icons":
        speed, _, rest = arg.partition(",")
        kw = {"quality": 100} if rest == "lossless" else ({"subsampling": "4:0:0"} if rest else {})
        return _pil_avif(_tiles(257, 131), speed=int(speed), **kw)
    raise KeyError(name)


DECODED = (["fixture:%d" % q for q in (0, 10, 25, 50, 75, 90, 100)] + ["crop:10"]
           + ["%s:%s" % (k, s) for k in ("noise", "fixcrop")
              for s in ("1x1", "17x3", "65x65", "130x96", "257x129")]
           + ["alpha:", "ui:0", "ui:6", "orient6:", "mono:50", "mono:100", "tiles:", "lossless:",
              "crop:0"]
           + ["icons:5", "icons:6", "icons:7", "icons:6,lossless", "icons:6,mono"]
           + ["aom:deltaq-mode=2", "aom:sharpness=3", "aom:sharpness=7",
              "aom:reduced-tx-type-set=1", "aom:enable-chroma-deltaq=1",
              "aom:enable-qm=1", "aom:enable-qm=1,qm-min=0,qm-max=4,quality=95",
              "aom:enable-qm=1,qm-min=10,qm-max=14,quality=30"]
           + ["cdef:%d" % s for s in (0, 2, 4, 6, 8)] + ["cdefq:%d" % q for q in (30, 75, 95)]
           + ["sb:64", "sb:128", "lr:2,40", "lr:0,20", "lrtiles:"]
           + ["grain:%s" % s for s in ("1x1", "17x3", "65x65", "130x96", "201x77", "257x129")]
           + ["cdefalpha:", "cdefmono:", "cdeflossless:", "cdeficons:"]
           # film grain (tests/test_torch_av1_film_grain.py holds the rest)
           + ["aom:film-grain-test=1", "aom:film-grain-test=1,quality=30"]
           # PIL's save_all: an image sequence's first frame
           # (tests/test_torch_avif_sequence.py holds the rest)
           + ["avis:2", "avis:3"])
# PIL's image sequences with their tracks' size 3/4 of their frames'
# (libyuv's 3/4 filter; ROADMAP item 1.3, entry 10)
REFUSED = {"avis:2": "an AV1 frame of another size than ispe",
           "avis:3": "an AV1 frame of another size than ispe"}


@pytest.mark.parametrize("name", DECODED)
def test_corpus_equals_pil(name):
    data = _corpus(name)
    got = imagefile.decode_image(data)
    want = _pil(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_corpus_outside_the_slice_is_refused(name):
    """The corpus's sequence of that many frames, cut to 128x96 and its
    tracks sized 96x72: the first frame scaled by 3/4 stays refused."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_image_formats import with_track_size

    crop = _fixture()[100:196, 200:328]
    frames = [Image.fromarray(np.ascontiguousarray(np.roll(crop, k, 1)))
              for k in range(int(name.split(":")[1]))]
    out = io.BytesIO()
    frames[0].save(out, "AVIF", save_all=True, append_images=frames[1:])
    with pytest.raises(NotImplementedError, match=rf"AVIF images with {REFUSED[name]}"):
        imagefile.decode_image(with_track_size(out.getvalue(), 96, 72))


# the post-filters each file's plain decode must reach
PLAIN_KINDS = {"grain:257x129": ("wiener", "sgr"), "lr:2,40": ("cdef", "wiener", "sgr"),
               "cdef:6": ("cdef",), "cdefmono:": ("cdef", "sgr"), "cdefalpha:": ("cdef", "wiener")}


@pytest.mark.parametrize("name", ["noise:65x65", "fixcrop:130x96", "ui:6", "lossless:",
                                  "mono:100", "fixcrop:17x3", "icons:6"] + list(PLAIN_KINDS))
def test_plain_decode_checks_every_stage_against_its_twin(name):
    """decode(plain=True): every traced prediction, CfL, inverse transform,
    loop-filter, CDEF, Wiener and self-guided call equal to its twin (the
    files with the post-filters reach those named in PLAIN_KINDS), and the
    YUV -> RGB twin's image equal to PIL's. The alpha item's calls count
    with the colour's."""
    data = _corpus(name)
    still = avif.parse(data)
    frame = av1.decode(still.color, plain=True)
    assert frame.checked["predict"] > 0
    checked = dict(frame.checked)
    if still.alpha:
        for k, n in av1.decode(still.alpha, plain=True).checked.items():
            checked[k] += n
    assert all(checked[k] > 0 for k in PLAIN_KINDS.get(name, ())), checked
    np.testing.assert_array_equal(avif.decode_avif(data, plain=True), _pil(data))


@pytest.mark.parametrize("path, kinds", [
    (AVIF_FIXTURE, ("predict", "cfl", "txfm", "lf")),
    (AVIF_CDEF_FIXTURE, ("predict", "cfl", "txfm", "lf", "cdef", "wiener", "sgr"))])
def test_the_fixtures_stages_include_every_kind(path, kinds):
    """Each stored fixture traces its kinds of stage call, each equal to
    its twin (a capped number of each): the speed-2 CDEF fixture also
    CDEF, Wiener and self-guided calls."""
    with open(path, "rb") as fh:
        still = avif.parse(fh.read())
    lib = image_lib.load_av1()
    trace = np.zeros(60 * 1024 * 1024 // 4, np.int32)
    lib.fd_av1_trace(trace.ctypes.data, trace.size)
    av1.decode(still.color)
    n = lib.fd_av1_trace(ctypes.c_void_p(0), 0)
    assert n > 0
    counts = av1.check_trace(trace[:n], limit=300)
    assert all(counts[k] > 0 for k in kinds), counts


# --- headers ----------------------------------------------------------------------

def _headers(data: bytes):
    still = avif.parse(data)
    seq, fh = None, None
    for kind, payload in av1.obus(still.color):
        if kind == av1.OBU_SEQUENCE_HEADER:
            seq = av1.parse_sequence(payload)
        elif kind == av1.OBU_FRAME:
            fh = av1.parse_frame_header(av1.BitReader(payload), seq)
    return seq, fh


def test_fixture_headers():
    """PIL's default save: a reduced still-picture header, 128x128
    superblocks, filter intra and the edge filter on, two tile columns
    (PIL's autotiling), the colour in the colr box (BT.601 full range)."""
    with open(AVIF_FIXTURE, "rb") as fh:
        seq, fh = _headers(fh.read())
    assert seq.profile == 0 and seq.still and seq.reduced
    assert seq.use128 and seq.filter_intra and seq.edge_filter and not seq.mono
    assert (seq.max_width, seq.max_height) == (800, 600)
    assert (seq.primaries, seq.transfer, seq.matrix, seq.full_range) == (2, 2, 2, 1)
    assert avif.parse(open(AVIF_FIXTURE, "rb").read()).nclx == (1, 13, 6, 1)  # the colr box
    hdr = fh["hdr"]
    assert (hdr[av1.H_MI_COLS], hdr[av1.H_MI_ROWS]) == (200, 150)
    assert fh["col_starts"] == [0, 128, 200] and fh["row_starts"] == [0, 150]
    assert 0 < hdr[av1.H_BASE_Q] < 255 and hdr[av1.H_TX_MODE] == 2
    assert hdr[av1.H_LF_LEVEL0] > 0


@pytest.mark.parametrize("name", ["icons:5", "icons:6", "icons:7", "icons:6,lossless",
                                  "icons:6,mono"])
def test_repeated_icons_are_coded_with_intra_block_copy(name):
    """The icon grid: allow_intrabc set (no loop filter), blocks coded as
    copies of earlier ones (the vector stack, split transform sizes, the
    inter transform sets), decoded equal to PIL (test_corpus_equals_pil)."""
    still = avif.parse(_corpus(name))
    frame = av1.decode(still.color)
    assert frame.mi[..., av1.M_INTER].sum() > 0
    vectors = frame.mi[..., av1.M_MV_ROW][frame.mi[..., av1.M_INTER] > 0]
    assert np.all(vectors % 8 == 0)  # whole pels


def test_flat_ui_turns_on_screen_content_and_palettes():
    seq, fh = _headers(_corpus("ui:6"))
    assert fh["hdr"][av1.H_SCREEN_CONTENT] == 1


@pytest.mark.parametrize("name, field, value", [
    ("aom:deltaq-mode=2", "H_DELTA_Q_PRESENT", 1), ("aom:sharpness=7", "H_SHARPNESS", 7),
    ("aom:reduced-tx-type-set=1", "H_REDUCED_TX_SET", 1), ("aom:enable-chroma-deltaq=1", "H_DQ_U_AC", 2),
    ("aom:enable-qm=1", "H_USING_QM", 1),
])
def test_aom_options_reach_the_header(name, field, value):
    """The header fields the aom options set (delta q, loop filter
    sharpness, the reduced transform sets, chroma delta q, quantiser
    matrices, which apply to 2D transform types only), each file decoded
    equal to PIL (test_corpus_equals_pil)."""
    _seq, fh = _headers(_corpus(name))
    assert fh["hdr"][getattr(av1, field)] == value


def test_lossless_frame_is_coded_lossless():
    _seq, fh = _headers(_corpus("lossless:"))
    hdr = fh["hdr"]
    assert hdr[av1.H_LOSSLESS:av1.H_LOSSLESS + 8].all() and hdr[av1.H_BASE_Q] == 0
    assert hdr[av1.H_LF_LEVEL0] == 0 and hdr[av1.H_TX_MODE] == 0


def test_tiles_are_read():
    _seq, fh = _headers(_corpus("tiles:"))
    assert len(fh["col_starts"]) - 1 == 2 and len(fh["row_starts"]) - 1 == 2


@pytest.mark.parametrize("kw, profile", [
    (dict(subsampling="4:4:4"), 1),
    (dict(subsampling="4:2:2"), 2),
    (dict(range="limited"), 0),
])
def test_header_features_once_refused_equal_pil(kw, profile):
    """4:4:4 (AV1 profile 1), 4:2:2 (profile 2) and limited range, refused
    before they were ported (tests/test_torch_av1_chroma.py holds them
    whole): decoded equal to PIL byte for byte."""
    data = _pil_avif(np.ascontiguousarray(_fixture()[:47, :61]), **kw)
    seq, _fh = _headers(data)
    assert seq.profile == profile
    np.testing.assert_array_equal(imagefile.decode_image(data), _pil(data))


def test_obus_and_leb128():
    assert av1.leb128(bytes([0x80, 0x01]), 0) == (128, 2)
    assert av1.leb128(bytes([0x05]), 0) == (5, 1)
    stream = bytes([0x12, 0x00, 0x7A, 0x02, 0xAB, 0xCD])  # temporal delimiter, padding
    assert [(k, p) for k, p in av1.obus(stream)] == [(2, b""), (15, b"\xab\xcd")]
    with pytest.raises(ValueError):
        list(av1.obus(bytes([0x12, 0x05, 0x00])))


# --- the tables -------------------------------------------------------------------

def _header_tables() -> dict:
    with open(TABLES_HEADER) as fh:
        text = fh.read()
    out = {}
    for m in re.finditer(r"static const \w+ (\w+)((?:\[\d+\])+) = \{([^}]*)\};", text):
        out[m.group(1)] = np.array([int(v) for v in m.group(3).replace("\n", " ").split(",")
                                    if v.strip()], np.int64)
    return out


def test_every_table_is_pinned_by_its_sha256():
    header = _header_tables()
    assert set(header) == set(av1_tables.SHA256)
    for name, values in header.items():
        digest = hashlib.sha256(values.astype("<i4").tobytes()).hexdigest()
        assert digest == av1_tables.SHA256[name], name
        if hasattr(av1_tables, name):
            np.testing.assert_array_equal(getattr(av1_tables, name).reshape(-1), values)


def _libaom() -> bytes:
    path = libaom_path()
    if not path:
        pytest.skip("no libaom on this host to find the tables in")
    with open(path, "rb") as fh:
        return fh.read()


def test_tables_are_what_the_tool_reads_from_libaom():
    tables = read_tables(libaom_path() if _libaom() else "")
    header = _header_tables()
    for name, (arr, _off, _what) in tables.items():
        np.testing.assert_array_equal(arr.reshape(-1), header[name], err_msg=name)


@pytest.mark.parametrize("name", [n for n in STORED] + ["DEFAULT_SCAN_%dX%d" % s for s in (
    (4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16), (16, 8), (16, 32), (32, 16),
    (4, 16), (16, 4), (8, 32), (32, 8))])
def test_stored_tables_occur_whole_in_libaom(name):
    binary = _libaom()
    fmt = STORED[name][0] if name in STORED else "<i2"
    values = _header_tables()[name].astype(fmt)
    assert values.tobytes() in binary


def test_gaussian_sequence_is_dav1ds():
    """dav1d's int16 copy of film grain's Gaussian sequence, in PIL's libavif."""
    path = glob.glob(os.path.join(os.path.dirname(os.path.dirname(Image.__file__)),
                                  "pillow.libs", "libavif-*.so*"))[0]
    with open(path, "rb") as fh:
        assert av1_tables.GAUSSIAN_SEQUENCE.astype("<i2").tobytes() in fh.read()


@pytest.mark.parametrize("name", list(CDFS))
def test_cdfs_occur_in_libaom(name):
    """Each CDF's inverse values occur in libaom's binary; the last CfL
    alpha CDF's run there repeats two values (read as the 15 falling
    ones), so its two falling parts occur."""
    binary = _libaom()
    header = _header_tables()[name]
    grid, ns, _anchor, _what = CDFS[name]
    count = int(np.prod(grid)) if grid else 1
    nlist = ns if isinstance(ns, list) else [ns] * count
    slot = max(nlist) + 1
    rows = header.reshape(count, slot)
    for k, n in enumerate(nlist):
        vals = rows[k, :n - 1]
        assert np.all(vals[:-1] > vals[1:]) and vals[-1] > 0 and rows[k, n - 1] == 0
        parts = [vals[:11], vals[11:]] if name == "CFL_ALPHA" and k == 5 else [vals]
        for part in parts:
            assert part.astype("<u2").tobytes() in binary, (name, k)


def test_scans_are_permutations():
    for w, h in ((4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16), (16, 8),
                 (16, 32), (32, 16), (4, 16), (16, 4), (8, 32), (32, 8)):
        scan = getattr(av1_tables, f"DEFAULT_SCAN_{w}X{h}")
        assert sorted(scan.tolist()) == list(range(w * h))


# --- the C++ stages against their twins ---------------------------------------------

INTRA_TYPES = {  # the 2D types each size may take in an intra frame, and a flipped one
    0: range(16), 1: range(16), 2: range(16), 3: (0, 9), 4: (0,),
    5: range(16), 6: range(16), 7: range(16), 8: range(16), 9: (0, 9), 10: (0, 9),
    11: (0,), 12: (0,), 13: range(16), 14: range(16), 15: (0, 9), 16: (0, 9), 17: (0,), 18: (0,),
}


@pytest.mark.parametrize("tx", range(19))
def test_inverse_transforms_equal_their_twin(tx):
    lib = image_lib.load_av1()
    rng = np.random.default_rng(tx)
    w, h = av1.TX_W[tx], av1.TX_H[tx]
    for tx_type in INTRA_TYPES[tx]:
        for trial in range(3):
            deq = np.zeros((64, 64), np.int32)
            tw, th = min(w, 32), min(h, 32)
            k = rng.integers(1, tw * th + 1)
            idx = rng.choice(tw * th, k, replace=False)
            scale = (8, 200, 2000)[trial]
            deq[idx // tw, idx % tw] = rng.integers(-scale, scale + 1, k)
            got = np.zeros(w * h, np.int32)
            assert lib.fd_av1_inv_txfm(deq.ctypes.data, tx, tx_type, 0, 8, got.ctypes.data) == 0
            want = av1.inv_txfm_plain(deq, tx, tx_type, 0)
            np.testing.assert_array_equal(got.reshape(h, w), want, err_msg=f"{tx} {tx_type}")
    deq = np.zeros((64, 64), np.int32)
    deq[:4, :4] = rng.integers(-300, 300, (4, 4))
    got = np.zeros(16, np.int32)
    lib.fd_av1_inv_txfm(deq.ctypes.data, 0, 0, 1, 8, got.ctypes.data)
    np.testing.assert_array_equal(got.reshape(4, 4), av1.inv_txfm_plain(deq, 0, 0, 1))


@pytest.mark.parametrize("n, kind", [(2, 0), (3, 0), (4, 0), (5, 0), (6, 0), (2, 1), (3, 1), (4, 1)])
def test_transforms_follow_their_float_bases(n, kind):
    """The DCT and ADST twins against float bases (the AV1 DCT-II and
    its ADSTs: sin(pi (i + 1)(2k + 1) / 9) at 4, the DST-IV above)."""
    N = 1 << n
    tx = {2: 0, 3: 1, 4: 2, 5: 3, 6: 4}[n]
    for k in range(min(N, 32)):
        deq = np.zeros((64, 64), np.int64)
        deq[k, 0] = 2000
        col = av1.inv_txfm_plain(deq, tx, 1 if kind else 0, 0)[:, 0].astype(float)
        i = np.arange(N)
        if kind == 0:
            basis = np.cos(np.pi * (2 * i + 1) * k / (2 * N))
        elif N == 4:
            basis = np.sin(np.pi * (i + 1) * (2 * k + 1) / 9)
        else:
            basis = np.sin(np.pi * (2 * i + 1) * (2 * k + 1) / (4 * N))
        corr = np.dot(col, basis) / np.linalg.norm(col) / np.linalg.norm(basis)
        assert corr > 0.999, (n, kind, k)


def _edges(rng, n, flat=False):
    if flat:
        return np.full(n, rng.integers(0, 256), np.int32)
    base = rng.integers(0, 256)
    return np.clip(base + np.cumsum(rng.integers(-12, 13, n)), 0, 255).astype(np.int32)


PREDICT_CASES = [(mode, lw, lh) for mode in range(13) for lw, lh in
                 ((2, 2), (3, 3), (4, 4), (5, 5), (6, 6), (2, 3), (3, 2), (2, 4), (4, 2),
                  (3, 5), (5, 3), (4, 6), (6, 4))]


@pytest.mark.parametrize("mode, lw, lh", PREDICT_CASES)
def test_predictors_equal_their_twin(mode, lw, lh):
    """Each mode and size, with the edge filter on and off, each angle
    delta, both filter types, edges available or not and cut by the frame
    (aboveLimit / leftLimit), filter intra's five modes at the sizes it
    takes."""
    lib = image_lib.load_av1()
    rng = np.random.default_rng(mode * 100 + lw * 10 + lh)
    w, h = 1 << lw, 1 << lh
    deltas = range(-3, 4) if 1 <= mode <= 8 else (0,)
    for delta in deltas:
        for trial in range(4):
            have_left, have_above = int(trial != 1), int(trial != 2)
            params = [mode, lw, lh, have_left, have_above, delta, trial & 1, int(trial < 3),
                      0, 0, int(rng.integers(1, 2 * w)), int(rng.integers(1, 2 * h))]
            n = w + h + 1
            above, left = _edges(rng, n, trial == 3), _edges(rng, n)
            left[0] = above[0]
            p = np.array(params, np.int32)
            got = np.zeros(w * h, np.uint16)
            assert lib.fd_av1_predict(p.ctypes.data, above.ctypes.data, left.ctypes.data, 8,
                                      got.ctypes.data) == 0
            want = av1.predict_plain(params, above, left)
            np.testing.assert_array_equal(got.reshape(h, w), want, err_msg=str(params))
    if mode == 0 and w <= 32 and h <= 32:
        for fmode in range(5):
            params = [0, lw, lh, 1, 1, 0, 0, 1, 1, fmode, w, h]
            above, left = _edges(rng, w + h + 1), _edges(rng, w + h + 1)
            left[0] = above[0]
            p = np.array(params, np.int32)
            got = np.zeros(w * h, np.uint16)
            lib.fd_av1_predict(p.ctypes.data, above.ctypes.data, left.ctypes.data, 8, got.ctypes.data)
            np.testing.assert_array_equal(got.reshape(h, w), av1.predict_plain(params, above, left))


@pytest.mark.parametrize("w, h", [(4, 4), (8, 4), (4, 16), (16, 16), (32, 8), (32, 32)])
def test_cfl_equals_its_twin(w, h):
    lib = image_lib.load_av1()
    rng = np.random.default_rng(w * h)
    for alpha in (-16, -5, -1, 0, 1, 7, 16):
        L = (rng.integers(0, 256 * 4, (h, w)) * 2).astype(np.int32)
        dc = np.full((h, w), rng.integers(0, 256), np.uint8)
        got = dc.astype(np.uint16)
        assert lib.fd_av1_cfl(L.ctypes.data, w, h, alpha, 8, got.ctypes.data) == 0
        np.testing.assert_array_equal(got, av1.cfl_plain(L, alpha, dc))


@pytest.mark.parametrize("size, plane", [(4, 0), (8, 0), (16, 0), (4, 1), (8, 1)])
def test_loop_filter_edge_equals_its_twin(size, plane):
    """One position at each filter length (4, 6 for chroma, 8, 14), smooth
    and sharp sides, at levels from low to high (sharpness 0 and 4)."""
    lib = image_lib.load_av1()
    rng = np.random.default_rng(size * 3 + plane)
    rows = []
    for trial in range(400):
        step = int(rng.integers(0, 40))
        base = int(rng.integers(0, 200))
        s = np.concatenate([np.full(8, base), np.full(8, base + step)])
        s = np.clip(s + rng.integers(-2, 3, 16) * (trial % 3), 0, 255).astype(np.int32)
        rows.append(s)
    for lvl in (4, 20, 40, 63):
        for sharp in (0, 4):
            shift = 2 if sharp > 4 else (1 if sharp else 0)
            limit = max(1, lvl >> shift) if not sharp else min(max(lvl >> shift, 1), 9 - sharp)
            params = [size, plane, limit, 2 * (lvl + 2) + limit, lvl >> 4]
            p = np.array(params, np.int32)
            got = []
            for s in rows:
                x = s.copy()
                lib.fd_av1_lf_edge(x.ctypes.data, p.ctypes.data, 8)
                got.append(x)
            np.testing.assert_array_equal(np.array(got), av1.lf_edge_plain(np.array(rows), params))


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (3, 17), (47, 61), (96, 130)])
def test_yuv_to_rgb_equals_its_twin(shape):
    lib = image_lib.load_av1()
    rng = np.random.default_rng(shape[0] * shape[1])
    h, w = shape
    pad = lambda a: np.ascontiguousarray(np.pad(a, ((0, 3), (0, 5))))  # noqa: E731
    y = pad(rng.integers(0, 256, (h, w), np.uint8))
    u = pad(rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), np.uint8))
    v = pad(rng.integers(0, 256, u.shape[:1] and ((h + 1) // 2, (w + 1) // 2), np.uint8))
    a = rng.integers(0, 256, (h, w), np.uint8)
    for alpha in (None, a):
        # 4:2:0 full-range BT.601 (libyuv's), limited-range BT.709 (libyuv's)
        # and SMPTE 240 (libavif's float conversion)
        for full, matrix in ((1, 6), (0, 1), (1, 7)):
            conv = av1.conversion(0, 1, 1, full, matrix, 1, alpha is not None)
            out = np.zeros((h, w, 4), np.uint8)
            ap = alpha.ctypes.data if alpha is not None else ctypes.c_void_p(0)
            lib.fd_av1_to_rgb(y.ctypes.data, y.shape[1], u.ctypes.data, v.ctypes.data, u.shape[1],
                              ap, w, w, h, conv.ctypes.data, out.ctypes.data)
            np.testing.assert_array_equal(out, av1.to_rgba_plain(y, u, v, alpha, w, h, conv))


def test_flat_colours_convert_as_libyuv():
    """Flat 4:2:0 pictures of seeded colours: PIL's RGB is libyuv's
    fixed-point BT.601 of the decoded YUV (no chroma upsampling error on a
    flat picture)."""
    rng = np.random.default_rng(11)
    for _ in range(6):
        px = np.full((16, 16, 3), rng.integers(0, 256, 3), np.uint8)
        data = _pil_avif(px, quality=100)
        np.testing.assert_array_equal(imagefile.decode_image(data), _pil(data))


# --- seeded files of the agreement tool, and no fallback ------------------------------

@pytest.mark.parametrize("seed, index", [(3, i) for i in range(6)] + [(1, 66)])
def test_fuzz_agreement_cases(seed, index):
    """Seeded files of the agreement tool, equal to PIL at every speed
    (loop restoration at speeds 0-4, CDEF where the case draws it); (1, 66)
    is an alpha item whose intra block copies take H_ADST (the inter
    transform sets' symbol order, libaom's av1_ext_tx_inv, once read wrong
    here)."""
    options, data = fuzz.case(seed, index)
    kind, detail = fuzz.outcome(data)
    assert kind == "equal", (options, detail)


def _clamped_coefficients(data: bytes) -> int:
    """The dequantised coefficients at the dequantiser's clamp (|c| >=
    32767) in the traced transform calls of a file's items."""
    lib = image_lib.load_av1()
    still, count = avif.parse(data), 0
    for stream in (still.color, still.alpha):
        if not stream:
            continue
        buf = np.zeros(40 * 1024 * 1024 // 4, np.int32)
        lib.fd_av1_trace(buf.ctypes.data, buf.size)
        av1.decode(stream)
        n = lib.fd_av1_trace(ctypes.c_void_p(0), 0)
        pos = 0
        while pos < n:  # the record layouts of check_trace
            kind = int(buf[pos])
            if kind == 1:
                m, w, h = int(buf[pos + 13]), 1 << int(buf[pos + 2]), 1 << int(buf[pos + 3])
                pos += 14 + 2 * m + w * h
            elif kind == 2:
                pos += 4 + 3 * int(buf[pos + 1]) * int(buf[pos + 2])
            elif kind == 3:
                tx, nnz = int(buf[pos + 1]), int(buf[pos + 4])
                values = buf[pos + 6:pos + 5 + 2 * nnz:2].astype(np.int64)
                count += int((np.abs(values) >= 32767).sum())
                pos += 5 + 2 * nnz + av1.TX_W[tx] * av1.TX_H[tx]
            elif kind == 4:
                pos += 38
            elif kind == 5:
                w, h = int(buf[pos + 2]), int(buf[pos + 3])
                pos += 10 + (w + 4) * (h + 4) + w * h
            else:
                w, h = int(buf[pos + 1]), int(buf[pos + 2])
                pos += 9 + (w + 6) * (h + 6) + w * h
    return count


# tools/avif_fuzz_agreement.py --corrupt 200 3 cases that differ from PIL
# where PIL's dav1d runs its SSSE3 or AVX2 transforms (ROADMAP.md §3, kept:
# not a fault of the port)
CLAMP_CORRUPT = [(0, 78), (2, 26), (2, 74), (2, 110)]


@pytest.fixture
def dav1d_c_path():
    with fuzz.dav1d_c_path():
        yield


@pytest.mark.parametrize("seed, index", CLAMP_CORRUPT)
def test_corrupt_streams_at_the_coefficient_clamp_equal_dav1d_c_path(seed, index, dav1d_c_path):
    """In each, bit flips send a tile's symbols into garbage that
    dequantises coefficients to the clamp (+-32767); the inverse transform
    then leaves its 16-bit range, where dav1d's x86 SIMD transforms part
    from its own C code and the specification (PIL's output depends on
    the CPU's instruction set). With dav1d's C code forced
    (dav1d_set_cpu_flags_mask(0) in PIL's libavif) PIL equals the port.
    The uncorrupted source has no such coefficient and equals PIL."""
    options, data = fuzz.case(seed, index, corrupt=True)
    assert fuzz.outcome(data, True) == ("equal", "")
    assert _clamped_coefficients(data) > 0
    source = fuzz.case(seed, index % 12)[1]
    assert fuzz.outcome(source)[0] == "equal" and _clamped_coefficients(source) == 0


def test_a_reduced_header_without_still_picture_raises():
    """A sequence header with reduced_still_picture_header set and
    still_picture clear (a bit flip of --grids --corrupt, seed 5 index 41):
    dav1d rejects the stream (PIL: "Decoding of color planes failed"), and
    so does the port, which decoded it before."""
    _options, data = fuzz.case(3, 0)
    head = next(p for k, p in av1.obus(avif.parse(data).color) if k == av1.OBU_SEQUENCE_HEADER)
    assert av1.parse_sequence(head).reduced and head[0] & 0x10
    flipped = data.replace(head, bytes([head[0] & ~0x10]) + head[1:])
    with pytest.raises(Exception):
        _pil(flipped)
    with pytest.raises(ValueError, match="still"):
        imagefile.decode_image(flipped)


def test_a_failed_build_raises(monkeypatch):
    """The C++ AV1 library does not build: the decode raises, never runs
    the plain twins."""
    from figdraw_tpu_torch.utils import gxx

    def broken(*_a, **_k):
        raise subprocess.CalledProcessError(1, ["g++"], "", "error")

    monkeypatch.setattr(image_lib, "_av1", None)
    monkeypatch.setattr(gxx, "build", broken)
    for path in (AVIF_FIXTURE, AVIF_CDEF_FIXTURE, AVIF_444_FIXTURE, AVIF_422_FIXTURE):
        with open(path, "rb") as fh:
            data = fh.read()
        with pytest.raises(subprocess.CalledProcessError):
            imagefile.decode_image(data)
    with pytest.raises(subprocess.CalledProcessError):  # the scale to ispe
        av1.scale(np.zeros((4, 4), np.uint8), 4, 4, 3, 2)
    frame = av1.Frame((np.zeros((8, 8), np.uint8), np.zeros((8, 8), np.uint8),
                       np.zeros((8, 8), np.uint8)), 8, 8, 0, 9, 0, 0, 0)
    with pytest.raises(subprocess.CalledProcessError):  # the conversion alone
        av1.to_rgba(frame, None, 0, 9)
