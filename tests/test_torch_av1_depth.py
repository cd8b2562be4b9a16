"""The port's AV1 decoder on 10- and 12-bit AVIF stills against PIL 12.1.0
(libavif 1.3.0 with dav1d, as figdraw_tpu reads them). aom in PIL's
libavif has no high bit depth, so every input here is a PIL-written 8-bit
file made 10- or 12-bit by rewriting its sequence headers, av1C and pixi
(tools/make_image_formats.py's avif_at_depth; the tile symbols are kept
and read at the new depth, 12 bits in profile 2): the rewritten headers
parse to the intended fields and a bit slipped to the wrong place is
caught; the decode equals PIL byte for byte over 10- and 12-bit 4:0:0,
4:2:0, 4:2:2 and 4:4:4, with and without alpha, at speeds with and
without CDEF and loop restoration (screen content, whose palette colours
are read with BitDepth bits, parts from the stream's syntax and raises as
PIL does); each stage's C++ (fd_av1_predict and the other stage entry
points, at a bit depth) equals its numpy twin at 10 and 12 bits on seeded
inputs, and through the stage trace of
whole decodes; the conversion equals libavif's own avifImageYUVToRGB at 10
and 12 bits on seeded planes of every format, matrix and range, with and
without alpha (libyuv's high-bit-depth functions, its 8-bit ones after a
downshift, or libavif's float conversion, as libavif picks); an alpha item
of another bit depth than the colour item fails as in libavif; a frame of
another size than its ispe is scaled as libavif scales it (libyuv's
ScalePlane_16, held to avifImageScale)."""

import ctypes
import os
import sys

import numpy as np
import pytest
import torch

from figdraw_tpu_torch.utils import av1, avif, image_lib, imagefile
from torch_reference import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
import avif_fuzz_agreement as fuzz  # noqa: E402
import make_image_formats as tool  # noqa: E402
from test_torch_av1_chroma import (  # noqa: E402
    FORMATS, MATRICES, PRIMARIES_12, _avif_yuv_to_rgb, _flat_ui, _grain, _libavif, _picture, _pil,
    _pil_avif, _same, _tiles,
)
from test_torch_av1_postfilter import _window  # noqa: E402
from test_torch_avif import _avif_scale, _with_ispe  # noqa: E402
from test_torch_avif import _libavif as _scale_lib  # noqa: E402

torch.set_num_threads(1)

CDEF = {"enable-cdef": "1"}
DEPTHS = (10, 12)


def _headers(data: bytes) -> list:
    """The parsed sequence headers of each item's stream and of each
    av1C's configOBUs."""
    still = avif.parse(data)
    heads = [p for s in (still.color, still.alpha) for k, p in av1.obus(s)
             if k == av1.OBU_SEQUENCE_HEADER]
    at = 0
    while (at := data.find(b"av1C", at + 1)) > 0:
        size = int.from_bytes(data[at - 4:at], "big")
        heads += [p for k, p in av1.obus(data[at + 8:at - 4 + size]) if k == av1.OBU_SEQUENCE_HEADER]
    return [av1.parse_sequence(h) for h in heads]


# --- the rewrite ------------------------------------------------------------------

# (subsampling, bits): the stream's profile and subsampling after the rewrite
HEADER_CASES = {("4:2:0", 10): (0, 1, 1), ("4:0:0", 10): (0, 1, 1), ("4:4:4", 10): (1, 0, 0),
                ("4:2:2", 10): (2, 1, 0), ("4:2:0", 12): (2, 1, 1), ("4:0:0", 12): (2, 1, 1),
                ("4:4:4", 12): (2, 0, 0), ("4:2:2", 12): (2, 1, 0)}


@pytest.mark.parametrize("sub, depth", sorted(HEADER_CASES))
def test_rewritten_headers_parse_to_the_intended_fields(sub, depth):
    """Every sequence header of the file (both items'; libavif writes av1C
    without configOBUs) at the new depth in the intended profile and
    subsampling, every other field kept; av1C's bits (one av1C shared by a
    monochrome colour item and its alpha) and pixi's depths follow."""
    data = _pil_avif(_picture(40, 24, 6, True), subsampling=sub, speed=9)
    before = _headers(data)
    out = tool.avif_at_depth(data, depth)
    after = _headers(out)
    assert len(after) == len(before) == 2
    assert sum(not a.mono for a in after) == (0 if sub == "4:0:0" else 1)
    profile, ssx, ssy = HEADER_CASES[(sub, depth)]
    for b, a in zip(before, after):
        assert a.bit_depth == depth
        assert (a.profile, a.ssx, a.ssy) == ((2 if depth == 12 else 0, 1, 1) if a.mono
                                             else (profile, ssx, ssy))
        changed = {f for f in vars(b) if getattr(b, f) != getattr(a, f)}
        assert changed <= {"bit_depth", "profile", "ssx", "ssy", "chroma_position"}
    still = avif.parse(out)
    assert still.av1c[1:3] == (1, int(depth == 12)) == still.alpha_av1c[1:3]
    assert (still.av1c[4], still.av1c[5]) == (ssx, ssy)
    at = out.find(b"pixi")
    assert list(out[at + 9:at + 9 + out[at + 8]]) == [depth] * out[at + 8]


def _pack(bits) -> bytes:
    bits = list(bits) + [0] * (-len(bits) % 8)
    return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


def test_a_slipped_subsampling_bit_is_caught():
    """The 12-bit 4:2:2 rewrite with its subsampling bits written right
    after twelve_bit (not after color_range): the header then parses as a
    monochrome stream, which PIL would decode to a flat grey without
    complaint; the rewrite's own check refuses it."""
    head = next(p for k, p in av1.obus(avif.parse(
        _pil_avif(_picture(40, 24, 6, False), subsampling="4:2:2", speed=9)).color)
        if k == av1.OBU_SEQUENCE_HEADER)
    seq = av1.parse_sequence(head)
    bits = tool._bits(head, 0, seq.color_bit)
    rest = tool._bits(head, seq.color_bit + 1, len(head) * 8)  # past high_bitdepth
    slipped = _pack(bits + [1, 1, 1, 0] + rest)
    assert av1.parse_sequence(slipped).mono == 1
    with pytest.raises(ValueError, match="mono"):
        tool.check_rewrite(slipped, head, 12)
    good = tool.sequence_header_at(head, 12)
    parsed = av1.parse_sequence(good)
    assert (parsed.mono, parsed.bit_depth, parsed.ssx, parsed.ssy) == (0, 12, 1, 0)


# --- decodes against PIL ------------------------------------------------------------

# (subsampling, bits, alpha, speed): speeds 6 (no post-filter) and 2 with
# CDEF (CDEF, Wiener and self-guided units on the grain picture)
DECODE_CASES = [(sub, depth, alpha, speed) for sub in ("4:0:0", "4:2:0", "4:2:2", "4:4:4")
                for depth in DEPTHS for alpha in (False, True) for speed in (6, 2)]


@pytest.mark.parametrize("sub, depth, alpha, speed", DECODE_CASES)
def test_decode_equals_pil(sub, depth, alpha, speed):
    if speed == 2:
        px = _grain(97, 61)
        if alpha:
            px = np.dstack([px, _picture(97, 61, 5, True)[..., 3]])
        data = _pil_avif(np.ascontiguousarray(px), subsampling=sub, speed=2, advanced=CDEF)
    else:
        data = _pil_avif(_picture(97, 61, 4, alpha), subsampling=sub, speed=6)
    out = tool.avif_at_depth(data, depth)
    got = _same(out)
    assert got.shape == (61, 97, 4)
    frame = av1.decode(avif.parse(out).color)
    assert frame.bit_depth == depth and frame.planes[0].dtype == np.uint16
    if speed == 2:
        assert (frame.cdef >= 0).any() and frame.lr[..., av1.L_TYPE].any()


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("kind", ["ui 4:4:4", "ui 4:2:0", "icons 4:2:0", "icons 4:2:2"])
def test_screen_content_agrees_with_pil(kind, depth):
    """Palettes (the flat UI) and intra block copy (the icon grid): a
    palette's colours are read with BitDepth bits, so the 8-bit stream's
    symbols part from the syntax after the rewrite; the port raises where
    PIL raises, or decodes equal to it."""
    name, sub = kind.split()
    px = _flat_ui() if name == "ui" else _tiles(257, 131)
    data = tool.avif_at_depth(_pil_avif(px, subsampling=sub, speed=6 if name == "ui" else 5),
                              depth)
    assert fuzz.outcome(data)[0] == "equal"


def test_stored_fixtures_are_the_rewrites_of_the_8_bit_ones():
    """The three stored high-depth files: the stored 8-bit files rewritten
    (their profile, subsampling, range and matrix kept), decoded equal to
    PIL; the CDEF file and the 4:2:2 file reach CDEF and both restoration
    filters at their depth."""
    from figdraw_tpu_torch.scenes import IMAGE_FORMATS_DIR

    for name, (source, depth) in tool.AVIF_DEPTHS.items():
        with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
            data = fh.read()
        with open(os.path.join(IMAGE_FORMATS_DIR, source), "rb") as fh:
            assert tool.avif_at_depth(fh.read(), depth) == data
        _same(data)
        still = avif.parse(data)
        seq = _headers(data)[0]
        assert seq.bit_depth == depth
        frame = av1.decode(still.color, plain=True)
        if "cdef" in name or "422" in name:
            assert all(frame.checked[k] for k in ("cdef", "wiener", "sgr")), frame.checked


# --- av1C, pixi and the alpha item ----------------------------------------------------

@pytest.mark.parametrize("colour, alpha", [(10, 8), (8, 10), (10, 12), (12, 10)])
def test_an_alpha_item_of_another_depth_fails(colour, alpha):
    """libavif fails an alpha plane whose depth differs from the colour
    plane's (PIL: "Decoding of alpha plane failed"); so does the port."""
    data = _pil_avif(_picture(40, 24, 6, True), speed=9)
    data = tool.avif_at_depth(data, colour, alpha_depth=alpha) if colour > 8 else \
        _alpha_only(data, alpha)
    with pytest.raises(Exception, match="alpha"):
        _pil(data)
    with pytest.raises(ValueError, match="alpha item"):
        imagefile.decode_image(data)


def _alpha_only(data: bytes, depth: int) -> bytes:
    """The file with its alpha item (and its av1C and pixi) alone at
    `depth` bits: the colour stays at 8."""
    out = tool.avif_at_depth(data, depth)
    colour, deeper = avif.parse(data).color, avif.parse(out).color
    assert len(deeper) == len(colour)  # 4:2:0 at 10 bits: no bit added
    return out.replace(deeper, colour)


def test_the_stream_decides_the_depth_beside_av1c_and_pixi():
    """A 10-bit stream under av1C and pixi that say 8: libavif holds pixi
    to av1C alone, and dav1d decodes the stream at its own depth."""
    data = _pil_avif(_picture(40, 24, 6, False), subsampling="4:4:4", speed=9)
    colour = avif.parse(data).color
    deeper = tool.stream_at(colour, 10)
    assert len(deeper) == len(colour)
    data = data.replace(colour, deeper)
    assert avif.parse(data).av1c[1:3] == (0, 0)
    _same(data)
    assert av1.decode(avif.parse(data).color).bit_depth == 10


# --- the stages against their twins --------------------------------------------------

def _ramp(rng, n, depth, flat=False):
    peak = (1 << depth) - 1
    if flat:
        return np.full(n, rng.integers(0, peak + 1), np.int32)
    step = 12 << (depth - 8)
    return np.clip(rng.integers(0, peak + 1) + np.cumsum(rng.integers(-step, step + 1, n)), 0,
                   peak).astype(np.int32)


def _deep_window(rng, w, h, margin, depth, smooth, outside=None):
    """_window's samples at `depth` bits (-1 outside kept)."""
    win = _window(rng, w, h, margin, smooth, outside)
    deep = (win.astype(np.int64) << (depth - 8)) | rng.integers(0, 1 << (depth - 8), win.shape)
    return np.ascontiguousarray(np.where(win < 0, -1, deep).astype(np.int32))


def _predict(lib, rng, depth):
    for mode in range(13):
        for lw, lh in ((2, 2), (3, 4), (5, 3), (6, 6), (4, 2)):
            w, h = 1 << lw, 1 << lh
            for delta in (range(-3, 4) if 1 <= mode <= 8 else (0,)):
                trial = int(rng.integers(4))
                params = [mode, lw, lh, int(trial != 1), int(trial != 2), delta, trial & 1,
                          int(trial < 3), 0, 0, int(rng.integers(1, 2 * w)),
                          int(rng.integers(1, 2 * h))]
                if mode == 0 and w <= 32 and h <= 32 and rng.integers(3) == 0:
                    params[8:10] = [1, int(rng.integers(5))]
                above, left = _ramp(rng, w + h + 1, depth, trial == 3), _ramp(rng, w + h + 1, depth)
                left[0] = above[0]
                p = np.array(params, np.int32)
                got = np.zeros(w * h, np.uint16)
                assert lib.fd_av1_predict(p.ctypes.data, above.ctypes.data, left.ctypes.data,
                                            depth, got.ctypes.data) == 0
                want = av1.predict_plain(params, above, left, depth)
                np.testing.assert_array_equal(got.reshape(h, w), want, err_msg=str(params))


def _cfl(lib, rng, depth):
    peak = (1 << depth) - 1
    for w, h in ((4, 4), (8, 4), (4, 16), (16, 16), (32, 8), (32, 32)):
        for alpha in (-16, -5, -1, 0, 1, 7, 16):
            L = (rng.integers(0, (peak + 1) * 4, (h, w)) * 2).astype(np.int32)
            dc = np.full((h, w), rng.integers(0, peak + 1), np.uint16)
            got = dc.copy()
            assert lib.fd_av1_cfl(L.ctypes.data, w, h, alpha, depth, got.ctypes.data) == 0
            np.testing.assert_array_equal(got, av1.cfl_plain(L, alpha, dc, depth))


def _txfm(lib, rng, depth):
    for tx in range(19):
        w, h = av1.TX_W[tx], av1.TX_H[tx]
        for tx_type in range(16 if max(w, h) <= 16 else 1):
            deq = np.zeros((64, 64), np.int32)
            tw, th = min(w, 32), min(h, 32)
            k = int(rng.integers(1, tw * th + 1))
            idx = rng.choice(tw * th, k, replace=False)
            scale = int(rng.choice([8, 2000, 1 << (7 + depth)]))
            deq[idx // tw, idx % tw] = rng.integers(-scale, scale, k)
            got = np.zeros(w * h, np.int32)
            assert lib.fd_av1_inv_txfm(deq.ctypes.data, tx, tx_type, 0, depth,
                                         got.ctypes.data) == 0
            np.testing.assert_array_equal(got.reshape(h, w),
                                          av1.inv_txfm_plain(deq, tx, tx_type, 0, depth),
                                          err_msg=f"{tx} {tx_type} {scale}")


def _lf(lib, rng, depth):
    peak, one = (1 << depth) - 1, 1 << (depth - 8)
    for size, plane in ((4, 0), (8, 0), (16, 0), (4, 1), (8, 1)):
        rows = []
        for trial in range(200):
            step, base = int(rng.integers(0, 40)) * one, int(rng.integers(0, 200)) * one
            s = np.concatenate([np.full(8, base), np.full(8, base + step)])
            rows.append(np.clip(s + rng.integers(-2, 3, 16) * one * (trial % 3)
                                + rng.integers(0, one, 16), 0, peak).astype(np.int32))
        for lvl in (4, 20, 40, 63):
            limit = max(1, lvl)
            params = [size, plane, limit, 2 * (lvl + 2) + limit, lvl >> 4]
            p = np.array(params, np.int32)
            got = []
            for s in rows:
                x = s.copy()
                assert lib.fd_av1_lf_edge(x.ctypes.data, p.ctypes.data, depth) == 0
                got.append(x)
            np.testing.assert_array_equal(np.array(got),
                                          av1.lf_edge_plain(np.array(rows), params, depth))


def _cdef(lib, rng, depth):
    for plane, w, h in ((0, 8, 8), (1, 4, 4), (1, 4, 8), (1, 8, 8)):
        for trial in range(150):
            pri, sec = int(rng.integers(0, 16)), int((0, 1, 2, 4)[rng.integers(4)])
            damping = int(rng.integers(3, 7)) - plane
            ydir = int(rng.integers(0, 8)) if plane else -1
            cut = tuple(int(v) for v in rng.integers(0, 3, 4) * (rng.random(4) < 0.3)) \
                if trial % 2 else None
            win = _deep_window(rng, w, h, 2, depth, trial % 3 == 0, cut)
            out = np.zeros(w * h, np.uint16)
            dv = np.zeros(2, np.int32)
            assert lib.fd_av1_cdef_block(win.ctypes.data, w, h, plane, pri, sec, damping, ydir,
                                           depth, out.ctypes.data, dv.ctypes.data) == 0
            d, var, want = av1.cdef_block_plain(win, plane, pri, sec, damping, ydir, depth)
            assert (d, var) == tuple(dv), (pri, sec, damping)
            np.testing.assert_array_equal(out.reshape(h, w), want, err_msg=f"{pri} {sec}")


def _wiener(lib, rng, depth):
    lo, hi = av1.T.WIENER_TAPS_MIN, av1.T.WIENER_TAPS_MAX
    for w, h in ((1, 1), (5, 4), (64, 64), (70, 3)):
        for trial in range(8):
            taps = np.array([rng.integers(lo[k], hi[k] + 1) for k in range(3)]
                            + [rng.integers(lo[k], hi[k] + 1) for k in range(3)], np.int32)
            if trial == 0:
                taps = np.concatenate([lo, hi]).astype(np.int32)
            win = _deep_window(rng, w, h, 3, depth, trial % 3 == 0)
            out = np.zeros(w * h, np.uint16)
            assert lib.fd_av1_wiener(win.ctypes.data, w, h, taps.ctypes.data, depth,
                                       out.ctypes.data) == 0
            np.testing.assert_array_equal(out.reshape(h, w),
                                          av1.wiener_plain(win, taps[:3], taps[3:], depth))


def _sgr(lib, rng, depth):
    lo, hi = av1.T.SGRPROJ_XQD_MIN, av1.T.SGRPROJ_XQD_MAX
    for sgr_set in range(16):
        r0 = int(av1.T.SGR_PARAMS[sgr_set, 0])
        for trial in range(3):
            w, h = int(rng.integers(1, 40)), int(rng.integers(1, 40))
            xqd = np.array([rng.integers(lo[0], hi[0] + 1) if r0 else 0,
                            rng.integers(lo[1], hi[1] + 1)], np.int32)
            win = _deep_window(rng, w, h, 3, depth, trial % 2 == 0)
            out = np.zeros(w * h, np.uint16)
            assert lib.fd_av1_sgr(win.ctypes.data, w, h, sgr_set, xqd.ctypes.data, depth,
                                    out.ctypes.data) == 0
            np.testing.assert_array_equal(out.reshape(h, w),
                                          av1.sgr_plain(win, sgr_set, xqd, depth))


STAGES = {"predict": _predict, "cfl": _cfl, "txfm": _txfm, "lf": _lf, "cdef": _cdef,
          "wiener": _wiener, "sgr": _sgr}


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_stage_equals_its_twin_at_depth(stage, depth):
    """Each C++ stage alone at 10 and 12 bits (fd_av1_predict, fd_av1_cfl
    and the others) against its numpy twin on seeded inputs of the bit
    depth: every predictor and size with
    filter intra, CfL, every transform size and type with coefficients up
    to the dequantiser's clamp, the loop filter's lengths, CDEF's luma and
    chroma blocks cut by the frame, Wiener and self-guided units."""
    STAGES[stage](image_lib.load_av1(), np.random.default_rng(depth * 31 + len(stage)), depth)


def test_the_stage_entry_points_refuse_other_depths():
    lib = image_lib.load_av1()
    win = np.zeros(144, np.int32)
    out = np.zeros(64, np.uint16)
    dv = np.zeros(2, np.int32)
    for bad in (7, 9, 11, 16):
        assert lib.fd_av1_cdef_block(win.ctypes.data, 8, 8, 0, 1, 0, 3, -1, bad,
                                       out.ctypes.data, dv.ctypes.data) == -2


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4"])
def test_plain_decode_checks_every_stage_at_depth(sub, depth):
    """decode(plain=True) of a CDEF and restoration file at 10 and 12 bits:
    the trace opens each stage's records with the bit depth, and every
    traced prediction, CfL, transform, loop-filter (where aom keeps it on),
    CDEF, Wiener and self-guided call equals its twin at that depth; the
    plain conversion's image equals PIL's."""
    data = tool.avif_at_depth(_pil_avif(_grain(130, 96), subsampling=sub, speed=2,
                                        advanced=CDEF), depth)
    lib = image_lib.load_av1()
    buf = np.zeros(60 * 1024 * 1024 // 4, np.int32)
    lib.fd_av1_trace(buf.ctypes.data, buf.size)
    av1.decode(avif.parse(data).color)
    n = lib.fd_av1_trace(ctypes.c_void_p(0), 0)
    assert n > 0
    assert buf[0] == 8 and buf[1] == depth  # the tile's depth record first
    counts = av1.check_trace(buf[:n])
    assert all(counts[k] > 0 for k in ("predict", "cfl", "txfm", "cdef", "wiener", "sgr")), counts
    np.testing.assert_array_equal(avif.decode_avif(data, plain=True), _pil(data))


# --- the conversion against libavif -------------------------------------------------

@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("full", [1, 0], ids=["full", "limited"])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_to_rgb_and_its_twin_equal_libavifs_conversion_at_depth(fmt, full, depth):
    """fd_av1_to_rgb and to_rgba_plain against avifImageYUVToRGB on seeded
    planes of 10 and 12 bits (odd and even sizes from 1x1, padded as
    decoded) for every matrix, matrix 12's primaries, with and without
    alpha: equal where libavif converts (libyuv's 10-bit functions with
    alpha, I012ToARGBMatrix for 12-bit 4:2:0 with alpha, a downshift to
    8 bits and its 8-bit functions, or its float conversion at the depth),
    and `conversion` raises ValueError where it fails."""
    lib = _libavif()
    av1lib = image_lib.load_av1()
    ssx, ssy, mono = FORMATS[fmt]
    rng = np.random.default_rng(len(fmt) * 7 + full + depth)
    peak = (1 << depth) - 1
    null = ctypes.c_void_p(0)
    routes = set()
    for matrix in MATRICES:
        for primaries in (PRIMARIES_12 if matrix == 12 else (2,)):
            h, w = (int(v) for v in rng.integers(1, 30, 2))
            y = rng.integers(0, peak + 1, (h, w)).astype(np.uint16)
            cshape = ((h + ssy) >> ssy, (w + ssx) >> ssx)
            u, v = (rng.integers(0, peak + 1, cshape).astype(np.uint16) for _ in range(2))
            for alpha in (None, rng.integers(0, peak + 1, (h, w)).astype(np.uint16)):
                want = _avif_yuv_to_rgb(lib, [y] if mono else [y, u, v], alpha, fmt, full,
                                        matrix, primaries, depth)
                if want is None:
                    with pytest.raises(ValueError, match="Reformat failed"):
                        av1.conversion(mono, ssx, ssy, full, matrix, primaries,
                                       alpha is not None, depth)
                    continue
                conv = av1.conversion(mono, ssx, ssy, full, matrix, primaries, alpha is not None,
                                      depth)
                routes.add((int(conv[av1.C_ROUTE]), int(conv[av1.C_DOWN]),
                            int(conv[av1.C_NEAREST])))

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
                msg = f"{fmt} full {full} matrix {matrix} primaries {primaries} alpha " \
                      f"{alpha is not None}"
                np.testing.assert_array_equal(out, want, err_msg=msg)
                np.testing.assert_array_equal(av1.to_rgba_plain(yp, up, vp, alpha, w, h, conv),
                                              want, err_msg=msg)
    # the float conversion at the depth and the downshift everywhere;
    # libyuv's high-bit-depth functions for colour with alpha at 10 bits
    # and for 4:2:0 at 12 (I012ToARGBMatrix, nearest chroma)
    assert (av1.ROUTE_FLOAT, 0, 0) in routes
    assert any(down for _r, down, _n in routes)
    if not mono and (depth == 10 or ssy):
        assert (av1.ROUTE_LIBYUV, 0, int(depth == 12)) in routes


def test_alpha_rescale_equals_libavifs_over_every_value():
    """The alpha plane to 8 bits over every 10- and 12-bit value: libyuv's
    shift where its 10-bit alpha function converts, libavif's rounding
    (a * 255 / max) where libavif reformats the alpha itself."""
    lib = _libavif()
    for depth in DEPTHS:
        peak = (1 << depth) - 1
        a = np.arange(peak + 1).reshape(-1, 64).astype(np.uint16)
        h, w = a.shape
        y = np.full((h, w), 1 << (depth - 1), np.uint16)
        for fmt, full, matrix in (("4:2:0", 1, 1), ("4:4:4", 1, 4), ("4:0:0", 0, 6)):
            ssx, ssy, mono = FORMATS[fmt]
            c = np.full(((h + ssy) >> ssy, (w + ssx) >> ssx), 1 << (depth - 1), np.uint16)
            want = _avif_yuv_to_rgb(lib, [y] if mono else [y, c, c], a, fmt, full, matrix, 2,
                                    depth)
            conv = av1.conversion(mono, ssx, ssy, full, matrix, 2, True, depth)
            got = av1.to_rgba_plain(y, None if mono else c, None if mono else c, a, w, h, conv)
            np.testing.assert_array_equal(got[..., 3], want[..., 3], err_msg=f"{depth} {fmt}")


# --- the scale to ispe ------------------------------------------------------------

def test_scale16_and_its_twin_equal_libavifs_scale():
    """fd_av1_scale and scale_plain on uint16 planes against libavif's
    own avifImageScale at 10 and 12 bits (libyuv's ScalePlane_16: its box
    sums unwrapped, its C column filter) over the paths ScalePlane takes;
    the 3/4 and 3/8 scales refused."""
    lib = _scale_lib()
    rng = np.random.default_rng(28)
    refused = 0
    for trial in range(200):
        depth = DEPTHS[trial & 1]
        sw, sh = int(rng.integers(1, 70)), int(rng.integers(1, 70))
        dw, dh = int(rng.integers(1, 140)), int(rng.integers(1, 140))
        k = trial % 10
        if k == 0:
            dw = sw
        elif k == 1:
            dh = sh
        elif k in (2, 3):
            dw, dh = max(1, sw // (2 * (k - 1))), max(1, sh // (2 * (k - 1)))
        elif k == 4:
            dw, dh = 2 * sw - (trial & 1), 2 * sh - ((trial >> 1) & 1)
        elif k == 5:
            dw = 2 * sw - (trial & 1)
        elif k == 6:
            sw = 1
        elif k == 7:
            sw, sh = 4 * int(rng.integers(1, 12)), 8 * int(rng.integers(1, 6))
            dw, dh = (3 * sw // 4, 3 * sh // 4) if trial & 1 else (3 * sw // 8, 3 * sh // 8)
        dw, dh = max(1, dw), max(1, dh)
        src = rng.integers(0, 1 << depth, (sh, sw)).astype(np.uint16)
        twin = av1.scale_plain(src, dw, dh)
        if twin is None:
            with pytest.raises(NotImplementedError, match="another size than ispe"):
                av1.scale(src, sw, sh, dw, dh)
            refused += 1
            continue
        want = _avif_scale(lib, src, dw, dh, depth)
        np.testing.assert_array_equal(twin, want, err_msg=f"{sw}x{sh} to {dw}x{dh}")
        np.testing.assert_array_equal(av1.scale(src, sw, sh, dw, dh, plain=True), want)
    assert refused == 20


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("size", [(192, 128), (48, 32), (97, 64), (96, 65)])
def test_a_frame_of_another_size_than_ispe_is_scaled_as_pil_at_depth(size, depth):
    data = tool.avif_at_depth(_pil_avif(_picture(96, 64, 4, True), speed=9), depth)
    _same(_with_ispe(data, *size))
