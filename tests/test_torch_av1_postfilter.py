"""The AV1 decoder's post-filters (figdraw_tpu_torch/utils/av1.py, their C++
in csrc/av1_decode.cpp): each C++ stage alone against its numpy twin on
seeded windows (CDEF of a luma 8x8 with its direction search and of a
chroma 4x4, at every strength, damping and with samples outside the frame;
the Wiener filter at the taps' extremes; the self-guided filter with each
of the 16 parameter sets), the direction search against the lines of a
picture, the frame headers' cdef_params and lr_params on files PIL 12.1.0
writes, the CDEF indices and restoration units fd_av1_tile reads, and the
conditions that keep both tools off (coded lossless, intra block copy)."""

import os
import sys

import numpy as np
import pytest
import torch

from figdraw_tpu_torch.utils import av1, image_lib
from torch_reference import REPO

sys.path.insert(0, os.path.join(REPO, "tests"))
from test_torch_av1 import _corpus, _headers  # noqa: E402

torch.set_num_threads(1)


def _window(rng, w, h, margin, smooth, outside=None):
    """(h + 2 margin, w + 2 margin) int32 samples: noise or a noisy ramp;
    `outside` (top, bottom, left, right) rows / columns of -1 (CDEF's
    samples outside the frame)."""
    H, W = h + 2 * margin, w + 2 * margin
    if smooth:
        gy, gx = np.mgrid[0:H, 0:W]
        win = np.clip(gx * rng.integers(-6, 7) + gy * rng.integers(-6, 7) + rng.integers(60, 200)
                      + rng.integers(-3, 4, (H, W)), 0, 255)
    else:
        win = rng.integers(0, 256, (H, W))
    win = win.astype(np.int32)
    if outside is not None:
        top, bottom, left, right = outside
        win[:top] = -1
        win[H - bottom:] = -1
        win[:, :left] = -1
        win[:, W - right:] = -1
    return np.ascontiguousarray(win)


@pytest.mark.parametrize("plane", [0, 1])
def test_cdef_blocks_equal_their_twin(plane):
    """fd_av1_cdef_block against cdef_block_plain: every primary strength
    (0-15) and secondary (0, 1, 2, 4), dampings 3-6 (chroma one less), each
    luma direction for chroma, windows cut by the frame's edges."""
    lib = image_lib.load_av1()
    rng = np.random.default_rng(plane)
    n = 8 if plane == 0 else 4
    for trial in range(400):
        pri, sec = int(rng.integers(0, 16)), int((0, 1, 2, 4)[rng.integers(4)])
        damping = int(rng.integers(3, 7)) - plane
        ydir = int(rng.integers(0, 8)) if plane else -1
        cut = tuple(int(v) for v in rng.integers(0, 3, 4) * (rng.random(4) < 0.3)) \
            if trial % 2 else None
        win = _window(rng, n, n, 2, trial % 3 == 0, cut)
        out = np.zeros(n * n, np.uint16)
        dv = np.zeros(2, np.int32)
        assert lib.fd_av1_cdef_block(win.ctypes.data, n, n, plane, pri, sec, damping, ydir, 8,
                                     out.ctypes.data, dv.ctypes.data) == 0
        d, var, want = av1.cdef_block_plain(win, plane, pri, sec, damping, ydir)
        assert (d, var) == tuple(dv), (pri, sec, damping)
        np.testing.assert_array_equal(out.reshape(n, n), want, err_msg=f"{pri} {sec} {damping}")


def test_cdef_direction_follows_the_lines():
    """The direction search finds rows (direction 2), columns (6) and both
    diagonals (0 and 4) of an 8x8 striped two samples wide, with a variance
    that grows with
    the stripes' contrast; a flat block costs the same in every direction
    (the divisors' purpose): direction 0, variance 0."""
    i, j = np.mgrid[0:8, 0:8]
    for lines, want in ((i, 2), (j, 6), (i + j, 0), (i - j, 4)):
        variances = []
        for contrast in (20, 60):
            block = (128 + contrast * (((lines // 2) % 2) * 2 - 1)).astype(np.int32)
            d, var = av1.cdef_direction_plain(block)
            assert d == want, (want, d)
            variances.append(var)
        assert 0 < variances[0] < variances[1]
    assert av1.cdef_direction_plain(np.full((8, 8), 77)) == (0, 0)


WIENER_CASES = [(w, h) for w in (1, 5, 64, 70) for h in (1, 4, 64)]


@pytest.mark.parametrize("w, h", WIENER_CASES)
def test_wiener_equals_its_twin(w, h):
    """fd_av1_wiener against wiener_plain: seeded taps across their ranges
    (chroma's tap 0 is 0), the extremes, on noise (whose intermediate the
    clip bounds) and on ramps."""
    lib = image_lib.load_av1()
    rng = np.random.default_rng(w * 100 + h)
    lo, hi = av1.T.WIENER_TAPS_MIN, av1.T.WIENER_TAPS_MAX
    for trial in range(12):
        if trial == 0:
            taps = np.concatenate([lo, lo])
        elif trial == 1:
            taps = np.concatenate([hi, hi])
        else:
            taps = np.array([rng.integers(lo[k], hi[k] + 1) for k in range(3)] * 2)
            taps[3:] = [rng.integers(lo[k], hi[k] + 1) for k in range(3)]
            if trial % 2:
                taps[[0, 3]] = 0
        taps = taps.astype(np.int32)
        win = _window(rng, w, h, 3, trial % 3 == 0)
        out = np.zeros(w * h, np.uint16)
        assert lib.fd_av1_wiener(win.ctypes.data, w, h, taps.ctypes.data, 8, out.ctypes.data) == 0
        np.testing.assert_array_equal(out.reshape(h, w), av1.wiener_plain(win, taps[:3], taps[3:]),
                                      err_msg=str(taps))


def test_wiener_of_zero_taps_is_the_identity():
    win = _window(np.random.default_rng(3), 9, 7, 3, False)
    np.testing.assert_array_equal(av1.wiener_plain(win, (0, 0, 0), (0, 0, 0)), win[3:-3, 3:-3])


@pytest.mark.parametrize("sgr_set", range(16))
def test_sgr_equals_its_twin(sgr_set):
    """fd_av1_sgr against sgr_plain for one parameter set (radius 2 on
    every other row, radius 1, or both): seeded weights in their ranges
    (0 where the set's radius is 0), odd and even block heights, noise
    and ramps."""
    lib = image_lib.load_av1()
    rng = np.random.default_rng(sgr_set)
    r0, r1 = int(av1.T.SGR_PARAMS[sgr_set, 0]), int(av1.T.SGR_PARAMS[sgr_set, 1])
    lo, hi = av1.T.SGRPROJ_XQD_MIN, av1.T.SGRPROJ_XQD_MAX
    for trial in range(10):
        w, h = int(rng.integers(1, 70)), int(rng.integers(1, 65))
        xqd = np.array([rng.integers(lo[0], hi[0] + 1) if r0 else 0,
                        rng.integers(lo[1], hi[1] + 1)], np.int32)
        win = _window(rng, w, h, 3, trial % 2 == 0)
        out = np.zeros(w * h, np.uint16)
        assert lib.fd_av1_sgr(win.ctypes.data, w, h, sgr_set, xqd.ctypes.data, 8,
                              out.ctypes.data) == 0
        np.testing.assert_array_equal(out.reshape(h, w), av1.sgr_plain(win, sgr_set, xqd),
                                      err_msg=f"{w}x{h} {xqd}")
    assert r0 or r1


def test_the_stage_entry_points_refuse_bad_arguments():
    lib = image_lib.load_av1()
    win = np.zeros(144, np.int32)
    out = np.zeros(64, np.uint16)
    dv = np.zeros(2, np.int32)
    assert lib.fd_av1_cdef_block(win.ctypes.data, 8, 8, 0, 16, 0, 3, -1, 8, out.ctypes.data,
                                 dv.ctypes.data) == -2  # a primary strength past 15
    assert lib.fd_av1_cdef_block(win.ctypes.data, 4, 4, 1, 1, 0, 2, -1, 8, out.ctypes.data,
                                 dv.ctypes.data) == -2  # chroma without the luma direction
    assert lib.fd_av1_sgr(win.ctypes.data, 2, 2, 16, dv.ctypes.data, 8, out.ctypes.data) == -2


# --- the headers and what the tiles read -------------------------------------------

def _strengths(hdr, at):
    return hdr[at:at + 8]


@pytest.mark.parametrize("name, cdef, lr", [
    ("cdef:6", True, False), ("cdef:2", True, True), ("crop:0", False, True),
    ("lr:2,40", True, True), ("sb:64", True, None), ("cdefmono:", True, None),
    ("crop:10", False, False), ("ui:6", False, False)])
def test_cdef_and_lr_params(name, cdef, lr):
    """cdef_params: damping 3-6, cdef_bits 0-3, strengths 0-15 and 0-4
    (a secondary 3 read as 4) for the 1 << cdef_bits indices and 0 past
    them, none for chroma in 4:0:0; read as off (damping 3) where the
    sequence leaves CDEF off. lr_params: each plane's type, unit sizes 64,
    128 or 256 (luma at least the superblock's 64 or 128; chroma the same
    or half), the unit counts of count_units_in_frame. `lr` None: either."""
    seq, fh = _headers(_corpus(name))
    hdr = fh["hdr"]
    assert hdr[av1.H_CDEF_READ] == cdef == bool(seq.enable_cdef)
    bits = int(hdr[av1.H_CDEF_BITS])
    y_pri, y_sec = _strengths(hdr, av1.H_CDEF_Y_PRI), _strengths(hdr, av1.H_CDEF_Y_SEC)
    uv_pri, uv_sec = _strengths(hdr, av1.H_CDEF_UV_PRI), _strengths(hdr, av1.H_CDEF_UV_SEC)
    if cdef:
        assert 3 <= hdr[av1.H_CDEF_DAMPING] <= 6 and 0 <= bits <= 3
        for arr, top in ((y_pri, 15), (y_sec, 4), (uv_pri, 15), (uv_sec, 4)):
            assert arr.max() <= top and not arr[1 << bits:].any()
        assert 3 not in y_sec and 3 not in uv_sec
        if seq.mono:
            assert not (uv_pri | uv_sec).any()
    else:
        assert hdr[av1.H_CDEF_DAMPING] == 3 and bits == 0
        assert not (y_pri | y_sec | uv_pri | uv_sec).any()
    types = hdr[av1.H_LR_TYPE:av1.H_LR_TYPE + 3]
    if lr is not None:
        assert bool(types.any()) == lr == bool(seq.enable_restoration)
    sizes = hdr[av1.H_LR_SIZE:av1.H_LR_SIZE + 3]
    width, height = int(hdr[av1.H_WIDTH]), int(hdr[av1.H_HEIGHT])
    for p in range(3):
        if not types[p]:
            assert hdr[av1.H_LR_ROWS + p] == hdr[av1.H_LR_COLS + p] == 0
            continue
        assert sizes[p] in (64, 128, 256) if p == 0 else sizes[p] in (sizes[0], sizes[0] // 2)
        assert sizes[0] >= (128 if seq.use128 else 64)
        ss = int(p > 0)
        for n, at in ((height, av1.H_LR_ROWS), (width, av1.H_LR_COLS)):
            plane = (n + ss) >> ss
            assert hdr[at + p] == max((plane + sizes[p] // 2) // sizes[p], 1)


@pytest.mark.parametrize("name", ["cdeflossless:", "cdeficons:"])
def test_coded_lossless_and_intra_block_copy_keep_both_tools_off(name):
    """The sequence turns CDEF (and, at speed 2, loop restoration) on;
    a coded-lossless frame or one with intra block copy reads neither, and
    no 64x64 gets a CDEF index (each file equals PIL in
    test_corpus_equals_pil)."""
    data = _corpus(name)
    seq, fh = _headers(data)
    hdr = fh["hdr"]
    assert seq.enable_cdef
    assert hdr[av1.H_LOSSLESS:av1.H_LOSSLESS + 8].all() or hdr[av1.H_ALLOW_INTRABC]
    assert hdr[av1.H_CDEF_READ] == 0 and not hdr[av1.H_LR_TYPE:av1.H_LR_TYPE + 3].any()
    from figdraw_tpu_torch.utils import avif

    frame = av1.decode(avif.parse(data).color)
    assert (frame.cdef == -1).all() and not frame.lr.any()


@pytest.mark.parametrize("name", ["lr:2,40", "grain:257x129", "sb:64", "lrtiles:", "cdef:0"])
def test_tiles_read_cdef_indices_and_restoration_units(name):
    """fd_av1_tile's out-arrays: a CDEF index below 1 << cdef_bits at each
    64x64 with a block that is not skipped, -1 where every block skips;
    each unit's type one of its plane's (NONE or the frame's type, or any
    with SWITCHABLE), Wiener taps in their ranges (chroma's tap 0 is 0),
    self-guided weights in theirs (0 where the set's radius is 0)."""
    from figdraw_tpu_torch.utils import avif

    data = _corpus(name)
    _seq, fh = _headers(data)
    hdr = fh["hdr"]
    frame = av1.decode(avif.parse(data).color)
    bits = int(hdr[av1.H_CDEF_BITS])
    assert frame.cdef.min() >= -1 and frame.cdef.max() < 1 << bits
    rows, cols = frame.mi.shape[:2]
    skips = np.ones(frame.cdef.shape, bool)
    for r in range(rows):
        for c in range(cols):
            skips[r >> 4, c >> 4] &= bool(frame.mi[r, c, av1.M_SKIP])
    np.testing.assert_array_equal(frame.cdef == -1, skips)
    lo, hi = av1.T.WIENER_TAPS_MIN, av1.T.WIENER_TAPS_MAX
    for p in range(3):
        ftype = int(hdr[av1.H_LR_TYPE + p])
        n = int(hdr[av1.H_LR_ROWS + p] * hdr[av1.H_LR_COLS + p])
        units = frame.lr[p, :n]
        allowed = {av1.RESTORE_NONE, ftype} if ftype != av1.RESTORE_SWITCHABLE else {0, 1, 2}
        assert set(units[:, av1.L_TYPE].tolist()) <= allowed
        for u in units:
            if u[av1.L_TYPE] == av1.RESTORE_WIENER:
                taps = u[av1.L_WIENER:av1.L_WIENER + 6].reshape(2, 3)
                assert (taps >= lo).all() and (taps <= hi).all()
                assert p == 0 or not taps[:, 0].any()
            elif u[av1.L_TYPE] == av1.RESTORE_SGRPROJ:
                s = int(u[av1.L_SET])
                x0, x1 = u[av1.L_XQD], u[av1.L_XQD + 1]
                assert av1.T.SGRPROJ_XQD_MIN[0] <= x0 <= av1.T.SGRPROJ_XQD_MAX[0]
                assert av1.T.SGRPROJ_XQD_MIN[1] <= x1 <= av1.T.SGRPROJ_XQD_MAX[1]
                assert av1.T.SGR_PARAMS[s, 0] or x0 == 0
        assert not frame.lr[p, n:].any()
