"""AV1 film grain synthesis in the port's decoder (utils/av1.py's
parse_film_grain, film_grain and its twin film_grain_plain; csrc's
fd_av1_film_grain) against PIL 12.1.0, whose libavif 1.3.0 opens dav1d
1.5.1 with the grain applied (figdraw_tpu reads AVIF through PIL):

- fd_av1_film_grain equals film_grain_plain exactly on seeded parameter
  sets at 8, 10 and 12 bits in 4:2:0, 4:2:2, 4:4:4 and 4:0:0 over
  1x1 to 201x77 frames (every AR lag, scaling, AR and grain scale shift,
  0-14 luma points, chroma scaled from luma, overlap on and off, both
  clips), and so do its templates and scaling lookups;
- PIL-written files equal PIL byte for byte: aom's film-grain-test
  vectors 1-16 in each layout (each also decoded with the twins,
  `decode(plain=True)`), with alpha (the alpha item takes grain too),
  denoise levels on a noisy picture, 10 and 12 bits (avif_at_depth), a
  grid whose tiles each carry their own grain, a frame scaled to another
  ispe after its grain; seeded parameter sets written into PIL-written
  files (tools/make_image_formats.py's avif_with_grain), whose planes also
  equal dav1d's own grained planes (PIL's libavif exports dav1d's API:
  decoded with apply_grain 0, then dav1d_apply_grain);
- the film grain headers dav1d rejects raise ValueError where PIL fails;
- seeded cases of tools/avif_fuzz_agreement.py --grain.
The stored grain files (fixture_grain.avif, fixture_grain_422_10bit.avif)
run through tests/test_torch_avif.py's FIXTURES: PIL's digests,
load_image against figdraw_tpu's (pixels, mips, sidecar), the image-file
scene and the photo wall against figdraw_tpu's block means."""

import ctypes
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from figdraw_tpu_torch.scenes import AVIF_GRAIN_422_10_FIXTURE, AVIF_GRAIN_FIXTURE
from figdraw_tpu_torch.utils import av1, avif, image_lib, imagefile
from torch_reference import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
import avif_fuzz_agreement as fuzz  # noqa: E402
import make_image_formats as tool  # noqa: E402
from test_torch_av1_chroma import _fixture, _pil, _pil_avif, _same  # noqa: E402
from test_torch_avif import _with_ispe  # noqa: E402

LAYOUTS = {"4:2:0": (0, 1, 1), "4:2:2": (0, 1, 0), "4:4:4": (0, 0, 0), "4:0:0": (1, 1, 1)}
SIZES = [(1, 1), (17, 3), (33, 31), (65, 65), (130, 96), (201, 77)]
DEPTHS = (8, 10, 12)


def _seq(layout: str, depth: int = 8, matrix: int = 6) -> SimpleNamespace:
    """The sequence header fields film_grain_params depend on."""
    mono, ssx, ssy = LAYOUTS[layout]
    return SimpleNamespace(mono=mono, ssx=ssx, ssy=ssy, bit_depth=depth, matrix=matrix)


def _points(rng, n: int) -> list:
    return [(int(x), int(rng.integers(0, 256))) for x in sorted(rng.choice(256, n, replace=False))]


def _params(i: int, seq) -> dict:
    """Seeded film grain parameters (avif_with_grain's dict), every option
    cycled by the case index: the AR lag, the shifts, 0-14 luma points,
    chroma scaled from luma, overlap and the clip."""
    rng = np.random.default_rng([i, 30])
    ny = (0, 1, 2, 5, 9, 14)[i % 6]
    q = dict(seed=int(rng.integers(0, 65536)), y=_points(rng, ny),
             csfl=int(i % 5 == 1 and not seq.mono), scaling_shift=8 + i % 4, lag=(i // 3) % 4,
             ar_y=rng.integers(-128, 128, 24).tolist(), ar_cb=rng.integers(-128, 128, 25).tolist(),
             ar_cr=rng.integers(-128, 128, 25).tolist(), ar_shift=6 + (i // 2) % 4,
             grain_scale_shift=(i // 4) % 4, overlap=(i // 7) % 2, clip=(i // 11) % 2)
    for name in ("cb", "cr"):
        q.update({name + "_mult": int(rng.integers(-128, 128)),
                  name + "_luma_mult": int(rng.integers(-128, 128)),
                  name + "_offset": int(rng.integers(-256, 256))})
    ncb, ncr = int(rng.integers(0, 11)), int(rng.integers(0, 11))
    if seq.ssx and seq.ssy and (ncb == 0) != (ncr == 0):  # dav1d rejects one without the other
        ncr = ncb
    q["cb"], q["cr"] = _points(rng, ncb), _points(rng, ncr)
    return q


def _g(q: dict, seq) -> np.ndarray:
    """The G_FIELDS array the parser reads from the parameters' bits."""
    bits = tool.film_grain_bits(q, seq)
    data = bytes(int("".join(map(str, (bits + [0] * 7)[k:k + 8])), 2)
                 for k in range(0, len(bits), 8))
    return av1.parse_film_grain(av1.BitReader(data), seq)


def _planes(rng, w: int, h: int, seq) -> tuple:
    """Seeded planes of a w x h frame, wider and taller than it (padded
    decode buffers), the samples' range of the depth."""
    dtype = np.uint8 if seq.bit_depth == 8 else np.uint16
    top = 1 << seq.bit_depth
    ph, pw = h + 5, w + 7
    y = rng.integers(0, top, (ph, pw)).astype(dtype)
    if seq.mono:
        return y, None, None
    shape = ((ph + seq.ssy) >> seq.ssy, (pw + seq.ssx) >> seq.ssx)
    return y, rng.integers(0, top, shape).astype(dtype), rng.integers(0, top, shape).astype(dtype)


def _fd_grain(planes, w: int, h: int, g: np.ndarray) -> tuple:
    """fd_av1_film_grain's planes, templates and scaling lookups."""
    out = [p.copy() if p is not None else None for p in planes]
    templ = np.zeros((3, av1.GRAIN_H, av1.GRAIN_W), np.int16)
    scal = np.zeros((3, 4096), np.uint8)
    null = ctypes.c_void_p(0)

    def ptr(p):
        return p.ctypes.data if p is not None else null

    rc = image_lib.load_av1().fd_av1_film_grain(
        g.ctypes.data, w, h, *(ptr(p) for p in planes), planes[0].shape[1],
        planes[1].shape[1] if planes[1] is not None else 0, *(ptr(p) for p in out),
        templ.ctypes.data, scal.ctypes.data)
    assert rc == 0
    return out, templ, scal


TWIN_CASES = [(layout, depth, size) for layout in LAYOUTS for depth in DEPTHS for size in SIZES]


@pytest.mark.parametrize("layout, depth, size", TWIN_CASES)
def test_grain_equals_its_twin(layout, depth, size):
    """fd_av1_film_grain against film_grain_plain on a seeded parameter set
    and seeded planes: every plane equal (the samples past the frame
    untouched), the templates and the scaling lookups equal."""
    i = TWIN_CASES.index((layout, depth, size))
    seq = _seq(layout, depth, matrix=0 if i % 3 == 0 else 1)  # the identity's chroma clip
    g = _g(_params(i, seq), seq)
    rng = np.random.default_rng([i, 31])
    planes = _planes(rng, *size, seq)
    got, templ, scal = _fd_grain(planes, *size, g)
    want = av1.film_grain_plain(planes, *size, g)
    for k, (a, b) in enumerate(zip(got, want)):
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(a, b, err_msg=f"plane {k}")
        sx, sy = (seq.ssx, seq.ssy) if k else (0, 0)
        pw, ph = (size[0] + sx) >> sx, (size[1] + sy) >> sy
        np.testing.assert_array_equal(a[ph:], planes[k][ph:])
        np.testing.assert_array_equal(a[:, pw:], planes[k][:, pw:])
    np.testing.assert_array_equal(templ, av1.grain_templates_plain(g))
    for k in range(3):
        n = int(g[av1.G_NUM_Y] if k == 0 else g[av1.G_NUM_UV + k - 1])
        at = av1.G_Y_POINTS if k == 0 else av1.G_UV_POINTS + 20 * (k - 1)
        if n or (k == 0 and g[av1.G_CSFL]):
            np.testing.assert_array_equal(scal[k, :1 << depth],
                                          av1.grain_scaling_plain(g[at:], n, depth))


def test_the_seeded_sets_cover_every_option():
    seen = {k: set() for k in ("lag", "scaling_shift", "ar_shift", "grain_scale_shift", "overlap",
                               "clip", "csfl", "ny")}
    for i, (layout, depth, _size) in enumerate(TWIN_CASES):
        q = _params(i, _seq(layout, depth))
        for k in seen:
            seen[k].add(len(q["y"]) if k == "ny" else q[k])
    assert seen == {"lag": {0, 1, 2, 3}, "scaling_shift": {8, 9, 10, 11}, "ar_shift": {6, 7, 8, 9},
                    "grain_scale_shift": {0, 1, 2, 3}, "overlap": {0, 1}, "clip": {0, 1},
                    "csfl": {0, 1}, "ny": {0, 1, 2, 5, 9, 14}}


@pytest.mark.parametrize("depth", DEPTHS)
def test_scaling_lookup_interpolates_between_the_points(depth):
    """dav1d's generate_scaling: the first point's value before it, the
    last's after it, exact at the points, and (at 10 and 12 bits) each
    spread 8-bit step rounded between its ends."""
    pts = [10, 40, 100, 200, 180, 20, 250, 255]
    lut = av1.grain_scaling_plain(pts, 4, depth).astype(int)
    s = depth - 8
    assert lut.shape == (1 << depth,)
    assert (lut[:10 << s] == 40).all() and (lut[250 << s:] == 255).all()
    for x, v in zip(pts[::2], pts[1::2]):
        assert lut[x << s] == v
    assert (np.diff(lut[10 << s:(100 << s) + 1]) >= 0).all()
    assert (np.diff(lut[100 << s:(180 << s) + 1]) <= 0).all()
    assert not av1.grain_scaling_plain([], 0, depth).any()


# --- PIL-written files ---------------------------------------------------------------

def _dav1d():
    """PIL's libavif with dav1d's API bound (it exports dav1d's symbols)."""
    lib = fuzz.libavif()
    p = ctypes.c_void_p
    for name, args, res in (("dav1d_default_settings", [p], None),
                            ("dav1d_open", [p, p], ctypes.c_int),
                            ("dav1d_data_create", [p, ctypes.c_size_t], p),
                            ("dav1d_send_data", [p, p], ctypes.c_int),
                            ("dav1d_get_picture", [p, p], ctypes.c_int),
                            ("dav1d_apply_grain", [p, p, p], ctypes.c_int),
                            ("dav1d_picture_unref", [p], None), ("dav1d_close", [p], None)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def _picture_planes(pic) -> list:
    """The planes of a Dav1dPicture: data[3] at byte 16, stride[2] at 40,
    then p.w, p.h, p.layout (0 I400, 1 I420, 2 I422, 3 I444), p.bpc."""
    raw = ctypes.string_at(ctypes.addressof(pic), 72)
    data = [int.from_bytes(raw[16 + 8 * i:24 + 8 * i], "little") for i in range(3)]
    stride = [int.from_bytes(raw[40 + 8 * i:48 + 8 * i], "little", signed=True) for i in range(2)]
    w, h, layout, bpc = (int.from_bytes(raw[56 + 4 * i:60 + 4 * i], "little") for i in range(4))
    size = 1 if bpc == 8 else 2
    out = []
    for k in range(3 if layout else 1):
        sx, sy = (int(layout in (1, 2)), int(layout == 1)) if k else (0, 0)
        pw, ph = (w + sx) >> sx, (h + sy) >> sy
        st = stride[1 if k else 0]
        buf = ctypes.string_at(data[k], st * (ph - 1) + pw * size) + bytes(st - pw * size)
        out.append(np.frombuffer(buf, np.uint8 if size == 1 else np.uint16)
                   .reshape(ph, st // size)[:, :pw])
    return out


def dav1d_planes(stream: bytes) -> tuple:
    """(planes before grain, planes after) of an AV1 stream by PIL's dav1d:
    decoded with apply_grain 0 (Dav1dSettings: n_threads at byte 0,
    apply_grain at 8), then dav1d_apply_grain."""
    lib = _dav1d()
    settings = ctypes.create_string_buffer(1024)
    lib.dav1d_default_settings(settings)
    ctypes.memmove(ctypes.addressof(settings), (1).to_bytes(4, "little"), 4)
    ctypes.memmove(ctypes.addressof(settings) + 8, bytes(4), 4)
    ctx = ctypes.c_void_p()
    assert lib.dav1d_open(ctypes.byref(ctx), settings) == 0
    try:
        data = ctypes.create_string_buffer(256)  # Dav1dData
        ctypes.memmove(lib.dav1d_data_create(data, len(stream)), stream, len(stream))
        pic, out = ctypes.create_string_buffer(1024), ctypes.create_string_buffer(1024)
        assert lib.dav1d_send_data(ctx, data) == 0
        assert lib.dav1d_get_picture(ctx, pic) == 0
        assert lib.dav1d_apply_grain(ctx, out, pic) == 0
        before, after = _picture_planes(pic), _picture_planes(out)
        lib.dav1d_picture_unref(out)
        lib.dav1d_picture_unref(pic)
        return before, after
    finally:
        lib.dav1d_close(ctypes.byref(ctx))


def _equals_dav1d(stream: bytes) -> None:
    """The port's decoded planes (grained) equal dav1d's, and its planes
    before the grain equal dav1d's ungrained ones."""
    before, after = dav1d_planes(stream)
    frame = av1.decode(stream)
    for k, plane in enumerate(after):
        np.testing.assert_array_equal(frame.planes[k][:plane.shape[0], :plane.shape[1]], plane,
                                      err_msg=f"plane {k}")
    if av1.grain_applies(frame.grain):
        ungrained = av1.decode(stream, grain=False)
        for k, plane in enumerate(before):
            np.testing.assert_array_equal(ungrained.planes[k][:plane.shape[0], :plane.shape[1]],
                                          plane)


def _crop(w: int, h: int, alpha: bool = False) -> np.ndarray:
    px = _fixture()[100:100 + h, 200:200 + w]
    if alpha:
        px = np.dstack([px, np.tile(np.linspace(0, 255, w).astype(np.uint8), (h, 1))])
    return np.ascontiguousarray(px)


def _plain_same(data: bytes) -> None:
    """decode_image equals PIL, and so does the decode through every twin
    (the film grain's among them)."""
    want = _same(data)
    np.testing.assert_array_equal(avif.decode_avif(data, plain=True), want)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("vector", range(1, 17))
def test_film_grain_test_vectors_equal_pil(vector, layout):
    """aom's 16 film grain test vectors (luma and chroma points, chroma
    from luma in 15, AR lags 2 and 3, overlap, grain scale shifts) in each
    layout, over frames of sizes that are no multiple of 32, odd ones
    among them."""
    w, h = SIZES[vector % len(SIZES)]
    data = _pil_avif(_crop(w, h), subsampling=layout, advanced={"film-grain-test": str(vector)})
    frame = av1.decode(avif.parse(data).color)
    assert av1.grain_applies(frame.grain) and frame.ms["film grain"] >= 0
    _plain_same(data)
    _equals_dav1d(avif.parse(data).color)


@pytest.mark.parametrize("vector", [1, 2, 10, 15])
def test_alpha_item_takes_grain_too(vector):
    data = _pil_avif(_crop(130, 96, alpha=True), advanced={"film-grain-test": str(vector)})
    still = avif.parse(data)
    assert av1.grain_applies(av1.decode(still.alpha).grain)
    _plain_same(data)
    _equals_dav1d(still.alpha)


@pytest.mark.parametrize("level", [5, 20, 50])
def test_denoise_levels_equal_pil(level):
    """aom's denoise-noise-level: the picture denoised and its noise sent
    as grain parameters fitted to it (a noisy gradient)."""
    gy, gx = np.mgrid[0:96, 0:130]
    base = np.dstack([gx + 40, gy + 60, gx + gy + 20]).astype(float)
    px = np.clip(base + np.random.default_rng(level).normal(0, 12, base.shape), 0, 255)
    data = _pil_avif(px.astype(np.uint8), advanced={"denoise-noise-level": str(level)})
    assert av1.grain_applies(av1.decode(avif.parse(data).color).grain)
    _plain_same(data)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("depth", [10, 12])
def test_higher_depths_equal_pil(depth, layout):
    """10 and 12 bits (avif_at_depth keeps film_grain_params_present): the
    grain and the scaling lookups at the depth."""
    vector = 3 + depth + len(layout)
    data = tool.avif_at_depth(_pil_avif(_crop(65, 65, alpha=depth == 10), subsampling=layout,
                                        advanced={"film-grain-test": str(vector % 16 + 1)}),
                              depth)
    assert av1.decode(avif.parse(data).color).bit_depth == depth
    _plain_same(data)
    _equals_dav1d(avif.parse(data).color)


@pytest.mark.parametrize("layout, vector", [("4:2:0", 2), ("4:4:4", 7), ("4:2:2", 12)])
def test_grid_tiles_each_take_their_grain(layout, vector):
    """A grid through libavif's own encoder with aom's film-grain-test: each
    tile is a stream of its own, grained by its own parameters before the
    tiles are assembled (the alpha grid's tiles too)."""
    data = tool.avif_grid(_crop(192, 128, alpha=True), 3, 2, (64, 64), subsampling=layout,
                          film_grain_test=vector)
    still = avif.parse(data)
    assert still.grid is not None and still.alpha_grid is not None
    assert all(av1.grain_applies(av1.decode(t).grain) for t in still.grid.tiles)
    _plain_same(data)


@pytest.mark.parametrize("size", [(192, 128), (48, 32)])
def test_a_frame_scaled_to_its_ispe_after_the_grain(size):
    """libavif scales the grained picture to the item's ispe."""
    data = _with_ispe(_pil_avif(_crop(96, 64, alpha=True), advanced={"film-grain-test": "4"}),
                      *size)
    assert _same(data).shape == (size[1], size[0], 4)


# --- seeded parameter sets written into PIL's files -----------------------------------

WRITTEN = [(layout, depth, k) for layout in LAYOUTS for depth in DEPTHS for k in range(2)]


@pytest.mark.parametrize("layout, depth, k", WRITTEN)
def test_written_parameter_sets_equal_pil_and_dav1d(layout, depth, k):
    """The seeded parameter sets (clips, chroma from luma without luma
    points, no luma points, 14 of them, each lag) written into a
    PIL-written file in place of aom's: PIL's RGBA and dav1d's planes."""
    i = WRITTEN.index((layout, depth, k)) * 5 + 1
    w, h = SIZES[i % len(SIZES)]
    data = _pil_avif(_crop(w, h), subsampling=layout, quality=60,
                     advanced={"film-grain-test": "1"})
    seq = av1.parse_sequence(next(p for kind, p in av1.obus(avif.parse(data).color)
                                  if kind == av1.OBU_SEQUENCE_HEADER))
    data = tool.avif_with_grain(data, _params(i, seq))
    if depth > 8:
        data = tool.avif_at_depth(data, depth)
    _plain_same(data)
    _equals_dav1d(avif.parse(data).color)


@pytest.mark.parametrize("params", [None, "empty", "clip only"])
def test_parameters_that_grain_nothing(params):
    """apply_grain 0, or no points and no chroma from luma: dav1d leaves
    the picture as decoded, clip or not; chroma from luma with the clip
    clips chroma alone (dav1d's has_grain)."""
    data = _pil_avif(_crop(65, 33), advanced={"film-grain-test": "1"})
    q = None
    if params:
        q = dict(_params(0, _seq("4:2:0")), y=[], cb=[], cr=[], csfl=0,
                 clip=int(params == "clip only"))
    grained = tool.avif_with_grain(data, q)
    assert not av1.grain_applies(av1.decode(avif.parse(grained).color).grain)
    np.testing.assert_array_equal(_same(grained), _pil(tool.avif_with_grain(data, None)))
    q = dict(_params(0, _seq("4:2:0")), y=[], cb=[], cr=[], csfl=1, clip=1)
    clipped = tool.avif_with_grain(data, q)
    frame = av1.decode(avif.parse(clipped).color)
    assert av1.grain_applies(frame.grain)
    assert frame.planes[1][:17, :33].min() >= 16 and frame.planes[1][:17, :33].max() <= 240
    _same(clipped)


# --- what dav1d rejects ----------------------------------------------------------------

RULES = {
    "more than 14 luma points": ("4:2:0", dict(y=[(17 * i, 30) for i in range(15)]),
                                 "15 luma points"),
    "more than 10 Cb points": ("4:4:4", dict(cb=[(20 * i, 30) for i in range(11)]),
                               "11 Cb points"),
    "more than 10 Cr points": ("4:2:2", dict(cr=[(20 * i, 30) for i in range(11)]),
                               "11 Cr points"),
    "equal luma points": ("4:0:0", dict(y=[(0, 20), (100, 1), (100, 40)]),
                          "luma points do not increase"),
    "falling luma points": ("4:2:0", dict(y=[(0, 20), (120, 1), (100, 40)]),
                            "luma points do not increase"),
    "equal Cb points": ("4:2:2", dict(cb=[(0, 20), (50, 1), (50, 40)]),
                        "Cb points do not increase"),
    "falling Cr points": ("4:4:4", dict(cr=[(0, 20), (60, 1), (50, 40)]),
                          "Cr points do not increase"),
    "4:2:0 Cb points alone": ("4:2:0", dict(cr=[]), "one chroma plane only"),
    "4:2:0 Cr points alone": ("4:2:0", dict(cb=[]), "one chroma plane only"),
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_headers_dav1d_rejects_raise(rule):
    """dav1d's film grain header checks (obu.c): PIL fails ("Decoding of
    color planes failed"), the port raises ValueError."""
    layout, change, message = RULES[rule]
    data = _pil_avif(_crop(64, 48), subsampling=layout, advanced={"film-grain-test": "1"})
    base = dict(_params(2, _seq(layout)), y=[(0, 20), (255, 40)], cb=[(0, 20), (255, 30)],
                cr=[(0, 20), (255, 30)], csfl=0)
    data = tool.avif_with_grain(data, dict(base, **change))
    with pytest.raises(Exception, match="Decoding of color planes failed"):
        _pil(data)
    with pytest.raises(ValueError, match=message):
        imagefile.decode_image(data)


@pytest.mark.parametrize("layout, change", [
    ("4:2:0", dict(y=[(17 * i, 30) for i in range(14)])),
    ("4:4:4", dict(cb=[(25 * i, 30) for i in range(10)])),
    ("4:2:2", dict(cr=[])),
    ("4:0:0", dict(cb=[(0, 1), (0, 1)] * 6)),
])
def test_the_limits_themselves_are_read(layout, change):
    """14 luma and 10 chroma points, one chroma plane's points outside
    4:2:0, and chroma points in 4:0:0 (not in the syntax there) decode as
    PIL."""
    data = _pil_avif(_crop(64, 48), subsampling=layout, advanced={"film-grain-test": "1"})
    base = dict(_params(4, _seq(layout)), y=[(0, 20), (255, 40)], cb=[(0, 20), (255, 30)],
                cr=[(0, 20), (255, 30)], csfl=0)
    _same(tool.avif_with_grain(data, dict(base, **change)))


# --- the agreement tool, the stored files, no fallback ----------------------------------

@pytest.mark.parametrize("seed, index", [(0, 0), (0, 1), (1, 5), (2, 9), (4, 17), (5, 3)])
def test_fuzz_grain_cases(seed, index):
    options, data = fuzz.case(seed, index, grain=True)
    assert "grain" in options
    assert fuzz.outcome(data) == ("equal", ""), options


def test_corrupt_grain_case_at_the_coefficient_clamp_equals_dav1d_c_path():
    """`--grain --corrupt 200 3`'s one differing case (seed 2 index 74):
    bit flips drive two of the alpha item's coefficients to the
    dequantiser's clamp, where dav1d's SIMD transforms part from its C
    code (ROADMAP.md §3, kept); with the C path PIL equals the port, the
    grain included. The uncorrupted source has no such coefficient."""
    from test_torch_av1 import _clamped_coefficients

    options, data = fuzz.case(2, 74, corrupt=True, grain=True)
    assert options["grain"] == "film-grain-test=13" and _clamped_coefficients(data) > 0
    with fuzz.dav1d_c_path():
        assert fuzz.outcome(data) == ("equal", "")
    source = fuzz.case(2, 74 % 12, grain=True)[1]
    assert fuzz.outcome(source) == ("equal", "") and _clamped_coefficients(source) == 0


@pytest.mark.parametrize("path, vector, depth", [(AVIF_GRAIN_FIXTURE, 2, 8),
                                                 (AVIF_GRAIN_422_10_FIXTURE, 4, 10)])
def test_stored_grain_files(path, vector, depth):
    """The stored files carry the named vector's parameters (vector 2:
    chroma points, AR lag 3, overlap) in every item at their depth, and
    their grain stage equals its twin on the file's own planes."""
    with open(path, "rb") as fh:
        data = fh.read()
    assert tool.AVIF_GRAIN_VECTORS[os.path.basename(path)] == vector
    still = avif.parse(data)
    for stream in (still.color, still.alpha):
        if not stream:
            continue
        frame = av1.decode(stream, plain=True)
        g = frame.grain
        assert frame.bit_depth == depth and av1.grain_applies(g)
        assert g[av1.G_AR_LAG] >= 1 and g[av1.G_OVERLAP] == 1
        assert frame.mono or g[av1.G_NUM_UV] > 0
    assert still.alpha or path == AVIF_GRAIN_422_10_FIXTURE


def test_a_failed_build_raises(monkeypatch):
    """The C++ AV1 library does not build: the grain raises, never runs
    its twin."""
    from figdraw_tpu_torch.utils import gxx

    def broken(*_a, **_k):
        raise subprocess.CalledProcessError(1, ["g++"], "", "error")

    seq = _seq("4:2:0")
    g = _g(_params(3, seq), seq)
    planes = _planes(np.random.default_rng(0), 33, 31, seq)
    monkeypatch.setattr(image_lib, "_av1", None)
    monkeypatch.setattr(gxx, "build", broken)
    with pytest.raises(subprocess.CalledProcessError):
        av1.film_grain(planes, 33, 31, g)
    with open(AVIF_GRAIN_FIXTURE, "rb") as fh:
        data = fh.read()
    with pytest.raises(subprocess.CalledProcessError):
        imagefile.decode_image(data)


def test_bad_arguments_are_refused():
    """fd_av1_film_grain checks the parameters that bound its reads, and
    film_grain the planes' sizes, sample type and layout."""
    seq = _seq("4:2:0")
    planes = _planes(np.random.default_rng(1), 17, 3, seq)
    for field, value in ((av1.G_NUM_Y, 15), (av1.G_AR_LAG, 4), (av1.G_BITDEPTH, 9),
                         (av1.G_SCALING_SHIFT, 12), (av1.G_NUM_UV, 11)):
        g = _g(_params(5, seq), seq)
        g[field] = value
        with pytest.raises(ValueError, match="bad arguments"):
            av1.film_grain(planes, 17, 3, g)
    g = _g(_params(5, seq), seq)
    for w, h, bad in ((17 + 8, 3, planes), (17, 3 + 6, planes),  # past the planes
                      (17, 3, (planes[0].astype(np.uint16),) + planes[1:]),  # another depth's
                      (17, 3, (planes[0][:, ::2],) + planes[1:])):  # not contiguous
        with pytest.raises(ValueError, match="bad arguments"):
            av1.film_grain(bad, w, h, g)

