"""How often the port's AVIF reader and PIL agree: seeded pictures written
by PIL 12.1.0 (libavif 1.3.0 with aom) over sizes, qualities, speeds 0-10,
alpha and aom's CDEF (`enable-cdef`, drawn for half the cases from a
stream of its own, so the pictures and options of each case stay as they
were before it was drawn; speeds 0-4 turn on loop restoration by
themselves), each decoded by `utils/imagefile.decode_image` and by PIL's
`Image.open(...).convert("RGBA")`; with --corrupt, seeded truncations and
one to three bit flips of such files instead. With --formats each case
also draws, from seeded streams of their own, its chroma subsampling
(4:2:0, 4:2:2, 4:4:4 or 4:0:0), its range (full or limited) and a matrix
coefficient written into the colr box's nclx (or none: aom's BT.601); the
cases without --formats keep their bytes. With --dav1d-c PIL's dav1d runs
its C code only (`dav1d_set_cpu_flags_mask(0)` in PIL's libavif): on
coefficients that corrupt data drives to the clamp, dav1d's SSSE3 and AVX2
transforms part from its C code and the specification, which the port
follows. With --depths each case's file is made a 10- or 12-bit one (drawn
from a seeded stream of its own) by rewriting its sequence headers, av1C
and pixi (tools/make_image_formats.py's avif_at_depth: aom in PIL's
libavif writes 8 bits only; 12 bits in profile 2), its tile symbols kept.
With --grids each case is a grid image written by libavif's own encoder
(tools/make_image_formats.py's avif_grid: PIL's save writes no grid) from
streams of its own: 1 to 3 columns and rows of tiles 64 to 128 wide and
high, the last column and row (of two or more) cropped to a drawn width and
height (even where chroma is subsampled, as MIAF asks), a picture of the output's size
(a quarter with an alpha channel, which becomes an alpha grid), its
subsampling, range, quality, speed and aom's CDEF; with --depths too,
every tile made 10- or 12-bit. With --grain each written case or grid also draws,
from a seeded stream of its own, one of aom's film grain options: a
`film-grain-test` vector (1-16, aom's test parameter sets) or a
`denoise-noise-level` (5-50: aom denoises the picture and sends the grain
it took out as parameters); the port synthesises the grain as PIL's dav1d
does. With --avis each case is an image sequence (PIL's save_all: 2 to 4
frames, alpha for half, premultiplied for a quarter of those, a drawn
subsampling, quality, speed and aom option) written again in a drawn
sample layout (PIL's, a chunk a sample, co64, one sample size, moov
before meta, major brand mif1; tools/make_image_formats.py's Avis); with
--depths too, 10- or 12-bit (avis_at_depth). With --properties each case
is a PIL-written file with alpha given one of: premultiplied alpha, a
limited-range alpha item, both, or a clap, a1op, lsel, a1lx or irot
property of drawn value and essential flag on the colour or alpha item
(or on a sequence's colour sample entry), a third of them 10- or 12-bit.

A picture is one of: seeded noise, a crop of the PNG fixture
(tests/goldens/render_3d_overlay_gaussian.png), a flat UI-like picture of
a few solid rectangles (which turns on aom's screen content tools), or a
smooth gradient; a quarter carry an alpha channel. Each case ends as
`equal` (byte for byte), `refused` (NotImplementedError naming a feature
outside the slice; its feature is counted), `differ` or `error` (the port
raised something else, or, with --corrupt, one side raised and the other
decoded). With --corrupt an error on both sides agrees. The counts are
printed by speed, and each disagreement by its seed and index
(`case(seed, index)` rebuilds it). Needs PIL (the CPU host's).

    python tools/avif_fuzz_agreement.py [--corrupt] [--formats] [--depths] [--grids]
        [--grain] [--avis] [--properties] [--dav1d-c] [cases per seed, default 200]
        [seeds, default 1]
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import io
import os
import re
import struct
import sys
from collections import Counter, defaultdict

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "goldens", "render_3d_overlay_gaussian.png")


def _fixture() -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(FIXTURE).convert("RGB"))


def picture(rng: np.random.Generator, fixture: np.ndarray, w: int, h: int) -> np.ndarray:
    """One of the four kinds of seeded picture, (h, w, 3) uint8."""
    kind = int(rng.integers(4))
    if kind == 0:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == 1:
        y = int(rng.integers(0, fixture.shape[0] - min(h, fixture.shape[0]) + 1))
        x = int(rng.integers(0, fixture.shape[1] - min(w, fixture.shape[1]) + 1))
        crop = fixture[y:y + h, x:x + w]
        return np.ascontiguousarray(np.pad(crop, ((0, h - crop.shape[0]), (0, w - crop.shape[1]), (0, 0)),
                                           mode="reflect" if min(crop.shape[:2]) > 1 else "edge"))
    if kind == 2:
        out = np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
        for _ in range(int(rng.integers(1, 6))):
            x0, y0 = int(rng.integers(0, w)), int(rng.integers(0, h))
            x1, y1 = int(rng.integers(x0, w + 1)), int(rng.integers(y0, h + 1))
            out[y0:y1, x0:x1] = rng.integers(0, 256, 3)
        return out
    gy, gx = np.mgrid[0:h, 0:w]
    a = rng.uniform(-2, 2, 3)
    b = rng.uniform(-2, 2, 3)
    return np.clip(gx[..., None] * a + gy[..., None] * b + rng.integers(0, 256, 3), 0, 255).astype(np.uint8)


def pil_avif(px: np.ndarray, **options) -> bytes:
    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(px).save(out, "AVIF", **options)
    return out.getvalue()


SUBSAMPLINGS = ("4:2:0", "4:2:2", "4:4:4", "4:0:0")
# the nclx matrices --formats writes (None: PIL's own, BT.601), among them
# those libavif does not convert (3, 10, 11, 13, 14, limited-range 8, and
# 0 on subsampled chroma)
MATRICES = (None, None, None, None, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


# --grain: aom's film grain options, one drawn per case
GRAIN_OPTIONS = ([("film-grain-test", str(v)) for v in range(1, 17)]
                 + [("denoise-noise-level", str(v)) for v in (5, 10, 20, 35, 50)])


def with_matrix(data: bytes, matrix: int) -> bytes:
    """The file with its colr box's nclx matrix coefficients set."""
    at = data.find(b"nclx")
    return data[:at + 8] + matrix.to_bytes(2, "big") + data[at + 10:]


def _tool():
    for path in (REPO, os.path.dirname(os.path.abspath(__file__))):
        if path not in sys.path:
            sys.path.insert(0, path)
    import make_image_formats

    return make_image_formats


def at_depth(data: bytes, depth: int) -> bytes:
    """A PIL-written file made a `depth`-bit one (make_image_formats)."""
    return _tool().avif_at_depth(data, depth)


def grid_cases(seed: int, cases: int, start: int = 0, depths: bool = False,
               grain: bool = False):
    """Yields (index, options, bytes) of one seed's grid images (avif_grid)
    from index `start`."""
    rng = np.random.default_rng([seed, 20])
    depth_rng = np.random.default_rng([seed, 11])
    grain_rng = np.random.default_rng([seed, 12])
    fixture = _fixture()
    for i in range(cases):
        sub = SUBSAMPLINGS[int(rng.integers(4))]
        ssx, ssy = {"4:2:0": (1, 1), "4:2:2": (1, 0)}.get(sub, (0, 0))
        columns, rows = int(rng.integers(1, 4)), int(rng.integers(1, 4))
        tw, th = int(rng.integers(64, 129)), int(rng.integers(64, 129))
        tw, th = tw + (tw & ssx), th + (th & ssy)
        lw, lh = int(rng.integers(1, tw + 1)), int(rng.integers(1, th + 1))
        lw, lh = min(tw, lw + (lw & ssx)), min(th, lh + (lh & ssy))
        lw, lh = lw if columns > 1 else tw, lh if rows > 1 else th  # one cell: the tile itself
        w, h = tw * (columns - 1) + lw, th * (rows - 1) + lh
        px = picture(rng, fixture, w, h)
        if rng.integers(4) == 0:
            px = np.ascontiguousarray(np.dstack([px, picture(rng, fixture, w, h)[..., 0]]))
        options = {"grid": f"{columns}x{rows} of {tw}x{th}", "size": (w, h), "subsampling": sub,
                   "range": ("full", "limited")[int(rng.integers(2))],
                   "quality": int(rng.integers(0, 101)), "speed": int(rng.integers(0, 11)),
                   "cdef": int(rng.integers(2)), "alpha": px.shape[2] == 4}
        if depths:
            options["depth"] = (10, 12)[int(depth_rng.integers(2))]
        aom = {"enable_cdef": options["cdef"]}
        if grain:
            key, value = GRAIN_OPTIONS[int(grain_rng.integers(len(GRAIN_OPTIONS)))]
            options["grain"] = f"{key}={value}"
            aom[key.replace("-", "_")] = value
        if i >= start:
            data = _tool().avif_grid(px, columns, rows, (tw, th), quality=options["quality"],
                                     speed=options["speed"], subsampling=sub,
                                     full_range=options["range"] == "full", **aom)
            if depths:
                data = at_depth(data, options["depth"])
            yield i, options, data


def written_cases(seed: int, cases: int, start: int = 0, formats: bool = False,
                  depths: bool = False, grain: bool = False):
    """Yields (index, options, bytes) of one seed's PIL-written AVIFs from
    index `start` (the pictures before it are drawn, not written)."""
    rng = np.random.default_rng(seed)
    cdef_rng = np.random.default_rng([seed, 7])
    sub_rng, range_rng, matrix_rng = (np.random.default_rng([seed, k]) for k in (8, 9, 10))
    depth_rng = np.random.default_rng([seed, 11])
    grain_rng = np.random.default_rng([seed, 12])
    fixture = _fixture()
    for i in range(cases):
        w, h = int(rng.integers(1, 300)), int(rng.integers(1, 300))
        px = picture(rng, fixture, w, h)
        options = {"quality": int(rng.integers(0, 101)), "speed": int(rng.integers(0, 11))}
        if rng.integers(4) == 0:
            alpha = picture(rng, fixture, w, h)[..., 0]
            px = np.ascontiguousarray(np.dstack([px, alpha]))
        options["size"] = (w, h)
        options["cdef"] = int(cdef_rng.integers(2))
        extra = {}
        if formats:
            options["subsampling"] = SUBSAMPLINGS[int(sub_rng.integers(4))]
            options["range"] = ("full", "limited")[int(range_rng.integers(2))]
            options["matrix"] = MATRICES[int(matrix_rng.integers(len(MATRICES)))]
            extra = {"subsampling": options["subsampling"], "range": options["range"]}
        if depths:
            options["depth"] = (10, 12)[int(depth_rng.integers(2))]
        advanced = {"enable-cdef": str(options["cdef"])}
        if grain:
            key, value = GRAIN_OPTIONS[int(grain_rng.integers(len(GRAIN_OPTIONS)))]
            options["grain"] = f"{key}={value}"
            advanced[key] = value
        if i >= start:
            data = pil_avif(px, quality=options["quality"], speed=options["speed"],
                            advanced=advanced, **extra)
            if formats and options["matrix"] is not None:
                data = with_matrix(data, options["matrix"])
            if depths:
                data = at_depth(data, options["depth"])
            yield i, options, data


# --avis: the sample layouts written around PIL's own (tools/
# make_image_formats.py's Avis), each drawn as often as PIL's
LAYOUTS = ("pil", "pil", "pil", "chunks", "co64", "default size", "moov first", "major mif1")
# aom's options that libavif passes on for a sequence (kf-max-dist and
# lag-in-frames are refused there: "Invalid codec-specific option")
SEQUENCE_AOM = ({}, {}, {"auto-alt-ref": "1"}, {"error-resilient": "1"}, {"tile-columns": "1"},
                {"end-usage": "q", "cq-level": "30"}, {"enable-order-hint": "0"},
                {"frame-parallel": "1"})


def avis_cases(seed: int, cases: int, start: int = 0, depths: bool = False):
    """Yields (index, options, bytes) of one seed's image sequences (PIL's
    save_all) from index `start`: 2 to 4 frames, each a seeded crop or
    picture of a drawn size, with alpha for half of them, a drawn
    subsampling, quality, speed and aom options, premultiplied for a
    quarter of those with alpha, then written again in a drawn sample
    layout; with --depths made 10- or 12-bit (avis_at_depth)."""
    rng = np.random.default_rng([seed, 30])
    depth_rng = np.random.default_rng([seed, 11])
    fixture = _fixture()
    for i in range(cases):
        n = int(rng.integers(2, 5))
        w, h = int(rng.integers(1, 200)), int(rng.integers(1, 200))
        alpha = bool(rng.integers(2))
        frames = []
        for _f in range(n):
            px = picture(rng, fixture, w, h)
            if alpha:
                px = np.ascontiguousarray(np.dstack([px, picture(rng, fixture, w, h)[..., 0]]))
            frames.append(px)
        options = {"frames": n, "size": (w, h), "alpha": alpha,
                   "subsampling": SUBSAMPLINGS[int(rng.integers(4))],
                   "quality": int(rng.integers(0, 101)), "speed": int(rng.integers(0, 11)),
                   "aom": SEQUENCE_AOM[int(rng.integers(len(SEQUENCE_AOM)))],
                   "premultiplied": alpha and not rng.integers(4),
                   "layout": LAYOUTS[int(rng.integers(len(LAYOUTS)))]}
        if depths:
            options["depth"] = (10, 12)[int(depth_rng.integers(2))]
        if i < start:
            continue
        from PIL import Image

        out = io.BytesIO()
        images = [Image.fromarray(px) for px in frames]
        images[0].save(out, "AVIF", save_all=True, append_images=images[1:],
                       quality=options["quality"], speed=options["speed"],
                       subsampling=options["subsampling"], advanced=options["aom"],
                       alpha_premultiplied=options["premultiplied"])
        tool = _tool()
        data = tool.steady_times(out.getvalue())
        if depths:
            data = tool.avis_at_depth(data, options["depth"])
        layout = options["layout"]
        if layout != "pil":
            a = tool.Avis(data)
            if layout == "major mif1":
                a.ftyp = b"mif1" + a.ftyp[4:]
            data = a.write(chunks=[1] * n if layout == "chunks" else None, co64=layout == "co64",
                           default_size=layout == "default size",
                           order=(b"moov", b"meta") if layout == "moov first" else (b"meta", b"moov"))
        yield i, options, data


# --properties: what each case adds to a PIL-written file with alpha
PROPERTY_KINDS = ("prem", "limited alpha", "prem + limited alpha", "clap", "a1op", "lsel",
                  "a1lx", "lsel + a1lx", "irot", "track properties")


def property_cases(seed: int, cases: int, start: int = 0):
    """Yields (index, options, bytes) of one seed's files with the
    properties and alpha forms PIL reads as plain or converts: premultiplied
    alpha (PIL's alpha_premultiplied, or a prem reference added), a
    limited-range alpha (make_image_formats.limited_alpha), both, and the
    clap, a1op, lsel, a1lx and irot properties with drawn values, marked
    essential or not, on the colour or the alpha item (a sequence's sample
    entries for "track properties"); a third made 10- or 12-bit."""
    rng = np.random.default_rng([seed, 31])
    fixture = _fixture()
    for i in range(cases):
        w, h = int(rng.integers(1, 200)), int(rng.integers(1, 200))
        px = np.ascontiguousarray(np.dstack([picture(rng, fixture, w, h),
                                             picture(rng, fixture, w, h)[..., 0]]))
        kind = PROPERTY_KINDS[int(rng.integers(len(PROPERTY_KINDS)))]
        options = {"kind": kind, "size": (w, h), "quality": int(rng.integers(0, 101)),
                   "speed": int(rng.integers(0, 11)),
                   "subsampling": SUBSAMPLINGS[int(rng.integers(4))],
                   "depth": (8, 8, 8, 8, 10, 12)[int(rng.integers(6))],
                   "item": int(rng.integers(1, 3)), "essential": int(rng.integers(4) > 0)}
        value = int(rng.integers(0, 1 << 16))
        small = int(rng.integers(0, 6))
        if kind == "clap":
            options["value"] = [int(v) for v in rng.integers(0, 300, 8)]
        elif kind == "a1op":
            options["value"] = (0, 1, small, 31, 32, value & 0xFF)[small]
        elif kind in ("lsel", "lsel + a1lx"):
            options["value"] = (0, 0, 1, 3, 4, 0xFFFF)[small]
        elif kind == "a1lx":
            options["value"] = [int(v) for v in rng.integers(0, 400, 3)]
        if kind == "lsel + a1lx":
            options["sizes"] = [int(v) for v in rng.integers(0, 400, 3)]
        if i < start:
            continue
        tool = _tool()
        data = pil_avif(px, quality=options["quality"], speed=options["speed"],
                        subsampling=options["subsampling"],
                        alpha_premultiplied=kind.startswith("prem") and options["item"] == 1)
        if options["depth"] > 8:
            data = at_depth(data, options["depth"])
        if kind.startswith("prem") and options["item"] == 2:
            heif = tool.Heif(data)
            heif.refs.append((b"prem", heif.primary, [2]))
            data = heif.write()
        if "limited" in kind:
            data = tool.limited_alpha(data)
        props = {"clap": lambda v: struct.pack(">8I", *v),
                 "a1op": lambda v: bytes([v]), "lsel": lambda v: struct.pack(">H", v),
                 "a1lx": lambda v: b"\0" + struct.pack(">3H", *v),
                 "irot": lambda v: bytes([value & 3])}
        if kind in props or kind == "lsel + a1lx":
            heif = tool.Heif(data)
            item = options["item"] if options["item"] in heif.items else heif.primary
            if kind == "lsel + a1lx":
                heif.set_prop(item, b"a1lx", props["a1lx"](options["sizes"]))
                heif.set_prop(item, b"lsel", props["lsel"](options["value"]), options["essential"])
            else:
                heif.set_prop(item, kind.encode(), props[kind](options.get("value")),
                              options["essential"] ^ (kind == "a1lx"))
            data = heif.write()
        if kind == "track properties":
            from PIL import Image

            out = io.BytesIO()
            Image.fromarray(px).save(out, "AVIF", save_all=True,
                                     append_images=[Image.fromarray(px[::-1].copy())],
                                     quality=options["quality"], speed=options["speed"])
            a = tool.Avis(tool.steady_times(out.getvalue()))
            fmt, fields, entry = a.tracks[0]["entry"]
            extra = [(b"clap", struct.pack(">8I", *rng.integers(0, 300, 8))),
                     (b"a1op", bytes([(0, 5, 31, 32)[small % 4]])),
                     (b"lsel", struct.pack(">H", (0, 2, 4, 0xFFFF)[small % 4]))]
            a.tracks[0]["entry"] = (fmt, fields, entry + extra[:1 + small % 3])
            data = a.write()
        yield i, options, data


def corrupt_cases(seed: int, cases: int, formats: bool = False, depths: bool = False,
                  grids: bool = False, grain: bool = False, avis: bool = False,
                  properties: bool = False):
    """Yields (index, options, bytes): a third of PIL-written files (or
    grids, sequences or property cases) cut at a random length, the others
    with one to three bits flipped (a third of those in the first 400
    bytes, the container and headers; with grids and sequences, in the
    boxes before mdat)."""
    rng = np.random.default_rng(seed + 1000)
    sources = [(o, d) for _i, o, d in (
        grid_cases(seed, 12, depths=depths, grain=grain) if grids
        else avis_cases(seed, 12, depths=depths) if avis
        else property_cases(seed, 12) if properties
        else written_cases(seed, 12, formats=formats, depths=depths, grain=grain))]
    for i in range(cases):
        options, src = sources[i % len(sources)]
        data = bytearray(src)
        head_end = max(src.find(b"mdat") - 4, 1) if grids or avis else 400
        if rng.integers(3) == 0:
            data = data[: int(rng.integers(0, len(data)))]
        else:
            head = rng.integers(3) == 0
            for _ in range(int(rng.integers(1, 4))):
                at = (int(rng.integers(0, min(head_end, len(data)))) if head
                      else int(rng.integers(0, len(data))))
                data[at] ^= 1 << int(rng.integers(8))
        yield i, options, bytes(data)


def case(seed: int, index: int, corrupt: bool = False, formats: bool = False,
         depths: bool = False, grids: bool = False, grain: bool = False, avis: bool = False,
         properties: bool = False) -> tuple:
    """(options, bytes) of case `index` of `seed`."""
    gen = (corrupt_cases(seed, index + 1, formats, depths, grids, grain, avis, properties)
           if corrupt
           else grid_cases(seed, index + 1, index, depths, grain) if grids
           else avis_cases(seed, index + 1, index, depths) if avis
           else property_cases(seed, index + 1, index) if properties
           else written_cases(seed, index + 1, index, formats, depths, grain))
    for i, options, data in gen:
        if i == index:
            return options, data
    raise IndexError(index)


def libavif() -> ctypes.CDLL:
    """PIL's own libavif (pillow.libs), which holds its dav1d."""
    from PIL import Image

    paths = glob.glob(os.path.join(os.path.dirname(os.path.dirname(Image.__file__)),
                                   "pillow.libs", "libavif-*.so*"))
    if not paths:
        raise FileNotFoundError("no libavif beside PIL on this host")
    lib = ctypes.CDLL(paths[0])
    lib.dav1d_set_cpu_flags_mask.argtypes = [ctypes.c_uint]
    return lib


@contextlib.contextmanager
def dav1d_c_path():
    """PIL's dav1d on its C code only while the block runs (libavif opens
    a dav1d context for each image, which takes the mask), then every SIMD
    level again: the mask is process-wide."""
    lib = libavif()
    lib.dav1d_set_cpu_flags_mask(0)
    try:
        yield
    finally:
        lib.dav1d_set_cpu_flags_mask(0xFFFFFFFF)


def outcome(data: bytes, corrupt: bool = False) -> tuple:
    """(kind, detail) of one file: equal, refused (the feature), differ or
    error."""
    import warnings

    from PIL import Image

    sys.path.insert(0, REPO)
    from figdraw_tpu_torch.utils import imagefile

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    except Exception as exc:  # noqa: BLE001 - PIL's own error on a corrupt file
        want = exc
    try:
        got = imagefile.decode_image(data)
    except NotImplementedError as exc:
        m = re.search(r"AVIF images with (.*) are not decoded", str(exc))
        return "refused", m.group(1) if m else str(exc)
    except ValueError as exc:
        if isinstance(want, Exception):
            return "equal", "both raise"
        return "error", f"ValueError: {exc}"
    if isinstance(want, Exception):
        return "error", f"PIL raises {type(want).__name__}, the port decodes"
    if got.shape == want.shape and np.array_equal(got, want):
        return "equal", ""
    return "differ", f"max |diff| {np.abs(got.astype(int) - want.astype(int)).max() if got.shape == want.shape else 'shape'}"


def run(cases: int, seeds: int, corrupt: bool, formats: bool = False, depths: bool = False,
        grids: bool = False, grain: bool = False, avis: bool = False,
        properties: bool = False) -> dict:
    counts = Counter()
    by_speed, by_format, by_depth = defaultdict(Counter), defaultdict(Counter), defaultdict(Counter)
    by_grain = defaultdict(Counter)
    features = Counter()
    bad = []
    for seed in range(seeds):
        gen = (corrupt_cases(seed, cases, formats, depths, grids, grain, avis, properties)
               if corrupt
               else grid_cases(seed, cases, depths=depths, grain=grain) if grids
               else avis_cases(seed, cases, depths=depths) if avis
               else property_cases(seed, cases) if properties
               else written_cases(seed, cases, formats=formats, depths=depths, grain=grain))
        for i, options, data in gen:
            kind, detail = outcome(data, corrupt)
            counts[kind] += 1
            if detail == "both raise":
                counts["equal: both raise"] += 1
            by_speed[options["speed"]][kind] += 1
            if avis or properties:
                by_format[(options.get("layout") or options["kind"], options["subsampling"])][kind] += 1
            elif formats or grids:
                by_format[(options["subsampling"], options["range"])][kind] += 1
            if depths:
                by_depth[options["depth"]][kind] += 1
            if grain:
                by_grain[options["grain"].split("=")[0]][kind] += 1
            if kind == "refused":
                features[detail] += 1
            if kind in ("differ", "error"):
                bad.append((seed, i, options, detail))
    return {"counts": counts, "by_speed": by_speed, "by_format": by_format, "by_depth": by_depth,
            "by_grain": by_grain, "features": features, "bad": bad}


def main(argv) -> int:
    corrupt, formats, depths = "--corrupt" in argv, "--formats" in argv, "--depths" in argv
    grids, grain = "--grids" in argv, "--grain" in argv
    avis, properties = "--avis" in argv, "--properties" in argv
    nums = [int(a) for a in argv if not a.startswith("--")]
    cases = nums[0] if nums else 200
    seeds = nums[1] if len(nums) > 1 else 1
    with dav1d_c_path() if "--dav1d-c" in argv else contextlib.nullcontext():
        res = run(cases, seeds, corrupt, formats, depths, grids, grain, avis, properties)
    flags = " ".join(a for a in argv if a.startswith("--"))
    print(f"{'corrupt' if corrupt else 'written'} {flags}: {cases} cases x {seeds} seeds:",
          dict(res["counts"]))
    for speed in sorted(res["by_speed"]):
        print(f"  speed {speed}: {dict(res['by_speed'][speed])}")
    for (sub, rng), n in sorted(res["by_format"].items()):
        print(f"  {sub} {rng}{'' if avis or properties else ' range'}: {dict(n)}")
    for depth, n in sorted(res["by_depth"].items()):
        print(f"  {depth} bits: {dict(n)}")
    for option, n in sorted(res["by_grain"].items()):
        print(f"  {option}: {dict(n)}")
    for feature, n in res["features"].most_common():
        print(f"  refused, {feature}: {n}")
    for seed, i, options, detail in res["bad"]:
        print(f"  disagreement seed {seed} index {i} {options}: {detail}")
    return 0 if not res["bad"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
