"""AVIF grid images in the port's reader (figdraw_tpu_torch/utils/avif.py)
against PIL 12.1.0's `Image.open(...).convert("RGBA")`, which reads them
through libavif 1.3.0 as figdraw_tpu does. PIL's save writes no grid, so
every grid here is written in the test by libavif's own encoder
(tools/make_image_formats.py's avif_grid, through ctypes) and edited item
by item where a case needs a file no encoder writes (the tool's Heif).

The decode equals PIL byte for byte over 1x2, 2x1, 2x2 and 3x4 grids in
4:2:0, 4:4:4, 4:2:2 and 4:0:0, with the last column and row cropped or
whole, with and without an alpha grid, at speeds with and without CDEF and
loop restoration, and at 10 and 12 bits (every tile rewritten by
avif_at_depth); a sharp chroma edge on a tile seam is upsampled across
the seam, as libavif converts the assembled image; the numpy twins decode
a grid as the C++ helper does. Each check libavif makes of a grid is shown
by a file PIL refuses, on which the port raises ValueError; PIL's own
reading of a grid whose ispe is not its output size is copied. The stored
grids (the fixture with an alpha grid, a 12 MP photo) equal PIL's digests,
and the fixture's load_image, image-file scene and photo wall equal
figdraw_tpu's on the CPU."""

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
from PIL import Image

from figdraw_tpu_torch.scenes import (
    AVIF_GRID_FILE_REFERENCE, AVIF_GRID_FIXTURE, AVIF_GRID_WALL_REFERENCE, AVIF_PHOTO_FIXTURE,
    IMAGE_FIXTURE, IMAGE_FORMATS_REFERENCE,
)
from figdraw_tpu_torch.utils import av1, avif, imagefile
from torch_reference import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
import avif_fuzz_agreement as fuzz  # noqa: E402
import make_image_formats as tool  # noqa: E402
from make_image_formats import Heif, avif_grid  # noqa: E402

torch.set_num_threads(1)

ROADMAP_ITEM = "Image formats other than PNG"
CDEF = {"enable_cdef": "1"}


def _fixture() -> np.ndarray:
    return np.asarray(Image.open(IMAGE_FIXTURE).convert("RGBA"))


def _crop(w: int, h: int, alpha: bool = False) -> np.ndarray:
    """A crop of the PNG fixture, with a seeded alpha gradient."""
    px = _fixture()[100:100 + h, 200:200 + w].copy()
    if alpha:
        px[..., 3] = ((np.add.outer(np.arange(h) * 3, np.arange(w) * 5) + 40) % 256)
        return px
    return np.ascontiguousarray(px[..., :3])


def _grain(w: int, h: int, alpha: bool = False) -> np.ndarray:
    """A gradient under seeded noise: aom restores it with Wiener and
    self-guided units at speed 2, and writes no palette (whose colours a
    rewrite to 10 or 12 bits would read with more bits)."""
    gy, gx = np.mgrid[0:h, 0:w]
    base = np.dstack([gx * 200 / w + 30, gy * 200 / h + 20, (gx + gy) * 100 / (w + h) + 80])
    px = np.clip(base + np.random.default_rng(w).normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)
    if alpha:
        a = (np.add.outer(np.arange(h) * 3, np.arange(w) * 5) + 40) % 256
        px = np.dstack([px, a.astype(np.uint8)])
    return np.ascontiguousarray(px)


def _pil(data: bytes) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _same(data: bytes, plain: bool = False) -> np.ndarray:
    want = _pil(data)
    got = avif.decode_avif(data, plain=True) if plain else imagefile.decode_image(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def _refused_by_both(data: bytes, match: str = None) -> None:
    """PIL fails on the file (on open or on load); the port raises ValueError."""
    with pytest.raises(Exception):
        _pil(data)
    with pytest.raises(ValueError, match=match):
        imagefile.decode_image(data)


# --- grids libavif writes, against PIL ---------------------------------------------

# (columns, rows): the four layouts; each with every format, the last
# column and row whole or cropped, alpha and the speed alternating so that
# each format meets both
LAYOUTS = [(1, 2), (2, 1), (2, 2), (3, 4)]
FORMATS = ["4:2:0", "4:4:4", "4:2:2", "4:0:0"]
GRID_CASES = [(c, r, sub, crop, bool(k % 2), (6, 2)[(k // 2) % 2])
              for k, ((c, r), sub, crop) in enumerate(
                  (lay, sub, crop) for lay in LAYOUTS for sub in FORMATS for crop in (False, True))]


def _grid_id(case) -> str:
    c, r, sub, crop, alpha, speed = case
    return (f"{c}x{r}:{sub}{':cropped' if crop else ''}{':alpha' if alpha else ''}:s{speed}")


def _layout_size(columns: int, rows: int, sub: str, crop: bool) -> tuple:
    """The output size of a grid of 64x64 tiles: whole, or the last column
    40 wide and the last row 30 high (one column or row stays whole)."""
    w = 64 * columns - (24 if crop and columns > 1 else 0)
    h = 64 * rows - (34 if crop and rows > 1 else 0)
    return w, h


@pytest.mark.parametrize("case", GRID_CASES, ids=_grid_id)
def test_grid_equals_pil(case):
    columns, rows, sub, crop, alpha, speed = case
    w, h = _layout_size(columns, rows, sub, crop)
    px = _grain(w, h, alpha) if speed == 2 else _crop(w, h, alpha)
    data = avif_grid(px, columns, rows, (64, 64), subsampling=sub, speed=speed,
                     **(CDEF if speed == 2 else {}))
    still = avif.parse(data)
    if columns * rows > 1:
        assert (still.grid.columns, still.grid.rows) == (columns, rows)
        assert (still.grid.width, still.grid.height) == (w, h) == (still.width, still.height)
        assert all(s == (64, 64) for s in still.grid.sizes)
        assert (still.alpha_grid is not None) == alpha
    got = _same(data)
    assert got.shape == (h, w, 4)


def test_cdef_and_restoration_run_in_the_tiles():
    """Speed-2 grids reach CDEF and both restoration filters inside their
    tiles (aom picks them by the tile: CDEF in the 2x2 grid of 64x64
    tiles, Wiener and self-guided units in that of 128x128 ones)."""
    checked = {}
    for tile in (64, 128):
        data = avif_grid(_grain(2 * tile, 2 * tile), 2, 2, (tile, tile), speed=2, **CDEF)
        for stream in avif.parse(data).grid.tiles:
            for k, n in av1.decode(stream, plain=True).checked.items():
                checked[k] = checked.get(k, 0) + n
        _same(data)
    assert all(checked[k] for k in ("cdef", "wiener", "sgr")), checked


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("sub", FORMATS)
def test_grid_through_the_numpy_twins(sub, alpha):
    """decode_avif(plain=True): every stage of every tile through its numpy
    twin, the grid assembled and converted by to_rgba_plain."""
    data = avif_grid(_grain(104, 94, alpha), 2, 2, (64, 64), subsampling=sub, speed=2, **CDEF)
    if sub in ("4:2:0", "4:2:2"):
        assert avif.parse(data).grid.width == 104
    _same(data, plain=True)


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("sub", FORMATS)
def test_grid_at_a_higher_depth_equals_pil(sub, depth):
    """A grid with an alpha grid made 10- or 12-bit by avif_at_depth: every
    tile's stream and av1C and both grids' pixi rewritten; decoded on
    uint16 planes as PIL decodes it."""
    data = tool.avif_at_depth(avif_grid(_grain(192, 128, True), 3, 2, (64, 64), subsampling=sub,
                                        speed=2, **CDEF), depth)
    still = avif.parse(data)
    for grid in (still.grid, still.alpha_grid):
        for tile in grid.tiles:
            seq = av1.parse_sequence(next(p for k, p in av1.obus(tile)
                                          if k == av1.OBU_SEQUENCE_HEADER))
            assert seq.bit_depth == depth
    assert still.av1c[1:3] == (1, int(depth == 12)) == still.alpha_av1c[1:3]
    _same(data)


# --- chroma at the tile seams -------------------------------------------------------

@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2"])
@pytest.mark.parametrize("edge", [63, 64, 65])
def test_a_chroma_edge_on_a_tile_seam(sub, edge):
    """A sharp red-blue edge at the seam of two 64-wide tiles (and a pixel
    either side): libavif converts the assembled image, so the bilinear
    chroma upsampling crosses the seam; the port, which converts once,
    equals PIL, and converting each tile apart does not."""
    px = np.zeros((64, 128, 3), np.uint8)
    px[:, :edge] = (230, 20, 20)
    px[:, edge:] = (20, 20, 230)
    data = avif_grid(px, 2, 1, (64, 64), subsampling=sub, quality=100)
    got = _same(data)
    still = avif.parse(data)
    tiles = [av1.decode(t) for t in still.grid.tiles]
    cp, _tc, mc, full = still.nclx
    apart = np.concatenate([av1.to_rgba(f, None, full, mc, cp) for f in tiles], axis=1)
    assert not np.array_equal(apart, got)


# --- libavif's checks of a grid: PIL refuses, the port raises ValueError -------------

def _base(alpha: bool = False, sub: str = "4:2:0") -> bytes:
    return avif_grid(_crop(192 if alpha else 128, 128, alpha), 3 if alpha else 2, 2, (64, 64),
                     subsampling=sub)


def _payload(heif: Heif, grid: int, w: int, h: int, rows: int = 2, columns: int = 2,
             flags: int = 0, version: int = 0) -> None:
    field = ">II" if flags & 1 else ">HH"
    heif.items[grid]["data"] = bytes([version, flags, rows - 1, columns - 1]) + struct.pack(
        field, w, h)


def _without(heif: Heif, item: int, kind: bytes) -> None:
    heif.items[item]["props"] = [(i, e) for i, e in heif.items[item]["props"]
                                 if heif.ipco[i - 1][0] != kind]


def _tile_ispe(heif: Heif, tiles, w: int, h: int) -> None:
    for t in tiles:
        heif.set_prop(t, b"ispe", struct.pack(">III", 0, w, h))


def _av1c_flip(heif: Heif, tile: int, byte: int, bit: int) -> None:
    payload = heif.ipco[heif.prop(tile, b"av1C") - 1][1]
    heif.set_prop(tile, b"av1C", payload[:byte] + bytes([payload[byte] ^ bit])
                  + payload[byte + 1:], 1)


def _stream_of(data: bytes, k: int) -> bytes:
    h = Heif(data)
    return h.items[h.tiles(h.primary)[k]]["data"]


def _edit(name: str) -> Heif:
    h = Heif(_base(alpha=name.startswith("alpha")))
    tiles = h.tiles(1)
    if name == "version 1":
        _payload(h, 1, 128, 128, version=1)
    elif name == "trailing byte":
        h.items[1]["data"] += b"\0"
    elif name == "zero width":
        _payload(h, 1, 0, 128)
    elif name == "too wide":
        _payload(h, 1, 40000, 128, flags=1)
    elif name == "too large":
        _payload(h, 1, 20000, 20000, flags=1)
    elif name == "not covered":
        _payload(h, 1, 130, 128)
    elif name == "no overlap":
        _payload(h, 1, 64, 128)
    elif name == "odd width":
        _payload(h, 1, 127, 128)
    elif name == "odd height":
        _payload(h, 1, 128, 127)
    elif name == "fewer cells than tiles":
        _payload(h, 1, 128, 64, rows=1)
    elif name == "second dimg box":
        h.refs.append((b"dimg", 1, []))
    elif name == "a tile twice":
        tiles[3] = tiles[2]
    elif name == "tile of another type":
        h.items[tiles[2]]["type"] = b"hvc1"
    elif name == "a grid as a tile":
        h.items[tiles[0]]["type"] = b"grid"
    elif name == "unknown essential property":
        h.set_prop(tiles[2], b"zzzz", b"", essential=1)
    elif name == "first tile without av1C":
        _without(h, tiles[0], b"av1C")
    elif name == "a tile without av1C":
        _without(h, tiles[1], b"av1C")
    elif name == "av1C level differs":
        _av1c_flip(h, tiles[1], 1, 1)
    elif name == "av1C sample position differs":
        _av1c_flip(h, tiles[1], 2, 1)
    elif name == "tiles under 64":
        _tile_ispe(h, tiles, 62, 62)
        _payload(h, 1, 124, 124)
    elif name == "a tile of another size":
        _tile_ispe(h, tiles[1:2], 128, 128)
    elif name == "a tile of another format":
        h.items[tiles[1]]["data"] = _stream_of(_base(sub="4:4:4"), 1)
    elif name == "a tile of another range":
        h.items[tiles[1]]["data"] = _stream_of(avif_grid(_crop(128, 128), 2, 2, (64, 64),
                                                         full_range=False), 1)
    elif name == "a tile of another depth":
        h.items[tiles[1]]["data"] = tool.stream_at(h.items[tiles[1]]["data"], 10)
    elif name == "grid without ispe":
        _without(h, 1, b"ispe")
    elif name == "tile without ispe":
        _without(h, tiles[1], b"ispe")
    elif name == "grid pixi of another depth":
        h.set_prop(1, b"pixi", b"\0\0\0\0\x03\x0a\x0a\x0a")
    elif name == "ispe past the output":
        h.set_prop(1, b"ispe", struct.pack(">III", 0, 130, 128))
    elif name == "alpha grid of another size":
        alpha = next(f for k, f, _to in h.refs if k == b"auxl")
        _payload(h, alpha, 190, 128, columns=3)
    elif name == "alpha tile without ispe":
        alpha = next(f for k, f, _to in h.refs if k == b"auxl")
        _without(h, h.tiles(alpha)[0], b"ispe")
    elif name == "an unused item without ispe":  # libavif checks every item it could decode
        h.items[99] = dict(h.items[tiles[0]], props=[])
    elif name == "an illegal property index":
        h.items[tiles[1]]["props"].append((len(h.ipco) + 1, 0))
    elif name == "alpha grid narrower than its tiles":
        alpha = next(f for k, f, _to in h.refs if k == b"auxl")
        _payload(h, alpha, 128, 128, columns=3)
    return h


REFUSED = ["version 1", "trailing byte", "zero width", "too wide", "too large", "not covered",
           "no overlap", "odd width", "odd height", "fewer cells than tiles", "second dimg box",
           "a tile twice", "tile of another type", "a grid as a tile",
           "unknown essential property", "first tile without av1C", "a tile without av1C",
           "av1C level differs", "av1C sample position differs", "tiles under 64",
           "a tile of another size", "a tile of another format", "a tile of another range",
           "a tile of another depth", "grid without ispe", "tile without ispe",
           "grid pixi of another depth", "ispe past the output", "alpha grid of another size",
           "alpha grid narrower than its tiles", "alpha tile without ispe",
           "an unused item without ispe", "an illegal property index"]


@pytest.mark.parametrize("name", REFUSED)
def test_a_grid_libavif_refuses_raises(name):
    _refused_by_both(_edit(name).write())


def test_a_grid_under_64_is_refused_by_the_encoder_too():
    for tile in ((63, 64), (64, 63)):
        with pytest.raises(ValueError, match="Invalid image grid"):
            avif_grid(_crop(126, 128), 2, 2, tile)
    with pytest.raises(ValueError, match="Invalid image grid"):
        avif_grid(_crop(99, 95), 2, 2, (64, 64))


# --- what libavif and PIL accept -----------------------------------------------------

def test_the_edited_files_round_trip():
    """The Heif editor writes libavif's grids again unchanged in pixels."""
    for alpha in (False, True):
        src = _base(alpha)
        np.testing.assert_array_equal(_pil(Heif(src).write()), _pil(src))


@pytest.mark.parametrize("size", [(126, 128), (128, 126), (100, 60), (190, 128)])
def test_an_ispe_smaller_than_the_grid_is_read_as_pil_reads_it(size):
    """PIL sizes the image by the grid item's ispe and reads libavif's RGB
    (RGBA with alpha) rows of the output's width as rows of that size; the
    port copies it."""
    h = Heif(_base(alpha=size[0] > 128))
    h.set_prop(1, b"ispe", struct.pack(">III", 0, *size))
    got = _same(h.write())
    assert got.shape == (size[1], size[0], 4)


@pytest.mark.parametrize("name", ["32-bit fields", "tiles in another order", "tiles scaled",
                                  "unknown optional property", "av1C delay differs",
                                  "grid without colr", "tile pixi of another depth",
                                  "iovl alpha item", "an unused item past the file"])
def test_grids_libavif_accepts(name):
    h = Heif(_base(alpha=name == "iovl alpha item"))
    tiles = h.tiles(1)
    if name == "32-bit fields":
        _payload(h, 1, 128, 128, flags=1)
    elif name == "tiles in another order":
        next(to for k, f, to in h.refs if k == b"dimg" and f == 1).reverse()
    elif name == "tiles scaled":  # each 64x64 frame scaled to its 128x128 ispe
        _tile_ispe(h, tiles, 128, 128)
        _payload(h, 1, 256, 256)
        h.set_prop(1, b"ispe", struct.pack(">III", 0, 256, 256))
    elif name == "unknown optional property":
        h.set_prop(tiles[2], b"zzzz", b"")
    elif name == "av1C delay differs":  # initial_presentation_delay is not compared
        _av1c_flip(h, tiles[1], 3, 0x10)
    elif name == "grid without colr":
        _without(h, 1, b"colr")
    elif name == "tile pixi of another depth":  # only the grid's pixi is held to av1C
        h.set_prop(tiles[1], b"pixi", b"\0\0\0\0\x03\x0a\x0a\x0a")
    elif name == "an unused item past the file":  # its extent is read only if it is used
        h.items[99] = dict(h.items[tiles[0]])
    elif name == "iovl alpha item":  # skipped as libavif skips it: no alpha
        h.items[next(f for k, f, _to in h.refs if k == b"auxl")]["type"] = b"iovl"
    data = h.write()
    if name == "an unused item past the file":
        data = _past_the_file(data, 99)
    got = _same(data)
    if name == "iovl alpha item":
        assert (got[..., 3] == 255).all()


def _past_the_file(data: bytes, item_id: int) -> bytes:
    """The file with the iloc extent of `item_id` (the tool's layout: 16-bit
    id, 2 zero bytes, 1 extent, 32-bit offset and length) ending past the
    file's end."""
    at = data.find(struct.pack(">HHH", item_id, 0, 1)) + 10
    return data[:at] + struct.pack(">I", len(data)) + data[at + 4:]


def test_alpha_items_on_the_tiles_are_refused(tmp_path):
    """An alpha item on each colour tile (no alpha grid): libavif builds an
    alpha grid of them, which the port does not; it refuses with
    NotImplementedError naming the feature."""
    h = Heif(_base(alpha=True))
    alpha = next(f for k, f, _to in h.refs if k == b"auxl")
    aux = h.prop(alpha, b"auxC")
    for c, a in zip(h.tiles(1), h.tiles(alpha)):
        h.items[a]["props"].append((aux, 0))
        h.refs.append((b"auxl", a, [c]))
    h.refs = [r for r in h.refs if r[1] != alpha]
    del h.items[alpha]
    data = h.write()
    assert _pil(data)[..., 3].min() < 255
    path = str(tmp_path / "tiles.avif")
    with open(path, "wb") as fh:
        fh.write(data)
    with pytest.raises(NotImplementedError,
                       match=rf"AVIF images with alpha items on a grid's tiles.*{ROADMAP_ITEM}"):
        imagefile.read_image(path)


# --- the fuzz tool's grids ------------------------------------------------------------

# tools/avif_fuzz_agreement.py --grids --corrupt 200 6 cases that differ
# from PIL where PIL's dav1d runs its x86 SIMD transforms on coefficients
# at the dequantiser's clamp (ROADMAP.md §3, kept), equal on its C code
GRID_CLAMP_CORRUPT = [(2, 41), (2, 127)]


@pytest.mark.parametrize("seed, index", GRID_CLAMP_CORRUPT)
def test_corrupt_grids_at_the_coefficient_clamp_equal_dav1d_c_path(seed, index):
    _options, data = fuzz.case(seed, index, corrupt=True, grids=True)
    with fuzz.dav1d_c_path():
        assert fuzz.outcome(data, True) == ("equal", "")


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_grids_agree_with_pil(seed):
    """tools/avif_fuzz_agreement.py --grids's first cases of two seeds, and
    as many corrupt ones: the port decodes as PIL does, or both fail (or
    the port refuses a feature outside its slices)."""
    for _i, _o, data in fuzz.grid_cases(seed, 10):
        assert fuzz.outcome(data)[0] == "equal"
    for _i, _o, data in fuzz.corrupt_cases(seed, 20, grids=True):
        assert fuzz.outcome(data, corrupt=True)[0] in ("equal", "refused")


# --- the stored grids ------------------------------------------------------------------

@pytest.mark.parametrize("path", [AVIF_GRID_FIXTURE, AVIF_PHOTO_FIXTURE],
                         ids=os.path.basename)
def test_stored_grid_equals_pil_and_its_digests(path):
    with open(path, "rb") as fh:
        data = fh.read()
    with open(IMAGE_FORMATS_REFERENCE) as fh:
        ref = json.load(fh)["files"][os.path.basename(path)]
    assert hashlib.sha256(data).hexdigest() == ref["sha256"]
    got = _same(data)
    assert hashlib.sha256(got.tobytes()).hexdigest() == ref["decoded_sha256"]
    still = avif.parse(data)
    if path == AVIF_PHOTO_FIXTURE:
        assert (still.grid.columns, still.grid.rows, still.grid.width, still.grid.height) == (
            8, 6, 4032, 3024)
        assert still.grid.sizes == [(512, 512)] * 48 and still.alpha_grid is None
    else:
        assert (still.grid.columns, still.grid.rows) == (4, 3)
        assert still.alpha_grid.sizes == [(200, 200)] * 12
        assert got.shape == (600, 800, 4) and got[..., 3].min() < 255


@pytest.fixture(params=[AVIF_GRID_FIXTURE, AVIF_PHOTO_FIXTURE], ids=os.path.basename)
def grid_copies(request, tmp_path):
    """A stored grid copied twice (each package writes its own sidecar):
    (port path, jax path)."""
    paths = []
    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub)
        paths.append(str(tmp_path / sub / os.path.basename(request.param)))
        shutil.copyfile(request.param, paths[-1])
    return paths


def test_load_image_of_a_grid_gives_figdraw_tpus_image_mips_and_sidecar(grid_copies):
    """Cold and warm in both packages: the same pixels, mips and sidecar
    bytes, whose stored digest chip_smoke.py holds the card to."""
    import figdraw_tpu.resources as jres
    from torch_reference import jax_flippy

    from figdraw_tpu_torch import resources

    port_path, jax_path = grid_copies
    jax_flippy()
    bus, jbus = resources.ImageMessageBus(), jres.ImageMessageBus()
    sub, jsub = bus.subscribe(), jbus.subscribe()
    with open(IMAGE_FORMATS_REFERENCE) as fh:
        want = json.load(fh)["sidecar"][os.path.basename(port_path)]
    for _ in range(2):
        ref, jref = resources.load_image(port_path, bus=bus), jres.load_image(jax_path, bus=jbus)
        a = [m for m in sub.drain() if m.kind == resources.ImageMsgKind.PutImage][0]
        b = [m for m in jsub.drain() if m.kind == jres.ImageMsgKind.PutImage][0]
        np.testing.assert_array_equal(a.image, np.asarray(b.image))
        assert len(a.mips) == len(b.mips)
        for x, y in zip(a.mips, b.mips):
            np.testing.assert_array_equal(x, np.asarray(y))
        with open(port_path + ".flippy", "rb") as fh, open(jax_path + ".flippy", "rb") as jfh:
            sidecar = fh.read()
            assert sidecar == jfh.read()
        assert hashlib.sha256(sidecar).hexdigest() == want
        ref.close()
        jref.close()
        resources.clear_image_cache(bus=bus)
        jres.clear_image_cache(bus=jbus)


def _copies(tmp_path) -> tuple:
    paths = []
    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub)
        paths.append(str(tmp_path / sub / os.path.basename(AVIF_GRID_FIXTURE)))
        shutil.copyfile(AVIF_GRID_FIXTURE, paths[-1])
    return paths


def test_image_file_scene_from_a_grid_matches_jax(tmp_path):
    """The image-file scene with the stored grid (and its alpha grid)
    loaded: within 1/255 of figdraw_tpu's frame and within 1e-5 of its
    stored block means (chip_smoke.py holds the card to them)."""
    import figdraw_tpu_torch as port
    from torch_reference import block_means, jax_image_file_frame

    from figdraw_tpu_torch.scenes import render_image_file

    port_path, jax_path = _copies(tmp_path)
    want = jax_image_file_frame(jax_path, "1x")
    _ren, frame, ref = render_image_file(
        lambda ps: port.FigRenderer(atlas_size=512, device="cpu", pixel_scale=ps),
        port_path, "1x")
    got = frame.numpy()
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(AVIF_GRID_FILE_REFERENCE)
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1e-5
    ref.close()


def test_photo_wall_from_a_grid_matches_jax(tmp_path):
    import figdraw_tpu_torch as port
    from torch_reference import block_means, jax_photo_wall_frame

    from figdraw_tpu_torch import resources
    from figdraw_tpu_torch.scenes import PHOTO_WALL_SMALL, make_loaded_photo_wall

    port_path, jax_path = _copies(tmp_path)
    w, h, n = PHOTO_WALL_SMALL
    want = jax_photo_wall_frame(jax_path, w, h, n)
    ren = port.FigRenderer(atlas_size=512, device="cpu")
    bus = resources.ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    ref = resources.load_image(port_path, bus=bus)
    got = ren.render_frame(make_loaded_photo_wall(w, h, n, ref.id), port.vec2(w, h)).numpy()
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(AVIF_GRID_WALL_REFERENCE)
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1e-5
    ref.close()
