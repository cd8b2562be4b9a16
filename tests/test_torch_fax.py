"""The port's CCITT fax decoder (figdraw_tpu_torch/utils/fax.py, its C++ in
csrc/image_decode.cpp: fd_tiff_fax, the code tables in csrc/fax_tables.h)
behind load_image, against PIL 12.1.0's `Image.open(...).convert("RGBA")`,
which reads TIFF compressions 2, 3 and 4 through libtiff 4.7.1, as
figdraw_tpu does: equal byte for byte on the stored files
(tools/make_image_formats.py) and on files PIL writes here from seeded
bilevel arrays (Modified Huffman, T.4 one- and two-dimensional with and
without fill bits, T.6; FillOrder 1 and 2, MinIsWhite and MinIsBlack,
RowsPerStrip 1 and whole-image, odd widths), on files the tool's writer
makes where PIL writes none (tiles, big-endian), and on hand-made strips
that take libtiff's leniency: rows short or long of the width, bad code
words, data that ends inside a strip, a T.4 strip whose EOLs run out, a
T.6 strip that ends early. The C++ decoder against its plain twin on
seeded and corrupted strips, with the state libtiff carries from strip to
strip; the code tables against T.4's by decoding every run length; a
hypothesis round trip through the three codings; load_image against
figdraw_tpu's; the dithered Group 3 fixture's image-file scene and the
Group 4 page's photo wall against figdraw_tpu's block means."""

import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from figdraw_tpu_torch.scenes import IMAGE_FORMATS_DIR, IMAGE_FORMATS_REFERENCE
from figdraw_tpu_torch.utils import fax, imagefile, tiff
from torch_reference import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
from make_image_formats import FaxBits, fax_encode, fax_row_1d, fax_row_2d  # noqa: E402
from make_image_formats import tiff_bytes  # noqa: E402

torch.set_num_threads(1)

STORED = sorted(n for n in os.listdir(IMAGE_FORMATS_DIR)
                if n.endswith(".tif") and ("fax" in n or "g3" in n))
EOL = "000000000001"
# (compression, T4Options): Modified Huffman, T.4 1D, 2D, 2D with fill bits, T.6
CODINGS = [(2, 0), (3, 0), (3, 1), (3, 5), (4, 0)]
PIL_NAMES = {2: "tiff_ccitt", 3: "group3", 4: "group4"}


def _ids(c):
    return f"c{c[0]}t{c[1]}"


def _bits(seed: int, h: int, w: int, p: float = 0.3) -> np.ndarray:
    """Seeded 0/1 rows (1 black) with runs of every length, not just noise."""
    rng = np.random.default_rng(seed)
    noise = rng.random((h, w)) < p
    blocks = np.repeat(rng.random((h, -(-w // 9))) < 0.5, 9, axis=1)[:, :w]
    return (noise ^ blocks).astype(np.uint8)


def _pil(data: bytes) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _same(data: bytes) -> np.ndarray:
    """The port's decode, and its plain twins', equal PIL's."""
    want = _pil(data)
    got = imagefile.decode_image(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tiff.decode_tiff(data, plain=True), want)
    for _stage, a, b in tiff.stage_pairs(data):
        np.testing.assert_array_equal(a, b)
    return got


def _pil_fax(bits: np.ndarray, coding, tags: dict = None) -> bytes:
    """PIL's CCITT TIFF of 0/1 bits (1 black; mode "1" is white where 1),
    tags {tag: value} passed to its writer."""
    comp, t4 = coding
    info = dict(tags or {})
    if comp == 3:
        info[292] = t4
    b = io.BytesIO()
    Image.fromarray(bits == 0).save(b, "TIFF", compression=PIL_NAMES[comp], tiffinfo=info)
    return b.getvalue()


def _strip_tiff(strips, w: int, h: int, coding, rows_per_strip=None, photometric: int = 0,
                **kw) -> bytes:
    """A TIFF whose strips are the given bytes, in order."""
    comp, t4 = coding
    it = iter(strips)
    return tiff_bytes(np.zeros((h, w), np.uint8), photometric, bits=1, compression=comp,
                      rows_per_strip=rows_per_strip,
                      tags={292: (4, (t4,))} if comp == 3 else None,
                      codec=lambda _b: next(it), **kw)


# --- the stored files --------------------------------------------------------------


@pytest.mark.parametrize("name", STORED)
def test_stored_fax_files_equal_pil_and_their_digests(name):
    with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
        data = fh.read()
    with open(IMAGE_FORMATS_REFERENCE) as fh:
        ref = json.load(fh)["files"][name]
    got = _same(data)
    assert hashlib.sha256(got.tobytes()).hexdigest() == ref["decoded_sha256"]


def test_the_stored_fax_files_cover_the_codings():
    """Modified Huffman, T.4 two-dimensional with fill bits, T.6, FillOrder
    2, MinIsWhite and MinIsBlack, strips of many rows and tiles, a page at
    TIFF-F standard resolution."""
    seen = set()
    for name in STORED:
        with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
            _o, _b, tags = tiff.read_ifd(fh.read())
        seen |= {("compression", tags[259][0]), ("t4", tags.get(292, (0,))[0]),
                 ("fill", tags.get(266, (1,))[0]), ("photometric", tags[262][0]),
                 ("tiled", 324 in tags), ("size", (tags[256][0], tags[257][0]))}
    for want in [("compression", 2), ("compression", 3), ("compression", 4), ("t4", 5),
                 ("t4", 1), ("fill", 2), ("photometric", 0), ("photometric", 1),
                 ("tiled", True), ("size", (1728, 1143))]:
        assert want in seen, want


# --- files PIL writes ------------------------------------------------------------------


@pytest.mark.parametrize("coding", CODINGS, ids=_ids)
@pytest.mark.parametrize("fill", [1, 2])
@pytest.mark.parametrize("photometric", [0, 1])
@pytest.mark.parametrize("rows_per_strip", [1, None], ids=["rps1", "whole"])
def test_pil_written_files_equal_pil(coding, fill, photometric, rows_per_strip):
    """PIL writes what is asked, except that it garbles MinIsWhite on some
    images; the comparison is with PIL's reading of the same bytes."""
    bits = _bits(coding[0] * 10 + fill * 3 + photometric, 23, 37)
    tags = {266: fill, 262: photometric}
    if rows_per_strip:
        tags[278] = rows_per_strip
    data = _pil_fax(bits, coding, tags)
    _o, _b, got_tags = tiff.read_ifd(data)
    assert got_tags[266][0] == fill and got_tags[262][0] == photometric
    _same(data)


@pytest.mark.parametrize("coding", CODINGS, ids=_ids)
@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
def test_written_strips_and_tiles_equal_pil(coding, order, layout):
    """The tool's writer with libtiff's encoder (fax_encode): big-endian
    files and tiles (edge tiles padded), which PIL does not write."""
    bits = _bits(7, 45, 83)
    kw = {"tile": (32, 16)} if layout == "tiles" else {"rows_per_strip": 10}
    comp, t4 = coding
    data = tiff_bytes(bits, 0, bits=1, order=order, compression=comp,
                      tags={292: (4, (t4,))} if comp == 3 else None,
                      codec=lambda b: fax_encode(b[..., 0], comp, t4), **kw)
    got = _same(data)
    np.testing.assert_array_equal(got[..., 0], np.where(bits == 1, 0, 255))


def test_wide_rows_take_every_run_length():
    """Every run of 0 to 2700 pixels in both colours, through each coding:
    T.4's make-up, terminating and extended make-up codes as libtiff's
    tables (tif_fax3sm.c) read them, and rows past 2560 pixels."""
    runs = np.arange(2701)
    rows = []
    for k in range(0, len(runs), 2):
        row = np.zeros(2 * 2701 + 2, np.uint8)
        pos = 1
        for r in runs[k: k + 2]:
            row[pos: pos + r] = 1
            pos += r + 1
        rows.append(row[:pos])
    width = max(len(r) for r in rows)
    bits = np.zeros((len(rows), width), np.uint8)
    for i, r in enumerate(rows):
        bits[i, : len(r)] = r
        bits[i, len(r):] = 0
    bits = bits[::37]  # 37 rows of long runs of each colour
    for coding in CODINGS:
        got = _same(_pil_fax(bits, coding, {278: 8}))
        np.testing.assert_array_equal(got[..., 0], np.where(bits == 1, 0, 255))


def test_the_header_is_what_the_tool_writes():
    """csrc/fax_tables.h is generated from utils/fax.py's T.4 tables."""
    rc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "make_fax_tables.py"),
                         "--check"], capture_output=True)
    assert rc.returncode == 0


def test_the_code_tables_are_complete_prefix_codes():
    """Each table's codes are prefix-free; T.4's white and black codes
    with EOL fill their code space but for the codes no fax uses."""
    for name, entries in fax.codes().items():
        codes = [c for _s, c, _p in entries]
        for a in codes:
            for b in codes:
                assert a == b or not b.startswith(a), (name, a, b)
        kraft = sum(2.0 ** -len(c) for c in codes)
        assert kraft <= 1.0
    for name, bits in (("white", 12), ("black", 13)):
        table = fax.lookup_table(fax.codes()[name], bits)
        for i, (state, _w, _p) in enumerate(table):
            lead = f"{i:0{bits}b}"
            assert (state == fax.S_NULL) == (lead.startswith("0" * 8)
                                             and not lead.startswith("0" * 11)), (name, lead)


# --- C++ against the plain twin ------------------------------------------------------


@pytest.mark.parametrize("coding", CODINGS, ids=_ids)
@pytest.mark.parametrize("seed", range(3))
def test_fd_tiff_fax_equals_decode_plain(coding, seed):
    """Two strips of one image, then the same corrupted (truncations and bit
    flips): the rows, the state carried between strips and the error class
    equal."""
    comp, t4 = coding
    rng = np.random.default_rng(seed)
    w, h = int(rng.integers(5, 300)), int(rng.integers(1, 30))
    bits = _bits(seed, h, w, float(rng.uniform(0.02, 0.5)))
    two_d = comp == 4 or (comp == 3 and t4 & 1)
    row_bytes = (w + 7) // 8 + 1
    for corrupt in range(40):
        sa, sb = fax.new_state(w, two_d), fax.new_state(w, two_d)
        oa = np.full((h, row_bytes), 0x5A, np.uint8)
        ob = oa.copy()
        for _strip in range(2):
            s = bytearray(fax_encode(bits, comp, t4))
            if corrupt and corrupt % 2:
                s = s[: rng.integers(1, len(s))]
            elif corrupt:
                for _ in range(rng.integers(1, 5)):
                    s[rng.integers(0, len(s))] ^= 1 << rng.integers(8)
            errors = []
            for fn, out, state in ((fax.decode, oa, sa), (fax.decode_plain, ob, sb)):
                try:
                    fn(bytes(s), w, h, comp, t4, out, state)
                    errors.append(None)
                except (ValueError, NotImplementedError) as exc:
                    errors.append(type(exc))
            assert errors[0] == errors[1]
            np.testing.assert_array_equal(oa, ob)
            np.testing.assert_array_equal(sa, sb)


def test_decode_checks_its_buffers():
    with pytest.raises(ValueError, match="row buffer"):
        fax.decode(b"\x00", 16, 2, 4, 0, np.zeros((2, 1), np.uint8), fax.new_state(16, True))
    with pytest.raises(ValueError, match="row buffer"):
        fax.decode(b"\x00", 16, 2, 4, 0, np.zeros((2, 2), np.uint8), fax.new_state(16, False))


# --- libtiff's leniency, from hand-made strips ---------------------------------------


def test_rows_short_or_long_of_the_width_equal_pil():
    """A row whose runs fall short is padded with white; one that runs past
    the width loses the runs that cross it and is padded with white too
    (libtiff: "Premature EOL", "Line length mismatch")."""
    w = 24
    whole = np.array([0] * 3 + [1] * 5 + [0] * 16, np.uint8)
    for coding in [(3, 0), (3, 1)]:
        b = FaxBits()
        one_d = "1" if coding[1] else ""
        b.put(EOL + one_d).run(3, False).run(5, True)  # short: 8 of 24
        b.put(EOL + one_d).run(10, False).run(40, True)  # long: 50 of 24
        b.put(EOL + one_d)
        fax_row_1d(b, whole)
        b.put((EOL + one_d) * 6)
        got = _same(_strip_tiff([b.to_bytes()], w, 3, coding))
        assert (got[0, 8:, 0] == 255).all()  # padded white
        assert (got[1, 10:, 0] == 255).all()  # the overlong black run dropped


def test_bad_code_words_end_the_row_and_decoding_goes_on():
    """A code no table holds (libtiff: "Bad code word") ends its row as a
    short row ends; T.4 goes on at the next EOL, T.6 from the bits after
    the code it had read."""
    w = 16
    row = np.zeros(w, np.uint8)
    row[4:9] = 1
    for coding in [(3, 0), (3, 1), (4, 0)]:
        b = FaxBits()
        ref = np.zeros(w, np.uint8)
        for i in range(3):
            if coding[0] == 3:
                b.put(EOL + ("1" if coding[1] else ""))
            if i == 1:
                b.put("001" if coding[0] == 4 else "").put("000000001111")
                continue
            if coding[0] == 3:
                fax_row_1d(b, row)
            else:
                fax_row_2d(b, row, ref)
                ref = row
        b.put(EOL * 2)
        _same(_strip_tiff([b.to_bytes()], w, 3, coding))


@pytest.mark.parametrize("coding", CODINGS, ids=_ids)
def test_data_that_ends_inside_a_strip_equals_pil(coding):
    """Every cut of the second strip (the first strip whole, so the rows the
    cut strip never reaches hold the first strip's, as in PIL's reused
    buffer): PIL and the port agree on failing (Modified Huffman that runs
    out; a T.4 two-dimensional strip that ends inside a row) and on every
    row it writes."""
    bits = _bits(3, 12, 45)
    first = fax_encode(bits[:6], *coding)
    second = fax_encode(bits[6:], *coding)
    fails = 0
    for cut in range(1, len(second), 2):
        data = _strip_tiff([first, second[:cut]], 45, 12, coding, rows_per_strip=6)
        try:
            want = _pil(data)
        except OSError:
            fails += 1
            with pytest.raises(ValueError):
                imagefile.decode_image(data)
            with pytest.raises(ValueError):
                tiff.decode_tiff(data, plain=True)
            continue
        np.testing.assert_array_equal(imagefile.decode_image(data), want)
        np.testing.assert_array_equal(tiff.decode_tiff(data, plain=True), want)
    assert fails > 0 or coding == (3, 0)


def test_a_t4_strip_whose_eols_run_out_is_read_again_without_them():
    """libtiff's Fax3Decode1D/2D: data that ends inside the zeros of an EOL
    makes it read the strip again from its start without EOLs (its warning
    "Try to decode (read) fax Group 3 data without EOL"), into the rows
    left, and the later strips without EOLs too."""
    bits = _bits(11, 8, 30)
    for coding in [(3, 0), (3, 1)]:
        good = fax_encode(bits[:4], *coding)
        cut = fax_encode(bits[4:6], *coding, rtc=False) + b"\x00\x00"
        data = _strip_tiff([good, cut, good], 30, 12, coding, rows_per_strip=4)
        _same(data)


def test_a_t6_strip_that_ends_early_leaves_its_other_rows():
    """An EOFB after the second of four rows ends the strip (libtiff reads
    an EOL as the end of the strip, fills the row it was in white and keeps
    what it decoded): the last row keeps the previous strip's, as in PIL's
    strip buffer."""
    bits = _bits(5, 8, 40)
    early = fax_encode(bits[4:6], 4)
    data = _strip_tiff([fax_encode(bits[:4], 4), early], 40, 8, (4, 0), rows_per_strip=4)
    got = _same(data)
    assert (got[6, :, :3] == 255).all()
    np.testing.assert_array_equal(got[7], got[3])


@pytest.mark.parametrize("coding", CODINGS, ids=_ids)
def test_a_broken_tile_keeps_what_it_decoded(coding):
    """libtiff's TIFFReadEncodedTile takes the fax decoder's -1 for success:
    a tile that runs out (where a strip would fail) keeps its decoded rows,
    in PIL and in the port."""
    bits = _bits(9, 32, 64)
    comp, t4 = coding
    tiles = [fax_encode(bits[:, :32], comp, t4), fax_encode(bits[:, 32:], comp, t4)[:5]]
    it = iter(tiles)
    data = tiff_bytes(bits, 0, bits=1, compression=comp, tile=(32, 32),
                      tags={292: (4, (t4,))} if comp == 3 else None,
                      codec=lambda _b: next(it))
    got = _same(data)
    np.testing.assert_array_equal(got[:, :32, 0], np.where(bits[:, :32] == 1, 0, 255))


# --- a round trip through the three codings -------------------------------------------


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 90), st.integers(1, 12), st.integers(0, 2 ** 32 - 1),
       st.sampled_from(CODINGS), st.sampled_from([1, 2]))
def test_random_bilevel_round_trip(w, h, seed, coding, fill):
    bits = _bits(seed, h, w, 0.25)
    data = _pil_fax(bits, coding, {266: fill, 278: max(1, h // 3)})
    got = _same(data)
    np.testing.assert_array_equal(got[..., 0], np.where(bits == 1, 0, 255))


# --- against the JAX package ------------------------------------------------------------


@pytest.mark.parametrize("name", ["fax_page_g4.tif", "fixture_dither_g3_2d.tif"])
def test_load_image_gives_figdraw_tpus_image_and_mips(name, tmp_path):
    """Both packages' load_image of the same file: the same pixels and mips,
    the same sidecar bytes."""
    import figdraw_tpu.resources as jres
    from torch_reference import jax_flippy

    from figdraw_tpu_torch import resources

    paths = []
    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub)
        paths.append(str(tmp_path / sub / name))
        shutil.copyfile(os.path.join(IMAGE_FORMATS_DIR, name), paths[-1])
    jax_flippy()
    bus, jbus = resources.ImageMessageBus(), jres.ImageMessageBus()
    sub, jsub = bus.subscribe(), jbus.subscribe()
    ref, jref = resources.load_image(paths[0], bus=bus), jres.load_image(paths[1], bus=jbus)
    a = [m for m in sub.drain() if m.kind == resources.ImageMsgKind.PutImage][0]
    b = [m for m in jsub.drain() if m.kind == jres.ImageMsgKind.PutImage][0]
    np.testing.assert_array_equal(a.image, np.asarray(b.image))
    np.testing.assert_array_equal(a.image, _pil(open(paths[0], "rb").read()))
    assert len(a.mips) == len(b.mips)
    for x, y in zip(a.mips, b.mips):
        np.testing.assert_array_equal(x, np.asarray(y))
    with open(paths[0] + ".flippy", "rb") as fh, open(paths[1] + ".flippy", "rb") as jfh:
        assert fh.read() == jfh.read()
    ref.close()
    jref.close()


def test_image_file_scene_from_the_dithered_g3_fixture_matches_jax(tmp_path):
    import figdraw_tpu_torch as port
    from torch_reference import block_means, jax_image_file_frame

    from figdraw_tpu_torch.scenes import G3_FILE_REFERENCE, G3_FIXTURE, render_image_file

    paths = []
    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub)
        paths.append(str(tmp_path / sub / os.path.basename(G3_FIXTURE)))
        shutil.copyfile(G3_FIXTURE, paths[-1])
    want = jax_image_file_frame(paths[1], "1x")
    _ren, frame, ref = render_image_file(
        lambda ps: port.FigRenderer(atlas_size=512, device="cpu", pixel_scale=ps),
        paths[0], "1x")
    got = frame.numpy()
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(G3_FILE_REFERENCE)
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1e-5
    ref.close()


def test_photo_wall_from_the_g4_page_matches_jax(tmp_path):
    """The 1728x1143 page on the photo wall; figdraw_tpu's atlas starts at
    FAX_ATLAS (it asserts on an image more than twice its edge)."""
    import figdraw_tpu_torch as port
    from torch_reference import block_means, jax_photo_wall_frame

    from figdraw_tpu_torch import resources
    from figdraw_tpu_torch.scenes import (
        FAX_ATLAS, FAX_PAGE, G4_WALL_REFERENCE, PHOTO_WALL_SMALL, make_loaded_photo_wall,
    )

    paths = []
    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub)
        paths.append(str(tmp_path / sub / os.path.basename(FAX_PAGE)))
        shutil.copyfile(FAX_PAGE, paths[-1])
    w, h, n = PHOTO_WALL_SMALL
    want = jax_photo_wall_frame(paths[1], w, h, n, FAX_ATLAS)
    ren = port.FigRenderer(atlas_size=FAX_ATLAS, device="cpu")
    bus = resources.ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    ref = resources.load_image(paths[0], bus=bus)
    got = ren.render_frame(make_loaded_photo_wall(w, h, n, ref.id), port.vec2(w, h)).numpy()
    assert float(np.abs(got - want).max()) <= 1.0 / 255.0
    stored = np.load(G4_WALL_REFERENCE)
    np.testing.assert_allclose(stored, block_means(want), rtol=0, atol=1e-6)
    assert float(np.abs(block_means(got) - stored).max()) <= 1e-5
    ref.close()
