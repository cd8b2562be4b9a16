"""figdraw_tpu_torch's WOFF 2.0 reader (text/woff2.py with the port's Brotli
decoder, through text/otf.py and text/typefaces.py) against figdraw_tpu,
which opens a .woff2 face with fontTools 4.61.1's TTFont (WOFF2Reader;
tools/brotli_shim.py stands in for the brotli module, installed for each
test by `_brotli` and never for the session).

- The faces (scenes.WOFF2_FACES): DejaVuSans.woff2 (jupyterlab's copy of
  DejaVu Sans 2.37, glyf and loca transformed), FigPortSans-VF.woff2
  (glyf, loca and hmtx transformed) and FigPortSans-CFF.woff2 (CFF, none
  transformed; both written by tools/make_port_faces.py, byte for byte
  again in test_torch_variations.py). Every table of the port's sfnt but
  glyf and loca equals what WOFF2Reader gives, byte for byte; glyf's glyphs
  equal fontTools' (contours, points, on-curve flags, bounds, components,
  instructions), loca has the size the directory states.
- The typeface: its id (a hash of the file's own bytes), cmap, glyph order,
  kern pairs and metrics equal figdraw_tpu's, and its TTF or OTF twin's but
  the id (for the FigPort faces); every glyph's outline and advance equal
  figdraw_tpu's, at the seven scenes.FONT_LOCATIONS for the variable face;
  DejaVuSans.woff2's stored digests (reference/fonts.json) are the port's.
- Scenes: the WOFF2 text table at 8 rows through the port's planner on
  the megakernel with the atlas, its tape figdraw_tpu's byte for byte but
  the sign of zero and its frame within 1/255 of figdraw_tpu's. bench_text
  from each face is held to figdraw_tpu's combo and atlas byte for byte in
  test_torch_variations.py (scenes.FONT_TEXT_CASES).
- Faults: seeded cuts and flips of the two FigPort faces
  (tools/woff2_fuzz_agreement.py's cases) fail in the port, with
  ValueError, where they fail in fontTools and read its values elsewhere;
  the cases the port once read apart from fontTools, rebuilt from their
  seeds; a WOFF2 collection raises ValueError, as fontTools fails on one.
- A corrupt "wOF2" header raises ValueError naming WOFF2 where fontTools
  raises: tests/test_torch_woff.py::test_woff2_raises_naming_woff2.
"""

import io
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch
from fontTools.ttLib import TTFont
from fontTools.ttLib import woff2 as ft_woff2

from figdraw_tpu.text import typefaces as jax_tf
from figdraw_tpu_torch import scenes
from figdraw_tpu_torch.text import typefaces as port_tf
from figdraw_tpu_torch.text.otf import OTFont
from figdraw_tpu_torch.text.woff2 import directory
from torch_reference import REPO, block_means, jax_font_table_plan, jax_variations, \
    port_variations

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(REPO, "tools"))
import brotli_shim  # noqa: E402
import woff2_fuzz_agreement  # noqa: E402

TWINS = {"FigPortSans-VF.woff2": "FigPortSans-VF.ttf",
         "FigPortSans-CFF.woff2": "FigPortSans-CFF.otf"}
TRANSFORMED = {"DejaVuSans.woff2": ["glyf", "loca"],
               "FigPortSans-VF.woff2": ["glyf", "hmtx", "loca"],
               "FigPortSans-CFF.woff2": []}


@pytest.fixture(autouse=True)
def _brotli(monkeypatch):
    """fontTools' WOFF2 reader through tools/brotli_shim.py, for this test
    only."""
    monkeypatch.setattr(ft_woff2, "brotli", brotli_shim, raising=False)
    monkeypatch.setattr(ft_woff2, "haveBrotli", True)


def _read(face: str) -> bytes:
    with open(port_tf.bundled_font_path(face), "rb") as fh:
        return fh.read()


def _glyph(g) -> tuple:
    """A decompiled glyf glyph's contents."""
    if g.numberOfContours == 0:
        return (0,)
    box = (g.xMin, g.yMin, g.xMax, g.yMax)
    prog = g.program.getBytecode() if hasattr(g, "program") else b""
    if g.isComposite():
        comps = [(c.glyphName, getattr(c, "x", None), getattr(c, "y", None),
                  getattr(c, "transform", None), c.flags) for c in g.components]
        return (-1, box, comps, prog)
    return (g.numberOfContours, box, list(g.endPtsOfContours), list(g.coordinates),
            [f & 1 for f in g.flags], prog)


@pytest.mark.parametrize("face", scenes.WOFF2_FACES)
def test_tables_equal_fonttools_reader(face):
    data = _read(face)
    reader = ft_woff2.WOFF2Reader(io.BytesIO(data))
    _head, entries, _at = directory(data)
    assert sorted(e[0] for e in entries if e[4]) == TRANSFORMED[face]
    font = OTFont(data)
    assert sorted(font.tables) == sorted(str(tag) for tag in reader.tables)
    for tag in reader.tables:
        off, length = font.tables[str(tag)]
        assert off % 4 == 0
        if str(tag) not in ("glyf", "loca"):
            assert font.data[off: off + length] == reader[tag], tag
    if "glyf" in reader.tables:
        assert font.tables["loca"][1] == reader.tables["loca"].origLength
        want, got = TTFont(io.BytesIO(data)), TTFont(io.BytesIO(font.data))
        order = want.getGlyphOrder()
        assert got.getGlyphOrder() == order
        for name in order:
            assert _glyph(got["glyf"][name]) == _glyph(want["glyf"][name]), name


def _twin(face: str):
    """The port's typeface of a FigPort face's TTF or OTF twin (the WOFF2
    file wraps it); DejaVuSans.woff2 is jupyterlab's build of DejaVu Sans
    2.37 and not the bundled TTF (no kern table, other outlines): None."""
    if face not in TWINS:
        return None
    return port_tf.get_typeface(port_tf.load_typeface(port_tf.bundled_font_path(TWINS[face])))


@pytest.mark.parametrize("face", scenes.WOFF2_FACES)
def test_typeface_equals_figdraw_tpu_and_its_twin(face):
    jtf = jax_tf.get_typeface(jax_tf.load_typeface(port_tf.bundled_font_path(face)))
    ptf = port_tf.get_typeface(port_tf.load_typeface(port_tf.bundled_font_path(face)))
    stf = _twin(face)
    assert ptf.id == jtf.id
    assert stf is None or stf.id != ptf.id
    for tf in (jtf, stf) if stf is not None else (jtf,):
        assert ptf.cmap == tf.cmap and ptf.cmap
        assert ptf._glyph_order == tf._glyph_order
        assert ptf._kern == tf._kern
        assert [ptf.advance(g) for g in range(len(ptf._glyph_order))] == [
            tf.advance(g) for g in range(len(tf._glyph_order))]
        assert (ptf.units_per_em, ptf.ascent, ptf.descent, ptf.line_gap,
                ptf.family_name) == (tf.units_per_em, tf.ascent, tf.descent, tf.line_gap,
                                     tf.family_name)


OUTLINE_CASES = ([("FigPortSans-VF.woff2", loc) for loc in scenes.FONT_LOCATIONS]
                 + [("FigPortSans-CFF.woff2", ()), ("DejaVuSans.woff2", ())])


@pytest.mark.parametrize("case", OUTLINE_CASES,
                         ids=[scenes.font_case_key(*c) for c in OUTLINE_CASES])
def test_every_glyph_path_equals_figdraw_tpu(case):
    """Outlines and advances of every glyph at a location: equal as numbers
    and as int or float to figdraw_tpu's, and to the twin's (for the
    FigPort faces)."""
    face, loc = case
    jtf = jax_tf.get_typeface(jax_tf.load_typeface(port_tf.bundled_font_path(face)))
    ptf = port_tf.get_typeface(port_tf.load_typeface(port_tf.bundled_font_path(face)))
    stf = _twin(face) or ptf
    jv, pv = jax_variations(loc), port_variations(loc)
    for gid in range(len(ptf._glyph_order)):
        got = ptf.glyph_path(gid, pv)
        want = jtf.glyph_path(gid, jv)
        assert got == want, ptf.glyph_name(gid)
        assert [type(v) for _op, pts in got for pt in pts if pt is not None for v in pt] == \
            [type(v) for _op, pts in want for pt in pts if pt is not None for v in pt]
        assert got == stf.glyph_path(gid, pv), ptf.glyph_name(gid)
        assert ptf.var_advance(gid, pv) == jtf.var_advance(gid, jv) == stf.var_advance(gid, pv)


def test_dejavu_stored_digests_are_the_ports():
    """DejaVuSans.woff2 has no variation axes: its stored digests (written
    from figdraw_tpu at the seven locations) are one pair, the port's at
    the default."""
    with open(scenes.FONTS_REFERENCE) as fh:
        refs = json.load(fh)
    face = "DejaVuSans.woff2"
    stored = refs["faces"][face]["outlines"]
    assert len(stored) == len(scenes.FONT_LOCATIONS)
    pairs = {(v["paths"], v["advances"]) for v in stored.values()}
    ptf = port_tf.get_typeface(port_tf.load_typeface(port_tf.bundled_font_path(face)))
    assert pairs == {scenes.outline_digests(ptf, ())}
    for name, entry in refs["woff2"].items():
        _head, entries, _at = directory(_read(name))
        assert entry["bytes"] == sum(e[3] for e in entries)


def test_woff2_text_table_equals_figdraw_tpu():
    """The WOFF2 VF face's text table (its rows cut to 8): the port's
    walked tape is figdraw_tpu's plan byte for byte but the sign of zero,
    its atlas byte for byte, it plans to the megakernel with the atlas,
    and its frame is within 1/255 of figdraw_tpu's."""
    from figdraw_tpu_torch import FigRenderer, vec2
    from figdraw_tpu_torch.plan import pack_walked_tape, plan_execution

    face, loc = scenes.FONT_WOFF2_TABLE_CASE
    path = port_tf.bundled_font_path(face)
    rows = 8
    combo, atlas, frame = jax_font_table_plan(path, loc, render=True, rows=rows)
    tid = port_tf.load_typeface(path)
    tree = scenes.make_text_table_scene(rows, 6, 1200.0, 800.0, tid=tid,
                                        variations=port_variations(loc))
    ren = FigRenderer(atlas_size=512, device="cpu")
    tape = ren.flatten(tree, vec2(1200, 800))
    pack_walked_tape(tape)
    assert scenes.array_digest(tape.combo, zero_sign=True) == scenes.array_digest(
        combo, zero_sign=True)
    assert np.array_equal(ren.atlas.data, atlas)
    plan = plan_execution(tape)
    assert plan.mega_atlas
    got = ren.execute_plan(plan).numpy()
    assert np.abs(got - frame).max() <= 1.0 / 255.0
    assert np.abs(block_means(got) - block_means(frame)).max() <= 1.0 / 255.0


@pytest.mark.parametrize("seed", range(3))
def test_corrupt_faces_fail_where_fonttools_fails(seed):
    """25 seeded cuts and flips of the FigPort WOFF2 faces: the port reads
    fontTools' values or fails where fontTools fails."""
    faces = woff2_fuzz_agreement.stored_faces()
    kinds = []
    for _i, name, data in woff2_fuzz_agreement.corrupt_cases(faces, 100 + seed, 28):
        if name == "DejaVuSans.woff2":
            continue
        kinds.append(woff2_fuzz_agreement.classify(data))
    # both refuse, the port with ValueError or NotImplementedError only
    # (classify names any other refusal: "both_raise (IndexError)")
    assert all(k in ("equal", "both_raise") for k in kinds), kinds
    assert len(kinds) == 25


# (pass, seed, index) of tools/woff2_fuzz_agreement.py's cases the port once
# read apart from fontTools, and what each holds
REPAIRED_FUZZ_CASES = [
    ("woff2", 0, 124, "no post table: fontTools names the glyphs from cmap"),
    ("woff2", 1, 170, "no post table: fontTools names the glyphs from cmap"),
    ("woff2", 1, 9, "an hmtx shorter than its numberOfHMetrics"),
    ("woff2", 0, 267, "a CFF Top DICT with a VarStore cut short"),
    ("woff2", 1, 49, "a CFF offset before the table's start"),
    ("woff2", 1, 299, "a CFF INDEX item past the table"),
    ("woff2", 1, 337, "a WOFF2 metadata block past the file"),
    ("woff2", 1, 350, "the cmap entry's tag flipped: no cmap table"),
    ("woff2", 2, 33, "a CFF font name that is not ASCII"),
    ("woff2", 1, 97, "a Top DICT string id past the CFF strings"),
    ("woff2", 0, 217, "a table directory past the end (was struct.error)"),
    ("woff2", 1, 59, "a charstring operator short of operands (was IndexError)"),
    ("woff2", 1, 163, "a CFF charset offset below 0 (was KeyError)"),
    ("woff2", 0, 198, "a composite's component past the glyphs (was IndexError)"),
]


@pytest.mark.parametrize("case", REPAIRED_FUZZ_CASES,
                         ids=[f"{c[0]}-seed{c[1]}-{c[2]}" for c in REPAIRED_FUZZ_CASES])
def test_repaired_fuzz_cases_agree_with_fonttools(case):
    """Each case rebuilt from its seed and index: the port reads fontTools'
    values, or refuses with ValueError where fontTools fails."""
    which, seed, index, _why = case
    rebuild = woff2_fuzz_agreement.case if which == "woff2" else woff2_fuzz_agreement.sfnt_case
    _name, data = rebuild(seed, index)
    assert woff2_fuzz_agreement.classify(data) in ("equal", "both_raise")


def test_a_woff2_collection_raises():
    """A WOFF2 collection (flavor "ttcf" and a collection directory after
    the table directory): fontTools' WOFF2Reader has no collection
    directory and fails on the stream it misreads; the port refuses the
    flavor with ValueError. (A "ttcf" flavor over a single font's layout,
    with no collection directory, fontTools reads as one font: ROADMAP §3.)"""
    data = bytearray(_read("FigPortSans-VF.woff2"))
    head, entries, at = directory(bytes(data))
    n = len(entries)
    collection = struct.pack(">IB", 0x00010000, 1) + bytes([n]) + b"\x00\x01\x00\x00" + \
        bytes(range(n))
    coll = bytes(data[:at]) + collection + bytes(data[at:])
    coll = bytearray(coll)
    coll[4:8] = b"ttcf"
    struct.pack_into(">I", coll, 8, len(coll))
    with pytest.raises(Exception):
        TTFont(io.BytesIO(bytes(coll)))["glyf"]
    with pytest.raises(ValueError, match="collection"):
        OTFont(bytes(coll))
    flavor_only = bytearray(data)
    flavor_only[4:8] = b"ttcf"
    with pytest.raises(ValueError, match="collection"):
        OTFont(bytes(flavor_only))
    assert len(TTFont(io.BytesIO(bytes(flavor_only))).getGlyphOrder()) == 391
