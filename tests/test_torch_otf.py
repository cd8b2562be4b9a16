"""figdraw_tpu_torch's OpenType reader (text/otf.py) against fontTools, which
the JAX package reads fonts with.

- DejaVuSans and DejaVuSerif: the glyph order, getBestCmap, every advance,
  the legacy kern pairs, the GDEF classes, and the outline of every glyph as
  fontTools' DecomposingRecordingPen records it (values and their int or
  float types, exactly);
- the fonts the JAX shaping tests build with FontBuilder and feaLib, and
  one whose GSUB and GPOS lookups sit in extension subtables: the shaper
  compiled on the port's tables equals the JAX shaper compiled on
  fontTools' (every GSUB and GPOS lookup, the mark, cursive and kerning
  tables, the GDEF classes, the mark filtering sets);
- cmap formats 0, 6 and 12 on fonts built for them; the glyph names of
  faces whose post table names no glyph (format 3, none, format 1 over
  258 glyphs) and of post format 4, against figdraw_tpu's typeface, and
  the AGL table against fontTools.agl;
- malformed tables (hmtx, maxp, post, loca, fvar, a table or the
  directory past the end, no cmap) refused with ValueError where fontTools
  fails;
- names, axes, feature tags and scripts (typeface_info) against the JAX
  package's;
- a CFF face built with FontBuilder and a variable face at locations away
  from its default, equal to fontTools' outlines and figdraw_tpu's advances,
  typesets and rasters;
- cubic glyf contours (glyphDataFormat 1), drawn as fontTools draws them;
- a composite placed by point matching: figdraw_tpu raises on it (fontTools'
  getComponentInfo has no offset to give), the port raises
  NotImplementedError, and the face's other glyphs agree;
- the bundled font is DejaVuSans, with its sha256.
"""

import dataclasses
import hashlib
import io
import os
import struct
import sys

import pytest
from fontTools.pens.recordingPen import DecomposingRecordingPen
from fontTools.ttLib import TTFont

from figdraw_tpu.text import shaper as jax_shaper
from figdraw_tpu.text import typeface_info as jax_info
from figdraw_tpu.text import typefaces as jax_typefaces
from figdraw_tpu_torch.text import shaper as port_shaper
from figdraw_tpu_torch.text import typeface_info as port_info
from figdraw_tpu_torch.text import typefaces as port_typefaces
from figdraw_tpu_torch.text.otf import OTFont
from torch_reference import DEJAVU, shaping_font_paths

DEJAVU_SERIF = "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf"
BUNDLED_SHA256 = "abdc775b21b1bc470d50c97e790d276f2054b7504e56e5bd3e64f48d68582322"


def _reader(path):
    with open(path, "rb") as fh:
        return OTFont(fh.read())


@pytest.fixture(scope="module")
def built_fonts(tmp_path_factory):
    return shaping_font_paths(tmp_path_factory.mktemp("otf"))


def _types(value):
    return [type(v) for _op, pts in value for pt in pts if pt is not None for v in pt]


@pytest.mark.parametrize("path", [DEJAVU, DEJAVU_SERIF], ids=["sans", "serif"])
def test_tables_equal_fonttools(path):
    ours = _reader(path)
    tt = TTFont(path, lazy=True)
    order = tt.getGlyphOrder()
    assert ours.glyph_order == order
    assert ours.getBestCmap() == tt.getBestCmap()
    hmtx = tt["hmtx"]
    assert [ours.advance(g) for g in range(len(order))] == [hmtx[n][0] for n in order]
    want_kern = {}
    for sub in tt["kern"].kernTables:
        want_kern.update(getattr(sub, "kernTable", None) or {})
    assert ours.kern_pairs() == want_kern and want_kern
    gdef, tt_gdef = ours.get("GDEF").table, tt["GDEF"].table
    assert gdef.GlyphClassDef.classDefs == tt_gdef.GlyphClassDef.classDefs
    assert gdef.MarkAttachClassDef.classDefs == tt_gdef.MarkAttachClassDef.classDefs
    assert ours.units_per_em == tt["head"].unitsPerEm
    assert (ours.ascent, ours.descent, ours.line_gap) == (
        tt["hhea"].ascent, tt["hhea"].descent, tt["hhea"].lineGap)


@pytest.mark.parametrize("path", [DEJAVU, DEJAVU_SERIF], ids=["sans", "serif"])
def test_every_glyph_outline_equals_the_recording_pen(path):
    """All 6253 glyphs of DejaVuSans (3528 of DejaVuSerif): simple and
    composite, contours that start off-curve, the lsb - xMin shift of
    TTGlyphSet, exactly, with ints where fontTools gives ints."""
    ours = _reader(path)
    tt = TTFont(path, lazy=True)
    gs = tt.getGlyphSet()
    bad = []
    composites = 0
    for gid, name in enumerate(tt.getGlyphOrder()):
        pen = DecomposingRecordingPen(gs)
        gs[name].draw(pen)
        got = ours.glyph_path(gid)
        if got != pen.value or _types(got) != _types(pen.value):
            bad.append(name)
        composites += ours._glyph(gid)[0] == "composite"
    assert not bad, bad[:10]
    assert composites > 1000


def test_all_off_curve_contour_ends_in_none(tmp_path):
    """A contour with no on-curve point is one qCurveTo closed by None, and a
    contour that starts off-curve is rotated to end on-curve."""
    from fontTools.fontBuilder import FontBuilder
    from fontTools.pens.ttGlyphPen import TTGlyphPen

    fb = FontBuilder(1000, isTTF=True)
    names = [".notdef", "o", "s"]
    fb.setupGlyphOrder(names)
    fb.setupCharacterMap({ord("o"): "o", ord("s"): "s"})
    ring = TTGlyphPen(None)
    ring.qCurveTo((0, 100), (100, 200), (200, 100), (100, 0), None)
    ring.closePath()
    start_off = TTGlyphPen(None)
    start_off.qCurveTo((0, 0), (100, 300), (200, 0))
    start_off.lineTo((200, -50))
    start_off.closePath()
    fb.setupGlyf({".notdef": TTGlyphPen(None).glyph(), "o": ring.glyph(),
                  "s": start_off.glyph()})
    fb.setupHorizontalMetrics({n: (300, 0) for n in names})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "Rings", "styleName": "Regular"})
    fb.setupOS2()
    fb.setupPost()
    path = str(tmp_path / "rings.ttf")
    fb.font.save(path)
    ours = _reader(path)
    tt = TTFont(path)
    gs = tt.getGlyphSet()
    for gid, name in enumerate(names):
        pen = DecomposingRecordingPen(gs)
        gs[name].draw(pen)
        assert ours.glyph_path(gid) == pen.value
    assert ours.glyph_path(1)[0][1][-1] is None


def _compiled(shaper):
    """What a shaper compiled from its font's tables: every GSUB and GPOS
    lookup, and the tables its constructor builds."""
    out = {}
    if shaper._gsub is not None:
        n = len(shaper._gsub.table.LookupList.Lookup)
        out["gsub"] = [shaper._compile_lookup(i) for i in range(n)]
    if shaper._gpos_table is not None:
        n = len(shaper._gpos_table.LookupList.Lookup)
        out["gpos"] = [shaper._compile_gpos_lookup(i) for i in range(n)]
    for name in ("_gdef_class", "_mark_attach_class", "_mark_glyph_sets",
                 "_cursive", "_pair_specific", "_pair_class", "_mark_base",
                 "_mark_lig", "_mark_mark", "_mark_glyphs", "has_gpos_kern"):
        out[name] = getattr(shaper, name)
    for tag in ("GSUB", "GPOS"):
        found = shaper._tt.get(tag)
        if found is not None:
            table = found.table
            out[tag + " features"] = [(r.FeatureTag, r.Feature.LookupListIndex)
                                      for r in table.FeatureList.FeatureRecord]
            out[tag + " scripts"] = [
                (r.ScriptTag,
                 None if r.Script.DefaultLangSys is None
                 else r.Script.DefaultLangSys.FeatureIndex,
                 [(lr.LangSysTag, lr.LangSys.FeatureIndex)
                  for lr in r.Script.LangSysRecord])
                for r in table.ScriptList.ScriptRecord]
            out[tag + " flags"] = [(lk.LookupType, lk.LookupFlag,
                                    getattr(lk, "MarkFilteringSet", None))
                                   for lk in table.LookupList.Lookup]
    return out


def _font_ids():
    return ["dejavu", "serif", "fea", "multiple", "mark_filter", "cursive",
            "thai", "khmer", "myanmar", "extension", "context"]


@pytest.mark.parametrize("key", _font_ids())
def test_shaper_tables_equal_the_jax_shapers(built_fonts, key):
    path = {"dejavu": DEJAVU, "serif": DEJAVU_SERIF}.get(key) or built_fonts[key]
    jax_sh = jax_shaper.OpenTypeShaper(TTFont(path, lazy=True))
    port_sh = port_shaper.OpenTypeShaper(_reader(path))
    want, got = _compiled(jax_sh), _compiled(port_sh)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name
    if key == "extension":
        types = [lk.LookupType for t in ("GSUB", "GPOS")
                 for lk in port_sh._tt.get(t).table.LookupList.Lookup]
        assert 7 in types and 9 in types


def _decoded(obj, depth=0):
    """A fontTools or port layout object as plain data: the attributes the
    shaper reads, recursively."""
    if isinstance(obj, (list, tuple)):
        return [_decoded(v, depth + 1) for v in obj]
    if isinstance(obj, (int, str, float)) or obj is None:
        return obj
    if hasattr(obj, "glyphs"):
        return ("cov", list(obj.glyphs))
    if hasattr(obj, "classDefs"):
        return ("cd", dict(obj.classDefs))
    keep = ("Format", "Coverage", "ClassDef", "BacktrackClassDef", "InputClassDef",
            "LookAheadClassDef", "BacktrackCoverage", "InputCoverage",
            "LookAheadCoverage", "Backtrack", "Input", "LookAhead", "Class",
            "PosLookupRecord", "SubstLookupRecord", "SequenceIndex",
            "LookupListIndex")
    out = {}
    for name in dir(obj):
        if name in keep or name.endswith(("RuleSet", "ClassSet", "Rule")):
            if name.startswith("_") or callable(getattr(obj, name)):
                continue
            out[name] = _decoded(getattr(obj, name), depth + 1)
    return out


def test_context_positioning_subtables_equal_fonttools(built_fonts, tmp_path):
    """GPOS 7 (contextual positioning, formats 1-3) and the other context
    formats, decoded under fontTools' names and values. The shapers are
    not run on GPOS 7: both packages' _unwrap takes it for an extension."""
    import shutil

    from torch_reference import add_context_formats

    path = str(tmp_path / "ctx7.ttf")
    shutil.copy(built_fonts["context"], path)
    add_context_formats(path, gpos7=True)
    ours = _reader(path)
    tt = TTFont(path)
    for tag in ("GSUB", "GPOS"):
        want = tt[tag].table.LookupList.Lookup
        got = ours.get(tag).table.LookupList.Lookup
        assert len(got) == len(want)
        types = []
        for lw, lg in zip(want, got):
            assert (lg.LookupType, lg.LookupFlag) == (lw.LookupType, lw.LookupFlag)
            if lw.LookupType in (5, 6, 7, 8):
                assert _decoded(lg.SubTable) == _decoded(lw.SubTable)
                types.append((lw.LookupType, lw.SubTable[0].Format))
        if tag == "GPOS":
            assert {(7, 1), (7, 2), (7, 3), (8, 1), (8, 2)} <= set(types)
        else:
            assert {(5, 1), (5, 2), (5, 3), (6, 1), (6, 2)} <= set(types)


def test_cmap_formats_and_post_format_3(tmp_path):
    """getBestCmap's pick among subtables of formats 0, 4, 6 and 12, and a
    font without glyph names (post format 3): fontTools' names from the
    cmap (TTFont._getGlyphNamesFromCmap), figdraw_tpu's typeface's glyph
    order and glyph_name, the same gids through the shaper."""
    from fontTools.ttLib.tables._c_m_a_p import CmapSubtable

    base = TTFont(DEJAVU)
    cmap = base.getBestCmap()
    picks = []
    for fmt, (pid, eid), codes in ((0, (0, 0), range(32, 127)),
                                   (6, (3, 1), range(0x41, 0x5B)),
                                   (12, (3, 10), list(range(0x20, 0x7F)) + [0x1D400])):
        tt = TTFont(DEJAVU)
        sub = CmapSubtable.newSubtable(fmt)
        sub.platformID, sub.platEncID, sub.language = pid, eid, 0
        sub.cmap = {c: cmap.get(c, ".notdef") for c in codes}
        tt["cmap"].tables = [sub]
        path = str(tmp_path / f"cmap{fmt}.ttf")
        tt.save(path)
        want = TTFont(path).getBestCmap()
        assert _reader(path).getBestCmap() == want
        picks.append(len(want))
    assert all(picks)
    base["post"].formatType = 3.0
    path = str(tmp_path / "post3.ttf")
    base.save(path)
    ours = _reader(path)
    assert len(set(ours.glyph_order)) == len(ours.glyph_order) == 6253
    jtf = jax_typefaces.get_typeface(jax_typefaces.load_typeface(path))
    assert ours.glyph_order == jtf._glyph_order
    assert ours.glyph_order[:4] == [".notdef", "glyph00001", "glyph00002", "space"]
    tid = port_typefaces.load_typeface(path)
    tf = port_typefaces.get_typeface(tid)
    names = [tf.glyph_name(tf.glyph_id(ord(c))) for c in "office AV"]
    sh = port_shaper.get_shaper(tf)
    out, _ = sh.substitute(names, [(i, i + 1) for i in range(len(names))])
    ref = port_typefaces.get_typeface(port_typefaces.load_typeface(DEJAVU))
    ref_names = [ref.glyph_name(ref.glyph_id(ord(c))) for c in "office AV"]
    ref_out, _ = port_shaper.get_shaper(ref).substitute(
        ref_names, [(i, i + 1) for i in range(len(ref_names))])
    assert [tf._name_to_gid[n] for n in out] == [ref._name_to_gid[n] for n in ref_out]
    assert [tf.glyph_name(g) for g in range(6254)] == [jtf.glyph_name(g) for g in range(6254)]


@pytest.mark.parametrize("post", ["format 3", "none", "format 4", "format 1 over 258 glyphs"])
@pytest.mark.parametrize("face", ["FigPortSans-VF.ttf", "DejaVuSans.ttf"])
def test_glyph_names_without_post_names_are_figdraw_tpus(face, post, tmp_path):
    """A glyf face whose post table names no glyph (format 3, no post
    table, format 1 over more glyphs than its 258 names) takes fontTools'
    names from its cmap (AGL names, uniXXXX and uXXXXX, ".altN" for a name
    used again, glyphNNNNN for the rest); post format 4 names its glyphs
    by code through the AGL: the port's glyph_order and glyph_name equal
    figdraw_tpu's typeface's, name for name."""
    from figdraw_tpu_torch.text.typefaces import bundled_font_path

    tt = TTFont(bundled_font_path(face))
    if post == "none":
        del tt["post"]
    elif post == "format 1 over 258 glyphs":
        tt["post"].formatType = 1.0
    else:
        tt["post"].formatType = 3.0
    path = str(tmp_path / "twin.ttf")
    tt.save(path)
    if post == "format 4":  # fontTools writes no format 4: the codes are set by hand
        data = bytearray(open(path, "rb").read())
        ours = OTFont(bytes(data))
        off, _length = ours.tables["post"]
        cmap = {g: c for c, g in sorted(TTFont(path).getBestCmap().items(), reverse=True)
                if c <= 0xFFFF}
        codes = [cmap.get(name, 0xFFFF) for name in TTFont(path).getGlyphOrder()]
        body = struct.pack(">I", 0x00040000) + bytes(data[off + 4: off + 32]) + \
            struct.pack(">%dH" % len(codes), *codes)
        data = _replace_table(bytes(data), "post", body)
        with open(path, "wb") as fh:
            fh.write(data)
    ours = _reader(path)
    jtf = jax_typefaces.get_typeface(jax_typefaces.load_typeface(path))
    assert ours.glyph_order == jtf._glyph_order == TTFont(path).getGlyphOrder()
    n = len(ours.glyph_order)
    tf = port_typefaces.get_typeface(port_typefaces.load_typeface(path))
    assert [tf.glyph_name(g) for g in range(n + 1)] == [jtf.glyph_name(g) for g in range(n + 1)]
    if face == "FigPortSans-VF.ttf" and post != "format 1 over 258 glyphs":
        # the port's earlier rule (".notdef", then glyph00001 on) parted
        # from these names on most glyphs: 319 of 391 for post format 3
        synthesized = [".notdef"] + ["glyph%.5d" % g for g in range(1, n)]
        assert sum(a != b for a, b in zip(ours.glyph_order, synthesized)) >= 300


def _replace_table(data: bytes, tag: str, body: bytes) -> bytes:
    """The sfnt `data` with table `tag`'s bytes replaced by `body`, appended
    at the end (its directory entry's offset and length rewritten)."""
    out = bytearray(data)
    n = struct.unpack_from(">H", data, 4)[0]
    for i in range(n):
        rec = 12 + 16 * i
        if data[rec: rec + 4] == tag.encode():
            while len(out) % 4:
                out.append(0)
            struct.pack_into(">II", out, rec + 8, len(out), len(body))
            out += body
            return bytes(out)
    raise KeyError(tag)


def test_agl_table_is_what_the_tool_writes():
    """text/agl_data.py against fontTools.agl.UV2AGL, as
    tools/make_agl_table.py writes it."""
    from fontTools import agl

    from figdraw_tpu_torch.text.agl_data import UV2AGL
    from torch_reference import REPO

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_agl_table

    assert UV2AGL == agl.UV2AGL
    for path, data in make_agl_table.outputs().items():
        with open(path, "rb") as fh:
            assert fh.read() == data, path


def _malformed(name: str) -> bytes:
    """FigPortSans-VF.ttf with one table made malformed as `name` says."""
    from figdraw_tpu_torch.text.typefaces import bundled_font_path

    data = open(bundled_font_path("FigPortSans-VF.ttf"), "rb").read()
    face = OTFont(data)
    if name == "hmtx shorter than its metrics":
        off, length = face.tables["hmtx"]
        return _replace_table(data, "hmtx", data[off: off + length - 6])
    if name == "maxp of another length":
        off, length = face.tables["maxp"]
        return _replace_table(data, "maxp", data[off: off + length] + b"\0\0")
    if name == "a table past the end":
        return data[: face.tables["glyf"][0] + face.tables["glyf"][1] - 10] \
            if face.tables["glyf"][0] > face.tables["hmtx"][0] else data[:-10]
    if name == "no cmap":
        return data.replace(b"cmap", b"cmaq", 1)
    if name == "post format 2.5":
        off, length = face.tables["post"]
        return _replace_table(data, "post", struct.pack(">I", 0x00025000) +
                              data[off + 4: off + length])
    if name == "a loca entry before the one above it":
        off, length = face.tables["loca"]
        loca = bytearray(data[off: off + length])
        loca[8:10], loca[10:12] = loca[10:12], loca[8:10]
        loca[8:10] = struct.pack(">H", struct.unpack(">H", loca[10:12])[0] + 10)
        return _replace_table(data, "loca", bytes(loca))
    if name == "fvar of another version":
        off, length = face.tables["fvar"]
        return _replace_table(data, "fvar", b"\x00\x02" + data[off + 2: off + length])
    if name == "a directory past the end":
        return data[:30]
    raise KeyError(name)


MALFORMED = ["hmtx shorter than its metrics", "maxp of another length", "a table past the end",
             "no cmap", "post format 2.5", "a loca entry before the one above it",
             "fvar of another version", "a directory past the end"]


@pytest.mark.parametrize("name", MALFORMED)
def test_malformed_tables_raise_valueerror_where_fonttools_fails(name):
    """fontTools' checks on the tables figdraw_tpu's load reads: each
    malformed face fails in fontTools (as figdraw_tpu's Typeface opens it)
    and raises ValueError naming the table in the port."""
    from fontTools.pens.recordingPen import DecomposingRecordingPen

    data = _malformed(name)
    with pytest.raises(Exception):  # noqa: B017 - any fontTools failure
        tt = TTFont(io.BytesIO(data), lazy=True)
        tt["head"], tt["hhea"]  # noqa: B018
        order = tt.getGlyphOrder()
        gs = tt.getGlyphSet()
        for gname in order:
            gs[gname].draw(DecomposingRecordingPen(gs))
        tt.getBestCmap()
    with pytest.raises(ValueError):
        face = OTFont(data)
        face.getBestCmap()
        for gid in range(len(face.glyph_order)):
            face.glyph_path(gid)


@pytest.mark.parametrize("key", ["dejavu", "serif", "var", "fea"])
def test_typeface_info_equals_the_jax_packages(built_fonts, key):
    path = {"dejavu": DEJAVU, "serif": DEJAVU_SERIF}.get(key) or built_fonts[key]
    want = jax_info.get_typeface_info(jax_typefaces.load_typeface(path))
    got = port_info.get_typeface_info(port_typefaces.load_typeface(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.localized_names
    if key == "var":
        assert [a.tag for a in got.variation_axes] == ["wght"]


def test_cff_face_raises_with_its_roadmap_item(tmp_path):
    """The CFF face that raised before CFF outlines were read: it loads, and
    draws and measures as fontTools does."""
    from fontTools.fontBuilder import FontBuilder
    from fontTools.pens.t2CharStringPen import T2CharStringPen

    fb = FontBuilder(1000, isTTF=False)
    fb.setupGlyphOrder([".notdef", "A"])
    fb.setupCharacterMap({65: "A"})
    pen = T2CharStringPen(500, None)
    pen.moveTo((0, 0)); pen.lineTo((400, 0)); pen.lineTo((400, 600)); pen.closePath()
    fb.setupCFF("CffTest", {"FullName": "CffTest"},
                {".notdef": T2CharStringPen(500, None).getCharString(),
                 "A": pen.getCharString()}, {})
    fb.setupHorizontalMetrics({".notdef": (500, 0), "A": (500, 0)})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "CffTest", "styleName": "Regular"})
    fb.setupOS2()
    fb.setupPost()
    path = str(tmp_path / "cff.otf")
    fb.save(path)
    tf = port_typefaces.get_typeface(port_typefaces.load_typeface(path))
    tt = TTFont(path)
    gs = tt.getGlyphSet()
    pen = DecomposingRecordingPen(gs)
    gs["A"].draw(pen)
    a = tf.glyph_id(65)
    assert tf.glyph_path(a) == pen.value == [
        ("moveTo", ((0, 0),)), ("lineTo", ((400, 0),)), ("lineTo", ((400, 600),)),
        ("closePath", ())]
    assert tf.advance(a) == 500 and tf._glyph_order == tt.getGlyphOrder()
    jtf = jax_typefaces.get_typeface(jax_typefaces.load_typeface(path))
    assert tf.glyph_path(a) == jtf.glyph_path(a)


def test_variation_location_raises_with_its_roadmap_item(built_fonts):
    """The variable face whose locations away from the default raised
    before instancing was ported: at the default and at wght 900, 500 and
    past the axis, var_advance, glyph_path, a raster and a typeset equal
    figdraw_tpu's."""
    import numpy as np

    import figdraw_tpu as jp
    from figdraw_tpu.text.layout import typeset as jax_typeset
    from figdraw_tpu.text.raster import rasterize_glyph as jax_raster
    from figdraw_tpu_torch import fill, rgba, vec2
    from figdraw_tpu_torch.text.layout import typeset
    from figdraw_tpu_torch.text.raster import rasterize_glyph

    tid = port_typefaces.load_typeface(built_fonts["var"])
    tf = port_typefaces.get_typeface(tid)
    jtid = jax_typefaces.load_typeface(built_fonts["var"])
    jtf = jax_typefaces.get_typeface(jtid)
    a = tf.glyph_id(ord("A"))
    assert tf.var_advance(a, (port_typefaces.FontVariation("wght", 100),)) == 500
    assert tf.var_advance(a, (port_typefaces.FontVariation("wght", 900),)) == 900
    for w in (100, 500, 900, 1200):
        pv = (port_typefaces.FontVariation("wght", w),)
        jv = (jax_typefaces.FontVariation("wght", w),)
        assert tf.var_advance(a, pv) == jtf.var_advance(a, jv)
        assert tf.glyph_path(a, pv) == jtf.glyph_path(a, jv)
        got, want = rasterize_glyph(tf, a, 20.0, variations=pv), jax_raster(
            jtf, a, 20.0, variations=jv)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
        f = port_typefaces.FigFont(typeface_id=tid, size=20.0, variations=pv)
        jf = jax_typefaces.FigFont(typeface_id=jtid, size=20.0, variations=jv)
        arr = typeset(vec2(400, 40), [(f, fill(rgba(0, 0, 0, 255)), "AA")])
        jarr = jax_typeset(jp.vec2(400, 40), [(jf, jp.fill(jp.rgba(0, 0, 0, 255)), "AA")])
        assert [(g.glyph_id, g.pos.x, g.advance.x) for g in arr.arranged_glyphs] == [
            (g.glyph_id, g.pos.x, g.advance.x) for g in jarr.arranged_glyphs]


def _cubic_face(path):
    """A glyf face with glyphDataFormat 1: contours of cubic off-curve
    pairs (one all off-curve, one mixed with on-curve points and lines)."""
    from fontTools.fontBuilder import FontBuilder
    from fontTools.pens.ttGlyphPen import TTGlyphPen

    fb = FontBuilder(1000, isTTF=True, glyphDataFormat=1)
    fb.setupGlyphOrder([".notdef", "O", "D"])
    fb.setupCharacterMap({ord("O"): "O", ord("D"): "D"})
    o = TTGlyphPen(None)
    o.moveTo((100, 0)); o.curveTo((200, 0), (300, 100), (300, 200))
    o.curveTo((300, 300), (200, 401), (100, 401)); o.curveTo((0, 401), (-100, 300), (-100, 200))
    o.curveTo((-100, 100), (0, 0), (100, 0)); o.closePath()
    d = TTGlyphPen(None)
    d.moveTo((0, 0)); d.lineTo((200, 0)); d.curveTo((350, 0), (450, 150), (450, 351))
    d.curveTo((450, 500), (350, 700), (200, 700)); d.lineTo((0, 700)); d.closePath()
    fb.setupGlyf({".notdef": TTGlyphPen(None).glyph(), "O": o.glyph(dropImpliedOnCurves=True),
                  "D": d.glyph()})
    fb.setupHorizontalMetrics({".notdef": (500, 0), "O": (600, -100), "D": (600, 0)})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "Cubic", "styleName": "Regular"})
    fb.setupOS2()
    fb.setupPost()
    fb.save(path)


def test_cubic_glyf_contours_draw_as_fonttools(tmp_path):
    path = str(tmp_path / "cubic.ttf")
    _cubic_face(path)
    tt = TTFont(path)
    assert tt["head"].glyphDataFormat == 1
    gs = tt.getGlyphSet()
    ours = _reader(path)
    kinds = set()
    for gid, name in enumerate(tt.getGlyphOrder()):
        pen = DecomposingRecordingPen(gs)
        gs[name].draw(pen)
        got = ours.glyph_path(gid)
        assert got == pen.value, name
        assert _types(got) == _types(pen.value), name
        kinds.update(op for op, _ in got)
    assert "curveTo" in kinds and "qCurveTo" not in kinds


def test_bundled_font_is_dejavu_sans():
    path = port_typefaces.bundled_font_path()
    with open(path, "rb") as fh:
        data = fh.read()
    assert len(data) == 759720
    assert hashlib.sha256(data).hexdigest() == BUNDLED_SHA256
    if os.path.exists(DEJAVU):
        with open(DEJAVU, "rb") as fh:
            assert fh.read() == data
    # the same bytes get the same typeface id, by content
    assert port_typefaces.load_typeface(path) == port_typefaces.load_typeface(DEJAVU)
    with pytest.raises(FileNotFoundError):
        port_typefaces.load_typeface(path + ".missing")


def test_face_load_is_lazy_and_quick():
    """A 6253-glyph face reads no outline at load: glyf entries parse on
    first use."""
    import time

    t0 = time.perf_counter()
    ours = _reader(DEJAVU)
    ours.getBestCmap()
    elapsed = time.perf_counter() - t0
    assert not ours._glyphs
    ours.glyph_path(ours._name_to_gid["A"])
    assert len(ours._glyphs) == 1
    assert elapsed < 1.0


def _point_matched_face(path):
    """A glyf face whose "Adot" places its dot by point matching (dot's
    point 0 onto A's point 2), beside plain and offset composites."""
    from fontTools.fontBuilder import FontBuilder
    from fontTools.pens.ttGlyphPen import TTGlyphPen
    from fontTools.ttLib.tables._g_l_y_f import Glyph, GlyphComponent

    fb = FontBuilder(1000, isTTF=True)
    names = [".notdef", "A", "dot", "Adot", "Aacute"]
    fb.setupGlyphOrder(names)
    fb.setupCharacterMap({0x41: "A", 0x2E: "dot", 0xC0: "Adot", 0xC1: "Aacute"})
    a = TTGlyphPen(None)
    a.moveTo((0, 0)); a.lineTo((300, 700)); a.lineTo((600, 0)); a.closePath()
    dot = TTGlyphPen(None)
    dot.moveTo((0, 0)); dot.lineTo((0, 100)); dot.lineTo((100, 100)); dot.closePath()
    composites = {}
    for glyph, parts in (("Adot", (("A", (0, 0)), ("dot", None))),
                         ("Aacute", (("A", (0, 0)), ("dot", (250, 750))))):
        g = composites[glyph] = Glyph()
        g.numberOfContours = -1
        g.components = []
        for name, offset in parts:
            comp = GlyphComponent()
            comp.glyphName, comp.flags = name, 0
            if offset is None:
                comp.firstPt, comp.secondPt = 2, 0
            else:
                comp.x, comp.y = offset
            g.components.append(comp)
    fb.setupGlyf({".notdef": TTGlyphPen(None).glyph(), "A": a.glyph(), "dot": dot.glyph(),
                  **composites})
    fb.setupHorizontalMetrics({n: (600, 0) for n in names})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "Matched", "styleName": "Regular"})
    fb.setupOS2()
    fb.setupPost()
    fb.save(path)


def test_point_matched_composite_raises_in_both(tmp_path):
    """fontTools' glyph set cannot draw a composite placed by point matching
    (GlyphComponent.getComponentInfo raises AttributeError on its missing
    x), so figdraw_tpu raises on that glyph; the port raises
    NotImplementedError saying so. The face's other glyphs, its cmap and
    its advances agree in both."""
    path = str(tmp_path / "matched.ttf")
    _point_matched_face(path)
    jtf = jax_typefaces.get_typeface(jax_typefaces.load_typeface(path))
    ptf = port_typefaces.get_typeface(port_typefaces.load_typeface(path))
    gid = ptf._name_to_gid["Adot"]
    with pytest.raises(AttributeError):
        jtf.glyph_path(gid)
    with pytest.raises(NotImplementedError, match="point matching.*AttributeError"):
        ptf.glyph_path(gid)
    assert ptf.cmap == jtf.cmap and len(ptf.cmap) == 4
    for g, name in enumerate(ptf._glyph_order):
        assert ptf.advance(g) == jtf.advance(g)
        if name != "Adot":
            assert ptf.glyph_path(g) == jtf.glyph_path(g), name
    assert ptf.glyph_path(ptf._name_to_gid["Aacute"])
