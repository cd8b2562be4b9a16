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
- cmap formats 0, 6 and 12 and post format 3 names on fonts built for them;
- names, axes, feature tags and scripts (typeface_info) against the JAX
  package's;
- the NotImplementedErrors of a CFF face and of a variation location away
  from the default, each naming its ROADMAP item;
- the bundled font is DejaVuSans, with its sha256.
"""

import dataclasses
import hashlib
import os

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
    font without glyph names (post format 3): unique, stable names, the
    same gids through the shaper."""
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
    with pytest.raises(NotImplementedError, match="Text host pipeline.*CFF"):
        port_typefaces.load_typeface(path)


def test_variation_location_raises_with_its_roadmap_item(built_fonts):
    """The default location of a variable face draws; any other raises,
    at typeset and at raster time, naming the ROADMAP item."""
    from figdraw_tpu_torch import fill, rgba, vec2
    from figdraw_tpu_torch.text.layout import typeset
    from figdraw_tpu_torch.text.raster import rasterize_glyph

    tid = port_typefaces.load_typeface(built_fonts["var"])
    tf = port_typefaces.get_typeface(tid)
    a = tf.glyph_id(ord("A"))
    default = (port_typefaces.FontVariation("wght", 100),)
    heavy = (port_typefaces.FontVariation("wght", 900),)
    assert tf.var_advance(a, default) == tf.advance(a) == 500
    assert rasterize_glyph(tf, a, 20.0, variations=default) is not None
    with pytest.raises(NotImplementedError, match="Text host pipeline.*variable-font"):
        tf.var_advance(a, heavy)
    with pytest.raises(NotImplementedError, match="variable-font instancing"):
        rasterize_glyph(tf, a, 20.0, variations=heavy)
    f = port_typefaces.FigFont(typeface_id=tid, size=20.0, variations=heavy)
    with pytest.raises(NotImplementedError, match="variable-font instancing"):
        typeset(vec2(400, 40), [(f, fill(rgba(0, 0, 0, 255)), "AA")])


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
