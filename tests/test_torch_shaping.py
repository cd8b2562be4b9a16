"""figdraw_tpu_torch's shaper (text/shaper.py on the port's OpenType reader)
against figdraw_tpu's (on fontTools).

- Twins: every test of test_shaping.py, test_shaping_thai.py and
  test_shaping_use.py runs a second time on the port (torch_twin), with its
  fonts built by the same builders, test_variable_font_instancing's
  included; its differential twin holds the port's instanced advances,
  typesets and rasters to figdraw_tpu's at the same locations.
- Differential: the same fonts (DejaVuSans and the fonts those tests build)
  and the same strings go through both packages' typeset, and through both
  shapers' substitute / position for the Thai, Khmer and Myanmar runs of
  those tests: glyph ids, clusters and positions must be equal.
"""

import pytest
import torch

import test_shaping_thai as thai
import test_shaping_use as usex
from figdraw_tpu.text import layout as jax_layout
from figdraw_tpu.text import shaper as jax_shaper
from figdraw_tpu.text import typefaces as jax_tf
from figdraw_tpu_torch.text import layout as port_layout
from figdraw_tpu_torch.text import shaper as port_shaper
from figdraw_tpu_torch.text import typefaces as port_tf
from torch_reference import DEJAVU, shaping_font_paths
from torch_twin import assert_runs_on_port, case_id, port_twin, run_twin, twin_cases

torch.set_num_threads(1)

FILES = ("test_shaping", "test_shaping_thai", "test_shaping_use")
CASES = [c for name in FILES for c in twin_cases(name)]


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_port_twin(request, monkeypatch, case):
    assert_runs_on_port(port_twin(case[0]))
    run_twin(request, monkeypatch, case)


def test_variable_font_instancing(tmp_path):
    """test_shaping.test_variable_font_instancing's scene on both packages:
    at wght 100, 500, 900 and past the axis, the advances, the typeset
    arrangement, the font ids' distinctness and the rasters equal
    figdraw_tpu's."""
    import numpy as np
    import test_shaping

    import figdraw_tpu as jp
    from figdraw_tpu.text import raster as jax_raster
    from figdraw_tpu_torch import fill, rgba, vec2
    from figdraw_tpu_torch.text import raster as port_raster

    path = test_shaping._build_var_font(tmp_path)
    tid, jtid = port_tf.load_typeface(path), jax_tf.load_typeface(path)
    tf, jtf = port_tf.get_typeface(tid), jax_tf.get_typeface(jtid)
    a = tf.glyph_id(65)
    widths = []
    for w in (100.0, 500.0, 900.0, 1000.0):
        pv, jv = (port_tf.FontVariation("wght", w),), (jax_tf.FontVariation("wght", w),)
        assert tf.var_advance(a, pv) == jtf.var_advance(a, jv)
        pf = port_tf.FigFont(typeface_id=tid, size=20.0, variations=pv)
        jf = jax_tf.FigFont(typeface_id=jtid, size=20.0, variations=jv)
        pa = port_layout.typeset(vec2(1000, 100), [(pf, fill(rgba(0, 0, 0, 255)), "AA")])
        ja = jax_layout.typeset(jp.vec2(1000, 100), [(jf, jp.fill(jp.rgba(0, 0, 0, 255)), "AA")])
        assert arrangement(pa) == arrangement(ja)
        assert pa.arranged_glyphs[0].font_id == ja.arranged_glyphs[0].font_id
        got = port_raster.rasterize_glyph(tf, a, 40.0, variations=pv)
        want = jax_raster.rasterize_glyph(jtf, a, 40.0, variations=jv)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
        widths.append(pa.max_size.x)
    assert widths[0] < widths[1] < widths[2] == widths[3]


# --- the differential ------------------------------------------------------------------


@pytest.fixture(scope="module")
def fonts(tmp_path_factory):
    paths = shaping_font_paths(tmp_path_factory.mktemp("shaping"))
    paths["dejavu"] = DEJAVU
    return paths


def arrangement(arr):
    """Everything typeset decides, as plain data (but content_hash, which
    hashes the font objects' identities)."""
    return {
        "glyphs": [(g.glyph_id, g.cluster, g.source.rune_start, g.source.rune_end,
                    g.rune, g.is_whitespace, g.pos.x, g.pos.y, g.advance.x,
                    g.advance.y, g.offset.x, g.offset.y, g.rect.x, g.rect.y,
                    g.rect.w, g.rect.h, g.span_index, g.line_index)
                   for g in arr.arranged_glyphs],
        "lines": list(arr.lines), "spans": list(arr.spans),
        "levels": list(arr.bidi_levels), "bases": list(arr.bidi_bases),
        "bounding": (arr.bounding.x, arr.bounding.y, arr.bounding.w, arr.bounding.h),
    }


def both_typeset(path, text, size=24.0, box=(1000, 100), **kw):
    import figdraw_tpu as jp
    import figdraw_tpu_torch as pp

    out = []
    for pk, tf_mod, lay in ((jp, jax_tf, jax_layout), (pp, port_tf, port_layout)):
        tid = tf_mod.load_typeface(path)
        feats = tuple(tf_mod.FontFeature(t, v) for t, v in kw.pop("features", ())) \
            if "features" in kw else ()
        f = tf_mod.FigFont(typeface_id=tid, size=size, features=feats, **kw)
        arr = lay.typeset(pk.vec2(*box), [(f, pk.fill(pk.rgba(0, 0, 0, 255)), text)])
        out.append(arrangement(arr))
        kw = dict(kw, features=tuple((x.tag, x.value) for x in feats)) if feats else kw
    return out


HEB = "שלום"
TYPESET_CASES = [
    ("dejavu", "office", {}),
    ("dejavu", "office", {"features": (("liga", 0),)}),
    ("dejavu", "AVATAR WAVY Toyota", {}),
    ("dejavu", "AV", {"no_kerning_adjustments": True}),
    ("dejavu", HEB, {}),
    ("dejavu", "ab " + HEB, {}),
    ("dejavu", HEB + "(" + HEB + ")", {}),
    ("dejavu", "السلام", {}),
    ("dejavu", "لَا", {}),
    ("dejavu", "لاَ", {}),
    ("dejavu", "بَ", {}),
    ("dejavu", "éx ẹ́x i̇x", {}),
    ("dejavu", "б", {"language": "sr-Latn-RS"}),
    ("dejavu", "The quick brown fox jumps over the lazy dog 0123", {}),
    ("dejavu", "Wrapping a long line of text into a narrow box, twice over.",
     {"box": (120, 200)}),
    ("dejavu", "東京タワー and 北京", {"box": (60, 200)}),
    ("fea", "AVo", {}), ("fea", "afab", {}), ("fea", "TAVoT", {}),
    ("multiple", "é", {}), ("multiple", "éx", {}),
    ("mark_filter", "áb", {}), ("mark_filter", "ȧb", {}),
    ("mark_filter", "ćd", {}), ("mark_filter", "ċd", {}),
    ("cursive", "ab", {}), ("cursive", "abcab", {}),
    ("extension", "fil AV fi", {}), ("extension", "ÁV", {}),
    ("context", "axbyzcdaedbz", {}), ("context", "cdae bxz", {}),
    ("thai", "".join(chr(c) for c in (thai.KO, thai.MAI_EK, thai.SARA_AM)), {}),
    ("thai", "".join(chr(c) for c in (thai.LKO, thai.LMAI_EK, thai.LAM)), {}),
    ("thai_bare", "".join(chr(c) for c in (thai.KO, thai.MAI_EK, thai.SARA_AM)), {}),
    ("khmer", "".join(chr(c) for c in (usex.SA, usex.COENG, usex.RO, usex.II)), {}),
    ("myanmar", "".join(chr(c) for c in (usex.NGA, usex.ASAT, usex.VIRAMA, usex.MKA,
                                          usex.MEDRA, usex.ME)), {}),
]


@pytest.mark.parametrize("key,text,kw", TYPESET_CASES,
                         ids=[f"{k}-{i}" for i, (k, _t, _kw) in enumerate(TYPESET_CASES)])
def test_typeset_equals_the_jax_packages(fonts, key, text, kw):
    kw = dict(kw)
    box = kw.pop("box", (1000, 100))
    want, got = both_typeset(fonts[key], text, box=box, **kw)
    assert got == want
    assert got["glyphs"]


SHAPE_CASES = [
    ("thai", [thai.KO, thai.SARA_AM]),
    ("thai", [thai.KO, thai.MAI_EK, thai.MAI_THO, thai.SARA_AM]),
    ("thai", [thai.KO, thai.SARA_I, thai.MAI_EK, thai.SARA_AM]),
    ("thai", [thai.KO, thai.SARA_AM, thai.KO, thai.MAI_EK, thai.SARA_AM]),
    ("thai", [thai.LKO, thai.LYAMAKKAN, thai.LAM]),
    ("thai", [thai.LKO, thai.LMAI_KON, thai.LAM]),
    ("khmer", [usex.SA, usex.COENG, usex.RO, usex.AE]),
    ("khmer", [usex.KA, usex.E]),
    ("khmer", [usex.KA, usex.COENG, usex.RO, usex.COENG, usex.KA]),
    ("khmer", [usex.TA, usex.COENG, usex.TA]),
    ("khmer", [usex.KA, usex.ROBAT]),
    ("myanmar", [usex.NGA, usex.ASAT, usex.VIRAMA, usex.MKA]),
    ("myanmar", [usex.MKA, usex.VIRAMA, usex.MKA]),
    ("myanmar", [usex.MKA, usex.MEDYA, usex.MEDWA]),
    ("myanmar", [usex.MKA, usex.ME, usex.MKA, usex.ME]),
]


@pytest.mark.parametrize("key,cps", SHAPE_CASES,
                         ids=[f"{k}-{i}" for i, (k, _c) in enumerate(SHAPE_CASES)])
def test_substitute_and_position_equal_the_jax_shapers(fonts, key, cps):
    """The shapers' own entry points (substitute_ex with the source
    codepoints, position, cursive_chain) on the same runs: glyph ids,
    clusters, ligature components and x-advance deltas."""
    results = []
    for tf_mod, sh_mod in ((jax_tf, jax_shaper), (port_tf, port_shaper)):
        tf = tf_mod.get_typeface(tf_mod.load_typeface(fonts[key]))
        sh = sh_mod.get_shaper(tf)
        names = [tf.glyph_name(tf.glyph_id(cp)) for cp in cps]
        clusters = [(k, k + 1) for k in range(len(cps))]
        out_n, out_c, out_l = sh.substitute_ex(names, clusters, cps=cps)
        gids = [tf._name_to_gid.get(n, 0) for n in out_n]
        results.append((gids, out_c, out_l, sh.position(out_n), sh.cursive_chain(out_n)))
    assert results[1] == results[0]


def test_dejavu_kerning_tables_equal(fonts):
    """The GPOS kern pairs and the legacy kern table the layout falls back
    to, keyed by glyph id."""
    jt = jax_tf.get_typeface(jax_tf.load_typeface(DEJAVU))
    pt = port_tf.get_typeface(port_tf.load_typeface(DEJAVU))
    for a in "AVTWYLPFo.,":
        for b in "AVTWYovaey.,":
            ga, gb = jt.glyph_id(ord(a)), jt.glyph_id(ord(b))
            assert (pt.glyph_id(ord(a)), pt.glyph_id(ord(b))) == (ga, gb)
            assert pt.kerning(ga, gb) == jt.kerning(ga, gb)
            names = [jt.glyph_name(ga), jt.glyph_name(gb)]
            assert (port_shaper.get_shaper(pt).position(names)
                    == jax_shaper.get_shaper(jt).position(names))
