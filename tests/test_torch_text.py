"""figdraw_tpu_torch's text host pipeline against figdraw_tpu's: typesetting,
the glyph raster, the renderer's text switches and text nodes in frames.

- Twins (torch_twin): every test of test_text.py (typeset, wrap, align,
  caret, raster, TTC face selection, the subpixel and LCD flags,
  place_glyphs, typeset_for_measurement) and test_text_extra.py runs a
  second time on the port. test_font_fallback_resolver reads a Noto face
  that is not in this checkout; its twin runs the same resolver contract on
  a Devanagari face built with FontBuilder, against the JAX package.
- Differential: glyph rasters (rasterize_glyph, generate_glyph) byte for
  byte; text nodes of a RendersArray (selection bands, underline and
  strikethrough, inverted y, gradient spans) walked by both packages'
  native walks into the same packed combo and atlas, byte for byte, under
  each text switch; their frames within 1/255 of figdraw_tpu's
  (use_pallas=False), on the array and on the tree; the FIGDRAW_TEXT_*
  switches parse as figdraw_tpu.config's.
"""

import numpy as np
import pytest
import torch

import figdraw_tpu as jax_pkg
import figdraw_tpu_torch as port
from figdraw_tpu import config as jax_config
from figdraw_tpu.nodesarray import from_renders as jax_from_renders
from figdraw_tpu.renderer import FigRenderer as JaxRenderer
from figdraw_tpu.text import glyphs as jax_glyphs
from figdraw_tpu.text import layout as jax_layout
from figdraw_tpu.text import raster as jax_raster
from figdraw_tpu.text import typefaces as jax_tf
from figdraw_tpu_torch import config as port_config
from figdraw_tpu_torch.plan import pack_walked_tape
from figdraw_tpu_torch.text import glyphs as port_glyphs
from figdraw_tpu_torch.text import layout as port_layout
from figdraw_tpu_torch.text import raster as port_raster
from figdraw_tpu_torch.text import typefaces as port_tf
from torch_reference import DEJAVU
from torch_twin import assert_runs_on_port, case_id, port_twin, run_twin, twin_cases

torch.set_num_threads(1)

TOL = 1.0 / 255.0
CASES = (twin_cases("test_text")
         + twin_cases("test_text_extra", skip=("test_font_fallback_resolver",)))


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_port_twin(request, monkeypatch, case):
    assert_runs_on_port(port_twin(case[0]))
    run_twin(request, monkeypatch, case)


def _deva_font(path):
    """A face with the two Devanagari letters test_font_fallback_resolver
    asks for (DejaVuSans has none)."""
    from fontTools.fontBuilder import FontBuilder
    from fontTools.pens.ttGlyphPen import TTGlyphPen

    names = [".notdef", "ka", "ma"]
    fb = FontBuilder(1000, isTTF=True)
    fb.setupGlyphOrder(names)
    fb.setupCharacterMap({0x0915: "ka", 0x092E: "ma"})
    glyf = {}
    for i, g in enumerate(names):
        pen = TTGlyphPen(None)
        pen.moveTo((40, 0)); pen.lineTo((460 + 40 * i, 0))
        pen.lineTo((460, 650)); pen.lineTo((40, 650)); pen.closePath()
        glyf[g] = pen.glyph()
    fb.setupGlyf(glyf)
    fb.setupHorizontalMetrics({g: (520, 40) for g in names})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "DevaTest", "styleName": "Regular"})
    fb.setupOS2(sTypoAscender=800, sTypoDescender=-200)
    fb.setupPost()
    fb.font.save(str(path))
    return str(path)


def test_font_fallback_resolver(tmp_path):
    """test_text_extra.test_font_fallback_resolver's contract on a built
    Devanagari face: the resolver is asked once for the first miss, its
    typeface serves both letters, an unresolvable codepoint is asked once
    and memoized; the arrangement equals the JAX package's. The port has no
    Unicode script data (script_of_codepoint gives ""), so the resolver
    keys on the codepoints."""
    deva_path = _deva_font(tmp_path / "deva.ttf")
    results = []
    for pk, tf_mod, lay in ((jax_pkg, jax_tf, jax_layout), (port, port_tf, port_layout)):
        deva_id = tf_mod.load_typeface(deva_path)
        tid = tf_mod.load_typeface(DEJAVU)
        calls = []

        def resolver(req, calls=calls, deva_id=deva_id):
            calls.append(req)
            return [deva_id] if 0x0915 in req.codepoints else []

        assert tf_mod.font_fallback_resolver() is None
        tf_mod.set_font_fallback_resolver(resolver)
        try:
            font = tf_mod.FigFont(typeface_id=tid, size=18.0)
            ink = pk.fill(pk.rgba(0, 0, 0, 255))
            arr = lay.typeset(pk.vec2(400, 100), [(font, ink, "aकमb")])
            first = [(c.codepoints, c.primary_typeface_id) for c in calls]
            calls.clear()
            lay.typeset(pk.vec2(400, 100), [(font, ink, "\U00013000\U00013000")])
            second = len(calls)
        finally:
            tf_mod.set_font_fallback_resolver(None)
        by_rune = {g.rune: g for g in arr.arranged_glyphs}
        deva_tf = tf_mod.get_typeface(deva_id)
        assert [by_rune[ch].glyph_id for ch in "कम"] == [
            deva_tf.glyph_id(ord(ch)) for ch in "कम"]
        assert by_rune["a"].glyph_id != 0
        assert first == [((ord("क"),), tid)] and second == 1
        results.append([(g.glyph_id, g.font_id, g.pos.x, g.advance.x)
                        for g in arr.arranged_glyphs])
    assert results[1] == results[0]
    assert port_tf.script_of_codepoint(ord("क")) == ""


@pytest.mark.parametrize("size,shift,lcd", [(15.0, 0.0, False), (13.0, 0.3, False),
                                            (24.0, 0.0, True), (9.5, 0.7, True)])
def test_glyph_rasters_equal_the_jax_packages(size, shift, lcd):
    """rasterize_glyph's image and offset, byte for byte, over a spread of
    DejaVuSans' glyphs (Latin, Greek, Cyrillic, Arabic, marks, composites,
    symbols)."""
    jt = jax_tf.get_typeface(jax_tf.load_typeface(DEJAVU))
    pt = port_tf.get_typeface(port_tf.load_typeface(DEJAVU))
    rng = np.random.default_rng(0)
    gids = sorted(set(rng.integers(1, 6253, 60).tolist())
                  | {pt.glyph_id(ord(c)) for c in "AgQ@ßéπЖبﻼ%"})
    drawn = 0
    for gid in gids:
        a = jax_raster.rasterize_glyph(jt, gid, size, shift, lcd)
        b = port_raster.rasterize_glyph(pt, gid, size, shift, lcd)
        assert (a is None) == (b is None), gid
        if a is not None:
            assert a[1] == b[1], gid
            assert a[0].dtype == b[0].dtype and a[0].tobytes() == b[0].tobytes(), gid
            drawn += 1
    assert drawn > 40


def test_generate_glyph_and_hash_equal_the_jax_packages():
    """A registered font's glyph (its FontId folds in the UI scale) and its
    cache key, per subpixel variant."""
    jf = jax_tf.register_font(jax_tf.FigFont(typeface_id=jax_tf.load_typeface(DEJAVU),
                                             size=17.0), 1.5)
    pf = port_tf.register_font(port_tf.FigFont(typeface_id=port_tf.load_typeface(DEJAVU),
                                               size=17.0), 1.5)
    assert jf == pf
    for variant in (0, 3, 9):
        for lcd in (False, True):
            a = jax_glyphs.generate_glyph(jf, 36, lcd, variant)
            b = port_glyphs.generate_glyph(pf, 36, lcd, variant)
            assert a[1] == b[1] and a[0].tobytes() == b[0].tobytes()
            assert (port_glyphs.glyph_hash(pf, 36, lcd, variant)
                    == jax_glyphs.glyph_hash(jf, 36, lcd, variant))


@pytest.mark.parametrize("env", [
    {}, {"FIGDRAW_TEXT_LCD_FILTERING": "1"}, {"FIGDRAW_TEXT_LCD_FILTER": "yes"},
    {"FIGDRAW_TEXT_LCD_FILTERING": "0", "FIGDRAW_TEXT_LCD_FILTER": "1"},
    {"FIGDRAW_TEXT_SUBPIXEL_POSITIONING": "on"},
    {"FIGDRAW_TEXT_SUBPIXEL_POSITIONING": "1", "FIGDRAW_TEXT_SUBPIXEL_GLYPH_VARIANTS": "true"},
])
def test_text_switches_parse_as_the_jax_packages(monkeypatch, env):
    for name in ("FIGDRAW_TEXT_LCD_FILTERING", "FIGDRAW_TEXT_LCD_FILTER",
                 "FIGDRAW_TEXT_SUBPIXEL_POSITIONING", "FIGDRAW_TEXT_SUBPIXEL_GLYPH_VARIANTS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for fn in ("runtime_text_lcd_filtering_requested",
               "runtime_text_subpixel_positioning_requested",
               "runtime_text_subpixel_glyph_variants_requested"):
        assert getattr(port_config, fn)() == getattr(jax_config, fn)()
    ren = port.FigRenderer(device="cpu")
    assert ren._text_config() == (
        jax_config.runtime_text_lcd_filtering_requested(),
        jax_config.runtime_text_subpixel_positioning_requested(),
        jax_config.runtime_text_subpixel_positioning_requested()
        and jax_config.runtime_text_subpixel_glyph_variants_requested())


# --- text nodes in frames -------------------------------------------------------------


def text_scene(pk, w=320, h=120):
    """Text nodes with every part draw_text_layout emits, built with `pk`'s
    API: an underlined line, a selection over a Hebrew run, a struck-through
    gradient span, an inverted line, and a fractional x for the subpixel
    switches."""
    tf = __import__(pk.__name__ + ".text.typefaces", fromlist=["x"])
    lay = __import__(pk.__name__ + ".text.layout", fromlist=["x"])
    tid = tf.load_typeface(DEJAVU)
    ink = pk.fill(pk.rgba(20, 20, 30, 255))
    renders = pk.new_renders()
    renders.add_root(0, pk.Fig(kind=pk.FigKind.nkRectangle, screen_box=pk.rect(0, 0, w, h),
                               fill=pk.fill(pk.rgba(250, 250, 250, 255))))
    f = tf.FigFont(typeface_id=tid, size=16.0, underline=True)
    renders.add_root(0, pk.Fig(kind=pk.FigKind.nkText, screen_box=pk.rect(10.3, 6, 280, 22),
                               text_layout=lay.typeset(pk.vec2(280, 22),
                                                       [(f, ink, "Efficient AV text")])))
    f2 = tf.FigFont(typeface_id=tid, size=15.0)
    renders.add_root(0, pk.Fig(
        kind=pk.FigKind.nkText, screen_box=pk.rect(10, 32, 280, 22),
        text_layout=lay.typeset(pk.vec2(280, 22),
                                [(f2, pk.fill(pk.rgba(180, 30, 30, 255)), "sel שלום ok")]),
        flags=pk.FigFlags.NfSelectText, selection_range=(1, 6),
        fill=pk.fill(pk.rgba(90, 150, 255, 120))))
    f3 = tf.FigFont(typeface_id=tid, size=14.0, strikethrough=True)
    grad = pk.linear(pk.rgba(200, 40, 40, 255), pk.rgba(40, 40, 200, 255))
    renders.add_root(0, pk.Fig(kind=pk.FigKind.nkText, screen_box=pk.rect(12.6, 58, 280, 22),
                               text_layout=lay.typeset(pk.vec2(280, 22), [
                                   (f2, ink, "plain "), (f3, grad, "struck gradient")])))
    renders.add_root(0, pk.Fig(kind=pk.FigKind.nkText, screen_box=pk.rect(10, 84, 280, 22),
                               text_layout=lay.typeset(pk.vec2(280, 22), [(f2, ink, "inverted")]),
                               flags=pk.FigFlags.NfInvertY))
    return renders, (w, h)


SWITCHES = {
    "default": {},
    "subpixel": {"FIGDRAW_TEXT_SUBPIXEL_POSITIONING": "1"},
    "variants_lcd": {"FIGDRAW_TEXT_SUBPIXEL_POSITIONING": "1",
                     "FIGDRAW_TEXT_SUBPIXEL_GLYPH_VARIANTS": "1",
                     "FIGDRAW_TEXT_LCD_FILTERING": "1"},
}


def _set_switches(monkeypatch, name):
    for var in ("FIGDRAW_TEXT_LCD_FILTERING", "FIGDRAW_TEXT_LCD_FILTER",
                "FIGDRAW_TEXT_SUBPIXEL_POSITIONING", "FIGDRAW_TEXT_SUBPIXEL_GLYPH_VARIANTS"):
        monkeypatch.delenv(var, raising=False)
    for var, value in SWITCHES[name].items():
        monkeypatch.setenv(var, value)


@pytest.mark.parametrize("switches", list(SWITCHES))
def test_text_array_walks_and_frames_equal_the_jax_packages(monkeypatch, switches):
    """The text scene as a RendersArray: both native walks pack the same
    combo and both renderers the same atlas, byte for byte; the frames
    agree within 1/255, and the port's tree walk of to_renders(arr) gives
    the native walk's combo byte for byte on a renderer whose atlas the
    native walk warmed."""
    _set_switches(monkeypatch, switches)
    jtree, (w, h) = text_scene(jax_pkg)
    ptree, _ = text_scene(port)
    jarr = jax_from_renders(jtree)
    parr = port.from_renders(ptree)
    jren = JaxRenderer(atlas_size=256, use_pallas=False)
    pren = port.FigRenderer(atlas_size=256, device="cpu")
    assert pren._text_config() == jren._text_config()
    jtape = jren.flatten(jarr, jax_pkg.vec2(w, h))
    ptape = pren.flatten(parr, port.vec2(w, h))
    assert ptape.count == jtape.count > 40
    assert np.array_equal(np.asarray(ptape.combo).view(np.uint32),
                          np.asarray(jtape.combo).view(np.uint32))
    assert np.array_equal(pren.atlas.data, jren.atlas.data)
    want = np.asarray(jren.render_frame(jarr, jax_pkg.vec2(w, h)))
    got = pren.render_frame(parr, port.vec2(w, h)).numpy()
    assert np.abs(got - want).max() <= TOL
    # the Python walk on the warmed renderer: the native walk's bytes
    walked = pren.flatten(port.to_renders(parr), port.vec2(w, h))
    pack_walked_tape(walked)
    assert np.array_equal(walked.combo.view(np.uint32), ptape.combo.view(np.uint32))
    assert torch.equal(pren.render_frame(port.to_renders(parr), port.vec2(w, h)),
                       pren.render_frame(parr, port.vec2(w, h)))


def test_text_tree_frames_equal_the_jax_packages():
    """The tree through both Python walks (the glyphs rasterized as the walk
    meets them): frames within 1/255, and both atlases hold the same glyph
    keys."""
    jtree, (w, h) = text_scene(jax_pkg)
    ptree, _ = text_scene(port)
    jren = JaxRenderer(atlas_size=256, use_pallas=False)
    pren = port.FigRenderer(atlas_size=256, device="cpu")
    want = np.asarray(jren.render_frame(jtree, jax_pkg.vec2(w, h)))
    got = pren.render_frame(ptree, port.vec2(w, h)).numpy()
    assert np.abs(got - want).max() <= TOL
    assert (got[..., :3] < 0.5).any()
    assert set(pren.atlas.entries) == set(jren.atlas.entries)
    assert pren._glyph_offsets == jren._glyph_offsets


def test_place_glyphs_and_measurement_equal_the_jax_packages():
    results = []
    for pk, tf_mod, lay in ((jax_pkg, jax_tf, jax_layout), (port, port_tf, port_layout)):
        font = tf_mod.FigFont(typeface_id=tf_mod.load_typeface(DEJAVU), size=20.0)
        ink = pk.fill(pk.rgba(0, 0, 0, 255))
        cells = [("A", pk.vec2(0, 0)), ("B", pk.vec2(24, 0)), ("C", pk.vec2(48, 10))]
        out = []
        for origin in (lay.GlyphOrigin.TopLeft, lay.GlyphOrigin.Baseline):
            arr = lay.place_glyphs(font, ink, cells, origin=origin)
            out.append([(g.glyph_id, g.pos.x, g.pos.y, g.rect.x, g.rect.y, g.rect.w,
                         g.rect.h) for g in arr.arranged_glyphs])
        m = lay.typeset_for_measurement([(font, ink, "hello wide world")],
                                        bounds=pk.vec2(60, 200))
        out.append((m.lines, m.min_size.x, m.min_size.y, m.max_size.x, m.max_size.y))
        results.append(out)
    assert results[1] == results[0]
