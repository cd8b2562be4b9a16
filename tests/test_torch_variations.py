"""figdraw_tpu_torch's variable-font instancing (text/varstore.py,
text/gvar.py, CFF2 blends in text/cff.py, through text/otf.py and
text/typefaces.py) against figdraw_tpu, which instances faces through
fontTools 4.61.1's getGlyphSet(location=...), and the committed FigPort
Sans faces with their stored references.

- The faces: tools/make_port_faces.py regenerates the seven committed faces
  (CFF, glyf and CFF2 variable, the glyf one as WOFF, and with VARC, the
  glyf one and the CFF one as WOFF2) byte for byte; their names carry
  neither "Bitstream" nor "Vera"; fonts/README.md gives each file's sha256.
  figdraw_tpu reads the WOFF2 faces through tools/brotli_shim.py, installed
  for each test (`_brotli`).
- Normalization: fvar clamping, avar 1 (the wdth knee) and avar 2 (a face
  built with axis mappings, including a location that normalizes to
  nothing) equal TTFont.normalizeLocation.
- Outlines and advances: on a grid of locations (defaults, each master,
  the avar knee, intermediate points, values out of range, a tag of no
  axis), every glyph's glyph_path and var_advance equal figdraw_tpu's for
  the gvar+HVAR face (FigPortSans-VF.ttf), a gvar-only face (the same
  without HVAR: composites and intermediate regions, advances from hmtx
  as figdraw_tpu's undrawn glyph gives them) and the CFF2 face; the gvar
  face's phantom advances equal fontTools' drawn glyph widths.
- Downstream: typeset arrangements and rasterize_glyph bitmaps equal
  figdraw_tpu's at those locations; bench_text's scene and the text table
  from each face give figdraw_tpu's packed combo and atlas byte for byte;
  instance packs equal figdraw_tpu's.
- The stored references (reference/fonts.json, font_*_blocks8.npy) are
  fresh: figdraw_tpu's outline and pack digests, and the port's combos and
  atlases under PYTHONHASHSEED=0 (a variation's font id hashes its axis
  tags, and the glyphs of an array scene pack in font-id order, so the
  atlas of a variable face's scene is reproducible only under a fixed hash
  seed; chip_smoke.py runs under 0, as the references were written).
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from fontTools.pens.recordingPen import DecomposingRecordingPen
from fontTools.ttLib import TTFont

from figdraw_tpu.text import layout as jax_layout
from figdraw_tpu.text import native_pack as jax_pack
from figdraw_tpu.text import raster as jax_raster
from figdraw_tpu.text import typefaces as jax_tf
from figdraw_tpu_torch import scenes
from figdraw_tpu_torch.text import layout as port_layout
from figdraw_tpu_torch.text import native_pack as port_pack
from figdraw_tpu_torch.text import raster as port_raster
from figdraw_tpu_torch.text import typefaces as port_tf
from torch_reference import (
    REPO, jax_font_table_plan, jax_font_text_plan, jax_variations, port_variations,
)

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(REPO, "tools"))
import brotli_shim  # noqa: E402
import make_port_faces  # noqa: E402

VF_TTF = port_tf.bundled_font_path("FigPortSans-VF.ttf")
VF_OTF = port_tf.bundled_font_path("FigPortSans-VF.otf")
CFF_OTF = port_tf.bundled_font_path("FigPortSans-CFF.otf")

# locations: defaults, masters, the avar knee (wdth 90), intermediate
# points, values out of range, a tag of no axis
GRID = [
    (), (("wdth", 100.0),), (("wdth", 75.0),), (("wdth", 90.0),), (("wdth", 80.0),),
    (("wdth", 112.5),), (("wdth", 118.0),), (("wdth", 125.0),), (("wdth", 140.0),),
    (("wdth", 50.0),), (("slnt", -12.0),), (("slnt", -6.0),), (("slnt", 4.0),),
    (("wdth", 90.0), ("slnt", -6.0)), (("wdth", 125.0), ("slnt", -12.0)),
    (("wght", 700.0),),
]


@pytest.fixture(autouse=True)
def _brotli(monkeypatch):
    """fontTools' WOFF2 reader through tools/brotli_shim.py, for this test
    only."""
    from fontTools.ttLib import woff2

    monkeypatch.setattr(woff2, "brotli", brotli_shim, raising=False)
    monkeypatch.setattr(woff2, "haveBrotli", True)


def _loc_id(loc):
    return scenes.font_case_key("", loc).lstrip("@") or "default"


@pytest.fixture(scope="module")
def gvar_only(tmp_path_factory):
    """FigPortSans-VF.ttf without HVAR: advances from gvar's phantom points
    (fontTools sets them on a drawn glyph), composites, intermediate
    regions."""
    tt = TTFont(VF_TTF)
    del tt["HVAR"]
    path = str(tmp_path_factory.mktemp("gvar") / "FigPortSans-gvar.ttf")
    tt.save(path)
    return path


def _faces(gvar_only):
    return {"gvar_hvar": VF_TTF, "gvar_only": gvar_only, "cff2": VF_OTF}


# --- the committed faces ----------------------------------------------------------------


def test_generator_rewrites_the_committed_faces_byte_for_byte():
    made = make_port_faces.faces()
    assert sorted(made) == sorted(scenes.FONT_FACES)
    for name, data in made.items():
        with open(port_tf.bundled_font_path(name), "rb") as fh:
            assert fh.read() == data, name


@pytest.mark.parametrize("face", scenes.FONT_FACES)
def test_committed_face_names_and_readme(face):
    path = port_tf.bundled_font_path(face)
    with open(path, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()
    with open(os.path.join(os.path.dirname(path), "README.md")) as fh:
        readme = fh.read()
    assert f"{face}:" in readme and digest in readme
    tt = TTFont(path)
    for rec in tt["name"].names:
        text = rec.toUnicode()
        assert "Bitstream" not in text and "Vera" not in text, (rec.nameID, text)
    assert tt["name"].getDebugName(1) == "FigPort Sans"
    with open(scenes.FONTS_REFERENCE) as fh:
        assert json.load(fh)["faces"][face]["sha256"] == digest


def test_committed_faces_hold_the_tables_they_stand_for():
    ttf, otf = TTFont(VF_TTF), TTFont(VF_OTF)
    for tag in ("gvar", "HVAR", "avar", "fvar", "STAT", "glyf"):
        assert tag in ttf, tag
    for tag in ("CFF2", "HVAR", "avar", "fvar"):
        assert tag in otf, tag
    assert "CFF " in TTFont(CFF_OTF) and "fvar" not in TTFont(CFF_OTF)
    # composites, and a region with an intermediate peak (the wdth 112.5 master)
    assert sum(ttf["glyf"][n].isComposite() for n in ttf.getGlyphOrder()) > 100
    regions = {tuple(sorted(v.axes.items())) for n in ttf.getGlyphOrder()
               for v in ttf["gvar"].variations[n]}
    assert (("wdth", (0.0, 0.5, 1.0)),) in regions
    assert ttf["avar"].segments["wdth"][-0.4000244140625] == -0.5999755859375


# --- normalization ------------------------------------------------------------------------


def _build_avar2_face(path):
    """A wght/opsz face whose avar 2 maps (900, 72) to (600, 72) and
    (700, 12) to (800, 12)."""
    from fontTools import varLib
    from fontTools.designspaceLib import (
        AxisDescriptor, AxisMappingDescriptor, DesignSpaceDocument, SourceDescriptor,
    )
    from fontTools.fontBuilder import FontBuilder
    from fontTools.pens.ttGlyphPen import TTGlyphPen

    def master(width, height):
        fb = FontBuilder(1000, isTTF=True)
        fb.setupGlyphOrder([".notdef", "A"])
        fb.setupCharacterMap({65: "A"})
        pen = TTGlyphPen(None)
        pen.moveTo((50, 0)); pen.lineTo((width, 0))
        pen.lineTo((width, height)); pen.lineTo((50, height)); pen.closePath()
        fb.setupGlyf({".notdef": TTGlyphPen(None).glyph(), "A": pen.glyph()})
        fb.setupHorizontalMetrics({".notdef": (300, 0), "A": (width + 100, 50)})
        fb.setupHorizontalHeader(ascent=800, descent=-200)
        fb.setupNameTable({"familyName": "Avar2", "styleName": "Regular"})
        fb.setupOS2(sTypoAscender=800, sTypoDescender=-200)
        fb.setupPost()
        return fb.font

    ds = DesignSpaceDocument()
    for tag, name, triple in (("wght", "Weight", (100, 400, 900)),
                              ("opsz", "Optical", (8, 12, 72))):
        ax = AxisDescriptor()
        ax.tag, ax.name = tag, name
        ax.minimum, ax.default, ax.maximum = triple
        ds.addAxis(ax)
    ds.axisMappings = [
        AxisMappingDescriptor(inputLocation={"Weight": 900, "Optical": 72},
                              outputLocation={"Weight": 600, "Optical": 72}),
        AxisMappingDescriptor(inputLocation={"Weight": 700, "Optical": 12},
                              outputLocation={"Weight": 800, "Optical": 12})]
    for (w, o), (width, height) in (((400, 12), (400, 700)), ((100, 12), (300, 700)),
                                    ((900, 12), (800, 700)), ((400, 72), (400, 900)),
                                    ((400, 8), (400, 600))):
        src = SourceDescriptor()
        src.font = master(width, height)
        src.location = {"Weight": w, "Optical": o}
        if (w, o) == (400, 12):
            src.copyLib = src.copyInfo = True
        ds.addSource(src)
    vf, _, _ = varLib.build(ds)
    vf.save(path)


AVAR2_GRID = [{"wght": 900, "opsz": 72}, {"wght": 700}, {"wght": 400}, {},
              {"wght": 650, "opsz": 40}, {"wght": 100, "opsz": 8}, {"wght": 2000},
              {"opsz": 30.5, "xxxx": 3}]


def test_avar2_normalization_and_instances_as_fonttools(tmp_path):
    path = str(tmp_path / "avar2.ttf")
    _build_avar2_face(path)
    tt = TTFont(path)
    assert tt["avar"].majorVersion == 2
    with open(path, "rb") as fh:
        ours = port_tf.Typeface(path, fh.read(), 0)._tt
    jtf = jax_tf.get_typeface(jax_tf.load_typeface(path))
    ptf = port_tf.get_typeface(port_tf.load_typeface(path))
    a = ptf.glyph_id(65)
    for loc in AVAR2_GRID:
        assert ours.normalize_location(loc) == tt.normalizeLocation(loc), loc
        items = tuple(loc.items())
        assert ptf.glyph_path(a, port_variations(items)) == jtf.glyph_path(
            a, jax_variations(items)), loc
        assert ptf.var_advance(a, port_variations(items)) == jtf.var_advance(
            a, jax_variations(items)), loc
    assert ours.normalize_location({"wght": 400}) == {}  # the default glyph set


@pytest.mark.parametrize("path", [VF_TTF, VF_OTF], ids=["ttf", "otf"])
def test_avar1_normalization_as_fonttools(path):
    tt = TTFont(path)
    with open(path, "rb") as fh:
        ours = port_tf.Typeface(path, fh.read(), 0)._tt
    for loc in GRID[1:]:
        assert ours.normalize_location(dict(loc)) == tt.normalizeLocation(dict(loc)), loc
    assert -0.6 < ours.normalize_location({"wdth": 90.0})["wdth"] < -0.59  # avar's knee


# --- outlines and advances on the grid ------------------------------------------------------


@pytest.mark.parametrize("loc", GRID, ids=[_loc_id(g) for g in GRID])
@pytest.mark.parametrize("face", ["gvar_hvar", "gvar_only", "cff2"])
def test_outlines_and_advances_equal_figdraw_tpu(gvar_only, face, loc):
    path = _faces(gvar_only)[face]
    jtf = jax_tf.get_typeface(jax_tf.load_typeface(path))
    ptf = port_tf.get_typeface(port_tf.load_typeface(path))
    assert ptf._glyph_order == jtf._glyph_order
    jv, pv = jax_variations(loc), port_variations(loc)
    for gid in range(len(jtf._glyph_order)):
        assert ptf.glyph_path(gid, pv) == jtf.glyph_path(gid, jv), gid
        assert ptf.var_advance(gid, pv) == jtf.var_advance(gid, jv), gid


@pytest.mark.parametrize("loc", [(("wdth", 75.0),), (("wdth", 118.0), ("slnt", -3.0))],
                         ids=["wdth75", "wdth118_slnt-3"])
def test_phantom_advances_equal_fonttools_drawn_widths(gvar_only, loc):
    """Without HVAR fontTools sets a glyph's width from its moved phantom
    points when it draws the glyph (figdraw_tpu's var_advance reads an
    undrawn glyph, so it keeps hmtx's): the port's phantom_advance is the
    drawn width."""
    tt = TTFont(gvar_only)
    gs = tt.getGlyphSet(location=dict(loc))
    ptf = port_tf.get_typeface(port_tf.load_typeface(gvar_only))
    norm = ptf._location(port_variations(loc))
    differ = 0
    for gid, name in enumerate(tt.getGlyphOrder()):
        glyph = gs[name]
        before = glyph.width
        glyph.draw(DecomposingRecordingPen(gs))
        assert ptf._tt.phantom_advance(gid, norm) == glyph.width, name
        assert ptf.var_advance(gid, port_variations(loc)) == before, name
        differ += glyph.width != before
    assert differ > 100


def test_a_face_without_fvar_ignores_variations():
    tf = port_tf.get_typeface(port_tf.load_typeface(CFF_OTF))
    a = tf.glyph_id(ord("A"))
    vs = port_variations((("wdth", 75.0),))
    assert tf.glyph_path(a, vs) == tf.glyph_path(a)
    assert tf.var_advance(a, vs) == tf.advance(a)


# --- downstream: typeset, raster, scenes, packs ----------------------------------------------

TEXT = "Variable Office fifi AVATAR Ångström Łódź 0123"
DOWNSTREAM = [(VF_TTF, (("wdth", 75.0),)), (VF_TTF, (("wdth", 118.0), ("slnt", -12.0))),
              (VF_OTF, (("wdth", 90.0),)), (VF_OTF, (("wdth", 125.0), ("slnt", -6.0))),
              (CFF_OTF, ())]
DOWNSTREAM_IDS = [scenes.font_case_key(os.path.basename(p), loc) for p, loc in DOWNSTREAM]


def _arrangement(arr):
    return [(g.glyph_id, g.cluster, g.pos.x, g.pos.y, g.advance.x, g.advance.y,
             g.offset.x, g.offset.y, g.rect.x, g.rect.y, g.rect.w, g.rect.h,
             g.line_index) for g in arr.arranged_glyphs], list(arr.lines), (
        arr.bounding.x, arr.bounding.y, arr.bounding.w, arr.bounding.h)


@pytest.mark.parametrize("case", DOWNSTREAM, ids=DOWNSTREAM_IDS)
def test_typeset_and_raster_equal_figdraw_tpu(case):
    import figdraw_tpu as jp

    import figdraw_tpu_torch as pp

    path, loc = case
    jtid, ptid = jax_tf.load_typeface(path), port_tf.load_typeface(path)
    jf = jax_tf.FigFont(typeface_id=jtid, size=18.0, variations=jax_variations(loc))
    pf = port_tf.FigFont(typeface_id=ptid, size=18.0, variations=port_variations(loc))
    ja = jax_layout.typeset(jp.vec2(300, 200), [(jf, jp.fill(jp.rgba(0, 0, 0, 255)), TEXT)],
                            wrap=True)
    pa = port_layout.typeset(pp.vec2(300, 200), [(pf, pp.fill(pp.rgba(0, 0, 0, 255)), TEXT)],
                             wrap=True)
    assert _arrangement(pa) == _arrangement(ja)
    jtf, ptf = jax_tf.get_typeface(jtid), port_tf.get_typeface(ptid)
    for ch in "AVOfgQŁ":
        gid = ptf.glyph_id(ord(ch))
        for size, shift in ((18.0, 0.0), (41.5, 0.3)):
            want = jax_raster.rasterize_glyph(jtf, gid, size, shift,
                                              variations=jax_variations(loc))
            got = port_raster.rasterize_glyph(ptf, gid, size, shift,
                                              variations=port_variations(loc))
            assert (got is None) == (want is None)
            assert np.array_equal(got[0], want[0]) and got[1] == want[1], ch


@pytest.mark.parametrize("case", scenes.FONT_TEXT_CASES,
                         ids=[scenes.font_case_key(*c) for c in scenes.FONT_TEXT_CASES])
def test_bench_text_scene_equals_figdraw_tpu(case):
    """bench_text's 36 lines at 1200x800 from a committed face at a location:
    the port's packed combo and atlas are figdraw_tpu's byte for byte (both
    packages in one process share the hash seed the atlas order follows)."""
    from figdraw_tpu_torch import Color, FigRenderer, fill, rgba, vec2

    face, loc = case
    path = port_tf.bundled_font_path(face)
    line = scenes.font_text(face)[0]
    combo, atlas, _ = jax_font_text_plan(path, loc, text=line)
    tid = port_tf.load_typeface(path)
    scene, n = scenes.make_text_scene(tid, fill(rgba(20, 20, 30, 255)), 0,
                                      variations=port_variations(loc), text=line)
    ren = FigRenderer(atlas_size=512, device="cpu")
    ren._ensure_packed_glyphs(scene)
    plan = ren._walk_plan(scene, vec2(1200, 800), True, Color(1.0, 1.0, 1.0, 1.0))
    assert n > 2000
    assert np.array_equal(plan.combo.view(np.uint32), combo.view(np.uint32))
    assert np.array_equal(ren.atlas.data, atlas)


def test_text_table_equals_figdraw_tpu():
    """The text table of the CFF2 face at a location away from the default
    (its rows cut to 30 here): the port's walked tape is figdraw_tpu's plan
    byte for byte but the sign of zero, its atlas byte for byte, and it
    plans to the megakernel with the atlas."""
    from figdraw_tpu_torch import FigRenderer, vec2
    from figdraw_tpu_torch.plan import pack_walked_tape, plan_execution

    face, loc = scenes.FONT_TABLE_CASE
    path = port_tf.bundled_font_path(face)
    rows = 30
    combo, atlas, _ = jax_font_table_plan(path, loc, rows=rows)
    tid = port_tf.load_typeface(path)
    tree = scenes.make_text_table_scene(rows, 6, 1200.0, 800.0, tid=tid,
                                        variations=port_variations(loc))
    ren = FigRenderer(atlas_size=512, device="cpu")
    tape = ren.flatten(tree, vec2(1200, 800))
    pack_walked_tape(tape)
    assert scenes.array_digest(tape.combo, zero_sign=True) == scenes.array_digest(
        combo, zero_sign=True)
    assert np.array_equal(ren.atlas.data, atlas)
    assert plan_execution(tape).mega_atlas


@pytest.mark.parametrize("case", scenes.FONT_PACK_CASES,
                         ids=[scenes.font_case_key(*c) for c in scenes.FONT_PACK_CASES])
def test_instance_pack_equals_figdraw_tpu(case):
    face, loc = case
    path = port_tf.bundled_font_path(face)
    got = port_pack.build_font_pack(port_tf.load_typeface(path), port_variations(loc))
    want = jax_pack.build_font_pack(jax_tf.load_typeface(path), jax_variations(loc))
    assert got == want
    assert got != port_pack.build_font_pack(port_tf.load_typeface(path))
    with open(scenes.FONTS_REFERENCE) as fh:
        stored = json.load(fh)["packs"][scenes.font_case_key(face, loc)]
    assert hashlib.sha256(got).hexdigest() == stored


@pytest.mark.parametrize("face", scenes.FONT_FACES)
def test_typeface_info_equals_figdraw_tpu(face):
    from figdraw_tpu.text import typeface_info as jax_info
    from figdraw_tpu_torch.text import typeface_info as port_info

    path = port_tf.bundled_font_path(face)
    want = jax_info.get_typeface_info(jax_tf.load_typeface(path))
    got = port_info.get_typeface_info(port_tf.load_typeface(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [a.tag for a in got.variation_axes] == (
        [] if face.startswith("FigPortSans-CFF") else ["wdth", "slnt"])


# --- the stored references ------------------------------------------------------------------


@pytest.mark.parametrize("face", scenes.FONT_FACES)
def test_stored_outline_digests_are_figdraw_tpus(face):
    with open(scenes.FONTS_REFERENCE) as fh:
        stored = json.load(fh)["faces"][face]["outlines"]
    jtf = jax_tf.get_typeface(jax_tf.load_typeface(port_tf.bundled_font_path(face)))
    ptf = port_tf.get_typeface(port_tf.load_typeface(port_tf.bundled_font_path(face)))
    for loc in scenes.FONT_LOCATIONS:
        key = scenes.font_case_key(face, loc)
        want = (stored[key]["paths"], stored[key]["advances"])
        assert scenes.outline_digests(jtf, jax_variations(loc)) == want, key
        assert scenes.outline_digests(ptf, port_variations(loc)) == want, key


_SEEDED_CHECK = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
from figdraw_tpu_torch import Color, FigRenderer, fill, rgba, vec2, scenes
from figdraw_tpu_torch.plan import pack_walked_tape
from figdraw_tpu_torch.text.typefaces import FontVariation, bundled_font_path, load_typeface
refs = json.load(open(scenes.FONTS_REFERENCE))
out = {}
for face, loc in scenes.FONT_TEXT_CASES:
    tid = load_typeface(bundled_font_path(face))
    scene, _ = scenes.make_text_scene(tid, fill(rgba(20, 20, 30, 255)), 0,
        variations=tuple(FontVariation(t, v) for t, v in loc),
        text=scenes.font_text(face)[0])
    ren = FigRenderer(atlas_size=512, device="cpu")
    ren._ensure_packed_glyphs(scene)
    plan = ren._walk_plan(scene, vec2(1200, 800), True, Color(1.0, 1.0, 1.0, 1.0))
    want = refs["text"][scenes.font_case_key(face, loc)]
    out[scenes.font_case_key(face, loc)] = [
        scenes.array_digest(plan.combo) == want["combo"],
        scenes.array_digest(ren.atlas.data) == want["atlas"]]
for face, loc in scenes.FONT_TABLE_CASES:
    tid = load_typeface(bundled_font_path(face))
    tree = scenes.make_text_table_scene(180, 6, 1200.0, 800.0, tid=tid,
        variations=tuple(FontVariation(t, v) for t, v in loc),
        text=scenes.font_text(face)[1])
    ren = FigRenderer(atlas_size=512, device="cpu")
    tape = ren.flatten(tree, vec2(1200, 800))
    pack_walked_tape(tape)
    want = refs["table"][scenes.font_case_key(face, loc)]
    out["table " + scenes.font_case_key(face, loc)] = [
        scenes.array_digest(tape.combo, zero_sign=True) == want["combo"],
        scenes.array_digest(ren.atlas.data) == want["atlas"]]
print(json.dumps(out))
"""


def test_stored_scene_digests_under_the_fixed_hash_seed():
    """The port's bench_text scenes and full-size text tables (the CFF2
    face's, the VARC face's and the WOFF2 VF face's), built as
    chip_smoke.py builds them under PYTHONHASHSEED=0, against fonts.json."""
    env = dict(os.environ, PYTHONHASHSEED="0")
    res = subprocess.run([sys.executable, "-c", _SEEDED_CHECK, REPO], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(got) == len(scenes.FONT_TEXT_CASES) + len(scenes.FONT_TABLE_CASES)
    assert all(all(v) for v in got.values()), got


def test_stored_blocks_match_the_ports_frame():
    """The CFF face's bench_text frame rendered by the port on the CPU
    against figdraw_tpu's stored block means (the frame chip_smoke.py holds
    the card's to)."""
    from figdraw_tpu_torch import FigRenderer, fill, rgba, vec2
    from torch_reference import block_means

    face, loc = scenes.FONT_TEXT_CASES[0]
    tid = port_tf.load_typeface(port_tf.bundled_font_path(face))
    scene, _ = scenes.make_text_scene(tid, fill(rgba(20, 20, 30, 255)), 0)
    frame = FigRenderer(atlas_size=512, device="cpu").render_frame(
        scene, vec2(1200, 800)).numpy()
    blocks = np.load(scenes.font_blocks_path(scenes.font_case_key(face, loc)))
    assert np.abs(block_means(frame) - blocks).max() <= 1.0 / 255.0
