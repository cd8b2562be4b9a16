"""figdraw_tpu_torch's VARC table (text/varc.py, the MultiVarStore of
text/varstore.py, through text/otf.py) against figdraw_tpu, which draws a
VARC face's glyphs through fontTools 4.61.1's _TTGlyphSetVARC and
DecomposingRecordingPen.

- The committed FigPortSans-VARC.ttf (tools/make_port_faces.py; the
  generator's test in test_torch_variations.py rewrites it byte for byte):
  fontTools reads back every VarComponentFlags bit but GID_IS_24BIT, every
  condition format 1-5, a reset component, a component naming its own
  glyph and a VARC component inside a VARC glyph; the port decodes each
  component, condition and MultiVarStore delta as fontTools does.
- Every glyph at each of `scenes.FONT_LOCATIONS` and more equals
  figdraw_tpu's value list as numbers and as int or float; a glyph outside
  Coverage draws as the face without VARC draws it.
- A hand-packed component with a 24-bit glyph id and a reserved flag bit
  decodes as fontTools decodes it.
- A condition of format 5 that is evaluated: fontTools raises
  AttributeError (its _evaluateCondition reads an attribute the decoded
  table lacks), the port NotImplementedError; the face's other glyphs
  still draw equal.
- VARC over CFF2 outlines: fontTools' CFF glyph set keeps the last VARC
  component's blend location, so a plain glyph drawn after a VARC glyph
  changes; the port refuses VARC glyphs over CFF outlines.
- The text table from the VARC face (rows cut to 30) equals figdraw_tpu's
  tape and atlas; bench_text's scene from it is held in
  test_torch_variations.py (scenes.FONT_TEXT_CASES), and the stored
  references are checked fresh there.
"""

import io
import os
import struct
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from fontTools.pens.recordingPen import DecomposingRecordingPen
from fontTools.ttLib import TTFont
from fontTools.ttLib.tables import otTables as ot
from fontTools.ttLib.ttGlyphSet import _evaluateCondition
from fontTools.varLib.multiVarStore import MultiVarStoreInstancer

from figdraw_tpu.text import typefaces as jax_tf
from figdraw_tpu_torch import scenes
from figdraw_tpu_torch.text import typefaces as port_tf
from figdraw_tpu_torch.text import varc
from figdraw_tpu_torch.text.otf import OTFont
from torch_reference import REPO, jax_font_table_plan, jax_variations, port_variations

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(REPO, "tools"))
import make_port_faces  # noqa: E402

VARC_TTF = port_tf.bundled_font_path("FigPortSans-VARC.ttf")
VF_TTF = port_tf.bundled_font_path("FigPortSans-VF.ttf")
VF_OTF = port_tf.bundled_font_path("FigPortSans-VF.otf")
LOCATIONS = list(scenes.FONT_LOCATIONS) + [(("wdth", 112.5), ("slnt", -6.0)),
                                           (("wdth", 118.0), ("slnt", -3.0)),
                                           (("wdth", 80.0),)]


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _loc_id(loc):
    return scenes.font_case_key("", loc).lstrip("@") or "default"


def _types(value):
    return [type(v) for _op, pts in value for pt in pts if pt is not None for v in pt]


@pytest.fixture(scope="module")
def faces():
    """(figdraw_tpu's typeface of the VARC face, the port's)."""
    return (jax_tf.get_typeface(jax_tf.load_typeface(VARC_TTF)),
            port_tf.get_typeface(port_tf.load_typeface(VARC_TTF)))


@pytest.fixture(scope="module")
def tables():
    """(fontTools' VARC table, the port's OTFont of the face)."""
    return TTFont(VARC_TTF)["VARC"].table, OTFont(_read(VARC_TTF))


# --- the face and its table ---------------------------------------------------------


def test_face_holds_every_case(tables):
    cases = make_port_faces.check_varc_face(_read(VARC_TTF))
    assert cases["coverage"] == 166
    assert cases["own"] == ["Ecircumflex"] and cases["nested"] == ["Eacute"]
    table, font = tables
    ours = font.varc()
    flags = 0
    for gid in ours.coverage:
        for c in ours.components(gid):
            flags |= c.flags
    assert flags == cases["flags"]

    def formats(c, out):
        out.add(c.Format)
        for sub in (c.ConditionTable if c.Format in (3, 4)
                    else [c.ConditionTable] if c.Format == 5 else []):
            formats(sub, out)
        return out

    got = set()
    for c in ours.conditions:
        formats(c, got)
    assert got == set(cases["condition_formats"]) == {1, 2, 3, 4, 5}


def test_components_decode_as_fonttools(tables):
    table, font = tables
    ours = font.varc()
    order = font.glyph_order
    assert [order[g] for g, _i in sorted(ours.coverage.items(), key=lambda kv: kv[1])] == \
        table.Coverage.glyphs
    for name, glyph in zip(table.Coverage.glyphs, table.VarCompositeGlyphs.VarCompositeGlyph):
        comps = ours.components(order.index(name))
        assert len(comps) == len(glyph.components), name
        for c, want in zip(comps, glyph.components):
            assert order[c.gid] == want.glyphName
            for attr in ("flags", "conditionIndex", "axisIndicesIndex", "axisValues",
                         "axisValuesVarIndex", "transformVarIndex"):
                assert getattr(c, attr) == getattr(want, attr), (name, attr)
            for field, *_rest in varc.TRANSFORM_FIELDS:
                assert c.transform[field] == getattr(want.transform, field), (name, field)
    assert ours.axis_lists == [list(a) for a in table.AxisIndicesList.Item]


@pytest.mark.parametrize("loc", LOCATIONS, ids=[_loc_id(g) for g in LOCATIONS])
def test_store_and_conditions_equal_fonttools(tables, loc):
    """MultiVarStoreInstancer's vectors for every index the table uses, and
    _evaluateCondition of every condition, at a normalized location."""
    table, font = tables
    tt = TTFont(VARC_TTF)
    norm = tt.normalizeLocation(dict(loc)) if loc else {}
    axes = tt["fvar"].axes
    want_inst = MultiVarStoreInstancer(table.MultiVarStore, axes, norm)
    ours = font.varc()
    inst = ours.instancer(norm)
    indices = {c.axisValuesVarIndex for g in table.VarCompositeGlyphs.VarCompositeGlyph
               for c in g.components} | {c.transformVarIndex for g in
                                         table.VarCompositeGlyphs.VarCompositeGlyph
                                         for c in g.components}
    assert len(indices) > 10
    for idx in indices:
        want = list(want_inst[idx])
        got = inst[idx]
        assert got == want and [type(v) for v in got] == [type(v) for v in want], idx
    tags = [a.axisTag for a in axes]
    for c, want in zip(ours.conditions, table.ConditionList.ConditionTable):
        if want.Format == 4 and want.ConditionTable[-1].Format == 5:
            # fontTools raises past its first operand, which always holds
            assert want.ConditionTable[0].Format == 1
        assert varc.evaluate_condition(c, tags, norm, inst) == _evaluateCondition(
            want, axes, norm, want_inst)


# --- outlines -------------------------------------------------------------------------------


@pytest.mark.parametrize("loc", LOCATIONS, ids=[_loc_id(g) for g in LOCATIONS])
def test_every_glyph_equals_figdraw_tpu(faces, loc):
    """Every glyph (the 166 variable composites among them) at a location:
    figdraw_tpu's DecomposingRecordingPen value list, numbers and types."""
    jtf, ptf = faces
    jv, pv = jax_variations(loc), port_variations(loc)
    n_varc = 0
    cover = ptf._tt.varc().coverage
    for gid in range(len(ptf._glyph_order)):
        got = ptf.glyph_path(gid, pv)
        want = jtf.glyph_path(gid, jv)
        assert got == want and _types(got) == _types(want), ptf.glyph_name(gid)
        assert ptf.var_advance(gid, pv) == jtf.var_advance(gid, jv)
        n_varc += gid in cover and bool(got)
    assert n_varc == 166


def test_a_glyph_outside_coverage_draws_as_without_varc(faces):
    _jtf, ptf = faces
    plain = port_tf.get_typeface(port_tf.load_typeface(VF_TTF))
    cover = ptf._tt.varc().coverage
    for loc in ((), (("wdth", 75.0), ("slnt", -12.0))):
        pv = port_variations(loc)
        for gid in range(len(ptf._glyph_order)):
            if gid not in cover:
                assert ptf.glyph_path(gid, pv) == plain.glyph_path(gid, pv)
    agrave = ptf._name_to_gid["Agrave"]
    assert ptf.glyph_path(agrave) != plain.glyph_path(agrave)


def test_a_24_bit_glyph_id_and_a_reserved_flag_decode_as_fonttools():
    """A record fontTools' compiler writes only past glyph 65535, packed by
    hand: GID_IS_24BIT, axes with a variation index, a condition, every
    transform field, and a reserved flag bit whose uint32var is skipped."""
    from fontTools.ttLib.tables.otTables import VarComponent, _write_uint32var

    flags = (varc.GID_IS_24BIT | varc.HAVE_AXES | varc.AXIS_VALUES_HAVE_VARIATION
             | varc.TRANSFORM_HAS_VARIATION | varc.HAVE_CONDITION | varc.RESET_UNSPECIFIED_AXES
             | (1 << 15) | sum(f for _n, f, *_r in varc.TRANSFORM_FIELDS))
    record = (_write_uint32var(flags) + (70001).to_bytes(3, "big") + _write_uint32var(3)
              + _write_uint32var(0) + bytes([0x41]) + struct.pack(">hh", -8192, 300)
              + _write_uint32var(0x10002) + _write_uint32var(0x20005)
              + struct.pack(">9h", 100, -50, 455, 900, -1100, 200, -300, 12, 34)
              + _write_uint32var(300))
    record = record + record  # two components
    names = ["glyph%05d" % i for i in range(70002)]
    font = SimpleNamespace(glyphOrder=names)
    local = {"AxisIndicesList": SimpleNamespace(Item=[[0, 1]])}
    want = []
    rest = record
    while rest:
        comp = VarComponent()
        rest = comp.decompile(rest, font, local)
        want.append(comp)
    got = varc.decode_components(record, 0, len(record), [[0, 1]], 70002)
    assert len(got) == len(want) == 2
    for c, w in zip(got, want):
        assert names[c.gid] == w.glyphName == "glyph70001"
        for attr in ("flags", "conditionIndex", "axisIndicesIndex", "axisValues",
                     "axisValuesVarIndex", "transformVarIndex"):
            assert getattr(c, attr) == getattr(w, attr), attr
        for field, *_rest in varc.TRANSFORM_FIELDS:
            assert c.transform[field] == getattr(w.transform, field), field


# --- what figdraw_tpu cannot draw -----------------------------------------------------------


@pytest.fixture(scope="module")
def negated_face(tmp_path_factory):
    """The VARC face with Adieresis' first mark under a lone format 5
    condition (the negation the face keeps behind an OR)."""
    tt = TTFont(VARC_TTF)
    table = tt["VARC"].table
    conds = table.ConditionList.ConditionTable
    negation = [c for c in conds if c.Format == 4][-1].ConditionTable[-1]
    assert negation.Format == 5
    conds.append(negation)
    table.ConditionList.ConditionCount = len(conds)
    idx = table.Coverage.glyphs.index("Adieresis")
    table.VarCompositeGlyphs.VarCompositeGlyph[idx].components[1].conditionIndex = len(conds) - 1
    path = str(tmp_path_factory.mktemp("varc") / "negated.ttf")
    tt.save(path)
    return path


def test_an_evaluated_negation_raises_in_both(negated_face):
    jtf = jax_tf.get_typeface(jax_tf.load_typeface(negated_face))
    ptf = port_tf.get_typeface(port_tf.load_typeface(negated_face))
    gid = ptf._name_to_gid["Adieresis"]
    with pytest.raises(AttributeError, match="conditionTable"):
        jtf.glyph_path(gid)
    with pytest.raises(NotImplementedError, match="format 5.*AttributeError"):
        ptf.glyph_path(gid)
    for name in ("A", "Agrave", "Eacute", "Ecircumflex", "ntilde"):
        g = ptf._name_to_gid[name]
        assert ptf.glyph_path(g) == jtf.glyph_path(g), name


def test_varc_over_cff2_is_order_dependent_in_fonttools_and_refused():
    tt = TTFont(VF_OTF)
    assert tt.getGlyphOrder() == TTFont(VARC_TTF).getGlyphOrder()
    tt["VARC"] = TTFont(VARC_TTF)["VARC"]
    buf = io.BytesIO()
    tt.save(buf)
    data = buf.getvalue()
    gs = TTFont(io.BytesIO(data)).getGlyphSet()

    def draw(name):
        pen = DecomposingRecordingPen(gs)
        gs[name].draw(pen)
        return pen.value

    before = draw("A")
    draw("Agrave")
    assert draw("A") != before
    ours = OTFont(data)
    gid = ours.glyph_order.index("A")
    assert ours.glyph_path(gid) == before
    with pytest.raises(NotImplementedError, match="CFF"):
        ours.glyph_path(ours.glyph_order.index("Agrave"))


# --- scenes ----------------------------------------------------------------------------------


def test_text_table_equals_figdraw_tpu():
    """The text table of the VARC face (its rows cut to 30): the port's
    walked tape is figdraw_tpu's plan but the sign of zero, its atlas byte
    for byte, and it plans to the megakernel with the atlas."""
    from figdraw_tpu_torch import FigRenderer, vec2
    from figdraw_tpu_torch.plan import pack_walked_tape, plan_execution

    face, loc = scenes.FONT_VARC_TABLE_CASE
    path = port_tf.bundled_font_path(face)
    rows, cell = 30, scenes.font_text(face)[1]
    combo, atlas, _ = jax_font_table_plan(path, loc, rows=rows, text=cell)
    tid = port_tf.load_typeface(path)
    tree = scenes.make_text_table_scene(rows, 6, 1200.0, 800.0, tid=tid,
                                        variations=port_variations(loc), text=cell)
    ren = FigRenderer(atlas_size=512, device="cpu")
    tape = ren.flatten(tree, vec2(1200, 800))
    pack_walked_tape(tape)
    assert scenes.array_digest(tape.combo, zero_sign=True) == scenes.array_digest(
        combo, zero_sign=True)
    assert np.array_equal(ren.atlas.data, atlas)
    assert plan_execution(tape).mega_atlas
