"""figdraw_tpu_torch's cmap subtables of formats 2 and 13 (text/otf.py)
against fontTools 4.61.1's getBestCmap, which figdraw_tpu reads, on faces
built here from FigPortSans-VF.ttf with fontTools:

- format 13 (many-to-one: a last-resort face) as the best subtable under
  (3, 10) and under (0, 6), and format 2 (the high-byte mapping) under
  (3, 1): the port's map equals getBestCmap() exactly, and a string shapes
  to figdraw_tpu's glyphs and positions;
- formats 8 and 10, packed by hand (fontTools writes neither): fontTools
  has no reader for them, so figdraw_tpu cannot load such a face, and the
  port refuses it too, saying so.
"""

import io
import struct

import pytest
import torch
from fontTools.ttLib import TTFont
from fontTools.ttLib.tables._c_m_a_p import CmapSubtable
from fontTools.ttLib.tables.DefaultTable import DefaultTable

import figdraw_tpu as jp
import figdraw_tpu_torch as pp
from figdraw_tpu.text import layout as jax_layout
from figdraw_tpu.text import typefaces as jax_tf
from figdraw_tpu_torch.text import layout as port_layout
from figdraw_tpu_torch.text import typefaces as port_tf
from figdraw_tpu_torch.text.otf import OTFont

torch.set_num_threads(1)

VF = port_tf.bundled_font_path("FigPortSans-VF.ttf")
TEXT = "Ýou ŋot Ŧhe ĦĨĴ: Ëxact ŵords, ŝomewhere 0123"


def _subtable(fmt, pid, eid, cmap):
    sub = CmapSubtable.newSubtable(fmt)
    sub.platformID, sub.platEncID, sub.language = pid, eid, 0
    sub.cmap = cmap
    return sub


def _save(tt, path):
    tt.save(path)
    return path


@pytest.fixture(scope="module")
def cmap_faces(tmp_path_factory):
    """{case: path}: the best subtable of each face is the named format."""
    out = tmp_path_factory.mktemp("cmap")
    best = TTFont(VF).getBestCmap()
    low = {c: n for c, n in best.items() if c < 0x180}
    faces = {}
    # a last-resort mapping: ranges onto one glyph each, the Latin
    # Extended-A block onto its own glyphs
    last_resort = {c: ("A" if c < 0x60 else "B") for c in range(0x20, 0x100)}
    last_resort.update({c: n for c, n in best.items() if 0x100 <= c < 0x180})
    for case, (pid, eid) in (("13_3_10", (3, 10)), ("13_0_6", (0, 6))):
        tt = TTFont(VF)
        tt["cmap"].tables = [_subtable(4, 3, 1, low), _subtable(13, pid, eid, last_resort)]
        faces[case] = _save(tt, str(out / f"cmap{case}.ttf"))
    tt = TTFont(VF)
    tt["cmap"].tables = [_subtable(2, 3, 1, low), _subtable(0, 1, 0, {
        c: n for c, n in low.items() if c < 256})]
    faces["2_3_1"] = _save(tt, str(out / "cmap2.ttf"))
    for fmt in (8, 10):
        if fmt == 10:
            gids = [36, 37, 38]
            body = struct.pack(">HHIIII", 10, 0, 20 + 2 * len(gids), 0, 0x41,
                               len(gids)) + struct.pack(">3H", *gids)
        else:
            body = (struct.pack(">HHII", 8, 0, 12 + 8192 + 4 + 12, 0) + bytes(8192)
                    + struct.pack(">IIII", 1, 0x41, 0x43, 36))
        raw = struct.pack(">HHHHI", 0, 1, 3, 10, 12) + body
        tt = TTFont(VF)
        table = DefaultTable("cmap")
        table.data = raw
        tt["cmap"] = table
        faces[f"{fmt}_3_10"] = _save(tt, str(out / f"cmap{fmt}.ttf"))
    return faces


def _arrangement(arr):
    return [(g.glyph_id, g.cluster, g.pos.x, g.pos.y, g.offset.x, g.offset.y)
            for g in arr.arranged_glyphs]


@pytest.mark.parametrize("case", ["13_3_10", "13_0_6", "2_3_1"])
def test_best_cmap_and_shaping_equal_figdraw_tpu(cmap_faces, case):
    path = cmap_faces[case]
    tt = TTFont(path)
    fmt = int(case.split("_")[0])
    pick = [t for t in tt["cmap"].tables if t.format == fmt][0]
    assert tt["cmap"].getcmap(pick.platformID, pick.platEncID) is pick
    want = tt.getBestCmap()
    with open(path, "rb") as fh:
        got = OTFont(fh.read()).getBestCmap()
    assert got == want and list(got) == list(want)
    if fmt == 13:
        assert len(set(got.values())) < len(got)
    else:
        assert any(c > 0xFF for c in got) and any(c < 0x100 for c in got)
    jtid, ptid = jax_tf.load_typeface(path), port_tf.load_typeface(path)
    assert port_tf.get_typeface(ptid).cmap == jax_tf.get_typeface(jtid).cmap
    jf = jax_tf.FigFont(typeface_id=jtid, size=18.0)
    pf = port_tf.FigFont(typeface_id=ptid, size=18.0)
    ja = jax_layout.typeset(jp.vec2(600, 200), [(jf, jp.fill(jp.rgba(0, 0, 0, 255)), TEXT)])
    pa = port_layout.typeset(pp.vec2(600, 200), [(pf, pp.fill(pp.rgba(0, 0, 0, 255)), TEXT)])
    assert _arrangement(pa) == _arrangement(ja)
    assert len({g.glyph_id for g in pa.arranged_glyphs}) > 3


@pytest.mark.parametrize("fmt", [8, 10])
def test_formats_8_and_10_are_refused_by_both(cmap_faces, fmt):
    path = cmap_faces[f"{fmt}_3_10"]
    with pytest.raises(AttributeError):
        TTFont(path).getBestCmap()
    with pytest.raises(AttributeError):
        jax_tf.load_typeface(path)
    with pytest.raises(NotImplementedError, match=f"format {fmt} .*fontTools"):
        port_tf.load_typeface(path)


def test_format_13_groups_map_to_one_glyph():
    """A hand-packed format 13 subtable: each group's range to its glyph,
    a group onto gid 0 left out, as cmap_format_13 and _make_map give."""
    groups = [(0x41, 0x43, 36), (0x44, 0x44, 0), (0x100, 0x102, 5)]
    body = struct.pack(">HHIII", 13, 0, 16 + 12 * len(groups), 0, len(groups))
    body += b"".join(struct.pack(">III", *g) for g in groups)
    tt = TTFont(VF)
    table = DefaultTable("cmap")
    table.data = struct.pack(">HHHHI", 0, 1, 3, 10, 12) + body
    tt["cmap"] = table
    buf = io.BytesIO()
    tt.save(buf)
    want = TTFont(io.BytesIO(buf.getvalue())).getBestCmap()
    got = OTFont(buf.getvalue()).getBestCmap()
    assert got == want
    assert sorted(got) == [0x41, 0x42, 0x43, 0x100, 0x101, 0x102]
