"""figdraw_tpu_torch's CFF reader (text/cff.py, through text/otf.py) against
fontTools 4.61.1, which figdraw_tpu reads CFF faces with.

Every face is built by fontTools, saved and loaded from the file (module
fixtures), and every outline is compared with the value list of fontTools'
DecomposingRecordingPen on TTFont.getGlyphSet(), exactly (== on the lists:
ints against floats where Python's == holds):

- the whole bundled DejaVuSans converted to CFF (6253 glyphs, charstrings
  from T2CharStringPen, tools/make_port_faces.to_cff), in chunks;
- an operator face whose hand-written programs use every path operator,
  hintmask / cntrmask after implicit and explicit stems, flex, hflex,
  hflex1 and flex1, div, the width operand, a seac endchar, and local and
  global subrs at counts of 10, 1300 and 34000 (the biases 107, 1131 and
  32768);
- a CID-keyed face (ROS, two font DICTs with their own Private DICTs and
  subrs, FDSelect formats 0, 3 and 4);
- the glyph order (the charset), the predefined and custom charsets, and an
  operator fontTools does not implement raising here too.
"""

import os
import sys

import pytest
import torch
from fontTools.misc.psCharStrings import T2CharString
from fontTools.pens.recordingPen import DecomposingRecordingPen
from fontTools.ttLib import TTFont

from figdraw_tpu_torch.text import cff as port_cff
from figdraw_tpu_torch.text import typefaces as port_typefaces
from figdraw_tpu_torch.text.otf import OTFont
from torch_reference import REPO

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(REPO, "tools"))
import make_port_faces  # noqa: E402

CHUNKS = 8


def _reference(path):
    """{glyph name: DecomposingRecordingPen value} of every glyph."""
    tt = TTFont(path)
    gs = tt.getGlyphSet()
    out = {}
    for name in tt.getGlyphOrder():
        pen = DecomposingRecordingPen(gs)
        gs[name].draw(pen)
        out[name] = pen.value
    return tt, out


def _ours(path):
    with open(path, "rb") as fh:
        return OTFont(fh.read())


@pytest.fixture(scope="module")
def dejavu_cff(tmp_path_factory):
    """The whole bundled DejaVuSans as a CFF face, with fontTools' outlines."""
    src = TTFont(port_typefaces.bundled_font_path())
    path = str(tmp_path_factory.mktemp("cff") / "DejaVuSans-CFF.otf")
    with open(path, "wb") as fh:
        fh.write(make_port_faces._bytes(make_port_faces.to_cff(src)))
    tt, ref = _reference(path)
    return path, tt, ref, _ours(path)


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_whole_dejavu_as_cff_draws_every_glyph_as_fonttools(dejavu_cff, chunk):
    path, tt, ref, ours = dejavu_cff
    order = tt.getGlyphOrder()
    assert ours.glyph_order == order and ours.cff is not None and len(order) == 6253
    gids = range(chunk, len(order), CHUNKS)
    for gid in gids:
        assert ours.glyph_path(gid) == ref[order[gid]], order[gid]


def test_whole_dejavu_as_cff_tables(dejavu_cff):
    path, tt, _ref, ours = dejavu_cff
    assert ours.getBestCmap() == tt.getBestCmap()
    assert [ours.advance(g) for g in range(len(tt.getGlyphOrder()))] == [
        tt["hmtx"][n][0] for n in tt.getGlyphOrder()]
    assert tt["post"].formatType == 3.0  # the names come from the charset


# --- the operator face ------------------------------------------------------------------

def _operator_programs(bias_l: int, bias_g: int, n_local: int, n_global: int):
    """{glyph: program} exercising each operator; subr k is called as
    k - bias."""
    last_l, last_g = n_local - 1 - bias_l, n_global - 1 - bias_g
    mask = bytes([0b11000000])
    return {
        "rmoveto": [500, 10, 20, "rmoveto", 100, 0, 0, 100, -100, 0, "rlineto", "endchar"],
        "hmoveto": [30, "hmoveto", 100, 200, -100, "hlineto", "endchar"],
        "vmoveto": [40, "vmoveto", 100, 200, -100, 50, "vlineto", "endchar"],
        "nowidth": [0, 0, "rmoveto", 50, 0, "rlineto", "endchar"],
        "rrcurveto": [0, 0, "rmoveto", 10, 20, 30, 40, 50, 60, 1, 2, 3, 4, 5, 6,
                      "rrcurveto", "endchar"],
        "hhcurveto_odd": [0, 0, "rmoveto", 7, 10, 20, 30, 40, 50, 60, 70, 80,
                          "hhcurveto", "endchar"],
        "hhcurveto_even": [0, 0, "rmoveto", 10, 20, 30, 40, "hhcurveto", "endchar"],
        "vvcurveto_odd": [0, 0, "rmoveto", 5, 10, 20, 30, 40, 1, 2, 3, 4,
                          "vvcurveto", "endchar"],
        "vvcurveto_even": [0, 0, "rmoveto", 10, 20, 30, 40, "vvcurveto", "endchar"],
        "hvcurveto": [0, 0, "rmoveto", 10, 20, 30, 40, 50, 60, 70, 80, 9,
                      "hvcurveto", 11, 12, 13, 14, "hvcurveto", "endchar"],
        "vhcurveto": [0, 0, "rmoveto", 10, 20, 30, 40, 50, 60, 70, 80, 90, 100, 110,
                      120, 5, "vhcurveto", "endchar"],
        "rcurveline": [0, 0, "rmoveto", 10, 20, 30, 40, 50, 60, 1, 2, 3, 4, 5, 6, 70, 80,
                       "rcurveline", "endchar"],
        "rlinecurve": [0, 0, "rmoveto", 10, 20, 30, 40, 50, 60, 70, 80, 90, 100,
                       "rlinecurve", "endchar"],
        "flex": [0, 0, "rmoveto", 10, 20, 30, 40, 50, 60, 70, 80, 90, 100, 110, 120, 50,
                 "flex", "endchar"],
        "hflex": [0, 0, "rmoveto", 10, 20, 30, 40, 50, 60, 70, "hflex", "endchar"],
        "hflex1": [0, 0, "rmoveto", 10, 20, 30, 40, 50, 60, 70, 80, 90, "hflex1",
                   "endchar"],
        "flex1_dx": [0, 0, "rmoveto", 100, 1, 100, 2, 100, 3, 100, 4, 100, 5, 60,
                     "flex1", "endchar"],
        "flex1_dy": [0, 0, "rmoveto", 1, 100, 2, 100, 3, 100, 4, 100, 5, 100, 60,
                     "flex1", "endchar"],
        "hints": [480, 10, 20, 30, 40, "hstemhm", 50, 60, "vstemhm", "hintmask", mask,
                  0, 0, "rmoveto", 10, 10, "rlineto", "cntrmask", mask, 20, "hlineto",
                  "endchar"],
        "implicit_vstem": [10, 20, 30, 40, "hstem", 50, 60, "hintmask", mask,
                           5, 5, "rmoveto", 30, "vlineto", "endchar"],
        "stems": [10, 20, "hstem", 30, 40, "vstem", 7, 7, "rmoveto", 9, "hlineto",
                  "endchar"],
        "fixed_and_div": [0, 0, "rmoveto", 10.5, -3.25, "rlineto", 7, 2, "div", 6, 3,
                          "div", "rlineto", "endchar"],
        "two_paths": [0, 0, "rmoveto", 10, 0, "rlineto", 40, 40, "rmoveto", 0, 10,
                      "rlineto", "endchar"],
        "line_first": [10, 20, "rlineto", "endchar"],
        "subrs": [0, 0, "rmoveto", -bias_l, "callsubr", last_l, "callsubr", -bias_g,
                  "callgsubr", last_g, "callgsubr", "endchar"],
        "ignore": [3, 4, "ignore", "rmoveto", 5, "hlineto", "endchar"],
        "seac": [600, 10, 20, 65, 66, "endchar"],  # A (65) with B (66) at (10, 20)
        "after_endchar": [0, 0, "rmoveto", 10, "hlineto", "endchar", 5, "vlineto"],
    }


def _subr(k: int):
    return T2CharString(program=[k % 50 + 1, k % 7, "rlineto", "return"])


def build_operator_face(path: str, n_local: int, n_global: int) -> None:
    from fontTools.cffLib import SubrsIndex
    from fontTools.fontBuilder import FontBuilder

    programs = _operator_programs(port_cff.subr_bias(n_local), port_cff.subr_bias(n_global),
                                  n_local, n_global)
    base = {"A": [500, 0, 0, "rmoveto", 200, 700, "rlineto", 200, -700, "rlineto",
                  "endchar"],
            "B": [520, 0, 0, "rmoveto", 300, "hlineto", 700, "vlineto", -300, "hlineto",
                  "endchar"]}
    order = [".notdef", "A", "B"] + list(programs)
    fb = FontBuilder(1000, isTTF=False)
    fb.setupGlyphOrder(order)
    fb.setupCharacterMap({0x41: "A", 0x42: "B"})
    charstrings = {".notdef": T2CharString(program=[500, "endchar"])}
    for name, prog in list(base.items()) + list(programs.items()):
        charstrings[name] = T2CharString(program=list(prog))
    fb.setupCFF("OperatorTest", {"FullName": "OperatorTest"}, charstrings,
                {"nominalWidthX": 20, "defaultWidthX": 480})
    fb.setupHorizontalMetrics({n: (600, 0) for n in order})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "OperatorTest", "styleName": "Regular"})
    fb.setupOS2()
    fb.setupPost()
    cff = fb.font["CFF "].cff
    top = cff.topDictIndex[0]
    subrs = SubrsIndex()
    for k in range(n_local):
        subrs.append(_subr(k))
    top.Private.Subrs = subrs
    for k in range(n_global):
        cff.GlobalSubrs.append(_subr(3 * k + 1))
    fb.font.save(path)


@pytest.fixture(scope="module", params=[(10, 10), (1300, 10), (34000, 1300), (10, 34000)],
                ids=["subrs10", "local1300", "local34000", "global34000"])
def operator_face(request, tmp_path_factory):
    n_local, n_global = request.param
    path = str(tmp_path_factory.mktemp("ops") / f"ops_{n_local}_{n_global}.otf")
    build_operator_face(path, n_local, n_global)
    tt, ref = _reference(path)
    return tt, ref, _ours(path), (n_local, n_global)


OPERATOR_GLYPHS = list(_operator_programs(107, 107, 10, 10))


@pytest.mark.parametrize("glyph", OPERATOR_GLYPHS)
def test_operator_glyph_draws_as_fonttools(operator_face, glyph):
    tt, ref, ours, counts = operator_face
    gid = tt.getGlyphOrder().index(glyph)
    got = ours.glyph_path(gid)
    assert got == ref[glyph]
    assert got or glyph == ".notdef"


def test_operator_face_biases(operator_face):
    _tt, _ref, ours, (n_local, n_global) = operator_face
    assert len(ours.cff.privates[0].subrs) == n_local
    assert len(ours.cff.global_subrs) == n_global
    assert ours.cff.privates[0].bias == {10: 107, 1300: 1131, 34000: 32768}[n_local]
    assert ours.cff.global_bias == {10: 107, 1300: 1131, 34000: 32768}[n_global]
    assert ours.cff.privates[0].nominal_width == 20
    assert ours.cff.privates[0].default_width == 480


@pytest.mark.parametrize("op", ["add", "mul", "exch", "roll", "sqrt"])
def test_an_operator_fonttools_does_not_implement_raises(tmp_path, op):
    """fontTools raises NotImplementedError on these (psCharStrings.py);
    the port raises too, and draws no default outline in their place."""
    from fontTools.fontBuilder import FontBuilder

    fb = FontBuilder(1000, isTTF=False)
    fb.setupGlyphOrder([".notdef", "A"])
    fb.setupCharacterMap({0x41: "A"})
    prog = [0, 0, "rmoveto", 4, 2, op, 3, "rlineto", "endchar"]
    fb.setupCFF("Bad", {"FullName": "Bad"},
                {".notdef": T2CharString(program=[500, "endchar"]),
                 "A": T2CharString(program=prog)}, {})
    fb.setupHorizontalMetrics({".notdef": (500, 0), "A": (500, 0)})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "Bad", "styleName": "Regular"})
    fb.setupOS2()
    fb.setupPost()
    path = str(tmp_path / "bad.otf")
    fb.font.recalcBBoxes = False  # bounds would draw the glyph
    fb.save(path)
    tt = TTFont(path)
    gs = tt.getGlyphSet()
    with pytest.raises(NotImplementedError):
        gs["A"].draw(DecomposingRecordingPen(gs))
    with pytest.raises(NotImplementedError, match=op):
        _ours(path).glyph_path(1)


def test_unknown_operator_ends_its_charstring_as_in_fonttools(tmp_path):
    """An opcode fontTools has no operator for (2) ends the charstring it is
    in: the outline so far is drawn and closed."""
    from fontTools.fontBuilder import FontBuilder

    fb = FontBuilder(1000, isTTF=False)
    fb.setupGlyphOrder([".notdef", "A"])
    fb.setupCharacterMap({0x41: "A"})
    fb.setupCFF("Odd", {"FullName": "Odd"},
                {".notdef": T2CharString(program=[500, "endchar"]),
                 "A": T2CharString(bytecode=bytes([139, 139, 21, 149, 6, 2, 149, 7, 14]))},
                {})
    fb.setupHorizontalMetrics({".notdef": (500, 0), "A": (500, 0)})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "Odd", "styleName": "Regular"})
    fb.setupOS2()
    fb.setupPost()
    path = str(tmp_path / "odd.otf")
    fb.save(path)
    _tt, ref = _reference(path)
    assert _ours(path).glyph_path(1) == ref["A"] == [
        ("moveTo", ((0, 0),)), ("lineTo", ((10, 0),)), ("closePath", ())]


# --- a CID-keyed face -----------------------------------------------------------------


def build_cid_face(path: str, fd_select_format: int = 3) -> None:
    """Two font DICTs, each with its own Private DICT (nominal width) and
    three local subrs, an FDSelect of the given format over six glyphs
    named by CID."""
    from fontTools.cffLib import FDArrayIndex, FDSelect, FontDict, PrivateDict, SubrsIndex
    from fontTools.fontBuilder import FontBuilder

    order = [".notdef"] + ["cid%05d" % c for c in (1, 2, 3, 7, 8)]
    fb = FontBuilder(1000, isTTF=False)
    fb.setupGlyphOrder(order)
    fb.setupCharacterMap({0x41 + i: n for i, n in enumerate(order[1:])})
    fb.setupCFF("CidTest", {"FullName": "CidTest"},
                {n: T2CharString(program=[500, "endchar"]) for n in order}, {})
    fb.setupHorizontalMetrics({n: (600, 0) for n in order})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "CidTest", "styleName": "Regular"})
    fb.setupOS2()
    fb.setupPost()
    cff = fb.font["CFF "].cff
    top = cff.topDictIndex[0]
    top.ROS = ("Adobe", "Identity", 0)
    top.CIDCount = 100
    fd_array, privates = FDArrayIndex(), []
    for i in range(2):
        fd, private, subrs = FontDict(), PrivateDict(), SubrsIndex()
        for k in range(3):
            subrs.append(T2CharString(program=[10 * (i + 1) + k, 3 * i, "rlineto", "return"]))
        private.Subrs = subrs
        private.nominalWidthX = 100 * i
        private.defaultWidthX = 0
        fd.Private = private
        fd.FontName = f"CidTest-{i}"
        privates.append(private)
        fd_array.append(fd)
    select = FDSelect(format=fd_select_format)
    select.gidArray = [0, 0, 1, 1, 0, 1]
    top.FDArray = fd_array
    top.FDSelect = select
    del top.Private
    charstrings = top.CharStrings
    charstrings.fdArray, charstrings.fdSelect = fd_array, select
    for gid, name in enumerate(order):
        fd = select.gidArray[gid]
        prog = ([600 - 100 * fd, 50, 60, "rmoveto", -107, "callsubr", 200, "vlineto",
                 -105 - gid % 2, "callsubr", "endchar"] if gid else [500, "endchar"])
        cs = T2CharString(program=prog, private=privates[fd], globalSubrs=cff.GlobalSubrs)
        cs.fdSelectIndex = fd
        charstrings.charStrings[name] = cs
    fb.font.save(path)


@pytest.mark.parametrize("fd_select_format", [0, 3, 4])
def test_cid_keyed_face_draws_as_fonttools(tmp_path, fd_select_format):
    path = str(tmp_path / "cid.otf")
    build_cid_face(path, fd_select_format)
    tt, ref = _reference(path)
    ours = _ours(path)
    assert tt["CFF "].cff.topDictIndex[0].FDSelect.format == fd_select_format
    assert ours.glyph_order == tt.getGlyphOrder() == [
        ".notdef", "cid00001", "cid00002", "cid00003", "cid00007", "cid00008"]
    assert ours.cff.fd_select == [0, 0, 1, 1, 0, 1]
    assert [len(p.subrs) for p in ours.cff.privates] == [3, 3]
    for gid, name in enumerate(tt.getGlyphOrder()):
        assert ours.glyph_path(gid) == ref[name], name
    # the two font DICTs' subrs differ: glyphs of FD 0 and FD 1 differ
    assert ref["cid00001"] != ref["cid00002"]


# --- the charset and the committed face ------------------------------------------------


def test_repeated_charset_names_renamed_as_fonttools():
    names = port_cff.CFFTable._charset
    # format 2 at offset 4 (offsets 0-2 name the predefined charsets): SID 34
    # ("A"), then a run of two from SID 34 again
    data = bytearray(4) + bytes([2]) + (34).to_bytes(2, "big") + (0).to_bytes(2, "big") \
        + (34).to_bytes(2, "big") + (1).to_bytes(2, "big")
    got = names(bytes(data), {15: [4]}, [], 4, False)
    assert got == [".notdef", "A", "A.1", "B"]
    assert names(b"", {}, [], 3, False) == [".notdef", "space", "exclam"]


def test_committed_cff_face_reads_as_fonttools():
    path = port_typefaces.bundled_font_path("FigPortSans-CFF.otf")
    tt, ref = _reference(path)
    ours = _ours(path)
    assert ours.glyph_order == tt.getGlyphOrder()
    for gid, name in enumerate(tt.getGlyphOrder()):
        assert ours.glyph_path(gid) == ref[name], name
    assert ours.getBestCmap() == tt.getBestCmap()
