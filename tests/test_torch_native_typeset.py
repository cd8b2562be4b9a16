"""The port's C typesetter (text/native_typeset.py on the shared
native/typeset.cpp) and its FDTP font packs (text/native_pack.py) against
figdraw_tpu's.

- Twins (torch_twin): the tests of test_native_typeset.py that read fonts
  in this checkout run a second time on the port: with the system
  DejaVuSans the JAX tests read, and those that read it again with the
  port's bundled copy (fonts/DejaVuSans.ttf, sha256 checked). The others
  (WAITING) read faces that are not in the repository.
- The pack bytes: the port's build_font_pack equals figdraw_tpu's byte for
  byte on the DejaVu faces and the bundled copy; the bundled face's pack
  digest is pinned in reference/fdtp_DejaVuSans.json (chip_smoke.py holds
  the card's host to it) with the Unicode version of this Python, whose
  unicodedata makes the pack's bidi and joining tables.
- The port's build of typeset.cpp gives figdraw_tpu's build's results on
  the same strings, array for array; a variation location away from the
  default raises; a failed build raises with the compiler's output; the
  example typeset_demo.c runs against the port's library.
"""

import ast
import glob
import hashlib
import json
import os
import shutil
import struct
import subprocess
import unicodedata

import numpy as np
import pytest

from figdraw_tpu.text import native_pack as jax_pack
from figdraw_tpu.text import native_typeset as jax_nt
from figdraw_tpu.text import typefaces as jax_tf
from figdraw_tpu_torch.text import native_pack, native_typeset as nt, typefaces
from figdraw_tpu_torch.text.otf import VARIATIONS_NOT_PORTED
from figdraw_tpu_torch.utils import gxx
from torch_reference import DEJAVU, REPO, ensure_jax_typeset
from torch_twin import TESTS, assert_runs_on_port, port_twin, run_twin

BUNDLED = typefaces.bundled_font_path()
PACK_REF = os.path.join(REPO, "figdraw_tpu_torch", "reference", "fdtp_DejaVuSans.json")
DEJAVU_FACES = sorted(glob.glob("/usr/share/fonts/truetype/dejavu/DejaVuS*.ttf"))
PACK_FACES = [f for f in DEJAVU_FACES if os.path.basename(f) in (
    "DejaVuSans.ttf", "DejaVuSans-Bold.ttf", "DejaVuSansMono.ttf", "DejaVuSerif.ttf")]

# the tests of test_native_typeset.py that read Ubuntu, Hack, FiraCode and
# the Noto Hebrew, Naskh and Devanagari faces, none of which is in the
# repository (ROADMAP.md queue 1, item 5)
WAITING = (
    "test_ubuntu_and_hack_fonts_match", "test_firacode_calt_shapes_natively",
    "test_c_host_demo_compiles_and_runs", "test_hebrew_niqqud_shape_ex_matches_python",
    "test_devanagari_shape_ex_matches_layout", "test_devanagari_fuzz_parity",
    "test_mixed_script_fuzz_parity", "test_typeset_box_devanagari_wrapped",
    "test_arrangement_geometry_bidi", "test_arrangement_geometry_devanagari",
    "test_arrangement_geometry_edge_contracts", "test_variable_instance_packs",
    "test_typeset_box_bidi_hebrew", "test_typeset_box_bidi_arabic",
    "test_typeset_box_bidi_fuzz", "test_arabic_naskh_shape_ex_matches_layout",
    "test_arabic_positional_forms_actually_fire", "test_arabic_mixed_and_fuzz_parity",
)


def _twin_cases():
    """(test name, font path) for each twin: the system DejaVuSans, and the
    bundled copy for the tests that read DEJAVU. Read from the file's
    syntax tree, so collecting builds nothing."""
    with open(os.path.join(TESTS, "test_native_typeset.py")) as fh:
        tree = ast.parse(fh.read())
    cases = []
    for node in tree.body:
        if not (isinstance(node, ast.FunctionDef) and node.name.startswith("test_")):
            continue
        if node.name in WAITING:
            continue
        cases.append((node.name, DEJAVU))
        if any(isinstance(n, ast.Name) and n.id == "DEJAVU" for n in ast.walk(node)):
            cases.append((node.name, BUNDLED))
    return cases


CASES = _twin_cases()


def test_twins_are_the_tests_that_read_fonts_in_the_repo():
    names = {name for name, _ in CASES}
    assert len(names) == 21 and len(names) + len(WAITING) == 39


@pytest.mark.parametrize("case", CASES, ids=[
    f"{name}[{'bundled' if path == BUNDLED else 'system'}]" for name, path in CASES])
def test_port_twin(request, monkeypatch, case):
    name, path = case
    twin = port_twin("test_native_typeset")
    assert_runs_on_port(twin)
    assert twin.nt is nt
    monkeypatch.setattr(twin, "DEJAVU", path)
    run_twin(request, monkeypatch, ("test_native_typeset", name, None))


def test_bundled_font_is_the_system_dejavu_sans():
    with open(BUNDLED, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()
    assert digest == "abdc775b21b1bc470d50c97e790d276f2054b7504e56e5bd3e64f48d68582322"
    with open(DEJAVU, "rb") as fh:
        assert hashlib.sha256(fh.read()).hexdigest() == digest


# --- the pack bytes -------------------------------------------------------------


@pytest.mark.parametrize("path", PACK_FACES + [BUNDLED], ids=os.path.basename)
def test_pack_equals_figdraw_tpu_pack(path):
    assert len(PACK_FACES) == 4
    port = native_pack.build_font_pack(typefaces.load_typeface(path))
    ref = jax_pack.build_font_pack(jax_tf.load_typeface(path))
    assert port == ref


def test_bundled_pack_digest_is_pinned():
    """The pack chip_smoke.py builds on the card's host must have this
    digest: the same face and the same Unicode tables (unicodedata
    15.0.0 here) give the same bytes."""
    with open(PACK_REF) as fh:
        ref = json.load(fh)
    assert unicodedata.unidata_version == ref["unidata_version"] == "15.0.0"
    for build in (native_pack.build_font_pack(typefaces.load_typeface(BUNDLED)),
                  jax_pack.build_font_pack(jax_tf.load_typeface(BUNDLED))):
        assert len(build) == ref["pack_bytes"]
        assert hashlib.sha256(build).hexdigest() == ref["pack_sha256"]


def test_save_font_pack_writes_the_pack(tmp_path):
    tid = typefaces.load_typeface(BUNDLED)
    path = str(tmp_path / "dejavu.fdtp")
    native_pack.save_font_pack(tid, path)
    with open(path, "rb") as fh:
        assert fh.read() == native_pack.build_font_pack(tid)


def _variable_face(tmp_path):
    """A face with a wght axis (100-900, default 400) and no outline
    variations, built with fontTools."""
    from fontTools.fontBuilder import FontBuilder
    from fontTools.pens.ttGlyphPen import TTGlyphPen

    names = [".notdef", "A", "B"]
    fb = FontBuilder(1000, isTTF=True)
    fb.setupGlyphOrder(names)
    fb.setupCharacterMap({ord("A"): "A", ord("B"): "B"})
    glyf = {}
    for g in names:
        pen = TTGlyphPen(None)
        pen.moveTo((50, 0)); pen.lineTo((450, 0))
        pen.lineTo((450, 700)); pen.lineTo((50, 700)); pen.closePath()
        glyf[g] = pen.glyph()
    fb.setupGlyf(glyf)
    fb.setupHorizontalMetrics({g: (500, 50) for g in names})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "VarTest", "styleName": "Regular"})
    fb.setupOS2(sTypoAscender=800, sTypoDescender=-200)
    fb.setupPost()
    fb.setupFvar(axes=[("wght", 100, 400, 900, "Weight")], instances=[])
    path = str(tmp_path / "vartest.ttf")
    fb.font.save(path)
    return path


def test_variation_away_from_default_raises(tmp_path):
    path = _variable_face(tmp_path)
    tid = typefaces.load_typeface(path)
    default = native_pack.build_font_pack(tid)
    assert native_pack.build_font_pack(tid, [("wght", 400.0)]) == default
    assert default == jax_pack.build_font_pack(jax_tf.load_typeface(path))
    with pytest.raises(NotImplementedError, match="variation location"):
        native_pack.build_font_pack(tid, [("wght", 700.0)])
    with pytest.raises(NotImplementedError) as err:
        nt.shape_ex(tid, "AB", variations=[typefaces.FontVariation("wght", 700.0)])
    assert str(err.value) == VARIATIONS_NOT_PORTED
    assert not [key for key in nt._packs if key[0] == tid and key[1]]


# --- the port's C build against figdraw_tpu's ------------------------------------

STRINGS = (
    "Office fifi ffl flow first AVATAR WAVE To Ya",
    "\u0422\u0435\u0441\u0442 \u0434\u043e\u0431\u0440\u043e \u03b4\u03cc\u03be\u03b1 \u0394\u0398\u039b",
    "café mélange á̈ stack",
    "\u0644\u0627 \u0633\u0644\u0627\u0645 abc",
    "The quick brown fox jumps over the lazy dog.\nSecond paragraph, Office ffi.",
)


@pytest.fixture(scope="module")
def both_faces():
    ensure_jax_typeset()
    return typefaces.load_typeface(BUNDLED), jax_tf.load_typeface(BUNDLED)


def _same(a, b):
    """Equal results: arrays element for element, tuples member for member."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("text", STRINGS, ids=range(len(STRINGS)))
def test_c_results_equal_figdraw_tpu_build(both_faces, text):
    tid, jtid = both_faces
    assert nt.pack_blob(tid) == jax_nt.pack_blob(jtid)
    _same(nt.shape_ex(tid, text), jax_nt.shape_ex(jtid, text))
    _same(nt.shape_ex(tid, text, rtl=True), jax_nt.shape_ex(jtid, text, rtl=True))
    for kw in ({}, {"bounds": (220.0, 160.0), "h_align": 1, "v_align": 2},
               {"bounds": (90.0, 0.0), "line_height": 30.0, "wrap": False}):
        _same(nt.typeset_box(tid, text, 18.0, **kw), jax_nt.typeset_box(jtid, text, 18.0, **kw))
    try:
        want = jax_nt.shape(jtid, text)
    except jax_nt.NativeTypesetUnsupported:
        with pytest.raises(nt.NativeTypesetUnsupported):
            nt.shape(tid, text)
    else:
        _same(nt.shape(tid, text), want)
        _same(nt.typeset_line(tid, text, 24.0), jax_nt.typeset_line(jtid, text, 24.0))
    a = nt.Arrangement(tid, text, 18.0, bounds=(150.0, 0.0))
    b = jax_nt.Arrangement(jtid, text, 18.0, bounds=(150.0, 0.0))
    _same(a.glyphs(), b.glyphs())
    assert a.content_size() == b.content_size() and a.line_count() == b.line_count()
    for i in range(a.glyph_count()):
        assert a.glyph_rect(i) == b.glyph_rect(i) and a.cluster_rect(i) == b.cluster_rect(i)
        assert a.source_range(i) == b.source_range(i)
    n = len(text)
    assert a.selection_rects(0, n - 1) == b.selection_rects(0, n - 1)
    assert a.glyph_range_for(1, n // 2) == b.glyph_range_for(1, n // 2)
    for sr in range(n + 1):
        assert a.caret_positions(sr) == b.caret_positions(sr)
    for x, y in ((0.0, 2.0), (40.0, 15.0), (149.0, 40.0)):
        assert a.glyph_index_at(x, y) == b.glyph_index_at(x, y)
        assert a.nearest_source_rune(x, y) == b.nearest_source_rune(x, y)


def test_metrics_flags_and_utf8_equal_figdraw_tpu_build(both_faces):
    tid, jtid = both_faces
    assert nt.metrics(tid) == jax_nt.metrics(jtid)
    assert nt.pack_flags(tid) == jax_nt.pack_flags(jtid)
    for cp in (0x41, 0xE9, 0x3A9, 0x6211, 0x10FFFF):
        gid = nt.glyph_id(tid, cp)
        assert gid == jax_nt.glyph_id(jtid, cp)
        assert nt.advance(tid, gid) == jax_nt.advance(jtid, gid)
    raw = "Zürich → δ".encode() + b"\xed\xa0\x80\xf4\x90\x80\x80"
    _same(nt.utf8_to_cps(raw), jax_nt.utf8_to_cps(raw))


# --- the build ----------------------------------------------------------------------


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "typeset.cpp"
    broken.write_text("int fd_pack_load( {\n")
    monkeypatch.setattr(nt, "_SRC", str(broken))
    monkeypatch.setattr(nt, "_lib", None)
    with pytest.raises(subprocess.CalledProcessError) as err:
        nt.available()
    assert "error" in err.value.stderr
    assert nt._lib is None


def test_typeset_demo_runs_against_the_port_library(tmp_path):
    """native/examples/typeset_demo.c on a pack of the bundled DejaVuSans:
    the line, the wrapped box and the refusal of a mark the advance stream
    cannot place, as test_native_typeset.py's demo test checks them (its
    Devanagari leg waits for a Devanagari face in the repository)."""
    if shutil.which("gcc") is None:
        raise RuntimeError("gcc is needed to build the C example")
    lib = nt.build()
    exe = str(tmp_path / "typeset_demo")
    subprocess.run(["gcc", os.path.join(REPO, "native", "examples", "typeset_demo.c"),
                    "-I", os.path.join(REPO, "native"), lib,
                    f"-Wl,-rpath,{os.path.dirname(lib)}", "-o", exe],
                   check=True, capture_output=True)
    tid = typefaces.load_typeface(BUNDLED)
    pack = str(tmp_path / "dejavu.fdtp")
    native_pack.save_font_pack(tid, pack)
    text = "Office flow AVATAR"
    out = subprocess.run([exe, pack, text], check=True, capture_output=True, text=True)
    lines = dict(line.split("=") for line in out.stdout.split())
    gids, _, _, baseline = nt.typeset_line(tid, text, 24.0)
    _, adv, _ = nt.shape(tid, text)
    assert int(lines["glyphs"]) == len(gids)
    assert int(lines["first_gid"]) == int(gids[0])
    want_w = float(np.sum(adv.astype(np.float64))) * 24.0 / typefaces.get_typeface(tid).units_per_em
    assert abs(float(lines["width_px"]) - want_w) < 0.05
    assert float(lines["baseline"]) == baseline
    bg, _, _, _, bsize = nt.typeset_box(tid, text, 24.0, bounds=(160, 0), h_align=1, wrap=True)
    assert int(lines["box_glyphs"]) == len(bg)
    assert abs(float(lines["box_w"]) - bsize[0]) < 0.05
    assert abs(float(lines["box_h"]) - bsize[1]) < 0.05
    assert int(lines["flags"]) == nt.pack_flags(tid)
    assert subprocess.run([exe, pack, "cafe\u0301"], capture_output=True).returncode == 2
    out = subprocess.run([exe, pack, "--box", "cafe\u0301"], check=True,
                         capture_output=True, text=True)
    lines = dict(line.split("=") for line in out.stdout.split())
    bg, _, _, _, bsize = nt.typeset_box(tid, "cafe\u0301", 24.0, bounds=(160, 0),
                                        h_align=1, wrap=True)
    assert int(lines["box_glyphs"]) == len(bg)
    assert abs(float(lines["box_w"]) - bsize[0]) < 0.05


def test_pack_header_is_version_5():
    blob = native_pack.build_font_pack(typefaces.load_typeface(BUNDLED))
    assert struct.unpack_from("<II", blob, 0) == (native_pack.MAGIC, native_pack.VERSION) \
        == (0x46445450, 5)
    assert gxx.BUILD_DIR in nt.build()
