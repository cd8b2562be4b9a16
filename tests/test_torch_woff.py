"""figdraw_tpu_torch's WOFF 1.0 reader (text/woff.py, through text/otf.py
and text/typefaces.py) against figdraw_tpu, which opens a .woff face with
fontTools 4.61.1's TTFont, and against the sfnt the WOFF wraps.

- The committed FigPortSans-VF.woff (tools/make_port_faces.py writes it
  from FigPortSans-VF.ttf, byte for byte again here) holds compressed and
  stored tables; the port's unwrapped sfnt has every table fontTools'
  SFNTReader reads from the WOFF, byte for byte.
- The typeface: its id (a hash of the file's own bytes), cmap, glyph order,
  kern pairs and advances equal figdraw_tpu's, and the sfnt's but the id;
  every glyph's outline at each of `scenes.FONT_LOCATIONS` equals
  figdraw_tpu's as numbers and types, and the sfnt's.
- A WOFF 1.0 file under the "wOF2" signature raises ValueError naming
  WOFF2 (text/woff2.py reads WOFF2 since the Brotli decoder came; its own
  tests are tests/test_torch_woff2.py) where fontTools fails too; a table
  whose compLength exceeds its origLength is refused by both packages.

bench_text's combo and atlas from the WOFF face, its typeface_info and its
instance pack are held to figdraw_tpu's in tests/test_torch_variations.py
(the face is in scenes.FONT_FACES, FONT_TEXT_CASES and FONT_PACK_CASES).
"""

import io
import os
import struct
import sys

import pytest
import torch
from fontTools.ttLib import TTFont
from fontTools.ttLib.sfnt import SFNTReader

from figdraw_tpu.text import typefaces as jax_tf
from figdraw_tpu_torch import scenes
from figdraw_tpu_torch.text import typefaces as port_tf
from figdraw_tpu_torch.text.otf import OTFont, collection_size
from figdraw_tpu_torch.text.woff import woff_to_sfnt
from torch_reference import REPO, jax_variations, port_variations

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(REPO, "tools"))
import make_port_faces  # noqa: E402

WOFF = port_tf.bundled_font_path("FigPortSans-VF.woff")
SFNT = port_tf.bundled_font_path("FigPortSans-VF.ttf")


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def faces():
    """(figdraw_tpu's typeface of the WOFF, the port's, the port's of the
    sfnt)."""
    return (jax_tf.get_typeface(jax_tf.load_typeface(WOFF)),
            port_tf.get_typeface(port_tf.load_typeface(WOFF)),
            port_tf.get_typeface(port_tf.load_typeface(SFNT)))


def test_generator_rewrites_the_woff_byte_for_byte():
    assert make_port_faces.woff(_read(SFNT)) == _read(WOFF)


def test_unwrapped_tables_equal_fonttools_reader():
    """Every table of the port's sfnt equals what SFNTReader decodes from
    the WOFF (zlib-inflated or stored), and the file holds both kinds."""
    data = _read(WOFF)
    reader = SFNTReader(io.BytesIO(data))
    assert reader.flavor == "woff"
    ours = OTFont(data)
    stored = {str(tag): entry.length == entry.origLength
              for tag, entry in reader.tables.items()}
    assert any(stored.values()) and not all(stored.values())
    assert sorted(ours.tables) == sorted(stored)
    for tag in stored:
        off, length = ours.tables[tag]
        assert ours.data[off : off + length] == reader[tag], tag
        assert off % 4 == 0, tag
    assert collection_size(data) == 1
    sfnt = woff_to_sfnt(data)
    assert TTFont(io.BytesIO(sfnt)).getGlyphOrder() == TTFont(WOFF).getGlyphOrder()


def test_typeface_equals_figdraw_tpu_and_the_sfnt(faces):
    jtf, ptf, stf = faces
    assert ptf.id == jtf.id != stf.id
    for tf in (jtf, stf):
        assert ptf.cmap == tf.cmap and ptf.cmap
        assert ptf._glyph_order == tf._glyph_order
        assert ptf._kern == tf._kern and ptf._kern
        assert [ptf.advance(g) for g in range(len(ptf._glyph_order))] == [
            tf.advance(g) for g in range(len(tf._glyph_order))]
        assert (ptf.units_per_em, ptf.ascent, ptf.descent, ptf.line_gap) == (
            tf.units_per_em, tf.ascent, tf.descent, tf.line_gap)
    assert ptf.family_name == jtf.family_name == "FigPort Sans"


def _types(value):
    return [type(v) for _op, pts in value for pt in pts if pt is not None for v in pt]


@pytest.mark.parametrize("loc", scenes.FONT_LOCATIONS,
                         ids=[scenes.font_case_key("", loc).lstrip("@") or "default"
                              for loc in scenes.FONT_LOCATIONS])
def test_every_glyph_path_equals_figdraw_tpu_and_the_sfnt(faces, loc):
    """Outlines and advances of every glyph at a location: equal as numbers
    and as int or float to figdraw_tpu's (fontTools' instanced glyph set of
    the WOFF) and to the port's of the sfnt."""
    jtf, ptf, stf = faces
    jv, pv = jax_variations(loc), port_variations(loc)
    for gid in range(len(ptf._glyph_order)):
        got = ptf.glyph_path(gid, pv)
        want = jtf.glyph_path(gid, jv)
        assert got == want and _types(got) == _types(want), ptf.glyph_name(gid)
        assert got == stf.glyph_path(gid, pv), ptf.glyph_name(gid)
        assert ptf.var_advance(gid, pv) == jtf.var_advance(gid, jv) == stf.var_advance(gid, pv)


def test_woff2_raises_naming_woff2(tmp_path):
    """A WOFF 1.0 file under the "wOF2" signature: its directory is no
    WOFF2 directory, and both packages refuse it (the port with ValueError
    naming WOFF2; fontTools, reading WOFF2 through tools/brotli_shim.py
    here, with its own error)."""
    from fontTools.ttLib import woff2 as ft_woff2

    import brotli_shim

    path = str(tmp_path / "face.woff2")
    with open(path, "wb") as fh:
        fh.write(b"wOF2" + _read(WOFF)[4:])
    with pytest.raises(ValueError, match="WOFF2"):
        port_tf.load_typeface(path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ft_woff2, "brotli", brotli_shim, raising=False)
        mp.setattr(ft_woff2, "haveBrotli", True)
        with pytest.raises(Exception):
            TTFont(path)["glyf"]


def test_a_table_larger_compressed_than_stored_is_refused(tmp_path):
    """A directory entry whose compLength exceeds its origLength: fontTools'
    WOFFDirectoryEntry asserts, the port raises ValueError."""
    data = bytearray(_read(WOFF))
    n_tables = struct.unpack_from(">H", data, 12)[0]
    for i in range(n_tables):
        at = 44 + 20 * i
        if data[at : at + 4] == b"maxp":
            comp, orig = struct.unpack_from(">II", data, at + 8)
            struct.pack_into(">I", data, at + 12, comp - 1)
    path = str(tmp_path / "bad.woff")
    with open(path, "wb") as fh:
        fh.write(bytes(data))
    with pytest.raises(AssertionError):
        TTFont(path)["maxp"]
    with pytest.raises(ValueError, match="exceeds"):
        OTFont(bytes(data))
