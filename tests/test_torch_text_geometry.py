"""figdraw_tpu_torch's text geometry (selection bands, cluster rects, carets,
hit tests: text/layout.py's GlyphArrangement) against figdraw_tpu's.

Every test of test_text_geometry.py runs a second time on the port
(torch_twin). On shaped DejaVuSans text (ligatures, bidi runs, wrapped
lines), both packages' arrangements give the same selection bands, cluster
rects, carets at every insertion index, nearest runes and glyph hits.
"""

import pytest
import torch

import figdraw_tpu as jax_pkg
import figdraw_tpu_torch as port
from figdraw_tpu.text import layout as jax_layout
from figdraw_tpu.text import typefaces as jax_tf
from figdraw_tpu_torch.text import layout as port_layout
from figdraw_tpu_torch.text import typefaces as port_tf
from torch_reference import DEJAVU
from torch_twin import assert_runs_on_port, case_id, port_twin, run_twin, twin_cases

torch.set_num_threads(1)

CASES = twin_cases("test_text_geometry")


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_port_twin(request, monkeypatch, case):
    assert_runs_on_port(port_twin(case[0]))
    run_twin(request, monkeypatch, case)


def _r(rect):
    return (rect.x, rect.y, rect.w, rect.h)


def geometry(pk, tf_mod, lay, text, box):
    font = tf_mod.FigFont(typeface_id=tf_mod.load_typeface(DEJAVU), size=20.0)
    arr = lay.typeset(pk.vec2(*box), [(font, pk.fill(pk.rgba(0, 0, 0, 255)), text)])
    n = len(arr.source_runes)
    out = {
        "clusters": [_r(arr.cluster_rect(i)) for i in range(len(arr.arranged_glyphs))],
        "bands": [[_r(b) for b in arr.selection_rects_for((a, b))]
                  for a in range(n) for b in range(a, min(n, a + 6))],
        "glyph_bands": [[_r(b) for b in arr.glyph_selection_rects_for((a, a + 2))]
                        for a in range(n)],
        "carets": [[(c.source_rune, c.glyph_index, c.line_index, c.pos.x, c.pos.y,
                     _r(c.rect), c.affinity) for c in arr.caret_positions_for(i)]
                   for i in range(n + 1)],
        "ranges": [arr.glyph_range_for((a, a + 1)) for a in range(n)],
    }
    probes = [pk.vec2(x, y) for x in range(-4, int(box[0]) + 4, 7)
              for y in (5.0, 15.0, 30.0, 55.0)]
    out["nearest"] = [arr.nearest_source_rune_for_caret_point(p) for p in probes]
    out["hits"] = [arr.glyph_index_at(p) for p in probes]
    return out


@pytest.mark.parametrize("text,box", [
    ("office affluent", (300, 40)),
    ("ab" + "שלום" + "cd", (300, 40)),
    ("שלום (עולם) and ltr", (300, 40)),
    ("wrapped words over three lines of text", (110, 120)),
])
def test_geometry_equals_the_jax_packages(text, box):
    want = geometry(jax_pkg, jax_tf, jax_layout, text, box)
    got = geometry(port, port_tf, port_layout, text, box)
    assert got == want
