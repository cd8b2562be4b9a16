"""figdraw_tpu_torch's typeface registry against figdraw_tpu's.

Every test of test_text_registry.py runs a second time on the port
(torch_twin): content-hash typeface ids, metadata, a variable face's axes,
font ids that ignore shaping-only settings. Both registries give the same
typeface ids (a content digest of the bytes and the face index) and font ids
for the same fonts, so glyph cache keys agree across the packages; and both
resolve a name through the data dir and the system font dirs alike; the
committed variable faces give the same axes, the same font ids at a
location and the same instanced advances.
"""

import os
import shutil

import pytest
import torch

from figdraw_tpu.text import typefaces as jax_tf
from figdraw_tpu_torch.text import typefaces as port_tf
from torch_reference import DEJAVU
from torch_twin import assert_runs_on_port, case_id, port_twin, run_twin, twin_cases

torch.set_num_threads(1)

CASES = twin_cases("test_text_registry")


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_port_twin(request, monkeypatch, case):
    assert_runs_on_port(port_twin(case[0]))
    run_twin(request, monkeypatch, case)


def test_ids_equal_the_jax_packages(tmp_path):
    serif = "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf"
    alias = tmp_path / "alias.ttf"
    shutil.copy(DEJAVU, alias)
    for path in (DEJAVU, serif, str(alias), port_tf.bundled_font_path()):
        assert port_tf.load_typeface(path) == jax_tf.load_typeface(path)
    tid = port_tf.load_typeface(DEJAVU)
    for size, ui, case, variations in ((12.0, 1.0, 0, ()), (15.0, 2.0, 1, ()),
                                       (13.5, 1.25, 3, ())):
        pf = port_tf.FigFont(typeface_id=tid, size=size, font_case=case)
        jf = jax_tf.FigFont(typeface_id=tid, size=size, font_case=case)
        assert port_tf.register_font(pf, ui) == jax_tf.register_font(jf, ui)
    for text, case in (("Hello World", 0), ("Hello World", 1), ("hello world", 3)):
        assert port_tf.apply_font_case(text, case) == jax_tf.apply_font_case(text, case)


def test_name_resolution_equals_the_jax_packages(tmp_path):
    """A file name in the data dir, an absolute path, a system font by file
    stem; the system discovery helpers list the same files."""
    data = tmp_path / "data"
    data.mkdir()
    shutil.copy(DEJAVU, data / "MyFace.ttf")
    old = (port_tf.fig_data_dir(), jax_tf.fig_data_dir())
    port_tf.set_fig_data_dir(str(data))
    jax_tf.set_fig_data_dir(str(data))
    try:
        for name in ("MyFace.ttf", DEJAVU, "DejaVuSerif", "dejavusansmono.ttf"):
            assert port_tf._resolve_path(name) == jax_tf._resolve_path(name)
        assert port_tf.find_system_font_file("DejaVuSans") == \
            jax_tf.find_system_font_file("DejaVuSans")
    finally:
        port_tf.set_fig_data_dir(old[0])
        jax_tf.set_fig_data_dir(old[1])
    assert port_tf.system_font_files() == jax_tf.system_font_files()
    for role in (port_tf.SystemFontRole.Sans, port_tf.SystemFontRole.Mono):
        names = port_tf.system_default_font_names(role)
        assert names == jax_tf.system_default_font_names(jax_tf.SystemFontRole(int(role)))
        assert (port_tf.find_system_font_file_from(names)
                == jax_tf.find_system_font_file_from(names))
    assert port_tf.supported_font_file_extensions() == jax_tf.supported_font_file_extensions()
    assert port_tf.text_backend_features() == jax_tf.text_backend_features()
    assert os.path.exists(port_tf.bundled_font_path())


@pytest.mark.parametrize("face", ["FigPortSans-VF.ttf", "FigPortSans-VF.otf"])
def test_variable_axes_equal_the_jax_packages(face):
    """A variable face's axes, its font ids at variation locations (the
    same hash of the same fields, in one process) and its instanced
    advances."""
    from figdraw_tpu.text import typeface_info as jax_info
    from figdraw_tpu_torch.text import typeface_info as port_info

    path = port_tf.bundled_font_path(face)
    tid = port_tf.load_typeface(path)
    assert tid == jax_tf.load_typeface(path)
    ptf, jtf = port_tf.get_typeface(tid), jax_tf.get_typeface(tid)
    assert ptf.is_variable() and jtf.is_variable()
    axes = [(a.tag, a.min_value, a.default_value, a.max_value)
            for a in port_info.get_typeface_info(tid).variation_axes]
    assert axes == [(a.tag, a.min_value, a.default_value, a.max_value)
                    for a in jax_info.get_typeface_info(tid).variation_axes]
    assert axes == [("wdth", 75.0, 100.0, 125.0), ("slnt", -12.0, 0.0, 0.0)]
    a = ptf.glyph_id(ord("a"))
    ids = set()
    for loc in ((), (("wdth", 75.0),), (("wdth", 90.0), ("slnt", -6.0))):
        pv = tuple(port_tf.FontVariation(t, v) for t, v in loc)
        jv = tuple(jax_tf.FontVariation(t, v) for t, v in loc)
        pid = port_tf.register_font(port_tf.FigFont(typeface_id=tid, size=15.0,
                                                    variations=pv))
        assert pid == jax_tf.register_font(jax_tf.FigFont(typeface_id=tid, size=15.0,
                                                          variations=jv))
        ids.add(pid)
        assert ptf.var_advance(a, pv) == jtf.var_advance(a, jv)
    assert len(ids) == 3
