"""The scene-building C ABI of the shared walk (native/flatten.cpp's
fd_renders_*, the retained recipe, the fill and border helpers) on the
port's own build of it: the twins of tests/test_native_scene_api.py, with
the port's Fig, nodesarray and borders, and the C examples compiled against
the port's `_build/` libraries. Beside them, at a small size, what
chip_smoke.py's capi phase holds on the card: a scene fed row by row through
the C ABI (chip_smoke.capi_scene), exported by native.export_tape and run by
FigRenderer.execute gives flatten's tape byte for byte and render_frame's
frame bit for bit: the headline scene, bench_text's scene through
fd_renders_add_text, and the retained recipe on bench_retained's grid.
"""

import ctypes
import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
import figdraw_tpu_torch as port
from figdraw_tpu import native as jax_native
from figdraw_tpu.nodesarray import FIG_DTYPE as JAX_FIG_DTYPE, GLYPH_DTYPE as JAX_GLYPH_DTYPE
from figdraw_tpu.nodesarray import OP_DTYPE as JAX_OP_DTYPE, TRECT_DTYPE as JAX_TRECT_DTYPE
from figdraw_tpu_torch import native
from figdraw_tpu_torch.nodesarray import FIG_DTYPE, GLYPH_DTYPE, OP_DTYPE, TRECT_DTYPE
from torch_reference import REPO, ensure_jax_native

# one intra-op thread: the suite runs a pytest-xdist worker per core
torch.set_num_threads(1)

NK_RECT = 2
NK_DRAWABLE = 3
DK_CIRCLE = 1
DK_BEZIER = 3
NF_CLIP = 1
NATIVE = os.path.join(REPO, "native")


def _ren(**kw):
    return port.FigRenderer(device="cpu", **kw)


def _row_ptr(row):
    return row.ctypes.data_as(ctypes.c_void_p)


def _export(lib, ctx):
    """(fields, modes) of a walked context, by fd_export."""
    n = lib.fd_quad_count(ctx)
    fields = np.zeros((max(n, 1), 68), np.float32)
    modes = np.zeros((max(n, 1), 2), np.int32)
    items = np.zeros((max(lib.fd_item_count(ctx), 1), 5), np.int32)
    rc = lib.fd_export(ctx, _row_ptr(fields), _row_ptr(modes), fields.shape[0],
                       _row_ptr(items), items.shape[0])
    assert rc == n
    return fields[:n], modes[:n]


def _flatten_capi(lib, build):
    """Run `build(lib, renders)` against a fresh context; (fields, modes)."""
    ctx = lib.fd_create(ctypes.c_float(1.0), ctypes.c_float(1.0), ctypes.c_float(1.2))
    renders = lib.fd_renders_new()
    try:
        build(lib, renders)
        lib.fd_flatten_renders(ctx, renders)
        return _export(lib, ctx)
    finally:
        lib.fd_renders_free(renders)
        lib.fd_destroy(ctx)


def _same_as_figdraw_tpu(build):
    """The rows of `build` on the port's build of flatten.cpp, which equal
    figdraw_tpu's build's byte for byte."""
    got = _flatten_capi(native.load(), build)
    want = _flatten_capi(ensure_jax_native(), build)
    assert got[0].tobytes() == want[0].tobytes() and np.array_equal(got[1], want[1])
    return got


def _assert_tape(tape, fields, modes):
    assert tape.count == fields.shape[0]
    assert np.array_equal(tape.fields[: tape.count].view(np.uint32), fields.view(np.uint32))
    assert np.array_equal(tape.modes[: tape.count], modes)


def test_capi_scene_matches_python_scene():
    def build(lib, renders):
        bg = np.zeros((), FIG_DTYPE)
        bg["kind"] = NK_RECT
        bg["box"] = (0, 0, 200, 150)
        lib.fd_fill_solid(_row_ptr(bg["fill"]), 240, 240, 240, 255)
        assert lib.fd_renders_add_root(renders, 0, _row_ptr(bg)) == 0

        clip = np.zeros((), FIG_DTYPE)
        clip["kind"] = NK_RECT
        clip["box"] = (10, 10, 100, 80)
        clip["corners"] = (9, 9, 9, 9)
        clip["flags"] = NF_CLIP
        lib.fd_fill_solid(_row_ptr(clip["fill"]), 200, 50, 50, 255)
        ci = lib.fd_renders_add_root(renders, 0, _row_ptr(clip))

        inner = np.zeros((), FIG_DTYPE)
        inner["kind"] = NK_RECT
        inner["box"] = (0, 0, 300, 300)
        start = np.array([255, 0, 0, 255], np.uint8)
        stop = np.array([0, 0, 255, 255], np.uint8)
        lib.fd_fill_linear2(_row_ptr(inner["fill"]), 1, _row_ptr(start), _row_ptr(stop))
        assert lib.fd_renders_add_child(renders, 0, ci, _row_ptr(inner)) == ci + 1

        d = np.zeros((), FIG_DTYPE)
        d["kind"] = NK_DRAWABLE
        d["box"] = (20, 20, 150, 100)
        d["draw_weight"] = 4.0
        lib.fd_fill_solid(_row_ptr(d["draw_stroke_fill"]), 10, 160, 40, 255)
        d["ops_start"] = lib.fd_renders_op_count(renders, 1)
        circle = np.zeros((), OP_DTYPE)
        circle["kind"] = DK_CIRCLE
        circle["data"][0:3] = (40, 40, 25)
        lib.fd_renders_add_op(renders, 1, _row_ptr(circle), None, 0)
        bez = np.zeros((), OP_DTYPE)
        bez["kind"] = DK_BEZIER
        pts = np.array([[0, 80], [60, 0], [140, 70]], np.float32)
        lib.fd_renders_add_op(renders, 1, _row_ptr(bez), _row_ptr(pts), pts.shape[0])
        d["ops_count"] = 2
        lib.fd_renders_add_root(renders, 1, _row_ptr(d))

    c_fields, c_modes = _same_as_figdraw_tpu(build)

    from figdraw_tpu_torch import (
        Fig, FigFlags, FigKind, RenderStroke, fill, new_renders, rect, rgba, vec2,
    )
    from figdraw_tpu_torch.fill import FillGradientAxis, linear
    from figdraw_tpu_torch.nodes import drawable_bezier, drawable_circle
    from figdraw_tpu_torch.nodesarray import from_renders

    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, 200, 150),
                            fill=fill(rgba(240, 240, 240, 255))))
    clip = renders.add_root(0, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(10, 10, 100, 80),
        corners=(9, 9, 9, 9), flags=FigFlags.NfClipContent,
        fill=fill(rgba(200, 50, 50, 255))))
    renders.add_child(0, clip, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(0, 0, 300, 300),
        fill=linear(rgba(255, 0, 0, 255), rgba(0, 0, 255, 255), axis=FillGradientAxis.fgaY)))
    renders.add_root(1, Fig(
        kind=FigKind.nkDrawable, screen_box=rect(20, 20, 150, 100),
        draw_stroke=RenderStroke(weight=4.0, fill=fill(rgba(10, 160, 40, 255))),
        draw_ops=(drawable_circle(vec2(40, 40), 25.0),
                  drawable_bezier([vec2(0, 80), vec2(60, 0), vec2(140, 70)]))))
    _assert_tape(_ren(atlas_size=64).flatten(from_renders(renders), vec2(200, 150)),
                 c_fields, c_modes)


def _border_rows_c(lib, style, box, corners, p1=0.0, p2=0.0, off=0.0):
    if lib.fd_border_ops.argtypes is None:  # figdraw_tpu's load leaves it unbound
        lib.fd_border_ops.argtypes = [ctypes.c_int] + [ctypes.c_double] * 4 + [
            ctypes.c_void_p] + [ctypes.c_double] * 3 + [ctypes.c_void_p, ctypes.c_int]
    cr = np.asarray(corners, dtype=np.float64)
    cap = 4096
    buf = np.zeros(cap, dtype=OP_DTYPE)
    n = lib.fd_border_ops(style, box.x, box.y, box.w, box.h, _row_ptr(cr), p1, p2, off,
                          _row_ptr(buf), cap)
    assert 0 <= n <= cap
    return buf[:n]


def _border_rows_py(ops):
    from figdraw_tpu_torch.nodes import DrawableKind

    rows = np.zeros(len(ops), dtype=OP_DTYPE)
    for k, op in enumerate(ops):
        rows[k]["kind"] = int(op.kind)
        if op.kind == DrawableKind.dkLine:
            rows[k]["data"][0:4] = (op.a.x, op.a.y, op.b.x, op.b.y)
        elif op.kind == DrawableKind.dkCircle:
            rows[k]["data"][0:3] = (op.center.x, op.center.y, op.radius)
        elif op.kind == DrawableKind.dkArc:
            rows[k]["data"][0:5] = (op.arc_center.x, op.arc_center.y, op.arc_radius,
                                    op.start_angle, op.sweep_angle)
    return rows


def test_capi_border_ops_bit_identical():
    """fd_border_ops on the port's build equals the port's borders.py bit
    for bit: 120 seeded boxes, radii and patterns over the three styles,
    compared as OP_DTYPE rows."""
    from figdraw_tpu_torch import rect
    from figdraw_tpu_torch.borders import (
        drawable_dashed_rounded_rect_border_ops, drawable_dotted_rounded_rect_border_ops,
        drawable_rounded_rect_border_ops,
    )

    lib = native.load()
    rng = random.Random(8080)
    for _ in range(120):
        box = rect(rng.uniform(-20, 50), rng.uniform(-20, 50),
                   rng.uniform(0.0, 300), rng.uniform(0.0, 300))
        corners = tuple(rng.uniform(0, 60) for _ in range(4))
        style = rng.randint(0, 2)
        p1, p2, off = rng.uniform(0, 12), rng.uniform(0, 8), rng.uniform(-9, 20)
        if style == 0:
            want = _border_rows_py(drawable_rounded_rect_border_ops(box, corners))
        elif style == 1:
            want = _border_rows_py(drawable_dashed_rounded_rect_border_ops(
                box, corners, p1, p2, off))
        else:
            want = _border_rows_py(drawable_dotted_rounded_rect_border_ops(
                box, corners, p1, p2, off))
        got = _border_rows_c(lib, style, box, corners, p1, p2, off)
        assert len(got) == len(want), (style, box, corners, p1, p2, off)
        assert got.tobytes() == want.tobytes(), (style, box, corners)


def test_capi_dashed_border_scene_matches_python():
    from figdraw_tpu_torch import new_renders, rect, rgba, vec2
    from figdraw_tpu_torch.borders import fig_dashed_rounded_rect_border
    from figdraw_tpu_torch.fill import fill
    from figdraw_tpu_torch.nodesarray import from_renders

    box = rect(20, 15, 140, 90)
    corners = (12, 6, 0, 18)
    weight, dash, gap, off = 3.0, 8.0, 5.0, 2.5

    def build(lib, renders):
        half = weight * 0.5
        rows = _border_rows_c(lib, 1, rect(half, half, box.w, box.h), corners, dash, gap, off)
        d = np.zeros((), FIG_DTYPE)
        d["kind"] = NK_DRAWABLE
        d["box"] = (box.x - half, box.y - half, box.w + weight, box.h + weight)
        d["draw_weight"] = weight
        d["draw_cap"] = 2  # scButt
        lib.fd_fill_solid(_row_ptr(d["draw_stroke_fill"]), 30, 90, 200, 255)
        d["ops_start"] = lib.fd_renders_op_count(renders, 0)
        for k in range(len(rows)):
            lib.fd_renders_add_op(renders, 0, _row_ptr(rows[k : k + 1]), None, 0)
        d["ops_count"] = len(rows)
        lib.fd_renders_add_root(renders, 0, _row_ptr(d))

    c_fields, c_modes = _same_as_figdraw_tpu(build)
    renders = new_renders()
    renders.add_root(0, fig_dashed_rounded_rect_border(
        box, corners, fill(rgba(30, 90, 200, 255)), weight, dash, gap, off))
    _assert_tape(_ren(atlas_size=64).flatten(from_renders(renders), vec2(220, 160)),
                 c_fields, c_modes)


def test_capi_rejects_bad_parent():
    lib = native.load()
    renders = lib.fd_renders_new()
    try:
        fig = np.zeros((), FIG_DTYPE)
        fig["kind"] = NK_RECT
        assert lib.fd_renders_add_child(renders, 0, 7, _row_ptr(fig)) == -1
    finally:
        lib.fd_renders_free(renders)


def _gcc(tmp_path, name, libs, *defs):
    """native/examples/<name>.c built against the port's libraries, linked
    by their full paths (utils.gxx names them lib<name>_<hash>.so)."""
    if shutil.which("gcc") is None:
        raise RuntimeError("gcc is needed to build the C examples")
    exe = str(tmp_path / name)
    subprocess.run(["gcc", os.path.join(NATIVE, "examples", name + ".c"), "-I", NATIVE,
                    *defs, *libs, f"-Wl,-rpath,{os.path.dirname(libs[0])}", "-o", exe],
                   check=True, capture_output=True)
    return exe


def test_c_host_demo_compiles_and_runs(tmp_path):
    offs = {name: FIG_DTYPE.fields[name][1]
            for name in ("ops_start", "draw_weight", "draw_stroke_fill")}
    exe = _gcc(tmp_path, "scene_demo", [native._build()],
               *(f"-DFD_OFF_{k.upper()}={v}" for k, v in offs.items()))
    out = subprocess.run([exe], check=True, capture_output=True, text=True)
    lines = dict(line.split("=") for line in out.stdout.split())
    assert int(lines["quads"]) >= 3
    assert int(lines["patch_ok"]) == 1


def test_layout_header_is_current():
    """native/figdraw_layout.h equals what native/gen_layout.py generates
    from figdraw_tpu's dtypes and from the port's, whose dtypes equal
    figdraw_tpu's field for field."""
    import importlib.util
    import re

    for port_dt, jax_dt in ((FIG_DTYPE, JAX_FIG_DTYPE), (OP_DTYPE, JAX_OP_DTYPE),
                            (GLYPH_DTYPE, JAX_GLYPH_DTYPE), (TRECT_DTYPE, JAX_TRECT_DTYPE)):
        assert port_dt.descr == jax_dt.descr and port_dt.itemsize == jax_dt.itemsize
    gen = os.path.join(NATIVE, "gen_layout.py")
    spec = importlib.util.spec_from_file_location("gen_layout", gen)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(NATIVE, "figdraw_layout.h")) as fh:
        header = fh.read()
    assert mod.generate() == header
    with open(gen) as fh:
        src = re.sub(r"from figdraw_tpu\.", "from figdraw_tpu_torch.", fh.read())
    assert "figdraw_tpu_torch.nodesarray" in src
    ported = {"__name__": "gen_layout_port", "__file__": gen}
    exec(compile(src, gen, "exec"), ported)
    assert ported["generate"]() == header


def test_shim_demo_compiles_and_runs(tmp_path):
    from figdraw_tpu_torch.text import native_typeset
    from figdraw_tpu_torch.text.native_pack import save_font_pack
    from figdraw_tpu_torch.text.typefaces import bundled_font_path, load_typeface

    exe = _gcc(tmp_path, "shim_demo", [native._build(), native_typeset.build()])
    pack = str(tmp_path / "dejavu.fdtp")
    save_font_pack(load_typeface(bundled_font_path()), pack)
    out = subprocess.run([exe, pack], check=True, capture_output=True, text=True)
    lines = dict(kv.split("=") for line in out.stdout.splitlines() for kv in line.split())
    assert int(lines["quads"]) > 0
    assert int(lines["patch_ok"]) == 1
    assert int(lines["label_glyphs"]) > 0
    assert int(lines["dashed_idx"]) >= 0
    assert int(lines["dotted_idx"]) > int(lines["dashed_idx"])


def test_capi_retained_patch_matches_full_reflatten():
    """fd_flatten_renders_spans + fd_renders_set_fig + fd_flatten_renders_root
    on the port's build: the patched tape equals a full re-flatten."""
    lib = native.load()
    renders = lib.fd_renders_new()
    ctx = lib.fd_create(ctypes.c_float(1.0), ctypes.c_float(1.0), ctypes.c_float(1.2))
    scratch = lib.fd_create(ctypes.c_float(1.0), ctypes.c_float(1.0), ctypes.c_float(1.2))

    def reset(c):
        lib.fd_reset(c, ctypes.c_float(1.0), ctypes.c_float(1.0), ctypes.c_float(1.2))

    try:
        for i in range(3):
            fig = np.zeros((), FIG_DTYPE)
            fig["kind"] = NK_RECT
            fig["box"] = (10 + 30 * i, 10, 24, 24)
            fig["corners"] = (4, 4, 4, 4)
            lib.fd_fill_solid(_row_ptr(fig["fill"]), 40 * (i + 1), 80, 120, 255)
            assert lib.fd_renders_add_root(renders, 0, _row_ptr(fig)) == i
        top = np.zeros((), FIG_DTYPE)
        top["kind"] = NK_RECT
        top["box"] = (0, 60, 100, 10)
        lib.fd_fill_solid(_row_ptr(top["fill"]), 9, 9, 9, 255)
        lib.fd_renders_add_root(renders, 2, _row_ptr(top))

        n_roots = lib.fd_renders_root_count(renders)
        assert n_roots == 4
        spans = np.zeros((n_roots, 2), np.int32)
        reserve = 2
        assert lib.fd_flatten_renders_spans(ctx, renders, _row_ptr(spans), n_roots,
                                            reserve) == n_roots
        assert lib.fd_flatten_renders_spans(ctx, renders, _row_ptr(spans), 1, 0) == -1
        reset(ctx)
        assert lib.fd_flatten_renders_spans(ctx, renders, _row_ptr(spans), n_roots,
                                            reserve) == n_roots
        fields, modes = _export(lib, ctx)
        assert (spans[:, 1] - spans[:, 0] >= reserve).all()

        edit = np.zeros((), FIG_DTYPE)
        edit["kind"] = NK_RECT
        edit["box"] = (40, 10, 24, 24)
        edit["corners"] = (9, 9, 0, 0)
        lib.fd_fill_solid(_row_ptr(edit["fill"]), 250, 50, 10, 255)
        assert lib.fd_renders_set_fig(renders, 0, 1, _row_ptr(edit)) == 0
        assert lib.fd_renders_set_fig(renders, 0, 99, _row_ptr(edit)) == -1
        assert lib.fd_renders_set_fig(renders, 7, 0, _row_ptr(edit)) == -1

        got = lib.fd_flatten_renders_root(scratch, renders, 0, 1)
        span_len = int(spans[1, 1] - spans[1, 0])
        assert 0 < got <= span_len
        assert lib.fd_mask_count(scratch) == 0
        assert lib.fd_item_count(scratch) <= 1
        lib.fd_pad_rows(scratch, span_len - got)
        pf, pm = _export(lib, scratch)
        assert pf.shape[0] == span_len
        patched_f, patched_m = fields.copy(), modes.copy()
        patched_f[spans[1, 0] : spans[1, 1]] = pf
        patched_m[spans[1, 0] : spans[1, 1]] = pm

        reset(ctx)
        lib.fd_flatten_renders_spans(ctx, renders, _row_ptr(spans), n_roots, reserve)
        rf, rm = _export(lib, ctx)
        assert np.array_equal(patched_f, rf)
        assert np.array_equal(patched_m, rm)

        assert lib.fd_flatten_renders_root(scratch, renders, 0, 99) == -1
        assert lib.fd_flatten_renders_root(scratch, renders, 5, 0) == -1
    finally:
        lib.fd_renders_free(renders)
        lib.fd_destroy(ctx)
        lib.fd_destroy(scratch)


def test_capi_text_node_matches_python_scene():
    """fd_renders_add_text with glyph and decoration rows, the atlas, glyph
    offsets and white texel set from the port renderer: the same rows as
    the renderer's own walk."""
    from figdraw_tpu_torch import Fig, FigKind, fill, new_renders, rect, rgba, vec2
    from figdraw_tpu_torch.basics import fig_ui_scale
    from figdraw_tpu_torch.nodesarray import from_renders
    from figdraw_tpu_torch.text.layout import typeset
    from figdraw_tpu_torch.text.typefaces import FigFont, bundled_font_path, load_typeface

    tid = load_typeface(bundled_font_path())
    f = FigFont(typeface_id=tid, size=16.0, underline=True)
    arr = typeset(vec2(140, 24), [(f, fill(rgba(20, 20, 40, 255)), "AV fi")])
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, 160, 60),
                            fill=fill(rgba(250, 250, 250, 255))))
    renders.add_root(0, Fig(kind=FigKind.nkText, screen_box=rect(8, 8, 140, 24),
                            text_layout=arr))
    scene = from_renders(renders)
    ren = _ren(atlas_size=128)
    py_tape = ren.flatten(scene, vec2(160, 60))
    assert py_tape.count > 3

    lst = scene.layers[0]
    glyphs, trects = lst.text_view()
    lib = native.load()
    (ids, levels, rects_), edge, (u, v) = ren._walk_atlas()
    gkeys, goffs = ren._glyph_offsets_pack()
    ctx = lib.fd_create(ctypes.c_float(fig_ui_scale()), ctypes.c_float(1.0),
                        ctypes.c_float(1.2))
    rend = lib.fd_renders_new()
    try:
        lib.fd_set_text_config(ctx, 0, 0, 0)
        lib.fd_set_atlas(ctx, _row_ptr(ids), _row_ptr(levels), _row_ptr(rects_),
                         ids.shape[0], ctypes.c_float(float(edge)))
        lib.fd_set_glyph_offsets(ctx, _row_ptr(gkeys), _row_ptr(goffs), gkeys.shape[0])
        lib.fd_set_white_uv(ctx, ctypes.c_double(u), ctypes.c_double(v))
        assert lib.fd_renders_add_root(rend, 0, _row_ptr(np.ascontiguousarray(lst.nodes[0]))) == 0
        assert lib.fd_renders_glyph_count(rend, 0) == 0
        assert lib.fd_renders_trect_count(rend, 0) == 0
        g, t = np.ascontiguousarray(glyphs), np.ascontiguousarray(trects)
        lib.fd_renders_add_text(rend, 0, _row_ptr(g), g.shape[0], _row_ptr(t), t.shape[0])
        assert lib.fd_renders_glyph_count(rend, 0) == g.shape[0]
        lib.fd_renders_add_root(rend, 0, _row_ptr(np.ascontiguousarray(lst.nodes[1])))
        lib.fd_flatten_renders(ctx, rend)
        fields, modes = _export(lib, ctx)
    finally:
        lib.fd_renders_free(rend)
        lib.fd_destroy(ctx)
    _assert_tape(py_tape, fields, modes)


# --- chip_smoke's capi legs at a small size ---------------------------------------


def _capi_frame(lib, scene, ren, w, h):
    """The C-built tape against flatten's (byte for byte), its execute
    frame against render_frame's on the same renderer (bit for bit)."""
    tape = chip_smoke.capi_tape(lib, scene, ren, w, h)
    want = ren.flatten(scene, port.vec2(w, h))
    assert chip_smoke.same_tape(tape, want)
    assert torch.equal(ren.execute(tape), ren.render_frame(scene, port.vec2(w, h)))
    return tape


def test_capi_headline_row_by_row():
    from figdraw_tpu_torch.scenes import make_render_tree_array

    lib = native.load()
    for frame in (0, 7):
        scene = make_render_tree_array(384, 216, frame, copies=10)
        tape = _capi_frame(lib, scene, _ren(), 384, 216)
        assert tape.count == 76 and [type(i).__name__ for i in tape.items] == [
            "DrawItem", "BlurItem", "DrawItem"]


def test_capi_headline_with_drawables_and_clips():
    """Ops, bezier points and child rows through capi_scene: the example
    scenes' arrays (drawable beziers, dashed borders, clipped layers)."""
    from figdraw_tpu_torch.nodesarray import from_renders
    from figdraw_tpu_torch.scenes import (
        make_dashed_borders_scene, make_drawable_beziers_scene, make_layers_clip_scene,
    )

    lib = native.load()
    for make, (w, h) in ((make_drawable_beziers_scene, (760, 560)),
                         (make_dashed_borders_scene, (820, 560)),
                         (make_layers_clip_scene, (900, 560))):
        scene = from_renders(make())
        tape = _capi_frame(lib, scene, _ren(), w, h)
        assert tape.count > 0


def test_capi_text_scene_row_by_row():
    from figdraw_tpu_torch import fill, rgba
    from figdraw_tpu_torch.scenes import make_text_scene
    from figdraw_tpu_torch.text.typefaces import bundled_font_path, load_typeface

    tid = load_typeface(bundled_font_path())
    scene, n_glyphs = make_text_scene(tid, fill(rgba(20, 20, 30, 255)), 0, w=400, h=100,
                                      lines=4)
    ren = _ren(atlas_size=512)
    ren.flatten(scene, port.vec2(400, 100))  # the glyphs into the atlas
    tape = _capi_frame(native.load(), scene, ren, 400, 100)
    assert n_glyphs > 100 and tape.count > 100


def test_capi_retained_recipe_300_boxes():
    """bench_retained's grid of 300 boxes through the C retained recipe
    (chip_smoke.capi_snapshot / capi_patch): 8 dirty roots a frame, the
    patched tape equals a full re-flatten byte for byte each frame, and its
    frame the full one's bit for bit."""
    from figdraw_tpu_torch.scenes import build_grid

    lib = native.load()
    grid, boxes = build_grid(300, 640, 360)
    lst = grid[0]
    rows = lst.nodes[: lst.count].copy()
    pos_of = {int(r): p for p, r in enumerate(lst.root_ids)}
    ren = _ren()
    handle = chip_smoke.capi_scene(lib, grid)
    try:
        snap, spans = chip_smoke.capi_snapshot(lib, handle, ren, 640, 360)
        assert snap.count == 301 * (1 + chip_smoke.CAPI_RESERVE)
        for f in range(3):
            dirty = []
            for k in range(8):
                b = boxes[(f * 8 + k) % len(boxes)]
                x, y, w, h = rows["box"][b]
                rows["box"][b] = (x, (y + 3 + f) % 360, w, h)
                rows["fill"]["c0"][b] = ((b * 13 + f) % 255, 120, 220, 180)
                assert lib.fd_renders_set_fig(handle, 0, b, _row_ptr(rows[b : b + 1])) == 0
                dirty.append((0, pos_of[b], pos_of[b]))
            chip_smoke.capi_patch(lib, handle, ren, snap, spans, dirty)
            full, full_spans = chip_smoke.capi_snapshot(lib, handle, ren, 640, 360)
            assert chip_smoke.same_tape(snap, full) and np.array_equal(spans, full_spans)
        got = ren.execute(chip_smoke.tape_copy(snap))
        assert torch.equal(got, _ren().execute(full))
        # the array edited the same way renders the same frame
        for b in boxes[:24]:
            lst.nodes[b] = rows[b]
        assert torch.equal(got, _ren().render_frame(grid, port.vec2(640, 360)))
    finally:
        lib.fd_renders_free(handle)


def test_capi_patch_refuses_a_root_that_outgrows_its_span():
    from figdraw_tpu_torch.scenes import build_grid

    lib = native.load()
    grid, boxes = build_grid(20, 320, 180)
    ren = _ren()
    handle = chip_smoke.capi_scene(lib, grid)
    try:
        snap, spans = chip_smoke.capi_snapshot(lib, handle, ren, 320, 180, reserve=0)
        row = grid[0].nodes[boxes[3] : boxes[3] + 1].copy()
        row["stroke_weight"] = 2.0  # a border adds a quad
        row["stroke_fill"]["c0"] = (0, 0, 0, 255)
        assert lib.fd_renders_set_fig(handle, 0, boxes[3], _row_ptr(row)) == 0
        pos = list(grid[0].root_ids).index(boxes[3])
        with pytest.raises(ValueError, match="for a span of 1"):
            chip_smoke.capi_patch(lib, handle, ren, snap, spans, [(0, pos, pos)])
    finally:
        lib.fd_renders_free(handle)


def test_export_tape_of_an_empty_walk():
    lib = native.load()
    ctx = lib.fd_create(ctypes.c_float(1.0), ctypes.c_float(1.0), ctypes.c_float(1.2))
    try:
        tape = native.export_tape(ctx, 64, 32)
    finally:
        lib.fd_destroy(ctx)
    assert tape.count == 0 and tape.items == [] and tape.clear_color is None
    frame = _ren().execute(tape)
    assert tuple(frame.shape) == (32, 64, 4) and not frame.any()


def test_port_binds_every_entry_point_figdraw_tpu_binds():
    """Every C function figdraw_tpu/native.py gives a signature, the port's
    load() gives one too (fd_border_ops included, whose signature
    figdraw_tpu's test sets)."""
    import inspect
    import re

    names = set(re.findall(r"lib\.(fd_\w+)\.(?:argtypes|restype)",
                           inspect.getsource(jax_native._load))) | {"fd_border_ops"}
    lib = native.load()
    assert len(names) >= 45
    assert not [n for n in sorted(names) if getattr(lib, n).argtypes is None]
