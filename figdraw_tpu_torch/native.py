"""ctypes bridge to the native flattener (native/flatten.cpp, shared with
figdraw_tpu and unchanged).

The library is built at first use with g++ into this package's `_build/`,
keyed by a hash of the source and flags. A RendersArray always takes this
walk: a missing toolchain raises instead of falling back to the Python
walk (render.py), which renders trees.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .nodesarray import FIG_DTYPE, GLYPH_DTYPE, OP_DTYPE, TRECT_DTYPE, RendersArray
from .ops.layout import (
    PACKED_WIDTH, QF_BBOX_X0, QF_BBOX_X1, QF_BBOX_Y0, QF_BBOX_Y1, QF_INV_A,
    QF_ORG_X, QF_ORG_Y, QF_WIDTH, pack_fields_np,
)
from .plan import ROLLED_THRESHOLD, TILE_H, TILE_W, bucket, fill_meta, meta_rows
from .tape import BlurItem, ClearMaskItem, DrawItem, Tape
from .utils import gxx

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "flatten.cpp")
# -ffp-contract=off: the walk and the scene animator are pinned bit-identical
# to their numpy twins in figdraw_tpu, and numpy never fuses multiply-add
_CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-pthread",
              "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def _build() -> str:
    """Compile the walk into the package's _build/ (utils.gxx); returns the library
    path. Raises CalledProcessError with the compiler's output."""
    return gxx.build(_SRC, "figdraw_flatten", _CXX_FLAGS)


def load() -> ctypes.CDLL:
    """The walk library, built and bound at first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fd_create.restype = vp
        lib.fd_create.argtypes = [f, f, f]
        lib.fd_reset.argtypes = [vp, f, f, f]
        lib.fd_reset.restype = None
        lib.fd_flatten_layer.argtypes = [vp, vp, i, vp, i]
        lib.fd_flatten_layer.restype = None
        lib.fd_flatten_layer_spans.argtypes = [vp, vp, i, vp, i, vp]
        lib.fd_flatten_layer_spans.restype = None
        lib.fd_pad_rows.argtypes = [vp, i]
        lib.fd_pad_rows.restype = None
        lib.fd_set_geometry.argtypes = [vp, vp, i, vp, i]
        lib.fd_set_geometry.restype = None
        lib.fd_set_text_geometry.argtypes = [vp, vp, i, vp, i]
        lib.fd_set_text_geometry.restype = None
        lib.fd_set_text_config.argtypes = [vp, i, i, i]
        lib.fd_set_text_config.restype = None
        lib.fd_set_glyph_offsets.argtypes = [vp, vp, vp, i]
        lib.fd_set_glyph_offsets.restype = None
        lib.fd_set_white_uv.argtypes = [vp, ctypes.c_double, ctypes.c_double]
        lib.fd_set_white_uv.restype = None
        lib.fd_set_atlas.argtypes = [vp, vp, vp, vp, i, f]
        lib.fd_set_atlas.restype = None
        for name in ("fd_quad_count", "fd_item_count", "fd_mask_count",
                     "fd_clear_count"):
            getattr(lib, name).argtypes = [vp]
            getattr(lib, name).restype = i
        lib.fd_tape_info.argtypes = [vp, vp]
        lib.fd_tape_info.restype = None
        lib.fd_export_items.argtypes = [vp, vp, i]
        lib.fd_export_items.restype = i
        lib.fd_export_combo_packed.argtypes = [vp, vp, i, i]
        lib.fd_export_combo_packed.restype = i
        lib.fd_export_mega_packed.argtypes = [vp, vp, i, i]
        lib.fd_export_mega_packed.restype = i
        lib.fd_density.argtypes = [vp, i, i, vp]
        lib.fd_density.restype = None
        lib.fd_cull_saturated.argtypes = [vp, f, f]
        lib.fd_cull_saturated.restype = i
        lib.fd_scene_animate.argtypes = [
            vp, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
        ] + [vp] * 8
        lib.fd_scene_animate.restype = i
        _bind_scene_api(lib)
        for name, dtype in (("fd_fig_struct_size", FIG_DTYPE),
                            ("fd_op_struct_size", OP_DTYPE),
                            ("fd_glyph_struct_size", GLYPH_DTYPE),
                            ("fd_trect_struct_size", TRECT_DTYPE)):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
            size = getattr(lib, name)()
            if size != dtype.itemsize:
                raise RuntimeError(
                    f"{name}: native struct is {size} B, numpy dtype "
                    f"{dtype.itemsize} B"
                )
        _lib = lib
        return _lib


def _bind_scene_api(lib) -> None:
    """The C ABI for external hosts (native/figdraw_flatten.h): the
    context's destroy and exports, the scene-building calls fd_renders_*,
    the retained recipe, the fill helpers and the border op generator, as
    figdraw_tpu/native.py binds them. A host builds a scene row by row with
    them and export_tape hands the walked tape to FigRenderer.execute."""
    vp, i, u8, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint8, ctypes.c_double
    signatures = {
        "fd_destroy": ([vp], None),
        "fd_export": ([vp, vp, vp, i, vp, i], i),
        "fd_export_combo": ([vp, vp, i, i], i),
        "fd_export_mega": ([vp, vp, i, i], i),
        "fd_renders_new": ([], vp),
        "fd_renders_free": ([vp], None),
        "fd_renders_add_root": ([vp, i, vp], i),
        "fd_renders_add_child": ([vp, i, i, vp], i),
        "fd_renders_op_count": ([vp, i], i),
        "fd_renders_add_op": ([vp, i, vp, vp, i], i),
        "fd_renders_glyph_count": ([vp, i], i),
        "fd_renders_trect_count": ([vp, i], i),
        "fd_renders_add_text": ([vp, i, vp, i, vp, i], i),
        "fd_renders_root_count": ([vp], i),
        "fd_renders_set_fig": ([vp, i, i, vp], i),
        "fd_flatten_renders": ([vp, vp], None),
        "fd_flatten_renders_spans": ([vp, vp, vp, i, i], i),
        "fd_flatten_renders_root": ([vp, vp, i, i], i),
        "fd_fill_solid": ([vp, u8, u8, u8, u8], None),
        "fd_fill_linear2": ([vp, i, vp, vp], None),
        "fd_fill_linear3": ([vp, i, vp, vp, vp, u8], None),
        "fd_border_ops": ([i, d, d, d, d, vp, d, d, d, vp, i], i),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def _ptr(arr: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(arr.ctypes.data)


def export_tape(ctx, frame_w: float, frame_h: float, clear_color=None) -> Tape:
    """The context's walked tape as a Tape of logical rows (fd_export;
    figdraw_tpu.native._export_tape): fields, modes, pass items, the mask
    count and fd_density's tile summary. FigRenderer.execute plans it as it
    plans a walked tape (plan.pack_walked_tape), so a scene a C host built
    through fd_renders_* and walked with fd_flatten_renders renders on the
    port's kernels. ctx: a context from fd_create, walked. clear_color: the
    frame's (r, g, b, a) clear, or None to draw over the last frame."""
    lib = load()
    n_quads = lib.fd_quad_count(ctx)
    n_items = lib.fd_item_count(ctx)
    tape = Tape(capacity=max(n_quads, 1))
    items = np.zeros((max(n_items, 1), 5), dtype=np.int32)
    rc = lib.fd_export(ctx, _ptr(tape.fields), _ptr(tape.modes), tape.fields.shape[0],
                       _ptr(items), items.shape[0])
    if rc != n_quads:
        raise RuntimeError(f"fd_export wrote {rc} of {n_quads} quads")
    tape.count = n_quads
    tape.mask_count = lib.fd_mask_count(ctx)
    tape.frame_size = (frame_w, frame_h)
    tape.clear_color = clear_color
    for word, target, start, end, rbits in items[:n_items]:
        kind = word & 0xFF  # draw items carry the atlas and backdrop bits 8 and 9
        if kind == 0:
            tape.items.append(DrawItem(target=int(target), start=int(start), end=int(end)))
        elif kind == 1:
            tape.items.append(BlurItem(radius=float(np.int32(rbits).view(np.float32))))
        else:
            tape.items.append(ClearMaskItem(index=int(target)))
    dens = np.zeros(2, np.float32)
    lib.fd_density(ctx, TILE_W, TILE_H, _ptr(dens))
    tape.tile_density = (float(dens[0]), float(dens[1]))
    return tape


def _layer_arrays(lst):
    """Contiguous walk arrays for one render list."""
    nodes = np.ascontiguousarray(lst.nodes[: lst.count])
    roots = np.asarray(lst.root_ids, dtype=np.int32)
    ops, points = lst.ops_view()
    glyphs, trects = lst.text_view()
    return (nodes, roots, np.ascontiguousarray(ops),
            np.ascontiguousarray(points), np.ascontiguousarray(glyphs),
            np.ascontiguousarray(trects))


def pack_atlas_entries(entries: dict):
    """Sorted (id, level) parallel arrays for fd_set_atlas
    (native.pack_atlas_entries): integer keys are level-0 entries, (id,
    level) tuple keys are mips; other keys (the white texel's string) are
    skipped. Returns (ids (n,) i64, levels (n,) i32, rects (n, 4) f32)."""
    rows = []
    for key, rect in entries.items():
        if isinstance(key, tuple) and len(key) == 2 and isinstance(key[0], int):
            rows.append((key[0], key[1], rect))
        elif isinstance(key, int):
            rows.append((key, 0, rect))
    rows.sort(key=lambda r: (r[0], r[1]))
    n = len(rows)
    ids = np.asarray([r[0] for r in rows], dtype=np.int64)
    levels = np.asarray([r[1] for r in rows], dtype=np.int32)
    rects = (np.asarray([r[2] for r in rows], dtype=np.float32).reshape(n, 4)
             if n else np.zeros((0, 4), np.float32))
    return ids, levels, rects


def _set_walk_config(lib, ctx, atlas, text=None) -> None:
    """Context setup shared by the walks (native._set_walk_config). atlas:
    (pack_atlas_entries' arrays, atlas edge, white texel uv) or None;
    without it image nodes find no entry and emit nothing, and filled quads
    sample uv (0, 0). text: (text config, glyph offsets) or None (all text
    flags off, no offsets): the config is the renderer's (lcd filtering,
    subpixel positioning, subpixel glyph variants), the offsets its sorted
    (keys (n,) i64, offsets (n, 2) f32) raster offsets per glyph key, or
    None; a text node's glyphs find their atlas entries by key."""
    config, offsets = text if text is not None else ((False, False, False), None)
    lib.fd_set_text_config(ctx, int(config[0]), int(config[1]), int(config[2]))
    if offsets is not None:
        keys, offs = offsets
        lib.fd_set_glyph_offsets(ctx, _ptr(keys), _ptr(offs), keys.shape[0])
    white_uv = (0.0, 0.0)
    if atlas is not None:
        (ids, levels, rects), size, white_uv = atlas
        lib.fd_set_atlas(ctx, _ptr(ids), _ptr(levels), _ptr(rects),
                         ids.shape[0], ctypes.c_float(float(size)))
    lib.fd_set_white_uv(ctx, ctypes.c_double(white_uv[0]),
                        ctypes.c_double(white_uv[1]))


def _set_layer_geometry(lib, ctx, lst):
    """Hand one layer's side arrays to the context; returns (nodes, roots),
    which the caller keeps alive through its walk."""
    nodes, roots, ops, points, glyphs, trects = _layer_arrays(lst)
    lib.fd_set_geometry(
        ctx, _ptr(ops), ops.shape[0], _ptr(points), points.shape[0]
    )
    lib.fd_set_text_geometry(
        ctx, _ptr(glyphs), glyphs.shape[0], _ptr(trects), trects.shape[0]
    )
    return nodes, roots


def _run_walk(lib, ctx, renders, atlas, spans_out=None, reserves=None,
              text=None) -> None:
    """Context setup + layer walk in ZLevel order (native._run_walk). atlas,
    text: as _set_walk_config's. spans_out: a dict to fill with (lvl,
    root_node_idx) -> (qs, qe), each root's rows of the tape (the serial
    walk, fd_flatten_layer_spans). reserves: (lvl, root_node_idx) -> n; each
    such root's span ends in n inert rows (fd_pad_rows), so an edit that
    changes its quad count can still patch in place."""
    _set_walk_config(lib, ctx, atlas, text)
    for lvl, lst in renders.sorted_pairs():
        nodes, roots = _set_layer_geometry(lib, ctx, lst)
        if spans_out is None:
            lib.fd_flatten_layer(
                ctx, _ptr(nodes), nodes.shape[0], _ptr(roots), roots.shape[0]
            )
        elif reserves and any((lvl, int(r)) in reserves for r in roots):
            # one call a root, so a reserved root can pad in place; the
            # context keeps its runs open and its mask numbering, so apart
            # from the pads the tape is the one-call walk's byte for byte
            one = np.empty((1, 2), np.int32)
            for pos in range(roots.shape[0]):
                rid = int(roots[pos])
                lib.fd_flatten_layer_spans(
                    ctx, _ptr(nodes), nodes.shape[0],
                    _ptr(roots[pos : pos + 1]), 1, _ptr(one))
                pad = int(reserves.get((lvl, rid), 0))
                if pad > 0:
                    lib.fd_pad_rows(ctx, pad)
                spans_out[(lvl, rid)] = (int(one[0, 0]), int(one[0, 1]) + pad)
        else:
            spans = np.empty((roots.shape[0], 2), np.int32)
            lib.fd_flatten_layer_spans(
                ctx, _ptr(nodes), nodes.shape[0], _ptr(roots), roots.shape[0],
                _ptr(spans))
            for pos in range(roots.shape[0]):
                spans_out[(lvl, int(roots[pos]))] = (
                    int(spans[pos, 0]), int(spans[pos, 1]))


def _host_cull(lib, ctx, frame_w, frame_h, pixel_scale) -> int:
    """Translucent-saturation compaction of dense tapes before export
    (fd_cull_saturated, binning.py's SAT tier run on the host). No-op under
    4096 quads."""
    return lib.fd_cull_saturated(
        ctx,
        ctypes.c_float(frame_w * pixel_scale),
        ctypes.c_float(frame_h * pixel_scale),
    )


def _check_kinds(renders: RendersArray) -> None:
    """Raises ValueError for node kinds the walk does not handle."""
    if not renders.all_native_kinds():
        raise ValueError("scene holds node kinds the native walk does not handle")


_tls = threading.local()


def _acquire_ctx(lib, ui_scale, pixel_scale, aa_factor, slot: str = "ctx"):
    """Thread-local reusable walk context (fd_reset keeps the C++ vectors'
    capacity across frames); one per slot."""
    ctx = getattr(_tls, slot, None)
    if ctx is None:
        ctx = lib.fd_create(
            ctypes.c_float(ui_scale), ctypes.c_float(pixel_scale),
            ctypes.c_float(aa_factor),
        )
        setattr(_tls, slot, ctx)
    else:
        lib.fd_reset(
            ctx, ctypes.c_float(ui_scale), ctypes.c_float(pixel_scale),
            ctypes.c_float(aa_factor),
        )
    return ctx


def _acquire_scratch_ctx(lib, ui_scale, pixel_scale, aa_factor):
    """The retained-scene patch context (native._acquire_scratch_ctx): it
    shares neither tape state nor the combo pool with the frame walker's
    context, so a patch between frames leaves a tape in flight valid."""
    return _acquire_ctx(lib, ui_scale, pixel_scale, aa_factor, "patch_ctx")


# Ping-pong combo buffer pool, two buffers per (owner, ctx, shape): the
# previous frame's tape stays valid while the current one is exported.
# Quad rows [0, count) are rewritten by fd_export_combo_packed and the meta
# tail by fill_meta; the padding rows [count, bucket) are not written: a
# reused buffer keeps there what an earlier, longer tape left (zeros only in
# a fresh buffer). No consumer reads them (binning masks indices >= count and
# every consumer bounds by tape.count), but a whole-combo byte comparison
# sees them: start it from an empty pool on each side.
_combo_pool: dict = {}


def _pooled_combo(ctx, shape, owner=None) -> np.ndarray:
    key = (owner, ctx, shape)
    entry = _combo_pool.get(key)
    if entry is None:
        entry = [np.zeros(shape, np.float32), np.zeros(shape, np.float32), 0]
        _combo_pool[key] = entry
    entry[2] ^= 1
    return entry[entry[2]]


def _export_tape_combo(lib, ctx, frame_w, frame_h, clear_color,
                       pool_owner=None) -> Tape:
    """Export straight into the PACKED upload layout: one
    (bucket(count) + meta_rows, 52) wire buffer, quad rows written by C++
    (colors as u8x4 words), meta tail (draw bounds / blur radii / clear
    color) filled here (native._export_tape_combo)."""
    n_quads = lib.fd_quad_count(ctx)
    n_items = lib.fd_item_count(ctx)
    items = np.zeros((max(n_items, 1), 5), dtype=np.int32)
    rc = lib.fd_export_items(ctx, _ptr(items), items.shape[0])
    if rc != n_items:
        raise RuntimeError(f"fd_export_items wrote {rc} of {n_items} items")

    tape = Tape()
    tape.count = n_quads
    tape.mask_count = lib.fd_mask_count(ctx)
    tape.frame_size = (frame_w, frame_h)
    tape.clear_color = clear_color
    draws = []
    radii = []
    structure = []  # executor.tape_structure, built from the C++ flag bits
    seen_blur = False
    any_atlas = False
    any_backdrop = False
    for i in range(n_items):
        word, target, start, end, rbits = items[i]
        kind = word & 0xFF
        if kind == 0:
            tape.items.append(DrawItem(target=int(target), start=int(start),
                                       end=int(end)))
            if end > start:
                uses_atlas = bool(word & 0x100)
                has_backdrop = bool(word & 0x200)
                any_atlas |= uses_atlas
                any_backdrop |= has_backdrop
                structure.append(("draw", int(target), uses_atlas,
                                  seen_blur and has_backdrop))
                draws.append((int(start), int(end)))
        elif kind == 1:
            r = float(np.int32(rbits).view(np.float32))
            tape.items.append(BlurItem(radius=r))
            radii.append(r)
            seen_blur = True
            structure.append(("blur",))
        else:
            tape.items.append(ClearMaskItem(index=int(target)))
            structure.append(("clear_mask", int(target)))
    tape.structure_cache = (structure, draws, radii, any_atlas, any_backdrop)

    dens = np.zeros(2, np.float32)
    lib.fd_density(ctx, TILE_W, TILE_H, _ptr(dens))
    tape.tile_density = (float(dens[0]), float(dens[1]))

    rolled = len(structure) > ROLLED_THRESHOLD
    n_pad = bucket(max(n_quads, 1))
    nd = 0 if rolled else len(draws)
    nb = 0 if rolled else len(radii)
    rows = meta_rows(nd, nb, PACKED_WIDTH)
    combo = _pooled_combo(ctx, (n_pad + rows, PACKED_WIDTH), owner=pool_owner)
    rc = lib.fd_export_combo_packed(ctx, _ptr(combo), n_pad, PACKED_WIDTH)
    if rc != n_quads:
        raise RuntimeError(f"fd_export_combo_packed wrote {rc} of {n_quads} quads")
    fill_meta(
        combo[n_pad:].reshape(-1),
        draws if not rolled else [],
        radii if not rolled else [],
        clear_color or (0.0, 0.0, 0.0, 0.0),
    )
    tape.combo = combo
    tape.combo_quads = n_pad
    return tape


def flatten_fast(
    renders: RendersArray,
    frame_w: float,
    frame_h: float,
    ui_scale: float,
    pixel_scale: float,
    aa_factor: float,
    clear_color,
    atlas=None,
    pool_owner=None,
    text=None,
):
    """One walk, the best export for the scene (native.flatten_fast):

    ("mega", combo, mask_count, density): a scene of more than
    ROLLED_THRESHOLD items with no blur, atlas or backdrop quad, exported
    straight into the megakernel's (bucket(quads + clears) + 1, 52) wire
    buffer; the last row is the meta row the caller fills with the clear
    color. density is fd_density's (pairs_sum, median_h).
    ("tape", tape): everything else, as flatten_renders_array.

    The JAX package caps the mega export at VMEM_MEGA_ROWS, a limit of the
    TPU's vector memory; the CUDA megakernel reads the tape from device
    memory, so the port has no cap. A scene with an atlas quad always takes
    the tape: the C++ `flags` word marks it. atlas, text: as
    _set_walk_config's. Raises as _check_kinds."""
    _check_kinds(renders)
    lib = load()
    ctx = _acquire_ctx(lib, ui_scale, pixel_scale, aa_factor)
    _run_walk(lib, ctx, renders, atlas, text=text)
    _host_cull(lib, ctx, frame_w, frame_h, pixel_scale)
    info = np.zeros(4, np.int32)
    lib.fd_tape_info(ctx, _ptr(info))
    n_quads, n_items, mask_count, flags = (int(v) for v in info)
    if n_items > ROLLED_THRESHOLD and flags == 0:
        # quads + clear sentinels: draw and blur items never become rows
        cap = bucket(n_quads + lib.fd_clear_count(ctx))
        # C++ zeroes the padding rows, so ping-pong reuse leaks no old quads
        combo = _pooled_combo(ctx, (cap + 1, PACKED_WIDTH), owner=pool_owner)
        rows = lib.fd_export_mega_packed(ctx, _ptr(combo), cap, PACKED_WIDTH)
        if rows < 0:
            raise RuntimeError(f"fd_export_mega_packed overflowed {cap} rows")
        dens = np.zeros(2, np.float32)
        lib.fd_density(ctx, TILE_W, TILE_H, _ptr(dens))
        return "mega", combo, mask_count, (float(dens[0]), float(dens[1]))
    return "tape", _export_tape_combo(lib, ctx, frame_w, frame_h, clear_color,
                                      pool_owner=pool_owner)


def flatten_renders_array(
    renders: RendersArray,
    frame_w: float,
    frame_h: float,
    ui_scale: float,
    pixel_scale: float,
    aa_factor: float,
    clear_color,
    atlas=None,
    pool_owner=None,
    cull: bool = True,
    record_spans: bool = False,
    reserve=None,
    text=None,
) -> Tape:
    """Runs the native walk over all layers in ZLevel order, culls saturated
    stacks and exports the tape straight into the upload-combo layout padded
    to `bucket(count)` rows. atlas: as _set_walk_config's. cull=False skips
    the saturation cull: it is clamped to the viewport, so a tape that will
    be panned on the device (snapshot_scene) keeps every quad. text: as
    _set_walk_config's.
    record_spans=True fills tape.root_spans with (lvl, root_node_idx) ->
    (qs, qe), each root's rows; spans index rows before the cull, so it
    needs cull=False (ValueError). reserve: as _run_walk's reserves. Raises
    as _check_kinds."""
    if record_spans and cull:
        raise ValueError("root spans index pre-cull rows: record_spans needs "
                         "cull=False")
    _check_kinds(renders)
    lib = load()
    ctx = _acquire_ctx(lib, ui_scale, pixel_scale, aa_factor)
    spans_out = {} if record_spans else None
    _run_walk(lib, ctx, renders, atlas, spans_out=spans_out, reserves=reserve,
              text=text)
    if cull:
        _host_cull(lib, ctx, frame_w, frame_h, pixel_scale)
    tape = _export_tape_combo(lib, ctx, frame_w, frame_h, clear_color,
                              pool_owner=pool_owner)
    tape.root_spans = spans_out
    return tape


def inert_quad_rows(n: int) -> np.ndarray:
    """n inert packed rows, fd_pad_rows' bytes (native.inert_quad_rows): an
    empty bbox, so never binned, and an inverse affine that puts every pixel
    far outside the uv unit square, so coverage is exactly 0. The retained
    patch fills the tail of a span that shrank with these."""
    fields = np.zeros((n, QF_WIDTH), np.float32)
    fields[:, QF_INV_A] = 1.0
    fields[:, QF_ORG_X] = 2e9
    fields[:, QF_ORG_Y] = 2e9
    fields[:, QF_BBOX_X0] = 2e9
    fields[:, QF_BBOX_Y0] = 2e9
    fields[:, QF_BBOX_X1] = -2e9
    fields[:, QF_BBOX_Y1] = -2e9
    modes = np.zeros((n, 2), np.int32)
    modes[:, 0] = 3  # fd_pad_rows' packed_mode
    return pack_fields_np(fields, modes)


def walk_roots_packed(renders: RendersArray, dirty, ui_scale, pixel_scale,
                      aa_factor, atlas=None, allow_atlas: bool = False,
                      text=None):
    """Re-walk the roots `dirty`, a sequence of (lvl, root_node_idx), in the
    scratch context and export their quads as packed rows, the retained-scene
    patch (native.walk_roots_packed, packed layout).

    Returns (rows (n, PACKED_WIDTH) f32 in walk order, spans: a list of (qs,
    qe) into rows, one per dirty root), or None where a patch cannot stand in
    for a snapshot: a missing layer, a plane mask (their numbering is the
    whole scene's), a blur or a backdrop (they split the pass structure), or
    an atlas quad without allow_atlas. atlas, text: as _set_walk_config's.
    Raises as _check_kinds."""
    _check_kinds(renders)
    lib = load()
    ctx = _acquire_scratch_ctx(lib, ui_scale, pixel_scale, aa_factor)
    _set_walk_config(lib, ctx, atlas, text)
    dirty = list(dirty)
    spans: list = []
    i = 0
    while i < len(dirty):
        lvl = dirty[i][0]
        j = i
        while j < len(dirty) and dirty[j][0] == lvl:
            j += 1
        lst = renders.layers.get(lvl)
        if lst is None:
            return None
        nodes, _roots = _set_layer_geometry(lib, ctx, lst)
        roots = np.asarray([d[1] for d in dirty[i:j]], dtype=np.int32)
        out = np.empty((roots.shape[0], 2), np.int32)
        lib.fd_flatten_layer_spans(ctx, _ptr(nodes), nodes.shape[0],
                                   _ptr(roots), roots.shape[0], _ptr(out))
        spans.extend((int(s), int(e)) for s, e in out)
        i = j
    info = np.zeros(4, np.int32)
    lib.fd_tape_info(ctx, _ptr(info))
    n_quads, _n_items, mask_count, flags = (int(v) for v in info)
    if mask_count or (flags & 1) or (flags & 4):
        return None
    if (flags & 2) and not allow_atlas:
        return None
    rows = np.empty((max(n_quads, 1), PACKED_WIDTH), dtype=np.float32)
    rc = lib.fd_export_combo_packed(ctx, _ptr(rows), rows.shape[0], PACKED_WIDTH)
    if rc != n_quads:
        raise RuntimeError(f"fd_export_combo_packed wrote {rc} of {n_quads} quads")
    return rows[:n_quads], spans


def scene_animate(nodes: np.ndarray, w: float, h: float, frame: int,
                  copies: int, base_xs: np.ndarray, base_ys: np.ndarray,
                  tables: dict, clamp_x: float, clamp_y: float) -> None:
    """fd_scene_animate: writes the 300-box demo scene's frame-dependent
    columns into the FIG_DTYPE `nodes` array in place (bit-identical to
    figdraw_tpu.scenes._scene_animate_np). `tables` is the
    scenes._scene_anim_state dict of contiguous f64 phase tables."""
    lib = load()
    rc = lib.fd_scene_animate(
        _ptr(nodes), nodes.shape[0], float(w), float(h),
        float(clamp_x), float(clamp_y), int(frame),
        int(copies), _ptr(base_xs), _ptr(base_ys),
        _ptr(tables["sin_of_sp"]), _ptr(tables["cos_of_sp"]),
        _ptr(tables["sin_of_cp"]), _ptr(tables["cos_of_cp"]),
        _ptr(tables["sin_t"]), _ptr(tables["cos_t"]))
    if rc != 0:
        raise RuntimeError(f"fd_scene_animate failed ({rc})")
