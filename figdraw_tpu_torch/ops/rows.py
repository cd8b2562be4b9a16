"""Row transforms of a device-resident scene: the per-root affine, the camera
and the damage clip, over packed upload rows (ops/layout.py's wire layout,
52 columns).

`view_rows`, `animate_rows` and `damage_clip_rows` are the plain torch
versions of figdraw_tpu/executor.py `view_rows` (:761), `animate_rows` (:805)
and the bbox test of `get_partial_patch_view_runner` (:1001-1014): the same
column sets, row masks and order of every multiply and add. `transform_rows`
runs the stages a frame asks for in one launch of csrc/rows.cu, a
hand-written kernel for Hopper (sm_90a), on CUDA tensors (or raises); on CPU
tensors it composes the plain versions, which the CPU tests and the on-card
comparison use.

All of them are functional: the input rows are never written. Columns 16-21
(u8x4 colour words) and 50-51 (mode lanes) are integers in float lanes, so
only the geometry columns are touched, and rows past n_quads (the meta
tail), rows with an empty bbox and rows outside every root span come out
byte-identical.
"""

from __future__ import annotations

import ctypes
import math
import threading

import numpy as np
import torch

from . import nvcc
from .layout import PACKED_WIDTH

# rect-mask screen->local rows (ax, bx, tx, ay, by, ty) in the packed layout
# (executor.VIEW_RECT_COLS_PACKED)
VIEW_RECT_COLS_PACKED = (42, 43, 44, 46, 47, 48)
BBOX_COLS = (6, 7, 8, 9)
# damage-rect safety margin in px and the number of rects a scene tracks
# (executor.DAMAGE_PAD, DAMAGE_RECTS; csrc/rows.cu holds the same two)
DAMAGE_PAD = 2.0
DAMAGE_RECTS = 4
EMPTY_BBOX = (2e9, 2e9, -2e9, -2e9)

# kernel launches since the count was last reset
LAUNCHES = 0

_SOURCES = ("rows.cu",)

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""  # nvcc's output of the build this process loaded (ptxas -v)


def load() -> ctypes.CDLL:
    """The kernel library, built and bound at first use."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is None:
            path, BUILD_LOG = nvcc.build("figdraw_rows", _SOURCES)
            lib = ctypes.CDLL(path)
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.figdraw_rows.argtypes = [vp, vp, i, i] + [vp] * 6
            lib.figdraw_rows.restype = i
            _lib = lib
        return _lib


def _live(q: torch.Tensor) -> torch.Tensor:
    return (q[:, 8] > q[:, 6]) & (q[:, 9] > q[:, 7])


def _camera(combo, d, z):
    dev = combo.device
    return (torch.as_tensor(d, dtype=torch.float32, device=dev).reshape(2),
            torch.as_tensor(z, dtype=torch.float32, device=dev).reshape(()))


def view_rows(combo: torch.Tensor, d, z, n_quads: int) -> torch.Tensor:
    """The camera p' = z p + d on the quads of a packed buffer, as new rows.

    combo (rows, 52) f32, of which [0, n_quads) are quads; d (2,) and z ()
    f32 tensors on its device (or floats). Per live row (bbox not empty):
    origin (4, 5) and bbox (6..9) map by z x + d; the screen->uv inverse
    affine (0..3) and the rect-mask rows (42, 43 / 46, 47) scale by 1/z, and
    the rect-mask translations (44, 48) become t - M d / z, from the rows
    before they are scaled. Exact for integer d and z on integer scenes."""
    d, z = _camera(combo, d, z)
    out = combo.clone()
    q = combo[:n_quads]
    o = out[:n_quads]
    live = _live(q)
    linv = 1.0 / z
    ax, bx, tx, ay, by, ty = VIEW_RECT_COLS_PACKED
    for col in (0, 1, 2, 3, ax, bx, ay, by):
        o[:, col] = torch.where(live, q[:, col] * linv, q[:, col])
    for col, comp in ((4, d[0]), (6, d[0]), (8, d[0]), (5, d[1]), (7, d[1]),
                      (9, d[1])):
        o[:, col] = torch.where(live, q[:, col] * z + comp, q[:, col])
    o[:, tx] = torch.where(
        live, q[:, tx] + -(q[:, ax] * d[0] + q[:, bx] * d[1]) * linv, q[:, tx])
    o[:, ty] = torch.where(
        live, q[:, ty] + -(q[:, ay] * d[0] + q[:, by] * d[1]) * linv, q[:, ty])
    return out


def animate_rows(combo: torch.Tensor, table: torch.Tensor, ridx: torch.Tensor,
                 n_quads: int) -> torch.Tensor:
    """Per-root affines p' = M p + t on the quads of a packed buffer, as new
    rows.

    table (R + 1, 6) f32: a row (m00, m01, m10, m11, tx, ty) per root, the
    last the identity; ridx (n_quads,) i32: each quad row's table slot, -1
    for a row in no root's span. Per live row with a slot: the inverse
    affine (0..3) times M^-1; origin (4, 5) through M p + t; the bbox (6..9)
    the box of its four mapped corners, the translation added after the
    min/max; the rect-mask rows times M^-1 with their translations
    re-derived. Exact for integer translations and power-of-two axis-aligned
    scales of integer scenes."""
    out = combo.clone()
    q = combo[:n_quads]
    o = out[:n_quads]
    aff = table[ridx.clamp(min=0).long()]
    anim = _live(q) & (ridx >= 0)
    a, b, c, dd, tx, ty = (aff[:, k] for k in range(6))
    det = a * dd - b * c
    ia = dd / det
    ib = -b / det
    ic = -c / det
    idd = a / det
    new = {}
    new[0] = q[:, 0] * ia + q[:, 1] * ic
    new[1] = q[:, 0] * ib + q[:, 1] * idd
    new[2] = q[:, 2] * ia + q[:, 3] * ic
    new[3] = q[:, 2] * ib + q[:, 3] * idd
    new[4] = a * q[:, 4] + b * q[:, 5] + tx
    new[5] = c * q[:, 4] + dd * q[:, 5] + ty
    xs = (a * q[:, 6] + b * q[:, 7], a * q[:, 6] + b * q[:, 9],
          a * q[:, 8] + b * q[:, 7], a * q[:, 8] + b * q[:, 9])
    ys = (c * q[:, 6] + dd * q[:, 7], c * q[:, 6] + dd * q[:, 9],
          c * q[:, 8] + dd * q[:, 7], c * q[:, 8] + dd * q[:, 9])
    new[6] = torch.minimum(torch.minimum(xs[0], xs[1]),
                           torch.minimum(xs[2], xs[3])) + tx
    new[8] = torch.maximum(torch.maximum(xs[0], xs[1]),
                           torch.maximum(xs[2], xs[3])) + tx
    new[7] = torch.minimum(torch.minimum(ys[0], ys[1]),
                           torch.minimum(ys[2], ys[3])) + ty
    new[9] = torch.maximum(torch.maximum(ys[0], ys[1]),
                           torch.maximum(ys[2], ys[3])) + ty
    ax, bx, txc, ay, by, tyc = VIEW_RECT_COLS_PACKED
    mxa = q[:, ax] * ia + q[:, bx] * ic
    mxb = q[:, ax] * ib + q[:, bx] * idd
    mya = q[:, ay] * ia + q[:, by] * ic
    myb = q[:, ay] * ib + q[:, by] * idd
    new[ax], new[bx] = mxa, mxb
    new[ay], new[by] = mya, myb
    new[txc] = q[:, txc] - (mxa * tx + mxb * ty)
    new[tyc] = q[:, tyc] - (mya * tx + myb * ty)
    for col, val in new.items():
        o[:, col] = torch.where(anim, val, q[:, col])
    return out


def screen_rects(rects: torch.Tensor, d: torch.Tensor, z: torch.Tensor):
    """Scene-space damage rects (R, 4) under the camera, padded by
    DAMAGE_PAD: (rx0, ry0, rx1, ry1), each (R,)."""
    return (rects[:, 0] * z + d[0] - DAMAGE_PAD,
            rects[:, 1] * z + d[1] - DAMAGE_PAD,
            rects[:, 2] * z + d[0] + DAMAGE_PAD,
            rects[:, 3] * z + d[1] + DAMAGE_PAD)


def damage_clip_rows(viewed: torch.Tensor, rects: torch.Tensor, d, z,
                     n_quads: int) -> torch.Tensor:
    """Viewed rows with an empty bbox on every quad row whose bbox misses
    every damage rect, as new rows: such a row bins into no tile. rects
    (DAMAGE_RECTS, 4) f32 in scene space, unused slots inverted; d, z: the
    camera the rows were viewed under."""
    d, z = _camera(viewed, d, z)
    rx0, ry0, rx1, ry1 = screen_rects(rects, d, z)
    out = viewed.clone()
    q = viewed[:n_quads]
    keep = ((q[:, 6, None] <= rx1[None, :]) & (q[:, 8, None] >= rx0[None, :])
            & (q[:, 7, None] <= ry1[None, :]) & (q[:, 9, None] >= ry0[None, :])
            ).any(dim=1)
    empty = torch.tensor(EMPTY_BBOX, dtype=torch.float32, device=viewed.device)
    out[:n_quads, 6:10] = torch.where(keep[:, None], q[:, 6:10], empty)
    return out


def damage_spans(rects, d, z, height: int, width: int) -> list:
    """The pixels a damage-clipped frame takes from the new render, those
    whose centers lie in a padded damage rect under the camera (the frame
    keeps the previous one everywhere else), as (y0, y1, x0, x1) index
    ranges, one per rect that covers a pixel center of the frame, computed
    on the host: rects (R, 4) numpy f32, d and z floats. The rects go under the camera in
    float32, each product and sum rounded once as screen_rects rounds them;
    a pixel center i + 0.5 lies in [lo, hi] exactly when ceil(lo - 0.5) <= i
    <= floor(hi - 0.5), taken in doubles, which hold both sides exactly."""
    r = np.asarray(rects, np.float32)
    z32, dx, dy = np.float32(z), np.float32(d[0]), np.float32(d[1])
    pad = np.float32(DAMAGE_PAD)
    lo_x, lo_y = r[:, 0] * z32 + dx - pad, r[:, 1] * z32 + dy - pad
    hi_x, hi_y = r[:, 2] * z32 + dx + pad, r[:, 3] * z32 + dy + pad
    spans = []
    for k in range(r.shape[0]):
        x0 = max(math.ceil(float(lo_x[k]) - 0.5), 0)
        x1 = min(math.floor(float(hi_x[k]) - 0.5), width - 1) + 1
        y0 = max(math.ceil(float(lo_y[k]) - 0.5), 0)
        y1 = min(math.floor(float(hi_y[k]) - 0.5), height - 1) + 1
        if x1 > x0 and y1 > y0:
            spans.append((y0, y1, x0, x1))
    return spans


def transform_rows_plain(combo, n_quads: int, d, z, table=None, ridx=None,
                         rects=None) -> torch.Tensor:
    """The plain torch version of transform_rows (same arguments, any
    device); returns new rows."""
    rows = combo
    if table is not None:
        rows = animate_rows(rows, table, ridx, n_quads)
    rows = view_rows(rows, d, z, n_quads)
    if rects is not None:
        rows = damage_clip_rows(rows, rects, d, z, n_quads)
    return rows


def _check(t, name, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the rows on {dev}")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def transform_rows(combo: torch.Tensor, n_quads: int, d: torch.Tensor,
                   z: torch.Tensor, out: torch.Tensor, table=None, ridx=None,
                   rects=None) -> torch.Tensor:
    """One frame's geometry pass over a resident packed buffer, written into
    `out` (a scratch buffer of combo's shape, which must not be combo) and
    returned: the per-root affine when table and ridx are given
    (animate_rows), then the camera (view_rows), then the damage clip when
    rects is given (damage_clip_rows). combo is not written.

    combo (rows, 52) f32 with quads in [0, n_quads); d (2,) and z () or (1,)
    f32 tensors; table (R + 1, 6) f32 and ridx (n_quads,) i32 with values in
    [-1, R]; rects (DAMAGE_RECTS, 4) f32: all on combo's device."""
    dev = combo.device
    if dev.type == "cpu":
        return out.copy_(transform_rows_plain(combo, n_quads, d, z, table, ridx,
                                              rects))
    if dev.type != "cuda":
        raise ValueError(f"no row kernel for {dev}")
    _check(combo, "combo", torch.float32, None, dev)
    if combo.dim() != 2 or combo.shape[1] != PACKED_WIDTH:
        raise ValueError(f"combo must be (rows, {PACKED_WIDTH}), got "
                         f"{tuple(combo.shape)}")
    _check(out, "out", torch.float32, tuple(combo.shape), dev)
    if not 0 <= n_quads <= combo.shape[0]:
        raise ValueError(f"n_quads {n_quads} outside the {combo.shape[0]} rows")
    # the kernel moves a row as 13 16-byte words
    if combo.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("combo and out must be 16-byte aligned")
    nbytes = combo.numel() * 4
    if (out.data_ptr() < combo.data_ptr() + nbytes
            and combo.data_ptr() < out.data_ptr() + nbytes):
        raise ValueError("out must not overlap combo")
    _check(d, "d", torch.float32, (2,), dev)
    _check(z, "z", torch.float32, None, dev)
    if z.numel() != 1:
        raise ValueError(f"z must hold one value, got {tuple(z.shape)}")
    if (table is None) != (ridx is None):
        raise ValueError("table and ridx come together")
    if table is not None:
        _check(table, "table", torch.float32, None, dev)
        if table.dim() != 2 or table.shape[1] != 6 or table.shape[0] < 1:
            raise ValueError(f"table must be (R + 1, 6), got {tuple(table.shape)}")
        _check(ridx, "ridx", torch.int32, (n_quads,), dev)
    if rects is not None:
        _check(rects, "rects", torch.float32, (DAMAGE_RECTS, 4), dev)
    lib = load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.figdraw_rows(
        combo.data_ptr(), out.data_ptr(), combo.shape[0], n_quads,
        table.data_ptr() if table is not None else None,
        ridx.data_ptr() if ridx is not None else None,
        d.data_ptr(), z.data_ptr(),
        rects.data_ptr() if rects is not None else None, stream)
    if rc != 0:
        raise RuntimeError(f"row kernel launch failed: cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out
