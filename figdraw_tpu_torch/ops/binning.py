"""The frame's device front end: the wire decode and the tile binning, which
maps quad AABBs to per-tile draw-ordered index lists (figdraw_tpu/executor.py
`unpack_combo_device` :181 and figdraw_tpu/ops/binning.py:33-213, which the
JAX package leaves to XLA).

On CUDA tensors each entry point runs csrc/binning.cu, hand-written kernels
for Hopper (sm_90a), or raises; CPU tensors take the plain torch versions,
which the CPU tests and the on-card comparison use:

- `decode_and_bin`, the executors' call: the packed upload rows decoded and
  binned in two launches, the front kernel (the decode fused with the
  binning's per-quad terms) and the tile kernel. Its plain version is
  `unpack_combo_plain` followed by `bin_quads_plain`.
- `unpack_combo`, the decode alone (one launch of the front kernel);
  `unpack_combo_plain` is the JAX reference's ops.
- `bin_quads`, the binning of decoded fields (a prepass and the tile
  kernel); `bin_quads_plain` builds a (T, N) intersection mask from the
  bboxes, culls it for opaque occlusion and saturation, then sorts each
  tile row. The sort keys are unique (intersecting quads keep their index,
  the rest index + N), so any sort gives exactly the JAX reference's lists
  and counts.

Each entry point takes `row0`, the band origin of bin_quads' y_offset
(binning.py:36-42, :73; raster_pallas.prebin :399-416): tile row ty spans
the global rows [row0 + ty tile_h, row0 + (ty+1) tile_h). It is 0 for a
whole frame; a frame split into row bands over several devices
(parallel/sharding.py) bins each band at its own origin.

`bin_quads_model` is the kernels' decomposition in numpy (each quad's bbox
as an int16 tile range that sets its bit in each tile it meets, one lower
bound per tile and run from the covers among those bits, then an ordered
compaction with no sort), which the CPU tests hold to the JAX reference;
its `borderline` mask marks the quads whose saturation cut no two summation
orders need agree on, and `list_differences` compares two binnings outside
them.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import nvcc
from .layout import (
    PACKED_MODES, PACKED_WIDTH, QF_AA, QF_BBOX_X0, QF_BBOX_X1, QF_BBOX_Y0,
    QF_BBOX_Y1, QF_COLOR0, QF_INV_B, QF_INV_C, QF_MID_COLOR, QF_PARAMS,
    QF_RADII, QF_RECT_PARAMS, QF_STOP_COLOR, QF_WIDTH, QI_MASK, QI_MODE,
    QI_WIDTH,
)
from .raster import check_row0

# Translucent-stack saturation culling engages only on dense tapes (padded
# row count >= this): small scenes keep the exact opaque-only cull.
SAT_MIN_QUADS = 4096
# Cull a quad when the stack above it transmits < 2^-11 of it.
LOG2_SAT_EPS = -11.0
# A quad whose within-run above-stack, summed in float64, lies within
# SAT_BORDER + SAT_BORDER_REL * |S| of LOG2_SAT_EPS may be cut by one
# summation order and kept by another. S is the whole-row suffix sum from the
# quad that the plain version carries in float32 (it takes the within-run
# stack as a difference of two such sums, so its error grows with them);
# 2^-16 is 256 float32 units of |S|, over the log-depth error of the card's
# scan and the typical error of a sequential sum of 10^4 same-signed terms.
SAT_BORDER = 1e-3
SAT_BORDER_REL = 2.0 ** -16
# what one launch of the kernel takes (csrc/binning.cu): the frame runs it
# keeps in shared memory, the quads whose kept bits fit there, and the
# tiles an int16 tile range can name
MAX_RUNS = 64
MAX_QUADS = 1 << 20
MAX_TILES = 32767

# kernel launches since the count was last reset. LAUNCHES: the binning's,
# the tile kernel once a binning, and for `bin_quads` also its prepass (two
# a call; the tile kernel alone for a tape of no rows). DECODE_LAUNCHES:
# the front kernel's (the decode, fused with the binning's per-quad terms
# in `decode_and_bin`), one a call of `decode_and_bin` or `unpack_combo`
# with rows
LAUNCHES = 0
DECODE_LAUNCHES = 0
# of those, the launches at a band origin other than 0 (row0 != 0): the
# tile kernel's and the front kernel's
BAND_LAUNCHES = 0
BAND_DECODE_LAUNCHES = 0
# calls of the plain versions, on any device: a card's frames make none
PLAIN_DECODES = 0
PLAIN_BINNINGS = 0

_SOURCES = ("binning.cu", "decode.cuh")

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""  # nvcc's output of the build this process loaded (ptxas -v)


def load() -> ctypes.CDLL:
    """The kernel library, built and bound at first use."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is None:
            path, BUILD_LOG = nvcc.build("figdraw_binning", _SOURCES)
            lib = ctypes.CDLL(path)
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.figdraw_bin_quads.argtypes = ([vp] * 4 + [i, i, vp] + [i] * 9
                                              + [vp] * 4)
            lib.figdraw_decode_and_bin.argtypes = ([vp, i, vp, vp, vp, vp, i, i, i, vp]
                                                   + [i] * 8 + [vp] * 4 + [i])
            lib.figdraw_decode.argtypes = [vp, i, vp, vp, vp]
            for fn in (lib.figdraw_bin_quads, lib.figdraw_decode_and_bin,
                       lib.figdraw_decode):
                fn.restype = i
            _lib = lib
        return _lib


# k/255 as float32, computed on the host once: a division on the device may
# be rewritten into a multiply by 1/255, which is 1 ULP off the walk's own
# quantization (c/255.0f) and breaks the bit-exact decode
_U8_LUT = np.arange(256, dtype=np.float32) / np.float32(255.0)


def unpack_combo_plain(rows: torch.Tensor):
    """The plain torch version of unpack_combo (any device): the JAX
    reference's ops (executor.unpack_combo_device), each colour byte
    through the k/255 table."""
    global PLAIN_DECODES
    PLAIN_DECODES += 1
    n = rows.shape[0]
    words = rows[:, 16:22].contiguous().view(torch.int32)
    bytes_ = torch.stack(
        [(words >> (8 * k)) & 0xFF for k in range(4)], dim=2
    )  # (N, 6, 4): word w byte k = logical color col 16 + 4w + k
    lut = torch.from_numpy(_U8_LUT).to(rows.device)
    colors = lut[bytes_.reshape(n, 24).long()]
    fields = torch.cat([rows[:, :16], colors, rows[:, 22:50]], dim=1)
    modes = rows[:, PACKED_MODES : PACKED_MODES + 2].contiguous().view(torch.int32)
    return fields, modes


def _check_rows(rows) -> None:
    """The packed rows a front-kernel launch reads as 16-byte words: a
    contiguous (N, PACKED_WIDTH) float32 tensor at a 16-byte address (a row
    view of an upload or of a batch stack is one); anything else raises, it
    is never copied."""
    if (rows.dtype != torch.float32 or rows.dim() != 2
            or rows.shape[1] != PACKED_WIDTH or not rows.is_contiguous()):
        raise ValueError(f"rows must be contiguous (N, {PACKED_WIDTH}) float32, got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if rows.data_ptr() % 16:
        raise ValueError("rows must start at a 16-byte address (the kernel reads "
                         "them as 16-byte words)")
    if rows.shape[0] > MAX_QUADS:
        raise ValueError(f"{rows.shape[0]} rows are more than one launch's MAX_QUADS = "
                         f"{MAX_QUADS}")


def unpack_combo(rows: torch.Tensor):
    """Inverse of the packed wire layout: (N, PACKED_WIDTH) f32 rows ->
    ((N, 68) f32 fields, (N, 2) i32 modes), bit-identical to the pre-pack
    tape. Colors ride as six u8x4 words; each byte decodes to k/255.

    On CUDA tensors one launch of csrc/binning.cu's front kernel (a
    ValueError for rows it does not take, see _check_rows; a RuntimeError
    if the launch fails); CPU tensors take unpack_combo_plain; any other
    device raises ValueError."""
    if rows.device.type == "cpu":
        return unpack_combo_plain(rows)
    if rows.device.type != "cuda":
        raise ValueError(f"no decode kernel for {rows.device}")
    _check_rows(rows)
    n = rows.shape[0]
    fields = torch.empty((n, QF_WIDTH), dtype=torch.float32, device=rows.device)
    modes = torch.empty((n, QI_WIDTH), dtype=torch.int32, device=rows.device)
    if n == 0:
        return fields, modes
    rc = load().figdraw_decode(rows.data_ptr(), n, fields.data_ptr(), modes.data_ptr(),
                               torch.cuda.current_stream(rows.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode launch failed: cudaError {rc}")
    global DECODE_LAUNCHES
    DECODE_LAUNCHES += 1
    return fields, modes


def decode_and_bin_plain(rows, start, end, tiles_y: int, tiles_x: int,
                         tile_h: int, tile_w: int, cull: bool = False,
                         run_bounds=None, row0: int = 0):
    """The plain torch version of decode_and_bin (same arguments and
    results, any device): unpack_combo_plain, then bin_quads_plain."""
    fields, modes = unpack_combo_plain(rows)
    tile_idx, tile_counts = bin_quads_plain(
        fields, start, end, tiles_y, tiles_x, tile_h, tile_w,
        modes=modes if cull else None, run_bounds=run_bounds if cull else None,
        row0=row0)
    return fields, modes, tile_idx, tile_counts


def decode_and_bin(rows, start, end, tiles_y: int, tiles_x: int, tile_h: int,
                   tile_w: int, cull: bool = False, run_bounds=None, stop: int = 0,
                   row0: int = 0):
    """The front end of an executor run: (fields (N, 68) f32, modes (N, 2)
    i32, tile_idx (T, N) i32, tile_counts (T,) i32) = unpack_combo(rows)
    and bin_quads(fields, start, end, ..., modes=modes if cull, run_bounds)
    on them, T = tiles_y * tiles_x. rows: the (N, PACKED_WIDTH) packed
    upload rows; cull: the frame-target runs' opaque and saturation culls
    (bin_quads' modes), run-scoped when run_bounds is given; row0: the band
    origin, the global row of tile row 0.

    On CUDA tensors two launches of csrc/binning.cu: the front kernel,
    which reads each packed row once and writes the fields, the modes and
    the binning's per-quad terms, and the tile kernel (a ValueError for
    arguments they do not take; a RuntimeError if a launch fails). CPU
    tensors take decode_and_bin_plain; any other device raises ValueError.
    stop (CUDA only, to time the tile kernel's phases): 1-3 end the tile
    kernel after its overlap pass, its culls or its counts, 4 launches the
    front kernel alone; the lists are then not written."""
    row0 = check_row0(row0, tiles_y * tile_h)
    if rows.device.type == "cpu":
        return decode_and_bin_plain(rows, start, end, tiles_y, tiles_x, tile_h,
                                    tile_w, cull=cull, run_bounds=run_bounds,
                                    row0=row0)
    if rows.device.type != "cuda":
        raise ValueError(f"no front-end kernel for {rows.device}")
    _check_rows(rows)
    dev = rows.device
    n = rows.shape[0]
    runs, n_runs = _runs_arg(run_bounds if cull else None, dev)
    n_tiles = _tiles_arg(tiles_y, tiles_x, tile_h, tile_w)
    start_t, start_v = _window_arg(start, dev, "start")
    end_t, end_v = _window_arg(end, dev, "end")
    lib = load()
    fields = torch.empty((n, QF_WIDTH), dtype=torch.float32, device=dev)
    modes = torch.empty((n, QI_WIDTH), dtype=torch.int32, device=dev)
    tile_idx = torch.empty((n_tiles, n), dtype=torch.int32, device=dev)
    tile_counts = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    scratch = _scratch(n, n_tiles, dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = lib.figdraw_decode_and_bin(
        rows.data_ptr(), n, fields.data_ptr(), modes.data_ptr(), ptr(start_t),
        ptr(end_t), start_v, end_v, int(bool(cull)), ptr(runs), n_runs,
        int(bool(cull) and run_bounds is None), tiles_y, tiles_x, tile_h, tile_w,
        row0, int(bool(cull) and n >= SAT_MIN_QUADS), scratch.data_ptr(),
        tile_idx.data_ptr(), tile_counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, int(stop))
    if rc != 0:
        raise RuntimeError(f"front-end launch failed: cudaError {rc}")
    global LAUNCHES, DECODE_LAUNCHES, BAND_LAUNCHES, BAND_DECODE_LAUNCHES
    DECODE_LAUNCHES += 1 if n > 0 else 0
    LAUNCHES += 0 if stop == 4 else 1
    BAND_DECODE_LAUNCHES += n > 0 and row0 != 0
    BAND_LAUNCHES += stop != 4 and row0 != 0
    return fields, modes, tile_idx, tile_counts





def _scratch(n: int, n_tiles: int, dev) -> torch.Tensor:
    """What the front end passes its tile kernel (csrc/binning.cu
    scratch_terms): 16 bytes of cover terms a quad, the tiles' overlap bits
    (n_tiles, 4 ceil(n / 128)) and a flag."""
    return torch.empty((4 * n + 4 * n_tiles * ((n + 127) // 128) + 1,), dtype=torch.int32,
                       device=dev)


def _runs_arg(run_bounds, dev):
    """(int32 runs on the device or None, the count) for the kernels."""
    if run_bounds is None:
        return None, 0
    if (not isinstance(run_bounds, torch.Tensor) or run_bounds.device != dev
            or run_bounds.dim() != 2 or run_bounds.shape[1] != 2
            or run_bounds.dtype not in (torch.int32, torch.int64)):
        raise ValueError("run_bounds must be an (R, 2) integer tensor on the "
                         "rows' device")
    if run_bounds.shape[0] > MAX_RUNS:
        raise ValueError(f"{run_bounds.shape[0]} runs are more than one launch's "
                         f"MAX_RUNS = {MAX_RUNS}")
    return run_bounds.to(torch.int32).contiguous(), run_bounds.shape[0]


def _tiles_arg(tiles_y: int, tiles_x: int, tile_h: int, tile_w: int) -> int:
    """The tile count, for a grid the kernels take: at least one tile,
    at most MAX_TILES a side (the tile ranges are int16)."""
    if min(tiles_y, tiles_x, tile_h, tile_w) <= 0:
        raise ValueError(f"no tiles: {tiles_y} x {tiles_x} of {tile_h} x {tile_w}")
    if max(tiles_y, tiles_x) > MAX_TILES:
        raise ValueError(f"{tiles_y} x {tiles_x} tiles: more than MAX_TILES = "
                         f"{MAX_TILES} a side")
    return tiles_y * tiles_x


def bin_quads_plain(fields, start, end, tiles_y: int, tiles_x: int,
                    tile_h: int, tile_w: int, modes=None, run_bounds=None,
                    row0: int = 0):
    """The plain torch version of bin_quads (same arguments and results,
    any device): the JAX reference's ops, argsort included."""
    global PLAIN_BINNINGS
    PLAIN_BINNINGS += 1
    dev = fields.device
    n = fields.shape[0]
    x0 = fields[:, QF_BBOX_X0]
    y0 = fields[:, QF_BBOX_Y0]
    x1 = fields[:, QF_BBOX_X1]
    y1 = fields[:, QF_BBOX_Y1]

    ty = float(row0) + torch.arange(tiles_y, dtype=torch.float32, device=dev) * tile_h
    tx = torch.arange(tiles_x, dtype=torch.float32, device=dev) * tile_w
    # tile t covers pixel centers [t0 + 0.5, t0 + tile - 0.5]
    tx0 = tx[None, :, None]  # (1, TX, 1)
    ty0 = ty[:, None, None]  # (TY, 1, 1)

    idx = torch.arange(n, dtype=torch.int32, device=dev)
    valid = (idx >= start) & (idx < end)
    hit_x = (x0[None, None, :] < tx0 + tile_w) & (x1[None, None, :] > tx0)
    hit_y = (y0[None, None, :] < ty0 + tile_h) & (y1[None, None, :] > ty0)
    mask = hit_x & hit_y & valid[None, None, :]  # (TY, TX, N)
    mask = mask.reshape(tiles_y * tiles_x, n)

    if modes is not None:
        m = modes[:, QI_MODE]
        rest = torch.remainder(m, 256)  # mode + 128*elliptical
        fill_mode = torch.div(m, 256, rounding_mode="floor")
        # per-pixel fill alpha is a convex combination of the four vertex
        # colors (+ mid/stop for gradient fill modes), so their min bounds it
        a_min = torch.minimum(
            torch.minimum(fields[:, QF_COLOR0 + 3], fields[:, QF_COLOR0 + 7]),
            torch.minimum(fields[:, QF_COLOR0 + 11], fields[:, QF_COLOR0 + 15]),
        )
        a_min = torch.where(
            fill_mode == 0,
            a_min,
            torch.minimum(
                a_min,
                torch.minimum(
                    fields[:, QF_MID_COLOR + 3], fields[:, QF_STOP_COLOR + 3]
                ),
            ),
        )
        radii = fields[:, QF_RADII : QF_RADII + 4]
        hx = fields[:, QF_PARAMS + 2]  # shape half-extents
        hy = fields[:, QF_PARAMS + 3]
        elliptical = rest >= 128
        # elliptical corners carry 12+12-bit packed (x, y) radii (negative =
        # circular, radius -v-1): the per-axis interior inset is the max
        # decoded radius on that axis
        circ_r = -radii - 1.0
        pk = torch.where(radii >= 8388608.0, radii, torch.floor(radii + 0.5))
        rx = torch.where(radii < 0.0, circ_r,
                         torch.remainder(pk, 4096.0) * hx[:, None] / 4095.0)
        ry = torch.where(radii < 0.0, circ_r,
                         torch.floor(pk / 4096.0) * hy[:, None] / 4095.0)
        max_r = radii.amax(dim=1)
        inset_x = torch.where(elliptical, rx.amax(dim=1), max_r)
        inset_y = torch.where(elliptical, ry.amax(dim=1), max_r)
        margin = 0.5 / torch.clamp(fields[:, QF_AA], min=1e-3) + 0.01
        ihx = hx - inset_x - margin
        ihy = hy - inset_y - margin
        radii_ok = torch.where(
            elliptical,
            ((rx >= 0.0) & (ry >= 0.0)).all(dim=1),
            (radii >= 0.0).all(dim=1),
        )
        coverer = (
            (torch.remainder(rest, 128) == 3)  # ClipAA, any corners
            & (modes[:, QI_MASK] == 0)
            & (fields[:, QF_INV_B] == 0.0)
            & (fields[:, QF_INV_C] == 0.0)
            & (fields[:, QF_RECT_PARAMS + 2] < 0.0)  # rect mask disabled
            & radii_ok
            & (ihx > 0.0)
            & (ihy > 0.0)
        )
        cx = (x0 + x1) * 0.5  # axis-aligned: bbox center == shape center
        cy = (y0 + y1) * 0.5
        cov_x = ((cx - ihx)[None, None, :] <= tx0 + 0.5) & (
            (cx + ihx)[None, None, :] >= tx0 + tile_w - 0.5
        )
        cov_y = ((cy - ihy)[None, None, :] <= ty0 + 0.5) & (
            (cy + ihy)[None, None, :] >= ty0 + tile_h - 0.5
        )
        covers_any = (
            (cov_x & cov_y).reshape(tiles_y * tiles_x, n)
            & coverer[None, :]
            & valid[None, :]
        )
        covers = covers_any & (a_min >= 1.0)[None, :]  # exact: opaque covers
        saturate = n >= SAT_MIN_QUADS
        if saturate:
            # per tile, suffix-sum the log2 transmittance of constant-alpha
            # full covers; a quad whose above-stack transmits < 2^LOG2_SAT_EPS
            # is dropped
            lt = torch.where(
                covers_any,
                torch.log2(torch.clamp(1.0 - a_min, min=2.0 ** -24))[None, :],
                0.0,
            )
            suf = torch.flip(torch.cumsum(torch.flip(lt, [1]), dim=1), [1])
            above = suf - lt  # sum_{j>i}
        neg1 = torch.full((), -1, dtype=torch.int32, device=dev)
        if run_bounds is None:
            last_cover = torch.where(covers, idx[None, :], neg1).amax(
                dim=1, keepdim=True)
            mask = mask & (idx[None, :] >= last_cover)
            if saturate:
                mask = mask & (above >= LOG2_SAT_EPS)
        else:
            # run-scoped culling: per tile, the last cover WITHIN each run
            # bounds that run's quads only; quads outside every run keep -1
            thresh = torch.full((tiles_y * tiles_x, n), -1, dtype=torch.int32,
                                device=dev)
            keep_sat = None
            if saturate:
                # runs are contiguous, so for i in run r the within-run
                # above-stack is above[i] - suf[e_r]
                suf_pad = torch.cat(
                    [suf, torch.zeros((suf.shape[0], 1), dtype=suf.dtype,
                                      device=dev)], dim=1
                )
                keep_sat = torch.ones_like(mask)
            for r in range(run_bounds.shape[0]):
                s_r = run_bounds[r, 0]
                e_r = run_bounds[r, 1]
                in_r = (idx >= s_r) & (idx < e_r)
                last_r = torch.where(covers & in_r[None, :], idx[None, :],
                                     neg1).amax(dim=1, keepdim=True)
                thresh = torch.where(in_r[None, :], last_r, thresh)
                if saturate:
                    above_r = above - suf_pad.index_select(
                        1, e_r.reshape(1).long())
                    keep_sat = keep_sat & (
                        ~in_r[None, :] | (above_r >= LOG2_SAT_EPS)
                    )
            mask = mask & (idx[None, :] >= thresh)
            if keep_sat is not None:
                mask = mask & keep_sat

    # intersecting first, draw order kept
    keys = torch.where(mask, idx[None, :], n + idx[None, :])
    order = torch.argsort(keys, dim=1).to(torch.int32)
    counts = mask.sum(dim=1, dtype=torch.int32)
    return order, counts


def _window_arg(v, dev, what: str):
    """(device tensor or None, int) for one end of the window: a tensor on
    the card is read there by the kernel, an int or a CPU tensor by value."""
    if not isinstance(v, torch.Tensor):
        return None, int(v)
    if v.numel() != 1:
        raise ValueError(f"{what} must hold one value, got {tuple(v.shape)}")
    if v.device.type == "cpu":
        return None, int(v)
    if v.device != dev:
        raise ValueError(f"{what} lies on {v.device}, the fields on {dev}")
    return v.reshape(1).to(torch.int32), 0


def bin_quads(fields, start, end, tiles_y: int, tiles_x: int, tile_h: int,
              tile_w: int, modes=None, run_bounds=None, row0: int = 0):
    """Returns (tile_idx (T, N) i32, tile_counts (T,) i32), T = tiles_y *
    tiles_x.

    tile_idx[t, :counts[t]] are the indices of quads in [start, end) whose
    bbox intersects tile t, in draw order; the rest of the row is every
    other index, ascending. start/end: ints or 0-d integer tensors on the
    fields' device, which the kernel reads there.

    modes (frame-target runs only) enables opaque occlusion: a quad whose
    fully opaque interior covers a tile truncates the tile's list to start
    at it. Dense tapes (>= SAT_MIN_QUADS rows) also drop quads under a
    translucent stack that transmits less than 2^LOG2_SAT_EPS.

    run_bounds (with modes): (n_runs, 2) i32 [start, end) ranges of the
    frame-target draw runs when one binning serves a multi-run frame, on
    the fields' device; culling then stays run-scoped, and quads outside
    every run are never culled.

    row0: the band origin, the global row of tile row 0 (y_offset).

    On CUDA tensors this is one call of csrc/binning.cu, which launches the
    prepass and the tile kernel (a ValueError for more than MAX_QUADS rows,
    MAX_RUNS runs or MAX_TILES tiles a side, or arguments it does not take;
    a RuntimeError if the launch fails); CPU tensors take bin_quads_plain;
    any other device raises ValueError. The executors call decode_and_bin,
    which decodes the packed rows on the way.
    """
    row0 = check_row0(row0, tiles_y * tile_h)
    if fields.device.type == "cpu":
        return bin_quads_plain(fields, start, end, tiles_y, tiles_x, tile_h,
                               tile_w, modes=modes, run_bounds=run_bounds, row0=row0)
    if fields.device.type != "cuda":
        raise ValueError(f"no binning kernel for {fields.device}")
    dev = fields.device
    if (fields.dtype != torch.float32 or fields.dim() != 2
            or fields.shape[1] != QF_WIDTH or not fields.is_contiguous()):
        raise ValueError(f"fields must be contiguous (N, {QF_WIDTH}) float32, got "
                         f"{fields.dtype} {tuple(fields.shape)}")
    n = fields.shape[0]
    if n > MAX_QUADS:
        raise ValueError(f"{n} rows are more than one launch's MAX_QUADS = {MAX_QUADS}")
    n_tiles = _tiles_arg(tiles_y, tiles_x, tile_h, tile_w)
    if modes is not None and (modes.dtype != torch.int32 or modes.device != dev
                              or tuple(modes.shape) != (n, QI_WIDTH)
                              or not modes.is_contiguous()):
        raise ValueError(f"modes must be contiguous (N, {QI_WIDTH}) int32 on {dev}, "
                         f"got {modes.dtype} {tuple(modes.shape)} on {modes.device}")
    runs, n_runs = _runs_arg(run_bounds if modes is not None else None, dev)
    start_t, start_v = _window_arg(start, dev, "start")
    end_t, end_v = _window_arg(end, dev, "end")
    lib = load()
    tile_idx = torch.empty((n_tiles, n), dtype=torch.int32, device=dev)
    tile_counts = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    scratch = _scratch(n, n_tiles, dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = lib.figdraw_bin_quads(
        fields.data_ptr(), ptr(modes), ptr(start_t), ptr(end_t), start_v, end_v,
        ptr(runs), n_runs, int(modes is not None and run_bounds is None), n,
        tiles_y, tiles_x, tile_h, tile_w, row0,
        int(modes is not None and n >= SAT_MIN_QUADS), scratch.data_ptr(),
        tile_idx.data_ptr(), tile_counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"binning launch failed: cudaError {rc}")
    global LAUNCHES, BAND_LAUNCHES
    LAUNCHES += 2 if n > 0 else 1
    BAND_LAUNCHES += (2 if n > 0 else 1) if row0 != 0 else 0
    return tile_idx, tile_counts


def cover_terms(fields: np.ndarray, modes: np.ndarray):
    """What the kernel's prepass computes per quad, in numpy float32 with
    bin_quads_plain's steps and roundings: (cov (N, 4) = cx - ihx, cx + ihx,
    cy - ihy, cy + ihy, NaN for a quad that can never cover; a_min (N,), the
    least alpha of its fill)."""
    f = np.asarray(fields, np.float32)
    m = np.asarray(modes)[:, QI_MODE].astype(np.int64)
    rest, fill_mode = m % 256, m // 256
    a = f[:, [QF_COLOR0 + 3, QF_COLOR0 + 7, QF_COLOR0 + 11, QF_COLOR0 + 15]]
    a_min = np.minimum(np.minimum(a[:, 0], a[:, 1]), np.minimum(a[:, 2], a[:, 3]))
    a_min = np.where(fill_mode == 0, a_min, np.minimum(
        a_min, np.minimum(f[:, QF_MID_COLOR + 3], f[:, QF_STOP_COLOR + 3])))
    radii = f[:, QF_RADII : QF_RADII + 4]
    hx, hy = f[:, QF_PARAMS + 2 : QF_PARAMS + 3], f[:, QF_PARAMS + 3 : QF_PARAMS + 4]
    elliptical = rest >= 128
    with np.errstate(invalid="ignore"):
        circ_r = -radii - np.float32(1.0)
        pk = np.where(radii >= np.float32(8388608.0), radii,
                      np.floor(radii + np.float32(0.5)))
        rx = np.where(radii < 0, circ_r,
                      np.fmod(pk, np.float32(4096.0)) * hx / np.float32(4095.0))
        ry = np.where(radii < 0, circ_r,
                      np.floor(pk / np.float32(4096.0)) * hy / np.float32(4095.0))
        inset_x = np.where(elliptical, rx.max(1), radii.max(1))
        inset_y = np.where(elliptical, ry.max(1), radii.max(1))
        margin = (np.float32(0.5) / np.maximum(f[:, QF_AA], np.float32(1e-3))
                  + np.float32(0.01))
        ihx = hx[:, 0] - inset_x - margin
        ihy = hy[:, 0] - inset_y - margin
        radii_ok = np.where(elliptical, ((rx >= 0) & (ry >= 0)).all(1),
                            (radii >= 0).all(1))
        coverer = ((rest % 128 == 3) & (np.asarray(modes)[:, QI_MASK] == 0)
                   & (f[:, QF_INV_B] == 0) & (f[:, QF_INV_C] == 0)
                   & (f[:, QF_RECT_PARAMS + 2] < 0) & radii_ok & (ihx > 0) & (ihy > 0))
        cx = (f[:, QF_BBOX_X0] + f[:, QF_BBOX_X1]) * np.float32(0.5)
        cy = (f[:, QF_BBOX_Y0] + f[:, QF_BBOX_Y1]) * np.float32(0.5)
        cov = np.stack([cx - ihx, cx + ihx, cy - ihy, cy + ihy], 1)
    cov[~coverer] = np.nan
    return cov.astype(np.float32), a_min


def _spans(a, b, tiles: int) -> np.ndarray:
    """The tiles t in [a, b] (float64 bounds) as (first, last) int16,
    clamped to [0, tiles - 1]; (1, 0) when there is none (NaN included)."""
    with np.errstate(invalid="ignore"):
        empty = ~(a <= b) | (b < 0) | (a > tiles - 1)
        first = np.where(empty, 1, np.clip(np.nan_to_num(a), 0, tiles - 1))
        last = np.where(empty, 0, np.clip(np.nan_to_num(b), 0, tiles - 1))
    return np.stack([first, last], 1).astype(np.int16)


def tile_ranges(fields, tiles_y: int, tiles_x: int, tile_h: int, tile_w: int,
                row0: int = 0):
    """Each quad's bbox as the tile range the kernels read (csrc/decode.cuh
    bbox_tiles), (N, 4) int16 (x first, y first, x last, y last): tile
    (tx, ty) meets the quad exactly when x0 < (tx+1) w, x1 > tx w and the
    same in y with y taken from the band origin row0, that is floor(x0 / w)
    <= tx <= ceil(x1 / w) - 1, in float64; (1, 1, 0, 0) for a quad that
    meets no tile."""
    f = np.asarray(fields, np.float32).astype(np.float64)
    x = _spans(np.floor(f[:, QF_BBOX_X0] / tile_w), np.ceil(f[:, QF_BBOX_X1] / tile_w) - 1,
               tiles_x)
    y = _spans(np.floor((f[:, QF_BBOX_Y0] - row0) / tile_h),
               np.ceil((f[:, QF_BBOX_Y1] - row0) / tile_h) - 1, tiles_y)
    out = np.stack([x[:, 0], y[:, 0], x[:, 1], y[:, 1]], 1)
    out[(out[:, 0] > out[:, 2]) | (out[:, 1] > out[:, 3])] = (1, 1, 0, 0)
    return out


def cover_ranges(fields, modes, tiles_y: int, tiles_x: int, tile_h: int, tile_w: int,
                 row0: int = 0):
    """Each quad's cover terms as the tile kernel reads them (csrc/decode.cuh
    cover_term): ((N, 4) int16 range of the tiles its cover rectangle
    covers, (1, 1, 0, 0) for none: cx - ihx <= tx w + 0.5 and cx + ihx >=
    (tx+1) w - 0.5, that is ceil((cx - ihx - 0.5) / w) <= tx <=
    floor((cx + ihx + 0.5) / w) - 1, y taken from the band origin row0; (N,)
    float32 lt, 0 where the range is empty; (N,) bool opaque)."""
    cov, a_min = cover_terms(fields, modes)
    c = cov.astype(np.float64)
    x = _spans(np.ceil((c[:, 0] - 0.5) / tile_w), np.floor((c[:, 1] + 0.5) / tile_w) - 1,
               tiles_x)
    y = _spans(np.ceil((c[:, 2] - row0 - 0.5) / tile_h),
               np.floor((c[:, 3] - row0 + 0.5) / tile_h) - 1, tiles_y)
    rng = np.stack([x[:, 0], y[:, 0], x[:, 1], y[:, 1]], 1)
    empty = (rng[:, 0] > rng[:, 2]) | (rng[:, 1] > rng[:, 3])
    rng[empty] = (1, 1, 0, 0)
    with np.errstate(invalid="ignore", divide="ignore"):
        lt = np.log2(np.maximum(np.float32(1.0) - a_min, np.float32(2.0 ** -24)))
        opaque = a_min >= 1.0
    return rng, np.where(empty, np.float32(0.0), lt).astype(np.float32), opaque & ~empty


def _in(rng, tx: int, ty: int):
    return (tx >= rng[:, 0]) & (tx <= rng[:, 2]) & (ty >= rng[:, 1]) & (ty <= rng[:, 3])


def overlap_bits(rng, tiles_y: int, tiles_x: int) -> np.ndarray:
    """The (T, N) overlap bits the front kernel scatters: each quad sets its
    bit in every tile of its range (tile_ranges)."""
    bits = np.zeros((tiles_y, tiles_x, rng.shape[0]), bool)
    for i in np.flatnonzero((rng[:, 0] <= rng[:, 2]) & (rng[:, 1] <= rng[:, 3])):
        bits[rng[i, 1] : rng[i, 3] + 1, rng[i, 0] : rng[i, 2] + 1, i] = True
    return bits.reshape(tiles_y * tiles_x, -1)


def bin_quads_model(fields, start: int, end: int, tiles_y: int, tiles_x: int,
                    tile_h: int, tile_w: int, modes=None, run_bounds=None,
                    row0: int = 0):
    """csrc/binning.cu's decomposition in numpy, on numpy arrays, from the
    terms its front kernel writes (tile_ranges, cover_ranges): each quad
    sets its bit in every tile its int16 range names; per tile the bits in
    the window, then per run r (the window when no runs are given) one lower
    bound from the covers among those bits (among every quad of the run
    when some quad's cover range is not inside its bbox range): the last
    opaque cover, or in the saturation tier j*, the last cover whose
    within-run stack from itself on, summed in float64, is under
    LOG2_SAT_EPS; quad i of r is kept at or after the bound of the last run
    holding it (every run's, in the saturation tier); then the kept quads at
    their prefix and the rest after them ascending. Returns (tile_idx (T, N)
    i32, tile_counts (T,) i32, borderline (T, N) bool: the quads whose
    within-run above-stack lies within SAT_BORDER + SAT_BORDER_REL * |S| of
    LOG2_SAT_EPS, S the stack of the window's covers from the quad on). row0:
    the band origin (tile_ranges, cover_ranges)."""
    f = np.asarray(fields, np.float32)
    n = f.shape[0]
    n_tiles = tiles_y * tiles_x
    idx = np.arange(n)
    w_lo, w_hi = max(start, 0), min(end, n)
    window = (idx >= w_lo) & (idx < w_hi)
    rng = tile_ranges(f, tiles_y, tiles_x, tile_h, tile_w, row0)
    keep = overlap_bits(rng, tiles_y, tiles_x) & window[None, :]
    borderline = np.zeros((n_tiles, n), bool)
    if modes is not None:
        crng, lt, opaque = cover_ranges(f, modes, tiles_y, tiles_x, tile_h, tile_w, row0)
        outside = ((crng[:, 0] <= crng[:, 2])
                   & ((crng[:, 0] < rng[:, 0]) | (crng[:, 2] > rng[:, 2])
                      | (crng[:, 1] < rng[:, 1]) | (crng[:, 3] > rng[:, 3]))).any()
        saturate = n >= SAT_MIN_QUADS
        runs = ([(start, end)] if run_bounds is None
                else [tuple(int(v) for v in r) for r in np.asarray(run_bounds)])
        for t in range(n_tiles):
            ty, tx = divmod(t, tiles_x)
            bits = keep[t]
            covers = _in(crng, tx, ty) & window
            thr = np.full(n, -1)
            for s_r, e_r in runs:
                lo, hi = max(s_r, w_lo), min(e_r, w_hi)
                if lo >= hi:
                    continue
                seg = np.arange(lo, hi)
                cand = np.ones(hi - lo, bool) if outside else bits[lo:hi]
                cov_r = cand & covers[lo:hi]
                if saturate:
                    terms = np.where(cov_r, lt[lo:hi].astype(np.float64), 0.0)
                    stack = np.cumsum(terms[::-1])[::-1]  # from each quad on
                    with np.errstate(invalid="ignore"):
                        under = cov_r & ~(stack >= LOG2_SAT_EPS)
                    bound = seg[under].max() if under.any() else -1
                    thr[lo:hi] = np.maximum(thr[lo:hi], bound)
                else:
                    opq = cov_r & opaque[lo:hi]
                    thr[lo:hi] = seg[opq].max() if opq.any() else -1
            keep[t] = bits & (idx >= thr)
            if saturate and w_lo < w_hi:
                terms = np.where(covers, lt.astype(np.float64), 0.0)
                row_suf = np.cumsum(terms[::-1])[::-1]  # the window's stack
                for s_r, e_r in runs:
                    lo, hi = max(s_r, w_lo), min(e_r, w_hi)
                    if lo >= hi:
                        continue
                    above = np.zeros(hi - lo)  # the run's stack strictly above
                    above[:-1] = np.cumsum(terms[lo:hi][::-1])[::-1][1:]
                    with np.errstate(invalid="ignore"):
                        borderline[t, lo:hi] |= np.abs(above - LOG2_SAT_EPS) < (
                            SAT_BORDER + SAT_BORDER_REL * np.abs(row_suf[lo:hi]))
    counts = keep.sum(1)
    prefix = np.cumsum(keep, axis=1) - keep
    pos = np.where(keep, prefix, counts[:, None] + idx[None, :] - prefix)
    tile_idx = np.empty((n_tiles, n), np.int32)
    tile_idx[np.arange(n_tiles)[:, None], pos] = idx[None, :]
    return tile_idx, counts.astype(np.int32), borderline


def list_differences(a_idx, a_counts, b_idx, b_counts, borderline=None) -> dict:
    """How two binnings ((T, N) lists, (T,) counts, as numpy arrays) differ
    once the quads that `borderline` ((T, N) bool by quad index) marks are
    left out of both: `compared`, the list entries compared; `differing`,
    how many of them differ; `count_delta`, the largest difference of the
    kept counts over the tiles; `max_abs_err`, the largest |a - b| over the
    compared entries and the kept counts (0 when they agree, inf when the
    shapes or the entries left out do not match)."""
    a_idx, b_idx = np.asarray(a_idx), np.asarray(b_idx)
    a_counts, b_counts = np.asarray(a_counts), np.asarray(b_counts)
    if a_idx.shape != b_idx.shape or a_counts.shape != b_counts.shape:
        return {"compared": 0, "differing": max(a_idx.size, b_idx.size),
                "count_delta": None, "max_abs_err": float("inf")}
    n = a_idx.shape[1]
    if borderline is None:
        borderline = np.zeros(a_idx.shape, bool)
    rows = np.arange(a_idx.shape[0])[:, None]
    live = np.arange(n)[None, :]

    def left_out(x):  # entries of borderline quads (an index out of range is kept)
        return borderline[rows, np.clip(x, 0, max(n - 1, 0))] & (x >= 0) & (x < n)

    out_a, out_b = left_out(a_idx), left_out(b_idx)
    kept_a = a_counts.astype(np.int64) - (out_a & (live < a_counts[:, None])).sum(1)
    kept_b = b_counts.astype(np.int64) - (out_b & (live < b_counts[:, None])).sum(1)
    va, vb = a_idx[~out_a].astype(np.int64), b_idx[~out_b].astype(np.int64)
    if va.shape != vb.shape:
        return {"compared": 0, "differing": max(va.size, vb.size),
                "count_delta": None, "max_abs_err": float("inf")}
    diff = np.abs(va - vb)
    delta = int(np.abs(kept_a - kept_b).max(initial=0))
    return {"compared": int(va.size), "differing": int((diff != 0).sum()),
            "count_delta": delta, "max_abs_err": float(max(int(diff.max(initial=0)), delta))}


def lists_equal(a_idx, a_counts, b_idx, b_counts, borderline=None) -> bool:
    """Whether two binnings agree outside the borderline quads
    (list_differences finds no difference)."""
    return list_differences(a_idx, a_counts, b_idx, b_counts, borderline)["max_abs_err"] == 0
