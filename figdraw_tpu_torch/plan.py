"""Host half of a frame: pass structure, upload buffers and executor
parameters (figdraw_tpu/renderer.py `_plan_execution` with the host helpers
of figdraw_tpu/executor.py).

A native export arrives packed, with its structure and tile density from
the C++ walk. A tape of the Python walk arrives as logical rows:
`pack_walked_tape` gives it what the native export gives (the structure
from its mode lanes, the packed combo with its meta tail), and its tile
height comes from its rows (`pick_tile_h`), as the JAX renderer plans such
a tape.

A frame of at most ROLLED_THRESHOLD pass items takes the unrolled frame
executor: draw runs into the frame or into mask planes, mask clears and
backdrop blurs. A longer frame takes the megakernel, whose combo
`pack_mega_combo` builds, with the atlas when it holds an atlas run, unless
it holds a blur or a backdrop: then it takes the frame executor's rolled
form, whose draw bounds and blur radii come from an item table
(`build_rolled_items`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .ops.layout import (
    PACKED_MODES, PACKED_WIDTH, QF_BBOX_X0, QF_BBOX_X1, QF_BBOX_Y0, QF_BBOX_Y1,
    QI_MASK, QI_MODE, QI_WIDTH, pack_fields_np,
)
from .ops.mega import MEGA_CLEAR_BIT, MEGA_TARGET_SHIFT
from .ops.raster import TILE_H, TILE_W
from .tape import BlurItem, ClearMaskItem, DrawItem, FRAME_TARGET, Tape

ROLLED_THRESHOLD = 24  # structure items above this need the rolled executor


def meta_rows(n_draws: int, n_blurs: int, row_width: int) -> int:
    """Rows of the combo's meta tail: bitcast draw bounds, blur radii, clear
    color (executor._meta_rows)."""
    return max(1, -(-(2 * n_draws + n_blurs + 4) // row_width))


def fill_meta(meta, bounds, radii, clear_color) -> None:
    """The one writer of the combo meta-tail layout (executor.fill_meta)."""
    nd = len(bounds)
    nb = len(radii)
    if nd:
        meta[: 2 * nd] = (
            np.asarray(bounds, np.int32).view(np.float32).reshape(-1)
        )
    if nb:
        meta[2 * nd : 2 * nd + nb] = radii
    meta[2 * nd + nb : 2 * nd + nb + 4] = clear_color


# pow2, then 1.5x-pow2 steps above 2048 (renderer.py:37-38): the upload is
# padded to the bucket so the executor's shapes repeat across frames
QUAD_BUCKETS = (64, 128, 256, 512, 1024, 2048, 3072, 4096, 6144, 8192,
                12288, 16384, 24576, 32768, 49152, 65536)


def bucket(n: int) -> int:
    """Padded quad-row count for n quads (renderer._bucket)."""
    for b in QUAD_BUCKETS:
        if n <= b:
            return b
    return ((n + QUAD_BUCKETS[-1] - 1) // QUAD_BUCKETS[-1]) * QUAD_BUCKETS[-1]


DENSE_TILE_H = 64
DENSE_QUADS_PER_TILE = 48.0
VERY_DENSE_TILE_H = 32
VERY_DENSE_QUADS_PER_TILE = 120.0
SHORT_QUAD_H = 64.0


def tile_h_from_density(pairs_sum: float, median_h: float, height: int,
                        width: int) -> int:
    """Tile height from the walk's density summary (executor.py:74-91):
    pairs_sum = quad-tile pair count over live quads, median_h = median
    live bbox height (-1 = no live quads). The thresholds were measured on
    a TPU; the slice keeps them so both packages tile a frame alike."""
    if median_h < 0.0:
        return TILE_H
    tiles = max((-(-height // TILE_H)) * (-(-width // TILE_W)), 1)
    quads_per_tile = pairs_sum / tiles
    if quads_per_tile > VERY_DENSE_QUADS_PER_TILE:
        return VERY_DENSE_TILE_H
    if quads_per_tile > DENSE_QUADS_PER_TILE:
        return DENSE_TILE_H
    if median_h <= SHORT_QUAD_H:
        return DENSE_TILE_H
    return TILE_H


def pick_tile_h(fields: np.ndarray, count: int, height: int, width: int) -> int:
    """The tile height of a tape from its rows (executor.pick_tile_h): the
    density summary the native walk's fd_density gives, computed from the
    live quads' bboxes (padding rows, zero bboxes, do not count), through
    tile_h_from_density's rule."""
    f = fields[:count]
    bw = np.maximum(f[:, QF_BBOX_X1] - f[:, QF_BBOX_X0], 0.0)
    bh = np.maximum(f[:, QF_BBOX_Y1] - f[:, QF_BBOX_Y0], 0.0)
    live = (bw > 0) & (bh > 0)
    if not live.any():
        return tile_h_from_density(0.0, -1.0, height, width)
    pairs = (((bw // TILE_W) + 1) * ((bh // TILE_H) + 1))[live]
    return tile_h_from_density(float(pairs.sum()), float(np.median(bh[live])),
                               height, width)


# base sdf modes that sample the atlas (raster_pallas.ATLAS_BASE_MODES): the
# atlas quad, MSDF / MTSDF and their annular forms
ATLAS_BASE_MODES = (0, 13, 14, 15, 16)
BACKDROP_BASE_MODE = 17
_ATLAS_MODE_LUT = np.zeros(128, bool)
_ATLAS_MODE_LUT[list(ATLAS_BASE_MODES)] = True


def tape_structure(tape: Tape, modes: np.ndarray):
    """The pass structure of a tape from its mode lanes
    (executor.tape_structure): (structure, bounds, radii, is_atlas_mode,
    is_backdrop_mode), the structure items as check_structure takes them.
    A draw run is ("draw", target, uses_atlas, needs_backdrop): it reads the
    backdrop when a blur came before it and one of its quads is a backdrop
    quad. Empty runs are dropped."""
    base_modes = (modes[:, QI_MODE] % 256) % 128  # strip fill + elliptical
    is_atlas_mode = _ATLAS_MODE_LUT[base_modes]
    is_backdrop_mode = base_modes == BACKDROP_BASE_MODE
    structure = []
    bounds = []
    radii = []
    seen_blur = False
    for item in tape.items:
        if isinstance(item, ClearMaskItem):
            structure.append(("clear_mask", item.index))
        elif isinstance(item, BlurItem):
            structure.append(("blur",))
            radii.append(item.radius)
            seen_blur = True
        elif isinstance(item, DrawItem):
            if item.end <= item.start:
                continue
            uses_atlas = bool(is_atlas_mode[item.start : item.end].any())
            needs_backdrop = seen_blur and bool(
                is_backdrop_mode[item.start : item.end].any())
            structure.append(("draw", item.target, uses_atlas, needs_backdrop))
            bounds.append((item.start, item.end))
    return structure, bounds, radii, is_atlas_mode, is_backdrop_mode


def pack_tape_combo(tape: Tape, n_pad: int, bounds, radii, clear_color) -> np.ndarray:
    """A tape's logical rows in the packed upload layout
    (executor.pack_tape_combo): (n_pad + meta rows, PACKED_WIDTH) f32, the
    quad rows packed, the padding rows zero, the meta tail filled; the
    Python walk's twin of the native fd_export_combo_packed."""
    c = tape.count
    combo = np.zeros((n_pad + meta_rows(len(bounds), len(radii), PACKED_WIDTH),
                      PACKED_WIDTH), dtype=np.float32)
    pack_fields_np(tape.fields[:c], tape.modes[:c], out=combo[:c])
    fill_meta(combo[n_pad:].reshape(-1), bounds, radii, clear_color)
    return combo


def pack_walked_tape(tape: Tape) -> None:
    """Give a tape of the Python walk what the native export gives it: the
    structure cache (from its mode lanes) and the packed combo, padded to
    its quad bucket, whose meta tail carries the draw bounds and blur radii
    (only the clear color when the tape takes the megakernel or the rolled
    form). A tape that has them already is left as it is."""
    if tape.structure_cache is not None:
        return
    structure, bounds, radii, is_atlas, is_backdrop = tape_structure(
        tape, tape.modes[: tape.count])
    tape.structure_cache = (structure, bounds, radii, bool(is_atlas.any()),
                            bool(is_backdrop.any()))
    rolled = len(structure) > ROLLED_THRESHOLD
    n_pad = bucket(max(tape.count, 1))
    tape.combo = pack_tape_combo(tape, n_pad, [] if rolled else bounds,
                                 [] if rolled else radii,
                                 tape.clear_color or (0.0, 0.0, 0.0, 0.0))
    tape.combo_quads = n_pad


def _mega_splice(tape: Tape, bbox: np.ndarray, qmask: np.ndarray):
    """What the megakernel's tape adds to a tape of n quads with (n, 4)
    bboxes and (n,) mask reads: (per-quad target (n,) i32: 0 the frame,
    k + 1 mask plane k; the tape index each clear sentinel precedes (c,)
    i64, in item order; the sentinels' planes (c,) i32; their bboxes (c, 4)
    f32).

    A clear of plane k is only observed where plane k is read or written
    before its next clear, so the sentinel's bbox is the union of those
    quads' bboxes (a degenerate bbox when there are none): it bins only
    into the tiles its cell touches, and the kernel drops it with them."""
    n = bbox.shape[0]
    tgt = np.zeros(n, np.int32)
    positions = []
    plane_list = []
    cursor = 0
    for item in tape.items:
        if isinstance(item, DrawItem):
            if item.end > item.start and item.target >= 0:
                tgt[item.start : item.end] = item.target + 1
            cursor = max(cursor, item.end)
        elif isinstance(item, ClearMaskItem):
            positions.append(cursor)
            plane_list.append(item.index)
    planes = np.asarray(plane_list, np.int32)
    positions = np.asarray(positions, np.int64)
    nc = positions.shape[0]
    cb = np.zeros((nc, 4), np.float32)
    for k in np.unique(planes) if n else ():
        rel = (tgt == k + 1) | (qmask == k)
        lo = np.where(rel[:, None], bbox[:, 0:2], np.float32(np.inf))
        hi = np.where(rel[:, None], bbox[:, 2:4], np.float32(-np.inf))
        sel = planes == k
        # segments between consecutive clears of plane k (the last runs to
        # the end); reduceat gives x[start] for an empty segment, which is
        # overwritten below
        starts = positions[sel]
        r_starts = np.minimum(starts, n - 1)
        mins = np.minimum.reduceat(lo, r_starts, axis=0)
        maxs = np.maximum.reduceat(hi, r_starts, axis=0)
        empty = starts >= np.append(starts[1:], n)
        mins[empty] = np.inf
        maxs[empty] = -np.inf
        cb[sel, 0:2] = mins
        cb[sel, 2:4] = maxs
    # a clear whose plane is never touched again gets a degenerate bbox
    cb[~np.isfinite(cb).all(axis=1)] = 0.0
    return tgt, positions, planes, cb


def pack_mega_combo(tape: Tape) -> np.ndarray:
    """The megakernel's upload of a tape, (bucket(quads + clears) + 1, 52)
    f32 with the clear color in the last row (executor.pack_mega_modes'
    rows, packed): draw-run quads get (target + 1) << MEGA_TARGET_SHIFT
    added to the mode lane, and each ClearMaskItem becomes a sentinel row
    with MEGA_CLEAR_BIT set and the bbox _mega_splice gives it. The splice
    works on the tape's packed rows as they are (the bbox and the mode lanes
    ride the wire unpacked; a sentinel's other columns are zeros), so a long
    tape is not unpacked and packed again."""
    n = tape.count
    packed = tape.combo[:n]
    lanes = packed[:, PACKED_MODES : PACKED_MODES + QI_WIDTH].view(np.int32)
    tgt, positions, planes, cb = _mega_splice(
        tape, packed[:, QF_BBOX_X0 : QF_BBOX_Y1 + 1], lanes[:, QI_MASK])
    nc = positions.shape[0]
    out = np.zeros((bucket(max(n + nc, 1)) + 1, PACKED_WIDTH), np.float32)
    # quad i lands after the sentinels that precede it
    dest = np.arange(n) + np.searchsorted(positions, np.arange(n), side="right")
    out[dest] = packed
    out_lanes = out[:, PACKED_MODES : PACKED_MODES + QI_WIDTH].view(np.int32)
    out_lanes[dest, QI_MODE] += tgt << MEGA_TARGET_SHIFT
    at = positions + np.arange(nc)
    out[at, QF_BBOX_X0 : QF_BBOX_Y1 + 1] = cb
    out_lanes[at, QI_MODE] = MEGA_CLEAR_BIT + ((planes + 1) << MEGA_TARGET_SHIFT)
    out[-1, :4] = tape.clear_color or (0.0, 0.0, 0.0, 0.0)
    return out


@dataclass
class ExecPlan:
    """What renderer._ExecPlan holds on the frame-executor path."""

    combo: np.ndarray  # (bucket + meta rows, 52) f32 packed upload
    structure: Tuple  # ("draw", target, uses_atlas, needs_backdrop) |
    # ("blur",) | ("clear_mask", k)
    bounds: List[Tuple[int, int]]  # per draw item [start, end)
    radii: List[float]  # per blur item
    height: int
    width: int
    n_masks: int
    tile_h: int
    has_init_frame: bool
    # (bucket(quads + clears) + 1, 52) megakernel upload (pack_mega_combo;
    # the last row holds the clear color), or None
    mega_combo: Optional[np.ndarray] = None
    # the mega tape holds atlas quads: the megakernel samples the atlas
    mega_atlas: bool = False
    # the rolled executor's (n, 4) i32 item table and (n,) f32 blur radii
    # (build_rolled_items), or None; the combo's meta is then one row, the
    # clear color
    rolled_items: Optional[np.ndarray] = None
    rolled_radii: Optional[np.ndarray] = None


def check_structure(structure, n_masks: int) -> Tuple:
    """The structure as the executors key it: ("draw", target, uses_atlas,
    needs_backdrop) | ("blur",) | ("clear_mask", k)."""
    if n_masks < 1:
        raise ValueError(f"n_masks must be >= 1, got {n_masks}")
    out = []
    for item in structure:
        if item[0] == "blur":
            out.append(("blur",))
        elif item[0] == "clear_mask":
            out.append(("clear_mask", int(item[1])))
        elif item[0] == "draw":
            _, target, uses_atlas, needs_backdrop = item[:4]
            out.append(("draw", int(target), bool(uses_atlas),
                        bool(needs_backdrop)))
        else:
            raise ValueError(f"unknown pass item {item!r}")
    return tuple(out)


# rolled item kinds (executor.ITEM_*; the JAX table's ITEM_NOOP = 0 pads it
# to a compile-cost bucket, which the port has no use for)
ITEM_DRAW_SDF = 1
ITEM_DRAW_ATLAS = 2
ITEM_DRAW_SDF_BD = 3
ITEM_DRAW_MASK = 4
ITEM_BLUR = 5
ITEM_CLEAR_MASK = 6


def build_rolled_items(structure, bounds, radii):
    """The rolled executor's item table (renderer._build_rolled_items,
    without its padding): (n, 4) i32 rows [kind, target, start, end] and
    (n,) f32 blur radii, one per item. A frame run with an atlas quad is
    ITEM_DRAW_ATLAS, else ITEM_DRAW_SDF_BD when it reads the backdrop, else
    ITEM_DRAW_SDF; a mask run is ITEM_DRAW_MASK."""
    items = np.zeros((len(structure), 4), np.int32)
    out_radii = np.zeros((len(structure),), np.float32)
    di = 0
    bi = 0
    for i, item in enumerate(structure):
        if item[0] == "clear_mask":
            items[i] = (ITEM_CLEAR_MASK, item[1], 0, 0)
        elif item[0] == "blur":
            items[i] = (ITEM_BLUR, 0, 0, 0)
            out_radii[i] = radii[bi]
            bi += 1
        else:
            _, target, uses_atlas, needs_backdrop = item[:4]
            s, e = bounds[di]
            di += 1
            if target == FRAME_TARGET:
                kind = (ITEM_DRAW_ATLAS if uses_atlas else
                        ITEM_DRAW_SDF_BD if needs_backdrop else ITEM_DRAW_SDF)
                items[i] = (kind, 0, s, e)
            else:
                items[i] = (ITEM_DRAW_MASK, target, s, e)
    return items, out_radii


def _plan(tape: Tape, rolled: Optional[bool]) -> ExecPlan:
    """The plan of a tape; rolled: None for plan_execution's own routing of
    long tapes, True for the rolled item table whatever the tape holds."""
    width = int(round(tape.frame_size[0]))
    height = int(round(tape.frame_size[1]))
    n_masks = tape.mask_count + 1
    pack_walked_tape(tape)
    structure, bounds, radii, any_atlas, any_backdrop = tape.structure_cache
    if tape.combo_quads != bucket(max(tape.count, 1)):
        raise ValueError("tape combo was not padded to its quad bucket")
    checked = check_structure(structure, n_masks)
    long = len(structure) > ROLLED_THRESHOLD
    if rolled is None:
        rolled = long and bool(any_backdrop or radii)
    mega_combo = rolled_items = rolled_radii = None
    if rolled:
        rolled_items, rolled_radii = build_rolled_items(checked, bounds, radii)
    elif long:
        mega_combo = pack_mega_combo(tape)
    return ExecPlan(
        combo=tape.combo, structure=checked,
        bounds=list(bounds), radii=list(radii), height=height, width=width,
        n_masks=n_masks,
        tile_h=(tile_h_from_density(*tape.tile_density, height, width)
                if tape.tile_density is not None
                else pick_tile_h(tape.fields, tape.count, height, width)),
        has_init_frame=tape.clear_color is None, mega_combo=mega_combo,
        mega_atlas=mega_combo is not None and bool(any_atlas),
        rolled_items=rolled_items, rolled_radii=rolled_radii,
    )


def plan_execution(tape: Tape) -> ExecPlan:
    """Derive the pass structure, pick the tile height, and take the packed
    upload buffer (the native walk's as is; a walked tape's packed by
    pack_walked_tape). A tape of more than ROLLED_THRESHOLD
    items also gets the rolled item table when it holds a blur or a
    backdrop, else the megakernel's combo, atlas runs included. (The JAX
    default keeps atlas scenes off its megakernel, renderer.py:1123-1166,
    for the cost of its in-kernel VMEM window on a TPU v5e; on the H100 a
    gather is a load and one launch beats a pass per item.)"""
    return _plan(tape, None)


def plan_rolled(tape: Tape) -> ExecPlan:
    """The plan of a tape on the frame executor's rolled form, whatever
    plan_execution would route it to. snapshot_scene(animate=True) takes it
    for a long tape with clip masks, whose megakernel combo would interleave
    clear sentinel rows; the tests and chip_smoke.py hold the megakernel's
    frame and time against a pass per item with it. render_frame never
    calls it."""
    return _plan(tape, True)


def from_jax_plan(jax_plan) -> ExecPlan:
    """The port's plan from a figdraw_tpu.renderer._ExecPlan (read through
    its numpy fields only), so one tape can run through both packages'
    executors. The plan keeps the JAX package's route: a mega plan carries
    its megakernel combo (and mega_atlas, when JAX planned it with the
    in-kernel sampler; the 1:1 marks in bit 13 of its mode lanes ride along
    and are ignored), a rolled plan gets its item table. Run it with the
    JAX renderer's atlas (atlas_from_jax)."""
    mega = jax_plan.mega_combo
    structure = check_structure(jax_plan.structure, jax_plan.n_masks)
    bounds = [tuple(int(v) for v in b) for b in jax_plan.bounds]
    radii = [float(r) for r in jax_plan.radii]
    rolled_items = rolled_radii = None
    if len(structure) > ROLLED_THRESHOLD and mega is None:
        rolled_items, rolled_radii = build_rolled_items(structure, bounds, radii)
    return ExecPlan(
        combo=np.asarray(jax_plan.combo, np.float32), structure=structure,
        bounds=bounds, radii=radii,
        height=int(jax_plan.height), width=int(jax_plan.width),
        n_masks=int(jax_plan.n_masks), tile_h=int(jax_plan.tile_h),
        has_init_frame=bool(jax_plan.has_init_frame),
        mega_combo=None if mega is None else np.asarray(mega, np.float32),
        mega_atlas=mega is not None and bool(getattr(jax_plan, "mega_atlas", False)),
        rolled_items=rolled_items, rolled_radii=rolled_radii,
    )


def atlas_from_jax(jax_atlas, device="cpu") -> torch.Tensor:
    """The (S, S, 4) f32 atlas tensor from figdraw_tpu's renderer atlas
    data (`FigRenderer.atlas.data`, numpy), for execute_plan."""
    data = np.asarray(jax_atlas, np.float32)
    if data.ndim != 3 or data.shape[0] != data.shape[1] or data.shape[2] != 4:
        raise ValueError(f"atlas must be (S, S, 4), got {data.shape}")
    return torch.from_numpy(data).to(device, copy=True)
