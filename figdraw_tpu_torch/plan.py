"""Host half of a frame: pass structure, upload buffer and executor
parameters (figdraw_tpu/renderer.py `_plan_execution` on its
frame-executor path, with the host helpers of figdraw_tpu/executor.py).

The slice plans frames the unrolled frame executor runs: draw runs into the
frame and backdrop blurs. Scenes that need another path raise
NotImplementedError naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .ops.raster import TILE_H, TILE_W
from .tape import FRAME_TARGET, Tape

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


@dataclass
class ExecPlan:
    """What renderer._ExecPlan holds on the frame-executor path."""

    combo: np.ndarray  # (bucket + meta rows, 52) f32 packed upload
    structure: Tuple  # ("draw", target, uses_atlas, needs_backdrop) | ("blur",)
    bounds: List[Tuple[int, int]]  # per draw item [start, end)
    radii: List[float]  # per blur item
    height: int
    width: int
    n_masks: int
    tile_h: int
    has_init_frame: bool


def check_structure(structure, n_masks: int) -> Tuple:
    """The structure as the slice's executor keys it; raises
    NotImplementedError for passes another ROADMAP item ports."""
    if len(structure) > ROLLED_THRESHOLD:
        raise NotImplementedError(
            f"{len(structure)} pass items need the rolled executor or the "
            "megakernel (ROADMAP.md, port item 'Masks')")
    out = []
    for item in structure:
        if item[0] == "blur":
            out.append(("blur",))
        elif item[0] == "draw":
            _, target, uses_atlas, needs_backdrop = item[:4]
            if target != FRAME_TARGET:
                raise NotImplementedError(
                    "mask-target draws run on kernel K3 (ROADMAP.md, port "
                    "item 'Masks')")
            if uses_atlas:
                raise NotImplementedError(
                    "atlas runs (text, images) need kernel K1-atlas "
                    "(ROADMAP.md, port item 'Atlas')")
            out.append(("draw", FRAME_TARGET, False, bool(needs_backdrop)))
        else:
            raise NotImplementedError(
                f"pass item {item[0]!r} belongs to the masked executors "
                "(ROADMAP.md, port item 'Masks')")
    if n_masks != 1:
        raise NotImplementedError(
            "mask planes belong to the masked executors (ROADMAP.md, port "
            "item 'Masks')")
    return tuple(out)


def plan_execution(tape: Tape) -> ExecPlan:
    """Derive the pass structure, pick the tile height, and take the
    native walk's packed upload buffer as is."""
    width = int(round(tape.frame_size[0]))
    height = int(round(tape.frame_size[1]))
    n_masks = tape.mask_count + 1
    structure, bounds, radii, _any_atlas, _any_backdrop = tape.structure_cache
    structure = check_structure(structure, n_masks)
    if tape.combo_quads != bucket(max(tape.count, 1)):
        raise ValueError("tape combo was not padded to its quad bucket")
    return ExecPlan(
        combo=tape.combo, structure=structure, bounds=list(bounds),
        radii=list(radii), height=height, width=width, n_masks=n_masks,
        tile_h=tile_h_from_density(*tape.tile_density, height, width),
        has_init_frame=tape.clear_color is None,
    )


def from_jax_plan(jax_plan) -> ExecPlan:
    """The port's plan from a figdraw_tpu.renderer._ExecPlan (read through
    its numpy fields only), so one tape can run through both executors."""
    return ExecPlan(
        combo=np.asarray(jax_plan.combo, np.float32),
        structure=check_structure(jax_plan.structure, jax_plan.n_masks),
        bounds=[tuple(int(v) for v in b) for b in jax_plan.bounds],
        radii=[float(r) for r in jax_plan.radii],
        height=int(jax_plan.height), width=int(jax_plan.width),
        n_masks=int(jax_plan.n_masks), tile_h=int(jax_plan.tile_h),
        has_init_frame=bool(jax_plan.has_init_frame),
    )
