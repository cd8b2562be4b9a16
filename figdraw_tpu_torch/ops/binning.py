"""Tile binning: map quad AABBs to per-tile draw-ordered index lists, in
plain torch (figdraw_tpu/ops/binning.py:33-213).

A (T, N) intersection mask from the tape's bboxes, opaque-occlusion and
saturation culling on it, then one argsort per tile row. The sort keys are
unique (intersecting quads keep their index, the rest index + N), so any
sort gives exactly the JAX reference's lists and counts.
"""

from __future__ import annotations

import torch

from .layout import (
    QF_AA, QF_BBOX_X0, QF_BBOX_X1, QF_BBOX_Y0, QF_BBOX_Y1, QF_COLOR0,
    QF_INV_B, QF_INV_C, QF_MID_COLOR, QF_PARAMS, QF_RADII, QF_RECT_PARAMS,
    QF_STOP_COLOR, QI_MASK, QI_MODE,
)

# Translucent-stack saturation culling engages only on dense tapes (padded
# row count >= this): small scenes keep the exact opaque-only cull.
SAT_MIN_QUADS = 4096
# Cull a quad when the stack above it transmits < 2^-11 of it.
LOG2_SAT_EPS = -11.0


def bin_quads(fields, start, end, tiles_y: int, tiles_x: int, tile_h: int,
              tile_w: int, modes=None, run_bounds=None):
    """Returns (tile_idx (T, N) i32, tile_counts (T,) i32).

    tile_idx[t, :counts[t]] are the indices of quads in [start, end) whose
    bbox intersects tile t, in draw order; the rest is padding. start/end:
    ints or 0-d integer tensors on the fields' device.

    modes (frame-target runs only) enables opaque occlusion: a quad whose
    fully opaque interior covers a tile truncates the tile's list to start
    at it. Dense tapes (>= SAT_MIN_QUADS rows) also drop quads under a
    translucent stack that transmits less than 2^LOG2_SAT_EPS.

    run_bounds (with modes): (n_runs, 2) i32 [start, end) ranges of the
    frame-target draw runs when one binning serves a multi-run frame;
    culling then stays run-scoped, and quads outside every run are never
    culled.
    """
    dev = fields.device
    n = fields.shape[0]
    x0 = fields[:, QF_BBOX_X0]
    y0 = fields[:, QF_BBOX_Y0]
    x1 = fields[:, QF_BBOX_X1]
    y1 = fields[:, QF_BBOX_Y1]

    ty = torch.arange(tiles_y, dtype=torch.float32, device=dev) * tile_h
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
