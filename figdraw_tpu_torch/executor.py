"""Executors: the device half of a frame, as plain functions on tensors
(figdraw_tpu/executor.py `unpack_combo_device`, `get_frame_executor` with
its rolled form `get_rolled_executor`, `get_mega_executor`, and
`get_batch_runner` as `BatchStack` and `run_batch`).

The packed upload is decoded and the whole tape binned once, in one front
end call (ops/binning.decode_and_bin: the front kernel, the decode fused
with the binning's per-quad terms, then the tile kernel). The frame
executor then runs the pass structure in order: draw runs
into the frame (K1, K1-atlas) or into a mask plane (K3), mask clears and
backdrop blurs (the blur kernel of ops/blur.py); its rolled form takes the bounds and radii of frames of
many items from the plan's item table. The mega executor runs the whole
masked frame in one kernel (K4, or K4-atlas when the tape samples the
atlas). No value goes back to the host: draw
bounds, blur radii and the clear color stay device tensors, and the
kernels read their run's bounds themselves.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from .ops.binning import decode_and_bin, unpack_combo  # noqa: F401 - unpack_combo re-exported
from .ops.blur import backdrop_blur_planar
from .ops.layout import PACKED_WIDTH
from .ops.mega import draw_pass_mega
from .ops.raster import TILE_W, draw_pass_mask_prebinned, draw_pass_planar_prebinned
from .plan import meta_rows
from .tape import FRAME_TARGET

def item_rows(structure: Tuple, rolled: bool) -> list:
    """Each item's row of the bounds (draws) or radii (blurs): the item's own
    row of the rolled table, else its place among the meta's draws or
    blurs."""
    if rolled:
        return list(range(len(structure)))
    counts = {"draw": 0, "blur": 0, "clear_mask": 0}
    rows = []
    for item in structure:
        rows.append(counts[item[0]])
        counts[item[0]] += 1
    return rows


def read_meta(combo: torch.Tensor, structure: Tuple, rolled: bool, items=None,
              radii=None):
    """(draw bounds (D, 2) i32, blur radii, clear color (4,), meta rows) of
    a frame upload on its device: from the combo's meta tail, or for the
    rolled form from its item table and radii (numpy, uploaded here, or
    tensors on the combo's device) and the one meta row."""
    if rolled:
        if isinstance(items, np.ndarray):
            items = torch.from_numpy(items).to(combo.device)
            radii = torch.from_numpy(radii).to(combo.device)
        return items[:, 2:4].contiguous(), radii, combo[-1, 0:4], 1
    n_draws = sum(1 for item in structure if item[0] == "draw")
    n_blurs = sum(1 for item in structure if item[0] == "blur")
    rows = meta_rows(n_draws, n_blurs, PACKED_WIDTH)
    meta = combo[-rows:].reshape(-1)
    return (meta[: 2 * n_draws].view(torch.int32).reshape(-1, 2),
            meta[2 * n_draws : 2 * n_draws + n_blurs],
            meta[2 * n_draws + n_blurs : 2 * n_draws + n_blurs + 4], rows)


def _init_planes(combo_clear, init_frame, has_init_frame: bool, height: int,
                 width: int, ph: int, pw: int):
    """The (4, PH, PW) planes a frame starts from: the previous frame padded
    to the tiles, or the clear color."""
    if has_init_frame:
        return torch.nn.functional.pad(
            init_frame.permute(2, 0, 1), (0, pw - width, 0, ph - height)
        ).contiguous()
    return combo_clear[:, None, None].expand(4, ph, pw).contiguous()


@lru_cache(maxsize=64)
def get_frame_executor(structure: Tuple, height: int, width: int,
                       n_masks: int, has_init_frame: bool, tile_h: int,
                       rolled: bool = False):
    """run(combo, init_frame, atlas, ...) -> (height, width, 4) f32 frame,
    for one pass structure (plan.check_structure's items). combo: the
    plan's upload on the device; init_frame: the (height, width, 4) previous
    frame, read only when has_init_frame (frames that do not clear); atlas:
    the (S, S, 4) f32 atlas, passed with pixelate and subpixel_positioning
    to every draw whose run holds an atlas quad, frame and mask runs alike.
    draw / draw_mask: the frame and mask passes, the K1 and K3 wrappers
    (which update the executor's own planes in place) unless a check
    substitutes their plain versions (which return new planes). The
    caller's init_frame is never written.

    rolled: the rolled form (executor.get_rolled_executor:590-751), for
    plans of more than ROLLED_THRESHOLD items. The combo's meta is then one
    row, the clear color; run's items and radii, the plan's item table
    (plan.build_rolled_items: numpy, uploaded here, or tensors on the
    combo's device, as a batch passes them), give each item's draw bounds
    and blur radius; and the tape is binned with no culling. JAX rolls the
    item loop into a lax.fori_loop to keep its compile cost constant; here
    both forms walk the same host loop."""
    th, tw = tile_h, TILE_W
    tiles_y = -(-height // th)
    tiles_x = -(-width // tw)
    ph, pw = tiles_y * th, tiles_x * tw
    any_blur = any(item[0] == "blur" for item in structure)
    draws = [item for item in structure if item[0] == "draw"]
    item_row = item_rows(structure, rolled)
    # positions of the frame-target runs among the draws: only they are
    # occlusion- and saturation-culled (executor.py:319-347); the rolled
    # form culls nothing (executor.py:634-640)
    frame_pos = [] if rolled else [
        i for i, item in enumerate(draws) if item[1] == FRAME_TARGET]
    frame_rows = {}  # device -> frame_pos as an index tensor there, made once

    def run(combo: torch.Tensor, init_frame=None, atlas=None,
            pixelate: bool = False, subpixel_positioning: bool = False,
            draw=draw_pass_planar_prebinned,
            draw_mask=draw_pass_mask_prebinned,
            items: Optional[np.ndarray] = None,
            radii: Optional[np.ndarray] = None) -> torch.Tensor:
        dev = combo.device
        bounds, blur_radii, clear_color, rows = read_meta(combo, structure, rolled,
                                                          items, radii)

        planes = _init_planes(clear_color, init_frame, has_init_frame, height,
                              width, ph, pw)
        masks = torch.zeros((n_masks, ph, pw), dtype=torch.float32, device=dev)
        masks[0] = 1.0
        backdrop = (torch.zeros((4, ph, pw), dtype=torch.float32, device=dev)
                    if any_blur else None)

        # one binning serves every draw of the frame; each run selects its
        # contiguous segment of a tile's list. Culling stays scoped to the
        # frame-target runs, and a frame without one is not culled at all:
        # a mask write's quads never truncate a list
        run_bounds = None
        if frame_pos:
            rows_at = frame_rows.get(dev)
            if rows_at is None:
                rows_at = frame_rows[dev] = torch.tensor(frame_pos, device=dev)
            run_bounds = bounds.index_select(0, rows_at)
        n = combo.shape[0] - rows
        fields, modes, tile_idx, tile_counts = decode_and_bin(
            combo[:n], 0, n, tiles_y, tiles_x, th, tw, cull=bool(frame_pos),
            run_bounds=run_bounds,
        )

        flags = dict(tile_h=th, pixelate=pixelate,
                     subpixel_positioning=subpixel_positioning)
        for item, row in zip(structure, item_row):
            if item[0] == "blur":
                backdrop = backdrop_blur_planar(planes, blur_radii[row])
            elif item[0] == "clear_mask":
                masks[item[1]] = 0.0
            elif item[1] == FRAME_TARGET:
                planes = draw(
                    fields, modes, bounds[row], tile_idx, tile_counts, planes,
                    masks, backdrop if item[3] else None,
                    atlas=atlas if item[2] else None, **flags)
            else:
                # the kernel writes the plane in place, and each pixel's
                # quads read every plane, this one too, before the pixel is
                # written; a plain version returns a new plane to store
                plane = masks[item[1] : item[1] + 1]
                out = draw_mask(fields, modes, bounds[row], tile_idx,
                                tile_counts, plane, masks,
                                atlas=atlas if item[2] else None, **flags)
                if out is not plane:
                    plane.copy_(out)
        return planes.permute(1, 2, 0)[:height, :width].contiguous()

    return run


@lru_cache(maxsize=32)
def get_mega_executor(height: int, width: int, n_masks: int,
                      has_init_frame: bool, tile_h: int):
    """run(combo, init_frame, atlas, ...) -> (height, width, 4) f32 frame
    through the megakernel (executor.get_mega_executor). combo: target-baked
    packed rows (plan.pack_mega_combo or native.flatten_fast's mega export)
    and one meta row whose first four values are the clear color;
    init_frame as in get_frame_executor, never written; atlas: the (S, S, 4)
    f32 atlas when the tape holds atlas quads (K4-atlas, with pixelate and
    subpixel_positioning), else None (K4). draw: the megakernel's wrapper
    (which updates the executor's own planes in place) unless a check
    substitutes its plain version (which returns new planes)."""
    th, tw = tile_h, TILE_W
    tiles_y = -(-height // th)
    tiles_x = -(-width // tw)
    ph, pw = tiles_y * th, tiles_x * tw

    def run(combo: torch.Tensor, init_frame=None, atlas=None,
            pixelate: bool = False, subpixel_positioning: bool = False,
            draw=draw_pass_mega) -> torch.Tensor:
        planes = _init_planes(combo[-1, 0:4], init_frame, has_init_frame,
                              height, width, ph, pw)
        # no culling: a mask write or a clear never truncates a list
        n = combo.shape[0] - 1
        fields, modes, tile_idx, tile_counts = decode_and_bin(
            combo[:n], 0, n, tiles_y, tiles_x, th, tw)
        planes = draw(fields, modes, tile_idx, tile_counts, planes, n_masks,
                      tile_h=th, atlas=atlas, pixelate=pixelate,
                      subpixel_positioning=subpixel_positioning)
        return planes.permute(1, 2, 0)[:height, :width].contiguous()

    return run


def _aligned(words: int) -> int:
    """words rounded up to whole 16-byte units: every buffer of a batch
    stack starts at a 16-byte address, as the front kernel reads its rows."""
    return -(-words // 4) * 4


class BatchStack:
    """The varying buffers of a group of batched frames (the JAX package's
    stacked `lax.map` operands, executor.get_batch_runner): one (chunk, L)
    f32 host row a frame, each named buffer flattened into it from a
    16-byte boundary (an int32 buffer as its bits). A frame's buffers are
    copied in when it is added, so a pooled walk buffer is free again at
    once; the group goes
    to the device as one (F, L) upload (`upload`), and `frame` gives frame
    f's buffers back as views of that one tensor, in their own shapes and
    dtypes."""

    def __init__(self, buffers: dict, chunk: int):
        self.layout = []  # (name, shape, is_int32, start, end)
        at = 0
        for name, arr in buffers.items():
            if arr.dtype not in (np.float32, np.int32):
                raise ValueError(f"batch buffer {name!r} has dtype {arr.dtype}")
            self.layout.append((name, arr.shape, arr.dtype == np.int32, at,
                                at + arr.size))
            at = _aligned(at + arr.size)
        self.host = np.zeros((chunk, at), np.float32)
        self.count = 0
        self.add(buffers)

    def add(self, buffers: dict) -> None:
        if self.count >= self.host.shape[0]:
            raise ValueError(f"a batch group holds at most {self.host.shape[0]} frames")
        row = self.host[self.count]
        for name, shape, _is_int, a, b in self.layout:
            arr = buffers[name]
            if arr.shape != shape:
                raise ValueError(f"batch buffer {name!r} is {arr.shape}, the group's {shape}")
            row[a:b] = np.ascontiguousarray(arr).reshape(-1).view(np.float32)
        self.count += 1

    def upload(self, device, start: int = 0, end: Optional[int] = None) -> torch.Tensor:
        """The group's frames [start, end) (default all) as one (F, L) f32
        tensor, one host-to-device copy."""
        end = self.count if end is None else min(end, self.count)
        return torch.from_numpy(self.host[start:end]).to(device, copy=True)

    def frame(self, stack: torch.Tensor, f: int) -> dict:
        row = stack[f]
        out = {}
        for name, shape, is_int, a, b in self.layout:
            t = row[a:b]
            out[name] = (t.view(torch.int32) if is_int else t).view(shape)
        return out


def run_batch(run, batch: BatchStack, out: torch.Tensor, **const) -> torch.Tensor:
    """The CUDA counterpart of the JAX package's `lax.map` over a chunk
    (executor.get_batch_runner): upload the group's stack once, then run the
    single-frame executor `run` on each frame's slice of it, in order,
    writing frame f into out[f] (a preallocated (F, H, W, 4) f32 tensor).
    const: the frame-invariant keywords (init_frame, atlas, pixelate).
    `lax.map` is a sequential loop on the TPU as well; each frame equals
    run's frame on the same buffers bit for bit."""
    stack = batch.upload(out.device)
    for f in range(batch.count):
        out[f] = run(**batch.frame(stack, f), **const)
    return out
