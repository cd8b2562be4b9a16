"""Executors: the device half of a frame, as plain functions on tensors
(figdraw_tpu/executor.py `unpack_combo_device`, `get_frame_executor` and
`get_mega_executor`).

The packed upload is decoded on the device and the whole tape is binned
once. The frame executor then runs the pass structure in order: draw runs
into the frame (K1) or into a mask plane (K3), mask clears and backdrop
blurs. The mega executor runs the whole masked frame in one kernel (K4). No
value goes back to the host: draw bounds, blur radii and the clear color
stay device tensors, and the kernels read their run's bounds themselves.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .ops.binning import bin_quads
from .ops.blur import backdrop_blur_planar
from .ops.layout import PACKED_MODES, PACKED_WIDTH
from .ops.mega import draw_pass_mega
from .ops.raster import TILE_W, draw_pass_mask_prebinned, draw_pass_planar_prebinned
from .plan import meta_rows
from .tape import FRAME_TARGET

# k/255 as float32, computed on the host once: a division on the device may
# be rewritten into a multiply by 1/255, which is 1 ULP off the walk's own
# quantization (c/255.0f) and breaks the bit-exact decode
_U8_LUT = np.arange(256, dtype=np.float32) / np.float32(255.0)


def unpack_combo(rows: torch.Tensor):
    """Inverse of the packed wire layout: (N, PACKED_WIDTH) f32 rows ->
    ((N, 68) f32 fields, (N, 2) i32 modes), bit-identical to the pre-pack
    tape. Colors ride as six u8x4 words; each byte goes through the k/255
    table."""
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
                       n_masks: int, has_init_frame: bool, tile_h: int):
    """run(combo, init_frame) -> (height, width, 4) f32 frame, for one pass
    structure (plan.check_structure's items). combo: the plan's upload on
    the device; init_frame: the (height, width, 4) previous frame, read only
    when has_init_frame (frames that do not clear). draw / draw_mask: the
    frame and mask passes, the K1 and K3 wrappers unless a check
    substitutes their plain versions."""
    th, tw = tile_h, TILE_W
    tiles_y = -(-height // th)
    tiles_x = -(-width // tw)
    ph, pw = tiles_y * th, tiles_x * tw
    any_blur = any(item[0] == "blur" for item in structure)
    draws = [item for item in structure if item[0] == "draw"]
    n_draws = len(draws)
    n_blurs = sum(1 for item in structure if item[0] == "blur")
    rows = meta_rows(n_draws, n_blurs, PACKED_WIDTH)
    # positions of the frame-target runs among the draws: only they are
    # occlusion- and saturation-culled (executor.py:319-347)
    frame_pos = [i for i, item in enumerate(draws) if item[1] == FRAME_TARGET]

    def run(combo: torch.Tensor, init_frame=None, draw=draw_pass_planar_prebinned,
            draw_mask=draw_pass_mask_prebinned) -> torch.Tensor:
        dev = combo.device
        fields, modes = unpack_combo(combo[:-rows])
        meta = combo[-rows:].reshape(-1)
        bounds = meta[: 2 * n_draws].view(torch.int32).reshape(-1, 2)
        radii = meta[2 * n_draws : 2 * n_draws + n_blurs]
        clear_color = meta[2 * n_draws + n_blurs : 2 * n_draws + n_blurs + 4]

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
        run_bounds = bounds[frame_pos] if frame_pos else None
        tile_idx, tile_counts = bin_quads(
            fields, 0, fields.shape[0], tiles_y, tiles_x, th, tw,
            modes=modes if frame_pos else None, run_bounds=run_bounds,
        )

        di = 0
        bi = 0
        for item in structure:
            if item[0] == "blur":
                backdrop = backdrop_blur_planar(planes, radii[bi])
                bi += 1
            elif item[0] == "clear_mask":
                masks[item[1]] = 0.0
            elif item[1] == FRAME_TARGET:
                needs_backdrop = item[3]
                planes = draw(
                    fields, modes, bounds[di], tile_idx, tile_counts, planes,
                    masks, backdrop if needs_backdrop else None, tile_h=th,
                )
                di += 1
            else:
                # the kernel reads every plane as it was before the pass and
                # writes a new one, so the store below is the only update
                masks[item[1]] = draw_mask(
                    fields, modes, bounds[di], tile_idx, tile_counts,
                    masks[item[1]][None].contiguous(), masks, tile_h=th,
                )[0]
                di += 1
        return planes.permute(1, 2, 0)[:height, :width].contiguous()

    return run


@lru_cache(maxsize=32)
def get_mega_executor(height: int, width: int, n_masks: int,
                      has_init_frame: bool, tile_h: int):
    """run(combo, init_frame) -> (height, width, 4) f32 frame through the
    megakernel (executor.get_mega_executor). combo: target-baked packed rows
    (plan.pack_mega_modes or native.flatten_fast's mega export) and one meta
    row whose first four values are the clear color; init_frame as in
    get_frame_executor. draw: the K4 wrapper unless a check substitutes its
    plain version."""
    th, tw = tile_h, TILE_W
    tiles_y = -(-height // th)
    tiles_x = -(-width // tw)
    ph, pw = tiles_y * th, tiles_x * tw

    def run(combo: torch.Tensor, init_frame=None,
            draw=draw_pass_mega) -> torch.Tensor:
        fields, modes = unpack_combo(combo[:-1])
        planes = _init_planes(combo[-1, 0:4], init_frame, has_init_frame,
                              height, width, ph, pw)
        # no culling: a mask write or a clear never truncates a list
        tile_idx, tile_counts = bin_quads(fields, 0, fields.shape[0], tiles_y,
                                          tiles_x, th, tw)
        planes = draw(fields, modes, tile_idx, tile_counts, planes, n_masks,
                      tile_h=th)
        return planes.permute(1, 2, 0)[:height, :width].contiguous()

    return run
