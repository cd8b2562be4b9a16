"""Frame executor: the device half of a frame, as plain functions on tensors
(figdraw_tpu/executor.py `unpack_combo_device` and `get_frame_executor`).

The packed upload is decoded on the device, the whole tape is binned once,
and the pass structure (draw → blur → draw with backdrop on the headline
scene) runs in order. No value goes back to the host: draw bounds, blur
radii and the clear color stay device tensors, and the raster kernel reads
its run's bounds itself.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .ops.binning import bin_quads
from .ops.blur import backdrop_blur_planar
from .ops.layout import PACKED_MODES, PACKED_WIDTH
from .ops.raster import TILE_W, draw_pass_planar_prebinned
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


@lru_cache(maxsize=64)
def get_frame_executor(structure: Tuple, height: int, width: int,
                       n_masks: int, has_init_frame: bool, tile_h: int):
    """run(combo, init_frame) -> (height, width, 4) f32 frame, for one pass
    structure (plan.check_structure's items). combo: the plan's upload on
    the device; init_frame: the (height, width, 4) previous frame, read only
    when has_init_frame (frames that do not clear). draw: the draw pass, the
    raster kernel's wrapper unless a check substitutes its plain version."""
    th, tw = tile_h, TILE_W
    tiles_y = -(-height // th)
    tiles_x = -(-width // tw)
    ph, pw = tiles_y * th, tiles_x * tw
    any_blur = any(item[0] == "blur" for item in structure)
    n_draws = sum(1 for item in structure if item[0] == "draw")
    n_blurs = sum(1 for item in structure if item[0] == "blur")
    rows = meta_rows(n_draws, n_blurs, PACKED_WIDTH)
    if any(item[0] == "draw" and item[1] != FRAME_TARGET for item in structure):
        raise NotImplementedError("the frame executor draws into the frame only")

    def run(combo: torch.Tensor, init_frame=None,
            draw=draw_pass_planar_prebinned) -> torch.Tensor:
        dev = combo.device
        fields, modes = unpack_combo(combo[:-rows])
        meta = combo[-rows:].reshape(-1)
        bounds = meta[: 2 * n_draws].view(torch.int32).reshape(-1, 2)
        radii = meta[2 * n_draws : 2 * n_draws + n_blurs]
        clear_color = meta[2 * n_draws + n_blurs : 2 * n_draws + n_blurs + 4]

        if has_init_frame:
            planes = torch.nn.functional.pad(
                init_frame.permute(2, 0, 1), (0, pw - width, 0, ph - height)
            ).contiguous()
        else:
            planes = clear_color[:, None, None].expand(4, ph, pw).contiguous()
        masks = torch.zeros((n_masks, ph, pw), dtype=torch.float32, device=dev)
        masks[0] = 1.0
        backdrop = (torch.zeros((4, ph, pw), dtype=torch.float32, device=dev)
                    if any_blur else None)

        # one binning serves every draw of the frame; each run selects its
        # contiguous segment of a tile's list, and occlusion culling stays
        # run-scoped through run_bounds
        tile_idx, tile_counts = bin_quads(
            fields, 0, fields.shape[0], tiles_y, tiles_x, th, tw,
            modes=modes, run_bounds=bounds,
        )

        di = 0
        bi = 0
        for item in structure:
            if item[0] == "blur":
                backdrop = backdrop_blur_planar(planes, radii[bi])
                bi += 1
            else:
                needs_backdrop = item[3]
                planes = draw(
                    fields, modes, bounds[di], tile_idx, tile_counts, planes,
                    masks, backdrop if needs_backdrop else None, tile_h=th,
                )
                di += 1
        return planes.permute(1, 2, 0)[:height, :width].contiguous()

    return run
