"""FigRenderer: flatten a scene on the host, rasterize it on the device
(figdraw_tpu/renderer.py, the native-walk paths: the frame executor and the
megakernel).

The device is explicit: FigRenderer(device="cuda") raises when CUDA is
absent, and a "cpu" renderer runs the plain torch versions of the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from . import native
from .colors import Color, as_color
from .executor import get_frame_executor, get_mega_executor
from .geometry import Vec2
from .plan import ExecPlan, plan_execution, tile_h_from_density
from .tape import Tape

DEFAULT_SDF_AA_FACTOR = 1.2  # figbackend.nim:34


class FigRenderer:
    """Renders RendersArray scenes to (H, W, 4) float32 frames on `device`.

    atlas_size: the glyph/image atlas edge; the slice samples no atlas
    (plan.check_structure refuses atlas runs), so it is only recorded.
    """

    def __init__(self, atlas_size: int = 512, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FigRenderer(device='cuda'): CUDA is not available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.atlas_size = atlas_size
        self.aa_factor = DEFAULT_SDF_AA_FACTOR
        self.last_frame = None  # (H, W, 4) f32 tensor of the last render

    def _clear_tuple(self, clear_main: bool, clear_color):
        clear_color = as_color(clear_color)
        return ((clear_color.r, clear_color.g, clear_color.b, clear_color.a)
                if clear_main else None)

    def flatten(self, renders, frame_size: Vec2, clear_main: bool = True,
                clear_color: Color = Color(1.0, 1.0, 1.0, 1.0)) -> Tape:
        """Walk the scene into a packed quad tape (host only)."""
        return native.flatten_renders_array(
            renders, frame_size.x, frame_size.y, 1.0, 1.0, self.aa_factor,
            self._clear_tuple(clear_main, clear_color), pool_owner=id(self),
        )

    def execute(self, tape: Tape) -> torch.Tensor:
        """Plan the tape on the host, then run it on the device."""
        return self.execute_plan(plan_execution(tape))

    def _init_frame(self, has_init_frame: bool, height: int, width: int):
        """The previous frame for frames that do not clear (zeros when there
        is none of this size), else None."""
        if not has_init_frame:
            return None
        last = self.last_frame
        if last is None or tuple(last.shape[:2]) != (height, width):
            return torch.zeros((height, width, 4), dtype=torch.float32,
                               device=self.device)
        return last

    def _run_mega(self, combo: np.ndarray, height: int, width: int,
                  n_masks: int, has_init_frame: bool, tile_h: int):
        run = get_mega_executor(height, width, n_masks, has_init_frame, tile_h)
        # a synchronous copy: the walk's combo pool reuses this host buffer
        # two flattens later
        frame = run(torch.from_numpy(combo).to(self.device, copy=True),
                    self._init_frame(has_init_frame, height, width))
        self.last_frame = frame
        return frame

    def execute_plan(self, plan: ExecPlan) -> torch.Tensor:
        """Upload the plan's combo and run its executor: the megakernel for
        a mega plan, else the frame executor."""
        if plan.mega_combo is not None:
            return self._run_mega(plan.mega_combo, plan.height, plan.width,
                                  plan.n_masks, plan.has_init_frame, plan.tile_h)
        run = get_frame_executor(plan.structure, plan.height, plan.width,
                                 plan.n_masks, plan.has_init_frame, plan.tile_h)
        combo = torch.from_numpy(plan.combo).to(self.device, copy=True)
        frame = run(combo, self._init_frame(plan.has_init_frame, plan.height,
                                            plan.width))
        self.last_frame = frame
        return frame

    def render_frame(self, renders, frame_size: Vec2, clear_main: bool = True,
                     clear_color: Color = Color(1.0, 1.0, 1.0, 1.0)):
        """Full frame: flatten on the host, rasterize on the device. Returns
        the (H, W, 4) f32 frame tensor (asynchronous on CUDA).

        The walk's fast export comes first (renderer.py:1307-1317): a
        mask-heavy scene goes from the walk straight to the megakernel,
        every other scene through a tape and execute()."""
        if frame_size.x <= 0 or frame_size.y <= 0:
            return self.last_frame
        cc = self._clear_tuple(clear_main, clear_color)
        result = native.flatten_fast(
            renders, frame_size.x, frame_size.y, 1.0, 1.0, self.aa_factor, cc,
            pool_owner=id(self),
        )
        if result[0] == "tape":
            return self.execute(result[1])
        _, combo, mask_count, density = result
        width = int(round(frame_size.x))
        height = int(round(frame_size.y))
        # the pooled buffer's meta row may hold an earlier frame's clear
        # color; a frame that does not clear starts from the last frame
        combo[-1, 0:4] = cc if cc is not None else 0.0
        return self._run_mega(combo, height, width, mask_count + 1, cc is None,
                              tile_h_from_density(*density, height, width))

    def take_screenshot(self, frame=None, frame_rect=None) -> np.ndarray:
        """The frame as uint8 RGBA (renderer.py:2193). frame_rect: optional
        (x, y, w, h) crop in pixels, clamped to the frame."""
        if frame is None:
            frame = self.last_frame
        arr = frame.detach().cpu().numpy()
        if frame_rect is not None:
            x, y, w, h = (int(round(v)) for v in frame_rect)
            x = max(0, min(x, arr.shape[1]))
            y = max(0, min(y, arr.shape[0]))
            arr = arr[y : y + max(h, 0), x : x + max(w, 0)]
        return np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
