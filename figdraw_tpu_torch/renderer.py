"""FigRenderer: flatten a scene on the host, rasterize it on the device
(figdraw_tpu/renderer.py, the native-walk frame-executor path).

The device is explicit: FigRenderer(device="cuda") raises when CUDA is
absent, and a "cpu" renderer runs the plain torch versions of the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from . import native
from .colors import Color, as_color
from .executor import get_frame_executor
from .geometry import Vec2
from .plan import ExecPlan, bucket, plan_execution
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

    def flatten(self, renders, frame_size: Vec2, clear_main: bool = True,
                clear_color: Color = Color(1.0, 1.0, 1.0, 1.0)) -> Tape:
        """Walk the scene into a packed quad tape (host only)."""
        clear_color = as_color(clear_color)
        cc = ((clear_color.r, clear_color.g, clear_color.b, clear_color.a)
              if clear_main else None)
        return native.flatten_renders_array(
            renders, frame_size.x, frame_size.y, 1.0, 1.0, self.aa_factor, cc,
            bucket=bucket, pool_owner=id(self),
        )

    def execute(self, tape: Tape) -> torch.Tensor:
        """Plan the tape on the host, then run it on the device."""
        return self.execute_plan(plan_execution(tape))

    def execute_plan(self, plan: ExecPlan) -> torch.Tensor:
        """Upload the plan's combo and run its frame executor."""
        run = get_frame_executor(plan.structure, plan.height, plan.width,
                                 plan.n_masks, plan.has_init_frame, plan.tile_h)
        # a synchronous copy: the walk's combo pool reuses this host buffer
        # two flattens later
        combo = torch.from_numpy(plan.combo).to(self.device, copy=True)
        init_frame = None
        if plan.has_init_frame:
            init_frame = self.last_frame
            if init_frame is None or tuple(init_frame.shape[:2]) != (plan.height, plan.width):
                init_frame = torch.zeros((plan.height, plan.width, 4),
                                         dtype=torch.float32, device=self.device)
        frame = run(combo, init_frame)
        self.last_frame = frame
        return frame

    def render_frame(self, renders, frame_size: Vec2, clear_main: bool = True,
                     clear_color: Color = Color(1.0, 1.0, 1.0, 1.0)):
        """Full frame: flatten on the host, rasterize on the device. Returns
        the (H, W, 4) f32 frame tensor (asynchronous on CUDA)."""
        if frame_size.x <= 0 or frame_size.y <= 0:
            return self.last_frame
        return self.execute(self.flatten(renders, frame_size, clear_main,
                                         clear_color))

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
