"""FigRenderer: flatten a scene on the host, rasterize it on the device
(figdraw_tpu/renderer.py, the native-walk paths: the frame executor, the
rolled executor and the megakernel), with the glyph/image atlas and its
image message bus.

The device is explicit: FigRenderer(device="cuda") raises when CUDA is
absent, and a "cpu" renderer runs the plain torch versions of the kernels.
"""

from __future__ import annotations

from typing import Hashable, Optional

import numpy as np
import torch

from . import native
from .atlas import Atlas, AtlasEntryMeta
from .colors import Color, as_color
from .executor import get_frame_executor, get_mega_executor
from .geometry import Vec2
from .plan import ExecPlan, plan_execution, tile_h_from_density
from .resources import ImageMessageBus, ImageMsgKind, default_bus
from .tape import Tape

DEFAULT_SDF_AA_FACTOR = 1.2  # figbackend.nim:34
WHITE_IMAGE_KEY = "__figdraw_white__"  # renderer.WHITE_IMAGE_KEY


class FigRenderer:
    """Renders RendersArray scenes to (H, W, 4) float32 frames on `device`.

    atlas_size, atlas_margin: the glyph/image atlas's first edge and its
    per-entry margin (it doubles on overflow). pixelate: nearest atlas
    sampling (GL_NEAREST) instead of bilinear. Glyph quads sample without
    the subpixel shift: the option comes with the text host pipeline."""

    def __init__(self, atlas_size: int = 512, atlas_margin: int = 4,
                 pixelate: bool = False, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FigRenderer(device='cuda'): CUDA is not available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.atlas = Atlas(size=atlas_size, margin=atlas_margin)
        # the white texel filled quads sample (glcontext.nim:966-973)
        self.atlas.put_image(WHITE_IMAGE_KEY, np.ones((4, 4, 4), np.float32),
                             AtlasEntryMeta(kind="generated"))
        self.pixelate = pixelate
        self.aa_factor = DEFAULT_SDF_AA_FACTOR
        self.last_frame = None  # (H, W, 4) f32 tensor of the last render
        self._atlas_device = None
        self._atlas_pack_cache = None
        self._bus = None
        self._subscription = None

    # --- the image message bus -----------------------------------------------

    def ensure_image_message_subscription(self, bus: Optional[ImageMessageBus] = None
                                          ) -> None:
        """Subscribe to `bus` (default: the process-wide bus, unless already
        subscribed to one); the subscription replays the bus's live images."""
        if bus is None:
            if self._subscription is not None:
                return
            bus = default_bus
        if self._subscription is None or self._bus is not bus:
            self._bus = bus
            self._subscription = bus.subscribe()

    def process_image_messages(self) -> None:
        """Drain the subscription and apply its puts, replaces and clears to
        the atlas, dropping stale puts (renderer.process_image_messages, the
        image half)."""
        self.ensure_image_message_subscription()
        bus = self._bus
        for msg in self._subscription.drain():
            kind = msg.kind
            if kind in (ImageMsgKind.PutImage, ImageMsgKind.ReplaceImage):
                if not bus.message_current(msg) or msg.image is None:
                    continue
                meta = AtlasEntryMeta(kind="image", image_id=msg.id)
                if msg.mipmapped:  # a mip chain always repacks
                    self.atlas.remove(msg.id)
                    self.atlas.put_image(msg.id, msg.image, meta, mipmapped=True)
                else:  # same size: in place; else repack
                    self.atlas.update_image(msg.id, msg.image)
                    self.atlas.meta[msg.id] = meta
            elif kind == ImageMsgKind.ClearImage:
                self.atlas.remove(msg.id)
            elif kind == ImageMsgKind.ClearImages:
                for i in msg.ids:
                    self.atlas.remove(i)
            elif kind == ImageMsgKind.ClearImageCache:
                self.atlas.clear()

    # --- the atlas -------------------------------------------------------------

    def put_image(self, key: Hashable, img, kind: str = "image") -> None:
        self.atlas.put_image(key, img, AtlasEntryMeta(kind=kind))

    def has_image(self, key: Hashable) -> bool:
        return key in self.atlas

    def _white_uv(self):
        """The white texel's uv center; restored first if a cache clear
        removed it (renderer._white_uv)."""
        if WHITE_IMAGE_KEY not in self.atlas.entries:
            self.atlas.put_image(WHITE_IMAGE_KEY, np.ones((4, 4, 4), np.float32),
                                 AtlasEntryMeta(kind="generated"))
        x, y, w, h = self.atlas.entries[WHITE_IMAGE_KEY]
        return (x + w / 2.0, y + h / 2.0)

    def _walk_atlas(self):
        """The atlas as the walk reads it: (packed entries, edge, white uv),
        the packing cached by entries version and edge."""
        white_uv = self._white_uv()
        key = (self.atlas.entries_version, self.atlas.size)
        if self._atlas_pack_cache is None or self._atlas_pack_cache[0] != key:
            self._atlas_pack_cache = (key, native.pack_atlas_entries(self.atlas.entries))
        return self._atlas_pack_cache[1], self.atlas.size, white_uv

    def _device_atlas(self) -> torch.Tensor:
        """The (S, S, 4) f32 atlas on the device (renderer._device_atlas):
        uploaded whole after a rebuild, a size change or when the dirty rects
        cover the atlas' area, else each dirty rect is copied into its slice.
        The copies are synchronous: the host array changes under the next
        put_image."""
        atlas = self.atlas
        dev = self._atlas_device
        if (atlas.full_dirty or dev is None
                or tuple(dev.shape) != atlas.data.shape):
            self._atlas_device = torch.from_numpy(atlas.data).to(self.device,
                                                                 copy=True)
        elif atlas.dirty and atlas.dirty_rects:
            patched = sum(w * h for (_x, _y, w, h) in atlas.dirty_rects)
            if patched * 4 >= atlas.data.size:
                self._atlas_device = torch.from_numpy(atlas.data).to(self.device,
                                                                     copy=True)
            else:
                for (x, y, w, h) in atlas.dirty_rects:
                    dev[y : y + h, x : x + w].copy_(
                        torch.from_numpy(atlas.data[y : y + h, x : x + w]))
        atlas.full_dirty = False
        atlas.dirty = False
        atlas.dirty_rects.clear()
        return self._atlas_device

    # --- frames ----------------------------------------------------------------

    def _clear_tuple(self, clear_main: bool, clear_color):
        clear_color = as_color(clear_color)
        return ((clear_color.r, clear_color.g, clear_color.b, clear_color.a)
                if clear_main else None)

    def flatten(self, renders, frame_size: Vec2, clear_main: bool = True,
                clear_color: Color = Color(1.0, 1.0, 1.0, 1.0)) -> Tape:
        """Walk the scene into a packed quad tape (host only)."""
        return native.flatten_renders_array(
            renders, frame_size.x, frame_size.y, 1.0, 1.0, self.aa_factor,
            self._clear_tuple(clear_main, clear_color),
            atlas=self._walk_atlas(), pool_owner=id(self),
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
                  n_masks: int, has_init_frame: bool, tile_h: int,
                  atlas: Optional[torch.Tensor] = None):
        """The megakernel on a mega combo; atlas: the device atlas when the
        tape holds atlas quads, else None."""
        run = get_mega_executor(height, width, n_masks, has_init_frame, tile_h)
        # a synchronous copy: the walk's combo pool reuses this host buffer
        # two flattens later
        frame = run(torch.from_numpy(combo).to(self.device, copy=True),
                    self._init_frame(has_init_frame, height, width),
                    atlas=atlas, pixelate=self.pixelate)
        self.last_frame = frame
        return frame

    def execute_plan(self, plan: ExecPlan,
                     atlas: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Upload the plan's combo and run its executor: the megakernel for
        a mega plan (with the atlas for a mega_atlas plan), else the frame
        executor (its rolled form for a rolled plan). atlas: the (S, S, 4)
        f32 atlas the plan's uv were packed against (plan.atlas_from_jax for
        a JAX plan); default this renderer's own."""
        needs_atlas = plan.mega_combo is None or plan.mega_atlas
        if atlas is None and needs_atlas:
            atlas = self._device_atlas()
        if plan.mega_combo is not None:
            return self._run_mega(plan.mega_combo, plan.height, plan.width,
                                  plan.n_masks, plan.has_init_frame, plan.tile_h,
                                  atlas=atlas if plan.mega_atlas else None)
        init = self._init_frame(plan.has_init_frame, plan.height, plan.width)
        combo = torch.from_numpy(plan.combo).to(self.device, copy=True)
        flags = dict(atlas=atlas, pixelate=self.pixelate)
        run = get_frame_executor(plan.structure, plan.height, plan.width,
                                 plan.n_masks, plan.has_init_frame, plan.tile_h,
                                 rolled=plan.rolled_items is not None)
        frame = run(combo, init, items=plan.rolled_items,
                    radii=plan.rolled_radii, **flags)
        self.last_frame = frame
        return frame

    def render_frame(self, renders, frame_size: Vec2, clear_main: bool = True,
                     clear_color: Color = Color(1.0, 1.0, 1.0, 1.0)):
        """Full frame: apply pending image messages, flatten on the host,
        rasterize on the device. Returns the (H, W, 4) f32 frame tensor
        (asynchronous on CUDA).

        The walk's fast export comes first (renderer.py:1307-1317): a
        mask-heavy scene without atlas quads, blurs or backdrops goes from
        the walk straight to the megakernel, every other scene through a
        tape and execute(), which sends a mask-heavy atlas scene to the
        megakernel too (plan.plan_execution)."""
        if frame_size.x <= 0 or frame_size.y <= 0:
            return self.last_frame
        self.process_image_messages()
        cc = self._clear_tuple(clear_main, clear_color)
        result = native.flatten_fast(
            renders, frame_size.x, frame_size.y, 1.0, 1.0, self.aa_factor, cc,
            atlas=self._walk_atlas(), pool_owner=id(self),
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
