"""FigRenderer: flatten a scene on the host, rasterize it on the device
(figdraw_tpu/renderer.py: the frame executor, the rolled executor and the
megakernel), with the glyph/image atlas and its image message bus, and
device-resident scenes: snapshot_scene parks a flattened scene on the
device, render_view and render_views draw it under a camera and per-root
affines, update_scene patches edited roots in place (scene.py holds their
state and host half).

A RendersArray goes through the native walk (native/flatten.cpp); a
Renders tree or a RenderFragments goes through the Python walk
(render.render_root on a tape.TapeBackend) and the planner packs its tape.
Both walks apply the global UI scale (basics.fig_ui_scale) and the
renderer's pixel scale, and render_frame scales the frame size by the UI
scale, as the JAX renderer does.

Text nodes typeset on the host (text/layout.py); their glyphs are
rasterized into the atlas on a cold miss (text/glyphs.py): by the Python
walk as it meets them, and for a RendersArray by _ensure_packed_glyphs
before the native walk, which then finds every glyph's atlas entry and
raster offset by key.

The frame loop's other entry points: render_frame_async (the walk on
the caller's thread, upload and executor on one worker thread, at most two
frames in flight), render_batch (groups of frames of one pass structure
uploaded as one stack and run into one preallocated output),
render_frame_with_overlays (external frames composited between layers);
and the image surface (update_image, remove_image, contains_image,
rebuild_image_atlas, atlas_usage, publish_atlas_usage).

The device is explicit: FigRenderer(device="cuda") raises when CUDA is
absent, and a "cpu" renderer runs the plain torch versions of the kernels.
No path retries a failed kernel or build another way: the error reaches
the caller.
"""

from __future__ import annotations

import collections
import concurrent.futures
import os
import threading
from dataclasses import dataclass
from typing import Hashable, Optional

import numpy as np
import torch

from . import native
from .atlas import Atlas, AtlasEntryMeta
from .basics import fig_ui_scale, scaled
from .colors import Color, as_color
from .config import (
    batch_chunk, runtime_text_lcd_filtering_requested,
    runtime_text_subpixel_glyph_variants_requested,
    runtime_text_subpixel_positioning_requested,
)
from .executor import BatchStack, get_frame_executor, get_mega_executor, run_batch
from .geometry import Vec2
from .nodesarray import RendersArray
from .render import render_root
from .ops.rows import damage_spans, transform_rows
from .plan import ExecPlan, plan_execution, plan_rolled, tile_h_from_density
from .resources import ImageMessageBus, ImageMsgKind, default_bus
from .scene import (
    DeviceScene, anim_table, damage_rects, patch_device_scene, patch_staging,
    patchable_spans, plan_kind,
)
from .tape import Tape, TapeBackend

DEFAULT_SDF_AA_FACTOR = 1.2  # figbackend.nim:34
WHITE_IMAGE_KEY = "__figdraw_white__"  # renderer.WHITE_IMAGE_KEY
ASYNC_IN_FLIGHT = 2  # render_frame_async's cap: the walk pool's two buffers
STAGING_SLOTS = 3  # pinned upload slots of the async pipeline


@dataclass
class AtlasUsage:
    """Atlas occupancy snapshot (renderer.AtlasUsage, figbackend.nim:72-89)."""

    snapshot_id: int = 0
    generation: int = 0
    rebuild_count: int = 0
    atlas_size: int = 0
    atlas_area: int = 0
    used_area: int = 0
    packed_area: int = 0
    entry_count: int = 0
    image_count: int = 0
    glyph_count: int = 0
    generated_count: int = 0
    unknown_count: int = 0

    @property
    def used_ratio(self) -> float:
        return self.used_area / self.atlas_area if self.atlas_area > 0 else 0.0

    @property
    def packed_ratio(self) -> float:
        return self.packed_area / self.atlas_area if self.atlas_area > 0 else 0.0


_atlas_usage_lock = threading.Lock()
_last_atlas_usage = AtlasUsage()
_next_snapshot_id = 0


def atlas_usage_snapshot() -> AtlasUsage:
    """The last published snapshot, readable from any thread
    (renderer.atlas_usage_snapshot, figbackend.nim:347-353)."""
    with _atlas_usage_lock:
        return _last_atlas_usage


def blend_overlay(frame: torch.Tensor, overlay: torch.Tensor) -> torch.Tensor:
    """Source-over of an external straight-alpha (H, W, 4) layer onto a
    frame (renderer._blend_overlay, the GL blend state of glcontext.nim).
    Elementwise, in plain torch: the JAX package computes it outside any
    Pallas kernel, as one XLA op."""
    a = overlay[..., 3:4]
    rgb = overlay[..., :3] * a + frame[..., :3] * (1.0 - a)
    al = overlay[..., 3] + frame[..., 3] * (1.0 - overlay[..., 3])
    return torch.cat([rgb, al[..., None]], dim=-1)


class _Staging:
    """The async pipeline's upload slots: STAGING_SLOTS pinned host buffers,
    each with the CUDA event recorded after the copy that last read it. A
    slot is written only once its event has completed, so a non_blocking
    copy never reads a buffer the host is rewriting; the walk's pooled
    buffer itself is free as soon as its bytes are in a slot. On the CPU a
    slot is a plain copy."""

    def __init__(self, device: torch.device):
        self.device = device
        self.slots = [[None, None] for _ in range(STAGING_SLOTS)]
        self.turn = 0

    def upload(self, arr: np.ndarray) -> torch.Tensor:
        if self.device.type != "cuda":
            return torch.from_numpy(arr).clone()
        slot = self.slots[self.turn]
        self.turn = (self.turn + 1) % len(self.slots)
        buf, event = slot
        if event is not None:
            event.synchronize()
        if buf is None or buf.numel() < arr.nbytes:
            buf = slot[0] = torch.empty(arr.nbytes, dtype=torch.uint8,
                                        pin_memory=True)
        host = buf[: arr.nbytes]
        host.copy_(torch.from_numpy(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)))
        dev = host.to(self.device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return dev.view(torch.float32).view(arr.shape)


class FigRenderer:
    """Renders scenes (a RendersArray, a Renders tree or a RenderFragments)
    to (H, W, 4) float32 frames on `device`.

    atlas_size, atlas_margin: the glyph/image atlas's first edge and its
    per-entry margin (it doubles on overflow). pixelate: nearest atlas
    sampling (GL_NEAREST) instead of bilinear. pixel_scale: device pixels
    per UI unit after the UI scale (a HiDPI frame); the walks draw the
    scene that much larger, and the caller sizes the frame.

    The text switches (renderer.FigRenderer's, defaults from config's
    FIGDRAW_TEXT_* environment): text_lcd_filtering rasterizes glyphs
    through the 5-tap LCD filter; text_subpixel_positioning snaps glyph
    quads to whole pixels and carries the fraction as a subpixel shift the
    kernels' atlas sample applies; with text_subpixel_glyph_variants too,
    the fraction picks one of 10 pre-shifted rasters instead."""

    def __init__(self, atlas_size: int = 512, atlas_margin: int = 4,
                 pixelate: bool = False, pixel_scale: float = 1.0,
                 device="cuda"):
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
        self.pixel_scale = float(pixel_scale)
        self.aa_factor = DEFAULT_SDF_AA_FACTOR
        self.text_lcd_filtering = runtime_text_lcd_filtering_requested()
        self.text_subpixel_positioning = runtime_text_subpixel_positioning_requested()
        self.text_subpixel_glyph_variants = (
            runtime_text_subpixel_glyph_variants_requested())
        # glyph key -> raster offset (x, y) of the glyphs in the atlas
        self._glyph_offsets: dict = {}
        self._glyph_pack_cache = None
        # id(glyph block) -> (block, stamp): see _ensure_packed_glyphs
        self._ensured_glyph_blocks: dict = {}
        self._image_owners: dict = {}
        self._font_owners: dict = {}
        self.last_frame = None  # (H, W, 4) f32 tensor of the last render
        self._atlas_device = None
        # the device atlas was handed to work that has not run yet (an async
        # job, a batch group): the next patch goes into a copy
        self._atlas_shared = False
        self._atlas_stamp = 0  # bumped each time the device atlas changes
        self.atlas_upload_bytes = 0  # bytes of the last device-atlas upload
        self._atlas_pack_cache = None
        self._bus = None
        self._subscription = None
        self._render_thread_id: Optional[int] = None
        # render_frame_async: one worker thread for upload and executor, and
        # a release future per frame in flight (at most ASYNC_IN_FLIGHT)
        self._pipe = None
        self._async_released = collections.deque()
        self._staging = _Staging(self.device)

    def _assert_render_thread(self) -> None:
        """The render path has one owner thread (renderer._assert_render_thread,
        the runtime form of the reference's thread-effect tags,
        shared.nim:22-35); other threads publish images through the message
        bus. FIGDRAW_NO_THREAD_GUARD=1 turns the check off."""
        if os.environ.get("FIGDRAW_NO_THREAD_GUARD") == "1":
            return
        tid = threading.get_ident()
        if self._render_thread_id is None:
            self._render_thread_id = tid
        elif self._render_thread_id != tid:
            raise RuntimeError(
                "FigRenderer render path used from two threads; publish "
                "resources through the image message bus instead "
                "(figdraw_tpu_torch.resources), or set FIGDRAW_NO_THREAD_GUARD=1")

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
        """Drain the subscription and apply its messages to the atlas
        (renderer.process_image_messages): image puts and replaces (stale
        ones dropped), glyph puts (a key already held is kept), clears of an
        image, a list, the cache, a font's or a typeface's glyphs, and the
        retain / release of ImageRef and FontRef owners, whose final release
        evicts the image or the font's glyphs."""
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
            elif kind == ImageMsgKind.PutGlyph:
                if msg.image is None or msg.id in self.atlas:
                    continue
                self.atlas.put_image(msg.id, msg.image, AtlasEntryMeta(
                    kind="glyph", font_id=msg.font_id, typeface_id=msg.typeface_id))
            elif kind == ImageMsgKind.ClearImage:
                self.atlas.remove(msg.id)
            elif kind == ImageMsgKind.ClearImages:
                for i in msg.ids:
                    self.atlas.remove(i)
            elif kind == ImageMsgKind.ClearImageCache:
                self.atlas.clear()
            elif kind == ImageMsgKind.ClearFontGlyphs:
                self._clear_glyphs(lambda m: m.font_id == msg.font_id)
            elif kind == ImageMsgKind.ClearTypefaceGlyphs:
                self._clear_glyphs(lambda m: m.typeface_id == msg.typeface_id)
            elif kind == ImageMsgKind.RetainImage:
                self._image_owners.setdefault(msg.id, set()).add(msg.owner_token)
            elif kind == ImageMsgKind.ReleaseImage:
                self._release(self._image_owners, msg.id, msg.owner_token)
                if msg.final_release:
                    self.atlas.remove(msg.id)
            elif kind == ImageMsgKind.RetainFont:
                self._font_owners.setdefault(msg.font_id, set()).add(msg.owner_token)
            elif kind == ImageMsgKind.ReleaseFont:
                self._release(self._font_owners, msg.font_id, msg.owner_token)
                if msg.final_release:
                    self._clear_glyphs(lambda m: m.font_id == msg.font_id)

    @staticmethod
    def _release(owners: dict, key, token) -> None:
        held = owners.get(key)
        if held is not None:
            held.discard(token)
            if not held:
                owners.pop(key, None)

    def _clear_glyphs(self, pred) -> None:
        keys = [k for k, m in self.atlas.meta.items()
                if m.kind == "glyph" and pred(m)]
        for k in keys:
            self.atlas.remove(k)

    # --- the atlas -------------------------------------------------------------

    def put_image(self, key: Hashable, img, kind: str = "image") -> None:
        self.atlas.put_image(key, img, AtlasEntryMeta(kind=kind))

    def update_image(self, key: Hashable, img) -> None:
        """Replace an image's pixels in place when its size is unchanged
        (the device atlas then takes a dirty-rect copy), else repack it."""
        self.atlas.update_image(key, img)

    def remove_image(self, key: Hashable) -> None:
        self.atlas.remove(key)

    def contains_image(self, key: Hashable) -> bool:
        return key in self.atlas

    def rebuild_image_atlas(self, minimum_size: int = 0) -> None:
        """Reset the atlas (grown to at least minimum_size), then replay the
        bus's live images into it (figbackend.nim:202-207); the device atlas
        is uploaded whole at the next frame."""
        self.atlas.reset(minimum_size)
        self._glyph_offsets.clear()
        if self._bus is not None and self._subscription is not None:
            self._bus.replay_to(self._subscription)
            self.process_image_messages()

    def atlas_usage(self) -> AtlasUsage:
        """The atlas' occupancy now (renderer.atlas_usage)."""
        atlas = self.atlas
        usage = AtlasUsage(
            generation=atlas.generation, rebuild_count=atlas.rebuild_count,
            atlas_size=atlas.size, atlas_area=atlas.size * atlas.size,
            used_area=atlas.used_area(),
            packed_area=max(atlas.packed_area(), atlas.used_area()),
            entry_count=len(atlas.entries),
        )
        for key in atlas.entries:
            meta = atlas.meta.get(key)
            if meta is None:
                usage.unknown_count += 1
            elif meta.kind == "image":
                usage.image_count += 1
            elif meta.kind == "glyph":
                usage.glyph_count += 1
            else:
                usage.generated_count += 1
        if usage.atlas_area > 0:
            usage.used_area = min(usage.used_area, usage.atlas_area)
            usage.packed_area = min(usage.packed_area, usage.atlas_area)
        return usage

    def publish_atlas_usage(self) -> None:
        """Publish atlas_usage() for atlas_usage_snapshot()."""
        global _last_atlas_usage, _next_snapshot_id
        usage = self.atlas_usage()
        with _atlas_usage_lock:
            _next_snapshot_id += 1
            usage.snapshot_id = _next_snapshot_id
            _last_atlas_usage = usage

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

    # --- glyphs -----------------------------------------------------------------

    def _text_config(self):
        """(lcd filtering, subpixel positioning, subpixel glyph variants) as
        the walks read them: variants only under subpixel positioning."""
        return (self.text_lcd_filtering, self.text_subpixel_positioning,
                self.text_subpixel_positioning and self.text_subpixel_glyph_variants)

    def _walk_text(self):
        """The walk's text argument (native._set_walk_config): the text
        config and the sorted glyph offsets."""
        return self._text_config(), self._glyph_offsets_pack()

    def _load_glyph(self, key, glyph, lcd: bool, variant: int) -> bool:
        """Cold-miss glyph generation straight into the atlas
        (renderer._load_glyph, figrender.nim:477-491): False for a glyph
        with no outline."""
        from .text.glyphs import generate_glyph
        from .text.typefaces import get_fig_font

        result = generate_glyph(glyph.font_id, glyph.glyph_id, lcd, variant)
        if result is None:
            return False
        img, offset = result
        self.atlas.put_image(key, img, AtlasEntryMeta(
            kind="glyph", font_id=glyph.font_id,
            typeface_id=get_fig_font(glyph.font_id).typeface_id))
        self._glyph_offsets[key] = offset
        return True

    def _ensure_packed_glyphs(self, renders) -> None:
        """Rasterize the glyphs a RendersArray's text rows reference that
        are not in the atlas yet (renderer._ensure_packed_glyphs), so the
        native walk only meets warm keys. Keys are computed over the
        GLYPH_DTYPE rows at once (text/glyphs.py glyph_hash) and loaded in
        sorted key order, the JAX package's order, so both atlases pack the
        same glyphs in the same places. Each glyph block (cached per
        arrangement by nodesarray.pack_text) is scanned once per text
        config, UI scale and atlas entries version."""
        from types import SimpleNamespace

        lcd, _subpixel, variants_on = self._text_config()
        ui = fig_ui_scale()
        config_key = (lcd, variants_on, ui, self.atlas.entries_version,
                      self.atlas.size)
        cache = self._ensured_glyph_blocks
        pending = []
        for _lvl, lst in renders.sorted_pairs():
            for block in lst.glyph_rows:
                if block.ndim == 0 or block.shape[0] == 0:
                    continue
                marker = cache.get(id(block))
                if (marker is not None and marker[0] is block
                        and marker[1] == config_key):
                    continue
                pending.append(block)
        if not pending:
            return
        glyphs = np.concatenate([np.atleast_1d(b) for b in pending])
        n = glyphs.shape[0]
        if variants_on:
            gx = glyphs["x"] * ui + glyphs["img_ox"]
            frac = np.clip(gx - np.floor(gx), 0.0, 0.999)
            variant = np.minimum((frac * 10.0).astype(np.int64), 9)
        else:
            variant = np.zeros(n, np.int64)
        h = np.full(n, 0xCBF29CE484222325, np.uint64)
        prime = np.uint64(0x100000001B3)
        for v in (np.full(n, 2344, np.uint64), glyphs["font_id"].astype(np.uint64),
                  glyphs["glyph_id"].astype(np.uint64),
                  np.full(n, int(lcd), np.uint64), variant.astype(np.uint64)):
            h = (h ^ v) * prime
        keys = (h & np.uint64(0x7FFFFFFFFFFFFFFF)).astype(np.int64)
        uniq, first = np.unique(keys, return_index=True)
        entries = self.atlas.entries
        for k, i in zip(uniq.tolist(), first.tolist()):
            if k in entries:
                continue
            g = glyphs[i]
            self._load_glyph(k, SimpleNamespace(font_id=int(g["font_id"]),
                                                glyph_id=int(g["glyph_id"])),
                             lcd, int(variant[i]))
        # stamped after the loads, so the loads themselves do not
        # invalidate the markers; the table is bounded for frame loops that
        # typeset afresh every frame
        if len(cache) > 4096:
            cache.clear()
        stamp = (lcd, variants_on, ui, self.atlas.entries_version, self.atlas.size)
        for block in pending:
            cache[id(block)] = (block, stamp)

    def _glyph_offsets_pack(self):
        """Sorted (keys (n,) i64, offsets (n, 2) f32) arrays for
        fd_set_glyph_offsets, cached by the offsets table's size (entries
        are only added), or None while it is empty."""
        n = len(self._glyph_offsets)
        cached = self._glyph_pack_cache
        if cached is None or cached[0] != n:
            packed = None
            if n:
                keys = np.fromiter(self._glyph_offsets.keys(), dtype=np.int64, count=n)
                order = np.argsort(keys)
                offs = np.asarray(list(self._glyph_offsets.values()), dtype=np.float32)
                packed = (np.ascontiguousarray(keys[order]),
                          np.ascontiguousarray(offs[order]))
            cached = self._glyph_pack_cache = (n, packed)
        return cached[1]

    def _device_atlas(self) -> torch.Tensor:
        """The (S, S, 4) f32 atlas on the device (renderer._device_atlas):
        uploaded whole after a rebuild, a size change or when the dirty rects
        cover a quarter of the atlas' area, else each dirty rect is copied
        into its slice (atlas_upload_bytes: the bytes of the last upload).
        The copies are synchronous: the host array changes under the next
        put_image. While work that has not run yet holds the device atlas
        (_atlas_shared), the rects go into a copy of it, so that work
        samples the atlas as of its own walk."""
        atlas = self.atlas
        dev = self._atlas_device
        if (atlas.full_dirty or dev is None
                or tuple(dev.shape) != atlas.data.shape):
            dev = None
        elif atlas.dirty and atlas.dirty_rects:
            patched = sum(w * h for (_x, _y, w, h) in atlas.dirty_rects)
            if patched * 4 >= atlas.data.size:
                dev = None
            else:
                if self._atlas_shared:
                    dev = dev.clone()
                total = 0
                for (x, y, w, h) in atlas.dirty_rects:
                    patch = torch.from_numpy(atlas.data[y : y + h, x : x + w])
                    dev[y : y + h, x : x + w].copy_(patch)
                    total += w * h * 16
                self._atlas_device = dev
                self._atlas_shared = False
                self._atlas_stamp += 1
                self.atlas_upload_bytes = total
        else:
            dev = self._atlas_device
        if dev is None:
            self._atlas_device = torch.from_numpy(atlas.data).to(self.device,
                                                                 copy=True)
            self._atlas_shared = False
            self._atlas_stamp += 1
            self.atlas_upload_bytes = atlas.data.nbytes
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
                clear_color: Color = Color(1.0, 1.0, 1.0, 1.0),
                cull: bool = True, record_spans: bool = False,
                reserve=None) -> Tape:
        """Walk the scene into a quad tape (host only), at the UI scale and
        the pixel scale; frame_size is the frame's own (already scaled).

        A RendersArray takes the native walk, whose tape arrives packed;
        cull, record_spans and reserve are native.flatten_renders_array's.
        A Renders or a RenderFragments takes the Python walk (renderer.flatten
        of the JAX package), which has no saturation cull, root spans or
        reserves, so those three are ignored there; its tape holds logical
        rows, which plan.plan_execution packs."""
        if isinstance(renders, RendersArray):
            self._ensure_packed_glyphs(renders)
            return native.flatten_renders_array(
                renders, frame_size.x, frame_size.y, fig_ui_scale(),
                self.pixel_scale, self.aa_factor,
                self._clear_tuple(clear_main, clear_color),
                atlas=self._walk_atlas(), pool_owner=id(self), cull=cull,
                record_spans=record_spans, reserve=reserve,
                text=self._walk_text(),
            )
        backend = TapeBackend(white_uv=self._white_uv())
        backend.entries = self.atlas.entries
        backend.atlas_size = self.atlas.size
        backend.glyph_offsets = self._glyph_offsets
        backend.glyph_loader = self._load_glyph
        backend.aa_factor = self.aa_factor
        backend.set_text_lcd_filtering_enabled(self.text_lcd_filtering)
        backend.set_text_subpixel_positioning_enabled(self.text_subpixel_positioning)
        backend.set_text_subpixel_glyph_variants_enabled(
            self.text_subpixel_glyph_variants)
        backend.begin_frame(frame_size, clear_main, as_color(clear_color))
        backend.save_transform()
        backend.scale(self.pixel_scale)
        render_root(backend, renders)
        backend.restore_transform()
        backend.end_frame()
        return backend.finish()

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

    def _upload(self, combo: np.ndarray) -> torch.Tensor:
        """A synchronous copy: the walk's combo pool reuses the host buffer
        two flattens later (native._pooled_combo). The async pipeline
        uploads through its pinned slots instead (_Staging)."""
        return torch.from_numpy(combo).to(self.device, copy=True)

    def execute_plan(self, plan: ExecPlan,
                     atlas: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Upload the plan's combo and run its executor: the megakernel for
        a mega plan (with the atlas for a mega_atlas plan), else the frame
        executor (its rolled form for a rolled plan). atlas: the (S, S, 4)
        f32 atlas the plan's uv were packed against (plan.atlas_from_jax for
        a JAX plan); default this renderer's own."""
        combo = plan.mega_combo if plan.mega_combo is not None else plan.combo
        return self._run_plan(plan, self._upload(combo), atlas)

    def _run_plan(self, plan: ExecPlan, combo: torch.Tensor,
                  atlas: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run the plan's executor on `combo`, the plan's upload (or a
        transformed copy of it) on the device; atlas as execute_plan's."""
        if atlas is None and _needs_atlas(plan):
            atlas = self._device_atlas()
        init = self._init_frame(plan.has_init_frame, plan.height, plan.width)
        if plan.mega_combo is not None:
            run = get_mega_executor(plan.height, plan.width, plan.n_masks,
                                    plan.has_init_frame, plan.tile_h)
            frame = run(combo, init, atlas=atlas if plan.mega_atlas else None,
                        pixelate=self.pixelate,
                        subpixel_positioning=self.text_subpixel_positioning)
        else:
            run = get_frame_executor(plan.structure, plan.height, plan.width,
                                     plan.n_masks, plan.has_init_frame,
                                     plan.tile_h,
                                     rolled=plan.rolled_items is not None)
            frame = run(combo, init, atlas=atlas, pixelate=self.pixelate,
                        subpixel_positioning=self.text_subpixel_positioning,
                        items=plan.rolled_items, radii=plan.rolled_radii)
        self.last_frame = frame
        return frame

    def _walk_plan(self, renders, fs: Vec2, clear_main: bool,
                   clear_color) -> ExecPlan:
        """The host half of a frame at the scaled frame size fs: the walk and
        the plan. A RendersArray takes the walk's fast export first
        (renderer.py:1307-1317): a mask-heavy scene without atlas quads,
        blurs or backdrops goes from the walk straight to a megakernel plan
        whose combo is the walk's pooled export; every other scene gets a
        tape, which plan.plan_execution plans (and sends to the megakernel
        too when it is mask-heavy, atlas runs included). A tree takes the
        Python walk."""
        if not isinstance(renders, RendersArray):
            return plan_execution(self.flatten(renders, fs, clear_main, clear_color))
        cc = self._clear_tuple(clear_main, clear_color)
        self._ensure_packed_glyphs(renders)
        result = native.flatten_fast(
            renders, fs.x, fs.y, fig_ui_scale(), self.pixel_scale,
            self.aa_factor, cc, atlas=self._walk_atlas(), pool_owner=id(self),
            text=self._walk_text(),
        )
        if result[0] == "tape":
            return plan_execution(result[1])
        _, combo, mask_count, density = result
        width = int(round(fs.x))
        height = int(round(fs.y))
        # the pooled buffer's meta row may hold an earlier frame's clear
        # color; a frame that does not clear starts from the last frame
        combo[-1, 0:4] = cc if cc is not None else 0.0
        return ExecPlan(
            combo=combo, structure=(), bounds=[], radii=[], height=height,
            width=width, n_masks=mask_count + 1,
            tile_h=tile_h_from_density(*density, height, width),
            has_init_frame=cc is None, mega_combo=combo)

    def render_frame(self, renders, frame_size: Vec2, clear_main: bool = True,
                     clear_color: Color = Color(1.0, 1.0, 1.0, 1.0)):
        """Full frame: apply pending image messages, flatten on the host,
        rasterize on the device. renders: a RendersArray, a Renders tree or
        a RenderFragments; frame_size in UI units (the frame is frame_size
        times the UI scale). Returns the (H, W, 4) f32 frame tensor
        (asynchronous on CUDA). Frames of render_frame_async still in
        flight are drained first. The route is _walk_plan's."""
        fs = scaled(frame_size)
        if fs.x <= 0 or fs.y <= 0:
            return self.last_frame
        self._assert_render_thread()
        self.drain_async()
        self.process_image_messages()
        frame = self.execute_plan(self._walk_plan(renders, fs, clear_main, clear_color))
        self.publish_atlas_usage()
        return frame

    # --- the async pipeline ----------------------------------------------------

    def render_frame_async(self, renders, frame_size: Vec2, clear_main: bool = True,
                           clear_color: Color = Color(1.0, 1.0, 1.0, 1.0)
                           ) -> concurrent.futures.Future:
        """A pipelined frame (renderer.render_frame_async): the image
        messages, the walk, the plan and the device atlas' update run now,
        on the calling thread; the upload and the executor run on the
        renderer's one worker thread, so the next frame's walk overlaps this
        frame's device work. Returns a Future of the (H, W, 4) f32 frame
        tensor; on CUDA the frame is enqueued on the caller's stream, which
        orders it for any later use there.

        At most ASYNC_IN_FLIGHT frames are in flight: the walk's combo pool
        alternates two buffers, so the walk of frame N+2 waits until frame
        N's job has copied its buffer out. The job copies it into a pinned
        staging slot and uploads that with a non_blocking copy; a slot is
        rewritten only after the event of its last copy has completed. The
        frame samples the atlas as of its own walk: the device atlas is
        resolved here, before the job is queued, and a later patch goes into
        a copy of it. An exception in the job reaches the Future's result()
        and frees the frame's slot; the pipeline stays usable."""
        fs = scaled(frame_size)
        done = concurrent.futures.Future()
        if fs.x <= 0 or fs.y <= 0:
            done.set_result(self.last_frame)
            return done
        self._assert_render_thread()
        if self._pipe is None:
            self._pipe = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="figdraw-pipe")
        while len(self._async_released) >= ASYNC_IN_FLIGHT:
            self._async_released.popleft().result()
        self.process_image_messages()
        plan = self._walk_plan(renders, fs, clear_main, clear_color)
        atlas = self._device_atlas() if _needs_atlas(plan) else None
        self._atlas_shared |= atlas is not None
        self.publish_atlas_usage()
        stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        released = concurrent.futures.Future()

        def job():
            try:
                combo = plan.mega_combo if plan.mega_combo is not None else plan.combo
                if stream is None:
                    return self._run_plan(plan, self._staging.upload(combo), atlas)
                with torch.cuda.stream(stream):
                    return self._run_plan(plan, self._staging.upload(combo), atlas)
            finally:
                released.set_result(None)

        fut = self._pipe.submit(job)
        self._async_released.append(released)
        return fut

    def drain_async(self) -> None:
        """Wait until no frame of render_frame_async is in flight; every
        synchronous entry point calls it first."""
        while self._async_released:
            self._async_released.popleft().result()
        # every job has enqueued its work: a later patch of the device atlas
        # is ordered after it on the stream
        self._atlas_shared = False

    # --- batched offline rendering ---------------------------------------------

    def render_batch(self, scenes, frame_size: Vec2,
                     clear_color: Color = Color(1.0, 1.0, 1.0, 1.0),
                     chunk: int = 0, as_uint8: bool = False, mesh=None
                     ) -> torch.Tensor:
        """A sequence of scenes as an (F, H, W, 4) f32 tensor in scene order
        (or, as_uint8, take_screenshot's RGBA u8), the offline animation
        path (renderer.render_batch). Consecutive frames of one group key
        (_batch_signature: the executor, the pass structure, the sizes and
        the atlas they sample) form a group of at most `chunk` frames
        (default FIGDRAW_BATCH_CHUNK, 8): the group's varying buffers go to
        the device as one stack in one copy, and the group's single-frame
        executor runs on each frame's slice of it into one preallocated
        output (executor.run_batch). Each frame equals render_frame's bit for
        bit. A frame that does not clear (none here: every frame clears)
        takes the single-frame path in order. An image update between frames
        changes the device atlas and so starts a new group. The frame axis is
        not padded to a power of two: that padding bounds XLA's jit
        signatures, which the port does not have. mesh (frame-parallel
        rendering over several devices) raises NotImplementedError."""
        if mesh is not None:
            raise NotImplementedError(
                "render_batch(mesh=...): rendering across several devices is "
                "not ported yet (ROADMAP.md, module item 10)")
        if chunk <= 0:
            chunk = batch_chunk()
        fs = scaled(frame_size)
        self._assert_render_thread()
        self.drain_async()
        height, width = int(round(fs.y)), int(round(fs.x))
        parts = []
        group = None  # [key, first plan, BatchStack, atlas]

        def flush():
            nonlocal group
            if group is None:
                return
            key, plan, batch, atlas = group
            group = None
            parts.append(self._dispatch_batch(key, plan, batch, atlas))

        for renders in scenes:
            self.process_image_messages()
            plan = self._walk_plan(renders, fs, True, clear_color)
            # resolved before the key: a change since the group's frames
            # goes into a copy of the atlas they hold and restamps it
            atlas = self._device_atlas() if _needs_atlas(plan) else None
            key, vary = self._batch_signature(plan)
            if key is None:
                flush()
                parts.append(self.execute_plan(plan)[None])
                continue
            if group is not None and (group[0] != key or group[2].count >= chunk):
                flush()
            if group is None:
                self._atlas_shared |= atlas is not None
                group = [key, plan, BatchStack(vary, chunk), atlas]
            else:
                group[2].add(vary)
        flush()
        self._atlas_shared = False
        self.publish_atlas_usage()
        if not parts:
            out = torch.zeros((0, height, width, 4), dtype=torch.float32,
                              device=self.device)
        else:
            out = parts[0] if len(parts) == 1 else torch.cat(parts)
            self.last_frame = out[-1]
        return frames_to_u8(out) if as_uint8 else out

    def _batch_signature(self, plan: ExecPlan):
        """(group key, the frame's varying buffers by name) for a plan, or
        (None, None) for a frame that cannot batch (it composites onto the
        previous frame). The key names the executor and everything its
        single-frame form is built for: the megakernel's sizes, planes, tile
        height, atlas form and combo shape; a rolled or unrolled plan's pass
        structure (which fixes the item table's rows and atlas runs), sizes
        and combo shape. A plan that samples the atlas adds the atlas
        generation and the device atlas' stamp, so frames that sample
        different atlas contents never share a group. Blur radii are not in
        the key: they ride in the combo's meta or the rolled radii, a device
        value a frame. The buffers are copied into the group's stack as the
        frame joins it."""
        if plan.has_init_frame:
            return None, None
        atlas_key = ((self.atlas.generation, self._atlas_stamp)
                     if _needs_atlas(plan) else None)
        sizes = (plan.height, plan.width, plan.n_masks, plan.tile_h)
        if plan.mega_combo is not None:
            return (("mega", sizes, plan.mega_atlas, plan.mega_combo.shape, atlas_key),
                    {"combo": plan.mega_combo})
        if plan.rolled_items is not None:
            return (("rolled", plan.structure, sizes, plan.combo.shape, atlas_key),
                    {"combo": plan.combo, "items": plan.rolled_items,
                     "radii": plan.rolled_radii})
        return (("unrolled", plan.structure, sizes, plan.combo.shape, atlas_key),
                {"combo": plan.combo})

    def _dispatch_batch(self, key, plan: ExecPlan, batch: BatchStack,
                        atlas: Optional[torch.Tensor]) -> torch.Tensor:
        """Run one group: its executor (from its first plan) over the
        stacked frames into a preallocated (F, H, W, 4) output. A failure
        raises: there is no per-frame retry."""
        if key[0] == "mega":
            run = get_mega_executor(plan.height, plan.width, plan.n_masks, False,
                                    plan.tile_h)
            atlas = atlas if plan.mega_atlas else None
        else:
            run = get_frame_executor(plan.structure, plan.height, plan.width,
                                     plan.n_masks, False, plan.tile_h,
                                     rolled=key[0] == "rolled")
        out = torch.empty((batch.count, plan.height, plan.width, 4),
                          dtype=torch.float32, device=self.device)
        return run_batch(run, batch, out, init_frame=None, atlas=atlas,
                         pixelate=self.pixelate,
                         subpixel_positioning=self.text_subpixel_positioning)

    # --- overlays ----------------------------------------------------------------

    def render_frame_with_overlays(self, renders, frame_size: Vec2, overlays,
                                   clear_main: bool = True,
                                   clear_color: Color = Color(1.0, 1.0, 1.0, 1.0)
                                   ) -> torch.Tensor:
        """Composite external full-frame images between the scene's layers
        (renderer.render_frame_with_overlays, the reference's 3D-overlay
        sandwich). overlays: {zlevel: (H, W, 4) straight-alpha image, a
        tensor or an array}; each composites source-over (blend_overlay)
        after every layer whose zlevel is below its key and before the
        layers at or above it. The layers between two boundaries render as
        one frame onto the last (render_frame with clear_main=False after
        the first group); when nothing lies below the first boundary, the
        frame starts from the clear color. An overlay whose shape is not the
        frame's raises ValueError."""
        if not overlays:
            return self.render_frame(renders, frame_size, clear_main, clear_color)
        clear_color = as_color(clear_color)
        boundaries = sorted(overlays)
        groups = [[] for _ in range(len(boundaries) + 1)]
        for lvl, lst in renders.sorted_pairs():
            gi = 0
            while gi < len(boundaries) and lvl >= boundaries[gi]:
                gi += 1
            groups[gi].append((lvl, lst))
        frame = None
        for gi, group in enumerate(groups):
            if group:
                sub = type(renders)()
                for lvl, lst in group:
                    sub.set_layer(lvl, lst)
                frame = self.render_frame(sub, frame_size,
                                          clear_main=clear_main if frame is None else False,
                                          clear_color=clear_color)
            elif frame is None:
                fs = scaled(frame_size)
                color = torch.tensor([clear_color.r, clear_color.g, clear_color.b,
                                      clear_color.a], dtype=torch.float32)
                frame = color.to(self.device).expand(
                    int(round(fs.y)), int(round(fs.x)), 4).contiguous()
                self.last_frame = frame
            if gi < len(boundaries):
                overlay = torch.as_tensor(overlays[boundaries[gi]],
                                          dtype=torch.float32).to(self.device)
                if tuple(overlay.shape) != tuple(frame.shape):
                    raise ValueError(f"overlay {tuple(overlay.shape)} must match "
                                     f"the frame {tuple(frame.shape)}")
                frame = self.last_frame = blend_overlay(frame, overlay)
        return frame

    # --- device-resident scenes -----------------------------------------------

    def snapshot_scene(self, renders, frame_size: Vec2, clear_main: bool = True,
                       clear_color: Color = Color(1.0, 1.0, 1.0, 1.0),
                       reserve=None, animate: bool = False) -> DeviceScene:
        """Flatten once and park the tape on the device; render_view then
        draws it under any camera for a camera upload, a row transform and
        the executor (renderer.snapshot_scene). renders and frame_size as
        render_frame's. A tree takes the Python walk, which records no
        per-root spans: its snapshot is drawn under a camera, and
        update_scene takes a new snapshot of it; root_transforms and patches
        in place need a RendersArray, as in the JAX package.

        The snapshot flattens without the saturation cull, which is clamped
        to the viewport: panning could reveal what it dropped. Later edits
        of `renders` are not seen; update_scene patches them in, or take a
        new snapshot. reserve: (lvl, root_idx) -> n pads those roots' spans
        with n inert rows, so an edit that changes their quad count can
        still patch in place up to the reserve. animate=True guarantees
        render_view's root_transforms: a scene with clip masks that would
        take the megakernel's layout, whose clear sentinel rows break the
        mapping of tape rows onto the resident rows, takes the rolled
        executor instead."""
        self._assert_render_thread()
        self.drain_async()
        self.process_image_messages()
        clear_color = as_color(clear_color)
        tape = self.flatten(renders, scaled(frame_size), clear_main, clear_color,
                            cull=False, record_spans=True, reserve=reserve)
        plan = plan_execution(tape)
        if animate and tape.mask_count and plan.mega_combo is not None:
            plan = plan_rolled(tape)
        # own the rows: the tape's combo is a view of the walk's pooled
        # buffer, and update_scene writes the plan's host rows
        plan.combo = plan.combo.copy()
        kind = plan_kind(plan)
        n_pad = tape.combo_quads
        if kind == "mega":
            combo = plan.mega_combo
            n_quads = combo.shape[0] - 1  # one meta row, the clear color
        else:
            combo = plan.combo
            n_quads = n_pad
        scene = DeviceScene(kind, plan, self._upload(combo), n_quads, n_pad)
        # spans index tape rows, which are the resident rows unless the mega
        # combo interleaves clear sentinels
        if tape.root_spans and not (kind == "mega" and tape.mask_count):
            scene.spans = patchable_spans(tape)
            scene.anim_spans = dict(tape.root_spans)
        scene.atlas_generation = self.atlas.generation
        scene.snap_args = (frame_size, clear_main, clear_color, reserve, animate)
        return scene

    def update_scene(self, scene: DeviceScene, renders, dirty=None) -> DeviceScene:
        """Bring a DeviceScene up to date after edits in place of `renders`,
        the scene it was snapshot from (renderer.update_scene): for a
        RendersArray walk only the dirty roots again and patch their rows
        into the resident buffer, so a frame's host cost follows the edited
        quads, not the scene; a tree always takes a new snapshot.

        dirty: (lvl, root_node_idx) keys, or bare ints for layer 0, of the
        roots whose subtrees changed. An edit that keeps a subtree's pass
        structure and does not grow its quad count past its span patches in
        place: geometry, rotation, fills, corners, shadow and stroke values.
        Anything else (a structural edit, a plane mask, a blur or a backdrop
        in a dirty root, an atlas rebuild, dirty=None) takes a new snapshot
        into `scene`: the same frames at a snapshot's cost. Returns scene."""
        self._assert_render_thread()
        self._check_scene_device(scene)
        if patch_device_scene(self, scene, renders, dirty):
            return scene
        frame_size, clear_main, clear_color, reserve, animate = scene.snap_args
        fresh = self.snapshot_scene(renders, frame_size, clear_main, clear_color,
                                    reserve=reserve, animate=animate)
        for slot in DeviceScene.__slots__:
            setattr(scene, slot, getattr(fresh, slot))
        return scene

    def _check_scene_device(self, scene: DeviceScene) -> None:
        """A scene is viewed and patched on the renderer's own device: a
        renderer on the card never runs a scene that lies on the CPU (it
        would take the plain versions of every kernel), nor the reverse."""
        have = scene.combo_dev.device

        def index(d: torch.device) -> int:
            if d.type != "cuda":
                return 0
            return torch.cuda.current_device() if d.index is None else d.index

        if have.type != self.device.type or index(have) != index(self.device):
            raise ValueError(f"the scene lies on {have}, the renderer on "
                             f"{self.device}: snapshot it with this renderer, or "
                             f"carry it over with from_jax_scene(scene, "
                             f"renderer.device)")

    @staticmethod
    def _flush_scene_patch(scene: DeviceScene) -> None:
        """Upload a pending patch and copy its rows into the resident buffer,
        in place, as 32-bit words."""
        if scene.pending_patch is None:
            return
        staged = torch.from_numpy(patch_staging(*scene.pending_patch)).to(
            scene.combo_dev.device).view(torch.int32)
        scene.combo_dev.view(torch.int32).index_copy_(
            0, staged[:, -1].long(), staged[:, :-1])
        scene.pending_patch = None

    @staticmethod
    def _partial_ok(scene: DeviceScene, cam) -> bool:
        """A damage-clipped frame is sound when the previous frame was
        rendered under the same camera, composites from the clear color (no
        init frame), and the pass structure has no blur and no backdrop,
        whose halos read pixels outside the damage rects."""
        if (not scene.pending_damage or scene.last_view_frame is None
                or scene.last_cam != cam or scene.plan.has_init_frame):
            return False
        return not any(item[0] == "blur" or (item[0] == "draw" and item[3])
                       for item in scene.plan.structure)

    def render_view(self, scene: DeviceScene, pan=(0.0, 0.0), zoom: float = 1.0,
                    root_transforms=None) -> torch.Tensor:
        """One (H, W, 4) f32 frame of a device-resident scene under the
        screen-space camera p' = zoom * p + pan, zoom > 0
        (renderer.render_view).

        Bit-exact against flattening the transformed scene for integer pans
        and zooms of integer scenes; a fractional view shifts the baked
        antialiasing without snapping again. Like a GL scale transform, zoom
        widens AA and shadow falloff and leaves backdrop-blur radii in
        screen pixels.

        root_transforms animates the scene with no walk: {root key:
        transform} with update_scene's keys and scene.affine6's forms, or a
        bulk (R, 6) array in scene.animation_order()'s slot order; only the
        table goes to the device. Transforms are absolute from the
        snapshot's geometry and the camera composes on top (p'' = zoom * (M
        p + t) + pan); integer translations and power-of-two scales of
        integer roots are bit-exact against a flatten of the roots wrapped
        in the same nkTransform. Raises ValueError for a snapshot without a
        per-root row mapping, and for a scene that lies on another device
        than this renderer.

        A pending update_scene patch lands first. When the camera has not
        moved since the last frame and the structure allows it
        (_partial_ok), the frame is damage-clipped: quads outside the edits'
        old and new bboxes drop out of the binning and the previous frame's
        pixels stand outside the damage rects, bit-equal to the full
        render."""
        self._check_scene_device(scene)
        cam = (float(pan[0]), float(pan[1]), float(zoom), scene.kind)
        dev = scene.combo_dev.device
        camera = torch.tensor(cam[:3], dtype=torch.float32).to(dev)
        d, z = camera[:2], camera[2:]
        table = ridx = rects = None
        if root_transforms is not None:
            table = torch.from_numpy(anim_table(scene, root_transforms)).to(dev)
            ridx = scene.anim_ridx_dev
        elif scene.pending_patch is not None and self._partial_ok(scene, cam):
            rects = damage_rects(scene.pending_damage)
        self._flush_scene_patch(scene)
        viewed = transform_rows(
            scene.combo_dev, scene.n_quads, d, z, scene.scratch, table, ridx,
            None if rects is None else torch.from_numpy(rects).to(dev))
        frame = self._run_plan(scene.plan, viewed)
        if rects is not None:
            # the previous frame everywhere but in the damage rects; a copy,
            # so that frame stays what it was for whoever holds it
            merged = scene.last_view_frame.clone()
            for y0, y1, x0, x1 in damage_spans(rects, cam[:2], cam[2],
                                               frame.shape[0], frame.shape[1]):
                merged[y0:y1, x0:x1] = frame[y0:y1, x0:x1]
            frame = self.last_frame = merged
        scene.pending_damage = None
        # an animated frame is no source for a damage-clipped one: its quads
        # moved without damage tracking
        animated = root_transforms is not None
        scene.last_cam = None if animated else cam
        scene.last_view_frame = None if animated else frame
        return frame

    def render_views(self, scene: DeviceScene, pans, zooms=1.0,
                     as_uint8: bool = False) -> torch.Tensor:
        """A flythrough of a device-resident scene: (N, H, W, 4) frames, f32
        or (as_uint8) take_screenshot's u8, for N cameras, written into one
        preallocated stack (renderer.render_views). pans: (N, 2); zooms: a
        scalar or (N,). The cameras go to the device in one upload; each
        view equals render_view's. A scene that does not clear composites
        each view onto the one before."""
        self._assert_render_thread()
        self.drain_async()
        self._check_scene_device(scene)
        ds = np.asarray(pans, dtype=np.float32).reshape(-1, 2)
        n = ds.shape[0]
        zarr = np.asarray(zooms, dtype=np.float32)
        zs = np.full((n,), zarr, np.float32) if zarr.ndim == 0 else zarr.reshape(n)
        self._flush_scene_patch(scene)
        dev = scene.combo_dev.device
        cameras = torch.from_numpy(np.column_stack([ds, zs])).to(dev)
        plan = scene.plan
        out = torch.empty((n, plan.height, plan.width, 4), device=dev,
                          dtype=torch.uint8 if as_uint8 else torch.float32)
        for i in range(n):
            viewed = transform_rows(scene.combo_dev, scene.n_quads,
                                    cameras[i, :2], cameras[i, 2:], scene.scratch)
            frame = self._run_plan(plan, viewed)
            out[i] = frames_to_u8(frame) if as_uint8 else frame
        return out

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


def _needs_atlas(plan: ExecPlan) -> bool:
    """Whether a plan's executor samples the atlas: a megakernel plan with
    atlas quads, or a draw run of the frame executor that holds one."""
    if plan.mega_combo is not None:
        return plan.mega_atlas
    return any(item[0] == "draw" and item[2] for item in plan.structure)


def frames_to_u8(frames: torch.Tensor) -> torch.Tensor:
    """RGBA u8 on the device, take_screenshot's rounding (half to even)."""
    return torch.clamp(torch.round(frames * 255.0), 0, 255).to(torch.uint8)


def new_fig_renderer(atlas_size: int = 512, pixel_scale: float = 1.0,
                     device="cuda") -> FigRenderer:
    """renderer.new_fig_renderer, with the port's explicit device."""
    return FigRenderer(atlas_size=atlas_size, pixel_scale=pixel_scale,
                       device=device)
