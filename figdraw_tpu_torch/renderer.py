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

The device is explicit: FigRenderer(device="cuda") raises when CUDA is
absent, and a "cpu" renderer runs the plain torch versions of the kernels.
"""

from __future__ import annotations

from typing import Hashable, Optional

import numpy as np
import torch

from . import native
from .atlas import Atlas, AtlasEntryMeta
from .basics import fig_ui_scale, scaled
from .colors import Color, as_color
from .executor import get_frame_executor, get_mega_executor
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


class FigRenderer:
    """Renders scenes (a RendersArray, a Renders tree or a RenderFragments)
    to (H, W, 4) float32 frames on `device`.

    atlas_size, atlas_margin: the glyph/image atlas's first edge and its
    per-entry margin (it doubles on overflow). pixelate: nearest atlas
    sampling (GL_NEAREST) instead of bilinear. pixel_scale: device pixels
    per UI unit after the UI scale (a HiDPI frame); the walks draw the
    scene that much larger, and the caller sizes the frame. Glyph quads
    sample without the subpixel shift: the option comes with the text host
    pipeline."""

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
            return native.flatten_renders_array(
                renders, frame_size.x, frame_size.y, fig_ui_scale(),
                self.pixel_scale, self.aa_factor,
                self._clear_tuple(clear_main, clear_color),
                atlas=self._walk_atlas(), pool_owner=id(self), cull=cull,
                record_spans=record_spans, reserve=reserve,
            )
        backend = TapeBackend(white_uv=self._white_uv())
        backend.entries = self.atlas.entries
        backend.atlas_size = self.atlas.size
        backend.aa_factor = self.aa_factor
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

    def _run_mega(self, combo: np.ndarray, height: int, width: int,
                  n_masks: int, has_init_frame: bool, tile_h: int):
        """The megakernel on the walk's own mega export (no atlas quads)."""
        run = get_mega_executor(height, width, n_masks, has_init_frame, tile_h)
        frame = run(self._upload(combo),
                    self._init_frame(has_init_frame, height, width),
                    pixelate=self.pixelate)
        self.last_frame = frame
        return frame

    def _upload(self, combo: np.ndarray) -> torch.Tensor:
        """A synchronous copy: the walk's combo pool reuses the host buffer
        two flattens later."""
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
        needs_atlas = plan.mega_combo is None or plan.mega_atlas
        if atlas is None and needs_atlas:
            atlas = self._device_atlas()
        init = self._init_frame(plan.has_init_frame, plan.height, plan.width)
        if plan.mega_combo is not None:
            run = get_mega_executor(plan.height, plan.width, plan.n_masks,
                                    plan.has_init_frame, plan.tile_h)
            frame = run(combo, init, atlas=atlas if plan.mega_atlas else None,
                        pixelate=self.pixelate)
        else:
            run = get_frame_executor(plan.structure, plan.height, plan.width,
                                     plan.n_masks, plan.has_init_frame,
                                     plan.tile_h,
                                     rolled=plan.rolled_items is not None)
            frame = run(combo, init, atlas=atlas, pixelate=self.pixelate,
                        items=plan.rolled_items, radii=plan.rolled_radii)
        self.last_frame = frame
        return frame

    def render_frame(self, renders, frame_size: Vec2, clear_main: bool = True,
                     clear_color: Color = Color(1.0, 1.0, 1.0, 1.0)):
        """Full frame: apply pending image messages, flatten on the host,
        rasterize on the device. renders: a RendersArray, a Renders tree or
        a RenderFragments; frame_size in UI units (the frame is frame_size
        times the UI scale). Returns the (H, W, 4) f32 frame tensor
        (asynchronous on CUDA).

        A RendersArray takes the walk's fast export first
        (renderer.py:1307-1317): a mask-heavy scene without atlas quads,
        blurs or backdrops goes from the walk straight to the megakernel,
        every other scene through a tape and execute(), which sends a
        mask-heavy atlas scene to the megakernel too (plan.plan_execution).
        A tree takes the Python walk and execute(). A text node raises
        NotImplementedError on either walk."""
        fs = scaled(frame_size)
        if fs.x <= 0 or fs.y <= 0:
            return self.last_frame
        self.process_image_messages()
        if not isinstance(renders, RendersArray):
            return self.execute(self.flatten(renders, fs, clear_main, clear_color))
        cc = self._clear_tuple(clear_main, clear_color)
        result = native.flatten_fast(
            renders, fs.x, fs.y, fig_ui_scale(), self.pixel_scale,
            self.aa_factor, cc, atlas=self._walk_atlas(), pool_owner=id(self),
        )
        if result[0] == "tape":
            return self.execute(result[1])
        _, combo, mask_count, density = result
        width = int(round(fs.x))
        height = int(round(fs.y))
        # the pooled buffer's meta row may hold an earlier frame's clear
        # color; a frame that does not clear starts from the last frame
        combo[-1, 0:4] = cc if cc is not None else 0.0
        return self._run_mega(combo, height, width, mask_count + 1, cc is None,
                              tile_h_from_density(*density, height, width))

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


def frames_to_u8(frames: torch.Tensor) -> torch.Tensor:
    """RGBA u8 on the device, take_screenshot's rounding (half to even)."""
    return torch.clamp(torch.round(frames * 255.0), 0, 255).to(torch.uint8)


def new_fig_renderer(atlas_size: int = 512, pixel_scale: float = 1.0,
                     device="cuda") -> FigRenderer:
    """renderer.new_fig_renderer, with the port's explicit device."""
    return FigRenderer(atlas_size=atlas_size, pixel_scale=pixel_scale,
                       device=device)
