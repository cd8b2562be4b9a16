"""Rendering across several devices (figdraw_tpu/parallel/sharding.py):
a frame's rows split into bands over a mesh of devices, and whole frames
dealt to devices.

The JAX package drives every device of a 1-D `Mesh` from one process with
`shard_map`. The port does the same from one process over a tuple of
`torch.device`s (`Mesh`), with one band's tensors on each:

- the tape (the plan's packed upload) goes once to each distinct device of
  the mesh; each band decodes and bins it at its band origin, the global
  row of its row 0 (ops/binning.decode_and_bin(row0=)), and runs the same
  kernels as one device at that origin: the pass chain of K1, K1-atlas and
  K3 (get_sharded_frame_executor) or one megakernel K4 / K4-atlas a band
  (get_sharded_mega_executor);
- the backdrop blur's vertical pass swaps BLUR_HALO rows with the
  neighbouring bands, or gathers every band where a band is shorter than
  the halo (ops/blur.banded_blur_planar, X6: two launches a device that
  read the bands' rows in place and write the backdrops); only rows of
  bands on another device move, by tensor copies, no collective library
  is needed;
- ShardedFigRenderer carries render_frame, execute, device-resident scenes
  (snapshot_scene, update_scene, render_view with per-root animation and
  the damage clip, render_views), the result an (H, W, 4) tensor on the
  mesh's first device;
- get_frame_parallel_runner deals whole frames of a batch to the devices in
  contiguous blocks (FigRenderer.render_batch(mesh=) and
  render_views(mesh=)).

A mesh may name one device more than once: the CPU tests use [cpu] * n,
which takes the kernels' plain versions, and one card runs [cuda:0] * n.
A CUDA mesh launches the kernels or raises; nothing falls back.

Band geometry is JAX's (_band_geometry): a band of `pband` rows, a multiple
of SHARD_TILE_H (8), the frame padded to gh = n pband
rows and pw, a multiple of 128, columns; the blur clamps at row gh - 1.
The port's kernels tile a band by a tile height of 16 to 128 rows
(band_tiles), so a band's planes may hold a few rows more than pband: they
render the next band's rows again and are dropped; the blur and the crop
see only the band's own pband rows.

The JAX package's fallback chain (use_pallas=False, the XLA raster path,
the 1:1 atlas window, _downgrade_scene) has no counterpart: the port has
one sampler and one route. Its power-of-two padding of the frame axis
bounds XLA signatures, which the port does not have.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from .. import executor
from ..basics import scaled
from ..colors import Color, as_color
from ..config import batch_chunk
from ..executor import item_rows, read_meta
from ..ops import mega, raster
from ..ops.blur import BLUR_HALO, banded_blur_planar
from ..ops.rows import damage_spans, transform_rows
from ..plan import plan_execution
from ..scene import (
    DeviceScene, anim_state, anim_table, damage_rects, patch_device_scene,
    patch_staging, plan_kind,
)
from ..tape import FRAME_TARGET

ROWS_AXIS = "rows"
FRAMES_AXIS = "frames"
# a band's rows are a multiple of this (sharding.py:149's default; the
# port's kernels tile a band by band_tiles, so it sets only the bands'
# boundaries and the row the blur clamps at)
SHARD_TILE_H = 8
SHARD_TILE_W = 128
BAND_TILE_MIN = 16  # the kernels' least tile height (their 16x16 blocks)

__all__ = [
    "BLUR_HALO", "FRAMES_AXIS", "Mesh", "ROWS_AXIS", "SHARD_TILE_H",
    "SHARD_TILE_W", "ShardedFigRenderer", "assemble", "band_geometry",
    "band_tiles", "cached_frame_parallel_runner", "deal", "deal_blocks",
    "default_mesh", "frames_mesh", "get_frame_parallel_runner", "get_sharded_frame_executor",
    "get_sharded_mega_executor", "kept_copy", "scene_rows",
]


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices of one axis, in order (a device may repeat).
    Every device is of one type, "cuda" or "cpu"; a CUDA device without an
    index is device 0."""

    devices: Tuple[torch.device, ...]
    axis_name: str = ROWS_AXIS

    def __post_init__(self):
        devs = []
        for d in self.devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", 0)
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        types = sorted({d.type for d in devs})
        if len(types) != 1:
            raise ValueError(f"a mesh holds devices of one type, got {types}")
        if types[0] not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device type {types[0]}")
        object.__setattr__(self, "devices", tuple(devs))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis_name: len(self.devices)}

    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in mesh order."""
        return tuple(dict.fromkeys(self.devices))


def _cuda_devices(n_devices: Optional[int], axis: str) -> Mesh:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: build a mesh of CPU devices explicitly, "
                           "Mesh((torch.device('cpu'),) * n)")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"{n} devices asked of {count}: a mesh that names a device "
                         "more than once is built explicitly")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


def default_mesh(n_devices: Optional[int] = None) -> Mesh:
    """Every CUDA device, or the first n_devices, on the rows axis
    (sharding.py:123). Raises without CUDA."""
    return _cuda_devices(n_devices, ROWS_AXIS)


def frames_mesh(n_devices: Optional[int] = None) -> Mesh:
    """Every CUDA device, or the first n_devices, on the frames axis, for
    FigRenderer.render_batch(mesh=) and render_views(mesh=) (sharding.py:944).
    Raises without CUDA."""
    return _cuda_devices(n_devices, FRAMES_AXIS)


def _on(device: torch.device):
    """The device's context for the launches of one band: the ctypes
    launches read the current device (its stream, the kernels' per-device
    one-time setup)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def band_geometry(mesh, height: int, width: int):
    """(n, th, tw, pband, gh, pw) of a frame over a mesh (or a band count),
    as the JAX package's _band_geometry: pband rows a band, a multiple of
    SHARD_TILE_H; gh = n pband, the padded height the blur clamps at; pw the
    width padded to SHARD_TILE_W."""
    n = mesh if isinstance(mesh, int) else mesh.size
    th, tw = SHARD_TILE_H, SHARD_TILE_W
    band = -(-height // n)
    pband = max(-(-band // th) * th, th)
    return n, th, tw, pband, pband * n, -(-width // tw) * tw


def band_tiles(pband: int, tile_h: int):
    """(kernel tile height, rows of a band's planes) for a band of pband
    rows and a plan's tile height: the tallest of tile_h, tile_h / 2, ...,
    16 that pads the band by at most an eighth (else 16), and the band's
    rows rounded up to it."""
    t = max(tile_h, BAND_TILE_MIN)
    while t > BAND_TILE_MIN and -(-pband // t) * t - pband > pband // 8:
        t //= 2
    t = max(t, BAND_TILE_MIN)
    return t, -(-pband // t) * t


def assemble(bands, pband: int, height: int, width: int, device) -> torch.Tensor:
    """The (height, width, 4) frame on `device` from band planes (4, >=
    pband, pw), band i holding rows [i pband, (i+1) pband)."""
    out = torch.empty((height, width, 4), dtype=torch.float32, device=device)
    for i, planes in enumerate(bands):
        a, b = i * pband, min((i + 1) * pband, height)
        if b <= a:
            break
        out[a:b].copy_(planes[:, : b - a, :width].permute(1, 2, 0))
    return out


def scene_rows(scene: DeviceScene, dev):
    """(rows, scratch, ridx or None) of a device-resident scene on a device:
    its own on the device it was snapshot on, else a copy made at first use
    and kept in scene.replicas until a patch through FigRenderer or a new
    snapshot drops the copies. ridx: the animated scene's root index there."""
    if dev == scene.combo_dev.device:
        return scene.combo_dev, scene.scratch, scene.anim_ridx_dev
    if scene.replicas is None:
        scene.replicas = {}
    rep = scene.replicas.get(dev)
    if rep is None:
        combo = scene.combo_dev.to(dev, copy=True)
        rep = scene.replicas[dev] = [combo, torch.empty_like(combo), None, None]
    if scene.anim_ridx_dev is not None and rep[2] is not scene.anim_ridx_dev:
        rep[2], rep[3] = scene.anim_ridx_dev, scene.anim_ridx_dev.to(dev)
    return rep[0], rep[1], rep[3]


def kept_copy(copies: dict, tensor: torch.Tensor, stamp, dev) -> torch.Tensor:
    """tensor on dev: itself where it lies there, else a copy kept in
    copies[dev] and made again when stamp or the shape changes."""
    if dev == tensor.device:
        return tensor
    got = copies.get(dev)
    if got is None or got[0] != stamp or got[1].shape != tensor.shape:
        got = copies[dev] = (stamp, tensor.to(dev))
    return got[1]


class _Band:
    """One band's state through an executor run."""

    __slots__ = ("device", "row0", "planes", "masks", "backdrop", "fields",
                 "modes", "tile_idx", "tile_counts", "bounds", "radii")


def _start_band(band: _Band, clear_color, init, pband: int, kh: int, pw: int):
    """The band's planes: its rows of the previous frame (init, (4, pband,
    pw) on its device) or the clear color, kh rows."""
    if init is None:
        band.planes = clear_color[:, None, None].expand(4, kh, pw).contiguous()
    else:
        band.planes = torch.zeros((4, kh, pw), dtype=torch.float32, device=band.device)
        band.planes[:, :pband] = init


@lru_cache(maxsize=64)
def get_sharded_frame_executor(structure: Tuple, height: int, width: int,
                               n_masks: int, has_init_frame: bool, tile_h: int,
                               n_bands: int, rolled: bool = False):
    """The mesh-sharded frame executor (sharding.py:193-342) for one pass
    structure: run(combos, devices, init_bands=None, atlases=None, ...) ->
    the bands' (4, kh, pw) planes, band i at global row i * pband
    (band_geometry; kh from band_tiles).

    combos: {device: the plan's upload there}; devices: each band's device
    (n_bands of them); init_bands: each band's (4, pband, pw) planes of the
    previous frame when has_init_frame; atlases: {device: (S, S, 4) f32
    atlas} for plans with atlas runs. Each band decodes and bins the whole
    tape once at its origin, culling the frame-target runs only, then runs
    the structure in order: draws through `draw` / `draw_mask` (the K1 and
    K3 wrappers, or a check's substitutes), mask clears, and each blur as
    one banded blur over every band. items / radii: the rolled form's table
    (executor.get_frame_executor)."""
    n, _th, tw, pband, _gh, pw = band_geometry(n_bands, height, width)
    kth, kh = band_tiles(pband, tile_h)
    tiles_y, tiles_x = kh // kth, pw // tw
    any_blur = any(item[0] == "blur" for item in structure)
    draws = [item for item in structure if item[0] == "draw"]
    rows_of = item_rows(structure, rolled)
    frame_pos = [] if rolled else [
        i for i, item in enumerate(draws) if item[1] == FRAME_TARGET]
    frame_rows = {}  # device -> frame_pos as an index tensor there, made once

    def run(combos: dict, devices, init_bands=None, atlases=None,
            pixelate: bool = False, subpixel_positioning: bool = False,
            draw=raster.draw_pass_planar_prebinned,
            draw_mask=raster.draw_pass_mask_prebinned,
            items=None, radii=None) -> list:
        if len(devices) != n:
            raise ValueError(f"{len(devices)} band devices for {n} bands")
        metas = {}
        bands = []
        for i, dev in enumerate(devices):
            band = _Band()
            band.device, band.row0 = dev, i * pband
            combo = combos[dev]
            with _on(dev):
                if dev not in metas:
                    metas[dev] = read_meta(combo, structure, rolled, items, radii)
                bounds, blur_radii, clear_color, meta = metas[dev]
                band.bounds, band.radii = bounds, blur_radii
                _start_band(band, clear_color, init_bands[i] if has_init_frame else None,
                            pband, kh, pw)
                band.masks = torch.zeros((n_masks, kh, pw), dtype=torch.float32,
                                         device=dev)
                band.masks[0] = 1.0
                band.backdrop = (torch.zeros((4, kh, pw), dtype=torch.float32, device=dev)
                                 if any_blur else None)
                run_bounds = None
                if frame_pos:
                    rows_at = frame_rows.get(dev)
                    if rows_at is None:
                        rows_at = frame_rows[dev] = torch.tensor(frame_pos, device=dev)
                    run_bounds = bounds.index_select(0, rows_at)
                rows = combo.shape[0] - meta
                (band.fields, band.modes, band.tile_idx,
                 band.tile_counts) = executor.decode_and_bin(
                    combo[:rows], 0, rows, tiles_y, tiles_x, kth, tw,
                    cull=bool(frame_pos), run_bounds=run_bounds, row0=band.row0)
            bands.append(band)

        for item, row in zip(structure, rows_of):
            if item[0] == "blur":
                # X6 reads each band's rows [0, pband) in place and writes
                # them into its backdrop
                banded_blur_planar([b.planes[:, :pband] for b in bands],
                                   [b.radii[row] for b in bands],
                                   out=[b.backdrop[:, :pband] for b in bands])
                continue
            for b in bands:
                with _on(b.device):
                    if item[0] == "clear_mask":
                        b.masks[item[1]] = 0.0
                        continue
                    atlas = atlases[b.device] if item[2] else None
                    flags = dict(tile_h=kth, pixelate=pixelate,
                                 subpixel_positioning=subpixel_positioning,
                                 row0=b.row0)
                    if item[1] == FRAME_TARGET:
                        b.planes = draw(b.fields, b.modes, b.bounds[row], b.tile_idx,
                                        b.tile_counts, b.planes, b.masks,
                                        b.backdrop if item[3] else None, atlas=atlas,
                                        **flags)
                    else:
                        plane = b.masks[item[1] : item[1] + 1]
                        out = draw_mask(b.fields, b.modes, b.bounds[row], b.tile_idx,
                                        b.tile_counts, plane, b.masks, atlas=atlas,
                                        **flags)
                        if out is not plane:
                            plane.copy_(out)
        return [b.planes for b in bands]

    return run


@lru_cache(maxsize=32)
def get_sharded_mega_executor(height: int, width: int, n_masks: int,
                              has_init_frame: bool, tile_h: int, n_bands: int):
    """The mesh-sharded megakernel (sharding.py:345-393): run(combos,
    devices, init_bands=None, atlases=None, ...) -> the bands' (4, kh, pw)
    planes, as get_sharded_frame_executor's; one front end and one K4 (or
    K4-atlas, with atlases) a band at its origin. draw: the megakernel's
    wrapper, or a check's substitute."""
    n, _th, tw, pband, _gh, pw = band_geometry(n_bands, height, width)
    kth, kh = band_tiles(pband, tile_h)
    tiles_y, tiles_x = kh // kth, pw // tw

    def run(combos: dict, devices, init_bands=None, atlases=None,
            pixelate: bool = False, subpixel_positioning: bool = False,
            draw=mega.draw_pass_mega) -> list:
        if len(devices) != n:
            raise ValueError(f"{len(devices)} band devices for {n} bands")
        out = []
        for i, dev in enumerate(devices):
            band = _Band()
            band.device, band.row0 = dev, i * pband
            combo = combos[dev]
            with _on(dev):
                _start_band(band, combo[-1, 0:4], init_bands[i] if has_init_frame else None,
                            pband, kh, pw)
                rows = combo.shape[0] - 1
                fields, modes, tile_idx, tile_counts = executor.decode_and_bin(
                    combo[:rows], 0, rows, tiles_y, tiles_x, kth, tw, row0=band.row0)
                out.append(draw(fields, modes, tile_idx, tile_counts, band.planes,
                                n_masks, tile_h=kth,
                                atlas=None if atlases is None else atlases[dev],
                                pixelate=pixelate,
                                subpixel_positioning=subpixel_positioning,
                                row0=band.row0))
        return out

    return run


def _needs_atlas(plan) -> bool:
    if plan.mega_combo is not None:
        return plan.mega_atlas
    return any(item[0] == "draw" and item[2] for item in plan.structure)


class ShardedFigRenderer:
    """A frame's rows split into bands over a mesh (sharding.py:396-941):
    the host walk and the atlas are one FigRenderer's on the mesh's first
    device; each band runs the single-device kernels at its band origin.
    Results are (H, W, 4) f32 tensors on the mesh's first device.

    mesh: a Mesh (default_mesh() when None); atlas_size and pixel_scale as
    FigRenderer's. The JAX package's use_pallas has no counterpart."""

    def __init__(self, mesh: Optional[Mesh] = None, atlas_size: int = 256,
                 pixel_scale: float = 1.0):
        from ..renderer import FigRenderer

        self.mesh = mesh if mesh is not None else default_mesh()
        self.n = self.mesh.size
        self._flattener = FigRenderer(atlas_size=atlas_size, pixel_scale=pixel_scale,
                                      device=self.mesh.devices[0])
        self.last_frame = None
        # each band's (4, pband, pw) planes of the last frame: where a frame
        # that does not clear starts
        self._last_bands = None
        self._atlas_copies = {}  # device -> (atlas stamp, atlas there)
        self.uploads = 0  # tape uploads, one a distinct device a frame
        self.last_plan_kind = None  # the last frame's executor: "mega", "rolled", "unrolled"

    def process_image_messages(self) -> None:
        self._flattener.process_image_messages()

    # --- frames ---------------------------------------------------------------

    def render_frame(self, renders, frame_size, clear_main: bool = True,
                     clear_color: Color = Color(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
        """The walk on the host (FigRenderer's, the fast export included),
        then the bands on the mesh: (H, W, 4) f32 on the first device."""
        fs = scaled(frame_size)
        if fs.x <= 0 or fs.y <= 0:
            return self.last_frame
        ren = self._flattener
        ren._assert_render_thread()
        ren.process_image_messages()
        plan = ren._walk_plan(renders, fs, clear_main, clear_color)
        frame = self.execute_plan(plan)
        ren.publish_atlas_usage()
        return frame

    def execute(self, tape) -> torch.Tensor:
        """Plan the tape on the host (plan.plan_execution: the megakernel,
        the rolled or the unrolled pass chain), then run it on the bands."""
        return self.execute_plan(plan_execution(tape))

    def execute_plan(self, plan) -> torch.Tensor:
        """Upload the plan's combo to each distinct device once, then run
        it on the bands."""
        rows = plan.mega_combo if plan.mega_combo is not None else plan.combo
        return self._run(plan, self._upload(rows))

    def _upload(self, rows: np.ndarray) -> dict:
        host = torch.from_numpy(rows)
        combos = {}
        for dev in self.mesh.distinct():
            combos[dev] = host.to(dev, copy=True)
            self.uploads += 1
        return combos

    def _atlases(self) -> dict:
        """The device atlas on each distinct device: the flattener's on the
        first, a copy kept on each other until the atlas changes."""
        ren = self._flattener
        first = ren._device_atlas()
        return {dev: kept_copy(self._atlas_copies, first, ren._atlas_stamp, dev)
                for dev in self.mesh.distinct()}

    def _init_bands(self, plan):
        _n, _th, _tw, pband, _gh, pw = band_geometry(self.mesh, plan.height, plan.width)
        last = self._last_bands
        if last is not None and tuple(last[0].shape) == (4, pband, pw):
            return last
        return [torch.zeros((4, pband, pw), dtype=torch.float32, device=d)
                for d in self.mesh.devices]

    def _bands(self, plan, combos: dict, draws=None) -> list:
        """The plan's executor over the bands. draws: the executor's draw
        keywords (a check's substitutes), or None."""
        ren = self._flattener
        init = self._init_bands(plan) if plan.has_init_frame else None
        atlases = self._atlases() if _needs_atlas(plan) else None
        common = dict(pixelate=ren.pixelate,
                      subpixel_positioning=ren.text_subpixel_positioning, **(draws or {}))
        if plan.mega_combo is not None:
            run = get_sharded_mega_executor(plan.height, plan.width, plan.n_masks,
                                            plan.has_init_frame, plan.tile_h, self.n)
            return run(combos, self.mesh.devices, init,
                       atlases if plan.mega_atlas else None, **common)
        run = get_sharded_frame_executor(plan.structure, plan.height, plan.width,
                                         plan.n_masks, plan.has_init_frame, plan.tile_h,
                                         self.n, rolled=plan.rolled_items is not None)
        return run(combos, self.mesh.devices, init, atlases,
                   items=plan.rolled_items, radii=plan.rolled_radii, **common)

    def _run(self, plan, combos: dict, draws=None) -> torch.Tensor:
        bands = self._bands(plan, combos, draws)
        self.last_plan_kind = plan_kind(plan)
        _n, _th, _tw, pband, _gh, _pw = band_geometry(self.mesh, plan.height, plan.width)
        self._last_bands = [b[:, :pband] for b in bands]
        self.last_frame = assemble(bands, pband, plan.height, plan.width,
                                   self.mesh.devices[0])
        return self.last_frame

    # --- device-resident scenes ------------------------------------------------

    def snapshot_scene(self, renders, frame_size, clear_main: bool = True,
                       clear_color: Color = Color(1.0, 1.0, 1.0, 1.0),
                       reserve=None, animate: bool = False) -> DeviceScene:
        """FigRenderer.snapshot_scene on the first device, its resident rows
        copied to each other distinct device (sharding.py:626-677)."""
        scene = self._flattener.snapshot_scene(renders, frame_size, clear_main,
                                               as_color(clear_color), reserve=reserve,
                                               animate=animate)
        self._replicate(scene)
        return scene

    def _replicate(self, scene: DeviceScene) -> None:
        """The scene's rows and a scratch buffer on each distinct device but
        the first (scene.replicas)."""
        scene.replicas = {}
        for dev in self.mesh.distinct():
            scene_rows(scene, dev)

    def _check_scene(self, scene: DeviceScene) -> None:
        have = scene.combo_dev.device
        if have.type == "cuda" and have.index is None:
            have = torch.device("cuda", 0)
        if have != self.mesh.devices[0]:
            raise ValueError(f"the scene lies on {have}, the mesh starts at "
                             f"{self.mesh.devices[0]}: snapshot it with this renderer")
        if scene.replicas is None:
            self._replicate(scene)

    def _flush(self, scene: DeviceScene) -> None:
        """A pending patch into every resident copy of the rows, as 32-bit
        words."""
        if scene.pending_patch is None:
            return
        staged = torch.from_numpy(patch_staging(*scene.pending_patch))
        copies = [scene.combo_dev] + [rep[0] for rep in scene.replicas.values()]
        for combo in copies:
            words = staged.to(combo.device).view(torch.int32)
            combo.view(torch.int32).index_copy_(0, words[:, -1].long(), words[:, :-1])
        scene.pending_patch = None

    def update_scene(self, scene: DeviceScene, renders, dirty=None) -> DeviceScene:
        """FigRenderer.update_scene on the mesh (sharding.py:679-728): the
        dirty roots' rows are patched into the rows of every device at the
        next view, else the scene is snapshot again."""
        ren = self._flattener
        ren._assert_render_thread()
        self._check_scene(scene)
        if patch_device_scene(ren, scene, renders, dirty):
            return scene
        frame_size, clear_main, clear_color, reserve, animate = scene.snap_args
        fresh = self.snapshot_scene(renders, frame_size, clear_main, clear_color,
                                    reserve=reserve, animate=animate)
        for slot in DeviceScene.__slots__:
            setattr(scene, slot, getattr(fresh, slot))
        return scene

    def _viewed(self, scene: DeviceScene, cams: dict, i: int, table=None,
                rects=None) -> dict:
        """Each distinct device's transformed rows of view i (cams: {device:
        (N, 3) f32 cameras there})."""
        viewed = {}
        for dev in self.mesh.distinct():
            combo, scratch, ridx = scene_rows(scene, dev)
            cam = cams[dev]
            with _on(dev):
                viewed[dev] = transform_rows(
                    combo, scene.n_quads, cam[i, :2], cam[i, 2:], scratch,
                    None if table is None else table.to(dev),
                    ridx if table is not None else None,
                    None if rects is None else rects.to(dev))
        return viewed

    def _cameras(self, cams: np.ndarray) -> dict:
        host = torch.from_numpy(np.ascontiguousarray(cams, np.float32))
        return {dev: host.to(dev) for dev in self.mesh.distinct()}

    def render_view(self, scene: DeviceScene, pan=(0.0, 0.0), zoom: float = 1.0,
                    root_transforms=None) -> torch.Tensor:
        """One frame of a device-resident scene under the camera p' = zoom p
        + pan, over the bands (sharding.py:730-826): the row kernel runs on
        each device's rows before the bands split, so a view equals the
        sharded render of the transformed scene bit for bit, as
        FigRenderer.render_view's equals the single-device one.
        root_transforms and the damage clip as FigRenderer.render_view's."""
        from ..renderer import FigRenderer

        self._check_scene(scene)
        cam = (float(pan[0]), float(pan[1]), float(zoom), scene.kind)
        table = rects = None
        if root_transforms is not None:
            table = torch.from_numpy(anim_table(scene, root_transforms))
            anim_state(scene)
        elif scene.pending_patch is not None and FigRenderer._partial_ok(scene, cam):
            rects = torch.from_numpy(damage_rects(scene.pending_damage))
        self._flush(scene)
        cams = self._cameras(np.asarray([cam[:3]], np.float32))
        frame = self._run(scene.plan, self._viewed(scene, cams, 0, table, rects))
        if rects is not None:
            merged = scene.last_view_frame.clone()
            for y0, y1, x0, x1 in damage_spans(rects.numpy(), cam[:2], cam[2],
                                               frame.shape[0], frame.shape[1]):
                merged[y0:y1, x0:x1] = frame[y0:y1, x0:x1]
            frame = self.last_frame = merged
        scene.pending_damage = None
        animated = root_transforms is not None
        scene.last_cam = None if animated else cam
        scene.last_view_frame = None if animated else frame
        return frame

    def render_views(self, scene: DeviceScene, pans, zooms=1.0, chunk: int = 0,
                     as_uint8: bool = False) -> torch.Tensor:
        """A flythrough over the bands (sharding.py:878-930): (N, H, W, 4)
        frames on the first device, f32 or take_screenshot's u8; chunk:
        views whose cameras go to the devices in one upload (default
        FIGDRAW_BATCH_CHUNK). Each view equals render_view's; a scene that
        does not clear composites each view onto the one before."""
        from ..renderer import frames_to_u8

        self._check_scene(scene)
        ds = np.asarray(pans, dtype=np.float32).reshape(-1, 2)
        n = ds.shape[0]
        zarr = np.asarray(zooms, dtype=np.float32)
        zs = np.full((n,), zarr, np.float32) if zarr.ndim == 0 else zarr.reshape(n)
        plan = scene.plan
        out = torch.empty((n, plan.height, plan.width, 4), device=self.mesh.devices[0],
                          dtype=torch.uint8 if as_uint8 else torch.float32)
        if plan.has_init_frame:
            for i in range(n):
                frame = self.render_view(scene, ds[i], float(zs[i]))
                out[i] = frames_to_u8(frame) if as_uint8 else frame
            return out
        self._flush(scene)
        chunk = chunk if chunk > 0 else batch_chunk()
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            cams = self._cameras(np.column_stack([ds[s:e], zs[s:e]]))
            for i in range(s, e):
                frame = self._run(plan, self._viewed(scene, cams, i - s))
                out[i] = frames_to_u8(frame) if as_uint8 else frame
        return out


# --- whole frames dealt to devices ------------------------------------------------


def deal(count: int, mesh: Mesh) -> list:
    """[(device, start, end)]: count frames dealt to the mesh's devices in
    contiguous blocks, in order, the first blocks one frame longer."""
    k = mesh.size
    out, at = [], 0
    for i, dev in enumerate(mesh.devices):
        take = count // k + (i < count % k)
        out.append((dev, at, at + take))
        at += take
    return out


def deal_blocks(mesh: Mesh, count: int, out: torch.Tensor, fn) -> torch.Tensor:
    """count items dealt to the mesh's devices in contiguous blocks (deal):
    fn(device, a, b, part) fills part, (b - a,) + out.shape[1:], under the
    device's context, part being out[a:b] itself where out lies on the
    device, else a tensor there; then the parts go into out in order.
    Returns out."""
    parts = []
    for dev, a, b in deal(count, mesh):
        if a == b:
            continue
        with _on(dev):
            if out.device == dev:
                fn(dev, a, b, out[a:b])
                continue
            part = torch.empty((b - a,) + tuple(out.shape[1:]), dtype=out.dtype,
                               device=dev)
            fn(dev, a, b, part)
        parts.append((a, b, part))
    for a, b, part in parts:
        out[a:b].copy_(part)
    return out


def get_frame_parallel_runner(run, mesh: Mesh):
    """The frame-parallel form of executor.run_batch (sharding.py:954-982):
    batched(batch, out, **const) runs the single-frame executor `run` on
    each frame of a BatchStack, the frames dealt to the mesh's devices in
    contiguous blocks (deal_blocks): each device gets its block's rows in
    one upload and runs its frames in order, then the frames go into out
    (F, H, W, 4) in order. const: the frame-invariant keywords; a tensor
    among them is copied to each device. Each frame equals run's on the
    same buffers bit for bit."""

    def batched(batch, out: torch.Tensor, **const) -> torch.Tensor:
        def block(dev, a, b, part):
            stack = batch.upload(dev, a, b)
            here = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
                    for k, v in const.items()}
            for f in range(b - a):
                part[f] = run(**batch.frame(stack, f), **here)

        return deal_blocks(mesh, batch.count, out, block)

    return batched


_FRAME_PARALLEL = {}


def cached_frame_parallel_runner(run, mesh: Mesh):
    """get_frame_parallel_runner, one a (run, mesh)."""
    key = (run, mesh)
    got = _FRAME_PARALLEL.get(key)
    if got is None:
        got = _FRAME_PARALLEL[key] = get_frame_parallel_runner(run, mesh)
    return got
