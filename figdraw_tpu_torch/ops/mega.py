"""Megakernel: a whole clip-masked frame in one tile walk (kernels K4 and
K4-atlas).

`draw_pass_mega` runs csrc/mega.cu, the hand-written Hopper (sm_90a) port of
figdraw_tpu/ops/raster_pallas.py `_mega_kernel` (reached there through
`draw_pass_mega`, :643) in both its forms: without the atlas (K4) and with
it (K4-atlas, `has_atlas=True`; here the general in-kernel sampler of
csrc/sdf.cuh for atlas modes 0 and 13-16, bilinear or nearest, any uv map).
Each quad's target (the frame or mask plane k) and the mask clears ride in
the mode lane (plan.pack_mega_combo, or the walk's own mega export), so one
kernel walks each tile's binned list once, in tape order, holding the K
mask planes on chip. The tape is binned first, with no culling
(ops.binning.bin_quads without modes, as raster_pallas.prebin).

The wrapper updates the frame planes in place and returns them (the JAX
pass is pure); `draw_pass_mega_plain` stays pure and returns new planes,
and the wrapper's CPU branch copies its result into the frame. The kernel
culls each 16x16 block's list entries, clear sentinels included, by bbox
(`entry_survivors` states the rule; `draw_pass_mega_plain(..., cull=True)`
composites with it). That is exact for tapes whose clear sentinels carry the
union of the bboxes of the quads that read or write their plane, under the
clamps, before its next clear, as the packers make them. An entry that
targets plane 0, the all-pass parent, is never culled: the write clamp sends
it to plane 1 with plane 0 as its source, which changes plane 1 outside the
quad's bbox too (the walk emits none, but the clamps hold for any tape).

Both take `row0`, the band origin of the TPU kernel (seg_ref[0],
raster_pallas.py:505): the global row of the frame's row 0, 0 for a whole
frame and a band's own origin when a frame is split into row bands over
several devices (parallel/sharding.py).

CUDA tensors launch the kernel or raise; CPU tensors take
`draw_pass_mega_plain`, the plain torch version the CPU tests and the
on-card comparison use.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import nvcc
from .layout import QF_BBOX_X0, QI_MASK, QI_MODE
from .quad_eval_planar import eval_quad_planar
from .raster import (
    BLOCK, TILE_H, TILE_W, block_pairs, block_survivors, check_row0,
    check_tiles, from_tiles, pixel_centers, tile_origins, to_tiles,
)

# mode-lane packing (raster_pallas.py:481-492)
MEGA_CLEAR_BIT = 1 << 12  # clear sentinel: zero plane target - 1
MEGA_TARGET_SHIFT = 16  # bits 16+: target + 1 (0 = frame, k + 1 = plane k)
MEGA_EVAL_MASK = 0x2FFF  # the bits passed to the evaluator
# the kernel keeps K planes per 256-pixel block in shared memory, 1 KB each;
# 200 leave room under the 227 KB a block may use (csrc/mega.cu MAX_PLANES)
MAX_PLANES = 200

# kernel launches since the count was last reset: K4 (no atlas) and
# K4-atlas
LAUNCHES = 0
ATLAS_LAUNCHES = 0
# of those, the launches at a band origin other than 0 (row0 != 0)
BAND_LAUNCHES = 0
BAND_ATLAS_LAUNCHES = 0

_SOURCES = ("mega.cu", "cull.cuh", "sdf.cuh")

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""  # nvcc's output of the build this process loaded (ptxas -v)


def load() -> ctypes.CDLL:
    """The kernel library, built and bound at first use."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is None:
            path, BUILD_LOG = nvcc.build("figdraw_mega", _SOURCES)
            lib = ctypes.CDLL(path)
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.figdraw_mega.argtypes = [vp] * 6 + [i] * 11 + [vp]
            lib.figdraw_mega.restype = i
            _lib = lib
        return _lib


def draw_pass_mega(fields, modes, tile_idx, tile_counts, frame_planes,
                   n_masks: int, tile_h: int = TILE_H, atlas=None,
                   pixelate: bool = False, subpixel_positioning: bool = False,
                   row0: int = 0):
    """The whole frame over target-baked rows (kernel K4, or K4-atlas with
    an atlas).

    fields (N, 68) f32 and modes (N, 2) i32: the unpacked mega rows, clear
    sentinels included; tile_idx (T, N) i32 / tile_counts (T,) i32: their
    binning without culling; frame_planes (4, PH, PW) f32, the frame before
    the walk, updated in place; n_masks: K, the mask planes the walk keeps
    (plane 0 is the all-pass parent); atlas (S, S, 4) f32 or None, sampled
    by atlas-mode quads (0, 13-16), nearest when pixelate, mode 0's u
    shifted by the quad's subpixel shift when subpixel_positioning; row0:
    the band origin, the global row of the planes' row 0 (the binning's
    too). Returns frame_planes. On CUDA, K is at most MAX_PLANES
    (ValueError past it)."""
    row0 = check_row0(row0, frame_planes.shape[1])
    if frame_planes.device.type == "cpu":
        return frame_planes.copy_(draw_pass_mega_plain(
            fields, modes, tile_idx, tile_counts, frame_planes, n_masks,
            tile_h, atlas, pixelate, subpixel_positioning, row0=row0))
    if frame_planes.device.type != "cuda":
        raise ValueError(f"no megakernel for {frame_planes.device}")
    if not 1 <= n_masks <= MAX_PLANES:
        raise ValueError(f"the megakernel keeps 1 to MAX_PLANES = {MAX_PLANES} "
                         f"mask planes in shared memory, got {n_masks}")
    check_tiles(fields, modes, tile_idx, tile_counts, frame_planes, 4, tile_h,
                atlas)
    lib = load()
    _, ph, pw = frame_planes.shape
    stream = torch.cuda.current_stream(frame_planes.device).cuda_stream
    rc = lib.figdraw_mega(
        fields.data_ptr(), modes.data_ptr(), tile_idx.data_ptr(),
        tile_counts.data_ptr(), frame_planes.data_ptr(),
        atlas.data_ptr() if atlas is not None else None,
        fields.shape[0], pw // TILE_W, tile_h, TILE_W, ph, pw, row0, n_masks,
        atlas.shape[0] if atlas is not None else 0, int(pixelate),
        int(subpixel_positioning), stream)
    if rc != 0:
        raise RuntimeError(f"megakernel launch failed: cudaError {rc}")
    global LAUNCHES, ATLAS_LAUNCHES, BAND_LAUNCHES, BAND_ATLAS_LAUNCHES
    if atlas is None:
        LAUNCHES += 1
        BAND_LAUNCHES += row0 != 0
    else:
        ATLAS_LAUNCHES += 1
        BAND_ATLAS_LAUNCHES += row0 != 0
    return frame_planes


def targets_plane0(raw):
    """Whether a mode lane (int tensor) targets plane 0 (bits
    MEGA_TARGET_SHIFT+ == 1): such an entry is never culled."""
    return ((raw >> MEGA_TARGET_SHIFT) & 0xFFFF) == 1


def entry_survivors(bbox, raw, x0, y0, tile_h: int):
    """The megakernel's per-block cull in plain torch: raster's
    block_survivors on the entry's bbox, or every block of the tile for an
    entry that targets plane 0 (raw: the entries' mode lanes, (...) int)."""
    return block_survivors(bbox, x0, y0, tile_h) | targets_plane0(raw)[..., None, None]


def block_entries(fields, modes, tile_idx, tile_counts, tile_h: int, ph: int,
                  pw: int, row0: int = 0):
    """What the kernel's cull leaves of one walk over a (ph, pw) frame at
    band origin row0:
    (entry-block pairs of the tile lists, clear sentinels included, the
    pairs that survive the cull, the blocks that keep at least one entry
    and so read and write their pixels), as ints."""
    whole = torch.tensor([0, fields.shape[0]], dtype=torch.int32,
                         device=fields.device)
    return block_pairs(fields, whole, tile_idx, tile_counts, tile_h, ph, pw,
                       keep=targets_plane0(modes[:, QI_MODE]), row0=row0)


def draw_pass_mega_plain(fields, modes, tile_idx, tile_counts, frame_planes,
                         n_masks: int, tile_h: int = TILE_H, atlas=None,
                         pixelate: bool = False,
                         subpixel_positioning: bool = False,
                         cull: bool = False, row0: int = 0):
    """The plain torch version of draw_pass_mega (same arguments, any
    device, any K); pure: it returns new planes.

    The walk goes by depth, as raster's plain walk does: step k takes the
    k-th entry of every tile whose list is longer than k, with a (T, K, th,
    tw) mask state beside the (T, 4, th, tw) frame. A tile meets one entry
    per step, so the clears, frame blends and mask writes of a step touch
    disjoint tiles.

    cull: walk as the kernel does, each entry (quad or clear sentinel) only
    in the 16x16 blocks where it survives entry_survivors. The CPU tests
    hold it bit-identical to the full walk on tapes whose sentinels carry
    their plane's bbox union."""
    th, tw = tile_h, TILE_W
    _, ph, pw = frame_planes.shape
    tiles_y, tiles_x = ph // th, pw // tw
    dev = frame_planes.device
    kmax = n_masks - 1

    carry = to_tiles(frame_planes, tiles_y, th, tiles_x, tw).clone()
    masks = torch.zeros((carry.shape[0], n_masks, th, tw), dtype=torch.float32,
                        device=dev)
    masks[:, 0] = 1.0
    row0 = int(row0)
    py_t, px_t = pixel_centers(tiles_y, th, tiles_x, tw, dev, row0)
    x0_t, y0_t = tile_origins(tiles_y, th, tiles_x, tw, dev, row0)
    counts = tile_counts.long()

    for k in range(int(counts.max()) if counts.numel() else 0):
        act = torch.nonzero(counts > k).squeeze(1)
        qi = tile_idx[act, k].long()
        raw = modes[qi, QI_MODE]
        tgt = (raw >> MEGA_TARGET_SHIFT) & 0xFFFF  # logical shift of an i32
        clear = (raw & MEGA_CLEAR_BIT) != 0
        keep = None
        if cull:
            keep = entry_survivors(fields[qi][:, QF_BBOX_X0 : QF_BBOX_X0 + 4],
                                   raw, x0_t[act], y0_t[act], th)
            keep = keep.repeat_interleave(BLOCK, 1).repeat_interleave(BLOCK, 2)
        if kmax > 0:
            ct, cp = act[clear], (tgt[clear] - 1).clamp(1, kmax)
            masks[ct, cp] = (torch.where(keep[clear], 0.0, masks[ct, cp])
                             if cull else 0.0)
        draw = ~clear
        dt, qd, tg = act[draw], qi[draw], tgt[draw]
        if dt.numel() == 0:
            continue
        f = fields[qd]

        def fget(c, f=f):
            return f[:, c, None, None]

        fr, fg, fb, fa = eval_quad_planar(
            fget, (raw[draw] & MEGA_EVAL_MASK)[:, None, None], px_t[dt], py_t[dt],
            atlas=atlas, pixelate=pixelate,
            subpixel_positioning=subpixel_positioning)
        fa = fa * masks[dt, modes[qd, QI_MASK].long().clamp(0, kmax)]
        inv = 1.0 - fa
        frame = tg == 0
        ft = dt[frame]
        dst = carry[ft]
        new = torch.stack(
            (fr[frame] * fa[frame] + dst[:, 0] * inv[frame],
             fg[frame] * fa[frame] + dst[:, 1] * inv[frame],
             fb[frame] * fa[frame] + dst[:, 2] * inv[frame],
             fa[frame] + dst[:, 3] * inv[frame]), dim=1)
        carry[ft] = torch.where(keep[draw][frame][:, None], new, dst) if cull else new
        if kmax > 0:
            mt, tk, fm, im = dt[~frame], tg[~frame] - 1, fa[~frame], inv[~frame]
            cur = masks[mt, tk.clamp(0, kmax)]
            new = fm * fm + cur * im
            if cull:
                new = torch.where(keep[draw][~frame], new, masks[mt, tk.clamp(1, kmax)])
            masks[mt, tk.clamp(1, kmax)] = new
    return from_tiles(carry, tiles_y, th, tiles_x, tw)
