"""Megakernel: a whole clip-masked frame in one tile walk (kernel K4).

`draw_pass_mega` runs csrc/mega.cu, the hand-written Hopper (sm_90a) port of
figdraw_tpu/ops/raster_pallas.py `_mega_kernel` (reached there through
`draw_pass_mega`, :643). Each quad's target (the frame or mask plane k) and
the mask clears ride in the mode lane (plan.pack_mega_modes, or the walk's
own mega export), so one kernel walks each tile's binned list once, in tape
order, holding the K mask planes on chip. The tape is binned first, with no
culling (ops.binning.bin_quads without modes, as raster_pallas.prebin).

CUDA tensors launch the kernel or raise; CPU tensors take
`draw_pass_mega_plain`, the plain torch version the CPU tests and the
on-card comparison use.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import nvcc
from .layout import QI_MASK, QI_MODE
from .quad_eval_planar import eval_quad_planar
from .raster import TILE_H, TILE_W, check_tiles, from_tiles, pixel_centers, to_tiles

# mode-lane packing (raster_pallas.py:481-492)
MEGA_CLEAR_BIT = 1 << 12  # clear sentinel: zero plane target - 1
MEGA_TARGET_SHIFT = 16  # bits 16+: target + 1 (0 = frame, k + 1 = plane k)
MEGA_EVAL_MASK = 0x2FFF  # the bits passed to the evaluator
# the kernel keeps K planes per 256-pixel block in shared memory, 1 KB each;
# 200 leave room under the 227 KB a block may use (csrc/mega.cu MAX_PLANES)
MAX_PLANES = 200

LAUNCHES = 0  # kernel launches since the count was last reset

_SOURCES = ("mega.cu", "sdf.cuh")

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
            lib.figdraw_mega.argtypes = [vp] * 6 + [i] * 7 + [vp]
            lib.figdraw_mega.restype = i
            _lib = lib
        return _lib


def draw_pass_mega(fields, modes, tile_idx, tile_counts, frame_planes,
                   n_masks: int, tile_h: int = TILE_H):
    """The whole frame over target-baked rows (kernel K4).

    fields (N, 68) f32 and modes (N, 2) i32: the unpacked mega rows, clear
    sentinels included; tile_idx (T, N) i32 / tile_counts (T,) i32: their
    binning without culling; frame_planes (4, PH, PW) f32, the frame before
    the walk; n_masks: K, the mask planes the walk keeps (plane 0 is the
    all-pass parent). Returns the new (4, PH, PW) planes. On CUDA, K is at
    most MAX_PLANES (ValueError past it)."""
    if frame_planes.device.type == "cpu":
        return draw_pass_mega_plain(fields, modes, tile_idx, tile_counts,
                                    frame_planes, n_masks, tile_h)
    if frame_planes.device.type != "cuda":
        raise ValueError(f"no megakernel for {frame_planes.device}")
    if not 1 <= n_masks <= MAX_PLANES:
        raise ValueError(f"the megakernel keeps 1 to MAX_PLANES = {MAX_PLANES} "
                         f"mask planes in shared memory, got {n_masks}")
    check_tiles(fields, modes, tile_idx, tile_counts, frame_planes, 4, tile_h)
    lib = load()
    _, ph, pw = frame_planes.shape
    out = torch.empty_like(frame_planes)
    stream = torch.cuda.current_stream(frame_planes.device).cuda_stream
    rc = lib.figdraw_mega(
        fields.data_ptr(), modes.data_ptr(), tile_idx.data_ptr(),
        tile_counts.data_ptr(), frame_planes.data_ptr(), out.data_ptr(),
        fields.shape[0], pw // TILE_W, tile_h, TILE_W, ph, pw, n_masks, stream)
    if rc != 0:
        raise RuntimeError(f"megakernel launch failed: cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def draw_pass_mega_plain(fields, modes, tile_idx, tile_counts, frame_planes,
                         n_masks: int, tile_h: int = TILE_H):
    """The plain torch version of draw_pass_mega (same arguments and result,
    any device, any K).

    The walk goes by depth, as raster's plain walk does: step k takes the
    k-th quad of every tile whose list is longer than k, with a (T, K, th,
    tw) mask state beside the (T, 4, th, tw) frame. A tile meets one quad
    per step, so the clears, frame blends and mask writes of a step touch
    disjoint tiles."""
    th, tw = tile_h, TILE_W
    _, ph, pw = frame_planes.shape
    tiles_y, tiles_x = ph // th, pw // tw
    dev = frame_planes.device
    kmax = n_masks - 1

    carry = to_tiles(frame_planes, tiles_y, th, tiles_x, tw).clone()
    masks = torch.zeros((carry.shape[0], n_masks, th, tw), dtype=torch.float32,
                        device=dev)
    masks[:, 0] = 1.0
    py_t, px_t = pixel_centers(tiles_y, th, tiles_x, tw, dev)
    counts = tile_counts.long()

    for k in range(int(counts.max()) if counts.numel() else 0):
        act = torch.nonzero(counts > k).squeeze(1)
        qi = tile_idx[act, k].long()
        raw = modes[qi, QI_MODE]
        tgt = (raw >> MEGA_TARGET_SHIFT) & 0xFFFF  # logical shift of an i32
        clear = (raw & MEGA_CLEAR_BIT) != 0
        if kmax > 0:
            ct = act[clear]
            masks[ct, (tgt[clear] - 1).clamp(1, kmax)] = 0.0
        draw = ~clear
        dt, qd, tg = act[draw], qi[draw], tgt[draw]
        if dt.numel() == 0:
            continue
        f = fields[qd]

        def fget(c, f=f):
            return f[:, c, None, None]

        fr, fg, fb, fa = eval_quad_planar(
            fget, (raw[draw] & MEGA_EVAL_MASK)[:, None, None], px_t[dt], py_t[dt])
        fa = fa * masks[dt, modes[qd, QI_MASK].long().clamp(0, kmax)]
        inv = 1.0 - fa
        frame = tg == 0
        ft = dt[frame]
        dst = carry[ft]
        carry[ft] = torch.stack(
            (fr[frame] * fa[frame] + dst[:, 0] * inv[frame],
             fg[frame] * fa[frame] + dst[:, 1] * inv[frame],
             fb[frame] * fa[frame] + dst[:, 2] * inv[frame],
             fa[frame] + dst[:, 3] * inv[frame]), dim=1)
        if kmax > 0:
            mt, tk, fm, im = dt[~frame], tg[~frame] - 1, fa[~frame], inv[~frame]
            cur = masks[mt, tk.clamp(0, kmax)]
            masks[mt, tk.clamp(1, kmax)] = fm * fm + cur * im
    return from_tiles(carry, tiles_y, th, tiles_x, tw)
