"""Tile rasterizer: ordered compositing of binned quads into a
channel-planar frame, or into one mask plane.

`draw_pass_planar_prebinned` (K1, and K1-atlas when given the atlas) and
`draw_pass_mask_prebinned` (K3) run csrc/raster.cu, the hand-written Hopper
(sm_90a) port of figdraw_tpu/ops/raster_pallas.py `_kernel` in its
frame-target form (with and without backdrop planes), its atlas form
(`has_atlas`, here one general in-kernel sampler for atlas modes 0 and
13-16, bilinear or nearest, any uv map) and its mask-target form. CUDA
tensors launch the kernel or raise; CPU tensors take the plain torch
versions (`*_plain`, built on ops/quad_eval_planar.py), which the CPU tests
and the on-card comparison use.

The wrappers update their target in place and return it (the JAX passes
are pure); the plain versions stay pure and return new planes, and the
wrappers' CPU branch copies their result into the target. The kernel culls
each 16x16 block's quads by bbox (`block_survivors` states the rule in
plain torch; `_segment_walk(..., cull=True)` composites with it).

Every entry point takes `row0`, the band origin of the TPU kernel
(seg_ref[2], raster_pallas.py:161-184): the global row of the target's row
0. It is 0 for a whole frame; a frame split into row bands over several
devices (parallel/sharding.py) draws each band at its own origin, so pixel
centers and the cull are global while the planes are the band's.

The kernel library is compiled with nvcc at first use (ops/nvcc.py) and
bound with ctypes through plain C entry points.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import nvcc
from .layout import QF_BBOX_X0, QF_WIDTH, QI_MASK, QI_MODE, QI_WIDTH
from .quad_eval_planar import eval_quad_planar

TILE_H = 128  # tile rows (64 or 32 when dense: plan.tile_h_from_density)
TILE_W = 128
BLOCK = 16  # the kernels' square pixel block; tiles are multiples of it
# widening of a quad's bbox, in pixels, in the kernel's per-block cull: the
# bbox's float rounding and the evaluator's 1e-6 uv guard stay inside it
CULL_MARGIN = 1.0

# kernel launches since the count was last reset: K1 (frame target, no
# atlas), K1-atlas (frame target with the atlas) and K3 (mask target, with
# or without the atlas)
LAUNCHES = 0
ATLAS_LAUNCHES = 0
MASK_LAUNCHES = 0
# of those, the launches at a band origin other than 0 (row0 != 0)
BAND_LAUNCHES = 0
BAND_ATLAS_LAUNCHES = 0
BAND_MASK_LAUNCHES = 0

_SOURCES = ("raster.cu", "cull.cuh", "sdf.cuh")

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""  # nvcc's output of the build this process loaded (ptxas -v)


def load() -> ctypes.CDLL:
    """The kernel library, built and bound at first use."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is None:
            path, BUILD_LOG = nvcc.build("figdraw_raster", _SOURCES)
            lib = ctypes.CDLL(path)
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.figdraw_raster_frame.argtypes = [vp] * 9 + [i] * 10 + [vp]
            lib.figdraw_raster_frame.restype = i
            lib.figdraw_raster_mask.argtypes = [vp] * 8 + [i] * 10 + [vp]
            lib.figdraw_raster_mask.restype = i
            _lib = lib
        return _lib


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the frame on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_tiles(fields, modes, tile_idx, tile_counts, target, n_planes: int,
                tile_h: int, atlas=None) -> None:
    """Checks shared by the tile kernels' wrappers: the (N, 68) / (N, 2)
    tape and its alignment, its (T, N) / (T,) binning, an (n_planes, PH, PW)
    target that tiles by (tile_h, TILE_W), and the (S, S, 4) atlas when
    given. Raises ValueError."""
    dev = target.device
    _check(target, "target planes", torch.float32, 3, dev)
    _check(fields, "fields", torch.float32, 2, dev)
    _check(modes, "modes", torch.int32, 2, dev)
    _check(tile_idx, "tile_idx", torch.int32, 2, dev)
    _check(tile_counts, "tile_counts", torch.int32, 1, dev)
    planes, ph, pw = target.shape
    n = fields.shape[0]
    if planes != n_planes or tile_h % BLOCK or ph % tile_h or pw % TILE_W:
        raise ValueError(f"target planes {tuple(target.shape)} must be "
                         f"({n_planes}, PH, PW) tiled by ({tile_h}, {TILE_W})")
    tiles = (ph // tile_h) * (pw // TILE_W)
    if fields.shape[1] != QF_WIDTH or tuple(modes.shape) != (n, QI_WIDTH):
        raise ValueError("fields must be (N, 68) and modes (N, 2)")
    if tuple(tile_idx.shape) != (tiles, n) or tuple(tile_counts.shape) != (tiles,):
        raise ValueError(f"tile lists must be ({tiles}, {n}) and ({tiles},)")
    # the kernels stage quad rows in 16-byte pieces and read mode pairs as
    # 8-byte words
    if fields.data_ptr() % 16 or modes.data_ptr() % 8:
        raise ValueError("fields must be 16-byte and modes 8-byte aligned")
    if atlas is not None:
        _check(atlas, "atlas", torch.float32, 3, dev)
        if atlas.shape[0] != atlas.shape[1] or atlas.shape[2] != 4:
            raise ValueError(f"atlas must be (S, S, 4), got {tuple(atlas.shape)}")


def _check_args(fields, modes, bounds, tile_idx, tile_counts, target, masks,
                backdrop_planes, atlas, tile_h, n_planes):
    dev = target.device
    check_tiles(fields, modes, tile_idx, tile_counts, target, n_planes, tile_h,
                atlas)
    _check(bounds, "bounds", torch.int32, 1, dev)
    _check(masks, "masks", torch.float32, 3, dev)
    if bounds.shape[0] != 2:
        raise ValueError("bounds must be the run's [start, end)")
    if masks.shape[1:] != target.shape[1:] or masks.shape[0] < 1:
        raise ValueError("masks must be (K >= 1, PH, PW)")
    if backdrop_planes is not None:
        _check(backdrop_planes, "backdrop_planes", torch.float32, 3, dev)
        if backdrop_planes.shape != target.shape:
            raise ValueError("backdrop_planes must match frame_planes")


def _launch(entry, fields, modes, bounds, tile_idx, tile_counts, target,
            masks, backdrop_planes, atlas, pixelate, subpixel_positioning,
            tile_h, row0):
    """Launch one of the library's tile entry points on the target's
    current stream; the kernel updates the target in place."""
    lib = load()
    _, ph, pw = target.shape
    stream = torch.cuda.current_stream(target.device).cuda_stream
    ptrs = [fields.data_ptr(), modes.data_ptr(), tile_idx.data_ptr(),
            tile_counts.data_ptr(), bounds.data_ptr(), target.data_ptr(),
            masks.data_ptr()]
    if entry == "figdraw_raster_frame":
        ptrs.append(backdrop_planes.data_ptr()
                    if backdrop_planes is not None else None)
    ptrs.append(atlas.data_ptr() if atlas is not None else None)
    rc = getattr(lib, entry)(*ptrs, fields.shape[0],
                             pw // TILE_W, tile_h, TILE_W, ph, pw, int(row0),
                             atlas.shape[0] if atlas is not None else 0,
                             int(pixelate), int(subpixel_positioning), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")


def _no_kernel(device) -> None:
    if device.type != "cuda":
        raise ValueError(f"no raster kernel for {device}")


def check_row0(row0, ph: int) -> int:
    """A band origin as an int: a whole number in [0, 2^24 - ph], so that
    every global pixel center of the band is exact in f32. Raises
    ValueError."""
    r = int(row0)
    if r != row0 or r < 0 or r + ph > 1 << 24:
        raise ValueError(f"band origin {row0!r} must be an int in [0, 2^24 - {ph}]")
    return r


def draw_pass_planar_prebinned(fields, modes, bounds, tile_idx, tile_counts,
                               frame_planes, masks, backdrop_planes=None,
                               tile_h: int = TILE_H, atlas=None,
                               pixelate: bool = False,
                               subpixel_positioning: bool = False,
                               row0: int = 0):
    """Composite the run's quads [bounds[0], bounds[1]) over frame_planes
    (kernel K1, or K1-atlas with an atlas).

    fields (N, 68) f32 and modes (N, 2) i32: the unpacked tape; bounds: (2,)
    i32 [start, end); tile_idx (T, N) i32 / tile_counts (T,) i32: the
    binning of the whole tape (each tile's list ascending, so the run is one
    contiguous segment of it); frame_planes (4, PH, PW) f32, updated in
    place; masks (K, PH, PW) f32, read at each quad's mask index, masks[0]
    all ones (the kernel does not read it); backdrop_planes (4, PH, PW) f32
    or None, sampled by mode-17 quads; atlas (S, S, 4) f32 or None, sampled
    by atlas-mode quads (0, 13-16), nearest when pixelate, mode 0's u
    shifted by the quad's subpixel shift when subpixel_positioning; row0:
    the band origin, the global row of the planes' row 0 (the binning's
    too). Returns frame_planes.
    """
    row0 = check_row0(row0, frame_planes.shape[1])
    if frame_planes.device.type == "cpu":
        return frame_planes.copy_(draw_pass_planar_prebinned_plain(
            fields, modes, bounds, tile_idx, tile_counts, frame_planes, masks,
            backdrop_planes, tile_h, atlas, pixelate, subpixel_positioning,
            row0))
    _no_kernel(frame_planes.device)
    _check_args(fields, modes, bounds, tile_idx, tile_counts, frame_planes,
                masks, backdrop_planes, atlas, tile_h, 4)
    _launch("figdraw_raster_frame", fields, modes, bounds, tile_idx,
            tile_counts, frame_planes, masks, backdrop_planes, atlas, pixelate,
            subpixel_positioning, tile_h, row0)
    global LAUNCHES, ATLAS_LAUNCHES, BAND_LAUNCHES, BAND_ATLAS_LAUNCHES
    if atlas is None:
        LAUNCHES += 1
        BAND_LAUNCHES += row0 != 0
    else:
        ATLAS_LAUNCHES += 1
        BAND_ATLAS_LAUNCHES += row0 != 0
    return frame_planes


def draw_pass_mask_prebinned(fields, modes, bounds, tile_idx, tile_counts,
                             mask_plane, masks, tile_h: int = TILE_H,
                             atlas=None, pixelate: bool = False,
                             subpixel_positioning: bool = False,
                             row0: int = 0):
    """Write the run's quads [bounds[0], bounds[1]) into one mask plane
    (kernel K3; raster_pallas.draw_pass_mask_prebinned): per quad,
    fa = alpha * masks[mask_i] and m = fa*fa + m*(1 - fa), the GL blend of
    glsl/mask.frag.

    mask_plane (1, PH, PW) f32: the target plane, updated in place; it may
    be a view of one of the planes of masks (masks[p : p + 1]); masks (K,
    PH, PW) f32: every plane, read at each quad's mask index as it was
    before the pass, masks[0] all ones. The other arguments are
    draw_pass_planar_prebinned's. Returns mask_plane."""
    row0 = check_row0(row0, mask_plane.shape[1])
    if mask_plane.device.type == "cpu":
        return mask_plane.copy_(draw_pass_mask_prebinned_plain(
            fields, modes, bounds, tile_idx, tile_counts, mask_plane, masks,
            tile_h, atlas, pixelate, subpixel_positioning, row0))
    _no_kernel(mask_plane.device)
    _check_args(fields, modes, bounds, tile_idx, tile_counts, mask_plane,
                masks, None, atlas, tile_h, 1)
    _launch("figdraw_raster_mask", fields, modes, bounds, tile_idx,
            tile_counts, mask_plane, masks, None, atlas, pixelate,
            subpixel_positioning, tile_h, row0)
    global MASK_LAUNCHES, BAND_MASK_LAUNCHES
    MASK_LAUNCHES += 1
    BAND_MASK_LAUNCHES += row0 != 0
    return mask_plane


def to_tiles(planes, tiles_y, th, tiles_x, tw):
    """(C, PH, PW) -> (T, C, th, tw), tiles in row-major order."""
    c = planes.shape[0]
    return (planes.reshape(c, tiles_y, th, tiles_x, tw)
            .permute(1, 3, 0, 2, 4).reshape(tiles_y * tiles_x, c, th, tw))


def from_tiles(tiles, tiles_y, th, tiles_x, tw):
    c = tiles.shape[1]
    return (tiles.reshape(tiles_y, tiles_x, c, th, tw)
            .permute(2, 0, 3, 1, 4).reshape(c, tiles_y * th, tiles_x * tw))


def pixel_centers(tiles_y, th, tiles_x, tw, device, row0: int = 0):
    """Per-tile pixel-center grids ((T, th, 1) py, (T, 1, tw) px): (global
    tile origin + index) + 0.5, as the kernels compute them; row0: the band
    origin."""
    iy = torch.arange(th, dtype=torch.float32, device=device)[:, None]
    ix = torch.arange(tw, dtype=torch.float32, device=device)[None, :]
    ty = torch.arange(tiles_y, device=device).repeat_interleave(tiles_x)
    tx = torch.arange(tiles_x, device=device).repeat(tiles_y)
    y0 = (row0 + ty * th).to(torch.float32)[:, None, None]
    x0 = (tx * tw).to(torch.float32)[:, None, None]
    return y0 + iy + 0.5, x0 + ix + 0.5


def tile_origins(tiles_y, th, tiles_x, tw, device, row0: int = 0):
    """Each tile's first pixel ((T,) x0, (T,) y0) as int64, row-major, y0
    global (row0: the band origin)."""
    t = torch.arange(tiles_y * tiles_x, device=device)
    return (t % tiles_x) * tw, row0 + (t // tiles_x) * th


def run_segments(bounds, tile_idx, tile_counts):
    """Each tile's run segment [j_lo, j_hi) of its ascending list: the
    positions of the first entries >= bounds[0] and >= bounds[1] ((T,)
    int64 each)."""
    n = tile_idx.shape[1]
    pos = torch.arange(n, device=tile_idx.device)
    live = pos[None, :] < tile_counts[:, None].long()
    lists = torch.where(live, tile_idx.long(), torch.iinfo(torch.int64).max)
    seg = bounds.long().reshape(2, 1, 1).expand(2, lists.shape[0], 1)
    j_lo = torch.searchsorted(lists, seg[0].contiguous()).squeeze(1)
    j_hi = torch.searchsorted(lists, seg[1].contiguous()).squeeze(1)
    return j_lo, j_hi


def block_survivors(bbox, x0, y0, tile_h: int):
    """The kernel's per-block cull in plain torch: (..., tile_h // 16,
    TILE_W // 16) bool, whether a quad with bbox (..., 4) f32 (x0, y0, x1,
    y1), widened by CULL_MARGIN, reaches the pixel centers of each 16x16
    block of the tile whose first pixel is (x0, y0) ((...) int tensors).
    Computed in f32, as the kernel computes it."""
    bx = torch.arange(0, TILE_W, BLOCK, device=bbox.device)
    by = torch.arange(0, tile_h, BLOCK, device=bbox.device)
    cx0 = (x0[..., None] + bx).to(torch.float32) + 0.5
    cy0 = (y0[..., None] + by).to(torch.float32) + 0.5
    cx1, cy1 = cx0 + 15.0, cy0 + 15.0  # the block's last centers, exact
    hit_x = ((bbox[..., 0:1] - CULL_MARGIN <= cx1)
             & (bbox[..., 2:3] + CULL_MARGIN >= cx0))
    hit_y = ((bbox[..., 1:2] - CULL_MARGIN <= cy1)
             & (bbox[..., 3:4] + CULL_MARGIN >= cy0))
    return hit_y[..., :, None] & hit_x[..., None, :]


def ambiguous_pixels(fields, modes, ys, xs):
    """Whether each pixel (ys, xs) (int arrays) is one where two correct
    evaluations of the tape may differ by a whole pixel's coverage of a
    quad, for a quad of `fields` / `modes` ((N, 68) f32 and (N, 2) i32
    numpy rows) whose bbox holds the pixel center, computed in float64:

    - a uv clip edge: u or v within 4 ulps of its two products of a bound
      of the inside test (-1e-6 and 1 + 1e-6). There the clip turns on how
      u = inv_a dx + inv_b dy rounds, and a fused multiply-add (nvcc
      contracts one, as XLA does) and ATen's separate multiply and add fall
      on either side;
    - a bezier stroke's evolute (modes 18-20): the cubic solve's p = ky -
      kx^2 within 1% of kx^2, where it cancels and one ulp of kx moves the
      root (tests/test_torch_sdf_eval.py holds the evaluators there to the
      frame bound).

    Checks use it to tell such pixels from a fault: they are few, in frames
    of rotated or curved strokes."""
    import numpy as np

    from .layout import (
        QF_BBOX_X1, QF_BBOX_Y0, QF_BBOX_Y1, QF_INV_A, QF_INV_B, QF_INV_C,
        QF_INV_D, QF_ORG_X, QF_ORG_Y, QF_PARAMS, QF_RADII,
    )

    f = np.asarray(fields, np.float64)
    base = (np.asarray(modes)[:, QI_MODE] % 256) % 128
    out = np.zeros(len(ys), bool)
    for k, (y, x) in enumerate(zip(ys, xs)):
        px, py = float(x) + 0.5, float(y) + 0.5
        hold = ((f[:, QF_BBOX_X0] <= px) & (f[:, QF_BBOX_X1] >= px)
                & (f[:, QF_BBOX_Y0] <= py) & (f[:, QF_BBOX_Y1] >= py))
        g, gb = f[hold], base[hold]
        rx = (np.float32(px) - g[:, QF_ORG_X].astype(np.float32)).astype(np.float64)
        ry = (np.float32(py) - g[:, QF_ORG_Y].astype(np.float32)).astype(np.float64)
        uv = []
        for a, b in ((QF_INV_A, QF_INV_B), (QF_INV_C, QF_INV_D)):
            t1, t2 = g[:, a] * rx, g[:, b] * ry
            band = 4.0 * 2.0 ** -24 * (np.abs(t1) + np.abs(t2)) + 2.0 ** -30
            w = t1 + t2
            uv.append(w)
            if ((np.abs(w + 1e-6) <= band) | (np.abs(w - (1.0 + 1e-6)) <= band)).any():
                out[k] = True
        if out[k]:
            continue
        u, v = uv
        posx = (u - 0.5) * 2.0 * g[:, QF_PARAMS]
        posy = (v - 0.5) * 2.0 * g[:, QF_PARAMS + 1]
        ax, ay = g[:, QF_PARAMS + 2], g[:, QF_PARAMS + 3]
        bx, by, cx, cy = (g[:, QF_RADII + i] for i in range(4))
        abx, aby = bx - ax, by - ay
        bbx, bby = ax - 2.0 * bx + cx, ay - 2.0 * by + cy
        kk = 1.0 / np.maximum(bbx * bbx + bby * bby, 1e-6)
        kx = kk * (abx * bbx + aby * bby)
        ky = kk * (2.0 * (abx * abx + aby * aby) + ((ax - posx) * bbx
                                                    + (ay - posy) * bby)) / 3.0
        ill = np.abs(ky - kx * kx) < 0.01 * kx * kx
        out[k] = bool((ill & (gb >= 18) & (gb <= 20)).any())
    return out


def block_pairs(fields, bounds, tile_idx, tile_counts, tile_h: int, ph: int,
                pw: int, keep=None, row0: int = 0):
    """What the kernel's cull leaves of one pass over a (ph, pw) target at
    band origin row0: (quad-block pairs of the run segments, the pairs that
    survive the cull, the blocks that keep at least one quad and so read and
    write their pixels), as ints. keep: (N,) bool, quads that survive
    whatever their bbox (the megakernel's plane-0 targets), or None."""
    j_lo, j_hi = run_segments(bounds, tile_idx, tile_counts)
    depth = j_hi - j_lo
    per_tile = (tile_h // BLOCK) * (TILE_W // BLOCK)
    before = int(depth.sum()) * per_tile
    d = int(depth.max()) if depth.numel() else 0
    if d == 0:
        return before, 0, 0
    k = torch.arange(d, device=depth.device)
    valid = k[None, :] < depth[:, None]
    pos = (j_lo[:, None] + k).clamp(max=tile_idx.shape[1] - 1)
    q = tile_idx.gather(1, pos).long()
    x0, y0 = tile_origins(ph // tile_h, tile_h, pw // TILE_W, TILE_W, depth.device,
                          row0)
    surv = block_survivors(fields[q][..., QF_BBOX_X0 : QF_BBOX_X0 + 4],
                           x0[:, None].expand_as(q), y0[:, None].expand_as(q),
                           tile_h)
    if keep is not None:
        surv = surv | keep[q][:, :, None, None]
    surv = surv & valid[:, :, None, None]
    return before, int(surv.sum()), int(surv.any(dim=1).sum())


def _segment_walk(fields, modes, bounds, tile_idx, tile_counts, target, masks,
                  backdrop_planes, tile_h, mask_target: bool, atlas=None,
                  pixelate: bool = False, subpixel_positioning: bool = False,
                  cull: bool = False, row0: int = 0):
    """The plain walk behind both *_plain versions, at band origin row0. Each tile walks its run
    segment in draw order. The walk goes by depth: step k evaluates the
    k-th quad of every tile whose segment is longer than k, in one batched
    eval_quad_planar call over those tiles' pixels, and blends it over them,
    so every pixel sees its tile's quads in the same order as the kernel.

    cull: composite as the kernel does, each quad only in the 16x16 blocks
    where it survives block_survivors, and the mask plane multiplied in only
    where the fragment has alpha and the plane is not 0. The CPU tests hold
    it bit-identical to the full walk."""
    th, tw = tile_h, TILE_W
    _, ph, pw = target.shape
    tiles_y, tiles_x = ph // th, pw // tw
    dev = target.device

    j_lo, j_hi = run_segments(bounds, tile_idx, tile_counts)
    depth = j_hi - j_lo

    carry = to_tiles(target, tiles_y, th, tiles_x, tw).clone()
    mask_t = to_tiles(masks, tiles_y, th, tiles_x, tw)
    bd_t = (None if backdrop_planes is None
            else to_tiles(backdrop_planes, tiles_y, th, tiles_x, tw))
    py_t, px_t = pixel_centers(tiles_y, th, tiles_x, tw, dev, row0)
    x0_t, y0_t = tile_origins(tiles_y, th, tiles_x, tw, dev, row0)

    for k in range(int(depth.max()) if depth.numel() else 0):
        act = torch.nonzero(depth > k).squeeze(1)
        qi = tile_idx[act, j_lo[act] + k].long()
        f = fields[qi]
        m = modes[qi]

        def fget(c, f=f):
            return f[:, c, None, None]

        bd = None
        if bd_t is not None:
            b = bd_t[act]
            bd = (b[:, 0], b[:, 1], b[:, 2], b[:, 3])
        fr, fg, fb, fa = eval_quad_planar(
            fget, m[:, QI_MODE, None, None], px_t[act], py_t[act],
            backdrop_planes=bd, atlas=atlas, pixelate=pixelate,
            subpixel_positioning=subpixel_positioning,
        )
        mi = m[:, QI_MASK].long()
        if cull:
            reads = (fa != 0.0) & (mi != 0)[:, None, None]
            fa = torch.where(reads, fa * mask_t[act, mi], fa)
            keep = block_survivors(f[:, QF_BBOX_X0 : QF_BBOX_X0 + 4], x0_t[act],
                                   y0_t[act], th)
            keep = keep.repeat_interleave(BLOCK, 1).repeat_interleave(BLOCK, 2)
        else:
            fa = fa * mask_t[act, mi]
        dst = carry[act]
        if mask_target:
            new = (fa * fa + dst[:, 0] * (1.0 - fa))[:, None]
        else:
            inv = 1.0 - fa
            new = torch.stack(
                (fr * fa + dst[:, 0] * inv, fg * fa + dst[:, 1] * inv,
                 fb * fa + dst[:, 2] * inv, fa + dst[:, 3] * inv), dim=1)
        carry[act] = torch.where(keep[:, None], new, dst) if cull else new
    return from_tiles(carry, tiles_y, th, tiles_x, tw)


def draw_pass_planar_prebinned_plain(fields, modes, bounds, tile_idx,
                                     tile_counts, frame_planes, masks,
                                     backdrop_planes=None,
                                     tile_h: int = TILE_H, atlas=None,
                                     pixelate: bool = False,
                                     subpixel_positioning: bool = False,
                                     row0: int = 0):
    """The plain torch version of draw_pass_planar_prebinned (same
    arguments and result, any device)."""
    return _segment_walk(fields, modes, bounds, tile_idx, tile_counts,
                         frame_planes, masks, backdrop_planes, tile_h, False,
                         atlas, pixelate, subpixel_positioning, row0=int(row0))


def draw_pass_mask_prebinned_plain(fields, modes, bounds, tile_idx,
                                   tile_counts, mask_plane, masks,
                                   tile_h: int = TILE_H, atlas=None,
                                   pixelate: bool = False,
                                   subpixel_positioning: bool = False,
                                   row0: int = 0):
    """The plain torch version of draw_pass_mask_prebinned (same arguments
    and result, any device)."""
    return _segment_walk(fields, modes, bounds, tile_idx, tile_counts,
                         mask_plane, masks, None, tile_h, True, atlas,
                         pixelate, subpixel_positioning, row0=int(row0))
