"""Tile rasterizer: ordered source-over compositing of binned SDF quads into
a channel-planar frame.

`draw_pass_planar_prebinned` runs csrc/raster.cu, the hand-written Hopper
(sm_90a) port of figdraw_tpu/ops/raster_pallas.py `_kernel` in its frame
target form (with and without backdrop planes). CUDA tensors launch the
kernel or raise; CPU tensors take `draw_pass_planar_prebinned_plain`, the
plain torch version built on ops/quad_eval_planar.py, which the CPU tests and
the on-card comparison use.

The kernel library is compiled with nvcc at first use, from this package's
sources only, into `_build/` keyed by a hash of the sources and flags, and
bound with ctypes through a plain C entry point.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from .layout import QF_WIDTH, QI_MASK, QI_MODE, QI_WIDTH
from .quad_eval_planar import eval_quad_planar

TILE_H = 128  # tile rows (64 or 32 when dense: plan.tile_h_from_density)
TILE_W = 128
BLOCK = 16  # the kernel's square pixel block; tiles are multiples of it

LAUNCHES = 0  # kernel launches since the count was last reset

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_SOURCES = ("raster.cu", "sdf.cuh")
BUILD_DIR = os.path.join(os.path.dirname(_CSRC), "_build")
# no --use_fast_math: expf in the shadow profile and IEEE sqrt/division
# keep the kernel within rounding of the plain version
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""  # nvcc's output of the build this process loaded (ptxas -v)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # torch's toolkit lookup

    path = shutil.which("nvcc")
    if path is None and CUDA_HOME is not None:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the raster kernel needs the CUDA toolkit")
    return path


def build() -> tuple:
    """Compile csrc/raster.cu into BUILD_DIR (once per source and flag hash).
    Returns (library path, compiler output). Raises CalledProcessError with
    nvcc's output when the build fails."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as fh:
            digest.update(fh.read())
    path = os.path.join(BUILD_DIR, f"libfigdraw_raster_{digest.hexdigest()[:16]}.so")
    log_path = path + ".log"
    if os.path.exists(path):
        with open(log_path) as fh:
            return path, fh.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, "raster.cu")],
            check=True, capture_output=True, text=True,
        )
        with open(log_path, "w") as fh:
            fh.write(res.stdout + res.stderr)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, res.stdout + res.stderr


def load() -> ctypes.CDLL:
    """The kernel library, built and bound at first use."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is None:
            path, BUILD_LOG = build()
            lib = ctypes.CDLL(path)
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.figdraw_raster_frame.argtypes = [vp] * 9 + [i] * 6 + [vp]
            lib.figdraw_raster_frame.restype = i
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


def _check_args(fields, modes, bounds, tile_idx, tile_counts, frame_planes,
                masks, backdrop_planes, tile_h):
    dev = frame_planes.device
    _check(frame_planes, "frame_planes", torch.float32, 3, dev)
    _check(fields, "fields", torch.float32, 2, dev)
    _check(modes, "modes", torch.int32, 2, dev)
    _check(bounds, "bounds", torch.int32, 1, dev)
    _check(tile_idx, "tile_idx", torch.int32, 2, dev)
    _check(tile_counts, "tile_counts", torch.int32, 1, dev)
    _check(masks, "masks", torch.float32, 3, dev)
    planes, ph, pw = frame_planes.shape
    n = fields.shape[0]
    tiles = (ph // tile_h) * (pw // TILE_W)
    if planes != 4 or ph % tile_h or pw % TILE_W or tile_h % BLOCK:
        raise ValueError(f"frame_planes {tuple(frame_planes.shape)} does not "
                         f"tile by ({tile_h}, {TILE_W})")
    if fields.shape[1] != QF_WIDTH or tuple(modes.shape) != (n, QI_WIDTH):
        raise ValueError("fields must be (N, 68) and modes (N, 2)")
    if tuple(tile_idx.shape) != (tiles, n) or tuple(tile_counts.shape) != (tiles,):
        raise ValueError(f"tile lists must be ({tiles}, {n}) and ({tiles},)")
    if bounds.shape[0] != 2:
        raise ValueError("bounds must be the run's [start, end)")
    if masks.shape[1:] != frame_planes.shape[1:] or masks.shape[0] < 1:
        raise ValueError("masks must be (K >= 1, PH, PW)")
    if backdrop_planes is not None:
        _check(backdrop_planes, "backdrop_planes", torch.float32, 3, dev)
        if backdrop_planes.shape != frame_planes.shape:
            raise ValueError("backdrop_planes must match frame_planes")


def draw_pass_planar_prebinned(fields, modes, bounds, tile_idx, tile_counts,
                               frame_planes, masks, backdrop_planes=None,
                               tile_h: int = TILE_H):
    """Composite the run's quads [bounds[0], bounds[1]) over frame_planes.

    fields (N, 68) f32 and modes (N, 2) i32: the unpacked tape; bounds: (2,)
    i32 [start, end); tile_idx (T, N) i32 / tile_counts (T,) i32: the
    binning of the whole tape (each tile's list ascending, so the run is one
    contiguous segment of it); frame_planes (4, PH, PW) f32; masks (K, PH,
    PW) f32, read at each quad's mask index; backdrop_planes (4, PH, PW) f32
    or None, sampled by mode-17 quads. Returns the new (4, PH, PW) planes.
    """
    if frame_planes.device.type == "cpu":
        return draw_pass_planar_prebinned_plain(
            fields, modes, bounds, tile_idx, tile_counts, frame_planes, masks,
            backdrop_planes, tile_h)
    if frame_planes.device.type != "cuda":
        raise ValueError(f"no raster kernel for {frame_planes.device}")
    _check_args(fields, modes, bounds, tile_idx, tile_counts, frame_planes,
                masks, backdrop_planes, tile_h)
    lib = load()
    _, ph, pw = frame_planes.shape
    out = torch.empty_like(frame_planes)
    stream = torch.cuda.current_stream(frame_planes.device).cuda_stream
    rc = lib.figdraw_raster_frame(
        fields.data_ptr(), modes.data_ptr(), tile_idx.data_ptr(),
        tile_counts.data_ptr(), bounds.data_ptr(), frame_planes.data_ptr(),
        masks.data_ptr(),
        backdrop_planes.data_ptr() if backdrop_planes is not None else None,
        out.data_ptr(), fields.shape[0], pw // TILE_W, tile_h, TILE_W, ph, pw,
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"raster kernel launch failed: cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _to_tiles(planes, tiles_y, th, tiles_x, tw):
    """(C, PH, PW) -> (T, C, th, tw), tiles in row-major order."""
    c = planes.shape[0]
    return (planes.reshape(c, tiles_y, th, tiles_x, tw)
            .permute(1, 3, 0, 2, 4).reshape(tiles_y * tiles_x, c, th, tw))


def _from_tiles(tiles, tiles_y, th, tiles_x, tw):
    c = tiles.shape[1]
    return (tiles.reshape(tiles_y, tiles_x, c, th, tw)
            .permute(2, 0, 3, 1, 4).reshape(c, tiles_y * th, tiles_x * tw))


def draw_pass_planar_prebinned_plain(fields, modes, bounds, tile_idx,
                                     tile_counts, frame_planes, masks,
                                     backdrop_planes=None,
                                     tile_h: int = TILE_H):
    """The plain torch version of draw_pass_planar_prebinned (same
    arguments and result, any device).

    Each tile walks its run segment in draw order. The walk goes by depth:
    step k evaluates the k-th quad of every tile whose segment is longer than
    k, in one batched eval_quad_planar call over those tiles' pixels, and
    blends it over them — so every pixel sees its tile's quads in the same
    order as the kernel."""
    th, tw = tile_h, TILE_W
    _, ph, pw = frame_planes.shape
    tiles_y, tiles_x = ph // th, pw // tw
    dev = frame_planes.device
    n = fields.shape[0]

    # each tile's run segment [j_lo, j_hi) of its ascending list
    pos = torch.arange(n, device=dev)
    live = pos[None, :] < tile_counts[:, None].long()
    lists = torch.where(live, tile_idx.long(), torch.iinfo(torch.int64).max)
    seg = bounds.long().reshape(2, 1, 1).expand(2, lists.shape[0], 1)
    j_lo = torch.searchsorted(lists, seg[0].contiguous()).squeeze(1)
    j_hi = torch.searchsorted(lists, seg[1].contiguous()).squeeze(1)
    depth = j_hi - j_lo

    carry = _to_tiles(frame_planes, tiles_y, th, tiles_x, tw).clone()
    mask_t = _to_tiles(masks, tiles_y, th, tiles_x, tw)
    bd_t = (None if backdrop_planes is None
            else _to_tiles(backdrop_planes, tiles_y, th, tiles_x, tw))
    iy = torch.arange(th, dtype=torch.float32, device=dev)[:, None]
    ix = torch.arange(tw, dtype=torch.float32, device=dev)[None, :]
    ty = torch.arange(tiles_y, device=dev).repeat_interleave(tiles_x)
    tx = torch.arange(tiles_x, device=dev).repeat(tiles_y)
    y0 = (ty * th).to(torch.float32)[:, None, None]
    x0 = (tx * tw).to(torch.float32)[:, None, None]
    py_t = y0 + iy + 0.5  # (T, th, 1)
    px_t = x0 + ix + 0.5  # (T, 1, tw)

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
            backdrop_planes=bd,
        )
        fa = fa * mask_t[act, m[:, QI_MASK].long()]
        inv = 1.0 - fa
        dst = carry[act]
        carry[act] = torch.stack(
            (fr * fa + dst[:, 0] * inv, fg * fa + dst[:, 1] * inv,
             fb * fa + dst[:, 2] * inv, fa + dst[:, 3] * inv), dim=1)
    return _from_tiles(carry, tiles_y, th, tiles_x, tw)
