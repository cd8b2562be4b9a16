"""Backdrop blur: the separable gaussian over the channel-planar frame
(figdraw_tpu/ops/blur.py:21-65), which the JAX package leaves to XLA.

Radius clamped to 64, sigma = radius/2, tap step = max(radius/8, 1) px, 8
taps each side, linearly interpolated, clamp-to-edge, horizontal then
vertical. The radius stays a float32 tensor, so the weights are computed in
float32 as in the reference (never in Python doubles), and no value leaves
the device.

`backdrop_blur_planar` runs csrc/blur.cu, a hand-written kernel for Hopper
(sm_90a), one launch a pass, on CUDA tensors (or raises); CPU tensors take
`backdrop_blur_planar_plain`, the plain torch version, which the CPU tests
and the on-card comparison use.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import nvcc

TAP_RADIUS = 8

# kernel launches since the count was last reset (two a blur: one a pass)
LAUNCHES = 0

_SOURCES = ("blur.cu",)

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""  # nvcc's output of the build this process loaded (ptxas -v)


def load() -> ctypes.CDLL:
    """The kernel library, built and bound at first use."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is None:
            path, BUILD_LOG = nvcc.build("figdraw_blur", _SOURCES)
            lib = ctypes.CDLL(path)
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.figdraw_blur_pass.argtypes = [vp] * 3 + [i] * 4 + [vp]
            lib.figdraw_blur_pass.restype = i
            _lib = lib
        return _lib


def _blur_axis(img: torch.Tensor, radius: torch.Tensor, axis: int) -> torch.Tensor:
    """One separable pass along `axis` of img."""
    r = torch.clamp(radius, 0.0, 64.0)
    sigma = torch.clamp(0.5 * r, min=0.5)
    step_px = torch.clamp(r / TAP_RADIUS, min=1.0)
    n = img.shape[axis]

    coords = torch.arange(n, dtype=torch.float32, device=img.device)
    fr_shape = [1] * img.ndim
    fr_shape[axis] = n
    acc = torch.zeros_like(img)
    weight_sum = torch.zeros((), dtype=img.dtype, device=img.device)
    for i in range(-TAP_RADIUS, TAP_RADIUS + 1):
        x = i * step_px
        w = torch.exp(-0.5 * (x * x) / (sigma * sigma))
        pos = coords + x
        p0 = torch.floor(pos)
        frac = pos - p0
        i0 = torch.clamp(p0.to(torch.int64), 0, n - 1)
        i1 = torch.clamp(i0 + 1, 0, n - 1)
        s0 = img.index_select(axis, i0)
        s1 = img.index_select(axis, i1)
        fr = frac.reshape(fr_shape)
        acc = acc + (s0 * (1.0 - fr) + s1 * fr) * w
        weight_sum = weight_sum + w

    out = acc / torch.clamp(weight_sum, min=1e-5)
    return torch.where(r <= 0.5, img, out)


def backdrop_blur_planar_plain(frame_planes: torch.Tensor, radius) -> torch.Tensor:
    """The plain torch version of backdrop_blur_planar (same arguments, any
    device): horizontal then vertical pass (runBackdropSeparableBlur's
    order)."""
    radius = torch.as_tensor(radius, dtype=torch.float32, device=frame_planes.device)
    out = _blur_axis(frame_planes, radius, axis=2)
    out = _blur_axis(out, radius, axis=1)
    return out


def backdrop_blur_planar(frame_planes: torch.Tensor, radius) -> torch.Tensor:
    """Blur a channel-planar (C, H, W) f32 frame into new planes; the input
    is not written. radius: a 0-d (or one-element) float32 tensor on the
    planes' device, which the kernel reads there, or a float."""
    if frame_planes.device.type == "cpu":
        return backdrop_blur_planar_plain(frame_planes, radius)
    if frame_planes.device.type != "cuda":
        raise ValueError(f"no blur kernel for {frame_planes.device}")
    dev = frame_planes.device
    if (frame_planes.dtype != torch.float32 or frame_planes.dim() != 3
            or not frame_planes.is_contiguous()):
        raise ValueError("frame_planes must be contiguous (C, H, W) float32, got "
                         f"{frame_planes.dtype} {tuple(frame_planes.shape)}")
    radius = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    if radius.numel() != 1:
        raise ValueError(f"radius must hold one value, got {tuple(radius.shape)}")
    planes, ph, pw = frame_planes.shape
    if planes * ph > 1 << 30:
        raise ValueError(f"{planes} x {ph} rows are more than one launch takes")
    lib = load()
    mid = torch.empty_like(frame_planes)
    out = torch.empty_like(frame_planes)
    stream = torch.cuda.current_stream(dev).cuda_stream
    global LAUNCHES
    for src, dst, vertical in ((frame_planes, mid, 0), (mid, out, 1)):
        rc = lib.figdraw_blur_pass(src.data_ptr(), dst.data_ptr(),
                                   radius.data_ptr(), planes, ph, pw, vertical,
                                   stream)
        if rc != 0:
            raise RuntimeError(f"blur launch failed: cudaError {rc}")
        LAUNCHES += 1
    return out
