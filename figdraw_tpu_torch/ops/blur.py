"""Backdrop blur: the separable gaussian over the channel-planar frame
(figdraw_tpu/ops/blur.py:21-65), which the JAX package leaves to XLA.

Radius clamped to 64, sigma = radius/2, tap step = max(radius/8, 1) px, 8
taps each side, linearly interpolated, clamp-to-edge, horizontal then
vertical. The radius stays a float32 tensor, so the weights are computed in
float32 as in the reference (never in Python doubles), and no value leaves
the device.

`backdrop_blur_planar` runs csrc/blur.cu, a hand-written kernel for Hopper
(sm_90a), one launch a pass (`blur_pass`), on CUDA tensors (or raises); CPU
tensors take `backdrop_blur_planar_plain`, the plain torch version, which
the CPU tests and the on-card comparison use.

`banded_blur_planar` is the same blur on a frame split into row bands over
several devices (figdraw_tpu/parallel/sharding.py `_banded_blur_planar`,
:165-190, the ppermute halo exchange): the horizontal pass runs on each
band; each band then takes BLUR_HALO rows from each neighbour (its own edge
row repeated at the frame's top and bottom), and the vertical pass runs on
the extended band, which is cropped back. Where the halo is not shorter
than a band, every band is gathered onto each device instead, blurred
there once and sliced back. On CUDA bands both passes are X1's kernel
(`blur_pass`), the halo rows move by tensor copies between devices; the
plain version `banded_blur_planar_plain` does the same on `_blur_axis`.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import nvcc

TAP_RADIUS = 8

# kernel launches since the count was last reset (two a blur: one a pass)
LAUNCHES = 0
# of those, the passes the banded blur launched (a horizontal pass a band,
# then a vertical pass a band or, on the gather path, a device)
BAND_LAUNCHES = 0
# rows a band takes from each neighbour: the radius clamp 64 (blur.frag:12)
# and 1 for the linear tap's second texel (sharding.py:151)
BLUR_HALO = 65

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


def blur_pass(planes: torch.Tensor, radius, vertical: bool,
              band: bool = False) -> torch.Tensor:
    """One separable pass of X1's kernel over channel-planar (C, H, W) f32
    planes on the card, into new planes (along W, or along H when
    vertical); the input is not written. radius: a 0-d (or one-element)
    float32 tensor on the planes' device, which the kernel reads there, or a
    float. band: the pass belongs to banded_blur_planar (counted in
    BAND_LAUNCHES too). A tensor that is not on a CUDA device raises
    ValueError; blur_axis_plain is the pass's plain version."""
    if planes.device.type != "cuda":
        raise ValueError(f"no blur kernel for {planes.device}")
    dev = planes.device
    if planes.dtype != torch.float32 or planes.dim() != 3 or not planes.is_contiguous():
        raise ValueError("planes must be contiguous (C, H, W) float32, got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    radius = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    if radius.numel() != 1:
        raise ValueError(f"radius must hold one value, got {tuple(radius.shape)}")
    c, ph, pw = planes.shape
    if c * ph > 1 << 30:
        raise ValueError(f"{c} x {ph} rows are more than one launch takes")
    out = torch.empty_like(planes)
    lib = load()
    # the planes' device is the current one for the launch: the banded blur
    # passes bands of several devices
    with torch.cuda.device(dev):
        rc = lib.figdraw_blur_pass(planes.data_ptr(), out.data_ptr(), radius.data_ptr(),
                                   c, ph, pw, int(bool(vertical)),
                                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"blur launch failed: cudaError {rc}")
    global LAUNCHES, BAND_LAUNCHES
    LAUNCHES += 1
    BAND_LAUNCHES += bool(band)
    return out


def blur_axis_plain(planes: torch.Tensor, radius, vertical: bool) -> torch.Tensor:
    """The plain torch version of blur_pass (any device)."""
    radius = torch.as_tensor(radius, dtype=torch.float32, device=planes.device)
    return _blur_axis(planes, radius, axis=1 if vertical else 2)


def backdrop_blur_planar(frame_planes: torch.Tensor, radius) -> torch.Tensor:
    """Blur a channel-planar (C, H, W) f32 frame into new planes; the input
    is not written. radius: a 0-d (or one-element) float32 tensor on the
    planes' device, which the kernel reads there, or a float."""
    if frame_planes.device.type == "cpu":
        return backdrop_blur_planar_plain(frame_planes, radius)
    return blur_pass(blur_pass(frame_planes, radius, False), radius, True)


def _edge_rows(band: torch.Tensor, row: int, halo: int) -> torch.Tensor:
    """Row `row` of a (C, H, W) band repeated halo times."""
    return band[:, row : row + 1 if row >= 0 else None].expand(-1, halo, -1)


def _banded(bands, radii, halo: int, pass_fn):
    """The banded blur over one pass function pass_fn(planes, radius,
    vertical)."""
    n = len(bands)
    local = [pass_fn(b, r, False) for b, r in zip(bands, radii)]
    if n == 1:
        return [pass_fn(local[0], radii[0], True)]
    band_h = local[0].shape[1]
    if halo >= band_h:
        # bands no taller than the blur's reach: every band gathered onto
        # each device, blurred there once, and each band's rows taken back
        whole = {}
        out = []
        for i, b in enumerate(local):
            dev = b.device
            if dev not in whole:
                gathered = torch.cat([x.to(dev) for x in local], dim=1)
                whole[dev] = pass_fn(gathered, radii[i], True)
            out.append(whole[dev][:, i * band_h : (i + 1) * band_h].contiguous())
        return out
    out = []
    for i, b in enumerate(local):
        dev = b.device
        top = (_edge_rows(b, 0, halo) if i == 0
               else local[i - 1][:, -halo:].to(dev))
        bot = (_edge_rows(b, -1, halo) if i == n - 1
               else local[i + 1][:, :halo].to(dev))
        extended = torch.cat([top, b, bot], dim=1)
        out.append(pass_fn(extended, radii[i], True)[:, halo:-halo].contiguous())
    return out


def banded_blur_planar(bands, radii, halo: int = BLUR_HALO) -> list:
    """The backdrop blur of a frame split into row bands: bands, a list of
    (C, h, W) f32 planes (band i the frame's rows [i h, (i+1) h), each on
    its own device, one device for several bands allowed); radii, a list of
    each band's radius (a one-element f32 tensor on its device, or a
    float). Returns the blurred bands, new planes on the bands' devices;
    the inputs are not written. The frame's edge rows repeat at its top and
    bottom (clamp-to-edge on the n h rows). CUDA bands run blur_pass, CPU
    bands the plain version; a mix raises ValueError."""
    types = {b.device.type for b in bands}
    if len(types) != 1:
        raise ValueError(f"bands on devices of several types: {sorted(types)}")
    if len({tuple(b.shape) for b in bands}) != 1:
        raise ValueError("every band must have the same shape")
    if types == {"cpu"}:
        return banded_blur_planar_plain(bands, radii, halo)

    def kernel_pass(planes, radius, vertical):
        return blur_pass(planes, radius, vertical, band=True)

    return _banded(bands, radii, halo, kernel_pass)


def banded_blur_planar_plain(bands, radii, halo: int = BLUR_HALO) -> list:
    """The plain torch version of banded_blur_planar (any devices)."""
    return _banded(bands, radii, halo, blur_axis_plain)
