"""Separable gaussian backdrop blur in plain torch
(figdraw_tpu/ops/blur.py:21-65): radius clamped to 64, sigma = radius/2, tap
step = max(radius/8, 1) px, 8 taps each side, linearly interpolated,
clamp-to-edge gathers. The radius stays a float32 tensor, so the weights are
computed in float32 as in the reference (never in Python doubles), and no
value leaves the device.
"""

from __future__ import annotations

import torch

TAP_RADIUS = 8


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


def backdrop_blur_planar(frame_planes: torch.Tensor, radius) -> torch.Tensor:
    """Blur a channel-planar (4, H, W) frame: horizontal then vertical pass
    (runBackdropSeparableBlur's order). radius: 0-d float32 tensor (or a
    float) on the planes' device."""
    radius = torch.as_tensor(radius, dtype=torch.float32, device=frame_planes.device)
    out = _blur_axis(frame_planes, radius, axis=2)
    out = _blur_axis(out, radius, axis=1)
    return out
