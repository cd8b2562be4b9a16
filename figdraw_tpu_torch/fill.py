"""Fill variants: solid color, 2-stop and 3-stop linear gradients, and the
gradient sampling the walk's vertex colors come from (figdraw_tpu/fill.py,
copied). The enums are the FILL_DTYPE `kind` and `axis` codes.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Union

from .colors import Color, ColorRGBA, lerp_color


class FillGradientAxis(enum.IntEnum):
    fgaX = 0
    fgaY = 1
    fgaDiagTLBR = 2
    fgaDiagBLTR = 3


class FillKind(enum.IntEnum):
    flColor = 0
    flLinear2 = 1
    flLinear3 = 2


@dataclass(frozen=True, slots=True)
class Linear2:
    axis: FillGradientAxis = FillGradientAxis.fgaX
    start: ColorRGBA = ColorRGBA()
    stop: ColorRGBA = ColorRGBA()


@dataclass(frozen=True, slots=True)
class Linear3:
    axis: FillGradientAxis = FillGradientAxis.fgaX
    start: ColorRGBA = ColorRGBA()
    mid: ColorRGBA = ColorRGBA()
    stop: ColorRGBA = ColorRGBA()
    mid_pos: int = 128  # 0..255


@dataclass(frozen=True, slots=True)
class Fill:
    kind: FillKind = FillKind.flColor
    color: ColorRGBA = ColorRGBA()
    lin2: Optional[Linear2] = None
    lin3: Optional[Linear3] = None


def fill(c: Union[ColorRGBA, Color, Fill]) -> Fill:
    """Solid fill constructor (filltypes.nim:47-48); also accepts Color or an
    existing Fill for the reference's implicit converters."""
    if isinstance(c, Fill):
        return c
    if isinstance(c, Color):
        c = c.rgba()
    return Fill(kind=FillKind.flColor, color=c)


def linear(
    start: ColorRGBA,
    stop_or_mid: ColorRGBA,
    stop: Optional[ColorRGBA] = None,
    axis: FillGradientAxis = FillGradientAxis.fgaX,
    mid_pos: int = 128,
) -> Fill:
    """2-stop or 3-stop linear gradient (filltypes.nim:50-59)."""
    if stop is None:
        return Fill(
            kind=FillKind.flLinear2,
            lin2=Linear2(axis=axis, start=start, stop=stop_or_mid),
        )
    return Fill(
        kind=FillKind.flLinear3,
        lin3=Linear3(
            axis=axis, start=start, mid=stop_or_mid, stop=stop, mid_pos=int(mid_pos)
        ),
    )


def gradient_mid_pos01(f: Fill) -> float:
    if f.kind == FillKind.flLinear3:
        return min(max(f.lin3.mid_pos / 255.0, 0.01), 0.99)
    return 0.5


def sample_color(f: Fill, t: float) -> ColorRGBA:
    """Piecewise-linear gradient sample (filltypes.nim:76-89)."""
    if f.kind == FillKind.flColor:
        return f.color
    if f.kind == FillKind.flLinear2:
        return lerp_color(f.lin2.start, f.lin2.stop, t)
    tt = min(max(t, 0.0), 1.0)
    mid = gradient_mid_pos01(f)
    if tt <= mid:
        return lerp_color(f.lin3.start, f.lin3.mid, tt / mid)
    return lerp_color(f.lin3.mid, f.lin3.stop, (tt - mid) / (1.0 - mid))


def center_color_rgba(f: Fill) -> ColorRGBA:
    return sample_color(f, 0.5)


def center_color(f: Fill) -> Color:
    return center_color_rgba(f).to_color()


def fill_alpha_max(f: Fill) -> int:
    """Max alpha across gradient stops (figrender.nim:587-594)."""
    if f.kind == FillKind.flColor:
        return f.color.a
    if f.kind == FillKind.flLinear2:
        return max(f.lin2.start.a, f.lin2.stop.a)
    return max(f.lin3.start.a, f.lin3.mid.a, f.lin3.stop.a)


def fill_gradient_axis(f: Fill) -> FillGradientAxis:
    if f.kind == FillKind.flLinear2:
        return f.lin2.axis
    if f.kind == FillKind.flLinear3:
        return f.lin3.axis
    return FillGradientAxis.fgaX
