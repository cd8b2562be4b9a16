"""Fill variants: solid color, 2-stop and 3-stop linear gradients
(figdraw_tpu/fill.py without color sampling). The enums are the FILL_DTYPE
`kind` and `axis` codes; a Fill is what RenderListArray.set_fill and
set_stroke_fill take."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

from .colors import ColorRGBA


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


def fill(c) -> Fill:
    """Solid fill from a ColorRGBA (or a Fill, returned as is)."""
    if isinstance(c, Fill):
        return c
    return Fill(kind=FillKind.flColor, color=c)


def linear(start: ColorRGBA, stop_or_mid: ColorRGBA,
           stop: Optional[ColorRGBA] = None,
           axis: FillGradientAxis = FillGradientAxis.fgaX,
           mid_pos: int = 128) -> Fill:
    """2-stop, or with `stop` 3-stop, linear gradient."""
    if stop is None:
        return Fill(kind=FillKind.flLinear2,
                    lin2=Linear2(axis=axis, start=start, stop=stop_or_mid))
    return Fill(kind=FillKind.flLinear3,
                lin3=Linear3(axis=axis, start=start, mid=stop_or_mid,
                             stop=stop, mid_pos=int(mid_pos)))
