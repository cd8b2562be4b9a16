"""Scene-graph enums, style types and the global UI scale
(figdraw_tpu/basics.py, copied).

fig_ui_scale() multiplies every logical coordinate the walks read (node
boxes, corner radii, stroke weights, shadow offsets) and render_frame's
frame size; set_fig_ui_scale is process state, like the JAX package's.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple, Union

from .colors import ColorRGBA
from .fill import Fill, fill
from .geometry import Mat3, Rect, Vec2

SHADOW_COUNT = 4  # figbasics.nim:12

ZLevel = int  # int8 in the reference (figbasics.nim:16)
FigID = int


class Directions(enum.IntEnum):
    dTop = 0
    dRight = 1
    dBottom = 2
    dLeft = 3


class DirectionCorners(enum.IntEnum):
    dcTopLeft = 0
    dcTopRight = 1
    dcBottomLeft = 2
    dcBottomRight = 3


# CornerRadii = array[DirectionCorners, uint16] → 4-tuple ordered
# (TopLeft, TopRight, BottomLeft, BottomRight) as in figbasics.nim:25-31.
CornerRadii = Tuple[int, int, int, int]

ZERO_CORNERS: CornerRadii = (0, 0, 0, 0)


def round_half_away(x: float) -> float:
    """Round half away from zero (Nim round / C roundf), NOT Python banker's."""
    import math

    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


def corner_to_u16(v: float) -> int:
    """cornerToU16 (figbasics.nim:125-137): round+clamp to uint16."""
    if v <= 0:
        return 0
    if v >= 0xFFFF:
        return 0xFFFF
    return int(round(v))


def to_corner_radii(a: Sequence[float]) -> CornerRadii:
    return tuple(corner_to_u16(v) for v in a)  # type: ignore[return-value]


@dataclass(frozen=True, slots=True)
class CornerRadii2D:
    """Per-corner horizontal (x) and vertical (y) radii (figbasics.nim:33-35)."""

    x: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    y: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)

    @property
    def is_circular(self) -> bool:
        return all(self.x[i] == self.y[i] for i in range(4))


def init_corner_radii_2d(x: Sequence[float], y: Optional[Sequence[float]] = None) -> CornerRadii2D:
    xt = tuple(float(v) for v in x)
    yt = xt if y is None else tuple(float(v) for v in y)
    return CornerRadii2D(x=xt, y=yt)  # type: ignore[arg-type]


class FigKind(enum.IntEnum):
    nkFrame = 0
    nkText = 1
    nkRectangle = 2
    nkDrawable = 3
    nkScrollBar = 4
    nkImage = 5
    nkMsdfImage = 6
    nkMtsdfImage = 7
    nkBackdropBlur = 8
    nkTransform = 9


class FigFlags(enum.IntFlag):
    NfClipContent = 1 << 0
    NfDisableRender = 1 << 1
    NfRootWindow = 1 << 2
    NfInactive = 1 << 3
    NfSelectText = 1 << 4
    NfInvertY = 1 << 5
    NfRectMaskContent = 1 << 6
    NfEllipticalCorners = 1 << 7


# Re-export flag members at module level for reference-style spelling.
NfClipContent = FigFlags.NfClipContent
NfDisableRender = FigFlags.NfDisableRender
NfRootWindow = FigFlags.NfRootWindow
NfInactive = FigFlags.NfInactive
NfSelectText = FigFlags.NfSelectText
NfInvertY = FigFlags.NfInvertY
NfRectMaskContent = FigFlags.NfRectMaskContent
NfEllipticalCorners = FigFlags.NfEllipticalCorners


class ShadowStyle(enum.IntEnum):
    NoShadow = 0
    DropShadow = 1
    InnerShadow = 2


NoShadow = ShadowStyle.NoShadow
DropShadow = ShadowStyle.DropShadow
InnerShadow = ShadowStyle.InnerShadow


class StrokeCap(enum.IntEnum):
    scAuto = 0
    scRound = 1
    scButt = 2
    scSquare = 3


class StrokeJoin(enum.IntEnum):
    sjAuto = 0
    sjRound = 1
    sjBevel = 2
    sjMiter = 3


def _fill_or_color(v: Union[Fill, ColorRGBA, None]) -> Fill:
    if v is None:
        return Fill()
    return fill(v)


@dataclass(frozen=True, slots=True)
class RenderShadow:
    """figbasics.nim:78-84."""

    style: ShadowStyle = ShadowStyle.NoShadow
    fill: Fill = field(default_factory=Fill)
    blur: float = 0.0
    spread: float = 0.0
    x: float = 0.0
    y: float = 0.0


@dataclass(frozen=True, slots=True)
class RenderStroke:
    """figbasics.nim:86-90."""

    weight: float = 0.0
    fill: Fill = field(default_factory=Fill)
    cap: StrokeCap = StrokeCap.scAuto
    join: StrokeJoin = StrokeJoin.sjAuto


ImageId = int  # distinct Hash in the reference (imgutils.nim:13)


@dataclass(frozen=True, slots=True)
class ImageStyle:
    id: ImageId = 0
    fill: Fill = field(default_factory=Fill)


@dataclass(frozen=True, slots=True)
class MsdfImageStyle:
    id: ImageId = 0
    fill: Fill = field(default_factory=Fill)
    px_range: float = 0.0
    sd_threshold: float = 0.0
    stroke_weight: float = 0.0


@dataclass(frozen=True, slots=True)
class BackdropBlurStyle:
    blur: float = 0.0


@dataclass(frozen=True, slots=True)
class TransformStyle:
    translation: Vec2 = field(default_factory=Vec2)
    matrix: Optional[Mat3] = None  # set to apply after translation

    @property
    def use_matrix(self) -> bool:
        return self.matrix is not None


def image_style(id: ImageId, image_fill: Union[Fill, ColorRGBA, None] = None) -> ImageStyle:
    if image_fill is None:
        image_fill = fill(ColorRGBA(255, 255, 255, 255))
    return ImageStyle(id=id, fill=_fill_or_color(image_fill))


# --- Global UI scale (common/shared.nim:57-98) -------------------------------

_app_ui_scale: float = 1.0


def fig_ui_scale() -> float:
    return _app_ui_scale


def set_fig_ui_scale(scale: float) -> None:
    global _app_ui_scale
    _app_ui_scale = float(scale)


def scaled(v):
    """Multiply by the global UI scale (shared.nim:73-95)."""
    s = _app_ui_scale
    if isinstance(v, Rect):
        return Rect(v.x * s, v.y * s, v.w * s, v.h * s)
    if isinstance(v, Vec2):
        return Vec2(v.x * s, v.y * s)
    return v * s


def descaled(v):
    s = _app_ui_scale
    if isinstance(v, Rect):
        return Rect(v.x / s, v.y / s, v.w / s, v.h / s)
    if isinstance(v, Vec2):
        return Vec2(v.x / s, v.y / s)
    return v / s
