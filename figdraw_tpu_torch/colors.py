"""Color types (figdraw_tpu/colors.py, trimmed to what the slice uses).

ColorRGBA: packed 8-bit RGBA, the storage form of every scene fill.
Color: float RGBA in [0, 1], the form of the frame's clear color.
"""

from __future__ import annotations

from dataclasses import dataclass


def _clamp8(v: int) -> int:
    return 0 if v < 0 else (255 if v > 255 else int(v))


@dataclass(frozen=True, slots=True)
class ColorRGBA:
    r: int = 0
    g: int = 0
    b: int = 0
    a: int = 0

    def to_color(self) -> "Color":
        return Color(self.r / 255.0, self.g / 255.0, self.b / 255.0, self.a / 255.0)


@dataclass(frozen=True, slots=True)
class Color:
    r: float = 0.0
    g: float = 0.0
    b: float = 0.0
    a: float = 0.0


def rgba(r: int, g: int, b: int, a: int) -> ColorRGBA:
    return ColorRGBA(_clamp8(r), _clamp8(g), _clamp8(b), _clamp8(a))


def as_color(c) -> Color:
    """Coerce any public color form (Color, ColorRGBA, or a 3/4-tuple of
    floats) to a normalized Color — render_frame/clear_color accept all."""
    if isinstance(c, Color):
        return c
    if isinstance(c, ColorRGBA):
        return c.to_color()
    vals = tuple(float(v) for v in c)
    if len(vals) == 3:
        vals = vals + (1.0,)
    return Color(*vals)
