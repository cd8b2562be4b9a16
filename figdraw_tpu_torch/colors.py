"""Color types (figdraw_tpu/colors.py, copied: the JAX package's module
imports no JAX, but the port imports nothing of that package).

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

    def as_tuple(self):
        return (self.r, self.g, self.b, self.a)


@dataclass(frozen=True, slots=True)
class Color:
    r: float = 0.0
    g: float = 0.0
    b: float = 0.0
    a: float = 0.0

    def rgba(self) -> ColorRGBA:
        return ColorRGBA(
            _clamp8(round(self.r * 255)),
            _clamp8(round(self.g * 255)),
            _clamp8(round(self.b * 255)),
            _clamp8(round(self.a * 255)),
        )


def rgba(r: int, g: int, b: int, a: int) -> ColorRGBA:
    return ColorRGBA(_clamp8(r), _clamp8(g), _clamp8(b), _clamp8(a))


def color(r: float, g: float, b: float, a: float = 1.0) -> Color:
    return Color(float(r), float(g), float(b), float(a))


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


def lerp_color(a: ColorRGBA, b: ColorRGBA, t: float) -> ColorRGBA:
    """Per-channel lerp with round-half-away, matching the reference
    (filltypes.nim:67-74)."""
    tt = min(max(t, 0.0), 1.0)
    inv = 1.0 - tt

    def mix(x: int, y: int) -> int:
        v = x * inv + y * tt
        # Nim's round() rounds half away from zero; values here are >= 0.
        return _clamp8(int(v + 0.5))

    return ColorRGBA(mix(a.r, b.r), mix(a.g, b.g), mix(a.b, b.b), mix(a.a, b.a))


CLEAR_COLOR = color(0, 0, 0, 0)
WHITE_COLOR = color(1, 1, 1, 1)
BLACK_COLOR = color(0, 0, 0, 1)
BLUE_COLOR = color(0, 0, 1, 1)
