"""2D value types (figdraw_tpu/geometry.py, trimmed to what the slice uses)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, slots=True)
class Vec2:
    x: float = 0.0
    y: float = 0.0


def vec2(x: float = 0.0, y: float = 0.0) -> Vec2:
    return Vec2(float(x), float(y))


@dataclass(frozen=True, slots=True)
class Rect:
    x: float = 0.0
    y: float = 0.0
    w: float = 0.0
    h: float = 0.0


def rect(x: float = 0.0, y: float = 0.0, w: float = 0.0, h: float = 0.0) -> Rect:
    return Rect(float(x), float(y), float(w), float(h))
