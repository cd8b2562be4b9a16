"""Convenience Fig constructors: lines and circles as nkDrawable nodes
(figdraw_tpu/extras.py, copied).
"""

from __future__ import annotations

from .basics import FigKind, RenderStroke, ZLevel
from .fill import fill as make_fill
from .geometry import Vec2, rect, vec2
from .nodes import Fig, drawable_circle, drawable_line


def fig_line(a: Vec2, b: Vec2, fill_, weight: float, zlevel: ZLevel = 0) -> Fig:
    """figLine(a, b, fill, weight); use fig_line_xy for the coordinate form."""
    f = make_fill(fill_)
    delta = b - a
    half = max(0.0, weight) / 2.0
    bounds = rect(
        min(a.x, b.x) - half,
        min(a.y, b.y) - half,
        abs(delta.x) + half * 2.0,
        abs(delta.y) + half * 2.0,
    )
    node = Fig(kind=FigKind.nkDrawable)
    node.zlevel = zlevel
    node.screen_box = bounds
    node.fill = f
    node.draw_stroke = RenderStroke(weight=weight, fill=f)
    node.draw_ops = (drawable_line(a - bounds.xy, b - bounds.xy),)
    return node


def fig_line_xy(x1, y1, x2, y2, fill_, weight: float, zlevel: ZLevel = 0) -> Fig:
    return fig_line(vec2(x1, y1), vec2(x2, y2), fill_, weight, zlevel)


def fig_circle(center, fill_, radius: float = 0.0, zlevel: ZLevel = 0) -> Fig:
    if not isinstance(center, Vec2):
        raise TypeError("use fig_circle_xy for coordinate form")
    f = make_fill(fill_)
    r = max(0.0, radius)
    d = r * 2.0
    node = Fig(kind=FigKind.nkDrawable)
    node.zlevel = zlevel
    node.fill = f
    node.screen_box = rect(center.x - r, center.y - r, d, d)
    node.draw_ops = (drawable_circle(vec2(r, r), r),)
    return node


def fig_circle_xy(x, y, fill_, radius: float, zlevel: ZLevel = 0) -> Fig:
    return fig_circle(vec2(x, y), fill_, radius, zlevel)
