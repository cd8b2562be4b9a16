"""Dashed, dotted and solid rounded-rect border op generators
(figdraw_tpu/borders.py, copied): the rounded perimeter is decomposed into
line and arc path segments (clockwise from the top edge), dash and dot
intervals are measured by arc length along the path, and the result is an
nkDrawable Fig whose ops the walk turns into SDF quads.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

from .basics import CornerRadii, StrokeCap, RenderStroke, ZLevel
from .colors import rgba
from .fill import Fill, fill as make_fill
from .geometry import Rect, Vec2, rect, vec2
from .nodes import (
    DrawableOp,
    Fig,
    drawable_arc,
    drawable_circle,
    drawable_line,
)
from .basics import FigKind

PATH_EPSILON = 1e-6


@dataclass(frozen=True)
class _Segment:
    kind: str  # "line" | "arc"
    length: float
    a: Vec2 = None
    b: Vec2 = None
    center: Vec2 = None
    radius: float = 0.0
    start_angle: float = 0.0
    sweep_angle: float = 0.0


def _positive_mod(v: float, cycle: float) -> float:
    if cycle <= PATH_EPSILON:
        return 0.0
    r = v - math.floor(v / cycle) * cycle
    if r < 0.0:
        r += cycle
    return r


def _border_radii(box: Rect, corners: CornerRadii) -> Tuple[float, float, float, float]:
    """Clamp radii to half-extents, then rescale so opposing pairs fit
    (drawutils.nim:110-135). Order: TL, TR, BL, BR."""
    max_radius = max(0.0, min(box.w, box.h) * 0.5)
    r = [min(float(c), max_radius) for c in corners]
    TL, TR, BL, BR = 0, 1, 2, 3
    scale = 1.0
    for total, extent in (
        (r[TL] + r[TR], box.w),
        (r[BL] + r[BR], box.w),
        (r[TL] + r[BL], box.h),
        (r[TR] + r[BR], box.h),
    ):
        if total > PATH_EPSILON:
            scale = min(scale, extent / total)
    if scale < 1.0:
        r = [v * scale for v in r]
    return tuple(r)  # type: ignore[return-value]


def _segments(box: Rect, corners: CornerRadii) -> List[_Segment]:
    """Perimeter path: top edge → TR arc → right edge → BR arc → bottom →
    BL arc → left → TL arc (drawutils.nim:159-191)."""
    out: List[_Segment] = []
    if box.w <= 0.0 or box.h <= 0.0:
        return out
    x0, y0 = box.x, box.y
    x1, y1 = box.x + box.w, box.y + box.h
    tl, tr, bl, br = _border_radii(box, corners)
    quarter = math.pi * 0.5

    def add_line(a: Vec2, b: Vec2):
        length = (b - a).length()
        if length > PATH_EPSILON:
            out.append(_Segment("line", length, a=a, b=b))

    def add_arc(center: Vec2, radius: float, start: float, sweep: float):
        length = abs(radius * sweep)
        if radius > PATH_EPSILON and length > PATH_EPSILON:
            out.append(
                _Segment(
                    "arc", length, center=center, radius=radius,
                    start_angle=start, sweep_angle=sweep,
                )
            )

    add_line(vec2(x0 + tl, y0), vec2(x1 - tr, y0))
    add_arc(vec2(x1 - tr, y0 + tr), tr, -quarter, quarter)
    add_line(vec2(x1, y0 + tr), vec2(x1, y1 - br))
    add_arc(vec2(x1 - br, y1 - br), br, 0.0, quarter)
    add_line(vec2(x1 - br, y1), vec2(x0 + bl, y1))
    add_arc(vec2(x0 + bl, y1 - bl), bl, quarter, quarter)
    add_line(vec2(x0, y1 - bl), vec2(x0, y0 + tl))
    add_arc(vec2(x0 + tl, y0 + tl), tl, math.pi, quarter)
    return out


def _point_at(segments: Sequence[_Segment], distance: float) -> Vec2:
    seg_start = 0.0
    for seg in segments:
        seg_stop = seg_start + seg.length
        if distance <= seg_stop + PATH_EPSILON:
            local = min(max(distance - seg_start, 0.0), seg.length)
            if seg.kind == "line":
                t = local / seg.length
                return seg.a + (seg.b - seg.a) * t
            angle = seg.start_angle + seg.sweep_angle * (local / seg.length)
            return seg.center + vec2(
                math.cos(angle) * seg.radius, math.sin(angle) * seg.radius
            )
        seg_start = seg_stop
    return vec2(0, 0)


def _add_interval(ops: List[DrawableOp], segments: Sequence[_Segment],
                  start: float, stop: float) -> None:
    seg_start = 0.0
    for seg in segments:
        seg_stop = seg_start + seg.length
        local_start = max(start, seg_start)
        local_stop = min(stop, seg_stop)
        if local_stop > local_start + PATH_EPSILON:
            s = local_start - seg_start
            e = local_stop - seg_start
            if seg.kind == "line":
                t0, t1 = s / seg.length, e / seg.length
                ops.append(drawable_line(
                    seg.a + (seg.b - seg.a) * t0, seg.a + (seg.b - seg.a) * t1
                ))
            else:
                t0, t1 = s / seg.length, e / seg.length
                ops.append(drawable_arc(
                    seg.center, seg.radius,
                    seg.start_angle + seg.sweep_angle * t0,
                    seg.sweep_angle * (t1 - t0),
                ))
        seg_start = seg_stop


def drawable_rounded_rect_border_ops(box: Rect, corners: CornerRadii) -> List[DrawableOp]:
    """Solid perimeter ops (drawutils.nim:264-276)."""
    ops: List[DrawableOp] = []
    for seg in _segments(box, corners):
        if seg.kind == "line":
            ops.append(drawable_line(seg.a, seg.b))
        else:
            ops.append(drawable_arc(seg.center, seg.radius, seg.start_angle, seg.sweep_angle))
    return ops


def drawable_dashed_rounded_rect_border_ops(
    box: Rect, corners: CornerRadii, dash_length: float, gap_length: float,
    offset: float = 0.0,
) -> List[DrawableOp]:
    """Dash intervals measured along the path (drawutils.nim:278-315)."""
    if dash_length <= PATH_EPSILON:
        return []
    if gap_length <= PATH_EPSILON:
        return drawable_rounded_rect_border_ops(box, corners)
    segments = _segments(box, corners)
    path_length = sum(s.length for s in segments)
    cycle = dash_length + gap_length
    if path_length <= PATH_EPSILON or cycle <= PATH_EPSILON:
        return []
    ops: List[DrawableOp] = []
    distance = 0.0
    phase = _positive_mod(offset, cycle)
    drawing = phase < dash_length
    run_remaining = dash_length - phase if drawing else cycle - phase
    while distance < path_length - PATH_EPSILON:
        run_stop = min(path_length, distance + run_remaining)
        if drawing:
            _add_interval(ops, segments, distance, run_stop)
        distance = run_stop
        drawing = not drawing
        run_remaining = dash_length if drawing else gap_length
    return ops


def drawable_dotted_rounded_rect_border_ops(
    box: Rect, corners: CornerRadii, dot_radius: float, gap_length: float,
    offset: float = 0.0,
) -> List[DrawableOp]:
    """Dot centers spaced edge-to-edge by gap_length (drawutils.nim:317-341)."""
    if dot_radius <= PATH_EPSILON:
        return []
    segments = _segments(box, corners)
    path_length = sum(s.length for s in segments)
    spacing = dot_radius * 2.0 + max(0.0, gap_length)
    if path_length <= PATH_EPSILON or spacing <= PATH_EPSILON:
        return []
    ops: List[DrawableOp] = []
    phase = _positive_mod(offset, spacing)
    distance = 0.0 if phase <= PATH_EPSILON else spacing - phase
    while distance < path_length - PATH_EPSILON:
        ops.append(drawable_circle(_point_at(segments, distance), dot_radius))
        distance += spacing
    return ops


def _border_fig(box: Rect, pad: float, fill_: Fill, stroke: RenderStroke,
                ops, zlevel: ZLevel) -> Fig:
    bounds = rect(box.x - pad, box.y - pad, box.w + pad * 2.0, box.h + pad * 2.0)
    node = Fig(kind=FigKind.nkDrawable)
    node.zlevel = zlevel
    node.screen_box = bounds
    node.fill = fill_
    node.draw_stroke = stroke
    node.draw_ops = tuple(ops)
    return node


def fig_rounded_rect_border(
    box: Rect, corners: CornerRadii, fill_: Fill, weight: float,
    cap: StrokeCap = StrokeCap.scButt, zlevel: ZLevel = 0,
) -> Fig:
    """nkDrawable solid rounded-rect border (drawutils.nim:372-398)."""
    half = max(0.0, weight) * 0.5
    local = rect(half, half, box.w, box.h)
    return _border_fig(
        box, half, make_fill(rgba(0, 0, 0, 0)),
        RenderStroke(weight=weight, fill=fill_, cap=cap),
        drawable_rounded_rect_border_ops(local, corners), zlevel,
    )


def fig_dashed_rounded_rect_border(
    box: Rect, corners: CornerRadii, fill_: Fill, weight: float,
    dash_length: float, gap_length: float, offset: float = 0.0,
    cap: StrokeCap = StrokeCap.scButt, zlevel: ZLevel = 0,
) -> Fig:
    """nkDrawable dashed rounded-rect border (drawutils.nim:343-370)."""
    half = max(0.0, weight) * 0.5
    local = rect(half, half, box.w, box.h)
    return _border_fig(
        box, half, make_fill(rgba(0, 0, 0, 0)),
        RenderStroke(weight=weight, fill=fill_, cap=cap),
        drawable_dashed_rounded_rect_border_ops(local, corners, dash_length, gap_length, offset),
        zlevel,
    )


def fig_dotted_rounded_rect_border(
    box: Rect, corners: CornerRadii, fill_: Fill, weight: float,
    gap_length: float, offset: float = 0.0, zlevel: ZLevel = 0,
) -> Fig:
    """nkDrawable dotted rounded-rect border (drawutils.nim:400-422); dots are
    filled circles so the node fill carries the color."""
    dot_radius = max(0.0, weight) * 0.5
    local = rect(dot_radius, dot_radius, box.w, box.h)
    return _border_fig(
        box, dot_radius, fill_, RenderStroke(),
        drawable_dotted_rounded_rect_border_ops(local, corners, dot_radius, gap_length, offset),
        zlevel,
    )
