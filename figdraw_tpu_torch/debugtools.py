"""Debug tools: conservative visibility, hit testing, pixel probes
(figdraw_tpu/debugtools.py, copied): fig_visibility's conservative
axis-aligned reasoning (disabled / clipped-out / covered by a later opaque
rect, with an `approximate` flag when rotation, rounded clip corners,
matrices or partial cover are ignored), hits_at_point / top_fig_at_point
render-order hit testing, and color_at pixel sampling on a frame read back
as uint8 (FigRenderer.take_screenshot).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .basics import FigFlags, FigKind
from .colors import ColorRGBA
from .fill import Fill, FillKind
from .geometry import Rect, Vec2, rect, vec2
from .nodes import Fig, FigIdx, RenderList, Renders


@dataclass(frozen=True)
class FigLocation:
    zlevel: int = 0
    index: FigIdx = 0


class FigVisibilityReason(enum.Enum):
    fvVisible = "visible"
    fvMissingLayer = "missing-layer"
    fvMissingFig = "missing-fig"
    fvDisabled = "disabled"
    fvNoDrawable = "no-drawable"
    fvEmptyBounds = "empty-bounds"
    fvClippedOut = "clipped-out"
    fvCovered = "covered"


@dataclass
class FigVisibility:
    visible: bool = False
    reason: FigVisibilityReason = FigVisibilityReason.fvMissingFig
    location: FigLocation = field(default_factory=FigLocation)
    bounds: Rect = field(default_factory=Rect)
    clipped_bounds: Rect = field(default_factory=Rect)
    has_clip_bounds: bool = False
    clip_bounds: Rect = field(default_factory=Rect)
    has_covered_by: bool = False
    covered_by: FigLocation = field(default_factory=FigLocation)
    approximate: bool = False


@dataclass
class FigHit:
    location: FigLocation
    node: Fig
    bounds: Rect
    has_clip_bounds: bool = False
    clip_bounds: Rect = field(default_factory=Rect)
    clipped_bounds: Rect = field(default_factory=Rect)
    approximate: bool = False


@dataclass
class _DebugFig:
    hit: FigHit
    disabled: bool = False
    drawable: bool = False


def _is_positive(r: Rect) -> bool:
    return r.w > 0.0 and r.h > 0.0


def _contains_point(r: Rect, p: Vec2) -> bool:
    return r.x <= p.x < r.x + r.w and r.y <= p.y < r.y + r.h


def _contains_rect(outer: Rect, inner: Rect) -> bool:
    return (
        inner.x >= outer.x
        and inner.y >= outer.y
        and inner.x + inner.w <= outer.x + outer.w
        and inner.y + inner.h <= outer.y + outer.h
    )


def _intersect(a: Rect, b: Rect) -> Rect:
    x0 = max(a.x, b.x)
    y0 = max(a.y, b.y)
    x1 = min(a.x + a.w, b.x + b.w)
    y1 = min(a.y + a.h, b.y + b.h)
    if x1 <= x0 or y1 <= y0:
        return rect(x0, y0, 0.0, 0.0)
    return rect(x0, y0, x1 - x0, y1 - y0)


def _has_rounded_corners(node: Fig) -> bool:
    for i in range(4):
        rx = node.corners[i]
        ry = (
            node.corner_radii_y[i]
            if FigFlags.NfEllipticalCorners in node.flags
            else rx
        )
        if rx != 0 and ry != 0:
            return True
    return False


def _has_fill_alpha(f: Fill) -> bool:
    from .fill import fill_alpha_max

    return fill_alpha_max(f) > 0


def _is_opaque_fill(f: Fill) -> bool:
    if f.kind == FillKind.flColor:
        return f.color.a == 255
    if f.kind == FillKind.flLinear2:
        return f.lin2.start.a == 255 and f.lin2.stop.a == 255
    return f.lin3.start.a == 255 and f.lin3.mid.a == 255 and f.lin3.stop.a == 255


def _is_drawable_node(node: Fig) -> bool:
    if node.kind in (FigKind.nkFrame, FigKind.nkTransform):
        return False
    if node.kind == FigKind.nkRectangle:
        return _has_fill_alpha(node.fill) or node.stroke.weight > 0.0
    if node.kind == FigKind.nkBackdropBlur:
        return node.backdrop_blur.blur > 0.0 or _has_fill_alpha(node.fill)
    return True


def _is_opaque_cover(node: Fig) -> bool:
    return (
        node.kind == FigKind.nkRectangle
        and node.rotation == 0.0
        and not _has_rounded_corners(node)
        and node.stroke.weight <= 0.0
        and _is_opaque_fill(node.fill)
    )


def _collect(
    lst: RenderList,
    zlevel: int,
    node_idx: FigIdx,
    has_clip: bool,
    clip_bounds: Rect,
    translation: Vec2,
    parent_approximate: bool,
    out: List[_DebugFig],
) -> None:
    if node_idx < 0 or node_idx >= len(lst.nodes):
        return
    node = lst.nodes[node_idx]
    location = FigLocation(zlevel=zlevel, index=node_idx)
    node_translation = translation
    if node.kind == FigKind.nkTransform:
        node_translation = node_translation + node.transform.translation
    effective = rect(
        node.screen_box.x + node_translation.x,
        node.screen_box.y + node_translation.y,
        node.screen_box.w,
        node.screen_box.h,
    )
    if FigFlags.NfDisableRender in node.flags:
        out.append(
            _DebugFig(
                hit=FigHit(location=location, node=node, bounds=effective),
                disabled=True,
            )
        )
        return

    node_clips = (
        FigFlags.NfClipContent in node.flags or FigFlags.NfRectMaskContent in node.flags
    )
    next_has_clip = has_clip
    next_clip = clip_bounds
    approximate = (
        parent_approximate
        or node.rotation != 0.0
        or (node_clips and _has_rounded_corners(node))
        or (node.kind == FigKind.nkTransform and node.transform.use_matrix)
    )
    if node_clips:
        next_clip = _intersect(next_clip, effective) if next_has_clip else effective
        next_has_clip = True

    clipped = _intersect(effective, next_clip) if next_has_clip else effective
    out.append(
        _DebugFig(
            hit=FigHit(
                location=location,
                node=node,
                bounds=effective,
                has_clip_bounds=next_has_clip,
                clip_bounds=next_clip,
                clipped_bounds=clipped,
                approximate=approximate,
            ),
            drawable=_is_drawable_node(node),
        )
    )

    for child_idx in lst.child_index(node_idx):
        _collect(
            lst, zlevel, child_idx, next_has_clip, next_clip, node_translation,
            approximate, out,
        )


def _collect_all(renders_or_list, zlevel: int = 0) -> List[_DebugFig]:
    out: List[_DebugFig] = []
    if isinstance(renders_or_list, RenderList):
        layers = [(zlevel, renders_or_list)]
    else:
        layers = list(renders_or_list.pairs())
    for lvl, lst in layers:
        for root_idx in lst.root_ids:
            _collect(lst, lvl, root_idx, False, rect(0, 0, 0, 0), vec2(0, 0), False, out)
    return out


def collect_debug_figs(renders_or_list, zlevel: int = 0) -> List[FigHit]:
    """Renderable Fig debug entries in render order (debugtools.nim:199-225)."""
    return [
        item.hit
        for item in _collect_all(renders_or_list, zlevel)
        if item.drawable and _is_positive(item.hit.clipped_bounds)
    ]


def fig_visibility(renders_or_list, location_or_zlevel, index=None) -> FigVisibility:
    """Conservative visibility check (debugtools.nim:227-309)."""
    if isinstance(renders_or_list, RenderList):
        renders = Renders()
        if isinstance(location_or_zlevel, FigLocation):
            location = location_or_zlevel
        else:
            # (list, index) overload (debugtools.nim:303-309)
            location = FigLocation(zlevel=0, index=location_or_zlevel)
        renders.layers[location.zlevel] = renders_or_list
    else:
        renders = renders_or_list
        if isinstance(location_or_zlevel, FigLocation):
            location = location_or_zlevel
        else:
            location = FigLocation(zlevel=location_or_zlevel, index=index)

    result = FigVisibility(location=location)
    if location.zlevel not in renders.layers:
        result.reason = FigVisibilityReason.fvMissingLayer
        return result
    lst = renders.layers[location.zlevel]
    if location.index < 0 or location.index >= len(lst.nodes):
        result.reason = FigVisibilityReason.fvMissingFig
        return result

    debug_figs = _collect_all(renders)
    target_pos = -1
    for i, item in enumerate(debug_figs):
        if item.hit.location == location:
            target_pos = i
            result.bounds = item.hit.bounds
            result.clipped_bounds = item.hit.clipped_bounds
            result.has_clip_bounds = item.hit.has_clip_bounds
            result.clip_bounds = item.hit.clip_bounds
            result.approximate = item.hit.approximate
            if item.disabled:
                result.reason = FigVisibilityReason.fvDisabled
                return result
            if not item.drawable:
                result.reason = FigVisibilityReason.fvNoDrawable
                return result
            break
    if target_pos < 0:
        result.reason = FigVisibilityReason.fvMissingFig
        return result
    if not _is_positive(result.bounds):
        result.reason = FigVisibilityReason.fvEmptyBounds
        return result
    if not _is_positive(result.clipped_bounds):
        result.reason = FigVisibilityReason.fvClippedOut
        return result

    for item in debug_figs[target_pos + 1 :]:
        if (
            item.drawable
            and _is_positive(item.hit.clipped_bounds)
            and _is_opaque_cover(item.hit.node)
            and _contains_rect(item.hit.clipped_bounds, result.clipped_bounds)
        ):
            result.reason = FigVisibilityReason.fvCovered
            result.has_covered_by = True
            result.covered_by = item.hit.location
            result.approximate = result.approximate or item.hit.approximate
            return result

    result.visible = True
    result.reason = FigVisibilityReason.fvVisible
    return result


def hits_at_point(renders_or_list, point: Vec2, zlevel: int = 0) -> List[FigHit]:
    """Renderable Figs whose clipped bounds contain point, back to front."""
    return [
        hit
        for hit in collect_debug_figs(renders_or_list, zlevel)
        if _contains_point(hit.clipped_bounds, point)
    ]


def top_fig_at_point(renders_or_list, point: Vec2, zlevel: int = 0) -> Optional[FigHit]:
    hits = hits_at_point(renders_or_list, point, zlevel)
    return hits[-1] if hits else None


def color_at(image, x, y=None) -> ColorRGBA:
    """Pixel probe on a rendered uint8 RGBA frame (debugtools.nim:343-349)."""
    if y is None:
        p = x
        x, y = int(math.floor(p.x)), int(math.floor(p.y))
    arr = np.asarray(image)
    if x < 0 or y < 0 or y >= arr.shape[0] or x >= arr.shape[1]:
        return ColorRGBA(0, 0, 0, 0)
    px = arr[y, x]
    return ColorRGBA(int(px[0]), int(px[1]), int(px[2]), int(px[3]))
