"""Glyph cache identity + atlas integration + text-node drawing
(figdraw_tpu/text/glyphs.py, copied).

The glyph cache hash, generate_glyph, and the renderText draw loop:
selection bands, underline / strikethrough decoration rects, then per-glyph
atlas quads — generated synchronously into the renderer's atlas on a cache
miss (the render-thread cold-miss path). render.render_text calls
draw_text_layout itself (the JAX package's text/rendertext.py pass-through
is not ported).
"""

from __future__ import annotations

import math
from typing import Optional

from ..backend import SdfMode, to_backend_fill
from ..basics import FigFlags, scaled
from ..colors import ColorRGBA
from ..fill import fill_alpha_max
from ..geometry import Rect, Vec2, rect, vec2
from .layout import ArrangedGlyph, GlyphArrangement
from .raster import rasterize_glyph
from .typefaces import get_fig_font, get_typeface


def glyph_hash(font_id: int, glyph_id: int, lcd: bool = False, variant: int = 0) -> int:
    """Cache identity (fontglyphs.nim:54-59). FNV-1a over the identity tuple —
    deterministic integer math so the C++ flattener computes identical keys
    (native/flatten.cpp fd_glyph_key)."""
    h = 0xCBF29CE484222325
    for v in (2344, font_id & 0xFFFFFFFFFFFFFFFF, glyph_id, int(lcd), variant):
        h ^= v
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h & 0x7FFFFFFFFFFFFFFF


def generate_glyph(
    font_id: int,
    glyph_id: int,
    lcd_filtering: bool = False,
    subpixel_variant: int = 0,
):
    """Rasterize one glyph; returns (rgba image, image_offset) or None."""
    font = get_fig_font(font_id)
    tf = get_typeface(font.typeface_id)
    # the registered FontId already folds in ui scale; size here is px
    from .layout import _glyph_font

    shift = subpixel_variant / 10.0 if subpixel_variant else 0.0
    return rasterize_glyph(
        tf, glyph_id, font.size * _ui_scale_for(font_id), subpixel_shift=shift,
        lcd_filtering=lcd_filtering, variations=font.variations,
    )


def _ui_scale_for(font_id: int) -> float:
    from .typefaces import _fonts, _registry_lock

    with _registry_lock:
        entry = _fonts.get(font_id)
    return entry[1] if entry else 1.0


def to_glyph_variant_subpixel_step(fractional_x: float) -> int:
    """10 pre-baked subpixel variants (fontglyphs.nim:43-52)."""
    return min(int(fractional_x * 10.0), 9)


def draw_text_layout(ctx, node, layout: GlyphArrangement) -> None:
    """renderText port (figrender.nim:417-497). ctx is a BackendContext; the
    glyph raster lands in ctx.entries via ensure_glyph (tape backends carry a
    glyph_loader hook installed by the renderer)."""
    lcd = ctx.text_lcd_filtering_enabled()
    subpixel = ctx.text_subpixel_positioning_enabled()
    variant_subpixel = subpixel and ctx.text_subpixel_glyph_variants_enabled()

    ctx.save_transform()
    try:
        box = node.screen_box
        ctx.translate(scaled(box.xy))
        if FigFlags.NfInvertY in node.flags:
            pivot = scaled(box.h)
            ctx.translate(vec2(0.0, pivot))
            ctx.scale(vec2(1.0, -1.0))

        # selection bands
        sel_a, sel_b = node.selection_range
        if (
            FigFlags.NfSelectText in node.flags
            and fill_alpha_max(node.fill) > 0
            and sel_a <= sel_b
        ):
            for selection in layout.selection_rects_for((sel_a, sel_b)):
                if selection.h > 0:
                    sel_rect = rect(
                        selection.x, selection.y, max(selection.w, 1.0), selection.h
                    )
                    ctx.draw_rounded_rect_sdf(
                        rect=scaled(sel_rect),
                        fill=to_backend_fill(node.fill),
                        radii=_zero_radii(),
                        mode=SdfMode.sdfModeClipAA,
                        factor=4.0,
                        spread=0.0,
                        shape_size=vec2(0, 0),
                    )

        _draw_decorations(ctx, layout)

        loader = getattr(ctx, "glyph_loader", None)
        for g in layout.arranged_glyphs:
            if g.is_whitespace:
                continue
            # glyph raster offsets are already in physical px (FontId folds in
            # ui scale), so only the pen position (and the GPOS mark-anchor
            # offset, in logical px) scales
            glyph_pos = vec2(
                scaled(g.pos.x + g.offset.x) + g.image_offset.x,
                scaled(g.pos.y + g.offset.y) + g.image_offset.y,
            )
            subpixel_shift = 0.0
            variant = 0
            if subpixel:
                snapped = math.floor(glyph_pos.x)
                frac = max(0.0, min(glyph_pos.x - snapped, 0.999))
                glyph_pos = vec2(snapped, glyph_pos.y)
                if variant_subpixel:
                    variant = to_glyph_variant_subpixel_step(frac)
                else:
                    subpixel_shift = frac
            key = glyph_hash(g.font_id, g.glyph_id, lcd, variant)
            ctx.set_text_subpixel_shift(subpixel_shift)
            if not ctx.has_image(key):
                if loader is None or not loader(key, g, lcd, variant):
                    ctx.set_text_subpixel_shift(0.0)
                    continue
            offset = _glyph_image_offset(ctx, key, g)
            ctx.draw_image(
                key,
                pos=vec2(glyph_pos.x + offset.x, glyph_pos.y + offset.y),
                colors=_glyph_colors(g),
                size=vec2(0, 0),
                flip_y=False,
            )
            if subpixel:
                ctx.set_text_subpixel_shift(0.0)
    finally:
        ctx.set_text_subpixel_shift(0.0)
        ctx.restore_transform()


def _glyph_image_offset(ctx, key, g: ArrangedGlyph) -> Vec2:
    offsets = getattr(ctx, "glyph_offsets", None)
    if offsets is not None and key in offsets:
        ox, oy = offsets[key]
        # image_offset already baked into glyph_pos via g.image_offset when the
        # arrangement carries it; raster offsets win when present
        if g.image_offset.x == 0.0 and g.image_offset.y == 0.0:
            return vec2(ox, oy)
    return vec2(0, 0)


def _glyph_colors(g: ArrangedGlyph):
    """Span fill as 4 vertex colors — gradients tint glyphs exactly like
    rect quads (figrender.nim:494: drawImage(..., fill.gradientColors()))."""
    from ..backend import gradient_colors, to_backend_fill

    if g.fill is None:
        c = ColorRGBA(0, 0, 0, 255)
        return (c, c, c, c)
    return gradient_colors(to_backend_fill(g.fill))


def _zero_radii():
    from ..basics import CornerRadii2D

    return CornerRadii2D()


def _draw_decorations(ctx, layout: GlyphArrangement) -> None:
    """Underline / strikethrough bands per span+line (figrender.nim:370-415)."""
    for span_index, (s, e) in enumerate(layout.spans):
        if span_index >= len(layout.fonts):
            break
        gf = layout.fonts[span_index]
        if not (gf.underline or gf.strikethrough):
            continue
        color = (
            layout.span_colors[span_index]
            if span_index < len(layout.span_colors)
            else None
        )
        if color is None:
            continue
        thickness = max(round(gf.size / 16.0), 1.0)
        for line_s, line_e in layout.lines:
            start = max(s, line_s)
            stop = min(e, line_e)
            if start > stop:
                continue
            min_x = min_y = float("inf")
            max_x = max_y = float("-inf")
            for gi in range(start, stop + 1):
                r = layout.glyph_rect(gi)
                min_x = min(min_x, r.x)
                max_x = max(max_x, r.x + r.w)
                min_y = min(min_y, r.y)
                max_y = max(max_y, r.y + r.h)
            if min_x < max_x and min_y < max_y:
                if gf.underline:
                    _decoration_rect(
                        ctx, rect(min_x, max_y - thickness * 1.5, max_x - min_x, thickness), color
                    )
                if gf.strikethrough:
                    _decoration_rect(
                        ctx,
                        rect(
                            min_x,
                            min_y + (max_y - min_y) * 0.5 - thickness * 0.5,
                            max_x - min_x,
                            thickness,
                        ),
                        color,
                    )


def _decoration_rect(ctx, decoration: Rect, color) -> None:
    if decoration.w <= 0 or decoration.h <= 0:
        return
    ctx.draw_rounded_rect_sdf(
        rect=scaled(decoration),
        fill=to_backend_fill(color),
        radii=_zero_radii(),
        mode=SdfMode.sdfModeClipAA,
        factor=4.0,
        spread=0.0,
        shape_size=vec2(0, 0),
    )
