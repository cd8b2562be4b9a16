"""Host-side glyph rasterization: font outlines → anti-aliased coverage
(figdraw_tpu/text/raster.py, copied).

Glyph outlines come from the port's OpenType reader as pen value lists
(text/otf.py glyph_path), are flattened to polygons in pixel space and
filled with a nonzero-winding scanline rasterizer (4x vertical subsampling +
analytic horizontal span coverage). Output is a white RGBA image whose alpha
is coverage, tinted by vertex color at draw time like the reference
renderer's white-paint glyphs. numpy only, in the JAX package's order of
operations, so the atlas bytes are the same.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from .typefaces import FontGlyphId, Typeface

CURVE_STEPS = 12
SUBSAMPLES = 4
PAD = 2


def _flatten_path(path_ops, scale: float, subpixel_shift: float = 0.0) -> List[np.ndarray]:
    """RecordingPen ops (font units, y-up) → closed polygons (px, y-down)."""
    polys: List[np.ndarray] = []
    current: List[Tuple[float, float]] = []
    start = (0.0, 0.0)
    pos = (0.0, 0.0)

    def to_px(pt):
        return (pt[0] * scale + subpixel_shift, -pt[1] * scale)

    def close():
        nonlocal current
        if len(current) >= 3:
            polys.append(np.asarray(current, dtype=np.float64))
        current = []

    for op, args in path_ops:
        if op == "moveTo":
            close()
            pos = to_px(args[0])
            start = pos
            current = [pos]
        elif op == "lineTo":
            pos = to_px(args[0])
            current.append(pos)
        elif op == "qCurveTo":
            pts = [to_px(p) for p in args if p is not None]
            if args and args[-1] is None:
                # TrueType all-off-curve contour: close with implied points
                pts.append(current[0] if current else pos)
            # expand implied on-curve midpoints between consecutive off-points
            p0 = pos
            expanded = []
            for i in range(len(pts) - 1):
                c = pts[i]
                nxt = pts[i + 1]
                if i < len(pts) - 2:
                    end = ((c[0] + nxt[0]) / 2.0, (c[1] + nxt[1]) / 2.0)
                else:
                    end = nxt
                expanded.append((c, end))
            if not expanded and pts:
                expanded = [(pts[0], pts[0])]
            for c, end in expanded:
                for step in range(1, CURVE_STEPS + 1):
                    t = step / CURVE_STEPS
                    it = 1.0 - t
                    x = it * it * p0[0] + 2 * it * t * c[0] + t * t * end[0]
                    y = it * it * p0[1] + 2 * it * t * c[1] + t * t * end[1]
                    current.append((x, y))
                p0 = end
            pos = p0
        elif op == "curveTo":
            pts = [to_px(p) for p in args]
            p0 = pos
            # cubic segments in groups of 3
            for i in range(0, len(pts) - 2, 3):
                c1, c2, end = pts[i], pts[i + 1], pts[i + 2]
                for step in range(1, CURVE_STEPS + 1):
                    t = step / CURVE_STEPS
                    it = 1.0 - t
                    x = (it ** 3) * p0[0] + 3 * it * it * t * c1[0] + 3 * it * t * t * c2[0] + (t ** 3) * end[0]
                    y = (it ** 3) * p0[1] + 3 * it * it * t * c1[1] + 3 * it * t * t * c2[1] + (t ** 3) * end[1]
                    current.append((x, y))
                p0 = end
            pos = p0
        elif op == "closePath":
            close()
    close()
    return polys


def _fill_polygons(polys: List[np.ndarray], width: int, height: int) -> np.ndarray:
    """Nonzero-winding scanline fill with vertical subsampling."""
    coverage = np.zeros((height, width), dtype=np.float64)
    if not polys:
        return coverage
    edges = []
    for poly in polys:
        a = poly
        b = np.roll(poly, -1, axis=0)
        edges.append(np.concatenate([a, b], axis=1))  # x0 y0 x1 y1
    e = np.concatenate(edges, axis=0)
    x0, y0, x1, y1 = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
    non_horizontal = y0 != y1
    x0, y0, x1, y1 = x0[non_horizontal], y0[non_horizontal], x1[non_horizontal], y1[non_horizontal]
    winding = np.where(y1 > y0, 1, -1)
    ymin = np.minimum(y0, y1)
    ymax = np.maximum(y0, y1)
    inv_dy = 1.0 / (y1 - y0)

    sub_w = 1.0 / SUBSAMPLES
    for row in range(height):
        for sub in range(SUBSAMPLES):
            y = row + (sub + 0.5) * sub_w
            hit = (ymin <= y) & (y < ymax)
            if not hit.any():
                continue
            xs = x0[hit] + (y - y0[hit]) * (x1[hit] - x0[hit]) * inv_dy[hit]
            ws = winding[hit]
            order = np.argsort(xs, kind="stable")
            xs = xs[order]
            ws = ws[order]
            wind = np.cumsum(ws)
            inside = wind != 0
            # spans: xs[i] .. xs[i+1] where inside[i]
            for i in np.nonzero(inside[:-1])[0] if len(xs) > 1 else []:
                a = xs[i]
                b = xs[i + 1]
                if b <= 0 or a >= width or b <= a:
                    continue
                a = max(a, 0.0)
                b = min(b, float(width))
                ia, ib = int(a), min(int(b), width - 1)
                if ia == ib:
                    coverage[row, ia] += (b - a) * sub_w
                else:
                    coverage[row, ia] += (ia + 1 - a) * sub_w
                    if ia + 1 <= ib - 1:
                        coverage[row, ia + 1 : ib] += sub_w
                    coverage[row, ib] += (b - ib) * sub_w
    return np.clip(coverage, 0.0, 1.0)


def rasterize_glyph(
    typeface: Typeface,
    glyph_id: FontGlyphId,
    size: float,
    subpixel_shift: float = 0.0,
    lcd_filtering: bool = False,
    variations=(),
) -> Optional[Tuple[np.ndarray, Tuple[float, float]]]:
    """Returns (rgba image, image_offset) or None for empty glyphs.

    image_offset is the raster origin relative to the baseline pen position
    (ArrangedGlyph.imageOffset semantics, fonttypes.nim:96).
    """
    path_ops = typeface.glyph_path(glyph_id, variations)
    if not path_ops:
        return None
    scale = typeface.scale_for(size)
    polys = _flatten_path(path_ops, scale, 0.0)
    if not polys:
        return None
    all_pts = np.concatenate(polys, axis=0)
    xmin = math.floor(all_pts[:, 0].min()) - PAD
    ymin = math.floor(all_pts[:, 1].min()) - PAD
    xmax = math.ceil(all_pts[:, 0].max()) + PAD
    ymax = math.ceil(all_pts[:, 1].max()) + PAD
    width = max(1, xmax - xmin)
    height = max(1, ymax - ymin)
    shifted = [p - np.asarray([[xmin - subpixel_shift, ymin]]) for p in polys]
    coverage = _fill_polygons(shifted, width, height)
    if lcd_filtering:
        # FreeType-style 5-tap LCD filter applied per subpixel channel
        # (pixie_raster.nim:12-43); we approximate on the coverage plane.
        kernel = np.asarray([0.08, 0.24, 0.36, 0.24, 0.08])
        coverage = np.apply_along_axis(
            lambda r: np.convolve(r, kernel, mode="same"), 1, coverage
        )
    img = np.zeros((height, width, 4), dtype=np.float32)
    img[..., 0:3] = 1.0
    img[..., 3] = coverage.astype(np.float32)
    return img, (float(xmin), float(ymin))
