"""Text typesetting: spans → GlyphArrangement (figdraw_tpu/text/layout.py,
copied).

The GlyphArrangement model, the typeset dispatch and the line layout with
baselineOffset = round((ascent + lineGap/2)·scale). Shaping runs through the
OpenType shaper (text/shaper.py: full GSUB/GPOS lookup coverage, per-font
features/variations/language) with UAX#9 bidi reordering (text/bidi.py);
wrapping is greedy word wrap with CJK break-anywhere.

Pure host-side geometry — the device only ever sees the resulting glyph
quads.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from ..fill import Fill
from ..geometry import Rect, Vec2, rect, vec2
from .typefaces import (
    FigFont,
    FontGlyphId,
    FontId,
    TypefaceId,
    apply_font_case,
    get_typeface,
    register_font,
)


class HAlign:
    Left = 0
    Center = 1
    Right = 2


class VAlign:
    Top = 0
    Middle = 1
    Bottom = 2


@dataclass
class GlyphFont:
    """Per-span font info carried by the arrangement (fontglyphs parity)."""

    font_id: FontId
    font: FigFont
    size: float
    ascent: float  # px
    descent: float  # px, positive
    line_gap: float  # px
    line_height: float  # px
    baseline_offset: float  # px from line top to baseline
    underline: bool = False
    strikethrough: bool = False

    @property
    def typeface_id(self):
        return self.font.typeface_id


@dataclass
class GlyphSourceRange:
    rune_start: int
    rune_end: int


@dataclass
class ArrangedGlyph:
    """fonttypes.nim:86-98."""

    font_id: FontId
    glyph_id: FontGlyphId
    cluster: int
    source: GlyphSourceRange
    rune: str
    is_whitespace: bool
    pos: Vec2  # baseline pen position (local px)
    advance: Vec2
    offset: Vec2 = field(default_factory=Vec2)
    image_offset: Vec2 = field(default_factory=Vec2)  # raster origin rel. baseline
    rect: Rect = field(default_factory=Rect)  # local bounding rect (top-left + size)
    span_index: int = 0
    line_index: int = 0
    fill: Optional[Fill] = None


@dataclass
class GlyphArrangement:
    """fonttypes.nim:99-112 (glyph-id-first placement)."""

    content_hash: int = 0
    lines: List[Tuple[int, int]] = field(default_factory=list)  # inclusive glyph slices
    spans: List[Tuple[int, int]] = field(default_factory=list)
    fonts: List[GlyphFont] = field(default_factory=list)
    span_colors: List[Fill] = field(default_factory=list)
    source_runes: List[str] = field(default_factory=list)
    arranged_glyphs: List[ArrangedGlyph] = field(default_factory=list)
    max_size: Vec2 = field(default_factory=Vec2)
    min_size: Vec2 = field(default_factory=Vec2)
    bounding: Rect = field(default_factory=Rect)
    bidi_levels: List[int] = field(default_factory=list)  # per source rune
    bidi_bases: List[int] = field(default_factory=list)  # paragraph base levels

    def glyph_rect(self, index: int) -> Rect:
        return self.arranged_glyphs[index].rect

    # --- source-aware selection / caret APIs (fonttypes.nim:430-808) ----------

    def glyph_range_for(self, rune_range) -> Tuple[int, int]:
        """Glyph index range covering source runes [a, b] inclusive."""
        a, b = (rune_range.start, rune_range.stop - 1) if isinstance(rune_range, range) else rune_range
        lo, hi = None, None
        for i, g in enumerate(self.arranged_glyphs):
            if g.source.rune_end > a and g.source.rune_start <= b:
                if lo is None:
                    lo = i
                hi = i
        if lo is None:
            return (0, -1)
        return (lo, hi)

    # --- reference-exact selection band machinery (fonttypes.nim:440-654) ------

    def _lines_or_all(self) -> List[Tuple[int, int]]:
        if self.lines:
            return self.lines
        n = len(self.arranged_glyphs)
        return [(0, n - 1)] if n else []

    def _line_for_glyph(self, glyph_index: int) -> Tuple[int, int]:
        for line in self.lines:
            if line[0] <= glyph_index <= line[1]:
                return line
        return (0, len(self.arranged_glyphs) - 1)

    def _line_index_for_glyph(self, glyph_index: int) -> int:
        for li, line in enumerate(self.lines):
            if line[0] <= glyph_index <= line[1]:
                return li
        return 0

    def _selection_line_box(self, line: Tuple[int, int]) -> Rect:
        """Vertical extent of a line = union of its glyph rects
        (selectionLineBox, fonttypes.nim:367-382)."""
        s, e = line
        if e < s:
            return rect(0, 0, 0, 0)
        min_y = min(self.arranged_glyphs[i].rect.y for i in range(s, e + 1))
        max_y = max(
            self.arranged_glyphs[i].rect.y + self.arranged_glyphs[i].rect.h
            for i in range(s, e + 1)
        )
        return rect(0, min_y, 0, max(max_y - min_y, 0.0))

    def _selected_glyph_rect(self, glyph_index: int, sel_start: int,
                             sel_end: int) -> Rect:
        """Cluster rect clipped to the selected fraction of the glyph's
        source range — partial ligature selections highlight only the
        corresponding slice, from the right edge for RTL glyphs
        (selectedGlyphRectForRange, fonttypes.nim:526-560)."""
        src = self.arranged_glyphs[glyph_index].source
        cs = max(sel_start, src.rune_start)
        ce = min(sel_end, src.rune_end)
        if ce <= cs or src.rune_end <= src.rune_start:
            return rect(0, 0, 0, 0)
        r = self.cluster_rect(glyph_index)
        min_x = min(r.x, r.x + r.w)
        max_x = max(r.x, r.x + r.w)
        width = max_x - min_x
        n = max(src.rune_end - src.rune_start, 1)
        t0 = max(0.0, min((cs - src.rune_start) / n, 1.0))
        t1 = max(0.0, min((ce - src.rune_start) / n, 1.0))
        if self._glyph_appears_rtl(glyph_index):
            x0 = max_x - width * t0
            x1 = max_x - width * t1
        else:
            x0 = min_x + width * t0
            x1 = min_x + width * t1
        return rect(min(x0, x1), r.y, abs(x1 - x0), r.h)

    def selection_rects_for(self, rune_range) -> List[Rect]:
        """Per-line merged visual selection bands (fonttypes.nim:609-654):
        contiguous selected glyphs merge into one band spanning the line's
        vertical extent; an unselected glyph in between SPLITS the band
        (separated bidi fragments yield separate rects); partial ligature
        coverage clips the band to the selected fraction."""
        a, b = (rune_range.start, rune_range.stop - 1) if isinstance(rune_range, range) else rune_range
        if a > b:
            return []
        sel_start = max(a, 0)
        sel_end = b + 1
        if sel_end <= sel_start:
            return []
        out: List[Rect] = []
        for line in self._lines_or_all():
            s, e = line
            n = len(self.arranged_glyphs)
            s, e = max(s, 0), min(e, n - 1)
            if s > e:
                continue
            line_box = self._selection_line_box((s, e))
            band = None  # (min_x, max_x)
            # the reference stores glyphs in visual order (HarfBuzz output);
            # our storage is logical with visual rects — walk by visual x so
            # "an unselected glyph in between" means VISUALLY in between
            visual = sorted(
                range(s, e + 1),
                key=lambda i: min(self.arranged_glyphs[i].rect.x,
                                  self.arranged_glyphs[i].rect.x
                                  + self.arranged_glyphs[i].rect.w),
            )
            for i in visual:
                src = self.arranged_glyphs[i].source
                if src.rune_end > sel_start and src.rune_start < sel_end:
                    r = self._selected_glyph_rect(i, sel_start, sel_end)
                    gx0 = min(r.x, r.x + r.w)
                    gx1 = max(r.x, r.x + r.w)
                    if band is None:
                        band = (gx0, gx1)
                    else:
                        band = (min(band[0], gx0), max(band[1], gx1))
                elif band is not None:
                    out.append(rect(band[0], line_box.y, band[1] - band[0],
                                    line_box.h))
                    band = None
            if band is not None:
                out.append(rect(band[0], line_box.y, band[1] - band[0],
                                line_box.h))
        return out

    def selection_bands_for(self, rune_range) -> List[Rect]:
        """Alias matching the reference API (selectionBandsFor)."""
        return self.selection_rects_for(rune_range)

    def _byte_to_rune_range(self, byte_range) -> Tuple[int, int]:
        """Map an inclusive UTF-8 byte range onto the inclusive rune range it
        touches (sskBytes selections, fonttypes.nim:347-356)."""
        a, b = (byte_range.start, byte_range.stop - 1) if isinstance(byte_range, range) else byte_range
        lo = hi = None
        off = 0
        for i, r in enumerate(self.source_runes):
            w = len(r.encode("utf-8"))
            if off + w > a and off <= b:
                if lo is None:
                    lo = i
                hi = i
            off += w
        if lo is None:
            return (0, -1)
        return (lo, hi)

    def selection_rects_for_raw_bytes(self, byte_range) -> List[Rect]:
        """Merged bands for a raw source-byte range
        (selectionRectsForRawBytes)."""
        return self.selection_rects_for(self._byte_to_rune_range(byte_range))

    def _line_top(self, line_index: int) -> float:
        y = 0.0
        heights = self._line_heights()
        for i in range(line_index):
            y += heights[i]
        return y

    def _line_heights(self) -> List[float]:
        heights = []
        for (s, e) in self.lines:
            if e >= s:
                gf = self.fonts[self.arranged_glyphs[s].span_index]
                heights.append(gf.line_height)
            elif self.fonts:
                heights.append(self.fonts[0].line_height)
            else:
                heights.append(0.0)
        return heights

    def caret_positions_for(self, source_rune: int) -> List["TextCaretPosition"]:
        """Visual caret position(s) at a source insertion index
        (fonttypes.nim:718-785): bidi boundaries can produce more than one —
        the leading edge in one directional run and the trailing edge in the
        other, each on its glyph's visual side (caretX, :696-706)."""
        if not self.arranged_glyphs:
            if source_rune == 0:
                return [TextCaretPosition(0, -1, 0, vec2(0, 0),
                                          rect(0, 0, 1, 0))]
            return []

        def caret_x(r: Rect, rtl: bool, source_start: bool) -> float:
            if source_start:
                return r.x + r.w if rtl else r.x
            return r.x if rtl else r.x + r.w

        out: List[TextCaretPosition] = []

        def add(c: TextCaretPosition) -> None:
            for e in out:
                if (e.line_index == c.line_index
                        and abs(e.pos.x - c.pos.x) < 1e-3
                        and abs(e.pos.y - c.pos.y) < 1e-3):
                    return
            out.append(c)

        for i, g in enumerate(self.arranged_glyphs):
            src = g.source
            r = self.cluster_rect(i)
            rtl = self._glyph_appears_rtl(i)
            line_index = self._line_index_for_glyph(i)
            if src.rune_start == source_rune:
                x = caret_x(r, rtl, True)
                add(TextCaretPosition(source_rune, i, line_index,
                                      vec2(x, r.y), rect(x, r.y, 1.0, r.h),
                                      affinity="leading"))
            if src.rune_end == source_rune:
                x = caret_x(r, rtl, False)
                add(TextCaretPosition(source_rune, i, line_index,
                                      vec2(x, r.y), rect(x, r.y, 1.0, r.h),
                                      affinity="trailing"))
            if src.rune_start < source_rune < src.rune_end:
                t = (source_rune - src.rune_start) / max(
                    src.rune_end - src.rune_start, 1
                )
                x = r.x + r.w * ((1.0 - t) if rtl else t)
                add(TextCaretPosition(source_rune, i, line_index,
                                      vec2(x, r.y), rect(x, r.y, 1.0, r.h),
                                      affinity="inside"))
        return out

    def glyph_selection_rects_for(self, rune_range) -> List[Rect]:
        """Raw rects of the glyphs whose source INTERSECTS the range —
        unmerged, and skipping non-intersecting glyphs that merely sit
        between the endpoints visually (glyphSelectionRectsFor,
        fonttypes.nim:485-507)."""
        a, b = (rune_range.start, rune_range.stop - 1) if isinstance(rune_range, range) else rune_range
        if a > b:
            return []
        sel_start = max(a, 0)
        sel_end = b + 1
        return [
            g.rect for g in self.arranged_glyphs
            if g.source.rune_end > sel_start and g.source.rune_start < sel_end
        ]

    def glyph_index_at(self, point: Vec2) -> int:
        """Glyph index at a local layout point, or -1 (glyphIndexAt,
        fonttypes.nim:668-682)."""
        for i, g in enumerate(self.arranged_glyphs):
            r = g.rect
            if r.x <= point.x < r.x + r.w and r.y <= point.y < r.y + r.h:
                return i
        return -1

    def source_rune_range_at(self, where) -> Tuple[int, int]:
        """Source rune range [start, end) that produced a glyph, addressed by
        glyph index or by a local point (sourceRuneRangeAt,
        fonttypes.nim:684-706)."""
        glyph_index = (
            self.glyph_index_at(where) if isinstance(where, Vec2) else where
        )
        if not (0 <= glyph_index < len(self.arranged_glyphs)):
            return (0, 0)
        src = self.arranged_glyphs[glyph_index].source
        return (src.rune_start, src.rune_end)

    def _cluster_glyph_range(self, glyph_index: int) -> Tuple[int, int]:
        """Adjacent glyphs on the same line sharing the glyph's exact source
        range — the shaped-cluster fragments of one source cluster
        (clusterGlyphRangeForGlyph, fonttypes.nim:448-461)."""
        line_a, line_b = self._line_for_glyph(glyph_index)
        src = self.arranged_glyphs[glyph_index].source
        a = b = glyph_index

        def same(i):
            o = self.arranged_glyphs[i].source
            return (o.rune_start == src.rune_start
                    and o.rune_end == src.rune_end)

        while a > line_a and same(a - 1):
            a -= 1
        while b < line_b and same(b + 1):
            b += 1
        return (a, b)

    def cluster_rect(self, glyph_index: int) -> Rect:
        """Bounding rect of the whole shaped cluster containing a glyph
        (clusterRectForGlyph, fonttypes.nim:463-483)."""
        if not (0 <= glyph_index < len(self.arranged_glyphs)):
            return rect(0, 0, 0, 0)
        a, b = self._cluster_glyph_range(glyph_index)
        rects = [self.arranged_glyphs[i].rect for i in range(a, b + 1)]
        min_x = min(min(r.x, r.x + r.w) for r in rects)
        min_y = min(r.y for r in rects)
        max_x = max(max(r.x, r.x + r.w) for r in rects)
        max_y = max(r.y + r.h for r in rects)
        return rect(min_x, min_y, max_x - min_x, max_y - min_y)

    def _glyph_appears_rtl(self, glyph_index: int) -> bool:
        """Visual-order RTL detection: a glyph appears RTL when its line
        neighbors' source positions run backwards (glyphAppearsRtl,
        fonttypes.nim:430-442); falls back to the resolved bidi level when
        the neighbors are inconclusive (single-glyph runs)."""
        line_a, line_b = self._line_for_glyph(glyph_index)
        src = self.arranged_glyphs[glyph_index].source
        if glyph_index > line_a:
            prev = self.arranged_glyphs[glyph_index - 1].source
            if prev.rune_start > src.rune_start:
                return True
        if glyph_index < line_b:
            nxt = self.arranged_glyphs[glyph_index + 1].source
            if nxt.rune_start < src.rune_start:
                return True
        if line_a == line_b:
            return self.is_rtl_at(glyph_index)
        return False

    def is_rtl_at(self, glyph_index: int) -> bool:
        """RTL at a glyph = odd resolved bidi level (fonttypes.nim:430-442;
        levels from text/bidi.py's UAX#9 pass); codepoint-block heuristic
        when levels are absent (place_glyphs arrangements)."""
        if not (0 <= glyph_index < len(self.arranged_glyphs)):
            return False
        g = self.arranged_glyphs[glyph_index]
        if self.bidi_levels and g.source.rune_start < len(self.bidi_levels):
            return self.bidi_levels[g.source.rune_start] % 2 == 1
        cp = ord(g.rune[0]) if g.rune else 0
        return (
            0x0590 <= cp <= 0x08FF
            or 0xFB1D <= cp <= 0xFDFF
            or 0xFE70 <= cp <= 0xFEFF
            or 0x10800 <= cp <= 0x10FFF
        )

    def nearest_source_rune_for_caret_point(self, point: Vec2) -> int:
        """Closest insertion index to a local point, measured against every
        caret position of every source index — vertical distance counts only
        outside the caret's line extent (nearestSourceRuneForCaretPoint,
        fonttypes.nim:787-808)."""
        n_src = len(self.source_runes) if self.source_runes else len(
            self.arranged_glyphs
        )
        best = 0
        best_d = float("inf")
        for source_rune in range(n_src + 1):
            for caret in self.caret_positions_for(source_rune):
                dx = point.x - caret.pos.x
                if point.y < caret.rect.y:
                    dy = caret.rect.y - point.y
                elif point.y > caret.rect.y + caret.rect.h:
                    dy = point.y - (caret.rect.y + caret.rect.h)
                else:
                    dy = 0.0
                d = dx * dx + dy * dy
                if d < best_d:
                    best_d = d
                    best = source_rune
        return best


@dataclass
class TextCaretPosition:
    source_rune: int
    glyph_index: int
    line_index: int
    pos: Vec2
    rect: Rect
    affinity: str = "inside"  # "leading" | "trailing" | "inside"


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return (
        0x1100 <= cp <= 0x11FF
        or 0x2E80 <= cp <= 0x9FFF
        or 0xAC00 <= cp <= 0xD7AF
        or 0xF900 <= cp <= 0xFAFF
        or 0xFF00 <= cp <= 0xFFEF
        or 0x20000 <= cp <= 0x3FFFF
    )


def _glyph_font(font: FigFont, ui_scale: float) -> GlyphFont:
    tf = get_typeface(font.typeface_id)
    size = font.size * ui_scale
    s = tf.scale_for(size)
    ascent = tf.ascent * s
    descent = -tf.descent * s
    line_gap = tf.line_gap * s
    line_height = (
        font.line_height * ui_scale if font.line_height > 0
        else (ascent + descent + line_gap)
    )
    # pixie.nim:41-42 baseline formula
    baseline = round(ascent + line_gap / 2)
    return GlyphFont(
        font_id=register_font(font, ui_scale),
        font=font,
        size=size,
        ascent=ascent,
        descent=descent,
        line_gap=line_gap,
        line_height=line_height,
        baseline_offset=baseline,
        underline=font.underline,
        strikethrough=font.strikethrough,
    )


def typeset(
    bounds: Vec2,
    spans: Sequence[Tuple[FigFont, Fill, str]],
    h_align: int = HAlign.Left,
    v_align: int = VAlign.Top,
    wrap: bool = True,
    ui_scale: float = 1.0,
) -> GlyphArrangement:
    """Layout spans into lines within bounds (fontutils.nim:45-123)."""
    arr = GlyphArrangement()
    arr.content_hash = hash(
        (tuple((id(f), str(c), t) for f, c, t in spans), bounds.x, bounds.y,
         h_align, v_align, wrap)
    )

    glyphs: List[ArrangedGlyph] = []
    source_index = 0

    # --- bidi analysis over the full logical text (UAX#9, text/bidi.py) ----------
    from . import bidi as bidi_mod
    from . import shaper as shaper_mod
    from .shaper import DEFAULT_GSUB_FEATURES, get_shaper, ot_language_tag

    span_texts = [apply_font_case(t, f.font_case) for f, _c, t in spans]
    full_text = "".join(span_texts)
    if full_text.isascii():
        # ASCII has no RTL/AL characters: every level resolves to 0 in an
        # LTR paragraph — skip the UAX#9 pass entirely (hot-path win)
        levels = [0] * len(full_text)
        bases = [0] * len(full_text)
    else:
        levels, bases = bidi_mod.compute_levels(full_text) if full_text else ([], [])
    arr.bidi_levels = levels
    arr.bidi_bases = bases
    any_rtl = any(l % 2 for l in levels)

    # --- shape all spans into a flat glyph run (logical order) -------------------
    resolved_extra: List[TypefaceId] = []  # typefaces added by the dynamic
    resolver_misses: set = set()           # resolver this typeset (memoized)
    for span_index, (font, color_fill, text) in enumerate(spans):
        gf = _glyph_font(font, ui_scale)
        arr.fonts.append(gf)
        arr.span_colors.append(color_fill)
        tf = get_typeface(font.typeface_id)
        s = tf.scale_for(gf.size)
        span_start = len(glyphs)
        shaped = span_texts[span_index]
        feats = frozenset(
            (set(DEFAULT_GSUB_FEATURES)
             | {f.tag for f in font.features if f.value})
            - {f.tag for f in font.features if not f.value}
        )

        # per-char resolution: mirrored lookup codepoint (L4) + font fallback
        # (fontfallbacks.nim:4-25; harfbuzzy.nim:319-394)
        records = []  # (src, ch, cp, tf_resolved, font_id, adv_scale)
        for ch in shaped:
            arr.source_runes.append(ch)
            src = source_index
            source_index += 1
            if ch == "\n":
                records.append((src, ch, 0, None, gf.font_id, s))
                continue
            cp = ord(ch)
            if any_rtl and levels[src] % 2:
                cp = ord(bidi_mod.mirror_char(ch))
            glyph_font_id = gf.font_id
            rtf = tf
            adv_scale = s
            if tf.glyph_id(cp) == 0:
                fb_chain = list(font.fallback_typeface_ids) + resolved_extra
                hit = None
                for fb_id in fb_chain:
                    if get_typeface(fb_id).has_codepoint(cp):
                        hit = fb_id
                        break
                if hit is None and cp not in resolver_misses:
                    # dynamic resolver (fontfallbacks.nim:17-25): ask the
                    # installed per-thread callback for more typefaces
                    from .typefaces import (
                        font_fallback_resolver, FontFallbackRequest,
                        script_of_codepoint,
                    )

                    resolver = font_fallback_resolver()
                    if resolver is not None:
                        req = FontFallbackRequest(
                            primary_typeface_id=font.typeface_id,
                            existing_typeface_ids=tuple(fb_chain),
                            language=font.language,
                            script=script_of_codepoint(cp),
                            codepoints=(cp,),
                        )
                        for fb_id in resolver(req) or ():
                            if fb_id not in fb_chain:
                                resolved_extra.append(fb_id)
                                fb_chain.append(fb_id)
                            if hit is None and get_typeface(fb_id).has_codepoint(cp):
                                hit = fb_id
                    if hit is None:
                        resolver_misses.add(cp)
                if hit is not None:
                    fb_tf = get_typeface(hit)
                    fb_font = FigFont(
                        typeface_id=hit, size=font.size,
                        line_height=font.line_height, font_case=font.font_case,
                    )
                    glyph_font_id = register_font(fb_font, ui_scale)
                    adv_scale = fb_tf.scale_for(gf.size)
                    rtf = fb_tf
            records.append((src, ch, cp, rtf, glyph_font_id, adv_scale))

        # segment by resolved font; shape each segment through the OpenType
        # mini-shaper (GSUB liga/ccmp + GPOS kern — text/shaper.py) when the
        # face carries the tables, else 1:1 cmap with kern-table kerning
        i = 0
        while i < len(records):
            src, ch, cp, rtf, rfid, rs = records[i]
            if ch == "\n":
                glyphs.append(ArrangedGlyph(
                    font_id=rfid, glyph_id=0, cluster=src,
                    source=GlyphSourceRange(src, src + 1),
                    rune=ch, is_whitespace=True, pos=vec2(0, 0),
                    advance=vec2(0, 0), span_index=span_index, fill=color_fill,
                ))
                i += 1
                continue
            j = i
            while j < len(records) and records[j][1] != "\n" and records[j][4] == rfid:
                j += 1
            seg = records[i:j]
            names = [rtf.glyph_name(rtf.glyph_id(r[2])) for r in seg]
            clusters = [(r[0], r[0] + 1) for r in seg]
            ligc = None  # per-glyph (lig_size, attach_comp) for GPOS 5
            shaper = get_shaper(rtf)
            if shaper is not None:
                # cps routes Arabic runs through the staged positional
                # pipeline (masked isol/fina/medi/init stages)
                names, clusters, ligc = shaper.substitute_ex(
                    names, clusters, feats, ot_language_tag(font.language),
                    cps=[r[2] for r in seg],
                )
            elif any(r[2] in shaper_mod.THAI_SARA_AM for r in seg):
                # HarfBuzz's Thai SARA AM preprocess is table-independent:
                # apply it even for fonts with no GSUB/GPOS (no shaper)
                names, clusters, _ = shaper_mod.thai_sara_am_preprocess(
                    names, clusters, [r[2] for r in seg],
                    lambda cp: (rtf.glyph_name(rtf.glyph_id(cp))
                                if rtf.glyph_id(cp) else None),
                )
            use_gpos = shaper is not None and shaper.has_gpos_kern
            gpos_deltas = None
            if use_gpos and not font.no_kerning_adjustments:
                # full GPOS kerning pass: single/pair/contextual lookups with
                # flag skipping (shaper.position)
                gpos_deltas = shaper.position(names)
            cursive = shaper.cursive_chain(names) if shaper is not None else None
            prev_name = None
            base_name = None  # last non-mark glyph (GPOS mark attachment)
            base_lig_size = 1  # component count when the base is a ligature
            last_pen_glyph = None  # index of the glyph carrying the pen advance
            pen_since_base = 0.0
            prev_mark = None  # (name, offset) of the previous ATTACHED mark
            for out_i, (name, (cs, ce)) in enumerate(zip(names, clusters)):
                gid = rtf._name_to_gid.get(name, 0)
                if font.variations and rtf is tf:
                    adv = rtf.var_advance(gid, font.variations) * rs
                else:
                    adv = rtf.advance(gid) * rs
                rune = full_text[cs]
                # GPOS mark-to-base / mark-to-mark: anchor combining marks on
                # their base instead of the pen position (GPOS 4/6). Offsets
                # are consumed by the LEFT-to-right draw sweep (glyphs.py):
                # in an LTR run the mark's cursor sits past the base's
                # advance, so the anchor delta subtracts pen_since_base; in
                # an RTL run the visual reversal puts the mark BEFORE its
                # base, its cursor already at the base's origin — the anchor
                # delta applies as-is.
                is_rtl = any_rtl and cs < len(levels) and levels[cs] % 2 == 1
                attach = None
                if shaper is not None and shaper.is_mark(name):
                    if prev_mark is not None:
                        delta = shaper.mark_attach_mark(prev_mark[0], name)
                        if delta is not None:
                            attach = vec2(
                                prev_mark[1].x + delta[0] * rs,
                                prev_mark[1].y - delta[1] * rs,
                            )
                    if attach is None and base_name is not None:
                        delta = None
                        if base_lig_size > 1:
                            # GPOS 5: the base is a ligature — anchor on the
                            # component this mark logically follows (tagged
                            # through ligation; untagged trailing marks take
                            # the last component)
                            comp = ligc[out_i][1] if ligc is not None else -1
                            delta = shaper.mark_attach_ligature(
                                base_name, name, comp
                            )
                        if delta is None:
                            delta = shaper.mark_attach(base_name, name)
                        if delta is not None:
                            attach = vec2(
                                delta[0] * rs
                                - (0.0 if is_rtl else pen_since_base),
                                -delta[1] * rs,
                            )
                curs_dy = 0.0
                if cursive is not None:
                    c_adv, c_dy = cursive
                    if c_adv[out_i] is not None:
                        adv = c_adv[out_i] * rs  # exit→entry advance (GPOS 3)
                    curs_dy = -c_dy[out_i] * rs  # font y-up → screen y-down
                if gpos_deltas is not None:
                    if attach is None and gpos_deltas[out_i]:
                        adv += gpos_deltas[out_i] * rs
                elif attach is None and prev_name is not None \
                        and not font.no_kerning_adjustments:
                    adv_kern = rtf.kerning(
                        rtf._name_to_gid.get(prev_name, 0), gid
                    ) * rs
                    if adv_kern and last_pen_glyph is not None:
                        g = glyphs[last_pen_glyph]
                        g.advance = vec2(g.advance.x + adv_kern, 0.0)
                        # no pen_since_base update: the current glyph is
                        # non-attached here and becomes the new base below,
                        # resetting pen_since_base before any mark reads it
                        # (C twin native/typeset.cpp position_core agrees)
                glyphs.append(ArrangedGlyph(
                    font_id=rfid, glyph_id=gid, cluster=cs,
                    source=GlyphSourceRange(cs, ce),
                    rune=rune, is_whitespace=rune.isspace(), pos=vec2(0, 0),
                    advance=vec2(0.0 if attach is not None else adv, 0.0),
                    offset=(attach if attach is not None
                            else vec2(0.0, curs_dy)),
                    span_index=span_index, fill=color_fill,
                ))
                if attach is not None:
                    prev_mark = (name, attach)
                else:
                    base_name = name
                    base_lig_size = ligc[out_i][0] if ligc is not None else 1
                    last_pen_glyph = len(glyphs) - 1
                    pen_since_base = adv
                    prev_mark = None
                    prev_name = name
            i = j
        arr.spans.append((span_start, len(glyphs) - 1))

    # --- line breaking ---------------------------------------------------------------
    lines: List[Tuple[int, int]] = []
    line_start = 0
    x = 0.0
    last_break = -1  # index of last breakable glyph in current line
    i = 0
    while i < len(glyphs):
        g = glyphs[i]
        if g.rune == "\n":
            lines.append((line_start, i))
            line_start = i + 1
            x = 0.0
            last_break = -1
            i += 1
            continue
        breakable = g.is_whitespace or _is_cjk(g.rune)
        if (
            wrap
            and bounds.x > 0
            and x + g.advance.x > bounds.x
            and i > line_start
            and not g.is_whitespace
        ):
            if last_break >= line_start:
                lines.append((line_start, last_break))
                line_start = last_break + 1
            else:
                lines.append((line_start, i - 1))
                line_start = i
            x = 0.0
            last_break = -1
            # reflow from the new line start
            i = line_start
            continue
        x += g.advance.x
        if breakable:
            last_break = i
        i += 1
    if line_start < len(glyphs):
        lines.append((line_start, len(glyphs) - 1))
    if not glyphs:
        lines = []
    arr.lines = lines
    arr.arranged_glyphs = glyphs

    # --- position glyphs ---------------------------------------------------------------
    y = 0.0
    max_line_w = 0.0
    for line_index, (s_i, e_i) in enumerate(lines):
        gf = arr.fonts[glyphs[s_i].span_index] if e_i >= s_i else (arr.fonts[0] if arr.fonts else None)
        line_h = gf.line_height if gf else 0.0
        baseline = y + (gf.baseline_offset if gf else 0.0)
        # measure (excluding trailing whitespace for alignment)
        line_w = 0.0
        visible_w = 0.0
        for i in range(s_i, e_i + 1):
            line_w += glyphs[i].advance.x
            if not glyphs[i].is_whitespace:
                visible_w = line_w
        if h_align == HAlign.Center:
            x = (bounds.x - visible_w) / 2.0 if bounds.x > 0 else 0.0
        elif h_align == HAlign.Right:
            x = bounds.x - visible_w if bounds.x > 0 else 0.0
        else:
            x = 0.0
        # visual order (bidi L1+L2) — glyph storage stays logical so the
        # selection/caret APIs keep logical indexing; only pen x order flips
        if any_rtl:
            line_levels = [
                arr.bidi_levels[glyphs[i].source.rune_start]
                for i in range(s_i, e_i + 1)
            ]
            line_types = [
                bidi_mod.char_type(full_text[glyphs[i].source.rune_start])
                for i in range(s_i, e_i + 1)
            ]
            para = arr.bidi_bases[glyphs[s_i].source.rune_start]
            order = bidi_mod.line_visual_order(line_levels, line_types, para)
        else:
            order = range(e_i - s_i + 1)
        for k in order:
            i = s_i + k
            g = glyphs[i]
            g.line_index = line_index
            g.pos = vec2(x, baseline)
            gfi = arr.fonts[g.span_index]
            g.rect = rect(x, y, g.advance.x, gfi.line_height)
            x += g.advance.x
        max_line_w = max(max_line_w, visible_w)
        y += line_h

    total_h = y
    if v_align != VAlign.Top and bounds.y > 0:
        dy = bounds.y - total_h
        if v_align == VAlign.Middle:
            dy /= 2.0
        if dy != 0:
            for g in glyphs:
                g.pos = vec2(g.pos.x, g.pos.y + dy)
                g.rect = rect(g.rect.x, g.rect.y + dy, g.rect.w, g.rect.h)

    arr.max_size = vec2(max_line_w, total_h)
    # min-content = widest unbreakable run (the reference's min-content
    # two-pass measurement, textbackends/pixie.nim:81-121)
    widest_word = 0.0
    word_w = 0.0
    for g in glyphs:
        if g.is_whitespace or g.rune == "\n" or _is_cjk(g.rune):
            widest_word = max(widest_word, word_w + (g.advance.x if _is_cjk(g.rune) else 0.0))
            word_w = 0.0
        else:
            word_w += g.advance.x
    widest_word = max(widest_word, word_w)
    arr.min_size = vec2(widest_word, total_h)
    arr.bounding = rect(0, 0, max_line_w, total_h)
    return arr


def typeset_for_measurement(spans, bounds=None, ui_scale: float = 1.0) -> GlyphArrangement:
    """Unbounded layout for content measurement (fontutils.nim:93-123)."""
    b = bounds if bounds is not None else vec2(0, 0)
    return typeset(b, spans, wrap=bounds is not None, ui_scale=ui_scale)


_typeset_cache: "OrderedDict" = None  # lazily created
_TYPESET_CACHE_CAP = 2048


def typeset_cached(
    bounds: Vec2,
    spans: Sequence[Tuple[FigFont, Fill, str]],
    h_align: int = HAlign.Left,
    v_align: int = VAlign.Top,
    wrap: bool = True,
    ui_scale: float = 1.0,
) -> GlyphArrangement:
    """LRU-cached typeset for frame loops: UI text rarely changes between
    frames, and the reference's GlyphArrangement carries a contentHash for
    exactly this reuse (fonttypes.nim:86). Arrangements are immutable after
    layout — share them across frames; do not mutate."""
    global _typeset_cache
    from collections import OrderedDict

    if _typeset_cache is None:
        _typeset_cache = OrderedDict()
    key = (
        tuple((f.typeface_id, f.size, f.line_height, f.font_case,
               f.no_kerning_adjustments, f.fallback_typeface_ids,
               f.features, f.variations, id(c), t) for f, c, t in spans),
        bounds.x, bounds.y, h_align, v_align, wrap, ui_scale,
    )
    hit = _typeset_cache.get(key)
    if hit is not None:
        _typeset_cache.move_to_end(key)
        return hit
    arr = typeset(bounds, spans, h_align, v_align, wrap, ui_scale)
    _typeset_cache[key] = arr
    if len(_typeset_cache) > _TYPESET_CACHE_CAP:
        _typeset_cache.popitem(last=False)
    return arr


class GlyphOrigin:
    TopLeft = 0
    Baseline = 1


def place_glyphs(
    font: FigFont,
    color_fill: Fill,
    glyphs: Sequence[Tuple[str, Vec2]],
    origin: int = GlyphOrigin.TopLeft,
    ui_scale: float = 1.0,
) -> GlyphArrangement:
    """Explicit per-glyph placement for monospace/grid renderers
    (fontutils.nim:125-244). Positions are glyph top-left or baseline points
    depending on `origin`."""
    arr = GlyphArrangement()
    if not glyphs:
        return arr
    gf = _glyph_font(font, ui_scale)
    tf = get_typeface(font.typeface_id)
    s = tf.scale_for(gf.size)
    arr.fonts.append(gf)
    arr.span_colors.append(color_fill)
    arr.spans.append((0, len(glyphs) - 1))
    baseline_offset = gf.baseline_offset
    content_hash = 0
    for glyph_index, (ch, pos) in enumerate(glyphs):
        gid = tf.glyph_id(ord(ch))
        advance = tf.advance(gid) * s
        baseline_pos = (
            vec2(pos.x, pos.y + baseline_offset)
            if origin == GlyphOrigin.TopLeft
            else pos
        )
        draw_pos = vec2(baseline_pos.x, baseline_pos.y - baseline_offset)
        selection = rect(draw_pos.x, draw_pos.y, advance, gf.line_height)
        arr.source_runes.append(ch)
        arr.arranged_glyphs.append(ArrangedGlyph(
            font_id=gf.font_id,
            glyph_id=gid,
            cluster=glyph_index,
            source=GlyphSourceRange(glyph_index, glyph_index + 1),
            rune=ch,
            is_whitespace=ch.isspace(),
            pos=baseline_pos,
            advance=vec2(advance, 0.0),
            rect=selection,
            span_index=0,
            fill=color_fill,
        ))
        content_hash = hash((content_hash, gf.font_id, gid, ch, pos.x, pos.y, origin))
    arr.lines = [(0, len(glyphs) - 1)]
    arr.content_hash = content_hash
    min_x = min(g.rect.x for g in arr.arranged_glyphs)
    min_y = min(g.rect.y for g in arr.arranged_glyphs)
    max_x = max(g.rect.x + g.rect.w for g in arr.arranged_glyphs)
    max_y = max(g.rect.y + g.rect.h for g in arr.arranged_glyphs)
    arr.bounding = rect(min_x, min_y, max_x - min_x, max_y - min_y)
    arr.min_size = arr.bounding.wh
    arr.max_size = arr.bounding.wh
    return arr
