"""Write the faces figdraw_tpu_torch carries for CFF and variable-font text
(figdraw_tpu_torch/fonts/FigPortSans-*), derived from the bundled DejaVuSans
by fontTools' own production path. Run on a host with fontTools:

    python tools/make_port_faces.py [output directory]

(default: figdraw_tpu_torch/fonts). The output is deterministic: the same
fontTools version writes the same bytes (tests/test_torch_variations.py
regenerates the faces and compares them).

1. DejaVuSans is subset to U+0020-007E and U+00A0-017F, its GSUB, GPOS,
   GDEF and kern tables kept, hinting dropped, and renamed "FigPort Sans"
   (the Bitstream Vera licence forbids "Bitstream" and "Vera" in a modified
   face's names; fonts/LICENSE carries its notice).
2. FigPortSans-CFF.otf: CFF (name-keyed) with charstrings from
   T2CharStringPen over the glyf outlines (fontTools' default specializer).
3. FigPortSans-VF.ttf: varLib.build over five compatible glyf masters on
   the axes wdth 75-100-125 (avar: 90 -> 85) and slnt -12-0: x-scaled
   copies at wdth 75, 112.5 (an intermediate region) and 125, and a copy
   skewed by tan(12 deg) at slnt -12. A composite whose components carry
   only offsets stays a composite (its offsets move with the master); any
   other is decomposed in every master. The face holds gvar (IUP-optimized
   as varLib writes it), HVAR, avar, fvar and STAT.
4. FigPortSans-VF.otf: the same design space over CFF masters, which
   varLib merges into CFF2 with blend, and HVAR.
"""

from __future__ import annotations

import io
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FONTS = os.path.join(REPO, "figdraw_tpu_torch", "fonts")
SOURCE = os.path.join(FONTS, "DejaVuSans.ttf")
FAMILY = "FigPort Sans"
FACES = ("FigPortSans-CFF.otf", "FigPortSans-VF.ttf", "FigPortSans-VF.otf")
UNICODES = list(range(0x20, 0x7F)) + list(range(0xA0, 0x180))
TIMESTAMP = 0x00000000E0000000  # head.created and head.modified (2023-02-22)
SLANT = math.tan(math.radians(12.0))

# (wdth, slnt) design location -> the master's affine map of x: x * sx + y * kx
MASTERS = {
    (100.0, 0.0): (1.0, 0.0),
    (75.0, 0.0): (0.75, 0.0),
    (112.5, 0.0): (1.1, 0.0),
    (125.0, 0.0): (1.25, 0.0),
    (100.0, -12.0): (1.0, SLANT),
}
WDTH_MAP = [(75.0, 75.0), (90.0, 85.0), (100.0, 100.0), (125.0, 125.0)]


def _load(data: bytes):
    from fontTools.ttLib import TTFont

    return TTFont(io.BytesIO(data))


def _bytes(font) -> bytes:
    buf = io.BytesIO()
    font["head"].created = font["head"].modified = TIMESTAMP
    font.recalcTimestamp = False
    font.save(buf)
    return buf.getvalue()


def subset_source(path: str = SOURCE, unicodes=UNICODES):
    """DejaVuSans cut to `unicodes` (the Latin ranges) with its layout
    tables, renamed."""
    from fontTools import subset

    options = subset.Options()
    options.layout_features = ["*"]
    options.legacy_kern = True
    options.hinting = False
    options.name_IDs = []
    options.notdef_outline = True
    options.glyph_names = True
    options.recalc_timestamp = False
    font = subset.load_font(path, options)
    sub = subset.Subsetter(options)
    sub.populate(unicodes=unicodes)
    sub.subset(font)
    rename(font, "Regular")
    return _load(_bytes(font))


def rename(font, style: str) -> None:
    """A name table of its own: no Bitstream or Vera in any record."""
    ps = FAMILY.replace(" ", "") + "-" + style
    font["name"].names = []
    font["name"].setName("Derived from DejaVu Sans; see LICENSE", 0, 3, 1, 0x409)
    for nid, text in ((1, FAMILY), (2, style), (3, f"{ps};figdraw_tpu_torch"),
                      (4, f"{FAMILY} {style}"), (5, "Version 1.000"), (6, ps)):
        font["name"].setName(text, nid, 3, 1, 0x409)
        font["name"].setName(text, nid, 1, 0, 0)


def _charstrings(font, cff2: bool = False):
    from fontTools.pens.t2CharStringPen import T2CharStringPen

    gs = font.getGlyphSet()
    out = {}
    for name in font.getGlyphOrder():
        pen = T2CharStringPen(None if cff2 else gs[name].width, gs, CFF2=cff2)
        gs[name].draw(pen)
        out[name] = pen.getCharString()
    return out


def to_cff(font, style: str = "Regular"):
    """The glyf face as CFF: charstrings from its outlines, the other
    tables kept, post format 3 (the charset names the glyphs)."""
    from fontTools.fontBuilder import FontBuilder

    charstrings = _charstrings(font)
    cff = _load(_bytes(font))
    for tag in ("glyf", "loca", "gasp", "fpgm", "prep", "cvt "):
        if tag in cff:
            del cff[tag]
    cff.sfntVersion = "OTTO"
    fb = FontBuilder(font=cff)
    ps = FAMILY.replace(" ", "") + "-" + style
    fb.setupCFF(ps, {"FullName": f"{FAMILY} {style}", "FamilyName": FAMILY,
                     "Weight": style}, charstrings, {})
    fb.setupMaxp()
    cff["post"].formatType = 3.0
    return _load(_bytes(cff))


def _simple(coords, end_pts, flags):
    from fontTools.ttLib.tables import ttProgram
    from fontTools.ttLib.tables._g_l_y_f import Glyph, GlyphCoordinates

    g = Glyph()
    g.numberOfContours = len(end_pts)
    g.coordinates = GlyphCoordinates(coords)
    g.endPtsOfContours = list(end_pts)
    g.flags = bytearray(f & 0x81 for f in flags)
    g.program = ttProgram.Program()
    g.program.fromBytecode(b"")
    return g


def _decomposed(glyf) -> set:
    """Composites with a component that carries a 2x2 transform (which a
    master's map does not commute with): drawn decomposed in every master."""
    out = set()
    for name in glyf.keys():
        g = glyf[name]
        if g.isComposite() and any(hasattr(c, "transform") for c in g.components):
            out.add(name)
    return out


def master(base, sx: float, kx: float):
    """A copy of the glyf face with x mapped to x * sx + y * kx: points
    rounded, composites' offsets moved, advances scaled, lsbs recomputed."""
    from copy import deepcopy

    from fontTools.misc.roundTools import otRound

    font = _load(_bytes(base))
    glyf, hmtx = font["glyf"], font["hmtx"]
    decompose = _decomposed(base["glyf"])
    new = {}
    for name in font.getGlyphOrder():
        g = base["glyf"][name]
        if g.isComposite() and name not in decompose:
            c = deepcopy(g)
            for comp in c.components:
                comp.x, comp.y = otRound(comp.x * sx + comp.y * kx), comp.y
            new[name] = c
        elif g.numberOfContours == 0:
            new[name] = deepcopy(g)
        else:
            coords, end_pts, flags = g.getCoordinates(base["glyf"])
            moved = [(otRound(x * sx + y * kx), y) for x, y in coords]
            new[name] = _simple(moved, end_pts, flags)
    for name, g in new.items():
        glyf[name] = g
    for name in font.getGlyphOrder():
        g = glyf[name]
        g.recalcBounds(glyf)
        adv, _lsb = base["hmtx"][name]
        hmtx[name] = (otRound(adv * sx), getattr(g, "xMin", 0)
                      if g.numberOfContours != 0 else 0)
    return _load(_bytes(font))


def designspace(sources):
    from fontTools.designspaceLib import (
        AxisDescriptor, DesignSpaceDocument, SourceDescriptor,
    )

    ds = DesignSpaceDocument()
    wdth = AxisDescriptor()
    wdth.tag, wdth.name = "wdth", "Width"
    wdth.minimum, wdth.default, wdth.maximum = 75.0, 100.0, 125.0
    wdth.map = list(WDTH_MAP)
    slnt = AxisDescriptor()
    slnt.tag, slnt.name = "slnt", "Slant"
    slnt.minimum, slnt.default, slnt.maximum = -12.0, 0.0, 0.0
    ds.addAxis(wdth)
    ds.addAxis(slnt)
    for (w, s), font in sources:
        src = SourceDescriptor()
        src.font = font
        src.location = {"Width": w, "Slant": s}
        if (w, s) == (100.0, 0.0):
            src.copyLib = src.copyInfo = src.copyFeatures = True
        ds.addSource(src)
    return ds


def variable(base, cff: bool, exclude=()):
    """varLib.build over the masters of MASTERS (glyf, or CFF ones)."""
    from fontTools import varLib

    sources = []
    for loc, (sx, kx) in MASTERS.items():
        m = master(base, sx, kx)
        sources.append((loc, to_cff(m) if cff else m))
    vf, _, _ = varLib.build(designspace(sources), exclude=["MVAR", *exclude])
    rename(vf, "Regular")
    return vf


def faces(path: str = SOURCE) -> dict:
    """{file name: bytes} of the three faces."""
    base = subset_source(path)
    return {
        "FigPortSans-CFF.otf": _bytes(to_cff(base)),
        "FigPortSans-VF.ttf": _bytes(variable(base, cff=False)),
        "FigPortSans-VF.otf": _bytes(variable(base, cff=True)),
    }


def main() -> None:
    out = sys.argv[1] if len(sys.argv) > 1 else FONTS
    os.makedirs(out, exist_ok=True)
    for name, data in faces().items():
        path = os.path.join(out, name)
        with open(path, "wb") as fh:
            fh.write(data)
        print(f"wrote {path} ({len(data)} bytes)")


if __name__ == "__main__":
    main()
