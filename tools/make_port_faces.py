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
5. FigPortSans-VF.woff: FigPortSans-VF.ttf as WOFF 1.0 (fontTools' zlib
   writer; STAT, gasp, head and loca stay uncompressed, as zlib does not
   shrink them).
6. FigPortSans-VARC.ttf: FigPortSans-VF.ttf with a VARC table built from
   fontTools' own objects (otTables.VarComponent, ConditionTable,
   OnlineMultiVarStoreBuilder): the 166 composites of U+00C0-017F become
   variable composites of their components, each offset moving with the
   masters through the MultiVarStore, and named glyphs carry the cases of
   VARC drawing (varc_face). Together they use every VarComponentFlags bit
   but GID_IS_24BIT and every condition format; check_varc_face reads the
   table back with fontTools and checks that.
7. FigPortSans-VF.woff2: FigPortSans-VF.ttf as WOFF 2.0 through fontTools'
   WOFF2Writer with its glyf, loca and hmtx tables transformed, and
   FigPortSans-CFF.woff2: FigPortSans-CFF.otf as WOFF 2.0, no table
   transformed. The host has no brotli module, so tools/brotli_shim.py
   stands in for it: its compress writes uncompressed meta-blocks, which
   keeps the files deterministic and every Brotli decoder reads them.
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
FACES = ("FigPortSans-CFF.otf", "FigPortSans-VF.ttf", "FigPortSans-VF.otf",
         "FigPortSans-VF.woff", "FigPortSans-VARC.ttf", "FigPortSans-VF.woff2",
         "FigPortSans-CFF.woff2")
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


def woff(sfnt: bytes) -> bytes:
    """A face's bytes as WOFF 1.0 (fontTools' writer: zlib at its default
    level, a table stored as is where zlib does not make it smaller)."""
    font = _load(sfnt)
    font.flavor = "woff"
    return _bytes(font)


def woff2(sfnt: bytes, transformed=("glyf", "loca", "hmtx")) -> bytes:
    """A face's bytes as WOFF 2.0 (fontTools' WOFF2Writer, the tables named
    transformed, through tools/brotli_shim.py); raises if fontTools leaves
    one of them untransformed."""
    from fontTools.ttLib import woff2 as ft_woff2

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import brotli_shim

    font = _load(sfnt)
    font.flavor = "woff2"
    with brotli_shim.installed():
        font.flavorData = ft_woff2.WOFF2FlavorData(transformedTables=transformed)
        data = _bytes(font)
        reader = ft_woff2.WOFF2Reader(io.BytesIO(data))
    done = sorted(str(tag) for tag, entry in reader.tables.items() if entry.transformed)
    if done != sorted(t for t in transformed if t in reader.tables):
        raise ValueError(f"fontTools transformed {done}, not {sorted(transformed)}")
    return data


# axis indices (fvar order) of the VARC components' axes
WDTH, SLNT = 0, 1
AXIS_LISTS = ([WDTH], [SLNT], [WDTH, SLNT])
# the MultiVarStore's regions (normalized supports)
W_UP = {"wdth": (0.0, 1.0, 1.0)}
W_DOWN = {"wdth": (-1.0, -1.0, 0.0)}
W_MID = {"wdth": (0.0, 0.5, 1.0)}
S_DOWN = {"slnt": (-1.0, -1.0, 0.0)}
W_UP_S_DOWN = {"wdth": (0.0, 1.0, 1.0), "slnt": (-1.0, -1.0, 0.0)}


class _Store:
    """An OnlineMultiVarStoreBuilder that takes {support: per-field deltas}
    and returns a variation index (NO_VARIATION_INDEX for all-zero
    deltas)."""

    def __init__(self):
        from fontTools.varLib.multiVarStore import OnlineMultiVarStoreBuilder

        self.builder = OnlineMultiVarStoreBuilder(["wdth", "slnt"])

    def add(self, deltas: list) -> int:
        """deltas: [(support, [delta per field])], in one support order."""
        from fontTools.misc.vector import Vector
        from fontTools.ttLib.tables.otTables import NO_VARIATION_INDEX

        if not any(any(d) for _s, d in deltas):
            return NO_VARIATION_INDEX
        self.builder.setSupports([sup for sup, _d in deltas])
        return self.builder.storeDeltas([Vector(int(v) for v in d) for _s, d in deltas])


def _condition(fmt: int, *args):
    from fontTools.ttLib.tables import otTables as ot

    c = ot.ConditionTable()
    c.Format = fmt
    if fmt == 1:
        c.AxisIndex, c.FilterRangeMinValue, c.FilterRangeMaxValue = args
    elif fmt == 2:
        c.DefaultValue, c.VarIdx = args
    elif fmt in (3, 4):
        c.ConditionTable = list(args)
        c.ConditionCount = len(args)
    else:
        (c.ConditionTable,) = args
    return c


def _component(name: str, flags: int = 0, **fields):
    """A VarComponent of glyph `name`: `flags` (RESET_UNSPECIFIED_AXES),
    its transform fields (each sets its HAVE_ flag) and axisIndicesIndex /
    axisValues / conditionIndex / the variation indices."""
    from fontTools.ttLib.tables.otTables import VAR_TRANSFORM_MAPPING, VarComponent

    c = VarComponent()
    c.glyphName = name
    c.flags = flags
    for key, value in fields.items():
        if key in VAR_TRANSFORM_MAPPING:
            setattr(c.transform, key, value)
            c.flags |= VAR_TRANSFORM_MAPPING[key].flag
        else:
            setattr(c, key, value)
    if "scaleX" in fields and "scaleY" not in fields:
        c.transform.scaleY = c.transform.scaleX
    return c


def _moving_offset(store: _Store, fields: list, x: int, y: int) -> int:
    """The store item that moves a component's (x, y) offset as the
    masters move it (x scaled by 0.75 and 1.25 at wdth 75 and 125, x
    plus y tan 12 deg at slnt -12), for its flagged fields."""
    from fontTools.misc.roundTools import otRound

    def row(dx):
        return [dx if f == "translateX" else 0 for f in fields]

    return store.add([(W_UP, row(otRound(0.25 * x))), (W_DOWN, row(otRound(-0.25 * x))),
                      (S_DOWN, row(otRound(SLANT * y)))])


def _varc_glyphs(font, store: _Store) -> dict:
    """{glyph name: [VarComponent]} for the composites of U+00C0-017F:
    each component at its glyf offset, the offset moving with the masters
    through the MultiVarStore."""
    cmap = font.getBestCmap()
    glyf = font["glyf"]
    out = {}
    for cp in range(0xC0, 0x180):
        name = cmap.get(cp)
        if name is None or not glyf[name].isComposite() or name in out:
            continue
        comps = []
        for gc in glyf[name].components:
            fields = {}
            if gc.x:
                fields["translateX"] = gc.x
            if gc.y:
                fields["translateY"] = gc.y
            comp = _component(gc.glyphName, **fields)
            if gc.x:
                comp.transformVarIndex = _moving_offset(store, list(fields), gc.x, gc.y)
            comps.append(comp)
        out[name] = comps
    return out


def _special_cases(glyphs: dict, store: _Store, conditions: list) -> None:
    """The VARC cases on named glyphs (see varc_face)."""
    from fontTools.ttLib.tables.otTables import VarComponentFlags as F

    def mark(name):
        return glyphs[name][1]

    # a mark at its own wdth
    mark("Agrave").axisIndicesIndex = 0
    mark("Agrave").axisValues = (-0.5,)
    # a mark whose axis values vary through the MultiVarStore
    m = mark("Aacute")
    m.axisIndicesIndex, m.axisValues = 2, (0.25, 0.0)
    m.axisValuesVarIndex = store.add([(W_UP, [4096, 0]), (S_DOWN, [0, -8192]),
                                      (W_MID, [-2048, 1024])])
    # rotation, scale, skew and tCenter
    glyphs["Acircumflex"][1] = _component(
        "Circumflex", translateX=1212, translateY=373, rotation=8.0, scaleX=0.9,
        scaleY=1.1, skewX=6.0, skewY=-4.0, tCenterX=500, tCenterY=1480)
    # transform deltas beyond the offset: rotation and scale move too
    glyphs["Atilde"][1] = t = _component(
        "Tilde", translateX=1212, translateY=373, rotation=0.0, scaleX=1.0)
    t.transformVarIndex = store.add([(W_UP, [303, 0, 91, 51]), (W_DOWN, [-303, 0, -91, -102]),
                                     (W_UP_S_DOWN, [0, 40, 182, 0])])
    # conditions of each format: format 5 sits behind an OR whose first
    # operand always holds (fontTools 4.61.1 raises on evaluating it)
    def cond(c):
        conditions.append(c)
        return len(conditions) - 1

    wide = _condition(2, -100, store.add([(W_UP, [200])]))
    a = glyphs["Adieresis"]
    a[1].conditionIndex = cond(_condition(1, WDTH, -1.0, 0.25))
    a.append(_component("Acute", translateX=1212, translateY=373,
                        conditionIndex=cond(wide)))
    a.append(_component("Grave", translateX=1212, translateY=520, conditionIndex=cond(
        _condition(3, _condition(1, SLNT, -1.0, -0.4), _condition(1, WDTH, -0.1, 1.0)))))
    a.append(_component("Breve", translateX=1212, translateY=600, conditionIndex=cond(
        _condition(4, _condition(1, WDTH, 0.9, 1.0), _condition(1, SLNT, -1.0, -0.9)))))
    a.append(_component("Dotaccent", translateX=1212, translateY=700, conditionIndex=cond(
        _condition(4, _condition(1, WDTH, -1.0, 1.0),
                   _condition(5, _condition(1, SLNT, -1.0, -0.5))))))
    # a reset component, and a VARC component inside a VARC glyph
    e = glyphs["Egrave"]
    e[0].flags |= F.RESET_UNSPECIFIED_AXES
    e[0].axisIndicesIndex, e[0].axisValues = 1, (0.0,)
    glyphs["Eacute"][0] = _component("Egrave", axisIndicesIndex=0, axisValues=(-1.0,))
    # a component that names its own glyph (its glyf composite)
    glyphs["Ecircumflex"] = [_component("Ecircumflex", axisIndicesIndex=0,
                                        axisValues=(0.5,), translateX=-40)]


def varc_face(vf):
    """FigPortSans-VF.ttf with a VARC table: the composites of U+00C0-017F
    as variable composites of their components, and on named glyphs the
    cases VARC drawing has (a mark at its own wdth on Agrave, axis values
    varying through the MultiVarStore on Aacute, rotation, scale, skew and
    tCenter on Acircumflex, transform deltas on Atilde, a condition of
    each format on Adieresis, a reset component on Egrave, a VARC
    component in a VARC glyph on Eacute, a component naming its own glyph
    on Ecircumflex)."""
    from fontTools.ttLib import newTable
    from fontTools.ttLib.tables import otTables as ot

    font = _load(_bytes(vf))
    store = _Store()
    conditions: list = []
    glyphs = _varc_glyphs(font, store)
    _special_cases(glyphs, store, conditions)
    order = sorted(glyphs, key=font.getGlyphID)
    table = ot.VARC()
    table.Version = 0x00010000
    table.Coverage = ot.Coverage()
    table.Coverage.glyphs = order
    table.MultiVarStore = store.builder.finish()
    table.ConditionList = ot.ConditionList()
    table.ConditionList.ConditionTable = conditions
    table.ConditionList.ConditionCount = len(conditions)
    table.AxisIndicesList = ot.AxisIndicesList()
    table.AxisIndicesList.Item = [list(a) for a in AXIS_LISTS]
    table.VarCompositeGlyphs = ot.VarCompositeGlyphs()
    table.VarCompositeGlyphs.VarCompositeGlyph = [ot.VarCompositeGlyph(glyphs[n])
                                                   for n in order]
    font["VARC"] = newTable("VARC")
    font["VARC"].table = table
    return _load(_bytes(font))


def check_varc_face(data: bytes) -> dict:
    """What a VARC face's table holds, read back by fontTools: the union of
    its components' flags, its condition formats (nested ones included),
    and the glyphs with a component naming the glyph itself or a glyph in
    Coverage. Raises unless it uses every VarComponentFlags bit but
    GID_IS_24BIT (fontTools sets it only past glyph 65535), every
    condition format 1-5, a component naming its own glyph and a VARC
    component inside a VARC glyph."""
    from fontTools.ttLib.tables.otTables import VarComponentFlags as F

    table = _load(data)["VARC"].table
    cover = set(table.Coverage.glyphs)
    flags, formats, own, nested = 0, set(), [], []

    def walk(c):
        formats.add(c.Format)
        subs = (c.ConditionTable if c.Format in (3, 4)
                else [c.ConditionTable] if c.Format == 5 else [])
        for sub in subs:
            walk(sub)

    for c in table.ConditionList.ConditionTable:
        walk(c)
    for name, glyph in zip(table.Coverage.glyphs, table.VarCompositeGlyphs.VarCompositeGlyph):
        for comp in glyph.components:
            flags |= comp.flags
            if comp.glyphName == name:
                own.append(name)
            elif comp.glyphName in cover:
                nested.append(name)
    want = (1 << 15) - 1 & ~int(F.GID_IS_24BIT)
    if flags != want:
        raise ValueError(f"the VARC face's flags are {flags:#x}, not {want:#x}")
    if sorted(formats) != [1, 2, 3, 4, 5]:
        raise ValueError(f"the VARC face's conditions are {sorted(formats)}")
    if not (own and nested):
        raise ValueError("the VARC face lacks a self-named or a nested VARC component")
    return {"flags": flags, "condition_formats": sorted(formats), "own": own,
            "nested": nested, "coverage": len(cover)}


def faces(path: str = SOURCE) -> dict:
    """{file name: bytes} of the seven faces."""
    base = subset_source(path)
    vf = variable(base, cff=False)
    vf_bytes = _bytes(vf)
    cff_bytes = _bytes(to_cff(base))
    return {
        "FigPortSans-CFF.otf": cff_bytes,
        "FigPortSans-VF.ttf": vf_bytes,
        "FigPortSans-VF.otf": _bytes(variable(base, cff=True)),
        "FigPortSans-VF.woff": woff(vf_bytes),
        "FigPortSans-VARC.ttf": _bytes(varc_face(_load(vf_bytes))),
        "FigPortSans-VF.woff2": woff2(vf_bytes),
        "FigPortSans-CFF.woff2": woff2(cff_bytes, transformed=()),
    }


def main() -> None:
    out = sys.argv[1] if len(sys.argv) > 1 else FONTS
    os.makedirs(out, exist_ok=True)
    made = faces()
    print(f"VARC cases: {check_varc_face(made['FigPortSans-VARC.ttf'])}")
    for name, data in made.items():
        path = os.path.join(out, name)
        with open(path, "wb") as fh:
            fh.write(data)
        print(f"wrote {path} ({len(data)} bytes)")


if __name__ == "__main__":
    main()
