"""Compiled font packs for the native C typesetter (FDTP v5), written on the
port's own text modules (figdraw_tpu/text/native_pack.py, copied).

A C host typesets without Python through native/typeset.cpp, which reads a
flat little-endian blob: a typeface's metrics plus the shaper's own compiled
plan (text/shaper.py over the port's OpenType reader, text/otf.py; no
fontTools). For the same face the blob equals figdraw_tpu's byte for byte
(tests/test_torch_native_typeset.py); the bidi and Arabic joining tables
come from the running Python's unicodedata, so two hosts give the same pack
only on the same Unicode version (chip_smoke.py prints it). A variation
location away from a variable face's default raises NotImplementedError
(otf.VARIATIONS_NOT_PORTED), as the port's typefaces do: no default pack is
built in its place.

v2 exports the FULL default-feature plan: every GSUB lookup the default
features select (ccmp/liga/clig/rlig/calt/rclt/locl) with single / multiple
/ ligature / (chain-)contextual (5/6, all three formats) / reverse-chain (8)
entries plus every lookup they nest; the kern/dist GPOS lookups with single
/ pair / class-pair / (chain-)contextual (7/8) entries; GPOS 3 cursive
entry/exit anchors; and the GPOS 4/5/6 mark-to-base / mark-to-ligature /
mark-to-mark anchor tables.

v3 adds the STAGED ARABIC pipeline (shaper._substitute_arabic): the pack
carries the Unicode joining classes for the Arabic blocks plus seven
per-stage plan arrays (ccmp+locl, isol, fina, medi, init, rlig, rest) so
the C engine can run HarfBuzz-style masked positional shaping — Noto
Naskh-class fonts (skeleton+dot ccmp decomposition, shared positional
lookups) shape glyph-for-glyph equal to Python.

v4 adds the SYLLABLE pipelines (shaper._substitute_indic/_use): 21 more
stage plan arrays (Devanagari basic+presentation, Khmer, Myanmar) — the C
engine carries the syllable segmentation, base/reph analysis, positional
masks and reordering natively, so FD_TYPESET_E_SCRIPT is no longer
returned for any script the Python pipeline stages; everything (Latin-class
scripts WITH combining marks, Hebrew niqqud, Arabic, Devanagari, Khmer,
Myanmar, Thai/Lao, FiraCode-class contextual alternates) shapes
glyph-for-glyph equal to the Python pipeline (tests/test_native_typeset.py,
twinned by tests/test_torch_native_typeset.py).

Blob layout (all little-endian, naturally aligned):
  header:  u32 magic 'FDTP'  u32 version=5
           f32 upem  f32 ascent  f32 descent  f32 line_gap   (font units)
           u32 n_glyphs  u32 n_cmap  u32 n_sub  u32 n_pos
           u32 flags  u32 n_kern0
  cmap:    n_cmap x {u32 codepoint, u32 gid}        sorted by codepoint
  adv:     n_glyphs x f32                            advances (font units)
  gdef:    n_glyphs x u8: low 7 bits = GDEF glyph class (0..4); bit 7 set
           when the glyph is an attach-capable mark (GPOS 4/5/6 mark
           coverage) + pad to 4
  mattach: n_glyphs x u8 MarkAttachClassDef class    + pad to 4
  gsub:    u32 n_plan, u32 plan[n_plan] (pack-local lookup indices in plan
           order), then n_sub lookup records. Records hold the plan lookups
           FIRST (so plan[i] == i), then transitively nested lookups;
           contextual rule records reference nested lookups by pack-local
           index. One record per OpenType LOOKUP (entry grouping is
           load-bearing: a lookup's subtable entries are tried in order at
           each position, first match wins):
           u32 skip_classes(bit k = GDEF class k ignored)  u32 attach_class
           u32 filter_state (0 no filter set, 1 empty set, 2 present)
           u32 filter_n  [filter gids u16[], pad to 4]
           u32 n_entries, then per entry:
           u32 kind  u32 count  payload (pad to 4; see native/typeset.cpp)
  gpos:    same shape (u32 n_plan + plan[] + n_pos records)
  kern0:   n_kern0 x {u16 left, u16 right, i16 value, i16 0}   sorted by
           (left, right) — the legacy 'kern' table, applied only when the
           font has no GPOS kern feature (mirrors layout.py's elif branch)
  curs:    u32 n_tables; per table u32 n_rows +
           {u16 gid, u8 flags(1=entry,2=exit), u8 0, i16 ex, ey, xx, xy}
  markbase: u32 n_tables; per table marks {u32 n; u16 gid, u16 cls,
           i16 mx, my} + bases {u32 n; per base u16 gid, u16 n_anchor,
           {u16 cls, i16 ax, i16 ay}...}, pad4 per table
  marklig: u32 n_tables; per table marks + ligs {u32 n; per lig u16 gid,
           u16 n_comp, per comp u16 n_anchor + anchors}, pad4
  markmark: u32 n_tables; per table marks1 + mark2 (same shape as bases)
  arabic:  304 x u8 joining classes (0=U, 1=R, 2=D, 3=T) for U+0600..U+06FF
           then U+0750..U+077F (shaper._joining_class, evaluated at pack
           build so C matches the building Python's unicodedata exactly), then
           7 x {u32 n, u32 idx[n]} stage plan arrays in _substitute_arabic
           order: ccmp+locl, isol, fina, medi, init, rlig, rest
  syllable: 21 x {u32 n, u32 idx[n]} stage plan arrays: the 9 Indic stages
           (locl+nukt+akhn, rphf, rkrf, pref, blwf, half, pstf, vatu+cjct,
           presentation), 6 Khmer (locl+ccmp, pref, blwf, abvf, pstf,
           cfar), 5 Myanmar (locl+ccmp, rphf, pref, blwf, pstf), and the
           USE presentation set — V4_STAGE_FEATURES order
  bidi:    u32 n_cls_ranges, n x {u32 start, u32 end, u32 class} (RLE of
           unicodedata.bidirectional over all of Unicode, BIDI_CLASSES
           codes), then u32 n_mirror_ranges, n x {u32 start, u32 end}
           (the mirrored property) — the C fd_typeset_box runs the full
           UAX#9 pass (levels, L1/L2 visual order, L4 mirroring) from
           these, matching text/bidi.py on the building Python's Unicode version

`flags` bits record fidelity losses relative to the Python pipeline:
  bit 0  font has a GPOS kern/dist feature (C must NOT fall back to kern0)
  bit 1  the exported GSUB plan dropped entries it cannot represent
  bit 2  the exported GPOS kern lookups dropped entries
  bit 3  font has GPOS cursive attachment (curs) — exported in v2
  bit 4  font has GPOS mark attachment (4/5/6) — exported in v2
  bit 5  the font's default-feature plan selects lookups the exported plan
         does not carry — text shaped from such a pack is REFUSED by
         default (FD_TYPESET_E_REDUCED) unless the host opts into
         divergence via fd_pack_set_allow_reduced
  bit 6  an ARABIC-stage-only lookup dropped entries: Arabic runs from such
         a pack are refused by default (same opt-in), non-Arabic text is
         unaffected
  bit 7  a SYLLABLE-stage-only lookup (Indic/Khmer/Myanmar plans) dropped
         entries: runs in those scripts refuse by default (same opt-in)
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

from .shaper import (
    DEFAULT_GSUB_FEATURES,
    _joining_class,
    _select_lookups,
    get_shaper,
)
from .typefaces import get_typeface

MAGIC = 0x46445450  # 'FDTP'
VERSION = 5

# v5 bidi data: RLE of unicodedata.bidirectional over ALL of Unicode plus
# the mirrored-property ranges — serialized into every pack so the C
# layouter's UAX#9 pass uses the building Python's Unicode version (the same
# reasoning as the Arabic joining classes). Class codes index this tuple.
BIDI_CLASSES = ("L", "R", "AL", "EN", "ES", "ET", "AN", "CS", "NSM", "BN",
                "B", "S", "WS", "ON", "LRE", "RLE", "LRO", "RLO", "PDF",
                "LRI", "RLI", "FSI", "PDI")
_bidi_tables_cache = None


def _bidi_tables():
    """(class_ranges, mirror_ranges): class_ranges = [(start, end, code)]
    RLE over 0..0x110000 of bidi.char_type; mirror_ranges = [(start, end)]
    where unicodedata.mirrored is true. Computed once per process (~1 s)."""
    global _bidi_tables_cache
    if _bidi_tables_cache is not None:
        return _bidi_tables_cache
    import unicodedata

    code = {c: k for k, c in enumerate(BIDI_CLASSES)}
    ranges = []
    prev = None
    start = 0
    for cp in range(0x110000):
        c = unicodedata.bidirectional(chr(cp)) or "L"
        if c != prev:
            if prev is not None:
                ranges.append((start, cp, code[prev]))
            start, prev = cp, c
    ranges.append((start, 0x110000, code[prev]))
    mirrors = []
    prev_m = False
    start = 0
    for cp in range(0x110000):
        m = unicodedata.mirrored(chr(cp))
        if m != prev_m:
            if prev_m:
                mirrors.append((start, cp))
            start, prev_m = cp, m
    if prev_m:
        mirrors.append((start, 0x110000))
    _bidi_tables_cache = (ranges, mirrors)
    return _bidi_tables_cache


# entry kinds (within a lookup record)
K_SINGLE = 1     # count x {u16 from, u16 to}                     sorted by from
K_MULTIPLE = 2   # count x {u16 from, u16 seq_n, u16 seq[...]}
K_LIGA = 4       # count x {u16 first, u16 rest_n, u16 result, u16 rest[...]}
                 # (emission order is load-bearing: same-first candidates are
                 # tried in order, longest component chain first)
K_CTX1 = 5       # contextual fmt 1 (glyph rules); see docstring
K_CTX2 = 6       # contextual fmt 2 (class rules)
K_CTX3 = 7       # contextual fmt 3 (coverage rules)
K_RCHAIN = 8     # reverse chaining single substitution
K_POS1 = 17      # count x {u16 gid, i16 dx}                      sorted by gid
K_POS2S = 18     # count x {u16 g1, u16 g2, i16 v1, i16 v2}       sorted
K_POS2C = 19     # count=1; payload: {u32 n_cov, n_cd1, n_cd2, c1, c2} +
                 # cov u16[] pad4 + cd1/cd2 {u16 gid, u16 cls}[] (sorted) +
                 # matrix (c1*c2) x {i16 v1, i16 v2}

# header flags
F_HAS_GPOS_KERN = 1 << 0
F_GSUB_DROPPED = 1 << 1
F_GPOS_DROPPED = 1 << 2
F_HAS_CURSIVE = 1 << 3
F_HAS_MARKS = 1 << 4
F_FEATURES_REDUCED = 1 << 5
F_ARABIC_REDUCED = 1 << 6
F_SYLLABLE_REDUCED = 1 << 7
MARK_BIT = 0x80  # gdef byte: attach-capable mark (GPOS 4/5/6 coverage)

# v3 staged Arabic: stage feature sets in shaper._substitute_arabic order
# (ARABIC_POSITIONAL's Syriac-only fin2/fin3/med2 are not in the default
# feature set, so the Python pipeline skips them — 7 stages remain). The
# final 'rest' stage is feats - {ccmp, locl, rlig} - positional.
ARABIC_STAGE_FEATURES = (
    frozenset({"ccmp", "locl"}),
    frozenset({"isol"}),
    frozenset({"fina"}),
    frozenset({"medi"}),
    frozenset({"init"}),
    frozenset({"rlig"}),
    frozenset(DEFAULT_GSUB_FEATURES) - {"ccmp", "locl", "rlig"},
)

# v4 syllable pipelines: stage feature sets in the _shape_*_syllable order.
# The presentation stages fold in the default features HarfBuzz keeps on
# (feats ∩ {calt, clig, liga, dlig, ccmp} with the default feature set).
_PRES_COMMON = frozenset({"calt", "clig", "liga", "ccmp"})
INDIC_STAGE_FEATURES = (
    frozenset({"locl", "nukt", "akhn"}),
    frozenset({"rphf"}),
    frozenset({"rkrf"}),
    frozenset({"pref"}),
    frozenset({"blwf"}),
    frozenset({"half"}),
    frozenset({"pstf"}),
    frozenset({"vatu", "cjct"}),
    frozenset({"pres", "abvs", "blws", "psts", "haln"}) | _PRES_COMMON,
)
KHMER_STAGE_FEATURES = (
    frozenset({"locl", "ccmp"}),
    frozenset({"pref"}),
    frozenset({"blwf"}),
    frozenset({"abvf"}),
    frozenset({"pstf"}),
    frozenset({"cfar"}),
)
MYANMAR_STAGE_FEATURES = (
    frozenset({"locl", "ccmp"}),
    frozenset({"rphf"}),
    frozenset({"pref"}),
    frozenset({"blwf"}),
    frozenset({"pstf"}),
)
USE_PRES_FEATURES = frozenset({"pres", "abvs", "blws", "psts"}) | _PRES_COMMON
# serialization order of the v4 arrays (after the 7 Arabic ones)
V4_STAGE_FEATURES = (INDIC_STAGE_FEATURES + KHMER_STAGE_FEATURES
                     + MYANMAR_STAGE_FEATURES + (USE_PRES_FEATURES,))

# v2 exports the full default plan — kept for callers/tests that reference
# the v1 reduced set
PACK_GSUB_FEATURES = frozenset(DEFAULT_GSUB_FEATURES)


def _gid(tf, name: str) -> int:
    return tf._name_to_gid.get(name, 0)


def _u16s(vals) -> bytes:
    return struct.pack("<%dH" % len(vals), *vals)


def _i16(v: int) -> int:
    return max(-32768, min(32767, int(v)))


def _pad4(b: bytearray) -> None:
    while len(b) % 4:
        b.append(0)


def _skip_words(tf, skip) -> tuple:
    """(skip_classes bitmask, attach_class, filter gid list or None)."""
    classes, filter_set, attach_class = skip
    mask = 0
    for c in classes:
        mask |= 1 << c
    gids = None
    if filter_set is not None:
        gids = sorted(_gid(tf, n) for n in filter_set)
    return mask, int(attach_class or 0), gids


def _emit_record(tf, out: bytearray, skip, entries) -> None:
    """One lookup record: skip state + its subtable entries in order.
    `entries` is a list of (kind, count, payload bytes)."""
    mask, attach, gids = _skip_words(tf, skip)
    filter_state = 0 if gids is None else (1 if not gids else 2)
    out += struct.pack("<IIII", mask, attach, filter_state,
                       len(gids) if gids else 0)
    if gids:
        out += _u16s(gids)
        _pad4(out)
    out += struct.pack("<I", len(entries))
    for kind, count, payload in entries:
        out += struct.pack("<II", kind, count)
        out += payload
        _pad4(out)


class _PackCtx:
    """Shared serialization state: the lookup-index map for nested
    contextual references and the fidelity flags accumulated so far."""

    def __init__(self, tf):
        self.tf = tf
        self.flags = 0


def _ser_rule(payload: bytearray, bt, inp, la, recs, limap,
              val16) -> bool:
    """One (chain) context rule: u16 n_bt/n_inp/n_la/n_rec + value streams
    + {u16 seq_idx, u16 pack_lookup_idx} records. `val16` maps a rule value
    (glyph name / class id) to u16. Returns False when a nested lookup
    reference is missing from limap (caller drops the entry)."""
    for _seq, li in recs:
        if li not in limap:
            return False
    payload += struct.pack("<HHHH", len(bt), len(inp), len(la), len(recs))
    payload += _u16s([val16(v) for v in bt])
    payload += _u16s([val16(v) for v in inp])
    payload += _u16s([val16(v) for v in la])
    for seq, li in recs:
        payload += struct.pack("<HH", int(seq), limap[li])
    return True


def _ser_cov(payload: bytearray, gids) -> None:
    payload += struct.pack("<H", len(gids))
    payload += _u16s(sorted(gids))


def _ser_ctx_entry(ctx: _PackCtx, entry, limap) -> Optional[tuple]:
    """("ctx", fmt, data) → (kind, count, payload) or None (unsupported)."""
    tf = ctx.tf
    _, fmt, data = entry
    gid = lambda n: _gid(tf, n)  # noqa: E731
    if fmt == 1:
        payload = bytearray()
        firsts = []
        for first, rules in data["cov"].items():
            rp = bytearray()
            kept = 0
            for bt, inp, la, recs in rules:
                if _ser_rule(rp, bt, inp, la, recs, limap, gid):
                    kept += 1
            firsts.append((gid(first), kept, bytes(rp)))
        firsts.sort()
        body = bytearray()
        body += struct.pack("<I", len(firsts))
        for g, nr, rp in firsts:
            body += struct.pack("<HH", g, nr)
            body += rp
        _pad4(body)
        return (K_CTX1, len(firsts), bytes(body))
    if fmt == 2:
        body = bytearray()
        cov = sorted(gid(n) for n in data["cov"])
        in_cd = sorted((gid(n), int(c)) for n, c in data["in_cd"].items())
        bt_cd = sorted((gid(n), int(c)) for n, c in data["bt_cd"].items())
        la_cd = sorted((gid(n), int(c)) for n, c in data["la_cd"].items())
        sets = []
        for ci, rules in data["rules"].items():
            rp = bytearray()
            kept = 0
            for bt, inp, la, recs in rules:
                if _ser_rule(rp, bt, inp, la, recs, limap,
                             lambda v: int(v)):
                    kept += 1
            sets.append((int(ci), kept, bytes(rp)))
        sets.sort()
        body += struct.pack("<IIIII", len(cov), len(in_cd), len(bt_cd),
                            len(la_cd), len(sets))
        body += _u16s(cov)
        for g, c in in_cd + bt_cd + la_cd:
            body += struct.pack("<HH", g, c)
        for ci, nr, rp in sets:
            body += struct.pack("<HH", ci, nr)
            body += rp
        _pad4(body)
        return (K_CTX2, len(sets), bytes(body))
    if fmt == 3:
        for _seq, li in data["recs"]:
            if li not in limap:
                return None
        body = bytearray()
        body += struct.pack("<IIII", len(data["bt"]), len(data["inp"]),
                            len(data["la"]), len(data["recs"]))
        for cov in data["bt"]:
            _ser_cov(body, [gid(n) for n in cov])
        for cov in data["inp"]:
            _ser_cov(body, [gid(n) for n in cov])
        for cov in data["la"]:
            _ser_cov(body, [gid(n) for n in cov])
        for seq, li in data["recs"]:
            body += struct.pack("<HH", int(seq), limap[li])
        _pad4(body)
        return (K_CTX3, 1, bytes(body))
    return None


def _nested_lis(entry) -> List[int]:
    """Nested LookupListIndex references of one compiled entry."""
    if entry[0] != "ctx":
        return []
    _, fmt, data = entry
    out = []
    if fmt == 1:
        for rules in data["cov"].values():
            for _bt, _inp, _la, recs in rules:
                out.extend(li for _s, li in recs)
    elif fmt == 2:
        for rules in data["rules"].values():
            for _bt, _inp, _la, recs in rules:
                out.extend(li for _s, li in recs)
    else:
        out.extend(li for _s, li in data["recs"])
    return out


def _pack_gsub_entry(ctx: _PackCtx, entry, limap) -> Optional[tuple]:
    tf = ctx.tf
    ekind = entry[0]
    if ekind == "single":
        rows = sorted((_gid(tf, a), _gid(tf, b))
                      for a, b in entry[1].items())
        payload = bytearray()
        for a, b in rows:
            payload += struct.pack("<HH", a, b)
        return (K_SINGLE, len(rows), bytes(payload))
    if ekind == "multiple":
        payload = bytearray()
        cnt = 0
        for a, seq in entry[1].items():
            payload += struct.pack("<HH", _gid(tf, a), len(seq))
            payload += _u16s([_gid(tf, s) for s in seq])
            cnt += 1
        return (K_MULTIPLE, cnt, bytes(payload))
    if ekind == "liga":
        # font order within the lookup is load-bearing
        # (first-match-wins at each position)
        payload = bytearray()
        cnt = 0
        for first, ents in entry[1].items():
            fg = _gid(tf, first)
            for comp_seq, lig in ents:
                payload += struct.pack(
                    "<HHH", fg, len(comp_seq), _gid(tf, lig))
                payload += _u16s([_gid(tf, c) for c in comp_seq])
                cnt += 1
        return (K_LIGA, cnt, bytes(payload))
    if ekind == "rchain":
        data = entry[1]
        rows = sorted((_gid(tf, a), _gid(tf, b))
                      for a, b in data["map"].items())
        payload = bytearray()
        payload += struct.pack("<III", len(rows), len(data["bt"]),
                               len(data["la"]))
        for a, b in rows:
            payload += struct.pack("<HH", a, b)
        for cov in data["bt"]:
            _ser_cov(payload, [_gid(tf, n) for n in cov])
        for cov in data["la"]:
            _ser_cov(payload, [_gid(tf, n) for n in cov])
        _pad4(payload)
        return (K_RCHAIN, len(rows), bytes(payload))
    if ekind == "ctx":
        return _ser_ctx_entry(ctx, entry, limap)
    return None


def _pack_gpos_entry(ctx: _PackCtx, entry, limap) -> Optional[tuple]:
    tf = ctx.tf
    ekind = entry[0]
    if ekind == "pos1":
        rows = sorted((_gid(tf, g), int(v))
                      for g, v in entry[1].items())
        payload = bytearray()
        for g, v in rows:
            payload += struct.pack("<Hh", g, v)
        return (K_POS1, len(rows), bytes(payload))
    if ekind == "pos2s":
        rows = sorted(
            (_gid(tf, a), _gid(tf, b), int(v1), int(v2))
            for (a, b), (v1, v2) in entry[1].items())
        payload = bytearray()
        for a, b, v1, v2 in rows:
            payload += struct.pack("<HHhh", a, b, v1, v2)
        return (K_POS2S, len(rows), bytes(payload))
    if ekind == "pos2c":
        data = entry[1]
        cov = sorted(_gid(tf, n) for n in data["cov"])
        cd1 = sorted((_gid(tf, n), int(c))
                     for n, c in data["cd1"].items())
        cd2 = sorted((_gid(tf, n), int(c))
                     for n, c in data["cd2"].items())
        c1 = 1 + max([c for _, c in cd1] +
                     [c1c2[0] for c1c2 in data["m"]] + [0])
        c2 = 1 + max([c for _, c in cd2] +
                     [c1c2[1] for c1c2 in data["m"]] + [0])
        payload = bytearray()
        payload += struct.pack("<IIIII", len(cov), len(cd1),
                               len(cd2), c1, c2)
        payload += _u16s(cov)
        _pad4(payload)
        for g, c in cd1:
            payload += struct.pack("<HH", g, c)
        for g, c in cd2:
            payload += struct.pack("<HH", g, c)
        mat = [(0, 0)] * (c1 * c2)
        for (a, b), (v1, v2) in data["m"].items():
            mat[a * c2 + b] = (int(v1), int(v2))
        for v1, v2 in mat:
            payload += struct.pack("<hh", v1, v2)
        return (K_POS2C, 1, bytes(payload))
    if ekind == "ctx":
        return _ser_ctx_entry(ctx, entry, limap)
    return None


def _collect_lookups(plan_lis, compile_one) -> tuple:
    """(ordered li list, li → pack index map): the plan lookups first (so
    plan[i] == i), then every transitively nested lookup, BFS order."""
    order: List[int] = []
    limap: Dict[int, int] = {}
    queue = list(plan_lis)
    while queue:
        li = queue.pop(0)
        if li in limap:
            continue
        limap[li] = len(order)
        order.append(li)
        compiled = compile_one(li)
        entries = compiled[1]
        for entry in entries:
            for nli in _nested_lis(entry):
                if nli not in limap:
                    queue.append(nli)
    return order, limap


def build_font_pack(typeface_id: int, variations=()) -> bytes:
    """Serialize the typeface's metrics + compiled default-feature plan.

    `variations`: OpenType variable-axis coordinates — FontVariation
    objects or (tag, value) pairs. A non-empty set bakes an INSTANCE pack:
    advances come from the varied glyph set (typefaces.var_advance), so
    fd_typeset_* output equals layout.py's arrangement for a FigFont with
    the same variations. The Python pipeline does not vary GSUB/GPOS
    values (no rvrn/feature-variations), and neither does the pack — the
    plan tables are the default instance's, matching layout.py exactly."""
    tf = get_typeface(typeface_id)
    var_list = _norm_variations(variations)
    tf._check_location(var_list)  # before any work: never a default pack instead
    shaper = get_shaper(tf)
    ctx = _PackCtx(tf)

    n_glyphs = max(tf._name_to_gid.values(), default=0) + 1

    cmap_items = []
    for cp, name in tf.cmap.items():
        cmap_items.append((int(cp), _gid(tf, name)))
    cmap_items.sort()

    adv = [0.0] * n_glyphs
    for name, gid in tf._name_to_gid.items():
        adv[gid] = (float(tf.var_advance(gid, var_list)) if var_list
                    else float(tf.advance(gid)))

    gdef_cls = bytearray(n_glyphs)
    mattach = bytearray(n_glyphs)
    if shaper is not None:
        for name, cls in shaper._gdef_class.items():
            g = _gid(tf, name)
            if g:
                gdef_cls[g] = min(int(cls), 0x7F)
        for name, cls in shaper._mark_attach_class.items():
            g = _gid(tf, name)
            if g:
                mattach[g] = min(int(cls), 255)
        for name in shaper._mark_glyphs:
            g = _gid(tf, name)
            if g:
                gdef_cls[g] |= MARK_BIT
        if shaper.has_gpos_kern:
            ctx.flags |= F_HAS_GPOS_KERN
        if shaper._cursive:
            ctx.flags |= F_HAS_CURSIVE
        if shaper._mark_base or shaper._mark_lig or shaper._mark_mark:
            ctx.flags |= F_HAS_MARKS

    # --- GSUB: the full default plan + transitively nested lookups --------
    sub_blobs = bytearray()
    sub_plan: List[int] = []
    n_sub = 0
    pos_blobs = bytearray()
    pos_plan: List[int] = []
    n_pos = 0
    arab_plans: List[List[int]] = [[] for _ in ARABIC_STAGE_FEATURES]
    syl_plans: List[List[int]] = [[] for _ in V4_STAGE_FEATURES]
    if shaper is not None and shaper._gsub is not None:
        table = shaper._gsub.table
        plan_lis = _select_lookups(table, set(DEFAULT_GSUB_FEATURES))
        # lookups only the staged pipelines reach (the positional/syllable
        # features are not default features) join the pool; a serialization
        # drop there flags F_ARABIC_REDUCED / F_SYLLABLE_REDUCED (only the
        # affected pipeline's runs refuse), not F_GSUB_DROPPED (which would
        # refuse ALL text from the pack)
        default_reachable = set(
            _collect_lookups(plan_lis, shaper._compile_lookup)[0])
        stage_lis = [_select_lookups(table, set(fs))
                     for fs in ARABIC_STAGE_FEATURES]
        arabic_reachable = set(_collect_lookups(
            [li for lis in stage_lis for li in lis],
            shaper._compile_lookup)[0])
        v4_lis = [_select_lookups(table, set(fs))
                  for fs in V4_STAGE_FEATURES]
        syllable_reachable = set(_collect_lookups(
            [li for lis in v4_lis for li in lis],
            shaper._compile_lookup)[0])
        all_lis = list(plan_lis)
        for lis in stage_lis:
            all_lis.extend(lis)
        for lis in v4_lis:
            all_lis.extend(lis)
        order, limap = _collect_lookups(all_lis, shaper._compile_lookup)
        sub_plan = [limap[li] for li in plan_lis]
        arab_plans = [[limap[li] for li in lis] for lis in stage_lis]
        syl_plans = [[limap[li] for li in lis] for lis in v4_lis]
        for li in order:
            skip, entries, _trig = shaper._compile_lookup(li)
            packed = []
            for entry in entries:
                p = _pack_gsub_entry(ctx, entry, limap)
                if p is None:
                    # a lookup can be reachable from SEVERAL plans (a
                    # pan-script font sharing lookups between e.g. 'fina'
                    # and 'pres') — OR in every applicable flag so each
                    # script's refuse-by-default gate sees the drop
                    if li in default_reachable:
                        ctx.flags |= F_GSUB_DROPPED
                    else:
                        if li in arabic_reachable:
                            ctx.flags |= F_ARABIC_REDUCED
                        if li in syllable_reachable:
                            ctx.flags |= F_SYLLABLE_REDUCED
                        if li not in arabic_reachable \
                                and li not in syllable_reachable:
                            ctx.flags |= F_SYLLABLE_REDUCED
                else:
                    packed.append(p)
            _emit_record(tf, sub_blobs, skip, packed)
            n_sub += 1

    if shaper is not None and shaper.has_gpos_kern:
        plan_lis = shaper._kern_lookup_indices()
        order, limap = _collect_lookups(
            plan_lis, lambda li: shaper._compile_gpos_lookup(li))
        pos_plan = [limap[li] for li in plan_lis]
        for li in order:
            skip, entries = shaper._compile_gpos_lookup(li)
            packed = []
            for entry in entries:
                p = _pack_gpos_entry(ctx, entry, limap)
                if p is None:
                    ctx.flags |= F_GPOS_DROPPED
                else:
                    packed.append(p)
            _emit_record(tf, pos_blobs, skip, packed)
            n_pos += 1

    # with the full default plan exported, FEATURES_REDUCED fires only if
    # serialization genuinely dropped substitution entries
    if ctx.flags & F_GSUB_DROPPED:
        ctx.flags |= F_FEATURES_REDUCED

    # legacy 'kern' table: the layout fallback for GPOS-less fonts
    # (layout.py:717-725 elif branch) — exported only when that branch
    # can fire, so the blob stays small for GPOS fonts
    kern0 = []
    if shaper is None or not shaper.has_gpos_kern:
        for (ln, rn), v in getattr(tf, "_kern", {}).items():
            lg, rg = _gid(tf, ln), _gid(tf, rn)
            if (lg or rg) and v:
                kern0.append((lg, rg, int(v)))
        kern0.sort()

    # --- GPOS anchors: cursive (3), mark-to-base/lig/mark (4/5/6) ---------
    def ser_marks(out, marks):
        rows = sorted((_gid(tf, g), int(cls), _i16(mx), _i16(my))
                      for g, (cls, mx, my) in marks.items())
        out += struct.pack("<I", len(rows))
        for g, cls, mx, my in rows:
            out += struct.pack("<HHhh", g, cls, mx, my)

    def ser_anchor_map(out, bases):
        rows = sorted((_gid(tf, g), anchors) for g, anchors in bases.items())
        out += struct.pack("<I", len(rows))
        for g, anchors in rows:
            out += struct.pack("<HH", g, len(anchors))
            for cls in sorted(anchors):
                ax, ay = anchors[cls]
                out += struct.pack("<Hhh", int(cls), _i16(ax), _i16(ay))
        _pad4(out)

    anchors_out = bytearray()
    curs_tables = shaper._cursive if shaper is not None else []
    anchors_out += struct.pack("<I", len(curs_tables))
    for table in curs_tables:
        rows = []
        for g, (entry, exit_) in table.items():
            fl = (1 if entry is not None else 0) | (2 if exit_ is not None else 0)
            ex, ey = entry if entry is not None else (0, 0)
            xx, xy = exit_ if exit_ is not None else (0, 0)
            rows.append((_gid(tf, g), fl, _i16(ex), _i16(ey),
                         _i16(xx), _i16(xy)))
        rows.sort()
        anchors_out += struct.pack("<I", len(rows))
        for g, fl, ex, ey, xx, xy in rows:
            anchors_out += struct.pack("<HBBhhhh", g, fl, 0, ex, ey, xx, xy)

    mb = shaper._mark_base if shaper is not None else []
    anchors_out += struct.pack("<I", len(mb))
    for marks, bases in mb:
        ser_marks(anchors_out, marks)
        ser_anchor_map(anchors_out, bases)

    ml = shaper._mark_lig if shaper is not None else []
    anchors_out += struct.pack("<I", len(ml))
    for marks, ligs in ml:
        ser_marks(anchors_out, marks)
        lig_rows = sorted((_gid(tf, g), comps) for g, comps in ligs.items())
        anchors_out += struct.pack("<I", len(lig_rows))
        for g, comps in lig_rows:
            anchors_out += struct.pack("<HH", g, len(comps))
            for anchors in comps:
                anchors_out += struct.pack("<H", len(anchors))
                for cls in sorted(anchors):
                    ax, ay = anchors[cls]
                    anchors_out += struct.pack("<Hhh", int(cls),
                                               _i16(ax), _i16(ay))
        _pad4(anchors_out)

    mm = shaper._mark_mark if shaper is not None else []
    anchors_out += struct.pack("<I", len(mm))
    for marks1, marks2 in mm:
        ser_marks(anchors_out, marks1)
        ser_anchor_map(anchors_out, marks2)

    out = bytearray()
    out += struct.pack("<IIffff", MAGIC, VERSION, float(tf.units_per_em),
                       float(tf.ascent), float(tf.descent),
                       float(tf.line_gap))
    out += struct.pack("<IIIIII", n_glyphs, len(cmap_items), n_sub, n_pos,
                       ctx.flags, len(kern0))
    for cp, gid in cmap_items:
        out += struct.pack("<II", cp, gid)
    out += struct.pack("<%df" % n_glyphs, *adv)
    out += bytes(gdef_cls)
    _pad4(out)
    out += bytes(mattach)
    _pad4(out)
    out += struct.pack("<I", len(sub_plan))
    out += struct.pack("<%dI" % len(sub_plan), *sub_plan) if sub_plan else b""
    out += sub_blobs
    out += struct.pack("<I", len(pos_plan))
    out += struct.pack("<%dI" % len(pos_plan), *pos_plan) if pos_plan else b""
    out += pos_blobs
    for lg, rg, v in kern0:
        out += struct.pack("<HHhh", lg, rg, v, 0)
    out += anchors_out
    # --- v3 staged Arabic: joining classes + per-stage plan arrays --------
    cls_code = {"U": 0, "R": 1, "D": 2, "T": 3}
    join = bytearray()
    for cp in range(0x0600, 0x0700):
        join.append(cls_code[_joining_class(cp)])
    for cp in range(0x0750, 0x0780):
        join.append(cls_code[_joining_class(cp)])
    assert len(join) == 304  # 4-aligned by construction
    out += bytes(join)
    for plan in arab_plans:
        out += struct.pack("<I", len(plan))
        out += struct.pack("<%dI" % len(plan), *plan) if plan else b""
    # --- v4 syllable pipelines: 21 stage plan arrays (9 Indic basic+pres,
    # 6 Khmer basic, 5 Myanmar basic, 1 USE presentation) -------------------
    for plan in syl_plans:
        out += struct.pack("<I", len(plan))
        out += struct.pack("<%dI" % len(plan), *plan) if plan else b""
    # --- v5 bidi: RLE class table + mirrored ranges (UAX#9 in C) -----------
    cls_ranges, mirror_ranges = _bidi_tables()
    out += struct.pack("<I", len(cls_ranges))
    for s0, e0, c0 in cls_ranges:
        out += struct.pack("<III", s0, e0, c0)
    out += struct.pack("<I", len(mirror_ranges))
    for s0, e0 in mirror_ranges:
        out += struct.pack("<II", s0, e0)
    return bytes(out)


def _norm_variations(variations):
    """Accept FontVariation objects or (tag, value) pairs; return the
    FontVariation tuple typefaces.var_advance expects (or () if empty)."""
    if not variations:
        return ()
    from .typefaces import FontVariation

    out = []
    for v in variations:
        if isinstance(v, FontVariation):
            out.append(v)
        else:
            tag, value = v
            out.append(FontVariation(tag=tag, value=float(value)))
    return tuple(out)


def save_font_pack(typeface_id: int, path: str, variations=()) -> None:
    with open(path, "wb") as fh:
        fh.write(build_font_pack(typeface_id, variations))
