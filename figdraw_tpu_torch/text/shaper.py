"""OpenType shaping over GSUB/GPOS tables (figdraw_tpu/text/shaper.py,
copied; the tables come from the port's reader, text/otf.py, under the
attribute names fontTools gives them, so the code reads them unchanged).

A direct mini-shaper on the font's own tables:

- GSUB lookup types 1 (single), 2 (multiple substitution — decomposed glyphs
  inherit the source cluster), 3 (alternates, first variant), 4 (ligatures,
  with per-component mark tagging for GPOS 5), and 5/6 ((chain) contexts,
  all three formats, with nested lookup application) — applied position-wise
  in LookupList order for the selected features; extensions (7) unwrapped;
  reverse chaining single substitution (8) applies last-to-first for the
  rclt/calt feature set. Default feature set mirrors HarfBuzz's horizontal
  defaults: ccmp, liga, clig, rlig (+ FigFont.features overrides: value 0
  disables, >0 enables extra tags like dlig/hlig/salt).
- GPOS kerning as a full positioning pass (shaper.position): single (1,
  XAdvance), pair (2, both formats) and (chain) contextual (7/8) lookups
  with nested application — modern fonts carry kerning here rather than in
  the legacy kern table, which layout.py uses as the fallback. Anchor
  attachment: cursive (3) chains exit/entry anchors (Nastaliq-style
  descending baselines), mark-to-base (4), mark-to-ligature (5 — anchor
  selected by the ligature component the mark logically follows, tracked
  through ligation) and mark-to-mark (6).

Lookup flags honor GDEF glyph classes (IgnoreBaseGlyphs/Ligatures/Marks) with
full HarfBuzz-grade mark handling: UseMarkFilteringSet (0x10) skips every
mark NOT in the lookup's GDEF MarkGlyphSet (marks in the set participate in
matching), and MarkAttachmentType (high byte) skips marks whose GDEF
MarkAttachClassDef class differs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from . import indic, use

DEFAULT_GSUB_FEATURES = ("ccmp", "liga", "clig", "rlig", "calt", "rclt", "locl")

# BCP-47 primary subtags → OpenType language system tags (the common set the
# reference reaches through HarfBuzz's full registry)
OT_LANG_TAGS = {
    "sr": "SRB", "mk": "MKD", "tr": "TRK", "az": "AZE", "ro": "ROM",
    "mo": "MOL", "ca": "CAT", "es": "ESP", "gl": "GAL", "ur": "URD",
    "ku": "KUR", "sd": "SND", "nl": "NLD", "de": "DEU", "fr": "FRA",
    "pl": "PLK", "vi": "VIT", "bg": "BGR", "ru": "RUS", "uk": "UKR",
}


def ot_language_tag(bcp47: str):
    """Primary-subtag lookup: "sr-Latn-RS" → "SRB"; unknown → None."""
    if not bcp47:
        return None
    return OT_LANG_TAGS.get(bcp47.split("-")[0].lower())


def _select_lookups(table, wanted_tags,
                    scripts=("DFLT", "latn", "arab", "hebr", "dev2", "deva",
                             "khmr", "mym2", "mymr"),
                    lang=None) -> List[int]:
    """Lookup indices for the wanted feature tags, unioned over the given
    script tags (features live per script; lookups are glyph-driven, so a
    union is safe — e.g. arab ligature lookups never match latin glyphs), in
    LookupList order. When `lang` names an OpenType language-system tag, each
    script's matching LangSys replaces its DefaultLangSys (locl et al)."""
    if table is None or table.FeatureList is None or table.ScriptList is None:
        return []
    by_tag = {sr.ScriptTag: sr.Script for sr in table.ScriptList.ScriptRecord}
    records = table.FeatureList.FeatureRecord
    lookups: List[int] = []
    chosen = [by_tag[t] for t in scripts if t in by_tag]
    if not chosen and table.ScriptList.ScriptRecord:
        chosen = [table.ScriptList.ScriptRecord[0].Script]
    # the cyrl/grek/hebr scripts aren't in the default union; include any
    # script that carries the requested language so locl rules are reachable
    if lang is not None:
        for sr in table.ScriptList.ScriptRecord:
            script = sr.Script
            if script in chosen:
                continue
            for lr in getattr(script, "LangSysRecord", ()) or ():
                if lr.LangSysTag.strip() == lang:
                    chosen.append(script)
                    break
    for script in chosen:
        if script is None:
            continue
        langsys = script.DefaultLangSys
        if lang is not None:
            for lr in getattr(script, "LangSysRecord", ()) or ():
                if lr.LangSysTag.strip() == lang:
                    langsys = lr.LangSys
                    break
        if langsys is None:
            continue
        for fi in langsys.FeatureIndex:
            if fi < len(records) and records[fi].FeatureTag in wanted_tags:
                lookups.extend(records[fi].Feature.LookupListIndex)
    return sorted(set(lookups))


def _unwrap(lookup, subtable):
    if lookup.LookupType in (7, 9):  # GSUB/GPOS extension
        return subtable.ExtensionLookupType, subtable.ExtSubTable
    return lookup.LookupType, subtable


class OpenTypeShaper:
    """Per-typeface shaping tables; build with `get_shaper(typeface)`."""

    def __init__(self, tt):
        self._tt = tt
        self._cmap: Optional[dict] = None  # lazy, Thai/Lao decomposition only
        self._gsub = tt.get("GSUB")
        # feature set → ordered list of compiled lookups (skip_classes, entries)
        self._plans: Dict[frozenset, List[tuple]] = {}
        self._lookups: Dict[int, tuple] = {}  # lookup index → (skip, entries)
        # GDEF glyph classes (1 base, 2 ligature, 3 mark) for lookup flags
        self._gdef_class: Dict[str, int] = {}
        # GDEF v1.2 MarkGlyphSets (UseMarkFilteringSet targets) and
        # MarkAttachClassDef (MarkAttachmentType classes)
        self._mark_glyph_sets: Optional[List[frozenset]] = None
        self._mark_attach_class: Dict[str, int] = {}
        # GPOS 3 cursive chains — _build_gpos fills this; a GSUB-only font
        # (no GPOS table) must still answer cursive_chain()
        self._cursive: List[Dict[str, tuple]] = []
        gdef = tt.get("GDEF")
        if gdef is not None and gdef.table.GlyphClassDef is not None:
            self._gdef_class = dict(gdef.table.GlyphClassDef.classDefs)
        if gdef is not None:
            mac = getattr(gdef.table, "MarkAttachClassDef", None)
            if mac is not None:
                self._mark_attach_class = dict(mac.classDefs)
            mgs = getattr(gdef.table, "MarkGlyphSetsDef", None)
            if mgs is not None:
                self._mark_glyph_sets = [
                    frozenset(c.glyphs) for c in mgs.Coverage
                ]

        self._pair_specific: Dict[Tuple[str, str], int] = {}
        self._pair_class: List[Tuple[dict, dict, dict]] = []
        self._gpos_table = None
        self._gpos_lookups: Dict[int, tuple] = {}
        self._kern_lookups: Optional[List[int]] = None
        self.has_gpos_kern = False
        # mark-to-base (GPOS 4): [(mark {g: (cls, x, y)}, base {g: {cls: (x, y)}})]
        self._mark_base: List[Tuple[dict, dict]] = []
        # mark-to-ligature (GPOS 5):
        # [(mark {g: (cls, x, y)}, lig {g: [{cls: (x, y)} per component]})]
        self._mark_lig: List[Tuple[dict, dict]] = []
        # mark-to-mark (GPOS 6): [(mark1 {g: (cls, x, y)}, mark2 {g: {cls: (x, y)}})]
        self._mark_mark: List[Tuple[dict, dict]] = []
        self._mark_glyphs: set = set()
        gpos = tt.get("GPOS")
        if gpos is not None:
            self._build_gpos(gpos.table)

    # --- GSUB -----------------------------------------------------------------
    #
    # A lookup compiles to a list of subtable entries, tried in order at each
    # sequence position; the first match applies and the cursor moves past the
    # replaced input (OpenType lookup application model). Contextual chains
    # apply their nested lookups at the recorded input offsets.

    def _skipped(self, name: str, skip) -> bool:
        """LookupFlag glyph skipping. `skip` is the (classes, filter_set,
        attach_class) triple from _lookup_skip: IgnoreBaseGlyphs/Ligatures/
        Marks map to GDEF classes 1/2/3; when `filter_set` is a glyph set
        (UseMarkFilteringSet), every mark NOT in it is skipped and marks in
        it participate; else a nonzero `attach_class` (MarkAttachmentType)
        skips marks whose GDEF MarkAttachClassDef class differs."""
        classes, filter_set, attach_class = skip
        cls = self._gdef_class.get(name, 0)
        if cls and cls in classes:
            return True
        if cls == 3:
            if filter_set is not None:
                return name not in filter_set
            if attach_class:
                return self._mark_attach_class.get(name, 0) != attach_class
        return False

    _NO_SKIP = (frozenset(), None, 0)

    def _lookup_skip(self, lookup):
        """Compile a lookup's LookupFlag (+ MarkFilteringSet index) into the
        (classes, filter_set, attach_class) triple _skipped consumes.
        Precedence per the OpenType spec: IgnoreMarks skips all marks;
        otherwise UseMarkFilteringSet supersedes MarkAttachmentType."""
        flag = lookup.LookupFlag or 0
        classes = set()
        if flag & 0x02:
            classes.add(1)  # IgnoreBaseGlyphs
        if flag & 0x04:
            classes.add(2)  # IgnoreLigatures
        if flag & 0x08:
            classes.add(3)  # IgnoreMarks
        filter_set = None
        attach_class = 0
        if 3 not in classes:
            if flag & 0x10 and self._mark_glyph_sets is not None:
                idx = getattr(lookup, "MarkFilteringSet", None)
                if idx is not None and idx < len(self._mark_glyph_sets):
                    filter_set = self._mark_glyph_sets[idx]
            if filter_set is None:
                attach_class = flag >> 8
        if not classes and filter_set is None and not attach_class:
            return self._NO_SKIP
        return (frozenset(classes), filter_set, attach_class)

    def _compile_lookup(self, li: int):
        cached = self._lookups.get(li)
        if cached is not None:
            return cached
        table = self._gsub.table
        lookup = table.LookupList.Lookup[li]
        entries: List[tuple] = []
        for sub in lookup.SubTable:
            ltype, sub = _unwrap(lookup, sub)
            if ltype == 1:
                entries.append(("single", dict(sub.mapping)))
            elif ltype == 2:
                # multiple substitution (one glyph → a sequence, e.g. ccmp
                # decompositions); harfbuzzy.nim:395+ gets this via HarfBuzz
                entries.append((
                    "multiple",
                    {g: tuple(seq) for g, seq in sub.mapping.items()},
                ))
            elif ltype == 3:
                entries.append((
                    "single",
                    {g: alts[0] for g, alts in sub.alternates.items() if alts},
                ))
            elif ltype == 4:
                table_map: Dict[str, List[Tuple[Tuple[str, ...], str]]] = {}
                for first, ligs in sub.ligatures.items():
                    ents = [(tuple(l.Component), l.LigGlyph) for l in ligs]
                    ents.sort(key=lambda e: -len(e[0]))  # longest chains first
                    table_map[first] = ents
                entries.append(("liga", table_map))
            elif ltype in (5, 6):
                compiled = self._compile_context(ltype, sub)
                if compiled is not None:
                    entries.append(compiled)
            elif ltype == 8:
                # reverse chaining single substitution: applied last-to-first
                mapping = dict(zip(sub.Coverage.glyphs, sub.Substitute))
                entries.append(("rchain", {
                    "map": mapping,
                    "bt": [set(c.glyphs) for c in sub.BacktrackCoverage],
                    "la": [set(c.glyphs) for c in sub.LookAheadCoverage],
                }))
            # other types: unsupported, skipped
        result = (
            self._lookup_skip(lookup),
            entries,
            self._trigger_set(entries),
        )
        self._lookups[li] = result
        return result

    @staticmethod
    def _trigger_set(entries) -> Optional[frozenset]:
        """Union of glyphs that can start a match for any entry — a fast
        prefilter so the per-position loop skips irrelevant lookups with one
        set test. None = cannot prefilter (match anything)."""
        triggers = set()
        for entry in entries:
            kind = entry[0]
            if kind in ("single", "multiple", "liga"):
                triggers.update(entry[1].keys())
            elif kind == "rchain":
                triggers.update(entry[1]["map"].keys())
            else:
                _, fmt, data = entry
                if fmt == 1:
                    triggers.update(data["cov"].keys())
                elif fmt == 2:
                    triggers.update(data["cov"])
                else:
                    if not data["inp"]:
                        return None
                    triggers.update(data["inp"][0])
        return frozenset(triggers)

    @staticmethod
    def _attr(obj, *names):
        for n in names:
            v = getattr(obj, n, None)
            if v is not None:
                return v
        return None

    def _compile_context(self, ltype: int, sub):
        """(Chain)Context subst/pos → ("ctx", fmt, data). Rules are stored as
        (backtrack, input_rest, lookahead, records) with glyph names (fmt 1),
        class ids (fmt 2) or coverage sets (fmt 3). The same machinery serves
        GSUB 5/6 and GPOS 7/8 — only the attribute names differ."""
        chained = ltype in (6, 8)
        fmt = sub.Format

        def rule_records(r):
            recs = self._attr(r, "SubstLookupRecord", "PosLookupRecord") or ()
            return [(s.SequenceIndex, s.LookupListIndex) for s in recs]

        def unpack_rule(r):
            if chained:
                return (tuple(r.Backtrack), tuple(r.Input), tuple(r.LookAhead),
                        rule_records(r))
            # plain context rules: glyph rules carry Input, class rules Class
            inp = self._attr(r, "Input", "Class") or ()
            return ((), tuple(inp), (), rule_records(r))

        if fmt == 1:
            rules: Dict[str, list] = {}
            sets = self._attr(
                sub, "ChainSubRuleSet", "ChainPosRuleSet",
                "SubRuleSet", "PosRuleSet",
            )
            for first, rule_set in zip(sub.Coverage.glyphs, sets):
                if rule_set is None:
                    continue
                rlist = self._attr(
                    rule_set, "ChainSubRule", "ChainPosRule", "SubRule", "PosRule",
                ) or ()
                rules[first] = [unpack_rule(r) for r in rlist]
            return ("ctx", 1, {"cov": rules})
        if fmt == 2:
            cov = set(sub.Coverage.glyphs)
            in_cd = sub.InputClassDef.classDefs if getattr(sub, "InputClassDef", None) else {}
            if not in_cd and getattr(sub, "ClassDef", None):
                in_cd = sub.ClassDef.classDefs  # plain context fmt 2
            bt_cd = (sub.BacktrackClassDef.classDefs
                     if chained and sub.BacktrackClassDef else {})
            la_cd = (sub.LookAheadClassDef.classDefs
                     if chained and sub.LookAheadClassDef else {})
            class_rules: Dict[int, list] = {}
            sets = self._attr(
                sub, "ChainSubClassSet", "ChainPosClassSet",
                "SubClassSet", "PosClassSet",
            ) or ()
            for ci, cs in enumerate(sets):
                if cs is None:
                    continue
                rlist = self._attr(
                    cs, "ChainSubClassRule", "ChainPosClassRule",
                    "SubClassRule", "PosClassRule",
                ) or ()
                class_rules[ci] = [unpack_rule(r) for r in rlist]
            return ("ctx", 2, {
                "cov": cov, "in_cd": in_cd, "bt_cd": bt_cd, "la_cd": la_cd,
                "rules": class_rules,
            })
        if fmt == 3:
            if chained:
                bt = [set(c.glyphs) for c in sub.BacktrackCoverage]
                inp = [set(c.glyphs) for c in sub.InputCoverage]
                la = [set(c.glyphs) for c in sub.LookAheadCoverage]
            else:
                bt, la = [], []
                inp = [set(c.glyphs) for c in sub.Coverage]
            recs = self._attr(sub, "SubstLookupRecord", "PosLookupRecord") or ()
            return ("ctx", 3, {
                "bt": bt, "inp": inp, "la": la,
                "recs": [(s.SequenceIndex, s.LookupListIndex) for s in recs],
            })
        return None

    def _next_pos(self, names, j, skip):
        """First non-skipped position >= j, or len(names)."""
        n = len(names)
        while j < n and self._skipped(names[j], skip):
            j += 1
        return j

    def _prev_pos(self, names, j, skip):
        """First non-skipped position <= j, or -1."""
        while j >= 0 and self._skipped(names[j], skip):
            j -= 1
        return j

    @staticmethod
    def _mask_ok(masks, req, pos) -> bool:
        """HarfBuzz lookup-mask semantics: when a stage applies a masked
        feature (`req`), an input glyph participates only if its tag set
        carries the tag — a mismatching glyph fails the match (it is NOT
        skipped). Mask entries are frozensets (a glyph can be eligible for
        several masked features, e.g. an Indic halant in both half and
        blwf pairs) or None (no masked feature applies here)."""
        if req is None or masks is None:
            return True
        m = masks[pos]
        return m is not None and req in m

    def _try_entry_at(self, entry, names, clusters, comps, i, skip,
                      masks=None, req=None) -> Optional[int]:
        """Apply one compiled subtable entry at position i (in place),
        skipping LookupFlag-ignored glyphs when matching multi-glyph input.
        comps is the parallel (lig_size, attach_comp) list substitute_ex
        threads through for GPOS 5; masks is the optional parallel
        feature-mask list staged shaping (Arabic/Indic) threads through, with
        `req` the tag this stage requires on matched input glyphs. Returns
        the next cursor position on match, else None."""
        kind = entry[0]
        if kind == "single":
            repl = entry[1].get(names[i])
            if repl is None:
                return None
            names[i] = repl
            return i + 1
        if kind == "multiple":
            seq = entry[1].get(names[i])
            if seq is None:
                return None
            if not seq:
                # empty sequence = glyph deletion (HarfBuzz semantics)
                del names[i]
                del clusters[i]
                del comps[i]
                if masks is not None:
                    del masks[i]
                return i
            # every decomposed glyph inherits the source cluster (and mask)
            cl = clusters[i]
            names[i : i + 1] = list(seq)
            clusters[i : i + 1] = [cl] * len(seq)
            comps[i : i + 1] = [(1, -1)] * len(seq)
            if masks is not None:
                masks[i : i + 1] = [masks[i]] * len(seq)
            return i + len(seq)
        if kind == "liga":
            ents = entry[1].get(names[i])
            if not ents:
                return None
            for comp_seq, lig in ents:
                pos = [i]
                j = i + 1
                ok = True
                for comp in comp_seq:
                    j = self._next_pos(names, j, skip)
                    if j >= len(names) or names[j] != comp or \
                            not self._mask_ok(masks, req, j):
                        ok = False
                        break
                    pos.append(j)
                    j += 1
                if not ok:
                    continue
                # the ligature replaces the first component; later matched
                # components are removed, skipped glyphs in between stay put
                # (they ride after the ligature, HarfBuzz-style) tagged with
                # the ligature component they followed (GPOS 5 anchors are
                # per-component)
                names[i] = lig
                clusters[i] = (clusters[pos[0]][0], clusters[pos[-1]][1])
                comps[i] = (len(pos), -1)
                for k in range(len(pos) - 1):
                    for q in range(pos[k] + 1, pos[k + 1]):
                        comps[q] = (comps[q][0], k)
                for p in reversed(pos[1:]):
                    del names[p]
                    del clusters[p]
                    del comps[p]
                    if masks is not None:
                        del masks[p]
                return i + 1
            return None
        if kind == "rchain":
            data = entry[1]
            repl = data["map"].get(names[i])
            if repl is None:
                return None
            j = i
            for want in data["bt"]:
                j = self._prev_pos(names, j - 1, skip)
                if j < 0 or names[j] not in want:
                    return None
            j = i
            for want in data["la"]:
                j = self._next_pos(names, j + 1, skip)
                if j >= len(names) or names[j] not in want:
                    return None
            names[i] = repl
            return i + 1
        # contextual
        _, fmt, data = entry
        match = None  # (matched input positions, records)
        if fmt == 1:
            for bt, inp, la, recs in data["cov"].get(names[i], ()):  # noqa: B020
                m = self._match_ctx(names, i, bt, inp, la, skip, mode="glyph",
                                    masks=masks, req=req)
                if m is not None:
                    match = (m, recs)
                    break
        elif fmt == 2:
            if names[i] in data["cov"]:
                ci = data["in_cd"].get(names[i], 0)
                for bt, inp, la, recs in data["rules"].get(ci, ()):  # noqa: B020
                    m = self._match_ctx(names, i, bt, inp, la, skip,
                                        mode="class",
                                        cds=(data["bt_cd"], data["in_cd"],
                                             data["la_cd"]),
                                        masks=masks, req=req)
                    if m is not None:
                        match = (m, recs)
                        break
        else:
            inp = data["inp"]
            if inp and names[i] in inp[0]:
                m = self._match_ctx(names, i, data["bt"], inp[1:], data["la"],
                                    skip, mode="cov", masks=masks, req=req)
                if m is not None:
                    match = (m, data["recs"])
        if match is None:
            return None
        input_pos, recs = match
        end = input_pos[-1] + 1
        # nested lookups run at the recorded INPUT indices (which address the
        # matched, skip-filtered input sequence); earlier records may change
        # the sequence length, shifting later positions
        delta = 0
        for seq_idx, nested_li in recs:
            if seq_idx >= len(input_pos):
                continue
            pos = input_pos[seq_idx] + delta
            # pos < 0 happens only when an earlier record DELETED glyphs
            # before a later out-of-order record's position: skip it (Python
            # list indexing would silently wrap to the run's tail — the C
            # twin native/typeset.cpp apply_nested_sub skips, and both now
            # agree)
            if pos < 0 or pos >= len(names):
                continue
            before = len(names)
            n_skip, n_entries, _n_trig = self._compile_lookup(nested_li)
            if self._skipped(names[pos], n_skip):
                continue
            for nested in n_entries:
                if self._try_entry_at(
                    nested, names, clusters, comps, pos, n_skip,
                    masks=masks, req=req
                ) is not None:
                    break
            delta += len(names) - before
        return end + delta

    def _match_ctx(self, names, i, bt, inp, la, skip, mode, cds=None,
                   masks=None, req=None):
        """Match a (chain) context at i with flag skipping. Returns the list
        of matched input positions (starting with i), or None. Input glyphs
        must carry the stage's feature mask (`req`); backtrack/lookahead are
        not mask-checked (HarfBuzz semantics)."""

        def value_match(g, want, which):
            if mode == "glyph":
                return g == want
            if mode == "class":
                cd = cds[which]
                return cd.get(g, 0) == want
            return g in want  # coverage sets

        j = i
        for want in bt:  # closest-first order
            j = self._prev_pos(names, j - 1, skip)
            if j < 0 or not value_match(names[j], want, 0):
                return None
        input_pos = [i]
        j = i
        for want in inp:
            j = self._next_pos(names, j + 1, skip)
            if j >= len(names) or not value_match(names[j], want, 1) or \
                    not self._mask_ok(masks, req, j):
                return None
            input_pos.append(j)
        j = input_pos[-1]
        for want in la:
            j = self._next_pos(names, j + 1, skip)
            if j >= len(names) or not value_match(names[j], want, 2):
                return None
        return input_pos

    def _plan(self, feature_tags: frozenset, lang=None) -> List[tuple]:
        key = (feature_tags, lang)
        plan = self._plans.get(key)
        if plan is None:
            plan = []
            if self._gsub is not None:
                table = self._gsub.table
                for li in _select_lookups(table, set(feature_tags), lang=lang):
                    plan.append(self._compile_lookup(li))
            self._plans[key] = plan
        return plan

    def substitute(
        self,
        names: Sequence[str],
        clusters: Sequence[Tuple[int, int]],
        features: Optional[frozenset] = None,
        lang: Optional[str] = None,
        cps: Optional[Sequence[int]] = None,
    ) -> Tuple[List[str], List[Tuple[int, int]]]:
        """Apply the selected GSUB lookups; clusters are (source_start,
        source_end) per glyph and merge across ligated components. lang is an
        OpenType language-system tag (ot_language_tag maps BCP-47)."""
        out_n, out_c, _comps = self.substitute_ex(names, clusters, features,
                                                  lang, cps)
        return out_n, out_c

    def substitute_ex(
        self,
        names: Sequence[str],
        clusters: Sequence[Tuple[int, int]],
        features: Optional[frozenset] = None,
        lang: Optional[str] = None,
        cps: Optional[Sequence[int]] = None,
    ) -> Tuple[List[str], List[Tuple[int, int]], List[Tuple[int, int]]]:
        """substitute() plus per-glyph ligature-component info for GPOS 5:
        the third list holds (lig_size, attach_comp) — lig_size > 1 marks a
        ligature of that many components; attach_comp >= 0 tags a skipped
        mark with the 0-based component it logically follows (-1 = untagged;
        marks following the whole ligature attach to its last component).
        `cps` (source codepoints, 1:1 with `names`) routes Arabic-script
        runs through the staged positional pipeline."""
        feats = (features if features is not None
                 else frozenset(DEFAULT_GSUB_FEATURES))
        out_n = list(names)
        out_c = list(clusters)
        out_l: List[Tuple[int, int]] = [(1, -1)] * len(out_n)
        if cps is not None and any(_is_arabic_script(cp) for cp in cps):
            self._substitute_arabic(out_n, out_c, out_l, cps, feats, lang)
        elif cps is not None and any(indic.is_devanagari(cp) for cp in cps):
            self._substitute_indic(out_n, out_c, out_l, cps, feats, lang)
        elif cps is not None and any(
            use.is_khmer(cp) or use.is_myanmar(cp) for cp in cps
        ):
            self._substitute_use(out_n, out_c, out_l, cps, feats, lang)
        elif cps is not None and any(cp in THAI_SARA_AM for cp in cps):
            self._substitute_thai(out_n, out_c, out_l, cps, feats, lang)
        else:
            self._apply_plan(self._plan(feats, lang), out_n, out_c, out_l)
        return out_n, out_c, out_l

    def _apply_plan(self, plan, out_n, out_c, out_l, masks=None, req=None):
        """Run compiled lookups over the glyph run in place. `masks`/`req`
        implement HarfBuzz stage masks: only positions tagged `req` may start
        or participate in a match (staged Arabic/Indic shaping)."""
        for skip, entries, triggers in plan:
            if triggers is not None and not triggers.intersection(out_n):
                continue  # nothing in this run can start a match
            if entries and entries[0][0] == "rchain":
                # reverse chaining lookups walk the sequence last-to-first
                for i in range(len(out_n) - 1, -1, -1):
                    nm = out_n[i]
                    if (triggers is not None and nm not in triggers) or \
                            self._skipped(nm, skip) or \
                            not self._mask_ok(masks, req, i):
                        continue
                    for entry in entries:
                        if self._try_entry_at(
                            entry, out_n, out_c, out_l, i, skip,
                            masks=masks, req=req
                        ) is not None:
                            break
                continue
            i = 0
            while i < len(out_n):
                nm = out_n[i]
                if (triggers is not None and nm not in triggers) or \
                        self._skipped(nm, skip) or \
                        not self._mask_ok(masks, req, i):
                    i += 1
                    continue
                nxt = None
                for entry in entries:
                    nxt = self._try_entry_at(entry, out_n, out_c, out_l, i, skip,
                                             masks=masks, req=req)
                    if nxt is not None:
                        break
                i = nxt if nxt is not None else i + 1

    # Positional features, each its own masked stage in this order (HarfBuzz
    # arabic shaper stage list; fin2/fin3/med2 are Syriac-only but harmless)
    ARABIC_POSITIONAL = ("isol", "fina", "fin2", "fin3", "medi", "med2", "init")

    def _cp_name(self, cp: int) -> Optional[str]:
        """cmap lookup for glyphs a preprocess step introduces that are not
        in the source run (Thai decomposition); lazy — most fonts never
        need it."""
        if self._cmap is None:
            try:
                self._cmap = self._tt.getBestCmap()
            except Exception:
                self._cmap = {}
        return self._cmap.get(cp)

    def _substitute_thai(self, out_n, out_c, out_l, cps, feats, lang) -> None:
        """thai_sara_am_preprocess (module function below), then the
        regular plan — Thai needs no positional staging beyond the
        decomposition (ccmp/liga + GPOS mark attachment run after)."""
        new_n, new_c, _ = thai_sara_am_preprocess(out_n, out_c, cps,
                                                  self._cp_name)
        out_n[:] = new_n
        out_c[:] = new_c
        out_l[:] = [(1, -1)] * len(new_n)
        self._apply_plan(self._plan(feats, lang), out_n, out_c, out_l)

    def _substitute_arabic(self, out_n, out_c, out_l, cps, feats, lang) -> None:
        """HarfBuzz-style staged Arabic shaping: ccmp/locl first, then each
        positional feature (isol/fina/medi/init) applied ONLY at positions
        the joining analysis tagged with it (masks survive decomposition and
        ligation), then rlig, then the remaining common features. Fonts like
        Noto Naskh decompose letters into skeleton+dot marks in ccmp and
        share lookups between positional features, so a global
        lookup-order pass mis-shapes them — the masks are load-bearing."""
        forms = arabic_forms(cps)
        masks: List[Optional[frozenset]] = [
            frozenset({f}) if f else frozenset({"isol"}) for f in forms
        ]
        # non-Arabic chars and transparent marks carry no positional tag
        for k, cp in enumerate(cps):
            if not _is_arabic_script(cp) or _joining_class(cp) == "T":
                masks[k] = None
        self._apply_plan(self._plan(frozenset({"ccmp", "locl"}), lang),
                         out_n, out_c, out_l, masks=masks)
        for tag in self.ARABIC_POSITIONAL:
            if tag not in feats and tag not in ("isol", "fina", "medi", "init"):
                continue
            plan = self._plan(frozenset({tag}), lang)
            if plan:
                self._apply_plan(plan, out_n, out_c, out_l,
                                 masks=masks, req=tag)
        self._apply_plan(self._plan(frozenset({"rlig"}), lang),
                         out_n, out_c, out_l, masks=masks)
        rest = feats - {"ccmp", "locl", "rlig"} - set(self.ARABIC_POSITIONAL)
        if rest:
            self._apply_plan(self._plan(frozenset(rest), lang),
                             out_n, out_c, out_l, masks=masks)

    # Indic (Devanagari) basic-feature stages, per OpenType spec order:
    # (tags, mask requirement). Masked stages fire only at the positions the
    # syllable analysis tagged (text/indic.py:build_masks).
    INDIC_BASIC_STAGES = (
        (frozenset({"locl", "nukt", "akhn"}), None),
        (frozenset({"rphf"}), "rphf"),
        (frozenset({"rkrf"}), None),
        (frozenset({"pref"}), "pref"),
        (frozenset({"blwf"}), "blwf"),
        (frozenset({"half"}), "half"),
        (frozenset({"pstf"}), "pstf"),
        (frozenset({"vatu", "cjct"}), None),
    )
    INDIC_PRES_FEATURES = frozenset({"pres", "abvs", "blws", "psts", "haln"})

    def _substitute_indic(self, out_n, out_c, out_l, cps, feats, lang) -> None:
        """Devanagari shaping à la HarfBuzz's Indic shaper: split the run
        into syllables (text/indic.py), apply the dev2 basic features per
        syllable with positional masks, reorder (pre-base matra to the
        front, reph to the after-post slot), then run the presentation
        features over the reordered glyphs. Non-Devanagari stretches go
        through the generic plan. Reference: HarfBuzz Indic shaping via
        harfbuzzy.nim:395+ (surfer_text_shaping_demo.nim:19-22)."""
        res_n: List[str] = []
        res_c: List[Tuple[int, int]] = []
        res_l: List[Tuple[int, int]] = []
        n = len(cps)
        i = 0
        while i < n:
            if indic.is_devanagari(cps[i]):
                j = indic.next_syllable(cps, i)
                s_n = out_n[i:j]
                s_c = out_c[i:j]
                s_m = out_l[i:j]
                self._shape_indic_syllable(s_n, s_c, s_m, cps[i:j], feats, lang)
            else:
                j = i
                while j < n and not indic.is_devanagari(cps[j]):
                    j += 1
                s_n = out_n[i:j]
                s_c = out_c[i:j]
                s_m = out_l[i:j]
                self._apply_plan(self._plan(feats, lang), s_n, s_c, s_m)
            res_n.extend(s_n)
            res_c.extend(s_c)
            res_l.extend(s_m)
            i = j
        out_n[:] = res_n
        out_c[:] = res_c
        out_l[:] = res_l

    def _shape_indic_syllable(self, names, clusters, comps, cps_syl, feats,
                              lang) -> None:
        """Shape ONE Devanagari syllable in place (lists are the syllable's
        slices). Order: basic features (masked per the syllable analysis) →
        reorder reph/pre-base matra → merged clusters → presentation
        features."""
        base, has_reph = indic.analyze_syllable(cps_syl)
        mask_tags = indic.build_masks(cps_syl, base, has_reph)
        masks: List[Optional[frozenset]] = [m if m else None for m in mask_tags]
        # identities that survive GSUB: the (start, end) source clusters
        reph_cluster = ((clusters[0][0], clusters[1][1]) if has_reph else None)
        matra_clusters = [clusters[k] for k, cp in enumerate(cps_syl)
                          if indic.category(cp) == indic.C_MATRA_PRE]
        sm_clusters = {clusters[k] for k, cp in enumerate(cps_syl)
                       if indic.category(cp) in (indic.C_SM, indic.C_VEDIC)}
        for tags, req in self.INDIC_BASIC_STAGES:
            plan = self._plan(tags, lang)
            if plan:
                self._apply_plan(plan, names, clusters, comps,
                                 masks=masks, req=req)
        moved = False
        # pre-base matra (i) moves to the front of the syllable
        for mc in matra_clusters:
            for k, c in enumerate(clusters):
                if c == mc:
                    if k != 0:
                        for lst in (names, clusters, comps, masks):
                            lst.insert(0, lst.pop(k))
                        moved = True
                    break
        # reph moves to the after-post slot: end of syllable, before
        # syllable modifiers (anusvara & co) — REPH_POS_AFTER_POST
        if has_reph and reph_cluster is not None:
            idx = next((k for k, c in enumerate(clusters)
                        if c == reph_cluster), None)
            if idx is not None:
                tgt = len(names)
                while tgt - 1 > idx and clusters[tgt - 1] in sm_clusters:
                    tgt -= 1
                if tgt - 1 > idx:
                    for lst in (names, clusters, comps, masks):
                        lst.insert(tgt - 1, lst.pop(idx))
                    moved = True
        if moved and clusters:
            # HarfBuzz merges clusters across a reordered syllable
            lo = min(c[0] for c in clusters)
            hi = max(c[1] for c in clusters)
            clusters[:] = [(lo, hi)] * len(clusters)
        pres = self.INDIC_PRES_FEATURES | (
            feats & frozenset({"calt", "clig", "liga", "dlig", "ccmp"})
        )
        self._apply_plan(self._plan(pres, lang), names, clusters, comps,
                         masks=masks)

    # Khmer basic stages (HarfBuzz khmer shaper feature list): positional
    # features fire only at the coeng-pair / robat positions use.khmer_masks
    # tagged. Reference path: textbackends/harfbuzzy.nim:395-684 (HarfBuzz
    # supplies these shapers to the reference for free).
    KHMER_BASIC_STAGES = (
        (frozenset({"locl", "ccmp"}), None),
        (frozenset({"pref"}), "pref"),
        (frozenset({"blwf"}), "blwf"),
        (frozenset({"abvf"}), "abvf"),
        (frozenset({"pstf"}), "pstf"),
        (frozenset({"cfar"}), "cfar"),
    )
    # Myanmar basic stages (OpenType Myanmar spec order)
    MYANMAR_BASIC_STAGES = (
        (frozenset({"locl", "ccmp"}), None),
        (frozenset({"rphf"}), "rphf"),
        (frozenset({"pref"}), "pref"),
        (frozenset({"blwf"}), "blwf"),
        (frozenset({"pstf"}), "pstf"),
    )
    USE_PRES_FEATURES = frozenset({"pres", "abvs", "blws", "psts"})

    def _substitute_use(self, out_n, out_c, out_l, cps, feats, lang) -> None:
        """Khmer/Myanmar (USE-class) shaping: split the run into syllables
        (text/use.py), apply the script's basic features per syllable with
        positional masks, reorder (pre-base vowels and coeng-Ro / medial-Ra
        to the front, Myanmar kinzi to after the base cluster), then run the
        presentation features over the reordered glyphs. Non-USE stretches
        go through the generic plan."""
        res_n: List[str] = []
        res_c: List[Tuple[int, int]] = []
        res_l: List[Tuple[int, int]] = []
        n = len(cps)
        i = 0
        while i < n:
            if use.is_khmer(cps[i]):
                j = use.khmer_next_syllable(cps, i)
                s_n, s_c, s_m = out_n[i:j], out_c[i:j], out_l[i:j]
                self._shape_khmer_syllable(s_n, s_c, s_m, cps[i:j], feats, lang)
            elif use.is_myanmar(cps[i]):
                j = use.myanmar_next_syllable(cps, i)
                s_n, s_c, s_m = out_n[i:j], out_c[i:j], out_l[i:j]
                self._shape_myanmar_syllable(s_n, s_c, s_m, cps[i:j], feats,
                                             lang)
            else:
                j = i
                while j < n and not (use.is_khmer(cps[j])
                                     or use.is_myanmar(cps[j])):
                    j += 1
                s_n, s_c, s_m = out_n[i:j], out_c[i:j], out_l[i:j]
                self._apply_plan(self._plan(feats, lang), s_n, s_c, s_m)
            res_n.extend(s_n)
            res_c.extend(s_c)
            res_l.extend(s_m)
            i = j
        out_n[:] = res_n
        out_c[:] = res_c
        out_l[:] = res_l

    @staticmethod
    def _move_to_front(names, clusters, comps, masks, ranges) -> bool:
        """Move every glyph whose source cluster lies inside one of `ranges`
        to the front of the syllable, preserving their relative order.
        Identity survives GSUB because ligated pairs merge to a cluster still
        contained in the recorded pair range. Returns True if anything
        actually moved."""
        if not ranges:
            return False
        idxs = [
            k for k, c in enumerate(clusters)
            if any(c[0] >= r0 and c[1] <= r1 for (r0, r1) in ranges)
        ]
        if not idxs or idxs == list(range(len(idxs))):
            return False
        items = [(names[k], clusters[k], comps[k], masks[k]) for k in idxs]
        for k in reversed(idxs):
            for lst in (names, clusters, comps, masks):
                del lst[k]
        for nm, cl, cm, mk in reversed(items):
            names.insert(0, nm)
            clusters.insert(0, cl)
            comps.insert(0, cm)
            masks.insert(0, mk)
        return True

    @staticmethod
    def _merge_syllable_clusters(clusters) -> None:
        """HarfBuzz merges clusters across a reordered syllable."""
        if clusters:
            lo = min(c[0] for c in clusters)
            hi = max(c[1] for c in clusters)
            clusters[:] = [(lo, hi)] * len(clusters)

    def _shape_khmer_syllable(self, names, clusters, comps, cps_syl, feats,
                              lang) -> None:
        """Shape ONE Khmer syllable in place: masked basic features →
        reorder (coeng+Ro then pre-base vowel to the front, vowel leftmost)
        → presentation features."""
        mask_tags = use.khmer_masks(cps_syl)
        masks: List[Optional[frozenset]] = [m if m else None for m in mask_tags]
        vpre_ranges, pref_ranges = use.khmer_reorder_ranges(clusters, cps_syl)
        for tags, req in self.KHMER_BASIC_STAGES:
            plan = self._plan(tags, lang)
            if plan:
                self._apply_plan(plan, names, clusters, comps,
                                 masks=masks, req=req)
        moved = self._move_to_front(names, clusters, comps, masks, pref_ranges)
        moved |= self._move_to_front(names, clusters, comps, masks, vpre_ranges)
        if moved:
            self._merge_syllable_clusters(clusters)
        pres = self.USE_PRES_FEATURES | (
            feats & frozenset({"calt", "clig", "liga", "dlig", "ccmp"})
        )
        self._apply_plan(self._plan(pres, lang), names, clusters, comps,
                         masks=masks)

    def _shape_myanmar_syllable(self, names, clusters, comps, cps_syl, feats,
                                lang) -> None:
        """Shape ONE Myanmar syllable in place: masked basic features
        (rphf forms the kinzi) → reorder (kinzi to after the base cluster,
        medial Ra then vowel E to the front) → presentation features."""
        has_kinzi = use.myanmar_has_kinzi(cps_syl, 0)
        mask_tags = use.myanmar_masks(cps_syl, has_kinzi)
        masks: List[Optional[frozenset]] = [m if m else None for m in mask_tags]
        vpre_ranges, medra_ranges, kinzi_range = use.myanmar_reorder_ranges(
            clusters, cps_syl, has_kinzi
        )
        base_end_idx = use.myanmar_base_cluster_end(cps_syl, has_kinzi)
        # source offset one past the base cluster, captured BEFORE GSUB
        # mutates the cluster list
        boundary = (
            clusters[base_end_idx][0] if base_end_idx < len(clusters)
            else clusters[-1][1]
        )
        for tags, req in self.MYANMAR_BASIC_STAGES:
            plan = self._plan(tags, lang)
            if plan:
                self._apply_plan(plan, names, clusters, comps,
                                 masks=masks, req=req)
        moved = False
        if kinzi_range is not None:
            kidx = [
                k for k, c in enumerate(clusters)
                if c[0] >= kinzi_range[0] and c[1] <= kinzi_range[1]
            ]
            if kidx:
                items = [(names[k], clusters[k], comps[k], masks[k])
                         for k in kidx]
                for k in reversed(kidx):
                    for lst in (names, clusters, comps, masks):
                        del lst[k]
                tgt = 0
                for k, c in enumerate(clusters):
                    if c[0] < boundary:
                        tgt = k + 1
                for off, (nm, cl, cm, mk) in enumerate(items):
                    names.insert(tgt + off, nm)
                    clusters.insert(tgt + off, cl)
                    comps.insert(tgt + off, cm)
                    masks.insert(tgt + off, mk)
                moved = True
        moved |= self._move_to_front(names, clusters, comps, masks,
                                     medra_ranges)
        moved |= self._move_to_front(names, clusters, comps, masks,
                                     vpre_ranges)
        if moved:
            self._merge_syllable_clusters(clusters)
        pres = self.USE_PRES_FEATURES | (
            feats & frozenset({"calt", "clig", "liga", "dlig", "ccmp"})
        )
        self._apply_plan(self._plan(pres, lang), names, clusters, comps,
                         masks=masks)

    # --- GPOS -----------------------------------------------------------------

    def _compile_gpos_lookup(self, li: int):
        cached = self._gpos_lookups.get(li)
        if cached is not None:
            return cached
        table = self._gpos_table
        lookup = table.LookupList.Lookup[li]
        entries: List[tuple] = []
        for sub in lookup.SubTable:
            ltype, sub = _unwrap(lookup, sub)
            if ltype == 1:  # single positioning
                mapping: Dict[str, int] = {}
                if sub.Format == 1:
                    adv = getattr(sub.Value, "XAdvance", 0) if sub.Value else 0
                    if adv:
                        for g in sub.Coverage.glyphs:
                            mapping[g] = adv
                else:
                    for g, v in zip(sub.Coverage.glyphs, sub.Value):
                        adv = getattr(v, "XAdvance", 0) if v else 0
                        if adv:
                            mapping[g] = adv
                if mapping:
                    entries.append(("pos1", mapping))
            elif ltype == 2:  # pair positioning
                if sub.Format == 1:
                    pairs: Dict[Tuple[str, str], Tuple[int, int]] = {}
                    for first, pair_set in zip(sub.Coverage.glyphs, sub.PairSet):
                        for rec in pair_set.PairValueRecord:
                            v1 = getattr(rec.Value1, "XAdvance", 0) if rec.Value1 else 0
                            v2 = getattr(rec.Value2, "XAdvance", 0) if rec.Value2 else 0
                            if v1 or v2:
                                pairs[(first, rec.SecondGlyph)] = (v1, v2)
                    entries.append(("pos2s", pairs))
                else:
                    cd1 = sub.ClassDef1.classDefs if sub.ClassDef1 else {}
                    cd2 = sub.ClassDef2.classDefs if sub.ClassDef2 else {}
                    matrix: Dict[Tuple[int, int], Tuple[int, int]] = {}
                    for c1, rec1 in enumerate(sub.Class1Record):
                        for c2, rec2 in enumerate(rec1.Class2Record):
                            v1 = getattr(rec2.Value1, "XAdvance", 0) if rec2.Value1 else 0
                            v2 = getattr(rec2.Value2, "XAdvance", 0) if rec2.Value2 else 0
                            if v1 or v2:
                                matrix[(c1, c2)] = (v1, v2)
                    entries.append(("pos2c", {
                        "cov": set(sub.Coverage.glyphs), "cd1": cd1, "cd2": cd2,
                        "m": matrix,
                    }))
            elif ltype in (7, 8):  # (chain) contextual positioning
                compiled = self._compile_context(ltype, sub)
                if compiled is not None:
                    entries.append(compiled)
            # 3 cursive attachment unsupported; 4-6 handled by _build_marks
        result = (self._lookup_skip(lookup), entries)
        self._gpos_lookups[li] = result
        return result

    def _try_pos_entry_at(self, entry, names, deltas, i, skip) -> Optional[int]:
        kind = entry[0]
        if kind == "pos1":
            adv = entry[1].get(names[i])
            if adv is None:
                return None
            deltas[i] += adv
            return i + 1
        if kind in ("pos2s", "pos2c"):
            j = self._next_pos(names, i + 1, skip)
            if j >= len(names):
                return None
            if kind == "pos2s":
                vals = entry[1].get((names[i], names[j]))
            else:
                data = entry[1]
                vals = None
                if names[i] in data["cov"]:
                    vals = data["m"].get((
                        data["cd1"].get(names[i], 0),
                        data["cd2"].get(names[j], 0),
                    ))
            if vals is None:
                return None
            v1, v2 = vals
            deltas[i] += v1
            if v2:
                deltas[j] += v2
                return j + 1  # Value2 set → move past the second glyph
            return j  # second glyph may start the next pair
        # contextual positioning
        _, fmt, data = entry
        match = None
        if fmt == 1:
            for bt, inp, la, recs in data["cov"].get(names[i], ()):  # noqa: B020
                m = self._match_ctx(names, i, bt, inp, la, skip, mode="glyph")
                if m is not None:
                    match = (m, recs)
                    break
        elif fmt == 2:
            if names[i] in data["cov"]:
                ci = data["in_cd"].get(names[i], 0)
                for bt, inp, la, recs in data["rules"].get(ci, ()):  # noqa: B020
                    m = self._match_ctx(names, i, bt, inp, la, skip,
                                        mode="class",
                                        cds=(data["bt_cd"], data["in_cd"],
                                             data["la_cd"]))
                    if m is not None:
                        match = (m, recs)
                        break
        else:
            inp = data["inp"]
            if inp and names[i] in inp[0]:
                m = self._match_ctx(names, i, data["bt"], inp[1:], data["la"],
                                    skip, mode="cov")
                if m is not None:
                    match = (m, data["recs"])
        if match is None:
            return None
        input_pos, recs = match
        for seq_idx, nested_li in recs:
            if seq_idx >= len(input_pos):
                continue
            pos = input_pos[seq_idx]
            n_skip, n_entries = self._compile_gpos_lookup(nested_li)
            if self._skipped(names[pos], n_skip):
                continue
            for nested in n_entries:
                if self._try_pos_entry_at(nested, names, deltas, pos, n_skip) is not None:
                    break
        return input_pos[-1] + 1

    def position(self, names: Sequence[str]) -> List[int]:
        """Per-glyph x-advance deltas (font units) from the kern feature:
        single (1), pair (2) and (chain) contextual (7/8) positioning with
        lookup-flag skipping — the full GPOS kerning model."""
        n = len(names)
        deltas = [0] * n
        if self._gpos_table is None:
            return deltas
        for li in self._kern_lookup_indices():
            skip, entries = self._compile_gpos_lookup(li)
            if not entries:
                continue
            i = 0
            while i < n:
                if self._skipped(names[i], skip):
                    i += 1
                    continue
                nxt = None
                for entry in entries:
                    nxt = self._try_pos_entry_at(entry, names, deltas, i, skip)
                    if nxt is not None:
                        break
                i = nxt if nxt is not None and nxt > i else i + 1
        return deltas

    def _kern_lookup_indices(self) -> List[int]:
        if self._kern_lookups is None:
            self._kern_lookups = (
                _select_lookups(self._gpos_table, {"kern", "dist"})
                if self._gpos_table is not None
                else []
            )
        return self._kern_lookups

    def cursive_chain(self, names: Sequence[str]):
        """GPOS 3 cursive attachment: per-glyph (advance_override, dy) in
        font units, or None. Logical-order model: glyph i's exit anchor meets
        glyph i+1's entry anchor — the x-advance of i becomes
        exit_i.x - entry_{i+1}.x and the vertical offset accumulates
        (Nastaliq-style descending baselines)."""
        if not self._cursive:
            return None
        n = len(names)
        adv: List[Optional[int]] = [None] * n
        dy = [0.0] * n
        cur_dy = 0.0
        prev = None  # (index, exit anchor)
        for i, nm in enumerate(names):
            rec = None
            for table in self._cursive:
                rec = table.get(nm)
                if rec is not None:
                    break
            if rec is None:
                prev = None
                cur_dy = 0.0
                continue
            entry, exit_ = rec
            if prev is not None and entry is not None:
                pidx, pexit = prev
                adv[pidx] = pexit[0] - entry[0]
                cur_dy += pexit[1] - entry[1]
                dy[i] = cur_dy
            else:
                cur_dy = 0.0
            prev = (i, exit_) if exit_ is not None else None
        if all(a is None for a in adv) and not any(dy):
            return None
        return adv, dy

    def _build_gpos(self, table) -> None:
        self._gpos_table = table
        # GPOS 3 cursive attachment: glyph → (entry (x, y) | None, exit | None)
        self._cursive: List[Dict[str, tuple]] = []
        for li in _select_lookups(table, {"curs"},
                                  scripts=("DFLT", "latn", "arab")):
            lookup = table.LookupList.Lookup[li]
            for sub in lookup.SubTable:
                ltype, sub = _unwrap(lookup, sub)
                if ltype != 3:
                    continue
                m: Dict[str, tuple] = {}
                for g, rec in zip(sub.Coverage.glyphs, sub.EntryExitRecord):
                    entry = (
                        (rec.EntryAnchor.XCoordinate, rec.EntryAnchor.YCoordinate)
                        if rec.EntryAnchor is not None else None
                    )
                    exit_ = (
                        (rec.ExitAnchor.XCoordinate, rec.ExitAnchor.YCoordinate)
                        if rec.ExitAnchor is not None else None
                    )
                    m[g] = (entry, exit_)
                if m:
                    self._cursive.append(m)
        self._build_marks(table)
        for li in _select_lookups(table, {"kern", "dist"}):
            lookup = table.LookupList.Lookup[li]
            for sub in lookup.SubTable:
                ltype, sub = _unwrap(lookup, sub)
                if ltype in (1, 7, 8):
                    self.has_gpos_kern = True
                if ltype != 2:
                    continue
                self.has_gpos_kern = True
                if sub.Format == 1:
                    for first, pair_set in zip(sub.Coverage.glyphs, sub.PairSet):
                        for rec in pair_set.PairValueRecord:
                            adv = getattr(rec.Value1, "XAdvance", 0) if rec.Value1 else 0
                            if adv:
                                key = (first, rec.SecondGlyph)
                                self._pair_specific.setdefault(key, adv)
                else:
                    cd1 = sub.ClassDef1.classDefs if sub.ClassDef1 else {}
                    cd2 = sub.ClassDef2.classDefs if sub.ClassDef2 else {}
                    matrix: Dict[Tuple[int, int], int] = {}
                    for c1, rec1 in enumerate(sub.Class1Record):
                        for c2, rec2 in enumerate(rec1.Class2Record):
                            adv = getattr(rec2.Value1, "XAdvance", 0) if rec2.Value1 else 0
                            if adv:
                                matrix[(c1, c2)] = adv
                    cov = set(sub.Coverage.glyphs)
                    self._pair_class.append((cd1, cd2, {"cov": cov, "m": matrix}))

    def _build_marks(self, table) -> None:
        def mark_map(coverage, mark_array):
            m = {}
            for g, rec in zip(coverage.glyphs, mark_array.MarkRecord):
                a = rec.MarkAnchor
                if a is not None:
                    m[g] = (rec.Class, a.XCoordinate, a.YCoordinate)
            return m

        # abvm/blwm are the Indic above/below mark features (reph, matras,
        # anusvara placement in dev2 fonts) — same MarkBasePos machinery
        for li in _select_lookups(table, {"mark", "mkmk", "abvm", "blwm"}):
            lookup = table.LookupList.Lookup[li]
            for sub in lookup.SubTable:
                ltype, sub = _unwrap(lookup, sub)
                if ltype == 4:  # mark-to-base
                    marks = mark_map(sub.MarkCoverage, sub.MarkArray)
                    bases: Dict[str, dict] = {}
                    for g, rec in zip(sub.BaseCoverage.glyphs,
                                      sub.BaseArray.BaseRecord):
                        anchors = {}
                        for cls, a in enumerate(rec.BaseAnchor):
                            if a is not None:
                                anchors[cls] = (a.XCoordinate, a.YCoordinate)
                        bases[g] = anchors
                    self._mark_base.append((marks, bases))
                    self._mark_glyphs.update(marks)
                elif ltype == 5:  # mark-to-ligature (per-component anchors)
                    marks = mark_map(sub.MarkCoverage, sub.MarkArray)
                    ligs: Dict[str, list] = {}
                    for g, att in zip(sub.LigatureCoverage.glyphs,
                                      sub.LigatureArray.LigatureAttach):
                        comps = []
                        for crec in att.ComponentRecord:
                            anchors = {}
                            for cls, a in enumerate(crec.LigatureAnchor):
                                if a is not None:
                                    anchors[cls] = (a.XCoordinate, a.YCoordinate)
                            comps.append(anchors)
                        ligs[g] = comps
                    self._mark_lig.append((marks, ligs))
                    self._mark_glyphs.update(marks)
                elif ltype == 6:  # mark-to-mark
                    marks1 = mark_map(sub.Mark1Coverage, sub.Mark1Array)
                    marks2: Dict[str, dict] = {}
                    for g, rec in zip(sub.Mark2Coverage.glyphs,
                                      sub.Mark2Array.Mark2Record):
                        anchors = {}
                        for cls, a in enumerate(rec.Mark2Anchor):
                            if a is not None:
                                anchors[cls] = (a.XCoordinate, a.YCoordinate)
                        marks2[g] = anchors
                    self._mark_mark.append((marks1, marks2))
                    self._mark_glyphs.update(marks1)

    def is_mark(self, name: str) -> bool:
        return name in self._mark_glyphs

    def mark_attach(self, base: str, mark: str) -> Optional[Tuple[int, int]]:
        """(dx, dy) in font units placing `mark`'s anchor on `base`'s anchor
        (relative to the base glyph origin, y-up)."""
        for marks, bases in self._mark_base:
            rec = marks.get(mark)
            if rec is None:
                continue
            cls, mx, my = rec
            anchors = bases.get(base)
            if anchors is None or cls not in anchors:
                continue
            bx, by = anchors[cls]
            return bx - mx, by - my
        return None

    def mark_attach_ligature(
        self, lig: str, mark: str, component: int
    ) -> Optional[Tuple[int, int]]:
        """GPOS 5: (dx, dy) in font units placing `mark`'s anchor on the
        anchor of the given 0-based `component` of ligature glyph `lig`
        (relative to the ligature origin, y-up). component < 0 selects the
        last component (marks trailing the whole ligature)."""
        for marks, ligs in self._mark_lig:
            rec = marks.get(mark)
            if rec is None:
                continue
            comps = ligs.get(lig)
            if not comps:
                continue
            cls, mx, my = rec
            ci = component if component >= 0 else len(comps) - 1
            anchors = comps[min(ci, len(comps) - 1)]
            if cls not in anchors:
                continue
            bx, by = anchors[cls]
            return bx - mx, by - my
        return None

    def mark_attach_mark(self, mark2: str, mark1: str) -> Optional[Tuple[int, int]]:
        """Mark-to-mark stacking: place mark1 relative to mark2's origin."""
        for marks1, marks2 in self._mark_mark:
            rec = marks1.get(mark1)
            if rec is None:
                continue
            cls, mx, my = rec
            anchors = marks2.get(mark2)
            if anchors is None or cls not in anchors:
                continue
            bx, by = anchors[cls]
            return bx - mx, by - my
        return None

    def pair_kern(self, first: str, second: str) -> int:
        """X-advance adjustment (font units) for the glyph pair."""
        v = self._pair_specific.get((first, second))
        if v is not None:
            return v
        for cd1, cd2, data in self._pair_class:
            if first not in data["cov"]:
                continue
            c1 = cd1.get(first, 0)
            c2 = cd2.get(second, 0)
            v = data["m"].get((c1, c2))
            if v is not None:
                return v
        return 0


# --- Arabic joining (cursive forms) ---------------------------------------------
#
# Joining classes per Unicode ArabicShaping.txt semantics for the core block:
# R = right-joining (connects only to the preceding letter), D = dual-joining,
# U = non-joining, T = transparent (combining marks skipped by the algorithm).
# Letters of the block not listed default to D; non-letters to U.

_ARABIC_R = frozenset([
    0x0622, 0x0623, 0x0624, 0x0625, 0x0627, 0x0629, 0x062F, 0x0630, 0x0631,
    0x0632, 0x0648, 0x0671, 0x0672, 0x0673, 0x0675, 0x0676, 0x0677, 0x0688,
    0x0689, 0x068A, 0x068B, 0x068C, 0x068D, 0x068E, 0x068F, 0x0690, 0x0691,
    0x0692, 0x0693, 0x0694, 0x0695, 0x0696, 0x0697, 0x0698, 0x0699, 0x06C0,
    0x06C3, 0x06C4, 0x06C5, 0x06C6, 0x06C7, 0x06C8, 0x06C9, 0x06CA, 0x06CB,
    0x06CD, 0x06CF, 0x06D2, 0x06D3, 0x06D5,
])
_ARABIC_U = frozenset([0x0621, 0x0674, 0x06D4])


def _is_arabic_script(cp: int) -> bool:
    """Arabic block + Arabic Supplement (the ranges the joining-class pass
    understands) — gates the staged positional pipeline."""
    return 0x0600 <= cp <= 0x06FF or 0x0750 <= cp <= 0x077F


# The above-base marks the reordered nikhahit crosses — HarfBuzz's
# is_tone_mark set (hb-ot-shaper-thai.cc), which despite its name covers
# every above-base mark: MAI HAN-AKAT, the above vowels, MAITAIKHU, the
# four tones, THANTHAKHAT, NIKHAHIT, YAMAKKAN (and the Lao equivalents)
_THAI_ABOVE_MARKS = frozenset(
    [0x0E31, 0x0E34, 0x0E35, 0x0E36, 0x0E37,
     0x0E47, 0x0E48, 0x0E49, 0x0E4A, 0x0E4B, 0x0E4C, 0x0E4D, 0x0E4E])
# HarfBuzz folds Lao onto Thai with u & ~0x0080 before the range test, so
# the Lao set is the Thai set + 0x80 exactly: MAI KAN, above vowels,
# 0x0EC7 (unassigned but folded in), tones, CANCELLATION, NIGGAHITA,
# 0x0ECE (Lao yamakkan)
_LAO_ABOVE_MARKS = frozenset(cp + 0x80 for cp in _THAI_ABOVE_MARKS)

# Thai SARA AM / Lao AM → (nikhahit, sara aa, crossable above-base marks)
# for the HarfBuzz Thai shaper's Uniscribe-compatible decomposition
# (hb-ot-shaper-thai.cc preprocess_text; harfbuzzy.nim reaches it for free)
THAI_SARA_AM = {
    0x0E33: (0x0E4D, 0x0E32, _THAI_ABOVE_MARKS),
    0x0EB3: (0x0ECD, 0x0EB2, _LAO_ABOVE_MARKS),
}


def thai_sara_am_preprocess(names, clusters, cps, cp_name):
    """The HarfBuzz Thai/Lao shaper's Uniscribe-compatible preprocess
    (hb-ot-shaper-thai.cc preprocess_text): decompose SARA AM U+0E33
    (Lao AM U+0EB3) into NIKHAHIT U+0E4D (U+0ECD) + SARA AA U+0E32
    (U+0EB2), then move the nikhahit backwards over any contiguous
    preceding above-base marks (_THAI_ABOVE_MARKS/_LAO_ABOVE_MARKS) so it
    renders above the base consonant, under them. The moved span merges
    clusters. A font lacking either decomposition glyph keeps SARA AM
    as-is (HarfBuzz's has-glyph gate, via cp_name returning None).

    HarfBuzz runs this BEFORE any table lookup, so it is a module function:
    layout.py applies it even when the font has no GSUB/GPOS tables (no
    OpenTypeShaper). Returns (names, clusters, cps) as new lists."""
    new_n: List[str] = []
    new_c: List[Tuple[int, int]] = []
    new_cp: List[int] = []
    for k, cp in enumerate(cps):
        info = THAI_SARA_AM.get(cp)
        nik_name = aa_name = None
        if info is not None:
            nik_name = cp_name(info[0])
            aa_name = cp_name(info[1])
        if info is None or nik_name is None or aa_name is None:
            new_n.append(names[k])
            new_c.append(clusters[k])
            new_cp.append(cp)
            continue
        nik_cp, aa_cp, crossable = info
        j = len(new_n)
        while j > 0 and new_cp[j - 1] in crossable:
            j -= 1
        new_n.insert(j, nik_name)
        new_c.insert(j, clusters[k])
        new_cp.insert(j, nik_cp)
        new_n.append(aa_name)
        new_c.append(clusters[k])
        new_cp.append(aa_cp)
        # cluster merges exactly as hb-ot-shaper-thai.cc: marks crossed →
        # merge the whole moved span INCLUDING the appended SARA AA
        # [start, end); nothing crossed → the decomposed combining pair
        # merges with the PREVIOUS cluster [start-1, end) — selection/caret
        # ranges stay HarfBuzz-compatible
        end = len(new_n)
        if j + 2 < end:
            merged = range(j, end)
        elif j > 0:
            merged = range(j - 1, end)
        else:
            merged = range(0, 0)
        if len(merged) > 1:
            lo = min(new_c[s][0] for s in merged)
            hi = max(new_c[s][1] for s in merged)
            for s in merged:
                new_c[s] = (lo, hi)
    return new_n, new_c, new_cp


def _joining_class(cp: int) -> str:
    if 0x064B <= cp <= 0x065F or cp == 0x0670 or 0x0610 <= cp <= 0x061A \
            or 0x06D6 <= cp <= 0x06DC or 0x06DF <= cp <= 0x06E4 \
            or cp in (0x06E7, 0x06E8) or 0x06EA <= cp <= 0x06ED:
        return "T"
    if not (0x0600 <= cp <= 0x06FF or 0x0750 <= cp <= 0x077F):
        return "U"
    if cp in _ARABIC_R:
        return "R"
    if cp in _ARABIC_U:
        return "U"
    import unicodedata
    ch = chr(cp)
    if unicodedata.category(ch) in ("Lo", "Lm"):
        return "D"  # dual-joining default for letters (incl. 0640 tatweel via Lm)
    if cp == 0x0640:
        return "D"
    return "U"


def arabic_forms(cps: Sequence[int]) -> List[str]:
    """Per-character form selection in logical order: '' (isolated/other),
    'init', 'medi', 'fina'."""
    n = len(cps)
    cls = [_joining_class(cp) for cp in cps]

    def prev_join(i: int) -> bool:
        # does the previous non-transparent char connect forward?
        j = i - 1
        while j >= 0 and cls[j] == "T":
            j -= 1
        return j >= 0 and cls[j] == "D"

    def next_join(i: int) -> bool:
        # does the next non-transparent char connect backward?
        j = i + 1
        while j < n and cls[j] == "T":
            j += 1
        return j < n and cls[j] in ("R", "D")

    out = []
    for i, cp in enumerate(cps):
        c = cls[i]
        if c not in ("R", "D"):
            out.append("")
            continue
        before = prev_join(i) and c in ("R", "D")
        after = c == "D" and next_join(i)
        if before and after:
            out.append("medi")
        elif before:
            out.append("fina")
        elif after:
            out.append("init")
        else:
            out.append("")
    return out


def get_shaper(typeface) -> Optional[OpenTypeShaper]:
    """Cached shaper for a Typeface; None when the font has no usable
    GSUB/GPOS tables."""
    cached = getattr(typeface, "_ot_shaper", False)
    if cached is not False:
        return cached
    shaper: Optional[OpenTypeShaper] = None
    try:
        tt = typeface._tt
        if tt.get("GSUB") is not None or tt.get("GPOS") is not None:
            shaper = OpenTypeShaper(tt)
    except Exception:
        shaper = None
    typeface._ot_shaper = shaper
    return shaper
