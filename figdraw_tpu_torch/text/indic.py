"""Devanagari (Indic) syllable analysis for the OpenType shaper
(figdraw_tpu/text/indic.py, copied).

The script-specific pass the generic OTL applier cannot do: syllable
segmentation, base-consonant finding, reph detection, and the reordering
rules (reph to after-post position, pre-base matra to syllable start) that
HarfBuzz's Indic shaper performs around the dev2 feature set
(nukt/akhn/rphf/rkrf/blwf/half/cjct, then pres/abvs/blws/psts/haln).
shaper.OpenTypeShaper._substitute_indic drives these per syllable with
HarfBuzz-style feature masks.

Categories follow the OpenType Devanagari spec (simplified to the
Devanagari block; ZWJ/ZWNJ ride along as transparent members of a
syllable — explicit half-form requests are handled by the font's own
contextual lookups where present).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

# Character classes (Devanagari block 0x0900-0x097F)
C_OTHER = 0       # not part of a Devanagari syllable
C_CONSONANT = 1
C_VOWEL = 2       # independent vowel
C_MATRA_PRE = 3   # pre-base dependent vowel (i)
C_MATRA = 4       # post/above/below dependent vowel
C_NUKTA = 5
C_HALANT = 6
C_SM = 7          # syllable modifier (candrabindu/anusvara/visarga)
C_ZWJ = 8         # ZWJ / ZWNJ (transparent within a syllable)
C_AVAGRAHA = 9
C_VEDIC = 10      # vedic tone marks (ride at syllable end like SM)

RA = 0x0930
HALANT = 0x094D
ZWNJ, ZWJ = 0x200C, 0x200D

_CONSONANTS = frozenset(
    list(range(0x0915, 0x093A)) + list(range(0x0958, 0x0960)) +
    list(range(0x0978, 0x0980))
)
_INDEP_VOWELS = frozenset(
    list(range(0x0904, 0x0915)) + [0x0960, 0x0961] +
    list(range(0x0972, 0x0978)) + [0x0950]  # OM behaves as a standalone base
)
_MATRAS = frozenset(
    [0x093A, 0x093B] + list(range(0x093E, 0x094D)) + [0x094E, 0x094F] +
    list(range(0x0955, 0x0958)) + [0x0962, 0x0963]
)
_SM = frozenset([0x0900, 0x0901, 0x0902, 0x0903])
_VEDIC = frozenset([0x0951, 0x0952, 0x0953, 0x0954])


def category(cp: int) -> int:
    if cp in _CONSONANTS:
        return C_CONSONANT
    if cp in _INDEP_VOWELS:
        return C_VOWEL
    if cp == 0x093F:
        return C_MATRA_PRE
    if cp in _MATRAS:
        return C_MATRA
    if cp == 0x093C:
        return C_NUKTA
    if cp == HALANT:
        return C_HALANT
    if cp in _SM:
        return C_SM
    if cp in (ZWNJ, ZWJ):
        return C_ZWJ
    if cp == 0x093D:
        return C_AVAGRAHA
    if cp in _VEDIC:
        return C_VEDIC
    return C_OTHER


def is_devanagari(cp: int) -> bool:
    """Chars the Indic pass owns (the block + the joiners it consumes)."""
    return 0x0900 <= cp <= 0x097F


def next_syllable(cps: Sequence[int], start: int) -> int:
    """End index (exclusive) of the syllable starting at `start`.

    Consonant syllable:  C N? (H (ZWJ|ZWNJ)? C N?)* (H (ZWNJ)? | M_pre? M* N?) SM* V*
    Vowel syllable:      V N? (H C)? M* SM* V*
    Standalone:          one char (avagraha takes trailing matras/SM).
    Returns start+1 for non-Devanagari characters (caller routes those to the
    generic path).
    """
    n = len(cps)
    i = start
    cat = category(cps[i])

    def eat_nukta():
        nonlocal i
        if i < n and category(cps[i]) == C_NUKTA:
            i += 1

    if cat in (C_CONSONANT, C_VOWEL):
        i += 1
        eat_nukta()
        # (H (ZWJ|ZWNJ)? C N?)* — conjoined consonant chain
        while i < n and category(cps[i]) == C_HALANT:
            j = i + 1
            if j < n and category(cps[j]) == C_ZWJ:
                j += 1
            if j < n and category(cps[j]) == C_CONSONANT:
                i = j + 1
                eat_nukta()
            else:
                # trailing (dead) halant, optionally + ZWNJ
                i += 1
                if i < n and category(cps[i]) == C_ZWJ:
                    i += 1
                break
        # dependent vowels
        while i < n and category(cps[i]) in (C_MATRA_PRE, C_MATRA):
            i += 1
            eat_nukta()
        while i < n and category(cps[i]) == C_SM:
            i += 1
        while i < n and category(cps[i]) == C_VEDIC:
            i += 1
        return i
    if cat in (C_SM, C_MATRA, C_MATRA_PRE, C_NUKTA, C_HALANT, C_AVAGRAHA,
               C_VEDIC):
        # broken cluster / standalone sign: consume the run of signs
        i += 1
        while i < n and category(cps[i]) in (C_MATRA, C_MATRA_PRE, C_NUKTA,
                                             C_SM, C_VEDIC):
            i += 1
        return i
    return i + 1


def analyze_syllable(cps: Sequence[int]) -> Tuple[int, bool]:
    """(base_index, has_reph) for one syllable's codepoints.

    Base = last consonant, except a syllable-final Ra reached through a
    halant is a rakar (below-base form) and the base moves left past it
    (BASE_POS_LAST with Devanagari's Ra-only below-base set). Reph = initial
    Ra + halant followed by at least one more consonant (REPH_MODE_IMPLICIT).
    """
    cats = [category(cp) for cp in cps]
    n = len(cps)
    has_reph = (
        n > 2 and cps[0] == RA and cats[1] == C_HALANT
        and any(c in (C_CONSONANT, C_VOWEL) for c in cats[2:])
    )
    limit = 2 if has_reph else 0
    # find last consonant; walk left past below-base (rakar) Ra forms
    base = -1
    for k in range(n - 1, limit - 1, -1):
        if cats[k] in (C_CONSONANT, C_VOWEL):
            base = k
            break
    while (
        base > limit and cps[base] == RA and base >= 1
        and cats[base - 1] == C_HALANT
        and any(cats[q] in (C_CONSONANT, C_VOWEL) for q in range(limit, base - 1))
    ):
        prev = -1
        for k in range(base - 2, limit - 1, -1):
            if cats[k] in (C_CONSONANT, C_VOWEL):
                prev = k
                break
        if prev < 0:
            break
        base = prev
    return base, has_reph


def build_masks(cps: Sequence[int], base: int, has_reph: bool) -> List[frozenset]:
    """Per-character masked-feature tags for the basic features that HarfBuzz
    applies positionally: rphf on the initial Ra+halant, half on pre-base
    consonant+halant pairs, blwf on halant+Ra rakar pairs (Devanagari
    BLWF_MODE_PRE_AND_POST). Global features (nukt/akhn/rkrf/cjct and the
    presentation set) need no tags."""
    n = len(cps)
    cats = [category(cp) for cp in cps]
    masks: List[set] = [set() for _ in range(n)]
    if has_reph:
        masks[0].add("rphf")
        masks[1].add("rphf")
    start = 2 if has_reph else 0
    # half: every consonant BEFORE base that connects forward via halant.
    # Joiner semantics (HarfBuzz): halant+ZWJ explicitly REQUESTS the half
    # form (the global conjunct features were already blocked by the joiner
    # glyph sitting in their input sequence); halant+ZWNJ blocks the half
    # form too — the consonant renders full with a visible halant.
    k = start
    while k < base:
        if cats[k] in (C_CONSONANT, C_VOWEL):
            j = k + 1
            if j < n and cats[j] == C_NUKTA:
                j += 1
            if j < base and cats[j] == C_HALANT:
                if not (j + 1 < n and cps[j + 1] == ZWNJ):
                    for q in range(k, j + 1):
                        masks[q].add("half")
                k = j + 1
                continue
        k += 1
    # blwf: halant + Ra (rakar), pre or post base, excluding the reph pair
    for k in range(start, n - 1):
        if cats[k] == C_HALANT and cps[k + 1] == RA and k + 1 != base:
            masks[k].add("blwf")
            masks[k + 1].add("blwf")
    return [frozenset(m) if m else frozenset() for m in masks]
