"""Khmer & Myanmar (USE-class) syllable analysis for the OpenType shaper
(figdraw_tpu/text/use.py, copied).

What the generic OTL applier cannot do: syllable segmentation, the positional feature masks
(pref/blwf/pstf/abvf/cfar for Khmer; rphf/pref/blwf/pstf for Myanmar), and
the reordering rules — pre-base vowels and pre-base-reordering consonants
(Khmer coeng+Ro, Myanmar medial Ra) move to the syllable front, Myanmar
kinzi moves from logical start to after the base consonant cluster.
shaper.OpenTypeShaper._substitute_use drives these per syllable.

Simplifications vs HarfBuzz's USE machine (documented gaps):
 - Khmer split vowels with a left-side piece (U+17BE, U+17C0, U+17C4,
   U+17C5) ride as post-base signs; fonts that decompose them in ccmp get
   the left piece reordered only if it maps to U+17C1's glyph. The plain
   pre-base vowels U+17C1..U+17C3 reorder fully.
 - Myanmar kinzi detection covers the Burmese NGA (U+1004) + asat + virama
   prefix (the mainstream case; Mon/Shan kinzi bases are not segmented).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

ZWNJ, ZWJ = 0x200C, 0x200D

# ---------------------------------------------------------------- Khmer ----

KH_COENG = 0x17D2
KH_RO = 0x179A
KH_ROBAT = 0x17CC

_KH_CONSONANTS = frozenset(range(0x1780, 0x17A3))
_KH_INDEP_VOWELS = frozenset(range(0x17A3, 0x17B4))
_KH_DEP_VOWELS = frozenset(range(0x17B6, 0x17C6))
_KH_VPRE = frozenset([0x17C1, 0x17C2, 0x17C3])  # E, AE, AI — render left of base
_KH_SHIFTERS = frozenset([0x17C9, 0x17CA])  # muusikatoan, triisap
_KH_SIGNS = frozenset(
    [0x17C6, 0x17C7, 0x17C8]  # nikahit, reahmuk, yuukaleapintu
    + list(range(0x17CB, 0x17D2))  # bantoc..viriam (17CC robat rides here too)
    + [0x17DD]  # atthacan
)


def is_khmer(cp: int) -> bool:
    return 0x1780 <= cp <= 0x17FF


def _kh_base_char(cp: int) -> bool:
    return cp in _KH_CONSONANTS or cp in _KH_INDEP_VOWELS


def khmer_next_syllable(cps: Sequence[int], start: int) -> int:
    """End index (exclusive) of the Khmer syllable at `start`.

    syllable := (C|IV) (shifter | robat | coeng (C|IV) | ZWJ/ZWNJ)*
                (vowel)* (sign | shifter | coeng (C|IV))*
    Segmentation is permissive about ordering (matching HarfBuzz's machine,
    which accepts signs/shifters interleaved); a final coeng+C after vowels
    (the cfar case) stays in the syllable. Non-base starters consume a run of
    signs/vowels (broken cluster) or one char.
    """
    n = len(cps)
    i = start
    if not _kh_base_char(cps[i]):
        if cps[i] in _KH_DEP_VOWELS or cps[i] in _KH_SIGNS or \
                cps[i] in _KH_SHIFTERS or cps[i] == KH_COENG:
            i += 1
            while i < n and (cps[i] in _KH_DEP_VOWELS or cps[i] in _KH_SIGNS
                             or cps[i] in _KH_SHIFTERS):
                i += 1
            return i
        return i + 1
    i += 1
    while i < n:
        cp = cps[i]
        if cp == KH_COENG and i + 1 < n and _kh_base_char(cps[i + 1]):
            i += 2
        elif cp in _KH_DEP_VOWELS or cp in _KH_SIGNS or cp in _KH_SHIFTERS \
                or cp in (ZWJ, ZWNJ):
            i += 1
        else:
            break
    return i


def khmer_masks(cps: Sequence[int]) -> List[frozenset]:
    """Per-character positional feature tags for one Khmer syllable.

    coeng+Ro → pref (pre-base-reordering Ra); other coeng+C → blwf
    (below-base subscript); any coeng pair AFTER a pref pair additionally
    carries cfar ("coeng after Ro" — fonts shift those right); robat → abvf.
    pstf rides the blwf pairs too (post-base coeng Yo/Vo forms — fonts pick
    one of the two features per glyph, tags on the pair are harmless).
    """
    n = len(cps)
    masks: List[set] = [set() for _ in range(n)]
    seen_pref = False
    for k in range(n - 1):
        if cps[k] == KH_COENG and _kh_base_char(cps[k + 1]):
            if cps[k + 1] == KH_RO:
                masks[k].add("pref")
                masks[k + 1].add("pref")
                seen_pref = True
            else:
                for q in (k, k + 1):
                    masks[q].add("blwf")
                    masks[q].add("pstf")
                    if seen_pref:
                        masks[q].add("cfar")
    for k in range(n):
        if cps[k] == KH_ROBAT:
            masks[k].add("abvf")
    return [frozenset(m) for m in masks]


def khmer_reorder_ranges(
    clusters: Sequence[Tuple[int, int]], cps: Sequence[int]
) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """(vpre_ranges, pref_ranges): source-cluster ranges whose glyphs move to
    the syllable front — VPre vowels leftmost, then the coeng+Ro pair(s),
    then the base (HarfBuzz khmer reorder: both move to start; the vowel,
    being later in logical order, lands first). Ranges are in the original
    clusters' coordinate space, so they survive GSUB merging."""
    vpre: List[Tuple[int, int]] = []
    pref: List[Tuple[int, int]] = []
    for k, cp in enumerate(cps):
        if cp in _KH_VPRE:
            vpre.append(clusters[k])
        elif cp == KH_COENG and k + 1 < len(cps) and cps[k + 1] == KH_RO:
            pref.append((clusters[k][0], clusters[k + 1][1]))
    return vpre, pref


# -------------------------------------------------------------- Myanmar ----

MY_NGA = 0x1004
MY_ASAT = 0x103A
MY_VIRAMA = 0x1039  # invisible stacker
MY_MED_YA, MY_MED_RA, MY_MED_WA, MY_MED_HA = 0x103B, 0x103C, 0x103D, 0x103E
MY_VPRE = 0x1031  # vowel sign E — renders left of the base

_MY_CONSONANTS = frozenset(list(range(0x1000, 0x1021)) + [0x103F])
_MY_INDEP_VOWELS = frozenset(range(0x1021, 0x102B))
_MY_MEDIALS = frozenset([MY_MED_YA, MY_MED_RA, MY_MED_WA, MY_MED_HA])
_MY_DEP_VOWELS = frozenset(
    [0x102B, 0x102C, 0x102D, 0x102E, 0x102F, 0x1030, 0x1031, 0x1032, 0x1033,
     0x1034, 0x1035]
)
_MY_SIGNS = frozenset([0x1036, 0x1037, 0x1038])  # anusvara, dot below, visarga


def is_myanmar(cp: int) -> bool:
    return 0x1000 <= cp <= 0x109F


def _my_base_char(cp: int) -> bool:
    return cp in _MY_CONSONANTS or cp in _MY_INDEP_VOWELS


def myanmar_has_kinzi(cps: Sequence[int], i: int) -> bool:
    """NGA + asat + virama at i, followed by a base consonant (the kinzi
    prefix is encoded BEFORE the consonant it renders above)."""
    return (
        i + 3 < len(cps) and cps[i] == MY_NGA and cps[i + 1] == MY_ASAT
        and cps[i + 2] == MY_VIRAMA and _my_base_char(cps[i + 3])
    )


def myanmar_next_syllable(cps: Sequence[int], start: int) -> int:
    """End index (exclusive) of the Myanmar syllable at `start`.

    syllable := kinzi? (C|IV) (asat | virama C | medial | vowel | sign |
                ZWJ/ZWNJ)*
    """
    n = len(cps)
    i = start
    if myanmar_has_kinzi(cps, i):
        i += 3
    if i >= n or not _my_base_char(cps[i]):
        if i != start:
            return i  # kinzi with nothing to attach to: stop after it
        if cps[i] in _MY_DEP_VOWELS or cps[i] in _MY_SIGNS or \
                cps[i] in _MY_MEDIALS or cps[i] == MY_ASAT:
            i += 1
            while i < n and (cps[i] in _MY_DEP_VOWELS or cps[i] in _MY_SIGNS):
                i += 1
            return i
        return i + 1
    i += 1
    while i < n:
        cp = cps[i]
        if cp == MY_VIRAMA and i + 1 < n and _my_base_char(cps[i + 1]):
            i += 2
        elif cp in _MY_MEDIALS or cp in _MY_DEP_VOWELS or cp in _MY_SIGNS \
                or cp == MY_ASAT or cp in (ZWJ, ZWNJ):
            i += 1
        else:
            break
    return i


def myanmar_masks(cps: Sequence[int], has_kinzi: bool) -> List[frozenset]:
    """Positional tags: rphf on the kinzi triple, pref on medial Ra, blwf on
    medial Wa/Ha and virama+C stack pairs, pstf on medial Ya (OpenType
    Myanmar spec feature assignment)."""
    n = len(cps)
    masks: List[set] = [set() for _ in range(n)]
    if has_kinzi:
        for q in range(3):
            masks[q].add("rphf")
    start = 3 if has_kinzi else 0
    for k in range(start, n):
        cp = cps[k]
        if cp == MY_MED_RA:
            masks[k].add("pref")
        elif cp in (MY_MED_WA, MY_MED_HA):
            masks[k].add("blwf")
        elif cp == MY_MED_YA:
            masks[k].add("pstf")
        elif cp == MY_VIRAMA and k + 1 < n and _my_base_char(cps[k + 1]):
            masks[k].add("blwf")
            masks[k + 1].add("blwf")
    return [frozenset(m) for m in masks]


def myanmar_reorder_ranges(
    clusters: Sequence[Tuple[int, int]], cps: Sequence[int], has_kinzi: bool
) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]], Tuple[int, int]]:
    """(vpre_ranges, medra_ranges, kinzi_range): source ranges for the three
    reorders — vowel E and medial Ra to the front (E leftmost), kinzi from
    logical start to after the base consonant cluster. kinzi_range is None
    when has_kinzi is False."""
    vpre: List[Tuple[int, int]] = []
    medra: List[Tuple[int, int]] = []
    for k, cp in enumerate(cps):
        if cp == MY_VPRE:
            vpre.append(clusters[k])
        elif cp == MY_MED_RA:
            medra.append(clusters[k])
    kinzi = (clusters[0][0], clusters[2][1]) if has_kinzi else None
    return vpre, medra, kinzi


def myanmar_base_cluster_end(cps: Sequence[int], has_kinzi: bool) -> int:
    """Index (in the syllable's codepoints) one past the base consonant
    cluster — base + virama+C stacks + non-reordered medials + asat. The
    kinzi lands at this boundary after reordering (OT Myanmar spec: kinzi
    renders above the base, encoded after it and its below-base material)."""
    n = len(cps)
    i = 3 if has_kinzi else 0
    if i < n and _my_base_char(cps[i]):
        i += 1
    while i < n:
        cp = cps[i]
        if cp == MY_VIRAMA and i + 1 < n and _my_base_char(cps[i + 1]):
            i += 2
        elif cp in (MY_MED_YA, MY_MED_WA, MY_MED_HA) or cp == MY_ASAT:
            i += 1
        else:
            break
    return i
