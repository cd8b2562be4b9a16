"""Unicode bidirectional algorithm (UAX #9) for mixed-direction text
(figdraw_tpu/text/bidi.py, copied).

A self-contained implementation over `unicodedata.bidirectional`:

- P2/P3 paragraph level; X1-X8 explicit embeddings/overrides plus the
  X5a-X6a isolate initiators (levels honored; weak/neutral resolution then
  runs per level run with sos/eos, the UBA 6.2 run model)
- W1-W7 weak types, N1-N2 neutrals, I1-I2 implicit levels
- L1 trailing-whitespace reset and L2 run reversal for visual order
- L4 mirrored-glyph pairs for RTL brackets

Outputs are per-character embedding levels and per-line visual orders, which
text/layout.py applies at positioning time (glyph storage stays in logical
order so the selection/caret APIs keep logical indexing).
"""

from __future__ import annotations

import unicodedata
from typing import List, Optional, Sequence, Tuple

MAX_DEPTH = 125

_ISOLATE_INIT = ("LRI", "RLI", "FSI")
_EXPLICIT = ("LRE", "RLE", "LRO", "RLO", "PDF")
_NI = ("B", "S", "WS", "ON", "FSI", "LRI", "RLI", "PDI")  # neutrals/isolates

# BidiBrackets / common mirrored pairs (L4)
MIRROR_PAIRS = {
    "(": ")", ")": "(", "[": "]", "]": "[", "{": "}", "}": "{",
    "<": ">", ">": "<", "«": "»", "»": "«", "‹": "›", "›": "‹",
    "⟨": "⟩", "⟩": "⟨", "⌈": "⌉", "⌉": "⌈", "⌊": "⌋", "⌋": "⌊",
    "≤": "≥", "≥": "≤",
}


def char_type(ch: str) -> str:
    return unicodedata.bidirectional(ch) or "L"


def paragraph_level(types: Sequence[str]) -> int:
    """P2/P3: first strong type outside isolates decides the base level."""
    isolate = 0
    for t in types:
        if t in _ISOLATE_INIT:
            isolate += 1
        elif t == "PDI":
            if isolate > 0:
                isolate -= 1
        elif isolate == 0:
            if t == "L":
                return 0
            if t in ("R", "AL"):
                return 1
    return 0


def _matching_pdi(types: Sequence[str], i: int) -> int:
    """BD9: index of the PDI matching the isolate initiator at i (len if none)."""
    depth = 1
    for j in range(i + 1, len(types)):
        t = types[j]
        if t in _ISOLATE_INIT:
            depth += 1
        elif t == "PDI":
            depth -= 1
            if depth == 0:
                return j
    return len(types)


def resolve_levels(text: str, base_level: Optional[int] = None) -> Tuple[List[int], int]:
    """Per-character embedding levels for one paragraph (no B inside).

    Returns (levels, paragraph_level). Explicit formatting characters get the
    current level and are excluded from weak/neutral resolution (X9)."""
    n = len(text)
    types = [char_type(ch) for ch in text]
    para = paragraph_level(types) if base_level is None else base_level

    # --- X1-X8 + X5a-X6a: explicit levels ------------------------------------
    levels = [para] * n
    orig_types = list(types)
    stack = [(para, "", False)]  # (level, override 'L'/'R'/'', isolate)
    overflow_isolates = 0
    overflow_embedding = 0
    valid_isolates = 0

    def next_odd(level):
        return level + 1 if level % 2 == 0 else level + 2

    def next_even(level):
        return level + 2 if level % 2 == 0 else level + 1

    i = 0
    while i < n:
        t = types[i]
        if t in _EXPLICIT and t != "PDF":
            # RLE/LRE/RLO/LRO
            new_level = next_odd(stack[-1][0]) if t in ("RLE", "RLO") else next_even(stack[-1][0])
            levels[i] = stack[-1][0]
            types[i] = "BN"
            if new_level <= MAX_DEPTH and not overflow_isolates and not overflow_embedding:
                stack.append((new_level, "R" if t == "RLO" else ("L" if t == "LRO" else ""), False))
            else:
                if not overflow_isolates:
                    overflow_embedding += 1
        elif t == "PDF":
            levels[i] = stack[-1][0]
            types[i] = "BN"
            if overflow_isolates:
                pass
            elif overflow_embedding:
                overflow_embedding -= 1
            elif not stack[-1][2] and len(stack) > 1:
                stack.pop()
        elif t in _ISOLATE_INIT:
            if t == "FSI":
                # first strong inside the isolate decides LRI vs RLI
                end = _matching_pdi(types, i)
                t = "RLI" if paragraph_level(orig_types[i + 1 : end]) == 1 else "LRI"
            levels[i] = stack[-1][0]
            if stack[-1][1]:
                types[i] = stack[-1][1]
            new_level = next_odd(stack[-1][0]) if t == "RLI" else next_even(stack[-1][0])
            if new_level <= MAX_DEPTH and not overflow_isolates and not overflow_embedding:
                valid_isolates += 1
                stack.append((new_level, "", True))
            else:
                overflow_isolates += 1
        elif t == "PDI":
            if overflow_isolates:
                overflow_isolates -= 1
            elif valid_isolates:
                overflow_embedding = 0
                while not stack[-1][2]:
                    stack.pop()
                stack.pop()
                valid_isolates -= 1
            levels[i] = stack[-1][0]
            if stack[-1][1]:
                types[i] = stack[-1][1]
        elif t == "B":
            levels[i] = para
        else:
            levels[i] = stack[-1][0]
            if stack[-1][1]:
                types[i] = stack[-1][1]
        i += 1

    # --- level runs with sos/eos ------------------------------------------------
    # X10 (6.2 run model): process each maximal run of equal level; sos/eos
    # from max(adjacent levels) vs paragraph level at the edges.
    runs: List[Tuple[int, int]] = []  # [start, end)
    s = 0
    visible = [j for j in range(n) if types[j] != "BN"]
    if visible:
        vs = visible[0]
        for a, b in zip(visible, visible[1:]):
            if levels[b] != levels[a]:
                runs.append((vs, a + 1))
                vs = b
        runs.append((vs, visible[-1] + 1))

    for ri, (rs, re) in enumerate(runs):
        run_level = levels[rs]
        prev_level = levels[runs[ri - 1][0]] if ri > 0 else para
        next_level = levels[runs[ri + 1][0]] if ri + 1 < len(runs) else para
        sos = "R" if max(run_level, prev_level) % 2 else "L"
        eos = "R" if max(run_level, next_level) % 2 else "L"
        idxs = [j for j in range(rs, re) if types[j] != "BN"]

        # W1: NSM takes the type of the previous character (sos at start);
        # isolate initiators / PDI before an NSM give ON
        prev_t = sos
        for j in idxs:
            if types[j] == "NSM":
                types[j] = "ON" if prev_t in _ISOLATE_INIT + ("PDI",) else prev_t
            prev_t = types[j]
        # W2: EN → AN when the last strong type is AL
        strong = sos
        for j in idxs:
            t = types[j]
            if t in ("L", "R", "AL"):
                strong = t
            elif t == "EN" and strong == "AL":
                types[j] = "AN"
        # W3: AL → R
        for j in idxs:
            if types[j] == "AL":
                types[j] = "R"
        # W4: single ES between EN/EN → EN; single CS between matching numbers
        for k, j in enumerate(idxs):
            if k == 0 or k == len(idxs) - 1:
                continue
            a, b = types[idxs[k - 1]], types[idxs[k + 1]]
            if types[j] == "ES" and a == "EN" and b == "EN":
                types[j] = "EN"
            elif types[j] == "CS" and a == b and a in ("EN", "AN"):
                types[j] = a
        # W5: ET runs adjacent to EN → EN
        k = 0
        while k < len(idxs):
            if types[idxs[k]] == "ET":
                k2 = k
                while k2 < len(idxs) and types[idxs[k2]] == "ET":
                    k2 += 1
                before = types[idxs[k - 1]] if k > 0 else sos
                after = types[idxs[k2]] if k2 < len(idxs) else eos
                if before == "EN" or after == "EN":
                    for m in range(k, k2):
                        types[idxs[m]] = "EN"
                k = k2
            else:
                k += 1
        # W6: remaining ET/ES/CS → ON
        for j in idxs:
            if types[j] in ("ET", "ES", "CS"):
                types[j] = "ON"
        # W7: EN → L when the last strong type is L
        strong = sos
        for j in idxs:
            t = types[j]
            if t in ("L", "R"):
                strong = t
            elif t == "EN" and strong == "L":
                types[j] = "L"

        # N1/N2: neutral runs
        def n_side(t: str) -> str:
            return "R" if t in ("R", "EN", "AN") else ("L" if t == "L" else "")

        k = 0
        while k < len(idxs):
            if types[idxs[k]] in _NI:
                k2 = k
                while k2 < len(idxs) and types[idxs[k2]] in _NI:
                    k2 += 1
                before = n_side(types[idxs[k - 1]]) if k > 0 else sos
                after = n_side(types[idxs[k2]]) if k2 < len(idxs) else eos
                if before == after and before in ("L", "R"):
                    res = before
                else:
                    res = "R" if run_level % 2 else "L"  # N2
                for m in range(k, k2):
                    types[idxs[m]] = res
                k = k2
            else:
                k += 1

        # I1/I2: implicit levels
        for j in idxs:
            t = types[j]
            if run_level % 2 == 0:
                if t == "R":
                    levels[j] = run_level + 1
                elif t in ("AN", "EN"):
                    levels[j] = run_level + 2
            else:
                if t in ("L", "AN", "EN"):
                    levels[j] = run_level + 1

    # X9 cleanup: explicit formatting chars take the level of what follows
    # (they are zero-width; keeps reordering stable)
    for j in range(n - 2, -1, -1):
        if types[j] == "BN":
            levels[j] = levels[j + 1] if j + 1 < n else para
    return levels, para


def paragraph_ranges(text: str) -> List[Tuple[int, int]]:
    """Split on paragraph separators (class B, e.g. '\\n'); the separator
    belongs to the paragraph it ends."""
    out = []
    start = 0
    for i, ch in enumerate(text):
        if char_type(ch) == "B":
            out.append((start, i + 1))
            start = i + 1
    if start < len(text) or not out:
        out.append((start, len(text)))
    return out


def compute_levels(text: str) -> Tuple[List[int], List[int]]:
    """Levels for a whole (multi-paragraph) text; returns (levels,
    per-char paragraph base levels)."""
    levels: List[int] = []
    bases: List[int] = []
    for s, e in paragraph_ranges(text):
        ls, para = resolve_levels(text[s:e])
        levels.extend(ls)
        bases.extend([para] * (e - s))
    return levels, bases


def line_visual_order(levels: Sequence[int], types: Sequence[str],
                      para_level: int) -> List[int]:
    """L1 + L2 for one line (inputs are the line's slices, logical order).
    Returns logical indices in visual order."""
    n = len(levels)
    lv = list(levels)
    # L1: S/B to paragraph level; trailing whitespace/isolates too
    for i in range(n):
        if types[i] in ("S", "B"):
            lv[i] = para_level
            j = i - 1
            while j >= 0 and types[j] in ("WS", "FSI", "LRI", "RLI", "PDI", "BN"):
                lv[j] = para_level
                j -= 1
    j = n - 1
    while j >= 0 and types[j] in ("WS", "FSI", "LRI", "RLI", "PDI", "BN"):
        lv[j] = para_level
        j -= 1

    # L2: reverse runs from the highest level down to the lowest odd level
    order = list(range(n))
    if not lv:
        return order
    max_level = max(lv)
    min_odd = min((l for l in lv if l % 2), default=max_level + 1)
    for level in range(max_level, min_odd - 1, -1):
        i = 0
        while i < n:
            if lv[i] >= level:
                j = i
                while j < n and lv[j] >= level:
                    j += 1
                order[i:j] = order[i:j][::-1]
                i = j
            else:
                i += 1
    return order


def mirror_char(ch: str) -> str:
    """L4: the mirrored counterpart for RTL-context paired characters."""
    if unicodedata.mirrored(ch):
        return MIRROR_PAIRS.get(ch, ch)
    return ch
