"""How often the port's WOFF 2.0 reader (text/woff2.py with utils/brotli.py,
through text/otf.py) and fontTools 4.61.1's WOFF2Reader (the brotli module
being tools/brotli_shim.py, libbrotlidec through ctypes) agree on corrupt
fonts: seeded truncations and one to three bit flips of the committed WOFF2
faces (figdraw_tpu_torch/fonts/*.woff2), each read whole on both sides:
the glyph order, the best cmap, every glyph's advance and its outline as
fontTools' DecomposingRecordingPen records it at the default location.
A third of the flips land in the first 160 bytes (the header and the table
directory), the rest anywhere. A second pass does the same to the sfnt
twins of those faces (FigPortSans-VF.ttf, FigPortSans-CFF.otf and
DejaVuSans.ttf, read by text/otf.py and fontTools' TTFont), a third of
their flips in the table directory. Agreement is the same values, or a
failure on both sides; the counts of each kind are printed by face, with
each disagreement by its pass, seed and index (`case(seed, index)` and
`sfnt_case(seed, index)` rebuild it). A refusal of the port other than
ValueError or NotImplementedError is counted under its own name.
Needs fontTools and PIL (the CPU host's).

    python tools/woff2_fuzz_agreement.py [cases per seed, default 400] [seeds, default 3]
"""

from __future__ import annotations

import collections
import io
import logging
import os
import sys
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACES = ("FigPortSans-VF.woff2", "FigPortSans-CFF.woff2", "DejaVuSans.woff2")
SFNT_FACES = ("FigPortSans-VF.ttf", "FigPortSans-CFF.otf", "DejaVuSans.ttf")
# DejaVu Sans has 6253 glyphs: one case in this many is taken from it
DEJAVU_EVERY = 8


def stored_faces(names: tuple = FACES) -> dict:
    """{name: bytes} of the committed faces `names` (the WOFF2 faces by
    default)."""
    sys.path.insert(0, REPO)
    from figdraw_tpu_torch.text.typefaces import bundled_font_path

    out = {}
    for name in names:
        with open(bundled_font_path(name), "rb") as fh:
            out[name] = fh.read()
    return out


def _head(name: str, data: bytes) -> int:
    """The bytes a third of the flips land in: a WOFF2 file's first 160, an
    sfnt's table directory."""
    if name.endswith(".woff2"):
        return 160
    return 12 + 16 * int.from_bytes(data[4:6], "big")


def corrupt_cases(faces: dict, seed: int, cases: int, names: tuple = FACES):
    """Yields (index, face, corrupt bytes) of one seed's cases of the faces
    `names` (names[2], DejaVu Sans, one case in DEJAVU_EVERY)."""
    rng = np.random.default_rng(seed)
    for i in range(cases):
        name = names[2] if i % DEJAVU_EVERY == DEJAVU_EVERY - 1 else names[i % 2]
        data = bytearray(faces[name])
        if rng.integers(3) == 0:
            data = data[: rng.integers(0, len(data))]
        else:
            head = rng.integers(3) == 0
            for _ in range(rng.integers(1, 4)):
                at = rng.integers(0, _head(name, data)) if head else rng.integers(0, len(data))
                data[at] ^= 1 << rng.integers(8)
        yield i, name, bytes(data)


def case(seed: int, index: int) -> tuple:
    """(face, corrupt bytes) of case `index` of `seed` of the WOFF2 pass."""
    for i, name, data in corrupt_cases(stored_faces(), seed, index + 1):
        if i == index:
            return name, data
    raise IndexError(index)


def sfnt_case(seed: int, index: int) -> tuple:
    """(face, corrupt bytes) of case `index` of `seed` of the sfnt pass."""
    faces = stored_faces(SFNT_FACES)
    for i, name, data in corrupt_cases(faces, seed, index + 1, SFNT_FACES):
        if i == index:
            return name, data
    raise IndexError(index)


def _number(v) -> float:
    return float(v) + 0.0


def _values(order, cmap, advances, paths) -> tuple:
    """Comparable values, numbers as floats (fontTools' ints and the port's
    alike)."""
    return (list(order), dict(cmap or {}), [_number(a) for a in advances],
            [[(op, [None if p is None else (_number(p[0]), _number(p[1])) for p in pts])
              for op, pts in path] for path in paths])


def port_result(data: bytes) -> tuple:
    """(the port's values of a face, None) or (None, the exception's type)."""
    sys.path.insert(0, REPO)
    from figdraw_tpu_torch.text.otf import OTFont

    try:
        font = OTFont(data)
        n = len(font.glyph_order)
        return _values(font.glyph_order, font.getBestCmap(),
                       [font.advance(g) for g in range(n)],
                       [font.glyph_path(g) for g in range(n)]), None
    except Exception as err:  # noqa: BLE001 - counted by its type
        return None, type(err).__name__


def fonttools_result(data: bytes):
    """fontTools' values of a face (TTFont, lazy as figdraw_tpu opens it),
    or None where it fails."""
    from fontTools.pens.recordingPen import DecomposingRecordingPen
    from fontTools.ttLib import TTFont

    import brotli_shim

    try:
        with brotli_shim.installed(), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tt = TTFont(io.BytesIO(data), lazy=True)
            tt["head"], tt["hhea"]  # noqa: B018 - figdraw_tpu's Typeface reads both at load
            order = tt.getGlyphOrder()
            gs = tt.getGlyphSet()
            paths = []
            for name in order:
                pen = DecomposingRecordingPen(gs)
                gs[name].draw(pen)
                paths.append(pen.value)
            return _values(order, tt.getBestCmap(), [tt["hmtx"][g][0] for g in order], paths)
    except Exception:  # noqa: BLE001 - any fontTools failure counts as an error
        return None


def classify(data: bytes) -> str:
    """The kind of a case; a failure of the port other than ValueError is
    named with its type."""
    (got, err), want = port_result(data), fonttools_result(data)
    kind = None
    if got is None and want is None:
        kind = "both_raise"
    elif got is None:
        kind = "port_only_raises"
    if kind and err not in ("ValueError", "NotImplementedError"):
        kind += f" ({err})"
    if kind:
        return kind
    if want is None:
        return "fonttools_only_raises"
    return "equal" if got == want else "differ"


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    logging.disable(logging.CRITICAL)  # fontTools logs what it then raises on
    cases = int(sys.argv[1]) if len(sys.argv) > 1 else 400
    seeds = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    for label, names in (("woff2", FACES), ("sfnt", SFNT_FACES)):
        faces = stored_faces(names)
        counts = collections.defaultdict(collections.Counter)
        for seed in range(seeds):
            for i, name, data in corrupt_cases(faces, seed, cases, names):
                kind = classify(data)
                counts[name][kind] += 1
                if kind not in ("equal", "both_raise"):
                    print(f"{label} seed {seed} case {i} ({name}, {len(data)} bytes): {kind}",
                          flush=True)
        total = agree = 0
        for name in names:
            c = counts[name]
            n = sum(c.values())
            ok = sum(v for k, v in c.items() if k in ("equal", "both_raise"))
            total, agree = total + n, agree + ok
            print(f"{name}: {n} corrupt cases: {dict(c)}; agreeing {ok} "
                  f"({100.0 * ok / max(n, 1):.2f}%)")
        print(f"{label}: {len(names)} faces, {total} cases in all; agreeing {agree} "
              f"({100.0 * agree / max(total, 1):.2f}%)", flush=True)


if __name__ == "__main__":
    main()
