"""Write the Adobe Glyph List table of figdraw_tpu_torch's OpenType reader
from fontTools 4.61.1's `fontTools.agl.UV2AGL` (the names fontTools gives a
glyph it names from its cmap, `TTFont._makeGlyphName`, and a post format 4
table's codes, `table__p_o_s_t.decode_format_4_0`):

- `figdraw_tpu_torch/text/agl_data.py`: `UV2AGL`, {code point: name}.

    python tools/make_agl_table.py [--check]

--check exits 1 if the written file differs from what this would write.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY_OUT = os.path.join(REPO, "figdraw_tpu_torch", "text", "agl_data.py")


def python_source() -> str:
    import fontTools
    from fontTools import agl

    lines = [
        f'"""Generated by tools/make_agl_table.py from fontTools {fontTools.version}\'s',
        "fontTools.agl.UV2AGL. Do not edit.",
        "",
        "UV2AGL: {code point: Adobe Glyph List name}, the name fontTools gives a",
        'glyph named from its cmap or by a post format 4 code."""',
        "",
        "UV2AGL = {",
    ]
    for uv, name in agl.UV2AGL.items():
        lines.append(f"    0x{uv:04X}: {name!r},")
    lines.append("}")
    return "\n".join(lines) + "\n"


def outputs() -> dict:
    return {PY_OUT: python_source().encode()}


def main() -> None:
    made = outputs()
    if "--check" in sys.argv:
        stale = []
        for path, data in made.items():
            with open(path, "rb") as fh:
                if fh.read() != data:
                    stale.append(path)
        print("stale: " + ", ".join(stale) if stale else "all tables as written")
        sys.exit(1 if stale else 0)
    for path, data in made.items():
        with open(path, "wb") as fh:
            fh.write(data)
        print(f"wrote {path} ({len(data)} bytes)")


if __name__ == "__main__":
    main()
