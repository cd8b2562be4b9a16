"""Write figdraw_tpu_torch/csrc/fax_tables.h, the CCITT code tables of the
C++ fax decoder (csrc/image_decode.cpp: fd_tiff_fax), from T.4's tables as
figdraw_tpu_torch/utils/fax.py holds them (`fax.codes()`): the white, black
and two-dimensional codes as (state, length, code, param), in the order
libtiff's mkg3states.c fills its lookup tables, from which the decoder
builds the same 12-, 13- and 7-bit tables as the Python twin.

    python tools/make_fax_tables.py [--check]

--check exits 1 if the header differs from what this would write.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(REPO, "figdraw_tpu_torch", "csrc", "fax_tables.h")


def header() -> str:
    sys.path.insert(0, REPO)
    from figdraw_tpu_torch.utils import fax

    lines = [
        "// Generated by tools/make_fax_tables.py from figdraw_tpu_torch/utils/fax.py",
        "// (ITU-T T.4 tables 2, 3 and 4, and the two-dimensional codes). Do not edit.",
        "// Each entry: {state, code length, code (MSB first), run or offset}, in the",
        "// order libtiff's mkg3states.c fills its tables (a later entry wins).",
        "#pragma once",
        "#include <cstdint>",
        "",
        "struct FaxCode { uint8_t state, length; uint16_t code, param; };",
        "",
    ]
    for name, entries in fax.codes().items():
        lines.append(f"static const FaxCode kFax{name.capitalize()}[{len(entries)}] = {{")
        row = []
        for state, code, param in entries:
            row.append(f"{{{state}, {len(code)}, 0x{int(code, 2):04x}, {param}}}")
            if len(row) == 4:
                lines.append("    " + ", ".join(row) + ",")
                row = []
        if row:
            lines.append("    " + ", ".join(row) + ",")
        lines.append("};")
        lines.append("")
    return "\n".join(lines)


def main() -> None:
    text = header()
    if "--check" in sys.argv:
        with open(HEADER) as fh:
            sys.exit(0 if fh.read() == text else 1)
    with open(HEADER, "w") as fh:
        fh.write(text)
    print(f"wrote {HEADER}")


if __name__ == "__main__":
    main()
