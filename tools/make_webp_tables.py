"""Write the constant tables of figdraw_tpu_torch's WebP decoder,
`figdraw_tpu_torch/utils/webp_tables.py` (numpy) and
`figdraw_tpu_torch/csrc/webp_tables.h` (C++), from the libwebp binary that
PIL links (`PIL/../pillow.libs/libwebp-*.so*`, libwebp 1.6.0 with Pillow
12.1.0).

Each table is found in the binary by an anchor, a run of bytes that opens
it or lies at a known offset in it (the first rows of RFC 6386's tables,
the code-length order of the WebP lossless format), and read whole from
there: uint8 tables as stored, the AC quantiser table as little-endian
uint16, the B_PRED mode tree as int8. tests/test_torch_webp.py finds each
written table whole in the same binary again.

    python tools/make_webp_tables.py
"""

from __future__ import annotations

import glob
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY_OUT = os.path.join(REPO, "figdraw_tpu_torch", "utils", "webp_tables.py")
H_OUT = os.path.join(REPO, "figdraw_tpu_torch", "csrc", "webp_tables.h")

# name -> (dtype, shape, anchor values, the anchor's element offset in the
# table, what it is)
TABLES = {
    "COEFFS_PROBA0": ("uint8", (4, 8, 3, 11),
                      (253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128), 33,
                      "default token probabilities [type][band][ctx][node] (RFC 6386 13.5)"),
    "COEFFS_UPDATE_PROBA": ("uint8", (4, 8, 3, 11),
                            (176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255), 33,
                            "token probability update probabilities (RFC 6386 13.4)"),
    "BMODES_PROBA": ("uint8", (10, 10, 9), (231, 120, 48, 89, 115, 113, 120, 152, 112), 0,
                     "key-frame B_PRED sub-block mode probabilities [above][left]"),
    "DC_TABLE": ("uint8", (128,), (4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17),
                 0, "DC dequantisation factor by quantiser index (RFC 6386 14.1)"),
    "AC_TABLE": ("uint16", (128,), tuple(range(4, 20)), 0,
                 "AC dequantisation factor by quantiser index (RFC 6386 14.1)"),
    "ZIGZAG": ("uint8", (16,), (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15), 0,
               "token position -> raster index in a 4x4 block"),
    "BANDS": ("uint8", (17,), (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0), 0,
              "token position -> probability band (one past the end for the lookahead)"),
    "CAT3": ("uint8", (4,), (173, 148, 140, 0), 0, "DCT_CAT3 extra-bit probabilities, 0-ended"),
    "CAT4": ("uint8", (5,), (176, 155, 140, 135, 0), 0, "DCT_CAT4 extra-bit probabilities"),
    "CAT5": ("uint8", (6,), (180, 157, 141, 134, 130, 0), 0, "DCT_CAT5 extra-bit probabilities"),
    "CAT6": ("uint8", (12,), (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0), 0,
             "DCT_CAT6 extra-bit probabilities"),
    "YMODES_INTRA4": ("int8", (18,), (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8,
                                      -8, -9), 0,
                      "B_PRED mode tree: i = T[2i + bit] until i <= 0, mode -i"),
    "CODE_LENGTH_ORDER": ("uint8", (19,), (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11,
                                           12, 13, 14, 15), 0,
                          "VP8L code-length code order"),
    "CODE_TO_PLANE": ("uint8", (120,), (0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29), 0,
                      "VP8L distance codes 1-120: (dy << 4) | (8 - dx)"),
}


def libwebp_path() -> str:
    """The libwebp shared object PIL links, or "" when there is none."""
    try:
        import PIL
    except ImportError:
        return ""
    found = sorted(glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                                          "pillow.libs", "libwebp-*.so*")))
    return found[0] if found else ""


def table_bytes(values: np.ndarray) -> bytes:
    """A table as the binary stores it (little-endian)."""
    return np.ascontiguousarray(values).astype(values.dtype.newbyteorder("<")).tobytes()


def read_tables(binary: bytes) -> dict:
    """name -> numpy array read from the binary at its anchor."""
    out = {}
    for name, (dtype, shape, anchor, offset, _what) in TABLES.items():
        dt = np.dtype(dtype).newbyteorder("<")
        at = binary.find(np.array(anchor, dt).tobytes())
        if at < 0:
            raise SystemExit(f"{name}: anchor not found in the libwebp binary")
        start = at - offset * dt.itemsize
        n = int(np.prod(shape))
        out[name] = np.frombuffer(binary, dt, n, start).astype(dtype).reshape(shape)
    return out


def _rows(values: np.ndarray, indent: str) -> str:
    flat = [str(int(v)) for v in values.reshape(-1)]
    width = values.shape[-1] if values.ndim > 1 else 16
    lines = [", ".join(flat[i: i + width]) for i in range(0, len(flat), width)]
    return (",\n" + indent).join(lines)


def write(tables: dict) -> None:
    py = ['"""The constant tables of the WebP decoder (utils/webp.py, csrc/webp_decode.cpp),',
          "read from libwebp 1.6.0's binary by tools/make_webp_tables.py; the same",
          'tables are in csrc/webp_tables.h. Written by the tool: do not edit."""', "",
          "import numpy as np", ""]
    h = ["// The constant tables of the WebP decoder (csrc/webp_decode.cpp), read from",
         "// libwebp 1.6.0's binary by tools/make_webp_tables.py; the same tables are in",
         "// utils/webp_tables.py. Written by the tool: do not edit.", "",
         "#pragma once", "", "#include <cstdint>", ""]
    ctype = {"uint8": "uint8_t", "uint16": "uint16_t", "int8": "int8_t"}
    for name, (dtype, shape, _a, _o, what) in TABLES.items():
        values = tables[name]
        py.append(f"# {what}")
        py.append(f"{name} = np.array([\n    {_rows(values, '    ')}], np.{dtype})"
                  + (f".reshape({shape})" if len(shape) > 1 else ""))
        py.append("")
        dims = "".join(f"[{d}]" for d in shape)
        h.append(f"// {what}")
        h.append(f"static const {ctype[dtype]} k{name}{dims} = {{\n    "
                 f"{_rows(values, '    ')}}};")
        h.append("")
    with open(PY_OUT, "w") as fh:
        fh.write("\n".join(py))
    with open(H_OUT, "w") as fh:
        fh.write("\n".join(h))


def main() -> None:
    path = libwebp_path()
    if not path:
        raise SystemExit("no libwebp beside PIL")
    with open(path, "rb") as fh:
        write(read_tables(fh.read()))
    print(f"wrote {PY_OUT} and {H_OUT} from {os.path.basename(path)}")


if __name__ == "__main__":
    main()
