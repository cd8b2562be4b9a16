"""Write the constant tables of figdraw_tpu_torch's Brotli decoder from the
libbrotlicommon that PIL links (`PIL/../pillow.libs/libbrotlicommon-*.so*`,
brotli 1.2.0 with Pillow 12.1.0), read through ctypes:

- `figdraw_tpu_torch/utils/brotli_dictionary.bin`: RFC 7932's static
  dictionary (Appendix A, 122,784 bytes), `BrotliGetDictionary()->data`;
- `figdraw_tpu_torch/utils/brotli_tables.py` (Python) and
  `figdraw_tpu_torch/csrc/brotli_tables.h` (C++): the dictionary's
  NDBITS and offsets by word length (`size_bits_by_length`,
  `offsets_by_length`), its sha256, the 121 word transforms of Appendix B
  (`BrotliGetTransforms()`: prefix, type, suffix) and the context lookup
  table of section 7.1 (`_kBrotliContextLookupTable`, 512 bytes a mode).

    python tools/make_brotli_tables.py [--check]

--check exits 1 if a written file differs from what this would write.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UTILS = os.path.join(REPO, "figdraw_tpu_torch", "utils")
DICT_OUT = os.path.join(UTILS, "brotli_dictionary.bin")
PY_OUT = os.path.join(UTILS, "brotli_tables.py")
H_OUT = os.path.join(REPO, "figdraw_tpu_torch", "csrc", "brotli_tables.h")

# RFC 7932 Appendix B's transform types, in brotli's numbering
TYPES = ["identity"] + [f"omit last {k}" for k in range(1, 10)] + [
    "uppercase first", "uppercase all"] + [f"omit first {k}" for k in range(1, 10)] + [
    "shift first", "shift all"]


class _Dictionary(ctypes.Structure):
    _fields_ = [("size_bits_by_length", ctypes.c_uint8 * 32),
                ("offsets_by_length", ctypes.c_uint32 * 32),
                ("data_size", ctypes.c_size_t),
                ("data", ctypes.POINTER(ctypes.c_uint8))]


class _Transforms(ctypes.Structure):
    _fields_ = [("prefix_suffix_size", ctypes.c_uint16),
                ("prefix_suffix", ctypes.POINTER(ctypes.c_uint8)),
                ("prefix_suffix_map", ctypes.POINTER(ctypes.c_uint16)),
                ("num_transforms", ctypes.c_uint32),
                ("transforms", ctypes.POINTER(ctypes.c_uint8)),
                ("params", ctypes.POINTER(ctypes.c_uint8)),
                ("cutOffTransforms", ctypes.c_int16 * 10)]


def libbrotlicommon() -> ctypes.CDLL:
    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    return ctypes.CDLL(glob.glob(os.path.join(libs, "libbrotlicommon-*.so*"))[0],
                       mode=ctypes.RTLD_GLOBAL)


def tables() -> dict:
    """The tables as read from the library."""
    lib = libbrotlicommon()
    lib.BrotliGetDictionary.restype = ctypes.POINTER(_Dictionary)
    lib.BrotliGetTransforms.restype = ctypes.POINTER(_Transforms)
    d = lib.BrotliGetDictionary().contents
    data = ctypes.string_at(d.data, d.data_size)
    t = lib.BrotliGetTransforms().contents
    ps = ctypes.string_at(t.prefix_suffix, t.prefix_suffix_size)

    def piece(i: int) -> bytes:
        at = t.prefix_suffix_map[i]
        return ps[at + 1: at + 1 + ps[at]]

    transforms = []
    for i in range(t.num_transforms):
        prefix_id, kind, suffix_id = (t.transforms[3 * i + k] for k in range(3))
        transforms.append((piece(prefix_id), kind, piece(suffix_id)))
    lut = ctypes.string_at(ctypes.addressof(
        ctypes.c_uint8.in_dll(lib, "_kBrotliContextLookupTable")), 2048)
    return {"dictionary": data,
            "size_bits": list(d.size_bits_by_length),
            "offsets": list(d.offsets_by_length),
            "transforms": transforms,
            "context_lut": lut}


def _c_bytes(b: bytes) -> str:
    return "{" + ", ".join(str(v) for v in b) + "}" if b else "{0}"


def python_source(t: dict) -> str:
    lines = [
        '"""Generated by tools/make_brotli_tables.py from libbrotlicommon 1.2.0 (the',
        "library PIL links). Do not edit.",
        "",
        "RFC 7932's static dictionary lies beside this file in brotli_dictionary.bin;",
        "NDBITS and OFFSETS give its words by length (4 to 24), TRANSFORMS its 121",
        "word transforms (prefix, type, suffix; types: 0 identity, 1-9 omit the last",
        "k bytes, 10 uppercase the first letter, 11 uppercase all, 12-20 omit the",
        "first k - 11 bytes), CONTEXT_LUT the literal context lookup of section 7.1",
        '(512 bytes a context mode: 256 for p1, then 256 for p2)."""',
        "",
        f"DICTIONARY_SIZE = {len(t['dictionary'])}",
        f"DICTIONARY_SHA256 = \"{hashlib.sha256(t['dictionary']).hexdigest()}\"",
        f"NDBITS = {t['size_bits'][:25]!r}",
        f"OFFSETS = {t['offsets'][:25]!r}",
        "TRANSFORMS = (",
    ]
    for prefix, kind, suffix in t["transforms"]:
        lines.append(f"    ({prefix!r}, {kind}, {suffix!r}),")
    lines.append(")")
    lut = t["context_lut"]
    lines.append("CONTEXT_LUT = (")
    for i in range(0, len(lut), 32):
        lines.append(f"    {lut[i: i + 32]!r}")
    lines.append(")")
    return "\n".join(lines) + "\n"


def header(t: dict) -> str:
    lines = [
        "// Generated by tools/make_brotli_tables.py from libbrotlicommon 1.2.0 (the",
        "// library PIL links); the twin of figdraw_tpu_torch/utils/brotli_tables.py.",
        "// Do not edit. The dictionary itself is utils/brotli_dictionary.bin, which",
        "// the caller passes in.",
        "#pragma once",
        "#include <cstdint>",
        "",
        f"static const int64_t kBrotliDictionarySize = {len(t['dictionary'])};",
        "// NDBITS and the dictionary offset of the words of each length 0-24",
        f"static const uint8_t kBrotliNdbits[25] = {_c_bytes(bytes(t['size_bits'][:25]))};",
        "static const uint32_t kBrotliOffsets[25] = {"
        + ", ".join(str(v) for v in t["offsets"][:25]) + "};",
        "",
        "// RFC 7932 Appendix B: prefix, type, suffix (lengths first)",
        "struct BrotliTransform { uint8_t prefix_len; uint8_t prefix[8]; uint8_t type;",
        "                        uint8_t suffix_len; uint8_t suffix[8]; };",
        f"static const BrotliTransform kBrotliTransforms[{len(t['transforms'])}] = {{",
    ]
    for prefix, kind, suffix in t["transforms"]:
        assert len(prefix) <= 8 and len(suffix) <= 8
        lines.append(f"    {{{len(prefix)}, {_c_bytes(prefix)}, {kind}, {len(suffix)}, "
                     f"{_c_bytes(suffix)}}},")
    lines.append("};")
    lines.append("")
    lines.append("// section 7.1: lut[512 * mode + p1] | lut[512 * mode + 256 + p2]")
    lines.append("static const uint8_t kBrotliContextLut[2048] = {")
    lut = t["context_lut"]
    for i in range(0, len(lut), 32):
        lines.append("    " + ", ".join(str(v) for v in lut[i: i + 32]) + ",")
    lines.append("};")
    return "\n".join(lines) + "\n"


def outputs() -> dict:
    t = tables()
    assert len(t["dictionary"]) == 122784 and len(t["transforms"]) == 121
    return {DICT_OUT: t["dictionary"], PY_OUT: python_source(t).encode(),
            H_OUT: header(t).encode()}


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
