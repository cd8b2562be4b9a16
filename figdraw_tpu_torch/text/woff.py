"""WOFF 1.0 for the port's OpenType reader: a .woff file turned back into
the sfnt it wraps, with zlib and struct, as fontTools 4.61.1's SFNTReader
reads it with flavor "woff" (ttLib/sfnt.py and WOFFDirectoryEntry):

- the 44-byte header ("wOFF", the wrapped sfnt's version, the table
  count) and the table directory (tag, offset, compLength, origLength,
  origChecksum);
- a table whose compLength is below its origLength inflated with zlib to
  exactly origLength bytes, one whose lengths are equal copied; a
  compLength above origLength refused, as fontTools' assertion refuses it;
- the metadata and private blocks ignored (they hold no table).

The result is an sfnt that OTFont reads as it reads a .ttf or .otf: the
directory in tag order, each table at a 4-aligned offset and padded with
zeros. A WOFF 2.0 file ("wOF2") goes to text/woff2.py, which rebuilds its
sfnt with the port's own Brotli decoder (fontTools reads WOFF2 through the
optional brotli module).
"""

from __future__ import annotations

import struct
import zlib

WOFF_SIGNATURE = b"wOFF"
WOFF2_SIGNATURE = b"wOF2"
SFNT_VERSIONS = (b"\x00\x01\x00\x00", b"OTTO", b"true")

_HEADER = struct.Struct(">4s4sIHHIHHIIIII")  # 44 bytes
_ENTRY = struct.Struct(">4sIIII")  # tag, offset, compLength, origLength, origChecksum


def is_woff(data: bytes) -> bool:
    """Whether a font file's bytes are WOFF 1.0 or WOFF 2.0."""
    return data[:4] in (WOFF_SIGNATURE, WOFF2_SIGNATURE)


def woff_to_sfnt(data: bytes) -> bytes:
    """The sfnt a WOFF 1.0 or WOFF 2.0 file wraps, its tables decoded."""
    if data[:4] == WOFF2_SIGNATURE:
        from .woff2 import woff2_to_sfnt

        return woff2_to_sfnt(data)
    if len(data) < _HEADER.size or data[:4] != WOFF_SIGNATURE:
        raise ValueError("Not a WOFF font (not enough data)")
    (_sig, flavor, _length, num_tables, _reserved, _total, _major, _minor,
     _meta_off, _meta_len, _meta_orig, _priv_off, _priv_len) = _HEADER.unpack_from(data, 0)
    if flavor not in SFNT_VERSIONS:
        raise ValueError("Not a TrueType or OpenType font (bad sfntVersion)")
    tables = {}
    for i in range(num_tables):
        tag, offset, comp_len, orig_len, checksum = _ENTRY.unpack_from(
            data, _HEADER.size + _ENTRY.size * i)
        raw = data[offset : offset + comp_len]
        if len(raw) != comp_len:
            raise ValueError(f"WOFF table {tag!r} runs past the end of the file")
        if comp_len == orig_len:
            body = raw
        elif comp_len < orig_len:
            body = zlib.decompress(raw)
            if len(body) != orig_len:
                raise ValueError(f"WOFF table {tag!r} inflates to {len(body)} bytes, "
                                 f"not its origLength {orig_len}")
        else:
            raise ValueError(f"WOFF table {tag!r}: compLength {comp_len} exceeds "
                             f"origLength {orig_len}")
        tables[tag] = (checksum, body)
    return _sfnt(flavor, tables)


def _sfnt(flavor: bytes, tables: dict) -> bytes:
    """An sfnt of `tables` ({tag: (checksum, bytes)}): the offset table
    with its binary-search fields, the directory in tag order, each table
    4-aligned."""
    n = len(tables)
    entry_selector = max(n.bit_length() - 1, 0)
    search_range = (1 << entry_selector) * 16
    head = struct.pack(">4sHHHH", flavor, n, search_range, entry_selector,
                       n * 16 - search_range)
    offset = 12 + 16 * n
    directory, bodies = [], []
    for tag in sorted(tables):
        checksum, body = tables[tag]
        directory.append(struct.pack(">4sIII", tag, checksum, offset, len(body)))
        pad = -len(body) % 4
        bodies.append(body + b"\0" * pad)
        offset += len(body) + pad
    return head + b"".join(directory) + b"".join(bodies)
