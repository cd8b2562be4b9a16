"""figdraw_tpu_torch's Brotli decoder (utils/brotli.py: `decompress`, the C++
fd_brotli_decompress of csrc/brotli_decode.cpp, and its plain twin
`decompress_plain`) against libbrotlidec 1.2.0, the library fontTools'
brotli module wraps (PIL's copy, through ctypes: tools/brotli_shim.py's
`decompress`, which refuses input left after the last meta-block as the
brotli module does).

- The tables: the static dictionary's size and sha256 (RFC 7932 Appendix
  A), and utils/brotli_tables.py, csrc/brotli_tables.h and the dictionary
  as tools/make_brotli_tables.py writes them from libbrotlicommon.
- Streams: DejaVuSans.woff2's (253,730 bytes; native and plain), every
  WOFF2 stream of the installed jupyterlab package (native), and streams
  built here bit by bit (`Writer`) for what a font stream may leave out:
  every window size and the large-window escape, uncompressed and
  metadata meta-blocks, each of the 121 dictionary transforms on words of
  several lengths (multi-byte letters uppercased too) under NPOSTFIX and
  NDIRECT, every short distance code against the distance ring, and the
  four context modes through a context map (native and plain).
- Faults: seeded truncations and bit flips raise in the port exactly
  where libbrotlidec fails, and decode to its bytes elsewhere.
"""

import glob
import hashlib
import os
import sys

import numpy as np
import pytest

from figdraw_tpu_torch.text.typefaces import bundled_font_path
from figdraw_tpu_torch.text.woff2 import directory
from figdraw_tpu_torch.utils import brotli, brotli_tables
from torch_reference import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
import brotli_shim  # noqa: E402
import make_brotli_tables  # noqa: E402

DICTIONARY_SHA256 = "20e42eb1b511c21806d4d227d07e5dd06877d8ce7b3a817f378f313653f35c70"


def woff2_stream(data: bytes) -> tuple:
    """(the Brotli stream of a WOFF2 file, the size it decodes to)."""
    head, entries, at = directory(data)
    return data[at: at + head[6]], sum(e[3] for e in entries)


def reference(data: bytes):
    """libbrotlidec's bytes, or None where it fails."""
    try:
        return brotli_shim.decompress(data)
    except brotli_shim.error:
        return None


def port(data: bytes, plain: bool = False):
    try:
        return (brotli.decompress_plain if plain else brotli.decompress)(data)
    except ValueError:
        return None


@pytest.fixture(scope="module")
def dejavu():
    with open(bundled_font_path("DejaVuSans.woff2"), "rb") as fh:
        return woff2_stream(fh.read())


# --- the tables -----------------------------------------------------------------------


def test_dictionary_is_rfc7932s():
    data = brotli.dictionary()
    assert len(data) == 122784 == brotli_tables.DICTIONARY_SIZE
    assert hashlib.sha256(data).hexdigest() == DICTIONARY_SHA256 == \
        brotli_tables.DICTIONARY_SHA256
    assert len(brotli_tables.TRANSFORMS) == 121
    assert brotli_tables.TRANSFORMS[0] == (b"", 0, b"")


def test_tables_are_what_the_tool_writes_from_libbrotlicommon():
    for path, data in make_brotli_tables.outputs().items():
        with open(path, "rb") as fh:
            assert fh.read() == data, path


# --- real streams ------------------------------------------------------------------------


def test_dejavu_stream_native_and_plain(dejavu):
    stream, size = dejavu
    assert len(stream) == 253730
    want = brotli_shim.decompress(stream)
    assert len(want) == size
    assert brotli.decompress(stream) == want
    assert brotli.decompress(stream, size) == want
    assert brotli.decompress(stream, 100) == want  # a short buffer grows
    used = {}
    assert brotli.decompress_plain(stream, used) == want
    for kind in ("complex code", "simple code of 1", "simple code of 4", "context map",
                 "move-to-front", "block switch L", "block switch I", "block switch D",
                 "implicit distance", "last distance", "short distance", "coded distance",
                 "dictionary word, transform 0"):
        assert used.get(kind), kind


def _jupyterlab_woff2() -> list:
    try:
        import jupyterlab
    except ImportError:
        return []
    return sorted(glob.glob(os.path.join(os.path.dirname(jupyterlab.__file__), "**", "*.woff2"),
                            recursive=True))


def test_native_equals_libbrotlidec_on_every_jupyterlab_woff2():
    files = _jupyterlab_woff2()
    if not files:
        pytest.skip("the jupyterlab package is not installed: no WOFF2 files to read")
    assert len(files) >= 100
    for path in files:
        with open(path, "rb") as fh:
            stream, size = woff2_stream(fh.read())
        got = brotli.decompress(stream, size)
        assert got == brotli_shim.decompress(stream) and len(got) == size, path


# --- streams built bit by bit ----------------------------------------------------------------


class Writer:
    """Brotli's LSB-first bits."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def bits(self, value: int, n: int) -> "Writer":
        self.acc |= value << self.n
        self.n += n
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8
        return self

    def align(self) -> "Writer":
        if self.n:
            self.bits(0, 8 - self.n)
        return self

    def window(self, wbits: int) -> "Writer":
        if wbits == 16:
            return self.bits(0, 1)
        if wbits >= 18:
            return self.bits(1, 1).bits(wbits - 17, 3)
        if wbits == 17:
            return self.bits(1, 1).bits(0, 3).bits(0, 3)
        return self.bits(1, 1).bits(0, 3).bits(wbits - 8, 3)

    def simple(self, syms, size: int, tree_select: int = 0) -> "Writer":
        """A simple prefix code of 1-4 symbols over an alphabet of `size`."""
        self.bits(1, 2).bits(len(syms) - 1, 2)
        for s in syms:
            self.bits(s, (size - 1).bit_length())
        if len(syms) == 4:
            self.bits(tree_select, 1)
        return self

    def varlen8(self, v: int) -> "Writer":
        if v == 0:
            return self.bits(0, 1)
        if v == 1:
            return self.bits(1, 1).bits(0, 3)
        n = v.bit_length() - 1
        return self.bits(1, 1).bits(n, 3).bits(v - (1 << n), n)

    def mlen(self, n: int, last: bool) -> "Writer":
        """A compressed meta-block's header of n bytes."""
        self.bits(int(last), 1)
        if last:
            self.bits(0, 1)
        nibbles = max(4, -(-(n - 1).bit_length() // 4))
        self.bits(nibbles - 4, 2).bits(n - 1, 4 * nibbles)
        if not last:
            self.bits(0, 1)  # compressed
        return self

    def end(self) -> bytes:
        return bytes(self.bits(1, 1).bits(1, 1).align().out)


def _length_code(table, value: int) -> tuple:
    """(code, extra value, extra bits) of an insert or copy length."""
    for code in range(len(table) - 1, -1, -1):
        base, extra = table[code]
        if base <= value < base + (1 << extra):
            return code, value - base, extra
    raise ValueError(value)


def _command(insert: int, copy: int, implicit: bool = False) -> tuple:
    """(insert-and-copy symbol, [(extra value, bits)]) of a command."""
    ic, iv, ib = _length_code(brotli.INSERT, insert)
    cc, cv, cb = _length_code(brotli.COPY, copy)
    cell = next(k for k, (ibase, cbase) in enumerate(brotli.CELLS)
                if (k < 2) == implicit and ibase <= ic < ibase + 8 and cbase <= cc < cbase + 8)
    ibase, cbase = brotli.CELLS[cell]
    return 64 * cell + ((ic - ibase) << 3) + (cc - cbase), [(iv, ib), (cv, cb)]


def _distance_code(d: int, npostfix: int, ndirect: int) -> tuple:
    """(distance code, extra value, extra bits) of a distance past the
    16 short codes."""
    if d <= ndirect:
        return 16 + d - 1, 0, 0
    rest = d - ndirect - 1
    postfix, high = rest & ((1 << npostfix) - 1), rest >> npostfix
    nbits = 1
    while True:
        for half in (0, 1):
            offset = ((2 + half) << nbits) - 4
            if offset <= high < offset + (1 << nbits):
                hcode = 2 * (nbits - 1) + half
                return 16 + ndirect + ((hcode << npostfix) | postfix), high - offset, nbits
        nbits += 1


def _header(w: Writer, npostfix: int, ndirect: int, modes=(0,), nlit_trees: int = 1) -> None:
    """One block type of each category, NPOSTFIX and NDIRECT, the context
    modes; a literal context map of nlit_trees trees (no map when one)."""
    for _k in range(3):
        w.varlen8(0)
    w.bits((ndirect >> npostfix) << 2 | npostfix, 6)
    for m in modes:
        w.bits(m, 2)
    w.varlen8(nlit_trees - 1)


def word_stream(length: int, index: int, transform: int, npostfix: int = 0,
                ndirect: int = 0, wbits: int = 22) -> bytes:
    """A stream of one dictionary word: one command (no insert, a copy of
    `length` at a distance past the window), its literal and command codes
    of one symbol, its distance code of one symbol. An empty word (or one
    past the transforms) gets a meta-block of one byte, which it leaves
    unfilled."""
    size = length
    if transform < len(brotli_tables.TRANSFORMS):
        prefix, kind, suffix = brotli_tables.TRANSFORMS[transform]
        body = (length - kind if kind <= 9 else length - (kind - 11) if 12 <= kind <= 20
                else length)
        size = max(len(prefix) + max(body, 0) + len(suffix), 1)  # MLEN is at least 1
    w = Writer().window(wbits).mlen(size, last=True)
    _header(w, npostfix, ndirect)
    w.varlen8(0)  # one distance tree
    w.simple([0], 256)
    cmd, extras = _command(0, length)
    w.simple([cmd], 704)
    dsize = 16 + ndirect + (48 << npostfix)
    address = (transform << brotli_tables.NDBITS[length]) | index
    dcode, dval, dbits = _distance_code(1 + address, npostfix, ndirect)  # 0 bytes out yet
    w.simple([dcode], dsize)
    for v, n in extras:
        w.bits(v, n)
    w.bits(dval, dbits)
    return bytes(w.align().out)


def ring_stream(dcode: int, commands: int = 3) -> bytes:
    """Literals, then commands of 8 literals and a copy of 4 each through
    one distance code, short codes read against the distance ring."""
    size = 44 + commands * 12
    w = Writer().window(18).mlen(size, last=True)
    _header(w, 0, 0)
    w.varlen8(0)
    w.simple([0x41, 0x42, 0x43, 0x44], 256)
    lead, lead_extra = _command(40, 4)
    cmd, extras = _command(8, 4)
    w.simple(sorted({lead, cmd}), 704)
    dsize = 16 + 48
    dc, dval, dbits = (dcode, 0, 0) if dcode < 16 else _distance_code(dcode - 15, 0, 0)
    w.simple([dc], dsize)
    rng = np.random.default_rng(dcode)
    for k in range(commands + 1):
        c, ex = (lead, lead_extra) if k == 0 else (cmd, extras)
        if lead != cmd:
            w.bits(int(c > min(lead, cmd)), 1)
        for v, n in ex:
            w.bits(v, n)
        for _ in range(40 if k == 0 else 8):
            w.bits(int(rng.integers(4)), 2)
        w.bits(dval, dbits)
    return bytes(w.align().out)


def context_stream(mode: int, seed: int) -> bytes:
    """64 literals from two trees chosen by a seeded context map under a
    context mode (one command whose copy the meta-block's end drops)."""
    rng = np.random.default_rng(seed)
    n = 64
    w = Writer().window(20).mlen(n, last=True)
    _header(w, 0, 0, modes=(mode,), nlit_trees=2)
    w.bits(0, 1)  # no run lengths
    w.simple([0, 1], 2)
    for _ in range(64):
        w.bits(int(rng.integers(2)), 1)
    w.bits(int(rng.integers(2)), 1)  # the inverse move-to-front transform or not
    w.varlen8(0)
    w.simple([0x20, 0x61, 0xC3, 0x7F], 256)
    w.simple([0x30, 0x41, 0xE2, 0x00], 256)
    cmd, extras = _command(n, 2)
    w.simple([cmd], 704)
    w.simple([0], 64)
    for v, nb in extras:
        w.bits(v, nb)
    for _ in range(n):
        w.bits(int(rng.integers(4)), 2)
    return bytes(w.align().out)


def tree_select_stream(seed: int) -> bytes:
    """48 literals through a simple code of four symbols with the tree-select
    bit set (code lengths 1, 2, 3, 3)."""
    rng = np.random.default_rng(seed)
    n = 48
    syms = [int(v) for v in rng.choice(256, 4, replace=False)]
    # the canonical codes, LSB first: the first symbol 0, the second 10, the
    # larger two of 3 bits in symbol order 110 and 111
    third, fourth = sorted(syms[2:])
    codes = {syms[0]: (0, 1), syms[1]: (1, 2), third: (3, 3), fourth: (7, 3)}
    w = Writer().window(20).mlen(n, last=True)
    _header(w, 0, 0)
    w.varlen8(0)
    w.simple(syms, 256, tree_select=1)
    cmd, extras = _command(n, 2)
    w.simple([cmd], 704)
    w.simple([0], 64)
    for v, nb in extras:
        w.bits(v, nb)
    out = bytearray()
    for _ in range(n):
        s = syms[int(rng.integers(4))]
        w.bits(*codes[s])
        out.append(s)
    data = bytes(w.align().out)
    assert brotli_shim.decompress(data) == bytes(out)
    return data


def _words_of(length: int) -> list:
    """Word indices of a length: the first, the last, and ones whose first
    byte is a two- or three-byte UTF-8 lead (ToUpperCase's other steps)."""
    words = brotli.dictionary()
    count = 1 << brotli_tables.NDBITS[length]
    at = brotli_tables.OFFSETS[length]
    picks = {0, count - 1}
    for lead in ((0xC0, 0xE0), (0xE0, 0x100)):
        for i in range(count):
            if lead[0] <= words[at + i * length] < lead[1]:
                picks.add(i)
                break
    return sorted(picks)


def _same(data: bytes) -> None:
    want = reference(data)
    assert port(data) == want
    assert port(data, plain=True) == want


@pytest.mark.parametrize("transform", range(121))
def test_every_dictionary_transform(transform):
    """Words of lengths 4, 9 and 24 through one transform, equal to
    libbrotlidec's, under three NPOSTFIX and NDIRECT settings."""
    decoded = 0
    for length in (4, 9, 24):
        for index in _words_of(length):
            for npostfix, ndirect in ((0, 0), (1, 4), (3, 120)):
                data = word_stream(length, index, transform, npostfix, ndirect)
                _same(data)
                decoded += reference(data) is not None
    assert decoded


def test_words_past_the_transforms_and_lengths_raise():
    for data in (word_stream(4, 0, 121), word_stream(5, 0, 200)):
        assert reference(data) is None and port(data) is None
        assert port(data, plain=True) is None


@pytest.mark.parametrize("dcode", list(range(16)) + [16, 40])
def test_distance_ring(dcode):
    _same(ring_stream(dcode))


@pytest.mark.parametrize("mode", range(4))
def test_context_modes(mode):
    for seed in range(6):
        data = context_stream(mode, seed)
        assert reference(data) is not None
        _same(data)


def test_simple_code_tree_select():
    for seed in range(4):
        _same(tree_select_stream(seed))


@pytest.mark.parametrize("wbits", range(10, 25))
def test_window_sizes(wbits):
    data = Writer().window(wbits).end()
    assert reference(data) == b"" == port(data) == port(data, plain=True)


def test_large_window_escape_and_trailing_input_raise():
    large = bytes(Writer().bits(1, 1).bits(0, 3).bits(1, 3).bits(0, 1).bits(1, 2).align().out)
    for data in (large, Writer().window(22).end() + b"\0", b""):
        assert reference(data) is None and port(data) is None and port(data, True) is None


def test_uncompressed_and_metadata_meta_blocks():
    payload = bytes(range(256)) * 300
    data = brotli_shim.compress(payload)
    assert reference(data) == payload == port(data) == port(data, plain=True)
    w = Writer().window(16)
    w.bits(0, 1).bits(3, 2).bits(0, 1).bits(2, 2).bits(0x2C, 8).bits(0x01, 8).align()
    w.out += bytes(0x12D)  # MSKIPLEN 0x12D bytes of metadata
    w.bits(0, 1).bits(3, 2).bits(0, 1).bits(0, 2).align()  # an empty metadata block
    data = w.end()
    assert reference(data) == b"" == port(data) == port(data, plain=True)
    # a last nibble of 0 in a two-byte MSKIPBYTES, and non-zero padding
    bad = Writer().window(16).bits(0, 1).bits(3, 2).bits(0, 1).bits(2, 2).bits(5, 8)
    bad = bad.bits(0, 8).align().end()
    pad = bytes(Writer().window(16).bits(1, 1).bits(1, 1).bits(0b10000, 5).out)
    for data in (bad, pad):
        assert reference(data) is None and port(data) is None and port(data, True) is None


# --- faults ----------------------------------------------------------------------------------


def _corrupt(stream: bytes, rng) -> bytes:
    data = bytearray(stream)
    if rng.integers(3) == 0:
        return bytes(data[: rng.integers(0, len(data))])
    for _ in range(rng.integers(1, 4)):
        data[rng.integers(0, len(data))] ^= 1 << rng.integers(8)
    return bytes(data)


@pytest.mark.parametrize("seed", range(4))
def test_corrupt_streams_fail_where_libbrotlidec_fails(dejavu, seed):
    """Cuts and flips of the DejaVu stream (native), of built streams
    (native and plain) and of a few DejaVu cuts (plain): the port's bytes
    or failure are libbrotlidec's."""
    rng = np.random.default_rng(seed)
    stream = dejavu[0]
    outcomes = set()
    for _ in range(60):
        data = _corrupt(stream, rng)
        want = reference(data)
        assert port(data) == want
        outcomes.add(want is None)
    small = [word_stream(9, 5, 15, 1, 4), ring_stream(5), context_stream(2, seed),
             brotli_shim.compress(b"figdraw " * 40)]
    for base in small:
        for _ in range(40):
            data = _corrupt(base, rng)
            want = reference(data)
            assert port(data) == want
            assert port(data, plain=True) == want
            outcomes.add(want is None)
    cut = stream[: int(rng.integers(1000, len(stream)))]
    assert port(cut, plain=True) is None is reference(cut)
    assert outcomes == {True, False}
