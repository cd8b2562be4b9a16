"""Zstandard decoding (RFC 8878) as TIFF's ZSTD compression (50000) needs
it, read the way libtiff 4.7.1's ZSTDDecode reads a strip through
libzstd's streaming decoder, which PIL 12.1.0 reads such a TIFF through:
`decompress` in C++ (csrc/zstd_decode.cpp: fd_zstd_decompress),
`decompress_plain` its twin in Python.

A strip is read as one frame: frame header (single-segment flag, window
descriptor, dictionary ID, Frame_Content_Size, the content checksum,
checked with XXH64), raw, RLE and compressed blocks of at most 128 KiB
(and the window), literals raw, RLE or Huffman-coded in one or four
streams (weights stored directly or FSE-coded, or the previous block's
table), sequences with predefined, RLE, FSE-coded or repeated tables and
the three repeat offsets. As libzstd does inside ZSTDDecode, decoding
stops once the strip's bytes are out (one more block is read when they
end on a block, and its faults found), so what follows is not read; a
frame that ends first ends the strip, so a second frame, or any frame
after a skippable one, is never reached, and the strip then comes out
short (libtiff: "Not enough data"), as it does when the data is cut.
A dictionary, a window over 2^27 + 1 bytes, reserved bits and every fault
libzstd reports raise ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

from . import image_lib

MAGIC = 0xFD2FB528
SKIPPABLE, SKIPPABLE_MASK = 0x184D2A50, 0xFFFFFFF0
BLOCK_MAX = 128 * 1024
WINDOW_MAX = (1 << 27) + 1  # libzstd's default limit for a decoder

# literal length and match length codes: (baseline, extra bits)
LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4),
    (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12),
    (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4),
    (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12),
    (8195, 13), (16387, 14), (32771, 15), (65539, 16)]
# RFC 8878 3.1.1.3.2.2: the predefined distributions and accuracy logs
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2,
               1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
# (largest symbol, largest accuracy log) of each FSE table
LL_MAX, ML_MAX, OF_MAX = (35, 9), (52, 9), (31, 8)

ERRORS = {-1: "corrupt", -2: "a dictionary", -3: "a window over 2^27 + 1 bytes",
          -4: "a content checksum that does not match"}


def decompress(data: bytes, limit: int) -> np.ndarray:
    """The first `limit` bytes (or fewer, where the frame ends or the data
    is cut first) of a ZSTD strip, in C++."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max(limit, 1), np.uint8)
    got = image_lib.load_zstd().fd_zstd_decompress(src.ctypes.data, len(data), out.ctypes.data,
                                                   limit)
    if got < 0:
        raise ValueError(f"Zstandard data: {ERRORS.get(got, 'corrupt')}")
    return out[:got]


def decompress_plain(data: bytes, limit: int) -> np.ndarray:
    """decompress in Python."""
    out = _Frame(bytes(data), limit).run()
    return np.frombuffer(bytes(out[:limit]), np.uint8).copy()


def _fail(what: str = "corrupt"):
    raise ValueError(f"Zstandard data: {what}")


def highbit(v: int) -> int:
    return v.bit_length() - 1


# --- XXH64 -------------------------------------------------------------------------

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261
_M64 = (1 << 64) - 1


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    n, p = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64]
        lanes = struct.unpack_from(f"<{n // 32 * 4}Q", data)
        for i in range(0, len(lanes), 4):
            v = [_round(v[k], lanes[i + k]) for k in range(4)]
        p = n // 32 * 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for k in range(4):
            h = ((h ^ _round(0, v[k])) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        (lane,) = struct.unpack_from("<Q", data, p)
        h = (_rotl(h ^ _round(0, lane), 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        (lane,) = struct.unpack_from("<I", data, p)
        h = (_rotl(h ^ (lane * _P1 & _M64), 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h = (_rotl(h ^ (data[p] * _P5 & _M64), 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# --- bit readers ----------------------------------------------------------------------


class _Backward:
    """A backward bitstream (RFC 8878 4.1): read from its last byte's
    highest set bit (the end marker, not read) down to bit 0 of its first;
    bits past the start read as zeros and count as overflow."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            _fail()
        self.data = data
        self.pos = 8 * (len(data) - 1) + highbit(data[-1])  # bits left

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        lo = self.pos
        if lo >= 0:
            first, last = lo >> 3, (lo + n - 1) >> 3
            v = int.from_bytes(self.data[first: last + 1], "little")
            return (v >> (lo & 7)) & ((1 << n) - 1)
        if lo + n <= 0:
            return 0
        v = int.from_bytes(self.data[: (lo + n + 7) >> 3], "little")
        return (v << -lo) & ((1 << n) - 1)

    def overflow(self) -> bool:
        return self.pos < 0

    def finished(self) -> bool:
        return self.pos == 0


# --- FSE ------------------------------------------------------------------------------


def read_ncount(data: bytes, max_symbol: int, max_log: int) -> tuple:
    """An FSE table description (RFC 8878 4.1.1): (normalized counts,
    accuracy log, bytes read)."""
    bits = int.from_bytes(data[:1024] + bytes(8), "little")  # a description is shorter
    pos = 0

    def take(n):
        nonlocal pos
        v = (bits >> pos) & ((1 << n) - 1)
        return v

    log = take(4) + 5
    pos += 4
    if log > max_log:
        _fail("an FSE table of too fine an accuracy")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts = []
    previous0 = False
    while True:
        if pos > 8 * 1024:
            _fail("an FSE table description past its data")
        if previous0:
            while True:
                rep = take(2)
                pos += 2
                counts += [0] * rep
                if rep < 3:
                    break
            if len(counts) > max_symbol:
                break
        mx = 2 * threshold - 1 - remaining
        v = take(nbits)
        if (v & (threshold - 1)) < mx:
            count = v & (threshold - 1)
            pos += nbits - 1
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            pos += nbits
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        previous0 = count == 0
        if remaining < threshold:
            if remaining <= 1:
                break
            nbits = highbit(remaining) + 1
            threshold = 1 << (nbits - 1)
        if len(counts) > max_symbol:
            break
    if remaining != 1 or len(counts) > max_symbol + 1:
        _fail("an FSE table description")
    used = (pos + 7) >> 3
    if used > len(data):
        _fail("an FSE table description past its data")
    return counts, log, used


def build_fse(counts: list, log: int) -> list:
    """The decoding table (RFC 8878 4.1.1): [(symbol, bits, baseline)]."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    nxt = []
    for s, c in enumerate(counts):
        if c == -1:
            symbols[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(c)
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbols[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        _fail("an FSE table that does not spread")
    table = []
    for u in range(size):
        s = symbols[u]
        state = nxt[s]
        nxt[s] += 1
        nb = log - highbit(state)
        table.append((s, nb, (state << nb) - size))
    return table


# --- Huffman literals ---------------------------------------------------------------


def read_huffman(data: bytes) -> tuple:
    """A Huffman tree description (RFC 8878 4.2.1): (decoding table
    [(symbol, bits)] indexed by max_bits bits, max_bits, bytes read)."""
    if not data:
        _fail()
    head = data[0]
    if head >= 128:
        n = head - 127
        size = (n + 1) // 2
        if size + 1 > len(data):
            _fail("Huffman weights past the block")
        weights = []
        for i in range(n):
            b = data[1 + i // 2]
            weights.append(b >> 4 if i % 2 == 0 else b & 15)
    else:
        size = head
        if size + 1 > len(data):
            _fail("Huffman weights past the block")
        weights = _fse_weights(data[1: 1 + size])
    total = 0
    ranks = [0] * 13
    for w in weights:
        if w > 12:
            _fail("a Huffman weight over 12")
        ranks[w] += 1
        total += (1 << w) >> 1
    if total == 0:
        _fail("Huffman weights of no code")
    max_bits = highbit(total) + 1
    if max_bits > 12:
        _fail("a Huffman code over 12 bits")
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        _fail("Huffman weights that do not complete a code")
    last = highbit(rest) + 1
    weights.append(last)
    ranks[last] += 1
    if ranks[1] < 2 or ranks[1] & 1:
        _fail("Huffman weights of an odd count of the longest codes")
    table = [None] * (1 << max_bits)
    pos = 0
    for w in range(1, max_bits + 1):
        for s, sw in enumerate(weights):
            if sw == w:
                span = (1 << w) >> 1
                entry = (s, max_bits + 1 - w)
                table[pos: pos + span] = [entry] * span
                pos += span
    return table, max_bits, size + 1


def _fse_weights(data: bytes) -> list:
    """Huffman weights coded with FSE (two interleaved states, accuracy log
    at most 6), decoded until the bitstream overflows."""
    counts, log, used = read_ncount(data, 255, 6)
    table = build_fse(counts, log)
    bits = _Backward(data[used:])
    s1, s2 = bits.read(log), bits.read(log)
    out = []
    while True:
        for a, b in ((0, 1), (1, 0)):
            if len(out) > 253:
                _fail("too many Huffman weights")
            st = (s1, s2)[a]
            sym, nb, base = table[st]
            out.append(sym)
            st = base + bits.read(nb)
            if a == 0:
                s1 = st
            else:
                s2 = st
            if bits.overflow():
                other = (s1, s2)[b]
                out.append(table[other][0])
                return out


def decode_huffman(buf: bytes, lo: int, hi: int, n: int, table: list, max_bits: int,
                   pos: int = None, out: bytearray = None, at: int = 0) -> int:
    """n symbols of the Huffman stream buf[lo:hi] into out[at:], from bit
    position pos (its start by default); bits below buf[lo] read as zeros
    when lo is not 0 and as the bytes before it otherwise. Returns the bit
    position it ends at."""
    if pos is None:
        if hi <= lo or buf[hi - 1] == 0:
            _fail()
        pos = 8 * (hi - 1) + highbit(buf[hi - 1])
    base = 8 * lo
    mask = (1 << max_bits) - 1
    for i in range(at, at + n):
        lo_bit = pos - max_bits
        if lo_bit >= base:
            v = int.from_bytes(buf[lo_bit >> 3: ((pos - 1) >> 3) + 1], "little") >> (lo_bit & 7)
        elif pos > base:
            first = base >> 3
            v = (int.from_bytes(buf[first: ((pos - 1) >> 3) + 1], "little")
                 >> (base & 7)) << (base - lo_bit)
        else:
            v = 0
        sym, nb = table[v & mask]
        out[i] = sym
        pos -= nb
    return pos


def decode_streams(src: bytes, size: int, table: list, max_bits: int) -> bytes:
    """Four Huffman streams after their jump table, each of a quarter of
    the size (the last the rest). libzstd (64-bit) runs its fast loop where
    every stream has 8 bytes or more, the code at most 11 bits and four
    non-empty quarters: 5 symbols a stream between reloads of each 8-byte
    window, the rounds bounded by the output left and the first stream's
    bytes left; it fails if a window then lies more than 8 bytes below its
    stream's start, reads bits below a stream from the bytes before it, and
    checks no stream's end. Otherwise each stream must be used up exactly,
    bits below it read as zeros."""
    if len(src) < 10:
        _fail("four literal streams in under 10 bytes")
    l1, l2, l3 = struct.unpack_from("<3H", src)
    if 6 + l1 + l2 + l3 > len(src):
        _fail("literal streams past their data")
    per = (size + 3) // 4
    cuts = [6, 6 + l1, 6 + l1 + l2, 6 + l1 + l2 + l3, len(src)]
    counts = [per, per, per, size - 3 * per]
    out = bytearray(size)
    fast = (min(cuts[k + 1] - cuts[k] for k in range(4)) >= 8 and max_bits <= 11
            and 3 * per < size)
    if not fast:
        for k in range(4):
            end = decode_huffman(src, cuts[k], cuts[k + 1], counts[k], table, max_bits,
                                 out=out, at=k * per)
            if end != 8 * cuts[k]:
                _fail("a Huffman stream not used up exactly")
        return bytes(out)
    ip, used, pos = [], [0] * 4, []
    for k in range(4):  # a last byte of 0 has no end mark: all its bits are read
        last = src[cuts[k + 1] - 1]
        ip.append(cuts[k + 1] - 8)
        pos.append(8 * (cuts[k + 1] - 1) + (highbit(last) if last else 8))
    while True:
        iters = min((size - 3 * per - used[3]) // 5, ip[0] // 7)
        if iters == 0 or any(ip[k] < ip[k - 1] for k in (1, 2, 3)):
            break
        for _ in range(iters):
            for k in range(4):
                pos[k] = decode_huffman(src, 0, 0, 5, table, max_bits, pos[k], out,
                                        k * per + used[k])
                used[k] += 5
                ip[k] -= (8 * (ip[k] + 8) - pos[k]) >> 3
    for k in range(4):
        if ip[k] < cuts[k] - 8:
            _fail("a Huffman stream read past its start")
        decode_huffman(src, 0, 0, counts[k] - used[k], table, max_bits, pos[k], out,
                       k * per + used[k])
    return bytes(out)


# --- frames and blocks ----------------------------------------------------------------


class _Frame:
    def __init__(self, data: bytes, limit: int):
        self.data, self.limit = data, limit
        self.out = bytearray()
        self.huffman = None  # (table, max_bits) of the last Huffman literals
        self.fse = {}  # "ll", "of", "ml" -> the last table
        self.reps = [1, 4, 8]

    def run(self) -> bytearray:
        d = self.data
        if len(d) < 4:
            return self.out
        (magic,) = struct.unpack_from("<I", d)
        if magic & SKIPPABLE_MASK == SKIPPABLE:
            return self.out  # the frame ends, and with it libtiff's read
        if magic != MAGIC:
            _fail("not a Zstandard frame")
        if len(d) < 6:
            return self.out
        desc = d[4]
        fcs_flag, single, checksum, did_flag = desc >> 6, (desc >> 5) & 1, (desc >> 2) & 1, desc & 3
        if desc & 8:
            _fail("a reserved frame header bit")
        pos = 5
        window = 0
        if not single:
            wd = d[pos]
            pos += 1
            wlog = 10 + (wd >> 3)
            window = (1 << wlog) + ((1 << wlog) >> 3) * (wd & 7)
        did_size = (0, 1, 2, 4)[did_flag]
        fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
        if pos + did_size + fcs_size > len(d):
            return self.out
        did = int.from_bytes(d[pos: pos + did_size], "little")
        pos += did_size
        fcs = None
        if fcs_size:
            fcs = int.from_bytes(d[pos: pos + fcs_size], "little") + (256 if fcs_size == 2 else 0)
            pos += fcs_size
        if single:
            window = fcs
        if did:
            _fail("a dictionary")
        if window > WINDOW_MAX:
            _fail("a window over 2^27 + 1 bytes")
        block_max = min(window, BLOCK_MAX)
        one_more = False
        while True:
            if pos + 3 > len(d):
                return self.out
            bh = int.from_bytes(d[pos: pos + 3], "little")
            pos += 3
            last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
            if btype == 3:
                _fail("a reserved block type")
            if bsize > block_max or (btype == 2 and bsize >= BLOCK_MAX):
                _fail("a block over its largest size")
            if btype == 1:
                if pos + 1 > len(d):
                    return self.out
                block = d[pos: pos + 1] * bsize
                pos += 1
            else:
                if pos + bsize > len(d):
                    return self.out
                body = d[pos: pos + bsize]
                pos += bsize
                block = body if btype == 0 else self.compressed(body, block_max)
            self.out += block
            if fcs is not None and len(self.out) > fcs:
                _fail("more than the frame's content size")
            if last:
                if fcs is not None and len(self.out) != fcs:
                    _fail("other than the frame's content size")
                if checksum and len(self.out) <= self.limit:
                    if pos + 4 > len(d):
                        return self.out
                    if struct.unpack_from("<I", d, pos)[0] != xxh64(bytes(self.out)) & 0xFFFFFFFF:
                        _fail("a content checksum that does not match")
                return self.out
            if one_more or len(self.out) > self.limit:
                return self.out
            one_more = len(self.out) == self.limit

    # --- a compressed block ---
    def compressed(self, body: bytes, block_max: int) -> bytes:
        lits, pos = self.literals(body, block_max)
        seqs = self.sequences(body[pos:])
        return self.execute(lits, seqs, block_max)

    def literals(self, b: bytes, block_max: int) -> tuple:
        if len(b) < 2:
            _fail("a compressed block of under 2 bytes")
        kind, fmt = b[0] & 3, (b[0] >> 2) & 3
        if kind in (0, 1):
            if fmt in (0, 2):
                size, head = b[0] >> 3, 1
            elif fmt == 1:
                if len(b) < 2:
                    _fail()
                size, head = (b[0] >> 4) + (b[1] << 4), 2
            else:
                if len(b) < 3:
                    _fail()
                size, head = (b[0] >> 4) + (b[1] << 4) + (b[2] << 12), 3
            if size > block_max:
                _fail("literals over the block's largest size")
            if kind == 0:
                if head + size > len(b):
                    _fail("literals past the block")
                return b[head: head + size], head + size
            if head + 1 > len(b):
                _fail("literals past the block")
            return b[head: head + 1] * size, head + 1
        head = (3, 3, 4, 5)[fmt]
        if len(b) < 5:
            _fail("Huffman literals in under 5 bytes")
        v = int.from_bytes(b[:head], "little")
        if head == 3:
            size, csize = (v >> 4) & 0x3FF, (v >> 14) & 0x3FF
        elif head == 4:
            size, csize = (v >> 4) & 0x3FFF, v >> 18
        else:
            size, csize = (v >> 4) & 0x3FFFF, v >> 22
        streams = 1 if fmt == 0 else 4
        if size > block_max:
            _fail("literals over the block's largest size")
        if head + csize > len(b):
            _fail("literals past the block")
        if streams == 4 and size < 6:
            _fail("four literal streams of under 6 bytes")
        src = b[head: head + csize]
        if kind == 2:
            table, max_bits, used = read_huffman(src)
            self.huffman = (table, max_bits)
            src = src[used:]
        elif self.huffman is None:
            _fail("treeless literals without an earlier table")
        table, max_bits = self.huffman
        if streams == 1:
            out = bytearray(size)
            if decode_huffman(src, 0, len(src), size, table, max_bits, out=out) != 0:
                _fail("a Huffman stream not used up exactly")
            lits = bytes(out)
        else:
            lits = decode_streams(src, size, table, max_bits)
        return lits, head + csize

    def table(self, mode: int, b: bytes, pos: int, name: str, default, limits) -> tuple:
        if mode == 0:
            t = build_fse(*default)
            log = default[1]
        elif mode == 1:
            if pos >= len(b):
                _fail()
            if b[pos] > limits[0]:
                _fail("an RLE symbol past its table")
            t, log = [(b[pos], 0, 0)], 0
            pos += 1
        elif mode == 2:
            counts, log, used = read_ncount(b[pos:], limits[0], limits[1])
            t = build_fse(counts, log)
            pos += used
        else:
            if name not in self.fse:
                _fail("a repeated table without an earlier one")
            return self.fse[name], pos
        self.fse[name] = (t, log)
        return (t, log), pos

    def sequences(self, b: bytes) -> list:
        if not b:
            _fail("no sequences section")
        n = b[0]
        pos = 1
        if n == 0:
            if len(b) != 1:
                _fail("bytes after no sequences")
            return []
        if n >= 128:
            if n < 255:
                if len(b) < 2:
                    _fail()
                n, pos = ((n - 128) << 8) + b[1], 2
            else:
                if len(b) < 3:
                    _fail()
                n, pos = b[1] + (b[2] << 8) + 0x7F00, 3
        if pos >= len(b):
            _fail()
        modes = b[pos]
        pos += 1
        if modes & 3:
            _fail("reserved sequence mode bits")
        (llt, lllog), pos = self.table(modes >> 6, b, pos, "ll", LL_DEFAULT, LL_MAX)
        (oft, oflog), pos = self.table((modes >> 4) & 3, b, pos, "of", OF_DEFAULT, OF_MAX)
        (mlt, mllog), pos = self.table((modes >> 2) & 3, b, pos, "ml", ML_DEFAULT, ML_MAX)
        bits = _Backward(b[pos:])
        ll_s, of_s, ml_s = bits.read(lllog), bits.read(oflog), bits.read(mllog)
        seqs = []
        for i in range(n):
            ll_code, of_code, ml_code = llt[ll_s][0], oft[of_s][0], mlt[ml_s][0]
            if ll_code > 35 or ml_code > 52 or of_code > 31:
                _fail("a sequence code past its table")
            offset = (1 << of_code) + bits.read(of_code)
            mbase, mbits = ML_CODES[ml_code]
            match = mbase + bits.read(mbits)
            lbase, lbits = LL_CODES[ll_code]
            lit = lbase + bits.read(lbits)
            seqs.append((lit, offset, match))
            if i < n - 1:
                _s, nb, base = llt[ll_s]
                ll_s = base + bits.read(nb)
                _s, nb, base = mlt[ml_s]
                ml_s = base + bits.read(nb)
                _s, nb, base = oft[of_s]
                of_s = base + bits.read(nb)
        if not bits.finished():
            _fail("a sequences bitstream not used up exactly")
        return seqs

    def execute(self, lits: bytes, seqs: list, block_max: int) -> bytes:
        out = self.out
        start = len(out)
        reps = self.reps
        lp = 0
        for lit, value, match in seqs:
            if value > 3:
                offset = value - 3
                reps[:] = [offset, reps[0], reps[1]]
            else:
                idx = value - 1 + (lit == 0)
                if idx == 0:
                    offset = reps[0]
                elif idx == 3:
                    offset = reps[0] - 1
                    reps[:] = [offset, reps[0], reps[1]]
                else:
                    offset = reps[idx]
                    if idx == 1:
                        reps[:] = [offset, reps[0], reps[2]]
                    else:
                        reps[:] = [offset, reps[0], reps[1]]
            if lp + lit > len(lits):
                _fail("a sequence past its literals")
            out += lits[lp: lp + lit]
            lp += lit
            if offset == 0 or offset > len(out):
                _fail("a match offset before the frame's start")
            if len(out) - start + match > block_max:
                _fail("a block over its largest size")
            src = len(out) - offset
            if offset >= match:
                out += out[src: src + match]
            else:
                chunk = out[src: src + offset]
                out += (chunk * (match // offset + 1))[:match]
        out += lits[lp:]
        if len(out) - start > block_max:
            _fail("a block over its largest size")
        block = bytes(out[start:])
        del out[start:]
        return block
