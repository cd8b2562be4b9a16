"""Brotli decoding (RFC 7932) as WOFF 2.0 fonts need it, read the way
libbrotlidec 1.2.0 reads a stream (the library fontTools' `brotli` module
wraps): `decompress` in C++ (csrc/brotli_decode.cpp: fd_brotli_decompress),
`decompress_plain` its twin in Python.

A stream is read whole:

- the stream header (window bits 10-24; the large-window escape raises);
- meta-block headers: ISLAST and ISLASTEMPTY, MNIBBLES and MLEN (a last
  nibble of 0 in more than four raises), uncompressed meta-blocks and
  metadata meta-blocks (MSKIPBYTES, MSKIPLEN), their padding bits zero;
- simple prefix codes (NSYM 1-4, the tree-select bit) and complex ones (the
  code length code with HSKIP, repeat codes 16 and 17 with their growing
  repeat counts), each complete, as libbrotlidec checks them;
- block types and counts for the literal, insert-and-copy and distance
  categories, with the block type ring;
- NPOSTFIX and NDIRECT, the context modes (LSB6, MSB6, UTF8, signed, by
  the lookup table of section 7.1), the literal and distance context maps
  (run-length codes for zeros, the inverse move-to-front transform);
- insert-and-copy commands, the implicit last distance, the distance ring
  buffer and its 16 short codes, the direct and the NPOSTFIX codes;
- static-dictionary references (a distance past the window and the bytes
  out so far) with the 121 word transforms.

The dictionary and the transforms are libbrotlicommon's
(utils/brotli_dictionary.bin, utils/brotli_tables.py, written by
tools/make_brotli_tables.py). Every fault libbrotlidec reports, and a stream
that ends early, raises ValueError; so does input left after the last
meta-block, as the `brotli` Python module refuses it, and a command that
reads no bit and writes no byte (an empty dictionary word through codes of
one symbol), which would repeat without end.
"""

from __future__ import annotations

import os

import numpy as np

from . import brotli_tables as T
from . import image_lib

DICTIONARY_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "brotli_dictionary.bin")
WINDOW_GAP = 16
MAX_DISTANCE = 0x7FFFFFFC
ERRORS = {-1: "corrupt", -2: "truncated", -3: "input left after the last meta-block"}

# insert and copy length codes: (base, extra bits)
INSERT = [(0, 0), (1, 0), (2, 0), (3, 0), (4, 0), (5, 0), (6, 1), (8, 1), (10, 2), (14, 2),
          (18, 3), (26, 3), (34, 4), (50, 4), (66, 5), (98, 5), (130, 6), (194, 7), (322, 8),
          (578, 9), (1090, 10), (2114, 12), (6210, 14), (22594, 24)]
COPY = [(2, 0), (3, 0), (4, 0), (5, 0), (6, 0), (7, 0), (8, 0), (9, 0), (10, 1), (12, 1),
        (14, 2), (18, 2), (22, 3), (30, 3), (38, 4), (54, 4), (70, 5), (102, 5), (134, 6),
        (198, 7), (326, 8), (582, 9), (1094, 10), (2118, 24)]
# an insert-and-copy symbol's 64-cell: (insert code base, copy code base)
CELLS = [(0, 0), (0, 8), (0, 0), (0, 8), (8, 0), (8, 8), (0, 16), (16, 0), (8, 16), (16, 8),
         (16, 16)]
# block count codes: (base, extra bits)
BLOCK_LENGTH = [(1, 2), (5, 2), (9, 2), (13, 2), (17, 3), (25, 3), (33, 3), (41, 3), (49, 4),
                (65, 4), (81, 4), (97, 4), (113, 5), (145, 5), (177, 5), (209, 5), (241, 6),
                (305, 6), (369, 7), (497, 8), (753, 9), (1265, 10), (2289, 11), (4337, 12),
                (8433, 13), (16625, 24)]
# the code length code's symbols in stream order, and its fixed prefix code
# (the next four bits -> (length, value))
CODE_LENGTH_ORDER = (1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15)
CODE_LENGTH_PREFIX = [(2, 0), (2, 4), (2, 3), (3, 2), (2, 0), (2, 4), (2, 3), (4, 1),
                      (2, 0), (2, 4), (2, 3), (3, 2), (2, 0), (2, 4), (2, 3), (4, 5)]
# short distance codes 4-15: (which of the last distances, delta)
SHORT_DELTA = [(0, -1), (0, 1), (0, -2), (0, 2), (0, -3), (0, 3),
               (1, -1), (1, 1), (1, -2), (1, 2), (1, -3), (1, 3)]

_dictionary = None


def dictionary() -> bytes:
    """RFC 7932's static dictionary (libbrotlicommon's, stored beside this
    module)."""
    global _dictionary
    if _dictionary is None:
        with open(DICTIONARY_PATH, "rb") as fh:
            data = fh.read()
        if len(data) != T.DICTIONARY_SIZE:
            raise ValueError(f"{DICTIONARY_PATH} holds {len(data)} bytes, not "
                             f"{T.DICTIONARY_SIZE}")
        _dictionary = data
    return _dictionary


def decompress(data: bytes, size_hint: int = 0) -> bytes:
    """A whole Brotli stream decoded, in C++. size_hint: the expected size
    (the buffer is grown and the stream decoded again when it is more)."""
    src = np.frombuffer(bytes(data), np.uint8)
    words = np.frombuffer(dictionary(), np.uint8)
    cap = max(size_hint, 4 * len(src), 1 << 16)
    lib = image_lib.load_brotli()
    while True:
        out = np.empty(cap, np.uint8)
        got = lib.fd_brotli_decompress(src.ctypes.data, len(src), words.ctypes.data,
                                       out.ctypes.data, cap)
        if got < 0:
            raise ValueError(f"Brotli stream: {ERRORS.get(got, 'corrupt')}")
        if got <= cap:
            return out[:got].tobytes()
        cap = got


def decompress_plain(data: bytes, used: dict = None) -> bytes:
    """decompress in Python. used: a dict that counts what the stream
    exercises (meta-block kinds, prefix code kinds, context modes, block
    switches, distance kinds, dictionary words by transform)."""
    return bytes(_Decoder(bytes(data), used if used is not None else {}).run())


def _fail(what: str = "corrupt"):
    raise ValueError(f"Brotli stream: {what}")


class _Bits:
    """The stream's bits, LSB first, through a window of at least 64 bits
    (zeros past the end); consuming a bit past the end raises."""

    def __init__(self, data: bytes):
        self.data, self.end = data, 8 * len(data)
        self.buf = self.nbuf = self.next = 0

    @property
    def pos(self) -> int:
        return 8 * self.next - self.nbuf

    def peek(self, n: int) -> int:
        if self.nbuf < n:
            self.buf |= int.from_bytes(self.data[self.next: self.next + 8], "little") << self.nbuf
            self.nbuf += 64
            self.next += 8
        return self.buf & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.buf >>= n
        self.nbuf -= n
        if 8 * self.next - self.nbuf > self.end:
            _fail("truncated")

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.skip(n)
        return v

    def align(self) -> None:
        """libbrotlidec's BrotliJumpToByteBoundary: the pad bits must be 0."""
        if self.read(self.nbuf % 8):
            _fail()

    def take(self, n: int) -> bytes:
        """n whole bytes from a byte boundary."""
        at = self.pos // 8
        if at + n > len(self.data):
            _fail("truncated")
        self.buf = self.nbuf = 0
        self.next = at + n
        return self.data[at: at + n]


class _Code:
    """A prefix code read LSB first: a table of 2^bits entries
    (symbol << 4 | length) indexed by the next `bits` bits; a code of one
    symbol reads no bit."""

    def __init__(self, lengths, single: int = None):
        if single is not None:
            self.bits, self.table = 0, [single << 4]
            return
        bits = max(lengths)
        counts = [0] * 16
        for ln in lengths:
            counts[ln] += 1
        counts[0] = 0
        code, nxt = 0, [0] * 16
        for ln in range(1, 16):
            code = (code + counts[ln - 1]) << 1
            nxt[ln] = code
        table = np.zeros(1 << bits, np.int64)
        for sym, ln in enumerate(lengths):
            if ln:
                c = nxt[ln]
                nxt[ln] += 1
                rev = int(f"{c:0{ln}b}"[::-1], 2)
                table[rev:: 1 << ln] = (sym << 4) | ln
        self.bits, self.table = bits, table.tolist()

    def read(self, br: _Bits) -> int:
        e = self.table[br.peek(self.bits)]
        br.skip(e & 15)
        return e >> 4


class _Decoder:
    def __init__(self, data: bytes, used: dict):
        self.br = _Bits(data)
        self.used = used
        self.out = bytearray()
        self.rb = [16, 15, 11, 4]  # the distance ring, libbrotlidec's dist_rb
        self.rb_idx = 0

    def count(self, key: str, n: int = 1) -> None:
        self.used[key] = self.used.get(key, 0) + n

    # --- headers ----------------------------------------------------------------------

    def window_bits(self) -> int:
        br = self.br
        if not br.read(1):
            return 16
        n = br.read(3)
        if n:
            return 17 + n
        n = br.read(3)
        if n == 1:
            _fail("a large-window stream")
        return 8 + n if n else 17

    def varlen8(self) -> int:
        br = self.br
        if not br.read(1):
            return 0
        n = br.read(3)
        return 1 if n == 0 else (1 << n) + br.read(n)

    def code(self, size: int) -> _Code:
        """libbrotlidec's ReadHuffmanCode over an alphabet of `size`."""
        br = self.br
        kind = br.read(2)
        if kind == 1:
            nsym = br.read(2) + 1
            width = (size - 1).bit_length()
            syms = [br.read(width) for _ in range(nsym)]
            if any(s >= size for s in syms):
                _fail()
            if len(set(syms)) != nsym:
                _fail()
            lengths = [0] * size
            shape = {1: (0,), 2: (1, 1), 3: (1, 2, 2), 4: (2, 2, 2, 2)}[nsym]
            if nsym == 4 and br.read(1):
                shape = (1, 2, 3, 3)
            for s, ln in zip(syms, shape):
                lengths[s] = ln
            self.count(f"simple code of {nsym}")
            return _Code(lengths, syms[0] if nsym == 1 else None)
        # the code length code, its first `kind` lengths skipped (HSKIP)
        cl = [0] * 18
        space, ncodes = 32, 0
        for i in range(kind, 18):
            ln, v = CODE_LENGTH_PREFIX[br.peek(4)]
            br.skip(ln)
            cl[CODE_LENGTH_ORDER[i]] = v
            if v:
                space -= 32 >> v
                ncodes += 1
                if space <= 0:
                    break
        if not (ncodes == 1 or space == 0):
            _fail()
        clc = _Code(cl, next(s for s, v in enumerate(cl) if v) if ncodes == 1 else None)
        lengths = [0] * size
        sym, prev, repeat, repeat_len, space = 0, 8, 0, 0, 32768
        while sym < size and space > 0:
            c = clc.read(br)
            if c < 16:
                repeat = 0
                if c:
                    lengths[sym] = prev = c
                    space -= 32768 >> c
                sym += 1
                continue
            extra = 2 if c == 16 else 3
            delta_bits = br.read(extra)
            new_len = prev if c == 16 else 0
            if repeat_len != new_len:
                repeat, repeat_len = 0, new_len
            old = repeat
            if repeat > 0:
                repeat = (repeat - 2) << extra
            repeat += delta_bits + 3
            delta = repeat - old
            if sym + delta > size:
                _fail()
            if repeat_len:
                lengths[sym: sym + delta] = [repeat_len] * delta
                space -= delta << (15 - repeat_len)
            sym += delta
        if space != 0:
            _fail()
        self.count("complex code")
        return _Code(lengths)

    def block_length(self, code: _Code) -> int:
        base, extra = BLOCK_LENGTH[code.read(self.br)]
        return base + self.br.read(extra)

    def context_map(self, size: int) -> tuple:
        """(number of trees, the map) of `size` entries."""
        br = self.br
        ntrees = self.varlen8() + 1
        if ntrees < 2:
            return ntrees, [0] * size
        if br.pos + 5 > br.end:  # libbrotlidec peeks five bits here
            _fail("truncated")
        rle = br.read(4) + 1 if br.read(1) else 0
        code = self.code(ntrees + rle)
        cmap, i = [0] * size, 0
        while i < size:
            c = code.read(br)
            if c == 0:
                i += 1
            elif c > rle:
                cmap[i] = c - rle
                i += 1
            else:
                reps = (1 << c) + br.read(c)
                if i + reps > size:
                    _fail()
                i += reps
        if br.read(1):  # inverse move-to-front
            mtf = list(range(256))
            for k, v in enumerate(cmap):
                value = mtf[v]
                cmap[k] = value
                if v:
                    del mtf[v]
                    mtf.insert(0, value)
            self.count("move-to-front")
        self.count("context map")
        return ntrees, cmap

    # --- the stream --------------------------------------------------------------------

    def run(self) -> bytearray:
        br = self.br
        self.max_backward = (1 << self.window_bits()) - WINDOW_GAP
        while True:
            last = br.read(1)
            if last and br.read(1):
                self.count("empty last meta-block")
                break
            nibbles = br.read(2) + 4
            if nibbles == 7:  # a metadata meta-block
                if br.read(1):
                    _fail()
                nbytes, skip = br.read(2), 0
                for i in range(nbytes):
                    b = br.read(8)
                    if i + 1 == nbytes and nbytes > 1 and b == 0:
                        _fail()
                    skip |= b << (8 * i)
                br.align()
                br.take(skip + 1 if nbytes else 0)
                self.count("metadata meta-block")
            else:
                mlen = 0
                for i in range(nibbles):
                    v = br.read(4)
                    if i + 1 == nibbles and nibbles > 4 and v == 0:
                        _fail()
                    mlen |= v << (4 * i)
                mlen += 1
                if not last and br.read(1):
                    br.align()
                    self.out += br.take(mlen)
                    self.count("uncompressed meta-block")
                else:
                    self.compressed(mlen)
                    self.count("compressed meta-block")
            if last:
                break
        br.align()
        if br.pos != br.end:
            _fail(ERRORS[-3])
        return self.out

    def compressed(self, mlen: int) -> None:
        br, out = self.br, self.out
        ntypes, type_codes, len_codes, blen = [1, 1, 1], [None] * 3, [None] * 3, [1 << 24] * 3
        for k in range(3):
            ntypes[k] = self.varlen8() + 1
            if ntypes[k] >= 2:
                type_codes[k] = self.code(ntypes[k] + 2)
                len_codes[k] = self.code(26)
                blen[k] = self.block_length(len_codes[k])
                self.count(f"block types {'LID'[k]}")
        bits = br.read(6)
        npostfix = bits & 3
        ndirect = (bits >> 2) << npostfix
        modes = [br.read(2) for _ in range(ntypes[0])]
        for m in modes:
            self.count(f"context mode {m}")
        nlit, cmap = self.context_map(ntypes[0] << 6)
        ndist, dmap = self.context_map(ntypes[2] << 2)
        lit_codes = [self.code(256) for _ in range(nlit)]
        cmd_codes = [self.code(704) for _ in range(ntypes[1])]
        dsize = 16 + ndirect + (48 << npostfix)
        dist_codes = [self.code(dsize) for _ in range(ndist)]
        # the distance codes' (extra bits, offset) past the 16 short ones
        dist_extra, dist_offset = [0] * dsize, [0] * dsize
        i = 16
        for j in range(ndirect):
            dist_offset[i] = j + 1
            i += 1
        nbits, half = 1, 0
        while i < dsize:
            base = ndirect + ((((2 + half) << nbits) - 4) << npostfix) + 1
            for j in range(1 << npostfix):
                dist_extra[i], dist_offset[i] = nbits, base + j
                i += 1
            nbits += half
            half ^= 1
        btype, ring = [0, 0, 0], [[1, 0], [1, 0], [1, 0]]

        def switch(k: int) -> None:
            code = type_codes[k].read(br)
            blen[k] = self.block_length(len_codes[k])
            r = ring[k]
            t = r[1] + 1 if code == 1 else r[0] if code == 0 else code - 2
            if t >= ntypes[k]:
                t -= ntypes[k]
            r[0], r[1] = r[1], t
            btype[k] = t
            self.count(f"block switch {'LID'[k]}")

        lut = T.CONTEXT_LUT
        remaining = mlen
        lit_slice, lut_base = 0, 512 * modes[0]
        cmd_code = cmd_codes[0]
        dist_slice = 0
        rb = self.rb
        words = dictionary()
        while True:
            if blen[1] == 0:
                switch(1)
                cmd_code = cmd_codes[btype[1]]
            blen[1] -= 1
            start_bits = br.pos
            cmd = cmd_code.read(br)
            cell, low = divmod(cmd, 64)
            ins_base, copy_base = CELLS[cell]
            ins_code, copy_code = ins_base + (low >> 3), copy_base + (low & 7)
            base, extra = INSERT[ins_code]
            insert = base + br.read(extra)
            base, extra = COPY[copy_code]
            copy = base + br.read(extra)
            remaining -= insert
            if remaining < 0:
                _fail()
            for _k in range(insert):
                if blen[0] == 0:
                    switch(0)
                    lit_slice, lut_base = btype[0] << 6, 512 * modes[btype[0]]
                blen[0] -= 1
                n = len(out)
                p1 = out[n - 1] if n else 0
                p2 = out[n - 2] if n > 1 else 0
                ctx = lut[lut_base + p1] | lut[lut_base + 256 + p2]
                out.append(lit_codes[cmap[lit_slice + ctx]].read(br))
            if remaining == 0:
                break
            if cell < 2:  # the last distance, implied
                dcode = 0
                self.count("implicit distance")
            else:
                if blen[2] == 0:
                    switch(2)
                    dist_slice = btype[2] << 2
                blen[2] -= 1
                dctx = copy_code if copy_code < 3 else 3
                dcode = dist_codes[dmap[dist_slice + dctx]].read(br)
            if dcode < 16:
                if dcode < 4:
                    distance = rb[(self.rb_idx - 1 - dcode) & 3]
                else:
                    which, delta = SHORT_DELTA[dcode - 4]
                    distance = rb[(self.rb_idx - 1 - which) & 3] + delta
                    if distance <= 0:
                        _fail()
                self.count("short distance" if dcode else "last distance")
            else:
                distance = dist_offset[dcode] + (br.read(dist_extra[dcode]) << npostfix)
                self.count("direct distance" if dcode < 16 + ndirect else "coded distance")
            max_distance = min(len(out), self.max_backward)
            if distance > max_distance:
                if distance > MAX_DISTANCE or not 4 <= copy <= 24:
                    _fail()
                shift = T.NDBITS[copy]
                address = distance - max_distance - 1
                index, transform = address & ((1 << shift) - 1), address >> shift
                if transform >= len(T.TRANSFORMS):
                    _fail()
                at = T.OFFSETS[copy] + index * copy
                word = _transform(words[at: at + copy], transform)
                if not word and br.pos == start_bits:
                    _fail("a command that reads no bit and writes no byte")
                out += word
                remaining -= len(word)
                self.count(f"dictionary word, transform {transform}")
            else:
                if dcode:
                    rb[self.rb_idx & 3] = distance
                    self.rb_idx += 1
                remaining -= copy
                if remaining < 0:
                    _fail()
                start = len(out) - distance
                if distance >= copy:
                    out += out[start: start + copy]
                else:
                    for k in range(copy):
                        out.append(out[start + k])
            if remaining <= 0:
                if remaining < 0:
                    _fail()
                break


def _upper(buf: bytearray, i: int) -> int:
    """libbrotlicommon's ToUpperCase at buf[i]: the bytes it steps over."""
    c = buf[i]
    if c < 0xC0:
        if 0x61 <= c <= 0x7A:
            buf[i] ^= 32
        return 1
    if c < 0xE0:
        buf[i + 1] ^= 32
        return 2
    buf[i + 2] ^= 5
    return 3


def _transform(word: bytes, index: int) -> bytes:
    """A dictionary word through transform `index` (BrotliTransformDictionaryWord;
    an uppercased multi-byte letter may reach past the word, into what the
    suffix then overwrites)."""
    prefix, kind, suffix = T.TRANSFORMS[index]
    if kind <= 9:
        word = word[: max(len(word) - kind, 0)]
    elif 12 <= kind <= 20:
        word = word[kind - 11:]
    buf = bytearray(word) + bytearray(3)
    n = len(word)
    if kind == 10 and n:
        _upper(buf, 0)
    elif kind == 11:
        i = 0
        while i < n:
            i += _upper(buf, i)
    return prefix + bytes(buf[:n]) + suffix
