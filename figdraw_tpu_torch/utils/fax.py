"""CCITT fax decoding as libtiff 4.7.1 does it for TIFF compressions 2
(Modified Huffman), 3 (T.4, one- or two-dimensional), 4 (T.6) and 32771
(CCITT RLE-W: Modified Huffman with each row word-aligned), the decoder
PIL 12.1.0 reads such a TIFF through: `decode` in C++
(csrc/image_decode.cpp: fd_tiff_fax), `decode_plain` its twin in Python.

The code tables are T.4's (ITU-T T.4, tables 2, 3 and 4): `TERMINATING`,
`MAKE_UP` and `EXTENDED_MAKE_UP` below, from which tools/make_fax_tables.py
writes csrc/fax_tables.h. Both decoders look codes up in tables built
from them as libtiff's mkg3states.c builds TIFFFaxWhiteTable (12 bits),
TIFFFaxBlackTable (13 bits) and TIFFFaxMainTable (7 bits), and follow
libtiff's tif_fax3.c and tif_fax3.h step for step, its leniency included:

- a row whose runs fall short of the width is padded with white; one that
  runs past it loses the runs that cross it and is padded with white too
  ("Line length mismatch"); a bad code word ends the row as a short one,
  and the next row goes on;
- a Modified Huffman row ends on a byte, an RLE-W row on a 16-bit word
  (Fax3DecodeRLE with libtiff's FAXMODE_BYTEALIGN or FAXMODE_WORDALIGN:
  the buffered bits dropped down to a multiple of 16, then, with none
  left, a byte skipped where the read pointer's address is odd: libtiff
  reads the strip in the file's mapping, so the address has the parity of
  the strip's offset in the file plus the bytes read);
- past the end of the data, codes read zero bits up to the width asked
  for while any bit is left. Then a Modified Huffman or RLE-W strip fails; a T.4
  strip that ran out inside the zeros of an EOL is read again from its
  start without EOLs into the rows left ("Try to decode (read) fax Group 3
  data without EOL"), and so are the image's later strips; a T.4 strip
  that runs out inside a two-dimensional row fails; a T.6 strip is kept if
  it finished a row ("don't error on badly-terminated strips");
- an EOL inside a T.6 strip ends it (libtiff takes it for the EOFB);
- a tile never fails: libtiff's TIFFReadEncodedTile takes the decoder's
  -1 for success, so PIL keeps what a broken tile decoded;
- rows a strip never reaches keep the bytes they held: in PIL's strip
  buffer, which it reuses, the previous strip's rows (for the first strip,
  whatever the allocation held; here zeros); a reference line walked past
  its end reads the runs earlier rows left (`new_state` carries them);
- a two-dimensional row that meets the extension code (0000001, whether
  the three bits after it enter uncompressed mode, 0000001111, or not)
  ends there as EXPAND2D's S_Ext ends it: its remaining width one run of
  the current colour, the row cleaned up; libtiff reports "Uncompressed
  data (not supported)" and goes on, reading the bits after the seven of
  the code as the next row's (the one-dimensional tables hold no
  extension code: there it is a bad code word).

Out: each row `row_bytes` bytes, MSB first, a bit 1 where a black run
lies (libtiff's output; the photometric tag says which is dark).
"""

from __future__ import annotations

import numpy as np

from . import image_lib

# T.4 table 2: (run, white code, black code) for the terminating runs 0-63
TERMINATING = (
    (0, "00110101", "0000110111"), (1, "000111", "010"), (2, "0111", "11"),
    (3, "1000", "10"), (4, "1011", "011"), (5, "1100", "0011"), (6, "1110", "0010"),
    (7, "1111", "00011"), (8, "10011", "000101"), (9, "10100", "000100"),
    (10, "00111", "0000100"), (11, "01000", "0000101"), (12, "001000", "0000111"),
    (13, "000011", "00000100"), (14, "110100", "00000111"), (15, "110101", "000011000"),
    (16, "101010", "0000010111"), (17, "101011", "0000011000"),
    (18, "0100111", "0000001000"), (19, "0001100", "00001100111"),
    (20, "0001000", "00001101000"), (21, "0010111", "00001101100"),
    (22, "0000011", "00000110111"), (23, "0000100", "00000101000"),
    (24, "0101000", "00000010111"), (25, "0101011", "00000011000"),
    (26, "0010011", "000011001010"), (27, "0100100", "000011001011"),
    (28, "0011000", "000011001100"), (29, "00000010", "000011001101"),
    (30, "00000011", "000001101000"), (31, "00011010", "000001101001"),
    (32, "00011011", "000001101010"), (33, "00010010", "000001101011"),
    (34, "00010011", "000011010010"), (35, "00010100", "000011010011"),
    (36, "00010101", "000011010100"), (37, "00010110", "000011010101"),
    (38, "00010111", "000011010110"), (39, "00101000", "000011010111"),
    (40, "00101001", "000001101100"), (41, "00101010", "000001101101"),
    (42, "00101011", "000011011010"), (43, "00101100", "000011011011"),
    (44, "00101101", "000001010100"), (45, "00000100", "000001010101"),
    (46, "00000101", "000001010110"), (47, "00001010", "000001010111"),
    (48, "00001011", "000001100100"), (49, "01010010", "000001100101"),
    (50, "01010011", "000001010010"), (51, "01010100", "000001010011"),
    (52, "01010101", "000000100100"), (53, "00100100", "000000110111"),
    (54, "00100101", "000000111000"), (55, "01011000", "000000100111"),
    (56, "01011001", "000000101000"), (57, "01011010", "000001011000"),
    (58, "01011011", "000001011001"), (59, "01001010", "000000101011"),
    (60, "01001011", "000000101100"), (61, "00110010", "000001011010"),
    (62, "00110011", "000001100110"), (63, "00110100", "000001100111"),
)
# T.4 table 3: (run, white code, black code) for the make-up runs 64-1728
MAKE_UP = (
    (64, "11011", "0000001111"), (128, "10010", "000011001000"),
    (192, "010111", "000011001001"), (256, "0110111", "000001011011"),
    (320, "00110110", "000000110011"), (384, "00110111", "000000110100"),
    (448, "01100100", "000000110101"), (512, "01100101", "0000001101100"),
    (576, "01101000", "0000001101101"), (640, "01100111", "0000001001010"),
    (704, "011001100", "0000001001011"), (768, "011001101", "0000001001100"),
    (832, "011010010", "0000001001101"), (896, "011010011", "0000001110010"),
    (960, "011010100", "0000001110011"), (1024, "011010101", "0000001110100"),
    (1088, "011010110", "0000001110101"), (1152, "011010111", "0000001110110"),
    (1216, "011011000", "0000001110111"), (1280, "011011001", "0000001010010"),
    (1344, "011011010", "0000001010011"), (1408, "011011011", "0000001010100"),
    (1472, "010011000", "0000001010101"), (1536, "010011001", "0000001011010"),
    (1600, "010011010", "0000001011011"), (1664, "011000", "0000001100100"),
    (1728, "010011011", "0000001100101"),
)
# T.4 table 4: the make-up runs 1792-2560, one code for both colours
EXTENDED_MAKE_UP = (
    (1792, "00000001000"), (1856, "00000001100"), (1920, "00000001101"),
    (1984, "000000010010"), (2048, "000000010011"), (2112, "000000010100"),
    (2176, "000000010101"), (2240, "000000010110"), (2304, "000000010111"),
    (2368, "000000011100"), (2432, "000000011101"), (2496, "000000011110"),
    (2560, "000000011111"),
)
EOL = "000000000001"
# T.4 two-dimensional codes: (state, code, param); the extension is its
# first 7 bits (0000001xxx), EOL its first 7 (libtiff's EOLV)
MODES = (
    ("pass", "0001", 0), ("horiz", "001", 0), ("v0", "1", 0),
    ("vr", "011", 1), ("vr", "000011", 2), ("vr", "0000011", 3),
    ("vl", "010", 1), ("vl", "000010", 2), ("vl", "0000010", 3),
    ("ext", "0000001", 0), ("eol", "0000000", 0),
)

# libtiff's states (tif_fax3.h)
S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT = 0, 1, 2, 3, 4, 5, 6
S_TERMW, S_TERMB, S_MAKEUPW, S_MAKEUPB, S_MAKEUP, S_EOL = 7, 8, 9, 10, 11, 12
_MODE_STATES = {"pass": S_PASS, "horiz": S_HORIZ, "v0": S_V0, "vr": S_VR, "vl": S_VL,
                "ext": S_EXT, "eol": S_EOL}

# the modes of fd_tiff_fax (the TIFF compression) and its result
MH, T4, T6, RLEW = 2, 3, 4, 32771
T4_2D = 1  # T4Options bit 0; bit 2 (fill bits) needs nothing of a decoder
FAILED = -1
NOEOL = 1  # the state's flag word: T.4 read without EOLs from here on


def nruns(width: int, two_d: bool) -> int:
    """libtiff's run array length: the width plus one, rounded up to 32,
    doubled where a reference line is kept."""
    return (width + 1 + 31) // 32 * 32 * (2 if two_d else 1)


def new_state(width: int, two_d: bool) -> np.ndarray:
    """The state a strip leaves to the next of the same image, as libtiff
    keeps it: a flag word, then the two run arrays (and one spare entry).
    Read on corrupt data only: a reference line walked past its end reads
    what earlier rows left there, and once T.4 data has lost its EOLs the
    later strips are read without them."""
    return np.zeros(2 + 2 * nruns(width, two_d), np.uint32)


def codes() -> dict:
    """{table: [(state, code, param)]} of the white, black and main
    tables, in the order mkg3states.c fills them (a later fill wins)."""
    white = ([(S_MAKEUPW, w, r) for r, w, _b in MAKE_UP]
             + [(S_MAKEUP, c, r) for r, c in EXTENDED_MAKE_UP]
             + [(S_TERMW, w, r) for r, w, _b in TERMINATING] + [(S_EOL, EOL[:11], 0)])
    black = ([(S_MAKEUPB, b, r) for r, _w, b in MAKE_UP]
             + [(S_MAKEUP, c, r) for r, c in EXTENDED_MAKE_UP]
             + [(S_TERMB, b, r) for r, _w, b in TERMINATING] + [(S_EOL, EOL[:11], 0)])
    main = [(_MODE_STATES[s], c, p) for s, c, p in MODES]
    return {"white": white, "black": black, "main": main}


def lookup_table(entries, bits: int) -> list:
    """Index (the next `bits` bits, MSB first) -> (state, width, param);
    the indices no code starts are (S_NULL, 0, 0)."""
    table = [(S_NULL, 0, 0)] * (1 << bits)
    for state, code, param in entries:
        w = len(code)
        base = int(code, 2) << (bits - w)
        for i in range(1 << (bits - w)):
            table[base + i] = (state, w, param)
    return table


_TABLES = None


def _tables():
    global _TABLES
    if _TABLES is None:
        c = codes()
        _TABLES = (lookup_table(c["white"], 12), lookup_table(c["black"], 13),
                   lookup_table(c["main"], 7))
    return _TABLES


def decode(data: bytes, width: int, rows: int, mode: int, t4options: int, out: np.ndarray,
           state: np.ndarray, tile: bool = False, odd: bool = False) -> np.ndarray:
    """A strip or tile of `rows` rows of `width` pixels into `out`
    ((rows, row_bytes) uint8: rows the data never reaches keep what they
    held), in C++; `state` (new_state) carries over to the image's next
    strip; odd: the strip starts at an odd offset in its file (RLE-W's word
    alignment reads it). ValueError where libtiff fails a strip. A tile
    never fails: libtiff's TIFFReadEncodedTile takes the fax decoder's -1
    for success (its TIFFReadEncodedStrip does not), so PIL keeps what the
    tile decoded."""
    if out.dtype != np.uint8 or not out.flags.c_contiguous or out.shape[0] < rows \
            or out.shape[1] * 8 < width or state.dtype != np.uint32 \
            or len(state) != len(new_state(width, _two_d(mode, t4options))):
        raise ValueError("fax decode takes a contiguous uint8 row buffer and its state")
    src = np.frombuffer(data, np.uint8)
    rc = image_lib.load().fd_tiff_fax(src.ctypes.data, len(data), width, rows, mode,
                                      t4options, out.ctypes.data, out.shape[1],
                                      state.ctypes.data, int(odd))
    _check(rc, tile)
    return out


def _two_d(mode: int, t4options: int) -> bool:
    return mode == T6 or (mode == T4 and bool(t4options & T4_2D))


def _check(rc: int, tile: bool) -> None:
    if rc < 0 and not tile:
        raise ValueError("corrupt TIFF fax data: libtiff fails this strip")


def _u32(v: int) -> int:
    return v & 0xFFFFFFFF


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


class _Failed(Exception):
    def __init__(self, rc: int):
        self.rc = rc


class _Eof(Exception):
    """libtiff's jump to a premature-EOF label."""


class _NoEol(Exception):
    """SYNC_EOL ran out of data after an EOL's zeros (noEOLFound)."""


class _Plain:
    """tif_fax3.c's decoder state for one strip: the bit reader (the
    accumulator's valid bits, MSB first), the two run arrays and their
    cursors."""

    def __init__(self, data: bytes, width: int, two_d: bool, state: np.ndarray):
        self.data, self.cp, self.acc, self.avail = data, 0, 0, 0
        self.lastx = width
        self.nruns = nruns(width, two_d)
        self.runs = [int(v) for v in state[1:]]
        self.cur, self.ref = 0, self.nruns  # offsets of curruns and refruns
        if two_d:
            self.runs[self.ref], self.runs[self.ref + 1] = width, 0
        self.eolcnt = 0
        self.noeol = bool(state[0] & NOEOL)

    def save(self, state: np.ndarray) -> None:
        state[0] = NOEOL if self.noeol else 0
        state[1:] = self.runs

    # --- NeedBits8 / NeedBits16, GetBits, ClrBits -------------------------------
    def need(self, n: int) -> None:
        while self.avail < n:
            if self.cp >= len(self.data):
                if self.avail == 0:
                    raise _Eof
                self.acc <<= n - self.avail  # pad with zeros
                self.avail = n
                return
            self.acc = (self.acc << 8) | self.data[self.cp]
            self.cp += 1
            self.avail += 8

    def peek(self, n: int) -> int:
        return (self.acc >> (self.avail - n)) & ((1 << n) - 1)

    def clr(self, n: int) -> None:
        self.avail -= n
        self.acc &= (1 << self.avail) - 1

    def lookup(self, table: list, bits: int) -> tuple:
        self.need(bits)
        ent = table[self.peek(bits)]
        self.clr(ent[1])
        return ent

    def sync_eol(self) -> None:
        """SYNC_EOL: find an EOL (11 zeros), skip zero fill, eat its 1;
        _NoEol where the data ends inside the zeros."""
        if self.noeol:
            return
        if self.eolcnt == 0:
            while True:
                self.need(11)
                if self.peek(11) == 0:
                    break
                self.clr(1)
        while True:
            try:
                self.need(8)
            except _Eof:
                raise _NoEol from None
            if self.peek(8):
                break
            self.clr(8)
        while self.peek(1) == 0:
            self.clr(1)
        self.clr(1)
        self.eolcnt = 0


class _Row:
    """One row's runs being written: thisrun's offset, pa, a0, RunLength."""

    def __init__(self, st: _Plain):
        self.st = st
        self.thisrun = self.pa = st.cur
        self.a0 = 0
        self.run_length = 0

    def setvalue(self, x: int) -> None:
        st = self.st
        if self.pa >= self.thisrun + st.nruns:
            raise _Failed(FAILED)  # "Buffer overflow at line ..."
        st.runs[self.pa] = _u32(self.run_length + x)
        self.pa += 1
        self.a0 = _i32(self.a0 + x)
        self.run_length = 0

    def cleanup(self) -> None:
        """CLEANUP_RUNS: pad a short row with white, cut a long one."""
        runs, lastx = self.st.runs, self.st.lastx
        if self.run_length:
            self.setvalue(0)
        if self.a0 != lastx:
            while self.a0 > lastx and self.pa > self.thisrun:
                self.pa -= 1
                self.a0 = _i32(self.a0 - runs[self.pa])
            if self.a0 < lastx:
                if self.a0 < 0:
                    self.a0 = 0
                if (self.pa - self.thisrun) & 1:
                    self.setvalue(0)
                self.setvalue(lastx - self.a0)
            elif self.a0 > lastx:
                self.setvalue(lastx)
                self.setvalue(0)


def _fill(runs: list, start: int, end: int, lastx: int, row: np.ndarray) -> None:
    """_TIFFFax3fillruns: the runs [start, end) to bits, each cut to the
    row (the cut written back, as the next row's reference reads it)."""
    if (end - start) & 1:
        runs[end] = 0
        end += 1
    x = 0
    bits = np.zeros(lastx, np.uint8)
    for k in range(start, end, 2):
        for j, colour in ((k, 0), (k + 1, 1)):
            run = runs[j]
            if _u32(x + run) > lastx or run > lastx:
                run = runs[j] = _u32(lastx - x)
            if run:
                bits[x: x + run] = colour
                x = _u32(x + run)
    row[:] = 0
    packed = np.packbits(bits)
    row[: len(packed)] = packed


def _expand1d(st: _Plain, r: _Row, white: list, black: list) -> None:
    """EXPAND1D: alternating white and black runs to the width; raises
    _Eof at the premature end (the row cleaned up first)."""
    lastx = st.lastx
    try:
        while True:
            while True:
                state, _w, param = st.lookup(white, 12)
                if state == S_EOL:
                    st.eolcnt = 1
                    r.cleanup()
                    return
                if state == S_TERMW:
                    r.setvalue(param)
                    break
                if state in (S_MAKEUPW, S_MAKEUP):
                    r.a0 = _i32(r.a0 + param)
                    r.run_length += param
                    continue
                r.cleanup()  # unexpected("WhiteTable")
                return
            if r.a0 >= lastx:
                r.cleanup()
                return
            while True:
                state, _w, param = st.lookup(black, 13)
                if state == S_EOL:
                    st.eolcnt = 1
                    r.cleanup()
                    return
                if state == S_TERMB:
                    r.setvalue(param)
                    break
                if state in (S_MAKEUPB, S_MAKEUP):
                    r.a0 = _i32(r.a0 + param)
                    r.run_length += param
                    continue
                r.cleanup()  # unexpected("BlackTable")
                return
            if r.a0 >= lastx:
                r.cleanup()
                return
            if st.runs[r.pa - 1] == 0 and st.runs[r.pa - 2] == 0:
                r.pa -= 2
    except _Eof:
        r.cleanup()  # prematureEOF
        raise


def _horizontal(st: _Plain, r: _Row, first: list, fbits: int, fterm: int, fmake: int,
                second: list, sbits: int, sterm: int, smake: int) -> bool:
    """The two runs of a horizontal mode code; False on a bad code word."""
    for table, bits, term, make in ((first, fbits, fterm, fmake),
                                    (second, sbits, sterm, smake)):
        while True:
            state, _w, param = st.lookup(table, bits)
            if state == term:
                r.setvalue(param)
                break
            if state in (make, S_MAKEUP):
                r.a0 = _i32(r.a0 + param)
                r.run_length += param
                continue
            return False
    return True


def _expand2d(st: _Plain, r: _Row, white: list, black: list, main: list) -> None:
    """EXPAND2D: one row coded against the reference line (refruns);
    raises _Eof at the premature end (the row cleaned up first)."""
    runs, lastx, nruns = st.runs, st.lastx, st.nruns
    ref_end = st.ref + nruns
    pb = st.ref
    b1 = _i32(runs[pb])
    pb += 1

    def check_b1():
        nonlocal b1, pb
        if r.pa != r.thisrun:
            while b1 <= r.a0 and b1 < lastx:
                if pb + 1 >= ref_end:
                    raise _Failed(FAILED)
                b1 = _i32(b1 + runs[pb] + runs[pb + 1])
                pb += 2

    try:
        while r.a0 < lastx:
            if r.pa >= r.thisrun + nruns:
                raise _Failed(FAILED)
            state, _w, param = st.lookup(main, 7)
            if state == S_PASS:
                check_b1()
                if pb + 1 >= ref_end:
                    raise _Failed(FAILED)
                b1 = _i32(b1 + runs[pb])
                pb += 1
                r.run_length = _i32(r.run_length + b1 - r.a0)
                r.a0 = b1
                b1 = _i32(b1 + runs[pb])
                pb += 1
            elif state == S_HORIZ:
                if (r.pa - r.thisrun) & 1:
                    ok = _horizontal(st, r, black, 13, S_TERMB, S_MAKEUPB,
                                     white, 12, S_TERMW, S_MAKEUPW)
                else:
                    ok = _horizontal(st, r, white, 12, S_TERMW, S_MAKEUPW,
                                     black, 13, S_TERMB, S_MAKEUPB)
                if not ok:
                    break  # unexpected("BlackTable" / "WhiteTable")
                check_b1()
            elif state in (S_V0, S_VR):
                check_b1()
                r.setvalue(b1 - r.a0 + (param if state == S_VR else 0))
                if pb >= ref_end:
                    raise _Failed(FAILED)
                b1 = _i32(b1 + runs[pb])
                pb += 1
            elif state == S_VL:
                check_b1()
                if b1 < r.a0 + param:
                    break  # unexpected("VL")
                r.setvalue(b1 - r.a0 - param)
                pb -= 1
                b1 = _i32(b1 - runs[pb])
            elif state == S_EXT:  # extension(a0): reported, the row ended
                runs[r.pa] = _u32(lastx - r.a0)
                r.pa += 1
                break
            elif state == S_EOL:
                runs[r.pa] = _u32(lastx - r.a0)
                r.pa += 1
                st.need(4)
                st.clr(4)  # unexpected("EOL") if not zero
                st.eolcnt = 1
                break
            else:
                break  # unexpected("MainTable")
        else:
            if r.run_length:
                if r.run_length + r.a0 < lastx:
                    st.need(1)
                    if not st.peek(1):
                        r.cleanup()  # badMain2d
                        return
                    st.clr(1)
                r.setvalue(0)
    except _Eof:
        r.cleanup()  # prematureEOF
        raise
    r.cleanup()


def decode_plain(data: bytes, width: int, rows: int, mode: int, t4options: int,
                 out: np.ndarray, state: np.ndarray, tile: bool = False,
                 odd: bool = False) -> np.ndarray:
    """decode in Python."""
    st = _Plain(data, width, _two_d(mode, t4options), state)
    try:
        rc = _decode_rows(st, rows, mode, out, odd)
    finally:
        st.save(state)
    _check(rc, tile)
    return out


def _decode_rows(st: _Plain, rows: int, mode: int, out: np.ndarray, odd: bool) -> int:
    """Fax3DecodeRLE, Fax3Decode1D, Fax3Decode2D or Fax4Decode on one
    strip: the rows decoded, or FAILED."""
    white, black, main = _tables()
    width, two_d = st.lastx, st.nruns != nruns(st.lastx, False)
    line = 0
    try:
        while line < rows:
            r = _Row(st)
            if mode in (MH, RLEW):
                try:
                    _expand1d(st, r, white, black)
                except _Eof:
                    _fill(st.runs, r.thisrun, r.pa, width, out[line])
                    return FAILED
                _fill(st.runs, r.thisrun, r.pa, width, out[line])
                if mode == MH:
                    st.clr(st.avail % 8)  # each row starts on a byte
                else:  # on a word: the bits down to 0 or 16, then an even address
                    st.clr(st.avail % 16)
                    if st.avail == 0 and (st.cp + odd) & 1:
                        st.cp += 1
            elif mode == T4:
                try:
                    st.sync_eol()
                    if two_d:
                        st.need(1)
                        is1d = st.peek(1)
                        st.clr(1)
                except _NoEol:
                    st.noeol = True
                    st.cp = st.acc = st.avail = st.eolcnt = 0
                    continue
                except _Eof:
                    r.cleanup()
                    _fill(st.runs, r.thisrun, r.pa, width, out[line])
                    return FAILED
                try:
                    if not two_d or is1d:
                        _expand1d(st, r, white, black)
                    else:
                        _expand2d(st, r, white, black, main)
                except _Eof:
                    _fill(st.runs, r.thisrun, r.pa, width, out[line])
                    return FAILED
                _fill(st.runs, r.thisrun, r.pa, width, out[line])
                if two_d:
                    if r.pa < r.thisrun + st.nruns:
                        r.setvalue(0)  # the imaginary change for the reference
                    st.cur, st.ref = st.ref, st.cur
            else:
                try:
                    _expand2d(st, r, white, black, main)
                    if st.eolcnt:
                        raise _Eof
                except _Eof:
                    try:
                        st.need(13)
                    except _Eof:
                        pass
                    else:
                        st.clr(13)
                    _fill(st.runs, r.thisrun, r.pa, width, out[line])
                    return line if line else FAILED
                _fill(st.runs, r.thisrun, r.pa, width, out[line])
                r.setvalue(0)  # the imaginary change for the reference
                st.cur, st.ref = st.ref, st.cur
            line += 1
    except _Failed as exc:
        return exc.rc
    return line
