"""Write the constant tables of figdraw_tpu_torch's AV1 intra decoder,
`figdraw_tpu_torch/csrc/av1_tables.h` (C++) and
`figdraw_tpu_torch/utils/av1_tables.py` (numpy), from the libaom 3.6.0
binary of the host (`/usr/lib/x86_64-linux-gnu/libaom.so.3*`); nothing is
downloaded.

The default CDFs are stored in libaom as inverse CDFs (32768 - cdf[i]),
each run of N - 1 values followed by zeros. Each table is found by an
anchor, the inverse values that open its first CDF (the AV1
specification's default tables, section "Default CDF tables"), and read
CDF by CDF from there: N - 1 strictly falling values, then the zeros that
end it. libaom's binary stores a few tables with their unused tails
merged (the filter-intra CDFs of the sizes that may not use filter intra,
the last CfL alpha CDF, whose 16 symbols are read here as the 15 falling
values of its run); those are read as noted beside them. The quantiser
lookups, the default scans, the smooth weights, the directional
derivatives, the filter-intra taps, the 12-bit cosine and sine tables and
the self-guided restoration's parameter sets and divisors are read as
stored (int16, uint8, int8, int32). The remaining small tables (among
them CDEF's directions, taps and divisors and the Wiener and self-guided
coefficient ranges) are the specification's and are written here.

Both outputs carry the sha256 of every table (the C++ values as
little-endian int32), and tests/test_torch_av1.py finds each read table
in the binary again.

    python tools/make_av1_tables.py
"""

from __future__ import annotations

import glob
import hashlib
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY_OUT = os.path.join(REPO, "figdraw_tpu_torch", "utils", "av1_tables.py")
H_OUT = os.path.join(REPO, "figdraw_tpu_torch", "csrc", "av1_tables.h")


def libaom_path() -> str:
    paths = sorted(glob.glob("/usr/lib/x86_64-linux-gnu/libaom.so.3*"))
    return paths[-1] if paths else ""


def _pal_ns():
    return [n for n in range(2, 9) for _ in range(5)]


# name -> (shape of the CDF grid, symbols of each CDF (int or list), anchor
# (the first CDF's cdf values), what it is). The CDFs are written with
# N + 1 slots each: N - 1 inverse values, 0, and the adaptation count.
CDFS = {
    "KF_Y_MODE": ((5, 5), 13, (15588, 17027, 19338, 20218, 20682, 21110), "intra frame y mode [above ctx][left ctx]"),
    "UV_MODE_CFL_NOT_ALLOWED": ((13,), 13, (22631, 24152, 25378, 25661, 25986, 26520), "uv mode when CfL is not allowed [y mode]"),
    "UV_MODE_CFL_ALLOWED": ((13,), 14, None, "uv mode when CfL is allowed [y mode] (follows the above)"),
    "ANGLE_DELTA": ((8,), 7, (2180, 5032, 7567, 22776, 26989, 30217), "angle delta [directional mode - V_PRED]"),
    "PARTITION_W8": ((4,), 4, (19132, 25510, 30392), "partition of an 8x8 block [ctx]"),
    "PARTITION_W16": ((4,), 10, None, "partition of a 16x16 block [ctx]"),
    "PARTITION_W32": ((4,), 10, None, "partition of a 32x32 block [ctx]"),
    "PARTITION_W64": ((4,), 10, None, "partition of a 64x64 block [ctx]"),
    "PARTITION_W128": ((4,), 8, None, "partition of a 128x128 block [ctx]"),
    "SEGMENT_ID": ((3,), 8, (5622, 7893, 16093, 18233, 27809, 28373), "spatial segment id [ctx]"),
    "TX_8X8": ((3,), 2, [(19968,), (19968,), (24320,)], "tx depth, max 8x8 [ctx]"),
    "TX_16X16": ((3,), 3, None, "tx depth, max 16x16 [ctx]"),
    "TX_32X32": ((3,), 3, None, "tx depth, max 32x32 [ctx]"),
    "TX_64X64": ((3,), 3, None, "tx depth, max 64x64 [ctx]"),
    "FILTER_INTRA_MODE": ((), 5, (8949, 12776, 17211, 29558), "filter intra mode"),
    "FILTER_INTRA": ((22,), 2, [(4621,), (6743,), (5893,), (7866,)], "use filter intra [block size]"),
    "SKIP": ((3,), 2, [(31671,), (16515,), (4576,)], "skip [ctx]"),
    "DELTA_Q": ((), 4, (28160, 32120, 32677), "delta q abs"),
    "DELTA_LF": ((), 4, (28160, 32120, 32677), "delta lf abs"),
    "DELTA_LF_MULTI": ((4,), 4, (28160, 32120, 32677), "delta lf abs [lf id]"),
    "INTRA_TX_SET1": ((2, 13), 7, (1535, 8035, 9461, 12751, 23467, 27825), "intra tx type, set INTRA_1 [tx size sqr][intra dir]"),
    "INTRA_TX_SET2": ((3, 13), 5, None, "intra tx type, set INTRA_2 [tx size sqr][intra dir]"),
    "CFL_SIGN": ((), 8, (1418, 2123, 13340, 18405, 26972, 28343), "CfL joint sign"),
    "CFL_ALPHA": ((6,), 16, (7637, 20719, 31401, 32481, 32657, 32688), "CfL alpha [ctx]"),
    "PALETTE_Y_SIZE": ((7,), 7, (7952, 13000, 18149, 21478, 25527, 29241), "palette y size - 2 [bsize ctx]"),
    "PALETTE_UV_SIZE": ((7,), 7, (8713, 19979, 27128, 29609, 31331, 32272), "palette uv size - 2 [bsize ctx]"),
    "PALETTE_Y_COLOR": ((7, 5), _pal_ns(), [(28710,), (16384,), (10553,), (27036,), (31603,)], "palette y color index [size - 2][ctx] (size symbols)"),
    "PALETTE_UV_COLOR": ((7, 5), _pal_ns(), [(29089,), (16384,), (8713,), (29257,), (31610,)], "palette uv color index [size - 2][ctx]"),
    "PALETTE_Y_MODE": ((7, 3), 2, [(31676,), (3419,), (1261,)], "has palette y [bsize ctx][ctx]"),
    "PALETTE_UV_MODE": ((2,), 2, [(32461,), (21488,)], "has palette uv [ctx]"),
    "INTRABC": ((), 2, (30531,), "use intrabc"),
    "TXFM_SPLIT": ((21,), 2, [(28581,), (23846,), (20847,)], "txfm split of an intra block copy [ctx]"),
    "INTER_TX_SET1": ((4,), 16, (4458, 5560, 7695, 9709, 13330), "inter tx type, set INTER_1 [tx size sqr] (4x4 and 8x8 read)"),
    "INTER_TX_SET2": ((4,), 12, None, "inter tx type, set INTER_2 [tx size sqr] (16x16 read)"),
    "INTER_TX_SET3": ((4,), 2, None, "inter tx type, set INTER_3 [tx size sqr]"),
    "MV_JOINT": ((), 4, (4096, 11264, 19328), "mv joint (intra block copy)"),
    "MV_CLASS": ((), 11, None, "mv class (either component)"),
    "MV_SIGN": ((), 2, None, "mv sign"),
    "MV_CLASS0": ((), 2, None, "mv class 0 bit"),
    "MV_BITS": ((10,), 2, None, "mv integer bits [bit]"),
    "TXB_SKIP": ((4, 5, 13), 2, [(31849,), (5892,), (12112,)], "all zero [q ctx][tx size ctx][ctx]"),
    "EOB_PT_16": ((4, 2, 2), 5, (840, 1039, 1980, 4895), "eob pt, 16 coefficients [q ctx][plane type][ctx]"),
    "EOB_PT_32": ((4, 2, 2), 6, (400, 520, 977, 2102, 6542), "eob pt, 32 [q ctx][plane type][ctx]"),
    "EOB_PT_64": ((4, 2, 2), 7, (329, 498, 1101, 1784, 3265, 7758), "eob pt, 64"),
    "EOB_PT_128": ((4, 2, 2), 8, (219, 482, 1140, 2091, 3680, 6028), "eob pt, 128"),
    "EOB_PT_256": ((4, 2, 2), 9, (310, 584, 1887, 3589, 6168, 8611), "eob pt, 256"),
    "EOB_PT_512": ((4, 2, 2), 10, (641, 983, 3707, 5430, 10234, 14958), "eob pt, 512 (ctx 0 is read)"),
    "EOB_PT_1024": ((4, 2, 2), 11, (393, 421, 751, 1623, 3160, 6352), "eob pt, 1024 (ctx 0 is read)"),
    "EOB_EXTRA": ((4, 5, 2, 9), 2, [(16961,), (17223,), (7621,)], "eob extra [q ctx][tx size ctx][plane type][eob pt - 3]"),
    "DC_SIGN": ((4, 2, 3), 2, [(16000,), (13056,), (18816,)], "dc sign [q ctx][plane type][ctx]"),
    "COEFF_BASE_EOB": ((4, 5, 2, 4), 3, (17837, 29055), "coeff base at the eob [q ctx][tx size ctx][plane type][ctx]"),
    "COEFF_BASE": ((4, 5, 2, 42), 4, (4034, 8930, 12727), "coeff base [q ctx][tx size ctx][plane type][ctx]"),
    "COEFF_BR": ((4, 5, 2, 21), 4, (14298, 20718, 24174), "coeff br [q ctx][tx size ctx (max 3)][plane type][ctx]"),
    "RESTORATION_TYPE": ((), 3, (9413, 22581), "switchable restoration type of a unit"),
    "USE_WIENER": ((), 2, (11570,), "use wiener of a unit"),
    "USE_SGRPROJ": ((), 2, (16855,), "use self-guided of a unit"),
}

# tables that follow the one before them in libaom's binary
FOLLOWS = {"UV_MODE_CFL_ALLOWED", "PARTITION_W16", "PARTITION_W32", "PARTITION_W64",
           "PARTITION_W128", "TX_16X16", "TX_32X32", "TX_64X64", "INTRA_TX_SET2",
           "INTER_TX_SET2", "INTER_TX_SET3", "MV_CLASS", "MV_SIGN", "MV_CLASS0", "MV_BITS"}

# the filter-intra CDFs of the sizes that may not use filter intra (32x64 to
# 128x128, 16x64, 64x16) are merged in libaom's binary into the one 16384 of
# 32x64 (index 10); they are never read and are written as copies of it
FILTER_INTRA_UNUSED = (11, 12, 13, 14, 15, 20, 21)

# small tables that libaom's compiler stores as immediates in its code (no
# zero after the values), and the delta tables, whose CDFs are all the one
# found (read once, written to every slot)
UNENDED = {"FILTER_INTRA_MODE", "PALETTE_UV_MODE", "DELTA_Q", "DELTA_LF", "DELTA_LF_MULTI",
           "INTRABC", "RESTORATION_TYPE", "USE_WIENER", "USE_SGRPROJ"}
REPEATED = {"DELTA_LF_MULTI"}
# the restoration CDFs are immediates of one function, 25 bytes apart: the
# second and third are found at their anchor's first match after the first
NEAR_PREVIOUS = {"USE_WIENER", "USE_SGRPROJ"}

# CDFs of libaom's tables that the specification's do not have, skipped
# after the table: INTRA_1 of 16x16 and 32x32 (libaom keeps four sizes),
# and the fractional and high-precision mv CDFs (integer mvs only)
SKIP_AFTER = {"INTRA_TX_SET1": (26, 7), "MV_CLASS": (3, 4), "MV_SIGN": (2, 2)}


def _u16(blob: bytes) -> np.ndarray:
    return np.frombuffer(blob[: len(blob) // 2 * 2], dtype="<u2")


def _find(blob: bytes, values, fmt: str) -> list:
    pat = np.asarray(values, dtype=fmt).tobytes()
    out, i = [], blob.find(pat)
    while i >= 0:
        out.append(i)
        i = blob.find(pat, i + 1)
    return out


class _Reader:
    """CDF by CDF from a byte offset of the binary: skip zeros, then N - 1
    strictly falling inverse values."""

    def __init__(self, blob: bytes, off: int):
        self.a = _u16(blob[off:off + 200000])
        self.i = 0
        self.off = off

    def cdf(self, n: int, monotone: bool = False, ended: bool = True) -> list:
        a = self.a
        while a[self.i] == 0:
            self.i += 1
        vals = []
        while len(vals) < n - 1:
            v = int(a[self.i])
            self.i += 1
            if monotone and vals and v >= vals[-1]:
                continue
            if not (0 < v < 32768) or (vals and v >= vals[-1]):
                raise ValueError(f"not a CDF at byte {self.off + 2 * self.i}")
            vals.append(v)
        if ended and a[self.i] != 0:
            raise ValueError(f"a CDF of {n} symbols runs on at byte {self.off + 2 * self.i}")
        return vals


def _locate(blob: bytes, name: str, nlist: list, anchor, after: int = 0) -> "_Reader":
    """The reader at the first offset from `after` whose CDFs open with the
    anchor: a tuple of the first CDF's leading values, or a list of the
    first CDFs' leading values."""
    rows = anchor if isinstance(anchor, list) else [anchor]
    for off in _find(blob, [32768 - v for v in rows[0]], "<u2"):
        if off < after:
            continue
        try:
            probe = _Reader(blob, off)
            got = [probe.cdf(nlist[k], ended=name not in UNENDED) for k in range(len(rows))]
        except (ValueError, IndexError):
            continue
        if all(tuple(32768 - v for v in want) == tuple(g[:len(want)])
               for want, g in zip(rows, got)):
            return _Reader(blob, off)
    raise ValueError(f"{name}: anchor not found")


def read_cdfs(blob: bytes) -> dict:
    """name -> (int32 array of shape (*grid, N + 1) in inverse form, the
    byte offset where it was found)."""
    out, reader = {}, None
    for name, (grid, ns, anchor, _what) in CDFS.items():
        count = int(np.prod(grid)) if grid else 1
        nlist = ns if isinstance(ns, list) else [ns] * count
        slot = max(nlist) + 1
        if name not in FOLLOWS:
            reader = _locate(blob, name, nlist, anchor,
                             reader.off if name in NEAR_PREVIOUS else 0)
        start = reader.off + 2 * reader.i
        rows = []
        for k, n in enumerate(nlist):
            if (name == "FILTER_INTRA" and k in FILTER_INTRA_UNUSED) or (name in REPEATED and k):
                rows.append(list(rows[10 if name == "FILTER_INTRA" else 0]))
                continue
            rows.append(reader.cdf(n, monotone=name == "CFL_ALPHA", ended=name not in UNENDED))
        for _ in range(SKIP_AFTER.get(name, (0, 0))[0]):
            reader.cdf(SKIP_AFTER[name][1])
        table = np.zeros((count, slot), np.int32)
        for k, vals in enumerate(rows):
            table[k, :len(vals)] = vals
        out[name] = (table.reshape(*grid, slot), start)
    return out


# ------------------------------------------------------ tables as stored ---

def default_scan(w: int, h: int) -> list:
    """The AV1 default scan of a w x h block as raster positions: zig-zag
    for squares (right first), one diagonal direction for rectangles
    (tall: up-right to down-left, wide: the reverse)."""
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(h) if 0 <= d - r < w]  # r rising
        if w == h:
            if d % 2 == 0:
                cells = cells[::-1]
        elif w > h:
            cells = cells[::-1]
        out += [r * w + c for r, c in cells]
    return out


SCAN_SIZES = ((4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16), (16, 8),
              (16, 32), (32, 16), (4, 16), (16, 4), (8, 32), (32, 8))

STORED = {
    # name: (dtype, count, anchor, what)
    "DC_QLOOKUP": ("<i2", 256, (4, 8, 8, 9, 10, 11, 12, 12, 13, 14, 15, 16), "8-bit DC quantiser by q index"),
    "AC_QLOOKUP": ("<i2", 256, (4, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18), "8-bit AC quantiser by q index"),
    "DC_QLOOKUP_10": ("<i2", 256, (4, 9, 10, 13, 15, 17, 20, 22, 25, 28, 31, 34),
                      "10-bit DC quantiser by q index"),
    "AC_QLOOKUP_10": ("<i2", 256, (4, 9, 11, 13, 16, 18, 21, 24, 27, 30, 33, 37),
                      "10-bit AC quantiser by q index"),
    "DC_QLOOKUP_12": ("<i2", 256, (4, 12, 18, 25, 33, 41, 50, 60, 70, 80, 91, 103),
                      "12-bit DC quantiser by q index"),
    "AC_QLOOKUP_12": ("<i2", 256, (4, 13, 19, 27, 35, 44, 54, 64, 75, 87, 99, 112),
                      "12-bit AC quantiser by q index"),
    "SM_WEIGHTS": ("u1", 124, (255, 149, 85, 64, 255, 197, 146, 105), "smooth weights of 4, 8, 16, 32 and 64"),
    "DR_INTRA_DERIVATIVE": ("<i2", 90, (0, 0, 0, 1023, 0, 0, 547), "directional step by angle"),
    "FILTER_INTRA_TAPS": ("i1", 320, (-6, 10, 0, 0, 0, 12, 0, 0), "filter intra taps [mode][8][8] (7 used)"),
    "COS128": ("<i4", 64, (4096, 4095, 4091, 4085), "round(4096 cos(i pi / 128)), i < 64"),
    "SINPI": ("<i4", 5, (0, 1321, 2482, 3344, 3803), "ADST4 sines at 12 bits"),
    "QM_IWT": ("u1", 15 * 2 * 3344, (32, 43, 73, 97, 43, 67, 94, 110, 73, 94, 137, 150),
               "quantiser matrices (inverse weights) [level][plane > 0][3344]: each tx size's "
               "matrix from 4x4 in tx-size order, the 64-point sizes reusing 32"),
    "TX_TYPE_INV": ("<i4", 80, (9,) + (0,) * 15 + (9, 0, 3, 1, 2),
                    "tx type by symbol [set: DCT_IDTX (inter 3), DTT4_IDTX (intra 2), "
                    "DTT4_IDTX_1DDCT (intra 1), DTT9_IDTX_1DDCT (inter 2), ALL16 (inter 1)][16]"),
    "SGR_PARAMS": ("<i4", 64, (2, 1, 140, 3236),
                   "self-guided parameter sets [set][r0, r1, s0, s1] (libaom's av1_sgr_params)"),
    "X_BY_XPLUS1": ("<i4", 256, (1, 128, 171, 192, 205, 213),
                    "self-guided a by z: 256 z / (z + 1) rounded, 1 at 0, 256 at 255"),
    "ONE_BY_X": ("<i4", 25, (4096, 2048, 1365, 1024, 819, 683),
                 "self-guided 1 / n at 12 bits, n = 1 .. 25"),
    "GAUSSIAN_SEQUENCE": ("<i4", 2048, (56, 568, -180, 172, 124, -84, 172, -64, -900, 24, 820, 224),
                          "film grain's Gaussian sequence (12-bit values)"),
}


def read_stored(blob: bytes) -> dict:
    out = {}
    for name, (fmt, count, anchor, _what) in STORED.items():
        offs = _find(blob, anchor, fmt)
        if not offs:
            raise ValueError(f"{name}: anchor not found")
        size = np.dtype(fmt).itemsize
        arr = np.frombuffer(blob[offs[0]:offs[0] + size * count], dtype=fmt).astype(np.int32)
        shape = {"TX_TYPE_INV": (-1, 16), "QM_IWT": (15, 2, 3344),
                 "SGR_PARAMS": (16, 4)}.get(name, (-1,))
        out[name] = (arr.reshape(shape), offs[0])
    for w, h in SCAN_SIZES:
        scan = default_scan(w, h)
        offs = _find(blob, scan, "<i2")
        if not offs:
            raise ValueError(f"default scan {w}x{h} not found")
        out[f"DEFAULT_SCAN_{w}X{h}"] = (np.asarray(scan, np.int32), offs[0])
    return out


# tables only the C++ reads (no twin needs them): written to the header alone
C_ONLY = {"QM_IWT"}

# the specification's small tables, written here
SPEC = {
    "MODE_TO_ANGLE": ([0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0], "nominal angle by intra mode"),
    "INTRA_EDGE_KERNEL": ([0, 4, 8, 4, 0, 0, 5, 6, 5, 0, 2, 4, 4, 4, 2], "edge filter taps [strength - 1][5]"),
    "PALETTE_COLOR_CONTEXT": ([-1, -1, 0, -1, -1, 4, 3, 2, 1], "palette colour context by hash"),
    "PALETTE_COLOR_HASH_MULTIPLIERS": ([1, 2, 2], "palette colour hash multipliers"),
    "INTRA_MODE_CONTEXT": ([0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0], "y mode context by neighbour mode"),
    "CDEF_DIRECTIONS": ([-1, 1, -2, 2, 0, 1, -1, 2, 0, 1, 0, 2, 0, 1, 1, 2,
                         1, 1, 2, 2, 1, 0, 2, 1, 1, 0, 2, 0, 1, 0, 2, -1],
                        "CDEF tap offsets [direction][k][dy, dx]"),
    "CDEF_UV_DIR": ([0, 1, 2, 3, 4, 5, 6, 7, 1, 2, 2, 2, 3, 4, 6, 0,
                     7, 0, 2, 4, 5, 6, 6, 6, 0, 1, 2, 3, 4, 5, 6, 7],
                    "CDEF chroma direction [ss_x][ss_y][luma direction]"),
    "CDEF_PRI_TAPS": ([4, 2, 3, 3], "CDEF primary taps [strength & 1][k]"),
    "CDEF_SEC_TAPS": ([2, 1, 2, 1], "CDEF secondary taps [strength & 1][k]"),
    "CDEF_DIV_TABLE": ([0, 840, 420, 280, 210, 168, 140, 120, 105], "CDEF direction cost divisors"),
    "WIENER_TAPS_MIN": ([-5, -23, -17], "Wiener taps 0-2, least"),
    "WIENER_TAPS_MAX": ([10, 8, 46], "Wiener taps 0-2, most"),
    "WIENER_TAPS_MID": ([3, -7, 15], "Wiener taps 0-2, the reference at a tile's start"),
    "WIENER_TAPS_K": ([1, 2, 3], "Wiener taps 0-2, subexponential k"),
    "SGRPROJ_XQD_MIN": ([-96, -32], "self-guided projection weights, least"),
    "SGRPROJ_XQD_MAX": ([31, 95], "self-guided projection weights, most"),
    "SGRPROJ_XQD_MID": ([-32, 31], "self-guided projection weights, the reference at a tile's start"),
}

SPEC_SHAPES = {"CDEF_DIRECTIONS": (8, 2, 2), "CDEF_UV_DIR": (2, 2, 8), "CDEF_PRI_TAPS": (2, 2),
               "CDEF_SEC_TAPS": (2, 2)}


# ----------------------------------------------------------------- write ---

def digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr, dtype="<i4").tobytes()).hexdigest()


def read_tables(path: str = "") -> dict:
    """name -> (int32 array, byte offset in libaom or -1, what)."""
    with open(path or libaom_path(), "rb") as fh:
        blob = fh.read()
    out = {}
    for name, (arr, off) in read_cdfs(blob).items():
        out[name] = (arr, off, CDFS[name][3])
    for name, (arr, off) in read_stored(blob).items():
        what = STORED[name][3] if name in STORED else "default scan (raster positions)"
        out[name] = (arr, off, what)
    for name, (vals, what) in SPEC.items():
        out[name] = (np.asarray(vals, np.int32).reshape(SPEC_SHAPES.get(name, (-1,))), -1, what)
    return out


def _c_array(name: str, arr: np.ndarray, ctype: str) -> str:
    dims = "".join(f"[{d}]" for d in arr.shape)
    flat = arr.reshape(-1).tolist()
    step = 16
    body = ",\n".join("    " + ", ".join(str(v) for v in flat[i:i + step])
                      for i in range(0, len(flat), step))
    return f"static const {ctype} {name}{dims} = {{\n{body}\n}};\n"


def write(tables: dict) -> None:
    h = ["// The constant tables of the AV1 intra decoder (csrc/av1_decode.cpp),",
         "// read from libaom 3.6.0's binary or written from the AV1 specification",
         "// by tools/make_av1_tables.py. Written by the tool: do not edit.",
         "// CDFs are inverse (32768 - cdf), N + 1 slots each: N - 1 values, 0, count.",
         "#pragma once", "#include <cstdint>", ""]
    py = ['"""The constant tables of the AV1 intra decoder (utils/av1.py,',
          "csrc/av1_decode.cpp), read from libaom 3.6.0's binary or written from the",
          "AV1 specification by tools/make_av1_tables.py; the CDFs and the quantiser",
          'matrices are only in csrc/av1_tables.h. Written by the tool: do not edit."""', "",
          "import numpy as np", "", "# name -> sha256 of the table as little-endian int32",
          "SHA256 = {"]
    for name, (arr, off, what) in tables.items():
        where = f"libaom byte {off}" if off >= 0 else "AV1 specification"
        ctype = "uint16_t" if name in CDFS else ("uint8_t" if name == "QM_IWT" else
                                                  "int8_t" if name == "FILTER_INTRA_TAPS" else
                                                  "int32_t" if name in ("COS128", "TX_TYPE_INV",
                                                                        "SGR_PARAMS", "X_BY_XPLUS1",
                                                                        "ONE_BY_X")
                                                  else "int16_t")
        if name.startswith("DEFAULT_SCAN"):
            ctype = "int16_t"
        h.append(f"// {what} ({where}, sha256 {digest(arr)[:16]})")
        h.append(_c_array(name, arr, ctype))
        py.append(f'    "{name}": "{digest(arr)}",')
    py.append("}")
    py.append("")
    for name, (arr, off, what) in tables.items():
        if name in CDFS or name in C_ONLY:
            continue
        where = f"libaom byte {off}" if off >= 0 else "AV1 specification"
        py.append(f"# {what} ({where})")
        py.append(f"{name} = np.array({arr.reshape(-1).tolist()}, np.int32)"
                  + (f".reshape({arr.shape})" if arr.ndim > 1 else ""))
        py.append("")
    with open(H_OUT, "w") as fh:
        fh.write("\n".join(h))
    with open(PY_OUT, "w") as fh:
        fh.write("\n".join(py))


if __name__ == "__main__":
    write(read_tables())
    print(H_OUT, PY_OUT)
