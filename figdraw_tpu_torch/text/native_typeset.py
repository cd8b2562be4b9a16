"""ctypes bridge to the native typesetter (native/typeset.cpp, shared with
figdraw_tpu and unchanged; figdraw_tpu/text/native_typeset.py, copied).

The library is built at first use with g++ into the package's `_build/`
(utils/gxx.py) with figdraw_tpu's flags: -ffp-contract=off pins the pen
math to Python's unfused float evaluation (round() half-to-even ties), so
the C engine's positions equal text/layout.py's. A missing toolchain or a
failed build raises with the compiler's output; nothing falls back to the
Python typesetter. The engine reads FDTP packs that text/native_pack.py
builds from the port's own typefaces; native/figdraw_typeset.h is the C
hosts' surface, and tests/test_torch_native_typeset.py pins the engine
glyph for glyph against the port's Python pipeline.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils import gxx
from .native_pack import build_font_pack

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_SRC = os.path.join(_NATIVE_DIR, "typeset.cpp")
_HDR = os.path.join(_NATIVE_DIR, "figdraw_typeset.h")
_CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
              "-std=c++17", "-I", _NATIVE_DIR)

E_CAP = -1
E_MARKS = -2
E_REDUCED = -3
E_SCRIPT = -4
E_OFFSETS = -5

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# (typeface_id, variation key) -> (blob, handle); () = default instance
_packs: Dict[Tuple[int, tuple], Tuple[bytes, int]] = {}


class NativeTypesetUnsupported(Exception):
    """The text is outside the native boundary (offset-less API with marks
    or a reduced pack): shape it in Python. Arabic shapes natively since
    FDTP v3; the Indic/Khmer/Myanmar syllable pipelines since v4."""


def build() -> str:
    """Compile typeset.cpp into the package's _build/ (utils.gxx, keyed by
    the source, its header and the flags); returns the library path. Raises
    FileNotFoundError without g++ and CalledProcessError, with the
    compiler's output, when the build fails."""
    return gxx.build(_SRC, "figdraw_typeset", _CXX_FLAGS, deps=(_HDR,))


def _load() -> ctypes.CDLL:
    """The typesetter library, built and bound at first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.fd_pack_load.restype = ctypes.c_void_p
        lib.fd_pack_load.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.fd_pack_free.argtypes = [ctypes.c_void_p]
        lib.fd_pack_metric.restype = ctypes.c_float
        lib.fd_pack_metric.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.fd_pack_flags.restype = ctypes.c_uint32
        lib.fd_pack_flags.argtypes = [ctypes.c_void_p]
        lib.fd_pack_glyph_count.restype = ctypes.c_int32
        lib.fd_pack_glyph_count.argtypes = [ctypes.c_void_p]
        lib.fd_pack_glyph_id.restype = ctypes.c_uint32
        lib.fd_pack_glyph_id.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.fd_pack_advance.restype = ctypes.c_float
        lib.fd_pack_advance.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.fd_pack_set_allow_reduced.argtypes = [
            ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.fd_typeset_shape.restype = ctypes.c_int32
        lib.fd_typeset_shape.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.fd_typeset_shape_ex.restype = ctypes.c_int32
        lib.fd_typeset_shape_ex.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.fd_typeset_line.restype = ctypes.c_int32
        lib.fd_typeset_line.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p,
        ]
        lib.fd_typeset_box.restype = ctypes.c_int32
        lib.fd_typeset_box.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.fd_typeset_box_make.restype = ctypes.c_void_p
        lib.fd_typeset_box_make.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.fd_arr_free.argtypes = [ctypes.c_void_p]
        lib.fd_arr_glyph_count.restype = ctypes.c_int32
        lib.fd_arr_glyph_count.argtypes = [ctypes.c_void_p]
        lib.fd_arr_glyphs.restype = ctypes.c_int32
        lib.fd_arr_glyphs.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.fd_arr_content_size.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.fd_arr_line_count.restype = ctypes.c_int32
        lib.fd_arr_line_count.argtypes = [ctypes.c_void_p]
        lib.fd_arr_line_range.restype = ctypes.c_int32
        lib.fd_arr_line_range.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.fd_arr_glyph_rect.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.fd_arr_cluster_rect.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.fd_arr_source_range.restype = ctypes.c_int32
        lib.fd_arr_source_range.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.fd_arr_glyph_range_for.restype = ctypes.c_int32
        lib.fd_arr_glyph_range_for.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.fd_arr_selection_rects.restype = ctypes.c_int32
        lib.fd_arr_selection_rects.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_int32,
        ]
        lib.fd_arr_caret_positions.restype = ctypes.c_int32
        lib.fd_arr_caret_positions.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.fd_arr_glyph_index_at.restype = ctypes.c_int32
        lib.fd_arr_glyph_index_at.argtypes = [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
        ]
        lib.fd_arr_nearest_source_rune.restype = ctypes.c_int32
        lib.fd_arr_nearest_source_rune.argtypes = [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
        ]
        lib.fd_utf8_to_cps.restype = ctypes.c_int32
        lib.fd_utf8_to_cps.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """True once the library is built and bound; a failed build raises
    (figdraw_tpu's returns False and its callers shape in Python)."""
    _load()
    return True


def _var_key(variations):
    return tuple(sorted((v.tag, float(v.value)) for v in variations)) \
        if variations else ()


def _pack_handle(typeface_id: int, variations=()) -> int:
    lib = _load()
    key = (typeface_id, _var_key(variations))
    with _lock:
        cached = _packs.get(key)
        if cached is not None:
            return cached[1]
    blob = build_font_pack(typeface_id, variations)
    handle = lib.fd_pack_load(blob, len(blob))
    if not handle:
        raise RuntimeError("fd_pack_load rejected the font pack")
    with _lock:
        # two threads can both have built the pack (the build runs outside
        # the lock — it is slow); the first one in wins and the loser's
        # handle is freed instead of leaking
        cached = _packs.get(key)
        if cached is not None:
            lib.fd_pack_free(handle)
            return cached[1]
        # keep the blob alive alongside the handle (the C side copies, but
        # the pair documents ownership and lets tests reuse the bytes)
        _packs[key] = (blob, handle)
    return handle


def pack_blob(typeface_id: int) -> bytes:
    _pack_handle(typeface_id)
    return _packs[(typeface_id, ())][0]


def pack_flags(typeface_id: int) -> int:
    return _load().fd_pack_flags(_pack_handle(typeface_id))


def glyph_id(typeface_id: int, codepoint: int) -> int:
    return _load().fd_pack_glyph_id(_pack_handle(typeface_id), codepoint)


def advance(typeface_id: int, gid: int) -> float:
    return _load().fd_pack_advance(_pack_handle(typeface_id), gid)


def metrics(typeface_id: int) -> Tuple[float, float, float, float]:
    lib = _load()
    h = _pack_handle(typeface_id)
    return tuple(lib.fd_pack_metric(h, i) for i in range(4))


def _cps_array(text) -> np.ndarray:
    if isinstance(text, str):
        return np.array([ord(c) for c in text], dtype=np.uint32)
    return np.asarray(list(text), dtype=np.uint32)


def _retrying_call(name, call, n_cps):
    """Shared grow/retry + error-mapping loop for the fd_typeset_* entry
    points: `call(cap)` allocates cap-sized buffers, invokes the C
    function, and returns (n, a function of n giving the result); doubles cap on E_CAP up to
    1<<24, maps E_MARKS to NativeTypesetUnsupported (the Python-pipeline
    fallback boundary), anything else negative to RuntimeError."""
    cap = max(16, n_cps * 4)
    while True:
        n, build = call(cap)
        if n == E_CAP and cap < 1 << 24:
            cap *= 2
            continue
        if n == E_MARKS:
            raise NativeTypesetUnsupported(
                "the offset-less API cannot place attach-capable marks")
        if n == E_SCRIPT:
            raise NativeTypesetUnsupported(
                "reserved error (not returned since FDTP v4)")
        if n == E_REDUCED:
            raise NativeTypesetUnsupported(
                "pack is reduced vs the Python plan; opt in with "
                "set_allow_reduced")
        if n == E_OFFSETS:
            raise NativeTypesetUnsupported(
                "run has vertical positioning (GPOS cursive dy) the "
                "advance-stream API cannot carry; use shape_ex")
        if n < 0:
            raise RuntimeError(f"{name} failed ({n})")
        return build(n)


def shape(typeface_id: int, text) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """C-engine shaping: (gids u32, advances f32 font units, clusters u32).

    Raises NativeTypesetUnsupported when the run needs mark positioning —
    the caller falls back to the Python pipeline (the documented boundary)."""
    lib = _load()
    h = _pack_handle(typeface_id)
    cps = _cps_array(text)

    def call(cap):
        gids = np.zeros(cap, dtype=np.uint32)
        adv = np.zeros(cap, dtype=np.float32)
        clus = np.zeros(cap, dtype=np.uint32)
        n = lib.fd_typeset_shape(
            h, cps.ctypes.data_as(ctypes.c_void_p), len(cps),
            gids.ctypes.data_as(ctypes.c_void_p),
            adv.ctypes.data_as(ctypes.c_void_p),
            clus.ctypes.data_as(ctypes.c_void_p), cap)
        return n, lambda k: (gids[:k].copy(), adv[:k].copy(),
                             clus[:k].copy())

    return _retrying_call("fd_typeset_shape", call, len(cps))


def shape_ex(typeface_id: int, text, rtl: bool = False, variations=()):
    """Full C-engine shaping with per-glyph offsets: (gids u32, advances
    f32 font units — attached marks carry 0, dx f32, dy f32 — font units
    y-UP, clusters u32). The glyph stream is LOGICAL order; rtl selects the
    RTL mark-offset convention (no pen pullback). `variations` selects an
    instance pack (varied advances, native_pack.build_font_pack)."""
    lib = _load()
    h = _pack_handle(typeface_id, variations)
    cps = _cps_array(text)

    def call(cap):
        gids = np.zeros(cap, dtype=np.uint32)
        adv = np.zeros(cap, dtype=np.float32)
        dx = np.zeros(cap, dtype=np.float32)
        dy = np.zeros(cap, dtype=np.float32)
        clus = np.zeros(cap, dtype=np.uint32)
        n = lib.fd_typeset_shape_ex(
            h, cps.ctypes.data_as(ctypes.c_void_p), len(cps),
            1 if rtl else 0,
            gids.ctypes.data_as(ctypes.c_void_p),
            adv.ctypes.data_as(ctypes.c_void_p),
            dx.ctypes.data_as(ctypes.c_void_p),
            dy.ctypes.data_as(ctypes.c_void_p),
            clus.ctypes.data_as(ctypes.c_void_p), cap)
        return n, lambda k: (gids[:k].copy(), adv[:k].copy(), dx[:k].copy(),
                             dy[:k].copy(), clus[:k].copy())

    return _retrying_call("fd_typeset_shape_ex", call, len(cps))


def set_allow_reduced(typeface_id: int, allow: bool = True) -> None:
    """Opt this typeface's pack into reduced-feature divergence (the
    refuse-by-default boundary of FD_PACK_FEATURES_REDUCED)."""
    lib = _load()
    lib.fd_pack_set_allow_reduced(_pack_handle(typeface_id),
                                  1 if allow else 0)


def typeset_line(typeface_id: int, text, size: float):
    """C-engine single-line placement: (gids, xs px, clusters, baseline)."""
    lib = _load()
    h = _pack_handle(typeface_id)
    cps = _cps_array(text)
    baseline = ctypes.c_float(0.0)

    def call(cap):
        gids = np.zeros(cap, dtype=np.uint32)
        xs = np.zeros(cap, dtype=np.float32)
        clus = np.zeros(cap, dtype=np.uint32)
        n = lib.fd_typeset_line(
            h, cps.ctypes.data_as(ctypes.c_void_p), len(cps),
            ctypes.c_float(size),
            gids.ctypes.data_as(ctypes.c_void_p),
            xs.ctypes.data_as(ctypes.c_void_p),
            clus.ctypes.data_as(ctypes.c_void_p), cap,
            ctypes.byref(baseline))
        return n, lambda k: (gids[:k].copy(), xs[:k].copy(),
                             clus[:k].copy(), baseline.value)

    return _retrying_call("fd_typeset_line", call, len(cps))


def typeset_box(typeface_id: int, text, size: float, *, line_height=0.0,
                bounds=(0.0, 0.0), h_align=0, v_align=0, wrap=True,
                variations=()):
    """C-engine box typeset (layout.py typeset counterpart, single font):
    (gids, xs px, ys px at baselines, clusters, (max_line_w, total_h)).
    `variations` selects an instance pack (varied advances)."""
    lib = _load()
    h = _pack_handle(typeface_id, variations)
    cps = _cps_array(text)
    out_size = (ctypes.c_float * 2)()

    def call(cap):
        gids = np.zeros(cap, dtype=np.uint32)
        xs = np.zeros(cap, dtype=np.float32)
        ys = np.zeros(cap, dtype=np.float32)
        clus = np.zeros(cap, dtype=np.uint32)
        n = lib.fd_typeset_box(
            h, cps.ctypes.data_as(ctypes.c_void_p), len(cps),
            ctypes.c_float(size), ctypes.c_float(line_height),
            ctypes.c_float(bounds[0]), ctypes.c_float(bounds[1]),
            h_align, v_align, 1 if wrap else 0,
            gids.ctypes.data_as(ctypes.c_void_p),
            xs.ctypes.data_as(ctypes.c_void_p),
            ys.ctypes.data_as(ctypes.c_void_p),
            clus.ctypes.data_as(ctypes.c_void_p), cap, out_size)
        return n, lambda k: (gids[:k].copy(), xs[:k].copy(), ys[:k].copy(),
                             clus[:k].copy(), (out_size[0], out_size[1]))

    return _retrying_call("fd_typeset_box", call, len(cps))


def utf8_to_cps(data: bytes) -> np.ndarray:
    lib = _load()
    cap = max(16, len(data) + 1)
    cps = np.zeros(cap, dtype=np.uint32)
    n = lib.fd_utf8_to_cps(data, len(data),
                           cps.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        raise RuntimeError("fd_utf8_to_cps failed")
    return cps[:n].copy()


def load_raw_pack(blob: bytes) -> int:
    """Load an arbitrary blob (malformed-input tests). 0 = rejected."""
    lib = _load()
    return lib.fd_pack_load(blob, len(blob)) or 0


class Arrangement:
    """A retained C arrangement (fd_typeset_box_make) exposing the
    reference's GlyphArrangement query suite — glyph/cluster rects,
    selection bands, caret positions, hit testing — computed entirely in C
    and pinned position-for-position against layout.py
    (tests/test_native_typeset.py)."""

    def __init__(self, typeface_id: int, text, size: float, *,
                 line_height=0.0, bounds=(0.0, 0.0), h_align=0, v_align=0,
                 wrap=True, variations=()):
        self._lib = _load()
        h = _pack_handle(typeface_id, variations)
        cps = _cps_array(text)
        self._h = self._lib.fd_typeset_box_make(
            h, cps.ctypes.data_as(ctypes.c_void_p), len(cps),
            ctypes.c_float(size), ctypes.c_float(line_height),
            ctypes.c_float(bounds[0]), ctypes.c_float(bounds[1]),
            h_align, v_align, 1 if wrap else 0)
        if not self._h:
            raise NativeTypesetUnsupported(
                "fd_typeset_box_make refused this text")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.fd_arr_free(h)
            self._h = None

    def glyph_count(self) -> int:
        return self._lib.fd_arr_glyph_count(self._h)

    def glyphs(self):
        """(gids, xs, ys, clusters) — the draw stream."""
        cap = self.glyph_count()
        gids = np.zeros(cap, dtype=np.uint32)
        xs = np.zeros(cap, dtype=np.float32)
        ys = np.zeros(cap, dtype=np.float32)
        clus = np.zeros(cap, dtype=np.uint32)
        self._lib.fd_arr_glyphs(
            self._h, gids.ctypes.data_as(ctypes.c_void_p),
            xs.ctypes.data_as(ctypes.c_void_p),
            ys.ctypes.data_as(ctypes.c_void_p),
            clus.ctypes.data_as(ctypes.c_void_p), cap)
        return gids, xs, ys, clus

    def content_size(self):
        out = (ctypes.c_float * 2)()
        self._lib.fd_arr_content_size(self._h, out)
        return (out[0], out[1])

    def line_count(self) -> int:
        return self._lib.fd_arr_line_count(self._h)

    def line_range(self, line: int):
        out = (ctypes.c_int32 * 2)()
        if self._lib.fd_arr_line_range(self._h, line, out) < 0:
            raise IndexError(line)
        return (out[0], out[1])

    def glyph_rect(self, i: int):
        out = (ctypes.c_float * 4)()
        self._lib.fd_arr_glyph_rect(self._h, i, out)
        return tuple(out)

    def cluster_rect(self, i: int):
        out = (ctypes.c_float * 4)()
        self._lib.fd_arr_cluster_rect(self._h, i, out)
        return tuple(out)

    def source_range(self, i: int):
        out = (ctypes.c_uint32 * 2)()
        if self._lib.fd_arr_source_range(self._h, i, out) < 0:
            raise IndexError(i)
        return (out[0], out[1])

    def glyph_range_for(self, a: int, b: int):
        """Glyph range covering source runes [a, b] inclusive; (0, -1) when
        empty (layout.py glyph_range_for)."""
        out = (ctypes.c_int32 * 2)()
        self._lib.fd_arr_glyph_range_for(self._h, a, b, out)
        return (out[0], out[1])

    def selection_rects(self, a: int, b: int):
        """Merged visual selection bands for source runes [a, b] inclusive;
        list of (x, y, w, h)."""
        cap = 16
        while True:
            buf = np.zeros(cap * 4, dtype=np.float32)
            n = self._lib.fd_arr_selection_rects(
                self._h, a, b, buf.ctypes.data_as(ctypes.c_void_p), cap)
            if n <= cap:
                return [tuple(buf[k * 4:k * 4 + 4]) for k in range(n)]
            cap = n

    def caret_positions(self, source_rune: int):
        """List of (x, y, h, line_index, glyph_index, affinity) — affinity
        0 leading / 1 trailing / 2 inside."""
        cap = 16
        while True:
            buf = np.zeros(cap * 6, dtype=np.float32)
            n = self._lib.fd_arr_caret_positions(
                self._h, source_rune, buf.ctypes.data_as(ctypes.c_void_p),
                cap)
            if n <= cap:
                return [(buf[k * 6], buf[k * 6 + 1], buf[k * 6 + 2],
                         int(buf[k * 6 + 3]), int(buf[k * 6 + 4]),
                         int(buf[k * 6 + 5])) for k in range(n)]
            cap = n

    def glyph_index_at(self, x: float, y: float) -> int:
        return self._lib.fd_arr_glyph_index_at(
            self._h, ctypes.c_float(x), ctypes.c_float(y))

    def nearest_source_rune(self, x: float, y: float) -> int:
        return self._lib.fd_arr_nearest_source_rune(
            self._h, ctypes.c_float(x), ctypes.c_float(y))
