"""The decoders' host libraries (csrc/image_decode.cpp with its fax code
tables csrc/fax_tables.h, csrc/webp_decode.cpp with its tables
csrc/webp_tables.h, csrc/zstd_decode.cpp, and the Brotli decoder of WOFF2
fonts, csrc/brotli_decode.cpp with csrc/brotli_tables.h, and the AV1 intra
decoder of AVIF images, csrc/av1_decode.cpp with csrc/av1_tables.h), built with g++ by
utils.gxx at first use and bound through ctypes. A missing toolchain or a
failed build raises: no decoder falls back to its plain Python twin."""

from __future__ import annotations

import ctypes
import os
import threading

from . import gxx

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SRC = os.path.join(_CSRC, "image_decode.cpp")
_DEPS = (os.path.join(_CSRC, "fax_tables.h"),)
_WEBP_SRC = os.path.join(_CSRC, "webp_decode.cpp")
_WEBP_DEPS = (os.path.join(_CSRC, "webp_tables.h"),)
_ZSTD_SRC = os.path.join(_CSRC, "zstd_decode.cpp")
_BROTLI_SRC = os.path.join(_CSRC, "brotli_decode.cpp")
_BROTLI_DEPS = (os.path.join(_CSRC, "brotli_tables.h"),)
_AV1_SRC = os.path.join(_CSRC, "av1_decode.cpp")
_AV1_DEPS = (os.path.join(_CSRC, "av1_tables.h"),)
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_webp = None
_zstd = None
_brotli = None
_av1 = None

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "fd_jpeg_scan": ([_P, _I64, _I64, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
                     _I64),
    "fd_jpeg_arith_scan": ([_P, _I64, _I64, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I],
                           _I64),
    "fd_jpeg_lossless_scan": ([_P, _I64, _I64, _I, _P, _P, _P, _I, _I, _I, _I, _I], _I64),
    "fd_jpeg_smooth": ([_P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _P], _I),
    "fd_jpeg_idct_islow": ([_P, _I, _I, _P, _P], _I),
    "fd_jpeg_upsample": ([_P, _I, _I, _I, _P, _I, _I, _I, _I, _I], _I),
    "fd_jpeg_color": ([_P, _P, _P, _I64, _P, _I], _I),
    "fd_gif_lzw": ([_P, _I64, _I, _P, _I64], _I64),
    "fd_qoi_decode": ([_P, _I64, _P, _I64], _I64),
    "fd_tiff_packbits": ([_P, _I64, _P, _I64], _I64),
    "fd_tiff_lzw": ([_P, _I64, _P, _I64], _I64),
    "fd_tiff_predict": ([_P, _I64, _I64, _I, _I, _I, _I, _P], _I),
    "fd_tiff_fax": ([_P, _I64, _I, _I, _I, _I, _P, _I64, _P, _I], _I),
}
_WEBP_SIGNATURES = {
    "fd_webp_vp8": ([_P, _I64, _I, _I, _P, _P, _P], _I),
    "fd_webp_upsample": ([_P, _P, _P, _I, _I, _P], _I),
    "fd_webp_vp8l": ([_P, _I64, _I, _I, _I, _P], _I),
    "fd_webp_alpha_unfilter": ([_P, _I, _I, _I, _P], _I),
}
_AV1_SIGNATURES = {
    "fd_av1_tile": ([_P, _I64, _P, _P, _P, _P, _P, _P, _P, _P], _I),
    "fd_av1_deblock": ([_P, _P, _P, _P, _P], _I),
    "fd_av1_cdef": ([_P, _P, _P, _P, _P, _P, _P, _P, _P], _I),
    "fd_av1_lr": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P], _I),
    "fd_av1_to_rgb": ([_P, _I, _P, _P, _I, _P, _I, _I, _I, _P, _P], _I),
    "fd_av1_scale": ([_P, _I, _I, _I, _P, _I, _I, _I, _I], _I),
    "fd_av1_alpha_range": ([_P, _I, _I, _I, _I], _I),
    "fd_av1_unattenuate": ([_P, _I64], _I),
    "fd_av1_film_grain": ([_P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P], _I),
    "fd_av1_cdef_block": ([_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P], _I),
    "fd_av1_wiener": ([_P, _I, _I, _P, _I, _P], _I),
    "fd_av1_sgr": ([_P, _I, _I, _I, _P, _I, _P], _I),
    "fd_av1_predict": ([_P, _P, _P, _I, _P], _I),
    "fd_av1_cfl": ([_P, _I, _I, _I, _I, _P], _I),
    "fd_av1_inv_txfm": ([_P, _I, _I, _I, _I, _P], _I),
    "fd_av1_lf_edge": ([_P, _P, _I], _I),
    "fd_av1_trace": ([_P, _I64], _I64),
}
_ZSTD_SIGNATURES = {"fd_zstd_decompress": ([_P, _I64, _P, _I64], _I64)}
_BROTLI_SIGNATURES = {"fd_brotli_decompress": ([_P, _I64, _P, _P, _I64], _I64)}


def _bind(path: str, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name, (args, res) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def load() -> ctypes.CDLL:
    """The decoders' library, built and bound at first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(gxx.build(_SRC, "figdraw_image_decode", _FLAGS, _DEPS), _SIGNATURES)
        return _lib


def load_webp() -> ctypes.CDLL:
    """The WebP decoder's library, built and bound at first use."""
    global _webp
    with _lock:
        if _webp is None:
            _webp = _bind(gxx.build(_WEBP_SRC, "figdraw_webp_decode", _FLAGS, _WEBP_DEPS),
                          _WEBP_SIGNATURES)
        return _webp


def load_zstd() -> ctypes.CDLL:
    """The Zstandard decoder's library, built and bound at first use."""
    global _zstd
    with _lock:
        if _zstd is None:
            _zstd = _bind(gxx.build(_ZSTD_SRC, "figdraw_zstd_decode", _FLAGS), _ZSTD_SIGNATURES)
        return _zstd


def load_brotli() -> ctypes.CDLL:
    """The Brotli decoder's library, built and bound at first use."""
    global _brotli
    with _lock:
        if _brotli is None:
            _brotli = _bind(gxx.build(_BROTLI_SRC, "figdraw_brotli_decode", _FLAGS, _BROTLI_DEPS),
                            _BROTLI_SIGNATURES)
        return _brotli


def load_av1() -> ctypes.CDLL:
    """The AV1 decoder's library, built and bound at first use."""
    global _av1
    with _lock:
        if _av1 is None:
            # no contraction into FMA: the float YUV -> RGB rounds each
            # operation, as libavif's does
            _av1 = _bind(gxx.build(_AV1_SRC, "figdraw_av1_decode", _FLAGS + ("-ffp-contract=off",),
                                   _AV1_DEPS),
                         _AV1_SIGNATURES)
        return _av1
