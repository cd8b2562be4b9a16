"""The image decoders' host library (csrc/image_decode.cpp), built with g++
by utils.gxx at first use and bound through ctypes. A missing toolchain or
a failed build raises: no decoder falls back to its plain Python twin."""

from __future__ import annotations

import ctypes
import os
import threading

from . import gxx

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "image_decode.cpp")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "fd_jpeg_scan": ([_P, _I64, _I64, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I], _I64),
    "fd_jpeg_idct_islow": ([_P, _I, _I, _P, _P], _I),
    "fd_jpeg_upsample": ([_P, _I, _I, _I, _P, _I, _I, _I, _I, _I], _I),
    "fd_jpeg_color": ([_P, _P, _P, _I64, _P, _I], _I),
    "fd_gif_lzw": ([_P, _I64, _I, _P, _I64], _I64),
    "fd_qoi_decode": ([_P, _I64, _P, _I64], _I64),
    "fd_tiff_packbits": ([_P, _I64, _P, _I64], _I64),
    "fd_tiff_lzw": ([_P, _I64, _P, _I64], _I64),
    "fd_tiff_predict": ([_P, _I64, _I64, _I, _I, _I, _I, _P], _I),
}


def load() -> ctypes.CDLL:
    """The decoders' library, built and bound at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(gxx.build(_SRC, "figdraw_image_decode", _FLAGS))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, res
            _lib = lib
        return _lib
