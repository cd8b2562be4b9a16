"""A stand-in for the `brotli` Python module, for fontTools' WOFF 2.0 reader
and writer on a host without it: libbrotlidec (the one PIL links, in
`PIL/../pillow.libs`) through ctypes for `decompress`, and a `compress`
that writes the data as uncompressed meta-blocks, a valid Brotli stream
that every decoder reads back. Used by tools/make_port_faces.py (which
writes the committed WOFF2 faces through fontTools' WOFF2Writer), the
WOFF2 tests and tools/woff2_fuzz_agreement.py; figdraw_tpu_torch itself
never imports it.

The tests install it per test (monkeypatch `fontTools.ttLib.woff2.brotli`
and `haveBrotli`), never into sys.modules for a whole session:

    monkeypatch.setattr(woff2, "brotli", brotli_shim)
    monkeypatch.setattr(woff2, "haveBrotli", True)

or, outside pytest, `with brotli_shim.installed(): ...`.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import os

MODE_GENERIC, MODE_TEXT, MODE_FONT = 0, 1, 2
WINDOW_BITS = 22
_CHUNK = 1 << 16  # an uncompressed meta-block's bytes (MLEN in four nibbles)


class error(Exception):  # noqa: N801 - the brotli module's name
    """brotli.error."""


_dec = None


def libbrotlidec() -> ctypes.CDLL:
    """PIL's libbrotlidec, libbrotlicommon loaded first with RTLD_GLOBAL."""
    global _dec
    if _dec is None:
        import PIL

        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
        ctypes.CDLL(glob.glob(os.path.join(libs, "libbrotlicommon-*.so*"))[0],
                    mode=ctypes.RTLD_GLOBAL)
        lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libbrotlidec-*.so*"))[0])
        P, S = ctypes.c_void_p, ctypes.c_size_t
        lib.BrotliDecoderCreateInstance.argtypes = [P, P, P]
        lib.BrotliDecoderCreateInstance.restype = P
        lib.BrotliDecoderDestroyInstance.argtypes = [P]
        lib.BrotliDecoderDecompressStream.argtypes = [
            P, ctypes.POINTER(S), ctypes.POINTER(P), ctypes.POINTER(S), ctypes.POINTER(P), P]
        lib.BrotliDecoderDecompressStream.restype = ctypes.c_int
        _dec = lib
    return _dec


def decompress(data: bytes) -> bytes:
    """A whole stream through libbrotlidec's streaming decoder, as the
    brotli module's decompress runs it: the result must be SUCCESS with no
    input left; anything else raises `error`."""
    lib = libbrotlidec()
    state = lib.BrotliDecoderCreateInstance(None, None, None)
    src = ctypes.create_string_buffer(bytes(data), len(data))
    avail_in = ctypes.c_size_t(len(data))
    next_in = ctypes.c_void_p(ctypes.addressof(src))
    chunks = []
    try:
        while True:
            buf = ctypes.create_string_buffer(1 << 16)
            avail_out = ctypes.c_size_t(len(buf))
            next_out = ctypes.c_void_p(ctypes.addressof(buf))
            result = lib.BrotliDecoderDecompressStream(state, ctypes.byref(avail_in),
                                                       ctypes.byref(next_in),
                                                       ctypes.byref(avail_out),
                                                       ctypes.byref(next_out), None)
            chunks.append(buf.raw[: len(buf) - avail_out.value])
            if result != 3:  # BROTLI_DECODER_RESULT_NEEDS_MORE_OUTPUT
                break
    finally:
        lib.BrotliDecoderDestroyInstance(state)
    if result != 1 or avail_in.value:  # BROTLI_DECODER_RESULT_SUCCESS
        raise error("BrotliDecompress failed")
    return b"".join(chunks)


class _Writer:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def bits(self, value: int, n: int) -> None:
        self.acc |= value << self.n
        self.n += n
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def align(self) -> None:
        if self.n:
            self.bits(0, 8 - self.n)


def compress(data: bytes, mode: int = MODE_GENERIC, quality: int = 11, lgwin: int = 22,
             lgblock: int = 0) -> bytes:
    """`data` as a Brotli stream of uncompressed meta-blocks of at most
    64 KiB (window bits 22), ended by an empty last meta-block; mode,
    quality and the sizes are accepted and ignored."""
    w = _Writer()
    w.bits(1, 1)
    w.bits(WINDOW_BITS - 17, 3)
    for at in range(0, len(data), _CHUNK):
        chunk = data[at: at + _CHUNK]
        w.bits(0, 1)  # ISLAST
        w.bits(0, 2)  # MNIBBLES 4
        w.bits(len(chunk) - 1, 16)
        w.bits(1, 1)  # ISUNCOMPRESSED
        w.align()
        w.out += chunk
    w.bits(1, 1)  # ISLAST
    w.bits(1, 1)  # ISLASTEMPTY
    w.align()
    return bytes(w.out)


@contextlib.contextmanager
def installed():
    """fontTools' WOFF2 module reading and writing through this shim for
    the duration of a with block."""
    import sys

    from fontTools.ttLib import woff2

    saved = getattr(woff2, "brotli", None), woff2.haveBrotli
    woff2.brotli, woff2.haveBrotli = sys.modules[__name__], True
    try:
        yield
    finally:
        woff2.brotli, woff2.haveBrotli = saved
