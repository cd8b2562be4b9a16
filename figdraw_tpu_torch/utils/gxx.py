"""g++ builds of the port's host libraries (the walk, the typesetter, the
Snappy codec, the PNG unfilter) into the package's `_build/`.

A library is keyed by a hash of its source, the headers named beside it, the
flags and the host
(-march=native code is only good on the machine that built it). It is
built under a private name and then renamed, since concurrent test
workers may race to build the same library. A missing toolchain or a
failed build raises: no caller falls back to another path.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build")


def build(src: str, name: str, flags: tuple, deps: tuple = ()) -> str:
    """Compile the C++ file `src` into BUILD_DIR/lib<name>_<hash>.so once
    per source, headers `deps`, flags and host; returns the library path. Raises
    FileNotFoundError without g++ and CalledProcessError, with the
    compiler's output, when the build fails."""
    host = f"{platform.node()} {platform.machine()}"
    digest = hashlib.sha256()
    for path in (src, *deps):
        with open(path, "rb") as fh:
            digest.update(fh.read())
    digest.update(" ".join((*flags, host)).encode())
    path = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *flags, "-o", tmp, src], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path
