"""Builds the port's CUDA sources (csrc/) with nvcc into shared libraries
with a plain C interface, which ops/raster.py and ops/mega.py bind with
ctypes.

A library is built at first use into the package's `_build/`, keyed by a
hash of its sources and the flags, under a private name and then renamed,
so concurrent processes may race to build it. Each source builds alone, so
callers can build several at once (one nvcc each).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
# no --use_fast_math: expf in the shadow profile and IEEE sqrt/division
# keep the kernels within rounding of their plain versions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # torch's toolkit lookup

    path = shutil.which("nvcc")
    if path is None and CUDA_HOME is not None:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def build(name: str, sources: tuple) -> tuple:
    """Compile csrc/<sources[0]> (the other sources are headers it
    includes) into BUILD_DIR/lib<name>_<hash>.so, once per source and flag
    hash. Returns (library path, compiler output: ptxas -v's registers,
    shared memory and spills). Raises RuntimeError with nvcc's output when
    the build fails."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(os.path.join(CSRC, src), "rb") as fh:
            digest.update(fh.read())
    path = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    log_path = path + ".log"
    if os.path.exists(path):
        with open(log_path) as fh:
            return path, fh.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, sources[0])],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{sources[0]}:\n"
                               f"{res.stdout}{res.stderr}")
        with open(log_path, "w") as fh:
            fh.write(res.stdout + res.stderr)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, res.stdout + res.stderr
