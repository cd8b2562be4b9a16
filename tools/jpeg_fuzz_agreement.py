"""How often the port's JPEG reader and PIL agree on corrupt JPEGs: seeded
truncations and one to three bit flips of the stored SOF9, SOF10 and SOF3
files (figdraw_tpu_torch/reference/images, `arith_*.jpg` and
`lossless_*.jpg`), or with --huffman of the stored Huffman-coded baseline
and progressive files (every other `*.jpg` but the arithmetic-coded
`*arith*`), each decoded by `utils/imagefile.decode_image` and by PIL's
`Image.open(...).convert("RGBA")`.
A third of the flips land in the first 400 bytes (the markers before the
entropy-coded data), the rest anywhere. Agreement is an image equal byte for
byte, or an error on both sides; the counts of each kind are printed, and
each disagreement by its seed and index (`case(seed, index)` rebuilds it).
Needs PIL (the CPU host's).

    python tools/jpeg_fuzz_agreement.py [--huffman] [cases per seed, default 1000]
        [seeds, default 3]
"""

from __future__ import annotations

import io
import os
import sys
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _in_set(name: str, huffman: bool) -> bool:
    if name.startswith(("arith_", "lossless_")):
        return not huffman
    return huffman and "arith" not in name


def stored_files(huffman: bool = False) -> dict:
    """{name: bytes} of the stored arithmetic-coded and lossless JPEGs, or
    of the Huffman-coded ones, by name."""
    sys.path.insert(0, REPO)
    from figdraw_tpu_torch.scenes import IMAGE_FORMATS_DIR

    files = {}
    for name in sorted(os.listdir(IMAGE_FORMATS_DIR)):
        if name.endswith(".jpg") and _in_set(name, huffman):
            with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
                files[name] = fh.read()
    return files


def corrupt_cases(files: dict, seed: int, cases: int):
    """Yields (index, file name, corrupt bytes) of one seed's cases: a
    third cut at a random length, the others with one to three bits
    flipped."""
    names = list(files)
    rng = np.random.default_rng(seed)
    for i in range(cases):
        name = names[i % len(names)]
        data = bytearray(files[name])
        if rng.integers(3) == 0:
            data = data[: rng.integers(0, len(data))]
        else:
            head = rng.integers(3) == 0
            for _ in range(rng.integers(1, 4)):
                at = rng.integers(0, min(400, len(data))) if head else rng.integers(0, len(data))
                data[at] ^= 1 << rng.integers(8)
        yield i, name, bytes(data)


def case(seed: int, index: int, huffman: bool = False) -> tuple:
    """(file name, corrupt bytes) of case `index` of `seed`."""
    for i, name, data in corrupt_cases(stored_files(huffman), seed, index + 1):
        if i == index:
            return name, data
    raise IndexError(index)


def port_result(data: bytes):
    """The port's RGBA image of a file, or None where it raises."""
    from figdraw_tpu_torch.utils import imagefile

    try:
        return imagefile.decode_image(data)
    except (ValueError, NotImplementedError):
        return None


def pil_result(data: bytes):
    """PIL's Image.open(...).convert("RGBA") of a file, or None where it
    fails."""
    from PIL import Image

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    except Exception:  # noqa: BLE001 - any PIL failure counts as an error
        return None


def classify(data: bytes) -> str:
    got, want = port_result(data), pil_result(data)
    if got is None and want is None:
        return "both_raise"
    if got is None:
        return "port_only_raises"
    if want is None:
        return "pil_only_raises"
    if got.shape == want.shape and np.array_equal(got, want):
        return "equal"
    return "differ"


def main() -> None:
    args = sys.argv[1:]
    huffman = "--huffman" in args
    args = [a for a in args if a != "--huffman"]
    cases = int(args[0]) if args else 1000
    seeds = int(args[1]) if len(args) > 1 else 3
    files = stored_files(huffman)
    counts = dict(equal=0, both_raise=0, port_only_raises=0, pil_only_raises=0, differ=0)
    for seed in range(seeds):
        for i, name, data in corrupt_cases(files, seed, cases):
            kind = classify(data)
            counts[kind] += 1
            if kind not in ("equal", "both_raise"):
                print(f"seed {seed} case {i} ({name}, {len(data)} bytes): {kind}", flush=True)
    total = cases * seeds
    agree = counts["equal"] + counts["both_raise"]
    print(f"{len(files)} files, {total} corrupt cases: {counts}; "
          f"agreeing {agree} ({100.0 * agree / total:.2f}%)")


if __name__ == "__main__":
    main()
