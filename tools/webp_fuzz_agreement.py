"""How often the port's WebP reader and PIL agree on corrupt files: seeded
truncations and one to three bit flips of the stored WebPs under 6000 bytes
(figdraw_tpu_torch/reference/images), each decoded by
`utils/imagefile.decode_image` and by PIL's `Image.open(...).convert("RGBA")`.
Agreement is an image equal byte for byte, or an error on both sides; the
counts of each kind are printed, and each disagreement by its seed and
index (`case(seed, index)` rebuilds it). Needs PIL (the CPU host's).

    python tools/webp_fuzz_agreement.py [cases per seed, default 3000] [seeds, default 4]
"""

from __future__ import annotations

import io
import os
import sys
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stored_files() -> dict:
    """{name: bytes} of the stored WebPs under 6000 bytes, by name."""
    sys.path.insert(0, REPO)
    from figdraw_tpu_torch.scenes import IMAGE_FORMATS_DIR

    files = {}
    for name in sorted(os.listdir(IMAGE_FORMATS_DIR)):
        if name.endswith(".webp"):
            with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
                data = fh.read()
            if len(data) < 6000:
                files[name] = data
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
            for _ in range(rng.integers(1, 4)):
                data[rng.integers(0, len(data))] ^= 1 << rng.integers(8)
        yield i, name, bytes(data)


def case(seed: int, index: int) -> tuple:
    """(file name, corrupt bytes) of case `index` of `seed`."""
    for i, name, data in corrupt_cases(stored_files(), seed, index + 1):
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


def main() -> None:
    cases = int(sys.argv[1]) if len(sys.argv) > 1 else 3000
    seeds = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    files = stored_files()
    counts = dict(equal=0, both_raise=0, port_only_raises=0, pil_only_raises=0, differ=0)
    for seed in range(seeds):
        for i, name, data in corrupt_cases(files, seed, cases):
            got, want = port_result(data), pil_result(data)
            if got is None and want is None:
                kind = "both_raise"
            elif got is None:
                kind = "port_only_raises"
            elif want is None:
                kind = "pil_only_raises"
            elif got.shape == want.shape and np.array_equal(got, want):
                kind = "equal"
            else:
                kind = "differ"
            counts[kind] += 1
            if kind not in ("equal", "both_raise"):
                print(f"seed {seed} case {i} ({name}, {len(data)} bytes): {kind}", flush=True)
    total = cases * seeds
    agree = counts["equal"] + counts["both_raise"]
    print(f"{len(files)} files, {total} corrupt cases: {counts}; "
          f"agreeing {agree} ({100.0 * agree / total:.2f}%)")


if __name__ == "__main__":
    main()
