"""How often the port's CCITT fax and ZSTD decoding and PIL agree on corrupt
TIFFs: seeded cuts and bit flips of one strip or tile of the stored fax and
ZSTD files under 50000 bytes (figdraw_tpu_torch/reference/images), and of
the RLE-W ones (`rlew_*.tif`, a fifth as many cases, seeded from 100), each
decoded by `utils/imagefile.decode_image` and by PIL's
`Image.open(...).convert("RGBA")` (libtiff 4.7.1). A cut shortens the
strip's byte count, so the IFD stays whole; a flip changes one to three
bits of the strip. Agreement is an image equal byte for byte, or an error
on both sides; the counts of each kind are printed by codec, with the
files and cases of each disagreement. Needs PIL (the CPU host's).

    python tools/tiff_fuzz_agreement.py [cases per seed, default 1500] [seeds, default 2]

(the fax and ZSTD case `i` of seed `s` is the i-th of `np.random.default_rng(s)`,
as before the RLE-W cases were added)
"""

from __future__ import annotations

import collections
import io
import os
import struct
import sys
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _count_entry(data: bytes, tag: int):
    """(file offset of the value of a classic little- or big-endian TIFF's
    first-IFD entry `tag`, struct code of one value, count)."""
    o = "<" if data[:2] == b"II" else ">"
    (at,) = struct.unpack_from(o + "I", data, 4)
    (n,) = struct.unpack_from(o + "H", data, at)
    for k in range(n):
        pos = at + 2 + 12 * k
        t, ftype, count = struct.unpack_from(o + "HHI", data, pos)
        if t == tag:
            code = o + ("H" if ftype == 3 else "I")
            size = struct.calcsize(code) * count
            where = pos + 8 if size <= 4 else struct.unpack_from(o + "I", data, pos + 8)[0]
            return where, code, count
    raise ValueError(f"no tag {tag}")


def corrupt(data: bytes, rng) -> tuple:
    """(corrupt copy, what was done, the strip or tile's index): one strip
    or tile cut or flipped."""
    from figdraw_tpu_torch.utils import tiff

    order, _big, tags = tiff.read_ifd(data)
    tiled = tiff.TILE_OFFSETS in tags
    offsets = tags[tiff.TILE_OFFSETS if tiled else tiff.STRIP_OFFSETS]
    counts = tags[tiff.TILE_COUNTS if tiled else tiff.STRIP_COUNTS]
    k = int(rng.integers(len(offsets)))
    out = bytearray(data)
    if rng.integers(3) == 0:
        where, code, _n = _count_entry(data, tiff.TILE_COUNTS if tiled else tiff.STRIP_COUNTS)
        cut = int(rng.integers(0, counts[k]))
        struct.pack_into(code, out, where + k * struct.calcsize(code), cut)
        return bytes(out), f"strip {k} cut to {cut} of {counts[k]} bytes", k
    flips = []
    for _ in range(int(rng.integers(1, 4))):
        at = offsets[k] + int(rng.integers(counts[k]))
        bit = int(rng.integers(8))
        out[at] ^= 1 << bit
        flips.append((at, bit))
    return bytes(out), f"strip {k} bits flipped at {flips}", k


def _unreached_rows_only(data: bytes, got: np.ndarray, want: np.ndarray) -> bool:
    """The images differ only in rows of the first strip or tile that the
    port left as it found them (one value across the strip's or tile's
    row): where PIL shows its buffer's uninitialised bytes."""
    from figdraw_tpu_torch.utils import tiff

    order, _big, tags = tiff.read_ifd(data)
    img = tiff.Image(order, tags)
    if got.shape != want.shape:
        return False
    diff = (got != want).any(axis=2)
    rows, cols = np.flatnonzero(diff.any(axis=1)), np.flatnonzero(diff.any(axis=0))
    cw = min(img.cw, img.width)
    return bool(len(rows)) and rows.max() < img.ch and cols.max() < cw and all(
        (got[r, :cw] == got[r, :1]).all() for r in rows)


def _stored(keep) -> dict:
    from figdraw_tpu_torch.scenes import IMAGE_FORMATS_DIR

    files = {}
    for name in sorted(os.listdir(IMAGE_FORMATS_DIR)):
        if name.endswith(".tif") and keep(name):
            with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
                data = fh.read()
            if len(data) < 50000:
                files[name] = data
    return files


def _kind(data: bytes, strip: int) -> str:
    from PIL import Image

    from figdraw_tpu_torch.utils import imagefile

    try:
        got = imagefile.decode_image(data)
    except (ValueError, NotImplementedError) as exc:
        got = type(exc).__name__
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    except Exception:  # noqa: BLE001 - any PIL failure counts as an error
        want = None
    if isinstance(got, str) and want is None:
        return "both_raise"
    if isinstance(got, str):
        return f"port_only_raises ({got})"
    if want is None:
        return "pil_only_raises"
    if got.shape == want.shape and np.array_equal(got, want):
        return "equal"
    if strip == 0 and _unreached_rows_only(data, got, want):
        return "differ in rows the first strip or tile never reached"
    return "differ"


def _run(files: dict, codec_of, seeds: range, cases: int, counts, odd) -> None:
    names = list(files)
    for seed in seeds:
        rng = np.random.default_rng(seed)
        for i in range(cases):
            name = names[i % len(names)]
            data, what, strip = corrupt(files[name], rng)
            kind = _kind(data, strip)
            counts[codec_of(name)][kind] += 1
            if kind not in ("both_raise", "equal"):
                odd.append((kind, name, seed, i, what))


def main() -> None:
    sys.path.insert(0, REPO)
    cases = int(sys.argv[1]) if len(sys.argv) > 1 else 1500
    seeds = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    files = _stored(lambda n: "fax" in n or "g3" in n or "zstd" in n)
    counts = collections.defaultdict(collections.Counter)
    odd = []
    _run(files, lambda n: "zstd" if "zstd" in n else "fax", range(seeds), cases, counts, odd)
    # the RLE-W files, seeded apart (seeds from 100) so that the cases above
    # keep their numbers
    rlew = _stored(lambda n: n.startswith("rlew_"))
    _run(rlew, lambda n: "rlew", range(100, 100 + seeds), cases // 5, counts, odd)
    for codec, c in sorted(counts.items()):
        n = sum(c.values())
        agree = c["equal"] + c["both_raise"]
        print(f"{codec}: {n} corrupt cases: {dict(c)}; agreeing {agree} "
              f"({100.0 * agree / n:.2f}%)")
    print(f"{len(files) + len(rlew)} files, {(cases + cases // 5) * seeds} cases in all")
    for case in odd:
        print("  ", *case)


if __name__ == "__main__":
    main()
