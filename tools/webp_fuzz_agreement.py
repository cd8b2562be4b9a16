"""How often the port's WebP reader and PIL agree on corrupt files: seeded
truncations and one to three bit flips of the stored WebPs under 6000 bytes
(figdraw_tpu_torch/reference/images), each decoded by
`utils/imagefile.decode_image` and by PIL's `Image.open(...).convert("RGBA")`.
Agreement is an image equal byte for byte, or an error on both sides; the
counts of each kind are printed. Needs PIL (the CPU host's).

    python tools/webp_fuzz_agreement.py [cases per seed, default 3000] [seeds, default 4]
"""

from __future__ import annotations

import io
import os
import sys
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    sys.path.insert(0, REPO)
    from PIL import Image

    from figdraw_tpu_torch.scenes import IMAGE_FORMATS_DIR
    from figdraw_tpu_torch.utils import imagefile

    cases = int(sys.argv[1]) if len(sys.argv) > 1 else 3000
    seeds = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    files = {}
    for name in sorted(os.listdir(IMAGE_FORMATS_DIR)):
        if name.endswith(".webp"):
            with open(os.path.join(IMAGE_FORMATS_DIR, name), "rb") as fh:
                data = fh.read()
            if len(data) < 6000:
                files[name] = data
    names = list(files)
    counts = dict(equal=0, both_raise=0, port_only_raises=0, pil_only_raises=0, differ=0)
    for seed in range(seeds):
        rng = np.random.default_rng(seed)
        for i in range(cases):
            data = bytearray(files[names[i % len(names)]])
            if rng.integers(3) == 0:
                data = data[: rng.integers(0, len(data))]
            else:
                for _ in range(rng.integers(1, 4)):
                    data[rng.integers(0, len(data))] ^= 1 << rng.integers(8)
            try:
                got = imagefile.decode_image(bytes(data))
            except (ValueError, NotImplementedError):
                got = None
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    want = np.asarray(Image.open(io.BytesIO(bytes(data))).convert("RGBA"))
            except Exception:  # noqa: BLE001 - any PIL failure counts as an error
                want = None
            if got is None and want is None:
                counts["both_raise"] += 1
            elif got is None:
                counts["port_only_raises"] += 1
            elif want is None:
                counts["pil_only_raises"] += 1
            elif got.shape == want.shape and np.array_equal(got, want):
                counts["equal"] += 1
            else:
                counts["differ"] += 1
    total = cases * seeds
    agree = counts["equal"] + counts["both_raise"]
    print(f"{len(files)} files, {total} corrupt cases: {counts}; "
          f"agreeing {agree} ({100.0 * agree / total:.2f}%)")


if __name__ == "__main__":
    main()
