"""Write the stored image files of figdraw_tpu_torch's decoders and their
references, from the repo's PNG fixture (tests/goldens/
render_3d_overlay_gaussian.png, 800x600 RGBA), with PIL on the CPU host:

- `figdraw_tpu_torch/reference/images/`: JPEGs (baseline 4:2:0 at q 90,
  progressive 4:2:2, 4:4:4 with a restart interval of one MCU row,
  grayscale, Adobe CMYK, a 797x599 crop, a 64x48 progressive crop with
  restarts), a GIF with a transparent index, BMPs of each header kind
  (crops: OS/2 core 8-bit, INFO 24-bit, INFO RLE8 and RLE4, INFO 1-bit,
  V2 16-bit 5-6-5 bitfields, V3 32-bit BGRA bitfields, V4 32-bit BI_RGB
  top-down, V5 4-bit), an ICO with a PNG entry and one with a DIB entry,
  and a QOI. The card's machine has no PIL: chip_smoke.py decodes these.
- `figdraw_tpu_torch/reference/image_formats.json`: under "files", each
  file's sha256 and the sha256 and shape of PIL's decode,
  `Image.open(p).convert("RGBA")`; under "sidecar", the sha256 of the
  .flippy sidecar figdraw_tpu's read_image_cached writes for the baseline
  JPEG.
- `reference/example_image_file_jpeg_1x_blocks8.npy` and
  `reference/photo_wall_jpeg_480x270_blocks8.npy`: 8x8 block means of
  figdraw_tpu's frames of the image-file scene and of the photo wall at
  480x270 (12 panels) with the baseline JPEG loaded by its load_image
  (FigRenderer(atlas_size=512, use_pallas=False), tests/torch_reference.py).

The BMP builders (`bmp_bytes`, `rle8`, `rle4`) also serve the tests: PIL
writes only one BMP header kind.

    JAX_PLATFORMS=cpu python tools/make_image_formats.py   (~40 s)
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import struct
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "goldens", "render_3d_overlay_gaussian.png")
OUT_DIR = os.path.join(REPO, "figdraw_tpu_torch", "reference", "images")
DIGESTS = os.path.join(REPO, "figdraw_tpu_torch", "reference", "image_formats.json")
BASELINE = "baseline_420_q90.jpg"


def _pack_rows(pixels: np.ndarray, bits: int) -> np.ndarray:
    """(h, w) indices (bits <= 8), (h, w) uint16 (16) or (h, w, n) bytes to
    (h, stride) rows padded to 4 bytes."""
    h, w = pixels.shape[:2]
    if bits < 8:
        per = 8 // bits
        idx = np.zeros((h, -(-w // per) * per), np.uint8)
        idx[:, :w] = pixels
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        raw = (idx.reshape(h, -1, per) << shifts).sum(axis=2, dtype=np.uint8)
    elif bits == 16:
        raw = pixels.astype("<u2").view(np.uint8).reshape(h, 2 * w)
    else:
        raw = pixels.reshape(h, -1).astype(np.uint8)
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : raw.shape[1]] = raw
    return rows


def bmp_bytes(pixels: np.ndarray, bits: int, header: int = 40, palette=None,
              compression: int = 0, masks=None, top_down: bool = False,
              rle: bytes = None) -> bytes:
    """A BMP file: `pixels` as _pack_rows takes them (ignored when `rle`
    gives the compressed data), a palette of (n, 3) RGB entries, the
    header kind by its size (12, 40, 52, 56, 108, 124), BI_BITFIELDS
    masks (R, G, B[, A])."""
    h, w = pixels.shape[:2]
    if rle is not None:
        data = rle
    else:
        rows = _pack_rows(pixels, bits)
        data = (rows if top_down else rows[::-1]).tobytes()
    pal = b""
    if palette is not None:
        pal_rgb = np.asarray(palette, np.uint8)[:, ::-1]
        if header != 12:
            pal_rgb = np.concatenate([pal_rgb, np.zeros((len(pal_rgb), 1), np.uint8)], 1)
        pal = pal_rgb.tobytes()
    if header == 12:
        head = struct.pack("<IHHHH", 12, w, h, 1, bits)
        extra = b""
    else:
        ncolors = 0 if palette is None else len(palette)
        head = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                           compression, len(data), 2835, 2835, ncolors, 0)
        extra = b""
        if header == 40 and masks is not None:
            extra = struct.pack("<3I", *masks[:3])
        elif header > 40:
            m = tuple(masks or (0, 0, 0, 0)) + (0,) * 4
            head += struct.pack("<4I", *m[:4])[: min(16, header - 40)]
            head += b"\x00" * (header - len(head))
    offset = 14 + len(head) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset)
            + head + extra + pal + data)


def _literal_or_runs(row, pos, n, rle4):
    """RLE bytes of row[pos:pos+n] as an absolute run (n >= 3; RLE4 even n)
    or as encoded runs of one pixel."""
    vals = [int(v) for v in row[pos: pos + n]]
    if n >= 3 and (not rle4 or n % 2 == 0):
        if rle4:
            body = bytes((vals[i] << 4) | vals[i + 1] for i in range(0, n, 2))
        else:
            body = bytes(vals)
        return bytes([0, n]) + body + (b"\x00" if len(body) % 2 else b"")
    return b"".join(bytes([1, (v << 4) | v if rle4 else v]) for v in vals)


def _rle(indices: np.ndarray, rle4: bool) -> bytes:
    """Bottom-up RLE8 / RLE4 rows (runs of up to 255, absolute runs for
    stretches without repeats), end-of-line after each row, end of
    bitmap."""
    out = bytearray()
    for row in indices[::-1]:
        x, w = 0, len(row)
        while x < w:
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 2:
                v = int(row[x])
                out += bytes([run, (v << 4) | v if rle4 else v])
                x += run
                continue
            end = x + 1
            while end < w and end - x < 254 and row[end] != row[end - 1]:
                end += 1
            n = end - x if end == w else end - x - 1
            n = max(n, 1)
            out += _literal_or_runs(row, x, n, rle4)
            x += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def rle8(indices: np.ndarray) -> bytes:
    return _rle(indices, False)


def rle4(indices: np.ndarray) -> bytes:
    return _rle(indices, True)


def _quantized(img, colors: int):
    """PIL's quantisation of an RGB image: (indices, (n, 3) palette)."""
    q = img.quantize(colors)
    pal = np.frombuffer(bytes(q.getpalette()[: 3 * colors]), np.uint8).reshape(-1, 3)
    return np.asarray(q), pal


def image_files() -> dict:
    """name -> bytes of every stored file."""
    from PIL import Image

    src = Image.open(FIXTURE).convert("RGBA")
    rgb = src.convert("RGB")
    files = {}

    def save(name, img, fmt, **kw):
        b = io.BytesIO()
        img.save(b, fmt, **kw)
        files[name] = b.getvalue()

    save(BASELINE, rgb, "JPEG", quality=90, subsampling="4:2:0")
    save("progressive_422.jpg", rgb, "JPEG", quality=90, subsampling="4:2:2",
         progressive=True)
    save("restart_444.jpg", rgb, "JPEG", quality=90, subsampling="4:4:4",
         restart_marker_rows=1)
    save("gray.jpg", rgb.convert("L"), "JPEG", quality=90)
    save("cmyk.jpg", rgb.convert("CMYK"), "JPEG", quality=90)
    save("crop_797x599.jpg", rgb.crop((2, 1, 799, 600)), "JPEG", quality=85)
    save("small_progressive_rst.jpg", rgb.crop((368, 276, 432, 324)), "JPEG", quality=75,
         progressive=True, restart_marker_blocks=2)
    centre = rgb.crop((240, 180, 560, 420))
    q = centre.quantize(64)
    save("transparent.gif", q, "GIF", transparency=int(np.asarray(q)[0, 0]))
    crop = rgb.crop((360, 270, 421, 317))  # 61x47: odd rows, padded strides
    px = np.asarray(crop)
    idx8, pal8 = _quantized(crop, 256)
    idx4, pal4 = _quantized(crop, 16)
    idx1, pal1 = _quantized(crop, 2)
    files["core_8bit.bmp"] = bmp_bytes(idx8, 8, 12, palette=pal8)
    files["info_24bit.bmp"] = bmp_bytes(px[..., ::-1], 24, 40)
    files["info_rle8.bmp"] = bmp_bytes(idx8, 8, 40, palette=pal8, compression=1,
                                       rle=rle8(idx8))
    files["info_rle4.bmp"] = bmp_bytes(idx4, 4, 40, palette=pal4, compression=2,
                                       rle=rle4(idx4))
    files["info_1bit.bmp"] = bmp_bytes(idx1, 1, 40, palette=pal1)
    v565 = ((px[..., 0].astype(np.uint16) >> 3) << 11) | ((px[..., 1].astype(np.uint16) >> 2)
                                                         << 5) | (px[..., 2] >> 3)
    files["v2_565.bmp"] = bmp_bytes(v565, 16, 52, compression=3,
                                    masks=(0xF800, 0x7E0, 0x1F))
    alpha = np.asarray(src.crop((360, 270, 421, 317)))[..., 3:].copy()
    alpha[::3, ::5] = 96
    bgra = np.concatenate([px[..., ::-1], alpha], -1)
    files["v3_bgra.bmp"] = bmp_bytes(bgra, 32, 56, compression=3,
                                     masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    files["v4_32bit_topdown.bmp"] = bmp_bytes(bgra, 32, 108, top_down=True)
    files["v5_4bit.bmp"] = bmp_bytes(idx4, 4, 124, palette=pal4)
    icon = src.crop((336, 236, 464, 364))
    save("png_entry.ico", icon, "ICO", sizes=[(64, 64)])
    save("dib_entry.ico", icon, "ICO", sizes=[(48, 48)], bitmap_format="bmp")
    save("image.qoi", src, "QOI")
    return files


def digests(files: dict) -> dict:
    """Each file's sha256 and PIL's RGBA decode's sha256 and shape."""
    from PIL import Image

    out = {}
    for name, data in sorted(files.items()):
        rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        out[name] = {"sha256": hashlib.sha256(data).hexdigest(),
                     "decoded_sha256": hashlib.sha256(rgba.tobytes()).hexdigest(),
                     "shape": list(rgba.shape)}
    return out


def sidecar_digest() -> str:
    """The sha256 of figdraw_tpu's .flippy sidecar of the baseline JPEG."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_reference import jax_flippy

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, BASELINE)
        shutil.copyfile(os.path.join(OUT_DIR, BASELINE), path)
        jax_flippy().read_image_cached(path)
        with open(path + ".flippy", "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()


def write_frames() -> None:
    """figdraw_tpu's block means of the image-file scene and the photo wall
    from the baseline JPEG."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_reference import block_means, jax_image_file_frame, jax_photo_wall_frame

    from figdraw_tpu_torch.scenes import (
        JPEG_FILE_REFERENCE, JPEG_WALL_REFERENCE, PHOTO_WALL_SMALL,
    )

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, BASELINE)
        shutil.copyfile(os.path.join(OUT_DIR, BASELINE), path)
        np.save(JPEG_FILE_REFERENCE,
                block_means(jax_image_file_frame(path, "1x")).astype(np.float32))
        print(f"wrote {JPEG_FILE_REFERENCE}")
        w, h, n = PHOTO_WALL_SMALL
        np.save(JPEG_WALL_REFERENCE,
                block_means(jax_photo_wall_frame(path, w, h, n)).astype(np.float32))
        print(f"wrote {JPEG_WALL_REFERENCE}")


def main() -> None:
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    files = image_files()
    os.makedirs(OUT_DIR, exist_ok=True)
    for name, data in files.items():
        with open(os.path.join(OUT_DIR, name), "wb") as fh:
            fh.write(data)
    stored = {"files": digests(files), "sidecar": {BASELINE: sidecar_digest()}}
    with open(DIGESTS, "w") as fh:
        json.dump(stored, fh, indent=1)
        fh.write("\n")
    total = sum(len(d) for d in files.values())
    print(f"wrote {len(files)} files ({total} bytes) to {OUT_DIR} and {DIGESTS}")
    write_frames()


if __name__ == "__main__":
    main()
