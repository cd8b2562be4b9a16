#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (figdraw_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the native walk (g++) and the CUDA kernels (nvcc, one process per
source, all at once) from the checkout. These paths run through
FigRenderer(device="cuda").render_frame or execute_plan:

- the 1080p 300-box headline scene (bench.py): the tile rasterizer K1,
  held against its plain torch version on the headline tape and on a scene
  of every SDF mode;
- the clip-mask table of bench_clipmask.py (1200x800, 180 rows x 6 cells):
  the rect-mask table on the frame executor (K1 twice and the mask-plane
  pass K3 once per frame) and the sub-clip table on the megakernel (K4 once
  per frame), each kernel held against its plain version on the frame's
  own inputs, and the megakernel also on a seeded tape that drives every
  clamp of its walk;
- images: bench_images.py's four variants at 1920x1080 with 400 panels,
  the photo published mipmapped on an image bus (K1-atlas once per frame,
  K1 for the SDF control);
- text: bench_text.py's frame (1200x800, 36 lines) from the plan and
  atlas figdraw_tpu built and stored, through execute_plan (K1-atlas once
  per frame): the baseline of the text-host phase below;
- clipped cards: the images_clipped cards at 1920x1080 with 400 panels
  (1201 pass items) through render_frame, which sends them to the
  megakernel with the atlas (K4-atlas once per frame);
- text table: a stored tape of text in clipped cells (1200x800, 180 rows x
  6 cells, `reference/textclip_1200x800.npz`) planned by the port and run
  through execute_plan (K4-atlas once per frame);
- the text host pipeline (text_host_phase), from the DejaVuSans.ttf in
  the checkout (sha256 checked) with the port's own OpenType reader,
  shaper, typesetter and glyph raster, no fontTools, no PIL, no stored
  plan: bench_text's scene typeset and rasterized by the port through
  render_frame (K1-atlas once per frame; its combo and atlas equal the
  stored plan's byte for byte), the text table walked and planned by the
  port (its tape the stored one's byte for byte but the sign of zero, then
  K4-atlas once per frame), and a text table tree through the Python walk
  at 1x, pixel_scale=2 and UI scale 2 (its combo the native walk's byte
  for byte); with the face load, typesetting cold and warm, the cold
  glyph raster and the warm frame's parts timed on the card's host;
- rolled: the same clipped cards through execute_plan on the rolled form
  of the frame executor (plan.plan_rolled: per card K3 into the mask plane
  and K1-atlas into the frame), the route these frames took before the
  megakernel had its atlas form; both atlas scenes run both routes in
  turns;
- device-resident scenes, through snapshot_scene, render_view, render_views
  and update_scene at 1920x1080 with 300 and 12000 boxes: bench_camera.py's
  pan and flythrough loops, bench_sceneanim.py's per-root affine table a
  frame and bench_retained.py's 8 edited roots a frame (damage-clipped and
  in full), each beside its render_frame loop; every view launches the row
  kernel (csrc/rows.cu) once, held against its plain version on each
  loop's own rows (equal 32-bit words), and the headline's frames launch
  the blur kernel (csrc/blur.cu) once a pass, held against the plain blur
  on the headline's planes and on seeded planes at other radii;
- tree-form scenes (Fig nodes in a Renders) through render_frame and the
  Python walk: bench.py's headline as a tree (1920x1080, 300 boxes, each
  frame its own animated tree), bench_clipmask's rect-mask and sub-clip
  tables as trees (1200x800, 180x6; from_renders of each equals the array
  form's rows) and the scenes of examples/layers_clip.py (900x560),
  drawable_beziers.py (760x560) and dashed_dotted_borders.py (820x560),
  each also at pixel_scale=2 and at UI scale 2 into a frame of twice the
  size, held to figdraw_tpu's stored block means; on each, the Python
  walk of to_renders(from_renders(tree)) gives the native walk's packed
  combo byte for byte and its frame bit for bit, each kernel of the frame
  is held against its plain version on the frame's own inputs, and the
  Python walk's and the planner's host time stand beside the native
  walk's;
- the frame loop's entry points: render_batch on bench_anim.py's run (the
  headline scene at 1920x1080 and 640x360, 48 frames in groups of 8,
  against its render_frame loop) and as mega, mega-with-atlas and rolled
  groups (the sub-clip table, images_clipped, the blurred cards), with an
  update_image between two groups; render_frame_async on 48 headline
  frames against the synchronous loop, with the device's idle share in a
  torch.profiler window of each; render_frame_with_overlays on
  examples/overlay_3d.py's scene and pyramid (420x300, six frames) against
  stored JAX block means; and the blurred cards (400 clipped photo cards at
  1920x1080 under a backdrop blur and a frosted panel, 80 more above it,
  1443 pass items), which the planner sends to the rolled executor through
  render_frame, with the walk, the plan and the upload + executor split.
  Every batched and async frame equals render_frame's bit for bit; each
  path is counted with the counts set to 0 just before it, and one frame of
  each has its kernels held against their plain versions on its own
  inputs (a batch group's on its slice of the group's one upload, an async
  frame's as the worker ran it);
- images from files and generated SDFs (image_files_phase): the Snappy
  library (native/snappy.cpp, g++) and the PNG unfilter
  (figdraw_tpu_torch/csrc/png_unfilter.cpp, g++); load_image of a copy of
  the repo's PNG fixture (800x600) cold, through the .flippy sidecar it
  writes, and warm, against the stored sha256 of PIL's decode and of
  figdraw_tpu's sidecar; the image-file scene (examples/image_renderlist.py),
  the MSDF star (examples/msdf_star.py, its SDF made by utils/sdfgen.py)
  and an MTSDF scene in each form through render_frame (K1-atlas), the SDF
  image modes 13-16 counted where they reach K1-atlas and, beside the main
  path, K4-atlas; and a 1080p photo wall of the loaded image (48 panels,
  12 clipped: the megakernel with the atlas), with the host times of the
  pipeline's steps and render_frame's perf span means; the stored files
  of the JPEG, GIF, BMP, ICO, QOI, TIFF (with CCITT fax and ZSTD) and
  WebP decoders (csrc/image_decode.cpp, csrc/webp_decode.cpp,
  csrc/zstd_decode.cpp, g++) and of the AVIF decoder (csrc/av1_decode.cpp:
  8-bit files, three made 10- and 12-bit, two grid images: the fixture
  with an alpha grid and a 12 MP photo, and two with film grain, one
  10-bit, drawn in the image-file scene and the photo wall) against PIL's stored
  digests, their C++ stages against the plain twins, and the baseline
  JPEG, the fixture's
  LZW + Predictor 2 TIFF, its lossy WebP at q 90 and its ZSTD + Predictor
  2 TIFF loaded cold and warm, each drawn in the image-file scene
  (K1-atlas) and the photo wall (K4-atlas) within 1e-5 of figdraw_tpu's
  stored block means, the fixture dithered to a Group 3 fax drawn in the
  image-file scene, a 1728x1143 Group 4 fax page loaded cold and warm and
  drawn in the photo wall, and the fixture's lossless WebP and ZSTD tiles
  equal to the PNG;
- the C ABI for external hosts (capi_phase, lines `check 14`): the
  headline scene fed row by row through the scene-building calls
  fd_renders_* (capi_scene), walked by fd_flatten_renders and exported by
  native.export_tape into FigRenderer.execute (its tape flatten's byte for
  byte, its frame render_frame's bit for bit, K1 2, the blur 2 and the
  front end 1 a frame); bench_text's scene through fd_renders_add_text
  (K1-atlas) beside the C typesetter (native/typeset.cpp, built with g++)
  on its 36 strings, glyph for glyph with the Python typesetter, from the
  FDTP pack of the bundled DejaVuSans (sha256 pinned by the CPU test);
  bench_retained's 12000 boxes through the C retained recipe
  (fd_flatten_renders_spans, fd_renders_set_fig, fd_flatten_renders_root),
  each patched tape a full re-flatten's byte for byte; and the C examples
  native/examples/{scene,shim,typeset}_demo.c built with gcc against the
  port's libraries and run;
- WOFF and VARC faces (woff_varc_phase, lines `check 17`, after the CFF
  and variable faces of fonts_phase, lines `check 15`): FigPortSans-VF.woff
  (inflated by text/woff.py) and FigPortSans-VARC.ttf (variable composites,
  text/varc.py) against reference/fonts.json: every glyph's outline and
  advance digests at 7 locations, bench_text from each through
  render_frame (K1-atlas; the VARC face's accented lines), the VARC face's
  text table on the megakernel with the atlas (K4-atlas), each kernel
  within 1e-5 of its plain version, the WOFF face's instance pack, and the
  face load, a VARC glyph's outline, the cold glyph and warm ms/frame
  beside FigPort Sans VF's;
- WOFF 2.0 faces (woff2_phase, lines `check 18`, after the WOFF and VARC
  faces): DejaVuSans.woff2 (the face as the web serves it, glyf and loca
  transformed), FigPortSans-VF.woff2 (glyf, loca and hmtx transformed) and
  FigPortSans-CFF.woff2, rebuilt by text/woff2.py through the port's own
  Brotli decoder (csrc/brotli_decode.cpp, g++): every glyph's outline and
  advance digests at 7 locations against reference/fonts.json, the C++
  decoder against the stored size and sha256 of each face's stream and
  against its plain twin, bench_text from each through render_frame
  (K1-atlas) and the VF face's text table on the megakernel with the atlas
  (K4-atlas), each kernel within 1e-5 of its plain version and the frames
  within 1/255 of figdraw_tpu's, and the Brotli decode, the WOFF2
  rebuild and the face load cold and warm beside each TTF or OTF twin's;
- rendering across several devices (sharded_phase, lines `check 16`), on
  meshes of [cuda:0] * n (one card runs every band): ShardedFigRenderer on
  the headline in 4 bands of 272 rows (the banded blur X6 on its swap path)
  and 24 of 48 (its gather path; on each X6 bit for bit with its plain
  version at the frame's radius, at r = 17.3 and through the route of bands
  on several cards, in 2 launches a blur item, copying nothing), the clip
  tables in 2 bands of 400 (K4 and
  K3 at a band origin), bench_text's scene in 4 (K1-atlas, glyph runs
  across the boundaries), the clipped cards in 4 (K4-atlas), a
  device-resident 12000-box grid in 4 (render_view, render_views, a patch
  and the damage-clipped view) and render_batch / render_views over a
  frames mesh of [cuda:0] * 2; every frame against the one-device one,
  each band-origin kernel and its front end against their plain versions
  at a non-zero origin, and ms/frame on 1, 2 and 4 bands beside
  render_frame.

Every path bins its tape once a frame through the binning kernel
(csrc/binning.cu), which each phase holds against its plain version on
the executor's own binning call of one frame: whole (T, N) lists and
counts equal, leaving out only the quads whose within-run stack lies
within rounding of the saturation threshold (counted and printed;
expected 0).

`python3 chip_smoke.py turns` only times the headline frame, the rect-mask
table's frame and a 12000-box camera view, each with its executor and its
binning, and the blur alone on seeded planes of the headline's size and
radius, through entry points that every commit since the device-resident
scenes has. It is how two commits are compared in turns: unpack the other
commit beside this one, copy this script into it, and run the command in
each checkout alternately, one process after the other on the same card,
so both see the same card and power limit. `python3 chip_smoke.py
band_turns` does the same for the sharded headline: ms/frame through
render_frame and on 1, 2 and 4 bands of one card (band_times); `python3
chip_smoke.py x6_turns` times the banded blur X6 alone on both its paths
(CUDA events, its whole device time by torch.profiler, its launches) and
X1 beside it, then band_times.

It checks the frames and the launch counts of each path, holds reduced
frames against stored block means of the JAX package's frames, and prints
times beside the card's name and power limit. The tile kernels work in
place, so each comparison hands the plain version the target as it was
before the kernel ran; their bounds are printed in place (the kernels'
own) and out of place (as earlier runs counted them), with the quad-block
pairs (for the megakernel: list entries, clear sentinels included) the
kernels' bbox cull keeps; each kernel's time is taken twice, by CUDA events
around its wrapper call and, for the kernel alone, by torch.profiler; the rolled path's launches are timed
on the device by torch.profiler and a CUDA graph replay, and on the host
around the wrapper calls. The line before the card line lists each kernel
with its launches, error, time and bound; the last line is the run's
summary JSON; any failure exits non-zero before them.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

WIDTH, HEIGHT, COPIES = 1920, 1080, 100
FRAMES = 20
TOL = 1.0 / 255.0  # kernel vs plain version, and port vs the JAX reference
# figdraw_tpu's renders as 8x8 block means: the 384x216 headline scene,
# frame 0 (tests/test_torch_render_frame.py pins it against the JAX
# package), and the 12x6 clip tables at 320x200 (tests/test_torch_masks.py
# and test_torch_mega.py pin those)
REPO = os.path.dirname(os.path.abspath(__file__))
REF_DIR = os.path.join(REPO, "figdraw_tpu_torch", "reference")
REF_BLOCKS = os.path.join(REF_DIR, "headline_384x216_f0_blocks8.npy")
# bench_clipmask.py's table
TABLE_W, TABLE_H, TABLE_ROWS, TABLE_COLS = 1200, 800, 180, 6
# bench_images.py's frame (and the clipped cards'), and the reduced one of
# the stored references
IMAGE_W, IMAGE_H, IMAGE_PANELS = 1920, 1080, 400
SMALL_W, SMALL_H, SMALL_PANELS = 480, 270, 25
BENCH_VARIANTS = ("sdf_control", "images_11", "images_scaled", "images_mixed")

# roofline of one H100 SXM (NVIDIA's data sheet, 700 W): HBM bytes/s and
# FP32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations of one pixel evaluation of a quad in csrc/sdf.cuh, by base
# mode, counted from the code (each add, multiply, compare, min/max,
# select, abs, floor, convert, sqrt, exp, log, sin, cos or divide one; the
# blend into the four planes and the mask multiply included); modifiers
# for elliptical corners, gradient fills and rect masks. Only pixels whose
# centers lie in the quad's bbox need one. Counted, not measured.
OPS_BY_MODE = {0: 130, 3: 75, 7: 85, 8: 85, 9: 103, 11: 80, 12: 80, 13: 165,
               14: 165, 15: 165, 16: 165, 17: 79, 18: 167, 19: 167, 20: 167,
               21: 85}
OPS_ELLIPTICAL, OPS_GRADIENT, OPS_RECT_MASK = 27, 44, 35
MASK_BLEND_SAVING = 11  # one plane blended instead of four


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    if not out:
        fail("nvidia-smi listed no card")
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Median device milliseconds of fn() over reps runs, by CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def block_means(frame, k: int = 8):
    """Means of the frame's k x k blocks; rows and columns past the last
    whole block are left out."""
    h, w, c = frame.shape
    h, w = h // k * k, w // k * k
    return frame[:h, :w].reshape(h // k, k, w // k, k, c).mean(axis=(1, 3))


TILE_TARGETS = (5, 6)  # a tile pass's target and mask stack
MEGA_TARGETS = (4,)  # the megakernel's frame planes


def as_before(args, targets=TILE_TARGETS):
    """A pass's arguments with its target copied (for a tile pass args[5]
    and the mask stack args[6]; for the megakernel args[4]): the kernels
    update the target in place, and K3's target is a plane of the stack, so
    a plain version run after the kernel gets them as they were before it."""
    return tuple(a.clone() if i in targets else a for i, a in enumerate(args))


def compared(fn, plain, errs, store, what: str, targets=TILE_TARGETS,
             ambiguous=None):
    """fn wrapped so that each call also runs its plain version on the same
    inputs (as they were before the kernel ran: the passes work in place),
    records max |kernel - plain| and the call's arguments. ambiguous: a list,
    or None; given, the pixels past TOL that ops.raster.ambiguous_pixels
    finds on a quad's uv clip edge or a bezier's evolute (where a fused
    multiply-add and ATen's rounding decide a whole pixel's coverage apart)
    are left out of the error and their count appended to the list."""
    import torch

    from figdraw_tpu_torch.ops.raster import ambiguous_pixels

    def call(*args, **kw):
        before = as_before(args, targets)
        got = fn(*args, **kw)
        ref = plain(*before, **kw)
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(ref).all())):
            fail(f"{what}: non-finite planes from {fn.__name__}")
        diff = (got - ref).abs()
        if ambiguous is not None:
            per_pixel = diff.amax(0)
            ys, xs = (t.cpu().numpy() for t in torch.nonzero(per_pixel > TOL, as_tuple=True))
            if len(ys):
                left = ambiguous_pixels(args[0].cpu().numpy(), args[1].cpu().numpy(), ys, xs)
                per_pixel[ys[left], xs[left]] = 0.0
                ambiguous.append(int(left.sum()))
            errs.append(float(per_pixel.max()))
        else:
            errs.append(float(diff.max()))
        store.append((args, kw))
        return got
    return call


def live_pairs(fields, modes, tile_idx, tile_counts, tile_h, tiles_x, seg=None,
               mega=False, row0=0):
    """Every (tile, quad) pair of the binned lists (the run's segment [seg)
    when given) that covers pixels: (quad, mode word, x0, x1, y0, y1), the
    tile's pixels whose centers lie in the quad's bbox as the integer
    ranges [x0, x1) x [y0, y1), rows counted from the band origin row0.
    Clear sentinels of the mega tape cover none."""
    import numpy as np

    from figdraw_tpu_torch.ops.layout import (
        QF_BBOX_X0, QF_BBOX_X1, QF_BBOX_Y0, QF_BBOX_Y1,
    )
    from figdraw_tpu_torch.ops.mega import MEGA_CLEAR_BIT, MEGA_EVAL_MASK

    f = fields.cpu().numpy()
    raw = modes[:, 0].cpu().numpy()
    idx = tile_idx.cpu().numpy()
    live = np.arange(idx.shape[1])[None, :] < tile_counts.cpu().numpy()[:, None]
    if seg is not None:
        live &= (idx >= seg[0]) & (idx < seg[1])
    t, j = np.nonzero(live)
    q = idx[t, j]
    r = raw[q]
    if mega:
        keep = (r & MEGA_CLEAR_BIT) == 0
        t, q, r = t[keep], q[keep], r[keep] & MEGA_EVAL_MASK
    tx0 = (t % tiles_x) * 128
    ty0 = row0 + (t // tiles_x) * tile_h
    # pixel x is covered when x + 0.5 lies in [bbox_x0, bbox_x1)
    x0 = np.maximum(np.ceil(f[q, QF_BBOX_X0] - 0.5), tx0).astype(np.int64)
    x1 = np.minimum(np.ceil(f[q, QF_BBOX_X1] - 0.5), tx0 + 128).astype(np.int64)
    y0 = np.maximum(np.ceil(f[q, QF_BBOX_Y0] - 0.5), ty0).astype(np.int64)
    y1 = np.minimum(np.ceil(f[q, QF_BBOX_Y1] - 0.5), ty0 + tile_h).astype(np.int64)
    keep = (x1 > x0) & (y1 > y0)
    return q[keep], r[keep], x0[keep], x1[keep], y0[keep] - row0, y1[keep] - row0


def tile_ops(fields, pairs, mask_target=False) -> float:
    """FP32 operations the tile walk needs for these pairs (live_pairs):
    OPS_BY_MODE with its modifiers at each covered pixel."""
    import numpy as np

    from figdraw_tpu_torch.ops.layout import QF_RECT_PARAMS

    f = fields.cpu().numpy()
    q, r, x0, x1, y0, y1 = pairs
    rest = r % 256
    base = rest % 128
    ops = np.array([OPS_BY_MODE.get(int(b), OPS_BY_MODE[3]) for b in range(128)])[base]
    ops = (ops + OPS_ELLIPTICAL * (rest >= 128) * np.where(base == 9, 2, 1)
           + OPS_GRADIENT * ((r // 256) % 8 != 0)
           + OPS_RECT_MASK * ((f[q, QF_RECT_PARAMS + 2] >= 0) & (f[q, QF_RECT_PARAMS + 3] >= 0)))
    if mask_target:
        ops = ops - MASK_BLEND_SAVING
    return float((ops * (x1 - x0) * (y1 - y0)).sum())


def covered(pairs, sel, shape) -> int:
    """Pixels of a (PH, PW) plane that the selected pairs cover, each
    counted once."""
    import numpy as np

    _q, _r, x0, x1, y0, y1 = pairs
    plane = np.zeros(shape, bool)
    for a, b, c, d in zip(x0[sel], x1[sel], y0[sel], y1[sel]):
        plane[c:d, a:b] = True
    return int(plane.sum())


def atlas_bytes(fields, pairs, atlas) -> int:
    """Bytes of the (S, S, 4) f32 atlas that the pairs' atlas quads (modes 0
    and 13-16) sample: the texels inside each quad's uv parallelogram's
    bounding rectangle, a texel wider for the bilinear taps, each counted
    once."""
    import numpy as np

    from figdraw_tpu_torch.ops.layout import QF_UV3_X

    s = atlas.shape[0]
    base = (pairs[1] % 256) % 128
    q = np.unique(pairs[0][(base == 0) | ((base >= 13) & (base <= 16))])
    uv = fields.cpu().numpy()[q, QF_UV3_X : QF_UV3_X + 6]
    us = uv[:, 0:1] + np.stack([0 * uv[:, 2], uv[:, 2], uv[:, 4], uv[:, 2] + uv[:, 4]], 1)
    vs = uv[:, 1:2] + np.stack([0 * uv[:, 3], uv[:, 3], uv[:, 5], uv[:, 3] + uv[:, 5]], 1)
    x0 = np.clip(np.floor(us.min(1) * s) - 1, 0, s).astype(np.int64)
    x1 = np.clip(np.ceil(us.max(1) * s) + 1, 0, s).astype(np.int64)
    y0 = np.clip(np.floor(vs.min(1) * s) - 1, 0, s).astype(np.int64)
    y1 = np.clip(np.ceil(vs.max(1) * s) + 1, 0, s).astype(np.int64)
    texels = np.zeros((s, s), bool)
    for a, b, c, d in zip(x0, x1, y0, y1):
        texels[c:d, a:b] = True
    return int(texels.sum()) * 16


def bound_of(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the least time for moving n_bytes through HBM
    once and doing n_ops FP32 operations, whichever is longer."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def raster_work(args, kw, mask_target=False):
    """The work of one K1 / K1-atlas / K3 call, counting what the run's
    quads need, as a numpy vector (bytes out of place, bytes in place, ops,
    quad-block pairs of the run segments, the pairs the cull keeps). Bytes:
    the quads' rows and modes, the live entries of the tile lists, the
    bounds, each mask plane the quads index and the backdrop only at the
    pixels the quads (mode-17 quads for the backdrop) cover, the atlas
    texels the quads sample (atlas_bytes), and the target read and written: whole for an out-of-place pass (the
    kernels' earlier design), only at the 16x16 blocks that keep a quad for
    the in-place kernel. Ops by tile_ops over the same pairs; pairs by
    raster.block_pairs."""
    import numpy as np

    from figdraw_tpu_torch.ops import raster
    from figdraw_tpu_torch.ops.layout import QF_WIDTH, QI_MASK, QI_WIDTH

    fields, modes, bounds, tile_idx, tile_counts, target, masks = args[:7]
    backdrop = args[7] if len(args) > 7 else kw.get("backdrop_planes")
    atlas = kw.get("atlas")
    planes, ph, pw = target.shape
    row0 = kw.get("row0", 0)
    pairs = live_pairs(fields, modes, tile_idx, tile_counts, kw["tile_h"], pw // 128,
                       seg=bounds.tolist(), row0=row0)
    q = pairs[0]
    plane_of = modes[:, QI_MASK].cpu().numpy()[q]
    n_bytes = (len(np.unique(q)) * (QF_WIDTH + QI_WIDTH) * 4
               + (int(tile_counts.sum()) + tile_counts.numel() + 2) * 4)
    n_bytes += 4 * sum(covered(pairs, plane_of == k, (ph, pw))
                       for k in np.unique(plane_of))
    if backdrop is not None:
        n_bytes += 16 * covered(pairs, (pairs[1] % 256) % 128 == 17, (ph, pw))
    if atlas is not None:
        n_bytes += atlas_bytes(fields, pairs, atlas)
    before, after, blocks = raster.block_pairs(fields, bounds, tile_idx, tile_counts,
                                               kw["tile_h"], ph, pw, row0=row0)
    per_block = 2 * planes * raster.BLOCK * raster.BLOCK * 4
    return np.array([n_bytes + 2 * target.nelement() * 4, n_bytes + blocks * per_block,
                     tile_ops(fields, pairs, mask_target=mask_target), before, after],
                    dtype=np.float64)


def bounds_of(work):
    """((bound_ms, bound_by) in place, the same out of place) of a
    raster_work vector or a sum of them."""
    return bound_of(work[1], work[2]), bound_of(work[0], work[2])


def bound_text(work) -> str:
    (ip, ip_by), (oop, oop_by) = bounds_of(work)
    return (f"bound {ip:.4f} ms in place ({ip_by}), {oop:.4f} ms out of place "
            f"({oop_by}); quad-block pairs {work[3]:.0f} before the cull, "
            f"{work[4]:.0f} after")


def kernel_device_ms(fn, reps: int = 3) -> dict:
    """Device ms per run of fn() in each kernel, by name, from torch.profiler
    (CUPTI): {name: (ms per run, launches per run)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = max(getattr(e, a, 0) or 0 for a in (
            "self_device_time_total", "device_time_total", "self_cuda_time_total",
            "cuda_time_total"))
        if us > 0:
            out[e.key] = (us / 1e3 / reps, e.count / reps)
    return out


TRACE_TAKES = 6  # torch.profiler takes of one timing before it fails


def kernels_alone(fn, names, reps: int = 5, replays=None) -> dict:
    """Each named kernel's device ms a launch from one torch.profiler trace
    of fn() (each launched once a run), taken again as device_ms_of takes a
    trace that comes back empty; {name: ms}. When every take comes back
    empty, replays() times them instead (CUDA graph replays, printed as
    such)."""
    prof = {}
    for attempt in range(TRACE_TAKES):
        if attempt:
            time.sleep(0.5 * attempt)
        prof = kernel_device_ms(fn, reps)
        got = {name: [ms / n for key, (ms, n) in prof.items() if name in key]
               for name in names}
        if all(got.values()):
            return {name: sum(v) for name, v in got.items()}
        if prof:
            break
        print(f"note: the profiler's trace for {names} came back with no device "
              f"activity (take {attempt + 1} of {TRACE_TAKES})", flush=True)
    if not prof and replays is not None:
        out = replays()
        print(f"note: {names} timed by CUDA graph replays instead: {out}", flush=True)
        return out
    fail(f"the profiler saw no kernels named {names}; it saw {sorted(prof)[:20]}")


def device_ms_of(fn, kernel, reps: int = 5, launches: int = 1) -> float:
    """Device ms per run of fn() in the kernels whose name holds `kernel`
    (a string, or a tuple of them for a wrapper that launches several
    kernels, each `launches` times), from torch.profiler: the kernels' own
    time, where CUDA events around a
    wrapper call also count the host's part of a launch into an idle
    queue. fn() launches each such kernel `launches` times. The profiler's
    traces on the card are not always whole: one in some hundred comes back
    with no device activity at all, once four in a row right after the
    rolled phase's long traces, so such a take is taken again after a pause
    that grows (up to five more times); the take after such a one has read
    2.5 times a kernel's usual time, and one call site's traces hold 4
    launches for 5 runs. So the time
    is the mean per launch that the trace holds times `launches`, and a
    trace that holds another number of launches than reps * launches is
    printed. When every take comes back empty, a CUDA graph replay of fn()
    times it instead (graph_ms), with a note."""
    prof = {}
    for attempt in range(TRACE_TAKES):
        if attempt:
            time.sleep(0.5 * attempt)
        prof = kernel_device_ms(fn, reps)
        names = (kernel,) if isinstance(kernel, str) else kernel
        hits = {k: v for k, v in prof.items() if any(name in k for name in names)}
        if all(any(name in k for k in hits) for name in names):
            seen = [round(n * reps) for _ms, n in hits.values()]
            if attempt or any(n != reps * launches for n in seen):
                print(f"note: the profiler's trace for {kernel} (take {attempt + 1}) "
                      f"holds {seen} launches for {reps} runs of {launches} each; "
                      f"timed by the mean per launch", flush=True)
            return sum(ms / n * launches for ms, n in hits.values())
        if prof:
            break
        print(f"note: the profiler's trace for {kernel} came back with no device "
              f"activity (take {attempt + 1} of {TRACE_TAKES})", flush=True)
    if not prof:
        # every take empty: the device time of a CUDA graph replay of fn()'s
        # launches, which also counts the graph's own launch (a few µs)
        ms = graph_ms(fn, reps=20)
        print(f"note: {kernel} timed by a CUDA graph replay of the call instead: "
              f"{ms:.4f} ms", flush=True)
        return ms
    fail(f"the profiler saw no kernel named {kernel}; it saw {sorted(prof)[:20]}")


def kernel_parts(fn, names) -> str:
    """Each named kernel's device ms a launch in one torch.profiler trace of
    fn(), as text: where a wrapper launches several kernels, which takes
    the time."""
    parts = {name: ms / n for key, (ms, n) in kernel_device_ms(fn).items()
             for name in names if name in key}
    return "a launch: " + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())


def graph_ms(fn, reps: int = 5) -> float:
    """Median device ms of one replay of a CUDA graph of fn()'s launches (no
    host work between them), by CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def mega_work(args, kw):
    """The work of one K4 / K4-atlas call, as raster_work's vector (bytes
    out of place, bytes in place, ops, entry-block pairs of the tile lists,
    the pairs the cull keeps). Bytes: the rows and modes of the quads the
    lists hold, their live entries, the atlas texels the quads sample
    (atlas_bytes), and the frame planes
    read and written: whole out of place (the earlier design), only at the
    16x16 blocks that keep an entry for the in-place kernel (the mask planes
    live in shared memory). Clear sentinels count as entries and cover no
    pixel."""
    import numpy as np

    from figdraw_tpu_torch.ops import mega, raster
    from figdraw_tpu_torch.ops.layout import QF_WIDTH, QI_WIDTH

    fields, modes, tile_idx, tile_counts, planes, _n_masks = args
    th, atlas = kw["tile_h"], kw.get("atlas")
    _, ph, pw = planes.shape
    row0 = kw.get("row0", 0)
    pairs = live_pairs(fields, modes, tile_idx, tile_counts, th, pw // 128, mega=True,
                       row0=row0)
    n_bytes = (len(np.unique(pairs[0])) * (QF_WIDTH + QI_WIDTH) * 4
               + (int(tile_counts.sum()) + tile_counts.numel()) * 4)
    if atlas is not None:
        n_bytes += atlas_bytes(fields, pairs, atlas)
    before, after, blocks = mega.block_entries(fields, modes, tile_idx, tile_counts, th,
                                               ph, pw, row0=row0)
    per_block = 2 * 4 * raster.BLOCK * raster.BLOCK * 4
    return np.array([n_bytes + 2 * planes.nelement() * 4, n_bytes + blocks * per_block,
                     tile_ops(fields, pairs), before, after], dtype=np.float64)


def image_renderer():
    """A CUDA renderer set up as bench_images.main sets up its own: a 256
    atlas and the photo published mipmapped on a bus of its own."""
    from figdraw_tpu_torch import FigRenderer
    from figdraw_tpu_torch.resources import ImageMessageBus, put_image
    from figdraw_tpu_torch.scenes import IMAGE_ID, photo_image

    ren = FigRenderer(atlas_size=256, device="cuda")
    bus = ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    put_image(IMAGE_ID, photo_image(), bus=bus, mipmapped=True)
    return ren


def launch_counts():
    from figdraw_tpu_torch.ops import mega, raster

    return (raster.LAUNCHES, raster.ATLAS_LAUNCHES, raster.MASK_LAUNCHES,
            mega.LAUNCHES, mega.ATLAS_LAUNCHES)


def zero_counts():
    from figdraw_tpu_torch.ops import binning, blur, mega, raster, rows

    raster.LAUNCHES = raster.ATLAS_LAUNCHES = raster.MASK_LAUNCHES = 0
    mega.LAUNCHES = mega.ATLAS_LAUNCHES = 0
    rows.LAUNCHES = blur.LAUNCHES = binning.LAUNCHES = binning.DECODE_LAUNCHES = 0
    binning.PLAIN_DECODES = binning.PLAIN_BINNINGS = 0
    raster.BAND_LAUNCHES = raster.BAND_ATLAS_LAUNCHES = raster.BAND_MASK_LAUNCHES = 0
    mega.BAND_LAUNCHES = mega.BAND_ATLAS_LAUNCHES = 0
    binning.BAND_LAUNCHES = binning.BAND_DECODE_LAUNCHES = blur.BAND_LAUNCHES = 0


FRONT_PATHS = {}  # path -> front-kernel launches of its counted run


def binning_launches(what: str, runs: int) -> int:
    """The front end's launches since zero_counts(): one front end a run of
    an executor, as the path ran `runs` of them, each launching the front
    kernel (the decode fused with the binning's terms) and the tile kernel,
    and no plain decode or binning; fails otherwise. Keeps the front
    kernel's count for the kernels line; returns the tile kernel's."""
    from figdraw_tpu_torch.ops import binning

    got = (binning.DECODE_LAUNCHES, binning.LAUNCHES, binning.PLAIN_DECODES,
           binning.PLAIN_BINNINGS)
    if got != (runs, runs, 0, 0):
        fail(f"{what}: (front kernel, tile kernel, plain decode, plain binning) ran "
             f"{got} times, expected {(runs, runs, 0, 0)} (one front end an executor run)")
    FRONT_PATHS[what] = binning.DECODE_LAUNCHES
    return binning.LAUNCHES


def recorded(module, name: str, render) -> list:
    """Runs render() with module.name's calls recorded as they run:
    [(args, kwargs)]."""
    calls, real = [], getattr(module, name)

    def record(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    setattr(module, name, record)
    try:
        render()
    finally:
        setattr(module, name, real)
    return calls


def recorded_binning(render) -> list:
    """Runs render() with the executor's front-end calls (decode_and_bin)
    recorded as they run: [(args, kwargs)]."""
    from figdraw_tpu_torch import executor

    return recorded(executor, "decode_and_bin", render)


BIN_CALLS = {}  # scene -> the executor's own front-end call, for the times
BIN_PATHS = {}  # path -> tile-kernel launches of its counted run
BORDERLINE = {}  # path -> saturation-borderline quads its check left out
BIN_DIFF = {}  # path -> binning.list_differences of its check
DECODE_DIFF = {}  # path -> (words compared, words differing, max |kernel - plain| word)


def words_differ(got, want) -> tuple:
    """(words compared, words differing, max |a - b| over the int32 words)
    of two tensors of 32-bit lanes."""
    import torch

    a = got.contiguous().view(torch.int32).long()
    b = want.contiguous().view(torch.int32).long()
    if a.shape != b.shape:
        return 0, max(a.numel(), b.numel()), float("inf")
    d = (a - b).abs()
    return a.numel(), int((d != 0).sum()), float(d.max()) if d.numel() else 0.0


def binning_check(what: str, render) -> int:
    """Runs render() (one frame or view of a path) with the executor's
    front-end call recorded, then holds the kernels against the plain front
    end on that call: the fields and modes equal the plain decode's as
    32-bit words (check 9 decode), and the whole (T, N) lists and counts
    equal the plain binning's, leaving out the quads whose within-run
    above-stack lies within rounding of the saturation threshold
    (bin_quads_model finds them; expected 0). Keeps the call for the times
    and the differences for the kernels line; returns the borderline quads
    left out."""
    import torch

    from figdraw_tpu_torch.ops import binning

    calls = recorded_binning(render)
    if len(calls) != 1:
        fail(f"{what}: the frame made {len(calls)} front-end calls, expected 1")
    a, k = calls[0]
    got = binning.decode_and_bin(*a, **k)
    want = binning.decode_and_bin_plain(*a, **k)
    torch.cuda.synchronize()
    rows, start, end, tiles_y, tiles_x, th, tw = a
    cull, runs = k.get("cull", False), k.get("run_bounds")
    words = [words_differ(got[i], want[i]) for i in (0, 1)]
    decode = (sum(w[0] for w in words), sum(w[1] for w in words),
              max(w[2] for w in words))
    print(f"check 9 decode: the front kernel vs the plain decode on the {what} rows "
          f"{tuple(rows.shape)}: {decode[1]} of {decode[0]} fields and modes words "
          f"differ (expected 0)", flush=True)
    if decode[1]:
        fail(f"{what}: the decode kernel's fields or modes differ from the plain decode's")
    DECODE_DIFF[what] = decode
    fields, modes = want[0], want[1]
    _idx, _counts, border = binning.bin_quads_model(
        fields.cpu().numpy(), int(start), int(end), tiles_y, tiles_x, th, tw,
        modes=modes.cpu().numpy() if cull else None,
        run_bounds=None if runs is None or not cull else runs.cpu().numpy())
    got_np = [t.cpu().numpy() for t in got[2:]]
    want_np = [t.cpu().numpy() for t in want[2:]]
    diff = binning.list_differences(*got_np, *want_np, border)
    same = diff["max_abs_err"] == 0
    culls = ("no culling" if not cull else "occlusion" if runs is None
             else f"{runs.shape[0]} frame runs")
    print(f"check 9: binning kernel vs plain on the {what} tape (T {tiles_y * tiles_x}, "
          f"N {rows.shape[0]}, tile_h {th}, {culls}"
          f"{', saturation tier' if cull and rows.shape[0] >= binning.SAT_MIN_QUADS else ''}): "
          f"whole lists and counts {'equal' if same else 'DIFFER'}: "
          f"{diff['differing']} of {diff['compared']} entries differ, kept counts "
          f"{diff['count_delta']} apart at most, max |kernel - plain| "
          f"{diff['max_abs_err']:g}; {int(border.sum())} saturation-borderline quads left "
          f"out (expected 0); {int(got_np[1].sum())} of {int(want_np[1].sum())} kept "
          f"entries", flush=True)
    if not same:
        fail(f"{what}: the binning kernel's lists differ from the plain version's")
    BIN_CALLS[what] = (a, k)
    BIN_DIFF[what] = diff
    return int(border.sum())


def front_work(a, k):
    """(bytes, operations) the front kernel needs: each packed row read
    once (208 B), its fields (272 B) and modes (8 B) written once, and the
    tile kernel's terms written once (the bbox's tile range, 8 B; with
    culling the cover terms, 16 B); 24 divisions of the colour bytes a row
    and, with culling, ~60 operations a quad for its cover terms. Counted,
    not measured."""
    rows = a[0]
    n, cull = rows.shape[0], k.get("cull", False)
    n_bytes = n * (208 + 272 + 8 + 8 + (16 if cull else 0))
    return n_bytes, n * (24 + 12 + (60 if cull else 0))


def tiles_work(a, k):
    """(bytes, operations) the tile kernel needs: each quad's tile range
    read once (8 B) and, with culling, the cover terms of the quads the
    walk visits (counted as all, 16 B), the runs and the window once; the
    (T, N) lists and the counts written once; four compares a (tile, quad)
    pair of the window. Counted, not measured."""
    rows, start, end, tiles_y, tiles_x = a[:5]
    n, n_tiles = rows.shape[0], tiles_y * tiles_x
    cull, runs = k.get("cull", False), k.get("run_bounds")
    n_bytes = n * (8 + (16 if cull else 0)) + 8
    n_bytes += 0 if runs is None else runs.numel() * 4
    n_bytes += n_tiles * n * 4 + n_tiles * 4
    window = max(0, min(int(end), n) - max(int(start), 0))
    return n_bytes, n_tiles * window * 4


def binning_work(a, k):
    """(bytes, operations) the whole front end needs as one function: the
    packed rows read once, the fields, modes, (T, N) lists and counts
    written once (the per-quad terms between its two kernels are its own);
    the two kernels' operations. Counted, not measured."""
    rows, _start, _end, tiles_y, tiles_x = a[:5]
    n, n_tiles = rows.shape[0], tiles_y * tiles_x
    runs = k.get("run_bounds")
    n_bytes = n * (208 + 272 + 8) + 8 + (0 if runs is None else runs.numel() * 4)
    n_bytes += n_tiles * n * 4 + n_tiles * 4
    return n_bytes, front_work(a, k)[1] + tiles_work(a, k)[1]


def binning_times(what: str, tag: str) -> dict:
    """The front end's times on one scene's own call: by CUDA events around
    the wrapper call (decode_and_bin, both kernels), the front kernel alone
    (stop=4) by events, each kernel alone by torch.profiler, the plain
    front end and the plain decode, and each bound; and, for the record
    only, torch.argsort of the (T, N) keys that the plain version sorts."""
    import torch

    from figdraw_tpu_torch.ops import binning

    a, k = BIN_CALLS[what]
    call = lambda: binning.decode_and_bin(*a, **k)
    front = lambda: binning.decode_and_bin(*a, **k, stop=4)
    ms = cuda_ms(call, 20)
    front_ms = cuda_ms(front, 20)
    torch.cuda.synchronize()
    host = []
    for _ in range(50):  # the wrapper's host path: checks, allocations, the C call
        t0 = time.perf_counter()
        call()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    host_ms = statistics.median(host)
    def replays():
        front_replay = graph_ms(front, reps=20)
        return {"front_kernel": front_replay,
                "tiles_kernel": graph_ms(call, reps=20) - front_replay}

    parts = kernels_alone(call, ("front_kernel", "tiles_kernel"), replays=replays)
    front_alone, tiles_alone = parts["front_kernel"], parts["tiles_kernel"]
    alone = front_alone + tiles_alone
    plain_ms = cuda_ms(lambda: binning.decode_and_bin_plain(*a, **k), 5)
    decode_plain_ms = cuda_ms(lambda: binning.unpack_combo_plain(a[0]), 5)
    _f, _m, idx, counts = call()
    n = idx.shape[1]
    order = torch.arange(n, dtype=torch.int32, device=idx.device)
    live = order[None, :] < counts[:, None]
    kept = torch.zeros_like(live).scatter_(1, idx.long(), live)
    keys = torch.where(kept, order[None, :], n + order[None, :])
    argsort_ms = cuda_ms(lambda: torch.argsort(keys, dim=1), 5)
    n_bytes, n_ops = binning_work(a, k)
    bound, by = bound_of(n_bytes, n_ops)
    f_bytes, f_ops = front_work(a, k)
    front_bound, front_by = bound_of(f_bytes, f_ops)
    t_bytes, t_ops = tiles_work(a, k)
    tiles_bound, tiles_by = bound_of(t_bytes, t_ops)
    print(f"times: front end on the {what} tape, rows {tuple(a[0].shape)}, lists "
          f"{tuple(idx.shape)}: {ms:.4f} ms (CUDA events around decode_and_bin; its host "
          f"path, the enqueue alone, {host_ms:.4f} ms), "
          f"{alone:.4f} ms (both kernels alone, torch.profiler), plain torch "
          f"{plain_ms:.3f} ms; bound {bound:.4f} ms ({by}: {n_bytes} bytes). The front "
          f"kernel: {front_ms:.4f} ms by events, {front_alone:.4f} ms alone, bound "
          f"{front_bound:.5f} ms ({front_by}: {f_bytes} bytes), the plain decode "
          f"{decode_plain_ms:.4f} ms. The tile kernel: {tiles_alone:.4f} ms alone, bound "
          f"{tiles_bound:.4f} ms ({tiles_by}: {t_bytes} bytes). torch.argsort of the "
          f"(T, N) keys alone {argsort_ms:.4f} ms (for the record, no yardstick) {tag}",
          flush=True)
    return {"ms": ms, "device_ms": alone, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "argsort_ms": argsort_ms, "host_ms": host_ms,
            "front": {"ms": front_ms, "device_ms": front_alone, "plain_ms": decode_plain_ms,
                      "bound_ms": front_bound, "bound_by": front_by},
            "tiles": {"device_ms": tiles_alone, "bound_ms": tiles_bound,
                      "bound_by": tiles_by}}


def tile_split(what: str, tag: str) -> dict:
    """The tile kernel's phases on one scene's own call: the front end
    stopped after its front kernel, after the tile kernel's overlap pass,
    its culls and its counts, and whole, each ten times in a CUDA graph (no
    host work between the launches) timed by CUDA events a replay; each
    phase is the difference of two."""
    from figdraw_tpu_torch.ops import binning

    a, k = BIN_CALLS[what]
    calls = 10  # a graph holds ten calls, so one replay's launch costs a tenth
    ms = {stop: graph_ms(lambda: [binning.decode_and_bin(*a, **k, stop=stop)
                                  for _ in range(calls)], reps=20) / calls
          for stop in (4, 1, 2, 3, 0)}
    split = {"overlap": ms[1] - ms[4], "culls": ms[2] - ms[1], "counts": ms[3] - ms[2],
             "writing": ms[0] - ms[3], "whole": ms[0] - ms[4]}
    print(f"times: the tile kernel's phases on the {what} tape (CUDA graph replays of the "
          f"front end stopped after each, differences): "
          + ", ".join(f"{p} {v:.4f} ms" for p, v in split.items())
          + f"; the front end whole {ms[0]:.4f} ms, its front kernel {ms[4]:.4f} ms {tag}",
          flush=True)
    return split


def front_stages(what: str) -> dict:
    """The front end's stages on a path's own call, by CUDA events: the
    decode alone (unpack_combo, the front kernel's decode-only form), the
    front end (decode_and_bin) and its plain version."""
    from figdraw_tpu_torch.ops import binning

    a, k = BIN_CALLS[what]
    return {
        "decode": cuda_ms(lambda: binning.unpack_combo(a[0]), 10),
        "front end": cuda_ms(lambda: binning.decode_and_bin(*a, **k), 10),
        "front end (plain torch)": cuda_ms(lambda: binning.decode_and_bin_plain(*a, **k), 5),
    }


def timed_frames(what: str, render, shape, frames: int = FRAMES) -> list:
    """`frames` frames of render(), each ended by a synchronize; checks
    shape and finiteness; returns the ms of each."""
    import torch

    total_ms = []
    for f in range(frames):
        t0 = time.perf_counter()
        frame = render()
        torch.cuda.synchronize()
        total_ms.append((time.perf_counter() - t0) * 1e3)
        if tuple(frame.shape) != shape:
            fail(f"{what} frame {f} has shape {tuple(frame.shape)}")
        if not bool(torch.isfinite(frame).all()):
            fail(f"{what} frame {f} holds non-finite values")
    return total_ms


def check_blocks(what: str, frame, path: str, tol: float = TOL) -> float:
    import numpy as np

    err = float(np.abs(block_means(frame.cpu().numpy()) - np.load(path)).max())
    print(f"check: {what} vs the JAX reference (8x8 block means) max |diff| "
          f"{err:.3e} (tol {tol:.3e})", flush=True)
    if not err <= tol:
        fail(f"{what} differs from the JAX reference by {err}")
    return err


def images_phase(tag: str, dev) -> dict:
    """bench_images' four variants at 1920x1080 with 400 panels, FRAMES
    frames each through render_frame with the counts set to 0 just before
    and read just after; K1 / K1-atlas against its plain version on one
    frame's inputs, the frame against the executor with the plain version,
    the 480x270, 25-panel frame against the stored JAX block means."""
    import torch

    from figdraw_tpu_torch import native, vec2
    from figdraw_tpu_torch.executor import get_frame_executor
    from figdraw_tpu_torch.ops import raster
    from figdraw_tpu_torch.plan import plan_execution
    from figdraw_tpu_torch.scenes import image_reference_path, make_image_panels_scene

    size = vec2(IMAGE_W, IMAGE_H)
    out = {}
    for variant in BENCH_VARIANTS:
        scene = make_image_panels_scene(IMAGE_W, IMAGE_H, IMAGE_PANELS, variant)
        ren = image_renderer()
        ren.render_frame(scene, size)  # the first frame uploads the atlas
        torch.cuda.synchronize()
        zero_counts()
        total_ms = timed_frames(variant, lambda: ren.render_frame(scene, size),
                                (IMAGE_H, IMAGE_W, 4))
        counts = launch_counts()
        bins = binning_launches(f"images {variant}", FRAMES)
        frame = ren.last_frame
        want = ((FRAMES, 0, 0, 0, 0) if variant == "sdf_control"
                else (0, FRAMES, 0, 0, 0))
        print(f"check images: {variant} {IMAGE_PANELS} panels at {IMAGE_W}x{IMAGE_H}, "
              f"{FRAMES} frames finite; launches K1 {counts[0]}, K1-atlas "
              f"{counts[1]}, K3 {counts[2]}, K4 {counts[3]}, K4-atlas {counts[4]} "
              f"(expected {want})", flush=True)
        if counts != want:
            fail(f"images {variant} launched {counts}, expected {want}")
        border = binning_check(f"images {variant}", lambda: ren.render_frame(scene, size))
        walk = ren._walk_atlas()
        walk_ms = []
        for _ in range(FRAMES):
            t0 = time.perf_counter()
            native.flatten_fast(scene, IMAGE_W, IMAGE_H, 1.0, 1.0, ren.aa_factor,
                                (1.0, 1.0, 1.0, 1.0), atlas=walk)
            walk_ms.append((time.perf_counter() - t0) * 1e3)
        tape = ren.flatten(scene, size)
        plan = plan_execution(tape)
        run = get_frame_executor(plan.structure, plan.height, plan.width,
                                 plan.n_masks, plan.has_init_frame, plan.tile_h)
        combo = torch.from_numpy(plan.combo).to(dev, copy=True)
        atlas = ren._device_atlas()
        errs, calls = [], []
        run(combo, None, atlas=atlas,
            draw=compared(raster.draw_pass_planar_prebinned,
                          raster.draw_pass_planar_prebinned_plain, errs, calls, variant))
        ref = run(combo, None, atlas=atlas, draw=raster.draw_pass_planar_prebinned_plain)
        torch.cuda.synchronize()
        frame_err = float((frame - ref).abs().max())
        print(f"check images: {variant} tape {tape.count} quads in {tape.combo_quads} "
              f"rows, structure {list(plan.structure)}, tile_h {plan.tile_h}; kernel "
              f"vs plain max |diff| {max(errs):.3e}, frame {FRAMES} vs the plain "
              f"executor {frame_err:.3e} (tol {TOL:.3e})", flush=True)
        if not (max(errs) <= TOL and frame_err <= TOL):
            fail(f"images {variant}: kernel or frame differs from plain "
                 f"({max(errs)}, {frame_err})")
        small = image_renderer().render_frame(
            make_image_panels_scene(SMALL_W, SMALL_H, SMALL_PANELS, variant),
            vec2(SMALL_W, SMALL_H))
        check_blocks(f"images {variant} {SMALL_W}x{SMALL_H}, {SMALL_PANELS} panels",
                     small, image_reference_path(variant))
        args, kw = calls[0]
        kernel_ms = cuda_ms(lambda: raster.draw_pass_planar_prebinned(*args, **kw), 20)
        work = raster_work(args, kw)
        print(f"times: images {variant}: median {statistics.median(total_ms):.3f} "
              f"ms/frame (render_frame + sync; host walk and export alone "
              f"{statistics.median(walk_ms):.3f} ms); its draw kernel "
              f"{kernel_ms:.4f} ms, {bound_text(work)} {tag}", flush=True)
        out[variant] = dict(launches=counts, err=max(max(errs), frame_err),
                            args=(args, kw), kernel_ms=kernel_ms, work=work,
                            ms_per_frame=statistics.median(total_ms),
                            bin_launches=bins, borderline=border)
    return out


def text_phase(tag: str, dev) -> dict:
    """bench_text's stored plan and atlas through execute_plan for FRAMES
    frames (K1-atlas once each); the kernel against its plain version on the
    frame's inputs; the frame against the stored JAX block means."""
    import torch

    from figdraw_tpu_torch import FigRenderer
    from figdraw_tpu_torch.executor import get_frame_executor
    from figdraw_tpu_torch.ops import raster
    from figdraw_tpu_torch.plan import atlas_from_jax
    from figdraw_tpu_torch.scenes import load_text_plan

    plan, atlas_np, blocks = load_text_plan()
    ren = FigRenderer(device="cuda")
    atlas = atlas_from_jax(atlas_np, dev)
    ren.execute_plan(plan, atlas=atlas)
    torch.cuda.synchronize()
    zero_counts()
    total_ms = timed_frames("text", lambda: ren.execute_plan(plan, atlas=atlas),
                            (plan.height, plan.width, 4))
    counts = launch_counts()
    bins = binning_launches("text", FRAMES)
    frame = ren.last_frame
    want = (0, FRAMES, 0, 0, 0)
    print(f"check text: {plan.width}x{plan.height}, {plan.bounds[0][1]} glyph and "
          f"box quads, atlas {atlas_np.shape[0]}, tile_h {plan.tile_h}, {FRAMES} "
          f"frames finite; launches {counts} (expected {want})", flush=True)
    if counts != want:
        fail(f"text launched {counts}, expected {want}")
    border = binning_check("text", lambda: ren.execute_plan(plan, atlas=atlas))
    run = get_frame_executor(plan.structure, plan.height, plan.width, plan.n_masks,
                             plan.has_init_frame, plan.tile_h)
    combo = torch.from_numpy(plan.combo).to(dev, copy=True)
    errs, calls = [], []
    run(combo, None, atlas=atlas,
        draw=compared(raster.draw_pass_planar_prebinned,
                      raster.draw_pass_planar_prebinned_plain, errs, calls, "text"))
    torch.cuda.synchronize()
    print(f"check text: kernel vs plain max |diff| {max(errs):.3e} (tol {TOL:.3e})",
          flush=True)
    if not max(errs) <= TOL:
        fail(f"text: kernel differs from plain by {max(errs)}")
    import numpy as np

    err_ref = float(np.abs(block_means(frame.cpu().numpy()) - blocks).max())
    print(f"check text: frame vs the JAX reference (8x8 block means) max |diff| "
          f"{err_ref:.3e} (tol {TOL:.3e})", flush=True)
    if not err_ref <= TOL:
        fail(f"text frame differs from the JAX reference by {err_ref}")
    args, kw = calls[0]
    kernel_ms = cuda_ms(lambda: raster.draw_pass_planar_prebinned(*args, **kw), 20)
    print(f"times: text: median {statistics.median(total_ms):.3f} ms/frame "
          f"(execute_plan + sync: upload, executor); its draw kernel "
          f"{kernel_ms:.4f} ms, {bound_text(raster_work(args, kw))} {tag}",
          flush=True)
    return dict(launches=counts, err=max(errs), args=(args, kw), kernel_ms=kernel_ms,
                ms_per_frame=statistics.median(total_ms), bin_launches=bins,
                borderline=border)


TURNS, TURN_FRAMES = 3, 10  # both routes of an atlas scene, in turns


def mega_atlas_phase(which: str, tag: str, dev) -> dict:
    """A mask-heavy atlas scene on the megakernel with the atlas (K4-atlas
    once a frame) for FRAMES frames, with the counts set to 0 just before
    and read just after. which: "clipped cards", images_clipped at 1920x1080
    with 400 panels through render_frame; "text table", the stored tape of
    text in clipped cells (1200x800, 180x6) through plan_execution and
    execute_plan. K4-atlas against its plain version on the frame's own
    inputs, the frame against the same executor with the plain version and
    against the stored JAX block means; the frame's host split; then the
    megakernel and the rolled form of the frame executor (plan.plan_rolled) on
    the same scene in turns."""
    import numpy as np
    import torch

    from figdraw_tpu_torch import FigRenderer, vec2
    from figdraw_tpu_torch.executor import get_mega_executor
    from figdraw_tpu_torch.ops import mega
    from figdraw_tpu_torch.plan import atlas_from_jax, plan_execution, plan_rolled
    from figdraw_tpu_torch.scenes import (
        image_reference_path, load_text_tape, make_image_panels_scene,
    )

    if which == "clipped cards":
        size = vec2(IMAGE_W, IMAGE_H)
        scene = make_image_panels_scene(IMAGE_W, IMAGE_H, IMAGE_PANELS, "images_clipped")
        ren = image_renderer()
        ren.process_image_messages()
        given = {}  # the renderer's own atlas
        make_tape = lambda: ren.flatten(scene, size)
        mega_frame = lambda: ren.render_frame(scene, size)
    else:
        tape, atlas_np, blocks = load_text_tape()
        ren = FigRenderer(device="cuda")
        given = dict(atlas=atlas_from_jax(atlas_np, dev))
        make_tape = lambda: tape
        mega_frame = lambda: ren.execute_plan(plan_execution(tape), **given)

    def rolled_frame():
        return ren.execute_plan(plan_rolled(make_tape()), **given)

    plan = plan_execution(make_tape())
    shape = (plan.height, plan.width, 4)
    mega_frame()  # the first frame uploads the atlas
    torch.cuda.synchronize()
    zero_counts()
    total_ms = timed_frames(which, mega_frame, shape)
    counts = launch_counts()
    bins = binning_launches(which, FRAMES)
    frame = ren.last_frame
    want = (0, 0, 0, 0, FRAMES)
    n_clears = sum(1 for item in plan.structure if item[0] == "clear_mask")
    print(f"check {which}: {plan.width}x{plan.height}, {len(plan.structure)} pass "
          f"items, mega combo {None if plan.mega_combo is None else plan.mega_combo.shape} "
          f"with {n_clears} clear sentinels, {plan.n_masks} planes, tile_h "
          f"{plan.tile_h}, {FRAMES} frames finite; launches K1 {counts[0]}, K1-atlas "
          f"{counts[1]}, K3 {counts[2]}, K4 {counts[3]}, K4-atlas {counts[4]} "
          f"(expected {want})", flush=True)
    if counts != want or not plan.mega_atlas:
        fail(f"{which} launched {counts}, expected {want} on a mega plan with "
             f"the atlas (mega_atlas {plan.mega_atlas})")
    border = binning_check(which, mega_frame)

    run = get_mega_executor(plan.height, plan.width, plan.n_masks,
                            plan.has_init_frame, plan.tile_h)
    combo = torch.from_numpy(plan.mega_combo).to(dev, copy=True)
    flags = dict(atlas=given["atlas"] if given else ren._device_atlas(),
                 pixelate=ren.pixelate)
    errs, calls = [], []
    run(combo, None, **flags,
        draw=compared(mega.draw_pass_mega, mega.draw_pass_mega_plain, errs, calls,
                      which, targets=MEGA_TARGETS))
    ref = run(combo, None, **flags, draw=mega.draw_pass_mega_plain)
    torch.cuda.synchronize()
    frame_err = float((frame - ref).abs().max())
    print(f"check {which}: K4-atlas vs plain max |diff| {errs[0]:.3e}, frame "
          f"{FRAMES} vs the plain executor {frame_err:.3e} (tol {TOL:.3e})", flush=True)
    if not (len(errs) == 1 and errs[0] <= TOL and frame_err <= TOL):
        fail(f"{which}: K4-atlas or the frame differs from plain ({errs}, {frame_err})")
    if which == "clipped cards":
        small = image_renderer().render_frame(
            make_image_panels_scene(SMALL_W, SMALL_H, SMALL_PANELS, "images_clipped"),
            vec2(SMALL_W, SMALL_H))
        check_blocks(f"{which} {SMALL_W}x{SMALL_H}, {SMALL_PANELS} panels", small,
                     image_reference_path("images_clipped"))
    else:
        err_ref = float(np.abs(block_means(frame.cpu().numpy()) - blocks).max())
        print(f"check {which}: frame vs the JAX reference (8x8 block means) max "
              f"|diff| {err_ref:.3e} (tol {TOL:.3e})", flush=True)
        if not err_ref <= TOL:
            fail(f"{which} frame differs from the JAX reference by {err_ref}")

    args, kw = calls[0]
    kernel_ms = cuda_ms(lambda: mega.draw_pass_mega(*args, **kw), 20)
    device_ms = device_ms_of(lambda: mega.draw_pass_mega(*args, **kw), "mega_kernel<true>")
    plain_ms = cuda_ms(lambda: mega.draw_pass_mega_plain(*args, **kw), 3)
    exec_ms = cuda_ms(lambda: run(combo, None, **flags), 20)
    work = mega_work(args, kw)
    # the frame's parts on the host's clock: the walk (none for the stored
    # tape), the plan (pack_mega_combo), execute_plan to the sync; and the
    # rolled form's plan (its item table) alone
    walk_ms, plan_ms, execute_ms, items_ms = [], [], [], []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        step_tape = make_tape()
        t1 = time.perf_counter()
        step = plan_execution(step_tape)
        t2 = time.perf_counter()
        ren.execute_plan(step, **given)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        plan_rolled(step_tape)
        t4 = time.perf_counter()
        for lst, a, b in ((walk_ms, t0, t1), (plan_ms, t1, t2), (execute_ms, t2, t3),
                          (items_ms, t3, t4)):
            lst.append((b - a) * 1e3)
    med = statistics.median
    print(f"times: {which}: median {med(total_ms):.3f} ms/frame on the megakernel "
          f"= host walk {med(walk_ms):.3f} ms + plan (pack_mega_combo) "
          f"{med(plan_ms):.3f} ms + execute_plan and sync {med(execute_ms):.3f} ms; "
          f"whole executor {exec_ms:.4f} ms, K4-atlas {kernel_ms:.4f} ms (CUDA "
          f"events around the wrapper call), {device_ms:.4f} ms (the kernel alone, "
          f"torch.profiler), plain torch {plain_ms:.2f} ms; {bound_text(work)} "
          f"(entries of the tile lists, clear sentinels included); the rolled "
          f"form's plan {med(items_ms):.3f} ms on the host {tag}", flush=True)
    # both routes in turns, each from the tape: walk, its own plan, execute
    by_route = {"mega": [], "rolled": []}
    for _ in range(TURNS):
        for route, render in (("mega", mega_frame), ("rolled", rolled_frame)):
            by_route[route].append(med(timed_frames(f"{which} {route}", render, shape,
                                                    TURN_FRAMES)))
    rolled_err = float((ren.last_frame - ref).abs().max())
    print(f"times: {which}: routes in turns, median ms/frame of {TURN_FRAMES} frames "
          f"a turn: megakernel {by_route['mega']}, rolled executor {by_route['rolled']}; "
          f"the rolled frame vs the plain mega walk max |diff| {rolled_err:.3e} {tag}",
          flush=True)
    if not rolled_err <= TOL:
        fail(f"{which}: the rolled frame differs from the mega frame by {rolled_err}")
    return dict(launches=counts, err=max(errs[0], frame_err), kernel_ms=kernel_ms,
                device_ms=device_ms, plain_ms=plain_ms, work=work, ms_per_frame=med(total_ms),
                mega_ms=med(by_route["mega"]), rolled_ms=med(by_route["rolled"]),
                bin_launches=bins, borderline=border)


FONT_SHA256 = "abdc775b21b1bc470d50c97e790d276f2054b7504e56e5bd3e64f48d68582322"
TEXT_TREE_ROWS = 60  # the text table tree of the walks' check: 60x6 cells


def text_host_phase(tag: str, dev) -> dict:
    """The port's own text pipeline on the card's host, from the font in the
    checkout (no fontTools, no PIL, no stored plan):

    1. DejaVuSans.ttf from figdraw_tpu_torch/fonts, its sha256 checked; the
       face load timed (the OpenType reader and the cmap);
    2. bench_text's scene (scenes.make_text_scene: 1200x800, 36 lines at
       15 px, seed 0, atlas_size=512) typeset cold, then warm, its glyphs
       rasterized on the cold miss; through render_frame: the packed combo
       and the atlas against the stored text_1200x800.npz byte for byte,
       FRAMES frames with the counts set to 0 just before and read just
       after (K1-atlas and one binning a frame), K1-atlas against its plain
       version on the frame's own inputs, the frame against the stored
       block means; the warm frame split into scene build, walk, glyph
       check, upload and executor;
    3. the text table (scenes.make_text_table_scene, 1200x800, 180x6)
       walked by the Python walk and planned: the tape against the stored
       textclip_1200x800.npz byte for byte but the sign of zero (the JAX
       Python walk's integer snap), TREE_FRAMES frames of its plan on the
       megakernel with the atlas, counted; K4-atlas against its plain
       version and the frame against the stored block means;
    4. a text table tree (TEXT_TREE_ROWS x 6 at 1200x800) through
       render_frame at 1x, pixel_scale=2 and UI scale 2: the Python walk's
       combo against the native walk's of the same arrays byte for byte,
       each frame counted (K4-atlas once) and its kernel held against its
       plain version."""
    import hashlib

    import numpy as np
    import torch

    from figdraw_tpu_torch import Color, FigRenderer, fill, rgba, vec2
    from figdraw_tpu_torch.basics import fig_ui_scale, set_fig_ui_scale
    from figdraw_tpu_torch.executor import get_frame_executor, get_mega_executor
    from figdraw_tpu_torch.ops import mega, raster
    from figdraw_tpu_torch.plan import pack_walked_tape, plan_execution
    from figdraw_tpu_torch.scenes import (
        TEXT_REFERENCE, TEXT_TABLE_REFERENCE, make_text_scene, make_text_table_scene,
    )
    from figdraw_tpu_torch.text import layout
    from figdraw_tpu_torch.text.typefaces import (
        FigFont, Typeface, bundled_font_path, get_typeface, load_typeface,
    )

    med = statistics.median
    out = {}
    # --- 1. the font ---
    path = bundled_font_path()
    with open(path, "rb") as fh:
        data = fh.read()
    digest = hashlib.sha256(data).hexdigest()
    print(f"check 12: font {os.path.relpath(path)}: {len(data)} bytes, sha256 {digest} "
          f"({'as expected' if digest == FONT_SHA256 else 'UNEXPECTED'})", flush=True)
    if digest != FONT_SHA256:
        fail(f"the bundled font's sha256 is {digest}, expected {FONT_SHA256}")
    load_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        Typeface(path, data, 0)
        load_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    tid = load_typeface(path)
    registry_ms = (time.perf_counter() - t0) * 1e3
    tf = get_typeface(tid)
    print(f"times: face load (the port's OpenType reader: tables, glyph names, cmap; "
          f"{len(tf._glyph_order)} glyphs) median {med(load_ms):.3f} ms of 5, "
          f"load_typeface (file read, sha256 id, load) {registry_ms:.3f} ms {tag}", flush=True)

    # --- 2. bench_text's scene through render_frame ---
    ink = fill(rgba(20, 20, 30, 255))
    t0 = time.perf_counter()
    scene, n_glyphs = make_text_scene(tid, ink, 0)
    cold_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    make_text_scene(tid, ink, 0)
    cached_ms = (time.perf_counter() - t0) * 1e3
    warm_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        for row in range(36):
            layout.typeset(vec2(1180, 22), [(FigFont(typeface_id=tid, size=15.0), ink,
                "The quick brown fox jumps over the lazy dog near the riverbank %d" % row)])
        warm_ms.append((time.perf_counter() - t0) * 1e3)
    size = vec2(1200, 800)
    ren = FigRenderer(atlas_size=512, device="cuda")
    before = len(ren.atlas.entries)
    t0 = time.perf_counter()
    ren._ensure_packed_glyphs(scene)
    raster_ms = (time.perf_counter() - t0) * 1e3
    n_raster = len(ren.atlas.entries) - before
    print(f"times: bench_text typesetting, 36 lines ({n_glyphs} glyphs): cold "
          f"{cold_ms:.3f} ms (the first typeset: the shaper's GSUB/GPOS tables decoded, "
          f"typeset_cached), warm {med(warm_ms):.3f} ms (typeset, uncached, median of 3), "
          f"cached {cached_ms:.3f} ms (typeset_cached hits, as bench_text's frame loop "
          f"builds its scene); cold glyph raster {raster_ms:.3f} ms for {n_raster} glyphs, "
          f"{raster_ms / max(n_raster, 1):.3f} ms a glyph {tag}", flush=True)
    plan = ren._walk_plan(scene, size, True, Color(1.0, 1.0, 1.0, 1.0))
    with np.load(TEXT_REFERENCE) as z:
        same_combo = np.array_equal(plan.combo.view(np.uint32), z["combo"].view(np.uint32))
        same_atlas = np.array_equal(ren.atlas.data, z["atlas"])
        blocks = z["blocks"].copy()
    print(f"check 12: bench_text scene built by the port: packed combo {plan.combo.shape} "
          f"{'equal' if same_combo else 'DIFFERS'} to the stored plan's byte for byte, "
          f"atlas {ren.atlas.data.shape} {'equal' if same_atlas else 'DIFFERS'} byte for "
          f"byte", flush=True)
    if not (same_combo and same_atlas):
        fail("bench_text built by the port differs from the stored plan or atlas")
    ren.render_frame(scene, size)  # the first frame uploads the atlas
    torch.cuda.synchronize()
    zero_counts()
    total_ms = timed_frames("text host", lambda: ren.render_frame(scene, size), (800, 1200, 4))
    counts = launch_counts()
    bins = binning_launches("text host", FRAMES)
    frame = ren.last_frame
    want = (0, FRAMES, 0, 0, 0)
    print(f"check 12: bench_text scene, {FRAMES} frames through render_frame on cuda, "
          f"finite; launches {counts} (expected {want}); binning {bins}", flush=True)
    if counts != want:
        fail(f"text host launched {counts}, expected {want}")
    border = binning_check("text host", lambda: ren.render_frame(scene, size))
    run = get_frame_executor(plan.structure, plan.height, plan.width, plan.n_masks,
                             plan.has_init_frame, plan.tile_h)
    combo = torch.from_numpy(plan.combo).to(dev, copy=True)
    atlas = ren._device_atlas()
    errs, calls = [], []
    run(combo, None, atlas=atlas,
        draw=compared(raster.draw_pass_planar_prebinned,
                      raster.draw_pass_planar_prebinned_plain, errs, calls, "text host"))
    ref = run(combo, None, atlas=atlas, draw=raster.draw_pass_planar_prebinned_plain)
    torch.cuda.synchronize()
    frame_err = float((frame - ref).abs().max())
    err_ref = float(np.abs(block_means(frame.cpu().numpy()) - blocks).max())
    print(f"check 12: bench_text scene: K1-atlas vs plain max |diff| {max(errs):.3e}, "
          f"frame vs the plain executor {frame_err:.3e}, frame vs the JAX reference (8x8 "
          f"block means) {err_ref:.3e} (tol {TOL:.3e})", flush=True)
    if not (max(errs) <= TOL and frame_err <= TOL and err_ref <= TOL):
        fail(f"text host: kernel, frame or reference differs ({max(errs)}, {frame_err}, "
             f"{err_ref})")
    args, kw = calls[0]
    kernel_ms = cuda_ms(lambda: raster.draw_pass_planar_prebinned(*args, **kw), 20)
    parts = {"build": [], "glyphs": [], "walk": [], "upload": [], "executor": []}
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        step_scene, _n = make_text_scene(tid, ink, 0)
        t1 = time.perf_counter()
        ren._ensure_packed_glyphs(step_scene)
        t2 = time.perf_counter()
        step = ren._walk_plan(step_scene, size, True, Color(1.0, 1.0, 1.0, 1.0))
        t3 = time.perf_counter()
        up = ren._upload(step.combo)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        ren._run_plan(step, up)
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        for key, a, b in (("build", t0, t1), ("glyphs", t1, t2), ("walk", t2, t3),
                          ("upload", t3, t4), ("executor", t4, t5)):
            parts[key].append((b - a) * 1e3)
    split = {k: med(v) for k, v in parts.items()}
    print(f"times: bench_text scene through render_frame: median "
          f"{med(total_ms):.3f} ms/frame (warm; render_frame + sync); its parts, "
          f"median of {FRAMES}: scene build {split['build']:.3f} ms (typeset_cached, "
          f"from_renders), glyph check {split['glyphs']:.3f} ms, walk and plan "
          f"{split['walk']:.3f} ms, upload {split['upload']:.3f} ms, executor "
          f"{split['executor']:.3f} ms; its draw kernel {kernel_ms:.4f} ms, "
          f"{bound_text(raster_work(args, kw))} {tag}", flush=True)
    out.update(launches=counts, err=max(max(errs), frame_err), bin_launches=bins,
               borderline=border, kernel_ms=kernel_ms, ms_per_frame=med(total_ms),
               split=split, face_load_ms=med(load_ms), typeset_cold_ms=cold_ms,
               typeset_warm_ms=med(warm_ms), typeset_cached_ms=cached_ms,
               raster_ms_per_glyph=raster_ms / max(n_raster, 1))

    # --- 3. the text table, walked and planned by the port ---
    tsize = vec2(TABLE_W, TABLE_H)
    t0 = time.perf_counter()
    tree = make_text_table_scene(TABLE_ROWS, TABLE_COLS, float(TABLE_W), float(TABLE_H),
                                 tid=tid)
    t1 = time.perf_counter()
    tren = FigRenderer(atlas_size=512, device="cuda")
    tape = tren.flatten(tree, tsize)
    t2 = time.perf_counter()
    pack_walked_tape(tape)
    tplan = plan_execution(tape)
    t3 = time.perf_counter()
    with np.load(TEXT_TABLE_REFERENCE) as z:
        stored, stored_atlas, tblocks = z["combo"], z["atlas"], z["blocks"].copy()
    wa, wb = tape.combo.view(np.uint32), stored.view(np.uint32)
    same_shape = wa.shape == wb.shape
    diff = (wa != wb) if same_shape else np.ones(1, bool)
    zeros = ((wa | wb) & np.uint32(0x7FFFFFFF)) == 0 if same_shape else np.zeros(1, bool)
    same_table = same_shape and not (diff & ~zeros).any()
    same_tatlas = np.array_equal(tren.atlas.data, stored_atlas)
    print(f"check 12: text table built by the port ({tape.count} quads, "
          f"{len(tape.items)} items): tape combo {tape.combo.shape} "
          f"{'equal' if same_table else 'DIFFERS'} to the stored JAX tape byte for byte "
          f"but {int((diff & zeros).sum())} zeros of the other sign (the JAX Python walk "
          f"snaps to ints), atlas {'equal' if same_tatlas else 'DIFFERS'} byte for byte; "
          f"planned to the megakernel with the atlas: {tplan.mega_atlas}", flush=True)
    if not (same_table and same_tatlas and tplan.mega_atlas):
        fail("the text table built by the port differs from the stored tape or atlas")
    tren.execute_plan(tplan)
    torch.cuda.synchronize()
    zero_counts()
    table_ms = timed_frames("text table host", lambda: tren.execute_plan(tplan),
                            (TABLE_H, TABLE_W, 4), frames=TREE_FRAMES)
    tcounts = launch_counts()
    tbins = binning_launches("text table host", TREE_FRAMES)
    twant = (0, 0, 0, 0, TREE_FRAMES)
    tframe = tren.last_frame
    print(f"check 12: text table, {TREE_FRAMES} frames of its plan through execute_plan: "
          f"launches {tcounts} (expected {twant}); binning {tbins}", flush=True)
    if tcounts != twant:
        fail(f"text table host launched {tcounts}, expected {twant}")
    tborder = binning_check("text table host", lambda: tren.execute_plan(tplan))
    mrun = get_mega_executor(tplan.height, tplan.width, tplan.n_masks,
                             tplan.has_init_frame, tplan.tile_h)
    mcombo = torch.from_numpy(tplan.mega_combo).to(dev, copy=True)
    flags = dict(atlas=tren._device_atlas(), pixelate=tren.pixelate)
    terrs, tcalls = [], []
    mrun(mcombo, None, **flags,
         draw=compared(mega.draw_pass_mega, mega.draw_pass_mega_plain, terrs, tcalls,
                       "text table host", targets=MEGA_TARGETS))
    tref = mrun(mcombo, None, **flags, draw=mega.draw_pass_mega_plain)
    torch.cuda.synchronize()
    tframe_err = float((tframe - tref).abs().max())
    terr_ref = float(np.abs(block_means(tframe.cpu().numpy()) - tblocks).max())
    print(f"check 12: text table: K4-atlas vs plain max |diff| {terrs[0]:.3e}, frame vs "
          f"the plain executor {tframe_err:.3e}, frame vs the JAX reference (8x8 block "
          f"means) {terr_ref:.3e} (tol {TOL:.3e})", flush=True)
    if not (terrs[0] <= TOL and tframe_err <= TOL and terr_ref <= TOL):
        fail(f"text table host: kernel, frame or reference differs ({terrs}, "
             f"{tframe_err}, {terr_ref})")
    targs, tkw = tcalls[0]
    texec_ms = cuda_ms(lambda: mrun(mcombo, None, **flags), 10)
    print(f"times: text table {TABLE_ROWS}x{TABLE_COLS} at {TABLE_W}x{TABLE_H}: tree "
          f"build ({TABLE_ROWS * TABLE_COLS} typesets) {(t1 - t0) * 1e3:.1f} ms, Python walk (glyphs "
          f"rasterized on the way) {(t2 - t1) * 1e3:.1f} ms, plan (pack and megakernel "
          f"combo) {(t3 - t2) * 1e3:.1f} ms, execute_plan + sync median "
          f"{med(table_ms):.3f} ms, executor {texec_ms:.4f} ms (device, CUDA events) "
          f"{tag}", flush=True)
    out.update(table_launches=tcounts, table_err=max(terrs[0], tframe_err),
               table_bin_launches=tbins, table_borderline=tborder,
               table_build_ms=(t1 - t0) * 1e3, table_walk_ms=(t2 - t1) * 1e3,
               table_plan_ms=(t3 - t2) * 1e3, table_exec_ms=texec_ms,
               table_ms=med(table_ms))

    # --- 4. a text tree at 1x, pixel_scale=2 and UI scale 2 ---
    out["tree"] = {}
    tree = make_text_table_scene(TEXT_TREE_ROWS, TABLE_COLS, float(TABLE_W),
                                 float(TABLE_H), tid=tid)
    for form, (ps, ui, mult) in (("1x", (1.0, 1.0, 1)), ("pixel2", (2.0, 1.0, 2)),
                                 ("ui2", (1.0, 2.0, 1))):
        old = fig_ui_scale()
        set_fig_ui_scale(ui)
        try:
            fsize = vec2(TABLE_W * mult, TABLE_H * mult)
            fren = FigRenderer(atlas_size=512, pixel_scale=ps, device="cuda")
            walks = tree_equal_walks(f"text {form}", tree, fsize, ren=fren,
                                     label="check 12")
            zero_counts()
            t0 = time.perf_counter()
            fframe = fren.render_frame(tree, fsize)
            torch.cuda.synchronize()
            f_ms = (time.perf_counter() - t0) * 1e3
            fcounts = launch_counts()
            fbins = binning_launches(f"text tree {form}", 1)
            shape = (int(TABLE_H * mult * ui), int(TABLE_W * mult * ui), 4)
            print(f"check 12: text tree {form}: frame {tuple(fframe.shape)} (expected "
                  f"{shape}); launches {fcounts} (expected (0, 0, 0, 0, 1)); binning "
                  f"{fbins}; render_frame + sync {f_ms:.3f} ms {tag}", flush=True)
            if fcounts != (0, 0, 0, 0, 1) or tuple(fframe.shape) != shape:
                fail(f"text tree {form}: launches {fcounts} or shape {tuple(fframe.shape)}")
            # the kernels against their plain versions on this frame's own
            # inputs (tree_kernel_checks walks at the frame's size, which UI
            # scale 2 changes under it: 1x and pixel_scale=2, as tree_phase)
            errs_f = {}
            if ui == 1.0:
                tree_kernel_checks(f"text tree {form}", fren, tree, fsize, errs_f)
            out["tree"][form] = {"launches": fcounts, "bin_launches": fbins,
                                 "err": max([max(v) for v in errs_f.values()
                                             if isinstance(v, list) and v] or [0.0]),
                                 "ms": f_ms, **walks}
        finally:
            set_fig_ui_scale(old)
    return out


def mega_clamps_check(dev) -> None:
    """K4 and K4-atlas against their plain versions on a seeded tape that
    drives every clamp of the walk (scenes.mega_modes_tape: reads, targets
    and clears out of range, and quads that target plane 0, which the
    kernel's cull must keep in every block)."""
    import numpy as np
    import torch

    from figdraw_tpu_torch.ops import mega
    from figdraw_tpu_torch.ops.binning import bin_quads
    from figdraw_tpu_torch.scenes import mega_modes_tape

    w, h = 512, 256
    errs = []
    for n_masks, th, size in ((1, 128, None), (3, 64, None), (3, 32, 256), (4, 128, 64)):
        fields, modes, atlas = (
            None if a is None else torch.from_numpy(a).to(dev)
            for a in mega_modes_tape(n_masks, n_masks * 1000 + th, w, h, size))
        tile_idx, tile_counts = bin_quads(fields, 0, fields.shape[0], h // th, w // 128,
                                          th, 128)
        planes = torch.from_numpy(np.random.RandomState(th).rand(4, h, w)
                                  .astype(np.float32)).to(dev)
        args = (fields, modes, tile_idx, tile_counts)
        got = mega.draw_pass_mega(*args, planes.clone(), n_masks, tile_h=th, atlas=atlas)
        ref = mega.draw_pass_mega_plain(*args, planes, n_masks, tile_h=th, atlas=atlas)
        torch.cuda.synchronize()
        errs.append(float((got - ref).abs().max()))
        if not float((ref - planes).abs().max()) > 0.1:
            fail("the clamps tape drew nothing")
    print(f"check: K4 / K4-atlas vs plain on the seeded clamps tape (planes out of "
          f"range, targets of plane 0) max |diff| {max(errs):.3e} (tol {TOL:.3e})",
          flush=True)
    if not max(errs) <= TOL:
        fail(f"the megakernel differs from plain on the clamps tape: {errs}")


def rolled_phase(tag: str, dev) -> dict:
    """images_clipped at 1920x1080 with 400 panels (1201 pass items) on the
    rolled form of the frame executor (plan.plan_rolled of the port's own
    tape) for FRAMES frames through flatten, plan and execute_plan; K1,
    K1-atlas and K3 against their plain versions on one frame's inputs, the
    frame against the rolled executor with the plain versions, the 480x270,
    25-panel frame against the stored JAX block means."""
    import torch

    from figdraw_tpu_torch import vec2
    from figdraw_tpu_torch.executor import get_frame_executor
    from figdraw_tpu_torch.ops import raster
    from figdraw_tpu_torch.plan import plan_rolled
    from figdraw_tpu_torch.scenes import image_reference_path, make_image_panels_scene

    size = vec2(IMAGE_W, IMAGE_H)
    scene = make_image_panels_scene(IMAGE_W, IMAGE_H, IMAGE_PANELS, "images_clipped")
    ren = image_renderer()
    ren.process_image_messages()

    def rolled_frame(scene=scene, size=size, ren=ren):
        return ren.execute_plan(plan_rolled(ren.flatten(scene, size)))

    rolled_frame()
    torch.cuda.synchronize()
    zero_counts()
    total_ms = timed_frames("rolled", rolled_frame, (IMAGE_H, IMAGE_W, 4))
    counts = launch_counts()
    bins = binning_launches("rolled", FRAMES)
    frame = ren.last_frame
    want = (FRAMES, FRAMES * IMAGE_PANELS, FRAMES * IMAGE_PANELS, 0, 0)
    tape = ren.flatten(scene, size)
    plan = plan_rolled(tape)
    print(f"check rolled: images_clipped {IMAGE_PANELS} panels, {len(plan.structure)} "
          f"pass items, {tape.count} quads, {plan.n_masks} planes, tile_h "
          f"{plan.tile_h}, {FRAMES} frames finite; launches K1 {counts[0]}, K1-atlas "
          f"{counts[1]}, K3 {counts[2]}, K4 {counts[3]}, K4-atlas {counts[4]} "
          f"(expected {want})", flush=True)
    if counts != want or plan.rolled_items is None:
        fail(f"rolled launched {counts}, expected {want}")
    border = binning_check("rolled", rolled_frame)
    run = get_frame_executor(plan.structure, plan.height, plan.width, plan.n_masks,
                             plan.has_init_frame, plan.tile_h, rolled=True)
    combo = torch.from_numpy(plan.combo).to(dev, copy=True)
    table = dict(items=plan.rolled_items, radii=plan.rolled_radii)
    atlas = ren._device_atlas()
    e1, e3, a1, a3 = [], [], [], []
    t0 = time.perf_counter()
    run(combo, None, atlas=atlas, **table,
        draw=compared(raster.draw_pass_planar_prebinned,
                      raster.draw_pass_planar_prebinned_plain, e1, a1, "rolled"),
        draw_mask=compared(raster.draw_pass_mask_prebinned,
                           raster.draw_pass_mask_prebinned_plain, e3, a3, "rolled"))
    ref = run(combo, None, atlas=atlas, **table,
              draw=raster.draw_pass_planar_prebinned_plain,
              draw_mask=raster.draw_pass_mask_prebinned_plain)
    torch.cuda.synchronize()
    frame_err = float((frame - ref).abs().max())
    print(f"check rolled: {len(a1)} frame and {len(a3)} mask passes; K1 / K1-atlas "
          f"vs plain max |diff| {max(e1):.3e}, K3 vs plain {max(e3):.3e}, frame "
          f"{FRAMES} vs the plain executor {frame_err:.3e} (tol {TOL:.3e}; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    if not (max(e1) <= TOL and max(e3) <= TOL and frame_err <= TOL):
        fail(f"rolled: a kernel or the frame differs from plain "
             f"({max(e1)}, {max(e3)}, {frame_err})")
    small_ren = image_renderer()
    small_ren.process_image_messages()
    small = rolled_frame(
        make_image_panels_scene(SMALL_W, SMALL_H, SMALL_PANELS, "images_clipped"),
        vec2(SMALL_W, SMALL_H), small_ren)
    check_blocks(f"rolled images_clipped {SMALL_W}x{SMALL_H}, {SMALL_PANELS} panels",
                 small, image_reference_path("images_clipped"))
    exec_ms = cuda_ms(lambda: run(combo, None, atlas=atlas, **table), 5)
    k_atlas = [(a, k) for a, k in a1 if k.get("atlas") is not None]

    def atlas_loop():
        for a, k in k_atlas:
            raster.draw_pass_planar_prebinned(*a, **k)

    def mask_loop():
        for a, k in a3:
            raster.draw_pass_mask_prebinned(*a, **k)

    # CUDA events around the host loops of wrapper calls: the host's cost
    atlas_host_ms, mask_host_ms = cuda_ms(atlas_loop, 5), cuda_ms(mask_loop, 5)
    # the kernels' own device time: torch.profiler, and a CUDA graph replay
    prof = kernel_device_ms(lambda: (atlas_loop(), mask_loop()))
    atlas_dev = [v for k, v in prof.items() if "raster_tiles_kernel<false, true>" in k]
    mask_dev = [v for k, v in prof.items() if "raster_tiles_kernel<true" in k]
    atlas_dev_ms, mask_dev_ms = sum(v[0] for v in atlas_dev), sum(v[0] for v in mask_dev)
    atlas_graph_ms, mask_graph_ms = graph_ms(atlas_loop), graph_ms(mask_loop)
    atlas_work = sum(raster_work(a, k) for a, k in k_atlas)
    mask_work = sum(raster_work(a, k, mask_target=True) for a, k in a3)
    # the frame's two halves: the host walk and plan, then execute_plan (the
    # upload and the executor's host loop of 1201 items) to the sync
    host_ms, execute_ms = [], []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        step = plan_rolled(ren.flatten(scene, size))
        t1 = time.perf_counter()
        ren.execute_plan(step)
        torch.cuda.synchronize()
        host_ms.append((t1 - t0) * 1e3)
        execute_ms.append((time.perf_counter() - t1) * 1e3)
    print(f"times: rolled: median {statistics.median(total_ms):.3f} ms/frame "
          f"(flatten, plan, execute_plan + sync) = host walk and plan "
          f"{statistics.median(host_ms):.3f} "
          f"ms + execute_plan and sync {statistics.median(execute_ms):.3f} ms; whole "
          f"executor {exec_ms:.3f} ms (CUDA events) {tag}", flush=True)
    print(f"times: rolled: its {len(k_atlas)} K1-atlas launches: device "
          f"{atlas_dev_ms:.3f} ms ({sum(v[1] for v in atlas_dev):g} kernels a run, "
          f"torch.profiler), CUDA graph replay {atlas_graph_ms:.3f} ms, host loop "
          f"{atlas_host_ms:.3f} ms (host time: CUDA events around the wrapper "
          f"calls); {bound_text(atlas_work)} {tag}", flush=True)
    print(f"times: rolled: its {len(a3)} K3 launches: device {mask_dev_ms:.3f} ms "
          f"({sum(v[1] for v in mask_dev):g} kernels a run, torch.profiler), CUDA "
          f"graph replay {mask_graph_ms:.3f} ms, host loop {mask_host_ms:.3f} ms "
          f"(host time); {bound_text(mask_work)} {tag}", flush=True)
    if not (len(k_atlas) == len(a3) == IMAGE_PANELS and atlas_dev_ms > 0 and mask_dev_ms > 0):
        fail(f"rolled: the profiler saw no device time for the {len(k_atlas)} "
             f"K1-atlas and {len(a3)} K3 launches; it saw {sorted(prof)[:20]}")
    return dict(launches=counts, k1_err=max(e1), k3_err=max(e3), frame_err=frame_err,
                ms_per_frame=statistics.median(total_ms), bin_launches=bins,
                borderline=border)


def clip_table_phase(kind: str, tag: str, dev) -> dict:
    """Render bench_clipmask's `kind` table (1200x800, 180x6) for FRAMES
    frames through render_frame, with every launch count set to 0 just
    before and read just after; check the frames and the counts; hold each
    kernel of the path against its plain version on the frame's own inputs
    and the last frame against the same executor run with the plain
    versions; hold a 12x6 table at 320x200 against figdraw_tpu's stored
    block means. Returns the numbers the summary needs."""
    import numpy as np
    import torch

    from figdraw_tpu_torch import FigRenderer, native, vec2
    from figdraw_tpu_torch.executor import get_frame_executor, get_mega_executor
    from figdraw_tpu_torch.ops import mega, raster
    from figdraw_tpu_torch.plan import plan_execution, tile_h_from_density
    from figdraw_tpu_torch.scenes import make_clip_table_scene

    size = vec2(TABLE_W, TABLE_H)
    scene = make_clip_table_scene(kind, TABLE_W, TABLE_H, TABLE_ROWS, TABLE_COLS)
    ren = FigRenderer(device="cuda")
    ren.render_frame(scene, size)  # the first frame builds the executor
    torch.cuda.synchronize()
    zero_counts()
    total_ms = timed_frames(kind, lambda: ren.render_frame(scene, size),
                            (TABLE_H, TABLE_W, 4))
    frame = ren.last_frame
    k1, k1_atlas, k3, k4, k4_atlas = launch_counts()
    bins = binning_launches(f"{kind} table", FRAMES)
    counts = (k1, k3, k4)
    want = (2 * FRAMES, FRAMES, 0) if kind == "rectmask" else (0, 0, FRAMES)
    print(f"check 6: {kind} table {TABLE_ROWS}x{TABLE_COLS} at {TABLE_W}x{TABLE_H}, "
          f"{FRAMES} frames finite; launches K1 {counts[0]}, K3 {counts[1]}, "
          f"K4 {counts[2]}, K1-atlas {k1_atlas}, K4-atlas {k4_atlas} (expected "
          f"{want}, 0, 0)", flush=True)
    if counts != want or k1_atlas or k4_atlas:
        fail(f"{kind} table launched (K1, K3, K4) {counts}, K1-atlas {k1_atlas} "
             f"and K4-atlas {k4_atlas}, expected {want}, 0 and 0")
    border = binning_check(f"{kind} table", lambda: ren.render_frame(scene, size))
    walk_ms = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        native.flatten_fast(scene, TABLE_W, TABLE_H, 1.0, 1.0, ren.aa_factor,
                            (1.0, 1.0, 1.0, 1.0))
        walk_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"times: {kind} table: median {statistics.median(total_ms):.3f} ms/frame "
          f"(render_frame + sync; host walk and export alone "
          f"{statistics.median(walk_ms):.3f} ms) {tag}", flush=True)

    out = {"launches": counts, "ms_per_frame": statistics.median(total_ms),
           "bin_launches": bins, "borderline": border}

    if kind == "rectmask":
        tape = ren.flatten(scene, size)
        plan = plan_execution(tape)
        run = get_frame_executor(plan.structure, plan.height, plan.width,
                                 plan.n_masks, plan.has_init_frame, plan.tile_h)
        combo = torch.from_numpy(plan.combo).to(dev, copy=True)
        e1, e3, a1, a3 = [], [], [], []
        run(combo, None,
            draw=compared(raster.draw_pass_planar_prebinned,
                          raster.draw_pass_planar_prebinned_plain, e1, a1, kind),
            draw_mask=compared(raster.draw_pass_mask_prebinned,
                               raster.draw_pass_mask_prebinned_plain, e3, a3, kind))
        ref = run(combo, None, draw=raster.draw_pass_planar_prebinned_plain,
                  draw_mask=raster.draw_pass_mask_prebinned_plain)
        if (len(e1), len(e3)) != (2, 1):
            fail(f"the rect-mask plan ran {len(e1)} frame and {len(e3)} mask "
                 "passes, expected 2 and 1")
        out.update(k1_err=max(e1), k3_err=e3[0], k1_args=a1,
                   k3_args=a3[0][0] + (a3[0][1]["tile_h"],),
                   k3_work=raster_work(*a3[0], mask_target=True))
        print(f"check 6: rect-mask plan {[it[:2] for it in plan.structure]}, "
              f"{tape.count} quads in {tape.combo_quads} rows, tile_h "
              f"{plan.tile_h}; K1 vs plain max |diff| {max(e1):.3e}, K3 vs "
              f"plain {e3[0]:.3e} (tol {TOL:.3e})", flush=True)
        if not (max(e1) <= TOL and e3[0] <= TOL):
            fail(f"rect-mask table: K1 or K3 differs from its plain version "
                 f"({max(e1)}, {e3[0]})")
    else:
        _, combo_np, mask_count, density = native.flatten_fast(
            scene, TABLE_W, TABLE_H, 1.0, 1.0, ren.aa_factor, (1.0, 1.0, 1.0, 1.0))
        combo_np[-1, 0:4] = 1.0  # the meta row: render_frame's white clear
        th = tile_h_from_density(*density, TABLE_H, TABLE_W)
        run = get_mega_executor(TABLE_H, TABLE_W, mask_count + 1, False, th)
        combo = torch.from_numpy(combo_np).to(dev, copy=True)
        e4, a4 = [], []
        run(combo, None, draw=compared(mega.draw_pass_mega,
                                       mega.draw_pass_mega_plain, e4, a4, kind,
                                       targets=MEGA_TARGETS))
        ref = run(combo, None, draw=mega.draw_pass_mega_plain)
        out.update(k4_err=e4[0], k4_args=a4[0][0] + (a4[0][1]["tile_h"],))
        out["k4_work"] = mega_work(*a4[0])
        print(f"check 6: sub-clip mega combo {tuple(combo_np.shape)}, "
              f"{mask_count + 1} mask planes, tile_h {th}; K4 vs plain max "
              f"|diff| {e4[0]:.3e} (tol {TOL:.3e}); {bound_text(out['k4_work'])}",
              flush=True)
        if not e4[0] <= TOL:
            fail(f"sub-clip table: K4 differs from its plain version by {e4[0]}")
    # the executor's stages on the frame's own inputs (device, CUDA events)
    stages = front_stages(f"{kind} table")
    stages["whole executor"] = cuda_ms(lambda: run(combo, None), 20)
    print(f"times: {kind} executor stages: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in stages.items()) + f" (device, CUDA events) {tag}",
        flush=True)
    torch.cuda.synchronize()
    out["frame_err"] = float((frame - ref).abs().max())
    print(f"check 6: {kind} frame {FRAMES} vs the same executor with plain "
          f"kernels max |diff| {out['frame_err']:.3e} (tol {TOL:.3e})", flush=True)
    if not out["frame_err"] <= TOL:
        fail(f"{kind} frame differs from the plain-kernel executor by "
             f"{out['frame_err']}")

    small = FigRenderer(device="cuda").render_frame(
        make_clip_table_scene(kind, 320, 200, 12, 6), vec2(320, 200))
    want_blocks = np.load(os.path.join(REF_DIR, f"cliptable_{kind}_320x200_blocks8.npy"))
    err_ref = float(np.abs(block_means(small.cpu().numpy()) - want_blocks).max())
    print(f"check 6: {kind} 12x6 table at 320x200 vs the JAX reference (8x8 "
          f"block means) max |diff| {err_ref:.3e} (tol {TOL:.3e})", flush=True)
    if not err_ref <= TOL:
        fail(f"{kind} table differs from the JAX reference by {err_ref}")
    return out


TREE_FRAMES = 5  # the clip tables as trees: frames through the Python walk


def expected_launches(plan) -> tuple:
    """(K1, K3, K4) launches one frame of a plan makes: a frame-target draw
    run launches K1, a mask-target run K3, a mega plan K4 once."""
    if plan.mega_combo is not None:
        return (0, 0, 1)
    draws = [it for it in plan.structure if it[0] == "draw"]
    return (sum(it[1] == -1 for it in draws), sum(it[1] >= 0 for it in draws), 0)


def recorded_blur(errs: list):
    """A stand-in for the executor's backdrop_blur_planar that also runs the
    plain blur on the same planes and records max |kernel - plain| (the
    kernel must equal it bit for bit); restore with the returned undo."""
    import torch

    from figdraw_tpu_torch import executor
    from figdraw_tpu_torch.ops import blur

    real = executor.backdrop_blur_planar

    def call(planes, radius):
        got = real(planes, radius)
        ref = blur.backdrop_blur_planar_plain(planes, radius)
        torch.cuda.synchronize()
        errs.append(float((got - ref).abs().max()))
        if not torch.equal(got, ref):
            fail(f"blur kernel on a tree frame's planes differs from the plain blur "
                 f"by {errs[-1]}")
        return got

    executor.backdrop_blur_planar = call
    return lambda: setattr(executor, "backdrop_blur_planar", real)


def tree_kernel_checks(what: str, ren, scene, size, errs: dict) -> None:
    """Each kernel of a tree frame's plan against its plain version on the
    frame's own inputs (the walked and planned tape on the card): K1 and K3
    through compared(), the blur through recorded_blur, K4 on the planner's
    megakernel combo; and the binning kernel on the frame's own binning
    call (binning_check)."""
    import torch

    from figdraw_tpu_torch.executor import get_frame_executor, get_mega_executor
    from figdraw_tpu_torch.ops import mega, raster
    from figdraw_tpu_torch.plan import plan_execution

    plan = plan_execution(ren.flatten(scene, size))
    store = []
    ambiguous = errs.setdefault("ambiguous pixels", {}).setdefault(what, [])
    if plan.mega_combo is not None:
        run = get_mega_executor(plan.height, plan.width, plan.n_masks,
                                plan.has_init_frame, plan.tile_h)
        combo = torch.from_numpy(plan.mega_combo).to(ren.device, copy=True)
        run(combo, None, draw=compared(mega.draw_pass_mega, mega.draw_pass_mega_plain,
                                       errs.setdefault("K4", []), store, what,
                                       targets=MEGA_TARGETS, ambiguous=ambiguous))
    else:
        run = get_frame_executor(plan.structure, plan.height, plan.width,
                                 plan.n_masks, plan.has_init_frame, plan.tile_h)
        combo = torch.from_numpy(plan.combo).to(ren.device, copy=True)
        undo = recorded_blur(errs.setdefault("blur", []))
        try:
            run(combo, None,
                draw=compared(raster.draw_pass_planar_prebinned,
                              raster.draw_pass_planar_prebinned_plain,
                              errs.setdefault("K1", []), store, what,
                              ambiguous=ambiguous),
                draw_mask=compared(raster.draw_pass_mask_prebinned,
                                   raster.draw_pass_mask_prebinned_plain,
                                   errs.setdefault("K3", []), store, what,
                                   ambiguous=ambiguous))
        finally:
            undo()
    worst = {k: max(v) for k, v in errs.items() if v and k in ("K1", "K3", "K4")}
    if any(v > TOL for v in worst.values()):
        fail(f"{what}: a kernel differs from its plain version: {worst}")
    BORDERLINE[what] = binning_check(what, lambda: ren.render_frame(scene, size))


def tree_equal_walks(what: str, tree, size, ren=None, label: str = "check 10") -> dict:
    """On one renderer (a new one unless given; glyphs land in its atlas in
    load order), from_renders(tree) through the native walk first, whose
    glyph check loads every glyph the arrays hold, then to_renders of those
    arrays through the Python walk: the packed combos (and megakernel
    combos) byte for byte, and the two render_frame frames bit for bit on
    the card."""
    import torch

    from figdraw_tpu_torch import FigRenderer, from_renders, to_renders
    from figdraw_tpu_torch.basics import scaled
    from figdraw_tpu_torch.plan import plan_execution

    ren = ren or FigRenderer(device="cuda")
    arr = from_renders(tree)
    walked = to_renders(arr)
    fs = scaled(size)
    nat_tape = ren.flatten(arr, fs)
    nat_plan = plan_execution(nat_tape)
    py_tape = ren.flatten(walked, fs)
    py_plan = plan_execution(py_tape)
    same_combo = py_plan.combo.tobytes() == nat_plan.combo.tobytes()
    same_mega = ((py_plan.mega_combo is None and nat_plan.mega_combo is None)
                 or (py_plan.mega_combo is not None and nat_plan.mega_combo is not None
                     and py_plan.mega_combo.tobytes() == nat_plan.mega_combo.tobytes()))
    nat_frame = ren.render_frame(arr, size)
    py_frame = ren.render_frame(walked, size)
    torch.cuda.synchronize()
    same_frame = torch.equal(py_frame, nat_frame)
    print(f"{label}: {what} tree, {py_tape.count} quads, {len(py_tape.items)} items, "
          f"{py_tape.mask_count} mask planes: Python walk of to_renders(from_renders"
          f"(tree)) vs native walk of from_renders(tree): packed combo "
          f"{'equal' if same_combo else 'DIFFERS'} byte for byte"
          + ("" if nat_plan.mega_combo is None else
             f", megakernel combo {'equal' if same_mega else 'DIFFERS'}")
          + f", render_frame frames {'equal' if same_frame else 'DIFFER'} bit for bit "
          f"(max |diff| {float((py_frame - nat_frame).abs().max()):.3e})", flush=True)
    if not (same_combo and same_mega and same_frame):
        fail(f"{what} tree: the Python walk and the native walk disagree")
    return {"quads": py_tape.count, "items": len(py_tape.items)}


def tree_host_ms(tree, size, frames: int, pixel_scale: float = 1.0) -> dict:
    """Host ms of one frame's walk alone, the Python walk of the tree and the
    native walk (and its export) of from_renders(tree), medians of
    `frames`, and the planner's ms on the walked tape."""
    from figdraw_tpu_torch import FigRenderer, from_renders, native
    from figdraw_tpu_torch.basics import fig_ui_scale, scaled
    from figdraw_tpu_torch.plan import plan_execution

    ren = FigRenderer(device="cuda", pixel_scale=pixel_scale)
    fs = scaled(size)
    arr = from_renders(tree)
    walk, plan, nat = [], [], []
    for _ in range(frames):
        t0 = time.perf_counter()
        tape = ren.flatten(tree, fs)
        t1 = time.perf_counter()
        plan_execution(tape)
        t2 = time.perf_counter()
        native.flatten_fast(arr, fs.x, fs.y, fig_ui_scale(), ren.pixel_scale,
                            ren.aa_factor, (1.0, 1.0, 1.0, 1.0))
        t3 = time.perf_counter()
        walk.append((t1 - t0) * 1e3)
        plan.append((t2 - t1) * 1e3)
        nat.append((t3 - t2) * 1e3)
    return {"walk_ms": statistics.median(walk), "plan_ms": statistics.median(plan),
            "native_walk_ms": statistics.median(nat)}


def tree_phase(tag: str) -> dict:
    """Tree-form scenes (Fig nodes in a Renders) through FigRenderer.render_frame
    and the Python walk, at their sources' full sizes: bench.py's headline
    (1920x1080, 300 boxes; FRAMES frames, each its own animated tree),
    bench_clipmask's rect-mask and sub-clip tables (1200x800, 180x6;
    TREE_FRAMES frames each) and the scenes of examples/layers_clip.py,
    drawable_beziers.py and dashed_dotted_borders.py at their own sizes, at
    pixel_scale=2 and at UI scale 2. Every path is counted with the counts
    set to 0 just before and read just after; each frame's kernels are held
    against their plain versions on its own inputs; the Python walk's frame
    and packed combo against the native walk's; the example frames against
    figdraw_tpu's stored block means; host times of the Python walk, the
    planner and the native walk beside the frame times."""
    import numpy as np
    import torch

    from figdraw_tpu_torch import FigRenderer, from_renders, make_render_tree, vec2
    from figdraw_tpu_torch.basics import fig_ui_scale, set_fig_ui_scale
    from figdraw_tpu_torch.ops import binning, blur
    from figdraw_tpu_torch.plan import plan_execution
    from figdraw_tpu_torch.scenes import (
        EXAMPLE_FORMS, EXAMPLE_IMAGES, EXAMPLE_SCENES, example_reference_path,
        make_clip_table_scene, make_table_scene, render_example,
    )

    out = {"launches": {}, "errs": {}}
    errs = out["errs"]

    def counted(what, frames, plan, blurs_per_frame=0):
        k1, k1_atlas, k3, k4, k4_atlas = launch_counts()
        got = (k1, k3, k4, blur.LAUNCHES)
        e1, e3, e4 = expected_launches(plan)
        want = (e1 * frames, e3 * frames, e4 * frames, blurs_per_frame * frames)
        print(f"check 10: {what} tree, {frames} frames through render_frame: launches "
              f"K1 {k1}, K3 {k3}, K4 {k4}, blur {blur.LAUNCHES}, K1-atlas {k1_atlas}, "
              f"K4-atlas {k4_atlas}, front kernel {binning.DECODE_LAUNCHES}, tile kernel "
              f"{binning.LAUNCHES} (expected {want}, 0, 0, {frames}, {frames})", flush=True)
        if got != want or k1_atlas or k4_atlas:
            fail(f"{what} tree launched (K1, K3, K4, blur) {got}, K1-atlas {k1_atlas}, "
                 f"K4-atlas {k4_atlas}, expected {want}, 0, 0")
        BIN_PATHS[f"tree {what}"] = binning_launches(f"{what} tree", frames)
        out["launches"][what] = {"K1": k1, "K3": k3, "K4": k4, "blur": blur.LAUNCHES}

    # --- bench.py's headline as a tree ---
    size = vec2(WIDTH, HEIGHT)
    t0 = time.perf_counter()
    trees = [make_render_tree(WIDTH, HEIGHT, f, copies=COPIES) for f in range(FRAMES + 1)]
    build_ms = (time.perf_counter() - t0) * 1e3 / len(trees)
    ren = FigRenderer(device="cuda")
    ren.render_frame(trees[0], size)
    torch.cuda.synchronize()
    zero_counts()
    it = iter(trees[1:])
    total_ms = timed_frames("headline tree", lambda: ren.render_frame(next(it), size),
                            (HEIGHT, WIDTH, 4), frames=FRAMES)
    plan = plan_execution(ren.flatten(trees[-1], size))
    counted("headline", FRAMES, plan, blurs_per_frame=2)
    host = tree_host_ms(trees[-1], size, FRAMES)
    arr_ren = FigRenderer(device="cuda")
    arrs = [from_renders(t) for t in trees[1:]]
    arr_ren.render_frame(arrs[0], size)
    ait = iter(arrs)
    arr_ms = timed_frames("headline tree's array", lambda: arr_ren.render_frame(next(ait), size),
                          (HEIGHT, WIDTH, 4), frames=FRAMES)
    exec_ms = cuda_ms(lambda: ren.execute_plan(plan), 10)
    print(f"times: headline tree {WIDTH}x{HEIGHT} {COPIES * 3} boxes, {FRAMES} frames "
          f"through render_frame (Python walk, planner, upload, executor, sync): median "
          f"{statistics.median(total_ms):.3f} ms/frame; Python walk alone "
          f"{host['walk_ms']:.3f} ms, planner alone {host['plan_ms']:.3f} ms, upload and "
          f"executor {exec_ms:.3f} ms (device, CUDA events); tree build "
          f"{build_ms:.3f} ms a frame (make_render_tree, not in the frame); the same "
          f"frames as arrays through render_frame {statistics.median(arr_ms):.3f} "
          f"ms/frame, native walk and export alone {host['native_walk_ms']:.3f} ms {tag}",
          flush=True)
    out["headline"] = {"ms_per_frame": statistics.median(total_ms), "exec_ms": exec_ms,
                       "array_ms_per_frame": statistics.median(arr_ms),
                       "build_ms": build_ms, **host}
    out["headline"].update(tree_equal_walks("headline", trees[-1], size))
    tree_kernel_checks("tree headline", ren, trees[-1], size, errs)

    # --- bench_clipmask's tables as trees ---
    tsize = vec2(TABLE_W, TABLE_H)
    for kind in ("rectmask", "subclip"):
        tree = make_table_scene(kind, TABLE_W, TABLE_H, TABLE_ROWS, TABLE_COLS)
        same_rows = from_renders(tree)[0].view().tobytes() == make_clip_table_scene(
            kind, TABLE_W, TABLE_H, TABLE_ROWS, TABLE_COLS)[0].view().tobytes()
        print(f"check 10: {kind} table tree: from_renders equals scenes."
              f"make_clip_table_scene's rows byte for byte: {same_rows}", flush=True)
        if not same_rows:
            fail(f"{kind} table tree: from_renders differs from make_clip_table_scene's rows")
        ren = FigRenderer(device="cuda")
        ren.render_frame(tree, tsize)
        torch.cuda.synchronize()
        zero_counts()
        total_ms = timed_frames(f"{kind} table tree", lambda: ren.render_frame(tree, tsize),
                                (TABLE_H, TABLE_W, 4), frames=TREE_FRAMES)
        plan = plan_execution(ren.flatten(tree, tsize))
        counted(f"{kind} table", TREE_FRAMES, plan)
        host = tree_host_ms(tree, tsize, TREE_FRAMES)
        print(f"times: {kind} table tree {TABLE_ROWS}x{TABLE_COLS} at {TABLE_W}x{TABLE_H}, "
              f"{TREE_FRAMES} frames through render_frame: median "
              f"{statistics.median(total_ms):.3f} ms/frame; Python walk alone "
              f"{host['walk_ms']:.3f} ms, planner alone {host['plan_ms']:.3f} ms, native "
              f"walk and export of its arrays alone {host['native_walk_ms']:.3f} ms {tag}",
              flush=True)
        out[kind] = {"ms_per_frame": statistics.median(total_ms), **host}
        out[kind].update(tree_equal_walks(f"{kind} table", tree, tsize))
        tree_kernel_checks(f"tree {kind} table", ren, tree, tsize, errs)

    # --- the example scenes, at their sizes and at both scales of 2 (those
    # that draw images: image_files_phase) ---
    out["examples"] = {}
    for name, (build, (w, h)) in EXAMPLE_SCENES.items():
        if name in EXAMPLE_IMAGES:
            continue
        for form, (ps, ui, mult) in EXAMPLE_FORMS.items():
            zero_counts()
            ren, frame = render_example(
                lambda p: FigRenderer(device="cuda", pixel_scale=p), name, form)
            torch.cuda.synchronize()
            shape = (h * mult * (2 if ui == 2 else 1), w * mult * (2 if ui == 2 else 1), 4)
            if tuple(frame.shape) != shape or not bool(torch.isfinite(frame).all()):
                fail(f"{name} {form}: frame of shape {tuple(frame.shape)}, expected {shape}, "
                     "or non-finite")
            ref = np.load(example_reference_path(name, form))
            err = float(np.abs(block_means(frame.cpu().numpy()) - ref).max())
            old = fig_ui_scale()
            set_fig_ui_scale(ui)
            try:
                scene = build(w, h)
                fsize = vec2(w * mult, h * mult)
                plan = plan_execution(ren.flatten(scene, vec2(shape[1], shape[0])))
                counted(f"{name} {form}", 1, plan)
                host = tree_host_ms(scene, fsize, 3, pixel_scale=ps)
                if form == "1x":
                    tree_kernel_checks(f"tree {name}", ren, scene, fsize, errs)
                    host.update(tree_equal_walks(name, scene, fsize))
            finally:
                set_fig_ui_scale(old)
            print(f"check 10: {name} {form} {shape[1]}x{shape[0]} vs the JAX reference "
                  f"(8x8 block means) max |diff| {err:.3e} (tol {TOL:.3e}); Python walk "
                  f"{host['walk_ms']:.3f} ms, planner {host['plan_ms']:.3f} ms, native walk "
                  f"{host['native_walk_ms']:.3f} ms {tag}", flush=True)
            if not err <= TOL:
                fail(f"{name} {form} differs from the JAX reference by {err}")
            out["examples"][f"{name} {form}"] = {"err": err, **host}
    left_out = {k: sum(v) for k, v in errs.pop("ambiguous pixels").items()}
    worst = {k: max(v) for k, v in errs.items() if v}
    print(f"check 10: tree frames' kernels vs their plain versions on the frames' own "
          f"inputs, max |diff| {worst} (tol {TOL:.3e}; the blur bit for bit), "
          f"leaving out the pixels on a quad's uv clip edge or a bezier's evolute "
          f"(ops.raster.ambiguous_pixels): {left_out}", flush=True)
    out["ambiguous"] = left_out
    return out


RESIDENT_FRAMES = 48  # the device-resident benchmarks' sweep length
RESIDENT_SCALES = (100, 4000)  # bench.py's copies: 300 and 12000 boxes
DIRTY_ROOTS = 8  # bench_retained.py's edited roots a frame
# FP32 operations the blur needs for one tap of one pixel: two multiplies and
# an add for the interpolation, a multiply and an add into the sum. A tap's
# position, floor, fraction, clamped texel indices and 1 - fraction (9 more
# operations) depend only on the column in the horizontal pass and on the row
# in the vertical one, so the function needs them once a line position, not
# once a pixel. ROWS_OPS_PER_ROW: one row of csrc/rows.cu with every stage
# on. Counted, not measured.
BLUR_OPS_PER_TAP, BLUR_OPS_PER_POSITION, BLUR_TAPS = 5, 9, 17
ROWS_OPS_PER_ROW = 190


def loop_ms(render, reps: int = 3) -> list:
    """ms/frame of `reps` loops of render(f) for f in range(RESIDENT_FRAMES),
    each loop ended by one synchronize, as the device-resident benchmarks
    time theirs."""
    import torch

    frames = RESIDENT_FRAMES
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in range(frames):
            render(f)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / frames)
    return out


def ms_text(ms: list) -> str:
    return f"{min(ms):.3f} ms/frame (loops of {RESIDENT_FRAMES}: " + ", ".join(
        f"{m:.3f}" for m in ms) + ")"


def rows_check(what: str, scene, d, z, errs: list, table=None, ridx=None,
               rects=None):
    """The row kernel against its plain version on a scene's resident rows:
    fails unless their int32 views are equal and the resident rows are
    untouched. Returns the call's arguments."""
    import torch

    from figdraw_tpu_torch.ops import rows

    resident = scene.combo_dev.clone()
    out = torch.empty_like(scene.combo_dev)
    args = (scene.combo_dev, scene.n_quads, d, z)
    kw = dict(table=table, ridx=ridx, rects=rects)
    got = rows.transform_rows(*args, out, **kw)
    ref = rows.transform_rows_plain(*args, **kw)
    torch.cuda.synchronize()
    differing = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
    moved = int((got.view(torch.int32) != resident.view(torch.int32)).sum())
    print(f"check 8: rows kernel vs plain on the {what} rows "
          f"{tuple(scene.combo_dev.shape)} ({scene.n_quads} quad rows, stages: "
          f"{'affine, ' if table is not None else ''}camera"
          f"{', damage clip' if rects is not None else ''}): {differing} of "
          f"{got.numel()} 32-bit words differ (expected 0); {moved} words moved",
          flush=True)
    if differing or not torch.equal(scene.combo_dev.view(torch.int32),
                                    resident.view(torch.int32)):
        fail(f"{what}: the row kernel differs from its plain version in "
             f"{differing} words, or wrote the resident rows")
    errs.append(float(differing))
    return args, kw


def shifted_scene(copies: int, d):
    """bench.py's frame-0 scene with every box moved by the integer offset d."""
    from figdraw_tpu_torch.scenes import make_render_tree_array

    import numpy as np

    arr = make_render_tree_array(WIDTH, HEIGHT, 0, copies=copies)
    box = arr[0].nodes["box"]
    box[:, 0] += np.float32(d[0])
    box[:, 1] += np.float32(d[1])
    return arr


def camera_phase(copies: int, tag: str, errs: list) -> dict:
    """bench_camera.py's loops at 1080p: render_frame of the static scene,
    render_view(snap, (3f, f)) and render_views of the same sweep with its
    zooms. Checks: an integer-pan view equals, bit for bit, the frame of the
    scene with its boxes moved by the pan (flattened without the viewport
    cull, and at copies=100 also render_frame's own frame); render_views
    equals the render_view loop; launch counts."""
    import torch

    from figdraw_tpu_torch import FigRenderer, vec2
    from figdraw_tpu_torch.ops import blur, raster, rows
    from figdraw_tpu_torch.scenes import make_render_tree_array

    size = vec2(WIDTH, HEIGHT)
    cache = {}
    ren = FigRenderer(device="cuda")
    n = RESIDENT_FRAMES

    def scene(f):
        return make_render_tree_array(WIDTH, HEIGHT, f, copies=copies, cache=cache)

    ren.render_frame(scene(0), size)
    walk = loop_ms(lambda f: ren.render_frame(scene(0), size), reps=1)
    snap = ren.snapshot_scene(scene(0), size)
    ren.render_view(snap, (1.0, 0.0))
    zero_counts()
    pan = loop_ms(lambda f: ren.render_view(snap, (f * 3.0, f * 1.0)))
    counts = (rows.LAUNCHES, blur.LAUNCHES, raster.LAUNCHES)
    bins = binning_launches(f"camera {copies * 3}", 3 * n)
    want = (3 * n, 2 * 3 * n, 2 * 3 * n)
    if counts != want:
        fail(f"camera {copies}: (rows, blur, K1) launches {counts}, expected {want}")
    border = binning_check(f"camera {copies * 3}", lambda: ren.render_view(snap, (21.0, 7.0)))
    pans = [(f * 3.0, f * 1.0) for f in range(n)]
    zooms = [1.0 + 0.4 * (f / n) for f in range(n)]
    ren.render_views(snap, pans[:2], zooms[:2])
    # one call renders the whole sweep: loop_ms divides its time by the views
    fly = loop_ms(lambda f: ren.render_views(snap, pans, zooms) if f == 0 else None)
    stack = ren.render_views(snap, pans, zooms)
    for i in (0, 1, n // 2, n - 1):
        if not torch.equal(stack[i], ren.render_view(snap, pans[i], zooms[i])):
            fail(f"camera {copies}: render_views' view {i} differs from render_view's")
    if not bool(torch.isfinite(stack).all()):
        fail(f"camera {copies}: render_views holds non-finite values")
    del stack
    # at copies=100 every comparison is bit for bit; past 4096 quads
    # render_frame's walk culls saturated stacks for its viewport, and the
    # device binning's saturation tier works tile by tile, so there the views
    # are held within TOL and the exact ones counted
    worst, worst_walk, exact = 0.0, 0.0, 0
    checked = (0, 7, n - 1)
    for f in checked:
        d = (f * 3.0, f * 1.0)
        view = ren.render_view(snap, d)
        other = FigRenderer(device="cuda")
        moved = shifted_scene(copies, d)
        expect = other.execute(other.flatten(moved, size, cull=False))
        exact += bool(torch.equal(view, expect))
        worst = max(worst, float((view - expect).abs().max()))
        worst_walk = max(worst_walk, float(
            (view - other.render_frame(moved, size)).abs().max()))
    limit = 0.0 if copies == COPIES else TOL
    print(f"check 8: camera {copies * 3} boxes ({snap.kind}, {snap.n_quads} quad "
          f"rows): integer-pan views against the frame of the scene with its boxes "
          f"moved: max |diff| {worst:.3e} flattened without the viewport cull "
          f"({exact} of {len(checked)} bit for bit), {worst_walk:.3e} against "
          f"render_frame (limit {limit:.3e}); render_views equals the render_view "
          f"loop; launches per view: rows 1, blur 2, K1 2", flush=True)
    if worst > limit or worst_walk > limit:
        fail(f"camera {copies}: an integer-pan view differs from the moved scene's "
             f"frame by {max(worst, worst_walk)}")
    args = rows_check(f"camera {copies * 3}-box", snap,
                      torch.tensor([21.0, 7.0], device="cuda"),
                      torch.tensor([1.0], device="cuda"), errs)
    print(f"times: camera {copies * 3} boxes {WIDTH}x{HEIGHT}: render_view "
          f"{ms_text(pan)}, render_views {ms_text(fly)} a view, render_frame loop "
          f"{walk[0]:.3f} ms/frame {tag}", flush=True)
    # a view's executor by stage, on the checked view's rows
    plan, viewed, th = snap.plan, snap.scratch, snap.plan.tile_h
    stages = front_stages(f"camera {copies * 3}")
    stages["whole executor"] = cuda_ms(lambda: ren._run_plan(plan, viewed), 10)
    print(f"times: camera {copies * 3} boxes: a view's executor stages (tile_h "
          f"{th}): " + ", ".join(f"{k} {v:.4f} ms" for k, v in stages.items())
          + f" (device, CUDA events) {tag}", flush=True)
    return {"rows_args": args, "pan": pan, "fly": fly, "walk": walk[0],
            "launches": counts[0], "blur_launches": counts[1], "bin_launches": bins,
            "borderline": border}


def sceneanim_phase(copies: int, tag: str, errs: list) -> dict:
    """bench_sceneanim.py's loops at 1080p: the bulk (R, 6) affine table a
    frame through render_view against the animate and re-flatten loop."""
    import numpy as np
    import torch

    from figdraw_tpu_torch import FigRenderer, vec2
    from figdraw_tpu_torch.ops import rows
    from figdraw_tpu_torch.scene import anim_table as scene_table
    from figdraw_tpu_torch.scenes import anim_table, box_tracks, make_render_tree_array

    size = vec2(WIDTH, HEIGHT)
    cache = {}
    ren = FigRenderer(device="cuda")

    def scene(f):
        return make_render_tree_array(WIDTH, HEIGHT, f, copies=copies, cache=cache)

    ren.render_frame(scene(0), size)
    walk = loop_ms(lambda f: ren.render_frame(scene(f), size), reps=1)
    snap = ren.snapshot_scene(scene(0), size)
    n_roots = len(snap.animation_order())
    base = box_tracks(copies, 0, WIDTH, HEIGHT)
    table = np.zeros((n_roots, 6), np.float32)
    table[:, 0] = table[:, 3] = 1.0
    still = ren.render_view(snap, root_transforms=table)
    if not torch.equal(still, ren.render_view(snap)):
        fail(f"sceneanim {copies}: the identity table's frame differs from the view")
    zero_counts()
    anim = loop_ms(lambda f: ren.render_view(
        snap, root_transforms=anim_table(copies, base, f, table, WIDTH, HEIGHT)))
    launches = rows.LAUNCHES
    bins = binning_launches(f"sceneanim {copies * 3}", 3 * RESIDENT_FRAMES)
    if launches != 3 * RESIDENT_FRAMES:
        fail(f"sceneanim {copies}: {launches} row launches, expected "
             f"{3 * RESIDENT_FRAMES}")
    moved = ren.last_frame
    if not bool(torch.isfinite(moved).all()) or torch.equal(moved, still):
        fail(f"sceneanim {copies}: the animated frame is not finite or did not move")
    border = binning_check(f"sceneanim {copies * 3}", lambda: ren.render_view(
        snap, root_transforms=anim_table(copies, base, 5, table, WIDTH, HEIGHT)))
    host = []
    for f in range(RESIDENT_FRAMES):
        t0 = time.perf_counter()
        anim_table(copies, base, f, table, WIDTH, HEIGHT)
        host.append((time.perf_counter() - t0) * 1e3)
    dev_table = torch.from_numpy(scene_table(snap, table)).cuda()
    args = rows_check(f"sceneanim {copies * 3}-box", snap,
                      torch.tensor([0.0, 0.0], device="cuda"),
                      torch.tensor([1.0], device="cuda"), errs, table=dev_table,
                      ridx=snap.anim_ridx_dev)
    print(f"times: sceneanim {copies * 3} boxes ({n_roots} roots): animated "
          f"render_view {ms_text(anim)} (the table's numpy math alone "
          f"{statistics.median(host):.3f} ms), animate + render_frame loop "
          f"{walk[0]:.3f} ms/frame {tag}", flush=True)
    return {"rows_args": args, "anim": anim, "walk": walk[0], "launches": launches,
            "bin_launches": bins, "borderline": border}


def retained_phase(copies: int, tag: str, errs: list) -> dict:
    """bench_retained.py's loops at 1080p: DIRTY_ROOTS edited roots a frame
    through update_scene + render_view, damage-clipped (the camera stands
    still) and in full, against the render_frame loop. Checks: every frame
    of the clipped loop took the clipped path and its last frame equals, bit
    for bit, the view of a new snapshot of the edited scene."""
    import torch

    from figdraw_tpu_torch import FigRenderer, renderer, rgba, vec2
    from figdraw_tpu_torch.ops import rows
    from figdraw_tpu_torch.scene import damage_rects
    from figdraw_tpu_torch.scenes import build_grid

    n_boxes = copies * 3
    size = vec2(WIDTH, HEIGHT)
    arr, boxes = build_grid(n_boxes, WIDTH, HEIGHT)
    lst = arr[0]
    ren = FigRenderer(device="cuda")

    def edit(f):
        dirty = []
        for k in range(DIRTY_ROOTS):
            b = boxes[(f * DIRTY_ROOTS + k) % len(boxes)]
            x, y, w, h = lst.nodes[b]["box"]
            lst.set_box(b, float(x), float((y + 3 + f) % HEIGHT), float(w), float(h))
            lst.set_solid_color(b, rgba((b * 13 + f) % 255, 120, 220, 180))
            dirty.append((0, b))
        return dirty

    def walk_frame(f):
        edit(f)
        ren.render_frame(arr, size)

    ren.render_frame(arr, size)
    walk = loop_ms(walk_frame, reps=1)
    scene = ren.snapshot_scene(arr, size)
    if scene.spans is None:
        fail(f"retained {n_boxes}: the snapshot has no spans")
    ren.update_scene(scene, arr, edit(0))
    ren.render_view(scene)
    clipped_frames = [0]
    spans = renderer.damage_spans

    def counting(*a, **k):
        clipped_frames[0] += 1
        return spans(*a, **k)

    renderer.damage_spans = counting
    host = []

    def retained_frame(f, full=False):
        t0 = time.perf_counter()
        ren.update_scene(scene, arr, edit(f + 1))
        host.append((time.perf_counter() - t0) * 1e3)
        if full:
            scene.last_view_frame = None  # no source for a damage-clipped frame
        ren.render_view(scene)

    try:
        zero_counts()
        clipped = loop_ms(retained_frame)
        taken = clipped_frames[0]
        last = ren.last_frame
        rects = torch.from_numpy(damage_rects(
            [(100.0, 80.0, 400.0, 300.0), (900.5, 600.25, 1300.0, 900.0)])).cuda()
        launches = rows.LAUNCHES
        bins = binning_launches(f"retained {n_boxes}", 3 * RESIDENT_FRAMES)
        full = loop_ms(lambda f: retained_frame(f, full=True))
    finally:
        renderer.damage_spans = spans
    if taken != 3 * RESIDENT_FRAMES or clipped_frames[0] != taken:
        fail(f"retained {n_boxes}: {taken} damage-clipped frames of "
             f"{3 * RESIDENT_FRAMES}, {clipped_frames[0] - taken} in the full loop")
    if launches != 3 * RESIDENT_FRAMES:
        fail(f"retained {n_boxes}: {launches} row launches, expected "
             f"{3 * RESIDENT_FRAMES}")
    # one more damage-clipped frame, held against a new snapshot's view
    ren.render_view(scene)
    ren.update_scene(scene, arr, edit(0))
    got = ren.render_view(scene)
    fresh = FigRenderer(device="cuda")
    want = fresh.render_view(fresh.snapshot_scene(arr, size))
    if not (torch.equal(got, want) and bool(torch.isfinite(last).all())):
        fail(f"retained {n_boxes}: the patched frame differs from a new "
             f"snapshot's by {float((got - want).abs().max())}")
    print(f"check 8: retained {n_boxes} boxes ({scene.kind}, {scene.n_quads} quad "
          f"rows, {DIRTY_ROOTS} dirty roots a frame): {taken} of {taken} frames "
          f"damage-clipped; a damage-clipped frame equals a new snapshot's view bit "
          f"for bit", flush=True)
    # a damage-clipped view's binning: the rows outside the damage drop out
    border = binning_check(f"retained {n_boxes}", lambda: (
        ren.update_scene(scene, arr, edit(1)), ren.render_view(scene)))
    args = rows_check(f"retained {n_boxes}-box", scene,
                      torch.tensor([0.0, 0.0], device="cuda"),
                      torch.tensor([1.0], device="cuda"), errs, rects=rects)
    print(f"times: retained {n_boxes} boxes: update_scene + render_view "
          f"damage-clipped {ms_text(clipped)}, in full {ms_text(full)} "
          f"(update_scene alone {statistics.median(host):.3f} ms), edit + "
          f"render_frame loop {walk[0]:.3f} ms/frame {tag}", flush=True)
    return {"rows_args": args, "clipped": clipped, "full": full, "walk": walk[0],
            "launches": launches, "bin_launches": bins, "borderline": border}


def rows_times(what: str, args, kw, tag: str) -> dict:
    """The row kernel's time on one phase's rows: by CUDA events around the
    wrapper call, alone by torch.profiler, its plain version, its bound."""
    import torch

    from figdraw_tpu_torch.ops import rows

    combo, n_quads = args[0], args[1]
    out = torch.empty_like(combo)
    ms = cuda_ms(lambda: rows.transform_rows(*args, out, **kw), 20)
    alone = device_ms_of(lambda: rows.transform_rows(*args, out, **kw), "rows_kernel")
    plain_ms = cuda_ms(lambda: rows.transform_rows_plain(*args, **kw), 3)
    n_bytes = 2 * combo.numel() * 4 + 12
    for extra in kw.values():
        if extra is not None:
            n_bytes += extra.numel() * 4
    bound, by = bound_of(n_bytes, ROWS_OPS_PER_ROW * n_quads)
    print(f"times: rows kernel on the {what} rows {tuple(combo.shape)}: {ms:.4f} ms "
          f"(CUDA events around the wrapper call), {alone:.4f} ms (the kernel alone, "
          f"torch.profiler), plain torch {plain_ms:.3f} ms; bound {bound:.5f} ms "
          f"({by}: {n_bytes} bytes) {tag}", flush=True)
    return {"ms": ms, "device_ms": alone, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by}


def blur_phase(planes, radius, tag: str) -> dict:
    """The blur kernel against the plain blur, bit for bit, on the
    headline's planes at its own radius, on seeded planes at other radii and
    on seeded planes whose sides are no multiple of the kernel's blocks;
    times and bound at the headline's."""
    import numpy as np
    import torch

    from figdraw_tpu_torch.ops import blur

    errs = {}
    rng = np.random.RandomState(18)
    seeded = torch.from_numpy(rng.rand(*planes.shape).astype(np.float32)).cuda()
    # (4, 1000, 1916): the 16-byte vertical pass with partial blocks;
    # (3, 1081, 1925): an odd width, the one-column vertical pass
    odd = [torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda()
           for shape in ((4, 1000, 1916), (3, 1081, 1925))]
    r18 = torch.tensor(float(radius), dtype=torch.float32, device="cuda")
    for what, src, r in [("headline", planes, float(radius))] + [
            ("seeded", seeded, r) for r in (0.3, 1.0, 7.5, 64.0, 100.0)] + [
            (f"seeded {tuple(o.shape)}", o, r) for o in odd for r in (0.5, 7.5, 18.0, 64.0)]:
        rt = torch.tensor(r, dtype=torch.float32, device="cuda")
        before = src.clone()
        got = blur.backdrop_blur_planar(src, rt)
        ref = blur.backdrop_blur_planar_plain(src, rt)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        errs[f"{what} r={r:g}"] = err
        if not (torch.equal(got, ref) and bool(torch.isfinite(got).all())
                and torch.equal(src, before)):
            fail(f"blur kernel on the {what} planes at r={r:g} differs from the "
                 f"plain blur by {err}, or wrote its input")
        if r <= 0.5 and not torch.equal(got, src):
            fail(f"blur kernel at r={r:g} is not the identity")
    print(f"check 8: blur kernel vs plain on {tuple(planes.shape)} planes, max |diff| "
          + ", ".join(f"{k}: {v:.2e}" for k, v in errs.items()) + " (bit for bit)",
          flush=True)
    ms = cuda_ms(lambda: blur.backdrop_blur_planar(planes, r18), 20)
    names = ("blur_h_kernel", "blur_v_kernel")
    alone = device_ms_of(lambda: blur.backdrop_blur_planar(planes, r18), names)
    parts = kernel_parts(lambda: blur.backdrop_blur_planar(planes, r18), names)
    plain_ms = cuda_ms(lambda: blur.backdrop_blur_planar_plain(planes, r18), 5)
    n_bytes = 4 * planes.numel() * 4  # two passes, each a read and a write
    # what the function needs: the interpolation and the sum for every tap of
    # every pixel and the divide, twice; the tap positions once a column
    # (horizontal pass) and once a row (vertical pass)
    ph, pw = planes.shape[-2:]
    n_ops = (2 * planes.numel() * (BLUR_TAPS * BLUR_OPS_PER_TAP + 1)
             + BLUR_TAPS * BLUR_OPS_PER_POSITION * (ph + pw))
    bound, by = bound_of(n_bytes, n_ops)
    print(f"times: blur kernel on the headline's planes {tuple(planes.shape)} at "
          f"r={float(radius):g}: {ms:.4f} ms (CUDA events around the wrapper call, both "
          f"passes), {alone:.4f} ms (the two kernels alone, torch.profiler; {parts}), plain "
          f"torch {plain_ms:.3f} ms; bound {bound:.4f} ms ({by}; bytes alone "
          f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms, the function's operations alone "
          f"{n_ops / FP32_OPS_PER_S * 1e3:.4f} ms); the kernel alone is "
          f"{alone / bound:.2f} times its bound {tag}", flush=True)
    return {"ms": ms, "device_ms": alone, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "err": max(errs.values())}


def resident_phases(tag: str) -> dict:
    """The device-resident loops of bench_camera.py, bench_sceneanim.py and
    bench_retained.py at both scales, and the row kernel's times on their
    rows."""
    errs, out = [], {"launches": {}}
    for copies in RESIDENT_SCALES:
        boxes = copies * 3
        cam = camera_phase(copies, tag, errs)
        anim = sceneanim_phase(copies, tag, errs)
        kept = retained_phase(copies, tag, errs)
        out[copies] = {"camera": cam, "sceneanim": anim, "retained": kept}
        for name, phase in (("camera", cam), ("sceneanim", anim), ("retained", kept)):
            out["launches"][f"{name} {boxes}"] = phase["launches"]
            BIN_PATHS[f"{name} {boxes}"] = phase["bin_launches"]
            BORDERLINE[f"{name} {boxes}"] = phase["borderline"]
    small, big = RESIDENT_SCALES[0], RESIDENT_SCALES[-1]
    out["times"] = rows_times(f"sceneanim {big * 3}-box (affine and camera)",
                              *out[big]["sceneanim"]["rows_args"], tag)
    rows_times(f"camera {small * 3}-box (camera)",
               *out[small]["camera"]["rows_args"], tag)
    rows_times(f"retained {big * 3}-box (camera and damage clip)",
               *out[big]["retained"]["rows_args"], tag)
    out["err"] = max(errs)
    return out


def turns_phase(tag: str) -> dict:
    """`python3 chip_smoke.py turns`: the headline frame (FRAMES frames of
    render_frame), the rect-mask table's frame and a 12000-box camera view
    (render_view, three loops of RESIDENT_FRAMES), each with its executor
    and the executor's own front end timed by CUDA events (the decode, the
    binning of the decoded fields and the two together); the
    blur (both passes) on seeded planes of the headline's shape at its
    radius, by CUDA events and alone by torch.profiler. Only entry points
    that every commit since the device-resident scenes has, and whichever
    binning and blur kernels the checkout has; no checks."""
    import importlib
    import itertools

    from figdraw_tpu_torch import FigRenderer, executor, native, vec2
    from figdraw_tpu_torch.executor import get_frame_executor
    from figdraw_tpu_torch.ops import binning, blur
    from figdraw_tpu_torch.plan import plan_execution
    from figdraw_tpu_torch.scenes import make_clip_table_scene, make_render_tree_array

    import torch

    loads = [native.load]
    for name in ("raster", "mega", "rows", "blur", "binning"):
        try:
            loads.append(importlib.import_module(f"figdraw_tpu_torch.ops.{name}").load)
        except (ImportError, AttributeError):  # an older checkout has no such kernel
            pass
    with ThreadPoolExecutor(len(loads)) as pool:
        list(pool.map(lambda load: load(), loads))

    def front_ms(render) -> dict:
        """The executor's front end on its own call, by CUDA events: the
        decode alone, the binning of the decoded fields (bin_quads), and the
        whole front end (decode_and_bin where the checkout has it, else its
        decode and binning calls in turn)."""
        if hasattr(executor, "decode_and_bin"):
            a, k = recorded(executor, "decode_and_bin", render)[0]
            rows = a[0]
            fields, modes = executor.unpack_combo(rows)
            b = (fields,) + a[1:]
            kb = dict(modes=modes, run_bounds=k.get("run_bounds")) if k.get("cull") else {}
            whole = lambda: executor.decode_and_bin(*a, **k)
            binned = lambda: binning.bin_quads(*b, **kb)
        else:
            (rows,), _k = recorded(executor, "unpack_combo", render)[0]
            b, kb = recorded(executor, "bin_quads", render)[0]
            whole = lambda: (executor.unpack_combo(rows), executor.bin_quads(*b, **kb))
            binned = lambda: executor.bin_quads(*b, **kb)
        return {"decode_ms": cuda_ms(lambda: executor.unpack_combo(rows), 20),
                "binning_ms": cuda_ms(binned, 20), "front_ms": cuda_ms(whole, 20)}

    size = vec2(WIDTH, HEIGHT)
    out = {}
    cache = {}
    ren = FigRenderer(device="cuda")
    step = itertools.count(1)
    headline = lambda: ren.render_frame(make_render_tree_array(
        WIDTH, HEIGHT, next(step), copies=COPIES, cache=cache), size)
    headline()
    frames = timed_frames("headline", headline, (HEIGHT, WIDTH, 4))
    plan = plan_execution(ren.flatten(make_render_tree_array(
        WIDTH, HEIGHT, 0, copies=COPIES, cache=cache), size))
    run = get_frame_executor(plan.structure, plan.height, plan.width, plan.n_masks,
                             plan.has_init_frame, plan.tile_h)
    combo = torch.from_numpy(plan.combo).to("cuda", copy=True)
    out["headline"] = {"frame_ms": statistics.median(frames),
                       "executor_ms": cuda_ms(lambda: run(combo, None), 20),
                       **front_ms(lambda: run(combo, None))}
    gen = torch.Generator(device="cuda").manual_seed(18)
    ph, pw = -(-plan.height // plan.tile_h) * plan.tile_h, -(-plan.width // 128) * 128
    planes = torch.rand((4, ph, pw), generator=gen, device="cuda")  # the executor's
    radius = torch.tensor(float(plan.radii[0]), dtype=torch.float32, device="cuda")
    blurred = lambda: blur.backdrop_blur_planar(planes, radius)
    out["blur"] = {"planes": list(planes.shape), "radius": float(plan.radii[0]),
                   "ms": cuda_ms(blurred, 20),
                   "device_ms": device_ms_of(blurred, "blur_"),  # both passes
                   "passes": kernel_parts(blurred, ("blur_h", "blur_v", "blur_pass"))}

    table = make_clip_table_scene("rectmask", TABLE_W, TABLE_H, TABLE_ROWS, TABLE_COLS)
    table_size = vec2(TABLE_W, TABLE_H)
    ren = FigRenderer(device="cuda")
    ren.render_frame(table, table_size)
    frames = timed_frames("rectmask", lambda: ren.render_frame(table, table_size),
                          (TABLE_H, TABLE_W, 4))
    plan = plan_execution(ren.flatten(table, table_size))
    run = get_frame_executor(plan.structure, plan.height, plan.width, plan.n_masks,
                             plan.has_init_frame, plan.tile_h)
    combo = torch.from_numpy(plan.combo).to("cuda", copy=True)
    out["rectmask"] = {"frame_ms": statistics.median(frames),
                       "executor_ms": cuda_ms(lambda: run(combo, None), 20),
                       **front_ms(lambda: run(combo, None))}

    copies = RESIDENT_SCALES[-1]
    ren = FigRenderer(device="cuda")
    snap = ren.snapshot_scene(make_render_tree_array(WIDTH, HEIGHT, 0, copies=copies), size)
    ren.render_view(snap, (1.0, 0.0))
    loops = loop_ms(lambda f: ren.render_view(snap, (f * 3.0, f * 1.0)))
    out[f"camera {copies * 3}"] = {
        "view_ms": min(loops), "loops_ms": loops,
        "executor_ms": cuda_ms(lambda: ren._run_plan(snap.plan, snap.scratch), 20),
        **front_ms(lambda: ren.render_view(snap, (21.0, 7.0)))}
    for what, v in out.items():
        print(f"turns: {what}: " + ", ".join(
            f"{k} {x:.4f}" if isinstance(x, float) else f"{k} {x}" for k, x in v.items())
            + f" {tag}", flush=True)
    print(json.dumps({"turns": out}), flush=True)
    return out


# --- the frame loop: render_batch, render_frame_async, overlays, blurred cards ----

ANIM_FRAMES = 48  # bench_anim.py's FIGDRAW_BENCH_FRAMES
ANIM_SIZES = ((1920, 1080), (640, 360))  # bench_anim.py's RESOLUTIONS
ANIM_CHUNK = 8  # bench_anim.py's FIGDRAW_BATCH_CHUNK
GROUP_FRAMES = 8  # frames of each further batch group
IDLE_FRAMES = 12  # frames in each torch.profiler window of the async phase


def frame_launches(plan) -> dict:
    """The kernel launches one frame of a plan makes, by kernel: a
    frame-target run K1 (K1-atlas when it holds an atlas quad), a
    mask-target run K3, a megakernel plan K4 or K4-atlas once, a blur item
    two blur launches, and one front end a frame (the front kernel,
    "decode", and the tile kernel, "binning"), with no plain decode or
    binning ("plain")."""
    out = dict.fromkeys(("K1", "K1-atlas", "K3", "K4", "K4-atlas", "blur", "plain"), 0)
    out["binning"] = out["decode"] = 1
    if plan.mega_combo is not None:
        out["K4-atlas" if plan.mega_atlas else "K4"] = 1
        return out
    for item in plan.structure:
        if item[0] == "blur":
            out["blur"] += 2
        elif item[0] == "draw":
            out["K3" if item[1] >= 0 else "K1-atlas" if item[2] else "K1"] += 1
    return out


def all_counts() -> dict:
    from figdraw_tpu_torch.ops import binning, blur

    k1, k1a, k3, k4, k4a = launch_counts()
    return {"K1": k1, "K1-atlas": k1a, "K3": k3, "K4": k4, "K4-atlas": k4a,
            "blur": blur.LAUNCHES, "binning": binning.LAUNCHES,
            "decode": binning.DECODE_LAUNCHES,
            "plain": binning.PLAIN_DECODES + binning.PLAIN_BINNINGS}


LOOP_PATHS = {}  # path -> its counted run's launches by kernel


def counted_launches(what: str, want: dict) -> dict:
    """The launches since zero_counts() against `want` (by kernel); fails
    on any difference; keeps them for the kernels line."""
    got = all_counts()
    print(f"check 11: {what}: launches {got} (expected {want})", flush=True)
    if got != want:
        fail(f"{what} launched {got}, expected {want}")
    LOOP_PATHS[what] = got
    return got


def scaled_launches(per_frame: dict, frames: int) -> dict:
    return {k: v * frames for k, v in per_frame.items()}


def recorded_frames(ren) -> tuple:
    """ren._run_plan wrapped so that each frame it runs is recorded with
    its own inputs, (plan, combo on the card, atlas, init frame), on
    whichever thread runs it; returns (the list, undo)."""
    from figdraw_tpu_torch.renderer import _needs_atlas

    runs, real = [], ren._run_plan

    def call(plan, combo, atlas=None):
        if atlas is None and _needs_atlas(plan):
            atlas = ren._device_atlas()
        init = ren._init_frame(plan.has_init_frame, plan.height, plan.width)
        runs.append((plan, combo, atlas, None if init is None else init.clone()))
        return real(plan, combo, atlas)

    ren._run_plan = call
    return runs, lambda: delattr(ren, "_run_plan")


def recorded_groups(ren) -> tuple:
    """ren._dispatch_batch wrapped so that each group render_batch runs is
    recorded: (key, first plan, its BatchStack, atlas); returns (the list,
    undo)."""
    groups, real = [], ren._dispatch_batch

    def call(key, plan, batch, atlas, **kw):
        groups.append((key, plan, batch, atlas))
        return real(key, plan, batch, atlas, **kw)

    ren._dispatch_batch = call
    return groups, lambda: delattr(ren, "_dispatch_batch")


FRAMELOOP_ERRS = {}  # kernel -> max |kernel - plain| over the frame loop's checks


def plan_kernel_checks(what: str, plan, combo, atlas, init=None, table=None,
                       calls=None) -> dict:
    """Each kernel of one frame of `plan` against its plain version on that
    frame's own inputs: combo (its upload on the card, or its slice of a
    batch's stack), atlas and init frame as the frame's executor got them,
    table the rolled item table and radii (tensors of a batch's stack, or
    the plan's own). K1, K1-atlas and K3 through compared(), K4 and K4-atlas
    on the megakernel (targets as before the kernel ran), the blur through
    recorded_blur (bit for bit) and the binning through binning_check.
    calls: an empty list, or None; given, it receives the (args, kwargs) of
    each K1, K1-atlas and K4 / K4-atlas launch the check made. Fails past
    TOL; returns the errors by kernel."""
    import torch

    from figdraw_tpu_torch.executor import get_frame_executor, get_mega_executor
    from figdraw_tpu_torch.ops import mega, raster

    errs, store = {}, ([] if calls is None else calls)
    if plan.mega_combo is not None:
        name = "K4-atlas" if plan.mega_atlas else "K4"
        run = get_mega_executor(plan.height, plan.width, plan.n_masks,
                                plan.has_init_frame, plan.tile_h)
        atlas = atlas if plan.mega_atlas else None

        def frame():
            return run(combo, init, atlas=atlas)

        run(combo, init, atlas=atlas,
            draw=compared(mega.draw_pass_mega, mega.draw_pass_mega_plain,
                          errs.setdefault(name, []), store, what, targets=MEGA_TARGETS))
    else:
        rolled = plan.rolled_items is not None
        run = get_frame_executor(plan.structure, plan.height, plan.width, plan.n_masks,
                                 plan.has_init_frame, plan.tile_h, rolled=rolled)
        if rolled and table is None:
            table = dict(items=plan.rolled_items, radii=plan.rolled_radii)
        table = table or {}

        def frame():
            return run(combo, init, atlas=atlas, **table)

        k1, k3 = [], []
        undo = recorded_blur(errs.setdefault("blur", []))
        try:
            run(combo, init, atlas=atlas, **table,
                draw=compared(raster.draw_pass_planar_prebinned,
                              raster.draw_pass_planar_prebinned_plain, k1, store, what),
                draw_mask=compared(raster.draw_pass_mask_prebinned,
                                   raster.draw_pass_mask_prebinned_plain, k3, [], what))
        finally:
            undo()
        for err, (_a, kw) in zip(k1, store):
            errs.setdefault("K1-atlas" if kw.get("atlas") is not None else "K1", []).append(err)
        if k3:
            errs["K3"] = k3
    torch.cuda.synchronize()
    worst = {k: max(v) for k, v in errs.items() if v}
    BORDERLINE[what] = binning_check(what, frame)
    print(f"check 11: {what}: each kernel vs its plain version on the frame's own "
          f"inputs, max |diff| {worst} (tol {TOL:.3e}; the blur bit for bit); the "
          f"binning's lists equal", flush=True)
    if any(v > TOL for v in worst.values()):
        fail(f"{what}: a kernel differs from its plain version: {worst}")
    for k, v in worst.items():
        FRAMELOOP_ERRS[k] = max(FRAMELOOP_ERRS.get(k, 0.0), v)
    return worst


def group_checks(what: str, group, dev) -> None:
    """plan_kernel_checks on the first frame of a recorded batch group, on
    its slice of the group's one upload."""
    key, plan, batch, atlas = group
    frame0 = batch.frame(batch.upload(dev), 0)
    table = ({"items": frame0["items"], "radii": frame0["radii"]}
             if key[0] == "rolled" else None)
    plan_kernel_checks(what, plan, frame0["combo"], atlas, table=table)


def equal_frames(what: str, got, want) -> None:
    import torch

    if len(got) != len(want):
        fail(f"{what}: {len(got)} frames, expected {len(want)}")
    bad = [f for f in range(len(want)) if not torch.equal(got[f], want[f])]
    print(f"check 11: {what}: {len(want)} frames bit-equal to render_frame's on a "
          f"second renderer: {not bad}", flush=True)
    if bad:
        diff = float((got[bad[0]] - want[bad[0]]).abs().max())
        fail(f"{what}: frames {bad} differ from render_frame's (frame {bad[0]} by {diff})")


def batch_phase(tag: str, dev) -> dict:
    """bench_anim.py's run through render_batch: the headline scene
    (copies=100, 300 boxes) at 1920x1080 and 640x360, ANIM_FRAMES frames in
    groups of ANIM_CHUNK, the batch's ms/frame (best of three) against the
    render_frame loop's (one synchronize a loop, as bench_anim times both);
    every frame bit-equal to render_frame's on a second renderer and its
    as_uint8 form to take_screenshot's; the counted run's launches (K1 2,
    blur 2, binning 2 a frame); then the sub-clip table, images_clipped and
    the blurred cards as mega, mega-with-atlas and rolled groups of
    GROUP_FRAMES, and an update_image between two groups; each group's
    first frame's kernels against their plain versions on its slice of the
    group's upload."""
    import numpy as np
    import torch

    from figdraw_tpu_torch import FigRenderer, vec2
    from figdraw_tpu_torch.plan import plan_execution
    from figdraw_tpu_torch.scenes import (
        IMAGE_ID, make_blurred_cards_scene, make_clip_table_scene,
        make_image_panels_scene, make_render_tree_array,
    )

    out = {}
    for w, h in ANIM_SIZES:
        size = vec2(w, h)
        cache = {}

        def scenes(n, base=0, w=w, h=h, cache=cache):
            for f in range(base, base + n):
                yield make_render_tree_array(w, h, f, copies=COPIES, cache=cache)

        ren = FigRenderer(atlas_size=256, device="cuda")
        ren.render_frame(next(iter(scenes(1))), size)
        ren.render_batch(scenes(ANIM_CHUNK), size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for sc in scenes(ANIM_FRAMES, base=100):
            ren.render_frame(sc, size)
        torch.cuda.synchronize()
        loop_ms_ = (time.perf_counter() - t0) * 1e3 / ANIM_FRAMES
        batch_ms = []
        for rep in range(3):
            if rep == 0:
                zero_counts()
            t0 = time.perf_counter()
            frames = ren.render_batch(scenes(ANIM_FRAMES, base=100), size,
                                      chunk=ANIM_CHUNK)
            torch.cuda.synchronize()
            batch_ms.append((time.perf_counter() - t0) * 1e3 / ANIM_FRAMES)
            if rep == 0:
                plan = plan_execution(ren.flatten(next(iter(scenes(1, base=100))), size))
                counted_launches(f"batch headline {w}x{h}",
                                 scaled_launches(frame_launches(plan), ANIM_FRAMES))
        if tuple(frames.shape) != (ANIM_FRAMES, h, w, 4) or not bool(torch.isfinite(frames).all()):
            fail(f"batch {w}x{h}: frames of shape {tuple(frames.shape)} or non-finite")
        ref = FigRenderer(atlas_size=256, device="cuda")
        want = [ref.render_frame(sc, size).clone() for sc in scenes(ANIM_FRAMES, base=100)]
        equal_frames(f"batch headline {w}x{h}", frames, want)
        u8 = ren.render_batch(scenes(ANIM_FRAMES, base=100), size, as_uint8=True)
        shots_equal = all(np.array_equal(u8[f].cpu().numpy(), ref.take_screenshot(want[f]))
                          for f in range(ANIM_FRAMES))
        print(f"check 11: batch headline {w}x{h}: as_uint8 equals take_screenshot of each "
              f"frame: {shots_equal}", flush=True)
        if not shots_equal:
            fail(f"batch {w}x{h}: as_uint8 differs from take_screenshot")
        groups, undo = recorded_groups(ren)
        ren.render_batch(scenes(1, base=100), size)
        undo()
        group_checks(f"batch headline {w}x{h}", groups[0], dev)
        print(f"times: batch headline {w}x{h} {COPIES * 3} boxes, {ANIM_FRAMES} frames in "
              f"groups of {ANIM_CHUNK}: render_batch {min(batch_ms):.3f} ms/frame (best of "
              f"3: {', '.join(f'{m:.3f}' for m in batch_ms)}), the render_frame loop "
              f"{loop_ms_:.3f} ms/frame (bench_anim.py's timing: one synchronize a loop) "
              f"{tag}", flush=True)
        out[f"{w}x{h}"] = {"batch_ms": min(batch_ms), "batch_runs_ms": batch_ms,
                           "loop_ms": loop_ms_}

    # --- further groups: mega, mega with the atlas, rolled ---
    cases = (
        ("subclip table", lambda f: make_clip_table_scene(
            "subclip", TABLE_W, TABLE_H, TABLE_ROWS, TABLE_COLS), vec2(TABLE_W, TABLE_H), "mega"),
        ("images_clipped", lambda f: make_image_panels_scene(
            IMAGE_W, IMAGE_H, IMAGE_PANELS, "images_clipped"), vec2(IMAGE_W, IMAGE_H), "mega"),
        ("blurred cards", lambda f: make_blurred_cards_scene(
            IMAGE_W, IMAGE_H, IMAGE_PANELS), vec2(IMAGE_W, IMAGE_H), "rolled"),
    )
    for what, build, size, kind in cases:
        built = [build(f) for f in range(GROUP_FRAMES)]
        ren, ref = image_renderer(), image_renderer()
        ren.render_batch(built[:1], size)
        ref.render_frame(built[0], size)
        torch.cuda.synchronize()
        groups, undo = recorded_groups(ren)
        zero_counts()
        t0 = time.perf_counter()
        frames = ren.render_batch(built, size)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / GROUP_FRAMES
        undo()
        counted_launches(f"batch {what}",
                         scaled_launches(frame_launches(groups[0][1]), GROUP_FRAMES))
        kinds = [g[0][0] for g in groups]
        if kinds != [kind] or groups[0][2].count != GROUP_FRAMES:
            fail(f"batch {what}: groups {kinds} of {[g[2].count for g in groups]} frames, "
                 f"expected one {kind} group of {GROUP_FRAMES}")
        t0 = time.perf_counter()
        want = [ref.render_frame(sc, size) for sc in built]
        torch.cuda.synchronize()
        loop_ms_ = (time.perf_counter() - t0) * 1e3 / GROUP_FRAMES
        equal_frames(f"batch {what}", frames, want)
        group_checks(f"batch {what}", groups[0], dev)
        print(f"times: batch {what}: one {kind} group of {GROUP_FRAMES} frames, "
              f"{ms:.3f} ms/frame (walks, plans, one upload, executor, sync), the "
              f"render_frame loop over the same scenes {loop_ms_:.3f} ms/frame (one "
              f"synchronize a loop) {tag}", flush=True)
        out[what] = {"kind": kind, "batch_group_ms": ms, "loop_ms": loop_ms_}

    # --- an image update between two groups ---
    red = np.zeros((64, 64, 4), np.uint8)
    red[..., 0] = red[..., 3] = 255
    size = vec2(IMAGE_W, IMAGE_H)

    def with_update(r):
        for f in range(GROUP_FRAMES):
            if f == GROUP_FRAMES // 2:
                r.update_image(IMAGE_ID, red)
            yield make_image_panels_scene(IMAGE_W, IMAGE_H, IMAGE_PANELS, "images_clipped")

    ren, ref = image_renderer(), image_renderer()
    groups, undo = recorded_groups(ren)
    frames = ren.render_batch(with_update(ren), size)
    undo()
    sizes = [g[2].count for g in groups]
    if sizes != [GROUP_FRAMES // 2] * 2:
        fail(f"batch with an update_image: groups of {sizes} frames, expected two of "
             f"{GROUP_FRAMES // 2}")
    equal_frames("batch with an update_image between two groups", frames,
                 [fr.clone() for fr in (ref.render_frame(sc, size) for sc in with_update(ref))])
    if torch.equal(frames[GROUP_FRAMES // 2 - 1], frames[GROUP_FRAMES // 2]):
        fail("batch with an update_image: the update did not show")
    return out


def device_idle(fn) -> dict:
    """The device's busy and idle time in one torch.profiler window around
    fn(): the window runs from the first to the last event of the trace
    (host and device), busy is the union of the device's kernel, copy and
    set intervals in it; idle share = 1 - busy / window."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("cat", ""))
             for e in events if e.get("ph") == "X" and "ts" in e]
    device = sorted((a, b) for a, b, cat in spans
                    if cat in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not device:
        fail(f"the profiler saw no device activity; categories "
             f"{sorted({cat for _a, _b, cat in spans})}")
    start, end = min(a for a, _b, _c in spans), max(b for _a, b, _c in spans)
    busy, cur_a, cur_b = 0.0, None, None
    for a, b in device:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    window = end - start
    return {"idle_share": 1.0 - busy / window, "busy_ms": busy / 1e3,
            "window_ms": window / 1e3}


def async_phase(tag: str, dev) -> dict:
    """ANIM_FRAMES headline frames (1920x1080, 300 boxes) through
    render_frame_async: bit-equal to the synchronous loop's frames, never
    more than two in flight, the counted run's launches (K1 2, blur 2,
    binning 2 a frame); ms/frame of the async loop (each future resolved
    two frames behind, one synchronize at the end) against the synchronous
    loop (render_frame + synchronize a frame: a UI loop that presents each
    frame), best of three; the device's idle share in a torch.profiler
    window of IDLE_FRAMES frames of each; one frame's kernels against their
    plain versions on its own inputs, recorded on the worker thread; a job
    that raises reaches its future, and the next frame renders."""
    import torch

    from figdraw_tpu_torch import FigRenderer, vec2
    from figdraw_tpu_torch.plan import plan_execution
    from figdraw_tpu_torch.scenes import make_render_tree_array

    size = vec2(WIDTH, HEIGHT)
    cache = {}

    def scene(f):
        return make_render_tree_array(WIDTH, HEIGHT, f, copies=COPIES, cache=cache)

    ren, ref = FigRenderer(device="cuda"), FigRenderer(device="cuda")
    ren.render_frame_async(scene(0), size).result()
    torch.cuda.synchronize()

    def async_loop(n, keep=None):
        futs, most = [], 0
        for f in range(n):
            futs.append(ren.render_frame_async(scene(f), size))
            most = max(most, len(ren._async_released))
            if len(futs) > 2:
                done = futs[-3].result()
                if keep is not None:
                    keep.append(done)
        for fut in futs[-2:]:
            done = fut.result()
            if keep is not None:
                keep.append(done)
        torch.cuda.synchronize()
        return most

    def sync_loop(n, keep=None):
        for f in range(n):
            frame = ref.render_frame(scene(f), size)
            torch.cuda.synchronize()
            if keep is not None:
                keep.append(frame)

    zero_counts()
    got = []
    most = async_loop(ANIM_FRAMES, got)
    plan = plan_execution(ref.flatten(scene(0), size))
    counted_launches("async headline", scaled_launches(frame_launches(plan), ANIM_FRAMES))
    want = []
    sync_loop(ANIM_FRAMES, want)
    equal_frames("async headline", got, want)
    print(f"check 11: async headline: at most {most} frames in flight (cap 2)", flush=True)
    if most > 2:
        fail(f"async: {most} frames in flight")
    async_ms, sync_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        async_loop(ANIM_FRAMES)
        async_ms.append((time.perf_counter() - t0) * 1e3 / ANIM_FRAMES)
        t0 = time.perf_counter()
        sync_loop(ANIM_FRAMES)
        sync_ms.append((time.perf_counter() - t0) * 1e3 / ANIM_FRAMES)
    idle_async = device_idle(lambda: async_loop(IDLE_FRAMES))
    idle_sync = device_idle(lambda: sync_loop(IDLE_FRAMES))
    runs, undo = recorded_frames(ren)
    ren.render_frame_async(scene(1), size).result()
    undo()
    plan_kernel_checks("async headline", *runs[0])
    real = ren._run_plan

    def boom(*a, **k):
        raise RuntimeError("injected job failure")

    ren._run_plan = boom
    raised = False
    try:
        ren.render_frame_async(scene(2), size).result()
    except RuntimeError as exc:
        raised = "injected job failure" in str(exc)
    ren._run_plan = real
    again = ren.render_frame_async(scene(3), size).result()
    ok = raised and torch.equal(again, ref.render_frame(scene(3), size))
    print(f"check 11: async: a job that raises reaches its future: {raised}; the next "
          f"frame renders and equals render_frame's: {ok}", flush=True)
    if not ok:
        fail("async: a failed job did not reach its future, or broke the pipeline")
    print(f"times: async headline {WIDTH}x{HEIGHT} {COPIES * 3} boxes, {ANIM_FRAMES} frames: "
          f"render_frame_async {min(async_ms):.3f} ms/frame (best of 3: "
          f"{', '.join(f'{m:.3f}' for m in async_ms)}), render_frame + synchronize a "
          f"frame {min(sync_ms):.3f} ms/frame ({', '.join(f'{m:.3f}' for m in sync_ms)}); "
          f"device idle share in a window of {IDLE_FRAMES} frames: async "
          f"{idle_async['idle_share']:.3f} (busy {idle_async['busy_ms']:.3f} of "
          f"{idle_async['window_ms']:.3f} ms), sync {idle_sync['idle_share']:.3f} (busy "
          f"{idle_sync['busy_ms']:.3f} of {idle_sync['window_ms']:.3f} ms; torch.profiler) "
          f"{tag}", flush=True)
    return {"async_ms": min(async_ms), "sync_ms": min(sync_ms), "async_runs_ms": async_ms,
            "sync_runs_ms": sync_ms, "idle_async": idle_async, "idle_sync": idle_sync}


def overlay_phase(tag: str, dev) -> dict:
    """examples/overlay_3d.py's scene at 420x300 with its numpy pyramid at
    zlevel 0, OVERLAY_FRAMES frames through render_frame_with_overlays:
    each frame within TOL of figdraw_tpu's stored block means; the counted
    run's launches (two layer groups a frame: K1 and a binning each); one
    frame's groups' kernels against their plain versions."""
    import numpy as np
    import torch

    from figdraw_tpu_torch import FigRenderer, vec2
    from figdraw_tpu_torch.scenes import (
        OVERLAY_FRAMES, OVERLAY_REFERENCE, OVERLAY_SIZE, make_overlay_scene,
        overlay_time, rasterize_pyramid,
    )

    w, h = OVERLAY_SIZE
    size = vec2(w, h)
    scene = make_overlay_scene(w, h)
    pyramids = [rasterize_pyramid(w, h, overlay_time(i)) for i in range(OVERLAY_FRAMES)]
    ren = FigRenderer(atlas_size=128, device="cuda")
    ren.render_frame_with_overlays(scene, size, {0: pyramids[0]})
    torch.cuda.synchronize()
    zero_counts()
    frames, ms = [], []
    for i in range(OVERLAY_FRAMES):
        t0 = time.perf_counter()
        frames.append(ren.render_frame_with_overlays(scene, size, {0: pyramids[i]}))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    per = {"K1": 2, "K1-atlas": 0, "K3": 0, "K4": 0, "K4-atlas": 0, "blur": 0, "binning": 2,
           "decode": 2, "plain": 0}
    counted_launches("overlay", scaled_launches(per, OVERLAY_FRAMES))
    stored = np.load(OVERLAY_REFERENCE)
    err = max(float(np.abs(block_means(f.cpu().numpy()) - stored[i]).max())
              for i, f in enumerate(frames))
    print(f"check 11: overlay {w}x{h}, {OVERLAY_FRAMES} frames vs the JAX reference (8x8 "
          f"block means) max |diff| {err:.3e} (tol {TOL:.3e})", flush=True)
    if not err <= TOL or not all(bool(torch.isfinite(f).all()) for f in frames):
        fail(f"overlay frames differ from the JAX reference by {err}")
    runs, undo = recorded_frames(ren)
    ren.render_frame_with_overlays(scene, size, {0: pyramids[1]})
    undo()
    for k, run in enumerate(runs):
        plan_kernel_checks(f"overlay group {k}", *run)
    print(f"times: overlay {w}x{h}: median {statistics.median(ms):.3f} ms/frame "
          f"(two layer groups, the pyramid's upload and blend, sync) {tag}", flush=True)
    return {"ms": statistics.median(ms), "err": err}


def blurred_phase(tag: str, dev) -> dict:
    """The blurred cards (scenes.make_blurred_cards_scene: 400 clipped photo
    cards at 1920x1080, a backdrop blur under a frosted panel, 80 cards
    above it) through render_frame, which plans them onto the rolled
    executor: FRAMES frames; launches as the plan's item table says; K1,
    K1-atlas, K3, the blur and the binning against their plain versions on
    one frame's own inputs; the 480x270 frame (25 cards) against the
    stored block means of figdraw_tpu's unrolled frame executor; ms/frame
    with the walk, the plan and the upload + executor split."""
    import torch

    from figdraw_tpu_torch import vec2
    from figdraw_tpu_torch.plan import plan_execution
    from figdraw_tpu_torch.scenes import (
        BLURRED_REFERENCE, BLURRED_SMALL, make_blurred_cards_scene,
    )

    size = vec2(IMAGE_W, IMAGE_H)
    scene = make_blurred_cards_scene(IMAGE_W, IMAGE_H, IMAGE_PANELS)
    ren = image_renderer()
    ren.render_frame(scene, size)
    torch.cuda.synchronize()
    zero_counts()
    total_ms = timed_frames("blurred cards", lambda: ren.render_frame(scene, size),
                            (IMAGE_H, IMAGE_W, 4))
    tape = ren.flatten(scene, size)
    plan = plan_execution(tape)
    if plan.rolled_items is None or ("blur",) not in plan.structure:
        fail("blurred cards: the planner did not send them to the rolled executor")
    counted_launches("blurred cards", scaled_launches(frame_launches(plan), FRAMES))
    print(f"check 11: blurred cards: {len(plan.structure)} pass items, {tape.count} "
          f"quads, {plan.n_masks} planes, tile_h {plan.tile_h}, rolled", flush=True)
    runs, undo = recorded_frames(ren)
    t0 = time.perf_counter()
    ren.render_frame(scene, size)
    undo()
    worst = plan_kernel_checks("blurred cards", *runs[0])
    print(f"check 11: blurred cards kernel checks took {time.perf_counter() - t0:.1f} s",
          flush=True)
    sw, sh, sn = BLURRED_SMALL
    small = image_renderer().render_frame(make_blurred_cards_scene(sw, sh, sn), vec2(sw, sh))
    err = check_blocks(f"blurred cards {sw}x{sh}, {sn} cards", small, BLURRED_REFERENCE)
    walk_ms, plan_ms, exec_ms = [], [], []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        ren.process_image_messages()
        step = ren.flatten(scene, size)
        t1 = time.perf_counter()
        step = plan_execution(step)
        t2 = time.perf_counter()
        ren.execute_plan(step)
        torch.cuda.synchronize()
        walk_ms.append((t1 - t0) * 1e3)
        plan_ms.append((t2 - t1) * 1e3)
        exec_ms.append((time.perf_counter() - t2) * 1e3)
    med = statistics.median
    device_ms = cuda_ms(lambda: ren.execute_plan(plan), 5)
    print(f"times: blurred cards {IMAGE_W}x{IMAGE_H}, {IMAGE_PANELS} + {IMAGE_PANELS // 5} "
          f"cards, {len(plan.structure)} items: render_frame median {med(total_ms):.3f} "
          f"ms/frame = walk {med(walk_ms):.3f} ms + plan {med(plan_ms):.3f} ms + upload "
          f"and executor to the sync {med(exec_ms):.3f} ms (the executor by CUDA events "
          f"{device_ms:.3f} ms) {tag}", flush=True)
    return {"ms": med(total_ms), "walk_ms": med(walk_ms), "plan_ms": med(plan_ms),
            "exec_ms": med(exec_ms), "device_ms": device_ms, "err": err,
            "items": len(plan.structure), "worst": worst}


IMAGE_REPS = 5  # repeats of each host step of the image-file pipeline
FILE_TOL = 1e-5  # a stored JPEG's, TIFF's or WebP's frames vs figdraw_tpu's block means


def host_ms(fn, reps: int = IMAGE_REPS):
    """Median host ms of fn() over reps runs, and its last result."""
    ms, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms), out


def atlas_modes(plan, calls, census: dict) -> None:
    """Adds to census[kernel][mode] the quads of SDF image modes 13-16 that
    reached an atlas kernel in the recorded kernel calls of one frame of
    `plan` (plan_kernel_checks' calls: the mode words each launch read;
    for a tile pass, its run [bounds) of the tape)."""
    from figdraw_tpu_torch.ops.layout import QI_MODE

    for args, kw in calls:
        if kw.get("atlas") is None:
            continue
        words = args[1][:, QI_MODE].cpu().numpy()
        if plan.mega_combo is not None:
            name = "K4-atlas"
        else:
            name = "K1-atlas"
            b0, b1 = args[2].tolist()
            words = words[b0:b1]
        base = (words % 256) % 128
        for mode in (13, 14, 15, 16):
            n = int((base == mode).sum())
            if n:
                per = census.setdefault(name, {})
                per[mode] = per.get(mode, 0) + n


def span_means(entries) -> dict:
    """Mean host ms of each perf span tag over the buffer's closed spans."""
    out, stack = {}, []
    for e in entries:
        if e.kind == "begin":
            stack.append(e)
        elif e.kind == "end" and stack and stack[-1].tag == e.tag:
            out.setdefault(e.tag, []).append((e.t - stack.pop().t) * 1e3)
    return {k: statistics.mean(v) for k, v in out.items()}


CROP_PIXELS = 20000  # pixels of a GIF's or QOI's stream held to the plain twin
AVIF_STAGE_CALLS = 150  # traced calls of each AV1 stage kind held to its numpy twin
# the stage kinds each stored AVIF's trace must reach: PIL's default save
# (4:2:0 and 4:4:4) runs no post-filter; the speed-2 CDEF file and the
# limited-range 4:2:2 file (4:2:2's CDEF direction map, chroma restoration
# units at ssy 0) also CDEF, Wiener and self-guided restoration; so do
# their 10- and 12-bit rewrites, each stage at its bit depth
AVIF_KINDS = {"fixture_q75.avif": ("predict", "cfl", "txfm", "lf"),
              "fixture_s2_cdef.avif": ("predict", "cfl", "txfm", "lf", "cdef", "wiener", "sgr"),
              "fixture_444.avif": ("predict", "cfl", "txfm", "lf"),
              "fixture_422_limited_cdef.avif": ("predict", "cfl", "txfm", "lf", "cdef", "wiener",
                                                "sgr"),
              "fixture_s2_cdef_10bit.avif": ("predict", "cfl", "txfm", "lf", "cdef", "wiener",
                                             "sgr"),
              "fixture_444_10bit.avif": ("predict", "cfl", "txfm", "lf"),
              "fixture_422_12bit.avif": ("predict", "cfl", "txfm", "lf", "cdef", "wiener", "sgr"),
              # the grids: the fixture's twelve 200x200 tiles, and the 12 MP
              # photo's middle tile (512x512, speed 10)
              "fixture_grid.avif": ("predict", "cfl", "txfm", "lf"),
              "photo_grid_4032x3024.avif": ("predict", "txfm", "lf"),
              # film grain (aom's test vectors 2 and 4): fd_av1_film_grain
              # against film_grain_plain on each grained item's own planes
              # (the first file's alpha item too)
              "fixture_grain.avif": ("predict", "cfl", "txfm", "lf", "grain"),
              "fixture_grain_422_10bit.avif": ("predict", "cfl", "txfm", "lf", "grain"),
              # an image sequence's first frame (a full sequence header; a
              # 64x64 frame at q 50 that neither CfL nor the loop filter
              # reaches), premultiplied: fd_av1_unattenuate against
              # unattenuate_plain on its RGBA, and the card's rewrites of it
              # (avif_rewrites)
              "sequence_prem_64x64.avif": ("predict", "txfm")}


def avif_rewrites(name: str, data: bytes, stored: dict) -> tuple:
    """The files made from the stored sequence `name` by byte edits that
    keep every offset (tools/make_image_formats.py's card_rewrites: its
    prem references renamed, its alpha track marked limited-range, read
    as a still, and that still with an lsel): each decoded to PIL's stored
    digest; fd_av1_alpha_range against alpha_range_plain on the limited
    file's own alpha plane. Returns (the stages held, {stage: (cold ms,
    warm ms)} of the new stages on the sequence's own planes)."""
    import hashlib

    from figdraw_tpu_torch.utils import av1, avif, imagefile

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_image_formats import card_rewrites

    held, made = [], card_rewrites(data)
    for kind, d in made.items():
        px = imagefile.decode_image(d, f"{name} ({kind})")
        ref = stored[kind]
        if (hashlib.sha256(px.tobytes()).hexdigest() != ref["decoded_sha256"]
                or list(px.shape) != ref["shape"]):
            fail(f"image formats: {name} ({kind}) decodes to another RGBA than PIL's stored "
                 "digest")
        held.append(f"{kind} at PIL's digest")
    limited = avif.parse(made["limited alpha"])
    f = av1.decode(limited.alpha)
    if f.full_range:
        fail(f"image formats: {name}'s limited-alpha rewrite decodes to a full-range alpha")
    try:
        av1.alpha_range(f.planes[0], f.width, f.height, f.bit_depth, plain=True)
    except RuntimeError as exc:
        fail(f"image formats: {name}: {exc}")
    held.append("alpha_range")
    t0 = time.perf_counter()
    av1.alpha_range(f.planes[0], f.width, f.height, f.bit_depth)
    cold = (time.perf_counter() - t0) * 1e3
    warm, _ = host_ms(lambda: av1.alpha_range(f.planes[0], f.width, f.height, f.bit_depth))
    return held, {"alpha range": (cold, warm)}


def split_frames(ren, scene, size, frames: int = FRAMES):
    """FRAMES frames of render_frame's two halves timed apart: the host
    (image messages, walk, plan) and the upload, executor and sync. Returns
    (median total ms, host ms list, device ms list)."""
    import torch

    from figdraw_tpu_torch.colors import Color

    host, device = [], []
    for _ in range(frames):
        t0 = time.perf_counter()
        ren.process_image_messages()
        step = ren._walk_plan(scene, size, True, Color(1.0, 1.0, 1.0, 1.0))
        t1 = time.perf_counter()
        ren.execute_plan(step)
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        device.append((time.perf_counter() - t1) * 1e3)
    return statistics.median([a + b for a, b in zip(host, device)]), host, device


# the stored JPEGs decoded whole through the plain twins beside the helper:
# the progressive crop with restarts, the one-scan file without its EOI
# (libjpeg's read-ahead at the end of the data) and the incomplete
# progressive files (block smoothing, Huffman and arithmetic)
PLAIN_JPEGS = ("small_progressive_rst.jpg", "baseline_no_eoi.jpg",
               "progressive_incomplete_huff.jpg", "progressive_incomplete_arith.jpg")


def image_formats_check(tag: str) -> dict:
    """The stored files of the image decoders (figdraw_tpu_torch/reference/
    images, written with PIL by tools/make_image_formats.py): each through
    read_image (the C++ helper, csrc/image_decode.cpp), its RGBA's sha256
    against PIL's stored digest, its cold (first) and warm (median) decode
    host ms; the helper's stages against their plain twins: each JPEG's
    block smoothing (fd_jpeg_smooth, on an incomplete progressive file),
    IDCT, upsampling and colour conversion on its whole frame, the entropy
    decoding on PLAIN_JPEGS (their whole plain decodes), the arithmetic
    (fd_jpeg_arith_scan) and lossless
    (fd_jpeg_lossless_scan) scans on each such file of at most 64x48 (every
    component, then its whole plain decode), GIF's LZW and QOI's ops on the first CROP_PIXELS pixels,
    each TIFF's PackBits, LZW, CCITT fax (fd_tiff_fax, its RLE-W mode among
    them, with the state it
    carries between strips) or Zstandard (fd_zstd_decompress) and
    predictor on every strip or tile (and its whole plain decode), and
    each WebP's stages (webp.stage_pairs:
    fd_webp_vp8 and fd_webp_vp8l whole on a frame of at most CROP_PIXELS
    pixels, fd_webp_upsample and fd_webp_alpha_unfilter on a 64x48 crop;
    the whole plain decode of each such frame), and each AVIF's
    (csrc/av1_decode.cpp through the stage trace: up to AVIF_STAGE_CALLS
    calls of each of the intra predictor, CfL, the inverse transform, the
    loop filter, CDEF and the Wiener and self-guided filters against
    av1.py's twins, every kind of AVIF_KINDS reached, fd_av1_film_grain
    against film_grain_plain on each grained item's own planes,
    fd_av1_to_rgb whole against to_rgba_plain, fd_av1_unattenuate against
    unattenuate_plain on a premultiplied file's RGBA, and the stored
    sequence's byte rewrites through avif_rewrites; its decode split in
    the tiles and loop filter, CDEF, loop restoration, film grain, the RGB
    conversion and the new stages). Returns {file: (cold
    ms, warm ms, shape)}, with "avif stages" {file: {stage: (cold ms, warm
    ms)}}."""
    import hashlib

    import numpy as np

    from figdraw_tpu_torch.scenes import IMAGE_FORMATS_DIR, IMAGE_FORMATS_REFERENCE
    from figdraw_tpu_torch.utils import (
        av1, avif, gif, image_lib, imagefile, jpeg, qoi, tiff, webp,
    )

    with open(IMAGE_FORMATS_REFERENCE) as fh:
        references = json.load(fh)
    stored, rewrites = references["files"], references["rewrites"]
    t0 = time.perf_counter()
    image_lib.load()  # the g++ builds, kept out of the first file's cold decode
    image_lib.load_webp()
    image_lib.load_zstd()
    image_lib.load_av1()
    build_ms = (time.perf_counter() - t0) * 1e3
    times, stages, avif_stages, avif_formats = {}, {}, {}, {}
    for name, ref in sorted(stored.items()):
        path = os.path.join(IMAGE_FORMATS_DIR, name)
        t0 = time.perf_counter()
        px = imagefile.read_image(path)
        cold = (time.perf_counter() - t0) * 1e3
        warm, _ = host_ms(lambda: imagefile.read_image(path))
        times[name] = (cold, warm, list(px.shape))
        if (hashlib.sha256(px.tobytes()).hexdigest() != ref["decoded_sha256"]
                or list(px.shape) != ref["shape"]):
            fail(f"image formats: {name} decodes to another RGBA than PIL's stored digest")
        with open(path, "rb") as fh:
            data = fh.read()
        held = []
        if name.endswith(".jpg"):
            frame = jpeg.read_frame(data)
            lossless = frame.kind == jpeg.LOSSLESS
            latch = jpeg.smoothing_latch(frame)
            planes = []
            for i, c in enumerate(frame.components):
                if lossless:  # no IDCT; replication upsampling (jpeg._full_planes)
                    samples = c.samples
                    method, hx, vy = jpeg.upsample_method(c, frame.hmax, frame.vmax)
                    args = (samples, c.cw, c.ch, frame.width, frame.height, jpeg.BOX, hx, vy)
                else:
                    coefs = c.coefs
                    if latch is not None:  # block smoothing (an incomplete progressive file)
                        sargs = jpeg.smooth_args(frame, c, latch[i])
                        coefs = jpeg.smooth(*sargs)
                        if not np.array_equal(coefs, jpeg.smooth_plain(*sargs)):
                            fail(f"image formats: {name}: fd_jpeg_smooth differs from "
                                 "smooth_plain")
                    samples = jpeg.idct(coefs, c.qt)
                    if not np.array_equal(samples, jpeg.idct_plain(coefs, c.qt)):
                        fail(f"image formats: {name}: fd_jpeg_idct_islow differs from "
                             "idct_plain")
                    args = (samples, c.cw, c.ch, frame.width, frame.height,
                            *jpeg.upsample_method(c, frame.hmax, frame.vmax))
                planes.append(jpeg.upsample(*args))
                if not np.array_equal(planes[-1], jpeg.upsample_plain(*args)):
                    fail(f"image formats: {name}: fd_jpeg_upsample differs from its plain twin")
            held += (["upsample"] if lossless else ["idct", "upsample"]
                     + ["smooth"] * (latch is not None))
            if (frame.arith or lossless) and frame.width * frame.height <= 64 * 48:
                # fd_jpeg_arith_scan or fd_jpeg_lossless_scan against its plain
                # twin: every component's coefficients or samples, then the
                # whole plain decode
                plain = jpeg.read_frame(data, plain=True)
                for a, b in zip(frame.components, plain.components):
                    if not np.array_equal(a.samples if lossless else a.coefs,
                                          b.samples if lossless else b.coefs):
                        fail(f"image formats: {name}: fd_jpeg_"
                             f"{'lossless' if lossless else 'arith'}_scan differs from its "
                             "plain twin")
                if not np.array_equal(jpeg.decode_jpeg(data, plain=True), px):
                    fail(f"image formats: {name}: the plain decode differs from the helper's")
                held += ["lossless scan" if lossless else "arith scan", "plain decode"]
            if jpeg.color_space(frame) in ("YCbCr", "YCCK"):
                kind = jpeg.YCC_RGB if jpeg.color_space(frame) == "YCbCr" else jpeg.YCC_INVERTED
                if not np.array_equal(jpeg.color(*planes[:3], kind),
                                      jpeg.color_plain(*planes[:3], kind)):
                    fail(f"image formats: {name}: fd_jpeg_color differs from color_plain")
                held.append("color")
            if name in PLAIN_JPEGS:
                if not np.array_equal(jpeg.decode_jpeg(data, plain=True), px):
                    fail(f"image formats: {name}: the plain decode (scan_plain or "
                         "arith_scan_plain, smooth_plain and the other twins) differs from "
                         "the helper's")
                held.append("arith scan" if frame.arith else "scan")
        elif name.endswith(".gif"):
            f = gif.read_first_frame(data)
            n = min(CROP_PIXELS, f["box"][2] * f["box"][3])
            if not np.array_equal(gif.lzw(f["stream"], f["min_size"], n),
                                  gif.lzw_plain(f["stream"], f["min_size"], n)):
                fail(f"image formats: {name}: fd_gif_lzw differs from lzw_plain")
            held.append("lzw")
        elif name.endswith(".qoi"):
            if not np.array_equal(qoi.ops(data[14:], CROP_PIXELS),
                                  qoi.ops_plain(data[14:], CROP_PIXELS)):
                fail(f"image formats: {name}: fd_qoi_decode differs from ops_plain")
            held.append("ops")
        elif name.endswith(".tif"):
            for stage, got, want in tiff.stage_pairs(data):
                if not np.array_equal(got, want):
                    fail(f"image formats: {name}: the C++ {stage} stage differs from its "
                         "plain twin")
                if stage not in held:
                    held.append(stage)
            if not np.array_equal(tiff.decode_tiff(data, plain=True), px):
                fail(f"image formats: {name}: the plain decode differs from the helper's")
            held.append("plain decode")
        elif name.endswith(".webp"):
            for stage, got, want in webp.stage_pairs(data, CROP_PIXELS):
                if not np.array_equal(got, want):
                    fail(f"image formats: {name}: fd_webp_{stage} differs from its plain twin")
                if stage not in held:
                    held.append(stage)
            box = webp.read_frame(data).box
            if box[2] * box[3] <= CROP_PIXELS:
                if not np.array_equal(webp.decode_webp(data, plain=True), px):
                    fail(f"image formats: {name}: the plain decode differs from the helper's")
                held.append("plain decode")
        elif name.endswith(".avif"):
            still = avif.parse(data)
            size = (still.width, still.height)
            lib = image_lib.load_av1()
            trace = np.zeros(40 * 1024 * 1024 // 4 * 3, np.int32)
            lib.fd_av1_trace(trace.ctypes.data, trace.size)
            # a grid's tiles while they hold an 800x600 frame's pixels, else
            # its middle tile
            traced = [still.color]
            if still.grid:
                g = still.grid
                traced = (g.tiles if sum(w * h for w, h in g.sizes) <= 800 * 600
                          else [g.tiles[g.rows // 2 * g.columns + g.columns // 2]])
            for stream in traced:
                av1.decode(stream)
            n = lib.fd_av1_trace(None, 0)
            if n <= 0:
                fail(f"image formats: {name}: the AV1 stage trace overflowed")
            try:
                checked = av1.check_trace(trace[:n], limit=AVIF_STAGE_CALLS)
            except RuntimeError as exc:
                fail(f"image formats: {name}: {exc}")
            if "grain" in AVIF_KINDS.get(name, ()):
                # fd_av1_film_grain against its twin on each grained item's
                # planes as the tiles, loop filter, CDEF and restoration left them
                checked["grain"] = 0
                for stream in traced + ([still.alpha] if still.alpha else []):
                    f = av1.decode(stream, grain=False)
                    if not av1.grain_applies(f.grain):
                        continue
                    try:
                        av1.film_grain(f.planes, f.width, f.height, f.grain, plain=True)
                    except RuntimeError as exc:
                        fail(f"image formats: {name}: {exc}")
                    checked["grain"] += 1
            missing = [k for k in AVIF_KINDS.get(name, ("predict",)) if not checked.get(k)]
            if missing:
                fail(f"image formats: {name}: the stage kinds {missing} never ran: {checked}")
            frame = avif.decode_item(still.color, still.grid, size)
            alpha = None
            if still.alpha or still.alpha_grid:
                alpha = avif.decode_item(still.alpha, still.alpha_grid, still.alpha_size,
                                         alpha=True).planes[0]
            y, u, v = frame.planes
            # the colr box's colour description, else the sequence header's
            cp, _tc, mc, full = still.nclx or (frame.primaries, 2, frame.matrix,
                                               frame.full_range)
            conv = av1.conversion(frame.mono, frame.ssx, frame.ssy, full, mc, cp,
                                  alpha is not None, frame.bit_depth)
            rgb = av1.to_rgba(frame, alpha, full, mc, cp)
            if not np.array_equal(rgb, av1.to_rgba_plain(y, u, v, alpha, frame.width,
                                                        frame.height, conv)):
                fail(f"image formats: {name}: fd_av1_to_rgb differs from to_rgba_plain")
            new_stages = {}
            if still.premultiplied:  # PIL's straight alpha from libavif's unpremultiply
                try:
                    straight = av1.unattenuate(rgb, plain=True)
                except RuntimeError as exc:
                    fail(f"image formats: {name}: {exc}")
                t0 = time.perf_counter()
                av1.unattenuate(rgb)
                new_stages["unattenuate"] = ((time.perf_counter() - t0) * 1e3,
                                             host_ms(lambda: av1.unattenuate(rgb))[0])
                rgb = straight
                held.append("unattenuate")
            if not np.array_equal(rgb, px):
                fail(f"image formats: {name}: the stages' RGBA differs from read_image's")
            held += [f"{k} x{c}" for k, c in checked.items() if c] + ["to_rgb"]
            if name in rewrites:
                more, times_of = avif_rewrites(name, data, rewrites[name])
                held += more
                new_stages.update(times_of)
            # the decode's stages (a grid's summed over its tiles, then its
            # assembly): the first run without the trace (cold) and the
            # median of IMAGE_REPS more (warm); the alpha item's whole decode
            first = avif.decode_item(still.color, still.grid, size)
            t0 = time.perf_counter()
            av1.to_rgba(frame, alpha, full, mc, cp)
            rgb_cold = (time.perf_counter() - t0) * 1e3
            runs = [avif.decode_item(still.color, still.grid, size).ms for _ in range(IMAGE_REPS)]
            rgb_warm, _ = host_ms(lambda: av1.to_rgba(frame, alpha, full, mc, cp))
            chroma = {(0, 0): "4:4:4", (1, 0): "4:2:2"}.get((frame.ssx, frame.ssy), "4:2:0")
            layout = (f", a grid of {still.grid.columns}x{still.grid.rows} tiles of "
                      f"{still.grid.sizes[0][0]}x{still.grid.sizes[0][1]}" if still.grid else "")
            avif_formats[name] = (f"{frame.width}x{frame.height}{layout}, {frame.bit_depth}-bit "
                                  f"{'4:0:0' if frame.mono else chroma}, "
                                  f"{'full' if full else 'limited'} range, matrix {mc}"
                                  + (", with alpha" if alpha is not None else ""))
            avif_stages[name] = {k: (first.ms[k], statistics.median(r[k] for r in runs))
                                 for k in first.ms}
            if alpha is not None:
                decode_alpha = (lambda: avif.decode_item(still.alpha, still.alpha_grid,
                                                         still.alpha_size, alpha=True))
                t0 = time.perf_counter()
                decode_alpha()
                alpha_cold = (time.perf_counter() - t0) * 1e3
                avif_stages[name]["alpha item"] = (alpha_cold, host_ms(decode_alpha)[0])
            avif_stages[name]["yuv -> rgba"] = (rgb_cold, rgb_warm)
            avif_stages[name].update(new_stages)
        if held:
            stages[name] = held
    print(f"check 13: the {len(stored)} stored image files (JPEG with Huffman, arithmetic and "
          f"lossless coding, incomplete progressive ones smoothed, one without its EOI; GIF, "
          f"BMP, ICO, QOI, TIFF with CCITT fax, RLE-W, uncompressed mode and ZSTD, WebP, "
          f"AVIF) decode to PIL's stored sha256 through the C++ helper; stages held to their "
          f"plain twins: {json.dumps(stages)}", flush=True)
    print(f"times: image decodes (the helpers' g++ builds {build_ms:.1f} ms first), host ms "
          f"cold (first) / warm (median of {IMAGE_REPS}): "
          + "; ".join(f"{k} {c:.3f} / {w:.3f} ({s[1]}x{s[0]})"
                      for k, (c, w, s) in times.items()) + f" {tag}", flush=True)
    for name, split in avif_stages.items():
        print(f"times: {name}'s decode ({avif_formats[name]}), host ms cold / warm (median of "
              f"{IMAGE_REPS}): " + "; ".join(f"{k} {c:.3f} / {w:.3f}" for k, (c, w) in split.items())
              + f" {tag}", flush=True)
    times["avif stages"] = avif_stages
    return times


def image_files_phase(tag: str, dev) -> dict:
    """Images from files and generated SDFs (the slice of load_image, the
    .flippy cache, utils/png.py and utils/sdfgen.py): the Snappy library
    (native/snappy.cpp, g++) round-trips the fixture's pixels and its
    decoder equals the plain Python one; a cold load_image of a copy of the
    repo's PNG fixture in a temporary directory (decode, bleed, chain,
    compress, write the sidecar) gives the stored digests of PIL's decode
    and of figdraw_tpu's sidecar; a warm load after clear_image_cache reads
    the sidecar and gives the same image and mips; a source newer than its
    sidecar regenerates it. Then render_frame on the image-file scene, the
    MSDF star and the MTSDF scene in each form, held to figdraw_tpu's
    stored block means, and the 1080p photo wall of the loaded image for
    FRAMES frames, its 480x270 reduction held likewise; every path counted
    with the counts set to 0 just before it, one frame of each with its
    kernels against their plain versions on its own inputs, and the SDF
    image modes 13-16 counted where they reach an atlas kernel (the SDF
    scenes' tapes also through the megakernel with the atlas, a check
    beside the main path). The same from the stored baseline JPEG, the
    stored LZW + Predictor 2 TIFF, the stored lossy WebP (q 90) and the
    stored ZSTD + Predictor 2 TIFF of the fixture, the stored progressive
    arithmetic-coded JPEG (SOF10) of the fixture, the lossless JPEG (SOF3)
    of a 224x168 crop (equal to the PNG's pixels), the incomplete
    progressive JPEG of the fixture (block smoothing), the RLE-W TIFF of
    its dithered centre and the fixture's AVIFs (PIL's default save,
    speed 2 with CDEF, 4:4:4, and limited-range BT.709 4:2:2 with CDEF and
    loop restoration; the CDEF file and the 4:4:4 file at 10 bits, the
    4:2:2 file at 12; a grid of 4x3 tiles with an alpha grid; film grain:
    aom's test vector 2 with a vignette alpha, and vector 4 at 4:2:2 made
    10-bit; an image sequence, premultiplied, and its byte rewrite with a
    limited-range alpha track), and a 12 MP
    AVIF grid of the fixture scaled to 4032x3024 loaded cold and warm (not
    drawn), its decode split printed (image_formats_check
    first: every stored format against PIL's digests): load_image cold and
    warm against figdraw_tpu's sidecar digest, the image-file scene on
    K1-atlas and the photo wall on K4-atlas, each within FILE_TOL of
    figdraw_tpu's stored block means; the fixture dithered to 1 bit as a
    Group 3 fax in the image-file scene, and the TIFF-F Group 4 fax page
    (1728x1143) loaded cold and warm and on the photo wall (its atlas
    started at FAX_ATLAS, as figdraw_tpu's reference), likewise; the
    fixture's lossless WebP and ZSTD tiles decode to the PNG's pixels. Host times of
    each step of the pipeline, each photo wall's ms/frame with its host
    and device split and its perf span means."""
    import dataclasses
    import hashlib
    import shutil
    import tempfile

    import numpy as np
    import torch

    from figdraw_tpu_torch import FigRenderer, vec2
    from figdraw_tpu_torch import resources
    from figdraw_tpu_torch.basics import fig_ui_scale, scaled, set_fig_ui_scale
    from figdraw_tpu_torch.colors import Color
    from figdraw_tpu_torch.ops import mega, raster
    from figdraw_tpu_torch.plan import pack_mega_combo, plan_execution
    from figdraw_tpu_torch.scenes import (
        ARITH_FILE_REFERENCE, ARITH_FIXTURE, AVIF_422_FILE_REFERENCE, AVIF_422_FIXTURE,
        AVIF_422_WALL_REFERENCE, AVIF_422_12_FILE_REFERENCE, AVIF_422_12_FIXTURE,
        AVIF_422_12_WALL_REFERENCE, AVIF_444_10_FILE_REFERENCE, AVIF_444_10_FIXTURE,
        AVIF_444_10_WALL_REFERENCE, AVIF_444_FILE_REFERENCE, AVIF_444_FIXTURE,
        AVIF_444_WALL_REFERENCE, AVIF_CDEF10_FILE_REFERENCE, AVIF_CDEF10_FIXTURE,
        AVIF_CDEF10_WALL_REFERENCE, AVIF_CDEF_FILE_REFERENCE, AVIF_CDEF_FIXTURE,
        AVIF_CDEF_WALL_REFERENCE, AVIF_FILE_REFERENCE, AVIF_FIXTURE, AVIF_GRID_FILE_REFERENCE,
        AVIF_GRAIN_422_10_FILE_REFERENCE, AVIF_GRAIN_422_10_FIXTURE,
        AVIF_GRAIN_422_10_WALL_REFERENCE, AVIF_GRAIN_FILE_REFERENCE, AVIF_GRAIN_FIXTURE,
        AVIF_GRAIN_WALL_REFERENCE, AVIF_SEQUENCE_FILE_REFERENCE, AVIF_SEQUENCE_FIXTURE,
        AVIF_SEQUENCE_LIMITED_FILE_REFERENCE, AVIF_SEQUENCE_LIMITED_WALL_REFERENCE,
        AVIF_SEQUENCE_WALL_REFERENCE,
        AVIF_GRID_FIXTURE, AVIF_GRID_WALL_REFERENCE, AVIF_PHOTO_FIXTURE,
        AVIF_WALL_REFERENCE, EXAMPLE_FORMS, EXAMPLE_IMAGES, EXAMPLE_SCENES,
        FAX_ATLAS, FAX_PAGE, G3_FILE_REFERENCE, LOSSLESS_FIXTURE, LOSSLESS_WALL_REFERENCE,
        G3_FIXTURE, G4_WALL_REFERENCE, IMAGE_FILE_SIZE, IMAGE_FIXTURE,
        INCOMPLETE_FILE_REFERENCE, INCOMPLETE_FIXTURE, INCOMPLETE_WALL_REFERENCE,
        RLEW_FILE_REFERENCE, RLEW_FIXTURE, RLEW_WALL_REFERENCE,
        IMAGE_FIXTURE_REFERENCE, IMAGE_FORMATS_REFERENCE, JPEG_FILE_REFERENCE, JPEG_FIXTURE,
        JPEG_WALL_REFERENCE, PHOTO_WALL_PANELS, PHOTO_WALL_REFERENCE, PHOTO_WALL_SIZE,
        PHOTO_WALL_SMALL, TIFF_FILE_REFERENCE, TIFF_FIXTURE, TIFF_WALL_REFERENCE,
        WEBP_FILE_REFERENCE, WEBP_FIXTURE, WEBP_WALL_REFERENCE, ZSTD_FILE_REFERENCE,
        ZSTD_FIXTURE, ZSTD_TILES_BOX, ZSTD_WALL_REFERENCE, example_reference_path,
        make_image_file_scene,
        make_loaded_photo_wall,
    )
    from figdraw_tpu_torch.utils import flippy, imagefile, perf, png

    t_phase = time.perf_counter()
    with open(IMAGE_FIXTURE_REFERENCE) as fh:
        stored = json.load(fh)
    decode_ms, pixels = host_ms(lambda: png.read_image(IMAGE_FIXTURE))
    raw = pixels.tobytes()
    if hashlib.sha256(raw).hexdigest() != stored["decoded_sha256"]:
        fail("image files: the PNG decode of the fixture differs from PIL's stored digest")
    zip_ms, packed = host_ms(lambda: flippy.snappy_compress(raw))
    unzip_ms, back = host_ms(lambda: flippy.snappy_uncompress(packed))
    if back != raw or flippy._py_uncompress(packed) != back:
        fail("image files: the Snappy library's round trip, or its decoder against "
             "the plain Python decoder, differs")
    print(f"check 13: Snappy (native/snappy.cpp) round-trips the fixture's "
          f"{len(raw)} pixel bytes ({len(packed)} compressed) and its decoder equals "
          f"_py_uncompress; the PNG decode equals PIL's stored sha256", flush=True)
    decodes = image_formats_check(tag)
    with open(IMAGE_FORMATS_REFERENCE) as fh:
        file_sidecars = json.load(fh)["sidecar"]
    chain_ms, chain = host_ms(lambda: flippy.image_to_flippy(pixels))
    census = {}
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, os.path.basename(IMAGE_FIXTURE))
        shutil.copyfile(IMAGE_FIXTURE, path)
        side = os.path.join(td, "timing.flippy")
        write_ms, _ = host_ms(lambda: flippy.save_flippy(chain, side))
        read_ms, _ = host_ms(lambda: flippy.load_flippy(side))
        # --- cold and warm loads ---
        bus = resources.ImageMessageBus()
        sub = bus.subscribe()
        t0 = time.perf_counter()
        cold = resources.load_image(path, bus=bus)
        cold_ms = (time.perf_counter() - t0) * 1e3
        with open(path + ".flippy", "rb") as fh:
            sidecar = fh.read()
        if hashlib.sha256(sidecar).hexdigest() != stored["sidecar_sha256"]:
            fail("image files: the sidecar differs from figdraw_tpu's stored digest")
        resources.clear_image_cache(bus=bus)
        t0 = time.perf_counter()
        warm = resources.load_image(path, bus=bus)
        warm_ms = (time.perf_counter() - t0) * 1e3
        puts = [m for m in sub.drain() if m.kind == resources.ImageMsgKind.PutImage]
        a, b = puts[0], puts[-1]
        same = (len(puts) == 2 and np.array_equal(a.image, b.image)
                and len(a.mips) == len(b.mips) == len(chain.mipmaps) - 1
                and all(np.array_equal(x, y) for x, y in zip(a.mips, b.mips))
                and hashlib.sha256(np.ascontiguousarray(b.image).tobytes()).hexdigest()
                == stored["decoded_sha256"])
        if not same:
            fail("image files: the warm load (the sidecar) differs from the cold one")
        # the sidecar made older than its source: the next load rewrites it
        old = os.path.getmtime(path) - 10
        os.utime(path + ".flippy", (old, old))
        resources.clear_image_cache(bus=bus)
        resources.load_image(path, bus=bus).close()
        with open(path + ".flippy", "rb") as fh:
            fresh = fh.read()
        if not (os.path.getmtime(path + ".flippy") > old and fresh == sidecar):
            fail("image files: a source newer than its sidecar did not regenerate it")
        cold.close()
        warm.close()
        print(f"check 13: load_image cold (decode, bleed, chain, compress, write "
              f"{len(sidecar)} bytes) gives figdraw_tpu's stored sidecar sha256; warm "
              f"(the sidecar) equals it, image and {len(a.mips)} mips; a newer source "
              f"regenerated the same sidecar", flush=True)
        # the stored baseline JPEG and TIFF fixture: cold, then warm
        def cold_warm(src, what):
            """load_image of a copy of src cold and warm: (path, cold ms,
            warm ms, the decoded image); the sidecar against figdraw_tpu's
            stored digest, the warm image and mips against the cold ones."""
            fpath = os.path.join(td, os.path.basename(src))
            shutil.copyfile(src, fpath)
            fsub = bus.subscribe()
            t0 = time.perf_counter()
            resources.load_image(fpath, bus=bus).close()
            fcold_ms = (time.perf_counter() - t0) * 1e3
            with open(fpath + ".flippy", "rb") as fh:
                fside = fh.read()
            if hashlib.sha256(fside).hexdigest() != file_sidecars[os.path.basename(src)]:
                fail(f"image files: the {what}'s sidecar differs from figdraw_tpu's stored "
                     "digest")
            resources.clear_image_cache(bus=bus)
            t0 = time.perf_counter()
            resources.load_image(fpath, bus=bus).close()
            fwarm_ms = (time.perf_counter() - t0) * 1e3
            fid = resources.image_id_from_path(fpath)
            fputs = [m for m in fsub.drain()
                     if m.kind == resources.ImageMsgKind.PutImage and m.id == fid]
            if not (len(fputs) == 2 and np.array_equal(fputs[0].image, fputs[1].image)
                    and all(np.array_equal(x, y) for x, y in zip(fputs[0].mips, fputs[1].mips))):
                fail(f"image files: the {what}'s warm load (the sidecar) differs from its cold "
                     "one")
            print(f"check 13: load_image of the {what} cold (the C++ decoders, bleed, "
                  f"chain, compress, write {len(fside)} bytes) gives figdraw_tpu's stored "
                  f"sidecar sha256; warm (the sidecar) equals it, image and "
                  f"{len(fputs[0].mips)} mips", flush=True)
            return fpath, fcold_ms, fwarm_ms, fputs[0].image

        jpath, jcold_ms, jwarm_ms, _jimage = cold_warm(JPEG_FIXTURE, "baseline JPEG")
        tpath, tcold_ms, twarm_ms, timage = cold_warm(TIFF_FIXTURE, "LZW + Predictor 2 TIFF")
        if hashlib.sha256(np.ascontiguousarray(timage).tobytes()).hexdigest() != \
                stored["decoded_sha256"]:
            fail("image files: the TIFF of the fixture decodes to other pixels than the PNG")
        wpath, wcold_ms, wwarm_ms, _wimage = cold_warm(WEBP_FIXTURE, "lossy WebP (q 90)")
        lossless = imagefile.read_image(os.path.join(os.path.dirname(WEBP_FIXTURE),
                                                     "fixture_lossless.webp"))
        if hashlib.sha256(lossless.tobytes()).hexdigest() != stored["decoded_sha256"]:
            fail("image files: the lossless WebP of the fixture decodes to other pixels than "
                 "the PNG")
        print("check 13: the fixture's lossless WebP decodes to the PNG's pixels (sha256)",
              flush=True)
        zpath, zcold_ms, zwarm_ms, zimage = cold_warm(ZSTD_FIXTURE, "ZSTD + Predictor 2 TIFF")
        ztiles = imagefile.read_image(os.path.join(os.path.dirname(ZSTD_FIXTURE),
                                                   "fixture_zstd_tiles.tif"))
        if hashlib.sha256(np.ascontiguousarray(zimage).tobytes()).hexdigest() != \
                stored["decoded_sha256"]:
            fail("image files: the fixture's ZSTD + Predictor 2 TIFF decodes to other pixels "
                 "than the PNG")
        x0, y0, x1, y1 = ZSTD_TILES_BOX
        if not np.array_equal(np.asarray(ztiles), pixels[y0:y1, x0:x1]):
            fail("image files: the ZSTD tiles decode to other pixels than the PNG's crop")
        print("check 13: the fixture's ZSTD TIFFs decode to the PNG's pixels (Predictor 2 "
              "strips, sha256) and to its crop ZSTD_TILES_BOX (64x64 tiles)", flush=True)
        gpath, gcold_ms, gwarm_ms, _gimage = cold_warm(FAX_PAGE, "Group 4 fax page (1728x1143)")
        apath, acold_ms, awarm_ms, _aimage = cold_warm(ARITH_FIXTURE,
                                                       "progressive arithmetic JPEG (SOF10)")
        lpath, lcold_ms, lwarm_ms, limage = cold_warm(LOSSLESS_FIXTURE,
                                                      "lossless JPEG crop (SOF3, 224x168)")
        if not np.array_equal(np.asarray(limage)[..., :3], pixels[216:384, 288:512, :3]):
            fail("image files: the lossless JPEG crop decodes to other pixels than the PNG's")
        print("check 13: the lossless JPEG crop decodes to the PNG's pixels", flush=True)
        ipath, icold_ms, iwarm_ms, _iimage = cold_warm(
            INCOMPLETE_FIXTURE, "incomplete progressive JPEG (block smoothing)")
        rpath, rcold_ms, rwarm_ms, _rimage = cold_warm(RLEW_FIXTURE, "RLE-W TIFF (400x300)")
        vpath, vcold_ms, vwarm_ms, _vimage = cold_warm(AVIF_FIXTURE, "AVIF (q 75, 4:2:0)")
        cpath, ccold_ms, cwarm_ms, _cimage = cold_warm(
            AVIF_CDEF_FIXTURE, "AVIF (speed 2, CDEF and loop restoration)")
        fpath, fcold_ms, fwarm_ms, _fimage = cold_warm(AVIF_444_FIXTURE, "AVIF (4:4:4)")
        kpath, kcold_ms, kwarm_ms, _kimage = cold_warm(
            AVIF_422_FIXTURE, "AVIF (4:2:2, limited-range BT.709, CDEF and loop restoration)")
        # the three rewritten to 10 and 12 bits
        c10path, c10cold_ms, c10warm_ms, _c10image = cold_warm(
            AVIF_CDEF10_FIXTURE, "10-bit AVIF (speed 2, CDEF and loop restoration)")
        f10path, f10cold_ms, f10warm_ms, _f10image = cold_warm(AVIF_444_10_FIXTURE,
                                                               "10-bit AVIF (4:4:4)")
        k12path, k12cold_ms, k12warm_ms, _k12image = cold_warm(
            AVIF_422_12_FIXTURE,
            "12-bit AVIF (4:2:2, limited-range BT.709, CDEF and loop restoration)")
        # the grids: the fixture with an alpha grid (drawn below) and the
        # 12 MP photo (loaded, not drawn), with its bleed and chain alone
        xpath, xcold_ms, xwarm_ms, _ximage = cold_warm(
            AVIF_GRID_FIXTURE, "AVIF grid (4x3 tiles of 200x200, an alpha grid)")
        _ppath, pcold_ms, pwarm_ms, pimage = cold_warm(
            AVIF_PHOTO_FIXTURE, "12 MP AVIF grid (4032x3024, 8x6 tiles of 512x512)")
        # film grain: aom's test vector 2 with the vignette alpha, and
        # vector 4 at 4:2:2 made 10-bit
        npath, ncold_ms, nwarm_ms, _nimage = cold_warm(
            AVIF_GRAIN_FIXTURE, "AVIF with film grain (vector 2, its alpha item grained too)")
        n10path, n10cold_ms, n10warm_ms, _n10image = cold_warm(
            AVIF_GRAIN_422_10_FIXTURE, "10-bit 4:2:2 AVIF with film grain (vector 4)")
        # an image sequence's first frame, premultiplied, and the same
        # file with its alpha track marked limited-range (a byte rewrite)
        spath, scold_ms, swarm_ms, _simage = cold_warm(
            AVIF_SEQUENCE_FIXTURE, "AVIF image sequence (2 frames of 64x64, premultiplied)")
        sys.path.insert(0, os.path.join(REPO, "tools"))
        from make_image_formats import card_rewrites

        slpath = os.path.join(td, "sequence_limited_alpha.avif")
        with open(AVIF_SEQUENCE_FIXTURE, "rb") as fh:
            limited_bytes = card_rewrites(fh.read())["limited alpha"]
        with open(slpath, "wb") as fh:
            fh.write(limited_bytes)
        pchain_ms, _ = host_ms(lambda: flippy.image_to_flippy(pimage), 3)
        g3path = os.path.join(td, os.path.basename(G3_FIXTURE))
        shutil.copyfile(G3_FIXTURE, g3path)

        # --- render_frame: the image-file scene and the SDF scenes in each form ---
        def checked_frame(what, make, ref_path, tol=TOL):
            """make() -> (renderer, scene, frame size): the frame's first
            render uploads the atlas; the counted one runs with the counts
            set to 0 just before; its kernels against their plain versions
            on its own inputs; its blocks within tol of the stored ones."""
            ren, scene, size = make()
            ren.render_frame(scene, size)
            torch.cuda.synchronize()
            zero_counts()
            frame = ren.render_frame(scene, size)
            torch.cuda.synchronize()
            plan = plan_execution(ren.flatten(scene, scaled(size)))
            counted_launches(what, frame_launches(plan))
            runs, undo = recorded_frames(ren)
            ren.render_frame(scene, size)
            undo()
            calls = []
            plan_kernel_checks(what, *runs[0], calls=calls)
            atlas_modes(plan, calls, census)
            check_blocks(what, frame, ref_path, tol)
            if not bool(torch.isfinite(frame).all()):
                fail(f"{what}: non-finite frame")
            return ren, plan, calls

        timed, refs = {}, []  # refs: the loaded images' owners, alive to the end
        for form, (ps, ui, mult) in EXAMPLE_FORMS.items():
            old = fig_ui_scale()
            set_fig_ui_scale(ui)
            try:
                def make_file(ps=ps, mult=mult):
                    ren = FigRenderer(atlas_size=512, device="cuda", pixel_scale=ps)
                    bus = resources.ImageMessageBus()
                    ren.ensure_image_message_subscription(bus)
                    refs.append(resources.load_image(path, bus=bus))
                    w, h = IMAGE_FILE_SIZE
                    return (ren, make_image_file_scene(w, h, refs[-1].id),
                            vec2(w * mult, h * mult))

                checked_frame(f"image_file {form}", make_file,
                              example_reference_path("image_file", form))
                for name in EXAMPLE_IMAGES:
                    def make_sdf(name=name, ps=ps, mult=mult):
                        build, (w, h) = EXAMPLE_SCENES[name]
                        ren = FigRenderer(device="cuda", pixel_scale=ps)
                        bus = resources.ImageMessageBus()
                        ren.ensure_image_message_subscription(bus)
                        for image_id, image in EXAMPLE_IMAGES[name]():
                            resources.put_image(image_id, image, bus=bus)
                        return ren, build(w, h), vec2(w * mult, h * mult)

                    ren, plan, calls = checked_frame(
                        f"{name} {form}", make_sdf, example_reference_path(name, form))
                    if form == "1x":
                        timed[name] = [c for c in calls if c[1].get("atlas") is not None]
                        # the same tape through the megakernel with the
                        # atlas: the MSDF branch of K4-atlas, beside the
                        # main path (its launches are not counted)
                        build, (w, h) = EXAMPLE_SCENES[name]
                        tape = ren.flatten(build(w, h), vec2(w, h))
                        mplan = dataclasses.replace(
                            plan_execution(tape), mega_combo=pack_mega_combo(tape),
                            mega_atlas=True)
                        mcalls = []
                        plan_kernel_checks(
                            f"{name} on K4-atlas", mplan,
                            torch.from_numpy(mplan.mega_combo).to(dev, copy=True),
                            ren._device_atlas(), calls=mcalls)
                        atlas_modes(mplan, mcalls, census)
            finally:
                set_fig_ui_scale(old)
        missing = [(k, m) for k in ("K1-atlas", "K4-atlas") for m in (13, 14, 15, 16)
                   if not census.get(k, {}).get(m)]
        print(f"check 13: SDF image modes reaching the atlas kernels, quads by kernel "
              f"and mode {census} (every one of 13-16 on each)", flush=True)
        if missing:
            fail(f"image files: no quad of (kernel, mode) {missing} reached an atlas kernel")

        def file_scene(src, what, ref_path):
            """The image-file scene of the image loaded from src on K1-atlas,
            within FILE_TOL of ref_path: (median ms/frame, host ms, device ms)."""
            def make():
                ren = FigRenderer(atlas_size=512, device="cuda")
                fbus = resources.ImageMessageBus()
                ren.ensure_image_message_subscription(fbus)
                refs.append(resources.load_image(src, bus=fbus))
                w, h = IMAGE_FILE_SIZE
                return ren, make_image_file_scene(w, h, refs[-1].id), vec2(w, h)

            fren, fplan, fcalls = checked_frame(f"image_file {what} 1x", make, ref_path,
                                                FILE_TOL)
            on_k1_atlas = any(kw.get("atlas") is not None for _a, kw in fcalls)
            if not on_k1_atlas or fplan.mega_combo is not None:
                fail(f"image_file {what}: the frame did not run K1-atlas")
            fscene = make_image_file_scene(*IMAGE_FILE_SIZE, refs[-1].id)
            return split_frames(fren, fscene, vec2(*IMAGE_FILE_SIZE))

        file_frames = {"jpeg": file_scene(jpath, "jpeg", JPEG_FILE_REFERENCE),
                       "tiff": file_scene(tpath, "tiff", TIFF_FILE_REFERENCE),
                       "webp": file_scene(wpath, "webp", WEBP_FILE_REFERENCE),
                       "zstd": file_scene(zpath, "zstd", ZSTD_FILE_REFERENCE),
                       "g3": file_scene(g3path, "g3", G3_FILE_REFERENCE),
                       "arith": file_scene(apath, "arith", ARITH_FILE_REFERENCE),
                       "incomplete": file_scene(ipath, "incomplete", INCOMPLETE_FILE_REFERENCE),
                       "rlew": file_scene(rpath, "rlew", RLEW_FILE_REFERENCE),
                       "avif": file_scene(vpath, "avif", AVIF_FILE_REFERENCE),
                       "avif cdef": file_scene(cpath, "avif cdef", AVIF_CDEF_FILE_REFERENCE),
                       "avif 444": file_scene(fpath, "avif 444", AVIF_444_FILE_REFERENCE),
                       "avif 422": file_scene(kpath, "avif 422", AVIF_422_FILE_REFERENCE),
                       "avif cdef 10-bit": file_scene(c10path, "avif cdef 10-bit",
                                                      AVIF_CDEF10_FILE_REFERENCE),
                       "avif 444 10-bit": file_scene(f10path, "avif 444 10-bit",
                                                     AVIF_444_10_FILE_REFERENCE),
                       "avif 422 12-bit": file_scene(k12path, "avif 422 12-bit",
                                                     AVIF_422_12_FILE_REFERENCE),
                       "avif grid": file_scene(xpath, "avif grid", AVIF_GRID_FILE_REFERENCE),
                       "avif grain": file_scene(npath, "avif grain", AVIF_GRAIN_FILE_REFERENCE),
                       "avif grain 422 10-bit": file_scene(n10path, "avif grain 422 10-bit",
                                                           AVIF_GRAIN_422_10_FILE_REFERENCE),
                       "avif sequence": file_scene(spath, "avif sequence",
                                                   AVIF_SEQUENCE_FILE_REFERENCE),
                       "avif sequence limited alpha": file_scene(
                           slpath, "avif sequence limited alpha",
                           AVIF_SEQUENCE_LIMITED_FILE_REFERENCE)}

        # --- the 1080p photo wall of each loaded image ---
        def photo_wall(src, small_ref, what, tol=TOL, atlas=256):
            """The wall of the image at src: FRAMES counted frames, its perf
            spans, its kernels against their plain versions, the 480x270
            wall within tol of small_ref, the host and device split; the
            atlases start at `atlas`."""
            w, h = PHOTO_WALL_SIZE
            size = vec2(w, h)
            ren = FigRenderer(atlas_size=atlas, device="cuda")
            wall_bus = resources.ImageMessageBus()
            ren.ensure_image_message_subscription(wall_bus)
            refs.append(resources.load_image(src, bus=wall_bus))
            scene = make_loaded_photo_wall(w, h, PHOTO_WALL_PANELS, refs[-1].id)
            ren.render_frame(scene, size)
            torch.cuda.synchronize()
            plan = plan_execution(ren.flatten(scene, size))
            if not plan.mega_atlas:
                fail(f"{what}: the planner did not send it to the megakernel with the atlas")
            perf._global_perf.clear()
            zero_counts()
            wall_ms = timed_frames(what, lambda: ren.render_frame(scene, size), (h, w, 4))
            spans = span_means(perf._global_perf.entries)
            perf._global_perf.clear()
            counted_launches(what, scaled_launches(frame_launches(plan), FRAMES))
            if set(spans) != {"frame", "messages", "flatten", "execute"}:
                fail(f"{what}: render_frame recorded the spans {sorted(spans)}")
            runs, undo = recorded_frames(ren)
            ren.render_frame(scene, size)
            undo()
            wall_calls = []
            plan_kernel_checks(what, *runs[0], calls=wall_calls)
            sw, sh, sn = PHOTO_WALL_SMALL
            small = FigRenderer(atlas_size=atlas, device="cuda")
            small_bus = resources.ImageMessageBus()
            small.ensure_image_message_subscription(small_bus)
            refs.append(resources.load_image(src, bus=small_bus))
            small_scene = make_loaded_photo_wall(sw, sh, sn, refs[-1].id)
            checked_frame(f"{what} {sw}x{sh}", lambda: (small, small_scene, vec2(sw, sh)),
                          small_ref, tol)
            _ms, host, device = split_frames(ren, scene, size)
            return dict(ms=wall_ms, host=host, device=device, spans=spans, plan=plan,
                        calls=wall_calls, atlas=ren.atlas.size)

        walls = {"png": photo_wall(path, PHOTO_WALL_REFERENCE, "photo wall"),
                 "jpeg": photo_wall(jpath, JPEG_WALL_REFERENCE, "photo wall jpeg", FILE_TOL),
                 "tiff": photo_wall(tpath, TIFF_WALL_REFERENCE, "photo wall tiff", FILE_TOL),
                 "webp": photo_wall(wpath, WEBP_WALL_REFERENCE, "photo wall webp", FILE_TOL),
                 "zstd": photo_wall(zpath, ZSTD_WALL_REFERENCE, "photo wall zstd", FILE_TOL),
                 "g4": photo_wall(gpath, G4_WALL_REFERENCE, "photo wall g4", FILE_TOL,
                                  FAX_ATLAS),
                 "lossless": photo_wall(lpath, LOSSLESS_WALL_REFERENCE, "photo wall lossless",
                                        FILE_TOL),
                 "incomplete": photo_wall(ipath, INCOMPLETE_WALL_REFERENCE,
                                          "photo wall incomplete", FILE_TOL),
                 "rlew": photo_wall(rpath, RLEW_WALL_REFERENCE, "photo wall rlew", FILE_TOL),
                 "avif": photo_wall(vpath, AVIF_WALL_REFERENCE, "photo wall avif", FILE_TOL),
                 "avif cdef": photo_wall(cpath, AVIF_CDEF_WALL_REFERENCE, "photo wall avif cdef",
                                         FILE_TOL),
                 "avif 444": photo_wall(fpath, AVIF_444_WALL_REFERENCE, "photo wall avif 444",
                                        FILE_TOL),
                 "avif 422": photo_wall(kpath, AVIF_422_WALL_REFERENCE, "photo wall avif 422",
                                        FILE_TOL),
                 "avif cdef 10-bit": photo_wall(c10path, AVIF_CDEF10_WALL_REFERENCE,
                                                "photo wall avif cdef 10-bit", FILE_TOL),
                 "avif 444 10-bit": photo_wall(f10path, AVIF_444_10_WALL_REFERENCE,
                                               "photo wall avif 444 10-bit", FILE_TOL),
                 "avif 422 12-bit": photo_wall(k12path, AVIF_422_12_WALL_REFERENCE,
                                               "photo wall avif 422 12-bit", FILE_TOL),
                 "avif grid": photo_wall(xpath, AVIF_GRID_WALL_REFERENCE, "photo wall avif grid",
                                         FILE_TOL),
                 "avif grain": photo_wall(npath, AVIF_GRAIN_WALL_REFERENCE,
                                          "photo wall avif grain", FILE_TOL),
                 "avif grain 422 10-bit": photo_wall(n10path, AVIF_GRAIN_422_10_WALL_REFERENCE,
                                                     "photo wall avif grain 422 10-bit",
                                                     FILE_TOL),
                 "avif sequence": photo_wall(spath, AVIF_SEQUENCE_WALL_REFERENCE,
                                             "photo wall avif sequence", FILE_TOL),
                 "avif sequence limited alpha": photo_wall(
                     slpath, AVIF_SEQUENCE_LIMITED_WALL_REFERENCE,
                     "photo wall avif sequence limited alpha", FILE_TOL)}
        for ref in refs:
            ref.close()
    med = statistics.median
    # the atlas kernels on this slice's frames: K1-atlas on the MSDF star's
    # draw, K4-atlas on the photo wall
    star_args, star_kw = timed["msdf_star"][0]
    k1a = dict(
        ms=cuda_ms(lambda: raster.draw_pass_planar_prebinned(*star_args, **star_kw), 20),
        device_ms=device_ms_of(lambda: raster.draw_pass_planar_prebinned(*star_args, **star_kw),
                               "raster_tiles_kernel<false, true>"),
        plain_ms=cuda_ms(lambda: raster.draw_pass_planar_prebinned_plain(*star_args, **star_kw), 3),
        work=raster_work(star_args, star_kw))
    wall_args, wall_kw = walls["png"]["calls"][0]
    k4a = dict(
        ms=cuda_ms(lambda: mega.draw_pass_mega(*wall_args, **wall_kw), 20),
        device_ms=device_ms_of(lambda: mega.draw_pass_mega(*wall_args, **wall_kw),
                               "mega_kernel<true>"),
        plain_ms=cuda_ms(lambda: mega.draw_pass_mega_plain(*wall_args, **wall_kw), 3),
        work=mega_work(wall_args, wall_kw))
    print(f"times: image files, host (median of {IMAGE_REPS}): PNG decode {decode_ms:.3f} ms "
          f"(800x600 RGBA8); bleed + chain {chain_ms:.3f} ms ({len(chain.mipmaps)} "
          f"levels); sidecar write {write_ms:.3f} ms; sidecar read {read_ms:.3f} ms; "
          f"Snappy compress {len(raw) / zip_ms / 1e3:.1f} MB/s, uncompress "
          f"{len(raw) / unzip_ms / 1e3:.1f} MB/s; load_image cold {cold_ms:.3f} ms, "
          f"warm {warm_ms:.3f} ms; the baseline JPEG's load_image cold {jcold_ms:.3f} ms, "
          f"warm {jwarm_ms:.3f} ms; the LZW + Predictor 2 TIFF's load_image cold "
          f"{tcold_ms:.3f} ms, warm {twarm_ms:.3f} ms; the lossy WebP's load_image cold "
          f"{wcold_ms:.3f} ms, warm {wwarm_ms:.3f} ms; the ZSTD + Predictor 2 TIFF's "
          f"load_image cold {zcold_ms:.3f} ms, warm {zwarm_ms:.3f} ms; the Group 4 fax page's "
          f"(1728x1143) load_image cold {gcold_ms:.3f} ms, warm {gwarm_ms:.3f} ms; the SOF10 "
          f"JPEG's load_image cold {acold_ms:.3f} ms, warm {awarm_ms:.3f} ms; the SOF3 crop's "
          f"(224x168) load_image cold {lcold_ms:.3f} ms, warm {lwarm_ms:.3f} ms; the incomplete "
          f"progressive JPEG's load_image cold {icold_ms:.3f} ms, warm {iwarm_ms:.3f} ms; the "
          f"RLE-W TIFF's (400x300) load_image cold {rcold_ms:.3f} ms, warm {rwarm_ms:.3f} ms; "
          f"the AVIF's load_image cold {vcold_ms:.3f} ms, warm {vwarm_ms:.3f} ms; the speed-2 "
          f"CDEF AVIF's load_image cold {ccold_ms:.3f} ms, warm {cwarm_ms:.3f} ms; the 4:4:4 "
          f"AVIF's load_image cold {fcold_ms:.3f} ms, warm {fwarm_ms:.3f} ms; the 4:2:2 "
          f"limited-range AVIF's load_image cold {kcold_ms:.3f} ms, warm {kwarm_ms:.3f} ms; "
          f"the 10-bit CDEF AVIF's load_image cold {c10cold_ms:.3f} ms, warm "
          f"{c10warm_ms:.3f} ms; the 10-bit 4:4:4 AVIF's load_image cold {f10cold_ms:.3f} ms, "
          f"warm {f10warm_ms:.3f} ms; the 12-bit 4:2:2 AVIF's load_image cold "
          f"{k12cold_ms:.3f} ms, warm {k12warm_ms:.3f} ms; the AVIF grid's (with its alpha "
          f"grid) load_image cold {xcold_ms:.3f} ms, warm {xwarm_ms:.3f} ms; the film grain "
          f"AVIF's (with its alpha) load_image cold {ncold_ms:.3f} ms, warm {nwarm_ms:.3f} ms; "
          f"the 10-bit 4:2:2 film grain AVIF's load_image cold {n10cold_ms:.3f} ms, warm "
          f"{n10warm_ms:.3f} ms; the AVIF image sequence's (premultiplied, 64x64) load_image "
          f"cold {scold_ms:.3f} ms, warm {swarm_ms:.3f} ms {tag}", flush=True)
    split = decodes["avif stages"]["photo_grid_4032x3024.avif"]
    print(f"times: the 12 MP AVIF grid (4032x3024, 48 tiles of 512x512), host ms cold / warm: "
          + "; ".join(f"{k} {c:.3f} / {w:.3f}" for k, (c, w) in split.items())
          + f" (the tiles' stages summed over 48 tiles); load_image cold (decode, bleed, "
          f"chain, compress, write) {pcold_ms:.3f}, of which bleed + chain alone "
          f"{pchain_ms:.3f} (median of 3); warm (the sidecar) {pwarm_ms:.3f} {tag}", flush=True)
    for src, (f_ms, f_host, f_dev) in file_frames.items():
        print(f"times: image_file scene from the {src.upper()}, 800x600 on K1-atlas: median "
              f"{f_ms:.3f} ms/frame = host (messages, walk, plan) {med(f_host):.3f} ms "
              f"+ upload, executor and sync {med(f_dev):.3f} ms {tag}", flush=True)
    w, h = PHOTO_WALL_SIZE
    for src, wall in walls.items():
        print(f"times: photo wall {w}x{h} from the {src.upper()}, {PHOTO_WALL_PANELS} panels "
              f"of the loaded image, {len(wall['plan'].structure)} pass items, atlas "
              f"{wall['atlas']}: median {med(wall['ms']):.3f} ms/frame (render_frame + sync) "
              f"= host (messages, walk, plan) {med(wall['host']):.3f} ms + upload, executor "
              f"and sync {med(wall['device']):.3f} ms; perf spans, mean ms over {FRAMES} "
              f"frames: " + ", ".join(f"{k} {wall['spans'][k]:.3f}"
                                      for k in ("frame", "messages", "flatten", "execute"))
              + f" {tag}", flush=True)
    print(f"times: K1-atlas on the MSDF star's draw {k1a['ms']:.4f} ms (events), "
          f"{k1a['device_ms']:.4f} ms alone, plain torch {k1a['plain_ms']:.2f} ms, "
          f"{bound_text(k1a['work'])}; K4-atlas on the photo wall {k4a['ms']:.4f} ms "
          f"(events), {k4a['device_ms']:.4f} ms alone, plain torch "
          f"{k4a['plain_ms']:.2f} ms, {bound_text(k4a['work'])} {tag}", flush=True)
    print(f"image files phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(census=census, k1a=k1a, k4a=k4a, decodes=decodes)


# --- the C ABI for external hosts (capi_phase) -------------------------------------

CAPI_FRAMES = 12  # frames or patches of each C-ABI timing and counted run (medians)
CAPI_RESERVE = 2  # inert rows at the end of each root's span (the retained recipe)
RETAINED_BOXES = 12000  # bench_retained.py's largest grid
TEXT_LINES = 36  # bench_text's lines
PACK_REF = os.path.join(REF_DIR, "fdtp_DejaVuSans.json")
NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")


def _cptr(arr):
    import ctypes

    return ctypes.c_void_p(arr.ctypes.data)


def capi_scene(lib, renders):
    """A RendersArray fed to the scene-building C ABI row by row, as an
    external host builds its scene: each layer in ascending zlevel, each
    node in order through fd_renders_add_root or fd_renders_add_child, a
    drawable's ops (and bezier points) through fd_renders_add_op and a text
    node's glyph and rect rows through fd_renders_add_text first, their
    starts read from the layer's counts. Returns the FdRenders handle (free
    it with fd_renders_free)."""
    import numpy as np

    from figdraw_tpu_torch.nodesarray import FIG_DTYPE

    handle = lib.fd_renders_new()
    row = np.zeros((), FIG_DTYPE)
    for lvl, lst in renders.sorted_pairs():
        nodes = lst.nodes[: lst.count]
        ops, points = lst.ops_view()
        glyphs, trects = lst.text_view()
        if list(lst.root_ids) != sorted(lst.root_ids):
            raise ValueError("the C ABI adds roots in node order")
        for i in range(lst.count):
            row[...] = nodes[i]
            n_ops = int(row["ops_count"])
            if n_ops:
                row["ops_start"] = lib.fd_renders_op_count(handle, lvl)
                first = int(nodes[i]["ops_start"])
                for op in np.split(ops[first : first + n_ops], n_ops):
                    n_pts = int(op["p_count"][0])
                    p0 = int(op["p_start"][0])
                    pts = np.ascontiguousarray(points[p0 : p0 + n_pts])
                    lib.fd_renders_add_op(handle, lvl, _cptr(op),
                                          _cptr(pts) if n_pts else None, n_pts)
            n_glyphs, n_rects = int(row["glyphs_count"]), int(row["trects_count"])
            if n_glyphs or n_rects:
                row["glyphs_start"] = lib.fd_renders_glyph_count(handle, lvl)
                row["trects_start"] = lib.fd_renders_trect_count(handle, lvl)
                g0, t0 = int(nodes[i]["glyphs_start"]), int(nodes[i]["trects_start"])
                g = np.ascontiguousarray(glyphs[g0 : g0 + n_glyphs])
                t = np.ascontiguousarray(trects[t0 : t0 + n_rects])
                lib.fd_renders_add_text(handle, lvl, _cptr(g) if n_glyphs else None,
                                        n_glyphs, _cptr(t) if n_rects else None, n_rects)
            parent = int(row["parent"])
            got = (lib.fd_renders_add_root(handle, lvl, _cptr(row)) if parent < 0
                   else lib.fd_renders_add_child(handle, lvl, parent, _cptr(row)))
            if got != i:
                lib.fd_renders_free(handle)
                raise RuntimeError(f"layer {lvl} node {i} was added as node {got}")
    return handle


def capi_context(lib, ren):
    """A walk context configured from a port renderer as a C host configures
    it (fd_create with the UI scale, pixel scale and coverage slope, then
    fd_set_text_config, fd_set_glyph_offsets, fd_set_atlas and
    fd_set_white_uv). Free it with fd_destroy."""
    import ctypes

    from figdraw_tpu_torch.basics import fig_ui_scale

    ctx = lib.fd_create(ctypes.c_float(fig_ui_scale()), ctypes.c_float(ren.pixel_scale),
                        ctypes.c_float(ren.aa_factor))
    (ids, levels, rects), edge, (u, v) = ren._walk_atlas()
    config, offsets = ren._walk_text()
    lib.fd_set_text_config(ctx, *(int(c) for c in config))
    if offsets is not None:
        keys, offs = offsets
        lib.fd_set_glyph_offsets(ctx, _cptr(keys), _cptr(offs), keys.shape[0])
    lib.fd_set_atlas(ctx, _cptr(ids), _cptr(levels), _cptr(rects), ids.shape[0],
                     ctypes.c_float(float(edge)))
    lib.fd_set_white_uv(ctx, ctypes.c_double(u), ctypes.c_double(v))
    return ctx


def capi_tape(lib, renders, ren, w, h, clear=(1.0, 1.0, 1.0, 1.0), times=None):
    """`renders` built through the C ABI (capi_scene), walked by
    fd_flatten_renders on a context configured from `ren` and exported by
    native.export_tape: the tape a C host hands to FigRenderer.execute.
    times: None, or a dict whose lists "build", "walk" and "export" each
    get the step's ms."""
    from figdraw_tpu_torch import native

    t0 = time.perf_counter()
    handle = capi_scene(lib, renders)
    t1 = time.perf_counter()
    ctx = capi_context(lib, ren)
    try:
        lib.fd_flatten_renders(ctx, handle)
        t2 = time.perf_counter()
        tape = native.export_tape(ctx, w, h, clear)
        t3 = time.perf_counter()
    finally:
        lib.fd_destroy(ctx)
        lib.fd_renders_free(handle)
    if times is not None:
        for key, ms in (("build", t1 - t0), ("walk", t2 - t1), ("export", t3 - t2)):
            times.setdefault(key, []).append(ms * 1e3)
    return tape


def capi_snapshot(lib, handle, ren, w, h, reserve=CAPI_RESERVE):
    """The retained recipe's snapshot: fd_flatten_renders_spans on a fresh
    context configured from `ren`, each root's span ending in `reserve`
    inert rows. Returns (tape, spans (roots, 2) i32 in flatten order)."""
    import numpy as np

    from figdraw_tpu_torch import native

    n = lib.fd_renders_root_count(handle)
    spans = np.zeros((n, 2), np.int32)
    ctx = capi_context(lib, ren)
    try:
        if lib.fd_flatten_renders_spans(ctx, handle, _cptr(spans), n, reserve) != n:
            raise RuntimeError("fd_flatten_renders_spans refused the span table")
        return native.export_tape(ctx, w, h, (1.0, 1.0, 1.0, 1.0)), spans
    finally:
        lib.fd_destroy(ctx)


def capi_patch(lib, handle, ren, tape, spans, dirty) -> None:
    """The retained recipe's patch of a snapshot tape, in place: each dirty
    root, (zlevel, position in its layer's roots, index into spans),
    re-walked alone by fd_flatten_renders_root on one scratch context,
    padded with fd_pad_rows to its span, and its rows spliced over the
    span. Raises ValueError where the recipe cannot patch in place (a root
    grew past its span, or the dirty roots emit a mask, a blur or a
    backdrop: re-flatten then). Patch a tape before planning it."""
    from figdraw_tpu_torch import native

    scratch = capi_context(lib, ren)
    try:
        lengths = []
        for lvl, pos, k in dirty:
            got = lib.fd_flatten_renders_root(scratch, handle, lvl, pos)
            span = int(spans[k, 1] - spans[k, 0])
            if not 0 <= got <= span:
                raise ValueError(f"root {pos} of layer {lvl} gave {got} rows for a span of {span}")
            lib.fd_pad_rows(scratch, span - got)
            lengths.append(span)
        if lib.fd_mask_count(scratch) or lib.fd_item_count(scratch) > 1:
            raise ValueError("the dirty roots emit a mask, a blur or a backdrop")
        rows = native.export_tape(scratch, *tape.frame_size)
    finally:
        lib.fd_destroy(scratch)
    r = 0
    for (_lvl, _pos, k), n in zip(dirty, lengths):
        s = int(spans[k, 0])
        tape.fields[s : s + n] = rows.fields[r : r + n]
        tape.modes[s : s + n] = rows.modes[r : r + n]
        r += n


def same_tape(a, b) -> bool:
    """Two tapes with the same rows, byte for byte, pass items and mask
    count."""
    import numpy as np

    n = a.count
    return (n == b.count and a.items == b.items and a.mask_count == b.mask_count
            and np.array_equal(a.fields[:n].view(np.uint32), b.fields[:n].view(np.uint32))
            and np.array_equal(a.modes[:n], b.modes[:n]))


def tape_copy(tape):
    """A new tape with a copy of `tape`'s rows, items and frame: the patched
    snapshot stays unplanned (planning packs a tape once)."""
    from figdraw_tpu_torch.tape import Tape

    out = Tape(capacity=max(tape.count, 1))
    out.fields[: tape.count] = tape.fields[: tape.count]
    out.modes[: tape.count] = tape.modes[: tape.count]
    out.count, out.items, out.mask_count = tape.count, list(tape.items), tape.mask_count
    out.frame_size, out.clear_color = tape.frame_size, tape.clear_color
    out.tile_density = tape.tile_density
    return out


def text_lines(seed: int = 0) -> list:
    """bench_text's strings (scenes.make_text_scene)."""
    return ["The quick brown fox jumps over the lazy dog near the riverbank %d" % (seed + row)
            for row in range(TEXT_LINES)]


def cold_typeset(which: str) -> dict:
    """Typesetting bench_text's 36 lines in a fresh process, from the
    bundled DejaVuSans: `py`, the port's Python typesetter (the first
    typeset decodes the shaper's tables), or `c`, the C typesetter (the
    face load, the FDTP pack's build and load, then the first typesets).
    Prints one JSON line of ms: the first pass (cold) and the median of
    three more (warm)."""
    from figdraw_tpu_torch import fill, rgba, vec2
    from figdraw_tpu_torch.text import layout, native_typeset
    from figdraw_tpu_torch.text.typefaces import FigFont, bundled_font_path, load_typeface

    t0 = time.perf_counter()
    tid = load_typeface(bundled_font_path())
    out = {"load_ms": (time.perf_counter() - t0) * 1e3}
    if which == "c":
        native_typeset.build()
        t0 = time.perf_counter()
        native_typeset.pack_blob(tid)
        out["pack_ms"] = (time.perf_counter() - t0) * 1e3

        def one_pass():
            for s in text_lines():
                native_typeset.typeset_box(tid, s, 15.0, bounds=(1180.0, 22.0))
    else:
        ink = fill(rgba(20, 20, 30, 255))

        def one_pass():
            for s in text_lines():
                layout.typeset(vec2(1180, 22), [(FigFont(typeface_id=tid, size=15.0), ink, s)])
    passes = []
    for _ in range(4):
        t0 = time.perf_counter()
        one_pass()
        passes.append((time.perf_counter() - t0) * 1e3)
    out.update(cold_ms=passes[0], warm_ms=statistics.median(passes[1:]))
    print(json.dumps(out), flush=True)
    return out


def run_cold_typeset(which: str) -> dict:
    """cold_typeset in a new Python process (nothing loaded or decoded yet)."""
    code = f"import chip_smoke; chip_smoke.cold_typeset({which!r})"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.abspath(__file__)), timeout=300)
    if res.returncode != 0:
        fail(f"cold typeset ({which}) failed: {res.stderr[-2000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def capi_checked_frames(what: str, ren, make_tape, frames: int) -> list:
    """`frames` frames of C-built tapes through ren.execute with the counts
    set to 0 just before and read just after (the launches of
    frame_launches a frame), then one more with each kernel held against
    its plain version on the frame's own inputs. Returns the ms of each
    counted frame (the tape, execute, the synchronize)."""
    import torch

    from figdraw_tpu_torch.plan import plan_execution

    plan = plan_execution(make_tape())
    ren.execute(make_tape())
    torch.cuda.synchronize()
    zero_counts()
    ms = timed_frames(what, lambda: ren.execute(make_tape()),
                      (plan.height, plan.width, 4), frames)
    counted_launches(what, scaled_launches(frame_launches(plan), frames))
    runs, undo = recorded_frames(ren)
    try:
        ren.execute(make_tape())
    finally:
        undo()
    torch.cuda.synchronize()
    rplan, combo, atlas, init = runs[0]
    plan_kernel_checks(what, rplan, combo, atlas, init)
    return ms


def equal_frame(what: str, got, want, ref: str = "render_frame's") -> None:
    import torch

    same = bool(torch.equal(got, want))
    print(f"check 14: {what}: the frame through the C ABI and execute equals {ref} "
          f"bit for bit: {same}", flush=True)
    if not same:
        fail(f"{what}: frames differ by {float((got - want).abs().max())}")


def capi_examples(tag: str, tid: int, tmp: str) -> dict:
    """The C examples of native/examples compiled with gcc against the
    port's own builds (by the libraries' full paths: utils.gxx names them
    lib<name>_<hash>.so) and run: scene_demo (a layered scene and the
    retained patch), shim_demo (native/figdraw.h: scene, a typeset label,
    borders, the patch; on a pack save_font_pack writes from the bundled
    DejaVuSans) and typeset_demo (a line, a wrapped box and the refusal of
    a mark, on the same pack)."""
    import shutil

    from figdraw_tpu_torch import native
    from figdraw_tpu_torch.nodesarray import FIG_DTYPE
    from figdraw_tpu_torch.text import native_pack, native_typeset

    gcc = shutil.which("gcc")
    if gcc is None:
        fail("no gcc to build the C examples")
    flatten_lib, typeset_lib = native._build(), native_typeset.build()
    rpath = f"-Wl,-rpath,{os.path.dirname(flatten_lib)}"
    offs = {name: FIG_DTYPE.fields[name][1]
            for name in ("ops_start", "draw_weight", "draw_stroke_fill")}

    def build(name, libs, *defs):
        exe = os.path.join(tmp, name)
        res = subprocess.run([gcc, os.path.join(NATIVE_DIR, "examples", name + ".c"),
                              "-I", NATIVE_DIR, *defs, *libs, rpath, "-o", exe],
                             capture_output=True, text=True)
        if res.returncode != 0:
            fail(f"{name}.c does not build: {res.stderr[-2000:]}")
        return exe

    def run(exe, *args, code=0):
        res = subprocess.run([exe, *args], capture_output=True, text=True, timeout=120)
        if res.returncode != code:
            fail(f"{os.path.basename(exe)} {args} exited {res.returncode}: {res.stderr[-1000:]}")
        return dict(kv.split("=") for line in res.stdout.splitlines() for kv in line.split())

    pack = os.path.join(tmp, "dejavu.fdtp")
    native_pack.save_font_pack(tid, pack)
    scene = run(build("scene_demo", [flatten_lib],
                      *(f"-DFD_OFF_{k.upper()}={v}" for k, v in offs.items())))
    shim = run(build("shim_demo", [flatten_lib, typeset_lib]), pack)
    demo = build("typeset_demo", [typeset_lib])
    text = "Office flow AVATAR"
    line = run(demo, pack, text)
    gids, _x, _c, baseline = native_typeset.typeset_line(tid, text, 24.0)
    bg, _bx, _by, _bc, bsize = native_typeset.typeset_box(tid, text, 24.0, bounds=(160, 0),
                                                          h_align=1, wrap=True)
    refused = subprocess.run([demo, pack, "cafe\u0301"], capture_output=True).returncode
    ok = {
        "scene_demo": int(scene["quads"]) >= 3 and int(scene["patch_ok"]) == 1,
        "shim_demo": (int(shim["quads"]) > 0 and int(shim["patch_ok"]) == 1
                      and int(shim["label_glyphs"]) > 0 and int(shim["dashed_idx"]) >= 0
                      and int(shim["dotted_idx"]) > int(shim["dashed_idx"])),
        "typeset_demo": (int(line["glyphs"]) == len(gids)
                         and int(line["first_gid"]) == int(gids[0])
                         and float(line["baseline"]) == baseline
                         and int(line["box_glyphs"]) == len(bg)
                         and abs(float(line["box_w"]) - bsize[0]) < 0.05
                         and abs(float(line["box_h"]) - bsize[1]) < 0.05 and refused == 2),
    }
    print(f"check 14: the C examples against the port's builds ({os.path.basename(flatten_lib)}, "
          f"{os.path.basename(typeset_lib)}): scene_demo quads {scene['quads']} patch_ok "
          f"{scene['patch_ok']}; shim_demo quads {shim['quads']} patch_ok {shim['patch_ok']} "
          f"label_glyphs {shim['label_glyphs']}; typeset_demo glyphs {line['glyphs']} box "
          f"{line['box_w']}x{line['box_h']}, the mark refused with exit {refused}: {ok} "
          f"{tag}", flush=True)
    if not all(ok.values()):
        fail(f"a C example disagrees with the port: {ok}")
    return ok | {"pack_bytes": os.path.getsize(pack)}


def capi_phase(tag: str) -> dict:
    """The C ABI for external hosts on the card (check 14):

    (a) bench.py's headline scene (1920x1080, 300 boxes, draw -> blur r=18
        -> draw with the backdrop) fed row by row through fd_renders_*
        (capi_scene), walked by fd_flatten_renders, exported by
        native.export_tape and run by FigRenderer(device="cuda").execute:
        the tape equals flatten's of the array byte for byte and the frame
        render_frame's bit for bit; CAPI_FRAMES frames counted (K1 2, the
        blur 2 and the front end 1 a frame), the kernels held against their
        plain versions on one frame's inputs; the C ABI's build, walk and
        export a frame against flatten_fast of the array;
    (b) bench_text's scene (1200x800, 36 lines of the bundled DejaVuSans)
        through fd_renders_add_text with the renderer's atlas, glyph
        offsets, text config and white texel, executed through K1-atlas:
        the tape and the frame as in (a); beside it the C typesetter on the
        36 strings, from the FDTP pack of the bundled face (its sha256
        against reference/fdtp_DejaVuSans.json), glyph for glyph with the
        port's Python typesetter within 1e-3 px; each typesetter's cold and
        warm times from a fresh process;
    (c) bench_retained's grid of 12000 boxes with 8 dirty roots a frame,
        the C retained recipe (fd_flatten_renders_spans with a reserve,
        fd_renders_set_fig, fd_flatten_renders_root on a scratch context):
        each patched tape equals a full re-flatten byte for byte, and its
        frame on the card the full one's bit for bit;
    and the C examples (capi_examples)."""
    import hashlib
    import tempfile
    import unicodedata

    import numpy as np

    from figdraw_tpu_torch import FigRenderer, fill, native, rgba, vec2
    from figdraw_tpu_torch.basics import fig_ui_scale
    from figdraw_tpu_torch.scenes import build_grid, make_render_tree_array, make_text_scene
    from figdraw_tpu_torch.text import layout, native_typeset
    from figdraw_tpu_torch.text.typefaces import FigFont, bundled_font_path, load_typeface

    med = statistics.median
    lib = native.load()
    t_phase = time.perf_counter()
    out = {}

    # --- (a) the headline through the C ABI ---
    size = vec2(WIDTH, HEIGHT)
    ren = FigRenderer(device="cuda")
    cache = {}
    arr = make_render_tree_array(WIDTH, HEIGHT, 0, copies=COPIES, cache=cache)
    tape = capi_tape(lib, arr, ren, WIDTH, HEIGHT)
    want = ren.flatten(arr, size)
    same = same_tape(tape, want)
    print(f"check 14: headline {WIDTH}x{HEIGHT} through fd_renders_* ({arr[0].count} nodes): "
          f"{tape.count} quads, {len(tape.items)} items; the tape equals flatten's of the "
          f"array byte for byte: {same}", flush=True)
    if not same:
        fail("the C-built headline tape differs from flatten's")
    got = ren.execute(tape)
    equal_frame("headline", got, FigRenderer(device="cuda").render_frame(arr, size))
    frame_no = [0]

    def headline_tape():
        frame_no[0] += 1
        return capi_tape(lib, make_render_tree_array(WIDTH, HEIGHT, frame_no[0],
                                                     copies=COPIES, cache=cache),
                         ren, WIDTH, HEIGHT)

    frame_ms = capi_checked_frames("capi headline", ren, headline_tape, CAPI_FRAMES)
    steps, fast_ms = {}, []
    for f in range(CAPI_FRAMES):
        scene = make_render_tree_array(WIDTH, HEIGHT, 100 + f, copies=COPIES, cache=cache)
        capi_tape(lib, scene, ren, WIDTH, HEIGHT, times=steps)
        t0 = time.perf_counter()
        native.flatten_fast(scene, WIDTH, HEIGHT, fig_ui_scale(), ren.pixel_scale,
                            ren.aa_factor, (1.0, 1.0, 1.0, 1.0), atlas=ren._walk_atlas(),
                            text=ren._walk_text())
        fast_ms.append((time.perf_counter() - t0) * 1e3)
    out["headline"] = {k: med(v) for k, v in steps.items()}
    out["headline"].update(flatten_fast_ms=med(fast_ms), frame_ms=med(frame_ms))
    h = out["headline"]
    print(f"times: capi headline, medians of {CAPI_FRAMES} frames: the C ABI's build "
          f"{h['build']:.3f} ms (capi_scene: {arr[0].count} rows through ctypes), walk "
          f"{h['walk']:.3f} ms (fd_flatten_renders), export {h['export']:.3f} ms "
          f"(export_tape); flatten_fast of the array {h['flatten_fast_ms']:.3f} ms; a frame "
          f"(C-ABI tape, execute, synchronize) {h['frame_ms']:.3f} ms {tag}", flush=True)

    # --- (b) text through fd_renders_add_text, and the C typesetter ---
    tid = load_typeface(bundled_font_path())
    ink = fill(rgba(20, 20, 30, 255))
    scene, n_glyphs = make_text_scene(tid, ink, 0)
    tsize = vec2(1200, 800)
    tren = FigRenderer(atlas_size=512, device="cuda")
    want = tren.flatten(scene, tsize)  # rasterizes the glyphs into the atlas
    tape = capi_tape(lib, scene, tren, 1200, 800)
    same = same_tape(tape, want)
    print(f"check 14: bench_text's scene through fd_renders_add_text ({n_glyphs} glyphs, "
          f"{len(tren.atlas.entries)} atlas entries): {tape.count} quads; the tape equals "
          f"flatten's byte for byte: {same}", flush=True)
    if not same:
        fail("the C-built text tape differs from flatten's")
    got = tren.execute(tape)
    equal_frame("text", got, tren.render_frame(scene, tsize))
    text_ms = capi_checked_frames(
        "capi text", tren, lambda: capi_tape(lib, scene, tren, 1200, 800), CAPI_FRAMES)
    blob = native_typeset.pack_blob(tid)
    digest = hashlib.sha256(blob).hexdigest()
    with open(PACK_REF) as fh:
        ref = json.load(fh)
    print(f"check 14: the FDTP pack of {os.path.relpath(bundled_font_path())}: {len(blob)} "
          f"bytes, sha256 {digest} ({'as' if digest == ref['pack_sha256'] else 'NOT as'} "
          f"pinned by the CPU test); unicodedata {unicodedata.unidata_version} (the pin's "
          f"{ref['unidata_version']}), Python {sys.version.split()[0]}", flush=True)
    if digest != ref["pack_sha256"]:
        fail(f"the pack's sha256 {digest} is not the pinned {ref['pack_sha256']}")
    worst, n_cmp = 0.0, 0
    for s in text_lines():
        arr_py = layout.typeset(vec2(1180, 22), [(FigFont(typeface_id=tid, size=15.0), ink, s)])
        gids, xs, ys, clus, _size = native_typeset.typeset_box(tid, s, 15.0,
                                                               bounds=(1180.0, 22.0))
        py = arr_py.arranged_glyphs
        if len(gids) != len(py) or any(int(g) != p.glyph_id or int(c) != p.cluster
                                       for g, c, p in zip(gids, clus, py)):
            fail(f"the C typesetter's glyphs differ from the Python one's on {s!r}")
        for x, y, p in zip(xs, ys, py):
            worst = max(worst, abs(float(x) - (p.pos.x + p.offset.x)),
                        abs(float(y) - (p.pos.y + p.offset.y)))
        n_cmp += len(py)
    print(f"check 14: the C typesetter on bench_text's {TEXT_LINES} strings: {n_cmp} glyphs "
          f"equal to the Python typesetter's glyph for glyph, positions max |diff| "
          f"{worst:.3e} px (tol 1e-3)", flush=True)
    if not worst < 1e-3:
        fail(f"the C typesetter's positions differ from the Python one's by {worst}")
    cold = {"py": run_cold_typeset("py"), "c": run_cold_typeset("c")}
    out["text"] = {"frame_ms": med(text_ms), "pack_sha256": digest, "pack_bytes": len(blob),
                   "max_pos_err": worst, "typeset": cold}
    print(f"times: typesetting bench_text's {TEXT_LINES} lines, each in a fresh process: "
          f"Python cold {cold['py']['cold_ms']:.3f} ms (the first typeset decodes the "
          f"shaper's tables), warm {cold['py']['warm_ms']:.3f} ms; C cold "
          f"{cold['c']['cold_ms']:.3f} ms (the first typesets on a loaded pack), warm "
          f"{cold['c']['warm_ms']:.3f} ms, after the pack's build and load "
          f"{cold['c']['pack_ms']:.3f} ms (build_font_pack: the shaper's tables, the "
          f"Unicode tables; fd_pack_load); face load {cold['py']['load_ms']:.3f} / "
          f"{cold['c']['load_ms']:.3f} ms; a frame (C-ABI tape, execute, synchronize) "
          f"{med(text_ms):.3f} ms {tag}", flush=True)

    # --- (c) the C retained recipe at 12000 boxes ---
    grid, boxes = build_grid(RETAINED_BOXES, WIDTH, HEIGHT)
    lst = grid[0]
    rows = lst.nodes[: lst.count].copy()
    pos_of = {int(r): p for p, r in enumerate(lst.root_ids)}
    rren = FigRenderer(device="cuda")
    handle = capi_scene(lib, grid)
    edits = [0]

    def patched():
        """The next frame's DIRTY_ROOTS edits through fd_renders_set_fig and
        the patch of the snapshot; returns the ms."""
        f = edits[0]
        edits[0] += 1
        t0 = time.perf_counter()
        dirty = []
        for k in range(DIRTY_ROOTS):
            b = boxes[(f * DIRTY_ROOTS + k) % len(boxes)]
            x, y, w, hh = rows["box"][b]
            rows["box"][b] = (x, (y + 3 + f) % HEIGHT, w, hh)
            rows["fill"]["c0"][b] = ((b * 13 + f) % 255, 120, 220, 180)
            if lib.fd_renders_set_fig(handle, 0, b, _cptr(rows[b : b + 1])) != 0:
                fail(f"fd_renders_set_fig refused node {b}")
            dirty.append((0, pos_of[b], pos_of[b]))
        capi_patch(lib, handle, rren, snap, spans, dirty)
        return (time.perf_counter() - t0) * 1e3

    try:
        snap, spans = capi_snapshot(lib, handle, rren, WIDTH, HEIGHT)
        patch_ms, full_ms, equal = [], [], 0
        for _ in range(CAPI_FRAMES):
            patch_ms.append(patched())
            t0 = time.perf_counter()
            full, full_spans = capi_snapshot(lib, handle, rren, WIDTH, HEIGHT)
            full_ms.append((time.perf_counter() - t0) * 1e3)
            equal += same_tape(snap, full) and np.array_equal(spans, full_spans)
        print(f"check 14: retained {RETAINED_BOXES} boxes through the C ABI ({snap.count} "
              f"rows with {CAPI_RESERVE} reserve rows a root), {DIRTY_ROOTS} dirty roots a "
              f"patch: {equal} of {CAPI_FRAMES} patched tapes equal a full re-flatten byte "
              f"for byte", flush=True)
        if equal != CAPI_FRAMES:
            fail("a patched tape differs from the full re-flatten")
        got = rren.execute(tape_copy(snap))
        equal_frame("retained", got, FigRenderer(device="cuda").execute(full),
                    "the full re-flatten's")

        def patched_tape():
            patched()
            return tape_copy(snap)

        exec_ms = capi_checked_frames("capi retained", rren, patched_tape, CAPI_FRAMES)
        if not same_tape(snap, capi_snapshot(lib, handle, rren, WIDTH, HEIGHT)[0]):
            fail("the patched tape of the counted frames differs from a full re-flatten")
    finally:
        lib.fd_renders_free(handle)
    out["retained"] = {"patch_ms": med(patch_ms), "full_ms": med(full_ms),
                       "frame_ms": med(exec_ms), "rows": snap.count}
    print(f"times: capi retained {RETAINED_BOXES} boxes, medians of {CAPI_FRAMES}: the "
          f"patch of {DIRTY_ROOTS} roots (fd_renders_set_fig, fd_flatten_renders_root, "
          f"fd_pad_rows, export, splice) {med(patch_ms):.3f} ms against a full re-flatten "
          f"and export {med(full_ms):.3f} ms; a frame (the patch, a copy of the tape, "
          f"execute, synchronize) {med(exec_ms):.3f} ms {tag}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        out["examples"] = capi_examples(tag, tid, tmp)
    print(f"capi phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def frameloop_phases(tag: str, dev) -> dict:
    """The frame loop's entry points, each path counted with the counts set
    to 0 just before it and read just after."""
    t0 = time.perf_counter()
    out = {"batch": batch_phase(tag, dev), "async": async_phase(tag, dev),
           "overlay": overlay_phase(tag, dev), "blurred": blurred_phase(tag, dev)}
    print(f"frame loop phases: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


FONT_PHASE_TOL = 3e-4  # K1-atlas and K4-atlas against their plain versions, fonts phase
NEW_FACE_TOL = 1e-5  # the same for the WOFF, VARC and WOFF2 faces' scenes (checks 17, 18)
# the faces of the WOFF and VARC phase (lines `check 17`) and of the WOFF2
# phase (`check 18`: scenes.WOFF2_FACES); the fonts phase (`check 15`)
# takes the others of scenes.FONT_FACES
NEW_FACES = ("FigPortSans-VF.woff", "FigPortSans-VARC.ttf")
WOFF2_TWINS = {"DejaVuSans.woff2": "DejaVuSans.ttf",
               "FigPortSans-VF.woff2": "FigPortSans-VF.ttf",
               "FigPortSans-CFF.woff2": "FigPortSans-CFF.otf"}


def later_face(face: str) -> bool:
    """Whether a face is a later phase's than the fonts phase's."""
    return face in NEW_FACES or face in WOFF2_TWINS


def _font_refs() -> dict:
    from figdraw_tpu_torch.scenes import FONTS_REFERENCE

    with open(FONTS_REFERENCE) as fh:
        return json.load(fh)


def _variations(loc) -> tuple:
    from figdraw_tpu_torch.text.typefaces import FontVariation

    return tuple(FontVariation(t, v) for t, v in loc)


def font_outlines_check(face: str, refs: dict, check: str, tag: str) -> dict:
    """Every glyph of a face at each of scenes.FONT_LOCATIONS through the
    port's reader: the outline and advance digests against the stored
    ones (figdraw_tpu's), with the face's load and an outline's cost."""
    import hashlib

    from figdraw_tpu_torch.scenes import FONT_LOCATIONS, font_case_key, outline_digests
    from figdraw_tpu_torch.text.typefaces import bundled_font_path, get_typeface, load_typeface

    path = bundled_font_path(face)
    with open(path, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()
    if digest != refs["faces"][face]["sha256"]:
        fail(f"{face}'s sha256 is {digest}, not the stored one")
    t0 = time.perf_counter()
    tf = get_typeface(load_typeface(path))
    load_ms = (time.perf_counter() - t0) * 1e3
    n = len(tf._glyph_order)
    bad, t0 = [], time.perf_counter()
    for loc in FONT_LOCATIONS:
        key = font_case_key(face, loc)
        want = refs["faces"][face]["outlines"][key]
        if outline_digests(tf, _variations(loc)) != (want["paths"], want["advances"]):
            bad.append(key)
    per_glyph_ms = (time.perf_counter() - t0) * 1e3 / (n * len(FONT_LOCATIONS))
    print(f"{check}: {face} ({len(refs['faces'][face]['outlines'])} locations x {n} "
          f"glyphs, sha256 as stored): outline and advance digests "
          f"{'equal to' if not bad else 'DIFFER from'} figdraw_tpu's at every location"
          f"{'' if not bad else ' but ' + str(bad)}; face load {load_ms:.3f} ms, an "
          f"outline with its advance {per_glyph_ms:.4f} ms {tag}", flush=True)
    if bad:
        fail(f"{face}: outlines or advances differ from figdraw_tpu's at {bad}")
    return {"load_ms": load_ms, "outline_ms": per_glyph_ms}


def font_text_case(face: str, loc, refs: dict, dev, host: dict, check: str, tol: float,
                   tag: str, beside: str = "DejaVuSans TTF") -> tuple:
    """bench_text's scene (1200x800, 36 lines at 15 px; the face's lines
    from scenes.font_text) from a face at a location: the packed combo and
    the atlas against the stored digests, FRAMES frames through
    render_frame with the counts set to 0 just before and read just after
    (K1-atlas and one front end a frame), K1-atlas against its plain
    version on the frame's own inputs, the frame against the stored block
    means. Returns (its numbers, its frame)."""
    import numpy as np
    import torch

    from figdraw_tpu_torch import Color, FigRenderer, fill, rgba, vec2
    from figdraw_tpu_torch.executor import get_frame_executor
    from figdraw_tpu_torch.ops import raster
    from figdraw_tpu_torch.scenes import (
        array_digest, font_blocks_path, font_case_key, font_text, make_text_scene,
    )
    from figdraw_tpu_torch.text.typefaces import bundled_font_path, load_typeface

    med = statistics.median
    key = font_case_key(face, loc)
    ink = fill(rgba(20, 20, 30, 255))
    size = vec2(1200, 800)
    tid = load_typeface(bundled_font_path(face))
    t0 = time.perf_counter()
    scene, n_glyphs = make_text_scene(tid, ink, 0, variations=_variations(loc),
                                      text=font_text(face)[0])
    cold_ms = (time.perf_counter() - t0) * 1e3
    ren = FigRenderer(atlas_size=512, device="cuda")
    before = len(ren.atlas.entries)
    t0 = time.perf_counter()
    ren._ensure_packed_glyphs(scene)
    raster_ms = (time.perf_counter() - t0) * 1e3
    n_raster = len(ren.atlas.entries) - before
    plan = ren._walk_plan(scene, size, True, Color(1.0, 1.0, 1.0, 1.0))
    want = refs["text"][key]
    same = (array_digest(plan.combo) == want["combo"],
            array_digest(ren.atlas.data) == want["atlas"])
    print(f"{check}: bench_text from {key}: {n_glyphs} glyphs, packed combo "
          f"{plan.combo.shape} {'equal' if same[0] else 'DIFFERS'} to figdraw_tpu's "
          f"byte for byte (its stored digest), atlas {'equal' if same[1] else 'DIFFERS'}",
          flush=True)
    if not all(same):
        fail(f"bench_text from {key} differs from figdraw_tpu's combo or atlas")
    ren.render_frame(scene, size)  # the first frame uploads the atlas
    torch.cuda.synchronize()
    zero_counts()
    total_ms = timed_frames(f"fonts {key}", lambda: ren.render_frame(scene, size),
                            (800, 1200, 4))
    counts = launch_counts()
    bins = binning_launches(f"fonts {key}", FRAMES)
    frame = ren.last_frame
    print(f"{check}: bench_text from {key}, {FRAMES} frames through render_frame on "
          f"cuda, finite; launches {counts} (expected {(0, FRAMES, 0, 0, 0)}); binning "
          f"{bins}", flush=True)
    if counts != (0, FRAMES, 0, 0, 0):
        fail(f"fonts {key} launched {counts}")
    border = binning_check(f"fonts {key}", lambda: ren.render_frame(scene, size))
    run = get_frame_executor(plan.structure, plan.height, plan.width, plan.n_masks,
                             plan.has_init_frame, plan.tile_h)
    combo = torch.from_numpy(plan.combo).to(dev, copy=True)
    atlas = ren._device_atlas()
    errs, calls = [], []
    run(combo, None, atlas=atlas,
        draw=compared(raster.draw_pass_planar_prebinned,
                      raster.draw_pass_planar_prebinned_plain, errs, calls,
                      f"fonts {key}"))
    ref = run(combo, None, atlas=atlas, draw=raster.draw_pass_planar_prebinned_plain)
    torch.cuda.synchronize()
    frame_err = float((frame - ref).abs().max())
    err_ref = float(np.abs(block_means(frame.cpu().numpy())
                           - np.load(font_blocks_path(key))).max())
    print(f"{check}: bench_text from {key}: K1-atlas vs plain max |diff| "
          f"{max(errs):.3e} (tol {tol:.0e}), frame vs the plain executor "
          f"{frame_err:.3e}, frame vs figdraw_tpu's (8x8 block means) {err_ref:.3e} "
          f"(tol {TOL:.3e})", flush=True)
    if not (max(errs) <= tol and frame_err <= tol and err_ref <= TOL):
        fail(f"fonts {key}: kernel, frame or reference differs ({max(errs)}, "
             f"{frame_err}, {err_ref})")
    entry = {"typeset_cold_ms": cold_ms, "raster_ms": raster_ms,
             "glyphs_rastered": n_raster, "raster_ms_per_glyph": raster_ms / max(n_raster, 1),
             "ms_per_frame": med(total_ms), "err": max(max(errs), frame_err),
             "ref_err": err_ref, "launches": counts[1], "bin_launches": bins,
             "borderline": border}
    print(f"times: fonts, bench_text from {key}: typeset cold {cold_ms:.3f} ms "
          f"({beside} {host['typeset_cold_ms']:.3f}), glyph raster cold "
          f"{raster_ms / max(n_raster, 1):.3f} ms a glyph for {n_raster} glyphs "
          f"({beside} {host['raster_ms_per_glyph']:.3f}), warm "
          f"{med(total_ms):.3f} ms/frame (render_frame + sync, median of {FRAMES}; "
          f"{beside} {host['ms_per_frame']:.3f}) {tag}", flush=True)
    return entry, frame.clone()


def font_table_case(face: str, loc, refs: dict, dev, host: dict, check: str, tol: float,
                    tag: str, beside: str = "DejaVuSans TTF") -> dict:
    """The text table (180x6 at 1200x800; the face's cells from
    scenes.font_text) from a face at a location, walked and planned by the
    port: its tape and atlas against the stored digests, TREE_FRAMES frames
    of its plan on the megakernel with the atlas, K4-atlas against its
    plain version, the block means."""
    import numpy as np
    import torch

    from figdraw_tpu_torch import FigRenderer, vec2
    from figdraw_tpu_torch.executor import get_mega_executor
    from figdraw_tpu_torch.ops import mega
    from figdraw_tpu_torch.plan import pack_walked_tape, plan_execution
    from figdraw_tpu_torch.scenes import (
        array_digest, font_blocks_path, font_case_key, font_text, make_text_table_scene,
    )
    from figdraw_tpu_torch.text.typefaces import bundled_font_path, load_typeface

    med = statistics.median
    key = font_case_key(face, loc)
    tid = load_typeface(bundled_font_path(face))
    t0 = time.perf_counter()
    tree = make_text_table_scene(TABLE_ROWS, TABLE_COLS, float(TABLE_W), float(TABLE_H),
                                 tid=tid, variations=_variations(loc),
                                 text=font_text(face)[1])
    t1 = time.perf_counter()
    tren = FigRenderer(atlas_size=512, device="cuda")
    tsize = vec2(TABLE_W, TABLE_H)
    tape = tren.flatten(tree, tsize)
    t2 = time.perf_counter()
    pack_walked_tape(tape)
    tplan = plan_execution(tape)
    want = refs["table"][key]
    same = (array_digest(tape.combo, zero_sign=True) == want["combo"],
            array_digest(tren.atlas.data) == want["atlas"])
    print(f"{check}: text table from {key} ({tape.count} quads, {len(tape.items)} items): "
          f"tape combo {tape.combo.shape} {'equal' if same[0] else 'DIFFERS'} to "
          f"figdraw_tpu's byte for byte but the sign of zero, atlas "
          f"{'equal' if same[1] else 'DIFFERS'}; planned to the megakernel with the atlas: "
          f"{tplan.mega_atlas}", flush=True)
    if not (all(same) and tplan.mega_atlas):
        fail(f"the text table from {key} differs from figdraw_tpu's tape or atlas")
    tren.execute_plan(tplan)
    torch.cuda.synchronize()
    zero_counts()
    table_ms = timed_frames(f"fonts table {key}", lambda: tren.execute_plan(tplan),
                            (TABLE_H, TABLE_W, 4), frames=TREE_FRAMES)
    tcounts = launch_counts()
    tbins = binning_launches(f"fonts table {key}", TREE_FRAMES)
    tframe = tren.last_frame
    print(f"{check}: text table from {key}, {TREE_FRAMES} frames of its plan through "
          f"execute_plan: launches {tcounts} (expected {(0, 0, 0, 0, TREE_FRAMES)}); "
          f"binning {tbins}", flush=True)
    if tcounts != (0, 0, 0, 0, TREE_FRAMES):
        fail(f"fonts table {key} launched {tcounts}")
    tborder = binning_check(f"fonts table {key}", lambda: tren.execute_plan(tplan))
    mrun = get_mega_executor(tplan.height, tplan.width, tplan.n_masks,
                             tplan.has_init_frame, tplan.tile_h)
    mcombo = torch.from_numpy(tplan.mega_combo).to(dev, copy=True)
    flags = dict(atlas=tren._device_atlas(), pixelate=tren.pixelate)
    terrs, tcalls = [], []
    mrun(mcombo, None, **flags,
         draw=compared(mega.draw_pass_mega, mega.draw_pass_mega_plain, terrs, tcalls,
                       f"fonts table {key}", targets=MEGA_TARGETS))
    tref = mrun(mcombo, None, **flags, draw=mega.draw_pass_mega_plain)
    torch.cuda.synchronize()
    tframe_err = float((tframe - tref).abs().max())
    terr_ref = float(np.abs(block_means(tframe.cpu().numpy())
                            - np.load(font_blocks_path(key))).max())
    print(f"{check}: text table from {key}: K4-atlas vs plain max |diff| {terrs[0]:.3e} "
          f"(tol {tol:.0e}), frame vs the plain executor {tframe_err:.3e}, frame "
          f"vs figdraw_tpu's (8x8 block means) {terr_ref:.3e} (tol {TOL:.3e})", flush=True)
    if not (terrs[0] <= tol and tframe_err <= tol and terr_ref <= TOL):
        fail(f"fonts table {key}: kernel, frame or reference differs ({terrs}, "
             f"{tframe_err}, {terr_ref})")
    print(f"times: fonts, text table from {key}: tree build ({TABLE_ROWS * TABLE_COLS} "
          f"typesets) {(t1 - t0) * 1e3:.1f} ms, Python walk with its glyph rasters "
          f"{(t2 - t1) * 1e3:.1f} ms, execute_plan + sync median {med(table_ms):.3f} ms "
          f"({beside}: build {host['table_build_ms']:.1f}, walk "
          f"{host['table_walk_ms']:.1f}, {host['table_ms']:.3f} ms) {tag}", flush=True)
    return {"key": key, "launches": tcounts[4], "bin_launches": tbins,
            "borderline": tborder, "err": max(terrs[0], tframe_err),
            "ref_err": terr_ref, "build_ms": (t1 - t0) * 1e3,
            "walk_ms": (t2 - t1) * 1e3, "ms": med(table_ms)}


def font_pack_case(face: str, loc, refs: dict, check: str, tag: str) -> dict:
    """The C typesetter's instance pack of a face at a location against the
    stored sha256 (figdraw_tpu's), and bench_text's 36 strings typeset with
    it, glyph for glyph with the Python typesetter."""
    import hashlib

    from figdraw_tpu_torch import fill, rgba, vec2
    from figdraw_tpu_torch.scenes import font_case_key
    from figdraw_tpu_torch.text import layout, native_pack, native_typeset
    from figdraw_tpu_torch.text.typefaces import FigFont, bundled_font_path, load_typeface

    ink = fill(rgba(20, 20, 30, 255))
    key = font_case_key(face, loc)
    tid = load_typeface(bundled_font_path(face))
    t0 = time.perf_counter()
    blob = native_pack.build_font_pack(tid, _variations(loc))
    pack_ms = (time.perf_counter() - t0) * 1e3
    digest = hashlib.sha256(blob).hexdigest()
    worst, n_cmp = 0.0, 0
    for s in text_lines():
        arr_py = layout.typeset(vec2(1180, 22), [(
            FigFont(typeface_id=tid, size=15.0, variations=_variations(loc)), ink, s)])
        gids, xs, ys, clus, _size = native_typeset.typeset_box(
            tid, s, 15.0, bounds=(1180.0, 22.0), variations=_variations(loc))
        py = arr_py.arranged_glyphs
        if len(gids) != len(py) or any(int(g) != p.glyph_id or int(c) != p.cluster
                                       for g, c, p in zip(gids, clus, py)):
            fail(f"the C typesetter's glyphs differ from the Python one's on {s!r} "
                 f"({key})")
        for x, y, p in zip(xs, ys, py):
            worst = max(worst, abs(float(x) - (p.pos.x + p.offset.x)),
                        abs(float(y) - (p.pos.y + p.offset.y)))
        n_cmp += len(py)
    stored = refs["packs"][key]
    print(f"{check}: the instance pack of {key}: {len(blob)} bytes, sha256 {digest} "
          f"({'as' if digest == stored else 'NOT as'} figdraw_tpu's, stored); bench_text's "
          f"{TEXT_LINES} strings through it: {n_cmp} glyphs equal to the Python "
          f"typesetter's glyph for glyph, positions max |diff| {worst:.3e} px (tol 1e-3); "
          f"pack build {pack_ms:.1f} ms {tag}", flush=True)
    if digest != stored or not worst < 1e-3:
        fail(f"the instance pack of {key}: sha256 {digest} or positions ({worst})")
    return {"sha256": digest, "bytes": len(blob), "max_pos_err": worst, "build_ms": pack_ms}


def fonts_phase(tag: str, dev, host: dict) -> dict:
    """CFF and variable faces on the card's host and through the atlas
    kernels (lines `check 15`), from the FigPort Sans faces in the checkout
    (figdraw_tpu_torch/fonts: CFF, glyf + gvar/HVAR/avar, CFF2 + HVAR/avar)
    and reference/fonts.json, which figdraw_tpu wrote on the CPU:

    a. every glyph of the three faces through the port's reader at the
       default and at three locations of each axis (scenes.FONT_LOCATIONS):
       the digests of the outlines and advances against the stored ones;
    b. bench_text's scene (1200x800, 36 lines at 15 px) from the CFF face
       and from each variable face at wdth 75 and at wdth 125 with slnt -12
       (scenes.FONT_TEXT_CASES): font_text_case, and the two instances of
       each variable face drawing different frames;
    c. the text table (180x6 at 1200x800) from the CFF2 face at wdth 90,
       slnt -6 (font_table_case);
    d. the C typesetter's instance packs of the glyf variable face at two
       locations (font_pack_case).

    The WOFF and VARC faces of the same lists are woff_varc_phase's, the
    WOFF2 faces woff2_phase's. Each
    face's cold typesetting, cold glyph raster and warm ms/frame print
    beside the bundled DejaVuSans's (the text-host phase's)."""
    from figdraw_tpu_torch.scenes import (
        FONT_FACES, FONT_PACK_CASES, FONT_TABLE_CASE, FONT_TEXT_CASES, font_case_key,
    )

    refs = _font_refs()
    out = {"faces": {}, "text": {}, "launches": {}, "bin_launches": {}, "borderline": {},
           "packs": {}}
    check = "check 15"
    for face in FONT_FACES:
        if not later_face(face):
            out["faces"][face] = font_outlines_check(face, refs, check, tag)
    frames = {}
    for face, loc in FONT_TEXT_CASES:
        if later_face(face):
            continue
        key = font_case_key(face, loc)
        entry, frames[key] = font_text_case(face, loc, refs, dev, host, check,
                                            FONT_PHASE_TOL, tag)
        out["launches"][key] = entry.pop("launches")
        out["bin_launches"][key] = entry.pop("bin_launches")
        out["borderline"][key] = entry.pop("borderline")
        out["text"][key] = entry
    for face in ("FigPortSans-VF.ttf", "FigPortSans-VF.otf"):
        a, b = (frames[font_case_key(f, loc)] for f, loc in FONT_TEXT_CASES if f == face)
        apart = float((a - b).abs().max())
        print(f"{check}: {face}'s two instances draw different frames: max |diff| "
              f"{apart:.3f}", flush=True)
        if not apart > 0.1:
            fail(f"{face}'s instances drew the same frame")
    face, loc = FONT_TABLE_CASE
    out["table"] = font_table_case(face, loc, refs, dev, host, check, FONT_PHASE_TOL, tag)
    for face, loc in FONT_PACK_CASES:
        if not later_face(face):
            out["packs"][font_case_key(face, loc)] = font_pack_case(face, loc, refs, check,
                                                                    tag)
    return out


def varc_outline_ms(face: str) -> tuple:
    """(ms an outline of a glyph in VARC's Coverage, ms an outline of one
    outside it) on a fresh load of the face, each glyph drawn once at
    FONT_TEXT_CASES' location of the face (no cache: glyph_path decodes
    the components on first use, and draws each time)."""
    from figdraw_tpu_torch.scenes import FONT_TEXT_CASES
    from figdraw_tpu_torch.text.otf import OTFont
    from figdraw_tpu_torch.text.typefaces import bundled_font_path

    with open(bundled_font_path(face), "rb") as fh:
        font = OTFont(fh.read())
    loc = dict(next(l for f, l in FONT_TEXT_CASES if f == face))
    norm = font.normalize_location(loc)
    cover = font.varc().coverage
    times = {True: [], False: []}
    for gid in range(font.num_glyphs):
        t0 = time.perf_counter()
        font.glyph_path(gid, norm)
        times[gid in cover].append((time.perf_counter() - t0) * 1e3)
    return (sum(times[True]) / len(times[True]), sum(times[False]) / len(times[False]),
            len(times[True]))


def woff_varc_phase(tag: str, dev, host: dict, fonts: dict) -> dict:
    """WOFF and VARC faces (lines `check 17`): FigPortSans-VF.woff (the glyf
    variable face as WOFF 1.0, inflated by text/woff.py at load) and
    FigPortSans-VARC.ttf (the same with a VARC table whose variable
    composites are the accented letters of U+00C0-017F), against
    reference/fonts.json, which figdraw_tpu wrote on the CPU:

    a. every glyph of each face at the 7 locations: outline and advance
       digests (font_outlines_check; the face load includes the WOFF
       inflate), and the VARC face's outline of a glyph in Coverage timed
       beside one outside it;
    b. bench_text's scene from each face (scenes.FONT_TEXT_CASES; the VARC
       face sets accented lines, scenes.font_text) through render_frame,
       K1-atlas within NEW_FACE_TOL of its plain version (font_text_case);
    c. the VARC face's text table (scenes.FONT_VARC_TABLE_CASE, accented
       cells) on the megakernel with the atlas, K4-atlas within
       NEW_FACE_TOL of its plain version (font_table_case);
    d. the WOFF face's instance pack against figdraw_tpu's sha256.

    Times print beside FigPort Sans VF's (the fonts phase's)."""
    from figdraw_tpu_torch.scenes import (
        FONT_PACK_CASES, FONT_TEXT_CASES, FONT_VARC_TABLE_CASE, font_case_key,
    )

    t_phase = time.perf_counter()
    refs = _font_refs()
    check = "check 17"
    vf = fonts["text"][font_case_key("FigPortSans-VF.ttf", (("wdth", 75.0),))]
    host_vf = {"typeset_cold_ms": vf["typeset_cold_ms"],
               "raster_ms_per_glyph": vf["raster_ms_per_glyph"],
               "ms_per_frame": vf["ms_per_frame"],
               "table_build_ms": fonts["table"]["build_ms"],
               "table_walk_ms": fonts["table"]["walk_ms"], "table_ms": fonts["table"]["ms"]}
    beside = "FigPort Sans VF"
    out = {"faces": {}, "text": {}, "launches": {}, "bin_launches": {}, "borderline": {},
           "packs": {}}
    for face in NEW_FACES:
        out["faces"][face] = font_outlines_check(face, refs, check, tag)
    in_ms, out_ms, n_varc = varc_outline_ms("FigPortSans-VARC.ttf")
    vf_outline = fonts["faces"]["FigPortSans-VF.ttf"]["outline_ms"]
    print(f"times: fonts, FigPortSans-VARC.ttf outlines drawn once each at its bench_text "
          f"location: {in_ms:.4f} ms a glyph in VARC's Coverage ({n_varc} glyphs), "
          f"{out_ms:.4f} ms a glyph outside it (FigPort Sans VF: an outline with its "
          f"advance {vf_outline:.4f} ms); face load {out['faces'][NEW_FACES[0]]['load_ms']:.3f} "
          f"ms with the WOFF inflate (FigPort Sans VF "
          f"{fonts['faces']['FigPortSans-VF.ttf']['load_ms']:.3f}) {tag}", flush=True)
    out["varc_outline_ms"], out["plain_outline_ms"] = in_ms, out_ms
    for face, loc in FONT_TEXT_CASES:
        if face not in NEW_FACES:
            continue
        key = font_case_key(face, loc)
        entry, _frame = font_text_case(face, loc, refs, dev, host_vf, check, NEW_FACE_TOL,
                                       tag, beside=beside)
        out["launches"][key] = entry.pop("launches")
        out["bin_launches"][key] = entry.pop("bin_launches")
        out["borderline"][key] = entry.pop("borderline")
        out["text"][key] = entry
    face, loc = FONT_VARC_TABLE_CASE
    out["table"] = font_table_case(face, loc, refs, dev, host_vf, check, NEW_FACE_TOL, tag,
                                   beside=beside + " (its CFF2 twin's table)")
    for face, loc in FONT_PACK_CASES:
        if face in NEW_FACES:
            out["packs"][font_case_key(face, loc)] = font_pack_case(face, loc, refs, check,
                                                                    tag)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"{check}: the WOFF and VARC phase took {out['seconds']:.1f} s", flush=True)
    return out


def woff2_times(face: str, tag: str) -> dict:
    """The WOFF2 face's Brotli stream decoded by fd_brotli_decompress, the
    whole file rebuilt into its sfnt (text/woff2.py), and the face loaded
    (Typeface: the rebuild and the OpenType reader's tables), each cold
    (the first in the process) and warm (the median of 5), beside the
    load of its TTF or OTF twin."""
    from figdraw_tpu_torch.text import woff2
    from figdraw_tpu_torch.text.typefaces import Typeface, bundled_font_path
    from figdraw_tpu_torch.utils import brotli

    med = statistics.median

    def cold_warm(fn) -> tuple:
        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return times[0], med(times[1:])

    with open(bundled_font_path(face), "rb") as fh:
        data = fh.read()
    head, entries, at = woff2.directory(data)
    stream = data[at: at + head[6]]
    total = sum(e[3] for e in entries)
    twin = WOFF2_TWINS[face]
    with open(bundled_font_path(twin), "rb") as fh:
        twin_data = fh.read()
    out = {}
    out["brotli_cold_ms"], out["brotli_ms"] = cold_warm(lambda: brotli.decompress(stream, total))
    out["rebuild_cold_ms"], out["rebuild_ms"] = cold_warm(lambda: woff2.woff2_to_sfnt(data))
    out["load_cold_ms"], out["load_ms"] = cold_warm(lambda: Typeface(face, data, 0))
    out["twin_load_cold_ms"], out["twin_load_ms"] = cold_warm(
        lambda: Typeface(twin, twin_data, 0))
    print(f"times: fonts, {face} ({len(data)} bytes, a Brotli stream of {len(stream)} bytes "
          f"to {total}): Brotli decode (fd_brotli_decompress) cold {out['brotli_cold_ms']:.3f} "
          f"ms, warm {out['brotli_ms']:.3f} ms; the WOFF2 rebuild with it cold "
          f"{out['rebuild_cold_ms']:.3f} ms, warm {out['rebuild_ms']:.3f} ms; the face load "
          f"cold {out['load_cold_ms']:.3f} ms, warm {out['load_ms']:.3f} ms (its twin {twin}: "
          f"cold {out['twin_load_cold_ms']:.3f} ms, warm {out['twin_load_ms']:.3f} ms) {tag}",
          flush=True)
    return out


def brotli_check(refs: dict, check: str, tag: str) -> dict:
    """fd_brotli_decompress on each WOFF2 face's stream against the stored
    size and sha256 (libbrotlidec's output, written on the CPU host) and
    against decompress_plain."""
    import hashlib

    from figdraw_tpu_torch.scenes import WOFF2_FACES
    from figdraw_tpu_torch.text import woff2
    from figdraw_tpu_torch.text.typefaces import bundled_font_path
    from figdraw_tpu_torch.utils import brotli

    out = {"streams": {}}
    for face in WOFF2_FACES:
        with open(bundled_font_path(face), "rb") as fh:
            data = fh.read()
        head, entries, at = woff2.directory(data)
        stream = data[at: at + head[6]]
        got = brotli.decompress(stream, sum(e[3] for e in entries))
        t0 = time.perf_counter()
        plain = brotli.decompress_plain(stream)
        plain_ms = (time.perf_counter() - t0) * 1e3
        want = refs["woff2"][face]
        same = (len(got) == want["bytes"] and hashlib.sha256(got).hexdigest() == want["sha256"],
                got == plain)
        print(f"{check}: fd_brotli_decompress on {face}'s stream ({len(stream)} bytes): "
              f"{len(got)} bytes, {'equal to' if same[0] else 'DIFFERENT FROM'} libbrotlidec's "
              f"(stored sha256), {'equal to' if same[1] else 'DIFFERENT FROM'} "
              f"decompress_plain ({plain_ms:.1f} ms) {tag}", flush=True)
        if not all(same):
            fail(f"fd_brotli_decompress on {face}'s stream differs ({same})")
        out["streams"][face] = {"bytes": len(got), "plain_ms": plain_ms}
    return out


def woff2_phase(tag: str, dev, host: dict, fonts: dict) -> dict:
    """WOFF 2.0 faces (lines `check 18`): scenes.WOFF2_FACES, each rebuilt
    into its sfnt at load by text/woff2.py with the port's Brotli decoder,
    against reference/fonts.json, which figdraw_tpu wrote on the CPU
    through fontTools:

    a. the Brotli decoder's library built from csrc/brotli_decode.cpp, and
       each face's Brotli decode, rebuild and load cold (the first in the
       process) and warm beside its TTF or OTF twin's load (woff2_times);
    b. fd_brotli_decompress on each face's stream against the stored size
       and sha256 and against decompress_plain (brotli_check), and every
       glyph of each face at the 7 locations: outline and advance digests
       (font_outlines_check);
    c. bench_text's scene from each face (scenes.FONT_TEXT_CASES) through
       render_frame, K1-atlas within NEW_FACE_TOL of its plain version and
       the frame within TOL of figdraw_tpu's block means (font_text_case),
       the cold glyph and warm ms/frame beside the twin's;
    d. the VF face's text table (scenes.FONT_WOFF2_TABLE_CASE) on the
       megakernel with the atlas, K4-atlas within NEW_FACE_TOL of its
       plain version (font_table_case)."""
    from figdraw_tpu_torch.scenes import (
        FONT_TEXT_CASES, FONT_WOFF2_TABLE_CASE, WOFF2_FACES, font_case_key,
    )
    from figdraw_tpu_torch.utils import image_lib

    t_phase = time.perf_counter()
    refs = _font_refs()
    check = "check 18"
    out = {"faces": {}, "times": {}, "text": {}, "launches": {}, "bin_launches": {},
           "borderline": {}}
    t0 = time.perf_counter()
    image_lib.load_brotli()
    out["build_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"{check}: the Brotli decoder's library (csrc/brotli_decode.cpp, g++) built and "
          f"bound in {out['build_ms']:.1f} ms {tag}", flush=True)
    for face in WOFF2_FACES:
        out["times"][face] = woff2_times(face, tag)
    out["brotli"] = brotli_check(refs, check, tag)
    for face in WOFF2_FACES:
        out["faces"][face] = font_outlines_check(face, refs, check, tag)
    twin_cases = {"DejaVuSans.woff2": ("DejaVuSans TTF", host),
                  "FigPortSans-VF.woff2": ("FigPortSans-VF.ttf@wdth=75", fonts["text"][
                      font_case_key("FigPortSans-VF.ttf", (("wdth", 75.0),))]),
                  "FigPortSans-CFF.woff2": ("FigPortSans-CFF.otf", fonts["text"][
                      font_case_key("FigPortSans-CFF.otf", ())])}
    for face, loc in FONT_TEXT_CASES:
        if face not in WOFF2_TWINS:
            continue
        key = font_case_key(face, loc)
        beside, twin = twin_cases[face]
        entry, _frame = font_text_case(face, loc, refs, dev, twin, check, NEW_FACE_TOL, tag,
                                       beside=beside)
        out["launches"][key] = entry.pop("launches")
        out["bin_launches"][key] = entry.pop("bin_launches")
        out["borderline"][key] = entry.pop("borderline")
        out["text"][key] = entry
    face, loc = FONT_WOFF2_TABLE_CASE
    table_host = {"table_build_ms": fonts["table"]["build_ms"],
                  "table_walk_ms": fonts["table"]["walk_ms"], "table_ms": fonts["table"]["ms"]}
    out["table"] = font_table_case(face, loc, refs, dev, table_host, check, NEW_FACE_TOL, tag,
                                   beside="FigPort Sans VF (its CFF2 twin's table)")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"{check}: the WOFF2 phase took {out['seconds']:.1f} s", flush=True)
    return out


SHARD_BANDS = 4  # the headline's bands: 1080 rows in bands of 272 (the last 264)
SHARD_FINE = 24  # 24 bands of 48 rows, shorter than the blur's halo: the gather path
SHARD_FRAMES = 8  # frames of each counted sharded run
SHARD_VIEWS = 8  # views of the device-resident grid's sweeps
SHARD_TABLE_BANDS = 2  # the clip tables' 800 rows in bands of 400
SHARD_PATHS = {}  # path -> its counted run's band-origin launches by kernel
SHARD_ERRS = {}  # band-origin kernel -> max |kernel - plain| over its checks
SHARD_TIMES = {}  # band-origin kernel -> its times and bound at the checked band


def band_counts() -> dict:
    """Launches at a band origin other than 0, by kernel, since zero_counts()."""
    from figdraw_tpu_torch.ops import binning, blur, mega, raster

    return {"K1": raster.BAND_LAUNCHES, "K1-atlas": raster.BAND_ATLAS_LAUNCHES,
            "K3": raster.BAND_MASK_LAUNCHES, "K4": mega.BAND_LAUNCHES,
            "K4-atlas": mega.BAND_ATLAS_LAUNCHES, "front": binning.BAND_DECODE_LAUNCHES,
            "tiles": binning.BAND_LAUNCHES, "X6": blur.BAND_LAUNCHES}


def band_expected(plan, n: int) -> dict:
    """A sharded frame's band-origin launches on n bands of one card (the
    wrappers count a launch at an origin other than 0): one front end and
    each kernel of the plan's executor a band but band 0; X6 a horizontal
    and a vertical launch a blur item (every band on one device, at most
    MAX_BANDS of them a launch), on both paths."""
    from figdraw_tpu_torch.ops.blur import MAX_BANDS
    from figdraw_tpu_torch.tape import FRAME_TARGET

    want = {"front": n - 1, "tiles": n - 1}
    if plan.mega_combo is not None:
        want["K4-atlas" if plan.mega_atlas else "K4"] = n - 1
        return want
    for item in plan.structure:
        if item[0] == "blur":
            want["X6"] = want.get("X6", 0) + 2 * -(-n // MAX_BANDS)
        elif item[0] == "draw":
            key = "K3" if item[1] != FRAME_TARGET else "K1-atlas" if item[2] else "K1"
            want[key] = want.get(key, 0) + n - 1
    return want


def sharded_counted(what: str, render, frames: int, want: dict) -> list:
    """`frames` runs of render(f) with the counts set to 0 just before and
    read just after: the band-origin launches must be want's (a frame)
    times frames, every other band-origin kernel 0, and no plain decode or
    binning; returns each frame's ms (host and device, a synchronize
    each)."""
    import torch

    zero_counts()
    ms = []
    for f in range(frames):
        t0 = time.perf_counter()
        frame = render(f)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if not bool(torch.isfinite(frame).all()):
            fail(f"sharded {what}: frame {f} holds non-finite values")
    got = band_counts()
    expect = {k: want.get(k, 0) * frames for k in got}
    plain = all_counts()["plain"]
    print(f"check 16: sharded {what}: {frames} runs, band-origin launches {got} "
          f"(expected {expect}), plain front ends {plain}", flush=True)
    if got != expect or plain:
        fail(f"sharded {what}: band-origin launches {got}, expected {expect}; "
             f"{plain} plain front ends")
    SHARD_PATHS[what] = got
    return ms


FRINGE_CAP = 64  # pixels of one frame that two tile layouts' fringes may explain


def tile_rows(ys, th: int, pband: int = 0):
    """Each pixel row's tile rows (t0, t1) as int64 arrays: tiles of th rows
    from row 0, or, pband > 0, from each band's origin (a multiple of
    pband), as a sharded frame tiles its bands."""
    import numpy as np

    ys = np.asarray(ys, np.int64)
    base = (ys // pband) * pband if pband else np.zeros_like(ys)
    t0 = base + ((ys - base) // th) * th
    return t0, t0 + th


def layout_fringe(fields, modes, ys, xs, tiles_a, tiles_b, tile_w: int = 128):
    """The most that the frames of two tile layouts can differ by at each
    pixel (ys, xs): the summed alpha there of the quads whose bbox meets the
    pixel's tile in one layout and not in the other (every renderer bins a
    quad by its bbox, and a fragment left out of a pixel changes it by at
    most its alpha). Such a quad reaches the pixel only with antialiased
    fringe past its bbox: the walk's bbox of a rotated box misses up to a
    pixel of it. 0 where no quad does. fields (N, 68) f32 and modes (N, 2)
    i32: the frame's unpacked rows, torch tensors on the CPU; tiles_a,
    tiles_b: each pixel's tile rows in the two layouts (tile_rows); columns
    tile by tile_w from 0 in both."""
    import numpy as np
    import torch

    from figdraw_tpu_torch.ops.layout import QF_BBOX_X0, QI_MODE
    from figdraw_tpu_torch.ops.quad_eval_planar import eval_quad_planar

    bb = fields[:, QF_BBOX_X0 : QF_BBOX_X0 + 4].numpy()
    live = (bb[:, 2] > bb[:, 0]) & (bb[:, 3] > bb[:, 1])
    out = np.zeros(len(ys), np.float64)
    for k, (y, x) in enumerate(zip(ys, xs)):
        c0 = (int(x) // tile_w) * tile_w
        cols = live & (bb[:, 0] < c0 + tile_w) & (bb[:, 2] > c0)
        in_a = cols & (bb[:, 1] < tiles_a[1][k]) & (bb[:, 3] > tiles_a[0][k])
        in_b = cols & (bb[:, 1] < tiles_b[1][k]) & (bb[:, 3] > tiles_b[0][k])
        idx = torch.from_numpy(np.nonzero(in_a ^ in_b)[0])
        if len(idx):
            alpha = eval_quad_planar(lambda f: fields[idx, f], modes[idx, QI_MODE],
                                     torch.tensor(float(x) + 0.5),
                                     torch.tensor(float(y) + 0.5))[3]
            out[k] = float(alpha.sum())
    return out


def sharded_equal(what: str, got, want, tol: float = TOL, fringe=None) -> float:
    """max |got - want| of two frames, the pixels that differ, printed; fails
    past tol. fringe: None, or fringe(ys, xs) -> how much two tile layouts'
    frames may differ at those pixels (layout_fringe); given, a pixel past
    tol whose difference is within that (and tol) is counted and left out,
    and more than FRINGE_CAP of them fail."""
    import torch

    torch.cuda.synchronize()
    diff = (got - want).abs().amax(-1)
    px = int((diff > 0).sum())
    left, worst = 0, (0.0, 0.0)
    if fringe is not None:
        ys, xs = (t.cpu().numpy() for t in torch.nonzero(diff > tol, as_tuple=True))
        if len(ys):
            bound = fringe(ys, xs)
            d = diff[ys, xs].cpu().numpy()
            ok = (bound > 0) & (d <= bound + tol)
            left = int(ok.sum())
            if left:
                k = int((d * ok).argmax())
                worst = (float(d[k]), float(bound[k]))
            diff[ys[ok], xs[ok]] = 0.0
    err = float(diff.max())
    print(f"check 16: sharded {what}: max |diff| {err:.3e} (tol {tol:.3e}), {px} of "
          f"{diff.shape[0] * diff.shape[1]} pixels differ"
          + (f", {left} of them (at most {FRINGE_CAP}) within a quad's fringe that the "
             f"two tile layouts bin differently, left out (the largest {worst[0]:.3f} "
             f"of {worst[1]:.3f} allowed)" if fringe is not None else ""), flush=True)
    if not err <= tol:
        fail(f"sharded {what} differs by {err}")
    if left > FRINGE_CAP:
        fail(f"sharded {what}: {left} pixels differ on a fringe, more than {FRINGE_CAP}")
    return err


def at_origin(fn, plain, row0: int, errs: list, store: list, what: str,
              targets=TILE_TARGETS):
    """fn wrapped so that its calls at band origin row0 also run the plain
    version on the same inputs (compared); other bands run fn alone."""
    checked = compared(fn, plain, errs, store, what, targets)

    def call(*args, **kw):
        return checked(*args, **kw) if kw.get("row0") == row0 else fn(*args, **kw)
    return call


def band_kernel_check(name: str, what: str, sr, plan, row0: int, draws_of) -> tuple:
    """One sharded run of plan with the kernel `name` at band origin row0
    held against its plain version on the band's own inputs, and the band's
    front end against the plain front end (fields and modes as words, whole
    lists): (the kernel call's (args, kw), the front end's (args, kw))."""
    import torch

    from figdraw_tpu_torch import executor
    from figdraw_tpu_torch.ops import binning

    errs, store = [], []
    rows = plan.mega_combo if plan.mega_combo is not None else plan.combo
    combos = sr._upload(rows)
    draws = draws_of(errs, store)
    calls = recorded(executor, "decode_and_bin", lambda: sr._run(plan, combos, draws=draws))
    torch.cuda.synchronize()
    if not store:
        fail(f"sharded {what}: no {name} call at band origin {row0}")
    err = max(errs)
    SHARD_ERRS[name] = max(SHARD_ERRS.get(name, 0.0), err)
    at = [(a, k) for a, k in calls if k.get("row0") == row0]
    if len(at) != 1:
        fail(f"sharded {what}: {len(at)} front ends at band origin {row0}, expected 1")
    a, k = at[0]
    got = binning.decode_and_bin(*a, **k)
    want = binning.decode_and_bin_plain(*a, **k)
    torch.cuda.synchronize()
    words = [words_differ(got[i], want[i]) for i in (0, 1)]
    runs = k.get("run_bounds")
    _idx, _counts, border = binning.bin_quads_model(
        want[0].cpu().numpy(), int(a[1]), int(a[2]), *a[3:7],
        modes=want[1].cpu().numpy() if k.get("cull") else None,
        run_bounds=None if runs is None or not k.get("cull") else runs.cpu().numpy(),
        row0=row0)
    diff = binning.list_differences(*[t.cpu().numpy() for t in got[2:]],
                                    *[t.cpu().numpy() for t in want[2:]], border)
    bad = sum(w[1] for w in words)
    print(f"check 16: sharded {what}, the band at row {row0}: {name} vs plain max |diff| "
          f"{err:.3e} over {len(errs)} calls (tol {TOL:.3e}); the front end's fields and "
          f"modes {bad} words differ, lists {diff['differing']} of {diff['compared']} "
          f"entries differ (T {got[2].shape[0]}, N {got[2].shape[1]}, tile_h {a[5]}; "
          f"{int(border.sum())} saturation-borderline quads left out, 0 expected)",
          flush=True)
    if not err <= TOL or bad or diff["max_abs_err"] != 0:
        fail(f"sharded {what}: {name} or the front end at band origin {row0} differs "
             f"from its plain version")
    SHARD_ERRS["front"] = max(SHARD_ERRS.get("front", 0.0), float(max(w[2] for w in words)))
    SHARD_ERRS["tiles"] = max(SHARD_ERRS.get("tiles", 0.0), diff["max_abs_err"])
    return store[0], (a, k)


def band_kernel_times(name: str, what: str, fn, plain, call, work_of, targets, tag: str):
    """The checked call of a band-origin kernel timed (CUDA events around the
    wrapper call), its plain version timed, and its bound from the work its
    inputs need (raster_work or mega_work)."""
    args, kw = call
    ms = cuda_ms(lambda: fn(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: plain(*as_before(args, targets), **kw), 3)
    bound, by = bounds_of(work_of(args, kw))[0]
    SHARD_TIMES[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                         "at": f"{what}, row {kw['row0']}"}
    print(f"times: {name} at band origin {kw['row0']} ({what}): kernel {ms:.4f} ms (CUDA "
          f"events around the wrapper call), plain torch {plain_ms:.2f} ms, bound "
          f"{bound:.4f} ms ({by}) {tag}", flush=True)


def band_front_times(what: str, call, tag: str) -> None:
    """The front end of the checked band timed: both kernels by events, the
    front kernel alone (stop=4), the plain front end; bounds as
    binning_times'."""
    from figdraw_tpu_torch.ops import binning

    a, k = call
    ms = cuda_ms(lambda: binning.decode_and_bin(*a, **k), 20)
    front_ms = cuda_ms(lambda: binning.decode_and_bin(*a, **k, stop=4), 20)
    plain_ms = cuda_ms(lambda: binning.decode_and_bin_plain(*a, **k), 3)
    decode_plain_ms = cuda_ms(lambda: binning.unpack_combo_plain(a[0]), 3)
    f_bound, f_by = bound_of(*front_work(a, k))
    t_bound, t_by = bound_of(*tiles_work(a, k))
    SHARD_TIMES["front"] = {"ms": front_ms, "plain_ms": decode_plain_ms, "bound_ms": f_bound,
                            "bound_by": f_by, "at": f"{what}, row {k['row0']}"}
    SHARD_TIMES["tiles"] = {"ms": ms - front_ms, "front_end_ms": ms, "plain_ms": plain_ms,
                            "bound_ms": t_bound, "bound_by": t_by,
                            "at": f"{what}, row {k['row0']}"}
    print(f"times: the front end at band origin {k['row0']} ({what}): {ms:.4f} ms (CUDA "
          f"events, both kernels), the front kernel {front_ms:.4f} ms (bound {f_bound:.5f} "
          f"ms, {f_by}), the tile kernel {ms - front_ms:.4f} ms by difference (bound "
          f"{t_bound:.5f} ms, {t_by}); plain front end {plain_ms:.3f} ms {tag}", flush=True)


X6_NAMES = ("BandRowsH", "BandLinesV")  # X6's kernels: blur.cu's banded row policies


def banded_blur_check(what: str, bands, radii, tag: str, timed: bool) -> None:
    """X6 against its plain version on a sharded frame's own bands, bit for
    bit: at the frame's radius, at r = 17.3, and through the halo-buffer
    route (the bands grouped by stand-in keys round robin over four, so
    that a neighbour's rows are copied into the scratch as from another
    card); the launches a blur item. With timed, its times by CUDA events
    and alone by torch.profiler, X1's on the same rows beside them, the
    copy bytes and its bounds."""
    import torch

    from figdraw_tpu_torch.ops import blur

    n, (c, band_h, pw) = len(bands), bands[0].shape
    dev = bands[0].device
    swap = blur.BLUR_HALO < band_h
    path = "swap" if swap else "gather"
    r173 = [torch.tensor(17.3, device=dev)] * n
    keys = [i % 4 for i in range(n)]
    launches = blur.BAND_LAUNCHES
    got = blur.banded_blur_planar(bands, radii)
    launches = blur.BAND_LAUNCHES - launches
    cases = [(f"r={float(radii[0]):g}", got, blur.banded_blur_planar_plain(bands, radii)),
             ("r=17.3", blur.banded_blur_planar(bands, r173),
              blur.banded_blur_planar_plain(bands, r173)),
             (f"halo-buffer route, groups {keys[:4]}...",
              blur.banded_blur_kernels(bands, radii, keys),
              blur.banded_blur_planar_plain(bands, radii))]
    torch.cuda.synchronize()
    for case, got, want in cases:
        diff = sum(words_differ(a, b)[1] for a, b in zip(got, want))
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        SHARD_ERRS["X6"] = max(SHARD_ERRS.get("X6", 0.0), err)
        print(f"check 16: X6 on the {what}'s {n} bands of {band_h} rows ({path} path, "
              f"{case}) vs plain: {diff} words differ, max |diff| {err:.3e} (bit for bit "
              "expected)", flush=True)
        if diff:
            fail(f"X6 on the {what} ({case}) differs from its plain version")
    groups = blur.band_table([b.device for b in bands], band_h)
    copied = blur.copy_bytes(groups, c, pw)
    want_launches = 2 * len(groups) * -(-n // blur.MAX_BANDS)
    print(f"check 16: X6 on the {what}: {launches} launches a blur item (expected "
          f"{want_launches}), {copied} bytes copied", flush=True)
    if launches != want_launches or copied:
        fail(f"X6 on the {what}: {launches} launches, {copied} bytes copied; expected "
             f"{want_launches} and 0 on one card")
    if not timed:
        return
    call = lambda: blur.banded_blur_planar(bands, radii)
    ms = cuda_ms(call, 20)
    alone = device_ms_of(call, X6_NAMES)
    parts = kernel_parts(call, X6_NAMES)
    plain_ms = cuda_ms(lambda: blur.banded_blur_planar_plain(bands, radii), 3)
    frame = torch.cat(bands, dim=1)  # X1 on the same rows: the yardstick
    whole = lambda: blur.backdrop_blur_planar(frame, radii[0])
    x1_ms = cuda_ms(whole, 20)
    x1_alone = device_ms_of(whole, ("blur_h_kernel", "blur_v_kernel"))
    rows = n * band_h
    plane_row = c * pw * 4  # bytes of one row of every plane
    n_bytes = 2 * rows * plane_row  # the bands read once, the result written once
    n_ops = (2 * c * rows * pw * (BLUR_TAPS * BLUR_OPS_PER_TAP + 1)
             + BLUR_TAPS * BLUR_OPS_PER_POSITION * (rows + pw))
    bound, by = bound_of(n_bytes, n_ops)
    two_pass, two_by = bound_of(2 * n_bytes, n_ops)  # each pass reads and writes once, as X1's
    SHARD_TIMES["X6"] = {"ms": ms, "device_ms": alone, "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": by, "bound_two_pass_ms": two_pass,
                         "x1_ms": x1_ms, "x1_device_ms": x1_alone,
                         "launches_a_blur": launches, "copy_bytes": copied,
                         "at": f"{what}, {n} bands of {band_h} rows"}
    print(f"times: X6 on the {what}'s {n} bands ({tuple(bands[0].shape)} each, one card): "
          f"{ms:.4f} ms (CUDA events), {alone:.4f} ms (the two kernels alone, torch.profiler; "
          f"{parts}), plain torch {plain_ms:.3f} ms; X1 on the same {rows} rows "
          f"{x1_ms:.4f} ms by events, {x1_alone:.4f} ms alone (X6 alone {alone / x1_alone:.2f} "
          f"times X1 alone); bound {bound:.4f} ms ({by}: the frame read and written once), "
          f"{two_pass:.4f} ms ({two_by}: each pass reading and writing the planes once, "
          f"X1's count); {launches} launches, {copied} bytes copied {tag}", flush=True)


def recorded_blur_bands(sr, plan) -> tuple:
    """(bands, radii) of the first banded blur of a sharded run of plan."""
    from figdraw_tpu_torch.parallel import sharding

    seen, real = [], sharding.banded_blur_planar

    def record(bands, radii, *a, **k):
        seen.append(([b.clone() for b in bands], list(radii)))
        return real(bands, radii, *a, **k)

    sharding.banded_blur_planar = record
    try:
        sr._run(plan, sr._upload(plan.combo))
    finally:
        sharding.banded_blur_planar = real
    if not seen:
        fail("the sharded frame ran no banded blur")
    return seen[0]


def band_times(head, one, mesh, turns: int, tag: str) -> dict:
    """ms/frame of the 1080p headline (head(f): frame f's renders) through
    one.render_frame and ShardedFigRenderer on 1, 2 and 4 bands of
    mesh(n): the median of SHARD_FRAMES frames (render_frame + sync), the
    best of `turns` turns, printed."""
    import torch

    from figdraw_tpu_torch import vec2
    from figdraw_tpu_torch.parallel.sharding import ShardedFigRenderer

    size = vec2(WIDTH, HEIGHT)
    timing = {"render_frame": lambda f: one.render_frame(head(f), size)}
    for k in (1, 2, 4):
        ren_k = ShardedFigRenderer(mesh(k))
        ren_k.render_frame(head(0), size)
        timing[f"{k} band{'s' if k > 1 else ''}"] = (
            lambda r: lambda f: r.render_frame(head(f), size))(ren_k)
    got = {}
    for _ in range(turns):  # in turns
        for name, fn in timing.items():
            per = []
            for f in range(SHARD_FRAMES):
                t0 = time.perf_counter()
                fn(f)
                torch.cuda.synchronize()
                per.append((time.perf_counter() - t0) * 1e3)
            got.setdefault(name, []).append(statistics.median(per))
    got = {k: min(v) for k, v in got.items()}
    print(f"times: headline ms/frame (median of {SHARD_FRAMES}, best of {turns} turns, "
          "one card): " + ", ".join(f"{k} {v:.3f}" for k, v in got.items()) + f" {tag}",
          flush=True)
    return got


def band_turns_phase(tag: str) -> None:
    """`python3 chip_smoke.py band_turns`: band_times alone, 5 turns, no
    checks: run it from two checkouts in turns to compare them."""
    import torch

    from figdraw_tpu_torch import FigRenderer, native
    from figdraw_tpu_torch.ops import binning, blur, mega, raster
    from figdraw_tpu_torch.parallel.sharding import Mesh
    from figdraw_tpu_torch.scenes import make_render_tree_array

    with ThreadPoolExecutor(5) as pool:
        list(pool.map(lambda load: load(), (native.load, raster.load, mega.load,
                                            blur.load, binning.load)))
    dev = torch.device("cuda", 0)
    cache = {}
    band_times(lambda f: make_render_tree_array(WIDTH, HEIGHT, f, copies=COPIES, cache=cache),
               FigRenderer(device="cuda"), lambda n: Mesh((dev,) * n), 5, tag)


def device_total_ms(fn, reps: int = 5) -> tuple:
    """(ms, {name: ms}) per run of fn(): every kernel, copy and fill that ran
    on the device in a torch.profiler trace of reps runs, whatever launched
    it (taken again as device_ms_of takes an empty trace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(TRACE_TAKES):
        if attempt:
            time.sleep(0.5 * attempt)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != DeviceType.CUDA:
                continue
            us = max(getattr(e, a, 0) or 0 for a in (
                "self_device_time_total", "device_time_total", "self_cuda_time_total",
                "cuda_time_total"))
            if us > 0:
                parts[e.key] = us / 1e3 / reps
        if parts:
            return sum(parts.values()), parts
        print(f"note: the profiler's trace came back with no device activity (take "
              f"{attempt + 1} of {TRACE_TAKES})", flush=True)
    fail("the profiler saw no device activity")


def x6_turns_phase(tag: str) -> None:
    """`python3 chip_smoke.py x6_turns`: X6 (banded_blur_planar, the entry
    point every commit with sharded rendering has) on seeded planes of the sharded
    headline's geometry, 4 bands of 272 rows (the swap path) and 24 of 48
    (the gather path), at r = 18: by CUDA events, its whole device time by
    torch.profiler (every kernel and copy it ran) and its launches; X1 on
    (4, 1088, 1920) planes beside it; then band_times' headline ms/frame on
    1, 2 and 4 bands beside render_frame, 3 turns. No checks: run it from
    two checkouts in turns to compare them."""
    import numpy as np
    import torch

    from figdraw_tpu_torch import FigRenderer, native
    from figdraw_tpu_torch.ops import binning, blur, mega, raster
    from figdraw_tpu_torch.parallel.sharding import Mesh
    from figdraw_tpu_torch.scenes import make_render_tree_array

    with ThreadPoolExecutor(5) as pool:
        list(pool.map(lambda load: load(), (native.load, raster.load, mega.load,
                                            blur.load, binning.load)))
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(24)
    frame = torch.from_numpy(rng.rand(4, 1152, 1920).astype(np.float32)).to(dev)
    r18 = torch.tensor(18.0, device=dev)
    for n, pband in ((4, 272), (24, 48)):
        bands = [frame[:, i * pband : (i + 1) * pband].contiguous() for i in range(n)]
        radii = [r18] * n
        call = lambda: blur.banded_blur_planar(bands, radii)
        launches = blur.BAND_LAUNCHES
        call()
        launches = blur.BAND_LAUNCHES - launches
        ms = cuda_ms(call, 20)
        total, parts = device_total_ms(call)
        top = sorted(parts.items(), key=lambda kv: -kv[1])[:6]
        print(f"times: X6 turns, {n} bands of {pband} rows at r=18: {ms:.4f} ms by CUDA "
              f"events, {total:.4f} ms of device time (torch.profiler, every kernel and "
              f"copy: " + ", ".join(f"{k[:60]} {v:.4f}" for k, v in top)
              + f"), {launches} launches of the blur kernels {tag}", flush=True)
    whole = frame[:, :1088].contiguous()
    x1 = lambda: blur.backdrop_blur_planar(whole, r18)
    total, parts = device_total_ms(x1)
    print(f"times: X6 turns, X1 on {tuple(whole.shape)} at r=18: {cuda_ms(x1, 20):.4f} ms "
          f"by CUDA events, {total:.4f} ms of device time ("
          + ", ".join(f"{k[:60]} {v:.4f}" for k, v in parts.items()) + f") {tag}",
          flush=True)
    cache = {}
    band_times(lambda f: make_render_tree_array(WIDTH, HEIGHT, f, copies=COPIES, cache=cache),
               FigRenderer(device="cuda"), lambda k: Mesh((dev,) * k), 3, tag)


def sharded_phase(tag: str, dev) -> dict:
    """Rendering across several devices on one card (parallel/sharding.py),
    meshes of [cuda:0] * n, each run counted with the counts set to 0 just
    before and read just after:

    1. the headline (1920x1080, 300 boxes) on 4 bands of 272 rows: the
       backdrop blur on X6's swap path; K1 at band origin 544 and the band's
       front end held against their plain versions, X6 against its plain
       version bit for bit; the frames against FigRenderer.render_frame
       within 1/255, the pixels that differ counted;
    2. the same frame on 24 bands of 48 rows, shorter than the halo: X6's
       gather path;
    3. bench_clipmask's tables (1200x800, 180x6) on 2 bands of 400 rows: the
       sub-clip table on the megakernel (K4 at origin 400), the rect-mask
       table on the frame executor (K3 at origin 400);
    4. bench_text's scene (1200x800, 36 lines, the bundled font) on 4 bands
       of 200: glyph runs across the band boundaries, K1-atlas at origin 400;
    5. bench_images' clipped cards (1920x1080, 400 panels) on 4 bands: K4-atlas
       at origin 544;
    6. a device-resident 12000-box grid on 4 bands: render_view against
       FigRenderer.render_view, the sharded render_views against its
       render_view loop and FigRenderer.render_views(chunk=, mesh=) over
       [cuda:0] * 2 against its loop, bit for bit; a patch of 8 roots and
       the damage-clipped view against a new snapshot's, bit for bit;
    7. render_batch(mesh=) over [cuda:0] * 2 on bench_anim's frames, each
       equal to render_frame's;
    8. ms/frame of the headline on 1, 2 and 4 bands beside render_frame.
    One card runs every band: these are one card's numbers and claim no
    scaling."""
    import numpy as np
    import torch

    from figdraw_tpu_torch import Color, FigRenderer, fill, rgba, vec2
    from figdraw_tpu_torch.ops import mega, raster
    from figdraw_tpu_torch.parallel.sharding import (
        FRAMES_AXIS, Mesh, ShardedFigRenderer, band_geometry, band_tiles,
    )
    from figdraw_tpu_torch.resources import ImageMessageBus, put_image
    from figdraw_tpu_torch.scenes import (
        IMAGE_ID, TEXT_SIZE, build_grid, make_clip_table_scene, make_image_panels_scene,
        make_render_tree_array, make_text_scene, photo_image,
    )
    from figdraw_tpu_torch.text.typefaces import bundled_font_path, load_typeface

    t_phase = time.perf_counter()
    med = statistics.median
    mesh = lambda n, axis="rows": Mesh((dev,) * n, axis)
    white = Color(1.0, 1.0, 1.0, 1.0)
    out = {"frames": {}}

    def plan_of(sr, renders, size):
        sr.process_image_messages()
        return sr._flattener._walk_plan(renders, size, True, white)

    def band_row(n, height, k):
        return band_geometry(n, height, 128)[3] * k

    # --- 1. the headline on 4 bands: X6's swap path ---
    size = vec2(WIDTH, HEIGHT)
    cache = {}
    head = lambda f: make_render_tree_array(WIDTH, HEIGHT, f, copies=COPIES, cache=cache)
    sr = ShardedFigRenderer(mesh(SHARD_BANDS))
    print(f"check 16: mesh {[str(d) for d in sr.mesh.devices]}, headline bands of "
          f"{band_geometry(SHARD_BANDS, HEIGHT, WIDTH)[3]} rows, kernel tiles "
          f"{band_tiles(band_geometry(SHARD_BANDS, HEIGHT, WIDTH)[3], 128)}", flush=True)
    one = FigRenderer(device="cuda")
    sr.render_frame(head(0), size)
    n = SHARD_BANDS
    plan = plan_of(sr, head(0), size)
    ms = sharded_counted("headline 4 bands", lambda f: sr.render_frame(head(f + 1), size),
                         SHARD_FRAMES, band_expected(plan, n))
    last = sr.last_frame
    out["frames"]["headline 4 bands"] = sharded_equal(
        "headline 4 bands against render_frame", last,
        one.render_frame(head(SHARD_FRAMES), size))
    row = band_row(n, HEIGHT, 2)
    plan = plan_of(sr, head(SHARD_FRAMES), size)
    k1_call, front_call = band_kernel_check(
        "K1", "headline", sr, plan, row,
        lambda errs, store: dict(draw=at_origin(
            raster.draw_pass_planar_prebinned, raster.draw_pass_planar_prebinned_plain,
            row, errs, store, "sharded headline K1")))
    bands, radii = recorded_blur_bands(sr, plan)
    banded_blur_check("headline", bands, radii, tag, timed=True)

    # --- 2. 24 bands of 48 rows: X6's gather path ---
    fine = ShardedFigRenderer(mesh(SHARD_FINE))
    fine.render_frame(head(0), size)
    sharded_counted("headline 24 bands", lambda f: fine.render_frame(head(f + 1), size), 2,
                    band_expected(plan, SHARD_FINE))
    out["frames"]["headline 24 bands"] = sharded_equal(
        "headline 24 bands against render_frame", fine.last_frame,
        one.render_frame(head(2), size))
    bands24, radii24 = recorded_blur_bands(fine, plan_of(fine, head(2), size))
    banded_blur_check("headline (24 bands)", bands24, radii24, tag, timed=False)

    # --- 3. the clip tables on 2 bands ---
    tsize = vec2(TABLE_W, TABLE_H)
    tables = ShardedFigRenderer(mesh(SHARD_TABLE_BANDS))
    row = band_row(SHARD_TABLE_BANDS, TABLE_H, 1)
    for kind, name, draws_of in (
            ("subclip", "K4",
             lambda errs, store: dict(draw=at_origin(
                 mega.draw_pass_mega, mega.draw_pass_mega_plain, row, errs, store,
                 "sharded sub-clip K4", MEGA_TARGETS))),
            ("rectmask", "K3",
             lambda errs, store: dict(draw_mask=at_origin(
                 raster.draw_pass_mask_prebinned, raster.draw_pass_mask_prebinned_plain,
                 row, errs, store, "sharded rect-mask K3")))):
        scene = make_clip_table_scene(kind, TABLE_W, TABLE_H, TABLE_ROWS, TABLE_COLS)
        tables.render_frame(scene, tsize)
        sharded_counted(f"{kind} table", lambda f: tables.render_frame(scene, tsize),
                        SHARD_FRAMES, band_expected(plan_of(tables, scene, tsize),
                                                    SHARD_TABLE_BANDS))
        out["frames"][f"{kind} table"] = sharded_equal(
            f"{kind} table against render_frame", tables.last_frame,
            one.render_frame(scene, tsize))
        plan = plan_of(tables, scene, tsize)
        call, _front = band_kernel_check(name, f"{kind} table", tables, plan, row, draws_of)
        if name == "K4":
            band_kernel_times("K4", "sub-clip table", mega.draw_pass_mega,
                              mega.draw_pass_mega_plain, call, mega_work, MEGA_TARGETS, tag)
        else:
            band_kernel_times("K3", "rect-mask table", raster.draw_pass_mask_prebinned,
                              raster.draw_pass_mask_prebinned_plain, call,
                              lambda a, k: raster_work(a, k, mask_target=True),
                              TILE_TARGETS, tag)

    # --- 4. bench_text's scene on 4 bands: K1-atlas ---
    tid = load_typeface(bundled_font_path())
    text_scene, _glyphs = make_text_scene(tid, fill(rgba(20, 20, 30, 255)), 0)
    xsize = vec2(*TEXT_SIZE)
    texts = ShardedFigRenderer(mesh(4), atlas_size=512)
    one_text = FigRenderer(atlas_size=512, device="cuda")
    texts.render_frame(text_scene, xsize)
    n = 4
    sharded_counted("bench_text", lambda f: texts.render_frame(text_scene, xsize),
                    SHARD_FRAMES, band_expected(plan_of(texts, text_scene, xsize), n))
    out["frames"]["bench_text"] = sharded_equal(
        "bench_text against render_frame", texts.last_frame,
        one_text.render_frame(text_scene, xsize))
    row = band_row(n, TEXT_SIZE[1], 2)
    call, _front = band_kernel_check(
        "K1-atlas", "bench_text", texts, plan_of(texts, text_scene, xsize), row,
        lambda errs, store: dict(draw=at_origin(
            raster.draw_pass_planar_prebinned, raster.draw_pass_planar_prebinned_plain,
            row, errs, store, "sharded bench_text K1-atlas")))
    band_kernel_times("K1-atlas", "bench_text", raster.draw_pass_planar_prebinned,
                      raster.draw_pass_planar_prebinned_plain, call, raster_work,
                      TILE_TARGETS, tag)

    # --- 5. the clipped cards on 4 bands: K4-atlas ---
    cards_scene = make_image_panels_scene(IMAGE_W, IMAGE_H, IMAGE_PANELS, "images_clipped")
    cards = ShardedFigRenderer(mesh(4))
    bus = ImageMessageBus()
    cards._flattener.ensure_image_message_subscription(bus)
    put_image(IMAGE_ID, photo_image(), bus=bus, mipmapped=True)
    one_cards = image_renderer()
    isize = vec2(IMAGE_W, IMAGE_H)
    cards.render_frame(cards_scene, isize)
    sharded_counted("clipped cards", lambda f: cards.render_frame(cards_scene, isize),
                    SHARD_FRAMES, band_expected(plan_of(cards, cards_scene, isize), n))
    out["frames"]["clipped cards"] = sharded_equal(
        "clipped cards against render_frame", cards.last_frame,
        one_cards.render_frame(cards_scene, isize))
    row = band_row(n, IMAGE_H, 2)
    call, _front = band_kernel_check(
        "K4-atlas", "clipped cards", cards, plan_of(cards, cards_scene, isize), row,
        lambda errs, store: dict(draw=at_origin(
            mega.draw_pass_mega, mega.draw_pass_mega_plain, row, errs, store,
            "sharded clipped cards K4-atlas", MEGA_TARGETS)))
    band_kernel_times("K4-atlas", "clipped cards", mega.draw_pass_mega,
                      mega.draw_pass_mega_plain, call, mega_work, MEGA_TARGETS, tag)

    # the headline's K1 and front end at their band, timed
    band_kernel_times("K1", "headline", raster.draw_pass_planar_prebinned,
                      raster.draw_pass_planar_prebinned_plain, k1_call, raster_work,
                      TILE_TARGETS, tag)
    band_front_times("headline", front_call, tag)

    # --- 6. a device-resident 12000-box grid on 4 bands ---
    arr, boxes = build_grid(RESIDENT_SCALES[-1] * 3, WIDTH, HEIGHT)
    grid = ShardedFigRenderer(mesh(4))
    scene = grid.snapshot_scene(arr, size)
    one_grid = FigRenderer(device="cuda")
    single = one_grid.snapshot_scene(arr, size)
    pans = [(float(7 * i), float(-3 * i)) for i in range(SHARD_VIEWS)]
    zooms = [1.0 + 0.125 * (i % 3) for i in range(SHARD_VIEWS)]
    grid.render_view(scene, pans[1], zooms[1])
    sharded_counted("grid views", lambda f: grid.render_view(scene, pans[f], zooms[f]),
                    SHARD_VIEWS, band_expected(scene.plan, 4))
    from figdraw_tpu_torch.ops.binning import unpack_combo_plain

    pband = band_geometry(4, HEIGHT, WIDTH)[3]
    kth = band_tiles(pband, scene.plan.tile_h)[0]
    for pan, zoom in ((pans[0], 1.0), (pans[-1], 1.5)):
        want = one_grid.render_view(single, pan, zoom)
        fields, modes = (t.cpu() for t in unpack_combo_plain(single.scratch[: single.n_quads]))

        def fringe(ys, xs, fields=fields, modes=modes):
            return layout_fringe(fields, modes, ys, xs, tile_rows(ys, single.plan.tile_h),
                                 tile_rows(ys, kth, pband))

        out["frames"][f"grid view zoom {zoom:g}"] = sharded_equal(
            f"12000-box view at pan {pan}, zoom {zoom:g} against FigRenderer.render_view",
            grid.render_view(scene, pan, zoom), want, fringe=fringe)
    stack = grid.render_views(scene, pans, zooms, chunk=4)
    loop = torch.stack([grid.render_view(scene, p, z) for p, z in zip(pans, zooms)])
    par = one_grid.render_views(single, pans, zooms, chunk=4,
                                mesh=mesh(2, FRAMES_AXIS))
    par_loop = torch.stack([one_grid.render_view(single, p, z) for p, z in zip(pans, zooms)])
    torch.cuda.synchronize()
    if not (torch.equal(stack, loop) and torch.equal(par, par_loop)):
        fail("the sharded render_views or FigRenderer.render_views(mesh=) differ from "
             "their render_view loops")
    lst = arr[0]
    dirty = []
    for k in range(DIRTY_ROOTS):
        b = boxes[k * 97 % len(boxes)]
        x, y, w, h = lst.nodes[b]["box"]
        lst.set_box(b, float(x) + 5.0, float(y) + 3.0, float(w), float(h))
        lst.set_solid_color(b, rgba((b * 13) % 255, 120, 220, 180))
        dirty.append((0, b))
    from figdraw_tpu_torch.parallel import sharding

    grid.render_view(scene, pans[2], zooms[2])
    grid.update_scene(scene, arr, dirty=dirty)
    spans = recorded(sharding, "damage_spans",
                     lambda: out.__setitem__("clipped", grid.render_view(scene, pans[2],
                                                                         zooms[2])))
    clipped = out.pop("clipped")
    if len(spans) != 1:
        fail("the sharded view after a patch did not take the damage clip")
    fresh = grid.render_view(grid.snapshot_scene(arr, size), pans[2], zooms[2])
    torch.cuda.synchronize()
    print(f"check 16: sharded 12000-box grid: render_views (chunk 4) equal to the "
          f"render_view loop, FigRenderer.render_views(chunk=4, mesh=[cuda:0] * 2) equal to "
          f"its loop, the damage-clipped view after a patch of {DIRTY_ROOTS} roots "
          f"{'equal' if torch.equal(clipped, fresh) else 'NOT equal'} to a new snapshot's",
          flush=True)
    if not torch.equal(clipped, fresh):
        fail("the sharded damage-clipped view differs from a new snapshot's")

    # --- 7. render_batch over [cuda:0] * 2 on bench_anim's frames ---
    anim = [make_render_tree_array(WIDTH, HEIGHT, f, copies=COPIES) for f in range(SHARD_FRAMES)]
    batch_ren = FigRenderer(device="cuda")
    batch = batch_ren.render_batch(anim, size, chunk=4, mesh=mesh(2, FRAMES_AXIS))
    for f, renders in enumerate(anim):
        if not torch.equal(batch[f], one.render_frame(renders, size)):
            fail(f"render_batch(mesh=) frame {f} differs from render_frame's")
    print(f"check 16: render_batch(mesh=[cuda:0] * 2, chunk=4) on {SHARD_FRAMES} of "
          f"bench_anim's frames: each equal to render_frame's", flush=True)

    # --- 8. ms/frame on 1, 2 and 4 bands beside render_frame ---
    out["ms"] = band_times(head, one, mesh, 2, tag)
    out["headline_4_bands_ms"] = med(ms)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"check 16: the sharded phase took {out['seconds']:.1f} s", flush=True)
    return out


def main() -> None:
    import numpy as np
    import torch

    t_main = time.perf_counter()

    # --- 1. device ---------------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    tag = f"[{card}]"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] in (["turns"], ["band_turns"], ["x6_turns"]):
        {"turns": turns_phase, "band_turns": band_turns_phase,
         "x6_turns": x6_turns_phase}[sys.argv[1]](tag)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
            flush=True)
        return

    from figdraw_tpu_torch import FigRenderer, vec2
    from figdraw_tpu_torch import native
    from figdraw_tpu_torch.executor import get_frame_executor
    from figdraw_tpu_torch.ops import binning, blur, mega, raster, rows
    from figdraw_tpu_torch.ops.binning import bin_quads
    from figdraw_tpu_torch.ops.layout import QF_RECT_PARAMS, QI_MODE
    from figdraw_tpu_torch.plan import plan_execution
    from figdraw_tpu_torch.scenes import make_render_tree_array, modes_tape
    from figdraw_tpu_torch.text import native_typeset
    from figdraw_tpu_torch.utils import flippy, png

    dev = torch.device("cuda", 0)

    # --- 2. build: the walk and each kernel source at once ------------------------
    def timed(fn):
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        builds = {name: pool.submit(timed, fn) for name, fn in (
            ("walk (g++)", native.load), ("raster.cu (nvcc)", raster.load),
            ("mega.cu (nvcc)", mega.load), ("rows.cu (nvcc)", rows.load),
            ("blur.cu (nvcc)", blur.load), ("binning.cu (nvcc)", binning.load),
            ("snappy (g++)", flippy.load), ("png_unfilter (g++)", png.load),
            ("typeset (g++)", native_typeset.build))}
        secs = {name: f.result() for name, f in builds.items()}
    print("build: " + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
          + f"; {time.perf_counter() - t0:.2f} s in all {tag}", flush=True)
    for log in (raster.BUILD_LOG, mega.BUILD_LOG, rows.BUILD_LOG, blur.BUILD_LOG,
                binning.BUILD_LOG):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    ren = FigRenderer(device="cuda")
    size = vec2(WIDTH, HEIGHT)
    plain = raster.draw_pass_planar_prebinned_plain

    # --- 3a. kernel vs plain on both draw runs of the headline tape ---------------
    draw_args = []  # (args, kwargs) of each headline draw, for the timings

    def compare_draw(*args, **kw):
        before = as_before(args)
        out = raster.draw_pass_planar_prebinned(*args, **kw)
        ref = plain(*before, **kw)
        torch.cuda.synchronize()
        if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
            fail("non-finite planes from the headline draw")
        draw_args.append((args, kw, float((out - ref).abs().max())))
        return out

    tape = ren.flatten(make_render_tree_array(WIDTH, HEIGHT, 0, copies=COPIES), size)
    plan = plan_execution(tape)
    run = get_frame_executor(plan.structure, plan.height, plan.width,
                             plan.n_masks, plan.has_init_frame, plan.tile_h)
    combo = torch.from_numpy(plan.combo).to(dev, copy=True)
    run(combo, None, draw=compare_draw)
    print(f"headline tape: {tape.count} quads, structure {list(plan.structure)}, "
          f"tile_h {plan.tile_h}", flush=True)
    if len(draw_args) != 2:
        fail(f"headline tape ran {len(draw_args)} draws, expected 2")
    err_headline = max(e for _a, _k, e in draw_args)
    for i, (args, kw, err) in enumerate(draw_args):
        b = args[2].tolist()
        print(f"check 3a: draw run {i} quads [{b[0]}, {b[1]}) backdrop="
              f"{args[7] is not None} kernel vs plain max |diff| {err:.3e} "
              f"(tol {TOL:.3e})", flush=True)
        if not err <= TOL:
            fail(f"headline draw run {i}: kernel differs from plain by {err}")

    # --- 3b. kernel vs plain on the SDF modes scene -------------------------------
    err_modes = 0.0
    rng = np.random.RandomState(7)
    mw, mh = 1024, 512
    fields_np, modes_np, n_live = modes_tape(mw, mh)
    n_pad = fields_np.shape[0]
    base = (modes_np[:n_live, QI_MODE] % 256) % 128
    census = sorted(set(base.tolist()))
    fills = sorted(set((modes_np[:n_live, QI_MODE] // 256).tolist()))
    ell = int(((modes_np[:n_live, QI_MODE] % 256) >= 128).sum())
    rect_masked = int((fields_np[:n_live, QF_RECT_PARAMS + 2] >= 0).sum())
    print(f"modes scene: {n_live} quads (4 rows built with numpy: modes 8, "
          f"11, 21 and 17, which the walk does not emit), modes {census}, fill modes {fills}, "
          f"{ell} elliptical, {rect_masked} rect-masked", flush=True)
    want = {3, 7, 8, 9, 11, 12, 17, 18, 19, 20, 21}
    if set(census) != want or fills != [0, 1, 2, 3, 4] or not ell or not rect_masked:
        fail("the modes scene does not cover every mode the kernel handles")
    fields = torch.from_numpy(fields_np).to(dev)
    modes = torch.from_numpy(modes_np).to(dev)
    bounds = torch.tensor([0, n_live], dtype=torch.int32, device=dev)
    for th in (128, 64):
        ph, pw = -(-mh // th) * th, -(-mw // 128) * 128
        tile_idx, tile_counts = bin_quads(fields, 0, n_pad, ph // th, pw // 128,
                                          th, 128, modes=modes)
        planes = torch.from_numpy(rng.rand(4, ph, pw).astype(np.float32)).to(dev)
        backdrop = torch.from_numpy(rng.rand(4, ph, pw).astype(np.float32)).to(dev)
        masks = torch.ones((1, ph, pw), dtype=torch.float32, device=dev)
        out = raster.draw_pass_planar_prebinned(
            fields, modes, bounds, tile_idx, tile_counts, planes.clone(), masks,
            backdrop, tile_h=th)
        ref = plain(fields, modes, bounds, tile_idx, tile_counts, planes, masks,
                    backdrop, tile_h=th)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        err_modes = max(err_modes, err)
        print(f"check 3b: modes scene {mw}x{mh} tile_h {th}: kernel vs plain "
              f"max |diff| {err:.3e} (tol {TOL:.3e})", flush=True)
        if not (torch.isfinite(out).all() and err <= TOL):
            fail(f"modes scene tile_h {th}: kernel differs from plain by {err}")

    # --- 4. the slice: render_frame on the headline scene -------------------------
    cache = {}
    ren = FigRenderer(device="cuda")
    frame = ren.render_frame(
        make_render_tree_array(WIDTH, HEIGHT, 0, copies=COPIES, cache=cache), size)
    torch.cuda.synchronize()
    host_ms, device_ms, total_ms = [], [], []
    zero_counts()
    for f in range(1, FRAMES + 1):
        t0 = time.perf_counter()
        tape = ren.flatten(
            make_render_tree_array(WIDTH, HEIGHT, f, copies=COPIES, cache=cache), size)
        t1 = time.perf_counter()
        frame = ren.execute(tape)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host_ms.append((t1 - t0) * 1e3)
        device_ms.append((t2 - t1) * 1e3)
        total_ms.append((t2 - t0) * 1e3)
        if tuple(frame.shape) != (HEIGHT, WIDTH, 4):
            fail(f"frame {f} has shape {tuple(frame.shape)}")
        if not bool(torch.isfinite(frame).all()):
            fail(f"frame {f} holds non-finite values")
    launches = raster.LAUNCHES
    print(f"check 4: {FRAMES} frames of {HEIGHT}x{WIDTH}x4, finite; raster "
          f"kernel launches {launches} ({launches / FRAMES:g} per frame)", flush=True)
    if launch_counts() != (2 * FRAMES, 0, 0, 0, 0):
        fail(f"{FRAMES} headline frames launched (K1, K1-atlas, K3, K4, K4-atlas) "
             f"{launch_counts()}, expected {2 * FRAMES}, 0, 0, 0, 0")
    blur_launches = blur.LAUNCHES
    if blur_launches != 2 * FRAMES:
        fail(f"{FRAMES} headline frames launched the blur kernel {blur_launches} "
             f"times, expected {2 * FRAMES} (one a pass)")
    BIN_PATHS["headline"] = binning_launches("headline", FRAMES)
    BORDERLINE["headline"] = binning_check("headline", lambda: ren.execute(tape))
    # the last frame again, by the same executor with the plain raster
    plan = plan_execution(tape)
    run = get_frame_executor(plan.structure, plan.height, plan.width,
                             plan.n_masks, plan.has_init_frame, plan.tile_h)
    ref = run(torch.from_numpy(plan.combo).to(dev, copy=True), None, draw=plain)
    torch.cuda.synchronize()
    err_frame = float((frame - ref).abs().max())
    print(f"check 4: frame {FRAMES} kernel path vs plain-raster path max |diff| "
          f"{err_frame:.3e} (tol {TOL:.3e})", flush=True)
    if not err_frame <= TOL:
        fail(f"frame {FRAMES} differs from the plain-raster executor by {err_frame}")
    # the JAX reference (figdraw_tpu on CPU, stored as 8x8 block means)
    small = FigRenderer(device="cuda").render_frame(
        make_render_tree_array(384, 216, 0, copies=10), vec2(384, 216))
    got = block_means(small.cpu().numpy())
    want_blocks = np.load(REF_BLOCKS)
    err_ref = float(np.abs(got - want_blocks).max())
    print(f"check 4: 384x216 headline frame 0 vs the JAX reference (8x8 block "
          f"means) max |diff| {err_ref:.3e} (tol {TOL:.3e})", flush=True)
    if not err_ref <= TOL:
        fail(f"port frame differs from the JAX reference by {err_ref}")

    # --- 5. times ----------------------------------------------------------------
    print(f"times: {FRAMES} frames {WIDTH}x{HEIGHT} {COPIES * 3} boxes: median "
          f"{statistics.median(total_ms):.3f} ms/frame = host flatten "
          f"{statistics.median(host_ms):.3f} ms + device {statistics.median(device_ms):.3f} "
          f"ms (upload, executor, sync) {tag}", flush=True)

    def draws(fn):
        return lambda: [fn(*a, **k) for a, k, _e in draw_args]

    kernel_ms = cuda_ms(draws(raster.draw_pass_planar_prebinned), 20)
    plain_ms = cuda_ms(draws(plain), 3)
    k1_work = sum(raster_work(a, k) for a, k, _e in draw_args)
    device_ms_k1 = device_ms_of(draws(raster.draw_pass_planar_prebinned),
                                "raster_tiles_kernel<false, false>",
                                launches=len(draw_args))
    print(f"times: headline draw runs (both): kernel {kernel_ms:.4f} ms (CUDA events "
          f"around the wrapper calls), {device_ms_k1:.4f} ms (the kernels alone, "
          f"torch.profiler), plain torch {plain_ms:.2f} ms; {bound_text(k1_work)} {tag}",
          flush=True)
    for i, (a, k, _e) in enumerate(draw_args):
        ms = cuda_ms(lambda: raster.draw_pass_planar_prebinned(*a, **k), 20)
        print(f"times: headline draw run {i}: kernel {ms:.4f} ms {tag}", flush=True)
    # the executor's stages on the frame-0 headline tape, with its own inputs
    stages = front_stages("headline")
    radius = torch.tensor(plan.radii[0], dtype=torch.float32, device=dev)
    ms_blur = cuda_ms(lambda: blur.backdrop_blur_planar(draw_args[1][0][5], radius), 20)
    ms_blur_plain = cuda_ms(
        lambda: blur.backdrop_blur_planar_plain(draw_args[1][0][5], radius), 5)
    ms_exec = cuda_ms(lambda: run(combo, None), 20)
    print(f"times: executor stages: decode {stages['decode']:.4f} ms (the front "
          f"kernel's decode-only form), front end {stages['front end']:.4f} ms (the "
          f"front kernel and the tile kernel; the plain torch decode and binning "
          f"{stages['front end (plain torch)']:.4f} ms), blur {ms_blur:.4f} ms (the kernel; the plain torch blur "
          f"{ms_blur_plain:.4f} ms), whole executor {ms_exec:.4f} ms "
          f"(device, CUDA events) {tag}", flush=True)
    blurred = blur_phase(draw_args[1][0][5], plan.radii[0], tag)
    binned = {"headline": binning_times("headline", tag)}

    # --- 6. the clip-mask tables (bench_clipmask.py) ------------------------------
    tables = {kind: clip_table_phase(kind, tag, dev) for kind in ("rectmask", "subclip")}
    rm, sc = tables["rectmask"], tables["subclip"]
    binned["rectmask table"] = binning_times("rectmask table", tag)
    t0 = time.perf_counter()
    kernel_ms_k3 = cuda_ms(lambda: raster.draw_pass_mask_prebinned(*rm["k3_args"]), 20)
    plain_ms_k3 = cuda_ms(lambda: raster.draw_pass_mask_prebinned_plain(*rm["k3_args"]), 3)
    kernel_ms_k4 = cuda_ms(lambda: mega.draw_pass_mega(*sc["k4_args"]), 20)
    plain_ms_k4 = cuda_ms(lambda: mega.draw_pass_mega_plain(*sc["k4_args"]), 3)
    device_ms_k3 = device_ms_of(lambda: raster.draw_pass_mask_prebinned(*rm["k3_args"]),
                                "raster_tiles_kernel<true")
    device_ms_k4 = device_ms_of(lambda: mega.draw_pass_mega(*sc["k4_args"]),
                                "mega_kernel<false>")
    print(f"times: K3 on the rect-mask table's mask run: kernel {kernel_ms_k3:.4f} "
          f"ms (CUDA events around the wrapper call), {device_ms_k3:.4f} ms (the "
          f"kernel alone, torch.profiler), plain torch {plain_ms_k3:.2f} ms {tag}",
          flush=True)
    print(f"times: K4 on the sub-clip table: kernel {kernel_ms_k4:.4f} ms (CUDA "
          f"events around the wrapper call), {device_ms_k4:.4f} ms (the kernel "
          f"alone, torch.profiler), plain torch {plain_ms_k4:.2f} ms "
          f"({time.perf_counter() - t0:.1f} s) {tag}", flush=True)
    k1_table_ms = cuda_ms(lambda: [raster.draw_pass_planar_prebinned(*a, **k)
                                   for a, k in rm["k1_args"]], 20)
    print(f"times: K1 on the rect-mask table's two frame runs: kernel "
          f"{k1_table_ms:.4f} ms; "
          f"{bound_text(sum(raster_work(a, k) for a, k in rm['k1_args']))} {tag}",
          flush=True)
    print(f"times: K3 on the rect-mask table's mask run: {bound_text(rm['k3_work'])} "
          f"{tag}", flush=True)

    mega_clamps_check(dev)

    # --- 7. images, text, the megakernel with the atlas, the rolled executor -------
    images = images_phase(tag, dev)
    text = text_phase(tag, dev)
    cards = mega_atlas_phase("clipped cards", tag, dev)
    table = mega_atlas_phase("text table", tag, dev)
    host = text_host_phase(tag, dev)
    rolled = rolled_phase(tag, dev)
    binned["text table"] = binning_times("text table", tag)
    faster = all(p["mega_ms"] < p["rolled_ms"] for p in (cards, table))
    print(f"routing: the megakernel with the atlas against the rolled executor, "
          f"median ms/frame: clipped cards {cards['mega_ms']:.3f} against "
          f"{cards['rolled_ms']:.3f}, text table {table['mega_ms']:.3f} against "
          f"{table['rolled_ms']:.3f}: the megakernel is "
          f"{'faster on both' if faster else 'not faster on both'} {tag}", flush=True)
    scaled_args, scaled_kw = images["images_scaled"]["args"]
    plain_ms_atlas = cuda_ms(
        lambda: raster.draw_pass_planar_prebinned_plain(*scaled_args, **scaled_kw), 3)
    device_ms_atlas = device_ms_of(
        lambda: raster.draw_pass_planar_prebinned(*scaled_args, **scaled_kw),
        "raster_tiles_kernel<false, true>")
    print(f"times: K1-atlas on the images_scaled frame's draw: kernel "
          f"{images['images_scaled']['kernel_ms']:.4f} ms (CUDA events around the "
          f"wrapper call), {device_ms_atlas:.4f} ms (the kernel alone, "
          f"torch.profiler), plain torch {plain_ms_atlas:.2f} ms {tag}", flush=True)

    # --- 8. device-resident scenes: camera, per-root animation, retained updates ---
    resident = resident_phases(tag)
    big = RESIDENT_SCALES[-1] * 3
    binned[f"camera {big}"] = binning_times(f"camera {big}", tag)
    for name, phase in [("rectmask", rm), ("subclip", sc), ("text", text),
                        ("clipped cards", cards), ("text table", table), ("rolled", rolled)] + [
            (f"images {v}", images[v]) for v in BENCH_VARIANTS]:
        BIN_PATHS[name] = phase["bin_launches"]
        BORDERLINE[name] = phase["borderline"]
    BIN_PATHS["text host"] = host["bin_launches"]
    BORDERLINE["text host"] = host["borderline"]
    BIN_PATHS["text table host"] = host["table_bin_launches"]
    BORDERLINE["text table host"] = host["table_borderline"]
    BIN_PATHS.update({f"text tree {f}": v["bin_launches"] for f, v in host["tree"].items()})
    print(f"check 9: tile-kernel launches by path {BIN_PATHS} and front-kernel "
          f"launches {FRONT_PATHS} (one each an executor run; no plain decode or "
          f"binning on any path); saturation-borderline quads left out by scene "
          f"{BORDERLINE} (expected 0)", flush=True)
    split = tile_split(f"camera {big}", tag)
    blur_paths = {"headline": blur_launches}
    blur_paths.update({f"camera {c * 3}": resident[c]["camera"]["blur_launches"]
                       for c in RESIDENT_SCALES})

    # --- 8b. tree-form scenes: the Python walk and the planner ------------------
    trees = tree_phase(tag)
    tree_paths = {k: {f"tree {p}": n[k] for p, n in trees["launches"].items() if n[k]}
                  for k in ("K1", "K3", "K4", "blur")}
    tree_errs = {k: max(v) for k, v in trees["errs"].items() if v}
    blur_paths.update(tree_paths["blur"])

    # --- 8c. the frame loop: render_batch, render_frame_async, overlays, blurred cards ---
    loop = frameloop_phases(tag, dev)

    # --- 8d. images from files and generated SDFs ----------------------------------
    before_images = time.perf_counter() - t_main
    images_from_files = image_files_phase(tag, dev)
    print(f"wall time: {before_images:.1f} s before the image_files phase, "
          f"{time.perf_counter() - t_main:.1f} s after it", flush=True)

    # --- 8e. the C ABI for external hosts -------------------------------------------
    capi = capi_phase(tag)
    print(f"capi: {json.dumps(capi)}", flush=True)

    # --- 8f. CFF and variable faces ------------------------------------------------
    fonts = fonts_phase(tag, dev, host)
    print(f"fonts: {json.dumps(fonts)}", flush=True)

    # --- 8f'. WOFF and VARC faces --------------------------------------------------
    woff_varc = woff_varc_phase(tag, dev, host, fonts)
    print(f"woff_varc: {json.dumps(woff_varc)}", flush=True)
    for phase in (fonts, woff_varc):
        for key, n in phase["bin_launches"].items():
            BIN_PATHS[f"fonts {key}"] = n
            BORDERLINE[f"fonts {key}"] = phase["borderline"][key]
        BIN_PATHS[f"fonts table {phase['table']['key']}"] = phase["table"]["bin_launches"]
        BORDERLINE[f"fonts table {phase['table']['key']}"] = phase["table"]["borderline"]

    # --- 8f''. WOFF2 faces through the port's Brotli decoder ----------------------------
    woff2_fonts = woff2_phase(tag, dev, host, fonts)
    print(f"woff2: {json.dumps(woff2_fonts)}", flush=True)
    for key, n in woff2_fonts["bin_launches"].items():
        BIN_PATHS[f"fonts {key}"] = n
        BORDERLINE[f"fonts {key}"] = woff2_fonts["borderline"][key]
    BIN_PATHS[f"fonts table {woff2_fonts['table']['key']}"] = woff2_fonts["table"]["bin_launches"]
    BORDERLINE[f"fonts table {woff2_fonts['table']['key']}"] = woff2_fonts["table"]["borderline"]

    # --- 8g. rendering across several devices: row bands on one card ------------------
    shard = sharded_phase(tag, dev)
    print(f"sharded: {json.dumps(shard)}", flush=True)
    for key in ("K1", "K1-atlas", "K3", "K4", "K4-atlas", "front", "tiles", "X6"):
        if not sum(p[key] for p in SHARD_PATHS.values()):
            fail(f"no sharded path launched {key} at a band origin")
    loop_paths = {k: {p: n[k] for p, n in LOOP_PATHS.items() if n[k]}
                  for k in ("K1", "K1-atlas", "K3", "K4", "K4-atlas", "blur")}
    BIN_PATHS.update({p: n["binning"] for p, n in LOOP_PATHS.items()})
    FRONT_PATHS.update({p: n["decode"] for p, n in LOOP_PATHS.items()})
    blur_paths.update(loop_paths["blur"])
    anim = loop["batch"]
    print(f"frame loop: batch against the render_frame loop, ms/frame: "
          + ", ".join(f"{k} {v['batch_ms']:.3f} against {v['loop_ms']:.3f}"
                      for k, v in anim.items() if "batch_ms" in v)
          + f"; async {loop['async']['async_ms']:.3f} against sync "
          f"{loop['async']['sync_ms']:.3f}; blurred cards {loop['blurred']['ms']:.3f} "
          f"(walk {loop['blurred']['walk_ms']:.3f}, plan {loop['blurred']['plan_ms']:.3f}, "
          f"upload and executor {loop['blurred']['exec_ms']:.3f}) {tag}", flush=True)

    # --- 9. results --------------------------------------------------------------
    # the in-place bound is the kernels' own (the out-of-place one counts
    # the earlier design's bytes, for comparison)
    k1_bound, k1_oop = bounds_of(k1_work)
    atlas_bound, atlas_oop = bounds_of(images["images_scaled"]["work"])
    k3_bound, k3_oop = bounds_of(rm["k3_work"])
    k4_bound, k4_oop = bounds_of(sc["k4_work"])
    k4a_bound, k4a_oop = bounds_of(cards["work"])
    table_bound, _table_oop = bounds_of(table["work"])
    print(f"bounds: K1 headline draws {k1_bound[0]:.4f} ms ({k1_bound[1]}; out of "
          f"place {k1_oop[0]:.4f}), K1-atlas images_scaled {atlas_bound[0]:.4f} ms "
          f"({atlas_bound[1]}; out of place {atlas_oop[0]:.4f}), K3 rect-mask "
          f"{k3_bound[0]:.4f} ms ({k3_bound[1]}; out of place {k3_oop[0]:.4f}), K4 "
          f"sub-clip {k4_bound[0]:.4f} ms ({k4_bound[1]}; out of place "
          f"{k4_oop[0]:.4f}), K4-atlas clipped cards {k4a_bound[0]:.4f} ms "
          f"({k4a_bound[1]}; out of place {k4a_oop[0]:.4f}), text table "
          f"{table_bound[0]:.4f} ms ({table_bound[1]}) at "
          f"{HBM_BYTES_PER_S / 1e12:g} TB/s and {FP32_OPS_PER_S / 1e12:g} FP32 "
          f"TFLOP/s", flush=True)
    ctrl = images["sdf_control"]
    k1_paths = {"headline": launches, "rectmask": rm["launches"][0],
                "images sdf_control": ctrl["launches"][0],
                "rolled": rolled["launches"][0], **tree_paths["K1"], **loop_paths["K1"]}
    atlas_paths = {f"images {v}": images[v]["launches"][1] for v in BENCH_VARIANTS[1:]}
    atlas_paths.update(text=text["launches"][1], rolled=rolled["launches"][1])
    atlas_paths["text host"] = host["launches"][1]
    atlas_paths.update(loop_paths["K1-atlas"])
    atlas_paths.update({f"fonts {k}": n for k, n in fonts["launches"].items()})
    atlas_paths.update({f"fonts {k}": n for k, n in woff_varc["launches"].items()})
    atlas_paths.update({f"fonts {k}": n for k, n in woff2_fonts["launches"].items()})
    k3_paths = {"rectmask": rm["launches"][1], "rolled": rolled["launches"][2],
                **tree_paths["K3"], **loop_paths["K3"]}
    k4_paths = {"subclip": sc["launches"][2], **tree_paths["K4"], **loop_paths["K4"]}
    k4a_paths = {"clipped cards": cards["launches"][4], "text table": table["launches"][4],
                 "text table host": host["table_launches"][4],
                 **{f"text tree {f}": v["launches"][4] for f, v in host["tree"].items()},
                 **loop_paths["K4-atlas"],
                 f"fonts table {fonts['table']['key']}": fonts["table"]["launches"],
                 f"fonts table {woff_varc['table']['key']}": woff_varc["table"]["launches"],
                 f"fonts table {woff2_fonts['table']['key']}": woff2_fonts["table"]["launches"]}
    loop_err = lambda name: FRAMELOOP_ERRS.get(name, 0.0)

    def band_entry(key: str, kernel: str, source: str, replaces: str, **more) -> dict:
        """A kernel's band-origin form: its launches at an origin other than
        0 on the sharded paths, its error against the plain version at the
        checked band, and its times and bound there."""
        times = SHARD_TIMES[key]
        return {"name": kernel, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(p[key] for p in SHARD_PATHS.values()),
                "launches_by_path": {p: v[key] for p, v in SHARD_PATHS.items() if v[key]},
                "max_abs_err": SHARD_ERRS[key], **times, **more, "library_ms": None}

    band_kernels = [
        band_entry("K1", "raster_tiles_kernel<false, false> (K1) at a band origin",
                   "figdraw_tpu_torch/csrc/raster.cu",
                   "figdraw_tpu/ops/raster_pallas.py:156 (row0 seg_ref[2], :161-184)"),
        band_entry("K1-atlas", "raster_tiles_kernel<false, true> (K1-atlas) at a band origin",
                   "figdraw_tpu_torch/csrc/raster.cu",
                   "figdraw_tpu/ops/raster_pallas.py:156 (has_atlas :325, row0 :184)"),
        band_entry("K3", "raster_tiles_kernel<true, *> (K3) at a band origin",
                   "figdraw_tpu_torch/csrc/raster.cu",
                   "figdraw_tpu/ops/raster_pallas.py:196 (row0 seg_ref[2], :184)"),
        band_entry("K4", "mega_kernel<false> (K4) at a band origin", "figdraw_tpu_torch/csrc/mega.cu",
                   "figdraw_tpu/ops/raster_pallas.py:495 (row0 :505, draw_pass_mega :643-665)"),
        band_entry("K4-atlas", "mega_kernel<true> (K4-atlas) at a band origin",
                   "figdraw_tpu_torch/csrc/mega.cu",
                   "figdraw_tpu/ops/raster_pallas.py:495 (has_atlas :567, row0 :505)"),
        band_entry("front", "front_kernel<MODE> (X7 with the band's tile ranges) at a band origin",
                   "figdraw_tpu_torch/csrc/binning.cu",
                   "figdraw_tpu/executor.py:181 and ops/binning.py:73 (y_offset); "
                   "XLA ops, no Pallas"),
        band_entry("tiles", "tiles_kernel<CULL, SATURATE> (X2) at a band origin",
                   "figdraw_tpu_torch/csrc/binning.cu",
                   "figdraw_tpu/ops/binning.py:35 (y_offset :36-42, :73; "
                   "raster_pallas.prebin :399); XLA ops, no Pallas"),
        # no one PyTorch call computes the banded blur: its tap step is a
        # device value and not whole pixels, as the whole blur's
        band_entry("X6", "blur_h_kernel<BandRowsH> + blur_v_kernel<VEC, BandLinesV> (X6, the "
                   "banded blur: two launches a device)", "figdraw_tpu_torch/csrc/blur.cu",
                   "figdraw_tpu/parallel/sharding.py:165 (_banded_blur_planar: ppermute "
                   "halo exchange or all_gather, then _blur_axis); XLA ops, no Pallas"),
    ]
    print(f"wall time: {time.perf_counter() - t_main:.1f} s in all", flush=True)
    print(json.dumps({"kernels": [
        {
            "name": "raster_tiles_kernel<false, false> (K1, frame target)",
            "route": "cuda",
            "source": "figdraw_tpu_torch/csrc/raster.cu",
            "replaces": "figdraw_tpu/ops/raster_pallas.py:156",
            "launches": sum(k1_paths.values()),
            "launches_by_path": k1_paths,
            "max_abs_err": max(err_headline, err_modes, err_frame, rm["k1_err"],
                               ctrl["err"], rolled["k1_err"], tree_errs.get("K1", 0.0),
                               loop_err("K1")),
            "ms": kernel_ms,
            "device_ms": device_ms_k1,
            "plain_ms": plain_ms,
            "bound_ms": k1_bound[0],
            "bound_by": k1_bound[1],
            "bound_out_of_place_ms": k1_oop[0],
            "library_ms": None,
        },
        {
            "name": "raster_tiles_kernel<false, true> (K1-atlas, frame target "
                    "sampling the atlas)",
            "route": "cuda",
            "source": "figdraw_tpu_torch/csrc/raster.cu",
            "replaces": "figdraw_tpu/ops/raster_pallas.py:325",
            "launches": sum(atlas_paths.values()),
            "launches_by_path": atlas_paths,
            "max_abs_err": max([images[v]["err"] for v in BENCH_VARIANTS[1:]]
                               + [text["err"], rolled["k1_err"], rolled["frame_err"],
                                  loop_err("K1-atlas"), host["err"]]
                               + [v["err"] for v in fonts["text"].values()]
                               + [v["err"] for v in woff_varc["text"].values()]
                               + [v["err"] for v in woff2_fonts["text"].values()]),
            "ms": images["images_scaled"]["kernel_ms"],
            "device_ms": device_ms_atlas,
            "plain_ms": plain_ms_atlas,
            "bound_ms": atlas_bound[0],
            "bound_by": atlas_bound[1],
            "bound_out_of_place_ms": atlas_oop[0],
            "msdf_star": {key: images_from_files["k1a"][key]
                          for key in ("ms", "device_ms", "plain_ms")}
                         | dict(zip(("bound_ms", "bound_by"),
                                    bounds_of(images_from_files["k1a"]["work"])[0])),
            "sdf_modes": images_from_files["census"].get("K1-atlas", {}),
            "library_ms": None,
        },
        {
            "name": "raster_tiles_kernel<true, *> (K3, mask target)",
            "route": "cuda",
            "source": "figdraw_tpu_torch/csrc/raster.cu",
            "replaces": "figdraw_tpu/ops/raster_pallas.py:196",
            "launches": sum(k3_paths.values()),
            "launches_by_path": k3_paths,
            "max_abs_err": max(rm["k3_err"], rm["frame_err"], rolled["k3_err"],
                               tree_errs.get("K3", 0.0), loop_err("K3")),
            "ms": kernel_ms_k3,
            "device_ms": device_ms_k3,
            "plain_ms": plain_ms_k3,
            "bound_ms": k3_bound[0],
            "bound_by": k3_bound[1],
            "bound_out_of_place_ms": k3_oop[0],
            "library_ms": None,
        },
        {
            "name": "mega_kernel<false> (K4)",
            "route": "cuda",
            "source": "figdraw_tpu_torch/csrc/mega.cu",
            "replaces": "figdraw_tpu/ops/raster_pallas.py:495",
            "launches": sum(k4_paths.values()),
            "launches_by_path": k4_paths,
            "max_abs_err": max(sc["k4_err"], sc["frame_err"], tree_errs.get("K4", 0.0),
                               loop_err("K4")),
            "ms": kernel_ms_k4,
            "device_ms": device_ms_k4,
            "plain_ms": plain_ms_k4,
            "bound_ms": k4_bound[0],
            "bound_by": k4_bound[1],
            "bound_out_of_place_ms": k4_oop[0],
            "entries_before_cull": sc["k4_work"][3],
            "entries_after_cull": sc["k4_work"][4],
            "library_ms": None,
        },
        {
            "name": "mega_kernel<true> (K4-atlas, the megakernel sampling the atlas)",
            "route": "cuda",
            "source": "figdraw_tpu_torch/csrc/mega.cu",
            "replaces": "figdraw_tpu/ops/raster_pallas.py:495 (has_atlas, :567)",
            "launches": sum(k4a_paths.values()),
            "launches_by_path": k4a_paths,
            "max_abs_err": max([cards["err"], table["err"], loop_err("K4-atlas"),
                                host["table_err"], fonts["table"]["err"],
                                woff_varc["table"]["err"], woff2_fonts["table"]["err"]]
                               + [v["err"] for v in host["tree"].values()]),
            "ms": cards["kernel_ms"],
            "device_ms": cards["device_ms"],
            "plain_ms": cards["plain_ms"],
            "bound_ms": k4a_bound[0],
            "bound_by": k4a_bound[1],
            "bound_out_of_place_ms": k4a_oop[0],
            "entries_before_cull": cards["work"][3],
            "entries_after_cull": cards["work"][4],
            "text_table": {"ms": table["kernel_ms"], "device_ms": table["device_ms"],
                           "plain_ms": table["plain_ms"],
                           "bound_ms": table_bound[0], "bound_by": table_bound[1],
                           "entries_before_cull": table["work"][3],
                           "entries_after_cull": table["work"][4]},
            "photo_wall": {key: images_from_files["k4a"][key]
                           for key in ("ms", "device_ms", "plain_ms")}
                          | dict(zip(("bound_ms", "bound_by"),
                                     bounds_of(images_from_files["k4a"]["work"])[0])),
            "sdf_modes": images_from_files["census"].get("K4-atlas", {}),
            "library_ms": None,
        },
        {
            "name": "rows_kernel (X3-X5: per-root affine, camera, damage clip)",
            "route": "cuda",
            "source": "figdraw_tpu_torch/csrc/rows.cu",
            "replaces": "figdraw_tpu/executor.py:761 (view_rows), :805 "
                        "(animate_rows), :1001 (the damage clip); XLA ops, no Pallas",
            "launches": sum(resident["launches"].values()),
            "launches_by_path": resident["launches"],
            "max_abs_err": resident["err"],
            **resident["times"],
            # no one PyTorch call transforms selected columns of selected rows
            "library_ms": None,
        },
        {
            "name": "blur_h_kernel + blur_v_kernel (X1: the backdrop blur, one launch a pass)",
            "route": "cuda",
            "source": "figdraw_tpu_torch/csrc/blur.cu",
            "replaces": "figdraw_tpu/ops/blur.py:61 (backdrop_blur_planar, "
                        "_blur_axis :21); XLA ops, no Pallas",
            "launches": sum(blur_paths.values()),
            "launches_by_path": blur_paths,
            "max_abs_err": max(blurred["err"], tree_errs.get("blur", 0.0), loop_err("blur")),
            "ms": blurred["ms"],
            "device_ms": blurred["device_ms"],
            "plain_ms": blurred["plain_ms"],
            "bound_ms": blurred["bound_ms"],
            "bound_by": blurred["bound_by"],
            # no one PyTorch call computes it: the tap step is a device value
            # and not whole pixels, so it is no convolution with a fixed kernel
            "library_ms": None,
        },
        {
            "name": "front_kernel<MODE> (X7: the wire decode, fused with the binning's "
                    "per-quad terms; one launch an executor run)",
            "route": "cuda",
            "source": "figdraw_tpu_torch/csrc/binning.cu",
            "replaces": "figdraw_tpu/executor.py:181 (unpack_combo_device); XLA ops, "
                        "no Pallas",
            "launches": sum(FRONT_PATHS.values()),
            "launches_by_path": FRONT_PATHS,
            # 32-bit words: the largest |kernel - plain| over every path's
            # fields and modes (the check fails on any difference)
            "max_abs_err": max(d[2] for d in DECODE_DIFF.values()),
            "words_compared": sum(d[0] for d in DECODE_DIFF.values()),
            "words_differing": sum(d[1] for d in DECODE_DIFF.values()),
            **binned["headline"]["front"],
            "by_scene": {k: v["front"] for k, v in binned.items() if k != "headline"},
            # no one PyTorch call decodes u8x4 words through a table
            "library_ms": None,
        },
        {
            "name": "tiles_kernel<CULL, SATURATE> (X2: the tile binning; launched by "
                    "the front end, or after prep_kernel by bin_quads)",
            "route": "cuda",
            "source": "figdraw_tpu_torch/csrc/binning.cu",
            "replaces": "figdraw_tpu/ops/binning.py:35 (bin_quads); XLA ops, no Pallas",
            "launches": sum(BIN_PATHS.values()),
            "launches_by_path": BIN_PATHS,
            # integer lists: the largest |kernel - plain| over the entries
            # and kept counts each path's check compared, outside the
            # saturation-borderline quads (the check fails on any)
            "max_abs_err": max(d["max_abs_err"] for d in BIN_DIFF.values()),
            "entries_compared": sum(d["compared"] for d in BIN_DIFF.values()),
            "entries_differing": sum(d["differing"] for d in BIN_DIFF.values()),
            "borderline_quads": BORDERLINE,
            # ms: CUDA events around the front end's call (both kernels);
            # device_ms the tile kernel alone; plain_ms the plain front end
            "ms": binned["headline"]["ms"],
            "device_ms": binned["headline"]["tiles"]["device_ms"],
            "plain_ms": binned["headline"]["plain_ms"],
            "bound_ms": binned["headline"]["tiles"]["bound_ms"],
            "bound_by": binned["headline"]["tiles"]["bound_by"],
            "front_end": {key: binned["headline"][key] for key in (
                "ms", "host_ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
            "by_scene": {k: {**v["tiles"], "front_end_ms": v["ms"],
                             "front_end_host_ms": v["host_ms"],
                             "front_end_device_ms": v["device_ms"],
                             "front_end_plain_ms": v["plain_ms"],
                             "front_end_bound_ms": v["bound_ms"]}
                         for k, v in binned.items() if k != "headline"},
            "phases_12000_boxes": split,
            # no one PyTorch call computes per-tile culled lists; argsort_ms
            # is torch.argsort of the plain version's keys, for the record
            "argsort_ms": binned["headline"]["argsort_ms"],
            "library_ms": None,
        },
    ] + band_kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    if os.environ.get("PYTHONHASHSEED") != "0":
        # a variation's font id hashes its axis tags with Python's string
        # hash, and an array scene's glyphs take their atlas places in
        # font-id order: the fonts phase's atlases equal the stored ones
        # (written under PYTHONHASHSEED=0) only under the same seed
        os.execve(sys.executable, [sys.executable, os.path.abspath(__file__), *sys.argv[1:]],
                  dict(os.environ, PYTHONHASHSEED="0"))
    main()
