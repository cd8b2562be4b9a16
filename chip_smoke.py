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
  pipeline's steps and render_frame's perf span means;
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
  port's libraries and run.

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
so both see the same card and power limit.

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
REF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "figdraw_tpu_torch", "reference")
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
               mega=False):
    """Every (tile, quad) pair of the binned lists (the run's segment [seg)
    when given) that covers pixels: (quad, mode word, x0, x1, y0, y1), the
    tile's pixels whose centers lie in the quad's bbox as the integer
    ranges [x0, x1) x [y0, y1). Clear sentinels of the mega tape cover
    none."""
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
    ty0 = (t // tiles_x) * tile_h
    # pixel x is covered when x + 0.5 lies in [bbox_x0, bbox_x1)
    x0 = np.maximum(np.ceil(f[q, QF_BBOX_X0] - 0.5), tx0).astype(np.int64)
    x1 = np.minimum(np.ceil(f[q, QF_BBOX_X1] - 0.5), tx0 + 128).astype(np.int64)
    y0 = np.maximum(np.ceil(f[q, QF_BBOX_Y0] - 0.5), ty0).astype(np.int64)
    y1 = np.minimum(np.ceil(f[q, QF_BBOX_Y1] - 0.5), ty0 + tile_h).astype(np.int64)
    keep = (x1 > x0) & (y1 > y0)
    return q[keep], r[keep], x0[keep], x1[keep], y0[keep], y1[keep]


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
    pairs = live_pairs(fields, modes, tile_idx, tile_counts, kw["tile_h"], pw // 128,
                       seg=bounds.tolist())
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
                                               kw["tile_h"], ph, pw)
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
    pairs = live_pairs(fields, modes, tile_idx, tile_counts, th, pw // 128, mega=True)
    n_bytes = (len(np.unique(pairs[0])) * (QF_WIDTH + QI_WIDTH) * 4
               + (int(tile_counts.sum()) + tile_counts.numel()) * 4)
    if atlas is not None:
        n_bytes += atlas_bytes(fields, pairs, atlas)
    before, after, blocks = mega.block_entries(fields, modes, tile_idx, tile_counts, th,
                                               ph, pw)
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


def check_blocks(what: str, frame, path: str) -> float:
    import numpy as np

    err = float(np.abs(block_means(frame.cpu().numpy()) - np.load(path)).max())
    print(f"check: {what} vs the JAX reference (8x8 block means) max |diff| "
          f"{err:.3e} (tol {TOL:.3e})", flush=True)
    if not err <= TOL:
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

    def call(key, plan, batch, atlas):
        groups.append((key, plan, batch, atlas))
        return real(key, plan, batch, atlas)

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
    beside the main path). Host times of each step of the pipeline, the
    photo wall's ms/frame with its host and device split and its perf span
    means."""
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
        EXAMPLE_FORMS, EXAMPLE_IMAGES, EXAMPLE_SCENES, IMAGE_FILE_SIZE, IMAGE_FIXTURE,
        IMAGE_FIXTURE_REFERENCE, PHOTO_WALL_PANELS, PHOTO_WALL_REFERENCE, PHOTO_WALL_SIZE,
        PHOTO_WALL_SMALL, example_reference_path, make_image_file_scene,
        make_loaded_photo_wall,
    )
    from figdraw_tpu_torch.utils import flippy, perf, png

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

        # --- render_frame: the image-file scene and the SDF scenes in each form ---
        def checked_frame(what, make, ref_path):
            """make() -> (renderer, scene, frame size): the frame's first
            render uploads the atlas; the counted one runs with the counts
            set to 0 just before; its kernels against their plain versions
            on its own inputs; its blocks against the stored ones."""
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
            check_blocks(what, frame, ref_path)
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

        # --- the 1080p photo wall of the loaded image ---
        w, h = PHOTO_WALL_SIZE
        size = vec2(w, h)
        ren = FigRenderer(atlas_size=256, device="cuda")
        wall_bus = resources.ImageMessageBus()
        ren.ensure_image_message_subscription(wall_bus)
        refs.append(resources.load_image(path, bus=wall_bus))
        scene = make_loaded_photo_wall(w, h, PHOTO_WALL_PANELS, refs[-1].id)
        ren.render_frame(scene, size)
        torch.cuda.synchronize()
        plan = plan_execution(ren.flatten(scene, size))
        if not plan.mega_atlas:
            fail("photo wall: the planner did not send it to the megakernel with the atlas")
        perf._global_perf.clear()
        zero_counts()
        wall_ms = timed_frames("photo wall", lambda: ren.render_frame(scene, size),
                               (h, w, 4))
        spans = span_means(perf._global_perf.entries)
        perf._global_perf.clear()
        counted_launches("photo wall", scaled_launches(frame_launches(plan), FRAMES))
        if set(spans) != {"frame", "messages", "flatten", "execute"}:
            fail(f"photo wall: render_frame recorded the spans {sorted(spans)}")
        runs, undo = recorded_frames(ren)
        ren.render_frame(scene, size)
        undo()
        wall_calls = []
        plan_kernel_checks("photo wall", *runs[0], calls=wall_calls)
        sw, sh, sn = PHOTO_WALL_SMALL
        small = FigRenderer(atlas_size=256, device="cuda")
        small_bus = resources.ImageMessageBus()
        small.ensure_image_message_subscription(small_bus)
        refs.append(resources.load_image(path, bus=small_bus))
        small_scene = make_loaded_photo_wall(sw, sh, sn, refs[-1].id)
        checked_frame(f"photo wall {sw}x{sh}", lambda: (small, small_scene, vec2(sw, sh)),
                      PHOTO_WALL_REFERENCE)
        host, device = [], []
        for _ in range(FRAMES):
            t0 = time.perf_counter()
            ren.process_image_messages()
            step = ren._walk_plan(scene, size, True, Color(1.0, 1.0, 1.0, 1.0))
            t1 = time.perf_counter()
            ren.execute_plan(step)
            torch.cuda.synchronize()
            host.append((t1 - t0) * 1e3)
            device.append((time.perf_counter() - t1) * 1e3)
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
    wall_args, wall_kw = wall_calls[0]
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
          f"warm {warm_ms:.3f} ms {tag}", flush=True)
    print(f"times: photo wall {w}x{h}, {PHOTO_WALL_PANELS} panels of the loaded "
          f"image, {len(plan.structure)} pass items, atlas {ren.atlas.size}: median "
          f"{med(wall_ms):.3f} ms/frame (render_frame + sync) = host (messages, walk, "
          f"plan) {med(host):.3f} ms + upload, executor and sync {med(device):.3f} ms; "
          f"perf spans, mean ms over {FRAMES} frames: " + ", ".join(
              f"{k} {spans[k]:.3f}" for k in ("frame", "messages", "flatten", "execute"))
          + f" {tag}", flush=True)
    print(f"times: K1-atlas on the MSDF star's draw {k1a['ms']:.4f} ms (events), "
          f"{k1a['device_ms']:.4f} ms alone, plain torch {k1a['plain_ms']:.2f} ms, "
          f"{bound_text(k1a['work'])}; K4-atlas on the photo wall {k4a['ms']:.4f} ms "
          f"(events), {k4a['device_ms']:.4f} ms alone, plain torch "
          f"{k4a['plain_ms']:.2f} ms, {bound_text(k4a['work'])} {tag}", flush=True)
    print(f"image files phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(census=census, k1a=k1a, k4a=k4a)


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
    if sys.argv[1:] == ["turns"]:
        turns_phase(tag)
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
    k3_paths = {"rectmask": rm["launches"][1], "rolled": rolled["launches"][2],
                **tree_paths["K3"], **loop_paths["K3"]}
    k4_paths = {"subclip": sc["launches"][2], **tree_paths["K4"], **loop_paths["K4"]}
    k4a_paths = {"clipped cards": cards["launches"][4], "text table": table["launches"][4],
                 "text table host": host["table_launches"][4],
                 **{f"text tree {f}": v["launches"][4] for f, v in host["tree"].items()},
                 **loop_paths["K4-atlas"]}
    loop_err = lambda name: FRAMELOOP_ERRS.get(name, 0.0)
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
                                  loop_err("K1-atlas"), host["err"]]),
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
                                host["table_err"]]
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
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
