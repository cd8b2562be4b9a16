#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (figdraw_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the native walk (g++) and the CUDA kernels (nvcc, one process per
source, all at once) from the checkout. Two paths run through
FigRenderer(device="cuda").render_frame:

- the 1080p 300-box headline scene (bench.py): the tile rasterizer K1,
  held against its plain torch version on the headline tape and on a scene
  of every SDF mode;
- the clip-mask table of bench_clipmask.py (1200x800, 180 rows x 6 cells):
  the rect-mask table on the frame executor (K1 twice and the mask-plane
  pass K3 once per frame) and the sub-clip table on the megakernel (K4 once
  per frame), each kernel held against its plain version on the frame's
  own inputs.

It checks the frames and the launch counts of each path and prints times
beside the card's name and power limit. The last line is the run's summary
JSON; any failure exits non-zero before it.
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
    h, w, c = frame.shape
    return frame.reshape(h // k, k, w // k, k, c).mean(axis=(1, 3))


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
    from figdraw_tpu_torch.executor import (
        get_frame_executor, get_mega_executor, unpack_combo,
    )
    from figdraw_tpu_torch.ops import mega, raster
    from figdraw_tpu_torch.ops.binning import bin_quads
    from figdraw_tpu_torch.plan import plan_execution, tile_h_from_density
    from figdraw_tpu_torch.scenes import make_clip_table_scene

    size = vec2(TABLE_W, TABLE_H)
    scene = make_clip_table_scene(kind, TABLE_W, TABLE_H, TABLE_ROWS, TABLE_COLS)
    ren = FigRenderer(device="cuda")
    ren.render_frame(scene, size)  # the first frame builds the executor
    torch.cuda.synchronize()
    total_ms = []
    raster.LAUNCHES = raster.MASK_LAUNCHES = mega.LAUNCHES = 0
    for f in range(FRAMES):
        t0 = time.perf_counter()
        frame = ren.render_frame(scene, size)
        torch.cuda.synchronize()
        total_ms.append((time.perf_counter() - t0) * 1e3)
        if tuple(frame.shape) != (TABLE_H, TABLE_W, 4):
            fail(f"{kind} frame {f} has shape {tuple(frame.shape)}")
        if not bool(torch.isfinite(frame).all()):
            fail(f"{kind} frame {f} holds non-finite values")
    counts = (raster.LAUNCHES, raster.MASK_LAUNCHES, mega.LAUNCHES)
    want = (2 * FRAMES, FRAMES, 0) if kind == "rectmask" else (0, 0, FRAMES)
    print(f"check 6: {kind} table {TABLE_ROWS}x{TABLE_COLS} at {TABLE_W}x{TABLE_H}, "
          f"{FRAMES} frames finite; launches K1 {counts[0]}, K3 {counts[1]}, "
          f"K4 {counts[2]} (expected {want})", flush=True)
    if counts != want:
        fail(f"{kind} table launched (K1, K3, K4) {counts}, expected {want}")
    walk_ms = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        native.flatten_fast(scene, TABLE_W, TABLE_H, 1.0, 1.0, ren.aa_factor,
                            (1.0, 1.0, 1.0, 1.0))
        walk_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"times: {kind} table: median {statistics.median(total_ms):.3f} ms/frame "
          f"(render_frame + sync; host walk and export alone "
          f"{statistics.median(walk_ms):.3f} ms) {tag}", flush=True)

    out = {"launches": counts, "ms_per_frame": statistics.median(total_ms)}

    def compared(fn, plain, errs, store):
        def call(*args, **kw):
            got = fn(*args, **kw)
            ref = plain(*args, **kw)
            torch.cuda.synchronize()
            if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(ref).all())):
                fail(f"{kind}: non-finite planes from {fn.__name__}")
            errs.append(float((got - ref).abs().max()))
            store.append((args, kw))
            return got
        return call

    if kind == "rectmask":
        tape = ren.flatten(scene, size)
        plan = plan_execution(tape)
        run = get_frame_executor(plan.structure, plan.height, plan.width,
                                 plan.n_masks, plan.has_init_frame, plan.tile_h)
        combo = torch.from_numpy(plan.combo).to(dev, copy=True)
        e1, e3, a1, a3 = [], [], [], []
        run(combo, None,
            draw=compared(raster.draw_pass_planar_prebinned,
                          raster.draw_pass_planar_prebinned_plain, e1, a1),
            draw_mask=compared(raster.draw_pass_mask_prebinned,
                               raster.draw_pass_mask_prebinned_plain, e3, a3))
        ref = run(combo, None, draw=raster.draw_pass_planar_prebinned_plain,
                  draw_mask=raster.draw_pass_mask_prebinned_plain)
        if (len(e1), len(e3)) != (2, 1):
            fail(f"the rect-mask plan ran {len(e1)} frame and {len(e3)} mask "
                 "passes, expected 2 and 1")
        out.update(k1_err=max(e1), k3_err=e3[0], k1_args=a1,
                   k3_args=a3[0][0] + (a3[0][1]["tile_h"],))
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
                                       mega.draw_pass_mega_plain, e4, a4))
        ref = run(combo, None, draw=mega.draw_pass_mega_plain)
        out.update(k4_err=e4[0], k4_args=a4[0][0] + (a4[0][1]["tile_h"],))
        print(f"check 6: sub-clip mega combo {tuple(combo_np.shape)}, "
              f"{mask_count + 1} mask planes, tile_h {th}; K4 vs plain max "
              f"|diff| {e4[0]:.3e} (tol {TOL:.3e})", flush=True)
        if not e4[0] <= TOL:
            fail(f"sub-clip table: K4 differs from its plain version by {e4[0]}")
    # the executor's stages on the frame's own inputs (device, CUDA events)
    fields, modes = (out["k1_args"][0][0] if kind == "rectmask" else out["k4_args"])[:2]
    n = fields.shape[0]
    th = out["k3_args"][-1] if kind == "rectmask" else out["k4_args"][-1]
    rows = combo.shape[0] - n
    if kind == "rectmask":
        rb = torch.stack([a[2] for a, _k in out["k1_args"]])
        binning = lambda: bin_quads(fields, 0, n, -(-TABLE_H // th), -(-TABLE_W // 128),
                                    th, 128, modes=modes, run_bounds=rb)
    else:
        binning = lambda: bin_quads(fields, 0, n, -(-TABLE_H // th), -(-TABLE_W // 128),
                                    th, 128)
    stages = {
        "unpack": cuda_ms(lambda: unpack_combo(combo[:-rows]), 20),
        "binning": cuda_ms(binning, 20),
        "whole executor": cuda_ms(lambda: run(combo, None), 20),
    }
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


def main() -> None:
    import numpy as np
    import torch

    # --- 1. device ---------------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    tag = f"[{card}]"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from figdraw_tpu_torch import FigRenderer, vec2
    from figdraw_tpu_torch import native
    from figdraw_tpu_torch.executor import get_frame_executor, unpack_combo
    from figdraw_tpu_torch.ops import mega, raster
    from figdraw_tpu_torch.ops.binning import bin_quads
    from figdraw_tpu_torch.ops.blur import backdrop_blur_planar
    from figdraw_tpu_torch.ops.layout import QF_RECT_PARAMS, QI_MODE
    from figdraw_tpu_torch.plan import plan_execution
    from figdraw_tpu_torch.scenes import make_render_tree_array, modes_tape

    dev = torch.device("cuda", 0)

    # --- 2. build: the walk and each kernel source at once ------------------------
    def timed(fn):
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        builds = {name: pool.submit(timed, fn) for name, fn in (
            ("walk (g++)", native.load), ("raster.cu (nvcc)", raster.load),
            ("mega.cu (nvcc)", mega.load))}
        secs = {name: f.result() for name, f in builds.items()}
    print("build: " + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
          + f"; {time.perf_counter() - t0:.2f} s in all {tag}", flush=True)
    for log in (raster.BUILD_LOG, mega.BUILD_LOG):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    ren = FigRenderer(device="cuda")
    size = vec2(WIDTH, HEIGHT)
    plain = raster.draw_pass_planar_prebinned_plain

    # --- 3a. kernel vs plain on both draw runs of the headline tape ---------------
    draw_args = []  # (args, kwargs) of each headline draw, for the timings

    def compare_draw(*args, **kw):
        out = raster.draw_pass_planar_prebinned(*args, **kw)
        ref = plain(*args, **kw)
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
            fields, modes, bounds, tile_idx, tile_counts, planes, masks,
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
    raster.LAUNCHES = raster.MASK_LAUNCHES = mega.LAUNCHES = 0
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
    if (launches, raster.MASK_LAUNCHES, mega.LAUNCHES) != (2 * FRAMES, 0, 0):
        fail(f"{FRAMES} headline frames launched K1 {launches}, K3 "
             f"{raster.MASK_LAUNCHES}, K4 {mega.LAUNCHES} times, expected "
             f"{2 * FRAMES}, 0, 0")
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
    print(f"times: headline draw runs (both): kernel {kernel_ms:.4f} ms, plain "
          f"torch {plain_ms:.2f} ms {tag}", flush=True)
    for i, (a, k, _e) in enumerate(draw_args):
        ms = cuda_ms(lambda: raster.draw_pass_planar_prebinned(*a, **k), 20)
        print(f"times: headline draw run {i}: kernel {ms:.4f} ms {tag}", flush=True)
    # the executor's stages on the frame-0 headline tape, with its own inputs
    fields, modes, _b, tile_idx, _c, planes = draw_args[0][0][:6]
    th = draw_args[0][1]["tile_h"]
    n = fields.shape[0]
    run_bounds = torch.stack([a[2] for a, _k, _e in draw_args])
    ms_unpack = cuda_ms(lambda: unpack_combo(combo[:n]), 20)
    ms_bin = cuda_ms(lambda: bin_quads(
        fields, 0, n, planes.shape[1] // th, planes.shape[2] // 128, th, 128,
        modes=modes, run_bounds=run_bounds), 20)
    ms_blur = cuda_ms(lambda: backdrop_blur_planar(draw_args[1][0][5], plan.radii[0]), 20)
    ms_exec = cuda_ms(lambda: run(combo, None), 20)
    print(f"times: executor stages: unpack {ms_unpack:.4f} ms, binning "
          f"{ms_bin:.4f} ms, blur {ms_blur:.4f} ms, whole executor {ms_exec:.4f} ms "
          f"(device, CUDA events) {tag}", flush=True)

    # --- 6. the clip-mask tables (bench_clipmask.py) ------------------------------
    tables = {kind: clip_table_phase(kind, tag, dev) for kind in ("rectmask", "subclip")}
    rm, sc = tables["rectmask"], tables["subclip"]
    t0 = time.perf_counter()
    kernel_ms_k3 = cuda_ms(lambda: raster.draw_pass_mask_prebinned(*rm["k3_args"]), 20)
    plain_ms_k3 = cuda_ms(lambda: raster.draw_pass_mask_prebinned_plain(*rm["k3_args"]), 3)
    kernel_ms_k4 = cuda_ms(lambda: mega.draw_pass_mega(*sc["k4_args"]), 20)
    plain_ms_k4 = cuda_ms(lambda: mega.draw_pass_mega_plain(*sc["k4_args"]), 3)
    print(f"times: K3 on the rect-mask table's mask run: kernel {kernel_ms_k3:.4f} "
          f"ms, plain torch {plain_ms_k3:.2f} ms {tag}", flush=True)
    print(f"times: K4 on the sub-clip table: kernel {kernel_ms_k4:.4f} ms, plain "
          f"torch {plain_ms_k4:.2f} ms ({time.perf_counter() - t0:.1f} s) {tag}",
          flush=True)
    k1_table_ms = cuda_ms(lambda: [raster.draw_pass_planar_prebinned(*a, **k)
                                   for a, k in rm["k1_args"]], 20)
    print(f"times: K1 on the rect-mask table's two frame runs: kernel "
          f"{k1_table_ms:.4f} ms {tag}", flush=True)

    # --- 7. results --------------------------------------------------------------
    print(json.dumps({"kernels": [
        {
            "name": "raster_tiles_kernel<false> (K1, frame target)",
            "route": "cuda",
            "source": "figdraw_tpu_torch/csrc/raster.cu",
            "replaces": "figdraw_tpu/ops/raster_pallas.py:156",
            "launches": launches + rm["launches"][0],
            "launches_by_path": {"headline": launches,
                                 "rectmask": rm["launches"][0]},
            "max_abs_err": max(err_headline, err_modes, err_frame, rm["k1_err"]),
            "ms": kernel_ms,
            "plain_ms": plain_ms,
        },
        {
            "name": "raster_tiles_kernel<true> (K3, mask target)",
            "route": "cuda",
            "source": "figdraw_tpu_torch/csrc/raster.cu",
            "replaces": "figdraw_tpu/ops/raster_pallas.py:196",
            "launches": rm["launches"][1],
            "launches_by_path": {"rectmask": rm["launches"][1]},
            "max_abs_err": max(rm["k3_err"], rm["frame_err"]),
            "ms": kernel_ms_k3,
            "plain_ms": plain_ms_k3,
        },
        {
            "name": "mega_kernel (K4)",
            "route": "cuda",
            "source": "figdraw_tpu_torch/csrc/mega.cu",
            "replaces": "figdraw_tpu/ops/raster_pallas.py:495",
            "launches": sc["launches"][2],
            "launches_by_path": {"subclip": sc["launches"][2]},
            "max_abs_err": max(sc["k4_err"], sc["frame_err"]),
            "ms": kernel_ms_k4,
            "plain_ms": plain_ms_k4,
        },
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
