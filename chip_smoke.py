#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (figdraw_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the native walk (g++) and the raster kernel (nvcc) from the checkout,
holds the kernel against its plain torch version on the headline tape and on
a scene of every SDF mode, renders the 1080p 300-box headline scene through
FigRenderer(device="cuda").render_frame, checks the frames, and prints times
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

WIDTH, HEIGHT, COPIES = 1920, 1080, 100
FRAMES = 20
TOL = 1.0 / 255.0  # kernel vs plain version, and port vs the JAX reference
# figdraw_tpu's render of the 384x216 headline scene, frame 0, as 8x8 block
# means (tests/test_torch_render_frame.py pins it against the JAX package)
REF_BLOCKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "figdraw_tpu_torch", "reference",
                          "headline_384x216_f0_blocks8.npy")


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
    from figdraw_tpu_torch.ops import raster
    from figdraw_tpu_torch.ops.binning import bin_quads
    from figdraw_tpu_torch.ops.blur import backdrop_blur_planar
    from figdraw_tpu_torch.ops.layout import QF_RECT_PARAMS, QI_MODE
    from figdraw_tpu_torch.plan import plan_execution
    from figdraw_tpu_torch.scenes import make_render_tree_array, modes_tape

    dev = torch.device("cuda", 0)

    # --- 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    native.load()
    t1 = time.perf_counter()
    raster.load()
    t2 = time.perf_counter()
    print(f"build: walk (g++) {t1 - t0:.2f} s, raster kernel (nvcc) "
          f"{t2 - t1:.2f} s {tag}", flush=True)
    for line in raster.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
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
    raster.LAUNCHES = 0
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
    if launches != 2 * FRAMES:
        fail(f"raster kernel launched {launches} times in {FRAMES} frames, "
             f"expected {2 * FRAMES}")
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

    # --- 6. results --------------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "raster_frame_kernel",
        "route": "cuda",
        "source": "figdraw_tpu_torch/csrc/raster.cu",
        "replaces": "figdraw_tpu/ops/raster_pallas.py:156",
        "launches": launches,
        "max_abs_err": max(err_headline, err_modes, err_frame),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
