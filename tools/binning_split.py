"""The phase split of the earlier tile-binning kernel (csrc/binning.cu
before the front end's redesign: bin_prep_kernel, then bin_tiles_kernel's
backward walk, counting pass and writing pass), on the card.

    python3 tools/binning_split.py CHECKOUT

CHECKOUT is an unpacked commit of that design (`git archive <commit> | tar
-x -C _scratch/parent`). Its binning.cu is copied, given a `stop` argument
that ends the tile kernel after the walk (1) or after the counting pass
(2), built with nvcc, and called on the executor's own binning call of
bench_camera's scene at 300 and 12000 boxes (1920x1080, a view's tape).
Prints each kernel's device ms a launch by torch.profiler for the whole
kernel and each stop, and the card's name and power limit. Measurement
only: the stopped variants write no lists."""

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STOPS = {1: "after the walk", 2: "after the counting pass", 0: "whole"}


def patched_source(src: str) -> str:
    """The earlier binning.cu with the tile kernel's `stop` argument."""
    reps = [
        ("int* __restrict__ tile_counts) {", "int* __restrict__ tile_counts, int stop) {"),
        ("    __syncthreads();\n  }\n\n  // counting pass",
         "    __syncthreads();\n  }\n  if (stop == 1) return;\n\n  // counting pass"),
        ("  if (tid == 0) tile_counts[t] = total;\n",
         "  if (tid == 0) tile_counts[t] = total;\n  if (stop == 2) return;\n"),
        ("int* tile_idx, int* tile_counts, void* stream) {",
         "int* tile_idx, int* tile_counts, void* stream, int stop) {"),
    ]
    for old, new in reps:
        if old not in src:
            raise SystemExit(f"not the earlier binning.cu: {old!r} not found")
        src = src.replace(old, new)
    return src.replace("tile_w, tile_idx, tile_counts);", "tile_w, tile_idx, tile_counts, stop);")


def main() -> None:
    checkout = os.path.abspath(sys.argv[1])
    sys.path.insert(0, checkout)
    sys.path.append(REPO)
    import torch

    import chip_smoke as cs
    from figdraw_tpu_torch import FigRenderer, executor, vec2
    from figdraw_tpu_torch.ops import binning, nvcc
    from figdraw_tpu_torch.scenes import make_render_tree_array

    print(cs.card_line(), flush=True)
    tmp = tempfile.mkdtemp()
    src = os.path.join(tmp, "binning.cu")
    with open(os.path.join(checkout, "figdraw_tpu_torch", "csrc", "binning.cu")) as fh:
        text = patched_source(fh.read())
    with open(src, "w") as fh:
        fh.write(text)
    lib_path = os.path.join(tmp, "libsplit.so")
    res = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", lib_path, src],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(res.stdout + res.stderr)
    lib = ctypes.CDLL(lib_path)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.figdraw_bin_quads.argtypes = [vp] * 4 + [i, i, vp] + [i] * 8 + [vp] * 4 + [i]
    lib.figdraw_bin_quads.restype = i
    size = vec2(1920, 1080)
    for copies in (100, 4000):
        ren = FigRenderer(device="cuda")
        snap = ren.snapshot_scene(make_render_tree_array(1920, 1080, 0, copies=copies), size)
        ren.render_view(snap, (1.0, 0.0))
        a, k = cs.recorded(executor, "bin_quads", lambda: ren.render_view(snap, (21.0, 7.0)))[0]
        fields, start, end, tiles_y, tiles_x, th, tw = a
        modes, runs = k.get("modes"), k.get("run_bounds")
        n, n_tiles = fields.shape[0], tiles_y * tiles_x
        dev = fields.device
        tile_idx = torch.empty((n_tiles, n), dtype=torch.int32, device=dev)
        counts = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
        scratch = torch.empty((10 * n,), dtype=torch.float32, device=dev)
        runs32 = None if runs is None else runs.to(torch.int32).contiguous()
        ptr = lambda t: None if t is None else t.data_ptr()

        def call(stop):
            rc = lib.figdraw_bin_quads(
                fields.data_ptr(), ptr(modes), None, None, int(start), int(end),
                ptr(runs32), 0 if runs32 is None else runs32.shape[0],
                int(modes is not None and runs is None), n, n_tiles, tiles_x, th, tw,
                int(modes is not None and n >= binning.SAT_MIN_QUADS), scratch.data_ptr(),
                tile_idx.data_ptr(), counts.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream, stop)
            if rc:
                raise SystemExit(f"launch failed: {rc}")

        parts = {stop: cs.kernels_alone(lambda: call(stop),
                                        ("bin_prep_kernel", "bin_tiles_kernel"))
                 for stop in STOPS}
        print(f"{copies * 3} boxes, (T, N) = ({n_tiles}, {n}), tile_h {th}: prepass "
              f"{parts[0]['bin_prep_kernel']:.4f} ms; tile kernel "
              + ", ".join(f"{what} {parts[stop]['bin_tiles_kernel']:.4f} ms"
                          for stop, what in STOPS.items())
              + f" (torch.profiler, a launch) {cs.card_line()}", flush=True)
    shutil.rmtree(tmp)


if __name__ == "__main__":
    main()
