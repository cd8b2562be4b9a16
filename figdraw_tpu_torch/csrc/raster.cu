// Tile rasterizer for NVIDIA Hopper (sm_90a): ordered compositing of
// binned quads into a channel-planar RGBA frame (K1, and K1-atlas when the
// pass samples the glyph/image atlas) or into one mask plane (K3), in place.
//
// Replaces figdraw_tpu/ops/raster_pallas.py `_kernel` (:156, pallas_call at
// :344) in its frame-target form, as reached through
// draw_pass_planar_prebinned (:431), and in its mask-target form (:196-212),
// as reached through draw_pass_mask_prebinned (:454): for every 128-column
// tile, find the run's [start, end) segment of the tile's ascending binned
// quad list (`_lower_bound`, :136), evaluate each quad of it at every pixel
// center in draw order, multiply by the quad's mask plane and blend
//   frame: rgb = f * fa + dst * (1 - fa),  a = fa + a * (1 - fa);
//   mask:  m = fa * fa + m * (1 - fa)  (glsl/mask.frag through the GL blend).
// Mode-17 quads sample the backdrop planes (frame target only).
//
// Band origin: `row0`, the global row of the target's row 0 (the TPU
// kernel's seg_ref[2], :161-184; nonzero when the target is one row band of
// a frame split over several devices, parallel/sharding.py). Pixel centers
// and the per-block cull are global, (row0 + y) + 0.5; the target, the
// masks and the backdrop are indexed by the band's own rows.
//
// K1-atlas replaces the same call's `has_atlas` form (raster_pallas.py:305,
// :325-329; `atlas_eval`, quad_eval_planar.py:271-329), which samples a
// VMEM-resident atlas only for 1:1 axis-aligned mode-0 quads through a
// (th+8, tw+128) window and lane rolls, and sends every other atlas quad to
// an XLA gather path (quad_eval.py:287-335). On Hopper a gather is an
// ordinary load, so K1-atlas is one general sampler: modes 0 and 13-16, any
// uv map, bilinear or nearest, through four 16-byte __ldg loads per pixel
// from the (S, S, 4) atlas, which sits in L2 (1-4 MB) for the whole pass. S
// is a launch argument (the atlas doubles when it overflows).
//
// What bounds it on this card. The work the pass needs is the SDF math of
// each quad at the pixels of its bbox (FP32 and SFU pipes; no matrix product,
// so the tensor cores have nothing to do) and the bytes of the pixels it
// changes. An earlier design had every 16x16 block walk its whole tile
// segment and read and write its whole target out of place: a quad that
// touches 2 of a tile's 64 blocks cost a loop step in all 64, and a pass that
// draws one small card still moved the whole frame (71 MB for K1-atlas and
// 18 MB for K3 at 1080p). The design:
//   * one thread per pixel, 16x16-pixel blocks: a pixel's blend chain is
//     serial and independent of its neighbours', so nothing crosses threads
//     but the quad records;
//   * in place: the target is read and written only by blocks that
//     composite something, each pixel by its own thread, once; a block whose
//     segment is empty, or whose quads all miss it, returns untouched;
//   * exact per-block culling: each staged quad whose bbox, widened by
//     CULL_MARGIN, misses the block's pixel centers is dropped before the
//     pixel loop. eval_quad is exactly 0 outside the quad's polygon (the
//     reference's `inside` guard), a zero fragment leaves the carry
//     bit-identical (x * 0 + r * 1), and the polygon lies inside its bbox up
//     to the bbox's float rounding and the 1e-6 uv guard, which the margin
//     covers (a bbox the walk clamped to its mask plane's support covers the
//     pixels where that plane is non-zero). The survivors keep their draw
//     order: one warp tests a chunk of 32 list entries, __ballot_sync marks
//     the survivors and each takes the slot __popc of the lower lanes gives;
//   * asynchronous staging: the survivors' 272-byte rows go to shared memory
//     with cp.async (17 x 16 B), double buffered, so the next chunk's bbox
//     test (16 B per quad straight from global memory) and copy run while the
//     block evaluates the current one; a warp finds the segment bounds with a
//     32-way search (one load per lane and round) instead of a serial one;
//   * each mode branch stays uniform across the block (one quad at a time),
//     and the mask plane is read only where the fragment has alpha and the
//     quad reads a plane other than 0 (the all-ones plane: fa * 1 == fa).
// The TPU blocking rules are dropped: no VMEM chunking of the tape, no
// (T, 1, N) reshape of the tile lists, no scalar prefetch (a block loads its
// own segment bounds).
//
// Aliasing: K3's target is one plane of `masks`, and a quad may read that
// plane. A thread reads masks[mi][pix] only inside its quad loop and writes
// its pixel once after it, so every read sees the value from before the
// pass. No pointer that may alias the target is __restrict__.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cull.cuh"
#include "sdf.cuh"

namespace {

using figdraw::CHUNK;
using figdraw::FULL;
using figdraw::Stage;
using figdraw::cp_async_wait_all;
using figdraw::stage_chunk;

constexpr int BLOCK = 16;  // pixels per block edge
constexpr int THREADS = BLOCK * BLOCK;
constexpr int WARPS = THREADS / 32;

// first position of the ascending list[0, count) holding a value >= value,
// found by one warp (every lane returns it): each round probes 32 positions
// spread over the candidates [lo, hi) and keeps the gap the answer lies in
__device__ int warp_lower_bound(const int* list, int count, int value,
                                int lane) {
  int lo = 0, hi = count;
  while (hi - lo > 32) {
    const int p = lo + (int)(((long long)lane * (hi - lo)) >> 5);
    const int c = __popc(__ballot_sync(FULL, list[p] < value));
    if (c == 0) return lo;  // list[lo] >= value
    const int p_last = __shfl_sync(FULL, p, c - 1);
    const int p_next = __shfl_sync(FULL, p, c & 31);
    lo = p_last + 1;
    if (c < 32) hi = p_next;
  }
  const int p = lo + lane;
  return lo + __popc(__ballot_sync(FULL, p < hi && list[p] < value));
}

// MASK_TARGET: `target` is one mask plane (K3), else the four RGBA planes
// (K1). HAS_ATLAS: atlas-mode quads sample `atlas`; without it the atlas
// branch is compiled out, so SDF-only passes pay nothing for it.
template <bool MASK_TARGET, bool HAS_ATLAS>
__global__ void __launch_bounds__(THREADS)
raster_tiles_kernel(const float* __restrict__ fields,
                    const int* __restrict__ modes,
                    const int* __restrict__ tile_idx,
                    const int* __restrict__ tile_counts,
                    const int* __restrict__ bounds, float* target,
                    const float* masks, const float* backdrop,
                    const float4* __restrict__ atlas, int n_quads,
                    int tiles_x, int tile_h, int tile_w, int ph, int pw,
                    int row0, int atlas_size, bool pixelate, bool subpixel) {
  __shared__ Stage s_stage[2];
  __shared__ int s_seg[2];

  const int tid = threadIdx.y * BLOCK + threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bx0 = blockIdx.x * BLOCK;
  const int by0 = blockIdx.y * BLOCK;
  const int tile = (by0 / tile_h) * tiles_x + bx0 / tile_w;
  const int* list = tile_idx + (size_t)tile * n_quads;
  if (warp < 2) {
    const int at = warp == 0 ? bounds[0] : bounds[1];
    const int j = warp_lower_bound(list, tile_counts[tile], at, lane);
    if (lane == 0) s_seg[warp] = j;
  }
  __syncthreads();
  const int j_lo = s_seg[0];
  const int j_hi = s_seg[1];
  if (j_lo >= j_hi) return;  // nothing of the run in this tile

  // the block's pixel centers: (global origin + index) + 0.5, exact in f32
  const float cx0 = (float)bx0 + 0.5f, cx1 = (float)bx0 + 15.5f;
  const float cy0 = (float)(row0 + by0) + 0.5f, cy1 = (float)(row0 + by0) + 15.5f;
  const int n_chunks = (j_hi - j_lo + CHUNK - 1) / CHUNK;
  if (warp == 0) {
    stage_chunk(s_stage[0], fields, modes, list, j_lo, min(CHUNK, j_hi - j_lo),
                cx0, cx1, cy0, cy1, lane);
    cp_async_wait_all();
  }
  __syncthreads();

  const int x = bx0 + threadIdx.x;
  const int y = by0 + threadIdx.y;
  const size_t plane = (size_t)ph * pw;
  const size_t pix = (size_t)y * pw + x;
  const float px = (float)x + 0.5f;
  const float py = (float)(row0 + y) + 0.5f;
  bool loaded = false;  // uniform: the block composited something
  float r = 0.0f, g = 0.0f, b = 0.0f, a = 0.0f;  // r: the mask value m in K3

  for (int c = 0; c < n_chunks; ++c) {
    const Stage& st = s_stage[c & 1];
    // the next chunk's test and copies, by a warp that takes turns, into the
    // buffer the block finished reading before the last barrier
    const int next = j_lo + (c + 1) * CHUNK;
    const bool stager = next < j_hi && warp == (c + 1) % WARPS;
    if (stager)
      stage_chunk(s_stage[(c + 1) & 1], fields, modes, list, next,
                  min(CHUNK, j_hi - next), cx0, cx1, cy0, cy1, lane);
    const int nq = st.count;
    if (nq > 0 && !loaded) {
      loaded = true;
      r = target[pix];
      if (!MASK_TARGET) {
        g = target[plane + pix];
        b = target[2 * plane + pix];
        a = target[3 * plane + pix];
      }
    }
    for (int q = 0; q < nq; ++q) {
      const int mode_packed = st.modes[2 * q];
      const int mi = st.modes[2 * q + 1];
      float bd[4];
      const float* bdp = nullptr;
      if (!MASK_TARGET && backdrop != nullptr) {
        const int rest = mode_packed % 256;
        if ((rest >= 128 ? rest - 128 : rest) == figdraw::MODE_BACKDROP_BLUR) {
          for (int ch = 0; ch < 4; ++ch) bd[ch] = backdrop[ch * plane + pix];
          bdp = bd;
        }
      }
      float frag[4];
      figdraw::eval_quad(st.fields + q * figdraw::QF_WIDTH, mode_packed, px,
                         py, bdp, frag, HAS_ATLAS ? atlas : nullptr,
                         atlas_size, pixelate, subpixel);
      float fa = frag[3];
      if (fa != 0.0f && mi != 0) fa *= masks[(size_t)mi * plane + pix];
      const float inv = 1.0f - fa;
      if (MASK_TARGET) {
        r = fa * fa + r * inv;
        continue;
      }
      r = frag[0] * fa + r * inv;
      g = frag[1] * fa + g * inv;
      b = frag[2] * fa + b * inv;
      a = fa + a * inv;
    }
    if (stager) cp_async_wait_all();
    __syncthreads();  // the next buffer is filled; this one is consumed
  }
  if (!loaded) return;  // every quad of the segment missed this block
  target[pix] = r;
  if (!MASK_TARGET) {
    target[plane + pix] = g;
    target[2 * plane + pix] = b;
    target[3 * plane + pix] = a;
  }
}

}  // namespace

// C entry points (bound with ctypes by ops/raster.py). Shapes: fields
// (n_quads, 68) f32 (16-byte aligned), modes (n_quads, 2) i32 (8-byte
// aligned), tile_idx (T, n_quads) i32, tile_counts (T,) i32, bounds (2,)
// i32, masks (K, ph, pw) f32 with masks[0] all ones, atlas (atlas_size,
// atlas_size, 4) f32 or null. ph is a multiple of tile_h, pw of tile_w, and
// both tile edges of 16; row0 is the global row of the target's row 0 (0
// for a whole frame). The target is updated in place. Each launches on
// `stream` and returns cudaGetLastError() as an int.

template <bool MASK_TARGET>
static int launch(const float* fields, const int* modes, const int* tile_idx,
                  const int* tile_counts, const int* bounds, float* target,
                  const float* masks, const float* backdrop,
                  const float* atlas, int n_quads, int tiles_x, int tile_h,
                  int tile_w, int ph, int pw, int row0, int atlas_size,
                  int pixelate, int subpixel, void* stream) {
  const dim3 block(BLOCK, BLOCK);
  const dim3 grid(pw / BLOCK, ph / BLOCK);
  const float4* atlas4 = reinterpret_cast<const float4*>(atlas);
  if (atlas != nullptr)
    raster_tiles_kernel<MASK_TARGET, true><<<grid, block, 0, (cudaStream_t)stream>>>(
        fields, modes, tile_idx, tile_counts, bounds, target, masks, backdrop,
        atlas4, n_quads, tiles_x, tile_h, tile_w, ph, pw, row0, atlas_size,
        pixelate != 0, subpixel != 0);
  else
    raster_tiles_kernel<MASK_TARGET, false><<<grid, block, 0, (cudaStream_t)stream>>>(
        fields, modes, tile_idx, tile_counts, bounds, target, masks, backdrop,
        nullptr, n_quads, tiles_x, tile_h, tile_w, ph, pw, row0, 0, false,
        false);
  return (int)cudaGetLastError();
}

// K1 / K1-atlas: frame/backdrop (4, ph, pw) f32; backdrop may be null.
extern "C" int figdraw_raster_frame(const float* fields, const int* modes,
                                    const int* tile_idx,
                                    const int* tile_counts, const int* bounds,
                                    float* frame, const float* masks,
                                    const float* backdrop, const float* atlas,
                                    int n_quads, int tiles_x, int tile_h,
                                    int tile_w, int ph, int pw, int row0,
                                    int atlas_size, int pixelate, int subpixel,
                                    void* stream) {
  return launch<false>(fields, modes, tile_idx, tile_counts, bounds, frame,
                       masks, backdrop, atlas, n_quads, tiles_x, tile_h,
                       tile_w, ph, pw, row0, atlas_size, pixelate, subpixel,
                       stream);
}

// K3: target (1, ph, pw) f32, the mask plane being written; it may be one of
// the planes of `masks`.
extern "C" int figdraw_raster_mask(const float* fields, const int* modes,
                                   const int* tile_idx, const int* tile_counts,
                                   const int* bounds, float* target,
                                   const float* masks, const float* atlas,
                                   int n_quads, int tiles_x, int tile_h,
                                   int tile_w, int ph, int pw, int row0,
                                   int atlas_size, int pixelate, int subpixel,
                                   void* stream) {
  return launch<true>(fields, modes, tile_idx, tile_counts, bounds, target,
                      masks, nullptr, atlas, n_quads, tiles_x, tile_h, tile_w,
                      ph, pw, row0, atlas_size, pixelate, subpixel, stream);
}
