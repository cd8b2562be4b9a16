// Tile rasterizer for NVIDIA Hopper (sm_90a): ordered compositing of
// binned quads into a channel-planar RGBA frame (K1, and K1-atlas when the
// pass samples the glyph/image atlas) or into one mask plane (K3).
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
// What bounds it on this card: arithmetic, not bytes. A 1080p frame is
// 35 MB of planes read and written once per pass, about 20 us of HBM time,
// while every pixel evaluates some 20 quads of SDF math (rounded and
// elliptical boxes, gaussians, the bezier cubic solve) on the SM's FP32 and
// SFU pipes. The design keeps that work on the pixels that need it:
//   * one thread per pixel, 16x16-pixel blocks: a pixel's blend chain is
//     independent of its neighbours', so nothing crosses threads but the
//     quad records;
//   * every block walks the list of the tile that contains it, so all its
//     threads evaluate the same quad at the same time and each mode branch
//     is uniform across the block: only the SDF family the quad uses runs;
//   * quad records are staged through shared memory in chunks of 32 rows
//     and read from there as broadcasts;
//   * the carry stays in registers and the frame is read and written once.
// The TPU blocking rules are dropped: no VMEM chunking of the tape, no
// (T, 1, N) reshape of the tile lists, no scalar prefetch (a block loads its
// own segment bounds).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sdf.cuh"

namespace {

constexpr int BLOCK = 16;  // pixels per block edge
constexpr int THREADS = BLOCK * BLOCK;
constexpr int CHUNK = 32;  // quad rows staged per shared-memory fill

// first position of the ascending list[0, count) holding a value >= value
__device__ int lower_bound(const int* list, int count, int value) {
  int lo = 0, hi = count;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (list[mid] < value)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// MASK_TARGET: `frame` and `out` are one mask plane (K3), else the four
// RGBA planes (K1). HAS_ATLAS: atlas-mode quads sample `atlas`; without it
// the atlas branch is compiled out, so SDF-only passes pay nothing for it.
template <bool MASK_TARGET, bool HAS_ATLAS>
__global__ void __launch_bounds__(THREADS)
raster_tiles_kernel(const float* __restrict__ fields,
                    const int* __restrict__ modes,
                    const int* __restrict__ tile_idx,
                    const int* __restrict__ tile_counts,
                    const int* __restrict__ bounds,
                    const float* __restrict__ frame,
                    const float* __restrict__ masks,
                    const float* __restrict__ backdrop,
                    const float4* __restrict__ atlas,
                    float* __restrict__ out, int n_quads, int tiles_x,
                    int tile_h, int tile_w, int ph, int pw, int atlas_size,
                    bool pixelate, bool subpixel) {
  __shared__ float s_fields[CHUNK * figdraw::QF_WIDTH];
  __shared__ int s_modes[CHUNK * 2];
  __shared__ int s_seg[2];

  const int tid = threadIdx.y * BLOCK + threadIdx.x;
  const int x = blockIdx.x * BLOCK + threadIdx.x;
  const int y = blockIdx.y * BLOCK + threadIdx.y;
  const int tile = (blockIdx.y * BLOCK / tile_h) * tiles_x +
                   (blockIdx.x * BLOCK / tile_w);
  const int* list = tile_idx + (size_t)tile * n_quads;
  if (tid == 0) {
    const int count = tile_counts[tile];
    s_seg[0] = lower_bound(list, count, bounds[0]);
    s_seg[1] = lower_bound(list, count, bounds[1]);
  }
  __syncthreads();
  const int j_lo = s_seg[0];
  const int j_hi = s_seg[1];

  const size_t plane = (size_t)ph * pw;
  const size_t pix = (size_t)y * pw + x;
  float r = frame[pix];  // the mask value m when MASK_TARGET
  float g = 0.0f, b = 0.0f, a = 0.0f;
  if (!MASK_TARGET) {
    g = frame[plane + pix];
    b = frame[2 * plane + pix];
    a = frame[3 * plane + pix];
  }
  // pixel centers: (tile origin + index) + 0.5, exact in f32
  const float px = (float)x + 0.5f;
  const float py = (float)y + 0.5f;
  float bd[4];
  if (!MASK_TARGET && backdrop != nullptr) {
    for (int ch = 0; ch < 4; ++ch) bd[ch] = backdrop[ch * plane + pix];
  }

  for (int base = j_lo; base < j_hi; base += CHUNK) {
    const int nq = min(CHUNK, j_hi - base);
    __syncthreads();  // the previous chunk is consumed
    for (int k = tid; k < nq * figdraw::QF_WIDTH; k += THREADS) {
      const int q = k / figdraw::QF_WIDTH;
      const int c = k - q * figdraw::QF_WIDTH;
      s_fields[k] = fields[(size_t)list[base + q] * figdraw::QF_WIDTH + c];
    }
    if (tid < nq * 2) s_modes[tid] = modes[(size_t)list[base + tid / 2] * 2 + tid % 2];
    __syncthreads();
    for (int q = 0; q < nq; ++q) {
      float frag[4];
      figdraw::eval_quad(s_fields + q * figdraw::QF_WIDTH, s_modes[2 * q], px,
                         py, !MASK_TARGET && backdrop != nullptr ? bd : nullptr,
                         frag, HAS_ATLAS ? atlas : nullptr, atlas_size,
                         pixelate, subpixel);
      const float fa = frag[3] * masks[(size_t)s_modes[2 * q + 1] * plane + pix];
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
  }
  out[pix] = r;
  if (!MASK_TARGET) {
    out[plane + pix] = g;
    out[2 * plane + pix] = b;
    out[3 * plane + pix] = a;
  }
}

}  // namespace

// C entry points (bound with ctypes by ops/raster.py). Shapes: fields
// (n_quads, 68) f32, modes (n_quads, 2) i32, tile_idx (T, n_quads) i32,
// tile_counts (T,) i32, bounds (2,) i32, masks (K, ph, pw) f32, atlas
// (atlas_size, atlas_size, 4) f32 or null. ph is a multiple of tile_h, pw of
// tile_w, and both tile edges of 16. Each launches on `stream` and returns
// cudaGetLastError() as an int.

template <bool MASK_TARGET>
static int launch(const float* fields, const int* modes, const int* tile_idx,
                  const int* tile_counts, const int* bounds,
                  const float* target, const float* masks,
                  const float* backdrop, const float* atlas, float* out,
                  int n_quads, int tiles_x, int tile_h, int tile_w, int ph,
                  int pw, int atlas_size, int pixelate, int subpixel,
                  void* stream) {
  const dim3 block(BLOCK, BLOCK);
  const dim3 grid(pw / BLOCK, ph / BLOCK);
  const float4* atlas4 = reinterpret_cast<const float4*>(atlas);
  if (atlas != nullptr)
    raster_tiles_kernel<MASK_TARGET, true><<<grid, block, 0, (cudaStream_t)stream>>>(
        fields, modes, tile_idx, tile_counts, bounds, target, masks, backdrop,
        atlas4, out, n_quads, tiles_x, tile_h, tile_w, ph, pw, atlas_size,
        pixelate != 0, subpixel != 0);
  else
    raster_tiles_kernel<MASK_TARGET, false><<<grid, block, 0, (cudaStream_t)stream>>>(
        fields, modes, tile_idx, tile_counts, bounds, target, masks, backdrop,
        nullptr, out, n_quads, tiles_x, tile_h, tile_w, ph, pw, 0, false,
        false);
  return (int)cudaGetLastError();
}

// K1 / K1-atlas: frame/out/backdrop (4, ph, pw) f32; backdrop may be null.
extern "C" int figdraw_raster_frame(const float* fields, const int* modes,
                                    const int* tile_idx,
                                    const int* tile_counts, const int* bounds,
                                    const float* frame, const float* masks,
                                    const float* backdrop, const float* atlas,
                                    float* out, int n_quads, int tiles_x,
                                    int tile_h, int tile_w, int ph, int pw,
                                    int atlas_size, int pixelate, int subpixel,
                                    void* stream) {
  return launch<false>(fields, modes, tile_idx, tile_counts, bounds, frame,
                       masks, backdrop, atlas, out, n_quads, tiles_x, tile_h,
                       tile_w, ph, pw, atlas_size, pixelate, subpixel, stream);
}

// K3: target/out (1, ph, pw) f32, the mask plane being written.
extern "C" int figdraw_raster_mask(const float* fields, const int* modes,
                                   const int* tile_idx, const int* tile_counts,
                                   const int* bounds, const float* target,
                                   const float* masks, const float* atlas,
                                   float* out, int n_quads, int tiles_x,
                                   int tile_h, int tile_w, int ph, int pw,
                                   int atlas_size, int pixelate, int subpixel,
                                   void* stream) {
  return launch<true>(fields, modes, tile_idx, tile_counts, bounds, target,
                      masks, nullptr, atlas, out, n_quads, tiles_x, tile_h,
                      tile_w, ph, pw, atlas_size, pixelate, subpixel, stream);
}
