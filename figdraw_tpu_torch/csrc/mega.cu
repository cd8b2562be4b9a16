// Megakernel for NVIDIA Hopper (sm_90a): a whole clip-masked frame in one
// tile walk, with the mask planes kept on chip, in place (K4, and K4-atlas
// when the tape holds atlas quads).
//
// Replaces figdraw_tpu/ops/raster_pallas.py `_mega_kernel` (:495,
// pallas_call at :635), as reached through draw_pass_mega (:643), in both
// its forms: `has_atlas=False` (K4) and `has_atlas=True` (K4-atlas, :496-499,
// :567-572, :622-624). The host bakes each quad's target and the mask clears
// into the mode lane (plan.pack_mega_combo, or the walk's
// fd_export_mega_packed):
//   bits 0-11  SDF mode (+ bit 13, the TPU kernel's 1:1 atlas flag, which
//              the evaluator ignores)
//   bit    12  clear sentinel: zero plane tgt - 1
//   bits 16+   tgt = target + 1 (0 = the frame, k + 1 = mask plane k)
// Every pixel sees the entries of its tile's binned list in tape order.
// Plane 0 starts at 1 (the all-pass parent), the others at 0, per frame. A
// draw multiplies its alpha by plane mask_i, then blends into the frame
// (tgt == 0) or writes plane tgt - 1 with m = fa * fa + m * (1 - fa). The
// JAX kernel's clamps are kept exactly: reads clamp the plane to [0, K-1],
// writes to [1, K-1], and with K == 1 every write (and every clear) is
// dropped.
//
// The TPU kernel samples the atlas only for 1:1 axis-aligned mode-0 quads,
// through a (th+8, tw+128) VMEM window and lane rolls, and the JAX package
// keeps every other atlas scene off it. On Hopper a gather is an ordinary
// load: K4-atlas is the sampler of sdf.cuh as K1-atlas and K3 use it (modes
// 0 and 13-16, any uv map, bilinear or nearest, four 16-byte __ldg taps from
// the (S, S, 4) atlas in L2), a template flag that SDF tapes compile out.
//
// What bounds it on this card: the SDF arithmetic of each quad at the
// pixels of its bbox and the bytes of the blocks the tape touches; the frame
// is read and written once, however many masks the scene uses. The design:
//   * one thread per pixel, and each thread's K mask values live in dynamic
//     shared memory at [k * THREADS + tid]: the plane index is data, so a
//     register array would be dynamically indexed and spill to local
//     memory (the TPU kernel's lax.switch over K registers has no
//     counterpart). K planes cost K KB per 256-thread block; MAX_PLANES
//     keeps the block under the 227 KB opt-in beside the staging buffers. No
//     thread reads another's mask values, so the planes need no barrier;
//   * exact per-block culling with asynchronous staging, as in raster.cu
//     (cull.cuh): an entry whose bbox, widened by CULL_MARGIN, misses the
//     block's pixel centers is dropped before the pixel loop, and the
//     survivors' rows arrive by cp.async in a double buffer, one barrier a
//     chunk. Clear sentinels are entries like any other: a sentinel's bbox is
//     the union of the bboxes of the quads that read or write its plane
//     before the plane's next clear, so a block it misses keeps none of those
//     quads either and never observes the plane. A culled frame draw leaves
//     x * 0 + r * 1, a culled mask write 0 * 0 + m * 1. The one entry that is
//     never culled targets plane 0 (tgt == 1): the write clamp sends it to
//     plane 1 with plane 0 as its source, which sets plane 1 outside its
//     bbox too (the host packers emit none; the clamp semantics hold for
//     any tape);
//   * in place: a block that keeps no entry touches nothing, not even its
//     planes in shared memory; the frame is read at the first chunk that
//     keeps an entry and written once after the walk, each pixel by its own
//     thread;
//   * every branch on the mode lane is uniform across the block.
//
// Band origin: `row0`, the global row of the frame's row 0 (the TPU
// kernel's seg_ref[0], :505; nonzero when the frame is one row band of a
// frame split over several devices, parallel/sharding.py). Pixel centers
// and the per-block cull are global, (row0 + y) + 0.5; the planes are
// indexed by the band's own rows. An entry that targets plane 0 is kept in
// every block of every band.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "cull.cuh"
#include "sdf.cuh"

namespace {

using figdraw::CHUNK;
using figdraw::Stage;
using figdraw::cp_async_wait_all;
using figdraw::stage_chunk;  // <true>: entries that target plane 0 stay

constexpr int BLOCK = 16;  // pixels per block edge
constexpr int THREADS = BLOCK * BLOCK;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_PLANES = 200;  // ops/mega.py MAX_PLANES
constexpr int MEGA_CLEAR_BIT = 1 << 12;
constexpr int MEGA_TARGET_SHIFT = 16;
constexpr int MEGA_EVAL_MASK = 0x2FFF;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// HAS_ATLAS: atlas-mode quads sample `atlas` (K4-atlas); without it the
// atlas branch is compiled out and they evaluate as SDF boxes (K4).
template <bool HAS_ATLAS>
__global__ void __launch_bounds__(THREADS)
mega_kernel(const float* __restrict__ fields, const int* __restrict__ modes,
            const int* __restrict__ tile_idx,
            const int* __restrict__ tile_counts, float* frame,
            const float4* __restrict__ atlas, int n_quads, int tiles_x,
            int tile_h, int tile_w, int ph, int pw, int row0, int n_masks,
            int atlas_size, bool pixelate, bool subpixel) {
  extern __shared__ float s_masks[];  // [n_masks * THREADS]
  __shared__ Stage s_stage[2];

  const int tid = threadIdx.y * BLOCK + threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bx0 = blockIdx.x * BLOCK;
  const int by0 = blockIdx.y * BLOCK;
  const int tile = (by0 / tile_h) * tiles_x + bx0 / tile_w;
  const int* list = tile_idx + (size_t)tile * n_quads;
  const int count = tile_counts[tile];
  if (count == 0) return;  // nothing of the tape in this tile

  // the block's pixel centers: (global origin + index) + 0.5, exact in f32
  const float cx0 = (float)bx0 + 0.5f, cx1 = (float)bx0 + 15.5f;
  const float cy0 = (float)(row0 + by0) + 0.5f, cy1 = (float)(row0 + by0) + 15.5f;
  const int n_chunks = (count + CHUNK - 1) / CHUNK;
  if (warp == 0) {
    stage_chunk<true>(s_stage[0], fields, modes, list, 0, min(CHUNK, count),
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
  const int kmax = n_masks - 1;
  bool loaded = false;  // uniform: the block kept an entry
  float r = 0.0f, g = 0.0f, b = 0.0f, a = 0.0f;

  for (int c = 0; c < n_chunks; ++c) {
    const Stage& st = s_stage[c & 1];
    // the next chunk's test and copies, by a warp that takes turns, into the
    // buffer the block finished reading before the last barrier
    const int next = (c + 1) * CHUNK;
    const bool stager = next < count && warp == (c + 1) % WARPS;
    if (stager)
      stage_chunk<true>(s_stage[(c + 1) & 1], fields, modes, list, next,
                        min(CHUNK, count - next), cx0, cx1, cy0, cy1, lane);
    const int nq = st.count;
    if (nq > 0 && !loaded) {
      loaded = true;
      r = frame[pix];
      g = frame[plane + pix];
      b = frame[2 * plane + pix];
      a = frame[3 * plane + pix];
      s_masks[tid] = 1.0f;
      for (int k = 1; k < n_masks; ++k) s_masks[k * THREADS + tid] = 0.0f;
    }
    for (int q = 0; q < nq; ++q) {
      const int raw = st.modes[2 * q];
      // logical shift: the target field is unsigned
      const int tgt = (int)((unsigned)raw >> MEGA_TARGET_SHIFT);
      if (raw & MEGA_CLEAR_BIT) {
        if (kmax > 0) s_masks[clampi(tgt - 1, 1, kmax) * THREADS + tid] = 0.0f;
        continue;
      }
      float frag[4];
      figdraw::eval_quad(st.fields + q * figdraw::QF_WIDTH,
                         raw & MEGA_EVAL_MASK, px, py, nullptr, frag,
                         HAS_ATLAS ? atlas : nullptr, atlas_size, pixelate,
                         subpixel);
      const int read = clampi(st.modes[2 * q + 1], 0, kmax);
      const float fa = frag[3] * s_masks[read * THREADS + tid];
      const float inv = 1.0f - fa;
      if (tgt == 0) {
        r = frag[0] * fa + r * inv;
        g = frag[1] * fa + g * inv;
        b = frag[2] * fa + b * inv;
        a = fa + a * inv;
      } else if (kmax > 0) {
        const float cur = s_masks[clampi(tgt - 1, 0, kmax) * THREADS + tid];
        s_masks[clampi(tgt - 1, 1, kmax) * THREADS + tid] = fa * fa + cur * inv;
      }
    }
    if (stager) cp_async_wait_all();
    __syncthreads();  // the next buffer is filled; this one is consumed
  }
  if (!loaded) return;  // every entry of the tile missed this block
  frame[pix] = r;
  frame[plane + pix] = g;
  frame[2 * plane + pix] = b;
  frame[3 * plane + pix] = a;
}

// Dynamic shared memory past 48 KB is an opt-in attribute of each kernel on
// each device. It is set once per device, for MAX_PLANES planes and both
// forms, at the first launch there; every launch then asks only for its own
// K planes.
constexpr int MAX_DEVICES = 64;
std::atomic<bool> g_smem_opted_in[MAX_DEVICES];

cudaError_t opt_in_smem() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < MAX_DEVICES;
  if (cached && g_smem_opted_in[dev].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  const int bytes = MAX_PLANES * THREADS * (int)sizeof(float);
  err = cudaFuncSetAttribute(mega_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mega_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err == cudaSuccess && cached) {
    g_smem_opted_in[dev].store(true, std::memory_order_release);
  }
  return err;
}

}  // namespace

// C entry point (bound with ctypes by ops/mega.py). Shapes: fields
// (n_quads, 68) f32 (16-byte aligned), modes (n_quads, 2) i32 (8-byte
// aligned) with target-baked mode lanes, tile_idx (T, n_quads) i32,
// tile_counts (T,) i32, frame (4, ph, pw) f32, updated in place, atlas
// (atlas_size, atlas_size, 4) f32 or null (K4-atlas with it, K4 without);
// 1 <= n_masks <= MAX_PLANES. ph is a multiple of tile_h, pw of tile_w, and
// both tile edges of 16; row0 is the global row of the frame's row 0 (0 for
// a whole frame). Launches on `stream` and returns cudaGetLastError()
// as an int (cudaErrorInvalidValue for n_masks out of range).
extern "C" int figdraw_mega(const float* fields, const int* modes,
                            const int* tile_idx, const int* tile_counts,
                            float* frame, const float* atlas, int n_quads,
                            int tiles_x, int tile_h, int tile_w, int ph, int pw,
                            int row0, int n_masks, int atlas_size, int pixelate,
                            int subpixel, void* stream) {
  if (n_masks < 1 || n_masks > MAX_PLANES) return (int)cudaErrorInvalidValue;
  const cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)n_masks * THREADS * sizeof(float);
  const dim3 block(BLOCK, BLOCK);
  const dim3 grid(pw / BLOCK, ph / BLOCK);
  if (atlas != nullptr)
    mega_kernel<true><<<grid, block, smem, (cudaStream_t)stream>>>(
        fields, modes, tile_idx, tile_counts, frame,
        reinterpret_cast<const float4*>(atlas), n_quads, tiles_x, tile_h,
        tile_w, ph, pw, row0, n_masks, atlas_size, pixelate != 0,
        subpixel != 0);
  else
    mega_kernel<false><<<grid, block, smem, (cudaStream_t)stream>>>(
        fields, modes, tile_idx, tile_counts, frame, nullptr, n_quads, tiles_x,
        tile_h, tile_w, ph, pw, row0, n_masks, 0, false, false);
  return (int)cudaGetLastError();
}
