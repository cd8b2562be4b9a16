// Megakernel for NVIDIA Hopper (sm_90a): a whole clip-masked frame in one
// tile walk, with the mask planes kept on chip (K4).
//
// Replaces figdraw_tpu/ops/raster_pallas.py `_mega_kernel` (:495,
// pallas_call at :635), as reached through draw_pass_mega (:643). The host
// bakes each quad's target and the mask clears into the mode lane
// (plan.pack_mega_modes, or the walk's fd_export_mega_packed):
//   bits 0-11  SDF mode (+ bit 13, the atlas 1:1 flag, passed to the eval)
//   bit    12  clear sentinel: zero plane tgt - 1
//   bits 16+   tgt = target + 1 (0 = the frame, k + 1 = mask plane k)
// Every 16x16-pixel block walks the whole binned list of the tile that
// contains it, in tape order. Plane 0 starts at 1 (the all-pass parent),
// the others at 0, per tile and per frame. A draw multiplies its alpha by
// plane mask_i, then blends into the frame (tgt == 0) or writes plane
// tgt - 1 with m = fa * fa + m * (1 - fa). The JAX kernel's clamps are kept
// exactly: reads clamp the plane to [0, K-1], writes to [1, K-1], and with
// K == 1 every write (and every clear) is dropped.
//
// What bounds it on this card: per-pixel SDF arithmetic, as in raster.cu;
// the frame is read and written once, however many masks the scene uses.
// The design:
//   * one thread per pixel, and each thread's K mask values live in dynamic
//     shared memory at [k * THREADS + tid]: the plane index is data, so a
//     register array would be dynamically indexed and spill to local
//     memory (the TPU kernel's lax.switch over K registers has no
//     counterpart). K planes cost K KB per 256-thread block; MAX_PLANES
//     keeps the block under the 227 KB opt-in;
//   * no thread reads another's mask values, so the planes need no
//     barrier; quad records are staged through shared memory in chunks of
//     32 rows as in raster.cu, and every branch on the mode lane is uniform
//     across the block.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sdf.cuh"

namespace {

constexpr int BLOCK = 16;  // pixels per block edge
constexpr int THREADS = BLOCK * BLOCK;
constexpr int CHUNK = 32;  // quad rows staged per shared-memory fill
constexpr int MAX_PLANES = 200;  // ops/mega.py MAX_PLANES
constexpr int MEGA_CLEAR_BIT = 1 << 12;
constexpr int MEGA_TARGET_SHIFT = 16;
constexpr int MEGA_EVAL_MASK = 0x2FFF;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(THREADS)
mega_kernel(const float* __restrict__ fields, const int* __restrict__ modes,
            const int* __restrict__ tile_idx,
            const int* __restrict__ tile_counts,
            const float* __restrict__ frame, float* __restrict__ out,
            int n_quads, int tiles_x, int tile_h, int tile_w, int ph, int pw,
            int n_masks) {
  extern __shared__ float s_masks[];  // [n_masks * THREADS]
  __shared__ float s_fields[CHUNK * figdraw::QF_WIDTH];
  __shared__ int s_modes[CHUNK * 2];

  const int tid = threadIdx.y * BLOCK + threadIdx.x;
  const int x = blockIdx.x * BLOCK + threadIdx.x;
  const int y = blockIdx.y * BLOCK + threadIdx.y;
  const int tile = (blockIdx.y * BLOCK / tile_h) * tiles_x +
                   (blockIdx.x * BLOCK / tile_w);
  const int* list = tile_idx + (size_t)tile * n_quads;
  const int count = tile_counts[tile];

  s_masks[tid] = 1.0f;
  for (int k = 1; k < n_masks; ++k) s_masks[k * THREADS + tid] = 0.0f;

  const size_t plane = (size_t)ph * pw;
  const size_t pix = (size_t)y * pw + x;
  float r = frame[pix];
  float g = frame[plane + pix];
  float b = frame[2 * plane + pix];
  float a = frame[3 * plane + pix];
  // pixel centers: (tile origin + index) + 0.5, exact in f32
  const float px = (float)x + 0.5f;
  const float py = (float)y + 0.5f;
  const int kmax = n_masks - 1;

  for (int base = 0; base < count; base += CHUNK) {
    const int nq = min(CHUNK, count - base);
    __syncthreads();  // the previous chunk is consumed
    for (int k = tid; k < nq * figdraw::QF_WIDTH; k += THREADS) {
      const int q = k / figdraw::QF_WIDTH;
      const int c = k - q * figdraw::QF_WIDTH;
      s_fields[k] = fields[(size_t)list[base + q] * figdraw::QF_WIDTH + c];
    }
    if (tid < nq * 2) s_modes[tid] = modes[(size_t)list[base + tid / 2] * 2 + tid % 2];
    __syncthreads();
    for (int q = 0; q < nq; ++q) {
      const int raw = s_modes[2 * q];
      // logical shift: the target field is unsigned
      const int tgt = (int)((unsigned)raw >> MEGA_TARGET_SHIFT);
      if (raw & MEGA_CLEAR_BIT) {
        if (kmax > 0) s_masks[clampi(tgt - 1, 1, kmax) * THREADS + tid] = 0.0f;
        continue;
      }
      float frag[4];
      figdraw::eval_quad(s_fields + q * figdraw::QF_WIDTH, raw & MEGA_EVAL_MASK,
                         px, py, nullptr, frag);
      const int read = clampi(s_modes[2 * q + 1], 0, kmax);
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
  }
  out[pix] = r;
  out[plane + pix] = g;
  out[2 * plane + pix] = b;
  out[3 * plane + pix] = a;
}

// Dynamic shared memory past 48 KB is an opt-in attribute of the kernel on
// each device. It is set once per device, for MAX_PLANES planes, at the first
// launch there; every launch then asks only for its own K planes.
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
  err = cudaFuncSetAttribute(mega_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_PLANES * THREADS * (int)sizeof(float));
  if (err == cudaSuccess && cached) {
    g_smem_opted_in[dev].store(true, std::memory_order_release);
  }
  return err;
}

}  // namespace

// C entry point (bound with ctypes by ops/mega.py). Shapes: fields
// (n_quads, 68) f32, modes (n_quads, 2) i32 with target-baked mode lanes,
// tile_idx (T, n_quads) i32, tile_counts (T,) i32, frame/out (4, ph, pw)
// f32; 1 <= n_masks <= MAX_PLANES. ph is a multiple of tile_h, pw of
// tile_w, and both tile edges of 16. Launches on `stream` and returns
// cudaGetLastError() as an int (cudaErrorInvalidValue for n_masks out of
// range).
extern "C" int figdraw_mega(const float* fields, const int* modes,
                            const int* tile_idx, const int* tile_counts,
                            const float* frame, float* out, int n_quads,
                            int tiles_x, int tile_h, int tile_w, int ph, int pw,
                            int n_masks, void* stream) {
  if (n_masks < 1 || n_masks > MAX_PLANES) return (int)cudaErrorInvalidValue;
  const cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)n_masks * THREADS * sizeof(float);
  const dim3 block(BLOCK, BLOCK);
  const dim3 grid(pw / BLOCK, ph / BLOCK);
  mega_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      fields, modes, tile_idx, tile_counts, frame, out, n_quads, tiles_x,
      tile_h, tile_w, ph, pw, n_masks);
  return (int)cudaGetLastError();
}
