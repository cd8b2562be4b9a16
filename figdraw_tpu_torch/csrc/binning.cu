// Tile binning for NVIDIA Hopper (sm_90a): per-tile, draw-ordered lists of
// the quads whose bbox meets each tile, with the occlusion and saturation
// culls of the frame's draw runs.
//
// Replaces figdraw_tpu/ops/binning.py `bin_quads` (:35), which the JAX
// package leaves to XLA (no Pallas): a (T, N) intersection mask, the cover
// tests, a whole-row suffix sum of log2 transmittance and one argsort per
// tile row. In plain torch the same function is ~30 kernels, and ~500 with
// the saturation tier and its loop over the runs.
//
// What it computes, for each tile t (ops/binning.bin_quads_plain):
//   1. the quads i in [start, end) whose bbox overlaps the tile;
//   2. with modes, the culls of each run r (the window itself when no runs
//      are given): a quad of r below the last opaque cover of r in the tile
//      is dropped, and with saturation (N >= SAT_MIN_QUADS) so is a quad
//      whose within-run stack of translucent covers above it sums to a log2
//      transmittance under LOG2_SAT_EPS. Quads outside every run are never
//      dropped;
//   3. the kept quads in draw order, then every other index ascending, as
//      the whole (T, N) permutation, and the count kept.
//
// What bounds it on this card: bytes. The output alone is T x N x 4 bytes
// (66.8 MB at N = 32769, T = 510: 0.020 ms at 3.35 TB/s), and every tile
// must test every quad of the window. The design:
//   * a prepass, one thread a quad, reads each 272-byte row once and writes
//     what the tiles need as packed arrays: the bbox (16 B), and with modes
//     the cover rectangle (16 B, NaN for a quad that can never cover) and
//     the log2 transmittance with the opaque flag (8 B). The tiles then read
//     16 contiguous bytes a quad, a warp 512 B at a time;
//   * one block a tile. The culls reduce to one lower bound per tile and
//     run: the above-stack only falls as i goes back through a run (every
//     term is <= 0), so the kept quads of run r are i >= lo_r, with lo_r the
//     last opaque cover or one past the last saturated quad, whichever is
//     later. The block finds them by walking the run's chunks from its end
//     backwards, a block max for the cover and a reverse block scan with a
//     carry for the stack, and stops at the first chunk that settles them:
//     in a covered tile most of the run is never read;
//   * compaction in order with no sort: one pass writes each warp's kept
//     bits (a ballot a word) to shared memory and counts them, a block scan
//     of the warps' counts gives each warp its base, and a second pass over
//     the bits writes kept quad i to prefix(i) and any other to
//     count + (i - prefix(i)), the plain argsort's permutation. Each warp
//     owns a contiguous run of words, so the two passes need two barriers in
//     all.
//
// Exactness: the lists and counts are integers and equal the plain
// version's. The cover test is float, so the prepass rounds each step once
// in the plain version's order (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn): an FMA contraction would move a cover across a tile edge.
// The saturation sum cannot be bit-equal (another summation order, log2f
// against torch.log2), so a quad whose within-run above-stack lies within
// rounding of LOG2_SAT_EPS may fall on either side; the checks
// (ops/binning.bin_quads_model's borderline mask) count such quads and leave
// them out.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 512;  // one block a tile
constexpr int WARPS = THREADS / 32;
constexpr int PREP_THREADS = 256;
constexpr int UNROLL = 4;  // words a warp has in flight in the counting pass
constexpr int MAX_RUNS = 64;  // ops/binning.py MAX_RUNS
constexpr int MAX_QUADS = 1 << 20;  // ops/binning.py MAX_QUADS: kept bits in shared memory
constexpr float LOG2_SAT_EPS = -11.0f;
constexpr unsigned FULL = 0xffffffffu;

// ops/layout.py
constexpr int QF_WIDTH = 68;
constexpr int QF_INV_B = 1;
constexpr int QF_INV_C = 2;
constexpr int QF_BBOX_X0 = 6;
constexpr int QF_COLOR0 = 16;
constexpr int QF_MID_COLOR = 32;
constexpr int QF_STOP_COLOR = 36;
constexpr int QF_PARAMS = 40;
constexpr int QF_RADII = 44;
constexpr int QF_AA = 50;
constexpr int QF_RECT_PARAMS = 52;
constexpr int QI_MODE = 0;
constexpr int QI_MASK = 1;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// torch.minimum and torch.clamp: a NaN operand gives NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? nan_f() : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? nan_f() : fmaxf(a, b);
}

// Per quad: the bbox and, with modes (CULL), the cover rectangle
// (cx - ihx, cx + ihx, cy - ihy, cy + ihy), NaN for a quad that cannot
// cover, and (lt, opaque): lt = log2(max(1 - a_min, 2^-24)), 0 for a quad
// that cannot cover, opaque = a_min >= 1 (bin_quads_plain :65-132).
template <bool CULL>
__global__ void __launch_bounds__(PREP_THREADS)
bin_prep_kernel(const float* __restrict__ fields, const int* __restrict__ modes,
                int n, float4* __restrict__ box, float4* __restrict__ cov,
                float2* __restrict__ lto) {
  const int i = blockIdx.x * PREP_THREADS + threadIdx.x;
  if (i >= n) return;
  const float* f = fields + (size_t)i * QF_WIDTH;
  const float x0 = f[QF_BBOX_X0], y0 = f[QF_BBOX_X0 + 1];
  const float x1 = f[QF_BBOX_X0 + 2], y1 = f[QF_BBOX_X0 + 3];
  box[i] = make_float4(x0, y0, x1, y1);
  if (!CULL) return;

  const int m = modes[2 * i + QI_MODE];
  const int rest = m & 255;      // torch.remainder(m, 256)
  const int fill_mode = m >> 8;  // floor division by 256
  float a_min = min_nan(min_nan(f[QF_COLOR0 + 3], f[QF_COLOR0 + 7]),
                        min_nan(f[QF_COLOR0 + 11], f[QF_COLOR0 + 15]));
  if (fill_mode != 0)
    a_min = min_nan(a_min, min_nan(f[QF_MID_COLOR + 3], f[QF_STOP_COLOR + 3]));
  const float hx = f[QF_PARAMS + 2], hy = f[QF_PARAMS + 3];
  const bool elliptical = rest >= 128;
  // elliptical corners carry 12+12-bit packed (x, y) radii; negative is a
  // circular radius -v-1. A NaN radius fails radii_ok, so the maxima need
  // not propagate NaN.
  float max_r = 0.0f, rx_max = 0.0f, ry_max = 0.0f;
  bool circ_ok = true, ell_ok = true;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    const float r = f[QF_RADII + k];
    const float circ = __fsub_rn(-r, 1.0f);
    const float pk = r >= 8388608.0f ? r : floorf(__fadd_rn(r, 0.5f));
    const float rx = r < 0.0f ? circ
                              : __fdiv_rn(__fmul_rn(fmodf(pk, 4096.0f), hx), 4095.0f);
    const float ry = r < 0.0f ? circ
                              : __fdiv_rn(__fmul_rn(floorf(__fdiv_rn(pk, 4096.0f)), hy),
                                          4095.0f);
    max_r = k == 0 ? r : fmaxf(max_r, r);
    rx_max = k == 0 ? rx : fmaxf(rx_max, rx);
    ry_max = k == 0 ? ry : fmaxf(ry_max, ry);
    circ_ok = circ_ok && r >= 0.0f;
    ell_ok = ell_ok && rx >= 0.0f && ry >= 0.0f;
  }
  const float inset_x = elliptical ? rx_max : max_r;
  const float inset_y = elliptical ? ry_max : max_r;
  const float margin = __fadd_rn(__fdiv_rn(0.5f, max_nan(f[QF_AA], 1e-3f)), 0.01f);
  const float ihx = __fsub_rn(__fsub_rn(hx, inset_x), margin);
  const float ihy = __fsub_rn(__fsub_rn(hy, inset_y), margin);
  const bool coverer = (rest & 127) == 3 && modes[2 * i + QI_MASK] == 0 &&
                       f[QF_INV_B] == 0.0f && f[QF_INV_C] == 0.0f &&
                       f[QF_RECT_PARAMS + 2] < 0.0f &&
                       (elliptical ? ell_ok : circ_ok) && ihx > 0.0f && ihy > 0.0f;
  if (coverer) {
    // axis-aligned: the bbox center is the shape center
    const float cx = __fmul_rn(__fadd_rn(x0, x1), 0.5f);
    const float cy = __fmul_rn(__fadd_rn(y0, y1), 0.5f);
    cov[i] = make_float4(__fsub_rn(cx, ihx), __fadd_rn(cx, ihx), __fsub_rn(cy, ihy),
                         __fadd_rn(cy, ihy));
    lto[i] = make_float2(log2f(max_nan(__fsub_rn(1.0f, a_min), 0x1p-24f)),
                         a_min >= 1.0f ? 1.0f : 0.0f);
  } else {
    cov[i] = make_float4(nan_f(), nan_f(), nan_f(), nan_f());
    lto[i] = make_float2(0.0f, 0.0f);
  }
}

// One block a tile. CULL: modes were given (runs, or the window as one run);
// SATURATE: the saturation tier (N >= SAT_MIN_QUADS).
template <bool CULL, bool SATURATE>
__global__ void __launch_bounds__(THREADS, 2)
bin_tiles_kernel(const float4* __restrict__ box, const float4* __restrict__ cov,
                 const float2* __restrict__ lto, const int* __restrict__ start_p,
                 const int* __restrict__ end_p, int start_v, int end_v,
                 const int* __restrict__ runs, int n_runs, int n, int tiles_x,
                 int tile_h, int tile_w, int* __restrict__ tile_idx,
                 int* __restrict__ tile_counts) {
  extern __shared__ unsigned s_bits[];  // one kept bit a quad
  __shared__ int s_lo[MAX_RUNS], s_hi[MAX_RUNS], s_cover[MAX_RUNS], s_satlo[MAX_RUNS];
  __shared__ int s_wmax[2][WARPS], s_wsat[2][WARPS], s_wcount[WARPS];
  __shared__ float s_wsum[2][WARPS];

  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int start = start_p != nullptr ? *start_p : start_v;
  const int end = end_p != nullptr ? *end_p : end_v;
  const int w_lo = max(start, 0), w_hi = min(end, n);  // the window within the rows
  // tile t covers pixel centers [t0 + 0.5, t0 + tile - 0.5]; every value
  // here is a whole number or a half, exact in float
  const float tx0 = (float)(t % tiles_x) * (float)tile_w;
  const float ty0 = (float)(t / tiles_x) * (float)tile_h;
  const float tx1 = tx0 + (float)tile_w, ty1 = ty0 + (float)tile_h;

  if (CULL) {
    const float cx_lo = tx0 + 0.5f, cx_hi = tx1 - 0.5f;
    const float cy_lo = ty0 + 0.5f, cy_hi = ty1 - 0.5f;
    int parity = 0;
    for (int r = 0; r < n_runs; r++) {
      const int lo = runs != nullptr ? max(runs[2 * r], w_lo) : w_lo;
      const int hi = runs != nullptr ? min(runs[2 * r + 1], w_hi) : w_hi;
      int cover = -1, satcut = -1;
      float carry = 0.0f;  // the stack of the chunks already walked
      for (int c_hi = hi; c_hi > lo; c_hi -= THREADS) {
        const int c_lo = max(lo, c_hi - THREADS);
        const int i = c_lo + tid;
        const bool in = i < c_hi;
        int opaque_at = -1;
        float lt = 0.0f;
        if (in) {
          const float4 c = cov[i];
          if (c.x <= cx_lo && c.y >= cx_hi && c.z <= cy_lo && c.w >= cy_hi) {
            const float2 l = lto[i];
            lt = l.x;
            if (l.y != 0.0f) opaque_at = i;
          }
        }
        // suffix sums within the warp: v = sum of lt over lanes >= lane
        float v = lt;
        if (SATURATE) {
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const float u = __shfl_down_sync(FULL, v, d);
            if (lane + d < 32) v += u;
          }
        }
        const int wmax = __reduce_max_sync(FULL, opaque_at);
        if (lane == 0) {
          s_wmax[parity][warp] = wmax;
          s_wsum[parity][warp] = v;
        }
        __syncthreads();
        int cand_cover = -1;
        for (int k = 0; k < WARPS; k++) cand_cover = max(cand_cover, s_wmax[parity][k]);
        if (cover < 0) cover = cand_cover;
        if (SATURATE) {
          float higher = 0.0f, total = 0.0f;  // the warps above this one, and all
          for (int k = WARPS - 1; k >= 0; k--) {
            if (k == warp) higher = total;
            total += s_wsum[parity][k];
          }
          const float next = __shfl_down_sync(FULL, v, 1);
          // the stack strictly above quad i within the run
          const float above = carry + ((lane < 31 ? next : 0.0f) + higher);
          const int wsat = __reduce_max_sync(FULL, in && !(above >= LOG2_SAT_EPS) ? i : -1);
          if (lane == 0) s_wsat[parity][warp] = wsat;
          __syncthreads();
          int cand_sat = -1;
          for (int k = 0; k < WARPS; k++) cand_sat = max(cand_sat, s_wsat[parity][k]);
          carry += total;
          parity ^= 1;
          // an opaque cover's lt is -24, so the quad below it is saturated:
          // the cut, once found, also settles the cover
          if (cand_sat >= 0) {
            satcut = cand_sat;
            break;
          }
        } else {
          parity ^= 1;
          if (cover >= 0) break;
        }
      }
      if (tid == 0) {
        s_lo[r] = lo;
        s_hi[r] = hi;
        s_cover[r] = cover;
        s_satlo[r] = satcut + 1;
      }
    }
    __syncthreads();
  }

  // counting pass: each warp owns the words [wb, we)
  const int words = (n + 31) >> 5;
  const int per = (words + WARPS - 1) / WARPS;
  const int wb = min(warp * per, words), we = min(wb + per, words);
  int count = 0;
  for (int w = wb; w < we; w += UNROLL) {
    float4 b[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; u++) {
      const int i = (w + u) * 32 + lane;
      b[u] = (w + u < we && i >= w_lo && i < w_hi)
                 ? box[i]
                 : make_float4(nan_f(), nan_f(), nan_f(), nan_f());
    }
#pragma unroll
    for (int u = 0; u < UNROLL; u++) {
      if (w + u >= we) break;
      const int i = (w + u) * 32 + lane;
      bool keep = b[u].x < tx1 && b[u].z > tx0 && b[u].y < ty1 && b[u].w > ty0;
      if (CULL && keep) {
        int thr = -1, satlo = 0;  // the last run holding i sets the cover
        for (int r = 0; r < n_runs; r++) {
          if (i >= s_lo[r] && i < s_hi[r]) {
            thr = s_cover[r];
            satlo = max(satlo, s_satlo[r]);
          }
        }
        keep = i >= thr && i >= satlo;
      }
      const unsigned bits = __ballot_sync(FULL, keep);
      if (lane == 0) s_bits[w + u] = bits;
      count += __popc(bits);
    }
  }
  if (lane == 0) s_wcount[warp] = count;
  __syncthreads();
  int base = 0, total = 0;
  for (int k = 0; k < WARPS; k++) {
    if (k == warp) base = total;
    total += s_wcount[k];
  }
  if (tid == 0) tile_counts[t] = total;

  // writing pass: kept quads at their prefix, the rest after them ascending
  int* out = tile_idx + (size_t)t * n;
  const unsigned below_mask = (1u << lane) - 1u;
  for (int w = wb; w < we; w++) {
    const unsigned bits = s_bits[w];
    const int i = w * 32 + lane;
    const int pre = base + __popc(bits & below_mask);
    if (i < n) out[(bits >> lane) & 1u ? pre : total + (i - pre)] = i;
    base += __popc(bits);
  }
}

// Dynamic shared memory past 48 KB is an opt-in attribute of each kernel on
// each device, set once per device for MAX_QUADS at the first launch there.
constexpr int MAX_DEVICES = 64;
std::atomic<bool> g_smem_opted_in[MAX_DEVICES];

cudaError_t opt_in_smem() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < MAX_DEVICES;
  if (cached && g_smem_opted_in[dev].load(std::memory_order_acquire)) return cudaSuccess;
  const int bytes = MAX_QUADS / 32 * (int)sizeof(unsigned);
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  err = cudaFuncSetAttribute(bin_tiles_kernel<false, false>, a, bytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(bin_tiles_kernel<true, false>, a, bytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(bin_tiles_kernel<true, true>, a, bytes);
  if (err == cudaSuccess && cached) g_smem_opted_in[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

// C entry point (bound with ctypes by ops/binning.py): one binning, the
// prepass then the tile kernel, both on `stream`. fields (n, 68) f32, modes
// (n, 2) i32 or null (no culling); the window [start, end) read from
// start_p / end_p (one i32 on the device each) where not null, else from
// start / end; with modes, runs (n_runs, 2) i32 on the device, or
// window_run != 0 for the window as the one run; scratch: 10 * n f32 of
// the device; tile_idx (n_tiles, n) i32 and tile_counts (n_tiles,) i32,
// written whole. Returns cudaGetLastError() as an int
// (cudaErrorInvalidValue for n or n_runs out of range).
extern "C" int figdraw_bin_quads(const float* fields, const int* modes,
                                 const int* start_p, const int* end_p, int start,
                                 int end, const int* runs, int n_runs, int window_run,
                                 int n, int n_tiles, int tiles_x, int tile_h,
                                 int tile_w, int saturate, float* scratch,
                                 int* tile_idx, int* tile_counts, void* stream) {
  if (n < 0 || n > MAX_QUADS || n_runs < 0 || n_runs > MAX_RUNS || tiles_x <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_tiles <= 0) return 0;
  cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  float4* box = reinterpret_cast<float4*>(scratch);
  float4* cov = box + n;
  float2* lto = reinterpret_cast<float2*>(cov + n);
  const bool cull = modes != nullptr;
  if (n > 0) {
    const int grid = (n + PREP_THREADS - 1) / PREP_THREADS;
    if (cull)
      bin_prep_kernel<true><<<grid, PREP_THREADS, 0, s>>>(fields, modes, n, box, cov, lto);
    else
      bin_prep_kernel<false><<<grid, PREP_THREADS, 0, s>>>(fields, nullptr, n, box, nullptr,
                                                          nullptr);
  }
  const size_t smem = (size_t)((n + 31) >> 5) * sizeof(unsigned);
  if (window_run) {
    runs = nullptr;
    n_runs = 1;
  }
  if (!cull)
    bin_tiles_kernel<false, false><<<n_tiles, THREADS, smem, s>>>(
        box, cov, lto, start_p, end_p, start, end, nullptr, 0, n, tiles_x, tile_h,
        tile_w, tile_idx, tile_counts);
  else if (!saturate)
    bin_tiles_kernel<true, false><<<n_tiles, THREADS, smem, s>>>(
        box, cov, lto, start_p, end_p, start, end, runs, n_runs, n, tiles_x, tile_h,
        tile_w, tile_idx, tile_counts);
  else
    bin_tiles_kernel<true, true><<<n_tiles, THREADS, smem, s>>>(
        box, cov, lto, start_p, end_p, start, end, runs, n_runs, n, tiles_x, tile_h,
        tile_w, tile_idx, tile_counts);
  return (int)cudaGetLastError();
}
