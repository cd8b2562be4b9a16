// Backdrop blur for NVIDIA Hopper (sm_90a): the separable gaussian over the
// channel-planar frame that a backdrop-blur node reads.
//
// Replaces figdraw_tpu/ops/blur.py `backdrop_blur_planar` (:61) and its
// `_blur_axis` (:21), which the JAX package leaves to XLA (no Pallas): the
// radius clamped to [0, 64], sigma = radius / 2 (at least 0.5), 17 taps at a
// step of max(radius / 8, 1) pixels, each tap linearly interpolated between
// its two texels with clamp-to-edge addressing, the sum divided by the sum
// of the weights, the horizontal pass then the vertical one, and the
// identity when the radius is at most 0.5. In plain torch the same function
// is 68 gathers and some 500 elementwise kernels over 35 MB planes at 1080p.
//
// What bounds it on this card: bytes. Each pass must read the planes once and
// write them once (at 1080p with 128-row tiles 4 x 1152 x 1920 x 4 B = 35.4
// MB each way, 141.6 MB for both passes). The function needs 86 FP32
// operations a pixel and pass beside them (5 a tap, one divide), under the
// bytes' time. Next in line is the on-chip traffic of the taps: 34 texels a
// pixel and pass, 136 bytes from shared memory, which at 128 bytes a cycle
// and SM come to about twice the bytes' bound.
//
// The design. A tap's position, its floor and fraction, its two clamped
// texel indices and 1 - fraction depend only on the column in the
// horizontal pass and only on the row in the vertical one, so a thread
// computes several pixels that share them:
//   * horizontal pass: a block of H_COLS threads takes items of H_COLS
//     columns of H_ROWS rows; each thread works out the 17 taps' positions
//     once for its column and applies them to its H_ROWS rows. The rows'
//     segments plus the halo the radius needs (at most 65 texels a side),
//     clamped at the line's ends as the taps would be, are staged into
//     shared memory by cp.async, double-buffered: the block stages its next
//     item while it computes this one;
//   * vertical pass: a block of V_TX x V_TY threads takes items of V_TX * VEC
//     columns of one plane and a segment of rows, and walks the segment down
//     in steps of V_OUT_ROWS rows; each thread works out a row's taps once
//     for VEC = 4 neighbouring columns, which share the texel rows, so a tap
//     is one 16-byte load of each of its two rows. The rows live in a ring of
//     V_RING rows in shared memory, filled by cp.async of 16-byte words: each
//     step prefetches the rows the next step adds while it computes, and
//     every row of the segment and its halo is read from memory once. Planes
//     whose width is not a multiple of 4 (or that are not 16-byte aligned)
//     take VEC = 1.
// Both passes are persistent: a grid of as many blocks as the card holds at
// once loops over the items, so the 17 weights and offsets are computed once
// a block, in float32 from the radius on the device (no value goes to the
// host), and kept in shared memory.
//
// Rounding: a tap's position `coord + i * step`, its floor and its fraction
// choose the two texels and their weights, so they are rounded exactly as the
// plain version rounds them (__fmul_rn / __fadd_rn; one ulp would move a tap
// across a texel boundary). The interpolation and the accumulation are
// rounded step by step in the plain version's order too, so each pixel's
// arithmetic is the plain version's; the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int TAP_RADIUS = 8;
constexpr int TAPS = 2 * TAP_RADIUS + 1;
// a tap lies at most 8 * 8 = 64 pixels off, its second texel one further:
// ceil(offset) + 1 texels a side
constexpr int MAX_HALO = 65;

constexpr int H_COLS = 128;  // horizontal pass: threads a block, a column each
constexpr int H_ROWS = 8;    // rows a thread
constexpr int H_LINE = H_COLS + 2 * MAX_HALO;

constexpr int V_TX = 16, V_TY = 16;  // vertical pass: threads a block
constexpr int V_ROWS = 3;            // rows a thread and step, V_TY apart
constexpr int V_OUT_ROWS = V_TY * V_ROWS;
// the ring holds the rows a step reads and the ones the next step adds:
// 2 * V_OUT_ROWS + 2 * MAX_HALO = 226 rows at most
constexpr int V_RING = 256;
static_assert(2 * V_OUT_ROWS + 2 * MAX_HALO <= V_RING, "the ring must hold two steps");

struct Taps {
  float off[TAPS];
  float w[TAPS];
  float den;
  int halo;  // texels a side the block stages
};

// The weights, offsets and halo for radius[0], into shared memory; every
// thread of the block calls it. Returns the clamped radius.
__device__ __forceinline__ float load_taps(const float* radius, Taps& taps, int tid) {
  const float r = fminf(fmaxf(radius[0], 0.0f), 64.0f);
  if (tid < TAPS) {
    const float sigma = fmaxf(__fmul_rn(0.5f, r), 0.5f);
    const float step = fmaxf(__fdiv_rn(r, (float)TAP_RADIUS), 1.0f);
    const float x = __fmul_rn((float)(tid - TAP_RADIUS), step);
    taps.off[tid] = x;
    taps.w[tid] = expf(__fdiv_rn(__fmul_rn(-0.5f, __fmul_rn(x, x)),
                                 __fmul_rn(sigma, sigma)));
  }
  __syncthreads();
  if (tid == 0) {
    float sum = 0.0f;
    for (int i = 0; i < TAPS; i++) sum = __fadd_rn(sum, taps.w[i]);
    taps.den = fmaxf(sum, 1e-5f);
    taps.halo = (int)ceilf(taps.off[TAPS - 1]) + 1;
  }
  __syncthreads();
  return r;
}

// One tap's position along a line of n texels: the two texel indices and
// the interpolation weights, as the plain version rounds them.
struct Pos {
  int i0, i1;
  float fr, omf;  // fraction and 1 - fraction
};

__device__ __forceinline__ Pos tap_pos(float coord, float off, int n) {
  const float pos = __fadd_rn(coord, off);
  const float p0 = floorf(pos);
  Pos p;
  p.fr = __fsub_rn(pos, p0);
  p.omf = __fsub_rn(1.0f, p.fr);
  p.i0 = min(max((int)p0, 0), n - 1);
  p.i1 = min(p.i0 + 1, n - 1);
  return p;
}

__device__ __forceinline__ float tap_sum(float acc, float s0, float s1, const Pos& p,
                                         float w) {
  const float tap = __fadd_rn(__fmul_rn(s0, p.omf), __fmul_rn(s1, p.fr));
  return __fadd_rn(acc, __fmul_rn(tap, w));
}

// cp.async from global to shared memory: 4 bytes (the .ca form) or 16 (.cg)
__device__ __forceinline__ void cp_async(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async(float4* smem, const float4* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits for all but the newest group of this thread's copies
__device__ __forceinline__ void cp_async_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stages item `item` of the horizontal pass (its rows' texels [base, base +
// width), clamped to the row) into `line`, as one cp.async group.
__device__ __forceinline__ void stage_h(const float* in, float (*line)[H_LINE], int item,
                                        int strips, int rows, int pw, int halo, int tid) {
  const int base = (item % strips) * H_COLS - halo;
  const int rb = (item / strips) * H_ROWS;
  const int width = H_COLS + 2 * halo;
  for (int k = 0; k < H_ROWS && rb + k < rows; k++) {
    const float* src = in + (size_t)(rb + k) * pw;
    for (int j = tid; j < width; j += H_COLS)
      cp_async(&line[k][j], src + min(max(base + j, 0), pw - 1));
  }
  cp_async_commit();
}

// Horizontal pass over `rows` rows of pw pixels; an item is H_COLS columns
// of H_ROWS rows.
__global__ void __launch_bounds__(H_COLS)
blur_h_kernel(const float* __restrict__ in, float* __restrict__ out,
              const float* __restrict__ radius, int rows, int pw) {
  __shared__ Taps taps;
  __shared__ float s_line[2][H_ROWS][H_LINE];
  const int tid = threadIdx.x;
  const int strips = (pw + H_COLS - 1) / H_COLS;
  const int items = strips * ((rows + H_ROWS - 1) / H_ROWS);
  const float r = load_taps(radius, taps, tid);
  if (r <= 0.5f) {
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int x = (item % strips) * H_COLS + tid, rb = (item / strips) * H_ROWS;
      if (x < pw)
        for (int k = 0; k < H_ROWS && rb + k < rows; k++)
          out[(size_t)(rb + k) * pw + x] = in[(size_t)(rb + k) * pw + x];
    }
    return;
  }
  const int halo = taps.halo;
  int buf = 0;
  if (blockIdx.x < items) stage_h(in, s_line[0], blockIdx.x, strips, rows, pw, halo, tid);
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int next = item + gridDim.x;
    if (next < items)
      stage_h(in, s_line[buf ^ 1], next, strips, rows, pw, halo, tid);
    else
      cp_async_commit();  // an empty group keeps the wait below uniform
    cp_async_wait_older();
    __syncthreads();

    const int xb = (item % strips) * H_COLS, rb = (item / strips) * H_ROWS;
    const int x = xb + tid, base = xb - halo;
    if (x < pw) {
      float acc[H_ROWS];
#pragma unroll
      for (int k = 0; k < H_ROWS; k++) acc[k] = 0.0f;
      const float coord = (float)x;
#pragma unroll
      for (int i = 0; i < TAPS; i++) {
        const Pos p = tap_pos(coord, taps.off[i], pw);
        const float w = taps.w[i];
        const int a = p.i0 - base, b = p.i1 - base;
#pragma unroll
        for (int k = 0; k < H_ROWS; k++)
          acc[k] = tap_sum(acc[k], s_line[buf][k][a], s_line[buf][k][b], p, w);
      }
#pragma unroll
      for (int k = 0; k < H_ROWS; k++)
        if (rb + k < rows) out[(size_t)(rb + k) * pw + x] = __fdiv_rn(acc[k], taps.den);
    }
    __syncthreads();  // the buffer is free for the item after next
    buf ^= 1;
  }
}

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

__device__ __forceinline__ float4 tap_sum(float4 acc, float4 s0, float4 s1, const Pos& p,
                                          float w) {
  return make_float4(tap_sum(acc.x, s0.x, s1.x, p, w), tap_sum(acc.y, s0.y, s1.y, p, w),
                     tap_sum(acc.z, s0.z, s1.z, p, w), tap_sum(acc.w, s0.w, s1.w, p, w));
}
__device__ __forceinline__ float4 div_rn(float4 a, float d) {
  return make_float4(__fdiv_rn(a.x, d), __fdiv_rn(a.y, d), __fdiv_rn(a.z, d),
                     __fdiv_rn(a.w, d));
}
__device__ __forceinline__ float div_rn(float a, float d) { return __fdiv_rn(a, d); }
__device__ __forceinline__ void zero(float4& a) { a = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ void zero(float& a) { a = 0.0f; }

// Stages rows [lo, hi) of the block's columns into their ring slots (row &
// (V_RING - 1)), as one cp.async group.
template <typename T>
__device__ __forceinline__ void stage_v(const float* plane, T (*ring)[V_TX], int lo, int hi,
                                        int xb, int pw, int tid) {
  constexpr int VEC = sizeof(T) / sizeof(float);
  for (int j = tid; j < (hi - lo) * V_TX; j += V_TX * V_TY) {
    const int row = lo + j / V_TX, c = j % V_TX;
    const int col = xb + c * VEC;
    if (col < pw)
      cp_async(&ring[row & (V_RING - 1)][c],
               reinterpret_cast<const T*>(plane + (size_t)row * pw + col));
  }
  cp_async_commit();
}

// Vertical pass over planes of ph rows and pw pixels (pw % VEC == 0). An
// item is V_TX * VEC columns of one plane over a segment of `seg_steps`
// steps of V_OUT_ROWS rows; the ring is dynamic shared memory.
template <int VEC>
__global__ void __launch_bounds__(V_TX * V_TY)
blur_v_kernel(const float* __restrict__ in, float* __restrict__ out,
              const float* __restrict__ radius, int planes, int ph, int pw, int seg_steps) {
  using T = typename Vec<VEC>::T;
  extern __shared__ __align__(16) unsigned char v_smem[];
  T(*ring)[V_TX] = reinterpret_cast<T(*)[V_TX]>(v_smem);
  __shared__ Taps taps;
  const int tid = threadIdx.y * V_TX + threadIdx.x;
  const int strips = (pw + V_TX * VEC - 1) / (V_TX * VEC);
  const int seg_rows = seg_steps * V_OUT_ROWS;
  const int segs = (ph + seg_rows - 1) / seg_rows;
  const int items = strips * segs * planes;
  const float r = load_taps(radius, taps, tid);
  const int halo = taps.halo;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int xb = (item % strips) * V_TX * VEC;
    const int y_lo = ((item / strips) % segs) * seg_rows;
    const int y_hi = min(y_lo + seg_rows, ph);
    const size_t plane = (size_t)(item / (strips * segs)) * ph * pw;
    const int x = xb + threadIdx.x * VEC;
    if (r <= 0.5f) {
      if (x < pw)
        for (int y = y_lo + threadIdx.y; y < y_hi; y += V_TY) {
          const size_t at = plane + (size_t)y * pw + x;
          *reinterpret_cast<T*>(out + at) = *reinterpret_cast<const T*>(in + at);
        }
      continue;
    }
    // the texel rows a step at y reads are [y - halo, y + V_OUT_ROWS + halo),
    // clamped to the plane; `staged` is the end of the rows in the ring
    int staged = min(y_lo + V_OUT_ROWS + halo, ph);
    stage_v<T>(in + plane, ring, max(y_lo - halo, 0), staged, xb, pw, tid);
    for (int y0 = y_lo; y0 < y_hi; y0 += V_OUT_ROWS) {
      // the rows the next step of the segment adds (none after the last,
      // so no copy is in flight when the next item stages)
      const int want = y0 + V_OUT_ROWS < y_hi ? min(y0 + 2 * V_OUT_ROWS + halo, ph) : staged;
      stage_v<T>(in + plane, ring, staged, want, xb, pw, tid);  // maybe an empty group
      staged = want;
      cp_async_wait_older();
      __syncthreads();
      if (x < pw) {
#pragma unroll
        for (int k = 0; k < V_ROWS; k++) {
          const int y = y0 + threadIdx.y + k * V_TY;
          if (y >= y_hi) break;
          T acc;
          zero(acc);
          const float coord = (float)y;
#pragma unroll
          for (int i = 0; i < TAPS; i++) {
            const Pos p = tap_pos(coord, taps.off[i], ph);
            acc = tap_sum(acc, ring[p.i0 & (V_RING - 1)][threadIdx.x],
                          ring[p.i1 & (V_RING - 1)][threadIdx.x], p, taps.w[i]);
          }
          *reinterpret_cast<T*>(out + plane + (size_t)y * pw + x) = div_rn(acc, taps.den);
        }
      }
      __syncthreads();  // the slots this step read are free for the step after next
    }
  }
}

template <int VEC>
constexpr int ring_bytes() {
  return V_RING * V_TX * VEC * (int)sizeof(float);
}

// Per device: the SMs, the blocks of each kernel one SM holds at once, and
// the vertical pass's dynamic shared memory opted in (set once at the first
// launch there).
struct Occupancy {
  int sms, h, v4, v1;
};
constexpr int MAX_DEVICES = 64;
std::atomic<bool> g_known[MAX_DEVICES];
Occupancy g_occupancy[MAX_DEVICES];

cudaError_t occupancy(Occupancy& o) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < MAX_DEVICES;
  if (cached && g_known[dev].load(std::memory_order_acquire)) {
    o = g_occupancy[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(blur_v_kernel<4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ring_bytes<4>());
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.h, blur_h_kernel, H_COLS, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.v4, blur_v_kernel<4>, V_TX * V_TY,
                                                        ring_bytes<4>());
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.v1, blur_v_kernel<1>, V_TX * V_TY,
                                                        ring_bytes<1>());
  if (err != cudaSuccess) return err;
  if (cached) {
    g_occupancy[dev] = o;
    g_known[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

// A persistent grid for `items` equal items on `slots` resident blocks: as
// few rounds as the slots allow, and no more blocks than that needs.
int persistent_grid(long long items, int slots) {
  slots = slots > 0 ? slots : 1;
  const long long rounds = (items + slots - 1) / slots;
  return (int)((items + rounds - 1) / rounds);
}

}  // namespace

// C entry point (bound with ctypes by ops/blur.py): one pass, along x
// (vertical == 0) or along y. in, out: (planes, ph, pw) f32, two distinct
// buffers; radius: one f32 on the device. Launches on
// `stream` and returns cudaGetLastError() as an int. A blur is two calls:
// in -> mid along x, then mid -> out along y.
extern "C" int figdraw_blur_pass(const float* in, float* out,
                                 const float* radius, int planes, int ph,
                                 int pw, int vertical, void* stream) {
  if (planes <= 0 || ph <= 0 || pw <= 0) return 0;
  Occupancy o;
  cudaError_t err = occupancy(o);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (!vertical) {
    const long long rows = (long long)planes * ph;
    if (rows > (1 << 30)) return (int)cudaErrorInvalidValue;
    const long long items = (long long)((pw + H_COLS - 1) / H_COLS) *
                            ((rows + H_ROWS - 1) / H_ROWS);
    if (items > (1 << 30)) return (int)cudaErrorInvalidValue;
    blur_h_kernel<<<persistent_grid(items, o.sms * o.h), H_COLS, 0, s>>>(in, out, radius,
                                                                         (int)rows, pw);
  } else {
    const bool vec4 = pw % 4 == 0 && ((uintptr_t)in | (uintptr_t)out) % 16 == 0;
    const int vec = vec4 ? 4 : 1;
    const int slots = o.sms * (vec4 ? o.v4 : o.v1);
    // split each column strip of a plane into segments: the fewest rounds
    // of the resident blocks, each round as short as they allow (a segment
    // also reads its halo, counted as one step)
    const long long columns = (long long)((pw + V_TX * vec - 1) / (V_TX * vec)) * planes;
    const int steps = (ph + V_OUT_ROWS - 1) / V_OUT_ROWS;
    int seg_steps = steps;
    long long best = -1;
    for (int k = 1; k <= steps; k++) {
      const long long items = columns * ((steps + k - 1) / k);
      const long long cost = (items + slots - 1) / slots * (k + 1);
      if (best < 0 || cost < best) best = cost, seg_steps = k;
    }
    const long long items = columns * ((steps + seg_steps - 1) / seg_steps);
    if (items > (1 << 30)) return (int)cudaErrorInvalidValue;
    const dim3 block(V_TX, V_TY);
    if (vec4)
      blur_v_kernel<4><<<persistent_grid(items, slots), block, ring_bytes<4>(), s>>>(
          in, out, radius, planes, ph, pw, seg_steps);
    else
      blur_v_kernel<1><<<persistent_grid(items, slots), block, ring_bytes<1>(), s>>>(
          in, out, radius, planes, ph, pw, seg_steps);
  }
  return (int)cudaGetLastError();
}
