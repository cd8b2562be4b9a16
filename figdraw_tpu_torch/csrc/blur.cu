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

// k / d and k % d for k >= 0 and d > 0, from the float quotient (rd = 1 / d)
// corrected to the exact one: a few instructions where an integer division
// by a value known only at run time takes some twenty.
struct QR {
  int q, r;
};
__device__ __forceinline__ QR divmod(int k, int d, float rd) {
  int q = __float2int_rz(__fmul_rn(__int2float_rn(k), rd));
  int r = k - q * d;
  while (r < 0) q--, r += d;
  while (r >= d) q++, r -= d;
  return QR{q, r};
}

// Row addressing. The two kernels below are templated on a policy P that
// says where a row lies, so X1 (one stack of planes) and X6 (the banded blur,
// below) run the same bodies:
//   horizontal pass: p.bands() bands of p.rows() rows, row k of band b read at
//     p.h_in(b, k) and written at p.h_out(b, k), with radius p.radius_of(b);
//   both: item i of per band items a band is item r of band q, where
//     {q, r} = p.band_of(i, per, 1 / per);
//   vertical pass: p.bands() bands of p.channels() planes, each plane a line
//     of p.extent(b) rows (the taps clamp to it); l = p.line(b, plane) is
//     worked out once an item, and its row t is read at l.src(t); output
//     rows are the line's rows [p.origin(b), p.origin(b) + p.out_rows()),
//     written at l.dst(y) in line coordinates.
// A block loads the taps again where an item's radius pointer is not the
// one it holds; X1 has one.

// X1: `planes` planes of ph rows, one line a plane.
struct Planes {
  const float* in;
  float* out;
  const float* radius;
  int planes, ph, pw;

  __device__ int bands() const { return 1; }
  __device__ QR band_of(int item, int, float) const { return QR{0, item}; }
  __device__ int rows() const { return planes * ph; }
  __device__ const float* radius_of(int) const { return radius; }
  __device__ const float* h_in(int, int k) const { return in + (size_t)k * pw; }
  __device__ float* h_out(int, int k) const { return out + (size_t)k * pw; }
  __device__ int channels() const { return planes; }
  __device__ int out_rows() const { return ph; }
  __device__ int origin(int) const { return 0; }
  __device__ int extent(int) const { return ph; }
  struct Line {
    const float* in;
    float* out;
    int pw;
    __device__ const float* src(int t) const { return in + (size_t)t * pw; }
    __device__ float* dst(int y) const { return out + (size_t)y * pw; }
  };
  __device__ Line line(int, int plane) const {
    const size_t at = (size_t)plane * ph * pw;
    return Line{in + at, out + at, pw};
  }
};

// ---------------------------------------------------------------------------
// X6, the banded blur: the same blur on a frame split into row bands over
// several devices.
//
// Replaces figdraw_tpu/parallel/sharding.py `_banded_blur_planar` (:165-190),
// XLA ops in the JAX package (no Pallas): the horizontal pass on each band, a
// ppermute of BLUR_HALO = 65 rows from each neighbour (the band's own edge row
// repeated at the frame's top and bottom) and the vertical pass on the
// extended band, cropped; or, where a band is no taller than the halo, an
// all_gather of every band and the vertical pass on the whole.
//
// What bounds it on this card: the blur's operations, as for X1 at these
// sizes. Fused, the function reads the frame once and writes it once (4
// bands of 272 x 1920 rows: 66.8 MB, 0.020 ms at 3.35 TB/s) and needs 86
// FP32 operations a pixel and pass (0.0215 ms at 67 TFLOP/s); the two
// passes as written here move the planes twice each way (133.7 MB, 0.040
// ms), as X1's do.
//
// The design. Each device's bands are blurred in two launches, whatever
// their number, and on one device nothing is copied:
//   * the horizontal pass (policy BandRowsH) reads rows [0, pband) of each
//     band's planes in place, through a table of base pointers passed by
//     value (a __grid_constant__ parameter, no upload), and writes one
//     scratch of the device's bands, channel-planar, each band at its slot;
//   * the vertical pass (policy BandLinesV) gives each band a line in the
//     plain version's own coordinates (the extended band of pband + 2 halo
//     rows, output row j at halo + j; or, gathered, the frame's n pband rows,
//     output row j at i pband + j), since the tap positions round by those
//     coordinates. The line is three segments of the scratch: the band's own
//     rows, and above and below it a neighbour's rows in place (same device),
//     rows copied from another device into the scratch past the bands, or the
//     band's edge row repeated (step 0). The segment is looked up once for
//     each row the ring stages, never per tap; the output goes straight into
//     the caller's views (the backdrop), so there is no crop and no copy.
// The per-pixel arithmetic is X1's: the same kernels, the same taps.

constexpr int MAX_BANDS = 32;  // bands a launch (ops/blur.py MAX_BANDS)

struct BandIn {
  const float* in;   // the band's planes, row 0 of plane 0
  long long cs;      // their channel stride in floats (kh pw for kh >= pband rows)
  const float* radius;
  int slot;          // the band's first row in the scratch
};

struct BandRowsH {
  float* scratch;
  long long cs;  // the scratch's channel stride
  int c, pband, pw, m;
  float rpband;  // 1 / pband
  BandIn b[MAX_BANDS];

  __device__ int bands() const { return m; }
  __device__ QR band_of(int item, int per, float rper) const { return divmod(item, per, rper); }
  __device__ int rows() const { return c * pband; }
  __device__ const float* radius_of(int band) const { return b[band].radius; }
  // row k of a band is row k % pband of its plane k / pband
  __device__ const float* h_in(int band, int k) const {
    const QR at = divmod(k, pband, rpband);
    return b[band].in + at.q * b[band].cs + (size_t)at.r * pw;
  }
  __device__ float* h_out(int band, int k) const {
    const QR at = divmod(k, pband, rpband);
    return scratch + at.q * cs + (size_t)(b[band].slot + at.r) * pw;
  }
};

struct BandLine {
  float* out;     // the band's output, row 0 of plane 0
  long long cs;   // its channel stride in floats
  const float* radius;
  int origin, n;  // line row of output row 0; the line's rows
  // segment s covers line rows [lo[s], lo[s + 1]) (the last up to n): line
  // row t is scratch row base[s] + (t - lo[s]) step[s]
  int lo[3], base[3], step[3];
};

struct BandLinesV {
  const float* scratch;
  long long cs;
  int c, pband, pw, m;
  BandLine b[MAX_BANDS];

  __device__ int bands() const { return m; }
  __device__ QR band_of(int item, int per, float rper) const { return divmod(item, per, rper); }
  __device__ const float* radius_of(int band) const { return b[band].radius; }
  __device__ int channels() const { return c; }
  __device__ int out_rows() const { return pband; }
  __device__ int origin(int band) const { return b[band].origin; }
  __device__ int extent(int band) const { return b[band].n; }
  // one plane of a band's line: line row t of segment s is scratch row
  // off_s + t step_s (scalars, so that the line stays in registers)
  struct Line {
    const float* in;
    float* out;
    int pw, origin, lo1, lo2, off0, off1, off2, step0, step1, step2;
    __device__ const float* src(int t) const {
      const int row = t < lo1 ? off0 + t * step0 : t < lo2 ? off1 + t * step1 : off2 + t * step2;
      return in + (size_t)row * pw;
    }
    __device__ float* dst(int y) const { return out + (size_t)(y - origin) * pw; }
  };
  __device__ Line line(int band, int plane) const {
    const BandLine& e = b[band];
    return Line{scratch + plane * cs, e.out + plane * e.cs, pw, e.origin, e.lo[1], e.lo[2],
                e.base[0] - e.lo[0] * e.step[0], e.base[1] - e.lo[1] * e.step[1],
                e.base[2] - e.lo[2] * e.step[2], e.step[0], e.step[1], e.step[2]};
  }
};

// Stages the horizontal pass's rows [rb, rb + H_ROWS) of band `band` (their
// texels [base, base + width) of the column strip, clamped to the row) into
// `line`, as one cp.async group.
template <class P>
__device__ __forceinline__ void stage_h(const P& p, float (*line)[H_LINE], int band, int strip,
                                        int rb, int rows, int halo, int tid) {
  const int base = strip * H_COLS - halo;
  const int width = H_COLS + 2 * halo;
  for (int k = 0; k < H_ROWS && rb + k < rows; k++) {
    const float* src = p.h_in(band, rb + k);
    for (int j = tid; j < width; j += H_COLS)
      cp_async(&line[k][j], src + min(max(base + j, 0), p.pw - 1));
  }
  cp_async_commit();
}

// Horizontal pass; an item is H_COLS columns of H_ROWS rows of one band. The
// next item is staged while this one computes where it shares the radius.
// At least 13 blocks an SM: as many as its shared memory holds, which caps a
// thread at 32 registers (X6's pass ran 3% faster so, X1's the same).
template <class P>
__global__ void __launch_bounds__(H_COLS, 13) blur_h_kernel(const __grid_constant__ P p) {
  __shared__ Taps taps;
  __shared__ float s_line[2][H_ROWS][H_LINE];
  const int tid = threadIdx.x;
  const int pw = p.pw;
  const int strips = (pw + H_COLS - 1) / H_COLS;
  const int rows = p.rows();
  const int per_band = strips * ((rows + H_ROWS - 1) / H_ROWS);
  const float rper = 1.0f / per_band;
  const int items = per_band * p.bands();
  const float* loaded = nullptr;
  float r = 0.0f;
  int halo = 0, buf = 0;
  bool ready = false;  // this item's rows are staged in s_line[buf]
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const QR at = p.band_of(item, per_band, rper);
    const int band = at.q, rest = at.r;
    const float* radius = p.radius_of(band);
    if (radius != loaded) {
      r = load_taps(radius, taps, tid);
      halo = taps.halo;
      loaded = radius;
    }
    const int strip = rest % strips, rb = (rest / strips) * H_ROWS;
    const int xb = strip * H_COLS, x = xb + tid;
    if (r <= 0.5f) {
      if (x < pw)
        for (int k = 0; k < H_ROWS && rb + k < rows; k++)
          p.h_out(band, rb + k)[x] = p.h_in(band, rb + k)[x];
      continue;
    }
    if (!ready) stage_h(p, s_line[buf], band, strip, rb, rows, halo, tid);
    const int next = item + gridDim.x;
    const QR nx = p.band_of(next, per_band, rper);
    ready = next < items && p.radius_of(nx.q) == radius;
    if (ready)
      stage_h(p, s_line[buf ^ 1], nx.q, nx.r % strips, (nx.r / strips) * H_ROWS, rows, halo,
              tid);
    else
      cp_async_commit();  // an empty group keeps the wait below uniform
    cp_async_wait_older();
    __syncthreads();

    const int base = xb - halo;
    if (x < pw) {
      float acc[H_ROWS];
#pragma unroll
      for (int k = 0; k < H_ROWS; k++) acc[k] = 0.0f;
      const float coord = (float)x;
#pragma unroll
      for (int i = 0; i < TAPS; i++) {
        const Pos q = tap_pos(coord, taps.off[i], pw);
        const float w = taps.w[i];
        const int a = q.i0 - base, b = q.i1 - base;
#pragma unroll
        for (int k = 0; k < H_ROWS; k++)
          acc[k] = tap_sum(acc[k], s_line[buf][k][a], s_line[buf][k][b], q, w);
      }
#pragma unroll
      for (int k = 0; k < H_ROWS; k++)
        if (rb + k < rows) p.h_out(band, rb + k)[x] = __fdiv_rn(acc[k], taps.den);
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

// Stages line rows [lo, hi) of the block's columns into their ring slots (row
// & (V_RING - 1)), as one cp.async group; each row's address is looked up
// once.
template <typename T, class L>
__device__ __forceinline__ void stage_v(const L& l, T (*ring)[V_TX], int lo, int hi, int xb,
                                        int tid) {
  constexpr int VEC = sizeof(T) / sizeof(float);
  for (int j = tid; j < (hi - lo) * V_TX; j += V_TX * V_TY) {
    const int row = lo + j / V_TX, c = j % V_TX;
    const int col = xb + c * VEC;
    if (col < l.pw)
      cp_async(&ring[row & (V_RING - 1)][c], reinterpret_cast<const T*>(l.src(row) + col));
  }
  cp_async_commit();
}

// Vertical pass (pw % VEC == 0). An item is V_TX * VEC columns of one plane
// of one band over a segment of `seg_steps` steps of V_OUT_ROWS output rows;
// the ring is dynamic shared memory.
template <int VEC, class P>
__global__ void __launch_bounds__(V_TX * V_TY)
blur_v_kernel(const __grid_constant__ P p, int seg_steps) {
  using T = typename Vec<VEC>::T;
  extern __shared__ __align__(16) unsigned char v_smem[];
  T(*ring)[V_TX] = reinterpret_cast<T(*)[V_TX]>(v_smem);
  __shared__ Taps taps;
  const int tid = threadIdx.y * V_TX + threadIdx.x;
  const int pw = p.pw;
  const int strips = (pw + V_TX * VEC - 1) / (V_TX * VEC);
  const int seg_rows = seg_steps * V_OUT_ROWS;
  const int rows = p.out_rows();
  const int segs = (rows + seg_rows - 1) / seg_rows;
  const int per_band = strips * segs * p.channels();
  const float rper = 1.0f / per_band;
  const int items = per_band * p.bands();
  const float* loaded = nullptr;
  float r = 0.0f;
  int halo = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const QR at = p.band_of(item, per_band, rper);
    const int band = at.q, rest = at.r;
    const float* radius = p.radius_of(band);
    if (radius != loaded) {
      r = load_taps(radius, taps, tid);
      halo = taps.halo;
      loaded = radius;
    }
    const int origin = p.origin(band), n = p.extent(band);
    const int xb = (rest % strips) * V_TX * VEC;
    const int y_lo = origin + ((rest / strips) % segs) * seg_rows;
    const int y_hi = min(y_lo + seg_rows, origin + rows);
    const typename P::Line l = p.line(band, rest / (strips * segs));
    const int x = xb + threadIdx.x * VEC;
    if (r <= 0.5f) {
      if (x < pw)
        for (int y = y_lo + threadIdx.y; y < y_hi; y += V_TY)
          *reinterpret_cast<T*>(l.dst(y) + x) = *reinterpret_cast<const T*>(l.src(y) + x);
      continue;
    }
    // the line rows a step at y reads are [y - halo, y + V_OUT_ROWS + halo),
    // clamped to the line; `staged` is the end of the rows in the ring
    int staged = min(y_lo + V_OUT_ROWS + halo, n);
    stage_v<T>(l, ring, max(y_lo - halo, 0), staged, xb, tid);
    for (int y0 = y_lo; y0 < y_hi; y0 += V_OUT_ROWS) {
      // the rows the next step of the segment adds (none after the last,
      // so no copy is in flight when the next item stages)
      const int want = y0 + V_OUT_ROWS < y_hi ? min(y0 + 2 * V_OUT_ROWS + halo, n) : staged;
      stage_v<T>(l, ring, staged, want, xb, tid);  // maybe an empty group
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
            const Pos q = tap_pos(coord, taps.off[i], n);
            acc = tap_sum(acc, ring[q.i0 & (V_RING - 1)][threadIdx.x],
                          ring[q.i1 & (V_RING - 1)][threadIdx.x], q, taps.w[i]);
          }
          *reinterpret_cast<T*>(l.dst(y) + x) = div_rn(acc, taps.den);
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

// Resident blocks an SM holds of each form of a pass.
struct Fits {
  int h, v4, v1;
};

template <class H, class V>
cudaError_t fits(Fits& f) {
  cudaError_t err = cudaFuncSetAttribute(blur_v_kernel<4, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         ring_bytes<4>());
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.h, blur_h_kernel<H>, H_COLS, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.v4, blur_v_kernel<4, V>,
                                                        V_TX * V_TY, ring_bytes<4>());
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.v1, blur_v_kernel<1, V>,
                                                        V_TX * V_TY, ring_bytes<1>());
  return err;
}

// Per device: the SMs, the blocks of each kernel one SM holds at once (X1's
// and X6's forms), and the vertical passes' dynamic shared memory opted in
// (set once at the first launch there).
struct Occupancy {
  int sms;
  Fits whole, bands;
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
  if (err == cudaSuccess) err = fits<Planes, Planes>(o.whole);
  if (err == cudaSuccess) err = fits<BandRowsH, BandLinesV>(o.bands);
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

// The horizontal pass over p's bands of `rows` rows of pw texels each.
template <class P>
cudaError_t run_h(const P& p, int bands, long long rows, int pw, int slots, cudaStream_t s) {
  if (rows * bands > (1 << 30)) return cudaErrorInvalidValue;
  const long long items = (long long)((pw + H_COLS - 1) / H_COLS) *
                          ((rows + H_ROWS - 1) / H_ROWS) * bands;
  if (items > (1 << 30)) return cudaErrorInvalidValue;
  blur_h_kernel<P><<<persistent_grid(items, slots), H_COLS, 0, s>>>(p);
  return cudaGetLastError();
}

// The vertical pass over p's bands of `planes` planes, `rows` output rows of
// pw texels each; vec4: 16-byte words (pw % 4 == 0, every row 16-byte aligned).
template <class P>
cudaError_t run_v(const P& p, int bands, int planes, int rows, int pw, bool vec4,
                  const Fits& f, int sms, cudaStream_t s) {
  const int vec = vec4 ? 4 : 1;
  const int slots = sms * (vec4 ? f.v4 : f.v1);
  // split each column strip of a plane into segments: the fewest rounds
  // of the resident blocks, each round as short as they allow (a segment
  // also reads its halo, counted as one step)
  const long long columns = (long long)((pw + V_TX * vec - 1) / (V_TX * vec)) * planes * bands;
  const int steps = (rows + V_OUT_ROWS - 1) / V_OUT_ROWS;
  int seg_steps = steps;
  long long best = -1;
  for (int k = 1; k <= steps; k++) {
    const long long items = columns * ((steps + k - 1) / k);
    const long long cost = (items + slots - 1) / slots * (k + 1);
    if (best < 0 || cost < best) best = cost, seg_steps = k;
  }
  const long long items = columns * ((steps + seg_steps - 1) / seg_steps);
  if (items > (1 << 30)) return cudaErrorInvalidValue;
  const dim3 block(V_TX, V_TY);
  if (vec4)
    blur_v_kernel<4, P><<<persistent_grid(items, slots), block, ring_bytes<4>(), s>>>(
        p, seg_steps);
  else
    blur_v_kernel<1, P><<<persistent_grid(items, slots), block, ring_bytes<1>(), s>>>(
        p, seg_steps);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return (uintptr_t)ptr % 16 == 0; }

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
  const Planes p{in, out, radius, planes, ph, pw};
  cudaStream_t s = (cudaStream_t)stream;
  if (!vertical) return (int)run_h(p, 1, (long long)planes * ph, pw, o.sms * o.whole.h, s);
  const bool vec4 = pw % 4 == 0 && aligned16(in) && aligned16(out);
  return (int)run_v(p, 1, planes, ph, pw, vec4, o.whole, o.sms, s);
}

// C entry points of X6 (ops/blur.py `banded_blur_kernels`), one launch each
// over m <= MAX_BANDS bands of one device, on `stream`; they return
// cudaGetLastError() as an int.
//
// The horizontal pass: band i's planes (c planes of >= pband rows of pw f32,
// channel stride in_cs[i] floats, rows pw apart) at in[i], its radius (one
// f32 on the device) at radius[i]; its rows [0, pband) blurred into rows
// [slot[i], slot[i] + pband) of each plane of the scratch (channel stride cs).
extern "C" int figdraw_blur_bands_h(float* scratch, long long cs, int c, int pband, int pw,
                                    int m, const long long* in, const long long* in_cs,
                                    const long long* radius, const int* slot, void* stream) {
  if (m <= 0 || c <= 0 || pband <= 0 || pw <= 0) return 0;
  if (m > MAX_BANDS) return (int)cudaErrorInvalidValue;
  Occupancy o;
  cudaError_t err = occupancy(o);
  if (err != cudaSuccess) return (int)err;
  BandRowsH p{};
  p.scratch = scratch, p.cs = cs, p.c = c, p.pband = pband, p.pw = pw, p.m = m;
  p.rpband = 1.0f / pband;
  for (int i = 0; i < m; i++)
    p.b[i] = BandIn{reinterpret_cast<const float*>(in[i]), in_cs[i],
                    reinterpret_cast<const float*>(radius[i]), slot[i]};
  return (int)run_h(p, m, (long long)c * pband, pw, o.sms * o.bands.h, (cudaStream_t)stream);
}

// The vertical pass: band i's pband output rows of each of the c planes
// written at out[i] (channel stride out_cs[i] floats, rows pw apart), its
// radius at radius[i]; geo[11 i ...] its line: origin, n, lo[3], base[3],
// step[3] (BandLine), rows of the scratch (channel stride cs).
extern "C" int figdraw_blur_bands_v(const float* scratch, long long cs, int c, int pband,
                                    int pw, int m, const long long* out,
                                    const long long* out_cs, const long long* radius,
                                    const int* geo, void* stream) {
  if (m <= 0 || c <= 0 || pband <= 0 || pw <= 0) return 0;
  if (m > MAX_BANDS) return (int)cudaErrorInvalidValue;
  Occupancy o;
  cudaError_t err = occupancy(o);
  if (err != cudaSuccess) return (int)err;
  BandLinesV p{};
  p.scratch = scratch, p.cs = cs, p.c = c, p.pband = pband, p.pw = pw, p.m = m;
  bool vec4 = pw % 4 == 0 && cs % 4 == 0 && aligned16(scratch);
  for (int i = 0; i < m; i++) {
    BandLine& e = p.b[i];
    const int* g = geo + 11 * i;
    e.out = reinterpret_cast<float*>(out[i]);
    e.cs = out_cs[i];
    e.radius = reinterpret_cast<const float*>(radius[i]);
    e.origin = g[0], e.n = g[1];
    for (int s = 0; s < 3; s++) e.lo[s] = g[2 + s], e.base[s] = g[5 + s], e.step[s] = g[8 + s];
    vec4 = vec4 && e.cs % 4 == 0 && aligned16(e.out);
  }
  return (int)run_v(p, m, c, pband, pw, vec4, o.bands, o.sms, (cudaStream_t)stream);
}
