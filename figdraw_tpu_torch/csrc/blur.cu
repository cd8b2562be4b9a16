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
// operations a pixel and pass beside them (5 a tap, one divide), well under
// the bytes' time; this kernel also works each tap's position out per pixel
// (14 operations a tap, ~240 a pixel and pass) and makes 34 loads, which is
// what keeps it several times over the bound.
// The design: one thread a pixel with x fastest, so a warp's 32 loads of a
// tap are 128 contiguous bytes in both passes (the vertical pass walks rows,
// not columns, inside a warp); a pixel's 34 texels lie within 2 x 64 + 2
// pixels of it, so neighbouring warps find them in L1 and no shared-memory
// tile is needed. The 17 weights and tap offsets are computed once a block,
// in float32 from the radius on the device (no value goes to the host), and
// kept in shared memory.
//
// Rounding: a tap's position `coord + i * step`, its floor and its fraction
// choose the two texels and their weights, so they are rounded exactly as the
// plain version rounds them (__fmul_rn / __fadd_rn; one ulp would move a tap
// across a texel boundary). The interpolation and the accumulation are
// rounded step by step in the plain version's order too, which leaves expf
// against torch.exp as the only difference (a few ulp of a weight).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TAP_RADIUS = 8;
constexpr int TAPS = 2 * TAP_RADIUS + 1;
constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;

// One pass along x (VERTICAL = false) or y (true) of `rows` = planes * ph
// rows of pw pixels; a vertical tap stays inside its own plane.
template <bool VERTICAL>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
blur_pass_kernel(const float* __restrict__ in, float* __restrict__ out,
                 const float* __restrict__ radius, int rows, int ph, int pw) {
  __shared__ float s_off[TAPS];
  __shared__ float s_w[TAPS];
  __shared__ float s_den;

  const float r = fminf(fmaxf(radius[0], 0.0f), 64.0f);
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  if (tid < TAPS) {
    const float sigma = fmaxf(__fmul_rn(0.5f, r), 0.5f);
    const float step = fmaxf(__fdiv_rn(r, (float)TAP_RADIUS), 1.0f);
    const float x = __fmul_rn((float)(tid - TAP_RADIUS), step);
    s_off[tid] = x;
    s_w[tid] = expf(__fdiv_rn(__fmul_rn(-0.5f, __fmul_rn(x, x)),
                              __fmul_rn(sigma, sigma)));
  }
  __syncthreads();
  if (tid == 0) {
    float sum = 0.0f;
    for (int i = 0; i < TAPS; i++) sum = __fadd_rn(sum, s_w[i]);
    s_den = fmaxf(sum, 1e-5f);
  }
  __syncthreads();

  const int x = blockIdx.x * BLOCK_X + threadIdx.x;
  const int row = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= pw || row >= rows) return;
  const size_t pix = (size_t)row * pw + x;
  if (r <= 0.5f) {
    out[pix] = in[pix];
    return;
  }

  // the line the taps walk: a row of pw pixels, or a column of ph pixels of
  // this row's plane at stride pw
  const int n = VERTICAL ? ph : pw;
  const int at = VERTICAL ? row % ph : x;
  const float* line = VERTICAL ? in + (size_t)(row - at) * pw + x
                               : in + (size_t)row * pw;
  const size_t stride = VERTICAL ? pw : 1;
  const float coord = (float)at;

  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < TAPS; i++) {
    const float pos = __fadd_rn(coord, s_off[i]);
    const float p0 = floorf(pos);
    const float fr = __fsub_rn(pos, p0);
    const int i0 = min(max((int)p0, 0), n - 1);
    const int i1 = min(i0 + 1, n - 1);
    const float s0 = line[i0 * stride];
    const float s1 = line[i1 * stride];
    const float tap = __fadd_rn(__fmul_rn(s0, __fsub_rn(1.0f, fr)),
                                __fmul_rn(s1, fr));
    acc = __fadd_rn(acc, __fmul_rn(tap, s_w[i]));
  }
  out[pix] = __fdiv_rn(acc, s_den);
}

}  // namespace

// C entry point (bound with ctypes by ops/blur.py): one pass, along x
// (vertical == 0) or along y. in, out: (planes, ph, pw) f32, two distinct
// buffers; radius: one f32 on the device. Launches on `stream` and returns
// cudaGetLastError() as an int. A blur is two calls: in -> mid along x, then
// mid -> out along y.
extern "C" int figdraw_blur_pass(const float* in, float* out,
                                 const float* radius, int planes, int ph,
                                 int pw, int vertical, void* stream) {
  const int rows = planes * ph;
  if (rows <= 0 || pw <= 0) return 0;
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid((pw + BLOCK_X - 1) / BLOCK_X, (rows + BLOCK_Y - 1) / BLOCK_Y);
  cudaStream_t s = (cudaStream_t)stream;
  if (vertical)
    blur_pass_kernel<true><<<grid, block, 0, s>>>(in, out, radius, rows, ph, pw);
  else
    blur_pass_kernel<false><<<grid, block, 0, s>>>(in, out, radius, rows, ph, pw);
  return (int)cudaGetLastError();
}
