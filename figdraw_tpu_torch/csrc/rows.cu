// Row transform for NVIDIA Hopper (sm_90a): the per-frame geometry pass of a
// device-resident scene, over the packed upload rows (52 32-bit words a row,
// ops/layout.py).
//
// Replaces three XLA stages of figdraw_tpu/executor.py that the JAX package
// fuses into its view dispatch (no Pallas there): `animate_rows` (:805, the
// per-root affine p' = M p + t), `view_rows` (:761, the camera p' = z p + d)
// and the bbox test of `get_partial_patch_view_runner` (:1001-1014, a row
// whose bbox misses every damage rect gets an empty bbox and so bins into no
// tile). One launch runs the stages a frame asks for, in that order, out of
// place: the resident rows keep the snapshot's base geometry and the
// executor reads the transformed copy.
//
// What bounds it on this card: bytes, and few of them. Each row is read once
// and written once (2 x 208 B; 11.7 MB at 28k rows, a few microseconds of
// HBM time), the arithmetic is ~60 FP32 operations a row, so a launch costs
// about what launching it costs. The design is therefore the plainest one
// that is exact: one thread a row, the row held in registers as 13 16-byte
// words, no shared memory.
//
// Exactness is the point of the kernel:
//   * columns 16-21 (u8x4 colour words) and 50-51 (mode lanes) are integers
//     stored in float lanes. The row travels as raw 32-bit words and only the
//     geometry columns are ever reinterpreted as floats, so no lane is
//     canonicalised. Rows at or past n_quads (the meta tail: bitcast draw
//     bounds, blur radii, the clear colour) are copied word for word, and so
//     are rows with an empty bbox and rows outside every root span;
//   * every product, sum and quotient is rounded once, in the order of the
//     plain version (ops/rows.py), through __fmul_rn / __fadd_rn / __fsub_rn
//     / __fdiv_rn, which nvcc never contracts into a fused multiply-add. The
//     bit-exactness contracts (integer pans and zooms of integer scenes,
//     integer translations and power-of-two scales per root, equal to a walk
//     of the transformed scene) rest on that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_WORDS = 52;            // ops/layout.py PACKED_WIDTH
constexpr int ROW_VECS = ROW_WORDS / 4;  // 16-byte words a row
constexpr int THREADS = 128;

// packed columns (ops/layout.py; the rect-mask rows are logical 60-62 and
// 64-66 less the 18 columns the colour packing saves)
constexpr int INV_A = 0, INV_B = 1, INV_C = 2, INV_D = 3;
constexpr int ORG_X = 4, ORG_Y = 5;
constexpr int BB_X0 = 6, BB_Y0 = 7, BB_X1 = 8, BB_Y1 = 9;
constexpr int RM_AX = 42, RM_BX = 43, RM_TX = 44;
constexpr int RM_AY = 46, RM_BY = 47, RM_TY = 48;

constexpr int DAMAGE_RECTS = 4;
constexpr float DAMAGE_PAD = 2.0f;
constexpr float EMPTY_LO = 2e9f, EMPTY_HI = -2e9f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
// a * b + c * d, each step rounded
__device__ __forceinline__ float dot2(float a, float b, float c, float d) {
  return add(mul(a, b), mul(c, d));
}
__device__ __forceinline__ float min4(float a, float b, float c, float d) {
  return fminf(fminf(a, b), fminf(c, d));
}
__device__ __forceinline__ float max4(float a, float b, float c, float d) {
  return fmaxf(fmaxf(a, b), fmaxf(c, d));
}

__global__ void __launch_bounds__(THREADS)
rows_kernel(const uint4* __restrict__ in, uint4* __restrict__ out, int n_rows,
            int n_quads, const float* __restrict__ table,
            const int* __restrict__ ridx, const float* __restrict__ cam_d,
            const float* __restrict__ cam_z, const float* __restrict__ rects) {
  const int row = blockIdx.x * THREADS + threadIdx.x;
  if (row >= n_rows) return;
  const uint4* src = in + (size_t)row * ROW_VECS;
  uint4* dst = out + (size_t)row * ROW_VECS;

  uint32_t w[ROW_WORDS];
#pragma unroll
  for (int v = 0; v < ROW_VECS; v++) {
    const uint4 t = src[v];
    w[4 * v + 0] = t.x;
    w[4 * v + 1] = t.y;
    w[4 * v + 2] = t.z;
    w[4 * v + 3] = t.w;
  }

  if (row < n_quads) {
#define F(c) __uint_as_float(w[c])
#define SET(c, val) w[c] = __float_as_uint(val)
    // 1. the per-root affine (animate_rows): live rows inside a root span
    if (table != nullptr) {
      const int slot = ridx[row];
      const bool live = F(BB_X1) > F(BB_X0) && F(BB_Y1) > F(BB_Y0);
      if (live && slot >= 0) {
        const float* m = table + (size_t)slot * 6;
        const float a = m[0], b = m[1], c = m[2], d = m[3];
        const float tx = m[4], ty = m[5];
        const float det = sub(mul(a, d), mul(b, c));
        const float ia = quo(d, det), ib = quo(-b, det);
        const float ic = quo(-c, det), id = quo(a, det);
        // INV' = INV M^-1
        const float n0 = dot2(F(INV_A), ia, F(INV_B), ic);
        const float n1 = dot2(F(INV_A), ib, F(INV_B), id);
        const float n2 = dot2(F(INV_C), ia, F(INV_D), ic);
        const float n3 = dot2(F(INV_C), ib, F(INV_D), id);
        // org' = M org + t
        const float n4 = add(dot2(a, F(ORG_X), b, F(ORG_Y)), tx);
        const float n5 = add(dot2(c, F(ORG_X), d, F(ORG_Y)), ty);
        // bbox: the box of the four mapped corners; the translation comes
        // after the min/max so an integer translation stays exact
        const float x00 = dot2(a, F(BB_X0), b, F(BB_Y0));
        const float x01 = dot2(a, F(BB_X0), b, F(BB_Y1));
        const float x10 = dot2(a, F(BB_X1), b, F(BB_Y0));
        const float x11 = dot2(a, F(BB_X1), b, F(BB_Y1));
        const float y00 = dot2(c, F(BB_X0), d, F(BB_Y0));
        const float y01 = dot2(c, F(BB_X0), d, F(BB_Y1));
        const float y10 = dot2(c, F(BB_X1), d, F(BB_Y0));
        const float y11 = dot2(c, F(BB_X1), d, F(BB_Y1));
        const float n6 = add(min4(x00, x01, x10, x11), tx);
        const float n8 = add(max4(x00, x01, x10, x11), tx);
        const float n7 = add(min4(y00, y01, y10, y11), ty);
        const float n9 = add(max4(y00, y01, y10, y11), ty);
        // rect-mask rows: mat' = mat M^-1, t' = t - mat' t
        const float mxa = dot2(F(RM_AX), ia, F(RM_BX), ic);
        const float mxb = dot2(F(RM_AX), ib, F(RM_BX), id);
        const float mya = dot2(F(RM_AY), ia, F(RM_BY), ic);
        const float myb = dot2(F(RM_AY), ib, F(RM_BY), id);
        const float ntx = sub(F(RM_TX), dot2(mxa, tx, mxb, ty));
        const float nty = sub(F(RM_TY), dot2(mya, tx, myb, ty));
        SET(INV_A, n0); SET(INV_B, n1); SET(INV_C, n2); SET(INV_D, n3);
        SET(ORG_X, n4); SET(ORG_Y, n5);
        SET(BB_X0, n6); SET(BB_Y0, n7); SET(BB_X1, n8); SET(BB_Y1, n9);
        SET(RM_AX, mxa); SET(RM_BX, mxb); SET(RM_AY, mya); SET(RM_BY, myb);
        SET(RM_TX, ntx); SET(RM_TY, nty);
      }
    }

    // 2. the camera (view_rows): live rows, after the affine
    const float z = cam_z[0], dx = cam_d[0], dy = cam_d[1];
    if (F(BB_X1) > F(BB_X0) && F(BB_Y1) > F(BB_Y0)) {
      const float linv = quo(1.0f, z);
      // the rect-mask translations use the rows before they are scaled
      const float ntx = add(F(RM_TX), mul(-dot2(F(RM_AX), dx, F(RM_BX), dy), linv));
      const float nty = add(F(RM_TY), mul(-dot2(F(RM_AY), dx, F(RM_BY), dy), linv));
      SET(RM_TX, ntx);
      SET(RM_TY, nty);
      SET(INV_A, mul(F(INV_A), linv)); SET(INV_B, mul(F(INV_B), linv));
      SET(INV_C, mul(F(INV_C), linv)); SET(INV_D, mul(F(INV_D), linv));
      SET(RM_AX, mul(F(RM_AX), linv)); SET(RM_BX, mul(F(RM_BX), linv));
      SET(RM_AY, mul(F(RM_AY), linv)); SET(RM_BY, mul(F(RM_BY), linv));
      SET(ORG_X, add(mul(F(ORG_X), z), dx)); SET(ORG_Y, add(mul(F(ORG_Y), z), dy));
      SET(BB_X0, add(mul(F(BB_X0), z), dx)); SET(BB_Y0, add(mul(F(BB_Y0), z), dy));
      SET(BB_X1, add(mul(F(BB_X1), z), dx)); SET(BB_Y1, add(mul(F(BB_Y1), z), dy));
    }

    // 3. the damage clip: every quad row whose bbox misses every rect
    if (rects != nullptr) {
      bool keep = false;
#pragma unroll
      for (int r = 0; r < DAMAGE_RECTS; r++) {
        const float rx0 = sub(add(mul(rects[4 * r + 0], z), dx), DAMAGE_PAD);
        const float ry0 = sub(add(mul(rects[4 * r + 1], z), dy), DAMAGE_PAD);
        const float rx1 = add(add(mul(rects[4 * r + 2], z), dx), DAMAGE_PAD);
        const float ry1 = add(add(mul(rects[4 * r + 3], z), dy), DAMAGE_PAD);
        keep |= F(BB_X0) <= rx1 && F(BB_X1) >= rx0 && F(BB_Y0) <= ry1 &&
                F(BB_Y1) >= ry0;
      }
      if (!keep) {
        SET(BB_X0, EMPTY_LO); SET(BB_Y0, EMPTY_LO);
        SET(BB_X1, EMPTY_HI); SET(BB_Y1, EMPTY_HI);
      }
    }
#undef F
#undef SET
  }

#pragma unroll
  for (int v = 0; v < ROW_VECS; v++)
    dst[v] = make_uint4(w[4 * v + 0], w[4 * v + 1], w[4 * v + 2], w[4 * v + 3]);
}

}  // namespace

// C entry point (bound with ctypes by ops/rows.py). in / out: (n_rows, 52)
// f32, 16-byte aligned, not overlapping; rows [0, n_quads) are quads, the
// rest is copied. table (R + 1, 6) f32 and ridx (n_quads,) i32 with values
// in [-1, R], or both null (no per-root affine); cam_d (2,) f32 and cam_z
// (1,) f32, the camera; rects (4, 4) f32 scene-space damage rects (unused
// slots inverted) or null. All on the device. Launches on `stream` and
// returns cudaGetLastError() as an int.
extern "C" int figdraw_rows(const void* in, void* out, int n_rows, int n_quads,
                            const float* table, const int* ridx,
                            const float* cam_d, const float* cam_z,
                            const float* rects, void* stream) {
  if (n_rows <= 0) return 0;
  const int blocks = (n_rows + THREADS - 1) / THREADS;
  rows_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)in, (uint4*)out, n_rows, n_quads, table, ridx, cam_d, cam_z,
      rects);
  return (int)cudaGetLastError();
}
