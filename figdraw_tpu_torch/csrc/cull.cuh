// Per-block bbox culling and asynchronous staging of binned quad rows,
// shared by the tile rasterizer (raster.cu) and the megakernel (mega.cu).
//
// A 16x16-pixel block walks a list of quad indices in chunks of CHUNK
// entries. One warp tests a chunk: each lane loads one entry's bbox (fields
// 6-9, 16 B straight from global memory), widened by CULL_MARGIN, against
// the block's pixel-center rectangle; __ballot_sync marks the survivors and
// each takes the slot __popc of the lower lanes gives, so the survivors
// keep their list order. The survivor's lane copies its 272-byte row with
// 17 cp.async of 16 B into a Stage. Two Stages make a double buffer: the
// next chunk is tested and copied while the block evaluates the current
// one, behind one barrier a chunk.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sdf.cuh"

namespace figdraw {

constexpr int CHUNK = 32;  // list entries one warp tests and stages at once
constexpr int ROW_PIECES = QF_WIDTH / 4;  // 16-byte pieces of a row
constexpr int QF_BBOX_X0 = 6;  // bbox (x0, y0, x1, y1), fields 6-9
// widening of a quad's bbox in the cull test, in pixels (ops/raster.py
// CULL_MARGIN)
constexpr float CULL_MARGIN = 1.0f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One staging buffer: the surviving quads' rows and mode words, in draw
// order, and how many there are. 16-byte aligned, as are its rows (272 B).
struct __align__(16) Stage {
  float fields[CHUNK * QF_WIDTH];
  int modes[CHUNK * 2];
  int count;
};

// Run by one warp: test the list entries [base, base + n) against the
// block's pixel-center rectangle [cx0, cx1] x [cy0, cy1], write the
// survivors' mode words and count, and start the copies of their rows (one
// cp.async group; the caller waits for it before the block barrier).
// KEEP_PLANE0_WRITES (the megakernel's tapes): an entry whose mode lane
// targets plane 0 (bits 16+ == 1) survives whatever its bbox. The
// megakernel's write clamp sends it to plane 1 with plane 0 as its source,
// so it changes plane 1 outside its bbox too.
template <bool KEEP_PLANE0_WRITES = false>
__device__ __forceinline__ void stage_chunk(Stage& st, const float* fields,
                                            const int* modes, const int* list,
                                            int base, int n, float cx0,
                                            float cx1, float cy0, float cy1,
                                            int lane) {
  int q = 0;
  bool keep = false;
  if (lane < n) {
    q = list[base + lane];
    // fields 6-9 of a 272-byte row start 24 bytes in: two 8-byte loads
    const float2* bb = reinterpret_cast<const float2*>(
        fields + (size_t)q * QF_WIDTH + QF_BBOX_X0);
    const float2 lo = bb[0], hi = bb[1];
    keep = lo.x - CULL_MARGIN <= cx1 && hi.x + CULL_MARGIN >= cx0 &&
           lo.y - CULL_MARGIN <= cy1 && hi.y + CULL_MARGIN >= cy0;
    if (KEEP_PLANE0_WRITES) keep |= ((unsigned)modes[2 * q] >> 16) == 1u;
  }
  const unsigned kept = __ballot_sync(FULL, keep);
  if (keep) {
    const int slot = __popc(kept & ((1u << lane) - 1u));
    const float4* src =
        reinterpret_cast<const float4*>(fields + (size_t)q * QF_WIDTH);
    float4* dst = reinterpret_cast<float4*>(st.fields + slot * QF_WIDTH);
#pragma unroll
    for (int k = 0; k < ROW_PIECES; ++k) cp_async16(dst + k, src + k);
    const int2 md = reinterpret_cast<const int2*>(modes)[q];
    st.modes[2 * slot] = md.x;
    st.modes[2 * slot + 1] = md.y;
  }
  if (lane == 0) st.count = __popc(kept);
  cp_async_commit();
}

}  // namespace figdraw
