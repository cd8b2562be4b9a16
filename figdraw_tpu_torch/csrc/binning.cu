// The frame's device front end for NVIDIA Hopper (sm_90a): the wire decode
// and the tile binning, the per-tile draw-ordered lists of the quads whose
// bbox meets each tile with the occlusion and saturation culls of the
// frame's draw runs.
//
// Replaces two XLA stages of the JAX package (no Pallas there):
// figdraw_tpu/executor.py `unpack_combo_device` (:181), the wire decode, and
// figdraw_tpu/ops/binning.py `bin_quads` (:35): a (T, N) intersection mask,
// the cover tests, a whole-row suffix sum of log2 transmittance and one
// argsort per tile row.
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
// Tile row ty spans the global rows [row0 + ty tile_h, row0 + (ty+1)
// tile_h): row0 is the band origin of bin_quads' y_offset (binning.py:36,
// :73), nonzero when the tiles cover one row band of a frame split over
// several devices (parallel/sharding.py), 0 for a whole frame.
//
// What bounds it on this card: bytes. The lists alone are T x N x 4 bytes
// (66.8 MB at N = 32769, T = 510: 0.020 ms at 3.35 TB/s) and the decoded
// fields N x 280 bytes. The design:
//   * the front kernel, one launch an executor run, reads each packed
//     208-byte row once. A block stages 128 rows in shared memory with
//     contiguous 16-byte loads; its first 128 threads write the rows' fields
//     and modes as contiguous 16-byte and 8-byte stores (the colour bytes
//     through a k/255 table the block builds), while the other 128, a thread
//     a row, compute what the tiles need (decode.cuh): the bbox's tile range
//     as four int16, from which the quad's bit is set in each tile it meets
//     (a (T, N/32) bit array; a block gathers its rows' words of every tile
//     in shared memory and writes them whole, and a warp deals its (quad,
//     tile) pairs out over its lanes, so a quad that meets every tile costs
//     its warp T/32 steps; in all about one shared-memory atomic a pair that
//     meets, where a tile reading every quad's bbox costs T x N reads), and
//     with culling the cover rectangle's tile range with (lt, opaque) (16 B).
//     A prepass kernel does the same from decoded fields for bin_quads;
//   * the tile kernel, one block a tile, in four phases:
//       1. overlap: the tile's bits, N/8 bytes, read once and masked to the
//          window;
//       2. culls: one lower bound per run. The above-stack only falls as i
//          goes back through a run (every term is <= 0), so the kept quads of
//          run r are i >= its last opaque cover or, with saturation, i >= j*,
//          the last cover whose stack from itself on is under LOG2_SAT_EPS
//          (an opaque cover's lt is -24, so j* is at or after the last opaque
//          cover). Only covers matter, and a cover of a tile meets it, so the
//          walk visits the set bits only: a thread a word, the run's words
//          from its end back, THREADS words a chunk, a block scan of the
//          words' sums for the carry, stopping at the first chunk that
//          settles it. A quad whose cover range is not inside its bbox range
//          (none of the walks') sets a flag in the front kernel, and the walk
//          then visits every quad of the run;
//       3. apply the bounds to the set bits and count each warp's words;
//       4. write: kept quad i to prefix(i), any other to count + (i -
//          prefix(i)), the plain argsort's permutation, a warp's words in
//          order, so each store of a warp is one or two contiguous runs.
//
// Exactness: the fields and modes equal the plain decode's as 32-bit words,
// and the lists and counts are integers equal to the plain version's. The
// cover test is float, so the terms round each step once in the plain
// version's order (decode.cuh). The saturation sum cannot be bit-equal
// (another summation order, log2f against torch.log2), so a quad whose
// within-run above-stack lies within rounding of LOG2_SAT_EPS may fall on
// either side; the checks (ops/binning.bin_quads_model's borderline mask)
// count such quads and leave them out.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "decode.cuh"

namespace {

using namespace figdraw;

constexpr int THREADS = 512;  // the tile kernel's block
constexpr int WARPS = THREADS / 32;
constexpr int PREP_THREADS = 256;
constexpr int FRONT_ROWS = 128;  // rows of a front-kernel block
constexpr int FRONT_THREADS = 2 * FRONT_ROWS;  // the decode's, then the terms'
constexpr int ROW_VECS = PACKED_WIDTH / 4;  // 16-byte words of a packed row
constexpr int FIELD_VECS = QF_WIDTH / 4;    // 16-byte words of a field row
constexpr int STAGE_WORDS = FRONT_ROWS / 32;  // a front-kernel block's words of a tile
// the most tiles whose words a front-kernel block stages in shared memory
// (64 KB); past it the bits are ORed in device memory
constexpr int MAX_STAGED_TILES = 4096;
constexpr int MAX_RUNS = 64;  // ops/binning.py MAX_RUNS
constexpr int MAX_QUADS = 1 << 20;  // ops/binning.py MAX_QUADS: kept bits in shared memory
constexpr int SMEM_BITS_BYTES = MAX_QUADS / 8;
constexpr unsigned FULL = 0xffffffffu;

// The tiles; tile row 0 starts at global row row0 (a band origin).
struct Grid {
  int tiles_x, tiles_y, tile_w, tile_h;
  double inv_w, inv_h;  // 1 / tile size when that is exact, else 0
  int row0;
};

// What the front end writes for the tile kernel, in the caller's scratch
// (scratch_terms): CoverTerm cov[n] (with culling), the tiles' overlap bits
// (n_tiles, words) u32 (words = ceil(n / 128) * 4, so that a tile's row
// starts at 16 bytes), and the `outside` flag.
struct Terms {
  CoverTerm* cov;
  unsigned* bits;
  int* outside;
  int words;
};

// A warp's rows' bits in the tiles their bbox ranges name, the (row, tile)
// pairs dealt out over the lanes so that a row that meets many tiles (a
// backdrop, a full-frame quad) does not hold its warp: lane l holds row
// 32 w + l and its range r (empty for no row). Each pair sets bit l of word
// w of the tile: into `stage` (the block's words of each tile in shared
// memory, STAGE_WORDS a tile; w_local the warp's word there) where given,
// else into the tiles' bits in device memory. Called by all 32 lanes.
__device__ __forceinline__ void scatter_bits(short4 r, int w, Terms t, const Grid& g,
                                             unsigned* stage, int w_local) {
  const int lane = threadIdx.x & 31;
  const int width = r.z - r.x + 1;
  const int pairs = r.x <= r.z && r.y <= r.w ? width * (r.w - r.y + 1) : 0;
  int incl = pairs;  // the pairs of lanes 0..lane
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += u;
  }
  const int total = __shfl_sync(FULL, incl, 31);
  const int excl = incl - pairs;
  const int x0 = r.x, y0 = r.y;
  for (int base = 0; base < total; base += 32) {
    const int p = base + lane;
    // the lane whose pairs hold p: the first with incl > p
    int j = 0;
#pragma unroll
    for (int step = 16; step >= 1; step >>= 1)
      if (__shfl_sync(FULL, incl, j + step - 1) <= p) j += step;
    const int jw = __shfl_sync(FULL, width, j), jx = __shfl_sync(FULL, x0, j);
    const int jy = __shfl_sync(FULL, y0, j), at = p - __shfl_sync(FULL, excl, j);
    if (p < total) {
      const int tile = (jy + at / jw) * g.tiles_x + jx + at % jw;
      if (stage != nullptr)
        atomicOr(stage + tile * STAGE_WORDS + w_local, 1u << j);
      else
        atomicOr(t.bits + (size_t)tile * t.words + w, 1u << j);
    }
  }
}

// Row i's terms, by all 32 lanes of a warp over 32 aligned rows (valid:
// the lane holds a row): its bits (scatter_bits), and with culling its
// cover terms.
__device__ __forceinline__ void store_terms(const QuadIn& q, bool valid, int i, Terms t,
                                            const Grid& g, bool cull, unsigned* stage,
                                            int i0) {
  const short4 r = valid ? bbox_tiles(q, g.tiles_x, g.tiles_y, g.tile_w, g.tile_h, g.inv_w,
                                      g.inv_h, (double)g.row0)
                         : make_short4(1, 1, 0, 0);
  scatter_bits(r, i >> 5, t, g, stage, (i - i0) >> 5);
  if (!cull || !valid) return;
  const CoverTerm c = cover_term(q, g.tiles_x, g.tiles_y, g.tile_w, g.tile_h, g.inv_w,
                                 g.inv_h, (double)g.row0);
  t.cov[i] = c;
  if (cover_outside(c.range, r)) atomicOr(t.outside, 1);
}

// MODE 0: the decode alone; 1: the decode and the overlap bits; 2: the
// decode, the bits and the cover terms. Threads [0, FRONT_ROWS) write the
// fields and modes, threads [FRONT_ROWS, 2 FRONT_ROWS) the terms, a row
// each. STAGED: the block gathers its rows' bits of every tile in shared
// memory (STAGE_WORDS words a tile) and writes them whole as one 16-byte
// store a tile, with no atomic in device memory (the tiles' bits then need
// no zeroing); else the bits are ORed into the zeroed bits in device memory.
template <int MODE, bool STAGED>
__global__ void __launch_bounds__(FRONT_THREADS)
front_kernel(const float4* __restrict__ packed, int n, float4* __restrict__ fields,
             int2* __restrict__ modes, Terms terms, Grid grid) {
  __shared__ float4 s_rows[FRONT_ROWS * ROW_VECS];
  __shared__ float s_unit[256];  // k / 255
  extern __shared__ uint4 s_stage[];  // STAGED: the block's words of each tile
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * FRONT_ROWS;
  const int rows = min(FRONT_ROWS, n - row0);
  const int n_tiles = grid.tiles_x * grid.tiles_y;
  const float4* src = packed + (size_t)row0 * ROW_VECS;
  constexpr int PER = (FRONT_ROWS * ROW_VECS + FRONT_THREADS - 1) / FRONT_THREADS;
  float4 v[PER];
#pragma unroll
  for (int u = 0; u < PER; u++) {
    const int q = tid + u * FRONT_THREADS;
    if (q < rows * ROW_VECS) v[u] = src[q];
  }
#pragma unroll
  for (int u = 0; u < PER; u++) {
    const int q = tid + u * FRONT_THREADS;
    if (q < rows * ROW_VECS) s_rows[q] = v[u];
  }
  if (tid < 256) s_unit[tid] = __fdiv_rn((float)tid, 255.0f);
  if (STAGED)
    for (int q = tid; q < n_tiles; q += FRONT_THREADS) s_stage[q] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const float* s = reinterpret_cast<const float*>(s_rows);
  if (tid < FRONT_ROWS) {
    float4* dst = fields + (size_t)row0 * FIELD_VECS;
    for (int q = tid; q < rows * FIELD_VECS; q += FRONT_ROWS) {
      const int r = q / FIELD_VECS, c = q - r * FIELD_VECS;  // field columns 4c..4c+3
      const float* p = s + r * PACKED_WIDTH;
      float4 out;
      if (c < 4) {
        out = s_rows[r * ROW_VECS + c];
      } else if (c < 10) {  // one colour word, bytes 0-3
        const unsigned w = __float_as_uint(p[PACKED_COLOR_WORDS + c - 4]);
        out = make_float4(s_unit[w & 255u], s_unit[(w >> 8) & 255u], s_unit[(w >> 16) & 255u],
                          s_unit[w >> 24]);
      } else {
        const float* t = p + 4 * c - FIELDS_TAIL + PACKED_TAIL;
        out = make_float4(t[0], t[1], t[2], t[3]);
      }
      dst[q] = out;
    }
    if (tid < rows) {
      const float* p = s + tid * PACKED_WIDTH;
      modes[row0 + tid] =
          make_int2(__float_as_int(p[PACKED_MODES]), __float_as_int(p[PACKED_MODES + 1]));
    }
  } else if (MODE > 0) {
    const int r = tid - FRONT_ROWS;
    const bool valid = r < rows;
    store_terms(quad_from_packed(s + min(r, rows - 1) * PACKED_WIDTH, s_unit), valid,
                row0 + r, terms, grid, MODE == 2,
                STAGED ? reinterpret_cast<unsigned*>(s_stage) : nullptr, row0);
  }
  if (STAGED && MODE > 0) {
    __syncthreads();
    uint4* bits4 = reinterpret_cast<uint4*>(terms.bits);
    const int stride = terms.words / STAGE_WORDS;
    for (int q = tid; q < n_tiles; q += FRONT_THREADS)
      bits4[(size_t)q * stride + blockIdx.x] = s_stage[q];
  }
}

// The same terms from decoded fields (bin_quads): a thread a row.
template <bool CULL>
__global__ void __launch_bounds__(PREP_THREADS)
prep_kernel(const float* __restrict__ fields, const int* __restrict__ modes, int n,
            Terms terms, Grid grid) {
  const int i = blockIdx.x * PREP_THREADS + threadIdx.x;
  const int row = min(i, n - 1);  // whole warps, each over 32 aligned rows
  const QuadIn q =
      quad_from_fields(fields + (size_t)row * QF_WIDTH, CULL ? modes + 2 * row : nullptr);
  store_terms(q, i < n, i, terms, grid, CULL, nullptr, 0);
}

// the bits of word w that lie in [lo, hi)
__device__ __forceinline__ unsigned span_mask(int w, int lo, int hi) {
  const int base = w << 5;
  unsigned m = FULL;
  if (base < lo) m &= lo - base >= 32 ? 0u : FULL << (lo - base);
  if (base + 32 > hi) m &= hi - base <= 0 ? 0u : FULL >> (32 - (hi - base));
  return m;
}

// The lower bound of run [lo, hi) in tile (tx, ty): the last opaque cover,
// or with SATURATE j*, the last cover whose stack from itself on is under
// LOG2_SAT_EPS; -1 when there is none. bits: the tile's overlap bits (every
// quad of the run when `every`). Called by the whole block; uses s_f, s_i.
template <bool SATURATE>
__device__ int run_bound(const unsigned* bits, bool every, const CoverTerm* __restrict__ cov,
                         int lo, int hi, int tx, int ty, float* s_f, int* s_i) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (lo >= hi) return -1;
  const int w_first = lo >> 5, w_last = (hi - 1) >> 5;
  float carry = 0.0f;  // the stack of the chunks already walked
  for (int c_hi = w_last; c_hi >= w_first; c_hi -= THREADS) {
    const int w = c_hi - tid;  // thread 0 takes the last word of the chunk
    unsigned covering = 0;
    float sum = 0.0f;   // the word's covers' lt, from its last quad back
    int opaque = -1;    // the word's last opaque cover
    if (w >= w_first) {
      unsigned cand = (every ? FULL : bits[w]) & span_mask(w, lo, hi);
      while (cand) {
        const int b = 31 - __clz(cand);
        cand &= ~(1u << b);
        const int i = (w << 5) + b;
        const CoverTerm c = cov[i];
        if (in_range(c.range, tx, ty)) {
          covering |= 1u << b;
          sum += c.lt;
          if (c.opaque && opaque < 0) opaque = i;
        }
      }
    }
    int found;
    if (SATURATE) {
      // the stack of the words after this one: an exclusive scan over the
      // threads (thread 0 holds the chunk's last word)
      float v = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float u = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v += u;
      }
      if (lane == 31) s_f[warp] = v;
      __syncthreads();
      float before = carry, total = carry;
      for (int k = 0; k < WARPS; k++) {
        const float t = s_f[k];
        if (k < warp) before += t;
        total += t;
      }
      const float up = __shfl_up_sync(FULL, v, 1);
      float stack = before + (lane > 0 ? up : 0.0f);  // the covers of the words after w
      int cut = -1;
      for (unsigned m = covering; m;) {
        const int b = 31 - __clz(m);
        m &= ~(1u << b);
        stack += cov[(w << 5) + b].lt;
        if (!(stack >= LOG2_SAT_EPS)) {
          cut = (w << 5) + b;
          break;
        }
      }
      found = __reduce_max_sync(FULL, cut);
      carry = total;
    } else {
      found = __reduce_max_sync(FULL, opaque);
    }
    if (lane == 0) s_i[warp] = found;
    __syncthreads();
    found = -1;
    for (int k = 0; k < WARPS; k++) found = max(found, s_i[k]);
    __syncthreads();  // s_f and s_i are free again
    if (found >= 0) return found;
  }
  return -1;
}

// One block a tile. CULL: modes were given (runs, or the window as one
// run); SATURATE: the saturation tier. stop (measurement only): 1 ends
// after the overlap pass, 2 after the culls, 3 after the counts.
template <bool CULL, bool SATURATE>
__global__ void __launch_bounds__(THREADS, 2)
tiles_kernel(const unsigned* __restrict__ bits_g, const CoverTerm* __restrict__ cov,
             const int* __restrict__ outside, const int* __restrict__ start_p,
             const int* __restrict__ end_p, int start_v, int end_v,
             const int* __restrict__ runs, int n_runs, int n, int tiles_x, int bits_stride,
             int* __restrict__ tile_idx, int* __restrict__ tile_counts, int stop) {
  extern __shared__ unsigned s_bits[];  // one kept bit a quad
  __shared__ int s_lo[MAX_RUNS], s_hi[MAX_RUNS], s_bound[MAX_RUNS];
  __shared__ int s_wcount[WARPS];
  __shared__ float s_f[WARPS];
  __shared__ int s_i[WARPS];

  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = t % tiles_x, ty = t / tiles_x;
  const int start = start_p != nullptr ? *start_p : start_v;
  const int end = end_p != nullptr ? *end_p : end_v;
  const int w_lo = max(start, 0), w_hi = min(end, n);  // the window within the rows
  const int words = (n + 31) >> 5;

  // 1. overlap: the tile's bits within the window
  const unsigned* tile_bits = bits_g + (size_t)t * bits_stride;
  for (int w = tid; w < words; w += THREADS) s_bits[w] = tile_bits[w] & span_mask(w, w_lo, w_hi);
  if (CULL && tid < n_runs) {
    s_lo[tid] = runs != nullptr ? max(runs[2 * tid], w_lo) : w_lo;
    s_hi[tid] = runs != nullptr ? min(runs[2 * tid + 1], w_hi) : w_hi;
  }
  __syncthreads();
  if (stop == 1) return;

  // 2. culls: one lower bound a run
  if (CULL) {
    const bool every = *outside != 0;
    for (int r = 0; r < n_runs; r++) {
      const int b = run_bound<SATURATE>(s_bits, every, cov, s_lo[r], s_hi[r], tx, ty, s_f, s_i);
      if (tid == 0) s_bound[r] = b;
    }
    __syncthreads();
  }
  if (stop == 2) return;

  // 3. apply the bounds to the set bits, a lane a word of its warp's; count
  // each warp's words
  const int per = (words + WARPS - 1) / WARPS;
  const int wb = min(warp * per, words), we = min(wb + per, words);
  int count = 0;
  for (int w = wb + lane; w < we; w += 32) {
    unsigned bits = s_bits[w];
    if (CULL && bits != 0u) {
      // a quad of run r below its bound is dropped; the last run holding a
      // quad sets its cover, and with SATURATE every run holding it bounds
      // it (a run's bound is at or after its cover)
      unsigned keep = FULL;
      for (int r = 0; r < n_runs; r++) {
        const int lo = s_lo[r], hi = s_hi[r];
        const unsigned below = span_mask(w, lo, min(hi, s_bound[r]));
        if (SATURATE) {
          keep &= ~below;
        } else {
          const unsigned in_run = span_mask(w, lo, hi);
          keep = (keep & ~in_run) | (in_run & ~below);
        }
      }
      bits &= keep;
      s_bits[w] = bits;
    }
    count += __popc(bits);
  }
  count = __reduce_add_sync(FULL, count);
  if (lane == 0) s_wcount[warp] = count;
  __syncthreads();
  int base = 0, total = 0;
  for (int q = 0; q < WARPS; q++) {
    if (q == warp) base = total;
    total += s_wcount[q];
  }
  if (tid == 0) tile_counts[t] = total;
  if (stop == 3) return;

  // 4. write: kept quads at their prefix, the rest after them ascending
  const unsigned below_mask = (1u << lane) - 1u;
  int* out = tile_idx + (size_t)t * n;
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
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const int stage_bytes = MAX_STAGED_TILES * STAGE_WORDS * (int)sizeof(unsigned);
  err = cudaFuncSetAttribute(tiles_kernel<false, false>, a, SMEM_BITS_BYTES);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(tiles_kernel<true, false>, a, SMEM_BITS_BYTES);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(tiles_kernel<true, true>, a, SMEM_BITS_BYTES);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(front_kernel<1, true>, a, stage_bytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(front_kernel<2, true>, a, stage_bytes);
  if (err == cudaSuccess && cached) g_smem_opted_in[dev].store(true, std::memory_order_release);
  return err;
}

Grid make_grid(int tiles_y, int tiles_x, int tile_h, int tile_w, int row0) {
  // a power-of-two tile size has an exact reciprocal
  auto inv = [](int size) { return (size & (size - 1)) == 0 ? 1.0 / size : 0.0; };
  return Grid{tiles_x, tiles_y, tile_w, tile_h, inv(tile_w), inv(tile_h), row0};
}

Terms scratch_terms(void* scratch, int n, int n_tiles) {
  Terms t;
  t.words = (n + FRONT_ROWS - 1) / FRONT_ROWS * STAGE_WORDS;
  t.cov = reinterpret_cast<CoverTerm*>(scratch);
  t.bits = reinterpret_cast<unsigned*>(t.cov + n);
  t.outside = reinterpret_cast<int*>(t.bits + (size_t)n_tiles * t.words);
  return t;
}

// zeroes the flag, and the bits unless the front kernel stages them (one
// memset: they are adjacent)
cudaError_t clear_terms(Terms t, int n_tiles, bool bits, cudaStream_t s) {
  if (!bits) return cudaMemsetAsync(t.outside, 0, sizeof(int), s);
  return cudaMemsetAsync(t.bits, 0, ((size_t)n_tiles * t.words + 1) * sizeof(unsigned), s);
}

int launch_tiles(Terms t, bool cull, const int* start_p, const int* end_p, int start, int end,
                 const int* runs, int n_runs, int window_run, int n, int n_tiles, int tiles_x,
                 int saturate, int* tile_idx, int* tile_counts, cudaStream_t s, int stop) {
  cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return (int)err;
  if (window_run) {
    runs = nullptr;
    n_runs = 1;
  }
  const size_t smem = (size_t)((n + 31) >> 5) * sizeof(unsigned);
  if (!cull)
    tiles_kernel<false, false><<<n_tiles, THREADS, smem, s>>>(
        t.bits, t.cov, t.outside, start_p, end_p, start, end, nullptr, 0, n, tiles_x,
        t.words, tile_idx, tile_counts, stop);
  else if (!saturate)
    tiles_kernel<true, false><<<n_tiles, THREADS, smem, s>>>(
        t.bits, t.cov, t.outside, start_p, end_p, start, end, runs, n_runs, n, tiles_x,
        t.words, tile_idx, tile_counts, stop);
  else
    tiles_kernel<true, true><<<n_tiles, THREADS, smem, s>>>(
        t.bits, t.cov, t.outside, start_p, end_p, start, end, runs, n_runs, n, tiles_x,
        t.words, tile_idx, tile_counts, stop);
  return (int)cudaGetLastError();
}

bool bad_args(int n, int n_runs, int tiles_y, int tiles_x, int tile_h, int tile_w) {
  return n < 0 || n > MAX_QUADS || n_runs < 0 || n_runs > MAX_RUNS || tiles_x <= 0 ||
         tiles_y <= 0 || tiles_x > 32767 || tiles_y > 32767 || tile_h <= 0 || tile_w <= 0;
}

}  // namespace

// C entry points (bound with ctypes by ops/binning.py), each on `stream`.
// They return cudaGetLastError() as an int (cudaErrorInvalidValue for
// arguments out of range). scratch: 16 n + 16 n_tiles ceil(n / 128) + 4
// bytes of the device, 16-byte aligned (scratch_terms).

// The wire decode alone: packed (n, 52) f32 rows, 16-byte aligned ->
// fields (n, 68) f32 and modes (n, 2) i32.
extern "C" int figdraw_decode(const float* packed, int n, float* fields, int* modes,
                              void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Terms none = {nullptr, nullptr, nullptr, 0};
  front_kernel<0, false><<<(n + FRONT_ROWS - 1) / FRONT_ROWS, FRONT_THREADS, 0,
                    (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(packed), n, reinterpret_cast<float4*>(fields),
      reinterpret_cast<int2*>(modes), none, make_grid(1, 1, 1, 1, 0));
  return (int)cudaGetLastError();
}

// The front end of a frame: the decode fused with the binning's terms (one
// launch), then the tile kernel. cull != 0 culls (runs (n_runs, 2) i32 on
// the device, or window_run != 0 for the window as the one run); the window
// [start, end) from start_p / end_p (one i32 on the device each) where not
// null, else from start / end; tile row 0 at global row row0 (a band
// origin, 0 for a whole frame); tile_idx (tiles_y * tiles_x, n) i32 and
// tile_counts i32, written whole. stop: 0 (1-3 and 4, after the front
// kernel, only to time the phases).
extern "C" int figdraw_decode_and_bin(const float* packed, int n, float* fields, int* modes,
                                      const int* start_p, const int* end_p, int start,
                                      int end, int cull, const int* runs, int n_runs,
                                      int window_run, int tiles_y, int tiles_x, int tile_h,
                                      int tile_w, int row0, int saturate, void* scratch,
                                      int* tile_idx, int* tile_counts, void* stream,
                                      int stop) {
  if (bad_args(n, n_runs, tiles_y, tiles_x, tile_h, tile_w)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = tiles_y * tiles_x;
  const Terms t = scratch_terms(scratch, n, n_tiles);
  const bool staged = n_tiles <= MAX_STAGED_TILES;
  cudaError_t err = opt_in_smem();
  if (err == cudaSuccess) err = clear_terms(t, n_tiles, !staged || n == 0, s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int grid = (n + FRONT_ROWS - 1) / FRONT_ROWS;
    const float4* p = reinterpret_cast<const float4*>(packed);
    float4* f = reinterpret_cast<float4*>(fields);
    int2* m = reinterpret_cast<int2*>(modes);
    const Grid g = make_grid(tiles_y, tiles_x, tile_h, tile_w, row0);
    const size_t smem = staged ? (size_t)n_tiles * STAGE_WORDS * sizeof(unsigned) : 0;
    if (cull && staged)
      front_kernel<2, true><<<grid, FRONT_THREADS, smem, s>>>(p, n, f, m, t, g);
    else if (cull)
      front_kernel<2, false><<<grid, FRONT_THREADS, 0, s>>>(p, n, f, m, t, g);
    else if (staged)
      front_kernel<1, true><<<grid, FRONT_THREADS, smem, s>>>(p, n, f, m, t, g);
    else
      front_kernel<1, false><<<grid, FRONT_THREADS, 0, s>>>(p, n, f, m, t, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (stop == 4) return 0;
  return launch_tiles(t, cull != 0, start_p, end_p, start, end, runs, n_runs, window_run, n,
                      n_tiles, tiles_x, saturate, tile_idx, tile_counts, s, stop);
}

// One binning of decoded fields (bin_quads): the prepass, then the tile
// kernel. fields (n, 68) f32, modes (n, 2) i32 or null (no culling); the
// rest as figdraw_decode_and_bin.
extern "C" int figdraw_bin_quads(const float* fields, const int* modes, const int* start_p,
                                 const int* end_p, int start, int end, const int* runs,
                                 int n_runs, int window_run, int n, int tiles_y, int tiles_x,
                                 int tile_h, int tile_w, int row0, int saturate, void* scratch,
                                 int* tile_idx, int* tile_counts, void* stream) {
  if (bad_args(n, n_runs, tiles_y, tiles_x, tile_h, tile_w)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = tiles_y * tiles_x;
  const Terms t = scratch_terms(scratch, n, n_tiles);
  const bool cull = modes != nullptr;
  cudaError_t err = clear_terms(t, n_tiles, true, s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int grid = (n + PREP_THREADS - 1) / PREP_THREADS;
    const Grid g = make_grid(tiles_y, tiles_x, tile_h, tile_w, row0);
    if (cull)
      prep_kernel<true><<<grid, PREP_THREADS, 0, s>>>(fields, modes, n, t, g);
    else
      prep_kernel<false><<<grid, PREP_THREADS, 0, s>>>(fields, nullptr, n, t, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return launch_tiles(t, cull, start_p, end_p, start, end, runs, n_runs, window_run, n,
                      n_tiles, tiles_x, saturate, tile_idx, tile_counts, s, 0);
}
