// The score-and-select sweep of one query block over key tiles, shared by
// csrc/knn.cu, csrc/ring_knn.cu and csrc/knn_banded.cu (CUDA C++ for
// sm_90a; included, not built on its own).
//
// A block of NT = 256 threads owns QB = 128 consecutive query rows of one
// event. Scores are the augmented contraction of
// kernels/knn_cuda.py::build_augmented_operands,
//     s_ij = sum_c qa[i, c] * ka[j, c],
// each pair ONE fp32 fmaf chain from 0.f in ascending channel order on the
// CUDA cores (no TF32). So every kernel that sweeps with it gives the exact
// kernel's (csrc/knn.cu) bits, at any width: channels past C + 2 are zeros
// and fmaf(0, 0, acc) == acc, and the chunked layout below carries the same
// chain across its chunks.
//
// Layout and pipeline.
// - Channels are padded to a multiple of 4 (not 16), with zeros.
// - The block's query rows and each key tile live in shared memory
//   channel-major (row c holds channel c of every query or key), so a
//   thread reads 4 consecutive rows with one 128-bit load. Query rows are
//   LDQ = QB + 4 floats apart and key rows LDK = TB + 4: 4 (mod 32) banks,
//   so the staging copies (lane -> row lane / 8, channel lane % 8 + 8 i)
//   write 32 distinct banks, and each thread steps through its own rows'
//   channels by pointer increments.
// - Key tiles of TB = 64 keys are staged with 4-byte cp.async (zero-filled
//   past the edge) into a double buffer: tile m + 1 loads while tile m is
//   scored and selected.
// - Wide C. When the query block and two key tiles do not fit in shared
//   memory (C + 2 > 180), the sweep runs in steps of one key tile and one
//   chunk of CH channels (`sweep_chunk`: the widest multiple of 4 that fits
//   beside the score tile, the bars and the kernel's own bytes, 120 on an
//   H100): each step stages the query rows' chunk and the key tile's chunk
//   into one of two buffers while the other step's chunks are multiplied,
//   and the chunks of a tile add into the same registers in ascending
//   channel order, so a score's bits do not depend on CH. The query rows
//   are staged again for every key tile (from L2). Narrow C takes the
//   one-pass layout above, a separate instantiation (CHUNK = false).
// - Each thread scores an 8 x 4 micro-tile (rows ty*4 + {0..3} and
//   64 + ty*4 + {0..3}, keys tx*4 + {0..3}): per channel three 128-bit
//   shared loads, two of them broadcast within the warp, for 32 FMAs.
// - Filter. Each row's bar, its k-th entry (score and index), sits in
//   shared memory. Still in registers, a thread compares its 32 scores with
//   its rows' bar scores and flags every row where a score reaches its bar.
//   On the main path only a few percent of a tile's rows hold a winner, so
//   this replaces most of the warp's compare-and-ballot passes with a
//   compare a score. A flag may be false (a key out of the row's band, or a
//   tie that the index decides, or a key ahead of the row's ceiling): the
//   warp's exact test below settles it.
// - The 128 x 64 score tile goes to shared memory; then warp w takes the
//   flagged rows among 16 w .. 16 w + 15: for each it tests and ballots the
//   row's 64 columns exactly against the row's bar ((score, index) order,
//   the row's key range, and the row's ceiling if there is one); if any
//   wins, it inserts the winners into the row's list (warp_topk.cuh; the
//   lists stay in registers for the whole sweep, and a row's list is fetched
//   by a jump on the row and put back) and writes the row's new bar.
// - k > KMAX in passes. A list holds at most KMAX = 64 entries (two
//   registers a lane; more would spill at 16 rows a warp), so a larger k
//   runs as passes of the whole sweep: pass p keeps the next min(64, k -
//   64 p) entries, and a key may enter a row's list only behind the row's
//   ceiling, the last entry of pass p - 1 (CEIL = true; a (score, index)
//   pair a row in global memory). (score desc, index asc) is a strict total
//   order and every pass sees the same score bits, so the passes
//   concatenated are the top k.
// - The tensor-core score (TC = true; --knn_precision default, the TPU's
//   single bf16 pass). The operands are bf16 (kernels/knn_cuda.py::
//   tc_operand: build_augmented_operands rounded to nearest even, channels
//   padded with zeros to a multiple of 16), row-major with channels
//   contiguous, staged with 16-byte cp.async into rows SKEW_TC = 8 elements
//   longer than the staged channels (4 (mod 8) words apart, so the fragment
//   loads of a warp's 8 rows hit 32 banks). Warp w scores its own 16 query
//   rows against the tile's 64 keys with mma.sync.m16n8k16 (bf16 x bf16 ->
//   fp32): 8 n8 tiles of 4 accumulators a thread, the 32 scores a thread
//   holds in the fp32 path, in the fragment layout (rows g = lane / 4 and g
//   + 8 of the warp's 16, keys 8 n + 2 t and + 1, t = lane % 4). The K loop
//   runs over the channels in steps of 16 into the same accumulators, so a
//   pair's score is one fixed sequence of mma steps in ascending channel
//   order: chunks of a multiple of 16 channels (past the one-pass width,
//   `sweep_chunk_tc`) and the kernel that sweeps (exact, ring, banded) do
//   not change its bits. Products of bf16 values are exact in fp32; the
//   tensor core's fp32 sums are not the CUDA cores' fmaf chain, so a TC
//   score agrees with the plain version (an fp32 matmul of the same bf16
//   operands) only to within a few units of its last place, and its graph
//   with the plain one's only up to near ties. The filter, the score tile
//   in shared memory, the selection and the passes are the fp32 path's.
// Two __syncthreads a tile (a step, chunked): one before the tile is read
// (its copies have landed, and the previous tile's selection and product
// are done, so the next prefetch, the score tile, the bars and the flags
// may be written), one before the selection reads the score tile and the
// flags.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "warp_topk.cuh"

namespace dgcnn {

constexpr int QB = 128;              // queries per block
constexpr int TB = 64;               // keys per tile
constexpr int NT = 256;              // threads per block
constexpr int NWARP = NT / 32;
constexpr int ROWS = QB / NWARP;     // query rows each warp selects for
constexpr int CPAD = 4;              // channels are padded to a multiple of this
constexpr int LDQ = QB + 4;          // floats between query channel rows
constexpr int LDK = TB + 4;          // floats between key channel rows
constexpr int LDS = TB + 4;          // floats between score tile rows
constexpr int KMAX = 64;             // entries a pass: two list registers a lane
constexpr int SMEM_LIMIT = 232448;   // shared memory a block may use (sm_90)

static_assert(NT == 256 && QB == 128 && TB == 64, "16 x 16 threads, 8 x 4 scores each");
static_assert(ROWS * NWARP == QB && ROWS <= 32 && TB % 32 == 0,
              "whole rows a warp, a lane a row, whole lane-passes a tile");
static_assert(ROWS == 16, "DGCNN_ROWS lists every row of a warp");

// X(u) for every row u of a warp
#define DGCNN_ROWS(X) \
  X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15)

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

constexpr float INVALID_BELOW = -1e29f;  // a slot scoring at or below it holds a masked key

// dynamic shared memory of a block of the one-pass layout: the query rows
// [c2p][LDQ], two key tiles [c2p][LDK], the score tile [QB][LDS], the rows'
// bars (score [QB] and index [QB]) and flags [QB]
__host__ __device__ inline size_t sweep_smem_bytes(int c2) {
  const size_t c2p = (size_t)round_up(c2, CPAD);
  return (c2p * LDQ + 2 * c2p * LDK + (size_t)QB * LDS + 3 * QB) * sizeof(float);
}

// dynamic shared memory of the chunked layout: two buffers of a query chunk
// [ch][LDQ] and a key chunk [ch][LDK], then the score tile, bars and flags
__host__ __device__ inline size_t chunk_smem_bytes(int ch) {
  return (2 * (size_t)ch * (LDQ + LDK) + (size_t)QB * LDS + 3 * QB) * sizeof(float);
}

// The channel chunk CH of a sweep over C + 2 = c2 channels beside `extra`
// bytes of the kernel's own shared memory: 0 where the one-pass layout
// fits, else the widest multiple of CPAD whose chunked layout fits.
inline int sweep_chunk(int c2, size_t extra) {
  if (sweep_smem_bytes(c2) + extra <= (size_t)SMEM_LIMIT) return 0;
  int ch = CPAD;
  while (chunk_smem_bytes(ch + CPAD) + extra <= (size_t)SMEM_LIMIT) ch += CPAD;
  return ch;
}

// the dynamic shared memory of a launch with chunk ch (0: one pass)
inline size_t sweep_bytes(int c2, int ch) {
  return ch ? chunk_smem_bytes(ch) : sweep_smem_bytes(c2);
}

// The tensor-core path (TC): bf16 operands, channels padded to a multiple
// of CPAD_TC (one mma k-step) by the wrapper; staged rows are SKEW_TC
// elements longer than their channels.
constexpr int CPAD_TC = 16;
constexpr int SKEW_TC = 8;

// the element type of a sweep's operands
template <bool TC>
using elem_t = std::conditional_t<TC, uint16_t, float>;

// dynamic shared memory of a TC sweep over c2 (a multiple of CPAD_TC)
// channels: the query rows [QB][c2 + SKEW_TC] and two key tiles [TB][c2 +
// SKEW_TC] of bf16, or (ch > 0, chunked) two buffers of a query chunk and a
// key chunk of ch channels; then the score tile, bars and flags
inline size_t sweep_bytes_tc(int c2, int ch) {
  const size_t tail = ((size_t)QB * LDS + 3 * QB) * sizeof(float);
  if (ch) return 2 * (size_t)(QB + TB) * (ch + SKEW_TC) * sizeof(uint16_t) + tail;
  return (size_t)(QB + 2 * TB) * (c2 + SKEW_TC) * sizeof(uint16_t) + tail;
}

// the channel chunk of a TC sweep beside `extra` bytes: 0 where the one-
// pass layout fits, else the widest multiple of CPAD_TC that fits
inline int sweep_chunk_tc(int c2, size_t extra) {
  if (sweep_bytes_tc(c2, 0) + extra <= (size_t)SMEM_LIMIT) return 0;
  int ch = CPAD_TC;
  while (sweep_bytes_tc(c2, ch + CPAD_TC) + extra <= (size_t)SMEM_LIMIT) ch += CPAD_TC;
  return ch;
}

template <bool TC>
inline int chunk_of(int c2, size_t extra) {
  return TC ? sweep_chunk_tc(c2, extra) : sweep_chunk(c2, extra);
}

template <bool TC>
inline size_t bytes_of(int c2, int ch) {
  return TC ? sweep_bytes_tc(c2, ch) : sweep_bytes(c2, ch);
}

// Calls f(tc) with a std::integral_constant<bool>: the fp32 or the
// tensor-core instantiation.
template <class F>
inline int with_precision(bool tc, F f) {
  return tc ? f(std::true_type{}) : f(std::false_type{});
}

// Calls f(ks, chunk, ceil) with std::integral_constant arguments: the
// instantiation of a sweep kernel for a pass of k entries (KS = 1 list
// register a lane for k <= 32, else 2), the chunked layout or not, with a
// ceiling or without.
template <class F>
inline int with_variant(int k, bool chunk, bool ceil, F f) {
  using Y = std::true_type;
  using N = std::false_type;
  using K1 = std::integral_constant<int, 1>;
  using K2 = std::integral_constant<int, 2>;
  if (k <= 32) {
    if (chunk) return ceil ? f(K1{}, Y{}, Y{}) : f(K1{}, Y{}, N{});
    return ceil ? f(K1{}, N{}, Y{}) : f(K1{}, N{}, N{});
  }
  if (chunk) return ceil ? f(K2{}, Y{}, Y{}) : f(K2{}, Y{}, N{});
  return ceil ? f(K2{}, N{}, Y{}) : f(K2{}, N{}, N{});
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// 16 bytes, zero-filled when !ok (src must then still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// stage rows [r0, r0 + R) of src (row-major, `stride` floats a row) channel-
// major into dst [cw][LD]: channels [0, cw) of src's rows, those at or past
// `cvalid` and rows at or past `rend` as zeros.
// Thread: rows 4 warp + lane / 8 + 32 h, channels lane % 8 + 8 i.
template <int R, int LD>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0, int rend, int stride,
                                      int cvalid, int cw) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < R / (NWARP * 4); ++h) {
    const int rr = (threadIdx.x >> 5) * 4 + (lane >> 3) + h * NWARP * 4;
    const bool row_ok = r0 + rr < rend;
    const float* s = src + (size_t)(row_ok ? r0 + rr : 0) * stride;
    for (int c = lane & 7; c < cw; c += 8) {
      const bool ok = row_ok && c < cvalid;
      cp_async4(dst + c * LD + rr, ok ? s + c : src, ok);
    }
  }
}

// add the products of the staged queries' and keys' first cw channels to
// this thread's 8 x 4 scores, channel by channel in ascending order
__device__ __forceinline__ void accumulate(float (&acc)[8][4], const float* qs, const float* kb,
                                           int cw) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float* qp = qs + ty * 4;
  const float* kp = kb + tx * 4;
#pragma unroll 2
  for (int c0 = 0; c0 < cw; c0 += CPAD) {
#pragma unroll
    for (int cc = 0; cc < CPAD; ++cc) {
      const int c = c0 + cc;
      const float4 a0 = *reinterpret_cast<const float4*>(qp + c * LDQ);
      const float4 a1 = *reinterpret_cast<const float4*>(qp + c * LDQ + QB / 2);
      const float4 b4 = *reinterpret_cast<const float4*>(kp + c * LDK);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// this thread's scores into the 128 x 64 score tile st; flags the rows
// where one of its scores of the first `cols` columns reaches the row's bar
__device__ __forceinline__ void finish_tile(const float (&acc)[8][4], float* st, const float* bar,
                                            int* flag, int cols) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float4 bar0 = *reinterpret_cast<const float4*>(bar + ty * 4);
  const float4 bar1 = *reinterpret_cast<const float4*>(bar + QB / 2 + ty * 4);
  const float bars[8] = {bar0.x, bar0.y, bar0.z, bar0.w, bar1.x, bar1.y, bar1.z, bar1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = (i >> 2) * (QB / 2) + ty * 4 + (i & 3);
    *reinterpret_cast<float4*>(st + row * LDS + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    bool hit = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) hit |= tx * 4 + j < cols && acc[i][j] >= bars[i];
    if (hit) flag[row] = 1;
  }
}

// the 128 x 64 score tile of the staged queries and keys (all c2p channels)
// into st, with the rows' flags
__device__ __forceinline__ void score_tile(const float* qs, const float* kb, float* st,
                                           const float* bar, int* flag, int c2p, int cols) {
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  accumulate(acc, qs, kb, c2p);
  finish_tile(acc, st, bar, flag, cols);
}

// TC: stage rows [r0, r0 + R) of src (bf16, `stride` elements a row) into
// dst [R][ld]: channels [0, cw) (a multiple of 8), rows at or past `rend`
// as zeros; 16 bytes a copy, consecutive threads along a row
template <int R>
__device__ __forceinline__ void stage_tc(uint16_t* dst, const uint16_t* src, int r0, int rend,
                                         int stride, int cw, int ld) {
  const int per_row = cw / 8;
  for (int i = threadIdx.x; i < R * per_row; i += NT) {
    const int rr = i / per_row;
    const int c = (i - rr * per_row) * 8;
    const bool ok = r0 + rr < rend;
    cp_async16(dst + rr * ld + c, ok ? src + (size_t)(r0 + rr) * stride + c : src, ok);
  }
}

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a b over one k-step of 16 channels: A 16 x 16 row-major (the rows'
// channels), B 16 x 8 column-major (the keys' channels), fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// TC: add the products of the staged queries' (qs [QB][ld]) and keys' (kb
// [TB][ld]) first cw channels to this thread's fragments: acc[n] holds rows
// 16 warp + g and + 8, keys 8 n + 2 t and + 1 (g = lane / 4, t = lane % 4)
__device__ __forceinline__ void accumulate_tc(float (&acc)[8][4], const uint16_t* qs,
                                              const uint16_t* kb, int ld, int cw) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint16_t* qp = qs + ((threadIdx.x >> 5) * 16 + g) * ld + 2 * t;
  const uint16_t* kp = kb + g * ld + 2 * t;
#pragma unroll 2
  for (int k0 = 0; k0 < cw; k0 += CPAD_TC) {
    const uint32_t a[4] = {lds32(qp + k0), lds32(qp + 8 * ld + k0), lds32(qp + k0 + 8),
                           lds32(qp + 8 * ld + k0 + 8)};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const uint16_t* kn = kp + n * 8 * ld + k0;
      mma_bf16(acc[n], a, lds32(kn), lds32(kn + 8));
    }
  }
}

// TC: this thread's fragments into the score tile st; flags its two rows
// where one of its scores of the first `cols` columns reaches the row's bar
__device__ __forceinline__ void finish_tile_tc(const float (&acc)[8][4], float* st,
                                               const float* bar, int* flag, int cols) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const float b0 = bar[r0];
  const float b1 = bar[r1];
  bool h0 = false;
  bool h1 = false;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<float2*>(st + r0 * LDS + col) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(st + r1 * LDS + col) = make_float2(acc[n][2], acc[n][3]);
    h0 |= (col < cols && acc[n][0] >= b0) || (col + 1 < cols && acc[n][1] >= b0);
    h1 |= (col < cols && acc[n][2] >= b1) || (col + 1 < cols && acc[n][3] >= b1);
  }
  if (h0) flag[r0] = 1;
  if (h1) flag[r1] = 1;
}

// The selection of one scored tile, whose columns are the keys of key-local
// rows t0 .. t0 + TB - 1: warp w takes its flagged rows, a lane a row, and
// clears their flags for the next tile; for each it ballots the columns
// that come before the row's bar, lie in the row's range and, with CEIL,
// come after the row's ceiling (ceil_v, ceil_i: the block's event's rows),
// and inserts them into the row's list.
template <int KS, bool CEIL, class RowRange>
__device__ __forceinline__ void select_tile(const float* st, float* bar, int* bar_i, int* flag,
                                            int q0, int nq, int k, int base, int t0,
                                            RowRange row_range, const float* ceil_v,
                                            const int* ceil_i, WarpTopK<KS> (&lists)[ROWS]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int mine = warp * ROWS + (lane % ROWS);
  const bool flagged = lane < ROWS && flag[mine] != 0;
  unsigned rows = __ballot_sync(FULL_MASK, flagged);
  if (flagged) flag[mine] = 0;
  while (rows) {
    const int r = __ffs(rows) - 1;
    rows &= rows - 1;
    const int row = warp * ROWS + r;
    if (q0 + row >= nq) continue;
    const float kv = bar[row];
    const int ki = bar_i[row];
    float cv = 0.f;
    int ci = 0;
    if constexpr (CEIL) {
      cv = __ldg(ceil_v + q0 + row);
      ci = __ldg(ceil_i + q0 + row);
    }
    const int2 range = row_range(row);
    float s[TB / 32];
    unsigned bal[TB / 32];
    unsigned any = 0;
#pragma unroll
    for (int g = 0; g < TB / 32; ++g) {
      const int t = t0 + g * 32 + lane;
      s[g] = st[row * LDS + g * 32 + lane];
      bal[g] = __ballot_sync(
          FULL_MASK, t >= range.x && t < range.y && ahead(s[g], base + t, kv, ki) &&
                         (!CEIL || ahead(cv, ci, s[g], base + t)));
      any |= bal[g];
    }
    if (!any) continue;  // a false flag: the list stays
    // the row's list into one working set and back by a jump on the
    // warp-uniform row: every case moves the registers of a static index,
    // so the lists stay in registers and the code below exists once, not
    // once a row (a chain of selects over the 16 lists took about 90
    // instructions a row)
    WarpTopK<KS> cur;
    switch (r) {
#define DGCNN_GET(u) \
  case u:            \
    cur = lists[u];  \
    break;
      DGCNN_ROWS(DGCNN_GET)
#undef DGCNN_GET
    }
#pragma unroll
    for (int g = 0; g < TB / 32; ++g) {
      if (bal[g]) cur.take(k, lane, bal[g], s[g], base + t0 + g * 32 + lane);
    }
    float nkv;
    int nki;
    cur.kth(k, nkv, nki);
    if (lane == 0) {
      bar[row] = nkv;
      bar_i[row] = nki;
    }
    switch (r) {
#define DGCNN_PUT(u) \
  case u:            \
    lists[u] = cur;  \
    break;
      DGCNN_ROWS(DGCNN_PUT)
#undef DGCNN_PUT
    }
  }
}

// every row's bar from its list's k-th entry, and no row flagged
template <int KS>
__device__ __forceinline__ void init_bars(WarpTopK<KS> (&lists)[ROWS], float* bar, int* bar_i,
                                          int* flag, int k) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float kv;
    int ki;
    lists[r].kth(k, kv, ki);
    if (lane == 0) {
      bar[warp * ROWS + r] = kv;
      bar_i[warp * ROWS + r] = ki;
    }
  }
  if (threadIdx.x < QB) flag[threadIdx.x] = 0;
}

// This warp's lists, rows q0 + 16 warp + r of event b (rows at or past nq
// skipped), into the partial lists (split, b, row, slot) of part_v and
// part_i when part_v is set (S > 1), else finished: the key index (the
// self-edge min(q, nk - 1) for a slot scoring <= INVALID_BELOW, unless
// raw), valid and the score.
template <int KS>
__device__ __forceinline__ void store_lists(const WarpTopK<KS> (&lists)[ROWS], int b, int batch,
                                            int split, int q0, int nq, int nk, int k, int raw,
                                            int32_t* idx_out, uint8_t* valid_out, float* score_out,
                                            float* part_v, int32_t* part_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int q = q0 + warp * ROWS + r;
    if (q >= nq) continue;
    const size_t row = (size_t)b * nq + q;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int slot = s * 32 + lane;
      if (slot >= k) continue;
      const float v = lists[r].v[s];
      if (part_v != nullptr) {
        const size_t o = ((size_t)split * batch * nq + row) * k + slot;
        part_v[o] = v;
        part_i[o] = lists[r].i[s];
      } else {
        const bool ok = v > INVALID_BELOW;
        idx_out[row * k + slot] = ok || raw ? lists[r].i[s] : min(q, nk - 1);
        valid_out[row * k + slot] = ok ? 1 : 0;
        score_out[row * k + slot] = v;
      }
    }
  }
}

// The TC sweep: `sweep`'s contract on bf16 operands (c2 a multiple of
// CPAD_TC, every channel staged as it is). One pass: the query rows once,
// key tiles double-buffered; chunked: steps of (key tile, channel chunk),
// each staging the query rows' chunk and the tile's chunk into one of two
// buffers while the other step's chunks are multiplied.
template <int KS, bool CHUNK, bool CEIL, class TileStart, class RowRange>
__device__ __forceinline__ void sweep_tc(float* smem, const uint16_t* qa_b, const uint16_t* ka_b,
                                         int nq, int q0, int c2, int ch, int k, int base,
                                         int ntiles, int key_end, TileStart tile_start,
                                         RowRange row_range, const float* ceil_v,
                                         const int* ceil_i, WarpTopK<KS> (&lists)[ROWS]) {
  uint16_t* sm = reinterpret_cast<uint16_t*>(smem);
  const int ld = (CHUNK ? ch : c2) + SKEW_TC;
  const int qn = QB * ld;  // elements of the staged query rows
  const int kn = TB * ld;  // of one staged key tile
  float* st = reinterpret_cast<float*>(sm + (CHUNK ? 2 * (qn + kn) : qn + 2 * kn));
  float* bar = st + QB * LDS;
  int* bar_i = reinterpret_cast<int*>(bar + QB);
  int* flag = bar_i + QB;
  const int nch = CHUNK ? (c2 + ch - 1) / ch : 1;
  const int steps = ntiles * nch;
  auto stage_step = [&](int s) {
    const int m = s / nch;
    const int c0 = (s - m * nch) * ch;
    uint16_t* buf = sm + (s & 1) * (qn + kn);
    const int w = min(ch, c2 - c0);
    stage_tc<QB>(buf, qa_b + c0, q0, nq, c2, w, ld);
    stage_tc<TB>(buf + qn, ka_b + c0, tile_start(m), key_end, c2, w, ld);
    cp_async_commit();
  };

  if constexpr (CHUNK) {
    if (steps > 0) stage_step(0);
  } else {
    stage_tc<QB>(sm, qa_b, q0, nq, c2, c2, ld);
    if (ntiles > 0) stage_tc<TB>(sm + qn, ka_b, tile_start(0), key_end, c2, c2, ld);
    cp_async_commit();
  }
  init_bars(lists, bar, bar_i, flag, k);

  float acc[8][4];
  if constexpr (CHUNK) {
    for (int s = 0; s < steps; ++s) {
      const int m = s / nch;
      const int j = s - m * nch;
      cp_async_wait_all();
      __syncthreads();
      if (s + 1 < steps) stage_step(s + 1);
      if (j == 0) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      }
      const uint16_t* buf = sm + (s & 1) * (qn + kn);
      accumulate_tc(acc, buf, buf + qn, ld, min(ch, c2 - j * ch));
      if (j == nch - 1) {
        const int t0 = tile_start(m);
        finish_tile_tc(acc, st, bar, flag, key_end - t0);
        __syncthreads();
        select_tile<KS, CEIL>(st, bar, bar_i, flag, q0, nq, k, base, t0, row_range, ceil_v,
                              ceil_i, lists);
      }
    }
  } else {
    for (int m = 0; m < ntiles; ++m) {
      cp_async_wait_all();
      __syncthreads();
      const int t0 = tile_start(m);
      if (m < ntiles - 1) {
        stage_tc<TB>(sm + qn + ((m + 1) & 1) * kn, ka_b, tile_start(m + 1), key_end, c2, c2, ld);
        cp_async_commit();
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      accumulate_tc(acc, sm, sm + qn + (m & 1) * kn, ld, c2);
      finish_tile_tc(acc, st, bar, flag, key_end - t0);
      __syncthreads();
      select_tile<KS, CEIL>(st, bar, bar_i, flag, q0, nq, k, base, t0, row_range, ceil_v, ceil_i,
                            lists);
    }
  }
  cp_async_wait_all();
}

// The sweep. The block's query rows are [q0, q0 + QB) of qa_b (rows at or
// past nq are zeros and select nothing). It visits `ntiles` key tiles, tile
// m starting at key-local row tile_start(m) of ka_b; keys at or past
// key_end read as zeros. Row r offers the columns of key-local index t in
// [row_range(r).x, row_range(r).y) to lists[r - 16 warp], with index
// base + t, behind the row's ceiling with CEIL. CHUNK: channels in chunks
// of ch (`sweep_chunk`), else all at once. This is the fp32 score (the
// CUDA cores' fmaf chain); `sweep` picks it or `sweep_tc`.
template <int KS, bool CHUNK, bool CEIL, class TileStart, class RowRange>
__device__ __forceinline__ void sweep_fp32(float* smem, const float* qa_b, const float* ka_b,
                                           int nq, int q0, int c2, int ch, int k, int base,
                                           int ntiles, int key_end, TileStart tile_start,
                                           RowRange row_range, const float* ceil_v,
                                           const int* ceil_i, WarpTopK<KS> (&lists)[ROWS]) {
  const int c2p = round_up(c2, CPAD);
  // query rows and key tiles, or two buffers of (query chunk, key chunk)
  const int step_floats = ch * (LDQ + LDK);
  float* qs = smem;
  float* ks = qs + c2p * LDQ;
  float* st = CHUNK ? smem + 2 * step_floats : ks + 2 * c2p * LDK;
  float* bar = st + QB * LDS;
  int* bar_i = reinterpret_cast<int*>(bar + QB);
  int* flag = bar_i + QB;
  // chunked: step s is key tile s / nch, channels [ch (s % nch), + ch)
  const int nch = CHUNK ? (c2p + ch - 1) / ch : 1;
  const int steps = ntiles * nch;
  auto stage_step = [&](int s) {
    const int m = s / nch;
    const int c0 = (s - m * nch) * ch;
    float* buf = smem + (s & 1) * step_floats;
    stage<QB, LDQ>(buf, qa_b + c0, q0, nq, c2, c2 - c0, min(ch, c2p - c0));
    stage<TB, LDK>(buf + ch * LDQ, ka_b + c0, tile_start(m), key_end, c2, c2 - c0,
                   min(ch, c2p - c0));
    cp_async_commit();
  };

  if constexpr (CHUNK) {
    if (steps > 0) stage_step(0);
  } else {
    stage<QB, LDQ>(qs, qa_b, q0, nq, c2, c2, c2p);
    if (ntiles > 0) stage<TB, LDK>(ks, ka_b, tile_start(0), key_end, c2, c2, c2p);
    cp_async_commit();
  }
  init_bars(lists, bar, bar_i, flag, k);

  if constexpr (CHUNK) {
    float acc[8][4] = {};
    for (int s = 0; s < steps; ++s) {
      const int m = s / nch;
      const int j = s - m * nch;
      cp_async_wait_all();
      __syncthreads();
      if (s + 1 < steps) stage_step(s + 1);
      if (j == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
      }
      const float* buf = smem + (s & 1) * step_floats;
      accumulate(acc, buf, buf + ch * LDQ, min(ch, c2p - j * ch));
      if (j == nch - 1) {
        const int t0 = tile_start(m);
        finish_tile(acc, st, bar, flag, key_end - t0);
        __syncthreads();
        select_tile<KS, CEIL>(st, bar, bar_i, flag, q0, nq, k, base, t0, row_range, ceil_v,
                              ceil_i, lists);
      }
    }
  } else {
    for (int m = 0; m < ntiles; ++m) {
      cp_async_wait_all();
      __syncthreads();
      const int t0 = tile_start(m);
      if (m + 1 < ntiles) {
        stage<TB, LDK>(ks + ((m + 1) & 1) * c2p * LDK, ka_b, tile_start(m + 1), key_end, c2, c2,
                       c2p);
        cp_async_commit();
      }
      score_tile(qs, ks + (m & 1) * c2p * LDK, st, bar, flag, c2p, key_end - t0);
      __syncthreads();
      select_tile<KS, CEIL>(st, bar, bar_i, flag, q0, nq, k, base, t0, row_range, ceil_v, ceil_i,
                            lists);
    }
  }
  cp_async_wait_all();
}

// The sweep of either score: fp32 operands, or with TC bf16 ones.
template <int KS, bool CHUNK, bool CEIL, bool TC, class TileStart, class RowRange>
__device__ __forceinline__ void sweep(float* smem, const elem_t<TC>* qa_b, const elem_t<TC>* ka_b,
                                      int nq, int q0, int c2, int ch, int k, int base, int ntiles,
                                      int key_end, TileStart tile_start, RowRange row_range,
                                      const float* ceil_v, const int* ceil_i,
                                      WarpTopK<KS> (&lists)[ROWS]) {
  if constexpr (TC) {
    sweep_tc<KS, CHUNK, CEIL>(smem, qa_b, ka_b, nq, q0, c2, ch, k, base, ntiles, key_end,
                              tile_start, row_range, ceil_v, ceil_i, lists);
  } else {
    sweep_fp32<KS, CHUNK, CEIL>(smem, qa_b, ka_b, nq, q0, c2, ch, k, base, ntiles, key_end,
                                tile_start, row_range, ceil_v, ceil_i, lists);
  }
}

}  // namespace dgcnn
