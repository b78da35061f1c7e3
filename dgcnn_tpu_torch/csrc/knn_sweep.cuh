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

// The sweep. The block's query rows are [q0, q0 + QB) of qa_b (rows at or
// past nq are zeros and select nothing). It visits `ntiles` key tiles, tile
// m starting at key-local row tile_start(m) of ka_b; keys at or past
// key_end read as zeros. Row r offers the columns of key-local index t in
// [row_range(r).x, row_range(r).y) to lists[r - 16 warp], with index
// base + t, behind the row's ceiling with CEIL. CHUNK: channels in chunks
// of ch (`sweep_chunk`), else all at once.
template <int KS, bool CHUNK, bool CEIL, class TileStart, class RowRange>
__device__ __forceinline__ void sweep(float* smem, const float* qa_b, const float* ka_b, int nq,
                                      int q0, int c2, int ch, int k, int base, int ntiles,
                                      int key_end, TileStart tile_start, RowRange row_range,
                                      const float* ceil_v, const int* ceil_i,
                                      WarpTopK<KS> (&lists)[ROWS]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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

}  // namespace dgcnn
