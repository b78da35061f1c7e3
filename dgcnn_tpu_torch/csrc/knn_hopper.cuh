// The exact fp32 kNN pass on a Hopper pipeline, CUDA C++ for sm_90a
// (included by csrc/knn.cu, not built on its own): `knn_topk_kernel_hopper`,
// entry `dgcnn_knn_topk_f32h`.
//
// Replaces: dgcnn_tpu/kernels/knn_pallas.py::_knn_kernel at HIGHEST
// precision (the Pallas TPU kernel behind knn_pallas and knn_pallas_cross),
// for the one-pass shapes: k <= KMAX, no ceiling, and channels whose query
// rows and a ring of at least MIN_STAGES key tiles fit shared memory
// (C + 2 <= max_c2() = 168). knn_sweep.cuh's `sweep_fp32` keeps the passes
// behind ceilings (k > 64) and the wider widths, and stays the bit
// reference of this kernel.
//
// What it computes: csrc/knn.cu's knn_topk_kernel<KS, false, false, false>,
// to the bit. Per query row the top k keys by s_ij = sum_c qa[i, c] ka[j, c]
// over the augmented operands of kernels/knn_cuda.py::build_augmented_operands
// (channels padded with zeros to a multiple of 4, the sweep's c2p), each
// score ONE fmaf chain from 0.f in ascending channel order on the CUDA
// cores, as `sweep_fp32` computes it (no TF32, no tensor cores); ordered
// (score desc, index asc) by warp_topk.cuh's exact test, `take`, `merge` and
// `kth`, unchanged; a slot scoring <= -1e29 becomes the self-edge; the key
// split S and knn_merge_kernel as the sweep's. Equal score bits and a
// strict total order make the same lists, whatever order the keys are
// offered in, so idx, valid and scores equal the sweep's.
//
// What bounds it on an H100. (2 C + 2) operations a (query, valid key)
// pair at 67 TFLOP/s fp32: 33.3 ms at one 131,072-point event and C = 64,
// 2.56 ms at C = 4. The sweep took 68.7 and 22.0 ms there (PERF.md): per
// 64-key tile two block-wide barriers, the whole 128 x 64 score tile
// stored to shared memory, a selection that the block's barrier waits on,
// 17 four-byte cp.async a thread, and 32 list registers beside the product
// under a 128-register cap.
//
// What this design does about it.
// - The ring, as tc::sweep's (knn_tc.cuh) but without a producer warp. One
//   thread loads the block's QB = 128 query rows once and the first key
//   tiles of 64 by TMA (3-d tensor maps over (channel, row, event), boxes of
//   8 channels, the 32-byte swizzle) into a ring of 3 to 6 stages, each with
//   a full mbarrier. No block-wide barrier runs in the sweep: a warp waits
//   on its stage's full barrier and, as soon as its product of the tile is
//   done, counts itself out of the stage (a shared-memory atomicInc that
//   wraps at the eighth warp); the warp that releases the stage last loads
//   the tile `stages` ahead into it. Then the warp filters and selects its
//   own rows while the other warps multiply. A ninth, producer warp (as
//   tc::sweep has) would put five warps of the SM's 18 on one of its four
//   register files, and cap a thread at 96 registers: the lists spilled and
//   a launch took 1.5 times the sweep's time (PERF.md, PR 18).
// - The product. Eight warps own 16 whole query rows each; lane (rg, kg) =
//   (lane % 4, lane / 4) scores rows rg + 4 i (i < 4) against keys kg + 8 j
//   (j < 8) of the tile: 32 accumulators; per 4 channels four 128-bit loads
//   of query rows and eight of keys, then the 128 FMAs a channel at a time
//   (32 independent chains). The swizzle puts 16-byte chunk q of row r at
//   chunk q ^ ((r >> 2) & 1) of its 32-byte row, so the distinct addresses of
//   a quarter warp's load fall in distinct banks. A 128-bit load costs a
//   quarter warp one pass of shared memory whatever it shares, so the
//   product, at 59.5 ms of the 66.2 at C = 64 on an H100, runs at about 60%
//   of the FMA pipe (34.9 ms at 1,980 MHz); an 8 x 8 tile (64 accumulators)
//   beside the 32 list registers left too few for two blocks an SM, and at
//   one block the selection's latency was no longer hidden (PERF.md, PR 18).
// - The filter in registers. Each row's bar (its list's k-th score and
//   index) sits in the warp's own shared memory; a lane compares its 8
//   scores of each of its 4 rows with the row's bar, and a ballot names the
//   rows with a candidate. Only those rows' scores go to the warp's staging
//   area (4 rows at a time, one group i), where the exact test and insert
//   read them a lane a column; the 128 x 64 score tile is never stored.
// - Keys at or past nk arrive from TMA as zeros; their columns score -inf,
//   which no bar lets through. Rows at or past nq are never flagged.
// About 104 KB of shared memory at C = 64 (3 stages) and 256 threads a
// block, so two blocks an SM at k <= 32 (128 registers a thread).

#pragma once

#include <cuda.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include "knn_sweep.cuh"
#include "knn_tc.cuh"
#include "sm90.cuh"

namespace dgcnn {
namespace f32h {

constexpr int TBK = 64;                          // keys a tile
constexpr int BOX = 8;                           // channels a TMA box: one 32-byte swizzle row
constexpr int BOX_BYTES = BOX * 4;
constexpr int WARPS = 8;                         // 16 query rows each
constexpr int NT_H = 32 * WARPS;
constexpr int RG = 4;                            // row groups: lane % 4
constexpr int KG = 8;                            // key groups: lane / 4
constexpr int RPL = ROWS / RG;                   // rows a lane: rg + 4 i
constexpr int KPL = TBK / KG;                    // keys a lane: kg + 8 j
constexpr int LDST = TBK + KG;                   // floats between staged rows: groups' writes apart
constexpr unsigned GROUP = 0x11111111u;          // the lanes of row group 0 (of group g: << g)
constexpr int MIN_STAGES = 3;
constexpr int MAX_STAGES = 6;
constexpr int ALIGN = 1024;                      // the swizzled regions' alignment
constexpr size_t SMEM_SM = 233472;               // shared memory of an SM (sm_90)
constexpr size_t SMEM_RESERVED = 1024;           // that the runtime keeps a block

static_assert(QB == WARPS * ROWS && ROWS == 16 && RPL == 4 && KPL == 8, "4 x 8 scores a lane");

// the TMA boxes of c2 channels (a multiple of 4), 8 channels each
__host__ __device__ inline int boxes(int c2) { return (c2 + BOX - 1) / BOX; }

// bytes of the query rows, of one key stage, and of the rest: the warps'
// staging areas (4 rows each), their bars (16 scores and 16 indices), the
// stages' full barriers and release counts, and the query rows' barrier
__host__ __device__ inline size_t q_bytes(int c2) { return (size_t)boxes(c2) * QB * BOX_BYTES; }
__host__ __device__ inline size_t tile_bytes(int c2) {
  return (size_t)boxes(c2) * TBK * BOX_BYTES;
}
__host__ __device__ inline size_t rest_bytes(int stages) {
  return (size_t)WARPS * (RG * LDST + 2 * ROWS) * sizeof(float) + (2 * stages + 1) * 8;
}
__host__ __device__ inline size_t smem_bytes(int c2, int stages) {
  return ALIGN + q_bytes(c2) + stages * tile_bytes(c2) + rest_bytes(stages);
}

// The stages of the ring for c2 channels: the most in [MIN_STAGES,
// MAX_STAGES] with which two blocks share an SM, else the most that fit
// one block; 0 where not even MIN_STAGES fit.
inline int stages_for(int c2) {
  const size_t budgets[2] = {SMEM_SM / 2 - SMEM_RESERVED, (size_t)SMEM_LIMIT};
  for (size_t budget : budgets)
    for (int s = MAX_STAGES; s >= MIN_STAGES; --s)
      if (smem_bytes(c2, s) <= budget) return s;
  return 0;
}

// the widest c2 (a multiple of CPAD) the kernel takes
inline int max_c2() {
  int c2 = CPAD;
  while (stages_for(c2 + CPAD)) c2 += CPAD;
  return c2;
}

// One 4-channel chunk of this lane's 4 x 8 scores: chunk qc of the rows
// rg + 4 i at qb, of the keys kg + 8 j at kb + kc (kc: this lane's swizzled
// offset of the chunk), each pair's chain advanced by the chunk's channels
// in ascending order, a channel at a time over all 32 pairs (32 independent
// FMAs between two of one chain). Row R's 16-byte chunk q sits at chunk
// q ^ ((R >> 2) & 1) of its 32-byte row (the swizzle), which for the rows
// 16 w + rg + 4 i is q ^ (i & 1).
__device__ __forceinline__ void chunk(float (&acc)[RPL][KPL], const char* qb, const char* kb,
                                      int qc, int kc) {
  float4 a[RPL], b[KPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i)
    a[i] = *reinterpret_cast<const float4*>(qb + RG * i * BOX_BYTES + ((qc ^ (i & 1)) << 4));
#pragma unroll
  for (int j = 0; j < KPL; ++j)
    b[j] = *reinterpret_cast<const float4*>(kb + KG * j * BOX_BYTES + kc);
#define DGCNN_CHANNEL(e)                 \
  _Pragma("unroll") for (int i = 0; i < RPL; ++i) \
      _Pragma("unroll") for (int j = 0; j < KPL; ++j) acc[i][j] = fmaf(a[i].e, b[j].e, acc[i][j]);
  DGCNN_CHANNEL(x)
  DGCNN_CHANNEL(y)
  DGCNN_CHANNEL(z)
  DGCNN_CHANNEL(w)
#undef DGCNN_CHANNEL
}

// This lane's scores of one tile from 0, channels ascending: rows at q (the
// lane's first row in box 0 of the query region), keys at k (box 0 of the
// stage), koff0 and koff1 this lane's offsets of key chunks 0 and 1 of a
// box (its keys kg + 8 j share the swizzle bit (kg >> 2) & 1).
__device__ __forceinline__ void product(float (&acc)[RPL][KPL], const char* q, const char* k,
                                        int koff0, int koff1, int c2) {
#pragma unroll
  for (int i = 0; i < RPL; ++i)
#pragma unroll
    for (int j = 0; j < KPL; ++j) acc[i][j] = 0.f;
  const int whole = c2 / BOX;
#pragma unroll 1
  for (int g = 0; g < whole; ++g) {
    const char* qb = q + g * QB * BOX_BYTES;
    const char* kb = k + g * TBK * BOX_BYTES;
    chunk(acc, qb, kb, 0, koff0);
    chunk(acc, qb, kb, 1, koff1);
  }
  if (c2 % BOX) chunk(acc, q + whole * QB * BOX_BYTES, k + whole * TBK * BOX_BYTES, 0, koff0);
}

// A pass of k <= KMAX entries (no ceiling) for query rows [q0, q0 + QB) of
// event blockIdx.z against the key tiles of split blockIdx.y; `stages` the
// ring's depth (stages_for). Outputs as csrc/knn.cu's knn_topk_kernel.
template <int KS>
__global__ void __launch_bounds__(NT_H, KS == 1 ? 2 : 1)
knn_topk_kernel_hopper(const __grid_constant__ CUtensorMap qmap,  // (B, nq, c2) f32
                       const __grid_constant__ CUtensorMap kmap,  // (B, nk, c2) f32
                       int32_t* __restrict__ idx_out, uint8_t* __restrict__ valid_out,
                       float* __restrict__ score_out, float* __restrict__ part_v,
                       int32_t* __restrict__ part_i, int nq, int nk, int c2, int k, int raw,
                       int stages) {
  extern __shared__ uint8_t smem_raw[];
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * QB;
  const int tiles = (nk + TBK - 1) / TBK;
  const int t_lo = split * tiles / splits;
  const int ntiles = (split + 1) * tiles / splits - t_lo;

  const uint32_t raw_s = sm90::smem_addr(smem_raw);
  const uint32_t pad = ((raw_s + ALIGN - 1) & ~(uint32_t)(ALIGN - 1)) - raw_s;
  char* qs = reinterpret_cast<char*>(smem_raw) + pad;  // [box][QB][8] floats, swizzled
  char* ks = qs + q_bytes(c2);                         // stages x [box][TBK][8]
  const uint32_t kt = (uint32_t)tile_bytes(c2);
  float* staged = reinterpret_cast<float*>(ks + stages * kt);  // [warp][RG][LDST]
  float* bars = staged + WARPS * RG * LDST;                    // [warp][16 scores, 16 indices]
  float* tail = bars + WARPS * 2 * ROWS;
  const uint32_t full = sm90::smem_addr(tail);                           // stages x 8 bytes
  unsigned* released = reinterpret_cast<unsigned*>(tail + 2 * stages);  // stages x 4 (of 8)
  const uint32_t qfull = full + 16 * stages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nbox = boxes(c2);
  // tile m into its stage, by one thread: TMA, completion counted in bytes
  auto load_tile = [&](int m) {
    const int s = m % stages;
    const uint32_t k_s = sm90::smem_addr(ks + s * kt);
    sm90::mbar_arrive_expect_tx(full + 8 * s, kt);
    for (int g = 0; g < nbox; ++g)
      sm90::tma_load_3d(k_s + g * TBK * BOX_BYTES, &kmap, g * BOX, (t_lo + m) * TBK, b,
                        full + 8 * s);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      released[s] = 0;
    }
    sm90::mbar_init(qfull, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();  // the only block-wide barrier
  if (threadIdx.x == 0) {  // the query rows once, and the ring's first tiles
    const uint32_t q_s = sm90::smem_addr(qs);
    sm90::tma_prefetch_map(&qmap);
    sm90::tma_prefetch_map(&kmap);
    sm90::mbar_arrive_expect_tx(qfull, (uint32_t)q_bytes(c2));
    for (int g = 0; g < nbox; ++g)
      sm90::tma_load_3d(q_s + g * QB * BOX_BYTES, &qmap, g * BOX, q0, b, qfull);
    for (int m = 0; m < min(stages, ntiles); ++m) load_tile(m);
  }

  // warp w: block rows 16 w + r, r = rg + RG i
  const int rg = lane % RG;
  const int kg = lane / RG;
  WarpTopK<KS> lists[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      lists[r].v[s] = -FLT_MAX;
      lists[r].i[s] = INT_MAX;
    }
  }
  // the rows' bars, row rg + 4 i at slot 4 rg + i: a lane's four in one load
  float* bar_v = bars + warp * 2 * ROWS;
  int* bar_i = reinterpret_cast<int*>(bar_v + ROWS);
  if (lane < ROWS) {
    bar_v[lane] = -FLT_MAX;
    bar_i[lane] = INT_MAX;
  }
  float* st = staged + warp * RG * LDST;
  const int live = min(max(nq - q0 - warp * ROWS, 0), ROWS);
  const unsigned live_rows = live == ROWS ? 0xffffu : (1u << live) - 1;  // bit r: row r < nq
  const char* qrow = qs + (warp * ROWS + rg) * BOX_BYTES;
  const int kbit = (kg >> 2) & 1;  // the swizzle of this lane's keys kg + KG j
  const int koff0 = kg * BOX_BYTES + (kbit << 4);
  const int koff1 = kg * BOX_BYTES + ((kbit ^ 1) << 4);
  const float NEG_INF = __int_as_float(0xff800000);
  __syncwarp();

  sm90::mbar_wait(qfull, 0);
  float acc[RPL][KPL];
  for (int m = 0; m < ntiles; ++m) {
    const int s = m % stages;
    sm90::mbar_wait(full + 8 * s, (m / stages) & 1);
    product(acc, qrow, ks + s * kt, koff0, koff1, c2);
    __syncwarp();
    // the stage is free again once every warp has multiplied it: the warp
    // that releases it last (the count wraps to 0) loads tile m + stages
    if (lane == 0 && atomicInc(released + s, WARPS - 1) == WARPS - 1 && m + stages < ntiles)
      load_tile(m + stages);

    const int t0 = (t_lo + m) * TBK;
    const int cols = nk - t0;
    if (cols < TBK) {  // the event's last tile: keys past nk take nothing
#pragma unroll
      for (int j = 0; j < KPL; ++j)
        if (kg + KG * j >= cols)
#pragma unroll
          for (int i = 0; i < RPL; ++i) acc[i][j] = NEG_INF;
    }
    const float4 bv4 = *reinterpret_cast<const float4*>(bar_v + RPL * rg);
    const float bv[RPL] = {bv4.x, bv4.y, bv4.z, bv4.w};
    unsigned rows = 0;  // bit r: row r has a candidate
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      bool h = false;
#pragma unroll
      for (int j = 0; j < KPL; ++j) h |= acc[i][j] >= bv[i];
      const unsigned bal = __ballot_sync(FULL_MASK, h);
#pragma unroll
      for (int g = 0; g < RG; ++g)
        rows |= (bal & (GROUP << g)) ? 1u << (RG * i + g) : 0u;
    }
    rows &= live_rows;
    while (rows) {
      // the lowest group i with a candidate: its rows' scores to the staging area
      const int i = (__ffs(rows) - 1) / RG;
      unsigned grp = (rows >> (RG * i)) & ((1u << RG) - 1);
      rows &= ~(((1u << RG) - 1) << (RG * i));
      float v[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        v[j] = acc[0][j];
#pragma unroll
        for (int ii = 1; ii < RPL; ++ii)
          if (i == ii) v[j] = acc[ii][j];
      }
      __syncwarp();  // the previous group's reads of st are done
      if ((grp >> rg) & 1) {
#pragma unroll
        for (int j = 0; j < KPL; ++j) st[rg * LDST + kg + KG * j] = v[j];
      }
      __syncwarp();
      while (grp) {
        const int g = __ffs(grp) - 1;
        grp &= grp - 1;
        const int r = g + RG * i;
        const float kv = bar_v[RPL * g + i];
        const int ki = bar_i[RPL * g + i];
        float sv[TBK / 32];
        unsigned bal[TBK / 32];
        unsigned any = 0;
#pragma unroll
        for (int c = 0; c < TBK / 32; ++c) {
          sv[c] = st[g * LDST + c * 32 + lane];
          bal[c] = __ballot_sync(FULL_MASK, ahead(sv[c], t0 + c * 32 + lane, kv, ki));
          any |= bal[c];
        }
        if (!any) continue;  // a false flag (a tie the index decides): the list stays
        // the row's list into one working set and back by a jump on the
        // warp-uniform row (as `select_tile`: the lists stay in registers)
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
        for (int c = 0; c < TBK / 32; ++c) {
          if (bal[c]) cur.take(k, lane, bal[c], sv[c], t0 + c * 32 + lane);
        }
        float nkv;
        int nki;
        cur.kth(k, nkv, nki);
        if (lane == 0) {
          bar_v[RPL * g + i] = nkv;
          bar_i[RPL * g + i] = nki;
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
    __syncwarp();  // lane 0's bars before the next tile's filter
  }
  store_lists(lists, b, gridDim.z, split, q0, nq, nk, k, raw, idx_out, valid_out, score_out,
              part_v, part_i);
}

// ---- host side

// The tensor map of a (batch, rows, c2) f32 operand, c2 a multiple of 4:
// boxes of 8 channels x box_rows rows of one event, 32-byte swizzle, zeros
// outside. False if the driver refuses it.
inline bool make_map(CUtensorMap* map, const void* ptr, int batch, int rows, int c2,
                     int box_rows) {
  const tc::EncodeTiled fn = tc::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)c2, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)c2 * 4, (cuuint64_t)rows * c2 * 4};
  const cuuint32_t box[3] = {(cuuint32_t)BOX, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether the kernel takes f32 operands qa and ka of c2 channels and a
// pass of k entries: c2 a multiple of CPAD whose ring fits shared memory,
// k <= KMAX, both operands 16-byte aligned (TMA's rule).
inline bool takes(const void* qa, const void* ka, int c2, int k) {
  return c2 >= CPAD && c2 % CPAD == 0 && stages_for(c2) != 0 && k >= 1 &&
         k <= KMAX && reinterpret_cast<uintptr_t>(qa) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(ka) % 16 == 0;
}

// Sets `kernel`'s dynamic shared memory for c2 channels (per device, so on
// every launch: a cheap host call) and returns it in *smem.
inline cudaError_t prepare(const void* kernel, int c2, size_t* smem) {
  *smem = smem_bytes(c2, stages_for(c2));
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace f32h
}  // namespace dgcnn
