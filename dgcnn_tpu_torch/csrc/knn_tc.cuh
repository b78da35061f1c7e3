// The Hopper kernels of the kNN's tensor-core score (--knn_precision
// default), CUDA C++ for sm_90a: one pipeline, `tc::sweep`, and three
// callers. csrc/knn.cu launches the exact pass (`knn_tc_kernel` here,
// `dgcnn_knn_topk_tc`), splits its keys and merges the splits;
// csrc/ring_knn.cu the ring step (`dgcnn_ring_knn_step_tc`: the running
// lists read and written in place, global key indices); csrc/knn_banded.cu
// the banded pass (`dgcnn_knn_banded_tc`: a block's band of keys, visited
// outward from the diagonal, each row's own window).
//
// Replaces: the DEFAULT-precision forms of the three Pallas kernels,
// dgcnn_tpu/kernels/knn_pallas.py::_knn_kernel (the single bf16
// dot_general, knn_pallas.py:108-114), knn_banded.py::_banded_kernel
// (:183) and ring_knn_rdma.py::_ring_kernel (:245).
// Each computes what knn_sweep.cuh's `sweep_tc` instantiation of its
// kernel computes, to the bit: per query row the top k keys by s_ij =
// sum_c qa[i, c] ka[j, c] over the bf16 operands of
// kernels/knn_cuda.py::tc_operand (channels padded with zeros to a
// multiple of 16), each score one chain of 16-channel tensor-core steps
// into fp32 accumulators from 0 in ascending channel order, ordered (score
// desc, index asc). Equal bits keep the ring's graph equal to the exact
// one and the banded graph at window >= N equal to it too. `sweep_tc`
// stays the bit reference and the route past one pass (k > KMAX behind
// ceilings, channels past max_c2()).
//
// What bounds the exact pass on an H100. The product is (2 C + 2) operations a (query,
// valid key) pair at the bf16 tensor cores' 989 TFLOP/s: 2.26 ms at one
// 131,072-point event and C = 64, 0.17 ms at C = 4. Every pair also takes
// one fp32 compare against its row's running k-th score on the CUDA cores
// (1.7e10 pairs there: about 0.5 ms at 33.5 T compares/s), and each block
// streams every key of its event through shared memory (21 MB at C = 64,
// from L2). The sweep's TC instantiation (`sweep_tc`) took 19.9 ms (C = 4)
// and 28.0 ms (C = 64) at that shape: per 64-key tile two block-wide
// barriers, the whole 128 x 64 score tile through shared memory, 32-bit
// fragment loads and one tile in flight.
//
// What this design does about it.
// - Warp specialisation. A block is two consumer warpgroups of 64 query
//   rows each (QB = 128, as `sweep_tc`) and one producer warp. The
//   producer's one thread loads the block's query rows once and then key
//   tiles of TBK = 64 keys by TMA (a 3-d tensor map over (channel, row,
//   event), boxes of 16 channels x rows, the 32-byte swizzle) into a ring of
//   2-4 stages with full / empty mbarriers. No block-wide barrier runs in
//   the sweep: a consumer warp waits on its stage's full barrier and, once
//   its product of the tile is done, arrives on the stage's empty barrier,
//   so the next load overlaps the warp's filter and selection.
// - The product: one warpgroup's 64 rows against the tile's 64 keys by
//   wgmma.m64n64k16 from shared-memory descriptors, channels in steps of
//   16 from the resident query rows and the staged keys. On every pair of
//   the 131,072-point inputs this chain gives the bits of sweep_tc's
//   mma.sync.m16n8k16 chain (kernel_variants.py --only probe). It leaves
//   each warp 16 whole rows in mma.sync's fragment layout, 32 accumulators
//   a thread.
// - The filter in registers. Each row's bar, its list's k-th entry, sits in
//   the registers of the four lanes that hold the row's scores. A thread
//   compares its 16 scores of each of its two rows with the row's bar; a
//   ballot names the rows with a candidate, and only those rows' scores go
//   to the warp's own staging area in shared memory (16 x 64 floats),
//   where the warp's exact test and insert (`sweep`'s, warp_topk.cuh)
//   read them, a lane a column.
//   Past the first tiles a few percent of the rows hold a candidate, and
//   the whole score tile is never stored.
// - Keys at or past nk arrive from TMA as zeros, which score 0: the filter
//   and the test take only columns in a row's range, which ends at nk or
//   before (a column out of it scores -inf).
// - The tile. 64 keys, not 128: a flagged row then stages and tests half
//   the columns, and the selection is most of the time (on an H100 at 1 x
//   131,072, C = 4: 11.8 against 15.9 ms; PERF.md).
// - What differs between the callers is handed to the sweep: the m-th
//   tile's first key (the producer and the consumers compute the same
//   sequence; TMA takes any row), each row's key-local column range [lo,
//   hi), kept in registers and applied by the filter and the exact test,
//   an index base added to each column, and the lists as the caller seeds
//   them (the bars start at their k-th entries).
// About 100 KB of shared memory at C = 64 (4 stages) and 288 threads a
// block; csrc/knn.cu splits the keys only where the grid has fewer blocks
// than the SMs (up to two blocks an SM: each split refills its lists from
// empty, and the selection is most of the time). The ring step and the
// banded pass do not split: their grids fill the card.

#pragma once

#include <cuda.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include "knn_sweep.cuh"
#include "sm90.cuh"

namespace dgcnn {
namespace tc {

constexpr int TBK = 64;                  // keys a tile
constexpr int KSTEP = 16;                // channels a product step: one 32-byte swizzle row
constexpr int CONSUMER_WARPS = 8;        // two warpgroups of 64 query rows
constexpr int NT_TC = 32 * CONSUMER_WARPS + 32;  // and the producer warp
constexpr int LDST = TBK + 8;            // floats between a warp's staged score rows
constexpr int MIN_STAGES = 2;
constexpr int MAX_STAGES = 4;
constexpr int ALIGN = 1024;              // the swizzled regions' alignment
constexpr int NF = TBK / 8;              // n8 fragments a thread holds a tile

static_assert(QB == 2 * 64 && ROWS == 16, "two warpgroups of 64 rows");
static_assert(TBK == 64, "one wgmma of n64 a k-step");

// bytes of the query rows, of one key stage, and of the rest (the warps'
// staging areas and the barriers) for c2 (a multiple of KSTEP) channels
__host__ __device__ inline size_t q_bytes(int c2) { return (size_t)QB * c2 * 2; }
__host__ __device__ inline size_t tile_bytes(int c2) { return (size_t)TBK * c2 * 2; }
__host__ __device__ inline size_t rest_bytes(int stages) {
  return (size_t)CONSUMER_WARPS * ROWS * LDST * sizeof(float) + (2 * stages + 1) * 8;
}
__host__ __device__ inline size_t smem_bytes(int c2, int stages) {
  return ALIGN + q_bytes(c2) + stages * tile_bytes(c2) + rest_bytes(stages);
}

// the stages of the ring for c2 channels: the most in [MIN_STAGES,
// MAX_STAGES] that fit, 0 where not even MIN_STAGES do
inline int stages_for(int c2) {
  for (int s = MAX_STAGES; s >= MIN_STAGES; --s)
    if (smem_bytes(c2, s) <= (size_t)SMEM_LIMIT) return s;
  return 0;
}

// the widest c2 (a multiple of KSTEP) the kernel takes
inline int max_c2() {
  int c2 = KSTEP;
  while (stages_for(c2 + KSTEP)) c2 += KSTEP;
  return c2;
}

// The product of one tile: the warpgroup's wgmma chain from 0. q_s: the
// query rows [g][QB][32 B], k_s: the stage's keys [g][TBK][32 B], g the
// 16-channel step.
__device__ __forceinline__ void product(float (&acc)[NF][4], uint32_t q_s, uint32_t k_s, int steps,
                                        int warp) {
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[n][e] = 0.f;
      sm90::fence_operand(acc[n][e]);
    }
  sm90::wgmma_fence();
  const uint32_t a0 = q_s + (warp >> 2) * 64 * 32;
  for (int g = 0; g < steps; ++g) {
    sm90::wgmma_k16(acc, sm90::desc_sw32(a0 + g * QB * 32), sm90::desc_sw32(k_s + g * TBK * 32));
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sm90::fence_operand(acc[n][e]);
}

// seeds every list empty: the exact and banded passes start so
struct FillEmpty {
  template <int KS>
  __device__ __forceinline__ void operator()(WarpTopK<KS> (&lists)[ROWS]) const {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        lists[r].v[s] = -FLT_MAX;
        lists[r].i[s] = INT_MAX;
      }
    }
  }
};

// The sweep of one query block, the producer and consumer loops shared by
// the Hopper TC kernels (csrc/knn.cu's exact pass, csrc/ring_knn.cu's ring
// step, csrc/knn_banded.cu's banded pass), as knn_sweep.cuh's `sweep` is
// by the sweeps. The block's query rows are [q0, q0 + QB) of event b of
// the query map (rows at or past nq arrive as zeros and take nothing). It
// visits `ntiles` key tiles: tile m's first key is key-local row
// tile_start(m) of the key map (any row; keys past the map's rows arrive as
// zeros), the same sequence in the producer and the consumers. Block row
// `row` offers the columns of key-local index t in [row_range(row).x,
// row_range(row).y) to lists[row - 16 warp], with index base + t. seed(lists)
// gives the consumer warps their lists before the first tile (sorted by
// (score desc, index asc)); the bars start at their k-th entries, so a
// seeded ring step filters against its running lists from its first tile.
// `stages` is the ring's depth (stages_for(c2)). Returns false in the
// producer warp, which holds no lists; true in the consumer warps, whose
// lists then hold the block's result.
template <int KS, class TileStart, class RowRange, class Seed>
__device__ __forceinline__ bool sweep(uint8_t* smem_raw, const CUtensorMap* qmap,
                                      const CUtensorMap* kmap, int b, int q0, int nq, int c2,
                                      int k, int base, int ntiles, int stages,
                                      TileStart tile_start, RowRange row_range, Seed seed,
                                      WarpTopK<KS> (&lists)[ROWS]) {
  const uint32_t raw_s = sm90::smem_addr(smem_raw);
  const uint32_t q_s = (raw_s + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const uint32_t k_s = q_s + (uint32_t)q_bytes(c2);
  const uint32_t kt = (uint32_t)tile_bytes(c2);
  float* staged = reinterpret_cast<float*>(smem_raw + (k_s - raw_s) + stages * kt);
  const uint32_t full = sm90::smem_addr(staged + CONSUMER_WARPS * ROWS * LDST);
  const uint32_t empty = full + 8 * stages;
  const uint32_t qfull = empty + 8 * stages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int steps = c2 / KSTEP;
  const float NEG_INF = __int_as_float(0xff800000);  // the score of a column a row may not take

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    sm90::mbar_init(qfull, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();  // the only block-wide barrier

  if (warp == CONSUMER_WARPS) {  // the producer
    if (lane == 0 && ntiles > 0) {
      sm90::tma_prefetch_map(qmap);
      sm90::tma_prefetch_map(kmap);
      sm90::mbar_arrive_expect_tx(qfull, (uint32_t)q_bytes(c2));
      for (int g = 0; g < steps; ++g)
        sm90::tma_load_3d(q_s + g * QB * 32, qmap, g * KSTEP, q0, b, qfull);
      for (int m = 0; m < ntiles; ++m) {
        const int s = m % stages;
        const int t0 = tile_start(m);
        sm90::mbar_wait(empty + 8 * s, ((m / stages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(full + 8 * s, kt);
        for (int g = 0; g < steps; ++g)
          sm90::tma_load_3d(k_s + s * kt + g * TBK * 32, kmap, g * KSTEP, t0, b, full + 8 * s);
      }
    }
    return false;
  }

  // a consumer warp: rows 16 warp + g and + 8 of the block (g = lane / 4)
  seed(lists);
  const int g = lane >> 2;
  const int t = lane & 3;
  // the bars (k-th entries) of rows g and g + 8, from the seeded lists
  float bar0 = -FLT_MAX, bar1 = -FLT_MAX;
  int bari0 = INT_MAX, bari1 = INT_MAX;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float kv;
    int ki;
    lists[r].kth(k, kv, ki);
    if (g == (r & 7)) {
      if (r < 8) {
        bar0 = kv;
        bari0 = ki;
      } else {
        bar1 = kv;
        bari1 = ki;
      }
    }
  }
  // the rows' key-local ranges, empty for rows at or past nq
  const int row0 = warp * ROWS + g;
  const int2 rr0 = q0 + row0 < nq ? row_range(row0) : make_int2(0, 0);
  const int2 rr1 = q0 + row0 + 8 < nq ? row_range(row0 + 8) : make_int2(0, 0);
  float* st = staged + warp * ROWS * LDST;

  if (ntiles > 0) sm90::mbar_wait(qfull, 0);
  float acc[NF][4];
  for (int m = 0; m < ntiles; ++m) {
    const int s = m % stages;
    sm90::mbar_wait(full + 8 * s, (m / stages) & 1);
    product(acc, q_s, k_s + s * kt, steps, warp);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty + 8 * s);  // the stage is free again

    const int t0 = tile_start(m);
    // the columns [a, e) of this tile that each row may take; a column it
    // may not take scores -inf, which no bar (a list entry, -FLT_MAX or
    // above) lets through the filter or the exact test
    const int a0 = min(max(rr0.x - t0, 0), TBK), e0 = min(max(rr0.y - t0, 0), TBK);
    const int a1 = min(max(rr1.x - t0, 0), TBK), e1 = min(max(rr1.y - t0, 0), TBK);
    if ((a0 | a1) != 0 || (e0 & e1) != TBK) {
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        const int col = 8 * n + 2 * t;
        if (col < a0 || col >= e0) acc[n][0] = NEG_INF;
        if (col + 1 < a0 || col + 1 >= e0) acc[n][1] = NEG_INF;
        if (col < a1 || col >= e1) acc[n][2] = NEG_INF;
        if (col + 1 < a1 || col + 1 >= e1) acc[n][3] = NEG_INF;
      }
    }
    bool h0 = false, h1 = false;
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      h0 |= (acc[n][0] >= bar0) | (acc[n][1] >= bar0);
      h1 |= (acc[n][2] >= bar1) | (acc[n][3] >= bar1);
    }
    const unsigned b0 = __ballot_sync(FULL_MASK, h0);
    const unsigned b1 = __ballot_sync(FULL_MASK, h1);
    if (!(b0 | b1)) continue;
    // bit r: row r of the warp's 16 (a row is flagged if any of its 4 lanes is)
    unsigned rows = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      rows |= ((b0 >> (4 * r)) & 0xfu) ? 1u << r : 0u;
      rows |= ((b1 >> (4 * r)) & 0xfu) ? 1u << (r + 8) : 0u;
    }
    __syncwarp();  // the previous selection's reads of st are done
    if ((rows >> g) & 1) {
#pragma unroll
      for (int n = 0; n < NF; ++n)
        *reinterpret_cast<float2*>(st + g * LDST + 8 * n + 2 * t) =
            make_float2(acc[n][0], acc[n][1]);
    }
    if ((rows >> (g + 8)) & 1) {
#pragma unroll
      for (int n = 0; n < NF; ++n)
        *reinterpret_cast<float2*>(st + (g + 8) * LDST + 8 * n + 2 * t) =
            make_float2(acc[n][2], acc[n][3]);
    }
    __syncwarp();
    while (rows) {
      const int r = __ffs(rows) - 1;
      rows &= rows - 1;
      // the row's bar from a lane that holds it
      const float kv = __shfl_sync(FULL_MASK, r < 8 ? bar0 : bar1, (r & 7) * 4);
      const int ki = __shfl_sync(FULL_MASK, r < 8 ? bari0 : bari1, (r & 7) * 4);
      float sv[TBK / 32];
      unsigned bal[TBK / 32];
      unsigned any = 0;
#pragma unroll
      for (int c = 0; c < TBK / 32; ++c) {
        const int col = c * 32 + lane;
        sv[c] = st[r * LDST + col];
        bal[c] = __ballot_sync(FULL_MASK, ahead(sv[c], base + t0 + col, kv, ki));
        any |= bal[c];
      }
      if (!any) continue;  // a false flag: the list stays
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
        if (bal[c]) cur.take(k, lane, bal[c], sv[c], base + t0 + c * 32 + lane);
      }
      float nkv;
      int nki;
      cur.kth(k, nkv, nki);
      if (g == (r & 7)) {
        if (r < 8) {
          bar0 = nkv;
          bari0 = nki;
        } else {
          bar1 = nkv;
          bari1 = nki;
        }
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
  return true;
}

// A pass of k <= KMAX entries (no ceiling) for query rows [q0, q0 + QB) of
// event blockIdx.z against the key tiles of split blockIdx.y; `stages` the
// ring's depth (stages_for). Outputs as csrc/knn.cu's knn_topk_kernel. At
// k <= 32 the bound asks for two blocks an SM: without it this kernel ran
// 1.6x as long at 1 x 131,072 (PERF.md).
template <int KS>
__global__ void __launch_bounds__(NT_TC, KS == 1 ? 2 : 1)
knn_tc_kernel(const __grid_constant__ CUtensorMap qmap,  // (B, nq, c2) bf16
              const __grid_constant__ CUtensorMap kmap,  // (B, nk, c2) bf16
              int32_t* __restrict__ idx_out, uint8_t* __restrict__ valid_out,
              float* __restrict__ score_out, float* __restrict__ part_v,
              int32_t* __restrict__ part_i, int nq, int nk, int c2, int k, int raw, int stages) {
  extern __shared__ uint8_t smem_raw[];
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * QB;
  const int tiles = (nk + TBK - 1) / TBK;
  const int t_lo = split * tiles / splits;
  const int ntiles = (split + 1) * tiles / splits - t_lo;
  WarpTopK<KS> lists[ROWS];
  if (!sweep<KS>(smem_raw, &qmap, &kmap, b, q0, nq, c2, k, 0, ntiles, stages,
                 [=](int m) { return (t_lo + m) * TBK; }, [nk](int) { return make_int2(0, nk); },
                 FillEmpty{}, lists)) {
    return;
  }
  store_lists(lists, b, gridDim.z, split, q0, nq, nk, k, raw, idx_out, valid_out, score_out,
              part_v, part_i);
}

// ---- host side

// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so
// the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a (batch, rows, c2) bf16 operand: boxes of 16 channels
// x box_rows rows of one event, 32-byte swizzle, zeros outside. False if
// the driver refuses it.
inline bool make_map(CUtensorMap* map, const void* ptr, int batch, int rows, int c2, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)c2, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)c2 * 2, (cuuint64_t)rows * c2 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)KSTEP, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether the Hopper kernels take bf16 operands qa and ka of c2 channels and
// a pass of k entries: c2 a multiple of KSTEP that fits the shared memory,
// k <= KMAX, both operands 16-byte aligned (TMA's rule).
inline bool takes(const void* qa, const void* ka, int c2, int k) {
  return c2 >= KSTEP && c2 % KSTEP == 0 && stages_for(c2) != 0 && k >= 1 && k <= KMAX &&
         reinterpret_cast<uintptr_t>(qa) % 16 == 0 && reinterpret_cast<uintptr_t>(ka) % 16 == 0;
}

// The tensor maps of a launch: the queries in boxes of QB rows, the keys in
// boxes of TBK rows. False if the driver refuses one.
inline bool make_maps(CUtensorMap* qmap, CUtensorMap* kmap, const void* qa, const void* ka,
                      int batch, int nq, int nk, int c2) {
  return make_map(qmap, qa, batch, nq, c2, QB) && make_map(kmap, ka, batch, nk, c2, TBK);
}

// Sets `kernel`'s dynamic shared memory for c2 channels (per device, so on
// every launch: a cheap host call) and returns it in *smem.
inline cudaError_t prepare(const void* kernel, int c2, size_t* smem) {
  *smem = smem_bytes(c2, stages_for(c2));
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

}  // namespace tc
}  // namespace dgcnn
