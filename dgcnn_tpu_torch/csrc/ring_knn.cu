// One step of the exact ring kNN over point shards, CUDA C++ for sm_90a.
// Plain C interface, loaded with ctypes by kernels/ring_knn_cuda.py.
//
// Replaces: dgcnn_tpu/kernels/ring_knn_rdma.py::_ring_kernel (the Pallas TPU
// kernel behind ring_knn_rdma, --ring_impl rdma).
//
// What it computes. Under context parallelism each of P ranks holds a
// contiguous shard of Nl points of every event, and every graph build passes
// key blocks around the ring: at step s rank `me` holds the block of owner
// o = (me - s) mod P, whose key j has the global index o * Nl + j. One launch
// is one step on one rank. For every resident query i and every key j of the
// block it scores
//     s_ij = sum_c qa[i, c] * ka[j, c]
// over the augmented operands of kernels/knn_cuda.py::build_augmented_operands
//     qa_i = [2 x_i, -1, -1]     ka_j = [x_j, |x_j|^2, 1e30 (1 - mask_j)]
// (the owner's mask travels in the block's last lane), and merges the block's
// keys into the query's running top-k list: topv (f32) and topi (i32, global
// indices), (B, nq, k) each, read at the start of the launch and UPDATED IN
// PLACE at its end. The order is (score descending, global index ascending);
// blocks arrive in owner order, not global order, and the lexicographic
// selection does not depend on arrival order. The wrapper seeds the lists
// with (-FLT_MAX, 0) before step 0 and, after step P - 1, turns a slot whose
// score is <= -1e29 (fewer than k valid keys in the event) into the global
// self index with valid = 0, as the Pallas kernel's wrapper does.
//
// Scores are bit-identical to csrc/knn.cu's: the same operands and the same
// fp32 FMA chain in ascending channel order, on the CUDA cores (no TF32;
// knn_sweep.cuh). So the ring's graph over P shards equals the exact
// kernel's graph over the whole event, index for index.
// --knn_precision default scores bf16 operands on the tensor cores, with
// the exact TC kernel's chain of 16-channel steps, so the ring's TC graph
// equals the exact TC kernel's, index for index; its bound is the same
// operations at the bf16 tensor cores' dense peak (989 TFLOP/s). A step of
// one pass (k <= KMAX, no ceiling) at c2 <= tc::max_c2() runs the Hopper
// kernel below (dgcnn_ring_knn_step_tc, csrc/knn_tc.cuh's pipeline: TMA
// key tiles, a producer warp, wgmma, the filter in registers); the later
// passes of k > KMAX and wider channels run the sweep's TC instantiation
// (dgcnn_ring_knn_step_bf16, knn_sweep.cuh's `sweep_tc`), the bit
// reference. The Hopper step:
// - loads each running list into its warp's registers at the start (the
//   bars start at the running k-th entries, so from step 1 on, when the
//   lists arrive full, a tile flags few rows) and writes it back in place
//   at the end, as the sweep does;
// - gives each key the global index base + j;
// - does not split the keys: at 32,768 queries a shard the grid is 256
//   query blocks, a wave at two blocks an SM, and nothing is left to merge.
//
// What bounds it on an H100. Per launch the function needs, for each
// (query, valid key of the block) pair, C fp32 FMAs, one subtract and one
// compare: (2C + 2) * B * nq * nk_valid operations, 2.1 ms at C = 64,
// nq = nk = 32,768 and 67 TFLOP/s (fp32 on the CUDA cores, H100 SXM at
// 700 W). Its bytes are the block, the queries and the running list, about
// 28 MB at that size, 8 us at 3.35 TB/s. So it is bound by operations.
//
// What this design does about it (knn_sweep.cuh, warp_topk.cuh).
// - The score loop: each thread scores an 8 x 4 micro-tile from three
//   128-bit shared loads (two of them broadcast) per 32 FMAs, not from 8
//   scalar loads per 16; channels are padded to a multiple of 4, not 16
//   (C = 4: 8 channels, not 16); key tiles are staged by cp.async into a
//   double buffer under the previous tile's work.
// - The selection: each query's list lives across the 32 lanes of one warp,
//   in registers. Each thread compares its scores, still in registers,
//   with its rows' bars (the k-th scores, in shared memory) and flags the
//   rows that may hold a winner; a warp tests only the flagged rows'
//   columns exactly, by ballot, and inserts the winners by popcount and
//   shuffles, or merges many at once by a bitonic network.
// - The block's running lists are loaded straight into those warp lists at
//   the start and written back in place at the end, so the running k-th
//   entry is the exact bar for every key of the block, on step 0 too
//   (seeded lists), and no merge of partial lists is left for the end.
//   After the first step most rows are flagged on no tile of the block.
// The running list lives in global memory between launches: B * nq * k * 8
// bytes, 5.2 MB at nq = 32,768 and k = 20.
// Transport runs outside the kernel (kernels/ring_knn_cuda.py): the next
// block's transfer is started before this launch and waited for after it.
//
// Any C and any k <= the shard (knn_sweep.cuh): wide C sweeps the channels
// in chunks, and k > 64 runs in passes of at most 64 entries, the launches
// of pass p behind a ceiling a row, the last entry of pass p - 1 (global
// index). kernels/ring_knn_cuda.py keeps the P blocks that the first
// rotation delivered and sweeps the later passes over them locally.
//
// Lists in registers or shared memory: in registers. chip_smoke.py phase 2
// prints ptxas's report; the choice holds while it shows no spill for any
// instantiation (KS = 1 at two blocks an SM for the one-pass sweep without
// a ceiling, one otherwise).

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include "knn_sweep.cuh"
#include "knn_tc.cuh"

namespace {

using namespace dgcnn;

// this warp's rows' running lists (rows q0 + 16 warp + r of event b), slot
// s on lane s % 32; rows at or past nq empty. One row at a time, put in
// place by a jump on the row (as the selection does): unrolled, the
// Hopper step at k <= 32 spilled at two blocks an SM.
template <int KS>
__device__ __forceinline__ void load_running(WarpTopK<KS> (&lists)[ROWS], const float* topv,
                                             const int32_t* topi, int b, int q0, int nq, int k) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int r = 0; r < ROWS; ++r) {
    const int q = q0 + warp * ROWS + r;
    const size_t o = ((size_t)b * nq + q) * k;
    WarpTopK<KS> cur;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int slot = s * 32 + lane;
      const bool in = q < nq && slot < k;
      cur.v[s] = in ? topv[o + slot] : -FLT_MAX;
      cur.i[s] = in ? topi[o + slot] : INT_MAX;
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

// this warp's lists back into the running lists, in place
template <int KS>
__device__ __forceinline__ void store_running(const WarpTopK<KS> (&lists)[ROWS], float* topv,
                                              int32_t* topi, int b, int q0, int nq, int k) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int q = q0 + warp * ROWS + r;
    if (q >= nq) continue;
    const size_t o = ((size_t)b * nq + q) * k;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int slot = s * 32 + lane;
      if (slot < k) {
        topv[o + slot] = lists[r].v[s];
        topi[o + slot] = lists[r].i[s];
      }
    }
  }
}

template <int KS, bool CHUNK, bool CEIL, bool TC>
__global__ void __launch_bounds__(NT, KS == 1 && !CHUNK && !CEIL ? 2 : 1)
ring_merge_kernel(const elem_t<TC>* __restrict__ qa,  // (B, nq, c2) resident queries
                  const elem_t<TC>* __restrict__ ka,  // (B, nk, c2) circulating block
                  float* topv,                    // (B, nq, k) running, in place
                  int32_t* topi,                  // (B, nq, k) running, in place
                  const float* __restrict__ ceil_v,   // (B, nq), CEIL; global index
                  const int32_t* __restrict__ ceil_i,
                  int nq, int nk, int c2, int ch, int k, int base) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * QB;

  // the running lists of this warp's rows
  WarpTopK<KS> lists[ROWS];
  load_running(lists, topv, topi, b, q0, nq, k);

  sweep<KS, CHUNK, CEIL, TC>(smem, qa + (size_t)b * nq * c2, ka + (size_t)b * nk * c2, nq, q0, c2,
                         ch, k, base, (nk + TB - 1) / TB, nk, [](int m) { return m * TB; },
                         [nk](int) { return make_int2(0, nk); },
                         CEIL ? ceil_v + (size_t)b * nq : nullptr,
                         CEIL ? ceil_i + (size_t)b * nq : nullptr, lists);

  store_running(lists, topv, topi, b, q0, nq, k);
}

// The Hopper TC ring step (csrc/knn_tc.cuh): a pass of k <= KMAX entries
// without a ceiling; `stages` the ring's depth (tc::stages_for). At k <= 32
// two blocks share an SM.
template <int KS>
__global__ void __launch_bounds__(tc::NT_TC, KS == 1 ? 2 : 1)
ring_tc_kernel(const __grid_constant__ CUtensorMap qmap,  // (B, nq, c2) bf16, resident queries
               const __grid_constant__ CUtensorMap kmap,  // (B, nk, c2) bf16, circulating block
               float* topv, int32_t* topi,                // (B, nq, k) running, in place
               int nq, int nk, int c2, int k, int base, int stages) {
  extern __shared__ uint8_t smem_raw[];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * QB;
  WarpTopK<KS> lists[ROWS];
  if (!tc::sweep<KS>(smem_raw, &qmap, &kmap, b, q0, nq, c2, k, base, (nk + tc::TBK - 1) / tc::TBK,
                     stages, [](int m) { return m * tc::TBK; },
                     [nk](int) { return make_int2(0, nk); },
                     [=](WarpTopK<KS>(&l)[ROWS]) { load_running(l, topv, topi, b, q0, nq, k); },
                     lists)) {
    return;
  }
  store_running(lists, topv, topi, b, q0, nq, k);
}

struct Launch {
  const void* qa;  // float, or bf16 bits with TC
  const void* ka;
  float* topv;
  int32_t* topi;
  const float* ceil_v;
  const int32_t* ceil_i;
  int batch, nq, nk, c2, ch, k, base;
  cudaStream_t stream;
};

template <int KS, bool CHUNK, bool CEIL, bool TC>
int launch(const Launch& a) {
  const size_t smem = bytes_of<TC>(a.c2, a.ch);
  // per device, so set on every launch (cheap host calls); the carveout
  // lets two blocks of the C = 64 size share an SM
  cudaError_t err = cudaFuncSetAttribute(ring_merge_kernel<KS, CHUNK, CEIL, TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ring_merge_kernel<KS, CHUNK, CEIL, TC>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.nq + QB - 1) / QB, a.batch);
  ring_merge_kernel<KS, CHUNK, CEIL, TC><<<grid, NT, smem, a.stream>>>(
      static_cast<const elem_t<TC>*>(a.qa), static_cast<const elem_t<TC>*>(a.ka), a.topv, a.topi, a.ceil_v, a.ceil_i, a.nq, a.nk, a.c2, a.ch, a.k, a.base);
  return (int)cudaGetLastError();
}

// One ring step of either score (see the extern functions below).
int step(const void* qa, const void* ka, float* topv, int32_t* topi, const float* ceil_v,
         const int32_t* ceil_i, int batch, int nq, int nk, int c2, int k, int base,
         cudaStream_t stream, bool tc) {
  if (batch < 1 || nq < 1 || nk < 1 || c2 < 1 || k < 1 || k > KMAX ||
      k > nk || batch > 65535 || base < 0 || ((ceil_v == nullptr) != (ceil_i == nullptr)) ||
      (tc && c2 % CPAD_TC != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  return with_precision(tc, [&](auto tc_) {
    constexpr bool TC = decltype(tc_)::value;
    const Launch a{qa, ka, topv, topi, ceil_v, ceil_i, batch, nq, nk, c2, chunk_of<TC>(c2, 0),
                   k, base, stream};
    return with_variant(k, a.ch > 0, ceil_v != nullptr, [&](auto ks, auto chunk, auto ceil) {
      return launch<decltype(ks)::value, decltype(chunk)::value, decltype(ceil)::value, TC>(a);
    });
  });
}

template <int KS>
int launch_tc(const Launch& a) {
  CUtensorMap qmap, kmap;
  if (!tc::make_maps(&qmap, &kmap, a.qa, a.ka, a.batch, a.nq, a.nk, a.c2)) {
    return (int)cudaErrorInvalidValue;
  }
  size_t smem = 0;
  cudaError_t err = tc::prepare((const void*)ring_tc_kernel<KS>, a.c2, &smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.nq + QB - 1) / QB, a.batch);
  ring_tc_kernel<KS><<<grid, tc::NT_TC, smem, a.stream>>>(qmap, kmap, a.topv, a.topi, a.nq, a.nk,
                                                          a.c2, a.k, a.base,
                                                          tc::stages_for(a.c2));
  return (int)cudaGetLastError();
}

// One ring step on the Hopper TC kernel (see dgcnn_ring_knn_step_tc).
int step_tc(const void* qa, const void* ka, float* topv, int32_t* topi, int batch, int nq,
            int nk, int c2, int k, int base, cudaStream_t stream) {
  if (batch < 1 || nq < 1 || nk < 1 || k > nk || batch > 65535 || base < 0 ||
      !tc::takes(qa, ka, c2, k)) {
    return (int)cudaErrorInvalidValue;
  }
  const Launch a{qa, ka, topv, topi, nullptr, nullptr, batch, nq, nk, c2, 0, k, base, stream};
  return k <= 32 ? launch_tc<1>(a) : launch_tc<2>(a);
}

}  // namespace

extern "C" {

int dgcnn_ring_knn_kmax() { return KMAX; }

int dgcnn_ring_knn_step_f32(const float* qa, const float* ka, float* topv,
                            int32_t* topi, const float* ceil_v, const int32_t* ceil_i,
                            int batch, int nq, int nk, int c2, int k, int base,
                            cudaStream_t stream) {
  return step(qa, ka, topv, topi, ceil_v, ceil_i, batch, nq, nk, c2, k, base, stream, false);
}

// The same step on the tensor cores: qa and ka bf16, c2 a multiple of 16.
int dgcnn_ring_knn_step_bf16(const void* qa, const void* ka, float* topv,
                             int32_t* topi, const float* ceil_v, const int32_t* ceil_i,
                             int batch, int nq, int nk, int c2, int k, int base,
                             cudaStream_t stream) {
  return step(qa, ka, topv, topi, ceil_v, ceil_i, batch, nq, nk, c2, k, base, stream, true);
}

// The same step on the Hopper TC kernel (csrc/knn_tc.cuh; one pass, no
// ceiling): qa and ka as for dgcnn_ring_knn_step_bf16, 16-byte aligned, c2
// <= dgcnn_ring_knn_tc_max_c2(), k <= KMAX.
int dgcnn_ring_knn_step_tc(const void* qa, const void* ka, float* topv, int32_t* topi, int batch,
                           int nq, int nk, int c2, int k, int base, cudaStream_t stream) {
  return step_tc(qa, ka, topv, topi, batch, nq, nk, c2, k, base, stream);
}

int dgcnn_ring_knn_tc_max_c2() { return tc::max_c2(); }

int dgcnn_ring_knn_chunk(int c2) {
  return c2 < 1 ? -(int)cudaErrorInvalidValue : sweep_chunk(c2, 0);
}

}  // extern "C"
