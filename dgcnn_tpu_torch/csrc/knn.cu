// Exact k-nearest-neighbour selection for the dynamic graph build, CUDA C++
// for sm_90a. Plain C interface, loaded with ctypes by kernels/knn_cuda.py.
//
// Replaces: dgcnn_tpu/kernels/knn_pallas.py::_knn_kernel (the Pallas TPU
// kernel behind knn_pallas and knn_pallas_cross).
//
// What it computes. For every query row i of one event and every key row j
// of the same event, the score
//     s_ij = sum_c qa[i, c] * ka[j, c]
// over the augmented operands that the wrapper builds
// (knn_cuda.build_augmented_operands):
//     qa_i = [2 x_i, -1, -1]     ka_j = [x_j, |x_j|^2, 1e30 (1 - mask_j)]
// so s_ij = 2<x_i, x_j> - |x_j|^2 - 1e30 (1 - mask_j) = |x_i|^2 - D_ij (minus
// 1e30 for a masked key). It keeps the k largest scores per query, ordered by
// score descending and, among equal scores, by key index ascending (the
// order of jax.lax.top_k and of the Pallas kernel). A slot whose score is
// <= -1e29 (a masked key, when the event has fewer than k valid keys) comes
// out as the self-edge min(i, nk - 1) with valid = 0. The cross form (nq !=
// nk, queries and keys from different rows) is the same launch.
//
// Each score is one fp32 FMA chain from 0 in ascending channel order, on the
// CUDA cores (knn_sweep.cuh).
//
// Two kernels compute it, chosen by shape alone
// (kernels/knn_cuda.py::f32_kernel_for): a pass of k <= KMAX without a
// ceiling at C + 2 <= 168 runs on the Hopper pipeline of knn_hopper.cuh
// (knn_topk_kernel_hopper, dgcnn_knn_topk_f32h: a TMA key ring that the
// warp releasing a stage last refills, no block-wide barrier, the filter
// in registers), and every other pass on the sweep below (knn_topk_kernel,
// dgcnn_knn_topk_f32). The two give the same bits; the sweep is the
// reference the card holds the Hopper kernel to.
//
// No tensor cores: the JAX reference scores at HIGHEST (fp32) precision
// and TF32 would change the graph. The ring and
// banded kernels score with the same chain, so the ring's graph equals this
// kernel's index for index and the banded graph at window >= N is this one.
//
// --knn_precision default (the Pallas kernel's Precision.DEFAULT, one bf16
// pass on the TPU's MXU) is the Hopper TC kernel (csrc/knn_tc.cuh,
// dgcnn_knn_topk_tc) for one pass of k <= KMAX at c2 <= its widest width,
// and else the sweep's TC instantiation, dgcnn_knn_topk_bf16:
// bf16 operands (rounded to nearest even by the wrapper), scored on the
// tensor cores with mma.sync.m16n8k16 and fp32 accumulators (knn_sweep.cuh,
// `sweep_tc`); the key split, the merge, the passes and the selection are
// the fp32 kernel's. The ring and banded TC instantiations share its
// fragment order, so the equalities above hold between the TC kernels too.
// Its bound: the same (2C + 2) operations a pair at the bf16 tensor cores'
// dense peak (989 TFLOP/s), 0.009 ms at the served batch, where bytes (a
// few us) come close: the selection, on the CUDA cores, is what is left.
//
// What bounds it on an H100. The function needs, per (query, valid key)
// pair, C fp32 FMAs, one subtract of the key's norm and one compare against
// the query's running k-th score: (2C + 2) * B * Nq * Nk_valid operations,
// 0.136 ms at B = 4, N = 4096, C = 64 and 67 TFLOP/s (fp32 on the CUDA
// cores, H100 SXM at 700 W). Its inputs and outputs are a few MB, about a
// microsecond at 3.35 TB/s. So it is bound by operations.
//
// What this design does about it (knn_sweep.cuh, warp_topk.cuh: the sweep
// of the ring and banded kernels).
// - The score loop: each thread scores an 8 x 4 micro-tile from three
//   128-bit shared loads per 32 FMAs; channels are padded to a multiple of
//   4 (C = 4: 8 channels; C = 64: 68); key tiles of 64 are staged by
//   cp.async into a double buffer under the previous tile's work.
// - The selection: each query's list lives across the 32 lanes of one warp,
//   in registers. A per-row filter against the row's k-th score lets a warp
//   test only the rows that may hold a winner; winners enter by ballot,
//   popcount and shuffles, or many at once by a bitonic merge (as when the
//   lists fill from empty on a split's first tile).
// - The grid. A block owns QB = 128 queries of one event, so a served
//   batch of 4 x 4096 points is 32 x 4 = 128 blocks, and an H100 SXM has
//   132 SMs, each holding two blocks of the k <= 32 instantiation (128
//   registers a thread, 109 KB of shared memory at C = 64): with one block
//   an SM, half the warps that hide the selection's latency would be
//   missing. So the key range is split: grid (query blocks, S, B), split s
//   sweeping key tiles [s T / S, (s + 1) T / S) of the T tiles into its own
//   lists, with global key indices. S = 1 writes the result directly; S > 1
//   writes (score, index) lists to a workspace (S, B, nq, k) that
//   knn_merge_kernel merges, one warp a query, into the result. Every test
//   compares (score, index), so S does not change one bit of the result.
//   Each split fills its lists from empty, so a row takes more inserts as S
//   grows (about k ln(N / (S k)) a split). The wrapper picks S
//   (kernels/knn_cuda.py::split_count) from the card's resident blocks,
//   dgcnn_knn_slots: the S in 1..8 (and <= T) whose grid takes the fewest
//   waves for a split's share of the keys, the smallest on a tie; S = 2 on
//   the served batch (256 blocks, one wave), S = 8 on one event alone (32
//   query blocks), S = 1 on the ring's 32,768-query cross form (256 query
//   blocks already).
// - The visit order: ascending. The served rows carry no order the filter
//   could use (the same rows shuffled take the same time), and visiting a
//   split's tiles outward from the block's own tile, as the banded kernel
//   does, timed the same; ascending order also keeps an event with fewer
//   than k valid points cheap, since its masked keys all score -1e30 and a
//   tie met in ascending index never displaces an entry.
// (kernel_variants.py times S and the order on the main path's inputs;
// PERF.md keeps the numbers.)
//
// Any C and any k <= Nk (knn_sweep.cuh): C + 2 > 180 sweeps the channels in
// chunks, and k > 64 runs in passes of at most 64 entries, each behind the
// previous pass's last entry (the ceiling); the wrapper concatenates the
// passes' raw lists (`raw`: true key indices in every slot) and finishes
// them once. The key split and its merge run inside each pass, unchanged.
//
// Lists in registers or shared memory: in registers. chip_smoke.py phase 2
// prints ptxas's report and fails on a spill or a stack frame (KS = 1 at two
// blocks an SM for the one-pass sweep without a ceiling, one otherwise).

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include "knn_hopper.cuh"
#include "knn_sweep.cuh"
#include "knn_tc.cuh"

namespace {

using namespace dgcnn;

constexpr int MAX_SPLITS = 8;  // the most key ranges a query block is split into

template <int KS, bool CHUNK, bool CEIL, bool TC>
__global__ void __launch_bounds__(NT, KS == 1 && !CHUNK && !CEIL ? 2 : 1)
knn_topk_kernel(const elem_t<TC>* __restrict__ qa,  // (B, nq, c2), bf16 with TC
                const elem_t<TC>* __restrict__ ka,  // (B, nk, c2)
                int32_t* __restrict__ idx_out,   // (B, nq, k), S = 1
                uint8_t* __restrict__ valid_out,
                float* __restrict__ score_out,
                float* __restrict__ part_v,      // (S, B, nq, k), S > 1
                int32_t* __restrict__ part_i,
                const float* __restrict__ ceil_v,  // (B, nq), CEIL
                const int32_t* __restrict__ ceil_i,
                int nq, int nk, int c2, int ch, int k, int raw) {
  extern __shared__ __align__(16) float smem[];
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * QB;
  const int tiles = (nk + TB - 1) / TB;
  const int t_lo = split * tiles / splits;
  const int ntiles = (split + 1) * tiles / splits - t_lo;

  WarpTopK<KS> lists[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      lists[r].v[s] = -FLT_MAX;
      lists[r].i[s] = INT_MAX;
    }
  }

  sweep<KS, CHUNK, CEIL, TC>(
      smem, qa + (size_t)b * nq * c2, ka + (size_t)b * nk * c2, nq, q0, c2, ch, k, 0, ntiles, nk,
      [=](int m) { return (t_lo + m) * TB; }, [nk](int) { return make_int2(0, nk); },
      CEIL ? ceil_v + (size_t)b * nq : nullptr, CEIL ? ceil_i + (size_t)b * nq : nullptr, lists);

  store_lists(lists, b, gridDim.z, split, q0, nq, nk, k, raw, idx_out, valid_out, score_out,
              part_v, part_i);
}

// The exact merge of the S splits' lists of each query, one warp a query:
// split 0's list becomes the warp's list, and every other split offers its
// entries 32 at a time; a split's list is sorted, so its first group with
// no entry ahead of the running k-th one ends it.
template <int KS>
__global__ void __launch_bounds__(NT)
knn_merge_kernel(const float* __restrict__ part_v,  // (S, rows, k)
                 const int32_t* __restrict__ part_i,
                 int32_t* __restrict__ idx_out,      // (rows, k), rows = B * nq
                 uint8_t* __restrict__ valid_out,
                 float* __restrict__ score_out,
                 int rows, int nq, int nk, int k, int splits, int raw) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * NWARP + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp
  const size_t stride = (size_t)rows * k;
  const size_t o = (size_t)row * k;
  WarpTopK<KS> list;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int slot = s * 32 + lane;
    list.v[s] = slot < k ? part_v[o + slot] : -FLT_MAX;
    list.i[s] = slot < k ? part_i[o + slot] : INT_MAX;
  }
  for (int p = 1; p < splits; ++p) {
#pragma unroll
    for (int g = 0; g < KS; ++g) {
      const int slot = g * 32 + lane;
      const bool in = slot < k;
      const float s = in ? part_v[p * stride + o + slot] : -FLT_MAX;
      const int j = in ? part_i[p * stride + o + slot] : INT_MAX;
      float kv;
      int ki;
      list.kth(k, kv, ki);
      const unsigned bal = __ballot_sync(FULL_MASK, in && ahead(s, j, kv, ki));
      if (!bal) break;
      list.take(k, lane, bal, s, j);
    }
  }
  const int q = row % nq;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int slot = s * 32 + lane;
    if (slot >= k) continue;
    const float v = list.v[s];
    const bool ok = v > INVALID_BELOW;
    idx_out[o + slot] = ok || raw ? list.i[s] : min(q, nk - 1);
    valid_out[o + slot] = ok ? 1 : 0;
    score_out[o + slot] = v;
  }
}

// per device, so set before every launch (cheap host calls); the carveout
// lets two blocks of the C = 64 size share an SM
template <int KS, bool CHUNK, bool CEIL, bool TC>
cudaError_t prepare(size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(knn_topk_kernel<KS, CHUNK, CEIL, TC>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(knn_topk_kernel<KS, CHUNK, CEIL, TC>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

struct Launch {
  const void* qa;  // float, or bf16 bits with TC
  const void* ka;
  int32_t* idx;
  uint8_t* valid;
  float* scores;
  float* part_v;
  int32_t* part_i;
  const float* ceil_v;
  const int32_t* ceil_i;
  int batch, nq, nk, c2, ch, k, splits, raw;
  cudaStream_t stream;
};

// the merge of a launch's S > 1 partial lists into its outputs
template <int KS>
int merge(const Launch& a) {
  const int rows = a.batch * a.nq;
  knn_merge_kernel<KS><<<(rows + NWARP - 1) / NWARP, NT, 0, a.stream>>>(
      a.part_v, a.part_i, a.idx, a.valid, a.scores, rows, a.nq, a.nk, a.k, a.splits, a.raw);
  return (int)cudaGetLastError();
}

template <int KS, bool CHUNK, bool CEIL, bool TC>
int launch(const Launch& a) {
  const size_t smem = bytes_of<TC>(a.c2, a.ch);
  cudaError_t err = prepare<KS, CHUNK, CEIL, TC>(smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.nq + QB - 1) / QB, a.splits, a.batch);
  knn_topk_kernel<KS, CHUNK, CEIL, TC><<<grid, NT, smem, a.stream>>>(
      static_cast<const elem_t<TC>*>(a.qa), static_cast<const elem_t<TC>*>(a.ka), a.idx, a.valid, a.scores, a.splits > 1 ? a.part_v : nullptr, a.part_i,
      a.ceil_v, a.ceil_i, a.nq, a.nk, a.c2, a.ch, a.k, a.raw);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  return merge<KS>(a);
}

template <int KS, bool CHUNK, bool CEIL, bool TC>
int slots(int c2, int ch) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = bytes_of<TC>(c2, ch);
  if (err == cudaSuccess) err = prepare<KS, CHUNK, CEIL, TC>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, knn_topk_kernel<KS, CHUNK, CEIL, TC>, NT, smem);
  if (err != cudaSuccess) return -(int)err;
  return sms * per_sm;
}

// One pass of either score (see the extern functions below).
int topk(const void* qa, const void* ka, int32_t* idx, uint8_t* valid, float* scores,
         float* part_v, int32_t* part_i, const float* ceil_v, const int32_t* ceil_i, int batch,
         int nq, int nk, int c2, int k, int splits, int raw, cudaStream_t stream, bool tc) {
  if (batch < 1 || nq < 1 || nk < 1 || c2 < 1 || k < 1 || k > KMAX ||
      k > nk || batch > 65535 || (long long)batch * nq > INT_MAX ||
      (tc && c2 % CPAD_TC != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (splits < 1 || splits > MAX_SPLITS || splits > (nk + TB - 1) / TB ||
      (splits > 1 && (part_v == nullptr || part_i == nullptr)) ||
      ((ceil_v == nullptr) != (ceil_i == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  return with_precision(tc, [&](auto tc_) {
    constexpr bool TC = decltype(tc_)::value;
    const Launch a{qa,    ka, idx, valid,  scores,   part_v, part_i, ceil_v, ceil_i,
                   batch, nq, nk,  c2,     chunk_of<TC>(c2, 0), k, splits, raw, stream};
    return with_variant(k, a.ch > 0, ceil_v != nullptr, [&](auto ks, auto chunk, auto ceil) {
      return launch<decltype(ks)::value, decltype(chunk)::value, decltype(ceil)::value, TC>(a);
    });
  });
}

int slots_of(int c2, int k, int ceil, bool tc) {
  if (c2 < 1 || k < 1 || k > KMAX || (tc && c2 % CPAD_TC != 0)) {
    return -(int)cudaErrorInvalidValue;
  }
  return with_precision(tc, [&](auto tc_) {
    constexpr bool TC = decltype(tc_)::value;
    const int ch = chunk_of<TC>(c2, 0);
    return with_variant(k, ch > 0, ceil != 0, [&](auto ks, auto chunk, auto ce) {
      return slots<decltype(ks)::value, decltype(chunk)::value, decltype(ce)::value, TC>(c2, ch);
    });
  });
}

// ---- the Hopper TC kernel (knn_tc.cuh): a pass of k <= KMAX entries
// without a ceiling at c2 <= tc::max_c2(); the key split and the merge as
// above, over tiles of tc::TBK keys.
template <int KS>
int launch_tc(const Launch& a) {
  CUtensorMap qmap, kmap;
  if (!tc::make_maps(&qmap, &kmap, a.qa, a.ka, a.batch, a.nq, a.nk, a.c2)) {
    return (int)cudaErrorInvalidValue;
  }
  size_t smem = 0;
  cudaError_t err = tc::prepare((const void*)tc::knn_tc_kernel<KS>, a.c2, &smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.nq + QB - 1) / QB, a.splits, a.batch);
  tc::knn_tc_kernel<KS><<<grid, tc::NT_TC, smem, a.stream>>>(
      qmap, kmap, a.idx, a.valid, a.scores, a.splits > 1 ? a.part_v : nullptr, a.part_i, a.nq,
      a.nk, a.c2, a.k, a.raw, tc::stages_for(a.c2));
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  return merge<KS>(a);
}

int topk_tc(const void* qa, const void* ka, int32_t* idx, uint8_t* valid, float* scores,
            float* part_v, int32_t* part_i, int batch, int nq, int nk, int c2, int k, int splits,
            int raw, cudaStream_t stream) {
  if (batch < 1 || nq < 1 || nk < 1 || k > nk || batch > 65535 ||
      (long long)batch * nq > INT_MAX || !tc::takes(qa, ka, c2, k)) {
    return (int)cudaErrorInvalidValue;
  }
  if (splits < 1 || splits > MAX_SPLITS || splits > (nk + tc::TBK - 1) / tc::TBK ||
      (splits > 1 && (part_v == nullptr || part_i == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const Launch a{qa, ka, idx, valid, scores, part_v, part_i, nullptr, nullptr,
                 batch, nq, nk, c2, 0, k, splits, raw, stream};
  return k <= 32 ? launch_tc<1>(a) : launch_tc<2>(a);
}

int slots_tc(int c2, int k) {
  if (c2 < tc::KSTEP || c2 % tc::KSTEP != 0 || tc::stages_for(c2) == 0 || k < 1 || k > KMAX) {
    return -(int)cudaErrorInvalidValue;
  }
  const void* fn = k <= 32 ? (const void*)tc::knn_tc_kernel<1> : (const void*)tc::knn_tc_kernel<2>;
  size_t smem = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = tc::prepare(fn, c2, &smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, tc::NT_TC, smem);
  if (err != cudaSuccess) return -(int)err;
  return per_sm > 0 ? sms : 0;
}

// ---- the Hopper fp32 kernel (knn_hopper.cuh): a pass of k <= KMAX entries
// without a ceiling at c2 <= f32h::max_c2() (a multiple of CPAD); the key
// split and the merge as the sweep's, over tiles of f32h::TBK keys.
template <int KS>
int launch_f32h(const Launch& a) {
  CUtensorMap qmap, kmap;
  if (!f32h::make_map(&qmap, a.qa, a.batch, a.nq, a.c2, QB) ||
      !f32h::make_map(&kmap, a.ka, a.batch, a.nk, a.c2, f32h::TBK)) {
    return (int)cudaErrorInvalidValue;
  }
  size_t smem = 0;
  cudaError_t err = f32h::prepare((const void*)f32h::knn_topk_kernel_hopper<KS>, a.c2, &smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.nq + QB - 1) / QB, a.splits, a.batch);
  f32h::knn_topk_kernel_hopper<KS><<<grid, f32h::NT_H, smem, a.stream>>>(
      qmap, kmap, a.idx, a.valid, a.scores, a.splits > 1 ? a.part_v : nullptr, a.part_i, a.nq,
      a.nk, a.c2, a.k, a.raw, f32h::stages_for(a.c2));
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  return merge<KS>(a);
}

int topk_f32h(const float* qa, const float* ka, int32_t* idx, uint8_t* valid, float* scores,
              float* part_v, int32_t* part_i, int batch, int nq, int nk, int c2, int k,
              int splits, int raw, cudaStream_t stream) {
  if (batch < 1 || nq < 1 || nk < 1 || k > nk || batch > 65535 ||
      (long long)batch * nq > INT_MAX || !f32h::takes(qa, ka, c2, k)) {
    return (int)cudaErrorInvalidValue;
  }
  if (splits < 1 || splits > MAX_SPLITS || splits > (nk + f32h::TBK - 1) / f32h::TBK ||
      (splits > 1 && (part_v == nullptr || part_i == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const Launch a{qa, ka, idx, valid, scores, part_v, part_i, nullptr, nullptr,
                 batch, nq, nk, c2, 0, k, splits, raw, stream};
  return k <= 32 ? launch_f32h<1>(a) : launch_f32h<2>(a);
}

int slots_f32h(int c2, int k) {
  if (c2 < CPAD || c2 % CPAD != 0 || f32h::stages_for(c2) == 0 || k < 1 || k > KMAX) {
    return -(int)cudaErrorInvalidValue;
  }
  const void* fn = k <= 32 ? (const void*)f32h::knn_topk_kernel_hopper<1>
                           : (const void*)f32h::knn_topk_kernel_hopper<2>;
  size_t smem = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = f32h::prepare(fn, c2, &smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, f32h::NT_H, smem);
  if (err != cudaSuccess) return -(int)err;
  return sms * per_sm;
}

}  // namespace

extern "C" {

int dgcnn_knn_kmax() { return KMAX; }

int dgcnn_knn_max_splits() { return MAX_SPLITS; }

// One pass on `stream` (k <= KMAX entries); returns a CUDA error code, 0
// when the launch was accepted. All pointers are device pointers to
// contiguous arrays. With `splits` > 1 the key range is split that many
// ways and part_v (f32) and part_i (i32), (splits, batch, nq, k) each, are
// the workspace of the partial lists; with splits = 1 they are not read.
// ceil_v (f32) and ceil_i (i32), (batch, nq) each or both null: each row's
// ceiling, a key entering only behind it. raw != 0: every slot keeps its
// key index (the wrapper finishes the passes); 0: a slot scoring <= -1e29
// becomes the self-edge min(q, nk - 1).
int dgcnn_knn_topk_f32(const float* qa, const float* ka, int32_t* idx,
                       uint8_t* valid, float* scores, float* part_v,
                       int32_t* part_i, const float* ceil_v, const int32_t* ceil_i,
                       int batch, int nq, int nk, int c2, int k, int splits, int raw,
                       cudaStream_t stream) {
  return topk(qa, ka, idx, valid, scores, part_v, part_i, ceil_v, ceil_i, batch, nq, nk, c2, k,
              splits, raw, stream, false);
}

// The same pass on the tensor cores: qa and ka are bf16 (B, nq, c2) and
// (B, nk, c2), c2 a multiple of 16 (channels padded with zeros).
int dgcnn_knn_topk_bf16(const void* qa, const void* ka, int32_t* idx,
                        uint8_t* valid, float* scores, float* part_v,
                        int32_t* part_i, const float* ceil_v, const int32_t* ceil_i,
                        int batch, int nq, int nk, int c2, int k, int splits, int raw,
                        cudaStream_t stream) {
  return topk(qa, ka, idx, valid, scores, part_v, part_i, ceil_v, ceil_i, batch, nq, nk, c2, k,
              splits, raw, stream, true);
}

// The same pass on the Hopper TC kernel (knn_tc.cuh; no ceiling): qa and
// ka as for dgcnn_knn_topk_bf16, 16-byte aligned, c2 <= dgcnn_knn_tc_max_c2(),
// splits <= ceil(nk / dgcnn_knn_tc_tile()).
int dgcnn_knn_topk_tc(const void* qa, const void* ka, int32_t* idx, uint8_t* valid,
                      float* scores, float* part_v, int32_t* part_i, int batch, int nq, int nk,
                      int c2, int k, int splits, int raw, cudaStream_t stream) {
  return topk_tc(qa, ka, idx, valid, scores, part_v, part_i, batch, nq, nk, c2, k, splits, raw,
                 stream);
}

// The same fp32 pass on the Hopper pipeline (knn_hopper.cuh; no ceiling):
// qa and ka f32 (B, nq, c2) and (B, nk, c2), c2 a multiple of 4 (channels
// padded with zeros) and <= dgcnn_knn_f32h_max_c2(), 16-byte aligned;
// splits <= ceil(nk / 64). Returns a CUDA error code, 0 when accepted.
int dgcnn_knn_topk_f32h(const float* qa, const float* ka, int32_t* idx, uint8_t* valid,
                        float* scores, float* part_v, int32_t* part_i, int batch, int nq, int nk,
                        int c2, int k, int splits, int raw, cudaStream_t stream) {
  return topk_f32h(qa, ka, idx, valid, scores, part_v, part_i, batch, nq, nk, c2, k, splits, raw,
                   stream);
}

// The blocks of the Hopper fp32 kernel for (c2, k) that the current device
// holds at once (its key split, kernels/knn_cuda.py::split_count).
// Negative: minus a CUDA error code.
int dgcnn_knn_slots_f32h(int c2, int k) { return slots_f32h(c2, k); }

// The widest padded c2 the Hopper fp32 kernel takes.
int dgcnn_knn_f32h_max_c2() { return f32h::max_c2(); }

// The SMs of the current device that hold a block of the Hopper TC kernel
// for (c2, k): all of them, or 0 if a block does not fit an SM (its key
// split counts SMs, kernels/knn_cuda.py::split_count_idle). Negative: minus
// a CUDA error code.
int dgcnn_knn_slots_tc(int c2, int k) { return slots_tc(c2, k); }

// The widest padded c2 and the key tile of the Hopper TC kernel.
int dgcnn_knn_tc_max_c2() { return tc::max_c2(); }

int dgcnn_knn_tc_tile() { return tc::TBK; }

// The blocks of the sweep kernel for (c2, k, a ceiling or not) that the
// current device holds at once: its SMs times the blocks an SM takes.
// Negative: minus a CUDA error code.
int dgcnn_knn_slots(int c2, int k, int ceil) { return slots_of(c2, k, ceil, false); }

// The same for the TC kernel (c2 the padded width).
int dgcnn_knn_slots_bf16(int c2, int k, int ceil) { return slots_of(c2, k, ceil, true); }

// The channel chunk of the sweep for C + 2 = c2 (0: one pass).
int dgcnn_knn_chunk(int c2) { return c2 < 1 ? -(int)cudaErrorInvalidValue : sweep_chunk(c2, 0); }

}  // extern "C"
