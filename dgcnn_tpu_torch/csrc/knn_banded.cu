// Banded k-nearest-neighbour selection over Morton-sorted points, CUDA C++
// for sm_90a. Plain C interface, loaded with ctypes by
// kernels/knn_banded_cuda.py.
//
// Replaces: dgcnn_tpu/kernels/knn_banded.py::_banded_kernel (the Pallas TPU
// kernel behind knn_pallas_banded and knn_pallas_banded_cross).
//
// What it computes. Points arrive sorted along a Z-order curve, padded
// points last. Query row r of event b sits at global sorted position
// q_base + r, key row j at key_base + j (both bases are 0 on the
// single-device path; the cross form's offsets serve halo context
// parallelism). Each query scores only the keys at global positions
// [lo, lo + window), lo = band_lo(q_base + r, nvalid_b, window), with the
// exact kernel's single contraction of augmented operands
// (knn_cuda.build_augmented_operands):
//     qa_i = [2 x_i, -1, -1]     ka_j = [x_j, |x_j|^2, 1e30 (1 - mask_j)]
// so s_ij = |x_i|^2 - D_ij (minus 1e30 for a masked key). It keeps the k
// largest in-band scores per query, by score descending and, among equal
// scores, key index ascending (jax.lax.top_k's order). Out-of-band keys
// never enter a list. A slot whose score is <= -1e29 (fewer than k valid
// in-band keys) comes out as the self-edge q_base + r with valid = 0.
// Returned indices are global: key-local plus key_base.
//
// Each score is one fp32 FMA chain in ascending channel order, on the CUDA
// cores, no TF32 (knn_sweep.cuh): the exact kernel's bits, so with
// window >= N the graph is the exact graph.
// --knn_precision default scores bf16 operands on the tensor cores with
// the exact TC kernel's chain of 16-channel steps, and so its bits; its
// bound is the same operations at the bf16 tensor cores' dense peak (989
// TFLOP/s). A pass of k <= KMAX without a ceiling at c2 <= tc::max_c2()
// runs the Hopper kernel below (dgcnn_knn_banded_tc, csrc/knn_tc.cuh's
// pipeline); the later passes of k > KMAX and wider channels run the
// sweep's TC instantiation (dgcnn_knn_banded_bf16, `sweep_tc`), the bit
// reference. The Hopper pass keeps this kernel's block range, visit order
// and row windows: its producer loads the key tiles by TMA in the outward
// order (a tile's first key, t_begin + 64 outward(m), need not be a
// multiple of 64: TMA takes any row and zero-fills past nk), and each
// consumer thread keeps its two rows' windows in registers, where the
// filter and the exact test apply them.
//
// What bounds it on an H100. Per (query, in-band valid key) pair the
// function needs C FMAs, one subtract and one compare, (2C + 2) operations;
// a query has at most `window` candidates, so the work is O(N * window)
// rather than O(N^2). Inputs and outputs move once: x, idx and valid, a few
// hundred MB at a million points. So it is bound by fp32 operations on the
// CUDA cores (67 TFLOP/s on an H100 SXM at 700 W).
//
// What this design does about it (knn_sweep.cuh, warp_topk.cuh).
// - A block of QB = 128 consecutive queries sweeps only the key range
//   [band_lo(first row), band_lo(last row) + window), shifted by key_base
//   and clamped to the key array: lo is monotone in position, so that range
//   covers every row's window. It is about window + QB keys, ~130 tiles of
//   64 at window = 8192, not N. An empty range is allowed.
// - The score loop: 8 x 4 scores a thread from three 128-bit shared loads
//   per 32 FMAs, channels padded to a multiple of 4, key tiles staged by
//   cp.async into a double buffer.
// - The selection: each query's list across one warp's lanes, in
//   registers. Each thread flags the rows where one of its scores reaches
//   the row's bar (the k-th score, in shared memory); a warp tests only the
//   flagged rows exactly, with the row's in-band test as a mask on the
//   ballot, and inserts the winners by popcount and shuffles, or merges
//   many at once by a bitonic network (the first tile, where the lists
//   fill). On the main path a row is flagged on about 6 of its ~130 tiles.
// - The tile holding the block's middle row is visited first, then the
//   others outward from it, alternating sides (`outward`). On sorted points
//   the nearest keys sit near the diagonal, so the lists' bar is high
//   before the far tiles are offered and few of their columns win. The
//   Pallas kernel's order (the diagonal tile, then the rest ascending,
//   knn_banded.py::tile_at) makes every tile below the diagonal approach
//   the query, so more keys win on the way (kernel_variants.py times both
//   orders on the main path's inputs; PERF.md keeps the numbers). The
//   (score, index) order of every test makes the result independent of the
//   visit order.
//
// Every address is computed in size_t: at a million points B * N * (C + 2)
// and N * window exceed 2^31.
//
// Any C and any k <= window (knn_sweep.cuh): wide C sweeps the channels in
// chunks, and k > 64 runs in passes of at most 64 entries behind the
// previous pass's last entry; `raw` keeps every slot's key index for the
// wrapper, which finishes the passes once. The row ranges stay as they are.
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

constexpr float INVALID_BELOW = -1e29f;
constexpr size_t RANGES_BYTES = QB * sizeof(int2);  // the kernel's static shared memory

// The window expression of dgcnn_tpu/ops/knn.py:88 (band_lo), written once
// here: the first candidate position of a query at global sorted position
// `pos`, clip(pos - window / 2, 0, max(nvalid - window, 0)).
__device__ __forceinline__ int band_lo(int pos, int nvalid, int window) {
  const int hi = max(nvalid - window, 0);
  return min(max(pos - window / 2, 0), hi);
}

// The m-th tile to visit of `ntiles`, outward from the diagonal tile:
// diag, diag - 1, diag + 1, diag - 2, ..., then the rest of the longer
// side, nearest first.
__device__ __forceinline__ int outward(int m, int diag, int ntiles) {
  const int below = diag;
  const int above = ntiles - 1 - diag;
  const int both = 2 * min(below, above);
  if (m <= both) return (m & 1) ? diag - (m + 1) / 2 : diag + m / 2;
  const int d = min(below, above) + (m - both);
  return below > above ? diag - d : diag + d;
}

// A block's key range, key-local: from the first row's window start to the
// last row's window end, clamped to the key array (may be empty), in tiles
// of T keys (the sweeps' TB, the Hopper kernel's tc::TBK), and the tile
// holding the middle row's own position (visited first)
struct Band {
  int t_begin, t_end, ntiles, diag;
};

template <int T>
__device__ __forceinline__ Band band_of(int q0, int nq, int nk, int nv, int window, int q_base,
                                        int key_base) {
  Band r;
  const int last = min(q0 + QB, nq) - 1;
  r.t_begin = min(max(band_lo(q_base + q0, nv, window) - key_base, 0), nk);
  r.t_end = min(max(band_lo(q_base + last, nv, window) + window - key_base, 0), nk);
  r.ntiles = (r.t_end - r.t_begin + T - 1) / T;
  const int mid = min(max(q_base + q0 + QB / 2 - key_base, r.t_begin), r.t_end - 1);
  r.diag = r.ntiles > 0 ? (mid - r.t_begin) / T : 0;
  return r;
}

// the m-th tile's first key: the tiles outward from the diagonal
template <int T>
__device__ __forceinline__ int band_tile(int m, const Band& band) {
  return band.t_begin + outward(m, band.diag, band.ntiles) * T;
}

// block row `row`'s window, key-local, clamped to the block's range
__device__ __forceinline__ int2 row_window(int row, const Band& band, int q0, int nv, int window,
                                           int q_base, int key_base) {
  const int lo = band_lo(q_base + q0 + row, nv, window) - key_base;
  return make_int2(lo, min(lo + window, band.t_end));
}

// this warp's lists (rows q0 + 16 warp + r of event b) into the outputs:
// global indices, and the self-edge q_base + q for a slot scoring <=
// INVALID_BELOW unless raw
template <int KS>
__device__ __forceinline__ void store_banded(const WarpTopK<KS> (&lists)[ROWS], int b, int q0,
                                             int nq, int k, int q_base, int key_base, int raw,
                                             int32_t* idx_out, uint8_t* valid_out,
                                             float* score_out) {
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
        const float v = lists[r].v[s];
        const bool ok = v > INVALID_BELOW;
        idx_out[o + slot] = ok || raw ? key_base + lists[r].i[s] : q_base + q;
        valid_out[o + slot] = ok ? 1 : 0;
        score_out[o + slot] = v;
      }
    }
  }
}

template <int KS, bool CHUNK, bool CEIL, bool TC>
__global__ void __launch_bounds__(NT, KS == 1 && !CHUNK && !CEIL ? 2 : 1)
knn_banded_kernel(const elem_t<TC>* __restrict__ qa,  // (B, nq, c2), bf16 with TC
                  const elem_t<TC>* __restrict__ ka,  // (B, nk, c2)
                  const int32_t* __restrict__ nvalid, // (B,)
                  int32_t* __restrict__ idx_out,      // (B, nq, k)
                  uint8_t* __restrict__ valid_out,
                  float* __restrict__ score_out,
                  const float* __restrict__ ceil_v,   // (B, nq), CEIL; key-local index
                  const int32_t* __restrict__ ceil_i,
                  int nq, int nk, int c2, int ch, int k, int window, int q_base,
                  int key_base, int raw) {
  extern __shared__ __align__(16) float smem[];
  // each row's window, key-local and clamped to the block's range: read
  // from here, the band's inputs need no registers during the sweep
  __shared__ int2 ranges[QB];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * QB;
  const int nv = nvalid[b];
  const Band band = band_of<TB>(q0, nq, nk, nv, window, q_base, key_base);
  if (threadIdx.x < QB) {  // read after the sweep's first __syncthreads
    ranges[threadIdx.x] = row_window(threadIdx.x, band, q0, nv, window, q_base, key_base);
  }

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
      smem, qa + (size_t)b * nq * c2, ka + (size_t)b * nk * c2, nq, q0, c2, ch, k, 0, band.ntiles,
      band.t_end, [=](int m) { return band_tile<TB>(m, band); },
      [](int row) { return ranges[row]; }, CEIL ? ceil_v + (size_t)b * nq : nullptr,
      CEIL ? ceil_i + (size_t)b * nq : nullptr, lists);

  store_banded(lists, b, q0, nq, k, q_base, key_base, raw, idx_out, valid_out, score_out);
}

// The Hopper TC banded pass (csrc/knn_tc.cuh): a pass of k <= KMAX entries
// without a ceiling over the same block range, visit order and row
// windows; `stages` the ring's depth (tc::stages_for). At k <= 32 two
// blocks share an SM.
template <int KS>
__global__ void __launch_bounds__(tc::NT_TC, KS == 1 ? 2 : 1)
banded_tc_kernel(const __grid_constant__ CUtensorMap qmap,  // (B, nq, c2) bf16
                 const __grid_constant__ CUtensorMap kmap,  // (B, nk, c2) bf16
                 const int32_t* __restrict__ nvalid,        // (B,)
                 int32_t* __restrict__ idx_out, uint8_t* __restrict__ valid_out,
                 float* __restrict__ score_out, int nq, int nk, int c2, int k, int window,
                 int q_base, int key_base, int raw, int stages) {
  extern __shared__ uint8_t smem_raw[];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * QB;
  const int nv = nvalid[b];
  const Band band = band_of<tc::TBK>(q0, nq, nk, nv, window, q_base, key_base);
  WarpTopK<KS> lists[ROWS];
  if (!tc::sweep<KS>(
          smem_raw, &qmap, &kmap, b, q0, nq, c2, k, 0, band.ntiles, stages,
          [=](int m) { return band_tile<tc::TBK>(m, band); },
          [=](int row) { return row_window(row, band, q0, nv, window, q_base, key_base); },
          tc::FillEmpty{}, lists)) {
    return;
  }
  store_banded(lists, b, q0, nq, k, q_base, key_base, raw, idx_out, valid_out, score_out);
}

struct Launch {
  const void* qa;  // float, or bf16 bits with TC
  const void* ka;
  const int32_t* nvalid;
  int32_t* idx;
  uint8_t* valid;
  float* scores;
  const float* ceil_v;
  const int32_t* ceil_i;
  int batch, nq, nk, c2, ch, k, window, q_base, key_base, raw;
  cudaStream_t stream;
};

template <int KS, bool CHUNK, bool CEIL, bool TC>
int launch(const Launch& a) {
  const size_t smem = bytes_of<TC>(a.c2, a.ch);
  // per device, so set on every launch (cheap host calls); the carveout
  // lets two blocks of the C = 64 size share an SM
  cudaError_t err = cudaFuncSetAttribute(knn_banded_kernel<KS, CHUNK, CEIL, TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(knn_banded_kernel<KS, CHUNK, CEIL, TC>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.nq + QB - 1) / QB, a.batch);
  knn_banded_kernel<KS, CHUNK, CEIL, TC><<<grid, NT, smem, a.stream>>>(
      static_cast<const elem_t<TC>*>(a.qa), static_cast<const elem_t<TC>*>(a.ka), a.nvalid, a.idx, a.valid, a.scores, a.ceil_v, a.ceil_i, a.nq, a.nk, a.c2, a.ch,
      a.k, a.window, a.q_base, a.key_base, a.raw);
  return (int)cudaGetLastError();
}

// One pass of either score (see the extern functions below).
int banded(const void* qa, const void* ka, const int32_t* nvalid, int32_t* idx, uint8_t* valid,
           float* scores, const float* ceil_v, const int32_t* ceil_i, int batch, int nq, int nk,
           int c2, int k, int window, int q_base, int key_base, int raw, cudaStream_t stream,
           bool tc) {
  if (batch < 1 || nq < 1 || nk < 1 || c2 < 1 || k < 1 || k > KMAX ||
      k > nk || window < k || batch > 65535 || q_base < 0 || key_base < 0 ||
      ((ceil_v == nullptr) != (ceil_i == nullptr)) || (tc && c2 % CPAD_TC != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  return with_precision(tc, [&](auto tc_) {
    constexpr bool TC = decltype(tc_)::value;
    const Launch a{qa, ka, nvalid, idx, valid, scores, ceil_v, ceil_i, batch, nq, nk, c2,
                   chunk_of<TC>(c2, RANGES_BYTES), k, window, q_base, key_base, raw, stream};
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
  cudaError_t err = tc::prepare((const void*)banded_tc_kernel<KS>, a.c2, &smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.nq + QB - 1) / QB, a.batch);
  banded_tc_kernel<KS><<<grid, tc::NT_TC, smem, a.stream>>>(
      qmap, kmap, a.nvalid, a.idx, a.valid, a.scores, a.nq, a.nk, a.c2, a.k, a.window, a.q_base,
      a.key_base, a.raw, tc::stages_for(a.c2));
  return (int)cudaGetLastError();
}

// One pass on the Hopper TC kernel (see dgcnn_knn_banded_tc).
int banded_tc(const void* qa, const void* ka, const int32_t* nvalid, int32_t* idx, uint8_t* valid,
              float* scores, int batch, int nq, int nk, int c2, int k, int window, int q_base,
              int key_base, int raw, cudaStream_t stream) {
  if (batch < 1 || nq < 1 || nk < 1 || k > nk || window < k || batch > 65535 || q_base < 0 ||
      key_base < 0 || !tc::takes(qa, ka, c2, k)) {
    return (int)cudaErrorInvalidValue;
  }
  const Launch a{qa, ka, nvalid, idx, valid, scores, nullptr, nullptr, batch, nq, nk, c2, 0, k,
                 window, q_base, key_base, raw, stream};
  return k <= 32 ? launch_tc<1>(a) : launch_tc<2>(a);
}

}  // namespace

extern "C" {

int dgcnn_knn_banded_kmax() { return KMAX; }

int dgcnn_knn_banded_f32(const float* qa, const float* ka, const int32_t* nvalid,
                         int32_t* idx, uint8_t* valid, float* scores, const float* ceil_v,
                         const int32_t* ceil_i, int batch, int nq, int nk, int c2, int k,
                         int window, int q_base, int key_base, int raw, cudaStream_t stream) {
  return banded(qa, ka, nvalid, idx, valid, scores, ceil_v, ceil_i, batch, nq, nk, c2, k, window,
                q_base, key_base, raw, stream, false);
}

// The same pass on the tensor cores: qa and ka bf16, c2 a multiple of 16.
int dgcnn_knn_banded_bf16(const void* qa, const void* ka, const int32_t* nvalid,
                          int32_t* idx, uint8_t* valid, float* scores, const float* ceil_v,
                          const int32_t* ceil_i, int batch, int nq, int nk, int c2, int k,
                          int window, int q_base, int key_base, int raw, cudaStream_t stream) {
  return banded(qa, ka, nvalid, idx, valid, scores, ceil_v, ceil_i, batch, nq, nk, c2, k, window,
                q_base, key_base, raw, stream, true);
}

// The same pass on the Hopper TC kernel (csrc/knn_tc.cuh; one pass, no
// ceiling): qa and ka as for dgcnn_knn_banded_bf16, 16-byte aligned, c2 <=
// dgcnn_knn_banded_tc_max_c2(), k <= KMAX.
int dgcnn_knn_banded_tc(const void* qa, const void* ka, const int32_t* nvalid, int32_t* idx,
                        uint8_t* valid, float* scores, int batch, int nq, int nk, int c2, int k,
                        int window, int q_base, int key_base, int raw, cudaStream_t stream) {
  return banded_tc(qa, ka, nvalid, idx, valid, scores, batch, nq, nk, c2, k, window, q_base,
                   key_base, raw, stream);
}

int dgcnn_knn_banded_tc_max_c2() { return tc::max_c2(); }

int dgcnn_knn_banded_chunk(int c2) {
  return c2 < 1 ? -(int)cudaErrorInvalidValue : sweep_chunk(c2, RANGES_BYTES);
}

}  // extern "C"
