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
// out as the self-edge min(i, nk - 1) with valid = 0.
//
// Each score is one fp32 FMA chain in ascending channel order, on the CUDA
// cores. No tensor cores: the JAX reference scores at HIGHEST (fp32)
// precision and TF32 would change the graph.
//
// What bounds it on an H100. The function needs, per (query, valid key)
// pair, C fp32 FMAs, one subtract of the key's norm and one compare against
// the query's running k-th score: (2C + 2) * B * Nq * Nk_valid operations
// (a masked key can be skipped). This design spends C + 2 FMAs a pair, the
// two augmented columns included, and scores masked keys too. Its inputs and
// outputs are a few MB. So it is bound by operations on the fp32 CUDA cores
// (67 TFLOP/s on an H100 SXM at 700 W, FMA counted as two), not by memory.
// The selection, not the FMAs, is what a simple design spends its time on:
// a sorted insert is a serial walk with divergent lanes.
//
// What this design does about it. A block owns QB = 64 queries of one event
// and keeps their augmented rows in shared memory for the whole sweep. It
// walks the keys in tiles of TB = 64: 256 threads compute the 64 x 64 score
// tile as a register-blocked product (4 x 4 scores a thread, key channels
// staged CK = 16 at a time), and write it to shared memory. Then each query
// has SPLIT = 4 threads, each scanning its own 16 of the tile's 64 columns
// against a register copy of its list's k-th score; only a score that beats
// it walks that thread's sorted list. Four short lists a query give four
// times the threads of one list a query, to hide the latency of the walk,
// and the lists live in shared memory, slot-major, so a walk step costs a
// conflict-free shared-memory access. (With the lists in local memory they
// fell out of L1 and the kernel took 3.7 ms instead of 1.4 ms a launch at
// B=4, N=4096, C=64, k=20 on an H100 80GB HBM3 at 700 W, as chip_smoke.py
// measures it on a served forward's inputs.) After the sweep one thread a
// query merges its four lists by (score desc, index asc). Keys reach each
// list in ascending index order, so a strict '>' keeps the lower index
// ahead of an equal score within a list, and the merge keeps it across
// lists. Open for later work: warp-cooperative selection and overlapped
// tile loads.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int QB = 64;               // queries per block
constexpr int TB = 64;               // keys per tile
constexpr int CK = 16;               // key channels per staged chunk
constexpr int NT = 256;              // threads per block
constexpr int SPLIT = NT / QB;       // lists (selecting threads) per query
constexpr int COLS = TB / SPLIT;     // tile columns each list scans
constexpr int KMAX = 64;             // largest k the kernel accepts
constexpr int SMEM_LIMIT = 232448;   // shared memory a block may use (sm_90)
constexpr float INVALID_BELOW = -1e29f;

static_assert(NT == 256 && QB == 64 && TB == 64, "16 x 16 threads, 4 x 4 scores each");

struct StaticSmem {
  float ks[CK][TB + 1];
  float st[QB][TB + 1];
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// dynamic shared memory: the query block's rows [c2p][QB + 1], then every
// thread's sorted list, values and indices [k][NT] each (slot-major, so the
// lanes of a warp hit distinct banks whatever slots they touch)
__host__ __device__ inline size_t dynamic_smem_bytes(int c2, int k) {
  const size_t rows = (size_t)round_up(c2, CK) * (QB + 1) * sizeof(float);
  const size_t lists = (size_t)NT * k * (sizeof(float) + sizeof(int));
  return rows + lists;
}

__global__ void __launch_bounds__(NT)
knn_topk_kernel(const float* __restrict__ qa,   // (B, nq, c2)
                const float* __restrict__ ka,   // (B, nk, c2)
                int32_t* __restrict__ idx_out,  // (B, nq, k)
                uint8_t* __restrict__ valid_out,
                float* __restrict__ score_out,
                int nq, int nk, int c2, int k) {
  __shared__ StaticSmem sm;
  extern __shared__ float dyn[];

  const int tid = threadIdx.x;
  const int tx = tid % 16;       // key columns tx + 16 j of the micro-tile
  const int ty = tid / 16;       // query rows ty + 16 i of the micro-tile
  const int ql = tid % QB;       // the query this thread selects for
  const int part = tid / QB;     // which quarter of each tile it scans
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * QB;
  const int c2p = round_up(c2, CK);
  const float* qa_b = qa + (size_t)b * nq * c2;
  const float* ka_b = ka + (size_t)b * nk * c2;

  // the query block's augmented rows, channel-major, zero past the edges
  float* qs = dyn;  // [c2p][QB + 1]
  for (int e = tid; e < c2p * QB; e += NT) {
    const int r = e / c2p;
    const int c = e % c2p;
    const int q = q0 + r;
    qs[c * (QB + 1) + r] = (q < nq && c < c2) ? qa_b[(size_t)q * c2 + c] : 0.f;
  }

  // this thread's sorted list: slot s at topv[s * NT], topi[s * NT]
  float* topv = qs + c2p * (QB + 1) + tid;
  int* topi = reinterpret_cast<int*>(qs + c2p * (QB + 1) + NT * k) + tid;
  for (int s = 0; s < k; ++s) {
    topv[s * NT] = -FLT_MAX;
    topi[s * NT] = 0;
  }
  float kth = -FLT_MAX;
  __syncthreads();

  for (int t0 = 0; t0 < nk; t0 += TB) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < c2; c0 += CK) {
      // stage key channels [c0, c0 + CK) of the tile; rows or channels past
      // the edge are zeros, which add exact zeros
      for (int e = tid; e < CK * TB; e += NT) {
        const int r = e / CK;
        const int cc = e % CK;
        const int c = c0 + cc;
        const int t = t0 + r;
        sm.ks[cc][r] = (t < nk && c < c2) ? ka_b[(size_t)t * c2 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int cc = 0; cc < CK; ++cc) {
        const float* qrow = qs + (c0 + cc) * (QB + 1);
        float a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qrow[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = sm.ks[cc][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bk[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sm.st[ty + 16 * i][tx + 16 * j] = acc[i][j];
    __syncthreads();

    // this thread's quarter of the tile, keys ascending, into its list
    const int lo = part * COLS;
    const int hi = min(lo + COLS, nk - t0);
    for (int j = lo; j < hi; ++j) {
      const float s = sm.st[ql][j];
      if (s > kth) {
        int pos = k - 1;
        while (pos > 0 && topv[(pos - 1) * NT] < s) {
          topv[pos * NT] = topv[(pos - 1) * NT];
          topi[pos * NT] = topi[(pos - 1) * NT];
          --pos;
        }
        topv[pos * NT] = s;
        topi[pos * NT] = t0 + j;
        kth = topv[(k - 1) * NT];
      }
    }
    __syncthreads();
  }

  // merge the SPLIT lists of each query: thread p * QB + ql holds list p
  const float* lv = qs + c2p * (QB + 1);
  const int* li = reinterpret_cast<const int*>(lv + NT * k);

  const int q = q0 + ql;
  if (part == 0 && q < nq) {
    int head[SPLIT];
#pragma unroll
    for (int p = 0; p < SPLIT; ++p) head[p] = 0;
    const int self = min(q, nk - 1);
    const size_t o = ((size_t)b * nq + q) * k;
    for (int s = 0; s < k; ++s) {
      int best = -1;
      float bv = 0.f;
      int bi = 0;
#pragma unroll
      for (int p = 0; p < SPLIT; ++p) {
        if (head[p] < k) {
          const int at = head[p] * NT + p * QB + ql;
          const float v = lv[at];
          const int i = li[at];
          if (best < 0 || v > bv || (v == bv && i < bi)) {
            best = p;
            bv = v;
            bi = i;
          }
        }
      }
      ++head[best];
      const bool v = bv > INVALID_BELOW;
      idx_out[o + s] = v ? bi : self;
      valid_out[o + s] = v ? 1 : 0;
      score_out[o + s] = bv;
    }
  }
}

}  // namespace

extern "C" {

int dgcnn_knn_kmax() { return KMAX; }

// Launch on `stream`; returns a CUDA error code, 0 when the launch was
// accepted. All pointers are device pointers to contiguous arrays.
int dgcnn_knn_topk_f32(const float* qa, const float* ka, int32_t* idx,
                       uint8_t* valid, float* scores, int batch, int nq,
                       int nk, int c2, int k, cudaStream_t stream) {
  if (batch < 1 || nq < 1 || nk < 1 || c2 < 1 || k < 1 || k > KMAX ||
      k > nk || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t dyn = dynamic_smem_bytes(c2, k);
  const size_t most = SMEM_LIMIT - sizeof(StaticSmem);
  if (dyn > most) return (int)cudaErrorInvalidValue;  // C too wide
  // per device, so set on every launch (a cheap host call)
  const cudaError_t err = cudaFuncSetAttribute(
      knn_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + QB - 1) / QB, batch);
  knn_topk_kernel<<<grid, NT, dyn, stream>>>(qa, ka, idx, valid, scores, nq,
                                             nk, c2, k);
  return (int)cudaGetLastError();
}

// The widest C + 2 the kernel takes for a given k (shared memory bound).
int dgcnn_knn_max_c2(int k) {
  const size_t most = SMEM_LIMIT - sizeof(StaticSmem);
  int c2 = CK;
  while (dynamic_smem_bytes(c2 + CK, k) <= most) c2 += CK;
  return c2;
}

}  // extern "C"
