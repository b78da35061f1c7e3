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
// cores, no TF32: the reference scores at HIGHEST (fp32) precision.
//
// What bounds it on an H100. Per (query, in-band valid key) pair the
// function needs C FMAs, one subtract and one compare, (2C + 2) operations;
// a query has at most `window` candidates, so the work is O(N * window)
// rather than O(N^2). Inputs and outputs move once: x, idx and valid, a few
// hundred MB at a million points. So it is bound by fp32 operations on the
// CUDA cores (67 TFLOP/s on an H100 SXM at 700 W). As in the exact kernel,
// a simple design spends its time on the selection: on sorted points
// nearly every tile of the band holds winners, so the sorted-list walks
// are denser than in the exact kernel.
//
// What this design does about it. It is the exact kernel (csrc/knn.cu)
// with three additions. (1) A block of QB = 64 consecutive queries sweeps
// only the key range [band_lo(first row), band_lo(last row) + window),
// shifted by key_base and clamped to the key array: lo is monotone in
// position, so that range covers every row's window. It is about
// window + QB keys, ~130 tiles of 64 at window = 8192, not N. An empty
// range is allowed. (2) A per-row in-band test on every scored column.
// (3) nvalid per event, read from a (B,) int32 array. Tiles are visited in
// ascending key order, so keys reach each list in ascending index order
// and a strict '>' keeps the lower index ahead of an equal score; the
// merge of the SPLIT lists compares (score, index). Open for later work:
// visiting the diagonal tile first (the Pallas kernel's diag_first order;
// the insert and the entry test would then compare (score, index)),
// warp-cooperative selection and overlapped tile loads.
//
// Every address is computed in size_t: at a million points B * N * (C + 2)
// and N * window exceed 2^31.

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

// The window expression of dgcnn_tpu/ops/knn.py:88 (band_lo), written once
// here: the first candidate position of a query at global sorted position
// `pos`, clip(pos - window / 2, 0, max(nvalid - window, 0)).
__device__ __forceinline__ int band_lo(int pos, int nvalid, int window) {
  const int hi = max(nvalid - window, 0);
  return min(max(pos - window / 2, 0), hi);
}

// dynamic shared memory: the query block's rows [c2p][QB + 1], then every
// thread's sorted list, values and indices [k][NT] each (slot-major)
__host__ __device__ inline size_t dynamic_smem_bytes(int c2, int k) {
  const size_t rows = (size_t)round_up(c2, CK) * (QB + 1) * sizeof(float);
  const size_t lists = (size_t)NT * k * (sizeof(float) + sizeof(int));
  return rows + lists;
}

__global__ void __launch_bounds__(NT)
knn_banded_kernel(const float* __restrict__ qa,       // (B, nq, c2)
                  const float* __restrict__ ka,       // (B, nk, c2)
                  const int32_t* __restrict__ nvalid, // (B,)
                  int32_t* __restrict__ idx_out,      // (B, nq, k)
                  uint8_t* __restrict__ valid_out,
                  float* __restrict__ score_out,
                  int nq, int nk, int c2, int k, int window, int q_base,
                  int key_base) {
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
  const int nv = nvalid[b];
  const float* qa_b = qa + (size_t)b * nq * c2;
  const float* ka_b = ka + (size_t)b * nk * c2;

  // the block's key range, key-local: from the first row's window start to
  // the last row's window end, clamped to the key array (may be empty)
  const int last = min(q0 + QB, nq) - 1;
  const int t_begin = min(max(band_lo(q_base + q0, nv, window) - key_base, 0), nk);
  const int t_end =
      min(max(band_lo(q_base + last, nv, window) + window - key_base, 0), nk);
  // this thread's query's window, key-local
  const int my_lo = band_lo(q_base + q0 + ql, nv, window) - key_base;
  const int my_hi = my_lo + window;

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

  // tiles in ascending key order (the tie rule relies on it)
  for (int t0 = t_begin; t0 < t_end; t0 += TB) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < c2; c0 += CK) {
      // stage key channels [c0, c0 + CK) of the tile; rows past the range
      // or channels past c2 are zeros, which add exact zeros
      for (int e = tid; e < CK * TB; e += NT) {
        const int r = e / CK;
        const int cc = e % CK;
        const int c = c0 + cc;
        const int t = t0 + r;
        sm.ks[cc][r] = (t < t_end && c < c2) ? ka_b[(size_t)t * c2 + c] : 0.f;
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

    // this thread's quarter of the tile, keys ascending, in-band keys only
    const int lo = max(part * COLS, my_lo - t0);
    const int hi = min(min(part * COLS + COLS, t_end - t0), my_hi - t0);
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
      idx_out[o + s] = v ? key_base + bi : q_base + q;
      valid_out[o + s] = v ? 1 : 0;
      score_out[o + s] = bv;
    }
  }
}

}  // namespace

extern "C" {

int dgcnn_knn_banded_kmax() { return KMAX; }

// Launch on `stream`; returns a CUDA error code, 0 when the launch was
// accepted. All pointers are device pointers to contiguous arrays.
int dgcnn_knn_banded_f32(const float* qa, const float* ka, const int32_t* nvalid,
                         int32_t* idx, uint8_t* valid, float* scores, int batch,
                         int nq, int nk, int c2, int k, int window, int q_base,
                         int key_base, cudaStream_t stream) {
  if (batch < 1 || nq < 1 || nk < 1 || c2 < 1 || k < 1 || k > KMAX ||
      k > nk || window < k || batch > 65535 || q_base < 0 || key_base < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t dyn = dynamic_smem_bytes(c2, k);
  const size_t most = SMEM_LIMIT - sizeof(StaticSmem);
  if (dyn > most) return (int)cudaErrorInvalidValue;  // C too wide
  const cudaError_t err = cudaFuncSetAttribute(
      knn_banded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + QB - 1) / QB, batch);
  knn_banded_kernel<<<grid, NT, dyn, stream>>>(qa, ka, nvalid, idx, valid, scores,
                                               nq, nk, c2, k, window, q_base,
                                               key_base);
  return (int)cudaGetLastError();
}

// The widest C + 2 the kernel takes for a given k (shared memory bound).
int dgcnn_knn_banded_max_c2(int k) {
  const size_t most = SMEM_LIMIT - sizeof(StaticSmem);
  int c2 = CK;
  while (dynamic_smem_bytes(c2 + CK, k) <= most) c2 += CK;
  return c2;
}

}  // extern "C"
