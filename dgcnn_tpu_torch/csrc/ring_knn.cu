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
// PLACE at its end. The order is (score descending, global index ascending).
// Blocks arrive in owner order, not global order, so the merge compares
// indices and does not rely on arrival order. The wrapper seeds the lists
// with (-FLT_MAX, 0) before step 0 and, after step P - 1, turns a slot whose
// score is <= -1e29 (fewer than k valid keys in the event) into the global
// self index with valid = 0, as the Pallas kernel's wrapper does.
//
// Scores are bit-identical to csrc/knn.cu's: the same operands, the same
// tile layout and the same fp32 FMA chain in ascending channel order, on the
// CUDA cores (no TF32). So the ring's graph over P shards equals the exact
// kernel's graph over the whole event, index for index.
//
// What bounds it on an H100. Per launch the function needs, for each
// (query, valid key of the block) pair, C fp32 FMAs, one subtract and one
// compare: (2C + 2) * B * nq * nk_valid operations, 2.1 ms at C = 64,
// nq = nk = 32,768 and 67 TFLOP/s (fp32 on the CUDA cores, H100 SXM at
// 700 W). Its bytes are the block, the queries and the running list, about
// 28 MB at that size, 8 us at 3.35 TB/s. So it is bound by operations.
//
// What this design does about it. It keeps csrc/knn.cu's layout: a block
// owns QB = 64 queries of one event, with their augmented rows in shared
// memory; 256 threads compute each 64 x 64 score tile as a register-blocked
// product and write it to shared memory; each query has SPLIT = 4 threads,
// each with its own sorted list of k (score, block index) in shared memory,
// slot-major, scanning its own 16 of each tile's 64 columns. Keys reach each
// list in ascending index order, all with the same owner base, so a strict
// '>' keeps the lower index first within a list. New here:
// - the block's running lists are loaded into shared memory at the start;
//   every list starts with the query's running k-th score as its floor (a
//   key scoring below it cannot enter the result), so on later ring steps
//   only the keys that can still win walk a list;
// - at the end one thread a query merges the running list and its four lists
//   by (score desc, global index asc) and writes the result back in place.
// The running list lives in global memory between launches: B * nq * k * 8
// bytes, 5.2 MB at nq = 32,768 and k = 20.
// Transport runs outside the kernel (kernels/ring_knn_cuda.py): the next
// block's transfer is started before this launch and waited for after it.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
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

static_assert(NT == 256 && QB == 64 && TB == 64, "16 x 16 threads, 4 x 4 scores each");

struct StaticSmem {
  float ks[CK][TB + 1];
  float st[QB][TB + 1];
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// dynamic shared memory: the query block's rows [c2p][QB + 1]; the running
// lists of its queries, values and indices [k][QB] each; then every thread's
// sorted list, values and indices [k][NT] each (slot-major: the lanes of a
// warp hit distinct banks whatever slots they touch)
__host__ __device__ inline size_t dynamic_smem_bytes(int c2, int k) {
  const size_t rows = (size_t)round_up(c2, CK) * (QB + 1) * sizeof(float);
  const size_t running = (size_t)QB * k * (sizeof(float) + sizeof(int));
  const size_t lists = (size_t)NT * k * (sizeof(float) + sizeof(int));
  return rows + running + lists;
}

__global__ void __launch_bounds__(NT)
ring_merge_kernel(const float* __restrict__ qa,   // (B, nq, c2) resident queries
                  const float* __restrict__ ka,   // (B, nk, c2) circulating block
                  float* topv,                    // (B, nq, k) running, in place
                  int32_t* topi,                  // (B, nq, k) running, in place
                  int nq, int nk, int c2, int k, int base) {
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

  // the running lists of the block's queries: slot s of query r at
  // rv[s * QB + r], ri[s * QB + r]
  float* rv = qs + c2p * (QB + 1);
  int* ri = reinterpret_cast<int*>(rv + QB * k);
  for (int e = tid; e < QB * k; e += NT) {
    const int r = e / k;
    const int s = e % k;
    const int q = q0 + r;
    const size_t g = ((size_t)b * nq + q) * k + s;
    rv[s * QB + r] = q < nq ? topv[g] : -FLT_MAX;
    ri[s * QB + r] = q < nq ? topi[g] : 0;
  }

  // this thread's sorted list: slot s at lv[s * NT], li[s * NT]
  float* lists = reinterpret_cast<float*>(ri + QB * k);
  float* lv = lists + tid;
  int* li = reinterpret_cast<int*>(lists + NT * k) + tid;
  for (int s = 0; s < k; ++s) {
    lv[s * NT] = -FLT_MAX;
    li[s * NT] = 0;
  }
  __syncthreads();

  // a key that scores below the running k-th score cannot enter the result;
  // one that ties it may (a lower global index wins), so the floor is the
  // next float down
  const float floor_v = nextafterf(rv[(k - 1) * QB + ql], -INFINITY);
  float kth = floor_v;

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
        while (pos > 0 && lv[(pos - 1) * NT] < s) {
          lv[pos * NT] = lv[(pos - 1) * NT];
          li[pos * NT] = li[(pos - 1) * NT];
          --pos;
        }
        lv[pos * NT] = s;
        li[pos * NT] = t0 + j;
        kth = fmaxf(lv[(k - 1) * NT], floor_v);
      }
    }
    __syncthreads();
  }

  // merge the running list and the SPLIT lists of each query (thread
  // p * QB + ql holds list p) by (score desc, global index asc), in place
  const float* mv = lists;
  const int* mi = reinterpret_cast<const int*>(lists + NT * k);
  const int q = q0 + ql;
  if (part == 0 && q < nq) {
    int head[SPLIT];
#pragma unroll
    for (int p = 0; p < SPLIT; ++p) head[p] = 0;
    int rh = 0;
    const size_t o = ((size_t)b * nq + q) * k;
    for (int s = 0; s < k; ++s) {
      int best = -1;  // SPLIT: the running list
      float bv = 0.f;
      int bi = 0;
      if (rh < k) {
        best = SPLIT;
        bv = rv[rh * QB + ql];
        bi = ri[rh * QB + ql];
      }
#pragma unroll
      for (int p = 0; p < SPLIT; ++p) {
        if (head[p] < k) {
          const int at = head[p] * NT + p * QB + ql;
          const float v = mv[at];
          const int i = base + mi[at];
          if (best < 0 || v > bv || (v == bv && i < bi)) {
            best = p;
            bv = v;
            bi = i;
          }
        }
      }
      if (best == SPLIT) {
        ++rh;
      } else {
        ++head[best];
      }
      topv[o + s] = bv;
      topi[o + s] = bi;
    }
  }
}

}  // namespace

extern "C" {

int dgcnn_ring_knn_kmax() { return KMAX; }

// One ring step on `stream`; returns a CUDA error code, 0 when the launch was
// accepted. All pointers are device pointers to contiguous arrays; topv and
// topi are read and written.
int dgcnn_ring_knn_step_f32(const float* qa, const float* ka, float* topv,
                            int32_t* topi, int batch, int nq, int nk, int c2,
                            int k, int base, cudaStream_t stream) {
  if (batch < 1 || nq < 1 || nk < 1 || c2 < 1 || k < 1 || k > KMAX ||
      k > nk || batch > 65535 || base < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t dyn = dynamic_smem_bytes(c2, k);
  const size_t most = SMEM_LIMIT - sizeof(StaticSmem);
  if (dyn > most) return (int)cudaErrorInvalidValue;  // C too wide
  // per device, so set on every launch (a cheap host call)
  const cudaError_t err = cudaFuncSetAttribute(
      ring_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + QB - 1) / QB, batch);
  ring_merge_kernel<<<grid, NT, dyn, stream>>>(qa, ka, topv, topi, nq, nk, c2,
                                               k, base);
  return (int)cudaGetLastError();
}

// The widest C + 2 the kernel takes for a given k (shared memory bound).
int dgcnn_ring_knn_max_c2(int k) {
  const size_t most = SMEM_LIMIT - sizeof(StaticSmem);
  int c2 = CK;
  while (dynamic_smem_bytes(c2 + CK, k) <= most) c2 += CK;
  return c2;
}

}  // extern "C"
