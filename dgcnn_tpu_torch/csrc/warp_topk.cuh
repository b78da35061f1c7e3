// Warp-cooperative top-k selection, shared by csrc/knn.cu, csrc/ring_knn.cu
// and csrc/knn_banded.cu (CUDA C++ for sm_90a; included, not built on its
// own).
//
// One query row's top-k list lives across the 32 lanes of one warp: slot s
// on lane s % 32, in register s / 32 of that lane. KS = ceil(k / 32) pairs
// of (value, index) registers a lane: one for k <= 32, two for k <= 64.
// The list is sorted by (score descending, index ascending), the order of
// jax.lax.top_k and of the Pallas kernels' insert
// (dgcnn_tpu/kernels/knn_banded.py::_banded_kernel). Every test and every
// insert compares (score, index) pairs, so the final list is the top k of
// all keys offered under that order, whatever order they were offered in:
// a kernel may visit its key tiles in any order.
//
// For one row and 32 candidate columns (one a lane), the caller
//   1. has each lane test its candidate against the warp-uniform k-th
//      entry (kv, ki, from `kth`): it enters if s > kv || (s == kv && j <
//      ki) (`ahead`);
//   2. gathers the winners with __ballot_sync;
//   3. hands them to `take`. Up to BULK = 8 winners go in one at a time,
//      in ascending lane (column) order (`insert`): an insert's position is
//      the popcount of the ballot of slots ahead of it, and the slots at
//      and after it move up one lane by __shfl_up_sync (lane 31 carries
//      into the next register). A winner that the inserts before it have
//      pushed out of the top k gets a position of k or more and changes
//      nothing below slot k, so no winner is tested again. More winners
//      than BULK, as when a list fills from empty, are merged at once
//      (`merge`, k <= 32): a bitonic sort of the 32 candidates and a
//      bitonic merge with the list, 20 shuffle stages instead of up to 32
//      serial inserts.
// A column group that holds no winner costs one compare and one ballot. No
// lane walks a list serially, and no lane waits for another's walk.
//
// Slots at or past k may hold anything: no test or position counts them.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>

namespace dgcnn {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int BULK = 8;  // winners of one ballot above which `take` merges them at once

// (v, i) comes before (s, j): a higher score, or an equal score and a
// lower index
__device__ __forceinline__ bool ahead(float v, int i, float s, int j) {
  return v > s || (v == s && i < j);
}

// one compare-exchange of a bitonic network between this lane and lane ^
// stride: the lower lane of the pair keeps the entry ahead if `desc`, the
// higher lane if not
__device__ __forceinline__ void exchange(float& v, int& i, int lane, int stride, bool desc) {
  const float ov = __shfl_xor_sync(FULL_MASK, v, stride);
  const int oi = __shfl_xor_sync(FULL_MASK, i, stride);
  const bool lower = (lane & stride) == 0;
  if (lower == desc ? ahead(ov, oi, v, i) : ahead(v, i, ov, oi)) {
    v = ov;
    i = oi;
  }
}

template <int KS>
struct WarpTopK {
  float v[KS];
  int i[KS];

  // the warp-uniform k-th entry (slot k - 1)
  __device__ __forceinline__ void kth(int k, float& kv, int& ki) const {
    const int reg = (k - 1) >> 5;
    float sv = v[0];
    int si = i[0];
#pragma unroll
    for (int r = 1; r < KS; ++r) {
      if (reg == r) {
        sv = v[r];
        si = i[r];
      }
    }
    kv = __shfl_sync(FULL_MASK, sv, (k - 1) & 31);
    ki = __shfl_sync(FULL_MASK, si, (k - 1) & 31);
  }

  // insert the warp-uniform candidate (s, j) at its place: after the
  // slots ahead of it (their count is its position), the slots from there
  // on moving up one. Branch-free: a candidate whose position is k or more
  // changes only slots at or past k, which nothing reads, so the caller
  // needs no test against the k-th entry, and the shifted values are
  // fetched while the position is counted.
  __device__ __forceinline__ void insert(int k, int lane, float s, int j) {
    float up_v[KS];
    int up_i[KS];
#pragma unroll
    for (int r = 0; r < KS; ++r) {
      up_v[r] = __shfl_up_sync(FULL_MASK, v[r], 1);
      up_i[r] = __shfl_up_sync(FULL_MASK, i[r], 1);
      if (r > 0) {  // lane 0 takes lane 31 of the register below
        const float last_v = __shfl_sync(FULL_MASK, v[r - 1], 31);
        const int last_i = __shfl_sync(FULL_MASK, i[r - 1], 31);
        if (lane == 0) {
          up_v[r] = last_v;
          up_i[r] = last_i;
        }
      }
    }
    int pos = 0;
#pragma unroll
    for (int r = 0; r < KS; ++r) {
      pos += __popc(__ballot_sync(FULL_MASK, r * 32 + lane < k && ahead(v[r], i[r], s, j)));
    }
#pragma unroll
    for (int r = 0; r < KS; ++r) {
      const int slot = r * 32 + lane;
      if (slot > pos) {
        v[r] = up_v[r];
        i[r] = up_i[r];
      } else if (slot == pos) {
        v[r] = s;
        i[r] = j;
      }
    }
  }

  // merge the candidates (s, j) of the lanes in `bal` all at once (one list
  // register, k <= 32): a bitonic sort of the 32 lanes' candidates (absent
  // ones behind everything), then the top 32 of them and the list, which
  // is the better of list slot l and sorted candidate 31 - l (a bitonic
  // sequence), sorted by a bitonic merge. 20 compare-exchange stages.
  __device__ __forceinline__ void merge(int k, int lane, unsigned bal, float s, int j) {
    const bool in = (bal >> lane) & 1u;
    float cv = in ? s : -FLT_MAX;
    int ci = in ? j : INT_MAX;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1)
        exchange(cv, ci, lane, stride, (lane & size) == 0);
    float lv = lane < k ? v[0] : -FLT_MAX;
    int li = lane < k ? i[0] : INT_MAX;
    const float rv = __shfl_sync(FULL_MASK, cv, 31 - lane);
    const int ri = __shfl_sync(FULL_MASK, ci, 31 - lane);
    if (ahead(rv, ri, lv, li)) {
      lv = rv;
      li = ri;
    }
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) exchange(lv, li, lane, stride, true);
    v[0] = lv;
    i[0] = li;
  }

  // insert the candidates (s, j) of the lanes in `bal` (not empty): more
  // than BULK of them at once by `merge` (k <= 32), else one at a time,
  // lowest lane first. A candidate that no longer comes before the k-th
  // entry (the bar may have risen since the ballot) lands past slot k - 1.
  // The next candidate is fetched while this one is inserted.
  __device__ __forceinline__ void take(int k, int lane, unsigned bal, float s, int j) {
    if (KS == 1 && __popc(bal) > BULK) {
      merge(k, lane, bal, s, j);
      return;
    }
    int src = __ffs(bal) - 1;
    float cs = __shfl_sync(FULL_MASK, s, src);
    int cj = __shfl_sync(FULL_MASK, j, src);
    for (bal &= bal - 1;; bal &= bal - 1) {
      src = bal ? __ffs(bal) - 1 : src;
      const float next_s = __shfl_sync(FULL_MASK, s, src);
      const int next_j = __shfl_sync(FULL_MASK, j, src);
      insert(k, lane, cs, cj);
      if (!bal) break;
      cs = next_s;
      cj = next_j;
    }
  }
};

}  // namespace dgcnn
