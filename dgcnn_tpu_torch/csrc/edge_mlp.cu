// The EdgeConv block of MLP depth 2 in training, fused over the edges, CUDA
// C++ for sm_90a. Plain C interface, loaded with ctypes by
// kernels/edge_mlp_cuda.py; the autograd around it is ops/edge.py's
// EdgeStats and EdgeMLP.
//
// Replaces no TPU kernel: the JAX package writes this block as jnp code on
// the materialised (B, N, k, C) edge tensor (dgcnn_tpu/models/dgcnn.py, the
// stacked per-edge convs), and so did the port's edge form. This file
// computes the same fp32 mathematics and never writes an E x C tensor (E =
// B N k edges) to device memory, forward or backward.
//
// What it computes. For each edge e = (i, s) of a valid query row i with
// neighbour j = idx[i, s] (rows of one event), with the block's first conv
// factorised outside as P = x (Wa - Wb), Q = x Wb:
//     y1_e = P_i + Q_j
//     h1_e = relu((y1_e - mean1) rsqrt(var1 + eps) gamma1 + beta1)   (BN1)
//     y2_e = h1_e W2                                                 (the stacked conv)
// and the block's output relu(BN2(max_s y2)) (the max where gamma2 >= 0,
// the min elsewhere: the BN + relu chain is monotone per channel), BN2's
// statistics over the same edges. Four kernels:
//   stats_kernel          sum_e w_i y1_e and sum_e w_i y1_e^2 a channel (BN1's batch sums)
//   mlp_forward_kernel    y2 on the fly: sum_e w_i y2_e, sum_e w_i y2_e^2, and a
//                         row's max (or min) of y2 with its first winning slot
//   mlp_backward_kernel   y1, h1, y2 recomputed in registers; dy2 = w_i (ds1 +
//                         2 ds2 y2) + [s = winner] dm; dW2 += h1^T dy2;
//                         dh1 = dy2 W2^T; dt = dh1 [t > 0]; BN1's sums
//                         sum dt and sum dt (y1 - mean1); dy1 = dt gamma1 r1
//                         summed into dP_i and scattered into dQ_j
//   stats_backward_kernel BN1's statistics backward: v = w_i (ds1 + 2 ds2 y1)
//                         summed into dP_i and scattered into dQ_j
// BN's finalisation (mean, variance, the running update, sync BN's merge)
// stays outside in ops.norm.finalize_batch_stats.
//
// What bounds it on an H100. The stacked conv is 2 E C^2 operations a
// product; forward and a recomputing backward are four products, 86 GFLOP a
// block at E = 32 x 4096 x 20 = 2,621,440 and C = 64: 1.28 ms at the fp32
// FMA peak (67 TFLOP/s). Its bytes: the neighbour rows Q (B N C fp32, 33.5
// MB at that shape) fit in the 50 MB L2 and are gathered k times from there;
// P, the indices and the outputs are read or written once (tens of MB,
// about 0.02 ms at 3.35 TB/s). So it is bound by the FMA pipe, with the
// gathers and the backward's scatter through L2 beside it. No tensor cores:
// the configuration is fp32 with TF32 off.
//
// What this design does about it.
// - A lane owns CH = 8 channels of one query row; C / 8 lanes hold a row and
//   a warp holds 32 / (C / 8) rows (4 at C = 64), each row's k edges taken
//   in chunks of KC = 10 (two at k = 20). A lane gathers its channels of the
//   chunk's neighbour rows with 128-bit loads (all in flight at once), forms
//   h1 in BN's op order (so the relu masks are the edge form's) and stages
//   the chunk's h1 rows, edge by edge, in its warp's shared memory.
// - The product is register-tiled: each lane computes KC edges x 8 channels
//   (80 accumulators) from one 128-bit broadcast load of an edge's 4 input
//   channels per 32 FMAs and two loads of W2's row segment per 4 input
//   channels, W2 staged once a block (W2^T too, for the backward). Every
//   output is one fp32 FMA chain from 0 in ascending input channel, the same
//   function in both passes, so the backward's recompute is bitwise the
//   forward.
// - The max over a row's edges, its winning slot and BN2's sums stay in the
//   lane's registers: the row's edges never leave the warp.
// - The backward's dW2 is a block-wide product over every warp's staged
//   h1 and dy2 rows a chunk, a 4 x 4 tile a thread, added into the block's
//   own slice of a (blocks, C, C) partial; dQ takes 128-bit float4
//   atomicAdd reductions (sm_90) into the L2-resident gradient of Q.
// - Sums are hierarchical: fp32 in a lane over a few hundred edges, then a
//   block's partial in fp64, then one sum over the blocks in the wrapper.
// - Persistent grids: as many blocks as the card holds at once, each walking
//   the rows.
// The Q gathers are not double-buffered: the two warps an SMSP overlap one
// warp's gathers with the other's product (PERF.md keeps the measured
// times against the bound).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CH = 8;          // channels a lane owns
constexpr int KC = 10;         // edges of a row a chunk
constexpr int CMAX = 128;      // the widest C
constexpr int KMAX = 64;       // the most neighbour slots (winners are uint8)
constexpr int MAX_WARPS = 8;   // warps a block
constexpr int NT = MAX_WARPS * 32;

enum Kind { STATS = 0, FORWARD = 1, BACKWARD = 2, STATS_BACKWARD = 3 };

struct Lanes {
  int lr;           // lanes a row: C / CH
  int rw;           // rows a warp: 32 / lr
  int stride;       // floats between two rows' stages: KC C + 4 (4 banks apart)
  int warp_floats;  // floats of one warp's stage: rw * stride
};

__host__ __device__ inline Lanes lanes_of(int c) {
  Lanes l;
  l.lr = c / CH;
  l.rw = 32 / l.lr;
  l.stride = KC * c + 4;
  l.warp_floats = l.rw * l.stride;
  return l;
}

__device__ __forceinline__ void load8(const float* src, float (&v)[CH]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void ldg8(const float* src, float (&v)[CH]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[CH]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// dst[0 .. 8) += v, as two 128-bit reductions (no return value: RED)
__device__ __forceinline__ void red8(float* dst, const float (&v)[CH]) {
  atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
  atomicAdd(reinterpret_cast<float4*>(dst + 4), make_float4(v[4], v[5], v[6], v[7]));
}

// BN1 and relu in ops.norm.batch_norm_apply's op order,
// (y - mean) * rsqrt(var + eps) * gamma + beta, with no contraction into FMA,
// so h1 and its relu mask are the edge form's for the same statistics
__device__ __forceinline__ float bn_relu(float y, float mean, float r, float g, float b) {
  const float t = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(y, mean), r), g), b);
  return t > 0.f ? t : 0.f;
}

// The lane's CH channels of h1 for the chunk's edges [0, ne) of its row into
// st[e * c + c0 ..] (edge-major rows of the chunk), zeros past ne or for an
// inactive row. ir: the row's indices at the chunk's first slot; qb: the
// row's event in Q; cst: mean1, r1, gamma1, beta1 (c each).
__device__ __forceinline__ void stage_h1(float* st, const float* __restrict__ qb,
                                         const int32_t* __restrict__ ir, int ne,
                                         const float (&pv)[CH], const float* cst, int c, int c0,
                                         bool active, bool lane_on) {
  float qv[KC][CH];
#pragma unroll
  for (int e = 0; e < KC; ++e) {
    if (active && e < ne) {
      ldg8(qb + (size_t)__ldg(ir + e) * c + c0, qv[e]);
    } else {
#pragma unroll
      for (int t = 0; t < CH; ++t) qv[e][t] = 0.f;
    }
  }
  if (!lane_on) return;
  float mean[CH], r[CH], g[CH], b[CH];
  load8(cst + c0, mean);
  load8(cst + c + c0, r);
  load8(cst + 2 * c + c0, g);
  load8(cst + 3 * c + c0, b);
#pragma unroll
  for (int e = 0; e < KC; ++e) {
    float h[CH];
#pragma unroll
    for (int t = 0; t < CH; ++t)
      h[t] = (active && e < ne) ? bn_relu(__fadd_rn(pv[t], qv[e][t]), mean[t], r[t], g[t], b[t])
                                : 0.f;
    store8(st + e * c + c0, h);
  }
}

// acc[e][t] = sum over c' of a[e * c + c'] * w[c' * c + c0 + t] for the
// chunk's KC staged rows: one fp32 FMA chain an output from 0 in ascending
// c', the same code in the forward and in the backward's recompute.
__device__ __forceinline__ void product(const float* a, const float* w, int c, int c0,
                                        float (&acc)[KC][CH]) {
#pragma unroll
  for (int e = 0; e < KC; ++e)
#pragma unroll
    for (int t = 0; t < CH; ++t) acc[e][t] = 0.f;
  for (int k = 0; k < c; k += 4) {
    float wv[4][CH];
#pragma unroll
    for (int u = 0; u < 4; ++u) load8(w + (k + u) * c + c0, wv[u]);
#pragma unroll
    for (int e = 0; e < KC; ++e) {
      const float4 h = *reinterpret_cast<const float4*>(a + e * c + k);
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        acc[e][t] = fmaf(h.x, wv[0][t], acc[e][t]);
        acc[e][t] = fmaf(h.y, wv[1][t], acc[e][t]);
        acc[e][t] = fmaf(h.z, wv[2][t], acc[e][t]);
        acc[e][t] = fmaf(h.w, wv[3][t], acc[e][t]);
      }
    }
  }
}

// The block's per-channel sums of the lanes' (a, b) into partial[block][0 ..
// 2c): a over the channels first, then b; each lane's fp32 sums added in
// fp64. scratch: blockDim.x * 2 * CH floats of shared memory, free.
__device__ __forceinline__ void block_partials(float* scratch, const float (&a)[CH], const float (&b)[CH],
                               double* __restrict__ partial, int c, Lanes L) {
  __syncthreads();
  float* const mine = scratch + threadIdx.x * 2 * CH;
#pragma unroll
  for (int t = 0; t < CH; ++t) {
    mine[t] = a[t];
    mine[CH + t] = b[t];
  }
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  for (int x = threadIdx.x; x < 2 * c; x += blockDim.x) {
    const int which = x / c, ch = x - which * c, lane = ch / CH, t = ch % CH;
    double sum = 0.0;
    for (int wp = 0; wp < nwarps; ++wp)
      for (int gg = 0; gg < L.rw; ++gg)
        sum += (double)scratch[(wp * 32 + gg * L.lr + lane) * 2 * CH + which * CH + t];
    partial[(size_t)blockIdx.x * 2 * c + x] = sum;
  }
}

// ---- the kernels ----------------------------------------------------------
// Shapes: p (rows, c) with rows = B n; q (B, nq, c) (nq > n for an extended
// neighbour operand); idx (rows, k) int32 into q's rows of the row's event;
// w (rows) the query weights, or null for all ones; c a multiple of CH up to
// CMAX, k <= KMAX.

__global__ void __launch_bounds__(NT)
stats_kernel(const float* __restrict__ p, const float* __restrict__ q,
             const int32_t* __restrict__ idx, const float* __restrict__ w,
             double* __restrict__ partial, int rows, int n, int nq, int c, int k) {
  extern __shared__ float4 smem4[];
  const Lanes L = lanes_of(c);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / L.lr, c0 = (lane % L.lr) * CH;
  const bool lane_on = g < L.rw;
  const int nwarps = blockDim.x >> 5;
  float s1[CH] = {}, s2[CH] = {};
  for (int rg = blockIdx.x * nwarps + warp; rg * L.rw < rows; rg += gridDim.x * nwarps) {
    const int row = rg * L.rw + g;
    if (!lane_on || row >= rows) continue;
    const float wi = w != nullptr ? __ldg(w + row) : 1.f;
    float pv[CH];
    ldg8(p + (size_t)row * c + c0, pv);
    const int32_t* const ir = idx + (size_t)row * k;
    const float* const qb = q + (size_t)(row / n) * nq * c;
    float a1[CH] = {}, a2[CH] = {};
    for (int s0 = 0; s0 < k; s0 += KC) {
      const int ne = min(KC, k - s0);
      float qv[KC][CH];
#pragma unroll
      for (int e = 0; e < KC; ++e)
        if (e < ne) ldg8(qb + (size_t)__ldg(ir + s0 + e) * c + c0, qv[e]);
#pragma unroll
      for (int e = 0; e < KC; ++e) {
        if (e < ne) {
#pragma unroll
          for (int t = 0; t < CH; ++t) {
            const float y = __fadd_rn(pv[t], qv[e][t]);
            a1[t] += y;
            a2[t] += y * y;
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < CH; ++t) {
      s1[t] += wi * a1[t];
      s2[t] += wi * a2[t];
    }
  }
  block_partials(reinterpret_cast<float*>(smem4), s1, s2, partial, c, L);
}

__global__ void __launch_bounds__(NT, 1)
mlp_forward_kernel(const float* __restrict__ p, const float* __restrict__ q,
                   const int32_t* __restrict__ idx, const float* __restrict__ w,
                   const float* __restrict__ consts,  // mean1, r1, gamma1, beta1 (c each)
                   const float* __restrict__ w2,      // (c, c)
                   const uint8_t* __restrict__ gsign,  // (c) gamma2 >= 0
                   float* __restrict__ m_out,         // (rows, c)
                   uint8_t* __restrict__ win_out,     // (rows, c)
                   double* __restrict__ partial,      // (blocks, 2c)
                   int rows, int n, int nq, int c, int k) {
  extern __shared__ float4 smem4[];
  float* const ws = reinterpret_cast<float*>(smem4);
  float* const cst = ws + c * c;
  float* const stages = cst + 4 * c;
  const Lanes L = lanes_of(c);
  const int nwarps = blockDim.x >> 5;
  for (int x = threadIdx.x; x < c * c / 4; x += blockDim.x)
    reinterpret_cast<float4*>(ws)[x] = __ldg(reinterpret_cast<const float4*>(w2) + x);
  for (int x = threadIdx.x; x < 4 * c; x += blockDim.x) cst[x] = __ldg(consts + x);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / L.lr, c0 = (lane % L.lr) * CH;
  const bool lane_on = g < L.rw;
  float* const st = stages + warp * L.warp_floats + (lane_on ? g : 0) * L.stride;
  bool gs[CH];
#pragma unroll
  for (int t = 0; t < CH; ++t) gs[t] = __ldg(gsign + c0 + t) != 0;
  float s1[CH] = {}, s2[CH] = {};
  const int per_iter = nwarps * L.rw;
  for (int r0 = blockIdx.x * per_iter; r0 < rows; r0 += gridDim.x * per_iter) {
    const int row = r0 + warp * L.rw + g;
    const bool active = lane_on && row < rows;
    float pv[CH] = {};
    if (active) ldg8(p + (size_t)row * c + c0, pv);
    const float wi = active ? (w != nullptr ? __ldg(w + row) : 1.f) : 0.f;
    const int32_t* const ir = idx + (size_t)(active ? row : 0) * k;
    const float* const qb = q + (size_t)(active ? row / n : 0) * nq * c;
    float best[CH];
    int win[CH];
#pragma unroll
    for (int t = 0; t < CH; ++t) {
      best[t] = -INFINITY;
      win[t] = 0;
    }
    for (int s0 = 0; s0 < k; s0 += KC) {
      const int ne = min(KC, k - s0);
      stage_h1(st, qb, ir + s0, ne, pv, cst, c, c0, active, lane_on);
      __syncwarp();
      float acc[KC][CH];
      product(st, ws, c, c0, acc);
      if (active) {
#pragma unroll
        for (int e = 0; e < KC; ++e) {
          if (e < ne) {
#pragma unroll
            for (int t = 0; t < CH; ++t) {
              const float y = acc[e][t];
              s1[t] += wi * y;
              s2[t] += wi * (y * y);
              // the max where gamma2 >= 0, else the min; strict compares
              // keep the first winning slot
              const float v = gs[t] ? y : -y;
              if (v > best[t]) {
                best[t] = v;
                win[t] = s0 + e;
              }
            }
          }
        }
      }
      __syncwarp();
    }
    if (active) {
      float mv[CH];
#pragma unroll
      for (int t = 0; t < CH; ++t) mv[t] = gs[t] ? best[t] : -best[t];
      store8(m_out + (size_t)row * c + c0, mv);
      uint2 packed;
      packed.x = win[0] | (win[1] << 8) | (win[2] << 16) | (win[3] << 24);
      packed.y = win[4] | (win[5] << 8) | (win[6] << 16) | (win[7] << 24);
      *reinterpret_cast<uint2*>(win_out + (size_t)row * c + c0) = packed;
    }
  }
  block_partials(stages, s1, s2, partial, c, L);
}

__global__ void __launch_bounds__(NT, 1)
mlp_backward_kernel(const float* __restrict__ p, const float* __restrict__ q,
                    const int32_t* __restrict__ idx, const float* __restrict__ w,
                    const float* __restrict__ consts,  // mean1, r1, gamma1, beta1, ds1, ds2
                    const float* __restrict__ w2,
                    const uint8_t* __restrict__ win_in,  // (rows, c), the forward's winners
                    const float* __restrict__ dm,        // (rows, c)
                    float* __restrict__ dp,              // (rows, c), written
                    float* __restrict__ dq,              // (B, nq, c), added into
                    double* __restrict__ partial,        // (blocks, 2c): sum dt, sum dt (y1 - mean1)
                    float* __restrict__ dw2,             // (blocks, c, c), added into
                    int rows, int n, int nq, int c, int k) {
  extern __shared__ float4 smem4[];
  float* const ws = reinterpret_cast<float*>(smem4);
  float* const wt = ws + c * c;
  float* const cst = wt + c * c;
  const Lanes L = lanes_of(c);
  const int nwarps = blockDim.x >> 5;
  float* const hs = cst + 6 * c;
  float* const ds = hs + nwarps * L.warp_floats;
  for (int x = threadIdx.x; x < c * c; x += blockDim.x) {
    const float v = __ldg(w2 + x);
    ws[x] = v;
    wt[(x % c) * c + x / c] = v;
  }
  for (int x = threadIdx.x; x < 6 * c; x += blockDim.x) cst[x] = __ldg(consts + x);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / L.lr, c0 = (lane % L.lr) * CH;
  const bool lane_on = g < L.rw;
  float* const sh = hs + warp * L.warp_floats + (lane_on ? g : 0) * L.stride;
  float* const sd = ds + warp * L.warp_floats + (lane_on ? g : 0) * L.stride;
  const int quads = c / 4;
  float sdt[CH] = {}, sdta[CH] = {};
  const int per_iter = nwarps * L.rw;
  for (int r0 = blockIdx.x * per_iter; r0 < rows; r0 += gridDim.x * per_iter) {
    const int row = r0 + warp * L.rw + g;
    const bool active = lane_on && row < rows;
    float pv[CH] = {}, dmv[CH] = {}, dpr[CH] = {};
    uint2 wpk = make_uint2(0u, 0u);
    if (active) {
      ldg8(p + (size_t)row * c + c0, pv);
      ldg8(dm + (size_t)row * c + c0, dmv);
      wpk = __ldg(reinterpret_cast<const uint2*>(win_in + (size_t)row * c + c0));
    }
    const float wi = active ? (w != nullptr ? __ldg(w + row) : 1.f) : 0.f;
    const int32_t* const ir = idx + (size_t)(active ? row : 0) * k;
    const size_t qrow0 = (size_t)(active ? row / n : 0) * nq;
    const float* const qb = q + qrow0 * c;
    for (int s0 = 0; s0 < k; s0 += KC) {
      const int ne = min(KC, k - s0);
      stage_h1(sh, qb, ir + s0, ne, pv, cst, c, c0, active, lane_on);
      __syncwarp();
      float acc[KC][CH];
      product(sh, ws, c, c0, acc);  // y2, bitwise the forward's
      if (lane_on) {
        float ds1[CH], ds2[CH];
        load8(cst + 4 * c + c0, ds1);
        load8(cst + 5 * c + c0, ds2);
#pragma unroll
        for (int e = 0; e < KC; ++e) {
          float d[CH];
#pragma unroll
          for (int t = 0; t < CH; ++t) {
            d[t] = 0.f;
            if (active && e < ne) {
              d[t] = wi * (ds1[t] + 2.f * ds2[t] * acc[e][t]);
              const unsigned wb = ((t < 4 ? wpk.x : wpk.y) >> (8 * (t & 3))) & 0xffu;
              if ((int)wb == s0 + e) d[t] += dmv[t];
            }
          }
          store8(sd + e * c + c0, d);
        }
      }
      __syncwarp();
      product(sd, wt, c, c0, acc);  // dh1 = dy2 W2^T, this lane's channels
      if (active) {
        float mean[CH], r[CH], gm[CH];
        load8(cst + c0, mean);
        load8(cst + c + c0, r);
        load8(cst + 2 * c + c0, gm);
#pragma unroll
        for (int e = 0; e < KC; ++e) {
          if (e < ne) {
            const int j = __ldg(ir + s0 + e);
            float qv[CH], h[CH], dy[CH];
            ldg8(qb + (size_t)j * c + c0, qv);
            load8(sh + e * c + c0, h);
#pragma unroll
            for (int t = 0; t < CH; ++t) {
              const float a = __fsub_rn(__fadd_rn(pv[t], qv[t]), mean[t]);
              const float dt = h[t] > 0.f ? acc[e][t] : 0.f;
              sdt[t] += dt;
              sdta[t] += dt * a;
              dy[t] = (dt * gm[t]) * r[t];
              dpr[t] += dy[t];
            }
            red8(dq + (qrow0 + j) * c + c0, dy);
          }
        }
      }
      __syncthreads();
      // dW2 += h1^T dy2 over every warp's staged chunk (zeros past a row's
      // edges and for inactive rows), a 4 x 4 tile a thread
      for (int tau = threadIdx.x; tau < quads * quads; tau += blockDim.x) {
        const int rq = (tau / quads) * 4, cq = (tau % quads) * 4;
        float a4[4][4] = {};
        for (int wp = 0; wp < nwarps; ++wp) {
          for (int gg = 0; gg < L.rw; ++gg) {
            const float* const hb = hs + wp * L.warp_floats + gg * L.stride;
            const float* const db = ds + wp * L.warp_floats + gg * L.stride;
#pragma unroll
            for (int e = 0; e < KC; ++e) {
              const float4 hv = *reinterpret_cast<const float4*>(hb + e * c + rq);
              const float4 dv = *reinterpret_cast<const float4*>(db + e * c + cq);
              const float hh[4] = {hv.x, hv.y, hv.z, hv.w};
              const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
              for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int v = 0; v < 4; ++v) a4[u][v] = fmaf(hh[u], dd[v], a4[u][v]);
            }
          }
        }
        float* const o = dw2 + (size_t)blockIdx.x * c * c + (size_t)rq * c + cq;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float4 v = *reinterpret_cast<float4*>(o + u * c);
          v.x += a4[u][0];
          v.y += a4[u][1];
          v.z += a4[u][2];
          v.w += a4[u][3];
          *reinterpret_cast<float4*>(o + u * c) = v;
        }
      }
      __syncthreads();
    }
    if (active) store8(dp + (size_t)row * c + c0, dpr);
  }
  block_partials(hs, sdt, sdta, partial, c, L);
}

__global__ void __launch_bounds__(NT)
stats_backward_kernel(const float* __restrict__ p, const float* __restrict__ q,
                      const int32_t* __restrict__ idx, const float* __restrict__ w,
                      const float* __restrict__ dsum,  // ds1, ds2 (c each)
                      float* __restrict__ dp, float* __restrict__ dq,
                      int rows, int n, int nq, int c, int k) {
  const Lanes L = lanes_of(c);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / L.lr, c0 = (lane % L.lr) * CH;
  const bool lane_on = g < L.rw;
  const int nwarps = blockDim.x >> 5;
  float ds1[CH], ds2[CH];
  ldg8(dsum + c0, ds1);
  ldg8(dsum + c + c0, ds2);
  for (int rg = blockIdx.x * nwarps + warp; rg * L.rw < rows; rg += gridDim.x * nwarps) {
    const int row = rg * L.rw + g;
    if (!lane_on || row >= rows) continue;
    const float wi = w != nullptr ? __ldg(w + row) : 1.f;
    float dpr[CH] = {};
    if (wi != 0.f) {
      float pv[CH];
      ldg8(p + (size_t)row * c + c0, pv);
      const int32_t* const ir = idx + (size_t)row * k;
      const size_t qrow0 = (size_t)(row / n) * nq;
      for (int s0 = 0; s0 < k; s0 += KC) {
        const int ne = min(KC, k - s0);
        int j[KC];
        float qv[KC][CH];
#pragma unroll
        for (int e = 0; e < KC; ++e) {
          if (e < ne) {
            j[e] = __ldg(ir + s0 + e);
            ldg8(q + (qrow0 + j[e]) * c + c0, qv[e]);
          }
        }
#pragma unroll
        for (int e = 0; e < KC; ++e) {
          if (e < ne) {
            float v[CH];
#pragma unroll
            for (int t = 0; t < CH; ++t) {
              v[t] = wi * (ds1[t] + 2.f * ds2[t] * __fadd_rn(pv[t], qv[e][t]));
              dpr[t] += v[t];
            }
            red8(dq + (qrow0 + j[e]) * c + c0, v);
          }
        }
      }
    }
    store8(dp + (size_t)row * c + c0, dpr);
  }
}

// ---- launching ------------------------------------------------------------

bool shape_ok(int rows, int n, int nq, int c, int k) {
  return rows >= 1 && n >= 1 && nq >= 1 && rows % n == 0 && c >= CH && c <= CMAX &&
         c % CH == 0 && k >= 1 && k <= KMAX;
}

// warps a block and dynamic shared memory of each kernel at width c
cudaError_t plan(int kind, int c, int* warps, size_t* smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const Lanes L = lanes_of(c);
  const size_t fl = sizeof(float);
  size_t fixed = 0, per_warp = 0;
  switch (kind) {
    case STATS:
      *warps = MAX_WARPS;
      *smem = (size_t)NT * 2 * CH * fl;
      return cudaSuccess;
    case STATS_BACKWARD:
      *warps = MAX_WARPS;
      *smem = 0;
      return cudaSuccess;
    case FORWARD:
      fixed = ((size_t)c * c + 4 * c) * fl;
      per_warp = (size_t)L.warp_floats * fl;
      break;
    case BACKWARD:
      fixed = (2 * (size_t)c * c + 6 * c) * fl;
      per_warp = 2 * (size_t)L.warp_floats * fl;
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if ((size_t)optin < fixed + per_warp) return cudaErrorInvalidValue;
  *warps = (int)((optin - fixed) / per_warp);
  if (*warps > MAX_WARPS) *warps = MAX_WARPS;
  *smem = fixed + *warps * per_warp;
  return cudaSuccess;
}

const void* kernel_of(int kind) {
  switch (kind) {
    case STATS: return (const void*)stats_kernel;
    case FORWARD: return (const void*)mlp_forward_kernel;
    case BACKWARD: return (const void*)mlp_backward_kernel;
    case STATS_BACKWARD: return (const void*)stats_backward_kernel;
    default: return nullptr;
  }
}

// plan, and lets kind's kernel take all the shared memory the current
// device offers a block, so that a plan at any width is valid after any
// other.
cudaError_t prepare(int kind, int c, int* warps, size_t* smem) {
  cudaError_t err = plan(kind, c, warps, smem);
  int dev = 0, optin = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const void* fn = kernel_of(kind);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" {

int dgcnn_emlp_ch() { return CH; }
int dgcnn_emlp_kc() { return KC; }
int dgcnn_emlp_cmax() { return CMAX; }
int dgcnn_emlp_kmax() { return KMAX; }

// Readies a launch of `kind` (0 stats, 1 forward, 2 backward, 3 stats
// backward) at width c on the current device, once before its first
// launch there: sets the kernel's attributes, and gives the blocks the card
// holds at once (`slots`) and the query rows a block takes (`rows`). The
// wrapper's grid is the lesser of slots and the blocks its rows need, and
// it sizes the (grid, ...) partials by it. Returns a CUDA error code.
int dgcnn_emlp_plan(int kind, int c, int* slots, int* rows) {
  if (kernel_of(kind) == nullptr || c < CH || c > CMAX || c % CH != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0, warps = 0;
  size_t smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = prepare(kind, c, &warps, &smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(kind), warps * 32,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *slots = sms * per_sm;
  *rows = warps * lanes_of(c).rw;
  return (int)cudaSuccess;
}

// Each launch runs on `stream` and returns a CUDA error code, 0 when it was
// accepted; every pointer is a device pointer to a contiguous array (w may
// be null: weights of one). dgcnn_emlp_plan has readied it; `grid` is
// the wrapper's.

// partial (grid, 2c) fp64: each block's sum_e w y1 and sum_e w y1^2
int dgcnn_emlp_stats(const float* p, const float* q, const int32_t* idx, const float* w,
                     double* partial, int grid, int rows, int n, int nq, int c, int k,
                     cudaStream_t stream) {
  if (!shape_ok(rows, n, nq, c, k) || grid < 1) return (int)cudaErrorInvalidValue;
  int warps = 0;
  size_t smem = 0;
  cudaError_t err = plan(STATS, c, &warps, &smem);
  if (err != cudaSuccess) return (int)err;
  stats_kernel<<<grid, warps * 32, smem, stream>>>(p, q, idx, w, partial, rows, n, nq, c, k);
  return (int)cudaGetLastError();
}

// consts (4, c): mean1, rsqrt(var1 + eps), gamma1, beta1; w2 (c, c); gsign
// (c) uint8; m and win (rows, c); partial (grid, 2c) fp64: sum_e w y2 and
// sum_e w y2^2
int dgcnn_emlp_forward(const float* p, const float* q, const int32_t* idx, const float* w,
                       const float* consts, const float* w2, const uint8_t* gsign, float* m,
                       uint8_t* win, double* partial, int grid, int rows, int n, int nq, int c,
                       int k, cudaStream_t stream) {
  if (!shape_ok(rows, n, nq, c, k) || grid < 1) return (int)cudaErrorInvalidValue;
  int warps = 0;
  size_t smem = 0;
  cudaError_t err = plan(FORWARD, c, &warps, &smem);
  if (err != cudaSuccess) return (int)err;
  mlp_forward_kernel<<<grid, warps * 32, smem, stream>>>(p, q, idx, w, consts, w2, gsign, m, win,
                                                         partial, rows, n, nq, c, k);
  return (int)cudaGetLastError();
}

// consts (6, c): the forward's four, then ds1 and ds2 (the cotangents of
// BN2's sums); win and dm (rows, c); dp (rows, c) written; dq (B, nq, c)
// and dw2 (grid, c, c) added into (zeros from the wrapper); partial (grid,
// 2c) fp64: sum_e dt and sum_e dt (y1 - mean1)
int dgcnn_emlp_backward(const float* p, const float* q, const int32_t* idx, const float* w,
                        const float* consts, const float* w2, const uint8_t* win,
                        const float* dm, float* dp, float* dq, double* partial, float* dw2,
                        int grid, int rows, int n, int nq, int c, int k, cudaStream_t stream) {
  if (!shape_ok(rows, n, nq, c, k) || grid < 1) return (int)cudaErrorInvalidValue;
  int warps = 0;
  size_t smem = 0;
  cudaError_t err = plan(BACKWARD, c, &warps, &smem);
  if (err != cudaSuccess) return (int)err;
  mlp_backward_kernel<<<grid, warps * 32, smem, stream>>>(p, q, idx, w, consts, w2, win, dm, dp,
                                                          dq, partial, dw2, rows, n, nq, c, k);
  return (int)cudaGetLastError();
}

// dsum (2, c): ds1 and ds2, the cotangents of BN1's sums; dp (rows, c)
// written; dq (B, nq, c) added into
int dgcnn_emlp_stats_backward(const float* p, const float* q, const int32_t* idx,
                              const float* w, const float* dsum, float* dp, float* dq, int grid,
                              int rows, int n, int nq, int c, int k, cudaStream_t stream) {
  if (!shape_ok(rows, n, nq, c, k) || grid < 1) return (int)cudaErrorInvalidValue;
  int warps = 0;
  size_t smem = 0;
  cudaError_t err = plan(STATS_BACKWARD, c, &warps, &smem);
  if (err != cudaSuccess) return (int)err;
  stats_backward_kernel<<<grid, warps * 32, smem, stream>>>(p, q, idx, w, dsum, dp, dq, rows, n,
                                                            nq, c, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
