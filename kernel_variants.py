#!/usr/bin/env python3
"""Time design variants of the exact, banded and ring kNN kernels on one
NVIDIA GPU.

    python3 kernel_variants.py [--only exact,banded,ring,passes,exact_tc,ring_tc,banded_tc,probe,step,
                                      exact_f32] [VARIANT ...]

Each variant is a copy of ``dgcnn_tpu_torch/csrc`` with a few text
patches (`VARIANTS`), built with the port's nvcc flags into
``build/variants/<name>/``, all builds started together. The script
captures the inputs of the first two graph builds (C=4 and C=64) of one
served forward on each kernel's main path, the way ``chip_smoke.py``
does: a 4 x 4096 batch for the exact kernel (timed at its own choice of
the key split S and at S forced to 1, 2 and 4; ``splits_*`` lines), a
1,048,576-point event with ``knn_window=8192`` for the banded kernel, a
131,072-point event split into 4 virtual owners (rank 0's ring order,
fresh running lists) for the ring kernel. It times every variant's
kernel alone on prebuilt operands with CUDA events and says whether its
graph equals the first variant's. ``chunk1``, ``chunk2`` and ``chunk4``
force the chunked layout of wide C (`csrc/knn_sweep.cuh`) at C = 64 with
its channels in 1, 2 or 4 chunks: the cost of a chunk, on the same graph.
``passes`` (no variant build) times the package's exact kernel on the
4 x 4096 inputs at k = 20, 32, 64, 96, 128 and 192 (one to three passes
of at most 64 entries) and at C = 256 (the C = 64 features repeated four
times: three chunks of channels), k = 20 and 96. ``count`` reports, per query row and
launch, the tiles where the filter flagged the row, the column groups with
a winner, the candidates taken one at a time and those of them that
entered the top k (bulk merges are not counted). Variants that skip work
(``noselect``, ``noselect_nostage``) give wrong graphs: they only split
the time. For ``base`` and ``noselect_nostage`` it also samples the SM
clock and the power draw (nvidia-smi) while the kernel runs for two
seconds.

``exact_tc`` times the exact kernel's two tensor-core forms, the shared
sweep's ``sweep_tc`` instantiation (``dgcnn_knn_topk_bf16``) and the Hopper kernel
(``csrc/knn_tc.cuh``, ``dgcnn_knn_topk_tc``), from each variant's library
in the same call, on the first two graph-build inputs (C=4, C=64) of step
1 of the bf16 + remat train step at 1 x 131,072 (``chip_smoke.py`` phase
17's) and at 1 x 16,384, and of one bf16 served 4 x 4096 forward: each at the card's key
split, the base in turns (sweep, Hopper, Hopper, sweep) and the Hopper
kernel at S forced to 1, 2, 4 and 8, its indices and scores against the
sweep's (``==``). ``noselect``, ``tc_noselect_nostage`` and
``tc_product_bare`` split a ``sweep_tc`` launch into product, staging,
score-tile store and filter, and selection; ``count`` counts both
kernels' selections; the ``hopper_*`` variants do the same for the Hopper
kernel, ``hopper_mma`` takes its product to mma.sync on ldmatrix
fragments and ``hopper_tile128`` its key tiles to 128 (a wgmma of n128);
both patches carry their code (``MMA_SYNC_PRODUCT``, ``WGMMA_N128``).
``ring_tc`` and ``banded_tc`` do the same for the ring step's and the
banded pass's TC forms (``dgcnn_ring_knn_step_tc`` / ``_bf16``,
``dgcnn_knn_banded_tc`` / ``_bf16``): the ring on the first two
graph-build inputs of step 1 of the bf16 + remat train step at 1 x
131,072 split into 4 virtual owners (rank 0's four steps from fresh
lists), the banded pass on the first two of a bf16 1,048,576-point
forward at ``knn_window=8192``; every variant's forms (``hopper_noselect``
and ``hopper_product`` split a Hopper launch into product and pipeline,
filter and ballots, and selection; ``count`` counts the selections), the
base's two forms in turns, their graphs against the base sweep's (``==``),
and in the same call the exact kernel's two TC forms in turns on the 1 x
131,072 inputs (the refactored Hopper kernel's time).
``probe`` (no variant build) scores every (query, key) pair of those two
train inputs with two product chains from the Hopper kernel's shared
layout, its wgmma.m64n64k16 chain and ``MMA_SYNC_PRODUCT``'s
mma.sync.m16n8k16 chain over ascending 16-channel steps, and counts the
scores where they differ (``==``, so +0 equals -0). ``step`` (no variant build) times the bf16 + remat train
step of phase 17 with the graph builds on the Hopper kernel and on
sweep_tc, in turns. ``exact_f32`` times the exact kernel's two fp32 forms,
the sweep (``dgcnn_knn_topk_f32``) and the Hopper fp32 kernel
(``csrc/knn_hopper.cuh``, ``dgcnn_knn_topk_f32h``), from each variant's
library, on the first two graph-build inputs (C=4, C=64) of one f32
forward of a 1 x 131,072 event (the train cell's shape) and of one served
4 x 4096 forward: the base in turns (sweep, Hopper, Hopper, sweep) at
the card's key split, each form's indices, valid flags and scores against
the base sweep's (``==``), the SM clock and power draw while ``base`` and
``f32h_product`` run at 1 x 131,072, and the Hopper kernel at S forced to 1, 2 and
4 on the served batch; ``f32h_noselect`` (no selection: the filter and
its ballots stay) and ``f32h_product`` (the pipeline and the product
alone) split a Hopper launch, and ``f32h_product_noload`` (the FMAs on
operands loaded once a tile) and ``f32h_product_keys1`` (every lane's keys
from one address) split the product. The numbers go to stdout.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
import sys
import threading
import time

import torch

import chip_smoke as cs
from dgcnn_tpu_torch.kernels import _build
from dgcnn_tpu_torch.kernels import knn_cuda as kmod

OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "variants")
PALLAS_ORDER = "(m == 0 ? band.diag : (m <= band.diag ? m - 1 : m))"
# csrc/knn_banded.cu's visit order, for the exact kernel's "outward" variant
OUTWARD = """
__device__ __forceinline__ int outward(int m, int diag, int ntiles) {
  const int below = diag;
  const int above = ntiles - 1 - diag;
  const int both = 2 * min(below, above);
  if (m <= both) return (m & 1) ? diag - (m + 1) / 2 : diag + m / 2;
  const int d = min(below, above) + (m - both);
  return below > above ? diag - d : diag + d;
}
"""
COUNTERS = "constexpr unsigned FULL_MASK = 0xffffffffu;"
COUNT_READ = """
extern "C" int count_read(unsigned long long* out) {
  const cudaError_t e = cudaMemcpyFromSymbol(out, dgcnn::counts, sizeof(dgcnn::counts));
  unsigned long long zero[4] = {0, 0, 0, 0};
  cudaMemcpyToSymbol(dgcnn::counts, zero, sizeof(zero));
  return (int)e;
}
"""
TAKE = "if (bal[g]) cur.take(k, lane, bal[g], s[g], base + t0 + g * 32 + lane);"
ROWS_BALLOT = "unsigned rows = __ballot_sync(FULL_MASK, flagged);"
FLAGGED_ROW = "if (q0 + row >= nq) continue;"
SCORE_SYNC = ("      score_tile(qs, ks + (m & 1) * c2p * LDK, st, bar, flag, c2p, key_end - t0);\n"
              "      __syncthreads();")
CHUNK_RULE = "  if (sweep_smem_bytes(c2) + extra <= (size_t)SMEM_LIMIT) return 0;"
# the TC sweep's one-pass loop: its next tile's staging, and its barrier
# between the score tile and the selection
TC_STAGE = "      if (m < ntiles - 1) {"
TC_SCORE_SYNC = "\n      finish_tile_tc(acc, st, bar, flag, key_end - t0);\n      __syncthreads();"
# the Hopper TC kernel: the point where a warp has released its stage
HOPPER_RELEASED = "    if (lane == 0) sm90::mbar_arrive(empty + 8 * s);  // the stage is free again\n"
HOPPER_ROWS = "    if (!(b0 | b1)) continue;"
HOPPER_TILE = "constexpr int TBK = 64; "
HOPPER_PRODUCT = "    product(acc, q_s, k_s + s * kt, steps, warp);"
HOPPER_KERNEL = "// The sweep of one query block, the producer and consumer loops"
# The Hopper kernel's product as this warp's mma.sync.m16n8k16 chain on
# ldmatrix fragments of the same swizzled shared memory (inside namespace
# dgcnn::tc): the `hopper_mma` variant's product and the probe's twin of
# the wgmma chain.
MMA_SYNC_PRODUCT = r"""
// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 and receives, of each matrix, row l / 4, elements 2 (l % 4)
// and + 1
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void product_mma(float (&acc)[NF][4], uint32_t q_s, uint32_t k_s,
                                            int steps, int warp, int lane) {
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // lane l addresses row l % 8 of matrix l / 8; a row of 16 channels is 32
  // bytes, its second 16-byte half swapped with the first where bit 2 of
  // the row is set (the 32-byte swizzle)
  const int mi = lane >> 3;
  const int qrow = warp * 16 + (mi & 1) * 8 + (lane & 7);
  const uint32_t qoff = qrow * 32 + (((mi >> 1) ^ ((qrow >> 2) & 1)) << 4);
  for (int g = 0; g < steps; ++g) {
    uint32_t a[4];
    ldmatrix_x4(a, q_s + g * QB * 32 + qoff);
#pragma unroll
    for (int np = 0; np < NF / 2; ++np) {
      const int key = (2 * np + (mi >> 1)) * 8 + (lane & 7);
      uint32_t b[4];
      ldmatrix_x4(b, k_s + g * TBK * 32 + key * 32 + (((mi & 1) ^ ((key >> 2) & 1)) << 4));
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

"""
# wgmma of 128 keys (64 accumulators a thread), for the `hopper_tile128`
# variant (sm90.cuh keeps only the n64 form the kernel uses)
WGMMA_N128 = r"""
__device__ __forceinline__ void wgmma_k16(float (&d)[16][4], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : DGCNN_ACC4(0), DGCNN_ACC4(1), DGCNN_ACC4(2), DGCNN_ACC4(3), DGCNN_ACC4(4),
        DGCNN_ACC4(5), DGCNN_ACC4(6), DGCNN_ACC4(7), DGCNN_ACC4(8), DGCNN_ACC4(9),
        DGCNN_ACC4(10), DGCNN_ACC4(11), DGCNN_ACC4(12), DGCNN_ACC4(13), DGCNN_ACC4(14),
        DGCNN_ACC4(15)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

"""
# the Hopper fp32 kernel: the point where a warp has released its stage
# (after which `f32h_product` sums its scores, so that none is dead code,
# and goes on to the next tile), and the rows its filter names
F32H_RELEASED = "      load_tile(m + stages);\n"
F32H_ROWS = "    rows &= live_rows;\n"
F32H_SINK = ("    float sink = 0.f;\n#pragma unroll\n    for (int i = 0; i < RPL; ++i)\n#pragma unroll\n"
             "      for (int j = 0; j < KPL; ++j) sink += acc[i][j];\n"
             "    if (sink == 1234.5f) st[lane] = sink;\n    continue;\n")
# its product's key loop (a key's four channels into each row's chain),
# and the same chains channel by channel over all eight keys at once
FORCE_CHUNKS = "  if (c2 > 8) return round_up((round_up(c2, CPAD) + {n} - 1) / {n}, CPAD);\n  if"
# name -> {file: [(old, new), ...]}
VARIANTS = {
    "base": {},
    # the banded kernel's tiles in the Pallas kernel's order and in
    # ascending order; the exact kernel's outward from the block's own tile
    "pallas_order": {"knn_banded.cu": [("outward(m, band.diag, band.ntiles)", PALLAS_ORDER)]},
    "ascending": {"knn_banded.cu": [("outward(m, band.diag, band.ntiles)", "m")]},
    "outward": {"knn.cu": [
        ("constexpr int MAX_SPLITS = 8;", "constexpr int MAX_SPLITS = 8;\n" + OUTWARD),
        ("[=](int m) { return (t_lo + m) * TB; }",
         "[=](int m) { return (t_lo + outward(m, min(max((q0 + QB / 2) / TB - t_lo, 0), ntiles - 1),"
         " ntiles)) * TB; }")]},
    # the channel loop without the extra unroll
    "unroll1": {"knn_sweep.cuh": [("#pragma unroll 2\n  for (int c0", "  for (int c0")]},
    # every row of every tile takes the warp's exact test
    "nofilter": {"knn_sweep.cuh": [("if (hit) flag[row] = 1;", "flag[row] = 1;")]},
    # winners of a ballot above which they are merged at once (never: 32)
    "bulk4": {"warp_topk.cuh": [("constexpr int BULK = 8;", "constexpr int BULK = 4;")]},
    "bulk16": {"warp_topk.cuh": [("constexpr int BULK = 8;", "constexpr int BULK = 16;")]},
    "nobulk": {"warp_topk.cuh": [("constexpr int BULK = 8;", "constexpr int BULK = 32;")]},
    # no warp selection: staging, product, filter, score tile
    "noselect": {"knn_sweep.cuh": [(ROWS_BALLOT, ROWS_BALLOT.replace("= __", "= 0u & __"))]},
    # and no key staging after the first tile
    "noselect_nostage": {"knn_sweep.cuh": [
        (ROWS_BALLOT, ROWS_BALLOT.replace("= __", "= 0u & __")),
        ("if (m + 1 < ntiles) {", "if (false) {")]},
    # noselect_nostage without the barrier before the selection, and then
    # also without the filter and the score tile's store: the bare loop
    "product_1sync": {"knn_sweep.cuh": [
        (ROWS_BALLOT, ROWS_BALLOT.replace("= __", "= 0u & __")),
        ("if (m + 1 < ntiles) {", "if (false) {"),
        (SCORE_SYNC, SCORE_SYNC.split("\n")[0])]},
    "product_bare": {"knn_sweep.cuh": [
        (ROWS_BALLOT, ROWS_BALLOT.replace("= __", "= 0u & __")),
        ("if (m + 1 < ntiles) {", "if (false) {"),
        (SCORE_SYNC, SCORE_SYNC.split("\n")[0]),
        ("    *reinterpret_cast<float4*>(st + row * LDS + tx * 4) =\n"
         "        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);",
         "    if (acc[i][0] == 1234.5f) st[row] = acc[i][1] + acc[i][2] + acc[i][3];"),
        ("    if (hit) flag[row] = 1;", "")]},
    # the product with every lane of a warp on one query (one key) address:
    # if the time falls, shared-memory loads bound the product
    "product_q_uniform": {"knn_sweep.cuh": [
        (ROWS_BALLOT, ROWS_BALLOT.replace("= __", "= 0u & __")),
        ("if (m + 1 < ntiles) {", "if (false) {"),
        ("const float* qp = qs + ty * 4;", "const float* qp = qs + (ty & ~1) * 4;")]},
    "product_k_uniform": {"knn_sweep.cuh": [
        (ROWS_BALLOT, ROWS_BALLOT.replace("= __", "= 0u & __")),
        ("if (m + 1 < ntiles) {", "if (false) {"),
        ("const float* kp = kb + tx * 4;", "const float* kp = kb + (tx & 0) * 4;")]},
    # the row's list fetched and put back by a chain of selects over the
    # warp's 16 lists, not by a jump on the row (PR 4's form)
    "select_rows": {"knn_sweep.cuh": [
        ("    switch (r) {\n#define DGCNN_GET(u) \\\n  case u:            \\\n"
         "    cur = lists[u];  \\\n    break;\n      DGCNN_ROWS(DGCNN_GET)\n#undef DGCNN_GET\n    }\n",
         "    cur = lists[0];\n#pragma unroll\n    for (int u = 1; u < ROWS; ++u) {\n"
         "      if (u == r) cur = lists[u];\n    }\n"),
        ("    switch (r) {\n#define DGCNN_PUT(u) \\\n  case u:            \\\n"
         "    lists[u] = cur;  \\\n    break;\n      DGCNN_ROWS(DGCNN_PUT)\n#undef DGCNN_PUT\n    }\n",
         "#pragma unroll\n    for (int u = 0; u < ROWS; ++u) {\n      if (u == r) lists[u] = cur;\n    }\n")]},
    # the chunked layout forced at C + 2 > 8 with its channels in 1, 2 or 4
    # chunks (the one-pass layout at C = 4): the cost of a chunk, same graph
    **{f"chunk{n}": {"knn_sweep.cuh": [
        (CHUNK_RULE, CHUNK_RULE.replace("  if", FORCE_CHUNKS.format(n=n), 1))]} for n in (1, 2, 4)},
    # the TC sweep (sweep_tc): no selection (`noselect` covers both scores),
    # and no key staging after the first tile; then also without the
    # barrier before the selection, the score tile's store and the flags
    "tc_noselect_nostage": {"knn_sweep.cuh": [
        (ROWS_BALLOT, ROWS_BALLOT.replace("= __", "= 0u & __")),
        (TC_STAGE, "      if (false) {")]},
    "tc_product_bare": {"knn_sweep.cuh": [
        (ROWS_BALLOT, ROWS_BALLOT.replace("= __", "= 0u & __")),
        (TC_STAGE, "      if (false) {"),
        (TC_SCORE_SYNC, TC_SCORE_SYNC.split("\n      __sync")[0]),
        ("    *reinterpret_cast<float2*>(st + r0 * LDS + col) = make_float2(acc[n][0], acc[n][1]);\n"
         "    *reinterpret_cast<float2*>(st + r1 * LDS + col) = make_float2(acc[n][2], acc[n][3]);",
         "    if (acc[n][0] == 1234.5f) st[r0] = acc[n][1] + acc[n][2] + acc[n][3];"),
        ("  if (h0) flag[r0] = 1;\n  if (h1) flag[r1] = 1;", "")]},
    # the Hopper TC kernel: its product by mma.sync on ldmatrix fragments
    # (the same bits); the ring of 2 or 3 stages; no selection (the filter
    # and its ballots stay); the pipeline and product alone
    "hopper_mma": {"knn_tc.cuh": [
        (HOPPER_KERNEL, MMA_SYNC_PRODUCT + HOPPER_KERNEL),
        (HOPPER_PRODUCT, HOPPER_PRODUCT.replace("product(", "product_mma(").replace(
            "warp);", "warp, lane);"))]},
    **{f"hopper_stages{n}": {"knn_tc.cuh": [("constexpr int MAX_STAGES = 4;",
                                             f"constexpr int MAX_STAGES = {n};")]}
       for n in (2, 3)},
    "hopper_noselect": {"knn_tc.cuh": [(HOPPER_ROWS, "    if ((b0 | b1) != 1u) continue;")]},
    # key tiles of 128 (a wgmma of n128, 64 accumulators a thread)
    "hopper_tile128": {
        "knn_tc.cuh": [(HOPPER_TILE, "constexpr int TBK = 128;"),
                       ("static_assert(TBK == 64,", "static_assert(TBK == 128,")],
        "sm90.cuh": [("#undef DGCNN_ACC4", WGMMA_N128 + "#undef DGCNN_ACC4")]},
    "hopper_product": {"knn_tc.cuh": [
        (HOPPER_RELEASED, HOPPER_RELEASED + "    if (acc[0][0] == 1234.5f) bar0 = acc[NF - 1][3];\n"
                                            "    continue;\n")]},
    # the Hopper fp32 kernel: no selection (a row flagged alone in row 0
    # still takes it, so the ballots stay); the pipeline and product alone;
    # a ring of three stages
    "f32h_noselect": {"knn_hopper.cuh": [(F32H_ROWS, F32H_ROWS + "    if (rows != 1u) continue;\n")]},
    "f32h_product": {"knn_hopper.cuh": [(F32H_RELEASED, F32H_RELEASED + F32H_SINK)]},
    # one block an SM (no register cap of two), and the product's chains
    # advanced channel by channel over all of a lane's keys
    # the product's operands loaded once a tile (the FMAs alone, from the
    # same registers), and every lane's keys read from one address (the
    # loads stay, their data is shared): what the FMA pipe and the shared
    # memory's bandwidth each cost
    "f32h_product_noload": {"knn_hopper.cuh": [
        (F32H_RELEASED, F32H_RELEASED + F32H_SINK),
        ("const char* qb = q + g * QB * BOX_BYTES;", "const char* qb = q;"),
        ("const char* kb = k + g * TBK * BOX_BYTES;", "const char* kb = k;")]},
    "f32h_product_keys1": {"knn_hopper.cuh": [
        (F32H_RELEASED, F32H_RELEASED + F32H_SINK),
        ("kb + KG * j * BOX_BYTES + kc);", "kb + j * 16);")]},
    "count": {
        "warp_topk.cuh": [
            (COUNTERS, COUNTERS + "\n__device__ unsigned long long counts[4];"),
            ("    int pos = 0;\n", "    int pos = 0;\n    if (lane == 0) atomicAdd(&counts[1], 1ull);\n"),
            ("#pragma unroll\n    for (int r = 0; r < KS; ++r) {\n      const int slot",
             "    if (lane == 0 && pos < k) atomicAdd(&counts[2], 1ull);\n"
             "#pragma unroll\n    for (int r = 0; r < KS; ++r) {\n      const int slot")],
        "knn_sweep.cuh": [
            (TAKE, "if (bal[g]) {\n          if (lane == 0) atomicAdd(&counts[0], 1ull);\n"
                   "          cur.take(k, lane, bal[g], s[g], base + t0 + g * 32 + lane);\n"
                   "        }"),
            (FLAGGED_ROW, FLAGGED_ROW + "\n      if (lane == 0) atomicAdd(&counts[3], 1ull);")],
        "knn_tc.cuh": [
            ("        if (bal[c]) cur.take(k, lane, bal[c], sv[c], base + t0 + c * 32 + lane);",
             "        if (bal[c]) {\n          if (lane == 0) atomicAdd(&counts[0], 1ull);\n"
             "          cur.take(k, lane, bal[c], sv[c], base + t0 + c * 32 + lane);\n        }"),
            ("      rows &= rows - 1;\n",
             "      rows &= rows - 1;\n      if (lane == 0) atomicAdd(&counts[3], 1ull);\n")],
        "knn.cu": [("extern \"C\" {", COUNT_READ + "\nextern \"C\" {")],
        "knn_banded.cu": [("extern \"C\" {", COUNT_READ + "\nextern \"C\" {")],
        "ring_knn.cu": [("extern \"C\" {", COUNT_READ + "\nextern \"C\" {")],
    },
}
# variants whose graph must equal the first one's
EXACT = ("base", "unroll1", "pallas_order", "ascending", "outward", "nofilter", "bulk4", "bulk16",
         "nobulk", "select_rows", "count", "chunk1", "chunk2", "chunk4", "hopper_mma",
         "hopper_stages2", "hopper_stages3", "hopper_tile128")
# kernel -> its source
SOURCES = {"exact": "knn", "banded": "knn_banded", "ring": "ring_knn"}
# the sections that time other entry points of those sources
TC_SOURCES = {"exact_tc": ("knn",), "ring_tc": ("ring_knn", "knn"),
              "banded_tc": ("knn_banded", "knn"), "exact_f32": ("knn",)}


def log(msg: str) -> None:
    print(msg, flush=True)


def build(names, sources):
    """Patch and build every variant's libraries of ``sources``, all nvcc
    processes started together; returns {(variant, source): CDLL}."""
    procs = {}
    for name in names:
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        for fname, patches in VARIANTS[name].items():
            path = os.path.join(d, fname)
            with open(path) as f:
                text = f.read()
            for old, new in patches:
                if old not in text:
                    raise RuntimeError(f"variant {name}: {fname} has no {old!r}")
                text = text.replace(old, new)
            with open(path, "w") as f:
                f.write(text)
        for src in sources:
            procs[(name, src)] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(d, f"lib{src}.so"),
                 os.path.join(d, src + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (name, src), proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}, {src}.cu:\n{out}")
        report = [ln.split(":", 1)[-1].strip() for ln in out.splitlines()
                  if "registers" in ln or "spill" in ln]
        log(f"build {name}/{src}: " + " | ".join(report))
        lib = ctypes.CDLL(os.path.join(OUT, name, f"lib{src}.so"))
        vp, i = ctypes.c_void_p, ctypes.c_int
        if src == "knn":
            for fn in (lib.dgcnn_knn_topk_f32, lib.dgcnn_knn_topk_bf16):
                fn.argtypes = [vp] * 9 + [i] * 7 + [vp]
                fn.restype = i
            for fn in (lib.dgcnn_knn_topk_tc, lib.dgcnn_knn_topk_f32h):
                fn.argtypes = [vp] * 7 + [i] * 7 + [vp]
                fn.restype = i
            for fn in (lib.dgcnn_knn_slots, lib.dgcnn_knn_slots_bf16):
                fn.argtypes = [i, i, i]
                fn.restype = i
            for fn in (lib.dgcnn_knn_slots_tc, lib.dgcnn_knn_slots_f32h):
                fn.argtypes = [i, i]
                fn.restype = i
        elif src == "knn_banded":
            for fn in (lib.dgcnn_knn_banded_f32, lib.dgcnn_knn_banded_bf16):
                fn.argtypes = [vp] * 8 + [i] * 9 + [vp]
                fn.restype = i
            lib.dgcnn_knn_banded_tc.argtypes = [vp] * 6 + [i] * 9 + [vp]
            lib.dgcnn_knn_banded_tc.restype = i
        else:
            for fn in (lib.dgcnn_ring_knn_step_f32, lib.dgcnn_ring_knn_step_bf16):
                fn.argtypes = [vp] * 6 + [i] * 6 + [vp]
                fn.restype = i
            lib.dgcnn_ring_knn_step_tc.argtypes = [vp] * 4 + [i] * 6 + [vp]
            lib.dgcnn_ring_knn_step_tc.restype = i
        if name == "count":
            lib.count_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
            lib.count_read.restype = i
        libs[(name, src)] = lib
    return libs


def capture(cfg, batch, seed: int):
    """The inputs of the first two graph builds of one forward."""
    from dgcnn_tpu_torch.train.trainval import Trainval

    tv = Trainval(cfg)
    state = tv.initialize(4, generator=torch.Generator().manual_seed(seed))
    points = torch.tensor(batch.points, device="cuda")
    mask = torch.tensor(batch.mask, device="cuda")
    captured, knn_fn = [], tv.model.knn_fn

    def recording(x, k, m):
        captured.append((x.clone(), m.clone()))
        return knn_fn(x, k, m)

    tv.model.knn_fn = recording
    with torch.inference_mode():
        tv.model(state.params, state.model_state, points, mask)
    return captured[:2]


def counted(lib, run, rows: int) -> str:
    buf = (ctypes.c_ulonglong * 4)()
    lib.count_read(buf)  # zero
    run()
    torch.cuda.synchronize()
    if lib.count_read(buf) != 0:
        raise RuntimeError("count_read failed")
    return (f" per row: flagged tiles {buf[3] / rows:.2f}, column groups with a winner "
            f"{buf[0] / rows:.2f}, candidates taken {buf[1] / rows:.2f}, entered the top k "
            f"{buf[2] / rows:.2f}")


def clocks_while(run, seconds: float = 2.0) -> str:
    """The SM clock and power draw that nvidia-smi reads while ``run`` is
    repeated for about ``seconds``: min, median and max of the samples."""
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=60).stdout
            samples.append([float(v) for v in out.strip().splitlines()[0].split(",")])

    run()
    torch.cuda.synchronize()
    thread = threading.Thread(target=sample)
    thread.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        run()
        torch.cuda.synchronize()
    stop.set()
    thread.join()
    if not samples:
        return "no clock samples"
    mhz, watts = (sorted(s[i] for s in samples) for i in (0, 1))
    return (f"{len(samples)} samples: SM clock {mhz[0]:.0f}/{mhz[len(mhz) // 2]:.0f}/{mhz[-1]:.0f} "
            f"MHz, power {watts[0]:.1f}/{watts[len(watts) // 2]:.1f}/{watts[-1]:.1f} W "
            f"(min/median/max)")


def time_variants(label, names, libs, src, make_run, rows, reps: int = 3):
    ref = None
    for name in names:
        lib = libs[(name, src)]
        run, out = make_run(lib)
        ms = cs.cuda_ms(torch, run, reps=reps, warmup=1)
        if name in ("base", "noselect_nostage"):
            log(f"{label} {name} under load: {clocks_while(run)}")
        note = ""
        if name in EXACT:
            got = out()
            ref = got.clone() if ref is None else ref
            note = f", graph equal to {names[0]}'s: {bool(torch.equal(ref, got))}"
        if name == "count":
            note += counted(lib, run, rows)
        log(f"{label} {name}: {ms:.4f} ms{note}")


def exact_section(names, libs, smi, k, stream):
    """The exact kernel on the first two graph-build inputs of one served
    4 x 4096 forward: every variant at the card's choice of S, then
    ``base`` with S forced to 1, 2 and 4 (outputs compared bit for bit);
    then ``base`` on the first event of each input alone at S forced to
    1, 2, 4 and 8."""
    from dgcnn_tpu_torch.config import Config

    cfg = Config(model_name="residual-dgcnn", num_class=2, kvalue=k,
                 edge_filters=(cs.EDGE_WIDTH,) * cs.EDGE_BLOCKS, minibatch_size=cs.B,
                 num_point=cs.N)
    captured = capture(cfg, cs.serving_batches(cfg, 0)[0], 0)
    # and one event alone (B=1, 32 query blocks): where the split fills the card
    for x, m in captured + [(x[:1].contiguous(), m[:1].contiguous()) for x, m in captured]:
        qa, ka = kmod.build_augmented_operands(x, x, m)
        b, n, c2 = qa.shape
        outs = tuple(torch.empty((b, n, k), dtype=t, device="cuda")
                     for t in (torch.int32, torch.bool, torch.float32))

        def make_run(lib, splits=None):
            s = splits or kmod.split_count(b * -(-n // kmod.QB), -(-n // kmod.TB),
                                           lib.dgcnn_knn_slots(c2, k, 0))
            part = [torch.empty((s, b, n, k), dtype=t, device="cuda")
                    for t in (torch.float32, torch.int32)] if s > 1 else [None, None]
            ptrs = [t.data_ptr() for t in (qa, ka) + outs] + [
                None if t is None else t.data_ptr() for t in part] + [None, None]

            def run():
                err = lib.dgcnn_knn_topk_f32(*ptrs, b, n, n, c2, k, s, 0, stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            return run, lambda: outs[0]

        label = f"exact B={b} N={n} C={c2 - 2} [{smi}]"
        base = libs[("base", "knn")] if "base" in names else None
        if base is not None:
            log(f"{label}: the card's split S="
                f"{kmod.split_count(b * -(-n // kmod.QB), -(-n // kmod.TB), base.dgcnn_knn_slots(c2, k, 0))}")
        if b > 1:
            time_variants(label, names, libs, "knn", make_run, b * n, reps=20)
        if base is None:
            continue
        ref = None
        for s in (1, 2, 4) if b > 1 else (1, 2, 4, 8):
            run, _ = make_run(base, s)
            ms = cs.cuda_ms(torch, run, reps=20, warmup=3)
            got = tuple(t.clone() for t in outs)
            ref = got if ref is None else ref
            same = all(torch.equal(a, g) for a, g in zip(ref, got))
            log(f"{label} base splits={s}: {ms:.4f} ms, idx, valid and scores equal to "
                f"splits=1's: {same}")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    kernels = list(SOURCES)
    if "--only" in argv:
        at = argv.index("--only")
        kernels = argv[at + 1].split(",")
        del argv[at:at + 2]
    names = argv or list(VARIANTS)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    from dgcnn_tpu_torch.train.trainval import disable_tf32

    smi = cs.nvidia_smi()
    disable_tf32()
    log(smi)
    t0 = time.perf_counter()
    sources = {SOURCES[kn] for kn in kernels if kn in SOURCES}
    sources |= {s for kn in kernels for s in TC_SOURCES.get(kn, ())}
    libs = build(names, sorted(sources))
    log(f"built {len(names)} variants of {kernels} in {time.perf_counter() - t0:.1f} s")
    k = cs.K
    stream = torch.cuda.current_stream().cuda_stream

    if "exact" in kernels:
        exact_section(names, libs, smi, k, stream)
    if "banded" in kernels:
        banded_section(names, libs, smi, k, stream)
    if "ring" in kernels:
        ring_section(names, libs, smi, k, stream)
    if "passes" in kernels:
        passes_section(smi)
    if "step" in kernels:
        step_section(smi)
    if "exact_f32" in kernels:
        exact_f32_section(names, libs, smi, k, stream)
    if {"exact_tc", "probe", "ring_tc", "banded_tc"} & set(kernels):
        inputs = tc_inputs(k)
        if "exact_tc" in kernels:
            exact_tc_section(names, libs, smi, k, stream, inputs)
        if "probe" in kernels:
            probe_section(smi, inputs[:2])
        if "ring_tc" in kernels:
            ring_tc_section(names, libs, smi, k, stream, inputs[:2])
        if "banded_tc" in kernels:
            banded_tc_section(names, libs, smi, k, stream)
        if ({"ring_tc", "banded_tc"} & set(kernels)) and "exact_tc" not in kernels:
            exact_tc_section(["base"] if "base" in names else [], libs, smi, k, stream,
                             inputs[:2])
    return 0


PROBE_SRC = r"""
// Two product chains on every (query, key) pair, from the Hopper kernel's
// 32-byte swizzled layout: csrc/knn_tc.cuh's wgmma chain and an mma.sync
// chain on ldmatrix fragments (`product_mma`). The rows of qa (64 a block)
// against the keys of ka (tc::TBK a block), bf16 with c2 channels.
#include "knn_tc.cuh"

using namespace dgcnn;

namespace dgcnn {
namespace tc {
""" + MMA_SYNC_PRODUCT + r"""
}  // namespace tc
}  // namespace dgcnn

__global__ void __launch_bounds__(128) probe_kernel(const uint16_t* qa, const uint16_t* ka, int nq,
                                                    int nk, int c2, float* out_w, float* out_m) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_s = sm90::smem_addr(smem_raw);
  const uint32_t q_s = (raw_s + tc::ALIGN - 1) & ~(uint32_t)(tc::ALIGN - 1);
  const int steps = c2 / tc::KSTEP;
  const uint32_t k_s = q_s + steps * QB * 32;
  uint8_t* qp = smem_raw + (q_s - raw_s);
  uint8_t* kp = smem_raw + (k_s - raw_s);
  const int per_row = c2 / 8;  // 16-byte pieces a row
  const int q0 = blockIdx.x * 64;
  const int t0 = blockIdx.y * tc::TBK;
  for (int i = threadIdx.x; i < QB * per_row; i += 128) {
    const int row = i / per_row, h = i % per_row;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < 64 && q0 + row < nq) v = *reinterpret_cast<const uint4*>(qa + (size_t)(q0 + row) * c2 + h * 8);
    *reinterpret_cast<uint4*>(qp + (h / 2) * QB * 32 + row * 32 + (((h % 2) ^ ((row >> 2) & 1)) << 4)) = v;
  }
  for (int i = threadIdx.x; i < tc::TBK * per_row; i += 128) {
    const int row = i / per_row, h = i % per_row;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t0 + row < nk) v = *reinterpret_cast<const uint4*>(ka + (size_t)(t0 + row) * c2 + h * 8);
    *reinterpret_cast<uint4*>(kp + (h / 2) * tc::TBK * 32 + row * 32 + (((h % 2) ^ ((row >> 2) & 1)) << 4)) = v;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[tc::NF][4];
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 0) {
      tc::product(acc, q_s, k_s, steps, warp);
    } else {
      tc::product_mma(acc, q_s, k_s, steps, warp, lane);
    }
    float* out = pass == 0 ? out_w : out_m;
#pragma unroll
    for (int n = 0; n < tc::NF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + warp * 16 + (lane >> 2) + (e >= 2 ? 8 : 0);
        const int key = t0 + 8 * n + 2 * (lane & 3) + (e & 1);
        if (row < nq && key < nk) out[(size_t)row * nk + key] = acc[n][e];
      }
  }
}

extern "C" int probe(const void* qa, const void* ka, int nq, int nk, int c2, float* out_w,
                     float* out_m, cudaStream_t stream) {
  const size_t smem = tc::ALIGN + (size_t)(QB + tc::TBK) * c2 * 2;
  cudaError_t err = cudaFuncSetAttribute(probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + 63) / 64, (nk + tc::TBK - 1) / tc::TBK);
  probe_kernel<<<grid, 128, smem, stream>>>(static_cast<const uint16_t*>(qa),
                                            static_cast<const uint16_t*>(ka), nq, nk, c2, out_w, out_m);
  return (int)cudaGetLastError();
}
"""


def tc_inputs(k):
    """The first two graph-build inputs (C=4, C=64) of step 1 of the bf16 +
    remat train step at 1 x PREC_N (``chip_smoke.py`` phase 17's) and at 1
    x TRAIN_N, and of one bf16 + default served B x N forward: ``[(label,
    x f32, mask)]``, the PREC_N ones first. The graphs of the capturing
    runs come from ``sweep_tc``, so the inputs do not depend on the kernel
    under test."""
    from dgcnn_tpu_torch.config import Config

    route = kmod.tc_kernel_for
    kmod.tc_kernel_for = lambda *a, **kw: "sweep"
    run = cs.run_steps(torch, kmod, cs.prec_config(cs.PREC_N), cs.one_event(cs.PREC_N, 0), 0, 0, 1,
                       record=True)
    out = [(f"train B=1 N={cs.PREC_N}", x.float().contiguous(), m) for x, m in run["captured"][:2]]
    run = cs.run_steps(torch, kmod, cs.prec_config(cs.TRAIN_N), cs.one_event(cs.TRAIN_N, 0), 0, 0, 1,
                       record=True)
    out += [(f"train B=1 N={cs.TRAIN_N}", x.float().contiguous(), m)
            for x, m in run["captured"][:2]]
    cfg = Config(model_name="residual-dgcnn", num_class=2, kvalue=k,
                 edge_filters=(cs.EDGE_WIDTH,) * cs.EDGE_BLOCKS, minibatch_size=cs.B,
                 num_point=cs.N, precision="bfloat16", knn_precision="default")
    out += [(f"serve B={cs.B} N={cs.N}", x.float().contiguous(), m)
            for x, m in capture(cfg, cs.serving_batches(cfg, 0)[0], 0)]
    kmod.tc_kernel_for = route
    return out


def step_section(smi, rounds: int = 2):
    """The bf16 + remat train step of ``chip_smoke.py`` phase 17 (the
    flagship model on one PREC_N-point event, 2 warm-up + PREC_STEPS timed
    steps, the same seeded init and batch) with the exact TC graph builds
    routed by shape (the Hopper kernel) and forced to sweep_tc, in turns
    (Hopper, sweep, sweep, Hopper, ...): ms a step by CUDA events and the
    host clock, peak memory, the launches of each form a step."""
    route = kmod.tc_kernel_for
    batch = cs.one_event(cs.PREC_N, 0)
    cfg = cs.prec_config(cs.PREC_N)
    for form in ("tc", "sweep", "sweep", "tc")[: 2 * rounds]:
        if form == "sweep":
            kmod.tc_kernel_for = lambda *a, **kw: "sweep"
        r = cs.run_steps(torch, kmod, cfg, batch, 0, cs.PREC_WARMUP, cs.PREC_STEPS)
        kmod.tc_kernel_for = route
        log(f"step bf16 + remat B=1 N={cs.PREC_N} graph builds on {form} [{smi}]: "
            f"{r['event_ms']:.3f} ms a step (CUDA events), {r['host_ms']:.3f} ms (host clock), "
            f"peak {r['peak_gib']:.3f} GiB, (Hopper TC, sweep TC, fp32) launches a step "
            f"{r['per_step'][-1]}, losses {[round(v, 6) for v in r['losses']]}")


def tc_forms(name):
    """The TC forms a variant changes: the sweep's, the Hopper kernel's, or
    both (``base``, ``count``); none for the fp32-only variants."""
    if name.startswith("hopper_"):
        return ("tc",)
    if name in ("noselect",) or name.startswith("tc_"):
        return ("sweep",)
    return ("sweep", "tc") if name in ("base", "count", "nobulk", "bulk4", "bulk16") else ()


def exact_tc_section(names, libs, smi, k, stream, inputs):
    """Both TC forms of the exact kernel on ``inputs`` (`tc_inputs`), from
    every variant's library: times at the card's key split, graphs against
    the base sweep's (indices and scores ``==``); the base in turns; the
    Hopper kernel at S forced to 1, 2, 4 and 8."""
    for label, x, m in inputs:
        qa, ka = kmod.build_augmented_operands(x, x, m, "default")
        qa, ka = kmod.tc_operand(qa), kmod.tc_operand(ka)
        b, n, c2 = qa.shape
        outs = tuple(torch.empty((b, n, k), dtype=t, device="cuda")
                     for t in (torch.int32, torch.bool, torch.float32))
        reps = 5 if n > 16384 else 20

        def make_run(lib, form, splits=None):
            blocks = b * -(-n // kmod.QB)
            if form == "tc":
                s = splits or kmod.split_count_idle(blocks, -(-n // kmod.TB_TC),
                                                    lib.dgcnn_knn_slots_tc(c2, k))
            else:
                s = splits or kmod.split_count(blocks, -(-n // kmod.TB),
                                               lib.dgcnn_knn_slots_bf16(c2, k, 0))
            part = [torch.empty((s, b, n, k), dtype=t, device="cuda")
                    for t in (torch.float32, torch.int32)] if s > 1 else [None, None]
            ptrs = [t.data_ptr() for t in (qa, ka) + outs] + [
                None if t is None else t.data_ptr() for t in part]

            def run():
                if form == "tc":
                    err = lib.dgcnn_knn_topk_tc(*ptrs, b, n, n, c2, k, s, 0, stream)
                else:
                    err = lib.dgcnn_knn_topk_bf16(*ptrs, None, None, b, n, n, c2, k, s, 0, stream)
                if err:
                    raise RuntimeError(f"{form} launch failed: CUDA error {err}")
            return run, s

        def graph():
            return tuple(t.clone() for t in outs)

        head = f"exact_tc {label} C={x.shape[-1]} (c2={c2}) k={k} [{smi}]"
        base = libs[("base", "knn")] if "base" in names else None
        ref = None
        if base is not None:
            run, s = make_run(base, "sweep")
            cs.cuda_once(torch, run)
            ref = graph()
            turns = []
            for form in ("sweep", "tc", "tc", "sweep"):
                run, s = make_run(base, form)
                turns.append(f"{form} (S={s}) {cs.cuda_ms(torch, run, reps=reps, warmup=1):.4f} ms")
            log(f"{head} base in turns: " + ", ".join(turns))
        for name in names:
            for form in tc_forms(name):
                lib = libs[(name, "knn")]
                run, s = make_run(lib, form)
                ms = cs.cuda_ms(torch, run, reps=reps, warmup=1)
                note = ""
                if name in EXACT and ref is not None:
                    got = graph()
                    same = all(torch.equal(a, g) for a, g in zip(ref, got))
                    note = f", indices, valid and scores equal to the base sweep's: {same}"
                if name == "count":
                    note += counted(lib, run, b * n)
                log(f"{head} {name} {form} (S={s}): {ms:.4f} ms{note}")
        if base is None:
            continue
        tiles = -(-n // kmod.TB_TC)
        for s in (1, 2, 4, 8):
            if s > tiles:
                continue
            run, _ = make_run(base, "tc", s)
            ms = cs.cuda_ms(torch, run, reps=reps, warmup=1)
            same = all(torch.equal(a, g) for a, g in zip(ref, graph()))
            log(f"{head} base tc splits={s}: {ms:.4f} ms, equal to the sweep's: {same}")


def f32_forms(name):
    """The fp32 forms of the exact kernel a variant's library is timed in:
    the Hopper kernel alone for its own variants, both for the others."""
    return ("hopper",) if name.startswith("f32h_") else ("sweep", "hopper")


def exact_f32_section(names, libs, smi, k, stream):
    """Both fp32 forms of the exact kernel on the first two graph-build
    inputs of one f32 forward at 1 x 131,072 and of one served B x N
    forward, from every variant's library: times at the card's key split,
    graphs against the base sweep's (indices, valid and scores ``==``);
    the base in turns; the Hopper kernel at S forced to 1, 2 and 4 on the
    served batch."""
    from dgcnn_tpu_torch.config import Config

    train_n = cs.LONG_TRAIN_N
    serve_cfg = Config(model_name="residual-dgcnn", num_class=2, kvalue=k,
                       edge_filters=(cs.EDGE_WIDTH,) * cs.EDGE_BLOCKS, minibatch_size=cs.B,
                       num_point=cs.N)
    inputs = [(f"train 1 x {train_n}", x, m) for x, m in
              capture(cs.long_config(train_n), cs.one_event(train_n, 0), 0)]
    inputs += [(f"served {cs.B} x {cs.N}", x, m) for x, m in
               capture(serve_cfg, cs.serving_batches(serve_cfg, 0)[-1], 0)]
    for label, x, m in inputs:
        qa, ka = kmod.build_augmented_operands(x, x, m, cpad=kmod.CPAD)
        b, n, c2 = qa.shape
        outs = tuple(torch.empty((b, n, k), dtype=t, device="cuda")
                     for t in (torch.int32, torch.bool, torch.float32))
        reps = 3 if n > 16384 else 20

        def make_run(lib, form, splits=None):
            blocks, tiles = b * -(-n // kmod.QB), -(-n // kmod.TB)
            slots = (lib.dgcnn_knn_slots_f32h(c2, k) if form == "hopper"
                     else lib.dgcnn_knn_slots(c2, k, 0))
            s = splits or kmod.split_count(blocks, tiles, slots)
            part = [torch.empty((s, b, n, k), dtype=t, device="cuda")
                    for t in (torch.float32, torch.int32)] if s > 1 else [None, None]
            ptrs = [t.data_ptr() for t in (qa, ka) + outs] + [
                None if t is None else t.data_ptr() for t in part]

            def run():
                if form == "hopper":
                    err = lib.dgcnn_knn_topk_f32h(*ptrs, b, n, n, c2, k, s, 0, stream)
                else:
                    err = lib.dgcnn_knn_topk_f32(*ptrs, None, None, b, n, n, c2, k, s, 0, stream)
                if err:
                    raise RuntimeError(f"{form} launch failed: CUDA error {err}")
            return run, s

        def graph():
            return tuple(t.clone() for t in outs)

        head = f"exact_f32 {label} C={x.shape[-1]} (c2={c2}) k={k} [{smi}]"
        base = libs[("base", "knn")] if "base" in names else None
        ref = None
        if base is not None:
            run, s = make_run(base, "sweep")
            cs.cuda_once(torch, run)
            ref = graph()
            turns = []
            for form in ("sweep", "hopper", "hopper", "sweep"):
                run, s = make_run(base, form)
                turns.append(f"{form} (S={s}) {cs.cuda_ms(torch, run, reps=reps, warmup=1):.4f} ms")
            log(f"{head} base in turns: " + ", ".join(turns))
        for name in names:
            for form in f32_forms(name):
                run, s = make_run(libs[(name, "knn")], form)
                ms = cs.cuda_ms(torch, run, reps=reps, warmup=1)
                note = ""
                if name in EXACT and ref is not None:
                    same = all(torch.equal(a, g) for a, g in zip(ref, graph()))
                    note = f", indices, valid and scores equal to the base sweep's: {same}"
                if n > 16384 and name in ("base", "f32h_product"):
                    note += f"; under load: {clocks_while(run)}"
                log(f"{head} {name} {form} (S={s}): {ms:.4f} ms{note}")
        if base is None or b == 1:
            continue
        for s in (1, 2, 4):
            run, _ = make_run(base, "hopper", s)
            ms = cs.cuda_ms(torch, run, reps=reps, warmup=1)
            same = all(torch.equal(a, g) for a, g in zip(ref, graph()))
            log(f"{head} base hopper splits={s}: {ms:.4f} ms, equal to the sweep's: {same}")


def tc_variants(label, names, libs, src, make_run, rows, reps):
    """Every variant's TC forms (`tc_forms`) of one input: times, graphs
    against the base sweep's (``==``), the base's two forms in turns.
    ``make_run(lib, form)`` gives ``(run, graph)``: the launches of one
    call and a function that returns their (idx, valid, scores)."""
    ref = None
    if "base" in names:
        base = libs[("base", src)]
        run, graph = make_run(base, "sweep")
        cs.cuda_once(torch, run)
        ref = graph()
        turns = []
        for form in ("sweep", "tc", "tc", "sweep"):
            run, _ = make_run(base, form)
            turns.append(f"{form} {cs.cuda_ms(torch, run, reps=reps, warmup=1):.4f} ms")
        log(f"{label} base in turns: " + ", ".join(turns))
    for name in names:
        for form in tc_forms(name):
            lib = libs[(name, src)]
            run, graph = make_run(lib, form)
            ms = cs.cuda_ms(torch, run, reps=reps, warmup=1)
            note = ""
            if name in EXACT and ref is not None:
                same = all(torch.equal(a, g) for a, g in zip(ref, graph()))
                note = f", indices, valid and scores equal to the base sweep's: {same}"
            if name == "count":
                note += counted(lib, run, rows)
            log(f"{label} {name} {form}: {ms:.4f} ms{note}")


def ring_tc_section(names, libs, smi, k, stream, inputs):
    """The ring step's two TC forms on ``inputs`` (`tc_inputs`' 1 x 131,072
    train inputs) split into CP_P virtual owners: rank 0's four steps from
    fresh lists, from every variant's library (`tc_variants`)."""
    for label, x, m in inputs:
        qa, ka = kmod.build_augmented_operands(x, x, m, "default")
        qa, ka = kmod.tc_operand(qa), kmod.tc_operand(ka)
        q, blocks = cs.ring_rank_blocks(qa, ka, 0, cs.CP_P)
        b, nl, c2 = q.shape
        lists = {}

        def make_run(lib, form):
            def run():
                topv = torch.full((b, nl, k), torch.finfo(torch.float32).min, device="cuda")
                topi = torch.zeros((b, nl, k), dtype=torch.int32, device="cuda")
                for kb, base in blocks:
                    ptrs = (q.data_ptr(), kb.data_ptr(), topv.data_ptr(), topi.data_ptr())
                    if form == "tc":
                        err = lib.dgcnn_ring_knn_step_tc(*ptrs, b, nl, kb.shape[1], c2, k, base,
                                                         stream)
                    else:
                        err = lib.dgcnn_ring_knn_step_bf16(*ptrs, None, None, b, nl, kb.shape[1],
                                                           c2, k, base, stream)
                    if err:
                        raise RuntimeError(f"{form} launch failed: CUDA error {err}")
                lists["out"] = (topi, topv)
            return run, lambda: lists["out"]

        tc_variants(f"ring_tc {label} 4 steps of N_local={nl} C={x.shape[-1]} (c2={c2}) k={k} "
                    f"[{smi}]", names, libs, "ring_knn", make_run, b * nl, reps=5)
    log("(ring_tc times are for rank 0's 4 steps from fresh lists; divide by 4 for a launch)")


def banded_tc_section(names, libs, smi, k, stream):
    """The banded pass's two TC forms on the first two graph-build inputs
    of one bf16 1,048,576-point forward at knn_window=8192, from every
    variant's library (`tc_variants`)."""
    from dgcnn_tpu_torch.config import Config

    cfg = Config(model_name="residual-dgcnn", num_class=2, kvalue=k,
                 edge_filters=(cs.EDGE_WIDTH,) * cs.EDGE_BLOCKS, knn_window=cs.LONG_W,
                 minibatch_size=1, num_point=cs.LONG_N, precision="bfloat16",
                 knn_precision="default")
    for x, m in capture(cfg, cs.long_events(0)[0], 0):
        x = x.float().contiguous()
        qa, ka = kmod.build_augmented_operands(x, x, m, "default")
        qa, ka = kmod.tc_operand(qa), kmod.tc_operand(ka)
        nvalid = m.sum(-1).to(torch.int32)
        b, n, c2 = qa.shape
        outs = tuple(torch.empty((b, n, k), dtype=t, device="cuda")
                     for t in (torch.int32, torch.bool, torch.float32))
        ptrs = [qa.data_ptr(), ka.data_ptr(), nvalid.data_ptr()] + [t.data_ptr() for t in outs]

        def make_run(lib, form):
            def run():
                if form == "tc":
                    err = lib.dgcnn_knn_banded_tc(*ptrs, b, n, n, c2, k, cs.LONG_W, 0, 0, 0,
                                                  stream)
                else:
                    err = lib.dgcnn_knn_banded_bf16(*ptrs, None, None, b, n, n, c2, k,
                                                    cs.LONG_W, 0, 0, 0, stream)
                if err:
                    raise RuntimeError(f"{form} launch failed: CUDA error {err}")
            return run, lambda: tuple(t.clone() for t in outs)

        tc_variants(f"banded_tc N={n} W={cs.LONG_W} C={x.shape[-1]} (c2={c2}) k={k} [{smi}]",
                    names, libs, "knn_banded", make_run, b * n, reps=3)


def probe_section(smi, inputs, chunk: int = 2048):
    """`PROBE_SRC` on every (query, key) pair of ``inputs``: the count of
    scores where the wgmma chain and the mma.sync chain differ (``!=``),
    their largest difference, and, on the first chunk of rows, both
    against an fp32 matmul of the same bf16 operands (relative to a
    score's sum of absolute terms: a layout fault shows as a large
    error, a summation order as a few units of the last place)."""
    d = os.path.join(OUT, "probe")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    with open(os.path.join(d, "probe.cu"), "w") as f:
        f.write(PROBE_SRC)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(d, "libprobe.so"),
                           os.path.join(d, "probe.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the probe:\n{proc.stdout}{proc.stderr}")
    log("build probe: " + " | ".join(ln.split(":", 1)[-1].strip() for ln in proc.stdout.splitlines()
                                      if "registers" in ln or "spill" in ln))
    lib = ctypes.CDLL(os.path.join(d, "libprobe.so"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.probe.argtypes = [vp, vp, i, i, i, vp, vp, vp]
    lib.probe.restype = i
    stream = torch.cuda.current_stream().cuda_stream
    for label, x, m in inputs:
        qa, ka = kmod.build_augmented_operands(x, x, m, "default")
        qa, ka = kmod.tc_operand(qa)[0], kmod.tc_operand(ka)[0]
        n, c2 = ka.shape
        out_w = torch.empty((chunk, n), device="cuda")
        out_m = torch.empty((chunk, n), device="cuda")
        differ, worst, pairs = 0, 0.0, 0
        for r0 in range(0, qa.shape[0], chunk):
            rows = min(chunk, qa.shape[0] - r0)
            err = lib.probe(qa[r0:].data_ptr(), ka.data_ptr(), rows, n, c2, out_w.data_ptr(),
                            out_m.data_ptr(), stream)
            if err:
                raise RuntimeError(f"probe launch failed: CUDA error {err}")
            w, mm = out_w[:rows], out_m[:rows]
            differ += int((w != mm).sum())
            worst = max(worst, float((w - mm).abs().max()))
            pairs += rows * n
            if r0 == 0:
                qf, kf = qa[:rows].float(), ka.float()
                ref = qf @ kf.T
                scale = qf.abs() @ kf.abs().T
                rel = lambda t: float(((t - ref).abs() / scale.clamp_min(1e-30)).max())  # noqa: E731
                log(f"probe {label} C={x.shape[-1]} (c2={c2}) rows [0, {rows}) [{smi}]: "
                    f"against an fp32 matmul of the bf16 operands, wgmma max rel {rel(w):.3e}, "
                    f"mma.sync max rel {rel(mm):.3e}")
        log(f"probe {label} C={x.shape[-1]} (c2={c2}) [{smi}]: {pairs} (query, key) pairs, "
            f"wgmma.m64n{kmod.TB_TC}k16 chain != mma.sync.m16n8k16 chain in {differ}, max "
            f"|difference| {worst:.3e}")


def passes_section(smi):
    """The package's exact kernel alone (prebuilt operands, the card's key
    split) on the first two graph-build inputs of one served 4 x 4096
    forward at k from one to three passes, and with the features repeated
    to C = 256 (three chunks of channels) at k = 20 and 96."""
    from dgcnn_tpu_torch.config import Config

    cfg = Config(model_name="residual-dgcnn", num_class=2, kvalue=cs.K,
                 edge_filters=(cs.EDGE_WIDTH,) * cs.EDGE_BLOCKS, minibatch_size=cs.B,
                 num_point=cs.N)
    captured = capture(cfg, cs.serving_batches(cfg, 0)[0], 0)
    wide = torch.cat([captured[1][0]] * 4, dim=-1)
    cases = [(x, m, k) for x, m in captured for k in (20, 32, 64, 96, 128, 192)]
    cases += [(wide, captured[1][1], k) for k in (20, 96)]
    lib = kmod._lib()
    for x, m, k in cases:
        qa, ka = kmod.build_augmented_operands(x, x, m)
        b, n, c2 = qa.shape
        ms = cs.cuda_ms(torch, lambda: kmod.launch_operands(qa, ka, k), reps=10, warmup=2)
        passes = -(-k // kmod.KMAX)
        chunk = lib.dgcnn_knn_chunk(c2)
        c2p = -(-c2 // 4) * 4  # channels padded to 4, as the kernel stages them
        nch = -(-c2p // chunk) if chunk else 1
        log(f"passes B={b} N={n} C={c2 - 2} k={k} [{smi}]: {ms:.4f} ms, {passes} pass(es), "
            f"{nch} channel chunk(s) (CH={chunk or 'one pass'})")


def banded_section(names, libs, smi, k, stream):
    from dgcnn_tpu_torch.config import Config

    long_cfg = Config(model_name="residual-dgcnn", num_class=2, kvalue=k,
                      edge_filters=(cs.EDGE_WIDTH,) * cs.EDGE_BLOCKS, knn_window=cs.LONG_W,
                      minibatch_size=1, num_point=cs.LONG_N)
    for x, m in capture(long_cfg, cs.long_events(0)[0], 0):
        qa, ka = kmod.build_augmented_operands(x, x, m)
        nvalid = m.sum(-1).to(torch.int32)
        b, n, c2 = qa.shape
        idx = torch.empty((b, n, k), dtype=torch.int32, device="cuda")
        valid = torch.empty((b, n, k), dtype=torch.bool, device="cuda")
        scores = torch.empty((b, n, k), dtype=torch.float32, device="cuda")

        def make_run(lib):
            def run():
                err = lib.dgcnn_knn_banded_f32(
                    qa.data_ptr(), ka.data_ptr(), nvalid.data_ptr(), idx.data_ptr(),
                    valid.data_ptr(), scores.data_ptr(), None, None, b, n, n, c2, k, cs.LONG_W,
                    0, 0, 0, stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            return run, lambda: idx

        time_variants(f"banded N={n} W={cs.LONG_W} C={c2 - 2} [{smi}]", names, libs,
                      "knn_banded", make_run, b * n)


def ring_section(names, libs, smi, k, stream):
    cp_cfg = dataclasses.replace(cs.cp_config(), point_shards=1, ring_impl="ppermute")
    for x, m in capture(cp_cfg, cs.cp_events(0)[0], 0):
        qa, ka = kmod.build_augmented_operands(x, x, m)
        q, blocks = cs.ring_rank_blocks(qa, ka, 0, cs.CP_P)
        b, nl, c2 = q.shape
        lists = [None]

        def make_run(lib):
            def run():
                topv = torch.full((b, nl, k), torch.finfo(torch.float32).min, device="cuda")
                topi = torch.zeros((b, nl, k), dtype=torch.int32, device="cuda")
                for kb, base in blocks:
                    err = lib.dgcnn_ring_knn_step_f32(q.data_ptr(), kb.data_ptr(), topv.data_ptr(),
                                                      topi.data_ptr(), None, None, b, nl,
                                                      kb.shape[1], c2, k, base, stream)
                    if err:
                        raise RuntimeError(f"launch failed: CUDA error {err}")
                lists[0] = topi
            return run, lambda: lists[0]

        time_variants(f"ring 4 steps of N_local={nl} C={c2 - 2} [{smi}]", names, libs,
                      "ring_knn", make_run, b * nl)
    log("(ring times are for rank 0's 4 steps from fresh lists; divide by 4 for a launch)")


if __name__ == "__main__":
    sys.exit(main())
