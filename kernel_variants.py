#!/usr/bin/env python3
"""Time design variants of the exact, banded and ring kNN kernels on one
NVIDIA GPU.

    python3 kernel_variants.py [--only exact,banded,ring,passes] [VARIANT ...]

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
seconds. The numbers go to stdout.
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
PALLAS_ORDER = "(m == 0 ? diag : (m <= diag ? m - 1 : m))"
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
FORCE_CHUNKS = "  if (c2 > 8) return round_up((round_up(c2, CPAD) + {n} - 1) / {n}, CPAD);\n  if"
# name -> {file: [(old, new), ...]}
VARIANTS = {
    "base": {},
    # the banded kernel's tiles in the Pallas kernel's order and in
    # ascending order; the exact kernel's outward from the block's own tile
    "pallas_order": {"knn_banded.cu": [("outward(m, diag, ntiles)", PALLAS_ORDER)]},
    "ascending": {"knn_banded.cu": [("outward(m, diag, ntiles)", "m")]},
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
        "knn.cu": [("extern \"C\" {", COUNT_READ + "\nextern \"C\" {")],
        "knn_banded.cu": [("extern \"C\" {", COUNT_READ + "\nextern \"C\" {")],
        "ring_knn.cu": [("extern \"C\" {", COUNT_READ + "\nextern \"C\" {")],
    },
}
# variants whose graph must equal the first one's
EXACT = ("base", "unroll1", "pallas_order", "ascending", "outward", "nofilter", "bulk4", "bulk16",
         "nobulk", "select_rows", "count", "chunk1", "chunk2", "chunk4")
# kernel -> its source
SOURCES = {"exact": "knn", "banded": "knn_banded", "ring": "ring_knn"}


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
            lib.dgcnn_knn_topk_f32.argtypes = [vp] * 9 + [i] * 7 + [vp]
            lib.dgcnn_knn_topk_f32.restype = i
            lib.dgcnn_knn_slots.argtypes = [i, i, i]
            lib.dgcnn_knn_slots.restype = i
        elif src == "knn_banded":
            lib.dgcnn_knn_banded_f32.argtypes = [vp] * 8 + [i] * 9 + [vp]
            lib.dgcnn_knn_banded_f32.restype = i
        else:
            lib.dgcnn_ring_knn_step_f32.argtypes = [vp] * 6 + [i] * 6 + [vp]
            lib.dgcnn_ring_knn_step_f32.restype = i
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
    libs = build(names, [SOURCES[kn] for kn in kernels if kn in SOURCES])
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
    return 0


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
