#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dgcnn_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--profile]

Phases, each fatal on failure (nonzero exit, no result line):

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, both TF32 flags.
2. Build: the hand-written kernels ``dgcnn_tpu_torch/csrc/knn.cu``,
   ``csrc/knn_banded.cu`` and ``csrc/ring_knn.cu`` (all three with the
   shared headers ``csrc/knn_sweep.cuh`` and ``csrc/warp_topk.cuh``), one
   nvcc each, started together, timed, with ptxas's register and spill
   report for each kernel instantiation; a spill or a stack frame fails.
3. Exact kernel vs plain: the CUDA kNN against `knn_plain` at the serving
   path's shapes (B=4, N=4096, k=20, C in {4, 64}) on a ragged mask with
   duplicated rows, self and cross forms, with the key split S the card
   gives the launch: 0 hard mismatches, identical ``valid`` and 0
   tie-order violations required. The same on the all-equal input (every
   valid point one point), where every row must also hold exactly the k
   lowest valid indices. Times from CUDA events, each from the same
   ``(x, mask)``: the wrapper (operand build + kernel), the plain version
   and a library yardstick (operand build + matmul + ``torch.topk``, never
   called by the port); the kernel alone on prebuilt operands; the bound.
4. Banded kernel vs plain: the CUDA banded kNN against `knn_banded_plain`
   on ragged random inputs (B=4, N=16384, C in {4, 64}, 16384 / 9000 / 13
   / 0 valid points, window 1024 and N, duplicated rows), self form and a
   halo-shaped cross form (non-zero ``q_base`` and ``key_base``): 0 hard
   mismatches, identical ``valid``, 0 tie-order violations. The same on
   the all-equal input (every valid point one point, so every score
   ties), where every row must also hold exactly its lowest in-band
   indices: the kernel visits the diagonal tile before lower-index tiles,
   so only its (score, index) order gives them.
5. Serving path: ``Trainval.inference`` of the full-width residual-dgcnn
   (6 x 64, k=20, head 1024 -> 512 -> 256) on seeded random weights over
   fixed 4 x 4096 and variable-length `SyntheticIO` batches. The exact kNN
   launch count must rise by exactly 6 per batch; outputs must be finite
   and well formed; a small model on the card must agree with the same
   model on the CPU (plain oracle graph build). The kernel is checked and
   timed on the six graph-build inputs of one served forward, per shape
   (C=4, C=64) and over the six.
6. Long-event serving: the same model with ``knn_window=8192`` on three
   1,048,576-point events (two full, one variable-length padded to N). Per
   event the banded kernel must launch exactly 6 times, the exact kernel
   never, and the streamed head once. The six graph-build inputs of one
   forward are captured and the banded kernel is checked and timed on
   each against `knn_banded_plain`, with its bound and a library
   yardstick (a strip loop of matmul + band mask + ``torch.topk``: no one
   PyTorch call computes a banded top-k); per-launch means by shape (C=4,
   C=64) and over the six.
7. Window >= N: on one 4 x 4096 batch the banded model with
   ``knn_window=4096`` gives the exact model's predictions, its first
   graph is the exact graph up to exact ties, and its logits are within
   5e-2 of the exact model's.
8. A small banded model (W=256, streamed head in several chunks) on the
   card against the same model on the CPU (banded oracle).
9. Ring kernel vs plain, one process: ``csrc/ring_knn.cu`` (one launch a
   ring step) for P=4 virtual owners, each rank's blocks in the order it
   sees them, on ragged random inputs (B=2, 4 x 4096 points, C in {4,
   64}; one event full, one with 13 valid points across the shards; exact
   duplicates in other shards): against ``step_plain`` 0 hard mismatches
   and identical ``valid``, 0 tie-order violations, and all ranks
   together equal to `knn_cuda` on the whole event, index for index. The
   same on the all-equal input, where every query must also hold exactly
   the k lowest valid global indices (every rank after the first meets
   them in a later block than its own).
10. Context-parallel serving: `run_point_ranks` starts 4 ranks (NCCL with
   a card each, else gloo on one card with host-staged transfers; the
   line names the backend and the devices); each builds
   ``Trainval(point_shards=4, ring_impl="rdma")`` of the full-width
   residual-dgcnn with rank 0's seeded weights, and serves two full
   131,072-point events and one variable-length event padded to 131,072.
   Per event and rank: exactly 24 ring launches and no exact or banded
   one; the packed outputs identical on all ranks, finite and well
   formed. Ms per event, valid points/s, each rank's forward device time
   and peak memory.
11. CP vs one device: the same weights and first event through the
   single-device exact model: the first block's graph identical, scores
   within 1e-4, predictions identical where the top-two logit margin
   exceeds 1e-4 (the others counted), and ``ring_impl="ppermute"`` the
   same first graph as ``"rdma"``.
12. The ring kernel on the six graph-build inputs of that single-device
   forward, split into 4 virtual owners: every rank's merges, all ranks
   equal to the exact kernel's graph of the input, rank 0 against the
   plain version; per-launch times of the wrapper's work, the kernel
   alone, the plain version and a library yardstick (matmul +
   ``torch.topk`` + sort merge, never called by the port), and the bound;
   per-launch means by shape (C=4, C=64) and over the six.
13. Any width and k: all three kernels at C=256 (past one shared-memory
   pass: the sweep stages channels in chunks) and k=96 (two passes of at
   most 64 entries, the second behind each row's ceiling) against their
   plain versions on the phase-3, -4 and -9 inputs and their all-equal
   forms: 0 hard mismatches, identical ``valid``, 0 tie-order violations,
   the lowest indices on the all-equal inputs, the ring equal to the exact
   kernel; wrapper and plain times at these shapes.
14. Train step: `Trainval.train_step` of the same full-width model on one
   fixed-length 16,384-point `SyntheticIO` event with Adam at 1e-3, the
   same batch every step (``bench.py``'s workload): 2 warm-up and 20 timed
   steps, exactly 6 exact-kernel launches a step (the counts set to 0
   before the steps and read after), a finite loss that falls over the
   timed steps, ms a step by CUDA events and by the synchronized host
   clock, points/s and peak memory; the same init and batch for 10 steps
   through the kernel's plain version `knn_plain` (step-1 loss within 1e-5
   relative) and through the oracle of ``use_pallas=False`` (within 1e-3:
   another distance expression), both within 1e-2 at step 10 (the
   backward's atomics and Adam, see `phase_train`); the kernel checked
   against `knn_plain` on step 1's six graph-build inputs and timed there
   per shape (C=4, C=64) with its bound and library yardstick.
   ``--profile`` adds a profiler table of one train step, its device time
   and the idle share of a timed step.
15. The command line on the card, in a directory under ``build/``:
   ``python3 -m dgcnn_tpu_torch info`` and ``python3 -m
   dgcnn_tpu_torch.io.convert synth`` (24 fixed-length 16,384-point events
   into a DGB file, 8 into a validation npz) as subprocesses; then
   ``cli.main`` in this process trains the same full-width model from the
   DGB file (``-mb 1 -np 16384``, 20 steps, reports at 5, 10, 15, 20 with
   2 validation batches each, checkpoints at 10 and 20): the native DGB
   reader must assemble every batch, the exact kernel launch exactly 6
   times a step and a validation batch (the counts set to 0 before and
   read after), the banded and ring kernels never; the CSV log must have
   the JAX package's columns, rows at 5, 10, 15, 20 with finite losses and
   ``val_*`` values, and both checkpoints must exist. The last checkpoint
   restored and saved again gives the same bytes. ``--auto_resume -i 30``
   restores at step 20 and adds rows 25 and 30 and a step-30 checkpoint.
   ``inference -mb 4`` writes all 24 events into an npz with per-point
   predictions and scores (6 launches a batch), which must equal an
   in-process `Trainval.restore_for_eval` + `Trainval.inference` over the
   same batches. One ``python3 -m dgcnn_tpu_torch train ... -i 2``
   subprocess on the card must exit 0. Printed: ms a step through the
   loop against phase 14's direct step, ms to assemble a native DGB batch,
   checkpoint save and restore ms, served points/s through the command
   line against phase 5's. Phase 15's runs pass ``-nd 1``: one process on
   a machine with any number of cards.

16. Data parallelism on every visible card (two ranks sharing the one
   card of a one-card machine: gloo, transfers staged through pinned host
   memory; NCCL with a card a rank): the full-width model, one
   16,384-point event a rank. From one init, 3 SGD steps at dropout 0 on
   ``run_ranks`` against one rank on the card with the same global
   batches, run again and on the batches' rows reversed, all on the
   graphs the exact kernel built in the first one-rank run (replayed, so
   no near tie flips between the runs): the step-1 loss within 1e-5
   relative; the parameters after 3 steps, by the L2 distance over every
   parameter relative to the steps' update, within max(10 x the one-rank
   runs' spread, 5%), and identical on every rank.
   Then Adam, 2 warm-up + 10 timed steps: ms a step (rank 0's host clock
   and CUDA events), global points/s, peak memory a rank, the collectives
   a step (one gradient all-reduce, 9 BN statistic collectives forward
   and 9 backward), the gradient all-reduce alone timed with its bytes;
   exactly 6 exact-kernel launches a step on every rank (the counts set
   to 0 before the first step and read after the last). Ranks that share
   a card share its SMs: that time is not a multi-card speed. The
   command line on phase 15's DGB file: ``train -nd N`` (10 steps, a
   report at 5 and 10, a checkpoint at 10), ``--auto_resume`` to 14, one
   log file and no duplicated row (rank 0 writes alone), and
   ``inference -nd N`` from the checkpoint, every event written once,
   equal to one process's `Trainval.inference` on each rank's rows (0
   differing predictions, scores within 1e-6). ``--profile`` adds rank
   0's profiler table of one step, its device time and idle share.

The line before the last is the ``{"kernels": [...]}`` JSON (every entry
with its per-shape times; the exact kernel's ``launches`` counts its
main paths, serving in phase 5, training in phase 14, the command line
in phase 15 and data-parallel training in phase 16, split in
``launches_by_path``, and ``train_shape_ms`` holds its times at the train
shape); the last line
is ``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this script, it exits nonzero and prints no result.
``--profile`` adds torch.profiler tables of one served 4 x 4096 batch, of
one long-event forward, of rank 0's CP forward and of one train step.
``--cp-only`` runs
phases 1, 2, 10 and 11 alone and prints no kernels line: the check of the
CP path on a machine with a card for each rank (NCCL). ``--dp-only`` runs
phases 1, 2 and 16 alone (its own DGB file), no kernels line: data
parallelism over every card of a machine with several (NCCL).
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# published peaks of one H100 SXM at 700 W (NVIDIA data sheet): fp32 on the
# CUDA cores (FMA counted as two operations) and HBM3 bandwidth
FP32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

B, N, K = 4, 4096, 20
EDGE_WIDTH, EDGE_BLOCKS = 64, 6
# the long-event path: one event of 2**20 points, a band of 8192
LONG_N, LONG_W = 1_048_576, 8192
# the banded kernel's ragged random inputs
RAGGED_N, RAGGED_NVALID = 16_384, (16_384, 9000, 13, 0)
# context parallelism: events of 2**17 points over 4 point shards; the
# ring kernel's ragged random inputs are 2 events of 4 x 4096 points
CP_N, CP_P = 131_072, 4
RING_B, RING_NL = 2, 4096
# any width and k: C past one shared-memory pass of the sweep (C + 2 > 180
# sweeps the channels in chunks) and k past one list pass (64 entries)
WIDE_C, WIDE_K = 256, 96
# the train step: bench.py's workload, one event of 16384 points, Adam at
# 1e-3; warm-up steps, timed steps, and the steps held against the plain
# graph build (with the loss tolerance after them, see phase_train)
TRAIN_N, TRAIN_WARMUP, TRAIN_STEPS, TRAIN_PLAIN_STEPS = 16_384, 2, 20, 10
TRAIN_ORACLE_RTOL, TRAIN_LOSS_RTOL = 1e-3, 1e-2
# the command line (phase 15): events in the DGB file and in the
# validation file, train steps, report and checkpoint cadence, validation
# batches a report, the step the resumed run goes to, the served batch
CLI_EVENTS, CLI_VAL_EVENTS, CLI_STEPS, CLI_REPORT, CLI_CKPT = 24, 8, 20, 5, 10
CLI_VAL_BATCHES, CLI_RESUME_TO, CLI_SERVE_B = 2, 30, 4
CSV_COLUMNS = ["iter", "epoch", "acc", "class_acc0", "class_acc1", "loss", "lr", "val_loss",
               "val_acc", "val_miou", "titer"]
# data parallelism (phase 16): SGD parity steps and their rate, Adam
# warm-up and timed steps, repeats of the timed gradient all-reduce; the
# step-1 loss limit, and the parameter limit after the parity steps, as
# the L2 distance over every parameter relative to the steps' update: the
# spread of one-rank runs (the same run again, and on the batches' rows
# reversed) times DP_SPREAD_FACTOR, at least DP_UPDATE_SHARE (a lost or
# doubled gradient share moves the parameters by half or all of the
# update; a leaf the loss barely sees, whose gradient is rounding noise,
# or a neighbour max whose winner a last bit flips, by far less);
# train-mode BN layers
# of the model (6 blocks, the head's feature conv, 2 MLP layers); the
# command line's steps and resume target
DP_PARITY_STEPS, DP_SGD_LR, DP_WARMUP, DP_STEPS, DP_ALLREDUCE_REPS = 3, 1e-2, 2, 10, 20
DP_LOSS_RTOL, DP_SPREAD_FACTOR, DP_UPDATE_SHARE, DP_BN_LAYERS = 1e-5, 10.0, 0.05, 9
DP_CLI_STEPS, DP_CLI_RESUME_TO = 10, 14
# the times each kernel's per-launch record holds
TIME_KEYS = ("wrapper_ms", "kernel_ms", "plain_ms", "library_ms", "bound_ms")


def log(msg: str = "") -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_once(torch, fn):
    """``(fn(), device ms)`` of one call, from CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ragged_inputs(seed: int, c: int):
    """B events: one full, ~2500 valid, 13 valid (fewer than k), none;
    with duplicated rows in every event."""
    n = N
    rng = np.random.RandomState(seed + c)
    x = rng.randn(B, n, c).astype(np.float32)
    for e in range(B):
        src = rng.choice(n, 64, replace=False)
        dst = rng.choice(n, 64, replace=False)
        x[e, dst] = x[e, src]
        x[e, 5] = x[e, 6]  # a duplicate inside the 13-valid prefix too
    nvalid = np.array([n, 2500, 13, 0])
    mask = np.arange(n)[None, :] < nvalid[:, None]
    return x, mask


def phase_kernel_vs_plain(torch, kmod, seed: int, smi: str) -> float:
    """Kernel vs plain on ragged random inputs at the main path's shapes,
    self and cross forms; returns the largest score difference."""
    dev = torch.device("cuda")
    err = 0.0
    for c in (4, EDGE_WIDTH):
        x, mask = ragged_inputs(seed, c)
        xt = torch.tensor(x, device=dev)
        mt = torch.tensor(mask, device=dev)
        err = max(err, check_knn(torch, kmod, f"random C={c} self", xt, xt, mt, x))
        # cross form, Nq != Nk: the first 1000 rows against all keys
        xq = xt[:, :1000].contiguous()
        err = max(err, check_knn(torch, kmod, f"random C={c} cross", xq, xt, mt,
                                 x[:, :1000], xk_np=x, cross=True))
        # every valid point one point: only the tie rule picks the keys
        xe_np = all_equal(x, mask)
        xe = torch.tensor(xe_np, device=dev)
        err = max(err, check_knn(torch, kmod, f"all-equal C={c} self", xe, xe, mt, xe_np, ties=True))
        err = max(err, check_knn(torch, kmod, f"all-equal C={c} cross", xe[:, :1000].contiguous(),
                                 xe, mt, xe_np[:, :1000], xk_np=xe_np, cross=True, ties=True))
        t = time_knn(torch, kmod, xt, mt)
        log(f"knn timing, random inputs B={B} N={N} C={c} k={K} [{smi}]: {fmt_times(t)}")
    return err


def library_knn(torch, kmod, x, mask):
    """The yardstick: the same augmented operands, one fp32 matmul and
    ``torch.topk`` (no tie rule). Never called by the port."""
    qa, ka = kmod.build_augmented_operands(x, x, mask)
    return torch.topk(torch.matmul(qa, ka.transpose(-1, -2)), K, dim=-1)


def time_knn(torch, kmod, x, mask) -> dict:
    """CUDA-event times on one input ``(x, mask)`` of the wrapper (operand
    build + kernel), the plain version and the library yardstick, all from
    ``(x, mask)``; of the kernel alone on prebuilt operands; and the bound
    of the function ``(x, mask) -> (idx, valid)`` on this input."""
    b, n, c = x.shape
    qa, ka = kmod.build_augmented_operands(x, x, mask)
    out = {
        "wrapper_ms": cuda_ms(torch, lambda: kmod.knn_cuda(x, K, mask)),
        "kernel_ms": cuda_ms(torch, lambda: kmod.launch_operands(qa, ka, K)),
        "plain_ms": cuda_ms(torch, lambda: kmod.knn_plain(x, x, K, mask), reps=5),
        "library_ms": cuda_ms(torch, lambda: library_knn(torch, kmod, x, mask), reps=5),
    }
    # what this input needs: every query against every valid key (a masked
    # key can be skipped), C FMAs (2 operations each), one subtract of the
    # key's norm and one compare a pair; the norms of the valid keys and
    # the query scaling once each
    valid_keys = int(mask.sum())
    pairs = n * valid_keys
    ops = pairs * (2 * c + 2) + valid_keys * 2 * c + b * n * c
    # x and the mask read once, idx (int32) and valid (bool) written once
    bytes_moved = 4 * x.numel() + mask.numel() + b * n * K * (4 + 1)
    ops_ms = ops / FP32_PEAK_FLOPS * 1e3
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    out["bound_ms"] = max(ops_ms, bytes_ms)
    out["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    return out


def fmt_times(t: dict) -> str:
    return (f"wrapper_ms={t['wrapper_ms']:.4f} kernel_only_ms={t['kernel_ms']:.4f} "
            f"plain_ms={t['plain_ms']:.4f} library_ms(matmul+topk)={t['library_ms']:.4f} "
            f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}; fp32 peak "
            f"{FP32_PEAK_FLOPS:.3g} FLOP/s, HBM {HBM_BYTES_PER_S:.3g} B/s, H100 SXM data sheet) "
            f"roofline_share={t['bound_ms'] / t['wrapper_ms']:.3f}")


def check_knn(torch, kmod, label, xq, xk, mk, x_np, xk_np=None, cross=False, ties=False,
              k: int = K) -> float:
    """Kernel vs knn_plain on one input: identical valid flags, 0 hard
    mismatches, duplicates in index order; with ``ties`` (an `all_equal`
    input) every row exactly at `lowest_valid`. Logs the key split S the
    launch took. Returns max |score diff|."""
    from dgcnn_tpu_torch.ops.knn import split_mismatches, tie_order_violations

    if cross:
        got = kmod.knn_cuda_cross(xq, xk, k, mk)
    else:
        got = kmod.knn_cuda(xq, k, mk, return_scores=True)
    ref = kmod.knn_plain(xq, xk, k, mk)
    torch.cuda.synchronize()
    gi, gv, gs = (t.cpu().numpy() for t in got)
    ri, rv, rs = (t.cpu().numpy() for t in ref)
    if not np.array_equal(gv, rv):
        raise AssertionError(f"{label}: valid flags differ in {(gv != rv).sum()} slots")
    hard, near = split_mismatches(x_np, gi, ri, gv, rv, xk=xk_np)
    swapped = tie_order_violations(x_np if xk_np is None else xk_np, gi, gv)
    err = float(np.max(np.abs(gs[gv] - rs[rv]))) if gv.any() else 0.0
    missed, note = 0, ""
    if ties:
        wi, wv = (a[:, :xq.shape[1]] for a in lowest_valid(mk.cpu().numpy(), k))
        missed = int((gv != wv).sum() + (np.where(wv, gi, 0) != np.where(wv, wi, 0)).sum())
        note = f", slots off the lowest valid indices={missed}"
    splits = kmod.choose_splits(xq.shape[0], xq.shape[1], xk.shape[1], xq.shape[2] + 2, k,
                                xq.device)
    log(f"knn {label} Nq={xq.shape[1]} Nk={xk.shape[1]} k={k} (key split S={splits}): hard={hard} "
        f"near_ties={near} of {gi.size} slots, duplicate keys out of index order={swapped}"
        f"{note}, max|score diff| on valid slots={err:.3e}")
    if hard or swapped or missed:
        raise AssertionError(f"{label}: {hard} hard mismatches against knn_plain, "
                             f"{swapped} tie-order violations, {missed} slots off the lowest "
                             f"valid indices")
    return err


def serving_batches(cfg, seed: int):
    """Three fixed-length batches and one variable-length batch padded to
    the same size."""
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO

    b, n = cfg.minibatch_size, cfg.num_point
    fixed = SyntheticIO(num_events=3 * b, num_point=n, seed=seed, variable_length=False)
    fixed.initialize()
    out = list(BucketBatcher(fixed, b, num_point=n, shuffle=False).epoch())
    var = SyntheticIO(num_events=b, num_point=n, seed=seed + 1, variable_length=True)
    var.initialize()
    out += list(BucketBatcher(var, b, buckets=(1024, n), shuffle=False).epoch())
    return out


def check_outputs(torch, scores, pred, metrics, batch, num_class: int):
    s = scores.float()
    if not bool(torch.isfinite(s).all()):
        raise AssertionError("non-finite scores")
    if float((s.sum(-1) - 1.0).abs().max()) > 1e-5:
        raise AssertionError("scores do not sum to 1")
    if int(pred.min()) < 0 or int(pred.max()) >= num_class:
        raise AssertionError("prediction out of range")
    for key in ("loss", "loss_weight", "confusion"):
        if not bool(torch.isfinite(metrics[key]).all()):
            raise AssertionError(f"non-finite {key}")
    if float(metrics["confusion"].sum()) != float(batch.mask.sum()):
        raise AssertionError("confusion matrix does not count every valid point once")


def phase_serving(torch, kmod, seed: int, smi: str, profile: bool):
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.train.trainval import Trainval

    cfg = Config(
        model_name="residual-dgcnn", num_class=2, kvalue=K,
        edge_filters=(EDGE_WIDTH,) * EDGE_BLOCKS, minibatch_size=B, num_point=N,
    )
    tv = Trainval(cfg)
    state = tv.initialize(4, generator=torch.Generator().manual_seed(seed))
    batches = serving_batches(cfg, seed)
    log(f"serving: residual-dgcnn edge_filters={cfg.edge_filters} k={K} head "
        f"{cfg.head_feat_dim}->{'->'.join(map(str, cfg.head_mlp))}, {len(batches)} batches "
        f"of {B}x{N} (last variable-length, valid points {[int(b.mask.sum()) for b in batches]})")

    kmod.launches = 0
    for i, batch in enumerate(batches):
        before = kmod.launches
        scores, pred, metrics = tv.inference(state, batch)
        torch.cuda.synchronize()
        rose = kmod.launches - before
        if rose != EDGE_BLOCKS:
            raise AssertionError(f"batch {i}: kNN kernel launched {rose} times, want {EDGE_BLOCKS}")
        check_outputs(torch, scores, pred, metrics, batch, cfg.num_class)
        log(f"batch {i}: knn launches +{rose}, loss={float(metrics['loss']):.6f}, "
            f"confusion={metrics['confusion'].cpu().numpy().astype(int).tolist()}")
    main_launches = kmod.launches
    log(f"main path: {main_launches} kNN kernel launches over {len(batches)} batches")
    per_launch = kernel_on_main_path_inputs(torch, kmod, tv, state, batches[0], smi)

    # time the served batches: host clock around inference + host copy
    fixed = batches[:-1]
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for batch in fixed:
            scores, pred, _ = tv.inference(state, batch)
            scores.cpu(), pred.cpu()
    dt = (time.perf_counter() - t0) / (reps * len(fixed))
    pts = sum(int(b.mask.sum()) for b in fixed) / len(fixed)
    serve_pps = pts / dt
    log(f"serving time [{smi}]: {dt * 1e3:.3f} ms/batch, {serve_pps:.1f} points/s "
        f"(B={B} N={N}, {reps * len(fixed)} batches, host clock incl. copy to host)")

    # the same batch through the plain oracle graph build on the card
    plain = Trainval(dataclasses.replace(cfg, use_pallas=False))
    batch = batches[0]
    points = torch.tensor(batch.points, device="cuda")
    mask = torch.tensor(batch.mask, device="cuda")
    with torch.inference_mode():
        lk, _ = tv.model(state.params, state.model_state, points, mask)
        lp, _ = plain.model(state.params, state.model_state, points, mask)
        fwd_kernel = cuda_ms(torch, lambda: tv.model(state.params, state.model_state, points, mask), reps=5)
        fwd_plain = cuda_ms(torch, lambda: plain.model(state.params, state.model_state, points, mask), reps=5)
    m = mask.bool()
    diff = float((lk - lp).abs()[m].max())
    flips = float((lk.argmax(-1) != lp.argmax(-1))[m].float().mean())
    log(f"kernel vs --no_pallas forward on the card: max|logit diff|={diff:.3e}, "
        f"share of points with another prediction={flips:.3e}")
    log(f"forward device time [{smi}]: kernel graph build {fwd_kernel:.3f} ms, "
        f"plain oracle graph build {fwd_plain:.3f} ms (CUDA events)")
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.inference_mode():
                tv.model(state.params, state.model_state, points, mask)
            torch.cuda.synchronize()
        log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20))
    return main_launches, per_launch, serve_pps


def kernel_on_main_path_inputs(torch, kmod, tv, state, batch, smi: str):
    """Capture the six graph-build inputs of one served forward, then check
    the kernel against knn_plain on each and time both there."""
    captured = []

    def recording(x, k, mask):
        captured.append((x.clone(), mask.clone()))
        return kmod.knn_cuda(x, k, mask)

    points = torch.tensor(batch.points, device="cuda")
    mask = torch.tensor(batch.mask, device="cuda")
    tv.model.knn_fn = recording
    with torch.inference_mode():
        tv.model(state.params, state.model_state, points, mask)
    tv.model.knn_fn = kmod.knn_cuda
    out = []
    for i, (x, m) in enumerate(captured):
        err = check_knn(torch, kmod, f"main path block {i} C={x.shape[-1]}", x, x, m,
                        x.cpu().numpy())
        t = time_knn(torch, kmod, x, m)
        t["max_abs_err"] = err
        t["c"] = x.shape[2]
        # the selection's cost depends on the order keys arrive in: the
        # same rows in a random order, for comparison
        perm = torch.randperm(x.shape[1], generator=torch.Generator().manual_seed(i)).cuda()
        qa, ka = kmod.build_augmented_operands(x[:, perm], x[:, perm], m[:, perm])
        shuffled = cuda_ms(torch, lambda: kmod.launch_operands(qa, ka, K))
        log(f"knn timing, main path block {i} B={x.shape[0]} N={x.shape[1]} C={x.shape[2]} "
            f"k={K} [{smi}]: {fmt_times(t)}; kernel_ms with rows shuffled={shuffled:.4f}")
        out.append(t)
    total = {key: sum(t[key] for t in out) for key in TIME_KEYS}
    log(f"knn per forward (6 launches) [{smi}]: " + " ".join(f"{k}={v:.4f}" for k, v in total.items()))
    log_per_shape("knn", out, smi)
    return out


def phase_small_reference(torch, seed: int):
    """A small model on the card (kernel graph build) against the same
    model on the CPU (plain oracle): the port's own reference."""
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO
    from dgcnn_tpu_torch.train.trainval import Trainval

    cfg = Config(model_name="residual-dgcnn", num_class=3, kvalue=K, edge_filters=(16, 24, 24),
                 head_feat_dim=64, head_mlp=(32,), minibatch_size=2, num_point=512)
    io = SyntheticIO(num_events=2, num_point=512, num_class=3, seed=seed + 2)
    io.initialize()
    batch = next(iter(BucketBatcher(io, 2, buckets=(512,), shuffle=False).epoch()))
    gpu, cpu = Trainval(cfg), Trainval(cfg, device="cpu")
    state = cpu.initialize(4, generator=torch.Generator().manual_seed(seed))
    gstate = gpu.initialize(4, generator=torch.Generator().manual_seed(seed))
    pts = torch.tensor(batch.points)
    msk = torch.tensor(batch.mask)
    with torch.inference_mode():
        lc, _ = cpu.model(state.params, state.model_state, pts, msk)
        lg, _ = gpu.model(gstate.params, gstate.model_state, pts.cuda(), msk.cuda())
    d = (lg.cpu() - lc).abs()[msk]
    far = float((d > 1e-3).float().mean())
    log(f"small model card vs CPU: max|logit diff|={float(d.max()):.3e}, "
        f"share of valid points off by > 1e-3: {far:.3e}")
    if not bool(torch.isfinite(lg).all()) or far > 0.01:
        raise AssertionError("the card's forward disagrees with the CPU reference")


# ------------------------------------------------------------ banded kNN


def banded_ragged_inputs(seed: int, c: int):
    """B events of RAGGED_N points with RAGGED_NVALID valid, duplicated
    rows in every event (also inside the 13-valid prefix)."""
    n = RAGGED_N
    rng = np.random.RandomState(seed + 7 * c)
    x = rng.randn(B, n, c).astype(np.float32)
    for e in range(B):
        src = rng.choice(n, 256, replace=False)
        dst = rng.choice(n, 256, replace=False)
        x[e, dst] = x[e, src]
        x[e, 5] = x[e, 6]
    mask = np.arange(n)[None, :] < np.asarray(RAGGED_NVALID)[:, None]
    return x, mask


def all_equal(x, mask):
    """``x`` with every valid point of every event set to one point: every
    valid key then scores the same for every query, and the tie rule
    alone (lowest index first) picks the keys."""
    x = x.copy()
    x[mask] = x[0, 0]
    return x


def lowest_in_band(pos, nvalid, window: int, k: int = K):
    """``(idx, valid)`` that the tie rule alone gives when every valid key
    ties and the valid points come first: the k lowest valid positions of
    each row's band ``[lo, lo + window)``. ``pos`` (Nq,) global positions,
    ``nvalid`` (B,)."""
    lo = np.clip(pos[None, :] - window // 2, 0, np.maximum(nvalid - window, 0)[:, None])
    count = np.minimum(lo + window, nvalid[:, None]) - lo
    slot = np.arange(k)
    return lo[..., None] + slot, slot < count[..., None]


def check_banded(torch, bmod, label, xq, xk, mk, window, x_full, q_rows=None, band=None,
                 ties=False, k: int = K):
    """Banded kernel vs knn_banded_plain on one input: identical valid
    flags, 0 hard mismatches, duplicates in index order. ``band`` holds
    the cross form's ``q_base``, ``key_base`` and ``nvalid`` (None: self
    form); indices are global positions in ``x_full`` (numpy), whose rows
    ``q_rows`` are the queries (None: all). With ``ties`` (an `all_equal`
    input) every row must hold exactly `lowest_in_band`. Returns ``(max
    |score diff|, plain ms)``, the plain version's time from CUDA events
    around its one call."""
    from dgcnn_tpu_torch.ops.knn import split_mismatches, tie_order_violations

    if band is None:
        window = min(window, xq.shape[1])
        got = bmod.knn_banded_cuda(xq, k, mk, window=window, return_scores=True)
        band = dict(q_base=0, key_base=0, nvalid=None)
    else:
        got = bmod.knn_banded_cuda_cross(xq, xk, k, mk, window=window, **band)
    ref, plain_ms = cuda_once(
        torch, lambda: bmod.knn_banded_plain(xq, xk, k, mk, window=window, **band))
    gi, gv, gs = (t.cpu().numpy() for t in got)
    ri, rv, rs = (t.cpu().numpy() for t in ref)
    xq_np = x_full
    pos = np.arange(xq.shape[1])
    nvalid = mk.sum(-1).cpu().numpy() if band["nvalid"] is None else band["nvalid"].cpu().numpy()
    q_ok = True
    if q_rows is not None:
        xq_np = x_full[:, q_rows]
        pos = np.arange(q_rows.start, q_rows.stop)
        # the cross form's padded-query rows are garbage by contract
        q_ok = (pos[None, :] < nvalid[:, None])[..., None]
        gi, ri = np.where(q_ok, gi, 0), np.where(q_ok, ri, 0)
        gv, rv = gv & q_ok, rv & q_ok
    if not np.array_equal(gv, rv):
        raise AssertionError(f"{label}: valid flags differ in {(gv != rv).sum()} slots")
    hard, near = split_mismatches(xq_np, gi, ri, gv, rv, xk=x_full)
    swapped = tie_order_violations(x_full, gi, gv)
    err = float(np.max(np.abs(gs[gv] - rs[rv]))) if gv.any() else 0.0
    missed, note = 0, ""
    if ties:
        wi, wv = lowest_in_band(pos, nvalid, window, k)
        wv = wv & q_ok
        missed = int((gv != wv).sum() + (np.where(wv, gi, 0) != np.where(wv, wi, 0)).sum())
        note = f", slots off the lowest in-band indices={missed}"
    log(f"banded knn {label} Nq={xq.shape[1]} Nk={xk.shape[1]} W={window} k={k}: hard={hard} "
        f"near_ties={near} of {gi.size} slots ({int(gv.sum())} valid), duplicate keys out of "
        f"index order={swapped}{note}, max|score diff| on valid slots={err:.3e}")
    if hard or swapped or missed:
        raise AssertionError(f"{label}: {hard} hard mismatches against knn_banded_plain, "
                             f"{swapped} tie-order violations, {missed} slots off the lowest "
                             f"in-band indices")
    return err, plain_ms


def phase_banded_vs_plain(torch, bmod, seed: int) -> float:
    """The banded kernel against its plain version on ragged random
    inputs and on the same inputs with every valid point equal (all
    scores tie: each row must hold the lowest in-band indices, though the
    kernel visits the diagonal tile before lower-index tiles), self form
    and a halo-shaped cross form (the shard's rows plus the window each
    side); returns the largest score difference."""
    dev = torch.device("cuda")
    err = 0.0
    s0, s1 = RAGGED_N // 4, RAGGED_N // 2  # the cross form's query shard
    for c in (4, EDGE_WIDTH):
        x0, mask = banded_ragged_inputs(seed, c)
        mt = torch.tensor(mask, device=dev)
        nvalid = mt.sum(-1).to(torch.int32)
        for kind, x in (("random", x0), ("all-equal", all_equal(x0, mask))):
            xt = torch.tensor(x, device=dev)
            ties = kind == "all-equal"
            for w in (1024, RAGGED_N):
                err = max(err, check_banded(torch, bmod, f"{kind} C={c} self", xt, xt, mt, w, x,
                                            ties=ties)[0])
                kb, ke = max(s0 - w, 0), min(s1 + w, RAGGED_N)
                e, _ = check_banded(
                    torch, bmod, f"{kind} C={c} cross q_base={s0} key_base={kb}",
                    xt[:, s0:s1].contiguous(), xt[:, kb:ke].contiguous(),
                    mt[:, kb:ke].contiguous(), w, x, q_rows=slice(s0, s1),
                    band=dict(q_base=s0, key_base=kb, nvalid=nvalid), ties=ties)
                err = max(err, e)
    return err


def library_banded(torch, kmod, x, mask, window: int, strip: int = 2048):
    """The yardstick: from ``(x, mask)``, the augmented operands, then per
    strip of queries one matmul over the strip's key span, the band mask
    and ``torch.topk`` (no tie rule). No one PyTorch call computes a
    banded top-k; the port never calls this."""
    from dgcnn_tpu_torch.ops.knn import band_lo

    n = x.shape[1]
    w = min(window, n)
    qa, ka = kmod.build_augmented_operands(x, x, mask)
    nvalid = mask.sum(-1)
    span = min(strip + w, n)
    offs = torch.arange(span, device=x.device)
    out = []
    for r0 in range(0, n, strip):
        rows = torch.arange(r0, min(r0 + strip, n), device=x.device)
        lo = band_lo(rows[None, :], nvalid[:, None], w)
        cols = torch.clamp(lo[:, 0], 0, n - span)[:, None] + offs
        keys = torch.gather(ka, 1, cols[..., None].expand(-1, -1, ka.shape[-1]))
        s = torch.matmul(qa[:, r0 : r0 + strip], keys.transpose(-1, -2))
        g = cols[:, None, :]
        s = torch.where((g >= lo[..., None]) & (g < (lo + w)[..., None]), s, float("-inf"))
        out.append(torch.topk(s, K, dim=-1))
    return out


def banded_bound(torch, x, mask, window: int):
    """``(bound ms, bound_by, pairs)`` of the function ``(x, mask) ->
    (idx, valid)`` on this input: (2C + 2) fp32 operations per (valid
    query, in-band valid key) pair, counted from the band and the mask,
    plus the valid keys' norms and the query scaling, at the fp32 peak;
    against x and the mask read once and idx (int32) and valid (bool)
    written once, at the HBM rate."""
    from dgcnn_tpu_torch.ops.knn import band_lo

    b, n, c = x.shape
    w = min(window, n)
    m = mask.to(torch.int64)
    cs = torch.nn.functional.pad(m.cumsum(-1), (1, 0))  # valid keys before each position
    nv = m.sum(-1)
    lo = band_lo(torch.arange(n, device=x.device)[None, :], nv[:, None], w).expand(b, n)
    in_band = cs.gather(1, torch.clamp(lo + w, max=n)) - cs.gather(1, lo)
    pairs = int((in_band * m).sum())
    valid_keys = int(nv.sum())
    ops = pairs * (2 * c + 2) + valid_keys * 2 * c + b * n * c
    bytes_moved = 4 * x.numel() + mask.numel() + b * n * K * (4 + 1)
    ops_ms = ops / FP32_PEAK_FLOPS * 1e3
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), pairs


def long_events(seed: int):
    """Two fixed-length events of LONG_N points and one variable-length
    event padded to LONG_N, one event a batch."""
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO

    out = []
    for i, variable in enumerate((False, False, True)):
        io = SyntheticIO(num_events=1, num_point=LONG_N, seed=seed + 10 + i,
                         variable_length=variable)
        io.initialize()
        out += list(BucketBatcher(io, 1, num_point=LONG_N, shuffle=False).epoch())
    return out


def phase_long_events(torch, kmod, bmod, seed: int, smi: str, profile: bool):
    """Serve the residual-dgcnn with knn_window=8192 on 1M-point events
    through Trainval.inference; returns the banded launches of that run
    and the kernel's numbers on one forward's graph-build inputs."""
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.models import head as thead
    from dgcnn_tpu_torch.train.trainval import Trainval

    cfg = Config(
        model_name="residual-dgcnn", num_class=2, kvalue=K, edge_filters=(EDGE_WIDTH,) * EDGE_BLOCKS,
        head_feat_dim=1024, head_mlp=(512, 256), knn_window=LONG_W, minibatch_size=1,
        num_point=LONG_N,
    )
    tv = Trainval(cfg)
    state = tv.initialize(4, generator=torch.Generator().manual_seed(seed))
    t0 = time.perf_counter()
    events = long_events(seed)
    valid = [int(e.mask.sum()) for e in events]
    log(f"long events: residual-dgcnn edge_filters={cfg.edge_filters} k={K} knn_window={LONG_W} "
        f"head {cfg.head_feat_dim}->{'->'.join(map(str, cfg.head_mlp))}, {len(events)} events of "
        f"1x{LONG_N} (last variable-length), valid points {valid} (made on the host in "
        f"{time.perf_counter() - t0:.1f} s)")
    torch.cuda.reset_peak_memory_stats()

    kmod.launches = bmod.launches = thead.runs = 0
    for i, batch in enumerate(events):
        before = (bmod.launches, kmod.launches, thead.runs)
        scores, pred, metrics = tv.inference(state, batch)
        torch.cuda.synchronize()
        rose = (bmod.launches - before[0], kmod.launches - before[1], thead.runs - before[2])
        if rose != (EDGE_BLOCKS, 0, 1):
            raise AssertionError(f"event {i}: banded launches +{rose[0]}, exact launches "
                                 f"+{rose[1]}, streamed head runs +{rose[2]}; want +6, +0, +1")
        check_outputs(torch, scores, pred, metrics, batch, cfg.num_class)
        log(f"event {i}: banded knn launches +{rose[0]}, exact knn launches +{rose[1]}, streamed "
            f"head runs +{rose[2]}, loss={float(metrics['loss']):.6f}, "
            f"confusion={metrics['confusion'].cpu().numpy().astype(int).tolist()}")
    main_launches = bmod.launches
    log(f"long-event path: {main_launches} banded kNN launches, {kmod.launches} exact kNN "
        f"launches, {thead.runs} streamed head runs over {len(events)} events; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # host clock per event, inference + copy of the results to the host
    for i, batch in enumerate(events):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores, pred, _ = tv.inference(state, batch)
        scores.cpu(), pred.cpu()
        dt = time.perf_counter() - t0
        log(f"long-event serving time [{smi}]: event {i} {dt * 1e3:.3f} ms, "
            f"{valid[i] / dt:.1f} valid points/s (host clock incl. copy to host)")

    # forward device time, banded kernel vs the banded oracle (--no_pallas)
    batch = events[0]
    points = torch.tensor(batch.points, device="cuda")
    mask = torch.tensor(batch.mask, device="cuda")
    plain = Trainval(dataclasses.replace(cfg, use_pallas=False))
    with torch.inference_mode():
        fwd_kernel = cuda_ms(torch, lambda: tv.model(state.params, state.model_state, points, mask),
                             reps=2, warmup=1)
        lk, _ = tv.model(state.params, state.model_state, points, mask)
        (lp, _), fwd_plain = cuda_once(
            torch, lambda: plain.model(state.params, state.model_state, points, mask))
    m = mask.bool()
    diff = float((lk - lp).abs()[m].max())
    flips = float((lk.argmax(-1) != lp.argmax(-1))[m].float().mean())
    log(f"banded kernel vs --no_pallas (banded oracle) forward on the card: max|logit diff|="
        f"{diff:.3e}, share of points with another prediction={flips:.3e}")
    log(f"long-event forward device time [{smi}]: banded kernel graph build {fwd_kernel:.3f} ms, "
        f"banded oracle graph build {fwd_plain:.3f} ms (CUDA events)")
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.inference_mode():
                tv.model(state.params, state.model_state, points, mask)
            torch.cuda.synchronize()
        log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))
    return main_launches, banded_on_main_path_inputs(torch, kmod, bmod, tv, state, points, mask, smi)


def banded_on_main_path_inputs(torch, kmod, bmod, tv, state, points, mask, smi: str):
    """Capture the six graph-build inputs of one long-event forward, then
    check the banded kernel against knn_banded_plain on each and time the
    wrapper, the kernel alone, the plain version and the yardstick."""
    captured = []

    def recording(x, k, m):
        captured.append((x.clone(), m.clone()))
        return bmod.knn_banded_cuda(x, k, m, window=LONG_W)

    knn_fn = tv.model.knn_fn
    tv.model.knn_fn = recording
    with torch.inference_mode():
        tv.model(state.params, state.model_state, points, mask)
    tv.model.knn_fn = knn_fn
    out = []
    for i, (x, m) in enumerate(captured):
        err, plain_ms = check_banded(torch, bmod, f"long event block {i} C={x.shape[-1]}",
                                     x, x, m, LONG_W, x.cpu().numpy())
        qa, ka = kmod.build_augmented_operands(x, x, m)
        nvalid = m.sum(-1).to(torch.int32)
        t = {
            "wrapper_ms": cuda_ms(torch, lambda: bmod.knn_banded_cuda(x, K, m, window=LONG_W),
                                  reps=3, warmup=1),
            "kernel_ms": cuda_ms(
                torch, lambda: bmod.launch_operands(qa, ka, nvalid, K, window=LONG_W),
                reps=3, warmup=1),
            "plain_ms": plain_ms,
            "library_ms": cuda_once(torch, lambda: library_banded(torch, kmod, x, m, LONG_W))[1],
            "max_abs_err": err,
        }
        t["bound_ms"], t["bound_by"], pairs = banded_bound(torch, x, m, LONG_W)
        t["c"] = x.shape[2]
        log(f"banded knn timing, long event block {i} B={x.shape[0]} N={x.shape[1]} "
            f"C={x.shape[2]} k={K} W={LONG_W} ({pairs} valid in-band pairs) [{smi}]: "
            f"{fmt_times(t)} (library = strip loop of matmul + band mask + torch.topk)")
        out.append(t)
    total = {key: sum(t[key] for t in out) for key in TIME_KEYS}
    log(f"banded knn per long-event forward ({len(out)} launches) [{smi}]: "
        + " ".join(f"{k}={v:.4f}" for k, v in total.items()))
    log_per_shape("banded knn", out, smi)
    return out


def phase_full_window_is_exact(torch, kmod, bmod, seed: int):
    """One 4 x 4096 batch: the banded model with knn_window = N (banded
    kernel) against the exact model (exact kernel), same weights.

    Both kernels score a pair with the same FMA chain, so on the first
    block's input (the raw points) the banded graph, mapped back from
    Morton order, must be the exact graph up to exact ties: every row's
    selected scores bit for bit the same, the same valid flags. A tie
    between equal scores goes to the lower index, and the sort renumbers
    the points, so a tied k-th neighbour may change;
    from there the logits differ as the kernel's and the oracle's do
    (1.2e-2 on the exact path), so they are held within 5e-2, and the
    predictions must agree on every valid point."""
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.ops.sfc import morton_order
    from dgcnn_tpu_torch.train.trainval import Trainval

    cfg = Config(model_name="residual-dgcnn", num_class=2, kvalue=K,
                 edge_filters=(EDGE_WIDTH,) * EDGE_BLOCKS, minibatch_size=B, num_point=N)
    batch = serving_batches(cfg, seed)[0]
    exact = Trainval(cfg)
    banded = Trainval(dataclasses.replace(cfg, knn_window=N))
    state = exact.initialize(4, generator=torch.Generator().manual_seed(seed))
    points = torch.tensor(batch.points, device="cuda")
    mask = torch.tensor(batch.mask, device="cuda")
    with torch.inference_mode():
        le, _ = exact.model(state.params, state.model_state, points, mask)
        lb, _ = banded.model(state.params, state.model_state, points, mask)
        ie, ve, se = kmod.knn_cuda(points, K, mask, return_scores=True)
        order, pos = morton_order(points, mask)
        xs = torch.gather(points, 1, order[..., None].expand(points.shape)).contiguous()
        ib, vb, sb = bmod.knn_banded_cuda(xs, K, torch.gather(mask, 1, order), window=N,
                                          return_scores=True)
        # row j of the batch is row pos[j] in Morton order, and a sorted
        # position p is the batch's point order[p]
        rows = pos[..., None].expand(ib.shape)
        ib = torch.gather(order, 1, torch.gather(ib, 1, rows).long().reshape(B, -1)).reshape(ib.shape)
        vb, sb = torch.gather(vb, 1, rows), torch.gather(sb, 1, rows)
    same_scores = bool(torch.equal(se, sb)) and bool(torch.equal(ve, vb))
    ties = int((ie != ib).sum())
    m = mask.bool()
    diff = float((le - lb).abs()[m].max())
    flips = int((le.argmax(-1) != lb.argmax(-1))[m].sum())
    log(f"knn_window=N={N} vs exact model on the card: first block's graph, selected scores "
        f"and valid flags identical={same_scores}, {ties} of {ie.numel()} slots hold another "
        f"key of an equal score; max|logit diff|={diff:.3e}, points with another "
        f"prediction={flips} of {int(m.sum())}")
    if not same_scores or flips or diff > 5e-2:
        raise AssertionError("the full-window banded model disagrees with the exact model")


def phase_small_banded_reference(torch, seed: int):
    """A small banded model on the card (banded kernel, streamed head in
    several chunks) against the same model on the CPU (banded oracle)."""
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO
    from dgcnn_tpu_torch.models import head as thead
    from dgcnn_tpu_torch.train.trainval import Trainval

    n = 2048
    cfg = Config(model_name="residual-dgcnn", num_class=3, kvalue=K, edge_filters=(16, 24, 24),
                 head_feat_dim=64, head_mlp=(32,), minibatch_size=2, num_point=n,
                 knn_window=256, head_stream="on")
    io = SyntheticIO(num_events=2, num_point=n, num_class=3, seed=seed + 3)
    io.initialize()
    batch = next(iter(BucketBatcher(io, 2, num_point=n, shuffle=False).epoch()))
    gpu, cpu = Trainval(cfg), Trainval(cfg, device="cpu")
    state = cpu.initialize(4, generator=torch.Generator().manual_seed(seed))
    gstate = gpu.initialize(4, generator=torch.Generator().manual_seed(seed))
    pts, msk = torch.tensor(batch.points), torch.tensor(batch.mask)
    target = thead.HEAD_CHUNK_TARGET_ELEMS
    thead.HEAD_CHUNK_TARGET_ELEMS = 2 * 64 * 256  # chunks of 256 rows, 8 a forward
    runs = thead.runs
    with torch.inference_mode():
        lc, _ = cpu.model(state.params, state.model_state, pts, msk)
        lg, _ = gpu.model(gstate.params, gstate.model_state, pts.cuda(), msk.cuda())
    thead.HEAD_CHUNK_TARGET_ELEMS = target
    d = (lg.cpu() - lc).abs()[msk]
    far = float((d > 1e-3).float().mean())
    log(f"small banded model (W=256, streamed head in 8 chunks) card vs CPU: max|logit diff|="
        f"{float(d.max()):.3e}, share of valid points off by > 1e-3: {far:.3e}")
    if thead.runs != runs + 2:
        raise AssertionError("the streamed head did not serve the small banded model")
    if not bool(torch.isfinite(lg).all()) or far > 0.01:
        raise AssertionError("the card's banded forward disagrees with the CPU reference")


# --------------------------------------------- ring kNN, context parallelism


def ring_ragged_inputs(seed: int, c: int):
    """RING_B events of CP_P * RING_NL points: one full; one with 13 valid
    points (fewer than k) spread over the shards; exact duplicate rows in
    other shards than their originals, so ties cross blocks."""
    n = CP_P * RING_NL
    rng = np.random.RandomState(seed + 11 * c)
    x = rng.randn(RING_B, n, c).astype(np.float32)
    src = rng.choice(RING_NL, 64, replace=False)
    for o in range(1, CP_P):
        x[0, o * RING_NL + src] = x[0, src]
    valid = [o * RING_NL + j for o in range(CP_P) for j in range(3)] + [5]
    x[1, 2 * RING_NL + 1] = x[1, 1]  # a valid pair in two shards
    x[1, 5] = x[1, RING_NL]
    mask = np.zeros((RING_B, n), bool)
    mask[0] = True
    mask[1, valid] = True
    return x, mask


def ring_rank_blocks(qa, ka, me: int, p: int):
    """Rank ``me``'s queries and the key blocks in the order it sees them
    on the ring, cut from operands built once for the whole event."""
    nl = qa.shape[1] // p
    blocks = [(ka[:, o * nl:(o + 1) * nl].contiguous(), o * nl)
              for o in ((me - s) % p for s in range(p))]
    return qa[:, me * nl:(me + 1) * nl].contiguous(), blocks


def lowest_valid(mask, k: int = K):
    """``(idx, valid)`` that the tie rule alone gives when every valid key
    of an event ties: the k lowest valid global indices, for every
    query."""
    b, n = mask.shape
    idx = np.zeros((b, n, k), np.int64)
    valid = np.zeros((b, n, k), bool)
    for e in range(b):
        first = np.nonzero(mask[e])[0][:k]
        idx[e, :, :first.size] = first
        valid[e, :, :first.size] = True
    return idx, valid


def check_ring(torch, kmod, rmod, label, x, mask, exact, plain_ranks, ties=False,
               k: int = K) -> float:
    """The ring kernel for every rank's order of P = CP_P virtual owners:
    against its plain version (``step_plain``) for the ranks in
    ``plain_ranks`` (identical valid flags, 0 hard mismatches), with 0
    tie-order violations, and all ranks together against ``exact`` (the
    exact kernel's graph of the whole event), index for index. With
    ``ties`` (an `all_equal` input) every query must hold exactly
    `lowest_valid`: every rank after the first meets its own indices
    before the lower ones of later blocks. Returns the largest score
    difference against the plain version."""
    from dgcnn_tpu_torch.ops.knn import split_mismatches, tie_order_violations

    p, n = CP_P, x.shape[1]
    nl = n // p
    qa, ka = kmod.build_augmented_operands(x, x, mask)
    x_np = x.cpu().numpy()
    err, hard, near, swapped, idx, valid = 0.0, 0, 0, 0, [], []
    for me in range(p):
        q, blocks = ring_rank_blocks(qa, ka, me, p)
        gi, gv, gs = rmod.merge_blocks(q, blocks, k, me * nl, rmod.launch_step, return_scores=True)
        gi, gv, gs = (t.cpu().numpy() for t in (gi, gv, gs))
        swapped += tie_order_violations(x_np, gi, gv)
        idx.append(gi)
        valid.append(gv)
        if me not in plain_ranks:
            continue
        ri, rv, rs = (t.cpu().numpy() for t in rmod.merge_blocks(
            q, blocks, k, me * nl, rmod.step_plain, return_scores=True))
        if not np.array_equal(gv, rv):
            raise AssertionError(f"{label} rank {me}: valid flags differ in {(gv != rv).sum()} slots")
        h, nt = split_mismatches(x_np[:, me * nl:(me + 1) * nl], gi, ri, gv, rv, xk=x_np)
        hard, near = hard + h, near + nt
        if gv.any():
            err = max(err, float(np.max(np.abs(gs[gv] - rs[rv]))))
    ei, ev = (t.cpu().numpy() for t in exact)
    gi, gv = np.concatenate(idx, 1), np.concatenate(valid, 1)
    same = np.array_equal(gi, ei) and np.array_equal(gv, ev)
    missed, note = 0, ""
    if ties:
        wi, wv = lowest_valid(mask.cpu().numpy(), k)
        missed = int((gv != wv).sum() + (np.where(wv, gi, 0) != np.where(wv, wi, 0)).sum())
        note = f"; slots off the lowest valid indices={missed}"
    log(f"ring knn {label} B={x.shape[0]} N={n} P={p} C={x.shape[2]} k={k}: vs plain (ranks "
        f"{list(plain_ranks)}) hard={hard} near_ties={near}, max|score diff| on valid slots="
        f"{err:.3e}; duplicate keys out of index order={swapped}{note}; all ranks == exact kernel "
        f"on the whole event: {same} ({int((gi != ei).sum())} slots differ, {int(gv.sum())} valid)")
    if hard or swapped or missed or not same:
        raise AssertionError(f"{label}: {hard} hard mismatches, {swapped} tie-order violations, "
                             f"{missed} slots off the lowest valid indices, equal to the exact "
                             f"kernel: {same}")
    return err


def library_ring(torch, kmod, xs, ms, blocks):
    """The yardstick: from the rank's shard, its operands, then per block
    one matmul, ``torch.topk`` and a sort-based merge of the running list
    (no tie rule). Never called by the port."""
    qa, _ = kmod.build_augmented_operands(xs, xs, ms)
    topv = torch.full(qa.shape[:2] + (K,), float("-inf"), device=qa.device)
    topi = torch.zeros(qa.shape[:2] + (K,), dtype=torch.long, device=qa.device)
    for ka, base in blocks:
        v, i = torch.topk(torch.matmul(qa, ka.transpose(-1, -2)), K, dim=-1)
        sv, order = torch.sort(torch.cat([topv, v], -1), dim=-1, descending=True)
        topv = sv[..., :K]
        topi = torch.gather(torch.cat([topi, i + base], -1), -1, order)[..., :K]
    return topv, topi


def time_ring(torch, kmod, rmod, x, mask) -> dict:
    """Per-launch CUDA-event times of rank 0's ring on one input: the
    wrapper's work (operand build of the shard, the P merges, the finish;
    the other owners' blocks prebuilt, as transport hands them over), the
    kernel alone, the plain version and the library yardstick, each
    divided by P; and the bound per launch from this input's valid keys."""
    p, (b, n, c) = CP_P, x.shape
    nl = n // p
    qa, ka = kmod.build_augmented_operands(x, x, mask)
    q, blocks = ring_rank_blocks(qa, ka, 0, p)
    xs, ms = x[:, :nl].contiguous(), mask[:, :nl].contiguous()

    def wrapper():
        qs, _ = kmod.build_augmented_operands(xs, xs, ms)
        return rmod.merge_blocks(qs, blocks, K, 0, rmod.launch_step)

    def kernel_alone(topv, topi):
        for kb, base in blocks:
            rmod.launch_step(q, kb, base, topv, topi)

    t = {
        "wrapper_ms": cuda_ms(torch, wrapper, reps=3, warmup=1) / p,
        # fresh running lists each time: a full list would raise every floor
        "kernel_ms": cuda_ms(torch, lambda: kernel_alone(*rmod.init_running(b, nl, K, x.device)),
                             reps=3, warmup=1) / p,
        "plain_ms": cuda_once(torch, lambda: rmod.merge_blocks(q, blocks, K, 0, rmod.step_plain))[1] / p,
        "library_ms": cuda_ms(torch, lambda: library_ring(torch, kmod, xs, ms, blocks),
                              reps=2, warmup=1) / p,
    }
    # (2C + 2) fp32 operations per (query, valid key of the block) pair;
    # the queries, the block and the running list read once and the list
    # written once
    valid_keys = int(mask.sum())
    ops = (2 * c + 2) * nl * valid_keys / p
    bytes_moved = 2 * 4 * b * nl * (c + 2) + 3 * 4 * b * nl * K * 2
    ops_ms = ops / FP32_PEAK_FLOPS * 1e3
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    t["bound_ms"] = max(ops_ms, bytes_ms)
    t["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    return t


def phase_ring_vs_plain(torch, kmod, rmod, seed: int, smi: str) -> float:
    """Phase 9: the ring kernel in one process on ragged random inputs and
    on the same inputs with every valid point equal, P = CP_P virtual
    owners; returns the largest score difference."""
    err = 0.0
    for c in (4, EDGE_WIDTH):
        x, mask = ring_ragged_inputs(seed, c)
        xt, mt = torch.tensor(x, device="cuda"), torch.tensor(mask, device="cuda")
        err = max(err, check_ring(torch, kmod, rmod, f"random C={c}", xt, mt,
                                  kmod.knn_cuda(xt, K, mt), range(CP_P)))
        xe = torch.tensor(all_equal(x, mask), device="cuda")
        err = max(err, check_ring(torch, kmod, rmod, f"all-equal C={c}", xe, mt,
                                  kmod.knn_cuda(xe, K, mt), range(CP_P), ties=True))
        t = time_ring(torch, kmod, rmod, xt, mt)
        log(f"ring knn timing, random inputs B={RING_B} N_local={RING_NL} P={CP_P} C={c} k={K} "
            f"[{smi}]: {fmt_times(t)} (library = matmul + torch.topk + sort merge per block)")
    return err


def cp_config():
    from dgcnn_tpu_torch.config import Config

    return Config(model_name="residual-dgcnn", num_class=2, kvalue=K,
                  edge_filters=(EDGE_WIDTH,) * EDGE_BLOCKS, head_feat_dim=1024,
                  head_mlp=(512, 256), minibatch_size=1, num_point=CP_N, point_shards=CP_P,
                  ring_impl="rdma")


def cp_events(seed: int):
    """Two fixed-length events of CP_N points and one variable-length
    event padded to CP_N, one event a batch."""
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO

    out = []
    for i, variable in enumerate((False, False, True)):
        io = SyntheticIO(num_events=1, num_point=CP_N, seed=seed + 20 + i, variable_length=variable)
        io.initialize()
        out += list(BucketBatcher(io, 1, num_point=CP_N, shuffle=False).epoch())
    return out


def cp_serve_rank(group, seed: int, profile: bool):
    """One rank of the CP serving phase (run by `run_point_ranks`): serve
    the CP events through `Trainval.inference_packed` with every kernel
    count at 0 before and read after, then time them and build the first
    block's graph by both ring impls."""
    import torch

    from dgcnn_tpu_torch.kernels import knn_banded_cuda as bmod
    from dgcnn_tpu_torch.kernels import knn_cuda as kmod
    from dgcnn_tpu_torch.kernels import ring_knn_cuda as rmod
    from dgcnn_tpu_torch.kernels.ring_knn import ring_knn
    from dgcnn_tpu_torch.parallel.collectives import broadcast_tree
    from dgcnn_tpu_torch.train.trainval import Trainval, TrainState

    tv = Trainval(cp_config(), group=group)
    state = tv.initialize(4, generator=torch.Generator().manual_seed(seed))
    # rank 0 seeds the weights, every rank serves with them
    state = TrainState(broadcast_tree(state.params, group), broadcast_tree(state.model_state, group))
    events = cp_events(seed)
    out = {"rank": group.rank, "device": str(group.device), "backend": group.backend,
           "stage_host": group.stage_host, "events": []}
    torch.cuda.reset_peak_memory_stats()

    rmod.launches = kmod.launches = bmod.launches = 0
    for batch in events:
        before = (rmod.launches, kmod.launches, bmod.launches)
        packed, metrics = tv.inference_packed(state, batch)
        torch.cuda.synchronize()
        out["events"].append({
            "packed": packed.cpu(),
            "metrics": {k: v.cpu() for k, v in metrics.items()},
            "launches": (rmod.launches - before[0], kmod.launches - before[1],
                         bmod.launches - before[2]),
        })
    out["main_launches"] = (rmod.launches, kmod.launches, bmod.launches)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()

    # host clock per event, inference + copy of the results to the host
    out["serve_s"] = []
    for batch in events:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores, pred, _ = tv.inference(state, batch)
        scores.cpu(), pred.cpu()
        out["serve_s"].append(time.perf_counter() - t0)
    # this rank's forward on its shard, CUDA events (the card is shared)
    points, _, _, mask = tv._put_batch(events[0])
    with torch.inference_mode():
        out["forward_ms"] = cuda_ms(
            torch, lambda: tv.model(state.params, state.model_state, points, mask), reps=2, warmup=1)
        if profile and group.rank == 0:
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as tprofile

            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                tv.model(state.params, state.model_state, points, mask)
                torch.cuda.synchronize()
            out["profile"] = prof.key_averages().table(sort_by="cuda_time_total", row_limit=15)
        elif profile:
            tv.model(state.params, state.model_state, points, mask)
        # the first block's graph (its input is the raw points), by both rings
        gi, gv = tv.model.knn_fn(points.float(), K, mask)
        pi, pv = ring_knn(points.float(), K, mask, group=group)
    out["first_graph"] = (gi.cpu(), gv.cpu())
    out["ppermute_differs"] = int((gi != pi).sum() + (gv != pv).sum())
    if group.rank == 0:
        out["state"] = (state.params, state.model_state)
    return out


def check_packed(packed, metrics, mask, num_class: int) -> None:
    s = packed[..., :num_class]
    pred = packed[..., num_class]
    if not np.isfinite(packed).all():
        raise AssertionError("non-finite packed output")
    if float(np.abs(s.sum(-1) - 1.0).max()) > 1e-5:
        raise AssertionError("scores do not sum to 1")
    if pred.min() < 0 or pred.max() >= num_class or not np.array_equal(pred, np.round(pred)):
        raise AssertionError("prediction out of range")
    if not np.allclose(packed[..., num_class + 1], metrics["loss"]):
        raise AssertionError("the packed loss lane is not the batch loss")
    if float(metrics["confusion"].sum()) != float(mask.sum()):
        raise AssertionError("confusion matrix does not count every valid point once")


def phase_cp_serving(torch, seed: int, smi: str, profile: bool):
    """Phase 10: the CP serving path on CP_P ranks."""
    from dgcnn_tpu_torch.parallel.launch import run_point_ranks

    torch.cuda.empty_cache()  # the ranks share the card with this process
    t0 = time.perf_counter()
    ranks = run_point_ranks(cp_serve_rank, CP_P, device="cuda", args=(seed, profile), timeout=900)
    events = cp_events(seed)
    valid = [int(e.mask.sum()) for e in events]
    log(f"cp serving: residual-dgcnn edge_filters={(EDGE_WIDTH,) * EDGE_BLOCKS} k={K} head "
        f"1024->512->256, ring_impl=rdma, {len(events)} events of 1x{CP_N} (last variable-length), "
        f"valid points {valid}; {CP_P} ranks, backend {ranks[0]['backend']}, devices "
        f"{[r['device'] for r in ranks]}, host staging {ranks[0]['stage_host']}; run_point_ranks "
        f"took {time.perf_counter() - t0:.1f} s (rank start-up included)")
    want = (EDGE_BLOCKS * CP_P, 0, 0)
    for i, batch in enumerate(events):
        for r in ranks:
            if r["events"][i]["launches"] != want:
                raise AssertionError(f"event {i} rank {r['rank']}: (ring, exact, banded) launches "
                                     f"+{r['events'][i]['launches']}, want +{want}")
        ref = ranks[0]["events"][i]
        for r in ranks[1:]:
            if not np.array_equal(r["events"][i]["packed"], ref["packed"]):
                raise AssertionError(f"event {i}: rank {r['rank']}'s packed output differs from rank 0's")
        check_packed(ref["packed"], ref["metrics"], batch.mask, 2)
        log(f"cp event {i}: ring launches +{want[0]} on each of {CP_P} ranks, exact +0, banded +0; "
            f"packed outputs identical on all ranks; loss={float(ref['metrics']['loss']):.6f}, "
            f"confusion={ref['metrics']['confusion'].astype(int).tolist()}")
    for r in ranks:
        if r["main_launches"] != (want[0] * len(events), 0, 0):
            raise AssertionError(f"rank {r['rank']}: main path launches {r['main_launches']}")
    for i in range(len(events)):
        dt = ranks[0]["serve_s"][i]
        log(f"cp serving time [{smi}]: event {i} {dt * 1e3:.3f} ms, {valid[i] / dt:.1f} valid "
            f"points/s (rank 0's host clock incl. copy to host; all ranks: "
            f"{[round(r['serve_s'][i] * 1e3, 3) for r in ranks]} ms)")
    cards = (f"the {CP_P} ranks share the card" if ranks[0]["stage_host"] else "a card a rank")
    log(f"cp forward device time per rank [{smi}]: {[round(r['forward_ms'], 3) for r in ranks]} ms "
        f"(CUDA events on each rank's shard; {cards}); peak device memory per rank "
        f"{[round(r['peak_bytes'] / 2**30, 3) for r in ranks]} GiB")
    if "profile" in ranks[0]:
        log(ranks[0]["profile"])
    return ranks, events


def phase_cp_vs_single(torch, kmod, ranks, events):
    """Phase 11: the same weights and first event through the
    single-device exact model (`knn_cuda`) on the card: the first block's
    graph identical, scores within 1e-4, predictions identical where the
    top-two logit margin exceeds 1e-4, ``ppermute`` gives the ``rdma``
    graph. Returns the six graph-build inputs of the single-device
    forward with the exact kernel's graph of each."""
    from dgcnn_tpu_torch.bridge import params_from_numpy
    from dgcnn_tpu_torch.train.trainval import Trainval

    params, mstate = params_from_numpy(*ranks[0]["state"], device="cuda")
    tv1 = Trainval(dataclasses.replace(cp_config(), point_shards=1, ring_impl="ppermute"))
    batch = events[0]
    points = torch.tensor(batch.points, device="cuda")
    mask = torch.tensor(batch.mask, device="cuda")
    captured = []

    def recording(x, k, m):
        out = kmod.knn_cuda(x, k, m)
        captured.append((x.clone(), m.clone(), out[0].clone(), out[1].clone()))
        return out

    tv1.model.knn_fn = recording
    with torch.inference_mode():
        logits, _ = tv1.model(params, mstate, points, mask)
        tv1.model.knn_fn = kmod.knn_cuda
        _, fwd_ms = cuda_once(torch, lambda: tv1.model(params, mstate, points, mask))
    gi = np.concatenate([r["first_graph"][0] for r in ranks], 1)
    gv = np.concatenate([r["first_graph"][1] for r in ranks], 1)
    same_graph = (np.array_equal(gi, captured[0][2].cpu().numpy())
                  and np.array_equal(gv, captured[0][3].cpu().numpy()))
    pp = [r["ppermute_differs"] for r in ranks]
    packed = ranks[0]["events"][0]["packed"]
    scores1 = torch.softmax(logits, -1).cpu().numpy()
    top2 = torch.topk(logits, 2, dim=-1).values
    decided = ((top2[..., 0] - top2[..., 1]) > 1e-4).cpu().numpy() & batch.mask
    pred_cp = packed[..., 2].astype(np.int64)
    pred1 = logits.argmax(-1).cpu().numpy()
    diff = float(np.abs(packed[..., :2] - scores1).max())
    flips = int(((pred_cp != pred1) & decided).sum())
    undecided = int((~decided & batch.mask).sum())
    log(f"cp vs single device (exact kernel on the whole event, {fwd_ms:.3f} ms forward device "
        f"time): first block's graph identical={same_graph}; max|score diff|={diff:.3e}; points "
        f"with another prediction among those with a top-two logit margin > 1e-4: {flips}; points "
        f"with margin <= 1e-4: {undecided} ({int(((pred_cp != pred1) & ~decided & batch.mask).sum())} "
        f"of them predicted differently); ppermute vs rdma first graph: {pp} slots differ per rank")
    if not same_graph or diff > 1e-4 or flips or any(pp):
        raise AssertionError("the CP path disagrees with the single-device model")
    return captured


def phase_ring_on_main_path(torch, kmod, rmod, captured, smi: str):
    """Phase 12: the ring kernel on the six graph-build inputs of a served
    CP_N-point forward, split into CP_P virtual owners: every rank's
    merges, all ranks together equal the exact kernel's graph of the
    whole input, rank 0 against the plain version; times and bound."""
    out = []
    for i, (x, m, ei, ev) in enumerate(captured):
        err = check_ring(torch, kmod, rmod, f"main path block {i} C={x.shape[-1]}", x, m,
                         (ei, ev), (0,))
        t = time_ring(torch, kmod, rmod, x, m)
        t["max_abs_err"] = err
        t["c"] = x.shape[2]
        log(f"ring knn timing, main path block {i} B={x.shape[0]} N_local={x.shape[1] // CP_P} "
            f"P={CP_P} C={x.shape[2]} k={K} [{smi}]: {fmt_times(t)} (per launch; library = "
            f"matmul + torch.topk + sort merge per block)")
        out.append(t)
    total = {key: sum(t[key] for t in out) * CP_P for key in TIME_KEYS}
    log(f"ring knn per rank and forward ({len(out) * CP_P} launches) [{smi}]: "
        + " ".join(f"{k}={v:.4f}" for k, v in total.items()))
    log_per_shape("ring knn", out, smi)
    return out


# ------------------------------------------------- any width, any k <= N


def phase_wide_and_long_k(torch, kmod, bmod, rmod, seed: int, smi: str) -> dict:
    """Phase 13: all three kernels at C = WIDE_C (channels in chunks) and
    k = WIDE_K (two passes, the second behind each row's ceiling) against
    their plain versions: the exact kernel on the phase-3 inputs (self,
    cross, all-equal), the banded kernel on the phase-4 inputs at W = 1024
    (self, halo cross, all-equal), the ring kernel on the phase-9 inputs
    (every rank against ``step_plain``, all ranks against the exact
    kernel, all-equal). Returns the largest score difference per kernel
    and logs wrapper and plain times at these shapes."""
    dev = torch.device("cuda")
    c, k = WIDE_C, WIDE_K
    err = {"knn": 0.0, "banded": 0.0, "ring": 0.0}
    chunks = (kmod._lib().dgcnn_knn_chunk(c + 2), bmod._lib().dgcnn_knn_banded_chunk(c + 2),
              rmod._lib().dgcnn_ring_knn_chunk(c + 2))
    log(f"any width and k: C={c} (C+2={c + 2}; channel chunk CH={chunks[0]} exact, {chunks[1]} "
        f"banded, {chunks[2]} ring), k={k} ({-(-k // kmod.KMAX)} passes)")

    x, mask = ragged_inputs(seed, c)
    xt, mt = torch.tensor(x, device=dev), torch.tensor(mask, device=dev)
    err["knn"] = max(check_knn(torch, kmod, f"random C={c} self", xt, xt, mt, x, k=k),
                     check_knn(torch, kmod, f"random C={c} cross", xt[:, :1000].contiguous(), xt,
                               mt, x[:, :1000], xk_np=x, cross=True, k=k))
    xe_np = all_equal(x, mask)
    xe = torch.tensor(xe_np, device=dev)
    err["knn"] = max(err["knn"], check_knn(torch, kmod, f"all-equal C={c} self", xe, xe, mt, xe_np,
                                           ties=True, k=k))
    log(f"knn timing C={c} k={k} B={B} N={N} [{smi}]: wrapper_ms="
        f"{cuda_ms(torch, lambda: kmod.knn_cuda(xt, k, mt), reps=5):.4f} plain_ms="
        f"{cuda_ms(torch, lambda: kmod.knn_plain(xt, xt, k, mt), reps=3, warmup=1):.4f}")

    x, mask = banded_ragged_inputs(seed, c)
    mt = torch.tensor(mask, device=dev)
    nvalid = mt.sum(-1).to(torch.int32)
    w, (s0, s1) = 1024, (RAGGED_N // 4, RAGGED_N // 2)
    kb, ke = s0 - w, s1 + w
    for kind, xn in (("random", x), ("all-equal", all_equal(x, mask))):
        xt = torch.tensor(xn, device=dev)
        ties = kind == "all-equal"
        err["banded"] = max(
            err["banded"],
            check_banded(torch, bmod, f"{kind} C={c} self", xt, xt, mt, w, xn, ties=ties, k=k)[0],
            check_banded(torch, bmod, f"{kind} C={c} cross q_base={s0} key_base={kb}",
                         xt[:, s0:s1].contiguous(), xt[:, kb:ke].contiguous(),
                         mt[:, kb:ke].contiguous(), w, xn, q_rows=slice(s0, s1),
                         band=dict(q_base=s0, key_base=kb, nvalid=nvalid), ties=ties, k=k)[0])
    xt = torch.tensor(x, device=dev)
    ms = cuda_ms(torch, lambda: bmod.knn_banded_cuda(xt, k, mt, window=w), reps=3, warmup=1)
    _, plain_ms = cuda_once(torch, lambda: bmod.knn_banded_plain(xt, xt, k, mt, window=w))
    log(f"banded knn timing C={c} k={k} W={w} B={B} N={RAGGED_N} [{smi}]: wrapper_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f}")

    x, mask = ring_ragged_inputs(seed, c)
    xt, mt = torch.tensor(x, device=dev), torch.tensor(mask, device=dev)
    xe = torch.tensor(all_equal(x, mask), device=dev)
    err["ring"] = max(
        check_ring(torch, kmod, rmod, f"random C={c}", xt, mt, kmod.knn_cuda(xt, k, mt),
                   range(CP_P), k=k),
        check_ring(torch, kmod, rmod, f"all-equal C={c}", xe, mt, kmod.knn_cuda(xe, k, mt),
                   range(CP_P), ties=True, k=k))
    qa, ka = kmod.build_augmented_operands(xt, xt, mt)
    q, blocks = ring_rank_blocks(qa, ka, 0, CP_P)
    ms = cuda_ms(torch, lambda: rmod.merge_blocks(q, blocks, k, 0, rmod.launch_step), reps=3,
                 warmup=1)
    _, plain_ms = cuda_once(torch, lambda: rmod.merge_blocks(q, blocks, k, 0, rmod.step_plain))
    log(f"ring knn timing C={c} k={k} B={RING_B} N_local={RING_NL} P={CP_P} [{smi}]: rank 0's "
        f"merges (all passes) / P: kernel_ms={ms / CP_P:.4f} plain_ms={plain_ms / CP_P:.4f}")
    return err


# ------------------------------------------------------------ train step


def phase_train(torch, kmod, seed: int, smi: str, profile: bool):
    """Phase 14: `Trainval.train_step` of the full-width residual-dgcnn (6 x
    64, k=20, head 1024 -> 512 -> 256) on one fixed-length `SyntheticIO`
    event of TRAIN_N points, Adam at 1e-3, the same batch every step
    (bench.py's workload). TRAIN_WARMUP steps, then TRAIN_STEPS timed
    ones; the exact kernel must launch exactly 6 times a step, and the
    loss must be finite and fall over the timed steps. The six graph-build
    inputs of step 1 are captured; the kernel is checked on each against
    `knn_plain` (0 hard mismatches) and timed there.

    The same init and batch for TRAIN_PLAIN_STEPS steps through two plain
    graph builds: the kernel's plain version `knn_plain` (the same
    augmented scores through a matmul, which gave the kernel's scores bit
    for bit on these inputs) and the oracle of ``use_pallas=False``
    (`ops.knn.knn_indices`, distances assembled as ``|x_i|^2 + |x_j|^2 -
    2 x_i.x_j``). Step 1 runs before any update: against `knn_plain` its
    loss must agree within 1e-5 relative; against the oracle within
    TRAIN_ORACLE_RTOL: on the dense tracks of `SyntheticIO` (neighbours
    1e-2 apart at coordinates of order 1) both expressions cancel terms of
    order 1 down to distances of order 1e-4, so each orders neighbours
    whose distances differ by parts in a thousand in its own way (8.55e-5
    measured on an H100). From step 2 on the
    backward's ``index_add_`` sums in the order its atomics land, which
    changes from run to run, and Adam turns such last-bit differences of
    a near-zero gradient into steps of about ``lr``: two runs of this
    very trainer differ by 4.5e-4 relative at step 10. The loss after
    TRAIN_PLAIN_STEPS steps must agree within TRAIN_LOSS_RTOL against both.
    Every number is logged before a limit is checked. Returns
    ``(launches, per-launch records at the train shape, host ms a step)``."""
    from dgcnn_tpu_torch.bridge import tree_map
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO
    from dgcnn_tpu_torch.train.trainval import Trainval

    cfg = Config(model_name="residual-dgcnn", num_class=2, kvalue=K,
                 edge_filters=(EDGE_WIDTH,) * EDGE_BLOCKS, minibatch_size=1, num_point=TRAIN_N,
                 optimizer="adam", learning_rate=1e-3)
    io = SyntheticIO(num_events=1, num_point=TRAIN_N, seed=seed, variable_length=False)
    io.initialize()
    batch = next(BucketBatcher(io, 1, num_point=TRAIN_N, shuffle=False).epoch())
    tv = Trainval(cfg)
    state = tv.initialize(4, generator=torch.Generator().manual_seed(seed))
    # copies of the init for the plain run: the steps update in place
    init = (tree_map(torch.clone, state.params), tree_map(torch.clone, state.model_state))
    log(f"train: residual-dgcnn edge_filters={cfg.edge_filters} k={K} head "
        f"{cfg.head_feat_dim}->{'->'.join(map(str, cfg.head_mlp))}, B=1 N={TRAIN_N} "
        f"(fixed-length SyntheticIO, {int(batch.mask.sum())} valid), {cfg.optimizer} lr "
        f"{cfg.learning_rate}, dropout {cfg.dropout}, {TRAIN_WARMUP} warm-up + {TRAIN_STEPS} "
        f"timed steps on one batch")

    captured = []
    graph_build = tv.model.knn_fn

    def recording(x, k, mask):
        captured.append((x.detach().clone(), mask.clone()))
        return graph_build(x, k, mask)

    losses = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    kmod.launches = 0
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            start.record()
        before = kmod.launches
        tv.model.knn_fn = recording if i == 0 else graph_build
        state, metrics = tv.train_step(state, batch)
        if kmod.launches - before != EDGE_BLOCKS:
            raise AssertionError(f"train step {i + 1}: kNN kernel launched "
                                 f"{kmod.launches - before} times, want {EDGE_BLOCKS}")
        losses.append(metrics["loss"])
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    launches = kmod.launches
    tv.model.knn_fn = graph_build
    event_ms = start.elapsed_time(end) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in losses]
    log(f"train main path: {launches} kNN kernel launches over {TRAIN_WARMUP + TRAIN_STEPS} steps "
        f"({EDGE_BLOCKS} a step)")
    log(f"train losses: {[round(v, 6) for v in losses]}")
    log(f"train step time [{smi}]: {event_ms:.3f} ms (CUDA events), {host_ms:.3f} ms (host clock, "
        f"synchronized), {TRAIN_N / (host_ms / 1e3):.1f} points/s, peak device memory {peak:.3f} "
        f"GiB (mean of {TRAIN_STEPS} steps, B=1 N={TRAIN_N})")
    timed = losses[TRAIN_WARMUP:]
    failed = []
    if not all(np.isfinite(losses)) or not timed[-1] < timed[0]:
        failed.append(f"loss not finite or not falling over the timed steps: {timed}")

    # the same init and batch through the two plain graph builds
    plain_fns = {
        "knn_plain (the kernel's plain version)": (
            dict(knn_fn=lambda x, k, mask: kmod.knn_plain(x, x, k, mask)[:2]), 1e-5),
        "--no_pallas (the oracle knn_indices)": (dict(), TRAIN_ORACLE_RTOL),
    }
    for label, (kw, step1_rtol) in plain_fns.items():
        plain = Trainval(dataclasses.replace(cfg, use_pallas=False), **kw)
        pstate = plain.with_params(*(tree_map(torch.clone, t) for t in init))
        plain_losses = []
        for _ in range(TRAIN_PLAIN_STEPS):
            pstate, pm = plain.train_step(pstate, batch)
            plain_losses.append(float(pm["loss"]))
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
        log(f"train kernel vs {label}, same init and batch: relative loss difference by step "
            f"{[f'{r:.2e}' for r in rel]} (limits: step 1 {step1_rtol}, step "
            f"{TRAIN_PLAIN_STEPS} {TRAIN_LOSS_RTOL})")
        if rel[0] > step1_rtol or rel[-1] > TRAIN_LOSS_RTOL:
            failed.append(f"loss against {label}: step 1 {rel[0]:.2e}, step "
                          f"{TRAIN_PLAIN_STEPS} {rel[-1]:.2e}")

    # the kernel on step 1's six graph-build inputs
    out = []
    for i, (x, m) in enumerate(captured):
        err = check_knn(torch, kmod, f"train step 1 block {i} C={x.shape[-1]}", x, x, m,
                        x.cpu().numpy())
        t = time_knn(torch, kmod, x, m)
        t["max_abs_err"] = err
        t["c"] = x.shape[2]
        log(f"knn timing, train block {i} B=1 N={TRAIN_N} C={x.shape[2]} k={K} [{smi}]: "
            f"{fmt_times(t)}")
        out.append(t)
    log_per_shape("knn train shape", out, smi)
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile

        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, _ = tv.train_step(state, batch)
            torch.cuda.synchronize()
        from torch.autograd import DeviceType

        table = prof.key_averages()
        # the device's own events (kernels, copies); an operator's row on
        # the host also carries its kernels' time, so it is not summed
        busy_ms = sum(e.self_device_time_total for e in table
                      if e.device_type != DeviceType.CPU) / 1e3
        log(table.table(sort_by="cuda_time_total", row_limit=25))
        # the profiler slows the host, so the idle share is taken against
        # the timed steps' mean
        log(f"train step profile [{smi}]: device busy {busy_ms:.3f} ms a step (profiler, device "
            f"events); idle share of a timed step 1 - {busy_ms:.3f} / {host_ms:.3f} ms = "
            f"{1 - busy_ms / host_ms:.3f}")
    if failed:
        raise AssertionError("train: " + "; ".join(failed))
    return launches, out, host_ms


class _Tee(io.TextIOBase):
    """Writes to standard output and keeps a copy."""

    def __init__(self):
        self.buf = io.StringIO()

    def write(self, s):
        sys.__stdout__.write(s)
        return self.buf.write(s)

    def flush(self):
        sys.__stdout__.flush()


def run_cli(torch, argv, tee=False):
    """``cli.main(argv)`` in this process on the card (exit code 0
    required); with ``tee``, also what it printed."""
    from dgcnn_tpu_torch import cli

    out = _Tee()
    with contextlib.redirect_stdout(out) if tee else contextlib.nullcontext():
        rc = cli.main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"cli.main({' '.join(argv)}) exited {rc}")
    return out.buf.getvalue()


def run_subprocess(args, cwd, timeout=600):
    """A command of the port in a child process with this checkout on its
    path; exit code 0 required. Returns its standard output."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=timeout)
    log(f"$ python3 {' '.join(args)}  ({time.perf_counter() - t0:.1f} s, exit {res.returncode})")
    if res.returncode != 0:
        raise AssertionError(f"{' '.join(args)} exited {res.returncode}:\n{res.stdout[-4000:]}"
                             f"\n{res.stderr[-4000:]}")
    return res.stdout


def read_csv_log(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    with open(path) as f:
        header = f.readline().strip().split(",")
    return header, rows


def phase_cli(torch, kmod, bmod, rmod, seed: int, smi: str, train_ms: float,
              serve_pps: float, d: str) -> int:
    """Phase 15: the command line of the port on the card, one process
    (``-nd 1``, whatever the card count), in the directory ``d`` (see the
    module docstring). Returns the exact kernel's launches over the
    command-line train and inference runs."""
    from dgcnn_tpu_torch.config import parse_args
    from dgcnn_tpu_torch.io import BucketBatcher
    from dgcnn_tpu_torch.io import dgb as dgb_mod
    from dgcnn_tpu_torch.train import checkpoint
    from dgcnn_tpu_torch.train.trainval import Trainval
    from dgcnn_tpu_torch.utils import device_memory_stats

    info = run_subprocess(["-m", "dgcnn_tpu_torch", "info"], d)
    log("\n".join("  " + line for line in info.strip().splitlines()))
    if "C++ batch assembler active" not in info or torch.cuda.get_device_name(0) not in info:
        raise AssertionError("info: the card or the native DGB reader is missing")
    t0 = time.perf_counter()
    run_subprocess(["-m", "dgcnn_tpu_torch.io.convert", "synth", "events.dgb", "--events",
                    str(CLI_EVENTS), "--points", str(TRAIN_N), "--fixed_length", "--seed",
                    str(seed)], d)
    run_subprocess(["-m", "dgcnn_tpu_torch.io.convert", "synth", "val.npz", "--events",
                    str(CLI_VAL_EVENTS), "--points", str(TRAIN_N), "--fixed_length", "--seed",
                    str(seed + 1)], d)
    log(f"cli data: {CLI_EVENTS} x {TRAIN_N} points -> events.dgb, {CLI_VAL_EVENTS} x "
        f"{TRAIN_N} -> val.npz in {time.perf_counter() - t0:.1f} s")
    p = lambda *names: os.path.join(d, *names)  # noqa: E731
    model = ["-mn", "residual-dgcnn", "-k", str(K), "--edge_filters",
             *[str(EDGE_WIDTH)] * EDGE_BLOCKS]
    data = ["-io", "dgb", "-if", p("events.dgb"), "-mb", "1", "-np", str(TRAIN_N), *model,
            "--seed", str(seed), "-nd", "1"]
    train = ["train", *data, "-rs", str(CLI_REPORT), "-cs", str(CLI_CKPT), "-wp",
             p("w", "snap"), "-ld", p("log")]

    # train: 20 steps with validation
    torch.cuda.reset_peak_memory_stats()
    kmod.launches = bmod.launches = rmod.launches = 0
    dgb_mod.native_batches = 0
    t0 = time.perf_counter()
    run_cli(torch, train + ["-i", str(CLI_STEPS), "-vf", p("val.npz"), "--val_batches",
                            str(CLI_VAL_BATCHES)])
    train_wall = time.perf_counter() - t0
    launches, native = kmod.launches, dgb_mod.native_batches
    log(f"cli train device memory [{smi}]: {device_memory_stats()} (bytes, cuda:0, "
        f"torch.cuda.memory_stats; the peak is the train run's)")
    val_batches = (CLI_STEPS // CLI_REPORT) * CLI_VAL_BATCHES
    want = EDGE_BLOCKS * (CLI_STEPS + val_batches)
    log(f"cli train: {CLI_STEPS} steps + {val_batches} validation batches in {train_wall:.1f} "
        f"s (start-up included); exact kNN launches {launches} (want {want}), banded "
        f"{bmod.launches}, ring {rmod.launches}; native DGB batches {native}")
    if launches != want or bmod.launches or rmod.launches:
        raise AssertionError(f"cli train: kernel launches {launches}/{bmod.launches}/"
                             f"{rmod.launches}, want {want}/0/0")
    # read ahead: the batch that ends the loop, the prefetch queue's 2
    # and the one its thread holds
    if not CLI_STEPS <= native <= CLI_STEPS + 4:
        raise AssertionError(f"cli train: the native DGB reader assembled {native} "
                             f"batches, want {CLI_STEPS} (+ prefetch)")
    header, rows = read_csv_log(p("log", "train_log.csv"))
    log(f"cli train log: {header}")
    for r in rows:
        log("  " + " ".join(f"{k}={r[k]}" for k in header))
    if header != CSV_COLUMNS:
        raise AssertionError(f"train_log.csv columns {header}, want {CSV_COLUMNS}")
    if [int(r["iter"]) for r in rows] != list(range(CLI_REPORT, CLI_STEPS + 1, CLI_REPORT)):
        raise AssertionError(f"train_log.csv rows at {[r['iter'] for r in rows]}")
    if not all(np.isfinite(float(r[k])) for r in rows for k in ("loss", "val_loss",
                                                                "val_acc", "val_miou")):
        raise AssertionError("train_log.csv: a loss or validation value is not finite")
    for step in range(CLI_CKPT, CLI_STEPS + 1, CLI_CKPT):
        if not os.path.exists(p("w", f"snap-{step}.ckpt")):
            raise AssertionError(f"no checkpoint at step {step}")

    # the last checkpoint: restore, save again, same bytes
    cfg = parse_args(train + ["-i", str(CLI_STEPS)])
    tv = Trainval(cfg)
    template = tv.state_tree(tv.initialize(4))
    path = p("w", f"snap-{CLI_STEPS}.ckpt")
    t0 = time.perf_counter()
    tree, step, saved = checkpoint.restore(path, template)
    state = tv.load_tree(tree)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    again = checkpoint.save(p("again", "snap"), step, tv.state_tree(state), saved)
    save_ms = (time.perf_counter() - t0) * 1e3
    same = open(path, "rb").read() == open(again, "rb").read()
    log(f"checkpoint [{smi}]: {os.path.getsize(path)} bytes, restore to the card "
        f"{restore_ms:.1f} ms, save {save_ms:.1f} ms (host clock); restored and saved "
        f"again: {'identical' if same else 'DIFFERENT'} bytes")
    if not same or step != CLI_STEPS or state.step != CLI_STEPS:
        raise AssertionError("checkpoint round trip changed the file or the step")
    del state, tree, tv

    # resume to step 30 (no validation: rows 25 and 30 time the steps)
    out = run_cli(torch, train + ["-i", str(CLI_RESUME_TO), "--auto_resume"], tee=True)
    if f"restored checkpoint at step {CLI_STEPS}" not in out:
        raise AssertionError("cli resume did not restore the last checkpoint")
    header, rows = read_csv_log(p("log", "train_log.csv"))
    iters = [int(r["iter"]) for r in rows]
    if iters != list(range(CLI_REPORT, CLI_RESUME_TO + 1, CLI_REPORT)):
        raise AssertionError(f"train_log.csv rows after the resume at {iters}")
    if not os.path.exists(p("w", f"snap-{CLI_RESUME_TO}.ckpt")):
        raise AssertionError(f"no checkpoint at step {CLI_RESUME_TO}")
    loop_ms = [float(r["titer"]) * 1e3 for r in rows[-2:]]
    log(f"cli train step time [{smi}]: {loop_ms[0]:.3f} ms (steps 21-25), "
        f"{loop_ms[1]:.3f} ms (steps 26-30) through the loop, host clock between report "
        f"lines; phase 14's direct train_step at the same shape {train_ms:.3f} ms "
        f"(host clock, synchronized)")

    # inference with write-back, 4 events a batch
    kmod.launches = 0
    out = run_cli(torch, ["inference", "-io", "dgb", "-if", p("events.dgb"), "-mb",
                          str(CLI_SERVE_B), "-nd", "1", "-mp", p("w", "snap"), "-of",
                          p("pred.npz"), "-ld", p("log")], tee=True)
    cli_serve_launches = kmod.launches
    n_batches = CLI_EVENTS // CLI_SERVE_B
    if cli_serve_launches != EDGE_BLOCKS * n_batches:
        raise AssertionError(f"cli inference: {cli_serve_launches} kernel launches, want "
                             f"{EDGE_BLOCKS * n_batches}")
    m = re.search(r"inference: (\d+) batches in ([0-9.]+)s", out)
    serve_s = float(m.group(2))
    cli_pps = CLI_EVENTS * TRAIN_N / serve_s
    pred = np.load(p("pred.npz"))
    ids, off = pred["event_ids"], pred["offsets"]
    if ids.tolist() != list(range(CLI_EVENTS)) or not np.all(np.diff(off) == TRAIN_N):
        raise AssertionError(f"pred.npz: events {ids.tolist()}, sizes {np.diff(off)}")
    if pred["scores"].shape != (CLI_EVENTS * TRAIN_N, 2) or not np.isfinite(
            pred["scores"]).all():
        raise AssertionError("pred.npz: scores missing or not finite")
    # the same checkpoint and batches in this process
    from dgcnn_tpu_torch.io.dgb import DGBIO
    from dgcnn_tpu_torch.train.checkpoint import adopt_model_flags

    icfg = adopt_model_flags(parse_args(["inference", "-mb", str(CLI_SERVE_B), "-mp",
                                         p("w", "snap")]), p("w", "snap"))
    tv = Trainval(icfg)
    state, _ = tv.restore_for_eval(tv.initialize(4), p("w", "snap"))
    reader = DGBIO(p("events.dgb")).initialize()
    mismatched = 0
    worst = 0.0
    for batch in BucketBatcher(reader, CLI_SERVE_B, shuffle=False, seed=icfg.seed).epoch():
        scores, pr, _ = tv.inference(state, batch)
        for j, eid in enumerate(batch.event_ids):
            lo, hi = off[eid], off[eid + 1]
            n = hi - lo
            mismatched += int((pr[j, :n].cpu().numpy() != pred["prediction"][lo:hi]).sum())
            worst = max(worst, float(np.abs(scores[j, :n].cpu().numpy()
                                            - pred["scores"][lo:hi]).max()))
    reader.finalize()
    log(f"cli inference: {n_batches} batches of {CLI_SERVE_B} x {TRAIN_N}, {cli_serve_launches} "
        f"kernel launches; pred.npz against restore_for_eval + Trainval.inference in this "
        f"process: {mismatched} predictions differ, max |score diff| {worst:.3e}")
    if mismatched or worst > 1e-6:
        raise AssertionError("cli inference disagrees with Trainval.inference")
    log(f"cli serving [{smi}]: {cli_pps:.1f} points/s ({CLI_EVENTS} events of {TRAIN_N} in "
        f"{serve_s:.2f} s, batches of {CLI_SERVE_B}, write-back to npz included, host "
        f"clock); phase 5 (Trainval.inference, {B} x {N}) {serve_pps:.1f} points/s")

    # native DGB batch assembly
    reader = DGBIO(p("events.dgb")).initialize()
    if not reader.native_active:
        raise AssertionError("the native DGB reader is not active")
    for bsz in (1, CLI_SERVE_B):
        reps = 20
        ids = [list(range(i, i + bsz)) for i in range(0, reps)]
        t0 = time.perf_counter()
        for e in ids:
            reader.read_batch([x % CLI_EVENTS for x in e], TRAIN_N, crop=TRAIN_N)
        ms = (time.perf_counter() - t0) * 1e3 / reps
        log(f"native DGB batch assembly [{smi}]: {ms:.3f} ms a batch of {bsz} x {TRAIN_N} "
            f"(host clock, {reps} batches)")
    reader.finalize()

    # one command-line train in a child process on the card
    run_subprocess(["-m", "dgcnn_tpu_torch", "train", *data, "-i", "2", "-wp",
                    p("sub", "snap"), "-ld", p("sub")], d)
    if not os.path.exists(p("sub", "snap-2.ckpt")):
        raise AssertionError("the child process wrote no checkpoint")
    return launches + cli_serve_launches


# ------------------------------------------------------ data parallelism

def dp_config(num_devices: int, optimizer: str, minibatch: int):
    """The full-width residual-dgcnn trained on TRAIN_N-point events, one
    event a data rank, dropout 0."""
    from dgcnn_tpu_torch.config import Config

    return Config(model_name="residual-dgcnn", num_class=2, kvalue=K,
                  edge_filters=(EDGE_WIDTH,) * EDGE_BLOCKS, minibatch_size=minibatch,
                  num_point=TRAIN_N, optimizer=optimizer,
                  learning_rate=DP_SGD_LR if optimizer == "sgd" else 1e-3,
                  num_devices=num_devices)


def replayed_graphs(path: str, rows: slice, device):
    """A kNN function that returns, call by call, the graphs saved in
    ``path`` (``idx{i}``, ``valid{i}``), rows ``rows`` of each."""
    import torch

    saved = np.load(path)
    calls = iter(range(len(saved.files) // 2))

    def knn(x, k, mask):
        i = next(calls)
        return tuple(torch.as_tensor(np.ascontiguousarray(saved[f"{name}{i}"][rows]),
                                     device=device) for name in ("idx", "valid"))

    return knn


def dp_train_rank(group, params, mstate, batches, graphs: str, seed: int, profile: bool):
    """One data rank of phase 16 (run by `run_ranks`): DP_PARITY_STEPS SGD
    steps from the bridged init on the parity batches, on this rank's rows
    of the exact kernel's graphs of the one-rank run (``graphs``), then the
    Adam timing run on the kernel (DP_WARMUP + DP_STEPS steps on the first
    batch, the exact kernel's count at 0 before the first step and read
    after the last); then the gradient all-reduce alone, timed."""
    import torch

    from dgcnn_tpu_torch.bridge import params_from_numpy, tree_leaves
    from dgcnn_tpu_torch.kernels import knn_cuda as kmod
    from dgcnn_tpu_torch.parallel import collectives
    from dgcnn_tpu_torch.train.trainval import Trainval

    dev = group.device
    n = group.data_size
    out = {"rank": group.data_rank, "device": str(dev), "backend": group.backend,
           "stage_host": group.stage_host}
    tv = Trainval(dp_config(n, "sgd", n), group=group)
    rows = len(batches[0][1]) // n
    tv.model.knn_fn = replayed_graphs(graphs, slice(group.data_rank * rows,
                                                    (group.data_rank + 1) * rows), dev)
    state = tv.with_params(*params_from_numpy(params, mstate, device=dev))
    losses = []
    for b in batches:
        state, m = tv.train_step(state, b)
        losses.append(float(m["loss"]))
    out["losses"] = losses
    out["params"] = [t.detach().cpu().numpy() for t in tree_leaves(state.params)]
    del tv, state

    tv = Trainval(dp_config(n, "adam", n), group=group)
    state = tv.initialize(4, generator=torch.Generator().manual_seed(seed))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    timed = []
    kmod.launches = 0
    for i in range(DP_WARMUP + DP_STEPS):
        if i == DP_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counts0 = dict(collectives.counts)
            t0 = time.perf_counter()
            start.record()
        state, m = tv.train_step(state, batches[0])
        timed.append(m["loss"])
    end.record()
    torch.cuda.synchronize()
    out["host_ms"] = (time.perf_counter() - t0) * 1e3 / DP_STEPS
    out["event_ms"] = start.elapsed_time(end) / DP_STEPS
    out["launches"] = kmod.launches
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["timed_losses"] = [float(v) for v in timed]
    out["collectives_a_step"] = {k: (v - counts0.get(k, 0)) / DP_STEPS
                                 for k, v in collectives.counts.items()}

    # the gradient all-reduce alone, on buffers of the gradient's size
    grads = [torch.ones_like(t) for t in tree_leaves(state.params)]
    collectives.all_reduce_grads(grads, group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DP_ALLREDUCE_REPS):
        collectives.all_reduce_grads(grads, group)
    torch.cuda.synchronize()
    out["allreduce_ms"] = (time.perf_counter() - t0) * 1e3 / DP_ALLREDUCE_REPS
    out["allreduce_bytes"] = 4 * sum(g.numel() for g in grads)

    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile

        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, _ = tv.train_step(state, batches[0])
            torch.cuda.synchronize()
        table = prof.key_averages()
        # NCCL's kernels spin until every rank has joined: their device
        # time is waiting, so it is reported apart from the busy time
        device = [e for e in table if e.device_type != DeviceType.CPU]
        nccl = [e for e in device if "nccl" in e.key.lower() or "param_comms" in e.key]
        out["busy_ms"] = sum(e.self_device_time_total for e in device if e not in nccl) / 1e3
        out["nccl_device_ms"] = sum(e.self_device_time_total for e in nccl) / 1e3
        # the backend's own records (gloo blocks in them, NCCL enqueues)
        out["collective_host_ms"] = sum(e.cpu_time_total for e in table
                                        if e.key.startswith(("gloo:", "nccl:"))) / 1e3
        out["profile"] = table.table(sort_by="cpu_time_total", row_limit=25)
    return out


def dp_ranks(torch) -> int:
    """The data ranks of phase 16: every visible card (two ranks sharing
    one card on a machine with one)."""
    return max(2, torch.cuda.device_count())


def phase_dp(torch, kmod, seed: int, smi: str, profile: bool, n: int, d: str) -> int:
    """Phase 16: data-parallel training on ``n`` ranks against one rank on
    the card (see the module docstring), with scratch files in ``d``.
    Returns the exact kernel's launches on all ranks."""
    from dgcnn_tpu_torch.bridge import params_from_numpy, params_to_numpy, tree_leaves
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO
    from dgcnn_tpu_torch.parallel.launch import run_ranks
    from dgcnn_tpu_torch.train.trainval import Trainval

    io = SyntheticIO(num_events=n * DP_PARITY_STEPS, num_point=TRAIN_N, seed=seed + 2,
                     variable_length=False)
    io.initialize()
    batches = [(b.points, b.labels, b.weights, b.mask)
               for b in BucketBatcher(io, n, num_point=TRAIN_N, shuffle=False).epoch()]
    cfg1 = dp_config(1, "sgd", n)
    one = Trainval(cfg1)
    init = one.initialize(4, generator=torch.Generator().manual_seed(seed))
    params, mstate = params_to_numpy(init.params, init.model_state)
    log(f"dp: residual-dgcnn edge_filters={cfg1.edge_filters} k={K} head "
        f"{cfg1.head_feat_dim}->{'->'.join(map(str, cfg1.head_mlp))}, {n} ranks x 1 event of "
        f"{TRAIN_N} points (global minibatch {n}), SGD lr {DP_SGD_LR}, dropout 0, "
        f"{DP_PARITY_STEPS} steps against one rank on the same card and batches")
    # the one-rank run builds its graphs with the exact kernel and saves
    # them; its repeat, its run on the batches' rows reversed and the ranks
    # replay them (a near tie that the last bit of a reassociated BN sum
    # flips would otherwise part the runs from step 1 on)
    kernel = one.model.knn_fn
    built = []

    def recording(x, k, mask):
        idx, valid = kernel(x, k, mask)
        built.append((idx.cpu().numpy(), valid.cpu().numpy()))
        return idx, valid

    graphs = os.path.join(d, "dp_graphs.npz")
    reversed_rows = [tuple(None if a is None else np.ascontiguousarray(a[::-1]) for a in b)
                     for b in batches]
    runs = []
    for i, bs in enumerate((batches, batches, reversed_rows)):
        if i == 0:
            one.model.knn_fn = recording
        else:
            one.model.knn_fn = replayed_graphs(graphs, slice(None, None, 1 if i == 1 else -1),
                                               torch.device("cuda"))
        st = one.with_params(*params_from_numpy(params, mstate, device="cuda"))
        losses = []
        for b in bs:
            st, m = one.train_step(st, b)
            losses.append(float(m["loss"]))
        runs.append((losses, [t.cpu().numpy() for t in tree_leaves(st.params)]))
        if i == 0:
            np.savez(graphs, **{f"{name}{j}": g[c] for j, g in enumerate(built)
                                for c, name in enumerate(("idx", "valid"))})
    del one, init, st, built
    torch.cuda.empty_cache()  # the ranks share the card with this process

    t0 = time.perf_counter()
    ranks = run_ranks(dp_train_rank, n, device="cuda",
                      args=(params, mstate, batches, graphs, seed, profile), timeout=900)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    ref = np.concatenate([p.ravel() for p in runs[0][1]])
    update = float(np.linalg.norm(ref - np.concatenate([p.ravel() for p in tree_leaves(params)])))

    def dist(leaves):
        """The distance of ``leaves`` from the one-rank run's parameters,
        relative to that run's update (L2 over every parameter), and the
        largest difference of one entry relative to the largest parameter."""
        flat = np.concatenate([p.ravel() for p in leaves])
        return (float(np.linalg.norm(flat - ref)) / update,
                float(np.abs(flat - ref).max()) / float(np.abs(ref).max()))

    again, rev, dp = dist(runs[1][1]), dist(runs[2][1]), dist(r0["params"])
    spread = max(again[0], rev[0])
    tol = max(DP_SPREAD_FACTOR * spread, DP_UPDATE_SHARE)
    dp_vs_1 = dp[0]
    step1 = abs(r0["losses"][0] - runs[0][0][0]) / abs(runs[0][0][0])
    same = all(np.array_equal(a, b) for r in ranks[1:] for a, b in zip(r["params"], r0["params"]))
    log(f"dp ranks: {n}, backend {r0['backend']}, devices {[r['device'] for r in ranks]}, host "
        f"staging {r0['stage_host']}; run_ranks took {spawn_s:.1f} s (rank start-up included)")
    log(f"dp losses: DP-{n} {[round(v, 6) for v in r0['losses']]}, DP-1 "
        f"{[round(v, 6) for v in runs[0][0]]}, again {[round(v, 6) for v in runs[1][0]]}, rows "
        f"reversed {[round(v, 6) for v in runs[2][0]]}; step 1 relative difference "
        f"{step1:.3e} (limit {DP_LOSS_RTOL})")
    log(f"dp params after {DP_PARITY_STEPS} steps, |p - p(DP-1)| / |p(DP-1) - p(init)| over "
        f"every parameter (and max |entry difference| / max |p|): DP-{n} {dp[0]:.3e} "
        f"({dp[1]:.3e}); DP-1 again {again[0]:.3e} ({again[1]:.3e}), rows reversed "
        f"{rev[0]:.3e} ({rev[1]:.3e}); |update| {update:.4f}; limit max({DP_SPREAD_FACTOR} x "
        f"spread, {DP_UPDATE_SHARE}) = {tol:.3e}; every rank's parameters identical: {same} "
        f"(all on the one-rank run's exact-kernel graphs)")
    want = EDGE_BLOCKS * (DP_WARMUP + DP_STEPS)
    launches = [r["launches"] for r in ranks]
    coll = r0["collectives_a_step"]
    bn = coll.get("psum_autograd", 0) + coll.get("psum_autograd_backward", 0)
    log(f"dp main path: exact kNN launches by rank {launches} (want {want} each: {EDGE_BLOCKS} a "
        f"step, {DP_WARMUP + DP_STEPS} steps); collectives a step "
        f"{ {k: v for k, v in sorted(coll.items()) if v} } ({bn:g} BN statistic collectives: "
        f"{coll.get('psum_autograd', 0):g} forward + {coll.get('psum_autograd_backward', 0):g} "
        f"backward)")
    shared = (f"{n} ranks share one card's SMs: not a multi-card DP speed" if r0["stage_host"]
              else f"a card a rank, {n} cards")
    host_ms = r0["host_ms"]
    log(f"dp train step time [{smi}]: {host_ms:.3f} ms (rank 0 host clock, synchronized), "
        f"{r0['event_ms']:.3f} ms (rank 0 CUDA events), all ranks "
        f"{[round(r['host_ms'], 3) for r in ranks]} ms; {n * TRAIN_N / (host_ms / 1e3):.1f} "
        f"global points/s; peak device memory a rank "
        f"{[round(r['peak_bytes'] / 2**30, 3) for r in ranks]} GiB (Adam, mean of {DP_STEPS} "
        f"steps; {shared})")
    log(f"dp gradient all-reduce [{smi}]: {r0['allreduce_ms']:.3f} ms a call, "
        f"{r0['allreduce_bytes']} bytes (one flat f32 buffer, {r0['backend']}"
        f"{', staged through pinned host memory' if r0['stage_host'] else ''}; host clock, "
        f"synchronized, mean of {DP_ALLREDUCE_REPS})")
    timed = r0["timed_losses"][DP_WARMUP:]
    if "profile" in r0:
        log(r0["profile"])
        log(f"dp train step profile [{smi}]: rank 0 device busy {r0['busy_ms']:.3f} ms a step "
            f"(profiler, device events other than NCCL's), NCCL kernels {r0['nccl_device_ms']:.3f} "
            f"ms on the device (waiting for the other ranks included), the backend's collective "
            f"records {r0['collective_host_ms']:.3f} ms on the host; idle share of a timed step "
            f"1 - {r0['busy_ms']:.3f} / {host_ms:.3f} ms = {1 - r0['busy_ms'] / host_ms:.3f}")
    failed = []
    if step1 > DP_LOSS_RTOL:
        failed.append(f"step-1 loss differs by {step1:.3e}")
    if dp_vs_1 > tol:
        failed.append(f"parameters differ by {dp_vs_1:.3e} > {tol:.3e}")
    if not same:
        failed.append("the ranks' parameters differ")
    if launches != [want] * n:
        failed.append(f"exact kernel launches {launches}, want {want} a rank")
    if coll.get("grads") != 1 or coll.get("psum_autograd") != DP_BN_LAYERS or coll.get(
            "psum_autograd_backward") != DP_BN_LAYERS:
        failed.append(f"collectives a step {coll}")
    if not all(np.isfinite(timed)) or not timed[-1] < timed[0]:
        failed.append(f"timed losses not finite or not falling: {timed}")
    if failed:
        raise AssertionError("dp: " + "; ".join(failed))
    return sum(launches)


def dp_cli_data(d: str, seed: int) -> None:
    """The phase-15 DGB file (for ``--dp-only``, which skips phase 15)."""
    run_subprocess(["-m", "dgcnn_tpu_torch.io.convert", "synth", "events.dgb", "--events",
                    str(CLI_EVENTS), "--points", str(TRAIN_N), "--fixed_length", "--seed",
                    str(seed)], d)


def phase_dp_cli(torch, d: str, seed: int, smi: str, n: int) -> None:
    """Phase 16's command line: ``train -nd n`` from phase 15's DGB file
    (DP_CLI_STEPS steps, a report and a checkpoint), ``--auto_resume`` to
    DP_CLI_RESUME_TO, ``inference -nd n`` from its checkpoint, against one
    process's `Trainval.inference` on each rank's rows."""
    from dgcnn_tpu_torch.config import parse_args
    from dgcnn_tpu_torch.io import BucketBatcher
    from dgcnn_tpu_torch.io.dgb import DGBIO
    from dgcnn_tpu_torch.train.checkpoint import adopt_model_flags
    from dgcnn_tpu_torch.train.trainval import Trainval

    p = lambda *names: os.path.join(d, "dp", *names)  # noqa: E731
    data = ["-io", "dgb", "-if", os.path.join(d, "events.dgb"), "-np", str(TRAIN_N), "-mn",
            "residual-dgcnn", "-k", str(K), "--edge_filters", *[str(EDGE_WIDTH)] * EDGE_BLOCKS,
            "--seed", str(seed), "-nd", str(n)]
    train = ["train", *data, "-mb", str(n), "-wp", p("w", "snap"), "-ld", p("log")]
    t0 = time.perf_counter()
    out = run_cli(torch, train + ["-i", str(DP_CLI_STEPS), "-rs", str(DP_CLI_STEPS // 2), "-cs",
                                  str(DP_CLI_STEPS)], tee=True)
    train_s = time.perf_counter() - t0
    backend = re.search(r"data parallel: .*", out)
    log(f"dp cli: {backend.group(0) if backend else 'no data-parallel line'}")
    _, rows = read_csv_log(p("log", "train_log.csv"))
    iters = [int(r["iter"]) for r in rows]
    if iters != [DP_CLI_STEPS // 2, DP_CLI_STEPS] or os.listdir(p("log")) != ["train_log.csv"]:
        raise AssertionError(f"dp cli train: log rows {iters}, files {os.listdir(p('log'))}")
    if not os.path.exists(p("w", f"snap-{DP_CLI_STEPS}.ckpt")):
        raise AssertionError(f"dp cli train: no checkpoint at step {DP_CLI_STEPS}")
    t0 = time.perf_counter()
    run_cli(torch, train + ["-i", str(DP_CLI_RESUME_TO), "-rs", "2", "-cs", "0",
                            "--auto_resume"])
    resume_s = time.perf_counter() - t0
    _, rows = read_csv_log(p("log", "train_log.csv"))
    iters = [int(r["iter"]) for r in rows]
    want = [DP_CLI_STEPS // 2, DP_CLI_STEPS] + list(range(DP_CLI_STEPS + 2, DP_CLI_RESUME_TO + 1, 2))
    if iters != want or not all(np.isfinite(float(r["loss"])) for r in rows):
        raise AssertionError(f"dp cli resume: log rows {iters}, want {want}")
    if not os.path.exists(p("w", f"snap-{DP_CLI_RESUME_TO}.ckpt")):
        raise AssertionError(f"dp cli resume: no checkpoint at step {DP_CLI_RESUME_TO}")
    serve_b = n * max(1, CLI_SERVE_B // n)
    t0 = time.perf_counter()
    run_cli(torch, ["inference", *data, "-mb", str(serve_b), "-mp", p("w", "snap"), "-of",
                    p("pred.npz"), "-ld", p("ilog")])
    serve_s = time.perf_counter() - t0
    if os.listdir(p("ilog")) != ["inference_log.csv"]:
        raise AssertionError(f"dp cli inference: log files {os.listdir(p('ilog'))}")
    pred = np.load(p("pred.npz"))
    ids, off = pred["event_ids"], pred["offsets"]
    if ids.tolist() != list(range(CLI_EVENTS)) or not np.all(np.diff(off) == TRAIN_N):
        raise AssertionError(f"dp pred.npz: events {ids.tolist()}, sizes {np.diff(off)}")
    # one process, each rank's rows of every batch
    icfg = adopt_model_flags(parse_args(["inference", "-mb", str(serve_b), "-mp",
                                         p("w", "snap")]), p("w", "snap"))
    tv = Trainval(icfg)
    state, _ = tv.restore_for_eval(tv.initialize(4), p("w", "snap"))
    reader = DGBIO(os.path.join(d, "events.dgb")).initialize()
    mismatched, worst = 0, 0.0
    rows_a_rank = serve_b // n
    for batch in BucketBatcher(reader, serve_b, shuffle=False, seed=icfg.seed).epoch():
        for r in range(n):
            sl = slice(r * rows_a_rank, (r + 1) * rows_a_rank)
            scores, pr, _ = tv.inference(state, (batch.points[sl], batch.labels[sl], None,
                                                 batch.mask[sl]))
            for j, eid in enumerate(batch.event_ids[sl]):
                lo, hi = off[eid], off[eid + 1]
                mismatched += int((pr[j].cpu().numpy()[: hi - lo]
                                   != pred["prediction"][lo:hi]).sum())
                worst = max(worst, float(np.abs(scores[j, : hi - lo].cpu().numpy()
                                                - pred["scores"][lo:hi]).max()))
    reader.finalize()
    log(f"dp cli [{smi}]: train -nd {n} {DP_CLI_STEPS} steps in {train_s:.1f} s, --auto_resume to "
        f"{DP_CLI_RESUME_TO} in {resume_s:.1f} s, inference -nd {n} of {CLI_EVENTS} events in "
        f"{serve_s:.1f} s (host clock, rank start-up included); one log, checkpoints at "
        f"{DP_CLI_STEPS} and {DP_CLI_RESUME_TO}; pred.npz holds every event once; against one "
        f"process on each rank's rows: {mismatched} predictions differ, max |score diff| "
        f"{worst:.3e}")
    if mismatched or worst > 1e-6:
        raise AssertionError("dp cli inference disagrees with one process")


def per_shape(per_launch) -> dict:
    """Per-launch means of the times by channel count C."""
    out = {}
    for c in sorted({t["c"] for t in per_launch}):
        ts = [t for t in per_launch if t["c"] == c]
        out[f"C={c}"] = {key: sum(t[key] for t in ts) / len(ts) for key in TIME_KEYS}
    return out


def log_per_shape(label, per_launch, smi: str) -> None:
    mean = {key: sum(t[key] for t in per_launch) / len(per_launch) for key in TIME_KEYS}
    shapes = {**per_shape(per_launch), f"mean of {len(per_launch)}": mean}
    for shape, ts in shapes.items():
        log(f"{label} per launch, {shape} [{smi}]: " + " ".join(f"{k}={v:.4f}" for k, v in ts.items()))


def kernel_entry(name, source, replaces, launches, per_launch, shape, extra_err=0.0):
    """One ``kernels`` entry: per-launch means over a forward's graph
    builds, on the inputs that forward gave the kernel."""
    mean = {key: sum(t[key] for t in per_launch) / len(per_launch) for key in TIME_KEYS}
    entry = {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max([extra_err] + [t["max_abs_err"] for t in per_launch]),
        "ms": mean["wrapper_ms"],  # operand build + kernel, as plain_ms
        "plain_ms": mean["plain_ms"],
        "bound_ms": mean["bound_ms"],
        "bound_by": per_launch[-1]["bound_by"],
        "library_ms": mean["library_ms"],
        "kernel_only_ms": mean["kernel_ms"],  # on prebuilt operands
        "shape": shape,
    }
    if "c" in per_launch[0]:
        entry["per_shape_ms"] = {s: {"ms": ts["wrapper_ms"], "kernel_only_ms": ts["kernel_ms"],
                                     "bound_ms": ts["bound_ms"], "plain_ms": ts["plain_ms"],
                                     "library_ms": ts["library_ms"]}
                                 for s, ts in per_shape(per_launch).items()}
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--cp-only", action="store_true",
                    help="phases 1, 2, 10 and 11 only (the CP path across cards), no kernels line")
    ap.add_argument("--dp-only", action="store_true",
                    help="phases 1, 2 and 16 only (data parallelism over every visible card), "
                    "no kernels line")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 2
    from dgcnn_tpu_torch.kernels import _build
    from dgcnn_tpu_torch.kernels import knn_banded_cuda as bmod
    from dgcnn_tpu_torch.kernels import knn_cuda as kmod
    from dgcnn_tpu_torch.kernels import ring_knn_cuda as rmod
    from dgcnn_tpu_torch.train.trainval import disable_tf32

    # phase 1: device
    smi = nvidia_smi()
    disable_tf32()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # phase 2: build, one nvcc per source, started together
    t0 = time.perf_counter()
    names = ("knn", "knn_banded", "ring_knn")
    _build.load_many(names)
    log(f"build: {', '.join(f'csrc/{n}.cu' for n in names)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)}, in parallel; csrc/knn_sweep.cuh and "
        f"csrc/warp_topk.cuh built into all three)")
    for name in names:
        for line in _build.build_logs.get(name, "(library reused)").splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error", "reused")):
                log(f"  {name}: {line.strip()}")
            if "spill" in line and any(int(v) for v in re.findall(r"(\d+) bytes", line)):
                raise AssertionError(f"csrc/{name}.cu: ptxas reports a stack frame or a spill")
    log("kernels: knn_cuda (csrc/knn.cu; self form knn_cuda, cross form knn_cuda_cross), "
        "knn_banded_cuda (csrc/knn_banded.cu; self form knn_banded_cuda, cross form "
        "knn_banded_cuda_cross), ring_knn_cuda (csrc/ring_knn.cu; one launch a ring step)")

    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    if args.cp_only or args.dp_only:
        if args.cp_only:
            ranks, cp_evts = phase_cp_serving(torch, args.seed, smi, args.profile)
            phase_cp_vs_single(torch, kmod, ranks, cp_evts)
        if args.dp_only:
            n = dp_ranks(torch)
            with tempfile.TemporaryDirectory(prefix="smoke-dp-", dir=os.path.join(root, "build")) as d:
                phase_dp(torch, kmod, args.seed, smi, args.profile, n, d)
                dp_cli_data(d, args.seed)
                phase_dp_cli(torch, d, args.seed, smi, n)
        log(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0

    # phase 3: exact kernel vs plain
    err = phase_kernel_vs_plain(torch, kmod, args.seed, smi)
    # phase 4: banded kernel vs plain
    banded_err = phase_banded_vs_plain(torch, bmod, args.seed)

    # phase 5: serving path, 4 x 4096, exact graph build
    launches, per_launch, serve_pps = phase_serving(torch, kmod, args.seed, smi, args.profile)
    phase_small_reference(torch, args.seed)

    # phase 6: long events, banded graph build
    banded_launches, banded_per_launch = phase_long_events(
        torch, kmod, bmod, args.seed, smi, args.profile)
    # phases 7 and 8: the banded model against its references
    phase_full_window_is_exact(torch, kmod, bmod, args.seed)
    phase_small_banded_reference(torch, args.seed)

    # phase 9: ring kernel vs plain, one process, virtual owners
    ring_err = phase_ring_vs_plain(torch, kmod, rmod, args.seed, smi)
    # phase 10: CP serving on CP_P ranks
    ranks, cp_evts = phase_cp_serving(torch, args.seed, smi, args.profile)
    ring_launches = sum(r["main_launches"][0] for r in ranks)
    # phases 11 and 12: against the single-device model, and the kernel on
    # the main path's inputs
    captured = phase_cp_vs_single(torch, kmod, ranks, cp_evts)
    ring_per_launch = phase_ring_on_main_path(torch, kmod, rmod, captured, smi)
    # phase 13: all three kernels at a width past one shared-memory pass and
    # a k past one list pass
    wide_err = phase_wide_and_long_k(torch, kmod, bmod, rmod, args.seed, smi)
    # phase 14: the train step, 1 x 16384, exact graph build
    train_launches, train_per_launch, train_ms = phase_train(
        torch, kmod, args.seed, smi, args.profile)
    with tempfile.TemporaryDirectory(prefix="smoke-cli-", dir=os.path.join(root, "build")) as d:
        # phase 15: the command line, train / resume / inference from a DGB file
        cli_launches = phase_cli(torch, kmod, bmod, rmod, args.seed, smi, train_ms, serve_pps, d)
        # phase 16: data parallelism on every card (two ranks on one card),
        # then its command line on phase 15's DGB file
        n = dp_ranks(torch)
        dp_launches = phase_dp(torch, kmod, args.seed, smi, args.profile, n, d)
        phase_dp_cli(torch, d, args.seed, smi, n)

    # the kernels line: per-launch means over the six graph builds of one
    # served forward (C=4 once, C=64 five times), on the inputs it gave;
    # the exact kernel's launches count both of its main paths (serving and
    # the train step), and its entry adds the train shape's times
    knn_entry = kernel_entry(
        "knn_cuda", "dgcnn_tpu_torch/csrc/knn.cu", "dgcnn_tpu/kernels/knn_pallas.py:52",
        launches + train_launches + cli_launches + dp_launches, per_launch,
        f"mean per launch over one served forward's {len(per_launch)} graph builds, "
        f"B={B} N={N} k={K}, C=4 once and C={EDGE_WIDTH} {len(per_launch) - 1} times; "
        f"train_shape_ms: step 1's graph builds of the train step, B=1 N={TRAIN_N}",
        extra_err=max([err, wide_err["knn"]] + [t["max_abs_err"] for t in train_per_launch]),
    )
    knn_entry["launches_by_path"] = {"serve": launches, "train": train_launches,
                                     "cli": cli_launches, "dp": dp_launches}
    knn_entry["train_shape_ms"] = {
        shape: {"ms": ts["wrapper_ms"], "kernel_only_ms": ts["kernel_ms"],
                "bound_ms": ts["bound_ms"], "plain_ms": ts["plain_ms"],
                "library_ms": ts["library_ms"]}
        for shape, ts in per_shape(train_per_launch).items()}
    entries = [
        knn_entry,
        kernel_entry(
            "knn_banded_cuda", "dgcnn_tpu_torch/csrc/knn_banded.cu",
            "dgcnn_tpu/kernels/knn_banded.py:86", banded_launches, banded_per_launch,
            f"mean per launch over one long-event forward's {len(banded_per_launch)} graph "
            f"builds, B=1 N={LONG_N} k={K} W={LONG_W}, C=4 once and C={EDGE_WIDTH} "
            f"{len(banded_per_launch) - 1} times; library_ms is a strip loop of matmul + band "
            f"mask + torch.topk (no one PyTorch call computes a banded top-k)",
            extra_err=max(banded_err, wide_err["banded"]),
        ),
        kernel_entry(
            "ring_knn_cuda", "dgcnn_tpu_torch/csrc/ring_knn.cu",
            "dgcnn_tpu/kernels/ring_knn_rdma.py:72", ring_launches, ring_per_launch,
            f"mean per launch over the {len(ring_per_launch)} graph builds of a served forward, "
            f"B=1 N={CP_N} over P={CP_P} shards of {CP_N // CP_P} (rank 0's ring order, virtual "
            f"owners), k={K}, C=4 once and C={EDGE_WIDTH} {len(ring_per_launch) - 1} times; "
            f"launches: all {CP_P} ranks over {len(cp_evts)} served events ({EDGE_BLOCKS * CP_P} "
            f"an event on each rank); ms is the wrapper's work per launch (operand build of the "
            f"shard, P merges, finish) / P; library_ms is matmul + torch.topk + sort merge per block",
            extra_err=max(ring_err, wide_err["ring"]),
        ),
    ]

    log(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
