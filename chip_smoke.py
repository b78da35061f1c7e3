#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dgcnn_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--profile]

Phases, each fatal on failure (nonzero exit, no result line):

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, both TF32 flags.
2. Build: the hand-written kernels ``dgcnn_tpu_torch/csrc/knn.cu``,
   ``csrc/knn_banded.cu`` and ``csrc/ring_knn.cu`` (all three with the
   shared headers ``csrc/knn_sweep.cuh`` and ``csrc/warp_topk.cuh``, and
   with the Hopper TC pipeline ``csrc/knn_tc.cuh`` and its PTX wrappers
   ``csrc/sm90.cuh``: the exact ``knn_tc_kernel``, the ring's
   ``ring_tc_kernel`` and the banded ``banded_tc_kernel``), one nvcc each,
   started together, timed, with ptxas's register and spill report for
   each kernel instantiation; a spill or a stack frame fails.
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

17. Mixed precision (``--precision bfloat16 --knn_precision default
   --remat``; the kernels' tensor-core (TC) forms: the Hopper kernels of
   ``csrc/knn_tc.cuh`` (TMA, mbarriers, wgmma; the exact pass, the ring
   step and the banded pass) where `knn_cuda.tc_kernel_for` routes a
   launch to them (one pass of k <= 64 at padded widths up to TC_MAX_C2),
   else the sweep's TC instantiation ``sweep_tc``, bf16 ``mma.sync``, the
   bit reference). The TC exact, banded and ring kernels against their
   plain versions (the same bf16-rounded operands through an fp32 matmul)
   on phase 3's, 4's, 9's and 13's inputs and their all-equal forms: 0
   hard mismatches by the rounded scores (`ops.knn.split_score_mismatches`,
   rtol TC_RTOL of a score's sum of absolute terms), identical ``valid``,
   0 slots out of the (score desc, index asc) order of the kernel's own
   scores, the lowest indices on the all-equal inputs, the ring equal to
   the exact TC kernel index for index, the banded pass at W >= N equal to
   the exact TC kernel's graph and scores. Every check also holds the
   Hopper form against ``sweep_tc`` on the same input (indices, valid
   flags and scores ``==``: the exact kernel forced to sweep_tc, every
   ring step and every banded pass forced to it), the banded cross form
   with nonzero ``q_base`` and ``key_base`` included; the exact Hopper
   kernel also runs on phase 4's and 9's inputs, and all three at the
   Hopper kernels' widest width (C = TC_MAX_C2 - 2; the exact kernel at k
   = 20 and 64). The flagship
   model trains on one 131,072-point event with the three flags (2
   warm-up + 5 timed steps): exactly 6 Hopper TC launches a step, none of
   ``sweep_tc`` and no fp32 one (remat keeps the indices), a finite
   falling loss, ms a step, points/s and peak memory, and the same steps
   without remat, whose peak must be higher; on step 1's six graph-build
   inputs the Hopper kernel equal to ``sweep_tc`` over the whole event
   and against `knn_plain` on 4096 query rows against all keys, the share
   of neighbour slots that differ from the fp32 kernel's graph (printed),
   times at C=4 and C=64 (the Hopper kernel and ``sweep_tc`` alone in
   turns), and the ring TC kernel over 4 virtual owners of each input
   (every rank == its steps on sweep_tc; the Hopper step and sweep_tc
   alone in turns).
   The same flags at 1 x 16,384 beside phase 14's f32 flags (ms, peak,
   losses printed). A ``python3 -m dgcnn_tpu_torch train --precision
   bfloat16 --knn_precision default --remat -i 2`` subprocess on phase
   15's DGB file, its
   checkpoint served through ``cli.main inference`` (6 TC launches a
   batch). Serving in bf16 + default: a 4 x 4096 batch (6 TC launches, the
   kernel checked and timed on its six inputs) and a 1,048,576-point event
   with ``knn_window=8192`` (6 banded Hopper TC launches and no sweep_tc,
   fp32 or exact one; the pass checked on its six inputs, == sweep_tc, and
   the two timed alone in turns), and one 131,072-point CP event on 4
   ranks (on each rank 24 ring Hopper TC launches and no sweep_tc, fp32 or
   exact one; the first graph of all ranks equal to the exact TC kernel's
   over the whole event). ``--profile`` adds a table
   of one 131,072-point bf16 remat step, its device time and idle share.

18. Long events on one card (the flagship, seeded weights, `SyntheticIO`):
   the f32 train step on one 131,072-point event with phase 14's flags (2
   warm-up + 3 timed steps): 6 exact-kernel launches a step and the
   streamed `GatheredStats` forward in all 6 blocks (`ops.edge.
   stream_runs`), ms a step, points/s, peak memory; on step 1's graph,
   pinned, the loss and gradients with the dense traversal
   (``SLOT_STREAM_ELEMS`` raised) against the streamed step's
   (`compare_pinned`: the loss and each parameter group's gradients
   within PIN_SPREAD_FACTOR times the gap of the dense form on the event
   in a random point order, at least PIN_RTOL); the train step's exact
   kernel call checked on the whole event against the plain version and
   timed, on step 1's inputs at C=4 and C=64. The f32 banded train step with ``--remat`` on one
   1,048,576-point event, W=8192: 6 banded launches a step and no exact
   one, the streamed head in train mode once a step, the streamed block
   forward twice a block (remat's recompute); on step 1's graph the
   streamed head's loss and gradients against the dense head's (the same
   rule); the
   banded kernel checked and timed on step 1's inputs. bf16 serving
   (``--precision bfloat16 --knn_precision default``) of a full and a
   padded 4,194,304-point event, W=8192: per event 6 banded Hopper TC
   launches, the edge form's slot stream in all 6 blocks
   (`models.dgcnn.block_forms`), the streamed head once; ms an event,
   valid points/s, peak; the TC pass checked and timed on its first two
   inputs; on a padded 2,097,152-point event (past the line too; the dense
   form does not fit at 4M) the same forward with the dense edge form on
   one graph (predictions on at least BF16_PRED_SHARE of the valid points,
   logits within BF16_LOGIT_TOL of the largest).
19. Banded CP serving: a full and a padded 1,048,576-point event over 4
   ranks (`run_point_ranks`, as phase 10), W=8192, in f32 and with
   ``--knn_precision default``: on each rank the banded kernel's cross
   form 6 times an event and no exact or ring launch, identical packed
   outputs on all ranks, the first graph over the ranks equal to the
   one-device banded kernel's on the valid rows (0 hard mismatches),
   predictions equal to the one-device banded model's and scores within
   CP_SCORE_TOL (1e-5 in f32, 1e-3 with the bf16 score); every block's
   graph of the full event against the one-device model's (printed), and
   the one-device model on the ranks' graphs within 1e-5 with equal
   predictions; ms an event, whether the ranks share a card; the cross
   form checked and timed on rank 1's halo operands.
20. Context-parallel training of the flagship (`run_point_ranks`: gloo on
   one card with staged collectives, NCCL with a card a rank), from the
   seeded init with Adam at 1e-3: the exact ring over CP_P ranks on one
   CP_N-point event, ``--ring_impl rdma`` in f32 (the ring kernel) and in
   bf16 with ``--knn_precision default --remat`` (the ring TC kernel; the
   edge form through the differentiable ring gather), CP_TRAIN_WARMUP +
   CP_TRAIN_STEPS steps each, and one step each with ``--ring_impl
   ppermute`` (the exact kernel's cross form, f32 and TC); banded CP,
   W=LONG_W, on one BANDED_TRAIN_N-point event over BANDED_TRAIN_P ranks in
   f32 with ``--remat`` (the banded kernel's cross form) and on one
   LONG_N-point event over CP_P ranks in bf16 with ``--knn_precision
   default --remat`` (its TC form). For each run, on every rank: the
   kernel's launches a step (the counts set to 0 before the steps and
   read after; no other kernel), the parameters after the steps identical
   (a digest), a finite loss that falls over the timed steps; ms a step,
   points/s, peak memory a rank, the collectives and their bytes a step,
   forward and backward; on a banded run, every rank's halo exchange
   backward at the run's block shape and dtype against the cotangents the
   plain exchange sends home, bit for bit (`halo_backward_check`). On
   step 1's graph over the ranks, pinned, the CP
   objective and global gradient (`Trainval.loss_and_grads`) against one
   device's (`compare_pinned`: the loss and each parameter group within
   PIN_SPREAD_FACTOR times the gap of one device on the event in a random
   point order, the loss at least CP_TRAIN_LOSS_RTOL, the groups at least
   PIN_RTOL of the largest gradient entry; bf16 by L2 distances, at least
   BF16_LOSS_RTOL and BF16_GRAD_SHARE, with the reference's global pool on
   the ranks' tie rule, `shard_pool`); the run's kernel checked against
   its plain version and timed on data rank 0's rows of the one-device
   forward's first two graph-build inputs (the ring over the run's point
   ranks as virtual owners, the cross form on rank 0's queries against
   rank 1's block, the halo cross form on rank 1's operands).
21. The ``data x points`` mesh: MESH_DATA x MESH_POINTS ranks (`run_ranks`)
   train on two CP_N-point events, one step, checked as a phase-20 run;
   then the command line on phase 15's DGB file: ``train -nd 4 -ps 2``
   (CP_CLI_STEPS steps, a report at half and a checkpoint at the end; one
   log, written by world rank 0 alone) and ``inference -nd 2 -ps 2`` from
   the checkpoint with write-back (CP_CLI_SERVE_BATCHES batches), whose
   predictions must equal one process's inference of the checkpoint and
   its scores be within CP_SCORE_TOL.

22. Export: phase 5's and phase 6's flagship models (seeded) saved with
   `train.checkpoint.save`, then ``export`` through the command line in
   this process (`cli.main`): (a) f32 exact at ``-mb 4``; (b) the same at
   ``-mb 0`` (a symbolic batch); (c) ``--precision bfloat16
   --knn_precision default`` at ``-mb 4``; (d) banded at 1 x LONG_N,
   ``--knn_window`` LONG_W, ``-mb 1``; (e) (d) with (c)'s flags. Each
   artifact's graph must hold six registered graph-build operators
   (``dgcnn_tpu_torch::knn`` or ``::knn_banded``) and no inlined top-k;
   loaded with `load_exported`, it serves phase 5's batches ((b) also one
   event of the first and the last batch) or one full and one padded
   long event: its scores within 1e-6 of `Trainval.inference`'s, the
   argmax on valid points identical, and each served batch must launch
   the hand-written kernel of its row exactly six times (fp32 exact for
   (a) and (b), the exact Hopper TC kernel for (c), fp32 banded for (d),
   the banded Hopper TC pass for (e)) and no other. It prints each
   export's seconds, the artifact's MB and ms a batch served from the
   artifact beside live inference (host clock).
23. The exact kNN's Hopper fp32 kernel (``csrc/knn_hopper.cuh``, which
   `knn_cuda.f32_kernel_for` routes every one-pass fp32 build to) against
   the fp32 sweep, forced (``launch_operands(..., kernel="hopper" |
   "sweep")``), idx, valid and scores ``==``: on the six graph-build
   inputs of step 1 of the f32 train step at 1 x 131,072 (C=4 and C=64;
   the three steps must launch the Hopper kernel 18 times and the sweep
   never), on the six of a served 4 x 4096 forward of the padded
   variable-length batch at the key split S forced to 1 and 2, and, by
   phase 3 (whose `check_knn` holds every Hopper launch to the sweep),
   on the ragged inputs with 13 and 0 valid points, the all-equal input
   and the cross form. Times of the wrapper and of both forms alone, in
   turns, beside the bound. ``--f32-only`` runs phases 1, 2 and 23 alone.
   Phase 2's ptxas report covers ``knn_topk_kernel_hopper``: a spill or
   a stack frame fails.
24. The fused depth-2 EdgeConv block's kernels (``csrc/edge_mlp.cu``,
   `kernels.edge_mlp_cuda`: the stats pass, the forward, the backward and
   the stats backward) at the segmentation cell's shape (32 x 4096, k=20,
   C=64, the first conv from C_in 4 and 64, the exact kernel's graph,
   the query weights the train step passes: its mask as float32, every
   row valid, and at C_in 64 also ragged, 4096 down to 166 valid points
   an event and one event of none): each against its plain version
   (within 1e-4 of the largest entry,
   winners equal but at near ties; in float64, the backward under BN1's
   relu masks as float32 rounds them, which are the kernel's bits), each
   timed alone beside the
   plain version and its bound (2 E C^2 operations a product at the fp32
   FMA peak, or its bytes), then one train step of the segmentation
   network (blocks of MLP depth 2, 2 and 1) at that shape under ``auto``
   and under ``edge`` in turns: ms a step, peak GiB, the forms and the
   kernels' launches (8 a step; the kernels line counts those of the
   timed steps under ``auto``). ``--edge-mlp-only`` runs phases 1, 2 and
   24 alone. Phase 2's ptxas report covers its four kernels.

The line before the last is the ``{"kernels": [...]}`` JSON (every entry
with its per-shape times; the exact kernel's ``launches`` counts its
main paths, serving in phase 5, training in phase 14, the command line
in phase 15 and data-parallel training in phase 16, split in
``launches_by_path``, and ``train_shape_ms`` holds its times at the train
shape; the three TC entries, ``knn_cuda_tc``, ``knn_banded_cuda_tc`` and
``ring_knn_cuda_tc`` (the Hopper kernels, each with ``sweep_tc``'s time
alone beside it, ``sweep_tc_kernel_only_ms``), are phase 17's, bound at
the bf16 tensor-core peak, the exact one's ``train_shape_ms`` at 1 x
131,072); the last line
is ``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this script, it exits nonzero and prints no result.
``--profile`` adds torch.profiler tables of one served 4 x 4096 batch, of
one long-event forward, of rank 0's CP forward and of one train step.
``--cp-only`` runs
phases 1, 2, 10 and 11 alone and prints no kernels line: the check of the
CP path on a machine with a card for each rank (NCCL). ``--dp-only`` runs
phases 1, 2 and 16 alone (its own DGB file), no kernels line: data
parallelism over every card of a machine with several (NCCL).
``--prec-only`` runs phases 1, 2 and 17 alone (its own DGB file) and logs
the three TC kernels' entries, no kernels line. ``--long-only`` runs
phases 1, 2, 18 and 19 alone, no kernels line. Phases 18 and 19 add to
the kernels line: the exact kernel's launches at 1 x 131,072 f32
(``train_131072_f32_ms``), the banded kernel's on the 1M banded train step
and on the banded CP path (``train_1048576_f32_ms``, ``halo_cross_ms``),
the banded TC pass's on 4M bf16 serving and banded CP with
``--knn_precision default`` (``serve_4194304_bf16_ms``,
``halo_cross_ms``), each split in ``launches_by_path``. Phases 20 and 21
add each row's launches on its CP train paths (``launches_by_path``'s
``cp_train_*`` entries: all six rows) and its per-shape times there
(``cp_train_ms``). ``--cp-train-only`` runs phases 1, 2, 20 and 21 alone
(its own DGB file) and logs those paths, no kernels line. Phase 22 adds
the launches of the served artifacts to rows 1, 1D, 2 and 2D
(``launches_by_path["export"]``); ``--export-only`` runs phases 1, 2 and
22 alone and logs them, no kernels line.
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
# the dense bf16 tensor-core peak (the same data sheet): the bound of the
# kernels' TC instantiations (--knn_precision default)
BF16_PEAK_FLOPS = 989e12

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
# mixed precision (phase 17): the flagship train step at one 131,072-point
# event with --precision bfloat16 --knn_precision default --remat, warm-up
# and timed steps; the query rows of the 131,072-key check of the exact TC
# kernel against knn_plain; the TC scores' tolerance against the plain
# version's, relative to a score's sum of absolute terms (the tensor
# cores sum the same exact bf16 products in another order: a few units of
# the last place of that sum; bf16 rounding of the operands moves a score
# by ~4e-3 of it, so the fp32 score would fail this)
PREC_N, PREC_WARMUP, PREC_STEPS, PREC_SLICE = 131_072, 2, 5, 4096
TC_RTOL = 1e-4
PREC_SMALL_STEPS = 10
# long events (phases 18, 19): the f32 train step at 131,072 points (exact
# graph) and at 1,048,576 (banded, --remat), warm-up and timed steps; bf16
# serving at 4,194,304 points; banded CP serving at 1,048,576 points over
# CP_P ranks. PIN_RTOL, PIN_SPREAD_FACTOR, PIN_GROUPS: a streamed step
# against the dense one on one pinned graph (`compare_pinned`): the loss
# relative, and each parameter group's largest gradient difference over
# the largest gradient entry. The streamed sums reassociate the BN
# statistics and the head's sums over points, and a gradient through
# train-mode BN is a sum over every point whose terms nearly cancel, so
# f32 rounding moves it far more than the loss: the loss and each group
# are held at PIN_SPREAD_FACTOR times the gap that reassociation alone
# makes in the same run, the dense form on the same event with its points
# in a random order (every sum over points in another order), and at
# least PIN_RTOL.
# The bf16 edge
# stream against the dense edge form: predictions on at least
# BF16_PRED_SHARE of the valid points, logits within BF16_LOGIT_TOL of the
# largest (the stream rounds each block's max to bf16 before the residual,
# the dense form after: one bf16 unit is 2^-8 of a value, and six blocks
# and the head carry it on), on a padded event of BF16_DENSE_N points: at
# 4,194,304 the dense bf16 edge form asked for 20 GiB more on 54 GiB
# allocated (its BN outputs of the (N, k, C) tensor are f32).
# CP_SCORE_TOL: banded CP's scores against one device's, by knn precision.
# With the bf16 score a last-bit change of a block's features (each rank's
# matmuls run at another shape than one device's) can flip the bf16
# rounding of an operand and so a near-tied neighbour of the later blocks'
# graphs (2.6e-4 measured on the card, no prediction changed). Phase 19
# shows it: it prints where the graphs first differ, and holds the
# one-device model on the ranks' graphs at the f32 limit; the first
# graph, built from the points themselves, is checked for equality.
LONG_TRAIN_N, LONG_WARMUP, LONG_STEPS = 131_072, 2, 3
SERVE_BF16_N, BF16_DENSE_N, BANDED_CP_N = 4_194_304, 2_097_152, 1_048_576
PIN_RTOL, PIN_SPREAD_FACTOR = 1e-4, 3.0
PIN_GROUPS = {
    "blocks": lambda p: p["blocks"],
    "head feature conv": lambda p: p["head"]["feat"],
    "head past the pool": lambda p: [p["head"]["mlp"], p["head"]["out"]],
}
BF16_PRED_SHARE, BF16_LOGIT_TOL = 0.999, 2.0**-4
CP_SCORE_TOL = {"highest": 1e-5, "default": 1e-3}
# context-parallel training (phases 20, 21): warm-up and timed steps of the
# main runs; the banded f32 event and its rank count; the data x points
# mesh; the command line's steps and served batches on the mesh
CP_TRAIN_WARMUP, CP_TRAIN_STEPS = 2, 3
BANDED_TRAIN_N, BANDED_TRAIN_P = 2_097_152, 2
MESH_DATA, MESH_POINTS = 2, 2
CP_CLI_STEPS, CP_CLI_SERVE_BATCHES = 4, 4
# the CP step-1 loss against one device's on the pinned graph (at least
# PIN_SPREAD_FACTOR times the witness's gap: at 2,097,152 points one
# device's own loss moves by 2.35e-5 when the points come in another
# order), and the floors of bf16 runs (`compare_pinned`; this script's
# own: the CPU tests hold bf16 by the largest entry). On the card the
# clean bf16 runs read at most 2.67e-2 of the gradient norm; a dropped
# ring-gather cotangent read 0.576 (it fails); a dropped halo cotangent
# moved the banded bf16 run from 5.71e-3 to 6.07e-3, inside bf16's own
# spread whatever the metric, so `halo_backward_check` holds the halo
# exchange's backward bit for bit (and the f32 banded run fails with it:
# 1.197e-3 against a limit of 5.10e-4)
CP_TRAIN_LOSS_RTOL, BF16_LOSS_RTOL, BF16_GRAD_SHARE = 1e-5, 1e-3, 0.05
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


def phase_kernel_vs_plain(torch, kmod, seed: int, smi: str, precision: str = "highest") -> float:
    """Kernel vs plain on ragged random inputs at the main path's shapes,
    self and cross forms (``precision="default"``: the TC kernel); returns
    the largest score difference."""
    dev = torch.device("cuda")
    err = 0.0
    pr = dict(precision=precision)
    tc = " TC" if precision == "default" else ""
    for c in (4, EDGE_WIDTH):
        x, mask = ragged_inputs(seed, c)
        xt = torch.tensor(x, device=dev)
        mt = torch.tensor(mask, device=dev)
        err = max(err, check_knn(torch, kmod, f"random C={c} self", xt, xt, mt, x, **pr))
        # cross form, Nq != Nk: the first 1000 rows against all keys
        xq = xt[:, :1000].contiguous()
        err = max(err, check_knn(torch, kmod, f"random C={c} cross", xq, xt, mt,
                                 x[:, :1000], xk_np=x, cross=True, **pr))
        # every valid point one point: only the tie rule picks the keys
        xe_np = all_equal(x, mask)
        xe = torch.tensor(xe_np, device=dev)
        err = max(err, check_knn(torch, kmod, f"all-equal C={c} self", xe, xe, mt, xe_np, ties=True,
                                 **pr))
        err = max(err, check_knn(torch, kmod, f"all-equal C={c} cross", xe[:, :1000].contiguous(),
                                 xe, mt, xe_np[:, :1000], xk_np=xe_np, cross=True, ties=True, **pr))
        t = time_knn(torch, kmod, xt, mt, precision)
        log(f"knn{tc} timing, random inputs B={B} N={N} C={c} k={K} [{smi}]: {fmt_times(t)}")
    return err


def library_knn(torch, kmod, x, mask, precision: str = "highest", xq=None):
    """The yardstick: the same augmented operands, one matmul (fp32, or
    bf16 for ``precision="default"``) and ``torch.topk`` (no tie rule).
    Never called by the port."""
    qa, ka = kmod.build_augmented_operands(x if xq is None else xq, x, mask, precision)
    if precision == "default":
        qa, ka = qa.to(torch.bfloat16), ka.to(torch.bfloat16)
    return torch.topk(torch.matmul(qa, ka.transpose(-1, -2)), K, dim=-1)


def time_knn(torch, kmod, x, mask, precision: str = "highest") -> dict:
    """CUDA-event times on one input ``(x, mask)`` of the wrapper (operand
    build + kernel), the plain version and the library yardstick, all from
    ``(x, mask)``; of the kernel alone on prebuilt operands (for the TC
    kernel its bf16 form); and the bound of the function ``(x, mask) ->
    (idx, valid)`` on this input, at the fp32 peak or, for the TC kernel,
    the bf16 tensor-core peak."""
    qa, ka = operands(kmod, x, mask, precision)
    out = {
        "wrapper_ms": cuda_ms(torch, lambda: kmod.knn_cuda(x, K, mask, precision=precision)),
        "kernel_ms": cuda_ms(torch, lambda: kmod.launch_operands(qa, ka, K, precision)),
        "plain_ms": cuda_ms(torch, lambda: kmod.knn_plain(x, x, K, mask, precision), reps=5),
        "library_ms": cuda_ms(torch, lambda: library_knn(torch, kmod, x, mask, precision),
                              reps=5),
    }
    if precision == "default":
        out.update(tc_turns(torch, kmod, qa, ka, reps=20, warmup=3))
    else:
        out.update(f32_turns(torch, kmod, qa, ka, reps=20, warmup=3))
    out.update(knn_bound(x, mask, precision))
    return out


def tc_turns(torch, kmod, qa, ka, reps: int, warmup: int) -> dict:
    """The two TC forms of the exact kernel alone on the same bf16
    operands, in turns (Hopper, sweep, sweep, Hopper): ``kernel_ms`` the
    Hopper kernel's mean, ``sweep_ms`` sweep_tc's (the shared sweep's TC
    instantiation)."""
    return form_turns(
        torch, lambda form: (lambda: kmod.launch_operands(qa, ka, K, "default", kernel=form)),
        reps=reps, warmup=warmup)


def f32_turns(torch, kmod, qa, ka, reps: int, warmup: int, k: int = K) -> dict:
    """The two fp32 forms of the exact kernel alone on the same operands
    (padded to a multiple of CPAD channels), in turns (Hopper, sweep,
    sweep, Hopper): ``kernel_ms`` the Hopper fp32 kernel's mean,
    ``sweep_ms`` the fp32 sweep's. Empty where the route is the sweep."""
    if kmod.f32_kernel_for(qa.shape[-1], k) != "hopper":
        return {}
    return form_turns(
        torch, lambda form: (lambda: kmod.launch_operands(qa, ka, k, kernel=form)),
        reps=reps, warmup=warmup, hopper="hopper")


def operands(kmod, x, mask, precision: str):
    """The kernel's own operands of ``(x, mask)``: `tc_operand`'s bf16
    form for the TC kernels, the fp32 ones padded to a multiple of CPAD
    channels (as the wrapper builds them for the Hopper fp32 kernel)."""
    if precision == "default":
        return tuple(kmod.tc_operand(t) for t in kmod.build_augmented_operands(x, x, mask,
                                                                                precision))
    return kmod.build_augmented_operands(x, x, mask, cpad=kmod.CPAD)


def knn_bound(x, mask, precision: str) -> dict:
    """The bound of the exact graph build ``(x, mask) -> (idx, valid)`` on
    this input: ``bound_ms``, ``bound_by`` and the ``peak`` it used."""
    b, n, c = x.shape
    # what this input needs: every query against every valid key (a masked
    # key can be skipped), C FMAs (2 operations each), one subtract of the
    # key's norm and one compare a pair; the norms of the valid keys and
    # the query scaling once each
    valid_keys = int(mask.sum())
    pairs = n * valid_keys
    ops = pairs * (2 * c + 2) + valid_keys * 2 * c + b * n * c
    # x and the mask read once, idx (int32) and valid (bool) written once
    bytes_moved = 4 * x.numel() + mask.numel() + b * n * K * (4 + 1)
    ops_ms = ops / peak_of(precision) * 1e3
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    out = {"bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "peak": peak_of(precision)}
    if precision == "default":
        # the selection's floor beside the tensor cores' bound: one fp32
        # compare a (query, valid key) pair against the row's running k-th
        # score, on the CUDA cores at half the FMA-counted fp32 peak
        out["compare_ms"] = pairs / (FP32_PEAK_FLOPS / 2) * 1e3
    return out


def peak_of(precision: str) -> float:
    """The operations peak of a kernel's score: the fp32 CUDA cores, or
    the bf16 tensor cores of the TC instantiation."""
    return BF16_PEAK_FLOPS if precision == "default" else FP32_PEAK_FLOPS


def graph_mismatches(torch, kmod, precision, xq, xk, mk, xq_np, xk_np, gi, ri, gv, rv,
                     key_offset: int = 0):
    """``(hard, near)`` between a kernel's graph and its plain version's:
    by the unrounded points' distances (`split_mismatches`) for the fp32
    kernels, by the rounded operands' own scores
    (`split_score_mismatches`, rtol TC_RTOL) for the TC kernels, whose
    plain version ranks the same bf16 operands. Indices are ``key_offset``
    plus rows of ``xk``."""
    from dgcnn_tpu_torch.ops.knn import split_mismatches, split_score_mismatches

    if precision == "highest":
        return split_mismatches(xq_np, gi, ri, gv, rv, xk=xk_np)
    qa, ka = kmod.build_augmented_operands(xq, xk, mk, precision)
    return split_score_mismatches(qa.cpu().numpy(), ka.cpu().numpy(), gi, ri, gv, rv,
                                  rtol=TC_RTOL, key_offset=key_offset)


def order_violations(x_np, gi, gv, gs) -> int:
    """Duplicate keys out of index order, plus, for any kernel, adjacent
    slots out of the (score desc, index asc) order of its own scores (under
    bf16 operands distinct keys tie often)."""
    from dgcnn_tpu_torch.ops.knn import score_order_violations, tie_order_violations

    return tie_order_violations(x_np, gi, gv) + score_order_violations(gs, gi, gv)


def fmt_times(t: dict) -> str:
    tc = t.get("peak") == BF16_PEAK_FLOPS
    sweep = (f"{'sweep_tc' if tc else 'sweep_fp32'}_only_ms={t['sweep_ms']:.4f} "
             if "sweep_ms" in t else "")
    if "compare_ms" in t:
        sweep += f"compare_floor_ms={t['compare_ms']:.4f} "
    return (f"wrapper_ms={t['wrapper_ms']:.4f} kernel_only_ms={t['kernel_ms']:.4f} {sweep}"
            f"plain_ms={t['plain_ms']:.4f} library_ms(matmul+topk)={t['library_ms']:.4f} "
            f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}; "
            f"{'bf16 tensor-core' if t.get('peak') == BF16_PEAK_FLOPS else 'fp32'} peak "
            f"{t.get('peak', FP32_PEAK_FLOPS):.3g} FLOP/s, HBM {HBM_BYTES_PER_S:.3g} B/s, H100 SXM data sheet) "
            f"roofline_share={t['bound_ms'] / t['wrapper_ms']:.3f}")


def check_knn(torch, kmod, label, xq, xk, mk, x_np, xk_np=None, cross=False, ties=False,
              k: int = K, precision: str = "highest", ref=None) -> float:
    """Kernel vs knn_plain on one input: identical valid flags, 0 hard
    mismatches (`graph_mismatches`), 0 order violations
    (`order_violations`); with ``ties`` (an `all_equal` input) every row
    exactly at `lowest_valid`. ``precision="default"``: the TC kernel
    against the plain version of the same rounded operands. ``ref``: the
    plain version's output on this input, where the caller has it. Logs
    the key split S the launch took. Returns max |score diff|."""
    if cross:
        got = kmod.knn_cuda_cross(xq, xk, k, mk, precision=precision)
    else:
        got = kmod.knn_cuda(xq, k, mk, return_scores=True, precision=precision)
    if ref is None:
        ref = kmod.knn_plain(xq, xk, k, mk, precision)
    torch.cuda.synchronize()
    gi, gv, gs = (t.cpu().numpy() for t in got)
    ri, rv, rs = (t.cpu().numpy() for t in ref)
    if not np.array_equal(gv, rv):
        raise AssertionError(f"{label}: valid flags differ in {(gv != rv).sum()} slots")
    hard, near = graph_mismatches(torch, kmod, precision, xq, xk, mk, x_np,
                                  x_np if xk_np is None else xk_np, gi, ri, gv, rv)
    swapped = order_violations(x_np if xk_np is None else xk_np, gi, gv, gs)
    err = float(np.max(np.abs(gs[gv] - rs[rv]))) if gv.any() else 0.0
    missed, note = 0, ""
    if ties:
        wi, wv = (a[:, :xq.shape[1]] for a in lowest_valid(mk.cpu().numpy(), k))
        missed = int((gv != wv).sum() + (np.where(wv, gi, 0) != np.where(wv, wi, 0)).sum())
        note = f", slots off the lowest valid indices={missed}"
    tc = precision == "default"
    pad = kmod.CPAD_TC if tc else kmod.CPAD
    c2 = -(-(xq.shape[2] + 2) // pad) * pad
    kernel = kmod.tc_kernel_for(c2, k) if tc else kmod.f32_kernel_for(c2, k)
    form = {"hopper": "f32_hopper", "sweep": "fp32"}[kernel] if not tc else kernel
    splits = kmod.choose_splits(xq.shape[0], xq.shape[1], xk.shape[1],
                                c2 if form != "fp32" else xq.shape[2] + 2, k, xq.device,
                                kernel=form)
    same = True
    if kernel == "tc":
        same = same_as_sweep(torch, kmod, xq, xk, mk, k, got)
        note += f", == sweep_tc's graph and scores: {same}"
    elif kernel == "hopper":
        same = same_as_sweep(torch, kmod, xq, xk, mk, k, got, precision="highest")
        note += f", == the fp32 sweep's graph and scores: {same}"
    log(f"knn{' TC' if tc else ''} {label} Nq={xq.shape[1]} Nk={xk.shape[1]} k={k} ({kernel} "
        f"kernel, key split S={splits}): hard={hard} "
        f"near_ties={near} of {gi.size} slots, keys out of (score, index) order={swapped}"
        f"{note}, max|score diff| on valid slots={err:.3e}")
    if hard or swapped or missed or not same:
        raise AssertionError(f"{label}: {hard} hard mismatches against knn_plain, "
                             f"{swapped} tie-order violations, {missed} slots off the lowest "
                             f"valid indices, equal to the sweep's: {same}")
    return err


def same_as_sweep(torch, kmod, xq, xk, mk, k, got, precision: str = "default") -> bool:
    """Whether a Hopper kernel's ``got`` (idx, valid, scores) equals the
    shared sweep's on the same input, index for index and score for score
    (``==``): the TC kernel against sweep_tc, the fp32 one
    (``precision="highest"``) against the fp32 sweep."""
    qa, ka = kmod.build_augmented_operands(xq, xk, mk, precision)
    ref = kmod.launch_operands(qa, ka, k, precision, kernel="sweep")
    return all(bool(torch.equal(a, r)) for a, r in zip(got, ref))


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


def kernel_on_main_path_inputs(torch, kmod, tv, state, batch, smi: str,
                               precision: str = "highest"):
    """Capture the six graph-build inputs of one served forward, then check
    the kernel (``precision="default"``: the TC kernel) against knn_plain
    on each and time both there."""
    captured = []
    knn_fn = tv.model.knn_fn
    tc = " TC" if precision == "default" else ""

    def recording(x, k, mask):
        captured.append((x.clone(), mask.clone()))
        return knn_fn(x, k, mask)

    points = torch.tensor(batch.points, device="cuda")
    mask = torch.tensor(batch.mask, device="cuda")
    tv.model.knn_fn = recording
    with torch.inference_mode():
        tv.model(state.params, state.model_state, points, mask)
    tv.model.knn_fn = knn_fn
    out = []
    for i, (x, m) in enumerate(captured):
        err = check_knn(torch, kmod, f"main path block {i} C={x.shape[-1]}", x, x, m,
                        x.cpu().numpy(), precision=precision)
        t = time_knn(torch, kmod, x, m, precision)
        t["max_abs_err"] = err
        t["c"] = x.shape[2]
        # the selection's cost depends on the order keys arrive in: the
        # same rows in a random order, for comparison
        perm = torch.randperm(x.shape[1], generator=torch.Generator().manual_seed(i)).cuda()
        qa, ka = kmod.build_augmented_operands(x[:, perm], x[:, perm], m[:, perm], precision)
        shuffled = cuda_ms(torch, lambda: kmod.launch_operands(qa, ka, K, precision))
        log(f"knn{tc} timing, main path block {i} B={x.shape[0]} N={x.shape[1]} C={x.shape[2]} "
            f"k={K} [{smi}]: {fmt_times(t)}; kernel_ms with rows shuffled={shuffled:.4f}")
        out.append(t)
    total = {key: sum(t[key] for t in out) for key in TIME_KEYS}
    log(f"knn{tc} per forward (6 launches) [{smi}]: "
        + " ".join(f"{k}={v:.4f}" for k, v in total.items()))
    log_per_shape(f"knn{tc}", out, smi)
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
                 ties=False, k: int = K, precision: str = "highest"):
    """Banded kernel vs knn_banded_plain on one input: identical valid
    flags, 0 hard mismatches, duplicates in index order. ``band`` holds
    the cross form's ``q_base``, ``key_base`` and ``nvalid`` (None: self
    form); indices are global positions in ``x_full`` (numpy), whose rows
    ``q_rows`` are the queries (None: all). With ``ties`` (an `all_equal`
    input) every row must hold exactly `lowest_in_band`. Returns ``(max
    |score diff|, plain ms)``, the plain version's time from CUDA events
    around its one call. ``precision="default"``: the TC kernel against the
    plain version of the same rounded operands (`graph_mismatches`)."""
    from dgcnn_tpu_torch.kernels import knn_cuda as kmod

    if band is None:
        window = min(window, xq.shape[1])
        got = bmod.knn_banded_cuda(xq, k, mk, window=window, return_scores=True,
                                   precision=precision)
        band = dict(q_base=0, key_base=0, nvalid=None)
    else:
        got = bmod.knn_banded_cuda_cross(xq, xk, k, mk, window=window, precision=precision,
                                         **band)
    ref, plain_ms = cuda_once(
        torch, lambda: bmod.knn_banded_plain(xq, xk, k, mk, window=window, precision=precision,
                                             **band))
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
    hard, near = graph_mismatches(torch, kmod, precision, xq, xk, mk, xq_np, x_full, gi, ri, gv,
                                  rv, key_offset=band["key_base"])
    swapped = order_violations(x_full, gi, gv, gs)
    err = float(np.max(np.abs(gs[gv] - rs[rv]))) if gv.any() else 0.0
    missed, note = 0, ""
    if ties:
        wi, wv = lowest_in_band(pos, nvalid, window, k)
        wv = wv & q_ok
        missed = int((gv != wv).sum() + (np.where(wv, gi, 0) != np.where(wv, wi, 0)).sum())
        note = f", slots off the lowest in-band indices={missed}"
    same = exact = True
    if precision == "default":
        same = banded_same_as_sweep(torch, bmod, xq, xk, mk, k, window, band, got)
        note += f", == sweep_tc's graph and scores: {same}"
        if q_rows is None and window >= xk.shape[1]:
            want = kmod.knn_cuda(xq, k, mk, return_scores=True, precision="default")
            exact = all(bool(torch.equal(a, w)) for a, w in zip(got, want))
            note += f", W >= N == the exact TC kernel's graph and scores: {exact}"
    log(f"banded knn{' TC' if precision == 'default' else ''} {label} Nq={xq.shape[1]} "
        f"Nk={xk.shape[1]} W={window} k={k}: hard={hard} near_ties={near} of {gi.size} slots "
        f"({int(gv.sum())} valid), keys out of (score, index) order={swapped}{note}, "
        f"max|score diff| on valid slots={err:.3e}")
    if hard or swapped or missed or not same or not exact:
        raise AssertionError(f"{label}: {hard} hard mismatches against knn_banded_plain, "
                             f"{swapped} tie-order violations, {missed} slots off the lowest "
                             f"in-band indices, equal to sweep_tc's: {same}, equal to the exact "
                             f"TC kernel's: {exact}")
    return err, plain_ms


def banded_same_as_sweep(torch, bmod, xq, xk, mk, k, window, band, got) -> bool:
    """Whether the banded TC wrapper's ``got`` (idx, valid, scores; its
    passes on the Hopper kernel where `tc_kernel_for` routes them) equals
    every pass on sweep_tc (``kernel="sweep"``) on the same input, index
    for index and score for score (``==``)."""
    from dgcnn_tpu_torch.kernels import knn_cuda as kmod

    qa, ka = kmod.build_augmented_operands(xq, xk, mk, "default")
    nvalid = mk.sum(-1).to(torch.int32) if band["nvalid"] is None else band["nvalid"]
    ref = bmod.launch_operands(qa, ka, nvalid, k, window=window, q_base=band["q_base"],
                               key_base=band["key_base"], precision="default", kernel="sweep")
    return all(bool(torch.equal(a, r)) for a, r in zip(got, ref))


def phase_banded_vs_plain(torch, bmod, seed: int, precision: str = "highest") -> float:
    """The banded kernel against its plain version on ragged random
    inputs and on the same inputs with every valid point equal (all
    scores tie: each row must hold the lowest in-band indices, though the
    kernel visits the diagonal tile before lower-index tiles), self form
    and a halo-shaped cross form (the shard's rows plus the window each
    side); ``precision="default"``: the TC kernel. Returns the largest
    score difference."""
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
                                            ties=ties, precision=precision)[0])
                kb, ke = max(s0 - w, 0), min(s1 + w, RAGGED_N)
                e, _ = check_banded(
                    torch, bmod, f"{kind} C={c} cross q_base={s0} key_base={kb}",
                    xt[:, s0:s1].contiguous(), xt[:, kb:ke].contiguous(),
                    mt[:, kb:ke].contiguous(), w, x, q_rows=slice(s0, s1),
                    band=dict(q_base=s0, key_base=kb, nvalid=nvalid), ties=ties,
                    precision=precision)
                err = max(err, e)
    return err


def library_banded(torch, kmod, x, mask, window: int, strip: int = 2048,
                   precision: str = "highest"):
    """The yardstick: from ``(x, mask)``, the augmented operands, then per
    strip of queries one matmul (bf16 for ``precision="default"``) over the
    strip's key span, the band mask and ``torch.topk`` (no tie rule). No
    one PyTorch call computes a banded top-k; the port never calls this."""
    from dgcnn_tpu_torch.ops.knn import band_lo

    n = x.shape[1]
    w = min(window, n)
    qa, ka = kmod.build_augmented_operands(x, x, mask, precision)
    if precision == "default":
        qa, ka = qa.to(torch.bfloat16), ka.to(torch.bfloat16)
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


def banded_bound(torch, x, mask, window: int, peak: float = FP32_PEAK_FLOPS, rows=None):
    """``(bound ms, bound_by, pairs)`` of the function ``(x, mask) ->
    (idx, valid)`` on this input: (2C + 2) operations per (valid query,
    in-band valid key) pair, counted from the band and the mask, plus the
    valid keys' norms and the query scaling, at ``peak`` (fp32, or bf16 for
    the TC kernel);
    against x and the mask read once and idx (int32) and valid (bool)
    written once, at the HBM rate. ``rows`` (a slice of positions): the
    queries of one band only (the halo path's cross form), whose keys are
    its rows and a window on each side."""
    from dgcnn_tpu_torch.ops.knn import band_lo

    b, n, c = x.shape
    w = min(window, n)
    m = mask.to(torch.int64)
    cs = torch.nn.functional.pad(m.cumsum(-1), (1, 0))  # valid keys before each position
    nv = m.sum(-1)
    lo = band_lo(torch.arange(n, device=x.device)[None, :], nv[:, None], w).expand(b, n)
    in_band = cs.gather(1, torch.clamp(lo + w, max=n)) - cs.gather(1, lo)
    rows = slice(0, n) if rows is None else rows
    nq = rows.stop - rows.start
    nk = min(n, rows.stop + w) - max(0, rows.start - w)
    pairs = int((in_band * m)[:, rows].sum())
    valid_keys = int(m[:, max(0, rows.start - w):rows.stop + w].sum())
    ops = pairs * (2 * c + 2) + valid_keys * 2 * c + b * nq * c
    bytes_moved = 4 * b * (nq + nk) * c + b * nk + b * nq * K * (4 + 1)
    ops_ms = ops / peak * 1e3
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), pairs


def long_events(seed: int, which=(0, 1, 2)):
    """Two fixed-length events of LONG_N points and one variable-length
    event padded to LONG_N (``which`` of them), one event a batch."""
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO

    out = []
    for i in which:
        io = SyntheticIO(num_events=1, num_point=LONG_N, seed=seed + 10 + i,
                         variable_length=i == 2)
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


def banded_on_main_path_inputs(torch, kmod, bmod, tv, state, points, mask, smi: str,
                               precision: str = "highest", limit: int = EDGE_BLOCKS,
                               label: str = "long event"):
    """Capture the six graph-build inputs of one long-event forward, then
    check the banded kernel (``precision="default"``: the TC kernel)
    against knn_banded_plain on the first ``limit`` and time the wrapper,
    the kernel alone, the plain version and the yardstick there."""
    captured = []
    pr = dict(precision=precision)

    def recording(x, k, m):
        captured.append((x.clone(), m.clone()))
        return bmod.knn_banded_cuda(x, k, m, window=LONG_W, **pr)

    knn_fn = tv.model.knn_fn
    tv.model.knn_fn = recording
    with torch.inference_mode():
        tv.model(state.params, state.model_state, points, mask)
    tv.model.knn_fn = knn_fn
    return banded_times(torch, kmod, bmod, captured[:limit], smi, precision, label)


def banded_times(torch, kmod, bmod, captured, smi: str, precision: str = "highest",
                 label: str = "long event"):
    """The banded kernel (self form) on each captured ``(x, mask)``:
    checked against knn_banded_plain, and its wrapper, alone, plain,
    library and bound times; per-launch records."""
    pr = dict(precision=precision)
    tc = " TC" if precision == "default" else ""
    out = []
    for i, (x, m) in enumerate(captured):
        x = x.float().contiguous()
        err, plain_ms = check_banded(torch, bmod, f"{label} block {i} C={x.shape[-1]}",
                                     x, x, m, LONG_W, x.cpu().numpy(), **pr)
        qa, ka = kmod.build_augmented_operands(x, x, m, precision)
        if precision == "default":
            qa, ka = kmod.tc_operand(qa), kmod.tc_operand(ka)
        nvalid = m.sum(-1).to(torch.int32)
        t = {
            "wrapper_ms": cuda_ms(torch, lambda: bmod.knn_banded_cuda(x, K, m, window=LONG_W, **pr),
                                  reps=3, warmup=1),
            "kernel_ms": cuda_ms(
                torch, lambda: bmod.launch_operands(qa, ka, nvalid, K, window=LONG_W, **pr),
                reps=3, warmup=1),
            "plain_ms": plain_ms,
            "library_ms": cuda_once(torch, lambda: library_banded(torch, kmod, x, m, LONG_W,
                                                                  **pr))[1],
            "max_abs_err": err,
        }
        if precision == "default":
            t.update(form_turns(torch, lambda form: (lambda: bmod.launch_operands(
                qa, ka, nvalid, K, window=LONG_W, kernel=form, **pr)), reps=3, warmup=1))
        t["bound_ms"], t["bound_by"], pairs = banded_bound(torch, x, m, LONG_W, peak_of(precision))
        t["peak"] = peak_of(precision)
        t["c"] = x.shape[2]
        log(f"banded knn{tc} timing, {label} block {i} B={x.shape[0]} N={x.shape[1]} "
            f"C={x.shape[2]} k={K} W={LONG_W} ({pairs} valid in-band pairs) [{smi}]: "
            f"{fmt_times(t)} (library = strip loop of matmul + band mask + torch.topk)")
        out.append(t)
    total = {key: sum(t[key] for t in out) for key in TIME_KEYS}
    log(f"banded knn{tc} per {label} forward ({len(out)} launches) [{smi}]: "
        + " ".join(f"{k}={v:.4f}" for k, v in total.items()))
    log_per_shape(f"banded knn{tc} {label}", out, smi)
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
               k: int = K, precision: str = "highest", p: int = CP_P) -> float:
    """The ring kernel for every rank's order of ``p`` virtual owners:
    against its plain version (``step_plain``) for the ranks in
    ``plain_ranks`` (identical valid flags, 0 hard mismatches), with 0
    tie-order violations, and all ranks together against ``exact`` (the
    exact kernel's graph of the whole event), index for index. With
    ``ties`` (an `all_equal` input) every query must hold exactly
    `lowest_valid`: every rank after the first meets its own indices
    before the lower ones of later blocks. Returns the largest score
    difference against the plain version. ``precision="default"``: the TC
    kernel, against the plain merge of the same rounded operands and the
    exact TC kernel's graph (the same fragment order: index for index)."""
    import functools

    n = x.shape[1]
    nl = n // p
    qa, ka = kmod.build_augmented_operands(x, x, mask, precision)
    step = functools.partial(rmod.launch_step, precision=precision)
    sweep = functools.partial(rmod.launch_step, precision=precision, kernel="sweep")
    x_np = x.cpu().numpy()
    err, hard, near, swapped, idx, valid = 0.0, 0, 0, 0, [], []
    same_sweep = True
    for me in range(p):
        q, blocks = ring_rank_blocks(qa, ka, me, p)
        got = rmod.merge_blocks(q, blocks, k, me * nl, step, return_scores=True)
        if precision == "default":
            # every step on sweep_tc, the bit reference of the Hopper step
            ref = rmod.merge_blocks(q, blocks, k, me * nl, sweep, return_scores=True)
            same_sweep &= all(bool(torch.equal(a, r)) for a, r in zip(got, ref))
        gi, gv, gs = (t.cpu().numpy() for t in got)
        swapped += order_violations(x_np, gi, gv, gs)
        idx.append(gi)
        valid.append(gv)
        if me not in plain_ranks:
            continue
        ri, rv, rs = (t.cpu().numpy() for t in rmod.merge_blocks(
            q, blocks, k, me * nl, rmod.step_plain, return_scores=True))
        if not np.array_equal(gv, rv):
            raise AssertionError(f"{label} rank {me}: valid flags differ in {(gv != rv).sum()} slots")
        rows = slice(me * nl, (me + 1) * nl)
        h, nt = graph_mismatches(torch, kmod, precision, x[:, rows], x, mask, x_np[:, rows], x_np,
                                 gi, ri, gv, rv)
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
    if precision == "default":
        note += f"; every rank == its steps on sweep_tc (indices, valid, scores): {same_sweep}"
    log(f"ring knn{' TC' if precision == 'default' else ''} {label} B={x.shape[0]} N={n} P={p} "
        f"C={x.shape[2]} k={k}: vs plain (ranks "
        f"{list(plain_ranks)}) hard={hard} near_ties={near}, max|score diff| on valid slots="
        f"{err:.3e}; keys out of (score, index) order={swapped}{note}; all ranks == exact kernel "
        f"on the whole event: {same} ({int((gi != ei).sum())} slots differ, {int(gv.sum())} valid)")
    if hard or swapped or missed or not same or not same_sweep:
        raise AssertionError(f"{label}: {hard} hard mismatches, {swapped} tie-order violations, "
                             f"{missed} slots off the lowest valid indices, equal to the exact "
                             f"kernel: {same}, equal to sweep_tc's steps: {same_sweep}")
    return err


def library_ring(torch, kmod, xs, ms, blocks, precision: str = "highest"):
    """The yardstick: from the rank's shard, its operands, then per block
    one matmul (bf16 for ``precision="default"``), ``torch.topk`` and a
    sort-based merge of the running list (no tie rule). Never called by
    the port."""
    qa, _ = kmod.build_augmented_operands(xs, xs, ms, precision)
    if precision == "default":
        qa = qa.to(torch.bfloat16)
    topv = torch.full(qa.shape[:2] + (K,), float("-inf"), device=qa.device, dtype=qa.dtype)
    topi = torch.zeros(qa.shape[:2] + (K,), dtype=torch.long, device=qa.device)
    for ka, base in blocks:
        v, i = torch.topk(torch.matmul(qa, ka.to(qa.dtype).transpose(-1, -2)), K, dim=-1)
        sv, order = torch.sort(torch.cat([topv, v], -1), dim=-1, descending=True)
        topv = sv[..., :K]
        topi = torch.gather(torch.cat([topi, i + base], -1), -1, order)[..., :K]
    return topv, topi


def time_ring(torch, kmod, rmod, x, mask, precision: str = "highest", p: int = CP_P) -> dict:
    """Per-launch CUDA-event times of rank 0's ring of ``p`` owners on one input: the
    wrapper's work (operand build of the shard, the P merges, the finish;
    the other owners' blocks prebuilt, as transport hands them over), the
    kernel alone, the plain version and the library yardstick, each
    divided by P; and the bound per launch from this input's valid keys.
    ``precision="default"``: the TC kernel (its queries and blocks
    prebuilt in bf16 for the kernel alone)."""
    import functools

    b, n, c = x.shape
    nl = n // p
    qa, ka = kmod.build_augmented_operands(x, x, mask, precision)
    q, blocks = ring_rank_blocks(qa, ka, 0, p)
    xs, ms = x[:, :nl].contiguous(), mask[:, :nl].contiguous()
    step = functools.partial(rmod.launch_step, precision=precision)
    tc = precision == "default"
    q_k = kmod.tc_operand(q) if tc else q
    blocks_k = [(kmod.tc_operand(kb) if tc else kb, base) for kb, base in blocks]

    def wrapper():
        qs, _ = kmod.build_augmented_operands(xs, xs, ms, precision)
        return rmod.merge_blocks(kmod.tc_operand(qs) if tc else qs, blocks, K, 0, step)

    def kernel_alone(kernel=None):
        # fresh running lists each time: a full list would raise every floor
        topv, topi = rmod.init_running(b, nl, K, x.device)
        for kb, base in blocks_k:
            if tc:
                rmod.launch_step(q_k, kb, base, topv, topi, precision=precision, kernel=kernel)
            else:
                step(q_k, kb, base, topv, topi)

    t = {
        "wrapper_ms": cuda_ms(torch, wrapper, reps=3, warmup=1) / p,
        "kernel_ms": cuda_ms(torch, kernel_alone, reps=3, warmup=1) / p,
        "plain_ms": cuda_once(torch, lambda: rmod.merge_blocks(q, blocks, K, 0, rmod.step_plain))[1] / p,
        "library_ms": cuda_ms(torch, lambda: library_ring(torch, kmod, xs, ms, blocks, precision),
                              reps=2, warmup=1) / p,
    }
    # (2C + 2) fp32 operations per (query, valid key of the block) pair;
    # the queries, the block and the running list read once and the list
    # written once
    valid_keys = int(mask.sum())
    ops = (2 * c + 2) * nl * valid_keys / p
    bytes_moved = 2 * 4 * b * nl * (c + 2) + 3 * 4 * b * nl * K * 2
    ops_ms = ops / peak_of(precision) * 1e3
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    t["bound_ms"] = max(ops_ms, bytes_ms)
    t["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    t["peak"] = peak_of(precision)
    if tc:
        t.update(form_turns(torch, lambda form: (lambda: kernel_alone(form)), reps=5, warmup=1,
                            per=p))
    return t


def form_turns(torch, make_run, reps: int, warmup: int, per: int = 1, hopper: str = "tc") -> dict:
    """A kernel's two forms alone on the same operands, in turns (Hopper,
    sweep, sweep, Hopper): ``kernel_ms`` the Hopper form's mean,
    ``sweep_ms`` the shared sweep's (sweep_tc for a TC kernel, whose
    Hopper form is ``"tc"``; the fp32 sweep for the fp32 kernel, whose
    Hopper form is ``"hopper"``), each divided by ``per``.
    ``make_run(form)`` gives the run of a form."""
    ms = {hopper: [], "sweep": []}
    for form in (hopper, "sweep", "sweep", hopper):
        ms[form].append(cuda_ms(torch, make_run(form), reps=reps, warmup=warmup) / per)
    return {"kernel_ms": sum(ms[hopper]) / 2, "sweep_ms": sum(ms["sweep"]) / 2}


def phase_ring_vs_plain(torch, kmod, rmod, seed: int, smi: str,
                        precision: str = "highest") -> float:
    """Phase 9: the ring kernel in one process on ragged random inputs and
    on the same inputs with every valid point equal, P = CP_P virtual
    owners (``precision="default"``: the TC kernels, the ring against the
    exact TC kernel); returns the largest score difference."""
    err = 0.0
    pr = dict(precision=precision)
    for c in (4, EDGE_WIDTH):
        x, mask = ring_ragged_inputs(seed, c)
        xt, mt = torch.tensor(x, device="cuda"), torch.tensor(mask, device="cuda")
        err = max(err, check_ring(torch, kmod, rmod, f"random C={c}", xt, mt,
                                  kmod.knn_cuda(xt, K, mt, **pr), range(CP_P), **pr))
        xe = torch.tensor(all_equal(x, mask), device="cuda")
        err = max(err, check_ring(torch, kmod, rmod, f"all-equal C={c}", xe, mt,
                                  kmod.knn_cuda(xe, K, mt, **pr), range(CP_P), ties=True, **pr))
        t = time_ring(torch, kmod, rmod, xt, mt, precision)
        log(f"ring knn{' TC' if precision == 'default' else ''} timing, random inputs B={RING_B} N_local={RING_NL} P={CP_P} C={c} k={K} "
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


def phase_ring_on_main_path(torch, kmod, rmod, captured, smi: str, precision: str = "highest"):
    """Phase 12: the ring kernel on the six graph-build inputs of a served
    CP_N-point forward, split into CP_P virtual owners: every rank's
    merges, all ranks together equal the exact kernel's graph of the
    whole input, rank 0 against the plain version; times and bound.
    ``precision="default"``: the TC kernels."""
    out = []
    for i, (x, m, ei, ev) in enumerate(captured):
        err = check_ring(torch, kmod, rmod, f"main path block {i} C={x.shape[-1]}", x, m,
                         (ei, ev), (0,), precision=precision)
        t = time_ring(torch, kmod, rmod, x, m, precision)
        t["max_abs_err"] = err
        t["c"] = x.shape[2]
        log(f"ring knn timing, main path block {i} B={x.shape[0]} N_local={x.shape[1] // CP_P} "
            f"P={CP_P} C={x.shape[2]} k={K} [{smi}]: {fmt_times(t)} (per launch; library = "
            f"matmul + torch.topk + sort merge per block)")
        out.append(t)
    total = {key: sum(t[key] for t in out) * CP_P for key in TIME_KEYS}
    tc = " TC" if precision == "default" else ""
    log(f"ring knn{tc} per rank and forward ({len(out) * CP_P} launches) [{smi}]: "
        + " ".join(f"{k}={v:.4f}" for k, v in total.items()))
    log_per_shape(f"ring knn{tc}", out, smi)
    return out


# ------------------------------------------------- any width, any k <= N


def phase_wide_and_long_k(torch, kmod, bmod, rmod, seed: int, smi: str,
                          precision: str = "highest") -> dict:
    """Phase 13: all three kernels at C = WIDE_C (channels in chunks) and
    k = WIDE_K (two passes, the second behind each row's ceiling) against
    their plain versions: the exact kernel on the phase-3 inputs (self,
    cross, all-equal), the banded kernel on the phase-4 inputs at W = 1024
    (self, halo cross, all-equal), the ring kernel on the phase-9 inputs
    (every rank against ``step_plain``, all ranks against the exact
    kernel, all-equal). ``precision="default"``: the TC kernels (one
    shared-memory pass of bf16 rows at this C). Returns the largest score
    difference per kernel and logs wrapper and plain times at these
    shapes."""
    import functools

    dev = torch.device("cuda")
    c, k = WIDE_C, WIDE_K
    pr = dict(precision=precision)
    tc = " TC" if precision == "default" else ""
    err = {"knn": 0.0, "banded": 0.0, "ring": 0.0}
    chunks = (kmod._lib().dgcnn_knn_chunk(c + 2), bmod._lib().dgcnn_knn_banded_chunk(c + 2),
              rmod._lib().dgcnn_ring_knn_chunk(c + 2))
    if tc:
        log(f"any width and k{tc}: C={c} (bf16 rows of {-(-(c + 2) // 16) * 16} channels, one "
            f"shared-memory pass), k={k} ({-(-k // kmod.KMAX)} passes)")
    else:
        log(f"any width and k: C={c} (C+2={c + 2}; channel chunk CH={chunks[0]} exact, "
            f"{chunks[1]} banded, {chunks[2]} ring), k={k} ({-(-k // kmod.KMAX)} passes)")

    x, mask = ragged_inputs(seed, c)
    xt, mt = torch.tensor(x, device=dev), torch.tensor(mask, device=dev)
    err["knn"] = max(check_knn(torch, kmod, f"random C={c} self", xt, xt, mt, x, k=k, **pr),
                     check_knn(torch, kmod, f"random C={c} cross", xt[:, :1000].contiguous(), xt,
                               mt, x[:, :1000], xk_np=x, cross=True, k=k, **pr))
    xe_np = all_equal(x, mask)
    xe = torch.tensor(xe_np, device=dev)
    err["knn"] = max(err["knn"], check_knn(torch, kmod, f"all-equal C={c} self", xe, xe, mt, xe_np,
                                           ties=True, k=k, **pr))
    log(f"knn{tc} timing C={c} k={k} B={B} N={N} [{smi}]: wrapper_ms="
        f"{cuda_ms(torch, lambda: kmod.knn_cuda(xt, k, mt, **pr), reps=5):.4f} plain_ms="
        f"{cuda_ms(torch, lambda: kmod.knn_plain(xt, xt, k, mt, precision), reps=3, warmup=1):.4f}")

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
            check_banded(torch, bmod, f"{kind} C={c} self", xt, xt, mt, w, xn, ties=ties, k=k,
                         **pr)[0],
            check_banded(torch, bmod, f"{kind} C={c} cross q_base={s0} key_base={kb}",
                         xt[:, s0:s1].contiguous(), xt[:, kb:ke].contiguous(),
                         mt[:, kb:ke].contiguous(), w, xn, q_rows=slice(s0, s1),
                         band=dict(q_base=s0, key_base=kb, nvalid=nvalid), ties=ties, k=k,
                         **pr)[0])
    xt = torch.tensor(x, device=dev)
    ms = cuda_ms(torch, lambda: bmod.knn_banded_cuda(xt, k, mt, window=w, **pr), reps=3, warmup=1)
    _, plain_ms = cuda_once(torch, lambda: bmod.knn_banded_plain(xt, xt, k, mt, window=w, **pr))
    log(f"banded knn{tc} timing C={c} k={k} W={w} B={B} N={RAGGED_N} [{smi}]: wrapper_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f}")

    x, mask = ring_ragged_inputs(seed, c)
    xt, mt = torch.tensor(x, device=dev), torch.tensor(mask, device=dev)
    xe = torch.tensor(all_equal(x, mask), device=dev)
    err["ring"] = max(
        check_ring(torch, kmod, rmod, f"random C={c}", xt, mt, kmod.knn_cuda(xt, k, mt, **pr),
                   range(CP_P), k=k, **pr),
        check_ring(torch, kmod, rmod, f"all-equal C={c}", xe, mt, kmod.knn_cuda(xe, k, mt, **pr),
                   range(CP_P), ties=True, k=k, **pr))
    qa, ka = kmod.build_augmented_operands(xt, xt, mt, precision)
    q, blocks = ring_rank_blocks(qa, ka, 0, CP_P)
    step = functools.partial(rmod.launch_step, precision=precision)
    ms = cuda_ms(torch, lambda: rmod.merge_blocks(q, blocks, k, 0, step), reps=3, warmup=1)
    _, plain_ms = cuda_once(torch, lambda: rmod.merge_blocks(q, blocks, k, 0, rmod.step_plain))
    log(f"ring knn{tc} timing C={c} k={k} B={RING_B} N_local={RING_NL} P={CP_P} [{smi}]: rank 0's "
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
    backend = re.search(r"parallel: .*", out)
    log(f"dp cli: {backend.group(0) if backend else 'no ranks line'}")
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


# ------------------------------------------------------ mixed precision


def prec_config(n: int, minibatch: int = 1, **kw):
    """The full-width residual-dgcnn with the mixed-precision flags
    (``--precision bfloat16 --knn_precision default --remat``; ``kw``
    overrides), Adam at 1e-3, ``minibatch`` events of ``n`` points."""
    from dgcnn_tpu_torch.config import Config

    flags = {**dict(precision="bfloat16", knn_precision="default", remat=True), **kw}
    return Config(model_name="residual-dgcnn", num_class=2, kvalue=K,
                  edge_filters=(EDGE_WIDTH,) * EDGE_BLOCKS, minibatch_size=minibatch,
                  num_point=n, optimizer="adam", learning_rate=1e-3, **flags)


def one_event(n: int, seed: int):
    """One fixed-length `SyntheticIO` event of ``n`` points, as a batch."""
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO

    io = SyntheticIO(num_events=1, num_point=n, seed=seed, variable_length=False)
    io.initialize()
    return next(BucketBatcher(io, 1, num_point=n, shuffle=False).epoch())


def run_steps(torch, kmod, cfg, batch, seed: int, warmup: int, steps: int, record=False,
              profile=False):
    """``warmup + steps`` train steps of a `Trainval` of ``cfg`` from the
    seeded init on one batch: the losses, ms a timed step (CUDA events and
    the synchronized host clock), the peak device memory over every step,
    each step's (Hopper TC, sweep TC, fp32) exact-kernel launches (the
    counts set to 0 before the first step and read after the last) and,
    with ``record``,
    step 1's graph-build inputs and graphs; with ``profile``, a profiler
    table of one more step and its device busy ms."""
    from dgcnn_tpu_torch.train.trainval import Trainval

    tv = Trainval(cfg)
    state = tv.initialize(4, generator=torch.Generator().manual_seed(seed))
    graph_build = tv.model.knn_fn
    captured, graphs = [], []

    def recording(x, k, mask):
        captured.append((x.detach().clone(), mask.clone()))
        graphs.append(tuple(t.clone() for t in graph_build(x, k, mask)[:2]))
        return graphs[-1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    losses, per_step = [], []
    kmod.launches = kmod.launches_f32_hopper = kmod.launches_tc = kmod.launches_tc_sweep = 0
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
        before = exact_counts(kmod)
        tv.model.knn_fn = recording if record and i == 0 else graph_build
        state, metrics = tv.train_step(state, batch)
        per_step.append(tuple(a - b for a, b in zip(exact_counts(kmod), before)))
        losses.append(metrics["loss"])
    end.record()
    torch.cuda.synchronize()
    out = {
        "losses": [float(v) for v in losses],
        "host_ms": (time.perf_counter() - t0) * 1e3 / steps,
        "event_ms": start.elapsed_time(end) / steps,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "per_step": per_step,
        "launches": exact_counts(kmod),
        "captured": captured,
        "graphs": graphs,
    }
    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, _ = tv.train_step(state, batch)
            torch.cuda.synchronize()
        table = prof.key_averages()
        out["busy_ms"] = sum(e.self_device_time_total for e in table
                             if e.device_type != DeviceType.CPU) / 1e3
        out["profile"] = table.table(sort_by="cuda_time_total", row_limit=25)
    del tv, state
    torch.cuda.empty_cache()
    return out


def exact_counts(kmod) -> tuple:
    """The exact kernel's launch counts: (Hopper TC, sweep TC, fp32)."""
    return kmod.launches_tc, kmod.launches_tc_sweep, kmod.launches


def time_knn_large(torch, kmod, x, mask, precision: str, strip: int = 8192) -> dict:
    """`time_knn` for one event too large for one score matrix: the
    wrapper and the kernel alone by CUDA events (3 launches); the plain
    version (blocks of query rows by construction) once; the library
    yardstick, a bf16 (or fp32) matmul and ``torch.topk`` for each strip
    of ``strip`` query rows, once, summed; the bound (`knn_bound`).
    Returns ``(times, the plain version's (idx, valid, scores))``."""
    n = x.shape[1]
    qa, ka = operands(kmod, x, mask, precision)

    def library():
        for r0 in range(0, n, strip):
            library_knn(torch, kmod, x, mask, precision, xq=x[:, r0:r0 + strip])

    plain, plain_ms = cuda_once(torch, lambda: kmod.knn_plain(x, x, K, mask, precision))
    out = {
        "wrapper_ms": cuda_ms(torch, lambda: kmod.knn_cuda(x, K, mask, precision=precision),
                              reps=3, warmup=1),
        "kernel_ms": cuda_ms(torch, lambda: kmod.launch_operands(qa, ka, K, precision), reps=3,
                             warmup=1),
        "plain_ms": plain_ms,
        "library_ms": cuda_once(torch, library)[1],
    }
    if precision == "default":
        out.update(tc_turns(torch, kmod, qa, ka, reps=3, warmup=1))
    else:
        out.update(f32_turns(torch, kmod, qa, ka, reps=3, warmup=1))
    out.update(knn_bound(x, mask, precision))
    return out, plain


def phase_prec_train(torch, kmod, rmod, seed: int, smi: str, profile: bool = False):
    """Phase 17, part 2: `Trainval.train_step` of the full-width model on
    one PREC_N-point event with ``--precision bfloat16 --knn_precision
    default --remat``, PREC_WARMUP + PREC_STEPS steps: exactly 6 TC
    exact-kernel launches a step and no fp32 one (12 would mean remat ran
    the graph build again), a finite loss that falls over the timed steps,
    ms a step, points/s, peak memory; the same steps without remat, whose
    peak must be higher. On step 1's six graph-build inputs: the TC kernel
    against `knn_plain` (``precision="default"``) on the first PREC_SLICE
    query rows against all PREC_N keys (cross form), the share of
    neighbour slots that differ from the fp32 kernel's graph (what the knob
    costs; printed, not gated), times per shape (C=4, C=64), and the ring
    TC kernel over CP_P virtual owners of each input (every rank's merges
    equal to the exact TC kernel's graph, rank 0 against the plain merge).
    ``profile``: a profiler table of one remat step, its device busy time
    and idle share. Returns ``(TC launches, per-launch records at the
    train shape, ring TC per-launch records)``."""
    batch = one_event(PREC_N, seed)
    cfg = prec_config(PREC_N)
    log(f"mixed precision train: residual-dgcnn edge_filters={cfg.edge_filters} k={K} head "
        f"{cfg.head_feat_dim}->{'->'.join(map(str, cfg.head_mlp))}, B=1 N={PREC_N} "
        f"({int(batch.mask.sum())} valid), --precision {cfg.precision} --knn_precision "
        f"{cfg.knn_precision} --remat, {cfg.optimizer} lr {cfg.learning_rate}, {PREC_WARMUP} "
        f"warm-up + {PREC_STEPS} timed steps on one batch")
    runs = {}
    for remat in (True, False):
        r = run_steps(torch, kmod, dataclasses.replace(cfg, remat=remat), batch, seed, PREC_WARMUP,
                      PREC_STEPS, record=remat, profile=profile and remat)
        runs[remat] = r
        timed = r["losses"][PREC_WARMUP:]
        log(f"mixed precision train, remat={remat} [{smi}]: {r['event_ms']:.3f} ms a step (CUDA "
            f"events), {r['host_ms']:.3f} ms (host clock, synchronized), "
            f"{PREC_N / (r['host_ms'] / 1e3):.1f} points/s, peak device memory "
            f"{r['peak_gib']:.3f} GiB; (Hopper TC, sweep TC, fp32) exact-kernel launches a step "
            f"{r['per_step']}; losses {[round(v, 6) for v in r['losses']]}")
        if any(p != (EDGE_BLOCKS, 0, 0) for p in r["per_step"]):
            raise AssertionError(f"mixed precision train, remat={remat}: (Hopper TC, sweep TC, "
                                 f"fp32) launches a step {r['per_step']}, want ({EDGE_BLOCKS}, 0, 0)")
        if not all(np.isfinite(r["losses"])) or not timed[-1] < timed[0]:
            raise AssertionError(f"mixed precision train, remat={remat}: loss not finite or not "
                                 f"falling over the timed steps: {timed}")
    log(f"mixed precision train peak device memory [{smi}]: {runs[True]['peak_gib']:.3f} GiB with "
        f"remat, {runs[False]['peak_gib']:.3f} GiB without")
    if "profile" in runs[True]:
        busy, host = runs[True]["busy_ms"], runs[True]["host_ms"]
        log(runs[True]["profile"])
        log(f"mixed precision train step profile [{smi}]: device busy {busy:.3f} ms a step "
            f"(profiler, device events); idle share of a timed step 1 - {busy:.3f} / {host:.3f} ms "
            f"= {1 - busy / host:.3f}")
    if not runs[True]["peak_gib"] < runs[False]["peak_gib"]:
        raise AssertionError("remat did not lower the peak device memory")
    launches = runs[True]["launches"][0] + runs[False]["launches"][0]

    out, ring_inputs = [], []
    for i, (x, m) in enumerate(runs[True]["captured"]):
        x = x.float().contiguous()
        x_np = x.cpu().numpy()
        err = check_knn(torch, kmod, f"train step 1 block {i} C={x.shape[-1]} rows "
                        f"[0, {PREC_SLICE})", x[:, :PREC_SLICE].contiguous(), x, m,
                        x_np[:, :PREC_SLICE], xk_np=x_np, cross=True, precision="default")
        got = kmod.knn_cuda(x, K, m, return_scores=True, precision="default")
        ti, tv_, _ = got
        if not same_as_sweep(torch, kmod, x, x, m, K, got):
            raise AssertionError(f"train step 1 block {i}: the Hopper TC kernel's graph or scores "
                                 f"differ from sweep_tc's over the whole event")
        log(f"knn TC train step 1 block {i} C={x.shape[-1]} B=1 N={PREC_N}: the Hopper kernel's "
            f"indices, valid flags and scores == sweep_tc's over the whole event")
        fi, fv, _ = kmod.knn_cuda(x, K, m, return_scores=True)
        both = (tv_ & fv)
        differ = float(((ti != fi) & both).sum()) / max(int(both.sum()), 1)

        def dist(idx):  # squared distances of the chosen neighbours, (B, N, k)
            return torch.square(x[:, :, None, :] - x[0][idx.long()]).sum(-1)

        ratio = float(dist(ti)[both].double().sum() / dist(fi)[both].double().sum())
        log(f"knn TC vs fp32 kernel, train step 1 block {i} C={x.shape[-1]} B=1 N={PREC_N}: "
            f"{differ:.4e} of the valid neighbour slots differ; the chosen neighbours' summed "
            f"squared distance is {ratio:.6f} x the fp32 graph's (the bf16 score's cost)")
        ring_inputs.append((x, m, ti, tv_))
        if i < 2:  # one input of each width: C=4 (the points), C=64
            t, _ = time_knn_large(torch, kmod, x, m, "default")
            t["max_abs_err"] = err
            t["c"] = x.shape[2]
            log(f"knn TC timing, train block {i} B=1 N={PREC_N} C={x.shape[2]} k={K} [{smi}]: "
                f"{fmt_times(t)} (library = bf16 matmul + torch.topk over strips of 8192 rows)")
            out.append(t)
    log_per_shape("knn TC train shape", out, smi)
    ring_out = phase_ring_on_main_path(torch, kmod, rmod, ring_inputs, smi, precision="default")
    return launches, out, ring_out


def phase_prec_small(torch, kmod, seed: int, smi: str) -> int:
    """Phase 17, part 3: the mixed-precision flags at phase 14's size (one
    TRAIN_N-point event) beside phase 14's f32 flags, from one init, 2
    warm-up and PREC_SMALL_STEPS timed steps each: ms a step, peak memory
    and the losses (printed; the bf16 run's must be finite and fall).
    Returns its TC launches."""
    batch = one_event(TRAIN_N, seed)
    r = run_steps(torch, kmod, prec_config(TRAIN_N), batch, seed, 2, PREC_SMALL_STEPS)
    f = run_steps(torch, kmod, prec_config(TRAIN_N, precision="default", knn_precision="highest",
                                           remat=False), batch, seed, 2, PREC_SMALL_STEPS)
    for label, run in (("bf16 + default + remat", r), ("f32 (phase 14's flags)", f)):
        log(f"train B=1 N={TRAIN_N} {label} [{smi}]: {run['event_ms']:.3f} ms a step (CUDA "
            f"events), {run['host_ms']:.3f} ms (host clock), {TRAIN_N / (run['host_ms'] / 1e3):.1f} "
            f"points/s, peak {run['peak_gib']:.3f} GiB; losses "
            f"{[round(v, 6) for v in run['losses']]}")
    rel = abs(r["losses"][-1] - f["losses"][-1]) / abs(f["losses"][-1])
    log(f"train B=1 N={TRAIN_N}: loss after {2 + PREC_SMALL_STEPS} steps bf16 "
        f"{r['losses'][-1]:.6f} vs f32 {f['losses'][-1]:.6f} (relative difference {rel:.3e}, "
        f"printed, not gated)")
    timed = r["losses"][2:]
    if any(p != (EDGE_BLOCKS, 0, 0) for p in r["per_step"]):
        raise AssertionError(f"bf16 train B=1 N={TRAIN_N}: (Hopper TC, sweep TC, fp32) launches "
                             f"{r['per_step']}")
    if not all(np.isfinite(r["losses"])) or not timed[-1] < timed[0]:
        raise AssertionError(f"bf16 train B=1 N={TRAIN_N}: loss not finite or not falling: {timed}")
    return r["launches"][0]


def phase_prec_cli(torch, kmod, d: str, seed: int, smi: str) -> int:
    """Phase 17, part 4: one ``python3 -m dgcnn_tpu_torch train --precision
    bfloat16 --knn_precision default --remat -i 2`` subprocess on phase
    15's DGB file (exit 0, a checkpoint), then ``inference`` of that
    checkpoint through `cli.main` with the same precision flags: every
    event written, 6 TC launches a batch and no fp32 one. Returns the TC
    launches of the inference."""
    p = lambda *names: os.path.join(d, *names)  # noqa: E731
    flags = ["--precision", "bfloat16", "--knn_precision", "default"]
    data = ["-io", "dgb", "-if", p("events.dgb"), "-np", str(TRAIN_N), "-mn", "residual-dgcnn",
            "-k", str(K), "--edge_filters", *[str(EDGE_WIDTH)] * EDGE_BLOCKS, "--seed", str(seed),
            "-nd", "1", *flags]
    run_subprocess(["-m", "dgcnn_tpu_torch", "train", *data, "-mb", "1", "--remat", "-i", "2",
                    "-wp", p("prec", "snap"), "-ld", p("prec")], d)
    if not os.path.exists(p("prec", "snap-2.ckpt")):
        raise AssertionError("the mixed-precision train child wrote no checkpoint")
    kmod.launches = kmod.launches_f32_hopper = kmod.launches_tc = kmod.launches_tc_sweep = 0
    t0 = time.perf_counter()
    run_cli(torch, ["inference", *data, "-mb", str(CLI_SERVE_B), "-mp", p("prec", "snap"),
                    "-of", p("prec", "pred.npz"), "-ld", p("prec", "ilog")])
    wall = time.perf_counter() - t0
    pred = np.load(p("prec", "pred.npz"))
    want = EDGE_BLOCKS * (CLI_EVENTS // CLI_SERVE_B)
    log(f"cli mixed precision: train -i 2 subprocess exit 0, inference of its checkpoint in "
        f"{wall:.1f} s [{smi}]: {len(pred['event_ids'])} events written, (Hopper TC, sweep TC, "
        f"fp32) launches {exact_counts(kmod)} (want {want}, 0, 0)")
    if exact_counts(kmod) != (want, 0, 0) or len(pred["event_ids"]) != CLI_EVENTS:
        raise AssertionError("cli mixed-precision inference: launches or events off")
    return kmod.launches_tc


def phase_prec_serving(torch, kmod, bmod, seed: int, smi: str):
    """Phase 17, part 5: serving with ``--precision bfloat16
    --knn_precision default``: one 4 x 4096 batch through
    `Trainval.inference` (6 TC exact launches, no fp32 one), then the TC
    kernel checked and timed on that forward's six graph-build inputs; one
    1,048,576-point event with ``knn_window`` LONG_W (6 banded TC launches,
    no fp32 banded or exact one, the streamed head once), then the banded
    TC kernel on that forward's inputs. Returns ``(exact TC launches, its
    per-launch records, banded TC launches, its per-launch records)``."""
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.models import head as thead
    from dgcnn_tpu_torch.train.trainval import Trainval

    flags = dict(precision="bfloat16", knn_precision="default")
    cfg = Config(model_name="residual-dgcnn", num_class=2, kvalue=K,
                 edge_filters=(EDGE_WIDTH,) * EDGE_BLOCKS, minibatch_size=B, num_point=N, **flags)
    tv = Trainval(cfg)
    state = tv.initialize(4, generator=torch.Generator().manual_seed(seed))
    batch = serving_batches(cfg, seed)[0]
    kmod.launches = kmod.launches_f32_hopper = kmod.launches_tc = kmod.launches_tc_sweep = 0
    (scores, pred, metrics), ms = cuda_once(torch, lambda: tv.inference(state, batch))
    check_outputs(torch, scores, pred, metrics, batch, cfg.num_class)
    serve = exact_counts(kmod)
    log(f"mixed precision serving B={B} N={N} [{smi}]: (Hopper TC, sweep TC, fp32) exact "
        f"launches {serve}, {ms:.3f} ms (CUDA events), loss={float(metrics['loss']):.6f}")
    if serve != (EDGE_BLOCKS, 0, 0):
        raise AssertionError(f"mixed precision serving: (Hopper TC, sweep TC, fp32) launches "
                             f"{serve}")
    per_launch = kernel_on_main_path_inputs(torch, kmod, tv, state, batch, smi, precision="default")
    del tv, state

    lcfg = dataclasses.replace(cfg, minibatch_size=1, num_point=LONG_N, knn_window=LONG_W)
    tv = Trainval(lcfg)
    state = tv.initialize(4, generator=torch.Generator().manual_seed(seed))
    event = long_events(seed)[0]
    kmod.launches = kmod.launches_f32_hopper = kmod.launches_tc = kmod.launches_tc_sweep = 0
    bmod.launches = bmod.launches_tc = bmod.launches_tc_sweep = thead.runs = 0
    torch.cuda.reset_peak_memory_stats()
    (scores, pred, metrics), ms = cuda_once(torch, lambda: tv.inference(state, event))
    check_outputs(torch, scores, pred, metrics, event, lcfg.num_class)
    long = (bmod.launches_tc, bmod.launches_tc_sweep, bmod.launches, sum(exact_counts(kmod)),
            thead.runs)
    log(f"mixed precision long event B=1 N={LONG_N} W={LONG_W} [{smi}]: (banded Hopper TC, "
        f"banded sweep TC, banded fp32, exact, streamed head) {long}, {ms:.3f} ms (CUDA events), "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"loss={float(metrics['loss']):.6f}")
    if long != (EDGE_BLOCKS, 0, 0, 0, 1):
        raise AssertionError(f"mixed precision long event: launches {long}")
    points = torch.tensor(event.points, device="cuda")
    mask = torch.tensor(event.mask, device="cuda")
    banded_per_launch = banded_on_main_path_inputs(torch, kmod, bmod, tv, state, points, mask, smi,
                                                   precision="default")
    return serve[0], per_launch, long[0], banded_per_launch


def cp_tc_rank(group, seed: int):
    """One rank of phase 17's CP serving: the first CP event through
    `Trainval.inference_packed` with ``knn_precision="default"``, every
    kernel count at 0 before and read after; the first block's graph."""
    import torch

    from dgcnn_tpu_torch.kernels import knn_cuda as kmod
    from dgcnn_tpu_torch.kernels import ring_knn_cuda as rmod
    from dgcnn_tpu_torch.parallel.collectives import broadcast_tree
    from dgcnn_tpu_torch.train.trainval import Trainval, TrainState

    tv = Trainval(dataclasses.replace(cp_config(), knn_precision="default"), group=group)
    state = tv.initialize(4, generator=torch.Generator().manual_seed(seed))
    state = TrainState(broadcast_tree(state.params, group), broadcast_tree(state.model_state, group))
    event = cp_events(seed)[0]
    rmod.launches = rmod.launches_tc = rmod.launches_tc_sweep = 0
    kmod.launches = kmod.launches_f32_hopper = kmod.launches_tc = kmod.launches_tc_sweep = 0
    packed, metrics = tv.inference_packed(state, event)
    torch.cuda.synchronize()
    counts = (rmod.launches_tc, rmod.launches_tc_sweep, rmod.launches,
              kmod.launches_tc + kmod.launches_tc_sweep + kmod.launches)
    points, _, _, mask = tv._put_batch(event)
    with torch.inference_mode():
        gi, gv = tv.model.knn_fn(points.float(), K, mask)
    return {"rank": group.rank, "packed": packed.cpu(), "launches": counts,
            "metrics": {k: v.cpu() for k, v in metrics.items()},
            "first_graph": (gi.cpu(), gv.cpu()), "backend": group.backend}


def phase_prec_cp(torch, kmod, seed: int, smi: str) -> int:
    """Phase 17, CP: one CP_N-point event served on CP_P ranks with
    ``ring_impl="rdma"`` and ``knn_precision="default"``: exactly 24 ring
    TC launches on each rank and no fp32 ring or exact one, the packed
    outputs identical on every rank, and the first block's graph of all
    ranks equal to the exact TC kernel's graph of the whole event, index
    for index (CP still equals one device). Returns the ring TC launches."""
    from dgcnn_tpu_torch.parallel.launch import run_point_ranks

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_point_ranks(cp_tc_rank, CP_P, device="cuda", args=(seed,), timeout=900)
    event = cp_events(seed)[0]
    want = (EDGE_BLOCKS * CP_P, 0, 0, 0)
    for r in ranks:
        if r["launches"] != want:
            raise AssertionError(f"cp TC rank {r['rank']}: (ring Hopper TC, ring sweep TC, ring "
                                 f"fp32, exact) launches {r['launches']}, want {want}")
        if not np.array_equal(r["packed"], ranks[0]["packed"]):
            raise AssertionError(f"cp TC: rank {r['rank']}'s packed output differs from rank 0's")
    check_packed(ranks[0]["packed"], ranks[0]["metrics"], event.mask, 2)
    points = torch.tensor(event.points, device="cuda").float()
    mask = torch.tensor(event.mask, device="cuda")
    ei, ev = (t.cpu().numpy() for t in kmod.knn_cuda(points, K, mask, precision="default"))
    # the ranks' results come back as numpy
    gi = np.concatenate([r["first_graph"][0] for r in ranks], 1)
    gv = np.concatenate([r["first_graph"][1] for r in ranks], 1)
    same = np.array_equal(gi, ei) and np.array_equal(gv, ev)
    log(f"cp serving TC: 1 event of 1x{CP_N} on {CP_P} ranks (backend {ranks[0]['backend']}) in "
        f"{time.perf_counter() - t0:.1f} s with start-up [{smi}]: (ring Hopper TC, ring sweep "
        f"TC, ring fp32, exact) launches {want} on each rank; packed outputs identical; first block's graph == exact TC "
        f"kernel's over the whole event: {same}; loss={float(ranks[0]['metrics']['loss']):.6f}")
    if not same:
        raise AssertionError("cp TC: the ring's first graph differs from the exact TC kernel's")
    return want[0] * CP_P


def phase_tc_on_other_inputs(torch, kmod, bmod, rmod, seed: int) -> dict:
    """Phase 17: the exact TC kernel (the Hopper kernel, by
    `tc_kernel_for`) against `knn_plain` and against sweep_tc
    (`check_knn`) on phase 4's and phase 9's ragged inputs and their
    all-equal forms, and at the Hopper kernels' widest width (C =
    TC_MAX_C2 - 2): the exact kernel on phase 13's kind of input at k = K
    and KMAX, self and cross; the banded pass on phase 4's kind (W=1024,
    self and halo cross form) and the ring step on phase 9's kind, each
    with its all-equal form, against their plain versions and sweep_tc.
    Returns the largest score difference per kernel."""
    dev = torch.device("cuda")
    err = 0.0
    pr = dict(precision="default")
    for phase, make in ((4, banded_ragged_inputs), (9, ring_ragged_inputs)):
        for c in (4, EDGE_WIDTH):
            x, mask = make(seed, c)
            mt = torch.tensor(mask, device=dev)
            for kind, xn in (("random", x), ("all-equal", all_equal(x, mask))):
                xt = torch.tensor(xn, device=dev)
                err = max(err, check_knn(torch, kmod, f"phase-{phase} inputs {kind} C={c} self", xt,
                                         xt, mt, xn, ties=kind == "all-equal", **pr))
    c = kmod.TC_MAX_C2 - 2
    x, mask = ragged_inputs(seed, c)
    xt, mt = torch.tensor(x, device=dev), torch.tensor(mask, device=dev)
    xe_np = all_equal(x, mask)
    xe = torch.tensor(xe_np, device=dev)
    for k in (K, kmod.KMAX):
        err = max(err, check_knn(torch, kmod, f"widest width C={c} self", xt, xt, mt, x, k=k, **pr),
                  check_knn(torch, kmod, f"widest width C={c} cross", xt[:, :1000].contiguous(), xt,
                            mt, x[:, :1000], xk_np=x, cross=True, k=k, **pr),
                  check_knn(torch, kmod, f"widest width all-equal C={c} self", xe, xe, mt, xe_np,
                            ties=True, k=k, **pr))
    out = {"knn": err, "banded": 0.0, "ring": 0.0}
    x, mask = banded_ragged_inputs(seed, c)
    mt = torch.tensor(mask, device=dev)
    nvalid = mt.sum(-1).to(torch.int32)
    w, (s0, s1) = 1024, (RAGGED_N // 4, RAGGED_N // 2)
    for kind, xn in (("random", x), ("all-equal", all_equal(x, mask))):
        xt = torch.tensor(xn, device=dev)
        ties = kind == "all-equal"
        out["banded"] = max(
            out["banded"],
            check_banded(torch, bmod, f"widest width {kind} C={c} self", xt, xt, mt, w, xn,
                         ties=ties, **pr)[0],
            check_banded(torch, bmod, f"widest width {kind} C={c} cross q_base={s0} "
                         f"key_base={s0 - w}", xt[:, s0:s1].contiguous(),
                         xt[:, s0 - w:s1 + w].contiguous(), mt[:, s0 - w:s1 + w].contiguous(), w,
                         xn, q_rows=slice(s0, s1),
                         band=dict(q_base=s0, key_base=s0 - w, nvalid=nvalid), ties=ties, **pr)[0])
    x, mask = ring_ragged_inputs(seed, c)
    xt, mt = torch.tensor(x, device=dev), torch.tensor(mask, device=dev)
    xe = torch.tensor(all_equal(x, mask), device=dev)
    out["ring"] = max(
        check_ring(torch, kmod, rmod, f"widest width random C={c}", xt, mt,
                   kmod.knn_cuda(xt, K, mt, **pr), range(CP_P), **pr),
        check_ring(torch, kmod, rmod, f"widest width all-equal C={c}", xe, mt,
                   kmod.knn_cuda(xe, K, mt, **pr), range(CP_P), ties=True, **pr))
    return out


def phase_prec(torch, kmod, bmod, rmod, seed: int, smi: str, d: str, profile: bool = False) -> list:
    """Phase 17, mixed precision: the TC kernels against their plain
    versions on phase 3's, 4's, 9's and 13's inputs; the bf16 train step at
    1 x PREC_N with remat, and at 1 x TRAIN_N; the command line on the DGB
    file in ``d``; serving (exact, banded, CP). Returns the three TC
    kernels' entries of the kernels line."""
    tc_err = {
        "knn": phase_kernel_vs_plain(torch, kmod, seed, smi, precision="default"),
        "banded": phase_banded_vs_plain(torch, bmod, seed, precision="default"),
        "ring": phase_ring_vs_plain(torch, kmod, rmod, seed, smi, precision="default"),
    }
    tc_wide = phase_wide_and_long_k(torch, kmod, bmod, rmod, seed, smi, precision="default")
    for name, e in phase_tc_on_other_inputs(torch, kmod, bmod, rmod, seed).items():
        tc_err[name] = max(tc_err[name], e)
    tc_train, tc_train_per_launch, ring_tc_per_launch = phase_prec_train(torch, kmod, rmod, seed,
                                                                         smi, profile)
    tc_small = phase_prec_small(torch, kmod, seed, smi)
    tc_cli = phase_prec_cli(torch, kmod, d, seed, smi)
    tc_serve, tc_per_launch, banded_tc, banded_tc_per_launch = phase_prec_serving(
        torch, kmod, bmod, seed, smi)
    ring_tc = phase_prec_cp(torch, kmod, seed, smi)
    tc_entry = kernel_entry(
        "knn_cuda_tc", "dgcnn_tpu_torch/csrc/knn_tc.cuh", "dgcnn_tpu/kernels/knn_pallas.py:52",
        tc_train + tc_small + tc_cli + tc_serve, tc_per_launch,
        f"the Hopper TC kernel (csrc/knn_tc.cuh, launched by csrc/knn.cu's dgcnn_knn_topk_tc: "
        f"TMA key tiles, a warp-specialised mbarrier pipeline, wgmma, the filter in registers; "
        f"--knn_precision default, the Pallas kernel's Precision.DEFAULT at "
        f"knn_pallas.py:108-114); mean per launch over one bf16 served forward's "
        f"{len(tc_per_launch)} graph builds, B={B} N={N} k={K}, C=4 once and C={EDGE_WIDTH} "
        f"{len(tc_per_launch) - 1} times; train_shape_ms: step 1's graph builds of the bf16 remat "
        f"train step, B=1 N={PREC_N} (blocks 0 and 1); sweep_tc_kernel_only_ms: the shared "
        f"sweep's TC instantiation (sweep_tc) alone on the same operands, timed in turns with "
        f"the Hopper kernel; bound at the bf16 tensor-core peak; library_ms is a bf16 matmul + "
        f"torch.topk",
        extra_err=max([tc_err["knn"], tc_wide["knn"]]
                      + [t["max_abs_err"] for t in tc_train_per_launch]),
    )
    tc_entry["launches_by_path"] = {"train_131072": tc_train, "train_16384": tc_small,
                                    "cli": tc_cli, "serve": tc_serve}
    tc_entry["train_shape_ms"] = {
        shape: {"ms": ts["wrapper_ms"], "kernel_only_ms": ts["kernel_ms"],
                "sweep_tc_kernel_only_ms": ts["sweep_ms"], "bound_ms": ts["bound_ms"],
                "plain_ms": ts["plain_ms"], "library_ms": ts["library_ms"]}
        for shape, ts in per_shape(tc_train_per_launch).items()}
    banded_entry = kernel_entry(
        "knn_banded_cuda_tc", "dgcnn_tpu_torch/csrc/knn_tc.cuh",
        "dgcnn_tpu/kernels/knn_banded.py:86", banded_tc, banded_tc_per_launch,
        f"the Hopper TC banded pass (csrc/knn_banded.cu's dgcnn_knn_banded_tc on the pipeline of "
        f"csrc/knn_tc.cuh: TMA key tiles of the block's band, outward from the diagonal, wgmma, "
        f"each row's window in registers; --knn_precision default, knn_banded.py:183); mean "
        f"per launch over one bf16 long-event forward's {len(banded_tc_per_launch)} graph "
        f"builds, B=1 N={LONG_N} k={K} W={LONG_W}, C=4 once and C={EDGE_WIDTH} "
        f"{len(banded_tc_per_launch) - 1} times; sweep_tc_kernel_only_ms: the shared sweep's TC "
        f"instantiation (dgcnn_knn_banded_bf16) alone on the same operands, timed in turns with "
        f"the Hopper pass; bound at the bf16 tensor-core peak; library_ms is a strip loop of "
        f"bf16 matmul + band mask + torch.topk",
        extra_err=max(tc_err["banded"], tc_wide["banded"]),
    )
    ring_entry = kernel_entry(
        "ring_knn_cuda_tc", "dgcnn_tpu_torch/csrc/knn_tc.cuh",
        "dgcnn_tpu/kernels/ring_knn_rdma.py:72", ring_tc, ring_tc_per_launch,
        f"the Hopper TC ring step (csrc/ring_knn.cu's dgcnn_ring_knn_step_tc on the pipeline of "
        f"csrc/knn_tc.cuh: the running lists seeded into the warps' registers and written back "
        f"in place, global key indices; --knn_precision default, ring_knn_rdma.py:245); mean "
        f"per launch over the {len(ring_tc_per_launch)} graph builds of step 1 of the bf16 train "
        f"step, B=1 N={PREC_N} over P={CP_P} virtual owners of {PREC_N // CP_P} (rank 0's ring "
        f"order, fresh lists), k={K}, C=4 once and C={EDGE_WIDTH} {len(ring_tc_per_launch) - 1} "
        f"times; launches: all {CP_P} ranks over 1 CP event served with knn_precision=default; "
        f"sweep_tc_kernel_only_ms: the shared sweep's TC instantiation "
        f"(dgcnn_ring_knn_step_bf16) alone on the same operands, timed in turns with the Hopper "
        f"step; bound at the bf16 tensor-core peak; library_ms is bf16 matmul + torch.topk + "
        f"sort merge per block",
        extra_err=max(tc_err["ring"], tc_wide["ring"]),
    )
    for entry, per_launch in ((tc_entry, tc_per_launch), (banded_entry, banded_tc_per_launch),
                              (ring_entry, ring_tc_per_launch)):
        entry["sweep_tc_kernel_only_ms"] = sum(t["sweep_ms"] for t in per_launch) / len(per_launch)
        for shape, ts in per_shape(per_launch).items():
            entry["per_shape_ms"][shape]["sweep_tc_kernel_only_ms"] = ts["sweep_ms"]
    return [tc_entry, banded_entry, ring_entry]


def long_config(n: int, **kw):
    """The flagship residual-dgcnn (6 x 64, k=20, head 1024 -> 512 -> 256)
    on one event of ``n`` points, Adam at 1e-3, f32 (``kw`` overrides)."""
    from dgcnn_tpu_torch.config import Config

    return Config(**{**dict(model_name="residual-dgcnn", num_class=2, kvalue=K,
                            edge_filters=(EDGE_WIDTH,) * EDGE_BLOCKS, head_feat_dim=1024,
                            head_mlp=(512, 256), minibatch_size=1, num_point=n,
                            optimizer="adam", learning_rate=1e-3), **kw})


def pinned_loss_grads(torch, cfg, batch, seed: int, graphs, capture=None, pool_fn=None,
                      shuffle: int | None = None):
    """The loss and the gradients of one train-mode forward of a `Trainval`
    of ``cfg`` from the seeded init, its graph builds replaced by
    ``graphs`` in order (the train step's objective, before any update):
    ``(loss, {group: [gradients]})`` over the parameter groups of
    PIN_GROUPS. ``shuffle`` (a seed): the same event and graphs with the
    points in a random order (for a banded model, after the model's own
    entry sort, which the model then skips), so every sum over points is
    reassociated throughout and nothing else changes. ``capture``: a list that receives each
    graph build's input ``(x, mask)``; ``pool_fn``: the model's global pool
    (`shard_pool`)."""
    from dgcnn_tpu_torch.bridge import tree_leaves, tree_map
    from dgcnn_tpu_torch.ops.sfc import morton_order
    from dgcnn_tpu_torch.train import trainval as tvm

    tv = tvm.Trainval(cfg)
    state = tv.initialize(4, generator=torch.Generator().manual_seed(seed))
    points, labels, weights, mask = tv._put_batch(batch)
    if shuffle is not None:
        if cfg.knn_window:
            order, _ = morton_order(points, mask)
            points = torch.gather(points, 1, order[..., None].expand(points.shape))
            labels, weights, mask = (torch.gather(a, 1, order) for a in (labels, weights, mask))
            tv.model.pre_sorted = True
        perm = torch.randperm(points.shape[1], generator=torch.Generator().manual_seed(
            shuffle)).to(points.device)
        inv = torch.argsort(perm)
        points, labels, weights, mask = (a[:, perm] for a in (points, labels, weights, mask))
        graphs = [(inv[i[:, perm].long()].to(i.dtype), v[:, perm]) for i, v in graphs]
    replay = iter(graphs)

    def knn(x, k, m):
        if capture is not None:
            capture.append((x.detach().clone(), m.clone()))
        return next(replay)

    tv.model.knn_fn = knn
    if pool_fn is not None:
        tv.model.pool_fn = pool_fn
    live = tree_map(lambda t: t.detach().requires_grad_(True), state.params)
    groups = {name: tree_leaves(pick(live)) for name, pick in PIN_GROUPS.items()}
    with torch.enable_grad():
        logits, _ = tv.model(live, state.model_state, points, mask, train=True)
        loss_sum, w_sum = tvm._weighted_sums(logits, labels, weights, mask, tv._cls_w)
        loss = loss_sum / torch.clamp(w_sum, min=1e-9)
        grads = iter(torch.autograd.grad(loss, [t for g in groups.values() for t in g]))
        out = float(loss.detach()), {name: [next(grads).detach() for _ in g]
                                     for name, g in groups.items()}
    del tv, state, live, logits, grads
    torch.cuda.empty_cache()
    return out


def pinned_gap(a, b, l2: bool = False) -> dict:
    """Run ``a`` against run ``b`` of `pinned_loss_grads`: the loss's
    relative difference, and the largest gradient difference of every
    parameter group over the largest gradient entry of ``b`` (all
    groups); ``l2``: each group's L2 distance over the L2 norm of ``b``'s
    whole gradient instead."""
    (la, ga), (lb, gb) = a, b
    if l2:
        def norm(ts):
            return sum(float(t.double().square().sum()) for t in ts) ** 0.5

        whole = norm([g for gs in gb.values() for g in gs])
        gap = {name: norm([x - y for x, y in zip(ga[name], gb[name])]) / whole for name in gb}
    else:
        top = max(float(g.abs().max()) for gs in gb.values() for g in gs)
        gap = {name: max(float((x - y).abs().max()) for x, y in zip(ga[name], gb[name])) / top
               for name in gb}
    return {"loss": abs(la - lb) / abs(lb), "groups": gap}


def compare_pinned(label, streamed, dense, witness, smi: str, loss_rtol: float = PIN_RTOL,
                   bf16: bool = False) -> None:
    """A run against the reference on one pinned graph, each measured
    against the gap that reassociation alone makes in the same process:
    ``witness``, the reference on the event with its points in a random
    order (`pinned_loss_grads` with ``shuffle``). The loss within
    ``loss_rtol`` relative, at least PIN_SPREAD_FACTOR times the witness's
    loss gap; each parameter group's gradients within PIN_SPREAD_FACTOR
    times the same group's witness gap, at least PIN_RTOL of the largest
    gradient entry. ``bf16``: a last-bit change of a sum (a matmul of
    another shape on each rank) flips the bf16 rounding of a feature, and
    so which neighbour or point wins a max: each flip moves a few gradient
    entries far, which the largest entry reads as the whole. So each group
    is held by its L2 distance over the whole gradient's L2 norm, at
    PIN_SPREAD_FACTOR times the witness's, at least BF16_GRAD_SHARE, and
    the loss at least BF16_LOSS_RTOL."""
    got, spread = pinned_gap(streamed, dense, l2=bf16), pinned_gap(witness, dense, l2=bf16)
    floor = BF16_GRAD_SHARE if bf16 else PIN_RTOL
    limits = {k: max(floor, PIN_SPREAD_FACTOR * v) for k, v in spread["groups"].items()}
    loss_rtol = max(BF16_LOSS_RTOL if bf16 else loss_rtol, PIN_SPREAD_FACTOR * spread["loss"])
    fmt = lambda gaps: ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())  # noqa: E731
    metric = ("gradient L2 distance over the whole gradient's L2 norm" if bf16 else
              "largest gradient difference over the largest gradient entry")
    log(f"{label} [{smi}]: loss relative {got['loss']:.3e} (limit {loss_rtol:.3e}); {metric}: "
        f"{fmt(got['groups'])} (limits {fmt(limits)}: max({floor}, {PIN_SPREAD_FACTOR} x the "
        f"witness's)); witness (the reference on the event in a random point order, against "
        f"the reference): loss relative {spread['loss']:.3e}; {fmt(spread['groups'])}")
    over = {k: v for k, v in got["groups"].items() if v > limits[k]}
    if got["loss"] > loss_rtol or over:
        raise AssertionError(f"{label}: loss relative {got['loss']:.3e} (limit {loss_rtol:.3e}), "
                             f"gradients over their limits: {over}")


def log_train_run(label, r, n: int, smi: str) -> None:
    timed = r["losses"][LONG_WARMUP:]
    log(f"{label} [{smi}]: {r['event_ms']:.3f} ms a step (CUDA events), {r['host_ms']:.3f} ms "
        f"(host clock, synchronized), {n / (r['host_ms'] / 1e3):.1f} points/s, peak device "
        f"memory {r['peak_gib']:.3f} GiB; losses {[round(v, 6) for v in r['losses']]}")
    if not all(np.isfinite(r["losses"])) or not timed[-1] < timed[0]:
        raise AssertionError(f"{label}: loss not finite or not falling over the timed steps: "
                             f"{timed}")
    if "profile" in r:
        log(r["profile"])
        log(f"{label} profile [{smi}]: device busy {r['busy_ms']:.3f} ms a step (profiler, "
            f"device events); idle share of a timed step 1 - {r['busy_ms']:.3f} / "
            f"{r['host_ms']:.3f} ms = {1 - r['busy_ms'] / r['host_ms']:.3f}")


def phase_long_train(torch, kmod, seed: int, smi: str, profile: bool):
    """Phase 18, part 1: the f32 train step of the flagship on one
    LONG_TRAIN_N-point event, exact graph, phase 14's flags: every block's
    `GatheredStats` streams (6 a step) and the exact kernel launches 6 times
    a step; ms, points/s, peak. On step 1's graph, pinned, one step's loss
    and gradients with SLOT_STREAM_ELEMS past the event (the dense
    traversal) against the streamed step's (`compare_pinned`). The train
    step's own kernel call (`knn_cuda`, the whole event) held against
    `knn_plain` on step 1's graph-build inputs of width 4 and 64 and
    timed there. Returns ``(launches, per-launch records)``."""
    from dgcnn_tpu_torch.ops import edge as tedge

    batch = one_event(LONG_TRAIN_N, seed)
    cfg = long_config(LONG_TRAIN_N)
    log(f"long f32 train: residual-dgcnn edge_filters={cfg.edge_filters} k={K} head "
        f"{cfg.head_feat_dim}->{'->'.join(map(str, cfg.head_mlp))}, B=1 N={LONG_TRAIN_N} "
        f"({int(batch.mask.sum())} valid), exact graph, f32, no remat, {cfg.optimizer} lr "
        f"{cfg.learning_rate}, {LONG_WARMUP} warm-up + {LONG_STEPS} timed steps on one batch")
    tedge.stream_runs = 0
    r = run_steps(torch, kmod, cfg, batch, seed, LONG_WARMUP, LONG_STEPS, record=True,
                  profile=profile)
    steps = LONG_WARMUP + LONG_STEPS + bool(profile)
    log(f"long f32 train counts: (Hopper TC, sweep TC, fp32) exact-kernel launches a step "
        f"{r['per_step']}; streamed GatheredStats forwards {tedge.stream_runs} over {steps} steps")
    if any(p != (0, 0, EDGE_BLOCKS) for p in r["per_step"]) or \
            tedge.stream_runs != EDGE_BLOCKS * steps:
        raise AssertionError(f"long f32 train: exact launches a step {r['per_step']}, streamed "
                             f"forwards {tedge.stream_runs}; want (0, 0, {EDGE_BLOCKS}) and "
                             f"{EDGE_BLOCKS * steps}")
    log_train_run("long f32 train step, 1 x 131,072", r, LONG_TRAIN_N, smi)
    launches = r["launches"][2]

    streamed = pinned_loss_grads(torch, cfg, batch, seed, r["graphs"])
    line = tedge.SLOT_STREAM_ELEMS
    tedge.SLOT_STREAM_ELEMS = 2**62
    try:
        dense = pinned_loss_grads(torch, cfg, batch, seed, r["graphs"])
        witness = pinned_loss_grads(torch, cfg, batch, seed, r["graphs"], shuffle=seed)
    finally:
        tedge.SLOT_STREAM_ELEMS = line
    compare_pinned("long f32 train, streamed vs dense GatheredStats on step 1's graph",
                   streamed, dense, witness, smi)

    out = []
    for i, (x, m) in enumerate(r["captured"][:2]):  # C=4 (the points) and C=64
        t, ref = time_knn_large(torch, kmod, x, m, "highest")
        err = check_knn(torch, kmod, f"long f32 train step 1 block {i} C={x.shape[-1]}", x, x, m,
                        x.cpu().numpy(), ref=ref)
        t.update(max_abs_err=err, c=x.shape[2])
        log(f"knn timing, long f32 train block {i} B=1 N={LONG_TRAIN_N} C={x.shape[2]} k={K} "
            f"[{smi}]: {fmt_times(t)} (library = fp32 matmul + torch.topk over strips of 8192 "
            f"rows)")
        out.append(t)
    log_per_shape("knn long f32 train shape", out, smi)
    return launches, out


def phase_long_banded_train(torch, kmod, bmod, seed: int, smi: str, profile: bool):
    """Phase 18, part 2: the f32 banded train step with ``--remat`` on one
    LONG_N-point event, W=LONG_W: the banded kernel 6 times a step, the
    exact kernel never, the streamed head once a step in train mode, the
    streamed `GatheredStats` in every block (twice with remat's
    recompute); ms, points/s, peak. On step 1's graph, pinned, the streamed
    head's loss and gradients against the dense head's
    (``head_stream="off"``). The banded kernel checked and timed on step
    1's inputs. Returns ``(launches, per-launch records)``."""
    from dgcnn_tpu_torch.models import head as thead
    from dgcnn_tpu_torch.ops import edge as tedge

    batch = one_event(LONG_N, seed + 1)
    cfg = long_config(LONG_N, knn_window=LONG_W, remat=True)
    log(f"long banded train: B=1 N={LONG_N} ({int(batch.mask.sum())} valid), knn_window="
        f"{LONG_W}, f32, --remat, {LONG_WARMUP} warm-up + {LONG_STEPS} timed steps")
    bmod.launches = bmod.launches_tc = bmod.launches_tc_sweep = thead.runs = 0
    tedge.stream_runs = 0
    r = run_steps(torch, kmod, cfg, batch, seed, LONG_WARMUP, LONG_STEPS, record=True,
                  profile=profile)
    steps = LONG_WARMUP + LONG_STEPS + bool(profile)
    counts = (bmod.launches, bmod.launches_tc + bmod.launches_tc_sweep, sum(r["launches"]),
              thead.runs, tedge.stream_runs)
    want = (EDGE_BLOCKS * steps, 0, 0, steps, 2 * EDGE_BLOCKS * steps)
    log(f"long banded train counts over {steps} steps: (banded fp32, banded TC, exact, streamed "
        f"head, streamed GatheredStats forwards incl. remat's recompute) {counts}, want {want}")
    if counts != want:
        raise AssertionError(f"long banded train: counts {counts}, want {want}")
    log_train_run(f"long banded train step, 1 x 1,048,576 W={LONG_W} --remat", r, LONG_N, smi)
    launches = counts[0]

    streamed = pinned_loss_grads(torch, cfg, batch, seed, r["graphs"])
    dense_cfg = dataclasses.replace(cfg, head_stream="off")
    dense = pinned_loss_grads(torch, dense_cfg, batch, seed, r["graphs"])
    witness = pinned_loss_grads(torch, dense_cfg, batch, seed, r["graphs"], shuffle=seed)
    compare_pinned("long banded train, streamed vs dense head on step 1's graph", streamed,
                   dense, witness, smi)
    return launches, banded_times(torch, kmod, bmod, r["captured"][:2], smi,
                                  label="long banded train")


def serve_events(n: int, seed: int):
    """One fixed-length event of ``n`` points and one variable-length one
    padded to ``n``, one event a batch."""
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO

    out = []
    for i, variable in enumerate((False, True)):
        io = SyntheticIO(num_events=1, num_point=n, seed=seed + i, variable_length=variable)
        io.initialize()
        out += list(BucketBatcher(io, 1, num_point=n, shuffle=False).epoch())
    return out


def phase_long_bf16_serving(torch, kmod, bmod, seed: int, smi: str):
    """Phase 18, part 3: bf16 serving (``--precision bfloat16
    --knn_precision default``) of SERVE_BF16_N-point events, W=LONG_W, one
    full and one padded: per event 6 banded Hopper TC launches (no
    sweep_tc, fp32 or exact one), the edge form's slot stream in all 6
    blocks, the streamed head once; ms an event, valid points/s, peak. The
    same forward on the same graph with EDGE_EVAL_STREAM_ELEMS raised (the
    dense bf16 edge form) on a padded BF16_DENSE_N-point event: predictions
    equal on at least 99.9% of the valid points, logits within
    BF16_LOGIT_TOL of the largest. The TC banded pass checked and timed on
    the first two graph-build inputs.
    Returns ``(launches, per-launch records)``."""
    from dgcnn_tpu_torch.models import dgcnn as tdgcnn
    from dgcnn_tpu_torch.models import head as thead
    from dgcnn_tpu_torch.train.trainval import Trainval

    cfg = long_config(SERVE_BF16_N, knn_window=LONG_W, precision="bfloat16",
                      knn_precision="default")
    tv = Trainval(cfg)
    state = tv.initialize(4, generator=torch.Generator().manual_seed(seed))
    t0 = time.perf_counter()
    events = serve_events(SERVE_BF16_N, seed + 40)
    valid = [int(e.mask.sum()) for e in events]
    log(f"long bf16 serving: B=1 N={SERVE_BF16_N}, knn_window={LONG_W}, --precision bfloat16 "
        f"--knn_precision default, {len(events)} events (the second variable-length), valid "
        f"points {valid} (made on the host in {time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters = lambda: (bmod.launches_tc, bmod.launches_tc_sweep, bmod.launches,  # noqa: E731
                        sum(exact_counts(kmod)), tdgcnn.block_forms["edge_stream"], thead.runs)
    bmod.launches = bmod.launches_tc = bmod.launches_tc_sweep = 0
    kmod.launches = kmod.launches_f32_hopper = kmod.launches_tc = kmod.launches_tc_sweep = 0
    tdgcnn.block_forms["edge_stream"] = thead.runs = 0
    for i, batch in enumerate(events):
        before = counters()
        scores, pred, metrics = tv.inference(state, batch)
        torch.cuda.synchronize()
        rose = tuple(a - b for a, b in zip(counters(), before))
        want = (EDGE_BLOCKS, 0, 0, 0, EDGE_BLOCKS, 1)
        log(f"long bf16 event {i}: (banded Hopper TC, sweep_tc, fp32, exact, edge slot streams, "
            f"streamed head) +{rose}, loss={float(metrics['loss']):.6f}")
        if rose != want:
            raise AssertionError(f"long bf16 event {i}: counts +{rose}, want +{want}")
        check_outputs(torch, scores, pred, metrics, batch, cfg.num_class)
    launches = bmod.launches_tc
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, batch in enumerate(events):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores, pred, _ = tv.inference(state, batch)
        scores.cpu(), pred.cpu()
        dt = time.perf_counter() - t0
        log(f"long bf16 serving time [{smi}]: event {i} {dt * 1e3:.3f} ms, {valid[i] / dt:.1f} "
            f"valid points/s (host clock incl. copy to host); peak device memory {peak:.3f} GiB")

    per_launch = banded_on_main_path_inputs(
        torch, kmod, bmod, tv, state, torch.tensor(events[0].points, device="cuda"),
        torch.tensor(events[0].mask, device="cuda"), smi, precision="default", limit=2,
        label="long bf16 serving")
    torch.cuda.empty_cache()

    # the dense edge form on the streamed forward's graph, on a padded event
    # of BF16_DENSE_N points (past the line too): at SERVE_BF16_N the dense
    # bf16 form's f32 BN outputs of (N, k, C) do not fit the card
    batch = serve_events(BF16_DENSE_N, seed + 42)[1]
    points = torch.tensor(batch.points, device="cuda")
    mask = torch.tensor(batch.mask, device="cuda")
    graphs = []
    build = tv.model.knn_fn

    def recording(x, k, m):
        graphs.append(build(x, k, m))
        return graphs[-1]

    with torch.inference_mode():
        tv.model.knn_fn = recording
        streamed, _ = tv.model(state.params, state.model_state, points, mask)
        replay = iter(graphs)
        tv.model.knn_fn = lambda x, k, m: next(replay)
        line = tdgcnn.EDGE_EVAL_STREAM_ELEMS
        tdgcnn.EDGE_EVAL_STREAM_ELEMS = 2**62
        torch.cuda.reset_peak_memory_stats()
        try:
            dense, _ = tv.model(state.params, state.model_state, points, mask)
        finally:
            tdgcnn.EDGE_EVAL_STREAM_ELEMS = line
            tv.model.knn_fn = build
    dense_peak = torch.cuda.max_memory_allocated() / 2**30
    m = mask[0]
    same = float((streamed.argmax(-1) == dense.argmax(-1))[0][m].float().mean())
    diff = float((streamed - dense).abs()[0][m].max())
    top = float(dense.abs()[0][m].max())
    log(f"long bf16 edge slot stream vs the dense edge form, 1 x {BF16_DENSE_N} "
        f"({int(batch.mask.sum())} valid) on one graph [{smi}]: "
        f"predictions equal on {same:.6f} of the valid points (limit {BF16_PRED_SHARE}), max "
        f"|logit diff| {diff:.4e} = {diff / top:.4e} of the largest |logit| {top:.4e} (limit "
        f"{BF16_LOGIT_TOL}); the dense form's peak device memory {dense_peak:.3f} GiB")
    if same < BF16_PRED_SHARE or diff > BF16_LOGIT_TOL * top:
        raise AssertionError(f"long bf16 serving: streamed vs dense predictions equal on {same}, "
                             f"logits {diff / top:.3e} of the largest")
    del streamed, dense, graphs, tv, state
    torch.cuda.empty_cache()
    return launches, per_launch


def banded_cp_rank(group, seed: int):
    """One rank of phase 19 (run by `run_point_ranks`): for each knn
    precision, `Trainval(point_shards=CP_P, knn_window=LONG_W)` with rank 0's
    seeded weights serves the BANDED_CP_N-point events (counts set to 0
    before and read after each), times them, and builds the first graph on
    its band."""
    import torch

    from dgcnn_tpu_torch.kernels import knn_banded_cuda as bmod
    from dgcnn_tpu_torch.kernels import knn_cuda as kmod
    from dgcnn_tpu_torch.kernels import ring_knn_cuda as rmod
    from dgcnn_tpu_torch.parallel.collectives import broadcast_tree
    from dgcnn_tpu_torch.train.trainval import Trainval, TrainState

    events = serve_events(BANDED_CP_N, seed + 50)
    out = {"rank": group.rank, "device": str(group.device), "backend": group.backend,
           "stage_host": group.stage_host, "runs": {}}

    def counts():
        return (bmod.launches, bmod.launches_tc, bmod.launches_tc_sweep, sum(exact_counts(kmod)),
                rmod.launches + rmod.launches_tc + rmod.launches_tc_sweep)

    for precision in ("highest", "default"):
        tv = Trainval(long_config(BANDED_CP_N, knn_window=LONG_W, point_shards=CP_P,
                                  knn_precision=precision), group=group)
        state = tv.initialize(4, generator=torch.Generator().manual_seed(seed))
        state = TrainState(broadcast_tree(state.params, group),
                           broadcast_tree(state.model_state, group))
        torch.cuda.reset_peak_memory_stats()
        bmod.launches = bmod.launches_tc = bmod.launches_tc_sweep = 0
        kmod.launches = kmod.launches_f32_hopper = kmod.launches_tc = kmod.launches_tc_sweep = 0
        rmod.launches = rmod.launches_tc = rmod.launches_tc_sweep = 0
        run = {"events": []}
        for batch in events:
            before = counts()
            packed, metrics = tv.inference_packed(state, batch)
            torch.cuda.synchronize()
            run["events"].append({"packed": packed.cpu(),
                                  "metrics": {k: v.cpu() for k, v in metrics.items()},
                                  "launches": tuple(a - b for a, b in zip(counts(), before))})
        run["main_launches"] = counts()
        run["peak_bytes"] = torch.cuda.max_memory_allocated()
        run["serve_s"] = []
        for batch in events:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores, pred, _ = tv.inference(state, batch)
            scores.cpu(), pred.cpu()
            run["serve_s"].append(time.perf_counter() - t0)
        # every block's graph of event 0 (the first built from the points)
        graphs, build = [], tv.model.knn_fn

        def recording(x, k, m):
            graphs.append(build(x, k, m))
            return graphs[-1]

        tv.model.knn_fn = recording
        tv.inference_packed(state, events[0])
        tv.model.knn_fn = build
        run["graphs"] = [(gi.cpu(), gv.cpu()) for gi, gv in graphs]
        if group.rank == 0:
            run["state"] = (state.params, state.model_state)
        out["runs"][precision] = run
        del tv, state
        torch.cuda.empty_cache()
    return out


def phase_banded_cp(torch, kmod, bmod, seed: int, smi: str):
    """Phase 19: banded context-parallel serving of one full and one padded
    BANDED_CP_N-point event over CP_P ranks (`run_point_ranks`: NCCL with a
    card a rank, else gloo on one card), W=LONG_W, in f32 and with
    ``--knn_precision default``: on each rank the banded kernel's cross
    form 6 times an event, the exact and ring kernels never; the packed
    outputs identical on all ranks; the first graph over the ranks equal
    to the one-device banded kernel's on the valid rows (f32: 0 hard
    mismatches; TC: by the rounded operands' scores); predictions equal to
    the one-device banded model's, scores within CP_SCORE_TOL (by
    precision). The witness of the TC limit: event 0's graphs over the
    ranks against the one-device model's block by block (printed), and the
    one-device model on the ranks' graphs, whose scores must be within the
    f32 limit and whose predictions must be equal. The cross form checked
    and timed on a middle rank's halo operands of the one-device forward's
    first two graph-build inputs. Returns ``{precision: (launches,
    per-launch records)}``."""
    from dgcnn_tpu_torch.bridge import params_from_numpy, tree_map
    from dgcnn_tpu_torch.ops.knn import split_mismatches, split_score_mismatches
    from dgcnn_tpu_torch.ops.sfc import morton_order
    from dgcnn_tpu_torch.parallel.launch import run_point_ranks
    from dgcnn_tpu_torch.train.trainval import Trainval, TrainState

    torch.cuda.empty_cache()  # the ranks share the card with this process
    t0 = time.perf_counter()
    ranks = run_point_ranks(banded_cp_rank, CP_P, device="cuda", args=(seed,), timeout=900)
    events = serve_events(BANDED_CP_N, seed + 50)
    valid = [int(e.mask.sum()) for e in events]
    cards = f"the {CP_P} ranks share the card" if ranks[0]["stage_host"] else "a card a rank"
    log(f"banded cp serving: residual-dgcnn 6 x {EDGE_WIDTH}, k={K}, knn_window={LONG_W}, "
        f"{len(events)} events of 1x{BANDED_CP_N} (the second variable-length), valid points "
        f"{valid}; {CP_P} ranks, backend {ranks[0]['backend']}, devices "
        f"{[r['device'] for r in ranks]} ({cards}); run_point_ranks took "
        f"{time.perf_counter() - t0:.1f} s (rank start-up included)")
    out = {}
    for precision, tc in (("highest", False), ("default", True)):
        tag = " TC" if tc else ""
        runs = [r["runs"][precision] for r in ranks]
        want = (0, EDGE_BLOCKS, 0, 0, 0) if tc else (EDGE_BLOCKS, 0, 0, 0, 0)
        for i, batch in enumerate(events):
            for r, run in zip(ranks, runs):
                if run["events"][i]["launches"] != want:
                    raise AssertionError(f"banded cp{tag} event {i} rank {r['rank']}: (banded "
                                         f"fp32, banded Hopper TC, sweep_tc, exact, ring) "
                                         f"launches +{run['events'][i]['launches']}, want +{want}")
            ref = runs[0]["events"][i]
            for run in runs[1:]:
                if not np.array_equal(run["events"][i]["packed"], ref["packed"]):
                    raise AssertionError(f"banded cp{tag} event {i}: the ranks' packed outputs "
                                         f"differ")
            check_packed(ref["packed"], ref["metrics"], batch.mask, 2)
            log(f"banded cp{tag} event {i}: (banded fp32, banded Hopper TC, sweep_tc, exact, "
                f"ring) launches +{want} on each of {CP_P} ranks; packed outputs identical on "
                f"all ranks; loss={float(ref['metrics']['loss']):.6f}")
        for i in range(len(events)):
            dt = runs[0]["serve_s"][i]
            log(f"banded cp{tag} serving time [{smi}]: event {i} {dt * 1e3:.3f} ms, "
                f"{valid[i] / dt:.1f} valid points/s (rank 0's host clock incl. copy to host; "
                f"all ranks {[round(run['serve_s'][i] * 1e3, 3) for run in runs]} ms; {cards}); "
                f"peak device memory a rank "
                f"{[round(run['peak_bytes'] / 2**30, 3) for run in runs]} GiB")

        # one device: the same weights, the banded model, the same events
        tv = Trainval(long_config(BANDED_CP_N, knn_window=LONG_W, knn_precision=precision))
        params, mstate = params_from_numpy(*runs[0]["state"])
        to = lambda t: t.to(tv.device)  # noqa: E731
        state = TrainState(tree_map(to, params), tree_map(to, mstate))
        for i, batch in enumerate(events):
            packed, _ = tv.inference_packed(state, batch)
            want_p = packed.cpu().numpy()[0]
            got_p = runs[0]["events"][i]["packed"][0]
            v = batch.mask[0]
            tol = CP_SCORE_TOL[precision]
            diff = float(np.abs(got_p[v, :2] - want_p[v, :2]).max())
            flips = int((got_p[v, 2] != want_p[v, 2]).sum())
            log(f"banded cp{tag} vs one device, event {i}: max |score diff| on valid points "
                f"{diff:.3e} (limit {tol}); predictions differ on {flips} of {int(v.sum())} "
                f"valid points")
            if diff > tol or flips:
                raise AssertionError(f"banded cp{tag} event {i} differs from one device")

        # event 0's graphs over the ranks against the one-device model's,
        # block by block, and the one-device model on the ranks' graphs
        x = torch.tensor(events[0].points, device="cuda")
        m = torch.tensor(events[0].mask, device="cuda")
        order, _ = morton_order(x, m)
        xs = torch.gather(x, 1, order[..., None].expand(x.shape)).contiguous()
        ms = torch.gather(m, 1, order)
        mn = ms.cpu().numpy()
        cp_graphs = [tuple(np.concatenate([np.asarray(run["graphs"][b][j]) for run in runs], axis=1)
                           for j in (0, 1)) for b in range(EDGE_BLOCKS)]
        captured, one_graphs = [], []
        build = tv.model.knn_fn

        def recording(xx, k, mm):
            captured.append((xx.clone(), mm.clone()))
            got = build(xx, k, mm)
            one_graphs.append(tuple(t.cpu().numpy() for t in got[:2]))
            return got

        tv.model.pre_sorted = True  # xs is the event in the model's own sorted order
        tv.model.knn_fn = recording
        with torch.inference_mode():
            tv.model(state.params, state.model_state, xs, ms)
        replay = iter([tuple(torch.as_tensor(a, device="cuda") for a in g) for g in cp_graphs])
        tv.model.knn_fn = lambda xx, k, mm: next(replay)
        with torch.inference_mode():
            logits, _ = tv.model(state.params, state.model_state, xs, ms)
        tv.model.knn_fn, tv.model.pre_sorted = build, False
        differ = [int(((cg[0] != og[0]) & mn[..., None]).sum())
                  for cg, og in zip(cp_graphs, one_graphs)]
        log(f"banded cp{tag} event 0, graphs over {CP_P} ranks vs the one-device model's: "
            f"neighbour slots that differ on valid rows, by block: {differ} of "
            f"{int(mn.sum()) * K}")
        replayed = torch.softmax(logits.float(), -1)[0].cpu().numpy()
        got_s = runs[0]["events"][0]["packed"][0][order[0].cpu().numpy()]
        v0 = mn[0]
        rdiff = float(np.abs(replayed[v0] - got_s[v0, :2]).max())
        rflips = int((replayed[v0].argmax(-1) != got_s[v0, 2]).sum())
        log(f"banded cp{tag} event 0 vs the one-device model on the ranks' graphs: max |score "
            f"diff| on valid points {rdiff:.3e} (limit {CP_SCORE_TOL['highest']}); predictions "
            f"differ on {rflips} of {int(v0.sum())} valid points")
        if rdiff > CP_SCORE_TOL["highest"] or rflips:
            raise AssertionError(f"banded cp{tag}: on the ranks' graphs one device still differs")

        # the first graph over the ranks against the one-device kernel's
        wi, wv, _ = bmod.knn_banded_cuda(xs, K, ms, window=LONG_W, return_scores=True,
                                         precision=precision)
        gi, gv = cp_graphs[0]
        wi, wv = wi.cpu().numpy(), wv.cpu().numpy()
        if not np.array_equal(gv[mn], wv[mn]):
            raise AssertionError(f"banded cp{tag}: first graph's valid flags differ")
        gi_v, wi_v = np.where(mn[..., None], gi, 0), np.where(mn[..., None], wi, 0)
        gv_v, wv_v = gv & mn[..., None], wv & mn[..., None]
        if tc:
            qa, ka = kmod.build_augmented_operands(xs, xs, ms, "default")
            hard, near = split_score_mismatches(qa.cpu().numpy(), ka.cpu().numpy(), gi_v, wi_v,
                                                gv_v, wv_v, rtol=TC_RTOL)
        else:
            hard, near = split_mismatches(xs.cpu().numpy(), gi_v, wi_v, gv_v, wv_v)
        log(f"banded cp{tag} first graph over {CP_P} ranks vs the one-device banded kernel's: "
            f"hard={hard} near_ties={near} of {gi_v.size} slots, equal indices on "
            f"{float((gi_v == wi_v).mean()):.6f}")
        if hard:
            raise AssertionError(f"banded cp{tag}: {hard} hard mismatches in the first graph")

        # the cross form on a middle rank's halo operands, timed
        per_launch = halo_cross_times(torch, kmod, bmod, captured[:2], smi, precision, CP_P,
                                      "banded knn")
        out[precision] = (sum(run["main_launches"][1 if tc else 0] for run in runs), per_launch)
        del tv, state
        torch.cuda.empty_cache()
    return out


# --------------------------------------------- context-parallel training


def cp_train_runs() -> dict:
    """Phase 20's runs by rank count (one spawn each) and phase 21's mesh
    run: its name in ``launches_by_path``, label, event size, events,
    `long_config` overrides, warm-up and timed steps, the kernel row it
    launches (its ``kernels`` entry), and the (Hopper TC, sweep_tc, fp32)
    launches of each kernel module a step on every rank."""
    ring = EDGE_BLOCKS * CP_P  # a launch a ring step, CP_P steps a graph build
    bf16 = dict(precision="bfloat16", knn_precision="default", remat=True)

    def want(mod, tc, per):
        out = {"knn": (0, 0, 0), "banded": (0, 0, 0), "ring": (0, 0, 0)}
        out[mod] = (per, 0, 0) if tc else (0, 0, per)
        return out

    return {
        CP_P: [
            dict(path="cp_train_rdma_f32", label="exact ring rdma f32", n=CP_N, kw=dict(ring_impl="rdma"),
                 warmup=CP_TRAIN_WARMUP, steps=CP_TRAIN_STEPS, row="ring_knn_cuda",
                 want=want("ring", False, ring)),
            dict(path="cp_train_rdma_bf16", label="exact ring rdma bf16 remat", n=CP_N, kw=dict(ring_impl="rdma", **bf16),
                 warmup=CP_TRAIN_WARMUP, steps=CP_TRAIN_STEPS, row="ring_knn_cuda_tc",
                 want=want("ring", True, ring)),
            dict(path="cp_train_ppermute_f32", label="exact ring ppermute f32", n=CP_N, kw=dict(ring_impl="ppermute"),
                 warmup=0, steps=1, row="knn_cuda", want=want("knn", False, ring)),
            dict(path="cp_train_ppermute_bf16", label="exact ring ppermute bf16 remat", n=CP_N,
                 kw=dict(ring_impl="ppermute", **bf16), warmup=0, steps=1, row="knn_cuda_tc",
                 want=want("knn", True, ring)),
            dict(path="cp_train_banded_bf16", label="banded bf16 remat", n=LONG_N, kw=dict(knn_window=LONG_W, **bf16),
                 warmup=1, steps=2, row="knn_banded_cuda_tc",
                 want=want("banded", True, EDGE_BLOCKS)),
        ],
        BANDED_TRAIN_P: [
            dict(path="cp_train_banded_f32", label="banded f32 remat", n=BANDED_TRAIN_N,
                 kw=dict(knn_window=LONG_W, remat=True), warmup=CP_TRAIN_WARMUP,
                 steps=CP_TRAIN_STEPS, row="knn_banded_cuda",
                 want=want("banded", False, EDGE_BLOCKS)),
        ],
        "mesh": [
            dict(path="cp_train_mesh_rdma_f32", label=f"exact ring rdma f32, {MESH_DATA} data x {MESH_POINTS} points", n=CP_N,
                 events=MESH_DATA, kw=dict(ring_impl="rdma", minibatch_size=MESH_DATA,
                                           num_devices=MESH_DATA * MESH_POINTS),
                 warmup=0, steps=1, row="ring_knn_cuda",
                 want=want("ring", False, EDGE_BLOCKS * MESH_POINTS)),
        ],
    }


def cp_train_batch(run: dict, seed: int):
    """The run's events (fixed length, ``run["events"]`` of them, one by
    default) as one batch."""
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO

    n, e = run["n"], run.get("events", 1)
    io = SyntheticIO(num_events=e, num_point=n, seed=seed + 60 + n % 997, variable_length=False)
    io.initialize()
    return next(BucketBatcher(io, e, num_point=n, shuffle=False).epoch())


def cp_run_config(run: dict, points: int):
    return long_config(run["n"], point_shards=points, **run["kw"])


def kernel_counts(kmod, bmod, rmod) -> dict:
    """Every kernel module's (Hopper TC, sweep_tc, fp32) launches."""
    return {name: (m.launches_tc, m.launches_tc_sweep, m.launches)
            for name, m in (("knn", kmod), ("banded", bmod), ("ring", rmod))}


def cp_train_rank(group, runs, seed: int, d: str, profile: bool):
    """One rank of phases 20 and 21 (`run_ranks`): for each run a `Trainval`
    on this rank's group from the seeded init; step 1's objective and
    global gradient before any update (`Trainval.loss_and_grads`), its
    graphs saved to ``d``; then the warm-up and timed steps, the counts of
    every kernel and collective set to 0 before them and read after; ms a
    step, peak memory, a digest of the parameters after the steps."""
    import hashlib

    import torch

    from dgcnn_tpu_torch.bridge import tree_leaves
    from dgcnn_tpu_torch.kernels import knn_banded_cuda as bmod
    from dgcnn_tpu_torch.kernels import knn_cuda as kmod
    from dgcnn_tpu_torch.kernels import ring_knn_cuda as rmod
    from dgcnn_tpu_torch.parallel import collectives
    from dgcnn_tpu_torch.train.trainval import Trainval

    world = group.data_rank * group.size + group.rank
    out = {"rank": group.rank, "data_rank": group.data_rank, "device": str(group.device),
           "backend": group.backend, "stage_host": group.stage_host, "runs": []}
    for ri, run in enumerate(runs):
        if world == 0:
            log(f"  cp train rank 0: {run['label']}, B={run.get('events', 1)} N={run['n']}")
        batch = cp_train_batch(run, seed)
        tv = Trainval(cp_run_config(run, group.size), group=group)
        state = tv.initialize(4, generator=torch.Generator().manual_seed(seed))
        build = tv.model.knn_fn
        graphs = []

        def recording(x, k, m, build=build, graphs=graphs):
            graphs.append(build(x, k, m))
            return graphs[-1]

        tv.model.knn_fn = recording
        loss1, grads1, _ = tv.loss_and_grads(state, batch)
        tv.model.knn_fn = build
        if world == 0:
            log(f"  cp train rank 0: {run['label']} step 1's objective {float(loss1):.6f}")
        for j, (gi, gv) in enumerate(graphs):
            np.save(os.path.join(d, f"cp{ri}_w{world}_b{j}_idx.npy"), gi.cpu().numpy())
            np.save(os.path.join(d, f"cp{ri}_w{world}_b{j}_valid.npy"), gv.cpu().numpy())
        res = {"loss1": float(loss1), "builds": len(graphs),
               "grads1": [g.cpu().numpy() for g in grads1] if world == 0 else None}
        if run["kw"].get("knn_window"):
            res["halo_backward"] = halo_backward_check(group, run, seed + world)
        del graphs, grads1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for m in (kmod, bmod, rmod):
            m.launches = m.launches_tc = m.launches_tc_sweep = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        losses = []
        total = run["warmup"] + run["steps"]
        for i in range(total):
            if i == run["warmup"]:
                torch.cuda.synchronize()
                counts0, bytes0 = dict(collectives.counts), dict(collectives.nbytes)
                t0 = time.perf_counter()
                start.record()
            state, metrics = tv.train_step(state, batch)
            losses.append(float(metrics["loss"]))
            if world == 0:
                log(f"  cp train rank 0: {run['label']} step {i + 1} of {total}, loss "
                    f"{losses[-1]:.6f}")
        end.record()
        torch.cuda.synchronize()
        res["host_ms"] = (time.perf_counter() - t0) * 1e3 / run["steps"]
        res["event_ms"] = start.elapsed_time(end) / run["steps"]
        res["losses"] = losses
        res["launches"] = kernel_counts(kmod, bmod, rmod)
        res["steps"] = total
        res["collectives"] = {k: (v - counts0.get(k, 0)) / run["steps"]
                              for k, v in collectives.counts.items() if v - counts0.get(k, 0)}
        res["nbytes"] = {k: (v - bytes0.get(k, 0)) / run["steps"]
                         for k, v in collectives.nbytes.items() if v - bytes0.get(k, 0)}
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
        digest = hashlib.sha256()
        for t in tree_leaves(state.params):
            digest.update(t.detach().cpu().numpy().tobytes())
        res["params_sha256"] = digest.hexdigest()
        if profile and ri == 0:
            # every rank takes the profiled step (its collectives need all)
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as tprofile

            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                state, _ = tv.train_step(state, batch)
                torch.cuda.synchronize()
            table = prof.key_averages()
            res["busy_ms"] = sum(e.self_device_time_total for e in table
                                 if e.device_type != DeviceType.CPU) / 1e3
            res["collective_host_ms"] = sum(e.cpu_time_total for e in table
                                            if e.key.startswith(("gloo:", "nccl:"))) / 1e3
            res["profile"] = table.table(sort_by="cpu_time_total", row_limit=25)
        out["runs"].append(res)
        del tv, state
        torch.cuda.empty_cache()
    return out


def halo_backward_check(group, run: dict, seed: int) -> float:
    """The halo exchange's backward on this rank at the run's block shape
    and compute dtype: the gradient of `halo_extend_values` of a seeded
    ``(B, N_local, EDGE_WIDTH)`` block under a seeded cotangent, against
    the cotangent sent home by the plain exchange (the band's own rows,
    plus the right neighbour's left halo on the last W rows and the left
    neighbour's right halo on the first W: with W <= N_local / 2 each row
    takes at most one, one rounding either way). A dropped or misrouted
    halo cotangent moves a bf16 step's gradient less than bf16 rounding
    does, so the step's comparison cannot see it. Returns the largest
    absolute difference (0 when they are equal bit for bit)."""
    import torch

    from dgcnn_tpu_torch.kernels.halo_knn import halo_extend_values
    from dgcnn_tpu_torch.parallel.collectives import ppermute_ring

    w, nl = run["kw"]["knn_window"], run["n"] // group.size
    dtype = torch.bfloat16 if run["kw"].get("precision") == "bfloat16" else torch.float32
    gen = torch.Generator(device=group.device).manual_seed(seed)
    x = torch.randn((run.get("events", 1) // group.data_size, nl, EDGE_WIDTH), generator=gen,
                    device=group.device).to(dtype).requires_grad_(True)
    with torch.enable_grad():
        ext = halo_extend_values(x, window=w, group=group)
        r = torch.randn(ext.shape, generator=gen, device=group.device).to(dtype)
        (got,) = torch.autograd.grad(ext, x, r)
    want = r[:, w:w + nl].clone()
    want[:, -w:] += ppermute_ring(r[:, :w].contiguous(), group, -1)
    want[:, :w] += ppermute_ring(r[:, -w:].contiguous(), group, 1)
    return float((got.float() - want.float()).abs().max())


def whole_graphs(d: str, ri: int, builds: int, data: int, points: int, device):
    """Run ``ri``'s graphs of every build over the ranks, joined into the
    whole batch's: point ranks along the points, data ranks along the
    events."""
    import torch

    out = []
    for j in range(builds):
        rows = [[np.concatenate([np.load(os.path.join(d, f"cp{ri}_w{dd * points + p}_b{j}_{t}.npy"))
                                 for p in range(points)], axis=1) for t in ("idx", "valid")]
                for dd in range(data)]
        out.append(tuple(torch.as_tensor(np.concatenate([r[t] for r in rows]), device=device)
                         for t in (0, 1)))
    return out


def grouped_grads(template, leaves, device) -> dict:
    """A gradient list in `tree_leaves` order as PIN_GROUPS' groups."""
    import torch

    from dgcnn_tpu_torch.bridge import tree_leaves, tree_unflatten

    tree = tree_unflatten(template, [torch.as_tensor(a, device=device) for a in leaves])
    return {name: tree_leaves(pick(tree)) for name, pick in PIN_GROUPS.items()}


def shard_pool(points: int):
    """The masked global max pool with the context-parallel pool's tie rule
    on one device: the max of each of ``points`` contiguous parts of the
    point axis, then the max of those (`parallel.context_parallel.
    cp_masked_max_pool` takes each rank's max, then the max over the ranks).
    A max's gradient splits evenly over its tied winners, so where bf16
    values tie the two rules send the cotangent to different points; f32
    values do not tie. Untagged, so the model keeps the dense head."""
    import torch

    def pool(x, mask):
        neg = torch.finfo(x.dtype).min
        xs = x if mask is None else torch.where(mask[..., None], x, neg)
        g = xs.unflatten(-2, (points, -1)).amax(dim=-2).amax(dim=-2)
        if mask is None:
            return g
        return torch.where(mask.any(dim=-1, keepdim=True), g, 0.0)

    return pool


def cross_times(torch, kmod, captured, smi: str, precision: str, p: int) -> list:
    """The exact kernel's cross form as the ``ppermute`` ring launches it
    (`kernels.ring_knn.ring_knn`): rank 0's query shard of ``p`` against
    rank 1's block of each captured input (one data rank's events), checked against
    the plain version and timed, with its bound (every query against every
    valid key of the block)."""
    out = []
    tag = " TC" if precision == "default" else ""
    for i, (x, m) in enumerate(captured):
        x = x.float().contiguous()
        b, n, c = x.shape
        nl = n // p
        xq, xk, mk = (t[:, rows].contiguous() for t, rows in
                      ((x, slice(0, nl)), (x, slice(nl, 2 * nl)), (m, slice(nl, 2 * nl))))
        x_np = x.cpu().numpy()
        err = check_knn(torch, kmod, f"cp train cross form block {i} C={c}", xq, xk, mk,
                        x_np[:, :nl], x_np[:, nl:2 * nl], cross=True, precision=precision)
        qa, ka = kmod.build_augmented_operands(xq, xk, mk, precision)
        if precision == "default":
            qa, ka = kmod.tc_operand(qa), kmod.tc_operand(ka)
        t = {
            "wrapper_ms": cuda_ms(torch, lambda: kmod.knn_cuda_cross(xq, xk, K, mk,
                                                                      precision=precision),
                                  reps=3, warmup=1),
            "kernel_ms": cuda_ms(torch, lambda: kmod.launch_operands(qa, ka, K, precision),
                                 reps=3, warmup=1),
            "plain_ms": cuda_once(torch, lambda: kmod.knn_plain(xq, xk, K, mk, precision))[1],
            "library_ms": cuda_ms(torch, lambda: library_knn(torch, kmod, xk, mk, precision,
                                                             xq=xq), reps=3, warmup=1),
            "max_abs_err": err,
            "c": c,
        }
        valid_keys = int(mk.sum())
        ops = nl * valid_keys * (2 * c + 2) + valid_keys * 2 * c + b * nl * c
        bytes_moved = 4 * (xq.numel() + xk.numel()) + mk.numel() + b * nl * K * (4 + 1)
        ops_ms = ops / peak_of(precision) * 1e3
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        t["bound_ms"] = max(ops_ms, bytes_ms)
        t["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
        t["peak"] = peak_of(precision)
        log(f"knn{tag} cross form on the cp train path, rank 0's {nl} queries against rank 1's "
            f"block of {nl} block {i} C={c} k={K} [{smi}]: {fmt_times(t)}")
        out.append(t)
    log_per_shape(f"knn{tag} cross form, cp train", out, smi)
    return out


def ring_train_times(torch, kmod, rmod, captured, smi: str, precision: str, p: int) -> list:
    """The ring kernel on each captured input of the CP train step (one
    data rank's events), over the run's ``p`` point ranks as virtual
    owners (`check_ring` against the exact kernel's graph of the input and
    the plain version, `time_ring`)."""
    out = []
    tag = " TC" if precision == "default" else ""
    for i, (x, m) in enumerate(captured):
        x = x.float().contiguous()
        exact = kmod.knn_cuda(x, K, m, precision=precision)
        err = check_ring(torch, kmod, rmod, f"cp train block {i} C={x.shape[-1]}", x, m, exact,
                         (0,), precision=precision, p=p)
        t = time_ring(torch, kmod, rmod, x, m, precision, p)
        t.update(max_abs_err=err, c=x.shape[2])
        log(f"ring knn{tag} timing, cp train block {i} B={x.shape[0]} N_local="
            f"{x.shape[1] // p} P={p} C={x.shape[2]} k={K} [{smi}]: {fmt_times(t)}")
        out.append(t)
    log_per_shape(f"ring knn{tag}, cp train", out, smi)
    return out


def check_cp_run(torch, kmod, bmod, rmod, run, ri, ranks, data, points, seed, smi, d) -> tuple:
    """Phase 20's (and 21's) checks of one run over its ranks: the kernel
    launches a step on every rank, the same parameters on every rank, a
    finite (and, over several timed steps, falling) loss; on step 1's graph
    over the ranks, pinned, the CP objective and global gradient against
    one device's (`compare_pinned`); the run's kernel checked and timed
    on data rank 0's rows of the one-device forward's first two
    graph-build inputs, over the run's point ranks. Logs ms a step, points/s, peak
    memory a rank, launches and the collectives a step. Returns ``(the
    row's launches over all ranks, per-launch records)``."""
    import dataclasses as dc

    from dgcnn_tpu_torch.bridge import tree_map

    label = f"cp train, {run['label']}"
    rs = [r["runs"][ri] for r in ranks]
    r0 = rs[0]
    want = {k: tuple(v * r0["steps"] for v in c) for k, c in run["want"].items()}
    bad = [(r["rank"], x["launches"]) for r, x in zip(ranks, rs) if x["launches"] != want]
    if bad:
        raise AssertionError(f"{label}: (Hopper TC, sweep_tc, fp32) launches by kernel {bad}, "
                             f"want {want} on every rank")
    if len({x["params_sha256"] for x in rs}) != 1:
        raise AssertionError(f"{label}: the ranks' parameters differ after the steps")
    timed = r0["losses"][run["warmup"]:]
    if not all(np.isfinite(r0["losses"])) or (len(timed) > 1 and not timed[-1] < timed[0]):
        raise AssertionError(f"{label}: losses not finite or not falling: {r0['losses']}")
    n_all = run["n"] * run.get("events", 1)
    shared = "the ranks share one card" if ranks[0]["stage_host"] else "a card a rank"
    log(f"{label} [{smi}]: {data} x {points} ranks ({shared}, backend {ranks[0]['backend']}), "
        f"B={run.get('events', 1)} N={run['n']}; {r0['event_ms']:.3f} ms a step (rank 0's CUDA "
        f"events), {r0['host_ms']:.3f} ms (host clock, synchronized), all ranks "
        f"{[round(x['host_ms'], 3) for x in rs]} ms; {n_all / (r0['host_ms'] / 1e3):.1f} points/s; "
        f"peak device memory a rank {[round(x['peak_bytes'] / 2**30, 3) for x in rs]} GiB; "
        f"losses {[round(v, 6) for v in r0['losses']]} ({run['warmup']} warm-up + {run['steps']} "
        f"timed steps); every rank's parameters identical after them: True")
    log(f"{label} launches over {r0['steps']} steps on every rank: (Hopper TC, sweep_tc, fp32) "
        f"{ {k: v for k, v in want.items()} }")
    if "halo_backward" in r0:
        diffs = [x["halo_backward"] for x in rs]
        log(f"{label}: the halo exchange's backward on every rank (`halo_backward_check`) against "
            f"the plain exchange's cotangents, largest difference {diffs} (want 0)")
        if any(diffs):
            raise AssertionError(f"{label}: the halo exchange's backward differs from the "
                                 f"cotangents sent home: {diffs}")
    fwd = {k: v for k, v in r0["collectives"].items() if not k.endswith("_backward")}
    bwd = {k: v for k, v in r0["collectives"].items() if k.endswith("_backward")}
    fb = {k: v for k, v in r0["nbytes"].items() if not k.endswith("_backward")}
    bb = {k: v for k, v in r0["nbytes"].items() if k.endswith("_backward")}
    log(f"{label} collectives a step on rank 0: forward {fwd} ({sum(fb.values()) / 2**20:.3f} "
        f"MiB put in: {fb}); backward {bwd} ({sum(bb.values()) / 2**20:.3f} MiB: {bb})")
    if "profile" in r0:
        log(r0["profile"])
        log(f"{label} profile [{smi}]: rank 0 device busy {r0['busy_ms']:.3f} ms a step, the "
            f"backend's collective records {r0['collective_host_ms']:.3f} ms on the host, idle "
            f"share 1 - {r0['busy_ms']:.3f} / {r0['host_ms']:.3f} ms = "
            f"{1 - r0['busy_ms'] / r0['host_ms']:.3f}")

    # one device on the ranks' step-1 graph, pinned
    dev = torch.device("cuda")
    cfg1 = dc.replace(cp_run_config(run, 1), num_devices=0)
    batch = cp_train_batch(run, seed)
    graphs = whole_graphs(d, ri, r0["builds"], data, points, dev)
    captured = []
    bf16 = run["kw"].get("precision") == "bfloat16"
    # bf16 features tie at the global max pool: the reference takes the
    # ranks' tie rule (and so the dense head, as the ranks at these sizes)
    pool = shard_pool(points) if bf16 else None
    dense = pinned_loss_grads(torch, cfg1, batch, seed, graphs, capture=captured, pool_fn=pool)
    witness = pinned_loss_grads(torch, cfg1, batch, seed, graphs, shuffle=seed, pool_fn=pool)
    from dgcnn_tpu_torch.train.trainval import Trainval

    template = Trainval(cfg1).model.init(4, torch.Generator().manual_seed(seed))[0]
    template = tree_map(lambda t: t.to(dev), template)
    cp = (r0["loss1"], grouped_grads(template, ranks[0]["runs"][ri]["grads1"], dev))
    failure = None
    try:  # the kernel checks below run either way; the failure is raised after them
        compare_pinned(f"{label}, {data * points} ranks vs one device on step 1's graph", cp,
                       dense, witness, smi, loss_rtol=CP_TRAIN_LOSS_RTOL, bf16=bf16)
    except AssertionError as e:
        failure = e
    del graphs, dense, witness
    torch.cuda.empty_cache()

    precision = run["kw"].get("knn_precision", "highest")
    row = run["row"]
    # the kernel's inputs on a rank: data rank 0's events, over the run's
    # point ranks
    rows = captured[0][0].shape[0] // data
    captured = [(x[:rows], m[:rows]) for x, m in captured[:2]]
    if row.startswith("ring"):
        per_launch = ring_train_times(torch, kmod, rmod, captured, smi, precision, points)
    elif row.startswith("knn_banded"):
        per_launch = halo_cross_times(torch, kmod, bmod, captured, smi, precision, points,
                                      f"{label}: banded knn")
    else:
        per_launch = cross_times(torch, kmod, captured, smi, precision, points)
    mod = next(m for m, prefix in (("ring", "ring"), ("banded", "knn_banded"), ("knn", "knn"))
               if row.startswith(prefix))
    launches = sum(sum(x["launches"][mod]) for x in rs)
    del captured
    torch.cuda.empty_cache()
    if failure is not None:
        raise failure
    return launches, per_launch


def phase_cp_train(torch, kmod, bmod, rmod, seed: int, smi: str, d: str, profile: bool) -> dict:
    """Phase 20: context-parallel training of the flagship (see the module
    docstring). Returns ``{row: [(path, launches, per-launch records)]}``
    for the kernels line."""
    from dgcnn_tpu_torch.parallel.launch import run_point_ranks

    out, failed = {}, []
    for points, runs in cp_train_runs().items():
        if points == "mesh":
            continue
        torch.cuda.empty_cache()  # the ranks share the card with this process
        t0 = time.perf_counter()
        ranks = run_point_ranks(cp_train_rank, points, device="cuda",
                                args=(runs, seed, d, profile), timeout=900)
        log(f"cp train: {points} ranks, backend {ranks[0]['backend']}, devices "
            f"{[r['device'] for r in ranks]}; run_point_ranks took {time.perf_counter() - t0:.1f} "
            f"s for {len(runs)} runs (rank start-up included)")
        for ri, run in enumerate(runs):
            try:  # every run is checked before a failure ends the phase
                launches, per_launch = check_cp_run(torch, kmod, bmod, rmod, run, ri, ranks, 1,
                                                    points, seed, smi, d)
            except AssertionError as e:
                failed.append(str(e))
                continue
            out.setdefault(run["row"], []).append((run["path"], launches, per_launch))
    if failed:
        raise AssertionError("cp train: " + "; ".join(failed))
    return out


def phase_mesh(torch, kmod, bmod, rmod, seed: int, smi: str, d: str, profile: bool) -> dict:
    """Phase 21: the ``data x points`` mesh (MESH_DATA x MESH_POINTS ranks,
    two CP_N-point events, one step against one device on the pinned
    graph), then its command line on phase 15's DGB file (``train -nd 4
    -ps 2`` with a checkpoint, ``inference -ps 2`` with write-back against
    one process's inference of the same checkpoint)."""
    from dgcnn_tpu_torch.config import parse_args
    from dgcnn_tpu_torch.io import BucketBatcher
    from dgcnn_tpu_torch.io.dgb import DGBIO
    from dgcnn_tpu_torch.parallel.launch import run_ranks
    from dgcnn_tpu_torch.train.checkpoint import adopt_model_flags
    from dgcnn_tpu_torch.train.trainval import Trainval

    runs = cp_train_runs()["mesh"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(cp_train_rank, MESH_DATA * MESH_POINTS, MESH_POINTS, device="cuda",
                      args=(runs, seed, d, False), timeout=900)
    log(f"mesh: {MESH_DATA} data x {MESH_POINTS} point ranks, backend {ranks[0]['backend']}, "
        f"devices {[r['device'] for r in ranks]}; run_ranks took {time.perf_counter() - t0:.1f} s")
    out = {}
    for ri, run in enumerate(runs):
        launches, per_launch = check_cp_run(torch, kmod, bmod, rmod, run, ri, ranks, MESH_DATA,
                                            MESH_POINTS, seed, smi, d)
        out.setdefault(run["row"], []).append((run["path"], launches, per_launch))

    # the command line on the mesh
    p = lambda *names: os.path.join(d, "mesh", *names)  # noqa: E731
    data = ["-io", "dgb", "-if", os.path.join(d, "events.dgb"), "-np", str(TRAIN_N), "-mn",
            "residual-dgcnn", "-k", str(K), "--edge_filters", *[str(EDGE_WIDTH)] * EDGE_BLOCKS,
            "--seed", str(seed), "-mb", str(MESH_DATA)]
    t0 = time.perf_counter()
    printed = run_cli(torch, ["train", *data, "-nd", str(MESH_DATA * MESH_POINTS), "-ps",
                              str(MESH_POINTS), "-i", str(CP_CLI_STEPS), "-rs",
                              str(CP_CLI_STEPS // 2), "-cs", str(CP_CLI_STEPS), "-wp",
                              p("w", "snap"), "-ld", p("log")], tee=True)
    train_s = time.perf_counter() - t0
    line = re.search(r"parallel: .*", printed)
    _, rows = read_csv_log(p("log", "train_log.csv"))
    iters = [int(r["iter"]) for r in rows]
    if (iters != [CP_CLI_STEPS // 2, CP_CLI_STEPS] or os.listdir(p("log")) != ["train_log.csv"]
            or not all(np.isfinite(float(r["loss"])) for r in rows)):
        raise AssertionError(f"mesh cli train: log rows {iters}, files {os.listdir(p('log'))}")
    if not os.path.exists(p("w", f"snap-{CP_CLI_STEPS}.ckpt")):
        raise AssertionError(f"mesh cli train: no checkpoint at step {CP_CLI_STEPS}")
    t0 = time.perf_counter()
    run_cli(torch, ["inference", *data, "-nd", str(MESH_POINTS), "-ps", str(MESH_POINTS), "-i",
                    str(CP_CLI_SERVE_BATCHES), "-mp", p("w", "snap"), "-of", p("pred.npz"),
                    "-ld", p("ilog")])
    serve_s = time.perf_counter() - t0
    if os.listdir(p("ilog")) != ["inference_log.csv"]:
        raise AssertionError(f"mesh cli inference: log files {os.listdir(p('ilog'))}")
    pred = np.load(p("pred.npz"))
    ids, off = pred["event_ids"].tolist(), pred["offsets"]
    served = CP_CLI_SERVE_BATCHES * MESH_DATA
    if len(ids) != served or len(set(ids)) != served:
        raise AssertionError(f"mesh pred.npz: events {ids}")
    # one process, the same checkpoint and batches
    icfg = adopt_model_flags(parse_args(["inference", "-mb", str(MESH_DATA), "-mp",
                                         p("w", "snap")]), p("w", "snap"))
    tv = Trainval(icfg)
    state, _ = tv.restore_for_eval(tv.initialize(4), p("w", "snap"))
    reader = DGBIO(os.path.join(d, "events.dgb")).initialize()
    mismatched, worst, seen = 0, 0.0, 0
    for bi, batch in enumerate(BucketBatcher(reader, MESH_DATA, shuffle=False,
                                             seed=icfg.seed).epoch()):
        if bi == CP_CLI_SERVE_BATCHES:
            break
        scores, pr, _ = tv.inference(state, batch)
        for j, eid in enumerate(batch.event_ids):
            k = ids.index(int(eid))
            lo, hi = off[k], off[k + 1]
            mismatched += int((pr[j].cpu().numpy()[: hi - lo] != pred["prediction"][lo:hi]).sum())
            worst = max(worst, float(np.abs(scores[j, : hi - lo].cpu().numpy()
                                            - pred["scores"][lo:hi]).max()))
            seen += hi - lo
    reader.finalize()
    log(f"mesh cli [{smi}]: {line.group(0) if line else 'no ranks line'}; train -nd "
        f"{MESH_DATA * MESH_POINTS} -ps {MESH_POINTS} {CP_CLI_STEPS} steps in {train_s:.1f} s, "
        f"inference -ps {MESH_POINTS} of {served} events in {serve_s:.1f} s (host clock, rank "
        f"start-up included); one log, a checkpoint at {CP_CLI_STEPS}; against one process's "
        f"inference of the checkpoint: {mismatched} of {seen} predictions differ, max |score "
        f"diff| {worst:.3e} (limit {CP_SCORE_TOL['highest']})")
    if mismatched or worst > CP_SCORE_TOL["highest"]:
        raise AssertionError("mesh cli inference disagrees with one process")
    return out


def phase_cp_parallel_train(torch, kmod, bmod, rmod, seed: int, smi: str, d: str,
                            profile: bool) -> dict:
    """Phases 20 and 21, timed; their kernel paths by row."""
    t0 = time.perf_counter()
    try:  # phase 21 runs even when phase 20 failed; the failure is raised after it
        paths, failure = phase_cp_train(torch, kmod, bmod, rmod, seed, smi, d, profile), None
    except AssertionError as e:
        paths, failure = {}, e
    log(f"phase 20 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for row, items in phase_mesh(torch, kmod, bmod, rmod, seed, smi, d, profile).items():
        paths.setdefault(row, []).extend(items)
    log(f"phase 21 took {time.perf_counter() - t0:.1f} s")
    if failure is not None:
        raise failure
    return paths


def cp_train_shapes(per_launch) -> dict:
    """A CP train path's per-launch means by channel count C, in the
    kernels line's names; ``library_ms`` None where there is no library
    call (the halo cross form)."""
    out = {}
    for c in sorted({t["c"] for t in per_launch}):
        ts = [t for t in per_launch if t["c"] == c]
        out[f"C={c}"] = {name: (sum(t[key] for t in ts) / len(ts) if key in ts[0] else None)
                         for key, name in (("wrapper_ms", "ms"), ("kernel_ms", "kernel_only_ms"),
                                           ("bound_ms", "bound_ms"), ("plain_ms", "plain_ms"),
                                           ("library_ms", "library_ms"), ("sweep_ms", "sweep_ms"))
                         if key in ts[0] or key == "library_ms"}
    return out


def add_cp_train_paths(entries, paths) -> None:
    """Phases 20 and 21 into the kernels line: each row's launches on its
    CP train paths (added to ``launches``, split in ``launches_by_path``)
    and its per-shape times there (``cp_train_ms`` by path)."""
    by_name = {e["name"]: e for e in entries}
    for row, items in paths.items():
        e = by_name[row]
        for path, launches, per_launch in items:
            e["launches"] += launches
            e.setdefault("launches_by_path", {})[path] = launches
            e["max_abs_err"] = max([e["max_abs_err"]] + [t["max_abs_err"] for t in per_launch])
            e.setdefault("cp_train_ms", {})[path] = cp_train_shapes(per_launch)


def halo_cross_times(torch, kmod, bmod, captured, smi: str, precision: str, p: int,
                     label: str) -> list:
    """The banded kernel's cross form on rank 1 of ``p``'s halo operands of
    each captured whole-event graph-build input ``(x, mask)`` (sorted
    positions, window LONG_W): checked against its plain version
    (`check_banded`) and timed (the wrapper, the kernel alone), with its
    bound. Returns the per-launch records."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_banded_cp_ranks import rank_operands

    tc = precision == "default"
    tag = " TC" if tc else ""
    per_launch = []
    for i, (xx, mm) in enumerate(captured):
        xx = xx.float().contiguous()
        q, qm, ext, em, nvalid, off = rank_operands(xx, mm, 1, p, LONG_W)
        cut = max(LONG_W - off, 0)
        xk, mk = ext[:, cut:].contiguous(), em[:, cut:].contiguous()
        q = q.contiguous()
        band = dict(q_base=off, key_base=off - LONG_W + cut, nvalid=nvalid)
        nl = q.shape[1]
        x_np = xx.cpu().numpy()
        err, plain_ms = check_banded(torch, bmod, f"{label} halo cross form rank 1 of {p} block "
                                     f"{i} C={xx.shape[-1]}", q, xk, mk, LONG_W, x_np,
                                     q_rows=slice(off, off + nl), band=band, precision=precision)
        qa, ka = kmod.build_augmented_operands(q, xk, mk, precision)
        if tc:
            qa, ka = kmod.tc_operand(qa), kmod.tc_operand(ka)
        t = {
            "wrapper_ms": cuda_ms(torch, lambda: bmod.knn_banded_cuda_cross(
                q, xk, K, mk, window=LONG_W, precision=precision, **band), reps=3, warmup=1),
            "kernel_ms": cuda_ms(torch, lambda: bmod.launch_operands(
                qa, ka, nvalid, K, window=LONG_W, precision=precision, q_base=band["q_base"],
                key_base=band["key_base"]), reps=3, warmup=1),
            "plain_ms": plain_ms,
            "max_abs_err": err,
            "c": xx.shape[2],
        }
        t["bound_ms"], t["bound_by"], pairs = banded_bound(
            torch, xx, mm, LONG_W, peak_of(precision), rows=slice(off, off + nl))
        log(f"{label}{tag} cross form on the halo path, rank 1 of {p} block {i} "
            f"Nq={nl} Nk={xk.shape[1]} C={xx.shape[2]} k={K} W={LONG_W} ({pairs} valid "
            f"in-band pairs) [{smi}]: " + " ".join(
                f"{k}={t[k]:.4f}" for k in ("wrapper_ms", "kernel_ms", "plain_ms", "bound_ms")))
        per_launch.append(t)
    return per_launch


def phase_long(torch, kmod, bmod, seed: int, smi: str, profile: bool) -> dict:
    """Phases 18 and 19: long events on one card, then banded CP serving.
    Returns each new path's launches and per-launch records, by row."""
    t0 = time.perf_counter()
    f32_launches, f32_times = phase_long_train(torch, kmod, seed, smi, profile)
    banded_launches, banded_times_ = phase_long_banded_train(torch, kmod, bmod, seed, smi,
                                                              profile)
    bf16_launches, bf16_times = phase_long_bf16_serving(torch, kmod, bmod, seed, smi)
    log(f"phase 18 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cp = phase_banded_cp(torch, kmod, bmod, seed, smi)
    log(f"phase 19 took {time.perf_counter() - t0:.1f} s")
    return {"knn": (f32_launches, f32_times), "banded": (banded_launches, banded_times_),
            "banded_tc": (bf16_launches, bf16_times), "cp": cp}


def add_long_paths(entries, long) -> None:
    """Phases 18 and 19 into the kernels line: each row's launches on its
    new paths (added to ``launches``, split in ``launches_by_path``) and its
    per-shape times there."""
    by_name = {e["name"]: e for e in entries}

    def grow(name, path, launches, per_launch, key):
        e = by_name[name]
        e["launches"] += launches
        e.setdefault("launches_by_path", {})[path] = launches
        e["max_abs_err"] = max([e["max_abs_err"]] + [t["max_abs_err"] for t in per_launch])
        keys = ("wrapper_ms", "kernel_ms", "plain_ms", "library_ms", "bound_ms")
        e[key] = {}
        for c in sorted({t["c"] for t in per_launch}):
            ts = [t for t in per_launch if t["c"] == c]
            e[key][f"C={c}"] = {
                ("ms" if k == "wrapper_ms" else "kernel_only_ms" if k == "kernel_ms" else k):
                sum(t[k] for t in ts) / len(ts) for k in keys if k in ts[0]}

    grow("knn_cuda", "train_131072_f32", *long["knn"], "train_131072_f32_ms")
    grow("knn_banded_cuda", "train_1048576_f32_remat", *long["banded"], "train_1048576_f32_ms")
    grow("knn_banded_cuda", "banded_cp_f32", *long["cp"]["highest"], "halo_cross_ms")
    grow("knn_banded_cuda_tc", "serve_4194304_bf16", *long["banded_tc"], "serve_4194304_bf16_ms")
    grow("knn_banded_cuda_tc", "banded_cp_tc", *long["cp"]["default"], "halo_cross_ms")


# ------------------------------------------------------------------ export


def artifact_calls(torch, path: str) -> list:
    """The call targets of an exported program's graph, its submodules'
    included."""
    out = []
    for gm in torch.export.load(path).graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            out += [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]
    return out


def host_ms(torch, fn, reps: int) -> float:
    """Host-clock ms a call of ``fn``, synchronised, over ``reps`` calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_export(torch, kmod, bmod, seed: int, smi: str, d: str) -> dict:
    """Phase 22: ``export`` through the command line in this process
    (`cli.main`, `train.export`) from checkpoints of phase 5's and phase
    6's seeded flagship models (`train.checkpoint.save`), each artifact
    loaded with `load_exported` and served; see the module docstring.
    Returns each row's launches from the artifacts' served batches."""
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.train import checkpoint
    from dgcnn_tpu_torch.train.export import load_exported
    from dgcnn_tpu_torch.train.trainval import Trainval

    t_phase = time.perf_counter()
    tc = dict(precision="bfloat16", knn_precision="default")
    cfg = Config(model_name="residual-dgcnn", num_class=2, kvalue=K,
                 edge_filters=(EDGE_WIDTH,) * EDGE_BLOCKS, minibatch_size=B, num_point=N)
    bcfg = dataclasses.replace(cfg, minibatch_size=1, num_point=LONG_N, knn_window=LONG_W)
    saved = {}
    for name, c in (("exact", cfg), ("banded", bcfg)):
        tv = Trainval(c)
        state = tv.initialize(4, generator=torch.Generator().manual_seed(seed))
        saved[name] = (checkpoint.save(os.path.join(d, name, "s"), 1, tv.state_tree(state),
                                       vars(c)), state)
    batches = serving_batches(cfg, seed)
    events = long_events(seed, which=(0, 2))
    one = [(b.points[:1], b.labels[:1], None, b.mask[:1]) for b in (batches[0], batches[-1])]
    common = ["-mn", "residual-dgcnn", "-k", str(K), "--edge_filters",
              *[str(EDGE_WIDTH)] * EDGE_BLOCKS]
    exact_args = ["-np", str(N), *common]
    banded_args = ["-np", str(LONG_N), "-mb", "1", "--knn_window", str(LONG_W), *common]
    tc_args = ["--precision", "bfloat16", "--knn_precision", "default"]
    # artifact: (checkpoint, flags, live config, served batches, the counter
    # a batch must raise by EDGE_BLOCKS, the kernels line's row, the op)
    exact_op, banded_op = "dgcnn_tpu_torch.knn.default", "dgcnn_tpu_torch.knn_banded.default"
    runs = {
        "a": ("exact", [*exact_args, "-mb", str(B)], cfg, batches, (kmod, "launches"),
              "knn_cuda", exact_op),
        "b": ("exact", [*exact_args, "-mb", "0"], cfg, one + batches, (kmod, "launches"),
              "knn_cuda", exact_op),
        "c": ("exact", [*exact_args, "-mb", str(B), *tc_args],
              dataclasses.replace(cfg, **tc), batches, (kmod, "launches_tc"), "knn_cuda_tc",
              exact_op),
        "d": ("banded", banded_args, bcfg, events, (bmod, "launches"), "knn_banded_cuda",
              banded_op),
        "e": ("banded", [*banded_args, *tc_args], dataclasses.replace(bcfg, **tc), events,
              (bmod, "launches_tc"), "knn_banded_cuda_tc", banded_op),
    }
    counters = [(m, n) for m in (kmod, bmod) for n in ("launches", "launches_tc",
                                                        "launches_tc_sweep")]
    launches = {}
    for tag, (ck, flags, live_cfg, served, (mod, counter), row, op) in runs.items():
        path = os.path.join(d, f"{tag}.pt2")
        t0 = time.perf_counter()
        printed = run_cli(torch, ["export", "-mp", saved[ck][0], *flags, "-of", path], tee=True)
        export_s = time.perf_counter() - t0
        calls = artifact_calls(torch, path)
        sorts = len([c for c in calls if "sort" in c])
        if (calls.count(op) != EDGE_BLOCKS or [c for c in calls if "topk" in c]
                or sorts != (1 if ck == "banded" else 0)):
            raise AssertionError(f"artifact ({tag}): {calls.count(op)} {op} nodes, want "
                                 f"{EDGE_BLOCKS}; {sorts} sorts; no plain kNN may be inlined")
        serve = load_exported(path)
        tv = Trainval(live_cfg)
        state = saved[ck][1]
        rise, worst, art_ms, live_ms = 0, 0.0, [], []
        for i, batch in enumerate(served):
            points, labels, weights, mask = (
                batch if isinstance(batch, tuple) else
                (batch.points, batch.labels, batch.weights, batch.mask))
            p = torch.tensor(points, device="cuda")
            m = torch.tensor(mask, device="cuda")
            live, pred, _ = tv.inference(state, (points, labels, weights, mask))
            before = {(mm, n): getattr(mm, n) for mm, n in counters}
            got = serve(p, m)
            torch.cuda.synchronize()
            rose = {(mm, n): getattr(mm, n) - v for (mm, n), v in before.items()}
            want = {key: (EDGE_BLOCKS if key == (mod, counter) else 0) for key in rose}
            if rose != want:
                raise AssertionError(f"artifact ({tag}) batch {i}: kernel launches rose "
                                     f"{[(mm.__name__.split('.')[-1], n, v) for (mm, n), v in rose.items()]}, "
                                     f"want {EDGE_BLOCKS} of {counter}")
            rise += rose[(mod, counter)]
            diff = float((got - live).abs().max())
            same = bool(torch.equal(got.argmax(-1)[m], pred.long()[m]))
            worst = max(worst, diff)
            log(f"export ({tag}) batch {i} {tuple(p.shape)}: max|score - live|={diff:.3e}, "
                f"argmax identical on valid points: {same}, {counter} +{rose[(mod, counter)]}")
            if not (diff <= 1e-6 and same and bool(torch.isfinite(got).all())):
                raise AssertionError(f"artifact ({tag}) batch {i} disagrees with live inference")
            reps = 3 if ck == "exact" else 1
            art_ms.append(host_ms(torch, lambda: serve(p, m).cpu(), reps))
            live_ms.append(host_ms(torch, lambda: tv.inference(state, (points, labels, weights,
                                                                         mask))[0].cpu(), reps))
        launches[row] = launches.get(row, 0) + rise
        log(f"export ({tag}) [{smi}]: {printed.strip().splitlines()[-1]}; export "
            f"{export_s:.1f} s, artifact {os.path.getsize(path) / 1e6:.2f} MB, {calls.count(op)} "
            f"{op} nodes; served {len(served)} batches, max|score - live|={worst:.3e}, ms a "
            f"batch (host clock incl. copy to host) artifact "
            f"{sum(art_ms) / len(art_ms):.3f} live {sum(live_ms) / len(live_ms):.3f}; "
            f"{row} launches {rise}")
        del serve, tv
        os.remove(path)
    log(f"phase 22 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def f32_counts(kmod) -> tuple:
    """The fp32 exact kernel's launch counts: (Hopper fp32, sweep)."""
    return kmod.launches_f32_hopper, kmod.launches - kmod.launches_f32_hopper


def f32_forms(torch, kmod, qa, ka, k: int = K, splits=None) -> tuple:
    """The Hopper fp32 kernel's and the fp32 sweep's outputs (idx, valid,
    scores) on the same operands, each forced, at the key split
    ``splits`` (None: each form's own), and whether they are equal
    (``==``)."""
    kmod._splits_override = splits
    try:
        got = kmod.launch_operands(qa, ka, k, kernel="hopper")
        ref = kmod.launch_operands(qa, ka, k, kernel="sweep")
    finally:
        kmod._splits_override = None
    return got, ref, all(bool(torch.equal(a, r)) for a, r in zip(got, ref))


def f32_on_inputs(torch, kmod, label, captured, smi: str, reps: int, splits=(None,)) -> list:
    """The Hopper fp32 kernel against the fp32 sweep (`f32_forms`, at each
    S of ``splits``) and the wrapper's own launch against both, on each
    captured graph-build input ``(x, mask)``; times of the wrapper and of
    both forms alone in turns (`f32_turns`), with the bound. Returns the
    per-launch records."""
    out = []
    for i, (x, m) in enumerate(captured):
        qa, ka = operands(kmod, x, m, "highest")
        same = []
        for s in splits:
            got, _, eq = f32_forms(torch, kmod, qa, ka, splits=s)
            same.append(eq)
        live = kmod.knn_cuda(x, K, m, return_scores=True)
        same.append(all(bool(torch.equal(a, g)) for a, g in zip(live, got)))
        t = {"wrapper_ms": cuda_ms(torch, lambda: kmod.knn_cuda(x, K, m), reps=reps, warmup=1)}
        t.update(f32_turns(torch, kmod, qa, ka, reps=reps, warmup=1))
        t.update(knn_bound(x, m, "highest"), c=x.shape[2])
        sp = kmod.choose_splits(x.shape[0], x.shape[1], x.shape[1], qa.shape[-1], K, x.device,
                                kernel="f32_hopper")
        log(f"f32 Hopper {label} block {i} B={x.shape[0]} N={x.shape[1]} C={x.shape[2]} k={K} "
            f"valid={m.sum(-1).tolist()} (card's S={sp}) [{smi}]: == the fp32 sweep's idx, valid "
            f"and scores at S={['card' if s is None else s for s in splits]}: {same[:-1]}, the "
            f"wrapper's launch == both: {same[-1]}; wrapper_ms={t['wrapper_ms']:.4f} "
            f"hopper_only_ms={t['kernel_ms']:.4f} sweep_fp32_only_ms={t['sweep_ms']:.4f} "
            f"bound_ms={t['bound_ms']:.4f} roofline_share(alone)={t['bound_ms'] / t['kernel_ms']:.3f}")
        if not all(same):
            raise AssertionError(f"f32 Hopper {label} block {i}: not equal to the fp32 sweep")
        out.append(t)
    keys = ("wrapper_ms", "kernel_ms", "sweep_ms", "bound_ms")
    for c in sorted({t["c"] for t in out}):
        ts = [t for t in out if t["c"] == c]
        log(f"f32 Hopper {label} per launch, C={c} ({len(ts)}) [{smi}]: " + " ".join(
            f"{key}={sum(t[key] for t in ts) / len(ts):.4f}" for key in keys))
    return out


def phase_f32_hopper(torch, kmod, seed: int, smi: str) -> dict:
    """Phase 23: the exact kNN's Hopper fp32 kernel (``csrc/knn_hopper.cuh``)
    against the fp32 sweep, bit for bit. The f32 train step of the
    flagship on one LONG_TRAIN_N-point event (1 warm-up + 2 steps): every
    fp32 graph build on the Hopper kernel and none on the sweep (6 a
    step); the kernel == the sweep on step 1's six graph-build inputs (C=4
    and C=64) and both timed there in turns. A served B x N batch with
    padded masks (phase 5's variable-length batch): the six graph-build
    inputs of its forward, at S forced to 1 and 2. Then phase 3 (the ragged
    inputs with events of 13 and 0 valid points, the all-equal input, the
    cross form with Nq != Nk), where `check_knn` holds each launch the
    Hopper kernel takes to the sweep too. Returns the per-launch records
    ``{"train": [...], "serve": [...]}``."""
    from dgcnn_tpu_torch.config import Config

    batch = one_event(LONG_TRAIN_N, seed)
    cfg = long_config(LONG_TRAIN_N)
    r = run_steps(torch, kmod, cfg, batch, seed, 1, 2, record=True)
    counts = f32_counts(kmod)
    log(f"f32 Hopper train 1 x {LONG_TRAIN_N}: (Hopper fp32, fp32 sweep) launches over 3 steps "
        f"{counts}, (Hopper TC, sweep TC, fp32) a step {r['per_step']}; ms a step "
        f"{r['event_ms']:.2f} (events), {LONG_TRAIN_N / r['event_ms'] * 1e3:.0f} points/s, peak "
        f"{r['peak_gib']:.3f} GiB, losses {[round(v, 5) for v in r['losses']]} [{smi}]")
    if counts != (3 * EDGE_BLOCKS, 0):
        raise AssertionError(f"f32 Hopper train: launches {counts}, want ({3 * EDGE_BLOCKS}, 0)")
    train = f32_on_inputs(torch, kmod, f"train 1 x {LONG_TRAIN_N}", r["captured"], smi, reps=3)

    from dgcnn_tpu_torch.train.trainval import Trainval

    scfg = Config(model_name="residual-dgcnn", num_class=2, kvalue=K,
                  edge_filters=(EDGE_WIDTH,) * EDGE_BLOCKS, minibatch_size=B, num_point=N)
    tv = Trainval(scfg)
    state = tv.initialize(4, generator=torch.Generator().manual_seed(seed))
    sbatch = serving_batches(scfg, seed)[-1]
    captured, knn_fn = [], tv.model.knn_fn

    def recording(x, k, m):
        captured.append((x.clone(), m.clone()))
        return knn_fn(x, k, m)

    tv.model.knn_fn = recording
    kmod.launches = kmod.launches_f32_hopper = 0
    with torch.inference_mode():
        tv.model(state.params, state.model_state, torch.tensor(sbatch.points, device="cuda"),
                 torch.tensor(sbatch.mask, device="cuda"))
    if f32_counts(kmod) != (EDGE_BLOCKS, 0):
        raise AssertionError(f"f32 Hopper serve: launches {f32_counts(kmod)}")
    serve = f32_on_inputs(torch, kmod, f"served {B} x {N}", captured, smi, reps=20,
                          splits=(1, 2))
    phase_kernel_vs_plain(torch, kmod, seed, smi)
    return {"train": train, "serve": serve}


EMLP_B, EMLP_N, EMLP_K, EMLP_C = 32, 4096, 20, 64  # the segmentation cell's blocks 1-2
EMLP_STEPS = 5


def emlp_inputs(torch, kmod, seed: int, cin: int, counts):
    """Inputs of the four passes of a depth-2 block at the segmentation
    cell's shape: ``p``, ``q`` through a random first conv from ``cin``
    channels, the exact kernel's graph over the valid points, the query
    weights the train step passes (its mask as float32: ``counts`` valid
    points an event), BN1's constants, a stacked conv, mixed-sign BN2
    scales, a cotangent of the block's winners and of BN2's and BN1's
    sums."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = EMLP_C
    x = torch.randn(EMLP_B, EMLP_N, cin, generator=g, device="cuda")
    w = torch.randn(2 * cin, c, generator=g, device="cuda") / np.sqrt(2 * cin)
    p, q = (x @ (w[:cin] - w[cin:])).contiguous(), (x @ w[cin:]).contiguous()
    mask = torch.arange(EMLP_N, device="cuda")[None] < torch.tensor(counts, device="cuda")[:, None]
    idx, _ = kmod.knn_cuda(x, EMLP_K, mask)
    wts = mask.float()
    bn = [0.1 * torch.randn(c, generator=g, device="cuda"),
          torch.rand(c, generator=g, device="cuda") + 0.5,
          torch.rand(c, generator=g, device="cuda") + 0.5,
          0.2 * torch.randn(c, generator=g, device="cuda")]
    w2 = torch.randn(c, c, generator=g, device="cuda") / np.sqrt(c)
    gsign = torch.arange(c, device="cuda") % 4 != 0
    dm = torch.randn(EMLP_B, EMLP_N, c, generator=g, device="cuda")
    ds = torch.randn(4, c, generator=g, device="cuda") * 1e-3
    return p, q, idx, wts, bn, w2, gsign, dm, ds


def emlp_bounds() -> dict:
    """The least ms of each pass at the cell's shape: a product is 2 E C^2
    operations at the fp32 FMA peak (the forward one, the backward three);
    the stats passes do no product and are bound by their bytes (P, the
    indices, the outputs, Q once) at HBM bandwidth."""
    e = EMLP_B * EMLP_N * EMLP_K
    rows_bytes = EMLP_B * EMLP_N * EMLP_C * 4
    product_ms = 2 * e * EMLP_C ** 2 / FP32_PEAK_FLOPS * 1e3
    stats_ms = (2 * rows_bytes + e * 4) / HBM_BYTES_PER_S * 1e3
    return {"stats": stats_ms, "forward": product_ms, "backward": 3 * product_ms,
            "stats_backward": (4 * rows_bytes + e * 4) / HBM_BYTES_PER_S * 1e3}


def emlp_backward_f64(torch, edge_ops, f32, f64):
    """The plain backward on the float64 arguments ``f64``, under BN1's
    relu masks as float32 rounds them on ``f32`` (``p, q, idx`` and BN1's
    four constants), which are the kernel's bits: each mask decides a
    whole term of dp, dq and BN1's sums, and float64 alone would flip the
    odd mask of a near-zero entry."""
    h1_32 = edge_ops._mlp_y1_h1(*f32)[1]
    y1_h1 = edge_ops._mlp_y1_h1

    def float32_masks(*args):
        y1, h1 = y1_h1(*args)
        return y1, torch.where((h1 > 0) == (h1_32 > 0), h1, h1_32.double())

    edge_ops._mlp_y1_h1 = float32_masks
    try:
        return edge_ops._PLAIN.backward(*f64)
    finally:
        edge_ops._mlp_y1_h1 = y1_h1


def emlp_step(torch, impl: str, seed: int, steps: int) -> dict:
    """Train steps of the segmentation network (`dgcnn`, blocks of MLP
    depth 2, 2 and 1, width 64, k=20, head 1024 -> 512 -> 256, Adam 1e-3)
    at EMLP_B x EMLP_N under ``block_impl=impl``: one warm-up step, then
    ``steps`` timed (host clock to a synchronize); ms a step, peak GiB, the
    losses, the forms a step and the fused block's launches in the timed
    steps (its counter set to 0 before them)."""
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.kernels import edge_mlp_cuda as emod
    from dgcnn_tpu_torch.models import dgcnn as tdgcnn
    from dgcnn_tpu_torch.train.trainval import Trainval

    cfg = Config(model_name="dgcnn", num_class=2, kvalue=EMLP_K, edge_filters=(EMLP_C,) * 3,
                 block_convs=(2, 2, 1), head_feat_dim=1024,
                 head_mlp=(512, 256), minibatch_size=EMLP_B, num_point=EMLP_N,
                 optimizer="adam", learning_rate=1e-3, block_impl=impl)
    tv = Trainval(cfg)
    state = tv.initialize(4, generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    batch = (rng.randn(EMLP_B, EMLP_N, 4).astype(np.float32),
             rng.randint(0, 2, (EMLP_B, EMLP_N)).astype(np.int32), None,
             np.ones((EMLP_B, EMLP_N), bool))
    state, m = tv.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    forms = dict(tdgcnn.block_forms)
    emod.launches = 0
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = tv.train_step(state, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    ran = {f: (v - forms[f]) // steps for f, v in tdgcnn.block_forms.items() if v != forms[f]}
    return {"ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "losses": losses,
            "forms": ran, "launches": emod.launches}


def phase_edge_mlp(torch, seed: int, smi: str) -> dict:
    """Phase 24 (see the module docstring). Returns the kernels-line entry."""
    from dgcnn_tpu_torch.kernels import edge_mlp_cuda as emod
    from dgcnn_tpu_torch.kernels import knn_cuda as kmod
    from dgcnn_tpu_torch.ops import edge as edge_ops

    bounds = emlp_bounds()
    plain = edge_ops._PLAIN
    full = [EMLP_N] * EMLP_B
    ragged = [EMLP_N - 131 * i for i in range(EMLP_B - 1)] + [0]
    shapes, worst = {}, 0.0
    for label, cin, counts in (("c_in=4", 4, full), (f"c_in={EMLP_C}", EMLP_C, full),
                               (f"c_in={EMLP_C},ragged", EMLP_C, ragged)):
        p, q, idx, w, bn, w2, gsign, dm, ds = emlp_inputs(torch, kmod, seed + cin, cin, counts)
        m, win, _, _ = emod.forward(p, q, idx, w, *bn, w2, gsign)
        runs = {
            "stats": lambda mod: mod.stats(p, q, idx, w),
            "forward": lambda mod: mod.forward(p, q, idx, w, *bn, w2, gsign),
            "backward": lambda mod: mod.backward(p, q, idx, w, *bn, w2, win, dm, ds[0], ds[1]),
            "stats_backward": lambda mod: mod.stats_backward(p, q, idx, w, ds[2], ds[3]),
        }
        d = {"p": p.double(), "q": q.double(), "w": w.double(), "bn": [t.double() for t in bn],
             "w2": w2.double(), "dm": dm.double(), "ds": ds.double()}
        want = {
            "stats": plain.stats(d["p"], d["q"], idx, d["w"]),
            "forward": plain.forward(d["p"], d["q"], idx, d["w"], *d["bn"], d["w2"], gsign),
            "backward": emlp_backward_f64(torch, edge_ops, (p, q, idx, *bn),
                                          (d["p"], d["q"], idx, d["w"], *d["bn"], d["w2"], win,
                                           d["dm"], d["ds"][0], d["ds"][1])),
            "stats_backward": plain.stats_backward(d["p"], d["q"], idx, d["w"], d["ds"][2],
                                                   d["ds"][3]),
        }
        del d
        entry = {}
        for name, run in runs.items():
            got = run(emod)
            for i, (a, r) in enumerate(zip(got, want[name])):
                if a.dtype == torch.uint8:
                    flips = float((a != r).float().mean())
                    if flips > 1e-4:
                        raise AssertionError(f"edge_mlp {label} {name}: winners differ at "
                                             f"{flips:.2e}")
                    continue
                err = float((a.double() - r).abs().max()) / float(r.abs().max())
                worst = max(worst, err)
                if err > 1e-4:
                    raise AssertionError(f"edge_mlp {label} {name} output {i}: error {err:.2e} "
                                         f"of the largest entry")
            entry[name] = {"kernel_ms": cuda_ms(torch, lambda: run(emod), reps=10, warmup=2),
                           "plain_ms": cuda_ms(torch, lambda: run(plain), reps=2, warmup=1),
                           "bound_ms": bounds[name]}
        del want
        shapes[label] = entry
        log(f"edge_mlp at {EMLP_B} x {EMLP_N}, k={EMLP_K}, {label}, C={EMLP_C}, "
            f"{sum(counts)} valid rows: "
            + "; ".join(f"{n} {t['kernel_ms']:.3f} ms (plain {t['plain_ms']:.2f}, bound "
                        f"{t['bound_ms']:.3f}, {100 * t['bound_ms'] / t['kernel_ms']:.1f}%)"
                        for n, t in entry.items()) + f" [{smi}]")
    steps = {}
    for impl in ("edge", "auto", "auto", "edge"):
        r = emlp_step(torch, impl, seed, EMLP_STEPS)
        steps.setdefault(impl, []).append(r)
        log(f"segmentation step {EMLP_B} x {EMLP_N} block_impl={impl}: {r['ms']:.2f} ms "
            f"({EMLP_B * EMLP_N / r['ms'] * 1e3:.0f} points/s), peak {r['peak_gib']:.3f} GiB, "
            f"forms a step {r['forms']}, edge_mlp launches in {EMLP_STEPS} steps "
            f"{r['launches']}, losses {[round(v, 5) for v in r['losses']]} [{smi}]")
    for r in steps["auto"]:
        if r["forms"] != {"fused_mlp": 2, "fused": 1} or r["launches"] != 8 * EMLP_STEPS:
            raise AssertionError(f"segmentation step under auto: forms {r['forms']}, "
                                 f"launches {r['launches']}")
    # launches: the main path's own, the timed steps of both runs under auto
    return {"name": "edge_mlp_cuda", "source": "dgcnn_tpu_torch/csrc/edge_mlp.cu",
            "replaces": None, "launches": sum(r["launches"] for r in steps["auto"]),
            "max_rel_err": worst,
            "shape": f"B={EMLP_B} N={EMLP_N} k={EMLP_K} C={EMLP_C}", "per_shape_ms": shapes,
            "step_ms": {impl: [r["ms"] for r in rs] for impl, rs in steps.items()},
            "step_peak_gib": {impl: rs[0]["peak_gib"] for impl, rs in steps.items()}}


def add_export_paths(entries, launches) -> None:
    """Phase 22 into the kernels line: each row's launches from the served
    artifacts (added to ``launches``, ``launches_by_path["export"]``)."""
    by_name = {e["name"]: e for e in entries}
    for row, n in launches.items():
        by_name[row]["launches"] += n
        by_name[row].setdefault("launches_by_path", {})["export"] = n


def time_keys(per_launch) -> list:
    """`TIME_KEYS`, and sweep_tc's time and the compare floor where the
    records hold them (the TC kernel's)."""
    return list(TIME_KEYS) + [key for key in ("sweep_ms", "compare_ms") if key in per_launch[0]]


def per_shape(per_launch) -> dict:
    """Per-launch means of the times by channel count C."""
    out = {}
    for c in sorted({t["c"] for t in per_launch}):
        ts = [t for t in per_launch if t["c"] == c]
        out[f"C={c}"] = {key: sum(t[key] for t in ts) / len(ts) for key in time_keys(per_launch)}
    return out


def log_per_shape(label, per_launch, smi: str) -> None:
    mean = {key: sum(t[key] for t in per_launch) / len(per_launch)
            for key in time_keys(per_launch)}
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
    ap.add_argument("--prec-only", action="store_true",
                    help="phases 1, 2 and 17 only (mixed precision, its own DGB file), the TC "
                    "kernels' entries logged, no kernels line")
    ap.add_argument("--long-only", action="store_true",
                    help="phases 1, 2, 18 and 19 only (long events on one card, banded CP "
                    "serving), no kernels line")
    ap.add_argument("--cp-train-only", action="store_true",
                    help="phases 1, 2, 20 and 21 only (context-parallel training, the data x "
                    "points mesh and its command line; its own DGB file), no kernels line")
    ap.add_argument("--export-only", action="store_true",
                    help="phases 1, 2 and 22 only (export through the command line, the "
                    "artifacts served against live inference), no kernels line")
    ap.add_argument("--f32-only", action="store_true",
                    help="phases 1, 2 and 23 only (the Hopper fp32 kNN kernel against the fp32 "
                    "sweep, bit for bit, at the train and serve cells' shapes), no kernels line")
    ap.add_argument("--edge-mlp-only", action="store_true",
                    help="phases 1, 2 and 24 only (the fused depth-2 EdgeConv block's kernels "
                    "against their plain versions, timed, and the segmentation step in both "
                    "forms), no kernels line")
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
    names = ("knn", "knn_banded", "ring_knn", "edge_mlp")
    _build.load_many(names)
    log(f"build: {', '.join(f'csrc/{n}.cu' for n in names)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)}, in parallel; csrc/knn_sweep.cuh, "
        f"csrc/warp_topk.cuh, csrc/knn_tc.cuh and csrc/sm90.cuh built into the three kNN "
        f"sources, csrc/knn_hopper.cuh into csrc/knn.cu)")
    for name in names:
        for line in _build.build_logs.get(name, "(library reused)").splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error", "reused")):
                log(f"  {name}: {line.strip()}")
            if "spill" in line and any(int(v) for v in re.findall(r"(\d+) bytes", line)):
                raise AssertionError(f"csrc/{name}.cu: ptxas reports a stack frame or a spill")
    log("kernels: knn_cuda (csrc/knn.cu; self form knn_cuda, cross form knn_cuda_cross), "
        "knn_banded_cuda (csrc/knn_banded.cu; self form knn_banded_cuda, cross form "
        "knn_banded_cuda_cross), ring_knn_cuda (csrc/ring_knn.cu; one launch a ring step); each "
        "TC form the Hopper kernel on csrc/knn_tc.cuh, or sweep_tc, by knn_cuda.tc_kernel_for; "
        "the exact fp32 pass the Hopper kernel on csrc/knn_hopper.cuh "
        "(knn_topk_kernel_hopper), or the sweep, by knn_cuda.f32_kernel_for")

    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    only = (args.cp_only, args.dp_only, args.prec_only, args.long_only, args.cp_train_only,
            args.export_only, args.f32_only, args.edge_mlp_only)
    if any(only):
        if args.edge_mlp_only:
            phase_edge_mlp(torch, args.seed, smi)
        if args.f32_only:
            phase_f32_hopper(torch, kmod, args.seed, smi)
        if args.export_only:
            with tempfile.TemporaryDirectory(prefix="smoke-export-", dir=os.path.join(root, "build")) as d:
                for row, n in phase_export(torch, kmod, bmod, args.seed, smi, d).items():
                    log(f"kernel path: {row} export launches={n}")
        if args.long_only:
            phase_long(torch, kmod, bmod, args.seed, smi, args.profile)
        if args.cp_train_only:
            with tempfile.TemporaryDirectory(prefix="smoke-cpt-", dir=os.path.join(root, "build")) as d:
                dp_cli_data(d, args.seed)
                for row, items in phase_cp_parallel_train(torch, kmod, bmod, rmod, args.seed, smi,
                                                          d, args.profile).items():
                    for path, launches, per_launch in items:
                        log(f"kernel path: {row} {path} launches={launches} "
                            f"{json.dumps(cp_train_shapes(per_launch))}")
        if args.prec_only:
            with tempfile.TemporaryDirectory(prefix="smoke-prec-", dir=os.path.join(root, "build")) as d:
                dp_cli_data(d, args.seed)
                for entry in phase_prec(torch, kmod, bmod, rmod, args.seed, smi, d, args.profile):
                    log(f"kernel entry: {json.dumps(entry)}")
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
        # phase 17: mixed precision
        tc_entries = phase_prec(torch, kmod, bmod, rmod, args.seed, smi, d, args.profile)
        # phases 18 and 19: long events on one card, banded CP serving
        long_paths = phase_long(torch, kmod, bmod, args.seed, smi, args.profile)
        # phases 20 and 21: context-parallel training, the data x points
        # mesh and its command line on phase 15's DGB file
        cp_train_paths = phase_cp_parallel_train(torch, kmod, bmod, rmod, args.seed, smi, d,
                                                 args.profile)
    # phase 22: export through the command line, the artifacts served
    with tempfile.TemporaryDirectory(prefix="smoke-export-", dir=os.path.join(root, "build")) as d:
        export_launches = phase_export(torch, kmod, bmod, args.seed, smi, d)
    # phase 23: the Hopper fp32 kernel against the fp32 sweep
    phase_f32_hopper(torch, kmod, args.seed, smi)
    # phase 24: the fused depth-2 EdgeConv block's kernels and the
    # segmentation step
    edge_mlp_entry = phase_edge_mlp(torch, args.seed, smi)

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
    entries += tc_entries
    entries.append(edge_mlp_entry)
    add_long_paths(entries, long_paths)
    add_cp_train_paths(entries, cp_train_paths)
    add_export_paths(entries, export_launches)

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
