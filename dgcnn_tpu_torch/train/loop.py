"""Driver loops (port of `dgcnn_tpu/train/loop.py`): the iteration loop
over the prefetched batches with report and checkpoint cadence, held-out
validation, early stop, a signal-safe stop, CSV/stdout logging, and the
inference loop with per-event write-back.

Both loops run on ``cuda`` unless the caller passes ``device="cpu"``.
Data parallelism: in a process that a launcher started (``torchrun``, or
one process per host; `utils.distributed`) the loop joins the
launcher's group; otherwise ``num_devices / point_shards > 1`` data ranks
(``-nd N``; 0 is every visible card) are spawned here
(`parallel.launch.run_ranks`) and the call returns rank 0's result. Every
rank of one host forms the same global batch sequence and computes on
its rows of each batch, so on one host the run is the JAX package's
one-process run on N devices. Across hosts each host reads its
`utils.distributed.host_event_range` slice through `SubsetIO` and
assembles its share of each global batch (``minibatch_size`` divisible
by the host count, ``--num_point`` required), as the JAX package's
processes do. All ranks agree on the resume step and, every iteration,
on one stop flag (a signal or the early stop), so no rank waits alone in
a collective; rank 0 alone reports, writes the logs and checkpoints,
and writes inference output. ``point_shards > 1`` through the loop
(context-parallel training, ROADMAP queue 1, item 13) raises
`NotImplementedError`; CP serving stays reachable through
`parallel.launch.run_point_ranks`.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time

import numpy as np
import torch

from dgcnn_tpu_torch.io import BucketBatcher, SegmentWriter, io_factory, prefetch
from dgcnn_tpu_torch.models.dgcnn import not_ported
from dgcnn_tpu_torch.ops.loss import mean_iou, per_class_accuracy
from dgcnn_tpu_torch.parallel.collectives import all_gather_data, psum_data
from dgcnn_tpu_torch.parallel.launch import join_from_env, leave, run_ranks
from dgcnn_tpu_torch.parallel.mesh import DATA_AXIS, choose_backend, make_mesh
from dgcnn_tpu_torch.train import checkpoint
from dgcnn_tpu_torch.train.logging import Reporter, maybe_start_profiler, maybe_stop_profiler
from dgcnn_tpu_torch.train.trainval import Trainval, resolve_device

# Flush the on-device f32 confusion accumulator to host f64 once this
# many points have been accumulated: a single cell gains at most one
# count per point, and 2^23 leaves 2x headroom under f32's 2^24 integer
# exactness bound. Module-level so tests can force frequent flushes.
_CM_FLUSH_POINTS = 1 << 23


def _launched(body, cfg, device):
    """``body(cfg, device, group)`` in this process alone, as a rank of the
    launcher's group, or on the spawned data ranks (rank 0's result)."""
    if cfg.point_shards > 1:
        raise not_ported("point_shards > 1 through the driver loops (context-parallel "
                         "training; CP serving runs through parallel.launch)", "13")
    device = resolve_device(device)
    group = join_from_env(cfg.point_shards, device)
    if group is not None:
        try:
            if group.data_rank == 0:
                _print_ranks(group.data_size, group.backend, group.stage_host, group.hosts)
            return body(cfg, group.device, group)
        finally:
            leave()
    n = make_mesh(cfg.num_devices, cfg.point_shards, device)[DATA_AXIS]
    if n == 1:
        return body(cfg, device, None)
    _print_ranks(n, *choose_backend(n, device))
    return run_ranks(_rank_body, n, device=str(device), args=(body, cfg), timeout=None)[0]


def _rank_body(group, body, cfg):
    return body(cfg, group.device, group)


def _print_ranks(n: int, backend: str, staged: bool, hosts: int = 1) -> None:
    print(f"data parallel: {n} ranks on {hosts} host(s), backend {backend}"
          + (" (ranks share a card: staged through pinned host memory)" if staged else ""),
          flush=True)


def _lead(group) -> bool:
    """Rank 0 of the group (or the one process) reports and writes."""
    return group is None or group.data_rank == 0


def _hosts(group) -> tuple[int, int]:
    return (0, 1) if group is None else (group.host, group.hosts)


def _local_batch_rows(batch, host: int, hosts: int):
    """This host's contiguous row slice of a global batch (every host
    forms the same global batch; each computes on its share)."""
    lb = batch.points.shape[0] // hosts
    lo, hi = host * lb, (host + 1) * lb
    return dataclasses.replace(
        batch,
        points=batch.points[lo:hi],
        labels=batch.labels[lo:hi],
        weights=None if batch.weights is None else batch.weights[lo:hi],
        mask=batch.mask[lo:hi],
        event_ids=batch.event_ids[lo:hi],
        lengths=batch.lengths[lo:hi],
    )


def _flatten_metrics(metrics: dict) -> dict:
    """Expand vector metrics (per-class accuracy) into scalar columns, in
    sorted key order (the order of the JAX step's metric dict)."""
    out = {}
    for k, v in sorted(metrics.items()):
        arr = np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
        if arr.ndim == 0:
            out[k] = float(arr)
        else:
            for i, x in enumerate(arr.ravel()):
                out[f"{k}{i}"] = float(x)
    return out


def _build_io(cfg, shuffle: bool, group=None, subset: bool = True):
    """Reader, batcher, the events' feature width and the (global) event
    count. With several hosts and ``subset`` (training) the reader is the
    host's `host_event_range` slice and the batches are the host's share
    of each global batch; without ``subset`` (inference) every host reads
    the whole file and forms the global batches."""
    io = io_factory(cfg).initialize()
    total_events = io.num_events()
    batch_size = cfg.minibatch_size
    host, hosts = _hosts(group)
    if hosts > 1 and subset:
        from dgcnn_tpu_torch.io.readers import SubsetIO
        from dgcnn_tpu_torch.utils.distributed import host_event_range

        if cfg.minibatch_size % hosts:
            raise ValueError(
                f"minibatch_size={cfg.minibatch_size} not divisible by "
                f"process_count={hosts}"
            )
        if cfg.num_point <= 0:
            raise ValueError(
                "multi-host training requires --num_point (all hosts must "
                "assemble identically-shaped batches; dynamic bucketing "
                "would desynchronize shapes across processes)"
            )
        io = SubsetIO(io, *host_event_range(total_events, host, hosts)).initialize()
        batch_size = cfg.minibatch_size // hosts
    batcher = BucketBatcher(
        io,
        batch_size=batch_size,
        buckets=cfg.buckets,
        num_point=cfg.num_point,
        shuffle=shuffle,
        seed=cfg.seed,
        crop_mode=cfg.crop_mode,
    )
    in_dim = io.read_event(0).points.shape[1]
    return io, batcher, in_dim, total_events


def _to_host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _metric(cm: np.ndarray, fn) -> np.ndarray:
    # in float32, as the JAX package's jnp metrics compute them
    return fn(torch.as_tensor(cm, dtype=torch.float32)).numpy()


def _make_validator(cfg, tv, group=None):
    """Periodic held-out evaluation: a callable state -> metrics dict, or
    None without a ``val_file``. The validation file's format follows its
    own extension, not the training io_type. Under data parallelism every
    rank reads the whole file and evaluates its rows of each batch (the
    host's share with several hosts); the metrics are summed over the
    ranks, so every rank returns the same."""
    if not cfg.val_file:
        return None
    from dgcnn_tpu_torch.io.readers import kind_of_path

    val_cfg = dataclasses.replace(
        cfg,
        input_file=cfg.val_file,
        io_type=kind_of_path(cfg.val_file, default=cfg.io_type),
    )
    val_io = io_factory(val_cfg).initialize()
    val_batcher = BucketBatcher(
        val_io,
        batch_size=cfg.minibatch_size,
        buckets=cfg.buckets,
        num_point=cfg.num_point,
        shuffle=False,
        seed=cfg.seed,
        crop_mode=cfg.crop_mode,
    )

    host, hosts = _hosts(group)

    def validate(state):
        cm = np.zeros((cfg.num_class, cfg.num_class), np.float64)
        loss_sum = w_sum = 0.0
        for i, batch in enumerate(val_batcher.epoch()):
            if cfg.val_batches and i >= cfg.val_batches:
                break
            m = tv.evaluate(state, batch if hosts == 1 else _local_batch_rows(batch, host, hosts))
            cm += _to_host(m["confusion"]).astype(np.float64)
            # weight each batch's mean loss by its valid-point mass, so
            # val_loss is a per-point mean across buckets
            w = float(m["loss_weight"])
            loss_sum += float(m["loss"]) * w
            w_sum += w
        acc = float(np.trace(cm) / max(cm.sum(), 1.0))
        return {
            "val_loss": loss_sum / max(w_sum, 1e-9),
            "val_acc": acc,
            "val_miou": float(_metric(cm, mean_iou)),
        }

    validate.io = val_io
    return validate


class _GracefulStop:
    """SIGTERM/SIGINT -> finish the current step, checkpoint, exit cleanly
    (preemption; pairs with --auto_resume)."""

    def __init__(self):
        self.stop = False
        self._installed = []

    def install(self):
        import signal

        def handler(signum, frame):
            # the flag first, then an async-signal-safe os.write (print()
            # can fail as a reentrant call, and an exception here would
            # skip the preemption checkpoint)
            self.stop = True
            try:
                os.write(
                    2,
                    f"received signal {signum}: checkpointing and "
                    f"stopping (repeat to abort immediately)\n".encode(),
                )
            except OSError:
                pass
            # a second signal must still kill a hung run (the flag is
            # polled between steps only): restore the original handlers
            self.uninstall()

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._installed.append((sig, signal.signal(sig, handler)))
            except ValueError:  # not the main thread
                pass
        return self

    def uninstall(self):
        import signal

        for sig, old in self._installed:
            try:
                signal.signal(sig, old)
            except ValueError:
                pass
        self._installed = []


def _save(cfg, tv, state, it: int) -> str:
    path = checkpoint.save(cfg.weight_prefix, it, tv.state_tree(state), vars(cfg))
    checkpoint.prune(cfg.weight_prefix, cfg.max_to_keep)
    return path


def _check_resume_step(start_step: int, tv, group) -> None:
    """Every rank must resume at one step: a rank that restored another
    checkpoint (a weight_prefix that is not shared) would finish early
    and leave the others waiting in a collective. All ranks see every
    step, so all raise together."""
    if group is None or group.data_size == 1:
        return
    steps = all_gather_data(torch.tensor([start_step], device=tv.device), group).tolist()
    if len(set(steps)) > 1:
        raise RuntimeError(
            f"resume step mismatch across hosts (per-process steps {steps}): "
            f"weight_prefix must point at a SHARED filesystem so every host "
            f"restores the checkpoint process 0 wrote"
        )


def train(cfg, device=None) -> dict:
    """Train per the flag surface on ``device`` (default ``cuda``), on
    every data rank (see the module docstring); returns the final
    metrics."""
    return _launched(_train, cfg, device)


def _train(cfg, device, group) -> dict:
    lead = _lead(group)
    io, batcher, in_dim, total_events = _build_io(cfg, shuffle=cfg.shuffle, group=group)
    tv = Trainval(cfg, device=device, group=group)
    state = tv.initialize(in_dim)
    validator = _make_validator(cfg, tv, group)
    start_step = 0
    restore_from = cfg.model_path
    if not restore_from and cfg.auto_resume:
        restore_from = checkpoint.latest(cfg.weight_prefix) or ""
    if restore_from:
        tree, start_step, saved_cfg = checkpoint.restore(restore_from, tv.state_tree(state))
        state = tv.load_tree(tree)
        diffs = checkpoint.model_flag_diffs(cfg, saved_cfg or {})
        if diffs and lead:
            # a resume may change shape-invariant model flags (fine-tune
            # with another k), but never silently
            print(
                "WARNING: model flags differ from the checkpoint "
                + ", ".join(
                    f"{k}: now {cur!r}, trained with {sav!r}"
                    for k, (cur, sav) in sorted(diffs.items())
                ),
                flush=True,
            )
        state = state._replace(step=start_step)
        # fold the resume step into the shuffle seed: a resumed run goes
        # on with a fresh batch order instead of the epoch's first batches
        batcher.reseed(cfg.seed + start_step)
        if lead:
            print(f"restored checkpoint at step {start_step}", flush=True)
    _check_resume_step(start_step, tv, group)

    reporter = Reporter(
        cfg.log_dir, "train", tensorboard=cfg.tensorboard,
        append=start_step > 0, start_iter=start_step,
    ) if lead else None
    prof = maybe_start_profiler(cfg.profile_dir) if lead else None
    events_per_epoch = max(total_events, 1)
    metrics = {}
    it = start_step
    batches = batcher.forever()
    if cfg.augment:
        from dgcnn_tpu_torch.io.augment import augment_stream

        # keyed off the resume step, so a resumed run draws new transforms;
        # the ranks of one host augment their global batch alike
        batches = augment_stream(batches, cfg.seed + start_step, process_index=_hosts(group)[0])
    stream = prefetch(batches, cfg.prefetch)
    stopper = _GracefulStop().install()

    patience = int(cfg.early_stop_patience or 0)
    best_val, stale = float("inf"), 0
    early_stopped = False

    def agreed_stop() -> bool:
        # a signal lands on one rank (and an early stop could differ): all
        # ranks agree on one flag every iteration, so they stop at the
        # same step or none does
        flag = stopper.stop or early_stopped
        if group is None or group.data_size == 1:
            return flag
        return bool(psum_data(torch.tensor([float(flag)], device=tv.device), group).item() > 0)

    try:
        for batch in stream:
            if it >= cfg.iteration or agreed_stop():
                break
            state, metrics = tv.train_step(state, batch)
            it += 1
            if it % cfg.report_step == 0 or it == cfg.iteration or cfg.debug:
                epoch = it * cfg.minibatch_size / events_per_epoch
                row = _flatten_metrics(metrics)
                # the step just taken was update it-1 (the schedules are
                # indexed by the count of earlier updates): report the
                # rate it applied
                row["lr"] = tv.lr_at(it - 1)
                if validator is not None:
                    # the metrics are the same on every rank
                    row.update(validator(state))
                    if patience:
                        if row["val_loss"] < best_val:
                            best_val, stale = row["val_loss"], 0
                        else:
                            stale += 1
                            if stale >= patience:
                                early_stopped = True
                                if lead:
                                    print(
                                        f"early stop at iter {it}: val_loss "
                                        f"has not improved for {stale} "
                                        f"validations (best {best_val:.4f})",
                                        flush=True,
                                    )
                if reporter is not None:
                    reporter.report(it, epoch, row)
            if cfg.checkpoint_step and it % cfg.checkpoint_step == 0 and lead:
                _save(cfg, tv, state, it)
        if lead:
            path = _save(cfg, tv, state, it)
            print(f"saved final checkpoint {path}", flush=True)
    finally:
        stopper.uninstall()
        # stop and join the prefetch worker before tearing the reader
        # down (unmapping a DGB file under a worker mid-copy is a use
        # after unmap)
        stream.close()
        maybe_stop_profiler(prof)
        if reporter is not None:
            reporter.close()
        io.finalize()
        if validator is not None:
            validator.io.finalize()
    return _flatten_metrics(metrics)


def inference(cfg, device=None) -> dict:
    """Inference on ``device`` (default ``cuda``) with per-event write-back
    of predictions and scores, on every data rank (see the module
    docstring): every rank reads the whole file and computes its rows of
    each batch, the packed outputs are gathered, and rank 0 alone writes
    them back. Returns summary metrics."""
    if not cfg.model_path:
        raise ValueError("inference requires --model_path")
    return _launched(_inference, cfg, device)


def _inference(cfg, device, group) -> dict:
    lead = _lead(group)
    host, hosts = _hosts(group)
    # the served function must be the trained function: adopt the
    # checkpoint's model-defining flags (kvalue, knn_every, widths, ...)
    cfg = checkpoint.adopt_model_flags(cfg, cfg.model_path)
    io, batcher, in_dim, _ = _build_io(cfg, shuffle=False, group=group, subset=False)
    if cfg.minibatch_size % hosts:
        raise ValueError(
            f"minibatch_size={cfg.minibatch_size} not divisible by process_count={hosts}"
        )
    tv = Trainval(cfg, device=device, group=group)
    state = tv.initialize(in_dim)
    # parameters and BN state only: serving needs no optimizer state
    state, step = tv.restore_for_eval(state, cfg.model_path)
    if lead:
        print(f"restored checkpoint at step {step}", flush=True)

    writer = SegmentWriter(cfg.output_file) if cfg.output_file and lead else None
    reporter = Reporter(cfg.log_dir, "inference", tensorboard=cfg.tensorboard) if lead else None
    cm_total = np.zeros((cfg.num_class, cfg.num_class), np.float64)
    n_batches = 0
    t0 = time.perf_counter()
    stream = prefetch(batcher.epoch(), cfg.prefetch)

    nc = cfg.num_class
    cm_dev = None  # the confusion matrix accumulates on the device
    cm_pts = 0  # points accumulated since the last flush

    def consume(pending):
        """The host half of one batch: one packed device-to-host copy
        (scores, predictions and the batch loss), write-back, report."""
        batch, packed, it = pending
        if writer is not None:
            arr = _to_host(packed)
            scores_h = arr[..., :nc]
            pred_h = arr[..., nc].astype(np.int32)
            loss = float(arr[0, 0, nc + 1])
            for i, eid in enumerate(batch.event_ids):
                n_valid = int(batch.mask[i].sum())
                writer.store_segment(
                    int(eid),
                    batch.points[i, :n_valid],
                    pred_h[i, :n_valid],
                    scores_h[i, :n_valid],
                )
        else:
            # no write-back (or not rank 0): still a small copy a batch,
            # so the device queue stays paced by the host
            loss = float(packed[0, 0, nc + 1])
        if reporter is not None:
            reporter.report(it, 0.0, {"loss": loss})

    # The host half runs on one worker thread behind a small bounded
    # queue, so batch i+1's forward, batch i's copy and batch i-1's
    # write-back overlap. On error the worker records it and drains
    # without blocking the producer; the loop re-raises. FIFO order keeps
    # the writer's first-write-wins and the report order.
    work = queue.Queue(maxsize=3)
    errs = []

    def _worker():
        while True:
            item = work.get()
            try:
                if item is None:
                    return
                if not errs:
                    consume(item)
            except BaseException as e:  # surfaced by the main thread
                errs.append(e)
            finally:
                work.task_done()

    worker = threading.Thread(target=_worker, name="inference-consume", daemon=True)
    worker.start()
    try:
        for batch in stream:
            if cfg.iteration and n_batches >= cfg.iteration:
                break
            if errs:
                break
            local = batch if hosts == 1 else _local_batch_rows(batch, host, hosts)
            # the packed output comes back gathered: the whole global batch
            packed, metrics = tv.inference_packed(state, local)
            cm = metrics["confusion"]
            cm_dev = cm if cm_dev is None else cm_dev + cm
            cm_pts += batch.points.shape[0] * batch.points.shape[1]
            n_batches += 1
            if cm_pts >= _CM_FLUSH_POINTS:
                # flush the f32 accumulator into host f64 before any
                # cell could approach 2^24
                cm_total += _to_host(cm_dev).astype(np.float64)
                cm_dev = None
                cm_pts = 0
            work.put((batch, packed, n_batches))
    finally:
        work.put(None)
        worker.join()
        stream.close()
        if cm_dev is not None:
            cm_total += _to_host(cm_dev).astype(np.float64)
        if reporter is not None:
            reporter.close()
        io.finalize()
    if errs:
        # raised outside the finally, so a loop-body exception is never
        # masked by the worker's
        raise errs[0]
    if writer is not None:
        writer.finalize()
        print(f"wrote {len(writer)} events -> {cfg.output_file}", flush=True)

    acc = float(np.trace(cm_total) / max(cm_total.sum(), 1.0))
    miou = float(_metric(cm_total, mean_iou))
    pca = _metric(cm_total, per_class_accuracy)
    dt = time.perf_counter() - t0
    if lead:
        print(
            f"inference: {n_batches} batches in {dt:.2f}s  acc={acc:.4f} "
            f"mIoU={miou:.4f} per-class={np.round(pca, 4).tolist()}",
            flush=True,
        )
    return {"acc": acc, "miou": miou, "batches": n_batches}
