"""Timing and profiling helpers (port of `dgcnn_tpu/utils/timing.py`):
an accumulating wall-clock timer, a `torch.profiler` trace scope for
``--profile_dir``, the program's named spans in such a trace, and the
card's memory counters."""

from __future__ import annotations

import contextlib
import os
import time


class Timer:
    """Accumulating wall-clock timer: ``with timer.measure(): ...``."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total += time.perf_counter() - t0
            self.count += 1

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


# what `span` returns while no profiler records: one object, reused
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named range of the program in a `torch.profiler` trace
    (``torch.profiler.record_function``) while a profiler records on this
    thread, e.g. ``--profile_dir``'s; otherwise one reused
    ``nullcontext``, so an unprofiled run pays a check and a ``with``.

    The program's spans, each with the same name wherever it opens:
    ``dgcnn.train_step`` and ``dgcnn.inference`` (a train step, an eval
    call), ``dgcnn.put_batch`` (the batch's slicing and host-to-device
    copies), ``dgcnn.graph`` (each graph build), ``dgcnn.edgeconv`` (each
    EdgeConv block), ``dgcnn.edge_mlp`` (inside it, a block's stacked
    per-edge convs), ``dgcnn.head``, ``dgcnn.loss``, ``dgcnn.backward``
    (``torch.autograd.grad`` and the gradient's all-reduce),
    ``dgcnn.optimizer``, ``dgcnn.outputs`` (a step's accuracies; an eval
    call's loss, confusion, scores and packing) and ``dgcnn.batch_wait``
    (the consumer's wait on the prefetch queue)."""
    import torch

    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def profiler(profile_dir: str | None):
    """An unstarted `torch.profiler` session of the host (and the card
    when there is one) whose `export_trace` writes a Chrome trace into
    ``profile_dir``; None when the directory is empty."""
    if not profile_dir:
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.trace_path = os.path.join(profile_dir, f"trace-{os.getpid()}.json")
    return prof


@contextlib.contextmanager
def trace(profile_dir: str | None):
    """A `profiler` scope that writes its Chrome trace on exit; no-op when
    ``profile_dir`` is empty."""
    prof = profiler(profile_dir)
    if prof is None:
        yield
        return
    with prof:
        yield prof
    prof.export_chrome_trace(prof.trace_path)


def device_memory_stats() -> dict:
    """Live, peak and reserved bytes of ``cuda:0`` (empty without a card),
    from ``torch.cuda.memory_stats``."""
    import torch

    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(0)
    keep = {
        "allocated_bytes.all.current": "bytes_in_use",
        "allocated_bytes.all.peak": "peak_bytes_in_use",
        "reserved_bytes.all.current": "bytes_reserved",
    }
    return {name: int(stats[k]) for k, name in keep.items() if k in stats}
