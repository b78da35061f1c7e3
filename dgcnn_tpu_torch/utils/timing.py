"""Timing and profiling helpers (port of `dgcnn_tpu/utils/timing.py`):
an accumulating wall-clock timer, a `torch.profiler` trace scope for
``--profile_dir``, and the card's memory counters."""

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
