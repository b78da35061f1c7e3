"""The traced run: `torch.profiler` around the measured window, the
benchmark's own spans, and the reduction of the trace to what the
per-layer readers and ``breakdown`` read.

Spans are the benchmark's (``portbench.window`` around the window,
``portbench.batch_wait`` around ``next()`` on the prefetch iterator,
``portbench.step`` / ``portbench.batch`` around the call into the train
or serve entry, ``portbench.copy`` around a served batch's copy to the
host on the consumer thread); the program has none of its own yet.

A device operation is a kernel, a copy or a memset on the card
(``gpu_user_annotation`` ranges are not operations). ``busy_s`` is the
length of the union of their intervals inside the window, so kernels
that overlap count once; ``window_s`` is the window's span on the same
clock. An idle gap is a stretch of the window with no device operation;
it is named by the benchmark span and the innermost host operation that
were running at its middle.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import sys

import numpy as np
import torch

TOP = 10


@dataclasses.dataclass
class Trace:
    """What a reader reads (times in seconds)."""

    kind: str  # "train" or "serve"
    window_s: float
    busy_s: float
    device_ops: list  # (name, start_s, end_s), clipped to the window
    spans: dict  # span name -> [(start_s, end_s)]
    units: int  # steps or batches in the window
    model_flops: float  # their model operations
    bounds_s: dict  # kernel family -> the least time of their launches of it
    peak_flops: float
    gaps: list  # (label, seconds), longest first
    latencies: list  # serve: each batch's seconds from the iterator to its answer on the host


class Recorder:
    """Spans and the profiler of one run; inert when ``enabled`` is off,
    so the untraced run pays nothing for them."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled = enabled
        self.cuda = cuda
        self.prof = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.start()

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.stop()

    def events(self):
        """``(name, activity, on_device, start_s, end_s)`` of every event,
        as the profiler parsed them (one clock for the host's and the
        card's; the raw kineto events held no kernels on the card)."""
        cpu = torch.autograd.DeviceType.CPU
        out = []
        for e in self.prof.events():
            on_device = e.device_type != cpu
            note = bool(getattr(e, "is_user_annotation", False))
            # a device event that is no annotation is an operation: a
            # kernel, a copy or a memset
            act = ("gpu_user_annotation" if note else "kernel") if on_device else (
                "user_annotation" if note else "cpu_op")
            out.append((e.name, act, on_device, e.time_range.start * 1e-6,
                        e.time_range.end * 1e-6))
        return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(rec: Recorder, kind: str, units: int, model_flops: float, bounds_s: dict,
           peak_flops: float, latencies: list) -> Trace:
    """The trace of ``rec``'s window."""
    events = rec.events()
    kinds = collections.Counter((a, d) for _, a, d, _, _ in events)
    print(f"trace: {len(events)} events by (activity, on device): {dict(kinds)}",
          file=sys.stderr, flush=True)
    spans: dict = {}
    host_ops = []
    for name, act, on_device, s, e in events:
        if on_device:
            continue
        if name.startswith("portbench."):
            spans.setdefault(name, []).append((s, e))
        elif act == "cpu_op":
            host_ops.append((s, e, name))
    (w0, w1), = spans.pop("portbench.window")
    ops = [(name, max(s, w0), min(e, w1)) for name, act, on_device, s, e in events
           if act == "kernel" and e > w0 and s < w1]
    busy = _union([(s, e) for _, s, e in ops])
    busy_s = sum(e - s for s, e in busy)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)
    return Trace(kind=kind, window_s=w1 - w0, busy_s=busy_s, device_ops=ops, spans=spans,
                 units=units, model_flops=model_flops, bounds_s=bounds_s,
                 peak_flops=peak_flops, gaps=_label(gaps[:TOP], spans, host_ops),
                 latencies=latencies)


def _label(gaps, spans, host_ops):
    """Each gap as ``(what the host was doing, seconds)``."""
    if host_ops:
        starts = np.array([s for s, _, _ in host_ops])
        ends = np.array([e for _, e, _ in host_ops])
    out = []
    for dur, s, e in gaps:
        mid = 0.5 * (s + e)
        span = next((name for name, ivs in spans.items()
                     if any(a <= mid <= b for a, b in ivs)), "no span")
        label = span
        if host_ops:
            inside = np.nonzero((starts <= mid) & (mid <= ends))[0]
            if inside.size:
                label += " > " + host_ops[int(inside[np.argmax(starts[inside])])][2]
        out.append((label, dur))
    return out


def breakdown(t: Trace) -> dict:
    """The device operations that took most time, by name, and the
    longest idle gaps."""
    by_name: dict = {}
    for name, s, e in t.device_ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:TOP]
    return {"device_ops": [[n[:200], v] for n, v in top],
            "idle_gaps": [[n[:200], v] for n, v in t.gaps]}

