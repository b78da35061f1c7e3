"""The card's time and idle gaps of a traced window, by the program's own
spans, and the layer readings they give.

The program (``dgcnn_tpu_torch``) opens ``dgcnn.*`` spans at its layer
boundaries (`dgcnn_tpu_torch.utils.timing.span`) whenever a profiler
records; `torch.profiler` puts them, the benchmark's ``portbench.*``
spans, the host's operations and the card's on one clock. A device
operation of the window (kernel, copy or memset) belongs to

1. its launching host operation: the frontend event whose correlation id
   is the operation's ``linked_correlation_id``, and that event's thread;
2. if that host operation lies inside an ``autograd::engine::
   evaluate_function: ...`` event, it is backward work: it goes to the
   innermost program span on the event's ``fwd_thread`` that was open when
   the forward created the autograd node of the event's ``sequence_nr``
   (the last forward event on that thread to carry the number; a custom
   ``autograd.Function``'s backward carries its forward's number, so the
   fused EdgeConv's ``GatheredStatsBackward`` lands in ``dgcnn.edgeconv``);
3. otherwise to the innermost program span open on the launching thread
   at the launch;
4. failing that, to the benchmark span open there (the consumer thread's
   copy to the host is ``portbench.copy``);
5. failing all, to nobody: ``unattributed_s``.

``device_s_by_span`` is, for each span name, the length of the union of
its operations' intervals inside the window; an idle gap of
`portbench.trace` is labelled as there, with the innermost program span on
the window's thread inserted after the benchmark span: what the host was
dispatching while the card waited. Every lookup is a bisection over one
thread's events sorted by start, so a window of 10^6 events reduces in
seconds.

`layer_readings` turns an attribution into milliseconds a step or batch
(the layer metrics ``edgeconv_ms``, ``head_ms``, ``optimizer_ms``,
``put_batch_ms``, ``dispatch_ms``). Run as a module it traces one cell of
``BENCHMARK.json`` on the card, once untraced and once traced, and prints
both windows' time a step or batch, the attribution and the readings as
one JSON line (no check of the outputs: that is `portbench.run`'s):

    python3 -m portbench.attribution --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import NamedTuple

from portbench import trace

PROGRAM = "dgcnn."
BENCH = "portbench."
BACKWARD = "autograd::engine::evaluate_function:"
NO_SPAN = "no span"


class Event(NamedTuple):
    """One event of the profiler, with what attribution needs."""

    name: str
    thread: int
    start: float  # seconds, on the profiler's clock
    end: float
    on_device: bool
    annotation: bool  # a ``record_function`` range, host or device
    corr: int  # the event's correlation id
    linked: int  # the launching event's id (device operations, runtime calls); else 0
    seq: int  # the autograd sequence number, -1 without
    fwd_thread: int  # a backward event's forward thread


def profiler_events(prof) -> list:
    """The `Event`s of a stopped ``torch.profiler.profile``, read from its
    kineto results, on the clock and with the filter of ``prof.events()``.

    `trace.Recorder.events` reads the parsed ``prof.events()``. On torch
    2.11 with CUDA 12.8 on an H100 both hold the same device operations
    (the same ``busy_s``, to the last digit, in every traced window of
    either cell), so the remark there that the kineto events held no
    kernels does not hold; but the parsed events drop each device
    operation's ``linked_correlation_id``, which attribution needs."""
    import torch
    from torch.autograd.profiler_util import _filter_name

    result = prof.profiler.kineto_results
    t0 = result.trace_start_ns()
    cpu = torch.autograd.DeviceType.CPU
    return [Event(k.name(), k.start_thread_id(), (k.start_ns() - t0) / 1000 * 1e-6,
                  (k.end_ns() - t0) / 1000 * 1e-6, k.device_type() != cpu,
                  k.is_user_annotation(), k.correlation_id(), k.linked_correlation_id(),
                  k.sequence_nr(), k.fwd_thread_id())
            for k in result.events()
            if not (_filter_name(k.name()) or getattr(k, "is_hidden_event", lambda: False)())]


class _Nest:
    """Properly nested ranges of one thread: the innermost one holding a
    time, by bisection and then up the parents."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))  # (start, end, payload)
        self.starts = [r[0] for r in self.ranges]
        self.parent, stack = [], []
        for i, (s, e, _) in enumerate(self.ranges):
            while stack and self.ranges[stack[-1]][1] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: float):
        """The innermost range holding ``t``, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ranges[i][1] < t:
            i = self.parent[i]
        return self.ranges[i] if i >= 0 else None


@dataclasses.dataclass
class Attribution:
    """A traced window by span (times in seconds)."""

    window_s: float
    busy_s: float
    device_s_by_span: dict  # span name -> the union of its operations' intervals
    attributed_s: float  # the union of every attributed operation's interval
    unattributed_s: float  # the union of the operations no span holds
    idle_s_by_span: dict  # the window's idle time by the window thread's innermost span
    gaps: list  # (label, seconds), longest first: `portbench.trace`'s, the program span added
    spans: dict  # every ``dgcnn.*`` and ``portbench.*`` span inside the window -> [(start, end)]
    unattributed: list  # (launching host event or "no launcher", seconds), most first


def _union_s(intervals) -> float:
    return sum(e - s for s, e in trace._union(intervals))


def _inner(nests, thread, t):
    """The payload of the innermost range of ``nests[thread]`` holding ``t``."""
    r = nests[thread].at(t) if thread in nests else None
    return r[2] if r else None


class Owners:
    """Which span each host event's device work belongs to (rules 2-4 of
    the module docstring), over one trace's host events."""

    def __init__(self, events: list):
        program, bench, backward = {}, {}, {}
        self.frontend, self.forward = {}, {}
        host = [ev for ev in events if not ev.on_device]
        for ev in host:
            if ev.linked == 0:
                self.frontend[ev.corr] = ev
            if ev.annotation and ev.name.startswith(PROGRAM):
                program.setdefault(ev.thread, []).append((ev.start, ev.end, ev.name))
            elif ev.annotation and ev.name.startswith(BENCH):
                bench.setdefault(ev.thread, []).append((ev.start, ev.end, ev.name))
            elif ev.name.startswith(BACKWARD):
                backward.setdefault(ev.thread, []).append((ev.start, ev.end, ev))
        self.program = {t: _Nest(r) for t, r in program.items()}
        self.bench = {t: _Nest(r) for t, r in bench.items()}
        self.backward = {t: _Nest(r) for t, r in backward.items()}
        # where each autograd node was made: the last forward event (outside
        # any backward) on its thread to carry its sequence number
        for ev in host:
            if ev.seq >= 0 and not ev.name.startswith(BACKWARD) and not (
                    ev.thread in self.backward and self.backward[ev.thread].at(ev.start)):
                key = (ev.thread, ev.seq)
                if self.forward.get(key, -1.0) < ev.start:
                    self.forward[key] = ev.start

    def node(self, h: Event):
        """The backward node (its ``evaluate_function`` event) that host
        event ``h`` runs inside, or None."""
        return _inner(self.backward, h.thread, h.start)

    def owner(self, h: Event):
        """The span ``h``'s device work belongs to, or None."""
        bwd = self.node(h)
        if bwd is not None and bwd.seq >= 0:
            made = self.forward.get((bwd.fwd_thread, bwd.seq))
            name = None if made is None else _inner(self.program, bwd.fwd_thread, made)
            if name is not None:
                return name
        return _inner(self.program, h.thread, h.start) or _inner(self.bench, h.thread, h.start)

    def launcher(self, op: Event):
        """The host event that launched device operation ``op``, or None."""
        return self.frontend.get(op.linked) if op.linked > 0 else None


def attribute(events: list) -> Attribution:
    """The attribution of ``events`` (the `Event`s of one traced window:
    one ``portbench.window`` span)."""
    (w0, w1, main), = [(ev.start, ev.end, ev.thread) for ev in events
                       if not ev.on_device and ev.name == BENCH + "window"]
    owners = Owners(events)
    ops = [(ev, max(ev.start, w0), min(ev.end, w1)) for ev in events
           if ev.on_device and not ev.annotation and ev.end > w0 and ev.start < w1]
    by_span, none, why = {}, [], {}
    for ev, s, e in ops:
        h = owners.launcher(ev)
        name = owners.owner(h) if h is not None else None
        if name:
            by_span.setdefault(name, []).append((s, e))
        else:
            none.append((s, e))
            key = "no launcher" if h is None else h.name
            why[key] = why.get(key, 0.0) + (e - s)
    busy = trace._union([(s, e) for _, s, e in ops])
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)
    inside = {}
    for nests in (owners.program, owners.bench):
        for nest in nests.values():
            for s, e, name in nest.ranges:
                if s >= w0 and e <= w1 and name != BENCH + "window":
                    inside.setdefault(name, []).append((s, e))
    program, bench = owners.program.get(main), owners.bench.get(main)
    return Attribution(
        window_s=w1 - w0, busy_s=sum(e - s for s, e in busy),
        device_s_by_span={k: _union_s(v) for k, v in sorted(by_span.items())},
        attributed_s=_union_s([iv for v in by_span.values() for iv in v]),
        unattributed_s=_union_s(none),
        idle_s_by_span=_idle_by_span(gaps, program, bench),
        gaps=_label(gaps[:trace.TOP], events, program),
        spans={k: sorted(v) for k, v in inside.items()},
        unattributed=sorted(why.items(), key=lambda kv: kv[1], reverse=True)[:trace.TOP])


def _idle_by_span(gaps, program, bench) -> dict:
    """Each idle gap's seconds split by the innermost span (the program's,
    else the benchmark's) open on the window's thread over it."""
    nests = [n for n in (program, bench) if n is not None]
    cuts = sorted({t for n in nests for s, e, _ in n.ranges for t in (s, e)})
    out: dict = {}
    for _, s, e in gaps:
        pts = [s] + cuts[bisect.bisect_right(cuts, s):bisect.bisect_left(cuts, e)] + [e]
        for a, b in zip(pts, pts[1:]):
            mid = 0.5 * (a + b)
            name = next((r[2] for r in (n.at(mid) for n in nests) if r), NO_SPAN)
            out[name] = out.get(name, 0.0) + (b - a)
    return dict(sorted(out.items(), key=lambda kv: kv[1], reverse=True))


def _label(gaps, events, program) -> list:
    """`portbench.trace`'s labels of ``gaps``, the window thread's
    innermost program span inserted after the benchmark span."""
    spans, host_ops = {}, []
    for ev in events:
        if ev.on_device:
            continue
        if ev.name.startswith(BENCH) and ev.name != BENCH + "window":
            spans.setdefault(ev.name, []).append((ev.start, ev.end))
        elif not ev.annotation:
            host_ops.append((ev.start, ev.end, ev.name))
    out = []
    for (label, dur), (_, s, e) in zip(trace._label(gaps, spans, host_ops), gaps):
        inner = program.at(0.5 * (s + e)) if program is not None else None
        if inner is not None:
            head, sep, tail = label.partition(" > ")
            label = f"{head} > {inner[2]}" + (sep + tail if sep else "")
        out.append((label, dur))
    return out


def _mean_ms(intervals) -> float | None:
    return 1e3 * sum(e - s for s, e in intervals) / len(intervals) if intervals else None


def layer_readings(a: Attribution, kind: str, units: int) -> dict:
    """The layer metrics of a window of ``units`` steps (``kind``
    ``"train"``) or batches (``"serve"``), in milliseconds; a reading the
    trace holds nothing for is None (a program without spans)."""
    dev = a.device_s_by_span

    def device_ms(*names):
        if units == 0 or not any(n in dev for n in names):
            return None
        return 1e3 * sum(dev.get(n, 0.0) for n in names) / units

    put = _mean_ms(a.spans.get(PROGRAM + "put_batch", []))
    if kind == "train":
        return {"edgeconv_ms.train": device_ms("dgcnn.edgeconv"),
                "head_ms.train": device_ms("dgcnn.head", "dgcnn.loss", "dgcnn.outputs"),
                "optimizer_ms.train": device_ms("dgcnn.optimizer"),
                "put_batch_ms.train": put}
    calls = a.spans.get(PROGRAM + "inference", [])
    puts = a.spans.get(PROGRAM + "put_batch", [])
    dispatch = None
    if calls:
        # each call less the put_batch inside it
        j, own = 0, 0.0
        for s, e in calls:
            own += e - s
            while j < len(puts) and puts[j][0] < s:
                j += 1
            while j < len(puts) and puts[j][1] <= e:
                own -= puts[j][1] - puts[j][0]
                j += 1
        dispatch = 1e3 * own / len(calls)
    return {"edgeconv_ms.serve": device_ms("dgcnn.edgeconv"),
            "head_ms.serve": device_ms("dgcnn.head", "dgcnn.outputs"),
            "put_batch_ms.serve": put, "dispatch_ms.serve": dispatch}


# ---------------------------------------------------------------- on the card


@contextlib.contextmanager
def _keeping():
    """The harness's `trace.Recorder`s made inside, kept reachable after the
    harness drops them."""
    made = []

    class Keep(trace.Recorder):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    plain, trace.Recorder = trace.Recorder, Keep
    try:
        yield made
    finally:
        trace.Recorder = plain


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(prog="python3 -m portbench.attribution")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from portbench import harness

    build = os.path.join(harness.ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    import torch

    if not torch.cuda.is_available():
        print("portbench.attribution: needs a CUDA card", file=sys.stderr, flush=True)
        return 3
    torch.set_num_threads(4)
    cell = harness.load_cell(args.workload)
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0), "power_limit_w": harness.power_limit()}
    plain = harness.program(cell, args.seed, args.seconds, False, "cuda", t0)
    out["untraced_ms_a_unit"] = 1e3 * plain.seconds / len(plain.units)
    del plain
    with _keeping() as made:
        w = harness.program(cell, args.seed, args.seconds, True, "cuda", time.perf_counter())
        t1 = time.perf_counter()
        a = attribute(profiler_events(made[-1].prof))
        out["reduce_s"] = time.perf_counter() - t1
    kind, units = cell.traffic["kind"], len(w.units)
    out.update(traced_ms_a_unit=1e3 * w.seconds / units, units=units,
               window_s=a.window_s, busy_s=a.busy_s, trace_busy_s=w.trace.busy_s,
               attributed_s=a.attributed_s, unattributed_s=a.unattributed_s,
               device_s_by_span=a.device_s_by_span, idle_s_by_span=a.idle_s_by_span,
               span_counts={k: len(v) for k, v in sorted(a.spans.items())},
               readings=layer_readings(a, kind, units), gaps=a.gaps,
               trace_gaps=w.trace.gaps, unattributed=a.unattributed)
    print(f"unattributed_s {a.unattributed_s!r} of busy_s {a.busy_s!r}", file=sys.stderr,
          flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
