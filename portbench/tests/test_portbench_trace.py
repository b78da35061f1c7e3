"""The traced window's reduction on a synthetic trace: `trace.reduce`'s
fields, which the per-layer readers read, and `attribution`'s split of the
same window by span (two host threads and an autograd thread, a consumer
copy, a backward node found by its sequence number, launches no span holds
and a stretch with no launch), and on the program's own trace of a tiny
train step (on the CPU) and of a step and a served batch (on the card)."""

from __future__ import annotations

import collections
import json
import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import attribution, harness, trace
from portbench.attribution import Event

MS = 1e-3
MAIN, AUTOGRAD, CONSUMER = 11, 12, 13
_corr = iter(range(1000, 10**9))


def host(name, thread, s, e, annotation=False, seq=-1, fwd_thread=0):
    return Event(name, thread, s * MS, e * MS, False, annotation, next(_corr), 0, seq, fwd_thread)


def span(name, thread, s, e):
    return host(name, thread, s, e, annotation=True)


def launch(op, s, e, name="kernel"):
    """A device operation launched by host event ``op`` (None: by none)."""
    return Event(name, 7, s * MS, e * MS, True, False, next(_corr),
                 0 if op is None else op.corr, -1, 0)


def window():
    """A step's trace: forward on MAIN, its backward on AUTOGRAD, a copy on
    CONSUMER; times in ms of a 100 ms window."""
    mm = host("aten::mm", MAIN, 4, 5, seq=7)
    head_mm = host("aten::addmm", MAIN, 22, 23, seq=9)
    bwd_mm = host("aten::mm", AUTOGRAD, 33, 34)
    bwd_head = host("aten::mul", AUTOGRAD, 36, 36.5)
    accumulate = host("aten::add_", AUTOGRAD, 37.5, 38)
    copy = host("aten::copy_", CONSUMER, 61, 61.5)
    events = [
        span("portbench.window", MAIN, 0, 100),
        span("portbench.step", MAIN, 1, 50),
        span("dgcnn.train_step", MAIN, 2, 49),
        span("dgcnn.edgeconv", MAIN, 3, 20), mm,
        # an operation that makes no node carries the next number too
        host("aten::empty", MAIN, 2.5, 2.6, seq=7),
        span("dgcnn.head", MAIN, 21, 30), head_mm,
        span("dgcnn.backward", MAIN, 31, 45),
        host("autograd::engine::evaluate_function: MmBackward0", AUTOGRAD, 32, 35, seq=7,
             fwd_thread=MAIN), bwd_mm,
        host("autograd::engine::evaluate_function: AddmmBackward0", AUTOGRAD, 35.5, 37,
             seq=9, fwd_thread=MAIN), bwd_head,
        host("autograd::engine::evaluate_function: torch::autograd::AccumulateGrad",
             AUTOGRAD, 37.2, 38.5, fwd_thread=0), accumulate,
        span("portbench.batch_wait", MAIN, 50, 60),
        span("dgcnn.batch_wait", MAIN, 51, 59),
        host("aten::empty_strided", MAIN, 52, 53),
        span("portbench.copy", CONSUMER, 60, 70), copy,
        launch(mm, 10, 15), launch(head_mm, 16, 18), launch(bwd_mm, 35, 39),
        launch(bwd_head, 40, 41), launch(accumulate, 42, 43),
        launch(copy, 61, 62, "Memcpy DtoH (Device -> Pageable)"),
        launch(None, 85, 86),
        # the device side of an annotation is no operation
        Event("dgcnn.edgeconv", 7, 3 * MS, 20 * MS, True, True, next(_corr), 0, -1, 0),
    ]
    return events


class _Rec:
    """`trace.Recorder`'s ``events()`` of a list of `Event`s."""

    def __init__(self, events):
        self._events = events

    def events(self):
        return [(ev.name, ("gpu_user_annotation" if ev.annotation else "kernel") if ev.on_device
                 else ("user_annotation" if ev.annotation else "cpu_op"), ev.on_device,
                 ev.start, ev.end) for ev in self._events]


def _reduce(events, kind="train", units=1):
    return trace.reduce(_Rec(events), kind, units, model_flops=6.7e11, bounds_s={"knn": 2 * MS},
                        peak_flops=67e12, latencies=[5 * MS, 7 * MS])


def test_reduce_gives_the_readers_their_numbers():
    """The fields the nine per-layer readers read, on the synthetic step
    and a served batch of the same events, and what each reader reads."""
    t = _reduce(window())
    assert t.window_s == pytest.approx(100 * MS)
    assert t.busy_s == pytest.approx(15 * MS)
    assert sorted(t.spans) == ["portbench.batch_wait", "portbench.copy", "portbench.step"]
    assert [n for n, _, _ in t.device_ops].count("kernel") == 6
    assert t.gaps[0] == ("no span", pytest.approx(23 * MS))  # 62 to 85 ms
    assert t.gaps[1] == ("portbench.batch_wait > aten::empty_strided", pytest.approx(18 * MS))
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    want = {"batch_wait_ms": 10.0, "mfu": 10.0, "idle_pct": 85.0, "knn_roofline": None,
            "batch_ms_p95": 6.9}
    for kind in ("train", "serve"):
        t = _reduce(window(), kind)
        for m in bench["per_layer"]:
            base, _, of = m["name"].partition(".")
            if base not in want:
                continue
            got = harness.load_reader(m["name"]).read(t)
            if of != kind or want[base] is None or (base == "batch_ms_p95" and kind != "serve"):
                assert got is None, m["name"]
            else:
                assert got == pytest.approx(want[base]), m["name"]


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_the_knn_roofline_reads_its_familys_bound(kind):
    """``knn_roofline.*`` reads the ``knn`` entry of ``bounds_s`` over the
    exact kNN kernels' device time, and nothing where the network's work
    count has no ``knn`` bound."""
    mm = host("aten::mm", MAIN, 4, 5)
    events = window() + [launch(mm, 20, 24, "void dgcnn::f32h::knn_topk_kernel_hopper<1>")]
    reader = harness.load_reader(f"knn_roofline.{kind}")
    assert reader.read(_reduce(events, kind)) == pytest.approx(50.0)  # 2 ms of 4
    t = _reduce(events, kind)
    t.bounds_s = {"banded": 1 * MS}
    assert reader.read(t) is None


def test_attribution_by_span():
    """Forward operations by their launch's innermost program span, the
    backward's by the forward node of their sequence number, the
    consumer's copy by the benchmark's span, the rest unattributed."""
    a = attribution.attribute(window())
    assert a.window_s == pytest.approx(100 * MS) and a.busy_s == pytest.approx(15 * MS)
    assert a.device_s_by_span == {"dgcnn.edgeconv": pytest.approx(9 * MS),
                                  "dgcnn.head": pytest.approx(3 * MS),
                                  "portbench.copy": pytest.approx(1 * MS)}
    assert a.attributed_s == pytest.approx(13 * MS)
    assert a.unattributed_s == pytest.approx(2 * MS)
    assert a.attributed_s + a.unattributed_s == pytest.approx(a.busy_s)
    assert len(a.spans["dgcnn.edgeconv"]) == 1 and "portbench.window" not in a.spans


def test_gap_labels_gain_the_program_span():
    """The same gaps as `trace.reduce`, longest first, each label with the
    window thread's innermost program span after the benchmark span."""
    events = window()
    old, new = _reduce(events).gaps, attribution.attribute(events).gaps
    assert [d for _, d in new] == [d for _, d in old]
    assert new[1] == ("portbench.batch_wait > dgcnn.batch_wait > aten::empty_strided",
                      pytest.approx(18 * MS))
    for (was, _), (now, _) in zip(old, new):
        head, _, tail = was.partition(" > ")
        assert now.startswith(head) and now.endswith(tail)
    assert new[2] == ("portbench.step > dgcnn.head", pytest.approx(17 * MS))  # 18 to 35 ms
    assert new[4] == ("portbench.step > dgcnn.edgeconv > aten::mm", pytest.approx(10 * MS))


def test_idle_splits_by_the_innermost_span():
    a = attribution.attribute(window())
    assert sum(a.idle_s_by_span.values()) == pytest.approx(a.window_s - a.busy_s)
    # 3 to 10, 15 to 16 and 18 to 20 ms
    assert a.idle_s_by_span["dgcnn.edgeconv"] == pytest.approx(10 * MS)
    assert a.idle_s_by_span["dgcnn.head"] == pytest.approx(9 * MS)
    assert a.idle_s_by_span["dgcnn.batch_wait"] == pytest.approx(8 * MS)
    # 0 to 1, 60 to 61, 62 to 85 and 86 to 100 ms: between the benchmark's spans
    assert a.idle_s_by_span["portbench.window"] == pytest.approx(39 * MS)


def test_layer_readings():
    a = attribution.attribute(window())
    got = attribution.layer_readings(a, "train", 1)
    assert got == {"edgeconv_ms.train": pytest.approx(9.0), "head_ms.train": pytest.approx(3.0),
                   "optimizer_ms.train": None, "put_batch_ms.train": None}
    # two served batches: each call less its put_batch
    events = [span("portbench.window", MAIN, 0, 40),
              span("dgcnn.inference", MAIN, 1, 11), span("dgcnn.put_batch", MAIN, 1, 4),
              span("dgcnn.inference", MAIN, 20, 28), span("dgcnn.put_batch", MAIN, 20, 21)]
    got = attribution.layer_readings(attribution.attribute(events), "serve", 2)
    assert got["put_batch_ms.serve"] == pytest.approx(2.0)
    assert got["dispatch_ms.serve"] == pytest.approx(7.0)
    assert got["edgeconv_ms.serve"] is None and got["head_ms.serve"] is None


def test_a_program_without_spans_reads_nothing():
    """The parent's program opens no ``dgcnn.*`` span: every reading is
    None, and its device time goes to the benchmark's spans."""
    events = [ev for ev in window() if not ev.name.startswith("dgcnn.")]
    a = attribution.attribute(events)
    assert set(a.device_s_by_span) <= {"portbench.step", "portbench.copy"}
    assert set(attribution.layer_readings(a, "train", 1).values()) == {None}


def test_a_large_window_reduces_in_seconds():
    """About 10^5 spans and operations, a thousand steps deep."""
    events = [span("portbench.window", MAIN, 0, 1e6)]
    for i in range(5000):
        t = 100.0 * i
        events.append(span("dgcnn.edgeconv", MAIN, t, t + 50))
        for j in range(5):
            op = host("aten::mul", MAIN, t + 10 * j, t + 10 * j + 1, seq=i)
            events += [op, launch(op, t + 10 * j + 2, t + 10 * j + 5)]
    t0 = time.perf_counter()
    a = attribution.attribute(events)
    assert time.perf_counter() - t0 < 10
    assert a.device_s_by_span["dgcnn.edgeconv"] == pytest.approx(5000 * 5 * 3 * MS)


# ------------------------------------------------- the program's own trace

SMALL = dict(model_name="residual-dgcnn", num_class=2, kvalue=6, edge_filters=(12, 12, 12),
             head_feat_dim=24, head_mlp=(16,), minibatch_size=2, num_point=128)
BLOCKS = len(SMALL["edge_filters"])
# the fused block's backward is its custom function's; the edge form's
# runs through the neighbour gather
EDGE_BACKWARD = {"fused": "GatheredStatsBackward", "edge": "GatherBackward0"}


def _trainer(device, **kw):
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.train.trainval import Trainval

    tv = Trainval(Config(**{**SMALL, **kw}), device=device)
    return tv, tv.initialize(4, generator=torch.Generator().manual_seed(0))


def _batch():
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO

    src = SyntheticIO(num_events=2, num_point=SMALL["num_point"], seed=3).initialize()
    return next(iter(BucketBatcher(src, 2, buckets=(SMALL["num_point"],),
                                   shuffle=False).epoch()))


@pytest.mark.parametrize("impl", sorted(EDGE_BACKWARD))
def test_the_edgeconv_backward_is_attributed_to_its_block(impl):
    """`Owners` on a traced train step: the host operations inside the
    EdgeConv backward's autograd nodes belong to ``dgcnn.edgeconv``, the
    loss's to ``dgcnn.loss``, and no backward operation is left without a
    span."""
    tv, state = _trainer("cpu", block_impl=impl)
    batch = _batch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("portbench.window"):
            tv.train_step(state, batch)
    events = attribution.profiler_events(prof)
    owners = attribution.Owners(events)
    nodes = collections.defaultdict(set)  # (node, sequence number) -> its operations' spans
    for ev in events:
        if ev.annotation or ev.name.startswith(attribution.BACKWARD):
            continue
        node = owners.node(ev)
        if node is not None and node.seq >= 0:
            nodes[node.name.split(": ", 1)[1], node.seq].add(owners.owner(ev))
    assert all(len(spans) == 1 for spans in nodes.values())
    owner = {key: spans.pop() for key, spans in nodes.items()}
    edge = [sp for (name, _), sp in owner.items() if name == EDGE_BACKWARD[impl]]
    assert edge.count("dgcnn.edgeconv") == BLOCKS
    assert [sp for (name, _), sp in owner.items() if name == "LogSoftmaxBackward0"] == [
        "dgcnn.loss"]
    assert set(owner.values()) == {"dgcnn.edgeconv", "dgcnn.head", "dgcnn.loss"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_card_time_goes_to_the_spans(cuda):
    """On the card, a traced train step and a served batch (the exact kNN
    kernel as the graph build) leave at most 1% of the device time outside
    every span, and the fused block's backward kernels, launched from the
    autograd engine's thread, land in ``dgcnn.edgeconv``."""
    tv, state = _trainer(cuda)
    batch = _batch()
    state, _ = tv.train_step(state, batch)
    tv.inference_packed(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the window the attribution reads, as the benchmark names it
        with record_function("portbench.window"):
            state, _ = tv.train_step(state, batch)
            tv.inference_packed(state, batch)
            torch.cuda.synchronize()
    events = attribution.profiler_events(prof)
    a = attribution.attribute(events)
    assert a.busy_s > 0 and a.unattributed_s <= 0.01 * a.busy_s, a.unattributed
    assert {"dgcnn.graph", "dgcnn.edgeconv", "dgcnn.head", "dgcnn.optimizer"} <= set(
        a.device_s_by_span)
    owners = attribution.Owners(events)
    main = next(ev.thread for ev in events if ev.name == "portbench.window")
    spans = set()
    for ev in events:
        h = owners.launcher(ev) if ev.on_device and not ev.annotation else None
        node = None if h is None else owners.node(h)
        if node is not None and "GatheredStatsBackward" in node.name:
            assert h.thread != main
            spans.add(owners.owner(h))
    assert spans == {"dgcnn.edgeconv"}
