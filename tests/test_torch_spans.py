"""The port's spans (`dgcnn_tpu_torch.utils.timing.span`) on the CPU: each
layer boundary opens its ``dgcnn.*`` range once a call (a block's once a
block) under `torch.profiler`, none is built without a profiler, the
autograd sequence numbers carry the EdgeConv backward back to
``dgcnn.edgeconv``, the command line's
``--profile_dir`` trace holds them, and an exported artifact holds no
profiler node."""

import collections
import glob
import io
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dgcnn_tpu_torch import cli
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO, prefetch
from dgcnn_tpu_torch.train import export as texport
from dgcnn_tpu_torch.train.trainval import Trainval
from dgcnn_tpu_torch.utils import timing

SMALL = dict(model_name="residual-dgcnn", num_class=2, kvalue=6, edge_filters=(12, 12, 12),
             head_feat_dim=24, head_mlp=(16,), minibatch_size=2, num_point=128)
BLOCKS = len(SMALL["edge_filters"])
TRAIN = {"dgcnn.train_step": 1, "dgcnn.put_batch": 1, "dgcnn.graph": BLOCKS,
         "dgcnn.edgeconv": BLOCKS, "dgcnn.head": 1, "dgcnn.loss": 1, "dgcnn.backward": 1,
         "dgcnn.optimizer": 1, "dgcnn.outputs": 1}
EVAL = {"dgcnn.inference": 1, "dgcnn.put_batch": 1, "dgcnn.graph": BLOCKS,
        "dgcnn.edgeconv": BLOCKS, "dgcnn.head": 1, "dgcnn.outputs": 1}
# the fused block's backward is its custom function's; the edge form's
# runs through the neighbour gather
EDGE_BACKWARD = {"fused": "GatheredStatsBackward", "edge": "GatherBackward0"}
BACKWARD = "autograd::engine::evaluate_function: "


def _trainer(**kw):
    tv = Trainval(Config(**{**SMALL, **kw}), device="cpu")
    return tv, tv.initialize(4, generator=torch.Generator().manual_seed(0))


def _batch():
    src = SyntheticIO(num_events=2, num_point=SMALL["num_point"], seed=3).initialize()
    return next(iter(BucketBatcher(src, 2, buckets=(SMALL["num_point"],),
                                   shuffle=False).epoch()))


def _counts(prof):
    return collections.Counter(e.name for e in prof.events() if e.name.startswith("dgcnn."))


@pytest.mark.parametrize("form", [
    dict(block_impl="fused"), dict(block_impl="reduced"), dict(block_impl="edge"),
    dict(head_stream="on"),
])
def test_each_span_opens_once_a_call(form):
    """Each span of a train step and of a served batch, once a call and the
    graph build's and the block's once a block, whatever the block's form
    or the head's."""
    tv, state = _trainer(**form)
    batch = _batch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = tv.train_step(state, batch)
    assert _counts(prof) == TRAIN
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tv.inference_packed(state, batch)
    assert _counts(prof) == EVAL


def test_the_prefetch_wait_is_a_span():
    """The consumer's wait on the prefetch queue, once an item taken."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert list(prefetch(iter(range(3)), 2)) == [0, 1, 2]
    # the three items and the end of the stream
    assert _counts(prof) == {"dgcnn.batch_wait": 4}


def test_no_profiler_builds_no_range(monkeypatch):
    """Without a profiler `span` returns its one reused no-op and never
    builds a ``record_function``; under one it builds one a span."""
    made = []
    real = torch.profiler.record_function

    def counting(name, *args):
        made.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    tv, state = _trainer()
    batch = _batch()
    state, _ = tv.train_step(state, batch)
    tv.inference_packed(state, batch)
    assert made == [] and timing.span("dgcnn.x") is timing.span("dgcnn.y")
    with profile(activities=[ProfilerActivity.CPU]):
        tv.inference_packed(state, batch)
    assert collections.Counter(made) == EVAL


@pytest.mark.parametrize("impl", sorted(EDGE_BACKWARD))
def test_the_edgeconv_backward_lands_in_its_block(impl):
    """The sequence-number rule: each backward node's sequence number was
    made, in the forward, inside one span, and the EdgeConv backward's
    nodes lead to ``dgcnn.edgeconv`` (once a block), the loss's to
    ``dgcnn.loss``; every node leads to a span of the model or the loss."""
    tv, state = _trainer(block_impl=impl)
    batch = _batch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tv.train_step(state, batch)
    events = prof.events()
    (backward,) = [e.time_range.start for e in events if e.name == "dgcnn.backward"]
    spans = [e for e in events if e.name.startswith("dgcnn.")]
    made = {}  # (thread, sequence number) -> the last forward event to carry it
    for e in events:
        if 0 <= e.sequence_nr and e.time_range.start < backward:
            key = (e.thread, e.sequence_nr)
            made[key] = max(made.get(key, e.time_range.start), e.time_range.start)

    def innermost(thread, t):
        inside = [sp for sp in spans if sp.thread == thread
                  and sp.time_range.start <= t <= sp.time_range.end]
        return max(inside, key=lambda sp: sp.time_range.start).name if inside else None

    nodes = [(e.name[len(BACKWARD):], innermost(e.fwd_thread, made[e.fwd_thread, e.sequence_nr]))
             for e in events if e.name.startswith(BACKWARD) and (e.fwd_thread, e.sequence_nr) in made]
    edge = collections.Counter(owner for name, owner in nodes if name == EDGE_BACKWARD[impl])
    # the loss's gather of the labels' log-probabilities is a GatherBackward0 too
    assert edge == {"dgcnn.edgeconv": BLOCKS, **({"dgcnn.loss": 1} if impl == "edge" else {})}
    assert [owner for name, owner in nodes if name == "LogSoftmaxBackward0"] == ["dgcnn.loss"]
    assert {owner for _, owner in nodes} == {"dgcnn.edgeconv", "dgcnn.head", "dgcnn.loss"}


def test_profile_dir_trace_holds_the_spans(tmp_path):
    """``train --profile_dir`` writes a Chrome trace with the program's
    spans of every step."""
    prof = tmp_path / "prof"
    argv = ["train", "-io", "synthetic", "-mb", "2", "-np", "128", "-k", "6",
            "--edge_filters", "8", "8", "--head_feat_dim", "16", "--head_mlp", "16",
            "-i", "2", "-rs", "1", "-cs", "0", "-wp", str(tmp_path / "w/s"),
            "-ld", str(tmp_path / "log"), "--profile_dir", str(prof)]
    assert cli.main(argv, device="cpu") == 0
    (path,) = glob.glob(str(prof / "trace-*.json"))
    with open(path) as f:
        names = collections.Counter(e.get("name") for e in json.load(f)["traceEvents"])
    assert names["dgcnn.train_step"] == 2 and names["dgcnn.edgeconv"] == 4
    assert {"dgcnn.put_batch", "dgcnn.graph", "dgcnn.head", "dgcnn.loss", "dgcnn.backward",
            "dgcnn.optimizer", "dgcnn.outputs", "dgcnn.batch_wait"} <= set(names)


@pytest.mark.parametrize("batch", [2, 0])
def test_an_export_holds_no_profiler_node(batch):
    """The serving artifact, at a fixed and a symbolic batch, calls no
    profiler operator: a span is a no-op while nothing records."""
    cfg = Config(**{**SMALL, "use_pallas": False})
    _, state = _trainer()
    ep = torch.export.load(io.BytesIO(texport.export_model(cfg, state, batch=batch,
                                                           device="cpu")))
    nodes = [str(n.target) for gm in ep.graph_module.modules()
             if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes]
    assert nodes and not [t for t in nodes if "profiler" in t or "record_function" in t]
    pts = torch.tensor(np.random.RandomState(0).randn(2, SMALL["num_point"], 4),
                       dtype=torch.float32)
    assert ep.module()(pts, torch.ones(2, SMALL["num_point"], dtype=torch.bool)).shape == (
        2, SMALL["num_point"], 2)
