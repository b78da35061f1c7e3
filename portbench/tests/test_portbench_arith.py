"""The benchmark's generator and work arithmetic: the frozen generator
draws what the program's does, the graph build's bound reproduces the
bound column of PERF.md's kernel table, the residual network's work count
and weights are the numbers and bits they were before they moved into
its package, and the weights have the tree the program builds."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from portbench import events, flops
from portbench.networks import residual_dgcnn as net
from portbench.tree import flatten

FLAGSHIP = {"name": "residual-dgcnn", "num_class": 2, "k": 20, "in_dim": 4,
            "edge_filters": [64] * 6, "residual": True, "head_feat_dim": 1024,
            "head_mlp": [512, 256], "bn_momentum": 0.9}


def test_a_fixed_length_pool_is_what_the_program_generates():
    from dgcnn_tpu_torch.io import SyntheticIO

    seed = 2**31 + 5
    mix = {"pool": 5, "num_point": 1024, "variable_length": False, "num_class": 2}
    pool = events.event_pool(mix, seed)
    io = SyntheticIO(num_events=5, num_point=1024, seed=seed % 2**32,
                     variable_length=False).initialize()
    for i, ev in enumerate(pool):
        theirs = io.read_event(i)
        np.testing.assert_array_equal(ev.points, theirs.points)
        np.testing.assert_array_equal(ev.labels, theirs.labels)


def test_every_seed_brings_the_same_lengths():
    mix = {"pool": 64, "num_point": 4096, "variable_length": True, "num_class": 2}
    a, b = events.event_pool(mix, 1), events.event_pool(mix, 2**31 + 9)
    la, lb = [len(e) for e in a], [len(e) for e in b]
    assert sorted(la) == sorted(lb) and la != lb
    assert min(la) == 2048 and max(la) == 4096
    assert not np.array_equal(a[0].points[:10], b[0].points[:10])


def test_make_event_draws_as_the_program():
    from dgcnn_tpu_torch.io import make_event

    a = events.make_event(np.random.RandomState(7), 777, 3)
    b = make_event(np.random.RandomState(7), 777, 3)
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.labels, b.labels)


def test_knn_bound_reproduces_the_kernel_table():
    peak = flops.DATASHEET_FLOPS["float32"]
    # a served 4 x 4096 batch: the mean of one C=4 and five C=64 launches
    served = [flops.knn_bound_s([4096] * 4, 4096, c, 20, peak) for c in (4, 64, 64, 64, 64, 64)]
    assert round(1e3 * sum(served) / 6, 4) == 0.1102
    assert round(1e3 * flops.knn_bound_s([131072], 131072, 64, 20, peak), 4) == 33.3345
    assert round(1e3 * flops.knn_bound_s([131072], 131072, 4, 20, peak), 4) == 2.5642


def test_model_flops_of_a_train_step():
    peak = flops.DATASHEET_FLOPS["float32"]
    step, _ = net.work(FLAGSHIP, [131072], 131072, True, peak)
    assert 1.23e13 < step < 1.25e13
    serve, _ = net.work(FLAGSHIP, [3072] * 4, 4096, False, peak)
    assert serve < step / 100


# ``flops.model_flops`` and ``flops.knn_bound_step_s`` of the harness
# before the network package, at each cell's shapes (a train step of
# 131,072 points; a served batch of four events padded to 4,096)
PARENT_WORK = [
    ([131072], 131072, True, 12351185092608.0, 0.16923643378244776),
    ([2048, 3071, 4096, 3500], 4096, False, 60889882580.0, 0.00042034401850746267),
]


@pytest.mark.parametrize("valid,padded,train,ops,knn", PARENT_WORK)
def test_work_gives_the_numbers_of_the_harness_before_it(valid, padded, train, ops, knn):
    peak = flops.DATASHEET_FLOPS["float32"]
    assert net.work(FLAGSHIP, valid, padded, train, peak) == (ops, {"knn": knn})
    # one build a block: C=4 once, then C=64 five times (33.3345 and 2.5642 ms at 131,072)
    widths = [4] + [64] * 5
    assert knn == sum(flops.knn_bound_s(valid, padded, c, 20, peak) for c in widths)


def _digest(*trees) -> str:
    h = hashlib.sha256()
    for tree in trees:
        for name, t in flatten(tree):
            h.update(name.encode())
            h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def test_the_weights_are_the_bits_they_were_before_they_moved():
    # recorded from ``portbench.weights.make`` before the network package
    ours = net.make_weights(FLAGSHIP, 2**31 + 3, "cpu")
    assert _digest(*ours) == "4103d7ef4fb8ee6ad3027c1f156a67144f9236f575b911f0666536a6987685f3"


def test_weights_have_the_programs_tree():
    import torch

    from dgcnn_tpu_torch.models import get_model
    from dgcnn_tpu_torch.models.dgcnn import ModelSpec

    spec = ModelSpec(num_class=2, k=20, edge_filters=(64,) * 6, head_feat_dim=1024,
                     head_mlp=(512, 256))
    theirs = get_model("residual-dgcnn", spec).init(4, torch.Generator().manual_seed(0))
    ours = net.make_weights(FLAGSHIP, 2**31 + 3, "cpu")
    for a, b in zip(ours, theirs):
        assert [(n, tuple(t.shape)) for n, t in flatten(a)] == \
               [(n, tuple(t.shape)) for n, t in flatten(b)]
    again = net.make_weights(FLAGSHIP, 2**31 + 3, "cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(flatten(ours), flatten(again)))


@pytest.mark.parametrize("cell,units,ops,knn", [
    ("train-f32-131k", [[131072]] * 21, 259374886944768.0, 3.553965109431403),
    ("serve-f32-4k-b32", [[2048, 3071, 4096, 3500], [4096, 2500, 2049, 3333]] * 700,
     81922530118800.0, 0.5586988965850745),
])
def test_a_windows_work_is_what_the_harness_before_it_summed(cell, units, ops, knn):
    """`harness.window_work` over a window's steps or batches, against the
    sums of ``flops.model_flops`` and ``flops.knn_bound_step_s`` recorded
    from the harness before the network package: ``mfu.*`` and
    ``knn_roofline.*`` divide these by the same trace's times."""
    from portbench import harness

    assert harness.window_work(harness.load_cell(cell), units) == (ops, {"knn": knn})
