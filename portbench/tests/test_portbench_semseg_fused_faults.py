"""The segmentation cell against the stacked conv's BN on running
statistics in training, planted in the form the program trains blocks of
MLP depth 2 in (``fused_mlp``, `dgcnn_tpu_torch.ops.edge.
edgeconv_block_fused_mlp`): BN2's batch statistics replaced by the
running ones, its running state left as it was. On the CPU at the tiny
size of `test_portbench_semseg_faults.py`, whose fault of the same name
patches the edge form's `batch_norm_apply`, which this form does not
call."""

from __future__ import annotations

import json
import os
import time

import pytest

from conftest import make_tiny_root
from portbench import harness

CELL = "train-semseg-f32-4k-b32"
TINY = {"edge_filters": [16, 16, 16], "block_convs": [2, 2, 1], "k": 8, "head_feat_dim": 32,
        "head_mlp": [16]}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_tiny_root(str(tmp_path_factory.mktemp("semseg_fused")))
    path = os.path.join(root, "portbench", "configs", "dgcnn-semseg-f32.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["model"].update(TINY)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return root


def _run(root, seed=2**31 + 29):
    cell = harness.load_cell(CELL, root)
    return harness.run(cell, seed, 0.5, False, "cpu", time.perf_counter())


def test_the_deep_blocks_train_in_the_fused_form(root):
    from dgcnn_tpu_torch.models import dgcnn as tdgcnn

    before = dict(tdgcnn.block_forms)
    out = _run(root)
    assert out["correct"], out["checks"]
    assert tdgcnn.block_forms["fused_mlp"] > before["fused_mlp"]


def test_running_bn_in_the_fused_stacked_conv_is_not_correct(root, monkeypatch):
    from dgcnn_tpu_torch.ops import edge as edge_ops

    apply, finalize = edge_ops.EdgeMLP.apply, edge_ops.finalize_batch_stats
    after_mlp = [False]

    def marked(*args):
        after_mlp[0] = True
        return apply(*args)

    def running(count, s1, s2, state, **kw):
        if after_mlp[0]:  # BN2 of a fused_mlp block
            after_mlp[0] = False
            return state["mean"], state["var"], state
        return finalize(count, s1, s2, state, **kw)

    monkeypatch.setattr(edge_ops.EdgeMLP, "apply", marked)
    monkeypatch.setattr(edge_ops, "finalize_batch_stats", running)
    out = _run(root)
    assert not out["correct"], out["checks"]
