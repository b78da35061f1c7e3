"""The segmentation cell (``train-semseg-f32-4k-b32``) against planted
faults: a sound run is correct, and each fault of the network's own paths
(block 1 at depth 1, the stacked conv's BN on running statistics in
training, the pooled vector zeroed, half of the batch's events out of the
mean) and the control (the reference's matmuls in TF32 in the program's
place) read ``correct`` false under the cell's real limits. On the CPU at
a tiny size: widths 16, k=8, 32 events of 256 points a step.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import pytest
import torch

from conftest import make_tiny_root
from portbench import control, harness

CELL = "train-semseg-f32-4k-b32"
TINY = {"edge_filters": [16, 16, 16], "block_convs": [2, 2, 1], "k": 8, "head_feat_dim": 32,
        "head_mlp": [16]}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_tiny_root(str(tmp_path_factory.mktemp("semseg")))
    path = os.path.join(root, "portbench", "configs", "dgcnn-semseg-f32.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["model"].update(TINY)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return root


def _run(root, seed=2**31 + 17):
    cell = harness.load_cell(CELL, root)
    return harness.run(cell, seed, 0.5, False, "cpu", time.perf_counter())


def test_a_sound_run_is_correct(root):
    out = _run(root)
    assert out["correct"], out["checks"]


def _depth_one_block_one(orig):
    def block(self, x, idx, blk_p, blk_s, mask, train, bn_group=None):
        if x.shape[-1] != 4:  # blocks 2 and 3
            return orig(self, x, idx, blk_p, blk_s, mask, train, bn_group)
        shallow = {k: v for k, v in blk_p.items() if k != "extra"}
        y, s = orig(self, x, idx, shallow, blk_s["main"], mask, train, bn_group)
        # the stacked conv's parameters stay in the graph, with a zero gradient
        unused = sum(t.sum() for ep in blk_p["extra"] for t in (ep["w"], *ep["bn"].values()))
        return y + 0.0 * unused, {"main": s, "extra": blk_s["extra"]}

    return block


def _running_bn_in_the_stacked_convs(monkeypatch):
    from dgcnn_tpu_torch.models import dgcnn as tdgcnn

    inside = [False]
    span, bn = tdgcnn.span, tdgcnn.batch_norm_apply

    @contextlib.contextmanager
    def marked(name):
        inside[0] = name == "dgcnn.edge_mlp"
        with span(name):
            yield
        inside[0] = False

    def running(p, s, h, mask=None, **kw):
        if inside[0]:
            kw["train"] = False
        return bn(p, s, h, mask, **kw)

    monkeypatch.setattr(tdgcnn, "span", marked)
    monkeypatch.setattr(tdgcnn, "batch_norm_apply", running)


def _half_events(orig):
    def put(self, batch, with_pos=False):
        out = list(orig(self, batch, with_pos))
        out[2] = out[2].clone()
        out[2][out[2].shape[0] // 2:] = 0.0  # half of the batch's events out of the mean
        return tuple(out)

    return put


@pytest.mark.parametrize("fault", ["depth_one_block_one", "running_bn_in_the_stacked_convs",
                                   "pooled_vector_zeroed", "half_of_the_events"])
def test_a_broken_network_is_not_correct(root, monkeypatch, fault):
    from dgcnn_tpu_torch.models import dgcnn as tdgcnn
    from dgcnn_tpu_torch.train.trainval import Trainval

    if fault == "depth_one_block_one":
        monkeypatch.setattr(tdgcnn.Model, "_block", _depth_one_block_one(tdgcnn.Model._block))
    elif fault == "running_bn_in_the_stacked_convs":
        _running_bn_in_the_stacked_convs(monkeypatch)
    elif fault == "pooled_vector_zeroed":
        monkeypatch.setattr(tdgcnn, "_masked_max_points", lambda x, mask: 0.0 * x.amax(dim=-2))
    else:
        monkeypatch.setattr(Trainval, "_put_batch", _half_events(Trainval._put_batch))
    out = _run(root)
    assert not out["correct"], out["checks"]


def test_the_control_fails_the_limits(root):
    cell = harness.load_cell(CELL, root)
    got = dict(control.train_readings(cell, 23, torch.device("cpu"), True))
    limits = cell.limits
    assert all(v <= limits[n] for n, v in got["program"].items() if n in limits)
    assert any(v > limits[n] for n, v in got["control"].items() if n in limits)
