"""The plain reference against the program's CPU path on the same
weights and events, at a tiny size; and that the reference imports
nothing of the program or of JAX."""

from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

from portbench import events, weights
from portbench.reference import Reference, flatten
from portbench.reference import model as ref_model

MODEL = {"name": "residual-dgcnn", "num_class": 2, "k": 8, "in_dim": 4,
         "edge_filters": [16, 16, 16], "residual": True, "head_feat_dim": 32,
         "head_mlp": [24, 16], "bn_momentum": 0.9}


def _port(train: bool):
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.train.trainval import Trainval

    cfg = Config(model_name="residual-dgcnn", num_class=2, kvalue=8, edge_filters=(16, 16, 16),
                 head_feat_dim=32, head_mlp=(24, 16), minibatch_size=1, num_point=384,
                 optimizer="adam", learning_rate=1e-3, num_devices=1)
    return Trainval(cfg, device="cpu")


def _event(seed, n=384):
    ev = events.make_event(events.rng_for(seed), n)
    return torch.as_tensor(ev.points)[None], torch.as_tensor(ev.labels).long()[None]


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_eval_scores_match_the_program(seed):
    params, state = weights.make(MODEL, seed, "cpu")
    points, labels = _event(seed)
    tv = _port(train=False)
    st = tv.with_params(params, state)
    packed, _ = tv.inference_packed(st, (points.numpy(), labels.numpy(), None,
                                         np.ones(labels.shape, bool)))
    ref = Reference(MODEL).log_probs(params, state, points[0])
    assert torch.allclose(packed[0, :, :2], ref.exp(), atol=2e-6)


@pytest.mark.parametrize("seed", [5, 6])
def test_train_step_matches_the_program(seed):
    params, state = weights.make(MODEL, seed, "cpu")
    start = {n: t.clone() for n, t in flatten(params)}
    points, labels = _event(seed)
    tv = _port(train=True)
    st = tv.with_params(params, state)
    batch = (points.numpy(), labels.numpy(), None, np.ones(labels.shape, bool))
    st, m = tv.train_step(st, batch)
    out = Reference(MODEL).train(
        {k: v for k, v in weights.make(MODEL, seed, "cpu")[0].items()}, state,
        [(points, labels)], 1e-3)
    assert abs(float(m["loss"]) - out["loss"][0]) <= 1e-6 * abs(out["loss"][0])
    median = float(np.median([float(g.norm()) for g in out["grad1"].values()]))
    for (name, mu), (_, p) in zip(zip(out["grad1"], st.opt_state["mu"]), flatten(st.params)):
        g = out["grad1"][name]
        tol = 1e-5 * max(float(g.norm()), median)
        assert float((mu / 0.1 - g).norm()) <= tol, name
        # an element whose gradient is nought to rounding moves by round-off
        moving = g.abs() >= 1e-4
        assert torch.allclose((p - start[name])[moving], out["change"][name][moving],
                              atol=1e-6), name


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -(1.0 + 2.0**-12)])
    got = ref_model._round(x, "tf32")
    assert got.tolist() == [1.0 + 2.0**-10, 1.0, 1.0 + 2 * 2.0**-10, -1.0]


def test_lower_precisions_change_the_reference():
    params, state = weights.make(MODEL, 9, "cpu")
    points, _ = _event(9)
    base = Reference(MODEL).log_probs(params, state, points[0])
    low = Reference(MODEL, matmul="tf32").log_probs(params, state, points[0])
    gap = float((low - base).abs().max())
    assert 0 < gap < float("inf")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_the_reference_imports_neither_the_program_nor_jax():
    folder = os.path.dirname(ref_model.__file__)
    banned = {"dgcnn_tpu_torch", "dgcnn_tpu", "jax", "jaxlib", "flax", "optax"}
    for f in os.listdir(folder):
        if f.endswith(".py"):
            tops = {m.split(".", 1)[0] for m in _imports(os.path.join(folder, f))}
            assert not tops & banned, (f, tops & banned)
            assert tops <= {"__future__", "torch", "portbench"}, (f, tops)
