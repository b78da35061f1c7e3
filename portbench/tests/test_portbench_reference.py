"""The plain reference against the program's CPU path on the same
weights and events, at a tiny size; that a seeded reference computes the
bits it computed before it moved into its network's package; and that no
network's package imports anything of the program or of JAX."""

from __future__ import annotations

import ast
import hashlib
import os

import numpy as np
import pytest
import torch

from portbench import events, flops, tree
from portbench.networks.residual_dgcnn import Reference, make_weights
from portbench.networks.residual_dgcnn import reference as ref_model
from portbench.tree import flatten

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
    params, state = make_weights(MODEL, seed, "cpu")
    points, labels = _event(seed)
    tv = _port(train=False)
    st = tv.with_params(params, state)
    packed, _ = tv.inference_packed(st, (points.numpy(), labels.numpy(), None,
                                         np.ones(labels.shape, bool)))
    ref = Reference(MODEL).log_probs(params, state, points[0])
    assert torch.allclose(packed[0, :, :2], ref.exp(), atol=2e-6)


@pytest.mark.parametrize("seed", [5, 6])
def test_train_step_matches_the_program(seed):
    params, state = make_weights(MODEL, seed, "cpu")
    start = {n: t.clone() for n, t in flatten(params)}
    points, labels = _event(seed)
    tv = _port(train=True)
    st = tv.with_params(params, state)
    batch = (points.numpy(), labels.numpy(), None, np.ones(labels.shape, bool))
    st, m = tv.train_step(st, batch)
    out = Reference(MODEL).train(
        {k: v for k, v in make_weights(MODEL, seed, "cpu")[0].items()}, state,
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
    params, state = make_weights(MODEL, 9, "cpu")
    points, _ = _event(9)
    base = Reference(MODEL).log_probs(params, state, points[0])
    low = Reference(MODEL, matmul="tf32").log_probs(params, state, points[0])
    gap = float((low - base).abs().max())
    assert 0 < gap < float("inf")


def _digest(*trees) -> str:
    h = hashlib.sha256()
    for t in trees:
        for name, leaf in flatten(t):
            h.update(name.encode())
            h.update(leaf.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_seeded_reference_is_the_bits_it_was_before_it_moved(one_thread):
    """Recorded from ``portbench.reference`` and ``portbench.weights``
    before the network package, on this CPU with one thread: the weights,
    an eval forward's log-probabilities, and two Adam steps' losses,
    first gradient and change."""
    params, state = make_weights(MODEL, 2**31 + 7, "cpu")
    assert _digest(params, state) == (
        "90dded531201bdcedad58bb07189691251d5a4938ee4d3d38e00e48a7e1b1653")
    ev = events.make_event(events.rng_for(2**31 + 7), 384)
    ev2 = events.make_event(events.rng_for(2**31 + 8), 384)
    points = torch.as_tensor(ev.points)
    lp = Reference(MODEL).log_probs(params, state, points)
    assert _digest({"": lp}) == "606c56c9a76ac0d83cb0d9f433c4a804caffd10502609502774725da9468e630"
    batches = [(points[None], torch.as_tensor(ev.labels).long()[None]),
               (torch.as_tensor(ev2.points)[None], torch.as_tensor(ev2.labels).long()[None])]
    out = Reference(MODEL).train(params, state, batches, 1e-3)
    assert out["loss"] == [0.8928415179252625, 0.6808032393455505]
    assert _digest(out["grad1"]) == (
        "e08069072f84fe61a94774c6af531c570387ded9bf3e9699f70db64227403474")
    assert _digest(out["change"]) == (
        "b6030c0944c35536a9603116e3ba000e3ccaf7f5d6460d45a6dfac8a00e903a4")


def _imports(path):
    """The modules ``path`` imports; ``"."`` for one of its own package."""
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "." if node.level else node.module


def test_the_reference_imports_neither_the_program_nor_jax():
    """Every network's package, and the benchmark's modules they import."""
    networks = os.path.dirname(os.path.dirname(ref_model.__file__))
    files = [os.path.join(d, f) for d, _, fs in os.walk(networks) for f in fs
             if f.endswith(".py")] + [tree.__file__, flops.__file__]
    assert len(files) >= 7
    banned = {"dgcnn_tpu_torch", "dgcnn_tpu", "jax", "jaxlib", "flax", "optax"}
    for f in files:
        mods = set(_imports(f))
        tops = {m.split(".", 1)[0] for m in mods if m != "."}
        assert not tops & banned, (f, tops & banned)
        assert tops <= {"__future__", "math", "torch", "portbench"}, (f, tops)
        assert {m for m in mods if m.startswith("portbench")} <= {
            "portbench", "portbench.tree", "portbench.flops"}, (f, mods)
