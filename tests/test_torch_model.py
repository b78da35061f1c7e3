"""The port's eval-mode model against the JAX model, on bridged JAX
parameters, at atol 2e-5 (the frozen-oracle tolerance).

BN running statistics come from a JAX train-mode apply and the BN scales
get mixed signs, so every branch of the eval reduction is live. Inputs are
numpy-seeded, with a ragged mask that includes an empty event.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.models import ModelSpec as JaxSpec
from dgcnn_tpu.models import get_model as jax_get_model
from dgcnn_tpu_torch.bridge import params_from_numpy, tree_leaves, tree_map
from dgcnn_tpu_torch.models import ModelSpec, get_model
from dgcnn_tpu_torch.models import dgcnn as tdgcnn
from dgcnn_tpu_torch.models import head as thead

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "frozen_oracle.npz")
SMALL = dict(num_class=3, k=10, edge_filters=(16, 24, 24), head_feat_dim=40, head_mlp=(32, 16))


def _inputs(seed, b=3, n=128, f=4, nvalid=(128, 70, 0)):
    rng = np.random.RandomState(seed)
    pts = rng.randn(b, n, f).astype(np.float32)
    mask = np.arange(n)[None] < np.asarray(nvalid)[:, None]
    return pts, mask


def _jax_params(name, spec_kw, pts, mask, seed=0):
    """JAX init, BN stats from one train-mode apply, BN scales of mixed sign.
    The statistics come from the default block form (the slot-loop fused
    one, quick to trace); the state tree is the same for every form."""
    model = jax_get_model(name, JaxSpec(**spec_kw))
    params, state = model.init(jax.random.PRNGKey(seed), pts.shape[-1])
    stats_model = jax_get_model(name, JaxSpec(**dict(spec_kw, block_impl="auto")))
    _, state = stats_model.apply(
        params, state, jnp.asarray(pts), jnp.asarray(mask), train=True
    )
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    rng = np.random.RandomState(seed + 1)
    for blk in params["blocks"] + [params["head"]["feat"]] + params["head"]["mlp"]:
        d = blk["bn"]["scale"].shape[0]
        blk["bn"]["scale"] = (rng.uniform(0.3, 1.5, d) * rng.choice([-1.0, 1.0], d)).astype(np.float32)
        blk["bn"]["bias"] = (rng.randn(d) * 0.2).astype(np.float32)
    return model, params, state


CASES = {
    "residual": ("residual-dgcnn", dict()),
    "plain": ("dgcnn", dict()),
    "knn_every3": ("residual-dgcnn", dict(knn_every=3)),
    "head_factorized": ("residual-dgcnn", dict(head_factorized=True)),
    "edge_form": ("residual-dgcnn", dict(block_impl="edge")),
    "fused_form_plain": ("dgcnn", dict(block_impl="fused", knn_every=2)),
    "no_global_pool": ("dgcnn", dict(global_pool=False)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_logits_match_jax(case):
    name, extra = CASES[case]
    spec_kw = {**SMALL, **extra}
    pts, mask = _inputs(7)
    jmodel, params, state = _jax_params(name, spec_kw, pts, mask)
    want, _ = jax.jit(lambda p, s, x, m: jmodel.apply(p, s, x, m, train=False))(
        params, state, jnp.asarray(pts), jnp.asarray(mask)
    )
    model = get_model(name, ModelSpec(**spec_kw))
    tp, ts = params_from_numpy(params, state)
    got, st_out = model(tp, ts, torch.tensor(pts), torch.tensor(mask))
    assert got.dtype == torch.float32 and got.shape == (3, 128, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    assert st_out is ts  # eval leaves the BN state as it was


def test_frozen_oracle_eval_logits():
    """Reproduce `tests/fixtures/frozen_oracle.npz`'s eval logits from the
    JAX init at PRNGKey(1234) and the BN state of its train-mode apply."""
    data = np.load(FIXTURE)
    spec_kw = dict(num_class=3, k=10, edge_filters=(16, 24), head_feat_dim=48, head_mlp=(32,))
    jmodel = jax_get_model("residual-dgcnn", JaxSpec(**spec_kw))
    params, state = jmodel.init(jax.random.PRNGKey(1234), 4)
    _, st = jmodel.apply(
        params, state, jnp.asarray(data["points"]), jnp.asarray(data["mask"]), train=True
    )
    tp, ts = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, st)
    )
    model = get_model("residual-dgcnn", ModelSpec(**spec_kw))
    got, _ = model(tp, ts, torch.tensor(data["points"]), torch.tensor(data["mask"]))
    np.testing.assert_allclose(got.numpy(), data["logits_eval"], atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", ["dgcnn", "residual-dgcnn"])
def test_init_tree_matches_jax(name):
    """Same tree, same shapes, glorot-bounded weights, identity BN."""
    spec_kw = dict(SMALL, edge_filters=(8, 16, 16))
    jp, js = jax_get_model(name, JaxSpec(**spec_kw)).init(jax.random.PRNGKey(0), 4)
    tp, ts = get_model(name, ModelSpec(**spec_kw)).init(4, torch.Generator().manual_seed(0))
    j_shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), (jp, js))
    t_shapes = tree_map(lambda t: tuple(t.shape), (tp, ts))
    assert jax.tree_util.tree_structure(j_shapes) == jax.tree_util.tree_structure(
        tuple(t_shapes)
    )
    assert jax.tree_util.tree_leaves(j_shapes) == jax.tree_util.tree_leaves(tuple(t_shapes))
    w = tp["blocks"][0]["w"]
    assert float(w.abs().max()) <= np.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    assert torch.equal(ts["blocks"][0]["var"], torch.ones(8))


def test_masked_max_points_empty_event_gives_zeros():
    x = torch.randn(2, 5, 3) - 10.0
    mask = torch.tensor([[True, False, True, False, False], [False] * 5])
    y = tdgcnn._masked_max_points(x, mask)
    assert torch.equal(y[1], torch.zeros(3))
    assert torch.equal(y[0], torch.maximum(x[0, 0], x[0, 2]))


def test_padding_does_not_change_valid_logits():
    """Garbage in padded rows never changes the valid points' logits."""
    pts, mask = _inputs(8, nvalid=(128, 60, 5))
    _, params, state = _jax_params("residual-dgcnn", SMALL, pts, mask)
    model = get_model("residual-dgcnn", ModelSpec(**SMALL))
    tp, ts = params_from_numpy(params, state)
    a, _ = model(tp, ts, torch.tensor(pts), torch.tensor(mask))
    noisy = pts.copy()
    noisy[~mask] = 1e3 * np.random.RandomState(9).randn(int((~mask).sum()), 4)
    b, _ = model(tp, ts, torch.tensor(noisy), torch.tensor(mask))
    assert torch.equal(a[torch.tensor(mask)], b[torch.tensor(mask)])


@pytest.mark.parametrize(
    "kw,item",
    [
        (dict(head_stream="on"), "item 11"),
    ],
)
def test_unported_options_raise(kw, item):
    """(The name is kept from when these options raised their item.) The
    streamed head, which refused to train until the long-event train slice
    (``item``), trains: finite logits and gradients, and a new head state
    (stacked per-edge convs: `tests/test_torch_train_model.py`; bf16 and
    remat: `test_precision_and_memory_options_train`)."""
    model = get_model("residual-dgcnn", ModelSpec(**{**SMALL, **kw}))
    params, state = model.init(4, torch.Generator().manual_seed(0))
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    runs = thead.runs
    logits, new_state = model(params, state, torch.randn(1, 32, 4), train=True)
    grads = torch.autograd.grad(logits.sum(), leaves)
    assert thead.runs == runs + 1 and bool(torch.isfinite(logits).all())
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert not torch.equal(new_state["head"]["feat"]["mean"], state["head"]["feat"]["mean"])


@pytest.mark.parametrize("kw", [dict(compute_dtype="bfloat16"), dict(remat=True)],
                         ids=["bf16", "remat"])
def test_precision_and_memory_options_train(kw):
    """bf16 and remat, which raised ROADMAP item 10 until the
    mixed-precision slice, build, serve and train: f32 logits, finite
    gradients into the f32 parameters (held against the JAX package by
    `tests/test_torch_precision.py`)."""
    model = get_model("residual-dgcnn", ModelSpec(**{**SMALL, **kw}))
    params, state = model.init(4, torch.Generator().manual_seed(0))
    x = torch.randn(1, 32, 4, generator=torch.Generator().manual_seed(1))
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    logits, _ = model(params, state, x, train=True)
    grads = torch.autograd.grad(logits.sum(), leaves)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in grads)
    with torch.no_grad():
        served, _ = model(params, state, x)
    assert served.dtype == torch.float32 and served.shape == logits.shape


@pytest.mark.parametrize("kw", [dict(knn_window=64), dict(head_stream="on")],
                         ids=["knn_window", "head_stream_on"])
def test_long_event_options_serve(kw):
    """The banded kNN and the streamed head, which raised before the
    long-event slice, now serve: ``head_stream="on"`` gives the dense
    head's logits bit for bit, and ``knn_window`` wider than the event
    gives the exact model's."""
    pts, mask = _inputs(11)
    _, params, state = _jax_params("residual-dgcnn", SMALL, pts, mask)
    tp, ts = params_from_numpy(params, state)
    exact = get_model("residual-dgcnn", ModelSpec(**SMALL))
    want, _ = exact(tp, ts, torch.tensor(pts), torch.tensor(mask))
    got, _ = get_model("residual-dgcnn", ModelSpec(**{**SMALL, **kw}))(
        tp, ts, torch.tensor(pts), torch.tensor(mask)
    )
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    if "head_stream" in kw:
        assert torch.equal(got, want)
    wide = get_model("residual-dgcnn", ModelSpec(**{**SMALL, **kw, "knn_window": 128}))
    m = torch.tensor(mask)
    np.testing.assert_allclose(
        wide(tp, ts, torch.tensor(pts), m)[0][m].numpy(), want[m].numpy(), atol=2e-5, rtol=0
    )


def test_train_mode_and_streamed_head_raise(monkeypatch):
    """Train mode runs on one device and under context parallelism (it
    raised "item 13" before the CP training slice; the name is kept): a
    model on one shard's CP graph ops trains and gives the plain model's
    train forward; the streamed head trains (it raised "item 11" before
    the long-event train slice). The automatic streamed head engages at
    rows * head_feat_dim >= the line and gives ``head_stream="on"``'s
    logits."""
    from dgcnn_tpu_torch.parallel.context_parallel import cp_graph_ops
    from dgcnn_tpu_torch.parallel.mesh import PointGroup

    model = get_model("residual-dgcnn", ModelSpec(**SMALL))
    params, state = model.init(4, torch.Generator().manual_seed(0))
    pts = torch.randn(1, 32, 4)
    logits, new_state = model(params, state, pts, train=True)
    assert logits.shape == (1, 32, 3) and new_state is not state
    solo = PointGroup(rank=0, size=1, device=torch.device("cpu"), backend="gloo",
                      stage_host=False)
    ops = cp_graph_ops(solo, impl="ppermute")
    cp = get_model("residual-dgcnn", ModelSpec(**SMALL), knn_fn=ops.knn, gather_fn=ops.gather,
                   pool_fn=ops.pool, gather_extend_fn=ops.extend,
                   gather_localize_fn=ops.localize)
    cp_logits, cp_state = cp(params, state, pts, train=True)
    assert torch.equal(cp_logits, logits)
    for a, b in zip(tree_leaves(cp_state), tree_leaves(new_state)):
        assert torch.equal(a, b)
    runs = thead.runs
    off = get_model("residual-dgcnn", ModelSpec(**SMALL, head_stream="off"))
    dense, _ = off(params, state, pts)
    auto_below, _ = model(params, state, pts)
    assert thead.runs == runs and torch.equal(auto_below, dense)
    monkeypatch.setattr(thead, "HEAD_STREAM_ELEMS", 32 * SMALL["head_feat_dim"])
    auto, _ = model(params, state, pts)
    assert thead.runs == runs + 1
    on = get_model("residual-dgcnn", ModelSpec(**SMALL, head_stream="on"))
    assert torch.equal(auto, on(params, state, pts)[0])
    assert auto.shape == (1, 32, 3)
    np.testing.assert_allclose(auto.numpy(), dense.numpy(), atol=1e-6, rtol=0)
    # the streamed head trains (it raised "item 11" before the long-event
    # train slice): the dense train head's logits and head state within
    # the sums' reassociation
    got, got_state = model(params, state, pts, train=True)
    assert thead.runs == runs + 3
    want, want_state = off(params, state, pts, train=True)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-5, rtol=0)
    for a, b in zip(tree_leaves(got_state["head"]), tree_leaves(want_state["head"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_edge_form_slot_stream_still_raises(monkeypatch):
    """(The name is kept from before the edge form's slot stream was
    ported, when it raised "item 11".) Past EDGE_EVAL_STREAM_ELEMS the
    edge form's eval streams one slot at a time: the logits equal the
    dense edge eval's bit for bit in f32, with stacked convs too
    (`tests/test_torch_long_train.py` holds it against the JAX stream)."""
    for kw in (dict(block_impl="edge"), dict(block_convs=2)):
        model = get_model("residual-dgcnn", ModelSpec(**SMALL, **kw))
        params, state = model.init(4, torch.Generator().manual_seed(0))
        x = torch.randn(1, 32, 4, generator=torch.Generator().manual_seed(1))
        mask = torch.arange(32)[None] < 27
        monkeypatch.setattr(tdgcnn, "EDGE_EVAL_STREAM_ELEMS", 2**31)
        dense, _ = model(params, state, x, mask)
        monkeypatch.setattr(tdgcnn, "EDGE_EVAL_STREAM_ELEMS", 32 * SMALL["k"])
        streamed, _ = model(params, state, x, mask)
        assert torch.equal(streamed, dense)


BANDED_CASES = {
    "residual_w64": ("residual-dgcnn", dict(knn_window=64)),
    "plain_w64_every2": ("dgcnn", dict(knn_window=64, knn_every=2)),
    "residual_w64_stream": ("residual-dgcnn", dict(knn_window=64, head_stream="on")),
    "plain_wide_window_stream": ("dgcnn", dict(knn_window=512, head_stream="on")),
    "residual_wide_window_every2": ("residual-dgcnn", dict(knn_window=128, knn_every=2)),
    "residual_w64_stream_factorized": (
        "residual-dgcnn", dict(knn_window=64, head_stream="on", head_factorized=True)
    ),
}


@pytest.mark.parametrize("case", sorted(BANDED_CASES))
def test_banded_eval_logits_match_jax(case):
    """The banded model (Morton sort, banded oracle, exit unpermute) on
    bridged JAX parameters, ragged masks with an empty event."""
    name, extra = BANDED_CASES[case]
    spec_kw = {**SMALL, **extra}
    pts, mask = _inputs(13, nvalid=(128, 90, 0))
    jmodel, params, state = _jax_params(name, spec_kw, pts, mask)
    want, _ = jax.jit(lambda p, s, x, m: jmodel.apply(p, s, x, m, train=False))(
        params, state, jnp.asarray(pts), jnp.asarray(mask)
    )
    tp, ts = params_from_numpy(params, state)
    got, _ = get_model(name, ModelSpec(**spec_kw))(tp, ts, torch.tensor(pts), torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_bad_knob_values_raise():
    for kw in (dict(block_impl="nope"), dict(head_stream="x")):
        with pytest.raises(ValueError):
            get_model("dgcnn", ModelSpec(**{**SMALL, **kw}))
    assert dataclasses.replace(ModelSpec(), k=5).num_edge_conv == 6
