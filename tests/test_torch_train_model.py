"""The port's train-mode model against the JAX model, on bridged JAX
parameters.

- The frozen-oracle fixture's train logits and post-train eval logits are
  reproduced at atol 2e-5 from the JAX init at ``PRNGKey(1234)``, as
  `tests/test_frozen_oracle.py` pins them for the JAX package (the port
  builds its own graph: no near tie flips on this input).
- Every other case runs on a pinned graph: the JAX forward records the
  neighbour indices of each graph build and the port replays them, since
  batch statistics summed in another order can flip near-tie kNN choices.
  Train logits compare at atol 2e-5 and the new BN state at atol 1e-5;
  whole-model loss gradients at rtol 1e-4, with an absolute floor of 1e-6
  of the largest gradient entry of the model: a residual projection's bias
  feeds only train-mode BN layers, which cancel it, so its true gradient
  is zero and both packages give rounding noise of ~1e-8 there.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.models import ModelSpec as JaxSpec
from dgcnn_tpu.models import get_model as jax_get_model
from dgcnn_tpu.ops.knn import knn_indices as jax_knn
from dgcnn_tpu_torch.bridge import params_from_numpy, params_to_numpy, tree_leaves, tree_map
from dgcnn_tpu_torch.models import ModelSpec, get_model

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "frozen_oracle.npz")
SMALL = dict(num_class=3, k=8, edge_filters=(16, 24, 24), head_feat_dim=40, head_mlp=(32, 16))


def _inputs(seed, b=2, n=96, f=4, nvalid=(96, 41)):
    rng = np.random.RandomState(seed)
    pts = rng.randn(b, n, f).astype(np.float32)
    mask = np.arange(n)[None] < np.asarray(nvalid)[:, None]
    return pts, mask


class Pinned:
    """The JAX graph builds recorded once (`record`), replayed to the port
    (`replay`) in call order."""

    def __init__(self):
        self.graphs = []

    def record(self, x, k, mask):
        idx, valid = jax_knn(x, k, mask)
        self.graphs.append((np.asarray(idx), np.asarray(valid)))
        return idx, valid

    def replay(self):
        it = iter(self.graphs)

        def knn(x, k, mask):
            idx, valid = next(it)
            return torch.tensor(idx, device=x.device), torch.tensor(valid, device=x.device)

        return knn


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_model(spec_kw, pts, seed=0, knn_fn=None, name="residual-dgcnn"):
    model = jax_get_model(name, JaxSpec(**spec_kw), knn_fn=knn_fn)
    params, state = model.init(jax.random.PRNGKey(seed), pts.shape[-1])
    return model, params, state


def _assert_tree_close(got, want, atol):
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol, rtol=0)


@pytest.mark.parametrize("block_impl", ["auto", "reduced", "edge"])
def test_frozen_oracle_train_and_eval_logits(block_impl):
    data = np.load(FIXTURE)
    spec_kw = dict(num_class=3, k=10, edge_filters=(16, 24), head_feat_dim=48, head_mlp=(32,))
    _, params, state = _jax_model(spec_kw, data["points"], seed=1234)
    tp, ts = params_from_numpy(_np(params), _np(state))
    model = get_model("residual-dgcnn", ModelSpec(**spec_kw, block_impl=block_impl))
    pts, mask = torch.tensor(data["points"]), torch.tensor(data["mask"])
    logits_train, st = model(tp, ts, pts, mask, train=True)
    logits_eval, _ = model(tp, st, pts, mask)
    np.testing.assert_allclose(logits_train.detach().numpy(), data["logits_train"], atol=2e-5)
    np.testing.assert_allclose(logits_eval.detach().numpy(), data["logits_eval"], atol=2e-5)


CASES = {
    "fused": ("residual-dgcnn", dict(block_impl="fused")),
    "reduced": ("residual-dgcnn", dict(block_impl="reduced")),
    "edge": ("residual-dgcnn", dict(block_impl="edge")),
    "plain_dgcnn": ("dgcnn", dict()),
    "block_convs2": ("residual-dgcnn", dict(block_convs=2)),
    "block_convs3_plain": ("dgcnn", dict(block_convs=3, edge_filters=(16, 24))),
    "head_factorized": ("residual-dgcnn", dict(head_factorized=True)),
    "knn_every2": ("residual-dgcnn", dict(knn_every=2)),
    "no_global_pool": ("dgcnn", dict(global_pool=False)),
    "momentum_half": ("residual-dgcnn", dict(bn_momentum=0.5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_forward_matches_jax_on_pinned_graph(case):
    name, extra = CASES[case]
    spec_kw = {**SMALL, **extra}
    pts, mask = _inputs(3)
    pin = Pinned()
    jmodel, params, state = _jax_model(spec_kw, pts, knn_fn=pin.record, name=name)
    want, want_state = jmodel.apply(params, state, jnp.asarray(pts), jnp.asarray(mask), train=True)
    model = get_model(name, ModelSpec(**spec_kw), knn_fn=pin.replay())
    tp, ts = params_from_numpy(_np(params), _np(state))
    got, got_state = model(tp, ts, torch.tensor(pts), torch.tensor(mask), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=0)
    # the new state has the JAX tree's layout, leaf for leaf
    assert jax.tree_util.tree_structure(params_to_numpy(tp, got_state)[1]) == \
        jax.tree_util.tree_structure(_np(want_state))
    _assert_tree_close(params_to_numpy(tp, got_state)[1], _np(want_state), atol=1e-5)


@pytest.mark.parametrize("block_convs", [2, 3])
def test_stacked_convs_eval_matches_jax(block_convs):
    """``block_convs >= 2`` (the stacked per-edge convs, which raised before
    the training slice) in eval, BN statistics from one JAX train apply."""
    spec_kw = {**SMALL, "block_convs": block_convs}
    pts, mask = _inputs(4)
    jmodel, params, state = _jax_model(spec_kw, pts)
    _, state = jmodel.apply(params, state, jnp.asarray(pts), jnp.asarray(mask), train=True)
    want, _ = jmodel.apply(params, state, jnp.asarray(pts), jnp.asarray(mask), train=False)
    tp, ts = params_from_numpy(_np(params), _np(state))
    model = get_model("residual-dgcnn", ModelSpec(**spec_kw))
    got, st = model(tp, ts, torch.tensor(pts), torch.tensor(mask))
    assert st is ts
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    # the port's own init draws the same tree
    p2, s2 = model.init(4, torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_structure(params_to_numpy(p2, s2)) == \
        jax.tree_util.tree_structure((_np(params), _np(state)))


def _ce(logits, labels, mask, xp):
    """Masked mean cross entropy in numpy-like namespace ``xp``."""
    if xp is torch:
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels[..., None])[..., 0]
        w = mask.float()
        return -torch.sum(ll * w) / torch.clamp(torch.sum(w), min=1e-9)
    logp = jax.nn.log_softmax(logits, axis=-1)
    ll = jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0]
    w = mask.astype(jnp.float32)
    return -jnp.sum(ll * w) / jnp.maximum(jnp.sum(w), 1e-9)


@pytest.mark.parametrize("case", ["fused", "reduced", "edge", "block_convs2", "head_factorized"])
def test_loss_gradients_match_jax_grad(case):
    name, extra = CASES[case]
    spec_kw = {**SMALL, **extra}
    pts, mask = _inputs(5)
    labels = np.random.RandomState(6).randint(0, 3, mask.shape).astype(np.int32)
    pin = Pinned()
    jmodel, params, state = _jax_model(spec_kw, pts, knn_fn=pin.record, name=name)

    def jloss(p):
        logits, _ = jmodel.apply(p, state, jnp.asarray(pts), jnp.asarray(mask), train=True)
        return _ce(logits, jnp.asarray(labels), jnp.asarray(mask), jnp)

    want = _np(jax.grad(jloss)(params))
    model = get_model(name, ModelSpec(**spec_kw), knn_fn=pin.replay())
    tp, ts = params_from_numpy(_np(params), _np(state))
    live = tree_map(lambda t: t.requires_grad_(True), tp)
    logits, _ = model(live, ts, torch.tensor(pts), torch.tensor(mask), train=True)
    loss = _ce(logits, torch.tensor(labels).long(), torch.tensor(mask), torch)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    want_leaves = tree_leaves(want)
    assert len(grads) == len(want_leaves)
    floor = 1e-6 * max(float(np.abs(w).max()) for w in want_leaves)
    for g, w in zip(grads, want_leaves):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=floor)
