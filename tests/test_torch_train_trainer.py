"""The port's single-device trainer against the JAX `Trainval` on the CPU:
the same bridged init, the same `SyntheticIO` batches, a pinned graph and
dropout 0, over 5 train steps, for every optimizer, with global-norm
clipping and each learning-rate schedule.

The pinned graph is a fixed ring (point i's neighbours are i .. i + k - 1
mod N) that both packages' ``knn_fn`` return whatever the features, so the
trajectories cannot part over a near-tie kNN choice. The model is the plain
``dgcnn`` without the global pool in the Adam cases: a residual
projection's bias and, under the global pool, the feature conv's BN bias
have a true gradient of zero (the train-mode BN layers after them cancel
any uniform shift), and Adam turns the two packages' rounding noise there
into steps of ``lr`` with opposite signs. The global pool, the flagship
``residual-dgcnn`` and its stacked per-edge convs train in the SGD cases. Loss within 1e-5 relative at every step; parameters within 1e-4
relative after 5 steps, with an absolute floor of 1e-4 of the model's
largest parameter (a zero-gradient leaf stays at rounding noise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dgcnn_tpu.config import Config as JaxConfig
from dgcnn_tpu.io.batching import BucketBatcher as JaxBatcher
from dgcnn_tpu.io.synthetic import SyntheticIO as JaxSyntheticIO
from dgcnn_tpu.train.trainval import Trainval as JaxTrainval
from dgcnn_tpu.train.trainval import _make_lr as jax_make_lr
from dgcnn_tpu_torch.bridge import params_from_numpy, tree_leaves
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.train.trainval import Trainval

SMALL = dict(model_name="dgcnn", num_class=2, kvalue=6, edge_filters=(12, 16),
             head_feat_dim=24, head_mlp=(16,), minibatch_size=2, num_point=128,
             global_pool=False)
STEPS = 5


def _ring(n, k):
    return (np.arange(n)[:, None] + np.arange(k)[None]) % n


def _jax_ring(x, k, mask):
    # the zeros derived from x keep the graph varying over the JAX
    # trainer's shard_map axes, as its own graph builds are
    idx = jnp.asarray(_ring(x.shape[-2], k), jnp.int32) + (x[..., :1] * 0).astype(jnp.int32)
    return idx, jnp.ones(idx.shape, bool)


def _port_ring(x, k, mask):
    idx = torch.tensor(_ring(x.shape[-2], k), dtype=torch.int32, device=x.device)
    idx = idx.expand(x.shape[:-1] + (k,))
    return idx, torch.ones(idx.shape, dtype=torch.bool, device=x.device)


def _batches():
    io = JaxSyntheticIO(num_events=2 * STEPS, num_point=128, seed=3, with_weights=True)
    io.initialize()
    return list(JaxBatcher(io, 2, buckets=(128,), shuffle=False).epoch())


CASES = {
    "adam": dict(optimizer="adam"),
    "adam_cosine_clip": dict(optimizer="adam", lr_schedule="cosine", lr_decay_steps=4,
                             grad_clip=0.05),
    "adamw_step": dict(optimizer="adamw", lr_schedule="step", lr_decay_steps=2,
                       lr_decay_rate=0.5, learning_rate=3e-3),
    "sgd_clip": dict(optimizer="sgd", learning_rate=0.05, grad_clip=0.05),
    "sgd_global_pool": dict(optimizer="sgd", learning_rate=0.05, global_pool=True),
    "sgd_cosine": dict(optimizer="sgd", learning_rate=0.05, lr_schedule="cosine", iteration=3),
    "momentum_step_clip": dict(optimizer="momentum", learning_rate=0.02, lr_schedule="step",
                               lr_decay_steps=3, grad_clip=0.1),
    "adam_class_weights": dict(optimizer="adam", class_weights=(1.0, 2.5)),
    # the flagship model, and its stacked per-edge convs (block_convs=2)
    "residual_sgd": dict(model_name="residual-dgcnn", global_pool=True, optimizer="sgd",
                         learning_rate=0.05),
    "residual_block_convs2_sgd": dict(model_name="residual-dgcnn", global_pool=True,
                                      block_convs=2, optimizer="sgd", learning_rate=0.05),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_five_steps_match_jax_trainval(case):
    kw = {**SMALL, **CASES[case]}
    jtv = JaxTrainval(JaxConfig(**kw, num_devices=1, use_pallas=False), knn_fn=_jax_ring)
    jstate = jtv.initialize(4, rng=jax.random.PRNGKey(7))
    tv = Trainval(Config(**kw), device="cpu", knn_fn=_port_ring)
    params, mstate = params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate.params),
                                       jax.tree_util.tree_map(np.asarray, jstate.model_state))
    state = tv.with_params(params, mstate)
    for i, batch in enumerate(_batches()[:STEPS]):
        jstate, jm = jtv.train_step(jstate, batch)
        state, m = tv.train_step(state, batch)
        want = float(jm["loss"])
        assert abs(float(m["loss"]) - want) <= 1e-5 * abs(want), (i, float(m["loss"]), want)
        np.testing.assert_allclose(m["acc"].numpy(), np.asarray(jm["acc"]), atol=1e-6)
        np.testing.assert_allclose(m["class_acc"].numpy(), np.asarray(jm["class_acc"]), atol=1e-6)
    assert state.step == STEPS and int(jstate.step) == STEPS
    want_leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jstate.params))
    got_leaves = tree_leaves(state.params)
    assert len(got_leaves) == len(want_leaves)
    floor = 1e-4 * max(float(np.abs(w).max()) for w in want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=floor)
    for g, w in zip(tree_leaves(state.model_state),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jstate.model_state))):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("schedule,kw", [
    ("constant", {}), ("cosine", dict(lr_decay_steps=7)), ("cosine", dict(iteration=10)),
    ("step", dict(lr_decay_steps=3, lr_decay_rate=0.3)), ("step", dict(iteration=4)),
])
def test_lr_at_matches_optax(schedule, kw):
    cfg = dict(learning_rate=2e-3, lr_schedule=schedule, **kw)
    want = jax_make_lr(JaxConfig(**cfg))
    tv = Trainval(Config(**cfg), device="cpu")
    for t in range(14):
        w = float(want(t)) if callable(want) else float(want)
        assert tv.lr_at(t) == pytest.approx(w, rel=1e-6, abs=1e-12)


def test_adamw_uses_optax_weight_decay():
    """AdamW's decay is optax's default 1e-4, not torch's 1e-2: with a zero
    gradient the first update is ``-lr * 1e-4 * p``."""
    tv = Trainval(Config(optimizer="adamw", learning_rate=0.5), device="cpu")
    p0 = jnp.asarray([2.0, -4.0])
    p = [torch.tensor(np.asarray(p0))]
    tv.opt.update(p, [torch.zeros(2)], tv.opt.init(p), tv.lr_at(0))
    opt = optax.adamw(0.5)
    upd, _ = opt.update(jnp.zeros(2), opt.init(p0), p0)
    np.testing.assert_array_equal(p[0].numpy(), np.asarray(optax.apply_updates(p0, upd)))
    assert p[0][0] == pytest.approx(2.0 - 0.5 * 1e-4 * 2.0)


def test_clip_matches_optax_without_epsilon():
    tv = Trainval(Config(optimizer="sgd", learning_rate=1.0, grad_clip=0.5), device="cpu")
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]
    p = [torch.zeros(2), torch.zeros(1)]
    tv.opt.update(p, g, tv.opt.init(p), 1.0)
    clip = optax.clip_by_global_norm(0.5)
    want, _ = clip.update([jnp.asarray([3.0, 4.0]), jnp.asarray([12.0])], clip.init(None))
    for got, w in zip(p, want):
        np.testing.assert_allclose(-got.numpy(), np.asarray(w), rtol=1e-7)


def test_train_step_metrics_and_state_tree():
    """The step's metrics, its new BN state in the model's tree, the step
    count, and the rule that the parameters update in place."""
    tv = Trainval(Config(**SMALL), device="cpu", knn_fn=_port_ring)
    state = tv.initialize(4)
    before = [t.clone() for t in tree_leaves(state.params)]
    batch = _batches()[0]
    new, m = tv.train_step(state, batch)
    assert set(m) == {"loss", "acc", "class_acc"} and m["class_acc"].shape == (2,)
    assert bool(torch.isfinite(m["loss"])) and 0.0 <= float(m["acc"]) <= 1.0
    assert new.step == 1 and new.params is state.params
    assert any(not torch.equal(a, b) for a, b in zip(before, tree_leaves(new.params)))
    assert len(tree_leaves(new.model_state)) == len(tree_leaves(state.model_state))
    assert not any(t.requires_grad for t in tree_leaves(new.params) + tree_leaves(new.model_state))
