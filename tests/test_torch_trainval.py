"""The port's trainer eval path against the JAX `Trainval` on the CPU, on
the same `SyntheticIO` batch and bridged parameters; and the port's
batcher against the JAX one, bit for bit."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dgcnn_tpu.config import Config as JaxConfig
from dgcnn_tpu.io.batching import BucketBatcher as JaxBatcher
from dgcnn_tpu.io.synthetic import SyntheticIO as JaxSyntheticIO
from dgcnn_tpu.parallel.mesh import make_mesh
from dgcnn_tpu.train.trainval import Trainval as JaxTrainval
from dgcnn_tpu_torch.bridge import params_from_numpy
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO, prefetch
from dgcnn_tpu_torch.ops.knn import knn_indices
from dgcnn_tpu_torch.train.trainval import Trainval, TrainState

SMALL = dict(
    model_name="residual-dgcnn", num_class=2, kvalue=8, edge_filters=(16, 16),
    head_feat_dim=32, head_mlp=(16,), minibatch_size=4,
)


def _batch(seed=0):
    io = JaxSyntheticIO(num_events=4, num_point=256, seed=seed, with_weights=True)
    io.initialize()
    batches = JaxBatcher(io, 4, buckets=(128, 256), shuffle=False).epoch()
    return next(iter(batches))


def _perturbed(tree, rng):
    """Mixed-sign BN scales and non-trivial running statistics."""
    tree = jax.tree_util.tree_map(np.asarray, tree)

    def walk(node):
        if isinstance(node, dict):
            if "scale" in node:
                d = node["scale"].shape[0]
                node["scale"] = (rng.uniform(0.3, 1.5, d) * rng.choice([-1.0, 1.0], d)).astype(np.float32)
                node["bias"] = (rng.randn(d) * 0.2).astype(np.float32)
            if "mean" in node:
                d = node["mean"].shape[0]
                node["mean"] = (rng.randn(d) * 0.3).astype(np.float32)
                node["var"] = rng.uniform(0.5, 2.0, d).astype(np.float32)
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
        return node

    return walk(tree)


def _pair(class_weights=(), **extra):
    kw = dict(SMALL, class_weights=class_weights, **extra)
    jtv = JaxTrainval(JaxConfig(**kw), mesh=make_mesh(1))
    jstate = jtv.initialize(4)
    rng = np.random.RandomState(3)
    params = _perturbed(jstate.params, rng)
    mstate = _perturbed(jstate.model_state, rng)
    jstate = jstate._replace(
        params=jax.tree_util.tree_map(jax.numpy.asarray, params),
        model_state=jax.tree_util.tree_map(jax.numpy.asarray, mstate),
    )
    ttv = Trainval(Config(**kw), device="cpu")
    tstate = TrainState(*params_from_numpy(params, mstate))
    return jtv, jstate, ttv, tstate


@pytest.mark.parametrize("class_weights", [(), (0.3, 2.0)])
def test_inference_matches_jax(class_weights):
    jtv, jstate, ttv, tstate = _pair(class_weights)
    batch = _batch()
    scores_j, pred_j, m_j = jtv.inference(jstate, batch)
    scores_t, pred_t, m_t = ttv.inference(tstate, batch)
    assert scores_t.shape == (4, 256, 2) and pred_t.dtype == torch.int32
    np.testing.assert_allclose(scores_t.numpy(), np.asarray(scores_j), atol=2e-5, rtol=0)
    np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred_j))
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m_t["loss_weight"]), float(m_j["loss_weight"]), rtol=1e-6)
    np.testing.assert_array_equal(m_t["confusion"].numpy(), np.asarray(m_j["confusion"]))
    assert float(m_t["confusion"].sum()) == batch.mask.sum()

    packed, m_p = ttv.inference_packed(tstate, batch)
    assert packed.shape == (4, 256, 4)
    assert torch.equal(packed[..., :2], scores_t)
    assert torch.equal(packed[..., 2].to(torch.int32), pred_t)
    assert torch.equal(packed[..., 3], m_t["loss"].expand(4, 256))
    m_e = ttv.evaluate(tstate, batch)
    for key in ("loss", "loss_weight", "confusion"):
        assert torch.equal(m_e[key], m_t[key]) and torch.equal(m_p[key], m_t[key])


@pytest.mark.parametrize("head_stream", ["off", "on"])
def test_banded_inference_matches_jax(head_stream):
    """``knn_window > 0`` on the CPU: the port's banded oracle under the
    Morton sort against the JAX trainer's, on the same batch and bridged
    parameters."""
    jtv, jstate, ttv, tstate = _pair(knn_window=64, head_stream=head_stream)
    batch = _batch(seed=2)
    scores_j, pred_j, m_j = jtv.inference(jstate, batch)
    scores_t, pred_t, m_t = ttv.inference(tstate, batch)
    np.testing.assert_allclose(scores_t.numpy(), np.asarray(scores_j), atol=2e-5, rtol=0)
    np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred_j))
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(m_t["confusion"].numpy(), np.asarray(m_j["confusion"]))


def test_knn_window_checks_match_jax():
    for kw in (dict(knn_window=-1), dict(knn_window=8, kvalue=20)):
        with pytest.raises(ValueError, match="knn_window"):
            Config(**kw)
        with pytest.raises(ValueError, match="knn_window"):
            JaxConfig(**kw).validate()
    assert Config(knn_window=20, kvalue=20).model_spec().knn_window == 20


def test_inference_without_weights_and_tuple_batch():
    """A tuple batch with weights None counts every valid point once."""
    jtv, jstate, ttv, tstate = _pair()
    b = _batch(seed=1)
    tup = (b.points, b.labels, None, b.mask)
    _, _, m_j = jtv.inference(jstate, tup)
    _, _, m_t = ttv.inference(tstate, tup)
    assert float(m_t["loss_weight"]) == b.mask.sum()
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]), rtol=1e-5)


def test_cpu_trainer_uses_oracle_and_seeded_init():
    cfg = Config(**SMALL)
    tv = Trainval(cfg, device="cpu")
    assert tv.model.knn_fn is knn_indices
    no_pallas = Trainval(dataclasses.replace(cfg, use_pallas=False), device="cpu")
    assert no_pallas.model.knn_fn is knn_indices
    a, b = tv.initialize(4), tv.initialize(4)
    assert torch.equal(a.params["blocks"][0]["w"], b.params["blocks"][0]["w"])
    c = tv.initialize(4, generator=torch.Generator().manual_seed(cfg.seed + 1))
    assert not torch.equal(a.params["blocks"][0]["w"], c.params["blocks"][0]["w"])
    scores, pred, _ = tv.inference(a, _batch())
    np.testing.assert_allclose(scores.sum(-1).numpy(), 1.0, atol=1e-5)
    assert int(pred.min()) >= 0 and int(pred.max()) < 2


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "kw",
    [
        dict(num_point=0, shuffle=True, buckets=(64, 128, 256)),
        dict(num_point=100, shuffle=False, crop_mode="random"),
        dict(num_point=96, shuffle=True, crop_mode="stride", drop_remainder=True),
    ],
)
def test_bucket_batcher_matches_jax_bit_for_bit(kw):
    ios = []
    for cls in (JaxSyntheticIO, SyntheticIO):
        io = cls(num_events=11, num_point=200, seed=5, with_weights=True)
        io.initialize()
        ios.append(io)
    jb = JaxBatcher(ios[0], 3, seed=9, **kw)
    tb = BucketBatcher(ios[1], 3, seed=9, **kw)
    for _ in range(2):  # the crop seed folds in the epoch when shuffled
        _assert_same_batches(list(tb.epoch()), list(jb.epoch()))


def test_prefetch_passes_items_through():
    io = SyntheticIO(num_events=6, num_point=64, seed=1)
    io.initialize()
    direct = list(BucketBatcher(io, 2, shuffle=False, num_point=64).epoch())
    fetched = list(prefetch(BucketBatcher(io, 2, shuffle=False, num_point=64).epoch(), 2))
    _assert_same_batches(fetched, direct)
