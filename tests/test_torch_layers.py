"""The port's eval BN, layer helpers and loss/metrics against the JAX
package, on numpy-seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.models import core as jcore
from dgcnn_tpu.ops import loss as jloss
from dgcnn_tpu.ops import norm as jnorm
from dgcnn_tpu_torch.models import core as tcore
from dgcnn_tpu_torch.ops import loss as tloss
from dgcnn_tpu_torch.ops import norm as tnorm


def _bn(rng, d):
    params = {
        "scale": rng.uniform(-1.5, 1.5, d).astype(np.float32),
        "bias": rng.randn(d).astype(np.float32),
    }
    state = {
        "mean": rng.randn(d).astype(np.float32),
        "var": rng.uniform(0.1, 3.0, d).astype(np.float32),
    }
    return params, state


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def test_batch_norm_eval_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 40, 9).astype(np.float32) * 4
    params, state = _bn(rng, 9)
    want, _ = jnorm.batch_norm_apply(_j(params), _j(state), jnp.asarray(x), train=False)
    ts = _t(state)
    got, st = tnorm.batch_norm_apply(_t(params), ts, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert st is ts  # eval leaves the running state as it was


def test_batch_norm_init_matches_jax():
    jp, js = jnorm.batch_norm_init(5)
    tp, ts = tnorm.batch_norm_init(5)
    for j, t in ((jp, tp), (js, ts)):
        for k in j:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


def test_conv_bn_and_dense_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 30, 6).astype(np.float32)
    w = rng.randn(6, 11).astype(np.float32)
    b = rng.randn(11).astype(np.float32)
    bn_p, bn_s = _bn(rng, 11)
    want, _ = jcore.conv_bn_apply(
        {"w": jnp.asarray(w), "bn": _j(bn_p)}, _j(bn_s), jnp.asarray(x), train=False
    )
    got, _ = tcore.conv_bn_apply({"w": torch.tensor(w), "bn": _t(bn_p)}, _t(bn_s), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)
    want = jcore.dense_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    got = tcore.dense_apply({"w": torch.tensor(w), "b": torch.tensor(b)}, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)


def test_glorot_init_shape_and_range():
    g = torch.Generator().manual_seed(0)
    p = tcore.dense_init(g, 40, 24)
    limit = np.sqrt(6.0 / 64)
    assert p["w"].shape == (40, 24) and p["b"].shape == (24,)
    assert float(p["w"].abs().max()) <= limit
    assert float(p["w"].std()) == pytest.approx(limit / np.sqrt(3), rel=0.1)
    # the same seed gives the same weights
    q = tcore.dense_init(torch.Generator().manual_seed(0), 40, 24)
    assert torch.equal(p["w"], q["w"])
    # eval dropout is the identity
    assert tcore.dropout(p["w"], 0.5, train=False) is p["w"]


@pytest.mark.parametrize("weighted,masked", [(False, False), (True, False), (True, True)])
def test_loss_and_metrics_match_jax(weighted, masked):
    rng = np.random.RandomState(2)
    logits = rng.randn(3, 50, 4).astype(np.float32) * 2
    labels = rng.randint(0, 4, (3, 50)).astype(np.int32)
    weights = rng.uniform(0.1, 2.0, (3, 50)).astype(np.float32) if weighted else None
    mask = (np.arange(50)[None] < np.array([[50], [20], [0]])) if masked else None

    def opt_j(a):
        return None if a is None else jnp.asarray(a)

    def opt_t(a):
        return None if a is None else torch.tensor(a)

    jl = jloss.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), opt_j(weights), opt_j(mask))
    tl = tloss.softmax_cross_entropy(torch.tensor(logits), torch.tensor(labels), opt_t(weights), opt_t(mask))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    ja = jloss.accuracy(jnp.asarray(logits), jnp.asarray(labels), opt_j(mask))
    ta = tloss.accuracy(torch.tensor(logits), torch.tensor(labels), opt_t(mask))
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    pred = np.argmax(logits, -1)
    jcm = jloss.confusion_matrix(jnp.asarray(pred), jnp.asarray(labels), 4, opt_j(mask))
    tcm = tloss.confusion_matrix(torch.tensor(pred), torch.tensor(labels), 4, opt_t(mask))
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))
    np.testing.assert_allclose(
        tloss.per_class_accuracy(tcm).numpy(), np.asarray(jloss.per_class_accuracy(jcm)), rtol=1e-6
    )
    np.testing.assert_allclose(
        float(tloss.mean_iou(tcm)), float(jloss.mean_iou(jcm)), rtol=1e-6
    )


def test_all_masked_loss_is_zero():
    """The 1e-9 floor on the weight sum: an all-masked batch gives 0."""
    logits = torch.randn(2, 8, 3)
    labels = torch.zeros(2, 8, dtype=torch.int32)
    mask = torch.zeros(2, 8, dtype=torch.bool)
    assert float(tloss.softmax_cross_entropy(logits, labels, mask=mask)) == 0.0
    want = jloss.softmax_cross_entropy(
        jnp.asarray(logits.numpy()), jnp.asarray(labels.numpy()), mask=jnp.asarray(mask.numpy())
    )
    assert float(want) == 0.0
