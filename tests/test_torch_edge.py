"""The port's edge ops against the JAX package: neighbor gather, edge
features, the factorized pre-activation and the eval-mode EdgeConv
reduction.

Gathers and subtractions are exact, so those compare bit for bit. The
reduction compares at atol 1e-6: ``rsqrt`` may differ by one ulp between
the two libraries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.ops import edge as jedge
from dgcnn_tpu_torch.ops import edge as tedge
from dgcnn_tpu_torch.ops.norm import batch_norm_apply


def _graph(seed, b=2, n=64, c=5, k=7):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, c).astype(np.float32)
    idx = rng.randint(0, n, size=(b, n, k)).astype(np.int32)
    return x, idx


def _bn(seed, d, gamma_sign):
    rng = np.random.RandomState(seed)
    scale = rng.uniform(0.2, 1.5, d).astype(np.float32)
    if gamma_sign == "negative":
        scale = -scale
    elif gamma_sign == "mixed":
        scale = scale * np.where(np.arange(d) % 2 == 0, 1.0, -1.0).astype(np.float32)
    params = {"scale": scale, "bias": rng.randn(d).astype(np.float32) * 0.3}
    state = {
        "mean": rng.randn(d).astype(np.float32) * 0.5,
        "var": rng.uniform(0.3, 2.0, d).astype(np.float32),
    }
    return params, state


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


@pytest.mark.parametrize("batch_dims", [0, 1])
def test_gather_neighbors_bitwise(batch_dims):
    x, idx = _graph(0)
    if batch_dims == 0:
        x, idx = x[0], idx[0]
    want = np.asarray(jedge.gather_neighbors(jnp.asarray(x), jnp.asarray(idx)))
    got = tedge.gather_neighbors(torch.tensor(x), torch.tensor(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def test_edge_features_bitwise():
    x, idx = _graph(1)
    want = np.asarray(jedge.edge_features(jnp.asarray(x), jnp.asarray(idx)))
    got = tedge.edge_features(torch.tensor(x), torch.tensor(idx)).numpy()
    assert got.shape == x.shape[:2] + (idx.shape[-1], 2 * x.shape[-1])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bias", [False, True])
def test_edge_preact_factorized_matches_jax(bias):
    """``P_i + Q_j (+ b)`` against the JAX function (atol 1e-5: the two
    libraries' f32 matmuls sum in other orders) and against the unfactorized
    ``edge_features @ w + b`` (1e-4: the factorization itself reassociates)."""
    x, idx = _graph(5, c=6)
    rng = np.random.RandomState(6)
    w = rng.randn(12, 10).astype(np.float32)
    b = rng.randn(10).astype(np.float32) if bias else None
    want = np.asarray(jedge.edge_preact_factorized(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), None if b is None else jnp.asarray(b)))
    tb = None if b is None else torch.tensor(b)
    got = tedge.edge_preact_factorized(torch.tensor(x), torch.tensor(idx), torch.tensor(w), tb)
    assert got.shape == (2, 64, 7, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    full = tedge.edge_features(torch.tensor(x), torch.tensor(idx)) @ torch.tensor(w)
    np.testing.assert_allclose(got.numpy(), (full if tb is None else full + tb).numpy(),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("gamma_sign", ["positive", "negative", "mixed"])
def test_edgeconv_block_reduced_eval_matches_jax(gamma_sign):
    x, idx = _graph(2, c=6)
    rng = np.random.RandomState(3)
    d = 12
    p = rng.randn(2, 64, d).astype(np.float32)
    q = rng.randn(2, 64, d).astype(np.float32)
    bn_p, bn_s = _bn(4, d, gamma_sign)
    mask = np.arange(64)[None] < np.array([[64], [30]])
    want, new_state = jedge.edgeconv_block_reduced(
        jnp.asarray(p), jnp.asarray(q),
        {k: jnp.asarray(v) for k, v in bn_p.items()},
        {k: jnp.asarray(v) for k, v in bn_s.items()},
        jnp.asarray(idx), jnp.asarray(mask), train=False,
    )
    got, _ = tedge.edgeconv_block_reduced(
        torch.tensor(p), torch.tensor(q), _t(bn_p), _t(bn_s), torch.tensor(idx)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    # eval BN leaves the running statistics as they were
    np.testing.assert_array_equal(np.asarray(new_state["mean"]), bn_s["mean"])


@pytest.mark.parametrize("gamma_sign", ["positive", "mixed"])
def test_reduced_equals_materialized_edge_form(gamma_sign):
    """Selection commutes with the monotone BN+relu chain, so the reduced
    block is bitwise the gather + BN + relu + max form."""
    rng = np.random.RandomState(5)
    _, idx = _graph(6, n=48, k=9)
    p = torch.tensor(rng.randn(2, 48, 10).astype(np.float32))
    q = torch.tensor(rng.randn(2, 48, 10).astype(np.float32))
    bn_p, bn_s = _bn(7, 10, gamma_sign)
    bn_p, bn_s = _t(bn_p), _t(bn_s)
    idx = torch.tensor(idx)
    reduced, _ = tedge.edgeconv_block_reduced(p, q, bn_p, bn_s, idx)
    h = p[..., :, None, :] + tedge.gather_neighbors(q, idx)
    edge = torch.relu(batch_norm_apply(bn_p, bn_s, h)[0]).amax(dim=-2)
    assert torch.equal(reduced, edge)


def test_slot_streamed_size_raises():
    """Past SLOT_STREAM_ELEMS the reduced block streams one slot at a time
    (it raised before the long-event slice) and the graph-sized buffer is
    never built; only the edge form's slot stream still raises (see
    `tests/test_torch_model.py::test_edge_form_slot_stream_still_raises`)."""
    # an (N, k) graph whose N * k * D reaches the line, built cheaply as an
    # expanded (zero-stride) index tensor; a dense gather would be 2**27
    # floats
    n = tedge.SLOT_STREAM_ELEMS // 64
    q = torch.arange(n, dtype=torch.float32).reshape(1, n, 1)
    p = torch.zeros(1, n, 1)
    idx = torch.tensor([3, 1] * 32, dtype=torch.int32).reshape(1, 1, 64).expand(1, n, 64)
    bn_p = {"scale": torch.tensor([-1.0]), "bias": torch.zeros(1)}
    bn_s = {"mean": torch.zeros(1), "var": torch.ones(1)}
    y, _ = tedge.edgeconv_block_reduced(p, q, bn_p, bn_s, idx)
    # gamma < 0 selects the neighbour min, q[1] = 1, through the BN chain
    want = torch.relu((0.0 + 1.0 - 0.0) * torch.rsqrt(torch.tensor(1.0 + 1e-3)) * -1.0)
    assert y.shape == (1, n, 1) and torch.equal(y, want.expand(1, n, 1))


@pytest.mark.parametrize("gamma_sign", ["positive", "negative", "mixed"])
def test_slot_streamed_equals_dense_bitwise(monkeypatch, gamma_sign):
    """The slot-streamed eval reduction folds max and min in slot order:
    bit for bit the dense gather's amax/amin, and so the JAX package's."""
    rng = np.random.RandomState(8)
    _, idx = _graph(9, n=80, k=11)
    p = rng.randn(2, 80, 12).astype(np.float32)
    q = rng.randn(2, 80, 12).astype(np.float32)
    q[:, 5] = q[:, 6]  # exact ties between slots
    bn_p, bn_s = _bn(10, 12, gamma_sign)
    args = (torch.tensor(p), torch.tensor(q), _t(bn_p), _t(bn_s), torch.tensor(idx))
    dense, _ = tedge.edgeconv_block_reduced(*args)
    monkeypatch.setattr(tedge, "SLOT_STREAM_ELEMS", 80 * 11 * 12)
    streamed, _ = tedge.edgeconv_block_reduced(*args)
    assert torch.equal(streamed, dense)
    mx, mn = tedge._maxmin_streamed(torch.tensor(q), torch.tensor(idx))
    g = tedge.gather_neighbors(torch.tensor(q), torch.tensor(idx))
    assert torch.equal(mx, g.amax(dim=-2)) and torch.equal(mn, g.amin(dim=-2))
    want, _ = jedge.edgeconv_block_reduced(
        jnp.asarray(p), jnp.asarray(q),
        {k: jnp.asarray(v) for k, v in bn_p.items()},
        {k: jnp.asarray(v) for k, v in bn_s.items()},
        jnp.asarray(idx), None, train=False,
    )
    np.testing.assert_allclose(streamed.numpy(), np.asarray(want), atol=1e-6, rtol=0)
