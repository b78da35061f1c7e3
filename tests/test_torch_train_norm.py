"""The port's train-mode batch norm and dropout against the JAX package,
on numpy-seeded inputs.

Statistics compare at atol 1e-6: the sums run in another order in the two
libraries, on unit-scale data; normalized outputs at atol 2e-6 and 1e-6
relative. Dropout's random bits cannot match JAX's PRNG, so its parity case
hands the port the keep mask JAX draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.models import core as jcore
from dgcnn_tpu.ops import norm as jnorm
from dgcnn_tpu_torch.models import core as tcore
from dgcnn_tpu_torch.ops import norm as tnorm


def _bn(rng, d):
    params = {"scale": rng.uniform(-1.5, 1.5, d).astype(np.float32),
              "bias": rng.randn(d).astype(np.float32)}
    state = {"mean": rng.randn(d).astype(np.float32),
             "var": rng.uniform(0.1, 3.0, d).astype(np.float32)}
    return params, state


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _close(got, want, atol=1e-6, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("count_kind", ["scalar", "per_channel", "zero"])
def test_finalize_batch_stats_matches_jax(count_kind):
    rng = np.random.RandomState(1)
    d = 7
    s1 = rng.randn(d).astype(np.float32) * 30
    s2 = rng.uniform(50, 200, d).astype(np.float32)
    _, state = _bn(rng, d)
    count = {"scalar": np.float32(40.0), "per_channel": np.full(d, 40.0, np.float32),
             "zero": np.zeros(d, np.float32)}[count_kind]
    want = jnorm.finalize_batch_stats(jnp.asarray(count), jnp.asarray(s1), jnp.asarray(s2),
                                      _j(state), momentum=0.9)
    got = tnorm.finalize_batch_stats(torch.tensor(count), torch.tensor(s1), torch.tensor(s2),
                                     _t(state), momentum=0.9)
    _close(got[0], want[0])
    _close(got[1], want[1])
    for key in ("mean", "var"):
        _close(got[2][key], want[2][key])
    if count_kind == "zero":
        # a batch with no valid position leaves the running state untouched
        for key in ("mean", "var"):
            np.testing.assert_array_equal(got[2][key].numpy(), state[key])


@pytest.mark.parametrize("mask_kind", ["none", "ragged", "all_false", "edge_shaped"])
@pytest.mark.parametrize("momentum", [0.9, 0.5])
def test_batch_norm_train_matches_jax(mask_kind, momentum):
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 40, 9) + 0.5).astype(np.float32)
    if mask_kind == "edge_shaped":  # (B, N, k, C) under a (B, N, 1) query mask
        x = rng.randn(3, 20, 5, 9).astype(np.float32)
    params, state = _bn(rng, 9)
    mask = {
        "none": None,
        "ragged": np.arange(40)[None] < np.array([[40], [13], [0]]),
        "all_false": np.zeros((3, 40), bool),
        "edge_shaped": (np.arange(20)[None] < np.array([[20], [7], [0]]))[..., None],
    }[mask_kind]
    want_y, want_s = jnorm.batch_norm_apply(
        _j(params), _j(state), jnp.asarray(x), None if mask is None else jnp.asarray(mask),
        train=True, momentum=momentum)
    got_y, got_s = tnorm.batch_norm_apply(
        _t(params), _t(state), torch.tensor(x), None if mask is None else torch.tensor(mask),
        train=True, momentum=momentum)
    # outputs to 1e-6 relative: with no valid position the chain scales by
    # rsqrt(eps) ~ 32
    _close(got_y, want_y, atol=2e-6, rtol=1e-6)
    for key in ("mean", "var"):
        _close(got_s[key], want_s[key])
    if mask_kind == "all_false":
        for key in ("mean", "var"):
            np.testing.assert_array_equal(got_s[key].numpy(), state[key])


def test_conv_bn_train_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 30, 6).astype(np.float32)
    w = (rng.randn(6, 11) * 0.4).astype(np.float32)
    bn_p, bn_s = _bn(rng, 11)
    mask = np.arange(30)[None] < np.array([[30], [17]])
    want, want_s = jcore.conv_bn_apply({"w": jnp.asarray(w), "bn": _j(bn_p)}, _j(bn_s),
                                       jnp.asarray(x), jnp.asarray(mask), train=True)
    got, got_s = tcore.conv_bn_apply({"w": torch.tensor(w), "bn": _t(bn_p)}, _t(bn_s),
                                     torch.tensor(x), torch.tensor(mask), train=True)
    _close(got, want, atol=1e-5)
    for key in ("mean", "var"):
        _close(got_s[key], want_s[key])


def test_dropout_deterministic_kept_share_and_scale():
    x = torch.full((64, 512), 3.0)
    a = tcore.dropout(x, 0.3, train=True, generator=torch.Generator().manual_seed(5))
    b = tcore.dropout(x, 0.3, train=True, generator=torch.Generator().manual_seed(5))
    c = tcore.dropout(x, 0.3, train=True, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert float(kept.float().mean()) == pytest.approx(0.7, abs=0.01)
    assert torch.equal(a[kept], torch.full_like(a[kept], 3.0 / 0.7))
    # identity in eval, at rate 0, and without a generator (JAX's rng=None)
    assert tcore.dropout(x, 0.3, train=False, generator=torch.Generator()) is x
    assert tcore.dropout(x, 0.0, train=True, generator=torch.Generator()) is x
    assert tcore.dropout(x, 0.3, train=True) is x


def test_dropout_injected_mask_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(4, 50, 8).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jcore.dropout(key, jnp.asarray(x), 0.25, train=True)
    keep = np.asarray(jax.random.bernoulli(key, 0.75, x.shape))
    got = tcore.dropout(torch.tensor(x), 0.25, train=True, keep_mask=torch.tensor(keep))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
