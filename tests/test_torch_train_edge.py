"""The port's train-mode EdgeConv blocks against the JAX package, on a
pinned graph: outputs and new BN states of the reduced and fused forms,
the fused form's gradients (`GatheredStats`) against ``jax.grad`` through
the JAX fused form, and ``torch.autograd.gradcheck`` in float64.

Tolerances: outputs and states atol 1e-5 (batch statistics summed in
another order); gradients rtol 1e-5 on tie-free data (every query's k
neighbours distinct, continuous values), with an absolute floor of 1e-6
of the gradient's largest entry for entries that cancel to near zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.ops import edge as jedge
from dgcnn_tpu_torch.ops import edge as tedge
from dgcnn_tpu_torch.ops.norm import batch_norm_apply


def _graph(seed, b=2, n=48, k=6, nq=None):
    """Distinct neighbours per query (no slot ties), indices into ``nq``
    key rows (default ``n``)."""
    rng = np.random.RandomState(seed)
    nq = nq or n
    idx = np.stack([np.stack([rng.choice(nq, k, replace=False) for _ in range(n)])
                    for _ in range(b)]).astype(np.int32)
    return idx


def _inputs(seed, b=2, n=48, d=10, k=6, nq=None, gamma_sign="mixed"):
    rng = np.random.RandomState(seed)
    p = rng.randn(b, n, d).astype(np.float32)
    q = rng.randn(b, nq or n, d).astype(np.float32)
    scale = rng.uniform(0.3, 1.5, d).astype(np.float32)
    if gamma_sign == "mixed":
        scale = scale * np.where(np.arange(d) % 2 == 0, 1.0, -1.0).astype(np.float32)
    bn_p = {"scale": scale, "bias": (rng.randn(d) * 0.3).astype(np.float32)}
    bn_s = {"mean": (rng.randn(d) * 0.5).astype(np.float32),
            "var": rng.uniform(0.3, 2.0, d).astype(np.float32)}
    mask = np.arange(n)[None] < np.array([[n], [n // 3]])[:b]
    return p, q, bn_p, bn_s, _graph(seed + 1, b, n, k, nq), mask


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


JAX_FORMS = {"reduced": jedge.edgeconv_block_reduced, "fused": jedge.edgeconv_block_fused}
PORT_FORMS = {"reduced": tedge.edgeconv_block_reduced, "fused": tedge.edgeconv_block_fused}


@pytest.mark.parametrize("form", ["reduced", "fused"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("gamma_sign", ["positive", "mixed"])
def test_train_block_matches_jax(form, masked, gamma_sign):
    p, q, bn_p, bn_s, idx, mask = _inputs(3, gamma_sign=gamma_sign)
    m = mask if masked else None
    want, want_s = JAX_FORMS[form](
        jnp.asarray(p), jnp.asarray(q), _j(bn_p), _j(bn_s), jnp.asarray(idx),
        None if m is None else jnp.asarray(m), train=True, momentum=0.9)
    got, got_s = PORT_FORMS[form](
        torch.tensor(p), torch.tensor(q), _t(bn_p), _t(bn_s), torch.tensor(idx),
        None if m is None else torch.tensor(m), train=True, momentum=0.9)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for key in ("mean", "var"):
        np.testing.assert_allclose(got_s[key].detach().numpy(), np.asarray(want_s[key]),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("gamma_sign", ["positive", "mixed"])
def test_fused_eval_is_the_edge_form_bitwise(gamma_sign):
    p, q, bn_p, bn_s, idx, mask = _inputs(4, gamma_sign=gamma_sign)
    p, q, idx = torch.tensor(p), torch.tensor(q), torch.tensor(idx)
    bn_p, bn_s = _t(bn_p), _t(bn_s)
    fused, st = tedge.edgeconv_block_fused(p, q, bn_p, bn_s, idx, torch.tensor(mask))
    h = p[..., :, None, :] + tedge.gather_neighbors(q, idx)
    edge = torch.relu(batch_norm_apply(bn_p, bn_s, h)[0]).amax(dim=-2)
    assert torch.equal(fused, edge) and st is bn_s


def _jax_grads(p, q, bn_p, bn_s, idx, mask, cot):
    """``jax.grad`` of a scalar that reaches every output of the JAX fused
    block: the output and both new running statistics."""
    cy, cm, cv = (jnp.asarray(c) for c in cot)

    def loss(p, q):
        y, s = jedge.edgeconv_block_fused(p, q, _j(bn_p), _j(bn_s), jnp.asarray(idx),
                                          None if mask is None else jnp.asarray(mask),
                                          train=True)
        return jnp.sum(y * cy) + jnp.sum(s["mean"] * cm) + jnp.sum(s["var"] * cv)

    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(p), jnp.asarray(q))


def _port_grads(p, q, bn_p, bn_s, idx, mask, cot):
    pt = torch.tensor(p, requires_grad=True)
    qt = torch.tensor(q, requires_grad=True)
    y, s = tedge.edgeconv_block_fused(pt, qt, _t(bn_p), _t(bn_s), torch.tensor(idx),
                                      None if mask is None else torch.tensor(mask), train=True)
    cy, cm, cv = (torch.tensor(c) for c in cot)
    loss = torch.sum(y * cy) + torch.sum(s["mean"] * cm) + torch.sum(s["var"] * cv)
    return torch.autograd.grad(loss, (pt, qt))


def _close_rel(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("extended", [False, True], ids=["local", "extended_q"])
def test_fused_gradients_match_jax_grad(masked, extended):
    """dp and dq through `GatheredStats` and the statistics around it equal
    ``jax.grad`` of the JAX fused block; ``extended``: ``q`` holds more
    rows than ``p`` (an extended neighbour operand, rows that no query
    references get zero gradient)."""
    nq = 80 if extended else None
    p, q, bn_p, bn_s, idx, mask = _inputs(5, nq=nq)
    m = mask if masked else None
    rng = np.random.RandomState(6)
    cot = (rng.randn(*p.shape).astype(np.float32), rng.randn(p.shape[-1]).astype(np.float32),
           rng.randn(p.shape[-1]).astype(np.float32))
    wp, wq = _jax_grads(p, q, bn_p, bn_s, idx, m, cot)
    gp, gq = _port_grads(p, q, bn_p, bn_s, idx, m, cot)
    _close_rel(gp.numpy(), wp)
    _close_rel(gq.numpy(), wq)
    if extended:
        untouched = np.ones(q.shape[:2], bool)
        for b in range(q.shape[0]):
            untouched[b, np.unique(idx[b])] = False
        assert np.all(gq.numpy()[untouched] == 0)


@pytest.mark.parametrize("weighted", [False, True])
def test_gathered_stats_gradcheck_float64(weighted):
    rng = np.random.RandomState(7)
    b, n, nq, d, k = 2, 9, 11, 3, 4
    p = torch.tensor(rng.randn(b, n, d), dtype=torch.float64, requires_grad=True)
    q = torch.tensor(rng.randn(b, nq, d), dtype=torch.float64, requires_grad=True)
    idx = torch.tensor(_graph(8, b, n, k, nq))
    w = torch.tensor((np.arange(n)[None] < np.array([[n], [5]])).astype(np.float64)) if weighted else None
    gsign = torch.tensor([True, False, True])
    assert torch.autograd.gradcheck(
        lambda p, q: tedge.GatheredStats.apply(p, q, idx, w, gsign), (p, q), eps=1e-6, atol=1e-7)


def test_gathered_stats_forward_and_winners():
    """The forward's outputs are the dense reductions; the winner of a tie
    is the first slot, which takes the whole cotangent (autograd of
    ``amax`` would split it)."""
    q = torch.tensor([[[1.0, -2.0], [1.0, 5.0], [0.5, -2.0]]], requires_grad=True)
    p = torch.zeros(1, 1, 2, requires_grad=True)
    idx = torch.tensor([[[2, 0, 1]]])
    m, s1p, s2a, s2b = tedge.GatheredStats.apply(p, q, idx, None, torch.tensor([True, False]))
    assert torch.equal(m, torch.tensor([[[1.0, -2.0]]]))
    assert torch.equal(s1p, torch.tensor([2.5, 1.0]))
    assert torch.equal(s2a, torch.tensor([2.25, 33.0]))
    (dq,) = torch.autograd.grad(m.sum(), (q,))
    # channel 0: max 1.0 at slots 1 (row 0) and 2 (row 1): row 0 wins;
    # channel 1: min -2.0 at slots 0 (row 2) and 1 (row 0): row 2 wins
    assert torch.equal(dq, torch.tensor([[[1.0, 0.0], [0.0, 0.0], [0.0, 1.0]]]))


def test_fused_train_past_the_slot_stream_line_raises(monkeypatch):
    """(The name is kept from before the slot-streamed train forward was
    ported, when this line raised "item 11".) Past the line the fused
    train block streams one slot at a time and gives the dense block's
    output and new BN state within the sums' reassociation, and the JAX
    package's streamed block's (`tests/test_torch_long_train.py` holds
    the reductions and gradients)."""
    p, q, bn_p, bn_s, idx, mask = _inputs(9)
    args = (torch.tensor(p), torch.tensor(q), _t(bn_p), _t(bn_s), torch.tensor(idx),
            torch.tensor(mask))
    want, want_s = tedge.edgeconv_block_fused(*args, train=True)
    line = idx.shape[1] * idx.shape[2] * p.shape[-1]
    monkeypatch.setattr(tedge, "SLOT_STREAM_ELEMS", line)
    monkeypatch.setattr(jedge, "SLOT_STREAM_ELEMS", line)
    got, got_s = tedge.edgeconv_block_fused(*args, train=True)
    jy, js = jedge.edgeconv_block_fused(jnp.asarray(p), jnp.asarray(q), _j(bn_p), _j(bn_s),
                                        jnp.asarray(idx), jnp.asarray(mask), train=True)
    for ref, ref_s in ((want, want_s), (np.asarray(jy), js)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        for key in ("mean", "var"):
            np.testing.assert_allclose(got_s[key].numpy(), np.asarray(ref_s[key]), rtol=1e-5,
                                       atol=1e-6)
