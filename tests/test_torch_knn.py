"""The port's kNN against the JAX package: the plain oracle against
`dgcnn_tpu.ops.knn.knn_indices`, and the kernel's plain version
`knn_plain` (self and cross) against the Pallas kernel in interpret mode.
The CUDA kernel itself is held against `knn_plain` on the card by
`tests/test_torch_cuda.py`, and timed by `kernel_times.py` (rows 1 and 1D).

The two sides score with different float expressions or contraction
orders, so 1-ulp near ties may order oppositely; the gate is zero HARD
mismatches by the split rule (`ops.knn.split_mismatches`) and identical
``valid`` flags. Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.kernels.knn_pallas import knn_pallas, knn_pallas_cross
from dgcnn_tpu.ops.knn import knn_indices as jax_knn_indices
from dgcnn_tpu_torch.kernels import knn_cuda as kmod
from dgcnn_tpu_torch.kernels.knn_cuda import knn_cuda, knn_cuda_cross, knn_plain
from dgcnn_tpu_torch.ops.knn import knn_indices, split_mismatches, tie_order_violations


def _points(seed, b, n, c, dup_rows=8):
    """Random points with duplicated rows (LArTPC voxels repeat)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, c).astype(np.float32)
    for e in range(b):
        src = rng.choice(n, dup_rows, replace=False)
        dst = rng.choice(n, dup_rows, replace=False)
        x[e, dst] = x[e, src]
    return x


def _mask(b, n, nvalid):
    """Per-event valid counts, e.g. (n, 100, 5, 0): full, ragged, fewer
    than k, empty."""
    return np.arange(n)[None, :] < np.asarray(nvalid)[:, None]


CASES = {
    "unmasked": dict(b=2, n=256, c=3, k=8, nvalid=None),
    "ragged": dict(b=4, n=256, c=16, k=20, nvalid=(256, 150, 5, 0)),
    "fewer_than_k": dict(b=2, n=128, c=4, k=12, nvalid=(7, 1)),
    "wide": dict(b=2, n=384, c=64, k=20, nvalid=(384, 200)),
}


def _case(name, seed=0):
    cfg = CASES[name]
    x = _points(seed, cfg["b"], cfg["n"], cfg["c"])
    mask = None if cfg["nvalid"] is None else _mask(cfg["b"], cfg["n"], cfg["nvalid"])
    return x, mask, cfg["k"]


def _assert_same_graph(x, idx_a, idx_b, valid_a, valid_b, xk=None):
    """``idx_a``/``valid_a`` are the port's: no hard mismatch against the
    other side, and duplicate keys listed by ascending index."""
    np.testing.assert_array_equal(np.asarray(valid_a), np.asarray(valid_b))
    hard, near = split_mismatches(x, idx_a, idx_b, valid_a, valid_b, xk=xk)
    assert hard == 0, f"{hard} hard mismatches ({near} near ties)"
    assert tie_order_violations(x if xk is None else xk, idx_a, valid_a) == 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_oracle_matches_jax_knn_indices(name):
    x, mask, k = _case(name)
    idx_j, valid_j = jax_knn_indices(
        jnp.asarray(x), k, None if mask is None else jnp.asarray(mask),
        precision=jax.lax.Precision.HIGHEST,
    )
    idx_t, valid_t = knn_indices(
        torch.tensor(x), k, None if mask is None else torch.tensor(mask)
    )
    assert idx_t.dtype == torch.int32 and valid_t.dtype == torch.bool
    _assert_same_graph(x, idx_t, idx_j, valid_t, valid_j)
    if mask is not None:
        # valid queries never pick a padded key; degraded slots are self-edges
        nv = mask.sum(1)
        for e in range(x.shape[0]):
            it = idx_t.numpy()[e, : nv[e]]
            assert (it < max(nv[e], 1)).all()
        self_idx = np.arange(x.shape[1])[None, :, None]
        bad = ~valid_t.numpy()
        assert (idx_t.numpy()[bad] == np.broadcast_to(self_idx, bad.shape)[bad]).all()


def test_pairwise_sq_dists_matches_jax():
    from dgcnn_tpu.ops.knn import pairwise_sq_dists as jax_pairwise
    from dgcnn_tpu_torch.ops.knn import pairwise_sq_dists

    x = _points(6, 2, 64, 5)
    want = np.asarray(jax_pairwise(jnp.asarray(x), precision=jax.lax.Precision.HIGHEST))
    got = pairwise_sq_dists(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    xd = x.astype(np.float64)
    exact = np.sum((xd[:, :, None] - xd[:, None]) ** 2, -1)
    np.testing.assert_allclose(got, exact, atol=1e-4)


def test_oracle_blocked_strips_match_one_shot(monkeypatch):
    """Query strips (the JAX `_knn_indices_blocked` memory bound) give the
    one-shot result: each row's expression and sort are row-independent."""
    from dgcnn_tpu_torch.ops import knn as knn_mod

    x, mask, k = _case("ragged", seed=4)
    one = knn_indices(torch.tensor(x), k, torch.tensor(mask))
    monkeypatch.setattr(knn_mod, "BLOCK_Q", 64)
    blocked = knn_indices(torch.tensor(x), k, torch.tensor(mask))
    _assert_same_graph(x, one[0], blocked[0], one[1], blocked[1])


@pytest.mark.parametrize("name", sorted(CASES))
def test_knn_plain_matches_pallas(name):
    x, mask, k = _case(name, seed=1)
    jm = None if mask is None else jnp.asarray(mask)
    idx_p, valid_p = knn_pallas(jnp.asarray(x), k, jm, interpret=True)
    tm = None if mask is None else torch.tensor(mask)
    idx_t, valid_t, scores_t = knn_plain(torch.tensor(x), torch.tensor(x), k, tm)
    _assert_same_graph(x, idx_t, idx_p, valid_t, valid_p)
    # scores are |x_i|^2 - D_ij, descending along k; invalid slots <= -1e29
    s = scores_t.numpy()
    assert (np.diff(s, axis=-1) <= 0).all()
    assert (s[~valid_t.numpy()] <= -1e29).all()


@pytest.mark.parametrize("nq,nk,c,k", [(200, 328, 8, 10), (384, 128, 16, 20)])
def test_knn_plain_cross_matches_pallas_cross(nq, nk, c, k):
    rng = np.random.RandomState(nq + nk)
    xq = rng.randn(2, nq, c).astype(np.float32)
    xk = rng.randn(2, nk, c).astype(np.float32)
    xk[:, 3] = xk[:, 7]  # a duplicated key
    mask_k = _mask(2, nk, (nk, 9))  # second event: fewer than k valid keys
    idx_p, valid_p, vals_p = knn_pallas_cross(
        jnp.asarray(xq), jnp.asarray(xk), k, jnp.asarray(mask_k), interpret=True
    )
    idx_t, valid_t, vals_t = knn_cuda_cross(
        torch.tensor(xq), torch.tensor(xk), k, torch.tensor(mask_k)
    )
    _assert_same_graph(xq, idx_t, idx_p, valid_t, valid_p, xk=xk)
    v = valid_t.numpy()
    np.testing.assert_allclose(vals_t.numpy()[v], np.asarray(vals_p)[v], rtol=1e-5, atol=1e-4)
    # invalid slots are self-edges min(i, nk - 1)
    self_idx = np.minimum(np.arange(nq), nk - 1)[None, :, None]
    assert (idx_t.numpy()[~v] == np.broadcast_to(self_idx, v.shape)[~v]).all()


@pytest.mark.parametrize("k", [65, 96, 130])
def test_knn_passes_plain_matches_plain_and_pallas(k):
    """The kernel's decomposition of k > 64 into passes of at most 64
    entries, each behind the last entry of the one before, is exact: equal
    to `knn_plain` (same scores, so index for index) and to the Pallas
    kernel in interpret mode, on a ragged mask where one event has fewer
    than k valid keys at k = 130."""
    x = _points(k, 2, 300, 5)
    x[:, 250] = x[:, 17]  # a duplicate the passes must keep in index order
    mask = _mask(2, 300, (300, 100))
    xt, mt = torch.tensor(x), torch.tensor(mask)
    got = kmod.knn_passes_plain(xt, xt, k, mt)
    for a, b in zip(got, knn_plain(xt, xt, k, mt)):
        assert torch.equal(a, b)
    idx_p, valid_p, vals_p = knn_pallas(jnp.asarray(x), k, jnp.asarray(mask), interpret=True,
                                        return_scores=True)
    idx_t, valid_t, vals_t = (t.numpy() for t in got)
    _assert_same_graph(x, idx_t, idx_p, valid_t, valid_p)
    np.testing.assert_allclose(vals_t[valid_t], np.asarray(vals_p)[valid_t], rtol=1e-5, atol=1e-5)
    assert valid_t[0].all() and valid_t[1].all() == (k <= 100)


@pytest.mark.parametrize("c", [3, 5, 179])
def test_identical_rows_get_identical_norms(c):
    """Equal key rows get bit-identical augmented operands at any C (the
    norms are reduced over rows padded to 16-byte alignment), so only the
    index decides between them."""
    row = np.random.RandomState(c).randn(c).astype(np.float32)
    x = np.broadcast_to(row, (2, 37, c)).copy()
    _, ka = kmod.build_augmented_operands(torch.tensor(x), torch.tensor(x))
    assert ka.shape == (2, 37, c + 2)
    assert torch.equal(ka, ka[:, :1].expand_as(ka))


def test_knn_cuda_on_cpu_is_knn_plain():
    """A CPU tensor takes the plain version and launches nothing."""
    x, mask, k = _case("ragged", seed=2)
    before = kmod.launches
    idx, valid = knn_cuda(torch.tensor(x), k, torch.tensor(mask))
    idx3, valid3, scores = knn_cuda(torch.tensor(x), k, torch.tensor(mask), return_scores=True)
    ref = knn_plain(torch.tensor(x), torch.tensor(x), k, torch.tensor(mask))
    for got in ((idx, valid), (idx3, valid3, scores)):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert kmod.launches == before


@pytest.mark.parametrize(
    "bad",
    ["float64", "noncontiguous", "mask_shape", "k_too_big", "k_above_nk", "mismatched_keys"],
)
def test_kernel_wrapper_refuses_bad_inputs(bad):
    """The launcher checks dtype, shape, contiguity and k before it builds
    or launches anything."""
    x = torch.randn(2, 96, 4)
    xk, mask, k = x, None, 8
    if bad == "float64":
        x = xk = x.double()
    elif bad == "noncontiguous":
        x = xk = torch.randn(2, 4, 96).transpose(1, 2)
    elif bad == "mask_shape":
        mask = torch.ones(2, 95, dtype=torch.bool)
    elif bad == "k_too_big":
        # any k up to Nk runs (in passes past KMAX); past Nk it is refused
        x = xk = torch.randn(1, 200, 4)
        k = 201
    elif bad == "k_above_nk":
        k = 97
    elif bad == "mismatched_keys":
        xk = torch.randn(2, 96, 5)
    with pytest.raises(ValueError):
        kmod._launch(x, xk, k, mask)


def test_tie_order_violations_counts_swapped_duplicates():
    x = np.zeros((1, 4, 2), np.float32)
    x[0, 1] = x[0, 3] = 1.0  # rows 1 and 3 are duplicates
    valid = np.ones((1, 1, 3), bool)
    assert tie_order_violations(x, np.array([[[1, 3, 0]]]), valid) == 0
    assert tie_order_violations(x, np.array([[[3, 1, 0]]]), valid) == 1
    assert tie_order_violations(x, np.array([[[3, 1, 0]]]), ~valid) == 0


def test_augmented_scores_are_offset_distances():
    """knn_plain's scores are |x_i|^2 - D_ij for valid slots."""
    x, mask, k = _case("unmasked", seed=3)
    idx, valid, scores = knn_plain(torch.tensor(x), torch.tensor(x), k)
    xd = x.astype(np.float64)
    b, i, s = np.nonzero(valid.numpy())
    j = idx.numpy()[b, i, s]
    want = np.sum(xd[b, i] ** 2, -1) - np.sum((xd[b, i] - xd[b, j]) ** 2, -1)
    np.testing.assert_allclose(scores.numpy()[b, i, s], want, atol=1e-4)
