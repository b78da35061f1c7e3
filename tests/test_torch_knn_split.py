"""The exact kernel's key split, on the CPU: the plain version of its merge
(`kernels.knn_cuda.merge_lists_plain`) over S key ranges of `knn_plain`
against `knn_plain` on the whole key set and against the JAX package's
Pallas kernel (`knn_pallas`, `knn_pallas_cross`, in interpret mode, as
the JAX tests run it), and the launcher's choice of S
(`kernels.knn_cuda.split_count`). The kernel and its merge kernel are
held against these on the card by `tests/test_torch_cuda.py`.

Inputs come from numpy seeds: ragged masks, duplicated rows (exact ties
between keys), and events with fewer than k valid points (self-edges).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.kernels.knn_pallas import knn_pallas, knn_pallas_cross
from dgcnn_tpu_torch.kernels import knn_cuda as kmod
from dgcnn_tpu_torch.ops.knn import split_mismatches, tie_order_violations

CASES = {
    # b, nq, nk, c, k, valid keys per event
    "ragged": (4, 200, 200, 16, 20, (200, 150, 7, 0)),
    "fewer_than_k": (2, 130, 130, 4, 12, (9, 1)),
    "cross": (2, 90, 250, 8, 10, (250, 6)),
}


def _inputs(name):
    b, nq, nk, c, k, nvalid = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    xk = rng.randn(b, nk, c).astype(np.float32)
    xk[:, 30:45] = xk[:, 0:15]  # duplicated rows: equal scores for every query
    xk[:, nk - 1] = xk[:, 2]  # and one across the last key range
    xq = xk[:, :nq].copy() if nq == nk else rng.randn(b, nq, c).astype(np.float32)
    mask = np.arange(nk)[None] < np.asarray(nvalid)[:, None]
    return xq, xk, mask, k


def _ranges(nk, s):
    """S key ranges, the last one shorter (uneven)."""
    step = -(-nk // s)
    return [(lo, min(lo + step, nk)) for lo in range(0, nk, step)]


def _split_plain(xq, xk, mask, k, s):
    """`knn_plain` over each of S key ranges, indices made global, then
    the plain merge."""
    vals, idx = [], []
    for lo, hi in _ranges(xk.shape[1], s):
        i, _, v = kmod.knn_plain(xq, xk[:, lo:hi].contiguous(), min(k, hi - lo),
                                 mask[:, lo:hi].contiguous())
        vals.append(v)
        idx.append(i + lo)
    return kmod.merge_lists_plain(vals, idx, k, xk.shape[1])


@pytest.mark.parametrize("s", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_merge_of_key_ranges_is_knn_plain(name, s):
    xq, xk, mask, k = _inputs(name)
    tq, tk, tm = torch.tensor(xq), torch.tensor(xk), torch.tensor(mask)
    got = _split_plain(tq, tk, tm, k, s)
    want = kmod.knn_plain(tq, tk, k, tm)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_merge_of_key_ranges_matches_pallas(name, s):
    """Against the Pallas kernel: 0 hard mismatches, identical valid,
    scores within 1e-5, duplicates in index order, and the self-edge
    ``min(i, Nk - 1)`` in every invalid slot."""
    xq, xk, mask, k = _inputs(name)
    if xq.shape[1] == xk.shape[1]:
        pi, pv, ps = knn_pallas(jnp.asarray(xk), k, jnp.asarray(mask), interpret=True,
                                return_scores=True)
    else:
        pi, pv, ps = knn_pallas_cross(jnp.asarray(xq), jnp.asarray(xk), k, jnp.asarray(mask),
                                      interpret=True)
    pi, pv, ps = np.asarray(pi), np.asarray(pv), np.asarray(ps)
    gi, gv, gs = (t.numpy() for t in _split_plain(
        torch.tensor(xq), torch.tensor(xk), torch.tensor(mask), k, s))
    np.testing.assert_array_equal(gv, pv)
    hard, _ = split_mismatches(xq, gi, pi, gv, pv, xk=xk)
    assert hard == 0
    assert tie_order_violations(xk, gi, gv) == 0
    np.testing.assert_allclose(gs[gv], ps[pv], rtol=0, atol=1e-5)
    self_idx = np.broadcast_to(np.minimum(np.arange(xq.shape[1]), xk.shape[1] - 1)[None, :, None],
                               gi.shape)
    assert (~gv).any()
    np.testing.assert_array_equal(gi[~gv], self_idx[~gv])


def test_split_count_fills_the_card():
    """The served batch (4 x 4096: 128 query blocks of 64 key tiles) on an
    H100 SXM (132 SMs, two blocks an SM at k <= 32) splits 2 ways, one
    wave of 256 blocks; the ring's 32,768-query cross form (256 query
    blocks) does not split; at one block an SM (k > 32) 128 blocks are
    one wave already."""
    assert kmod.split_count(128, 64, 264) == 2
    assert kmod.split_count(256, 512, 264) == 1
    assert kmod.split_count(128, 64, 132) == 1


@pytest.mark.parametrize("blocks,tiles,slots", [(1, 3, 264), (24, 11, 264), (7, 100, 264),
                                                (1000, 64, 264), (100, 64, 264)])
def test_split_count_bounds(blocks, tiles, slots):
    """S stays within 1 .. min(MAX_SPLITS, tiles), and no S in that range
    takes fewer waves for a split's share of the keys."""
    s = kmod.split_count(blocks, tiles, slots)
    assert 1 <= s <= min(kmod.MAX_SPLITS, tiles)

    def cost(n):
        return -(-blocks * n // slots) / n

    assert all(cost(s) <= cost(n) for n in range(1, min(kmod.MAX_SPLITS, tiles) + 1))
    assert all(cost(s) < cost(n) for n in range(1, s))


def test_split_override_reaches_the_launch(monkeypatch):
    """`choose_splits` takes the forced S without asking the card."""
    monkeypatch.setattr(kmod, "_splits_override", 4)
    monkeypatch.setattr(kmod, "_lib", lambda: (_ for _ in ()).throw(AssertionError("card asked")))
    assert kmod.choose_splits(4, 4096, 4096, 66, 20, "cuda") == 4
