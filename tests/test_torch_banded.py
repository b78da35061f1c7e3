"""The port's banded kNN against the JAX package: `band_lo` and the banded
oracle against `dgcnn_tpu.ops.knn`, and the kernel's plain version
`knn_banded_plain` (self and cross forms) against the Pallas banded kernel
in interpret mode. The CUDA kernel itself is held against
`knn_banded_plain` on the card by `tests/test_torch_cuda.py`, and timed
by `kernel_times.py` (rows 2 and 2D).

The two sides score with different float expressions or contraction
orders, so 1-ulp near ties may order oppositely: the gate is identical
``valid`` flags and zero hard mismatches (`ops.knn.split_mismatches`),
and near ties are reported. Points are Morton-sorted with padded points
last, as the model hands them to the graph build.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.kernels.knn_banded import knn_pallas_banded, knn_pallas_banded_cross
from dgcnn_tpu.ops.knn import band_lo as jax_band_lo
from dgcnn_tpu.ops.knn import banded_knn_indices as jax_banded
from dgcnn_tpu_torch.kernels import knn_banded_cuda as bmod
from dgcnn_tpu_torch.kernels.knn_banded_cuda import (
    knn_banded_cuda,
    knn_banded_cuda_cross,
    knn_banded_plain,
)
from dgcnn_tpu_torch.kernels.knn_cuda import knn_plain
from dgcnn_tpu_torch.ops.knn import (
    band_lo,
    banded_knn_indices,
    split_mismatches,
    tie_order_violations,
)
from dgcnn_tpu_torch.ops.sfc import morton_order

HI = jax.lax.Precision.HIGHEST


def _sorted_cloud(seed, b, n, c, nvalid):
    """Morton-sorted random points, padded last, with duplicated rows."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, c).astype(np.float32)
    for e in range(b):
        src = rng.choice(n, 8, replace=False)
        dst = rng.choice(n, 8, replace=False)
        x[e, dst] = x[e, src]
    mask = np.arange(n)[None] < np.asarray(nvalid)[:, None]
    order = morton_order(torch.tensor(x), torch.tensor(mask))[0].numpy()
    return np.take_along_axis(x, order[..., None], 1), np.take_along_axis(mask, order, 1)


def _assert_same_graph(x, idx_a, idx_b, valid_a, valid_b, xk=None):
    """``idx_a``/``valid_a`` are the port's."""
    np.testing.assert_array_equal(np.asarray(valid_a), np.asarray(valid_b))
    hard, near = split_mismatches(x, idx_a, idx_b, valid_a, valid_b, xk=xk)
    print(f"hard mismatches {hard}, near ties {near} of {np.asarray(idx_a).size} slots")
    assert hard == 0
    assert tie_order_violations(x if xk is None else xk, idx_a, valid_a) == 0


def test_band_lo_matches_jax():
    pos = np.arange(-3, 300)
    for nvalid in (0, 5, 64, 100, 300):
        for window in (1, 20, 64, 257):
            want = np.asarray(jax_band_lo(jnp.asarray(pos, jnp.int32), jnp.int32(nvalid), window))
            got = band_lo(torch.tensor(pos), torch.tensor(nvalid), window)
            np.testing.assert_array_equal(got.numpy(), want)


ORACLE_CASES = {
    "window_below_n": dict(n=512, c=4, k=20, w=128, nvalid=(512, 300)),
    "window_covers_n_exact_shortcut": dict(n=384, c=4, k=8, w=384, nvalid=(384, 100)),
    "nvalid_below_window": dict(n=512, c=8, k=12, w=256, nvalid=(512, 90)),
    "nvalid_below_k": dict(n=256, c=3, k=16, w=64, nvalid=(9, 0)),
    "n_not_power_of_two": dict(n=1100, c=4, k=10, w=96, nvalid=(1100, 777)),
}


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_banded_oracle_matches_jax(name):
    cfg = ORACLE_CASES[name]
    x, mask = _sorted_cloud(len(name), 2, cfg["n"], cfg["c"], cfg["nvalid"])
    want = jax_banded(jnp.asarray(x), cfg["k"], jnp.asarray(mask), window=cfg["w"], precision=HI)
    idx, valid = banded_knn_indices(torch.tensor(x), cfg["k"], torch.tensor(mask), window=cfg["w"])
    assert idx.dtype == torch.int32 and valid.dtype == torch.bool
    _assert_same_graph(x, idx, want[0], valid, want[1])


def test_banded_oracle_without_mask_and_batch_dims():
    x, _ = _sorted_cloud(3, 2, 640, 4, (640, 640))
    want = jax_banded(jnp.asarray(x), 8, None, window=200, precision=HI)
    idx, valid = banded_knn_indices(torch.tensor(x), 8, None, window=200)
    _assert_same_graph(x, idx, want[0], valid, want[1])
    one = banded_knn_indices(torch.tensor(x[0]), 8, None, window=200)
    assert torch.equal(one[0], idx[0]) and torch.equal(one[1], valid[0])


PLAIN_CASES = {
    "one_tile": dict(n=512, c=4, k=20, w=128, nvalid=(512, 341), block_t=1024),
    "several_tiles": dict(n=1024, c=4, k=16, w=512, nvalid=(1024, 700), block_t=256),
    "wide_ragged": dict(n=640, c=16, k=8, w=96, nvalid=(640, 5), block_t=256),
    "window_covers_n_empty_event": dict(n=384, c=3, k=20, w=384, nvalid=(384, 0), block_t=1024),
}


@pytest.mark.parametrize("name", sorted(PLAIN_CASES))
def test_knn_banded_plain_matches_pallas(name):
    cfg = PLAIN_CASES[name]
    x, mask = _sorted_cloud(len(name) + 10, 2, cfg["n"], cfg["c"], cfg["nvalid"])
    ip, vp = knn_pallas_banded(
        jnp.asarray(x), cfg["k"], jnp.asarray(mask), window=cfg["w"], interpret=True,
        block_t=cfg["block_t"],
    )
    idx, valid, scores = knn_banded_plain(
        torch.tensor(x), torch.tensor(x), cfg["k"], torch.tensor(mask), window=cfg["w"]
    )
    _assert_same_graph(x, idx, ip, valid, vp)
    s = scores.numpy()
    assert (np.diff(s, axis=-1) <= 0).all()
    assert (s[~valid.numpy()] <= -1e29).all()
    self_idx = np.broadcast_to(np.arange(cfg["n"])[None, :, None], idx.shape)
    assert (idx.numpy()[~valid.numpy()] == self_idx[~valid.numpy()]).all()


@pytest.mark.parametrize("shard", [(0, 256), (256, 512), (768, 1024)])
def test_knn_banded_plain_cross_matches_pallas_cross(shard):
    """A halo-shaped slice: the shard's queries against its rows plus
    ``w`` rows each side, at their global positions."""
    n, c, k, w = 1024, 8, 12, 128
    x, mask = _sorted_cloud(shard[0] + 1, 2, n, c, (n, 600))
    nvalid = mask.sum(-1).astype(np.int32)
    s0, s1 = shard
    kb, ke = max(s0 - w, 0), min(s1 + w, n)
    xq, xk, mk = x[:, s0:s1], x[:, kb:ke], mask[:, kb:ke]
    ip, vp = knn_pallas_banded_cross(
        jnp.asarray(xq), jnp.asarray(xk), k, jnp.asarray(mk), window=w, q_base=s0,
        key_base=kb, nvalid=jnp.asarray(nvalid), interpret=True, block_t=128,
    )
    idx, valid, _ = knn_banded_cuda_cross(
        torch.tensor(xq), torch.tensor(xk), k, torch.tensor(mk), window=w, q_base=s0,
        key_base=kb, nvalid=torch.tensor(nvalid),
    )
    # padded-query rows of the cross form are garbage by contract
    q_ok = mask[:, s0:s1]
    _assert_same_graph(
        x, np.where(q_ok[..., None], idx.numpy(), 0), np.where(q_ok[..., None], np.asarray(ip), 0),
        valid.numpy() & q_ok[..., None], np.asarray(vp) & q_ok[..., None],
    )
    # the same rows of the single-device form, in global positions
    full = knn_banded_plain(torch.tensor(x), torch.tensor(x), k, torch.tensor(mask), window=w)
    np.testing.assert_array_equal(idx.numpy()[q_ok], full[0].numpy()[:, s0:s1][q_ok])


def test_knn_banded_cuda_on_cpu_is_knn_banded_plain():
    """A CPU tensor takes the plain version and launches nothing."""
    x, mask = _sorted_cloud(21, 2, 512, 4, (512, 200))
    xt, mt = torch.tensor(x), torch.tensor(mask)
    before = bmod.launches
    got = knn_banded_cuda(xt, 10, mt, window=64, return_scores=True)
    ref = knn_banded_plain(xt, xt, 10, mt, window=64)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert [torch.equal(a, b) for a, b in zip(knn_banded_cuda(xt, 10, mt, window=64), ref)] == [True, True]
    # the self form clips the window to N
    big = knn_banded_cuda(xt, 10, mt, window=10**6)
    assert torch.equal(big[0], knn_banded_plain(xt, xt, 10, mt, window=512)[0])
    assert bmod.launches == before


def test_knn_banded_plain_full_window_is_the_exact_graph():
    """With window >= N every valid key is a candidate: the exact
    kernel's plain version gives the same graph."""
    x, mask = _sorted_cloud(22, 2, 384, 4, (384, 150))
    xt, mt = torch.tensor(x), torch.tensor(mask)
    banded = knn_banded_plain(xt, xt, 20, mt, window=384)
    exact = knn_plain(xt, xt, 20, mt)
    for a, b in zip(banded, exact):
        assert torch.equal(a, b)


@pytest.mark.parametrize(
    "bad",
    ["float64", "noncontiguous", "mask_shape", "k_above_window", "k_too_big", "nvalid_shape",
     "negative_base"],
)
def test_banded_kernel_wrapper_refuses_bad_inputs(bad):
    """The launcher checks dtype, shape, contiguity, k, the window and the
    bases before it builds or launches anything."""
    x = torch.randn(2, 96, 4)
    xk, mask, k, window, nvalid, q_base = x, None, 8, 32, None, 0
    if bad == "float64":
        x = xk = x.double()
    elif bad == "noncontiguous":
        x = xk = torch.randn(2, 4, 96).transpose(1, 2)
    elif bad == "mask_shape":
        mask = torch.ones(2, 95, dtype=torch.bool)
    elif bad == "k_above_window":
        window = 7
    elif bad == "k_too_big":
        # any k up to min(Nk, window) runs (in passes past KMAX); past Nk it
        # is refused
        x = xk = torch.randn(1, 200, 4)
        k, window = 201, 256
    elif bad == "nvalid_shape":
        nvalid = torch.full((3,), 96, dtype=torch.int32)
    elif bad == "negative_base":
        q_base = -1
    with pytest.raises(ValueError):
        bmod._launch(x, xk, k, mask, window=window, q_base=q_base, key_base=0, nvalid=nvalid)
