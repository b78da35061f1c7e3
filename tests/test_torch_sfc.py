"""The port's Morton codes and order against the JAX package's, exactly.

Both quantise in f32 with the same op order, so the codes must agree bit
for bit; a flipped quantisation boundary is a fault, not a tolerance.
Inputs are numpy-seeded, with ragged masks, an all-padded event and
garbage in the padded rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.ops.sfc import morton_code as jax_morton_code
from dgcnn_tpu.ops.sfc import morton_order as jax_morton_order
from dgcnn_tpu_torch.ops.sfc import morton_code, morton_order


def _cloud(seed, c, n=300, nvalid=(300, 117, 0), scale=1.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(len(nvalid), n, c) * scale).astype(np.float32)
    mask = np.arange(n)[None] < np.asarray(nvalid)[:, None]
    x[~mask] = 1e6 * rng.randn(int((~mask).sum()), c)  # garbage padding
    return x, mask


@pytest.mark.parametrize("c", [3, 4, 8, 12])
@pytest.mark.parametrize("masked", [True, False])
def test_morton_code_and_order_equal_jax(c, masked):
    for seed, scale in ((c, 1.0), (c + 100, 1e-3), (c + 200, 300.0)):
        x, mask = _cloud(seed, c, scale=scale)
        jm = jnp.asarray(mask) if masked else None
        tm = torch.tensor(mask) if masked else None
        want = np.asarray(jax_morton_code(jnp.asarray(x), jm)).astype(np.int64)
        got = morton_code(torch.tensor(x), tm)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        j_order, j_pos = jax_morton_order(jnp.asarray(x), jm)
        order, pos = morton_order(torch.tensor(x), tm)
        np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
        np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))


def test_morton_code_saturates_at_32_bits_like_jax():
    """One channel gets 32 bits, where the f32 clip bound rounds up to
    2**32; the reference's uint32 conversion saturates there."""
    x, mask = _cloud(5, 1)
    for m in (mask, None):
        want = np.asarray(
            jax_morton_code(jnp.asarray(x), None if m is None else jnp.asarray(m))
        ).astype(np.int64)
        got = morton_code(torch.tensor(x), None if m is None else torch.tensor(m))
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) == 2**32 - 1


def test_morton_order_puts_padding_last_and_inverts():
    x, mask = _cloud(6, 4)
    order, pos = morton_order(torch.tensor(x), torch.tensor(mask))
    iota = np.broadcast_to(np.arange(x.shape[1]), order.shape)
    np.testing.assert_array_equal(np.take_along_axis(order.numpy(), pos.numpy(), -1), iota)
    sorted_mask = np.take_along_axis(mask, order.numpy(), -1)
    assert (np.diff(sorted_mask.astype(int), axis=-1) <= 0).all()
    # garbage in the padded rows never moves a valid point's code
    x2 = x.copy()
    x2[~mask] = -x2[~mask]
    a = morton_code(torch.tensor(x), torch.tensor(mask)).numpy()
    b = morton_code(torch.tensor(x2), torch.tensor(mask)).numpy()
    np.testing.assert_array_equal(a[mask], b[mask])
