"""Edge features and the eval-mode EdgeConv reduction (port of
`dgcnn_tpu/ops/edge.py`).

The factorized pre-activation: with the block weight ``W = [Wa; Wb]``
acting on ``concat(x_i, x_j - x_i)``, ``h_ij = P_i + Q_j`` where
``P = x @ (Wa - Wb)`` and ``Q = x @ Wb``, so the matmul runs once per point
instead of once per edge.

In eval mode the JAX package's ``fused`` and ``reduced`` block forms are
the same computation (`edgeconv_block_fused` calls
`edgeconv_block_reduced` when ``train`` is False), so the port has one
function for both. Past ``SLOT_STREAM_ELEMS`` gather elements it streams
one neighbour slot at a time (`_maxmin_streamed`), so no ``(N, k, D)``
gather exists.
"""

from __future__ import annotations

import torch

from dgcnn_tpu_torch.ops.norm import EPS

# per-event gather elements (N * k * D) at or above which the JAX package
# streams the eval reduction one neighbor slot at a time
# (`ops/edge.py:142-157`)
SLOT_STREAM_ELEMS = 2**27


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j, :] = x[..., idx[..., i, j], :]``.

    ``x`` ``(..., N, C)``, ``idx`` ``(..., N, k)`` -> ``(..., N, k, C)``.
    """
    n, k = idx.shape[-2], idx.shape[-1]
    flat = idx.reshape(idx.shape[:-2] + (n * k, 1)).long()
    out = torch.gather(x, -2, flat.expand(flat.shape[:-1] + (x.shape[-1],)))
    return out.reshape(idx.shape + (x.shape[-1],))


def edge_features(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The reference's edge feature ``concat(x_i, x_j - x_i)``,
    ``(..., N, k, 2C)``. The model never builds it; tests use it as the
    oracle of the factorized form."""
    xj = gather_neighbors(x, idx)
    xi = x[..., :, None, :].expand(xj.shape)
    return torch.cat([xi, xj - xi], dim=-1)


def edgeconv_block_reduced(p, q, bn_params, bn_state, idx, *, eps: float = EPS,
                           gather_fn=None):
    """Eval-mode EdgeConv block ``max_k(relu(bn(P_i + Q_j)))`` without the
    per-edge BN.

    Per channel, ``t -> relu((t - mean) * gamma / sigma + beta)`` is monotone
    nondecreasing where ``gamma >= 0`` and nonincreasing elsewhere, so the
    max over neighbors of the chain is the chain applied to
    ``P_i + M_i`` with ``M_i = max_j Q_j`` (``gamma >= 0``) or ``min_j Q_j``.
    The chain below is the exact op order of `ops.norm.batch_norm_apply`,
    so the result equals the materializing form bit for bit.

    Args:
      p, q: ``(..., N, D)`` query- and neighbor-side pre-activations.
      bn_params: ``{"scale", "bias"}``; bn_state: ``{"mean", "var"}``.
      idx: ``(..., N, k)`` neighbor indices into ``q``'s rows. Under
        context parallelism ``q`` may be the extended operand (every
        rank's rows, ``(B, N, D)``) and ``idx`` the rank's ``(B, N/P, k)``
        global indices; the slot-stream threshold counts the local
        ``idx`` rows, as the JAX package does.
      gather_fn: neighbour gather override ``(q, idx) -> (..., N, k, D)``
        (`kernels.ring_knn.ring_gather` under context parallelism); it
        keeps the dense traversal at any size, as in the JAX package.

    Returns:
      float32 ``(..., N, D)``.
    """
    gamma = bn_params["scale"].float()
    beta = bn_params["bias"].float()
    qf = q.float()
    if gather_fn is None and idx.shape[-2] * idx.shape[-1] * q.shape[-1] >= SLOT_STREAM_ELEMS:
        # huge-N eval: two (..., N, D) carries instead of the gather
        mx, mn = _maxmin_streamed(qf, idx)
    else:
        g = (gather_fn or gather_neighbors)(qf, idx)  # (..., N, k, D)
        mx, mn = g.amax(dim=-2), g.amin(dim=-2)
    m = torch.where(gamma >= 0, mx, mn)
    return torch.relu(
        (p.float() + m - bn_state["mean"])
        * torch.rsqrt(bn_state["var"] + eps)
        * gamma
        + beta
    )


def _maxmin_streamed(q: torch.Tensor, idx: torch.Tensor):
    """Per-query neighbour max and min of ``q[idx]``, one slot at a time
    (port of `dgcnn_tpu/ops/edge.py::_maxmin_streamed`). Max and min are
    exact, so folding the slots in order gives the dense
    ``amax``/``amin`` bit for bit."""
    def slot(s):
        rows = idx[..., s : s + 1].long()  # (..., N, 1)
        return torch.gather(q, -2, rows.expand(rows.shape[:-1] + (q.shape[-1],)))

    mx = slot(0)
    mn = mx.clone()
    for s in range(1, idx.shape[-1]):
        g = slot(s)
        torch.maximum(mx, g, out=mx)  # in place: the carries are (..., N, D)
        torch.minimum(mn, g, out=mn)
    return mx, mn
