"""Dynamic kNN graph construction, plain PyTorch oracle (port of
`dgcnn_tpu/ops/knn.py`).

Pairwise squared distances via ``D_ij = |x_i|^2 + |x_j|^2 - 2 x_i.x_j``,
then the ``k`` smallest per query, self included. Masked keys are never
selected; when an event has fewer than ``k`` valid points the missing
slots become self-edges with ``neighbor_valid`` False.

This is what the model uses on the CPU, as the JAX package does off the
TPU. On CUDA the trainer uses the hand-written kernel
(`kernels.knn_cuda`) instead, unless ``use_pallas`` is off.
"""

from __future__ import annotations

import numpy as np
import torch

# query rows per distance strip: bounds the (block, N) score and sort
# buffers the way the JAX package's blocked oracle does at N >= 4096
BLOCK_Q = 2048


def top_k_stable(vals: torch.Tensor, k: int):
    """Top ``k`` along the last axis, ties by value descending then index
    ascending (`jax.lax.top_k`'s order). ``torch.topk`` does not promise
    that order among equal values, so this takes a stable descending
    sort."""
    v, i = torch.sort(vals, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """``(..., N, C)`` -> ``(..., N, N)`` squared Euclidean distances (up to
    the usual cancellation floor of the matmul identity)."""
    sq = torch.sum(torch.square(x), dim=-1)
    inner = torch.matmul(x, x.transpose(-1, -2))
    return sq[..., :, None] + sq[..., None, :] - 2.0 * inner


def knn_indices(x: torch.Tensor, k: int, mask: torch.Tensor | None = None):
    """Indices of the ``k`` nearest neighbors of every point (self included).

    Args:
      x: ``(..., N, C)`` point features.
      k: neighbor count.
      mask: optional ``(..., N)`` bool; False marks padded points that must
        never be selected as neighbors.

    Returns:
      ``idx`` int32 ``(..., N, k)`` sorted by increasing distance (ties by
      lowest index), and ``neighbor_valid`` bool ``(..., N, k)``.

    Distances are computed ``BLOCK_Q`` query rows at a time; each row's
    expression and selection are row-independent, so the blocking does
    not change results.
    """
    n = x.shape[-2]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, N={n}]")
    sq = torch.sum(torch.square(x), dim=-1)  # (..., N)
    xt = x.transpose(-1, -2)
    vals, idx = [], []
    for lo in range(0, n, BLOCK_Q):
        hi = min(lo + BLOCK_Q, n)
        inner = torch.matmul(x[..., lo:hi, :], xt)
        d = sq[..., lo:hi, None] + sq[..., None, :] - 2.0 * inner
        neg = -d
        if mask is not None:
            neg = neg.masked_fill(~mask[..., None, :], float("-inf"))
        v, i = top_k_stable(neg, k)
        vals.append(v)
        idx.append(i)
    vals = torch.cat(vals, dim=-2)
    idx = torch.cat(idx, dim=-2).to(torch.int32)
    neighbor_valid = torch.isfinite(vals)
    self_idx = torch.arange(n, dtype=torch.int32, device=x.device)[:, None]
    return torch.where(neighbor_valid, idx, self_idx), neighbor_valid


def split_mismatches(x, idx_a, idx_b, valid_a, valid_b, rtol: float = 1e-6,
                     xk=None):
    """``(hard, near)`` disagreements between two kNN results.

    The rule of the JAX package's hardware gate
    (`benchmarks/tpu_gate.py::_split_mismatches`): a slot where the two
    pick different keys is a near tie when the two keys' float64 squared
    distances to the query differ by at most ``rtol`` relative (the two
    score expressions may order 1-ulp near ties oppositely), and hard
    otherwise. Any ``valid`` disagreement is hard.

    ``x`` ``(B, Nq, C)`` queries, ``xk`` ``(B, Nk, C)`` keys (default
    ``x``); the other arrays ``(B, Nq, k)``. Accepts numpy arrays or CPU
    tensors.
    """
    x = np.asarray(x, dtype=np.float64)
    xk = x if xk is None else np.asarray(xk, dtype=np.float64)
    va, vb = np.asarray(valid_a), np.asarray(valid_b)
    ia, ib = np.asarray(idx_a), np.asarray(idx_b)
    hard = int(np.sum(va != vb))
    b, i, s = np.nonzero((ia != ib) & (va == vb))
    if b.size == 0:
        return hard, 0
    xi = x[b, i]
    da = np.sum((xi - xk[b, ia[b, i, s]]) ** 2, axis=-1)
    db = np.sum((xi - xk[b, ib[b, i, s]]) ** 2, axis=-1)
    near_tie = np.abs(da - db) <= rtol * np.maximum(np.maximum(da, db), 1e-12)
    return hard + int(np.sum(~near_tie)), int(np.sum(near_tie))


def tie_order_violations(xk, idx, valid) -> int:
    """Adjacent valid slots holding exact duplicate key rows in descending
    index order. Identical rows score identically, so the tie rule (value
    descending, then index ascending) must list them by ascending index;
    `split_mismatches` counts such a swap as a near tie, this does not."""
    xk = np.asarray(xk)
    idx, valid = np.asarray(idx), np.asarray(valid)
    a, b = idx[..., :-1], idx[..., 1:]
    both = valid[..., :-1] & valid[..., 1:]
    e = np.arange(idx.shape[0])[:, None, None]
    same = np.all(xk[e, a] == xk[e, b], axis=-1)
    return int(np.sum(both & same & (a > b)))
