"""Dynamic kNN graph construction, plain PyTorch oracle (port of
`dgcnn_tpu/ops/knn.py`).

Pairwise squared distances via ``D_ij = |x_i|^2 + |x_j|^2 - 2 x_i.x_j``,
then the ``k`` smallest per query, self included. Masked keys are never
selected; when an event has fewer than ``k`` valid points the missing
slots become self-edges with ``neighbor_valid`` False.

The banded form (`banded_knn_indices`, ``knn_window > 0``) scores each
query only against a window of consecutive positions of Morton-sorted
points.

This is what the model uses on the CPU, as the JAX package does off the
TPU. On CUDA the trainer uses the hand-written kernels
(`kernels.knn_cuda`, `kernels.knn_banded_cuda`) instead, unless
``use_pallas`` is off.
"""

from __future__ import annotations

import numpy as np
import torch

# query rows per distance strip: bounds the (block, N) score and sort
# buffers the way the JAX package's blocked oracle does at N >= 4096
BLOCK_Q = 2048
# query rows per chunk of the banded oracle (the JAX oracle's block_q)
BAND_BLOCK_Q = 1024


def top_k_stable(vals: torch.Tensor, k: int):
    """Top ``k`` along the last axis, ties by value descending then index
    ascending (`jax.lax.top_k`'s order). ``torch.topk`` does not promise
    that order among equal values, so this takes a stable descending
    sort. The results are copies, so the sorted rows do not stay alive
    behind them (a caller keeping many strips' top k of a 131,072-key
    event would otherwise hold every strip's whole sort)."""
    v, i = torch.sort(vals, dim=-1, descending=True, stable=True)
    return v[..., :k].clone(), i[..., :k].clone()


def tie_sort(vals: torch.Tensor, idx: torch.Tensor):
    """Sort each row's candidates by (value desc, index asc), the global
    tie order, whatever order they were gathered in."""
    order1 = torch.argsort(idx, dim=-1, stable=True)
    v1 = torch.gather(vals, -1, order1)
    i1 = torch.gather(idx, -1, order1)
    order2 = torch.argsort(-v1, dim=-1, stable=True)
    return torch.gather(v1, -1, order2), torch.gather(i1, -1, order2)


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


def band_lo(pos, nvalid, window: int):
    """First candidate position of each query's banded window (port of
    `dgcnn_tpu/ops/knn.py::band_lo`).

    The window-defining expression, shared by the banded oracle below and
    the banded kernel's plain version (`kernels.knn_banded_cuda`); the
    CUDA kernel writes the same expression once in ``csrc/knn_banded.cu``.
    A query at sorted position ``pos`` sees the ``window`` consecutive
    positions centred on it, clipped so the window stays inside the valid
    region ``[0, nvalid)`` whenever ``nvalid >= window``.

    ``pos`` and ``nvalid`` are integer tensors that broadcast; returns
    ``lo`` of their broadcast shape; the window is ``[lo, lo + window)``.
    """
    hi = torch.clamp(nvalid - window, min=0)
    return torch.minimum(torch.clamp(pos - window // 2, min=0), hi)


def _banded_select_core(xq_all, sq_all, keys_ext, ksq_ext, km_ext, *, key_base: int,
                        q_base: int, nvalid, k: int, w: int, qb: int):
    """Banded top-k selection, batched over events (port of
    `dgcnn_tpu/ops/knn.py::_banded_select_core`, which is one event under
    ``vmap``).

    Args:
      xq_all: ``(B, NQ, C)`` query rows; query ``r`` sits at global sorted
        position ``q_base + r``. sq_all: ``(B, NQ)`` their ``|x|^2``.
      keys_ext: ``(B, M, C)`` candidate rows; row ``j`` sits at
        ``key_base + j``. ksq_ext, km_ext: ``(B, M)`` their ``|x|^2`` and
        validity. Must cover every chunk's span ``[band_lo(first row),
        ... + w + qb)`` for chunks whose first query is valid.
      nvalid: ``(B,)`` valid points in the whole event.
      k, w, qb: neighbour count, window, query chunk (``NQ % qb == 0``).

    Returns:
      ``vals`` ``(B, NQ, k)`` selected scores (-inf where fewer than ``k``
      in-band valid candidates existed) and ``idx`` ``(B, NQ, k)`` int64
      global sorted positions (meaningless where ``vals`` is -inf).
    """
    b, nq, _ = xq_all.shape
    m = keys_ext.shape[1]
    span = w + qb
    dev = xq_all.device
    offs = torch.arange(span, device=dev)
    vals, idx = [], []
    for s in range(nq // qb):
        rows = q_base + s * qb + torch.arange(qb, device=dev)
        lo = band_lo(rows[None, :], nvalid[:, None], w)  # (B, qb)
        ulo = lo[:, 0]  # lo is monotone non-decreasing in position
        # a dynamic slice: the start clamps so the span fits
        start = torch.clamp(ulo - key_base, 0, m - span)
        cols = start[:, None] + offs  # (B, span)
        keys = torch.gather(keys_ext, 1, cols[..., None].expand(-1, -1, keys_ext.shape[-1]))
        ksq = torch.gather(ksq_ext, 1, cols)
        km = torch.gather(km_ext, 1, cols)
        xq = xq_all[:, s * qb : (s + 1) * qb]
        inner = torch.matmul(xq, keys.transpose(-1, -2))  # (B, qb, span)
        neg = -(sq_all[:, s * qb : (s + 1) * qb, None] + ksq[:, None, :] - 2.0 * inner)
        gcol = (ulo[:, None] + offs)[:, None, :]  # (B, 1, span)
        band = (gcol >= lo[..., None]) & (gcol < (lo + w)[..., None])
        neg = torch.where(band & km[:, None, :], neg, float("-inf"))
        v, c = top_k_stable(neg, k)
        vals.append(v)
        idx.append(ulo[:, None, None] + c)
    return torch.cat(vals, dim=1), torch.cat(idx, dim=1)


def banded_knn_indices(x: torch.Tensor, k: int, mask: torch.Tensor | None = None, *,
                       window: int):
    """Banded kNN over points already in space-filling-curve order, padded
    points last (`ops.sfc.morton_order`; the model sorts once at entry):
    O(N * window) instead of O(N^2). Port of
    `dgcnn_tpu/ops/knn.py::banded_knn_indices`.

    Each query at sorted position ``i`` selects its top ``k`` among the
    ``window`` positions ``[band_lo(i), band_lo(i) + window)``. Same
    return contract as `knn_indices`: ``idx`` int32 and ``neighbor_valid``
    bool, ``(..., N, k)``, ties by lowest index, slots without a valid
    in-band candidate are self-edges with ``neighbor_valid`` False. With
    ``window >= N`` the candidates are every valid point, and at
    ``N <= BAND_BLOCK_Q`` the exact oracle runs instead. Queries go
    ``BAND_BLOCK_Q`` at a time, halved until the chunk divides N.
    """
    n, c = x.shape[-2], x.shape[-1]
    w = min(window, n)
    if w >= n and n <= BAND_BLOCK_Q:
        # degenerate: the band covers everything, use the exact path
        return knn_indices(x, k, mask)
    qb = min(BAND_BLOCK_Q, n)
    while n % qb:
        qb //= 2
    lead = x.shape[:-2]
    xf = x.reshape((-1, n, c))
    b = xf.shape[0]
    if mask is None:
        mf = torch.ones((b, n), dtype=torch.bool, device=x.device)
    else:
        mf = mask.reshape((b, n))
    nvalid = mf.sum(-1)
    sq = torch.sum(torch.square(xf), dim=-1)  # (B, N)
    # pad keys by qb rows so the span slice never clips; padded rows are
    # masked out
    xp = torch.nn.functional.pad(xf, (0, 0, 0, qb))
    sqp = torch.nn.functional.pad(sq, (0, qb))
    mp = torch.nn.functional.pad(mf, (0, qb))
    vals, idx = _banded_select_core(
        xf, sq, xp, sqp, mp, key_base=0, q_base=0, nvalid=nvalid, k=k, w=w, qb=qb
    )
    valid = torch.isfinite(vals)
    self_idx = torch.arange(n, device=x.device)[:, None]
    idx = torch.where(valid, idx, self_idx).to(torch.int32)
    return idx.reshape(lead + (n, k)), valid.reshape(lead + (n, k))


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
    `split_mismatches` counts such a swap as a near tie, this does not.
    Works 65536 queries at a time, so a million-point graph needs no
    ``(B, N, k, C)`` host buffer."""
    rows = 65536
    xk = np.asarray(xk)
    idx, valid = np.asarray(idx), np.asarray(valid)
    e = np.arange(idx.shape[0])[:, None, None]
    total = 0
    for lo in range(0, idx.shape[1], rows):
        a, b = idx[:, lo : lo + rows, :-1], idx[:, lo : lo + rows, 1:]
        both = valid[:, lo : lo + rows, :-1] & valid[:, lo : lo + rows, 1:]
        same = np.all(xk[e, a] == xk[e, b], axis=-1)
        total += int(np.sum(both & same & (a > b)))
    return total


def split_score_mismatches(qa, ka, idx_a, idx_b, valid_a, valid_b, rtol: float = 1e-5,
                           key_offset: int = 0):
    """``(hard, near)`` disagreements between two kNN results that rank
    one set of score operands (`kernels.knn_cuda.build_augmented_operands`,
    e.g. the bf16-rounded ones of ``precision="default"``) and may sum
    them in different orders. A slot where the two pick different keys is a
    near tie when the float64 scores ``qa_i . ka_j`` of the two keys differ
    by at most ``rtol`` times the larger of their sums of absolute terms
    ``sum_c |qa_ic ka_jc|`` (the scale of a sum's rounding error), and hard
    otherwise; any ``valid`` disagreement is hard. The score, not the
    distance: rounded operands rank by their own score, whose ties the
    distances of the unrounded points do not see.

    ``qa`` ``(B, Nq, C2)``, ``ka`` ``(B, Nk, C2)``; the indices ``(B, Nq,
    k)`` are ``key_offset`` plus rows of ``ka``. Accepts numpy arrays or CPU
    tensors.
    """
    qa = np.asarray(qa, dtype=np.float64)
    ka = np.asarray(ka, dtype=np.float64)
    va, vb = np.asarray(valid_a), np.asarray(valid_b)
    ia = np.asarray(idx_a).astype(np.int64) - key_offset
    ib = np.asarray(idx_b).astype(np.int64) - key_offset
    hard = int(np.sum(va != vb))
    b, i, s = np.nonzero((ia != ib) & va & vb)
    if b.size == 0:
        return hard, 0
    q = qa[b, i]
    ta, tb = q * ka[b, ia[b, i, s]], q * ka[b, ib[b, i, s]]
    scale = np.maximum(np.abs(ta).sum(-1), np.abs(tb).sum(-1))
    near_tie = np.abs(ta.sum(-1) - tb.sum(-1)) <= rtol * scale
    return hard + int(np.sum(~near_tie)), int(np.sum(near_tie))


def score_order_violations(scores, idx, valid) -> int:
    """Adjacent valid slots out of the (score descending, index ascending)
    order of the scores a kernel returned: a later slot with a higher
    score, or an equal score and a lower index. Under bf16 operands many
    distinct keys score exactly alike, and only the index rule orders
    them; `tie_order_violations` sees only duplicate rows."""
    s = np.asarray(scores)
    i = np.asarray(idx).astype(np.int64)
    both = np.asarray(valid)[..., :-1] & np.asarray(valid)[..., 1:]
    bad = (s[..., 1:] > s[..., :-1]) | ((s[..., 1:] == s[..., :-1]) & (i[..., 1:] < i[..., :-1]))
    return int(np.sum(both & bad))
