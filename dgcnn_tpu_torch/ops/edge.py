"""Edge features and the EdgeConv block reductions (port of
`dgcnn_tpu/ops/edge.py`).

The factorized pre-activation: with the block weight ``W = [Wa; Wb]``
acting on ``concat(x_i, x_j - x_i)``, ``h_ij = P_i + Q_j`` where
``P = x @ (Wa - Wb)`` and ``Q = x @ Wb``, so the matmul runs once per point
instead of once per edge.

- `edgeconv_block_reduced`: ``max_k(relu(bn(P_i + Q_j)))`` from the
  per-query neighbour max/min of ``Q`` (the BN + relu chain is monotone
  per channel) and, in train mode, BN statistics factored over the edge
  sum. Its backward is autograd through the gather and ``amax``/``amin``.
  Past ``SLOT_STREAM_ELEMS`` gather elements its eval streams one
  neighbour slot at a time (`_maxmin_streamed`), so no ``(N, k, D)``
  gather exists.
- `GatheredStats`: the same reductions as one ``torch.autograd.Function``
  whose backward does no gather: k slot-wise ``index_add_`` scatters of
  ``C + 1`` channels (port of the JAX ``gathered_stats`` custom VJP).
- `edgeconv_block_fused`: eval is the reduced block; train runs
  `GatheredStats` and `ops.norm.finalize_batch_stats`.

Plain PyTorch: the JAX package writes these as jnp code with a custom VJP,
not as Pallas kernels.
"""

from __future__ import annotations

import math

import torch

from dgcnn_tpu_torch.ops.norm import EPS, finalize_batch_stats

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


def edgeconv_block_reduced(p, q, bn_params, bn_state, idx, mask=None, *, train: bool = False,
                           momentum: float = 0.9, eps: float = EPS, gather_fn=None,
                           group=None):
    """EdgeConv block ``max_k(relu(bn(P_i + Q_j)))`` without the per-edge
    tensor.

    Per channel, ``t -> relu((t - mean) * gamma / sigma + beta)`` is monotone
    nondecreasing where ``gamma >= 0`` and nonincreasing elsewhere, so the
    max over neighbors of the chain is the chain applied to
    ``P_i + M_i`` with ``M_i = max_j Q_j`` (``gamma >= 0``) or ``min_j Q_j``.
    The chain below is the exact op order of `ops.norm.batch_norm_apply`,
    so in eval the result equals the materializing form bit for bit. In
    train mode the BN batch statistics factor over the edge sum, with
    ``SQ_i = sum_j Q_j`` and ``SQ2_i = sum_j Q_j^2`` over ``i``'s
    neighbours: ``s1 = k sum P w + sum SQ w``, ``s2 = k sum P^2 w +
    2 sum P SQ w + sum SQ2 w``, ``count = k sum w``.

    Args:
      p, q: ``(..., N, D)`` query- and neighbor-side pre-activations.
      bn_params: ``{"scale", "bias"}``; bn_state: ``{"mean", "var"}``.
      idx: ``(..., N, k)`` neighbor indices into ``q``'s rows. Under
        context parallelism ``q`` may be the extended operand (every
        rank's rows, ``(B, N, D)``) and ``idx`` the rank's ``(B, N/P, k)``
        global indices; the slot-stream threshold counts the local
        ``idx`` rows, as the JAX package does.
      mask: ``(..., N)`` bool query validity or None; invalid rows are
        left out of the batch statistics (their outputs are still
        produced).
      train: masked batch statistics and the running-average update;
        eval uses the running statistics.
      gather_fn: neighbour gather override ``(q, idx) -> (..., N, k, D)``
        (`kernels.ring_knn.ring_gather` under context parallelism); it
        keeps the dense traversal at any size, as in the JAX package.
      group: sync BN: the train statistics merge over this axis of the
        rank group (`ops.norm.finalize_batch_stats`).

    Returns:
      ``(y float32 (..., N, D), new_bn_state)``.
    """
    gamma = bn_params["scale"].float()
    beta = bn_params["bias"].float()
    p = p.float()
    qf = q.float()
    k = idx.shape[-1]
    if (not train and gather_fn is None
            and idx.shape[-2] * k * q.shape[-1] >= SLOT_STREAM_ELEMS):
        # huge-N eval: two (..., N, D) carries instead of the gather
        mx, mn = _maxmin_streamed(qf, idx)
    else:
        g = (gather_fn or gather_neighbors)(qf, idx)  # (..., N, k, D)
        mx, mn = g.amax(dim=-2), g.amin(dim=-2)
    if train:
        w = None if mask is None else mask.float()
        _, s1p, s2a, s2b = _neighbour_sums(p, g, w)
        mean, var, new_state = _edge_batch_stats(p, k, w, s1p, s2a, s2b, bn_state, momentum,
                                                 group)
    else:
        mean, var, new_state = bn_state["mean"], bn_state["var"], bn_state
    m = torch.where(gamma >= 0, mx, mn)
    y = torch.relu((p + m - mean) * torch.rsqrt(var + eps) * gamma + beta)
    return y, new_state


def _neighbour_sums(p, g, w):
    """``(SQ, s1p, s2a, s2b)`` of the gathered neighbours ``g`` ``(..., N,
    k, C)``: ``SQ_i = sum_s g_is`` and, over the rows weighted by ``w``
    (``(..., N)`` or None for all), ``s1p = sum_i w_i SQ_i``, ``s2a =
    sum_i w_i sum_s g_is^2``, ``s2b = sum_i w_i p_i SQ_i``."""
    axes = tuple(range(p.dim() - 1))
    sq = g.sum(dim=-2)
    sq2 = torch.square(g).sum(dim=-2)
    if w is None:
        return sq, sq.sum(dim=axes), sq2.sum(dim=axes), (p * sq).sum(dim=axes)
    wc = w[..., None]
    return sq, (sq * wc).sum(dim=axes), (sq2 * wc).sum(dim=axes), (p * sq * wc).sum(dim=axes)


def _edge_batch_stats(p, k: int, w, s1p, s2a, s2b, bn_state, momentum: float, group=None):
    """The BN batch statistics of every row's k edges ``P_i + Q_j`` from
    the query side and `_neighbour_sums`: ``s1 = k sum P w + s1p``, ``s2 =
    k sum P^2 w + 2 s2b + s2a``, ``count = k sum w``; ``(mean, var,
    new_state)`` of `ops.norm.finalize_batch_stats`, merged over ``group``
    there. The merge sits outside `GatheredStats`, whose backward stays
    local (the JAX package's psums outside its custom VJP): summing
    there too would count the other ranks' cotangents twice."""
    axes = tuple(range(p.dim() - 1))
    c = p.shape[-1]
    if w is None:
        count = torch.full((c,), k * float(math.prod(p.shape[:-1])), device=p.device)
        s1 = k * torch.sum(p, dim=axes) + s1p
        s2 = k * torch.sum(torch.square(p), dim=axes) + 2.0 * s2b + s2a
    else:
        wc = w[..., None]
        count = (k * torch.sum(w)).expand(c)
        s1 = k * torch.sum(p * wc, dim=axes) + s1p
        s2 = k * torch.sum(torch.square(p) * wc, dim=axes) + 2.0 * s2b + s2a
    return finalize_batch_stats(count, s1, s2, bn_state, momentum=momentum, group=group)


def _winner_dtype(k: int):
    """Winning slots lie in ``[0, k)``: stored as uint8 up to k = 255."""
    return torch.uint8 if k <= 255 else torch.int32


class GatheredStats(torch.autograd.Function):
    """EdgeConv reduction core with a backward that does no gather (port of
    `dgcnn_tpu/ops/edge.py::gathered_stats`).

    ``apply(p, q, idx, w, gsign)``: one gather of ``g = q[idx]``
    ``(..., N, k, C)`` gives

    - ``m`` ``(..., N, C)``: the neighbour max of ``q`` where ``gsign``
      (``gamma >= 0``, ``(C,)`` bool) is True, the min elsewhere: the
      winning pre-activation of the monotone BN + relu chain;
    - ``s1p = sum_i w_i sum_s g_is``, ``s2a = sum_i w_i sum_s g_is^2`` and
      ``s2b = sum_i w_i p_i sum_s g_is``, each ``(C,)``.

    ``w`` is the ``(..., N)`` float query-validity weight or None; ``idx``,
    ``w`` and ``gsign`` get no gradient. ``q`` may hold more rows than
    ``p`` and ``idx`` (an extended neighbour operand).

    The forward keeps the winning slot of each ``(row, channel)`` as uint8
    (first winner on a tie: strict compares, as ``jnp.argmax``, so the whole
    cotangent goes to it, where autograd of ``amax`` would split it). The
    backward builds each slot's update ``[stat w + onehot(slot) dm, w]``,
    ``stat = ds1p + ds2b p``, and adds it into the slot's neighbour rows
    with ``index_add_``: k scatters of ``C + 1`` channels, the last one the
    masked in-degree, which carries ``dq += 2 q ds2a deg``; ``dp = ds2b sq
    w``. Peak memory of the backward is ``O(N C)``.
    """

    @staticmethod
    def forward(ctx, p, q, idx, w, gsign):
        k, c, ni = idx.shape[-1], q.shape[-1], idx.shape[-2]
        if ni * k * c >= SLOT_STREAM_ELEMS:
            raise NotImplementedError(
                "the slot-streamed train forward of the fused EdgeConv block is not ported "
                "yet (ROADMAP queue 1, item 11)")
        g = gather_neighbors(q, idx)  # (..., N, k, C)
        mx, ax = g.max(dim=-2)  # the first winning slot on a tie
        mn, an = g.min(dim=-2)
        sq, s1p, s2a, s2b = _neighbour_sums(p, g, w)
        m = torch.where(gsign, mx, mn)
        aw = torch.where(gsign, ax, an).to(_winner_dtype(k))
        ctx.save_for_backward(p, q, idx, w, aw, sq)
        return m, s1p, s2a, s2b

    @staticmethod
    def backward(ctx, dm, ds1p, ds2a, ds2b):
        p, q, idx, w, aw, sq = ctx.saved_tensors
        c, nq = q.shape[-1], q.shape[-2]
        ni, k = idx.shape[-2], idx.shape[-1]
        lead = idx.shape[:-2]
        bl = math.prod(lead)
        stat = ds1p + ds2b * p  # (..., N, C)
        wrow = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device) if w is None else w
        # the slot-invariant part of every update: [stat w, w]
        base = torch.cat([stat * wrow[..., None], wrow[..., None]], dim=-1).reshape(bl, ni, c + 1)
        dm2 = dm.reshape(bl, ni, c)
        aw2 = aw.reshape(bl, ni, c)
        # rows of the flattened (bl * nq, C + 1) accumulator
        rows = (idx.reshape(bl, ni, k).long()
                + nq * torch.arange(bl, device=idx.device)[:, None, None])
        acc = torch.zeros((bl * nq, c + 1), dtype=p.dtype, device=p.device)
        pad = torch.zeros((bl, ni, 1), dtype=p.dtype, device=p.device)
        for s in range(k):
            win = torch.where(aw2 == s, dm2, 0.0)
            upd = base + torch.cat([win, pad], dim=-1)
            acc.index_add_(0, rows[..., s].reshape(-1), upd.reshape(-1, c + 1))
        scat = acc.reshape(*lead, nq, c + 1)
        # destination-side q^2 term, weighted by the masked in-degree
        dq = scat[..., :c] + 2.0 * q * ds2a * scat[..., c:]
        dp = ds2b * sq * wrow[..., None]
        return dp, dq, None, None, None


def edgeconv_block_fused(p, q, bn_params, bn_state, idx, mask=None, *, train: bool = False,
                         momentum: float = 0.9, eps: float = EPS, group=None):
    """`edgeconv_block_reduced` with the `GatheredStats` core: the same
    forward, and a backward of k slot-wise scatters with no gather. Eval
    is the reduced block itself. Local gathers only (``q`` may be an
    extended operand with ``idx`` localized into it); ``group`` merges
    the train statistics (sync BN). Returns ``(y float32,
    new_bn_state)``."""
    if not train:
        return edgeconv_block_reduced(p, q, bn_params, bn_state, idx, mask, train=False,
                                      momentum=momentum, eps=eps)
    gamma = bn_params["scale"].float()
    beta = bn_params["bias"].float()
    p = p.float()
    w = None if mask is None else mask.float()
    m, s1p, s2a, s2b = GatheredStats.apply(p, q.float(), idx, w, gamma >= 0)
    mean, var, new_state = _edge_batch_stats(p, idx.shape[-1], w, s1p, s2a, s2b, bn_state,
                                             momentum, group)
    y = torch.relu((p + m - mean) * torch.rsqrt(var + eps) * gamma + beta)
    return y, new_state


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
