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
  ``C + 1`` channels (port of the JAX ``gathered_stats`` custom VJP). Past
  ``SLOT_STREAM_ELEMS`` its forward too streams one slot at a time
  (`_stats_streamed`), with ``(..., N, C)`` carries.
- `edgeconv_block_fused`: eval is the reduced block; train runs
  `GatheredStats` and `ops.norm.finalize_batch_stats`.
- `edgeconv_block_fused_mlp`: an f32 block of MLP depth 2 in training
  (BN1, relu, the stacked conv, BN2, relu and the max over the edges)
  through two ``torch.autograd.Function``s, `EdgeStats` (BN1's sums) and
  `EdgeMLP` (the stacked conv, BN2's sums and the max), with BN's
  finalisation between and after them. On CUDA tensors their four passes
  are the hand-written kernels of `kernels.edge_mlp_cuda`, which never
  write an ``(N, k, C)`` tensor; on the CPU the plain versions below
  (``_mlp_*_plain``), which materialise it.

Plain PyTorch apart from that block's kernels: the JAX package writes these
as jnp code with a custom VJP, not as Pallas kernels.
"""

from __future__ import annotations

import math

import types

import torch

from dgcnn_tpu_torch.kernels import edge_mlp_cuda
from dgcnn_tpu_torch.ops.norm import EPS, batch_sums, finalize_batch_stats
from dgcnn_tpu_torch.utils.timing import span

# per-event gather elements (N * k * D) at or above which the JAX package
# streams the eval reduction and the fused train forward one neighbor slot
# at a time (`ops/edge.py:142-157`, `:272`)
SLOT_STREAM_ELEMS = 2**27

# forwards of `GatheredStats` that streamed, so a run can show the
# streamed train forward served it
stream_runs = 0


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


def edge_preact_factorized(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor | None = None) -> torch.Tensor:
    """Factorized edge pre-activation ``h_ij = P_i + Q_j (+ b)``, ``P = x
    (W_a - W_b)``, ``Q = x W_b``: ``x`` ``(..., N, C)``, ``idx`` ``(..., N,
    k)``, ``w`` ``(2C, D)`` laid out over ``concat(x_i, x_j - x_i)`` (rows
    ``[:C]`` act on ``x_i``), ``b`` ``(D,)`` or None. Returns ``(..., N, k,
    D)``, equal to ``edge_features(x, idx) @ w + b`` up to rounding. The
    model inlines it (`Model._block`) to choose the gather."""
    c = x.shape[-1]
    wa, wb = w[:c], w[c:]
    h = torch.matmul(x, wa - wb)[..., :, None, :] + gather_neighbors(torch.matmul(x, wb), idx)
    return h if b is None else h + b


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
    s2a = sq2.sum(dim=axes) if w is None else (sq2 * w[..., None]).sum(dim=axes)
    s1p, s2b = _query_sums(p, sq, w)
    return sq, s1p, s2a, s2b


def _query_sums(p, sq, w):
    """``(s1p, s2b)`` from the per-row neighbour sums ``sq``: ``s1p =
    sum_i w_i SQ_i`` and ``s2b = sum_i w_i p_i SQ_i``, the one expression
    of both forward traversals."""
    axes = tuple(range(p.dim() - 1))
    if w is None:
        return sq.sum(dim=axes), (p * sq).sum(dim=axes)
    wc = w[..., None]
    return (sq * wc).sum(dim=axes), (p * sq * wc).sum(dim=axes)


def _edge_batch_stats(p, k: int, w, s1p, s2a, s2b, bn_state, momentum: float, group=None):
    """The BN batch statistics of every row's k edges ``P_i + Q_j`` from
    the query side and `_neighbour_sums`: ``s1 = k sum P w + s1p``, ``s2 =
    k sum P^2 w + 2 s2b + s2a``, ``count = k sum w``; ``(mean, var,
    new_state)`` of `ops.norm.finalize_batch_stats`, merged over ``group``
    there. The merge sits outside `GatheredStats`, whose backward stays
    local (the JAX package's psums outside its custom VJP): summing
    there too would count the other ranks' cotangents twice."""
    axes = tuple(range(p.dim() - 1))
    count = _edge_count(p, k, w)
    if w is None:
        s1 = k * torch.sum(p, dim=axes) + s1p
        s2 = k * torch.sum(torch.square(p), dim=axes) + 2.0 * s2b + s2a
    else:
        wc = w[..., None]
        s1 = k * torch.sum(p * wc, dim=axes) + s1p
        s2 = k * torch.sum(torch.square(p) * wc, dim=axes) + 2.0 * s2b + s2a
    return finalize_batch_stats(count, s1, s2, bn_state, momentum=momentum, group=group)


def _edge_count(p, k: int, w):
    """BN's count of every row's k edges, ``(C,)``: ``k sum w`` (every row
    for ``w`` None), the value the edge form's masked count takes."""
    c = p.shape[-1]
    if w is None:
        return torch.full((c,), k * float(math.prod(p.shape[:-1])), device=p.device)
    return (k * torch.sum(w)).expand(c)


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
    cotangent goes to it, where autograd of ``amax`` would split it). At
    ``N k C >= SLOT_STREAM_ELEMS`` it never forms ``g``: `_stats_streamed`
    folds one slot at a time (the JAX streamed branch), with max, min and
    the winners bitwise the dense traversal's and the sums reassociated;
    the residuals are the same, so the backward is one. The
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
            global stream_runs
            stream_runs += 1
            mx, ax, mn, an, sq, s2a = _stats_streamed(q, idx, w)
            s1p, s2b = _query_sums(p, sq, w)
        else:
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


def edgeconv_block_fused_mlp(p, q, bn_params, conv2, bn_state, idx, mask=None, *,
                             momentum: float = 0.9, eps: float = EPS, group=None):
    """An f32 EdgeConv block of MLP depth 2 in training, without the edge
    tensor on CUDA: ``max_k relu(BN2(relu(BN1(P_i + Q_j)) W2))``, each BN on
    the batch statistics of the valid rows' edges (the edge form's
    mathematics, `models.dgcnn.Model._block`).

    `EdgeStats` gives BN1's sums, `ops.norm.finalize_batch_stats` its mean,
    variance and running update (merged over ``group``, sync BN, outside
    the Function as `_edge_batch_stats` rules), `EdgeMLP` the stacked conv's
    BN2 sums and each row's winning ``y2`` (the max where ``gamma2 >= 0``,
    the min elsewhere), and the output is BN2 and relu of that winner (the
    chain is monotone per channel, as in `edgeconv_block_reduced`).

    Args:
      p, q: ``(..., N, C)`` and ``(..., NQ, C)`` query- and neighbour-side
        pre-activations of the first conv (``q`` may be an extended operand
        with ``idx`` localized into it).
      bn_params: BN1's ``{"scale", "bias"}``; conv2: the stacked conv
        ``{"w" (C, C), "bn"}``; bn_state: ``{"main", "extra": [state]}``.
      idx: ``(..., N, k)`` neighbour indices into ``q``'s rows.
      mask: ``(..., N)`` bool query validity or None.

    Returns:
      ``(y float32 (..., N, C), new_bn_state)``.
    """
    p, q = p.float(), q.float()
    w = None if mask is None else mask.float()
    k = idx.shape[-1]
    count = _edge_count(p, k, w)
    g1, b1 = bn_params["scale"].float(), bn_params["bias"].float()
    s1, s2 = EdgeStats.apply(p, q, idx, w)
    mean1, var1, state1 = finalize_batch_stats(count, s1, s2, bn_state["main"],
                                               momentum=momentum, group=group)
    r1 = torch.rsqrt(var1 + eps)
    g2, b2 = conv2["bn"]["scale"].float(), conv2["bn"]["bias"].float()
    with span("dgcnn.edge_mlp"):
        m, t1, t2 = EdgeMLP.apply(p, q, idx, w, mean1, r1, g1, b1, conv2["w"].float(), g2 >= 0)
    mean2, var2, state2 = finalize_batch_stats(count, t1, t2, bn_state["extra"][0],
                                               momentum=momentum, group=group)
    y = torch.relu((m - mean2) * torch.rsqrt(var2 + eps) * g2 + b2)
    return y, {"main": state1, "extra": [state2]}


def _mlp_passes(t: torch.Tensor):
    """The four passes of `EdgeStats` and `EdgeMLP` for tensors on ``t``'s
    device: the kernels on CUDA (which launch or raise), the plain
    versions on the CPU."""
    if t.device.type == "cuda":
        return edge_mlp_cuda
    if t.device.type == "cpu":
        return _PLAIN
    raise ValueError(f"edgeconv_block_fused_mlp: no implementation for device {t.device}")


class EdgeStats(torch.autograd.Function):
    """BN1's batch sums of the edges ``y1_e = P_i + Q_j``: ``apply(p, q,
    idx, w) -> (s1, s2)``, ``sum_e w_i y1_e`` and ``sum_e w_i y1_e^2``,
    ``(C,)`` each; ``idx`` and ``w`` get no gradient. The backward is one
    pass over the edges, ``v_e = w_i (ds1 + 2 ds2 y1_e)`` summed into
    ``dp_i`` and scattered into ``dq_j``."""

    @staticmethod
    def forward(ctx, p, q, idx, w):
        ctx.save_for_backward(p, q, idx, w)
        return _mlp_passes(p).stats(p, q, idx, w)

    @staticmethod
    def backward(ctx, ds1, ds2):
        p, q, idx, w = ctx.saved_tensors
        dp, dq = _mlp_passes(p).stats_backward(p, q, idx, w, ds1, ds2)
        return dp, dq, None, None


class EdgeMLP(torch.autograd.Function):
    """The stacked conv of a depth-2 block over the edges: ``apply(p, q,
    idx, w, mean1, r1, g1, b1, w2, gsign) -> (m, s1, s2)`` with ``h1_e =
    relu((P_i + Q_j - mean1) r1 g1 + b1)`` (``r1 = rsqrt(var1 + eps)``) and
    ``y2_e = h1_e w2``: ``m`` ``(..., N, C)`` each row's max of ``y2`` over
    its edges where ``gsign``, else the min; ``s1``, ``s2`` BN2's sums
    ``sum_e w_i y2_e`` and ``sum_e w_i y2_e^2``. The forward keeps each
    (row, channel)'s first winning slot (uint8), so the whole cotangent of
    ``m`` goes to it. The backward recomputes ``y1``, ``h1`` and ``y2``
    edge by edge: ``dy2 = w_i (ds1 + 2 ds2 y2) + [s = winner] dm``, ``dw2 =
    sum h1^T dy2``, ``dt = dy2 w2^T [h1 > 0]``, and from BN1's op order
    ``dy1 = dt g1 r1``, ``d beta1 = sum dt``, ``d gamma1 = r1 sum dt a``,
    ``d r1 = g1 sum dt a``, ``d mean1 = -g1 r1 sum dt`` (``a = y1 -
    mean1``)."""

    @staticmethod
    def forward(ctx, p, q, idx, w, mean1, r1, g1, b1, w2, gsign):
        m, win, s1, s2 = _mlp_passes(p).forward(p, q, idx, w, mean1, r1, g1, b1, w2, gsign)
        ctx.save_for_backward(p, q, idx, w, mean1, r1, g1, b1, w2, win)
        return m, s1, s2

    @staticmethod
    def backward(ctx, dm, ds1, ds2):
        p, q, idx, w, mean1, r1, g1, b1, w2, win = ctx.saved_tensors
        dp, dq, sdt, sdta, dw2 = _mlp_passes(p).backward(p, q, idx, w, mean1, r1, g1, b1, w2,
                                                          win, dm, ds1, ds2)
        return (dp, dq, None, None, -g1 * r1 * sdt, g1 * sdta, r1 * sdta, sdt, dw2, None)


def _mlp_y1(p, q, idx):
    """The materialised edges ``y1 = P_i + Q_j``, ``(..., N, k, C)``."""
    return p[..., :, None, :] + gather_neighbors(q, idx)


def _mlp_y1_h1(p, q, idx, mean1, r1, g1, b1):
    """``y1`` and ``h1 = relu(BN1(y1))`` in `ops.norm.batch_norm_apply`'s
    op order."""
    y1 = _mlp_y1(p, q, idx)
    return y1, torch.relu((y1 - mean1) * r1 * g1 + b1)


def _edge_weights(w):
    """The edge form's BN mask over the k slots: ``w`` ``(..., N)`` as
    ``(..., N, 1)``, or None."""
    return None if w is None else w[..., None]


def _scatter_rows(v, idx, nq: int):
    """``out[..., j, :] = sum over (i, s) with idx[..., i, s] = j of v[...,
    i, s, :]``: ``v`` ``(..., N, k, C)`` into ``(..., nq, C)``."""
    *lead, n, k, c = v.shape
    bl = math.prod(lead)
    rows = idx.reshape(bl, n, k).long() + nq * torch.arange(bl, device=idx.device)[:, None, None]
    acc = torch.zeros((bl * nq, c), dtype=v.dtype, device=v.device)
    acc.index_add_(0, rows.reshape(-1), v.reshape(-1, c))
    return acc.reshape(*lead, nq, c)


def _mlp_stats_plain(p, q, idx, w):
    """Plain version of `kernels.edge_mlp_cuda.stats`."""
    _, s1, s2 = batch_sums(_mlp_y1(p, q, idx), _edge_weights(w))
    return s1, s2


def _mlp_forward_plain(p, q, idx, w, mean1, r1, g1, b1, w2, gsign):
    """Plain version of `kernels.edge_mlp_cuda.forward`: the edge form's
    tensors, the same sums (bit for bit on the CPU), and the winners of
    ``max``/``min`` (the first on a tie)."""
    _, h1 = _mlp_y1_h1(p, q, idx, mean1, r1, g1, b1)
    y2 = torch.matmul(h1, w2)
    _, s1, s2 = batch_sums(y2, _edge_weights(w))
    mx, ax = y2.max(dim=-2)
    mn, an = y2.min(dim=-2)
    return (torch.where(gsign, mx, mn), torch.where(gsign, ax, an).to(torch.uint8), s1, s2)


def _mlp_backward_plain(p, q, idx, w, mean1, r1, g1, b1, w2, win, dm, ds1, ds2):
    """Plain version of `kernels.edge_mlp_cuda.backward`."""
    y1, h1 = _mlp_y1_h1(p, q, idx, mean1, r1, g1, b1)
    y2 = torch.matmul(h1, w2)
    k, c = idx.shape[-1], p.shape[-1]
    slots = torch.arange(k, device=p.device)[:, None]
    won = win.long()[..., None, :] == slots  # (..., N, k, C)
    wrow = torch.ones(p.shape[:-1], device=p.device) if w is None else w
    dy2 = wrow[..., None, None] * (ds1 + 2.0 * ds2 * y2) + torch.where(won, dm[..., None, :], 0.0)
    dw2 = torch.matmul(h1.reshape(-1, c).T, dy2.reshape(-1, c))
    dt = torch.where(h1 > 0, torch.matmul(dy2, w2.T), 0.0)
    axes = tuple(range(dt.dim() - 1))
    sdt, sdta = dt.sum(dim=axes), (dt * (y1 - mean1)).sum(dim=axes)
    dy1 = dt * g1 * r1
    return dy1.sum(dim=-2), _scatter_rows(dy1, idx, q.shape[-2]), sdt, sdta, dw2


def _mlp_stats_backward_plain(p, q, idx, w, ds1, ds2):
    """Plain version of `kernels.edge_mlp_cuda.stats_backward`."""
    v = ds1 + 2.0 * ds2 * _mlp_y1(p, q, idx)
    if w is not None:
        v = w[..., None, None] * v
    return v.sum(dim=-2), _scatter_rows(v, idx, q.shape[-2])


_PLAIN = types.SimpleNamespace(stats=_mlp_stats_plain, forward=_mlp_forward_plain,
                               backward=_mlp_backward_plain,
                               stats_backward=_mlp_stats_backward_plain)


def gather_slot(q: torch.Tensor, idx: torch.Tensor, s: int) -> torch.Tensor:
    """``q[idx[..., s]]``, ``(..., N, C)``: one neighbour slot's rows."""
    rows = idx[..., s : s + 1].long()  # (..., N, 1)
    return torch.gather(q, -2, rows.expand(rows.shape[:-1] + (q.shape[-1],)))


def _stats_streamed(q: torch.Tensor, idx: torch.Tensor, w):
    """`GatheredStats`' forward reductions one slot at a time (port of the
    streamed branch of `dgcnn_tpu/ops/edge.py::_gathered_stats_fwd`):
    ``(mx, ax, mn, an, sq, s2a)``, the max and min with their winning
    slots (``_winner_dtype``), the per-row sum ``sq``, each ``(..., N,
    C)``, and ``s2a = sum_i w_i sum_s g_is^2`` folded into a ``(C,)``
    carry slot by slot, so no per-row sum of squares exists. Strict
    compares keep the first winning slot, as the dense ``max``/``min`` do,
    so the winners are bitwise theirs (a NaN past slot 0 does not
    propagate, the JAX caveat); the sums are reassociated."""
    axes = tuple(range(q.dim() - 1))
    wc = None if w is None else w[..., None]

    def fold_sq2(g):
        g2 = torch.square(g)
        return (g2 if wc is None else g2 * wc).sum(dim=axes)

    g = gather_slot(q, idx, 0)
    mx, mn, sq = g, g.clone(), g.clone()
    ax = torch.zeros(g.shape, dtype=_winner_dtype(idx.shape[-1]), device=g.device)
    an = ax.clone()
    s2a = fold_sq2(g)
    for s in range(1, idx.shape[-1]):
        g = gather_slot(q, idx, s)
        gt, lt = g > mx, g < mn
        # in place: every carry is (..., N, C)
        torch.where(gt, g, mx, out=mx)
        ax.masked_fill_(gt, s)
        torch.where(lt, g, mn, out=mn)
        an.masked_fill_(lt, s)
        sq += g
        s2a += fold_sq2(g)
    return mx, ax, mn, an, sq, s2a


def _maxmin_streamed(q: torch.Tensor, idx: torch.Tensor):
    """Per-query neighbour max and min of ``q[idx]``, one slot at a time
    (port of `dgcnn_tpu/ops/edge.py::_maxmin_streamed`). Max and min are
    exact, so folding the slots in order gives the dense
    ``amax``/``amin`` bit for bit."""
    mx = gather_slot(q, idx, 0)
    mn = mx.clone()
    for s in range(1, idx.shape[-1]):
        g = gather_slot(q, idx, s)
        torch.maximum(mx, g, out=mx)  # in place: the carries are (..., N, D)
        torch.minimum(mn, g, out=mn)
    return mx, mn
