"""Streamed (chunked over points) head for huge events (port of
`dgcnn_tpu/models/head.py::head_streamed`).

The head is pointwise: a feature conv whose only consumer under global
pooling is the masked max pool, then an MLP over ``[agg, pooled global]``
(or the factorized pair), then the output dense. At a million points its
per-point activations are the largest tensors of the forward (the
``(N, 1024)`` feature conv alone is 4 GB), so this head works one chunk of
points at a time and no ``(N, width)`` tensor wider than one chunk exists;
the concat of the block features is built a chunk at a time, never whole.

- The pooled global vector commutes with BN + relu, as the EdgeConv
  blocks do (`ops.edge.edgeconv_block_reduced`): per channel the chain is
  monotone, nondecreasing where ``gamma >= 0`` and nonincreasing
  elsewhere, so the masked pool of ``relu(bn(agg @ Wf))`` is
  ``relu(bn(M))`` with ``M`` the masked per-channel max (or min, by the
  sign of gamma) of the pre-activation, carried across chunks in two
  ``(B, C)`` tensors.
- The MLP ladder and the logits run per chunk; every row's math is the
  dense head's, so eval is bitwise the dense head.
- Train mode: each BN layer's masked batch statistics come from one sweep
  over the chunks that recomputes the ladder below it (the feature conv's
  ride the pool's sweep), finalized by `ops.norm.finalize_batch_stats`;
  they differ from the dense head's by the order of the f32 sums. Each
  chunk runs under ``torch.utils.checkpoint``, so the backward too holds
  one chunk's activations at a time.

N is padded up to a whole number of chunks, the mask False on the pad (the
last chunk is padded as it is built, so the block features are not
copied). Left out of the JAX function: its lane packing (a TPU layout
trick) and ``vary`` (a ``shard_map`` detail).

``runs`` counts calls, so a run can show that the streamed head served it.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from dgcnn_tpu_torch.models.core import dense_apply
from dgcnn_tpu_torch.ops.norm import EPS, finalize_batch_stats

# rows * head_feat_dim at or above which the ``auto`` head streams
HEAD_STREAM_ELEMS = 2**30
# target element count of one chunk's widest activation (2**27 f32
# elements = 512 MB)
HEAD_CHUNK_TARGET_ELEMS = 2**27

runs = 0


def _chunk_geometry(n: int, b: int, width: int):
    """Chunk rows so one chunk's widest activation is about
    ``HEAD_CHUNK_TARGET_ELEMS`` elements: ``(rows, chunks, pad)``."""
    ch = max(int(HEAD_CHUNK_TARGET_ELEMS) // max(b * width, 1), 8)
    ch = min(ch, n)
    ch = max((ch // 8) * 8, 8)
    nchunks = -(-n // ch)  # ceil
    return ch, nchunks, nchunks * ch - n


def _normalize(bn_params, mean, var, pre):
    """The exact normalize + relu chain of the dense head's BN layers
    (`ops.norm.batch_norm_apply`'s expression on ``pre`` in f32, relu, cast
    back to ``pre``'s dtype), with the statistics ``(mean, var)``."""
    y = (pre.float() - mean) * torch.rsqrt(var + EPS) * bn_params["scale"] + bn_params["bias"]
    return torch.relu(y).to(pre.dtype)


def _masked_sums(pre, valid):
    """One chunk's BN partial sums ``(count, s1, s2)`` of ``pre`` over the
    rows where ``valid`` (``(B, ch)`` bool, or None for every row), as
    `ops.norm.batch_norm_apply` forms them."""
    xf = pre.float()
    axes = tuple(range(xf.dim() - 1))
    if valid is None:
        cnt = torch.tensor(float(math.prod(xf.shape[:-1])), device=xf.device)
        return cnt, xf.sum(dim=axes), torch.square(xf).sum(dim=axes)
    w = torch.broadcast_to(valid[..., None], xf.shape).to(xf.dtype)
    return w.sum(dim=axes), (xf * w).sum(dim=axes), (torch.square(xf) * w).sum(dim=axes)


def head_streamed(params, state, feats, mask, *, spec, pool_fn=None, train: bool = False,
                  cdtype=torch.float32, generator=None, group=None):
    """Streamed equivalent of the dense head in `models.dgcnn.Model.forward`.

    Args:
      params, state: the ``head`` subtrees (``feat``, ``mlp``, ``out``).
      feats: the per-block features, each ``(B, N, C_i)``.
      mask: ``(B, N)`` bool validity or None.
      spec: the `ModelSpec` (``global_pool``, ``head_factorized``,
        ``head_feat_dim``, ``bn_momentum``, ``dropout``).
      pool_fn: the model's masked-max pool ``(x, mask) -> (B, C)``, or
        None for the local one. It gets the ``(B, 1, C)`` partial and
        whether the event has a valid point, so a context-parallel pool
        applies its merge across ranks and its empty-event guard as in
        the dense head.
      train: masked batch statistics, one sweep over the chunks for each
        BN layer, finalized by `ops.norm.finalize_batch_stats` (merged
        over ``group``, sync BN); eval uses the running statistics.
      cdtype: the compute dtype of the matmuls (the weights cast from the
        f32 parameters, as the dense head casts them).
      generator: train-mode dropout after each MLP layer: the generator
        gives one seed a (layer, chunk), in order, and each chunk draws its
        mask from a generator of its own seed, so every sweep and the
        backward's recompute draw the same mask (the JAX head folds the
        chunk into a key). None: no dropout, as the dense head.

    Returns:
      ``(logits float32 (B, N, num_class), new_head_state)``.

    With autograd on, each chunk of each sweep runs under
    ``torch.utils.checkpoint`` (the JAX sweeps are checkpointed scans): its
    body takes the chunk index and slices the block features itself, so
    the backward saves the block features, which exist anyway, and
    recomputes one chunk at a time; the batch statistics stay
    differentiable.
    """
    global runs
    b, n = feats[0].shape[0], feats[0].shape[-2]
    dev = feats[0].device
    ca = sum(f.shape[-1] for f in feats)
    mom = spec.bn_momentum
    ch, nchunks, pad = _chunk_geometry(n, b, max(spec.head_feat_dim, 1))
    # the pad rows past N count in no statistic
    use_mask = mask is not None or pad > 0
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    grad = torch.is_grad_enabled()

    def sweep(body):
        """``[body(j) for j in chunks]``, each chunk checkpointed when
        autograd records."""
        if not grad:
            return [body(j) for j in range(nchunks)]
        return [torch.utils.checkpoint.checkpoint(body, j, use_reentrant=False,
                                                  preserve_rng_state=False)
                for j in range(nchunks)]

    def total(parts):
        """The summed ``(count, s1, s2)`` of a sweep's chunks."""
        return tuple(sum(t) for t in zip(*parts))

    def rows(x, j, fill):
        """Rows ``[j * ch, (j + 1) * ch)`` of ``x`` along the point axis,
        the pad past N filled with ``fill``."""
        piece = x[:, j * ch : (j + 1) * ch]
        short = ch - piece.shape[1]
        if short == 0:
            return piece
        pad_rows = torch.full((b, short) + tuple(x.shape[2:]), fill, dtype=x.dtype, device=dev)
        return torch.cat([piece, pad_rows], dim=1)

    def agg_chunk(j):
        # per-chunk concat of the block features: (B, ch, sum C)
        return torch.cat([rows(f, j, 0.0) for f in feats], dim=-1).to(cdtype)

    def chunk_valid(j):
        """The chunk's validity, or None where every row counts."""
        return rows(mask, j, False) if use_mask else None

    new_state = {"feat": state["feat"], "mlp": []}

    # ---------------- pooled global vector (global_pool only) ----------
    g_vec = None
    if spec.global_pool:
        fp = params["feat"]
        big = torch.finfo(torch.float32).max

        def feat_body(j):
            pre = dense_apply(fp, agg_chunk(j), cdtype)  # (B, ch, fdim)
            valid = rows(mask, j, False)
            pf = pre.float()
            mx = torch.where(valid[..., None], pf, -big).amax(dim=-2)
            mn = torch.where(valid[..., None], pf, big).amin(dim=-2)
            return (mx, mn) + (_masked_sums(pre, valid if use_mask else None) if train else ())

        parts = sweep(feat_body)
        mx, mn = parts[0][0], parts[0][1]
        for part in parts[1:]:
            mx, mn = torch.maximum(mx, part[0]), torch.minimum(mn, part[1])
        if train:
            fmean, fvar, new_state["feat"] = finalize_batch_stats(
                *total(part[2:] for part in parts), state["feat"], momentum=mom, group=group)
        else:
            fmean, fvar = state["feat"]["mean"], state["feat"]["var"]
        sel = torch.where(fp["bn"]["scale"] >= 0, mx, mn)
        g_row = _normalize(fp["bn"], fmean, fvar, sel.to(cdtype))
        any_valid = mask.any(dim=-1, keepdim=True)
        if pool_fn is None:
            # the dense pool's guard: zeros for an event with no valid point
            g_vec = torch.where(any_valid, g_row, 0.0)
        else:
            g_vec = pool_fn(g_row[..., None, :], any_valid)

    # ---------------- MLP ladder, a sweep a BN layer, then logits --------
    factorized = spec.global_pool and spec.head_factorized
    mlp = list(zip(params["mlp"], state["mlp"]))
    g_term = None
    if factorized:
        # per-event term computed once, added per chunk (the dense head's
        # broadcast of the same (B, D) product)
        g_term = torch.matmul(g_vec.to(cdtype), mlp[0][0]["w"].to(cdtype)[ca:])[..., None, :]
    seeds = None
    if train and spec.dropout > 0.0 and generator is not None:
        seeds = torch.randint(0, 2**62, (len(mlp), nchunks), generator=generator,
                              device=generator.device).tolist()
    stats = {}  # (mean, var) of each BN layer below the ladder's top

    def pre_act(li, h):
        """Layer ``li``'s pre-activation of the chunk's ``h``."""
        w = mlp[li][0]["w"].to(cdtype)
        if li == 0 and factorized:
            return torch.matmul(h, w[:ca]) + g_term
        return torch.matmul(h, w)

    def ladder(j, upto):
        """The chunk's input to MLP layer ``upto`` (or to the output
        dense when ``upto == len(mlp)``)."""
        a_c = agg_chunk(j)
        if spec.global_pool:
            h = a_c
            if not factorized:
                g = g_vec[..., None, :].to(cdtype).expand(a_c.shape[:-1] + g_vec.shape[-1:])
                h = torch.cat([a_c, g], dim=-1)
        else:
            # no pool: the feature conv is the ladder's first layer
            h = _normalize(params["feat"]["bn"], *stats["feat"],
                           dense_apply(params["feat"], a_c, cdtype))
        for li in range(upto):
            h = _normalize(mlp[li][0]["bn"], *stats[li], pre_act(li, h))
            if seeds is not None:
                keep = 1.0 - spec.dropout
                gen = torch.Generator(device=h.device).manual_seed(seeds[li][j])
                h = torch.where(torch.rand(h.shape, generator=gen, device=h.device) < keep,
                                h / keep, 0.0)
        return h

    if not spec.global_pool:
        if train:
            parts = sweep(lambda j: _masked_sums(dense_apply(params["feat"], agg_chunk(j),
                                                             cdtype), chunk_valid(j)))
            fmean, fvar, new_state["feat"] = finalize_batch_stats(
                *total(parts), state["feat"], momentum=mom, group=group)
            stats["feat"] = (fmean, fvar)
        else:
            stats["feat"] = (state["feat"]["mean"], state["feat"]["var"])
    for li, (_, s_l) in enumerate(mlp):
        if train:
            parts = sweep(lambda j, li=li: _masked_sums(pre_act(li, ladder(j, li)),
                                                        chunk_valid(j)))
            lmean, lvar, s_new = finalize_batch_stats(*total(parts), s_l, momentum=mom,
                                                      group=group)
            new_state["mlp"].append(s_new)
            stats[li] = (lmean, lvar)
        else:
            new_state["mlp"].append(s_l)
            stats[li] = (s_l["mean"], s_l["var"])

    logits = sweep(lambda j: dense_apply(params["out"], ladder(j, len(mlp)), cdtype))
    runs += 1
    return torch.cat(logits, dim=1)[:, :n].float(), new_state
