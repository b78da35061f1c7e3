"""Streamed (chunked over points) head for huge events, eval mode (port of
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
  dense head's.

N is padded up to a whole number of chunks, the mask False on the pad (the
last chunk is padded as it is built, so the block features are not
copied). Left out of the JAX function: its lane packing (a TPU layout
trick), ``vary`` (a ``shard_map`` detail) and the train-mode statistics
sweeps, which wait for ROADMAP queue 1, item 11 (``train=True`` raises).

``runs`` counts calls, so a run can show that the streamed head served it.
"""

from __future__ import annotations

import torch

from dgcnn_tpu_torch.models.core import conv_bn_apply, dense_apply
from dgcnn_tpu_torch.ops.norm import batch_norm_apply

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


def _normalize(params, state, pre):
    """The exact normalize + relu chain of the dense head's BN layers (f32
    in, relu, cast back to ``pre``'s dtype)."""
    return torch.relu(batch_norm_apply(params["bn"], state, pre)[0]).to(pre.dtype)


def head_streamed(params, state, feats, mask, *, spec, pool_fn=None, train: bool = False,
                  cdtype=torch.float32):
    """Eval-mode streamed equivalent of the dense head in
    `models.dgcnn.Model.forward`.

    Args:
      params, state: the ``head`` subtrees (``feat``, ``mlp``, ``out``).
      feats: the per-block features, each ``(B, N, C_i)``.
      mask: ``(B, N)`` bool validity or None.
      spec: the `ModelSpec` (``global_pool``, ``head_factorized``,
        ``head_feat_dim``).
      pool_fn: the model's masked-max pool ``(x, mask) -> (B, C)``, or
        None for the local one. It gets the ``(B, 1, C)`` partial and
        whether the event has a valid point, so a context-parallel pool
        applies its merge across ranks and its empty-event guard as in
        the dense head.
      train: the train-mode streamed head is not ported yet and raises.
      cdtype: the compute dtype of the matmuls (the weights cast from the
        f32 parameters, as the dense head casts them).

    Returns:
      float32 logits ``(B, N, num_class)``.
    """
    global runs
    if train:
        raise NotImplementedError(
            "the streamed head in train mode is not ported yet (ROADMAP queue 1, item 11)")
    b, n = feats[0].shape[0], feats[0].shape[-2]
    dev = feats[0].device
    ca = sum(f.shape[-1] for f in feats)
    ch, nchunks, _ = _chunk_geometry(n, b, max(spec.head_feat_dim, 1))
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=dev)

    def rows(x, j, fill):
        """Rows ``[j * ch, (j + 1) * ch)`` of ``x`` along the point axis,
        the pad past N filled with ``fill``."""
        piece = x[:, j * ch : (j + 1) * ch]
        short = ch - piece.shape[1]
        if short == 0:
            return piece
        pad = torch.full((b, short) + tuple(x.shape[2:]), fill, dtype=x.dtype, device=dev)
        return torch.cat([piece, pad], dim=1)

    def agg_chunk(j):
        # per-chunk concat of the block features: (B, ch, sum C)
        return torch.cat([rows(f, j, 0.0) for f in feats], dim=-1)

    # ---------------- pooled global vector (global_pool only) ----------
    g_vec = None
    if spec.global_pool:
        fp, fs = params["feat"], state["feat"]
        fdim = fp["w"].shape[-1]
        big = torch.finfo(torch.float32).max
        mx = torch.full((b, fdim), -big, device=dev)
        mn = torch.full((b, fdim), big, device=dev)
        for j in range(nchunks):
            pre = dense_apply(fp, agg_chunk(j).to(cdtype), cdtype).float()  # (B, ch, fdim)
            valid = rows(mask, j, False)[..., None]
            mx = torch.maximum(mx, torch.where(valid, pre, -big).amax(dim=-2))
            mn = torch.minimum(mn, torch.where(valid, pre, big).amin(dim=-2))
        sel = torch.where(fp["bn"]["scale"] >= 0, mx, mn)
        g_row = _normalize(fp, fs, sel.to(cdtype))
        any_valid = mask.any(dim=-1, keepdim=True)
        if pool_fn is None:
            # the dense pool's guard: zeros for an event with no valid point
            g_vec = torch.where(any_valid, g_row, 0.0)
        else:
            g_vec = pool_fn(g_row[..., None, :], any_valid)

    # ---------------- MLP ladder and logits, per chunk ------------------
    factorized = spec.global_pool and spec.head_factorized
    mlp = list(zip(params["mlp"], state["mlp"]))
    g_term = None
    if factorized:
        # per-event term computed once, added per chunk (the dense head's
        # broadcast of the same (B, D) product)
        g_term = torch.matmul(g_vec.to(cdtype), mlp[0][0]["w"].to(cdtype)[ca:])[..., None, :]

    logits = []
    for j in range(nchunks):
        a_c = agg_chunk(j).to(cdtype)
        if spec.global_pool:
            h = a_c
            if not factorized:
                g = g_vec[..., None, :].to(cdtype).expand(a_c.shape[:-1] + g_vec.shape[-1:])
                h = torch.cat([a_c, g], dim=-1)
        else:
            # no pool: the feature conv is the ladder's first layer
            h, _ = conv_bn_apply(params["feat"], state["feat"], a_c, dtype=cdtype)
        for li, (p, s) in enumerate(mlp):
            if li == 0 and factorized:
                h = _normalize(p, s, torch.matmul(h, p["w"].to(cdtype)[:ca]) + g_term)
            else:
                h, _ = conv_bn_apply(p, s, h, dtype=cdtype)
        logits.append(dense_apply(params["out"], h, cdtype))
    runs += 1
    return torch.cat(logits, dim=1)[:, :n].float()
