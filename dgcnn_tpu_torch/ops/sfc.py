"""Space-filling-curve point ordering, the banded kNN's sort key (port of
`dgcnn_tpu/ops/sfc.py`).

Sorting points along a Z-order (Morton) curve makes sorted-position
proximity a proxy for feature-space proximity, which lets the banded kNN
(`ops.knn.banded_knn_indices`, ``knn_window``) restrict each query's
candidates to a window of consecutive sorted positions.

The code interleaves ``32 // ndim`` bits of each of the first
``ndim = min(C, 8)`` channels, quantised per event over the valid points
only, in f32 with the JAX package's op order (``(x - lo) * scale``, clip,
truncate), so both packages give the same codes. torch's ``uint32`` lacks
shifts and sorts on many builds, so the code is held in ``int64``, and
the JAX two-key stable sort ``(invalid, code, iota)`` is one stable sort
of the key ``invalid << 32 | code``.
"""

from __future__ import annotations

import torch

MAX_CODE_DIMS = 8  # interleave at most this many feature channels


def morton_code(x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Z-order code of every point, ``int64`` holding a ``uint32`` value.

    Args:
      x: ``(..., N, C)`` point features; the first ``min(C, 8)`` channels
        feed the code with ``32 // ndim`` bits each.
      mask: optional ``(..., N)`` bool; the quantisation box spans the
        valid points only (padded rows' codes are irrelevant:
        `morton_order` sorts them last).

    Returns:
      ``(..., N)`` int64 codes in ``[0, 2**32)``.
    """
    ndim = min(x.shape[-1], MAX_CODE_DIMS)
    bits = 32 // ndim
    x = x[..., :ndim].float()
    if mask is not None:
        big = 3.4e38
        m = mask[..., None]
        lo = torch.where(m, x, big).amin(dim=-2, keepdim=True)
        hi = torch.where(m, x, -big).amax(dim=-2, keepdim=True)
        # all-padded events: lo > hi; collapse to a zero-extent box
        hi = torch.maximum(hi, lo)
    else:
        lo = x.amin(dim=-2, keepdim=True)
        hi = x.amax(dim=-2, keepdim=True)
    top = 2.0**bits - 1.0
    # a tensor numerator: torch computes ``float / tensor`` as a
    # reciprocal times the float, which rounds differently from the
    # reference's true division and flips quantisation boundaries
    extent = torch.clamp(hi - lo, min=1e-12)
    scale = torch.full_like(extent, top) / extent
    q = torch.clamp((x - lo) * scale, 0.0, top).to(torch.int64)  # truncates
    # at 32 bits (C == 1) the f32 bound rounds up to 2**32; the reference's
    # conversion to uint32 saturates there
    q = torch.clamp(q, max=(1 << bits) - 1)
    code = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    for b in range(bits):
        for d in range(ndim):
            code |= ((q[..., d] >> b) & 1) << (ndim * b + d)
    return code


def morton_order(x: torch.Tensor, mask: torch.Tensor | None = None):
    """Sorted order of points along the Z-curve, padded points last.

    Returns:
      ``order``: ``(..., N)`` int64; ``order[i]`` is the original index of
        the point at sorted position ``i`` (stable: equal codes keep their
        original index order).
      ``pos``: ``(..., N)`` int64 inverse permutation; ``pos[j]`` is the
        sorted position of original point ``j``.
    """
    key = morton_code(x, mask)
    if mask is not None:
        key = key | ((~mask).to(torch.int64) << 32)
    order = torch.sort(key, dim=-1, stable=True).indices
    iota = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    pos = torch.empty_like(order).scatter_(-1, order, iota)
    return order, pos
