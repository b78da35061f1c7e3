"""Batch normalization with running statistics (port of
`dgcnn_tpu/ops/norm.py`).

Not ``torch.nn.BatchNorm*``: the JAX package masks its batch statistics
(padded points never count), uses eps 1e-3, the running average
``momentum * old + (1 - momentum) * batch`` with the biased variance, and
leaves the running state untouched for a batch with no valid position; the
normalize chain below keeps its exact op order so both packages round
alike. Statistics always accumulate in f32.

Under data parallelism with sync BN (``group``, the data axis of the rank
group) the partial sums of every rank are merged before the mean, as the
JAX package psums them over its ``axis_name``: count, s1 and s2 travel
packed in one tensor through `parallel.collectives.psum_autograd`, so a
BN layer makes one collective forward and one (the cotangent's) backward.
"""

from __future__ import annotations

import math

import torch

from dgcnn_tpu_torch.parallel.collectives import psum_autograd

EPS = 1e-3


def batch_norm_init(dim: int):
    """Returns (params, state) for one BN layer over a trailing channel dim."""
    params = {"scale": torch.ones(dim), "bias": torch.zeros(dim)}
    state = {"mean": torch.zeros(dim), "var": torch.ones(dim)}
    return params, state


def finalize_batch_stats(count, s1, s2, state, *, momentum: float, group=None):
    """BN batch statistics from partial sums: the one place their
    semantics live, shared by `batch_norm_apply` and the EdgeConv blocks
    (`ops.edge`).

    Args:
      count, s1, s2: valid-position count, sum and sum of squares per
        channel (``count`` a tensor, per channel or scalar).
      state: ``{"mean", "var"}`` running statistics.
      group: merge the partial sums over this axis of the rank group
        (sync BN; differentiable), or None.

    Returns:
      ``(mean, var, new_state)``; ``var = max(s2 / count - mean^2, 0)``
      (biased), and ``count == 0`` (the merged count) leaves the running
      state as it was.
    """
    if group is not None and group.size > 1:
        c = s1.shape[-1]
        packed = torch.stack([torch.broadcast_to(count, (c,)), s1, s2])
        count, s1, s2 = psum_autograd(packed, group).unbind(0)
    denom = torch.clamp(count, min=1.0)
    mean = s1 / denom
    var = torch.clamp(s2 / denom - torch.square(mean), min=0.0)
    has_data = count > 0
    new_state = {
        "mean": torch.where(has_data, momentum * state["mean"] + (1.0 - momentum) * mean,
                            state["mean"]),
        "var": torch.where(has_data, momentum * state["var"] + (1.0 - momentum) * var,
                           state["var"]),
    }
    return mean, var, new_state


def batch_sums(x: torch.Tensor, mask=None):
    """``(count, s1, s2)`` of `finalize_batch_stats` over all axes of ``x``
    (``(..., C)`` f32) but the last: the valid-position count, the sum and
    the sum of squares, positions weighted by ``mask`` (bool or 0/1 float,
    broadcastable to ``x.shape[:-1]``; None for all)."""
    axes = tuple(range(x.dim() - 1))
    if mask is None:
        count = torch.tensor(float(math.prod(x.shape[:-1])), device=x.device)
        return count, torch.sum(x, dim=axes), torch.sum(torch.square(x), dim=axes)
    w = torch.broadcast_to(mask[..., None], x.shape).to(x.dtype)
    count = torch.sum(w, dim=axes)  # (C,), the same for every channel
    return count, torch.sum(x * w, dim=axes), torch.sum(torch.square(x) * w, dim=axes)


def batch_norm_apply(params, state, x: torch.Tensor, mask=None, *, train: bool = False,
                     momentum: float = 0.9, eps: float = EPS, group=None):
    """Normalize ``x`` (``(..., C)``) over all axes but the last.

    Eval (``train`` False): the running statistics, and the state is
    returned as it was. Train: the masked batch statistics (``mask`` bool,
    broadcastable to ``x.shape[:-1]``; False positions are excluded from
    the statistics, their outputs are still produced) and the updated
    running state; ``group`` merges the statistics over that axis of the
    rank group (sync BN). Returns ``(y float32, new_state)`` whatever the
    input's dtype: bf16 in, f32 out, as the JAX package's mixed-precision
    callers ask with ``out_dtype=float32`` (casting the post-BN chain to
    bf16 made the gradients of deep stacks overflow).
    """
    x = x.float()
    if train:
        mean, var, new_state = finalize_batch_stats(*batch_sums(x, mask), state,
                                                    momentum=momentum, group=group)
    else:
        mean, var, new_state = state["mean"], state["var"], state
    y = (x - mean) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y, new_state
