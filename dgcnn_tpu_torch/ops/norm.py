"""Batch normalization with running statistics (port of
`dgcnn_tpu/ops/norm.py`), eval mode.

Not ``torch.nn.BatchNorm*``: the JAX package masks its batch statistics,
uses eps 1e-3 and its own running-average rule, and the normalize chain
below keeps its exact op order so both packages round alike. The
train-mode statistics (`finalize_batch_stats`) arrive with the training
slice (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

import torch

EPS = 1e-3


def batch_norm_init(dim: int):
    """Returns (params, state) for one BN layer over a trailing channel dim."""
    params = {"scale": torch.ones(dim), "bias": torch.zeros(dim)}
    state = {"mean": torch.zeros(dim), "var": torch.ones(dim)}
    return params, state


def batch_norm_apply(params, state, x: torch.Tensor, *, eps: float = EPS):
    """Normalize ``x`` (``(..., C)``) with the running statistics — the
    reference's inference mode. Returns float32."""
    x = x.float()
    return (x - state["mean"]) * torch.rsqrt(state["var"] + eps) * params[
        "scale"
    ] + params["bias"]
