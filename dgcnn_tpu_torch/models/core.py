"""Functional layer helpers (port of `dgcnn_tpu/models/core.py`).

Explicit init/apply pairs over dicts of tensors, in the JAX package's
layouts: a dense weight is ``(din, dout)`` and activations are
``(..., C)``, so parameters bridge across packages without transposes.
Init draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch

from dgcnn_tpu_torch.ops.norm import batch_norm_apply, batch_norm_init


def glorot_uniform(generator: torch.Generator, shape):
    """Xavier/Glorot uniform on ``[-limit, limit)``, the TF1 conv default.
    Drawn on the CPU from a CPU generator, so a seed gives the same weights
    whichever device they are moved to."""
    fan_in, fan_out = shape[0], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.rand(shape, generator=generator, dtype=torch.float32)
    return w * (2.0 * limit) - limit


def dense_init(generator, din: int, dout: int, bias: bool = True):
    p = {"w": glorot_uniform(generator, (din, dout))}
    if bias:
        p["b"] = torch.zeros(dout)
    return p


def dense_apply(params, x: torch.Tensor) -> torch.Tensor:
    """1x1 conv == dense over the trailing channel axis."""
    y = torch.matmul(x, params["w"])
    if "b" in params:
        y = y + params["b"]
    return y


def conv_bn_init(generator, din: int, dout: int):
    """Dense (no bias: BN's mean subtraction cancels it) + BN; returns
    ``(params, state)``."""
    dp = dense_init(generator, din, dout, bias=False)
    bn_params, bn_state = batch_norm_init(dout)
    return {**dp, "bn": bn_params}, bn_state


def conv_bn_apply(params, state, x: torch.Tensor, mask=None, *, train: bool = False,
                  momentum: float = 0.9, activation=torch.relu, group=None):
    """dense -> BN (masked batch statistics in train mode, merged over
    ``group`` with sync BN; running ones in eval) -> activation. Returns
    ``(y, new_state)``."""
    y, new_state = batch_norm_apply(params["bn"], state, dense_apply(params, x), mask,
                                    train=train, momentum=momentum, group=group)
    return (y if activation is None else activation(y)), new_state


def dropout(x: torch.Tensor, rate: float, *, train: bool, generator=None, keep_mask=None):
    """Inverted dropout: keep each element with probability ``1 - rate``
    and scale the kept ones by ``1 / (1 - rate)``. Identity in eval mode,
    at rate 0, or with neither a ``generator`` nor a ``keep_mask`` (the JAX
    package's ``rng=None``).

    The keep mask is ``torch.rand(x.shape, generator=generator) < keep``
    on ``x``'s device (the generator lives there too), or ``keep_mask``
    (bool, broadcastable to ``x``) when given: JAX's PRNG bits cannot be
    reproduced, so a parity test hands both packages the same mask.
    """
    if not train or rate <= 0.0 or (generator is None and keep_mask is None):
        return x
    keep = 1.0 - rate
    if keep_mask is None:
        keep_mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(keep_mask, x / keep, 0.0)
