"""The segmentation network's parameters and BN state, made from
``--seed`` on the device as the residual network's are
(`residual_dgcnn.weights`: the same draws, kinds and ranges), with each
block's stacked convolutions: a block of depth ``d`` adds ``extra``, a
list of ``d - 1`` of ``{"w" (C_out, C_out), "bn"}``, and its state
becomes ``{"main": {"mean", "var"}, "extra": [...]}``, the program's
tree."""

from __future__ import annotations

import torch

from .residual import weights as base
from .work import depths


def _shapes(model: dict):
    params, state = base._shapes(model)
    for i, (blk, d) in enumerate(zip(params["blocks"], depths(model))):
        if d > 1:
            c = blk["w"].shape[-1]
            blk["extra"] = [{"w": base._Leaf((c, c), "glorot"), "bn": base._bn(c)}
                            for _ in range(d - 1)]
            state["blocks"][i] = {"main": state["blocks"][i],
                                  "extra": [base._stats(c) for _ in range(d - 1)]}
    return params, state


def make(model: dict, seed: int, device) -> tuple[dict, dict]:
    """``(params, state)`` for ``seed`` on ``device``, float32."""
    shapes, stats = _shapes(model)
    g = torch.Generator(device=device).manual_seed(int(seed))
    n = base._count(shapes)
    u = torch.rand(n + base._count(stats), generator=g, device=device)
    return base._fill(shapes, u[:n]), base._fill(stats, u[n:])
