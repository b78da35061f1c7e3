"""The residual network's parameters and BN state, made from ``--seed`` on
the device in two large draws.

The tree has the layout the program takes (`Trainval.with_params`) and
the reference reads: ``{"blocks": [{"w", "bn": {"scale", "bias"},
"proj"?: {"w", "b"}}], "head": {"feat": {"w", "bn"}, "mlp": [{"w",
"bn"}], "out": {"w", "b"}}}`` and the state ``{"blocks": [{"mean",
"var"}], "head": {"feat": {...}, "mlp": [...]}}``. Weights are Glorot
uniform (the model's initialiser); biases, BN scales and biases, and the
running statistics are drawn too (scale in [0.8, 1.2), bias, mean in
[-0.1, 0.1), variance in [0.5, 1.5)), so that every parameter and every
statistic takes part in what the comparison sees.
"""

from __future__ import annotations

import math

import torch

from portbench.tree import flatten, unflatten


class _Leaf:
    def __init__(self, shape, kind):
        self.shape, self.kind = shape, kind


def _shapes(model: dict):
    """``(params, state)`` trees of ``(shape, kind)`` leaves."""
    blocks, bstate = [], []
    c_in = int(model["in_dim"])
    for c_out in map(int, model["edge_filters"]):
        blk = {"w": _Leaf((2 * c_in, c_out), "glorot"), "bn": _bn(c_out)}
        if model["residual"] and c_in != c_out:
            blk["proj"] = {"w": _Leaf((c_in, c_out), "glorot"), "b": _Leaf((c_out,), "bias")}
        blocks.append(blk)
        bstate.append(_stats(c_out))
        c_in = c_out
    concat = sum(map(int, model["edge_filters"]))
    feat = int(model["head_feat_dim"])
    width, mlp, mstate = concat + feat, [], []
    for w in map(int, model["head_mlp"]):
        mlp.append({"w": _Leaf((width, w), "glorot"), "bn": _bn(w)})
        mstate.append(_stats(w))
        width = w
    head = {"feat": {"w": _Leaf((concat, feat), "glorot"), "bn": _bn(feat)}, "mlp": mlp,
            "out": {"w": _Leaf((width, int(model["num_class"])), "glorot"),
                    "b": _Leaf((int(model["num_class"]),), "bias")}}
    return ({"blocks": blocks, "head": head},
            {"blocks": bstate, "head": {"feat": _stats(feat), "mlp": mstate}})


def _bn(c):
    return {"scale": _Leaf((c,), "scale"), "bias": _Leaf((c,), "bias")}


def _stats(c):
    return {"mean": _Leaf((c,), "bias"), "var": _Leaf((c,), "var")}


def _fill(tree, u: torch.Tensor):
    leaves, at = [], 0
    for _, leaf in flatten(tree):
        shape, kind = leaf.shape, leaf.kind
        n = math.prod(shape)
        x = u[at:at + n].view(shape)
        at += n
        if kind == "glorot":
            lim = math.sqrt(6.0 / (shape[0] + shape[-1]))
            x = x * (2 * lim) - lim
        elif kind == "scale":
            x = 0.8 + 0.4 * x
        elif kind == "bias":
            x = 0.2 * x - 0.1
        else:
            x = 0.5 + x
        leaves.append(x.contiguous())
    return unflatten(tree, leaves)


def _count(tree) -> int:
    return sum(math.prod(leaf.shape) for _, leaf in flatten(tree))


def make(model: dict, seed: int, device) -> tuple[dict, dict]:
    """``(params, state)`` for ``seed`` on ``device``, float32."""
    shapes, stats = _shapes(model)
    g = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(_count(shapes) + _count(stats), generator=g, device=device)
    n = _count(shapes)
    return _fill(shapes, u[:n]), _fill(stats, u[n:])
