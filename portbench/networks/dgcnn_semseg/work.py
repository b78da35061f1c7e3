"""The segmentation network's work, counted from shapes.

Its operations (for ``mfu``): the residual network's count
(`residual_dgcnn.work`: the graph builds' ``2C + 2`` a pair of valid
points, each block's first convolution factorised as ``x @ (Wa - Wb)``
and ``x @ Wb``, ``4 C_in C_out`` a point, the head; with ``residual``
false no projection), plus each block's stacked convolutions, which act
on every edge: ``2 C_out^2 k`` a point each. A train step adds the
backward as twice the forward's matmuls; the graph build has no
backward. BN, relu, the gathers and the max are not counted.

Its kernels' least time (for ``knn_roofline``): one exact graph build a
block, on that block's input channels, as the residual network's.
"""

from __future__ import annotations

from . import residual


def depths(model: dict) -> list[int]:
    """Each block's MLP depth (``block_convs``: an int for every block, or
    a list)."""
    d = model["block_convs"]
    n = len(model["edge_filters"])
    return [int(d)] * n if isinstance(d, int) else [int(x) for x in d]


def stacked_flops_per_point(model: dict) -> float:
    """The stacked convolutions' operations a point, over its ``k`` edges."""
    k = int(model["k"])
    return float(sum((d - 1) * 2 * int(c) * int(c) * k
                     for d, c in zip(depths(model), model["edge_filters"])))


def work(model: dict, valid: list[int], padded: int, train: bool,
         peak_flops: float) -> tuple[float, dict]:
    """A step's (``train``) or a served batch's model operations over
    events of ``valid`` points each, padded to ``padded`` rows, and the
    least seconds of its kernels by family at ``peak_flops``."""
    ops, bounds = residual.work(model, valid, padded, train, peak_flops)
    stacked = stacked_flops_per_point(model) * sum(valid)
    return ops + (3 * stacked if train else stacked), bounds
