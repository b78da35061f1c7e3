"""The residual network's work, counted from shapes.

Its operations (for ``mfu``): the graph builds' pairs (`portbench.flops`:
``2C + 2`` a pair of valid points), the EdgeConv blocks' two factorised
matmuls ``x @ (Wa - Wb)`` and ``x @ Wb`` (``4 C_in C_out`` a point), a
residual projection where the width changes (``2 C_in C_out``), and the
head's 1x1 convolutions and output layer, all over valid points. A train
step adds the backward as twice the forward's matmuls; the graph build
has no backward, and a recompute (remat) is not model work.

Its kernels' least time (for ``knn_roofline``): one exact graph build a
block, on that block's input channels.
"""

from __future__ import annotations

from portbench import flops


def block_widths(model: dict) -> list[tuple[int, int]]:
    """``(C_in, C_out)`` of each EdgeConv block."""
    widths, c_in = [], int(model["in_dim"])
    for c_out in model["edge_filters"]:
        widths.append((c_in, int(c_out)))
        c_in = int(c_out)
    return widths


def knn_bound_step_s(model: dict, valid: list[int], padded: int, peak_flops: float) -> float:
    """The bound of one forward's graph builds (one a block)."""
    return sum(flops.knn_bound_s(valid, padded, c_in, int(model["k"]), peak_flops)
               for c_in, _ in block_widths(model))


def matmul_flops(model: dict, points: int) -> float:
    """The forward's matmul operations over ``points`` valid points."""
    per_point = 0
    for c_in, c_out in block_widths(model):
        per_point += 4 * c_in * c_out
        if model["residual"] and c_in != c_out:
            per_point += 2 * c_in * c_out
    concat = sum(int(c) for c in model["edge_filters"])
    feat = int(model["head_feat_dim"])
    width = concat + feat
    per_point += 2 * concat * feat
    for w in model["head_mlp"]:
        per_point += 2 * width * int(w)
        width = int(w)
    per_point += 2 * width * int(model["num_class"])
    return float(per_point) * points


def model_flops(model: dict, valid: list[int], train: bool) -> float:
    """A step's (``train``) or a served batch's model operations over
    events of ``valid`` points each."""
    pairs = sum(n * n for n in valid)
    knn = sum(pairs * (2 * c_in + 2) for c_in, _ in block_widths(model))
    mm = matmul_flops(model, sum(valid))
    return float(knn + (3 * mm if train else mm))


def work(model: dict, valid: list[int], padded: int, train: bool,
         peak_flops: float) -> tuple[float, dict]:
    """A step's (``train``) or a served batch's model operations over
    events of ``valid`` points each, padded to ``padded`` rows, and the
    least seconds of its kernels by family at ``peak_flops``."""
    return (model_flops(model, valid, train),
            {"knn": knn_bound_step_s(model, valid, padded, peak_flops)})
