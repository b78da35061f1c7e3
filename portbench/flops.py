"""The work a step or a batch needs, counted from shapes, and the chip's
peaks it is held against.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its full
700 W power limit): 67 TFLOP/s in float32 outside the tensor cores (the
port turns TF32 off), 989 TFLOP/s in bfloat16 on the tensor cores, and
3.35 TB/s of HBM3. A configuration file names the operations peak its
precision is held against (``peak_flops``), one of `DATASHEET_FLOPS`.

The kNN graph build needs, for every valid query against every valid key
of its event, ``C`` multiply-adds, one subtract of the key's norm and one
compare: ``2C + 2`` operations a pair, whatever implements it. Besides,
each valid key's norm (``2C``) and each valid query's scaling (``C``).
It reads each valid point's ``C`` float32 features and the mask once, and
writes ``k`` int32 indices and ``k`` validity bytes a valid query.

A model's operations (for ``mfu``): the graph builds' pairs as above,
the EdgeConv blocks' two factorised matmuls ``x @ (Wa - Wb)`` and
``x @ Wb`` (``4 C_in C_out`` a point), a residual projection where the
width changes (``2 C_in C_out``), and the head's 1x1 convolutions and
output layer, all over valid points. A train step adds the backward as
twice the forward's matmuls; the graph build has no backward, and a
recompute (remat) is not model work.
"""

from __future__ import annotations

DATASHEET_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def knn_ops(valid: list[int], c: int) -> float:
    """Operations one graph build needs over events of ``valid`` points
    each, at ``c`` input channels."""
    return float(sum(n * n * (2 * c + 2) + n * 2 * c + n * c for n in valid))


def knn_bytes(valid: list[int], padded: int, c: int, k: int) -> float:
    """Bytes one graph build needs to move: features and mask in, the
    indices and validity out (``padded`` is the batch's row count an
    event, which the mask covers)."""
    return float(sum(4 * n * c + padded + n * k * (4 + 1) for n in valid))


def knn_bound_s(valid: list[int], padded: int, c: int, k: int, peak_flops: float) -> float:
    """The least time the chip could take for one graph build: the larger
    of its operations over the peak and its bytes over HBM's bandwidth."""
    return max(knn_ops(valid, c) / peak_flops, knn_bytes(valid, padded, c, k) / HBM_BYTES_PER_S)


def block_widths(model: dict) -> list[tuple[int, int]]:
    """``(C_in, C_out)`` of each EdgeConv block."""
    widths, c_in = [], int(model["in_dim"])
    for c_out in model["edge_filters"]:
        widths.append((c_in, int(c_out)))
        c_in = int(c_out)
    return widths


def knn_bound_step_s(model: dict, valid: list[int], padded: int, peak_flops: float) -> float:
    """The bound of one forward's graph builds (one a block)."""
    return sum(knn_bound_s(valid, padded, c_in, int(model["k"]), peak_flops)
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
