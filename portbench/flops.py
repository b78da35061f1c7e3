"""The work of the kernels any network launches, counted from shapes,
and the chip's peaks it is held against. A network's own count (its
model operations, which kernels it launches on which shapes) is its
``work.py`` under `portbench.networks`.

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
