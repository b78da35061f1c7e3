"""Canonical oversized-event crop policy (port of `dgcnn_tpu/io/crop.py`).

Must stay bit-identical to the JAX package's policy, so that both packages
build the same batches from the same file:

- ``stride``: row j of m takes source row (j*n)//m.
- ``random`` (default): stratum j is the source range
  [(j*n)//m, ((j+1)*n)//m) and one row is drawn per stratum with a
  splitmix64 hash of (seed, event_id, j).
"""

from __future__ import annotations

import numpy as np

_PHI = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)

CROP_MODES = ("random", "stride")


def _sm64(z: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (vectorized uint64, wrapping)."""
    z = (z ^ (z >> np.uint64(30))) * _M1
    z = (z ^ (z >> np.uint64(27))) * _M2
    return z ^ (z >> np.uint64(31))


def crop_select(n: int, m: int, mode: str, seed: int, event_id: int) -> np.ndarray:
    """Indices (int64, strictly increasing, len m) of the kept rows when
    cropping an n-point event to m < n points."""
    if mode not in CROP_MODES:
        raise ValueError(f"crop_mode must be one of {CROP_MODES}, got {mode!r}")
    j = np.arange(m, dtype=np.uint64)
    lo = (j * np.uint64(n)) // np.uint64(m)
    if mode == "stride":
        return lo.astype(np.int64)
    hi = ((j + np.uint64(1)) * np.uint64(n)) // np.uint64(m)
    width = hi - lo  # >= 1 since n > m
    with np.errstate(over="ignore"):
        base = _sm64(
            (np.uint64(seed & 0xFFFFFFFFFFFFFFFF) ^ (np.uint64(event_id) * _PHI))
            + _PHI
        )
        h = _sm64(base + (j + np.uint64(1)) * _PHI)
    return (lo + h % width).astype(np.int64)
