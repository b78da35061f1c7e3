"""Host-side training-time augmentation (port of `dgcnn_tpu/io/augment.py`).

Random rotation about the z (drift) axis, isotropic scale and coordinate
jitter, applied on the host between the batcher and the train step;
seeded and stateless per (seed, batch counter), so runs reproduce and a
resumed run draws fresh transforms. Numpy only: the same seed gives the
JAX package's batches bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dgcnn_tpu_torch.io.batching import Batch


def augment_batch(
    batch: Batch,
    rng: np.random.RandomState,
    *,
    rotate_z: bool = True,
    scale_range: tuple = (0.95, 1.05),
    jitter_sigma: float = 0.01,
) -> Batch:
    """One augmented copy of a batch (coords = feature columns 0..2)."""
    pts = batch.points.copy()
    b = pts.shape[0]
    for i in range(b):
        coords = pts[i, :, :3]
        if rotate_z:
            theta = rng.uniform(0.0, 2.0 * np.pi)
            c, s = np.cos(theta), np.sin(theta)
            rot = np.array([[c, -s], [s, c]], np.float32)
            coords[:, :2] = coords[:, :2] @ rot.T
        if scale_range is not None:
            coords *= rng.uniform(*scale_range)
        if jitter_sigma:
            coords += rng.randn(*coords.shape).astype(np.float32) * jitter_sigma
        pts[i, :, :3] = coords
    pts[~batch.mask] = 0.0  # padding stays exactly zero
    return dataclasses.replace(batch, points=pts)


def augment_stream(batches, seed: int, process_index: int = 0, **kw):
    """Wrap a batch iterator with seeded augmentation. ``process_index``
    folds into the seed so that processes draw different transforms: the
    JAX package passes its process (one a host), the port's loop the
    host index, since the data ranks of one host each augment the same
    global batch and must do so alike."""
    counter = 0
    for batch in batches:
        rng = np.random.RandomState(
            (seed * 1_000_003 + process_index * 7_368_787 + counter) % (2**31 - 1)
        )
        counter += 1
        yield augment_batch(batch, rng, **kw)
