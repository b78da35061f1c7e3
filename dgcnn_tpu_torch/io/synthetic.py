"""Synthetic LArTPC-like events (port of `dgcnn_tpu/io/synthetic.py`).

Each event mixes track-like structures (points along straight lines, class
0) and shower-like blobs (class 1 and up) with an energy value channel.
The same seed gives the same events as the JAX package, draw for draw.
"""

from __future__ import annotations

import numpy as np

from dgcnn_tpu_torch.io.readers import Event, IOBase


def make_event(
    rng: np.random.RandomState,
    num_point: int,
    num_class: int = 2,
    with_weights: bool = False,
) -> Event:
    """One event with exactly ``num_point`` points."""
    pts, labels = [], []
    remaining = num_point
    while remaining > 0:
        cls = rng.randint(0, num_class)
        n = int(min(remaining, rng.randint(num_point // 8 + 1, num_point // 2 + 2)))
        if cls == 0:  # track: points along a line segment + small noise
            a = rng.uniform(-1, 1, 3)
            d = rng.randn(3)
            d /= np.linalg.norm(d) + 1e-9
            t = rng.uniform(0, 1.5, (n, 1))
            p = a + t * d + rng.randn(n, 3) * 0.01
        else:  # shower: anisotropic blob
            c = rng.uniform(-1, 1, 3)
            cov = rng.randn(3, 3) * 0.15
            p = c + rng.randn(n, 3) @ cov
        val = np.abs(rng.randn(n, 1) * 0.5 + 1.0)
        pts.append(np.concatenate([p, val], axis=1))
        labels.append(np.full(n, cls, np.int32))
        remaining -= n
    points = np.concatenate(pts).astype(np.float32)
    labels = np.concatenate(labels)
    perm = rng.permutation(len(points))
    weights = None
    if with_weights:
        # emphasize the rarer class, as the reference's per-point weights do
        counts = np.bincount(labels, minlength=num_class).astype(np.float64)
        w = (len(labels) / np.maximum(counts, 1.0))[labels]
        weights = (w / w.mean()).astype(np.float32)[perm]
    return Event(id=-1, points=points[perm], labels=labels[perm], weights=weights)


class SyntheticIO(IOBase):
    """In-memory reader over generated events (variable lengths)."""

    def __init__(
        self,
        num_events: int = 64,
        num_point: int = 1024,
        num_class: int = 2,
        seed: int = 0,
        variable_length: bool = True,
        with_weights: bool = False,
    ):
        self._n = num_events
        self._num_point = num_point
        self._num_class = num_class
        self._seed = seed
        self._variable = variable_length
        self._with_weights = with_weights
        self._events = None

    def initialize(self):
        rng = np.random.RandomState(self._seed)
        self._events = []
        for i in range(self._n):
            n = (
                int(rng.randint(self._num_point // 2, self._num_point + 1))
                if self._variable
                else self._num_point
            )
            ev = make_event(rng, n, self._num_class, self._with_weights)
            ev.id = i
            self._events.append(ev)
        return self

    def num_events(self):
        return self._n

    def read_event(self, i):
        return self._events[i]


def write_canonical(path: str, events, format: str = "h5"):
    """Write events in the canonical offsets layout (h5 or npz)."""
    points = np.concatenate([e.points for e in events]).astype(np.float32)
    offsets = np.zeros(len(events) + 1, np.int64)
    np.cumsum([len(e) for e in events], out=offsets[1:])
    arrays = {"data": points, "offsets": offsets}
    # all or nothing per array, as write_dgb: a mixed event list writes
    # no labels (or weights) rather than misaligned ones
    for key, attr, dtype in (("label", "labels", np.int32),
                             ("weight", "weights", np.float32)):
        have = [getattr(e, attr) is not None for e in events]
        if all(have):
            arrays[key] = np.concatenate(
                [getattr(e, attr) for e in events]
            ).astype(dtype)
        elif any(have):
            print(
                f"write_canonical: {sum(have)}/{len(events)} events carry "
                f"{attr}; mixed lists write NO {key} array",
                flush=True,
            )
    if format == "h5":
        from dgcnn_tpu_torch.io.readers import H5IO

        with H5IO.h5py().File(path, "w") as f:
            for k, v in arrays.items():
                f.create_dataset(k, data=v)
    elif format == "npz":
        np.savez(path, **arrays)
    else:
        raise ValueError(f"unknown format {format!r}")
