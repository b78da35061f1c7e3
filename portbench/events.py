"""The benchmark's events, made from ``--seed`` by one general generator.

A traffic file (``workloads/<cell>.json``) names its mix by parameters
only; `event_pool` reads them:

- ``pool``: how many distinct events the run cycles through;
- ``num_point``: the longest event; with ``variable_length`` the pool's
  lengths are spread evenly over ``[num_point // 2, num_point]`` (the
  range of the generator's rule) and the seed orders them, so that every
  seed brings the same set of sizes and only the points and their order
  differ; else every event has ``num_point`` points;
- ``num_class``: the label classes.

`make_event` is a frozen copy of the port's synthetic LArTPC event
(`dgcnn_tpu_torch/io/synthetic.py`): tracks (points along straight
lines, class 0) and shower blobs (class 1 and up), with an energy
channel. It is copied here so that a change to the program cannot move
the benchmark's inputs; for one seed it draws what the port's
``SyntheticIO`` draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Event:
    """One event as the benchmark made it: ``points`` ``(n, 4)`` float32
    (x, y, z, energy) and ``labels`` ``(n,)`` int32."""

    points: np.ndarray
    labels: np.ndarray

    def __len__(self) -> int:
        return self.points.shape[0]


def make_event(rng: np.random.RandomState, num_point: int, num_class: int = 2) -> Event:
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
    return Event(points=points[perm], labels=labels[perm])


def rng_for(seed: int) -> np.random.RandomState:
    """The events' stream for ``seed`` (any whole number; numpy's legacy
    stream takes 32 bits, so larger seeds fold)."""
    return np.random.RandomState(int(seed) % 2**32)


def event_pool(traffic: dict, seed: int) -> list[Event]:
    """The cell's distinct events, in the order the run cycles them."""
    rng = rng_for(seed)
    n_max, size = int(traffic["num_point"]), int(traffic["pool"])
    lengths = [n_max] * size
    if traffic["variable_length"]:
        lengths = rng.permutation(np.linspace(n_max // 2, n_max, size).round().astype(int))
    return [make_event(rng, int(n), int(traffic["num_class"])) for n in lengths]
