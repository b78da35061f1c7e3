"""Event record and reader interface (port of `dgcnn_tpu/io/readers.py`).

Only the in-memory pieces are ported so far; the h5, npz, csv and dgb
readers wait for the IO slice (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Event:
    """One sparse detector event: a variable-length labeled point cloud.

    ``id`` is what write-back reports; ``ordinal`` is the event's position
    in its file and is what seeded policies (crop) key on. It defaults to
    ``id``."""

    id: int
    points: np.ndarray  # (n, F) float32
    labels: Optional[np.ndarray] = None  # (n,) int32
    weights: Optional[np.ndarray] = None  # (n,) float32
    ordinal: Optional[int] = None  # position in file; None -> id

    @property
    def crop_key(self) -> int:
        return int(self.id if self.ordinal is None else self.ordinal)

    def __len__(self):
        return self.points.shape[0]


class IOBase:
    """Reader interface: initialize, then index events."""

    def initialize(self):
        raise NotImplementedError

    def num_events(self) -> int:
        raise NotImplementedError

    def read_event(self, i: int) -> Event:
        raise NotImplementedError

    def finalize(self):
        pass

    def __iter__(self):
        for i in range(self.num_events()):
            yield self.read_event(i)
