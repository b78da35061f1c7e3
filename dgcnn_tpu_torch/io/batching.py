"""Padded / bucketed variable-length batching with host-side prefetch
(port of `dgcnn_tpu/io/batching.py`).

Events are grouped by length and padded to the smallest bucket that fits
the batch; a validity mask threads through kNN, BN and the loss so padding
never leaks into the numerics. Batches are host numpy; the trainer moves
them to the device.

``LANE = 128`` is the JAX package's padding granule, kept as the port's:
equal padded shapes let both packages build the same batches from a file,
and 128 points is a whole number of the kNN kernels' 128-query blocks.
A reader with a ``read_batch`` method (the DGB reader's C++ path) assembles
each batch itself.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from dgcnn_tpu_torch.io.crop import crop_select
from dgcnn_tpu_torch.io.readers import Event, IOBase
from dgcnn_tpu_torch.utils.timing import span

LANE = 128  # padded point counts are multiples of this


@dataclasses.dataclass
class Batch:
    """One padded minibatch of events (host numpy)."""

    points: np.ndarray  # (B, N, F) float32
    labels: np.ndarray  # (B, N) int32 (zeros if unlabeled)
    weights: Optional[np.ndarray]  # (B, N) float32 or None
    mask: np.ndarray  # (B, N) bool
    event_ids: np.ndarray  # (B,) int64
    lengths: np.ndarray  # (B,) int64 — true (uncropped) point counts

    @property
    def num_valid(self) -> int:
        return int(self.mask.sum())


def _round_up(n: int, m: int = LANE) -> int:
    return ((n + m - 1) // m) * m


def pad_events(
    events: Sequence[Event],
    n_pad: int,
    crop: Optional[int] = None,
    crop_mode: str = "random",
    seed: int = 0,
) -> Batch:
    """Stack events into (B, n_pad, ...), cropping events longer than
    ``crop`` (default ``n_pad``) with the canonical policy (`io.crop`) and
    zero-padding shorter ones."""
    b = len(events)
    crop = min(crop or n_pad, n_pad)
    f = events[0].points.shape[1]
    points = np.zeros((b, n_pad, f), np.float32)
    labels = np.zeros((b, n_pad), np.int32)
    weights = (
        np.zeros((b, n_pad), np.float32)
        if any(e.weights is not None for e in events)
        else None
    )
    mask = np.zeros((b, n_pad), bool)
    ids = np.zeros((b,), np.int64)
    lengths = np.zeros((b,), np.int64)
    for i, ev in enumerate(events):
        n = len(ev)
        if n > crop:
            sel = crop_select(n, crop, crop_mode, seed, ev.crop_key)
        else:
            sel = slice(None)
        take = ev.points[sel]
        m = take.shape[0]
        points[i, :m] = take
        if ev.labels is not None:
            labels[i, :m] = ev.labels[sel]
        if weights is not None and ev.weights is not None:
            weights[i, :m] = ev.weights[sel]
        mask[i, :m] = True
        ids[i] = ev.id
        lengths[i] = n
    return Batch(points, labels, weights, mask, ids, lengths)


class BucketBatcher:
    """Groups events of similar length and pads to bucket boundaries.

    With ``num_point > 0`` every batch is padded/cropped to exactly that
    size (rounded up to ``LANE``). Otherwise events are sorted by length,
    batched, and padded to the smallest bucket ≥ the longest event in the
    batch.
    """

    def __init__(
        self,
        io: IOBase,
        batch_size: int,
        buckets: Sequence[int] = (1024, 4096, 16384, 32768),
        num_point: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = False,
        crop_mode: str = "random",
    ):
        self.io = io
        self.batch_size = batch_size
        self.buckets = sorted(_round_up(int(x)) for x in buckets)
        self.num_point = num_point
        self.shuffle = shuffle
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.drop_remainder = drop_remainder
        self.crop_mode = crop_mode
        self._lengths = None
        self._epochs_started = 0

    def reseed(self, seed: int) -> None:
        """Re-key the shuffle stream (a resumed run folds its step into the
        seed, so it goes on with a fresh batch order)."""
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self._epochs_started = 0

    def _crop_seed(self) -> int:
        """Shuffled (training) streams fold the epoch counter into the crop
        seed so an oversized event shows a different subset each epoch;
        unshuffled (eval) streams stay run-stable."""
        if not self.shuffle:
            return self.seed
        return self.seed + self._epochs_started * 1_000_003

    def _bucket_for(self, max_len: int) -> int:
        if self.num_point > 0:
            return _round_up(self.num_point)
        for edge in self.buckets:
            if max_len <= edge:
                return edge
        return _round_up(max_len)

    def _event_lengths(self):
        if self._lengths is None:
            # readers over an offsets table give the lengths without
            # touching point data
            fast = getattr(self.io, "event_lengths", None)
            if fast is not None:
                self._lengths = np.asarray(fast())
            else:
                self._lengths = np.array(
                    [len(self.io.read_event(i)) for i in range(self.io.num_events())]
                )
        return self._lengths

    def epoch(self) -> Iterator[Batch]:
        """One pass over the input in batches."""
        crop_seed = self._crop_seed()
        self._epochs_started += 1
        n = self.io.num_events()
        order = np.arange(n)
        lengths = self._event_lengths() if self.num_point == 0 else None
        if self.shuffle:
            self.rng.shuffle(order)
            if lengths is not None:
                # group similar lengths to reduce padding waste, keep the
                # shuffle as a tie-break within equal lengths
                order = order[np.argsort(lengths[order], kind="stable")]
        batches = [
            order[i : i + self.batch_size] for i in range(0, n, self.batch_size)
        ]
        if self.drop_remainder and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.shuffle:
            self.rng.shuffle(batches)
        native_batch = getattr(self.io, "read_batch", None)
        for idxs in batches:
            ids = list(map(int, idxs))
            n_live = len(ids)
            # static shapes: repeat events to fill a short remainder batch;
            # filler slots get an all-False mask below
            while len(ids) < self.batch_size:
                ids = ids + ids[: self.batch_size - len(ids)]
            if lengths is not None:
                n_pad = self._bucket_for(int(max(lengths[i] for i in ids)))
            else:
                n_pad = self._bucket_for(self.num_point)
            if native_batch is not None:
                batch = native_batch(ids, n_pad, crop=self.num_point or 0,
                                     crop_mode=self.crop_mode, seed=crop_seed)
            else:
                batch = pad_events(
                    [self.io.read_event(i) for i in ids],
                    n_pad,
                    crop=self.num_point or None,
                    crop_mode=self.crop_mode,
                    seed=crop_seed,
                )
            if n_live < self.batch_size:
                batch.mask[n_live:] = False
            yield batch

    def forever(self) -> Iterator[Batch]:
        """Endless epochs."""
        while True:
            yield from self.epoch()


def prefetch(it: Iterator, size: int = 2) -> Iterator:
    """Run ``it`` in a background thread, buffering ``size`` items.

    The generator's ``close()`` (or garbage collection) stops and joins the
    worker; a caller that breaks out early and then tears down the
    underlying reader must close the stream first.
    """
    if size <= 0:
        yield from it
        return
    q: queue.Queue = queue.Queue(maxsize=size)
    _END = object()
    stop = threading.Event()

    def _put(item) -> bool:
        """Blocking put that gives up when the consumer stopped."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not _put(item):
                    return
                if stop.is_set():
                    return
            _put(_END)
        except BaseException as e:  # propagate into the consumer
            _put(e)

    t = threading.Thread(target=worker, daemon=True, name="dgcnn-torch-prefetch")
    t.start()
    try:
        while True:
            with span("dgcnn.batch_wait"):
                item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # drain so a blocked put can't deadlock the join
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5.0)
