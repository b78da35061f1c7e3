"""DGB ("dynamic-graph binary") event store (port of `dgcnn_tpu/io/dgb.py`).

A flat, mmap-able binary layout (the header is documented in
``io/native/event_reader.cpp``) that the C++ reader serves with zero-copy
event access and threaded padded-batch assembly straight into numpy
buffers. A numpy memmap view serves the same events and batches, bit for
bit, where the native library did not build.

Write with `write_dgb` (or ``python -m dgcnn_tpu_torch.io.convert ...
out.dgb``).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from dgcnn_tpu_torch.io import native
from dgcnn_tpu_torch.io.batching import Batch
from dgcnn_tpu_torch.io.crop import CROP_MODES, crop_select
from dgcnn_tpu_torch.io.readers import Event, IOBase

MAGIC = b"DGB1"
_FLAG_LABELS = 1
_FLAG_WEIGHTS = 2

# batches assembled by the C++ reader (`DGBIO.read_batch` on the native
# path) in this process; the smoke run reads it to show the loop went
# through the native reader
native_batches = 0


def write_dgb(path: str, events) -> None:
    """Serialize events into the DGB layout."""
    points = np.ascontiguousarray(
        np.concatenate([e.points for e in events]), np.float32
    )
    f = points.shape[1]
    offsets = np.zeros(len(events) + 1, np.uint64)
    np.cumsum([len(e) for e in events], out=offsets[1:])
    flags = 0
    labels = weights = None
    if all(e.labels is not None for e in events):
        flags |= _FLAG_LABELS
        labels = np.ascontiguousarray(
            np.concatenate([e.labels for e in events]), np.int32
        )
    if all(e.weights is not None for e in events):
        flags |= _FLAG_WEIGHTS
        weights = np.ascontiguousarray(
            np.concatenate([e.weights for e in events]), np.float32
        )
    with open(path, "wb") as fh:
        fh.write(MAGIC)
        fh.write(struct.pack("<IQII", f, len(events), flags, 0))
        fh.write(offsets.tobytes())
        fh.write(points.tobytes())
        if labels is not None:
            fh.write(labels.tobytes())
        if weights is not None:
            fh.write(weights.tobytes())


class DGBIO(IOBase):
    """Reader over a DGB file: the C++ path, or the numpy view."""

    def __init__(self, path):
        self.path = path
        self._lib = None
        self._handle = None
        self._mm = None

    # ------------------------------------------------------------ lifecycle

    def initialize(self):
        # the numpy view first: it rejects corrupt files (bad magic,
        # truncation, non-monotonic offsets) before a native handle exists,
        # so a raise never leaks the C++ mmap
        self._init_python_view()
        self._lib = native.load()
        if self._lib is not None:
            self._handle = self._lib.dgb_open(self.path.encode())
            if not self._handle:
                self._lib = None  # the numpy view reports
        return self

    def _init_python_view(self):
        """np.memmap view (validates the file and serves read_event)."""
        with open(self.path, "rb") as fh:
            head = fh.read(0x18)
        if head[:4] != MAGIC:
            raise ValueError(f"{self.path}: not a DGB file")
        f, e, flags, _ = struct.unpack("<IQII", head[4:0x18])
        self._f, self._e, self._flags = int(f), int(e), int(flags)
        mm = np.memmap(self.path, dtype=np.uint8, mode="r")
        pos = 0x18
        if pos + (e + 1) * 8 > mm.size:
            raise ValueError(f"{self.path}: truncated DGB file")
        self._offsets = mm[pos : pos + (e + 1) * 8].view(np.uint64)
        pos += (e + 1) * 8
        # a non-monotonic table would make offsets[i+1] - offsets[i] wrap
        # to a huge count and drive out-of-bounds reads in either reader
        if int(self._offsets[0]) != 0 or np.any(np.diff(self._offsets.astype(np.int64)) < 0):
            raise ValueError(f"{self.path}: corrupt DGB offsets table")
        total = int(self._offsets[-1])
        expect = (
            pos
            + total * f * 4
            + (total * 4 if flags & _FLAG_LABELS else 0)
            + (total * 4 if flags & _FLAG_WEIGHTS else 0)
        )
        if expect > mm.size:
            raise ValueError(f"{self.path}: truncated DGB file")
        self._points = mm[pos : pos + total * f * 4].view(np.float32).reshape(
            total, f
        )
        pos += total * f * 4
        self._labels = None
        if flags & _FLAG_LABELS:
            self._labels = mm[pos : pos + total * 4].view(np.int32)
            pos += total * 4
        self._weights = None
        if flags & _FLAG_WEIGHTS:
            self._weights = mm[pos : pos + total * 4].view(np.float32)
            pos += total * 4
        self._mm = mm

    def finalize(self):
        if self._handle and self._lib is not None:
            self._lib.dgb_close(self._handle)
            self._handle = None
        self._mm = None

    # ------------------------------------------------------------- reading

    @property
    def native_active(self) -> bool:
        """True when batches come from the C++ reader."""
        return bool(self._handle)

    def num_events(self) -> int:
        return self._e

    def event_lengths(self):
        """All event sizes from the offsets table (no point-data IO)."""
        return np.diff(np.asarray(self._offsets)).astype(np.int64)

    def read_event(self, i: int) -> Event:
        lo, hi = int(self._offsets[i]), int(self._offsets[i + 1])
        return Event(
            id=i,
            points=np.asarray(self._points[lo:hi]),
            labels=(
                np.asarray(self._labels[lo:hi]) if self._labels is not None else None
            ),
            weights=(
                np.asarray(self._weights[lo:hi])
                if self._weights is not None
                else None
            ),
        )

    def read_batch(
        self,
        event_ids,
        n_pad: int,
        crop: int = 0,
        crop_mode: str = "random",
        seed: int = 0,
    ) -> Batch:
        """Assemble a padded batch. Native path: one C++ worker thread per
        event, memcpy from the mmap, no per-event Python objects. Both
        paths implement the canonical crop policy (`io.crop.crop_select`)
        bit-identically."""
        global native_batches
        ids = np.ascontiguousarray(event_ids, np.int64)
        b = len(ids)
        points = np.empty((b, n_pad, self._f), np.float32)
        labels = np.empty((b, n_pad), np.int32)
        weights = (
            np.empty((b, n_pad), np.float32)
            if self._flags & _FLAG_WEIGHTS
            else None
        )
        mask8 = np.empty((b, n_pad), np.uint8)
        lengths = np.empty((b,), np.int64)
        mode_id = CROP_MODES.index(crop_mode)  # 0=random, 1=stride
        if self.native_active:
            rc = self._lib.dgb_read_batch(
                self._handle,
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                b,
                n_pad,
                crop or n_pad,
                mode_id,
                ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF),
                points.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                (
                    weights.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                    if weights is not None
                    else None
                ),
                mask8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            if rc != 0:
                raise IndexError(f"bad event id in {ids}")
            native_batches += 1
        else:
            points[:] = 0
            labels[:] = 0
            if weights is not None:
                weights[:] = 0
            mask8[:] = 0
            eff_crop = min(crop or n_pad, n_pad)
            for j, eid in enumerate(ids):
                ev = self.read_event(int(eid))
                n = len(ev)
                lengths[j] = n
                m = min(n, eff_crop)
                if n <= eff_crop:
                    sel = slice(None)
                else:
                    sel = crop_select(n, m, crop_mode, seed, int(eid))
                points[j, :m] = ev.points[sel]
                if ev.labels is not None:
                    labels[j, :m] = ev.labels[sel]
                if weights is not None and ev.weights is not None:
                    weights[j, :m] = ev.weights[sel]
                mask8[j, :m] = 1
        return Batch(
            points=points,
            labels=labels,
            weights=weights,
            mask=mask8.astype(bool),
            event_ids=ids,
            lengths=lengths,
        )
