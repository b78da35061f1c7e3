"""Event-file readers (port of `dgcnn_tpu/io/readers.py`).

The port reads the JAX package's canonical formats (see `io.convert` for
the offline converter) and gives the same events, bit for bit:

Canonical offsets layout (h5 / npz):
  <data_key>   (total_points, F) float32   — [x, y, z, value, ...]
  <label_key>  (total_points,)  int        — per-point class
  <weight_key> (total_points,)  float32    — optional per-point loss weight
  offsets      (num_events + 1,) int64     — event i = rows [off[i], off[i+1])

CSV layout: ``event_id,x,y,z,value,label[,weight]`` with optional header.
DGB: the flat binary layout of `io.dgb`, read by a C++ batch assembler
(`io.native`) or a numpy memmap view.

``h5py`` is imported by `H5IO` alone, so every other format runs where it
is not installed.
"""

from __future__ import annotations

import csv as _csv
import dataclasses
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Event:
    """One sparse detector event: a variable-length labeled point cloud.

    ``id`` is what write-back reports (the file's own event identifier:
    positional for offset-layout formats, the raw event_id column for
    CSV). ``ordinal`` is the event's position in its file and is what
    seeded policies (crop) key on, so the same file gives the same batches
    through every reader; it defaults to ``id``."""

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


class SubsetIO(IOBase):
    """A contiguous id-range view of another reader (a process's slice of
    the event file under multi-process data parallelism)."""

    def __init__(self, io: IOBase, lo: int, hi: int):
        self._io, self._lo, self._hi = io, lo, hi

    def initialize(self):
        return self

    def num_events(self) -> int:
        return self._hi - self._lo

    def event_lengths(self):
        fast = getattr(self._io, "event_lengths", None)
        if fast is not None:
            return fast()[self._lo : self._hi]
        return np.array(
            [len(self._io.read_event(self._lo + i)) for i in range(self.num_events())]
        )

    def read_event(self, i: int) -> Event:
        ev = self._io.read_event(self._lo + i)
        return Event(ev.id, ev.points, ev.labels, ev.weights, ev.ordinal)

    def __getattr__(self, name):
        # the native batch path only when the inner reader has it
        # (BucketBatcher looks it up with getattr(..., None))
        if name == "read_batch":
            inner = getattr(self._io, "read_batch")  # may raise AttributeError

            def read_batch(event_ids, n_pad, crop=0, **kw):
                return inner(
                    [self._lo + int(i) for i in event_ids], n_pad, crop, **kw
                )

            return read_batch
        raise AttributeError(name)

    def finalize(self):
        self._io.finalize()


class _OffsetArraysIO(IOBase):
    """Shared logic for the canonical offsets layout (h5 and npz)."""

    def __init__(self, path, data_key="data", label_key="label", weight_key=""):
        self.path = path
        self.data_key = data_key or "data"
        self.label_key = label_key or "label"
        self.weight_key = weight_key
        self._points = self._labels = self._weights = self._offsets = None

    def _load_arrays(self):
        raise NotImplementedError

    def initialize(self):
        self._load_arrays()
        if self._offsets is None:
            # single-event file: everything is one event
            self._offsets = np.array([0, len(self._points)], np.int64)
        if self._points.ndim != 2:
            raise ValueError(
                f"{self.path}: expected (total_points, F) data, got "
                f"{self._points.shape}"
            )
        return self

    def num_events(self) -> int:
        return len(self._offsets) - 1

    def event_lengths(self):
        """All event sizes without touching point data (offsets diff)."""
        return np.diff(np.asarray(self._offsets)).astype(np.int64)

    def read_event(self, i: int) -> Event:
        lo, hi = int(self._offsets[i]), int(self._offsets[i + 1])
        return Event(
            id=i,
            points=np.asarray(self._points[lo:hi], np.float32),
            labels=(
                np.asarray(self._labels[lo:hi], np.int32)
                if self._labels is not None
                else None
            ),
            weights=(
                np.asarray(self._weights[lo:hi], np.float32)
                if self._weights is not None
                else None
            ),
        )


class H5IO(_OffsetArraysIO):
    """HDF5 reader. Arrays are read lazily per event; needs ``h5py``."""

    @staticmethod
    def h5py():
        """The ``h5py`` module (the port's one import of it: the h5 writers
        take it from here), or an ImportError that says what to do."""
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                "HDF5 files need h5py, which is not installed here; use npz, "
                "csv or dgb, or convert the file once where h5py is "
                "(python -m dgcnn_tpu_torch.io.convert convert in.h5 out.dgb)"
            ) from e
        return h5py

    def _load_arrays(self):
        self._file = self.h5py().File(self.path, "r")
        f = self._file
        if self.data_key not in f:
            raise KeyError(f"{self.path}: missing dataset {self.data_key!r}")
        self._points = f[self.data_key]
        self._labels = f.get(self.label_key)
        self._weights = f.get(self.weight_key) if self.weight_key else None
        self._offsets = (
            np.asarray(f["offsets"], np.int64) if "offsets" in f else None
        )

    def finalize(self):
        if getattr(self, "_file", None) is not None:
            self._file.close()
            self._file = None


class NPZIO(_OffsetArraysIO):
    """NPZ reader: the same canonical layout, fully in memory."""

    def _load_arrays(self):
        with np.load(self.path) as z:
            if self.data_key not in z:
                raise KeyError(f"{self.path}: missing array {self.data_key!r}")
            self._points = np.asarray(z[self.data_key], np.float32)
            self._labels = (
                np.asarray(z[self.label_key], np.int32)
                if self.label_key in z
                else None
            )
            self._weights = (
                np.asarray(z[self.weight_key], np.float32)
                if self.weight_key and self.weight_key in z
                else None
            )
            self._offsets = (
                np.asarray(z["offsets"], np.int64) if "offsets" in z else None
            )


class CSVIO(IOBase):
    """CSV reader: event_id,x,y,z,value,label[,weight]."""

    COLUMNS = ("event_id", "x", "y", "z", "value", "label", "weight")

    def __init__(self, path):
        self.path = path
        self._events = []

    def initialize(self):
        rows_by_event = {}
        with open(self.path, newline="") as fh:
            for row in _csv.reader(fh):
                if not row:
                    continue
                if row[0].strip().lower() in ("event_id", "event", "id"):
                    continue  # header
                vals = [float(v) for v in row]
                rows_by_event.setdefault(int(vals[0]), []).append(vals[1:])
        for eid in sorted(rows_by_event):
            arr = np.asarray(rows_by_event[eid], np.float32)
            has_label = arr.shape[1] >= 5
            has_weight = arr.shape[1] >= 6
            # id = the file's raw event_id (kept in write-back); ordinal =
            # position, so seeded crops match the offset-layout readers
            self._events.append(
                Event(
                    id=eid,
                    points=arr[:, :4],
                    labels=arr[:, 4].astype(np.int32) if has_label else None,
                    weights=arr[:, 5] if has_weight else None,
                    ordinal=len(self._events),
                )
            )
        return self

    def num_events(self) -> int:
        return len(self._events)

    def read_event(self, i: int) -> Event:
        return self._events[i]


def reader_for(kind: str, path: str, data_key="data", label_key="label",
               weight_key="") -> IOBase:
    """The one io_type -> reader dispatch, shared by `io_factory` (the
    CLI) and `io.convert.read_any` (the converter)."""
    if kind == "csv":
        return CSVIO(path)
    if kind == "dgb":
        from dgcnn_tpu_torch.io.dgb import DGBIO

        return DGBIO(path)
    cls = {"h5": H5IO, "npz": NPZIO}.get(kind)
    if cls is None:
        raise ValueError(f"unknown io_type {kind!r}")
    return cls(path, data_key, label_key, weight_key)


def kind_of_path(path: str, default: str = "h5") -> str:
    """Reader kind by file extension; unknown extensions -> ``default``."""
    lowered = path.lower()
    for ext, kind in (
        (".csv", "csv"), (".npz", "npz"), (".dgb", "dgb"),
        (".h5", "h5"), (".hdf5", "h5"),
    ):
        if lowered.endswith(ext):
            return kind
    return default


def io_factory(cfg) -> IOBase:
    """Build a reader from a Config."""
    kind = cfg.io_type
    if kind == "synthetic":
        from dgcnn_tpu_torch.io.synthetic import SyntheticIO

        return SyntheticIO(
            num_events=max(cfg.minibatch_size * 8, 64),
            num_class=cfg.num_class,
            seed=cfg.seed,
            num_point=cfg.num_point or 1024,
        )
    if not cfg.input_file:
        raise ValueError(f"io_type={kind!r} requires --input_file")
    if not os.path.exists(cfg.input_file):
        raise FileNotFoundError(cfg.input_file)
    if kind == "larcv":
        # ROOT files are not read directly: dump once offline, train on
        # the canonical formats
        raise ValueError(
            "io_type=larcv: ROOT files are not read directly. Dump the "
            "events to CSV with larcv tooling, then convert once:\n"
            "  python -m dgcnn_tpu_torch.io.convert csv2dgb dump.csv events.dgb\n"
            "and train with -io dgb -if events.dgb (or csv2h5 / csv2npz)."
        )
    if kind in ("dgb", "csv"):
        # fixed-layout formats: the key flags do not apply
        if (
            cfg.data_key not in ("", "data")
            or cfg.label_key not in ("", "label")
            or cfg.weight_key
        ):
            raise ValueError(
                f"io_type={kind}: data_key/label_key/weight_key do not "
                f"apply (the {kind.upper()} layout is fixed); drop the "
                f"key flags or use -io h5/npz"
            )
    return reader_for(
        kind, cfg.input_file, cfg.data_key, cfg.label_key, cfg.weight_key
    )
