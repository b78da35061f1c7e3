"""Inference prediction write-back, streamed at bounded memory (port of
`dgcnn_tpu/io/writeback.py::SegmentWriter`).

Predictions (argmax labels) and softmax scores are stored per event, keyed
by the original event ids; a repeated event (batch fill-up) keeps its
first write. `store_segment` appends raw bytes to temporary side files next
to the output, and `finalize` assembles the final h5/npz/csv from memory
maps in sorted event-id order, so the host never holds more than one event.
The files hold the same contents as the JAX package's.
"""

from __future__ import annotations

import csv as _csv
import os

import numpy as np


class SegmentWriter:
    """Stream per-event predictions to disk, then write one output file.

    Events sorted by id, first write per id wins, the canonical offsets
    layout (plus ``prediction``, ``scores`` and ``event_ids``) for h5/npz
    and one row per point for csv.
    """

    def __init__(self, path: str, format: str = None):
        self.path = path
        if format is None:
            format = (
                "h5"
                if path.endswith((".h5", ".hdf5"))
                else "npz" if path.endswith(".npz") else "csv"
            )
        if format not in ("h5", "npz", "csv"):
            raise ValueError(f"unknown format {format!r}")
        self.format = format
        self._seen = set()
        self._ids = []      # arrival order
        self._nrows = []    # per event
        self._tmp = {}      # name -> open file handle
        self._f = None      # point feature width
        self._nscore = None  # score width; None until first event, -1 = none

    # ------------------------------------------------------------ storing

    def _tmp_path(self, name: str) -> str:
        return f"{self.path}.tmp.{name}"

    def store_segment(self, event_id: int, points, prediction, scores=None):
        """Record one event's per-point predictions (first write wins —
        repeated ids from batch fill-up are ignored)."""
        event_id = int(event_id)
        if event_id in self._seen:
            return
        points = np.ascontiguousarray(points, np.float32)
        prediction = np.ascontiguousarray(prediction, np.int32)
        if points.ndim != 2 or len(points) != len(prediction):
            raise ValueError(
                f"event {event_id}: points {points.shape} vs "
                f"prediction {prediction.shape}"
            )
        if self._nscore is None:
            self._f = points.shape[1]
            self._nscore = -1 if scores is None else int(
                np.shape(scores)[-1]
            )
            for name in ("points", "pred") + (
                ("scores",) if self._nscore > 0 else ()
            ):
                self._tmp[name] = open(self._tmp_path(name), "wb")
        if points.shape[1] != self._f:
            raise ValueError(
                f"event {event_id}: {points.shape[1]} point features, "
                f"expected {self._f}"
            )
        if (scores is None) != (self._nscore < 0):
            raise ValueError(
                f"event {event_id}: scores must be passed for all events "
                "or none"
            )
        self._seen.add(event_id)
        self._ids.append(event_id)
        self._nrows.append(len(prediction))
        self._tmp["points"].write(points.tobytes())
        self._tmp["pred"].write(prediction.tobytes())
        if self._nscore > 0:
            scores = np.ascontiguousarray(scores, np.float32)
            if scores.shape != (len(prediction), self._nscore):
                raise ValueError(
                    f"event {event_id}: scores {scores.shape}, expected "
                    f"({len(prediction)}, {self._nscore})"
                )
            self._tmp["scores"].write(scores.tobytes())

    def __len__(self):
        return len(self._ids)

    # ---------------------------------------------------------- finalizing

    def _memmaps(self, total: int):
        for fh in self._tmp.values():
            fh.close()
        if total == 0:
            # every stored event was empty: numpy refuses to mmap
            # zero-byte files, so serve zero-row arrays; the writers
            # below still produce a complete output
            mm = {
                "points": np.zeros((0, self._f), np.float32),
                "pred": np.zeros((0,), np.int32),
            }
            if self._nscore > 0:
                mm["scores"] = np.zeros((0, self._nscore), np.float32)
            return mm
        mm = {
            "points": np.memmap(
                self._tmp_path("points"), np.float32, "r", shape=(total, self._f)
            ),
            "pred": np.memmap(
                self._tmp_path("pred"), np.int32, "r", shape=(total,)
            ),
        }
        if self._nscore > 0:
            mm["scores"] = np.memmap(
                self._tmp_path("scores"), np.float32, "r",
                shape=(total, self._nscore),
            )
        return mm

    def _cleanup(self):
        for name in ("points", "pred", "scores"):
            try:
                os.unlink(self._tmp_path(name))
            except FileNotFoundError:
                pass
        self._tmp = {}

    def finalize(self):
        if not self._ids:
            return
        ids = np.asarray(self._ids, np.int64)
        nrows = np.asarray(self._nrows, np.int64)
        starts = np.zeros(len(ids) + 1, np.int64)
        np.cumsum(nrows, out=starts[1:])
        total = int(starts[-1])
        order = np.argsort(ids, kind="stable")
        try:
            mm = self._memmaps(total)
            if self.format == "csv":
                self._write_csv(ids, order, starts, nrows, mm)
            else:
                self._write_offsets_layout(ids, order, starts, nrows, mm, total)
        finally:
            # POSIX allows unlinking files that are still mapped
            self._cleanup()

    def _write_csv(self, ids, order, starts, nrows, mm):
        with open(self.path, "w", newline="") as fh:
            w = _csv.writer(fh)
            nscore = max(self._nscore, 0)
            w.writerow(
                ["event_id", "x", "y", "z", "value", "prediction"]
                + [f"score{c}" for c in range(nscore)]
            )
            for e in order:
                lo, hi = starts[e], starts[e] + nrows[e]
                pts = np.asarray(mm["points"][lo:hi])
                pred = np.asarray(mm["pred"][lo:hi])
                sc = np.asarray(mm["scores"][lo:hi]) if nscore else None
                eid = int(ids[e])
                for j in range(len(pred)):
                    row = (
                        [eid]
                        + [f"{v:.6g}" for v in pts[j]]
                        + [int(pred[j])]
                    )
                    if sc is not None:
                        row += [f"{v:.6g}" for v in sc[j]]
                    w.writerow(row)

    def _write_offsets_layout(self, ids, order, starts, nrows, mm, total):
        from numpy.lib.format import open_memmap

        from dgcnn_tpu_torch.io.stream import write_h5_streamed, write_npz_streamed

        out_offsets = np.zeros(len(ids) + 1, np.int64)
        np.cumsum(nrows[order], out=out_offsets[1:])
        in_order = bool(np.all(order == np.arange(len(order))))
        specs = [("data", mm["points"]), ("prediction", mm["pred"])]
        if self._nscore > 0:
            specs.append(("scores", mm["scores"]))

        reorder_parts = []
        arrays = {}
        try:
            for name, src in specs:
                if in_order:
                    arrays[name] = src
                else:
                    # per-event reorder into a disk-backed part first
                    part = f"{self.path}.tmp.sorted.{name}.npy"
                    dst = open_memmap(
                        part, mode="w+", dtype=src.dtype, shape=src.shape
                    )
                    for o, e in enumerate(order):
                        lo, hi = starts[e], starts[e] + nrows[e]
                        dst[out_offsets[o] : out_offsets[o + 1]] = src[lo:hi]
                    dst.flush()
                    arrays[name] = dst
                    reorder_parts.append(part)
            arrays["offsets"] = out_offsets
            arrays["event_ids"] = ids[order]
            if self.format == "h5":
                write_h5_streamed(self.path, arrays)
            else:
                write_npz_streamed(self.path, arrays)
        finally:
            del arrays
            for part in reorder_parts:
                try:
                    os.unlink(part)
                except FileNotFoundError:
                    pass
