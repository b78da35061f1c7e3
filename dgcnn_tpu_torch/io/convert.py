"""Offline dataset converter and generator (port of
`dgcnn_tpu/io/convert.py`).

Detector dumps (CSV) are converted once into the formats the training
path reads (h5, npz, dgb), and a synthetic generator makes smoke and
benchmark datasets. Outputs hold the same arrays as the JAX package's.

Usage:
  python -m dgcnn_tpu_torch.io.convert csv2h5  in.csv out.h5
  python -m dgcnn_tpu_torch.io.convert csv2npz in.csv out.npz
  python -m dgcnn_tpu_torch.io.convert csv2dgb in.csv out.dgb
  python -m dgcnn_tpu_torch.io.convert convert in.h5 out.dgb   # any -> any
  python -m dgcnn_tpu_torch.io.convert synth   out.dgb --events 128 --points 4096

h5 needs ``h5py``; npz, csv and dgb need only numpy.
"""

from __future__ import annotations

import argparse
import os
import struct

import numpy as np

from dgcnn_tpu_torch.io.readers import CSVIO
from dgcnn_tpu_torch.io.synthetic import SyntheticIO, write_canonical


def write_any(path: str, events):
    """Write events in the format implied by the extension (h5/npz/dgb)."""
    if path.endswith(".dgb"):
        from dgcnn_tpu_torch.io.dgb import write_dgb

        write_dgb(path, events)
    elif path.endswith(".npz"):
        write_canonical(path, events, "npz")
    else:
        write_canonical(path, events, "h5")


def write_stream(path: str, events_iter):
    """Stream events to ``path`` (h5/npz/dgb by extension) at flat RSS.

    The in-memory `write_any` concatenates every event before writing;
    this variant spools per-event bytes to temporary side files and
    assembles the final file from memory maps. Output is array-identical
    to `write_any` on the same events. Returns ``(n_events, n_points)``.
    """
    from dgcnn_tpu_torch.io.stream import write_h5_streamed, write_npz_streamed

    tmp = {
        name: open(f"{path}.tmp.{name}", "wb")
        for name in ("points", "labels", "weights")
    }
    nrows, n_l, n_w, width = [], 0, 0, None
    try:
        for ev in events_iter:
            pts = np.ascontiguousarray(ev.points, np.float32)
            if width is None:
                width = pts.shape[1]
            elif pts.shape[1] != width:
                raise ValueError(
                    f"event {ev.id}: {pts.shape[1]} features, expected {width}"
                )
            nrows.append(len(pts))
            tmp["points"].write(pts.tobytes())
            if ev.labels is not None:
                tmp["labels"].write(
                    np.ascontiguousarray(ev.labels, np.int32).tobytes()
                )
                n_l += 1
            if ev.weights is not None:
                tmp["weights"].write(
                    np.ascontiguousarray(ev.weights, np.float32).tobytes()
                )
                n_w += 1
    except BaseException:
        # a failed spool must not strand .tmp.* files next to the output
        for fh in tmp.values():
            fh.close()
        for name in tmp:
            try:
                os.unlink(f"{path}.tmp.{name}")
            except FileNotFoundError:
                pass
        raise
    finally:
        for fh in tmp.values():
            fh.close()
    n = len(nrows)
    if n == 0:
        for name in tmp:
            os.unlink(f"{path}.tmp.{name}")
        raise ValueError(f"no events to write to {path}")
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(nrows, out=offsets[1:])
    total = int(offsets[-1])
    # all-or-nothing per array, matching write_any/write_dgb semantics
    all_l, all_w = n_l == n, n_w == n
    for key, cnt in (("label", n_l), ("weight", n_w)):
        if 0 < cnt < n:
            print(
                f"write_stream: {cnt}/{n} events carry {key}s; mixed "
                f"inputs write NO {key} array",
                flush=True,
            )
    mm = {}
    try:
        mm["points"] = np.memmap(
            f"{path}.tmp.points", np.float32, "r", shape=(total, width)
        )
        if all_l:
            mm["labels"] = np.memmap(
                f"{path}.tmp.labels", np.int32, "r", shape=(total,)
            )
        if all_w:
            mm["weights"] = np.memmap(
                f"{path}.tmp.weights", np.float32, "r", shape=(total,)
            )
        if path.endswith(".dgb"):
            from dgcnn_tpu_torch.io.dgb import _FLAG_LABELS, _FLAG_WEIGHTS, MAGIC

            flags = (_FLAG_LABELS if all_l else 0) | (
                _FLAG_WEIGHTS if all_w else 0
            )
            with open(path, "wb") as fh:
                fh.write(MAGIC)
                fh.write(struct.pack("<IQII", width, n, flags, 0))
                fh.write(offsets.astype(np.uint64).tobytes())
                for name in ("points", "labels", "weights"):
                    if name in mm:
                        src = mm[name]
                        step = max(1, (64 << 20) // max(
                            src.dtype.itemsize * (width if name == "points" else 1), 1
                        ))
                        for lo in range(0, total, step):
                            fh.write(
                                np.ascontiguousarray(src[lo : lo + step]).tobytes()
                            )
        else:
            arrays = {"data": mm["points"], "offsets": offsets}
            if all_l:
                arrays["label"] = mm["labels"]
            if all_w:
                arrays["weight"] = mm["weights"]
            if path.endswith(".npz"):
                write_npz_streamed(path, arrays)
            else:
                write_h5_streamed(path, arrays)
    finally:
        del mm
        for name in tmp:
            try:
                os.unlink(f"{path}.tmp.{name}")
            except FileNotFoundError:
                pass
    return n, total


def read_any(path: str, data_key="data", label_key="label", weight_key=""):
    """Reader chosen by extension (csv/h5/npz/dgb); returns event list.

    Dispatch is shared with the training path (`readers.reader_for`), so
    converter and trainer agree about every format. For large inputs
    prefer `open_any` + `write_stream`, which never hold the dataset."""
    io = open_any(path, data_key, label_key, weight_key)
    events = [io.read_event(i) for i in range(io.num_events())]
    io.finalize()
    return events


def open_any(path: str, data_key="data", label_key="label", weight_key=""):
    """Open an initialized reader for ``path`` by extension."""
    from dgcnn_tpu_torch.io.readers import kind_of_path, reader_for

    io = reader_for(kind_of_path(path), path, data_key, label_key, weight_key)
    io.initialize()
    return io


def main(argv=None):
    p = argparse.ArgumentParser(prog="dgcnn_tpu_torch.io.convert", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("csv2h5", "csv2npz", "csv2dgb", "convert"):
        c = sub.add_parser(
            name,
            help="any->any by extension" if name == "convert" else None,
        )
        c.add_argument("input")
        c.add_argument("output")
        if name == "convert":
            c.add_argument("--data_key", default="data")
            c.add_argument("--label_key", default="label")
            # canonical weight column name; silently absent if the input
            # has no weights (readers guard on key presence)
            c.add_argument("--weight_key", default="weight")
    s = sub.add_parser("synth")
    s.add_argument("output")
    s.add_argument("--events", type=int, default=128)
    s.add_argument("--points", type=int, default=4096)
    s.add_argument("--classes", type=int, default=2)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--weights", action="store_true")
    s.add_argument("--fixed_length", action="store_true")
    ns = p.parse_args(argv)

    if ns.cmd.startswith("csv2"):
        io = CSVIO(ns.input).initialize()
        n, _ = write_stream(ns.output, iter(io))
        io.finalize()
        print(f"wrote {n} events -> {ns.output}")
    elif ns.cmd == "convert":
        io = open_any(ns.input, ns.data_key, ns.label_key, ns.weight_key)
        n, _ = write_stream(ns.output, iter(io))
        io.finalize()
        print(f"wrote {n} events -> {ns.output}")
    else:
        io = SyntheticIO(
            num_events=ns.events,
            num_point=ns.points,
            num_class=ns.classes,
            seed=ns.seed,
            variable_length=not ns.fixed_length,
            with_weights=ns.weights,
        ).initialize()
        events = [io.read_event(i) for i in range(io.num_events())]
        write_any(ns.output, events)
        total = sum(len(e) for e in events)
        print(f"wrote {len(events)} events ({total} points) -> {ns.output}")


if __name__ == "__main__":
    main()
