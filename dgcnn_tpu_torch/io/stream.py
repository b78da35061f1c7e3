"""Bounded-memory helpers for large on-disk datasets (port of
`dgcnn_tpu/io/stream.py`).

Shared by the inference write-back (`io.writeback.SegmentWriter`) and the
converter (`io.convert`): both spool per-event bytes into temporary side
files and assemble the final h5/npz/dgb from memory maps, so the output's
size never drives the host's memory.
"""

from __future__ import annotations

import os

import numpy as np

_CHUNK_BYTES = 64 << 20


def copy_chunked(dst, src):
    """dst[:] = src in bounded chunks (both array-likes, same shape)."""
    n = src.shape[0]
    chunk = max(1, _CHUNK_BYTES // max(int(np.prod(src.shape[1:], dtype=np.int64)) * src.dtype.itemsize, 1))
    for lo in range(0, n, chunk):
        dst[lo : lo + chunk] = src[lo : lo + chunk]


def write_npz_streamed(path: str, arrays):
    """Write an .npz (zip of .npy members) from ``{name: array-like}``
    without holding the arrays in memory: each member is written as a
    disk-backed .npy part (chunked copy), then stored into the zip from
    disk. ``np.load`` reads it as it reads ``np.savez`` output."""
    import zipfile

    from numpy.lib.format import open_memmap

    parts = []
    try:
        for name, src in arrays.items():
            part = f"{path}.tmp.{name}.npy"
            src = src if hasattr(src, "dtype") else np.asarray(src)
            dst = open_memmap(part, mode="w+", dtype=src.dtype, shape=src.shape)
            copy_chunked(dst, src)
            dst.flush()
            del dst
            parts.append((part, f"{name}.npy"))
        with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
            for part, arcname in parts:
                zf.write(part, arcname)
    finally:
        for part, _ in parts:
            try:
                os.unlink(part)
            except FileNotFoundError:
                pass


def write_h5_streamed(path: str, arrays):
    """Write an HDF5 file from ``{name: array-like}`` with chunked copies
    (needs ``h5py``)."""
    from dgcnn_tpu_torch.io.readers import H5IO

    with H5IO.h5py().File(path, "w") as f:
        for name, src in arrays.items():
            src = src if hasattr(src, "dtype") else np.asarray(src)
            copy_chunked(f.create_dataset(name, src.shape, src.dtype), src)
