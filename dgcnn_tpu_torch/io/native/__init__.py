"""ctypes bindings for the native DGB event reader (port of
`dgcnn_tpu/io/native/__init__.py`).

``event_reader.cpp`` (this directory) builds with g++ at first use into
``build/native/libdgbio-<hash>.so`` at the repository root (a directory
that ``.gitignore`` lists), the hash covering the source and the flags.
It is host IO, not a kernel: when there is no compiler, or the build or
load fails, `load()` returns None and `io.dgb.DGBIO` serves the same
batches from its numpy view (``DGBIO.native_active`` says which).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "event_reader.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(_DIR))), "build", "native"
)
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdgbio-{h.hexdigest()[:16]}.so")


def build() -> str | None:
    """Compile the library unless it exists; its path, or None when g++
    is missing or fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, SRC, "-o", tmp], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load():
    """The loaded native library, built on first use; None on failure."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.dgb_open.restype = ctypes.c_void_p
        lib.dgb_open.argtypes = [ctypes.c_char_p]
        lib.dgb_close.argtypes = [ctypes.c_void_p]
        lib.dgb_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.dgb_event_bounds.argtypes = [
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.dgb_read_batch.restype = ctypes.c_int
        lib.dgb_read_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,   # batch
            ctypes.c_int64,   # n_pad
            ctypes.c_int64,   # crop
            ctypes.c_int32,   # crop_mode (0=random, 1=stride)
            ctypes.c_uint64,  # seed
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return _lib
