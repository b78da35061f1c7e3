"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and builds on its own into
``build/kernels/lib<name>-<hash>.so`` at the repository root (a directory
that ``.gitignore`` lists), with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so csrc/<name>.cu

The hash covers the source, every header ``csrc/*.cuh`` (the sources
include them by name) and the flags, so an edited kernel or header
rebuilds every library and an unchanged tree reuses them. `load_many`
starts one nvcc per missing source, all at once. The library is opened
with ``ctypes``; a build that fails raises with nvcc's output. There is
no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(CSRC)), "build", "kernels"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# what the last build of each kernel printed (ptxas register and spill
# report); tests/test_torch_cuda.py reads it
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def load_many(names) -> list[ctypes.CDLL]:
    """The loaded libraries of ``csrc/<name>.cu`` for each name, building
    the missing ones with one nvcc process each, all started together.
    Every process has ended before a failed build raises."""
    with _lock:
        started = {}
        for name in names:
            if name in _libs or name in started:
                continue
            src, out = _target(name)
            if os.path.exists(out):
                _libs[name] = ctypes.CDLL(out)
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            started[name] = (proc, tmp, out)
        for name, (proc, _, _) in started.items():
            build_logs[name] = proc.communicate()[0]
        for name, (proc, tmp, out) in started.items():
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{build_logs[name]}")
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
            _libs[name] = ctypes.CDLL(out)
        return [_libs[name] for name in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return load_many([name])[0]
