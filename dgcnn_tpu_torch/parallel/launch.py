"""Launch one process per point shard (the port's counterpart of
``shard_map``'s launch in `dgcnn_tpu/train/trainval.py`).

    results = run_point_ranks(fn, 4, device="cuda", args=(...))

spawns ``point_shards`` processes (start method ``spawn``), joins them in
a `torch.distributed` group through a rendezvous file (``file://``, so
runs in parallel never contend for a port), builds each rank's
`mesh.PointGroup` and calls ``fn(group, *args)`` there. ``fn`` must be a
module-level function and its result picklable; tensors in it come back
as numpy arrays. The call returns the results in rank order.

A rank that raises makes the whole call raise with that rank's
traceback; the other ranks are terminated, so nothing hangs on a
collective whose peer is gone. A rank that dies without a word, or a run
past ``timeout`` seconds, raises too.

On CUDA the kernels the ranks launch are built here, in the parent,
before any rank starts (`kernels._build.load_many`), so the ranks load
the libraries and never race one nvcc each.
"""

from __future__ import annotations

import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch

from dgcnn_tpu_torch.parallel.mesh import choose_backend, make_point_group, rank_device

# the kernels a point-sharded forward launches
RANK_KERNELS = ("knn", "ring_knn")


def _to_host(obj):
    """Tensors -> numpy arrays, through dicts, lists and plain tuples."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_host(v) for v in obj]
    if type(obj) is tuple:
        return tuple(_to_host(v) for v in obj)
    return obj


def _rank_main(rank, point_shards, backend, init_method, device, fn, args, results, timeout_s):
    import torch.distributed as dist

    try:
        dev = rank_device(rank, point_shards, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            # ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * point_shards)))
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=point_shards, timeout=timedelta(seconds=timeout_s))
        group = make_point_group(point_shards, device)
        out = fn(group, *args)
        results.put(("ok", rank, _to_host(out)))
    except BaseException:
        results.put(("err", rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def run_point_ranks(fn, point_shards: int, *, device="cuda", init_file: str | None = None,
                    args=(), timeout: float = 900.0):
    """Run ``fn(group, *args)`` on ``point_shards`` ranks; returns their
    results in rank order (see the module docstring). ``device`` is
    ``"cuda"`` (one card for all ranks or one card each, as
    `mesh.choose_backend` decides) or ``"cpu"``; ``init_file`` is the
    rendezvous file, a fresh temporary one by default."""
    if point_shards < 1:
        raise ValueError(f"point_shards must be >= 1, got {point_shards}")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
        from dgcnn_tpu_torch.kernels import _build

        _build.load_many(RANK_KERNELS)
    backend, _ = choose_backend(point_shards, device)
    tmpdir = None
    if init_file is None:
        tmpdir = tempfile.mkdtemp(prefix="dgcnn_ranks_")
        init_file = os.path.join(tmpdir, "rendezvous")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, daemon=True,
                    args=(r, point_shards, backend, "file://" + os.path.abspath(init_file),
                          str(device), fn, tuple(args), results, timeout))
        for r in range(point_shards)
    ]
    try:
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout
        while len(got) < point_shards:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{point_shards - len(got)} of {point_shards} ranks did not "
                                   f"finish within {timeout} s")
            try:
                kind, rank, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    try:  # a last word may still be in the pipe
                        kind, rank, payload = results.get(timeout=2.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} of {point_shards} died with exit code "
                            f"{procs[dead[0]].exitcode} and no traceback") from None
                else:
                    continue
            if kind == "err":
                raise RuntimeError(f"rank {rank} of {point_shards} raised:\n{payload}")
            got[rank] = payload
        for p in procs:
            p.join(60)
        return [got[r] for r in range(point_shards)]
    finally:
        _stop(procs)
        results.close()
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)
