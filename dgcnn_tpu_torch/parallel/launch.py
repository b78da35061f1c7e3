"""Launch one process per device (the port's counterpart of
``shard_map``'s launch in `dgcnn_tpu/train/trainval.py`).

    results = run_ranks(fn, 4, device="cuda", args=(...))          # 4 data ranks
    results = run_point_ranks(fn, 4, device="cuda", args=(...))    # 4 point shards

`run_ranks` spawns ``num_devices`` processes (start method ``spawn``),
``num_devices / point_shards`` data ranks of ``point_shards`` point
ranks each, joins them in a `torch.distributed` group through a
rendezvous file (``file://``, so runs in parallel never contend for a
port), builds each rank's `mesh.RankGroup` and calls ``fn(group,
*args)`` there. ``fn`` must be a module-level function and its result
picklable; tensors in it come back as numpy arrays. The call returns the
results in rank order. Each rank runs in a process group of its own;
while the call waits, SIGTERM and SIGINT sent to the caller (a
scheduler's stop, a terminal's Ctrl-C) are passed on to every rank once,
and a training loop checkpoints and stops on them.

A process that a launcher started (``torchrun``, one per host) joins the
launcher's group with `join_from_env` instead.

A rank that raises makes the whole call raise with that rank's
traceback; the other ranks are terminated, so nothing hangs on a
collective whose peer is gone. A rank that dies without a word, or a run
past ``timeout`` seconds, raises too.

On CUDA the kernels the ranks launch are built here, in the parent,
before any rank starts (`kernels._build.load_many`), so the ranks load
the libraries and never race one nvcc each.
"""

from __future__ import annotations

import contextlib
import os
import queue as queue_mod
import shutil
import signal
import tempfile
import threading
import time
import traceback
from datetime import timedelta

import torch

from dgcnn_tpu_torch.parallel.mesh import choose_backend, make_group, make_mesh, rank_device

# the kernels a rank launches: the exact kNN (data parallel), and the ring
# kNN too with point shards
RANK_KERNELS = ("knn", "ring_knn")
# a collective's timeout when the caller sets no deadline
DEFAULT_COLLECTIVE_TIMEOUT_S = 1800.0


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


def _rank_main(rank, world, point_shards, backend, init_method, device, fn, args, results,
               timeout_s):
    import torch.distributed as dist

    # a process group of its own: a signal reaches the rank once, passed
    # on by the caller (`_forward_signals`), not also from the terminal
    os.setpgrp()
    try:
        dev = rank_device(rank, world, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            # ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * world)))
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world, timeout=timedelta(seconds=timeout_s))
        group = make_group(point_shards, device)
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


@contextlib.contextmanager
def _forward_signals(procs):
    """Pass SIGTERM and SIGINT on to the ranks while the caller waits (in
    the main thread only; elsewhere signals stay as they are)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def handler(signum, frame):
        for p in procs:
            if p.is_alive() and p.pid is not None:
                with contextlib.suppress(ProcessLookupError):
                    os.kill(p.pid, signum)

    old = {sig: signal.signal(sig, handler) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        yield
    finally:
        for sig, h in old.items():
            signal.signal(sig, h)


def run_ranks(fn, num_devices: int, point_shards: int = 1, *, device="cuda",
              init_file: str | None = None, args=(), timeout: float | None = 900.0):
    """Run ``fn(group, *args)`` on ``num_devices`` ranks, ``point_shards``
    of them to a data replica; returns their results in rank order (see
    the module docstring). ``device`` is ``"cuda"`` (one card for all
    ranks or one card each, as `mesh.choose_backend` decides) or
    ``"cpu"``; ``init_file`` is the rendezvous file, a fresh temporary one
    by default; ``timeout`` bounds the whole call in seconds (None: no
    bound, each collective then times out after
    ``DEFAULT_COLLECTIVE_TIMEOUT_S``)."""
    if num_devices < 1 or point_shards < 1:
        raise ValueError(f"need >= 1 ranks and point shards, got {num_devices} and {point_shards}")
    make_mesh(num_devices, point_shards)  # the divisibility check
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
        from dgcnn_tpu_torch.kernels import _build

        _build.load_many(RANK_KERNELS if point_shards > 1 else RANK_KERNELS[:1])
    backend, _ = choose_backend(num_devices, device)
    tmpdir = None
    if init_file is None:
        tmpdir = tempfile.mkdtemp(prefix="dgcnn_ranks_")
        init_file = os.path.join(tmpdir, "rendezvous")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    collective_s = DEFAULT_COLLECTIVE_TIMEOUT_S if timeout is None else timeout
    procs = [
        ctx.Process(target=_rank_main, daemon=True,
                    args=(r, num_devices, point_shards, backend,
                          "file://" + os.path.abspath(init_file), str(device), fn, tuple(args),
                          results, collective_s))
        for r in range(num_devices)
    ]
    try:
        for p in procs:
            p.start()
        got = {}
        deadline = None if timeout is None else time.monotonic() + timeout
        with _forward_signals(procs):
            while len(got) < num_devices:
                left = 1.0 if deadline is None else deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{num_devices - len(got)} of {num_devices} ranks did "
                                       f"not finish within {timeout} s")
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
                                f"rank {dead[0]} of {num_devices} died with exit code "
                                f"{procs[dead[0]].exitcode} and no traceback") from None
                    else:
                        continue
                if kind == "err":
                    raise RuntimeError(f"rank {rank} of {num_devices} raised:\n{payload}")
                got[rank] = payload
        for p in procs:
            p.join(60)
        return [got[r] for r in range(num_devices)]
    finally:
        _stop(procs)
        results.close()
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)


def run_point_ranks(fn, point_shards: int, *, device="cuda", init_file: str | None = None,
                    args=(), timeout: float | None = 900.0):
    """`run_ranks` with one data replica of ``point_shards`` ranks."""
    return run_ranks(fn, point_shards, point_shards, device=device, init_file=init_file,
                     args=args, timeout=timeout)


def join_from_env(point_shards: int = 1, device="cuda"):
    """This process's `mesh.RankGroup` in the group a launcher names in the
    environment (`utils.distributed.maybe_initialize_distributed`), or
    None when there is none. Leave it with `leave`."""
    from dgcnn_tpu_torch.utils.distributed import maybe_initialize_distributed

    launch = maybe_initialize_distributed(device)
    if launch is None:
        return None
    if launch.local_size % point_shards and point_shards > 1:
        raise ValueError(f"{launch.local_size} ranks a host do not hold whole replicas of "
                         f"point_shards={point_shards}")
    return make_group(point_shards, device, local_rank=launch.local_rank,
                      local_size=launch.local_size, host=launch.host, hosts=launch.hosts)


def leave() -> None:
    """Leave the rank group this process joined."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
