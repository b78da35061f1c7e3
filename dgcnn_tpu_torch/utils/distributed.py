"""Joining a launched rank group from the environment (port of
`dgcnn_tpu/utils/distributed.py`).

A launcher (``torchrun``, a cluster's job runner, or one process per
host by hand) names the group in the environment; every process of it
calls `maybe_initialize_distributed` and joins. Two vocabularies are
read:

- torch's: ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` (the ranks of one host; 1 when
  unset), the host index from ``GROUP_RANK`` (else ``RANK //
  LOCAL_WORLD_SIZE``);
- the JAX package's: ``JAX_COORDINATOR_ADDRESS`` or
  ``COORDINATOR_ADDRESS`` (``host:port``), ``NUM_PROCESSES`` and
  ``PROCESS_ID``. The JAX package runs one process per host; here each
  such process is one rank and its own host.

`host_event_range` is the event slice of this rank's host (node), not of
the rank: the ranks of one host read the same slice and each takes its
rows of the host's share of a batch.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import NamedTuple


class Launch(NamedTuple):
    """The rank group a launcher names: rendezvous address ``host:port``,
    the world size and this process's rank, its rank among its host's
    and their count, and its host among ``hosts``."""

    address: str
    world: int
    rank: int
    local_rank: int
    local_size: int
    host: int
    hosts: int


def _int(name: str, default: int | None = None) -> int | None:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def launcher_env() -> Launch | None:
    """The launcher's group from the environment, or None when no
    launcher names one of more than one process. Raises when the names
    are incomplete or disagree."""
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get("COORDINATOR_ADDRESS")
    if addr:
        world, rank = _int("NUM_PROCESSES", 1), _int("PROCESS_ID", 0)
        if world <= 1:
            return None
        return _checked(Launch(addr, world, rank, 0, 1, rank, world))
    world = _int("WORLD_SIZE", 1)
    nproc = _int("NUM_PROCESSES", 1)
    if max(world, nproc) <= 1:
        return None
    if nproc > 1 and world == 1:
        raise RuntimeError(
            f"NUM_PROCESSES={nproc} names a launched group but no "
            f"JAX_COORDINATOR_ADDRESS/COORDINATOR_ADDRESS to meet at")
    if not (os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT")):
        raise RuntimeError(
            f"WORLD_SIZE={world} names a launched group but MASTER_ADDR/MASTER_PORT "
            f"are not set: launch with torchrun, or set them to the rendezvous address")
    if os.environ.get("RANK") in (None, ""):
        raise RuntimeError(f"WORLD_SIZE={world} names a launched group but RANK is not set")
    rank = _int("RANK")
    local_size = _int("LOCAL_WORLD_SIZE", 1)
    local_rank = _int("LOCAL_RANK", rank % local_size)
    if world % local_size:
        raise RuntimeError(f"WORLD_SIZE={world} not divisible by LOCAL_WORLD_SIZE={local_size}")
    host = _int("GROUP_RANK", rank // local_size)
    addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return _checked(Launch(addr, world, rank, local_rank, local_size, host, world // local_size))


def _checked(launch: Launch) -> Launch:
    if not 0 <= launch.rank < launch.world:
        raise RuntimeError(f"rank {launch.rank} outside a world of {launch.world}")
    if launch.rank != launch.host * launch.local_size + launch.local_rank:
        raise RuntimeError(
            f"rank {launch.rank} is not host {launch.host}'s local rank {launch.local_rank} "
            f"of {launch.local_size}: data ranks must be host-major")
    return launch


def maybe_initialize_distributed(device="cuda", timeout: float = 1800.0) -> Launch | None:
    """Join the launcher's group (`launcher_env`) with the backend
    `parallel.mesh.choose_backend` picks for the host's ranks on
    ``device``, this rank on `parallel.mesh.rank_device`; returns the
    `Launch`, or None when there is no launched group. A group that is
    already initialised is kept."""
    import torch
    import torch.distributed as dist

    from dgcnn_tpu_torch.parallel.mesh import choose_backend, rank_device

    launch = launcher_env()
    if launch is None or dist.is_initialized():
        return launch
    backend, _ = choose_backend(launch.local_size, device)
    dev = rank_device(launch.local_rank, launch.local_size, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{launch.address}", rank=launch.rank,
                            world_size=launch.world, timeout=timedelta(seconds=timeout))
    return launch


def host_event_range(num_events: int, host: int | None = None,
                     hosts: int | None = None) -> tuple[int, int]:
    """This host's contiguous slice ``[lo, hi)`` of the event file:
    ``ceil(num_events / hosts)`` events a host, the last one short. The
    host and the count default to the launcher's (the whole range
    without one)."""
    if host is None or hosts is None:
        launch = launcher_env()
        host, hosts = (0, 1) if launch is None else (launch.host, launch.hosts)
    per = (num_events + hosts - 1) // hosts
    lo = min(host * per, num_events)
    return lo, min(lo + per, num_events)
