"""Axis names and the point-shard process group (port of
`dgcnn_tpu/parallel/mesh.py`).

In the JAX package a ``(data, points)`` device mesh carries the
parallelism and every rank runs one SPMD program under ``shard_map``. The
port runs one process per point shard instead, in a `torch.distributed`
group; a `PointGroup` is what each process knows of it. The backend is
chosen once, from the devices, and never changed after a failure:

- ``nccl`` when every rank has a card of its own
  (``torch.cuda.device_count() >= point_shards``); rank r runs on
  ``cuda:r``;
- ``gloo`` when ranks share a card (every rank on ``cuda:0``) and on the
  CPU. Gloo moves host memory only, so on a shared card the collectives
  stage CUDA tensors through pinned host buffers
  (`PointGroup.stage_host`; `parallel.collectives`). That is transport
  between processes on one card, not a measurement of inter-card speed.

Only one data replica is ported: a ``data`` axis larger than 1 waits for
ROADMAP queue 1, item 12.
"""

from __future__ import annotations

import dataclasses

import torch

DATA_AXIS = "data"
POINT_AXIS = "points"


@dataclasses.dataclass
class PointGroup:
    """One rank's view of the point-shard group."""

    rank: int
    size: int
    device: torch.device
    backend: str
    # CUDA tensors cross the group through pinned host buffers (gloo on a
    # shared card)
    stage_host: bool
    pg: object = None  # the torch.distributed process group (None: world)
    # pinned staging buffers, reused by tag and shape
    _pinned: dict = dataclasses.field(default_factory=dict, repr=False)

    def pinned(self, tag: str, shape, dtype) -> torch.Tensor:
        key = (tag, tuple(shape), dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf


def choose_backend(point_shards: int, device) -> tuple[str, bool]:
    """``(backend, stage_host)`` for ``point_shards`` ranks on ``device``'s
    type: nccl when each rank can have a card, else gloo (staging CUDA
    tensors through the host)."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo", False
    if device.type != "cuda":
        raise ValueError(f"no point-shard backend for device {device}")
    if torch.cuda.device_count() >= point_shards:
        return "nccl", False
    return "gloo", True


def rank_device(rank: int, point_shards: int, device) -> torch.device:
    """``cuda:rank`` when there are enough cards, else the one card
    ``device`` names (``cuda:0`` by default); the CPU stays the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if choose_backend(point_shards, device)[0] == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", device.index or 0)


def make_point_group(point_shards: int, device) -> PointGroup:
    """This process's `PointGroup`, after `torch.distributed` has been
    initialised with the backend `choose_backend` picks
    (`parallel.launch.run_point_ranks` does both)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_point_group needs an initialised torch.distributed group")
    size = dist.get_world_size()
    if size != point_shards:
        raise ValueError(f"group of {size} ranks for point_shards={point_shards}")
    backend, stage = choose_backend(point_shards, device)
    if dist.get_backend() != backend:
        raise RuntimeError(
            f"the group runs {dist.get_backend()}, but {point_shards} ranks on "
            f"{torch.device(device)} need {backend}"
        )
    rank = dist.get_rank()
    return PointGroup(rank=rank, size=size, device=rank_device(rank, point_shards, device),
                      backend=backend, stage_host=stage)
