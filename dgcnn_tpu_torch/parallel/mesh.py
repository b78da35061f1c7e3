"""Axis names and the rank group (port of `dgcnn_tpu/parallel/mesh.py`).

In the JAX package a ``(data, points)`` device mesh carries the
parallelism and one SPMD program runs over it under ``shard_map``. The
port runs one process per device instead, in a `torch.distributed`
group, laid out as the JAX mesh is: world rank ``d * point_shards + p``
holds data rank ``d`` and point rank ``p``. A `RankGroup` is what each
process knows of it: its rank and size on each axis and one process
group per axis. The backend is chosen once, from the devices, and never
changed after a failure:

- ``nccl`` when every rank of a host has a card of its own
  (``torch.cuda.device_count() >=`` the host's ranks); local rank r runs
  on ``cuda:r``;
- ``gloo`` when ranks share a card (every rank on ``cuda:0``) and on the
  CPU. Gloo moves host memory only, so on a shared card the collectives
  stage CUDA tensors through pinned host buffers
  (`RankGroup.stage_host`; `parallel.collectives`). That is transport
  between processes on one card, not a measurement of inter-card speed.

Both axes larger than 1 at once is the ``data x points`` mesh: each data
replica's point ranks form one points group and each point rank's data
ranks one data group. ``RankGroup.axis(ALL_AXES)`` sees both axes as one
(the JAX ``axes = (data, points)``): the gradient all-reduce, the loss
and metric sums and sync BN run over it. Peers of a collective are named
by their world rank (`RankGroup.global_rank`), as `torch.distributed`'s
point-to-point ops and ``broadcast`` want.
"""

from __future__ import annotations

import dataclasses

import torch

DATA_AXIS = "data"
POINT_AXIS = "points"
# both axes seen as one: world rank data_rank * point_shards + point_rank
ALL_AXES = (DATA_AXIS, POINT_AXIS)


@dataclasses.dataclass
class RankGroup:
    """One rank's view of the rank group.

    ``rank``, ``size`` and ``pg`` are the points axis's (what the context
    parallel code reads); ``data_rank``, ``data_size`` and ``data_pg`` the
    data axis's. A ``pg`` of None is the whole world. ``host`` and
    ``hosts`` are this rank's host (node) and the host count, as a
    launcher names them (one host for ranks spawned by
    `parallel.launch.run_ranks`); data ranks are host-major."""

    rank: int
    size: int
    device: torch.device
    backend: str
    # CUDA tensors cross the group through pinned host buffers (gloo on a
    # shared card)
    stage_host: bool
    pg: object = None  # the points axis's torch.distributed group
    data_rank: int = 0
    data_size: int = 1
    data_pg: object = None
    host: int = 0
    hosts: int = 1
    # world rank of this axis's rank r: base + stride * r
    base: int = 0
    stride: int = 1
    # pinned staging buffers, reused by tag and shape (shared by the axis
    # views of one group)
    _pinned: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def local_size(self) -> int:
        """The data ranks of one host."""
        return self.data_size // self.hosts

    @property
    def local_rank(self) -> int:
        """This rank's data rank among its host's."""
        return self.data_rank % self.local_size

    def axis(self, name) -> "RankGroup":
        """The group seen as the one axis ``name``: that axis's rank, size
        and process group as ``rank``, ``size`` and ``pg``, which the
        collectives read (``self`` is the group as `make_group` builds it,
        the points axis's view). ``ALL_AXES`` is both axes as one: the
        world, in world-rank order."""
        if name == POINT_AXIS:
            return self
        if name == ALL_AXES:
            return dataclasses.replace(
                self, rank=self.data_rank * self.size + self.rank,
                size=self.data_size * self.size, pg=None, data_rank=0, data_size=1,
                data_pg=None, base=0, stride=1)
        if name != DATA_AXIS:
            raise ValueError(f"unknown axis {name!r}")
        return dataclasses.replace(self, rank=self.data_rank, size=self.data_size,
                                   pg=self.data_pg, data_rank=0, data_size=1, data_pg=None,
                                   base=self.rank, stride=self.size)

    def global_rank(self, r: int) -> int:
        """The world rank of this axis's rank ``r``."""
        return self.base + self.stride * r

    def pinned(self, tag: str, shape, dtype) -> torch.Tensor:
        key = (tag, tuple(shape), dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf


# the name the context-parallel code knows the group by
PointGroup = RankGroup


def default_num_devices(point_shards: int, device) -> int:
    """What ``num_devices=0`` means: every visible card on CUDA (at least
    one data rank of ``point_shards`` ranks, which then share cards), one
    data rank on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return point_shards
    return point_shards * max(1, torch.cuda.device_count() // point_shards)


def make_mesh(num_devices: int = 0, num_point_shards: int = 1, device="cuda") -> dict:
    """The ``{data: D, points: P}`` shape of the rank group for
    ``num_devices`` ranks (0: `default_num_devices`), with the JAX
    ``make_mesh``'s divisibility check and message. Ranks may outnumber
    the cards (they share one), so there is no check against the device
    count."""
    n = int(num_devices) or default_num_devices(num_point_shards, device)
    if n % num_point_shards:
        raise ValueError(f"{n} devices not divisible by {num_point_shards=}")
    return {DATA_AXIS: n // num_point_shards, POINT_AXIS: num_point_shards}


def choose_backend(ranks: int, device) -> tuple[str, bool]:
    """``(backend, stage_host)`` for ``ranks`` ranks on one host on
    ``device``'s type: nccl when each rank can have a card, else gloo
    (staging CUDA tensors through the host)."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo", False
    if device.type != "cuda":
        raise ValueError(f"no rank-group backend for device {device}")
    if torch.cuda.device_count() >= ranks:
        return "nccl", False
    return "gloo", True


def rank_device(rank: int, ranks: int, device) -> torch.device:
    """The device of local rank ``rank`` of ``ranks`` on one host:
    ``cuda:rank`` when there are enough cards, else the one card
    ``device`` names (``cuda:0`` by default); the CPU stays the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if choose_backend(ranks, device)[0] == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", device.index or 0)


def make_group(point_shards: int, device, *, local_rank: int | None = None,
               local_size: int | None = None, host: int = 0, hosts: int = 1) -> RankGroup:
    """This process's `RankGroup`, after `torch.distributed` has been
    initialised with the backend `choose_backend` picks
    (`parallel.launch` does both). ``local_rank``/``local_size`` place the
    rank among its host's (default: the world is one host). Every rank
    creates every axis group, in one order, as ``new_group`` requires."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_group needs an initialised torch.distributed group")
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = make_mesh(world, point_shards)
    data = shape[DATA_AXIS]
    local_rank = rank if local_rank is None else local_rank
    local_size = world if local_size is None else local_size
    if hosts < 1 or data % hosts:
        raise ValueError(f"{data} data ranks do not split over {hosts} hosts")
    backend, stage = choose_backend(local_size, device)
    if dist.get_backend() != backend:
        raise RuntimeError(
            f"the group runs {dist.get_backend()}, but {local_size} ranks on "
            f"{torch.device(device)} need {backend}"
        )
    point_pg = data_pg = None  # None: the world
    if data > 1 and point_shards > 1:
        for d in range(data):
            g = dist.new_group([d * point_shards + p for p in range(point_shards)])
            if d == rank // point_shards:
                point_pg = g
        for p in range(point_shards):
            g = dist.new_group([d * point_shards + p for d in range(data)])
            if p == rank % point_shards:
                data_pg = g
    return RankGroup(rank=rank % point_shards, size=point_shards,
                     device=rank_device(local_rank, local_size, device), backend=backend,
                     stage_host=stage, pg=point_pg, data_rank=rank // point_shards,
                     data_size=data, data_pg=data_pg, host=host, hosts=hosts,
                     base=rank - rank % point_shards)

