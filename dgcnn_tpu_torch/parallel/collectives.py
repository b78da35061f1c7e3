"""Collectives over the point-shard group (port of
`dgcnn_tpu/parallel/collectives.py`).

Each takes the rank's `mesh.PointGroup`. Under NCCL the tensors cross as
they are; under gloo on a shared card (``group.stage_host``) a CUDA
tensor is staged through a pinned host buffer: copied to the host before
it leaves (a synchronous copy, so the kernels that write it have
finished) and back to the card after it lands. The pinned buffers are
kept on the group and reused.

``ppermute_ring_start`` returns a handle, so a caller can launch work
between the start of a ring transfer and its end: the ring kNN merges
the resident key block while the next one travels.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dgcnn_tpu_torch.bridge import tree_map


def _staged(x: torch.Tensor, group) -> bool:
    return group.stage_host and x.is_cuda


def _outgoing(x: torch.Tensor, group, tag: str) -> torch.Tensor:
    """The tensor that leaves for ``x``: itself, or its pinned host copy."""
    if _staged(x, group):
        buf = group.pinned(tag, x.shape, x.dtype)
        buf.copy_(x)  # synchronous: waits for the kernels that write x
        return buf
    return x.contiguous()


class RingHandle:
    """An unfinished `ppermute_ring_start`; ``wait()`` returns the block
    received from the previous rank, on the sender's device."""

    def __init__(self, works, received, device):
        self._works = works
        self._received = received
        self._device = device

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        # a staged block comes back to the card by a synchronous copy, so
        # its pinned buffer is free for the next transfer
        return self._received.to(self._device)


def ppermute_ring_start(x: torch.Tensor, group, shift: int = 1) -> RingHandle:
    """Start sending ``x`` to rank ``rank + shift`` and receiving the
    same-shaped block from rank ``rank - shift`` (mod the group size)."""
    if group.size == 1:
        return RingHandle([], x, x.device)
    send = _outgoing(x, group, "ring_send")
    if _staged(x, group):
        recv = group.pinned("ring_recv", x.shape, x.dtype)
    else:
        recv = torch.empty_like(send)
    nxt = (group.rank + shift) % group.size
    prv = (group.rank - shift) % group.size
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, nxt, group=group.pg),
        dist.P2POp(dist.irecv, recv, prv, group=group.pg),
    ])
    return RingHandle(works, recv, x.device)


def ppermute_ring(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Rotate shards around the ring: returns rank ``rank - shift``'s
    ``x``."""
    return ppermute_ring_start(x, group, shift).wait()


def all_gather_points(x: torch.Tensor, group, axis: int = 1, tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` in rank order, concatenated along ``axis``
    (``tiled``) or stacked on a new ``axis``."""
    if group.size == 1:
        return x if tiled else x.unsqueeze(axis)
    send = _outgoing(x, group, "gather_send")
    parts = [torch.empty_like(send) for _ in range(group.size)]
    dist.all_gather(parts, send, group=group.pg)
    out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)
    return out.to(x.device)


def psum_points(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group, on every rank."""
    if group.size == 1:
        return x
    buf = x.detach().to("cpu" if _staged(x, group) else x.device, copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group.pg)
    return buf.to(x.device)


def broadcast_tree(tree, group, src: int = 0):
    """Rank ``src``'s tensors of ``tree`` (dicts and lists of tensors) on
    every rank, in place of each rank's own."""
    if group.size == 1:
        return tree

    def leaf(t):
        buf = t.detach().to("cpu" if _staged(t, group) else t.device, copy=True).contiguous()
        dist.broadcast(buf, src=src, group=group.pg)
        return buf.to(t.device)

    return tree_map(leaf, tree)
