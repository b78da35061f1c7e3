"""Collectives over the rank group (port of
`dgcnn_tpu/parallel/collectives.py`).

Each takes the rank's `mesh.RankGroup`. The ``_points`` ones and
`psum_autograd` run over the group's points axis (``rank``, ``size``,
``pg``; pass ``group.axis(DATA_AXIS)`` for the data axis), the ``_data``
ones over its data axis. Under NCCL the tensors cross as they are; under
gloo on a shared card (``group.stage_host``) a CUDA tensor is staged
through a pinned host buffer: copied to the host before it leaves (a
synchronous copy, so the kernels that write it have finished) and back to
the card after it lands. The pinned buffers are kept on the group and
reused.

``ppermute_ring_start`` returns a handle, so a caller can launch work
between the start of a ring transfer and its end: the ring kNN merges
the resident key block while the next one travels.

Under data parallelism the JAX package's implicit collectives become
these calls: `psum_autograd` is ``psum`` under ``shard_map``'s AD (its
backward all-reduces the cotangent), `all_reduce_grads` sums the
gradient of every parameter in one flat buffer, and `psum_data`,
`pmean_data` and `all_gather_data` merge metrics, running statistics and
eval outputs. ``counts`` tallies the collectives that ran, by kind.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from dgcnn_tpu_torch.bridge import tree_map
from dgcnn_tpu_torch.parallel.mesh import DATA_AXIS

# collectives that crossed ranks, by kind (a group of one runs none)
counts: collections.Counter = collections.Counter()


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
    counts["all_gather"] += 1
    dist.all_gather(parts, send, group=group.pg)
    out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)
    return out.to(x.device)


def _summed(x: torch.Tensor, group, tag: str, kind: str) -> torch.Tensor:
    """A new tensor: ``x`` summed over the group, on ``x``'s device."""
    counts[kind] += 1
    if _staged(x, group):
        buf = group.pinned(tag, x.shape, x.dtype)
        buf.copy_(x)
    else:
        buf = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group.pg)
    # a staged sum comes back by a synchronous copy, so its buffer is free
    return buf.to(x.device)


def psum_points(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group, on every rank."""
    if group.size == 1:
        return x
    return _summed(x, group, "psum", "psum")


class _PsumAutograd(torch.autograd.Function):
    """``psum`` with the transpose ``shard_map``'s AD gives it: the
    forward sums ``x`` over the group, the backward sums the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group, "psum_autograd", "psum_autograd")

    @staticmethod
    def backward(ctx, dy):
        return _summed(dy, ctx.group, "psum_autograd", "psum_autograd_backward"), None


def psum_autograd(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's points axis, differentiable: one
    all-reduce forward and one of the cotangent backward (every rank's
    objective depends on every rank's ``x``). Pass ``group.axis(DATA_AXIS)``
    for the data axis."""
    if group.size == 1:
        return x
    return _PsumAutograd.apply(x, group)


def psum_data(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the data axis, on every rank."""
    if group.data_size == 1:
        return x
    return _summed(x, group.axis(DATA_AXIS), "psum", "psum")


def pmean_data(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the data axis, on every rank."""
    if group.data_size == 1:
        return x
    return psum_data(x, group) / group.data_size


def all_gather_data(x: torch.Tensor, group) -> torch.Tensor:
    """Every data rank's ``x`` in rank order, concatenated along axis 0."""
    return all_gather_points(x, group.axis(DATA_AXIS), axis=0, tiled=True)


def all_reduce_grads(grads, group) -> list:
    """The gradients summed over the data axis: one all-reduce of one flat
    buffer, not one a leaf. Returns views of the summed buffer in the
    leaves' shapes."""
    grads = list(grads)
    if group.data_size == 1:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    summed = _summed(flat, group.axis(DATA_AXIS), "grads", "grads")
    return [s.view(g.shape) for s, g in zip(torch.split(summed, [g.numel() for g in grads]),
                                             grads)]


def broadcast_tree(tree, group, src: int = 0):
    """Rank ``src``'s tensors of ``tree`` (dicts and lists of tensors) on
    every rank, in place of each rank's own; other leaves stay as they
    are."""
    if group.size == 1:
        return tree

    def leaf(t):
        if not torch.is_tensor(t):
            return t
        buf = t.detach().to("cpu" if _staged(t, group) else t.device, copy=True).contiguous()
        counts["broadcast"] += 1
        dist.broadcast(buf, src=src, group=group.pg)
        return buf.to(t.device)

    return tree_map(leaf, tree)
