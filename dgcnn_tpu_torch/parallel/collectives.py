"""Collectives over the rank group (port of
`dgcnn_tpu/parallel/collectives.py`).

Each takes the rank's `mesh.RankGroup`. The ``_points`` ones, the ring
and `psum_autograd` run over the group as it is passed, by default its
points axis (``rank``, ``size``, ``pg``; pass ``group.axis(DATA_AXIS)``
for the data axis, ``group.axis(ALL_AXES)`` for both), the ``_data``
ones over its data axis. Under NCCL the tensors cross as they are; under
gloo on a shared card (``group.stage_host``) a CUDA tensor is staged
through a pinned host buffer: copied to the host before it leaves (a
synchronous copy, so the kernels that write it have finished) and back to
the card after it lands. The pinned buffers are kept on the group and
reused; what comes back to the caller is never one of them.

``ppermute_ring_start`` returns a handle, so a caller can launch work
between the start of a ring transfer and its end: the ring kNN merges
the resident key block while the next one travels.

The JAX package's implicit collectives become these calls:
`psum_autograd` is ``psum`` under ``shard_map``'s AD (its backward
all-reduces the cotangent), `all_reduce_grads` sums the gradient of every
parameter over both axes in one flat buffer, and `psum_data`,
`pmean_data` and `all_gather_data` merge metrics, running statistics and
eval outputs. The context-parallel forward's exchanges have the
transposes JAX's AD gives them (`ppermute_ring_autograd`: the cotangent
goes back the other way; `all_gather_autograd`: the cotangent summed
over the group, this rank's slice); their plain forms
(`ppermute_ring`, `all_gather_points`) serve code under ``no_grad``, the
graph build. ``counts`` tallies the collectives that ran, by kind (a
backward's kind ends in ``_backward``), ``nbytes`` the bytes this rank
put into them.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from dgcnn_tpu_torch.bridge import tree_map
from dgcnn_tpu_torch.parallel.mesh import ALL_AXES, DATA_AXIS

# collectives that crossed ranks, by kind (a group of one runs none), and
# the bytes this rank put into them
counts: collections.Counter = collections.Counter()
nbytes: collections.Counter = collections.Counter()


def _tally(kind: str, x: torch.Tensor) -> None:
    counts[kind] += 1
    nbytes[kind] += x.numel() * x.element_size()


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


def ppermute_ring_start(x: torch.Tensor, group, shift: int = 1,
                        kind: str = "ppermute") -> RingHandle:
    """Start sending ``x`` to rank ``rank + shift`` and receiving the
    same-shaped block from rank ``rank - shift`` (mod the group size)."""
    if group.size == 1:
        return RingHandle([], x, x.device)
    _tally(kind, x)
    send = _outgoing(x, group, "ring_send")
    if _staged(x, group):
        recv = group.pinned("ring_recv", x.shape, x.dtype)
    else:
        recv = torch.empty_like(send)
    # point-to-point peers are world ranks
    nxt = group.global_rank((group.rank + shift) % group.size)
    prv = group.global_rank((group.rank - shift) % group.size)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, nxt, group=group.pg),
        dist.P2POp(dist.irecv, recv, prv, group=group.pg),
    ])
    return RingHandle(works, recv, x.device)


def ppermute_ring(x: torch.Tensor, group, shift: int = 1, kind: str = "ppermute") -> torch.Tensor:
    """Rotate shards around the ring: returns rank ``rank - shift``'s
    ``x``. No gradient: for code under ``no_grad`` (the graph build)."""
    return ppermute_ring_start(x, group, shift, kind).wait()


class _PpermuteRing(torch.autograd.Function):
    """`ppermute_ring` with its transpose: the cotangent of the block
    received from rank ``rank - shift`` goes back to it (``-shift``)."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return ppermute_ring(x, group, shift)

    @staticmethod
    def backward(ctx, dy):
        return ppermute_ring(dy.contiguous(), ctx.group, -ctx.shift, "ppermute_backward"), None, None


def ppermute_ring_autograd(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """`ppermute_ring`, differentiable: one transfer forward and one of the
    cotangent backward, in the other direction."""
    if group.size == 1:
        return x
    return _PpermuteRing.apply(x, group, shift)


def all_gather_points(x: torch.Tensor, group, axis: int = 1, tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` in rank order, concatenated along ``axis``
    (``tiled``) or stacked on a new ``axis``. No gradient: see
    `all_gather_autograd`."""
    if group.size == 1:
        return x if tiled else x.unsqueeze(axis)
    send = _outgoing(x, group, "gather_send")
    parts = [torch.empty_like(send) for _ in range(group.size)]
    _tally("all_gather", x)
    dist.all_gather(parts, send, group=group.pg)
    out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)
    return out.to(x.device)


def _reduce_scatter(dy: torch.Tensor, group, axis: int, tiled: bool) -> torch.Tensor:
    """This rank's part of ``dy`` summed over the group: rows ``[rank * n,
    (rank + 1) * n)`` along ``axis`` (``tiled``) or index ``rank`` of the
    stacked ``axis``. NCCL reduce-scatters; gloo has no reduce-scatter, so
    there the whole ``dy`` is all-reduced and this rank's part sliced."""
    p, me = group.size, group.rank
    axis = axis % dy.dim()
    if group.backend == "nccl":
        front = dy.movedim(axis, 0).contiguous()  # the parts along dim 0, in rank order
        out = torch.empty((front.shape[0] // p,) + front.shape[1:], dtype=dy.dtype,
                          device=dy.device)
        _tally("all_gather_backward", front)
        dist.reduce_scatter_tensor(out, front, group=group.pg)
        return out.movedim(0, axis) if tiled else out.squeeze(0)
    summed = _summed(dy, group, "gather_backward", "all_gather_backward")
    if not tiled:
        return summed.select(axis, me)
    n = dy.shape[axis] // p
    return summed.narrow(axis, me * n, n)


class _AllGather(torch.autograd.Function):
    """`all_gather_points` with its transpose, `_reduce_scatter`."""

    @staticmethod
    def forward(ctx, x, group, axis, tiled):
        ctx.group, ctx.axis, ctx.tiled = group, axis, tiled
        return all_gather_points(x, group, axis, tiled)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter(dy, ctx.group, ctx.axis, ctx.tiled), None, None, None


def all_gather_autograd(x: torch.Tensor, group, axis: int = 1, tiled: bool = True) -> torch.Tensor:
    """`all_gather_points`, differentiable: every rank's result depends on
    every rank's ``x``, so the backward sums the cotangents of all ranks
    and each keeps its own part (a reduce-scatter, the JAX transpose of
    ``all_gather``)."""
    if group.size == 1:
        return x if tiled else x.unsqueeze(axis)
    return _AllGather.apply(x, group, axis, tiled)


def _summed(x: torch.Tensor, group, tag: str, kind: str) -> torch.Tensor:
    """A new tensor: ``x`` summed over the group, on ``x``'s device."""
    _tally(kind, x)
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


def psum_all(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over both axes of the group, on every rank."""
    return psum_points(x, group.axis(ALL_AXES))


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
    """The gradients summed over both axes of the group (each rank's are
    its partial sums of the global gradient): one all-reduce of one flat
    buffer, not one a leaf. Returns views of the summed buffer in the
    leaves' shapes."""
    grads = list(grads)
    whole = group.axis(ALL_AXES)
    if whole.size == 1:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    summed = _summed(flat, whole, "grads", "grads")
    return [s.view(g.shape) for s, g in zip(torch.split(summed, [g.numel() for g in grads]),
                                             grads)]


def broadcast_tree(tree, group, src: int = 0):
    """Rank ``src``'s (of the group as passed) tensors of ``tree`` (dicts
    and lists of tensors) on every rank, in place of each rank's own;
    other leaves stay as they are."""
    if group.size == 1:
        return tree

    def leaf(t):
        if not torch.is_tensor(t):
            return t
        buf = t.detach().to("cpu" if _staged(t, group) else t.device, copy=True).contiguous()
        _tally("broadcast", buf)
        # broadcast names its source by world rank
        dist.broadcast(buf, src=group.global_rank(src), group=group.pg)
        return buf.to(t.device)

    return tree_map(leaf, tree)
