"""Context parallelism: DGCNN over events whose points are sharded (port
of `dgcnn_tpu/parallel/context_parallel.py`: the exact ring and banded
context parallelism).

The graph ops a point-sharded `models.dgcnn.Model` needs: every EdgeConv's
graph build passes point blocks around the ring of ranks, the neighbour
gather fetches rows by global index, and the global max pool finishes
across the ranks. Each rank runs the unchanged model on its
``(B, N/P, F)`` shard with these ops injected:

    ops = cp_graph_ops(group, impl="rdma")
    model = make_model(spec, knn_fn=ops.knn, gather_fn=ops.gather,
                       pool_fn=ops.pool, gather_extend_fn=ops.extend,
                       gather_localize_fn=ops.localize)

(`train.trainval.Trainval` wires this when ``point_shards > 1``.) With
``knn_window > 0`` the ops are `banded_cp_graph_ops`' halo exchange
instead, on an event sorted as a whole, and the model is built
``pre_sorted``.

The ops train: the gather, its ``extend`` and the pool move values by the
differentiable collectives (`parallel.collectives.ppermute_ring_autograd`,
`all_gather_autograd`), so gradients flow back to the rank that owns
each row, as JAX's AD transposes the same collectives under
``shard_map``. The graph build is stop-gradient and moves its blocks by
the plain ones.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from dgcnn_tpu_torch.kernels.knn_cuda import check_precision
from dgcnn_tpu_torch.kernels.ring_knn import ring_gather, ring_knn
from dgcnn_tpu_torch.kernels.ring_knn_cuda import ring_knn_cuda
from dgcnn_tpu_torch.parallel.collectives import all_gather_autograd, psum_points

RING_IMPLS = ("ppermute", "rdma")


class GraphOps(NamedTuple):
    knn: Callable
    gather: Callable
    pool: Callable
    # the gather decomposed into "exchange once, gather locally":
    # ``extend(values) -> values_ext`` and ``localize(idx) -> rows into
    # values_ext``; the eval block then runs its reduced form on the
    # extended operand
    extend: Callable | None = None
    localize: Callable | None = None


def cp_masked_max_pool(x, mask, group):
    """Masked max over the (sharded) point axis -> ``(B, C)`` on every
    rank; zeros for an event with no valid point on any rank. The ranks'
    partial maxima meet by a differentiable stacked all-gather (as in the
    JAX package, where ``pmax`` has no VJP): the winner's cotangent goes
    back to the rank that holds it."""
    neg = torch.finfo(x.dtype).min
    if mask is None:
        local = x.amax(dim=-2)
        return all_gather_autograd(local, group, axis=0, tiled=False).amax(dim=0)
    local = torch.where(mask[..., None], x, neg).amax(dim=-2)
    g = all_gather_autograd(local, group, axis=0, tiled=False).amax(dim=0)
    any_valid = psum_points(mask.to(x.dtype).sum(dim=-1), group) > 0
    return torch.where(any_valid[..., None], g, 0.0)


def _masked_max_pool_for(group):
    """`cp_masked_max_pool` bound to a group and TAGGED as a masked-max
    pool: the streamed head may then chunk-decompose the pool into a local
    running max and this function on the ``(B, 1, C)`` partial."""
    f = lambda x, mask: cp_masked_max_pool(x, mask, group)  # noqa: E731
    f.is_masked_max = True
    return f


def cp_graph_ops(group, impl: str = "ppermute", knn_precision: str = "highest",
                 use_kernel: bool = True) -> GraphOps:
    """Ring kNN / gather / pool bound to a point-shard group.

    ``impl`` is the graph build's ring:
      * ``"ppermute"``: `kernels.ring_knn.ring_knn`, block by block with
        the exact kernel's cross form (on CUDA with ``use_kernel``) or the
        plain distance scores;
      * ``"rdma"``: `kernels.ring_knn_cuda.ring_knn_cuda`, one
        hand-written merge launch a ring step on CUDA (its plain version on
        the CPU, where the JAX package refuses ``rdma`` only because its
        interpreter cannot emulate remote DMA).
    Both merge lexicographically into one global order; on CUDA both
    score with the exact kernel's expression, so switching ``impl`` does
    not change the graph (on the CPU the ``ppermute`` distance scores may
    order a 1-ulp near tie the other way).
    ``knn_precision`` is the graph build's score precision (the CP form of
    ``--knn_precision``), applied alike to both rings, as the JAX package
    does: ``"default"`` scores with the kernels' bf16 tensor-core
    instantiations on CUDA, whose bits agree between the exact and ring
    kernels, so switching ``impl`` still does not change the graph. Off
    CUDA the ``ppermute`` ring's plain distance scores are f32 whatever it
    says; the ``rdma`` ring's plain version takes the bf16-rounded operands.
    """
    check_precision(knn_precision)
    if impl == "rdma":
        knn = lambda x, k, mask: ring_knn_cuda(  # noqa: E731
            x, k, mask, group=group, precision=knn_precision)
    elif impl == "ppermute":
        knn = lambda x, k, mask: ring_knn(  # noqa: E731
            x, k, mask, group=group, use_kernel=use_kernel, precision=knn_precision)
    else:
        raise ValueError(f"unknown ring impl {impl!r} (ppermute|rdma)")
    return GraphOps(
        knn=knn,
        gather=lambda values, idx: ring_gather(values, idx, group=group),
        pool=_masked_max_pool_for(group),
        # one tiled all-gather of the neighbour operand (its backward a
        # reduce-scatter); the indices are already global rows of it
        extend=lambda values: all_gather_autograd(values, group, axis=-2, tiled=True),
        localize=lambda idx: idx,
    )


def banded_cp_graph_ops(group, *, window: int, knn_precision: str = "highest",
                        use_kernel: bool = True) -> GraphOps:
    """Halo-exchange banded kNN / gather / pool bound to a point-shard
    group (`kernels.halo_knn`): the event arrives Morton-sorted as a whole,
    each rank holds a contiguous band, and the graph build and the gathers
    exchange ``window``-row halos with the two ring neighbours only.
    ``knn_precision`` is the graph build's score precision and
    ``use_kernel`` routes it through the banded kernel's cross form on
    CUDA (the ``--no_pallas`` knob turns it off), as in `cp_graph_ops`."""
    from dgcnn_tpu_torch.kernels.halo_knn import (
        halo_extend_values,
        halo_gather,
        halo_knn,
        halo_localize_idx,
    )

    check_precision(knn_precision)
    return GraphOps(
        knn=lambda x, k, mask: halo_knn(  # noqa: E731
            x, k, mask, window=window, group=group, precision=knn_precision,
            use_kernel=use_kernel),
        gather=lambda values, idx: halo_gather(values, idx, window=window, group=group),
        pool=_masked_max_pool_for(group),
        # exchange once, gather locally: the fused block's form
        extend=lambda values: halo_extend_values(values, window=window, group=group),
        localize=lambda idx: halo_localize_idx(idx, window=window, group=group),
    )
