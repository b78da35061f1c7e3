"""Ring kNN and ring gather: context parallelism over the point axis
(port of `dgcnn_tpu/kernels/ring_knn.py`).

Each rank of the point-shard group (`parallel.mesh.PointGroup`) holds a
contiguous shard of every event: global point ``g`` lives on rank
``g // N_local`` at row ``g % N_local``. `ring_knn` passes point blocks
around the ring (`parallel.collectives.ppermute_ring`) while each rank
keeps a running top-k for its resident queries; `ring_gather` is the
companion halo exchange that fetches neighbour rows by global index. The
graph build is stop-gradient and passes its blocks by the plain
`ppermute_ring`; `ring_gather` passes them by
`parallel.collectives.ppermute_ring_autograd`, so its backward sends each
block's cotangent back around the ring to the block's owner (the JAX
package's transposed ``ppermute``).

`ring_knn` is the ``ring_impl="ppermute"`` graph build: on CUDA with
``use_kernel`` it scores each block with the exact kernel's cross form
(`kernels.knn_cuda.knn_cuda_cross`), as the JAX ``use_pallas`` branch
does; otherwise (the CPU, or ``use_kernel`` off) with the plain distance
scores `_block_scores`, as the JAX package does off the TPU.
``ring_impl="rdma"`` is `kernels.ring_knn_cuda.ring_knn_cuda`.
"""

from __future__ import annotations

import torch

from dgcnn_tpu_torch.kernels.knn_cuda import knn_cuda_cross
from dgcnn_tpu_torch.ops.knn import tie_sort, top_k_stable
from dgcnn_tpu_torch.parallel.collectives import ppermute_ring, ppermute_ring_autograd


def _block_scores(q, blk, blk_mask):
    """Masked negative squared distances of local queries vs a block, in
    the oracle's expression order (`ops.knn.pairwise_sq_dists`).

    q: ``(B, Nq, C)``; blk: ``(B, Nb, C)``; blk_mask: ``(B, Nb)`` ->
    ``(B, Nq, Nb)``."""
    q2 = torch.sum(torch.square(q), dim=-1)
    b2 = torch.sum(torch.square(blk), dim=-1)
    inner = torch.matmul(q, blk.transpose(-1, -2))
    d = q2[..., :, None] + b2[..., None, :] - 2.0 * inner
    return torch.where(blk_mask[..., None, :], -d, float("-inf"))


def ring_knn(x_shard, k: int, mask_shard=None, *, group, use_kernel: bool = True,
             precision: str = "highest"):
    """kNN over points sharded across ``group``.

    Args:
      x_shard: ``(B, N_local, C)``, this rank's contiguous point shard.
      k: neighbour count; must be <= N_local.
      mask_shard: optional ``(B, N_local)`` validity.
      precision: the kernel's score precision (``--knn_precision``;
        ``"default"`` its tensor-core form); the plain distance scores
        are f32 whatever it says, as the JAX package's are off the TPU.

    Returns:
      ``idx`` int32 ``(B, N_local, k)`` global neighbour indices, ordered
      as a single-device top-k over all N points would order them, and
      ``valid`` bool ``(B, N_local, k)``, False where fewer than ``k``
      valid points exist globally (those slots hold the global self
      index).
    """
    p, me = group.size, group.rank
    nl = x_shard.shape[-2]
    if k > nl:
        raise ValueError(f"k={k} > local shard size {nl}")
    x_shard = x_shard.float()
    if mask_shard is None:
        mask_shard = torch.ones(x_shard.shape[:-1], dtype=torch.bool, device=x_shard.device)

    if use_kernel and x_shard.is_cuda:
        def block_topk(blk, blk_mask):
            bi, bvalid, bv = knn_cuda_cross(x_shard.contiguous(), blk.contiguous(), k,
                                            blk_mask.contiguous(), precision)
            return torch.where(bvalid, bv, float("-inf")), bi.long()
    else:
        def block_topk(blk, blk_mask):
            return top_k_stable(_block_scores(x_shard, blk, blk_mask), k)

    topv = torch.full(x_shard.shape[:-1] + (k,), float("-inf"), device=x_shard.device)
    topi = torch.zeros(x_shard.shape[:-1] + (k,), dtype=torch.long, device=x_shard.device)
    blk, blk_mask = x_shard, mask_shard
    for s in range(p):
        owner = (me - s) % p  # the ring shifted s times: the owner's block
        bv, bi = block_topk(blk, blk_mask)
        cand_v, cand_i = tie_sort(torch.cat([topv, bv], dim=-1),
                                   torch.cat([topi, bi + owner * nl], dim=-1))
        topv, topi = cand_v[..., :k], cand_i[..., :k]
        if s < p - 1:
            blk = ppermute_ring(blk, group)
            blk_mask = ppermute_ring(blk_mask, group)

    valid = torch.isfinite(topv)
    self_global = torch.arange(nl, device=x_shard.device)[None, :, None] + me * nl
    return torch.where(valid, topi, self_global).to(torch.int32), valid


def ring_gather(values_shard, idx_global, *, group):
    """Rows of a point-sharded array by global index: ``values_shard``
    ``(B, N_local, C)`` (this rank's shard of ``(B, N, C)``) and
    ``idx_global`` ``(B, N_local, k)`` -> ``(B, N_local, k, C)``, the
    EdgeConv halo exchange. Each ring step contributes the rows whose
    global index falls in the block it holds. Differentiable in
    ``values_shard``: the rows' gradients go home to their owners."""
    p, me = group.size, group.rank
    nl = values_shard.shape[-2]
    b, n_loc, k = idx_global.shape
    idx_global = idx_global.long()
    out = torch.zeros(idx_global.shape + values_shard.shape[-1:], dtype=values_shard.dtype,
                      device=values_shard.device)
    blk = values_shard
    for s in range(p):
        owner = (me - s) % p
        mine = (idx_global // nl) == owner
        local = torch.clamp(idx_global - owner * nl, 0, nl - 1).reshape(b, n_loc * k, 1)
        got = torch.gather(blk, -2, local.expand(-1, -1, blk.shape[-1]))
        out = torch.where(mine[..., None], got.reshape(out.shape), out)
        if s < p - 1:
            blk = ppermute_ring_autograd(blk, group)
    return out
