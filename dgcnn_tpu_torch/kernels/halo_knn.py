"""Halo-exchange banded kNN and gather: banded graphs over sharded points
(port of `dgcnn_tpu/kernels/halo_knn.py`).

Once an event is Morton-sorted as a whole (padded points last) and cut into
contiguous bands, one a rank, a query at sorted position ``p`` scores only
the window ``[band_lo(p), band_lo(p) + W)``, which lies inside its own band
and at most ``W`` rows of each ring neighbour's. So the graph build and the
neighbour gather need only a halo exchange, the ``W`` rows at each end of a
band sent to the neighbour on that side, where the exact ring passes every
band around.

Contract against the single-device banded graph
(`ops.knn.banded_knn_indices`):

- valid query rows get its selections bit for bit (the plain path scores
  with the same `ops.knn._banded_select_core`; the kernel path with the
  banded kernel's cross form, whose selections are the kernel's own);
- padded query rows are self-edges with ``valid`` False: a padded query's
  clipped window may lie on a distant rank, which no bounded halo covers,
  and every consumer masks padded rows.

Needs ``W <= N_local`` (halos from the next rank only). The outer halos of
the first and last ranks wrap around the ring and claim positions outside
``[0, N)``; the band never selects them, since it is defined by position.
"""

from __future__ import annotations

import torch

from dgcnn_tpu_torch.kernels.knn_banded_cuda import knn_banded_cuda_cross
from dgcnn_tpu_torch.ops.edge import gather_neighbors
from dgcnn_tpu_torch.ops.knn import BAND_BLOCK_Q, _banded_select_core
from dgcnn_tpu_torch.parallel.collectives import ppermute_ring, ppermute_ring_autograd, psum_points


def _halo_extend(x, w: int, group, permute=ppermute_ring):
    """``(B, NL, ...)`` -> ``(B, NL + 2w, ...)``: the left neighbour's last
    ``w`` rows, the band, the right neighbour's first ``w`` rows. Row ``j``
    claims global sorted position ``rank * NL - w + j``. ``permute`` moves
    the halos: the plain `ppermute_ring` (the graph build's points and
    mask), or `ppermute_ring_autograd` (values that need gradients)."""
    left = permute(x[:, -w:].contiguous(), group, 1)
    right = permute(x[:, :w].contiguous(), group, -1)
    return torch.cat([left, x, right], dim=1)


def halo_knn(x_shard, k: int, mask_shard=None, *, window: int, group,
             precision: str = "highest", use_kernel: bool = True):
    """Banded kNN over a globally sorted event cut into contiguous bands.

    Args:
      x_shard: ``(B, N_local, C)``, this rank's band (global sorted position
        ``p`` lives on rank ``p // N_local`` at row ``p % N_local``).
      k: neighbour count, at most ``window``.
      mask_shard: ``(B, N_local)`` bool validity of this rank's rows, or
        None.
      window: the band width W, at most ``N_local``.
      group: the point-shard `parallel.mesh.RankGroup`.
      precision: the score precision (``--knn_precision``) of the kernel.
      use_kernel: on CUDA, the banded kernel's cross form
        (`kernels.knn_banded_cuda.knn_banded_cuda_cross`, query base the
        band's first position, key base ``W`` before it, the event's
        global valid count); off, or off CUDA, the plain selection
        `ops.knn._banded_select_core` with the same bases (f32 whatever
        ``precision`` says, as the single-device oracle).

    Returns:
      ``idx`` int32 ``(B, N_local, k)`` global sorted positions and
      ``valid`` bool, False on padded query rows and on slots without an
      in-band valid candidate (both self-edges).
    """
    nl = x_shard.shape[-2]
    w = int(window)
    if w > nl:
        raise ValueError(
            f"knn_window={w} > local shard size {nl}: the halo-exchange "
            f"banded CP needs window <= num_point/point_shards (use fewer "
            f"point shards, a smaller window, or the exact ring path)"
        )
    if k > w:
        raise ValueError(f"k={k} > knn_window={w}")
    if mask_shard is None:
        mask_shard = torch.ones(x_shard.shape[:-1], dtype=torch.bool, device=x_shard.device)
    # (B,) valid points of the whole event
    nvalid = psum_points(mask_shard.sum(-1).to(torch.int32), group)
    ext = _halo_extend(x_shard, w, group)  # (B, NL + 2w, C)
    # the mask travels as bytes
    ext_mask = _halo_extend(mask_shard.to(torch.uint8), w, group).bool()
    return halo_select(x_shard, k, mask_shard, ext, ext_mask, nvalid, window=w,
                       off=group.rank * nl, precision=precision, use_kernel=use_kernel)


def halo_select(x_shard, k: int, mask_shard, ext, ext_mask, nvalid, *, window: int, off: int,
                precision: str = "highest", use_kernel: bool = True):
    """`halo_knn`'s selection on one rank once the halos are in: queries
    ``x_shard`` at global positions from ``off``, keys ``ext`` (``(B, NL +
    2W, C)``, validity ``ext_mask``) from ``off - W``, ``nvalid`` the
    event's valid count; the kernel's cross form on CUDA with
    ``use_kernel``, else the plain selection. Returns ``(idx, valid)`` as
    `halo_knn`."""
    nl = x_shard.shape[-2]
    w = int(window)
    if use_kernel and x_shard.is_cuda:
        # the first rank's left halo claims positions below 0, which no
        # band reaches; the kernel takes key positions from 0
        cut = max(w - off, 0)
        idx, valid, _ = knn_banded_cuda_cross(
            x_shard.contiguous(), ext[:, cut:].contiguous(), k, ext_mask[:, cut:].contiguous(),
            window=w, q_base=off, key_base=off - w + cut, nvalid=nvalid, precision=precision)
    else:
        qb = min(BAND_BLOCK_Q, nl)
        while nl % qb:
            qb //= 2
        vals, idx = _banded_select_core(
            x_shard, torch.sum(torch.square(x_shard), dim=-1), ext,
            torch.sum(torch.square(ext), dim=-1), ext_mask, key_base=off - w, q_base=off,
            nvalid=nvalid, k=k, w=w, qb=qb)
        valid = torch.isfinite(vals)
    # self-edges on degraded slots and on padded query rows
    valid = valid & mask_shard[..., None]
    self_global = off + torch.arange(nl, device=x_shard.device)[None, :, None]
    return torch.where(valid, idx, self_global).to(torch.int32), valid


def halo_extend_values(values_shard, *, window: int, group):
    """The halo exchange, ``(B, N_local, C)`` -> ``(B, N_local + 2W, C)``:
    with `halo_localize_idx` it decomposes `halo_gather` into "exchange
    once, then gather locally", the form the fused EdgeConv block takes.
    Differentiable (the JAX ``halo_extend_values``): the gradients
    scattered into the halo rows go back to the ranks that own them."""
    return _halo_extend(values_shard, int(window), group, ppermute_ring_autograd)


def halo_localize_idx(idx_global, *, window: int, group):
    """Global sorted positions from `halo_knn` -> rows of the
    halo-extended local array (clipped, a guard: every position
    `halo_knn` gives lies in ``[off - W, off + N_local + W)``)."""
    nl = idx_global.shape[-2]
    w = int(window)
    return torch.clamp(idx_global - (group.rank * nl - w), 0, nl + 2 * w - 1)


def halo_gather(values_shard, idx_global, *, window: int, group):
    """``(B, N_local, k, C)`` rows of a point-sharded sorted array by the
    global sorted positions of `halo_knn`: one halo exchange, then a local
    gather."""
    ext = halo_extend_values(values_shard, window=window, group=group)
    return gather_neighbors(ext, halo_localize_idx(idx_global, window=window, group=group))
