"""Rank function of the banded context-parallel port tests
(`tests/test_torch_banded_cp.py`).

`dgcnn_tpu_torch.parallel.launch.run_point_ranks` runs it in spawned
processes, one per point shard, which import this module to find it. So it
imports torch, numpy and the port only, never JAX or `dgcnn_tpu`; its
inputs are numpy arrays and dicts.
"""

import numpy as np
import torch

import torch_cp_ranks


def banded_cp(group, knn_cases, gather_case, configs, params, state, batch):
    """On this rank: `halo_knn` of each case ``(x, mask, k, window)`` (the
    rank's band of a sorted event), `halo_gather` of ``gather_case``
    ``(values, idx_global, window)``, and `Trainval.inference` of
    ``batch`` for each dict of `Config` fields in ``configs``."""
    from dgcnn_tpu_torch.kernels.halo_knn import halo_gather, halo_knn

    shard = torch_cp_ranks._shard
    knn = []
    for x, mask, k, window in knn_cases:
        knn.append(halo_knn(shard(x, group), k, shard(mask, group), window=window, group=group))
    values, idx, window = gather_case
    gathered = halo_gather(shard(values, group), shard(idx, group), window=window, group=group)
    runs = torch_cp_ranks.cp_inference(group, configs, params, state, batch)
    return {"knn": knn, "gather": gathered, "runs": runs["runs"], "imports": runs["imports"],
            "rank": group.rank, "nl": np.shape(batch[0])[1] // group.size}


def rank_operands(x, mask, rank: int, size: int, window: int):
    """What `halo_knn.halo_select` gets on rank ``rank`` of ``size``, cut
    from the whole sorted event ``(B, N, C)`` and its mask in one process
    (the halo exchange's result, wrap-around included): ``(x_shard,
    mask_shard, ext, ext_mask, nvalid, off)``. For checks of the selection
    on one card (`tests/test_torch_cuda.py`)."""
    nl = x.shape[1] // size
    off = rank * nl
    rows = torch.arange(off - window, off + nl + window, device=x.device) % x.shape[1]
    return (x[:, off:off + nl], mask[:, off:off + nl], x[:, rows], mask[:, rows],
            mask.sum(-1).to(torch.int32), off)
