"""Rank functions of the context-parallel port tests
(`tests/test_torch_ring.py`, `tests/test_torch_cp.py`,
`tests/test_torch_cuda.py`).

`dgcnn_tpu_torch.parallel.launch.run_point_ranks` runs each of them in
spawned processes, one per point shard, which import this module to find
them. So it imports torch, numpy and the port only, never JAX or
`dgcnn_tpu`, and its inputs are plain numpy arrays and dicts; each result
says which of those packages the rank had imported.
"""

import sys

import numpy as np
import torch


def _shard(a, group):
    """This rank's contiguous rows of a ``(B, N, ...)`` array."""
    nl = a.shape[1] // group.size
    return torch.as_tensor(np.ascontiguousarray(a[:, group.rank * nl:(group.rank + 1) * nl]))


def _imports():
    return {name: name in sys.modules for name in ("jax", "dgcnn_tpu")}


def ring_cases(group, cases):
    """For each case ``(x, mask, k)`` this rank's graph by the rdma ring's
    plain version and by `ring_knn` (plain distance scores)."""
    from dgcnn_tpu_torch.kernels import ring_knn_cuda as rmod
    from dgcnn_tpu_torch.kernels.ring_knn import ring_knn

    out = []
    for x, mask, k in cases:
        xs, ms = _shard(x, group), _shard(mask, group)
        out.append({"rdma": rmod.ring_knn_cuda(xs, k, ms, group=group),
                    "ppermute": ring_knn(xs, k, ms, group=group)})
    # the plain path counts no launch
    return {"cases": out, "launches": rmod.launches, "imports": _imports()}


def gather_pool(group, values, idx_global, feat, mask):
    """`ring_gather` of ``values`` by ``idx_global`` and
    `cp_masked_max_pool` of ``feat`` under ``mask``, with and without the
    mask."""
    from dgcnn_tpu_torch.kernels.ring_knn import ring_gather
    from dgcnn_tpu_torch.parallel.context_parallel import cp_masked_max_pool

    v, i = _shard(values, group), _shard(idx_global, group)
    f, m = _shard(feat, group), _shard(mask, group)
    return {
        "gather": ring_gather(v, i, group=group),
        "pool": cp_masked_max_pool(f, m, group),
        "pool_nomask": cp_masked_max_pool(f, None, group),
        "imports": _imports(),
    }


def cp_inference(group, configs, params, state, batch):
    """`Trainval.inference` of one numpy batch ``(points, labels,
    weights, mask)`` with bridged numpy parameters, on this rank, once for
    each dict of `Config` fields in ``configs``."""
    from dgcnn_tpu_torch.bridge import params_from_numpy
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.models import head
    from dgcnn_tpu_torch.train.trainval import Trainval, TrainState

    state = TrainState(*params_from_numpy(params, state))
    out = []
    for cfg_kwargs in configs:
        tv = Trainval(Config(**cfg_kwargs), device="cpu", group=group)
        runs = head.runs
        scores, pred, metrics = tv.inference(state, batch)
        out.append({"scores": scores, "pred": pred, "metrics": metrics,
                    "block_impl": tv.model.block_impl, "streamed_head": head.runs - runs})
    return {"runs": out, "imports": _imports()}


def card_inference(group, cfg_kwargs, params, state, batches):
    """`Trainval.inference_packed` of each numpy batch on this rank's card
    with the port's own graph builds: the packed output and metrics, each
    kernel module's launches over the batch (Hopper TC, sweep TC, fp32),
    every block's graph on this rank and, for the exact ring in fp32, the
    first block's graph by the ``ppermute`` ring too."""
    from dgcnn_tpu_torch.bridge import params_from_numpy
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.kernels import knn_banded_cuda, knn_cuda, ring_knn_cuda
    from dgcnn_tpu_torch.kernels.ring_knn import ring_knn
    from dgcnn_tpu_torch.train.trainval import Trainval, TrainState

    mods = {"knn": knn_cuda, "banded": knn_banded_cuda, "ring": ring_knn_cuda}

    def counts():
        return {n: (m.launches_tc, m.launches_tc_sweep, m.launches) for n, m in mods.items()}

    tv = Trainval(Config(**cfg_kwargs), group=group)
    state = TrainState(*params_from_numpy(params, state, device=group.device))
    build = tv.model.knn_fn
    out = []
    for batch in batches:
        graphs = []

        def recording(x, k, m, graphs=graphs):
            graphs.append(build(x, k, m))
            return graphs[-1]

        tv.model.knn_fn = recording
        before = counts()
        packed, metrics = tv.inference_packed(state, batch)
        torch.cuda.synchronize(group.device)
        after = counts()
        tv.model.knn_fn = build
        run = {"packed": packed, "metrics": metrics, "graphs": graphs,
               "launches": {n: tuple(a - b for a, b in zip(after[n], before[n])) for n in mods}}
        if not cfg_kwargs.get("knn_window") and tv.cfg.knn_precision == "highest":
            points, _, _, mask = tv._put_batch(batch)
            with torch.inference_mode():
                run["ppermute"] = ring_knn(points.float(), cfg_kwargs["kvalue"], mask,
                                           group=group)
        out.append(run)
    return {"rank": group.rank, "runs": out, "imports": _imports()}


def raise_on_rank(group, bad_rank):
    """Rank ``bad_rank`` raises; the others wait on a collective it never
    joins."""
    from dgcnn_tpu_torch.parallel.collectives import psum_points

    if group.rank == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    return psum_points(torch.ones(1), group)
