"""Rank functions of the data-parallel port tests (`tests/test_torch_dp.py`,
`tests/test_torch_loop.py`).

`dgcnn_tpu_torch.parallel.launch.run_ranks` runs each of them in spawned
processes, one per data rank, which import this module to find them. So
it imports torch, numpy and the port only, never JAX or `dgcnn_tpu`, and
its inputs are plain numpy arrays and dicts; each result says which of
those packages the rank had imported.
"""

import sys

import numpy as np
import torch


def _imports():
    return {name: name in sys.modules for name in ("jax", "dgcnn_tpu")}


def ring(n, k):
    return (np.arange(n)[:, None] + np.arange(k)[None]) % n


def port_ring(x, k, mask):
    """A pinned graph: point i's neighbours are i .. i + k - 1 mod N, what
    the JAX tests' ring ``knn_fn`` returns."""
    idx = torch.tensor(ring(x.shape[-2], k), dtype=torch.int32, device=x.device)
    idx = idx.expand(x.shape[:-1] + (k,))
    return idx, torch.ones(idx.shape, dtype=torch.bool, device=x.device)


def train_cases(group, cases, params, mstate, batches, eval_batch):
    """For each case (a dict of `Config` fields): 3 train steps of
    `Trainval` on this rank from the bridged ``(params, mstate)``, then
    `inference_packed` and `evaluate` of ``eval_batch``; the step
    metrics, the final parameters and BN state, and the eval outputs."""
    from dgcnn_tpu_torch.bridge import params_from_numpy, tree_leaves
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.parallel import collectives
    from dgcnn_tpu_torch.train.trainval import Trainval

    out = []
    for kw in cases:
        tv = Trainval(Config(**kw), device=group.device, group=group, knn_fn=port_ring)
        state = tv.with_params(*params_from_numpy(params, mstate, device=group.device))
        steps = []
        for batch in batches:
            before = dict(collectives.counts)
            state, m = tv.train_step(state, batch)
            ran = {k: v - before.get(k, 0) for k, v in collectives.counts.items()}
            steps.append({"loss": m["loss"], "acc": m["acc"], "class_acc": m["class_acc"],
                          "collectives": ran})
        packed, metrics = tv.inference_packed(state, eval_batch)
        out.append({
            "steps": steps,
            "params": [t.detach() for t in tree_leaves(state.params)],
            "model_state": [t.detach() for t in tree_leaves(state.model_state)],
            "packed": packed, "metrics": metrics,
            "evaluate": tv.evaluate(state, eval_batch),
        })
    return {"cases": out, "imports": _imports()}


def pinned_loop(body, group, *args):
    """``body(group, *args)`` (a loop's rank function) with the trainer's
    graph pinned to `port_ring`, as the loop tests pin it in one
    process."""
    import functools

    from dgcnn_tpu_torch.train import loop
    from dgcnn_tpu_torch.train.trainval import Trainval

    loop.Trainval = functools.partial(Trainval, knn_fn=port_ring)
    return body(group, *args)


def kernel_step(group, kw, batch):
    """One train step with the trainer's own graph build on this rank's
    device: the exact kNN kernel's launches and the kNN function used."""
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.kernels import knn_cuda as kmod
    from dgcnn_tpu_torch.train.trainval import Trainval

    tv = Trainval(Config(**kw), device=group.device, group=group)
    state = tv.initialize(batch[0].shape[-1])
    before = kmod.launches
    state, m = tv.train_step(state, batch)
    return {"launches": kmod.launches - before, "knn_fn": tv.model.knn_fn.__name__,
            "loss": m["loss"], "backend": group.backend, "stage_host": group.stage_host,
            "device": str(group.device)}
