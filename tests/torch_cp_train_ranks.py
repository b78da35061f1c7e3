"""Rank functions of the context-parallel training tests
(`tests/test_torch_cp_train.py`, `tests/test_torch_cuda.py`).

`dgcnn_tpu_torch.parallel.launch.run_ranks` runs them in spawned
processes, one per rank of a ``(data, points)`` layout, which import this
module to find them. So it imports torch, numpy and the port only, never JAX or
`dgcnn_tpu`; its inputs are numpy arrays and dicts.
"""

import torch

import torch_cp_ranks


def collective_grads(group, x, cot, idx_global, mask, window):
    """The gradient, on this rank's shard, of ``sum <f(shard), cot_r>``
    summed over the ranks, for each differentiable collective ``f``, by
    autograd on each rank (the backward collectives carry the other ranks'
    cotangents home). ``x`` ``(B, N, C)`` is the whole event of this data
    replica; ``cot`` maps each collective to every rank's cotangent,
    stacked on a leading points axis."""
    from dgcnn_tpu_torch.kernels.halo_knn import halo_extend_values
    from dgcnn_tpu_torch.kernels.ring_knn import ring_gather
    from dgcnn_tpu_torch.parallel import collectives
    from dgcnn_tpu_torch.parallel.context_parallel import cp_masked_max_pool

    def shard(a, group):
        return torch_cp_ranks._shard(a, group).to(group.device)

    fns = {
        "ppermute": lambda v: collectives.ppermute_ring_autograd(v, group, 1),
        "ppermute_back": lambda v: collectives.ppermute_ring_autograd(v, group, -1),
        "all_gather_tiled": lambda v: collectives.all_gather_autograd(v, group, axis=-2),
        "all_gather_stacked": lambda v: collectives.all_gather_autograd(v, group, axis=0,
                                                                        tiled=False),
        "halo_extend": lambda v: halo_extend_values(v, window=window, group=group),
        "ring_gather": lambda v: ring_gather(v, shard(idx_global, group), group=group),
        "cp_pool": lambda v: cp_masked_max_pool(v, shard(mask, group), group),
    }
    out = {}
    before = dict(collectives.counts)
    for name, f in fns.items():
        v = shard(x, group).requires_grad_(True)
        y = f(v)
        c = torch.as_tensor(cot[name][group.rank], device=group.device)
        (g,) = torch.autograd.grad((y * c).sum(), [v])
        out[name] = g
    out["counts"] = {k: v - before.get(k, 0) for k, v in collectives.counts.items()}
    return out


def cp_train(group, collective_case, cases, params, mstate, batches):
    """On this rank: `collective_grads` of ``collective_case`` (a dict of
    its arguments), then for each case of ``cases`` a `Trainval` of its
    `Config` fields from the bridged ``(params, mstate)``, ``steps`` train
    steps on ``batches[batch]``: each step's metrics and each kernel
    module's launches in it (Hopper TC, sweep TC, fp32), the parameters
    after the first step, the parameters and BN state after the last, the
    graphs every build gave this rank, and what each step's dropout drew,
    on the group's device. A case's ``head_stream_elems`` and
    ``head_chunk_elems`` set the streamed head's lines on this rank; with
    ``halo_gap``, its result holds `halo_backward_gap` at the case's block
    shape and compute dtype."""
    from dgcnn_tpu_torch.bridge import params_from_numpy, tree_leaves
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.kernels import knn_banded_cuda, knn_cuda, ring_knn_cuda
    from dgcnn_tpu_torch.models import head
    from dgcnn_tpu_torch.train import trainval

    mods = {"knn": knn_cuda, "banded": knn_banded_cuda, "ring": ring_knn_cuda}

    def counts():
        if group.device.type == "cuda":
            torch.cuda.synchronize(group.device)
        return {n: (m.launches_tc, m.launches_tc_sweep, m.launches) for n, m in mods.items()}

    out = {"rank": group.rank, "data_rank": group.data_rank,
           "collectives": collective_grads(group, **collective_case) if collective_case else None,
           "cases": {}, "imports": torch_cp_ranks._imports()}
    draws = []
    make_gen = trainval.dropout_generator

    def recording_gen(device, seed, step, rank=0):
        gen = make_gen(device, seed, step, rank)
        probe = torch.Generator(device=device)
        probe.set_state(gen.get_state())
        draws.append({"step": step, "rank": rank,
                      "draw": torch.rand(8, generator=probe, device=device)})
        return gen

    trainval.dropout_generator = recording_gen
    lines = (head.HEAD_STREAM_ELEMS, head.HEAD_CHUNK_TARGET_ELEMS)
    for name, case in cases.items():
        head.HEAD_STREAM_ELEMS = case.get("head_stream_elems") or lines[0]
        head.HEAD_CHUNK_TARGET_ELEMS = case.get("head_chunk_elems") or lines[1]
        cfg = Config(**case["cfg"])
        tv = trainval.Trainval(cfg, group=group)
        graphs, build = [], tv.model.knn_fn

        def recording(x, k, m, build=build, graphs=graphs):
            graphs.append(build(x, k, m))
            return graphs[-1]

        tv.model.knn_fn = recording
        state = tv.with_params(*params_from_numpy(params, mstate, device=group.device))
        del draws[:]
        runs = head.runs
        steps, launches, first = [], [], None
        for _ in range(case.get("steps", 3)):
            before = counts()
            state, m = tv.train_step(state, batches[case.get("batch", "full")])
            after = counts()
            launches.append({n: tuple(a - b for a, b in zip(after[n], before[n])) for n in mods})
            steps.append({k: v.detach().clone() for k, v in m.items()})
            first = first or [t.detach().clone() for t in tree_leaves(state.params)]
        out["cases"][name] = {
            "steps": steps,
            "launches": launches,
            "params1": first,
            "params": [t.detach().clone() for t in tree_leaves(state.params)],
            "model_state": [t.detach().clone() for t in tree_leaves(state.model_state)],
            "graphs": [(i.clone(), v.clone()) for i, v in graphs],
            "block_impl": tv.model.block_impl,
            "streamed_head": head.runs - runs,
            "draws": list(draws),
        }
        if case.get("halo_gap"):
            shape = (cfg.minibatch_size // group.data_size, cfg.num_point // group.size,
                     cfg.edge_filters[0])
            dtype = torch.bfloat16 if cfg.precision == "bfloat16" else torch.float32
            out["cases"][name]["halo_backward_gap"] = halo_backward_gap(
                group, shape, cfg.knn_window, dtype)
        if case.get("eval"):
            packed, _ = tv.inference_packed(state, batches[case.get("batch", "full")])
            out["cases"][name]["packed"] = packed
    head.HEAD_STREAM_ELEMS, head.HEAD_CHUNK_TARGET_ELEMS = lines
    trainval.dropout_generator = make_gen
    return out


def halo_backward_gap(group, shape, window, dtype):
    """The halo exchange's backward (`halo_extend_values`) on this rank's
    seeded ``(B, N_local, C)`` block under a seeded cotangent, against the
    cotangent the plain exchange sends home: the band's own rows, plus the
    right neighbour's left halo on the last W rows and the left
    neighbour's right halo on the first W (with W <= N_local / 2 a row
    takes at most one, so either order rounds alike). A dropped or
    misrouted halo cotangent moves a bf16 step's gradient less than bf16
    rounding does, so a step's comparison cannot see it. Returns the
    largest absolute difference: 0 when they agree bit for bit."""
    from dgcnn_tpu_torch.kernels.halo_knn import halo_extend_values
    from dgcnn_tpu_torch.parallel.collectives import ppermute_ring

    gen = torch.Generator(device=group.device).manual_seed(group.rank)
    x = torch.randn(shape, generator=gen, device=group.device).to(dtype).requires_grad_(True)
    with torch.enable_grad():
        ext = halo_extend_values(x, window=window, group=group)
        r = torch.randn(ext.shape, generator=gen, device=group.device).to(dtype)
        (got,) = torch.autograd.grad(ext, x, r)
    nl, w = shape[1], window
    want = r[:, w:w + nl].clone()
    want[:, -w:] += ppermute_ring(r[:, :w].contiguous(), group, -1)
    want[:, :w] += ppermute_ring(r[:, -w:].contiguous(), group, 1)
    return float((got.float() - want.float()).abs().max())
