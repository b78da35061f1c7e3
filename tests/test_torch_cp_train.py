"""Context-parallel training of the port against the JAX package's, on CPU
gloo ranks.

Three layouts ``(data, points)`` = (1, 2), (1, 4), (2, 2), each spawned
once (`dgcnn_tpu_torch.parallel.launch.run_ranks`, rank function in
`tests/torch_cp_train_ranks.py`, which imports no JAX) for all its cases.
The oracle is the JAX `Trainval` on the same layout of the 8-device CPU
mesh, from one JAX init bridged into the port, on the same numpy batch, 3
SGD steps: the loss within 1e-4 relative at every step, the parameters
and BN state within 5e-4 after them (`tests/test_context_parallel.py`'s
limits), for the exact ring and the banded halo exchange. Beside it: each
differentiable collective's gradient against the gradient of the
unsharded function in one process (float64, 1e-6); the port's one-device
step on the ranks' own graphs; the block forms against each other; bf16
within 5% of the largest gradient; the streamed head; remat; ``bn_sync``
off; a fully padded shard; the dropout streams of the ranks.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cp_train_ranks
from dgcnn_tpu.config import Config as JaxConfig
from dgcnn_tpu.io.batching import BucketBatcher as JaxBatcher
from dgcnn_tpu.io.synthetic import SyntheticIO as JaxSyntheticIO
from dgcnn_tpu.models import dgcnn as jdgcnn
from dgcnn_tpu.models import head as jhead
from dgcnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dgcnn_tpu.train.trainval import Trainval as JaxTrainval
from dgcnn_tpu_torch.bridge import params_from_numpy, tree_leaves
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.ops.edge import gather_neighbors
from dgcnn_tpu_torch.parallel.launch import run_ranks
from dgcnn_tpu_torch.train.trainval import Trainval, dropout_generator, jax_key, seed_of_key

SMALL = dict(model_name="residual-dgcnn", num_class=2, kvalue=8, edge_filters=(16, 16),
             head_feat_dim=32, head_mlp=(32,), use_pallas=False, precision="highest",
             optimizer="sgd", learning_rate=1e-2, minibatch_size=2)
LAYOUTS = [(1, 2), (1, 4), (2, 2)]
WINDOW = 32
# the streamed head's lines, low in both packages: chunks of 32 rows
HEAD_LINE, HEAD_CHUNK = 1, 32 * 2 * 32
LOSS_RTOL, PARAM_ATOL = 1e-4, 5e-4


def _cases(data, points):
    """The port's cases of a layout, by name: Config fields and steps."""
    base = dict(SMALL, point_shards=points, num_devices=data * points)
    cases = {
        "exact": dict(cfg=dict(base, ring_impl="ppermute", knn_every=1 if data == 1 else 2)),
        "banded": dict(cfg=dict(base, knn_window=WINDOW, num_point=256)),
        "rdma": dict(cfg=dict(base, ring_impl="rdma")),
    }
    if (data, points) == (1, 2):
        cases.update({
            "exact_remat": dict(cfg=dict(base, ring_impl="rdma", remat=True)),
            "banded_remat": dict(cfg=dict(base, knn_window=WINDOW, num_point=256, remat=True)),
            "streamed_head": dict(cfg=dict(base, ring_impl="ppermute"),
                                  head_stream_elems=HEAD_LINE, head_chunk_elems=HEAD_CHUNK),
            "bf16": dict(cfg=dict(base, precision="bfloat16", learning_rate=1.0), steps=1),
            "banded_bf16": dict(cfg=dict(base, precision="bfloat16", learning_rate=1.0,
                                         knn_window=WINDOW, num_point=256), steps=1),
        })
    if (data, points) == (1, 4):
        for impl in ("fused", "edge", "reduced"):
            cases[f"exact_{impl}"] = dict(cfg=dict(base, block_impl=impl), batch="padded",
                                          eval=True)
        for impl in ("fused", "edge"):
            cases[f"banded_{impl}"] = dict(cfg=dict(base, block_impl=impl, knn_window=WINDOW,
                                                    num_point=256), batch="padded", eval=True)
        cases["padded_shards"] = dict(cfg=dict(base), batch="half_empty", steps=10)
    if (data, points) == (2, 2):
        cases["exact_nosync"] = dict(cfg=dict(base, bn_sync=False))
        cases["dropout"] = dict(cfg=dict(base, dropout=0.5), steps=2)
    return cases


def _batches():
    """The full batch (2 x 256, `tests/test_context_parallel.py`'s), a
    padded one (200-point events in a 256 bucket) and the full one with
    only the first 100 points valid (shards past them hold no point)."""
    io = JaxSyntheticIO(num_events=2, num_point=256, seed=0).initialize()
    full = next(JaxBatcher(io, 2, num_point=256, shuffle=False).epoch())
    io = JaxSyntheticIO(num_events=2, num_point=200, seed=11).initialize()
    padded = next(JaxBatcher(io, 2, buckets=(256,), shuffle=False).epoch())
    assert padded.mask.sum() < padded.mask.size
    mask = full.mask.copy()
    mask[:, 100:] = False
    return {"full": full, "padded": padded, "half_empty": dataclasses.replace(full, mask=mask)}


def _tup(b):
    return (b.points, b.labels, b.weights, b.mask)


@functools.lru_cache(maxsize=None)
def _init():
    jstate = JaxTrainval(JaxConfig(**SMALL), mesh=jax_make_mesh(1)).initialize(4)
    leaves = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return leaves(jstate.params), leaves(jstate.model_state)


def _collective_case(points):
    """Float64 inputs of `torch_cp_train_ranks.collective_grads` and every
    rank's cotangent of each collective's output."""
    rng = np.random.RandomState(points)
    b, nl, c, k, w = 2, 8, 3, 4, 3
    n = nl * points
    x = rng.randn(b, n, c)
    mask = rng.rand(b, n) < 0.7
    mask[:, 0] = True
    shapes = {"ppermute": (b, nl, c), "ppermute_back": (b, nl, c),
              "all_gather_tiled": (b, n, c), "all_gather_stacked": (points, b, nl, c),
              "halo_extend": (b, nl + 2 * w, c), "ring_gather": (b, nl, k, c), "cp_pool": (b, c)}
    cot = {name: rng.randn(points, *shape) for name, shape in shapes.items()}
    return dict(x=x, cot=cot, idx_global=rng.randint(0, n, (b, n, k)), mask=mask, window=w)


def _unsharded_grads(case, points):
    """The same objectives on the whole event in one process: the gradient
    of ``sum_r <f_r(X), cot_r>``, cut into the ranks' shards."""
    x = torch.tensor(case["x"], requires_grad=True)
    n = x.shape[1]
    nl, w = n // points, case["window"]
    cot = {name: torch.tensor(c) for name, c in case["cot"].items()}
    shards = lambda t: [t[:, r * nl:(r + 1) * nl] for r in range(points)]  # noqa: E731

    def halo(r):
        rows = torch.arange(r * nl - w, (r + 1) * nl + w) % n
        return x[:, rows]

    mask = torch.tensor(case["mask"])
    neg = torch.finfo(x.dtype).min
    outs = {
        "ppermute": [shards(x)[(r - 1) % points] for r in range(points)],
        "ppermute_back": [shards(x)[(r + 1) % points] for r in range(points)],
        "all_gather_tiled": [x for _ in range(points)],
        "all_gather_stacked": [torch.stack(shards(x)) for _ in range(points)],
        "halo_extend": [halo(r) for r in range(points)],
        "ring_gather": [gather_neighbors(x, torch.tensor(case["idx_global"][:, r * nl:(r + 1) * nl]))
                        for r in range(points)],
        "cp_pool": [torch.where(mask[..., None], x, neg).amax(-2) for _ in range(points)],
    }
    grads = {}
    for name, ys in outs.items():
        total = sum((y * cot[name][r]).sum() for r, y in enumerate(ys))
        (g,) = torch.autograd.grad(total, [x])
        grads[name] = shards(g)
    return grads


@functools.lru_cache(maxsize=None)
def _port(data, points):
    """Every case of the layout in one spawn; the results by world rank."""
    params, mstate = _init()
    batches = {name: _tup(b) for name, b in _batches().items()}
    return run_ranks(torch_cp_train_ranks.cp_train, data * points, points, device="cpu",
                     args=(_collective_case(points), _cases(data, points), params, mstate,
                           batches), timeout=300)


@functools.lru_cache(maxsize=None)
def _jax(data, points, name):
    """The JAX CP `Trainval` of case ``name`` on the same layout: the steps'
    metrics and the parameters and BN state after them, as numpy."""
    case = _cases(data, points)[name]
    cfg = dict(case["cfg"])
    cfg.pop("ring_impl", None)  # the JAX trainer refuses rdma off the TPU
    if not cfg.get("bn_sync", True):
        # the JAX CP step without sync BN fails to trace on the data x
        # points mesh (ROADMAP section 3); with one event a data replica it
        # is data parallelism with each event's statistics whole
        data, points = data * points // points, 1
        cfg.update(point_shards=1, num_devices=data)
    params, mstate = _init()
    with pytest.MonkeyPatch.context() as mp:
        if "head_stream_elems" in case:
            mp.setattr(jdgcnn, "HEAD_STREAM_ELEMS", case["head_stream_elems"])
            mp.setattr(jhead, "HEAD_CHUNK_TARGET_ELEMS", case["head_chunk_elems"])
        jtv = JaxTrainval(JaxConfig(**cfg), mesh=jax_make_mesh(data * points,
                                                             num_point_shards=points))
        js = jtv.initialize(4)
        js = jax.device_put(js._replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                                        model_state=jax.tree_util.tree_map(jnp.asarray, mstate)),
                            jtv._repl_sharding)
        batch = _batches()[case.get("batch", "full")]
        steps = []
        for _ in range(case.get("steps", 3)):
            js, m = jtv.train_step(js, batch)
            steps.append({k: np.asarray(v) for k, v in m.items()})
    leaves = lambda t: [np.asarray(a) for a in jax.tree_util.tree_leaves(t)]  # noqa: E731
    return {"steps": steps, "params": leaves(js.params), "model_state": leaves(js.model_state)}


def _assert_run_close(got, want, loss_rtol=LOSS_RTOL, atol=PARAM_ATOL):
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"], strict=True)):
        np.testing.assert_allclose(float(g["loss"]), float(w["loss"]), rtol=loss_rtol,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(float(g["acc"]), float(w["acc"]), rtol=loss_rtol)
    for sub in ("params", "model_state"):
        assert len(got[sub]) == len(want[sub])
        for a, b in zip(got[sub], want[sub]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


def _replicated(ranks, name):
    """Every rank holds world rank 0's parameters and BN state, bit for
    bit (one all-reduce of the gradient); returns rank 0's run."""
    got = ranks[0]["cases"][name]
    for r in ranks[1:]:
        for sub in ("params", "model_state"):
            for a, b in zip(r["cases"][name][sub], got[sub]):
                np.testing.assert_array_equal(a, b)
        assert [float(s["loss"]) for s in r["cases"][name]["steps"]] == [
            float(s["loss"]) for s in got["steps"]]
    return got


def _whole_graphs(ranks, name, data, points):
    """The ranks' graphs of every build, joined into the whole batch's:
    point shards along the points, data ranks along the events."""
    builds = len(ranks[0]["cases"][name]["graphs"])
    out = []
    for j in range(builds):
        rows = []
        for d in range(data):
            parts = [ranks[d * points + p]["cases"][name]["graphs"][j] for p in range(points)]
            rows.append([np.concatenate([np.asarray(pt[t]) for pt in parts], axis=1)
                         for t in (0, 1)])
        out.append(tuple(torch.as_tensor(np.concatenate([r[t] for r in rows], axis=0))
                         for t in (0, 1)))
    return out


def _one_device(cfg, graphs, batch, steps):
    """The port's one-process trainer from the bridged init, its graph
    builds replaced by ``graphs`` in order."""
    replay = iter(graphs)
    kw = {k: v for k, v in cfg.items() if k not in ("point_shards", "num_devices", "ring_impl")}
    tv = Trainval(Config(**kw), device="cpu", knn_fn=lambda x, k, m: next(replay))
    state = tv.with_params(*params_from_numpy(*_init()))
    out = []
    for _ in range(steps):
        state, m = tv.train_step(state, batch)
        out.append(m)
    return {"steps": out, "params": tree_leaves(state.params),
            "model_state": tree_leaves(state.model_state)}


@pytest.mark.parametrize("data,points", LAYOUTS)
def test_collective_gradients_match_the_unsharded_function(data, points):
    """Each differentiable collective (ppermute both ways, the tiled and
    the stacked all-gather, the halo extend, the ring gather, the CP
    pool): on every rank the gradient equals the unsharded function's on
    that rank's shard, to 1e-6 (float64); every collective's backward ran
    (its ``_backward`` count)."""
    ranks = _port(data, points)
    want = _unsharded_grads(_collective_case(points), points)
    for r in ranks:
        got = r["collectives"]
        for name, shards in want.items():
            np.testing.assert_allclose(got[name], shards[r["rank"]].numpy(), rtol=0, atol=1e-6,
                                       err_msg=name)
        assert got["counts"]["ppermute_backward"] > 0 and got["counts"]["all_gather_backward"] > 0


@pytest.mark.parametrize("axis,tiled", [(-2, True), (0, False)])
def test_all_gather_backward_layouts_agree(monkeypatch, axis, tiled):
    """The all-gather's backward: its NCCL branch (`dist.reduce_scatter_tensor`,
    here a local sum over the ranks' inputs split along dim 0 as NCCL does)
    and its gloo branch (an all-reduce, here a local sum, and a slice) give
    every rank its part of the cotangent summed over the ranks, for the
    tiled (the CP extend, axis -2) and the stacked (the CP pool, axis 0)
    gathers."""
    import types

    from dgcnn_tpu_torch.parallel import collectives

    p = 3
    shape = (2, 4 * p, 5) if tiled else (p, 2, 7)
    dys = [torch.tensor(np.random.default_rng(r).normal(size=shape)) for r in range(p)]
    total = sum(dys)
    inputs = {}

    def reduce_scatter(out, inp, group=None):
        inputs[group] = inp  # the first pass records every rank's input
        out.copy_(sum(inputs.values()).chunk(p, 0)[group] if len(inputs) == p else 0)

    def all_reduce(buf, op=None, group=None):
        buf.copy_(total)

    monkeypatch.setattr(collectives.dist, "reduce_scatter_tensor", reduce_scatter)
    monkeypatch.setattr(collectives.dist, "all_reduce", all_reduce)
    for me in range(p):  # record every rank's input
        collectives._reduce_scatter(dys[me], types.SimpleNamespace(
            backend="nccl", size=p, rank=me, pg=me, stage_host=False), axis, tiled)
    for me in range(p):
        nccl, gloo = (collectives._reduce_scatter(dys[me], types.SimpleNamespace(
            backend=backend, size=p, rank=me, pg=me, stage_host=False), axis, tiled)
            for backend in ("nccl", "gloo"))
        want = total.select(axis, me) if not tiled else total.narrow(axis % 3, me * 4, 4)
        assert nccl.shape == gloo.shape == want.shape
        assert torch.equal(nccl, want) and torch.equal(gloo, want)


@pytest.mark.parametrize("data,points", LAYOUTS)
@pytest.mark.parametrize("name", ["exact", "banded"])
def test_cp_train_matches_jax(data, points, name):
    """The exact ring (``knn_every`` 2 at 2 x 2, as the JAX test) and the
    banded halo exchange (W=32) against the JAX CP trainer at the same
    layout; the ranks agree bit for bit; no JAX in the ranks."""
    ranks = _port(data, points)
    assert all(not any(r["imports"].values()) for r in ranks)
    got = _replicated(ranks, name)
    assert got["block_impl"] == "fused"
    _assert_run_close(got, _jax(data, points, name))


@pytest.mark.parametrize("data,points", LAYOUTS)
@pytest.mark.parametrize("name", ["exact", "banded", "rdma"])
def test_cp_train_matches_one_device_on_its_graphs(data, points, name):
    """The port's one-device trainer on the ranks' own graphs (exact and
    banded graphs in the whole event's positions; the exact ring by
    ``ppermute`` and by the rdma ring's plain merge): loss within 1e-5,
    parameters and BN state within 1e-5."""
    ranks = _port(data, points)
    got = _replicated(ranks, name)
    case = _cases(data, points)[name]
    want = _one_device(case["cfg"], _whole_graphs(ranks, name, data, points),
                       _tup(_batches()["full"]), len(got["steps"]))
    _assert_run_close(got, want, loss_rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["exact", "banded"])
def test_cp_block_forms_agree(kind):
    """``fused`` == ``edge`` (== ``reduced`` on the exact ring) under CP on
    a padded batch over 4 shards: 3 steps within the JAX limits, and the
    eval of each form's trained state equal on the valid points within
    1e-5 (the JAX tests' `test_cp_fused_matches_edge_impl`)."""
    ranks = _port(1, 4)
    forms = ("fused", "edge", "reduced") if kind == "exact" else ("fused", "edge")
    runs = {f: _replicated(ranks, f"{kind}_{f}") for f in forms}
    assert [runs[f]["block_impl"] for f in forms] == list(forms)
    m = _batches()["padded"].mask
    for f in forms[1:]:
        _assert_run_close(runs[f], runs["fused"])
        np.testing.assert_allclose(runs[f]["packed"][m][:, :2], runs["fused"]["packed"][m][:, :2],
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["bf16", "banded_bf16"])
def test_bf16_edge_cp_gradient(name):
    """bf16 (the edge form, through the differentiable ring gather or halo
    gather) at 1 x 2: one SGD step at rate 1, so the update is the
    gradient; against the port's one-device bf16 step on the ranks'
    graphs, within 5% of the largest gradient entry; the loss within 1e-3
    relative."""
    ranks = _port(1, 2)
    got = _replicated(ranks, name)
    assert got["block_impl"] == "edge"
    case = _cases(1, 2)[name]
    want = _one_device(case["cfg"], _whole_graphs(ranks, name, 1, 2), _tup(_batches()["full"]), 1)
    p0 = tree_leaves(params_from_numpy(*_init())[0])
    g_got = [p.numpy() - a for p, a in zip(p0, got["params"])]
    g_want = [(p - a).numpy() for p, a in zip(p0, want["params"])]
    top = max(float(np.abs(g).max()) for g in g_want)
    assert top > 0
    gap = max(float(np.abs(a - b).max()) for a, b in zip(g_got, g_want))
    assert gap <= 0.05 * top, (gap, top)
    np.testing.assert_allclose(float(got["steps"][0]["loss"]),
                               float(want["steps"][0]["loss"]), rtol=1e-3)


def test_streamed_head_cp_train_matches_jax():
    """``HEAD_STREAM_ELEMS`` and the chunk target low in both packages: the
    streamed head trains under CP (its pool of partials through the
    differentiable stacked all-gather, its BN statistics over the group)
    and matches the JAX streamed head at 1 x 2."""
    ranks = _port(1, 2)
    got = _replicated(ranks, "streamed_head")
    assert got["streamed_head"] == 3
    _assert_run_close(got, _jax(1, 2, "streamed_head"))
    _assert_run_close(got, _replicated(ranks, "exact"), loss_rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["exact", "banded"])
def test_remat_under_cp_equals_no_remat(kind):
    """``--remat`` recomputes each block and its exchange in backward: the
    same steps as without it (the exact case on the rdma ring)."""
    ranks = _port(1, 2)
    got = _replicated(ranks, f"{kind}_remat")
    want = _replicated(ranks, "rdma" if kind == "exact" else "banded")
    _assert_run_close(got, want, loss_rtol=1e-6, atol=1e-6)


def test_bn_sync_off_at_two_by_two():
    """``--no_bn_sync`` on the 2 x 2 mesh: BN statistics over the points
    axis only, the running ones averaged over the data axis; one event a
    data replica, so the JAX oracle is its DP-2 trainer without sync BN
    (its CP step fails to trace here, ROADMAP section 3); differs from
    sync BN."""
    ranks = _port(2, 2)
    got = _replicated(ranks, "exact_nosync")
    _assert_run_close(got, _jax(2, 2, "exact_nosync"))
    sync = ranks[0]["cases"]["exact"]
    assert any(not np.allclose(a, b) for a, b in zip(got["model_state"], sync["model_state"]))


def test_fully_padded_shards_train():
    """Events with 100 valid points of 256 over 4 shards (shards 2 and 3
    hold none): 10 steps, finite losses that fall (the JAX
    `test_cp_variable_length_masked`)."""
    got = _replicated(_port(1, 4), "padded_shards")
    losses = [float(s["loss"]) for s in got["steps"]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_dropout_streams_by_world_rank():
    """Dropout on the 2 x 2 mesh: world rank ``data_rank * 2 +
    point_rank`` draws from its own stream, so point shards draw
    different masks, and world rank 0 draws the one-process stream."""
    ranks = _port(2, 2)
    seed = seed_of_key(jax_key(Config(**SMALL).seed))
    for step in range(2):
        draws = [next(d for d in r["cases"]["dropout"]["draws"] if d["step"] == step)
                 for r in ranks]
        assert [d["rank"] for d in draws] == [r["data_rank"] * 2 + r["rank"] for r in ranks]
        assert len({tuple(np.asarray(d["draw"]).tolist()) for d in draws}) == 4
        one = torch.rand(8, generator=dropout_generator("cpu", seed, step, 0))
        np.testing.assert_array_equal(draws[0]["draw"], one.numpy())
    losses = [float(s["loss"]) for s in _replicated(ranks, "dropout")["steps"]]
    assert np.isfinite(losses).all()
