"""Mixed precision and remat in the port's model and trainer, against the
JAX package on the CPU.

- bf16 (``compute_dtype="bfloat16"``) against JAX's
  ``make_model(compute_dtype="bfloat16")`` on one pinned graph (the JAX
  forward records its graph builds, the port replays them) with bridged
  parameters. XLA:CPU may keep excess precision where torch rounds
  (`dgcnn_tpu/models/dgcnn.py:508`), so the tolerances are bf16-scale:
  eval logits within 2^-7 of the largest logit (one bf16 unit at the top:
  measured equal), train logits within 2^-6 of it, the new BN state within
  1e-2 relative, and gradients within 5% of the largest gradient entry of
  the model (a bf16 matmul's gradient carries 8 bits; 2.5% measured).
- bf16 types: f32 logits, f32 parameter gradients, f32 BN outputs from
  bf16 inputs, bf16 block outputs; ``block_impl`` ignored (the edge form).
- The 6-block bf16 stack keeps finite gradients, and 40 bf16 Adam steps
  halve the loss (`tests/test_mixed_precision.py`'s cases).
- Remat against no remat: the same loss and gradients, bit for bit (the
  recompute repeats the same ops on the CPU), for the fused, reduced and
  edge forms in f32 and in bf16, with the kNN function called once a
  block, not again in backward; and on 2 gloo data ranks with sync BN,
  whose recompute issues each block's statistic all-reduce again.
- A `Trainval` trajectory of 5 bf16 + remat steps against the JAX
  `Trainval` on a pinned ring graph: loss within 1e-2 relative at every
  step (1.6e-3 measured), parameters within 2e-2 of the largest parameter
  after 5 steps (5e-3 measured).
"""

import functools
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.config import Config as JaxConfig
from dgcnn_tpu.io.batching import BucketBatcher as JaxBatcher
from dgcnn_tpu.io.synthetic import SyntheticIO as JaxSyntheticIO
from dgcnn_tpu.models import ModelSpec as JaxSpec
from dgcnn_tpu.models import get_model as jax_get_model
from dgcnn_tpu.ops.knn import knn_indices as jax_knn
from dgcnn_tpu.train.trainval import Trainval as JaxTrainval
from dgcnn_tpu_torch.bridge import params_from_numpy, params_to_numpy, tree_leaves, tree_map
from dgcnn_tpu_torch.config import Config, parse_args
from dgcnn_tpu_torch.models import ModelSpec, get_model
from dgcnn_tpu_torch.models import dgcnn as mdgcnn
from dgcnn_tpu_torch.ops.norm import batch_norm_apply, batch_norm_init
from dgcnn_tpu_torch.parallel.launch import run_ranks
from dgcnn_tpu_torch.train.trainval import Trainval

sys.path.insert(0, os.path.dirname(__file__))
import torch_dp_ranks  # noqa: E402

SMALL = dict(num_class=3, k=8, edge_filters=(16, 24, 24), head_feat_dim=40, head_mlp=(32, 16))
BF16 = dict(SMALL, compute_dtype="bfloat16")


def _inputs(seed, b=2, n=96, f=4, nvalid=(96, 41)):
    rng = np.random.RandomState(seed)
    pts = rng.randn(b, n, f).astype(np.float32)
    mask = np.arange(n)[None] < np.asarray(nvalid)[:, None]
    return pts, mask


class Pinned:
    """The JAX graph builds recorded once, replayed to the port in call
    order (the port's graph builds get f32 features, JAX's bf16 ones: the
    recorded graph is what both use)."""

    def __init__(self):
        self.graphs = []

    def record(self, x, k, mask):
        idx, valid = jax_knn(x, k, mask)
        self.graphs.append((np.asarray(idx), np.asarray(valid)))
        return idx, valid

    def replay(self):
        it = iter(self.graphs)

        def knn(x, k, mask):
            idx, valid = next(it)
            return torch.tensor(idx), torch.tensor(valid)

        return knn


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_case(spec_kw, train, seed=3, name="residual-dgcnn"):
    pts, mask = _inputs(seed)
    pin = Pinned()
    jmodel = jax_get_model(name, JaxSpec(**spec_kw), knn_fn=pin.record)
    params, state = jmodel.init(jax.random.PRNGKey(0), pts.shape[-1])
    logits, new_state = jmodel.apply(params, state, jnp.asarray(pts), jnp.asarray(mask),
                                     train=train)
    return jmodel, params, state, pts, mask, pin, np.asarray(logits), _np(new_state)


FORWARD_CASES = {
    "eval": (False, "residual-dgcnn", {}),
    "train": (True, "residual-dgcnn", {}),
    # the stacked per-edge convs: the edge tensor enters each conv in bf16
    # and leaves its BN in f32
    "train_block_convs2": (True, "residual-dgcnn", dict(block_convs=2)),
    "train_head_factorized": (True, "residual-dgcnn", dict(head_factorized=True)),
    "train_dgcnn": (True, "dgcnn", {}),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_bf16_forward_matches_jax_on_a_pinned_graph(case):
    train, name, extra = FORWARD_CASES[case]
    spec_kw = {**BF16, **extra}
    _, params, state, pts, mask, pin, want, want_state = _jax_case(spec_kw, train, name=name)
    model = get_model(name, ModelSpec(**spec_kw), knn_fn=pin.replay())
    tp, ts = params_from_numpy(_np(params), _np(state))
    got, got_state = model(tp, ts, torch.tensor(pts), torch.tensor(mask), train=train)
    assert got.dtype == torch.float32
    top = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=(2.0**-6 if train else 2.0**-7) * top)
    for g, w in zip(tree_leaves(got_state), jax.tree_util.tree_leaves(want_state)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-2, atol=1e-3)


def _loss_weights(shape):
    return np.random.RandomState(0).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_bf16_gradients_match_jax_on_a_pinned_graph(remat):
    jmodel, params, state, pts, mask, pin, want, _ = _jax_case(BF16, True)
    w = _loss_weights(want.shape)
    jgrad = jax.grad(lambda p: jnp.sum(jmodel.apply(p, state, jnp.asarray(pts), jnp.asarray(mask),
                                                    train=True)[0] * w))(params)
    # the JAX gradient pass built the graph again: replay the first forward's
    pin.graphs = pin.graphs[:len(BF16["edge_filters"])]
    model = get_model("residual-dgcnn", ModelSpec(**BF16, remat=remat), knn_fn=pin.replay())
    tp, ts = params_from_numpy(_np(params), _np(state))
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    logits, _ = model(tp, ts, torch.tensor(pts), torch.tensor(mask), train=True)
    grads = torch.autograd.grad((logits * torch.tensor(w)).sum(), leaves)
    want_leaves = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrad)]
    top = max(float(np.abs(g).max()) for g in want_leaves)
    for g, wl in zip(grads, want_leaves):
        assert g.dtype == torch.float32  # master parameters stay f32
        np.testing.assert_allclose(g.numpy(), wl, rtol=0, atol=0.05 * top)


def test_bf16_types_along_the_model():
    """Block outputs in bf16, BN outputs in f32 from bf16 inputs, logits
    f32; the f32 model keeps f32 everywhere."""
    pts, mask = _inputs(4)
    for spec_kw, block_dtype in ((BF16, torch.bfloat16), (SMALL, torch.float32)):
        model = get_model("residual-dgcnn", ModelSpec(**spec_kw))
        params, state = model.init(4, torch.Generator().manual_seed(0))
        seen = []
        block = model._block

        def spy(*args, **kwargs):
            y, s = block(*args, **kwargs)
            seen.append(y.dtype)
            return y, s

        model._block = spy
        logits, _ = model(params, state, torch.tensor(pts), torch.tensor(mask), train=True)
        assert seen == [block_dtype] * len(spec_kw["edge_filters"])
        assert logits.dtype == torch.float32
    p, s = batch_norm_init(8)
    x = torch.ones((4, 8), dtype=torch.bfloat16)
    for train in (False, True):
        y, _ = batch_norm_apply(p, s, x, train=train)
        assert y.dtype == torch.float32


@pytest.mark.parametrize("impl", ["fused", "reduced"])
def test_block_impl_is_ignored_under_bf16(impl, capsys):
    """A bf16 model rounds each edge's pre-activation before BN, which the
    restructured forms cannot reproduce: an explicit fused or reduced
    block falls back to the edge form with a warning (as the JAX package
    prints one), and gives the edge model's logits bit for bit."""
    pts, mask = _inputs(5)
    with pytest.warns(UserWarning, match="forces the 'edge' implementation"):
        model = get_model("residual-dgcnn", ModelSpec(**BF16, block_impl=impl))
    assert model.block_impl == "edge"
    auto = get_model("residual-dgcnn", ModelSpec(**BF16))
    assert auto.block_impl == "edge"
    params, state = model.init(4, torch.Generator().manual_seed(1))
    for train in (False, True):
        a, _ = model(params, state, torch.tensor(pts), torch.tensor(mask), train=train)
        b, _ = auto(params, state, torch.tensor(pts), torch.tensor(mask), train=train)
        assert torch.equal(a, b)
    jax_get_model("residual-dgcnn", JaxSpec(**BF16, block_impl=impl))
    assert "forces the 'edge' implementation" in capsys.readouterr().out


def _labels(pts):
    return torch.tensor((pts[..., 0] > 0).astype(np.int64))


def test_bf16_deep_stack_gradients_are_finite():
    """The 6-block residual stack in bf16 (the depth at which casting the
    post-BN chain to bf16 overflowed): finite gradients, and close in
    direction to the f32 model's on the same graph (cosine > 0.99 per
    leaf of the blocks; the f32 and bf16 gradients measure ~0.999)."""
    spec = dict(num_class=2, k=8, edge_filters=(32,) * 6, head_feat_dim=64, head_mlp=(64,))
    pts = np.random.RandomState(0).randn(1, 512, 4).astype(np.float32)
    labels = _labels(pts)
    grads = {}
    for dtype in ("bfloat16", "float32"):
        model = get_model("residual-dgcnn", ModelSpec(**spec, compute_dtype=dtype),
                          knn_fn=functools.partial(_fixed_graph, pts=pts))
        params, state = model.init(4, torch.Generator().manual_seed(0))
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        logits, _ = model(params, state, torch.tensor(pts), train=True)
        loss = torch.nn.functional.cross_entropy(logits.reshape(-1, 2), labels.reshape(-1))
        assert torch.isfinite(loss)
        grads[dtype] = torch.autograd.grad(loss, leaves)
    for g in grads["bfloat16"]:
        assert bool(torch.isfinite(g).all())
    n_block = len(tree_leaves(params["blocks"]))
    for a, b in list(zip(grads["bfloat16"], grads["float32"]))[:n_block]:
        if float(b.norm()) > 1e-6:
            assert float(torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), 0)) > 0.99


def _fixed_graph(x, k, mask, pts):
    """The f32 oracle graph of the raw points, for every block: one graph
    for both dtypes."""
    from dgcnn_tpu_torch.ops.knn import knn_indices

    return knn_indices(torch.tensor(pts), k, mask)


def test_bf16_adam_halves_the_loss():
    """40 Adam steps of the bf16 model at 1e-2, as
    `tests/test_mixed_precision.py::test_bf16_trains`: the loss falls
    below half its start; master parameters and their gradients stay
    f32."""
    spec = ModelSpec(num_class=2, k=6, edge_filters=(16, 16), head_feat_dim=32, head_mlp=(32,),
                     compute_dtype="bfloat16")
    model = get_model("dgcnn", spec)
    params, state = model.init(3, torch.Generator().manual_seed(1))
    pts = np.random.RandomState(0).randn(1, 128, 3).astype(np.float32)
    labels = (pts[..., 0] > 0).astype(np.int64)
    pts[..., 1] += labels * 2.0
    x, y = torch.tensor(pts), torch.tensor(labels)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=1e-2)
    losses = []
    for _ in range(40):
        logits, state = model(params, state, x, train=True)
        state = tree_map(lambda t: t.detach(), state)
        loss = torch.nn.functional.cross_entropy(logits.reshape(-1, 2), y.reshape(-1))
        opt.zero_grad()
        loss.backward()
        assert all(t.grad.dtype == torch.float32 for t in leaves)
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.5, losses[::10]


class CountingKnn:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, x, k, mask):
        self.calls += 1
        return self.fn(x, k, mask)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["fused", "reduced", "edge"])
def test_remat_equals_no_remat(impl, dtype):
    """The same loss and gradients with and without remat, bit for bit,
    and the kNN function called once a block in both (remat saves the
    indices: backward does not build the graph again)."""
    pts, mask = _inputs(6)
    from dgcnn_tpu_torch.ops.knn import knn_indices

    out = {}
    for remat in (False, True):
        knn = CountingKnn(knn_indices)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # bf16 forces the edge form
            model = get_model("residual-dgcnn", ModelSpec(**SMALL, block_impl=impl,
                                                          compute_dtype=dtype, remat=remat),
                              knn_fn=knn)
        params, state = model.init(4, torch.Generator().manual_seed(2))
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        logits, new_state = model(params, state, torch.tensor(pts), torch.tensor(mask), train=True)
        loss = (logits * torch.tensor(_loss_weights(logits.shape))).sum()
        grads = torch.autograd.grad(loss, leaves)
        assert knn.calls == len(SMALL["edge_filters"])
        out[remat] = (loss.detach(), grads, tree_leaves(new_state))
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1] + tuple(out[False][2]), out[True][1] + tuple(out[True][2])):
        assert torch.equal(a, b)


DP_SMALL = dict(model_name="residual-dgcnn", num_class=2, kvalue=8, edge_filters=(16, 16),
                head_feat_dim=32, head_mlp=(32,), use_pallas=False, optimizer="sgd",
                learning_rate=1e-2, minibatch_size=4, num_point=128, num_devices=2)
DP_CASES = [dict(block_impl="edge"), dict(block_impl="fused"),
            dict(block_impl="edge", precision="bfloat16")]


@functools.lru_cache(maxsize=None)
def _dp_runs():
    """Every DP case with and without remat on 2 gloo ranks, one spawn."""
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO

    model = get_model("residual-dgcnn", Config(**DP_SMALL).model_spec())
    params, mstate = params_to_numpy(*model.init(4, torch.Generator().manual_seed(3)))
    io = SyntheticIO(num_events=12, num_point=100, seed=3, with_weights=True)
    io.initialize()
    batches = [(b.points, b.labels, b.weights, b.mask)
               for b in list(BucketBatcher(io, 4, buckets=(128,), shuffle=False).epoch())[:3]]
    cases = [dict(DP_SMALL, **c, remat=r) for c in DP_CASES for r in (False, True)]
    return run_ranks(torch_dp_ranks.train_cases, 2, device="cpu",
                     args=(cases, params, mstate, batches, batches[0]), timeout=300)


@pytest.mark.parametrize("case", range(len(DP_CASES)), ids=["edge", "fused", "edge_bf16"])
def test_remat_on_two_data_ranks_equals_no_remat(case):
    """On 2 gloo data ranks with sync BN the recompute issues each block's
    statistic all-reduce again, on every rank in the same order: no hang,
    and the same losses and parameters as without remat, on both ranks."""
    ranks = _dp_runs()
    for r in ranks:
        plain, remat = r["cases"][2 * case], r["cases"][2 * case + 1]
        for a, b in zip(plain["steps"], remat["steps"]):
            assert float(a["loss"]) == float(b["loss"])
        for a, b in zip(plain["params"] + plain["model_state"],
                        remat["params"] + remat["model_state"]):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
        # backward recomputed each block's BN statistics, all-reduce included:
        # one more forward collective a block, the rest as without remat
        got = {k: v for k, v in remat["steps"][0]["collectives"].items() if v}
        want = {k: v for k, v in plain["steps"][0]["collectives"].items() if v}
        want["psum_autograd"] += len(DP_SMALL["edge_filters"])
        assert got == want


TSMALL = dict(model_name="dgcnn", num_class=2, kvalue=6, edge_filters=(12, 16), head_feat_dim=24,
              head_mlp=(16,), minibatch_size=2, num_point=128, global_pool=False)


def _ring(n, k):
    return (np.arange(n)[:, None] + np.arange(k)[None]) % n


def _jax_ring(x, k, mask):
    idx = jnp.asarray(_ring(x.shape[-2], k), jnp.int32) + (x[..., :1] * 0).astype(jnp.int32)
    return idx, jnp.ones(idx.shape, bool)


@pytest.mark.parametrize("case", ["sgd", "adam", "residual_sgd"])
def test_bf16_remat_trainval_matches_jax(case):
    extra = {"sgd": dict(optimizer="sgd", learning_rate=0.05), "adam": dict(optimizer="adam"),
             "residual_sgd": dict(model_name="residual-dgcnn", global_pool=True, optimizer="sgd",
                                  learning_rate=0.05)}[case]
    kw = {**TSMALL, **extra, "precision": "bfloat16", "remat": True}
    jtv = JaxTrainval(JaxConfig(**kw, num_devices=1, use_pallas=False), knn_fn=_jax_ring)
    jstate = jtv.initialize(4, rng=jax.random.PRNGKey(7))
    tv = Trainval(Config(**kw), device="cpu", knn_fn=torch_dp_ranks.port_ring)
    assert tv.model.cdtype == torch.bfloat16 and tv.model.spec.remat
    state = tv.with_params(*params_from_numpy(_np(jstate.params), _np(jstate.model_state)))
    io = JaxSyntheticIO(num_events=10, num_point=128, seed=3, with_weights=True)
    io.initialize()
    for i, batch in enumerate(list(JaxBatcher(io, 2, buckets=(128,), shuffle=False).epoch())[:5]):
        jstate, jm = jtv.train_step(jstate, batch)
        state, m = tv.train_step(state, batch)
        want = float(jm["loss"])
        assert abs(float(m["loss"]) - want) <= 1e-2 * abs(want), (i, float(m["loss"]), want)
    want_leaves = jax.tree_util.tree_leaves(_np(jstate.params))
    floor = 2e-2 * max(float(np.abs(w).max()) for w in want_leaves)
    for g, w in zip(tree_leaves(state.params), want_leaves):
        assert g.dtype == torch.float32  # checkpoints keep f32 master parameters
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=floor)


def test_the_command_line_flags_build_and_train_on_the_cpu():
    """``train --precision bfloat16 --knn_precision default --remat`` builds
    a trainer on the CPU (the f32 oracle graph: the knob reaches the
    kernels only) that takes a step with a finite loss."""
    cfg = parse_args(["train", "--precision", "bfloat16", "--knn_precision", "default", "--remat",
                      "-mb", "1", "-np", "128", "-k", "6", "--edge_filters", "8", "8",
                      "--head_feat_dim", "16", "--head_mlp", "8"])
    tv = Trainval(cfg, device="cpu")
    assert tv.model.cdtype == torch.bfloat16 and tv.model.spec.remat
    state = tv.initialize(4)
    io = JaxSyntheticIO(num_events=1, num_point=128, seed=0)
    io.initialize()
    state, m = tv.train_step(state, next(JaxBatcher(io, 1, buckets=(128,)).epoch()))
    assert bool(torch.isfinite(m["loss"]))
    assert all(t.dtype == torch.float32 for t in tree_leaves(state.params))


def test_streamed_head_in_bf16_matches_the_dense_head():
    """The streamed head's eval half takes the compute dtype as the dense
    head does: in several chunks its bf16 logits equal the dense head's
    within one bf16 unit of the largest logit."""
    from dgcnn_tpu_torch.models import head as thead

    pts, mask = _inputs(7, n=200, nvalid=(200, 130))
    dense = get_model("residual-dgcnn", ModelSpec(**BF16))
    streamed = get_model("residual-dgcnn", ModelSpec(**BF16, head_stream="on"))
    params, state = dense.init(4, torch.Generator().manual_seed(4))
    old = thead.HEAD_CHUNK_TARGET_ELEMS
    thead.HEAD_CHUNK_TARGET_ELEMS = 64 * BF16["head_feat_dim"] * 2
    try:
        before = thead.runs
        b, _ = streamed(params, state, torch.tensor(pts), torch.tensor(mask))
        assert thead.runs == before + 1
    finally:
        thead.HEAD_CHUNK_TARGET_ELEMS = old
    a, _ = dense(params, state, torch.tensor(pts), torch.tensor(mask))
    m = torch.tensor(mask)
    assert b.dtype == torch.float32
    top = float(a[m].abs().max())
    np.testing.assert_allclose(b[m].numpy(), a[m].numpy(), rtol=0, atol=2.0**-7 * top)


def test_compute_dtype_must_be_known():
    with pytest.raises(ValueError, match="compute_dtype"):
        get_model("residual-dgcnn", ModelSpec(**SMALL, compute_dtype="float16"))
    assert mdgcnn.COMPUTE_DTYPES["bfloat16"] is torch.bfloat16


CP_SMALL = dict(model_name="residual-dgcnn", num_class=2, kvalue=6, edge_filters=(8, 12),
                head_feat_dim=16, head_mlp=(8,), minibatch_size=2, num_point=256,
                precision="bfloat16")


def test_cp_serving_in_bf16_matches_one_device():
    """Context parallelism in bf16 on 2 gloo ranks (bf16 features cross the
    ranks in the edge form's ring gather and in the pool's max, with no
    cast): every rank returns the same scores, those of the
    single-device bf16 model within 2^-6 (the ranks' matmuls and sums
    cover other rows than one device's, and bf16 keeps 8 bits); with
    ``knn_precision="default"`` the rdma ring builds the rounded graph,
    and the scores stay finite."""
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO
    from dgcnn_tpu_torch.parallel.launch import run_point_ranks
    from dgcnn_tpu_torch.train.trainval import TrainState

    import torch_cp_ranks

    model = get_model("residual-dgcnn", Config(**CP_SMALL).model_spec())
    params, mstate = params_to_numpy(*model.init(4, torch.Generator().manual_seed(5)))
    io = SyntheticIO(num_events=2, num_point=256, seed=6, with_weights=True)
    io.initialize()
    batch = next(iter(BucketBatcher(io, 2, buckets=(256,), shuffle=False).epoch()))
    configs = [dict(CP_SMALL, point_shards=2),
               dict(CP_SMALL, point_shards=2, ring_impl="rdma", knn_precision="default")]
    res = run_point_ranks(torch_cp_ranks.cp_inference, 2, device="cpu",
                          args=(configs, params, mstate,
                                (batch.points, batch.labels, batch.weights, batch.mask)),
                          timeout=300)
    tv = Trainval(Config(**CP_SMALL), device="cpu")
    scores, pred, _ = tv.inference(TrainState(*params_from_numpy(params, mstate)), batch)
    m = batch.mask
    for i in range(len(configs)):
        first = res[0]["runs"][i]
        assert np.isfinite(first["scores"]).all()
        np.testing.assert_array_equal(res[1]["runs"][i]["scores"], first["scores"])
    np.testing.assert_allclose(res[0]["runs"][0]["scores"][m], scores.numpy()[m], rtol=0,
                               atol=2.0**-6)
