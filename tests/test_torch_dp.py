"""The port's data parallelism against the JAX package's, on CPU gloo ranks.

DP-2 and DP-4 (`dgcnn_tpu_torch.parallel.launch.run_ranks`, one spawn a
rank count, every case in it; the rank functions are in
`tests/torch_dp_ranks.py`) against the JAX `Trainval` on ``make_mesh(2|4)``
from one bridged init with mixed-sign BN scales, on the same batches, 3
SGD steps at dropout 0, the graph pinned to a ring on both sides: the
loss within 1e-5 relative at every step and the parameters and BN state
within 1e-5 absolute after them (the JAX DP test's tolerances,
tests/test_trainval.py), for the edge and the fused block (whose
`GatheredStats` backward must stay local: a merge inside it would count
the other ranks' cotangents twice), the depth-2 ``fused_mlp`` block (its
two Functions' backwards local in the same way), sync BN on and off, and
one clipped case. Every rank holds the same parameters. DP eval and
`inference_packed` against DP-1 and the JAX eval; the count of
collectives a step; the JAX minibatch message.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks
from dgcnn_tpu.config import Config as JaxConfig
from dgcnn_tpu.io.batching import BucketBatcher as JaxBatcher
from dgcnn_tpu.io.synthetic import SyntheticIO as JaxSyntheticIO
from dgcnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dgcnn_tpu.train.trainval import Trainval as JaxTrainval
from dgcnn_tpu_torch.bridge import params_from_numpy
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.parallel.launch import run_ranks
from dgcnn_tpu_torch.parallel.mesh import RankGroup
from dgcnn_tpu_torch.train.trainval import Trainval

SMALL = dict(model_name="residual-dgcnn", num_class=2, kvalue=8, edge_filters=(16, 16),
             head_feat_dim=32, head_mlp=(32,), use_pallas=False, precision="highest",
             optimizer="sgd", learning_rate=1e-2, minibatch_size=4, num_point=128)
CASES = {
    "edge_sync": dict(block_impl="edge"),
    "fused_sync": dict(block_impl="fused"),
    "edge_nosync": dict(block_impl="edge", bn_sync=False),
    "fused_nosync": dict(block_impl="fused", bn_sync=False),
    "fused_sync_clip": dict(block_impl="fused", grad_clip=0.05),
    # blocks of MLP depth 2: fused_mlp in the port, the edge form in JAX
    "fused_mlp_sync": dict(block_impl="fused", block_convs=2),
}
NAMES = sorted(CASES)


def _depth(case):
    return CASES[case].get("block_convs", 1)


def _bn_layers(case):
    """Train-mode BN layers of SMALL under ``case``: 2 blocks of one BN a
    conv, the head's feature conv, 1 MLP layer."""
    return 2 * _depth(case) + 2


def _jax_ring(x, k, mask):
    idx = jnp.asarray(torch_dp_ranks.ring(x.shape[-2], k), jnp.int32) + (
        x[..., :1] * 0).astype(jnp.int32)
    return idx, jnp.ones(idx.shape, bool)


def _batches(n, seed):
    io = JaxSyntheticIO(num_events=4 * n, num_point=100, seed=seed, with_weights=True)
    io.initialize()
    out = list(JaxBatcher(io, 4, buckets=(128,), shuffle=False).epoch())[:n]
    assert all(b.mask.sum() < b.mask.size for b in out)  # padded events
    return out


def _tup(b):
    return (b.points, b.labels, b.weights, b.mask)


def _mixed(tree, rng):
    """The JAX tree as numpy, with mixed-sign BN scales and non-trivial
    running statistics (both branches of the reduced block's max/min)."""
    tree = jax.tree_util.tree_map(np.asarray, tree)

    def walk(node):
        if isinstance(node, dict):
            if "scale" in node:
                d = node["scale"].shape[0]
                node["scale"] = (rng.uniform(0.3, 1.5, d) * rng.choice([-1.0, 1.0], d)).astype(np.float32)
                node["bias"] = (rng.randn(d) * 0.2).astype(np.float32)
            if "mean" in node:
                d = node["mean"].shape[0]
                node["mean"] = (rng.randn(d) * 0.3).astype(np.float32)
                node["var"] = rng.uniform(0.5, 2.0, d).astype(np.float32)
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
        return node

    return walk(tree)


@functools.lru_cache(maxsize=None)
def _init(depth=1):
    """The bridged init of SMALL with blocks of MLP depth ``depth``."""
    jstate = JaxTrainval(JaxConfig(**SMALL, block_convs=depth),
                         mesh=jax_make_mesh(1)).initialize(4)
    rng = np.random.RandomState(5)
    return _mixed(jstate.params, rng), _mixed(jstate.model_state, rng)


@functools.lru_cache(maxsize=None)
def _jax(n, case):
    """The JAX run of ``case`` on ``make_mesh(n)``: step metrics, final
    params and state as numpy, and the packed eval of the trained state."""
    params, mstate = _init(_depth(case))
    jtv = JaxTrainval(JaxConfig(**SMALL, **CASES[case], num_devices=n), mesh=jax_make_mesh(n),
                      knn_fn=_jax_ring)
    js = jtv.initialize(4)
    js = jax.device_put(js._replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                                    model_state=jax.tree_util.tree_map(jnp.asarray, mstate)),
                        jtv._repl_sharding)
    steps = []
    for b in _batches(3, seed=3):
        js, m = jtv.train_step(js, b)
        steps.append({k: np.asarray(v) for k, v in m.items()})
    packed, metrics = jtv.inference_packed(js, _batches(1, seed=8)[0])
    leaves = lambda t: [np.asarray(a) for a in jax.tree_util.tree_leaves(t)]  # noqa: E731
    return {"steps": steps, "params": leaves(js.params), "model_state": leaves(js.model_state),
            "packed": np.asarray(packed), "metrics": {k: np.asarray(v) for k, v in metrics.items()}}


@functools.lru_cache(maxsize=None)
def _port(n, depth=1):
    """Every case of blocks of MLP depth ``depth`` on ``n`` gloo ranks, in
    one spawn; the results by rank."""
    params, mstate = _init(depth)
    names = [c for c in NAMES if _depth(c) == depth]
    cases = [dict(SMALL, **CASES[c], num_devices=n) for c in names]
    res = run_ranks(torch_dp_ranks.train_cases, n, device="cpu",
                    args=(cases, params, mstate, [_tup(b) for b in _batches(3, seed=3)],
                          _tup(_batches(1, seed=8)[0])), timeout=300)
    return [{name: r["cases"][i] for i, name in enumerate(names)} for r in res], \
        [r["imports"] for r in res]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", NAMES)
def test_dp_train_steps_match_jax(n, case):
    ranks, imports = _port(n, _depth(case))
    want = _jax(n, case)
    assert all(imp == {"jax": False, "dgcnn_tpu": False} for imp in imports)
    got = ranks[0][case]
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        assert abs(float(g["loss"]) - float(w["loss"])) <= 1e-5 * abs(float(w["loss"])), (i, g, w)
        np.testing.assert_allclose(g["acc"], w["acc"], atol=1e-6)
        np.testing.assert_allclose(g["class_acc"], w["class_acc"], atol=1e-6)
    for sub in ("params", "model_state"):
        assert len(got[sub]) == len(want[sub])
        for a, b in zip(got[sub], want[sub]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    # the parameters are replicated: every rank holds rank 0's, bit for bit
    for r in ranks[1:]:
        for sub in ("params", "model_state"):
            for a, b in zip(r[case][sub], got[sub]):
                np.testing.assert_array_equal(a, b)
        assert [float(s["loss"]) for s in r[case]["steps"]] == [
            float(s["loss"]) for s in got["steps"]]


@pytest.mark.parametrize("n", [2, 4])
def test_dp_collectives_a_step(n):
    """Sync BN: one collective forward and one backward a BN layer; one
    gradient all-reduce; the loss and the metric counts in one psum
    each. Without sync BN: no BN collective, and one more psum for the
    running statistics."""
    for case in NAMES:
        ranks, _ = _port(n, _depth(case))
        sync = {"psum_autograd": _bn_layers(case), "psum_autograd_backward": _bn_layers(case),
                "grads": 1, "psum": 2}
        want = sync if CASES[case].get("bn_sync", True) else {"grads": 1, "psum": 3}
        for r in ranks:
            for s in r[case]["steps"]:
                assert {k: v for k, v in s["collectives"].items() if v} == want, (case, s)


@pytest.mark.parametrize("n", [2, 4])
def test_dp_eval_matches_jax_and_dp1(n):
    """The packed output is gathered on every rank and equals the JAX
    eval of the same trained state and the one-process port's eval of
    rank 0's trained state; the metrics are summed over the ranks."""
    ranks, _ = _port(n)
    eval_batch = _batches(1, seed=8)[0]
    for case in ("edge_sync", "fused_nosync"):
        got = ranks[0][case]
        want = _jax(n, case)
        np.testing.assert_allclose(got["packed"], want["packed"], rtol=0, atol=1e-5)
        for k in ("loss", "loss_weight", "confusion"):
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-5)
            np.testing.assert_allclose(got["evaluate"][k], got["metrics"][k], rtol=1e-6)
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[case]["packed"], got["packed"])
        # DP-1: the one-process trainer on rank 0's trained state
        tv = Trainval(Config(**SMALL, **CASES[case]), device="cpu",
                      knn_fn=torch_dp_ranks.port_ring)
        state = tv.with_params(*params_from_numpy(*_init()))
        state = state._replace(
            params=_unflatten(state.params, got["params"]),
            model_state=_unflatten(state.model_state, got["model_state"]))
        packed, metrics = tv.inference_packed(state, eval_batch)
        np.testing.assert_allclose(got["packed"], packed.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["metrics"]["confusion"], metrics["confusion"].numpy())
        np.testing.assert_allclose(got["metrics"]["loss"], metrics["loss"].numpy(), rtol=1e-6)


def _unflatten(tree, leaves):
    from dgcnn_tpu_torch.bridge import tree_unflatten

    return tree_unflatten(tree, [torch.as_tensor(a) for a in leaves])


def _fake_group(data_size):
    """A rank's group as `Trainval` reads it, without a process group."""
    return RankGroup(rank=0, size=1, device=torch.device("cpu"), backend="gloo",
                     stage_host=False, data_rank=0, data_size=data_size)


def test_minibatch_not_divisible_raises_like_jax():
    kw = dict(SMALL, minibatch_size=3, num_devices=2)
    with pytest.raises(ValueError) as want:
        JaxTrainval(JaxConfig(**kw), mesh=jax_make_mesh(2))
    with pytest.raises(ValueError) as got:
        Trainval(Config(**kw), device="cpu", group=_fake_group(2))
    assert str(got.value) == str(want.value)


def test_trainval_checks_the_group_against_num_devices():
    with pytest.raises(ValueError, match="RankGroup"):
        Trainval(Config(**SMALL, num_devices=2), device="cpu")
    with pytest.raises(ValueError, match="RankGroup"):
        Trainval(Config(**SMALL, num_devices=4), device="cpu", group=_fake_group(2))
    assert Trainval(Config(**SMALL), device="cpu", group=_fake_group(2)).data_size == 2
