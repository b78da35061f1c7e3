"""Context-parallel serving of the port against the JAX package on the
CPU, and the port's CP checks.

The port's `Trainval` with ``point_shards = P`` runs on P gloo ranks
(`dgcnn_tpu_torch.parallel.launch.run_point_ranks`, through
`tests/torch_cp_ranks.py`, which imports no JAX) with ``ring_impl="rdma"``
(its plain merge on the CPU). The JAX side is `Trainval(point_shards=P)`
with ``ring_impl="ppermute"`` on ``make_mesh(P, num_point_shards=P)``,
with the same bridged state on a padded `BucketBatcher` batch, as
`tests/test_context_parallel.py` runs it.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import torch_cp_ranks
from dgcnn_tpu.config import Config as JaxConfig
from dgcnn_tpu.io.batching import BucketBatcher as JaxBatcher
from dgcnn_tpu.io.synthetic import SyntheticIO as JaxSyntheticIO
from dgcnn_tpu.parallel.mesh import make_mesh
from dgcnn_tpu.train.trainval import Trainval as JaxTrainval
from dgcnn_tpu_torch.bridge import params_from_numpy
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.models.dgcnn import ModelSpec, make_model
from dgcnn_tpu_torch.parallel.context_parallel import cp_graph_ops
from dgcnn_tpu_torch.parallel.launch import run_point_ranks
from dgcnn_tpu_torch.parallel.mesh import PointGroup
from dgcnn_tpu_torch.train.trainval import Trainval, TrainState

SMALL = dict(
    model_name="residual-dgcnn", num_class=2, kvalue=8, edge_filters=(16, 16),
    head_feat_dim=32, head_mlp=(16,), minibatch_size=2,
)
# the port's configurations run on the ranks, by name
PORT_RUNS = {
    "rdma": dict(ring_impl="rdma"),
    "ppermute": dict(ring_impl="ppermute"),
    "rdma_edge": dict(ring_impl="rdma", block_impl="edge"),
    "rdma_reduced": dict(ring_impl="rdma", block_impl="reduced"),
    "rdma_streamed_head": dict(ring_impl="rdma", head_stream="on"),
}


def _numpy_tree(tree, rng):
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
def _setup(p):
    """JAX CP inference on a padded batch and the port's runs on p ranks,
    from one bridged state."""
    jtv = JaxTrainval(JaxConfig(point_shards=p, ring_impl="ppermute", use_pallas=False, **SMALL),
                      mesh=make_mesh(p, num_point_shards=p))
    jstate = jtv.initialize(4)
    rng = np.random.RandomState(p)
    params = _numpy_tree(jstate.params, rng)
    mstate = _numpy_tree(jstate.model_state, rng)
    jstate = jstate._replace(
        params=jax.tree_util.tree_map(jax.numpy.asarray, params),
        model_state=jax.tree_util.tree_map(jax.numpy.asarray, mstate),
    )
    io = JaxSyntheticIO(num_events=2, num_point=200, seed=11 + p, with_weights=True)
    io.initialize()
    batch = next(iter(JaxBatcher(io, 2, buckets=(256,), shuffle=False).epoch()))
    assert batch.mask.sum() < batch.mask.size  # genuinely padded
    jax_out = jtv.inference(jax.device_put(jstate, jtv._repl_sharding), batch)
    tup = (batch.points, batch.labels, batch.weights, batch.mask)
    configs = [dict(SMALL, point_shards=p, **kw) for kw in PORT_RUNS.values()]
    res = run_point_ranks(torch_cp_ranks.cp_inference, p, device="cpu",
                          args=(configs, params, mstate, tup), timeout=300)
    port = {name: [r["runs"][i] for r in res] for i, name in enumerate(PORT_RUNS)}
    return batch, params, mstate, jax_out, port, [r["imports"] for r in res]


@pytest.mark.parametrize("p", [2, 4])
def test_cp_inference_matches_jax(p):
    """Scores within 1e-4, equal predictions and an exact confusion
    matrix against the JAX trainer under the same point sharding."""
    batch, _, _, (sc_j, pr_j, m_j), port, _ = _setup(p)
    got = port["rdma"][0]
    assert got["block_impl"] == "fused"  # auto: the ring gather decomposes
    np.testing.assert_allclose(got["scores"], np.asarray(sc_j), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got["pred"], np.asarray(pr_j))
    np.testing.assert_array_equal(got["metrics"]["confusion"], np.asarray(m_j["confusion"]))
    np.testing.assert_allclose(got["metrics"]["loss"], float(m_j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["metrics"]["loss_weight"], float(m_j["loss_weight"]), rtol=1e-6)
    assert float(got["metrics"]["confusion"].sum()) == batch.mask.sum()


@pytest.mark.parametrize("p", [2, 4])
def test_cp_inference_matches_single_device(p):
    """The same state and batch through the port's own single-device
    trainer on the CPU."""
    batch, params, mstate, _, port, _ = _setup(p)
    tv = Trainval(Config(**SMALL), device="cpu")
    sc, pr, m = tv.inference(TrainState(*params_from_numpy(params, mstate)), batch)
    got = port["rdma"][0]
    np.testing.assert_allclose(got["scores"], sc.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got["pred"], pr.numpy())
    np.testing.assert_array_equal(got["metrics"]["confusion"], m["confusion"].numpy())


@pytest.mark.parametrize("p", [2, 4])
def test_cp_every_rank_returns_the_whole_batch(p):
    batch, _, _, _, port, imports = _setup(p)
    assert all(not any(imp.values()) for imp in imports)
    for runs in port.values():
        first = runs[0]
        assert first["scores"].shape == batch.labels.shape + (2,)
        for other in runs[1:]:
            np.testing.assert_array_equal(other["scores"], first["scores"])
            np.testing.assert_array_equal(other["pred"], first["pred"])
            np.testing.assert_array_equal(other["metrics"]["confusion"], first["metrics"]["confusion"])


@pytest.mark.parametrize("p", [2, 4])
def test_cp_block_forms_and_ring_impls_agree(p):
    """``edge`` and ``reduced`` (the ring gather) give the fused form's
    eval scores bit for bit on the valid points; ``ppermute`` gives the
    ``rdma`` predictions; the streamed head (pool over the ranks on a
    (B, 1, C) partial) gives the dense head's scores."""
    batch, _, _, _, port, _ = _setup(p)
    m = batch.mask
    fused = port["rdma"][0]
    for name, impl in (("rdma_edge", "edge"), ("rdma_reduced", "reduced")):
        assert port[name][0]["block_impl"] == impl
        np.testing.assert_array_equal(port[name][0]["scores"][m], fused["scores"][m])
    np.testing.assert_allclose(port["ppermute"][0]["scores"], fused["scores"], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(port["ppermute"][0]["pred"], fused["pred"])
    streamed = port["rdma_streamed_head"][0]
    assert streamed["streamed_head"] == 1 and fused["streamed_head"] == 0
    np.testing.assert_allclose(streamed["scores"], fused["scores"], atol=2e-5, rtol=0)
    np.testing.assert_array_equal(streamed["metrics"]["confusion"], fused["metrics"]["confusion"])


@pytest.mark.parametrize("kw,err,match", [
    (dict(point_shards=0), ValueError, "point_shards must be >= 1"),
    (dict(point_shards=3, num_point=256), ValueError, "not divisible by point_shards=3"),
    (dict(point_shards=4, num_point=64, kvalue=40), ValueError, "exceeds the local shard size"),
    (dict(ring_impl="bogus"), ValueError, "ring_impl must be one of"),
    (dict(point_shards=2, knn_window=64), NotImplementedError, "item 13"),
    (dict(point_shards=2, num_devices=4), NotImplementedError, "item 13"),
    (dict(point_shards=2, num_devices=3), ValueError, "3 devices not divisible by"),
])
def test_config_checks(kw, err, match):
    with pytest.raises(err, match=match):
        Config(**kw)


def test_config_builds_a_data_axis():
    """``num_devices=2`` is two data ranks; with ``point_shards`` equal to
    it, one data replica of point shards."""
    from dgcnn_tpu_torch.parallel.mesh import make_mesh

    assert Config(num_devices=2).num_devices == 2
    assert make_mesh(2, 1) == {"data": 2, "points": 1}
    assert make_mesh(4, 4) == {"data": 1, "points": 4}
    assert make_mesh(0, 2, device="cpu") == {"data": 1, "points": 2}


def test_config_checks_match_jax_where_it_has_them():
    with pytest.raises(ValueError, match="point_shards must be >= 1"):
        JaxConfig(point_shards=0).validate()
    with pytest.raises(ValueError, match="ring_impl must be one of"):
        JaxConfig(ring_impl="bogus").validate()
    assert Config(point_shards=4, num_point=200, kvalue=20).point_shards == 4  # 256 / 4 = 64


def test_cp_needs_a_group_and_known_impl():
    with pytest.raises(ValueError, match="PointGroup"):
        Trainval(Config(point_shards=2, **SMALL), device="cpu")
    solo = PointGroup(rank=0, size=1, device=torch.device("cpu"), backend="gloo",
                      stage_host=False)
    with pytest.raises(ValueError, match="unknown ring impl"):
        cp_graph_ops(solo, impl="bogus")
    with pytest.raises(NotImplementedError, match="item 10"):
        cp_graph_ops(solo, impl="rdma", knn_precision="default")
    ops = cp_graph_ops(solo, impl="rdma")
    with pytest.raises(NotImplementedError, match="item 13"):
        make_model(ModelSpec(knn_window=64), knn_fn=ops.knn, gather_fn=ops.gather,
                   pool_fn=ops.pool)


def test_run_point_ranks_raises_when_a_rank_raises():
    """A rank that raises ends the call with its traceback while the
    others wait on a collective it never joins: no hang."""
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 3 raised.*fails on purpose"):
        run_point_ranks(torch_cp_ranks.raise_on_rank, 3, device="cpu", args=(1,), timeout=120)


def test_one_shard_group_is_the_single_device_model():
    """With a group of one, the CP ops reduce to the local ones: the
    model with them gives the plain model's logits bit for bit."""
    solo = PointGroup(rank=0, size=1, device=torch.device("cpu"), backend="gloo",
                      stage_host=False)
    spec = ModelSpec(k=6, edge_filters=(8, 8), residual=True, head_feat_dim=16, head_mlp=(8,))
    ops = cp_graph_ops(solo, impl="ppermute")
    cp = make_model(spec, knn_fn=ops.knn, gather_fn=ops.gather, pool_fn=ops.pool,
                    gather_extend_fn=ops.extend, gather_localize_fn=ops.localize)
    plain = make_model(spec)
    params, state = plain.init(3, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    pts = torch.tensor(rng.randn(2, 96, 3).astype(np.float32))
    mask = torch.tensor(np.arange(96)[None] < np.array([[96], [40]]))
    a, _ = cp(params, state, pts, mask)
    b, _ = plain(params, state, pts, mask)
    np.testing.assert_array_equal(a.numpy()[mask.numpy()], b.numpy()[mask.numpy()])
