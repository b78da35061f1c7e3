"""Banded context parallelism of the port (ROADMAP item 13, piece 1:
serving) against the JAX package and the port's own single device, on the
CPU.

The port's ranks run on gloo (`dgcnn_tpu_torch.parallel.launch.
run_point_ranks`, through `tests/torch_banded_cp_ranks.py`, which imports
no JAX), spawned once per rank count for every case. Contract
(`dgcnn_tpu_torch/kernels/halo_knn.py`): with the event sorted as a
whole and cut into contiguous bands, `halo_knn`'s valid query rows are
the single-device banded graph (`ops.knn.banded_knn_indices`, and the JAX
package's) index for index, its padded rows self-edges with ``valid``
False; the whole model served over the ranks gives the single-device
banded model's predictions, its scores within 1e-5, in the caller's
point order.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import torch_banded_cp_ranks
from dgcnn_tpu.config import Config as JaxConfig
from dgcnn_tpu.io.batching import BucketBatcher as JaxBatcher
from dgcnn_tpu.io.synthetic import SyntheticIO as JaxSyntheticIO
from dgcnn_tpu.ops.knn import banded_knn_indices as jax_banded
from dgcnn_tpu.parallel.mesh import make_mesh
from dgcnn_tpu.train.trainval import Trainval as JaxTrainval
from dgcnn_tpu_torch.bridge import params_from_numpy
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.kernels import halo_knn as thalo
from dgcnn_tpu_torch.ops.edge import gather_neighbors
from dgcnn_tpu_torch.ops.knn import banded_knn_indices
from dgcnn_tpu_torch.ops.sfc import morton_order
from dgcnn_tpu_torch.parallel.context_parallel import banded_cp_graph_ops
from dgcnn_tpu_torch.parallel.launch import run_point_ranks
from dgcnn_tpu_torch.parallel.mesh import PointGroup
from dgcnn_tpu_torch.train.trainval import Trainval, TrainState
from test_torch_cp import _numpy_tree

SMALL = dict(
    model_name="residual-dgcnn", num_class=2, kvalue=8, edge_filters=(16, 16),
    head_feat_dim=32, head_mlp=(16,), minibatch_size=2, num_point=512, knn_window=64,
)
# the port's configurations run on the ranks, by name
PORT_RUNS = {
    "banded": {},
    "banded_edge": dict(block_impl="edge"),
    "banded_streamed_head": dict(head_stream="on"),
}


def _sorted_event(b, n, c, nvalid=None, seed=0):
    """A random batch in the sorted layout: padded rows, if any, last."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, c).astype(np.float32)
    if nvalid is None:
        return x, np.ones((b, n), bool)
    return x, np.arange(n)[None, :] < np.asarray(nvalid)[:, None]


def _morton_sorted(seed=4):
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.rand(2, 512, 4).astype(np.float32) * 100)
    mask = torch.tensor(np.arange(512)[None, :] < np.array([512, 410])[:, None])
    order, _ = morton_order(x, mask)
    return (torch.gather(x, 1, order[..., None].expand(x.shape)).numpy(),
            torch.gather(mask, 1, order).numpy())


# name -> (x, mask, k, window by rank count)
KNN_CASES = {
    "random": (*_sorted_event(2, 512, 8), 16, {2: 128, 4: 64}),
    "masked_boundary_mid_shard": (*_sorted_event(3, 512, 6, [300, 512, 70], seed=1), 12,
                                  {2: 64, 4: 64}),
    "window_equals_shard": (*_sorted_event(1, 256, 4, [200], seed=2), 8, {2: 128, 4: 64}),
    "fewer_than_k_valid": (*_sorted_event(1, 256, 4, [5], seed=3), 8, {2: 32, 4: 32}),
    "all_padded_shard": (*_sorted_event(2, 512, 6, [512, 40], seed=11), 8, {2: 64, 4: 64}),
    "after_morton_sort": (*_morton_sorted(), 16, {2: 128, 4: 128}),
}
GATHER_WINDOW, GATHER_K = 64, 12


def _gather_case():
    x, mask = _sorted_event(2, 512, 8, [512, 300], seed=5)
    idx, _ = banded_knn_indices(torch.tensor(x), GATHER_K, torch.tensor(mask),
                                window=GATHER_WINDOW)
    values = np.random.RandomState(6).randn(2, 512, 16).astype(np.float32)
    return values, idx.numpy(), mask


@functools.lru_cache(maxsize=None)
def _setup(p):
    """Every case on p ranks in one spawn, the JAX single-device banded
    inference and the bridged state."""
    jtv = JaxTrainval(JaxConfig(use_pallas=False, **SMALL), mesh=make_mesh(1))
    jstate = jtv.initialize(4)
    rng = np.random.RandomState(30 + p)
    params = _numpy_tree(jstate.params, rng)
    mstate = _numpy_tree(jstate.model_state, rng)
    jstate = jstate._replace(params=jax.tree_util.tree_map(jax.numpy.asarray, params),
                             model_state=jax.tree_util.tree_map(jax.numpy.asarray, mstate))
    io = JaxSyntheticIO(num_events=2, num_point=450, seed=17 + p, with_weights=True,
                        variable_length=True)
    io.initialize()
    batch = next(iter(JaxBatcher(io, 2, num_point=512, shuffle=False).epoch()))
    assert batch.mask.sum() < batch.mask.size  # genuinely padded
    jax_out = jtv.inference(jstate, batch)
    tup = (batch.points, batch.labels, batch.weights, batch.mask)
    knn_cases = [(x, m, k, w[p]) for x, m, k, w in KNN_CASES.values()]
    values, idx, _ = _gather_case()
    configs = [dict(SMALL, point_shards=p, **kw) for kw in PORT_RUNS.values()]
    res = run_point_ranks(torch_banded_cp_ranks.banded_cp, p, device="cpu",
                          args=(knn_cases, (values, idx, GATHER_WINDOW), configs, params, mstate,
                                tup), timeout=300)
    return batch, params, mstate, jax_out, res


def _whole(res, key, i=None):
    """The ranks' bands of a result put back along the point axis."""
    parts = [r[key] if i is None else r[key][i] for r in res]
    if isinstance(parts[0], tuple):
        return tuple(np.concatenate([np.asarray(p[j]) for p in parts], axis=1)
                     for j in range(len(parts[0])))
    return np.concatenate([np.asarray(p) for p in parts], axis=1)


@pytest.mark.parametrize("case", sorted(KNN_CASES))
@pytest.mark.parametrize("p", [2, 4])
def test_halo_knn_matches_banded_oracle(p, case):
    """Valid query rows: the port's and the JAX package's single-device
    banded graph, index and flag for index and flag; padded query rows:
    self-edges, flagged invalid."""
    x, mask, k, windows = KNN_CASES[case]
    w = windows[p]
    res = _setup(p)[-1]
    i = list(KNN_CASES).index(case)
    got_idx, got_valid = _whole(res, "knn", i)
    want_idx, want_valid = banded_knn_indices(torch.tensor(x), k, torch.tensor(mask), window=w)
    jidx, jvalid = jax_banded(x, k, mask, window=w, precision=jax.lax.Precision.HIGHEST)
    for wi, wv in ((want_idx.numpy(), want_valid.numpy()), (np.asarray(jidx), np.asarray(jvalid))):
        np.testing.assert_array_equal(got_idx[mask], wi[mask])
        np.testing.assert_array_equal(got_valid[mask], wv[mask])
    n = x.shape[1]
    self_idx = np.broadcast_to(np.arange(n)[None, :, None], got_idx.shape)
    np.testing.assert_array_equal(got_idx[~mask], self_idx[~mask])
    assert not got_valid[~mask].any()
    assert got_idx.dtype == np.int32


def test_halo_knn_window_too_large_raises():
    solo = PointGroup(rank=0, size=1, device=torch.device("cpu"), backend="gloo",
                      stage_host=False)
    x = torch.randn(1, 32, 4)
    with pytest.raises(ValueError, match="local shard size"):
        thalo.halo_knn(x, 8, window=64, group=solo)
    with pytest.raises(ValueError, match="k=40 > knn_window=32"):
        thalo.halo_knn(x, 40, window=32, group=solo)


@pytest.mark.parametrize("p", [2, 4])
def test_halo_gather_matches_local_gather(p):
    res = _setup(p)[-1]
    values, idx, mask = _gather_case()
    got = _whole(res, "gather")
    want = gather_neighbors(torch.tensor(values), torch.tensor(idx)).numpy()
    np.testing.assert_array_equal(got[mask], want[mask])


@pytest.mark.parametrize("p", [2, 4])
def test_banded_cp_inference_matches_single_device_and_jax(p):
    """Served over p ranks, every configuration gives the single-device
    banded `Trainval.inference` (the port's and the JAX package's, on the
    same bridged weights) predictions and scores within 1e-5 on the valid
    points, and the same confusion matrix, in the caller's point order,
    on every rank."""
    batch, params, mstate, (sc_j, pr_j, m_j), res = _setup(p)
    tv = Trainval(Config(**SMALL), device="cpu")
    sc, pr, m = tv.inference(TrainState(*params_from_numpy(params, mstate)), batch)
    v = batch.mask  # padded rows are self-edges here, garbage there
    for i, name in enumerate(PORT_RUNS):
        for r in res:
            got = r["runs"][i]
            for want_sc, want_pr, want_cm in ((sc.numpy(), pr.numpy(), m["confusion"].numpy()),
                                              (np.asarray(sc_j), np.asarray(pr_j),
                                               np.asarray(m_j["confusion"]))):
                np.testing.assert_allclose(got["scores"][v], want_sc[v], atol=1e-5, rtol=0,
                                           err_msg=name)
                np.testing.assert_array_equal(got["pred"][v], want_pr[v], err_msg=name)
                np.testing.assert_array_equal(got["metrics"]["confusion"], want_cm, err_msg=name)
            np.testing.assert_allclose(got["metrics"]["loss"], float(m_j["loss"]), rtol=1e-5)


@pytest.mark.parametrize("p", [2, 4])
def test_banded_cp_auto_resolves_fused_and_imports_no_jax(p):
    """With the halo decomposition (``extend``/``localize``) the auto block
    form is ``fused``, as in the JAX package; the streamed head serves
    over the ranks; no rank imports JAX."""
    res = _setup(p)[-1]
    for r in res:
        assert not any(r["imports"].values())
        runs = dict(zip(PORT_RUNS, r["runs"]))
        assert runs["banded"]["block_impl"] == "fused"
        assert runs["banded_edge"]["block_impl"] == "edge"
        assert runs["banded_streamed_head"]["streamed_head"] == 1
        assert runs["banded"]["streamed_head"] == 0


def test_banded_cp_graph_ops_honor_no_pallas(monkeypatch):
    """``use_kernel`` (the ``--no_pallas`` knob) reaches `halo_knn`."""
    seen = {}
    real = thalo.halo_knn

    def spy(x, k, mask=None, **kw):
        seen.update(kw)
        return real(x, k, mask, **kw)

    monkeypatch.setattr(thalo, "halo_knn", spy)
    solo = PointGroup(rank=0, size=1, device=torch.device("cpu"), backend="gloo",
                      stage_host=False)
    ops = banded_cp_graph_ops(solo, window=32, use_kernel=False, knn_precision="default")
    x = torch.randn(1, 128, 4, generator=torch.Generator().manual_seed(0))
    idx, valid = ops.knn(x, 8, None)
    assert seen["use_kernel"] is False and seen["precision"] == "default"
    # one rank: the halo wraps onto itself and the graph is the banded one
    want, _ = banded_knn_indices(x, 8, window=32)
    assert torch.equal(idx, want) and bool(valid.all())
    values = torch.randn(1, 128, 5)
    assert torch.equal(ops.gather(values, idx), gather_neighbors(values, idx))
    assert torch.equal(gather_neighbors(ops.extend(values), ops.localize(idx)),
                       gather_neighbors(values, idx))


def test_config_rejects_window_wider_than_shard():
    with pytest.raises(ValueError, match="points per shard"):
        Config(**{**SMALL, "point_shards": 8, "num_point": 256, "knn_window": 64})


def test_config_rejects_rdma_with_banded_cp():
    with pytest.raises(ValueError, match="halos"):
        Config(**{**SMALL, "point_shards": 4, "num_point": 256, "ring_impl": "rdma"})


def test_config_validates_padded_sizes_not_raw():
    """The padded sizes the batcher makes, not the raw ones: raw 200 pads
    to 256 (a shard of 128 holds a window of 128); raw 192 divides by 6
    but 256 does not."""
    Config(**{**SMALL, "point_shards": 2, "num_point": 200, "knn_window": 128}).validate()
    with pytest.raises(ValueError, match="not divisible"):
        Config(**{**SMALL, "point_shards": 6, "num_point": 192, "knn_window": 32})
