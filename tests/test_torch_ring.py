"""The port's ring kNN, ring gather and cross-shard pool against the JAX
package on the CPU.

The port side runs in P ranks spawned by
`dgcnn_tpu_torch.parallel.launch.run_point_ranks` (gloo), through the
rank functions of `tests/torch_cp_ranks.py`, which import no JAX. The JAX
side runs here, on conftest's virtual CPU devices: `ring_knn_rdma` in
interpret mode under a single-axis ``shard_map`` with ``check_vma=False``
(as `tests/test_ring_rdma.py` runs it), `ring_knn`, `ring_gather` and
`cp_masked_max_pool`. Inputs come from numpy seeds.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_cp_ranks
from dgcnn_tpu.kernels.ring_knn import ring_gather as jax_ring_gather
from dgcnn_tpu.kernels.ring_knn import ring_knn as jax_ring_knn
from dgcnn_tpu.kernels.ring_knn_rdma import ring_knn_rdma
from dgcnn_tpu.parallel.context_parallel import cp_masked_max_pool as jax_pool
from dgcnn_tpu_torch.kernels import ring_knn_cuda as rmod
from dgcnn_tpu_torch.kernels.knn_cuda import build_augmented_operands, knn_plain
from dgcnn_tpu_torch.ops.knn import split_mismatches
from dgcnn_tpu_torch.parallel.launch import run_point_ranks


def _event(b, n, c=3, seed=0, dup=True, masked=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    if dup:  # exact duplicates in different shards: ties across blocks
        x[:, n // 2] = x[:, 1]
        x[:, n - 3] = x[:, 1]
        x[:, n // 4 + 1] = x[:, 1]
    mask = np.ones((b, n), bool)
    if masked:
        mask[:, -masked:] = False
    return x, mask


def _cases(p):
    """(name, x, mask, k): masks and duplicates across shards; k == N/P;
    5 valid points with k = 16 (and an event with none)."""
    x_a, m_a = _event(2, 256, seed=p, masked=17)
    x_b, m_b = _event(1, 256, seed=5 + p, dup=False)
    x_c, m_c = _event(2, 256, seed=7 + p, dup=False)
    m_c[:] = False
    m_c[0, :5] = True
    return [("masked_dups", x_a, m_a, 12), ("k_is_shard", x_b, m_b, 256 // p),
            ("five_valid", x_c, m_c, 16)]


def _mesh(d):
    return Mesh(np.array(jax.devices())[:d].reshape(d), ("points",))


def _jax_ring(fn, x, mask, d, **kw):
    f = shard_map(
        lambda xs, ms: fn(xs, ms),
        mesh=_mesh(d),
        in_specs=(P(None, "points"), P(None, "points")),
        out_specs=(P(None, "points"), P(None, "points")),
        **kw,
    )
    idx, valid = jax.jit(f)(x, mask)
    return np.asarray(idx), np.asarray(valid)


@functools.lru_cache(maxsize=None)
def _port(p):
    """Every case of `_cases(p)` through the port on p gloo ranks, each
    rank's shard concatenated back along the points."""
    cases = _cases(p)
    res = run_point_ranks(torch_cp_ranks.ring_cases, p, device="cpu",
                          args=([(x, m, k) for _, x, m, k in cases],), timeout=300)
    out = {}
    for ci, (name, *_rest) in enumerate(cases):
        out[name] = {
            impl: tuple(np.concatenate([r["cases"][ci][impl][j] for r in res], axis=1)
                        for j in range(2))
            for impl in ("rdma", "ppermute")
        }
    out["launches"] = [r["launches"] for r in res]
    out["imports"] = [r["imports"] for r in res]
    return out


CASES = ["masked_dups", "k_is_shard", "five_valid"]


def _case(p, name):
    return next(c for c in _cases(p) if c[0] == name)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_rdma_plain_matches_jax_rdma(p, name):
    """The port's ``ring_impl="rdma"`` on the CPU (its plain merge) against
    the Pallas ring kernel in interpret mode: 0 hard mismatches, the same
    valid flags, invalid slots on the global self index."""
    _, x, mask, k = _case(p, name)
    ji, jv = _jax_ring(lambda xs, ms: ring_knn_rdma(xs, k, ms, axis_name="points"),
                       x, mask, p, check_vma=False)
    ti, tv = _port(p)[name]["rdma"]
    np.testing.assert_array_equal(tv, jv)
    hard, _ = split_mismatches(x, ti, ji, tv, jv)
    assert hard == 0
    self_idx = np.broadcast_to(np.arange(x.shape[1])[None, :, None], ti.shape)
    np.testing.assert_array_equal(ti[~tv], self_idx[~tv])
    if name == "five_valid":
        assert tv.sum(-1).max() == 5 and not tv[1].any()


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_ring_knn_matches_jax_ring_knn(p, name):
    """The port's ``ppermute`` ring (plain distance scores off CUDA)
    against the JAX `ring_knn`."""
    _, x, mask, k = _case(p, name)
    ji, jv = _jax_ring(lambda xs, ms: jax_ring_knn(xs, k, ms, axis_name="points"), x, mask, p)
    ti, tv = _port(p)[name]["ppermute"]
    np.testing.assert_array_equal(tv, jv)
    hard, _ = split_mismatches(x, ti, ji, tv, jv)
    assert hard == 0


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_ppermute_and_rdma_give_one_graph(p, name):
    """Switching ``ring_impl`` does not change the graph."""
    port = _port(p)[name]
    np.testing.assert_array_equal(port["rdma"][0], port["ppermute"][0])
    np.testing.assert_array_equal(port["rdma"][1], port["ppermute"][1])


@pytest.mark.parametrize("p", [2, 4])
def test_ranks_import_no_jax_and_count_no_launch(p):
    port = _port(p)
    assert all(not any(imp.values()) for imp in port["imports"])
    assert port["launches"] == [0] * p  # the plain path is not a launch


@pytest.mark.parametrize("p", [2, 4])
def test_ring_gather_and_pool_match_jax(p):
    """`ring_gather` and `cp_masked_max_pool` bit for bit against JAX, with
    an event that has no valid point (it pools to zeros)."""
    rng = np.random.default_rng(20 + p)
    b, n, c, k = 3, 128, 5, 6
    values = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, size=(b, n, k)).astype(np.int32)
    feat = rng.normal(size=(b, n, 7)).astype(np.float32)
    mask = rng.random((b, n)) < 0.6
    mask[1] = False
    res = run_point_ranks(torch_cp_ranks.gather_pool, p, device="cpu",
                          args=(values, idx, feat, mask), timeout=300)
    assert all(not any(r["imports"].values()) for r in res)

    mesh = _mesh(p)
    jg = jax.jit(shard_map(lambda v, i: jax_ring_gather(v, i, axis_name="points"), mesh=mesh,
                           in_specs=(P(None, "points"), P(None, "points")),
                           out_specs=P(None, "points")))(values, idx)
    gathered = np.concatenate([r["gather"] for r in res], axis=1)
    np.testing.assert_array_equal(gathered, np.asarray(jg))
    np.testing.assert_array_equal(gathered, values[np.arange(b)[:, None, None], idx])

    for key, m in (("pool", mask), ("pool_nomask", None)):
        if m is None:
            f = shard_map(lambda x: jax_pool(x, None, "points"), mesh=mesh,
                          in_specs=P(None, "points"), out_specs=P(), check_vma=False)
            jp = np.asarray(jax.jit(f)(feat))
        else:
            f = shard_map(lambda x, mm: jax_pool(x, mm, "points"), mesh=mesh,
                          in_specs=(P(None, "points"), P(None, "points")), out_specs=P(),
                          check_vma=False)
            jp = np.asarray(jax.jit(f)(feat, m))
        for r in res:  # every rank holds the whole pool
            np.testing.assert_array_equal(r[key], jp)
    np.testing.assert_array_equal(res[0]["pool"][1], np.zeros(7, np.float32))


@pytest.mark.parametrize("p", [2, 4])
def test_merges_equal_one_global_top_k(p):
    """The ring's merges on one process, blocks in the order each rank
    sees them (`merge_blocks` with `step_plain`), on operands built once
    for the whole event: concatenated over the ranks they are the exact
    kNN's plain version over the whole event, index for index (the same
    scores, ties by lower global index across blocks)."""
    x, mask = _event(2, 256, seed=30 + p, masked=9)
    x[:, 200] = x[:, 3]  # a tie between the last and the first shard
    xt, mt = torch.tensor(x), torch.tensor(mask)
    qa, ka = build_augmented_operands(xt, xt, mt)
    nl, k = 256 // p, 12
    idx, valid = [], []
    for me in range(p):
        rows = slice(me * nl, (me + 1) * nl)
        blocks = [(ka[:, ((me - s) % p) * nl:((me - s) % p + 1) * nl], ((me - s) % p) * nl)
                  for s in range(p)]
        i, v = rmod.merge_blocks(qa[:, rows], blocks, k, me * nl, rmod.step_plain)
        idx.append(i)
        valid.append(v)
    oi, ov, _ = knn_plain(xt, xt, k, mt)
    np.testing.assert_array_equal(torch.cat(idx, 1).numpy(), oi.numpy())
    np.testing.assert_array_equal(torch.cat(valid, 1).numpy(), ov.numpy())


@pytest.mark.parametrize("k", [65, 96, 130])
def test_merges_in_passes_equal_one_global_top_k(k):
    """k > 64 on the ring: pass 0 merges the blocks as they arrive, the
    later passes sweep the kept blocks behind each row's ceiling; over 4
    ranks the lists are the exact kNN's plain version index for index,
    one event with fewer than k valid points included."""
    p, n = 4, 640
    x, mask = _event(2, n, seed=k, masked=90)
    mask[1, 100:] = False
    x[:, 600] = x[:, 3]  # a tie between the last and the first shard
    xt, mt = torch.tensor(x), torch.tensor(mask)
    qa, ka = build_augmented_operands(xt, xt, mt)
    nl = n // p
    idx, valid = [], []
    for me in range(p):
        rows = slice(me * nl, (me + 1) * nl)
        blocks = [(ka[:, ((me - s) % p) * nl:((me - s) % p + 1) * nl], ((me - s) % p) * nl)
                  for s in range(p)]
        i, v = rmod.merge_blocks(qa[:, rows], blocks, k, me * nl, rmod.step_plain)
        idx.append(i)
        valid.append(v)
    oi, ov, _ = knn_plain(xt, xt, k, mt)
    np.testing.assert_array_equal(torch.cat(idx, 1).numpy(), oi.numpy())
    np.testing.assert_array_equal(torch.cat(valid, 1).numpy(), ov.numpy())
    assert ov[0].all() and ov[1].all() == (k <= 100)


def test_ring_kernel_wrapper_takes_plain_path_on_cpu():
    """A CPU tensor takes the plain ring (no launch, no build), and an
    unknown device raises."""
    from dgcnn_tpu_torch.parallel.mesh import PointGroup

    x, mask = _event(1, 64, seed=3)
    solo = PointGroup(rank=0, size=1, device=torch.device("cpu"), backend="gloo",
                      stage_host=False)
    before = rmod.launches
    idx, valid = rmod.ring_knn_cuda(torch.tensor(x), 8, torch.tensor(mask), group=solo)
    assert rmod.launches == before
    oi, ov, _ = knn_plain(torch.tensor(x), torch.tensor(x), 8, torch.tensor(mask))
    np.testing.assert_array_equal(idx.numpy(), oi.numpy())
    np.testing.assert_array_equal(valid.numpy(), ov.numpy())
    with pytest.raises(ValueError, match="k=9 > local shard size 8"):
        rmod.ring_knn_cuda(torch.tensor(x[:, :8]), 9, group=solo)
    with pytest.raises(ValueError, match="no kernel for device"):
        rmod.ring_knn_cuda(torch.tensor(x, device="meta"), 8, group=solo)
