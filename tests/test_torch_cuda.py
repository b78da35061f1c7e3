"""Tests of the hand-written CUDA kernels against their plain versions on
the card. They skip where there is no GPU; on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

This file imports no JAX, so it runs where only PyTorch is installed.
"""

import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.kernels import knn_banded_cuda as bmod
from dgcnn_tpu_torch.kernels import knn_cuda as kmod
from dgcnn_tpu_torch.kernels import ring_knn_cuda as rmod
from dgcnn_tpu_torch.ops.knn import split_mismatches, tie_order_violations


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ragged(seed, b=4, n=700, c=16, nvalid=(700, 400, 9, 0)):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, c).astype(np.float32)
    x[:, 100:140] = x[:, 0:40]  # duplicated rows
    mask = np.arange(n)[None] < np.asarray(nvalid)[:, None]
    return x, mask


def _all_equal(seed, b=2, n=1000, c=8, nvalid=(1000, 600)):
    """Every valid point of an event is the same point, so every valid key
    scores the same for every query: the tie rule alone picks the keys
    (the lowest indices). Padded points differ."""
    x, mask = _ragged(seed, b=b, n=n, c=c, nvalid=nvalid)
    x[mask] = x[0, 0]
    return x, mask


def _check(x, got, ref, xk=None):
    gi, gv, gs = (t.cpu().numpy() for t in got)
    ri, rv, _ = (t.cpu().numpy() for t in ref)
    np.testing.assert_array_equal(gv, rv)
    hard, _ = split_mismatches(x, gi, ri, gv, rv, xk=xk)
    assert hard == 0
    assert tie_order_violations(x if xk is None else xk, gi, gv) == 0
    assert (np.diff(gs, axis=-1) <= 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("c,k", [(4, 20), (16, 8), (64, 20), (3, 64)])
def test_knn_kernel_matches_plain(cuda, c, k):
    x, mask = _ragged(c + k, c=c)
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    before = kmod.launches
    got = kmod.knn_cuda(xt, k, mt, return_scores=True)
    torch.cuda.synchronize()
    assert kmod.launches == before + 1
    _check(x, got, kmod.knn_plain(xt, xt, k, mt))


@pytest.mark.cuda
def test_knn_kernel_cross_form(cuda):
    x, mask = _ragged(1)
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    xq = xt[:, 50:300].contiguous()
    got = kmod.knn_cuda_cross(xq, xt, 20, mt)
    _check(x[:, 50:300], got, kmod.knn_plain(xq, xt, 20, mt), xk=x)
    # fewer than k valid keys: self-edges min(i, nk - 1), valid False
    idx, valid, _ = (t.cpu().numpy() for t in got)
    bad = ~valid[2]
    assert bad.any()
    assert (idx[2][bad] == np.minimum(np.arange(250), 699)[:, None].repeat(20, 1)[bad]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 32, 33, 64])
def test_knn_kernel_k_boundaries(cuda, k):
    """One list register a lane (k <= 32) and two (k > 32), at the edges,
    against the plain version, self and cross forms."""
    x, mask = _ragged(k + 2, c=8)
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    _check(x, kmod.knn_cuda(xt, k, mt, return_scores=True), kmod.knn_plain(xt, xt, k, mt))
    xq = xt[:, 100:400].contiguous()
    _check(x[:, 100:400], kmod.knn_cuda_cross(xq, xt, k, mt), kmod.knn_plain(xq, xt, k, mt), xk=x)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 20, 32, 33, 64])
def test_knn_kernel_ties_take_lowest_indices(cuda, k):
    """All valid points equal: every valid key ties for every query, and a
    split holding higher indices may be swept first, so only the (score,
    index) order gives each row exactly the k lowest valid indices, in
    the self and the cross form."""
    x, mask = _all_equal(k, n=1000, nvalid=(1000, 600))
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    for xq, rows in ((xt, slice(None)), (xt[:, 300:700].contiguous(), slice(300, 700))):
        got = kmod.knn_cuda_cross(xq, xt, k, mt)
        _check(x[:, rows], got, kmod.knn_plain(xq, xt, k, mt), xk=x)
        gi, gv = got[0].cpu().numpy(), got[1].cpu().numpy()
        assert gv.all()
        np.testing.assert_array_equal(gi, np.broadcast_to(np.arange(k), gi.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 64])
def test_knn_kernel_splits_agree(cuda, c, monkeypatch):
    """The key split S in {1, 2, 4}, forced, gives bit-identical idx,
    valid and scores at the served shape (B=4, N=4096, k=20) on a ragged
    mask, and the plain version's graph."""
    x, mask = _ragged(c, n=4096, c=c, nvalid=(4096, 2500, 13, 0))
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    outs = []
    for s in (1, 2, 4):
        monkeypatch.setattr(kmod, "_splits_override", s)
        outs.append(kmod.knn_cuda(xt, 20, mt, return_scores=True))
    for got in outs[1:]:
        for a, b in zip(outs[0], got):
            assert torch.equal(a, b)
    _check(x, outs[0], kmod.knn_plain(xt, xt, 20, mt))
    monkeypatch.setattr(kmod, "_splits_override", None)
    assert 1 <= kmod.choose_splits(4, 4096, 4096, c + 2, 20, cuda) <= kmod.MAX_SPLITS


@pytest.mark.cuda
def test_knn_kernel_refuses_launch_it_cannot_take(cuda):
    """C = 2000 runs (channels in chunks) and gives the plain version's
    graph; k past Nk is refused before any launch."""
    x, mask = _ragged(3, b=1, n=200, c=2000, nvalid=(150,))
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    _check(x, kmod.knn_cuda(xt, 20, mt, return_scores=True), kmod.knn_plain(xt, xt, 20, mt))
    with pytest.raises(ValueError, match="Nk"):
        kmod.knn_cuda(xt, 201, mt)


# C + 2 = 180 is the widest one-pass layout, 181 the first chunked one;
# k = 64 one pass, 65 and 96 two passes (64 + 1, 64 + 32), 128 two full ones
WIDE = [(c, k) for c in (178, 179, 256, 1024) for k in (64, 65, 96, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,k", WIDE)
def test_knn_kernel_any_width_and_k(cuda, c, k):
    """The exact kernel at widths past one shared-memory pass and k past one
    list pass, against the plain version: self and cross forms on a ragged
    mask (events with fewer than k valid points), and on the all-equal
    input, where every row holds exactly the k lowest valid indices."""
    x, mask = _ragged(c + k, n=700, c=c)
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    _check(x, kmod.knn_cuda(xt, k, mt, return_scores=True), kmod.knn_plain(xt, xt, k, mt))
    xq = xt[:, 100:400].contiguous()
    _check(x[:, 100:400], kmod.knn_cuda_cross(xq, xt, k, mt), kmod.knn_plain(xq, xt, k, mt), xk=x)
    xe, me = _all_equal(c, n=700, c=c, nvalid=(700, 300))
    xet, met = torch.tensor(xe, device=cuda), torch.tensor(me, device=cuda)
    got = kmod.knn_cuda(xet, k, met, return_scores=True)
    _check(xe, got, kmod.knn_plain(xet, xet, k, met))
    assert got[1].all()
    np.testing.assert_array_equal(got[0].cpu().numpy(), np.broadcast_to(np.arange(k), got[0].shape))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 64])
def test_knn_kernel_splits_agree_in_passes(cuda, c, monkeypatch):
    """k = 96 (two passes, the second behind a ceiling) with the key split
    S in {1, 2, 4}, forced: bit-identical idx, valid and scores, and the
    plain version's graph."""
    x, mask = _ragged(c + 1, n=4096, c=c, nvalid=(4096, 2500, 13, 0))
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    outs = []
    for s in (1, 2, 4):
        monkeypatch.setattr(kmod, "_splits_override", s)
        outs.append(kmod.knn_cuda(xt, 96, mt, return_scores=True))
    for got in outs[1:]:
        for a, b in zip(outs[0], got):
            assert torch.equal(a, b)
    _check(x, outs[0], kmod.knn_plain(xt, xt, 96, mt))


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,window", [(4, 20, 64), (64, 20, 256), (3, 8, 700), (16, 64, 100)])
def test_banded_kernel_matches_plain(cuda, c, k, window):
    x, mask = _ragged(c + k + window, c=c)
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    before = bmod.launches
    got = bmod.knn_banded_cuda(xt, k, mt, window=window, return_scores=True)
    torch.cuda.synchronize()
    assert bmod.launches == before + 1
    _check(x, got, bmod.knn_banded_plain(xt, xt, k, mt, window=min(window, 700)))


@pytest.mark.cuda
def test_banded_kernel_cross_form(cuda):
    """A halo-shaped slice: queries [200, 450) against their rows plus
    the window each side, at their global positions."""
    x, mask = _ragged(2)
    w, k = 96, 12
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    nvalid = mt.sum(-1).to(torch.int32)
    xq = xt[:, 200:450].contiguous()
    xk = xt[:, 200 - w : 450 + w].contiguous()
    mk = mt[:, 200 - w : 450 + w].contiguous()
    band = dict(window=w, q_base=200, key_base=200 - w, nvalid=nvalid)
    got = bmod.knn_banded_cuda_cross(xq, xk, k, mk, **band)
    ref = bmod.knn_banded_plain(xq, xk, k, mk, **band)
    _check(x[:, 200:450], got, ref, xk=x)  # indices are global positions in x


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 32, 33, 64])
def test_banded_kernel_k_boundaries(cuda, k):
    """One list register a lane (k <= 32) and two (k > 32), at the edges,
    against the plain version; the window spans several tiles."""
    x, mask = _ragged(k, c=8)
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    got = bmod.knn_banded_cuda(xt, k, mt, window=200, return_scores=True)
    _check(x, got, bmod.knn_banded_plain(xt, xt, k, mt, window=200))


@pytest.mark.cuda
@pytest.mark.parametrize("c,k", WIDE)
def test_banded_kernel_any_width_and_k(cuda, c, k):
    """The banded kernel at widths past one shared-memory pass and k past
    one list pass, against the plain version: the self form on a ragged
    mask, a halo-shaped cross form, and the all-equal input, where every
    row holds exactly its lowest in-band indices."""
    n, w = 700, 200
    x, mask = _ragged(c + k + 1, n=n, c=c)
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    _check(x, bmod.knn_banded_cuda(xt, k, mt, window=w, return_scores=True),
           bmod.knn_banded_plain(xt, xt, k, mt, window=w))
    nvalid = mt.sum(-1).to(torch.int32)
    band = dict(window=w, q_base=250, key_base=50, nvalid=nvalid)
    xq, xk, mk = xt[:, 250:450].contiguous(), xt[:, 50:650].contiguous(), mt[:, 50:650].contiguous()
    got = bmod.knn_banded_cuda_cross(xq, xk, k, mk, **band)
    ref = bmod.knn_banded_plain(xq, xk, k, mk, **band)
    # padded queries' rows are garbage by contract
    q_ok = torch.tensor(np.arange(250, 450)[None] < nvalid.cpu().numpy()[:, None])[..., None]

    def valid_rows(out):
        i, v, sc = (t.cpu() for t in out)
        return torch.where(q_ok, i, 0), v & q_ok, torch.where(q_ok, sc, 0.0)

    _check(x[:, 250:450], valid_rows(got), valid_rows(ref), xk=x)
    nv = np.array([700, 300])
    xe, me = _all_equal(c, n=n, c=c, nvalid=tuple(nv))
    xet, met = torch.tensor(xe, device=cuda), torch.tensor(me, device=cuda)
    got = bmod.knn_banded_cuda(xet, k, met, window=w, return_scores=True)
    _check(xe, got, bmod.knn_banded_plain(xet, xet, k, met, window=w))
    lo = np.clip(np.arange(n)[None] - w // 2, 0, np.maximum(nv - w, 0)[:, None])
    assert got[1].all()
    np.testing.assert_array_equal(got[0].cpu().numpy(), lo[..., None] + np.arange(k))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 32, 33, 64])
def test_banded_kernel_ties_take_lowest_indices(cuda, k):
    """All valid points equal: every in-band valid key ties, and the
    kernel visits the diagonal tile before lower-index tiles of the
    window, so only the (score, index) order gives the lowest in-band
    indices ``lo .. lo + k - 1`` of each row."""
    n, w = 1000, 300
    nvalid = np.array([1000, 600])
    x, mask = _all_equal(k, n=n, nvalid=tuple(nvalid))
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    got = bmod.knn_banded_cuda(xt, k, mt, window=w, return_scores=True)
    _check(x, got, bmod.knn_banded_plain(xt, xt, k, mt, window=w))
    gi, gv = got[0].cpu().numpy(), got[1].cpu().numpy()
    lo = np.clip(np.arange(n)[None] - w // 2, 0, np.maximum(nvalid - w, 0)[:, None])
    assert gv.all()
    np.testing.assert_array_equal(gi, lo[..., None] + np.arange(k))


def _ring_ranks(x, mask, k, p, device):
    """The ring's merges in one process, P virtual owners, blocks in the
    order each rank sees them, on operands built once for the event: each
    rank's kernel result against `step_plain`; returns all ranks' ``(idx,
    valid)`` concatenated."""
    n = x.shape[1]
    xt, mt = torch.tensor(x, device=device), torch.tensor(mask, device=device)
    qa, ka = kmod.build_augmented_operands(xt, xt, mt)
    nl = n // p
    idx, valid = [], []
    for me in range(p):
        rows = slice(me * nl, (me + 1) * nl)
        order = [(me - s) % p for s in range(p)]
        blocks = [(ka[:, o * nl:(o + 1) * nl].contiguous(), o * nl) for o in order]
        before = rmod.launches
        gi, gv = rmod.merge_blocks(qa[:, rows].contiguous(), blocks, k, me * nl, rmod.launch_step)
        torch.cuda.synchronize()
        assert rmod.launches == before + p * -(-k // rmod.KMAX)  # a launch a step of a pass
        ri, rv = rmod.merge_blocks(qa[:, rows].contiguous(), blocks, k, me * nl, rmod.step_plain)
        gi, gv, ri, rv = (t.cpu().numpy() for t in (gi, gv, ri, rv))
        np.testing.assert_array_equal(gv, rv)
        hard, _ = split_mismatches(x[:, rows], gi, ri, gv, rv, xk=x)
        assert hard == 0
        assert tie_order_violations(x, gi, gv) == 0
        idx.append(gi)
        valid.append(gv)
    return np.concatenate(idx, 1), np.concatenate(valid, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 32, 33, 64])
def test_ring_kernel_k_boundaries(cuda, k):
    """One and two list registers a lane, at the edges: every rank against
    the plain version, all ranks together against the exact kernel."""
    x, mask = _ragged(k + 1, n=768, c=8, nvalid=(768, 400, 9, 0))
    gi, gv = _ring_ranks(x, mask, k, 4, cuda)
    ei, ev = kmod.knn_cuda(torch.tensor(x, device=cuda), k, torch.tensor(mask, device=cuda))
    np.testing.assert_array_equal(gi, ei.cpu().numpy())
    np.testing.assert_array_equal(gv, ev.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 32, 33, 64])
def test_ring_kernel_ties_take_lowest_indices(cuda, k):
    """All valid points equal: every valid key ties, and every rank but
    the first meets its own (higher) indices before the lower ones of
    later blocks, so only the (score, global index) order gives the k
    lowest valid global indices to every query."""
    x, mask = _all_equal(k, n=768, nvalid=(768, 400))
    gi, gv = _ring_ranks(x, mask, k, 4, cuda)
    assert gv.all()
    np.testing.assert_array_equal(gi, np.broadcast_to(np.arange(k), gi.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,p", [(4, 20, 4), (64, 20, 4), (3, 16, 2), (16, 64, 4)])
def test_ring_kernel_matches_plain_and_exact(cuda, c, k, p):
    """The ring's merges in one process, P virtual owners, blocks in the
    order each rank sees them, on operands built once for the event: the
    kernel against `step_plain` per rank, and all ranks together against
    the exact kernel over the whole event, index for index."""
    n = 768
    x, mask = _ragged(c + k + p, n=n, c=c, nvalid=(768, 400, 9, 0))
    x[:, 700] = x[:, 5]  # a tie between the last shard and the first
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    gi, gv = _ring_ranks(x, mask, k, p, cuda)
    ei, ev = kmod.knn_cuda(xt, k, mt)
    np.testing.assert_array_equal(gi, ei.cpu().numpy())
    np.testing.assert_array_equal(gv, ev.cpu().numpy())


@pytest.mark.cuda
def test_ring_kernel_one_shard_is_the_exact_kernel(cuda):
    """A group of one: one launch, the exact kernel's graph."""
    from dgcnn_tpu_torch.parallel.mesh import PointGroup

    x, mask = _ragged(5, c=8)
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    solo = PointGroup(rank=0, size=1, device=cuda, backend="nccl", stage_host=False)
    before = rmod.launches
    gi, gv = rmod.ring_knn_cuda(xt, 20, mt, group=solo)
    assert rmod.launches == before + 1
    ei, ev = kmod.knn_cuda(xt, 20, mt)
    assert torch.equal(gi, ei) and torch.equal(gv, ev)
    # C = 2000 runs (channels in chunks), k = 96 in two passes
    xw, mw = _ragged(6, b=1, n=256, c=2000, nvalid=(200,))
    xwt, mwt = torch.tensor(xw, device=cuda), torch.tensor(mw, device=cuda)
    for k in (20, 96):
        gi, gv = rmod.ring_knn_cuda(xwt, k, mwt, group=solo)
        ei, ev = kmod.knn_cuda(xwt, k, mwt)
        assert torch.equal(gi, ei) and torch.equal(gv, ev)


@pytest.mark.cuda
@pytest.mark.parametrize("c,k", WIDE)
def test_ring_kernel_any_width_and_k(cuda, c, k):
    """The ring at widths past one shared-memory pass and k past one list
    pass: every rank against the plain version (the later passes over the
    kept blocks), all ranks together against the exact kernel index for
    index; on the all-equal input every query holds the k lowest valid
    global indices."""
    x, mask = _ragged(c + k + 2, n=768, c=c, nvalid=(768, 400, 9, 0))
    x[:, 700] = x[:, 5]  # a tie between the last shard and the first
    gi, gv = _ring_ranks(x, mask, k, 4, cuda)
    ei, ev = kmod.knn_cuda(torch.tensor(x, device=cuda), k, torch.tensor(mask, device=cuda))
    np.testing.assert_array_equal(gi, ei.cpu().numpy())
    np.testing.assert_array_equal(gv, ev.cpu().numpy())
    xe, me = _all_equal(c, n=768, c=c, nvalid=(768, 400))
    gi, gv = _ring_ranks(xe, me, k, 4, cuda)
    assert gv.all()
    np.testing.assert_array_equal(gi, np.broadcast_to(np.arange(k), gi.shape))


def _ring_graph(x, k, mask):
    """A pinned graph: point i's neighbours are i .. i + k - 1 mod N,
    whatever the features, so the card and the CPU train on one graph."""
    n = x.shape[-2]
    idx = (torch.arange(n, device=x.device)[:, None] + torch.arange(k, device=x.device)) % n
    idx = idx.to(torch.int32).expand(x.shape[:-1] + (k,))
    return idx, torch.ones(idx.shape, dtype=torch.bool, device=x.device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(model_name="dgcnn", global_pool=False, optimizer="adam"),
    dict(model_name="residual-dgcnn", optimizer="sgd", learning_rate=0.05, grad_clip=0.5),
])
def test_train_step_on_the_card_matches_the_cpu(cuda, case):
    """Three train steps of a small model on the card (the fused EdgeConv
    block's autograd.Function, train-mode BN, the optimizer) against the
    same steps on the CPU from the same init and batches, on a pinned
    graph: loss within 1e-5 relative at every step, parameters within 1e-4
    relative after 3 steps (an absolute floor of 1e-4 of the largest
    parameter: the card's index_add_ sums in another order)."""
    from dgcnn_tpu_torch.bridge import tree_leaves, tree_map
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO
    from dgcnn_tpu_torch.train.trainval import Trainval

    cfg = Config(**{**dict(num_class=2, kvalue=6, edge_filters=(12, 16), head_feat_dim=24,
                           head_mlp=(16,), minibatch_size=2, num_point=256), **case})
    io = SyntheticIO(num_events=6, num_point=256, seed=3, with_weights=True)
    io.initialize()
    batches = list(BucketBatcher(io, 2, buckets=(256,), shuffle=False).epoch())[:3]
    cpu = Trainval(cfg, device="cpu", knn_fn=_ring_graph)
    gpu = Trainval(cfg, device=cuda, knn_fn=_ring_graph)
    sc = cpu.initialize(4)
    # copies: the steps update the parameters in place
    sg = gpu.with_params(tree_map(lambda t: t.clone().to(cuda), sc.params),
                         tree_map(lambda t: t.clone().to(cuda), sc.model_state))
    for i, batch in enumerate(batches):
        sc, mc = cpu.train_step(sc, batch)
        sg, mg = gpu.train_step(sg, batch)
        want = float(mc["loss"])
        assert abs(float(mg["loss"]) - want) <= 1e-5 * abs(want), (i, float(mg["loss"]), want)
    want_leaves = [t.numpy() for t in tree_leaves(sc.params)]
    floor = 1e-4 * max(float(np.abs(w).max()) for w in want_leaves)
    for g, w in zip(tree_leaves(sg.params), want_leaves):
        np.testing.assert_allclose(g.cpu().numpy(), w, rtol=1e-4, atol=floor)


@pytest.mark.cuda
def test_cli_train_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """Three train steps through the command line (`cli.main`) on the card,
    from a DGB file, against the same run on the CPU with the kernel's
    plain version `knn_plain` as the graph build: the CSV loss within 1e-4
    relative at every step; the kernel launched for every graph build of
    the card run."""
    import csv
    import functools

    from dgcnn_tpu_torch import cli
    from dgcnn_tpu_torch.io import SyntheticIO
    from dgcnn_tpu_torch.io.dgb import write_dgb
    from dgcnn_tpu_torch.train import loop
    from dgcnn_tpu_torch.train.trainval import Trainval

    io = SyntheticIO(num_events=6, num_point=256, seed=3, with_weights=True).initialize()
    write_dgb(str(tmp_path / "ev.dgb"), [io.read_event(i) for i in range(6)])
    losses = {}
    for dev in ("cpu", "cuda"):
        if dev == "cpu":
            plain = functools.partial(Trainval, knn_fn=lambda x, k, m: kmod.knn_plain(x, x, k, m)[:2])
            monkeypatch.setattr(loop, "Trainval", plain)
        else:
            monkeypatch.setattr(loop, "Trainval", Trainval)
        before = kmod.launches
        assert cli.main(["train", "-io", "dgb", "-if", str(tmp_path / "ev.dgb"), "-mb", "2",
                         "-np", "256", "-k", "6", "--edge_filters", "12", "16",
                         "--head_feat_dim", "24", "--head_mlp", "16", "-i", "3", "-rs", "1",
                         "--no_shuffle", "-nd", "1", "-wp", str(tmp_path / dev / "w"),
                         "-ld", str(tmp_path / dev)], device=dev) == 0
        assert kmod.launches - before == (6 if dev == "cuda" else 0)
        with open(tmp_path / dev / "train_log.csv") as f:
            losses[dev] = [float(r["loss"]) for r in csv.DictReader(f)]
    assert len(losses["cuda"]) == 3
    for g, w in zip(losses["cuda"], losses["cpu"]):
        assert abs(g - w) <= 1e-4 * abs(w), (losses["cuda"], losses["cpu"])


def _dp_case():
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO

    kw = dict(model_name="residual-dgcnn", num_class=2, kvalue=8, edge_filters=(16, 16),
              head_feat_dim=32, head_mlp=(32,), optimizer="sgd", learning_rate=1e-2,
              minibatch_size=4, num_point=256)
    io = SyntheticIO(num_events=12, num_point=256, seed=3, with_weights=True).initialize()
    batches = list(BucketBatcher(io, 4, buckets=(256,), shuffle=False).epoch())[:3]
    return kw, [(b.points, b.labels, b.weights, b.mask) for b in batches]


@pytest.mark.cuda
@pytest.mark.parametrize("block_impl", ["edge", "fused"])
def test_dp_two_ranks_on_the_card_match_one(cuda, block_impl):
    """DP-2 on the card (two ranks on one card share it through gloo and
    pinned host buffers; one card each under NCCL) against one rank on
    the card, from one init, on a pinned graph, 3 SGD steps: the loss
    within 1e-5 relative, the parameters within 1e-4 relative (a floor of
    1e-4 of the largest: index_add_ sums in another order on the card),
    the same on both ranks."""
    import torch_dp_ranks
    from dgcnn_tpu_torch.bridge import params_to_numpy, tree_leaves
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.parallel.launch import run_ranks
    from dgcnn_tpu_torch.train.trainval import Trainval

    kw, batches = _dp_case()
    kw = dict(kw, block_impl=block_impl)
    one = Trainval(Config(**kw), device=cuda, knn_fn=torch_dp_ranks.port_ring)
    state = one.initialize(4)
    params, mstate = params_to_numpy(state.params, state.model_state)
    ranks = run_ranks(torch_dp_ranks.train_cases, 2, device="cuda",
                      args=([dict(kw, num_devices=2)], params, mstate, batches, batches[0]),
                      timeout=600)
    losses = []
    for b in batches:
        state, m = one.train_step(state, b)
        losses.append(float(m["loss"]))
    got = ranks[0]["cases"][0]
    for g, w in zip([float(s["loss"]) for s in got["steps"]], losses):
        assert abs(g - w) <= 1e-5 * abs(w), (g, w)
    want = [t.cpu().numpy() for t in tree_leaves(state.params)]
    floor = 1e-4 * max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got["params"], want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=floor)
    for g, w in zip(ranks[1]["cases"][0]["params"], got["params"]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_dp_ranks_launch_the_exact_kernel(cuda):
    """Every DP rank on the card builds its graphs with the hand-written
    exact kernel: one launch a block a step, never the plain version."""
    import torch_dp_ranks
    from dgcnn_tpu_torch.parallel.launch import run_ranks

    kw, batches = _dp_case()
    ranks = run_ranks(torch_dp_ranks.kernel_step, 2, device="cuda",
                      args=(dict(kw, num_devices=2), batches[0]), timeout=600)
    for r in ranks:
        assert r["launches"] == 2 and r["knn_fn"] == "knn_cuda", r
        assert r["device"].startswith("cuda")
    assert ranks[0]["loss"] == ranks[1]["loss"]
