"""Tests of the port on the card: the hand-written CUDA kernels against
their plain versions, and every path of the port that launches them
(serving, training, the command line, export, data and context
parallelism) for its launches, its outputs and its agreement with the
CPU, one device or the plain graph build. They skip where there is no
GPU; on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

This file imports no JAX (``--noconftest`` leaves out `tests/conftest.py`,
which does), so it runs where only PyTorch is installed.
"""

import dataclasses
import os
import re
import subprocess
import sys

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
@pytest.mark.parametrize("c,k", [(3, 20), (4, 20), (64, 20), (64, 32), (64, 33), (64, 64),
                                 (126, 1), (166, 20), pytest.param(None, 20, id="train-f32-131k")])
def test_f32_hopper_kernel_equals_the_sweep(cuda, c, k, monkeypatch):
    """Every one-pass fp32 shape the exact kernel routes to the Hopper
    kernel (`f32_kernel_for`) gives the fp32 sweep's idx, valid and scores
    bit for bit, each form forced, at the key split S in {1, 2, 3}: self
    and cross form (Nq != Nk) on a ragged mask with events of fewer than k
    valid points, and the all-equal input; the wrapper's launch counts in
    ``launches_f32_hopper`` and gives the same outputs. ``train-f32-131k``:
    the six graph-build inputs of the flagship's f32 train step on one
    131,072-point event (`_flagship_step_inputs`: the step launched the
    Hopper form for every build), at the card's own S."""
    if c is None:
        inputs, splits = [(x, x, m) for x, m in _flagship_step_inputs(cuda)], (None,)
    else:
        inputs, splits = [], (1, 2, 3)
        x, mask = _ragged(c + k, c=c)
        xe, me = _all_equal(c + k + 1, n=700, c=c, nvalid=(700, 300))
        for xn, mn in ((x, mask), (xe, me)):
            xt, mt = torch.tensor(xn, device=cuda), torch.tensor(mn, device=cuda)
            inputs += [(xt, xt, mt), (xt[:, 100:400].contiguous(), xt, mt)]
    for xq, xk, mk in inputs:
        assert kmod.f32_kernel_for(xk.shape[-1] + 2, k) == "hopper"
        qa, ka = kmod.build_augmented_operands(xq, xk, mk, cpad=kmod.CPAD)
        ref = None
        for s in splits:
            monkeypatch.setattr(kmod, "_splits_override", s)
            got = kmod.launch_operands(qa, ka, k, kernel="hopper")
            ref = ref or kmod.launch_operands(qa, ka, k, kernel="sweep")
            for a, b in zip(got, ref):
                assert torch.equal(a, b)
        monkeypatch.setattr(kmod, "_splits_override", None)
        before = (kmod.launches, kmod.launches_f32_hopper)
        live = kmod.knn_cuda_cross(xq, xk, k, mk)
        assert (kmod.launches, kmod.launches_f32_hopper) == (before[0] + 1, before[1] + 1)
        for a, b in zip(live, ref, strict=True):
            assert torch.equal(a, b)


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
@pytest.mark.parametrize("form", ["self", "cross"])
@pytest.mark.parametrize("k", [1, 32, 33, 64])
def test_banded_kernel_ties_take_lowest_indices(cuda, k, form):
    """All valid points equal: every in-band valid key ties, and the
    kernel visits the diagonal tile before lower-index tiles of the
    window, so only the (score, index) order gives the lowest in-band
    indices ``lo .. lo + k - 1`` of each row. ``cross``: the halo cross
    form (queries [400, 700) against keys [100, 1000), indices at their
    global positions, the second event's queries past its 600 valid
    points padded): every valid query row holds exactly its lowest
    in-band positions, with the plain version's valid flags."""
    n, w = 1000, 300
    nvalid = np.array([1000, 600])
    x, mask = _all_equal(k, n=n, nvalid=tuple(nvalid))
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    if form == "self":
        got = bmod.knn_banded_cuda(xt, k, mt, window=w, return_scores=True)
        _check(x, got, bmod.knn_banded_plain(xt, xt, k, mt, window=w))
        gi, gv = got[0].cpu().numpy(), got[1].cpu().numpy()
        lo = np.clip(np.arange(n)[None] - w // 2, 0, np.maximum(nvalid - w, 0)[:, None])
        assert gv.all()
        np.testing.assert_array_equal(gi, lo[..., None] + np.arange(k))
        return
    q0, q1 = 400, 700
    band = dict(window=w, q_base=q0, key_base=q0 - w, nvalid=mt.sum(-1).to(torch.int32))
    xq, xk = xt[:, q0:q1].contiguous(), xt[:, q0 - w:q1 + w].contiguous()
    mk = mt[:, q0 - w:q1 + w].contiguous()
    gi, gv, _ = (t.cpu().numpy() for t in bmod.knn_banded_cuda_cross(xq, xk, k, mk, **band))
    rv = bmod.knn_banded_plain(xq, xk, k, mk, **band)[1].cpu().numpy()
    pos = np.arange(q0, q1)
    q_ok = (pos[None] < nvalid[:, None])[..., None]
    lo = np.clip(pos[None] - w // 2, 0, np.maximum(nvalid - w, 0)[:, None])
    want_v = (np.arange(k) < (np.minimum(lo + w, nvalid[:, None]) - lo)[..., None]) & q_ok
    np.testing.assert_array_equal(gv & q_ok, want_v)
    np.testing.assert_array_equal(rv & q_ok, want_v)
    np.testing.assert_array_equal(np.where(want_v, gi, 0),
                                  np.where(want_v, lo[..., None] + np.arange(k), 0))


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


# --knn_precision default: the TC instantiations (bf16 mma.sync) against
# their plain versions, the same bf16-rounded operands through an fp32
# matmul. The tensor cores sum the exact products in another order, so the
# gate is `split_score_mismatches` at rtol 1e-4 of a score's sum of
# absolute terms (the scores agree to ~1e-6 of it; bf16 rounding moves them
# by ~4e-3 of it, which the gate would catch), identical valid flags and 0
# adjacent slots out of the (score desc, index asc) order.
TC_RTOL = 1e-4


def _counts():
    """The exact kernel's launches: (Hopper TC, sweep TC, fp32)."""
    return kmod.launches_tc, kmod.launches_tc_sweep, kmod.launches


def _check_tc(xq, xk, mk, got, ref, key_offset=0):
    from dgcnn_tpu_torch.ops.knn import score_order_violations, split_score_mismatches

    qa, ka = kmod.build_augmented_operands(xq, xk, mk, "default")
    gi, gv, gs = (t.cpu().numpy() for t in got)
    ri, rv, _ = (t.cpu().numpy() for t in ref)
    np.testing.assert_array_equal(gv, rv)
    hard, _ = split_score_mismatches(qa.cpu().numpy(), ka.cpu().numpy(), gi, ri, gv, rv,
                                     rtol=TC_RTOL, key_offset=key_offset)
    assert hard == 0
    assert score_order_violations(gs, gi, gv) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("c,k", [(4, 20), (16, 8), (64, 20), (3, 64), (64, 96), (256, 20),
                                 (1024, 65)])
def test_tc_knn_kernel_matches_plain(cuda, c, k):
    x, mask = _ragged(c + k + 1, c=c)
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    before = _counts()
    got = kmod.knn_cuda(xt, k, mt, return_scores=True, precision="default")
    torch.cuda.synchronize()
    # one launch of the kernel its shape routes to: the Hopper kernel up to
    # k = KMAX at one-pass widths, sweep_tc past them
    hopper = kmod.tc_kernel_for(-(-(c + 2) // kmod.CPAD_TC) * kmod.CPAD_TC, k) == "tc"
    assert _counts() == (before[0] + hopper, before[1] + (not hopper), before[2])
    _check_tc(xt, xt, mt, got, kmod.knn_plain(xt, xt, k, mt, "default"))
    cross = kmod.knn_cuda_cross(xt[:, 50:300].contiguous(), xt, k, mt, precision="default")
    _check_tc(xt[:, 50:300], xt, mt, cross,
              kmod.knn_plain(xt[:, 50:300].contiguous(), xt, k, mt, "default"))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 20, 33, 64, 96])
def test_tc_knn_kernel_ties_take_lowest_indices(cuda, k):
    x, mask = _all_equal(k + 5)
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    gi, gv = (t.cpu().numpy() for t in kmod.knn_cuda(xt, k, mt, precision="default"))
    for e, nv in enumerate(mask.sum(-1)):
        want = np.arange(min(k, nv))
        assert (gi[e, :, :want.size] == want).all() and gv[e, :, :want.size].all()


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 2, 4])
def test_tc_knn_kernel_splits_agree(cuda, s, monkeypatch):
    """The key split does not change one bit of the TC graph."""
    x, mask = _ragged(8, b=2, n=2048, c=64, nvalid=(2048, 1500))
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    monkeypatch.setattr(kmod, "_splits_override", 1)
    want = kmod.knn_cuda(xt, 20, mt, return_scores=True, precision="default")
    monkeypatch.setattr(kmod, "_splits_override", s)
    got = kmod.knn_cuda(xt, 20, mt, return_scores=True, precision="default")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _same_as_sweep(xq, xk, mk, k, got):
    """The Hopper TC kernel's (idx, valid, scores) equal sweep_tc's (the
    shared sweep's TC instantiation, the bit reference on the card) on the same operands:
    indices and valid flags equal, scores ``==``."""
    qa, ka = kmod.build_augmented_operands(xq, xk, mk, "default")
    ref = kmod.launch_operands(qa, ka, k, "default", kernel="sweep")
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# the widths of the Hopper TC kernel's tests: the points (3, 4), the
# flagship's features (64), 126 (c2 = 128) and its widest one-pass width
HOPPER_C = [3, 4, 64, 126, kmod.TC_MAX_C2 - 2]


@pytest.mark.cuda
@pytest.mark.parametrize("c", HOPPER_C)
@pytest.mark.parametrize("k", [1, 20, 32, 33, 64])
def test_hopper_tc_kernel_matches_plain_and_sweep(cuda, c, k):
    """The Hopper TC kernel (csrc/knn_tc.cuh) on ragged input: B = 2, N =
    1000 (not a multiple of its 64-key tile), one event with 13 valid
    points; self and cross forms against the plain version of the rounded
    operands and against sweep_tc, bit for bit."""
    x, mask = _ragged(7 * c + k, b=2, n=1000, c=c, nvalid=(1000, 13))
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    before = _counts()
    got = kmod.knn_cuda(xt, k, mt, return_scores=True, precision="default")
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1], before[2])
    _check_tc(xt, xt, mt, got, kmod.knn_plain(xt, xt, k, mt, "default"))
    _same_as_sweep(xt, xt, mt, k, got)
    xq = xt[:, 100:400].contiguous()
    cross = kmod.knn_cuda_cross(xq, xt, k, mt, precision="default")
    _check_tc(xq, xt, mt, cross, kmod.knn_plain(xq, xt, k, mt, "default"))
    _same_as_sweep(xq, xt, mt, k, cross)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 64])
@pytest.mark.parametrize("k", [1, 20, 32, 33, 64])
def test_hopper_tc_kernel_ties_take_lowest_indices(cuda, c, k):
    """Every valid point one point: the Hopper kernel keeps the lowest
    indices, as sweep_tc does, bit for bit."""
    x, mask = _all_equal(k + c, c=c)
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    got = kmod.knn_cuda(xt, k, mt, return_scores=True, precision="default")
    gi, gv = (t.cpu().numpy() for t in got[:2])
    for e, nv in enumerate(mask.sum(-1)):
        want = np.arange(min(k, nv))
        assert (gi[e, :, :want.size] == want).all() and gv[e, :, :want.size].all()
    _same_as_sweep(xt, xt, mt, k, got)


@pytest.mark.cuda
@pytest.mark.parametrize("c,k", [(4, 20), (64, 20), (64, 64),
                                 pytest.param(None, 20, id="train-bf16-131k")])
def test_hopper_tc_kernel_splits_agree(cuda, c, k, monkeypatch):
    """The key split (S forced to 1, 2 and 8 over 32 tiles of 64 keys, the
    last one short, and the card's own S) changes no bit of the Hopper
    kernel's graph, which is sweep_tc's; the cross form of its first 4,096
    query rows against every key is the plain version's.
    ``train-bf16-131k``: the six graph-build inputs of the flagship's bf16
    + remat train step with the TC graph build on one 131,072-point event
    (`_flagship_step_inputs`: the step launched the Hopper TC form for
    every build)."""
    if c is None:
        inputs = _flagship_step_inputs(cuda, **BF16, remat=True)
    else:
        x, mask = _ragged(c + k, b=2, n=2000, c=c, nvalid=(2000, 1500))
        inputs = [(torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda))]
    for xt, mt in inputs:
        outs = []
        for s in (1, 2, 8, None):
            monkeypatch.setattr(kmod, "_splits_override", s)
            outs.append(kmod.knn_cuda(xt, k, mt, return_scores=True, precision="default"))
        for got in outs[1:]:
            for a, b in zip(got, outs[0]):
                assert torch.equal(a, b)
        _same_as_sweep(xt, xt, mt, k, outs[0])
        xq = xt[:, :4096].contiguous()
        _check_tc(xq, xt, mt, kmod.knn_cuda_cross(xq, xt, k, mt, precision="default"),
                  kmod.knn_plain(xq, xt, k, mt, "default"))
        b, n, c2 = xt.shape[0], xt.shape[1], -(-(xt.shape[2] + 2) // 16) * 16
        assert 1 <= kmod.choose_splits(b, n, n, c2, k, cuda, kernel="tc") <= kmod.MAX_SPLITS


@pytest.mark.cuda
def test_hopper_tc_kernel_refuses_what_it_does_not_take(cuda):
    """A forced Hopper launch at a width or k the kernel does not take
    raises; the route sends those shapes to sweep_tc."""
    x, mask = _ragged(5, b=1, n=300, c=kmod.TC_MAX_C2, nvalid=(300,))
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    qa, ka = kmod.build_augmented_operands(xt, xt, mt, "default")
    with pytest.raises(ValueError, match="no TC kernel"):
        kmod.launch_operands(qa, ka, 20, "default", kernel="tc")
    with pytest.raises(ValueError, match="no TC kernel"):
        kmod.launch_operands(qa[..., :8].contiguous(), ka[..., :8].contiguous(), 65, "default",
                             kernel="tc")


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,window", [(4, 20, 64), (64, 20, 256), (3, 8, 700), (64, 96, 300),
                                        (256, 20, 128)])
def test_tc_banded_kernel_matches_plain(cuda, c, k, window):
    x, mask = _ragged(c + window, c=c)
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    before = (bmod.launches_tc, bmod.launches)
    got = bmod.knn_banded_cuda(xt, k, mt, window=window, return_scores=True, precision="default")
    torch.cuda.synchronize()
    assert (bmod.launches_tc, bmod.launches) == (before[0] + 1, before[1])
    _check_tc(xt, xt, mt, got,
              bmod.knn_banded_plain(xt, xt, k, mt, window=window, precision="default"))
    if window >= x.shape[1]:
        # the window past the event: the exact TC kernel's graph, bit for bit
        exact = kmod.knn_cuda(xt, k, mt, return_scores=True, precision="default")
        assert torch.equal(got[0], exact[0]) and torch.equal(got[2], exact[2])


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,p", [(4, 20, 4), (64, 20, 4), (16, 96, 4), (256, 20, 2)])
def test_tc_ring_kernel_matches_plain_and_the_exact_tc_kernel(cuda, c, k, p):
    """Every rank's TC merges against the plain merge of the rounded
    operands, and all ranks together equal to the exact TC kernel's graph,
    index for index (one fragment order: the same score bits)."""
    import functools

    x, mask = _ragged(c + p, n=512, c=c, nvalid=(512, 300, 9, 0))
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    qa, ka = kmod.build_augmented_operands(xt, xt, mt, "default")
    step = functools.partial(rmod.launch_step, precision="default")
    nl = x.shape[1] // p
    idx, valid = [], []
    for me in range(p):
        rows = slice(me * nl, (me + 1) * nl)
        blocks = [(ka[:, o * nl:(o + 1) * nl].contiguous(), o * nl)
                  for o in ((me - s) % p for s in range(p))]
        before = (rmod.launches_tc + rmod.launches_tc_sweep, rmod.launches)
        got = rmod.merge_blocks(qa[:, rows].contiguous(), blocks, k, me * nl, step,
                                return_scores=True)
        torch.cuda.synchronize()
        # a TC launch a ring step of a pass: the Hopper kernel or sweep_tc
        assert (rmod.launches_tc + rmod.launches_tc_sweep, rmod.launches) == (
            before[0] + p * -(-k // rmod.KMAX), before[1])
        ref = rmod.merge_blocks(qa[:, rows].contiguous(), blocks, k, me * nl, rmod.step_plain,
                                return_scores=True)
        _check_tc(xt[:, rows], xt, mt, got, ref)
        idx.append(got[0])
        valid.append(got[1])
    ei, ev = kmod.knn_cuda(xt, k, mt, precision="default")
    assert torch.equal(torch.cat(idx, 1), ei) and torch.equal(torch.cat(valid, 1), ev)


# The ring step's and the banded pass's Hopper TC kernels
# (dgcnn_ring_knn_step_tc, dgcnn_knn_banded_tc on csrc/knn_tc.cuh's
# pipeline) against sweep_tc, their bit reference: indices, valid flags and
# scores ``==``; and against the plain versions and the exact TC kernel.


def _ring_forms(x, mask, k, p):
    """Every rank's merges over P virtual owners of ``x`` by the Hopper
    ring step and by sweep_tc (``kernel`` forced): ``{form: (idx, valid,
    scores)}``, the ranks concatenated, with the launches each form took."""
    import functools

    qa, ka = kmod.build_augmented_operands(x, x, mask, "default")
    nl = x.shape[1] // p
    out = {}
    for form in ("tc", "sweep"):
        step = functools.partial(rmod.launch_step, precision="default", kernel=form)
        before = (rmod.launches_tc, rmod.launches_tc_sweep, rmod.launches)
        ranks = []
        for me in range(p):
            blocks = [(ka[:, o * nl:(o + 1) * nl].contiguous(), o * nl)
                      for o in ((me - s) % p for s in range(p))]
            ranks.append(rmod.merge_blocks(qa[:, me * nl:(me + 1) * nl].contiguous(), blocks, k,
                                           me * nl, step, return_scores=True))
        torch.cuda.synchronize()
        after = (rmod.launches_tc, rmod.launches_tc_sweep, rmod.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (
            (p * p, 0, 0) if form == "tc" else (0, p * p, 0))
        out[form] = tuple(torch.cat([r[i] for r in ranks], 1) for i in range(3))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 64, kmod.TC_MAX_C2 - 2])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_hopper_ring_step_equals_sweep_and_exact(cuda, c, p):
    """The Hopper ring step over P = 1, 2 and 4 owners (ragged events, one
    with 9 valid points) equals sweep_tc's step bit for bit, the plain merge
    up to the rounded scores' near ties, and, all ranks together, the exact
    TC kernel's graph of the whole event."""
    x, mask = _ragged(3 * c + p, n=512, c=c, nvalid=(512, 300, 9, 0))
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    forms = _ring_forms(xt, mt, 20, p)
    for a, b in zip(forms["tc"], forms["sweep"]):
        assert torch.equal(a, b)
    exact = kmod.knn_cuda(xt, 20, mt, return_scores=True, precision="default")
    for a, b in zip(forms["tc"], exact):
        assert torch.equal(a, b)
    qa, ka = kmod.build_augmented_operands(xt, xt, mt, "default")
    ref = rmod.merge_blocks(qa, [(ka, 0)], 20, 0, rmod.step_plain, return_scores=True)
    _check_tc(xt, xt, mt, forms["tc"], ref)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 64, kmod.TC_MAX_C2 - 2])
@pytest.mark.parametrize("k", [1, 20, 32, 33, 64])
def test_hopper_ring_step_ties_take_lowest_indices(cuda, c, k):
    """Every valid point one point: the Hopper ring step keeps the lowest
    valid global indices over 4 owners, as sweep_tc does, bit for bit."""
    x, mask = _all_equal(k + c, n=1024, c=c, nvalid=(1024, 600))
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    forms = _ring_forms(xt, mt, k, 4)
    for a, b in zip(forms["tc"], forms["sweep"]):
        assert torch.equal(a, b)
    gi, gv = (t.cpu().numpy() for t in forms["tc"][:2])
    for e, nv in enumerate(mask.sum(-1)):
        want = np.arange(min(k, nv))
        assert (gi[e, :, :want.size] == want).all() and gv[e, :, :want.size].all()


def _banded_forms(xq, xk, mk, k, window, **band):
    """The banded pass on both TC kernels (forced) from the same operands,
    with the launches each took: ``{form: (idx, valid, scores)}``."""
    qa, ka = kmod.build_augmented_operands(xq, xk, mk, "default")
    nvalid = band.pop("nvalid", None)
    if nvalid is None:
        nvalid = mk.sum(-1).to(torch.int32)
    out = {}
    for form in ("tc", "sweep"):
        before = (bmod.launches_tc, bmod.launches_tc_sweep, bmod.launches)
        out[form] = bmod.launch_operands(qa, ka, nvalid, k, window=window, precision="default",
                                         kernel=form, **band)
        after = (bmod.launches_tc, bmod.launches_tc_sweep, bmod.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (
            (1, 0, 0) if form == "tc" else (0, 1, 0))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,window", [(4, 20, 64), (64, 20, 256), (3, 8, 700), (64, 64, 100),
                                        (kmod.TC_MAX_C2 - 2, 20, 128), (16, 33, 2000)])
def test_hopper_banded_pass_equals_sweep(cuda, c, k, window):
    """The Hopper banded pass on ragged events (700 / 400 / 9 / 0 valid
    points), self form and the halo cross form (nonzero q_base and
    key_base), equals sweep_tc's pass bit for bit and the plain version up
    to near ties; with the window past the event it is the exact TC
    kernel's graph."""
    x, mask = _ragged(c + k + window, c=c)
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    w = min(window, x.shape[1])
    forms = _banded_forms(xt, xt, mt, k, w)
    for a, b in zip(forms["tc"], forms["sweep"]):
        assert torch.equal(a, b)
    _check_tc(xt, xt, mt, forms["tc"],
              bmod.knn_banded_plain(xt, xt, k, mt, window=w, precision="default"))
    got = bmod.knn_banded_cuda(xt, k, mt, window=window, return_scores=True, precision="default")
    for a, b in zip(got, forms["tc"]):
        assert torch.equal(a, b)
    if window >= x.shape[1]:
        exact = kmod.knn_cuda(xt, k, mt, return_scores=True, precision="default")
        for a, b in zip(got, exact):
            assert torch.equal(a, b)
    s0, s1 = 200, 450
    kb, ke = max(s0 - w, 0), min(s1 + w, x.shape[1])
    band = dict(q_base=s0, key_base=kb, nvalid=mt.sum(-1).to(torch.int32))
    xq, xk, mk = xt[:, s0:s1].contiguous(), xt[:, kb:ke].contiguous(), mt[:, kb:ke].contiguous()
    forms = _banded_forms(xq, xk, mk, k, w, **band)
    for a, b in zip(forms["tc"], forms["sweep"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 64, kmod.TC_MAX_C2 - 2])
@pytest.mark.parametrize("k", [1, 20, 32, 33, 64])
def test_hopper_banded_pass_ties_take_lowest_indices(cuda, c, k):
    """Every valid point one point: each row keeps its lowest in-band
    positions, as sweep_tc does, bit for bit, though the tiles are visited
    outward from the diagonal."""
    x, mask = _all_equal(k + 2 * c, n=1000, c=c, nvalid=(1000, 600))
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    window = 256
    forms = _banded_forms(xt, xt, mt, k, window)
    for a, b in zip(forms["tc"], forms["sweep"]):
        assert torch.equal(a, b)
    gi, gv = (t.cpu().numpy() for t in forms["tc"][:2])
    pos = np.arange(x.shape[1])
    for e, nv in enumerate(mask.sum(-1)):
        lo = np.clip(pos - window // 2, 0, max(nv - window, 0))
        count = np.minimum(lo + window, nv) - lo
        for r in range(x.shape[1]):
            m = min(k, count[r])
            assert (gi[e, r, :m] == lo[r] + np.arange(m)).all() and gv[e, r, :m].all()


@pytest.mark.cuda
def test_hopper_ring_and_banded_refuse_what_they_do_not_take(cuda):
    """A misaligned operand and a forced Hopper launch past TC_MAX_C2 raise
    before any launch, in both wrappers."""
    x, mask = _ragged(6, b=1, n=300, c=kmod.TC_MAX_C2, nvalid=(300,))
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    qa, ka = kmod.build_augmented_operands(xt, xt, mt, "default")
    topv, topi = rmod.init_running(1, 300, 20, cuda)
    nvalid = mt.sum(-1).to(torch.int32)
    with pytest.raises(ValueError, match="no TC kernel"):
        rmod.launch_step(qa, ka, 0, topv, topi, precision="default", kernel="tc")
    with pytest.raises(ValueError, match="no TC kernel"):
        bmod.launch_operands(qa, ka, nvalid, 20, window=64, precision="default", kernel="tc")
    q4, k4 = (kmod.tc_operand(t[..., :6].contiguous()) for t in (qa, ka))
    flat = torch.zeros(q4.numel() + 8, dtype=torch.bfloat16, device=cuda)
    skewed = flat[1:1 + q4.numel()].view(q4.shape)
    skewed.copy_(q4)
    before = (rmod.launches_tc, bmod.launches_tc)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rmod.launch_step(skewed, k4, 0, topv, topi, precision="default")
    with pytest.raises(ValueError, match="16-byte aligned"):
        bmod.launch_operands(skewed, k4, nvalid, 20, window=64, precision="default")
    assert (rmod.launches_tc, bmod.launches_tc) == before


@pytest.mark.cuda
def test_bf16_remat_train_step_on_the_card(cuda):
    """Three bf16 + remat train steps of a small model on the card with the
    TC graph build: one TC launch a block a step (2 blocks, 6 steps: 12;
    remat keeps the indices, so none in backward) and none in fp32, a
    finite falling
    loss, and within bf16 reach of the same steps on the CPU on a pinned
    graph (loss within 2e-2 relative: bf16 matmuls sum in other orders on
    the two devices)."""
    from dgcnn_tpu_torch.bridge import tree_map
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO
    from dgcnn_tpu_torch.train.trainval import Trainval

    cfg = Config(num_class=2, kvalue=6, edge_filters=(12, 16), head_feat_dim=24, head_mlp=(16,),
                 minibatch_size=2, num_point=256, optimizer="adam", precision="bfloat16",
                 knn_precision="default", remat=True)
    io = SyntheticIO(num_events=6, num_point=256, seed=3, with_weights=True)
    io.initialize()
    batches = list(BucketBatcher(io, 2, buckets=(256,), shuffle=False).epoch())[:3]
    gpu = Trainval(cfg, device=cuda)
    sg = gpu.initialize(4)
    kmod.launches = kmod.launches_tc = 0
    losses = []
    for batch in batches * 2:
        sg, m = gpu.train_step(sg, batch)
        losses.append(float(m["loss"]))
    assert (kmod.launches_tc, kmod.launches) == (2 * 6, 0)
    assert np.isfinite(losses).all() and losses[3] < losses[0]
    cpu = Trainval(cfg, device="cpu", knn_fn=_ring_graph)
    pin = Trainval(cfg, device=cuda, knn_fn=_ring_graph)
    sc = cpu.initialize(4)
    sp = pin.with_params(tree_map(lambda t: t.clone().to(cuda), sc.params),
                         tree_map(lambda t: t.clone().to(cuda), sc.model_state))
    for batch in batches:
        sc, mc = cpu.train_step(sc, batch)
        sp, mp = pin.train_step(sp, batch)
        assert abs(float(mp["loss"]) - float(mc["loss"])) <= 2e-2 * abs(float(mc["loss"]))


# ------------------------------------------------- long events, banded CP


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("p", [2, 4])
def test_halo_knn_cross_form_matches_plain(cuda, p, precision):
    """`halo_select` on every virtual rank of one card (the operands its
    halo exchange gives, `torch_banded_cp_ranks.rank_operands`): the banded kernel's
    cross form (``q_base`` the band's first position, ``key_base`` W before
    it, cut at 0 on rank 0; the event's ``nvalid``) against the plain
    version of the same band (`knn_banded_plain`, the cross form): the same
    valid flags, 0 hard mismatches, and (fp32) the single-device banded
    kernel's graph on the valid rows."""
    import torch_banded_cp_ranks
    from dgcnn_tpu_torch.kernels import halo_knn as hk
    from dgcnn_tpu_torch.ops.knn import split_score_mismatches

    x, mask = _ragged(p, b=3, n=4096, c=16, nvalid=(4096, 2500, 13))
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    w, k = 512, 20
    whole_i, whole_v = bmod.knn_banded_cuda(xt, k, mt, window=w, precision=precision)
    idx, valid = [], []
    for r in range(p):
        xs, ms, ext, em, nvalid, off = torch_banded_cp_ranks.rank_operands(xt, mt, r, p, w)
        gi, gv = hk.halo_select(xs, k, ms, ext, em, nvalid, window=w, off=off,
                                precision=precision)
        cut = max(w - off, 0)
        ri, rv, _ = bmod.knn_banded_plain(xs, ext[:, cut:], k, em[:, cut:], window=w, q_base=off,
                                          key_base=off - w + cut, nvalid=nvalid,
                                          precision=precision)
        rv = rv & ms[..., None]
        assert torch.equal(gv, rv)
        qa, ka = kmod.build_augmented_operands(xs, xt, mt, precision)
        hard, _ = split_score_mismatches(qa.cpu().numpy(), ka.cpu().numpy(), gi.cpu().numpy(),
                                         ri.cpu().numpy(),
                                         gv.cpu().numpy(), rv.cpu().numpy())
        assert hard == 0
        idx.append(gi)
        valid.append(gv)
    gi, gv = torch.cat(idx, 1), torch.cat(valid, 1)
    m = mt.cpu().numpy()
    assert torch.equal(gv[mt], whole_v[mt])
    if precision == "highest":
        assert torch.equal(gi[mt], whole_i[mt])


@pytest.mark.cuda
def test_streamed_gathered_stats_match_dense_at_131072(cuda, monkeypatch):
    """The fused block's slot-streamed train forward at the flagship's
    131,072-point event (C=64, k=20, past SLOT_STREAM_ELEMS) against the
    dense traversal on the card: ``m`` bitwise, the sums within 1e-5, the
    gradients within 1e-4 of the largest."""
    from dgcnn_tpu_torch.ops import edge as tedge

    n, c, k = 131_072, 64, 20
    assert n * k * c >= tedge.SLOT_STREAM_ELEMS
    g = torch.Generator(device=cuda).manual_seed(0)
    p = torch.randn(1, n, c, device=cuda, generator=g).requires_grad_(True)
    q = torch.randn(1, n, c, device=cuda, generator=g).requires_grad_(True)
    idx = torch.randint(0, n, (1, n, k), device=cuda, generator=g, dtype=torch.int32)
    w = (torch.arange(n, device=cuda) < n - 1000).float()[None]
    gsign = torch.arange(c, device=cuda) % 3 != 1
    cot = [torch.randn(s, device=cuda, generator=g) for s in ((1, n, c), (c,), (c,), (c,))]
    out = []
    for line in (tedge.SLOT_STREAM_ELEMS, 2**40):
        monkeypatch.setattr(tedge, "SLOT_STREAM_ELEMS", line)
        runs = tedge.stream_runs
        got = tedge.GatheredStats.apply(p, q, idx, w, gsign)
        assert tedge.stream_runs == runs + (line < 2**40)
        grads = torch.autograd.grad(sum((o * t).sum() for o, t in zip(got, cot)), (p, q))
        out.append((got, grads))
    (s_out, s_grad), (d_out, d_grad) = out
    assert torch.equal(s_out[0], d_out[0])
    for a, b in zip(s_out[1:], d_out[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.detach().abs().max()))
    for a, b in zip(s_grad, d_grad):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_stream_matches_dense_edge_form(cuda, dtype, monkeypatch):
    """The edge form's slot-streamed eval of one block at 1 x 65,536 (C=64,
    k=20, where the dense gather fits) against the dense edge eval: f32
    bitwise, bf16 within one bf16 unit of the outputs' scale."""
    from dgcnn_tpu_torch.models import ModelSpec, get_model
    from dgcnn_tpu_torch.models import dgcnn as tdgcnn

    n, k = 65_536, 20
    spec = ModelSpec(k=k, edge_filters=(64, 64), residual=True, block_impl="edge",
                     compute_dtype=dtype)
    model = get_model("residual-dgcnn", spec)
    params, state = model.init(4, torch.Generator().manual_seed(1))
    blk_p = {key: v.to(cuda) if torch.is_tensor(v) else v for key, v in params["blocks"][1].items()}
    blk_p["bn"] = {key: v.to(cuda) for key, v in blk_p["bn"].items()}
    blk_s = {key: v.to(cuda) + 0.1 for key, v in state["blocks"][1].items()}
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(1, n, 64, device=cuda, generator=g).to(model.cdtype)
    idx = torch.randint(0, n, (1, n, k), device=cuda, generator=g, dtype=torch.int32)
    mask = torch.ones(1, n, dtype=torch.bool, device=cuda)
    out = []
    with torch.inference_mode():
        for line in (1, 2**40):
            monkeypatch.setattr(tdgcnn, "EDGE_EVAL_STREAM_ELEMS", line)
            runs = tdgcnn.block_forms["edge_stream"]
            out.append(model._block(x, idx, blk_p, blk_s, mask, False)[0].float())
            assert tdgcnn.block_forms["edge_stream"] == runs + (line == 1)
    if dtype == "float32":
        assert torch.equal(out[0], out[1])
    else:
        torch.testing.assert_close(out[0], out[1], rtol=0,
                                   atol=2.0**-7 * float(out[1].abs().max()))


# Context-parallel training on the card: the twins of
# `tests/test_torch_cp_train.py`'s rank tests (that file holds the port
# against the JAX package on the CPU; these hold the card's ranks, which
# launch the kernels, against one process on the card).


def _cp_train_case(data, points):
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO

    base = dict(model_name="residual-dgcnn", num_class=2, kvalue=8, edge_filters=(16, 16),
                head_feat_dim=32, head_mlp=(32,), optimizer="sgd", learning_rate=1e-2,
                minibatch_size=2, point_shards=points, num_devices=data * points)
    bf16_remat = dict(precision="bfloat16", knn_precision="default", remat=True)
    band = dict(knn_window=128, num_point=512)
    cases = {"rdma": dict(cfg=dict(base, ring_impl="rdma")),
             "ppermute": dict(cfg=dict(base, ring_impl="ppermute"), steps=1),
             "banded": dict(cfg=dict(base, **band), halo_gap=True),
             "banded_remat": dict(cfg=dict(base, **band, remat=True), halo_gap=True),
             "rdma_bf16_remat": dict(cfg=dict(base, ring_impl="rdma", **bf16_remat)),
             "ppermute_bf16_remat": dict(cfg=dict(base, ring_impl="ppermute", **bf16_remat)),
             "banded_bf16_remat": dict(cfg=dict(base, **band, **bf16_remat), halo_gap=True)}
    io = SyntheticIO(num_events=2, num_point=512, seed=4).initialize()
    b = next(BucketBatcher(io, 2, num_point=512, shuffle=False).epoch())
    return cases, {"full": (b.points, b.labels, b.weights, b.mask)}


@pytest.mark.cuda
@pytest.mark.parametrize("data,points", [(1, 2), (2, 2)])
def test_cp_train_ranks_on_the_card_match_one(cuda, data, points):
    """CP training on the card (the ranks share it through gloo, or one
    card each under NCCL), on two point ranks and on the 2 x 2 data x
    points mesh: the exact ring by the ring kernel (f32, and bf16 + the
    TC ring + remat through the differentiable ring gather), by the exact
    kernel's cross form (``ppermute``: f32 and TC) and the banded halo
    exchange by the banded kernel's cross form (f32 with and without
    remat, bf16 + remat). On every rank each step launches the case's
    kernel once a block a ring step (the ring, the cross form) or once a
    block (the halo), and no other; the loss finite, and falling over
    several steps; every rank holds the same parameters bit for bit.
    Against one process on the card replaying the ranks' graphs: every
    step's loss within 1e-5 relative and the parameters after the last
    within 1e-4 of the largest (bf16: step 1's loss within 1e-3 and the
    parameters after it within 5e-2, as bf16 features tie at the global
    max pool and the ranks' tie rule sends the cotangent elsewhere). The
    halo exchange's backward at a banded case's block shape and compute
    dtype sends home the plain exchange's cotangents, bit for bit."""
    import torch_cp_train_ranks
    from dgcnn_tpu_torch.bridge import params_from_numpy, params_to_numpy, tree_leaves
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.parallel.launch import run_ranks
    from dgcnn_tpu_torch.train.trainval import Trainval

    cases, batches = _cp_train_case(data, points)
    init = Trainval(Config(**{k: v for k, v in cases["rdma"]["cfg"].items()
                              if k not in ("point_shards", "num_devices")}), device=cuda)
    params, mstate = params_to_numpy(*init.initialize(4)[:2])
    blocks = len(cases["rdma"]["cfg"]["edge_filters"])
    ranks = run_ranks(torch_cp_train_ranks.cp_train, data * points, points, device="cuda",
                      args=(None, cases, params, mstate, batches), timeout=900)
    for name, case in cases.items():
        cfg = case["cfg"]
        tc = cfg.get("knn_precision") == "default"
        if cfg.get("knn_window"):
            want = _want(blocks, "banded", tc=tc)
        else:
            want = _want(blocks * points, "ring" if cfg["ring_impl"] == "rdma" else "knn", tc=tc)
        del want["f32_hopper"]
        got = ranks[0]["cases"][name]
        for r in ranks:
            res = r["cases"][name]
            assert res["launches"] == [want] * case.get("steps", 3), name
            for a, b in zip(res["params"], got["params"]):
                np.testing.assert_array_equal(a, b)
            assert res.get("halo_backward_gap", 0.0) == 0.0, name
        losses = [float(s["loss"]) for s in got["steps"]]
        assert np.isfinite(losses).all() and (len(losses) == 1 or losses[-1] < losses[0]), (
            name, losses)
        graphs = []
        for j in range(len(got["graphs"])):
            rows = [[np.concatenate([np.asarray(ranks[d * points + p]["cases"][name]["graphs"][j][t])
                                     for p in range(points)], axis=1) for t in (0, 1)]
                    for d in range(data)]
            graphs.append(tuple(torch.as_tensor(np.concatenate([r[t] for r in rows]), device=cuda)
                                for t in (0, 1)))
        replay = iter(graphs)
        one = Trainval(Config(**{k: v for k, v in cfg.items()
                                 if k not in ("point_shards", "num_devices", "ring_impl")}),
                       device=cuda, knn_fn=lambda x, k, m: next(replay))
        state = one.with_params(*params_from_numpy(params, mstate, device=cuda))
        bf16 = cfg.get("precision") == "bfloat16"
        for g in losses[:1] if bf16 else losses:
            state, m = one.train_step(state, batches["full"])
            w = float(m["loss"])
            assert abs(g - w) <= (1e-3 if bf16 else 1e-5) * abs(w), (name, g, w)
        want_p = [t.cpu().numpy() for t in tree_leaves(state.params)]
        floor = (5e-2 if bf16 else 1e-4) * max(float(np.abs(w).max()) for w in want_p)
        for a, b in zip(got["params1" if bf16 else "params"], want_p, strict=True):
            np.testing.assert_allclose(a, b, rtol=0, atol=floor, err_msg=name)


@pytest.mark.cuda
def test_cp_collective_gradients_on_the_card(cuda):
    """The differentiable collectives of CP training on the card's ranks
    (staged through pinned host buffers when they share it): each
    gradient equals the unsharded function's in one process, float64."""
    import torch_cp_train_ranks
    from dgcnn_tpu_torch.ops.edge import gather_neighbors
    from dgcnn_tpu_torch.parallel.launch import run_ranks

    p, b, nl, c, k, w = 2, 2, 8, 3, 4, 3
    n = nl * p
    rng = np.random.RandomState(0)
    x = rng.randn(b, n, c)
    mask = rng.rand(b, n) < 0.7
    idx = rng.randint(0, n, (b, n, k))
    shapes = {"ppermute": (b, nl, c), "ppermute_back": (b, nl, c),
              "all_gather_tiled": (b, n, c), "all_gather_stacked": (p, b, nl, c),
              "halo_extend": (b, nl + 2 * w, c), "ring_gather": (b, nl, k, c), "cp_pool": (b, c)}
    cot = {name: rng.randn(p, *s) for name, s in shapes.items()}
    case = dict(x=x, cot=cot, idx_global=idx, mask=mask, window=w)
    ranks = run_ranks(torch_cp_train_ranks.cp_train, p, p, device="cuda",
                      args=(case, {}, None, None, {}), timeout=600)
    xt = torch.tensor(x, requires_grad=True)
    m = torch.tensor(mask)
    shard = lambda t, r: t[:, r * nl:(r + 1) * nl]  # noqa: E731
    outs = {
        "ppermute": lambda r: shard(xt, (r - 1) % p),
        "ppermute_back": lambda r: shard(xt, (r + 1) % p),
        "all_gather_tiled": lambda r: xt,
        "all_gather_stacked": lambda r: torch.stack([shard(xt, q) for q in range(p)]),
        "halo_extend": lambda r: xt[:, torch.arange(r * nl - w, (r + 1) * nl + w) % n],
        "ring_gather": lambda r: gather_neighbors(xt, torch.tensor(shard(idx, r))),
        "cp_pool": lambda r: torch.where(m[..., None], xt, torch.finfo(xt.dtype).min).amax(-2),
    }
    for name, f in outs.items():
        total = sum((f(r) * torch.tensor(cot[name][r])).sum() for r in range(p))
        (g,) = torch.autograd.grad(total, [xt])
        for r in ranks:
            np.testing.assert_allclose(r["collectives"][name], shard(g, r["rank"]).numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_registered_operators_launch_the_kernels(cuda, precision):
    """The graph builds' registered operators (`kernels.ops`) on the card:
    `torch.library.opcheck` on CUDA inputs, and a module exported with
    them, saved and loaded, launches each kernel once a call and gives the
    live wrappers' outputs bit for bit."""
    import io

    from dgcnn_tpu_torch.kernels import ops

    x, mask = _ragged(41, c=8)
    xt, mt = torch.tensor(x, device=cuda), torch.tensor(mask, device=cuda)
    torch.library.opcheck(ops.knn, (xt, 20, mt, precision))
    torch.library.opcheck(ops.knn_banded, (xt, 20, mt, 256, precision))

    class Builds(torch.nn.Module):
        def forward(self, x, mask):
            return (*kmod.knn_cuda(x, 20, mask, return_scores=True, precision=precision),
                    *bmod.knn_banded_cuda(x, 20, mask, window=256, return_scores=True,
                                          precision=precision))

    with torch.no_grad():
        ep = torch.export.export(Builds(), (xt, mt))
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    buf.seek(0)
    served = torch.export.load(buf).module()
    counter = "launches_tc" if precision == "default" else "launches"
    before = (getattr(kmod, counter), getattr(bmod, counter))
    got = served(xt, mt)
    torch.cuda.synchronize()
    assert (getattr(kmod, counter), getattr(bmod, counter)) == (before[0] + 1, before[1] + 1)
    for g, w in zip(got, Builds()(xt, mt)):
        assert torch.equal(g, w)


# ------------------------------------------------ the fused_mlp block's kernels

def _emlp_inputs(cuda, seed, b, n, k, cin, c=64, ragged=None, extra_rows=0):
    """A depth-2 block's pass inputs on the card: ``p``, ``q`` from random
    points through a random first conv, the graph the exact kNN kernel
    builds (``q`` with ``extra_rows`` more rows, an extended operand),
    query weights from ``ragged`` valid counts, BN1's constants, a stacked
    conv and mixed-sign BN2 scales."""
    from dgcnn_tpu_torch.kernels.knn_cuda import knn_cuda

    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(b, n + extra_rows, cin, generator=g, device=cuda)
    w = torch.randn(2 * cin, c, generator=g, device=cuda) / np.sqrt(2 * cin)
    p = (x[:, :n] @ (w[:cin] - w[cin:])).contiguous()
    q = (x @ w[cin:]).contiguous()
    idx, _ = knn_cuda(x, k)
    idx = idx[:, :n].contiguous()
    wts = None
    if ragged is not None:
        wts = (torch.arange(n, device=cuda)[None] < torch.tensor(ragged, device=cuda)[:, None])
        wts = wts.float()
    consts = [0.1 * torch.randn(c, generator=g, device=cuda),
              torch.rand(c, generator=g, device=cuda) + 0.5,
              torch.rand(c, generator=g, device=cuda) + 0.5,
              0.2 * torch.randn(c, generator=g, device=cuda)]
    w2 = torch.randn(c, c, generator=g, device=cuda) / np.sqrt(c)
    gsign = torch.arange(c, device=cuda) % 4 != 0
    return p, q, idx, wts, consts, w2, gsign


def _close(name, got, want, rel=1e-4):
    """``got`` within ``rel`` of the largest entry of ``want`` (float64)."""
    err = float((got.double() - want).abs().max())
    assert err <= rel * float(want.abs().max()), (name, err, float(want.abs().max()))


EMLP_CASES = {
    # name: (B, N, k, C_in, C, ragged valid counts (None: no weights), extra
    # q rows); the cell's shapes with the weights its train step passes
    "cell_cin4": (32, 4096, 20, 4, 64, (4096,) * 32, 0),
    "cell_cin64": (32, 4096, 20, 64, 64, (4096,) * 32, 0),
    "cell_ragged": (32, 4096, 20, 64, 64, tuple(4096 - 131 * i for i in range(31)) + (0,), 0),
    "masked_ragged": (4, 700, 20, 16, 64, (700, 400, 9, 0), 0),
    "partial_chunk_c16": (2, 900, 7, 4, 16, (900, 333), 0),
    "wide_k33_c128": (2, 1000, 33, 8, 128, None, 0),
    "extended_q": (2, 600, 20, 8, 64, (600, 250), 200),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EMLP_CASES))
def test_edge_mlp_kernels_match_plain(cuda, case, monkeypatch):
    """Each of the four passes against its plain version on the same
    inputs, in float64: every output within 1e-4 of the largest entry of
    the plain one, the winners equal but for near ties of ``y2`` (at most
    1e-4 of them), and the backward given the kernel's winners. The plain
    backward runs under BN1's relu masks as float32 rounds them, which are
    the kernel's bits (the same ops in the same order): each mask decides
    a whole term of ``dp``, ``dq`` and BN1's two sums, and float64 would
    flip the odd mask of a near-zero entry."""
    from dgcnn_tpu_torch.kernels import edge_mlp_cuda as emod
    from dgcnn_tpu_torch.ops import edge as edge_ops

    b, n, k, cin, c, ragged, extra = EMLP_CASES[case]
    p, q, idx, w, bn, w2, gsign = _emlp_inputs(cuda, 7, b, n, k, cin, c, ragged, extra)
    d = [t.double() for t in (p, q)]
    wd = None if w is None else w.double()
    bnd = [t.double() for t in bn]
    before = emod.launches
    s1, s2 = emod.stats(p, q, idx, w)
    r1, r2 = edge_ops._mlp_stats_plain(*d, idx, wd)
    _close("stats s1", s1, r1)
    _close("stats s2", s2, r2)
    m, win, t1, t2 = emod.forward(p, q, idx, w, *bn, w2, gsign)
    rm, rwin, rt1, rt2 = edge_ops._mlp_forward_plain(*d, idx, wd, *bnd, w2.double(), gsign)
    _close("forward m", m, rm)
    _close("forward s1", t1, rt1)
    _close("forward s2", t2, rt2)
    assert float((win != rwin).float().mean()) <= 1e-4
    g = torch.Generator(device=cuda).manual_seed(8)
    dm = torch.randn(m.shape, generator=g, device=cuda)
    ds1, ds2 = torch.randn(2, c, generator=g, device=cuda) * 1e-3
    got = emod.backward(p, q, idx, w, *bn, w2, win, dm, ds1, ds2)
    h1_32 = edge_ops._mlp_y1_h1(p, q, idx, *bn)[1]
    y1_h1 = edge_ops._mlp_y1_h1

    def float32_masks(*args):
        y1, h1 = y1_h1(*args)
        return y1, torch.where((h1 > 0) == (h1_32 > 0), h1, h1_32.double())

    with monkeypatch.context() as m:
        m.setattr(edge_ops, "_mlp_y1_h1", float32_masks)
        want = edge_ops._mlp_backward_plain(*d, idx, wd, *bnd, w2.double(), win, dm.double(),
                                            ds1.double(), ds2.double())
    del h1_32
    for name, a, r in zip(("dp", "dq", "sdt", "sdta", "dw2"), got, want):
        _close(f"backward {name}", a, r)
    got = emod.stats_backward(p, q, idx, w, ds1, ds2)
    want = edge_ops._mlp_stats_backward_plain(*d, idx, wd, ds1.double(), ds2.double())
    for name, a, r in zip(("dp", "dq"), got, want):
        _close(f"stats backward {name}", a, r)
    torch.cuda.synchronize()
    assert emod.launches == before + 4


@pytest.mark.cuda
def test_edge_mlp_refuses_what_it_does_not_take(cuda):
    from dgcnn_tpu_torch.kernels import edge_mlp_cuda as emod

    p, q, idx, w, _, _, _ = _emlp_inputs(cuda, 1, 1, 64, 8, 4, 16)
    with pytest.raises(ValueError, match="takes C a multiple of 8"):
        emod.stats(p[..., :12].contiguous(), q[..., :12].contiguous(), idx, w)
    with pytest.raises(ValueError, match="contiguous"):
        emod.stats(p[:, ::2], q, idx[:, ::2], w)


def _semseg_step(cuda, impl, graphs, seed=3, b=4, n=2048):
    """One train-mode forward and backward of the segmentation network
    (blocks of MLP depth 2, 2 and 1, width 64, k=20) on the card under
    ``block_impl=impl``, the graph of each block replayed from ``graphs``
    (recorded on the first call): the loss, the gradients, the new BN
    state and the forms the blocks took."""
    from dgcnn_tpu_torch.bridge import tree_leaves
    from dgcnn_tpu_torch.kernels import edge_mlp_cuda as emod
    from dgcnn_tpu_torch.kernels.knn_cuda import knn_cuda
    from dgcnn_tpu_torch.models import ModelSpec, get_model
    from dgcnn_tpu_torch.models import dgcnn as tdgcnn

    calls = [0]

    def knn_fn(x, k, mask):
        i = calls[0]
        calls[0] += 1
        if len(graphs) <= i:
            graphs.append(knn_cuda(x, k, mask))
        return graphs[i]

    spec = ModelSpec(num_class=2, k=20, edge_filters=(64, 64, 64), head_feat_dim=1024,
                     head_mlp=(512, 256), block_convs=(2, 2, 1), block_impl=impl)
    model = get_model("dgcnn", spec, knn_fn=knn_fn)
    params, state = model.init(4, torch.Generator().manual_seed(seed))
    leaves = [t.to(cuda).requires_grad_(True) for t in tree_leaves(params)]
    from dgcnn_tpu_torch.bridge import tree_unflatten

    live = tree_unflatten(params, leaves)
    state = tree_unflatten(state, [t.to(cuda) for t in tree_leaves(state)])
    g = torch.Generator(device=cuda).manual_seed(seed)
    pts = torch.randn(b, n, 4, generator=g, device=cuda)
    labels = torch.randint(0, 2, (b, n), generator=g, device=cuda)
    mask = torch.arange(n, device=cuda)[None] < torch.tensor([n, n, n // 2, n - 7],
                                                            device=cuda)[:, None]
    before, launches = dict(tdgcnn.block_forms), emod.launches
    logits, new_state = model(live, state, pts, mask, train=True)
    ll = torch.log_softmax(logits, -1).gather(-1, labels[..., None])[..., 0]
    loss = -(ll * mask).sum() / mask.sum()
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    forms = {f: v - before[f] for f, v in tdgcnn.block_forms.items() if v != before[f]}
    return float(loss.detach()), grads, tree_leaves(new_state), forms, emod.launches - launches


@pytest.mark.cuda
def test_semseg_train_step_fused_mlp_matches_edge_on_the_card(cuda, monkeypatch):
    """One train step of the segmentation network under ``auto`` (blocks
    1-2 ``fused_mlp``, four launches each) against ``edge`` on one pinned
    graph: the loss within 1e-5 relative, each leaf's gradient within 2e-3
    of the larger of its norm and the median leaf's (the check's worst-leaf
    rule, inside its sound spread of 1.6e-2), the new BN state within
    1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    graphs = []
    loss_e, grads_e, state_e, forms_e, n_e = _semseg_step(cuda, "edge", graphs)
    loss_f, grads_f, state_f, forms_f, n_f = _semseg_step(cuda, "auto", graphs)
    assert forms_e == {"edge": 3} and n_e == 0
    assert forms_f == {"fused_mlp": 2, "fused": 1} and n_f == 8
    assert abs(loss_f - loss_e) <= 1e-5 * abs(loss_e)
    median = float(np.median([float(g.norm()) for g in grads_e]))
    for i, (a, r) in enumerate(zip(grads_f, grads_e)):
        assert float((a - r).norm()) <= 2e-3 * max(float(r.norm()), median), i
    for a, r in zip(state_f, state_e):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------ the build, ties

@pytest.mark.cuda
def test_kernels_build_without_spills(cuda, tmp_path, monkeypatch):
    """Every hand-written kernel source built afresh, one nvcc each, all
    started together: ptxas reports every kernel instantiation, and none
    has a stack frame or a spill."""
    from dgcnn_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_logs", {})
    names = sorted(f[:-3] for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    assert {"knn", "knn_banded", "ring_knn", "edge_mlp"} <= set(names)
    _build.load_many(names)
    for name in names:
        reports = [line for line in _build.build_logs[name].splitlines() if "spill" in line]
        assert reports, name
        for line in reports:
            assert not any(int(v) for v in re.findall(r"(\d+) bytes", line)), (name, line)


# ------------------------------------------------ the port's paths on the card
# What a run on the card shows beyond the kernels' own tests: the launches
# each path takes, its outputs well formed, and its agreement with the
# CPU, with one device or with the plain graph build, at the smallest
# shapes that take each branch.

# a small flagship-like model that serves; the CP and train tests' models
SERVE_CFG = dict(model_name="residual-dgcnn", num_class=3, kvalue=20, edge_filters=(16, 24, 24),
                 head_feat_dim=64, head_mlp=(32,), minibatch_size=2, num_point=512)
CP_CFG = dict(model_name="residual-dgcnn", num_class=2, kvalue=10, edge_filters=(16, 16),
              head_feat_dim=32, head_mlp=(32,), minibatch_size=1, num_point=1024)
TRAIN_CFG = dict(model_name="residual-dgcnn", num_class=2, kvalue=20, edge_filters=(16, 16),
                 head_feat_dim=64, head_mlp=(32,), minibatch_size=1, num_point=2048,
                 optimizer="adam", learning_rate=1e-3)
BF16 = dict(precision="bfloat16", knn_precision="default")
# the JAX package's train log
CSV_COLUMNS = ["iter", "epoch", "acc", "class_acc0", "class_acc1", "loss", "lr", "val_loss",
               "val_acc", "val_miou", "titer"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launches():
    """Each kernel module's launches (Hopper TC, sweep TC, fp32), and the
    exact kernel's fp32 launches on its Hopper form."""
    out = {name: (m.launches_tc, m.launches_tc_sweep, m.launches)
           for name, m in (("knn", kmod), ("banded", bmod), ("ring", rmod))}
    out["f32_hopper"] = kmod.launches_f32_hopper
    return out


def _rose(before):
    after = _launches()
    return {name: (after[name] - v if name == "f32_hopper" else
                   tuple(a - b for a, b in zip(after[name], v))) for name, v in before.items()}


def _want(n, kernel="knn", tc=False):
    """What `_rose` shows when ``n`` graph builds launched ``kernel`` (its
    Hopper TC form with ``tc``; the exact fp32 builds on its Hopper form)
    and nothing else."""
    out = {name: (0, 0, 0) for name in ("knn", "banded", "ring")}
    out[kernel] = (n, 0, 0) if tc else (0, 0, n)
    out["f32_hopper"] = n if kernel == "knn" and not tc else 0
    return out


def _batches(n, b, seed, num_class=2, variable=(False, True)):
    """`SyntheticIO` batches of ``b`` events padded to ``n`` points: a
    fixed-length one and a variable-length one."""
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO

    out = []
    for i, var in enumerate(variable):
        io = SyntheticIO(num_events=b, num_point=n, num_class=num_class, seed=seed + i,
                         variable_length=var).initialize()
        out += list(BucketBatcher(io, b, num_point=n, shuffle=False).epoch())
    return out


def _check_served(scores, pred, metrics, mask, num_class):
    """Scores finite, each point's summing to 1; predictions in range; a
    finite loss; a confusion matrix that counts every valid point once."""
    s = scores.float()
    assert bool(torch.isfinite(s).all())
    assert float((s.sum(-1) - 1.0).abs().max()) <= 1e-5
    assert 0 <= int(pred.min()) and int(pred.max()) < num_class
    for key in ("loss", "loss_weight", "confusion"):
        assert bool(torch.isfinite(torch.as_tensor(metrics[key])).all()), key
    assert float(torch.as_tensor(metrics["confusion"]).sum()) == float(np.asarray(mask).sum())


def _check_packed(packed, metrics, mask, num_class):
    """`_check_served` of a packed output, whose loss lane holds the loss."""
    packed = torch.as_tensor(packed)
    pred = packed[..., num_class]
    assert torch.equal(pred, torch.round(pred))
    _check_served(packed[..., :num_class], pred.long(), metrics, mask, num_class)
    assert np.allclose(packed[..., num_class + 1].numpy(), np.asarray(metrics["loss"]))


def _seeded(tv, seed=0):
    return tv.initialize(4, generator=torch.Generator().manual_seed(seed))


def _recording(tv):
    """Record every graph ``tv``'s model builds; returns the list."""
    graphs, build = [], tv.model.knn_fn

    def knn(x, k, m):
        graphs.append(build(x, k, m))
        return graphs[-1]

    tv.model.knn_fn = knn
    return graphs


def _logits_match_the_cpu(gpu, state, batches):
    """The card's eval logits (the kernels' graph builds) those of the same
    seeded model on the CPU (the plain oracles): finite, at most 1% of the
    valid points off by more than 1e-3."""
    from dgcnn_tpu_torch.train.trainval import Trainval

    cpu = Trainval(gpu.cfg, device="cpu")
    cstate = _seeded(cpu)
    for batch in batches:
        pts, msk = torch.tensor(batch.points), torch.tensor(batch.mask)
        with torch.inference_mode():
            lc, _ = cpu.model(cstate.params, cstate.model_state, pts, msk)
            lg, _ = gpu.model(state.params, state.model_state, pts.to(gpu.device),
                              msk.to(gpu.device))
        d = (lg.cpu() - lc).abs()[msk]
        assert bool(torch.isfinite(lg).all())
        assert float((d > 1e-3).float().mean()) <= 0.01, float(d.max())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_inference_on_the_card(cuda, precision):
    """Serving (`Trainval.inference`) of a small residual model with the
    exact graph build on a fixed-length and a padded variable-length 2 x
    512 batch: a launch of the exact kernel a block a batch (its Hopper
    fp32 form, or with --precision bfloat16 --knn_precision default its
    Hopper TC form) and no other launch; the outputs well formed; in fp32
    the card's logits those of the same model on the CPU (the plain oracle
    graph build), at most 1% of the valid points off by more than 1e-3."""
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.train.trainval import Trainval

    tc = precision == "bfloat16"
    cfg = Config(**SERVE_CFG, **(BF16 if tc else {}))
    gpu = Trainval(cfg, device=cuda)
    state = _seeded(gpu)
    batches = _batches(512, 2, seed=5, num_class=3)
    assert not batches[-1].mask.all()
    for batch in batches:
        before = _launches()
        scores, pred, metrics = gpu.inference(state, batch)
        torch.cuda.synchronize()
        assert _rose(before) == _want(len(cfg.edge_filters), tc=tc)
        _check_served(scores, pred, metrics, batch.mask, cfg.num_class)
    if not tc:
        _logits_match_the_cpu(gpu, state, batches)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_banded_inference_on_the_card(cuda, precision, monkeypatch):
    """Serving a small banded model (W=256) with the streamed head (four
    chunks a forward) on a full and a padded 4,096-point event: a banded
    launch a block an event (with --precision bfloat16 --knn_precision
    default the Hopper TC pass), no exact or ring launch, the streamed
    head once; the outputs well formed. fp32: the card's logits those of
    the same model on the CPU (the banded oracle), at most 1% of the valid
    points off by more than 1e-3. bf16: every block's eval in the edge
    form's slot stream (its line lowered past the event), whose logits on
    the same graphs are the dense edge form's within 2^-4 of the largest,
    the predictions equal on at least 99.9% of the valid points (the
    stream rounds each block's max to bf16 before the residual, the dense
    form after)."""
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.models import dgcnn as tdgcnn
    from dgcnn_tpu_torch.models import head as thead
    from dgcnn_tpu_torch.train.trainval import Trainval

    tc = precision == "bfloat16"
    n = 4096
    cfg = Config(**dict(SERVE_CFG, minibatch_size=1, num_point=n, knn_window=256,
                        head_stream="on"), **(BF16 if tc else {}))
    blocks = len(cfg.edge_filters)
    monkeypatch.setattr(thead, "HEAD_CHUNK_TARGET_ELEMS", cfg.head_feat_dim * n // 4)
    if tc:
        monkeypatch.setattr(tdgcnn, "EDGE_EVAL_STREAM_ELEMS", 1)
    gpu = Trainval(cfg, device=cuda)
    state = _seeded(gpu)
    events = _batches(n, 1, seed=6, num_class=3)
    for batch in events:
        before, runs, streams = _launches(), thead.runs, tdgcnn.block_forms["edge_stream"]
        scores, pred, metrics = gpu.inference(state, batch)
        torch.cuda.synchronize()
        assert _rose(before) == _want(blocks, "banded", tc=tc)
        assert thead.runs == runs + 1
        assert tdgcnn.block_forms["edge_stream"] == streams + (blocks if tc else 0)
        _check_served(scores, pred, metrics, batch.mask, cfg.num_class)
    if tc:
        pts = torch.tensor(events[-1].points, device=cuda)
        msk = torch.tensor(events[-1].mask, device=cuda)
        build = gpu.model.knn_fn
        graphs = _recording(gpu)
        with torch.inference_mode():
            streamed, _ = gpu.model(state.params, state.model_state, pts, msk)
            replay = iter(graphs)
            gpu.model.knn_fn = lambda x, k, m: next(replay)
            monkeypatch.setattr(tdgcnn, "EDGE_EVAL_STREAM_ELEMS", 2**62)
            dense, _ = gpu.model(state.params, state.model_state, pts, msk)
        gpu.model.knn_fn = build
        streamed, dense = streamed.float()[msk], dense.float()[msk]
        assert float((streamed.argmax(-1) == dense.argmax(-1)).float().mean()) >= 0.999
        assert float((streamed - dense).abs().max()) <= 2**-4 * float(dense.abs().max())
    else:
        _logits_match_the_cpu(gpu, state, events)


@pytest.mark.cuda
def test_full_window_banded_model_is_the_exact_model(cuda):
    """knn_window = N: the banded model (banded kernel) against the exact
    model (exact kernel) from the same weights on a 2 x 512 batch. Both
    kernels score a pair with the same FMA chain, so the first block's
    graph (built from the points), mapped back from Morton order, has the
    exact graph's selected scores and valid flags bit for bit (a tie of
    equal scores may take another key: the sort renumbers the points);
    the logits within 5e-2 of each other and the predictions equal on
    every valid point."""
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.ops.sfc import morton_order
    from dgcnn_tpu_torch.train.trainval import Trainval

    cfg = Config(**SERVE_CFG)
    b, n, k = cfg.minibatch_size, cfg.num_point, cfg.kvalue
    batch = _batches(n, b, seed=7, num_class=3, variable=(False,))[0]
    exact = Trainval(cfg, device=cuda)
    banded = Trainval(dataclasses.replace(cfg, knn_window=n), device=cuda)
    state = _seeded(exact)
    points = torch.tensor(batch.points, device=cuda)
    mask = torch.tensor(batch.mask, device=cuda)
    with torch.inference_mode():
        le, _ = exact.model(state.params, state.model_state, points, mask)
        lb, _ = banded.model(state.params, state.model_state, points, mask)
        _, ve, se = kmod.knn_cuda(points, k, mask, return_scores=True)
        order, pos = morton_order(points, mask)
        xs = torch.gather(points, 1, order[..., None].expand(points.shape)).contiguous()
        _, vb, sb = bmod.knn_banded_cuda(xs, k, torch.gather(mask, 1, order), window=n,
                                         return_scores=True)
        # row j of the batch is row pos[j] in Morton order
        rows = pos[..., None].expand(vb.shape)
        vb, sb = torch.gather(vb, 1, rows), torch.gather(sb, 1, rows)
    assert torch.equal(se, sb) and torch.equal(ve, vb)
    m = mask.bool()
    assert float((le - lb).abs()[m].max()) <= 5e-2
    assert torch.equal(le.argmax(-1)[m], lb.argmax(-1)[m])


def _train_event(n, seed):
    return _batches(n, 1, seed=seed, variable=(False,))[0]


def _flagship_step_inputs(cuda, **flags):
    """The six graph-build inputs ``(x, mask)`` of one train step of the
    flagship (6 x 64, k=20, head 1024 -> 512 -> 256, Adam) on one
    131,072-point event, the shape of the ``train-f32-131k`` cell, with
    the Config fields ``flags``. The step launches the exact kernel's
    Hopper form (fp32, or TC with ``knn_precision="default"``) once a
    block and nothing else."""
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.train.trainval import Trainval

    cfg = Config(**dict(TRAIN_CFG, edge_filters=(64,) * 6, head_feat_dim=1024,
                        head_mlp=(512, 256), num_point=131072, **flags))
    tv = Trainval(cfg, device=cuda)
    state = _seeded(tv)
    inputs, build = [], tv.model.knn_fn

    def recording(x, k, m):
        inputs.append((x.detach().float().contiguous(), m.clone()))
        return build(x, k, m)

    tv.model.knn_fn = recording
    before = _launches()
    tv.train_step(state, _train_event(cfg.num_point, seed=5))
    torch.cuda.synchronize()
    assert _rose(before) == _want(6, tc=cfg.knn_precision == "default")
    assert len(inputs) == 6
    return inputs


@pytest.mark.cuda
def test_train_step_on_the_card_builds_with_the_kernel(cuda):
    """Six Adam steps of a small residual model on one fixed-length
    2,048-point event: every graph build one launch of the exact kernel's
    Hopper fp32 form (a block a step) and no other launch, a finite loss
    that falls. From the same init on the card, the kernel's plain version
    `knn_plain` as the graph build (the same augmented scores through a
    matmul) gives the step-1 loss within 1e-5 relative, and the oracle of
    ``use_pallas=False`` (`ops.knn.knn_indices`: distances assembled as
    |x_i|^2 + |x_j|^2 - 2 x_i.x_j, which orders neighbours a part in a
    thousand apart in its own way) within 1e-3; after the six steps both
    within 1e-2 (the backward's index_add_ sums in the order its atomics
    land, and Adam turns last-bit differences of near-zero gradients into
    steps of about lr)."""
    from dgcnn_tpu_torch.bridge import tree_map
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.train.trainval import Trainval

    cfg = Config(**TRAIN_CFG)
    batch = _train_event(cfg.num_point, seed=3)
    tv = Trainval(cfg, device=cuda)
    state = _seeded(tv)
    init = (tree_map(torch.clone, state.params), tree_map(torch.clone, state.model_state))
    losses = []
    for _ in range(6):
        before = _launches()
        state, m = tv.train_step(state, batch)
        torch.cuda.synchronize()
        assert _rose(before) == _want(len(cfg.edge_filters))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    plain = dataclasses.replace(cfg, use_pallas=False)
    for kw, step1 in ((dict(knn_fn=lambda x, k, mask: kmod.knn_plain(x, x, k, mask)[:2]), 1e-5),
                      (dict(), 1e-3)):
        other = Trainval(plain, device=cuda, **kw)
        ostate = other.with_params(*(tree_map(torch.clone, t) for t in init))
        got = []
        for _ in range(6):
            ostate, m = other.train_step(ostate, batch)
            got.append(float(m["loss"]))
        assert abs(got[0] - losses[0]) <= step1 * abs(got[0]), (got, losses)
        assert abs(got[-1] - losses[-1]) <= 1e-2 * abs(got[-1]), (got, losses)


@pytest.mark.cuda
def test_bf16_remat_lowers_the_peak_on_the_card(cuda):
    """The flagship (6 x 64, k=20, head 1024 -> 512 -> 256) on one
    16,384-point event with --precision bfloat16 --knn_precision default,
    two steps with --remat and two without: a Hopper TC launch a block a
    step either way (remat keeps the indices: no second build) and no
    other launch, finite losses, and a lower peak of device memory with
    remat."""
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.train.trainval import Trainval

    cfg = Config(**dict(TRAIN_CFG, edge_filters=(64,) * 6, head_feat_dim=1024,
                        head_mlp=(512, 256), num_point=16384), **BF16)
    batch = _train_event(cfg.num_point, seed=4)
    peaks = {}
    for remat in (True, False):
        tv = Trainval(dataclasses.replace(cfg, remat=remat), device=cuda)
        state = _seeded(tv)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            before = _launches()
            state, m = tv.train_step(state, batch)
            torch.cuda.synchronize()
            assert _rose(before) == _want(6, tc=True)
            assert np.isfinite(float(m["loss"]))
        peaks[remat] = torch.cuda.max_memory_allocated()
        del tv, state
        torch.cuda.empty_cache()
    assert peaks[True] < peaks[False], peaks


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["exact", "banded_remat"])
def test_streamed_train_step_on_the_card(cuda, case, monkeypatch):
    """The train step's streamed forms, their lines lowered past a small
    event: the fused block's slot-streamed `GatheredStats`
    (`ops.edge.SLOT_STREAM_ELEMS`) in every block and, for the banded
    model with --remat (W=256), the streamed head in train mode and each
    block's streamed forward twice a step (remat's recompute). Each step:
    one launch of the graph build's kernel a block and no other, the
    streamed forms as often as said, a finite loss. On step 1's graph,
    pinned, the loss and gradients (`Trainval.loss_and_grads`) against
    the dense form's (the line raised; the banded model's head with
    head_stream off): the loss within 1e-5 relative, every gradient
    within 1e-4 of the largest gradient entry."""
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.models import head as thead
    from dgcnn_tpu_torch.ops import edge as tedge
    from dgcnn_tpu_torch.train.trainval import Trainval

    banded = case == "banded_remat"
    cfg = Config(**TRAIN_CFG, **(dict(knn_window=256, remat=True, head_stream="on")
                                 if banded else {}))
    blocks = len(cfg.edge_filters)
    monkeypatch.setattr(tedge, "SLOT_STREAM_ELEMS", 1)
    batch = _train_event(cfg.num_point, seed=5)
    tv = Trainval(cfg, device=cuda)
    state = _seeded(tv)
    graphs = _recording(tv)
    for _ in range(2):
        before, runs, streams = _launches(), thead.runs, tedge.stream_runs
        state, m = tv.train_step(state, batch)
        torch.cuda.synchronize()
        assert _rose(before) == _want(blocks, "banded" if banded else "knn")
        assert thead.runs - runs == int(banded)
        assert tedge.stream_runs - streams == (2 if banded else 1) * blocks
        assert np.isfinite(float(m["loss"]))

    def pinned(c):
        replay = iter(graphs[:blocks])
        one = Trainval(c, device=cuda, knn_fn=lambda x, k, mask: next(replay))
        loss, grads, _ = one.loss_and_grads(_seeded(one), batch)
        return float(loss), grads

    streamed = pinned(cfg)
    if banded:
        dense = pinned(dataclasses.replace(cfg, head_stream="off"))
    else:
        monkeypatch.setattr(tedge, "SLOT_STREAM_ELEMS", 2**62)
        dense = pinned(cfg)
    assert abs(streamed[0] - dense[0]) <= 1e-5 * abs(dense[0])
    top = max(float(g.abs().max()) for g in dense[1])
    for a, b in zip(streamed[1], dense[1]):
        assert float((a - b).abs().max()) <= 1e-4 * top


@pytest.mark.cuda
def test_dp_ranks_on_the_card_sync_bn_and_learn(cuda):
    """DP-2 on the card (two ranks sharing it through gloo and pinned host
    buffers; NCCL with a card each), three Adam steps on one batch on a
    pinned graph: every step on every rank one gradient all-reduce, one BN
    statistic collective forward and one backward for each of the model's
    4 train-mode BN layers (2 blocks, the head's feature conv, 1 MLP
    layer), and the psums of the loss and of the metrics; a finite loss
    that falls."""
    import torch_dp_ranks
    from dgcnn_tpu_torch.bridge import params_to_numpy
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.parallel.launch import run_ranks
    from dgcnn_tpu_torch.train.trainval import Trainval

    kw, batches = _dp_case()
    kw = dict(kw, optimizer="adam", learning_rate=1e-3)
    one = Trainval(Config(**kw), device=cuda, knn_fn=torch_dp_ranks.port_ring)
    params, mstate = params_to_numpy(*one.initialize(4)[:2])
    ranks = run_ranks(torch_dp_ranks.train_cases, 2, device="cuda",
                      args=([dict(kw, num_devices=2)], params, mstate, [batches[0]] * 3,
                            batches[0]), timeout=600)
    want = {"grads": 1, "psum": 2, "psum_autograd": 4, "psum_autograd_backward": 4}
    for r in ranks:
        steps = r["cases"][0]["steps"]
        for s in steps:
            assert {k: v for k, v in s["collectives"].items() if v} == want, s
        losses = [float(s["loss"]) for s in steps]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def _port_command(args, cwd):
    """``python -m <args>`` in a child process with this checkout on its
    path, on the card; its standard output (exit 0 required)."""
    path = [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    res = subprocess.run([sys.executable, "-m", *args], cwd=cwd, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join(path)), timeout=600)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    return res.stdout


def _csv_rows(path):
    import csv

    with open(path) as f:
        rows = list(csv.DictReader(f))
    with open(path) as f:
        return f.readline().strip().split(","), rows


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_cli_on_the_card(cuda, tmp_path, precision, capsys):
    """The command line on the card, one process (-nd 1), a small residual
    model: `info` (the card, the native DGB reader), `io.convert synth` (a
    DGB file of 8 fixed-length 512-point events and a validation npz of 4)
    and a `train -i 2` as child processes; then `cli.main` here: train 6
    steps with validation (reports at 2, 4 and 6 with a validation batch
    each, checkpoints at 3 and 6), the native DGB reader assembling every
    batch, the exact kernel launched once a block a step and a validation
    batch (bf16 with --knn_precision default and --remat: its Hopper TC
    form) and no other; the CSV log with the JAX package's columns and
    finite losses and validation values; the last checkpoint restored and
    saved again to the same bytes; --auto_resume on to step 8; `inference`
    with write-back (a launch a block a batch), every event written, equal
    to `restore_for_eval` + `Trainval.inference` of the same batches here
    (predictions equal, scores within 1e-6)."""
    from dgcnn_tpu_torch import cli
    from dgcnn_tpu_torch.config import parse_args
    from dgcnn_tpu_torch.io import BucketBatcher
    from dgcnn_tpu_torch.io import dgb as dgb_mod
    from dgcnn_tpu_torch.io.dgb import DGBIO
    from dgcnn_tpu_torch.train import checkpoint
    from dgcnn_tpu_torch.train.checkpoint import adopt_model_flags
    from dgcnn_tpu_torch.train.trainval import Trainval

    tc = precision == "bfloat16"
    n, events, blocks = 512, 8, 2
    info = _port_command(["dgcnn_tpu_torch", "info"], tmp_path)
    assert "C++ batch assembler active" in info and torch.cuda.get_device_name(0) in info
    for name, count, seed in (("events.dgb", events, 0), ("val.npz", 4, 1)):
        _port_command(["dgcnn_tpu_torch.io.convert", "synth", name, "--events", str(count),
                       "--points", str(n), "--fixed_length", "--seed", str(seed)], tmp_path)

    def p(*names):
        return str(tmp_path.joinpath(*names))

    flags = ["--precision", "bfloat16", "--knn_precision", "default"] if tc else []
    data = ["-io", "dgb", "-if", p("events.dgb"), "-np", str(n), "-mn", "residual-dgcnn", "-k",
            "20", "--edge_filters", "16", "16", "--head_feat_dim", "32", "--head_mlp", "32",
            "-mb", "2", "-nd", "1", *flags]
    train = ["train", *data, "-rs", "2", "-cs", "3", "-wp", p("w", "snap"), "-ld", p("log"),
             *(["--remat"] if tc else [])]
    _port_command(["dgcnn_tpu_torch", "train", *data, *(["--remat"] if tc else []), "-i", "2",
                   "-wp", p("sub", "snap"), "-ld", p("sub")], tmp_path)
    assert os.path.exists(p("sub", "snap-2.ckpt"))

    before, native = _launches(), dgb_mod.native_batches
    assert cli.main(train + ["-i", "6", "-vf", p("val.npz"), "--val_batches", "1"]) == 0
    torch.cuda.synchronize()
    assert _rose(before) == _want(blocks * (6 + 3), tc=tc)
    # read ahead: the prefetch queue's batches
    assert 6 <= dgb_mod.native_batches - native <= 6 + 4
    header, rows = _csv_rows(p("log", "train_log.csv"))
    assert header == CSV_COLUMNS
    assert [int(r["iter"]) for r in rows] == [2, 4, 6]
    assert all(np.isfinite(float(r[key])) for r in rows
               for key in ("loss", "val_loss", "val_acc", "val_miou"))
    assert all(os.path.exists(p("w", f"snap-{s}.ckpt")) for s in (3, 6))

    tv = Trainval(parse_args(train + ["-i", "6"]))
    tree, step, saved = checkpoint.restore(p("w", "snap-6.ckpt"),
                                           tv.state_tree(tv.initialize(4)))
    state = tv.load_tree(tree)
    again = checkpoint.save(p("again", "snap"), step, tv.state_tree(state), saved)
    assert step == state.step == 6
    with open(p("w", "snap-6.ckpt"), "rb") as f, open(again, "rb") as g:
        assert f.read() == g.read()

    capsys.readouterr()
    assert cli.main(train + ["-i", "8", "--auto_resume"]) == 0
    assert "restored checkpoint at step 6" in capsys.readouterr().out
    assert [int(r["iter"]) for r in _csv_rows(p("log", "train_log.csv"))[1]] == [2, 4, 6, 8]
    assert os.path.exists(p("w", "snap-8.ckpt"))

    before = _launches()
    assert cli.main(["inference", *data, "-mp", p("w", "snap"), "-of", p("pred.npz"), "-ld",
                     p("ilog")]) == 0
    torch.cuda.synchronize()
    assert _rose(before) == _want(blocks * events // 2, tc=tc)
    pred = np.load(p("pred.npz"))
    off = pred["offsets"]
    assert pred["event_ids"].tolist() == list(range(events)) and (np.diff(off) == n).all()
    assert pred["scores"].shape == (events * n, 2) and np.isfinite(pred["scores"]).all()
    icfg = adopt_model_flags(parse_args(["inference", "-mb", "2", "-mp", p("w", "snap"),
                                         *flags]), p("w", "snap"))
    tv = Trainval(icfg)
    state, _ = tv.restore_for_eval(tv.initialize(4), p("w", "snap"))
    reader = DGBIO(p("events.dgb")).initialize()
    for batch in BucketBatcher(reader, 2, shuffle=False, seed=icfg.seed).epoch():
        scores, pr, _ = tv.inference(state, batch)
        for j, eid in enumerate(batch.event_ids):
            lo, hi = off[eid], off[eid + 1]
            np.testing.assert_array_equal(pr[j, :hi - lo].cpu().numpy(),
                                          pred["prediction"][lo:hi])
            np.testing.assert_allclose(scores[j, :hi - lo].cpu().numpy(), pred["scores"][lo:hi],
                                       rtol=0, atol=1e-6)
    reader.finalize()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dp", "mesh"])
def test_parallel_cli_on_the_card(cuda, tmp_path, layout):
    """The command line over ranks on the card (ranks that share one card
    run gloo through pinned host buffers; NCCL with a card a rank), a
    small residual model on a DGB file of 8 fixed-length 512-point events:
    ``dp`` trains with -nd 2 (4 steps, reports at 2 and 4, a checkpoint at
    4), resumes with --auto_resume to 6 and serves with -nd 2; ``mesh``
    trains the data x points layout, -nd 4 -ps 2 (the exact ring), and
    serves with -nd 2 -ps 2. One log file, written by world rank 0 alone
    (no duplicated row), finite losses; every event written once; the
    served predictions those of one process serving the same checkpoint
    (-nd 1), its scores within 1e-6 (dp) or 1e-5 (mesh: each point rank's
    matmuls run at another shape)."""
    from dgcnn_tpu_torch import cli
    from dgcnn_tpu_torch.io import SyntheticIO
    from dgcnn_tpu_torch.io.dgb import write_dgb

    io = SyntheticIO(num_events=8, num_point=512, seed=3, variable_length=False).initialize()
    write_dgb(str(tmp_path / "ev.dgb"), [io.read_event(i) for i in range(8)])

    def p(*names):
        return str(tmp_path.joinpath(*names))

    data = ["-io", "dgb", "-if", p("ev.dgb"), "-np", "512", "-mn", "residual-dgcnn", "-k", "10",
            "--edge_filters", "16", "16", "--head_feat_dim", "32", "--head_mlp", "32", "-mb",
            "2", "--seed", "3", "-wp", p("w", "s")]
    ranks = {"dp": (["-nd", "2"], ["-nd", "2"]),
             "mesh": (["-nd", "4", "-ps", "2"], ["-nd", "2", "-ps", "2"])}[layout]
    train = ["train", *data, "-ld", p("log"), *ranks[0]]
    assert cli.main(train + ["-i", "4", "-rs", "2", "-cs", "4"]) == 0
    want = [2, 4]
    if layout == "dp":
        assert cli.main(train + ["-i", "6", "-rs", "2", "-cs", "0", "--auto_resume"]) == 0
        want = [2, 4, 6]
    assert os.listdir(p("log")) == ["train_log.csv"]
    rows = _csv_rows(p("log", "train_log.csv"))[1]
    assert [int(r["iter"]) for r in rows] == want
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    assert os.path.exists(p("w", f"s-{want[-1]}.ckpt"))
    for name, nd in (("ranks", ranks[1]), ("one", ["-nd", "1"])):
        assert cli.main(["inference", *data, "-mp", p("w", "s"), "-of", p(f"{name}.npz"), "-ld",
                         p(f"ilog_{name}"), *nd]) == 0
        assert os.listdir(p(f"ilog_{name}")) == ["inference_log.csv"]
    got, one = np.load(p("ranks.npz")), np.load(p("one.npz"))
    assert sorted(got["event_ids"].tolist()) == list(range(8))
    np.testing.assert_array_equal(got["event_ids"], one["event_ids"])
    np.testing.assert_array_equal(got["prediction"], one["prediction"])
    np.testing.assert_allclose(got["scores"], one["scores"], rtol=0,
                               atol=1e-6 if layout == "dp" else 1e-5)


def _cp_serve(cuda, kw, points):
    """The seeded init of the model of ``kw`` (as numpy), a full and a
    padded 1 x 1,024 event, and `torch_cp_ranks.card_inference` of both
    on ``points`` ranks sharing the card (NCCL with a card a rank)."""
    import torch_cp_ranks
    from dgcnn_tpu_torch.bridge import params_to_numpy
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.parallel.launch import run_point_ranks
    from dgcnn_tpu_torch.train.trainval import Trainval

    params, mstate = params_to_numpy(*_seeded(Trainval(Config(**kw), device=cuda))[:2])
    events = _batches(kw["num_point"], 1, seed=8)
    batches = [(b.points, b.labels, b.weights, b.mask) for b in events]
    ranks = run_point_ranks(torch_cp_ranks.card_inference, points, device="cuda",
                            args=(dict(kw, point_shards=points), params, mstate, batches),
                            timeout=600)
    return params, mstate, events, ranks


def _check_cp_runs(runs, batch, want, num_class=2):
    """Every rank's launches ``want`` and the same packed output, well
    formed."""
    for run in runs:
        assert run["launches"] == want
        np.testing.assert_array_equal(run["packed"], runs[0]["packed"])
    _check_packed(runs[0]["packed"], runs[0]["metrics"], batch.mask, num_class)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_cp_inference_on_the_card_matches_one_device(cuda, precision):
    """CP serving with the exact ring (ring_impl rdma) over 4 ranks that
    share the card (gloo through pinned host buffers; NCCL with a card a
    rank) on a full and a padded 1,024-point event: on every rank a ring
    launch a block a ring step (with --knn_precision default the Hopper TC
    ring step) and no exact or banded one; the packed outputs identical on
    every rank and well formed; the first block's graph over the ranks
    that of one device from the same weights (the exact kernel on the
    whole event; with the TC score the exact TC kernel's, index for
    index). In fp32 also the ppermute ring's first graph the rdma ring's,
    and one device's scores within 1e-4 and its predictions equal
    wherever the top-two logit margin exceeds 1e-4 (with the TC score a
    rank's features differ from one device's in the last bit, which can
    flip a later block's bf16 operand and so a near-tied neighbour)."""
    from dgcnn_tpu_torch.bridge import params_from_numpy
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.train.trainval import Trainval

    kw = dict(CP_CFG, ring_impl="rdma", knn_precision=precision)
    params, mstate, events, ranks = _cp_serve(cuda, kw, 4)
    want = _want(len(kw["edge_filters"]) * 4, "ring", tc=precision == "default")
    del want["f32_hopper"]
    one = Trainval(Config(**dict(CP_CFG, knn_precision=precision)), device=cuda)
    state = one.with_params(*params_from_numpy(params, mstate, device=cuda))
    build = one.model.knn_fn
    for i, batch in enumerate(events):
        runs = [r["runs"][i] for r in ranks]
        _check_cp_runs(runs, batch, want)
        points = torch.tensor(batch.points, device=cuda)
        mask = torch.tensor(batch.mask, device=cuda)
        graphs = _recording(one)
        with torch.inference_mode():
            logits, _ = one.model(state.params, state.model_state, points, mask)
        one.model.knn_fn = build
        v = batch.mask  # the valid rows
        for t in (0, 1):
            first = np.concatenate([np.asarray(run["graphs"][0][t]) for run in runs], 1)
            np.testing.assert_array_equal(first[v], graphs[0][t].cpu().numpy()[v])
            if precision == "highest":
                ppermute = np.concatenate([np.asarray(run["ppermute"][t]) for run in runs], 1)
                np.testing.assert_array_equal(ppermute[v], first[v])
        if precision == "highest":
            packed = runs[0]["packed"]
            np.testing.assert_allclose(packed[..., :2][v],
                                       torch.softmax(logits, -1).cpu().numpy()[v], rtol=0,
                                       atol=1e-4)
            top2 = torch.topk(logits, 2, dim=-1).values
            decided = ((top2[..., 0] - top2[..., 1]) > 1e-4).cpu().numpy() & v
            np.testing.assert_array_equal(packed[..., 2][decided],
                                          logits.argmax(-1).cpu().numpy()[decided])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_banded_cp_inference_on_the_card_matches_one_device(cuda, precision):
    """Banded CP serving (W=128, the halo exchange) over 4 ranks sharing
    the card on a full and a padded 1,024-point event: on every rank the
    banded kernel's cross form once a block an event (with --knn_precision
    default its Hopper TC pass) and no exact or ring launch; the packed
    outputs identical on every rank and well formed. Against the
    one-device banded model from the same weights: the predictions equal
    and the scores within 1e-5 (1e-3 with the bf16 score: a last bit of a
    rank's matmul, at another shape than one device's, can flip the bf16
    rounding of an operand and so a near-tied neighbour of a later
    block); the first graph over the ranks the one-device banded kernel's
    on the valid rows (0 hard mismatches by the points' distances, with
    the TC score by the rounded operands' scores); the one-device model on
    the ranks' graphs within 1e-5 of the ranks' scores, the predictions
    equal."""
    from dgcnn_tpu_torch.bridge import params_from_numpy
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.ops.knn import split_score_mismatches
    from dgcnn_tpu_torch.ops.sfc import morton_order
    from dgcnn_tpu_torch.train.trainval import Trainval

    tc = precision == "default"
    kw = dict(CP_CFG, knn_window=128, knn_precision=precision)
    blocks, k = len(kw["edge_filters"]), kw["kvalue"]
    params, mstate, events, ranks = _cp_serve(cuda, kw, 4)
    want = _want(blocks, "banded", tc=tc)
    del want["f32_hopper"]
    one = Trainval(Config(**kw), device=cuda)
    state = one.with_params(*params_from_numpy(params, mstate, device=cuda))
    build = one.model.knn_fn
    for i, batch in enumerate(events):
        runs = [r["runs"][i] for r in ranks]
        _check_cp_runs(runs, batch, want)
        got = runs[0]["packed"][0]
        single, _ = one.inference_packed(state, batch)
        single = single.cpu().numpy()[0]
        v = batch.mask[0]
        np.testing.assert_allclose(got[v, :2], single[v, :2], rtol=0, atol=1e-3 if tc else 1e-5)
        np.testing.assert_array_equal(got[v, 2], single[v, 2])

        # the ranks' graphs are in the model's Morton order
        x = torch.tensor(batch.points, device=cuda)
        m = torch.tensor(batch.mask, device=cuda)
        order, _ = morton_order(x, m)
        xs = torch.gather(x, 1, order[..., None].expand(x.shape)).contiguous()
        ms = torch.gather(m, 1, order)
        mn = ms.cpu().numpy()[..., None]
        cp = [tuple(torch.as_tensor(np.concatenate([np.asarray(run["graphs"][b][t])
                                                    for run in runs], 1), device=cuda)
                    for t in (0, 1)) for b in range(blocks)]
        wi, wv, _ = bmod.knn_banded_cuda(xs, k, ms, window=128, return_scores=True,
                                         precision=precision)
        gi, gv = (t.cpu().numpy() for t in cp[0])
        wi, wv = wi.cpu().numpy(), wv.cpu().numpy()
        np.testing.assert_array_equal(gv & mn, wv & mn)
        gi, wi = np.where(mn, gi, 0), np.where(mn, wi, 0)
        if tc:
            qa, ka = kmod.build_augmented_operands(xs, xs, ms, "default")
            hard, _ = split_score_mismatches(qa.cpu().numpy(), ka.cpu().numpy(), gi, wi, gv & mn,
                                             wv & mn, rtol=TC_RTOL)
        else:
            hard, _ = split_mismatches(xs.cpu().numpy(), gi, wi, gv & mn, wv & mn)
        assert hard == 0

        replay = iter(cp)
        one.model.pre_sorted, one.model.knn_fn = True, lambda xx, kk, mm: next(replay)
        with torch.inference_mode():
            logits, _ = one.model(state.params, state.model_state, xs, ms)
        one.model.pre_sorted, one.model.knn_fn = False, build
        replayed = torch.softmax(logits.float(), -1)[0].cpu().numpy()
        got_sorted = got[order[0].cpu().numpy()]
        v0 = mn[0, :, 0]
        np.testing.assert_allclose(replayed[v0], got_sorted[v0, :2], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(replayed[v0].argmax(-1), got_sorted[v0, 2])


def _artifact_calls(path):
    """The call targets of an exported program's graph and its
    submodules'."""
    out = []
    for gm in torch.export.load(path).graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            out += [str(node.target) for node in gm.graph.nodes if node.op == "call_function"]
    return out


# name: (model flags, export flags, the graph build's kernel, its TC form)
EXPORT_CASES = {
    "exact": (dict(), ["-mb", "2"], "knn", False),
    "exact_any_batch": (dict(), ["-mb", "0"], "knn", False),
    "exact_tc": (BF16, ["-mb", "2", "--precision", "bfloat16", "--knn_precision", "default"],
                 "knn", True),
    "banded": (dict(knn_window=256), ["-mb", "1", "--knn_window", "256"], "banded", False),
    "banded_tc": (dict(knn_window=256, **BF16), ["-mb", "1", "--knn_window", "256",
                                                 "--precision", "bfloat16", "--knn_precision",
                                                 "default"], "banded", True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EXPORT_CASES))
def test_exported_artifact_on_the_card_matches_live(cuda, tmp_path, case):
    """`export` through the command line on the card, from a checkpoint
    of a seeded small residual model: the artifact's graph holds one
    registered graph-build operator a block (dgcnn_tpu_torch::knn, or
    ::knn_banded with its one Morton sort) and no inlined top-k; loaded
    with `load_exported`, it serves a fixed-length and a padded batch (a
    symbolic batch also one event of each) with scores within 1e-6 of
    `Trainval.inference`'s and the same argmax on the valid points, each
    batch launching its row's kernel (the exact fp32 kernel, its Hopper TC
    form, the banded kernel, its Hopper TC pass) once a block and nothing
    else."""
    from dgcnn_tpu_torch import cli
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.train import checkpoint
    from dgcnn_tpu_torch.train.export import load_exported
    from dgcnn_tpu_torch.train.trainval import Trainval

    flags, argv, kernel, tc = EXPORT_CASES[case]
    banded = kernel == "banded"
    n, b = (1024, 1) if banded else (512, 2)
    cfg = Config(**dict(SERVE_CFG, num_class=2, minibatch_size=b, num_point=n, **flags))
    blocks = len(cfg.edge_filters)
    tv = Trainval(cfg, device=cuda)
    state = _seeded(tv)
    ck = checkpoint.save(str(tmp_path / "w" / "s"), 1, tv.state_tree(state), vars(cfg))
    path = str(tmp_path / "model.pt2")
    assert cli.main(["export", "-mp", ck, "-np", str(n), "-mn", "residual-dgcnn", "-k", "20",
                     "--edge_filters", "16", "24", "24", "--head_feat_dim", "64", "--head_mlp",
                     "32", *argv, "-of", path]) == 0
    calls = _artifact_calls(path)
    op = f"dgcnn_tpu_torch.{'knn_banded' if banded else 'knn'}.default"
    assert calls.count(op) == blocks
    assert not [c for c in calls if "topk" in c]
    assert len([c for c in calls if "sort" in c]) == int(banded)
    serve = load_exported(path)
    served = [(x.points, x.labels, x.weights, x.mask) for x in _batches(n, b, seed=9)]
    if case == "exact_any_batch":
        served += [tuple(None if a is None else a[:1] for a in x) for x in served]
    for points, labels, weights, mask in served:
        live, pred, _ = tv.inference(state, (points, labels, weights, mask))
        p, m = torch.tensor(points, device=cuda), torch.tensor(mask, device=cuda)
        before = _launches()
        got = serve(p, m)
        torch.cuda.synchronize()
        assert _rose(before) == _want(blocks, kernel, tc=tc)
        assert bool(torch.isfinite(got).all())
        assert float((got - live).abs().max()) <= 1e-6
        assert torch.equal(got.argmax(-1)[m], pred.long()[m])
