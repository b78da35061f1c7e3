"""The long-event paths of one device against the JAX package (ROADMAP
queue 1, item 11): the fused block's slot-streamed train forward
(`ops.edge.GatheredStats` past `SLOT_STREAM_ELEMS`), the streamed head's
train-mode statistics sweeps (`models.head.head_streamed(train=True)`)
and the edge form's slot-streamed eval (`models.dgcnn.Model` past
`EDGE_EVAL_STREAM_ELEMS`).

Each case patches the size line low in both packages, so a small input
takes the streamed path in each. Tolerances: max, min and the winning
slots of the streamed forward are bitwise (max is exact and the strict
compares keep the first winner, as the dense ``max`` does); its sums are
reassociated (rtol 1e-5) and so its gradients (rtol 1e-4). The train-mode
head's statistics differ from JAX's by the order of f32 sums (the new BN
state rtol 1e-5, gradients rtol 1e-4 relative to the largest gradient
entry). The f32 edge
stream is bitwise the port's dense edge eval and within 2e-5 of JAX's
stream (the frozen-oracle tolerance: two libraries' matmuls); the bf16
one within one bf16 unit of the block outputs' scale of JAX's. The whole
train step runs both packages on one pinned graph (the JAX graph
recorded and replayed), train-mode comparisons need one (ROADMAP queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.models import ModelSpec as JaxSpec
from dgcnn_tpu.models import dgcnn as jdgcnn
from dgcnn_tpu.models import get_model as jax_get_model
from dgcnn_tpu.models import head as jhead
from dgcnn_tpu.ops import edge as jedge
from dgcnn_tpu.ops.knn import banded_knn_indices as jax_banded
from dgcnn_tpu.ops.knn import knn_indices as jax_knn
from dgcnn_tpu_torch.bridge import params_from_numpy, tree_leaves, tree_unflatten
from dgcnn_tpu_torch.models import ModelSpec, get_model
from dgcnn_tpu_torch.models import dgcnn as tdgcnn
from dgcnn_tpu_torch.models import head as thead
from dgcnn_tpu_torch.ops import edge as tedge


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------ A1: GatheredStats streamed

def _stats_inputs(seed, b=2, n=40, c=6, k=7):
    """Tie-free neighbour values (a permutation of distinct values), a
    graph with distinct neighbours per row, a ragged weight."""
    rng = np.random.RandomState(seed)
    p = rng.randn(b, n, c).astype(np.float32)
    q = (rng.permutation(b * n * c).reshape(b, n, c) / (b * n * c) - 0.5).astype(np.float32)
    idx = np.stack([np.stack([rng.choice(n, k, replace=False) for _ in range(n)])
                    for _ in range(b)]).astype(np.int32)
    w = (np.arange(n)[None] < np.array([[n], [n // 2]])).astype(np.float32)
    gsign = np.arange(c) % 3 != 1
    return p, q, idx, w, gsign


@pytest.mark.parametrize("weighted", [False, True], ids=["w_none", "w_ragged"])
def test_gathered_stats_streamed_matches_jax(monkeypatch, weighted):
    p, q, idx, w, gsign = _stats_inputs(3)
    w = w if weighted else None
    monkeypatch.setattr(jedge, "SLOT_STREAM_ELEMS", 1)
    monkeypatch.setattr(tedge, "SLOT_STREAM_ELEMS", 1)
    jw = None if w is None else jnp.asarray(w)
    cot = [np.random.RandomState(5).randn(*s).astype(np.float32)
           for s in ((2, 40, 6), (6,), (6,), (6,))]

    def jfn(pp, qq):
        outs = jedge.gathered_stats(pp, qq, jnp.asarray(idx), jw, jnp.asarray(gsign))
        return sum(jnp.sum(o * jnp.asarray(cv)) for o, cv in zip(outs, cot)), outs

    (_, want), (jdp, jdq) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(p), jnp.asarray(q))
    _, (_, _, _, _, jaw, _) = jedge._gathered_stats_fwd(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(idx), jw, jnp.asarray(gsign))

    tp = torch.tensor(p, requires_grad=True)
    tq = torch.tensor(q, requires_grad=True)
    tw = None if w is None else torch.tensor(w)
    got = tedge.GatheredStats.apply(tp, tq, torch.tensor(idx), tw, torch.tensor(gsign))
    dp, dq = torch.autograd.grad(sum((o * torch.tensor(cv)).sum() for o, cv in zip(got, cot)),
                                 (tp, tq))
    np.testing.assert_array_equal(got[0].detach().numpy(), np.asarray(want[0]))
    for g, wv in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(wv), rtol=1e-5, atol=1e-6)
    # the winning slots, by gamma's sign, bitwise JAX's residual
    mx, ax, mn, an, _, _ = tedge._stats_streamed(torch.tensor(q), torch.tensor(idx), tw)
    aw = torch.where(torch.tensor(gsign), ax, an)
    assert aw.dtype == torch.uint8
    np.testing.assert_array_equal(aw.numpy(), np.asarray(jaw))
    for g, wv in ((dp, jdp), (dq, jdq)):
        top = float(np.abs(np.asarray(wv)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-4, atol=1e-6 * top)
    # the streamed port against its own dense traversal
    monkeypatch.setattr(tedge, "SLOT_STREAM_ELEMS", 2**27)
    dense = tedge.GatheredStats.apply(tp, tq, torch.tensor(idx), tw, torch.tensor(gsign))
    assert torch.equal(dense[0], got[0])
    dmx, dax = tedge.gather_neighbors(torch.tensor(q), torch.tensor(idx)).max(dim=-2)
    assert torch.equal(dmx, mx) and torch.equal(dax.to(torch.uint8), ax)


def _close_grads(grads, want):
    """Every gradient within rtol 1e-4, relative to the largest entry of
    them all (a leaf whose gradient cancels to rounding noise, as a
    weight ahead of train-mode BN's mean, is held at that scale)."""
    top = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-4, atol=1e-4 * top)


# ------------------------------------------ A2: the streamed head in train

HSPEC = dict(num_class=3, k=6, edge_filters=(8, 12), head_feat_dim=24, head_mlp=(16, 8))
HB = 2
# 24 channels x 2 events x 16 rows: chunks of 16 rows
HCHUNK = 24 * HB * 16


def _head_tree(seed, n, global_pool=True):
    spec = JaxSpec(**HSPEC, global_pool=global_pool)
    params, state = _np(jdgcnn.make_model(spec).init(jax.random.PRNGKey(seed), 4))
    rng = np.random.RandomState(seed)
    hp = params["head"]
    for p in [hp["feat"]] + list(hp["mlp"]):
        d = p["bn"]["scale"].shape[0]
        p["bn"]["scale"] = (rng.uniform(0.3, 1.5, d) * rng.choice([-1.0, 1.0], d)).astype(np.float32)
        p["bn"]["bias"] = (rng.randn(d) * 0.2).astype(np.float32)
    feats = [rng.randn(HB, n, c).astype(np.float32) for c in HSPEC["edge_filters"]]
    return params, state, feats


HEAD_CASES = {
    f"{pool}_{fac}_{m}": (pool == "pool", fac == "factorized", m == "ragged")
    for pool in ("pool", "nopool") for fac in ("concat", "factorized")
    for m in ("nomask", "ragged")
    if not (pool == "nopool" and fac == "factorized")
}


@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_head_streamed_train_matches_jax(monkeypatch, case):
    """Train-mode streamed head in 6 chunks of 16 rows against JAX's
    (N = 96, a whole number of chunks: JAX's padded masked tail is a fault
    of the reference, ROADMAP queue 3)."""
    pool, factorized, ragged = HEAD_CASES[case]
    monkeypatch.setattr(jhead, "HEAD_CHUNK_TARGET_ELEMS", HCHUNK)
    monkeypatch.setattr(thead, "HEAD_CHUNK_TARGET_ELEMS", HCHUNK)
    n = 96
    params, state, feats = _head_tree(4, n, pool)
    mask = (np.arange(n)[None] < np.array([[n], [61]])) if ragged else None
    jspec = JaxSpec(**HSPEC, global_pool=pool, head_factorized=factorized)
    cot = np.random.RandomState(6).randn(HB, n, 3).astype(np.float32)

    def jfn(hp, fs):
        logits, new_s = jhead.head_streamed(
            hp, jax.tree_util.tree_map(jnp.asarray, state["head"]), fs,
            None if mask is None else jnp.asarray(mask), spec=jspec, cdtype=jnp.float32,
            precision=jax.lax.Precision.HIGHEST, bn_axis=None, pool_fn=jdgcnn._masked_max_points,
            rng=None, train=True)
        return jnp.sum(logits * cot), new_s

    (_, want_s), (jgp, jgf) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params["head"]), [jnp.asarray(f) for f in feats])

    tp, ts = params_from_numpy(params, state)
    hp = tp["head"]
    leaves = tree_leaves(hp)
    tfeats = [torch.tensor(f, requires_grad=True) for f in feats]
    for t in leaves:
        t.requires_grad_(True)
    spec = ModelSpec(**HSPEC, global_pool=pool, head_factorized=factorized)
    logits, got_s = thead.head_streamed(hp, ts["head"], tfeats,
                                        None if mask is None else torch.tensor(mask),
                                        spec=spec, train=True)
    grads = torch.autograd.grad((logits * torch.tensor(cot)).sum(), leaves + tfeats)
    for g, w in zip(tree_leaves(got_s), jax.tree_util.tree_leaves(want_s)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgp)] + [np.asarray(g) for g in jgf]
    assert len(grads) == len(want)
    _close_grads(grads, want)


def test_head_streamed_train_padded_tail_matches_dense(monkeypatch):
    """The port's own padded masked tail (N = 100, not a whole number of
    16-row chunks), held against its dense train head: logits, new state
    and every gradient within the sums' reassociation."""
    monkeypatch.setattr(thead, "HEAD_CHUNK_TARGET_ELEMS", HCHUNK)
    n = 100
    params, state, feats = _head_tree(5, n)
    mask = torch.tensor(np.arange(n)[None] < np.array([[n], [61]]))
    tp, ts = params_from_numpy(params, state)
    spec = ModelSpec(**HSPEC)
    cot = torch.tensor(np.random.RandomState(7).randn(HB, n, 3).astype(np.float32))
    out = []
    for stream in (True, False):
        leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(tp["head"])]
        hp = tree_unflatten(tp["head"], leaves)
        tfeats = [torch.tensor(f, requires_grad=True) for f in feats]
        if stream:
            logits, new_s = thead.head_streamed(hp, ts["head"], tfeats, mask, spec=spec,
                                                train=True)
        else:
            dense = get_model("residual-dgcnn", dataclasses.replace(spec, head_stream="off"))
            logits, new_s = dense._dense_head(hp, ts["head"], tfeats, mask, train=True)
        out.append((logits, new_s, torch.autograd.grad((logits * cot).sum(), leaves + tfeats)))
    (l0, s0, g0), (l1, s1, g1) = out
    np.testing.assert_allclose(l0.detach().numpy(), l1.detach().numpy(), rtol=1e-5, atol=1e-5)
    for a, b in zip(tree_leaves(s0), tree_leaves(s1)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-6)
    _close_grads(g0, g1)


def test_head_streamed_train_dropout_is_one_mask_a_layer_and_chunk(monkeypatch):
    """Dropout draws one seed a (layer, chunk) from the generator, so the
    statistics sweeps, the logits sweep and the backward's recompute of a
    checkpointed chunk all see one mask: the gradients equal those of the
    same run with the chunks not checkpointed, and some entries drop."""
    monkeypatch.setattr(thead, "HEAD_CHUNK_TARGET_ELEMS", HCHUNK)
    n = 96
    params, state, feats = _head_tree(6, n)
    tp, ts = params_from_numpy(params, state)
    spec = ModelSpec(**HSPEC, dropout=0.5)

    def run(spec):
        leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(tp["head"])]
        logits, _ = thead.head_streamed(tree_unflatten(tp["head"], leaves), ts["head"],
                                        [torch.tensor(f) for f in feats], None, spec=spec,
                                        train=True, generator=torch.Generator().manual_seed(11))
        return logits, torch.autograd.grad(logits.square().sum(), leaves)

    logits, grads = run(spec)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", lambda fn, *a, **kw: fn(*a))
    plain_logits, plain_grads = run(spec)
    assert torch.equal(logits, plain_logits)
    assert all(torch.equal(a, b) for a, b in zip(grads, plain_grads))
    undropped, _ = run(dataclasses.replace(spec, dropout=0.0))
    assert not torch.allclose(undropped, logits)


# -------------------------------------------- A3: the edge form's eval stream

ESPEC = dict(num_class=3, k=6, edge_filters=(8, 12), head_feat_dim=24, head_mlp=(16,))
EDGE_CASES = {
    "f32_edge": dict(block_impl="edge"),
    "f32_block_convs2": dict(block_convs=2),
    "bf16": dict(compute_dtype="bfloat16"),
    "bf16_block_convs2": dict(compute_dtype="bfloat16", block_convs=2),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edge_stream_eval_matches_dense_and_jax(monkeypatch, case):
    """One block's eval output (a one-block model, the head's input) past
    the patched line: f32 bitwise the port's dense edge eval and within
    2e-5 of JAX's stream; bf16 within one bf16 unit of JAX's stream."""
    spec_kw = {**ESPEC, **EDGE_CASES[case], "edge_filters": (8,)}
    bf16 = spec_kw.get("compute_dtype") == "bfloat16"
    rng = np.random.RandomState(8)
    pts = rng.randn(2, 48, 4).astype(np.float32)
    mask = np.arange(48)[None] < np.array([[48], [30]])
    graphs = []

    def record(x, k, m):
        idx, valid = jax_knn(x.astype(jnp.float32), k, m)
        graphs.append((np.asarray(idx), np.asarray(valid)))
        return idx, valid

    jmodel = jax_get_model("residual-dgcnn", JaxSpec(**spec_kw), knn_fn=record)
    params, state = _np(jmodel.init(jax.random.PRNGKey(1), 4))
    state = jax.tree_util.tree_map(lambda a: a + 0.1, state)  # non-trivial running stats
    feats = {}
    real_head = jdgcnn.head_streamed

    def spy(hp, hs, block_feats, m, **kw):
        feats["jax"] = np.asarray(block_feats[0]).astype(np.float32)
        return real_head(hp, hs, block_feats, m, **kw)

    monkeypatch.setattr(jdgcnn, "head_streamed", spy)
    monkeypatch.setattr(jdgcnn, "EDGE_EVAL_STREAM_ELEMS", 1)
    jmodel = jax_get_model("residual-dgcnn", JaxSpec(**spec_kw, head_stream="on"),
                           knn_fn=record)
    jmodel.apply(params, state, jnp.asarray(pts), jnp.asarray(mask), train=False)
    idx, valid = graphs[-1]

    model = get_model("residual-dgcnn", ModelSpec(**spec_kw),
                      knn_fn=lambda x, k, m: (torch.tensor(idx), torch.tensor(valid)))
    tp, ts = params_from_numpy(params, state)
    blk = tp["blocks"][0], ts["blocks"][0]

    def port_block(line):
        monkeypatch.setattr(tdgcnn, "EDGE_EVAL_STREAM_ELEMS", line)
        x = torch.tensor(pts).to(model.cdtype)
        with torch.no_grad():
            return model._block(x, torch.tensor(idx), *blk, torch.tensor(mask), False)[0]

    streamed, dense = port_block(1), port_block(2**31)
    m = mask
    if not bf16:
        assert torch.equal(streamed, dense)
        np.testing.assert_allclose(streamed.numpy()[m], feats["jax"][m], rtol=0, atol=2e-5)
    else:
        assert streamed.dtype == torch.bfloat16
        got = streamed.float().numpy()
        unit = 2.0 ** -7 * float(np.abs(feats["jax"][m]).max())
        np.testing.assert_allclose(got[m], feats["jax"][m], rtol=0, atol=unit)


# ------------------------------------------- the whole train step, pinned

TSPEC = dict(num_class=3, k=6, edge_filters=(16, 16, 16), head_feat_dim=40, head_mlp=(32, 16))
STEP_CASES = {"exact": {}, "banded": dict(knn_window=16)}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_past_both_lines_matches_jax(monkeypatch, case):
    """One train step of a small flagship-shaped model (residual, 3
    blocks, head 40 -> 32 -> 16) with the fused block's slot stream and the
    streamed head (4 chunks of 16 rows) engaged in both packages, on the
    JAX graph replayed: the loss and every gradient within rtol 1e-4 (of
    the largest entry), the new BN state within 1e-5."""
    spec_kw = {**TSPEC, **STEP_CASES[case]}
    n = 64
    for mod in (jedge, tedge):
        monkeypatch.setattr(mod, "SLOT_STREAM_ELEMS", 1)
    for mod in (jhead, thead):
        monkeypatch.setattr(mod, "HEAD_CHUNK_TARGET_ELEMS", 40 * 16)
    monkeypatch.setattr(jdgcnn, "HEAD_STREAM_ELEMS", 1)
    monkeypatch.setattr(thead, "HEAD_STREAM_ELEMS", 1)
    rng = np.random.RandomState(12)
    pts = rng.randn(1, n, 4).astype(np.float32)
    mask = np.arange(n)[None] < 57
    labels = rng.randint(0, 3, (1, n)).astype(np.int32)
    graphs = []
    oracle = ((lambda x, k, m: jax_banded(x, k, m, window=spec_kw["knn_window"]))
              if "knn_window" in spec_kw else jax_knn)

    def record(x, k, m):
        idx, valid = oracle(x, k, m)
        graphs.append((np.asarray(idx), np.asarray(valid)))
        return idx, valid

    jmodel = jax_get_model("residual-dgcnn", JaxSpec(**spec_kw), knn_fn=record)
    params, state = jmodel.init(jax.random.PRNGKey(2), 4)

    def jloss(p):
        logits, new_s = jmodel.apply(p, state, jnp.asarray(pts), jnp.asarray(mask), train=True)
        logp = jax.nn.log_softmax(logits, axis=-1)
        ll = jnp.take_along_axis(logp, jnp.asarray(labels)[..., None], axis=-1)[..., 0]
        w = jnp.asarray(mask, jnp.float32)
        return -jnp.sum(ll * w) / jnp.sum(w), new_s

    (want_loss, want_s), jgrad = jax.value_and_grad(jloss, has_aux=True)(params)
    assert jmodel.block_impl == "fused"
    replay = iter(graphs[:len(TSPEC["edge_filters"])])
    model = get_model("residual-dgcnn", ModelSpec(**spec_kw),
                      knn_fn=lambda x, k, m: tuple(torch.tensor(a) for a in next(replay)))
    tp, ts = params_from_numpy(*_np((params, state)))
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    runs = thead.runs
    logits, got_s = model(tp, ts, torch.tensor(pts), torch.tensor(mask), train=True)
    assert thead.runs == runs + 1 and model.block_impl == "fused"
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, torch.tensor(labels).long()[..., None])[..., 0]
    w = torch.tensor(mask).float()
    loss = -torch.sum(ll * w) / torch.sum(w)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrad)]
    assert len(grads) == len(want)
    _close_grads(grads, want)
    for g, wv in zip(tree_leaves(got_s), jax.tree_util.tree_leaves(want_s)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(wv), rtol=1e-5, atol=1e-6)
