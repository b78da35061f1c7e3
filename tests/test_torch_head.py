"""The port's streamed head (eval) against the JAX package's
`head_streamed` and against the port's own dense head.

Both packages' chunk targets are patched down so an event of 96 or 100
points splits into several chunks of 16 rows (at 100, with a padded
tail). Against JAX the tolerance is 2e-5
absolute (the frozen-oracle tolerance: the two libraries' matmuls sum in
different orders). Against the port's dense head the test asserts bitwise
equality: every row's math is the same and the pool commutes with BN +
relu exactly; a BLAS could sum a short and a long product differently,
which this test would catch on the CPU it runs on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.models import ModelSpec as JaxSpec
from dgcnn_tpu.models import dgcnn as jdgcnn
from dgcnn_tpu.models import head as jhead
from dgcnn_tpu_torch.bridge import params_from_numpy
from dgcnn_tpu_torch.models import ModelSpec, get_model
from dgcnn_tpu_torch.models import head as thead

SPEC = dict(num_class=3, k=6, edge_filters=(8, 12), head_feat_dim=24, head_mlp=(16, 8))
B = 3
# 24 channels x 3 events x 16 rows: chunks of 16 rows
CHUNK_TARGET = 24 * 3 * 16


def _mask(name, n):
    if name == "none":
        return None
    return np.arange(n)[None] < np.array([[n], [61], [0]])  # ragged, an empty event


def _jax_head(params, state, feats, mask, jspec):
    return jhead.head_streamed(
        jax.tree_util.tree_map(jnp.asarray, params["head"]),
        jax.tree_util.tree_map(jnp.asarray, state["head"]),
        [jnp.asarray(f) for f in feats],
        None if mask is None else jnp.asarray(mask),
        spec=jspec, cdtype=jnp.float32, precision=jax.lax.Precision.HIGHEST, bn_axis=None,
        pool_fn=jdgcnn._masked_max_points, rng=None, train=False,
    )[0]


def _tree(seed, n):
    """JAX-initialised head params, BN scales of mixed sign, non-trivial
    running statistics; block features from a numpy seed."""
    spec = JaxSpec(**SPEC)
    params, state = jax.tree_util.tree_map(
        np.asarray, jdgcnn.make_model(spec).init(jax.random.PRNGKey(seed), 4)
    )
    rng = np.random.RandomState(seed)
    head_p, head_s = params["head"], state["head"]
    for p, s in [(head_p["feat"], head_s["feat"])] + list(zip(head_p["mlp"], head_s["mlp"])):
        d = p["bn"]["scale"].shape[0]
        p["bn"]["scale"] = (rng.uniform(0.3, 1.5, d) * rng.choice([-1.0, 1.0], d)).astype(np.float32)
        p["bn"]["bias"] = (rng.randn(d) * 0.2).astype(np.float32)
        s["mean"] = (rng.randn(d) * 0.3).astype(np.float32)
        s["var"] = rng.uniform(0.5, 2.0, d).astype(np.float32)
    feats = [rng.randn(B, n, c).astype(np.float32) for c in SPEC["edge_filters"]]
    return params, state, feats


@pytest.mark.parametrize("factorized", [False, True])
@pytest.mark.parametrize("mask_name,n", [("none", 100), ("ragged", 96)])
def test_head_streamed_matches_jax_and_dense(monkeypatch, factorized, mask_name, n):
    monkeypatch.setattr(jhead, "HEAD_CHUNK_TARGET_ELEMS", CHUNK_TARGET)
    monkeypatch.setattr(thead, "HEAD_CHUNK_TARGET_ELEMS", CHUNK_TARGET)
    assert thead._chunk_geometry(n, B, SPEC["head_feat_dim"]) == (16, -(-n // 16), -n % 16)
    mask = _mask(mask_name, n)
    params, state, feats = _tree(1, n)
    want = _jax_head(params, state, feats, mask, JaxSpec(**SPEC, head_factorized=factorized))
    tp, ts = params_from_numpy(params, state)
    spec = ModelSpec(**SPEC, head_factorized=factorized)
    tfeats = [torch.tensor(f) for f in feats]
    tmask = None if mask is None else torch.tensor(mask)
    runs = thead.runs
    got, _ = thead.head_streamed(tp["head"], ts["head"], tfeats, tmask, spec=spec)
    assert thead.runs == runs + 1
    assert got.shape == (B, n, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    dense = get_model("residual-dgcnn", dataclasses.replace(spec, head_stream="off"))
    assert torch.equal(got, dense._dense_head(tp["head"], ts["head"], tfeats, tmask)[0])


def test_head_streamed_masked_padded_tail(monkeypatch):
    """A mask and a padded last chunk together: the port pads the point
    axis (mask False on the pad) and gives its dense head's logits. The
    JAX function pads the mask's batch axis instead
    (`dgcnn_tpu/models/head.py:85-90,147-149`: `_pad_points` pads axis -2
    of any 2-d array) and fails on a shape error, so this case has no JAX
    reference; it is reached only where N is not a whole number of
    chunks, which the JAX package's million-point sizes avoid."""
    monkeypatch.setattr(jhead, "HEAD_CHUNK_TARGET_ELEMS", CHUNK_TARGET)
    monkeypatch.setattr(thead, "HEAD_CHUNK_TARGET_ELEMS", CHUNK_TARGET)
    n = 100
    mask = _mask("ragged", n)
    params, state, feats = _tree(3, n)
    with pytest.raises(ValueError, match="broadcast"):
        _jax_head(params, state, feats, mask, JaxSpec(**SPEC))
    tp, ts = params_from_numpy(params, state)
    spec = ModelSpec(**SPEC)
    tfeats = [torch.tensor(f) for f in feats]
    got, _ = thead.head_streamed(tp["head"], ts["head"], tfeats, torch.tensor(mask), spec=spec)
    dense = get_model("residual-dgcnn", dataclasses.replace(spec, head_stream="off"))
    assert torch.equal(got, dense._dense_head(tp["head"], ts["head"], tfeats, torch.tensor(mask))[0])


def test_head_streamed_without_global_pool(monkeypatch):
    """No pool: the feature conv becomes the first layer of the chunked
    ladder."""
    monkeypatch.setattr(jhead, "HEAD_CHUNK_TARGET_ELEMS", CHUNK_TARGET)
    monkeypatch.setattr(thead, "HEAD_CHUNK_TARGET_ELEMS", CHUNK_TARGET)
    n = 96
    _, _, feats = _tree(2, n)
    mask = _mask("ragged", n)
    jspec = JaxSpec(**SPEC, global_pool=False)
    # without the pool the MLP takes head_feat_dim inputs
    jparams, jstate = jax.tree_util.tree_map(
        np.asarray, jdgcnn.make_model(jspec).init(jax.random.PRNGKey(2), 4)
    )
    want = _jax_head(jparams, jstate, feats, mask, jspec)
    tp, ts = params_from_numpy(jparams, jstate)
    spec = ModelSpec(**SPEC, global_pool=False)
    tfeats = [torch.tensor(f) for f in feats]
    got, _ = thead.head_streamed(tp["head"], ts["head"], tfeats, torch.tensor(mask), spec=spec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    dense = get_model("residual-dgcnn", dataclasses.replace(spec, head_stream="off"))
    assert torch.equal(got, dense._dense_head(tp["head"], ts["head"], tfeats, torch.tensor(mask))[0])


def test_chunk_geometry_matches_jax(monkeypatch):
    for target in (2**27, 1000, 7):
        monkeypatch.setattr(jhead, "HEAD_CHUNK_TARGET_ELEMS", target)
        monkeypatch.setattr(thead, "HEAD_CHUNK_TARGET_ELEMS", target)
        for n, b, w in ((1_048_576, 1, 1024), (100, 3, 24), (5, 2, 1), (4096, 4, 1024)):
            assert thead._chunk_geometry(n, b, w) == jhead._chunk_geometry(n, b, w)
