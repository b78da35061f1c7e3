"""The edge form's slot-stream guard in train mode, against the JAX package.

`EDGE_EVAL_STREAM_ELEMS` (2^31 gather elements) switches the edge form to
its slot-streamed eval. The reference streams only in eval and only for
local gathers (`dgcnn_tpu/models/dgcnn.py`, ``not train and gather_fn is
None``); a train step keeps the dense edge form at any size. The port's
guard is the same. Here the line is patched to 128 in both packages, so a
1 x 32-point step is far past it, and a train step on the edge form
(``block_impl="edge"``, ``block_convs=2``, and every bf16 model) gives the
JAX package's loss and gradients on one pinned graph: f32 at rtol 1e-4 with
a floor of 1e-6 of the largest gradient entry (the tolerance of
`tests/test_torch_train_model.py`), bf16 within 5% of the largest gradient
entry and the loss within 1e-2 relative (that of
`tests/test_torch_precision.py`). The eval forward under the same patch
streams one slot at a time, as the JAX package's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.models import ModelSpec as JaxSpec
from dgcnn_tpu.models import dgcnn as jdgcnn
from dgcnn_tpu.models import get_model as jax_get_model
from dgcnn_tpu.ops.knn import knn_indices as jax_knn
from dgcnn_tpu_torch.bridge import params_from_numpy, tree_leaves
from dgcnn_tpu_torch.models import ModelSpec, get_model
from dgcnn_tpu_torch.models import dgcnn as tdgcnn

SMALL = dict(num_class=3, k=8, edge_filters=(16, 24), head_feat_dim=40, head_mlp=(32,))
LINE = 128  # gather elements: 1 x 32 points x k=8 x 16 channels is 4096

CASES = {
    "edge": dict(block_impl="edge"),
    # the stacked per-edge convs in the edge form (auto trains a depth-2
    # f32 block as fused_mlp, tests/test_torch_edge_mlp.py)
    "block_convs2": dict(block_convs=2, block_impl="edge"),
    "bf16_edge": dict(compute_dtype="bfloat16"),
}


def _inputs(seed=11, n=32, f=4):
    rng = np.random.RandomState(seed)
    pts = rng.randn(1, n, f).astype(np.float32)
    mask = np.ones((1, n), dtype=bool)
    mask[0, -3:] = False
    labels = rng.randint(0, SMALL["num_class"], (1, n)).astype(np.int32)
    return pts, mask, labels


def _ce(logits, labels, mask, xp):
    """Masked mean cross entropy in numpy-like namespace ``xp``."""
    if xp is torch:
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels[..., None])[..., 0]
        w = mask.float()
        return -torch.sum(ll * w) / torch.clamp(torch.sum(w), min=1e-9)
    logp = jax.nn.log_softmax(logits, axis=-1)
    ll = jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0]
    w = mask.astype(jnp.float32)
    return -jnp.sum(ll * w) / jnp.maximum(jnp.sum(w), 1e-9)


@pytest.fixture
def low_line(monkeypatch):
    monkeypatch.setattr(jdgcnn, "EDGE_EVAL_STREAM_ELEMS", LINE)
    monkeypatch.setattr(tdgcnn, "EDGE_EVAL_STREAM_ELEMS", LINE)


@pytest.mark.parametrize("case", sorted(CASES))
def test_edge_form_trains_past_the_stream_line(case, low_line):
    spec_kw = {**SMALL, **CASES[case]}
    bf16 = spec_kw.get("compute_dtype") == "bfloat16"
    pts, mask, labels = _inputs()
    graphs = []

    def record(x, k, m):
        idx, valid = jax_knn(x, k, m)
        graphs.append((np.asarray(idx), np.asarray(valid)))
        return idx, valid

    jmodel = jax_get_model("residual-dgcnn", JaxSpec(**spec_kw), knn_fn=record)
    params, state = jmodel.init(jax.random.PRNGKey(0), pts.shape[-1])

    def jloss(p):
        logits, _ = jmodel.apply(p, state, jnp.asarray(pts), jnp.asarray(mask), train=True)
        return _ce(logits, jnp.asarray(labels), jnp.asarray(mask), jnp)

    want_loss, jgrad = jax.value_and_grad(jloss)(params)
    # the JAX gradient pass may trace the forward again: replay one forward's
    replay = iter(graphs[:len(SMALL["edge_filters"])])

    def knn(x, k, m):
        idx, valid = next(replay)
        return torch.tensor(idx), torch.tensor(valid)

    model = get_model("residual-dgcnn", ModelSpec(**spec_kw), knn_fn=knn)
    tp, ts = params_from_numpy(*jax.tree_util.tree_map(np.asarray, (params, state)))
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    logits, _ = model(tp, ts, torch.tensor(pts), torch.tensor(mask), train=True)
    loss = _ce(logits, torch.tensor(labels).long(), torch.tensor(mask), torch)
    grads = torch.autograd.grad(loss, leaves)
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrad)]
    assert len(grads) == len(want)
    top = max(float(np.abs(w).max()) for w in want)
    if bf16:
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-2)
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=0.05 * top)
    else:
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6 * top)


def test_edge_form_eval_past_the_line_still_raises(low_line):
    """(The name is kept from when the eval half raised "item 11".) The
    eval half of the same guard streams, as the JAX package does: on JAX
    parameters and the JAX graph replayed, the streamed eval logits are
    within 2e-5 of JAX's streamed eval (the frozen-oracle tolerance), and
    the train forward keeps the dense edge form."""
    pts, mask, _ = _inputs()
    graphs = []

    def record(x, k, m):
        idx, valid = jax_knn(x, k, m)
        graphs.append((np.asarray(idx), np.asarray(valid)))
        return idx, valid

    spec_kw = {**SMALL, "block_impl": "edge"}
    jmodel = jax_get_model("residual-dgcnn", JaxSpec(**spec_kw), knn_fn=record)
    params, state = jmodel.init(jax.random.PRNGKey(0), pts.shape[-1])
    want, _ = jmodel.apply(params, state, jnp.asarray(pts), jnp.asarray(mask), train=False)
    replay = iter(graphs)
    model = get_model("residual-dgcnn", ModelSpec(**spec_kw),
                      knn_fn=lambda x, k, m: tuple(torch.tensor(a) for a in next(replay)))
    tp, ts = params_from_numpy(*jax.tree_util.tree_map(np.asarray, (params, state)))
    got, _ = model(tp, ts, torch.tensor(pts), torch.tensor(mask))
    np.testing.assert_allclose(got.numpy()[mask], np.asarray(want)[mask], rtol=0, atol=2e-5)
    model = get_model("residual-dgcnn", ModelSpec(**spec_kw))
    out, _ = model(tp, ts, torch.tensor(pts), torch.tensor(mask), train=True)
    assert out.shape == (1, 32, SMALL["num_class"]) and torch.isfinite(out).all()
