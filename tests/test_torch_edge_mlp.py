"""The ``fused_mlp`` block form (`ops.edge.edgeconv_block_fused_mlp`) on the
CPU, where its four passes are the plain versions of the kernels in
`kernels.edge_mlp_cuda`: against the edge form of `Model._block` on one
block of MLP depth 2 at small shapes, and its two autograd Functions
against numerical derivatives.

On the CPU the new form's forward computes the edge form's tensors in the
same op order, and BN2 and relu of the winning ``y2`` equal the max of BN2
and relu over the edges (the chain is monotone per channel), so the output
and the new BN state are equal bit for bit. The backward is the
Functions' own algebra, so the gradients agree to float32 rounding: within
1e-5 of the largest entry of each."""

import dataclasses

import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.kernels import edge_mlp_cuda
from dgcnn_tpu_torch.models import ModelSpec, get_model
from dgcnn_tpu_torch.models import dgcnn as tdgcnn
from dgcnn_tpu_torch.ops.edge import EdgeMLP, EdgeStats

B, N = 2, 48
CASES = {
    # name: (C_in, k, mask, a negative gamma2 channel, a forced tie)
    "cin4_k4": (4, 4, False, False, False),
    "cin4_k20": (4, 20, False, False, False),
    "cin8_k4_masked": (8, 4, True, False, False),
    "cin8_k20_masked": (8, 20, True, False, False),
    "cin4_k20_masked_neg_gamma2": (4, 20, True, True, False),
    "cin8_k4_tie": (8, 4, False, False, True),
    "cin4_k20_masked_neg_gamma2_tie": (4, 20, True, True, True),
}


def _case(name, width=16):
    """A depth-2 block's parameters, state, input, graph and mask for
    ``name``; BN scales of mixed sign where the case asks for a negative
    gamma2, and a graph whose first two slots are one neighbour where it
    asks for a tie (two edges with equal ``y2`` on every channel)."""
    cin, k, masked, neg, tie = CASES[name]
    g = torch.Generator().manual_seed(sum(map(ord, name)))
    spec = ModelSpec(num_class=2, k=k, edge_filters=(width,), head_feat_dim=8, head_mlp=(8,),
                     block_convs=2)
    params, state = get_model("dgcnn", spec).init(cin, g)
    blk, st = params["blocks"][0], state["blocks"][0]
    for bn in (blk["bn"], blk["extra"][0]["bn"]):
        bn["scale"] = torch.rand(width, generator=g) + 0.5
        bn["bias"] = 0.3 * torch.randn(width, generator=g)
    if neg:
        blk["extra"][0]["bn"]["scale"][::3] *= -1.0
    for s in (st["main"], st["extra"][0]):
        s["mean"] = 0.2 * torch.randn(width, generator=g)
        s["var"] = torch.rand(width, generator=g) + 0.5
    x = torch.randn(B, N, cin, generator=g)
    idx = torch.stack([torch.stack([torch.randperm(N, generator=g)[:k] for _ in range(N)])
                       for _ in range(B)])
    if tie:
        idx[..., 1] = idx[..., 0]
    mask = None
    if masked:
        mask = torch.ones(B, N, dtype=torch.bool)
        mask[1, -9:] = False
    return spec, blk, st, x, idx.to(torch.int32), mask


def _leaves(blk):
    return [blk["w"], blk["bn"]["scale"], blk["bn"]["bias"], blk["extra"][0]["w"],
            blk["extra"][0]["bn"]["scale"], blk["extra"][0]["bn"]["bias"]]


def _run(form, name, remat=False):
    """One train-mode block in ``form``: ``(y, new_state, grads of x, W,
    gamma1, beta1, W2, gamma2, beta2)`` of a fixed linear objective, and
    the forms the block counted."""
    spec, blk, st, x, idx, mask = _case(name)
    model = get_model("dgcnn", dataclasses.replace(spec, block_impl=form, remat=remat))
    live = {"w": blk["w"].clone().requires_grad_(True),
            "bn": {n: t.clone().requires_grad_(True) for n, t in blk["bn"].items()},
            "extra": [{"w": blk["extra"][0]["w"].clone().requires_grad_(True),
                       "bn": {n: t.clone().requires_grad_(True)
                              for n, t in blk["extra"][0]["bn"].items()}}]}
    xx = x.clone().requires_grad_(True)
    before = dict(tdgcnn.block_forms)
    if remat:
        y, new = torch.utils.checkpoint.checkpoint(model._block, xx, idx, live, st, mask, True,
                                                   use_reentrant=False)
    else:
        y, new = model._block(xx, idx, live, st, mask, True)
    weights = torch.linspace(-1.0, 1.0, y.numel()).reshape(y.shape)
    grads = torch.autograd.grad((y * weights).sum(), [xx] + _leaves(live))
    ran = {f: n - before[f] for f, n in tdgcnn.block_forms.items() if n != before[f]}
    return y, new, grads, ran


@pytest.mark.parametrize("name", sorted(CASES))
def test_output_equals_the_edge_form(name):
    y_edge, _, _, ran_edge = _run("edge", name)
    y, _, _, ran = _run("auto", name)
    assert ran_edge == {"edge": 1} and ran == {"fused_mlp": 1}
    assert torch.equal(y, y_edge)


@pytest.mark.parametrize("name", sorted(CASES))
def test_new_bn_state_equals_the_edge_form(name):
    _, want, _, _ = _run("edge", name)
    _, got, _, _ = _run("auto", name)
    for part in ("main", "extra"):
        a = got[part] if part == "main" else got[part][0]
        b = want[part] if part == "main" else want[part][0]
        assert torch.equal(a["mean"], b["mean"]) and torch.equal(a["var"], b["var"]), part


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_the_edge_form(name):
    """Gradients of the input, the first conv, both BNs' gamma and beta
    and the stacked conv. With a forced tie the edge form's ``amax``
    splits the cotangent between the tied edges and the new form gives it
    all to the first; the tied edges are one neighbour, so the sums
    agree."""
    _, _, want, _ = _run("edge", name)
    _, _, got, _ = _run("auto", name)
    names = ["x", "w", "gamma1", "beta1", "w2", "gamma2", "beta2"]
    for n, a, b in zip(names, got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), n


@pytest.mark.parametrize("name", ["cin4_k20", "cin8_k4_masked"])
def test_remat_recomputes_the_same_block(name):
    """Under ``torch.utils.checkpoint`` the backward reruns the two
    forward passes: the same output and the same gradients, bit for bit."""
    y, _, grads, ran = _run("auto", name)
    y_r, _, grads_r, ran_r = _run("auto", name, remat=True)
    assert ran == {"fused_mlp": 1} and ran_r == {"fused_mlp": 2}
    assert torch.equal(y, y_r)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_r))


def _function_inputs(extended: bool, masked: bool):
    """Double inputs of `EdgeStats` and `EdgeMLP` at a tiny size (B=1,
    N=7, k=3, C=8), ``q`` with three rows more than ``p`` where
    ``extended`` (a context-parallel rank's neighbour operand)."""
    g = torch.Generator().manual_seed(7 + 2 * extended + masked)
    n, k, c = 7, 3, 8
    nq = n + 3 if extended else n
    dd = dict(dtype=torch.float64)
    p = torch.randn(1, n, c, generator=g, **dd)
    q = torch.randn(1, nq, c, generator=g, **dd)
    idx = torch.stack([torch.randperm(nq, generator=g)[:k] for _ in range(n)])[None]
    w = None
    if masked:
        w = torch.ones(1, n, **dd)
        w[0, -2:] = 0.0
    bn = [0.1 * torch.randn(c, generator=g, **dd), torch.rand(c, generator=g, **dd) + 0.5,
          torch.randn(c, generator=g, **dd), 0.2 * torch.randn(c, generator=g, **dd)]
    w2 = torch.randn(c, c, generator=g, **dd) / np.sqrt(c)
    gsign = torch.arange(c) % 3 != 0
    return p, q, idx.to(torch.int32), w, bn, w2, gsign


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fn", ["stats", "mlp"])
def test_functions_pass_gradcheck(fn, masked, extended):
    """Each Function's backward against central differences in float64,
    through every differentiable input (the winners are strict, so no
    difference step crosses a tie at these random inputs)."""
    p, q, idx, w, (mean1, r1, g1, b1), w2, gsign = _function_inputs(extended, masked)
    if fn == "stats":
        inputs = [p, q]

        def f(p, q):
            return EdgeStats.apply(p, q, idx, w)
    else:
        inputs = [p, q, mean1, r1, g1, b1, w2]

        def f(p, q, mean1, r1, g1, b1, w2):
            return EdgeMLP.apply(p, q, idx, w, mean1, r1, g1, b1, w2, gsign)
    inputs = [t.clone().requires_grad_(True) for t in inputs]
    assert torch.autograd.gradcheck(f, inputs, eps=1e-6, atol=1e-6, rtol=1e-5)


def _forms(width, k=6, depth=2, **kw):
    spec = ModelSpec(num_class=2, k=k, edge_filters=(width,), head_feat_dim=8, head_mlp=(8,),
                     block_convs=depth, **kw)
    return get_model("dgcnn", spec).block_impls


@pytest.mark.parametrize("width,k,depth,kw,want", [
    (16, 20, 2, {}, "fused_mlp"),
    (8, 4, 2, {}, "fused_mlp"),
    (128, 64, 2, {}, "fused_mlp"),
    (16, 20, 2, {"block_impl": "fused"}, "fused_mlp"),
    (12, 20, 2, {}, "edge"),  # a width the kernels do not take
    (136, 20, 2, {}, "edge"),
    (16, 65, 2, {}, "edge"),  # more neighbours than a uint8 winner's kernel takes
    (16, 20, 3, {}, "edge"),
    (16, 20, 2, {"block_impl": "edge"}, "edge"),
    (16, 20, 2, {"compute_dtype": "bfloat16"}, "edge"),
])
def test_auto_routes_a_depth_two_block_by_what_the_kernels_take(width, k, depth, kw, want):
    assert _forms(width, k, depth, **kw) == (want,)


def test_a_gather_that_does_not_decompose_keeps_the_edge_form():
    spec = ModelSpec(num_class=2, k=6, edge_filters=(16,), head_feat_dim=8, head_mlp=(8,),
                     block_convs=2)
    model = get_model("dgcnn", spec, gather_fn=lambda v, i: v)
    assert model.block_impls == ("edge",)


def test_eval_keeps_the_edge_form():
    spec, blk, st, x, idx, mask = _case("cin4_k4")
    model = get_model("dgcnn", spec)
    before = dict(tdgcnn.block_forms)
    with torch.no_grad():
        model._block(x, idx, blk, st, mask, False)
    assert {f: n - before[f] for f, n in tdgcnn.block_forms.items() if n != before[f]} == {
        "edge": 1}


@pytest.mark.parametrize("fn", ["stats", "forward", "backward", "stats_backward"])
def test_the_kernel_wrapper_raises_for_cpu_tensors(fn):
    p, q, idx, w, bn, w2, gsign = _function_inputs(False, False)
    p, q = p.float(), q.float()
    args = {"stats": (p, q, idx, w), "forward": (p, q, idx, w, *bn, w2, gsign),
            "backward": (p, q, idx, w, *bn, w2, None, p, bn[0], bn[1]),
            "stats_backward": (p, q, idx, w, bn[0], bn[1])}[fn]
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        getattr(edge_mlp_cuda, fn)(*args)
