"""The paper's segmentation DGCNN on the port (``dgcnn`` with one MLP depth
a block, ``block_convs=(2, 2, 1)``) at a small size on the CPU: against
the benchmark's plain reference (`portbench/networks/dgcnn_semseg`) on
seeded random weights and a pinned graph; equal depths as the int model,
bit for bit; each block's form by the form counter; the refusals; and
the depths through the command line, a checkpoint and its mismatch hint.

The graph is pinned (a fixed random graph a block, given to the program
and to the reference alike) because a near-tie neighbour flips under any
re-associated sum, and the program's factorised first convolution
``x_i @ (Wa - Wb) + x_j @ Wb`` rounds otherwise than the reference's
``[x_i, x_j - x_i] @ W``."""

import dataclasses
import itertools
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dgcnn_tpu_torch.config import Config, parse_args
from dgcnn_tpu_torch.models import ModelSpec, get_model
from dgcnn_tpu_torch.models import dgcnn as tdgcnn
from dgcnn_tpu_torch.train import checkpoint
from dgcnn_tpu_torch.train.trainval import Trainval
from portbench import events
from portbench.networks import dgcnn_semseg
from portbench.tree import flatten

B, N, K = 2, 64, 6
MODEL = {"name": "dgcnn", "num_class": 2, "k": K, "in_dim": 4, "edge_filters": [8, 8, 8],
         "block_convs": [2, 2, 1], "residual": False, "head_feat_dim": 16, "head_mlp": [12, 8],
         "bn_momentum": 0.9}
SPEC = dict(num_class=2, k=K, edge_filters=(8, 8, 8), head_feat_dim=16, head_mlp=(12, 8))
CFG = dict(model_name="dgcnn", num_class=2, kvalue=K, edge_filters=(8, 8, 8), head_feat_dim=16,
           head_mlp=(12, 8), minibatch_size=B, num_point=N, optimizer="adam",
           learning_rate=1e-3, num_devices=1)
BLOCKS = len(MODEL["edge_filters"])


def _events(seed):
    evs = [events.make_event(events.rng_for(seed + i), N) for i in range(B)]
    return (torch.as_tensor(np.stack([e.points for e in evs])),
            torch.as_tensor(np.stack([e.labels for e in evs])).long())


def _pinned_graphs(seed):
    """A fixed random graph a block, each row's neighbours distinct."""
    g = torch.Generator().manual_seed(seed)
    return [torch.stack([torch.stack([torch.randperm(N, generator=g)[:K] for _ in range(N)])
                         for _ in range(B)]).to(torch.int32) for _ in range(BLOCKS)]


def _pinned_knn(graphs):
    """The program's ``knn_fn`` over ``graphs``, block after block."""
    calls = itertools.count()

    def knn_fn(x, k, mask):
        idx = graphs[next(calls) % BLOCKS]
        return idx, torch.ones(idx.shape, dtype=torch.bool)

    return knn_fn


def _reference(graphs, **kw):
    ref = dgcnn_semseg.Reference(MODEL, **kw)
    calls = itertools.count()
    ref.knn = lambda x: graphs[next(calls) % BLOCKS].long()
    return ref


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_eval_logits_and_train_loss_match_the_reference(seed):
    """Eval: the logits within 2e-6 of their largest (float32 rounding of
    two matmul orders over 8-16 channels). Train mode: BN on the batch's
    statistics divides by a spread of the same rounding, so 1e-5."""
    params, state = dgcnn_semseg.make_weights(MODEL, seed, "cpu")
    points, labels = _events(seed)
    graphs = _pinned_graphs(seed)
    model = get_model("dgcnn", ModelSpec(**SPEC, block_convs=(2, 2, 1)),
                      knn_fn=_pinned_knn(graphs))
    ref = _reference(graphs)
    with torch.no_grad():
        got, _ = model(params, state, points)
        want, _ = ref.forward(params, state, points, train=False)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 2e-6 * scale
        got, got_s = model(params, state, points, train=True)
        want, want_s = ref.forward(params, state, points, train=True)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    # the new BN state, stacked convs' included, has the reference's tree
    assert [n for n, _ in flatten(got_s)] == [n for n, _ in flatten(want_s)]
    for (n, a), (_, b) in zip(flatten(got_s), flatten(want_s)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=n)


@pytest.mark.parametrize("seed", [5, 2**31 + 6])
def test_one_adam_step_matches_the_reference(seed):
    """One step of `Trainval.train_step` (Adam at 1e-3) against the
    reference's: the loss within 1e-6, each leaf's first gradient (Adam's
    first moment over 0.1) within 1e-5 of the larger of its norm and the
    median leaf's, and the change of every element whose gradient is not
    nought to rounding (Adam moves those by its sign) within 1e-6."""
    params, state = dgcnn_semseg.make_weights(MODEL, seed, "cpu")
    start = {n: t.clone() for n, t in flatten(params)}
    points, labels = _events(seed)
    graphs = _pinned_graphs(seed)
    tv = Trainval(Config(**CFG, block_convs=(2, 2, 1)), device="cpu",
                  knn_fn=_pinned_knn(graphs))
    st = tv.with_params(params, state)
    st, m = tv.train_step(st, (points.numpy(), labels.numpy(), None, np.ones((B, N), bool)))
    fresh = dgcnn_semseg.make_weights(MODEL, seed, "cpu")
    out = _reference(graphs).train(*fresh, [(points, labels)], 1e-3)
    assert abs(float(m["loss"]) - out["loss"][0]) <= 1e-6 * abs(out["loss"][0])
    median = float(np.median([float(g.norm()) for g in out["grad1"].values()]))
    names = [n for n, _ in flatten(st.params)]
    assert names == list(out["grad1"])
    for name, mu, (_, p) in zip(names, st.opt_state["mu"], flatten(st.params)):
        g = out["grad1"][name]
        assert float((mu / 0.1 - g).norm()) <= 1e-5 * max(float(g.norm()), median), name
        moving = g.abs() >= 1e-4
        torch.testing.assert_close((p - start[name])[moving], out["change"][name][moving],
                                   rtol=0, atol=1e-6, msg=name)


def _forward_all(model, params, state, points):
    with torch.no_grad():
        return (model(params, state, points)[0],) + model(params, state, points, train=True)


def test_equal_depths_build_the_int_model_bit_for_bit():
    """``block_convs=(2, 2, 2)`` is ``block_convs=2``: the same tree drawn
    from the same generator, the same forms, the same outputs and state;
    and a `Config` keeps it as the int."""
    points, _ = _events(1)
    built = []
    for depths in (2, (2, 2, 2)):
        model = get_model("dgcnn", ModelSpec(**SPEC, block_convs=depths))
        params, state = model.init(4, torch.Generator().manual_seed(0))
        built.append((model, params, state, _forward_all(model, params, state, points)))
    (m_int, p_int, s_int, o_int), (m_tup, p_tup, s_tup, o_tup) = built
    assert m_int.block_impls == m_tup.block_impls == ("fused_mlp",) * BLOCKS
    for a, b in ((p_int, p_tup), (s_int, s_tup), (o_int[2], o_tup[2])):
        assert [(n, t.shape) for n, t in flatten(a)] == [(n, t.shape) for n, t in flatten(b)]
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(flatten(a), flatten(b)))
    assert torch.equal(o_int[0], o_tup[0]) and torch.equal(o_int[1], o_tup[1])
    assert Config(**CFG, block_convs=[2, 2, 2]).block_convs == 2
    assert Config(**CFG, block_convs=[2, 2, 1]).block_convs == (2, 2, 1)


def test_per_block_depths_draw_extra_convs_only_where_deep():
    model = get_model("dgcnn", ModelSpec(**SPEC, block_convs=(2, 3, 1)))
    params, state = model.init(4, torch.Generator().manual_seed(0))
    assert [len(b.get("extra", ())) for b in params["blocks"]] == [1, 2, 0]
    assert [sorted(s) for s in state["blocks"]] == [["extra", "main"], ["extra", "main"],
                                                    ["mean", "var"]]
    assert params["blocks"][1]["extra"][1]["w"].shape == (8, 8)
    # a depth-1 model draws the JAX package's order, so its first block is
    # the same weights as the deeper model's first conv
    flat = get_model("dgcnn", ModelSpec(**SPEC)).init(4, torch.Generator().manual_seed(0))[0]
    assert torch.equal(flat["blocks"][0]["w"], params["blocks"][0]["w"])


def _forms(model, params, state, points, train):
    before = dict(tdgcnn.block_forms)
    with torch.no_grad():
        model(params, state, points, train=train)
    return {f: n - before[f] for f, n in tdgcnn.block_forms.items() if n != before[f]}


@pytest.mark.parametrize("name,depths,train,want", [
    ("dgcnn", (2, 2, 1), True, {"fused_mlp": 2, "fused": 1}),
    ("dgcnn", (2, 2, 1), False, {"edge": 2, "reduced": 1}),
    ("dgcnn", 2, True, {"fused_mlp": BLOCKS}),
    ("residual-dgcnn", 1, True, {"fused": BLOCKS}),
    ("residual-dgcnn", 1, False, {"reduced": BLOCKS}),
])
def test_auto_resolves_each_blocks_form(name, depths, train, want):
    """``block_impl="auto"`` per block, read by the form counter: an f32
    depth-1 block fused (reduced in eval), as every block of the flagship
    residual network, and a depth-2 block ``fused_mlp`` in training and
    the edge form in eval."""
    model = get_model(name, ModelSpec(**SPEC, block_convs=depths))
    params, state = model.init(4, torch.Generator().manual_seed(0))
    assert _forms(model, params, state, _events(2)[0], train) == want


def test_an_explicit_form_falls_back_only_where_a_block_cannot_take_it():
    with pytest.warns(UserWarning, match=r"forces the 'edge' implementation on blocks \[0, 1\]"):
        model = get_model("dgcnn", ModelSpec(**SPEC, block_convs=(2, 2, 1),
                                             block_impl="reduced"))
    assert model.block_impls == ("edge", "edge", "reduced") and model.block_impl == "mixed"
    params, state = model.init(4, torch.Generator().manual_seed(0))
    assert _forms(model, params, state, _events(2)[0], True) == {"edge": 2, "reduced": 1}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert get_model("dgcnn", ModelSpec(**SPEC, block_convs=(2, 2, 1),
                                            block_impl="edge")).block_impl == "edge"


@pytest.mark.parametrize("depths,message", [
    ((2, 2), "block_convs gives 2 depths for 3 EdgeConv blocks"),
    ((2, 2, 1, 1), "block_convs gives 4 depths for 3 EdgeConv blocks"),
    ((2, 0, 1), r"block_convs depths must be ints >= 1, got \(2, 0, 1\)"),
    ((2, -1, 1), "block_convs depths must be ints >= 1"),
    (0, "block_convs must be >= 1, got 0"),
])
def test_a_bad_depth_is_refused(depths, message):
    with pytest.raises(ValueError, match=message):
        get_model("dgcnn", ModelSpec(**SPEC, block_convs=depths))
    with pytest.raises(ValueError, match=message):
        Config(**CFG, block_convs=depths)


def test_the_flag_takes_one_depth_or_one_a_block(capsys):
    base = ["train", "-mn", "dgcnn", "--edge_filters", "8", "8", "8"]
    assert parse_args(base + ["--block_convs", "2,2,1"]).block_convs == (2, 2, 1)
    assert parse_args(base + ["--block_convs", "2"]).block_convs == 2
    assert parse_args(base + ["--block_convs", "2,2,2"]).block_convs == 2
    with pytest.raises(SystemExit):
        parse_args(base + ["--block_convs", "2,x,1"])
    assert "not an int or a comma-separated list of ints" in capsys.readouterr().err
    with pytest.raises(ValueError, match="block_convs gives 2 depths for 3"):
        parse_args(base + ["--block_convs", "2,1"])


def test_depths_survive_a_checkpoint_and_its_mismatch_hint(tmp_path, capsys):
    """``--block_convs 2,2,1`` through `Trainval`, a checkpoint save and
    restore; a run configured otherwise adopts the saved depths, and a
    restore into another tree names them in its hint."""
    cfg = parse_args(["train", "-mn", "dgcnn", "-k", str(K), "--edge_filters", "8", "8", "8",
                      "--head_feat_dim", "16", "--head_mlp", "12", "8", "-mb", str(B), "-np",
                      str(N), "-nd", "1", "--block_convs", "2,2,1"])
    tv = Trainval(cfg, device="cpu")
    state = tv.initialize(4, generator=torch.Generator().manual_seed(0))
    path = checkpoint.save(str(tmp_path / "snap"), 3, tv.state_tree(state), vars(cfg))
    tree, step, saved = checkpoint.restore(path, tv.state_tree(state))
    assert step == 3 and saved["block_convs"] == [2, 2, 1]
    for (n, a), (_, b) in zip(flatten(tree["params"]), flatten(tv.state_tree(state)["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=n)
    flat = dataclasses.replace(cfg, block_convs=1)
    assert checkpoint.model_flag_diffs(flat, saved) == {"block_convs": (1, (2, 2, 1))}
    assert checkpoint.adopt_model_flags(flat, path).block_convs == (2, 2, 1)
    assert "adopting model flags from checkpoint: block_convs=(2, 2, 1)" in capsys.readouterr().out
    assert checkpoint.model_flag_diffs(cfg, saved) == {}
    other = Trainval(flat, device="cpu")
    with pytest.raises(ValueError, match=r"'block_convs': \[2, 2, 1\]"):
        checkpoint.restore(path, other.state_tree(other.initialize(4)))


def test_the_stacked_convs_open_their_span_inside_the_block():
    """``dgcnn.edge_mlp`` once a deep block a forward, inside
    ``dgcnn.edgeconv``; a depth-1 block opens none."""
    model = get_model("dgcnn", ModelSpec(**SPEC, block_convs=(2, 2, 1)))
    params, state = model.init(4, torch.Generator().manual_seed(0))
    points = _events(4)[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(params, state, points, train=True)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name in ("dgcnn.edgeconv", "dgcnn.edge_mlp"))
    mlp = [s for s in spans if s[2] == "dgcnn.edge_mlp"]
    blocks = [s for s in spans if s[2] == "dgcnn.edgeconv"]
    assert len(mlp) == 2 and len(blocks) == BLOCKS
    for start, end, _ in mlp:
        assert any(b0 <= start and end <= b1 for b0, b1, _ in blocks[:2])


def test_the_command_loop_trains_and_serves_the_per_block_network(tmp_path, monkeypatch,
                                                                    capsys):
    """``train --block_convs 2,2,1`` through `train.loop` (the command's
    path, on the CPU) saves a checkpoint; ``inference`` without the flag
    adopts the saved depths and labels events."""
    from dgcnn_tpu_torch.train import loop

    monkeypatch.chdir(tmp_path)
    model = ["-io", "synthetic", "-mb", "2", "-np", "128", "-mn", "dgcnn", "-k", str(K),
             "--edge_filters", "8", "8", "8", "--head_feat_dim", "16", "--head_mlp", "8"]
    loop.train(parse_args(["train", *model, "-i", "2", "-rs", "1", "-cs", "2",
                           "--block_convs", "2,2,1", "-wp", "w/snap", "-ld", "log"]),
               device="cpu")
    assert (tmp_path / "w" / "snap-2.ckpt").exists()
    out = loop.inference(parse_args(["inference", *model, "-i", "1", "-mp", "w/snap",
                                     "-of", "pred.npz"]), device="cpu")
    assert "adopting model flags from checkpoint: block_convs=(2, 2, 1)" in capsys.readouterr().out
    assert out["batches"] == 1 and (tmp_path / "pred.npz").exists()
