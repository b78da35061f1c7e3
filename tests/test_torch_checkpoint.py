"""The port's checkpoints against the JAX package's: the pure-Python
msgpack codec gives ``flax.serialization``'s bytes (chunked arrays too),
a JAX checkpoint restores into the port for every optimizer with and
without clipping (leaves bitwise equal, and saved again byte for byte), a
port checkpoint restores through the JAX ``checkpoint.restore``, and the
file helpers (prune, latest, step parsing, model-flag adoption, the
mismatch message) behave as the JAX ones."""

import json

import flax.serialization as flax_ser
import jax
import numpy as np
import pytest
import torch

from dgcnn_tpu.config import Config as JaxConfig
from dgcnn_tpu.io import BucketBatcher as JaxBatcher
from dgcnn_tpu.io import SyntheticIO as JaxSyntheticIO
from dgcnn_tpu.train import checkpoint as jck
from dgcnn_tpu.train.trainval import Trainval as JaxTrainval
from dgcnn_tpu_torch.bridge import tree_leaves
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.train import checkpoint as ck
from dgcnn_tpu_torch.train.trainval import Trainval, jax_key, seed_of_key

SMALL = dict(model_name="residual-dgcnn", num_class=3, kvalue=4, edge_filters=(8, 12),
             head_feat_dim=16, head_mlp=(8,), minibatch_size=1, num_point=64,
             use_pallas=False)


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "b": [rng.randn(3, 4).astype(np.float32),
              {"z": np.int32(5), "a": np.arange(300, dtype=np.int64)}],
        "a": {"count": np.array(7, np.int32), "empty": np.zeros((0, 3), np.float32),
              "u8": rng.randint(0, 255, (5,)).astype(np.uint8), "rng": jax_key(123)},
        "s": "x" * 40, "t": "y" * 300, "long": "z" * 70000, "n": None, "f": 1.5, "bo": True,
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129,
                 -32768, -32769, -2**31, -2**31 - 1, 2**63],
        "map16": {str(i): i for i in range(20)}, "list16": list(range(20)),
        "bytes": b"\x00" * 300, "scal": np.float32(2.5), "bool": np.bool_(True),
        "f64": np.float64(3.0),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_codec_bytes_equal_flax(seed):
    payload = {"tree": _tree(seed), "step": 3, "config": json.dumps({"k": [1, 2]})}
    want = flax_ser.msgpack_serialize(payload)
    assert ck.serialize(payload) == want
    got = ck.restore_bytes(want)
    ref = flax_ser.msgpack_restore(want)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        assert type(a) is type(b)
        np.testing.assert_array_equal(a, b)


def test_codec_chunked_arrays_equal_flax(monkeypatch):
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(ck, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(2)
    payload = {"tree": {"w": rng.randn(10, 7).astype(np.float32), "small": np.ones(3, np.int8),
                        "v": rng.randn(9).astype(np.float64)}, "step": 1}
    want = flax_ser.msgpack_serialize(payload)
    assert ck.serialize(payload) == want
    got = ck.restore_bytes(want)
    np.testing.assert_array_equal(got["tree"]["w"], payload["tree"]["w"])
    np.testing.assert_array_equal(got["tree"]["v"], payload["tree"]["v"])


def test_codec_rejects_truncated_and_foreign_data():
    data = ck.serialize({"tree": {"w": np.ones(4, np.float32)}, "step": 1})
    with pytest.raises(ValueError, match="truncated"):
        ck.restore_bytes(data[:-3])
    with pytest.raises(ValueError, match="extra bytes"):
        ck.restore_bytes(data + b"\x00")
    with pytest.raises(TypeError):
        ck.serialize({"x": object()})


@pytest.mark.parametrize("seed", [0, 123, 2**32 - 1, 2**33 + 5, -5])
def test_jax_key_is_prngkey(seed):
    want = np.asarray(jax.random.PRNGKey(seed))
    np.testing.assert_array_equal(jax_key(seed), want)
    assert seed_of_key(want) == seed % 2**32
    tv = Trainval(Config(**SMALL, seed=seed), device="cpu")
    np.testing.assert_array_equal(tv.state_tree(tv.initialize(4))["rng"], want)


def _jax_state(kw, steps=2):
    """A JAX Trainval state after ``steps`` steps (non-zero moments)."""
    jcfg = JaxConfig(**kw, num_devices=1)
    jtv = JaxTrainval(jcfg)
    state = jtv.initialize(4)
    io = JaxSyntheticIO(num_events=steps, num_point=64, seed=1).initialize()
    for batch in JaxBatcher(io, 1, num_point=64, shuffle=False).epoch():
        state, _ = jtv.train_step(state, batch)
    return jcfg, state


OPTIMIZERS = [(opt, clip) for opt in ("adam", "adamw", "sgd", "momentum") for clip in (0.0, 0.5)]


@pytest.mark.parametrize("opt,clip", OPTIMIZERS)
def test_jax_checkpoint_restores_into_port(tmp_path, opt, clip):
    sched = "cosine" if opt in ("adam", "momentum") else "constant"
    kw = dict(SMALL, optimizer=opt, grad_clip=clip, lr_schedule=sched)
    jcfg, jstate = _jax_state(kw)
    jpath = jck.save(str(tmp_path / "j"), 2, jstate, vars(jcfg))

    tv = Trainval(Config(**kw, num_devices=1), device="cpu")
    tree, step, saved = ck.restore(jpath, tv.state_tree(tv.initialize(4)))
    state = tv.load_tree(tree)
    assert step == 2 and state.step == 2 and state.rng == 123
    assert saved == json.loads(json.dumps(vars(jcfg), default=list))
    for got, want in ((state.params, jstate.params), (state.model_state, jstate.model_state)):
        want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, want))
        for a, b in zip(tree_leaves(got), want):
            np.testing.assert_array_equal(a.numpy(), b)
    jopt = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jstate.opt_state))
    popt = jax.tree_util.tree_leaves(tv.state_tree(state)["opt_state"])
    assert len(popt) == len(jopt)
    for a, b in zip(popt, jopt):
        np.testing.assert_array_equal(np.asarray(a), b)
    # saved again by the port: the JAX file, byte for byte
    ppath = ck.save(str(tmp_path / "p"), 2, tv.state_tree(state), vars(jcfg))
    assert open(ppath, "rb").read() == open(jpath, "rb").read()


@pytest.mark.parametrize("opt,clip", [("adam", 0.0), ("momentum", 0.5)])
def test_port_checkpoint_restores_in_jax(tmp_path, opt, clip):
    kw = dict(SMALL, optimizer=opt, grad_clip=clip)
    cfg = Config(**kw, num_devices=1, seed=9)
    tv = Trainval(cfg, device="cpu")
    state = tv.initialize(4)
    io = JaxSyntheticIO(num_events=2, num_point=64, seed=1).initialize()
    for batch in JaxBatcher(io, 1, num_point=64, shuffle=False).epoch():
        state, _ = tv.train_step(state, batch)
    path = ck.save(str(tmp_path / "p"), state.step, tv.state_tree(state), vars(cfg))

    jcfg = JaxConfig(**kw, num_devices=1, seed=9)
    template = JaxTrainval(jcfg).initialize(4)
    jstate, step, saved = jck.restore(str(tmp_path / "p"), template)
    assert step == 2 and int(jstate.step) == 2 and saved["seed"] == 9
    np.testing.assert_array_equal(np.asarray(jstate.rng), np.asarray(jax.random.PRNGKey(9)))
    want = jax.tree_util.tree_leaves(tv.state_tree(state)["params"])
    for a, b in zip(jax.tree_util.tree_leaves(jstate.params), want):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the JAX package restores and continues training from it
    JaxTrainval(jcfg).train_step(jstate, next(JaxBatcher(io, 1, num_point=64).epoch()))
    assert ck.latest(str(tmp_path / "p")) == path


def test_restore_for_eval_needs_no_optimizer_match(tmp_path):
    jcfg, jstate = _jax_state(dict(SMALL, optimizer="momentum", grad_clip=0.5))
    jck.save(str(tmp_path / "w"), 2, jstate, vars(jcfg))
    tv = Trainval(Config(**SMALL, optimizer="adam"), device="cpu")
    state, step = tv.restore_for_eval(tv.initialize(4), str(tmp_path / "w"))
    assert step == 2
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jstate.params))
    for a, b in zip(tree_leaves(state.params), want):
        np.testing.assert_array_equal(a.numpy(), b)


def test_mismatch_message_like_jax(tmp_path):
    """A checkpoint of other widths (or another optimizer) restores in
    neither package, with the same advice."""
    jcfg, jstate = _jax_state(dict(SMALL, optimizer="adam"))
    path = jck.save(str(tmp_path / "w"), 2, jstate, vars(jcfg))
    other = dict(SMALL, edge_filters=(8, 8, 8), optimizer="sgd")
    tv = Trainval(Config(**other), device="cpu")
    with pytest.raises(ValueError) as got:
        ck.restore(path, tv.state_tree(tv.initialize(4)))
    with pytest.raises(ValueError) as want:
        jck.restore(path, JaxTrainval(JaxConfig(**other, num_devices=1)).initialize(4))
    for e in (got.value, want.value):
        assert "does not match the current run configuration" in str(e)
        assert "'edge_filters': [8, 12]" in str(e) and "'optimizer': 'adam'" in str(e)
    assert str(got.value).split("\n")[1] == str(want.value).split("\n")[1]
    # same widths, another head: the shapes differ
    tv = Trainval(Config(**dict(SMALL, head_feat_dim=32)), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore_subtrees(path, {"params": tv.initialize(4).params})


def test_prune_latest_and_step_parsing(tmp_path):
    """tests/test_crop.py::test_prune_ignores_sibling_prefixes, both
    packages on the same files."""
    mine = [tmp_path / f"snap-{s}.ckpt" for s in (100, 200, 300)]
    sibling = [tmp_path / f"snap-lr01-{s}.ckpt" for s in (50, 700)]
    for p in mine + sibling + [tmp_path / "snap-x.ckpt", tmp_path / "snap-5.ckpt.tmp"]:
        p.write_bytes(b"x")
    prefix = str(tmp_path / "snap")
    for p in mine + sibling:
        assert ck._step_of(prefix, str(p)) == jck._step_of(prefix, str(p))
    assert ck._step_of(prefix, str(mine[1])) == 200
    assert ck._step_of(prefix, str(sibling[0])) is None
    assert ck.latest(prefix) == jck.latest(prefix) == str(mine[2])
    assert ck.latest(str(tmp_path / "snap-lr01")) == str(sibling[1])
    assert ck.prune(prefix, 0) == []
    removed = ck.prune(prefix, keep=1)
    assert sorted(removed) == [str(p) for p in mine[:2]]
    assert all(p.exists() for p in sibling)
    assert ck.latest(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ck.peek(str(tmp_path / "none"))


def test_adopt_model_flags_like_jax(tmp_path, capsys):
    trained = Config(**dict(SMALL, kvalue=5, knn_every=2, knn_window=32))
    ck.save(str(tmp_path / "w"), 1, {"x": np.zeros(1, np.float32)}, vars(trained))
    payload = ck.peek(str(tmp_path / "w"))
    assert payload["step"] == 1
    serve = Config(**dict(SMALL, command="inference", model_path="m"))
    jserve = JaxConfig(**dict(SMALL, command="inference", model_path="m"))
    assert ck.model_flag_diffs(serve, json.loads(payload["config"])) == \
        jck.model_flag_diffs(jserve, json.loads(payload["config"]))
    assert ck.MODEL_FLAGS == jck.MODEL_FLAGS
    got = ck.adopt_model_flags(serve, str(tmp_path / "w-1.ckpt"))
    out = capsys.readouterr().out
    want = jck.adopt_model_flags(jserve, str(tmp_path / "w-1.ckpt"))
    assert capsys.readouterr().out == out
    assert "adopting model flags from checkpoint" in out and "kvalue=5" in out
    assert (got.kvalue, got.knn_every, got.knn_window) == (5, 2, 32)
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert ck.adopt_model_flags(got, payload=payload) is got


def test_torch_state_leaves_serialize_without_copy_back():
    """Tensors in the tree serialize as their numpy arrays."""
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    want = flax_ser.msgpack_serialize({"tree": {"w": t.numpy()}, "step": 0})
    assert ck.serialize({"tree": ck.to_state_dict({"w": t}), "step": 0}) == want
