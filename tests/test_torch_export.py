"""The port's serving export (`dgcnn_tpu_torch.train.export`) against the
JAX package's (`dgcnn_tpu/train/export.py`, `tests/test_export.py`): the
same checkpoint file (both packages read the JAX format) exported by each,
served on the same numpy inputs.

On the CPU the port's artifact runs the plain oracle graph builds its live
CPU forward runs, so it equals that forward bit for bit, and the JAX
artifact and JAX's live forward within 1e-5 (the JAX test's own
tolerance; the two packages sum in other orders). A bf16 model is held
against JAX on the port's graph replayed into JAX (near-tie neighbours of
bf16 features would otherwise part them), at the bf16 tolerance of
`tests/test_torch_precision.py`: eval logits within 2^-7 of the largest
logit, here on the scores. On the card the graph builds are the registered
operators of `kernels.ops`; a module or model that calls the kernel
wrappers on CPU tensors exports with one such node a graph build, which the
plain version computes here.
"""

import dataclasses
import functools
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.config import Config as JaxConfig
from dgcnn_tpu.models import get_model as jax_get_model
from dgcnn_tpu.train import checkpoint as jck
from dgcnn_tpu.train import export as jexport
from dgcnn_tpu.train.loop import train as jax_train
from dgcnn_tpu.train.trainval import Trainval as JaxTrainval
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.kernels import knn_banded_cuda as bmod
from dgcnn_tpu_torch.kernels import knn_cuda as kmod
from dgcnn_tpu_torch.kernels import ops
from dgcnn_tpu_torch.ops.knn import knn_indices
from dgcnn_tpu_torch.train import export as texport
from dgcnn_tpu_torch.train import trainval as ttrainval
from dgcnn_tpu_torch.train.export import load_exported, run_export

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_export.py's sizes
SMALL = dict(
    io_type="synthetic",
    num_class=2,
    kvalue=6,
    edge_filters=(8,),
    head_feat_dim=16,
    head_mlp=(16,),
    minibatch_size=2,
    num_point=128,
    num_devices=1,
    use_pallas=False,
    precision="highest",
    seed=4,
)
ATOL = 1e-5


def _inputs(seed, b, n=128, f=4, nvalid=None):
    rng = np.random.RandomState(seed)
    pts = rng.randn(b, n, f).astype(np.float32)
    mask = np.arange(n)[None].repeat(b, 0) < (n if nvalid is None else nvalid)
    return pts, mask


def _jax_checkpoint(path, cfg, in_dim=4, step=1):
    """A JAX-initialised state saved in the JAX format; returns it."""
    state = JaxTrainval(cfg).initialize(in_dim)
    jck.save(path, step, {"params": state.params, "model_state": state.model_state,
                          "opt_state": state.opt_state, "rng": state.rng}, vars(cfg))
    return state


def _jax_live(cfg, state, pts, mask, knn_fn=None):
    model = jax_get_model(cfg.model_name, cfg.model_spec(), knn_fn=knn_fn)
    logits, _ = model.apply(state.params, state.model_state, jnp.asarray(pts),
                            jnp.asarray(mask), train=False)
    return np.asarray(jax.nn.softmax(logits, -1))


def _port_live(cfg, ckpt, pts, mask, in_dim=4):
    """The port's live eval scores of the checkpoint on the CPU
    (`Trainval.inference`)."""
    tv = ttrainval.Trainval(cfg, device="cpu")
    state, _ = tv.restore_for_eval(tv.initialize(in_dim), ckpt)
    labels = np.zeros(mask.shape, np.int64)
    scores, _, _ = tv.inference(state, (pts, labels, None, mask))
    return scores


def _port_export(cfg, ckpt, out, **kw):
    return run_export(dataclasses.replace(Config(**{**SMALL, **cfg}), command="export",
                                          model_path=ckpt, output_file=out, **kw), device="cpu")


def _serve(path, pts, mask):
    return load_exported(path)(torch.tensor(pts), torch.tensor(mask))


def test_export_roundtrip_matches_live(tmp_path, capsys):
    cfg = JaxConfig(command="train", iteration=6, report_step=6, checkpoint_step=0,
                    weight_prefix=str(tmp_path / "w/s"), log_dir=str(tmp_path / "log"), **SMALL)
    jax_train(cfg)
    ckpt = str(tmp_path / "w/s")
    capsys.readouterr()
    path = _port_export({}, ckpt, str(tmp_path / "model.pt2"))
    assert os.path.getsize(path) > 1000
    assert capsys.readouterr().out.strip() == (
        f"exported step-6 model ({os.path.getsize(path) / 1e6:.2f} MB, shapes [2,128,4]) -> "
        f"{path}")
    jpath = jexport.run_export(dataclasses.replace(
        cfg, command="export", model_path=ckpt, output_file=str(tmp_path / "model.jaxir")))

    pts, mask = _inputs(0, 2, nvalid=np.array([[128], [100]]))
    served = _serve(path, pts, mask)
    torch.testing.assert_close(served, _port_live(Config(**SMALL), ckpt, pts, mask),
                               rtol=0, atol=0)
    jax_served = np.asarray(jexport.load_exported(jpath)(jnp.asarray(pts), jnp.asarray(mask)))
    np.testing.assert_allclose(served.numpy(), jax_served, atol=ATOL)
    jstate = JaxTrainval(cfg).initialize(4)
    jstate, _, _ = jck.restore(ckpt, jstate)
    np.testing.assert_allclose(served.numpy(), _jax_live(cfg, jstate, pts, mask), atol=ATOL)


@pytest.mark.parametrize("head_stream", ["auto", "off"])
def test_export_polymorphic_batch(tmp_path, head_stream):
    """-mb 0 exports one artifact that serves any batch size: traced at
    batch 2, its batch is at least 1 and has no upper bound (a streaming
    threshold compared against a symbolic batch would put one there)."""
    cfg = JaxConfig(command="train", **{**SMALL, "head_stream": head_stream})
    state = _jax_checkpoint(str(tmp_path / "wp/s"), cfg)
    path = _port_export({"head_stream": head_stream}, str(tmp_path / "wp/s"),
                        str(tmp_path / "poly.pt2"), minibatch_size=0)
    ep = torch.export.load(path)
    (bound,) = ep.range_constraints.values()
    assert bound.lower == 1 and bool(bound.upper > 2**20)
    for b in (1, 3):
        pts, mask = _inputs(2 + b, b)
        served = _serve(path, pts, mask)
        assert served.shape == (b, 128, 2)
        np.testing.assert_allclose(served.numpy(), _jax_live(cfg, state, pts, mask), atol=ATOL)


def test_export_derives_in_dim_from_checkpoint(tmp_path):
    """A checkpoint trained on F=5 events exports and serves at F=5."""
    cfg = JaxConfig(command="train", **SMALL)
    state = _jax_checkpoint(str(tmp_path / "w5/s"), cfg, in_dim=5, step=3)
    path = _port_export({}, str(tmp_path / "w5/s"), str(tmp_path / "model5.pt2"))
    pts, mask = _inputs(1, 2, f=5)
    served = _serve(path, pts, mask)
    np.testing.assert_allclose(served.numpy(), _jax_live(cfg, state, pts, mask), atol=ATOL)
    torch.testing.assert_close(served, _port_live(Config(**SMALL), str(tmp_path / "w5/s"), pts,
                                                  mask, in_dim=5), rtol=0, atol=0)


def test_export_adopts_checkpoint_model_flags(tmp_path, capsys):
    """Export with "forgotten" shape-invariant flags (kvalue, knn_every)
    adopts the checkpoint's values: the artifact serves the trained
    function, bit for bit, whatever the command line repeated."""
    flags = {"kvalue": 5, "edge_filters": (8, 8), "knn_every": 2}
    cfg = JaxConfig(command="train", **{**SMALL, **flags})
    state = _jax_checkpoint(str(tmp_path / "w/s"), cfg)
    ckpt = str(tmp_path / "w/s")
    good = _port_export(flags, ckpt, str(tmp_path / "good.pt2"), minibatch_size=1)
    capsys.readouterr()
    bad = _port_export({**flags, "kvalue": 8, "knn_every": 1}, ckpt, str(tmp_path / "bad.pt2"),
                       minibatch_size=1)
    printed = capsys.readouterr().out
    assert "adopting model flags from checkpoint: knn_every=2, kvalue=5" in printed
    pts, mask = _inputs(0, 1)
    sa, sb = _serve(good, pts, mask), _serve(bad, pts, mask)
    torch.testing.assert_close(sa, sb, rtol=0, atol=0)
    np.testing.assert_allclose(sa.numpy(), _jax_live(cfg, state, pts, mask), atol=ATOL)


def test_export_banded_model_roundtrip(tmp_path, capsys):
    """A --knn_window model exports (the Morton sort and the banded graph
    build trace), adopts the window from the checkpoint when the command
    line forgets it, and serves a padded event as live inference does."""
    cfg = JaxConfig(command="train", **{**SMALL, "knn_window": 32})
    state = _jax_checkpoint(str(tmp_path / "w/s"), cfg)
    ckpt = str(tmp_path / "w/s")
    capsys.readouterr()
    path = _port_export({}, ckpt, str(tmp_path / "banded.pt2"), minibatch_size=1)
    assert "adopting model flags from checkpoint: knn_window=32" in capsys.readouterr().out
    pts, mask = _inputs(1, 1, nvalid=100)
    served = _serve(path, pts, mask)
    np.testing.assert_allclose(served.numpy(), _jax_live(cfg, state, pts, mask), atol=ATOL)
    torch.testing.assert_close(served, _port_live(Config(**SMALL, knn_window=32), ckpt, pts,
                                                  mask), rtol=0, atol=0)


def test_export_bf16_edge_form_polymorphic(tmp_path):
    """--precision bfloat16 (the edge form, whose eval-stream guard counts
    the batch) at -mb 0 exports and serves batch 1 and 3: equal to the
    port's live forward bit for bit, and to JAX's on the port's graph at
    the bf16 tolerance."""
    cfg = JaxConfig(command="train", **{**SMALL, "precision": "bfloat16"})
    state = _jax_checkpoint(str(tmp_path / "w/s"), cfg)
    ckpt = str(tmp_path / "w/s")
    path = _port_export({"precision": "bfloat16"}, ckpt, str(tmp_path / "bf16.pt2"),
                        minibatch_size=0)
    pcfg = Config(**{**SMALL, "precision": "bfloat16"})
    graphs = []

    def recording(x, k, m):
        graphs.append(knn_indices(x, k, m))
        return graphs[-1]

    tv = ttrainval.Trainval(pcfg, device="cpu", knn_fn=recording)
    tstate, _ = tv.restore_for_eval(tv.initialize(4), ckpt)
    for b in (1, 3):
        pts, mask = _inputs(5 + b, b, nvalid=np.array([[128], [90], [128]])[:b])
        served = _serve(path, pts, mask)
        graphs.clear()
        live, _, _ = tv.inference(tstate, (pts, np.zeros(mask.shape, np.int64), None, mask))
        torch.testing.assert_close(served, live, rtol=0, atol=0)
        replay = iter(graphs)

        def knn_fn(x, k, m):
            idx, valid = next(replay)
            return jnp.asarray(idx.numpy()), jnp.asarray(valid.numpy())

        model = jax_get_model(cfg.model_name, cfg.model_spec(), knn_fn=knn_fn)
        logits, _ = model.apply(state.params, state.model_state, jnp.asarray(pts),
                                jnp.asarray(mask), train=False)
        top = float(np.abs(np.asarray(logits)).max())
        np.testing.assert_allclose(served.numpy(), np.asarray(jax.nn.softmax(logits, -1)),
                                   rtol=0, atol=2.0**-7 * top)


class _Builds(torch.nn.Module):
    """Graph builds through the kernel wrappers: two exact (one bf16-scored)
    and one banded."""

    def forward(self, x, mask):
        i1, v1 = kmod.knn_cuda(x, 5, mask)
        i2, v2, s2 = kmod.knn_cuda(x, 5, None, return_scores=True, precision="default")
        i3, v3, s3 = bmod.knn_banded_cuda(x, 5, mask, window=999, return_scores=True)
        return i1, v1, i2, v2, s2, i3, v3, s3


def _op_nodes(ep):
    """The graph's call targets, every submodule's included."""
    out = []
    for gm in ep.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            out += [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]
    return out


def test_knn_ops_registered(tmp_path):
    """Both operators pass `torch.library.opcheck` (schema, fake tensor
    shapes, dtypes and strides against the real outputs, autograd
    registration, dynamic shapes) with and without a mask; a module calling
    the wrappers exports with one operator node a call, survives save and
    load, and computes what the plain versions compute."""
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(2, 64, 5).astype(np.float32))
    mask = torch.tensor(rng.rand(2, 64) > 0.3)
    for m in (mask, None):
        for precision in ("highest", "default"):
            torch.library.opcheck(ops.knn, (x, 6, m, precision))
            torch.library.opcheck(ops.knn_banded, (x, 6, m, 16, precision))
    meta = ops.knn(torch.empty(3, 10, 4, device="meta"), 4, None, "highest")
    assert [(t.shape, t.dtype) for t in meta] == [
        ((3, 10, 4), torch.int32), ((3, 10, 4), torch.bool), ((3, 10, 4), torch.float32)]

    with torch.no_grad():
        ep = torch.export.export(_Builds(), (x, mask))
    nodes = _op_nodes(ep)
    assert nodes.count("dgcnn_tpu_torch.knn.default") == 2
    assert nodes.count("dgcnn_tpu_torch.knn_banded.default") == 1
    assert not [t for t in nodes if "sort" in t or "topk" in t]
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    buf.seek(0)
    got = torch.export.load(buf).module()(x, mask)
    want = (*kmod.knn_plain(x, x, 5, mask)[:2], *kmod.knn_plain(x, x, 5, None, "default"),
            *bmod.knn_banded_plain(x, x, 5, mask, window=64))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("window", [0, 32])
def test_exported_model_has_one_operator_node_a_graph_build(monkeypatch, tmp_path, window):
    """The model exported with the kernel wrappers as its graph builds (the
    card's choice, on CPU tensors here): one registered operator node a
    block, no inlined plain kNN (no top-k; the banded model keeps its one
    Morton sort), and the live forward's scores bit for bit."""
    cfg = Config(**{**SMALL, "edge_filters": (8, 8, 8), "knn_window": window})
    wrapper = (functools.partial(bmod.knn_banded_cuda, window=window) if window
               else kmod.knn_cuda)
    monkeypatch.setattr(ttrainval, "knn_fn_for", lambda *a: wrapper)
    tv = ttrainval.Trainval(cfg, device="cpu")
    state = tv.initialize(4, generator=torch.Generator().manual_seed(0))
    blob = texport.export_model(cfg, state, batch=0, device="cpu")
    nodes = _op_nodes(torch.export.load(io.BytesIO(blob)))
    op = "dgcnn_tpu_torch.knn_banded.default" if window else "dgcnn_tpu_torch.knn.default"
    assert nodes.count(op) == 3
    assert not [t for t in nodes if "topk" in t]
    assert len([t for t in nodes if "sort" in t]) == (1 if window else 0)
    pts, mask = _inputs(3, 3, nvalid=np.array([[128], [77], [128]]))
    served = load_exported(blob)(torch.tensor(pts), torch.tensor(mask))
    scores, _, _ = tv.inference(state, (pts, np.zeros(mask.shape, np.int64), None, mask))
    torch.testing.assert_close(served, scores, rtol=0, atol=0)


BLOCKED = ("jax", "jaxlib", "flax", "optax", "dgcnn_tpu", "msgpack", "h5py", "tensorboard",
           "dgcnn_tpu_torch.models", "dgcnn_tpu_torch.io", "dgcnn_tpu_torch.config")


@pytest.mark.parametrize("builds", ["oracle", "operators"])
def test_artifact_serves_without_the_package(monkeypatch, tmp_path, builds):
    """A fresh process with JAX, the models, the IO and the configuration
    blocked, and the checkpoint deleted, loads the artifact and serves the
    live scores bit for bit: with the CPU's oracle graph builds, and with
    the registered operators the card's artifact holds (which the load
    registers)."""
    cfg = JaxConfig(command="train", **SMALL)
    _jax_checkpoint(str(tmp_path / "w/s"), cfg)
    ckpt = str(tmp_path / "w/s-1.ckpt")
    if builds == "operators":
        monkeypatch.setattr(ttrainval, "knn_fn_for", lambda *a: kmod.knn_cuda)
    path = _port_export({}, ckpt, str(tmp_path / "m.pt2"))
    pts, mask = _inputs(7, 2, nvalid=np.array([[128], [60]]))
    tv = ttrainval.Trainval(Config(**SMALL), device="cpu")
    state, _ = tv.restore_for_eval(tv.initialize(4), ckpt)
    scores, _, _ = tv.inference(state, (pts, np.zeros(mask.shape, np.int64), None, mask))
    np.savez(tmp_path / "live.npz", pts=pts, mask=mask, scores=scores.numpy())
    os.remove(ckpt)
    code = (
        "import sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "from dgcnn_tpu_torch.train.export import load_exported\n"
        "d = np.load(sys.argv[2])\n"
        "got = load_exported(sys.argv[1])(torch.tensor(d['pts']), torch.tensor(d['mask']))\n"
        "assert torch.equal(got, torch.tensor(d['scores'])), float((got - torch.tensor(d['scores'])).abs().max())\n"
        "assert 'dgcnn_tpu_torch.kernels.ops' in sys.modules\n"
        "assert not [k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'dgcnn_tpu')\n"
        "            and sys.modules[k] is not None]\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code, path, str(tmp_path / "live.npz")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
