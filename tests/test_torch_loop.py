"""The port's driver loops against the JAX package's, on the CPU.

Train parity: both loops start from one JAX-written checkpoint (``-mp``)
and train on the same `SyntheticIO` stream, each loop's `Trainval` patched
here (never in ``dgcnn_tpu/``) to take a pinned ring graph, so a near-tie
kNN choice cannot part the trajectories; the plain ``dgcnn`` without the
global pool under Adam (see tests/test_torch_train_trainer.py for why),
the flagship ``residual-dgcnn`` under SGD. The CSV ``loss`` (and
``val_loss``) columns agree within 1e-5 relative at every report and the
final checkpoints within 1e-4 relative, with an absolute floor of 1e-4 of
the largest parameter. A port run resumed from its checkpoint equals the
uninterrupted run bitwise at dropout 0.5. Inference from one JAX
checkpoint writes the same events and points; predictions are identical
where the top-two score margin exceeds 1e-4 and scores agree within 1e-5.
The rest are the JAX package's loop tests (tests/test_cli_loop.py,
test_schedules_resume.py, test_validation.py, test_preemption.py) on the
port, and the loops' data-parallel branches: ``-nd 2`` through
`cli.main` on gloo ranks against the JAX loop on a 2-device mesh,
inference on two ranks against one process, the hosts' `SubsetIO` slices,
and two processes joined from a launcher's variables stopping together
on a signal to one.
"""

import csv
import dataclasses
import functools
import glob
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.config import Config as JaxConfig
from dgcnn_tpu.io import SyntheticIO as JaxSyntheticIO
from dgcnn_tpu.io import write_canonical as jax_write_canonical
from dgcnn_tpu.train import checkpoint as jck
from dgcnn_tpu.train import loop as jloop
from dgcnn_tpu.train.trainval import Trainval as JaxTrainval
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.train import checkpoint as ck
from dgcnn_tpu_torch.train import loop
from dgcnn_tpu_torch.train.trainval import Trainval

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(command="train", io_type="synthetic", num_class=2, kvalue=6, edge_filters=(8,),
             head_feat_dim=16, head_mlp=(16,), minibatch_size=4, num_point=128,
             iteration=8, report_step=4, checkpoint_step=0, use_pallas=False, seed=7)


def _cfg(tmp_path, **kw):
    return Config(**{**SMALL, "weight_prefix": str(tmp_path / "w/s"),
                     "log_dir": str(tmp_path / "log"), **kw})


def _ring(n, k):
    return (np.arange(n)[:, None] + np.arange(k)[None]) % n


def _jax_ring(x, k, mask):
    idx = jnp.asarray(_ring(x.shape[-2], k), jnp.int32) + (x[..., :1] * 0).astype(jnp.int32)
    return idx, jnp.ones(idx.shape, bool)


def _port_ring(x, k, mask):
    idx = torch.tensor(_ring(x.shape[-2], k), dtype=torch.int32, device=x.device)
    idx = idx.expand(x.shape[:-1] + (k,))
    return idx, torch.ones(idx.shape, dtype=torch.bool, device=x.device)


def _rows(log_dir, name="train"):
    with open(os.path.join(log_dir, f"{name}_log.csv")) as f:
        return list(csv.DictReader(f))


def _steps(prefix):
    return sorted(ck._step_of(prefix, p) for p in glob.glob(prefix + "-*.ckpt"))


PARITY = {
    "adam_dgcnn": dict(model_name="dgcnn", global_pool=False, optimizer="adam",
                       learning_rate=1e-3, edge_filters=(12, 16), head_mlp=(16,)),
    "sgd_residual_val": dict(model_name="residual-dgcnn", optimizer="sgd", learning_rate=0.05,
                             lr_schedule="cosine", grad_clip=0.5, val_batches=2),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_train_loop_matches_jax_from_one_checkpoint(tmp_path, monkeypatch, case):
    kw = {**SMALL, **PARITY[case], "iteration": 10, "report_step": 2, "checkpoint_step": 5,
          "num_devices": 1}
    if "val_batches" in kw:
        val = JaxSyntheticIO(num_events=8, num_point=128, seed=9).initialize()
        kw["val_file"] = str(tmp_path / "val.npz")
        jax_write_canonical(kw["val_file"], [val.read_event(i) for i in range(8)], "npz")
    jcfg0 = JaxConfig(**kw)
    start = jck.save(str(tmp_path / "init"), 0, JaxTrainval(jcfg0).initialize(4), vars(jcfg0))
    monkeypatch.setattr(jloop, "Trainval", functools.partial(JaxTrainval, knn_fn=_jax_ring))
    monkeypatch.setattr(loop, "Trainval", functools.partial(Trainval, knn_fn=_port_ring))
    run = dict(kw, model_path=start)
    jloop.train(JaxConfig(**run, weight_prefix=str(tmp_path / "j/s"),
                          log_dir=str(tmp_path / "jlog")))
    loop.train(Config(**run, weight_prefix=str(tmp_path / "p/s"),
                      log_dir=str(tmp_path / "plog")), device="cpu")

    want, got = _rows(tmp_path / "jlog"), _rows(tmp_path / "plog")
    assert list(got[0]) == list(want[0])
    assert [r["iter"] for r in got] == ["2", "4", "6", "8", "10"]
    cols = ["loss"] + (["val_loss"] if "val_file" in kw else [])
    for g, w in zip(got, want):
        assert g["lr"] == w["lr"] and g["epoch"] == w["epoch"]
        for c in cols:
            assert abs(float(g[c]) - float(w[c])) <= 1e-5 * abs(float(w[c])), (c, g, w)
    assert _steps(str(tmp_path / "p/s")) == _steps(str(tmp_path / "j/s")) == [5, 10]
    gt, wt = (ck.peek(str(tmp_path / d / "s-10.ckpt"))["tree"] for d in ("p", "j"))
    wl = jax.tree_util.tree_leaves(wt["params"])
    floor = 1e-4 * max(float(np.abs(a).max()) for a in wl)
    for sub in ("params", "model_state", "opt_state"):
        gl, wl = (jax.tree_util.tree_leaves(t[sub]) for t in (gt, wt))
        assert len(gl) == len(wl)
        for a, b in zip(gl, wl):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=floor)
    assert int(gt["step"]) == int(wt["step"]) == 10
    np.testing.assert_array_equal(gt["rng"], wt["rng"])


def _fixed_events(tmp_path, n=4, num_point=128, seed=2):
    io = JaxSyntheticIO(num_events=n, num_point=num_point, seed=seed,
                        variable_length=False).initialize()
    path = str(tmp_path / "ev.npz")
    jax_write_canonical(path, [io.read_event(i) for i in range(n)], "npz")
    return path


def test_resumed_run_equals_uninterrupted_run_with_dropout(tmp_path):
    """Dropout 0.5: the resumed run draws the masks the uninterrupted run
    drew (each step's generator is keyed by (seed, step)), and the
    optimizer's moments come back from the file. Unshuffled, and the
    resume falls on an epoch boundary, so both runs see the same
    batches."""
    data = _fixed_events(tmp_path)
    kw = dict(io_type="npz", input_file=data, minibatch_size=2, shuffle=False, dropout=0.5,
              optimizer="adam", learning_rate=1e-2, report_step=2)
    loop.train(_cfg(tmp_path / "a", iteration=8, **kw), device="cpu")
    loop.train(_cfg(tmp_path / "b", iteration=4, **kw), device="cpu")
    loop.train(_cfg(tmp_path / "b", iteration=8, auto_resume=True, **kw), device="cpu")
    a, b = (ck.peek(str(tmp_path / d / "w/s-8.ckpt"))["tree"] for d in ("a", "b"))
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)
    ra, rb = _rows(tmp_path / "a/log"), _rows(tmp_path / "b/log")
    assert [r["iter"] for r in rb] == ["2", "4", "6", "8"]
    assert [r["loss"] for r in ra] == [r["loss"] for r in rb]
    # the masks are live: without dropout the run differs
    loop.train(_cfg(tmp_path / "c", iteration=8, **{**kw, "dropout": 0.0}), device="cpu")
    c = ck.peek(str(tmp_path / "c/w/s-8.ckpt"))["tree"]
    assert not np.array_equal(c["params"]["head"]["out"]["w"], a["params"]["head"]["out"]["w"])


def test_dropout_masks_depend_on_seed_and_step():
    """Each step's generator is a function of (seed, step) alone: the same
    pair draws the same masks, another step or seed other masks."""
    from dgcnn_tpu_torch.train.trainval import dropout_generator

    def mask(seed, step):
        return torch.rand(64, generator=dropout_generator("cpu", seed, step)) < 0.5

    assert torch.equal(mask(7, 3), mask(7, 3))
    assert not torch.equal(mask(7, 3), mask(7, 4))
    assert not torch.equal(mask(7, 3), mask(8, 3))


def test_inference_matches_jax_from_one_checkpoint(tmp_path):
    """Eval mode on the real graphs (the JAX oracle and the port's)."""
    kw = dict(SMALL, model_name="residual-dgcnn", edge_filters=(8, 8), num_devices=1,
              minibatch_size=3, num_point=0, buckets=(128, 256), command="inference")
    events = JaxSyntheticIO(num_events=7, num_point=200, seed=4).initialize()
    data = str(tmp_path / "ev.npz")
    jax_write_canonical(data, [events.read_event(i) for i in range(7)], "npz")
    jcfg = JaxConfig(**dict(kw, command="train"))
    jtv = JaxTrainval(jcfg)
    state = jtv.initialize(4)
    io = JaxSyntheticIO(num_events=3, num_point=128, seed=1).initialize()
    from dgcnn_tpu.io import BucketBatcher as JaxBatcher

    for batch in JaxBatcher(io, 3, num_point=128).epoch():
        state, _ = jtv.train_step(state, batch)
    ckpt = jck.save(str(tmp_path / "w/s"), 1, state, vars(jcfg))
    run = dict(kw, io_type="npz", input_file=data, model_path=ckpt, iteration=0,
               log_dir=str(tmp_path / "log"))
    want = jloop.inference(JaxConfig(**run, output_file=str(tmp_path / "j.npz")))
    got = loop.inference(Config(**run, output_file=str(tmp_path / "p.npz")), device="cpu")
    assert got["batches"] == want["batches"] == 3
    j, p = np.load(tmp_path / "j.npz"), np.load(tmp_path / "p.npz")
    assert sorted(p.files) == sorted(j.files)
    for k in ("event_ids", "offsets", "data"):
        np.testing.assert_array_equal(p[k], j[k])
    np.testing.assert_allclose(p["scores"], j["scores"], atol=1e-5, rtol=0)
    top2 = np.sort(j["scores"], axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    np.testing.assert_array_equal(p["prediction"][clear], j["prediction"][clear])
    assert clear.mean() > 0.9
    assert abs(got["acc"] - want["acc"]) <= 1e-3


def test_train_checkpoint_resume_inference_writeback(tmp_path):
    """tests/test_cli_loop.py::test_train_checkpoint_resume_inference on
    the port: train, resume with -mp, serve a file with write-back."""
    cfg = _cfg(tmp_path, iteration=6, report_step=3, checkpoint_step=3, learning_rate=1e-2)
    loop.train(cfg, device="cpu")
    assert _steps(cfg.weight_prefix) == [3, 6]
    header = list(_rows(tmp_path / "log")[0])
    assert header[:2] == ["iter", "epoch"] and "loss" in header and header[-1] == "titer"
    loop.train(dataclasses.replace(cfg, iteration=8, model_path=cfg.weight_prefix), device="cpu")
    assert _steps(cfg.weight_prefix) == [3, 6, 8]
    data = _fixed_events(tmp_path, n=5, num_point=100)
    out = str(tmp_path / "pred.csv")
    summary = loop.inference(dataclasses.replace(
        cfg, command="inference", io_type="npz", input_file=data, model_path=cfg.weight_prefix,
        output_file=out, iteration=0, minibatch_size=2), device="cpu")
    assert summary["batches"] == 3
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 5 * 100 and sorted({int(r["event_id"]) for r in rows}) == list(range(5))
    assert set(rows[0]) == {"event_id", "x", "y", "z", "value", "prediction", "score0", "score1"}


def test_inference_adopts_checkpoint_model_flags(tmp_path, capsys):
    cfg = _cfg(tmp_path, kvalue=5, knn_every=2, iteration=2)
    loop.train(cfg, device="cpu")
    data = _fixed_events(tmp_path, n=4, num_point=96)

    def infer(out, **kw):
        return loop.inference(Config(**{**SMALL, **kw, "command": "inference", "io_type": "npz",
                                        "input_file": data, "model_path": cfg.weight_prefix,
                                        "output_file": str(tmp_path / out), "iteration": 0,
                                        "log_dir": str(tmp_path / "ilog")}), device="cpu")

    a = infer("a.npz", kvalue=5, knn_every=2)
    capsys.readouterr()
    b = infer("b.npz")
    out = capsys.readouterr().out
    assert "adopting model flags from checkpoint" in out and "kvalue=5" in out
    assert a == {**b, "batches": a["batches"]}
    np.testing.assert_array_equal(np.load(tmp_path / "a.npz")["scores"],
                                  np.load(tmp_path / "b.npz")["scores"])


def test_resume_warns_on_model_flag_mismatch(tmp_path, capsys):
    cfg = _cfg(tmp_path, iteration=2, kvalue=6)
    loop.train(cfg, device="cpu")
    capsys.readouterr()
    loop.train(dataclasses.replace(cfg, kvalue=8, iteration=3,
                                   model_path=cfg.weight_prefix + "-2.ckpt"), device="cpu")
    out = capsys.readouterr().out
    assert "WARNING: model flags differ" in out and "kvalue" in out
    assert "restored checkpoint at step 2" in out


def _serving_setup(tmp_path):
    data = _fixed_events(tmp_path, n=10, num_point=96)
    cfg = _cfg(tmp_path)
    tv = Trainval(cfg, device="cpu")
    path = ck.save(cfg.weight_prefix, 0, tv.state_tree(tv.initialize(4)), vars(cfg))
    return dataclasses.replace(cfg, command="inference", io_type="npz", input_file=data,
                               model_path=path, iteration=0, minibatch_size=2)


def test_inference_worker_error_propagates(tmp_path, monkeypatch):
    class _BoomWriter:
        def __init__(self, path):
            self.path = path

        def store_segment(self, *a, **kw):
            raise RuntimeError("disk full (injected)")

        def finalize(self):  # pragma: no cover - must not be reached
            raise AssertionError("finalize must be skipped after a worker error")

        def __len__(self):
            return 0

    monkeypatch.setattr(loop, "SegmentWriter", _BoomWriter)
    cfg = dataclasses.replace(_serving_setup(tmp_path), output_file=str(tmp_path / "p.npz"))
    with pytest.raises(RuntimeError, match="disk full"):
        loop.inference(cfg, device="cpu")
    assert not os.path.exists(tmp_path / "p.npz")


def test_inference_cm_flush_invariance(tmp_path, monkeypatch):
    cfg = _serving_setup(tmp_path)
    base = loop.inference(cfg, device="cpu")
    monkeypatch.setattr(loop, "_CM_FLUSH_POINTS", 1)
    frequent = loop.inference(cfg, device="cpu")
    assert base == frequent and base["batches"] == 5


def test_auto_resume_continues_and_cold_run_restarts(tmp_path):
    loop.train(_cfg(tmp_path, iteration=4, checkpoint_step=4), device="cpu")
    loop.train(_cfg(tmp_path, iteration=6, auto_resume=True), device="cpu")
    assert _steps(str(tmp_path / "w/s")) == [4, 6]
    assert [r["iter"] for r in _rows(tmp_path / "log")] == ["4", "6"]
    # without auto_resume the same prefix trains from step 0 and truncates the log
    loop.train(_cfg(tmp_path, iteration=2, report_step=2), device="cpu")
    assert [r["iter"] for r in _rows(tmp_path / "log")] == ["2"]


def test_max_to_keep_prunes_old_checkpoints(tmp_path):
    loop.train(_cfg(tmp_path, iteration=7, checkpoint_step=2, max_to_keep=2), device="cpu")
    assert _steps(str(tmp_path / "w/s")) == [6, 7]


def test_lr_column_reports_the_applied_rate(tmp_path):
    loop.train(_cfg(tmp_path, iteration=4, lr_schedule="cosine", learning_rate=1e-2,
                    lr_decay_steps=8), device="cpu")
    lr = float(_rows(tmp_path / "log")[0]["lr"])
    np.testing.assert_allclose(lr, 0.5e-2 * (1 + np.cos(np.pi * 3 / 8)), rtol=1e-4)


def test_early_stop_on_stale_val_loss(tmp_path):
    val = _fixed_events(tmp_path, n=4, num_point=96)
    loop.train(_cfg(tmp_path, val_file=val, val_batches=1, iteration=100, report_step=2,
                    learning_rate=0.0, early_stop_patience=2), device="cpu")
    assert _steps(str(tmp_path / "w/s"))[-1] == 6
    row = _rows(tmp_path / "log")[0]
    assert {"val_loss", "val_acc", "val_miou"} <= set(row)


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    loop.train(_cfg(tmp_path, iteration=1, profile_dir=str(tmp_path / "prof")), device="cpu")
    traces = glob.glob(str(tmp_path / "prof/trace-*.json"))
    assert traces and os.path.getsize(traces[0]) > 0


def test_augment_and_dgb_val_file(tmp_path):
    """--augment, a DGB training file with an npz validation file (the
    validation file's own extension picks its reader)."""
    from dgcnn_tpu_torch.io.dgb import write_dgb

    io = JaxSyntheticIO(num_events=8, num_point=96, seed=1).initialize()
    events = [io.read_event(i) for i in range(8)]
    write_dgb(str(tmp_path / "tr.dgb"), events)
    val = _fixed_events(tmp_path, n=4, num_point=96)
    m = loop.train(_cfg(tmp_path, io_type="dgb", input_file=str(tmp_path / "tr.dgb"),
                        val_file=val, iteration=4, report_step=2, augment=True,
                        num_point=0, buckets=(128,)), device="cpu")
    assert np.isfinite(m["loss"])
    assert np.isfinite(float(_rows(tmp_path / "log")[0]["val_loss"]))


def test_multi_process_and_cp_through_the_loop_raise_their_items(tmp_path, monkeypatch):
    """A launcher's world without its rendezvous address raises; CP through
    the loop (which raised "item 13" before the CP training slice; the
    name is kept) serves: ``point_shards=2`` on two gloo ranks, the exact
    ring, equals the one-process inference of the same checkpoint."""
    data = _fixed_events(tmp_path, n=4, num_point=128)
    cfg = _cfg(tmp_path, io_type="npz", input_file=data, iteration=2)
    # a launcher's world without its rendezvous address: a clear error,
    # not a run on one process
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR/MASTER_PORT are not set"):
        loop.train(cfg, device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    loop.train(cfg, device="cpu")
    served = {}
    for ps in (1, 2):
        out = str(tmp_path / f"pred{ps}.npz")
        served[ps] = loop.inference(dataclasses.replace(
            cfg, command="inference", point_shards=ps, model_path=cfg.weight_prefix,
            output_file=out, iteration=0, log_dir=str(tmp_path / f"log{ps}")), device="cpu")
    one, cp = (np.load(tmp_path / f"pred{ps}.npz") for ps in (1, 2))
    assert served[2]["batches"] == served[1]["batches"] == 1
    np.testing.assert_array_equal(cp["event_ids"], one["event_ids"])
    np.testing.assert_allclose(cp["scores"], one["scores"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(cp["prediction"], one["prediction"])


def test_cp_cli_train_and_serve_on_the_data_x_points_mesh(tmp_path):
    """The JAX `test_banded_cp_train_inference_writeback_loop` on the
    command line: ``train -nd 4 -ps 2`` (2 data x 2 point ranks, banded
    CP, W=32) with checkpoints, then ``inference -ps 2`` from the last one
    with write-back: every event written once, equal to a one-process
    serve of the same checkpoint (predictions equal, scores within
    1e-6)."""
    from dgcnn_tpu_torch import cli

    data = _fixed_events(tmp_path, n=8, num_point=128)
    common = ["-io", "npz", "-if", data, "-mn", "residual-dgcnn", "-mb", "2", "-np", "128",
              "-k", "8", "--edge_filters", "16", "16", "--head_feat_dim", "32", "--head_mlp",
              "32", "--knn_window", "32", "--seed", "7", "-wp", str(tmp_path / "w/s")]
    assert cli.main(["train", *common, "-i", "6", "-rs", "3", "-cs", "3", "-lr", "1e-2",
                     "-nd", "4", "-ps", "2", "-ld", str(tmp_path / "log")], device="cpu") == 0
    assert _steps(str(tmp_path / "w/s")) == [3, 6]
    rows = _rows(tmp_path / "log")
    assert [r["iter"] for r in rows] == ["3", "6"] and os.listdir(tmp_path / "log") == [
        "train_log.csv"]
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    for ps, nd in (("2", "2"), ("1", "1")):
        assert cli.main(["inference", *common, "-mp", str(tmp_path / "w/s"), "-ps", ps, "-nd",
                         nd, "-of", str(tmp_path / f"pred{ps}.npz"), "-ld",
                         str(tmp_path / f"ilog{ps}")], device="cpu") == 0
    one, cp = (np.load(tmp_path / f"pred{ps}.npz") for ps in ("1", "2"))
    assert sorted(cp["event_ids"].tolist()) == list(range(8))
    np.testing.assert_array_equal(cp["event_ids"], one["event_ids"])
    np.testing.assert_array_equal(cp["prediction"], one["prediction"])
    np.testing.assert_allclose(cp["scores"], one["scores"], rtol=0, atol=1e-6)


def test_cli_main_trains_and_serves(tmp_path):
    from dgcnn_tpu_torch import cli

    data = _fixed_events(tmp_path, n=4, num_point=96)
    common = ["-io", "npz", "-if", data, "-mb", "2", "-k", "6", "--edge_filters", "8",
              "--head_feat_dim", "16", "--head_mlp", "16", "-ld", str(tmp_path / "log")]
    assert cli.main(["train", *common, "-i", "2", "-rs", "1", "-wp", str(tmp_path / "w/s")],
                    device="cpu") == 0
    assert cli.main(["inference", *common, "-mp", str(tmp_path / "w/s"),
                     "-of", str(tmp_path / "p.npz")], device="cpu") == 0
    assert len(np.load(tmp_path / "p.npz")["event_ids"]) == 4


SCRIPT = """
import sys
sys.path.insert(0, {repo!r})
sys.modules["jax"] = None
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.train.loop import train
cfg = Config(
    command="train", io_type="synthetic", num_class=2, kvalue=6,
    edge_filters=(8,), head_feat_dim=16, head_mlp=(16,), minibatch_size=4,
    num_point=128, iteration=100000, report_step=5, checkpoint_step=0,
    use_pallas=False, seed=7, weight_prefix={prefix!r}, log_dir={logdir!r},
    auto_resume=True,
)
print("READY", flush=True)
train(cfg, device="cpu")
print("CLEAN-EXIT", flush=True)
"""


def test_sigterm_checkpoints_and_resumes(tmp_path):
    """tests/test_preemption.py on the port."""
    prefix = str(tmp_path / "w/s")
    script = SCRIPT.format(repo=REPO, prefix=prefix, logdir=str(tmp_path / "log"))
    proc = subprocess.Popen([sys.executable, "-u", "-c", script], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    deadline = time.time() + 180
    lines = []
    while True:
        if time.time() > deadline:
            proc.kill()
            raise AssertionError(f"never reached iter 10: {lines[-5:]}")
        line = proc.stdout.readline()
        if line == "":
            if proc.poll() is not None:
                raise AssertionError(f"subprocess exited rc={proc.returncode}: {lines[-10:]}")
            time.sleep(0.1)
            continue
        lines.append(line)
        if line.startswith("iter 10 "):
            break
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
    assert "checkpointing and stopping" in out
    assert "saved final checkpoint" in out and "CLEAN-EXIT" in out
    assert proc.returncode == 0
    saved = _steps(prefix)
    assert saved and saved[-1] >= 10
    loop.train(Config(**{**SMALL, "iteration": saved[-1] + 3, "report_step": 1,
                         "weight_prefix": prefix, "log_dir": str(tmp_path / "log"),
                         "auto_resume": True}), device="cpu")
    assert _steps(prefix)[-1] == saved[-1] + 3


def test_reporter_csv_and_tensorboard_like_jax(tmp_path, capsys):
    """The port's Reporter writes the JAX Reporter's CSV and report lines
    (the header extended when a resumed run gains columns)."""
    from dgcnn_tpu.train.logging import Reporter as JaxReporter
    from dgcnn_tpu_torch.train.logging import Reporter

    def drive(cls, d, **kw):
        r = cls(str(d), "train", **kw)
        r.report(2, 0.5, {"loss": 0.25, "acc": 0.5})
        r.close()
        r = cls(str(d), "train", append=True, start_iter=2)
        r.report(4, 1.0, {"loss": 0.125, "acc": 0.75, "val_loss": 0.5})
        r.close()
        with open(d / "train_log.csv") as f:
            header = f.readline().strip().split(",")
        rows = _rows(d)
        return header, [{k: v for k, v in r.items() if k != "titer"} for r in rows]

    assert drive(Reporter, tmp_path / "p") == drive(JaxReporter, tmp_path / "j")
    assert "iter 4 epoch 1.00 loss=0.1250 acc=0.7500 val_loss=0.5000" in capsys.readouterr().out


def test_reporter_without_tensorboard_keeps_the_csv(tmp_path, monkeypatch, capsys):
    """--tensorboard where it is not installed: the CSV goes on."""
    from dgcnn_tpu_torch.train.logging import Reporter

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    r = Reporter(str(tmp_path), "train", tensorboard=True)
    r.report(1, 0.1, {"loss": 1.0})
    r.close()
    assert "tensorboard writer unavailable" in capsys.readouterr().err
    assert len(_rows(tmp_path)) == 1


def test_timing_helpers(tmp_path):
    from dgcnn_tpu_torch.utils import Timer, device_memory_stats, trace

    t = Timer()
    for _ in range(3):
        with t.measure():
            time.sleep(0.001)
    assert t.count == 3 and t.mean >= 0.001
    with trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    assert glob.glob(str(tmp_path / "prof/trace-*.json"))
    with trace(""):
        pass
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}


# ------------------------------------------------ data parallelism (-nd N)

def _pin_ranks(monkeypatch):
    """The spawned ranks' trainers take the pinned ring graph too (each
    rank imports the loop afresh, so the patch travels with the rank
    function)."""
    import torch_dp_ranks

    spawn = loop.run_ranks
    monkeypatch.setattr(loop, "run_ranks", lambda fn, *a, **kw: spawn(
        functools.partial(torch_dp_ranks.pinned_loop, fn), *a, **kw))


def _dp_argv(tmp_path, data, name, *extra):
    return ["-io", "npz", "-if", data, "-mn", "residual-dgcnn", "-mb", "4", "-np", "128",
            "-k", "6", "--edge_filters", "8", "8", "--head_feat_dim", "16", "--head_mlp", "16",
            "-wp", str(tmp_path / name / "s"), "-ld", str(tmp_path / name / "log"), *extra]


def test_dp_cli_train_matches_jax_on_two_devices_and_resumes(tmp_path, monkeypatch):
    """``train -nd 2`` on two gloo ranks gives the CSV of the JAX package's
    one-process loop on a 2-device mesh (same batches, same pinned graph,
    SGD); rank 0 alone writes the log and the checkpoints, and
    ``--auto_resume`` goes on from the last one."""
    from dgcnn_tpu.config import parse_args as jax_parse_args
    from dgcnn_tpu_torch import cli

    data = _fixed_events(tmp_path, n=12, num_point=128)
    train = ["-opt", "sgd", "-lr", "0.05", "-i", "6", "-rs", "2", "-cs", "3", "-nd", "2"]
    # both loops start from one JAX-written checkpoint
    jcfg = jax_parse_args(["train", *_dp_argv(tmp_path, data, "init"), *train])
    start = jck.save(str(tmp_path / "init/s"), 0, JaxTrainval(jcfg).initialize(4), vars(jcfg))
    train += ["-mp", start]
    monkeypatch.setattr(jloop, "Trainval", functools.partial(JaxTrainval, knn_fn=_jax_ring))
    jloop.train(jax_parse_args(["train", *_dp_argv(tmp_path, data, "j"), *train]))
    _pin_ranks(monkeypatch)
    assert cli.main(["train", *_dp_argv(tmp_path, data, "p"), *train], device="cpu") == 0

    want, got = _rows(tmp_path / "j/log"), _rows(tmp_path / "p/log")
    assert [r["iter"] for r in got] == ["2", "4", "6"]  # one writer: no duplicate rows
    for g, w in zip(got, want):
        # the loss to the printed digit
        assert (g["epoch"], g["lr"], g["loss"]) == (w["epoch"], w["lr"], w["loss"]), (g, w)
        assert abs(float(g["acc"]) - float(w["acc"])) <= 1e-5 * abs(float(w["acc"])), (g, w)
    assert os.listdir(tmp_path / "p/log") == ["train_log.csv"]
    assert _steps(str(tmp_path / "p/s")) == _steps(str(tmp_path / "j/s")) == [3, 6]
    gt, wt = (ck.peek(str(tmp_path / d / "s-6.ckpt"))["tree"] for d in ("p", "j"))
    for a, b in zip(jax.tree_util.tree_leaves(gt["params"]),
                    jax.tree_util.tree_leaves(wt["params"])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)

    resume = ["-opt", "sgd", "-lr", "0.05", "-i", "8", "-rs", "2", "-nd", "2", "--auto_resume"]
    assert cli.main(["train", *_dp_argv(tmp_path, data, "p"), *resume], device="cpu") == 0
    assert [r["iter"] for r in _rows(tmp_path / "p/log")] == ["2", "4", "6", "8"]
    assert _steps(str(tmp_path / "p/s")) == [3, 6, 8]


def test_dp_cli_inference_writes_every_event_once_as_one_process(tmp_path, monkeypatch):
    """``inference -nd 2``: every rank reads the whole file and computes
    its rows, the outputs are gathered, and rank 0 alone writes each event
    once, equal to the one-process run."""
    from dgcnn_tpu_torch import cli

    data = _fixed_events(tmp_path, n=10, num_point=128)
    assert cli.main(["train", *_dp_argv(tmp_path, data, "t"), "-i", "2", "-rs", "2", "-cs", "0",
                     "-nd", "1"], device="cpu") == 0
    import torch_dp_ranks

    monkeypatch.setattr(loop, "Trainval",
                        functools.partial(Trainval, knn_fn=torch_dp_ranks.port_ring))
    _pin_ranks(monkeypatch)
    for nd in ("1", "2"):
        argv = _dp_argv(tmp_path, data, f"i{nd}", "-mp", str(tmp_path / "t/s"), "-of",
                        str(tmp_path / f"pred{nd}.npz"), "-nd", nd)
        assert cli.main(["inference", *argv], device="cpu") == 0
        assert os.listdir(tmp_path / f"i{nd}/log") == ["inference_log.csv"]
    one, two = (np.load(tmp_path / f"pred{nd}.npz") for nd in ("1", "2"))
    assert sorted(two["event_ids"].tolist()) == list(range(10))
    assert set(one.files) == set(two.files)
    for key in one.files:
        if one[key].dtype.kind == "f":
            np.testing.assert_allclose(two[key], one[key], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(two[key], one[key])


def test_two_hosts_read_the_jax_host_slices(tmp_path, monkeypatch):
    """With two hosts each host reads `host_event_range`'s slice of the
    file through `SubsetIO` (the JAX package's per-process slices) and
    batches its share of the global minibatch; the launcher's variables
    name the host."""
    import dgcnn_tpu.utils.distributed as jdist
    from dgcnn_tpu_torch.parallel.mesh import RankGroup
    from dgcnn_tpu_torch.utils.distributed import launcher_env

    data = _fixed_events(tmp_path, n=9, num_point=128)
    cfg = Config(**{**SMALL, "io_type": "npz", "input_file": data})
    for host in (0, 1):
        monkeypatch.setattr(jax, "process_index", lambda h=host: h)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        want = jdist.host_event_range(9)
        group = RankGroup(rank=0, size=1, device=torch.device("cpu"), backend="gloo",
                          stage_host=False, data_rank=host, data_size=2, host=host, hosts=2)
        io, batcher, _, total = loop._build_io(cfg, shuffle=False, group=group)
        assert (io._lo, io._hi) == want and total == 9
        assert batcher.batch_size == SMALL["minibatch_size"] // 2
        io.finalize()
        for var, val in dict(WORLD_SIZE="2", RANK=str(host), LOCAL_WORLD_SIZE="1",
                             MASTER_ADDR="127.0.0.1", MASTER_PORT="29999").items():
            monkeypatch.setenv(var, val)
        launch = launcher_env()
        assert (launch.host, launch.hosts, launch.local_rank, launch.local_size) == (host, 2, 0, 1)
    # one host of two ranks (torchrun's single-node layout)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert launcher_env()[3:] == (1, 2, 0, 1)
    with pytest.raises(ValueError, match="num_point"):
        loop._build_io(dataclasses.replace(cfg, num_point=0), shuffle=False, group=group)


LAUNCHED = """
import sys
sys.path.insert(0, {repo!r})
sys.modules["jax"] = None
from dgcnn_tpu_torch.io import readers
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.train import loop
from dgcnn_tpu_torch.train.trainval import Trainval

class Sub(readers.SubsetIO):
    def __init__(self, io, lo, hi):
        print("SLICE", lo, hi, flush=True)
        super().__init__(io, lo, hi)

readers.SubsetIO = Sub
steps = []

class Counting(Trainval):
    def train_step(self, state, batch):
        steps.append(state.step)
        if len(steps) == 6:
            print("READY", flush=True)
        return super().train_step(state, batch)

loop.Trainval = Counting
cfg = Config(
    command="train", io_type="npz", input_file={data!r}, num_class=2, kvalue=6,
    edge_filters=(8,), head_feat_dim=16, head_mlp=(16,), minibatch_size=4,
    num_point=128, iteration=100000, report_step=5, checkpoint_step=0,
    use_pallas=False, seed=7, weight_prefix={prefix!r}, log_dir={logdir!r},
)
loop.train(cfg, device="cpu")
print("STEPS", len(steps), flush=True)
"""


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launched_hosts_stop_together_on_one_rank_signal(tmp_path):
    """Two processes a launcher started, each its own host (the launcher's
    variables, a rendezvous on localhost): each reads its host's slice;
    SIGTERM to rank 1 alone stops both at the same step, and rank 0
    checkpoints there."""
    data = _fixed_events(tmp_path, n=16, num_point=128)
    prefix = str(tmp_path / "w/s")
    script = LAUNCHED.format(repo=REPO, data=data, prefix=prefix, logdir=str(tmp_path / "log"))
    port = str(_free_port())
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank), LOCAL_WORLD_SIZE="1",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        procs.append(subprocess.Popen([sys.executable, "-u", "-c", script], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        deadline = time.time() + 180
        lines = []
        while not any(line.startswith("READY") for line in lines):
            if time.time() > deadline or procs[1].poll() is not None:
                raise AssertionError(f"rank 1 never reached step 6: {lines[-10:]}")
            line = procs[1].stdout.readline()
            if line:
                lines.append(line)
        procs[1].send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs[1] = "".join(lines) + outs[1]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "checkpointing and stopping" in outs[1]
    slices = [[ln.split()[1:] for ln in out.splitlines() if ln.startswith("SLICE")]
              for out in outs]
    assert slices == [[["0", "8"]], [["8", "16"]]]
    stopped = [[ln for ln in out.splitlines() if ln.startswith("STEPS")] for out in outs]
    assert stopped[0] == stopped[1] and len(stopped[0]) == 1, stopped
    assert "saved final checkpoint" in outs[0] and "saved final checkpoint" not in outs[1]
    assert _steps(prefix) == [int(stopped[0][0].split()[1])]


SPAWNED = """
import sys
sys.path.insert(0, {repo!r})
sys.modules["jax"] = None
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.train import loop

if __name__ == "__main__":
    cfg = Config(
        command="train", io_type="synthetic", num_class=2, kvalue=6,
        edge_filters=(8,), head_feat_dim=16, head_mlp=(16,), minibatch_size=4,
        num_point=128, iteration=100000, report_step=5, checkpoint_step=0,
        use_pallas=False, seed=7, weight_prefix={prefix!r}, log_dir={logdir!r},
        num_devices=2,
    )
    loop.train(cfg, device="cpu")
    print("CLEAN-EXIT", flush=True)
"""


def test_sigterm_to_the_caller_stops_the_spawned_ranks(tmp_path):
    """``-nd 2`` spawns the ranks; a SIGTERM to the calling process is
    passed on to both, which agree on the stop step, and rank 0 writes the
    final checkpoint there before the caller exits cleanly."""
    prefix = str(tmp_path / "w/s")
    script = SPAWNED.format(repo=REPO, prefix=prefix, logdir=str(tmp_path / "log"))
    proc = subprocess.Popen([sys.executable, "-u", "-c", script], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        deadline = time.time() + 180
        while not any(line.startswith("iter 10 ") for line in lines):
            if time.time() > deadline or proc.poll() is not None:
                raise AssertionError(f"never reached iter 10: {lines[-10:]}")
            line = proc.stdout.readline()
            if line:
                lines.append(line)
        proc.send_signal(signal.SIGTERM)
        out = "".join(lines) + proc.communicate(timeout=120)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-3000:]
    assert out.count("checkpointing and stopping") == 2  # once on each rank
    assert "saved final checkpoint" in out and "CLEAN-EXIT" in out
    saved = _steps(prefix)
    assert len(saved) == 1 and saved[0] >= 10
