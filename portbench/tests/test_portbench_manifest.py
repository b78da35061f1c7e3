"""``BENCHMARK.json`` against its contract, the files and networks it
names resolve by name, a later network or cell is new files only, and the
harness loads nothing of JAX or the JAX package."""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench import harness, run

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_entries_have_exactly_the_contracts_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    for section, keys in KEYS.items():
        for e in BENCH[section]:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert keys <= set(e) <= keys | extra, (section, e)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_command_paths_and_run_seconds():
    assert BENCH["paths"] == ["portbench"] and len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w for w in BENCH["command"])
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits in 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_fields():
    for section in KEYS:
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names)), section
        for e in BENCH[section]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher"), e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_configs_resolve_and_are_used():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used and _line(c["source"]) and len(c["reduced"]) <= 16
        assert _line(c["why"])
        assert c["file"].startswith("portbench/configs/")
        d = json.load(open(os.path.join(ROOT, c["file"])))
        assert d["name"] == c["name"] and d["reduced"] == c["reduced"]
        assert d["peak_flops"] in __import__("portbench.flops").flops.DATASHEET_FLOPS.values()
        net = harness.load_network(d["network"])
        assert set(net.MODELLED) == {"model", "port", "reference", "control"}
        assert all(callable(getattr(net, f)) for f in (
            "config_kwargs", "make_weights", "Reference", "work"))
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", CELLS)
def test_every_cells_files_resolve_by_name(cell):
    c = harness.load_cell(cell)
    assert c.traffic["kind"] in ("train", "serve") and c.limits
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(harness.load_reader(m["name"]).read)


def test_each_per_layer_metric_moves_one_metric_all_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = open(os.path.join(ROOT, "PERF.md")).read()
    assert all(layer in perf for layer in layers)


def _digests(root: str) -> dict:
    """Each file under ``root`` (bytecode caches aside) by its digest."""
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _copy(root: str) -> str:
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return os.path.join(root, "portbench")


def test_a_later_cell_is_new_files_and_entries(tmp_path):
    """A later network, configuration, traffic mix, cell and per-layer
    metric are new files and new entries of ``BENCHMARK.json``: the
    network a copy of ``residual_dgcnn`` whose ``MODELLED`` also admits
    EdgeConv MLPs of two layers (``port.block_convs``), which
    ``residual_dgcnn`` refuses. No file that was there is written to."""
    root = str(tmp_path)
    pb = _copy(root)
    before = _digests(root)
    nets = os.path.join(pb, "networks")
    shutil.copytree(os.path.join(nets, "residual_dgcnn"), os.path.join(nets, "later_net"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(nets, "later_net", "__init__.py"), "a") as f:
        f.write('\nMODELLED = {**MODELLED, "port": {**MODELLED["port"], "block_convs": None}}\n')
    cfg = json.load(open(os.path.join(pb, "configs", "residual-dgcnn-f32.json")))
    cfg.update(name="later-config", network="later_net")
    cfg["port"]["block_convs"] = 2
    json.dump(cfg, open(os.path.join(pb, "configs", "later-config.json"), "w"))
    json.dump({"kind": "serve", "pool": 8, "num_point": 2048, "variable_length": True,
               "num_class": 2, "batch": 2, "buckets": [2048], "warmup_batches": 1,
               "checked_batches": 2}, open(os.path.join(pb, "traffic", "later-mix.json"), "w"))
    json.dump({"limits": {"score_gap_mean": 1e-3}},
              open(os.path.join(pb, "cells", "later-cell.json"), "w"))
    with open(os.path.join(pb, "metrics", "later_metric.serve.py"), "w") as f:
        f.write("def read(t):\n    return 42.0 if t.kind == 'serve' else None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "later-config", "source": "https://example.org/x",
                             "file": "portbench/configs/later-config.json", "reduced": [],
                             "why": "a fixture"})
    bench["workloads"].append({"name": "later-cell", "config": "later-config",
                               "traffic": "later-mix", "chips": 1, "why": "a fixture"})
    bench["end_to_end"][0].setdefault("workloads", []).append("later-cell")
    bench["per_layer"].append({"name": "later_metric.serve", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "serve_points_per_s", "workloads": ["later-cell"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    c = harness.load_cell("later-cell", root)
    assert c.config["name"] == "later-config" and c.traffic["batch"] == 2
    assert os.path.dirname(c.network.__file__) == os.path.realpath(
        os.path.join(nets, "later_net"))
    assert c.network.MODELLED["port"]["block_convs"] is None
    assert harness.port_config(c, 1).block_convs == 2
    assert c.limits == {"score_gap_mean": 1e-3}
    assert [m["name"] for m in c.per_layer] == ["later_metric.serve"]

    class T:
        kind = "serve"

    assert harness.load_reader("later_metric.serve", root).read(T) == 42.0
    # the accepted network refuses the same configuration
    cfg["network"] = "residual_dgcnn"
    json.dump(cfg, open(os.path.join(pb, "configs", "later-config.json"), "w"))
    with pytest.raises(ValueError, match="'residual_dgcnn' do not model port.block_convs"):
        harness.load_cell("later-cell", root)
    after = _digests(root)
    assert [f for f in before if f != "BENCHMARK.json" and after[f] != before[f]] == []
    for section in KEYS:
        for old, now in zip(BENCH[section], bench[section]):
            assert {k: v for k, v in old.items() if k != "workloads"} == \
                   {k: v for k, v in now.items() if k != "workloads"}
            assert set(old.get("workloads", CELLS)) <= set(now.get("workloads", CELLS))


def test_forbidden_modules_are_matched_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "dgcnn_tpu_torch_like", sys)
    assert "dgcnn_tpu_torch" not in run.loaded_forbidden()
    assert all(m.split(".")[0] in run.FORBIDDEN for m in run.loaded_forbidden())
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in run.loaded_forbidden()


BLOCK = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "dgcnn_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
from portbench import control, harness, run
for cell in {cells!r}:
    c = harness.load_cell(cell)
    for m in c.per_layer:
        harness.load_reader(m["name"])
    harness.port_config(c, 2**31 + 1)
from dgcnn_tpu_torch.train.trainval import Trainval
from dgcnn_tpu_torch.io import BucketBatcher, prefetch
assert not run.loaded_forbidden(), run.loaded_forbidden()
print("ok")
"""


def test_the_harness_imports_with_jax_and_the_jax_package_blocked():
    out = subprocess.run([sys.executable, "-c", BLOCK.format(cells=CELLS)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_a_run_without_a_card_fails_and_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("section,key,value", [
    ("port", "knn_window", 8192), ("port", "knn_every", 2), ("port", "block_convs", 2),
    ("port", "precision", "bfloat16"), ("port", "knn_precision", "default"),
    ("train", "optimizer", "sgd"), ("model", "name", "dgcnn"),
    ("traffic", "variable_length", True),
])
def test_a_configuration_the_harness_does_not_model_is_refused(tmp_path, section, key, value):
    """By the network's ``MODELLED`` (``model``, ``port``) or the harness's
    (``train``, ``traffic``)."""
    root = str(tmp_path)
    _copy(root)
    cell = harness.load_cell(CELLS[0], root)
    if section == "traffic":
        path = os.path.join(root, "portbench", "traffic",
                            next(w["traffic"] for w in BENCH["workloads"]
                                 if w["name"] == CELLS[0]) + ".json")
        d = dict(cell.traffic)
        d[key] = value
    else:
        path = os.path.join(root, next(c["file"] for c in BENCH["configs"]
                                       if c["name"] == cell.config["name"]))
        d = json.loads(json.dumps(cell.config))
        d[section][key] = value
    json.dump(d, open(path, "w"))
    with pytest.raises(ValueError, match=f"{section}.{key}"):
        harness.load_cell(CELLS[0], root)


@pytest.mark.parametrize("network,message", [
    (None, "names no network"), ("no_such_net", "no network 'no_such_net'"),
    ("../configs", "not a name"),
])
def test_a_configuration_without_a_network_of_the_benchmark_is_refused(tmp_path, network,
                                                                        message):
    root = str(tmp_path)
    _copy(root)
    cfg = next(c for c in BENCH["configs"]
               if c["name"] == next(w["config"] for w in BENCH["workloads"]
                                    if w["name"] == CELLS[0]))
    path = os.path.join(root, cfg["file"])
    d = json.load(open(path))
    if network is None:
        del d["network"]
    else:
        d["network"] = network
    json.dump(d, open(path, "w"))
    with pytest.raises(ValueError, match=re.escape(message)):
        harness.load_cell(CELLS[0], root)


def test_a_cell_on_several_cards_is_refused(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"][0]["chips"] = 4
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    with pytest.raises(ValueError, match="4 cards"):
        harness.load_cell(CELLS[0], root)
