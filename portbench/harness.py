"""The benchmark's core: find a cell's files by name, set the program up,
drive the measured window, and judge what it produced.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix;
the harness reads

- ``portbench/configs/<config>.json``: the network it runs
  (``network``), the model's sizes (``model``), the flags the program
  runs them with (``port``), the optimizer (``train``), the peak its
  precision is held against (``peak_flops``), the reference's precisions
  and the control's (``reference``, ``control``) and the kernel libraries
  its path launches (``kernels``);
- ``portbench/networks/<network>/``: everything that describes one
  network (`portbench.networks`): the keys and values of the
  configuration it models, its `Config` fields, its weights, its plain
  reference and its work count;
- ``portbench/traffic/<traffic>.json``: the kind of work (``train`` or
  ``serve``), the events (`events.event_pool`), the batch, and for
  serving the padding buckets and how many batches the check samples;
- ``portbench/cells/<cell>.json``: the limits of the numbers compared;
- ``portbench/metrics/<metric>.py``: a per-layer metric's reader, a
  ``read(trace)`` that returns a number or None.

So a later network, configuration, traffic mix, cell or per-layer
metric is new files and new entries of ``BENCHMARK.json``. The harness
itself models the optimizer and the traffic (`MODELLED`), and the
network the rest of the configuration (its ``MODELLED``); a file with a
key or a value outside them is refused when the cell loads, since it
would be counted and judged as something it is not.

Train cells: set-up builds one `Trainval` with the benchmark's weights,
feeds it the pool's events through the port's `BucketBatcher` and
`prefetch`, and takes ``checked_steps`` steps through the window's own
call (`Trainval.train_step`); it keeps each step's loss, the first
gradient as Adam's first moment holds it after one step (``0.1 g``), and
the parameters' change after the last. The window goes on with the same
object. Afterwards the reference follows those steps on the same events
from the same weights.

Serve cells: the ``inference`` command's loop (`train/loop.py`), one
client labelling as fast as the card goes: each batch from the prefetch
iterator goes through `Trainval.inference_packed`, and a consumer thread
behind a queue of 3 copies its packed output to the host, so the next
batch's forward overlaps that copy. A
sample of the window's batches, drawn from the seed, is kept and the
reference computes each of their events alone afterwards.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib.util
import json
import os
import queue
import re
import sys
import threading
import time

import numpy as np
import torch

from portbench import check, events, trace
from portbench.tree import flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
ANY = None
# The keys of the sections the harness models, and where only some
# values are modelled, those; a network's ``MODELLED`` holds the rest of
# the configuration's. The checked readings take the first gradient from
# Adam's first moment (`_train`), and the reference's train steps stack a
# step's events unpadded, so variable-length training is refused.
MODELLED = {
    "train": {"optimizer": ("adam",), "learning_rate": ANY},
    "traffic": {"kind": ("train", "serve"), "pool": ANY, "num_point": ANY,
                "variable_length": ANY, "num_class": ANY, "batch": ANY, "buckets": ANY,
                "warmup_batches": ANY, "checked_batches": ANY, "checked_steps": ANY},
}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the entries of BENCHMARK.json this cell reports
    per_layer: list
    network: object  # the configuration's package of `portbench.networks`
    root: str = ROOT


def _json(root: str, *parts) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def _named(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def refuse_unmodelled(sections: dict, network: str, modelled: dict) -> None:
    """Raise ``ValueError`` naming every key or value of ``sections``
    (``{section: dict}``) that neither `MODELLED` nor ``network``'s
    ``modelled`` holds."""
    modelled = {**modelled, **MODELLED}
    bad = []
    for section, d in sections.items():
        for key, value in d.items():
            allowed = modelled[section]
            if key not in allowed:
                bad.append(f"{section}.{key}")
            elif allowed[key] is not ANY and value not in allowed[key]:
                bad.append(f"{section}.{key}={value!r}")
    if sections["traffic"]["kind"] == "train" and sections["traffic"]["variable_length"]:
        bad.append("traffic.variable_length=True with kind 'train'")
    if bad:
        raise ValueError(f"the harness and network {network!r} do not model " + ", ".join(bad))


def load_network(name: str, root: str = ROOT):
    """The package ``portbench/networks/<name>/`` of ``root``, imported
    by its path (once a path)."""
    path = os.path.realpath(os.path.join(root, "portbench", "networks", _named(name)))
    init = os.path.join(path, "__init__.py")
    if not os.path.isfile(init):
        raise ValueError(f"no network {name!r}: no package {path}")
    key = f"portbench_network_{name}_{hashlib.sha1(path.encode()).hexdigest()[:12]}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, init,
                                                      submodule_search_locations=[path])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod  # for the package's relative imports
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, its files read."""
    bench = _json(root, "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    if int(wl["chips"]) != 1:
        raise ValueError(f"the harness does not model {name!r} on {wl['chips']} cards: it "
                         "drives one card")
    cfg = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = _json(root, cfg["file"])
    if "network" not in config:
        raise ValueError(f"configuration {cfg['name']!r} names no network")
    network = load_network(config["network"], root)
    traffic = _json(root, "portbench", "traffic", _named(wl["traffic"]) + ".json")
    refuse_unmodelled({**{k: config[k] for k in ("model", "train", "port", "reference",
                                                  "control")}, "traffic": traffic},
                      config["network"], network.MODELLED)
    return Cell(
        name=name,
        chips=int(wl["chips"]),
        config=config,
        traffic=traffic,
        limits=_json(root, "portbench", "cells", _named(name) + ".json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        network=network,
        root=root,
    )


def load_reader(metric: str, root: str = ROOT):
    """The module of ``portbench/metrics/<metric>.py``."""
    path = os.path.join(root, "portbench", "metrics", _named(metric) + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_config(cell: Cell, seed: int):
    """The program's `Config` for the cell."""
    from dgcnn_tpu_torch.config import Config

    t = cell.traffic
    return Config(
        **cell.network.config_kwargs(cell.config["model"]), dropout=0.0,
        optimizer=cell.config["train"]["optimizer"],
        learning_rate=cell.config["train"]["learning_rate"],
        minibatch_size=t["batch"], num_point=t["num_point"] if t["kind"] == "train" else 0,
        buckets=tuple(t.get("buckets", (t["num_point"],))), shuffle=False,
        num_devices=cell.chips, seed=int(seed) % 2**31, **cell.config["port"],
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pool_reader(pool):
    """The pool as a reader of the program's IO layer."""
    from dgcnn_tpu_torch.io.readers import Event, IOBase

    class PoolIO(IOBase):
        def initialize(self):
            return self

        def num_events(self):
            return len(pool)

        def read_event(self, i):
            return Event(id=i, points=pool[i].points, labels=pool[i].labels)

    return PoolIO()


def _stream(cfg, pool):
    from dgcnn_tpu_torch.io import BucketBatcher, prefetch

    batcher = BucketBatcher(_pool_reader(pool), batch_size=cfg.minibatch_size,
                            buckets=cfg.buckets, num_point=cfg.num_point, shuffle=False,
                            seed=cfg.seed)
    return prefetch(batcher.forever(), cfg.prefetch)


def _to_host(tree):
    """A copy of a tree of tensors in host memory."""
    return {k: (_to_host(v) if isinstance(v, dict) else [_to_host(x) for x in v]
                if isinstance(v, list) else v.detach().to("cpu", copy=True))
            for k, v in tree.items()}


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


@dataclasses.dataclass
class Window:
    """What the program did in set-up and in the measured window."""

    setup_s: float
    marks: list  # (phase, seconds) of set-up
    seconds: float
    units: list  # valid points of each event, a list a step or batch
    failed: int
    latencies: list  # serve: seconds a batch
    peak_bytes: int
    checked: object  # train: the checked steps' readings; serve: the sample
    trace: object = None  # the traced window (`trace.Trace`)


def program(cell: Cell, seed: int, seconds: float, traced: bool, device, t0: float) -> Window:
    """The program's side of a run, on ``device``: set-up, the window,
    and its trace."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    marks = [("imports", time.perf_counter())]
    if cuda:
        from dgcnn_tpu_torch.kernels import _build

        torch.cuda.init()
        marks.append(("cuda", time.perf_counter()))
        _build.load_many(cell.config["kernels"])
        torch.cuda.reset_peak_memory_stats(device)
        marks.append(("kernels", time.perf_counter()))
    pool = events.event_pool(cell.traffic, seed)
    marks.append(("events", time.perf_counter()))
    params, mstate = cell.network.make_weights(cell.config["model"], seed, device)
    cfg = port_config(cell, seed)
    rec = trace.Recorder(traced, cuda)
    marks.append(("weights", time.perf_counter()))
    kind = cell.traffic["kind"]
    if kind == "train":
        w = _train(cell, cfg, pool, params, mstate, seconds, rec, device, t0)
    else:
        w = _serve(cell, cfg, pool, params, mstate, seconds, rec, seed, device, t0)
    marks.append(("warm-up", t0 + w.setup_s))
    w.marks = [(name, b - a) for (_, a), (name, b) in zip([("process", t0)] + marks, marks)]
    if traced:
        ops, bounds = window_work(cell, w.units)
        w.trace = trace.reduce(rec, kind, len(w.units), ops, bounds,
                               cell.config["peak_flops"], w.latencies)
    return w


def window_work(cell: Cell, units: list) -> tuple[float, dict]:
    """The model operations of the window's steps or batches (``units``:
    each one's valid points an event), and their kernels' least seconds by
    family, as the cell's network counts them (each by `sum`, whose float
    sum is compensated)."""
    works = [cell.network.work(cell.config["model"], u, cell.traffic["num_point"],
                               cell.traffic["kind"] == "train", cell.config["peak_flops"])
             for u in units]
    families = dict.fromkeys(f for _, b in works for f in b)
    return (sum(o for o, _ in works),
            {f: sum(b.get(f, 0) for _, b in works) for f in families})


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t0: float) -> dict:
    """One run of ``cell``: its result line's fields, and ``checks``. The
    reference runs after the program's state is freed, on weights it
    makes again from the seed."""
    device = torch.device(device)
    w = program(cell, seed, seconds, traced, device, t0)
    print("setup: " + ", ".join(f"{name} {dt:.3f} s" for name, dt in w.marks),
          file=sys.stderr, flush=True)
    pool = events.event_pool(cell.traffic, seed)
    init = cell.network.make_weights(cell.config["model"], seed, device)
    if cell.traffic["kind"] == "train":
        checks = check.train(cell, w.checked, train_reference(cell, pool, init, w.checked,
                                                               device))
    else:
        checks = check.serve(cell, w.checked, serve_reference(cell, pool, init, w.checked,
                                                               device))
    points = sum(sum(u) for u in w.units)
    metrics = {}
    out = {"attempted": len(w.units), "failed": w.failed,
           "device": device_info(device, w.peak_bytes, cell.chips)}
    if traced:
        for m in cell.per_layer:
            v = load_reader(m["name"], cell.root).read(w.trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["device"].update(busy_s=w.trace.busy_s, window_s=w.trace.window_s)
        out["breakdown"] = trace.breakdown(w.trace)
    else:
        e2e = {
            "setup_s": w.setup_s,
            "train_points_per_s": points / w.seconds,
            "train_peak_gib": w.peak_bytes / 2**30,
            "serve_points_per_s": points / w.seconds,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    out["metrics"] = metrics
    out["correct"] = (w.failed == 0 and len(w.units) > 0
                      and all(c["value"] <= c["limit"] for c in checks.values()))
    out["checks"] = checks
    return out


def device_info(device: torch.device, peak_bytes: int, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": peak_bytes, "power_limit_w": power_limit()}


def power_limit():
    """The card's power limit in watts, as ``nvidia-smi`` reads it."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


# ------------------------------------------------------------------ train


def _train(cell, cfg, pool, params, mstate, seconds, rec, device, t0):
    from dgcnn_tpu_torch.train.trainval import Trainval

    init = (_to_host(params), _to_host(mstate))
    tv = Trainval(cfg, device=device)
    state = tv.with_params(params, mstate)
    del params, mstate
    stream = _stream(cfg, pool)
    try:
        readings = {"loss": [], "ids": []}
        for step in range(int(cell.traffic["checked_steps"])):
            batch = next(stream)
            state, m = tv.train_step(state, batch)
            readings["loss"].append(m["loss"])
            readings["ids"].append([int(i) for i in batch.event_ids])
            if step == 0:
                # Adam's first moment after one step from zero is 0.1 g
                readings["grad1"] = {name: _norm(mu) / 0.1 for (name, _), mu in
                                     zip(flatten(init[0]), state.opt_state["mu"])}
        readings["loss"] = [float(v) for v in readings["loss"]]
        readings["change"] = {name: p.detach().to("cpu", copy=True) - p0 for (name, p0), (_, p)
                              in zip(flatten(init[0]), flatten(state.params))}
        _sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        rec.start()
        setup_s = time.perf_counter() - t0
        units, losses = [], []
        with rec.span("portbench.window"):
            start = time.perf_counter()
            while True:
                with rec.span("portbench.batch_wait"):
                    batch = next(stream)
                with rec.span("portbench.step"):
                    state, m = tv.train_step(state, batch)
                losses.append(m["loss"])
                units.append([int(v) for v in batch.mask.sum(axis=1)])
                if time.perf_counter() - start >= seconds:
                    break
            _sync(device)
            elapsed = time.perf_counter() - start
        rec.stop()
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    finally:
        stream.close()
    del tv, state, m, batch
    _free(device)
    return Window(setup_s, [], elapsed, units, failed, [], peak, readings)


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _train_batches(pool, ids, device):
    """The reference's ``(points, labels)`` of each step's events."""
    return [(torch.as_tensor(np.stack([pool[i].points for i in step]), device=device),
             torch.as_tensor(np.stack([pool[i].labels for i in step]), device=device).long())
            for step in ids]


def train_reference(cell, pool, init, readings, device, side="reference", weights_fn=None):
    ref = cell.network.Reference(cell.config["model"], **cell.config[side])
    out = ref.train(init[0], init[1],
                    _train_batches(pool, readings["ids"], device),
                    float(cell.config["train"]["learning_rate"]), weights_fn)
    return {"loss": out["loss"], "grad1": {k: v.cpu() for k, v in out["grad1"].items()},
            "change": {k: v.cpu() for k, v in out["change"].items()}}


# ------------------------------------------------------------------ serve


class Reservoir:
    """A uniform sample of ``size`` items of a stream, drawn from ``seed``."""

    def __init__(self, size: int, seed: int):
        self.size, self.items, self.seen = size, [], 0
        self.rng = np.random.RandomState(int(seed) % 2**32)

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randint(0, self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def _serve(cell, cfg, pool, params, mstate, seconds, rec, seed, device, t0):
    """The serving loop of `train/loop.py`'s ``_inference``: the main
    thread dispatches each batch's forward and hands the packed output to
    a consumer thread behind a queue of 3, which copies it to the host;
    so batch i+1's forward overlaps batch i's copy."""
    from dgcnn_tpu_torch.train.trainval import Trainval

    tv = Trainval(cfg, device=device)
    state = tv.with_params(params, mstate)
    del params, mstate
    stream = _stream(cfg, pool)
    sample = Reservoir(int(cell.traffic["checked_batches"]), seed)
    units, lat, failed, errs = [], [], [0], []
    work = queue.Queue(maxsize=3)

    def consume():
        while True:
            item = work.get()
            if item is None:
                return
            if errs:
                continue
            try:
                t_b, batch, packed = item
                with rec.span("portbench.copy"):
                    host = packed.cpu().numpy()
                lat.append(time.perf_counter() - t_b)
                valid = [int(v) for v in batch.mask.sum(axis=1)]
                units.append(valid)
                failed[0] += int(not np.isfinite(host).all())
                sample.offer(([int(i) for i in batch.event_ids], valid, host))
            except BaseException as e:  # raised again by the main thread
                errs.append(e)

    try:
        for _ in range(int(cell.traffic["warmup_batches"])):
            packed, _ = tv.inference_packed(state, next(stream))
            packed.cpu()
        _sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        worker = threading.Thread(target=consume, name="portbench-consume", daemon=True)
        worker.start()
        rec.start()
        setup_s = time.perf_counter() - t0
        with rec.span("portbench.window"):
            start = time.perf_counter()
            try:
                while time.perf_counter() - start < seconds and not errs:
                    with rec.span("portbench.batch_wait"):
                        batch = next(stream)
                    t_b = time.perf_counter()
                    with rec.span("portbench.batch"):
                        packed, _ = tv.inference_packed(state, batch)
                    work.put((t_b, batch, packed))
            finally:
                work.put(None)
                worker.join()
            # the window closes with the last answer on the host
            elapsed = time.perf_counter() - start
        rec.stop()
        if errs:
            raise errs[0]
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    finally:
        stream.close()
    del tv, state, packed
    _free(device)
    return Window(setup_s, [], elapsed, units, failed[0], lat, peak, sample.items)


def serve_reference(cell, pool, init, sample, device, side="reference"):
    """The reference's class log-probabilities of every sampled event, by
    id (``side="control"``: the control's)."""
    ref = cell.network.Reference(cell.config["model"], **cell.config[side])
    params, state = init
    ids = sorted({i for item in sample for i in item[0]})
    return {i: ref.log_probs(params, state, torch.as_tensor(pool[i].points, device=device))
            .cpu().numpy() for i in ids}
