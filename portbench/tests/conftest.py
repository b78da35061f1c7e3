"""Shared fixtures of the benchmark's own tests (run from the checkout's
root: ``python -m pytest portbench/tests -q``). They run on the CPU at
tiny sizes; the one marked ``cuda`` runs a cell on the card."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_MODEL = {"edge_filters": [16, 16], "head_feat_dim": 32, "head_mlp": [16], "k": 8}


def make_tiny_root(dest: str) -> str:
    """A copy of the benchmark (its ``BENCHMARK.json`` and ``portbench/``)
    whose configurations and traffic are cut to a size the CPU runs in
    seconds; the cells' limits are the real ones."""
    root = os.path.join(dest, "root")
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for sub, shrink in (("configs", _tiny_config), ("traffic", _tiny_traffic)):
        folder = os.path.join(root, "portbench", sub)
        for f in os.listdir(folder):
            path = os.path.join(folder, f)
            with open(path) as fh:
                d = json.load(fh)
            shrink(d)
            with open(path, "w") as fh:
                json.dump(d, fh)
    return root


def _tiny_config(d):
    d["model"].update(TINY_MODEL)


def _tiny_traffic(d):
    if d["kind"] == "train":
        d["num_point"] = 256
    else:
        # a pool of two batches, so every batch is full of events, as the
        # cell's own pool fills its batches
        d.update(num_point=256, buckets=[256], pool=2 * d["batch"], checked_batches=4)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("portbench")))
