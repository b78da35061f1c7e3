"""A cell's run on the card, as the benchmark's command starts it (``python -m pytest
portbench/tests -m cuda`` on a machine with an H100)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_serve_run_on_the_card_is_correct(card, trace):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "serve-f32-4k-b32",
                          "--seed", str(2**31 + 101 + trace), "--seconds", "2", "--trace",
                          str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check logit_gap_mean")
