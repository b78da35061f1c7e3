"""A run with the timed path broken underneath reads ``correct`` false,
and the control (the reference in the precision below the
configuration's, in the program's place) fails the cell's limits; a
sound run passes them. Each drives the rest of a run on the CPU at a
tiny size (the look for a card skipped) against the cells' real limits.
"""

from __future__ import annotations

import time

import pytest
import torch

from portbench import control, harness

TRAIN = ["train-f32-131k"]
SERVE = ["serve-f32-4k-b32"]


def _run(root, name, seed=2**31 + 17):
    cell = harness.load_cell(name, root)
    return harness.run(cell, seed, 0.5, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_a_sound_run_is_correct(tiny_root, name):
    out = _run(tiny_root, name)
    assert out["correct"], out["checks"]


def _unchanged(self, state, batch):
    loss, _, _ = self.loss_and_grads(state, batch)
    return state, {"loss": loss}


def _half_points(orig):
    def put(self, batch, with_pos=False):
        out = list(orig(self, batch, with_pos))
        out[2] = out[2].clone()
        out[2][..., 1::2] = 0.0  # half of the batch out of the mean
        return tuple(out)

    return put


def _altered(orig):
    def packed(self, state, batch):
        out, metrics = orig(self, state, batch)
        out = out.clone()
        out[0, :, :2] = out[0, :, :2].flip(-1)  # the first event's answer, its classes swapped
        return out, metrics

    return packed


def _half_events(orig):
    def packed(self, state, batch):
        out, metrics = orig(self, state, batch)
        out = out.clone()
        out[out.shape[0] // 2:] = 0.0  # half of the batch's events left out
        return out, metrics

    return packed


def _partial(orig):
    def update(self, leaves, grads, state, lr):
        kept = {i: t.clone() for i, t in enumerate(leaves) if i % 4 == 0}
        orig(self, leaves, grads, state, lr)
        for i, t in kept.items():
            leaves[i].copy_(t)  # every fourth leaf left unstepped

    return update


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "partial_update"])
def test_a_broken_train_step_is_not_correct(tiny_root, monkeypatch, name, fault):
    from dgcnn_tpu_torch.train import trainval
    from dgcnn_tpu_torch.train.trainval import Trainval

    if fault == "unchanged":
        monkeypatch.setattr(Trainval, "train_step", _unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(Trainval, "_put_batch", _half_points(Trainval._put_batch))
    else:
        monkeypatch.setattr(trainval._Optimizer, "update", _partial(trainval._Optimizer.update))
    out = _run(tiny_root, name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", SERVE)
@pytest.mark.parametrize("fault", [_altered, _half_events])
def test_a_broken_answer_is_not_correct(tiny_root, monkeypatch, name, fault):
    from dgcnn_tpu_torch.train.trainval import Trainval

    monkeypatch.setattr(Trainval, "inference_packed", fault(Trainval.inference_packed))
    out = _run(tiny_root, name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_the_control_fails_the_limits(tiny_root, name):
    cell = harness.load_cell(name, tiny_root)
    device = torch.device("cpu")
    if cell.traffic["kind"] == "train":
        got = dict(control.train_readings(cell, 23, device, True))
    else:
        got = dict(control.serve_readings(cell, 23, device, 0.5, True))
    assert all(v <= cell.limits[n] for n, v in got["program"].items() if n in cell.limits)
    assert any(v > cell.limits[n] for n, v in got["control"].items() if n in cell.limits)
