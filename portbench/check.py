"""The numbers that decide ``correct``, each held to its limit in the
cell's file (``portbench/cells/<cell>.json``, with the readings the limit
was set from).

Train cells, over the checked steps (the program's and the reference's
readings, `harness._train` and `harness.train_reference`). Compared:

- ``loss_gap_step1``: the relative gap of the first step's loss;
- ``grad1_gap``: the worst leaf's gap between the norms of the first
  step's gradient, ``|‖g‖ - ‖g_ref‖|``, over the larger of that leaf's
  reference norm and the median leaf's;
- ``change_gap_steady``: the worst leaf's gap, measured alike, of the
  parameters' change after the last checked step, over the leaf's
  steady elements: those whose first reference gradient is at least
  `ZERO_GRAD` of the median leaf's root mean square (with one event a
  step, BN cancels what is constant over the event's points, so the
  rows of the first head MLP weight that take the pooled vector, the
  pooled layer itself and the first block's projection bias get no
  gradient at all) and at least `STEADY` of its own leaf's. A leaf left
  unstepped or stepped twice reads about 1.

Adam's first step moves every element a full step by its gradient's
sign, whatever the gradient's size, so an element whose gradient is
near nought within its leaf moves either way by round-off, and what
follows from it swings from seed to seed. So these are only recorded
(`portbench.control` prints them): ``loss_gap``, the largest of any
checked step's loss gap; ``change_gap``, the worst leaf's change over
all elements above the first floor; ``change_gap_median`` and
``grad1_gap_median``, the median leaf's.

Serve cells, over the sampled batches' events (each event's valid rows
of the packed output against the reference's logits):

- ``logit_gap_mean``: the mean over every compared point of its relative
  logit gap (`serve_numbers`);
- ``event_gap_max``: the largest of an event's mean gap (an answer whose
  rows do not match its event's length, or hold a non-finite value,
  reads 1).
"""

from __future__ import annotations

import numpy as np
import torch

ZERO_GRAD = 1e-3  # an element's gradient under this share of the median leaf's RMS
STEADY = 0.3  # ... or under this share of its own leaf's RMS (``change_gap_steady``)


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """Each leaf's ``|prog - ref|`` over the larger of its reference norm
    and the median leaf's."""
    names = list(names)
    floor = float(np.median([ref[n] for n in names]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in names}


def norm(t) -> float:
    """The L2 norm of a tensor, in float64."""
    return float(torch.linalg.vector_norm(t.double()))


def _rms(t) -> float:
    return norm(t) / t.numel() ** 0.5


def change_gaps(prog: dict, ref: dict, steady: float = 0.0) -> dict:
    """Each leaf's change gap over its counted elements: those whose first
    reference gradient is at least `ZERO_GRAD` of the median leaf's RMS
    and ``steady`` of its own leaf's."""
    floor = ZERO_GRAD * float(np.median([_rms(g) for g in ref["grad1"].values()]))
    keep = {n: (g.abs() >= floor) & (g.abs() >= steady * _rms(g))
            for n, g in ref["grad1"].items()}
    counted = [n for n, m in keep.items() if bool(m.any())]
    return leaf_gaps({n: norm(prog["change"][n][keep[n]]) for n in counted},
                     {n: norm(ref["change"][n][keep[n]]) for n in counted}, counted)


def train_gaps(prog: dict, ref: dict) -> tuple[list, dict, dict]:
    """Each step's relative loss gap, and each leaf's first-gradient and
    change gaps. ``prog``: the program's losses, first-gradient norms and
    changes (tensors); ``ref``: the reference's losses, first gradients
    and changes (tensors)."""
    loss = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["loss"], ref["loss"])]
    g1 = {n: norm(g) for n, g in ref["grad1"].items()}
    return loss, leaf_gaps(prog["grad1"], g1, g1), change_gaps(prog, ref)


def train_numbers(prog: dict, ref: dict) -> dict:
    loss, grad1, change = train_gaps(prog, ref)
    return {"loss_gap_step1": loss[0], "loss_gap": max(loss), "grad1_gap": max(grad1.values()),
            "grad1_gap_median": float(np.median(list(grad1.values()))),
            "change_gap": max(change.values()),
            "change_gap_median": float(np.median(list(change.values()))),
            "change_gap_steady": max(change_gaps(prog, ref, STEADY).values())}


def _centered(logp: np.ndarray) -> np.ndarray:
    return logp - logp.mean(axis=-1, keepdims=True)


def serve_numbers(sample, ref: dict) -> dict:
    """``ref``: the reference's log-probabilities of each sampled event,
    by id, one column a class (the program's answer holds its classes in
    as many columns first). A point's gap is the largest gap of its centred
    log-probabilities (its logits up to a constant; the program's from
    its served probabilities), over the larger of 1 and the reference's
    largest: a saturated softmax hides a logit's error in the
    probabilities, not in their logarithms."""
    gaps, per_event = [], []
    for ids, valid, host in sample:
        for row, (i, n) in enumerate(zip(ids, valid)):
            r = _centered(ref[i].astype(np.float64))
            if n != r.shape[0]:
                per_event.append(1.0)
                continue
            p = host[row, :n, :r.shape[1]].astype(np.float64)
            if not np.isfinite(p).all():
                per_event.append(1.0)
                continue
            p = _centered(np.log(np.maximum(p, 1e-45)))
            g = np.abs(p - r).max(axis=-1) / np.maximum(np.abs(r).max(axis=-1), 1.0)
            gaps.append(g)
            per_event.append(float(g.mean()))
    allg = np.concatenate(gaps) if gaps else np.ones(1)
    return {"logit_gap_mean": float(allg.mean()), "event_gap_max": max(per_event)}


def held(numbers: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}`` of the numbers the cell compares."""
    return {n: {"value": numbers[n], "limit": float(limits[n])} for n in limits}


def train(cell, prog: dict, ref: dict) -> dict:
    return held(train_numbers(prog, ref), cell.limits)


def serve(cell, sample, ref: dict) -> dict:
    return held(serve_numbers(sample, ref), cell.limits)
