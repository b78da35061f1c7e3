"""The readings a cell's limits are set from, taken on the card at the
cell's own size (the benchmark's runs never run this):

    python3 -m portbench.control --workload <cell> --seeds 1 2 ... --control-seeds 7 8 9

For every seed of ``--seeds`` the program's numbers, as a run reads them
(train: the checked steps of the set-up; serve: a window of
``--seconds`` and its sample); the largest of each is its lower reading.
For every seed of ``--control-seeds`` the control's numbers: the
reference computed in the configuration's ``control`` precisions (its
matmuls one precision below the ones it states) put in the program's
place; and, on a train cell, two faults planted in the reference put
in the program's place: half of each batch left out of the loss (the
mean taken over the rest), and a quarter of the leaves (every fourth)
left unstepped. A state left unchanged reads 1 on ``grad1_gap`` and
``change_gap`` by their definition. One JSON line a reading, then the
summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import check, events, harness


def _program(cell, seed, device, seconds):
    """The program's window (its checked steps or its sample), then the
    events and the weights again for the reference."""
    w = harness.program(cell, seed, seconds, False, device, time.perf_counter())
    return w.checked, events.event_pool(cell.traffic, seed), cell.network.make_weights(
        cell.config["model"], seed, device)


def _frozen(change: dict) -> dict:
    """The change of a step that leaves every fourth leaf unstepped."""
    return {n: torch.zeros_like(c) if i % 4 == 0 else c for i, (n, c) in enumerate(change.items())}


def _half(labels):
    """Half of the batch out of the mean: every other event, or with one
    event every other point."""
    w = torch.ones(labels.shape, device=labels.device)
    if labels.shape[0] > 1:
        w[1::2] = 0.0
    else:
        w[..., 1::2] = 0.0
    return w


def train_readings(cell, seed, device, control: bool):
    prog, pool, init = _program(cell, seed, device, 0.0)
    ref = harness.train_reference(cell, pool, init, prog, device)
    out = [("program", _train_detail(prog, ref))]
    if control:
        for side, ref_side, fn in (("control", "control", None),
                                   ("half_batch", "reference", _half)):
            alt = harness.train_reference(cell, pool, init, prog, device, ref_side, fn)
            out.append((side, _train_detail(
                {"loss": alt["loss"], "grad1": {n: check.norm(g) for n, g in alt["grad1"].items()},
                 "change": alt["change"]}, ref)))
            del alt
        out.append(("frozen", _train_detail(
            {"loss": ref["loss"], "grad1": {n: check.norm(g) for n, g in ref["grad1"].items()},
             "change": _frozen(ref["change"])}, ref)))
    return out


def _train_detail(prog, ref) -> dict:
    """The numbers, the median leaf's gaps, and what lies behind them:
    each step's loss gap and the three worst leaves of each number."""
    loss, grad1, change = check.train_gaps(prog, ref)
    worst = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:3]  # noqa: E731
    return {**check.train_numbers(prog, ref), "loss_by_step": loss,
            "grad1_worst": worst(grad1), "change_worst": worst(change),
            "steady_worst": worst(check.change_gaps(prog, ref, check.STEADY))}


def serve_readings(cell, seed, device, seconds, control: bool):
    sample, pool, init = _program(cell, seed, device, seconds)
    ref = harness.serve_reference(cell, pool, init, sample, device)
    out = [("program", check.serve_numbers(sample, ref))]
    if control:
        alt = harness.serve_reference(cell, pool, init, sample, device, "control")
        # the control's answers in the program's place, the same sample
        fake = []
        for ids, valid, host in sample:
            h = host.copy()
            for row, i in enumerate(ids):
                h[row, :valid[row], :alt[i].shape[1]] = np.exp(alt[i])
            fake.append((ids, valid, h))
        out.append(("control", check.serve_numbers(fake, ref)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda":
        from dgcnn_tpu_torch.kernels import _build

        _build.load_many(cell.config["kernels"])
    table: dict = {}
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        control = seed in args.control_seeds
        if cell.traffic["kind"] == "train":
            got = train_readings(cell, seed, device, control)
        else:
            got = serve_readings(cell, seed, device, args.seconds, control)
        for side, numbers in got:
            if side == "program" and seed not in args.seeds:
                continue
            print(json.dumps({"seed": seed, "side": side, **numbers}), flush=True)
            for name, v in numbers.items():
                if not isinstance(v, float):
                    continue
                table.setdefault(side, {}).setdefault(name, []).append(v)
    summary = {side: {name: {"max" if side == "program" else "min":
                             (max if side == "program" else min)(vs), "n": len(vs)}
                      for name, vs in numbers.items()} for side, numbers in table.items()}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
