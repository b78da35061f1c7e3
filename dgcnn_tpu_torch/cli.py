"""Command-line entry point (port of `dgcnn_tpu/cli.py`):

  python -m dgcnn_tpu_torch train     -io dgb -if events.dgb -i 100 ...
  python -m dgcnn_tpu_torch inference -io dgb -if events.dgb -mp weights/snap -of pred.npz
  python -m dgcnn_tpu_torch export    -mp weights/snap -np 4096 -of model.pt2
  python -m dgcnn_tpu_torch info

The flags are the JAX package's. Runs on ``cuda`` unless the caller of
`main` passes ``device="cpu"``. ``train`` and ``inference`` run data
parallel on ``-nd N`` ranks (``num_devices / point_shards``; 0 is every
visible card): spawned here, or, in processes a launcher started
(``torchrun``, one per host), as ranks of the launcher's group
(`train.loop`). ``export`` (`train.export`) and ``info`` run in one
process.
"""

from __future__ import annotations

import sys

from dgcnn_tpu_torch.config import parse_args


def main(argv=None, device=None):
    args = list(sys.argv[1:] if argv is None else argv)
    if args[:1] == ["info"]:
        # diagnostics never need the full flag surface
        from dgcnn_tpu_torch.config import print_info

        return print_info()
    cfg = parse_args(args)
    try:
        cfg.validate()
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"dgcnn_tpu_torch {cfg.command} configuration:\n{cfg.summary()}", flush=True)
    from dgcnn_tpu_torch.train.loop import inference, train

    if cfg.command == "train":
        train(cfg, device=device)
    elif cfg.command == "inference":
        inference(cfg, device=device)
    elif cfg.command == "export":
        from dgcnn_tpu_torch.train.export import run_export

        run_export(cfg, device=device)
    else:  # pragma: no cover - argparse enforces the choices
        raise SystemExit(f"unknown command {cfg.command!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
