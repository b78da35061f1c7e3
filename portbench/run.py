"""Run one cell of the benchmark of ``dgcnn_tpu_torch`` on the card(s) of
this machine and print its result as the last line of standard output:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiler trace of the window, with the device's
busy seconds and a breakdown. Both judge the window's outputs against the
plain reference (``correct``) and print each number compared beside its
limit, last on standard error and last in the result line.

A run needs the cards the cell asks for and fails without them; it never
falls back to the CPU. It fails too if JAX, a library of its family or
the JAX package was loaded, and without the program beside the benchmark.
The kernels build once into the checkout's ``build/`` (the program's
fixed ``build/kernels``); later runs there load them.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dgcnn_tpu")


def loaded_forbidden() -> list[str]:
    """Modules of ``sys.modules`` whose top-level name is forbidden,
    compared whole (``dgcnn_tpu_torch`` is not ``dgcnn_tpu``)."""
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def report(result: dict) -> None:
    """The result line (``checks`` last), then the checks on stderr."""
    checks = result.pop("checks")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    found = loaded_forbidden()
    if found:
        return fail(f"JAX or the JAX package is loaded at start: {found}", 4)
    args = parse(argv)
    from portbench import harness

    build = os.path.join(harness.ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    import torch

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        return fail(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)
    import dgcnn_tpu_torch  # noqa: F401  (fails here without the program)

    torch.set_num_threads(4)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = loaded_forbidden()
    if found:
        return fail(f"JAX or the JAX package was loaded during the run: {found}", 4)
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
