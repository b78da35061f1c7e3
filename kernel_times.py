#!/usr/bin/env python3
"""Per-kernel times of the port's hand-written kernels on one NVIDIA card:
the rows of `PERF.md` §6's kernel table.

    python3 kernel_times.py [ROW ...]      # ROW in 1 1D 2 2D 3 3D E1; all by default

Rows 1-3D are the graph builds, timed on the inputs one forward of the
flagship (residual-dgcnn, 6 blocks of 64, k=20, head 1024 -> 512 -> 256,
seeded weights, fixed-length `SyntheticIO` events) gives its kernel: 1
and 1D a served 4 x 4096 batch (the exact kernel; 1D with
``--precision bfloat16 --knn_precision default``, its Hopper TC form), 2
and 2D a 1 x 1,048,576 event at ``knn_window`` 8192 (the banded kernel),
3 and 3D a 1 x 131,072 event split over 4 virtual owners of 32,768 points,
rank 0's ring order (the ring step; times a launch, the rank's work over
P). E1 is the fused depth-2 EdgeConv block's four passes at the
segmentation cell's shape (32 x 4096, k=20, C=64; the first conv from 4
and from 64 channels, the mask weights of the train step, and a ragged
batch).

For each input (C=4 once, C=64 five times) and their means it prints, in
ms from CUDA events: ``ms``, the wrapper from ``(x, mask)`` (operand
build + kernel); ``alone``, the kernel on prebuilt operands; ``sweep``,
the shared sweep's form alone on the same operands, timed in turns with
the Hopper form (rows 1, 1D, 2D, 3D); ``plain``, the kernel's plain
version; ``library``, the yardstick the port never calls (the operands,
a matmul and ``torch.topk``: bf16 for TC rows; the banded one a strip
loop with a band mask; the ring's a sort merge a block); ``bound``, the
least time of the function on that input: (2C + 2) operations a (query,
valid key) pair plus the keys' norms, at 67 TFLOP/s fp32 or, TC rows,
989 TFLOP/s bf16, or its bytes at 3.35 TB/s, whichever is longer (H100
SXM data sheet), and for TC rows ``compare``, one fp32 compare a pair at
half the fp32 peak. E1 prints each pass alone, its plain version and its
bound (2 E C^2 operations a product, or the stats passes' bytes). The
last line is the JSON of every row.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

FP32_PEAK, BF16_PEAK, HBM = 67e12, 989e12, 3.35e12
K, WIDTH, BLOCKS = 20, 64, 6
LONG_N, LONG_W = 1_048_576, 8192
RING_N, RING_P = 131_072, 4
ROWS = ("1", "1D", "2", "2D", "3", "3D", "E1")


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(run, reps: int, warmup: int, per: int = 1) -> dict:
    """``alone`` and ``sweep``: ``run(form)`` for the Hopper form and the
    shared sweep, in turns (Hopper, sweep, sweep, Hopper), each over
    ``per``."""
    ms = {"hopper": [], "sweep": []}
    for form in ("hopper", "sweep", "sweep", "hopper"):
        ms[form].append(cuda_ms(run(form), reps, warmup) / per)
    return {"alone": sum(ms["hopper"]) / 2, "sweep": sum(ms["sweep"]) / 2}


def bound(ops: float, nbytes: float, tc: bool) -> float:
    return max(ops / (BF16_PEAK if tc else FP32_PEAK), nbytes / HBM) * 1e3


def captured_inputs(n: int, b: int, tc: bool, window: int = 0):
    """The graph-build inputs ``(x, mask)`` of one eval forward of the
    flagship on ``b`` fixed-length events of ``n`` points, float32."""
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO
    from dgcnn_tpu_torch.train.trainval import Trainval

    flags = dict(precision="bfloat16", knn_precision="default") if tc else {}
    cfg = Config(model_name="residual-dgcnn", num_class=2, kvalue=K,
                 edge_filters=(WIDTH,) * BLOCKS, minibatch_size=b, num_point=n,
                 knn_window=window, **flags)
    tv = Trainval(cfg)
    state = tv.initialize(4, generator=torch.Generator().manual_seed(0))
    io = SyntheticIO(num_events=b, num_point=n, seed=0, variable_length=False).initialize()
    batch = next(BucketBatcher(io, b, num_point=n, shuffle=False).epoch())
    build, captured = tv.model.knn_fn, []

    def recording(x, k, m):
        captured.append((x.float().contiguous(), m.clone()))
        return build(x, k, m)

    tv.model.knn_fn = recording
    with torch.inference_mode():
        tv.model(state.params, state.model_state, torch.tensor(batch.points, device="cuda"),
                 torch.tensor(batch.mask, device="cuda"))
    del tv, state
    torch.cuda.empty_cache()
    return captured


# ------------------------------------------------------------ exact, 1 and 1D

def exact_times(x, mask, tc: bool) -> dict:
    from dgcnn_tpu_torch.kernels import knn_cuda as kmod

    precision = "default" if tc else "highest"
    qa, ka = kmod.build_augmented_operands(x, x, mask, precision, **({} if tc else
                                                                       {"cpad": kmod.CPAD}))
    if tc:
        qa, ka = kmod.tc_operand(qa), kmod.tc_operand(ka)

    def library():
        q, k_ = kmod.build_augmented_operands(x, x, mask, precision)
        if tc:
            q, k_ = q.to(torch.bfloat16), k_.to(torch.bfloat16)
        return torch.topk(torch.matmul(q, k_.transpose(-1, -2)), K, dim=-1)

    t = {"ms": cuda_ms(lambda: kmod.knn_cuda(x, K, mask, precision=precision)),
         "plain": cuda_ms(lambda: kmod.knn_plain(x, x, K, mask, precision), reps=5),
         "library": cuda_ms(library, reps=5)}
    hopper = kmod.tc_kernel_for(qa.shape[-1], K) == "tc" if tc else \
        kmod.f32_kernel_for(qa.shape[-1], K) == "hopper"
    if hopper:
        names = {"hopper": "tc" if tc else "hopper", "sweep": "sweep"}
        t.update(in_turns(lambda form: lambda: kmod.launch_operands(
            qa, ka, K, precision, kernel=names[form]), reps=20, warmup=3))
    else:
        t["alone"] = cuda_ms(lambda: kmod.launch_operands(qa, ka, K, precision))
    b, n, c = x.shape
    valid = int(mask.sum())
    pairs = n * valid
    t["bound"] = bound(pairs * (2 * c + 2) + valid * 2 * c + b * n * c,
                       4 * x.numel() + mask.numel() + b * n * K * 5, tc)
    if tc:
        t["compare"] = pairs / (FP32_PEAK / 2) * 1e3
    return t


# ------------------------------------------------------------ banded, 2 and 2D

def banded_times(x, mask, tc: bool) -> dict:
    from dgcnn_tpu_torch.kernels import knn_banded_cuda as bmod
    from dgcnn_tpu_torch.kernels import knn_cuda as kmod
    from dgcnn_tpu_torch.ops.knn import band_lo

    precision = "default" if tc else "highest"
    pr = dict(window=LONG_W, precision=precision)
    qa, ka = kmod.build_augmented_operands(x, x, mask, precision)
    if tc:
        qa, ka = kmod.tc_operand(qa), kmod.tc_operand(ka)
    nvalid = mask.sum(-1).to(torch.int32)
    b, n, c = x.shape
    w = min(LONG_W, n)

    def library(strip: int = 2048):
        q, k_ = kmod.build_augmented_operands(x, x, mask, precision)
        if tc:
            q, k_ = q.to(torch.bfloat16), k_.to(torch.bfloat16)
        span = min(strip + w, n)
        offs = torch.arange(span, device=x.device)
        for r0 in range(0, n, strip):
            rows = torch.arange(r0, min(r0 + strip, n), device=x.device)
            lo = band_lo(rows[None, :], nvalid[:, None].long(), w)
            cols = torch.clamp(lo[:, 0], 0, n - span)[:, None] + offs
            keys = torch.gather(k_, 1, cols[..., None].expand(-1, -1, k_.shape[-1]))
            s = torch.matmul(q[:, r0:r0 + strip], keys.transpose(-1, -2))
            g = cols[:, None, :]
            s = torch.where((g >= lo[..., None]) & (g < (lo + w)[..., None]), s, float("-inf"))
            torch.topk(s, K, dim=-1)

    t = {"ms": cuda_ms(lambda: bmod.knn_banded_cuda(x, K, mask, **pr), reps=3, warmup=1),
         "plain": cuda_ms(lambda: bmod.knn_banded_plain(x, x, K, mask, **pr), reps=1, warmup=0),
         "library": cuda_ms(library, reps=1, warmup=1)}
    if tc:
        t.update(in_turns(lambda form: lambda: bmod.launch_operands(
            qa, ka, nvalid, K, kernel="tc" if form == "hopper" else "sweep", **pr),
            reps=3, warmup=1))
    else:
        t["alone"] = cuda_ms(lambda: bmod.launch_operands(qa, ka, nvalid, K, **pr), reps=3,
                             warmup=1)
    # (2C + 2) operations a (valid query, in-band valid key) pair, counted
    # from the band and the mask, plus the keys' norms and the query scaling
    m = mask.to(torch.int64)
    cs = torch.nn.functional.pad(m.cumsum(-1), (1, 0))
    lo = band_lo(torch.arange(n, device=x.device)[None, :], m.sum(-1)[:, None], w).expand(b, n)
    pairs = int(((cs.gather(1, torch.clamp(lo + w, max=n)) - cs.gather(1, lo)) * m).sum())
    t["bound"] = bound(pairs * (2 * c + 2) + int(m.sum()) * 2 * c + b * n * c,
                       4 * 2 * b * n * c + b * n + b * n * K * 5, tc)
    if tc:
        t["compare"] = pairs / (FP32_PEAK / 2) * 1e3
    return t


# ------------------------------------------------------------ ring, 3 and 3D

def ring_times(x, mask, tc: bool, p: int = RING_P) -> dict:
    """Rank 0's ring over ``p`` virtual owners, each time over ``p``: the
    wrapper's work (the shard's operands, the p merges, the finish; the
    other owners' blocks prebuilt, as the transport hands them over), the
    steps alone on prebuilt operands, the plain merge and the library."""
    import functools

    from dgcnn_tpu_torch.kernels import knn_cuda as kmod
    from dgcnn_tpu_torch.kernels import ring_knn_cuda as rmod

    precision = "default" if tc else "highest"
    b, n, c = x.shape
    nl = n // p
    qa, ka = kmod.build_augmented_operands(x, x, mask, precision)
    blocks = [(ka[:, o * nl:(o + 1) * nl].contiguous(), o * nl) for o in range(p)]
    q = qa[:, :nl].contiguous()
    xs, ms = x[:, :nl].contiguous(), mask[:, :nl].contiguous()
    cast = kmod.tc_operand if tc else (lambda a: a)
    q_k, blocks_k = cast(q), [(cast(kb), base) for kb, base in blocks]
    step = functools.partial(rmod.launch_step, precision=precision)

    def wrapper():
        qs, _ = kmod.build_augmented_operands(xs, xs, ms, precision)
        return rmod.merge_blocks(cast(qs), blocks, K, 0, step)

    def steps(kernel=None):
        topv, topi = rmod.init_running(b, nl, K, x.device)  # fresh lists each time
        for kb, base in blocks_k:
            rmod.launch_step(q_k, kb, base, topv, topi, precision=precision, kernel=kernel)

    def library():
        qs, _ = kmod.build_augmented_operands(xs, xs, ms, precision)
        qs = qs.to(torch.bfloat16) if tc else qs
        topv = torch.full((b, nl, K), float("-inf"), device=x.device, dtype=qs.dtype)
        topi = torch.zeros((b, nl, K), dtype=torch.long, device=x.device)
        for kb, base in blocks:
            v, i = torch.topk(torch.matmul(qs, kb.to(qs.dtype).transpose(-1, -2)), K, dim=-1)
            sv, order = torch.sort(torch.cat([topv, v], -1), dim=-1, descending=True)
            topv = sv[..., :K]
            topi = torch.gather(torch.cat([topi, i + base], -1), -1, order)[..., :K]

    t = {"ms": cuda_ms(wrapper, reps=3, warmup=1) / p,
         "plain": cuda_ms(lambda: rmod.merge_blocks(q, blocks, K, 0, rmod.step_plain), reps=1,
                          warmup=0) / p,
         "library": cuda_ms(library, reps=2, warmup=1) / p}
    if tc:
        t.update(in_turns(lambda form: lambda: steps("tc" if form == "hopper" else "sweep"),
                          reps=5, warmup=1, per=p))
    else:
        t["alone"] = cuda_ms(steps, reps=3, warmup=1) / p
    # (2C + 2) operations a (query, valid key of the block) pair; the
    # queries, the block and the running list read once, the list written
    t["bound"] = bound((2 * c + 2) * nl * int(mask.sum()) / p,
                       2 * 4 * b * nl * (c + 2) + 3 * 4 * b * nl * K * 2, tc)
    if tc:
        t["compare"] = nl * int(mask.sum()) / p / (FP32_PEAK / 2) * 1e3
    return t


# ------------------------------------------------------------ E1: fused_mlp

def edge_mlp_rows() -> dict:
    from dgcnn_tpu_torch.kernels import edge_mlp_cuda as emod
    from dgcnn_tpu_torch.kernels import knn_cuda as kmod
    from dgcnn_tpu_torch.ops import edge as edge_ops

    b, n, c = 32, 4096, WIDTH
    e = b * n * K
    rows_bytes = b * n * c * 4
    product = 2 * e * c * c / FP32_PEAK * 1e3
    bounds = {"stats": (2 * rows_bytes + e * 4) / HBM * 1e3, "forward": product,
              "backward": 3 * product, "stats_backward": (4 * rows_bytes + e * 4) / HBM * 1e3}
    plain = edge_ops._PLAIN
    out = {}
    for label, cin, counts in (("C_in=4", 4, [n] * b), ("C_in=64", 64, [n] * b),
                               ("C_in=64 ragged", 64, [n - 131 * i for i in range(b - 1)] + [0])):
        g = torch.Generator(device="cuda").manual_seed(cin)
        x = torch.randn(b, n, cin, generator=g, device="cuda")
        w1 = torch.randn(2 * cin, c, generator=g, device="cuda") / np.sqrt(2 * cin)
        p, q = (x @ (w1[:cin] - w1[cin:])).contiguous(), (x @ w1[cin:]).contiguous()
        mask = torch.arange(n, device="cuda")[None] < torch.tensor(counts, device="cuda")[:, None]
        idx, _ = kmod.knn_cuda(x, K, mask)
        w = mask.float()
        bn = [0.1 * torch.randn(c, generator=g, device="cuda"),
              torch.rand(c, generator=g, device="cuda") + 0.5,
              torch.rand(c, generator=g, device="cuda") + 0.5,
              0.2 * torch.randn(c, generator=g, device="cuda")]
        w2 = torch.randn(c, c, generator=g, device="cuda") / np.sqrt(c)
        gsign = torch.arange(c, device="cuda") % 4 != 0
        dm = torch.randn(b, n, c, generator=g, device="cuda")
        ds = torch.randn(4, c, generator=g, device="cuda") * 1e-3
        win = emod.forward(p, q, idx, w, *bn, w2, gsign)[1]
        runs = {
            "stats": lambda mod: mod.stats(p, q, idx, w),
            "forward": lambda mod: mod.forward(p, q, idx, w, *bn, w2, gsign),
            "backward": lambda mod: mod.backward(p, q, idx, w, *bn, w2, win, dm, ds[0], ds[1]),
            "stats_backward": lambda mod: mod.stats_backward(p, q, idx, w, ds[2], ds[3]),
        }
        out[label] = {name: {"alone": cuda_ms(lambda: run(emod), reps=10, warmup=2),
                             "plain": cuda_ms(lambda: run(plain), reps=2, warmup=1),
                             "bound": bounds[name]} for name, run in runs.items()}
        del p, q, idx, dm, win
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ the table

GRAPH_ROWS = {
    # row: (kernel times, forward: (points, events, TC, window), label)
    "1": (exact_times, (4096, 4, False, 0), "exact fp32, a served 4 x 4096 batch"),
    "1D": (exact_times, (4096, 4, True, 0), "exact TC, a served 4 x 4096 batch"),
    "2": (banded_times, (LONG_N, 1, False, LONG_W), "banded fp32, 1 x 1,048,576, W=8192"),
    "2D": (banded_times, (LONG_N, 1, True, LONG_W), "banded TC, 1 x 1,048,576, W=8192"),
    "3": (ring_times, (RING_N, 1, False, 0), "ring fp32, 1 x 131,072 over 4 owners, a launch"),
    "3D": (ring_times, (RING_N, 1, True, 0), "ring TC, 1 x 131,072 over 4 owners, a launch"),
}


def fmt(t: dict) -> str:
    return " ".join(f"{k}={v:.4f}" for k, v in t.items())


def graph_row(row: str, smi: str) -> dict:
    times, (n, b, tc, window), label = GRAPH_ROWS[row]
    inputs = captured_inputs(n, b, tc, window)
    per = []
    for i, (x, m) in enumerate(inputs):
        t = times(x, m, tc)
        per.append((x.shape[-1], t))
        print(f"row {row} ({label}) build {i} C={x.shape[-1]} [{smi}]: {fmt(t)}", flush=True)
    out = {"launches_a_forward": len(per)}
    for c in sorted({c for c, _ in per}):
        ts = [t for cc, t in per if cc == c]
        out[f"C={c}"] = {k: sum(t[k] for t in ts) / len(ts) for k in ts[0]}
    out["mean"] = {k: sum(t[k] for _, t in per) / len(per) for k in per[0][1]}
    for key, t in out.items():
        if key != "launches_a_forward":
            print(f"row {row} ({label}) {key} of {len(per)} builds [{smi}]: {fmt(t)}",
                  flush=True)
    return out


def main(argv) -> int:
    rows = argv or list(ROWS)
    unknown = [r for r in rows if r not in ROWS]
    if unknown:
        print(f"kernel_times: unknown rows {unknown}; rows are {' '.join(ROWS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    from dgcnn_tpu_torch.train.trainval import disable_tf32

    disable_tf32()
    smi = card()
    print(f"{smi}; torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    table = {}
    for row in rows:
        if row == "E1":
            table[row] = edge_mlp_rows()
            for label, passes in table[row].items():
                print(f"row E1 (fused_mlp, 32 x 4096, k=20, C=64) {label} [{smi}]: " + "; ".join(
                    f"{name} {fmt(t)}" for name, t in passes.items()), flush=True)
        else:
            table[row] = graph_row(row, smi)
    print(json.dumps({"card": smi, "rows": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
