"""Exact fused kNN: the hand-written CUDA kernel and its plain version
(port of `dgcnn_tpu/kernels/knn_pallas.py`).

Both score every (query, key) pair as one contraction of augmented
operands, ``[2x_i, -1, -1] . [x_j, |x_j|^2, 1e30 (1 - m_j)]`` =
``|x_i|^2 - D_ij`` (minus 1e30 for a masked key), and keep the ``k``
largest per query, ties by score descending then key index ascending. A
slot whose score is <= -1e29 (a masked key, when fewer than ``k`` keys are
valid) becomes the self-edge ``min(i, Nk - 1)`` with ``valid`` False.

- `knn_cuda` / `knn_cuda_cross`: on a CUDA tensor they launch
  ``csrc/knn.cu`` (built at first use by `kernels._build`) on the current
  stream, or raise. On a CPU tensor they run `knn_plain`. The self form
  goes through the registered operator ``dgcnn_tpu_torch::knn``
  (`kernels.ops`), whose CUDA implementation is `_launch`.
- Routing of the fp32 score (``precision="highest"``), by shape alone
  (`f32_kernel_for`): a build of ``k <= KMAX`` at padded widths up to
  ``F32_MAX_C2`` runs on the Hopper pipeline (``csrc/knn_hopper.cuh``,
  ``knn_topk_kernel_hopper``: TMA key tiles through a ring of stages that
  the warp releasing a stage last refills, no block-wide barrier, the
  filter in registers), on operands padded with zeros to a multiple of
  ``CPAD`` = 4 channels (TMA's 16-byte rows); every other build (k >
  KMAX in passes behind ceilings, wider channels in chunks) on the
  shared sweep (``knn_sweep.cuh``'s ``sweep_fp32``). Both give the same
  bits. ``launch_operands(..., kernel="sweep" | "hopper")`` forces a form,
  for the card's comparisons; a CUDA launch the Hopper kernel refuses
  raises, with no fallback.
- `knn_plain`: the same operands through an fp32 ``torch.matmul`` and
  `ops.knn.top_k_stable` (a stable descending sort), which gives the tie
  rule explicitly
  (``torch.topk`` does not promise lowest index first among equal values
  on CUDA).
- The kernel may split each query block's keys into S ranges, swept by S
  blocks into partial lists that a second kernel merges (`split_count`
  picks S from the card); `merge_lists_plain` is the plain version of that
  merge.
- A launch keeps at most ``KMAX`` = 64 entries a row. A larger ``k`` runs
  in passes: pass ``p`` keeps the next ``min(64, k - 64 p)`` entries
  among the keys behind each row's ceiling, the last entry of pass
  ``p - 1``; the passes' lists are concatenated and finished once.
  `knn_passes_plain` is the plain version of that decomposition. Wide C
  needs nothing here: the kernel sweeps channels in chunks.

``precision`` is ``--knn_precision``: ``"highest"`` scores in fp32 (the
CUDA cores' fmaf chain, no TF32); ``"default"`` is the Pallas kernel's
``Precision.DEFAULT``, one bf16 pass on the TPU's MXU: the operands
rounded to bf16 (round to nearest even) in `build_augmented_operands`,
their products exact in fp32 and summed in fp32. On a CUDA tensor it
launches a tensor-core kernel on the bf16 form of those operands
(`tc_operand`): `tc_kernel_for` picks the Hopper kernel
(``csrc/knn_tc.cuh``: TMA-staged key tiles, a warp-specialised pipeline,
``wgmma``, the filter in registers) for every one-pass width up to
``TC_MAX_C2`` with ``k <= KMAX``, and the sweep's TC instantiation
(``sweep_tc``, bf16 ``mma.sync``) for wider operands and the passes of a
larger ``k``. The two give the same score bits, so the same graph. The
plain versions take the same rounded operands through an fp32
``torch.matmul``. The tensor cores sum in another order than the matmul,
so the two agree up to near ties of the rounded score
(`ops.knn.split_score_mismatches`).

``launches`` counts graph builds that launched an fp32 kernel (either
form), ``launches_f32_hopper`` those of them on the Hopper fp32 kernel
(so ``launches - launches_f32_hopper`` are the sweep's),
``launches_tc`` those that launched the Hopper TC kernel and
``launches_tc_sweep`` those of the sweep's TC instantiation (one each,
the merge and the passes included); the plain path does not count.
"""

from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.ops.knn import BLOCK_Q, tie_sort, top_k_stable

MASK_BIG = 1e30  # masked-key score offset; a score <= -1e29 is invalid
INVALID_BELOW = -1e29
KMAX = 64  # entries a pass of the kernel (csrc/knn_sweep.cuh)
MAX_SPLITS = 8  # the most key ranges a query block is split into (csrc/knn.cu)
QB, TB = 128, 64  # queries a block, keys a tile (csrc/knn_sweep.cuh)
# the Hopper fp32 kernel (csrc/knn_hopper.cuh): its operands' channels are
# padded to a multiple of CPAD, and F32_MAX_C2 is the widest padded width
# whose query rows and three key stages (of TB keys) fit its shared memory
CPAD, F32_MAX_C2 = 4, 168

PRECISIONS = ("highest", "default")
CPAD_TC = 16  # the TC kernels' channels are padded to a multiple of this
# the Hopper TC kernel (csrc/knn_tc.cuh): keys a tile, and the widest padded
# width whose query rows, two key stages and staging areas fit its shared
# memory (the widest one-pass width of sweep_tc too)
TB_TC, TC_MAX_C2 = 64, 368

launches = 0
launches_f32_hopper = 0
launches_tc = 0
launches_tc_sweep = 0
# S forced on every launch, for timing and testing the split; None: the
# card's choice (`choose_splits`)
_splits_override = None
_slots_cache: dict = {}


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"knn precision must be one of {PRECISIONS}, got {precision!r}")
    return precision


_constants: dict = {}


def _constant(device, values: tuple, lead) -> torch.Tensor:
    """``values`` as the last axis of an f32 tensor of leading shape
    ``lead`` on ``device``: one cached tensor on the device, expanded (no
    launch after the first)."""
    key = (device, values)
    if key not in _constants:
        _constants[key] = torch.tensor(values, dtype=torch.float32, device=device)
    return _constants[key].expand(*lead, len(values))


def build_augmented_operands(xq: torch.Tensor, xk: torch.Tensor, mask_k=None,
                             precision: str = "highest", cpad: int = 1):
    """The score-defining operands, in one place for the kernels and the
    plain versions. ``xq`` ``(B, Nq, C)``, ``xk`` ``(B, Nk, C)``, ``mask_k``
    ``(B, Nk)`` bool or None. Returns contiguous f32 ``qa`` ``(B, Nq, C+2)``
    and ``ka`` ``(B, Nk, C+2)``, with zero channels after them up to a
    multiple of ``cpad`` (in the same copy; zeros change no score); with
    ``precision="default"`` both rounded to bf16 (nearest even) and held in
    f32, the TPU's single-pass operands (a masked key's channel stays below
    -1e29: bf16(1e30) is within 0.4% of 1e30)."""
    xq = xq.detach().float()
    xk = xk.detach().float()
    # the norms of rows padded with zeros to a multiple of 4 channels: every
    # row then starts 16-byte aligned, so the reduction takes one path on
    # every row and identical points get identical norms, bit for bit (at
    # C = 179 unpadded rows fall into four alignments, and the norms of
    # equal rows differed in the last bit on the card)
    xs = xk if xk.shape[-1] % 4 == 0 else torch.nn.functional.pad(xk, (0, -xk.shape[-1] % 4))
    k2 = torch.sum(torch.square(xs), dim=-1, keepdim=True)
    # the query's constant channels [-1, -1] and the zeros up to a multiple
    # of cpad, and the key's masked-key channel, each in one launch at most
    extra = -(xq.shape[-1] + 2) % cpad
    qa = [2.0 * xq, _constant(xq.device, (-1.0, -1.0) + (0.0,) * extra, xq.shape[:-1])]
    if mask_k is None:
        ka = [xk, k2, _constant(xk.device, (0.0,) * (1 + extra), xk.shape[:-1])]
    else:
        ka = [xk, k2, torch.where(mask_k[..., None], 0.0, MASK_BIG)]
        if extra:
            ka.append(_constant(xk.device, (0.0,) * extra, xk.shape[:-1]))
    qa = torch.cat(qa, dim=-1).contiguous()
    ka = torch.cat(ka, dim=-1).contiguous()
    if check_precision(precision) == "default":
        qa = qa.to(torch.bfloat16).float()
        ka = ka.to(torch.bfloat16).float()
    return qa, ka


def f32_kernel_for(c2: int, k: int, ceiling: bool = False) -> str:
    """The kernel of an fp32 graph build of ``k`` entries on operands of
    ``c2`` channels (``C + 2``, padded or not), by shape alone:
    ``"hopper"``, the Hopper pipeline, for one pass (``k <= KMAX``, no
    ceiling) at a padded width up to ``F32_MAX_C2``; else ``"sweep"``,
    the shared sweep (channels in chunks, passes behind ceilings)."""
    c2p = -(-c2 // CPAD) * CPAD
    return "hopper" if c2p <= F32_MAX_C2 and k <= KMAX and not ceiling else "sweep"


def resolve_f32_kernel(c2: int, k: int, kernel: str | None = None) -> str:
    """The fp32 kernel a build of ``k`` entries on ``c2`` channels takes:
    ``kernel`` where given (``"hopper"`` or ``"sweep"``; raises if the
    Hopper kernel does not take the shape), else `f32_kernel_for`'s
    choice."""
    route = f32_kernel_for(c2, k)
    kernel = kernel or route
    if kernel == "tc":
        raise ValueError("kernel 'tc' takes precision='default'")
    if kernel not in ("hopper", "sweep") or (kernel == "hopper" and route != "hopper"):
        raise ValueError(f"no fp32 kernel {kernel!r} for c2={c2}, k={k}")
    return kernel


def f32_operand(a: torch.Tensor) -> torch.Tensor:
    """An operand of the Hopper fp32 kernel: f32, channels padded with
    zeros to a multiple of ``CPAD``, contiguous (`build_augmented_operands`
    with ``cpad=CPAD`` builds it so in one copy)."""
    if a.shape[-1] % CPAD == 0 and a.is_contiguous():
        return a
    return torch.nn.functional.pad(a, (0, -a.shape[-1] % CPAD)).contiguous()


def tc_kernel_for(c2: int, k: int, ceiling: bool = False) -> str:
    """The kernel of a TC graph build of ``k`` entries on operands of
    padded width ``c2`` (a multiple of ``CPAD_TC``), by shape alone:
    ``"tc"``, the Hopper kernel, for one pass (``k <= KMAX``, no ceiling)
    at ``c2 <= TC_MAX_C2``; else ``"sweep"``, the sweep's TC
    instantiation (channels in chunks, passes behind ceilings)."""
    return "tc" if c2 <= TC_MAX_C2 and k <= KMAX and not ceiling else "sweep"


def resolve_tc_kernel(c2: int, k: int, ceiling: bool = False, kernel: str | None = None) -> str:
    """The TC kernel a launch of ``k`` entries on operands of padded width
    ``c2`` takes: ``kernel`` where given (``"tc"`` or ``"sweep"``; raises
    if the Hopper kernel does not take the shape), else `tc_kernel_for`'s
    choice."""
    route = tc_kernel_for(c2, k, ceiling)
    kernel = kernel or route
    if kernel not in ("tc", "sweep") or (kernel == "tc" and route != "tc"):
        raise ValueError(f"no TC kernel {kernel!r} for c2={c2}, k={k}, ceiling={ceiling}")
    return kernel


def check_aligned(*tensors) -> None:
    """The Hopper kernels load their operands by TMA, which takes only
    16-byte aligned addresses: raise for any other."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"a Hopper TC kernel's operand must be 16-byte aligned, got address "
                             f"{t.data_ptr():#x}")


def tc_operand(a: torch.Tensor) -> torch.Tensor:
    """An operand of the tensor-core kernels: bf16, channels padded with
    zeros to a multiple of ``CPAD_TC``, contiguous. ``a`` is a
    `build_augmented_operands` output of ``precision="default"`` (f32 values
    that are bf16 already, so the cast is exact) or already such an
    operand."""
    if a.dtype == torch.bfloat16 and a.shape[-1] % CPAD_TC == 0 and a.is_contiguous():
        return a
    a = torch.nn.functional.pad(a, (0, -a.shape[-1] % CPAD_TC))
    return a.to(torch.bfloat16).contiguous()


def _finish(idx, vals, nq: int, nk: int):
    valid = vals > INVALID_BELOW
    self_idx = torch.clamp(
        torch.arange(nq, dtype=torch.int32, device=idx.device), max=nk - 1
    )[None, :, None]
    return torch.where(valid, idx.to(torch.int32), self_idx), valid, vals


def knn_plain(xq, xk, k: int, mask_k=None, precision: str = "highest"):
    """Plain PyTorch version of the kernel: ``(idx, valid, scores)``, each
    ``(B, Nq, k)``. Scores are ``|x_i|^2 - D_ij`` (per-query offset), not
    distances; with ``precision="default"`` those of the bf16-rounded
    operands, summed by an fp32 matmul."""
    nq, nk = xq.shape[1], xk.shape[1]
    if not 1 <= k <= nk:
        raise ValueError(f"k={k} must be in [1, Nk={nk}]")
    qa, ka = build_augmented_operands(xq, xk, mask_k, precision)
    kat = ka.transpose(-1, -2)
    vals, idx = [], []
    for lo in range(0, nq, BLOCK_Q):  # bounds the (B, rows, Nk) buffers
        v, i = top_k_stable(torch.matmul(qa[:, lo : lo + BLOCK_Q], kat), k)
        vals.append(v)
        idx.append(i)
    return _finish(torch.cat(idx, dim=1), torch.cat(vals, dim=1), nq, nk)


def behind(v, i, ceil_v, ceil_i):
    """Where the entries ``(v, i)`` come after the ceilings ``(ceil_v,
    ceil_i)`` in the (score desc, index asc) order: the keys a pass may
    take."""
    return (ceil_v > v) | ((ceil_v == v) & (ceil_i < i))


def knn_passes_plain(xq, xk, k: int, mask_k=None, pass_k: int = KMAX,
                     precision: str = "highest"):
    """Plain PyTorch version of the kernel's passes: for each query a
    stable top-``pass_k`` of the keys, then of the keys behind that pass's
    last entry, and so on to ``k``, concatenated and finished once.
    ``(idx, valid, scores)``, each ``(B, Nq, k)``, equal to `knn_plain`'s
    because (score desc, index asc) is a strict total order. The CPU tests
    use it; no path calls it."""
    nq, nk = xq.shape[1], xk.shape[1]
    if not 1 <= k <= nk:
        raise ValueError(f"k={k} must be in [1, Nk={nk}]")
    qa, ka = build_augmented_operands(xq, xk, mask_k, precision)
    kat = ka.transpose(-1, -2)
    cols = torch.arange(nk, device=qa.device)
    vals, idx = [], []
    for lo in range(0, nq, BLOCK_Q):
        s = torch.matmul(qa[:, lo : lo + BLOCK_Q], kat)
        pv, pi = [], []
        for p0 in range(0, k, pass_k):
            cand = s if not pv else torch.where(
                behind(s, cols, pv[-1][..., -1:], pi[-1][..., -1:]), s, float("-inf"))
            v, i = top_k_stable(cand, min(pass_k, k - p0))
            pv.append(v)
            pi.append(i)
        vals.append(torch.cat(pv, dim=-1))
        idx.append(torch.cat(pi, dim=-1))
    return _finish(torch.cat(idx, dim=1), torch.cat(vals, dim=1), nq, nk)


def merge_lists_plain(vals, idx, k: int, nk: int):
    """Plain version of the kernel's merge: the top ``k`` of S partial
    lists of the same queries over disjoint key ranges, by (score desc,
    index asc), finished as the kernel finishes them. ``vals`` and ``idx``
    are S tensors ``(B, Nq, k_s)`` each (or stacked, ``(S, B, Nq, k)``),
    indices global among the ``nk`` keys. Returns ``(idx, valid,
    scores)``."""
    v, i = tie_sort(torch.cat(list(vals), dim=-1), torch.cat(list(idx), dim=-1).long())
    return _finish(i[..., :k], v[..., :k], v.shape[1], nk)


def split_count(blocks: int, tiles: int, slots: int) -> int:
    """The key split S for a grid of ``blocks`` query blocks over
    ``tiles`` key tiles on a card that holds ``slots`` blocks at once: the
    S in ``1 .. min(MAX_SPLITS, tiles)`` whose grid takes the fewest waves
    for a split's share of the keys, ``ceil(blocks S / slots) / S``, the
    smallest S on a tie."""
    best, best_cost = 1, 1.0 * -(-blocks // slots)
    for s in range(2, min(MAX_SPLITS, tiles) + 1):
        cost = -(-blocks * s // slots) / s
        if cost < best_cost:
            best, best_cost = s, cost
    return best


# the fp32 sweep, the Hopper fp32 kernel, the sweep's TC instantiation, the
# Hopper TC kernel
KERNELS = ("fp32", "f32_hopper", "sweep", "tc")


def split_count_idle(blocks: int, tiles: int, sms: int) -> int:
    """The key split S of the Hopper TC kernel on a card of ``sms`` SMs
    that hold a block of it: the most splits whose grid stays within two
    blocks an SM, ``2 sms // blocks`` (1 for a grid of a wave or more), at
    most ``MAX_SPLITS`` and the tiles. Each split fills its lists from
    empty, and the selection is most of that kernel's time, so a split pays
    only where the grid would leave the card short of work (on an H100, S=2
    took 1.32x S=1's time at 1 x 131,072 and 0.90x at 4 x 4096; PERF.md)."""
    return max(1, min(MAX_SPLITS, tiles, 2 * sms // blocks))


def choose_splits(b: int, nq: int, nk: int, c2: int, k: int, device, ceiling: bool = False,
                  kernel: str = "fp32") -> int:
    """The S a launch of a pass of ``min(k, KMAX)`` entries (behind a
    ceiling or not) of ``kernel`` (one of `KERNELS`; ``c2`` the width it
    is given, padded for the TC kernels) on ``device`` takes: `split_count`
    from the card's resident blocks of that kernel (``dgcnn_knn_slots``,
    ``dgcnn_knn_slots_bf16``, ``dgcnn_knn_slots_f32h``) over its key tiles
    of ``TB`` keys (the sweeps and the Hopper fp32 kernel), or
    `split_count_idle` from the SMs that hold a block of it
    (``dgcnn_knn_slots_tc``) over tiles of ``TB_TC`` keys (the Hopper
    kernel), unless ``_splits_override`` forces it."""
    if _splits_override is not None:
        return _splits_override
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    k = min(k, KMAX)
    key = (torch.device(device).index, c2, k, ceiling, kernel)
    if key not in _slots_cache:
        with torch.cuda.device(device):
            lib = _lib()
            if kernel == "tc":
                slots = lib.dgcnn_knn_slots_tc(c2, k)
            elif kernel == "f32_hopper":
                slots = lib.dgcnn_knn_slots_f32h(c2, k)
            else:
                fn = lib.dgcnn_knn_slots_bf16 if kernel == "sweep" else lib.dgcnn_knn_slots
                slots = fn(c2, k, int(ceiling))
        if slots <= 0:
            raise RuntimeError(f"knn kernel occupancy query failed: CUDA error {-slots}")
        _slots_cache[key] = slots
    blocks = b * -(-nq // QB)
    if kernel == "tc":
        return split_count_idle(blocks, -(-nk // TB_TC), _slots_cache[key])
    return split_count(blocks, -(-nk // TB), _slots_cache[key])


def _check(name, t, dtype, ndim, device):
    if t.dtype != dtype or t.dim() != ndim or t.device != device:
        raise ValueError(
            f"{name}: expected a {ndim}-d {dtype} tensor on {device}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _launch(xq, xk, k: int, mask_k, precision: str = "highest"):
    """Run ``csrc/knn.cu`` on CUDA tensors. Raises on anything it does not
    take, and when the launch is refused."""
    dev = xq.device
    _check("xq", xq, torch.float32, 3, dev)
    _check("xk", xk, torch.float32, 3, dev)
    b, nq, c = xq.shape
    nk = xk.shape[1]
    if xk.shape[0] != b or xk.shape[2] != c:
        raise ValueError(f"xk {tuple(xk.shape)} does not match xq {tuple(xq.shape)}")
    if mask_k is not None:
        _check("mask", mask_k, torch.bool, 2, dev)
        if tuple(mask_k.shape) != (b, nk):
            raise ValueError(f"mask {tuple(mask_k.shape)} must be {(b, nk)}")
    if not 1 <= k <= nk:
        raise ValueError(f"k={k} must be in [1, Nk={nk}]")
    if not 1 <= b <= 65535:
        raise ValueError(f"batch {b} out of the kernel's grid range")
    # the Hopper fp32 kernel's operands come padded from the one copy
    hopper = precision == "highest" and f32_kernel_for(c + 2, k) == "hopper"
    qa, ka = build_augmented_operands(xq, xk, mask_k, precision, cpad=CPAD if hopper else 1)
    return launch_operands(qa, ka, k, precision)


def launch_operands(qa, ka, k: int, precision: str = "highest", kernel: str | None = None):
    """Launch the kernel on augmented operands from
    `build_augmented_operands` (contiguous f32 CUDA tensors ``(B, Nq, C+2)``
    and ``(B, Nk, C+2)``, of the same ``precision``; for ``"default"`` also
    `tc_operand`'s bf16 form); returns ``(idx, valid, scores)``. ``k <=
    KMAX`` is one pass, finished by the kernel; a larger ``k`` runs in
    passes of raw lists, each behind the last entry of the one before,
    finished here once. ``kernel`` forces the form, for the card's
    comparisons of the two: with ``"default"`` ``"tc"`` or ``"sweep"``
    (None: by `tc_kernel_for`), with ``"highest"`` ``"hopper"`` or
    ``"sweep"`` (None: by `f32_kernel_for`; the Hopper kernel's operands
    are padded to a multiple of ``CPAD`` channels here where they are
    not)."""
    global launches, launches_f32_hopper, launches_tc, launches_tc_sweep
    if check_precision(precision) == "default":
        qa, ka = tc_operand(qa), tc_operand(ka)
        _check("qa", qa, torch.bfloat16, 3, qa.device)
        _check("ka", ka, torch.bfloat16, 3, qa.device)
        kernel = resolve_tc_kernel(qa.shape[-1], k, kernel=kernel)
        if kernel == "tc":
            check_aligned(qa, ka)
    else:
        _check("qa", qa, torch.float32, 3, qa.device)
        _check("ka", ka, torch.float32, 3, qa.device)
        if resolve_f32_kernel(qa.shape[-1], k, kernel) == "hopper":
            qa, ka = f32_operand(qa), f32_operand(ka)
            check_aligned(qa, ka)
            kernel = "f32_hopper"
        else:
            kernel = "fp32"
    if k <= KMAX:
        out = _launch_pass(qa, ka, k, None, raw=False, kernel=kernel)
    else:
        idx, vals, ceil = [], [], None
        for lo in range(0, k, KMAX):
            i, _, v = _launch_pass(qa, ka, min(KMAX, k - lo), ceil, raw=True, kernel=kernel)
            idx.append(i)
            vals.append(v)
            ceil = (v[..., -1].contiguous(), i[..., -1].contiguous())
        out = _finish(torch.cat(idx, dim=-1), torch.cat(vals, dim=-1), qa.shape[1], ka.shape[1])
    if kernel == "tc":
        launches_tc += 1
    elif kernel == "sweep":
        launches_tc_sweep += 1
    else:
        launches += 1
        launches_f32_hopper += kernel == "f32_hopper"
    return out


def _launch_pass(qa, ka, k: int, ceil, *, raw: bool, kernel: str):
    """One pass of ``k <= KMAX`` entries behind the rows' ceilings ``ceil``
    (``(vals, idx)``, ``(B, Nq)`` each) or none, on ``kernel`` (one of
    `KERNELS`: f32 operands for ``"fp32"`` and ``"f32_hopper"``, bf16 ones
    for the TC kernels; ``"tc"`` and ``"f32_hopper"`` take no ceiling).
    With a key split S > 1 it allocates the partial lists' workspace ``(S,
    B, Nq, k)``."""
    dev = qa.device
    b, nq, c2 = qa.shape
    nk = ka.shape[1]
    idx = torch.empty((b, nq, k), dtype=torch.int32, device=dev)
    valid = torch.empty((b, nq, k), dtype=torch.bool, device=dev)
    scores = torch.empty((b, nq, k), dtype=torch.float32, device=dev)
    lib = _lib()
    splits = choose_splits(b, nq, nk, c2, k, dev, ceiling=ceil is not None, kernel=kernel)
    part_v = part_i = None
    if splits > 1:
        part_v = torch.empty((splits, b, nq, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((splits, b, nq, k), dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (qa, ka, idx, valid, scores)] + [
        None if t is None else t.data_ptr() for t in (part_v, part_i)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kernel in ("tc", "f32_hopper"):
            fn = lib.dgcnn_knn_topk_tc if kernel == "tc" else lib.dgcnn_knn_topk_f32h
            err = fn(*ptrs, b, nq, nk, c2, k, splits, int(raw), stream)
        else:
            cv, ci = (None, None) if ceil is None else (t.data_ptr() for t in ceil)
            err = (lib.dgcnn_knn_topk_bf16 if kernel == "sweep" else lib.dgcnn_knn_topk_f32)(
                *ptrs, cv, ci, b, nq, nk, c2, k, splits, int(raw), stream)
    if err != 0:
        raise RuntimeError(f"knn kernel launch failed: CUDA error {err}")
    return idx, valid, scores


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from dgcnn_tpu_torch.kernels import _build

        lib = _build.load("knn")
        vp, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.dgcnn_knn_topk_f32, lib.dgcnn_knn_topk_bf16):
            fn.argtypes = [vp] * 9 + [i] * 7 + [vp]
            fn.restype = i
        for fn in (lib.dgcnn_knn_topk_tc, lib.dgcnn_knn_topk_f32h):
            fn.argtypes = [vp] * 7 + [i] * 7 + [vp]
            fn.restype = i
        for fn, args in ((lib.dgcnn_knn_kmax, []), (lib.dgcnn_knn_max_splits, []),
                         (lib.dgcnn_knn_chunk, [i]), (lib.dgcnn_knn_slots, [i, i, i]),
                         (lib.dgcnn_knn_slots_bf16, [i, i, i]), (lib.dgcnn_knn_slots_tc, [i, i]),
                         (lib.dgcnn_knn_slots_f32h, [i, i]), (lib.dgcnn_knn_tc_max_c2, []),
                         (lib.dgcnn_knn_tc_tile, []), (lib.dgcnn_knn_f32h_max_c2, [])):
            fn.argtypes = args
            fn.restype = i
        if (lib.dgcnn_knn_kmax(), lib.dgcnn_knn_max_splits(), lib.dgcnn_knn_tc_max_c2(),
                lib.dgcnn_knn_tc_tile(), lib.dgcnn_knn_f32h_max_c2()) != (
                    KMAX, MAX_SPLITS, TC_MAX_C2, TB_TC, F32_MAX_C2):
            raise RuntimeError("csrc/knn.cu and knn_cuda's KMAX, MAX_SPLITS, TC_MAX_C2, TB_TC "
                               "or F32_MAX_C2 disagree")
        _LIB = lib
    return _LIB


def _dispatch(xq, xk, k, mask_k, precision):
    if xq.device.type == "cpu":
        return knn_plain(xq, xk, k, mask_k, precision)
    if xq.device.type == "cuda":
        return _launch(xq, xk, k, mask_k, precision)
    raise ValueError(f"knn_cuda: no kernel for device {xq.device}")


def knn_cuda(x, k: int, mask=None, *, return_scores: bool = False,
             precision: str = "highest"):
    """Drop-in ``knn_fn`` (same contract as `ops.knn.knn_indices`):
    ``(idx int32, valid bool)`` of shape ``(B, N, k)``, plus the scores
    with ``return_scores``. ``precision="default"`` scores on the tensor
    cores. A thin wrapper over the registered operator
    ``dgcnn_tpu_torch::knn`` (`kernels.ops`), so an exported program holds
    the graph build as one node that launches this kernel on the card."""
    from dgcnn_tpu_torch.kernels import ops

    out = ops.knn(x, k, mask, check_precision(precision))
    return out if return_scores else out[:2]


def knn_cuda_cross(xq, xk, k: int, mask_k=None, precision: str = "highest"):
    """Top-k keys of ``xk`` for every query of ``xq``: ``(idx into xk,
    valid, scores)``. Scores are ``|q|^2 - D``, comparable across key sets
    of the same queries."""
    return _dispatch(xq, xk, k, mask_k, precision)
