"""Exact ring kNN over point shards, ``ring_impl="rdma"``: the hand-written
CUDA kernel and its plain version (port of
`dgcnn_tpu/kernels/ring_knn_rdma.py`).

Every rank of the point-shard group holds ``(B, N_local, C)`` of each
event. `ring_knn_cuda` builds the rank's augmented operands
(`kernels.knn_cuda.build_augmented_operands`: the mask folded into the
key block's last lane), then for ``s = 0 .. P-1`` merges the key block it
holds, that of owner ``(rank - s) mod P``, into its queries' running top-k
while the block travels on to the next rank
(`parallel.collectives.ppermute_ring_start` before the merge, ``wait``
after it; two blocks in flight, as the Pallas kernel's double buffer).
The send/recv rendezvous takes the place of the Pallas kernel's credit
tokens. The merge orders by (score desc, global index asc), so the graph
is a single top-k over all N points: the same contract as `ring_knn`.

- On a CUDA tensor each merge launches ``csrc/ring_knn.cu`` (built at
  first use by `kernels._build`) on the current stream, or raises; it
  updates the running lists in place. Its scores are the exact kernel's
  (`csrc/knn.cu`) bit for bit.
- On a CPU tensor the merges run `step_plain`: the same augmented scores
  through ``torch.matmul``, the block's stable top-k and a lexicographic
  merge with the running list (`ring_knn_rdma_plain`).
- ``k > KMAX``: passes of at most 64 entries, pass ``p`` behind each row's
  ceiling, the last entry of pass ``p - 1``. The rank keeps the P key
  blocks that the rotation of pass 0 delivered and sweeps the later passes
  over them locally, with no further transport: ``(B, N, C+2)`` floats a
  rank (34.6 MB at 131,072 points and C=64), against P - 1 more transfers
  a pass, which on ranks sharing one card cost more than the sweep. Both
  step functions run the same passes.

``precision="default"`` (``--knn_precision default``) builds the
bf16-rounded operands (`knn_cuda.build_augmented_operands`) and launches a
tensor-core kernel, whose scores are the exact TC kernel's bit for bit;
the key blocks travel as the rounded f32 operands and each launch casts
them to bf16 (`knn_cuda.tc_operand`, exact). `knn_cuda.tc_kernel_for`
picks the kernel of each launch by its shape: the Hopper kernel
(``dgcnn_ring_knn_step_tc``, ``csrc/knn_tc.cuh``'s pipeline) for a step of
one pass (no ceiling) at padded widths up to ``TC_MAX_C2``, else the
sweep's TC instantiation (``dgcnn_ring_knn_step_bf16``, ``sweep_tc``): the
later passes of ``k > KMAX`` and wider operands. `step_plain` takes the
same rounded operands.

``launches`` counts fp32 kernel launches, ``launches_tc`` those of the
Hopper TC kernel and ``launches_tc_sweep`` those of ``sweep_tc`` (one a
ring step of a pass); the plain path does not count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dgcnn_tpu_torch.kernels.knn_cuda import (
    INVALID_BELOW,
    _check,
    behind,
    TC_MAX_C2,
    build_augmented_operands,
    check_aligned,
    check_precision,
    resolve_tc_kernel,
    tc_operand,
)
from dgcnn_tpu_torch.ops.knn import BLOCK_Q, tie_sort, top_k_stable
from dgcnn_tpu_torch.parallel.collectives import ppermute_ring_start

KMAX = 64  # entries a pass of the kernel (csrc/knn_sweep.cuh)
LIST_FILL = torch.finfo(torch.float32).min  # an empty slot of a running list

launches = 0
launches_tc = 0
launches_tc_sweep = 0


def init_running(b: int, nq: int, k: int, device):
    """Empty running lists ``(topv f32, topi i32)``, ``(B, nq, k)``."""
    return (torch.full((b, nq, k), LIST_FILL, dtype=torch.float32, device=device),
            torch.zeros((b, nq, k), dtype=torch.int32, device=device))


def step_plain(qa, ka, base: int, topv, topi, ceil=None) -> None:
    """Plain version of one launch: merge the keys of ``ka`` (global
    indices ``base + j``) into the running lists ``topv``/``topi`` of the
    queries ``qa``, in place; with ``ceil`` (``(vals, global idx)``, ``(B,
    nq)`` each) only the keys behind each row's ceiling."""
    k, nk = topv.shape[-1], ka.shape[1]
    kat = ka.transpose(-1, -2)
    cols = base + torch.arange(nk, device=qa.device)
    for lo in range(0, qa.shape[1], BLOCK_Q):  # bounds the (B, rows, nk) buffers
        hi = min(lo + BLOCK_Q, qa.shape[1])
        s = torch.matmul(qa[:, lo:hi], kat)
        if ceil is not None:
            keep = behind(s, cols, ceil[0][:, lo:hi, None], ceil[1][:, lo:hi, None])
            s = torch.where(keep, s, float("-inf"))
        bv, bi = top_k_stable(s, min(k, nk))
        v, i = tie_sort(torch.cat([topv[:, lo:hi], bv], dim=-1),
                         torch.cat([topi[:, lo:hi].long(), bi + base], dim=-1))
        topv[:, lo:hi] = v[..., :k]
        topi[:, lo:hi] = i[..., :k].to(torch.int32)


def launch_step(qa, ka, base: int, topv, topi, ceil=None, *, precision: str = "highest",
                kernel: str | None = None) -> None:
    """One launch of ``csrc/ring_knn.cu`` on CUDA tensors: the kernel form
    of `step_plain`. ``precision="default"`` launches a TC kernel on the
    bf16 form of the rounded operands (`tc_operand`): ``kernel`` (``"tc"``,
    the Hopper kernel, or ``"sweep"``, sweep_tc) forces one, for the card's
    comparisons of the two; None: `knn_cuda.tc_kernel_for` by the shape.
    Raises on anything the kernel does not take, and when the launch is
    refused."""
    global launches, launches_tc, launches_tc_sweep
    dev = qa.device
    tc = check_precision(precision) == "default"
    if tc:
        qa, ka = tc_operand(qa), tc_operand(ka)
    elif kernel not in (None, "fp32"):
        raise ValueError(f"kernel {kernel!r} takes precision='default'")
    dtype = torch.bfloat16 if tc else torch.float32
    _check("qa", qa, dtype, 3, dev)
    _check("ka", ka, dtype, 3, dev)
    _check("topv", topv, torch.float32, 3, dev)
    _check("topi", topi, torch.int32, 3, dev)
    b, nq, c2 = qa.shape
    nk, k = ka.shape[1], topv.shape[-1]
    if ka.shape[0] != b or ka.shape[2] != c2:
        raise ValueError(f"ka {tuple(ka.shape)} does not match qa {tuple(qa.shape)}")
    if tuple(topv.shape) != (b, nq, k) or tuple(topi.shape) != (b, nq, k):
        raise ValueError(f"running lists {tuple(topv.shape)}, {tuple(topi.shape)} must be "
                         f"{(b, nq, k)}")
    if not 1 <= k <= min(nk, KMAX):
        raise ValueError(f"k={k} must be in [1, min(Nk={nk}, {KMAX})]")
    if not 1 <= b <= 65535:
        raise ValueError(f"batch {b} out of the kernel's grid range")
    if not 0 <= base <= 2**31 - 1 - nk:
        raise ValueError(f"global base {base} out of int32 range")
    cv = ci = None
    if ceil is not None:
        cv, ci = ceil
        _check("ceiling scores", cv, torch.float32, 2, dev)
        _check("ceiling indices", ci, torch.int32, 2, dev)
        if tuple(cv.shape) != (b, nq) or tuple(ci.shape) != (b, nq):
            raise ValueError(f"ceilings {tuple(cv.shape)}, {tuple(ci.shape)} must be {(b, nq)}")
    form = resolve_tc_kernel(c2, k, ceil is not None, kernel) if tc else "fp32"
    if form == "tc":
        check_aligned(qa, ka)
    lib = _lib()
    lists = (qa.data_ptr(), ka.data_ptr(), topv.data_ptr(), topi.data_ptr())
    ceils = (None if cv is None else cv.data_ptr(), None if ci is None else ci.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if form == "tc":
            err = lib.dgcnn_ring_knn_step_tc(*lists, b, nq, nk, c2, k, base, stream)
        else:
            err = (lib.dgcnn_ring_knn_step_bf16 if tc else lib.dgcnn_ring_knn_step_f32)(
                *lists, *ceils, b, nq, nk, c2, k, base, stream)
    if err != 0:
        raise RuntimeError(f"ring knn kernel launch failed: CUDA error {err}")
    if form == "tc":
        launches_tc += 1
    elif form == "sweep":
        launches_tc_sweep += 1
    else:
        launches += 1


def finish(topv, topi, self_base: int):
    """``(idx int32, valid bool)`` from the final running lists: a slot
    scoring <= -1e29 (fewer than k valid points in the event) becomes the
    global self index ``self_base + i``."""
    valid = topv > INVALID_BELOW
    self_idx = self_base + torch.arange(topv.shape[1], dtype=torch.int32, device=topv.device)
    return torch.where(valid, topi, self_idx[None, :, None]), valid


def later_passes(qa, blocks, k: int, topv, topi, step):
    """Passes 1 .. of a ``k > KMAX`` graph over the ``(ka, base)`` blocks
    that pass 0 (the running lists ``topv``/``topi``) swept: each pass
    behind the last entry of the one before. Returns the concatenated
    lists ``(B, nq, k)``."""
    vals, idx = [topv], [topi]
    for lo in range(topv.shape[-1], k, KMAX):
        ceil = (vals[-1][..., -1].contiguous(), idx[-1][..., -1].contiguous())
        tv, ti = init_running(qa.shape[0], qa.shape[1], min(KMAX, k - lo), qa.device)
        for ka, base in blocks:
            step(qa, ka, base, tv, ti, ceil)
        vals.append(tv)
        idx.append(ti)
    return torch.cat(vals, dim=-1), torch.cat(idx, dim=-1)


def merge_blocks(qa, blocks, k: int, self_base: int, step, *, return_scores: bool = False):
    """The merges of one rank without transport: ``blocks`` are
    ``(ka, base)`` pairs in the order the rank sees them on the ring,
    ``step`` is `launch_step` or `step_plain`. Returns `finish`'s
    ``(idx, valid)``, and the selected scores with ``return_scores``."""
    topv, topi = init_running(qa.shape[0], qa.shape[1], min(k, KMAX), qa.device)
    for ka, base in blocks:
        step(qa, ka, base, topv, topi)
    topv, topi = later_passes(qa, blocks, k, topv, topi, step)
    out = finish(topv, topi, self_base)
    return out + (topv,) if return_scores else out


def _ring(x_shard, k: int, mask_shard, group, step, precision: str = "highest"):
    p, me = group.size, group.rank
    b, nl, _ = x_shard.shape
    if k > nl:
        raise ValueError(f"k={k} > local shard size {nl}")
    qa, ka = build_augmented_operands(x_shard, x_shard, mask_shard, precision)
    if step is launch_step and precision == "default":
        qa = tc_operand(qa)  # the resident queries, cast once
        step = functools.partial(launch_step, precision=precision)
    topv, topi = init_running(b, nl, min(k, KMAX), x_shard.device)
    blk, kept = ka, []
    for s in range(p):
        # the next block leaves before this one is merged and lands after
        nxt = ppermute_ring_start(blk, group) if s < p - 1 else None
        base = ((me - s) % p) * nl
        step(qa, blk, base, topv, topi)
        if k > KMAX:
            kept.append((blk, base))
        if nxt is not None:
            blk = nxt.wait()
    topv, topi = later_passes(qa, kept, k, topv, topi, step)
    return finish(topv, topi, me * nl)


def ring_knn_rdma_plain(x_shard, k: int, mask_shard=None, *, group, precision: str = "highest"):
    """Plain version of `ring_knn_cuda`: the same ring with `step_plain`."""
    return _ring(x_shard, k, mask_shard, group, step_plain, precision)


def ring_knn_cuda(x_shard, k: int, mask_shard=None, *, group, precision: str = "highest"):
    """Global exact kNN of this rank's shard (same contract as
    `kernels.ring_knn.ring_knn`): ``(idx int32, valid bool)``, each
    ``(B, N_local, k)``, global indices ordered as one top-k over all N
    points. A CUDA tensor runs the kernel (``precision="default"``: its TC
    instantiation), a CPU tensor the plain version."""
    if x_shard.device.type == "cpu":
        return ring_knn_rdma_plain(x_shard, k, mask_shard, group=group, precision=precision)
    if x_shard.device.type != "cuda":
        raise ValueError(f"ring_knn_cuda: no kernel for device {x_shard.device}")
    dev = x_shard.device
    _check("x_shard", x_shard, torch.float32, 3, dev)
    if mask_shard is not None:
        _check("mask_shard", mask_shard, torch.bool, 2, dev)
        if tuple(mask_shard.shape) != tuple(x_shard.shape[:2]):
            raise ValueError(f"mask {tuple(mask_shard.shape)} must be {tuple(x_shard.shape[:2])}")
    return _ring(x_shard, k, mask_shard, group, launch_step, precision)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from dgcnn_tpu_torch.kernels import _build

        lib = _build.load("ring_knn")
        vp, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.dgcnn_ring_knn_step_f32, lib.dgcnn_ring_knn_step_bf16):
            fn.argtypes = [vp] * 6 + [i] * 6 + [vp]
            fn.restype = i
        lib.dgcnn_ring_knn_step_tc.argtypes = [vp] * 4 + [i] * 6 + [vp]
        lib.dgcnn_ring_knn_step_tc.restype = i
        for fn, args in ((lib.dgcnn_ring_knn_kmax, []), (lib.dgcnn_ring_knn_chunk, [i]),
                         (lib.dgcnn_ring_knn_tc_max_c2, [])):
            fn.argtypes = args
            fn.restype = i
        if (lib.dgcnn_ring_knn_kmax(), lib.dgcnn_ring_knn_tc_max_c2()) != (KMAX, TC_MAX_C2):
            raise RuntimeError("csrc/ring_knn.cu and ring_knn_cuda's KMAX or TC_MAX_C2 disagree")
        _LIB = lib
    return _LIB
