"""Banded kNN over Morton-sorted points: the hand-written CUDA kernel and
its plain version (port of `dgcnn_tpu/kernels/knn_banded.py`).

Each query at global sorted position ``q_base + r`` scores only the keys
at global positions ``[lo, lo + window)``, ``lo = band_lo(q_base + r,
nvalid, window)`` (`ops.knn.band_lo`), with the exact kernel's augmented
operands (`knn_cuda.build_augmented_operands`, so the score is defined in
one place), and keeps the ``k`` largest, ties by score descending then key
index ascending. A slot whose score is <= -1e29 (fewer than ``k`` valid
in-band keys) becomes the self-edge ``q_base + r`` with ``valid`` False.
Indices come back global (key-local plus ``key_base``).

- `knn_banded_cuda` (self form, bases 0) and `knn_banded_cuda_cross`
  (offset query and key positions, the halo context-parallel form): on a
  CUDA tensor they launch ``csrc/knn_banded.cu`` (built at first use by
  `kernels._build`) on the current stream, or raise. On a CPU tensor they
  run `knn_banded_plain`. The self form goes through the registered
  operator ``dgcnn_tpu_torch::knn_banded`` (`kernels.ops`), whose CUDA
  implementation is `_launch`.
- `knn_banded_plain`: the same operands through an fp32 ``torch.matmul``,
  one strip of query rows at a time over the strip's key span, out-of-band
  scores set to -inf, selection by `ops.knn.top_k_stable`.
- ``k > KMAX`` runs in passes, as `knn_cuda.launch_operands` does: each
  pass keeps at most 64 entries behind the last entry of the pass before,
  and the concatenated lists are finished once.

``precision="default"`` (``--knn_precision default``) rounds the operands
to bf16 (`knn_cuda.build_augmented_operands`) and launches a tensor-core
kernel on CUDA, each pass the one `knn_cuda.tc_kernel_for` picks for its
shape: the Hopper kernel (``dgcnn_knn_banded_tc``, ``csrc/knn_tc.cuh``'s
pipeline over the block's band) for a pass without a ceiling at padded
widths up to ``TC_MAX_C2``, else the sweep's TC instantiation
(``dgcnn_knn_banded_bf16``, ``sweep_tc``): the later passes of ``k > KMAX``
and wider operands. The two give the same bits. The plain version takes
the same rounded operands.

``launches`` counts graph builds that launched the fp32 kernel,
``launches_tc`` those that launched the Hopper TC kernel and
``launches_tc_sweep`` those that launched ``sweep_tc`` (a build of ``k >
KMAX`` counts in both); the plain path does not count.
"""

from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.kernels.knn_cuda import (
    INVALID_BELOW,
    KMAX,
    TC_MAX_C2,
    _check,
    build_augmented_operands,
    check_aligned,
    check_precision,
    resolve_tc_kernel,
    tc_operand,
)
from dgcnn_tpu_torch.ops.knn import BLOCK_Q, band_lo, top_k_stable

# the kernel computes positions in 32-bit ints
POSITION_LIMIT = 2**31

launches = 0
launches_tc = 0
launches_tc_sweep = 0


def _nvalid_of(mask, b: int, n: int, device):
    if mask is None:
        return torch.full((b,), n, dtype=torch.int32, device=device)
    return mask.sum(-1).to(torch.int32)


def knn_banded_plain(xq, xk, k: int, mask_k=None, *, window: int, q_base: int = 0,
                     key_base: int = 0, nvalid=None, precision: str = "highest"):
    """Plain PyTorch version of the kernel: ``(idx, valid, scores)``, each
    ``(B, Nq, k)``; ``idx`` int32 global positions, scores ``|x_i|^2 -
    D_ij``. ``nvalid`` ``(B,)``: valid points of the whole event (default:
    the count of ``mask_k``). Query strips of ``BLOCK_Q`` rows each score
    the key span ``[lo_first, lo_last + window)`` (``lo`` is monotone in
    position), at most ``BLOCK_Q + window`` keys."""
    b, nq, _ = xq.shape
    nk = xk.shape[1]
    if not 1 <= k <= min(window, nk):
        raise ValueError(f"k={k} must be in [1, min(window={window}, Nk={nk})]")
    if nvalid is None:
        nvalid = _nvalid_of(mask_k, b, nk, xq.device)
    nvalid = torch.as_tensor(nvalid, device=xq.device).to(torch.int64)
    qa, ka = build_augmented_operands(xq, xk, mask_k, precision)
    span = min(BLOCK_Q + window, nk)
    offs = torch.arange(span, device=xq.device)
    vals, idx = [], []
    for r0 in range(0, nq, BLOCK_Q):
        rows = q_base + torch.arange(r0, min(r0 + BLOCK_Q, nq), device=xq.device)
        lo = band_lo(rows[None, :], nvalid[:, None], window)  # (B, S) global
        start = torch.clamp(lo[:, 0] - key_base, 0, nk - span)  # (B,) key-local
        cols = start[:, None] + offs  # (B, span)
        keys = torch.gather(ka, 1, cols[..., None].expand(-1, -1, ka.shape[-1]))
        s = torch.matmul(qa[:, r0 : r0 + BLOCK_Q], keys.transpose(-1, -2))
        g = (key_base + cols)[:, None, :]
        band = (g >= lo[..., None]) & (g < (lo + window)[..., None])
        v, c = top_k_stable(torch.where(band, s, float("-inf")), k)
        vals.append(v)
        idx.append(torch.gather(cols, 1, c.reshape(b, -1)).reshape(c.shape))
    return _finish(key_base + torch.cat(idx, dim=1), torch.cat(vals, dim=1), q_base)


def _finish(idx, vals, q_base: int):
    """``(idx int32, valid, vals)`` from global indices and scores: a slot
    scoring <= -1e29 becomes the self-edge ``q_base + r``."""
    valid = vals > INVALID_BELOW
    self_idx = q_base + torch.arange(vals.shape[1], device=vals.device)[None, :, None]
    return torch.where(valid, idx, self_idx).to(torch.int32), valid, vals


def _launch(xq, xk, k: int, mask_k, *, window: int, q_base: int, key_base: int, nvalid,
            precision: str = "highest"):
    """Run ``csrc/knn_banded.cu`` on CUDA tensors. Raises on anything it
    does not take, and when the launch is refused."""
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
    if nvalid is None:
        nvalid = _nvalid_of(mask_k, b, nk, dev)
    nvalid = torch.as_tensor(nvalid).to(dev, torch.int32).contiguous()
    if tuple(nvalid.shape) != (b,):
        raise ValueError(f"nvalid {tuple(nvalid.shape)} must be ({b},)")
    if not 1 <= k <= min(nk, window):
        raise ValueError(f"k={k} must be in [1, min(Nk={nk}, window={window})]")
    if q_base < 0 or key_base < 0 or max(q_base + nq, key_base + nk) + window >= POSITION_LIMIT:
        raise ValueError("positions out of the kernel's 32-bit range")
    if not 1 <= b <= 65535:
        raise ValueError(f"batch {b} out of the kernel's grid range")
    qa, ka = build_augmented_operands(xq, xk, mask_k, precision)
    return launch_operands(qa, ka, nvalid, k, window=window, q_base=q_base, key_base=key_base,
                           precision=precision)


def launch_operands(qa, ka, nvalid, k: int, *, window: int, q_base: int = 0, key_base: int = 0,
                    precision: str = "highest", kernel: str | None = None):
    """Launch the kernel on augmented operands from
    `build_augmented_operands` (contiguous f32 CUDA tensors ``(B, Nq, C+2)``
    and ``(B, Nk, C+2)`` of the same ``precision``; for ``"default"`` also
    `tc_operand`'s bf16 form) and ``nvalid`` (contiguous int32 ``(B,)``);
    returns ``(idx, valid, scores)``. ``k > KMAX`` runs in passes.
    ``kernel`` forces the TC kernel of every pass (``"tc"``, the Hopper
    kernel, for one pass, or ``"sweep"``), for the card's comparisons of the
    two; None: `knn_cuda.tc_kernel_for` by each pass's shape."""
    global launches, launches_tc, launches_tc_sweep
    dev = qa.device
    tc = check_precision(precision) == "default"
    if tc:
        qa, ka = tc_operand(qa), tc_operand(ka)
        if kernel is not None:
            resolve_tc_kernel(qa.shape[-1], k, kernel=kernel)
    elif kernel not in (None, "fp32"):
        raise ValueError(f"kernel {kernel!r} takes precision='default'")
    dtype = torch.bfloat16 if tc else torch.float32
    _check("qa", qa, dtype, 3, dev)
    _check("ka", ka, dtype, 3, dev)
    _check("nvalid", nvalid, torch.int32, 1, dev)
    band = dict(window=window, q_base=q_base, key_base=key_base)
    forms = set()

    def one_pass(kp, ceil, raw):
        form = resolve_tc_kernel(qa.shape[-1], kp, ceil is not None, kernel) if tc else "fp32"
        forms.add(form)
        return _launch_pass(qa, ka, nvalid, kp, ceil, raw=raw, kernel=form, **band)

    if k <= KMAX:
        out = one_pass(k, None, False)
    else:
        idx, vals, ceil = [], [], None
        for lo in range(0, k, KMAX):
            i, _, v = one_pass(min(KMAX, k - lo), ceil, True)
            idx.append(i)
            vals.append(v)
            # the sweep's indices are key-local
            ceil = (v[..., -1].contiguous(), (i[..., -1] - key_base).contiguous())
        out = _finish(torch.cat(idx, dim=-1), torch.cat(vals, dim=-1), q_base)
    launches_tc += "tc" in forms
    launches_tc_sweep += "sweep" in forms
    launches += "fp32" in forms
    return out


def _launch_pass(qa, ka, nvalid, k: int, ceil, *, raw: bool, kernel: str, window: int,
                 q_base: int, key_base: int):
    """One pass of ``k <= KMAX`` entries behind the rows' ceilings ``ceil``
    (``(vals, key-local idx)``, ``(B, Nq)`` each) or none, on ``kernel``:
    ``"fp32"`` (f32 operands), ``"sweep"`` (sweep_tc) or ``"tc"`` (the
    Hopper kernel, no ceiling), the TC kernels on bf16 operands."""
    dev = qa.device
    b, nq, c2 = qa.shape
    nk = ka.shape[1]
    idx = torch.empty((b, nq, k), dtype=torch.int32, device=dev)
    valid = torch.empty((b, nq, k), dtype=torch.bool, device=dev)
    scores = torch.empty((b, nq, k), dtype=torch.float32, device=dev)
    cv, ci = (None, None) if ceil is None else ceil
    if kernel == "tc":
        check_aligned(qa, ka)
    lib = _lib()
    ptrs = (qa.data_ptr(), ka.data_ptr(), nvalid.data_ptr(), idx.data_ptr(), valid.data_ptr(),
            scores.data_ptr())
    shape = (b, nq, nk, c2, k, window, q_base, key_base, int(raw))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kernel == "tc":
            err = lib.dgcnn_knn_banded_tc(*ptrs, *shape, stream)
        else:
            fn = lib.dgcnn_knn_banded_bf16 if kernel == "sweep" else lib.dgcnn_knn_banded_f32
            err = fn(*ptrs, None if cv is None else cv.data_ptr(),
                     None if ci is None else ci.data_ptr(), *shape, stream)
    if err != 0:
        raise RuntimeError(f"banded knn kernel launch failed: CUDA error {err}")
    return idx, valid, scores


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from dgcnn_tpu_torch.kernels import _build

        lib = _build.load("knn_banded")
        vp, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.dgcnn_knn_banded_f32, lib.dgcnn_knn_banded_bf16):
            fn.argtypes = [vp] * 8 + [i] * 9 + [vp]
            fn.restype = i
        lib.dgcnn_knn_banded_tc.argtypes = [vp] * 6 + [i] * 9 + [vp]
        lib.dgcnn_knn_banded_tc.restype = i
        for fn, args in ((lib.dgcnn_knn_banded_kmax, []), (lib.dgcnn_knn_banded_chunk, [i]),
                         (lib.dgcnn_knn_banded_tc_max_c2, [])):
            fn.argtypes = args
            fn.restype = i
        if (lib.dgcnn_knn_banded_kmax(), lib.dgcnn_knn_banded_tc_max_c2()) != (KMAX, TC_MAX_C2):
            raise RuntimeError("csrc/knn_banded.cu and knn_cuda's KMAX or TC_MAX_C2 disagree")
        _LIB = lib
    return _LIB


def _dispatch(xq, xk, k, mask_k, **band):
    if xq.device.type == "cpu":
        return knn_banded_plain(xq, xk, k, mask_k, **band)
    if xq.device.type == "cuda":
        return _launch(xq, xk, k, mask_k, **band)
    raise ValueError(f"knn_banded_cuda: no kernel for device {xq.device}")


def knn_banded_cuda(x, k: int, mask=None, *, window: int, return_scores: bool = False,
                    precision: str = "highest"):
    """Drop-in banded ``knn_fn`` (same contract as
    `ops.knn.banded_knn_indices`; ``x`` Morton-sorted, padded points
    last): ``(idx int32, valid bool)`` of shape ``(B, N, k)``, plus the
    scores with ``return_scores``. The window is clipped to N.
    ``precision="default"`` scores on the tensor cores. A thin wrapper over
    the registered operator ``dgcnn_tpu_torch::knn_banded`` (`kernels.ops`),
    so an exported program holds the graph build as one node that launches
    this kernel on the card."""
    from dgcnn_tpu_torch.kernels import ops

    out = ops.knn_banded(x, k, mask, window, check_precision(precision))
    return out if return_scores else out[:2]


def knn_banded_cuda_cross(xq, xk, k: int, mask_k=None, *, window: int, q_base: int,
                          key_base: int, nvalid, precision: str = "highest"):
    """Banded selection with offset positions (the halo context-parallel
    form): query row ``r`` at global sorted position ``q_base + r``, key
    row ``j`` at ``key_base + j``, ``nvalid`` ``(B,)`` valid points of the
    whole event. Returns ``(idx, valid, scores)``, ``idx`` global. Rows of
    padded queries whose windows leave the key array are garbage the
    caller discards, as in the JAX package."""
    return _dispatch(xq, xk, k, mask_k, window=window, q_base=int(q_base),
                     key_base=int(key_base), nvalid=nvalid, precision=precision)
