"""The fused EdgeConv block of MLP depth 2 in training: launches of
``csrc/edge_mlp.cu`` (built at first use by `kernels._build`) on the
current stream.

Four passes, each on CUDA tensors only (it raises otherwise, and for a
shape the kernels do not take; the plain PyTorch versions of the same
passes, which the CPU runs, are in `ops.edge`):

- `stats`: BN1's sums ``sum_e w_i y1_e`` and ``sum_e w_i y1_e^2`` over the
  edges ``y1_e = P_i + Q_j``, a gather and no product.
- `forward`: ``y2_e = relu(BN1(y1_e)) W2`` on the fly; BN2's sums and each
  row's max of ``y2`` over its edges where ``gsign`` (the min elsewhere)
  with the first winning slot (uint8).
- `backward`: the recompute of ``y1``, ``h1`` and ``y2`` and the chain back
  to ``dP``, ``dQ``, ``dW2`` and BN1's two cotangent sums.
- `stats_backward`: BN1's sums back to ``dP`` and ``dQ``.

Shapes: ``p`` ``(..., N, C)``, ``q`` ``(..., NQ, C)`` (an extended
neighbour operand may hold more rows), ``idx`` ``(..., N, k)`` into ``q``'s
rows, ``w`` ``(..., N)`` float query weights or None; ``C`` a multiple of
`CH` up to `CMAX`, ``k <= KMAX``. The per-channel sums come back as fp64
block partials, summed here once.

``launches`` counts the kernels launched (four a block a train step, six
under remat, whose recompute runs the forward passes again).
"""

from __future__ import annotations

import ctypes

import torch

CH, KC, CMAX, KMAX = 8, 10, 128, 64  # csrc/edge_mlp.cu
STATS, FORWARD, BACKWARD, STATS_BACKWARD = range(4)

launches = 0


def shape_ok(c: int, k: int) -> bool:
    """Whether the kernels take a block of width ``c`` and ``k``
    neighbours."""
    return c % CH == 0 and CH <= c <= CMAX and 1 <= k <= KMAX


def _check(name, t, dtype, device):
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: expected a {dtype} tensor on {device}, got {t.dtype} on "
                         f"{t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")


def _operands(p, q, idx, w):
    """The checked common operands and ``(rows, n, nq, c, k, lead)``."""
    if p.device.type != "cuda":
        raise ValueError(f"edge_mlp_cuda: no kernel for device {p.device}")
    dev = p.device
    *lead, n, c = p.shape
    nq, k = q.shape[-2], idx.shape[-1]
    if tuple(q.shape[:-2]) != tuple(lead) or q.shape[-1] != c:
        raise ValueError(f"q {tuple(q.shape)} does not match p {tuple(p.shape)}")
    if tuple(idx.shape[:-1]) != (*lead, n):
        raise ValueError(f"idx {tuple(idx.shape)} does not match p {tuple(p.shape)}")
    if not shape_ok(c, k):
        raise ValueError(f"edge_mlp_cuda takes C a multiple of {CH} up to {CMAX} and k <= "
                         f"{KMAX}, got C={c}, k={k}")
    rows = n
    for d in lead:
        rows *= d
    idx = idx.to(torch.int32).contiguous()
    _check("p", p, torch.float32, dev)
    _check("q", q, torch.float32, dev)
    _check("idx", idx, torch.int32, dev)
    if w is not None:
        if tuple(w.shape) != (*lead, n):
            raise ValueError(f"w {tuple(w.shape)} does not match p {tuple(p.shape)}")
        _check("w", w, torch.float32, dev)
    return idx, (rows, n, nq, c, k, tuple(lead))


def _grid(kind: int, c: int, rows: int, dev) -> int:
    """The blocks of a launch of ``kind`` at width ``c`` over ``rows`` query
    rows: as many as the card holds at once, at most one a block's share of
    rows. The kernel is readied once a (kind, width, device)."""
    key = (kind, c, dev.index)
    if key not in _PLANS:
        slots, per_block = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(dev):
            err = _lib().dgcnn_emlp_plan(kind, c, ctypes.byref(slots), ctypes.byref(per_block))
        if err != 0:
            raise RuntimeError(f"edge_mlp kernel occupancy query failed: CUDA error {err}")
        _PLANS[key] = (slots.value, per_block.value)
    slots, per_block = _PLANS[key]
    return min(slots, -(-rows // per_block))


def _run(name, fn, dev, *args):
    global launches
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"edge_mlp {name} launch failed: CUDA error {err}")
    launches += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _sums(partial, c):
    s = partial.sum(0).float()
    return s[:c], s[c:]


def stats(p, q, idx, w):
    """``(s1, s2)``, each ``(C,)``: ``sum_e w_i y1_e`` and ``sum_e w_i
    y1_e^2`` over every edge ``y1_e = P_i + Q_j``."""
    idx, (rows, n, nq, c, k, _) = _operands(p, q, idx, w)
    grid = _grid(STATS, c, rows, p.device)
    partial = torch.empty((grid, 2 * c), dtype=torch.float64, device=p.device)
    _run("stats", _lib().dgcnn_emlp_stats, p.device, p.data_ptr(), q.data_ptr(), idx.data_ptr(),
         _ptr(w), partial.data_ptr(), grid, rows, n, nq, c, k)
    return _sums(partial, c)


def forward(p, q, idx, w, mean1, r1, g1, b1, w2, gsign):
    """``(m, win, s1, s2)``: ``m`` ``(..., N, C)`` each row's max of ``y2``
    over its edges where ``gsign`` (``(C,)`` bool), else the min; ``win``
    ``(..., N, C)`` uint8 its first winning slot; ``s1``, ``s2`` ``(C,)``
    BN2's sums ``sum_e w_i y2_e`` and ``sum_e w_i y2_e^2``. ``mean1``,
    ``r1`` (``rsqrt(var1 + eps)``), ``g1``, ``b1``: BN1, ``(C,)`` each;
    ``w2`` ``(C, C)``."""
    idx, (rows, n, nq, c, k, lead) = _operands(p, q, idx, w)
    dev = p.device
    consts = torch.stack([mean1, r1, g1, b1]).float().contiguous()
    w2 = w2.float().contiguous()
    gs = gsign.to(torch.uint8).contiguous()
    for name, t, shape in (("consts", consts, (4, c)), ("w2", w2, (c, c)), ("gsign", gs, (c,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
    _check("consts", consts, torch.float32, dev)
    _check("w2", w2, torch.float32, dev)
    grid = _grid(FORWARD, c, rows, dev)
    m = torch.empty((*lead, n, c), dtype=torch.float32, device=dev)
    win = torch.empty((*lead, n, c), dtype=torch.uint8, device=dev)
    partial = torch.empty((grid, 2 * c), dtype=torch.float64, device=dev)
    _run("forward", _lib().dgcnn_emlp_forward, dev, p.data_ptr(), q.data_ptr(), idx.data_ptr(),
         _ptr(w), consts.data_ptr(), w2.data_ptr(), gs.data_ptr(), m.data_ptr(), win.data_ptr(),
         partial.data_ptr(), grid, rows, n, nq, c, k)
    return (m, win, *_sums(partial, c))


def backward(p, q, idx, w, mean1, r1, g1, b1, w2, win, dm, ds1, ds2):
    """The chain back from ``(dm, ds1, ds2)``, the cotangents of
    `forward`'s ``m`` and BN2's sums: ``(dp, dq, sdt, sdta, dw2)``, the
    gradients of ``p`` and ``q``, BN1's sums ``sum_e dt`` and ``sum_e dt
    (y1_e - mean1)`` (``dt`` the cotangent of BN1's output before the
    relu), and the gradient of ``w2``."""
    idx, (rows, n, nq, c, k, lead) = _operands(p, q, idx, w)
    dev = p.device
    consts = torch.stack([mean1, r1, g1, b1, ds1, ds2]).float().contiguous()
    w2 = w2.float().contiguous()
    dm = dm.float().contiguous()
    for name, t, dtype in (("consts", consts, torch.float32), ("w2", w2, torch.float32),
                           ("win", win, torch.uint8), ("dm", dm, torch.float32)):
        _check(name, t, dtype, dev)
    if tuple(win.shape) != (*lead, n, c) or tuple(dm.shape) != (*lead, n, c):
        raise ValueError(f"win {tuple(win.shape)} and dm {tuple(dm.shape)} must be "
                         f"{(*lead, n, c)}")
    grid = _grid(BACKWARD, c, rows, dev)
    dp = torch.empty_like(p)
    dq = torch.zeros_like(q)
    partial = torch.empty((grid, 2 * c), dtype=torch.float64, device=dev)
    dw2 = torch.zeros((grid, c, c), dtype=torch.float32, device=dev)
    _run("backward", _lib().dgcnn_emlp_backward, dev, p.data_ptr(), q.data_ptr(),
         idx.data_ptr(), _ptr(w), consts.data_ptr(), w2.data_ptr(), win.data_ptr(),
         dm.data_ptr(), dp.data_ptr(), dq.data_ptr(), partial.data_ptr(), dw2.data_ptr(), grid,
         rows, n, nq, c, k)
    sdt, sdta = _sums(partial, c)
    return dp, dq, sdt, sdta, dw2.sum(0)


def stats_backward(p, q, idx, w, ds1, ds2):
    """`stats` back from the cotangents ``(ds1, ds2)`` of its sums:
    ``(dp, dq)``."""
    idx, (rows, n, nq, c, k, _) = _operands(p, q, idx, w)
    dev = p.device
    dsum = torch.stack([ds1, ds2]).float().contiguous()
    _check("dsum", dsum, torch.float32, dev)
    grid = _grid(STATS_BACKWARD, c, rows, dev)
    dp = torch.empty_like(p)
    dq = torch.zeros_like(q)
    _run("stats_backward", _lib().dgcnn_emlp_stats_backward, dev, p.data_ptr(), q.data_ptr(),
         idx.data_ptr(), _ptr(w), dsum.data_ptr(), dp.data_ptr(), dq.data_ptr(), grid, rows, n,
         nq, c, k)
    return dp, dq


_LIB = None
_PLANS = {}  # (kind, c, device index) -> (slots, rows a block)


def _lib():
    global _LIB
    if _LIB is None:
        from dgcnn_tpu_torch.kernels import _build

        lib = _build.load("edge_mlp")
        vp, i = ctypes.c_void_p, ctypes.c_int
        shape = [i] * 6 + [vp]  # grid, rows, n, nq, c, k, stream
        for fn, ptrs in ((lib.dgcnn_emlp_stats, 5), (lib.dgcnn_emlp_forward, 10),
                         (lib.dgcnn_emlp_backward, 12), (lib.dgcnn_emlp_stats_backward, 7)):
            fn.argtypes = [vp] * ptrs + shape
            fn.restype = i
        ip = ctypes.POINTER(i)
        for fn, args in ((lib.dgcnn_emlp_ch, []), (lib.dgcnn_emlp_kc, []),
                         (lib.dgcnn_emlp_cmax, []), (lib.dgcnn_emlp_kmax, []),
                         (lib.dgcnn_emlp_plan, [i, i, ip, ip])):
            fn.argtypes = args
            fn.restype = i
        if (lib.dgcnn_emlp_ch(), lib.dgcnn_emlp_kc(), lib.dgcnn_emlp_cmax(),
                lib.dgcnn_emlp_kmax()) != (CH, KC, CMAX, KMAX):
            raise RuntimeError("csrc/edge_mlp.cu and edge_mlp_cuda's CH, KC, CMAX or KMAX "
                               "disagree")
        _LIB = lib
    return _LIB
