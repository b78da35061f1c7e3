"""The ring step's and the banded pass's Hopper tensor-core kernels
(``dgcnn_ring_knn_step_tc``, ``dgcnn_knn_banded_tc``, both on
``csrc/knn_tc.cuh``'s pipeline) from the CPU: their route by shape, the
arguments their wrappers hand them, their launch counters, and a Python
mirror of the banded block's tile sequence and row windows.

The kernels run only on the card (``tests/test_torch_cuda.py``;
``kernel_times.py`` rows 2D and 3D time them beside sweep_tc). Here the wrappers' library is a stub that
records each call, so what surrounds the kernels runs on the CPU.
"""

import contextlib

import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.kernels import knn_banded_cuda as bmod
from dgcnn_tpu_torch.kernels import knn_cuda as kmod
from dgcnn_tpu_torch.kernels import ring_knn_cuda as rmod
from dgcnn_tpu_torch.ops.knn import band_lo

QB, TBK = kmod.QB, kmod.TB_TC


def _c2(c):
    return -(-(c + 2) // kmod.CPAD_TC) * kmod.CPAD_TC


class Lib:
    """A stand-in for a kernel library: every entry records its arguments
    and returns ``err``."""

    def __init__(self, err=0):
        self.err = err
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return self.err
        return fn


@pytest.fixture
def lib(monkeypatch):
    """A recording library behind both wrappers, every counter at 0, and
    the CUDA stream and device contexts as no-ops."""
    stub = Lib()
    monkeypatch.setattr(rmod, "_lib", lambda: stub)
    monkeypatch.setattr(bmod, "_lib", lambda: stub)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    for mod in (rmod, bmod):
        for name in ("launches", "launches_tc", "launches_tc_sweep"):
            monkeypatch.setattr(mod, name, 0)
    return stub


def _operands(seed, b, n, c, precision="default"):
    x = torch.tensor(np.random.RandomState(seed).randn(b, n, c).astype(np.float32))
    return kmod.build_augmented_operands(x, x, None, precision)


def _counts(mod):
    return mod.launches_tc, mod.launches_tc_sweep, mod.launches


@pytest.mark.parametrize("c,k,ceiling,want", [
    (4, 20, False, "tc"), (64, 20, False, "tc"), (64, 64, False, "tc"), (64, 1, False, "tc"),
    (kmod.TC_MAX_C2 - 2, 20, False, "tc"), (64, 20, True, "sweep"), (4, 64, True, "sweep"),
    (kmod.TC_MAX_C2 - 1, 20, False, "sweep"), (1024, 20, False, "sweep"), (64, 65, False, "sweep"),
])
def test_ring_and_banded_launches_route_by_tc_kernel_for(lib, c, k, ceiling, want):
    """One pass without a ceiling at c2 <= TC_MAX_C2 takes the Hopper
    entry; a ceiling (the later passes of k > KMAX) or a wider c2 takes
    sweep_tc's, in both wrappers, as `tc_kernel_for` says."""
    assert kmod.tc_kernel_for(_c2(c), k, ceiling) == want
    if k > kmod.KMAX:
        return  # no single launch takes it: the passes below split it
    qa, ka = _operands(c, 1, 160, c)
    b, n = qa.shape[:2]
    ceil = (torch.zeros(b, n), torch.zeros(b, n, dtype=torch.int32)) if ceiling else None
    topv, topi = rmod.init_running(b, n, k, "cpu")
    rmod.launch_step(qa, ka, 0, topv, topi, ceil, precision="default")
    entry = {"tc": "dgcnn_ring_knn_step_tc", "sweep": "dgcnn_ring_knn_step_bf16"}[want]
    assert lib.calls[-1][0] == entry
    nvalid = torch.full((b,), n, dtype=torch.int32)
    ceil_b = ceil and (ceil[0], ceil[1])
    bmod._launch_pass(kmod.tc_operand(qa), kmod.tc_operand(ka), nvalid, k, ceil_b, raw=ceiling,
                      kernel=kmod.resolve_tc_kernel(_c2(c), k, ceiling), window=64, q_base=0,
                      key_base=0)
    entry = {"tc": "dgcnn_knn_banded_tc", "sweep": "dgcnn_knn_banded_bf16"}[want]
    assert lib.calls[-1][0] == entry


def test_ring_hopper_launch_hands_the_kernel_its_arguments(lib):
    """The Hopper ring step gets the bf16 operands, the running lists in
    place, the padded width, k and the global base, and no ceiling."""
    qa, ka = _operands(1, 2, 200, 64)
    topv, topi = rmod.init_running(2, 200, 20, "cpu")
    rmod.launch_step(qa, ka, 600, topv, topi, precision="default")
    name, args = lib.calls[-1]
    assert name == "dgcnn_ring_knn_step_tc"
    assert args[2:4] == (topv.data_ptr(), topi.data_ptr())
    assert args[4:10] == (2, 200, 200, 80, 20, 600)
    assert _counts(rmod) == (1, 0, 0)


def test_banded_hopper_launch_hands_the_kernel_its_arguments(lib):
    """The Hopper banded pass gets the bf16 operands, nvalid, the outputs,
    the band (window, q_base, key_base) and raw, and no ceiling."""
    qa, ka = _operands(2, 2, 300, 64)
    qa = qa[:, 40:140].contiguous()
    nvalid = torch.tensor([300, 200], dtype=torch.int32)
    out = bmod.launch_operands(qa, ka, nvalid, 20, window=64, q_base=40, key_base=0,
                               precision="default")
    name, args = lib.calls[-1]
    assert name == "dgcnn_knn_banded_tc"
    assert args[2] == nvalid.data_ptr()
    assert args[3:6] == tuple(t.data_ptr() for t in out)
    assert args[6:15] == (2, 100, 300, 80, 20, 64, 40, 0, 0)
    assert _counts(bmod) == (1, 0, 0)


def test_counters_tell_the_forms_apart(lib):
    """Ring: one count a launch, by the kernel it took; a graph of k >
    KMAX takes the Hopper kernel for pass 0 and sweep_tc for the passes
    behind ceilings. Banded: one count a graph build in each form it
    launched. A forced form goes where it is sent; fp32 counts apart."""
    p, nl, k = 4, 128, 96
    qa, ka = _operands(3, 1, p * nl, 16)
    blocks = [(ka[:, o * nl:(o + 1) * nl].contiguous(), o * nl) for o in range(p)]
    step = lambda *a: rmod.launch_step(*a, precision="default")  # noqa: E731
    rmod.merge_blocks(qa[:, :nl].contiguous(), blocks, 20, 0, step)
    assert _counts(rmod) == (p, 0, 0)
    rmod.merge_blocks(qa[:, :nl].contiguous(), blocks, k, 0, step)
    assert _counts(rmod) == (2 * p, p, 0)
    forced = lambda *a: rmod.launch_step(*a, precision="default", kernel="sweep")  # noqa: E731
    rmod.merge_blocks(qa[:, :nl].contiguous(), blocks, 20, 0, forced)
    f32 = _operands(3, 1, p * nl, 16, "highest")
    rmod.merge_blocks(f32[0][:, :nl].contiguous(), [(f32[1][:, :nl].contiguous(), 0)], 20, 0,
                      rmod.launch_step)
    assert _counts(rmod) == (2 * p, 2 * p, 1)

    nvalid = torch.tensor([p * nl], dtype=torch.int32)
    band = dict(window=256, precision="default")
    bmod.launch_operands(qa, ka, nvalid, 20, **band)
    bmod.launch_operands(qa, ka, nvalid, k, **band)
    bmod.launch_operands(qa, ka, nvalid, 20, kernel="sweep", **band)
    bmod.launch_operands(*f32, nvalid, 20, window=256)
    assert _counts(bmod) == (2, 2, 1)
    names = [c[0] for c in lib.calls if "banded" in c[0]]
    assert names == ["dgcnn_knn_banded_tc", "dgcnn_knn_banded_tc", "dgcnn_knn_banded_bf16",
                     "dgcnn_knn_banded_bf16", "dgcnn_knn_banded_f32"]


def test_refused_launches_raise(lib, monkeypatch):
    """A forced Hopper launch of a shape it does not take, or a misaligned
    operand, raises before any launch; a launch the library refuses raises
    (no fallback to sweep_tc or to the plain version)."""
    wide_q, wide_k = _operands(4, 1, 100, kmod.TC_MAX_C2)
    topv, topi = rmod.init_running(1, 100, 20, "cpu")
    nvalid = torch.tensor([100], dtype=torch.int32)
    with pytest.raises(ValueError, match="no TC kernel"):
        rmod.launch_step(wide_q, wide_k, 0, topv, topi, precision="default", kernel="tc")
    with pytest.raises(ValueError, match="no TC kernel"):
        bmod.launch_operands(wide_q, wide_k, nvalid, 20, window=64, precision="default",
                             kernel="tc")
    with pytest.raises(ValueError, match="no TC kernel"):
        bmod.launch_operands(*_operands(4, 1, 100, 4), nvalid, 65, window=100,
                             precision="default", kernel="tc")
    qa, ka = (kmod.tc_operand(t) for t in _operands(5, 1, 100, 4))
    flat = torch.zeros(qa.numel() + 1, dtype=torch.bfloat16)
    flat[1:] = qa.flatten()
    skewed = flat[1:].view(qa.shape)  # 2 bytes past an aligned address
    assert skewed.is_contiguous() and skewed.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        rmod.launch_step(skewed, ka, 0, topv, topi, precision="default")
    with pytest.raises(ValueError, match="16-byte aligned"):
        bmod.launch_operands(skewed, ka, nvalid, 20, window=64, precision="default")
    assert lib.calls == []
    lib.err = 1
    plain = []
    monkeypatch.setattr(rmod, "step_plain", lambda *a, **kw: plain.append(1))
    monkeypatch.setattr(bmod, "knn_banded_plain", lambda *a, **kw: plain.append(1))
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        rmod.launch_step(qa, ka, 0, topv, topi, precision="default")
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        bmod.launch_operands(qa, ka, nvalid, 20, window=64, precision="default")
    assert not plain and [c[0] for c in lib.calls] == ["dgcnn_ring_knn_step_tc",
                                                       "dgcnn_knn_banded_tc"]


# ---- a Python mirror of csrc/knn_banded.cu's Band, outward order and row
# windows, and of csrc/knn_tc.cuh's per-tile columns [a, e)


def _outward(m, diag, ntiles):
    below, above = diag, ntiles - 1 - diag
    both = 2 * min(below, above)
    if m <= both:
        return diag - (m + 1) // 2 if m & 1 else diag + m // 2
    d = min(below, above) + (m - both)
    return diag - d if below > above else diag + d


def _band_lo(pos, nv, w):
    return int(band_lo(torch.tensor(pos), torch.tensor(nv), w))


def _block_offers(q0, nq, nk, nv, w, q_base, key_base):
    """{block row: sorted key-local keys the Hopper sweep offers it}, each
    key as many times as it is offered."""
    last = min(q0 + QB, nq) - 1
    t_begin = min(max(_band_lo(q_base + q0, nv, w) - key_base, 0), nk)
    t_end = min(max(_band_lo(q_base + last, nv, w) + w - key_base, 0), nk)
    ntiles = -(-(t_end - t_begin) // TBK)
    mid = min(max(q_base + q0 + QB // 2 - key_base, t_begin), t_end - 1)
    diag = (mid - t_begin) // TBK if ntiles > 0 else 0
    order = [_outward(m, diag, ntiles) for m in range(ntiles)]
    assert sorted(order) == list(range(ntiles))  # each tile once
    out = {}
    for row in range(QB):
        if q0 + row >= nq:
            continue
        lo = _band_lo(q_base + q0 + row, nv, w) - key_base
        hi = min(lo + w, t_end)
        keys = []
        for j in order:
            t0 = t_begin + TBK * j
            a, e = min(max(lo - t0, 0), TBK), min(max(hi - t0, 0), TBK)
            keys += [t0 + col for col in range(a, e)]
        out[row] = sorted(keys)
    return out


@pytest.mark.parametrize("n,nv,w,q_base,key_base,nk", [
    (1000, 1000, 256, 0, 0, 1000),      # self form, whole event valid
    (1000, 617, 256, 0, 0, 1000),       # ragged: padded tail
    (1000, 617, 4096, 0, 0, 1000),      # W >= N
    (300, 90, 64, 0, 0, 300),           # fewer valid than a window, rows past nv
    (1000, 1000, 200, 300, 100, 600),   # cross form: halo keys [100, 700)
    (1000, 850, 256, 256, 0, 1000),     # cross form, q_base only
    (1000, 700, 100, 500, 430, 280),    # cross form past the valid points
])
def test_banded_tiles_cover_every_in_band_key_once(n, nv, w, q_base, key_base, nk):
    """Every query row's in-band keys inside the key array, ``[band_lo,
    band_lo + W)`` (`ops.knn.band_lo`) shifted by key_base and clipped to
    [0, nk), are offered to it exactly once by its block's tile sequence
    (``t_begin + 64 outward(m)``, need not be a multiple of 64) and its
    window's columns of each tile, and no other key is."""
    nq = min(n - q_base, 3 * QB + 17)
    for q0 in range(0, nq, QB):
        offers = _block_offers(q0, nq, nk, nv, w, q_base, key_base)
        for row, keys in offers.items():
            lo = _band_lo(q_base + q0 + row, nv, w)
            want = [g - key_base for g in range(lo, lo + w) if 0 <= g - key_base < nk]
            assert keys == want, (q0, row)
