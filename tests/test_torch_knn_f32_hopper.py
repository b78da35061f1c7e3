"""The exact kNN's Hopper fp32 kernel (``csrc/knn_hopper.cuh``) from the
CPU: its route by shape, its launch counters, its arguments, its key
split and its padded operands.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``;
``kernel_times.py`` row 1 times it beside the sweep). Here the wrapper's launch is stubbed, by the
plain graph of the operands it was handed or by a library that records its
calls, so what surrounds the kernel runs on the CPU.
"""

import contextlib

import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO
from dgcnn_tpu_torch.kernels import knn_cuda as kmod
from dgcnn_tpu_torch.models import model_names
from dgcnn_tpu_torch.ops.knn import top_k_stable
from dgcnn_tpu_torch.train.trainval import Trainval


def _points(seed, b, n, c):
    return np.random.RandomState(seed).randn(b, n, c).astype(np.float32)


@pytest.mark.parametrize("c,k,ceiling,want", [
    (3, 20, False, "hopper"), (4, 20, False, "hopper"), (64, 20, False, "hopper"),
    (64, 1, False, "hopper"), (64, 33, False, "hopper"), (64, 64, False, "hopper"),
    (126, 20, False, "hopper"), (kmod.F32_MAX_C2 - 2, 64, False, "hopper"),
    (kmod.F32_MAX_C2 - 1, 20, False, "sweep"), (178, 20, False, "sweep"),
    (256, 20, False, "sweep"), (1024, 20, False, "sweep"), (64, 65, False, "sweep"),
    (4, 96, False, "sweep"), (4, 20, True, "sweep"), (64, 64, True, "sweep"),
])
def test_f32_kernel_for_routes_by_shape(c, k, ceiling, want):
    """One-pass fp32 builds (k <= KMAX, no ceiling) whose padded width fits
    the Hopper kernel's ring go to it; the passes behind ceilings (k > 64),
    the widths past F32_MAX_C2 and the chunked ones (C + 2 > 180) stay on
    the sweep. The padded and the unpadded width route alike."""
    assert kmod.f32_kernel_for(c + 2, k, ceiling) == want
    assert kmod.f32_kernel_for(-(-(c + 2) // kmod.CPAD) * kmod.CPAD, k, ceiling) == want


def _smem(c2, stages):
    """csrc/knn_hopper.cuh's shared memory of a block: 1 KB of alignment,
    the query rows (128 rows of boxes of 8 channels), the stages' key tiles
    (64 keys each), the warps' staging areas (8 x 4 x 72 floats) and bars
    (8 x 32 words), the barriers."""
    boxes = -(-c2 // 8)
    return (1024 + boxes * 128 * 32 + stages * boxes * 64 * 32 + 8 * (4 * 72 + 32) * 4
            + (2 * stages + 1) * 8)


def test_f32_max_c2_is_the_kernels_shared_memory_limit():
    """F32_MAX_C2 mirrors csrc/knn_hopper.cuh: the widest multiple of 4
    whose query rows and three key stages fit the 232,448 bytes a block may
    use; the C = 64 operands (68 channels) take three stages and the C = 4
    ones (8) six, with two blocks an SM."""
    assert _smem(kmod.F32_MAX_C2, 3) <= 232448 < _smem(kmod.F32_MAX_C2 + kmod.CPAD, 3)
    assert _smem(68, 3) <= 233472 // 2 - 1024 < _smem(68, 4)
    assert _smem(8, 6) <= 233472 // 2 - 1024
    assert kmod.F32_MAX_C2 % kmod.CPAD == 0 and kmod.TB == 64


def _stub_launch(monkeypatch, seen):
    """Route CPU tensors through the wrapper's launch path, with the pass
    replaced by the plain graph of the operands it is handed."""
    def fake_pass(qa, ka, k, ceil, *, raw, kernel):
        seen.append((kernel, qa.shape[-1], k, ceil is not None))
        v, i = top_k_stable(torch.matmul(qa.float(), ka.float().transpose(-1, -2)), k)
        return kmod._finish(i, v, qa.shape[1], ka.shape[1])

    monkeypatch.setattr(kmod, "_launch_pass", fake_pass)
    monkeypatch.setattr(kmod, "knn_plain", lambda xq, xk, k, m, p: kmod._launch(xq, xk, k, m, p))
    for name in ("launches", "launches_f32_hopper", "launches_tc", "launches_tc_sweep"):
        monkeypatch.setattr(kmod, name, 0)


@pytest.mark.parametrize("model", model_names())
def test_registry_models_build_every_f32_graph_on_the_hopper_kernel(monkeypatch, model):
    """Both registry models at full width (6 blocks of 64, k = 20) in fp32:
    the six graph builds of a forward are six launches of the Hopper fp32
    kernel and none of the sweep, on operands padded to 8 and 68
    channels."""
    seen = []
    _stub_launch(monkeypatch, seen)
    cfg = Config(model_name=model, num_class=2, minibatch_size=1, num_point=256)
    assert cfg.edge_filters == (64,) * 6 and cfg.kvalue == 20
    tv = Trainval(cfg, device="cpu", knn_fn=kmod.knn_cuda)
    state = tv.initialize(4, generator=torch.Generator().manual_seed(0))
    io = SyntheticIO(num_events=1, num_point=256, seed=0, variable_length=False)
    io.initialize()
    batch = next(BucketBatcher(io, 1, num_point=256, shuffle=False).epoch())
    with torch.inference_mode():
        tv.model(state.params, state.model_state, torch.tensor(batch.points),
                 torch.tensor(batch.mask))
    assert (kmod.launches, kmod.launches_f32_hopper, kmod.launches_tc) == (6, 6, 0)
    assert seen == [("f32_hopper", 8, 20, False)] + [("f32_hopper", 68, 20, False)] * 5


@pytest.mark.parametrize("c,k,kernel,want", [
    (4, 20, None, ("f32_hopper", 8, 1)), (64, 20, None, ("f32_hopper", 68, 1)),
    (4, 20, "sweep", ("fp32", 6, 1)), (64, 64, "sweep", ("fp32", 66, 1)),
    (4, 100, None, ("fp32", 6, 2)), (200, 20, None, ("fp32", 202, 1)),
])
def test_counters_tell_hopper_from_sweep_builds(monkeypatch, c, k, kernel, want):
    """Every fp32 build counts once in ``launches``; only a build on the
    Hopper kernel counts in ``launches_f32_hopper``: the route's, or the
    sweep's where forced, where k > KMAX (every pass behind a ceiling on
    the sweep) or where the width is past F32_MAX_C2. The Hopper kernel
    gets its operands padded to a multiple of 4 channels, the sweep them
    as built."""
    seen = []
    _stub_launch(monkeypatch, seen)
    x = torch.tensor(_points(c + k, 1, 300, c))
    qa, ka = kmod.build_augmented_operands(x, x, None)
    got = kmod.launch_operands(qa, ka, k, kernel=kernel)
    form, width, passes = want
    assert [s[:2] for s in seen] == [(form, width)] * passes
    assert [s[3] for s in seen] == [False] + [True] * (passes - 1)
    assert (kmod.launches, kmod.launches_f32_hopper) == (1, int(form == "f32_hopper"))
    assert (kmod.launches_tc, kmod.launches_tc_sweep) == (0, 0)
    assert all(t.shape == (1, 300, k) for t in got)


@pytest.mark.parametrize("kernel,k,c,match", [
    ("hopper", 65, 4, "no fp32 kernel 'hopper'"),
    ("hopper", 20, kmod.F32_MAX_C2, "no fp32 kernel 'hopper'"),
    ("tc", 20, 4, "takes precision='default'"),
    ("fp32", 20, 4, "no fp32 kernel 'fp32'"),
])
def test_forced_shapes_the_kernel_refuses_raise(monkeypatch, kernel, k, c, match):
    """A forced Hopper launch of a shape it does not take, the TC kernel's
    name or a name of no fp32 form raises before any launch."""
    seen = []
    _stub_launch(monkeypatch, seen)
    x = torch.tensor(_points(5, 1, 300, c))
    with pytest.raises(ValueError, match=match):
        kmod.launch_operands(*kmod.build_augmented_operands(x, x, None), k, kernel=kernel)
    assert not seen and kmod.launches == 0


class _Lib:
    """A kernel library that records its calls and returns ``err``."""

    def __init__(self, calls, err):
        self.calls, self.err = calls, err

    def __getattr__(self, name):
        def fn(*args):
            self.calls[name] = args
            return self.err
        return fn


def _no_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: type("S", (), {"cuda_stream": 7}))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())


@pytest.mark.parametrize("splits,raw", [(1, False), (2, False), (3, True)])
def test_hopper_launch_hands_the_kernel_its_arguments(monkeypatch, splits, raw):
    """The Hopper pass calls ``dgcnn_knn_topk_f32h`` with the padded f32
    operands, its outputs, the workspace of S > 1 partial lists (S, B, Nq,
    k) or none, the shapes, the padded width, k, S, ``raw`` and the
    stream, and nothing else of the library."""
    calls = {}
    _no_device(monkeypatch)
    monkeypatch.setattr(kmod, "choose_splits", lambda *a, **kw: splits)
    monkeypatch.setattr(kmod, "_lib", lambda: _Lib(calls, 0))
    x = torch.tensor(_points(3, 2, 200, 64))
    qa, ka = kmod.build_augmented_operands(x, x, None, cpad=kmod.CPAD)
    idx, valid, scores = kmod._launch_pass(qa, ka, 20, None, raw=raw, kernel="f32_hopper")
    assert set(calls) == {"dgcnn_knn_topk_f32h"}
    args = calls["dgcnn_knn_topk_f32h"]
    assert args[:5] == (qa.data_ptr(), ka.data_ptr(), idx.data_ptr(), valid.data_ptr(),
                        scores.data_ptr())
    assert (args[5] is None, args[6] is None) == (splits == 1, splits == 1)
    assert args[7:] == (2, 200, 200, 68, 20, splits, int(raw), 7)
    assert idx.shape == valid.shape == scores.shape == (2, 200, 20)


@pytest.mark.parametrize("err", [1, 700])
def test_refused_launch_raises_without_fallback(monkeypatch, err):
    """A launch the library refuses (a CUDA error code) raises; neither
    the plain version nor the sweep runs in its place."""
    calls = {}
    _no_device(monkeypatch)
    monkeypatch.setattr(kmod, "choose_splits", lambda *a, **kw: 1)
    monkeypatch.setattr(kmod, "_lib", lambda: _Lib(calls, err))
    plain = []
    monkeypatch.setattr(kmod, "knn_plain", lambda *a, **kw: plain.append(1))
    x = torch.tensor(_points(4, 1, 100, 4))
    qa, ka = kmod.build_augmented_operands(x, x, None, cpad=kmod.CPAD)
    with pytest.raises(RuntimeError, match=f"CUDA error {err}"):
        kmod._launch_pass(qa, ka, 20, None, raw=False, kernel="f32_hopper")
    assert set(calls) == {"dgcnn_knn_topk_f32h"} and not plain


@pytest.mark.parametrize("b,n,slots,want", [(1, 131072, 264, 1), (4, 4096, 264, 2),
                                            (1, 4096, 264, 8), (1, 300, 264, 5),
                                            (2, 2000, 132, 4)])
def test_choose_splits_asks_the_hopper_kernels_occupancy(monkeypatch, b, n, slots, want):
    """`choose_splits` for the Hopper fp32 kernel asks its own resident
    blocks (``dgcnn_knn_slots_f32h``) and takes `split_count`'s S over
    tiles of 64 keys: S = 1 at the train cell's 1 x 131,072 (no
    workspace), S = 2 at the served 4 x 4096."""
    class Lib:
        def dgcnn_knn_slots_f32h(self, c2, k):
            assert (c2, k) == (68, 20)
            return slots

    monkeypatch.setattr(kmod, "_lib", lambda: Lib())
    monkeypatch.setattr(kmod, "_slots_cache", {})
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    s = kmod.choose_splits(b, n, n, 68, 20, "cuda:0", kernel="f32_hopper")
    assert s == want == kmod.split_count(b * -(-n // kmod.QB), -(-n // kmod.TB), slots)


@pytest.mark.parametrize("c", [3, 4, 5, 64, 126])
def test_padded_operands_keep_the_graph(c):
    """`build_augmented_operands` with ``cpad=4`` gives the unpadded
    operands' channels bit for bit, then zeros up to a multiple of 4, in
    one contiguous tensor; `f32_operand` pads an unpadded operand to the
    same; the plain graph of the padded operands is `knn_plain`'s, index
    for index and score for score, on a ragged mask."""
    b, n, k = 2, 256, 20
    x = torch.tensor(_points(c, b, n, c))
    mask = torch.tensor(np.arange(n)[None] < np.array([[n], [13]]))
    qa, ka = kmod.build_augmented_operands(x, x, mask)
    qp, kp = kmod.build_augmented_operands(x, x, mask, cpad=kmod.CPAD)
    width = -(-(c + 2) // kmod.CPAD) * kmod.CPAD
    for a, p in ((qa, qp), (ka, kp)):
        assert p.shape[-1] == width and p.is_contiguous()
        assert torch.equal(p[..., :c + 2], a) and not bool(p[..., c + 2:].any())
        assert torch.equal(kmod.f32_operand(a), p)
    assert kmod.f32_operand(qp) is qp
    v, i = top_k_stable(torch.matmul(qp, kp.transpose(-1, -2)), k)
    for a, w in zip(kmod._finish(i, v, n, n), kmod.knn_plain(x, x, k, mask)):
        assert torch.equal(a, w)
