"""The exact kNN's Hopper tensor-core kernel (``csrc/knn_tc.cuh``) from the
CPU: its route by shape, its launch counters, its key split, and the
padding of its operands against the JAX package's Pallas body.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``;
``kernel_times.py`` row 1D times it beside sweep_tc). Here the wrapper's launch is stubbed by the
plain graph of the operands it was handed, so what surrounds the kernel
(routing, counting, the split, the operand form) runs on the CPU.
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO
from dgcnn_tpu_torch.kernels import knn_cuda as kmod
from dgcnn_tpu_torch.models import model_names
from dgcnn_tpu_torch.ops.knn import score_order_violations, split_score_mismatches, top_k_stable
from dgcnn_tpu_torch.train.trainval import Trainval

KP = importlib.import_module("dgcnn_tpu.kernels.knn_pallas")


def _points(seed, b, n, c):
    return np.random.RandomState(seed).randn(b, n, c).astype(np.float32)


def _c2(c):
    """The padded width the TC kernels get for C features (C + 2 augmented
    channels, padded to a multiple of 16)."""
    return -(-(c + 2) // kmod.CPAD_TC) * kmod.CPAD_TC


@pytest.mark.parametrize("c,k,want", [
    (3, 20, "tc"), (4, 20, "tc"), (64, 20, "tc"), (64, 1, "tc"), (64, 64, "tc"),
    (126, 20, "tc"), (256, 20, "tc"), (kmod.TC_MAX_C2 - 2, 64, "tc"),
    (kmod.TC_MAX_C2 - 1, 20, "sweep"), (1024, 20, "sweep"), (64, 65, "sweep"), (4, 96, "sweep"),
])
def test_tc_kernel_for_routes_by_shape(c, k, want):
    """One-pass widths up to TC_MAX_C2 with k <= KMAX go to the Hopper
    kernel; wider operands and the k of several passes to sweep_tc; a pass
    behind a ceiling never to the Hopper kernel. TC_MAX_C2 is sweep_tc's
    widest one-pass width too: the chunked widths are the sweep's."""
    assert kmod.tc_kernel_for(_c2(c), k) == want
    assert kmod.tc_kernel_for(_c2(c), min(k, kmod.KMAX), ceiling=True) == "sweep"


def test_tc_max_c2_is_the_kernels_shared_memory_limit():
    """TC_MAX_C2 mirrors csrc/knn_tc.cuh: the widest multiple of 16 whose
    query rows (128 x c2 bf16), two key stages (TB_TC keys each) and the
    warps' staging areas (8 x 16 x (TB_TC + 8) floats) with the barriers
    and 1 KB of alignment fit the 232,448 bytes a block may use; it is
    also the widest width sweep_tc takes in one pass (its query rows and two
    64-key tiles of c2 + 8 bf16, a 128 x 68 float score tile, bars and
    flags)."""
    def smem(c2, stages):
        return (1024 + 128 * c2 * 2 + stages * kmod.TB_TC * c2 * 2
                + 8 * 16 * (kmod.TB_TC + 8) * 4 + (2 * stages + 1) * 8)

    def sweep_one_pass(c2):
        return (128 + 2 * 64) * (c2 + 8) * 2 + (128 * 68 + 3 * 128) * 4

    assert smem(kmod.TC_MAX_C2, 2) <= 232448 < smem(kmod.TC_MAX_C2 + 16, 2)
    assert sweep_one_pass(kmod.TC_MAX_C2) <= 232448 < sweep_one_pass(kmod.TC_MAX_C2 + 16)
    assert kmod.TC_MAX_C2 % kmod.CPAD_TC == 0 and kmod.TB_TC == 64


def _stub_launch(monkeypatch, seen):
    """Route CPU tensors through the wrapper's launch path (the operator
    ``dgcnn_tpu_torch::knn`` runs `knn_plain` on the CPU), with the pass
    itself replaced by the plain graph of the operands it is handed."""
    def fake_pass(qa, ka, k, ceil, *, raw, kernel):
        seen.append((kernel, qa.shape[-1], k, qa.dtype))
        v, i = top_k_stable(torch.matmul(qa.float(), ka.float().transpose(-1, -2)), k)
        return kmod._finish(i, v, qa.shape[1], ka.shape[1])

    monkeypatch.setattr(kmod, "_launch_pass", fake_pass)
    monkeypatch.setattr(kmod, "knn_plain", lambda xq, xk, k, m, p: kmod._launch(xq, xk, k, m, p))
    for name in ("launches", "launches_tc", "launches_tc_sweep"):
        monkeypatch.setattr(kmod, name, 0)


@pytest.mark.parametrize("model", model_names())
def test_registry_models_build_every_graph_on_the_hopper_kernel(monkeypatch, model):
    """Both registry models at full width (6 blocks of 64, k = 20) on
    --precision bfloat16 --knn_precision default: the six graph builds of a
    forward are six launches of the Hopper kernel, none of sweep_tc and
    none of the fp32 kernel, on bf16 operands of 16 and 80 channels."""
    seen = []
    _stub_launch(monkeypatch, seen)
    cfg = Config(model_name=model, num_class=2, minibatch_size=1, num_point=256,
                 precision="bfloat16", knn_precision="default")
    assert cfg.edge_filters == (64,) * 6 and cfg.kvalue == 20
    fn = lambda x, k, m: kmod.knn_cuda(x, k, m, precision="default")  # noqa: E731
    tv = Trainval(cfg, device="cpu", knn_fn=fn)
    state = tv.initialize(4, generator=torch.Generator().manual_seed(0))
    io = SyntheticIO(num_events=1, num_point=256, seed=0, variable_length=False)
    io.initialize()
    batch = next(BucketBatcher(io, 1, num_point=256, shuffle=False).epoch())
    with torch.inference_mode():
        tv.model(state.params, state.model_state, torch.tensor(batch.points),
                 torch.tensor(batch.mask))
    assert (kmod.launches_tc, kmod.launches_tc_sweep, kmod.launches) == (6, 0, 0)
    assert [s[:3] for s in seen] == [("tc", 16, 20)] + [("tc", 80, 20)] * 5
    assert {s[3] for s in seen} == {torch.bfloat16}


def test_counters_tell_the_three_kernels_apart(monkeypatch):
    """A one-pass TC build counts in ``launches_tc``, a build of k > KMAX
    (every pass on sweep_tc) or past TC_MAX_C2 in ``launches_tc_sweep``, an
    fp32 build in ``launches``; a forced form goes where it is sent, and a
    forced Hopper launch of a shape it does not take raises before any
    launch. (The fp32 build of C = 4, k = 20 runs on the Hopper fp32
    kernel, `f32_kernel_for`.)"""
    seen = []
    _stub_launch(monkeypatch, seen)
    x = torch.tensor(_points(1, 1, 300, 4))
    qa, ka = kmod.build_augmented_operands(x, x, None, "default")
    kmod.launch_operands(qa, ka, 20, "default")
    kmod.launch_operands(qa, ka, 100, "default")
    kmod.launch_operands(qa, ka, 20, "default", kernel="sweep")
    wide = torch.tensor(_points(2, 1, 300, kmod.TC_MAX_C2))
    kmod.knn_cuda(wide, 8, None, precision="default")
    kmod.launch_operands(*kmod.build_augmented_operands(x, x, None), 20)
    assert (kmod.launches_tc, kmod.launches_tc_sweep, kmod.launches) == (1, 3, 1)
    assert [s[0] for s in seen] == ["tc", "sweep", "sweep", "sweep", "sweep", "f32_hopper"]
    n = len(seen)
    with pytest.raises(ValueError, match="no TC kernel"):
        kmod.launch_operands(qa, ka, 100, "default", kernel="tc")
    with pytest.raises(ValueError, match="takes precision='default'"):
        kmod.launch_operands(*kmod.build_augmented_operands(x, x, None), 20, kernel="tc")
    assert len(seen) == n


def test_hopper_launch_hands_the_kernel_its_arguments(monkeypatch):
    """The Hopper pass calls ``dgcnn_knn_topk_tc`` with the bf16 operands,
    the padded width and no ceiling; a refused launch raises (no fallback
    to the plain version or to sweep_tc)."""
    calls = {}

    class Lib:
        def __init__(self, err):
            self.err = err

        def __getattr__(self, name):
            def fn(*args):
                calls[name] = args
                return self.err
            return fn

    monkeypatch.setattr(kmod, "choose_splits", lambda *a, **kw: 1)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    x = torch.tensor(_points(3, 2, 200, 64))
    qa, ka = (kmod.tc_operand(t) for t in kmod.build_augmented_operands(x, x, None, "default"))
    monkeypatch.setattr(kmod, "_lib", lambda: Lib(0))
    kmod._launch_pass(qa, ka, 20, None, raw=False, kernel="tc")
    assert set(calls) == {"dgcnn_knn_topk_tc"}
    args = calls["dgcnn_knn_topk_tc"]
    assert args[0] == qa.data_ptr() and args[7:14] == (2, 200, 200, 80, 20, 1, 0)
    monkeypatch.setattr(kmod, "_lib", lambda: Lib(1))
    plain = []
    monkeypatch.setattr(kmod, "knn_plain", lambda *a, **kw: plain.append(1))
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        kmod._launch_pass(qa, ka, 20, None, raw=False, kernel="tc")
    assert not plain


@pytest.mark.parametrize("b,n,slots", [(1, 131072, 132), (4, 4096, 132), (1, 4096, 132),
                                       (1, 300, 132), (2, 2000, 264)])
def test_choose_splits_counts_the_hopper_kernels_tiles(monkeypatch, b, n, slots):
    """`choose_splits` for the Hopper kernel asks its own occupancy and
    counts tiles of TB_TC = 64 keys: a valid S (at most MAX_SPLITS and the
    tiles), `split_count_idle`'s choice: 1 for a grid of a wave or more (a
    split refills every list), more only up to two blocks an SM."""
    class Lib:
        def dgcnn_knn_slots_tc(self, c2, k):
            assert (c2, k) == (80, 20)
            return slots

    monkeypatch.setattr(kmod, "_lib", lambda: Lib())
    monkeypatch.setattr(kmod, "_slots_cache", {})
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    s = kmod.choose_splits(b, n, n, 80, 20, "cuda:0", kernel="tc")
    tiles = -(-n // kmod.TB_TC)
    assert 1 <= s <= min(kmod.MAX_SPLITS, tiles)
    blocks = b * -(-n // kmod.QB)
    assert s == kmod.split_count_idle(blocks, tiles, slots)
    assert s == 1 if blocks >= slots else s > 1
    assert blocks * s <= 2 * slots or s == 1
    if n == 300:  # 5 tiles of 64 keys, 3 query blocks
        assert s == 5
    with pytest.raises(ValueError, match="kernel must be one of"):
        kmod.choose_splits(b, n, n, 80, 20, "cuda:0", kernel="bf16")


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_split_partial_lists_merge_to_the_graph(splits):
    """The Hopper kernel's key split: split s takes tiles [s T / S, (s + 1)
    T / S) of T = ceil(N / 64) tiles, writes its lists to (S, B, Nq, k)
    with global key indices, and the merge (`merge_lists_plain`, the plain
    version of csrc/knn.cu's merge kernel) gives `knn_plain`'s graph of
    the rounded operands, index for index."""
    b, n, k = 2, 1000, 20
    x = torch.tensor(_points(4, b, n, 8))
    mask = torch.tensor(np.arange(n)[None] < np.array([[n], [13]]))
    qa, ka = kmod.build_augmented_operands(x, x, mask, "default")
    s = torch.matmul(qa, ka.transpose(-1, -2))
    tiles = -(-n // kmod.TB_TC)
    pv, pi = [], []
    for sp in range(splits):
        lo = sp * tiles // splits * kmod.TB_TC
        hi = min((sp + 1) * tiles // splits * kmod.TB_TC, n)
        v, i = top_k_stable(s[..., lo:hi], k)
        pv.append(v)
        pi.append(i + lo)
    got = kmod.merge_lists_plain(torch.stack(pv), torch.stack(pi), k, n)
    want = kmod.knn_plain(x, x, k, mask, "default")
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.parametrize("c,k", [(4, 20), (64, 20), (126, 33)])
def test_padded_operands_keep_the_pallas_default_graph(monkeypatch, c, k):
    """The Hopper kernel's operands are `tc_operand`'s: bf16, channels
    padded with zeros to a multiple of 16 (its TMA boxes are 16 channels
    wide and take no more). Those zeros change no score: the plain graph of
    the padded operands is `knn_plain`'s of the unpadded ones, index for
    index and score for score, and it is the JAX package's Pallas body's
    (interpret mode, ``Precision.DEFAULT``, on the same bf16-rounded
    operands)."""
    def rounded(build):
        def rounded_build(*args, **kwargs):
            qa, ka, *rest = build(*args, **kwargs)
            r = lambda t: t.astype(jnp.bfloat16).astype(jnp.float32)  # noqa: E731
            return (r(qa), r(ka), *rest)
        return rounded_build

    monkeypatch.setattr(KP, "build_augmented_operands", rounded(KP.build_augmented_operands))
    b, n = 2, 256
    x = _points(c + k, b, n, c)
    mask = np.arange(n)[None] < np.array([[n], [150]])
    xt, mt = torch.tensor(x), torch.tensor(mask)
    qa, ka = kmod.build_augmented_operands(xt, xt, mt, "default")
    qp, kp = kmod.tc_operand(qa), kmod.tc_operand(ka)
    assert qp.shape[-1] == _c2(c) and not bool(qp[..., c + 2:].any())
    v, i = top_k_stable(torch.matmul(qp.float(), kp.float().transpose(-1, -2)), k)
    padded = kmod._finish(i, v, n, n)
    plain = kmod.knn_plain(xt, xt, k, mt, "default")
    for a, w in zip(padded, plain):
        assert torch.equal(a, w)
    idx, valid, vals = KP._knn_pallas_call.__wrapped__(
        jnp.asarray(x), jnp.asarray(x), jnp.asarray(mask), k=k, block_q=128, block_t=256,
        interpret=True, precision=jax.lax.Precision.DEFAULT)
    wi, wv = np.asarray(idx), np.asarray(valid)
    np.testing.assert_array_equal(padded[1].numpy(), wv)
    hard, near = split_score_mismatches(qa.numpy(), ka.numpy(), padded[0].numpy(), wi,
                                        padded[1].numpy(), wv, rtol=1e-5)
    assert hard == 0, f"{hard} hard mismatches ({near} near ties)"
    assert score_order_violations(padded[2].numpy(), padded[0].numpy(), padded[1].numpy()) == 0
    assert score_order_violations(np.asarray(vals), wi, wv) == 0
