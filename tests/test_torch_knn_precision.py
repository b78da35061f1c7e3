"""``--knn_precision default`` in the port's graph builds, against the
Pallas kernels' own bodies on the CPU.

``Precision.DEFAULT`` is one bf16 pass of the MXU: the augmented operands
rounded to bf16, their products exact in fp32, the sums fp32. XLA:CPU
computes ``DEFAULT`` in f32, so the JAX package cannot give that graph on
the CPU by itself. The oracle is therefore the Pallas kernel bodies in
interpret mode, wired as their ``pallas_call`` wrappers wire them
(`_knn_pallas_call`, `_banded_pallas_call`, run un-jitted), with the JAX
`build_augmented_operands` rounded to bf16 for the call (a monkeypatch of
the module attribute, restored after each test): exact, banded, and a
ring of steps against the exact form. The port's plain versions take the
same rounded operands (`kernels.knn_cuda.build_augmented_operands` with
``precision="default"``) through an fp32 matmul.

The two sides sum the same exact products in different orders, so a
score may differ in its last bits and a near tie of the ROUNDED score may
order the other way. The gate is the port's own rule for that
(`ops.knn.split_score_mismatches`): 0 slots where the two pick keys whose
float64 rounded scores differ by more than ``RTOL`` = 1e-5 of the score's
sum of absolute terms (fp32 summation of at most C + 2 terms: ~1e-6), 0
adjacent slots out of the (score desc, index asc) order of each side's
own scores, and identical ``valid``. The unrounded scores differ from the
rounded ones by ~1e-3 of that scale, so the fp32 graph fails this gate
(`test_the_gate_tells_the_two_precisions_apart`). The CUDA tensor-core
kernels are held against these plain versions on the card
(`tests/test_torch_cuda.py`).
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.kernels import knn_banded_cuda as bmod
from dgcnn_tpu_torch.kernels import knn_cuda as kmod
from dgcnn_tpu_torch.kernels import ring_knn_cuda as rmod
from dgcnn_tpu_torch.models.dgcnn import default_knn_fn
from dgcnn_tpu_torch.ops.knn import (
    banded_knn_indices,
    knn_indices,
    score_order_violations,
    split_score_mismatches,
)
from dgcnn_tpu_torch.train.trainval import knn_fn_for

KP = importlib.import_module("dgcnn_tpu.kernels.knn_pallas")
KB = importlib.import_module("dgcnn_tpu.kernels.knn_banded")
RTOL = 1e-5


def _points(seed, b, n, c, dup_rows=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, c).astype(np.float32)
    for e in range(b):
        src = rng.choice(n, dup_rows, replace=False)
        dst = rng.choice(n, dup_rows, replace=False)
        x[e, dst] = x[e, src]
    return x


def _mask(n, nvalid):
    return np.arange(n)[None, :] < np.asarray(nvalid)[:, None]


CASES = {
    "unmasked": dict(b=2, n=256, c=3, k=8, nvalid=None),
    "ragged": dict(b=3, n=256, c=16, k=20, nvalid=(256, 150, 5)),
    "wide": dict(b=2, n=384, c=64, k=20, nvalid=(384, 200)),
    "lattice": dict(b=1, n=256, c=3, k=16, nvalid=None),
}


def _case(name, seed=0):
    cfg = CASES[name]
    if name == "lattice":
        # integer points: many exact score ties, only the index rule orders them
        x = np.random.RandomState(seed).randint(0, 4, (1, cfg["n"], 3)).astype(np.float32)
    else:
        x = _points(seed, cfg["b"], cfg["n"], cfg["c"])
    mask = None if cfg["nvalid"] is None else _mask(cfg["n"], cfg["nvalid"])
    return x, mask, cfg["k"]


def _rounded(build):
    def rounded_build(*args, **kwargs):
        qa, ka, *rest = build(*args, **kwargs)
        r = lambda t: t.astype(jnp.bfloat16).astype(jnp.float32)  # noqa: E731
        return (r(qa), r(ka), *rest)

    return rounded_build


@pytest.fixture
def pallas_default(monkeypatch):
    """The Pallas kernels' DEFAULT graph builds: ``exact(xq, xk, k, mask)``
    and ``banded(xq, xk, k, mask, window, q_base, key_base, nvalid)``,
    each ``(idx, valid, scores)`` as numpy."""
    monkeypatch.setattr(KP, "build_augmented_operands", _rounded(KP.build_augmented_operands))
    monkeypatch.setattr(KB, "build_augmented_operands", _rounded(KB.build_augmented_operands))
    up = lambda v, m: -(-v // m) * m  # noqa: E731
    default = jax.lax.Precision.DEFAULT

    def exact(xq, xk, k, mask=None):
        idx, valid, vals = KP._knn_pallas_call.__wrapped__(
            jnp.asarray(xq), jnp.asarray(xk), None if mask is None else jnp.asarray(mask), k=k,
            block_q=min(256, up(xq.shape[1], 128)), block_t=min(1024, up(xk.shape[1], 128)),
            interpret=True, precision=default)
        return np.asarray(idx), np.asarray(valid), np.asarray(vals)

    def banded(xq, xk, k, mask, *, window, q_base, key_base, nvalid):
        block_t = min(1024, up(xk.shape[1], 128))
        idx, valid = KB._banded_pallas_call.__wrapped__(
            jnp.asarray(xq), jnp.asarray(xk), None if mask is None else jnp.asarray(mask),
            jnp.asarray(nvalid, jnp.int32), jnp.asarray([q_base, key_base], jnp.int32), k=k,
            window=window, block_q=min(256, up(xq.shape[1], 128)), block_t=block_t,
            interpret=True, precision=default,
            merge_chunk=KB._resolve_merge_chunk(None, block_t), tile_order=KB.TILE_ORDER_DEFAULT)
        return np.asarray(idx), np.asarray(valid)

    return exact, banded


def _assert_same_graph(qa, ka, got, want, key_offset=0):
    """``got`` the port's ``(idx, valid, scores)``, ``want`` the other
    side's ``(idx, valid[, scores])``: identical valid, no hard mismatch by
    the rounded scores, both lists in (score desc, index asc) order."""
    gi, gv, gs = (np.asarray(t) for t in got)
    wi, wv = np.asarray(want[0]), np.asarray(want[1])
    np.testing.assert_array_equal(gv, wv)
    hard, near = split_score_mismatches(qa, ka, gi, wi, gv, wv, rtol=RTOL, key_offset=key_offset)
    assert hard == 0, f"{hard} hard mismatches ({near} near ties)"
    assert score_order_violations(gs, gi, gv) == 0
    if len(want) > 2:
        assert score_order_violations(want[2], wi, wv) == 0


def test_default_operands_are_the_bf16_rounded_ones():
    x, mask, _ = _case("ragged")
    xt, mt = torch.tensor(x), torch.tensor(mask)
    qa, ka = kmod.build_augmented_operands(xt, xt, mt, "highest")
    qd, kd = kmod.build_augmented_operands(xt, xt, mt, "default")
    assert qd.dtype == kd.dtype == torch.float32
    # round to nearest even, in this one place
    assert torch.equal(qd, qa.to(torch.bfloat16).float())
    assert torch.equal(kd, ka.to(torch.bfloat16).float())
    # a masked key still scores below -1e29 after rounding
    masked = torch.matmul(qd, kd.transpose(-1, -2))[~mt[:, None, :].expand(-1, x.shape[1], -1)]
    assert float(masked.max()) <= kmod.INVALID_BELOW
    # the TC kernels' form: bf16, channels padded to 16 with zeros, exact
    t = kmod.tc_operand(kd)
    assert t.dtype == torch.bfloat16 and t.shape[-1] == 32 and t.is_contiguous()
    assert torch.equal(t[..., :18].float(), kd) and not bool(t[..., 18:].any())
    assert kmod.tc_operand(t) is t
    with pytest.raises(ValueError, match="knn precision"):
        kmod.build_augmented_operands(xt, xt, mt, "bf16")


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_default_matches_the_pallas_body(pallas_default, name):
    exact, _ = pallas_default
    x, mask, k = _case(name)
    xt = torch.tensor(x)
    mt = None if mask is None else torch.tensor(mask)
    qa, ka = kmod.build_augmented_operands(xt, xt, mt, "default")
    got = kmod.knn_plain(xt, xt, k, mt, "default")
    _assert_same_graph(qa, ka, got, exact(x, x, k, mask))
    # the CPU wrapper is the plain version
    for a, b in zip(kmod.knn_cuda(xt, k, mt, return_scores=True, precision="default"), got):
        assert torch.equal(a, b)


def test_plain_default_cross_form_matches_the_pallas_body(pallas_default):
    exact, _ = pallas_default
    x, mask, k = _case("ragged", seed=3)
    xq = x[:, 40:200]
    xt, xqt, mt = torch.tensor(x), torch.tensor(xq), torch.tensor(mask)
    qa, ka = kmod.build_augmented_operands(xqt, xt, mt, "default")
    got = kmod.knn_cuda_cross(xqt, xt, k, mt, precision="default")
    _assert_same_graph(qa, ka, got, exact(xq, x, k, mask))


@pytest.mark.parametrize("k", [65, 96, 130])
def test_passes_plain_default_past_64(pallas_default, k):
    """k > 64 runs in passes behind each row's ceiling: the same graph as
    one top-k of the same rounded scores (the scores are the same matmul's,
    so index for index), and the Pallas body's."""
    exact, _ = pallas_default
    x, mask = _points(5, 2, 256, 8), _mask(256, (256, 170))
    xt, mt = torch.tensor(x), torch.tensor(mask)
    one = kmod.knn_plain(xt, xt, k, mt, "default")
    passes = kmod.knn_passes_plain(xt, xt, k, mt, precision="default")
    for a, b in zip(passes, one):
        assert torch.equal(a, b)
    qa, ka = kmod.build_augmented_operands(xt, xt, mt, "default")
    _assert_same_graph(qa, ka, passes, exact(x, x, k, mask))


@pytest.mark.parametrize("window", [64, 200, 512])
def test_banded_plain_default_matches_the_pallas_body(pallas_default, window):
    _, banded = pallas_default
    x, mask = _points(7, 2, 512, 6), _mask(512, (512, 300))
    xt, mt = torch.tensor(x), torch.tensor(mask)
    nvalid = mask.sum(-1)
    got = bmod.knn_banded_plain(xt, xt, 16, mt, window=window, precision="default")
    qa, ka = kmod.build_augmented_operands(xt, xt, mt, "default")
    _assert_same_graph(qa, ka, got, banded(x, x, 16, mask, window=window, q_base=0, key_base=0,
                                           nvalid=nvalid))
    # the banded graph with the window past the event is the exact graph
    if window >= 512:
        full = kmod.knn_plain(xt, xt, 16, mt, "default")
        assert torch.equal(got[0], full[0]) and torch.equal(got[2], full[2])


def test_banded_plain_default_cross_form_matches_the_pallas_body(pallas_default):
    """The halo-CP form: queries at offset positions against an extended
    key array."""
    _, banded = pallas_default
    x, mask = _points(9, 2, 512, 6), _mask(512, (512, 400))
    nvalid = mask.sum(-1)
    q0, q1, kb, ke, w = 128, 256, 64, 320, 64
    xq, xk, mk = x[:, q0:q1], x[:, kb:ke], mask[:, kb:ke]
    got = bmod.knn_banded_cuda_cross(torch.tensor(xq), torch.tensor(xk), 16, torch.tensor(mk),
                                     window=w, q_base=q0, key_base=kb,
                                     nvalid=torch.tensor(nvalid), precision="default")
    qa, ka = kmod.build_augmented_operands(torch.tensor(xq), torch.tensor(xk), torch.tensor(mk),
                                           "default")
    want = banded(xq, xk, 16, mk, window=w, q_base=q0, key_base=kb, nvalid=nvalid)
    _assert_same_graph(qa, ka, got, want, key_offset=kb)


@pytest.mark.parametrize("k", [20, 80])
def test_ring_steps_default_match_the_pallas_body(pallas_default, k):
    """A ring of `step_plain` merges over 4 virtual owners, each rank's
    key blocks in the order it sees them, on the rounded operands: every
    rank's graph is the Pallas body's over the whole event (its cross
    form), and equals the plain exact graph of the same rounded scores."""
    exact, _ = pallas_default
    p, nl = 4, 96
    x = _points(11, 2, p * nl, 5)
    mask = np.ones((2, p * nl), bool)
    mask[1, 2 * nl:] = False
    mask[1, :3] = True
    xt, mt = torch.tensor(x), torch.tensor(mask)
    qa, ka = kmod.build_augmented_operands(xt, xt, mt, "default")
    for me in range(p):
        rows = slice(me * nl, (me + 1) * nl)
        blocks = [(ka[:, o * nl:(o + 1) * nl].contiguous(), o * nl)
                  for o in ((me - s) % p for s in range(p))]
        got = rmod.merge_blocks(qa[:, rows].contiguous(), blocks, k, me * nl, rmod.step_plain,
                                return_scores=True)
        _assert_same_graph(qa[:, rows], ka, got, exact(x[:, rows], x, k, mask))
        want = kmod.knn_plain(xt[:, rows], xt, k, mt, "default")
        hard, _ = split_score_mismatches(qa[:, rows], ka, got[0], want[0], got[1], want[1],
                                         rtol=RTOL)
        assert hard == 0


def test_the_gate_tells_the_two_precisions_apart():
    """The rounded graph is another graph: the fp32 one fails the gate
    against it (so the gate would catch a kernel that ignored the knob),
    while two sums of the rounded products pass it."""
    x, mask, k = _case("wide", seed=2)
    xt, mt = torch.tensor(x), torch.tensor(mask)
    qa, ka = kmod.build_augmented_operands(xt, xt, mt, "default")
    di, dv, _ = kmod.knn_plain(xt, xt, k, mt, "default")
    hi, hv, _ = kmod.knn_plain(xt, xt, k, mt, "highest")
    hard, _ = split_score_mismatches(qa, ka, hi, di, hv, dv, rtol=RTOL)
    assert hard > 0
    # the same rounded scores summed in reverse channel order
    rev = torch.matmul(qa.flip(-1), ka.flip(-1).transpose(-1, -2))
    ri = torch.sort(rev, dim=-1, descending=True, stable=True)[1][..., :k]
    hard, _ = split_score_mismatches(qa, ka, ri, di, dv, dv, rtol=RTOL)
    assert hard == 0


def test_score_order_violations_counts_adjacent_slots():
    s = np.array([[[3.0, 2.0, 2.0, 1.0]]])
    i = np.array([[[4, 1, 2, 0]]])
    v = np.ones_like(s, bool)
    assert score_order_violations(s, i, v) == 0
    assert score_order_violations(s, i[..., [0, 2, 1, 3]], v) == 1
    assert score_order_violations(s[..., [0, 3, 1, 2]], i, v) == 2  # 1 < 2, then 2 = 2 with 2 > 0
    v[..., 2] = False
    assert score_order_violations(s, i[..., [0, 2, 1, 3]], v) == 0


def test_knn_functions_bind_the_precision(monkeypatch):
    """On CUDA with the kernels, ``default`` binds the TC instantiation
    (exact and banded); the CPU graph stays the f32 oracle whatever the
    knob says, as the JAX package's does off the TPU; an unknown value
    raises."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    fn = knn_fn_for(cuda, True, "default", 0)
    assert fn.func is kmod.knn_cuda and fn.keywords == {"precision": "default"}
    assert knn_fn_for(cuda, True, "highest", 0) is kmod.knn_cuda
    fn = knn_fn_for(cuda, True, "default", 64)
    assert fn.func is bmod.knn_banded_cuda and fn.keywords == {"window": 64,
                                                               "precision": "default"}
    assert knn_fn_for(cpu, True, "default", 0) is knn_indices
    assert knn_fn_for(cuda, False, "default", 0) is knn_indices
    fn = knn_fn_for(cpu, True, "default", 64)
    assert fn.func is banded_knn_indices and fn.keywords == {"window": 64}
    assert default_knn_fn(cpu, precision="default") is knn_indices
    with pytest.raises(ValueError, match="knn precision"):
        knn_fn_for(cpu, True, "bf16", 0)


def test_cuda_wrappers_count_tc_launches_apart(monkeypatch):
    """A CUDA launch of ``default`` counts in ``launches_tc`` (the Hopper
    TC kernel, one pass) or ``launches_tc_sweep`` (sweep_tc: the passes of
    k > 64), of ``highest`` in ``launches``, and only there (the plain path
    counts nothing): the launch itself is stubbed here, the card tests
    launch it."""
    x = torch.tensor(_points(1, 1, 200, 4))
    calls = []

    def fake_pass(qa, ka, k, ceil, *, raw, kernel):
        calls.append(qa.dtype)
        b, nq = qa.shape[:2]
        return (torch.zeros((b, nq, k), dtype=torch.int32), torch.ones((b, nq, k), dtype=torch.bool),
                torch.zeros((b, nq, k)))

    monkeypatch.setattr(kmod, "_launch_pass", fake_pass)
    monkeypatch.setattr(kmod, "launches", 0)
    monkeypatch.setattr(kmod, "launches_tc", 0)
    monkeypatch.setattr(kmod, "launches_tc_sweep", 0)
    qa, ka = kmod.build_augmented_operands(x, x, None, "default")
    kmod.launch_operands(qa, ka, 8, "default")
    kmod.launch_operands(qa, ka, 100, "default")  # two passes, one launch counted
    qa, ka = kmod.build_augmented_operands(x, x, None)
    kmod.launch_operands(qa, ka, 8)
    assert (kmod.launches_tc, kmod.launches_tc_sweep, kmod.launches) == (1, 1, 1)
    assert calls == [torch.bfloat16] * 3 + [torch.float32]
    kmod.knn_plain(x, x, 8, None, "default")
    assert (kmod.launches_tc, kmod.launches_tc_sweep, kmod.launches) == (1, 1, 1)


def test_ring_wrappers_take_the_precision(monkeypatch):
    """`ring_knn_cuda` on the CPU is the plain ring of the rounded
    operands; on CUDA its steps would launch the TC kernel on the bf16
    form of those operands, the resident queries cast once."""
    from dgcnn_tpu_torch.parallel.mesh import PointGroup

    solo = PointGroup(rank=0, size=1, device=torch.device("cpu"), backend="gloo",
                      stage_host=False)
    x = torch.tensor(_points(4, 2, 128, 5))
    got = rmod.ring_knn_cuda(x, 12, None, group=solo, precision="default")
    want = kmod.knn_plain(x, x, 12, None, "default")
    qa, ka = kmod.build_augmented_operands(x, x, None, "default")
    hard, _ = split_score_mismatches(qa, ka, got[0], want[0], got[1], want[1], rtol=RTOL)
    assert hard == 0 and torch.equal(got[1], want[1])
    seen = []

    def fake_step(qa, ka, base, topv, topi, ceil=None, *, precision="highest"):
        seen.append((qa.dtype, ka.dtype, precision))
        rmod.step_plain(qa.float()[..., :ka.shape[-1]], ka, base, topv, topi, ceil)

    monkeypatch.setattr(rmod, "launch_step", fake_step)
    rmod._ring(x, 12, None, solo, rmod.launch_step, "default")
    assert seen == [(torch.bfloat16, torch.float32, "default")]


def test_rdma_and_ppermute_rings_take_the_precision():
    """`cp_graph_ops` passes ``knn_precision`` to both rings: on the CPU
    the rdma ring's plain version ranks the rounded operands, the
    ppermute ring's plain distance scores stay f32 (the JAX package's
    off-TPU behaviour)."""
    from dgcnn_tpu_torch.parallel.context_parallel import cp_graph_ops
    from dgcnn_tpu_torch.parallel.mesh import PointGroup

    solo = PointGroup(rank=0, size=1, device=torch.device("cpu"), backend="gloo",
                      stage_host=False)
    x = torch.tensor(_points(6, 1, 128, 4))
    rd = cp_graph_ops(solo, impl="rdma", knn_precision="default").knn(x, 10, None)
    pp = cp_graph_ops(solo, impl="ppermute", knn_precision="default").knn(x, 10, None)
    assert torch.equal(rd[0], kmod.knn_plain(x, x, 10, None, "default")[0])
    assert torch.equal(pp[0], knn_indices(x, 10)[0])
    with pytest.raises(ValueError, match="knn precision"):
        cp_graph_ops(solo, impl="rdma", knn_precision="bf16")


def test_the_tc_launch_pads_the_channels(monkeypatch):
    """The TC launches (sweep_tc and the Hopper kernel) hand the kernel
    bf16 rows of a multiple of 16 channels and the padded width; the fp32
    launch the f32 rows."""
    seen = {}

    class Lib:
        def __getattr__(self, name):
            def fn(*args):
                seen[name] = args
                return 0
            return fn

    monkeypatch.setattr(kmod, "_lib", lambda: Lib())
    monkeypatch.setattr(kmod, "choose_splits", lambda *a, **kw: 1)
    qa, ka = kmod.build_augmented_operands(*(torch.tensor(_points(2, 1, 64, 5)),) * 2, None,
                                           "default")
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    kmod._launch_pass(kmod.tc_operand(qa), kmod.tc_operand(ka), 8, None, raw=False,
                      kernel="sweep")
    args = seen["dgcnn_knn_topk_bf16"]
    assert args[9:16] == (1, 64, 64, 16, 8, 1, 0)
    kmod._launch_pass(kmod.tc_operand(qa), kmod.tc_operand(ka), 8, None, raw=False, kernel="tc")
    assert seen["dgcnn_knn_topk_tc"][7:14] == (1, 64, 64, 16, 8, 1, 0)
    kmod._launch_pass(qa, ka, 8, None, raw=False, kernel="fp32")
    assert seen["dgcnn_knn_topk_f32"][9:16] == (1, 64, 64, 7, 8, 1, 0)
