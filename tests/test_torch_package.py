"""Package rules of the port: it imports no JAX and nothing of the JAX
package, runs on CUDA unless told otherwise, never falls back from the
kernel to its plain version on a CUDA tensor, and its parameter bridge
round-trips."""

import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dgcnn_tpu.models import ModelSpec as JaxSpec
from dgcnn_tpu.models import get_model as jax_get_model
from dgcnn_tpu_torch.bridge import params_from_numpy, params_to_numpy
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.kernels import knn_banded_cuda as bmod
from dgcnn_tpu_torch.kernels import knn_cuda as kmod
from dgcnn_tpu_torch.kernels import ring_knn_cuda as rmod
from dgcnn_tpu_torch.models import dgcnn as tdgcnn
from dgcnn_tpu_torch.ops.knn import banded_knn_indices, knn_indices
from dgcnn_tpu_torch.train import trainval as ttrainval

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "dgcnn_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dgcnn_tpu")


def _port_sources():
    out = [os.path.join(ROOT, "kernel_times.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_h5py_is_imported_by_h5io_alone():
    """h5py may be missing where the port runs: only `H5IO` imports it."""
    found = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for cls in ast.walk(tree):
            for node in ast.walk(cls):
                if isinstance(node, (ast.Import, ast.ImportFrom)) and any(
                        "h5py" in (a.name or "") for a in node.names) or (
                        isinstance(node, ast.ImportFrom) and node.module == "h5py"):
                    found.append((os.path.relpath(path, ROOT),
                                  getattr(cls, "name", None), node.lineno))
    inside = {(f, line) for f, name, line in found if name == "H5IO"}
    assert inside == {("dgcnn_tpu_torch/io/readers.py", line) for _, line in inside}
    assert len(inside) == 1 and {(f, line) for f, _, line in found} == inside


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'dgcnn_tpu', 'msgpack', 'h5py',\n"
        "          'tensorboard'):\n"
        "    sys.modules[m] = None\n"
        "import dgcnn_tpu_torch, dgcnn_tpu_torch.bridge, dgcnn_tpu_torch.config\n"
        "import dgcnn_tpu_torch.io, dgcnn_tpu_torch.models, dgcnn_tpu_torch.ops.loss\n"
        "import dgcnn_tpu_torch.kernels.knn_cuda, dgcnn_tpu_torch.kernels._build\n"
        "import dgcnn_tpu_torch.kernels.knn_banded_cuda, dgcnn_tpu_torch.ops.sfc\n"
        "import dgcnn_tpu_torch.models.head, dgcnn_tpu_torch.train.trainval\n"
        "import dgcnn_tpu_torch.kernels.ring_knn_cuda, dgcnn_tpu_torch.parallel.launch\n"
        "import dgcnn_tpu_torch.parallel.context_parallel\n"
        "import dgcnn_tpu_torch.cli, dgcnn_tpu_torch.train.loop, dgcnn_tpu_torch.train.checkpoint\n"
        "import dgcnn_tpu_torch.io.readers, dgcnn_tpu_torch.io.dgb, dgcnn_tpu_torch.io.convert\n"
        "import dgcnn_tpu_torch.io.augment, dgcnn_tpu_torch.io.writeback, dgcnn_tpu_torch.utils\n"
        "import dgcnn_tpu_torch.utils.distributed, dgcnn_tpu_torch.parallel.collectives\n"
        "import dgcnn_tpu_torch.kernels.ops, dgcnn_tpu_torch.train.export\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax', 'optax', 'msgpack', 'h5py')\n"
        "               and sys.modules[k] is not None for k in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cli_runs_with_jax_msgpack_h5py_blocked(tmp_path):
    """The path the card runs (convert to DGB and npz, train with
    validation and checkpoints, resume, serve with write-back) in a
    process where jax, flax, msgpack, h5py and tensorboard cannot be
    imported."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'dgcnn_tpu', 'msgpack', 'h5py',\n"
        "          'tensorboard'):\n"
        "    sys.modules[m] = None\n"
        "from dgcnn_tpu_torch import cli\n"
        "from dgcnn_tpu_torch.io.convert import main as convert\n"
        "d = sys.argv[1]\n"
        "convert(['synth', d + '/ev.dgb', '--events', '6', '--points', '96'])\n"
        "convert(['synth', d + '/val.npz', '--events', '2', '--points', '96', '--seed', '1'])\n"
        "common = ['-io', 'dgb', '-if', d + '/ev.dgb', '-mb', '2', '-np', '96', '-k', '6',\n"
        "          '--edge_filters', '8', '--head_feat_dim', '16', '--head_mlp', '16',\n"
        "          '-wp', d + '/w/s', '-ld', d + '/log']\n"
        "assert cli.main(['train', *common, '-i', '2', '-rs', '1', '-cs', '1', '-vf',\n"
        "                 d + '/val.npz'], device='cpu') == 0\n"
        "assert cli.main(['train', *common, '-i', '3', '--auto_resume'], device='cpu') == 0\n"
        "assert cli.main(['inference', *common, '-mp', d + '/w/s', '-of', d + '/p.npz'],\n"
        "                device='cpu') == 0\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    assert "restored checkpoint at step 2" in out.stdout
    assert sorted(os.listdir(tmp_path / "w")) == ["s-1.ckpt", "s-2.ckpt", "s-3.ckpt"]
    assert len(np.load(tmp_path / "p.npz")["event_ids"]) == 6


def test_trainval_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(model_name="residual-dgcnn", edge_filters=(8,), head_feat_dim=8, head_mlp=(8,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainval.Trainval(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainval.Trainval(cfg, device="cuda")
    tv = ttrainval.Trainval(cfg, device="cpu")
    assert tv.device.type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cuda_trainer_picks_the_kernel(monkeypatch):
    """On cuda with use_pallas the model's kNN function is the kernel;
    use_pallas=False picks the oracle there too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = Config(model_name="residual-dgcnn", edge_filters=(8,), head_feat_dim=8, head_mlp=(8,))
    assert ttrainval.Trainval(cfg).model.knn_fn is kmod.knn_cuda
    off = ttrainval.Trainval(Config(**{**cfg.__dict__, "use_pallas": False}))
    assert off.model.knn_fn is knn_indices
    # --knn_precision default (ROADMAP item 10, raised until the
    # mixed-precision slice) binds the kernel's tensor-core instantiation
    tc = ttrainval.Trainval(Config(**{**cfg.__dict__, "knn_precision": "default"})).model.knn_fn
    assert tc.func is kmod.knn_cuda and tc.keywords == {"precision": "default"}


def _is_banded(fn, func, window):
    return fn.func is func and fn.args == () and fn.keywords == {"window": window}


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_trainer_picks_the_banded_kernel(monkeypatch, device, use_pallas):
    """With knn_window > 0: the banded kernel on cuda with use_pallas, the
    banded oracle on the CPU or with use_pallas off; both bound to the
    window."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = Config(model_name="residual-dgcnn", edge_filters=(8,), head_feat_dim=8,
                 head_mlp=(8,), knn_window=256, use_pallas=use_pallas)
    fn = ttrainval.Trainval(cfg, device=device).model.knn_fn
    want = bmod.knn_banded_cuda if device == "cuda" and use_pallas else banded_knn_indices
    assert _is_banded(fn, want, 256)


def test_model_without_knn_fn_picks_by_device(monkeypatch):
    """A model built without a kNN function takes the kernel for CUDA
    features and the oracle for CPU features, never the oracle on the
    card."""
    assert tdgcnn.default_knn_fn(torch.device("cuda", 0)) is kmod.knn_cuda
    assert tdgcnn.default_knn_fn(torch.device("cuda", 0), use_kernel=False) is knn_indices
    assert tdgcnn.default_knn_fn(torch.device("cpu")) is knn_indices
    assert _is_banded(tdgcnn.default_knn_fn(torch.device("cuda", 0), window=64),
                      bmod.knn_banded_cuda, 64)
    assert _is_banded(tdgcnn.default_knn_fn(torch.device("cpu"), window=64),
                      banded_knn_indices, 64)
    spec = tdgcnn.ModelSpec(num_class=2, k=4, edge_filters=(8, 8), head_feat_dim=8, head_mlp=(8,))
    model = tdgcnn.make_model(spec)
    params, state = model.init(3, torch.Generator().manual_seed(0))
    seen = []
    monkeypatch.setattr(
        tdgcnn, "default_knn_fn", lambda dev, window=0: seen.append((dev, window)) or knn_indices
    )
    logits, _ = model(params, state, torch.randn(1, 16, 3))
    assert logits.shape == (1, 16, 2)
    assert seen == [(torch.device("cpu"), 0)]


class _CudaLike:
    """Stands in for a CUDA tensor where torch has no CUDA."""

    device = torch.device("cuda", 0)


def test_knn_cuda_on_cuda_tensor_never_reaches_plain(monkeypatch):
    """The self forms' registered operators (`kernels.ops`) take a CUDA
    tensor to the kernel's launch, the cross forms their `_dispatch`; a
    refused launch raises, and no path reaches the plain version. A meta
    tensor (tracing) gets the fake implementation's shapes and reaches
    neither."""
    from dgcnn_tpu_torch.kernels import ops

    calls = []

    def no_plain(*a, **k):
        raise AssertionError("knn_plain reached for a CUDA tensor")

    def fake_launch(xq, xk, k, mask_k, precision="highest"):
        calls.append((xq, xk, k, mask_k))
        raise RuntimeError("launch refused")

    monkeypatch.setattr(kmod, "knn_plain", no_plain)
    monkeypatch.setattr(kmod, "_launch", fake_launch)
    monkeypatch.setattr(bmod, "knn_banded_plain", no_plain)
    monkeypatch.setattr(bmod, "_launch", lambda xq, xk, k, mask_k, **band: fake_launch(xq, xk, k, mask_k))
    x = _CudaLike()
    x.shape = (1, 8, 3)
    with pytest.raises(RuntimeError, match="launch refused"):
        ops.knn._backend_fns["cuda"](x, 4, None, "highest")
    with pytest.raises(RuntimeError, match="launch refused"):
        kmod.knn_cuda_cross(x, x, 4)
    with pytest.raises(RuntimeError, match="launch refused"):
        ops.knn_banded._backend_fns["cuda"](x, 4, None, 8, "highest")
    with pytest.raises(RuntimeError, match="launch refused"):
        bmod.knn_banded_cuda_cross(x, x, 4, window=8, q_base=0, key_base=0, nvalid=[8])
    assert len(calls) == 4
    meta = torch.empty(1, 8, 3, device="meta")
    for idx, valid in (kmod.knn_cuda(meta, 2), bmod.knn_banded_cuda(meta, 2, window=4)):
        assert (idx.shape, idx.dtype, valid.shape, valid.dtype, idx.device.type) == (
            (1, 8, 2), torch.int32, (1, 8, 2), torch.bool, "meta")
    assert len(calls) == 4
    # other devices are refused outright by the cross forms
    with pytest.raises(ValueError, match="no kernel"):
        kmod.knn_cuda_cross(meta, meta, 2)


def test_ring_kernel_on_cuda_tensor_never_reaches_plain(monkeypatch):
    """A CUDA shard runs the ring with the kernel's merge step, never the
    plain one."""
    seen = []
    monkeypatch.setattr(rmod, "_check", lambda *a: None)
    monkeypatch.setattr(rmod, "_ring", lambda x, k, m, group, step, precision: seen.append(step))
    x = _CudaLike()
    x.shape = (1, 8, 3)
    rmod.ring_knn_cuda(x, 4, group=None)
    assert seen == [rmod.launch_step]


def test_kernel_module_has_no_fallback():
    """No try/except in the wrapper: a failed build or launch raises."""
    from dgcnn_tpu_torch.kernels import edge_mlp_cuda, ops

    for mod in (kmod, bmod, rmod, ops, edge_mlp_cuda):
        tree = ast.parse(open(mod.__file__).read())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    build = ast.parse(open(os.path.join(PKG, "kernels", "_build.py")).read())
    assert not [n for n in ast.walk(build) if isinstance(n, ast.Try)]


def test_kernel_build_names_every_source():
    from dgcnn_tpu_torch.kernels import _build

    # three kNN kernels, all sharing the sweep and the warp top-k headers
    # and the Hopper TC pipeline with its PTX wrappers; the exact one also
    # the Hopper fp32 pipeline; and the fused depth-2 EdgeConv block, which
    # includes none of them
    assert sorted(os.listdir(_build.CSRC)) == [
        "edge_mlp.cu", "knn.cu", "knn_banded.cu", "knn_hopper.cuh", "knn_sweep.cuh",
        "knn_tc.cuh", "ring_knn.cu", "sm90.cuh", "warp_topk.cuh"]
    assert '#include "' not in open(os.path.join(_build.CSRC, "edge_mlp.cu")).read()
    for name in ("knn", "knn_banded", "ring_knn"):
        source = open(os.path.join(_build.CSRC, name + ".cu")).read()
        assert '#include "knn_sweep.cuh"' in source
        assert '#include "knn_tc.cuh"' in source
        assert ('#include "knn_hopper.cuh"' in source) == (name == "knn")
    sweep = open(os.path.join(_build.CSRC, "knn_sweep.cuh")).read()
    assert '#include "warp_topk.cuh"' in sweep
    assert '#include "sm90.cuh"' in open(os.path.join(_build.CSRC, "knn_tc.cuh")).read()
    for name in ("knn", "knn_banded", "ring_knn", "edge_mlp"):
        src, lib = _build._target(name)
        assert src.endswith(os.path.join("dgcnn_tpu_torch", "csrc", name + ".cu"))
        assert lib.startswith(os.path.join(ROOT, "build", "kernels"))
    # the band expression is written once in the kernel's source
    banded = open(os.path.join(_build.CSRC, "knn_banded.cu")).read()
    assert banded.count("int band_lo(") == 1 and "dgcnn_tpu/ops/knn.py:88" in banded
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_kernel_build_hash_covers_headers(monkeypatch, tmp_path):
    """An edited header gives every source a new library path; an edit of
    one source moves only its own."""
    from dgcnn_tpu_torch.kernels import _build

    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "b.cu").write_text("// b\n")
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    first = {n: _build._target(n)[1] for n in ("a", "b")}
    assert first == {n: _build._target(n)[1] for n in ("a", "b")}
    (tmp_path / "h.cuh").write_text("// two\n")
    second = {n: _build._target(n)[1] for n in ("a", "b")}
    assert all(second[n] != first[n] for n in ("a", "b"))
    (tmp_path / "b.cu").write_text("// b, edited\n")
    third = {n: _build._target(n)[1] for n in ("a", "b")}
    assert third["a"] == second["a"] and third["b"] != second["b"]
    (tmp_path / "g.cuh").write_text("// a new header\n")
    assert _build._target("a")[1] != third["a"]


JAX_ROOT = os.path.join(ROOT, "dgcnn_tpu")
# the kernel modules' counterparts, and their entry points' names there
KERNEL_MODULES = {
    "kernels/knn_pallas.py": ("kernels/knn_cuda.py", {
        "knn_pallas": "knn_cuda", "knn_pallas_cross": "knn_cuda_cross"}),
    "kernels/knn_banded.py": ("kernels/knn_banded_cuda.py", {
        "knn_pallas_banded": "knn_banded_cuda", "knn_pallas_banded_cross": "knn_banded_cuda_cross"}),
    "kernels/ring_knn_rdma.py": ("kernels/ring_knn_cuda.py", {"ring_knn_rdma": "ring_knn_cuda"}),
}
# public names of the JAX package with a counterpart of another name
RENAMED = {("ops/edge.py", "gathered_stats"): "GatheredStats"}
# public names of the JAX package with no counterpart, each with its reason
EXEMPT = {
    ("parallel/mesh.py", "data_sharding"): "a jax.sharding object; the port's ranks each hold "
                                           "their rows, cut by RankGroup",
    ("parallel/mesh.py", "replicated"): "a jax.sharding object; parameters replicate by "
                                        "broadcast over a RankGroup",
    ("parallel/collectives.py", "axis_index"): "a traced axis index; a rank reads "
                                               "RankGroup.rank",
}


def _top_level_names(path, public):
    names = set()
    for node in ast.parse(open(path).read(), path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif not public and isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif not public and isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in names if not n.startswith("_")} if public else names


def test_every_public_name_of_the_jax_package_has_a_counterpart():
    """Every public function and class of every module of `dgcnn_tpu` has a
    counterpart in the port's module of the same path (the kernel modules:
    their `*_cuda.py`), or an exemption with its reason."""
    missing, modules = [], 0
    for d, _, files in os.walk(JAX_ROOT):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, f), JAX_ROOT).replace(os.sep, "/")
            port_rel, names = KERNEL_MODULES.get(rel, (rel, {}))
            port = os.path.join(PKG, port_rel)
            assert os.path.exists(port), f"dgcnn_tpu/{rel} has no counterpart dgcnn_tpu_torch/{port_rel}"
            modules += 1
            have = _top_level_names(port, public=False)
            for name in sorted(_top_level_names(os.path.join(d, f), public=True)):
                if (rel, name) in EXEMPT:
                    continue
                if names.get(name, RENAMED.get((rel, name), name)) not in have:
                    missing.append(f"dgcnn_tpu/{rel}::{name}")
    assert modules >= 40
    assert not missing, missing
    # an exemption names a real gap: the JAX name exists and the port has none
    for (rel, name), reason in EXEMPT.items():
        assert name in _top_level_names(os.path.join(JAX_ROOT, rel), public=True) and reason
        assert name not in _top_level_names(os.path.join(PKG, rel), public=False)


@pytest.mark.parametrize("name", ["dgcnn", "residual-dgcnn"])
def test_bridge_round_trips(name):
    spec = JaxSpec(num_class=3, k=4, edge_filters=(8, 12), head_feat_dim=16, head_mlp=(8,))
    params, state = jax_get_model(name, spec).init(jax.random.PRNGKey(2), 5)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    tp, ts = params_from_numpy(params, state)
    assert tp["blocks"][0]["w"].dtype == torch.float32
    back_p, back_s = params_to_numpy(tp, ts)
    assert jax.tree_util.tree_structure((back_p, back_s)) == jax.tree_util.tree_structure(
        (params, state)
    )
    for a, b in zip(jax.tree_util.tree_leaves((back_p, back_s)),
                    jax.tree_util.tree_leaves((params, state))):
        np.testing.assert_array_equal(a, b)
    assert ("proj" in tp["blocks"][0]) == (name == "residual-dgcnn")
