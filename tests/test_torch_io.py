"""The port's event IO against the JAX package's on the same files: every
reader gives bitwise-equal events (DGB through the C++ reader and through
the numpy view), the batcher bitwise-equal batches in both crop modes with
and without the native batch path, the converter the same files (DGB byte
for byte; npz member by member and h5 dataset by dataset, since zip and
HDF5 headers carry write times), the write-back the same contents, and
augmentation the same draws.
"""

import os
import subprocess
import sys
import zipfile

import h5py
import numpy as np
import pytest

from dgcnn_tpu.io import BucketBatcher as JaxBatcher
from dgcnn_tpu.io import SegmentWriter as JaxWriter
from dgcnn_tpu.io import SyntheticIO as JaxSyntheticIO
from dgcnn_tpu.io import write_canonical as jax_write_canonical
from dgcnn_tpu.io.augment import augment_stream as jax_augment_stream
from dgcnn_tpu.io.convert import main as jax_convert
from dgcnn_tpu.io.dgb import DGBIO as JaxDGBIO
from dgcnn_tpu.io.dgb import write_dgb as jax_write_dgb
from dgcnn_tpu.io.readers import reader_for as jax_reader_for
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.io import BucketBatcher, SegmentWriter, SyntheticIO, io_factory, native
from dgcnn_tpu_torch.io import write_canonical
from dgcnn_tpu_torch.io import dgb as dgb_mod
from dgcnn_tpu_torch.io.augment import augment_stream
from dgcnn_tpu_torch.io.convert import main as convert
from dgcnn_tpu_torch.io.dgb import DGBIO, write_dgb
from dgcnn_tpu_torch.io.readers import H5IO, reader_for

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _events(n=10, num_point=300, seed=0, weights=True):
    io = JaxSyntheticIO(num_events=n, num_point=num_point, seed=seed,
                        with_weights=weights).initialize()
    return [io.read_event(i) for i in range(n)]


def _csv(path, events, weights=True):
    rows = ["event_id,x,y,z,value,label" + (",weight" if weights else "")]
    for i, ev in zip((100018, 7, 100042, 3, 55, 9, 12, 13, 14, 15), events):
        for j in range(len(ev)):
            vals = [f"{v:.6f}" for v in ev.points[j]] + [str(int(ev.labels[j]))]
            if weights:
                vals.append(f"{ev.weights[j]:.6f}")
            rows.append(f"{i}," + ",".join(vals))
    path.write_text("\n".join(rows))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("io")
    events = _events()
    out = {"events": events}
    for kind in ("h5", "npz"):
        out[kind] = str(d / f"ev.{kind}")
        jax_write_canonical(out[kind], events, kind)
    out["dgb"] = str(d / "ev.dgb")
    jax_write_dgb(out["dgb"], events)
    out["csv"] = str(d / "ev.csv")
    _csv(d / "ev.csv", events[:6])
    return out


def _same_event(a, b):
    assert a.id == b.id and a.ordinal == b.ordinal and a.crop_key == b.crop_key
    for x, y in ((a.points, b.points), (a.labels, b.labels), (a.weights, b.weights)):
        if y is None:
            assert x is None
        else:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _port_dgb(path, native_path: bool):
    io = DGBIO(path).initialize()
    if not native_path:
        io.finalize()
        io = DGBIO(path)
        io._init_python_view()
    assert io.native_active == native_path
    return io


@pytest.mark.parametrize("kind", ["h5", "npz", "csv", "dgb-native", "dgb-python"])
def test_readers_match_jax(files, kind):
    fmt = kind.split("-")[0]
    want = jax_reader_for(fmt, files[fmt], weight_key="weight").initialize()
    if kind.startswith("dgb"):
        got = _port_dgb(files[fmt], kind == "dgb-native")
    else:
        got = reader_for(fmt, files[fmt], weight_key="weight").initialize()
    assert got.num_events() == want.num_events()
    for i in range(want.num_events()):
        _same_event(got.read_event(i), want.read_event(i))
    if hasattr(want, "event_lengths"):
        np.testing.assert_array_equal(got.event_lengths(), want.event_lengths())
    got.finalize()
    want.finalize()


def test_native_reader_builds_outside_the_package():
    lib = native.load()
    assert lib is not None, "g++ build of the DGB reader failed"
    path = native.library_path()
    assert path.startswith(os.path.join(ROOT, "build", "native"))
    assert os.path.exists(path)
    assert not [f for f in os.listdir(os.path.dirname(native.SRC)) if f.endswith(".so")]


def _same_batch(a, b):
    for name in ("points", "labels", "weights", "mask", "event_ids", "lengths"):
        x, y = getattr(a, name), getattr(b, name)
        if y is None:
            assert x is None, name
        else:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("native_path", [True, False])
@pytest.mark.parametrize("crop_mode", ["random", "stride"])
@pytest.mark.parametrize("num_point,shuffle", [(128, True), (0, True), (200, False)])
def test_batches_match_jax(files, native_path, crop_mode, num_point, shuffle):
    """Two epochs of batches (a remainder batch, crops of events longer
    than num_point, buckets when num_point is 0), DGB through the C++ or
    the numpy path on both sides, against the JAX batcher."""
    jio = JaxDGBIO(files["dgb"]).initialize()
    if not native_path:
        jio._handle = None
    pio = _port_dgb(files["dgb"], native_path)
    kw = dict(batch_size=4, buckets=(128, 256, 512), num_point=num_point, shuffle=shuffle,
              seed=5, crop_mode=crop_mode)
    jb, pb = JaxBatcher(jio, **kw), BucketBatcher(pio, **kw)
    if shuffle:
        jb.reseed(17)
        pb.reseed(17)
    before = dgb_mod.native_batches
    got = [b for _ in range(2) for b in pb.epoch()]
    want = [b for _ in range(2) for b in jb.epoch()]
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        _same_batch(a, b)
    assert dgb_mod.native_batches - before == (6 if native_path else 0)
    pio.finalize()
    jio.finalize()


@pytest.mark.parametrize("kind", ["h5", "npz", "csv"])
def test_batches_of_other_readers_match_jax(files, kind):
    jio = jax_reader_for(kind, files[kind]).initialize()
    pio = reader_for(kind, files[kind]).initialize()
    kw = dict(batch_size=3, num_point=160, shuffle=True, seed=2)
    for a, b in zip(BucketBatcher(pio, **kw).epoch(), JaxBatcher(jio, **kw).epoch()):
        _same_batch(a, b)


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _h5_arrays(path):
    with h5py.File(path, "r") as f:
        return {k: (f[k].dtype, np.asarray(f[k])) for k in f}


def _same_file(a, b):
    if a.endswith(".npz"):
        assert _npz_members(a) == _npz_members(b)
    elif a.endswith(".h5"):
        ga, gb = _h5_arrays(a), _h5_arrays(b)
        assert ga.keys() == gb.keys()
        for k in ga:
            assert ga[k][0] == gb[k][0]
            np.testing.assert_array_equal(ga[k][1], gb[k][1])
    else:
        assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("argv", [
    ["synth", "{out}.dgb", "--events", "5", "--points", "200", "--weights"],
    ["synth", "{out}.npz", "--events", "5", "--points", "200", "--fixed_length", "--seed", "3"],
    ["synth", "{out}.h5", "--events", "4", "--points", "150", "--classes", "3"],
    ["csv2dgb", "{csv}", "{out}.dgb"],
    ["csv2npz", "{csv}", "{out}.npz"],
    ["csv2h5", "{csv}", "{out}.h5"],
    ["convert", "{npz}", "{out}.dgb"],
    ["convert", "{dgb}", "{out}.npz"],
    ["convert", "{h5}", "{out}.npz"],
])
def test_convert_matches_jax(files, tmp_path, argv, capsys):
    outs = []
    for name, main in (("jax", jax_convert), ("port", convert)):
        args = [a.format(out=str(tmp_path / name), **files) for a in argv]
        main(args)
        outs.append(args[-1] if argv[0] != "synth" else args[1])
    _same_file(outs[1], outs[0])
    out = capsys.readouterr().out
    assert out.count("wrote") == 2


def test_write_canonical_matches_jax(files, tmp_path):
    events = files["events"]
    for kind in ("npz", "h5"):
        jax_write_canonical(str(tmp_path / f"j.{kind}"), events, kind)
        write_canonical(str(tmp_path / f"p.{kind}"), events, kind)
        _same_file(str(tmp_path / f"p.{kind}"), str(tmp_path / f"j.{kind}"))
    write_dgb(str(tmp_path / "p.dgb"), events)
    _same_file(str(tmp_path / "p.dgb"), files["dgb"])


@pytest.mark.parametrize("ext", ["h5", "npz", "csv"])
@pytest.mark.parametrize("with_scores", [True, False])
def test_segment_writer_matches_jax(tmp_path, ext, with_scores):
    """Out-of-order ids, a repeated id (first write wins), an empty event."""
    rng = np.random.RandomState(4)
    stores = []
    for eid, n in ((7, 11), (2, 5), (7, 3), (0, 0), (5, 9)):
        pts = rng.randn(n, 4).astype(np.float32)
        pred = rng.randint(0, 3, n)
        sc = rng.rand(n, 3).astype(np.float32) if with_scores else None
        stores.append((eid, pts, pred, sc))
    paths = []
    for name, cls in (("jax", JaxWriter), ("port", SegmentWriter)):
        path = str(tmp_path / f"{name}.{ext}")
        w = cls(path)
        for s in stores:
            w.store_segment(*s)
        assert len(w) == 4
        w.finalize()
        paths.append(path)
        assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    _same_file(paths[1], paths[0])


def test_augment_stream_matches_jax(files):
    io = JaxDGBIO(files["dgb"]).initialize()
    batches = list(JaxBatcher(io, 3, num_point=256, shuffle=False, seed=1).epoch())
    got = list(augment_stream(iter(batches), seed=11))
    want = list(jax_augment_stream(iter(batches), seed=11))
    for a, b in zip(got, want):
        _same_batch(a, b)
    assert not np.array_equal(got[0].points, batches[0].points)
    io.finalize()


def test_port_writers_read_back_in_jax(tmp_path):
    """A file the port wrote reads in the JAX package (and the events of
    the port's own SyntheticIO equal the JAX package's)."""
    events = [SyntheticIO(num_events=3, num_point=64, seed=1).initialize().read_event(i)
              for i in range(3)]
    for want, got in zip(_events(3, 64, 1, weights=False), events):
        _same_event(got, want)
    write_dgb(str(tmp_path / "p.dgb"), events)
    jio = JaxDGBIO(str(tmp_path / "p.dgb")).initialize()
    for i, ev in enumerate(events):
        np.testing.assert_array_equal(jio.read_event(i).points, ev.points)
    jio.finalize()


@pytest.mark.parametrize("corruption,msg", [
    ("magic", "not a DGB file"), ("truncated", "truncated DGB file"),
    ("offsets", "corrupt DGB offsets table"),
])
def test_corrupt_dgb_rejected_like_jax(files, tmp_path, corruption, msg):
    data = bytearray(open(files["dgb"], "rb").read())
    if corruption == "magic":
        data[:4] = b"XXXX"
    elif corruption == "truncated":
        data = data[: len(data) // 2]
    else:
        data[0x18 + 8 : 0x18 + 16] = np.uint64(10**6).tobytes()
    path = tmp_path / "bad.dgb"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=msg):
        JaxDGBIO(str(path)).initialize()
    with pytest.raises(ValueError, match=msg):
        DGBIO(str(path)).initialize()


def _cfg(**kw):
    return Config(**{"io_type": "dgb", "input_file": "", **kw})


def test_io_factory_checks(files, tmp_path):
    with pytest.raises(ValueError, match="requires --input_file"):
        io_factory(_cfg())
    with pytest.raises(FileNotFoundError):
        io_factory(_cfg(input_file=str(tmp_path / "missing.dgb")))
    with pytest.raises(ValueError, match="ROOT files are not read directly"):
        io_factory(_cfg(io_type="larcv", input_file=files["dgb"]))
    for kind in ("dgb", "csv"):
        with pytest.raises(ValueError, match="do not apply"):
            io_factory(_cfg(io_type=kind, input_file=files[kind], label_key="y"))
    assert io_factory(_cfg(io_type="synthetic", minibatch_size=2)).num_events() == 64


def test_h5_needs_h5py_only_when_read(files, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="need h5py"):
        H5IO(files["h5"]).initialize()
    w = SegmentWriter(str(tmp_path / "p.h5"))
    w.store_segment(0, np.zeros((1, 4)), [0])
    with pytest.raises(ImportError, match="need h5py"):
        w.finalize()
    with pytest.raises(ImportError, match="need h5py"):
        convert(["synth", str(tmp_path / "s.h5"), "--events", "1", "--points", "8"])
    # the other formats go on without it
    assert reader_for("npz", files["npz"]).initialize().num_events() == 10


def test_convert_command_line_runs_without_h5py(tmp_path):
    """``python -m dgcnn_tpu_torch.io.convert`` to DGB and npz in a process
    where h5py, jax and the JAX package cannot be imported."""
    code = (
        "import sys, runpy\n"
        "for m in ('h5py', 'jax', 'flax', 'dgcnn_tpu'):\n"
        "    sys.modules[m] = None\n"
        "sys.argv = ['convert'] + sys.argv[1:]\n"
        "runpy.run_module('dgcnn_tpu_torch.io.convert', run_name='__main__')\n"
    )
    for out in ("a.dgb", "a.npz"):
        res = subprocess.run(
            [sys.executable, "-c", code, "synth", str(tmp_path / out), "--events", "3",
             "--points", "64"], cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        assert "wrote 3 events" in res.stdout
