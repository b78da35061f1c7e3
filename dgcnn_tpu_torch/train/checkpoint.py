"""Checkpoint save/restore (port of `dgcnn_tpu/train/checkpoint.py`).

A checkpoint is ``{weight_prefix}-{step}.ckpt``: one msgpack document
``{"config": json, "step": int, "tree": state}`` in the JAX package's file
format, byte for byte, so either package restores what the other wrote.
The JAX package writes it with ``flax.serialization.msgpack_serialize``;
the port has no flax or msgpack, so this module carries the subset of
msgpack that flax uses as a small pure-Python codec (`packb`, `unpackb`):

- nil, bool, int, float (64-bit), str, bin, array and map;
- ext type 1, an ndarray: the msgpack array ``(shape, dtype name, C-order
  bytes)``; ext type 3, a numpy scalar in the same encoding;
- every map's keys in sorted order (flax maps the tree through
  ``jax.tree_util``, which sorts dict keys), lists and tuples as maps
  keyed ``"0"``, ``"1"``, ...;
- arrays of more than `MAX_CHUNK_SIZE` bytes as flax's chunked form
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
  (keys in that order), read back whole.

The tree is the JAX `TrainState` as flax's state dict: ``params``,
``model_state``, ``opt_state`` (optax's chain state), ``step`` (int32) and
``rng`` (a JAX key). The trainer maps its own state to and from that
layout (`train.trainval.Trainval.state_tree` / `load_tree`); this module
knows only the format and the template matching.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import struct

import numpy as np

# flax's limit for one array leaf before it is split into chunks
MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# ----------------------------------------------------------------- codec


def to_state_dict(tree):
    """flax's ``to_state_dict``: lists and tuples as maps keyed by
    position, torch tensors as numpy arrays."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    if hasattr(tree, "detach"):  # a torch tensor
        return tree.detach().cpu().numpy()
    return tree


def _prepared(tree):
    """The tree as ``msgpack_serialize`` packs it: every map sorted by key
    (flax maps it through ``jax.tree_util``), large arrays chunked."""
    if isinstance(tree, dict):
        return {k: _prepared(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_prepared(v) for v in tree]
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        chunk = max(1, int(MAX_CHUNK_SIZE / tree.dtype.itemsize))
        flat = tree.reshape(-1)
        return {
            _CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(tree.shape)},
            "chunks": {str(j): flat[lo : lo + chunk]
                       for j, lo in enumerate(range(0, flat.size, chunk))},
        }
    return tree


def _pack_len(out: list, n: int, small: int | None, small_max: int, codes) -> None:
    """A length header: the fix form below ``small_max``, else 8/16/32-bit."""
    if small is not None and n <= small_max:
        out.append(struct.pack("B", small | n))
    elif codes[0] is not None and n <= 0xFF:
        out.append(struct.pack(">BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    else:
        out.append(struct.pack(">BI", codes[2], n))


def _pack_ndarray(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(obj, out: list) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        if 0 <= obj < 0x80:
            out.append(struct.pack("B", obj))
        elif -0x20 <= obj < 0:
            out.append(struct.pack("b", obj))
        elif 0 <= obj <= 0xFF:
            out.append(struct.pack(">BB", 0xCC, obj))
        elif -0x80 <= obj < 0:
            out.append(struct.pack(">Bb", 0xD0, obj))
        elif 0 <= obj <= 0xFFFF:
            out.append(struct.pack(">BH", 0xCD, obj))
        elif -0x8000 <= obj < 0:
            out.append(struct.pack(">Bh", 0xD1, obj))
        elif 0 <= obj <= 0xFFFFFFFF:
            out.append(struct.pack(">BI", 0xCE, obj))
        elif -0x80000000 <= obj < 0:
            out.append(struct.pack(">Bi", 0xD2, obj))
        elif 0 <= obj <= 0xFFFFFFFFFFFFFFFF:
            out.append(struct.pack(">BQ", 0xCF, obj))
        elif -0x8000000000000000 <= obj < 0:
            out.append(struct.pack(">Bq", 0xD3, obj))
        else:
            raise OverflowError(f"integer {obj} does not fit msgpack")
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif t is str:
        b = obj.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(b)
    elif t is bytes:
        _pack_len(out, len(obj), None, -1, (0xC4, 0xC5, 0xC6))
        out.append(obj)
    elif t is list:
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif t is dict:
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        data = _pack_ndarray(np.asarray(obj))
        n = len(data)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(struct.pack(">Bb", fixext[n], code))
        elif n <= 0xFF:
            out.append(struct.pack(">BBb", 0xC7, n, code))
        elif n <= 0xFFFF:
            out.append(struct.pack(">BHb", 0xC8, n, code))
        else:
            out.append(struct.pack(">BIb", 0xC9, n, code))
        out.append(data)
    else:
        raise TypeError(f"cannot serialize {t.__name__}")


def packb(obj) -> bytes:
    """msgpack bytes of ``obj`` (maps in their given order)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        v = self.data[self.pos : self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {  # code -> struct format of a number
    0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_LEN = {  # code -> (kind, struct format of the length)
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _unpack(r: _Reader):
    c = r.unpack("B")
    if c <= 0x7F:
        return c
    if c >= 0xE0:
        return c - 0x100
    if 0x80 <= c <= 0x8F:
        kind, n = "map", c & 0x0F
    elif 0x90 <= c <= 0x9F:
        kind, n = "array", c & 0x0F
    elif 0xA0 <= c <= 0xBF:
        kind, n = "str", c & 0x1F
    elif c == 0xC0:
        return None
    elif c == 0xC2:
        return False
    elif c == 0xC3:
        return True
    elif c in _FIXED:
        return r.unpack(_FIXED[c])
    elif c in _LEN:
        kind, fmt = _LEN[c]
        n = r.unpack(fmt)
    elif c in _FIXEXT:
        kind, n = "ext", _FIXEXT[c]
    else:
        raise ValueError(f"unsupported msgpack type 0x{c:02x}")
    if kind == "str":
        return bytes(r.take(n)).decode("utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    if kind == "map":
        out = {}
        for _ in range(n):
            k = _unpack(r)
            out[k] = _unpack(r)
        return out
    code = r.unpack("b")
    data = bytes(r.take(n))
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, dtype, buf = unpackb(data)
    arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
    return arr if code == _EXT_NDARRAY else arr[()]


def unpackb(data: bytes):
    """The object of msgpack bytes (ndarrays as read-only views)."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("extra bytes after the msgpack document")
    return obj


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            flat = np.concatenate(
                [tree["chunks"][str(j)] for j in range(len(tree["chunks"]))])
            return flat.reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def serialize(payload) -> bytes:
    """``flax.serialization.msgpack_serialize`` of a tree of dicts, lists,
    numpy arrays and Python scalars."""
    return packb(_prepared(payload))


def restore_bytes(data: bytes):
    """``flax.serialization.msgpack_restore``: the tree, chunks joined."""
    return _unchunk(unpackb(data))


def from_state_dict(template, state, path: str = ""):
    """``state`` (a restored tree) in the structure of ``template``: dicts
    by key (every template key must be there), lists and tuples from maps
    keyed by position (equal length), leaves as numpy arrays of the
    template leaf's shape. A mismatch raises ValueError naming the path."""
    if isinstance(template, dict):
        if not isinstance(state, dict):
            raise ValueError(f"expected a map at {path or '/'}")
        missing = set(map(str, template)) - set(state)
        if missing:
            raise ValueError(
                f"the state dict lacks keys {sorted(missing)} at {path or '/'}")
        return {k: from_state_dict(v, state[str(k)], f"{path}/{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(state, dict) or len(state) != len(template):
            raise ValueError(
                f"the size of the list and the state dict do not match at {path or '/'}")
        return type(template)(from_state_dict(v, state[str(i)], f"{path}/{i}")
                              for i, v in enumerate(template))
    shape = tuple(template.shape if hasattr(template, "shape") else np.shape(template))
    if np.shape(state) != shape:
        raise ValueError(
            f"shape mismatch at {path}: checkpoint {np.shape(state)}, run {shape}")
    return np.asarray(state)


# ------------------------------------------------------------ the files


def save(path_prefix: str, step: int, tree, config_dict=None) -> str:
    """Write ``{path_prefix}-{step}.ckpt`` atomically; returns the path.
    ``tree`` is the state dict of the run (`Trainval.state_tree`)."""
    d = os.path.dirname(path_prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = {
        "tree": to_state_dict(tree),
        "step": int(step),
        "config": json.dumps(config_dict or {}, default=list),
    }
    path = f"{path_prefix}-{step}.ckpt"
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(serialize(payload))
    os.replace(tmp, path)  # a crash never leaves a torn checkpoint
    return path


def _step_of(path_prefix: str, path: str):
    """Step number iff ``path`` is exactly ``{prefix}-<step>.ckpt`` (a
    suffix search would also match a sibling run whose prefix extends this
    one, ``snap-lr01-700.ckpt`` for ``snap``, and prune deletes)."""
    m = re.fullmatch(re.escape(path_prefix) + r"-(\d+)\.ckpt", path)
    return int(m.group(1)) if m else None


def prune(path_prefix: str, keep: int) -> list:
    """Delete all but the ``keep`` highest-step checkpoints of a prefix;
    returns the removed paths. ``keep <= 0`` keeps everything."""
    if keep <= 0:
        return []
    found = []
    for p in glob.glob(f"{path_prefix}-*.ckpt"):
        step = _step_of(path_prefix, p)
        if step is not None:
            found.append((step, p))
    found.sort()
    removed = []
    for _, p in found[:-keep] if len(found) > keep else []:
        try:
            os.remove(p)
            removed.append(p)
        except OSError:
            pass
    return removed


def latest(path_prefix: str):
    """Highest-step checkpoint path for a prefix, or None."""
    best, best_step = None, -1
    for p in glob.glob(f"{path_prefix}-*.ckpt"):
        step = _step_of(path_prefix, p)
        if step is not None and step > best_step:
            best, best_step = p, step
    return best


def _resolve(path: str) -> str:
    """``path`` itself, or the newest checkpoint of it as a prefix."""
    if os.path.exists(path):
        return path
    cand = latest(path)
    if cand is None:
        raise FileNotFoundError(f"no checkpoint at {path!r}")
    return cand


def _mismatch_error(path, payload, err):
    saved = json.loads(payload.get("config", "{}"))
    hints = {
        k: saved.get(k)
        for k in (
            "model_name", "edge_filters", "head_feat_dim", "head_mlp",
            "block_convs", "optimizer", "lr_schedule", "num_class",
        )
    }
    return ValueError(
        f"checkpoint {path!r} does not match the current run "
        f"configuration: {err}\nThe checkpoint was saved with {hints}; "
        f"pass matching model/optimizer flags to resume from it."
    )


def peek(path: str):
    """The raw payload (keys tree/step/config) without a template, for a
    caller that inspects it before building the model; pass it on to
    `restore_subtrees` so the file is parsed once."""
    with open(_resolve(path), "rb") as f:
        return restore_bytes(f.read())


def restore_subtrees(path: str, templates: dict, payload: dict | None = None):
    """Load only named top-level entries (params and model_state for
    inference, which carries no optimizer state). Returns ``({name:
    tree}, step, config_dict)``."""
    if payload is None:
        path = _resolve(path)
        with open(path, "rb") as f:
            payload = restore_bytes(f.read())
    tree_sd = payload["tree"]
    try:
        out = {k: from_state_dict(t, tree_sd[k], k) for k, t in templates.items()}
    except (ValueError, KeyError) as e:
        raise _mismatch_error(path, payload, e) from e
    return out, int(payload["step"]), json.loads(payload["config"])


# flags that define the trained function but do not all change parameter
# shapes: kvalue, knn_every and (at uniform widths) model_name alter
# predictions with checkpoints of the same shapes, so a serving run that
# forgets one would compute a different model
MODEL_FLAGS = (
    "model_name", "num_class", "kvalue", "edge_filters",
    "head_feat_dim", "head_mlp", "global_pool", "knn_every",
    "block_convs", "knn_window", "head_factorized",
)


def model_flag_diffs(cfg, saved: dict) -> dict:
    """{flag: (current, saved)} for model-defining flags that disagree
    with the checkpoint's recorded config."""
    diffs = {}
    for k in MODEL_FLAGS:
        if k not in saved or saved[k] is None:
            continue
        cur = getattr(cfg, k, None)
        sav = saved[k]
        if isinstance(cur, tuple):
            sav = tuple(sav)
        if cur != sav:
            diffs[k] = (cur, sav)
    return diffs


def adopt_model_flags(cfg, path: str | None = None, payload: dict | None = None):
    """``cfg`` with the checkpoint's model-defining flags adopted, so the
    served function is the trained one whatever flags the command line
    repeated (training flags are never touched). Prints what it adopted
    and validates the merged config."""
    if payload is None:
        payload = peek(path)
    saved = json.loads(payload.get("config", "{}"))
    diffs = model_flag_diffs(cfg, saved)
    if not diffs:
        return cfg
    repl = {
        k: (tuple(sav) if isinstance(getattr(cfg, k), tuple) else sav)
        for k, (_, sav) in diffs.items()
    }
    print(
        "adopting model flags from checkpoint: "
        + ", ".join(f"{k}={v}" for k, v in sorted(repl.items())),
        flush=True,
    )
    cfg = dataclasses.replace(cfg, **repl)
    if hasattr(cfg, "validate"):
        cfg.validate()
    return cfg


def restore(path: str, tree_template):
    """Load a checkpoint into the structure of ``tree_template``.

    Args:
      path: a ``.ckpt`` file, or a prefix (the newest step is picked).

    Returns:
      (tree, step, config_dict)
    """
    path = _resolve(path)
    with open(path, "rb") as f:
        payload = restore_bytes(f.read())
    try:
        tree = from_state_dict(tree_template, payload["tree"])
    except (ValueError, KeyError) as e:
        raise _mismatch_error(path, payload, e) from e
    return tree, int(payload["step"]), json.loads(payload["config"])
