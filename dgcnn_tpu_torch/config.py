"""Configuration and flag surface (port of `dgcnn_tpu/config.py`).

`Config` has every field of the JAX package's, with the same names,
defaults, choices and order (a checkpoint embeds ``vars(cfg)`` as JSON, so
both packages write and read the same config). ``validate()`` makes the
same checks with the same messages; ``build_parser()`` and
``parse_args()`` take the same flag vocabulary, short flags and ``-c
FILE.json`` included.

``__post_init__`` keeps the checks the port makes as a Config is built:
the JAX package's ``knn_window``, ``point_shards``, ``block_convs`` and
choice checks, the padded event size under context parallelism (and
under banded context parallelism, ``knn_window`` with ``point_shards >
1``, the JAX ``validate``'s shard-size and ``ring_impl`` checks) and the
divisibility of ``num_devices`` by ``point_shards``. ``block_convs`` is
the JAX package's int (every EdgeConv block's MLP depth) or, in the port
alone, a tuple of one depth a block (``--block_convs 2,2,1``); a tuple of
equal depths becomes the int. ``num_devices`` has
the JAX meaning: the ranks in all, ``num_devices / point_shards`` of them
data ranks (``Config(num_devices=4, point_shards=2)`` is the ``{data: 2,
points: 2}`` mesh); 0 is every visible card on CUDA and one data rank on
the CPU (`parallel.mesh.make_mesh`). ``precision`` ``default`` and ``highest``
are both full f32 (TF32 off); ``bfloat16`` is the mixed-precision model
(`models.dgcnn`), ``knn_precision="default"`` the kNN kernels' bf16
tensor-core score, and ``remat`` recomputes each EdgeConv block in
backward, keeping the kNN indices.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

from dgcnn_tpu_torch.io.batching import _round_up
from dgcnn_tpu_torch.models.dgcnn import ModelSpec, block_depths
from dgcnn_tpu_torch.parallel.mesh import make_mesh

RING_IMPLS = ("ppermute", "rdma")
# the allowed values of every enumerated field (argparse `choices` guard
# only flags given on the command line; --config files and Configs built
# in code are checked here)
CHOICES = {
    "precision": ("default", "highest", "bfloat16"),
    "knn_precision": ("highest", "default"),
    "io_type": ("h5", "npz", "csv", "dgb", "synthetic", "larcv"),
    "lr_schedule": ("constant", "cosine", "step"),
    "crop_mode": ("random", "stride"),
    "optimizer": ("adam", "adamw", "sgd", "momentum"),
    "ring_impl": RING_IMPLS,
    "block_impl": ("auto", "edge", "reduced", "fused"),
    "head_stream": ("auto", "on", "off"),
    "block_scan": ("auto", "on", "off"),
}
# the choices checked as a Config is built (the others wait for validate())
POST_INIT_CHOICES = ("optimizer", "lr_schedule", "ring_impl")


@dataclasses.dataclass
class Config:
    # command
    command: str = "train"
    # model
    model_name: str = "dgcnn"
    num_class: int = 2
    kvalue: int = 20
    num_edge_conv: int = 6
    edge_filters: Optional[tuple] = None  # default: (64,) * num_edge_conv
    head_feat_dim: int = 1024
    head_mlp: tuple = (512, 256)
    global_pool: bool = True
    dropout: float = 0.0
    bn_momentum: float = 0.9
    bn_sync: bool = True  # cross-replica BN statistics (one device: no-op)
    # training
    iteration: int = 10000
    report_step: int = 100
    checkpoint_step: int = 500
    minibatch_size: int = 4
    num_point: int = 0  # 0 -> derive from data / buckets
    seed: int = 123
    learning_rate: float = 1e-3
    optimizer: str = "adam"  # adam | adamw | sgd | momentum
    lr_schedule: str = "constant"  # constant | cosine | step
    lr_decay_steps: int = 0  # cosine horizon / step period (0 -> iteration)
    lr_decay_rate: float = 0.5  # step decay factor
    grad_clip: float = 0.0  # global-norm gradient clipping (0 = off)
    # per-class loss weight multipliers (len == num_class; composes with
    # per-point weights from the event file); empty = uniform
    class_weights: tuple = ()
    auto_resume: bool = False  # resume from the latest weight_prefix checkpoint
    max_to_keep: int = 0  # checkpoint retention; 0 = keep all
    augment: bool = False  # host-side train augmentation (z-rot/scale/jitter)
    # stop when val_loss hasn't improved for N consecutive validations
    # (0 = never; requires --val_file)
    early_stop_patience: int = 0
    # io
    io_type: str = "h5"  # h5 | npz | csv | dgb | synthetic
    input_file: str = ""
    output_file: str = ""
    val_file: str = ""  # held-out events; evaluated at report steps
    val_batches: int = 4
    data_key: str = "data"
    label_key: str = "label"
    weight_key: str = ""
    shuffle: bool = True
    buckets: tuple = (1024, 4096, 16384, 32768)
    prefetch: int = 2
    crop_mode: str = "random"  # oversized-event crop: random | stride
    # checkpoint / logging
    model_path: str = ""
    weight_prefix: str = "weights/snapshot"
    log_dir: str = "log"
    debug: bool = False
    profile_dir: str = ""
    tensorboard: bool = False
    # execution: num_devices ranks in all (0: every visible card on cuda,
    # one data rank on the cpu), num_devices / point_shards of them data
    # ranks (parallel.launch)
    num_devices: int = 0
    point_shards: int = 1  # context parallelism: shard the point axis
    use_pallas: bool = True  # the hand-written kNN kernels on cuda; False
    #                          picks the plain oracle on any device
    remat: bool = False
    # default and highest are both full f32 here (TF32 is off); bfloat16
    # runs the model's matmuls and edge tensors in bf16
    precision: str = "default"
    knn_precision: str = "highest"
    knn_every: int = 1
    knn_window: int = 0
    ring_impl: str = "ppermute"  # the exact ring's graph build: ppermute | rdma
    # per-edge convs of every EdgeConv block (an int), or of each (a tuple)
    block_convs: int | tuple = 1
    head_factorized: bool = False
    head_stream: str = "auto"
    # accepted for config parity; the port has no scanned block form
    block_scan: str = "auto"
    block_impl: str = "auto"

    def __post_init__(self):
        if self.edge_filters is None:
            self.edge_filters = (64,) * self.num_edge_conv
        else:
            self.edge_filters = tuple(self.edge_filters)
            self.num_edge_conv = len(self.edge_filters)
        self.head_mlp = tuple(self.head_mlp)
        self.class_weights = tuple(self.class_weights or ())
        self.buckets = tuple(sorted(self.buckets))
        if self.knn_window < 0:
            raise ValueError(f"knn_window must be >= 0, got {self.knn_window}")
        if self.knn_window and self.knn_window < self.kvalue:
            raise ValueError(
                f"knn_window={self.knn_window} is smaller than "
                f"KVALUE={self.kvalue}: every query needs at least k "
                f"candidates in its band"
            )
        if self.point_shards < 1:
            raise ValueError("point_shards must be >= 1")
        depths = block_depths(self.block_convs, self.num_edge_conv)
        if not isinstance(self.block_convs, int):
            # equal depths are the int: one model, one checkpoint entry
            self.block_convs = depths[0] if len(set(depths)) == 1 else depths
        for field in POST_INIT_CHOICES:
            _check_choice(self, field)
        if self.num_devices < 0:
            raise ValueError(f"num_devices must be >= 0, got {self.num_devices}")
        if self.num_devices:
            make_mesh(self.num_devices, self.point_shards)  # the divisibility check
        if self.point_shards > 1:
            # the padded event splits over the point shards; banded CP
            # exchanges window-sized halos with the next ranks only
            # (kernels.halo_knn), so there every shard of every padded
            # event size the batcher makes is at least one window wide
            sizes = (self.num_point,) if self.num_point else ()
            if self.knn_window and not self.num_point:
                sizes = self.buckets or ()
            for raw in sizes:
                n = _round_up(int(raw))
                if n % self.point_shards:
                    raise ValueError(
                        f"padded event size {n} (configured {raw}, rounded to the "
                        f"128-point lane width) not divisible by point_shards={self.point_shards}"
                    )
                if self.knn_window > n // self.point_shards:
                    raise ValueError(
                        f"knn_window={self.knn_window} exceeds the local "
                        f"shard size {n // self.point_shards} (= padded "
                        f"event size {n} / {self.point_shards} shards): "
                        f"the halo-exchange banded CP needs window <= "
                        f"points per shard. Use fewer point shards, a "
                        f"smaller window, or the exact ring (knn_window=0)."
                    )
                if self.kvalue > n // self.point_shards:
                    raise ValueError(
                        f"KVALUE={self.kvalue} exceeds the local shard size "
                        f"{n // self.point_shards} (= padded event size {n} / "
                        f"{self.point_shards} shards)"
                    )
            if self.knn_window and self.ring_impl == "rdma":
                raise ValueError(
                    "--ring_impl rdma does not apply to banded context "
                    "parallelism (--knn_window with point_shards > 1): the "
                    "banded path exchanges halos, not ring blocks. Drop "
                    "--ring_impl or use knn_window=0 for the exact RDMA ring."
                )

    def model_spec(self) -> ModelSpec:
        return ModelSpec(
            num_class=self.num_class,
            k=self.kvalue,
            edge_filters=tuple(self.edge_filters),
            residual=(self.model_name == "residual-dgcnn"),
            head_feat_dim=self.head_feat_dim,
            head_mlp=tuple(self.head_mlp),
            global_pool=self.global_pool,
            dropout=self.dropout,
            bn_momentum=self.bn_momentum,
            compute_dtype=(
                "bfloat16" if self.precision == "bfloat16" else "float32"
            ),
            remat=self.remat,
            knn_every=self.knn_every,
            knn_window=self.knn_window,
            block_impl=self.block_impl,
            block_convs=self.block_convs,
            head_factorized=self.head_factorized,
            head_stream=self.head_stream,
        )

    def validate(self):
        """Fail fast on inconsistent flags, with the JAX package's checks
        and messages (those `__post_init__` made already hold)."""
        if self.kvalue < 1:
            raise ValueError(f"KVALUE must be >= 1, got {self.kvalue}")
        min_n = self.num_point or (min(self.buckets) if self.buckets else 0)
        if min_n and self.kvalue > min_n:
            raise ValueError(
                f"KVALUE={self.kvalue} exceeds the smallest padded event "
                f"size {min_n} (num_point/buckets)"
            )
        if self.minibatch_size < 1 and not (
            self.command == "export" and self.minibatch_size == 0
        ):
            raise ValueError("MINIBATCH_SIZE must be >= 1")
        if self.num_class < 2:
            raise ValueError(f"NUM_CLASS must be >= 2, got {self.num_class}")
        if self.class_weights:
            if len(self.class_weights) != self.num_class:
                raise ValueError(
                    f"--class_weights needs {self.num_class} values "
                    f"(one per class), got {len(self.class_weights)}"
                )
            for w in self.class_weights:
                # zero or negative weights collapse the weighted mean's
                # denominator; strings from JSON would fail later
                if not isinstance(w, (int, float)) or not (w > 0):
                    raise ValueError(
                        f"--class_weights must be positive numbers, "
                        f"got {w!r}"
                    )
        if self.early_stop_patience < 0:
            raise ValueError("early_stop_patience must be >= 0")
        if self.early_stop_patience and not self.val_file:
            raise ValueError("--early_stop_patience requires --val_file")
        if self.knn_every < 1:
            raise ValueError(f"knn_every must be >= 1, got {self.knn_every}")
        if self.head_factorized and self.global_pool and not self.head_mlp:
            raise ValueError(
                "head_factorized needs at least one head_mlp layer to "
                "factorize (the output dense would otherwise consume the "
                "concat directly)"
            )
        for field in CHOICES:
            _check_choice(self, field)
        if self.command == "inference" and not self.model_path:
            raise ValueError("inference requires --model_path")
        if self.command == "export":
            if not self.model_path:
                raise ValueError("export requires --model_path")
            if not self.output_file:
                raise ValueError("export requires --output_file")
            if self.num_point <= 0:
                raise ValueError(
                    "export requires --num_point (static serving shape)"
                )
        return self

    def summary(self) -> str:
        """One flag per line, the startup echo."""
        d = dataclasses.asdict(self)
        return "\n".join(f"  {k:18s} = {d[k]}" for k in sorted(d))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=list)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def _check_choice(cfg, field: str) -> None:
    allowed = CHOICES[field]
    if getattr(cfg, field) not in allowed:
        raise ValueError(f"{field} must be one of {allowed}, got {getattr(cfg, field)!r}")


def _block_convs(text: str):
    """``--block_convs``: ``2`` (every block) or ``2,2,1`` (one a block)."""
    try:
        depths = tuple(int(d) for d in text.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(f"not an int or a comma-separated list of ints: "
                                         f"{text!r}") from None
    return depths[0] if len(depths) == 1 else depths


def _add_common_flags(p: argparse.ArgumentParser):
    p.add_argument("-c", "--config", default=None, metavar="FILE.json",
                   help="load flag defaults from a JSON config (e.g. a "
                   "checkpoint's embedded config or Config.to_json()); "
                   "explicit CLI flags override")
    g = p.add_argument_group("model")
    g.add_argument("-mn", "--model_name", default="dgcnn",
                   help="dgcnn | residual-dgcnn (reference MODEL_NAME)")
    g.add_argument("-nc", "--num_class", type=int, default=2)
    g.add_argument("-k", "--kvalue", type=int, default=20,
                   help="neighbor count for the dynamic kNN graph (KVALUE)")
    g.add_argument("-ec", "--num_edge_conv", type=int, default=6)
    g.add_argument("--edge_filters", type=int, nargs="*", default=None,
                   help="per-block EdgeConv widths; overrides num_edge_conv")
    g.add_argument("--head_feat_dim", type=int, default=1024)
    g.add_argument("--head_mlp", type=int, nargs="*", default=[512, 256])
    g.add_argument("--no_global_pool", dest="global_pool", action="store_false")
    g.add_argument("--dropout", type=float, default=0.0)
    g.add_argument("--bn_momentum", type=float, default=0.9)
    g.add_argument("--no_bn_sync", dest="bn_sync", action="store_false",
                   help="per-replica BN statistics instead of synced ones")

    g = p.add_argument_group("io")
    g.add_argument("-io", "--io_type", default="h5",
                   choices=["h5", "npz", "csv", "dgb", "larcv", "synthetic"])
    g.add_argument("-if", "--input_file", default="")
    g.add_argument("-of", "--output_file", default="")
    g.add_argument("-vf", "--val_file", default="",
                   help="held-out event file; evaluated at report steps")
    g.add_argument("--val_batches", type=int, default=4)
    g.add_argument("--data_key", default="data")
    g.add_argument("--label_key", default="label")
    g.add_argument("--weight_key", default="")
    g.add_argument("-mb", "--minibatch_size", type=int, default=4)
    g.add_argument("-np", "--num_point", type=int, default=0,
                   help="fixed point budget per event; 0 = bucketed")
    g.add_argument("--buckets", type=int, nargs="*",
                   default=[1024, 4096, 16384, 32768])
    g.add_argument("--prefetch", type=int, default=2)
    g.add_argument("--no_shuffle", dest="shuffle", action="store_false")
    g.add_argument("--crop_mode", default="random",
                   choices=["random", "stride"],
                   help="oversized-event subsampling: seeded stratified "
                   "random (default) or deterministic stride; identical "
                   "across all readers incl. the C++ DGB path")

    g = p.add_argument_group("run")
    g.add_argument("--seed", type=int, default=123)
    g.add_argument("-mp", "--model_path", default="",
                   help="checkpoint to restore (resume / inference)")
    g.add_argument("-wp", "--weight_prefix", default="weights/snapshot")
    g.add_argument("-ld", "--log_dir", default="log")
    g.add_argument("--debug", action="store_true")
    g.add_argument("--profile_dir", default="",
                   help="write a torch.profiler Chrome trace of the run here")
    g.add_argument("--tensorboard", action="store_true",
                   help="also write TensorBoard scalar summaries")

    g = p.add_argument_group("device")
    g.add_argument("-nd", "--num_devices", type=int, default=0,
                   help="device count: num_devices / point_shards data-parallel "
                   "ranks (0 = every visible card on cuda, one on the cpu)")
    g.add_argument("-ps", "--point_shards", type=int, default=1,
                   help="context parallelism: shard each event's points "
                   "over this many devices (ring kNN)")
    g.add_argument("--no_pallas", dest="use_pallas", action="store_false",
                   help="plain PyTorch graph builds instead of the "
                   "hand-written CUDA kernels")
    g.add_argument("--precision", default="default",
                   choices=["default", "highest", "bfloat16"])
    g.add_argument("--knn_precision", default="highest",
                   choices=["highest", "default"],
                   help="kNN score precision: highest = fp32 (the kernels' "
                   "graph equals the f32 oracle's); default = one bf16 pass on "
                   "the tensor cores (near-ties may swap)")
    g.add_argument("--knn_every", type=int, default=1,
                   help="rebuild the dynamic kNN graph every N EdgeConv "
                   "blocks (1 = reference per-block semantics)")
    g.add_argument("--knn_window", type=int, default=0,
                   help="banded sub-quadratic kNN: 0 = exact; > 0 sorts "
                   "each event along a Morton curve and restricts every "
                   "graph build to this many consecutive sorted positions "
                   "per query (model-defining)")
    g.add_argument("--ring_impl", default="ppermute",
                   choices=["ppermute", "rdma"],
                   help="context-parallel ring: ppermute = the exact kernel "
                   "block by block; rdma = the ring kernel, one launch a "
                   "ring step")
    g.add_argument("--remat", action="store_true",
                   help="recompute each EdgeConv block in backward "
                   "(trade FLOPs for device memory at large NUM_POINT; the "
                   "kNN indices are kept)")
    g.add_argument("--block_convs", type=_block_convs, default=1,
                   help="stacked shared-MLP convs per EdgeConv block: one "
                   "for all (2) or one a block (2,2,1) (model-defining)")
    g.add_argument("--head_factorized", action="store_true",
                   help="factorize the first head-MLP dense over the "
                   "[agg, pooled-global] concat (model-defining)")
    g.add_argument("--head_stream", default="auto",
                   choices=["auto", "on", "off"],
                   help="streamed (chunked) head: auto = at >= 2**30 "
                   "row-elements; on = always; off = never")
    g.add_argument("--block_scan", default="auto",
                   choices=["auto", "on", "off"],
                   help="accepted for config parity with the JAX package")
    g.add_argument("--block_impl", default="auto",
                   choices=["auto", "edge", "reduced", "fused"],
                   help="EdgeConv block implementation: auto = fused for "
                   "depth-1 blocks, edge otherwise")


def build_parser(defaults: dict | None = None) -> argparse.ArgumentParser:
    """``defaults`` (from --config) override argument-level defaults on
    every subcommand; explicit CLI flags still win over both."""
    p = argparse.ArgumentParser(
        prog="dgcnn_tpu_torch",
        description="dynamic graph CNN trainer for sparse 3D point-cloud "
        "semantic segmentation (PyTorch/CUDA)",
    )
    sub = p.add_subparsers(dest="command", required=True)
    tr = sub.add_parser("train", help="train a model")
    _add_common_flags(tr)
    tr.add_argument("-i", "--iteration", type=int, default=10000)
    tr.add_argument("-rs", "--report_step", type=int, default=100)
    tr.add_argument("-cs", "--checkpoint_step", type=int, default=500)
    tr.add_argument("-lr", "--learning_rate", type=float, default=1e-3)
    tr.add_argument("-opt", "--optimizer", default="adam",
                    choices=["adam", "adamw", "sgd", "momentum"])
    tr.add_argument("--lr_schedule", default="constant",
                    choices=["constant", "cosine", "step"])
    tr.add_argument("--lr_decay_steps", type=int, default=0,
                    help="cosine horizon / step period (0 = --iteration)")
    tr.add_argument("--lr_decay_rate", type=float, default=0.5)
    tr.add_argument("--class_weights", type=float, nargs="+", default=(),
                    help="per-class loss weight multipliers (one per "
                    "class; composes with per-point file weights)")
    tr.add_argument("--grad_clip", type=float, default=0.0,
                    help="clip gradients to this global norm (0 = off)")
    tr.add_argument("--auto_resume", action="store_true",
                    help="resume from the latest weight_prefix checkpoint "
                    "if one exists (preemption-friendly)")
    tr.add_argument("--max_to_keep", type=int, default=0,
                    help="keep only the newest N checkpoints (0 = keep all)")
    tr.add_argument("--early_stop_patience", type=int, default=0,
                    help="stop when val_loss hasn't improved for N "
                    "consecutive validations (0 = never; needs -vf)")
    tr.add_argument("--augment", action="store_true",
                    help="seeded train-time augmentation on the host: "
                    "random z-rotation, scale 0.95-1.05, coord jitter")

    inf = sub.add_parser("inference", help="run inference + write-back")
    _add_common_flags(inf)
    inf.add_argument("-i", "--iteration", type=int, default=0,
                     help="max batches (0 = whole input file)")

    exp = sub.add_parser(
        "export", help="serialize a checkpoint to a serving artifact"
    )
    _add_common_flags(exp)
    sub.add_parser(
        "info", help="print environment/runtime diagnostics and exit"
    )
    if defaults:
        for sp in (tr, inf, exp):
            sp.set_defaults(**defaults)
    return p


def parse_args(argv=None) -> Config:
    import sys as _sys

    argv = list(_sys.argv[1:] if argv is None else argv)
    # --config FILE supplies defaults; explicit flags override. The path
    # is taken by an exact token scan: argparse's prefix matching would
    # read -cs (checkpoint_step) as "-c s" and --conf as --config
    config_path = None
    rest = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok in ("-c", "--config"):
            if i + 1 >= len(argv):
                raise SystemExit(f"{tok} requires a file path")
            config_path = argv[i + 1]
            i += 2
            continue
        if tok.startswith("--config="):
            config_path = tok.split("=", 1)[1]
            i += 1
            continue
        rest.append(tok)
        i += 1
    overrides = None
    if config_path:
        with open(config_path) as f:
            loaded = json.load(f)
        fields = {f_.name for f_ in dataclasses.fields(Config)}
        unknown = sorted(set(loaded) - fields)
        if unknown:
            raise SystemExit(
                f"--config {config_path}: unknown keys {unknown}"
            )
        skip = {"command"}  # the subcommand comes from the CLI
        requested = next((t for t in rest if not t.startswith("-")), None)
        if requested != "train" and "iteration" in loaded:
            # `iteration` is train steps on train but max batches (0 = the
            # whole file) on inference: a train config must not truncate
            # a prediction file
            print(
                f"--config: skipping train-only key 'iteration' for "
                f"{requested} (pass -i explicitly to bound batches)",
                flush=True,
            )
            skip.add("iteration")
        overrides = {
            k: tuple(v) if isinstance(v, list) else v
            for k, v in loaded.items()
            if k not in skip
        }
    ns = build_parser(overrides).parse_args(rest)
    d = vars(ns)
    if d.pop("config", None) is not None:
        # a joined -cFILE or an abbreviated --conf reached the parser
        raise SystemExit(
            "--config must be passed as '-c FILE', '--config FILE' or "
            "'--config=FILE' (joined/abbreviated forms are not supported)"
        )
    return Config.from_dict(d)


def print_info() -> int:
    """`dgcnn_tpu_torch info`: the environment facts a bug report needs:
    versions, the card's name and power limit, the kernel build directory
    and whether the native DGB reader is active."""
    import platform
    import shutil
    import subprocess

    import torch

    import dgcnn_tpu_torch
    from dgcnn_tpu_torch.io import native
    from dgcnn_tpu_torch.kernels import _build

    print(f"dgcnn_tpu_torch {dgcnn_tpu_torch.__version__}")
    print(f"python      {platform.python_version()} ({platform.machine()})")
    print(f"torch       {torch.__version__} (CUDA {torch.version.cuda})")
    if torch.cuda.is_available():
        from dgcnn_tpu_torch.parallel.mesh import choose_backend

        n = torch.cuda.device_count()
        print(f"device      cuda ({n} card(s))")
        for i in range(n):
            print(f"  - cuda:{i} {torch.cuda.get_device_name(i)}")
        backend, staged = choose_backend(max(n, 2), "cuda")
        print(f"data par.   -nd 0 runs {n} rank(s); {max(n, 2)} ranks run {backend}"
              + (" (ranks share a card, staged through pinned host memory)" if staged else ""))
        smi = shutil.which("nvidia-smi")
        if smi:
            out = subprocess.run(
                [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60,
            )
            for line in out.stdout.strip().splitlines():
                print(f"  nvidia-smi: {line}")
    else:
        print("device      cpu only (no CUDA device; entry points need device='cpu')")
        print("data par.   -nd N runs N gloo ranks on the cpu (device='cpu')")
    print(f"kernels     {_build.BUILD_DIR}")
    lib = native.load()
    print(
        "native IO   "
        + (f"{native.library_path()} loaded (C++ batch assembler active)"
           if lib is not None
           else "unavailable (pure-Python DGB fallback in use)")
    )
    return 0
