"""Configuration (port of `dgcnn_tpu/config.py::Config`).

Only the fields the serving and single-device training paths read are
ported, with the JAX package's names, defaults and choices, plus
``__post_init__`` (the reference's ``knn_window``, ``point_shards`` and
choice checks, with the padded event size taken from ``num_point``) and
``model_spec()``. Context parallelism serves with one
data replica: ``num_devices`` is 0 (the point shards) or
``point_shards``; a data axis waits for ROADMAP queue 1, item 12, and
``knn_window`` with ``point_shards > 1`` (banded CP) for item 13. The
argparse flag surface waits for the CLI slice (item 8).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from dgcnn_tpu_torch.io.batching import _round_up
from dgcnn_tpu_torch.models.dgcnn import ModelSpec, not_ported

RING_IMPLS = ("ppermute", "rdma")
# the JAX Config's choices for the fields ported here
CHOICES = {
    "optimizer": ("adam", "adamw", "sgd", "momentum"),
    "lr_schedule": ("constant", "cosine", "step"),
    "ring_impl": RING_IMPLS,
}


@dataclasses.dataclass
class Config:
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
    learning_rate: float = 1e-3
    optimizer: str = "adam"  # adam | adamw | sgd | momentum
    lr_schedule: str = "constant"  # constant | cosine | step
    lr_decay_steps: int = 0  # cosine horizon / step period (0 -> iteration)
    lr_decay_rate: float = 0.5  # step decay factor
    grad_clip: float = 0.0  # global-norm gradient clipping (0 = off)
    # batching
    minibatch_size: int = 4
    num_point: int = 0  # 0 -> derive from data / buckets
    seed: int = 123
    # per-class loss weight multipliers (len == num_class; composes with
    # per-point weights from the event file); empty = uniform
    class_weights: tuple = ()
    # parallelism: one process per point shard (parallel.launch)
    num_devices: int = 0  # 0 -> point_shards (one data replica)
    point_shards: int = 1  # context parallelism: shard the point axis
    ring_impl: str = "ppermute"  # the exact ring's graph build: ppermute | rdma
    # execution
    use_pallas: bool = True  # the hand-written kNN kernel on cuda; False
    #                          picks the plain oracle on any device
    remat: bool = False
    # default and highest are both full f32 here (TF32 is off); bfloat16
    # raises until mixed precision is ported
    precision: str = "default"
    knn_precision: str = "highest"
    knn_every: int = 1
    knn_window: int = 0
    block_convs: int = 1
    head_factorized: bool = False
    head_stream: str = "auto"
    block_impl: str = "auto"

    def __post_init__(self):
        if self.edge_filters is None:
            self.edge_filters = (64,) * self.num_edge_conv
        else:
            self.edge_filters = tuple(self.edge_filters)
            self.num_edge_conv = len(self.edge_filters)
        self.head_mlp = tuple(self.head_mlp)
        self.class_weights = tuple(self.class_weights or ())
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
        if self.block_convs < 1:
            raise ValueError(f"block_convs must be >= 1, got {self.block_convs}")
        for field, allowed in CHOICES.items():
            if getattr(self, field) not in allowed:
                raise ValueError(f"{field} must be one of {allowed}, got {getattr(self, field)!r}")
        if self.num_devices not in (0, self.point_shards):
            raise not_ported(
                f"num_devices={self.num_devices} with point_shards={self.point_shards} "
                f"(a data-parallel mesh axis)", "12")
        if self.knn_window and self.point_shards > 1:
            raise not_ported("knn_window with point_shards > 1 (banded context parallelism)", "13")
        if self.point_shards > 1 and self.num_point:
            n = _round_up(int(self.num_point))
            if n % self.point_shards:
                raise ValueError(
                    f"padded event size {n} (configured {self.num_point}, rounded to the "
                    f"128-point lane width) not divisible by point_shards={self.point_shards}"
                )
            if self.kvalue > n // self.point_shards:
                raise ValueError(
                    f"KVALUE={self.kvalue} exceeds the local shard size "
                    f"{n // self.point_shards} (= padded event size {n} / "
                    f"{self.point_shards} shards)"
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
