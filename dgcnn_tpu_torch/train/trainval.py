"""Trainer, eval path (port of `dgcnn_tpu/train/trainval.py::Trainval`).

Builds the model and its kNN function and serves eval-mode forwards:
``Trainval(cfg).initialize(in_dim)`` then ``inference(state, batch)``.
The eval math is the JAX package's ``device_eval``: a packed
``(B, N, C+2)`` array of softmax scores, argmax prediction and the batch
loss; the class-weighted mean cross entropy; the masked confusion matrix.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without ``device="cpu"`` they raise. The constructor
turns TF32 off for matmuls and cuDNN, because the reference is f32 and
TF32 changes the kNN graph.

Context parallelism (``point_shards > 1``): one `Trainval` runs on each
rank of a point-shard group (`parallel.launch.run_point_ranks`, which
hands each rank its `parallel.mesh.PointGroup`), with the ring graph ops
of `parallel.context_parallel.cp_graph_ops` in the model. Every rank reads
the same global batch and cuts its contiguous point shard out of it; the
loss sums, the weight sum and the confusion matrix are summed over the
group, and the packed output is all-gathered along the points, so every
rank returns the whole batch's scores. ``ring_impl="rdma"`` launches the
hand-written ring kernel on CUDA and runs its plain merge on the CPU (the
JAX package refuses ``rdma`` on CPU meshes only because its interpreter
cannot emulate remote DMA).

Training (the optimizer, ``train_step``) arrives with the training slice
(ROADMAP queue 1, item 6); ``initialize`` returns no optimizer state.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from dgcnn_tpu_torch.bridge import tree_map
from dgcnn_tpu_torch.models import get_model
from dgcnn_tpu_torch.models.dgcnn import default_knn_fn, not_ported
from dgcnn_tpu_torch.parallel.collectives import all_gather_points, psum_points
from dgcnn_tpu_torch.parallel.context_parallel import cp_graph_ops


class TrainState(NamedTuple):
    params: Any  # {"blocks": [...], "head": {...}} of tensors
    model_state: Any  # BN running statistics


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when the
    device is CUDA and there is no GPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: dgcnn_tpu_torch runs on the GPU unless the "
            "caller passes device='cpu'"
        )
    return device


def disable_tf32() -> None:
    """f32 matmuls and convolutions in full f32, as the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def knn_fn_for(device: torch.device, use_pallas: bool, knn_precision: str,
               knn_window: int):
    """The trainer's kNN function, named explicitly: the hand-written
    kernel (exact, or banded with ``knn_window > 0``) on CUDA with
    ``use_pallas``, the plain oracle on the CPU or with ``use_pallas`` off
    (the ``--no_pallas`` debug knob); see `models.dgcnn.default_knn_fn`."""
    if knn_precision != "highest":
        raise not_ported(f"knn_precision={knn_precision!r}", "10")
    return default_knn_fn(device, use_pallas, knn_window)


class Trainval:
    """Build once per run; owns the model and the eval step."""

    def __init__(self, cfg, device=None, group=None):
        self.cfg = cfg
        self.point_shards = int(cfg.point_shards)
        self.group = group
        if self.point_shards > 1:
            if group is None or group.size != self.point_shards:
                raise ValueError(
                    f"point_shards={self.point_shards}: Trainval runs on each rank of a "
                    f"group of {self.point_shards} (parallel.launch.run_point_ranks) and "
                    f"takes its PointGroup"
                )
            if device is not None and torch.device(device).type != group.device.type:
                raise ValueError(f"device {device} is not the group's {group.device}")
            self.device = resolve_device(group.device)
        else:
            self.device = resolve_device(device)
        disable_tf32()
        if self.point_shards > 1:
            ops = cp_graph_ops(group, impl=cfg.ring_impl, knn_precision=cfg.knn_precision,
                               use_kernel=cfg.use_pallas)
            self.model = get_model(
                cfg.model_name, cfg.model_spec(), knn_fn=ops.knn, gather_fn=ops.gather,
                pool_fn=ops.pool, gather_extend_fn=ops.extend, gather_localize_fn=ops.localize,
            )
        else:
            knn_fn = knn_fn_for(self.device, cfg.use_pallas, cfg.knn_precision, cfg.knn_window)
            self.model = get_model(cfg.model_name, cfg.model_spec(), knn_fn=knn_fn)
        cw = _class_weights_of(cfg)
        self._cls_w = None if cw is None else cw.to(self.device)

    def initialize(self, in_dim: int, generator: torch.Generator | None = None) -> TrainState:
        """Glorot init from ``generator`` (default: seeded with
        ``cfg.seed``), drawn on the CPU and moved to the device."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        params, mstate = self.model.init(in_dim, generator)
        to = lambda t: t.to(self.device)  # noqa: E731
        return TrainState(tree_map(to, params), tree_map(to, mstate))

    # ----------------------------------------------------------- eval step

    @torch.inference_mode()
    def _eval(self, state: TrainState, batch, packed: bool):
        points, labels, weights, mask = self._put_batch(batch)
        logits, _ = self.model(state.params, state.model_state, points, mask)
        num_class = self.cfg.num_class
        pred = torch.argmax(logits, dim=-1)
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels[..., None])[..., 0]
        w = weights * mask.to(logits.dtype)
        if self._cls_w is not None:
            # same objective as training: the class-weighted loss
            w = w * self._cls_w[labels]
        loss_sum = -torch.sum(ll * w)
        w_sum = torch.sum(w)
        cls = torch.arange(num_class, device=labels.device)
        m = mask.reshape(-1).to(torch.float32)
        t1h = (labels.reshape(-1)[:, None] == cls).to(torch.float32) * m[:, None]
        p1h = (pred.reshape(-1)[:, None] == cls).to(torch.float32)
        cm = t1h.T @ p1h
        if self.point_shards > 1:
            loss_sum, w_sum, cm = (psum_points(t, self.group) for t in (loss_sum, w_sum, cm))
        loss = loss_sum / torch.clamp(w_sum, min=1e-9)
        metrics = {"loss": loss, "loss_weight": w_sum, "confusion": cm}
        if not packed:
            return metrics
        scores = torch.softmax(logits, dim=-1)
        out = torch.cat(
            [
                scores,
                pred.to(torch.float32)[..., None],
                loss.expand(pred.shape)[..., None],
            ],
            dim=-1,
        )
        if self.point_shards > 1:
            out = all_gather_points(out, self.group, axis=1)
        return out, metrics

    def inference_packed(self, state: TrainState, batch):
        """Eval-mode forward returning ``(packed (B, N, C+2), metrics)``:
        ``packed[..., :C]`` softmax scores, ``packed[..., C]`` the argmax
        prediction and ``packed[..., C+1]`` the batch loss, all f32."""
        return self._eval(state, batch, packed=True)

    def inference(self, state: TrainState, batch):
        """Forward pass in eval mode. Returns ``(scores (B, N, C), pred
        (B, N) int32, metrics)``; metrics hold ``loss``, ``loss_weight``
        and the ``confusion`` matrix (rows truth, columns prediction)."""
        packed, metrics = self.inference_packed(state, batch)
        scores = packed[..., : self.cfg.num_class]
        pred = packed[..., self.cfg.num_class].to(torch.int32)
        return scores, pred, metrics

    def evaluate(self, state: TrainState, batch) -> dict:
        """Metrics only (loss, loss weight, confusion)."""
        return self._eval(state, batch, packed=False)

    # ------------------------------------------------------------- helpers

    def _put_batch(self, batch):
        """A `Batch` (any object with its fields) or a tuple
        ``(points, labels, weights or None, mask)`` -> device tensors.
        Under context parallelism: this rank's contiguous point shard."""
        if hasattr(batch, "points"):
            points, labels, mask = batch.points, batch.labels, batch.mask
            weights = batch.weights
        else:
            points, labels, weights, mask = batch
        if weights is None:
            weights = np.ones(np.shape(labels), np.float32)
        if self.point_shards > 1:
            n, p = np.shape(labels)[1], self.point_shards
            if n % p:
                raise ValueError(f"event size {n} not divisible by point_shards={p}")
            nl = n // p
            if self.cfg.kvalue > nl:
                raise ValueError(f"KVALUE={self.cfg.kvalue} exceeds the local shard size {nl}")
            rows = slice(self.group.rank * nl, (self.group.rank + 1) * nl)
            points, labels, weights, mask = (
                np.asarray(a)[:, rows] for a in (points, labels, weights, mask))

        def put(x, dtype):
            return torch.as_tensor(np.asarray(x)).to(self.device, dtype)

        return (
            put(points, torch.float32),
            put(labels, torch.int64),
            put(weights, torch.float32),
            put(mask, torch.bool),
        )


def _class_weights_of(cfg):
    """``(num_class,)`` f32 tensor from ``class_weights``, or None."""
    cw = tuple(getattr(cfg, "class_weights", None) or ())
    return torch.tensor(cw, dtype=torch.float32) if cw else None
