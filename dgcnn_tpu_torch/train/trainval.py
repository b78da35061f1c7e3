"""Trainer (port of `dgcnn_tpu/train/trainval.py::Trainval`).

Builds the model, its kNN function and the optimizer:
``Trainval(cfg).initialize(in_dim)``, then ``train_step(state, batch)``
(single device) or ``inference(state, batch)``. The eval math is the JAX
package's ``device_eval``: a packed ``(B, N, C+2)`` array of softmax
scores, argmax prediction and the batch loss; the class-weighted mean
cross entropy; the masked confusion matrix. The train step is its
``device_step``: the train-mode forward, the class-weighted global mean
cross entropy ``sum(w l) / max(sum(w), 1e-9)``, the gradient by autograd,
one optimizer step and the new BN state. The optimizers and learning-rate
schedules reproduce the optax ones the JAX package builds
(`_make_optimizer`, `_make_lr`); parameters and optimizer moments are
updated in place (the JAX step returns new trees), so a step holds no
second copy of them.

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

Training under context parallelism waits for ROADMAP queue 1, item 13:
``train_step`` raises there.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from dgcnn_tpu_torch.bridge import tree_leaves, tree_map
from dgcnn_tpu_torch.models import get_model
from dgcnn_tpu_torch.models.dgcnn import default_knn_fn, not_ported
from dgcnn_tpu_torch.parallel.collectives import all_gather_points, psum_points
from dgcnn_tpu_torch.parallel.context_parallel import cp_graph_ops


class TrainState(NamedTuple):
    params: Any  # {"blocks": [...], "head": {...}} of tensors
    model_state: Any  # BN running statistics
    opt_state: Any = None  # the optimizer's moments, over the params' leaves
    step: int = 0  # train steps taken
    # dropout's random stream: a generator on the device, seeded with
    # cfg.seed by `Trainval.initialize`; each train step draws its dropout
    # masks from it, head layer by head layer, so it advances by what the
    # step drew (nothing at dropout 0)
    rng: Any = None


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
    """Build once per run; owns the model, the optimizer and the steps.

    ``knn_fn`` replaces the graph build (as the JAX ``Trainval`` takes it),
    e.g. to pin the graph in a test."""

    def __init__(self, cfg, device=None, group=None, knn_fn=None):
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
                cfg.model_name, cfg.model_spec(), knn_fn=knn_fn or ops.knn, gather_fn=ops.gather,
                pool_fn=ops.pool, gather_extend_fn=ops.extend, gather_localize_fn=ops.localize,
            )
        else:
            knn_fn = knn_fn or knn_fn_for(self.device, cfg.use_pallas, cfg.knn_precision,
                                          cfg.knn_window)
            self.model = get_model(cfg.model_name, cfg.model_spec(), knn_fn=knn_fn)
        cw = _class_weights_of(cfg)
        self._cls_w = None if cw is None else cw.to(self.device)
        self._lr = _make_lr(cfg)
        self.opt = _make_optimizer(cfg.optimizer, cfg.grad_clip)

    def initialize(self, in_dim: int, generator: torch.Generator | None = None) -> TrainState:
        """Glorot init from ``generator`` (default: seeded with
        ``cfg.seed``), drawn on the CPU and moved to the device; the
        optimizer's zero state over the parameter leaves in tree order;
        step 0; the dropout generator on the device, seeded with
        ``cfg.seed``."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        params, mstate = self.model.init(in_dim, generator)
        to = lambda t: t.to(self.device)  # noqa: E731
        return self.with_params(tree_map(to, params), tree_map(to, mstate))

    def with_params(self, params, model_state) -> TrainState:
        """A fresh `TrainState` around given parameters (e.g. bridged from
        the JAX package): a zero optimizer state, step 0 and the dropout
        generator seeded with ``cfg.seed``."""
        rng = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        return TrainState(params, model_state, self.opt.init(tree_leaves(params)), 0, rng)

    def lr_at(self, step: int) -> float:
        """The learning rate of the update taken at ``step`` (the count of
        updates before it)."""
        return self._lr(step)

    # ---------------------------------------------------------- train step

    def train_step(self, state: TrainState, batch):
        """One optimization step: ``(new_state, metrics)`` with ``loss``
        (the class-weighted global mean cross entropy), ``acc`` and
        ``class_acc`` (per-class recall). Runs with autograd on, never
        under ``inference_mode``; on CUDA its graph builds launch the kNN
        kernel (`knn_fn_for`)."""
        if self.point_shards > 1:
            raise not_ported("training under context parallelism", "13")
        if state.opt_state is None:
            raise ValueError("the state has no optimizer state: build it with initialize() "
                             "or with_params()")
        points, labels, weights, mask = self._put_batch(batch)
        leaves = tree_leaves(state.params)
        # the same storage, as leaves of this step's autograd graph
        live = tree_map(lambda t: t.detach().requires_grad_(True), state.params)
        with torch.enable_grad():
            logits, new_mstate = self.model(live, state.model_state, points, mask, train=True,
                                            generator=state.rng)
            loss, w_sum = _weighted_loss(logits, labels, weights, mask, self._cls_w)
            grads = torch.autograd.grad(loss, tree_leaves(live))
        with torch.no_grad():
            self.opt.update(leaves, list(grads), state.opt_state, self._lr(state.step))
            pred = torch.argmax(logits, dim=-1)
            valid = mask.to(torch.float32)
            acc = torch.sum((pred == labels).to(torch.float32) * valid) / torch.clamp(
                torch.sum(valid), min=1.0)
            cls = torch.arange(self.cfg.num_class, device=labels.device)
            is_cls = (labels[..., None] == cls) & mask[..., None]
            total = is_cls.sum(dim=(0, 1)).to(torch.float32)
            correct = (is_cls & (pred == labels)[..., None]).sum(dim=(0, 1)).to(torch.float32)
            class_acc = correct / torch.clamp(total, min=1.0)
        new_mstate = tree_map(lambda t: t.detach(), new_mstate)
        metrics = {"loss": loss.detach(), "acc": acc, "class_acc": class_acc}
        return TrainState(state.params, new_mstate, state.opt_state, state.step + 1,
                          state.rng), metrics

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


def _weighted_loss(logits, labels, weights, mask, cls_w):
    """``(loss, weight sum)``: the class-weighted mean cross entropy
    ``-sum(w log p) / max(sum(w), 1e-9)``, ``w = weights * mask (*
    cls_w[labels])``."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    w = weights * mask.to(logits.dtype)
    if cls_w is not None:
        w = w * cls_w[labels]
    w_sum = torch.sum(w)
    return -torch.sum(ll * w) / torch.clamp(w_sum, min=1e-9), w_sum


def _make_lr(cfg):
    """The learning rate as a function of the update count (optax's
    schedules, evaluated at the count before the update): constant;
    cosine ``base (1 + cos(pi min(t, T) / T)) / 2``; step ``base
    rate^floor(t / T)``; ``T = lr_decay_steps or max(iteration, 1)``."""
    base = float(cfg.learning_rate)
    horizon = cfg.lr_decay_steps or max(cfg.iteration, 1)
    if cfg.lr_schedule == "constant":
        return lambda t: base
    if cfg.lr_schedule == "cosine":
        return lambda t: base * 0.5 * (1.0 + math.cos(math.pi * min(t, horizon) / horizon))
    if cfg.lr_schedule == "step":
        return lambda t: base * float(cfg.lr_decay_rate) ** (t // horizon)
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


class _Optimizer:
    """The optax optimizers of the JAX package over a list of parameter
    leaves, updated in place.

    - ``adam``: betas (0.9, 0.999), eps 1e-8 outside the square root, bias
      corrections ``1 - beta^t`` in float32;
    - ``adamw``: Adam plus ``1e-4 * param`` (optax's default weight decay;
      torch's own default is 1e-2), scaled by the learning rate with it;
    - ``sgd``; ``momentum``: the trace ``t = g + 0.9 t``.

    ``grad_clip > 0`` first scales the gradients as optax's
    ``clip_by_global_norm``: ``g`` if the global norm is below the limit,
    else ``g / norm * limit`` (no epsilon).
    """

    def __init__(self, name: str, grad_clip: float = 0.0):
        if name not in ("adam", "adamw", "sgd", "momentum"):
            raise ValueError(f"unknown optimizer {name!r}")
        self.name = name
        self.grad_clip = float(grad_clip or 0.0)

    def init(self, leaves):
        """The zero state: ``{"count", "mu", "nu"}`` (Adam), ``{"trace"}``
        (momentum) or ``{}`` (sgd), moments aligned with ``leaves``."""
        if self.name in ("adam", "adamw"):
            return {"count": 0, "mu": [torch.zeros_like(t) for t in leaves],
                    "nu": [torch.zeros_like(t) for t in leaves]}
        if self.name == "momentum":
            return {"trace": [torch.zeros_like(t) for t in leaves]}
        return {}

    @torch.no_grad()
    def update(self, leaves, grads, state, lr: float) -> None:
        """One step on ``leaves`` in place from ``grads`` at rate ``lr``."""
        if self.grad_clip > 0:
            norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
            keep = norm < self.grad_clip
            grads = [torch.where(keep, g, g / norm * self.grad_clip) for g in grads]
        if self.name in ("adam", "adamw"):
            state["count"] += 1
            t = np.int32(state["count"])
            c1 = float(np.float32(1) - np.float32(0.9) ** t)
            c2 = float(np.float32(1) - np.float32(0.999) ** t)
            for p, g, mu, nu in zip(leaves, grads, state["mu"], state["nu"]):
                mu.mul_(0.9).add_(0.1 * g)  # (1 - b1) g + b1 mu
                nu.mul_(0.999).add_(0.001 * torch.square(g))
                u = (mu / c1) / (torch.sqrt(nu / c2) + 1e-8)
                if self.name == "adamw":
                    u = u + 1e-4 * p
                p.add_(-lr * u)
        elif self.name == "momentum":
            for p, g, tr in zip(leaves, grads, state["trace"]):
                tr.mul_(0.9).add_(g)
                p.add_(-lr * tr)
        else:
            for p, g in zip(leaves, grads):
                p.add_(-lr * g)


def _make_optimizer(name: str, grad_clip: float = 0.0) -> _Optimizer:
    """The JAX package's `_make_optimizer`: ``name`` with global-norm
    clipping first when ``grad_clip > 0``. The learning rate comes with
    each update (`_make_lr`)."""
    return _Optimizer(name, grad_clip)


def _class_weights_of(cfg):
    """``(num_class,)`` f32 tensor from ``class_weights``, or None."""
    cw = tuple(getattr(cfg, "class_weights", None) or ())
    return torch.tensor(cw, dtype=torch.float32) if cw else None
