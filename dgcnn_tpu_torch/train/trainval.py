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

Data parallelism (a rank group whose data axis holds D > 1 ranks,
`parallel.launch.run_ranks`): one `Trainval` runs on each rank and takes
its `parallel.mesh.RankGroup`. Every rank is handed the same global batch
and computes on its contiguous rows (under several hosts: its rows of the
host's share). The parameters are replicated, rank 0's broadcast when a
state is made or loaded. The JAX package's implicit ``shard_map``
collectives are explicit here: each rank's autograd objective is its
``sum(w l)`` over the all-reduced global ``sum(w)``, BN statistics merge
over the data axis in every train BN layer (``bn_sync``, the default;
`ops.norm.finalize_batch_stats`), and one all-reduce of the flat
gradient (`parallel.collectives.all_reduce_grads`) runs before the
optimizer, so every rank takes the JAX package's global step, clipping
included. The loss, accuracies and eval metrics are summed over the
ranks and the packed eval output is all-gathered, so every rank returns
the whole batch's. With ``--no_bn_sync`` each rank normalises with its
own rows' statistics and the running statistics are averaged after the
step. Each rank draws dropout from its own stream (`dropout_generator`
with its world rank; rank 0's is the one-process stream).

Context parallelism (``point_shards > 1``): one `Trainval` runs on each
rank of a point-shard group (`parallel.launch.run_point_ranks`, or
`run_ranks` with ``point_shards`` for the ``data x points`` mesh), with the
ring graph ops of `parallel.context_parallel.cp_graph_ops` in the model.
Every rank reads the same global batch and cuts its data rank's rows, then
its contiguous point shard, out of it. ``ring_impl="rdma"`` launches the
hand-written ring kernel on CUDA and runs its plain merge on the CPU (the
JAX package refuses ``rdma`` on CPU meshes only because its interpreter
cannot emulate remote DMA). With ``knn_window > 0`` (banded context
parallelism) the graph ops are `parallel.context_parallel.
banded_cp_graph_ops`' halo exchange: every rank Morton-sorts the whole
event (`_sort_batch_global`, the single-device model's entry sort) before
it cuts its band, the model is built ``pre_sorted``, and the gathered
eval output is put back in the caller's point order.

Training under context parallelism is the JAX ``device_step`` under
``shard_map`` over ``(data, points)``, with its implicit collectives
explicit over both axes (``group.axis(ALL_AXES)``): the objective of a
rank is its ``sum(w l)`` over the weight sum of the whole group; the
forward's exchanges are differentiable (their backwards send the
cotangents home), so a rank's gradient is its part of the global one,
and one all-reduce of the flat gradient over both axes makes the global
step on every rank. BN statistics merge over both axes with ``bn_sync``,
else over the points axis (a point shard is never a statistics unit),
and the running statistics are then averaged over the data axis. The
loss, the accuracies and the eval metrics are summed over both axes; the
packed eval output is all-gathered along the points, then along the
data. Dropout on world rank ``data_rank * point_shards + point_rank``
draws from that rank's stream, the JAX ``lin_idx``.

Checkpoints: `state_tree` gives the state in the JAX package's checkpoint
layout (optax's chain state for the optimizer, the step as int32, the
dropout seed as a JAX key) and `load_tree` takes it back, so
`train.checkpoint` reads and writes files either package can resume.
Dropout draws step ``i``'s masks from a generator seeded with ``(seed,
i)`` (and the world rank), as the JAX step folds the step and the device
into its key, so a resumed run draws what the uninterrupted run would
have drawn.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from dgcnn_tpu_torch.bridge import tree_leaves, tree_map, tree_unflatten
from dgcnn_tpu_torch.kernels.knn_cuda import check_precision
from dgcnn_tpu_torch.models import get_model
from dgcnn_tpu_torch.models.dgcnn import default_knn_fn
from dgcnn_tpu_torch.parallel.collectives import (
    all_gather_data,
    all_gather_points,
    all_reduce_grads,
    broadcast_tree,
    pmean_data,
    psum_all,
)
from dgcnn_tpu_torch.ops.sfc import morton_order
from dgcnn_tpu_torch.parallel.context_parallel import banded_cp_graph_ops, cp_graph_ops
from dgcnn_tpu_torch.parallel.mesh import ALL_AXES, DATA_AXIS, make_mesh
from dgcnn_tpu_torch.utils.timing import span


class TrainState(NamedTuple):
    params: Any  # {"blocks": [...], "head": {...}} of tensors
    model_state: Any  # BN running statistics
    opt_state: Any = None  # the optimizer's moments, over the params' leaves
    step: int = 0  # train steps taken
    # the dropout seed (cfg.seed mod 2**32 at initialisation; a checkpoint
    # stores it as the JAX key PRNGKey(rng)): step i draws its dropout
    # masks from a generator seeded with (rng, i), see `dropout_generator`
    rng: int = 0


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


_M64 = (1 << 64) - 1


def _splitmix64(a: int, b: int) -> int:
    z = ((a & _M64) * 0x9E3779B97F4A7C15 + b + 1) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def dropout_generator(device, seed: int, step: int, rank: int = 0) -> torch.Generator:
    """The generator of step ``step``'s dropout masks on ``device`` for
    world rank ``rank`` (``data_rank * point_shards + point_rank``): seeded
    with a splitmix64 hash of ``(seed, step)``, hashed once more with the
    rank for ranks above 0, so it depends on nothing but the run's seed,
    the step and the rank, and rank 0 draws what one process draws."""
    z = _splitmix64(seed, step)
    if rank:
        z = _splitmix64(z, rank)
    return torch.Generator(device=device).manual_seed(z)


def jax_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s raw uint32[2] key as the JAX package
    makes it (64-bit mode off, JAX's default): ``[0, seed mod 2**32]``."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def seed_of_key(key) -> int:
    """The seed of a `jax_key`."""
    hi, lo = (int(v) for v in np.asarray(key, np.uint32).reshape(2))
    return (hi << 32) | lo


def disable_tf32() -> None:
    """f32 matmuls and convolutions in full f32, as the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def knn_fn_for(device: torch.device, use_pallas: bool, knn_precision: str,
               knn_window: int):
    """The trainer's kNN function, named explicitly: the hand-written
    kernel (exact, or banded with ``knn_window > 0``; with ``knn_precision
    ="default"`` its tensor-core instantiation) on CUDA with
    ``use_pallas``, the plain f32 oracle on the CPU or with ``use_pallas``
    off (the ``--no_pallas`` debug knob), whatever the precision says, as
    the JAX package off the TPU; see `models.dgcnn.default_knn_fn`."""
    check_precision(knn_precision)
    return default_knn_fn(device, use_pallas, knn_window, knn_precision)


class Trainval:
    """Build once per run; owns the model, the optimizer and the steps.

    ``knn_fn`` replaces the graph build (as the JAX ``Trainval`` takes it),
    e.g. to pin the graph in a test."""

    def __init__(self, cfg, device=None, group=None, knn_fn=None):
        self.cfg = cfg
        self._staging = {}  # a train batch's pinned host buffers (`_put_batch`)
        self.point_shards = int(cfg.point_shards)
        self.group = group
        self.data_size = 1 if group is None else group.data_size
        if cfg.num_devices:
            want = make_mesh(cfg.num_devices, self.point_shards)[DATA_AXIS]
            if want > 1 and self.data_size != want:
                raise ValueError(
                    f"num_devices={cfg.num_devices}: Trainval runs on each rank of a group "
                    f"with {want} data ranks (parallel.launch.run_ranks) and takes its "
                    f"RankGroup")
        if self.point_shards > 1 and (group is None or group.size != self.point_shards):
            raise ValueError(
                f"point_shards={self.point_shards}: Trainval runs on each rank of a "
                f"group of {self.point_shards} (parallel.launch.run_point_ranks) and "
                f"takes its PointGroup"
            )
        if self.data_size > 1 and cfg.minibatch_size % self.data_size:
            raise ValueError(
                f"minibatch_size={cfg.minibatch_size} not divisible by "
                f"data-parallel devices={self.data_size}"
            )
        if self.data_size > 1 or self.point_shards > 1:
            if device is not None and torch.device(device).type != group.device.type:
                raise ValueError(f"device {device} is not the group's {group.device}")
            self.device = resolve_device(group.device)
        else:
            self.device = resolve_device(device)
        # the data axis and both axes of the rank group, None in one data
        # replica and in one process
        self._dg = group.axis(DATA_AXIS) if self.data_size > 1 else None
        self._wg = (group.axis(ALL_AXES) if self.data_size * self.point_shards > 1
                    else None)
        disable_tf32()
        self._banded_cp = self.point_shards > 1 and cfg.knn_window > 0
        if self._banded_cp:
            ops = banded_cp_graph_ops(group, window=cfg.knn_window,
                                      knn_precision=cfg.knn_precision, use_kernel=cfg.use_pallas)
        elif self.point_shards > 1:
            ops = cp_graph_ops(group, impl=cfg.ring_impl, knn_precision=cfg.knn_precision,
                               use_kernel=cfg.use_pallas)
        if self.point_shards > 1:
            self.model = get_model(
                cfg.model_name, cfg.model_spec(), knn_fn=knn_fn or ops.knn, gather_fn=ops.gather,
                pool_fn=ops.pool, gather_extend_fn=ops.extend, gather_localize_fn=ops.localize,
                pre_sorted=self._banded_cp,
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
        step 0; the dropout seed ``cfg.seed``."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        params, mstate = self.model.init(in_dim, generator)
        to = lambda t: t.to(self.device)  # noqa: E731
        return self.with_params(tree_map(to, params), tree_map(to, mstate))

    def with_params(self, params, model_state) -> TrainState:
        """A fresh `TrainState` around given parameters (e.g. bridged from
        the JAX package; over ranks world rank 0's, broadcast): a
        zero optimizer state, step 0 and the dropout seed ``cfg.seed``."""
        params, model_state = self._replicated((params, model_state))
        return TrainState(params, model_state, self.opt.init(tree_leaves(params)), 0,
                          seed_of_key(jax_key(int(self.cfg.seed))))

    def _replicated(self, tree):
        """``tree`` as world rank 0 holds it, on every rank."""
        return tree if self._wg is None else broadcast_tree(tree, self._wg)

    # --------------------------------------------------------- checkpoints

    def state_tree(self, state: TrainState) -> dict:
        """The state in the JAX package's checkpoint layout: ``params``,
        ``model_state``, ``opt_state`` as optax's chain state, ``step``
        (int32) and ``rng`` (the JAX key of the dropout seed). Leaves are
        the state's own tensors (no copy)."""
        return {
            "params": state.params,
            "model_state": state.model_state,
            "opt_state": self.opt.state_tree(state.opt_state, state.params, state.step,
                                             scheduled=self.cfg.lr_schedule != "constant"),
            "step": np.asarray(state.step, np.int32),
            "rng": jax_key(int(state.rng)),
        }

    def load_tree(self, tree: dict) -> TrainState:
        """The `TrainState` of a tree in `state_tree`'s layout (numpy
        leaves, e.g. restored by `train.checkpoint.restore` with
        ``state_tree`` of a live state as the template), on the device; over
        ranks world rank 0's tensors on every rank."""
        params, mstate, opt_state = self._replicated((
            tree_map(self._to_device, tree["params"]),
            tree_map(self._to_device, tree["model_state"]),
            self.opt.load_tree(tree["opt_state"], self._to_device)))
        return TrainState(params, mstate, opt_state, int(np.asarray(tree["step"])),
                          seed_of_key(tree["rng"]))

    def restore_for_eval(self, state: TrainState, path: str):
        """Restore only the parameters and BN state from a checkpoint
        (serving carries no optimizer state, so the training run's
        optimizer and schedule flags do not matter). Returns ``(state,
        step)``."""
        from dgcnn_tpu_torch.train import checkpoint

        loaded, step, _ = checkpoint.restore_subtrees(
            path, {"params": state.params, "model_state": state.model_state})
        return state._replace(params=tree_map(self._to_device, loaded["params"]),
                              model_state=tree_map(self._to_device, loaded["model_state"])), step

    def _to_device(self, a) -> torch.Tensor:
        """A copy of a restored numpy leaf on the device."""
        return torch.tensor(np.asarray(a), device=self.device)

    def lr_at(self, step: int) -> float:
        """The learning rate of the update taken at ``step`` (the count of
        updates before it)."""
        return self._lr(step)

    # ---------------------------------------------------------- train step

    def train_step(self, state: TrainState, batch):
        """One optimization step: ``(new_state, metrics)`` with ``loss``
        (the class-weighted global mean cross entropy), ``acc`` and
        ``class_acc`` (per-class recall), over the whole global batch over
        ranks (data and point shards alike). Runs with autograd on, never
        under ``inference_mode``; on CUDA its graph builds launch the kNN
        kernels (`knn_fn_for`; the ring or the halo cross form under
        context parallelism)."""
        if state.opt_state is None:
            raise ValueError("the state has no optimizer state: build it with initialize() "
                             "or with_params()")
        with span("dgcnn.train_step"):
            loss, grads, (logits, labels, mask, new_mstate) = self.loss_and_grads(state, batch)
            with torch.no_grad(), span("dgcnn.optimizer"):
                self.opt.update(tree_leaves(state.params), grads, state.opt_state,
                                self._lr(state.step))
            with torch.no_grad(), span("dgcnn.outputs"):
                hit = torch.argmax(logits, dim=-1) == labels
                cls = torch.arange(self.cfg.num_class, device=labels.device)
                is_cls = (labels[..., None] == cls) & mask[..., None]
                # [correct, valid, per-class totals, per-class correct]
                counts = torch.cat([
                    torch.stack([torch.sum(hit & mask), torch.sum(mask)]),
                    is_cls.sum(dim=(0, 1)),
                    (is_cls & hit[..., None]).sum(dim=(0, 1))]).to(torch.float32)
                if self._wg is not None:
                    counts = psum_all(counts, self.group)
                correct, valid = counts[0], counts[1]
                total, correct_cls = counts[2:].chunk(2)
                acc = correct / torch.clamp(valid, min=1.0)
                class_acc = correct_cls / torch.clamp(total, min=1.0)
            if self._dg is not None and not self.cfg.bn_sync:
                # each data rank's own statistics: average the running ones
                # (with sync BN they are equal on every rank already, and the
                # points axis always merges)
                new_mstate = _tree_pmean(new_mstate, self.group)
        metrics = {"loss": loss, "acc": acc, "class_acc": class_acc}
        return TrainState(state.params, new_mstate, state.opt_state, state.step + 1,
                          state.rng), metrics

    def loss_and_grads(self, state: TrainState, batch):
        """The train step without its update: the train-mode forward on
        ``state`` (its dropout stream, step and BN state), the objective and
        its gradient. Returns ``(loss, grads, (logits, labels, mask,
        new_model_state))``: the global loss, the global gradient (summed
        over ranks; a list in `tree_leaves` order of the parameters) and
        this rank's logits, labels, mask and new BN state."""
        wg, group = self._wg, self.group
        with span("dgcnn.put_batch"):
            points, labels, weights, mask = self._put_batch(batch)
        # the same storage, as leaves of this step's autograd graph
        live = tree_map(lambda t: t.detach().requires_grad_(True), state.params)
        if self.cfg.bn_sync:
            bn_group = wg
        else:
            # a point shard is never a statistics unit
            bn_group = group if self.point_shards > 1 else None
        with torch.enable_grad():
            gen = (dropout_generator(self.device, int(state.rng), int(state.step),
                                     0 if wg is None else wg.rank)
                   if self.cfg.dropout > 0 else None)
            logits, new_mstate = self.model(live, state.model_state, points, mask, train=True,
                                            generator=gen, bn_group=bn_group)
            with span("dgcnn.loss"):
                loss_sum, w_sum = _weighted_sums(logits, labels, weights, mask, self._cls_w)
                if wg is None:
                    objective = loss = loss_sum / torch.clamp(w_sum, min=1e-9)
                else:
                    # the global weighted mean: this rank's share of it, over
                    # the global weight sum (no gradient flows through it)
                    g_loss, g_w = psum_all(torch.stack([loss_sum.detach(), w_sum.detach()]),
                                           group)
                    w_all = torch.clamp(g_w, min=1e-9)
                    objective, loss = loss_sum / w_all, g_loss / w_all
        with span("dgcnn.backward"):
            grads = list(torch.autograd.grad(objective, tree_leaves(live)))
            if wg is not None:
                # the sum of every rank's share: the global gradient
                grads = all_reduce_grads(grads, group)
        return (loss.detach(), grads, (logits.detach(), labels, mask,
                                       tree_map(lambda t: t.detach(), new_mstate)))

    # ----------------------------------------------------------- eval step

    @torch.inference_mode()
    def _eval(self, state: TrainState, batch, packed: bool):
        with span("dgcnn.inference"):
            with span("dgcnn.put_batch"):
                points, labels, weights, mask, pos = self._put_batch(batch, with_pos=True)
            logits, _ = self.model(state.params, state.model_state, points, mask)
            with span("dgcnn.outputs"):
                return self._eval_outputs(logits, labels, weights, mask, pos, packed)

    def _eval_outputs(self, logits, labels, weights, mask, pos, packed: bool):
        """`_eval`'s metrics from the logits, with the packed output when
        ``packed``."""
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
        if self._wg is not None:
            merged = psum_all(torch.cat([torch.stack([loss_sum, w_sum]), cm.reshape(-1)]),
                              self.group)
            loss_sum, w_sum, cm = merged[0], merged[1], merged[2:].view(cm.shape)
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
            if pos is not None:
                # sorted order -> the caller's (row j sat at position pos[j])
                out = torch.gather(out, 1, pos[..., None].expand(pos.shape + out.shape[-1:]))
        if self._dg is not None:
            out = all_gather_data(out, self.group)
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

    def _put_batch(self, batch, with_pos: bool = False):
        """A `Batch` (any object with its fields) or a tuple
        ``(points, labels, weights or None, mask)`` -> device tensors.
        Under data parallelism: this rank's contiguous rows of the global
        batch (with several hosts the batch is the host's share, and the
        rows are this rank's among its host's, as the JAX package takes
        each process's local rows); under context parallelism: then this
        rank's contiguous point shard of those rows, under banded context
        parallelism of the events Morton-sorted as a whole. ``with_pos`` adds the
        sort's inverse permutation ``(B, N)`` (None without the sort).

        On a card a train step's copies go through pinned buffers of this
        `Trainval` without blocking the host: from pageable memory a copy
        waits for the card to drain the stream, which then idles while the
        host dispatches the step (2.4% of a 32 x 4,096-point step, H100).
        The buffers are allocated once and refilled once the card has read
        them, which keeps the host at most a step ahead: a page-locked
        allocation is itself a barrier for the card. Under inference mode
        (serving, evaluation) the copies stay pageable: pinned, the served
        points a second fell by 4% (median of 4 pairs, H100)."""
        if hasattr(batch, "points"):
            points, labels, mask = batch.points, batch.labels, batch.mask
            weights = batch.weights
        else:
            points, labels, weights, mask = batch
        if weights is None:
            weights = np.ones(np.shape(labels), np.float32)
        if self._dg is not None:
            g = self.group
            ranks, r = (g.local_size, g.local_rank) if g.hosts > 1 else (g.data_size, g.data_rank)
            b = np.shape(labels)[0]
            if b % ranks:
                raise ValueError(f"a batch of {b} events does not split over {ranks} data ranks")
            rows = slice(r * (b // ranks), (r + 1) * (b // ranks))
            points, labels, weights, mask = (
                np.asarray(a)[rows] for a in (points, labels, weights, mask))
        if self.point_shards > 1:
            n, p = np.shape(labels)[1], self.point_shards
            if n % p:
                raise ValueError(f"event size {n} not divisible by point_shards={p}")
            nl = n // p
            if self.cfg.kvalue > nl:
                raise ValueError(f"KVALUE={self.cfg.kvalue} exceeds the local shard size {nl}")
            rows = slice(self.group.rank * nl, (self.group.rank + 1) * nl)
            if not self._banded_cp:
                points, labels, weights, mask = (
                    np.asarray(a)[:, rows] for a in (points, labels, weights, mask))

        def put(slot, x, dtype):
            t = torch.as_tensor(np.asarray(x))
            if self.device.type != "cuda" or torch.is_inference_mode_enabled():
                return t.to(self.device, dtype)
            buf, read = self._staging.get(slot, (None, None))
            if buf is None or buf.numel() < t.nbytes:
                buf, read = torch.empty(t.nbytes, dtype=torch.uint8, pin_memory=True), \
                    torch.cuda.Event()
            read.synchronize()  # the card has copied the last batch out
            staged = buf[:t.nbytes].view(t.dtype).view(t.shape)
            staged.copy_(t)
            # the card casts: a cast on the way could be made on the host,
            # into pageable memory again
            out = staged.to(self.device, non_blocking=True)
            read.record()
            self._staging[slot] = buf, read
            return out.to(dtype)

        out = [put(0, points, torch.float32), put(1, labels, torch.int64),
               put(2, weights, torch.float32), put(3, mask, torch.bool)]
        pos = None
        if self._banded_cp:
            # the band is cut from the whole event, sorted on the device
            *out, pos = _sort_batch_global(*out)
            out = [a[:, rows].contiguous() for a in out]
        return (*out, pos) if with_pos else tuple(out)


def _sort_batch_global(points, labels, weights, mask):
    """Morton-sort every event of the whole batch (the banded context
    parallel entry sort; port of the JAX `train/trainval.py::
    _sort_batch_global`): the single-device banded model's own entry sort
    (`ops.sfc.morton_order`), so the sorted rows are the same on every
    rank and as on one device; labels, weights and mask follow. Returns
    ``(points, labels, weights, mask, pos)``, ``pos`` the inverse
    permutation (row j sits at sorted position ``pos[j]``)."""
    order, pos = morton_order(points, mask)
    take = lambda a: torch.gather(a, 1, order)  # noqa: E731
    return (torch.gather(points, 1, order[..., None].expand(points.shape)), take(labels),
            take(weights), take(mask), pos)


def _weighted_sums(logits, labels, weights, mask, cls_w):
    """``(-sum(w log p), sum(w))``, ``w = weights * mask (*
    cls_w[labels])``: the class-weighted mean cross entropy is their
    quotient, the weight sum clamped at 1e-9."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    w = weights * mask.to(logits.dtype)
    if cls_w is not None:
        w = w * cls_w[labels]
    return -torch.sum(ll * w), torch.sum(w)


def _tree_pmean(tree, group):
    """The mean of every tensor of ``tree`` over the data axis: one
    all-reduce of the leaves packed flat."""
    leaves = tree_leaves(tree)
    flat = pmean_data(torch.cat([t.reshape(-1) for t in leaves]), group)
    parts = torch.split(flat, [t.numel() for t in leaves])
    return tree_unflatten(tree, [p.view(t.shape) for p, t in zip(parts, leaves)])


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

    def state_tree(self, state, params, step: int, scheduled: bool):
        """``state`` as optax's chain state of `_make_optimizer`'s
        optimizer, with the moments in ``params``' tree: ``(core,
        [weight decay,] learning rate)``, behind ``(clip, ...)`` with
        clipping. The core is ``{count, mu, nu}`` (Adam), ``{trace}``
        (momentum) or empty (sgd); a schedule's state is ``{count}``, the
        updates taken, an empty state otherwise."""
        if self.name in ("adam", "adamw"):
            core = {"count": np.asarray(state["count"], np.int32),
                    "mu": tree_unflatten(params, state["mu"]),
                    "nu": tree_unflatten(params, state["nu"])}
        elif self.name == "momentum":
            core = {"trace": tree_unflatten(params, state["trace"])}
        else:
            core = {}
        lr_state = {"count": np.asarray(step, np.int32)} if scheduled else {}
        chain = (core, {}, lr_state) if self.name == "adamw" else (core, lr_state)
        return ({}, chain) if self.grad_clip > 0 else chain

    def load_tree(self, tree, to):
        """The inverse of `state_tree`, leaves through ``to``."""
        core = tree[1][0] if self.grad_clip > 0 else tree[0]
        if self.name in ("adam", "adamw"):
            return {"count": int(np.asarray(core["count"])),
                    "mu": [to(a) for a in tree_leaves(core["mu"])],
                    "nu": [to(a) for a in tree_leaves(core["nu"])]}
        if self.name == "momentum":
            return {"trace": [to(a) for a in tree_leaves(core["trace"])]}
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
