"""DGCNN segmentation models (port of `dgcnn_tpu/models/dgcnn.py`).

NUM_EDGE_CONV EdgeConv blocks, each rebuilding the kNN graph from the
previous block's features (the dynamic graph), then a dense head over the
concatenated block outputs with a masked global max pool, giving per-point
logits. Variable-length events arrive padded with a validity mask that
threads through the kNN, the pool and the loss.

With ``knn_window > 0`` the graph build is banded: the whole network runs
in Morton order (`ops.sfc.morton_order`, padded points last), each query
scoring only a window of consecutive sorted positions, and the logits are
unpermuted at exit. Past `models.head.HEAD_STREAM_ELEMS` row-elements
(or with ``head_stream="on"``) the head runs in chunks of points
(`models.head.head_streamed`).

Under context parallelism each rank runs this model on its ``(B, N/P, F)``
point shard with the graph ops of `parallel.context_parallel.cp_graph_ops`
injected (``knn_fn``, ``gather_fn``, ``pool_fn`` and the gather's
``extend``/``localize`` decomposition), as the JAX ``make_model`` takes
them.

The model is a parameterless ``nn.Module`` over dicts of tensors: ``init``
returns ``(params, state)`` in the JAX package's tree layout
(``{"blocks": [{w, bn, proj?}], "head": {feat, mlp, out}}`` and the BN
``{mean, var}`` state), and ``forward(params, state, points, mask)``
returns ``(logits, state)``. So JAX parameters bridge in one step
(`dgcnn_tpu_torch.bridge`).

``forward(..., train=True, generator=...)`` is the train-mode forward:
masked batch statistics in every BN layer, the running statistics updated
(the new state comes back in the JAX ``apply``'s tree), dropout after each
head MLP layer drawn from ``generator``. The graph build is stop-gradient
(built from detached features under ``torch.no_grad``), so training
launches the same forward-only kNN kernel as serving.

The options of the JAX model that the port does not cover yet raise
``NotImplementedError`` naming the ROADMAP item that ports them: bf16 and
remat (item 10), the streamed head and the edge form's slot stream in
train mode (item 11), training under context parallelism (item 13).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings

import torch
from torch import nn

from dgcnn_tpu_torch.models.core import (
    conv_bn_apply,
    conv_bn_init,
    dense_apply,
    dense_init,
    dropout,
)
from dgcnn_tpu_torch.kernels.knn_banded_cuda import knn_banded_cuda
from dgcnn_tpu_torch.kernels.knn_cuda import knn_cuda
from dgcnn_tpu_torch.models import head as head_mod
from dgcnn_tpu_torch.ops.edge import (
    edgeconv_block_fused,
    edgeconv_block_reduced,
    gather_neighbors,
)
from dgcnn_tpu_torch.ops.knn import banded_knn_indices, knn_indices
from dgcnn_tpu_torch.ops.norm import batch_norm_apply
from dgcnn_tpu_torch.ops.sfc import morton_order

# gather elements at or above which the JAX EDGE impl's eval streams one
# neighbor slot at a time (`models/dgcnn.py:47`); not ported here
EDGE_EVAL_STREAM_ELEMS = 2**31

BLOCK_IMPLS = ("auto", "edge", "reduced", "fused")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item {item})"
    )


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static architecture hyperparameters, as in the JAX package."""

    num_class: int = 2
    k: int = 20
    edge_filters: tuple = (64, 64, 64, 64, 64, 64)
    residual: bool = False
    head_feat_dim: int = 1024
    head_mlp: tuple = (512, 256)
    global_pool: bool = True
    dropout: float = 0.0
    bn_momentum: float = 0.9
    compute_dtype: str = "float32"
    remat: bool = False
    knn_every: int = 1
    block_impl: str = "auto"
    knn_window: int = 0
    head_factorized: bool = False
    head_stream: str = "auto"
    block_convs: int = 1

    @property
    def num_edge_conv(self) -> int:
        return len(self.edge_filters)


def _masked_max_points(x: torch.Tensor, mask):
    """Max over the point axis, ignoring padded points; zeros for an event
    with no valid point. ``x`` ``(B, N, C)``."""
    if mask is None:
        return x.amax(dim=-2)
    neg = torch.finfo(x.dtype).min
    y = torch.where(mask[..., None], x, neg).amax(dim=-2)
    any_valid = mask.any(dim=-1, keepdim=True)
    return torch.where(any_valid, y, 0.0)


def default_knn_fn(device: torch.device, use_kernel: bool = True, window: int = 0):
    """The kNN function for features on ``device`` (the JAX package's
    `_maybe_pallas_knn` rule), chosen here and nowhere else. With
    ``window == 0``: the hand-written exact kernel
    (`kernels.knn_cuda.knn_cuda`) on CUDA, the plain oracle
    (`ops.knn.knn_indices`) on the CPU or with ``use_kernel`` off. With
    ``window > 0``: the banded kernel
    (`kernels.knn_banded_cuda.knn_banded_cuda`) on CUDA, the banded oracle
    (`ops.knn.banded_knn_indices`) otherwise, each bound to the window."""
    kernel = use_kernel and device.type == "cuda"
    if window > 0:
        fn = knn_banded_cuda if kernel else banded_knn_indices
        return functools.partial(fn, window=window)
    return knn_cuda if kernel else knn_indices


class Model(nn.Module):
    """Functional DGCNN: holds the spec and the graph ops, no weights.

    ``knn_fn``: ``(x, k, mask) -> (idx, valid)``; None picks
    `default_knn_fn` for the device of each call's ``points``.
    ``gather_fn``: ``(values, idx) -> (B, N, k, C)`` neighbour gather
    (default: the local `ops.edge.gather_neighbors`); ``pool_fn``:
    ``(x, mask) -> (B, C)`` masked global max pool (default: the local
    one); ``gather_extend_fn`` / ``gather_localize_fn``: the gather
    decomposed as ``gather_fn(v, idx) == gather_neighbors(extend(v),
    localize(idx))``. With the decomposition (or no ``gather_fn``)
    ``block_impl="auto"`` resolves to ``fused``, which in eval runs the
    reduced block on the extended operand; without it, to ``edge``.
    """

    def __init__(self, spec: ModelSpec, knn_fn=None, gather_fn=None, pool_fn=None,
                 gather_extend_fn=None, gather_localize_fn=None):
        super().__init__()
        if spec.compute_dtype != "float32":
            raise not_ported(f"compute_dtype={spec.compute_dtype!r}", "10")
        if spec.remat:
            raise not_ported("remat", "10")
        if spec.block_convs < 1:
            raise ValueError(f"block_convs must be >= 1, got {spec.block_convs}")
        if spec.head_stream not in ("auto", "on", "off"):
            raise ValueError(
                f"head_stream must be 'auto', 'on' or 'off', got "
                f"{spec.head_stream!r}"
            )
        if spec.block_impl not in BLOCK_IMPLS:
            raise ValueError(
                f"block_impl must be one of {BLOCK_IMPLS}, got {spec.block_impl!r}"
            )
        if spec.knn_window > 0 and (gather_fn is not None or pool_fn is not None):
            raise not_ported("knn_window with context parallelism (banded CP)", "13")
        self.spec = spec
        self.knn_fn = knn_fn
        self.gather_fn = gather_fn
        self.pool_fn = pool_fn
        self.gather_extend_fn = gather_extend_fn
        self.gather_localize_fn = gather_localize_fn
        # the fused block gathers locally: from the operand itself, or from
        # the extended operand of a gather that decomposes
        self.fused_gather_ok = gather_fn is None or (
            gather_extend_fn is not None and gather_localize_fn is not None
        )
        # f32 depth-1 blocks restructure (fused where the gather allows
        # it, else edge); stacked per-edge convs need the edge tensor, and
        # an explicit fused/reduced falls back to it with a warning, as in
        # the JAX package
        restructurable = spec.block_convs == 1
        if spec.block_impl == "auto":
            self.block_impl = "fused" if restructurable and self.fused_gather_ok else "edge"
        else:
            self.block_impl = spec.block_impl
            if self.block_impl != "edge" and not restructurable:
                warnings.warn(f"block_impl={spec.block_impl!r} requires depth-1 blocks; "
                              f"block_convs={spec.block_convs} forces the 'edge' implementation")
                self.block_impl = "edge"

    def init(self, in_dim: int, generator: torch.Generator | None = None):
        """Glorot-initialised ``(params, state)`` in the JAX tree layout, on
        the CPU from a CPU generator, drawn in the JAX package's order
        (blocks with their stacked convs and projections, head feature conv,
        head MLP, output layer)."""
        spec = self.spec
        g = generator if generator is not None else torch.Generator()
        blocks, block_states = [], []
        c_in = in_dim
        for c_out in spec.edge_filters:
            p, s = conv_bn_init(g, 2 * c_in, c_out)
            if spec.block_convs > 1:
                # stacked per-edge convs; the state becomes a dict only at
                # depth >= 2, as in the JAX tree
                extra = [conv_bn_init(g, c_out, c_out) for _ in range(spec.block_convs - 1)]
                p["extra"] = [ep for ep, _ in extra]
                s = {"main": s, "extra": [es for _, es in extra]}
            if spec.residual and c_in != c_out:
                p["proj"] = dense_init(g, c_in, c_out)
            blocks.append(p)
            block_states.append(s)
            c_in = c_out
        concat_dim = sum(spec.edge_filters)
        feat_p, feat_s = conv_bn_init(g, concat_dim, spec.head_feat_dim)
        mlp_in = (
            concat_dim + spec.head_feat_dim if spec.global_pool else spec.head_feat_dim
        )
        mlp, mlp_states = [], []
        for width in spec.head_mlp:
            p, s = conv_bn_init(g, mlp_in, width)
            mlp.append(p)
            mlp_states.append(s)
            mlp_in = width
        out_p = dense_init(g, mlp_in, spec.num_class)
        params = {"blocks": blocks, "head": {"feat": feat_p, "mlp": mlp, "out": out_p}}
        state = {"blocks": block_states, "head": {"feat": feat_s, "mlp": mlp_states}}
        return params, state

    def _block(self, x, idx, blk_p, blk_s, mask, train: bool, bn_group=None):
        """One EdgeConv block; returns ``(y, new_block_state)``."""
        spec = self.spec
        bn = dict(train=train, momentum=spec.bn_momentum, group=bn_group)
        # factorized pre-activation h_ij = P_i + Q_j, P = x@(Wa-Wb), Q = x@Wb
        c = x.shape[-1]
        w = blk_p["w"]
        wa, wb = w[:c], w[c:]
        p_feat = torch.matmul(x, wa - wb)
        q_feat = torch.matmul(x, wb)
        if self.block_impl == "fused" and self.fused_gather_ok:
            if self.gather_fn is None:
                q_in, idx_in = q_feat, idx
            else:
                # exchange once, gather locally
                q_in, idx_in = self.gather_extend_fn(q_feat), self.gather_localize_fn(idx)
            y, bn_s = edgeconv_block_fused(p_feat, q_in, blk_p["bn"], blk_s, idx_in, mask, **bn)
        elif self.block_impl in ("reduced", "fused"):
            y, bn_s = edgeconv_block_reduced(p_feat, q_feat, blk_p["bn"], blk_s, idx, mask,
                                             gather_fn=self.gather_fn, **bn)
        else:
            if self.gather_fn is None and idx.numel() * q_feat.shape[-1] >= EDGE_EVAL_STREAM_ELEMS:
                raise not_ported("the slot-streamed edge eval", "11")
            stacked = "extra" in blk_p  # block_convs >= 2
            h = p_feat[..., :, None, :] + (self.gather_fn or gather_neighbors)(q_feat, idx)
            bn_mask = None if mask is None else mask[..., None]  # over the k slots too
            h, bn_s0 = batch_norm_apply(blk_p["bn"], blk_s["main"] if stacked else blk_s, h,
                                        bn_mask, **bn)
            h = torch.relu(h)
            if stacked:
                # stacked per-edge conv + BN + relu on the (B, N, k, C) tensor
                extra_states = []
                for ep, es in zip(blk_p["extra"], blk_s["extra"]):
                    h, es2 = conv_bn_apply(ep, es, h, bn_mask, **bn)
                    extra_states.append(es2)
                bn_s = {"main": bn_s0, "extra": extra_states}
            else:
                bn_s = bn_s0
            y = h.amax(dim=-2)
        if spec.residual:
            shortcut = dense_apply(blk_p["proj"], x) if "proj" in blk_p else x
            y = y + shortcut
        return y, bn_s

    def forward(self, params, state, points, mask=None, *, train: bool = False,
                generator: torch.Generator | None = None, bn_group=None):
        """``points`` ``(B, N, F)``, ``mask`` ``(B, N)`` bool or None.

        Eval: running BN statistics; returns ``(logits (B, N, num_class)
        float32, state)`` with the state unchanged. Train: masked batch
        statistics; returns ``(logits, new_state)``, the running averages
        updated, and dropout drawn from ``generator`` (none without one,
        as the JAX ``apply`` with ``rng=None``). ``bn_group`` (the data
        axis of the rank group, the JAX ``bn_axis``) merges every train
        BN layer's statistics over its ranks (sync BN)."""
        spec = self.spec
        if train and self.gather_fn is not None:
            raise not_ported("training under context parallelism", "13")
        x = points.float()
        inv_pos = None
        if spec.knn_window > 0:
            # banded kNN: run the whole network in Morton order, padded
            # points last; every op up to the exit unpermute is
            # permutation-invariant given the permuted mask
            order, inv_pos = morton_order(x, mask)
            x = torch.gather(x, -2, order[..., None].expand(x.shape))
            if mask is not None:
                mask = torch.gather(mask, -1, order)
        knn_fn = self.knn_fn or default_knn_fn(x.device, window=spec.knn_window)
        block_feats, block_states = [], []
        idx = None
        for i, (blk_p, blk_s) in enumerate(zip(params["blocks"], state["blocks"])):
            if i % spec.knn_every == 0:
                with torch.no_grad():  # the graph build is stop-gradient
                    idx, _ = knn_fn(x.detach(), spec.k, mask)  # dynamic graph
            x, bn_s = self._block(x, idx, blk_p, blk_s, mask, train, bn_group)
            block_feats.append(x)
            block_states.append(bn_s)

        # the streamed pool decomposes a masked MAX pool only (the default
        # and the context-parallel one); another pool keeps the dense head
        stream_pool_ok = (
            not spec.global_pool
            or self.pool_fn is None
            or getattr(self.pool_fn, "is_masked_max", False)
        )
        if spec.head_stream == "auto":
            rows = math.prod(block_feats[0].shape[:-1])
            stream = stream_pool_ok and rows * max(spec.head_feat_dim, 1) >= head_mod.HEAD_STREAM_ELEMS
        else:
            stream = stream_pool_ok and spec.head_stream == "on"
        if stream:
            logits = head_mod.head_streamed(
                params["head"], state["head"], block_feats, mask, spec=spec,
                pool_fn=self.pool_fn, train=train,
            )
            head_state = state["head"]
        else:
            logits, head_state = self._dense_head(params["head"], state["head"], block_feats,
                                                  mask, train, generator, bn_group)
        if inv_pos is not None:
            # back to the caller's point order (row j was computed at
            # sorted position inv_pos[j])
            logits = torch.gather(
                logits, -2, inv_pos[..., None].expand(inv_pos.shape + logits.shape[-1:])
            )
        if not train:
            return logits, state
        return logits, {"blocks": block_states, "head": head_state}

    def _dense_head(self, head_p, head_s, block_feats, mask, train: bool = False,
                    generator=None, bn_group=None):
        """The dense head: ``(logits, new_head_state)``."""
        spec = self.spec
        bn = dict(train=train, momentum=spec.bn_momentum, group=bn_group)
        agg = torch.cat(block_feats, dim=-1)  # (B, N, sum C)
        feat, feat_s = conv_bn_apply(head_p["feat"], head_s["feat"], agg, mask, **bn)
        factorize = spec.global_pool and spec.head_factorized
        if spec.global_pool:
            g_vec = (self.pool_fn or _masked_max_points)(feat, mask)  # (B, head_feat_dim)
            if factorize:
                h = agg
            else:
                g = g_vec[..., None, :].expand(agg.shape[:-1] + g_vec.shape[-1:])
                h = torch.cat([agg, g], dim=-1)
        else:
            h = feat
        mlp_states = []
        for li, (p, s) in enumerate(zip(head_p["mlp"], head_s["mlp"])):
            if li == 0 and factorize:
                # h @ [Wa; Wg] = agg @ Wa + g @ Wg, g @ Wg once per event
                ca = h.shape[-1]
                w = p["w"]
                pre = torch.matmul(h, w[:ca]) + torch.matmul(g_vec, w[ca:])[..., None, :]
                h, s2 = batch_norm_apply(p["bn"], s, pre, mask, **bn)
                h = torch.relu(h)
            else:
                h, s2 = conv_bn_apply(p, s, h, mask, **bn)
            h = dropout(h, spec.dropout, train=train, generator=generator)
            mlp_states.append(s2)
        return dense_apply(head_p["out"], h).float(), {"feat": feat_s, "mlp": mlp_states}


def make_model(spec: ModelSpec, knn_fn=None, **graph_ops) -> Model:
    """Build the DGCNN model for ``spec`` (see `Model`); ``graph_ops`` are
    `Model`'s ``gather_fn``, ``pool_fn``, ``gather_extend_fn`` and
    ``gather_localize_fn``."""
    return Model(spec, knn_fn=knn_fn, **graph_ops)
