"""DGCNN segmentation models (port of `dgcnn_tpu/models/dgcnn.py`).

NUM_EDGE_CONV EdgeConv blocks, each rebuilding the kNN graph from the
previous block's features (the dynamic graph), then a dense head over the
concatenated block outputs with a masked global max pool, giving per-point
logits. Variable-length events arrive padded with a validity mask that
threads through the kNN, the pool and the loss.

A block's per-edge MLP has the depth ``block_convs`` gives it (one int
for every block, or one a block, as the paper's segmentation network's
2, 2 and 1). ``block_impl="auto"`` picks each block's form alone: an f32
depth-1 block is fused (reduced in eval); an f32 depth-2 block whose
width and k the kernels take trains as ``fused_mlp``
(`ops.edge.edgeconv_block_fused_mlp`: BN, relu, the stacked conv, BN and
the max over the edges with no edge tensor on the card) and evaluates in
the edge form; a deeper block runs the edge form, whose stacked convs act
on the materialised ``(B, N, k, C)`` edge tensor. `block_forms` counts the
blocks run in each form.

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

Mixed precision (``compute_dtype="bfloat16"``, JAX `models/dgcnn.py:389-663`):
the points, the block matmuls (weights cast from the f32 master
parameters), the edge pre-activation ``h = P_i + Q_j`` (rounded before BN)
and the head's matmuls run in bf16; BN takes bf16 and gives f32, the
post-BN chain (relu, the max over the k slots, the residual add) stays f32
and each block's output is cast back to bf16 at its boundary; the logits
are f32. A bf16 model always uses the ``edge`` block form: the fused and
reduced forms compute in f32 and would change the model.

Remat (``remat=True``): each block runs under
``torch.utils.checkpoint.checkpoint`` (non-reentrant), so backward
recomputes its ``(B, N, k, C)`` edge tensors instead of holding them. The
kNN indices are built outside the block and enter it as an input, so they
are saved and the graph build is not launched again in backward (the JAX
``save_only_these_names("knn_idx")``); the block returns its BN state
rather than mutating it, so the recompute cannot update it twice.

Long events (the JAX package's item 11): past `ops.edge.SLOT_STREAM_ELEMS`
the fused block's train forward streams one neighbour slot at a time; past
`EDGE_EVAL_STREAM_ELEMS` the edge form's eval does (the per-edge chain a
slot at a time, the max folded into a carry); the streamed head trains by
statistics sweeps. Banded context parallelism (``knn_window > 0`` with the
halo graph ops of `parallel.context_parallel.banded_cp_graph_ops`) needs a
``pre_sorted`` model: the caller sorts the whole event, so the model skips
its entry sort and exit unpermute.

Training under context parallelism (the JAX package's CP ``device_step``)
runs the same forward: the graph ops' exchanges are differentiable
(`parallel.context_parallel`), so the blocks' and the pool's gradients
flow back to the rank that owns each row. ``bn_group`` is the caller's
BN axis, and under CP it must span the points axis at least (a point
shard is never a statistics unit): `train.trainval.Trainval` passes the
whole group with ``bn_sync``, else the points axis, the JAX ``bn_axis``
rule. Remat recomputes a block and its exchange in backward; only the
kNN indices are kept.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings

import torch
import torch.utils.checkpoint
from torch import nn

from dgcnn_tpu_torch.models.core import (
    conv_bn_apply,
    conv_bn_init,
    dense_apply,
    dense_init,
    dropout,
)
from dgcnn_tpu_torch.kernels import edge_mlp_cuda
from dgcnn_tpu_torch.kernels.knn_banded_cuda import knn_banded_cuda
from dgcnn_tpu_torch.kernels.knn_cuda import knn_cuda
from dgcnn_tpu_torch.models import head as head_mod
from dgcnn_tpu_torch.ops.edge import (
    edgeconv_block_fused,
    edgeconv_block_fused_mlp,
    edgeconv_block_reduced,
    gather_neighbors,
    gather_slot,
)
from dgcnn_tpu_torch.ops.knn import banded_knn_indices, knn_indices
from dgcnn_tpu_torch.ops.norm import batch_norm_apply
from dgcnn_tpu_torch.ops.sfc import morton_order
from dgcnn_tpu_torch.utils.timing import span

# gather elements at or above which the edge form's eval streams one
# neighbour slot at a time (the JAX `models/dgcnn.py:47`)
EDGE_EVAL_STREAM_ELEMS = 2**31

# the blocks run in each form (a remat recompute runs its block again), so
# a run can show which form each block took
block_forms = dict.fromkeys(("fused", "reduced", "fused_mlp", "edge", "edge_stream"), 0)

BLOCK_IMPLS = ("auto", "edge", "reduced", "fused")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def static_elems(shape) -> int:
    """The element count of ``shape`` for a size line, 0 where a dim is
    symbolic (the batch of a shape-polymorphic ``export -mb 0`` trace): a
    symbolic dim keeps the dense form, as in the JAX package
    (`dgcnn_tpu/models/dgcnn.py:486-495`, `:807-821`), and comparing it
    would put a bound on the exported batch."""
    if any(isinstance(d, torch.SymInt) for d in shape):
        return 0
    return math.prod(shape)


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
    block_convs: int | tuple = 1  # one MLP depth for every block, or one a block

    @property
    def num_edge_conv(self) -> int:
        return len(self.edge_filters)

    @property
    def depths(self) -> tuple:
        """Each EdgeConv block's MLP depth (its per-edge convs)."""
        return block_depths(self.block_convs, self.num_edge_conv)


def block_depths(block_convs, num_blocks: int) -> tuple:
    """``block_convs`` as one MLP depth a block: an int is every block's
    depth, a tuple or list gives one a block. Raises ``ValueError`` naming
    the field for a depth under 1 or a tuple of another length."""
    if isinstance(block_convs, int):
        if block_convs < 1:
            raise ValueError(f"block_convs must be >= 1, got {block_convs}")
        return (block_convs,) * num_blocks
    depths = tuple(block_convs)
    if len(depths) != num_blocks:
        raise ValueError(f"block_convs gives {len(depths)} depths for {num_blocks} EdgeConv "
                         f"blocks: give one a block, or one int for all")
    if not all(isinstance(d, int) and d >= 1 for d in depths):
        raise ValueError(f"block_convs depths must be ints >= 1, got {depths}")
    return depths


def _masked_max_points(x: torch.Tensor, mask):
    """Max over the point axis, ignoring padded points; zeros for an event
    with no valid point. ``x`` ``(B, N, C)``."""
    if mask is None:
        return x.amax(dim=-2)
    neg = torch.finfo(x.dtype).min
    y = torch.where(mask[..., None], x, neg).amax(dim=-2)
    any_valid = mask.any(dim=-1, keepdim=True)
    return torch.where(any_valid, y, 0.0)


def default_knn_fn(device: torch.device, use_kernel: bool = True, window: int = 0,
                   precision: str = "highest"):
    """The kNN function for features on ``device`` (the JAX package's
    `_maybe_pallas_knn` rule), chosen here and nowhere else. With
    ``window == 0``: the hand-written exact kernel
    (`kernels.knn_cuda.knn_cuda`) on CUDA, the plain oracle
    (`ops.knn.knn_indices`) on the CPU or with ``use_kernel`` off. With
    ``window > 0``: the banded kernel
    (`kernels.knn_banded_cuda.knn_banded_cuda`) on CUDA, the banded oracle
    (`ops.knn.banded_knn_indices`) otherwise, each bound to the window.
    ``precision`` (``--knn_precision``) binds the kernels' score precision
    (``"default"``: their tensor-core instantiations); the oracles score in
    f32 whatever it says, as the JAX package's do off the TPU (XLA:CPU
    computes ``Precision.DEFAULT`` in f32)."""
    if not (use_kernel and device.type == "cuda"):
        return functools.partial(banded_knn_indices, window=window) if window > 0 else knn_indices
    tc = {} if precision == "highest" else {"precision": precision}
    if window > 0:
        return functools.partial(knn_banded_cuda, window=window, **tc)
    return functools.partial(knn_cuda, **tc) if tc else knn_cuda


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
    ``block_impl="auto"`` resolves to ``fused`` (``fused_mlp`` for a
    depth-2 block), which in eval runs the reduced block on the extended
    operand (the edge form at depth 2); without it, to ``edge``.
    ``pre_sorted``: a banded model whose caller has Morton-sorted the
    whole event (banded context parallelism) skips the entry sort and
    returns the logits in sorted order.
    """

    def __init__(self, spec: ModelSpec, knn_fn=None, gather_fn=None, pool_fn=None,
                 gather_extend_fn=None, gather_localize_fn=None, pre_sorted: bool = False):
        super().__init__()
        if spec.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {tuple(COMPUTE_DTYPES)}, got "
                             f"{spec.compute_dtype!r}")
        self.cdtype = COMPUTE_DTYPES[spec.compute_dtype]
        depths = spec.depths  # checks block_convs
        if spec.head_stream not in ("auto", "on", "off"):
            raise ValueError(
                f"head_stream must be 'auto', 'on' or 'off', got "
                f"{spec.head_stream!r}"
            )
        if spec.block_impl not in BLOCK_IMPLS:
            raise ValueError(
                f"block_impl must be one of {BLOCK_IMPLS}, got {spec.block_impl!r}"
            )
        if spec.knn_window > 0 and (gather_fn is not None or pool_fn is not None) and not pre_sorted:
            # a per-shard Morton sort would be wrong: banded CP sorts the
            # whole event before sharding it
            raise ValueError("knn_window with context-parallel graph ops needs a pre_sorted "
                             "model: the caller sorts the whole event before it is sharded "
                             "(a model that sorts its own shard would build another graph)")
        self.spec = spec
        self.pre_sorted = pre_sorted
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
        self.block_impls = tuple(self._form(d, c) for d, c in zip(depths, spec.edge_filters))
        forced = [i for i, f in enumerate(self.block_impls)
                  if spec.block_impl not in ("auto", "edge") and f == "edge"]
        if forced:
            reason = (f"compute_dtype={spec.compute_dtype!r}"
                      if spec.compute_dtype != "float32"
                      else f"block_convs={spec.block_convs}")
            warnings.warn(f"block_impl={spec.block_impl!r} requires f32 depth-1 blocks (or "
                          f"depth-2 ones the fused_mlp kernels take, for 'fused'); {reason} "
                          f"forces the 'edge' implementation on blocks {forced}")

    def _form(self, depth: int, width: int) -> str:
        """The form of a block of MLP depth ``depth`` and ``width`` output
        channels. An f32 depth-1 block restructures (``auto``: fused where
        the gather allows it, else edge). An f32 depth-2 block trains as
        ``fused_mlp`` under ``auto`` or ``fused`` where the gather is local
        and the kernels take its width and k
        (`kernels.edge_mlp_cuda.shape_ok`); it evaluates in the edge form.
        A bf16 model rounds each edge's pre-activation before BN, which the
        fused forms (f32 algebra) cannot reproduce, and deeper stacked
        convs need the edge tensor: both take the edge form, an explicit
        fused/reduced with a warning, as in the JAX package."""
        spec = self.spec
        f32 = spec.compute_dtype == "float32"
        if (f32 and depth == 2 and spec.block_impl in ("auto", "fused") and self.fused_gather_ok
                and edge_mlp_cuda.shape_ok(width, spec.k)):
            return "fused_mlp"
        restructurable = f32 and depth == 1
        if spec.block_impl == "auto":
            return "fused" if restructurable and self.fused_gather_ok else "edge"
        return spec.block_impl if restructurable else "edge"

    @property
    def block_impl(self) -> str:
        """The form every block takes, or ``"mixed"``."""
        forms = set(self.block_impls)
        return forms.pop() if len(forms) == 1 else "mixed"

    def init(self, in_dim: int, generator: torch.Generator | None = None):
        """Glorot-initialised ``(params, state)`` in the JAX tree layout, on
        the CPU from a CPU generator, drawn in the JAX package's order
        (blocks with their stacked convs and projections, head feature conv,
        head MLP, output layer)."""
        spec = self.spec
        g = generator if generator is not None else torch.Generator()
        blocks, block_states = [], []
        c_in = in_dim
        for c_out, depth in zip(spec.edge_filters, spec.depths):
            p, s = conv_bn_init(g, 2 * c_in, c_out)
            if depth > 1:
                # stacked per-edge convs; the state becomes a dict only at
                # depth >= 2, as in the JAX tree
                extra = [conv_bn_init(g, c_out, c_out) for _ in range(depth - 1)]
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
        """One EdgeConv block in the compute dtype; returns ``(y,
        new_block_state)``, ``y`` in the compute dtype."""
        spec = self.spec
        cd = self.cdtype
        bn = dict(train=train, momentum=spec.bn_momentum, group=bn_group)
        # factorized pre-activation h_ij = P_i + Q_j, P = x@(Wa-Wb), Q = x@Wb
        c = x.shape[-1]
        w = blk_p["w"].to(cd)
        wa, wb = w[:c], w[c:]
        p_feat = torch.matmul(x, wa - wb)
        q_feat = torch.matmul(x, wb)
        stacked = "extra" in blk_p  # MLP depth >= 2
        form = self._form(1 + len(blk_p.get("extra", ())), w.shape[-1])
        fused_mlp = form == "fused_mlp" and train
        if (form == "fused" or fused_mlp) and self.fused_gather_ok:
            block_forms["fused_mlp" if fused_mlp else "fused" if train else "reduced"] += 1
            if self.gather_fn is None:
                q_in, idx_in = q_feat, idx
            else:
                # exchange once, gather locally
                q_in, idx_in = self.gather_extend_fn(q_feat), self.gather_localize_fn(idx)
            if fused_mlp:
                y, bn_s = edgeconv_block_fused_mlp(p_feat, q_in, blk_p["bn"], blk_p["extra"][0],
                                                   blk_s, idx_in, mask, momentum=spec.bn_momentum,
                                                   group=bn_group)
            else:
                y, bn_s = edgeconv_block_fused(p_feat, q_in, blk_p["bn"], blk_s, idx_in, mask,
                                               **bn)
        elif form in ("reduced", "fused"):
            block_forms["reduced"] += 1
            y, bn_s = edgeconv_block_reduced(p_feat, q_feat, blk_p["bn"], blk_s, idx, mask,
                                             gather_fn=self.gather_fn, **bn)
        elif (not train and self.gather_fn is None
                and static_elems(idx.shape) * q_feat.shape[-1] >= EDGE_EVAL_STREAM_ELEMS):
            # huge-N eval: the per-edge chain one slot at a time, no
            # (B, N, k, C) gather
            block_forms["edge_stream"] += 1
            y, bn_s = self._edge_stream_eval(p_feat, q_feat, idx, blk_p, blk_s), blk_s
        else:
            block_forms["edge"] += 1
            # (B, N, k, C) in the compute dtype, rounded before BN; BN gives
            # f32, and the chain after it (relu, max, residual) stays f32
            h = p_feat[..., :, None, :] + (self.gather_fn or gather_neighbors)(q_feat, idx)
            bn_mask = None if mask is None else mask[..., None]  # over the k slots too
            h, bn_s0 = batch_norm_apply(blk_p["bn"], blk_s["main"] if stacked else blk_s, h,
                                        bn_mask, **bn)
            h = torch.relu(h)
            if stacked:
                # stacked per-edge conv + BN + relu on the (B, N, k, C) tensor
                extra_states = []
                # (the edge tensor enters each conv in the compute dtype and
                # leaves its BN in f32, as in the JAX package)
                with span("dgcnn.edge_mlp"):
                    for ep, es in zip(blk_p["extra"], blk_s["extra"]):
                        h, es2 = batch_norm_apply(ep["bn"], es, dense_apply(ep, h.to(cd), cd),
                                                  bn_mask, **bn)
                        h = torch.relu(h)
                        extra_states.append(es2)
                bn_s = {"main": bn_s0, "extra": extra_states}
            else:
                bn_s = bn_s0
            y = h.amax(dim=-2)
        if spec.residual:
            shortcut = dense_apply(blk_p["proj"], x, cd) if "proj" in blk_p else x
            y = y + shortcut.to(y.dtype)
        return y.to(cd), bn_s

    def _edge_stream_eval(self, p_feat, q_feat, idx, blk_p, blk_s):
        """The edge form's eval a neighbour slot at a time (port of the JAX
        `models/dgcnn.py:519-592`): each slot's ``P_i + Q_j`` through the
        running-statistics BN, relu and the stacked convs, folded into a
        max carry in the compute dtype (the cast is monotone, so f32 is
        bitwise the dense edge eval; bf16 rounds once before the residual
        instead of after, within a bf16 ulp). Returns the f32 max."""
        cd = self.cdtype
        stacked = "extra" in blk_p

        def chain(h):
            h = torch.relu(batch_norm_apply(blk_p["bn"], blk_s["main"] if stacked else blk_s,
                                            h)[0])
            for ep, es in zip(blk_p.get("extra", ()), blk_s["extra"] if stacked else ()):
                h = torch.relu(batch_norm_apply(ep["bn"], es, dense_apply(ep, h.to(cd), cd))[0])
            return h.to(cd)

        acc = chain(p_feat + gather_slot(q_feat, idx, 0))
        for s in range(1, idx.shape[-1]):
            torch.maximum(acc, chain(p_feat + gather_slot(q_feat, idx, s)), out=acc)
        return acc.float()

    def forward(self, params, state, points, mask=None, *, train: bool = False,
                generator: torch.Generator | None = None, bn_group=None):
        """``points`` ``(B, N, F)``, ``mask`` ``(B, N)`` bool or None.

        Eval: running BN statistics; returns ``(logits (B, N, num_class)
        float32, state)`` with the state unchanged. Train: masked batch
        statistics; returns ``(logits, new_state)``, the running averages
        updated, and dropout drawn from ``generator`` (none without one,
        as the JAX ``apply`` with ``rng=None``). ``bn_group`` (an axis
        view of the rank group, the JAX ``bn_axis``) merges every train
        BN layer's statistics over its ranks (sync BN; under context
        parallelism the points axis or both axes, see the module
        docstring)."""
        spec = self.spec
        x = points.float()
        cd = self.cdtype
        inv_pos = None
        if spec.knn_window > 0 and not self.pre_sorted:
            # banded kNN: run the whole network in Morton order, padded
            # points last; every op up to the exit unpermute is
            # permutation-invariant given the permuted mask
            order, inv_pos = morton_order(x, mask)
            x = torch.gather(x, -2, order[..., None].expand(x.shape))
            if mask is not None:
                mask = torch.gather(mask, -1, order)
        x = x.to(cd)
        knn_fn = self.knn_fn or default_knn_fn(x.device, window=spec.knn_window)
        # remat: backward recomputes each block from its saved inputs (x,
        # idx, the parameters) instead of holding its edge tensors
        remat = spec.remat and torch.is_grad_enabled()
        block_feats, block_states = [], []
        idx = None
        for i, (blk_p, blk_s) in enumerate(zip(params["blocks"], state["blocks"])):
            if i % spec.knn_every == 0:
                # the graph build is stop-gradient
                with torch.no_grad(), span("dgcnn.graph"):
                    # dynamic graph, from the f32 values of the block input
                    idx, _ = knn_fn(x.detach().float(), spec.k, mask)
            with span("dgcnn.edgeconv"):
                if remat:
                    x, bn_s = torch.utils.checkpoint.checkpoint(
                        self._block, x, idx, blk_p, blk_s, mask, train, bn_group,
                        use_reentrant=False, preserve_rng_state=False)
                else:
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
            rows = static_elems(block_feats[0].shape[:-1])
            stream = stream_pool_ok and rows * max(spec.head_feat_dim, 1) >= head_mod.HEAD_STREAM_ELEMS
        else:
            stream = stream_pool_ok and spec.head_stream == "on"
        with span("dgcnn.head"):
            if stream:
                logits, head_state = head_mod.head_streamed(
                    params["head"], state["head"], block_feats, mask, spec=spec,
                    pool_fn=self.pool_fn, train=train, cdtype=cd, generator=generator,
                    group=bn_group,
                )
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
        """The dense head: ``(logits f32, new_head_state)``; its matmuls in
        the compute dtype."""
        spec = self.spec
        cd = self.cdtype
        bn = dict(train=train, momentum=spec.bn_momentum, group=bn_group)
        agg = torch.cat(block_feats, dim=-1)  # (B, N, sum C)
        feat, feat_s = conv_bn_apply(head_p["feat"], head_s["feat"], agg, mask, dtype=cd, **bn)
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
                w = p["w"].to(cd)
                pre = torch.matmul(h, w[:ca]) + torch.matmul(g_vec, w[ca:])[..., None, :]
                h, s2 = batch_norm_apply(p["bn"], s, pre, mask, **bn)
                h = torch.relu(h).to(pre.dtype)
            else:
                h, s2 = conv_bn_apply(p, s, h, mask, dtype=cd, **bn)
            h = dropout(h, spec.dropout, train=train, generator=generator)
            mlp_states.append(s2)
        return dense_apply(head_p["out"], h, cd).float(), {"feat": feat_s, "mlp": mlp_states}


def make_model(spec: ModelSpec, knn_fn=None, pre_sorted: bool = False, **graph_ops) -> Model:
    """Build the DGCNN model for ``spec`` (see `Model`); ``graph_ops`` are
    `Model`'s ``gather_fn``, ``pool_fn``, ``gather_extend_fn`` and
    ``gather_localize_fn``."""
    return Model(spec, knn_fn=knn_fn, pre_sorted=pre_sorted, **graph_ops)
