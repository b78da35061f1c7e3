"""Parameters across packages: the JAX model's pytree as numpy <-> the
port's dicts of tensors.

The JAX tree (`dgcnn_tpu/models/dgcnn.py:327-370`) is
``{"blocks": [{w, bn: {scale, bias}, extra?: [{w, bn}], proj?: {w, b}}],
"head": {feat, mlp, out}}`` with the BN state ``{"blocks": [{mean, var}],
"head": {feat, mlp}}``; with stacked per-edge convs (``block_convs >= 2``)
a block's state is ``{"main": {mean, var}, "extra": [{mean, var}]}``. The
port keeps the same tree and the same ``(din, dout)`` weight layout, so
the bridge only converts leaves. It imports no JAX: a caller
turns a JAX tree into numpy first, e.g. with
``jax.tree_util.tree_map(np.asarray, params)``. Optimizer state does not
cross: each side starts its optimizer fresh (carrying optax state belongs
to the checkpoint slice, ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples, dict keys in
    sorted order (the order of JAX's ``tree_leaves``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def params_from_numpy(params, state, device="cpu"):
    """``(params, state)`` of numpy arrays -> the same trees of float32
    tensors on ``device``."""

    def leaf(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    return tree_map(leaf, params), tree_map(leaf, state)


def params_to_numpy(params, state):
    """The port's ``(params, state)`` -> the same trees of numpy arrays."""

    def leaf(t):
        return t.detach().cpu().numpy()

    return tree_map(leaf, params), tree_map(leaf, state)
