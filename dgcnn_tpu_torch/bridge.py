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
``jax.tree_util.tree_map(np.asarray, params)``. Optimizer state crosses
through checkpoints (`train.checkpoint`, which reads and writes the JAX
package's files).
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


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure whose leaves are ``leaves``, in
    `tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


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
