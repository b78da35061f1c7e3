"""Parameters across packages: the JAX model's pytree as numpy <-> the
port's dicts of tensors.

The JAX tree (`dgcnn_tpu/models/dgcnn.py:327-370`) is
``{"blocks": [{w, bn: {scale, bias}, proj?: {w, b}}], "head": {feat, mlp,
out}}`` with the BN state ``{"blocks": [{mean, var}], "head": {feat,
mlp}}``. The port keeps the same tree and the same ``(din, dout)`` weight
layout, so the bridge only converts leaves. It imports no JAX: a caller
turns a JAX tree into numpy first, e.g. with
``jax.tree_util.tree_map(np.asarray, params)``.
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
