"""The plain reference of the paper's segmentation DGCNN: the residual
network's reference (`residual_dgcnn.reference`: the graph build, BN,
the head, the loss, Adam, the ``matmul`` precisions) with each block's
MLP run on the materialised edge features, as the paper writes it:

- ``e_ij = [x_i, x_j - x_i]`` over the ``k`` neighbours of the block's
  own graph;
- the block's convolutions in turn (``w``, then each of ``extra``), each
  a matmul followed by BN (train: the batch's biased statistics over
  points and neighbours; eval: the running ones) and relu;
- the max over the neighbours, with no shortcut.

A block of depth 1 holds its BN state as ``{"mean", "var"}``, a deeper
one as ``{"main": ..., "extra": [...]}`` (the program's tree).
"""

from __future__ import annotations

import torch

from .residual import reference as base


class Reference(base.Reference):
    """The network for one configuration's ``model`` section: the residual
    network's keys, ``residual`` false, and ``block_convs`` (each
    block's depth: the length of its ``extra`` plus one, read from the
    weights)."""

    def _edgeconv(self, p, s, x, train: bool):
        idx = self.knn(x)
        b, n, k = idx.shape
        c = x.shape[-1]
        xj = torch.gather(x, 1, idx.reshape(b, n * k, 1).expand(b, n * k, c)).view(b, n, k, c)
        xi = x[:, :, None, :].expand(b, n, k, c)
        h = torch.cat([xi, xj - xi], dim=-1)
        stacked = "extra" in p
        convs = [p] + list(p.get("extra", ()))
        states = [s["main"]] + list(s["extra"]) if stacked else [s]
        out = []
        for cp, cs in zip(convs, states):
            h, cs = self._bn(cp["bn"], cs, self._mm(h, cp["w"]), train)
            h = torch.relu(h)
            out.append(cs)
        new = {"main": out[0], "extra": out[1:]} if stacked else out[0]
        return h.amax(dim=2), new
