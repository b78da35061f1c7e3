"""The plain reference of the residual DGCNN segmentation network.

Written from the published model (Wang et al., "Dynamic Graph CNN for
Learning on Point Clouds", arXiv:1801.07829) with the residual blocks
and masked batch normalisation of the configuration's description, in
plain PyTorch, float32, TF32 off. It imports nothing but torch and the
benchmark's tree walk, and computes from the events and weights the
benchmark made:

- the kNN graph of every block from that block's input features: the
  ``k`` largest of ``2 x_i . x_j - |x_j|^2`` (the smallest squared
  distances, self included) by a matmul and ``torch.topk``, in strips of
  query rows;
- EdgeConv: ``h_ij = [x_i, x_j - x_i] @ W`` over the ``k`` neighbours,
  batch normalisation (train: the batch's biased statistics over points
  and neighbours; eval: the running ones; eps 1e-3), relu, the max over
  the neighbours, plus the shortcut (a dense projection where the width
  changes);
- the head: a 1x1 convolution of the blocks' concatenated outputs with
  BN and relu, a global max pool over the event's points, the
  concatenation of each point's features with the pooled vector, the MLP
  (1x1 convolution, BN, relu) and a dense output layer;
- the mean cross entropy over the points and Adam (betas 0.9, 0.999, eps
  1e-8 outside the square root, bias-corrected).

Events enter unpadded, so no mask is needed: a served event is computed
alone (in eval mode nothing couples the events of a batch), and the
train cells' events all have the same length.

``matmul`` sets what every matmul's operands are rounded to, forward and
backward: ``float32`` (none) or ``tf32`` (10 mantissa bits, to nearest
even: what the tensor cores' TF32 mode reads); products are summed in
float32. A configuration names its reference's precision (float32, as
it states) and its control's (tf32, the precision below float32 with
TF32 off).
"""

from __future__ import annotations

import torch

from portbench.tree import flatten, unflatten

BN_EPS = 1e-3
PRECISIONS = ("float32", "tf32")


def _top_k(score: torch.Tensor, k: int, spare: int = 8) -> torch.Tensor:
    """The ``k`` largest of each row, ties by the lower index first (the
    graph build's rule): ``torch.topk`` promises no order among equal
    values, so its ``k + spare`` largest are ordered by (value desc,
    index asc)."""
    v, i = torch.topk(score, min(k + spare, score.shape[-1]), dim=-1)
    by_index = torch.argsort(i, dim=-1, stable=True)
    v, i = torch.gather(v, -1, by_index), torch.gather(i, -1, by_index)
    by_value = torch.argsort(-v, dim=-1, stable=True)
    return torch.gather(i, -1, by_value)[..., :k]


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return x
    # tf32: keep 10 of float32's 23 mantissa bits, to nearest even
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, precision):
        ra, rb = _round(a, precision), _round(b, precision)
        ctx.save_for_backward(ra, rb)
        ctx.precision = precision
        return torch.matmul(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = _round(g, ctx.precision)
        ga = torch.matmul(rg, rb.transpose(-1, -2))
        gb = torch.matmul(ra.reshape(-1, ra.shape[-1]).transpose(0, 1),
                          rg.reshape(-1, rg.shape[-1]))
        return ga, gb, None


class Reference:
    """The network for one configuration's ``model`` section
    (``num_class``, ``k``, ``in_dim``, ``edge_filters``, ``residual``,
    ``head_feat_dim``, ``head_mlp``, ``bn_momentum``)."""

    def __init__(self, model: dict, matmul: str = "float32", strip: int = 8192):
        if matmul not in PRECISIONS:
            raise ValueError(f"unknown precision {matmul!r}")
        self.m = model
        self.precision = matmul
        self.strip = strip
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def _mm(self, a, b):
        return _Matmul.apply(a, b, self.precision)

    def _dense(self, p, x):
        y = self._mm(x, p["w"])
        return y + p["b"] if "b" in p else y

    def knn(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, N, k)`` indices of each point's ``k`` nearest points in
        ``x`` ``(B, N, C)``."""
        x = x.detach()
        sq = torch.sum(x * x, dim=-1)
        xt = x.transpose(1, 2)
        out = []
        with torch.no_grad():
            for lo in range(0, x.shape[1], self.strip):
                score = (2.0 * _Matmul.apply(x[:, lo:lo + self.strip], xt, self.precision)
                         - _round(sq, self.precision)[:, None, :])
                out.append(_top_k(score, int(self.m["k"])))
        return torch.cat(out, dim=1)

    def _bn(self, p, s, h, train: bool):
        if train:
            dims = tuple(range(h.dim() - 1))
            mean = h.mean(dim=dims)
            var = torch.square(h - mean).mean(dim=dims)
            mom = float(self.m["bn_momentum"])
            s = {"mean": mom * s["mean"] + (1 - mom) * mean.detach(),
                 "var": mom * s["var"] + (1 - mom) * var.detach()}
        else:
            mean, var = s["mean"], s["var"]
        return (h - mean) * torch.rsqrt(var + BN_EPS) * p["scale"] + p["bias"], s

    def _edgeconv(self, p, s, x, train: bool):
        idx = self.knn(x)
        b, n, k = idx.shape
        c = x.shape[-1]
        xj = torch.gather(x, 1, idx.reshape(b, n * k, 1).expand(b, n * k, c)).view(b, n, k, c)
        xi = x[:, :, None, :].expand(b, n, k, c)
        h = self._mm(torch.cat([xi, xj - xi], dim=-1), p["w"])
        h, s = self._bn(p["bn"], s, h, train)
        y = torch.relu(h).amax(dim=2)
        if self.m["residual"]:
            y = y + (self._dense(p["proj"], x) if "proj" in p else x)
        return y, s

    def forward(self, params, state, points: torch.Tensor, train: bool):
        """``(logits (B, N, num_class), new_state)`` of events ``points``
        ``(B, N, F)``."""
        x = points
        feats, block_states = [], []
        for p, s in zip(params["blocks"], state["blocks"]):
            x, s = self._edgeconv(p, s, x, train)
            feats.append(x)
            block_states.append(s)
        hp, hs = params["head"], state["head"]
        agg = torch.cat(feats, dim=-1)
        feat, feat_s = self._bn(hp["feat"]["bn"], hs["feat"], self._mm(agg, hp["feat"]["w"]),
                                train)
        feat = torch.relu(feat)
        pooled = feat.amax(dim=1, keepdim=True).expand(feat.shape)
        h = torch.cat([agg, pooled], dim=-1)
        mlp_states = []
        for p, s in zip(hp["mlp"], hs["mlp"]):
            h, s = self._bn(p["bn"], s, self._mm(h, p["w"]), train)
            h = torch.relu(h)
            mlp_states.append(s)
        logits = self._dense(hp["out"], h)
        return logits, {"blocks": block_states, "head": {"feat": feat_s, "mlp": mlp_states}}

    def log_probs(self, params, state, points: torch.Tensor) -> torch.Tensor:
        """Eval-mode class log-probabilities ``(N, num_class)`` of one
        event ``(N, F)``."""
        with torch.no_grad():
            logits, _ = self.forward(params, state, points[None], train=False)
        return torch.log_softmax(logits[0], dim=-1)

    def loss(self, params, state, points, labels, weights=None):
        """The mean cross entropy of a train-mode forward (``weights``, if
        given, a per-point weighting: ``sum(w l) / sum(w)``)."""
        logits, _ = self.forward(params, state, points, train=True)
        ll = torch.gather(torch.log_softmax(logits, dim=-1), -1, labels[..., None])[..., 0]
        if weights is None:
            return -ll.mean()
        return -(ll * weights).sum() / weights.sum()

    def train(self, params, state, batches, lr: float, weights_fn=None) -> dict:
        """Adam from ``params`` over ``batches`` (``(points, labels)`` each,
        ``(B, N, F)`` and ``(B, N)``), one step a batch. Returns each step's
        ``loss``, the first step's gradient ``grad1`` and the parameters'
        change after the last step ``change``, as ``{path: tensor}``.
        ``weights_fn(labels)`` gives a step's per-point loss weights."""
        named = flatten(params)
        start = [t.detach().clone() for _, t in named]
        live = [t.detach().clone().requires_grad_(True) for _, t in named]
        mu = [torch.zeros_like(t) for t in live]
        nu = [torch.zeros_like(t) for t in live]
        losses, grad1 = [], None
        for step, (points, labels) in enumerate(batches, 1):
            tree = unflatten(params, live)
            w = None if weights_fn is None else weights_fn(labels)
            loss = self.loss(tree, state, points, labels, w)
            grads = torch.autograd.grad(loss, live)
            losses.append(float(loss.detach()))
            if step == 1:
                grad1 = {name: g.detach().clone() for (name, _), g in zip(named, grads)}
            c1, c2 = 1 - 0.9 ** step, 1 - 0.999 ** step
            with torch.no_grad():
                for p, g, m, v in zip(live, grads, mu, nu):
                    m.mul_(0.9).add_(0.1 * g)
                    v.mul_(0.999).add_(0.001 * g * g)
                    p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + 1e-8))
            del grads, loss
        change = {name: (p.detach() - p0) for (name, _), p, p0 in zip(named, live, start)}
        return {"loss": losses, "grad1": grad1, "change": change}
