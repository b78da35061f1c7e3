"""Masked, weighted per-point segmentation loss and metrics (port of
`dgcnn_tpu/ops/loss.py`)."""

from __future__ import annotations

import torch


def _point_weights(labels, weights, mask, dtype):
    w = torch.ones(labels.shape, dtype=dtype, device=labels.device)
    if mask is not None:
        w = w * mask.to(dtype)
    if weights is not None:
        w = w * weights.to(dtype)
    return w


def softmax_cross_entropy(logits, labels, weights=None, mask=None):
    """Weighted mean of per-point cross entropy over valid points; the
    weight sum is floored at 1e-9 so an all-masked batch gives 0."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    w = _point_weights(labels, weights, mask, logits.dtype)
    return -torch.sum(ll * w) / torch.clamp(torch.sum(w), min=1e-9)


def accuracy(logits, labels, mask=None):
    """Overall per-point accuracy over valid points."""
    pred = torch.argmax(logits, dim=-1)
    correct = (pred == labels).to(logits.dtype)
    if mask is None:
        return torch.mean(correct)
    m = mask.to(logits.dtype)
    return torch.sum(correct * m) / torch.clamp(torch.sum(m), min=1e-9)


def confusion_matrix(pred, labels, num_class: int, mask=None):
    """``(num_class, num_class)`` float32 counts; rows = truth, cols =
    prediction. Masked points count in no row."""
    cls = torch.arange(num_class, dtype=torch.int64, device=labels.device)
    onehot = (labels.reshape(-1, 1).long() == cls).float()
    pred_onehot = (pred.reshape(-1, 1).long() == cls).float()
    if mask is not None:
        onehot = onehot * mask.reshape(-1, 1).float()
    return onehot.T @ pred_onehot


def per_class_accuracy(cm):
    """Recall per class from a confusion matrix; 0 where a class is absent."""
    row = torch.sum(cm, dim=1)
    return torch.where(
        row > 0, torch.diagonal(cm) / torch.clamp(row, min=1.0), 0.0
    )


def mean_iou(cm):
    """Mean intersection-over-union over classes present in truth or pred."""
    inter = torch.diagonal(cm)
    union = torch.sum(cm, dim=0) + torch.sum(cm, dim=1) - inter
    present = union > 0
    iou = torch.where(present, inter / torch.clamp(union, min=1.0), 0.0)
    return torch.sum(iou) / torch.clamp(torch.sum(present.to(iou.dtype)), min=1.0)
