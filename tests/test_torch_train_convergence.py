"""Training-quality pin of the port: the copy of
`tests/test_convergence.py::test_pinned_convergence` for the port's trainer
on the CPU.

The same fixed synthetic dataset, seed and configuration (240 steps, 3 x 24
residual DGCNN, N=512, k=8, 4 events a batch, 64 training events, the plain
graph build), the JAX init at ``PRNGKey(7)`` bridged into the port, and the
same floors: final loss <= 0.62, held-out accuracy >= 0.575 and mIoU >= 0.40
(the JAX package recorded 0.492, 0.624 and 0.448).
"""

import jax
import numpy as np
import torch

from dgcnn_tpu.config import Config as JaxConfig
from dgcnn_tpu.models import get_model as jax_get_model
from dgcnn_tpu_torch.bridge import params_from_numpy
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.io import BucketBatcher, SyntheticIO
from dgcnn_tpu_torch.ops.loss import mean_iou
from dgcnn_tpu_torch.train.trainval import Trainval


def _run(steps=240, n_point=512, minibatch=4, num_events=64, seed=7):
    kw = dict(model_name="residual-dgcnn", num_class=2, kvalue=8, edge_filters=(24, 24, 24),
              head_feat_dim=64, head_mlp=(32,), minibatch_size=minibatch, num_point=n_point,
              use_pallas=False, iteration=steps, seed=seed)
    tv = Trainval(Config(**kw), device="cpu")
    jmodel = jax_get_model(kw["model_name"], JaxConfig(**kw).model_spec())
    params, mstate = jmodel.init(jax.random.PRNGKey(seed), 4)
    state = tv.with_params(*params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                              jax.tree_util.tree_map(np.asarray, mstate)))
    io = SyntheticIO(num_events=num_events, num_point=n_point, seed=seed)
    io.initialize()
    batcher = BucketBatcher(io, minibatch, num_point=n_point, shuffle=True, seed=seed)
    losses = []
    for i, batch in enumerate(batcher.forever()):
        if i >= steps:
            break
        state, metrics = tv.train_step(state, batch)
        if (i + 1) % max(steps // 10, 1) == 0:
            losses.append(float(metrics["loss"]))
    val_io = SyntheticIO(num_events=16, num_point=n_point, seed=seed + 1)
    val_io.initialize()
    cm = np.zeros((2, 2), np.float64)
    for batch in BucketBatcher(val_io, minibatch, num_point=n_point, shuffle=False).epoch():
        cm += tv.evaluate(state, batch)["confusion"].numpy().astype(np.float64)
    return {"final_loss": losses[-1], "val_acc": float(np.trace(cm) / cm.sum()),
            "val_miou": float(mean_iou(torch.tensor(cm)))}


def test_pinned_convergence():
    out = _run()
    print(out)
    assert np.isfinite(out["final_loss"])
    assert out["final_loss"] <= 0.62, out
    assert out["val_acc"] >= 0.575, out
    assert out["val_miou"] >= 0.40, out
