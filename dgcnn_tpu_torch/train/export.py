"""Serving export (port of `dgcnn_tpu/train/export.py`): a trained
checkpoint baked into a self-contained ``torch.export`` artifact, the
parameters as constants and the point count static, that a process loads
and calls without the checkpoint, the models, the trainer or the
configuration. CLI:

  python -m dgcnn_tpu_torch export -mp weights/snap -np 4096 -of model.pt2
  python -m dgcnn_tpu_torch export -mp weights/snap -np 4096 -mb 0 -of model.pt2

The artifact computes the function the port's live server computes on the
same device: the model is built as `train.trainval.Trainval` builds it
(`knn_fn_for`, so ``--knn_precision`` and ``--no_pallas`` count, and the
compute dtype of ``--precision``). On the card its graph builds are the
registered operators of `kernels.ops` (``dgcnn_tpu_torch::knn`` and
``::knn_banded``), one node a build, which launch the hand-written kernels
when the artifact runs, never a plain version in their place; on the CPU
they are the plain oracles the live CPU path runs. The artifact serves the
device it was made on (the program asserts its inputs' device), as a JAX
artifact is bound to its platform. Mesh flags (``-nd``, ``-ps``) do not
change it: it is the one-device function.
"""

from __future__ import annotations

import io

import torch

# the batch a shape-polymorphic export is traced at: torch specialises a
# dim traced at size 0 or 1, so the trace takes 2 and `Dim("b", min=1)`
# still admits 1
POLY_TRACE_BATCH = 2


def export_model(cfg, state, in_dim: int = 4, batch: int = 1, device=None) -> bytes:
    """Serialize eval-mode inference at ``(batch, num_point, in_dim)``.

    ``batch=0`` exports a shape-polymorphic artifact: the batch dimension
    is symbolic (at least 1, no upper bound), so one artifact serves any
    request batch size; the point count stays static. ``state`` holds
    ``params`` and ``model_state`` as tensors on ``device`` (default
    ``cuda``).

    Returns the bytes of ``torch.export.save``. The artifact's signature
    is ``(points f32[B,N,F], mask bool[B,N]) -> scores f32[B,N,C]``.
    """
    from dgcnn_tpu_torch.models import get_model
    from dgcnn_tpu_torch.train.trainval import disable_tf32, knn_fn_for, resolve_device

    if cfg.num_point <= 0:
        raise ValueError("export requires --num_point (static serving shape)")
    device = resolve_device(device)
    disable_tf32()
    knn_fn = knn_fn_for(device, cfg.use_pallas, cfg.knn_precision, cfg.knn_window)
    model = get_model(cfg.model_name, cfg.model_spec(), knn_fn=knn_fn)
    params, mstate = state.params, state.model_state

    class Serve(torch.nn.Module):
        def forward(self, points, mask):
            logits, _ = model(params, mstate, points, mask, train=False)
            return torch.softmax(logits, dim=-1)

    b = POLY_TRACE_BATCH if batch == 0 else batch
    example = (torch.zeros((b, cfg.num_point, in_dim), dtype=torch.float32, device=device),
               torch.ones((b, cfg.num_point), dtype=torch.bool, device=device))
    dynamic = None
    if batch == 0:
        dim = torch.export.Dim("b", min=1)
        dynamic = ({0: dim}, {0: dim})
    with torch.no_grad():
        ep = torch.export.export(Serve(), example, dynamic_shapes=dynamic)
    # the trace's zero inputs would be saved beside the program (17 MB at
    # 1 x 1,048,576 points): the artifact keeps the parameters alone
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def load_exported(path_or_bytes):
    """Deserialize an exported artifact; returns a callable ``(points,
    mask) -> scores`` on the device the artifact was made on. Needs
    ``torch`` and `kernels.ops` (imported here to register the graph
    builds' operators) alone."""
    import dgcnn_tpu_torch.kernels.ops  # noqa: F401  (registers the operators)

    data = path_or_bytes
    if isinstance(data, (bytes, bytearray)):
        data = io.BytesIO(data)
    return torch.export.load(data).module()


def run_export(cfg, device=None) -> str:
    """CLI driver: restore checkpoint -> export -> write artifact file."""
    import types

    import numpy as np

    from dgcnn_tpu_torch.bridge import tree_map
    from dgcnn_tpu_torch.models import get_model
    from dgcnn_tpu_torch.train import checkpoint
    from dgcnn_tpu_torch.train.trainval import resolve_device

    if not cfg.model_path:
        raise ValueError("export requires --model_path")
    if not cfg.output_file:
        raise ValueError("export requires --output_file")
    # only params + BN state matter for serving: optimizer/schedule flags
    # of the original run are irrelevant here. in_dim comes from the
    # checkpoint itself: the first EdgeConv weight is (2*in_dim, C_out),
    # so a model trained on F!=4 events exports correctly.
    payload = checkpoint.peek(cfg.model_path)
    # serve exactly the trained function: adopt the checkpoint's
    # model-defining flags (kvalue/knn_every/... don't all change
    # parameter shapes, so a mismatch would export a DIFFERENT model
    # from byte-identical weights without any error)
    cfg = checkpoint.adopt_model_flags(cfg, payload=payload)
    try:
        in_dim = int(payload["tree"]["params"]["blocks"]["0"]["w"].shape[0]) // 2
    except (KeyError, AttributeError) as e:
        raise ValueError(
            f"cannot derive in_dim from checkpoint {cfg.model_path!r}: {e}"
        ) from e
    device = resolve_device(device)
    params0, mstate0 = get_model(cfg.model_name, cfg.model_spec()).init(in_dim)
    loaded, step, _ = checkpoint.restore_subtrees(
        cfg.model_path, {"params": params0, "model_state": mstate0}, payload=payload,
    )
    on_device = lambda a: torch.tensor(np.asarray(a), device=device)  # noqa: E731
    state = types.SimpleNamespace(
        params=tree_map(on_device, loaded["params"]),
        model_state=tree_map(on_device, loaded["model_state"]),
    )
    blob = export_model(cfg, state, in_dim=in_dim, batch=cfg.minibatch_size, device=device)
    with open(cfg.output_file, "wb") as f:
        f.write(blob)
    bdesc = "b" if cfg.minibatch_size == 0 else str(cfg.minibatch_size)
    print(
        f"exported step-{step} model ({len(blob)/1e6:.2f} MB, shapes "
        f"[{bdesc},{cfg.num_point},{in_dim}]) -> {cfg.output_file}",
        flush=True,
    )
    return cfg.output_file
