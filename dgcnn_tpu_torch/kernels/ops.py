"""The graph builds as registered operators, so that an exported program
(`train.export`, ``torch.export``) holds them as single nodes that launch
the hand-written kernels when the program runs.

- ``dgcnn_tpu_torch::knn(Tensor x, int k, Tensor? mask, str precision)``:
  the exact self-form graph build (`knn_cuda.knn_cuda`).
- ``dgcnn_tpu_torch::knn_banded(Tensor x, int k, Tensor? mask, int window,
  str precision)``: the banded one (`knn_banded_cuda.knn_banded_cuda`), the
  window clipped to N.

Each returns ``(idx int32, valid bool, scores f32)``, each ``(B, N, k)``
and contiguous, and has three implementations: on CUDA the kernel's launch
(`knn_cuda._launch`, `knn_banded_cuda._launch`, which raise on what they do
not take: no fallback); on the CPU the plain version (`knn_cuda.knn_plain`,
`knn_banded_cuda.knn_banded_plain`); and a fake one that gives the outputs'
shapes, dtypes and strides alone, which tracing and a meta tensor take. No
other device has an implementation.

A process that loads an exported program imports this module to register
the operators: it needs ``torch`` and the kernel modules, nothing of the
models, the trainer, the IO or the configuration. On the card the first
launch builds the kernels from ``csrc/`` (`kernels._build`).
"""

from __future__ import annotations

import torch

from dgcnn_tpu_torch.kernels import knn_banded_cuda as _banded
from dgcnn_tpu_torch.kernels import knn_cuda as _exact

Outputs = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@torch.library.custom_op("dgcnn_tpu_torch::knn", mutates_args=(), device_types="cpu")
def knn(x: torch.Tensor, k: int, mask: torch.Tensor | None, precision: str) -> Outputs:
    """The exact graph build of ``x`` ``(B, N, C)`` f32 over itself; on the
    CPU the plain version."""
    return _exact.knn_plain(x, x, k, mask, precision)


@knn.register_kernel("cuda")
def knn_launch(x, k, mask, precision):
    return _exact._launch(x, x, k, mask, precision)


def _band(x, window: int) -> dict:
    return dict(window=min(window, x.shape[1]), q_base=0, key_base=0, nvalid=None)


@torch.library.custom_op("dgcnn_tpu_torch::knn_banded", mutates_args=(), device_types="cpu")
def knn_banded(x: torch.Tensor, k: int, mask: torch.Tensor | None, window: int,
               precision: str) -> Outputs:
    """The banded graph build of Morton-sorted ``x`` ``(B, N, C)`` f32; on
    the CPU the plain version."""
    return _banded.knn_banded_plain(x, x, k, mask, precision=precision, **_band(x, window))


@knn_banded.register_kernel("cuda")
def knn_banded_launch(x, k, mask, window, precision):
    return _banded._launch(x, x, k, mask, precision=precision, **_band(x, window))


def _outputs_like(x, k: int) -> Outputs:
    shape = (x.shape[0], x.shape[1], k)
    return (x.new_empty(shape, dtype=torch.int32), x.new_empty(shape, dtype=torch.bool),
            x.new_empty(shape, dtype=torch.float32))


@knn.register_fake
def _(x, k, mask, precision):
    return _outputs_like(x, k)


@knn_banded.register_fake
def _(x, k, mask, window, precision):
    return _outputs_like(x, k)
