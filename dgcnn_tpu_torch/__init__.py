"""dgcnn_tpu_torch — the PyTorch/CUDA port of `dgcnn_tpu` for NVIDIA Hopper.

A second package beside the JAX one, module for module: ``io``, ``config``,
``ops``, ``models``, ``kernels`` and ``train`` keep the JAX package's layout
and names so each counterpart is easy to find. Plain tensor code is
PyTorch; every Pallas kernel of the JAX package becomes a kernel written by
hand for ``sm_90a`` (sources under ``csrc/``, built at first use by
``kernels._build``), with a plain PyTorch version beside it that the CPU
path and the tests use.

This package imports ``torch`` and numpy only — never jax, flax, optax or
any module of ``dgcnn_tpu``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.

Covered so far: the command line (``python -m dgcnn_tpu_torch train |
inference | info``, ``cli``) with the driver loops (``train.loop``),
checkpoints in the JAX package's file format (``train.checkpoint``) and
the event IO (``io``: h5, npz, csv, DGB with its C++ batch reader);
single-device training (``train.Trainval.train_step``); the eval-mode
serving path of the DGCNN models (``train.Trainval.inference``) with the
exact kNN as a CUDA kernel (``kernels.knn_cuda``), long events with the
banded kNN (``kernels.knn_banded_cuda``), and exact context parallelism
over point shards, one process a shard (``parallel``), with the ring kNN
(``kernels.ring_knn_cuda``). ROADMAP.md lists what is still to be ported.
"""

__version__ = "0.1.0"
