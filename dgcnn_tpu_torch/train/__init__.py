"""The trainer, eval path so far (port of `dgcnn_tpu/train`)."""
