"""The benchmark of ``dgcnn_tpu_torch`` on NVIDIA H100 cards: the
harness (`run`, `harness`), the plain reference (`reference`), the event
generator (`events`), the weights (`weights`), the work and peaks
(`flops`), the trace reduction (`trace`), the comparisons (`check`) and
the control's readings (`control`). ``BENCHMARK.json`` at the checkout's
root names the cells; each configuration, traffic mix, cell and per-layer
metric has a file of its own here."""
