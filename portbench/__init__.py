"""The benchmark of ``dgcnn_tpu_torch`` on NVIDIA H100 cards: the
harness (`run`, `harness`), the networks (`networks`: each one's plain
reference, weights and work count), the event generator (`events`), the
kernels' work and the peaks (`flops`), the trace reduction (`trace`),
the comparisons (`check`) and the control's readings (`control`).
``BENCHMARK.json`` at the checkout's root names the cells; each network,
configuration, traffic mix, cell and per-layer metric has a file or a
package of its own here."""
