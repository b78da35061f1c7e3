"""Graph build (`kernels.knn_cuda`, `kernels.ops`, `csrc/knn.cu`): the
least time the window's graph builds need (``t.bounds_s["knn"]``: the
network's ``work()``, each build by `portbench.flops.knn_bound_s` at the
configuration's peak) over the device time of the exact kNN kernels in
the trace, in percent. Moves ``train_points_per_s``."""

import re

# the fp32 sweep, its split merge and the Hopper tensor-core kernel
KERNELS = re.compile(r"knn_topk_kernel|knn_merge_kernel|knn_tc_kernel")


def read(t):
    if t.kind != "train":
        return None
    bound = t.bounds_s.get("knn")
    busy = sum(e - s for name, s, e in t.device_ops if KERNELS.search(name))
    return 100.0 * bound / busy if bound is not None and busy > 0 else None
