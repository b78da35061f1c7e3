"""Train and serve entry (`train.trainval`, `train/loop.py`'s serving
loop): the 95th percentile of the traced window's batch latencies, each
from the moment the batch leaves the prefetch iterator to its packed
output on the host, in milliseconds (host clock). Moves
``serve_points_per_s``: in a loop that labels as fast as the card goes,
a batch's latency is the host's and the card's time for it, plus the
batches ahead of it in the consumer's queue."""

import numpy as np


def read(t):
    if t.kind != "serve" or not t.latencies:
        return None
    return float(np.percentile(t.latencies, 95)) * 1e3
