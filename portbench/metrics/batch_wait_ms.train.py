"""Host batching and transfer (`io.batching`, `io.prefetch`): the mean
milliseconds a step waited in ``next()`` on the prefetch iterator, from
the benchmark's span ``portbench.batch_wait``. Moves ``train_points_per_s``."""


def read(t):
    waits = t.spans.get("portbench.batch_wait") if t.kind == "train" else None
    if not waits:
        return None
    return 1e3 * sum(e - s for s, e in waits) / len(waits)
