"""Train and serve entry (`train.trainval`): the window's model
operations (the network's ``work()``; for ``residual_dgcnn`` the graph
builds' pairs, the factorised EdgeConv matmuls, the head, and a step's
backward as twice its matmuls) over the traced window's seconds times
the configuration's peak, in percent. Moves ``train_points_per_s``."""


def read(t):
    if t.kind != "train" or t.units == 0:
        return None
    return 100.0 * t.model_flops / (t.window_s * t.peak_flops)
