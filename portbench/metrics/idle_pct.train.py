"""Device (one H100): the share of the traced window in which no kernel,
copy or memset ran on the card, in percent (overlapping operations count
once). Moves ``train_points_per_s``."""


def read(t):
    if t.kind != "train" or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
