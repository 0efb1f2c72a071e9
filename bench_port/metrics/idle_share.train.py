"""The share of the profiled training steps in which no kernel or copy
ran on the device: 1 - (union of device intervals) / (window)."""

SOURCE, UNIT, BETTER = "device_trace", "%", "lower"
LAYER, MOVES = "device", "train_pairs_per_s"


def read(ctx):
    p = ctx["profile"]
    if p["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
