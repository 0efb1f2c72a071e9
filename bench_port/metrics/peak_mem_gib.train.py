"""The training run's peak device memory in GiB, from the allocator's
counter (``torch.cuda.max_memory_allocated``) after the profiled
steps: train-mode BatchNorm's float32 temporaries set it."""

SOURCE, UNIT, BETTER = "program_counter", "GiB", "lower"
LAYER, MOVES = "training step", "train_pairs_per_s"


def read(ctx):
    peak = ctx.get("memory_peak") or 0
    return peak / 2 ** 30 if peak > 0 else None
