"""The profiled training steps' share of the chip's peak: three times the
least time of their forward work at the bf16 peak (the trunk and
skip-pool head per valid crop, PointNet, fusion and det head per valid
detection, the link and new/end heads per valid pair of each frame
pair; ``harness/work.py::model_seconds`` with ``passes=3``: the forward
and a backward of twice its work) over the window's time."""

from bench_port.harness import work

SOURCE, UNIT, BETTER = "device_trace", "%", "higher"
LAYER, MOVES = "device", "train_pairs_per_s"


def read(ctx):
    p = ctx["profile"]
    if p["busy_s"] <= 0.0:
        return None
    w = ctx["work"]
    least = work.model_seconds(ctx["mcfg"], w["dets"], w["dets"], w["pairs"],
                               w["pair_dets"], False, passes=3.0)
    return 100.0 * least / p["window_s"]
