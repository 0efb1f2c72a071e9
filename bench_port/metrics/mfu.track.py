"""The profiled tracking window's share of the chip's peak: the least
time the window's model work takes at the published peaks (counted from
its valid detections and pairs by ``harness/work.py::model_seconds``:
the trunk and skip-pool head per valid crop, PointNet, fusion and det
head per valid detection, the link and new/end heads per valid pair;
the trunk at the int8 rate where the configuration states an int8
trunk) over the window's time."""

from bench_port.harness import work

SOURCE, UNIT, BETTER = "device_trace", "%", "higher"
LAYER, MOVES = "device", "track_fps"


def read(ctx):
    p = ctx["profile"]
    if p["busy_s"] <= 0.0:
        return None
    w = ctx["work"]
    least = work.model_seconds(ctx["mcfg"], w["dets"], w["dets"], w["pairs"],
                               w["pair_dets"], ctx["int8"])
    return 100.0 * least / p["window_s"]
