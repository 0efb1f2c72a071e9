"""The fused affinity kernel's share of its roofline in the profiled
window: the least time of the window's call (its valid pairs' and
detections' operations at the bf16 peak, or its bytes at the memory
peak; ``harness/work.py::affinity_bound_s``) over the device time of the
kernel's launches (``norms_kernel``, ``products_kernel``,
``finish_kernel`` of ``csrc/affinity.cu``)."""

from bench_port.harness import work

SOURCE, UNIT, BETTER = "device_trace", "%", "higher"
LAYER, MOVES = "affinity kernel", "track_fps"
KERNELS = ("norms_kernel", "products_kernel", "finish_kernel")


def read(ctx):
    spent = sum(v for k, v in ctx["profile"]["kernels"].items()
                if any(n in k for n in KERNELS))
    if spent <= 0.0:
        return None
    w = ctx["work"]
    bound = work.affinity_bound_s(ctx["mcfg"], w["pairs"], w["pair_dets"],
                                  w["frame_pairs"], ctx["slots"])
    return 100.0 * bound / spent
