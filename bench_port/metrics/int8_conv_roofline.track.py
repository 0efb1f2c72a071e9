"""The int8 conv kernel's share of its roofline in the profiled window:
the 13 layers' least time over the window's crops, one a valid
detection, whatever rows the program pads them to (each layer the
larger of its operations at the int8 peak and its bytes at the memory
peak; ``harness/work.py::int8_trunk_bound_s``) over the device time of
``int8_conv_main_kernel`` and ``int8_conv_stem_kernel``
(``csrc/int8_conv.cu``)."""

from bench_port.harness import work

SOURCE, UNIT, BETTER = "device_trace", "%", "higher"
LAYER, MOVES = "int8 conv kernel", "track_fps"
KERNELS = ("int8_conv_main_kernel", "int8_conv_stem_kernel")


def read(ctx):
    spent = sum(v for k, v in ctx["profile"]["kernels"].items()
                if any(n in k for n in KERNELS))
    if spent <= 0.0 or not ctx["int8"]:
        return None
    a = ctx["mcfg"]["appearance"]
    convs = work.vgg_convs(a["crop_size"][0], a.get("width_mult", 1.0))
    crops = ctx["work"]["dets"]
    return 100.0 * work.int8_trunk_bound_s(crops, convs) / spent
