"""The yardstick's arithmetic: the operations and bytes the benchmark's
inputs need, counted from the valid detections and pairs the same way
whatever implements them, and the H100's published peaks (NVIDIA's
data sheet, SXM part, dense, at a 700 W limit).

A multiply-add counts as two operations.  Padding slots and compaction
rows count for nothing in the model's work (``mfu``); a kernel's
roofline counts what the kernel is handed, each input byte read once
and each output byte written once.
"""

from __future__ import annotations

PEAK_BF16 = 989e12          # FLOP/s, bf16 and fp16 tensor cores
PEAK_INT8 = 1979e12         # OP/s, int8 tensor cores
PEAK_BYTES = 3.35e12        # bytes/s, HBM3

VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M")


def vgg_convs(size: int = 224, mult: float = 1.0):
    """(H, W, cin, cout, pooled) of each 3x3 conv of the VGG16 trunk on
    size x size crops, widths times ``mult`` (at least 8); ``pooled``: a
    2x2 max-pool follows it."""
    out, cin, h = [], 3, size
    for k, item in enumerate(VGG16):
        if item == "M":
            h //= 2
            continue
        pooled = k + 1 < len(VGG16) and VGG16[k + 1] == "M"
        co = max(8, int(item * mult))
        out.append((h, h, cin, co, pooled))
        cin = co
    return out


def _trunk(mcfg: dict):
    a = mcfg["appearance"]
    return vgg_convs(a["crop_size"][0], a.get("width_mult", 1.0))


def trunk_flops(convs) -> float:
    """The convolutions ``convs`` (``vgg_convs``) of one crop."""
    return sum(2.0 * h * w * 9 * ci * co for h, w, ci, co, _ in convs)


def head_flops(mcfg: dict) -> float:
    """The skip-pool head of one crop: a reduce of each of the last three
    stages and the projection."""
    a = mcfg["appearance"]
    red = a["reduction_dim"]
    stage_ch = [co for _, _, _, co, pooled in _trunk(mcfg) if pooled][-3:]
    return 2.0 * (sum(c * red for c in stage_ch) + 3 * red * a["out_dim"])


def detection_flops(mcfg: dict) -> float:
    """One detection past its crop's trunk: PointNet over ``point_len``
    points, the fusion (gate and both projections) and the det head."""
    pt = mcfg["point"]
    chans, cin, per_point = pt["channels"], 4, 0
    for c in chans:
        per_point += cin * c
        cin = c
    d, hh = mcfg["fusion"]["out_dim"], mcfg["new_end"]["hidden_dim"]
    a = mcfg["appearance"]["out_dim"]
    return 2.0 * (pt["point_len"] * per_point + cin * pt["out_dim"]
                  + (a + pt["out_dim"]) * 2 + a * d + pt["out_dim"] * d
                  + d * hh + hh)


def pair_flops(mcfg: dict, n_pairs: float, n_dets: float,
               branches: int = 3) -> float:
    """The link heads over ``n_pairs`` valid detection pairs (each branch:
    the hidden layer and the output) and the new/end heads over the
    ``n_dets`` detections on either side of them."""
    d, h = mcfg["fusion"]["out_dim"], mcfg["affinity"]["hidden_dim"]
    hh = mcfg["new_end"]["hidden_dim"]
    return (2.0 * branches * n_pairs * (d * h + h)
            + 2.0 * n_dets * ((d + 1) * hh + hh))


def model_seconds(mcfg: dict, crops: float, dets: float, pairs: float,
                  pair_dets: float, int8_trunk: bool = False,
                  passes: float = 1.0) -> float:
    """The least time the model's work takes at the published peaks: the
    trunk at the int8 rate where the configuration states an int8
    trunk, everything else at the bf16 rate; ``passes`` 3 for a training
    step (forward and a backward of twice its work)."""
    trunk = crops * trunk_flops(_trunk(mcfg))
    rest = (crops * head_flops(mcfg) + dets * detection_flops(mcfg)
            + pair_flops(mcfg, pairs, pair_dets))
    return passes * (trunk / (PEAK_INT8 if int8_trunk else PEAK_BF16)
                     + rest / PEAK_BF16)


def affinity_bound_s(mcfg: dict, n_pairs: float, n_dets: float,
                     frame_pairs: int, slots: int,
                     branches: int = 3, item: int = 2) -> float:
    """The fused affinity kernel's least time for one call over
    ``frame_pairs`` frame pairs of ``slots`` slots: the valid pairs' and
    detections' operations at the bf16 peak, or its bytes (both sides'
    embeddings, the masks, the weights, the link, its normalisation and
    the new/end outputs) at the memory peak, whichever is longer."""
    d, h = mcfg["fusion"]["out_dim"], mcfg["affinity"]["hidden_dim"]
    hh = mcfg["new_end"]["hidden_dim"]
    flops = pair_flops(mcfg, n_pairs, n_dets, branches)
    weights = 4 * (branches * (d * h + 2 * h + 2 * h + 1)
                   + 2 * ((d + 1) * hh + 2 * hh + 1))
    nbytes = (2 * frame_pairs * branches * slots * d * item
              + 2 * frame_pairs * slots + weights
              + 2 * (frame_pairs * slots * slots + frame_pairs * slots)
              * item)
    return max(flops / PEAK_BF16, nbytes / PEAK_BYTES)


def int8_trunk_bound_s(rows: int, convs) -> float:
    """The int8 trunk's 13 convolutions over ``rows`` crops, each layer at
    the larger of its operations at the int8 peak and its bytes (input
    and weights read once, the (pooled) int8 output and the per-channel
    requant vectors written and read once) at the memory peak, summed;
    ``convs`` as ``vgg_convs`` gives them."""
    total = 0.0
    for h, w, ci, co, pooled in convs:
        pixels = rows * h * w
        ops = 2.0 * pixels * 9 * ci * co
        out = pixels // 4 if pooled else pixels
        nbytes = pixels * ci + co * 9 * ci + 8 * co + out * co
        total += max(ops / PEAK_INT8, nbytes / PEAK_BYTES)
    return total
