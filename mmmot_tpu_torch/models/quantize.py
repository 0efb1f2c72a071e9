"""Int8 post-training quantisation of the VGG appearance trunk: port of
``mmmot_tpu/models/quantize.py``, function by function.

- **weights**: eval-mode BatchNorm folded into each conv
  (``_folded_trunk``), then per-output-channel symmetric int8;
- **activations**: per-tensor abs-max scales calibrated on sample crops
  (``calibrate_appearance``); a post-ReLU map uses [0, 127], so the clip
  at 0 is the ReLU;
- **compute**: each conv is ``kernels/int8_conv.py`` (the CUDA kernel on
  the GPU), int32 accumulation with the requantisation epilogue; the 2x2
  max-pools run on int8, fused into the epilogue of the conv before
  them;
- the skip-pool tail (the 1x1 reduces, their BatchNorms and the
  projection) stays in float32 and reads the net's own weights, so a
  checkpoint needs no conversion.

``quantize_appearance`` returns a ``QuantizedAppearance``; attached to a
``TrackingNet`` as ``net.quant_int8`` (``with_int8_appearance``,
``quantize_for_inference``) it takes the image branch of
``TrackingNet.extract``, so ``TrackingModule``, the runner and the
serving steps need no new plumbing.  It is inference-only: its buffers
are not persistent, so checkpoints and state dicts hold the float
weights alone.

Rounding follows the reference's float32 arithmetic: quotients are
rounded once from float64 (``_f32_div``, independent of how a device's
kernel treats a scalar divisor), and ``lax.rsqrt`` in the fold is not
bit-exact against ``torch.rsqrt``, so the port's own weights may land
one int8 level away from the reference's on a few weights.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from mmmot_tpu_torch.device import f32_parity
from mmmot_tpu_torch.kernels.int8_conv import (int8_conv3x3_requant,
                                               max_pool_int8, pack_weights,
                                               unpack_weights)
from mmmot_tpu_torch.models.appearance import trunk_ops
from mmmot_tpu_torch.models.layers import BN_EPS, fma

# ``quantize_for_inference``'s calibration set, as the reference's: at most
# this many frames of each sequence, until this many crops.
CALIB_FRAMES = 8
CALIB_CROPS = 256

def _tensor(v) -> torch.Tensor:
    """A tensor of ``v`` (a tensor, or an array that may be read-only)."""
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.array(v))


def _f32(v, device=None) -> torch.Tensor:
    return _tensor(v).to(dtype=torch.float32, device=device)


def _f32_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` of float32 tensors, rounded once: the float64 quotient
    of two float32 values rounds to the correctly rounded float32 one."""
    return (a.double() / b.double()).float()


def _folded_trunk(appear_net) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``[(W, b), ...]`` in plan order: ``W`` the BN-folded float32 kernel
    [3, 3, Cin, Cout] (HWIO, the reference's layout) and ``b`` the folded
    bias [Cout], eval BatchNorm collapsed into the conv with the eps of
    ``MaskedBatchNorm``."""
    bb = appear_net.backbone
    convs = []
    with torch.no_grad():
        for op in bb.ops:
            if op[0] != "conv":
                continue
            conv, bn = getattr(bb, f"conv_{op[1]}"), getattr(bb, f"bn_{op[1]}")
            g = bn.weight.float() * torch.rsqrt(bn.running_var.float()
                                                + BN_EPS)
            b = fma(g, conv.bias.float() - bn.running_mean.float(),
                    bn.bias.float())
            w = conv.weight.float().permute(2, 3, 1, 0) * g
            convs.append((w, b))
    return convs


def calibrate_appearance(appear_net, crops) -> Tuple[float, ...]:
    """Per-tensor activation scales from sample crops (abs-max):
    ``(input_absmax, conv0_max, conv1_max, ...)`` as Python floats, from
    the folded float32 trunk with ReLU (TF32 off).  ``crops``: float
    [..., H, W, 3]; a few hundred detections are plenty."""
    convs = _folded_trunk(appear_net)
    y = crops.float().reshape((-1,) + tuple(crops.shape[-3:]))
    y = y.permute(0, 3, 1, 2)
    with torch.no_grad(), f32_parity():
        maxes = [y.abs().max()]
        for op in appear_net.backbone.ops:
            if op[0] == "pool":
                y = F.max_pool2d(y, 2)
            elif op[0] == "conv":
                w, b = convs[op[1]]
                y = torch.relu(F.conv2d(y, w.permute(3, 2, 0, 1), padding=1)
                               + b[:, None, None])
                maxes.append(y.max())
    return tuple(float(m) for m in torch.stack(maxes).cpu())


def _scale(act_max: float) -> float:
    return max(float(act_max), 1e-12) / 127.0


def _stage_scales(depth: int, act_scales: Sequence[float]
                  ) -> Tuple[float, ...]:
    """The activation scale live at each stage output (the scale of the
    stage's last conv)."""
    out, conv_i = [], 0
    for op in trunk_ops(depth):
        if op[0] == "conv":
            conv_i += 1
        elif op[0] == "stage":
            out.append(_scale(act_scales[conv_i]))
    return tuple(out)


class QuantizedAppearance(nn.Module):
    """The int8 trunk (``quant_int8`` of the reference) as buffers:
    per conv ``i``, ``w_q_{i}`` int8 [Cout, Kp] (``pack_weights``: the
    kernel's layout, packed once here), ``m_{i}`` and ``b_{i}`` float32
    [Cout]; ``in_scale`` and ``stage_scale_{j}``, 0-d float32.

    ``layers`` take the reference's per-layer dicts ``{"w": HWIO int8
    [3, 3, Cin, Cout], "m": [Cout], "b": [Cout]}`` (tensors or numpy
    arrays); ``to_flax`` gives that tree back."""

    def __init__(self, depth: int, in_scale, layers: Sequence[Dict],
                 stage_scales: Sequence):
        super().__init__()
        self.ops = trunk_ops(depth)
        n_convs = sum(op[0] == "conv" for op in self.ops)
        n_stages = sum(op[0] == "stage" for op in self.ops)
        if len(layers) != n_convs or len(stage_scales) != n_stages:
            raise ValueError(
                f"VGG{depth} has {n_convs} convs and {n_stages} stages; "
                f"got {len(layers)} layers and {len(stage_scales)} stage "
                "scales")
        self.cins = []
        self.register_buffer("in_scale", _f32(in_scale).reshape(()),
                             persistent=False)
        for i, layer in enumerate(layers):
            w = _tensor(layer["w"])
            if w.dtype != torch.int8 or w.dim() != 4 or w.shape[:2] != (3, 3):
                raise ValueError(f"layer {i}: w must be int8 [3, 3, Cin, "
                                 f"Cout], got {w.dtype} {tuple(w.shape)}")
            self.cins.append(int(w.shape[2]))
            for name, t in (("w_q", pack_weights(w)),
                            ("m", _f32(layer["m"])), ("b", _f32(layer["b"]))):
                self.register_buffer(f"{name}_{i}", t, persistent=False)
        for j, s in enumerate(stage_scales):
            self.register_buffer(f"stage_scale_{j}", _f32(s).reshape(()),
                                 persistent=False)
        self.n_stages = n_stages

    def layer(self, i: int):
        """(w_q [Cout, Kp] int8, m, b) of conv ``i``."""
        return (getattr(self, f"w_q_{i}"), getattr(self, f"m_{i}"),
                getattr(self, f"b_{i}"))

    def stage_scale(self, j: int) -> torch.Tensor:
        return getattr(self, f"stage_scale_{j}")

    def to_flax(self) -> Dict:
        """The reference's ``quant_int8`` tree as numpy arrays: a tuple of
        per-layer dicts and a tuple of stage scales."""
        def arr(t):
            return t.detach().cpu().numpy()

        layers = []
        for i, cin in enumerate(self.cins):
            wq, m, b = self.layer(i)
            layers.append({"w": np.ascontiguousarray(
                arr(unpack_weights(wq, cin))), "m": arr(m), "b": arr(b)})
        return {"in_scale": arr(self.in_scale), "layers": tuple(layers),
                "stage_scales": tuple(arr(self.stage_scale(j))
                                      for j in range(self.n_stages))}


def quantize_appearance(appear_net, act_scales: Sequence[float]
                        ) -> QuantizedAppearance:
    """The int8 trunk from the net's float weights and the calibration.

    Per conv ``i`` (input scale ``s_in``, output activation max ``a_i``,
    ``s_out = a_i / 127``):

        w_q[c] = clip(round(W_folded[..., c] / s_w[c]), -127, 127),
                 s_w[c] = max|W_folded[..., c]| / 127
        m[c]   = s_in * s_w[c] / s_out,   b[c] = b_folded[c] / s_out

    Raises ``ValueError`` unless there is one scale for the input and one
    per conv.  The buffers land on the net's device."""
    convs = _folded_trunk(appear_net)
    if len(act_scales) != len(convs) + 1:
        raise ValueError(f"need {len(convs) + 1} calibration scales "
                         f"(input + per conv), got {len(act_scales)}")
    dev = appear_net.proj.weight.device
    s_in = _scale(act_scales[0])
    layers, s_prev = [], s_in
    for i, (w, b) in enumerate(convs):
        s_w = _f32_div(w.abs().amax(dim=(0, 1, 2)).clamp_min(1e-12),
                       _f32(127.0, dev))
        w_q = torch.round(_f32_div(w, s_w)).clamp_(-127, 127).to(torch.int8)
        s_out = _f32(_scale(act_scales[i + 1]), dev)
        m = _f32_div((_f32(s_prev, dev).double() * s_w.double()).float(),
                     s_out)
        layers.append({"w": w_q, "m": m, "b": _f32_div(b, s_out)})
        s_prev = _scale(act_scales[i + 1])
    depth = appear_net.cfg.depth
    return QuantizedAppearance(depth, s_in, layers,
                               _stage_scales(depth, act_scales)).to(dev)


def with_int8_appearance(net, sample_crops):
    """Calibrate and quantise ``net``'s trunk on ``sample_crops`` and
    attach the result as ``net.quant_int8``, which switches
    ``TrackingNet.extract`` onto the int8 trunk; returns ``net``."""
    scales = calibrate_appearance(net.appear_net, sample_crops)
    net.quant_int8 = quantize_appearance(net.appear_net, scales)
    return net


def quantize_for_inference(net, data_cfg, sequences=None):
    """Quantise ``net``'s trunk for a dataset (``model.int8_appearance``).

    The calibration crops are the detections of real frames of
    ``data_cfg.root``: up to ``CALIB_FRAMES`` frames of each of
    ``sequences`` (default: the first sequence) until ``CALIB_CROPS``
    crops,
    cut and ImageNet-normalised on the net's device by the tracker's own
    preprocessing.  Raises ``ValueError`` when the tree holds no
    detections, or when the net has no camera branch (``use_image``
    off).  Returns ``net`` with ``quant_int8`` attached."""
    from mmmot_tpu_torch.data.kitti_dataset import KittiTrackingDataset

    if not net.cfg.use_image:
        raise ValueError("int8 appearance needs the camera branch: the "
                         "model has use_image off")
    from mmmot_tpu_torch.ops.crop_resize import (crop_and_resize_batched,
                                                 normalize_crops)

    dev = net.device
    crop = tuple(net.cfg.appearance.crop_size)
    ds = KittiTrackingDataset(data_cfg, max_cloud_points=4096)
    seqs = list(sequences) if sequences else ds.sequences[:1]
    found, total = [], 0
    with torch.inference_mode():
        for seq in seqs:
            arrs = ds.load_sequence(seq, max_frames=CALIB_FRAMES)
            dm = torch.as_tensor(arrs.det_mask, device=dev)
            c = crop_and_resize_batched(
                torch.as_tensor(arrs.images, device=dev).float(),
                torch.as_tensor(arrs.boxes, device=dev), crop, dm)
            valid = normalize_crops(c, scale=1.0 / 255.0)[dm]
            found.append(valid)
            total += len(valid)
            if total >= CALIB_CROPS:
                break
        calib = torch.cat(found)[:CALIB_CROPS]
    if len(calib) == 0:
        raise ValueError(
            f"no detections found in {data_cfg.root!r} to calibrate the "
            "int8 trunk on (model.int8_appearance needs real crops)")
    return with_int8_appearance(net, calib)


def quantize_input(quant: QuantizedAppearance, x) -> torch.Tensor:
    """Float crops [n, H, W, 3] -> int8: divided by ``in_scale``, rounded
    half to even, clipped to [-127, 127]."""
    return torch.round(_f32_div(x.float(), quant.in_scale)).clamp_(
        -127, 127).to(torch.int8).contiguous()


def quantized_trunk_stages(quant: QuantizedAppearance, x
                           ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Run the int8 trunk on float crops ``x`` [n, H, W, 3]: the input
    quantised (``quantize_input``), each conv ``int8_conv3x3_requant``,
    each pool on int8: fused into the conv before it (``pool=True``),
    else ``max_pool_int8``.
    Returns ``[(int8 NHWC stage map, its dequant scale)]`` per stage."""
    xq = quantize_input(quant, x)
    stages, ops = [], quant.ops
    for i, op in enumerate(ops):
        if op[0] == "conv":
            pool = i + 1 < len(ops) and ops[i + 1][0] == "pool"
            xq = int8_conv3x3_requant(xq, *quant.layer(op[1]), pool=pool)
        elif op[0] == "stage":
            stages.append((xq, quant.stage_scale(len(stages))))
        elif not (i and ops[i - 1][0] == "conv"):    # else fused above
            xq = max_pool_int8(xq)
    return stages


def quantized_appearance_apply(quant: QuantizedAppearance, appear_net,
                               crops, mask=None, dtype=torch.float32):
    """Eval-mode ``AppearanceNet.forward`` with the int8 trunk.

    The skip-pool tail (reduce_i Dense, its BatchNorm with
    ``MaskedBatchNorm``'s multiply-add, ReLU, concat, proj) runs in
    float32 (TF32 off) from ``appear_net``'s weights, then casts to
    ``dtype``; masked slots are exactly 0."""
    lead = crops.shape[:-3]
    x = crops.reshape((-1,) + tuple(crops.shape[-3:]))
    stages = quantized_trunk_stages(quant, x)
    pooled = []
    with f32_parity():
        for i, (s_q, s_scale) in enumerate(stages[-appear_net.n_picked:]):
            p = s_q.amax(dim=(1, 2)).float() * s_scale
            red = getattr(appear_net, f"reduce_{i}")
            p = p @ red.weight.float().t() + red.bias.float()
            bn = getattr(appear_net, f"reduce_bn_{i}")
            inv = torch.rsqrt(bn.running_var.float() + BN_EPS)
            p = fma((p - bn.running_mean.float()) * inv, bn.weight.float(),
                    bn.bias.float())
            pooled.append(torch.relu(p))
        proj = appear_net.proj
        feat = torch.cat(pooled, dim=-1) @ proj.weight.float().t()
        feat = (feat + proj.bias.float()).to(dtype)
    feat = feat.reshape(tuple(lead) + (feat.shape[-1],))
    if mask is not None:
        feat = feat * mask[..., None].to(feat.dtype)
    return feat
