"""Plain reference of the int8 appearance trunk (``full_mmmot_int8``):
post-training quantisation of the VGG16-bn trunk as the configuration
states it, computed here from the float weights and the calibration
crops the benchmark hands both sides.

- eval BatchNorm folded into each conv;
- weights symmetric per output channel, ``round(W / s_w)`` clipped to
  the signed range, ``s_w = max|W| / qmax``;
- activations per tensor, scales ``max / qmax`` from the abs-max of the
  crops and of each ReLU output of the folded float trunk on the
  calibration crops (the 2x2 pools in between);
- each conv accumulates integers, then ``round(acc * m + b)`` (half to
  even) clipped to ``[0, qmax]`` (the clip at 0 is the ReLU), ``m = s_in
  s_w / s_out``, ``b = b_folded / s_out``; the pools take the max of the
  integers;
- the skip-pool head reads each stage map times its scale, in float32.

``qmax`` is 127 (int8); with ``lowp`` it is 7 (int4, the control of an
int8 configuration), and the bfloat16 layers round to float8 as in
``mmmot.Ref``.  The integer convolutions run as float32 convolutions of
integer values without TF32: exact while a sum stays under 2**24, and
within a unit or two of the accumulator past it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_port.reference.mmmot import BN_EPS, Ref, exact_matmuls, vgg_plan


class RefInt8(Ref):
    """``Ref`` with the int8 trunk; ``calibrate`` before use."""

    def __init__(self, p, mcfg, lowp: bool = False, train: bool = False):
        super().__init__(p, mcfg, lowp=lowp, train=train)
        self.qmax = 7.0 if lowp else 127.0
        self.layers = None

    def folded(self):
        """[(W [out, in, 3, 3], b [out])] with eval BatchNorm folded in."""
        out, i = [], 0
        for item in vgg_plan(self.cfg):
            if item == "M":
                continue
            pre = f"appear_net.backbone.conv_{i}"
            bn = f"appear_net.backbone.bn_{i}"
            g = self.p[bn + ".weight"] / torch.sqrt(
                self.p[bn + ".running_var"] + BN_EPS)
            b = (self.p[pre + ".bias"] - self.p[bn + ".running_mean"]) * g \
                + self.p[bn + ".bias"]
            out.append((self.p[pre + ".weight"] * g[:, None, None, None], b))
            i += 1
        return out

    @torch.no_grad()
    def calibrate(self, crops) -> None:
        """Scales and integer weights from the calibration crops [n, h,
        w, 3] (normalised)."""
        convs = self.folded()
        with exact_matmuls():
            y = crops.permute(0, 3, 1, 2)
            maxes, i = [float(y.abs().max())], 0
            for item in vgg_plan(self.cfg):
                if item == "M":
                    y = F.max_pool2d(y, 2)
                    continue
                w, b = convs[i]
                y = torch.relu(F.conv2d(y, w, b, padding=1))
                maxes.append(float(y.max()))
                i += 1
        q = self.qmax
        scales = [max(m, 1e-12) / q for m in maxes]
        self.s_in = scales[0]
        self.layers, s_prev = [], scales[0]
        for k, (w, b) in enumerate(convs):
            s_w = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / q
            w_q = torch.round(w / s_w[:, None, None, None]).clamp(-q, q)
            s_out = scales[k + 1]
            self.layers.append((w_q, s_prev * s_w / s_out, b / s_out, s_out))
            s_prev = s_out

    def appearance(self, crops):
        q = self.qmax
        x = torch.round(crops.permute(0, 3, 1, 2) / self.s_in).clamp(-q, q)
        stages, i, scale = [], 0, self.s_in
        for item in vgg_plan(self.cfg):
            if item == "M":
                x = F.max_pool2d(x, 2)
                stages.append(x * scale)
                continue
            w_q, m, b, scale = self.layers[i]
            acc = F.conv2d(x, w_q, padding=1)
            x = torch.round(acc * m[:, None, None] + b[:, None, None]
                            ).clamp(0.0, q)
            i += 1
        return self.skip_head(stages[-3:])
