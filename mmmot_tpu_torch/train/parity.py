"""One ``tiny_debug`` float32 training step on the CPU and on another
device, compared: how the GPU's training step is held to the CPU's.

The step is sgd at lr 1e-2 with the clip active, compact-first at
capacity 12, on a seeded synthetic batch; both devices start from the
same seeded weights, and TF32 is off on the GPU (``train_step`` turns
it off for a float32 model).  Tolerances: the loss and each metric
within ``LOSS_RTOL`` relative (plus ``LOSS_ATOL``); every gradient and
every post-step tensor within ``TRAIN_TOL`` of its largest magnitude
(thousands of float32 products summed in other orders).  The biases of the layers that feed a train-mode BatchNorm
(``BN_FED_BIAS``) have a zero gradient in exact arithmetic, since the
normalisation removes them: theirs is rounding noise on both devices,
held to the scale of the same layer's weight gradient.  The step is sgd
because adam would turn that noise into updates of about the learning
rate.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict

import numpy as np
import torch

from mmmot_tpu_torch.config import tiny_debug
from mmmot_tpu_torch.data.synthetic import make_training_batch
from mmmot_tpu_torch.models.tracking_net import TrackingNet, init_random_
from mmmot_tpu_torch.train.trainer import create_train_state, train_step

TRAIN_TOL = 1e-3
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
BN_FED_BIAS = re.compile(r"(conv_\d+|reduce_\d+|mlp_\d+|head_0)\.bias$")


def tiny_step(device):
    """(metrics, gradients, state dict) of the step on ``device``, on the
    CPU."""
    cfg = tiny_debug()
    tcfg = dataclasses.replace(cfg.train, optimizer="sgd", lr=1e-2,
                               warmup_steps=0, grad_clip=1.0)
    b = make_training_batch(np.random.default_rng(0), batch_size=2,
                            num_slots=8, crop_size=(32, 32),
                            points_per_det=16, drop_prob=0.1, fp_prob=0.2)
    net = init_random_(TrackingNet(cfg.model, device=device), 0)
    state = create_train_state(net, tcfg, 10)
    _, m = train_step(state, {k: torch.as_tensor(v, device=net.device)
                              for k, v in b.items()}, compact_capacity=12)
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.detach().cpu() for n, p in net.named_parameters()},
            {k: v.detach().cpu() for k, v in net.state_dict().items()})


def step_agreement(device) -> Dict[str, object]:
    """The step on the CPU and on ``device``, held to the tolerances
    above; raises AssertionError naming the first tensor outside them.
    Returns the losses, ``grad_norm`` and the worst error of the
    gradients and of the post-step tensors, each a share of its scale."""
    (mc, gc, sc), (mg, gg, sg) = tiny_step("cpu"), tiny_step(device)
    if mc["grad_norm"] <= 1.0:
        raise AssertionError("train agreement: the clip is not active")
    for k in mc:
        if abs(mg[k] - mc[k]) > LOSS_RTOL * abs(mc[k]) + LOSS_ATOL:
            raise AssertionError(f"train agreement: {k} {mg[k]} vs {mc[k]}")
    worst = {"grad": 0.0, "state": 0.0}

    def hold(what, name, err, scale):
        rel = err / max(scale, 1e-30)
        if rel > TRAIN_TOL:
            raise AssertionError(f"train agreement: {what} {name}: {err} "
                                 f"> {TRAIN_TOL} x {scale}")
        worst[what] = max(worst[what], rel)

    for n, g in gc.items():
        if BN_FED_BIAS.search(n):
            hold("grad", n, max(g.abs().max().item(),
                                gg[n].abs().max().item()),
                 gc[n[:-len("bias")] + "weight"].abs().max().item())
        else:
            hold("grad", n, (gg[n] - g).abs().max().item(),
                 g.abs().max().item())
    for k, v in sc.items():
        hold("state", k, (sg[k] - v).abs().max().item(),
             v.abs().max().item())
    return {"loss": mg["total"], "loss_cpu": mc["total"],
            "grad_norm": mg["grad_norm"], "max_rel_err": worst}
