"""The schedule, the optimizer and the train step: port of
``mmmot_tpu/train/trainer.py``.

The ``nn.Module`` holds the parameters and the BatchNorm running
statistics; ``OptaxChain`` is a ``torch.optim.Optimizer`` whose numbers
are those of the reference's optax chain:

- ``clip_by_global_norm(grad_clip)``: ``g * max / |g|`` when ``|g| >=
  max`` (no epsilon), ``|g|`` over every gradient;
- adam: ``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8 outside the square
  root, bias-corrected moments) with the weight decay added to the
  update of **every** parameter, BatchNorm scales and biases included:
  ``p -= lr * (adam + wd * p)``;
- sgd: ``add_decayed_weights(wd)`` after the clip, then the momentum
  trace ``t = g + m * t``, ``p -= lr * t``.

Update k (k earlier updates) uses ``schedule(k)``.  A parameter that got
no gradient counts as a zero gradient, as every optax leaf does.

Data parallelism (``train_step(..., group=)``, the counterpart of the
reference's step on a batch sharded over its mesh): each rank runs the
forward on its rows with the BatchNorm moments shared over the group
(``models/layers.py::norm_group``) and the loss normalised by the
group's counts, then the gradients are summed over the group before the
clip and the global norm, so every rank takes the same update.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

from mmmot_tpu_torch.config import TrainConfig
from mmmot_tpu_torch.device import f32_parity
from mmmot_tpu_torch.models.layers import norm_group, set_dropblock_generator
from mmmot_tpu_torch.train.losses import tracking_loss


def build_schedule(cfg: TrainConfig, steps_per_epoch: int
                   ) -> Callable[[int], float]:
    """Learning rate of update ``count``: step decay, cosine or constant,
    behind a linear warmup from 0 over ``warmup_steps``.

    As ``optax.join_schedules`` does, the schedule after the warmup is
    handed ``count - warmup_steps``, so the decay boundaries move by the
    warmup; ``piecewise_constant_schedule`` applies a decay from its
    boundary on (``count >= boundary``)."""
    base = cfg.lr
    total = max(cfg.epochs * steps_per_epoch, 1)
    if cfg.lr_schedule == "step":
        # A dict, as the reference's: epochs that collide keep one rate.
        bounds = sorted({e * steps_per_epoch: cfg.lr_decay_rate
                         for e in cfg.lr_decay_epochs}.items())

        def sched(count):
            v = base
            for b, rate in bounds:
                if count >= b:
                    v = v * rate
            return v
    elif cfg.lr_schedule == "cosine":
        def sched(count):
            c = min(count, total)
            return base * 0.5 * (1.0 + math.cos(math.pi * c / total))
    elif cfg.lr_schedule == "constant":
        def sched(count):
            return base
    else:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    warm = cfg.warmup_steps
    if warm <= 0:
        return sched

    def joined(count):
        if count < warm:
            return base * min(max(count, 0), warm) / warm
        return sched(count - warm)
    return joined


class OptaxChain(torch.optim.Optimizer):
    """The reference's optax chain (module docstring) as a PyTorch
    optimizer.  ``step()`` takes no closure; ``update_count`` (in the
    param group, so the state dict carries it) counts earlier updates."""

    def __init__(self, params, cfg: TrainConfig, steps_per_epoch: int):
        if cfg.optimizer not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        super().__init__(params, {"update_count": 0})
        self.cfg = cfg
        self.schedule = build_schedule(cfg, steps_per_epoch)

    def params_and_grads(self):
        params = [p for g in self.param_groups for p in g["params"]]
        grads = [p.grad.detach() if p.grad is not None
                 else torch.zeros_like(p) for p in params]
        return params, grads

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxChain.step takes no closure")
        cfg = self.cfg
        params, grads = self.params_and_grads()
        if cfg.grad_clip > 0:
            norm = global_norm(grads)
            keep = norm < cfg.grad_clip
            grads = [torch.where(keep, g, g / norm * cfg.grad_clip)
                     for g in grads]
        group = self.param_groups[0]
        count = group["update_count"]
        lr = self.schedule(count)
        if cfg.optimizer == "adam":
            self._adamw(params, grads, count + 1, lr)
        else:
            self._sgd(params, grads, lr)
        for g in self.param_groups:
            g["update_count"] = count + 1

    def _state_list(self, params, key):
        for p in params:
            if key not in self.state[p]:
                self.state[p][key] = torch.zeros_like(p)
        return [self.state[p][key] for p in params]

    def _adamw(self, params, grads, count_inc, lr):
        b1, b2, eps = 0.9, 0.999, 1e-8
        mu = self._state_list(params, "mu")
        nu = self._state_list(params, "nu")
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        mu_hat = torch._foreach_div(mu, 1.0 - b1 ** count_inc)
        den = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - b2 ** count_inc))
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(mu_hat, den)
        torch._foreach_add_(upd, params, alpha=self.cfg.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)

    def _sgd(self, params, grads, lr):
        upd = torch._foreach_add(grads, params, alpha=self.cfg.weight_decay)
        trace = self._state_list(params, "trace")
        torch._foreach_mul_(trace, self.cfg.momentum)
        torch._foreach_add_(trace, upd)
        torch._foreach_add_(params, trace, alpha=-lr)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


@dataclass
class TrainState:
    """The net (parameters and running statistics), its optimizer, the
    number of steps taken and the generator that the net's DropBlock
    layers draw their seeds from."""

    net: torch.nn.Module
    optimizer: OptaxChain
    step: int = 0
    dropblock_gen: torch.Generator = None


def create_train_state(net, cfg: TrainConfig,
                       steps_per_epoch: int = 1000) -> TrainState:
    """A train state over ``net``'s weights as they are (seeded, loaded
    or mapped from the reference); optimizer state starts at zero.  The
    net's ``DropBlock2D`` layers (``appearance.dropblock``) draw from a
    generator on the net's device seeded from ``cfg.seed`` (+ 1: the
    augmentation's generator takes the seed itself)."""
    gen = torch.Generator(device=next(net.parameters()).device)
    gen.manual_seed(cfg.seed + 1)
    set_dropblock_generator(net, gen)
    return TrainState(net, OptaxChain(net.parameters(), cfg,
                                      steps_per_epoch), dropblock_gen=gen)


def loss_and_grads(net, batch: Dict[str, torch.Tensor],
                   loss_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0),
                   compact_capacity: int = 0, group=None):
    """The train-mode forward, the loss and its gradients (left in each
    parameter's ``.grad``, earlier ones cleared); the running statistics
    move once.  Returns (loss, metrics).  With a process ``group`` the
    BatchNorm moments and the loss normalisers span its ranks, and the
    loss, metrics and gradients are this rank's shares (``train_step``
    sums them)."""
    net.train()
    for p in net.parameters():
        p.grad = None
    with norm_group(net, group):
        outputs = net(batch, compact_capacity=compact_capacity)
        loss, metrics = tracking_loss(outputs, batch, loss_weights, group)
        loss.backward()
    return loss, metrics


def sum_over_group(tensors, group) -> None:
    """Each tensor summed over the ranks of ``group``, in place, by one
    all-reduce of their float32 concatenation."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               loss_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0),
               compact_capacity: int = 0, group=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimization step on ``batch`` (tensors on the net's device).
    Returns (state, metrics): the loss terms, ``total`` and
    ``grad_norm``, the norm of the raw gradients, before the clip, as
    0-dim tensors (nothing here waits for the device).  float32 models
    run with TF32 off.

    With a process ``group`` ``batch`` is this rank's share of the
    batch and the step is data-parallel: moments, normalisers, metrics
    and gradients span the group, so the metrics and the update are
    those of one process on the whole batch (within float32 rounding:
    sums are taken in another order).  ``compact_capacity`` then bounds
    each rank's rows; the step equals the whole batch's where no rank
    drops a detection."""
    net = state.net
    with f32_parity(net.compute_dtype == torch.float32):
        _, metrics = loss_and_grads(net, batch, loss_weights,
                                    compact_capacity, group)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if group is not None:
            params, grads = state.optimizer.params_and_grads()
            for p, g in zip(params, grads):
                p.grad = g          # a missing gradient sums as zeros
            sum_over_group(grads + list(metrics.values()), group)
        metrics["grad_norm"] = global_norm(
            state.optimizer.params_and_grads()[1])
        state.optimizer.step()
    state.step += 1
    return state, metrics


@torch.no_grad()
def eval_forward(net, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """The forward with the running statistics (eval mode)."""
    net.eval()
    with f32_parity(net.compute_dtype == torch.float32):
        return net(batch)
