"""Plain reference of the mmMOT training step: the train-mode forward
over a batch of adjacent frame pairs (BatchNorm on the moments of the
batch's valid rows), the tracking loss, its gradients by autograd, the
global-norm clip and AdamW with the configuration's schedule, all in
float32 with TF32 off.

The loss, per the configuration's ``train`` group (Zhang et al. 2019,
section 3.4, with the new/end and det terms of the measured
configuration): for each previous detection a cross-entropy over
{link to each current detection, end}, for each current detection one
over {linked from each previous detection, new}, logistic terms on the
new and end logits and on the det logits (target: a real object), each
averaged over the batch's valid detections.  Targets come from the
track ids: a pair links when both carry the same id.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from bench_port.reference.mmmot import (BRANCHES, Ref, crops_of,
                                        exact_matmuls, frustum_points,
                                        resize_dtype)


def labels(ids_prev, ids_curr):
    """(link [Np, Nc], new [Nc], end [Np]) float targets of one pair's
    valid detections from their track ids."""
    link = ((ids_prev[:, None] == ids_curr[None, :])
            & (ids_prev[:, None] >= 0)).float()
    return link, (link.sum(0) == 0).float(), (link.sum(1) == 0).float()


def _ce(logits, target):
    """Cross-entropy of each row's decision, summed over rows."""
    return -(target * F.log_softmax(logits, -1)).sum()


def _bce(logits, target):
    return F.binary_cross_entropy_with_logits(logits, target,
                                              reduction="sum")


def forward_loss(ref: Ref, batch: dict, crop, P) -> torch.Tensor:
    """The loss of one batch: images [B, 2, H, W, 3] uint8, clouds [B, 2,
    M, 4], boxes [B, 2, N, 4], det_mask [B, 2, N], ids [B, 2, N], proj
    [3, 4]."""
    B = batch["det_mask"].shape[0]
    crops, pts, pms, where = [], [], [], []
    rd = resize_dtype(ref.cfg)
    for b in range(B):
        for t in range(2):
            dm = batch["det_mask"][b, t]
            bx = batch["boxes"][b, t][dm]
            if len(bx):
                crops.append(crops_of(batch["images"][b, t], bx, crop, rd))
                p, m = frustum_points(batch["clouds"][b, t], bx,
                                      batch["proj"], P)
                pts.append(p)
                pms.append(m)
            where.append(len(bx))
    feats = ref.extract(torch.cat(crops), torch.cat(pts), torch.cat(pms))
    per, at = [], 0
    for n in where:
        per.append({k: v[at:at + n] for k, v in feats.items()})
        at += n
    # The link heads of every pair at once: BatchNorm over all valid pairs.
    pairs = [(per[2 * b], per[2 * b + 1]) for b in range(B)]
    link = batched_link(ref, pairs)
    total_prev = total_curr = 0.0
    ce_p = ce_c = bce_n = bce_e = bce_d = 0.0
    for b, (fp, fc) in enumerate(pairs):
        lk = link[b]
        new, end = ref.new_end(fp["fused"], fc["fused"], lk)
        ids = batch["ids"][b]
        dm = batch["det_mask"][b]
        g_link, g_new, g_end = labels(ids[0][dm[0]], ids[1][dm[1]])
        ce_p = ce_p + _ce(torch.cat([lk, end[:, None]], 1),
                          torch.cat([g_link, g_end[:, None]], 1))
        ce_c = ce_c + _ce(torch.cat([lk.T, new[:, None]], 1),
                          torch.cat([g_link.T, g_new[:, None]], 1))
        bce_n = bce_n + _bce(new, g_new)
        bce_e = bce_e + _bce(end, g_end)
        for f in (fp, fc):
            d = ref.det_logit(f["fused"])
            bce_d = bce_d + _bce(d, torch.ones_like(d))
        total_prev += len(end)
        total_curr += len(new)
    n_prev, n_curr = max(total_prev, 1), max(total_curr, 1)
    n_dets = max(total_prev + total_curr, 1)
    return (ce_p / n_prev + ce_c / n_curr + bce_n / n_curr + bce_e / n_prev
            + bce_d / n_dets)


def batched_link(ref: Ref, pairs) -> List[torch.Tensor]:
    """Raw links [Np, Nc] of several frame pairs, each head's BatchNorm
    on the moments of all their valid pairs together."""
    out = [0.0] * len(pairs)
    for br in BRANCHES:
        xs = [(fp[br][:, None, :] - fc[br][None, :, :]).abs()
              for fp, fc in pairs]
        flat = torch.cat([x.reshape(-1, x.shape[-1]) for x in xs])
        h = ref.dense(f"affinity_{br}.head_0", flat)
        h = torch.relu(ref.bn(f"affinity_{br}.head_bn_0", h))
        s = ref.dense(f"affinity_{br}.head_out", h)[:, 0]
        at = 0
        for k, x in enumerate(xs):
            n = x.shape[0] * x.shape[1]
            out[k] = out[k] + s[at:at + n].reshape(x.shape[:2])
            at += n
    return out


def schedule(tcfg: dict, count: int, steps_per_epoch: int) -> float:
    """The learning rate of update ``count``: linear warm-up from 0 over
    ``warmup_steps``, then the base rate with its step decays."""
    base, warm = tcfg["lr"], tcfg["warmup_steps"]
    if count < warm:
        return base * count / warm
    c = count - warm
    lr = base
    for e in sorted(set(tcfg["lr_decay_epochs"])):
        if c >= e * steps_per_epoch:
            lr *= tcfg["lr_decay_rate"]
    return lr


class RefTrainer:
    """The reference's training state: float32 leaves of every trained
    weight (the running statistics are not trained), AdamW moments."""

    def __init__(self, weights: Dict[str, torch.Tensor], mcfg: dict,
                 tcfg: dict, steps_per_epoch: int, lowp: bool = False,
                 ref_cls=Ref):
        self.p = {k: v.detach().clone().requires_grad_(
            not k.endswith(("running_mean", "running_var")))
            for k, v in weights.items()}
        self.mcfg, self.tcfg, self.spe = mcfg, tcfg, steps_per_epoch
        self.lowp, self.ref_cls = lowp, ref_cls
        self.leaves = [k for k, v in self.p.items() if v.requires_grad]
        self.mu = {k: torch.zeros_like(self.p[k]) for k in self.leaves}
        self.nu = {k: torch.zeros_like(self.p[k]) for k in self.leaves}
        self.count = 0

    def step(self, batch: dict, crop, P):
        """One update; returns (loss, the clipped gradients)."""
        ref = self.ref_cls(self.p, self.mcfg, lowp=self.lowp, train=True)
        with exact_matmuls():
            loss = forward_loss(ref, batch, crop, P)
            grads = torch.autograd.grad(loss, [self.p[k]
                                               for k in self.leaves],
                                        allow_unused=True)
        g = {k: (torch.zeros_like(self.p[k]) if x is None else x.detach())
             for k, x in zip(self.leaves, grads)}
        norm = torch.sqrt(sum((x * x).sum() for x in g.values()))
        clip = self.tcfg["grad_clip"]
        if clip > 0 and float(norm) >= clip:
            g = {k: x / norm * clip for k, x in g.items()}
        b1, b2, eps = 0.9, 0.999, 1e-8
        lr = schedule(self.tcfg, self.count, self.spe)
        n = self.count + 1
        with torch.no_grad():
            for k in self.leaves:
                self.mu[k].mul_(b1).add_(g[k], alpha=1 - b1)
                self.nu[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                upd = (self.mu[k] / (1 - b1 ** n)) / (
                    torch.sqrt(self.nu[k] / (1 - b2 ** n)) + eps)
                upd = upd + self.tcfg["weight_decay"] * self.p[k]
                self.p[k].sub_(lr * upd)
        self.count = n
        return float(loss), g


def batch_of(scene: dict, seqs, t: int) -> dict:
    """The training batch of frame pair (t, t + 1) of sequences ``seqs``
    of a scene, as the reference reads it."""
    idx = torch.as_tensor(seqs, device=scene["det_mask"].device)
    out = {k: scene[k][idx, t:t + 2] for k in ("images", "clouds", "boxes",
                                               "det_mask", "ids")}
    out["proj"] = scene["proj"]
    return out
