"""The tracking loss: port of ``mmmot_tpu/train/losses.py``.

Cross-entropy over each previous detection's decision {link to each
current detection, end} and each current detection's {linked from each
previous detection, new}, binary terms on the new/end logits, link
suppression on pairs that involve a false positive and a
detection-confidence term.  Every term is masked to valid slots and
normalised by the true detection counts.  False positives (``gt_ids`` <
0) carry no association supervision of their own: their target is
rejection, which the det-confidence term teaches.

Under data parallelism (a process ``group``) every normaliser is the
count over all ranks' rows, so each rank's loss is its share of the
whole batch's loss: the shares and their gradients sum to the
single-process values.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from mmmot_tpu_torch.ops.masking import masked_log_softmax, pair_mask


def _count(m, group):
    """The number of set entries of mask ``m`` (float32 0-dim), over
    every rank of ``group`` when one is given."""
    n = m.float().sum()
    if group is not None:
        dist.all_reduce(n, op=dist.ReduceOp.SUM, group=group)
    return n.clamp_min(1.0)


def _decision_ce(logits, cand_mask, target, sup, group=None):
    """Masked cross-entropy of each supervised row's decision."""
    logp = masked_log_softmax(logits, cand_mask, dim=-1)
    ce = -(target * torch.where(cand_mask, logp, torch.zeros_like(logp))
           ).sum(-1)
    sup_f = sup.to(ce.dtype)
    return (ce * sup_f).sum() / _count(sup, group).to(ce.dtype)


def _prev_ce(link, end, gt_link, gt_end, sup_prev, mask_curr, group=None):
    """CE over each prev det's decision: [link to j..., end]; the
    candidate columns are every valid curr det (links toward false
    positives are suppressed through the denominators)."""
    logits = torch.cat([link, end[..., :, None]], dim=-1)
    cand = torch.cat([pair_mask(sup_prev, mask_curr), sup_prev[..., :, None]],
                     dim=-1)
    target = torch.cat([gt_link, gt_end[..., :, None]], dim=-1)
    return _decision_ce(logits, cand, target, sup_prev, group)


def _curr_ce(link, new, gt_link, gt_new, sup_curr, mask_prev, group=None):
    """CE over each curr det's decision: [linked from i..., new]."""
    logits = torch.cat([link.transpose(-1, -2), new[..., :, None]], dim=-1)
    cand = torch.cat([pair_mask(sup_curr, mask_prev), sup_curr[..., :, None]],
                     dim=-1)
    target = torch.cat([gt_link.transpose(-1, -2), gt_new[..., :, None]],
                       dim=-1)
    return _decision_ce(logits, cand, target, sup_curr, group)


def _masked_bce(logits, targets, mask, group=None):
    """Mean over ``mask`` of the logistic loss, written as
    ``max(x, 0) - x t + log1p(exp(-|x|))``."""
    loss = (torch.maximum(logits, torch.zeros_like(logits))
            - logits * targets + torch.log1p(torch.exp(-logits.abs())))
    m = mask.to(loss.dtype)
    return (loss * m).sum() / _count(mask, group).to(loss.dtype)


def tracking_loss(outputs: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor],
                  weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0),
                  group=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, metrics) of the net's training forward.

    outputs: link [B, T-1, N, N], new/end [B, T-1, N], det [B, T, N]
    (and kept_mask [B, T, N] under compact-first extraction, which then
    replaces det_mask); batch: gt_link/gt_new/gt_end (pair shapes),
    det_mask [B, T, N] and optionally gt_ids [B, T, N] (-1: false
    positive).  ``weights``: link, new, end, det.  Metrics: ce_prev,
    ce_curr, bce_new, bce_end, bce_fp_link, n_dets (the kept count), with
    gt_ids bce_det, and total.  With a process ``group`` the terms are
    this rank's shares of the whole batch's (normalised by the counts
    over every rank), and n_dets this rank's count."""
    w_link, w_new, w_end, w_det = weights
    det_mask = outputs.get("kept_mask", batch["det_mask"])
    has_ids = "gt_ids" in batch
    sup_mask = det_mask & (batch["gt_ids"] >= 0) if has_ids else det_mask
    sup_prev, sup_curr = sup_mask[:, :-1], sup_mask[:, 1:]
    mask_prev, mask_curr = det_mask[:, :-1], det_mask[:, 1:]
    gt_link = batch["gt_link"].float()
    gt_new, gt_end = batch["gt_new"].float(), batch["gt_end"].float()

    # The outputs stay in the compute dtype: the log-softmax and the
    # logistic terms run in it, and the products with the float32
    # targets promote to float32, as in the reference.
    link, new, end = outputs["link"], outputs["new"], outputs["end"]
    ce_prev = _prev_ce(link, end, gt_link, gt_end, sup_prev, mask_curr,
                       group)
    ce_curr = _curr_ce(link, new, gt_link, gt_new, sup_curr, mask_prev,
                       group)
    bce_new = _masked_bce(new, gt_new, sup_curr, group)
    bce_end = _masked_bce(end, gt_end, sup_prev, group)
    # Pairs that involve a false positive: explicit link suppression, or
    # the link head could chain clutter across frames unsupervised.
    bce_fp_link = torch.zeros((), device=link.device)
    if has_ids:
        fp_pair = pair_mask(mask_prev, mask_curr) & ~pair_mask(sup_prev,
                                                               sup_curr)
        bce_fp_link = _masked_bce(link, torch.zeros_like(link), fp_pair,
                                  group)

    metrics = {"ce_prev": ce_prev, "ce_curr": ce_curr, "bce_new": bce_new,
               "bce_end": bce_end, "bce_fp_link": bce_fp_link,
               "n_dets": det_mask.float().sum()}
    total = (w_link * (ce_prev + ce_curr + bce_fp_link) + w_new * bce_new
             + w_end * bce_end)
    if "det" in outputs and has_ids:
        det_target = (batch["gt_ids"] >= 0).float()
        bce_det = _masked_bce(outputs["det"], det_target, det_mask, group)
        metrics["bce_det"] = bce_det
        total = total + w_det * bce_det
    metrics["total"] = total
    return total, metrics
