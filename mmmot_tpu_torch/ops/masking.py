"""Masked primitives over padded detection slots.

Port of ``mmmot_tpu/ops/masking.py``: masks are boolean (True = valid),
reductions over fully-masked axes give a neutral value, and ``NEG_INF`` is
a large finite negative so masked softmax stays NaN-free in bfloat16.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def _neg(x: torch.Tensor) -> torch.Tensor:
    return torch.full((), NEG_INF, dtype=x.dtype, device=x.device)


def masked_max(x, mask, dim, fill: float = 0.0):
    """Max over ``dim`` of the ``mask``-valid entries; ``fill`` where none."""
    m = torch.where(mask, x, _neg(x)).amax(dim=dim)
    return torch.where(mask.any(dim=dim), m, torch.full_like(m, fill))


def masked_mean(x, mask, dim):
    mask_f = mask.to(x.dtype)
    num = (x * mask_f).sum(dim=dim)
    return num / mask_f.sum(dim=dim).clamp_min(1.0)


def masked_softmax(x, mask, dim: int = -1):
    """Softmax over ``dim`` with zero probability at invalid entries;
    fully-masked rows are all zero.  The max shift carries no gradient
    (the reference's ``stop_gradient``)."""
    logits = torch.where(mask, x, _neg(x))
    logits = logits - logits.amax(dim=dim, keepdim=True).detach()
    unnorm = torch.exp(logits) * mask.to(x.dtype)
    den = unnorm.sum(dim=dim, keepdim=True)
    return unnorm / den.clamp_min(1e-30)


def masked_log_softmax(x, mask, dim: int = -1):
    """Log-softmax over ``dim`` of the valid entries; ``NEG_INF`` (finite)
    at invalid ones, so a ``where(mask, logp, 0)`` downstream has finite
    gradients.  The max shift carries no gradient."""
    neg = _neg(x)
    logits = torch.where(mask, x, neg)
    shifted = logits - logits.amax(dim=dim, keepdim=True).detach()
    unnorm = torch.where(mask, torch.exp(shifted), torch.zeros_like(shifted))
    lse = torch.log(unnorm.sum(dim=dim, keepdim=True).clamp_min(1e-30))
    return torch.where(mask, shifted - lse, neg)


def pair_mask(mask_a, mask_b):
    """[..., Na] x [..., Nb] -> [..., Na, Nb] pair validity."""
    return mask_a[..., :, None] & mask_b[..., None, :]


def compact_indices(flat_mask: torch.Tensor, capacity: int):
    """Valid-first stable ordering of a flat boolean mask [..., total]
    (each row of a batch on its own).

    Returns (idx [..., capacity] int64: valid slots first, in original
    order; taken [..., capacity] bool).  Scores are unique, so ``topk``
    gives the same order as the reference's ``lax.top_k``.
    """
    total = flat_mask.shape[-1]
    capacity = min(capacity, total)
    iota = torch.arange(total, dtype=torch.int64, device=flat_mask.device)
    score = flat_mask.to(torch.int64) * (total + 1) - iota
    idx = torch.topk(score, capacity, sorted=True).indices
    return idx, torch.gather(flat_mask, -1, idx)


def scatter_compact(values, idx, taken, total: int):
    """Scatter compacted [capacity, D] rows back to flat [total, D], with
    zeros at every slot not taken."""
    out = values.new_zeros((total, values.shape[-1]))
    out[idx] = values * taken[:, None].to(values.dtype)
    return out
