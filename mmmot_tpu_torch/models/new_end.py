"""Birth/death heads: port of ``mmmot_tpu/models/new_end.py::NewEndHead``
(v2 over the link's max, mean or softmax-weighted pools; v1 on the
feature alone)."""

from __future__ import annotations

import torch
from torch import nn

from mmmot_tpu_torch.models.layers import MLP2, ordered_sum
from mmmot_tpu_torch.ops.masking import (masked_max, masked_mean,
                                         masked_softmax, pair_mask)


def pool_link(link, pm, dim: int, pool: str):
    """The link pooled over ``dim`` at the ``pm``-valid pairs: ``max``
    (0 where none is valid), ``mean`` (the sum over at least one), or
    ``softmax`` (the link weighted by its masked softmax: the products
    in float32, summed in the reference's order, rounded once), in the
    dtype of ``link``; an unknown pool raises, as the reference's
    ``_pool``."""
    if pool == "max":
        return masked_max(link, pm, dim=dim)
    if pool == "mean":
        return masked_mean(link, pm, dim=dim)
    if pool == "softmax":
        w = masked_softmax(link, pm, dim=dim)
        return ordered_sum(w.float() * link.float(), dim).to(link.dtype)
    raise ValueError(f"unknown pool {pool!r}")


class NewEndHead(nn.Module):
    """-> (new [.., Nc], end [.., Np]) logits, zero at invalid slots.
    ``version`` >= 2 concatenates each detection's row (end) or column
    (new) pool of the link to its feature; v1 reads the feature alone."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype,
                 version: int = 2, pool: str = "max"):
        super().__init__()
        self.version, self.pool = version, pool
        width = dim + 1 if version >= 2 else dim
        self.new_mlp = MLP2(width, hidden, 1, dtype)
        self.end_mlp = MLP2(width, hidden, 1, dtype)

    def forward(self, feat_prev, feat_curr, link, mask_prev, mask_curr):
        if self.version >= 2:
            pm = pair_mask(mask_prev, mask_curr)
            row = pool_link(link, pm, -1, self.pool)        # [.., Np]
            col = pool_link(link, pm, -2, self.pool)        # [.., Nc]
            end_in = torch.cat([feat_prev, row[..., None]], dim=-1)
            new_in = torch.cat([feat_curr, col[..., None]], dim=-1)
        else:
            end_in, new_in = feat_prev, feat_curr
        new = self.new_mlp(new_in)[..., 0]
        end = self.end_mlp(end_in)[..., 0]
        return new * mask_curr.to(new.dtype), end * mask_prev.to(end.dtype)
