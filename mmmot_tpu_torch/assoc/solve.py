"""Solver entry point: port of ``mmmot_tpu/assoc/solve.py::associate``
for the auction."""

from __future__ import annotations

from typing import Optional

import torch

from mmmot_tpu_torch.assoc.auction import solve_auction
from mmmot_tpu_torch.assoc.cost import NEG, Decisions
from mmmot_tpu_torch.config import AssocConfig


def associate(link, new, end, mask_prev, mask_curr,
              cfg: Optional[AssocConfig] = None, det_prev=None,
              det_curr=None) -> Decisions:
    """Solve a batch of association instances with the auction.

    ``cfg`` defaults to ``AssocConfig()``.  ``det_prev``/``det_curr`` are
    optional per-detection confidence scores (log-odds-like) that let the
    LP reject false positives (the reference ILP's ``y_det`` variables).
    """
    cfg = cfg or AssocConfig()
    if cfg.link_threshold > 0.0:
        # Links below the threshold are forbidden outright; the solver
        # then explains those detections by end/new instead.
        link = torch.where(link >= cfg.link_threshold, link,
                           torch.tensor(NEG, dtype=link.dtype,
                                        device=link.device))
    return solve_auction(link, new, end, mask_prev, mask_curr,
                         scaling_steps=cfg.auction_scaling_steps,
                         det_prev=det_prev, det_curr=det_curr)
