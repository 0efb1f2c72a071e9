"""Solver dispatch: port of ``mmmot_tpu/assoc/solve.py::associate``, one
entry point for the six association solvers."""

from __future__ import annotations

from typing import Optional

import torch

from mmmot_tpu_torch.assoc.auction import solve_auction
from mmmot_tpu_torch.assoc.cost import NEG, Decisions
from mmmot_tpu_torch.assoc.greedy import solve_greedy
from mmmot_tpu_torch.assoc.ilp_oracle import (solve_ilp_oracle,
                                              solve_lap_oracle,
                                              solve_native_oracle)
from mmmot_tpu_torch.assoc.sinkhorn import solve_sinkhorn
from mmmot_tpu_torch.config import AssocConfig

SOLVERS = ("auction", "sinkhorn", "greedy", "ilp", "lap", "native")


def associate(link, new, end, mask_prev, mask_curr,
              cfg: Optional[AssocConfig] = None, det_prev=None,
              det_curr=None) -> Decisions:
    """Solve association instances with the solver ``cfg.solver`` names
    (``cfg`` defaults to ``AssocConfig()``): ``auction``, ``sinkhorn`` and
    ``greedy`` on the tensors' device, batched over any leading axes;
    ``ilp``, ``lap`` and ``native`` exact on the host, one instance at a
    time (``native`` also batched), results on the input's device.  An
    unknown name raises ``ValueError``.

    ``det_prev``/``det_curr`` are optional per-detection confidence
    scores (log-odds-like) that let the LP reject false positives (the
    reference ILP's ``y_det`` variables).
    """
    cfg = cfg or AssocConfig()
    if cfg.link_threshold > 0.0:
        # Links below the threshold are forbidden outright; the solver
        # then explains those detections by end/new instead.
        link = torch.where(link >= cfg.link_threshold, link,
                           torch.full((), NEG, dtype=link.dtype,
                                      device=link.device))
    det = {"det_prev": det_prev, "det_curr": det_curr}
    s = cfg.solver
    if s == "auction":
        return solve_auction(link, new, end, mask_prev, mask_curr,
                             scaling_steps=cfg.auction_scaling_steps, **det)
    if s == "sinkhorn":
        return solve_sinkhorn(link, new, end, mask_prev, mask_curr,
                              tau=cfg.sinkhorn_tau, iters=cfg.sinkhorn_iters,
                              **det)
    if s == "greedy":
        return solve_greedy(link, new, end, mask_prev, mask_curr, **det)
    if s == "ilp":
        return solve_ilp_oracle(link, new, end, mask_prev, mask_curr, **det)
    if s == "lap":
        return solve_lap_oracle(link, new, end, mask_prev, mask_curr, **det)
    if s == "native":
        return solve_native_oracle(link, new, end, mask_prev, mask_curr,
                                   **det)
    raise ValueError(f"unknown solver {s!r}; expected one of {SOLVERS}")
