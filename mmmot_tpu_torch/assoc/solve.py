"""Solver entry point: port of ``mmmot_tpu/assoc/solve.py::associate``
for the auction."""

from __future__ import annotations

from mmmot_tpu_torch.assoc.auction import solve_auction
from mmmot_tpu_torch.assoc.cost import Decisions


def associate(link, new, end, mask_prev, mask_curr) -> Decisions:
    """Solve a batch of association instances with the auction."""
    return solve_auction(link, new, end, mask_prev, mask_curr)
