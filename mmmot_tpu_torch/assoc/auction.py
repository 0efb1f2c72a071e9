"""Batched integer eps-scaling auction: port of
``mmmot_tpu/assoc/auction.py`` (``auction_lap``, ``_auction_all_phases``,
``_complete_matching``, ``solve_auction``).

The reference vmaps a ``while_loop``, which applies the body only to the
instances whose condition still holds.  Here all instances run as one
batch: each round computes the body for every instance and keeps the new
state only where the instance is still running.  The host reads the
running flags once every ``SYNC_EVERY`` rounds; the extra rounds are
no-ops for finished instances, so the result is the same as stopping each
instance on time.  Scores are quantized exactly as in the reference
(float32, ``torch.round`` is half-to-even like ``jnp.round``), and the
bidding runs in int32 with the same argmax tie-breaking (first maximum).
"""

from __future__ import annotations

import math

import torch

from mmmot_tpu_torch.assoc.cost import (NEG, Decisions, build_assignment_cost,
                                        decode_assignment)

BIG_NEG = -(2 ** 30)        # forbidden / sentinel for int32 scores
SYNC_EVERY = 64             # bidding rounds between host checks
SCALING_STEPS = 8           # eps phases (AssocConfig's default)
QUANT_BITS = 18             # score grid: 2**18 steps over each cost's span


def _quantize(cost):
    """float [S, M, M] -> int32 scores on the (M + 1)-scaled grid."""
    M = cost.shape[-1]
    allowed = cost > NEG / 2
    cost = cost.float()
    inf = torch.tensor(float("inf"), device=cost.device)
    cmax = torch.where(allowed, cost, -inf).amax(dim=(-2, -1), keepdim=True)
    cmin = torch.where(allowed, cost, inf).amin(dim=(-2, -1), keepdim=True)
    span = (cmax - cmin).clamp_min(1e-12)
    q = torch.round((cost - cmin) / span * float(2 ** QUANT_BITS))
    ci = q.to(torch.int32) * (M + 1)
    return torch.where(allowed, ci, torch.full_like(ci, BIG_NEG))


def _auction_all_phases(cost, eps_start: int, scale_div: int,
                        max_iters: int, bid_cap: int):
    """All eps phases for S instances at once; cost int32 [S, M, M].

    Returns (assign [S, M], owner [S, M]) int32, -1 where unassigned,
    and the bidding rounds run (the slowest instance's, rounded up to
    ``SYNC_EVERY``).
    """
    S, M, _ = cost.shape
    dev = cost.device
    i32 = torch.int32
    assign = torch.full((S, M), -1, dtype=i32, device=dev)
    owner = torch.full((S, M), -1, dtype=i32, device=dev)
    prices = torch.zeros((S, M), dtype=i32, device=dev)
    eps = torch.full((S,), eps_start, dtype=i32, device=dev)
    it = torch.zeros((S,), dtype=i32, device=dev)
    rows = torch.arange(M, dtype=i32, device=dev)
    big_neg = torch.tensor(BIG_NEG, dtype=i32, device=dev)
    cap = torch.tensor(bid_cap, dtype=i32, device=dev)
    rounds = 0
    while True:
        unfinished = (assign < 0).any(dim=1) | (eps > 1)
        running = unfinished & (it < max_iters)
        if rounds % SYNC_EVERY == 0 and not bool(running.any()):
            break
        rounds += 1
        converged = ~(assign < 0).any(dim=1)
        # Phase end: divide eps, reset the matching, keep the prices.
        done_eps = torch.clamp_min(eps // scale_div, 1)
        # Bidding round (Jacobi: every unassigned row bids at once).
        active = assign < 0
        v = cost - prices[:, None, :]                    # [S, M, M]
        best_v, best_j = v.max(dim=2)
        is_best = rows[None, None, :] == best_j[:, :, None].to(i32)
        second_v = torch.where(is_best, big_neg, v).amax(dim=2)
        bid = torch.minimum(best_v - second_v, cap) + eps[:, None]
        bids = torch.where(active[:, :, None] & is_best, bid[:, :, None],
                           big_neg)
        win_bid, win_row = bids.max(dim=1)              # per column
        win_row = win_row.to(i32)
        contested = win_bid > BIG_NEG // 2
        bid_prices = torch.where(contested, prices + win_bid, prices)
        won = contested[:, None, :] & (win_row[:, None, :] == rows[None, :,
                                                                   None])
        row_won = won.any(dim=2)
        new_col = won.to(torch.uint8).argmax(dim=2).to(i32)
        owned = (owner[:, None, :] == rows[None, :, None]) & contested[:, None,
                                                                       :]
        displaced = owned.any(dim=2) & ~row_won
        bid_assign = torch.where(row_won, new_col,
                                 torch.where(displaced, -1, assign))
        bid_owner = torch.where(contested, win_row, owner)

        conv = converged[:, None]
        upd = running[:, None]
        assign = torch.where(upd, torch.where(conv, -1, bid_assign), assign)
        owner = torch.where(upd, torch.where(conv, -1, bid_owner), owner)
        prices = torch.where(upd & ~conv, bid_prices, prices)
        eps = torch.where(running & converged, done_eps, eps)
        it = it + running.to(i32)
    return assign, owner, rounds


def _complete_matching(cost, assign, owner):
    """Greedy completion of rows left unassigned at the iteration cap
    (rare): row by row, take the best column no row owns yet."""
    S, M, _ = cost.shape
    cols = torch.arange(M, device=cost.device)
    batch = torch.arange(S, device=cost.device)
    big_neg = torch.tensor(BIG_NEG, dtype=cost.dtype, device=cost.device)
    for i in range(M):
        need = assign[:, i] < 0                          # [S]
        vals = torch.where(owner < 0, cost[:, i], big_neg)
        j = vals.argmax(dim=1)                           # [S]
        assign[:, i] = torch.where(need, j.to(assign.dtype), assign[:, i])
        hit = need[:, None] & (cols[None, :] == j[:, None])
        owner = torch.where(hit, torch.tensor(i, dtype=owner.dtype,
                                              device=owner.device), owner)
    return assign, owner


def auction_lap(cost, scaling_steps: int = SCALING_STEPS,
                max_iters: int = 100000):
    """Max-weight perfect matching for each of S square cost matrices.

    cost float [S, M, M] -> (row_to_col int32 [S, M], n_unassigned [S],
    the rows left for the greedy completion: 0 whenever the auction
    converged).  ``auction_lap.rounds`` counts the bidding rounds run, over
    all calls; each round launches the loop body's ops once for the
    whole batch.
    """
    S, M, _ = cost.shape
    ci = _quantize(cost)
    start = (2 ** QUANT_BITS) * (M + 1) // 4
    scale_div = max(2, int(math.ceil(start ** (1.0 / max(scaling_steps,
                                                         1)))))
    bid_cap = (2 ** QUANT_BITS) * (M + 1)
    assign, owner, rounds = _auction_all_phases(ci, start, scale_div,
                                                max_iters, bid_cap)
    auction_lap.rounds += rounds
    n_unassigned = (assign < 0).sum(dim=1)
    if bool((n_unassigned > 0).any()):
        assign, owner = _complete_matching(ci, assign.clone(), owner)
    return assign, n_unassigned


auction_lap.rounds = 0


def solve_auction(link, new, end, mask_prev, mask_curr,
                  scaling_steps: int = SCALING_STEPS,
                  max_iters: int = 100000, det_prev=None,
                  det_curr=None) -> Decisions:
    """Scores -> square reduction -> auction -> decisions, for any
    leading batch shape; ``det_prev``/``det_curr`` as in
    ``build_assignment_cost``."""
    cost = build_assignment_cost(link, new, end, mask_prev, mask_curr,
                                 det_prev=det_prev, det_curr=det_curr)
    lead = cost.shape[:-2]
    M = cost.shape[-1]
    rc, _ = auction_lap(cost.reshape(-1, M, M), scaling_steps=scaling_steps,
                        max_iters=max_iters)
    return decode_assignment(rc.reshape(*lead, M), mask_prev, mask_curr,
                             new=new, end=end, det_prev=det_prev,
                             det_curr=det_curr)
