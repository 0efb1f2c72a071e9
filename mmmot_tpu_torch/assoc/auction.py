"""Batched integer eps-scaling auction: port of
``mmmot_tpu/assoc/auction.py`` (``auction_lap``, ``_auction_all_phases``,
``_complete_matching``, ``solve_auction``), with the partial-matching
form the greedy solver takes (``build_gain_matrix``,
``decode_matching``).

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
from mmmot_tpu_torch.utils.profiling import host_read, span, spanned

BIG_NEG = -(2 ** 30)        # forbidden / sentinel for int32 scores
SYNC_EVERY = 64             # bidding rounds between host checks
SCALING_STEPS = 8           # eps phases (AssocConfig's default)
QUANT_BITS = 18             # score grid: 2**18 steps over each cost's span


def build_gain_matrix(link, new, end, mask_prev, mask_curr, det_prev=None,
                      det_curr=None):
    """gain[i, j] = link[i, j] - outside_p[i] - outside_c[j], ``NEG`` at
    forbidden pairs: the tracking objective is the sum of the matched
    gains plus a constant, so any max-weight partial matching on it
    (outside option 0) is exact.  The outside options are end[i] and
    new[j]; with det scores linking also earns them and the outside
    option is ``max(det + end/new, 0)`` (end or reject)."""
    pair_ok = mask_prev.bool()[..., :, None] & mask_curr.bool()[..., None, :]
    if det_prev is not None:
        out_p = torch.clamp_min(end + det_prev, 0.0) - det_prev
        out_c = torch.clamp_min(new + det_curr, 0.0) - det_curr
    else:
        out_p, out_c = end, new
    gain = link - out_p[..., :, None] - out_c[..., None, :]
    return torch.where(pair_ok, gain, torch.full((), NEG, dtype=gain.dtype,
                                                 device=gain.device))


def decode_matching(row_to_col, mask_prev, mask_curr, new=None, end=None,
                    det_prev=None, det_curr=None) -> Decisions:
    """A *partial* matching [.., N] (curr column or -1) -> Decisions."""
    N = mask_prev.shape[-1]
    mp, mc = mask_prev.bool(), mask_curr.bool()
    linked = (row_to_col >= 0) & mp
    match_prev = torch.where(linked, row_to_col, -1).to(torch.int32)
    is_end = mp & ~linked
    lead = match_prev.shape[:-1]
    cols = torch.arange(N, device=mp.device)
    idx = torch.where(linked, match_prev, N).long().reshape(-1, N)
    src = torch.where(linked, cols.to(torch.int32), -1).reshape(-1, N)
    inv = torch.full((idx.shape[0], N + 1), -1, dtype=torch.int32,
                     device=mp.device)
    inv.scatter_(1, idx, src)
    match_curr = torch.where(mc, inv[:, :N].reshape(*lead, N), -1)
    is_new = mc & (match_curr < 0)
    if det_prev is not None:
        is_end = is_end & ((det_prev + end) >= 0.0)
        is_new = is_new & ((det_curr + new) >= 0.0)
    keep_prev = linked | is_end
    keep_curr = ((match_curr >= 0) | is_new) & mc
    return Decisions(match_prev, match_curr.to(torch.int32), is_end, is_new,
                     keep_prev, keep_curr)


def _quantize(cost):
    """float [S, M, M] -> int32 scores on the (M + 1)-scaled grid."""
    M = cost.shape[-1]
    allowed = cost > NEG / 2
    cost = cost.float()
    inf = torch.full((), float("inf"), device=cost.device)
    cmax = torch.where(allowed, cost, -inf).amax(dim=(-2, -1), keepdim=True)
    cmin = torch.where(allowed, cost, inf).amin(dim=(-2, -1), keepdim=True)
    span = (cmax - cmin).clamp_min(1e-12)
    q = torch.round((cost - cmin) / span * float(2 ** QUANT_BITS))
    ci = q.to(torch.int32) * (M + 1)
    return torch.where(allowed, ci, torch.full_like(ci, BIG_NEG))


def _running(assign, eps, it, max_iters: int):
    """The instances still bidding: unassigned rows or eps above 1, under
    the iteration cap."""
    return ((assign < 0).any(dim=1) | (eps > 1)) & (it < max_iters)


def _bid_round(cost, assign, owner, prices, eps, it, running, rows, big_neg,
               cap, scale_div: int):
    """One round of every running instance: a phase end where the
    matching is complete, else a bidding round.  Returns the next
    (assign, owner, prices, eps, it)."""
    i32 = torch.int32
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
    return assign, owner, prices, eps, it


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
    big_neg = torch.full((), BIG_NEG, dtype=i32, device=dev)
    cap = torch.full((), bid_cap, dtype=i32, device=dev)
    rounds = 0
    running = _running(assign, eps, it, max_iters)
    # A host check every SYNC_EVERY rounds, the first before any round.
    while host_read(running.any(), "auction.check"):
        with span("auction.bid"):
            for _ in range(SYNC_EVERY):
                rounds += 1
                assign, owner, prices, eps, it = _bid_round(
                    cost, assign, owner, prices, eps, it, running, rows,
                    big_neg, cap, scale_div)
                running = _running(assign, eps, it, max_iters)
    return assign, owner, rounds


def _complete_matching(cost, assign, owner):
    """Greedy completion of rows left unassigned at the iteration cap
    (rare): row by row, take the best column no row owns yet."""
    S, M, _ = cost.shape
    cols = torch.arange(M, device=cost.device)
    batch = torch.arange(S, device=cost.device)
    big_neg = torch.full((), BIG_NEG, dtype=cost.dtype, device=cost.device)
    for i in range(M):
        need = assign[:, i] < 0                          # [S]
        vals = torch.where(owner < 0, cost[:, i], big_neg)
        j = vals.argmax(dim=1)                           # [S]
        assign[:, i] = torch.where(need, j.to(assign.dtype), assign[:, i])
        hit = need[:, None] & (cols[None, :] == j[:, None])
        owner = torch.where(hit, torch.full((), i, dtype=owner.dtype,
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
    with span("auction.quantize"):
        ci = _quantize(cost)
    start = (2 ** QUANT_BITS) * (M + 1) // 4
    scale_div = max(2, int(math.ceil(start ** (1.0 / max(scaling_steps,
                                                         1)))))
    bid_cap = (2 ** QUANT_BITS) * (M + 1)
    assign, owner, rounds = _auction_all_phases(ci, start, scale_div,
                                                max_iters, bid_cap)
    auction_lap.rounds += rounds
    with span("auction.complete"):
        n_unassigned = (assign < 0).sum(dim=1)
        if host_read((n_unassigned > 0).any(), "auction.check"):
            assign, owner = _complete_matching(ci, assign.clone(), owner)
    return assign, n_unassigned


auction_lap.rounds = 0


@spanned("auction")
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
