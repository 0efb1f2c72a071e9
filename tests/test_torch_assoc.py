"""Port parity of the association: the port's batched auction gets the
same float costs as ``mmmot_tpu.assoc.solve_auction`` and must make the
same decisions exactly, on the score regimes of
tests/assoc_stress_runner.py (random, coarse ties, bf16-quantized, and
the detection-confidence cost) at N <= 32 on a few instances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmot_tpu.assoc import solve_auction as j_solve_auction
from mmmot_tpu.assoc.auction import auction_lap as j_auction_lap
from mmmot_tpu.assoc.cost import build_assignment_cost as j_build_cost
from mmmot_tpu_torch.assoc.auction import auction_lap, solve_auction
from mmmot_tpu_torch.assoc.cost import build_assignment_cost
from mmmot_tpu_torch.assoc.solve import associate


def make_instances(kind, N, batch=6, seed=0):
    """assoc_stress_runner.make_instances, at test size."""
    rng = np.random.default_rng(
        {"rand": 1, "ties": 2, "bf16": 3}.get(kind, 4) * 1000 + seed)
    link = rng.normal(0, 1, (batch, N, N)).astype(np.float32)
    if kind == "ties":
        link = np.round(link * 2) / 2
    elif kind == "bf16":
        link = np.array(jnp.asarray(link, jnp.bfloat16).astype(jnp.float32))
    new = rng.uniform(0, 1, (batch, N)).astype(np.float32)
    end = rng.uniform(0, 1, (batch, N)).astype(np.float32)
    mp = np.arange(N)[None] < rng.integers(0, N + 1, (batch, 1))
    mc = np.arange(N)[None] < rng.integers(0, N + 1, (batch, 1))
    return link, new, end, mp, mc


FIELDS = ("match_prev", "match_curr", "is_end", "is_new", "keep_prev",
          "keep_curr")


def check_same(got, ref):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


@pytest.mark.parametrize("kind,N", [("rand", 32), ("ties", 32),
                                    ("bf16", 32), ("rand", 7), ("ties", 12)])
def test_decisions_equal_reference(kind, N):
    inst = make_instances(kind, N)
    ref = jax.jit(j_solve_auction)(*map(jnp.asarray, inst))
    got = solve_auction(*map(torch.from_numpy, inst))
    check_same(got, ref)
    cost = build_assignment_cost(*map(torch.from_numpy, inst))
    _, unassigned = auction_lap(cost)
    assert int(unassigned.max()) == 0


def test_det_regime_equal_reference():
    """The reference's cost with detection-confidence scores folded in
    (links shifted per row and column, clamped new/end): the port's
    auction gets that same float cost and must pick the same matching."""
    inst = make_instances("rand", 32, seed=7)
    rng = np.random.default_rng(99)
    dp = rng.normal(0, 1.5, (6, 32)).astype(np.float32)
    dc = rng.normal(0, 1.5, (6, 32)).astype(np.float32)
    cost = jax.jit(lambda *a: j_build_cost(*a[:5], det_prev=a[5],
                                           det_curr=a[6]))(
        *map(jnp.asarray, inst + (dp, dc)))
    ref = jax.jit(jax.vmap(j_auction_lap))(cost)
    got, unassigned = auction_lap(torch.from_numpy(np.array(cost)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(unassigned.max()) == 0


@pytest.mark.parametrize("seed", [3, 4])
def test_bf16_scores_through_associate(seed):
    """bf16 link/new/end (the flagship dtype) through ``associate``; the
    reference gets the same bf16 values."""
    from mmmot_tpu.assoc import associate as j_associate
    from mmmot_tpu.config import AssocConfig as JAssocConfig

    link, new, end, mp, mc = make_instances("rand", 16, seed=seed)
    j = [jnp.asarray(x, jnp.bfloat16) for x in (link, new, end)]
    t = [torch.from_numpy(x).bfloat16() for x in (link, new, end)]
    ref = j_associate(*j, jnp.asarray(mp), jnp.asarray(mc),
                      JAssocConfig(solver="auction"))
    got = associate(*t, torch.from_numpy(mp), torch.from_numpy(mc))
    check_same(got, ref)


def test_iteration_cap_completes_matching():
    """A cap of a few rounds leaves rows unassigned; the greedy completion
    still returns a valid permutation, as the reference's does."""
    link, new, end, mp, mc = make_instances("rand", 8, batch=3)
    cost = build_assignment_cost(*map(torch.from_numpy,
                                      (link, new, end, mp, mc)))
    rc, unassigned = auction_lap(cost, max_iters=3)
    assert int(unassigned.max()) > 0
    for s in range(3):
        assert sorted(rc[s].tolist()) == list(range(16))
        ref = j_auction_lap(jnp.asarray(cost[s].numpy()), max_iters=3)
        np.testing.assert_array_equal(rc[s].numpy(), np.asarray(ref))
