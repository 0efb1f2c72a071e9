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

from tests.torch_port_fixtures import torch_one_thread  # noqa: F401


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


@pytest.mark.parametrize("N,dtype", [(32, "float32"), (64, "float32"),
                                     (32, "bfloat16")])
def test_ydet_decisions_equal_reference(N, dtype):
    """Detection-confidence scores (y_det) through ``solve_auction`` on
    random instances with holed masks: every decision, the rejections
    (``keep_*`` False at a valid slot) included, equals the reference's."""
    from mmmot_tpu.assoc import associate as j_associate
    from mmmot_tpu.config import AssocConfig as JAssocConfig

    link, new, end, _, _ = make_instances("rand", N, seed=11)
    rng = np.random.default_rng(N)
    mp = rng.random((6, N)) < 0.6
    mc = rng.random((6, N)) < 0.6
    # Raw new/end logits and det logits of mixed sign, so that end/new,
    # links and the reject arm all win somewhere.
    new, end = 2.0 * new - 0.5, 2.0 * end - 0.5
    dp = rng.normal(0.0, 1.0, (6, N)).astype(np.float32)
    dc = rng.normal(0.0, 1.0, (6, N)).astype(np.float32)
    args = (link, new, end, mp, mc, dp, dc)
    jd = [jnp.asarray(x, dtype) if x.dtype == np.float32 else jnp.asarray(x)
          for x in args]
    ref = jax.jit(lambda l, n, e, p, c, a, b: j_associate(
        l, n, e, p, c, JAssocConfig(solver="auction", use_det_scores=True),
        det_prev=a, det_curr=b))(*jd)
    td = [torch.from_numpy(x).to(getattr(torch, dtype))
          if x.dtype == np.float32 else torch.from_numpy(x) for x in args]
    got = solve_auction(*td[:5], det_prev=td[5], det_curr=td[6])
    check_same(got, ref)
    assert (mp & ~got.keep_prev.numpy()).any()
    assert (mc & ~got.keep_curr.numpy()).any()
    assert got.is_new.any() and got.is_end.any()
    assert (got.match_prev >= 0).any()


def test_link_threshold_equals_reference():
    """``link_threshold`` forbids weak links through ``associate``."""
    from mmmot_tpu.assoc import associate as j_associate
    from mmmot_tpu.config import AssocConfig as JAssocConfig
    from mmmot_tpu_torch.config import AssocConfig

    link, new, end, mp, mc = make_instances("rand", 16, seed=5)
    ref = j_associate(*map(jnp.asarray, (link, new, end, mp, mc)),
                      JAssocConfig(solver="auction", link_threshold=0.5))
    got = associate(*map(torch.from_numpy, (link, new, end, mp, mc)),
                    AssocConfig(link_threshold=0.5))
    check_same(got, ref)
    linked = got.match_prev.numpy()
    rows, = np.nonzero((linked >= 0).any(1))
    assert rows.size
    for b in rows:
        for i in np.flatnonzero(linked[b] >= 0):
            assert link[b, i, linked[b, i]] >= 0.5
