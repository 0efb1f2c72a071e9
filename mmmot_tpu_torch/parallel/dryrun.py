"""The data-parallel dry run: the port's counterpart of the reference's
``__graft_entry__.py::dryrun_multichip``.

``dryrun(n, backend, device)`` starts ``n`` ranks (one process each,
``torch.multiprocessing`` with the spawn method, a process group at
``tcp://localhost:<free port>``).  Each builds the same nets and inputs
and runs, sharded over the data axis of its mesh:

- ``train``: one data-parallel ``train_step`` on a batch of frame pairs
  (``train_batch``), the rows split over the ranks;
- ``norm``: a train-mode ``MaskedBatchNorm`` over a process group and
  the gradient through it;
- the tracking legs, S sequences of padded detections
  (``dryrun_inputs``) split over the ranks and tracked by
  ``track_sequences_batched``, the ids gathered back in sequence order:
  ``auction`` (the flagship association), ``quality`` (y_det, revival,
  the IoU gate, ghost coverage) and ``motion`` (the learned motion term,
  ``motion_dim=8``, on the quality stack).

Rank 0 then runs each leg in one process on the whole batch.  The
gathered ids must equal the one-process ids bit for bit (ghost ids too),
the step's loss within 1e-4 and its gradient norm within 1e-3 relative
(the reference's ``tests/test_parallel.py`` tolerances: sums are taken
in another order), the norm leg within float32 rounding.  The step is
plain SGD at the full rate (``step_config``): the parameters must have
moved and be equal on every rank after it, and the change they made
must differ from the one-process step's (``param_err``, a relative
norm) by at most ``PARAM_RTOL``, or by twice what one process gives with
the batch's halves swapped (``param_floor``: the same sums in another
order), the larger.  ``dryrun`` returns what rank 0 found, and raises
(``check``) if a check failed.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from mmmot_tpu_torch.config import AssocConfig

LEGS = ("auction", "quality", "motion")
# The reference's production operating point (experiments/full_mmmot_noisy)
# that its dry run shards: y_det, K=4 revival, the IoU gate and prior,
# coverage capped at the first missed frame.
QUALITY = dict(solver="auction", use_det_scores=True, raw_new_end=True,
               revival_window=4, iou_weight=0.5, iou_gate=0.01,
               ghost_coverage=True, coverage_max_miss=1)
T_FRAMES = 4            # frames of each tracked sequence
LOSS_RTOL, GRAD_NORM_RTOL = 1e-4, 1e-3
NORM_TOL = 1e-5         # float32 sums over 2 ranks in another order
# The step's change of the parameters against one process's (the norm
# of their difference over the norm of the change): within the gradient
# norm's tolerance, or twice one process's with the batch in another
# order.  In float32 at full width the latter is the larger: 5.9e-3 on an
# H100, where a BatchNorm's scale gradient sums 10^7 cancelling terms.
PARAM_RTOL, PARAM_FLOOR_X = GRAD_NORM_RTOL, 2.0


def step_config(train):
    """The dry run's optimizer: ``train`` with SGD and no warmup.  A
    warmup's first rate is 0, so no parameter would move; Adam's first
    update, rate * g / (|g| + eps), is +-rate by the sign of g wherever
    g is 0 but for rounding (the biases in front of a BatchNorm), so two
    right sums in another order leave such a parameter up to 2 rates
    apart.  SGD's update is linear in g: a parameter's difference says
    how far its gradient differs."""
    return dataclasses.replace(train, optimizer="sgd", warmup_steps=0)


def motion_model(model):
    """``model`` with the learned motion term (``motion_dim=8``)."""
    return dataclasses.replace(model, affinity=dataclasses.replace(
        model.affinity, motion_dim=8))


def dryrun_inputs(cfg, S: int, T: int = T_FRAMES, seed: int = 7
                  ) -> Dict[str, np.ndarray]:
    """The tracking legs' inputs, as the reference's dry run draws them:
    crops [S, T, N, h, w, 3] and points [S, T, N, P, 4] standard normal,
    every point valid, a prefix of 1..N detections a frame, boxes [S, T,
    N, 4] of 16 px at random corners."""
    rng = np.random.default_rng(seed)
    N, P = cfg.data.max_dets, cfg.data.point_len
    h, w = cfg.data.crop_size
    out = {
        "crops": rng.normal(0, 1, (S, T, N, h, w, 3)).astype(np.float32),
        "points": rng.normal(0, 1, (S, T, N, P, 4)).astype(np.float32),
        "point_mask": np.ones((S, T, N, P), bool),
        "det_mask": (np.arange(N)[None, None, :]
                     < rng.integers(1, N + 1, (S, T))[..., None])}
    out["boxes"] = (rng.uniform(4, 60, (S, T, N, 2)).repeat(2, axis=-1)
                    + np.asarray([0, 0, 16, 16], np.float32)
                    ).astype(np.float32)
    return out


def train_batch(cfg, B: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """B labelled frame pairs (the reference's ``_example_batch``): random
    crops and points, a prefix of 1..N detections a frame, ids unique in
    a frame and partly shared across the pair."""
    from mmmot_tpu_torch.data.synthetic import association_labels

    rng = np.random.default_rng(seed)
    N, P = cfg.data.max_dets, cfg.data.point_len
    h, w = cfg.data.crop_size
    det_mask = (np.arange(N)[None, None, :]
                < rng.integers(1, N + 1, (B, 2))[..., None])
    batch = {
        "crops": rng.normal(0, 1, (B, 2, N, h, w, 3)).astype(np.float32),
        "points": rng.normal(0, 1, (B, 2, N, P, 4)).astype(np.float32),
        "point_mask": np.ones((B, 2, N, P), bool),
        "det_mask": det_mask}
    gt_ids = np.stack([np.stack([rng.permutation(2 * N)[:N]
                                 for _ in range(2)]) for _ in range(B)])
    gt_ids = np.where(det_mask, gt_ids, -1).astype(np.int32)
    lab = association_labels(gt_ids[:, 0], gt_ids[:, 1], det_mask[:, 0],
                             det_mask[:, 1])
    batch.update(gt_ids=gt_ids, gt_link=lab["link"][:, None],
                 gt_new=lab["new"][:, None], gt_end=lab["end"][:, None])
    return batch


def build_net(model, device, weights=None, seed: int = 0):
    """A ``TrackingNet`` of ``model`` on ``device`` with ``weights`` (a
    state dict), else seeded random weights (``init_random_``: the
    motion MLP's output layer is drawn nonzero too)."""
    from mmmot_tpu_torch.models.tracking_net import TrackingNet, init_random_

    net = TrackingNet(model, device="cpu")
    if weights is not None:
        net.load_state_dict(weights)
    else:
        init_random_(net, seed)
    return net.to(device)


def _free_address() -> str:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def _timed(fn):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _numpy(out):
    return {k: v.detach().float().cpu().numpy() if v.is_floating_point()
            else v.cpu().numpy() for k, v in out.items()}


def _capacity(batch, compact_capacity: int) -> int:
    """``compact_capacity``, or with -1 the batch's valid detections
    rounded up to 32: every valid row extracted, none dropped, and no
    more rows than that (the full-width float32 step's memory)."""
    if compact_capacity >= 0:
        return compact_capacity
    return -(-int(torch.as_tensor(batch["det_mask"]).sum()) // 32) * 32


def _train_leg(cfg, mesh, weights, B, compact_capacity):
    """The data-parallel step on this rank's rows, and (rank 0) one
    process's step on the whole batch from the same weights."""
    import torch.distributed as dist

    from mmmot_tpu_torch.parallel.mesh import (all_gather_rows, replicate,
                                               shard_batch)
    from mmmot_tpu_torch.train.trainer import create_train_state, train_step

    batch = train_batch(cfg, B)
    dev = mesh.device
    # Every rank starts from rank 0's weights (the others draw their own
    # seed, which the broadcast overwrites).
    net = replicate(mesh, build_net(cfg.model, dev, weights,
                                    seed=mesh.rank))
    before = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
    train_cfg = step_config(cfg.train)
    state = create_train_state(net, train_cfg, steps_per_epoch=10)
    part = shard_batch(mesh, batch)
    (_, m), ms = _timed(lambda: train_step(
        state, part, compact_capacity=_capacity(part, compact_capacity),
        group=dist.group.WORLD))
    flat = torch.cat([p.detach().reshape(-1) for p in
                      state.net.parameters()])[None]
    every = all_gather_rows(mesh, flat)
    out = {"loss": float(m["total"]), "grad_norm": float(m["grad_norm"]),
           "n_dets": float(m["n_dets"]), "ms": ms,
           "replicated": bool((every == every[:1]).all()),
           "param_moved": float((flat[0] - before).abs().max())}
    if mesh.rank == 0:
        def one_process(rows):
            one = create_train_state(build_net(cfg.model, dev, weights,
                                               seed=0),
                                     train_cfg, steps_per_epoch=10)
            whole = {k: torch.as_tensor(v[rows], device=dev)
                     for k, v in batch.items()}
            (_, m1), ms1 = _timed(lambda: train_step(
                one, whole,
                compact_capacity=_capacity(whole, compact_capacity)))
            return m1, ms1, torch.cat(
                [p.detach().reshape(-1) for p in one.net.parameters()])

        m1, ms1, single = one_process(np.arange(B))
        # The same step with the batch's halves swapped: how far another
        # order of the same sums moves the change.
        swapped = one_process(np.roll(np.arange(B), B // 2))[2]
        move = (single - before).double().norm()
        diff = (single - flat[0]).double()
        out.update(loss_single=float(m1["total"]),
                   grad_norm_single=float(m1["grad_norm"]),
                   n_dets_single=float(m1["n_dets"]), ms_single=ms1,
                   param_max_diff=float(diff.abs().max()),
                   param_err=float(diff.norm() / move),
                   param_floor=float((single - swapped).double().norm()
                                     / move))
    return out


def _norm_leg(mesh, B=16, D=8):
    """``MaskedBatchNorm`` in train mode over the group on this rank's rows
    against one process on all B rows: outputs, running statistics and
    the gradients of a weighted sum, to x (gathered) and to the scale and
    bias (summed over the ranks)."""
    import torch.distributed as dist

    from mmmot_tpu_torch.models.layers import MaskedBatchNorm
    from mmmot_tpu_torch.parallel.mesh import all_gather_rows, shard_batch

    rng = np.random.default_rng(5)
    data = {"x": rng.normal(2.0, 3.0, (B, D)).astype(np.float32),
            "mask": rng.random(B) < 0.7,
            "w": rng.normal(0, 1, (B, D)).astype(np.float32)}
    group = dist.group.WORLD

    def run(part, grp):
        bn = MaskedBatchNorm(D).to(mesh.device).train()
        bn.group = grp
        x = part["x"].clone().requires_grad_(True)
        y = bn(x, part["mask"])
        (y * part["w"]).sum().backward()
        return y.detach(), x.grad, bn

    y, gx, bn = run(shard_batch(mesh, data), group)
    gp = torch.cat([bn.weight.grad, bn.bias.grad])
    dist.all_reduce(gp, group=group)
    got = {"y": all_gather_rows(mesh, y), "gx": all_gather_rows(mesh, gx),
           "gp": gp, "stats": torch.cat([bn.running_mean, bn.running_var])}
    if mesh.rank != 0:
        return {}
    y1, gx1, bn1 = run({k: torch.as_tensor(v, device=mesh.device)
                        for k, v in data.items()}, None)
    want = {"y": y1, "gx": gx1,
            "gp": torch.cat([bn1.weight.grad, bn1.bias.grad]),
            "stats": torch.cat([bn1.running_mean, bn1.running_var])}
    return {k: float((got[k] - want[k]).abs().max()
                     / want[k].abs().max().clamp_min(1.0)) for k in got}


def _tracking_legs(cfg, mesh, weights, S):
    """Each leg sharded over the data axis and gathered, and (rank 0) in
    one process: {leg: {"ids", "ids_single", ..., "ms", "ms_single"}}."""
    from mmmot_tpu_torch.parallel.mesh import (gather_sequences,
                                               shard_sequences)
    from mmmot_tpu_torch.tracker.sequence import track_sequences_batched
    from mmmot_tpu_torch.tracker.tracker import TrackingModule

    dev = mesh.device
    inputs = dryrun_inputs(cfg, S)
    keys = ("crops", "points", "point_mask", "det_mask", "boxes")
    net = build_net(cfg.model, dev, weights.get("net"))
    net_m = build_net(motion_model(cfg.model), dev, weights.get("motion"),
                      seed=3)
    modules = {"auction": TrackingModule(net, AssocConfig(solver="auction")),
               "quality": TrackingModule(net, AssocConfig(**QUALITY)),
               "motion": TrackingModule(net_m, AssocConfig(**QUALITY))}
    shard = shard_sequences(mesh, inputs)
    whole = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
    out = {}
    for leg, mod in modules.items():
        part, ms = _timed(lambda: track_sequences_batched(
            mod, *(shard[k] for k in keys)))
        got = _numpy(gather_sequences(mesh, part))
        res = {"ids": got["ids"], "ms": ms}
        if "ghost_ids" in got:
            res["ghost_ids"] = got["ghost_ids"]
        if mesh.rank == 0:
            one, ms1 = _timed(lambda: track_sequences_batched(
                mod, *(whole[k] for k in keys)))
            one = _numpy(one)
            res.update(ids_single=one["ids"], ms_single=ms1)
            if "ghost_ids" in one:
                res["ghost_ids_single"] = one["ghost_ids"]
        out[leg] = res
    return out


def _rank(rank: int, n: int, address: str, backend: str, device: str,
          cfg, weights, S: int, B: int, compact_capacity: int,
          result: str):
    """One rank of ``dryrun``: joins the group, runs every leg, and rank 0
    writes what it found to ``result``."""
    import torch.distributed as dist

    from mmmot_tpu_torch.parallel.mesh import (ParallelConfig,
                                               init_distributed, make_mesh)

    dev = init_distributed(rank, n, address, backend, device)
    try:
        mesh = make_mesh(ParallelConfig(num_data=n), device=dev)
        found = {"train": _train_leg(cfg, mesh, weights.get("net"), B,
                                     compact_capacity),
                 "norm": _norm_leg(mesh),
                 "tracking": _tracking_legs(cfg, mesh, weights, S),
                 "world_size": n, "backend": backend, "device": str(dev)}
        if rank == 0:
            torch.save(found, result)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def check(found) -> None:
    """Raise ``AssertionError`` where the sharded legs part from one
    process (module docstring)."""
    tr = found["train"]
    if not tr["replicated"]:
        raise AssertionError("parameters differ between ranks after the "
                             "data-parallel step")
    if not tr["param_moved"] > 0:
        raise AssertionError("no parameter moved in the data-parallel step")
    tol = max(PARAM_RTOL, PARAM_FLOOR_X * tr["param_floor"])
    if not tr["param_err"] <= tol:
        raise AssertionError(f"the data-parallel step's change of the "
                             f"parameters {tr['param_err']} (relative "
                             f"norm) from one process's, past {tol} (one "
                             f"process in another order: "
                             f"{tr['param_floor']})")
    for k, tol in (("loss", LOSS_RTOL), ("grad_norm", GRAD_NORM_RTOL)):
        a, b = tr[k], tr[f"{k}_single"]
        if not abs(a - b) <= tol * abs(b):
            raise AssertionError(f"data-parallel {k} {a} vs one process "
                                 f"{b} (rel tol {tol})")
    if tr["n_dets"] != tr["n_dets_single"]:
        raise AssertionError(f"n_dets {tr['n_dets']} vs one process "
                             f"{tr['n_dets_single']}")
    bad = {k: v for k, v in found["norm"].items() if not v <= NORM_TOL}
    if bad:
        raise AssertionError(f"BatchNorm over the group vs the whole batch: "
                             f"{bad} (tol {NORM_TOL} of scale)")
    for leg, r in found["tracking"].items():
        for k in ("ids", "ghost_ids"):
            if k in r and not np.array_equal(r[k], r[f"{k}_single"]):
                raise AssertionError(f"sharded {leg} {k} differ from one "
                                     f"process at "
                                     f"{int((r[k] != r[k + '_single']).sum())}"
                                     f" slots")


def dryrun(n: int, backend: str = "gloo", device: str = "cpu", cfg=None,
           weights: Optional[Dict[str, Dict]] = None, B: Optional[int] = None,
           compact_capacity: int = 0) -> Dict:
    """Run the legs of the module docstring over ``n`` ranks of
    ``backend`` on ``device`` (``cpu``, or ``cuda:<i>`` for every rank
    with gloo; with nccl rank r takes ``cuda:<r>`` unless ``device``
    names one by its index) for the preset ``cfg`` (default ``tiny_debug()``), with
    ``weights`` {"net": state dict, "motion": state dict of the motion
    net} or seeded ones, 2 n sequences of ``T_FRAMES`` frames and a
    train batch of B pairs (default 2 n), extracted compact-first at
    ``compact_capacity`` (0: every slot; -1: each step's own valid
    count, rounded up to 32, so that no detection is dropped).  Returns rank 0's findings
    (``train``, ``norm``, ``tracking``, with times in ms), checked by
    ``check``."""
    import torch.multiprocessing as mp

    from mmmot_tpu_torch.config import tiny_debug

    cfg = cfg or tiny_debug()
    B = B or 2 * n
    fd, result = tempfile.mkstemp(suffix=".pt")
    os.close(fd)
    try:
        mp.start_processes(
            _rank, args=(n, _free_address(), backend, device, cfg,
                         weights or {}, 2 * n, B, compact_capacity, result),
            nprocs=n, join=True, start_method="spawn")
        found = torch.load(result, weights_only=False)
    finally:
        os.unlink(result)
    check(found)
    return found
