"""Training cells: ``train/trainer.py::train_step`` on batches of adjacent
frame pairs, each batch cut on the card by the program's own
preprocessing (``crop_and_resize_batched``, ``normalize_crops``,
``frustum_sample_batched``), as ``data/kitti_loader.py`` cuts it after
its PNG decode.

Set-up builds one training state, drives it through the cell's first
``check_steps`` steps by the window's own call (and keeps what the
check compares: each step's loss, the first gradient as the optimizer
holds it, the change of every weight), then hands the same state to
the window.  The window runs synchronised steps until ``--seconds`` have
passed; ``train_pairs_per_s`` is every pair of every step over the time
they took.  A traced run profiles its first ``profile_steps`` steps.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Optional

import torch

from bench_port.harness import common, trace
from bench_port.harness.entry_track import reference_inputs, sync
from bench_port.harness.traffic import make_scene
from bench_port.reference.mmmot import (FIT_ROWS, fit_to_traffic,
                                        param_shapes)
from bench_port.reference.train import RefTrainer, batch_of, labels


def groups(cars, batch: int):
    """Sequences of each batch group: sorted by their car count, the k-th
    fewest paired with the k-th most, the pairs dealt to the groups in
    turn, so that every group holds the same number of cars."""
    order = sorted(range(len(cars)), key=lambda s: (cars[s], s))
    pairs = [(order[k], order[-1 - k]) for k in range(len(order) // 2)]
    n_groups = len(cars) // batch
    return [[s for p in pairs[g::n_groups] for s in p]
            for g in range(n_groups)]


class TrainCell:
    def __init__(self, cell: dict, seed: int, device):
        from mmmot_tpu_torch.config import config_from_dict
        from mmmot_tpu_torch.models.tracking_net import TrackingNet
        from mmmot_tpu_torch.train.trainer import create_train_state

        self.cell, self.seed, self.device = cell, seed, device
        raw = cell["cfg"]["config"]
        self.mcfg, self.tcfg = raw["model"], raw["train"]
        self.cfg = config_from_dict(raw)
        mix = self.mix = cell["mix"]
        self.B = self.tcfg["batch_size"]
        self.N = self.cfg.data.max_dets
        self.crop = tuple(self.cfg.model.appearance.crop_size)
        self.P = self.cfg.model.point.point_len
        self.scene = make_scene(mix, seed, self.N, device)
        cars = self.scene["cars"].tolist()
        self.groups = groups(cars, self.B)
        self.frames = mix["frames"]
        weights = common.make_weights(param_shapes(self.mcfg), seed, device)
        sc = self.scene
        s, t, n = sc["det_mask"].nonzero(as_tuple=True)
        rows = (s[:FIT_ROWS], t[:FIT_ROWS], n[:FIT_ROWS])
        crops, pts, pm = reference_inputs(sc, rows, sc["proj"], self.crop,
                                          self.P)
        self.weights = fit_to_traffic(weights, self.mcfg, crops, pts, pm)
        self.labels = [self.make_labels(j) for j in range(self.n_batches())]
        net = TrackingNet(self.cfg.model, device=device)
        net.load_state_dict(self.weights, strict=True)
        self.state = create_train_state(net, self.cfg.train,
                                        mix["steps_per_epoch"])
        self.losses, self.n_dets = [], []
        self.k = 0
        # The first steps: warm-up, and what the check compares.
        p0 = {k: v.detach().clone() for k, v in net.named_parameters()}
        self.step()
        opt = self.state.optimizer
        # Adam's first moment after one step is 0.1 g: the gradient as the
        # optimizer got it (none kept: a step that changed nothing).
        self.first_grad = {
            name: float(opt.state[p]["mu"].float().norm()) / (1 - 0.9)
            if "mu" in opt.state[p] else 0.0
            for name, p in net.named_parameters()}
        for _ in range(mix["check_steps"] - 1):
            self.step()
        self.change = {name: float((p.detach() - p0[name]).float().norm())
                       for name, p in net.named_parameters()}
        self.check_losses = [float(x) for x in self.losses]
        del p0

    def n_batches(self) -> int:
        return len(self.groups) * (self.frames - 1)

    def where(self, j: int):
        """(sequences, first frame) of batch ``j``."""
        j %= self.n_batches()
        return self.groups[j % len(self.groups)], j // len(self.groups)

    def make_labels(self, j: int) -> dict:
        seqs, t = self.where(j)
        sc = self.scene
        ids, dm = sc["ids"][seqs, t:t + 2], sc["det_mask"][seqs, t:t + 2]
        N = self.N
        link = torch.zeros((len(seqs), 1, N, N), device=self.device)
        new = torch.zeros((len(seqs), 1, N), device=self.device)
        end = torch.zeros((len(seqs), 1, N), device=self.device)
        for b in range(len(seqs)):
            lk, nw, ed = labels(ids[b, 0], ids[b, 1])
            pm = dm[b, 0][:, None] & dm[b, 1][None, :]
            link[b, 0] = lk * pm
            new[b, 0] = nw * dm[b, 1]
            end[b, 0] = ed * dm[b, 0]
        return {"gt_link": link, "gt_new": new, "gt_end": end,
                "gt_ids": torch.where(dm, ids, -1).to(torch.int32)}

    def step(self) -> None:
        """One training step on the next batch, cut on the card by the
        program's preprocessing; waits for the device."""
        from mmmot_tpu_torch.ops.crop_resize import (crop_and_resize_batched,
                                                     normalize_crops)
        from mmmot_tpu_torch.ops.frustum import frustum_sample_batched
        from mmmot_tpu_torch.train.trainer import train_step

        seqs, t = self.where(self.k)
        sc = self.scene
        boxes = sc["boxes"][seqs, t:t + 2]
        dm = sc["det_mask"][seqs, t:t + 2]
        crops = crop_and_resize_batched(sc["images"][seqs, t:t + 2].float(),
                                        boxes, self.crop, dm)
        crops = normalize_crops(crops, scale=1.0 / 255.0)
        pts, pmask = frustum_sample_batched(sc["clouds"][seqs, t:t + 2],
                                            boxes, sc["proj"], self.P,
                                            det_mask=dm)
        batch = {"crops": crops, "points": pts, "point_mask": pmask,
                 "boxes": boxes, "det_mask": dm,
                 **self.labels[self.k % self.n_batches()]}
        self.state, metrics = train_step(
            self.state, batch, tuple(self.tcfg["loss_weights"]),
            compact_capacity=self.tcfg["compact_capacity"])
        self.losses.append(metrics["total"].detach())
        self.n_dets.append((metrics["n_dets"].detach(), dm.sum()))
        self.k += 1
        sync(self.device)

    def window_work(self, first: int, steps: int) -> dict:
        """Valid crops and pairs of steps ``first`` .. ``first + steps``."""
        dets = pairs = pair_dets = 0.0
        for j in range(first, first + steps):
            seqs, t = self.where(j)
            c = self.scene["det_mask"][seqs, t:t + 2].sum(-1).double()
            dets += float(c.sum())
            pairs += float((c[:, 0] * c[:, 1]).sum())
            pair_dets += float(c.sum())
        return {"dets": dets, "pairs": pairs, "pair_dets": pair_dets}

    def failed_steps(self) -> int:
        """Steps with a non-finite loss or a dropped valid detection."""
        bad = 0
        for loss, (kept, valid) in zip(self.losses, self.n_dets):
            bad += int(not torch.isfinite(loss).item()
                       or int(kept) != int(valid))
        return bad

    def free_program(self) -> None:
        self.state = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # ---- correctness ----------------------------------------------------
    def check(self, program=None) -> dict:
        """The compared numbers: the reference follows the check steps on
        the same batches; ``program`` (default: what set-up kept) gives
        the losses, first gradients and changes to judge."""
        got = program or {"losses": self.check_losses,
                          "first_grad": self.first_grad,
                          "change": self.change}
        return compare(got, self.reference_run())

    def reference_run(self, lowp: bool = False, ref_cls=None) -> dict:
        """The reference's losses, first (clipped) gradient norms and
        weight changes over the check steps."""
        kw = {} if ref_cls is None else {"ref_cls": ref_cls}
        rt = RefTrainer(self.weights, self.mcfg, self.tcfg,
                        self.mix["steps_per_epoch"], lowp=lowp, **kw)
        p0 = {k: rt.p[k].detach().clone() for k in rt.leaves}
        losses, first = [], None
        for j in range(self.mix["check_steps"]):
            seqs, t = self.where(j)
            loss, g = rt.step(batch_of(self.scene, seqs, t), self.crop,
                              self.P)
            losses.append(loss)
            if first is None:
                first = {k: float(v.norm()) for k, v in g.items()}
        change = {k: float((rt.p[k].detach() - p0[k]).norm())
                  for k in rt.leaves}
        return {"losses": losses, "first_grad": first, "change": change}


def compare(got: dict, ref: dict) -> dict:
    """The worst gaps: of a step's loss, relative to the reference's; of a
    leaf's first-gradient norm and of its change's norm, each relative
    to the larger of the reference leaf's norm and the median leaf's.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out (round-off alone moves them under Adam)."""
    losses = [abs(a - b) / max(abs(b), 1e-12)
              for a, b in zip(got["losses"], ref["losses"])]
    g_ref = ref["first_grad"]
    med_g = sorted(g_ref.values())[len(g_ref) // 2]
    kept = [k for k in g_ref if g_ref[k] >= 1e-3 * med_g]

    def gaps(key):
        r = ref[key]
        med = sorted(r[k] for k in kept)[len(kept) // 2]
        return sorted((abs(got[key][k] - r[k]) / max(r[k], med, 1e-30), k)
                      for k in kept)

    g, c = gaps("first_grad"), gaps("change")
    gk, ck = g[-1][1], c[-1][1]
    return {"loss_gap": max(losses), "loss_gap_first": losses[0],
            "grad_gap": g[-1][0], "grad_gap_median": g[len(g) // 2][0],
            "change_gap": c[-1][0], "change_gap_median": c[len(c) // 2][0],
            "grad_worst_leaf": gk, "change_worst_leaf": ck,
            "grad_worst": (got["first_grad"][gk], ref["first_grad"][gk]),
            "change_worst": (got["change"][ck], ref["change"][ck])}


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> None:
    tc = TrainCell(cell, seed, device)
    sync(device)
    setup_s = time.perf_counter() - t_start
    first = tc.k
    metrics, breakdown = {}, None
    t0 = time.perf_counter()
    if traced:
        steps = cell["mix"]["profile_steps"]
        prof = trace.profile_window(
            lambda: [tc.step() for _ in range(steps)])
        w = tc.window_work(first, steps)
        ctx = {"profile": prof, "work": w, "mcfg": tc.mcfg, "int8": False}
    while time.perf_counter() - t0 < seconds:
        tc.step()
    elapsed = time.perf_counter() - t0
    steps_run = tc.k - first
    if traced:
        ctx["memory_peak"] = (torch.cuda.max_memory_allocated()
                              if torch.cuda.is_available() else 0)
        metrics = common.read_metrics(cell, ctx)
        breakdown = {"device_ops": trace.top(prof["kernels"]),
                     "idle_gaps": trace.top(prof["gaps"])}
    else:
        metrics["train_pairs_per_s"] = {
            "value": steps_run * tc.B / elapsed, "unit": "pairs/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    failed = tc.failed_steps()
    if torch.cuda.is_available():
        dev = common.device_info(cell["chips"])
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": 0}
    if traced:
        dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
    tc.free_program()
    found = common.forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    t_ref = time.perf_counter()
    reads = tc.check()
    print(f"set-up {setup_s:.1f} s, reference {time.perf_counter() - t_ref:.1f}"
          f" s, {steps_run} steps", file=sys.stderr)
    correct, checks = common.judge(reads, cell["limits"])
    common.emit(correct and failed == 0, len(tc.losses), failed, metrics,
                dev, checks, breakdown, reads)


@contextlib.contextmanager
def planted(fault: Optional[str]):
    """The program with a fault planted underneath while inside:
    ``half_batch`` leaves the second half of each batch's pairs out of
    the step (the loss and gradients are the mean over the rest)."""
    if fault is None:
        yield
        return
    if fault != "half_batch":
        raise ValueError(f"unknown fault {fault!r}")
    import mmmot_tpu_torch.train.trainer as trainer

    real = trainer.loss_and_grads

    def half(net, batch, *a, **kw):
        dm = batch["det_mask"].clone()
        dm[dm.shape[0] // 2:] = False
        return real(net, dict(batch, det_mask=dm), *a, **kw)

    trainer.loss_and_grads = half
    try:
        yield
    finally:
        trainer.loss_and_grads = real


def calibration_readings(cell: dict, seed: int, device, program: bool = True,
                         control: bool = False,
                         fault: Optional[str] = None) -> dict:
    """The compared numbers after the set-up: the program's (with
    ``fault`` planted, if one is named), and the control's (the reference
    one precision below the configuration in the program's place)."""
    with planted(fault):
        tc = TrainCell(cell, seed, device)
    tc.free_program()
    ref = tc.reference_run()
    out = {}
    if program:
        out["fault" if fault else "program"] = compare(
            {"losses": tc.check_losses, "first_grad": tc.first_grad,
             "change": tc.change}, ref)
    if control:
        out["control"] = compare(tc.reference_run(lowp=True), ref)
    return out
