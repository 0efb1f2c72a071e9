#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (``mmmot_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # the check
    python3 chip_smoke.py --profile  # also profile one main-path pass:
                                     # top CUDA kernels, and the device's
                                     # busy time over that pass's wall

Phases, each logged to stderr as ``[smoke] <phase> <elapsed>s``:

1. environment: torch, the GPU, and nvidia-smi's name and power limit;
   no CUDA device is an error;
2. build: the CUDA kernels of ``mmmot_tpu_torch/csrc`` with nvcc;
   then each kernel's registers, shared memory and spills (ptxas) and its
   tensor-core instructions (cuobjdump -sass, where the toolkit has it);
3. kernel vs plain: the fused affinity kernel against its plain PyTorch
   version at the flagship shapes (K=3, N=32, D=H=512, hh=256) for B=16
   and B=512 frame pairs, in float32 and bfloat16, with holed masks, an
   empty frame and a frame of 27 detections among them, and at the
   revival entry band's shape (B=10 pairs at N=64: 64 state slots
   against 32 real and 32 padded current slots, one pair with an empty
   state); every masked link must be exactly 0; kernel, per-launch, plain
   and library timings, each as device time and as time per call with
   the host's work;
4. reference: ``fma`` (``torch.addcmul``) must round once, as its float64
   form does; then the ``tiny_debug`` model tracks a small sequence on the CPU
   (plain versions) and on the GPU (kernels) in float32 with the same
   seeded weights; the track ids must be equal;
5. main path: the flagship ``full_mmmot`` at full width, seeded random
   weights, one sequence of T=16 raw 384x1248 frames with 16384-point
   clouds and N=32 slots (about 12 valid per frame), compact-first with
   chunk 32 and the auction; ids are checked and the fused kernel's launch
   count must rise during the run;
6. runner: a KITTI tree (two sequences of 100 and 70 frames at 376x1248,
   PNGs from the port's writer, 16384-point scans, labels as oracle
   detections) tracked by ``track_kitti_sequences``.  First ``tiny_debug``
   in float32 on the first 20 frames, window 8, two sequences per call,
   on the CPU and on the GPU: the result files must be byte-equal.  Then
   ``full_mmmot`` at full width, window 64, two sequences per call (state
   carried across windows, the last window padded): no dropped
   detections, finite scores, ids that continue across windows, and one
   fused-kernel launch per window.  The runner then tracks one window
   again with its stages timed (``stage_timers``), and the fused kernel's
   output on that window's own inputs (B=128 frame pairs) is held against
   its plain version.  Its JSON line ``{"runner": ...}`` follows;
7. quality: the same tree gains ``detections/noisy/`` (a detector
   simulated over the labels: jitter, dropout bursts of 1-4 frames,
   i.i.d. misses, false positives with overlapping scores), tracked with
   ``full_mmmot_noisy``'s association (y_det rejection, a 4-frame ghost
   pool, the IoU gate and prior, coverage rows).  First ``tiny_debug``
   widths in float32 on the first 20 frames, window 8, two sequences per
   call, CPU against GPU: the result files, coverage rows included, must
   match (a coverage row's score may differ within the port's float32
   tolerance: it is a det-head output, float32 sums in other orders on
   each device).  Then the full-width net's det and new/end output
   biases are set from the tree's first frames (``calibrate_heads``:
   random heads give logits of one sign, and the LP would reject every
   detection), and, at full width in bfloat16 on phase 5's frames and
   on the tree's first 16 frames, the revival hybrid must equal the
   sequential ``step_from_feats`` scan (ids and coverage outputs; 2
   kernel launches against 16).  Then the
   full-width noisy runner over the tree (window 64, two sequences per
   call, the ghost pool carried across the boundary): no dropped
   detections, finite scores, ids that follow the revival rules, two
   fused-kernel launches per window; then one window again with its
   stages timed (extraction, band affinity, the per-frame scan, ids),
   the auction's rounds per frame, and the kernel's outputs on that
   window's own band and entry-band inputs held against the plain
   version.  Its JSON line ``{"quality": ...}`` follows;
8. look-alike: ``full_mmmot_lookalike`` (two GNN rounds and the learned
   motion term, which enters the fused kernel as its ``link_bias``, on
   the noisy stack with coverage uncapped).  First ``tiny_debug`` widths
   with that affinity in float32, CPU against GPU, as in phase 7.  Then,
   at full width with seeded random weights: the kernel's bias instance
   against its plain version in float32 and bfloat16 at B=16 N=32 and at
   the scan's B=2 N=64 (the bias must move the link; masked links
   exactly 0), with its timings; heads calibrated as in phase 7; the
   motion-only model (the same weights without the GNN rounds) on the
   tree's first 16 frames, S=1: its revival hybrid must equal its
   sequential scan (2 launches against 16); the runner over the tree
   (window 64, two sequences per call, the sequential scan: 64
   bias-instance launches per window and no other, no dropped
   detections, ids that follow the revival rules); one window again
   with its stages timed (extraction, GNN rounds, motion term, kernel,
   scan and its auction, ghost pool, frame step) and the auction's
   rounds per frame, three of its kernel calls held against the plain
   version.  Its JSON line ``{"lookalike": ...}`` precedes the kernel
   line, which lists the bias instance as a second entry.

The last stdout line is ``{"ok": true, "device": {...}}``, printed only
when every phase passed; the line before it is a JSON object with one
entry per kernel.  Any failure raises and exits nonzero.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mmmot_tpu_torch.assoc.auction import auction_lap
from mmmot_tpu_torch.config import (full_mmmot, full_mmmot_lookalike,
                                    full_mmmot_noisy, tiny_debug)
from mmmot_tpu_torch.device import f32_parity
from mmmot_tpu_torch.kernels import build as kbuild
from mmmot_tpu_torch.kernels.affinity import (affinity_launches,
                                              affinity_plain,
                                              build_affinity_params,
                                              fused_affinity, heads_plain)
from mmmot_tpu_torch.models.layers import fma
from mmmot_tpu_torch.models.tracking_net import TrackingNet, init_random_
from mmmot_tpu_torch.tracker.kitti_runner import track_kitti_sequences
from mmmot_tpu_torch.tracker.sequence import track_sequence_from_frames
from mmmot_tpu_torch.tracker.tracker import TrackingModule

T0 = time.time()
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, float32
# outside them, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
SPIN_HZ = 1.98e9           # H100 SXM boost clock: torch.cuda._sleep cycles
# Main-path shapes (bench.py's workload, one sequence).
T, N, H_IMG, W_IMG, M_PTS = 16, 32, 384, 1248, 16384
CHUNK = 32
# Tolerances, kernel vs plain.  float32: the two sum the 512-term dots in
# different orders (relative error ~1e-6); 1e-4 of the output's scale.
# bfloat16: 8 significant bits; an f32 sum that lands near a rounding
# boundary rounds to the neighbouring value in one version and not the
# other, so the link may differ by a bf16 ulp (2^-7 relative) and a
# softmax over such links by a few ulps.  Each stage is held on its own:
# the link within 2 ulps at its largest magnitude, and the normalisation
# and heads, recomputed by the plain version from the kernel's own link,
# within 2 ulps (2^-6) of their scale.
TOL_F32 = 1e-4
TOL_BF16 = 2.0 ** -6


def stage(msg: str) -> None:
    print(f"[smoke] {msg} {time.time() - T0:.1f}s", file=sys.stderr,
          flush=True)


def nvidia_smi() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except FileNotFoundError:
        return "nvidia-smi: not found"
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 \
        else f"nvidia-smi: exit {proc.returncode}"


def cuda_ms(fn, reps: int):
    """``(device_ms, call_ms)``: two mean times per call of ``fn`` over
    ``reps`` back-to-back calls after one warm-up, each from CUDA events
    around the calls.

    - ``call_ms``: the calls alone.  Where the host's work per call
      (Python checks, allocations, ctypes) takes longer than its device
      work, the device waits for the host and that wait counts: this is
      what a caller gets per call in a loop.
    - ``device_ms``: the same calls behind a spin kernel that keeps the
      device busy while the host enqueues them, so the events bracket the
      calls' device work back to back and the host's work between calls
      does not count."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def timed():
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    call = timed()
    torch.cuda._sleep(int(min(2e-3 * reps * call * SPIN_HZ, 2.0 * SPIN_HZ)))
    return timed(), call


def max_err(x, y) -> float:
    return (x.float() - y.float()).abs().max().item()


def scale_of(y) -> float:
    return max(1.0, y.float().abs().max().item())


def affinity_inputs(dtype, gen, dev, B, D=512):
    """B frame pairs at the flagship shapes.  Counts are 3..16 per side;
    every second pair has a random (holed) subset of the slots valid, the
    others a prefix.  Pair 0 has an empty prev frame, pair 1 27 valid
    detections on both sides, pair 2 alternating slots (even prev, odd
    curr), pair 3 a single prev detection at the last slot."""
    a = torch.randn((B, 3, N, D), generator=gen, device=dev).to(dtype)
    b = torch.randn((B, 3, N, D), generator=gen, device=dev).to(dtype)
    counts = torch.randint(3, 17, (2, B, 1), generator=gen, device=dev)
    counts[0, 0] = 0
    ar = torch.arange(N, device=dev)
    rank = torch.rand((2, B, N), generator=gen, device=dev).argsort(-1) \
        .argsort(-1)
    holed = (torch.arange(B, device=dev) % 2 == 0)[None, :, None]
    masks = torch.where(holed, rank < counts, ar < counts)
    masks[:, 1] = ar < 27
    masks[0, 2], masks[1, 2] = ar % 2 == 0, ar % 2 == 1
    masks[0, 3] = ar == N - 1
    return a, b, masks[0].contiguous(), masks[1].contiguous()


def affinity_bound(mp, mc, params, dtype, bias=None):
    """(bound_ms, "bytes"|"operations"): the least time for the work these
    masks need (valid pairs and valid detections only) against the H100's
    peak for ``dtype``, or the bytes every input and output must move
    (the float32 ``bias`` [B, N, N] among them when given)."""
    K, D, H = params["w1"].shape
    hh = params["wn1"].shape[-1]
    np_, nc = mp.sum(1).double(), mc.sum(1).double()
    flops = float((2 * K * np_ * nc * (D * H + H)
                   + 2 * (np_ + nc) * (D * hh + hh)).sum())
    item = torch.empty((), dtype=dtype).element_size()
    B, N = mp.shape
    nbytes = (2 * B * K * N * D * item + 2 * B * N
              + sum(v.numel() * v.element_size() for v in params.values())
              + 2 * (B * N * N + B * N) * item
              + (0 if bias is None else bias.numel() * 4))
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def check_agreement(got, want, a, b, mp, mc, params, dtype, label):
    """Kernel vs plain within the stated tolerance; every masked link
    exactly 0.  ``label`` names the input in messages.  Returns the max
    |kernel - plain| per output."""
    errs = {k: max_err(x, y) for k, x, y in zip(got._fields, got, want)}
    if dtype == torch.float32:
        for k, x, y in zip(got._fields, got, want):
            if errs[k] > TOL_F32 * scale_of(y):
                raise AssertionError(
                    f"{label} float32 {k}: max |kernel - plain| {errs[k]} > "
                    f"{TOL_F32} x {scale_of(y)}")
    else:
        if errs["link"] > TOL_BF16 * scale_of(want.link):
            raise AssertionError(f"{label} bfloat16 link: {errs['link']} > "
                                 f"{TOL_BF16} x {scale_of(want.link)}")
        staged = heads_plain(got.link, a, b, mp, mc, params)
        for k in ("link_norm", "new", "end"):
            e = max_err(getattr(got, k), getattr(staged, k))
            if e > TOL_BF16 * scale_of(getattr(staged, k)):
                raise AssertionError(
                    f"{label} bfloat16 {k} from the kernel's link: {e} > "
                    f"{TOL_BF16} x {scale_of(getattr(staged, k))}")
    masked = ~(mp[:, :, None] & mc[:, None, :])
    if (got.link[masked] != 0).any():
        raise AssertionError(f"{label} {str(dtype)[6:]}: nonzero masked link")
    return errs


def entry_band_inputs(dtype, gen, dev, B=None, D=512):
    """B frame pairs shaped like the revival hybrid's entry band at
    N = 2 * 32 = 64 slots (``tracker/sequence.py::_revival_track``): the
    previous side is a state of 32 live slots and 32 ghost slots (a
    random subset of the 64 valid), the current side 32 real slots (a
    random subset valid) and 32 padded ones.  Pair 0 has an empty
    previous side, as every entry pair of a run's first window has."""
    B = B or ENTRY_B
    n = 2 * N
    a = torch.randn((B, 3, n, D), generator=gen, device=dev).to(dtype)
    b = torch.randn((B, 3, n, D), generator=gen, device=dev).to(dtype)
    mp = torch.rand((B, n), generator=gen, device=dev) < 0.6
    mc = torch.rand((B, n), generator=gen, device=dev) < 0.7
    mc[:, N:] = False
    mp[0] = False
    return a, b, mp.contiguous(), mc.contiguous()


def measure_kernel(a, b, mp, mc, params, dtype, label, bias=None):
    """Kernel vs plain on one input (with ``bias``, the kernel's bias
    instance, which must move the link), then kernel, per-launch, plain
    and library timings (device time, and time per call with the host's
    work; ``cuda_ms``) and the bound."""
    B = a.shape[0]
    with f32_parity(dtype == torch.float32):
        got = fused_affinity(a, b, mp, mc, params, bias)
        want = affinity_plain(a, b, mp, mc, params, bias)
        torch.cuda.synchronize()
        errs = check_agreement(got, want, a, b, mp, mc, params, dtype,
                               label)
        if bias is not None:
            moved = max_err(got.link, fused_affinity(a, b, mp, mc,
                                                     params).link)
            if moved <= 1e-2:
                raise AssertionError(f"{label}: the bias moves the link by "
                                     f"{moved} only")
            errs["bias_moves_link"] = moved
        # The plain version's broadcast matmul takes tens of GB at
        # B=512: time it before the kernel's scratch can split the
        # allocator's cached block.
        del want
        torch.cuda.empty_cache()
        plain_ms, plain_call_ms = cuda_ms(
            lambda: affinity_plain(a, b, mp, mc, params, bias), 3)
        torch.cuda.empty_cache()
        products, finish, _ = affinity_launches(a, b, mp, mc, params, bias)
        ms, call_ms = cuda_ms(
            lambda: fused_affinity(a, b, mp, mc, params, bias), 20)
        launch_ms = {"products": cuda_ms(products, 20)[0],
                     "finish": cuda_ms(finish, 20)[0]}
        # Library yardstick for the dominant product only: one batched
        # matmul [K, B*N*N, D] x [K, D, H] over all pairs (no fused
        # library call computes the whole function).
        K, D, H = params["w1"].shape
        pair = (a[:, :, :, None] - b[:, :, None]).abs()
        pair = pair.permute(1, 0, 2, 3, 4).reshape(K, -1, D).contiguous()
        lib_ms, lib_call_ms = cuda_ms(lambda: torch.bmm(pair, params["w1"]),
                                      5)
        del pair, got
    bound_ms, bound_by = affinity_bound(mp, mc, params, dtype, bias)
    per_pair = mp.sum(1) * mc.sum(1)
    pairs = int(per_pair.sum())
    # Launch 1's blocks with work, computed from the masks (the kernel
    # does not count them): one per 64 valid pairs and branch, and a
    # head block per side with detections.
    tiles = int(3 * ((per_pair + 63) // 64).sum()
                + mp.any(1).sum() + mc.any(1).sum())
    n = mp.shape[1]
    stage(f"kernel {str(dtype)[6:]} {label} ({pairs} valid pairs of "
          f"{B * n * n}; {tiles} blocks with work by the masks): "
          f"max err {errs} kernel {ms:.4f} ms (products "
          f"{launch_ms['products']:.4f}, finish "
          f"{launch_ms['finish']:.4f}; per call with the host "
          f"{call_ms:.4f}) plain {plain_ms:.4f} ms (with the host "
          f"{plain_call_ms:.4f}) bmm {lib_ms:.4f} ms (with the host "
          f"{lib_call_ms:.4f}) bound {bound_ms:.4f} ms ({bound_by})")
    torch.cuda.empty_cache()
    return dict(errs=errs, ms=ms, call_ms=call_ms, launch_ms=launch_ms,
                plain_ms=plain_ms, plain_call_ms=plain_call_ms,
                library_ms=lib_ms, library_call_ms=lib_call_ms,
                bound_ms=bound_ms, bound_by=bound_by, valid_pairs=pairs,
                frame_pairs=B, slots=n)


def check_kernel(net, dev):
    """Phase 3: kernel vs plain in float32 and bfloat16, at B=16 (the
    main path's window) and B=512 (one T=512 sequence of bench.py's
    workload) with N=32 slots, and at the revival entry band's shape
    (B=10 frame pairs at N=64)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        params = build_affinity_params(net, dtype)
        for B in (T, 512):
            report[dtype, B] = measure_kernel(
                *affinity_inputs(dtype, gen, dev, B), params, dtype,
                f"B={B}")
        report[dtype, "entry"] = measure_kernel(
            *entry_band_inputs(dtype, gen, dev), params, dtype,
            f"entry band B={ENTRY_B} N={2 * N}")
    return report


def compiled_code():
    """Registers, shared memory and spills of each kernel from the
    ptxas log of this process's build, and the tensor-core instructions
    (HMMA / HGMMA) in each kernel's SASS where cuobjdump is present."""
    log = kbuild.build_logs.get("affinity")
    ptxas = kbuild.ptxas_summary(log) if log else None
    for name, info in (ptxas or {}).items():
        stage(f"ptxas {name}: {info}")
    sass = kbuild.disassemble(kbuild.build("affinity"))
    if sass is None:
        stage("cuobjdump: absent from the toolkit; SASS not counted")
        return ptxas, None
    counts = kbuild.sass_counts(sass)
    for name, c in counts.items():
        stage(f"sass {name}: {c}")
    return ptxas, counts


def synthetic_frames(gen, dev, T_, H, W, M, N_, count_lo, count_hi):
    """Random uint8 frames, uniform clouds in front of the camera and
    random boxes, made on ``dev``: bench.py's distributions, with box
    sizes, margins and focal length scaled to an H x W frame."""
    sx, sy = W / W_IMG, H / H_IMG

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    images = torch.randint(0, 256, (T_, H, W, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    lo = torch.tensor([-25.0, -3.0, 2.0, 0.0], device=dev)
    hi = torch.tensor([25.0, 3.0, 70.0, 1.0], device=dev)
    clouds = u((T_, M, 4), 0.0, 1.0) * (hi - lo) + lo
    cx, cy = u((T_, N_), 100 * sx, W - 100 * sx), u((T_, N_), 100 * sy,
                                                      H - 80 * sy)
    bw, bh = u((T_, N_), 40 * sx, 160 * sx), u((T_, N_), 30 * sy, 90 * sy)
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                        -1)
    counts = torch.randint(count_lo, count_hi, (T_,), generator=gen,
                           device=dev)
    det_mask = torch.arange(N_, device=dev)[None] < counts[:, None]
    proj = torch.tensor([[720.0 * sx, 0, W / 2, 40.0 * sx],
                         [0, 720.0 * sy, H / 2, 1.0 * sy],
                         [0, 0, 1, 0.003]], device=dev)
    return images, clouds, boxes, det_mask, proj


def crop_window(boxes, det_mask, width: int) -> int:
    """Band width >= the widest valid box, in steps of 128, at least 256
    (mmmot_tpu/tracker/kitti_runner.py::_crop_window)."""
    widths = (boxes[..., 2] - boxes[..., 0])[det_mask]
    wmax = float(widths.max()) if widths.numel() else 0.0
    return int(min(max(256, -(-wmax // 128) * 128), width))


def check_ids(ids, det_mask) -> None:
    """ids: -1 exactly at empty slots; within a frame unique; each id is
    inherited from the previous frame or the next fresh one in slot
    order."""
    ids, dm = ids.cpu().numpy(), det_mask.cpu().numpy()
    if ids.shape != dm.shape:
        raise AssertionError(f"ids shape {ids.shape} != {dm.shape}")
    if not ((ids >= 0) == dm).all() or not (ids[~dm] == -1).all():
        raise AssertionError("ids are not -1 exactly on the empty slots")
    next_id, prev = 0, set()
    for t in range(len(ids)):
        row = ids[t][dm[t]]
        if len(set(row.tolist())) != len(row):
            raise AssertionError(f"frame {t}: repeated id")
        for i in row.tolist():
            if i in prev:
                continue
            if i != next_id:
                raise AssertionError(f"frame {t}: id {i}, expected an "
                                     f"inherited id or {next_id}")
            next_id += 1
        prev = set(row.tolist())


def reference_check(dev):
    """Phase 4: tiny_debug tracking, CPU plain versions vs GPU kernels."""
    cfg = tiny_debug()
    gen = torch.Generator().manual_seed(5)
    frames = synthetic_frames(gen, "cpu", 6, 96, 320, 512, 8, 2, 9)
    ids = {}
    for device in ("cpu", dev):
        net = init_random_(TrackingNet(cfg.model, device=device), 7)
        with torch.no_grad():           # favour links over new/end
            for head in (net.new_end.new_mlp, net.new_end.end_mlp):
                head.dense_1.bias.fill_(-3.0)
        mod = TrackingModule(net)
        before = fused_affinity.launches
        out = track_sequence_from_frames(
            mod, *(x.to(device) for x in frames), (32, 32),
            cfg.model.point.point_len, compact_capacity=48, extract_chunk=16,
            crop_window=128)
        launched = fused_affinity.launches - before
        if (device == "cpu") == (launched > 0):
            raise AssertionError(f"{device}: {launched} kernel launches")
        ids[device] = out["ids"].cpu()
        check_ids(out["ids"], frames[3].to(device))
    if not torch.equal(ids["cpu"], ids[dev]):
        raise AssertionError(f"tiny_debug ids differ between CPU and GPU:\n"
                             f"{ids['cpu']}\n{ids[dev]}")
    linked = len(ids["cpu"][ids["cpu"] >= 0].unique())
    stage(f"reference: tiny_debug ids equal on CPU and GPU "
          f"({linked} tracks over {int(frames[3].sum())} detections)")


@contextlib.contextmanager
def stage_timers(mod, stages=None):
    """While open, the tracking path's own stage functions run wrapped in
    timers that synchronise the device before and after each call:
    ``stages`` {name: (object, attribute)}, by default the flagship's
    (extraction, ``mod.affinity``, the association, the id propagation),
    and the fused kernel itself as "kernel".  Yields (times {stage: ms,
    summed over calls}, seen: "args" (a, b, mask_prev, mask_curr, params,
    link_bias) and "out" of the fused kernel's last call, "kernel_calls"
    [(args, out)] of every call, and "calls" {stage: [(ms, auction rounds
    run)] per call})."""
    import mmmot_tpu_torch.tracker.sequence as seq_mod
    import mmmot_tpu_torch.tracker.tracker as trk_mod

    times, seen = {}, {"calls": {}, "kernel_calls": []}

    def timer(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t, r0 = time.perf_counter(), auction_lap.rounds
            r = fn(*args, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            times[name] = times.get(name, 0.0) + ms
            seen["calls"].setdefault(name, []).append(
                (ms, auction_lap.rounds - r0))
            return r
        return run

    timed_kernel = timer("kernel", fused_affinity)

    def kernel(*args):
        seen["args"], seen["out"] = args, timed_kernel(*args)
        seen["kernel_calls"].append((args, seen["out"]))
        return seen["out"]

    stages = stages or {"extract": (seq_mod, "extract_frames_batched"),
                        "affinity": (mod, "affinity"),
                        "auction": (seq_mod, "associate"),
                        "ids": (seq_mod, "propagate_ids")}
    saved = {k: getattr(m, n) for k, (m, n) in stages.items()}
    own = {k: n in vars(m) for k, (m, n) in stages.items()}
    for k, (m, n) in stages.items():
        setattr(m, n, timer(k, saved[k]))
    trk_mod.fused_affinity = kernel
    try:
        yield times, seen
    finally:
        for k, (m, n) in stages.items():
            if own[k]:
                setattr(m, n, saved[k])
            else:
                delattr(m, n)           # a method: the class's again
        trk_mod.fused_affinity = fused_affinity


def main_path(net, dev, smi: str, profile: bool):
    """Phase 5: the flagship raw-frames path at full width."""
    cfg = full_mmmot()
    gen = torch.Generator(device=dev).manual_seed(42)
    images, clouds, boxes, det_mask, proj = synthetic_frames(
        gen, dev, T, H_IMG, W_IMG, M_PTS, N, 6, 19)
    n_valid = int(det_mask.sum())
    capacity = -(-n_valid // CHUNK) * CHUNK
    window = crop_window(boxes, det_mask, W_IMG)
    mod = TrackingModule(net)
    kw = dict(crop_size=cfg.model.appearance.crop_size,
              points_per_det=cfg.model.point.point_len, compact_capacity=capacity,
              extract_chunk=CHUNK, crop_window=window)
    args = (images, clouds, boxes, det_mask, proj)
    track_sequence_from_frames(mod, *args, **kw)          # warm-up
    torch.cuda.synchronize()
    stage(f"main path warm-up: {n_valid} detections, capacity {capacity}, "
          f"crop window {window}")

    fused_affinity.launches = auction_lap.rounds = 0
    t0 = time.perf_counter()
    out = track_sequence_from_frames(mod, *args, **kw)
    ids = out["ids"].cpu()
    warm_s = time.perf_counter() - t0
    launches, rounds = fused_affinity.launches, auction_lap.rounds
    if launches < 1:
        raise AssertionError("main path did not launch the fused kernel")
    if int(out["n_dropped"]) != 0:
        raise AssertionError(f"n_dropped = {int(out['n_dropped'])}")
    if not torch.isfinite(out["det_score"].float()).all():
        raise AssertionError("non-finite det scores")
    check_ids(ids, det_mask)
    stage(f"main path: {warm_s * 1e3:.1f} ms for {T} frames = "
          f"{T / warm_s:.1f} FPS on {smi}, {launches} fused-kernel "
          f"launch(es), {rounds} auction rounds, "
          f"{len(ids[ids >= 0].unique())} tracks")

    # Stage breakdown: the same call, synchronised between stages.
    with stage_timers(mod) as (times, _):
        track_sequence_from_frames(mod, *args, **kw)
    stage("main path stages (ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in times.items()))
    result = dict(launches=launches, warm_ms=warm_s * 1e3, fps=T / warm_s,
                  stages_ms=times, n_valid=n_valid, auction_rounds=rounds)
    if profile:
        result["profiled"] = profiled_pass(mod, args, kw)
    return result


def busy_ms(events) -> float:
    """Length of the union of the device intervals among ``events``."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    total, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total / 1e3


def profiled_pass(mod, args, kw):
    """One main-path pass under torch.profiler: its wall time on the host
    clock (profiler overhead included), the device's busy time (union of
    kernel and copy intervals) and the idle share, all from this pass."""
    from torch.profiler import ProfilerActivity, profile as prof

    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        t = time.perf_counter()
        track_sequence_from_frames(mod, *args, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    print(p.key_averages().table(sort_by="cuda_time_total", row_limit=25),
          file=sys.stderr)
    busy = busy_ms(p.events())
    if busy == 0.0:
        stage(f"profiled pass: {wall:.1f} ms wall; device time not measured "
              "(the profiler saw no CUDA events)")
        return dict(wall_ms=wall, device_busy_ms=None, idle_share=None)
    stage(f"profiled pass: {wall:.1f} ms wall, device busy {busy:.1f} ms, "
          f"idle share {1 - busy / wall:.3f}")
    return dict(wall_ms=wall, device_busy_ms=busy, idle_share=1 - busy / wall)


# Phase 6: the KITTI runner on a tree written by the port's own PNG
# writer.  Two sequences at KITTI's frame size; 6 cars through the whole
# sequence and 12 for 20-60 frames each (6-18 per frame).
RUNNER_SEQS = (("0000", 100), ("0001", 70))
KITTI_H, KITTI_W = 376, 1248
KITTI_F, KITTI_CX, KITTI_CY = 721.5377, 609.5593, 172.854
CLOUD_POINTS = 16384
AGREE_FRAMES, AGREE_WINDOW = 20, 8
RUNNER_WINDOW, RUNNER_S = 64, 2


def _car_tracks(rng, T):
    """(birth, death, lateral x0, vx, depth z0, vz, colour, texture) per
    car, in camera coordinates (metres)."""
    tracks = []
    for k in range(18):
        if k < 6:
            birth, death = 0, T
        else:
            span = int(rng.integers(20, 61))
            birth = int(rng.integers(0, max(1, T - span)))
            death = min(T, birth + span)
        tracks.append((birth, death, rng.uniform(-8, 8), rng.uniform(-0.05,
                                                                       0.05),
                       rng.uniform(8, 45), rng.uniform(-0.15, 0.15),
                       rng.integers(40, 220, 3),
                       rng.integers(-30, 31, (8, 8, 3))))
    return tracks


def write_kitti_tree(root: str, seed: int = 0):
    """KITTI tracking layout under ``root``: image_02 PNGs (the port's
    writer, rows cycling through all five filters), velodyne scans of
    16384 points with a cluster inside every car, label_02 (read as
    oracle detections), calib.  Returns the frame count."""
    import os

    from mmmot_tpu_torch.data.kitti_io import (KittiObject,
                                               write_kitti_result)
    from mmmot_tpu_torch.data.png import write_png

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:KITTI_H, :KITTI_W]
    dims = np.array([1.5, 1.6, 3.9])                     # h, w, l
    for seq, T in RUNNER_SEQS:
        for sub in (f"image_02/{seq}", f"velodyne/{seq}", "label_02",
                    "calib"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        with open(os.path.join(root, "calib", f"{seq}.txt"), "w") as fh:
            fh.write("P2: " + " ".join(map(str, (
                KITTI_F, 0, KITTI_CX, 0, 0, KITTI_F, KITTI_CY, 0, 0, 0, 1,
                0))) + "\n")
            fh.write("R_rect " + " ".join(map(str, np.eye(3).ravel()))
                     + "\n")
            fh.write("Tr_velo_cam 0 -1 0 0 0 0 -1 0 1 0 0 0\n")
        sky = np.stack([90 + xx // 16, 120 + yy // 8, 160 + 0 * xx], -1)
        tracks = _car_tracks(rng, T)
        objs = []
        for t in range(T):
            img = sky.copy()
            cars = []
            for tid, (b, d, x0, vx, z0, vz, col, tex) in enumerate(tracks):
                if not b <= t < d:
                    continue
                z = float(np.clip(z0 + vz * (t - b), 6.0, 60.0))
                x = float(np.clip(x0 + vx * (t - b), -0.6 * z * KITTI_CX
                                  / KITTI_F, 0.6 * z * KITTI_CX / KITTI_F))
                y = 1.65 - dims[0] / 2
                u, v = KITTI_F * x / z + KITTI_CX, KITTI_F * y / z + KITTI_CY
                hw, hh = KITTI_F * dims[2] / z / 2, KITTI_F * dims[0] / z / 2
                box = np.clip([u - hw, v - hh, u + hw, v + hh], 0,
                              [KITTI_W - 1, KITTI_H - 1] * 2)
                if min(box[2] - box[0], box[3] - box[1]) >= 4:
                    cars.append((z, tid, box, x, y, col, tex))
            for z, tid, box, x, y, col, tex in sorted(cars, reverse=True):
                l, tp, r, bt = box.astype(int)
                patch = np.tile(tex, (-(-(bt - tp) // 8), -(-(r - l) // 8),
                                      1))[:bt - tp, :r - l]
                img[tp:bt, l:r] = col + patch
                objs.append(KittiObject(
                    frame=t, track_id=tid, obj_type="Car",
                    bbox=np.asarray(box, float), dimensions=dims,
                    location=np.array([x, 1.65, z]), rotation_y=0.0))
            write_png(os.path.join(root, "image_02", seq, f"{t:06d}.png"),
                      np.clip(img, 0, 255).astype(np.uint8))
            # Velodyne frame: x forward, y left, z up (camera X right,
            # Y down, Z forward): velo = (Z, -X, -Y).
            pts = [np.stack([rng.uniform(2, 70, CLOUD_POINTS),
                             rng.uniform(-30, 30, CLOUD_POINTS),
                             rng.uniform(-2, 1, CLOUD_POINTS)], -1)]
            for z, tid, box, *_ in cars:
                n = 300
                uu = rng.uniform(box[0], box[2], n)
                vv = rng.uniform(box[1], box[3], n)
                zz = z + rng.uniform(-dims[2] / 2, dims[2] / 2, n)
                pts.append(np.stack([zz, -(uu - KITTI_CX) * zz / KITTI_F,
                                     -(vv - KITTI_CY) * zz / KITTI_F], -1))
            pts = np.concatenate(pts)
            order = rng.permutation(len(pts))[:CLOUD_POINTS]
            cloud = np.concatenate([pts[order], rng.uniform(
                0, 1, (len(order), 1))], -1).astype(np.float32)
            cloud.tofile(os.path.join(root, "velodyne", seq, f"{t:06d}.bin"))
        write_kitti_result(objs, os.path.join(root, "label_02",
                                              f"{seq}.txt"))
    return sum(T for _, T in RUNNER_SEQS)


def runner_agreement(root: str, dev, tmp: str):
    """tiny_debug float32 on the tree's first frames, window 8, two
    sequences per call, on the CPU (plain versions) and on the GPU
    (kernels): the result and summary files must be byte-equal."""
    import dataclasses
    import os

    cfg = tiny_debug()
    data = dataclasses.replace(cfg.data, root=root)
    files = {}
    for device in ("cpu", dev):
        net = init_random_(TrackingNet(cfg.model, device=device), 7)
        with torch.no_grad():           # favour links over new/end
            for head in (net.new_end.new_mlp, net.new_end.end_mlp):
                head.dense_1.bias.fill_(-3.0)
        before = fused_affinity.launches
        out = os.path.join(tmp, f"agree_{torch.device(device).type}")
        stats = track_kitti_sequences(
            TrackingModule(net), data, out, window=AGREE_WINDOW,
            batch_sequences=RUNNER_S, max_frames=AGREE_FRAMES)
        launched = fused_affinity.launches - before
        if (device == "cpu") == (launched > 0):
            raise AssertionError(f"agreement run on {device}: {launched} "
                                 "kernel launches")
        if stats["n_dropped"]:
            raise AssertionError(f"{device}: n_dropped {stats['n_dropped']}")
        files[device] = result_files(out)
    cpu, gpu = files["cpu"], files[dev]
    if sorted(cpu) != sorted(gpu) or len(cpu) < 4:
        raise AssertionError(f"result files differ: {sorted(cpu)} vs "
                             f"{sorted(gpu)}")
    for name in cpu:
        if cpu[name] != gpu[name]:
            raise AssertionError(f"{name}: GPU result differs from the CPU's")
    stage(f"runner agreement: tiny_debug f32, {AGREE_FRAMES} frames x "
          f"{RUNNER_S} sequences, window {AGREE_WINDOW}: {len(cpu)} files "
          "byte-equal on CPU and GPU")
    return {"frames": AGREE_FRAMES, "window": AGREE_WINDOW,
            "files": sorted(cpu), "byte_equal": True}


def runner_split(mod, data, dev, out_dir: str):
    """The runner itself over one window (the first 64 frames of each
    sequence: one group of two) under ``stage_timers``: load (the
    loader's PNG decode and cloud read of the group), extract, affinity,
    auction, ids and the whole window (ms).  The fused kernel's output on
    that window's own features and masks (B = S*64 frame pairs) is then
    held against its plain version at the bfloat16 tolerance."""
    auction_lap.rounds = 0
    with stage_timers(mod) as (times, seen):
        stats = track_kitti_sequences(
            mod, data, out_dir, window=RUNNER_WINDOW,
            batch_sequences=RUNNER_S, max_frames=RUNNER_WINDOW,
            evaluate=False)
    rounds = auction_lap.rounds
    if stats["n_windows"] != 1:
        raise AssertionError(f"split: {stats['n_windows']} windows")
    times["load"] = stats["load_s"] * 1e3
    times["window"] = stats["window_s"][0] * 1e3
    a, b, mp, mc, params, _ = seen["args"]
    B = RUNNER_S * RUNNER_WINDOW
    if a.shape[0] != B or a.dtype != torch.bfloat16:
        raise AssertionError(f"split: kernel got {tuple(a.shape)} "
                             f"{a.dtype}, expected B={B} bfloat16")
    with torch.inference_mode():
        want = affinity_plain(a, b, mp, mc, params)
        errs = check_agreement(seen["out"], want, a, b, mp, mc, params,
                               torch.bfloat16, f"runner window B={B}")
    stage(f"runner window vs plain: B={B} bfloat16, "
          f"{int((mp.sum(1) * mc.sum(1)).sum())} valid pairs of the "
          f"runner's features: max err {errs}")
    n_det = sum(int(o["det_mask"].sum()) for o in stats["outputs"].values())
    return times, n_det, rounds, errs


def runner_phase(net, dev, smi: str, root: str, tmp: str):
    """Phase 6: the agreement gate, then the flagship ``full_mmmot``
    runner at full width over the whole tree at ``root`` (window 64, two
    sequences per call: state carried across windows, the last window
    padded)."""
    import dataclasses

    agreement = runner_agreement(root, dev, tmp)

    data = dataclasses.replace(full_mmmot().data, root=root)
    mod = TrackingModule(net)
    fused_affinity.launches = 0
    stats = track_kitti_sequences(
        mod, data, f"{tmp}/full", window=RUNNER_WINDOW,
        batch_sequences=RUNNER_S)
    launches = fused_affinity.launches
    if launches != stats["n_windows"]:
        raise AssertionError(f"runner: {launches} fused-kernel launches "
                             f"for {stats['n_windows']} windows")
    if stats["n_dropped"] != 0:
        raise AssertionError(f"runner: n_dropped {stats['n_dropped']}")
    for seq, o in stats["outputs"].items():
        if not np.isfinite(o["det_score"]).all():
            raise AssertionError(f"{seq}: non-finite det scores")
        check_ids(torch.as_tensor(o["ids"]),
                  torch.as_tensor(o["det_mask"]))
    split, n_det, rounds, split_errs = runner_split(
        mod, data, dev, f"{tmp}/split")
    counted = stats["window_s"][1:]
    result = {
        "frames": stats["frames_loaded"], "windows": stats["n_windows"],
        "S": RUNNER_S, "window": RUNNER_WINDOW,
        "fps": stats["fps"], "frames_counted": stats["total_frames"],
        "window_ms": [1e3 * x for x in stats["window_s"]],
        "ms_per_window": 1e3 * sum(counted) / max(1, len(counted)),
        "split_ms": split, "split_detections": n_det,
        "split_auction_rounds": rounds,
        "split_kernel_vs_plain_max_err": split_errs,
        "load_s": stats["load_s"],
        "png_decode_ms_per_frame": 1e3 * stats["decode_s"]
        / max(1, stats["frames_loaded"]),
        "launches": launches,
        "mota_random_weights": stats["metrics"].mota,
        "hota_random_weights": stats["hota"].hota,
        "agreement": agreement, "gpu": smi}
    stage(f"runner: {result['frames']} frames, {result['windows']} windows "
          f"of {RUNNER_WINDOW} x S={RUNNER_S}, {stats['fps']:.1f} FPS after "
          f"the first window, windows {result['window_ms']} ms, split "
          f"{split} ms ({rounds} auction rounds), PNG decode "
          f"{result['png_decode_ms_per_frame']:.1f} ms/frame, MOTA {result['mota_random_weights']:.4f} HOTA "
          f"{result['hota_random_weights']:.4f} (random weights), "
          f"{launches} launches, on {smi}")
    return result


# Phase 7: the noisy-detector quality stack (full_mmmot_noisy's
# association: y_det rejection, revival window K=4, the IoU gate and
# prior, coverage for the first missed frame) on noisy detections.
QUALITY_K = 4
ENTRY_B = RUNNER_S * (QUALITY_K + 1)   # a window's entry band: S*(K+1)


def write_noisy_detections(root: str, seed: int = 1):
    """``detections/noisy/<seq>.txt`` beside the tree's labels: a
    detector simulated over them (the recipe of the JAX package's
    ``scripts/make_bench_tree.py``): boxes jittered by 2 % of their size,
    per-track dropout bursts of 1-4 frames (Poisson, 2 per track), 2 %
    i.i.d. misses, and false positives (Poisson, 1.2 per frame, 30 % of
    them half a box beside a car) scored N(0.45, 0.15) against the true
    detections' N(0.88, 0.06), so the two overlap.  Returns (detections,
    false positives)."""
    import os

    from mmmot_tpu_torch.data.kitti_io import (KittiObject,
                                               read_kitti_tracking_labels,
                                               write_kitti_result)

    rng = np.random.default_rng(seed)
    hi = np.array([KITTI_W - 1, KITTI_H - 1] * 2, float)
    n_dets = n_fp = 0
    for seq, T_seq in RUNNER_SEQS:
        gt = read_kitti_tracking_labels(os.path.join(root, "label_02",
                                                     f"{seq}.txt"))
        tracks = {}
        for t in sorted(gt):
            for o in gt[t]:
                tracks.setdefault(o.track_id, []).append(o)
        dets = []
        for tid in sorted(tracks):
            frames = [o.frame for o in tracks[tid]]
            drop = set()
            for _ in range(rng.poisson(2.0)):
                f0 = int(rng.choice(frames))
                drop.update(range(f0, f0 + int(rng.integers(1, 5))))
            for o in tracks[tid]:
                if o.frame in drop or rng.random() < 0.02:
                    continue
                l, tp, r, b = o.bbox
                w, h = r - l, b - tp
                j = rng.normal(0, 0.02, 4) * [w, h, w, h]
                box = np.clip(o.bbox + j, 0, hi)
                if min(box[2] - box[0], box[3] - box[1]) < 4:
                    continue
                jn = (abs(j[0]) + abs(j[2])) / w + (abs(j[1]) + abs(j[3])) / h
                dets.append(KittiObject(
                    frame=o.frame, track_id=0, obj_type="Car", bbox=box,
                    dimensions=o.dimensions, location=o.location,
                    rotation_y=o.rotation_y, score=float(np.clip(
                        rng.normal(0.88, 0.06) - 0.5 * jn, 0.05, 1.0))))
        for t in range(T_seq):
            cars = gt.get(t, [])
            for _ in range(rng.poisson(1.2)):
                w, h = rng.uniform(40, 160), rng.uniform(30, 80)
                if cars and rng.random() < 0.3:
                    a = cars[int(rng.integers(len(cars)))].bbox
                    cx = (a[0] + a[2]) / 2 + rng.choice([-1, 1]) * (
                        a[2] - a[0]) * 0.6
                    cy = (a[1] + a[3]) / 2 + rng.normal(0, (a[3] - a[1])
                                                        * 0.2)
                else:
                    cx, cy = rng.uniform(30, KITTI_W - 30), rng.uniform(
                        100, 300)
                box = np.clip([cx - w / 2, cy - h / 2, cx + w / 2,
                               cy + h / 2], 0, hi)
                if min(box[2] - box[0], box[3] - box[1]) < 8:
                    continue
                dets.append(KittiObject(
                    frame=t, track_id=0, obj_type="Car", bbox=box,
                    score=float(np.clip(rng.normal(0.45, 0.15), 0.05, 1.0))))
                n_fp += 1
        dets.sort(key=lambda o: o.frame)
        for i, o in enumerate(dets):
            o.track_id = i
        write_kitti_result(dets, os.path.join(root, "detections", "noisy",
                                              f"{seq}.txt"))
        n_dets += len(dets)
    return n_dets, n_fp


# A result row's score may differ by the port's float32 tolerance (that
# of tests/torch_port_fixtures.py) plus half a unit of its sixth printed
# decimal: a coverage row is scored by its track's last det-head
# confidence, float32 sums that cuBLAS and the CPU take in other orders.
SCORE_RTOL, SCORE_ATOL = 1e-4, 1e-5 + 5e-7


def results_match(a, b, what: str) -> int:
    """Result trees ``a`` and ``b`` ({name: bytes}) equal byte for byte,
    except that a row's last field (its score) may differ within
    ``SCORE_RTOL``/``SCORE_ATOL``.  Returns the rows that used the
    allowance."""
    if sorted(a) != sorted(b) or len(a) < 4:
        raise AssertionError(f"{what}: files {sorted(a)} vs {sorted(b)}")
    loose = 0
    for name in a:
        if a[name] == b[name]:
            continue
        la, lb = a[name].decode().splitlines(), b[name].decode().splitlines()
        if name.startswith(("summary", "hota")) or len(la) != len(lb):
            raise AssertionError(f"{what}: {name} differs")
        for x, y in zip(la, lb):
            if x == y:
                continue
            x, y = x.split(), y.split()
            if x[:-1] != y[:-1] or abs(float(x[-1]) - float(y[-1])) > (
                    SCORE_ATOL + SCORE_RTOL * abs(float(y[-1]))):
                raise AssertionError(f"{what}: {name}: {x} vs {y}")
            loose += 1
    return loose


def noisy_tiny_net(device, model=None):
    """tiny_debug (or ``model``) with seeded random weights, the new/end
    logits lowered and the det-head logits raised, so that links, births,
    LP rejections and ghosts all occur (the weights of
    ``tests/test_torch_quality.py``'s kind)."""
    net = init_random_(TrackingNet(model or tiny_debug().model,
                                   device=device), 7)
    with torch.no_grad():
        for head in (net.new_end.new_mlp, net.new_end.end_mlp):
            head.dense_1.bias.fill_(-1.0)
        net.det_head.dense_1.bias.fill_(1.0)
    return net


def quality_counts(outputs, K: int):
    """LP rejections (valid slots without an id), revived ids (an id absent
    from a frame after being present, then present again within K more
    frames) and coverage rows, over a runner's outputs."""
    rej = rev = cov = 0
    for o in outputs.values():
        ids, dm = o["ids"], o["det_mask"]
        rej += int(((ids < 0) & dm).sum())
        cov += int((o["ghost_ids"] >= 0).sum())
        seen = [set(r[r >= 0].tolist()) for r in ids]
        for t in range(1, len(seen) - 1):
            gone = seen[t - 1] - seen[t]
            rev += len(gone & set().union(*seen[t + 1:t + 1 + K]))
    return {"lp_rejections": rej, "revived_ids": rev, "coverage_rows": cov}


def check_quality_ids(ids, det_mask, K: int) -> None:
    """ids [T, N] of the quality stack: -1 at every empty slot (and at a
    detection the LP rejected); within a frame unique; a fresh id is the
    next one, in slot order; an id seen before comes back within K + 1
    frames of its last (revival)."""
    ids, dm = np.asarray(ids), np.asarray(det_mask)
    if ids.shape != dm.shape or (ids[~dm] != -1).any():
        raise AssertionError("ids are not -1 at every empty slot")
    next_id, last = 0, {}
    for t in range(len(ids)):
        row = ids[t][ids[t] >= 0].tolist()
        if len(set(row)) != len(row):
            raise AssertionError(f"frame {t}: repeated id")
        for i in row:
            if i in last:
                if t - last[i] > K + 1:
                    raise AssertionError(f"frame {t}: id {i} back after "
                                         f"{t - last[i]} frames")
            elif i != next_id:
                raise AssertionError(f"frame {t}: id {i}, expected an "
                                     f"earlier id or {next_id}")
            else:
                next_id += 1
            last[i] = t


def quality_agreement(root: str, dev, tmp: str, cfg=None, model=None):
    """tiny_debug widths (``model``: tiny widths of another affinity) with
    ``cfg``'s association (default full_mmmot_noisy's), float32, on the
    first frames of both sequences, window 8, two per call, on the CPU
    (plain versions) and on the GPU (kernels): the result files, coverage
    rows included, must match (``results_match``)."""
    import dataclasses

    cfg = cfg or full_mmmot_noisy()
    data = dataclasses.replace(tiny_debug().data, root=root,
                               det_source="noisy")
    files, counts = {}, None
    for device in ("cpu", dev):
        before = kernel_launches()
        out = f"{tmp}/{cfg.name}_agree_{torch.device(device).type}"
        stats = track_kitti_sequences(
            TrackingModule(noisy_tiny_net(device, model), cfg.assoc), data,
            out, window=AGREE_WINDOW, batch_sequences=RUNNER_S,
            max_frames=AGREE_FRAMES, score_sweep=(0.5,))
        launched = kernel_launches() - before
        if (device == "cpu") == (launched > 0):
            raise AssertionError(f"quality agreement on {device}: "
                                 f"{launched} kernel launches")
        if stats["n_dropped"]:
            raise AssertionError(f"{device}: n_dropped {stats['n_dropped']}")
        files[device] = result_files(out)
        counts = quality_counts(stats["outputs"], QUALITY_K)
    if counts["coverage_rows"] == 0:
        raise AssertionError("quality agreement: no coverage row to compare")
    loose = results_match(files["cpu"], files[dev], "quality agreement")
    stage(f"{cfg.name} agreement: tiny f32, {AGREE_FRAMES} frames x "
          f"{RUNNER_S} sequences, window {AGREE_WINDOW}: "
          f"{len(files['cpu'])} files equal on CPU and GPU ({loose} "
          f"coverage scores within the float32 tolerance); {counts}")
    return dict(frames=AGREE_FRAMES, window=AGREE_WINDOW,
                files=sorted(files["cpu"]), loose_score_rows=loose, **counts)


def result_files(d: str):
    """{relative path: bytes} of every file under ``d``."""
    import os

    out = {}
    for base, _, names in os.walk(d):
        for n in names:
            p = os.path.join(base, n)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


def kernel_launches() -> int:
    """Launches of the fused kernel so far, both instances."""
    return fused_affinity.launches + fused_affinity.bias_launches


def quality_strategy_gate(net, dev, inputs, cfg=None):
    """The revival hybrid against the sequential ``step_from_feats`` scan
    at full width in bf16 with ``cfg``'s association (default
    full_mmmot_noisy's), on each of ``inputs`` {name: (images, clouds,
    boxes, det_mask, proj, cloud_valid)}: ids and coverage outputs equal,
    2 kernel launches against one per frame."""
    cfg = cfg or full_mmmot_noisy()
    report = {}
    for what, (images, clouds, boxes, det_mask, proj, cv) in inputs.items():
        n_valid, T_in = int(det_mask.sum()), det_mask.shape[0]
        kw = dict(crop_size=net.cfg.appearance.crop_size,
                  points_per_det=net.cfg.point.point_len, cloud_valid=cv,
                  compact_capacity=-(-n_valid // CHUNK) * CHUNK,
                  extract_chunk=CHUNK,
                  crop_window=crop_window(boxes, det_mask, images.shape[2]))
        outs, launches = {}, {}
        for name, hybrid in (("revival", None), ("sequential", False)):
            before = kernel_launches()
            out = track_sequence_from_frames(
                TrackingModule(net, cfg.assoc, hybrid_presolve=hybrid),
                images, clouds, boxes, det_mask, proj, **kw)
            outs[name] = {k: v.cpu() for k, v in out.items()}
            launches[name] = kernel_launches() - before
        if launches != {"revival": 2, "sequential": T_in}:
            raise AssertionError(f"strategy gate {what}: launches "
                                 f"{launches}")
        got, want = outs["revival"], outs["sequential"]
        for k in ("ids", "ghost_ids", "ghost_boxes", "ghost_scores"):
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"strategy gate {what}: {k} differ")
        if max_err(got["det_score"], want["det_score"]) > 1e-6:
            raise AssertionError(f"strategy gate {what}: det_score differ")
        check_quality_ids(got["ids"], det_mask.cpu(), QUALITY_K)
        counts = quality_counts({"s": {
            "ids": got["ids"].numpy(), "ghost_ids": got["ghost_ids"].numpy(),
            "det_mask": det_mask.cpu().numpy()}}, QUALITY_K)
        report[what] = dict(frames=T_in, launches=launches, **counts)
        stage(f"{cfg.name} strategy gate ({what}): revival hybrid == "
              f"sequential scan on {T_in} frames at full width "
              f"({launches}); {counts}")
    return report


def quality_window_split(mod, data, out_dir: str):
    """One window of the noisy runner (the first 64 frames of both
    sequences) with its stages timed: extraction, band affinity (the
    fused kernel's two calls), scan (per frame: normalisation, gate,
    new/end heads and the auction; the auction alone as scan_auction)
    and ids (per frame: ids and the ghost pool).  The kernel's outputs on that window's own inputs (the bands,
    B = S*(K+1)*64 at N=32, and the entry band, B = S*(K+1) at N=64)
    are held against the plain version."""
    import mmmot_tpu_torch.tracker.sequence as seq_mod
    import mmmot_tpu_torch.tracker.tracker as trk_mod

    stages = {"extract": (seq_mod, "extract_frames_batched"),
              "band_affinity": (mod, "affinity_link"),
              "scan": (mod, "frame_decisions"),
              "scan_auction": (trk_mod, "associate"),
              "ids": (seq_mod, "advance_pool")}
    auction_lap.rounds = 0
    with stage_timers(mod, stages) as (times, seen):
        stats = track_kitti_sequences(
            mod, data, out_dir, window=RUNNER_WINDOW,
            batch_sequences=RUNNER_S, max_frames=RUNNER_WINDOW,
            evaluate=False)
    if stats["n_windows"] != 1 or len(seen["kernel_calls"]) != 2:
        raise AssertionError(f"split: {stats['n_windows']} windows, "
                             f"{len(seen['kernel_calls'])} kernel calls")
    times["window"] = stats["window_s"][0] * 1e3
    times["load"] = stats["load_s"] * 1e3
    rounds = sorted(r for _, r in seen["calls"]["scan"])
    errs = {}
    with torch.inference_mode():
        for what, (args, out) in zip(("bands", "entry"),
                                     seen["kernel_calls"]):
            a, b, mp, mc, params, _ = args
            want = affinity_plain(a, b, mp, mc, params)
            errs[what] = check_agreement(
                out, want, a, b, mp, mc, params, torch.bfloat16,
                f"noisy window {what} B={a.shape[0]} N={a.shape[2]}")
            errs[what]["frame_pairs"], errs[what]["slots"] = a.shape[0], \
                a.shape[2]
            del want
    torch.cuda.empty_cache()
    return times, rounds, errs


def calibrate_heads(net, data, dev, frames: int = 16):
    """Set the output biases of the det head and the new/end heads of the
    seeded random ``net`` from the data, so that the y_det LP sees what a
    trained net gives it: det-head logits with median +1 and raw new/end
    logits with median -0.5 over the first ``frames`` frames of sequence
    0000.  Most unlinked detections then start tracks (det + new >= 0),
    links beat both arms, and the lower tail is rejected.  Random heads
    give logits of one sign for every detection (at seed 0 the LP
    rejects them all).  Returns ({the medians before, the shifts}, that
    sequence's first frames as the tracker's inputs)."""
    from mmmot_tpu_torch.data.kitti_dataset import KittiTrackingDataset
    from mmmot_tpu_torch.tracker.sequence import extract_frames_batched

    a = KittiTrackingDataset(data, max_cloud_points=32768).load_sequence(
        "0000", max_frames=frames)
    window = tuple(torch.as_tensor(x, device=dev) for x in (
        a.images, a.clouds, a.boxes, a.det_mask, a.proj, a.cloud_valid))
    images, clouds, boxes, dm, _, cv = (x[None] for x in window)
    mod = TrackingModule(net)
    n_valid = int(dm.sum())
    feats, kept = extract_frames_batched(
        mod, images, clouds, boxes, dm, torch.as_tensor(a.proj, device=dev),
        net.cfg.appearance.crop_size, net.cfg.point.point_len,
        -(-n_valid // CHUNK) * CHUNK, CHUNK,
        crop_window(boxes, dm, KITTI_W), cv)
    feats, kept = {k: v[0] for k, v in feats.items()}, kept[0]
    aff = mod.affinity({k: v[:-1] for k, v in feats.items()},
                       {k: v[1:] for k, v in feats.items()}, kept[:-1],
                       kept[1:])
    med = {"det": mod.det_score(feats["fused"], kept)[kept],
           "new": aff.new[kept[1:]], "end": aff.end[kept[:-1]]}
    med = {k: float(v.float().median()) for k, v in med.items()}
    shift = {"det": 1.0 - med["det"], "new": -0.5 - med["new"],
             "end": -0.5 - med["end"]}
    with torch.no_grad():
        net.det_head.dense_1.bias += shift["det"]
        net.new_end.new_mlp.dense_1.bias += shift["new"]
        net.new_end.end_mlp.dense_1.bias += shift["end"]
    stage(f"quality heads: medians {med} shifted by {shift}")
    return {"median_logits": med, "bias_shift": shift}, window


def quality_phase(net, dev, smi: str, root: str, tmp: str):
    """Phase 7: the agreement gate; then, with the heads' output biases
    set from the data (``calibrate_heads``; this is the last phase to use
    ``net``), the strategy gate and ``full_mmmot_noisy`` through the
    runner at full width over the whole tree (window 64, two sequences
    per call: the ghost pool carried across the window boundary), then
    one window with its stages timed."""
    import dataclasses

    agreement = quality_agreement(root, dev, tmp)
    cfg = full_mmmot_noisy()
    data = dataclasses.replace(cfg.data, root=root)
    heads, tree_frames = calibrate_heads(net, data, dev)
    gen = torch.Generator(device=dev).manual_seed(42)
    gate = quality_strategy_gate(net, dev, {
        "main_path_frames": synthetic_frames(gen, dev, T, H_IMG, W_IMG,
                                             M_PTS, N, 6, 19) + (None,),
        "tree_frames": tree_frames})
    mod = TrackingModule(net, cfg.assoc)
    fused_affinity.launches = auction_lap.rounds = 0
    stats = track_kitti_sequences(
        mod, data, f"{tmp}/noisy", window=RUNNER_WINDOW,
        batch_sequences=RUNNER_S)
    launches, rounds = fused_affinity.launches, auction_lap.rounds
    if launches != 2 * stats["n_windows"] or stats["n_windows"] < 2:
        raise AssertionError(f"quality runner: {launches} fused-kernel "
                             f"launches for {stats['n_windows']} windows")
    if stats["n_dropped"] != 0:
        raise AssertionError(f"quality runner: n_dropped "
                             f"{stats['n_dropped']}")
    for seq, o in stats["outputs"].items():
        for k in ("det_score", "ghost_scores", "ghost_boxes"):
            if not np.isfinite(o[k]).all():
                raise AssertionError(f"{seq}: non-finite {k}")
        check_quality_ids(o["ids"], o["det_mask"], QUALITY_K)
    counts = quality_counts(stats["outputs"], QUALITY_K)
    split, frame_rounds, split_errs = quality_window_split(
        mod, data, f"{tmp}/noisy_split")
    counted = stats["window_s"][1:]
    result = {
        "config": cfg.name, "frames": stats["frames_loaded"],
        "windows": stats["n_windows"], "S": RUNNER_S,
        "window": RUNNER_WINDOW, "fps": stats["fps"],
        "frames_counted": stats["total_frames"],
        "window_ms": [1e3 * x for x in stats["window_s"]],
        "ms_per_window": 1e3 * sum(counted) / max(1, len(counted)),
        "auction_rounds": rounds,
        "split_ms": split,
        "split_rounds_per_frame": {
            "min": frame_rounds[0], "median": frame_rounds[len(
                frame_rounds) // 2], "max": frame_rounds[-1],
            "frames": len(frame_rounds), "total": sum(frame_rounds)},
        "split_ms_per_round": split["scan_auction"] / max(
            1, sum(frame_rounds)),
        "split_kernel_vs_plain_max_err": split_errs,
        "launches": launches, **counts,
        "mota_random_weights": stats["metrics"].mota,
        "hota_random_weights": stats["hota"].hota,
        "agreement": agreement, "strategy_gate": gate, "heads": heads,
        "gpu": smi}
    stage(f"quality runner: {result['frames']} frames, {result['windows']} "
          f"windows of {RUNNER_WINDOW} x S={RUNNER_S}, {stats['fps']:.2f} "
          f"FPS after the first window, windows {result['window_ms']} ms, "
          f"{rounds} auction rounds, split {split} ms, rounds per frame "
          f"{result['split_rounds_per_frame']}, {counts}, {launches} "
          f"launches, MOTA {result['mota_random_weights']:.4f} HOTA "
          f"{result['hota_random_weights']:.4f} (random weights), on {smi}")
    return result


# Phase 8: the look-alike stack (full_mmmot_lookalike: two GNN rounds and
# the learned motion term, which enters the kernel as its link_bias, on
# the noisy stack with coverage uncapped) on the same tree.  GNN rounds
# rule out the pre-solves: each frame runs the rounds, the motion MLP and
# one bias-instance launch over its S frame pairs at 2N = 64 slots.


def lookalike_tiny_model():
    """tiny_debug widths with the look-alike affinity (two GNN rounds,
    motion_dim 8)."""
    import dataclasses

    m = tiny_debug().model
    return dataclasses.replace(m, affinity=dataclasses.replace(
        m.affinity, gnn_rounds=2, motion_dim=8))


def check_bias_kernel(net, dev):
    """The kernel's bias instance against its plain version in float32
    and bfloat16 with phase 3's tolerances, at the flagship's B=16 N=32
    and at the look-alike scan's B=S=2 N=64 (a state of 2N slots against
    N real and N padded current slots; pair 0's state empty, as in a
    run's first window), with a N(0, 2) float32 bias that must move the
    link; masked links exactly 0."""
    gen = torch.Generator(device=dev).manual_seed(8)
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        params = build_affinity_params(net, dtype)
        for what, inputs in (
                ("b16", affinity_inputs(dtype, gen, dev, T)),
                ("scan", entry_band_inputs(dtype, gen, dev, RUNNER_S))):
            B, n = inputs[0].shape[0], inputs[0].shape[2]
            bias = 2.0 * torch.randn((B, n, n), generator=gen, device=dev)
            report[dtype, what] = measure_kernel(
                *inputs, params, dtype, f"link_bias B={B} N={n}", bias)
    return report


def lookalike_window_split(mod, data, out_dir: str):
    """One window of the look-alike runner (the first 64 frames of both
    sequences) with its stages timed: extraction, per frame the GNN
    rounds, the motion term, the fused kernel (bias instance), the scan
    (normalisation, gates, new/end heads and the auction; the auction
    alone as scan_auction), the ghost pool (ids) and the whole frame
    step.  Three of the window's 64 kernel calls (B=2 frame pairs at
    N=64) are held against the plain version on their own inputs."""
    import mmmot_tpu_torch.tracker.sequence as seq_mod
    import mmmot_tpu_torch.tracker.tracker as trk_mod

    stages = {"extract": (seq_mod, "extract_frames_batched"),
              "gnn": (mod.net, "gnn_refine"),
              "motion": (mod.net, "motion_bias"),
              "scan": (mod, "frame_decisions"),
              "scan_auction": (trk_mod, "associate"),
              "ids": (mod, "_revival_state"),
              "step": (mod, "step_from_feats")}
    auction_lap.rounds = 0
    with stage_timers(mod, stages) as (times, seen):
        stats = track_kitti_sequences(
            mod, data, out_dir, window=RUNNER_WINDOW,
            batch_sequences=RUNNER_S, max_frames=RUNNER_WINDOW,
            evaluate=False)
    calls = seen["kernel_calls"]
    if stats["n_windows"] != 1 or len(calls) != RUNNER_WINDOW:
        raise AssertionError(f"lookalike split: {stats['n_windows']} "
                             f"windows, {len(calls)} kernel calls")
    times["window"] = stats["window_s"][0] * 1e3
    times["load"] = stats["load_s"] * 1e3
    rounds = sorted(r for _, r in seen["calls"]["scan"])
    errs = {}
    with torch.inference_mode():
        for i in (0, RUNNER_WINDOW // 2, RUNNER_WINDOW - 1):
            (a, b, mp, mc, params, bias), out = calls[i]
            if bias is None or a.shape[:3] != (RUNNER_S, 3, 2 * N):
                raise AssertionError(
                    f"lookalike split: kernel call {i} got "
                    f"{tuple(a.shape)}, bias {bias is not None}")
            errs[f"frame_{i}"] = check_agreement(
                out, affinity_plain(a, b, mp, mc, params, bias), a, b, mp,
                mc, params, torch.bfloat16, f"lookalike frame {i}")
    torch.cuda.empty_cache()
    return times, rounds, errs


def lookalike_phase(dev, smi: str, root: str, tmp: str):
    """Phase 8: the tiny agreement gate; ``full_mmmot_lookalike`` at full
    width (seeded random weights, heads calibrated on the tree as in
    phase 7): the bias instance against its plain version; the
    motion-only model's revival hybrid against its sequential scan; the
    runner over the whole tree (window 64, two sequences per call: 64
    bias-instance launches per window, no other); one window with its
    stages timed.  Returns (result, the kernel report)."""
    import dataclasses

    cfg = full_mmmot_lookalike()
    agreement = quality_agreement(root, dev, tmp, cfg, lookalike_tiny_model())
    net = init_random_(TrackingNet(cfg.model, device=dev), 0)
    kern = check_bias_kernel(net, dev)
    data = dataclasses.replace(cfg.data, root=root)
    heads, tree_frames = calibrate_heads(net, data, dev)
    # The same weights without the GNN rounds: motion alone keeps the
    # revival pre-solve sound.
    motion_only = TrackingNet(dataclasses.replace(
        cfg.model, affinity=dataclasses.replace(cfg.model.affinity,
                                                gnn_rounds=0)), device=dev)
    motion_only.load_state_dict({k: v for k, v in net.state_dict().items()
                                 if ".gnn_" not in k})
    gate = quality_strategy_gate(motion_only, dev,
                                 {"tree_frames": tree_frames}, cfg)
    del motion_only
    mod = TrackingModule(net, cfg.assoc)
    if mod.hybrid_presolve or mod.parallel_assoc:
        raise AssertionError("lookalike: not the sequential scan")
    fused_affinity.launches = fused_affinity.bias_launches = 0
    auction_lap.rounds = 0
    stats = track_kitti_sequences(
        mod, data, f"{tmp}/lookalike", window=RUNNER_WINDOW,
        batch_sequences=RUNNER_S)
    launches = {"link_bias": fused_affinity.bias_launches,
                "no_bias": fused_affinity.launches}
    rounds = auction_lap.rounds
    if (launches != {"link_bias": RUNNER_WINDOW * stats["n_windows"],
                     "no_bias": 0} or stats["n_windows"] < 2):
        raise AssertionError(f"lookalike runner: launches {launches} for "
                             f"{stats['n_windows']} windows")
    if stats["n_dropped"] != 0:
        raise AssertionError(f"lookalike runner: n_dropped "
                             f"{stats['n_dropped']}")
    for seq, o in stats["outputs"].items():
        for k in ("det_score", "ghost_scores", "ghost_boxes"):
            if not np.isfinite(o[k]).all():
                raise AssertionError(f"{seq}: non-finite {k}")
        check_quality_ids(o["ids"], o["det_mask"], QUALITY_K)
    counts = quality_counts(stats["outputs"], QUALITY_K)
    split, frame_rounds, split_errs = lookalike_window_split(
        mod, data, f"{tmp}/lookalike_split")
    counted = stats["window_s"][1:]
    result = {
        "config": cfg.name, "frames": stats["frames_loaded"],
        "windows": stats["n_windows"], "S": RUNNER_S,
        "window": RUNNER_WINDOW, "fps": stats["fps"],
        "frames_counted": stats["total_frames"],
        "window_ms": [1e3 * x for x in stats["window_s"]],
        "ms_per_window": 1e3 * sum(counted) / max(1, len(counted)),
        "auction_rounds": rounds, "launches": launches,
        "launches_per_window": launches["link_bias"] / stats["n_windows"],
        "split_ms": split,
        "split_rounds_per_frame": {
            "min": frame_rounds[0], "median": frame_rounds[len(
                frame_rounds) // 2], "max": frame_rounds[-1],
            "frames": len(frame_rounds), "total": sum(frame_rounds)},
        "split_ms_per_round": split["scan_auction"] / max(
            1, sum(frame_rounds)),
        "split_kernel_vs_plain_max_err": split_errs, **counts,
        "mota_random_weights": stats["metrics"].mota,
        "hota_random_weights": stats["hota"].hota,
        "agreement": agreement, "motion_strategy_gate": gate,
        "heads": heads, "gpu": smi}
    stage(f"lookalike runner: {result['frames']} frames, "
          f"{result['windows']} windows of {RUNNER_WINDOW} x S={RUNNER_S}, "
          f"{stats['fps']:.2f} FPS after the first window, windows "
          f"{result['window_ms']} ms, {rounds} auction rounds, launches "
          f"{launches}, split {split} ms, rounds per frame "
          f"{result['split_rounds_per_frame']}, {counts}, MOTA "
          f"{result['mota_random_weights']:.4f} HOTA "
          f"{result['hota_random_weights']:.4f} (random weights), on {smi}")
    return result, kern


def check_fma(dev):
    """The GPU's ``fma`` (``torch.addcmul``) rounds once, as the CPU's
    float64 form does and as the reference's compiled multiply-adds do."""
    gen = torch.Generator(device=dev).manual_seed(3)
    a, b, c = (torch.randn(1 << 20, generator=gen, device=dev) * 100
               for _ in range(3))
    got = fma(a, b, c)
    want = (a.double() * b.double() + c.double()).float()
    if not torch.equal(got, want):
        raise AssertionError(f"fma on {dev}: {(got != want).sum().item()} of "
                             f"{a.numel()} differ from the float64 form")
    stage("fma: torch.addcmul equals the float64 form on 2^20 values")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    profile = "--profile" in argv
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}", flush=True)
    stage(f"environment: {kind}; {smi}")

    t = time.time()
    kbuild.build("affinity")
    stage(f"build {time.time() - t:.1f}s")
    print(kbuild.build_logs.get("affinity", "(library reused)"),
          file=sys.stderr)

    ptxas, sass = compiled_code()

    net = init_random_(TrackingNet(full_mmmot().model, device=dev), 0)
    kern = check_kernel(net, dev)
    check_fma(dev)
    reference_check(dev)
    run = main_path(net, dev, smi, profile)
    with tempfile.TemporaryDirectory() as tmp:
        root = f"{tmp}/kitti"
        t = time.perf_counter()
        n_frames = write_kitti_tree(root)
        n_dets, n_fp = write_noisy_detections(root)
        stage(f"runner tree: {n_frames} frames of {KITTI_H}x{KITTI_W} and "
              f"{n_dets} noisy detections ({n_fp} false positives) written "
              f"in {time.perf_counter() - t:.1f} s")
        runner = runner_phase(net, dev, smi, root, tmp)
        quality = quality_phase(net, dev, smi, root, tmp)
        del net
        torch.cuda.empty_cache()
        lookalike, kern_bias = lookalike_phase(dev, smi, root, tmp)

    def at(dtype, B):
        r = kern[dtype, B]
        return {k: r[k] for k in ("ms", "call_ms", "launch_ms", "plain_ms",
                                  "plain_call_ms", "library_ms",
                                  "library_call_ms", "bound_ms", "bound_by",
                                  "valid_pairs", "errs", "frame_pairs",
                                  "slots")}

    def worst(errs):
        return max(errs[k] for k in ("link", "link_norm", "new", "end"))

    bf = kern[torch.bfloat16, T]
    entry = {
        "name": "fused_affinity", "route": "cuda",
        "source": "mmmot_tpu_torch/csrc/affinity.cu",
        "replaces": "mmmot_tpu/kernels/affinity_kernel.py:206",
        "launches": run["launches"],
        "launches_by_path": {"main_path": run["launches"],
                             "runner": runner["launches"],
                             "quality_runner": quality["launches"],
                             "lookalike_runner": lookalike["launches"][
                                 "no_bias"]},
        "max_abs_err": worst(bf["errs"]),
        "ms": bf["ms"], "plain_ms": bf["plain_ms"],
        "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
        "library_ms": bf["library_ms"],
        "library_call": "torch.bmm [K, B*N*N, D] x [K, D, H] (the W1 "
                        "product alone, over all pairs)",
        "dtype": "bfloat16", "frame_pairs": T,
        "call_ms": bf["call_ms"], "plain_call_ms": bf["plain_call_ms"],
        "library_call_ms": bf["library_call_ms"],
        "launch_ms": bf["launch_ms"], "valid_pairs": bf["valid_pairs"],
        "b512": at(torch.bfloat16, 512),
        "entry_band": at(torch.bfloat16, "entry"),
        "float32": {"b16": at(torch.float32, T),
                    "b512": at(torch.float32, 512),
                    "entry_band": at(torch.float32, "entry")},
        "ptxas": ptxas, "sass_tensor_core": sass,
    }
    bsc = kern_bias[torch.bfloat16, "scan"]

    def bias_at(dtype, what):
        r = kern_bias[dtype, what]
        return {k: r[k] for k in ("ms", "call_ms", "launch_ms", "plain_ms",
                                  "library_ms", "bound_ms", "bound_by",
                                  "valid_pairs", "errs", "frame_pairs",
                                  "slots")}

    entry_bias = {
        "name": "fused_affinity[link_bias]", "route": "cuda",
        "source": "mmmot_tpu_torch/csrc/affinity.cu",
        "replaces": "mmmot_tpu/kernels/affinity_kernel.py:206",
        "instance": "link_bias (affinity_kernel.py:209; finish_kernel<T, "
                    "true>)",
        "launches": lookalike["launches"]["link_bias"],
        "max_abs_err": worst(bsc["errs"]),
        "ms": bsc["ms"], "plain_ms": bsc["plain_ms"],
        "bound_ms": bsc["bound_ms"], "bound_by": bsc["bound_by"],
        "library_ms": bsc["library_ms"],
        "library_call": "torch.bmm [K, B*N*N, D] x [K, D, H] (the W1 "
                        "product alone, over all pairs)",
        "dtype": "bfloat16", "frame_pairs": bsc["frame_pairs"],
        "slots": bsc["slots"], "call_ms": bsc["call_ms"],
        "launch_ms": bsc["launch_ms"], "valid_pairs": bsc["valid_pairs"],
        "b16": bias_at(torch.bfloat16, "b16"),
        "float32": {"scan": bias_at(torch.float32, "scan"),
                    "b16": bias_at(torch.float32, "b16")},
    }
    print(json.dumps({"main_path": {
        "frames": T, "detections": run["n_valid"], "warm_ms": run["warm_ms"],
        "auction_rounds": run["auction_rounds"],
        "fps": run["fps"], "stages_ms": run["stages_ms"],
        "profiled": run.get("profiled"), "gpu": smi}}))
    print(json.dumps({"runner": runner}))
    print(json.dumps({"quality": quality}))
    print(json.dumps({"lookalike": lookalike}))
    print(json.dumps({"kernels": [entry, entry_bias]}))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
