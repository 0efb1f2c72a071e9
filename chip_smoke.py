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
   empty frame and a frame of 27 detections among them; every masked link
   must be exactly 0; kernel, per-launch, plain and library timings,
   each as device time and as time per call with the host's work;
4. reference: the ``tiny_debug`` model tracks a small sequence on the CPU
   (plain versions) and on the GPU (kernels) in float32 with the same
   seeded weights; the track ids must be equal;
5. main path: the flagship ``full_mmmot`` at full width, seeded random
   weights, one sequence of T=16 raw 384x1248 frames with 16384-point
   clouds and N=32 slots (about 12 valid per frame), compact-first with
   chunk 32 and the auction; ids are checked and the fused kernel's launch
   count must rise during the run.

The last stdout line is ``{"ok": true, "device": {...}}``, printed only
when every phase passed; the line before it is a JSON object with one
entry per kernel.  Any failure raises and exits nonzero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from mmmot_tpu_torch.assoc.solve import associate
from mmmot_tpu_torch.config import full_mmmot, tiny_debug
from mmmot_tpu_torch.device import f32_parity
from mmmot_tpu_torch.kernels import build as kbuild
from mmmot_tpu_torch.kernels.affinity import (affinity_launches,
                                              affinity_plain,
                                              build_affinity_params,
                                              fused_affinity, heads_plain)
from mmmot_tpu_torch.models.tracking_net import TrackingNet, init_random_
from mmmot_tpu_torch.tracker.sequence import (extract_frames, pair_inputs,
                                              propagate_ids,
                                              track_sequence_from_frames)
from mmmot_tpu_torch.tracker.tracker import TrackingModule, init_state

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


def affinity_bound(mp, mc, params, dtype):
    """(bound_ms, "bytes"|"operations"): the least time for the work these
    masks need (valid pairs and valid detections only) against the H100's
    peak for ``dtype``, or the bytes every input and output must move."""
    K, D, H = params["w1"].shape
    hh = params["wn1"].shape[-1]
    np_, nc = mp.sum(1).double(), mc.sum(1).double()
    flops = float((2 * K * np_ * nc * (D * H + H)
                   + 2 * (np_ + nc) * (D * hh + hh)).sum())
    item = torch.empty((), dtype=dtype).element_size()
    B = mp.shape[0]
    nbytes = (2 * B * K * N * D * item + 2 * B * N
              + sum(v.numel() * v.element_size() for v in params.values())
              + 2 * (B * N * N + B * N) * item)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def check_agreement(got, want, a, b, mp, mc, params, dtype, B):
    """Kernel vs plain within the stated tolerance; every masked link
    exactly 0.  Returns the max |kernel - plain| per output."""
    errs = {k: max_err(x, y) for k, x, y in zip(got._fields, got, want)}
    if dtype == torch.float32:
        for k, x, y in zip(got._fields, got, want):
            if errs[k] > TOL_F32 * scale_of(y):
                raise AssertionError(
                    f"B={B} float32 {k}: max |kernel - plain| {errs[k]} > "
                    f"{TOL_F32} x {scale_of(y)}")
    else:
        if errs["link"] > TOL_BF16 * scale_of(want.link):
            raise AssertionError(f"B={B} bfloat16 link: {errs['link']} > "
                                 f"{TOL_BF16} x {scale_of(want.link)}")
        staged = heads_plain(got.link, a, b, mp, mc, params)
        for k in ("link_norm", "new", "end"):
            e = max_err(getattr(got, k), getattr(staged, k))
            if e > TOL_BF16 * scale_of(getattr(staged, k)):
                raise AssertionError(
                    f"B={B} bfloat16 {k} from the kernel's link: {e} > "
                    f"{TOL_BF16} x {scale_of(getattr(staged, k))}")
    masked = ~(mp[:, :, None] & mc[:, None, :])
    if (got.link[masked] != 0).any():
        raise AssertionError(f"B={B} {str(dtype)[6:]}: nonzero masked link")
    return errs


def check_kernel(net, dev):
    """Phase 3: kernel vs plain in float32 and bfloat16, at B=16 (the
    main path's window) and B=512 (one T=512 sequence of bench.py's
    workload); kernel, per-launch, plain and library timings (device
    time, and time per call with the host's work; ``cuda_ms``)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        params = build_affinity_params(net, dtype)
        for B in (T, 512):
            a, b, mp, mc = affinity_inputs(dtype, gen, dev, B)
            with f32_parity(dtype == torch.float32):
                got = fused_affinity(a, b, mp, mc, params)
                want = affinity_plain(a, b, mp, mc, params)
                torch.cuda.synchronize()
                errs = check_agreement(got, want, a, b, mp, mc, params,
                                       dtype, B)
                # The plain version's broadcast matmul takes tens of GB at
                # B=512: time it before the kernel's scratch can split the
                # allocator's cached block.
                del want
                torch.cuda.empty_cache()
                plain_ms, plain_call_ms = cuda_ms(
                    lambda: affinity_plain(a, b, mp, mc, params), 3)
                torch.cuda.empty_cache()
                products, finish, _ = affinity_launches(a, b, mp, mc,
                                                        params)
                ms, call_ms = cuda_ms(
                    lambda: fused_affinity(a, b, mp, mc, params), 20)
                launch_ms = {"products": cuda_ms(products, 20)[0],
                             "finish": cuda_ms(finish, 20)[0]}
                # Library yardstick for the dominant product only: one
                # batched matmul [K, B*N*N, D] x [K, D, H] over all pairs
                # (no fused library call computes the whole function).
                K, D, H = params["w1"].shape
                pair = (a[:, :, :, None] - b[:, :, None]).abs()
                pair = pair.permute(1, 0, 2, 3, 4).reshape(K, -1, D) \
                    .contiguous()
                lib_ms, lib_call_ms = cuda_ms(
                    lambda: torch.bmm(pair, params["w1"]), 5)
                del pair
            bound_ms, bound_by = affinity_bound(mp, mc, params, dtype)
            per_pair = mp.sum(1) * mc.sum(1)
            pairs = int(per_pair.sum())
            # Launch 1's blocks with work, computed from the masks (the
            # kernel does not count them): one per 64 valid pairs and
            # branch, and a head block per side with detections.
            tiles = int(3 * ((per_pair + 63) // 64).sum()
                        + mp.any(1).sum() + mc.any(1).sum())
            report[dtype, B] = dict(
                errs=errs, ms=ms, call_ms=call_ms, launch_ms=launch_ms,
                plain_ms=plain_ms, plain_call_ms=plain_call_ms,
                library_ms=lib_ms, library_call_ms=lib_call_ms,
                bound_ms=bound_ms, bound_by=bound_by, valid_pairs=pairs)
            stage(f"kernel {str(dtype)[6:]} B={B} ({pairs} valid pairs of "
                  f"{B * N * N}; {tiles} blocks with work by the masks): "
                  f"max err {errs} kernel {ms:.4f} ms (products "
                  f"{launch_ms['products']:.4f}, finish "
                  f"{launch_ms['finish']:.4f}; per call with the host "
                  f"{call_ms:.4f}) plain {plain_ms:.4f} ms (with the host "
                  f"{plain_call_ms:.4f}) bmm {lib_ms:.4f} ms (with the host "
                  f"{lib_call_ms:.4f}) bound {bound_ms:.4f} ms ({bound_by})")
            del a, b, got
            torch.cuda.empty_cache()
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

    fused_affinity.launches = 0
    t0 = time.perf_counter()
    out = track_sequence_from_frames(mod, *args, **kw)
    ids = out["ids"].cpu()
    warm_s = time.perf_counter() - t0
    launches = fused_affinity.launches
    if launches < 1:
        raise AssertionError("main path did not launch the fused kernel")
    if int(out["n_dropped"]) != 0:
        raise AssertionError(f"n_dropped = {int(out['n_dropped'])}")
    if not torch.isfinite(out["det_score"].float()).all():
        raise AssertionError("non-finite det scores")
    check_ids(ids, det_mask)
    stage(f"main path: {warm_s * 1e3:.1f} ms for {T} frames = "
          f"{T / warm_s:.1f} FPS on {smi}, {launches} fused-kernel "
          f"launch(es), {len(ids[ids >= 0].unique())} tracks")

    # Stage breakdown: the same calls, synchronised between stages.
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t) * 1e3
        return r

    feats, kept = timed("extract", lambda: extract_frames(mod, *args, **kw))
    state0 = init_state({k: v.shape[-1] for k, v in feats.items()}, N,
                        net.compute_dtype, dev)
    prev, mask_prev = pair_inputs(feats, kept, state0)
    aff = timed("affinity", lambda: mod.affinity(prev, feats, mask_prev,
                                                 kept))
    dec = timed("auction", lambda: associate(
        aff.link_norm, torch.sigmoid(aff.new), torch.sigmoid(aff.end),
        mask_prev, kept))
    timed("ids", lambda: propagate_ids(dec.match_curr, dec.is_new, kept,
                                       state0))
    stage("main path stages (ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in times.items()))
    result = dict(launches=launches, warm_ms=warm_s * 1e3, fps=T / warm_s,
                  stages_ms=times, n_valid=n_valid)
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
    reference_check(dev)
    run = main_path(net, dev, smi, profile)

    def at(dtype, B):
        r = kern[dtype, B]
        return {k: r[k] for k in ("ms", "call_ms", "launch_ms", "plain_ms",
                                  "plain_call_ms", "library_ms",
                                  "library_call_ms", "bound_ms", "bound_by",
                                  "valid_pairs", "errs")}

    bf = kern[torch.bfloat16, T]
    entry = {
        "name": "fused_affinity", "route": "cuda",
        "source": "mmmot_tpu_torch/csrc/affinity.cu",
        "replaces": "mmmot_tpu/kernels/affinity_kernel.py:206",
        "launches": run["launches"],
        "max_abs_err": max(bf["errs"].values()),
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
        "float32": {"b16": at(torch.float32, T),
                    "b512": at(torch.float32, 512)},
        "ptxas": ptxas, "sass_tensor_core": sass,
    }
    print(json.dumps({"main_path": {
        "frames": T, "detections": run["n_valid"], "warm_ms": run["warm_ms"],
        "fps": run["fps"], "stages_ms": run["stages_ms"],
        "profiled": run.get("profiled"), "gpu": smi}}))
    print(json.dumps({"kernels": [entry]}))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
