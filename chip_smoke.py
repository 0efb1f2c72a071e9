#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (``mmmot_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # the check
    python3 chip_smoke.py --profile  # also profile one main-path pass
                                     # and one full-width training step:
                                     # top CUDA kernels, and the device's
                                     # busy time over that pass's wall

Phases, each logged to stderr as ``[smoke] <phase> <elapsed>s``:

1. environment: torch, the GPU, and nvidia-smi's name and power limit;
   no CUDA device is an error;
2. build: the CUDA kernels of ``mmmot_tpu_torch/csrc`` (``affinity.cu``,
   ``int8_conv.cu``, ``bn_relu.cu``) with nvcc, one process a source,
   started together; then each kernel's registers, shared memory and
   spills (ptxas) and its tensor-core instructions (cuobjdump -sass,
   where the toolkit has it: HMMA / HGMMA, IMMA / IGMMA for int8; every
   int8 conv instance must hold IGMMA, its wgmma products);
3. kernel vs plain: the fused affinity kernel against its plain PyTorch
   version at the flagship shapes (K=3, N=32, D=H=512, hh=256) for B=16
   and B=512 frame pairs, in float32 and bfloat16, with holed masks, an
   empty frame and a frame of 27 detections among them, and at the
   revival entry band's shape (B=10 pairs at N=64: 64 state slots
   against 32 real and 32 padded current slots, one pair with an empty
   state); every masked link must be exactly 0; kernel, per-launch, plain
   and library timings, each as device time and as time per call with
   the host's work.  Then the conv epilogue (``fused_bn_relu``) against
   its op chain (``bn_relu_plain``) on VGG16's 13 conv outputs of a
   256-crop chunk at 224², pooled where the trunk pools, in bfloat16 and
   float32: every output equal bit for bit; kernel, chain and bound
   (3.35 TB/s) per layer and summed;
4. reference: ``fma`` (``torch.addcmul``) must round once, as its float64
   form does; then the ``tiny_debug`` model tracks a small sequence on the CPU
   (plain versions) and on the GPU (kernels) in float32 with the same
   seeded weights; the track ids must be equal;
5. main path: the flagship ``full_mmmot`` at full width, seeded random
   weights, one sequence of T=16 raw 384x1248 frames with 16384-point
   clouds and N=32 slots (about 12 valid per frame), compact-first with
   chunk 32 and the auction; ids are checked, the fused kernel's launch
   count must rise during the run, and the conv epilogue must launch 13
   times a chunk, 5 of them pooled;
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
   full-width noisy runner over the first window of the tree (its
   first 64 frames, two sequences per call): no dropped
   detections, finite scores, ids that follow the revival rules, two
   fused-kernel launches per window, that window's stages timed
   (extraction, band affinity, the per-frame scan, ids),
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
   sequential scan (2 launches against 16); the runner over the first
   window of the tree (64 frames, two sequences per call, the sequential
   scan: 64 bias-instance launches per window and no other, no dropped
   detections, ids that follow the revival rules), that window's
   stages timed (extraction, GNN rounds, motion term, kernel,
   scan and its auction, ghost pool, frame step) and the auction's
   rounds per frame, three of its kernel calls held against the plain
   version.  Its JSON line ``{"lookalike": ...}`` follows, and the kernel
   line lists the bias instance as a second entry;
9. training, on the same tree: (a) one ``tiny_debug`` float32
   ``train_step`` (sgd, the clip active, compact-first) on the same
   synthetic batch on the CPU and on the GPU, held by
   ``train.parity.step_agreement``: loss and metrics, every gradient
   and every post-step tensor within its stated tolerance; (b) 20
   ``tiny_debug`` steps at lr 1e-3 on the GPU: the mean loss of the
   last 5 below 0.85 of that of the first 5; then the train CLI
   (``cli/train.run``) on the tree, one epoch each, its own loop timed
   through a wrapper around its ``train_step``: (c) ``full_mmmot``
   (bf16, 4 pairs a step, capacity 128, augmentation on): 2 warm-up
   steps, 10 timed ones (ms a step, pairs a second, the load apart), 2
   with a synchronising split (forward, backward, optimizer), peak
   memory; (d) ``full_mmmot_b8`` (remat: each VGG stage checkpointed, 8
   pairs, capacity 256) and the same without remat: 2 timed steps each
   and their peak memory; (e) ``tiny_debug``, 4 steps.  In every run:
   finite loss and grad norm, ``n_dets`` equal to the batch's valid
   count, no fused-kernel launch in a step (the launches are counted),
   every parameter moved after step 2; the validation of the held-out
   sequence through ``track_kitti_sequences`` launches the fused
   kernel; the latest and best checkpoints and the scalars are written.
   After (c) and (e) the track CLI with ``--load-path`` on the best
   checkpoint must write the validation's files again.  Its JSON line
   ``{"training": ...}`` follows;
10. serving (``deploy.py``, ``cli/serve.py``, ``cli/export.py``): (a)
   ``tiny_debug`` float32 on a synthetic scene, CPU against GPU: the
   per-frame step's ids equal, one launch a frame on the GPU, and on
   each device the S=3 multi-stream step (padded, and compact) under
   partial flushes equals per-stream steps, its inactive lanes
   unchanged bit for bit; (b) ``full_mmmot`` with phase 7's calibrated
   weights, exported by ``cli/export`` and loaded by
   ``DeployedTracker``, over the first 40 frames of sequence 0000 (full
   16384-point scans): ids checked, one launch a frame, latency
   p50/p90/max after 3 warm frames, one frame's stages timed, the
   kernel at B=1 N=32 against its plain version, ids against the window
   pipeline's; (c) S=4 streams (both sequences at two offsets), 12
   flushes padded and at compact capacity 64: one launch a flush, ms a
   flush, frames a second, ids against per-stream steps, drops equal to
   the overflow, the kernel at B=4; (d) ``full_mmmot_noisy``'s per-frame
   step over 20 frames of noisy detections (2N=64 state, the kernel at
   B=1 N=64); (e) ``python -m mmmot_tpu_torch.cli.serve`` as a GPU
   subprocess, ``--exported --warmup`` and then ``--streams 2``, driven
   through the NDJSON protocol.  Its JSON line ``{"serving": ...}``
   follows, and the kernel line lists the three serving shapes as
   entries of their own;
11. int8 (``full_mmmot_int8``: the VGG16 trunk in int8 through
   ``csrc/int8_conv.cu``, the pool after conv_1, 3, 6, 9 and 12 fused
   into their epilogue): (a) at VGG16's 13 conv shapes at 224², on 32
   real crops of the tree quantised by the trunk calibrated on the tree,
   each layer's kernel output exactly equal to its plain version (a
   float64 conv), with kernel, plain, ``torch._int_mm`` (the product
   alone over the im2col'd input) and cuDNN bf16 conv times, the bound
   (int8 1,979 TOP/s, 3.35 TB/s) and the launch plan (instance, tile,
   shared memory); then the five fused-pool calls against the plain
   fused version, exactly equal, their bound counting the pooled
   output; (b) ``tiny_debug`` float32 with an int8 trunk calibrated
   once on the tree, its first 20 frames, window 8, CPU against GPU:
   result files byte-equal; (c) phase 7's calibrated seed-0 weights,
   the trunk calibrated on the tree: the int8 embeddings of the real
   crops against the bf16 trunk's (cosine above 0.99, relative norm
   below 0.1), the bf16 runner and then ``cli/track --config
   full_mmmot_int8`` over the tree (S=2, window 64; no detection
   dropped, finite scores, one affinity launch a window, 13 int8 conv
   launches an extraction: 12 of the main instance, 1 of the stem, 5
   with the pool fused, and no separate ``max_pool_int8``; ids against
   the bf16 runner's, printed), the runner's largest extraction chunk
   (up to 256 crops) through the 13 layers as the trunk runs them,
   kernel exactly equal to the plain version at that shape, with the
   library yardsticks and the bound there, one window split as in phase
   6; (d) ``cli/export --int8`` of those weights, calibrated on the
   tree, served by ``DeployedTracker`` over 20 frames of 0000 (one
   affinity and 13 int8 launches a frame, counted by kind as in (c);
   latency p50/p90).  Its JSON line ``{"int8": ...}`` precedes the
   kernel line, whose last entry is the int8 conv (the 13 unpooled
   layers summed, each in ``layers``; the fused calls in
   ``fused_pool_layers``; the runner chunk in ``runner_chunk``);
12. solvers and single branches: (a) the fused kernel's K=1 instance
   (one score branch, on ``fusion_C``'s seeded weights), its K=2
   instances (``full_mmmot``'s with a dead camera: fused and lidar; with
   a dead LiDAR: fused and image) and ``avg`` (K=3, the branch sum
   divided by K) against their plain version at D=H=512, hh=256, N=32,
   B=16 and B=128, in float32 and bfloat16, with holed masks and an
   empty frame, timed as phase 3 times K=3; (b) the tiny float32 runner
   (first 20 frames, window 8, S=2) CPU against GPU, files byte-equal,
   for tiny ``fusion_C``, ``img_only``, ``lidar_only`` (Sinkhorn),
   ``tiny_debug`` with the greedy solver, and ``tiny_debug`` with a dead
   camera, then a dead LiDAR; ``lap``, ``ilp`` and ``native`` equal on 32
   seeded instances; (c) at full width on the first window of the tree
   (S=2, 64 frames, seeded random weights): ``fusion_C``, ``img_only``,
   ``lidar_only`` and
   ``batched_val`` (Sinkhorn) through ``track_kitti_sequences``, a
   ``batched_val`` net with ``score_fusion="avg"`` over sequence 0001
   (no preset averages), and ``cli/track --config full_mmmot
   --dead-sensor camera``, then ``lidar`` (the auction, K=2).  Each run:
   no detection dropped, finite scores, ids that follow the rules across
   windows, one affinity launch a window counted under its K
   (``fused_affinity.k_launches``), and no auction call in a Sinkhorn
   run.  Each Sinkhorn preset's window runs with its stages timed (load,
   extract, affinity, sinkhorn_lap, greedy rounding, ids), and its
   association inputs go to the CPU: in float32
   the GPU's and the CPU's ``solve_sinkhorn`` decisions must be equal; in
   bfloat16 the rows that differ are counted.  Its JSON line
   ``{"solvers": ...}`` precedes the kernel line, which ends with the
   K=1, K=2 and avg instances;
13. model variants: (a) the fused kernel's other instances against
   their plain version at D=H=512, hh=256, K=3, in float32 and
   bfloat16, with holed masks and an empty frame: each correlation op
   (``mul``, ``diff``, ``cosine``), ``subabs`` with ``mul`` and all four
   ops (Dc=2048: the contraction runs one op segment at a time) at B=16
   and B=128, N=32; the ``mean`` and ``softmax`` pools and the
   ``single`` and ``none`` modes, and the instances of (c)'s two
   runners, at B=16; N=128 (the revival band of ``max_dets`` 64) at
   B=10 and B=2; every masked link exactly 0, timed as phase 3, with
   ``torch.bmm`` on the W1 product at that Dc beside; (b) the tiny
   float32 runner CPU against GPU, files byte-equal (or, where they
   differ, the first differing auction call a near tie: each device's
   assignment within ``TIE_GAP`` of the other's objective under both
   devices' costs, printed), for fusion A with
   the T-Net on ``mul`` (softmax pool, single mode), fusion B on all four
   ops (mean pool, no softmax), ``keep_single`` off on ``cosine``, and two
   configs the kernel does not cover (new/end v1, a 3-layer link head:
   the module path on both devices, no launch), then the noisy revival
   stack at ``max_dets`` 64 (2N = 128 state slots; its N=128 launches
   counted); (c) at full width on the first window of the tree (S=2, 64
   frames, seed-0 weights, the auction): ``full_mmmot`` with the first
   variant of (b), then with the second; each with every count set to 0
   just before and read just after (one launch a window under its ops,
   pool and mode), the window timed by stage, its auction rounds and
   its kernel inputs held against the plain version.  Its JSON line
   ``{"variants": ...}`` precedes the kernel
   line, which ends with the runners' instances and N=128;
14. the slice past N=128 and data parallelism: (a) the fused kernel at
   N = 144, 192, 256 and 384 (launch 2's instance that streams its lines
   from device memory) at B=10 and B=2 in float32 and bfloat16, with
   every other pool and mode and the bias instance at N=192 B=2, against
   its plain version (masked links exactly 0), timed as phase 3 with
   the bound and ``torch.bmm``; B=16 N=32 and N=128 B=10 timed again;
   (b) ``full_mmmot_noisy`` at ``max_dets`` 96 (a 2N = 192 revival
   state) through the runner, S=2, the first 64 frames, heads calibrated
   on the tree, its launches counted by N (the entry band at N=192),
   and the tiny float32 noisy runner at ``max_dets`` 96 CPU against
   GPU; (c) ``point_source="box3d"``: the tiny runner CPU against GPU
   (files byte-equal) and ``full_mmmot`` through the runner (the boxes
   holding points counted); (d) ``full_mmmot`` over the whole tree twice
   with the packed cache: files equal to each other and to phase 6's,
   each run's load and decode time; (e) the per-slot branch
   (``compact_capacity=None``): tiny ids CPU == GPU, and the main
   path's T=16 frames at full width, timed; (f) ``cli/track`` with no
   tree: 2 synthetic sequences of 16 frames at full width; (g) the
   port's data-parallel dry run (``parallel/dryrun.py``) with two ranks
   sharing the card over gloo (NCCL refuses two ranks on one device),
   tiny and at full width (``full_mmmot`` in float32, a B=4 step split
   2 + 2), then NCCL at world size 1: gathered ids equal to one process's, the step
   within loss rel 1e-4 and grad norm rel 1e-3.  Its JSON line
   ``{"phase14": ...}`` precedes the kernel line, whose entry after the
   K and variant instances is the streaming instance (N > 128) with its
   launches in (b);
15. the last modules, seed-0 random weights at full width: (a) the int8
   conv at the space-to-depth stem's shape, conv_0 [32, 112, 112, 12]
   -> 64 on the stem instance (Kp 108 padded to 128), and the s2d
   trunk's 13 layers as the trunk runs them (conv_0 and conv_1 at 112²,
   the pool fused after conv_3, 6, 9 and 12) on 32 real crops of the
   tree quantised by the s2d trunk calibrated there, then the s2d int8
   runner's largest chunk (256 crops) through them: each layer exactly
   equal to its plain version, with kernel, plain, ``torch._int_mm`` and
   cuDNN bf16 times and the bound, as phase 11 (a); (b) tiny float32
   runners (first 20 frames, window 8, S=2) CPU against GPU, files
   byte-equal (or the rows' scores within the float32 tolerance, or the
   first differing auction call a near tie), for VGG without
   BatchNorm, without skip pooling, with
   the s2d stem, with the s2d stem and an int8 trunk (the stem
   instance launched), and with bfloat16 parameters; (c) ``full_mmmot``
   at full width through the runner over the first window (S=2, 64
   frames) under ``stage_timers``, with the s2d stem in bf16, with the
   s2d stem and its calibrated int8 trunk (13 int8 launches an
   extraction: 12 main, 1 stem, 4 pooled), and with BatchNorm and skip
   pooling off: one affinity launch, no detection dropped, finite
   scores, ids by the rules, the window's kernel output against its
   plain version, FPS and the split of window 1; (d) the train CLI on
   ``full_mmmot`` with DropBlock (B=4, 4 steps and the validation)
   and ``--pretrained-vgg`` on a ``vgg16_bn`` features state dict
   written with ``torch.save`` (random values at torchvision's names
   and shapes): every loaded tensor equals the one written, five
   DropBlock draws a step, a finite loss; (e) the s2d variant exported
   under a name no preset has, loaded by ``DeployedTracker`` from its
   manifest's config and served over 20 frames of 0000 (one launch a
   frame), and a tiny float32 variant artifact giving the same ids on
   the CPU and the GPU.  Its JSON line ``{"phase15": ...}`` precedes
   the kernel line, whose entry before the last is the int8 conv's stem
   instance at Cin=12; the last is the conv epilogue (``fused_bn_relu``:
   phase 3's timings and bits, phase 5's launches).

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mmmot_tpu_torch.assoc.auction import auction_lap
from mmmot_tpu_torch.assoc.greedy import greedy_matching
from mmmot_tpu_torch.config import (full_mmmot, full_mmmot_b8,
                                    full_mmmot_lookalike,
                                    full_mmmot_noisy, tiny_debug)
from mmmot_tpu_torch.data.kitti_loader import KittiPairLoader
from mmmot_tpu_torch.data.synthetic import make_training_batch
from mmmot_tpu_torch.device import f32_parity
from mmmot_tpu_torch.kernels import build as kbuild
from mmmot_tpu_torch.kernels.affinity import (affinity_launches,
                                              affinity_plain,
                                              build_affinity_params,
                                              fused_affinity, heads_plain)
from mmmot_tpu_torch.kernels.bn_relu import bn_relu_plain, fused_bn_relu
from mmmot_tpu_torch.kernels.bn_relu import launch_counts as bn_relu_counts
from mmmot_tpu_torch.models.affinity import correlation_tensor
from mmmot_tpu_torch.models.appearance import VGG_PLANS
from mmmot_tpu_torch.models.layers import MaskedBatchNorm, fma
from mmmot_tpu_torch.models.tracking_net import TrackingNet, init_random_
from mmmot_tpu_torch.tracker.kitti_runner import track_kitti_sequences
from mmmot_tpu_torch.tracker.sequence import track_sequence_from_frames
from mmmot_tpu_torch.tracker.tracker import TrackingModule
from mmmot_tpu_torch.train.parity import step_agreement
from mmmot_tpu_torch.train.trainer import create_train_state, train_step

T0 = time.time()
KERNELS = ("affinity", "int8_conv", "bn_relu")   # the sources of csrc/
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, float32
# outside them, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
SPIN_HZ = 1.98e9           # H100 SXM boost clock: torch.cuda._sleep cycles
# Main-path shapes (bench.py's workload, one sequence).
T, N, H_IMG, W_IMG, M_PTS = 16, 32, 384, 1248, 16384
CHUNK = 32
# The runner's extraction chunk: the conv epilogue's crops in phase 3.
EPILOGUE_CROPS = 256
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


def affinity_inputs(dtype, gen, dev, B, D=512, K=3):
    """B frame pairs at the flagship shapes, K branches.  Counts are 3..16
    per side;
    every second pair has a random (holed) subset of the slots valid, the
    others a prefix.  Pair 0 has an empty prev frame, pair 1 27 valid
    detections on both sides, pair 2 alternating slots (even prev, odd
    curr), pair 3 a single prev detection at the last slot."""
    a = torch.randn((B, K, N, D), generator=gen, device=dev).to(dtype)
    b = torch.randn((B, K, N, D), generator=gen, device=dev).to(dtype)
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


def affinity_bound(a, mp, mc, params, dtype, bias=None):
    """(bound_ms, "bytes"|"operations"): the least time for the work these
    masks need (valid pairs and valid detections only) against the H100's
    peak for ``dtype``, or the bytes every input and output must move
    (the float32 ``bias`` [B, N, N] among them when given).  The
    embeddings a, b [B, K, N, D] are D wide, the pair features Dc =
    len(ops) * D (the rows of W1)."""
    K, Dc, H = params["w1"].shape
    D = a.shape[-1]
    hh = params["wn1"].shape[-1]
    np_, nc = mp.sum(1).double(), mc.sum(1).double()
    flops = float((2 * K * np_ * nc * (Dc * H + H)
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


def check_agreement(got, want, a, b, mp, mc, params, dtype, label,
                    pool="max", softmax_mode="dual"):
    """Kernel vs plain within the stated tolerance; every masked link
    exactly 0.  ``label`` names the input in messages; ``pool`` and
    ``softmax_mode`` are the instance's.  Returns the max |kernel -
    plain| per output."""
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
        staged = heads_plain(got.link, a, b, mp, mc, params, pool,
                             softmax_mode)
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


def entry_band_inputs(dtype, gen, dev, B=None, D=512, n=2 * N):
    """B frame pairs shaped like the revival hybrid's entry band at
    n = 2 * 32 = 64 slots (``tracker/sequence.py::_revival_track``): the
    previous side is a state of n/2 live slots and n/2 ghost slots (a
    random subset of the n valid), the current side n/2 real slots (a
    random subset valid) and n/2 padded ones.  Pair 0 has an empty
    previous side, as every entry pair of a run's first window has.
    n = 128 is the band of ``max_dets`` 64."""
    B = B or ENTRY_B
    a = torch.randn((B, 3, n, D), generator=gen, device=dev).to(dtype)
    b = torch.randn((B, 3, n, D), generator=gen, device=dev).to(dtype)
    mp = torch.rand((B, n), generator=gen, device=dev) < 0.6
    mc = torch.rand((B, n), generator=gen, device=dev) < 0.7
    mc[:, n // 2:] = False
    mp[0] = False
    return a, b, mp.contiguous(), mc.contiguous()


def measure_kernel(a, b, mp, mc, params, dtype, label, bias=None,
                   avg=False, ops=("subabs",), pool="max",
                   softmax_mode="dual"):
    """Kernel vs plain on one input (with ``bias``, the kernel's bias
    instance, which must move the link; with ``avg``, the branch sum
    divided by K; ``ops``, ``pool`` and ``softmax_mode`` pick the
    instance), then kernel, per-launch, plain and library timings
    (device time, and time per call with the host's work; ``cuda_ms``)
    and the bound."""
    B = a.shape[0]
    inst = dict(avg=avg, ops=ops, pool=pool, softmax_mode=softmax_mode)
    with f32_parity(dtype == torch.float32):
        got = fused_affinity(a, b, mp, mc, params, bias, **inst)
        want = affinity_plain(a, b, mp, mc, params, bias, **inst)
        torch.cuda.synchronize()
        errs = check_agreement(got, want, a, b, mp, mc, params, dtype,
                               label, pool, softmax_mode)
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
            lambda: affinity_plain(a, b, mp, mc, params, bias, **inst), 3)
        torch.cuda.empty_cache()
        products, finish, _ = affinity_launches(a, b, mp, mc, params, bias,
                                                **inst)
        ms, call_ms = cuda_ms(
            lambda: fused_affinity(a, b, mp, mc, params, bias, **inst), 20)
        launch_ms = {"products": cuda_ms(products, 20)[0],
                     "finish": cuda_ms(finish, 20)[0]}
        # Library yardstick for the dominant product only: one batched
        # matmul [K, B*N*N, Dc] x [K, Dc, H] over all pairs (no fused
        # library call computes the whole function).
        K, Dc, H = params["w1"].shape
        pair = correlation_tensor(a, b, ops)
        pair = pair.permute(1, 0, 2, 3, 4).reshape(K, -1, Dc).contiguous()
        lib_ms, lib_call_ms = cuda_ms(lambda: torch.bmm(pair, params["w1"]),
                                      5)
        del pair, got
    bound_ms, bound_by = affinity_bound(a, mp, mc, params, dtype, bias)
    per_pair = mp.sum(1) * mc.sum(1)
    pairs = int(per_pair.sum())
    # Launch 1's blocks with work, computed from the masks (the kernel
    # does not count them): one per 64 valid pairs and branch, and a
    # head block per 64 detections of a side.
    tiles = int(a.shape[1] * ((per_pair + 63) // 64).sum()
                + ((mp.sum(1) + 63) // 64).sum()
                + ((mc.sum(1) + 63) // 64).sum())
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


def vgg16_layers(size: int = 224):
    """(name, C, H, pool) of VGG16's convs at ``size``², in order; ``pool``
    where a 2x2 max-pool follows (conv_1, 3, 6, 9 and 12)."""
    out, i, H = [], 0, size
    for item in VGG_PLANS[16]:
        if item == "M":
            out[-1] = out[-1][:3] + (True,)
            H //= 2
        else:
            out.append((f"conv_{i}", item, H, False))
            i += 1
    return out


def epilogue_case(n, C, H, dtype, dev, gen):
    """A conv output [n, C, H, H] (channels-last, as cuDNN writes it)
    around each channel's BatchNorm mean, the conv bias and an eval
    BatchNorm with drawn statistics, scales of both signs and shifts."""
    bn = MaskedBatchNorm(C, dtype, dim=1).to(dev).eval()
    with torch.no_grad():
        bn.running_mean.normal_(0.0, 2.0, generator=gen)
        bn.running_var.normal_(generator=gen).exp_()
        bn.weight.normal_(generator=gen)
        bn.bias.normal_(0.5, 1.0, generator=gen)
        cb = torch.randn(C, generator=gen, device=dev)
        y = torch.empty((n, C, H, H), device=dev, dtype=dtype,
                        memory_format=torch.channels_last)
        y.normal_(generator=gen)
        y.mul_(bn.running_var.sqrt().to(dtype)[:, None, None])
        y.add_((bn.running_mean - cb).to(dtype)[:, None, None])
    return y, cb, bn


def check_bn_relu(dev):
    """Phase 3, the conv epilogue: ``fused_bn_relu`` against the op chain
    (``bn_relu_plain``) on VGG16's 13 conv outputs of a 256-crop chunk at
    224², in the trunk's order with the 2x2 max-pool fused where the
    trunk pools, in bfloat16 and float32.  Every output must equal the
    chain's bit for bit.  Kernel and chain as device time (``cuda_ms``)
    and the bound: reading the conv output once and writing the (pooled)
    activation once at 3.35 TB/s.  Sums over the 13 layers by dtype,
    with the layers."""
    gen = torch.Generator(device=dev).manual_seed(20)
    report = {}
    for dtype in (torch.bfloat16, torch.float32):
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        rows = []
        with torch.inference_mode():
            for name, C, H, pool in vgg16_layers():
                y, cb, bn = epilogue_case(EPILOGUE_CROPS, C, H, dtype, dev,
                                          gen)
                got = fused_bn_relu(y, cb, bn, pool)
                want = bn_relu_plain(y, cb, bn, pool)
                if not torch.equal(got.view(bits), want.view(bits)):
                    raise AssertionError(f"fused_bn_relu {dtype} {name}: "
                                         "bits differ from the op chain")
                del got, want
                ms, call_ms = cuda_ms(
                    lambda: fused_bn_relu(y, cb, bn, pool), 20)
                plain_ms, _ = cuda_ms(
                    lambda: bn_relu_plain(y, cb, bn, pool), 5)
                out = y.numel() // 4 if pool else y.numel()
                nbytes = (y.numel() + out) * y.element_size()
                rows.append({"layer": name, "C": C, "H": H, "pool": pool,
                             "ms": ms, "call_ms": call_ms,
                             "plain_ms": plain_ms,
                             "bound_ms": nbytes / PEAK_BYTES * 1e3})
                del y, cb, bn
                torch.cuda.empty_cache()
        total = {k: sum(r[k] for r in rows)
                 for k in ("ms", "call_ms", "plain_ms", "bound_ms")}
        stage(f"fused_bn_relu {str(dtype)[6:]} {EPILOGUE_CROPS} crops, 13 "
              f"layers: {total['ms']:.4f} ms (with the host "
              f"{total['call_ms']:.4f}), chain {total['plain_ms']:.4f} ms, "
              f"bound {total['bound_ms']:.4f} ms "
              f"({total['bound_ms'] / total['ms']:.1%}); bits equal")
        report[str(dtype)[6:]] = dict(total=total, layers=rows)
    return report


def compiled_code():
    """Registers, shared memory and spills of each kernel from the
    ptxas logs of this process's builds, and the tensor-core
    instructions (HMMA / HGMMA, IMMA / IGMMA for int8) in each kernel's
    SASS where cuobjdump is present.  Every int8 conv instance must hold
    ``IGMMA`` there (its products are ``wgmma``)."""
    ptxas, counts = {}, {}
    for src in KERNELS:
        log = kbuild.build_logs.get(src)
        ptxas.update(kbuild.ptxas_summary(log) if log else {})
        sass = kbuild.disassemble(kbuild.build(src))
        if sass is None:
            stage("cuobjdump: absent from the toolkit; SASS not counted")
            continue
        counts.update(kbuild.sass_counts(sass, ("HMMA", "HGMMA", "IMMA",
                                                "IGMMA")))
    for name, info in ptxas.items():
        stage(f"ptxas {name}: {info}")
    for name, c in counts.items():
        stage(f"sass {name}: {c}")
    int8 = {k: c for k, c in counts.items() if k.startswith("int8_conv_")}
    if counts and (not any(k.startswith("int8_conv_main") for k in int8)
                   or any(c["IGMMA"] == 0 for c in int8.values())):
        raise AssertionError(f"int8 conv SASS without wgmma (IGMMA): {int8}")
    return ptxas or None, counts or None


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


def check_ids(ids, det_mask, unassigned_ok: bool = False) -> int:
    """ids: -1 exactly at empty slots; within a frame unique; each id is
    inherited from the previous frame or the next fresh one in slot
    order.  With ``unassigned_ok`` a valid slot may be -1 too: the greedy
    rounding of a Sinkhorn plan can leave a detection neither linked nor
    new (as the reference's does).  Returns the number of such slots."""
    ids, dm = ids.cpu().numpy(), det_mask.cpu().numpy()
    if ids.shape != dm.shape:
        raise AssertionError(f"ids shape {ids.shape} != {dm.shape}")
    unassigned = int((dm & (ids < 0)).sum())
    if (ids[~dm] != -1).any() or (unassigned and not unassigned_ok):
        raise AssertionError("ids are not -1 exactly on the empty slots")
    next_id, prev = 0, set()
    for t in range(len(ids)):
        row = ids[t][dm[t] & (ids[t] >= 0)]
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
    return unassigned


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
    link_bias), "kw" (its instance: avg, ops, pool, softmax_mode) and
    "out" of the fused kernel's last call, "kernel_calls"
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

    def kernel(*args, **kw):
        seen["args"], seen["kw"] = args, kw
        seen["out"] = timed_kernel(*args, **kw)
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
    fused_bn_relu.launches = fused_bn_relu.pool_launches = 0
    t0 = time.perf_counter()
    out = track_sequence_from_frames(mod, *args, **kw)
    ids = out["ids"].cpu()
    warm_s = time.perf_counter() - t0
    launches, rounds = fused_affinity.launches, auction_lap.rounds
    epilogue = bn_relu_counts()
    if launches < 1:
        raise AssertionError("main path did not launch the fused kernel")
    chunks = capacity // CHUNK
    if epilogue != {"launches": 13 * chunks, "pool_launches": 5 * chunks}:
        raise AssertionError(f"main path: conv epilogue launches "
                             f"{epilogue} for {chunks} chunks, expected "
                             "13 and 5 a chunk")
    if int(out["n_dropped"]) != 0:
        raise AssertionError(f"n_dropped = {int(out['n_dropped'])}")
    if not torch.isfinite(out["det_score"].float()).all():
        raise AssertionError("non-finite det scores")
    check_ids(ids, det_mask)
    stage(f"main path: {warm_s * 1e3:.1f} ms for {T} frames = "
          f"{T / warm_s:.1f} FPS on {smi}, {launches} fused-kernel "
          f"launch(es), conv epilogue {epilogue} over {chunks} chunks, "
          f"{rounds} auction rounds, "
          f"{len(ids[ids >= 0].unique())} tracks")

    # Stage breakdown: the same call, synchronised between stages.
    with stage_timers(mod) as (times, _):
        track_sequence_from_frames(mod, *args, **kw)
    stage("main path stages (ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in times.items()))
    result = dict(launches=launches, warm_ms=warm_s * 1e3, fps=T / warm_s,
                  stages_ms=times, n_valid=n_valid, auction_rounds=rounds,
                  chunks=chunks, bn_relu_launches=epilogue)
    if profile:
        result["profiled"] = profiled_pass(
            lambda: track_sequence_from_frames(mod, *args, **kw))
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


def profiled_pass(fn, what: str = "main path"):
    """One call of ``fn`` under torch.profiler: its wall time on the host
    clock (profiler overhead included), the device's busy time (union of
    kernel and copy intervals), the idle share and the ten kernels with
    the most device time, all from this pass."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    print(p.key_averages().table(sort_by="cuda_time_total", row_limit=25),
          file=sys.stderr)
    busy = busy_ms(p.events())
    if busy == 0.0:
        stage(f"profiled {what}: {wall:.1f} ms wall; device time not "
              "measured (the profiler saw no CUDA events)")
        return dict(wall_ms=wall, device_busy_ms=None, idle_share=None)
    kernels = {}
    for e in p.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    stage(f"profiled {what}: {wall:.1f} ms wall, device busy {busy:.1f} "
          f"ms, idle share {1 - busy / wall:.3f}")
    return dict(wall_ms=wall, device_busy_ms=busy, idle_share=1 - busy / wall,
                top_kernels_ms=[[k[:120], v] for k, v in top])


# Phase 6: the KITTI runner on a tree written by the port's own PNG
# writer.  Two sequences at KITTI's frame size; 6 cars through the whole
# sequence and 12 for 20-60 frames each (6-18 per frame).
RUNNER_SEQS = (("0000", 100), ("0001", 70))
KITTI_H, KITTI_W = 376, 1248
KITTI_F, KITTI_CX, KITTI_CY = 721.5377, 609.5593, 172.854
CLOUD_POINTS = 16384
AGREE_FRAMES, AGREE_WINDOW = 20, 8
RUNNER_WINDOW, RUNNER_S = 64, 2
# The full-width runners of phases 7, 8, 12 (c), 13 (c) and 15 (c) track
# the first window of each sequence (its first 64 frames): one window.
CUT_FRAMES = RUNNER_WINDOW


def window_fps(stats) -> float:
    """Frames a second over every window of a runner's run (with one
    window, the first: its warm-up included)."""
    return stats["frames_loaded"] / max(sum(stats["window_s"]), 1e-9)


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


def agreement_net(device):
    """tiny_debug with seeded random weights, the new/end logits lowered
    so that links win over births and deaths."""
    net = init_random_(TrackingNet(tiny_debug().model, device=device), 7)
    with torch.no_grad():
        for head in (net.new_end.new_mlp, net.new_end.end_mlp):
            head.dense_1.bias.fill_(-3.0)
    return net


def runner_agreement(root: str, dev, tmp: str, nets=None, tag="runner",
                     assoc=None, dead_sensor=None, tie_check=None):
    """tiny_debug float32 on the tree's first frames, window 8, two
    sequences per call, on the CPU (plain versions) and on the GPU
    (kernels): the result and summary files must be byte-equal.  ``nets``
    {device: net} (default ``agreement_net`` on each) share weights;
    ``assoc`` (an ``AssocConfig``) and ``dead_sensor`` go to the
    runner.  Where files differ, ``tie_check()`` (if given) must explain
    it (it raises otherwise) and its report is returned."""
    import dataclasses
    import os

    data = dataclasses.replace(tiny_debug().data, root=root)
    nets = nets or {d: agreement_net(d) for d in ("cpu", dev)}
    files = {}
    for device, net in nets.items():
        before = fused_affinity.launches
        out = os.path.join(tmp, f"{tag}_agree_{torch.device(device).type}")
        mod = TrackingModule(net, assoc)
        stats = track_kitti_sequences(
            mod, data, out, window=AGREE_WINDOW,
            batch_sequences=RUNNER_S, max_frames=AGREE_FRAMES,
            dead_sensor=dead_sensor)
        launched = fused_affinity.launches - before
        # The kernel on the GPU for a config it covers, the module path
        # (no launch) otherwise and on the CPU.
        if (device != "cpu" and mod.fused_kernel) != (launched > 0):
            raise AssertionError(f"agreement run on {device}: {launched} "
                                 "kernel launches")
        if stats["n_dropped"]:
            raise AssertionError(f"{device}: n_dropped {stats['n_dropped']}")
        files[device] = result_files(out)
    cpu, gpu = files["cpu"], files[dev]
    if sorted(cpu) != sorted(gpu) or len(cpu) < 4:
        raise AssertionError(f"result files differ: {sorted(cpu)} vs "
                             f"{sorted(gpu)}")
    differ = sorted(n for n in cpu if cpu[n] != gpu[n])
    if differ and tie_check is None:
        raise AssertionError(f"{differ[0]}: GPU result differs from the "
                             "CPU's")
    tie = tie_check() if differ else None
    stage(f"{tag} agreement: tiny_debug f32, {AGREE_FRAMES} frames x "
          f"{RUNNER_S} sequences, window {AGREE_WINDOW}: {len(cpu)} files, "
          + (f"{differ} differ by a near tie {tie}"
             if differ else "byte-equal on CPU and GPU"))
    return {"frames": AGREE_FRAMES, "window": AGREE_WINDOW,
            "files": sorted(cpu), "byte_equal": not differ,
            "differ": differ, "near_tie": tie}


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


def quality_agreement(root: str, dev, tmp: str, cfg=None, model=None,
                      max_dets=None):
    """tiny_debug widths (``model``: tiny widths of another affinity) with
    ``cfg``'s association (default full_mmmot_noisy's), float32, on the
    first frames of both sequences, window 8, two per call, on the CPU
    (plain versions) and on the GPU (kernels): the result files, coverage
    rows included, must match (``results_match``).  ``max_dets`` replaces
    tiny_debug's 8 slots a frame (the revival's state holds twice as
    many)."""
    import dataclasses

    cfg = cfg or full_mmmot_noisy()
    data = dataclasses.replace(tiny_debug().data, root=root,
                               det_source="noisy")
    if max_dets:
        data = dataclasses.replace(data, max_dets=max_dets)
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
          f"{RUNNER_S} sequences, window {AGREE_WINDOW}, "
          f"{data.max_dets} slots: "
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
    """The noisy runner over one window (the first 64 frames of both
    sequences) with its stages timed: extraction, band affinity (the
    fused kernel's two calls), scan (per frame: normalisation, gate,
    new/end heads and the auction; the auction alone as scan_auction)
    and ids (per frame: ids and the ghost pool).  The kernel's outputs on that window's own inputs (the bands,
    B = S*(K+1)*64 at N=32, and the entry band, B = S*(K+1) at N=64)
    are held against the plain version.  Returns (the runner's stats,
    times, auction rounds per frame, errors)."""
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
            batch_sequences=RUNNER_S, max_frames=CUT_FRAMES)
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
    return stats, times, rounds, errs


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
    runner at full width over the tree's first window (64 frames, two
    sequences per call) with its stages timed
    (``quality_window_split``)."""
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
    fused_affinity.launches = 0
    stats, split, frame_rounds, split_errs = quality_window_split(
        mod, data, f"{tmp}/noisy")
    launches, rounds = fused_affinity.launches, auction_lap.rounds
    if launches != 2 * stats["n_windows"] or stats["n_windows"] != 1:
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
    result = {
        "config": cfg.name, "frames": stats["frames_loaded"],
        "windows": stats["n_windows"], "S": RUNNER_S,
        "window": RUNNER_WINDOW, "fps_window_1": window_fps(stats),
        "window_ms": [1e3 * x for x in stats["window_s"]],
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
          f"window of {RUNNER_WINDOW} x S={RUNNER_S}, "
          f"{result['fps_window_1']:.2f} FPS (window 1, warm-up included, "
          f"stages timed), windows {result['window_ms']} ms, "
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
    """The look-alike runner over one window (the first 64 frames of
    both sequences) with its stages timed: extraction, per frame the GNN
    rounds, the motion term, the fused kernel (bias instance), the scan
    (normalisation, gates, new/end heads and the auction; the auction
    alone as scan_auction), the ghost pool (ids) and the whole frame
    step.  Three of the window's 64 kernel calls (B=2 frame pairs at
    N=64) are held against the plain version on their own inputs.
    Returns (the runner's stats, times, auction rounds per frame,
    errors)."""
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
            batch_sequences=RUNNER_S, max_frames=CUT_FRAMES)
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
    return stats, times, rounds, errs


def lookalike_phase(dev, smi: str, root: str, tmp: str):
    """Phase 8: the tiny agreement gate; ``full_mmmot_lookalike`` at full
    width (seeded random weights, heads calibrated on the tree as in
    phase 7): the bias instance against its plain version; the
    motion-only model's revival hybrid against its sequential scan; the
    runner over the tree's first window (64 frames, two sequences per
    call: 64 bias-instance launches, no other) with its stages timed
    (``lookalike_window_split``).  Returns (result, the kernel
    report)."""
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
    stats, split, frame_rounds, split_errs = lookalike_window_split(
        mod, data, f"{tmp}/lookalike")
    launches = {"link_bias": fused_affinity.bias_launches,
                "no_bias": fused_affinity.launches}
    rounds = auction_lap.rounds
    if (launches != {"link_bias": RUNNER_WINDOW * stats["n_windows"],
                     "no_bias": 0} or stats["n_windows"] != 1):
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
    result = {
        "config": cfg.name, "frames": stats["frames_loaded"],
        "windows": stats["n_windows"], "S": RUNNER_S,
        "window": RUNNER_WINDOW, "fps_window_1": window_fps(stats),
        "window_ms": [1e3 * x for x in stats["window_s"]],
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
          f"{result['windows']} window of {RUNNER_WINDOW} x S={RUNNER_S}, "
          f"{result['fps_window_1']:.2f} FPS (window 1, warm-up included, "
          f"stages timed), windows {result['window_ms']} ms, {rounds} "
          f"auction rounds, "
          f"launches "
          f"{launches}, split {split} ms, rounds per frame "
          f"{result['split_rounds_per_frame']}, {counts}, MOTA "
          f"{result['mota_random_weights']:.4f} HOTA "
          f"{result['hota_random_weights']:.4f} (random weights), on {smi}")
    return result, kern


# Phase 9: training on the tree.  (a) holds one tiny float32 step on the
# GPU to the CPU's (``train.parity`` states the tolerances); (c), (d)
# and (e) run the train CLI itself, ``cli/train.run``, on the tree.
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_SPLIT_STEPS = 2, 10, 2
REMAT_STEPS = 2
TRAIN_VAL = ("0001", 20, 64)    # held-out sequence, frames, window
CLI_RUNS = ("full", "remat_b8", "plain_b8", "cli")


def train_agreement(dev):
    """(a) ``train.parity.step_agreement``: one tiny_debug float32 step
    (sgd, clip active, compact-first at capacity 12) on the same
    synthetic batch on the CPU and on the GPU (TF32 off): the loss and
    metrics, every gradient and every post-step tensor."""
    out = step_agreement(dev)
    worst = out["max_rel_err"]
    stage(f"training (a): tiny_debug f32 step CPU vs GPU: loss "
          f"{out['loss']:.6f} vs {out['loss_cpu']:.6f}, grad_norm "
          f"{out['grad_norm']:.4f}; worst gradient {worst['grad']:.2e}, "
          f"post-step {worst['state']:.2e} of scale")
    return out


def train_learning(dev):
    """(b) tiny_debug, 20 steps at lr 1e-3 on the GPU: the mean loss of
    the last 5 below 0.85 of that of the first 5 (the bar of
    tests/test_e2e_train.py)."""
    import dataclasses

    cfg = tiny_debug()
    rng = np.random.default_rng(0)
    net = init_random_(TrackingNet(cfg.model, device=dev), 0)
    state = create_train_state(net, dataclasses.replace(cfg.train, lr=1e-3),
                               20)
    losses = []
    for _ in range(20):
        b = make_training_batch(rng, batch_size=4, num_slots=8,
                                crop_size=(32, 32), points_per_det=16,
                                drop_prob=0.05, fp_prob=0.1)
        _, m = train_step(state, {k: torch.as_tensor(v, device=dev)
                                  for k, v in b.items()})
        losses.append(float(m["total"]))
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not np.isfinite(losses).all() or last >= 0.85 * first:
        raise AssertionError(f"train learning: {losses}")
    stage(f"training (b): tiny_debug 20 steps: mean loss {first:.4f} -> "
          f"{last:.4f} ({last / first:.3f} of the first 5)")
    return {"losses": losses, "first5": first, "last5": last}


@contextlib.contextmanager
def patched(obj, name: str, fn):
    """``obj.name`` is ``fn`` while open."""
    saved = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def train_cli_run(cfg, label: str, root: str, tmp: str, warmup: int,
                  steps: int, smi: str, split_steps: int = 0,
                  profile: bool = False, track: bool = False,
                  extra_args=(), first_step=None):
    """(c), (d), (e): the train CLI (``cli/train.run``) on ``cfg`` over
    the tree, on the GPU: one epoch of ``warmup + steps + split_steps``
    steps (one more under torch.profiler with ``profile``) on
    ``KittiPairLoader`` batches of sequence 0000 (augmentation on), the
    validation of the held-out 0001 through ``track_kitti_sequences``,
    the latest and best checkpoints and the scalars.

    The CLI's own ``train_step`` runs wrapped: a synchronised host-clock
    time of each step and of what the loop does before it (the batch:
    PNG decode, the device's crops and samples, augmentation), and in the
    split steps the step's stages in synchronising timers.  Every step:
    finite loss and grad_norm, ``n_dets`` equal to the batch's valid
    count (nothing dropped), no fused-kernel launch (counted all the
    same); after step 2 every parameter with a gradient has moved.  The
    validation must launch the kernel.  With ``track``, ``cli/track
    --load-path`` on the best checkpoint then writes the validation's
    files again.  ``extra_args`` go to the CLI; ``first_step(state)``
    (if given) sees the train state before the first step runs."""
    import dataclasses

    import mmmot_tpu_torch.train.trainer as trainer_mod
    from mmmot_tpu_torch.cli import track as track_cli
    from mmmot_tpu_torch.cli import train as train_cli
    from mmmot_tpu_torch.train.checkpoint import latest_step
    from mmmot_tpu_torch.utils.scalars import read_scalars

    n_steps = warmup + steps + split_steps + int(profile)
    ckpt, res, logs = (f"{tmp}/{label}_{d}"
                       for d in ("ckpt", "results", "runs"))
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, root=root),
        train=dataclasses.replace(cfg.train, epochs=1, log_every=n_steps,
                                  ckpt_dir=ckpt))
    val_seq, val_frames, val_window = TRAIN_VAL
    args = train_cli.parse_args([
        "--config", cfg.name, "--steps-per-epoch", str(n_steps),
        "--val-every", "1", "--val-frames", str(val_frames),
        "--val-window", str(val_window), "--result-path", res,
        "--log-dir", logs, *extra_args])
    real_step, real_sample = trainer_mod.train_step, KittiPairLoader.sample
    records, split = [], {}
    rec = {"launches": 0, "decode_s": 0.0, "end": None, "peak": 0,
           "profiled": None}

    def sample(loader):
        d0 = loader.ds.decode_s
        try:
            return real_sample(loader)
        finally:
            rec["decode_s"] += loader.ds.decode_s - d0

    def step(state, batch, *a, **kw):
        k = len(records)
        torch.cuda.synchronize()
        load_ms = (None if rec["end"] is None
                   else (time.perf_counter() - rec["end"]) * 1e3)
        decode_ms, rec["decode_s"] = rec["decode_s"] * 1e3, 0.0
        valid = int(batch["det_mask"].sum())
        if k == 0:
            rec["start"] = {n: p.detach().clone()
                            for n, p in state.net.named_parameters()}
            if first_step is not None:
                first_step(state)
        before = kernel_launches()
        t = time.perf_counter()
        if k < warmup + steps:
            out = real_step(state, batch, *a, **kw)
        elif k < warmup + steps + split_steps:
            timers = {"forward": (state.net, "forward"),
                      "backward": (torch.Tensor, "backward"),
                      "optimizer": (state.optimizer, "step")}
            with stage_timers(None, timers) as (times, _):
                out = real_step(state, batch, *a, **kw)
            for name in timers:
                split[name] = split.get(name, 0.0) + times[name]
        else:
            box = []
            rec["profiled"] = profiled_pass(
                lambda: box.append(real_step(state, batch, *a, **kw)),
                f"{cfg.name} train step")
            out = box[0]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches = kernel_launches() - before
        rec["launches"] += launches
        rec["peak"] = max(rec["peak"], torch.cuda.max_memory_allocated())
        m = {n: float(v) for n, v in out[1].items()}
        if not (np.isfinite(m["total"]) and np.isfinite(m["grad_norm"])):
            raise AssertionError(f"{label}: step {k + 1}: {m}")
        if int(m["n_dets"]) != valid:
            raise AssertionError(f"{label}: n_dets {m['n_dets']} of "
                                 f"{valid} valid: capacity overflow")
        if launches:
            raise AssertionError(f"{label}: the training step launched "
                                 "the fused affinity kernel")
        if k == 1:
            still = [n for n, p in state.net.named_parameters()
                     if p.grad is not None and torch.equal(
                         p, rec["start"][n])]
            if still:
                raise AssertionError(f"{label}: unchanged after step 2: "
                                     f"{still}")
        records.append({"ms": ms, "load_ms": load_ms,
                        "decode_ms": decode_ms, "valid": valid,
                        "loss": m["total"], "grad_norm": m["grad_norm"]})
        rec["end"] = time.perf_counter()
        return out

    torch.cuda.reset_peak_memory_stats()
    before = kernel_launches()
    t = time.perf_counter()
    with patched(trainer_mod, "train_step", step), \
            patched(KittiPairLoader, "sample", sample):
        result = train_cli.run(cfg, args)
    seconds = time.perf_counter() - t
    val_launches = kernel_launches() - before - rec["launches"]
    if len(records) != n_steps or val_launches <= 0:
        raise AssertionError(f"{label}: {len(records)} steps of {n_steps}, "
                             f"{val_launches} validation launches")
    best = f"{ckpt}/{cfg.name}_best"
    if (latest_step(f"{ckpt}/{cfg.name}"), latest_step(best)) != (
            n_steps, n_steps):
        raise AssertionError(f"{label}: checkpoints missing")
    tags = {r["tag"] for r in read_scalars(logs)}
    if not {"loss/total", "lr", "val/mota"} <= tags:
        raise AssertionError(f"{label}: scalars {sorted(tags)}")
    mota = result["val"]["epoch0"].mota
    timed = records[warmup:warmup + steps]
    B = cfg.train.batch_size

    def mean(key, rows=timed):
        return float(np.mean([r[key] for r in rows]))

    out = {"config": cfg.name, "batch_pairs": B,
           "pretrained_vgg": result.get("pretrained_vgg"),
           "compact_capacity": cfg.train.compact_capacity,
           "remat": cfg.model.remat, "steps": n_steps, "timed_steps": steps,
           "step_ms": [r["ms"] for r in timed], "step_ms_mean": mean("ms"),
           "pairs_per_s": B * 1e3 / mean("ms"),
           "load_ms_mean": mean("load_ms"),
           "png_decode_ms_mean": mean("decode_ms"),
           "pairs_per_s_with_load": B * 1e3 / (mean("ms")
                                               + mean("load_ms")),
           "valid_dets": [r["valid"] for r in records],
           "loss": [r["loss"] for r in records],
           "grad_norm": [r["grad_norm"] for r in records],
           "peak_mem_gib": rec["peak"] / 2 ** 30,
           "peak_mem_gib_with_validation":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "train_step_launches": rec["launches"],
           "launches": val_launches, "val_mota": mota,
           "cli_seconds": seconds, "scalar_tags": sorted(tags),
           "profiled": rec["profiled"], "gpu": smi}
    if split_steps:
        split = {k: v / split_steps for k, v in split.items()}
        split["step"] = mean("ms", records[warmup + steps:
                                           warmup + steps + split_steps])
        split["rest"] = split["step"] - sum(split[k] for k in (
            "forward", "backward", "optimizer"))
    out["split_ms"] = split
    if track:
        track_cli.main(["--config", cfg.name, "--data-root", root,
                        "--load-path", best, "--window", str(val_window),
                        "--frames", str(val_frames), "--sequences", val_seq,
                        "--result-path", f"{tmp}/{label}_tracked",
                        "--result-sha", "best"])
        got = result_files(f"{tmp}/{label}_tracked/{cfg.name}/best")
        want = result_files(f"{res}/{cfg.name}/epoch0")
        if sorted(got) != sorted(want) or f"{val_seq}.txt" not in got \
                or any(got[k] != want[k] for k in got):
            raise AssertionError(f"{label}: tracked files {sorted(got)} "
                                 f"differ from the validation's "
                                 f"{sorted(want)}")
        out["tracked_files"] = sorted(got)
    stage(f"training ({label}): train CLI, {cfg.name} B={B} capacity "
          f"{cfg.train.compact_capacity} remat={cfg.model.remat}: "
          f"{out['step_ms_mean']:.1f} ms/step ({out['pairs_per_s']:.1f} "
          f"pairs/s; load {out['load_ms_mean']:.1f} ms a batch, of it PNG "
          f"decode {out['png_decode_ms_mean']:.1f}), peak "
          f"{out['peak_mem_gib']:.2f} GiB "
          f"({out['peak_mem_gib_with_validation']:.2f} with the "
          f"validation), loss {out['loss'][0]:.3f} -> "
          f"{out['loss'][-1]:.3f}, split {split}; {n_steps} steps and the "
          f"validation in {seconds:.1f} s, {val_launches} fused-kernel "
          f"launches, MOTA {mota:.4f}"
          + ("; track --load-path wrote the same files" if track else "")
          + f"; {smi}")
    return out


def training_phase(dev, smi: str, root: str, tmp: str,
                   profile: bool = False):
    """Phase 9: (a) CPU/GPU agreement, (b) learning, then the train CLI:
    (c) full_mmmot, (d) full_mmmot_b8 with remat and without, (e)
    tiny_debug; (c) and (e) track their best checkpoints again."""
    import dataclasses

    out = {"agreement": train_agreement(dev),
           "learning": train_learning(dev)}
    out["full"] = train_cli_run(full_mmmot(), "full", root, tmp,
                                TRAIN_WARMUP, TRAIN_STEPS, smi,
                                TRAIN_SPLIT_STEPS, profile, track=True)
    torch.cuda.empty_cache()
    b8 = full_mmmot_b8()
    out["remat_b8"] = train_cli_run(b8, "remat_b8", root, tmp, 1,
                                    REMAT_STEPS, smi)
    torch.cuda.empty_cache()
    # The same batches without remat: what the checkpoints save.
    plain = dataclasses.replace(
        b8, model=dataclasses.replace(b8.model, remat=False))
    out["plain_b8"] = train_cli_run(plain, "plain_b8", root, tmp, 1,
                                    REMAT_STEPS, smi)
    torch.cuda.empty_cache()
    out["cli"] = train_cli_run(tiny_debug(), "cli", root, tmp, 1, 3, smi,
                               track=True)
    out["gpu"] = smi
    return out


# Phase 10: serving.  (a) tiny float32 per-frame and multi-stream steps,
# CPU against GPU; (b) full_mmmot through DeployedTracker, loaded from
# an artifact cli/export writes; (c) the multi-stream step at S=4,
# padded and compact; (d) full_mmmot_noisy's per-frame step; (e) the
# serve CLI in a subprocess on the GPU.
SERVE_FRAMES, SERVE_WARM = 40, 3
STREAMS, STREAM_FRAMES, STREAM_OFFSETS = 4, 12, (0, 28)
STREAM_CAPACITY = 64
NOISY_SERVE_FRAMES = 20
SCHEDULE = ([0, 1, 2], [0, 2], [1], [0, 2], [1])   # (a): partial flushes


def lane_of(tree, s):
    if isinstance(tree, dict):
        return {k: lane_of(v, s) for k, v in tree.items()}
    return tree[s]


def tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(tree_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


def stream_inputs(frames, picks, S: int, n_slots: int):
    """Stacked multi-stream inputs for one flush: ``picks`` {stream: its
    frame (image, cloud, boxes [N, 4], det_mask [N], proj)}; the other
    lanes hold zeros.  Returns (active [S], the five stacked arrays)."""
    ref = next(iter(picks.values()))
    out = [np.zeros((S,) + np.shape(x), np.asarray(x).dtype) for x in ref]
    active = np.zeros((S,), bool)
    for s, fr in picks.items():
        for o, x in zip(out, fr):
            o[s] = np.asarray(x)
        active[s] = True
    return active, out


def multistream_schedule(mod, crop, P, n_slots, streams, schedule,
                         capacity=None, split_last: bool = False):
    """Run the multi-stream step over ``schedule`` (active streams per
    flush) on ``streams`` [stream][frame] = (image, cloud, boxes [N, 4],
    det_mask [N], proj); inactive lanes must keep their state bit for bit
    and answer -1.  With ``split_last`` the last flush runs with its
    stages timed (``stage_timers``) and is left out of the flush times.
    Returns (ids per stream per frame, ms per flush, launches, auction
    rounds per flush, valid detections per flush, (split, seen) of the
    last flush or None)."""
    from mmmot_tpu_torch.deploy import (_build_multistream_step,
                                        _stacked_state)

    S = len(streams)
    multi = _build_multistream_step(mod, crop, P, capacity)
    states = _stacked_state(mod, n_slots, S)
    frame_of, got = [0] * S, [[] for _ in range(S)]
    ms, rounds, valid, split = [], [], [], None
    fused_affinity.launches = 0
    for i, slots in enumerate(schedule):
        active, ins = stream_inputs(
            streams, {s: streams[s][frame_of[s]] for s in slots}, S, n_slots)
        before, r0 = states, auction_lap.rounds
        if split_last and i == len(schedule) - 1:
            with stage_timers(mod, serve_frame_stages(mod)) as split:
                states, ids, scores = multi(states, active, *ins)
            ids = ids.cpu()
        else:
            if mod.device.type == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            states, ids, scores = multi(states, active, *ins)
            ids = ids.cpu()
            ms.append((time.perf_counter() - t) * 1e3)
        rounds.append(auction_lap.rounds - r0)
        valid.append(int(ins[3].sum()))
        for s in range(S):
            if s in slots:
                got[s].append(ids[s][torch.as_tensor(ins[3][s])].tolist())
                frame_of[s] += 1
            elif not ((ids[s] == -1).all() and (scores[s] == 0).all()
                      and tree_equal(lane_of(states, s),
                                     lane_of(before, s))):
                raise AssertionError(f"multi-stream: inactive lane {s} "
                                     "changed")
    return got, ms, fused_affinity.launches, rounds, valid, split


def per_stream_ids(mod, crop, P, n_slots, frames):
    """(b)-style per-frame steps over one stream's frames: ids of the
    valid slots per frame."""
    from mmmot_tpu_torch.deploy import _build_step, _fresh_state, \
        _state_to_dict

    step = _build_step(mod, crop, P)
    st = _state_to_dict(_fresh_state(mod, n_slots))
    out = []
    for image, cloud, boxes, dm, proj in frames:
        st, ids, _ = step(st, image, cloud, boxes, dm, proj)
        out.append(ids.cpu()[torch.as_tensor(dm)].tolist())
    return out


def serving_agreement(dev):
    """(a) tiny_debug float32 with seeded weights, on the CPU (plain
    versions) and the GPU (kernels): the per-frame step over a 6-frame
    synthetic scene gives equal ids on both, one launch a frame on the
    GPU; on each device the multi-stream step at S=3 (padded, and
    compact at a capacity that holds every detection) under partial
    flushes ({0, 1, 2}, {0, 2}, {1}, ...) gives the per-stream steps' ids
    and keeps its inactive lanes bit for bit."""
    cfg = tiny_debug()
    crop, P, Nt = tuple(cfg.data.crop_size), cfg.data.point_len, \
        cfg.data.max_dets
    gen = torch.Generator().manual_seed(11)

    def frames(T_, lo, hi):
        im, cl, bx, dm, pj = synthetic_frames(gen, "cpu", T_, 96, 320, 512,
                                              Nt, lo, hi)
        return [(im[t], cl[t], bx[t], dm[t], pj) for t in range(T_)]

    scene = frames(6, 2, 9)
    streams = [frames(3, 1, 7) for _ in range(3)]
    ids, report = {}, {}
    for device in ("cpu", dev):
        net = init_random_(TrackingNet(cfg.model, device=device), 7)
        with torch.no_grad():           # favour links over new/end
            for head in (net.new_end.new_mlp, net.new_end.end_mlp):
                head.dense_1.bias.fill_(-3.0)
        mod = TrackingModule(net)
        with f32_parity():
            before = fused_affinity.launches
            ids[device] = per_stream_ids(mod, crop, P, Nt, scene)
            launched = fused_affinity.launches - before
            if launched != (0 if device == "cpu" else len(scene)):
                raise AssertionError(f"serving agreement on {device}: "
                                     f"{launched} launches")
            want = [per_stream_ids(mod, crop, P, Nt, s) for s in streams]
            for capacity in (None, 3 * Nt):
                got, _, launches, _, _, _ = multistream_schedule(
                    mod, crop, P, Nt, streams, SCHEDULE, capacity)
                if got != want:
                    raise AssertionError(
                        f"{device} multi-stream (capacity {capacity}) ids "
                        f"{got} != per-stream {want}")
                if launches != (0 if device == "cpu" else len(SCHEDULE)):
                    raise AssertionError(f"multi-stream on {device}: "
                                         f"{launches} launches")
        report[device] = want
    if ids["cpu"] != ids[dev]:
        raise AssertionError(f"serve step ids differ between CPU and GPU: "
                             f"{ids['cpu']} vs {ids[dev]}")
    stage(f"serving agreement: tiny f32 serve-step ids equal on CPU and GPU "
          f"over {len(scene)} frames; multi-stream S=3 (padded, compact) "
          f"equals the per-stream steps on each device, inactive lanes "
          f"unchanged")
    return {"frames": len(scene), "ids": ids["cpu"],
            "multistream_flushes": len(SCHEDULE),
            "per_stream_equal_cpu_gpu": report["cpu"] == report[dev]}


def tree_frames(a):
    """Per-frame serving inputs of a loaded sequence: (image, cloud
    [M, 4] with invalid points zeroed, boxes [N, 4], det_mask [N],
    proj)."""
    clouds = np.where(a.cloud_valid[..., None], a.clouds, 0.0).astype(
        np.float32)
    return [(a.images[t], clouds[t], a.boxes[t], a.det_mask[t], a.proj)
            for t in range(len(a.images))]


def percentiles(ms):
    return {"p50": float(np.percentile(ms, 50)),
            "p90": float(np.percentile(ms, 90)), "max": float(max(ms)),
            "mean": float(np.mean(ms)), "frames": len(ms)}


def serve_frame_stages(mod):
    import mmmot_tpu_torch.deploy as dep_mod
    import mmmot_tpu_torch.tracker.tracker as trk_mod

    return {"frame": (dep_mod, "_frames_step"),
            "crop": (dep_mod, "crop_and_resize_batched"),
            "frustum": (dep_mod, "frustum_sample_batched"),
            "extract": (mod, "extract"),
            "decisions": (mod, "frame_decisions"),
            "auction": (trk_mod, "associate"),
            "ids": (trk_mod, "assign_ids")}


def serve_kernel(seen, label):
    """The fused kernel against its plain version (phase 3's
    tolerances) and timed, on the inputs of the split frame's call."""
    a, b, mp, mc, params, bias = seen["args"]
    if bias is not None:
        raise AssertionError(f"{label}: unexpected link_bias")
    with torch.inference_mode():
        return measure_kernel(a, b, mp, mc, params, torch.bfloat16, label)


def serve_single(trk, a, dev):
    """(b) The sequence's frames through ``DeployedTracker.step``: ids
    checked (every valid detection an id, unique per frame, inherited or
    fresh in slot order), one kernel launch a frame, latency per frame on
    the host clock (the call returns the ids on the host); the last frame
    with its stages timed; the kernel on its inputs; the ids against the
    window pipeline's on the same frames."""
    frames = tree_frames(a)
    T_, n_slots = a.det_mask.shape
    ids = np.full((T_, n_slots), -1, np.int64)
    ms, rounds = [], []
    fused_affinity.launches = auction_lap.rounds = 0
    for t, (image, cloud, boxes, dm, proj) in enumerate(frames):
        launches, r0 = fused_affinity.launches, auction_lap.rounds
        if t == T_ - 1:
            with stage_timers(trk.module, serve_frame_stages(
                    trk.module)) as (split, seen):
                got, scores = trk.step(image, cloud, boxes[dm], proj)
        else:
            t0 = time.perf_counter()
            got, scores = trk.step(image, cloud, boxes[dm], proj)
            ms.append((time.perf_counter() - t0) * 1e3)
        rounds.append(auction_lap.rounds - r0)
        if fused_affinity.launches - launches != 1:
            raise AssertionError(f"serve frame {t}: "
                                 f"{fused_affinity.launches - launches} "
                                 "kernel launches")
        if not np.isfinite(scores).all():
            raise AssertionError(f"serve frame {t}: non-finite scores")
        ids[t, :len(got)] = got
    launches = fused_affinity.launches
    check_ids(torch.as_tensor(ids), torch.as_tensor(a.det_mask))
    split["rounds"] = seen["calls"]["auction"][0][1]
    kern = serve_kernel(seen, f"serve B=1 N={n_slots}")
    mod = trk.module
    n_valid = int(a.det_mask.sum())
    window = track_sequence_from_frames(
        mod, a.images, a.clouds, a.boxes, a.det_mask, a.proj,
        tuple(trk.manifest["crop_size"]), trk.manifest["point_len"],
        cloud_valid=a.cloud_valid,
        compact_capacity=-(-n_valid // CHUNK) * CHUNK, extract_chunk=CHUNK,
        crop_window=crop_window(torch.as_tensor(a.boxes),
                                torch.as_tensor(a.det_mask), KITTI_W))
    wids = window["ids"].cpu().numpy()
    same = (wids == ids)[a.det_mask]
    differ = np.nonzero(~(wids == ids).all(1))[0]
    lat = percentiles(ms[SERVE_WARM:])
    result = {"frames": T_, "detections": n_valid, "launches": launches,
              "latency_ms": lat, "latency_first_ms": ms[:SERVE_WARM],
              "rounds_per_frame": {"min": min(rounds),
                                   "median": int(np.median(rounds)),
                                   "max": max(rounds), "total": sum(rounds)},
              "split_ms": split, "kernel": kern,
              "window_agreement": {"ids_equal": int(same.sum()),
                                   "valid": int(same.size),
                                   "first_differing_frame": (
                                       int(differ[0]) if len(differ)
                                       else None)},
              "tracks": int(len(np.unique(ids[ids >= 0])))}
    stage(f"serving (b): {T_} frames of 0000 through DeployedTracker, "
          f"{launches} launches, latency after {SERVE_WARM} warm frames "
          f"{lat} ms, rounds per frame {result['rounds_per_frame']}, split "
          f"{split}, ids equal to the window pipeline's at "
          f"{int(same.sum())} of {same.size} detections")
    return result


def serve_multistream(mod, seqs, dev):
    """(c) S=4 streams (the tree's two sequences at two offsets) through
    the multi-stream step, every flush with all four active, padded and
    at compact capacity 64: one kernel launch a flush, ms a flush and
    frames a second, ids against per-stream steps; every valid
    detection past the capacity, and no other, is dropped."""
    crop, P = tuple(mod.net.cfg.appearance.crop_size), \
        mod.net.cfg.point.point_len
    streams = [tree_frames(seqs[s])[o:o + STREAM_FRAMES]
               for s, _ in RUNNER_SEQS for o in STREAM_OFFSETS]
    S, n_slots = len(streams), seqs["0000"].det_mask.shape[1]
    want = [per_stream_ids(mod, crop, P, n_slots, s) for s in streams]
    schedule = [list(range(S))] * STREAM_FRAMES
    out = {}
    for name, capacity in (("padded", None), ("compact", STREAM_CAPACITY)):
        got, ms, launches, rounds, valid, split = multistream_schedule(
            mod, crop, P, n_slots, streams, schedule, capacity,
            split_last=True)
        if launches != len(schedule):
            raise AssertionError(f"multi-stream {name}: {launches} "
                                 f"launches for {len(schedule)} flushes")
        dropped = sum(sum(i < 0 for i in f) for s in got for f in s)
        overflow = sum(max(0, v - (capacity or v)) for v in valid)
        if dropped != overflow:
            raise AssertionError(f"multi-stream {name}: {dropped} detections "
                                 f"without an id, {overflow} over the "
                                 "capacity")
        equal = sum(g == w for gs, ws in zip(got, want)
                    for g, w in zip(gs, ws))
        warm = ms[1:]
        out[name] = {"launches": launches, "ms_per_flush": percentiles(warm),
                     "first_flush_ms": ms[0],
                     "fps": S * len(warm) / (sum(warm) / 1e3),
                     "rounds_per_flush": rounds, "valid_per_flush": valid,
                     "dropped": dropped,
                     "frames_equal_per_stream_steps": equal,
                     "frames": S * len(schedule), "split_ms": split[0]}
        if capacity is None:
            out["kernel"] = serve_kernel(split[1], f"multistream B={S} "
                                                   f"N={n_slots}")
        stage(f"serving (c) {name}: S={S}, {len(schedule)} flushes, "
              f"{launches} launches, {out[name]['ms_per_flush']} ms a "
              f"flush, {out[name]['fps']:.2f} frames/s, valid per flush "
              f"{valid}, dropped {dropped}, {equal} of {S * len(schedule)} "
              f"frames' ids equal the per-stream steps'")
    return out


def serve_noisy(net, root, dev):
    """(d) full_mmmot_noisy's association through the per-frame step
    over the first frames of 0000's noisy detections: the 2N=64 state,
    the ghost pool, y_det; one launch a frame (N=64), ms and auction
    rounds a frame; the last frame's kernel call held against the plain
    version."""
    import dataclasses

    from mmmot_tpu_torch.data.kitti_dataset import KittiTrackingDataset
    from mmmot_tpu_torch.deploy import (_build_step, _fresh_state,
                                        _state_to_dict)

    cfg = full_mmmot_noisy()
    data = dataclasses.replace(cfg.data, root=root, cloud_filter="none")
    a = KittiTrackingDataset(data, max_cloud_points=CLOUD_POINTS
                             ).load_sequence("0000",
                                             max_frames=NOISY_SERVE_FRAMES)
    mod = TrackingModule(net, cfg.assoc)
    step = _build_step(mod, tuple(cfg.data.crop_size), cfg.data.point_len)
    n_slots = cfg.data.max_dets
    state = _state_to_dict(_fresh_state(mod, n_slots))
    frames = tree_frames(a)
    ids = np.full((len(frames), n_slots), -1, np.int64)
    ms, rounds = [], []
    fused_affinity.launches = auction_lap.rounds = 0
    for t, (image, cloud, boxes, dm, proj) in enumerate(frames):
        r0 = auction_lap.rounds
        if t == len(frames) - 1:
            with stage_timers(mod, serve_frame_stages(mod)) as (split, seen):
                state, got, _ = step(state, image, cloud, boxes, dm, proj)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, got, _ = step(state, image, cloud, boxes, dm, proj)
            got = got.cpu()
            ms.append((time.perf_counter() - t0) * 1e3)
        rounds.append(auction_lap.rounds - r0)
        ids[t] = got.cpu().numpy()
    launches = fused_affinity.launches
    if launches != len(frames):
        raise AssertionError(f"noisy serving: {launches} launches for "
                             f"{len(frames)} frames")
    check_quality_ids(ids, a.det_mask, QUALITY_K)
    kern = serve_kernel(seen, f"noisy serve B=1 N={2 * n_slots}")
    if kern["slots"] != 2 * n_slots:
        raise AssertionError(f"noisy serving: kernel at N={kern['slots']}")
    counts = quality_counts({"0000": {"ids": ids, "det_mask": a.det_mask,
                                      "ghost_ids": np.full_like(ids, -1)}},
                            QUALITY_K)
    result = {"frames": len(frames), "launches": launches,
              "ms_per_frame": percentiles(ms[SERVE_WARM:]),
              "rounds_per_frame": {"min": min(rounds),
                                   "median": int(np.median(rounds)),
                                   "max": max(rounds), "total": sum(rounds)},
              "split_ms": dict(split, rounds=seen["calls"]["auction"][0][1]),
              "kernel": kern,
              "lp_rejections": counts["lp_rejections"],
              "revived_ids": counts["revived_ids"]}
    stage(f"serving (d) {cfg.name}: {len(frames)} frames, {launches} "
          f"launches at N={2 * n_slots}, {result['ms_per_frame']} ms a frame, "
          f"rounds {result['rounds_per_frame']}, {counts}")
    return result


class ServeProcess:
    """``python -m mmmot_tpu_torch.cli.serve <args>`` on the GPU, read
    through a thread so that every response waits at most ``timeout``
    seconds; any ``error`` response fails unless it is expected."""

    def __init__(self, args, timeout: float = 300.0):
        import os
        import queue
        import threading

        self.timeout = timeout
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "mmmot_tpu_torch.cli.serve", *args],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        self.lines = queue.Queue()

        def read():
            for line in self.proc.stdout:
                self.lines.put(line)
            self.lines.put(None)

        threading.Thread(target=read, daemon=True).start()

    def send(self, obj):
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def recv(self, error_ok: bool = False):
        line = self.lines.get(timeout=self.timeout)
        if line is None:
            raise AssertionError(f"serve CLI ended with exit code "
                                 f"{self.proc.wait()}")
        out = json.loads(line)
        if "error" in out and not error_ok:
            raise AssertionError(f"serve CLI answered {out}")
        return out

    def rpc(self, obj, error_ok: bool = False):
        self.send(obj)
        return self.recv(error_ok)

    def close(self) -> int:
        try:
            self.proc.stdin.close()
            return self.proc.wait(timeout=120)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()


def serve_cli(art: str, config: str, seqs, tmp: str):
    """(e) The serve CLI on the GPU: ``--exported`` with ``--warmup`` (the
    ready line with warmup_secs, 5 frames, a reset and frame 0 again with
    equal ids, quit with exit 0); then ``--config full_mmmot --streams 2
    --flush-ms 30`` with interleaved streams, as
    tests/test_serve.py::test_serve_multistream_interleaved drives it."""
    paths = {}
    for s, key in (("0000", "a"), ("0001", "b")):
        for t, (image, cloud, boxes, dm, proj) in enumerate(
                tree_frames(seqs[s])[:5]):
            paths[key, t] = f"{tmp}/serve_{key}{t}.npz"
            np.savez(paths[key, t], image=image, cloud=cloud,
                     boxes=boxes[dm], proj=proj)
    out = {}
    svc = ServeProcess(["--exported", art, "--warmup"])
    try:
        t0 = time.perf_counter()
        ready = svc.recv()
        out["exported_ready_s"] = time.perf_counter() - t0
        if not (ready.get("ready") and "warmup_secs" in ready):
            raise AssertionError(f"serve --exported: ready line {ready}")
        got = [svc.rpc({"npz": paths["a", t]}) for t in range(5)]
        if [r["frame"] for r in got] != list(range(5)):
            raise AssertionError(f"serve --exported: frames {got}")
        svc.rpc({"cmd": "reset"})
        again = svc.rpc({"npz": paths["a", 0]})
        if again != got[0]:
            raise AssertionError(f"serve --exported: after reset {again} "
                                 f"!= {got[0]}")
        svc.rpc({"cmd": "quit"})
    finally:
        rc = svc.close()
    if rc != 0:
        raise AssertionError(f"serve --exported exited with {rc}")
    out["exported"] = {"ready": ready, "ids": [r["ids"] for r in got]}

    svc = ServeProcess(["--config", config, "--streams", "2",
                        "--flush-ms", "30"])
    try:
        ready = svc.recv()
        if ready.get("streams") != 2:
            raise AssertionError(f"serve --streams: ready line {ready}")
        svc.send({"npz": paths["a", 0], "stream": "a"})
        svc.send({"npz": paths["b", 0], "stream": "b"})
        ra, rb = svc.recv(), svc.recv()
        a1 = svc.rpc({"npz": paths["a", 1], "stream": "a"})
        svc.send({"npz": paths["b", 1], "stream": "b"})
        svc.send({"npz": paths["b", 2], "stream": "b"})
        rb1, rb2 = svc.recv(), svc.recv()
        svc.rpc({"cmd": "reset", "stream": "a"})
        ra0 = svc.rpc({"npz": paths["a", 0], "stream": "a"})
        refused = svc.rpc({"npz": paths["a", 0], "stream": "c"},
                          error_ok=True)
        rb3 = svc.rpc({"npz": paths["b", 0], "stream": "b"})
        svc.rpc({"cmd": "quit"})
    finally:
        rc = svc.close()
    seen = [(r["stream"], r["frame"]) for r in (ra, rb, a1, rb1, rb2, ra0,
                                                 rb3)]
    if (seen != [("a", 0), ("b", 0), ("a", 1), ("b", 1), ("b", 2), ("a", 0),
                 ("b", 3)] or "error" not in refused or ra0 != ra
            or rc != 0):
        raise AssertionError(f"serve --streams 2: {seen}, {refused}, "
                             f"{ra0} vs {ra}, exit {rc}")
    out["multistream"] = {"ready": ready, "responses": seen}
    stage(f"serving (e): serve CLI --exported (warmup "
          f"{out['exported']['ready']['warmup_secs']} s) and --streams 2 "
          "answered the protocol on the GPU")
    return out


def serving_phase(dev, smi: str, root: str, tmp: str):
    """Phase 10: (a)-(e) above.  The full-width weights are phase 7's:
    seed 0, heads calibrated on the tree (``calibrate_heads``)."""
    import dataclasses

    from mmmot_tpu_torch.cli.export import main as export_main
    from mmmot_tpu_torch.compat.from_jax import save_npz, to_flax_variables
    from mmmot_tpu_torch.data.kitti_dataset import KittiTrackingDataset
    from mmmot_tpu_torch.deploy import DeployedTracker

    agreement = serving_agreement(dev)
    cfg = full_mmmot()
    net = init_random_(TrackingNet(cfg.model, device=dev), 0)
    heads, _ = calibrate_heads(net, dataclasses.replace(
        full_mmmot_noisy().data, root=root), dev)
    weights, art = f"{tmp}/serve_weights.npz", f"{tmp}/serve_artifact"
    save_npz(weights, to_flax_variables(net))
    del net
    t = time.perf_counter()
    export_main(["--config", cfg.name, "--weights", weights, "--out", art,
                 "--shape", f"{KITTI_H}x{KITTI_W}x{CLOUD_POINTS}"])
    trk = DeployedTracker.load(art, device=dev)
    load_s = time.perf_counter() - t
    data = dataclasses.replace(cfg.data, root=root, cloud_filter="none")
    ds = KittiTrackingDataset(data, max_cloud_points=CLOUD_POINTS)
    seqs = {s: ds.load_sequence(s, max_frames=SERVE_FRAMES)
            for s, _ in RUNNER_SEQS}
    single = serve_single(trk, seqs["0000"], dev)
    multi = serve_multistream(trk.module, seqs, dev)
    noisy = serve_noisy(trk.module.net, root, dev)
    del trk
    torch.cuda.empty_cache()
    cli = serve_cli(art, cfg.name, seqs, tmp)
    return {"agreement": agreement, "export_and_load_s": load_s,
            "heads": heads, "single": single, "multistream": multi,
            "noisy": noisy, "cli": cli, "gpu": smi}


# Phase 11: the int8 appearance trunk (``full_mmmot_int8``).
INT8_CROPS = 32
INT8_SERVE_FRAMES = 20
INT8_PEAK_OPS = 1979e12        # H100 SXM int8 tensor cores, dense
INT8_LAUNCHES = 13             # VGG16's convs: launches per extraction
# ... of them by instance and with the pool fused (conv_1, 3, 6, 9, 12)
INT8_BY_KIND = {"main_launches": 12, "stem_launches": 1, "pool_launches": 5}


def int8_counts_ok(counts: dict, per: int) -> bool:
    """The int8 conv's launch counts are those of ``per`` VGG16
    extractions."""
    want = {"launches": INT8_LAUNCHES * per,
            **{k: v * per for k, v in INT8_BY_KIND.items()}}
    return counts == want


def real_crops(root: str, dev, n: int, crop):
    """The first ``n`` detections of sequence 0000's first 8 frames, cut
    and normalised by the tracker's own preprocessing."""
    import dataclasses

    from mmmot_tpu_torch.data.kitti_dataset import KittiTrackingDataset
    from mmmot_tpu_torch.ops.crop_resize import (crop_and_resize_batched,
                                                 normalize_crops)

    a = KittiTrackingDataset(dataclasses.replace(full_mmmot().data,
                                                 root=root),
                             max_cloud_points=4096).load_sequence(
        "0000", max_frames=8)
    dm = torch.as_tensor(a.det_mask, device=dev)
    with torch.inference_mode():
        c = crop_and_resize_batched(
            torch.as_tensor(a.images, device=dev).float(),
            torch.as_tensor(a.boxes, device=dev), crop, dm)
        c = normalize_crops(c, scale=1.0 / 255.0)[dm]
    if len(c) < n:
        raise AssertionError(f"only {len(c)} crops in 8 frames, need {n}")
    return c[:n].contiguous()


def int8_bound(n, H, W, cin, cout, pool=False):
    """(bound_ms, ops_ms, bytes_ms, "operations"|"bytes") of one conv: its
    int8 operations at the tensor cores' peak, or reading its input and
    weights once and writing its (pooled) output once."""
    pixels = n * H * W
    ops = 2.0 * pixels * 9 * cin * cout
    out = n * (H // 2) * (W // 2) if pool else pixels
    nbytes = pixels * cin + cout * 9 * cin + 8 * cout + out * cout
    t_ops, t_bytes = ops / INT8_PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), t_ops, t_bytes,
            "operations" if t_ops >= t_bytes else "bytes")


def int8_yardsticks(xq, wq, reps: int):
    """Device ms of the two library calls that compute the conv's product
    (neither is called by the port): ``torch._int_mm`` over the im2col'd
    input (K padded as the kernel pads it; with the host), and the bf16
    cuDNN conv of the float trunk at that shape."""
    import torch.nn.functional as F

    from mmmot_tpu_torch.kernels.int8_conv import unpack_weights

    n, H, W, cin = xq.shape
    kp = wq.shape[1]
    xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, ky:ky + H, kx:kx + W] for ky in range(3)
                      for kx in range(3)], dim=-1).reshape(-1, 9 * cin)
    cols = F.pad(cols, (0, kp - 9 * cin)).contiguous()
    del xp
    lib_ms, lib_call_ms = cuda_ms(lambda: torch._int_mm(cols, wq.t()), reps)
    del cols
    torch.cuda.empty_cache()
    xb = xq.permute(0, 3, 1, 2).to(torch.bfloat16)     # channels-last NCHW
    wb = unpack_weights(wq, cin).permute(3, 2, 0, 1).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    cudnn_ms, _ = cuda_ms(lambda: F.conv2d(xb, wb, padding=1), reps)
    del xb, wb
    torch.cuda.empty_cache()
    return lib_ms, lib_call_ms, cudnn_ms


def int8_layer_check(xq, wq, m, b, label: str, pool=False, reps=10,
                     plain_reps=1):
    """One conv shape, with ``pool`` its fused-pool instance: the kernel
    against its plain version (exactly equal), their times, the bound
    and the launch plan (``conv_plan``)."""
    from mmmot_tpu_torch.kernels.int8_conv import (
        conv_plan, int8_conv3x3_requant, int8_conv3x3_requant_plain,
        int8_conv3x3_requant_pool_plain)

    plain = (int8_conv3x3_requant_pool_plain if pool
             else int8_conv3x3_requant_plain)
    n, H, W, cin = xq.shape
    cout = wq.shape[0]
    got = int8_conv3x3_requant(xq, wq, m, b, pool=pool)
    want = plain(xq, wq, m, b)
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"int8 conv {label}: {int((got != want).sum())} "
                             f"of {got.numel()} outputs differ (max {err})")
    live = float((got > 0).float().mean())
    del want
    torch.cuda.empty_cache()
    ms, call_ms = cuda_ms(
        lambda: int8_conv3x3_requant(xq, wq, m, b, pool=pool), reps)
    plain_ms, plain_call_ms = cuda_ms(lambda: plain(xq, wq, m, b),
                                      plain_reps)
    torch.cuda.empty_cache()
    bound_ms, ops_ms, bytes_ms, bound_by = int8_bound(n, H, W, cin, cout,
                                                      pool)
    ops = 2.0 * n * H * W * 9 * cin * cout
    plan = conv_plan(n, H, W, cin, cout, pool)
    r = {"layer": label, "pool": pool, "n": n, "hw": [H, W], "cin": cin,
         "cout": cout, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
         "plain_call_ms": plain_call_ms, "bound_ms": bound_ms,
         "ops_ms": ops_ms, "bytes_ms": bytes_ms, "bound_by": bound_by,
         "gops": ops / 1e9, "tops": ops / ms / 1e9, "max_abs_err": err,
         "nonzero_share": live, "plan": plan,
         # Product rows that no pixel of the map fills (a main tile has
         # 128, a stem tile 64).
         "padding_share": 1.0 - H * W / (
             plan["tiles_x"] * plan["tiles_y"]
             * (64 if plan["instance"] == "stem" else 128))}
    stage(f"int8 conv {label}{' +pool' if pool else ''} [{n}, {H}, {W}, "
          f"{cin}] -> {cout}: equal, kernel {ms:.4f} ms ({r['tops']:.1f} "
          f"TOP/s; with the host {call_ms:.4f}) plain {plain_ms:.4f} ms "
          f"bound {bound_ms:.4f} ms ({bound_by}); {plan['instance']} "
          f"instance, tile {plan['tile_w']}x{plan['tile_h']} x "
          f"{plan['tile_n']}, {plan['blocks']} blocks, {plan['k_bytes']} K "
          f"bytes a stage{', halo' * plan['halo']}, {plan['smem']} B "
          f"shared; {live:.3f} of the outputs > 0")
    return got, r


def int8_kernel_check(quant, crops):
    """(a) VGG16's 13 conv shapes at 224², on the 32 real crops quantised
    by the calibrated tree: each layer's own input map through
    ``int8_layer_check`` unpooled, with the library yardsticks; then each
    conv that a pool follows (conv_1, 3, 6, 9, 12; with the
    space-to-depth stem, which runs conv_0 and conv_1 at 112² on its
    relayout, conv_3, 6, 9, 12) again with the pool fused, whose output
    is the next layer's input."""
    from mmmot_tpu_torch.models.quantize import (quantize_input,
                                                 space_to_depth)

    xq = quantize_input(quant, crops)
    layers, fused = [], []
    ops = quant.ops
    with torch.inference_mode():
        for i, op in enumerate(ops):
            if op[0] == "s2d":
                xq = space_to_depth(xq).contiguous()
            if op[0] != "conv":
                continue
            args = quant.layer(op[1])
            label = f"conv_{op[1]}"
            got, r = int8_layer_check(xq, *args, label)
            lib_ms, lib_call_ms, cudnn_ms = int8_yardsticks(xq, args[0], 5)
            r.update(library_ms=lib_ms, library_call_ms=lib_call_ms,
                     cudnn_bf16_ms=cudnn_ms)
            stage(f"  {label}: _int_mm {lib_ms:.4f} ms, cuDNN bf16 "
                  f"{cudnn_ms:.4f} ms")
            layers.append(r)
            if i + 1 < len(ops) and ops[i + 1][0] == "pool":
                got, rp = int8_layer_check(xq, *args, label, pool=True)
                fused.append(rp)
            xq = got
    keys = ("ms", "call_ms", "plain_ms", "library_ms", "cudnn_bf16_ms",
            "bound_ms", "ops_ms", "bytes_ms", "gops")
    total = {k: sum(r[k] for r in layers) for k in keys}
    by_layer = {r["layer"]: r for r in layers}
    by_layer.update({r["layer"]: r for r in fused})
    path = {k: sum(r[k] for r in by_layer.values())
            for k in ("ms", "bound_ms", "ops_ms", "bytes_ms")}
    slower = [r["layer"] for r in layers if r["ms"] >= r["library_ms"]]
    stage(f"int8 trunk, {len(layers)} convs on {crops.shape[0]} crops: "
          f"kernel {total['ms']:.3f} ms for {total['gops']:.1f} GOP, plain "
          f"{total['plain_ms']:.1f} ms, _int_mm {total['library_ms']:.3f} "
          f"ms, cuDNN bf16 {total['cudnn_bf16_ms']:.3f} ms, bound "
          f"{total['bound_ms']:.4f} ms; as the trunk runs it ({len(fused)} "
          f"pools fused) {path['ms']:.3f} ms, bound {path['bound_ms']:.4f} "
          f"ms; layers not below _int_mm: {slower or 'none'}")
    return {"crops": int(crops.shape[0]), "layers": layers,
            "fused_pool_layers": fused, "total": total, "path": path,
            "not_below_int_mm": slower}


def int8_chunk_check(quant, chunk):
    """(c) The runner's own shape: the largest extraction chunk that the
    int8 runner handed its trunk (``chunk``: its crops and detection
    mask) through the 13 layers as the trunk runs them (the pools fused),
    each layer's kernel output exactly equal to its plain version on the
    chunk's own maps; the kernel's, the plain version's and the library
    yardsticks' device times and the bound at that shape."""
    from mmmot_tpu_torch.models.quantize import (quantize_input,
                                                 space_to_depth)

    crops = chunk["crops"]
    layers = []
    ops = quant.ops
    with torch.inference_mode():
        xq = quantize_input(quant, crops)
        for i, op in enumerate(ops):
            if op[0] == "s2d":
                xq = space_to_depth(xq).contiguous()
            if op[0] != "conv":
                continue
            args = quant.layer(op[1])
            pool = i + 1 < len(ops) and ops[i + 1][0] == "pool"
            lib_ms, _, cudnn_ms = int8_yardsticks(xq, args[0], 3)
            xq, r = int8_layer_check(xq, *args,
                                     f"chunk conv_{op[1]}", pool=pool,
                                     reps=3)
            r.update(library_ms=lib_ms, cudnn_bf16_ms=cudnn_ms)
            layers.append(r)
    sums = {k: sum(r[k] for r in layers)
            for k in ("ms", "plain_ms", "library_ms", "cudnn_bf16_ms",
                      "bound_ms")}
    result = {"crops": int(crops.shape[0]),
              "real_crops": int(chunk["mask"].sum()),
              "max_abs_err": max(r["max_abs_err"] for r in layers),
              "fused_pools": sum(r["pool"] for r in layers), **sums,
              "layers": layers}
    stage(f"int8 runner chunk of {result['crops']} crops "
          f"({result['real_crops']} real): {len(layers)} convs "
          f"({result['fused_pools']} with the pool fused) equal to the plain "
          f"version, kernel {sums['ms']:.3f} ms, plain {sums['plain_ms']:.1f}"
          f" ms, _int_mm {sums['library_ms']:.3f} ms, cuDNN bf16 "
          f"{sums['cudnn_bf16_ms']:.3f} ms, bound {sums['bound_ms']:.4f} ms")
    return result


def int8_agreement(root: str, dev, tmp: str):
    """(b) ``runner_agreement`` with an int8 trunk: tiny_debug widths in
    float32, the trunk calibrated once on the tree on the CPU and moved
    to the GPU; the GPU run must launch the int8 conv."""
    import copy
    import dataclasses

    from mmmot_tpu_torch.kernels.int8_conv import int8_conv3x3_requant
    from mmmot_tpu_torch.models.quantize import quantize_for_inference

    cfg = tiny_debug()
    cpu = agreement_net("cpu")
    quantize_for_inference(cpu, dataclasses.replace(cfg.data, root=root))
    gpu = TrackingNet(cfg.model, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    gpu.quant_int8 = copy.deepcopy(cpu.quant_int8).to(dev)
    before = int8_conv3x3_requant.launches     # the CPU run counts none
    result = runner_agreement(root, dev, tmp, {"cpu": cpu, dev: gpu},
                              "int8")
    result["gpu_int8_launches"] = int8_conv3x3_requant.launches - before
    if not result["gpu_int8_launches"]:
        raise AssertionError("int8 agreement: no int8 conv launch on the GPU")
    return result


def int8_features(net, crops):
    """(c) The int8 trunk's embeddings against the bf16 trunk's on real
    crops: cosine per crop above 0.99 and relative norm below 0.1, the
    reference's bounds (tests/test_quantize.py)."""
    from mmmot_tpu_torch.models.quantize import quantized_appearance_apply

    with torch.inference_mode():
        ref = net.appear_net(crops).double()
        q = quantized_appearance_apply(net.quant_int8, net.appear_net, crops,
                                       dtype=net.compute_dtype).double()
    cos = (ref * q).sum(-1) / (ref.norm(dim=-1) * q.norm(dim=-1)).clamp_min(
        1e-12)
    rel = float((q - ref).norm() / ref.norm())
    if not (torch.isfinite(q).all() and cos.min() > 0.99 and rel < 0.1):
        raise AssertionError(f"int8 features: cosine min {cos.min():.5f}, "
                             f"relative norm {rel:.5f}")
    stage(f"int8 features vs bf16 on {len(crops)} real crops: cosine min "
          f"{cos.min():.5f} mean {cos.mean():.5f}, relative norm {rel:.5f}")
    return {"cos_min": float(cos.min()), "cos_mean": float(cos.mean()),
            "rel_norm": rel}


def int8_runner(net, root: str, tmp: str, weights: str):
    """(c) The bf16 runner (the same weights, the trunk detached), then
    ``cli/track --config full_mmmot_int8`` itself (it calibrates on the
    tree after loading ``weights``) over the tree, S=2, window 64, with
    every count set to 0 just before and read just after: no dropped
    detections, finite scores, ids that follow the rules, one affinity
    launch a window and 13 int8 conv launches an extraction; the ids
    compared with the bf16 runner's (printed, not held: random
    weights).  The largest extraction chunk's crops, its trunk and mask
    are kept for ``int8_chunk_check``."""
    import dataclasses

    from mmmot_tpu_torch.cli.track import main as track_main
    from mmmot_tpu_torch.kernels import int8_conv
    from mmmot_tpu_torch.models import quantize, tracking_net

    data = dataclasses.replace(full_mmmot().data, root=root)
    quant, net.quant_int8 = net.quant_int8, None
    auction_lap.rounds = 0
    bf16 = track_kitti_sequences(TrackingModule(net), data, f"{tmp}/int8_bf16",
                                 window=RUNNER_WINDOW,
                                 batch_sequences=RUNNER_S, evaluate=False)
    bf16_rounds = auction_lap.rounds
    net.quant_int8 = quant
    calls = [0]
    extract = TrackingNet.extract

    def counted(self, *args, **kw):
        calls[0] += 1
        return extract(self, *args, **kw)

    apply = tracking_net.quantized_appearance_apply
    chunk = {}

    def captured(quant, appear_net, crops, mask, dtype):
        x = crops.reshape((-1,) + tuple(crops.shape[-3:]))
        if len(x) > len(chunk.get("crops", ())):
            chunk.update(crops=x.clone(), mask=mask.reshape(-1).clone(),
                         quant=quant)
        return apply(quant, appear_net, crops, mask, dtype)

    pools = [0]
    pool_op = quantize.max_pool_int8

    def counted_pool(xq):
        pools[0] += 1
        return pool_op(xq)

    fused_affinity.launches = 0
    int8_conv.reset_launches()
    auction_lap.rounds = 0
    with patched(TrackingNet, "extract", counted), \
            patched(tracking_net, "quantized_appearance_apply", captured), \
            patched(quantize, "max_pool_int8", counted_pool):
        stats = track_main(["--config", "full_mmmot_int8", "--data-root",
                            root, "--weights", weights, "--result-path",
                            f"{tmp}/int8_results", "--batch-sequences",
                            str(RUNNER_S), "--window", str(RUNNER_WINDOW),
                            "--no-eval"])
    counts = int8_conv.launch_counts()
    launches = {"fused_affinity": fused_affinity.launches,
                "int8_conv3x3_requant": counts["launches"]}
    rounds = auction_lap.rounds
    if launches["fused_affinity"] != stats["n_windows"]:
        raise AssertionError(f"int8 runner: {launches} for "
                             f"{stats['n_windows']} windows")
    if not (calls[0] and int8_counts_ok(counts, calls[0])) or pools[0]:
        raise AssertionError(f"int8 runner: {counts} and {pools[0]} "
                             f"separate pools for {calls[0]} extractions")
    if stats["n_dropped"] != 0:
        raise AssertionError(f"int8 runner: n_dropped {stats['n_dropped']}")
    equal = valid = 0
    for seq, o in stats["outputs"].items():
        if not np.isfinite(o["det_score"]).all():
            raise AssertionError(f"int8 {seq}: non-finite det scores")
        check_ids(torch.as_tensor(o["ids"]), torch.as_tensor(o["det_mask"]))
        dm = o["det_mask"]
        equal += int((o["ids"] == bf16["outputs"][seq]["ids"])[dm].sum())
        valid += int(dm.sum())
    counted_s = stats["window_s"][1:]
    result = {"frames": stats["frames_loaded"], "windows": stats["n_windows"],
              "fps": stats["fps"], "bf16_fps": bf16["fps"],
              "window_ms": [1e3 * x for x in stats["window_s"]],
              "bf16_window_ms": [1e3 * x for x in bf16["window_s"]],
              "ms_per_window": 1e3 * sum(counted_s) / max(1, len(counted_s)),
              "extractions": calls[0], "launches": launches,
              "int8_launches_by_kind": counts,
              "separate_max_pool_int8": pools[0],
              "auction_rounds": rounds, "bf16_auction_rounds": bf16_rounds,
              "ids_equal_bf16": equal, "valid": valid}
    stage(f"int8 runner (cli/track --config full_mmmot_int8): "
          f"{result['frames']} frames, {result['windows']} windows, "
          f"{stats['fps']:.1f} FPS after the first window (bf16, same "
          f"weights: {bf16['fps']:.1f}), launches {launches} over "
          f"{calls[0]} extractions, {rounds} auction rounds (bf16 "
          f"{bf16_rounds}); int8 conv launches by kind {counts}, "
          f"{pools[0]} separate pools; ids equal to the bf16 runner's at "
          f"{equal} of {valid} detections")
    return result, chunk


def int8_serving(root: str, tmp: str, weights: str, dev):
    """(d) ``cli/export --int8`` of the same weights, calibrated on the
    tree, then ``DeployedTracker`` over 20 frames of sequence 0000 (full
    scans): one affinity launch and 13 int8 conv launches a frame,
    latency p50/p90 after 3 warm frames, the last frame's stages timed
    as in phase 10 (b)."""
    import dataclasses

    from mmmot_tpu_torch.cli.export import main as export_main
    from mmmot_tpu_torch.data.kitti_dataset import KittiTrackingDataset
    from mmmot_tpu_torch.deploy import DeployedTracker
    from mmmot_tpu_torch.kernels import int8_conv

    art = f"{tmp}/int8_artifact"
    t = time.perf_counter()
    export_main(["--config", "full_mmmot", "--int8", "--weights", weights,
                 "--out", art, "--calib-root", root,
                 "--shape", f"{KITTI_H}x{KITTI_W}x{CLOUD_POINTS}"])
    trk = DeployedTracker.load(art, device=dev)
    load_s = time.perf_counter() - t
    if not (trk.manifest["int8"] and trk.module.net.quant_int8 is not None):
        raise AssertionError("int8 artifact: no int8 trunk after loading")
    data = dataclasses.replace(full_mmmot().data, root=root,
                               cloud_filter="none")
    a = KittiTrackingDataset(data, max_cloud_points=CLOUD_POINTS
                             ).load_sequence("0000",
                                             max_frames=INT8_SERVE_FRAMES)
    ms, launched = [], np.zeros(2, np.int64)
    ids = np.full(a.det_mask.shape, -1, np.int64)
    frames = tree_frames(a)
    int8_conv.reset_launches()
    for t, (image, cloud, boxes, dm, proj) in enumerate(frames):
        f0, q0 = fused_affinity.launches, int8_conv.launch_counts()
        if t == len(frames) - 1:
            with stage_timers(trk.module, serve_frame_stages(
                    trk.module)) as (split, _):
                got, scores = trk.step(image, cloud, boxes[dm], proj)
        else:
            t0 = time.perf_counter()
            got, scores = trk.step(image, cloud, boxes[dm], proj)
            ms.append((time.perf_counter() - t0) * 1e3)
        q1 = int8_conv.launch_counts()
        step = (fused_affinity.launches - f0,
                {k: q1[k] - q0[k] for k in q1})
        if step[0] != 1 or not int8_counts_ok(step[1], 1):
            raise AssertionError(f"int8 serve frame {t}: launches {step}")
        launched += (step[0], step[1]["launches"])
        if not np.isfinite(scores).all():
            raise AssertionError(f"int8 serve frame {t}: non-finite scores")
        ids[t, :len(got)] = got
    check_ids(torch.as_tensor(ids), torch.as_tensor(a.det_mask))
    lat = percentiles(ms[SERVE_WARM:])
    stage(f"int8 serving: export + load {load_s:.1f} s, {len(frames)} frames "
          f"through DeployedTracker, latency after {SERVE_WARM} warm frames "
          f"{lat} ms, 1 affinity and {INT8_LAUNCHES} int8 conv launches a "
          f"frame; split of the last frame {split} ms")
    return {"export_and_load_s": load_s, "frames": len(frames),
            "split_ms": split,
            "latency_ms": lat, "latency_first_ms": ms[:SERVE_WARM],
            "launches": {"fused_affinity": int(launched[0]),
                         "int8_conv3x3_requant": int(launched[1])},
            "int8_launches_by_kind": int8_conv.launch_counts()}


def int8_phase(dev, smi: str, root: str, tmp: str, runner):
    """Phase 11: (a)-(d) above.  The full-width weights are phase 7's
    (seed 0, heads calibrated on the tree) with the trunk calibrated on
    the tree (``quantize_for_inference``)."""
    import dataclasses

    from mmmot_tpu_torch.compat.from_jax import save_npz, to_flax_variables
    from mmmot_tpu_torch.config import full_mmmot_int8
    from mmmot_tpu_torch.models.quantize import quantize_for_inference

    agreement = int8_agreement(root, dev, tmp)
    cfg = full_mmmot_int8()
    net = init_random_(TrackingNet(cfg.model, device=dev), 0)
    heads, _ = calibrate_heads(net, dataclasses.replace(
        full_mmmot_noisy().data, root=root), dev)
    weights = f"{tmp}/int8_weights.npz"
    save_npz(weights, to_flax_variables(net))
    t = time.perf_counter()
    quantize_for_inference(net, dataclasses.replace(cfg.data, root=root))
    calib_s = time.perf_counter() - t
    crops = real_crops(root, dev, INT8_CROPS, cfg.model.appearance.crop_size)
    kernel = int8_kernel_check(net.quant_int8, crops)
    features = int8_features(net, crops)
    del crops
    torch.cuda.empty_cache()
    run, chunk = int8_runner(net, root, tmp, weights)
    runner_chunk = int8_chunk_check(chunk.pop("quant"), chunk)
    del chunk
    torch.cuda.empty_cache()
    split, n_det, rounds, errs = runner_split(
        TrackingModule(net), dataclasses.replace(cfg.data, root=root), dev,
        f"{tmp}/int8_split")
    stage(f"int8 runner split of window 1 (ms): {split}; bf16 (phase 6): "
          f"{runner['split_ms']}")
    del net
    torch.cuda.empty_cache()
    serving = int8_serving(root, tmp, weights, dev)
    return {"agreement": agreement, "heads": heads, "calibration_s": calib_s,
            "kernel": kernel, "runner_chunk": runner_chunk,
            "features": features, "runner": run,
            "split_ms": split, "split_detections": n_det,
            "split_auction_rounds": rounds,
            "split_kernel_vs_plain_max_err": errs,
            "bf16_split_ms_phase6": runner["split_ms"], "serving": serving,
            "gpu": smi}


# Phase 12: the other solvers and the single-branch scorers.  (a) the
# fused kernel's K=1 (one score branch), K=2 (a dead sensor's branch
# absent) and avg instances against their plain version; (b) tiny
# float32 runners, CPU against GPU, on the single-branch nets, the greedy
# solver and a dead sensor, then the host oracles; (c) full width on the
# tree: the Sinkhorn presets through the runner, a score_fusion="avg"
# net over sequence 0001, and cli/track --dead-sensor on full_mmmot.
SINKHORN_PRESETS = ("fusion_C", "img_only", "lidar_only", "batched_val")
SOLVER_B = (T, 128)     # the main path's window and a runner window
# (label, preset that gives the weights, branches, avg)
INSTANCES = (("K=1", "fusion_C", ("fused",), False),
             ("K=2 dead camera", "full_mmmot", ("fused", "lidar"), False),
             ("K=2 dead lidar", "full_mmmot", ("fused", "image"), False),
             ("K=3 avg", "full_mmmot", ("fused", "image", "lidar"), True))


def preset_net(name: str, dev, seed: int = 0, **model):
    """A full-width net of preset ``name`` with seeded random weights
    (as phase 6's), ``model`` replacing fields of its model config."""
    import dataclasses

    import mmmot_tpu_torch.config as presets

    mcfg = dataclasses.replace(getattr(presets, name)().model, **model)
    return init_random_(TrackingNet(mcfg, device=dev), seed)


def check_instances(dev):
    """(a): each instance of ``INSTANCES`` against its plain version at
    D=H=512, hh=256, N=32, B=16 and B=128, float32 and bfloat16, with
    holed masks and an empty frame, timed as phase 3 times K=3."""
    gen = torch.Generator(device=dev).manual_seed(12)
    report = {}
    for label, preset, branches, avg in INSTANCES:
        net = preset_net(preset, dev)
        for dtype in (torch.float32, torch.bfloat16):
            params = build_affinity_params(net, dtype, branches)
            for B in SOLVER_B:
                report[label, dtype, B] = measure_kernel(
                    *affinity_inputs(dtype, gen, dev, B, K=len(branches)),
                    params, dtype, f"{label} B={B}", avg=avg)
        del net
        torch.cuda.empty_cache()
    return report


def single_branch_nets(model, device, seed=7):
    """tiny_debug widths with ``model`` switches, seeded as
    ``agreement_net``."""
    import dataclasses

    net = init_random_(TrackingNet(dataclasses.replace(
        tiny_debug().model, **model), device=device), seed)
    with torch.no_grad():
        for head in (net.new_end.new_mlp, net.new_end.end_mlp):
            head.dense_1.bias.fill_(-3.0)
    return net


TIE_GAP = 1e-3     # a near tie: the two picks' scores differ by at most
                   # this (log-plan or gain units) in each device's scores


def lockstep_gap(score_cpu, score_gpu):
    """Greedy rounding of the CPU's and the GPU's scores [M, M] of one
    instance in lock step, up to the first round whose picks differ:
    (round, the CPU's score of its pick minus that of the GPU's pick,
    the same in the GPU's scores), or None when every pick agrees."""
    a = score_cpu.double().numpy()
    b = score_gpu.double().cpu().numpy()
    M = a.shape[-1]
    used_r, used_c = np.zeros(M, bool), np.zeros(M, bool)
    for r in range(M):
        used = used_r[:, None] | used_c[None, :]
        ma, mb = np.where(used, -np.inf, a), np.where(used, -np.inf, b)
        ia, ib = int(np.argmax(ma)), int(np.argmax(mb))
        if ia != ib:
            return r, float(ma.flat[ia] - ma.flat[ib]), float(
                mb.flat[ib] - mb.flat[ia])
        used_r[ia // M] = used_c[ia % M] = True
    return None


def greedy_tie_report(calls_cpu, calls_gpu, what: str):
    """The first solver call whose decisions differ between the CPU's and
    the GPU's run (``calls_*``: (the scores the call handed to
    ``greedy_matching``, its decisions), in call order; later calls see
    states that differ).  For each of its instances that differ: the
    greedy rounding's first round whose picks differ and the two picks'
    gap in each device's scores, or with equal picks the smallest gain
    picked (the greedy solver keeps a pick while its gain is positive).
    Raises unless every gap is at most ``TIE_GAP`` (near ties), or when
    no decision differs; returns the call, the instances that differ,
    the largest gap and the first instance's report."""
    for k, ((x, dx), (y, dy)) in enumerate(zip(calls_cpu, calls_gpu)):
        x, y = x.reshape((-1,) + x.shape[-2:]), y.reshape((-1,) +
                                                           y.shape[-2:])
        n = x.shape[0]
        differ = torch.zeros(n, dtype=torch.bool)
        for a, b in zip(dx, dy):
            differ |= (a.cpu().reshape(n, -1) != b.cpu().reshape(n, -1)
                       ).any(-1)
        reports = []
        for i in torch.nonzero(differ)[:, 0].tolist():
            found = lockstep_gap(x[i], y[i])
            if found is None:
                rc = greedy_matching(x[i])
                gain = x[i].gather(-1, rc.long()[:, None])
                reports.append({"instance": i, "round": None,
                                "gap": float(gain.abs().min())})
            else:
                rnd, gap_cpu, gap_gpu = found
                reports.append({"instance": i, "round": rnd,
                                "gap": max(gap_cpu, gap_gpu),
                                "gap_cpu": gap_cpu, "gap_gpu": gap_gpu})
        if not reports:
            continue
        worst = max(r["gap"] for r in reports)
        if worst > TIE_GAP:
            raise AssertionError(f"{what}: call {k}: the decisions differ "
                                 f"by more than a near tie: {reports}")
        return {"call": k, "instances": len(reports), "max_gap": worst,
                "first": reports[0]}
    raise AssertionError(f"{what}: files differ, but every decision of the "
                         f"{len(calls_cpu)} solver calls agrees")


@contextlib.contextmanager
def greedy_inputs():
    """While open, each call of the Sinkhorn or the greedy solver records,
    by device type, the scores its rounding (``greedy_matching``) got and
    the decisions it returned."""
    import mmmot_tpu_torch.assoc.greedy as greedy_mod
    import mmmot_tpu_torch.assoc.sinkhorn as sk_mod
    import mmmot_tpu_torch.assoc.solve as solve_mod

    calls = {"cpu": [], "cuda": []}
    scores = []
    rounding = greedy_mod.greedy_matching

    def recorded(score):
        scores.append(score.detach().float().cpu())
        return rounding(score)

    def solver(fn):
        def run(link, *args, **kw):
            dec = fn(link, *args, **kw)
            calls[link.device.type].append((scores.pop(), dec))
            return dec
        return run

    with patched(greedy_mod, "greedy_matching", recorded), \
            patched(sk_mod, "greedy_matching", recorded), \
            patched(solve_mod, "solve_sinkhorn",
                    solver(solve_mod.solve_sinkhorn)), \
            patched(solve_mod, "solve_greedy",
                    solver(solve_mod.solve_greedy)):
        yield calls


def oracle_agreement():
    """lap, ilp and native: equal decisions on 32 seeded instances (N=16,
    half with det scores), on the host."""
    from mmmot_tpu_torch.assoc.solve import associate
    from mmmot_tpu_torch.config import AssocConfig

    rng = np.random.default_rng(12)
    for i in range(32):
        n = 16
        args = [torch.tensor(rng.normal(0, 1, (n, n)), dtype=torch.float32),
                torch.tensor(rng.uniform(0, 1, n), dtype=torch.float32),
                torch.tensor(rng.uniform(0, 1, n), dtype=torch.float32),
                torch.tensor(rng.random(n) < 0.7),
                torch.tensor(rng.random(n) < 0.7)]
        det = {}
        if i % 2:
            det = {k: torch.tensor(rng.normal(0, 1.5, n), dtype=torch.float32)
                   for k in ("det_prev", "det_curr")}
        decs = [associate(*args, AssocConfig(solver=s), **det)
                for s in ("lap", "ilp", "native")]
        for d in decs[1:]:
            for f, x, y in zip(d._fields, d, decs[0]):
                if not torch.equal(x, y):
                    raise AssertionError(f"oracles differ on instance {i}: "
                                         f"{f}")
    return 32


def solver_agreement(root: str, dev, tmp: str):
    """(b): the tiny float32 runner CPU against GPU, result files
    byte-equal, for tiny fusion_C, img_only and lidar_only (Sinkhorn),
    tiny_debug with the greedy solver, and tiny_debug with a dead camera,
    then a dead LiDAR; then the three host oracles."""
    from mmmot_tpu_torch.config import AssocConfig

    runs = {"fusion_C": (dict(score_fusion="fused-only"), "sinkhorn", None),
            "img_only": (dict(use_lidar=False), "sinkhorn", None),
            "lidar_only": (dict(use_image=False), "sinkhorn", None),
            "greedy": ({}, "greedy", None),
            "dead_camera": ({}, "auction", "camera"),
            "dead_lidar": ({}, "auction", "lidar")}
    out = {}
    for tag, (model, solver, dead) in runs.items():
        nets = {d: single_branch_nets(model, d) for d in ("cpu", dev)}
        with greedy_inputs() as calls:
            out[tag] = runner_agreement(
                root, dev, tmp, nets, f"solvers {tag}",
                AssocConfig(solver=solver), dead,
                tie_check=lambda: greedy_tie_report(
                    calls["cpu"], calls["cuda"], tag))
    out["oracle_instances"] = oracle_agreement()
    stage(f"solvers agreement: {len(runs)} tiny runners byte-equal on CPU "
          f"and GPU; lap, ilp and native equal on "
          f"{out['oracle_instances']} instances")
    return out


def sinkhorn_inputs_check(args, cfg):
    """One window's association inputs (link_norm, new, end, masks; the
    Sinkhorn runs on the GPU) taken to the CPU: upcast to float32, the
    GPU and CPU ``solve_sinkhorn`` decisions must be equal, but for a
    near tie of the greedy rounding (``greedy_tie_report``, printed); in
    bfloat16, the slots whose decisions differ are counted."""
    import mmmot_tpu_torch.assoc.solve as solve_mod

    link, new, end, mp, mc = args
    kw = dict(tau=cfg.sinkhorn_tau, iters=cfg.sinkhorn_iters)
    out = {"instances": int(link.shape[0]), "dtype": str(link.dtype)[6:]}
    for what, cast in (("float32", lambda x: x.float()),
                       ("bfloat16", lambda x: x)):
        with greedy_inputs() as calls:
            dec = {d: solve_mod.solve_sinkhorn(
                *(cast(x).to(d) for x in (link, new, end)), mp.to(d),
                mc.to(d), **kw) for d in ("cpu", link.device)}
        diff = [int((x.cpu() != y).sum())
                for x, y in zip(dec[link.device], dec["cpu"])]
        out[what] = dict(zip(dec["cpu"]._fields, diff))
        if what == "float32" and any(diff):
            out["float32_near_tie"] = greedy_tie_report(
                calls["cpu"], calls["cuda"], "sinkhorn float32")
    return out


def counted_calls(obj, name: str, counter: dict):
    """``patched`` with a wrapper that counts the calls of ``obj.name``
    into ``counter[name]``."""
    fn = getattr(obj, name)

    def run(*a, **kw):
        counter[name] = counter.get(name, 0) + 1
        return fn(*a, **kw)
    return patched(obj, name, run)


def check_runner_run(stats, what: str, K: int, launches: dict,
                     unassigned_ok: bool = False) -> int:
    """No detection dropped, finite scores, ids that follow the rules
    across windows (``check_ids``; ``unassigned_ok`` for a greedy
    rounding), and one affinity launch a window, counted under K.
    Returns the valid detections left without an id."""
    if stats["n_dropped"] != 0:
        raise AssertionError(f"{what}: n_dropped {stats['n_dropped']}")
    unassigned = 0
    for seq, o in stats["outputs"].items():
        if not np.isfinite(o["det_score"]).all():
            raise AssertionError(f"{what} {seq}: non-finite det scores")
        unassigned += check_ids(torch.as_tensor(o["ids"]),
                                torch.as_tensor(o["det_mask"]),
                                unassigned_ok)
    want = {k: stats["n_windows"] if k == K else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"{what}: launches by K {launches} for "
                             f"{stats['n_windows']} windows at K={K}")
    return unassigned


def sinkhorn_runner(name: str, root: str, tmp: str, dev, split=True,
                    sequences=None, **model):
    """Preset ``name`` at full width through ``track_kitti_sequences``
    (S=2, the first window of 64 frames; ``model`` replaces fields of
    its model config) with every count set to 0 just before and read
    just after: ``check_runner_run`` and no auction call.  With
    ``split``, that window runs under ``stage_timers`` (load, extract,
    affinity, sinkhorn_lap, greedy rounding, ids, window) and its
    association inputs are held CPU against GPU
    (``sinkhorn_inputs_check``)."""
    import dataclasses

    import mmmot_tpu_torch.assoc.sinkhorn as sk_mod
    import mmmot_tpu_torch.assoc.solve as solve_mod
    import mmmot_tpu_torch.config as presets
    import mmmot_tpu_torch.tracker.sequence as seq_mod
    from mmmot_tpu_torch.kernels.affinity import reset_launches

    cfg = getattr(presets, name)()
    net = preset_net(name, dev, **model)
    K = len(net.score_branches)
    mod = TrackingModule(net, cfg.assoc)
    data = dataclasses.replace(cfg.data, root=root)
    calls, seen = {}, {}
    assoc = seq_mod.associate

    def captured(*args, **kw):
        seen["args"] = args[:5]
        return assoc(*args, **kw)

    stages = {"extract": (seq_mod, "extract_frames_batched"),
              "affinity": (mod, "affinity"),
              "sinkhorn_lap": (sk_mod, "sinkhorn_lap"),
              "greedy": (sk_mod, "greedy_matching"),
              "ids": (seq_mod, "propagate_ids")}
    reset_launches()
    auction_lap.rounds = 0
    with contextlib.ExitStack() as timed:
        if split:
            timed.enter_context(patched(seq_mod, "associate", captured))
            times, _ = timed.enter_context(stage_timers(mod, stages))
        timed.enter_context(counted_calls(solve_mod, "solve_auction", calls))
        timed.enter_context(counted_calls(sk_mod, "sinkhorn_lap", calls))
        stats = track_kitti_sequences(
            mod, data, f"{tmp}/{name}", window=RUNNER_WINDOW,
            batch_sequences=RUNNER_S, sequences=sequences,
            max_frames=CUT_FRAMES, evaluate=False)
    launches = dict(fused_affinity.k_launches)
    avg_launches = fused_affinity.avg_launches
    if calls.get("solve_auction") or auction_lap.rounds:
        raise AssertionError(f"{name}: {calls} auction calls "
                             f"({auction_lap.rounds} rounds)")
    if calls.get("sinkhorn_lap") != stats["n_windows"]:
        raise AssertionError(f"{name}: {calls} for {stats['n_windows']} "
                             "windows")
    unassigned = check_runner_run(stats, name, K, launches, True)
    result = {"frames": stats["frames_loaded"], "windows": stats["n_windows"],
              "K": K, "score_fusion": net.cfg.score_fusion,
              "fps_window_1": window_fps(stats),
              "window_ms": [1e3 * x for x in stats["window_s"]],
              "load_s": stats["load_s"], "launches_by_k": launches,
              "avg_launches": avg_launches, "calls": calls,
              "auction_rounds": auction_lap.rounds,
              "detections": sum(int(o["det_mask"].sum())
                                for o in stats["outputs"].values()),
              "unassigned_by_rounding": unassigned}
    if split:
        times["load"] = stats["load_s"] * 1e3
        times["window"] = stats["window_s"][0] * 1e3
        result["split_ms"] = times
        result["gpu_vs_cpu_sinkhorn"] = sinkhorn_inputs_check(
            seen["args"], cfg.assoc)
    stage(f"solvers runner {name}{model or ''}: {result['frames']} frames, "
          f"{result['windows']} window, K={K}, "
          f"{result['fps_window_1']:.1f} FPS (window 1, warm-up included"
          f"{', stages timed' if split else ''}), windows "
          f"{result['window_ms']} ms, "
          f"launches by K {launches} (avg {avg_launches}), calls {calls}, "
          f"{unassigned} of {result['detections']} detections left "
          "without an id by the greedy rounding"
          + (f", split {result['split_ms']} ms, GPU vs CPU sinkhorn "
             f"{result['gpu_vs_cpu_sinkhorn']}" if split else ""))
    del net, mod
    torch.cuda.empty_cache()
    return result


def dead_sensor_cli(root: str, tmp: str, weights: str, dead: str):
    """``cli/track --config full_mmmot --dead-sensor <dead>`` itself over
    the tree (S=2, window 64, the auction, K=2) with every count set to 0
    just before and read just after (``check_runner_run``)."""
    from mmmot_tpu_torch.cli.track import main as track_main
    from mmmot_tpu_torch.kernels.affinity import reset_launches

    reset_launches()
    auction_lap.rounds = 0
    stats = track_main(["--config", "full_mmmot", "--data-root", root,
                        "--weights", weights, "--dead-sensor", dead,
                        "--result-path", f"{tmp}/dead_{dead}",
                        "--batch-sequences", str(RUNNER_S), "--window",
                        str(RUNNER_WINDOW), "--frames", str(CUT_FRAMES),
                        "--no-eval"])
    launches = dict(fused_affinity.k_launches)
    check_runner_run(stats, f"dead {dead}", 2, launches)
    result = {"frames": stats["frames_loaded"], "windows": stats["n_windows"],
              "fps_window_1": window_fps(stats),
              "window_ms": [1e3 * x for x in stats["window_s"]],
              "launches_by_k": launches,
              "auction_rounds": auction_lap.rounds}
    stage(f"solvers cli/track --dead-sensor {dead}: {result['frames']} "
          f"frames, {result['windows']} window, "
          f"{result['fps_window_1']:.1f} FPS (window 1, warm-up included), "
          f"windows {result['window_ms']} ms, "
          f"launches by K {launches}, {auction_lap.rounds} auction rounds")
    return result


def solvers_phase(dev, smi: str, root: str, tmp: str):
    """Phase 12: (a), (b) and (c) above; returns the kernel report of (a)
    and the ``{"solvers": ...}`` result."""
    from mmmot_tpu_torch.compat.from_jax import save_npz, to_flax_variables

    kern = check_instances(dev)
    agreement = solver_agreement(root, dev, tmp)
    runs = {name: sinkhorn_runner(name, root, tmp, dev)
            for name in SINKHORN_PRESETS}
    # No preset averages: the avg instance runs on a batched_val net with
    # score_fusion="avg", over sequence 0001 only.
    runs["avg"] = sinkhorn_runner("batched_val", root, tmp, dev, split=False,
                                  sequences=["0001"], score_fusion="avg")
    if runs["avg"]["avg_launches"] != runs["avg"]["windows"]:
        raise AssertionError(f"avg run: {runs['avg']['avg_launches']} avg "
                             "launches")
    weights = f"{tmp}/solvers_full_mmmot.npz"
    net = preset_net("full_mmmot", "cpu")
    save_npz(weights, to_flax_variables(net))
    del net
    for dead in ("camera", "lidar"):
        runs[f"dead_{dead}"] = dead_sensor_cli(root, tmp, weights, dead)
    return kern, {"agreement": agreement, "runs": runs, "gpu": smi}


def instance_entries(kern, solvers):
    """The kernel line's entries of the K=1, K=2 and avg instances (B=16
    bfloat16, with B=128 and float32 beside), each with its launches on
    the driven paths of phase 12 (c)."""
    runs = solvers["runs"]
    launches = {
        "K=1": {n: runs[n]["launches_by_k"][1]
                for n in ("fusion_C", "img_only", "lidar_only")},
        "K=2 dead camera": {"dead_camera": runs["dead_camera"][
            "launches_by_k"][2]},
        "K=2 dead lidar": {"dead_lidar": runs["dead_lidar"][
            "launches_by_k"][2]},
        "K=3 avg": {"avg": runs["avg"]["avg_launches"]}}
    keys = ("ms", "call_ms", "launch_ms", "plain_ms", "plain_call_ms",
            "library_ms", "library_call_ms", "bound_ms", "bound_by",
            "valid_pairs", "errs", "frame_pairs", "slots")
    out = []
    for label, _, branches, avg in INSTANCES:
        r = kern[label, torch.bfloat16, T]
        out.append({
            "name": f"fused_affinity[{label}]", "route": "cuda",
            "source": "mmmot_tpu_torch/csrc/affinity.cu",
            "replaces": "mmmot_tpu/kernels/affinity_kernel.py:206",
            "instance": f"branches {list(branches)}, avg={avg} "
                        "(affinity_kernel.py:121-148)",
            "launches": sum(launches[label].values()),
            "launches_by_path": launches[label],
            "max_abs_err": max(r["errs"][k] for k in ("link", "link_norm",
                                                      "new", "end")),
            **{k: r[k] for k in keys},
            "library_call": "torch.bmm [K, B*N*N, D] x [K, D, H] (the W1 "
                            "product alone, over all pairs)",
            "dtype": "bfloat16",
            "b128": {k: kern[label, torch.bfloat16, 128][k] for k in keys},
            "float32": {f"b{B}": {k: kern[label, torch.float32, B][k]
                                  for k in keys} for B in SOLVER_B}})
    return out


# Phase 13: the model variants and the rest of the fused kernel's
# instances.  (a) each correlation op, two and four ops (Dc = 4 * 512 =
# 2048, the op segments), the mean and softmax pools, the single and none
# modes, both runners' instances, and N=128 (the revival band of
# max_dets 64) against their plain version; (b) tiny float32 runners CPU
# against GPU for each variant, the two the kernel does not cover (new/end
# v1, a 3-layer link head: the module path, no launch) and the noisy
# revival stack at max_dets 64 (2N = 128 state slots); (c) two full-width
# variant runners on the tree, S=2, window 64, seed-0 weights.
ALL_OPS = ("mul", "subabs", "diff", "cosine")
# (label, ops, pool, mode, frame-pair counts)
VARIANT_INSTANCES = (
    ("mul", ("mul",), "max", "dual", SOLVER_B),
    ("diff", ("diff",), "max", "dual", SOLVER_B),
    ("cosine", ("cosine",), "max", "dual", SOLVER_B),
    ("subabs+mul", ("subabs", "mul"), "max", "dual", SOLVER_B),
    ("all four ops", ALL_OPS, "max", "dual", SOLVER_B),
    ("pool mean", ("subabs",), "mean", "dual", (T,)),
    ("pool softmax", ("subabs",), "softmax", "dual", (T,)),
    ("mode single", ("subabs",), "max", "single", (T,)),
    ("mode none", ("subabs",), "max", "none", (T,)),
    ("runner A", ("mul",), "softmax", "single", (T,)),
    ("runner B", ALL_OPS, "mean", "none", (T,)))
WIDE_N, WIDE_B = 2 * 64, (ENTRY_B, 2)   # N=128: the entry band, the scan
# Variant -> {model sub-config: {field: value}}; the tiny runners of (b)
# and, at full width, the first two as the runners of (c).
VARIANTS = {
    "A_tnet_mul": dict(fusion={"variant": "A"}, point={"use_tnet": True},
                       affinity={"correlation_ops": ("mul",),
                                 "softmax_mode": "single"},
                       new_end={"pool": "softmax"}),
    "B_all_ops": dict(fusion={"variant": "B"},
                      affinity={"correlation_ops": ALL_OPS,
                                "softmax_mode": "none"},
                      new_end={"pool": "mean"}),
    "no_single_cosine": dict(fusion={"keep_single": False},
                             affinity={"correlation_ops": ("cosine",)}),
    "v1": dict(new_end={"version": 1},
               affinity={"correlation_ops": ("diff",)}),
    "layers3": dict(affinity={"num_layers": 3,
                              "correlation_ops": ("subabs", "mul")})}


def variant_model(model, sections):
    """``model`` with fields of its sub-configs replaced."""
    import dataclasses

    return dataclasses.replace(model, **{
        k: dataclasses.replace(getattr(model, k), **v)
        for k, v in sections.items()})


def instance_of(model):
    """(ops, pool, mode) of a model config's fused-kernel instance."""
    return (tuple(model.affinity.correlation_ops), model.new_end.pool,
            model.affinity.softmax_mode)


def check_variant_instances(dev):
    """(a): each of ``VARIANT_INSTANCES`` at D=H=512, hh=256, N=32, then
    N=128, against its plain version in float32 and bfloat16, with holed
    masks and an empty frame, timed as phase 3 times K=3 (the library
    yardstick is ``torch.bmm`` on the W1 product at that Dc)."""
    gen = torch.Generator(device=dev).manual_seed(13)
    report, nets = {}, {}
    for label, ops, pool, mode, Bs in VARIANT_INSTANCES + (
            ("N=128", ("subabs",), "max", "dual", WIDE_B),):
        if ops not in nets:
            nets[ops] = init_random_(TrackingNet(variant_model(
                full_mmmot().model, {"affinity": {"correlation_ops": ops}}),
                device=dev), 0)
        for dtype in (torch.float32, torch.bfloat16):
            params = build_affinity_params(nets[ops], dtype)
            for B in Bs:
                inputs = (entry_band_inputs(dtype, gen, dev, B, n=WIDE_N)
                          if label == "N=128" else
                          affinity_inputs(dtype, gen, dev, B))
                report[label, dtype, B] = measure_kernel(
                    *inputs, params, dtype, f"{label} B={B}", ops=ops,
                    pool=pool, softmax_mode=mode)
                del inputs
            del params
    del nets
    torch.cuda.empty_cache()
    return report


@contextlib.contextmanager
def auction_inputs():
    """While open, each ``auction_lap`` call records, by device type, its
    costs [S, M, M] (float32, on the CPU) and its assignment."""
    import mmmot_tpu_torch.assoc.auction as auction_mod

    calls = {"cpu": [], "cuda": []}
    lap = auction_mod.auction_lap

    def recorded(cost, *args, **kw):
        rc, left = lap(cost, *args, **kw)
        calls[cost.device.type].append((cost.detach().float().cpu(),
                                        rc.cpu()))
        return rc, left

    recorded.rounds = lap.rounds   # the solver counts its rounds here
    try:
        with patched(auction_mod, "auction_lap", recorded):
            yield calls
    finally:
        lap.rounds = recorded.rounds


def auction_tie_report(calls_cpu, calls_gpu, what: str):
    """The first auction call whose assignment differs between the CPU's
    and the GPU's run (``calls_*``: (costs, assignment) in call order;
    later calls see states that differ).  For each of its instances that
    differ: the objective of each device's assignment (the sum of its
    rows' costs) under each device's costs.  Raises unless both
    assignments are optimal within ``TIE_GAP`` of each other under both
    costs (a near tie of the LP), or when no assignment differs; returns
    the call, the instances that differ and the largest gap."""
    for k, ((x, rx), (y, ry)) in enumerate(zip(calls_cpu, calls_gpu)):
        differ = torch.nonzero((rx != ry).any(-1))[:, 0].tolist()
        if not differ:
            continue

        def objective(cost, rc):
            rows = torch.arange(cost.shape[-1])[rc >= 0]
            return float(cost[rows, rc[rc >= 0].long()].double().sum())

        gaps = [max(abs(objective(c[i], rx[i]) - objective(c[i], ry[i]))
                    for c in (x, y)) for i in differ]
        if max(gaps) > TIE_GAP:
            raise AssertionError(f"{what}: auction call {k}: instances "
                                 f"{differ} differ by objective gaps {gaps}")
        return {"call": k, "instances": len(differ), "max_gap": max(gaps)}
    raise AssertionError(f"{what}: files differ, but every assignment of "
                         f"the {len(calls_cpu)} auction calls agrees")


def variant_agreement(root: str, dev, tmp: str):
    """(b): the tiny float32 runner CPU against GPU (first 20 frames,
    window 8, S=2), files byte-equal, for each of ``VARIANTS`` (the
    kernel's launches for those it covers, none for v1 and the 3-layer
    head; new/end output biases at -6 so that links win), or, where
    files differ, the first differing auction call a near tie of the LP
    (``auction_tie_report``, printed); then the noisy revival stack at
    max_dets 64, whose state holds 2N = 128 slots, with its N=128
    launches counted."""
    import mmmot_tpu_torch.tracker.tracker as trk_mod
    from mmmot_tpu_torch.kernels.affinity import kernel_supported

    out = {}
    for tag, sw in VARIANTS.items():
        model = variant_model(tiny_debug().model, sw)
        nets = {d: init_random_(TrackingNet(model, device=d), 7)
                for d in ("cpu", dev)}
        for net in nets.values():
            with torch.no_grad():
                for head in (net.new_end.new_mlp, net.new_end.end_mlp):
                    head.dense_1.bias.fill_(-6.0)
        with auction_inputs() as calls:
            out[tag] = runner_agreement(
                root, dev, tmp, nets, f"variants {tag}",
                tie_check=lambda: auction_tie_report(
                    calls["cpu"], calls["cuda"], tag))
        out[tag]["kernel"] = kernel_supported(model)
    widths = []

    def recorded(a, *args, **kw):
        if a.is_cuda:
            widths.append(a.shape[2])
        return fused_affinity(a, *args, **kw)

    with patched(trk_mod, "fused_affinity", recorded):
        out["noisy_max_dets_64"] = quality_agreement(root, dev, tmp,
                                                     max_dets=64)
    n128 = widths.count(WIDE_N)
    out["noisy_max_dets_64"]["n128_launches"] = n128
    if n128 == 0:
        raise AssertionError(f"noisy max_dets 64: no N=128 launch "
                             f"({sorted(set(widths))})")
    equal = sum(out[tag]["byte_equal"] for tag in VARIANTS)
    stage(f"variants agreement: {equal} of {len(VARIANTS)} tiny runners "
          f"byte-equal on CPU and GPU, the others a near tie; noisy revival "
          f"at max_dets 64: {n128} launches at N=128 of {len(widths)}")
    return out


def variant_runner(name: str, root: str, tmp: str, dev):
    """``full_mmmot`` with ``VARIANTS[name]`` at full width through
    ``track_kitti_sequences`` (S=2, the first window of 64 frames, the
    auction) under ``stage_timers`` (load, extract, affinity, kernel,
    auction, ids, window), with every count set to 0 just before and
    read just after: no detection dropped, finite scores, ids by the
    rules, one launch a window counted under its instance (ops, pool,
    mode); the kernel's output on that window's own inputs held against
    its plain version."""
    import dataclasses

    from mmmot_tpu_torch.kernels.affinity import reset_launches

    cfg = full_mmmot()
    model = variant_model(cfg.model, VARIANTS[name])
    net = init_random_(TrackingNet(model, device=dev), 0)
    mod = TrackingModule(net, cfg.assoc)
    data = dataclasses.replace(cfg.data, root=root)
    ops, pool, mode = instance_of(model)
    reset_launches()
    auction_lap.rounds = 0
    with stage_timers(mod) as (times, seen):
        stats = track_kitti_sequences(
            mod, data, f"{tmp}/{name}", window=RUNNER_WINDOW,
            batch_sequences=RUNNER_S, max_frames=CUT_FRAMES,
            evaluate=False)
    launches = {"ops": fused_affinity.op_launches[ops],
                "pool": fused_affinity.pool_launches[pool],
                "mode": fused_affinity.mode_launches[mode],
                "by_k": dict(fused_affinity.k_launches)}
    rounds = auction_lap.rounds
    K = len(net.score_branches)
    check_runner_run(stats, name, K, launches["by_k"])
    if {launches[k] for k in ("ops", "pool", "mode")} != {stats["n_windows"]}:
        raise AssertionError(f"{name}: launches {launches} for "
                             f"{stats['n_windows']} windows")
    times["load"] = stats["load_s"] * 1e3
    times["window"] = stats["window_s"][0] * 1e3
    a, b, mp, mc, params, bias = seen["args"]
    with torch.inference_mode():
        want = affinity_plain(a, b, mp, mc, params, bias, **seen["kw"])
        errs = check_agreement(seen["out"], want, a, b, mp, mc, params,
                               torch.bfloat16, f"{name} window", pool, mode)
    result = {"instance": {"ops": list(ops), "pool": pool, "mode": mode},
              "variant": VARIANTS[name], "K": K,
              "frames": stats["frames_loaded"], "windows": stats["n_windows"],
              "fps_window_1": window_fps(stats),
              "window_ms": [1e3 * x for x in stats["window_s"]],
              "load_s": stats["load_s"], "launches": launches,
              "auction_rounds": rounds, "split_ms": times,
              "split_kernel_vs_plain_max_err": errs,
              "split_frame_pairs": int(a.shape[0]),
              "detections": sum(int(o["det_mask"].sum())
                                for o in stats["outputs"].values())}
    stage(f"variant runner {name} {result['instance']}: {result['frames']} "
          f"frames, {result['windows']} window, "
          f"{result['fps_window_1']:.1f} FPS (window 1, warm-up included, "
          f"stages timed), windows {result['window_ms']} ms, "
          f"{rounds} auction rounds, launches {launches}, split "
          f"{times} ms, window kernel vs plain {errs}")
    del net, mod
    torch.cuda.empty_cache()
    return result


def variants_phase(dev, smi: str, root: str, tmp: str):
    """Phase 13: (a), (b) and (c) above; returns the kernel report of (a)
    and the ``{"variants": ...}`` result."""
    kern = check_variant_instances(dev)
    agreement = variant_agreement(root, dev, tmp)
    runs = {name: variant_runner(name, root, tmp, dev)
            for name in ("A_tnet_mul", "B_all_ops")}
    return kern, {"agreement": agreement, "runs": runs, "gpu": smi}


def variant_entries(kern, variants):
    """The kernel line's entries of the new instances (B=16 bfloat16, or
    the entry band's B=10 at N=128, with float32 beside), each with its
    launches on its driven path: runner A's instance (mul, softmax pool,
    single) and runner B's (all four ops, Dc=2048: the op segments and
    the cosine scales; mean pool, none) from (c), N=128 from (b)'s noisy
    revival run on the GPU.  Each op's, pool's and mode's own readings
    ride in runner B's ``instances``."""
    keys = ("ms", "call_ms", "launch_ms", "plain_ms", "plain_call_ms",
            "library_ms", "library_call_ms", "bound_ms", "bound_by",
            "valid_pairs", "errs", "frame_pairs", "slots")

    def at(label, dtype, B):
        return {k: kern[label, dtype, B][k] for k in keys}

    runs = variants["runs"]
    n128 = variants["agreement"]["noisy_max_dets_64"]["n128_launches"]
    out = []
    for label, what, launches, B in (
            ("runner A", "ops mul, pool softmax, mode single "
             "(affinity_kernel.py:56-57, :89-91, :167-168)",
             runs["A_tnet_mul"]["launches"]["ops"], T),
            ("runner B", "ops mul, subabs, diff, cosine (Dc=2048; "
             "affinity_kernel.py:53-64, :127-132), pool mean (:84-88), "
             "mode none (:163-164)", runs["B_all_ops"]["launches"]["ops"],
             T),
            ("N=128", "N=128, the revival band of max_dets 64 "
             "(affinity_kernel.py:231-235)", n128, ENTRY_B)):
        r = kern[label, torch.bfloat16, B]
        out.append({
            "name": f"fused_affinity[{label}]", "route": "cuda",
            "source": "mmmot_tpu_torch/csrc/affinity.cu",
            "replaces": "mmmot_tpu/kernels/affinity_kernel.py:206",
            "instance": what, "launches": launches,
            "max_abs_err": max(r["errs"][k] for k in ("link", "link_norm",
                                                      "new", "end")),
            **{k: r[k] for k in keys},
            "library_call": "torch.bmm [K, B*N*N, Dc] x [K, Dc, H] (the W1 "
                            "product alone, over all pairs)",
            "dtype": "bfloat16",
            "float32": at(label, torch.float32, B)})
    out[-1]["b2"] = at("N=128", torch.bfloat16, 2)
    out[1]["instances"] = {
        label: {f"{str(dt)[6:]}_b{B}": at(label, dt, B)
                for dt in (torch.bfloat16, torch.float32) for B in Bs}
        for label, _, _, _, Bs in VARIANT_INSTANCES}
    return out


# Phase 14: the slice past N=128 and the data-parallel path.  (a) the
# fused kernel at N = 144, 192, 256, 384 (launch 2's instance that
# streams its lines from device memory) at B=10 and B=2, float32 and
# bfloat16, with every pool and mode and the bias instance at N=192 B=2;
# B=16 N=32 and N=128 B=10 timed again beside them.
WIDE_NS = (144, 192, 256, 384)
WIDE_INSTANCES = (("pool mean", "mean", "dual", False),
                  ("pool softmax", "softmax", "dual", False),
                  ("mode single", "max", "single", False),
                  ("mode none", "max", "none", False),
                  ("link_bias", "max", "dual", True))


def wide_inputs(dtype, gen, dev, B, n, D=512):
    """B frame pairs at n slots, K=3: about 60 % of the previous and 70 %
    of the current slots valid, in holes across all n; pair 0 has an
    empty previous frame and pair 1 every slot valid on both sides, so
    that lines of n entries and the last ballot word are used."""
    a = torch.randn((B, 3, n, D), generator=gen, device=dev).to(dtype)
    b = torch.randn((B, 3, n, D), generator=gen, device=dev).to(dtype)
    mp = torch.rand((B, n), generator=gen, device=dev) < 0.6
    mc = torch.rand((B, n), generator=gen, device=dev) < 0.7
    mp[0] = False
    if B > 1:
        mp[1] = mc[1] = True
    return a, b, mp.contiguous(), mc.contiguous()


def check_wide_kernel(dev):
    """(a): ``full_mmmot``'s kernel instance at each of ``WIDE_NS`` for
    B=10 and B=2, float32 and bfloat16, then the other pools and modes
    and the bias instance at N=192 B=2, each against its plain version
    (every masked link exactly 0) and timed as phase 3; then B=16 N=32
    and the N=128 B=10 instance again, to show they did not move."""
    gen = torch.Generator(device=dev).manual_seed(14)
    net = init_random_(TrackingNet(full_mmmot().model, device=dev), 0)
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        params = build_affinity_params(net, dtype)
        for n in WIDE_NS:
            for B in (ENTRY_B, 2):
                report[n, dtype, B] = measure_kernel(
                    *wide_inputs(dtype, gen, dev, B, n), params, dtype,
                    f"N={n} B={B}")
        for label, pool, mode, bias in WIDE_INSTANCES:
            a, b, mp, mc = wide_inputs(dtype, gen, dev, 2, 192)
            lb = (torch.randn((2, 192, 192), generator=gen, device=dev)
                  if bias else None)
            report[label, dtype] = measure_kernel(
                a, b, mp, mc, params, dtype, f"N=192 B=2 {label}", bias=lb,
                pool=pool, softmax_mode=mode)
        report["B=16 N=32", dtype] = measure_kernel(
            *affinity_inputs(dtype, gen, dev, T), params, dtype,
            "again B=16 N=32")
        report["N=128", dtype] = measure_kernel(
            *entry_band_inputs(dtype, gen, dev, ENTRY_B, n=WIDE_N), params,
            dtype, f"again N=128 B={ENTRY_B}")
        del params
    del net
    torch.cuda.empty_cache()
    return report


WIDE_DETS = 96          # (b): max_dets 96, a 2N = 192 revival state


def count_widths(fn):
    """(fn's result, {N: launches}) with every launch of the fused kernel
    on the GPU during ``fn()`` counted by its slot count N."""
    import mmmot_tpu_torch.tracker.tracker as trk_mod

    widths = {}

    def recorded(a, *args, **kw):
        if a.is_cuda:
            widths[a.shape[2]] = widths.get(a.shape[2], 0) + 1
        return fused_affinity(a, *args, **kw)

    with patched(trk_mod, "fused_affinity", recorded):
        return fn(), widths


def wide_runner(root: str, dev, tmp: str, smi: str):
    """(b): ``full_mmmot_noisy`` at ``max_dets`` 96 through the runner, S=2,
    the first 64 frames of both sequences, at full width (seed-0
    weights, heads calibrated on the tree): its bands at N=96 and its
    entry band at N=192, the kernel's streaming instance; then a tiny
    float32 noisy runner at max_dets 96, CPU against GPU."""
    import dataclasses

    agreement, tiny_widths = count_widths(lambda: quality_agreement(
        root, dev, tmp, max_dets=WIDE_DETS))
    cfg = full_mmmot_noisy()
    data = dataclasses.replace(cfg.data, root=root, max_dets=WIDE_DETS)
    net = init_random_(TrackingNet(cfg.model, device=dev), 0)
    heads, _ = calibrate_heads(net, data, dev)
    mod = TrackingModule(net, cfg.assoc)
    fused_affinity.wide_launches = auction_lap.rounds = 0
    stats, widths = count_widths(lambda: track_kitti_sequences(
        mod, data, f"{tmp}/wide", window=RUNNER_WINDOW,
        batch_sequences=RUNNER_S, max_frames=RUNNER_WINDOW, evaluate=False))
    wide = fused_affinity.wide_launches
    if widths.get(2 * WIDE_DETS, 0) == 0 or wide != widths[2 * WIDE_DETS]:
        raise AssertionError(f"wide runner: launches by N {widths}, "
                             f"{wide} of the streaming instance")
    if stats["n_dropped"]:
        raise AssertionError(f"wide runner: n_dropped {stats['n_dropped']}")
    for seq, o in stats["outputs"].items():
        check_quality_ids(o["ids"], o["det_mask"], QUALITY_K)
    counts = quality_counts(stats["outputs"], QUALITY_K)
    out = {"max_dets": WIDE_DETS, "frames": stats["frames_loaded"],
           "window_ms": [1e3 * x for x in stats["window_s"]],
           "load_s": stats["load_s"], "launches_by_n": widths,
           "wide_launches": wide, "auction_rounds": auction_lap.rounds,
           **counts, "heads": heads,
           "tiny_agreement": dict(agreement, launches_by_n=tiny_widths)}
    del net, mod
    torch.cuda.empty_cache()
    stage(f"(b) full_mmmot_noisy at max_dets {WIDE_DETS}: windows "
          f"{out['window_ms']} ms, launches by N {widths} ({wide} streaming), "
          f"{auction_lap.rounds} auction rounds, {counts}; tiny f32 at "
          f"max_dets {WIDE_DETS} files equal CPU and GPU, launches by N "
          f"{tiny_widths}, on {smi}")
    return out


def box3d_runner(root: str, dev, tmp: str, smi: str):
    """(c): ``point_source="box3d"``: the tiny float32 runner CPU against
    GPU (files byte-equal), then ``full_mmmot`` at full width through
    the runner (S=2, the first 64 frames), with the detections whose 3D
    box holds points of the scan counted."""
    import dataclasses

    from mmmot_tpu_torch.data.kitti_dataset import KittiTrackingDataset
    from mmmot_tpu_torch.ops.frustum import box3d_sample

    tiny = dataclasses.replace(tiny_debug().data, root=root,
                               point_source="box3d")
    files = {}
    for device in ("cpu", dev):
        out = f"{tmp}/box3d_agree_{torch.device(device).type}"
        stats = track_kitti_sequences(
            TrackingModule(agreement_net(device)), tiny, out,
            window=AGREE_WINDOW, batch_sequences=RUNNER_S,
            max_frames=AGREE_FRAMES)
        files[device] = result_files(out)
    if files["cpu"] != files[dev] or len(files["cpu"]) < 4:
        raise AssertionError("box3d tiny runner: files differ between the "
                             "CPU and the GPU")
    data = dataclasses.replace(full_mmmot().data, root=root,
                               point_source="box3d")
    net = init_random_(TrackingNet(full_mmmot().model, device=dev), 0)
    fused_affinity.launches = 0
    stats = track_kitti_sequences(
        TrackingModule(net), data, f"{tmp}/box3d", window=RUNNER_WINDOW,
        batch_sequences=RUNNER_S, max_frames=RUNNER_WINDOW)
    if stats["n_dropped"] or fused_affinity.launches != stats["n_windows"]:
        raise AssertionError(f"box3d runner: {stats['n_dropped']} dropped, "
                             f"{fused_affinity.launches} launches")
    for seq, o in stats["outputs"].items():
        check_ids(torch.as_tensor(o["ids"]), torch.as_tensor(o["det_mask"]))
    a = KittiTrackingDataset(data, max_cloud_points=32768).load_sequence(
        "0000", max_frames=RUNNER_WINDOW)
    _, m = box3d_sample(*(torch.as_tensor(x, device=dev) for x in (
        a.clouds, a.boxes3d)), data.point_len,
        torch.as_tensor(a.velo_to_rect, device=dev),
        torch.as_tensor(a.det_mask, device=dev),
        torch.as_tensor(a.cloud_valid, device=dev))
    with_pts = int(m.any(-1).sum())
    n_det = int(a.det_mask.sum())
    if with_pts < n_det // 2:
        raise AssertionError(f"box3d: {with_pts} of {n_det} boxes hold "
                             "points of the scan")
    out = {"tiny_files_equal": sorted(files["cpu"]),
           "window_ms": [1e3 * x for x in stats["window_s"]],
           "launches": fused_affinity.launches,
           "mota_random_weights": stats["metrics"].mota,
           "detections_with_points": [with_pts, n_det]}
    del net
    torch.cuda.empty_cache()
    stage(f"(c) box3d: tiny runner files equal CPU and GPU; full_mmmot "
          f"windows {out['window_ms']} ms, {out['launches']} launches, "
          f"{with_pts} of {n_det} boxes of 0000 hold points, on {smi}")
    return out


def packed_runner(root: str, dev, tmp: str, smi: str):
    """(d): ``full_mmmot`` over the whole tree twice with the packed cache
    (the first run packs each sequence, the second memory-maps it): files
    equal to each other and to phase 6's run of the same seed-0 weights
    without the cache (the same groups, windows and capacity); each
    run's load and decode time."""
    import dataclasses
    import os

    data = dataclasses.replace(full_mmmot().data, root=root,
                               packed_cache=True)
    net = init_random_(TrackingNet(full_mmmot().model, device=dev), 0)
    runs = []
    for k in range(2):
        stats = track_kitti_sequences(TrackingModule(net), data,
                                      f"{tmp}/packed{k}",
                                      window=RUNNER_WINDOW,
                                      batch_sequences=RUNNER_S)
        runs.append({"load_s": stats["load_s"],
                     "decode_s": stats["decode_s"],
                     "files": result_files(f"{tmp}/packed{k}")})
    if runs[0]["files"] != runs[1]["files"]:
        raise AssertionError("packed cache: the memory-mapped run's files "
                             "differ from the packing run's")
    if runs[1]["decode_s"] != 0.0:
        raise AssertionError("packed cache: the second run decoded PNGs")
    plain = result_files(f"{tmp}/full") if os.path.isdir(f"{tmp}/full") \
        else None
    if plain is not None and plain != runs[0]["files"]:
        raise AssertionError("packed cache: files differ from phase 6's "
                             "run without the cache")
    out = {"load_s": [r["load_s"] for r in runs],
           "decode_s": [r["decode_s"] for r in runs],
           "files": sorted(runs[0]["files"]),
           "equal_to_uncached_run": plain is not None}
    del net
    torch.cuda.empty_cache()
    stage(f"(d) packed cache: load {out['load_s']} s (PNG decode "
          f"{out['decode_s']} s), files equal across the runs"
          + (" and to phase 6's" if plain is not None else "")
          + f", on {smi}")
    return out


def per_slot_phase(dev, smi: str):
    """(e): the per-slot branch (``compact_capacity=None``): the tiny
    float32 ids CPU against GPU, then the main path's T=16 frames
    (phase 5's inputs) at full width, timed warm."""
    cfg = tiny_debug()
    gen = torch.Generator().manual_seed(5)
    frames = synthetic_frames(gen, "cpu", 6, 96, 320, 512, 8, 2, 9)
    ids = {}
    for device in ("cpu", dev):
        out = track_sequence_from_frames(
            TrackingModule(agreement_net(device)),
            *(x.to(device) for x in frames), (32, 32),
            cfg.model.point.point_len)
        ids[device] = out["ids"].cpu()
        check_ids(out["ids"], frames[3].to(device))
    if not torch.equal(ids["cpu"], ids[dev]):
        raise AssertionError("per-slot tiny ids differ between CPU and GPU")
    full = full_mmmot()
    net = init_random_(TrackingNet(full.model, device=dev), 0)
    gen = torch.Generator(device=dev).manual_seed(42)
    images, clouds, boxes, det_mask, proj = synthetic_frames(
        gen, dev, T, H_IMG, W_IMG, M_PTS, N, 6, 19)
    mod = TrackingModule(net)

    def run():
        return track_sequence_from_frames(
            mod, images, clouds, boxes, det_mask, proj,
            full.model.appearance.crop_size, full.model.point.point_len)

    run()
    fused_affinity.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    check_ids(out["ids"], det_mask)
    ms = 1e3 * (time.perf_counter() - t0)
    if fused_affinity.launches != 1 or int(out["n_dropped"]) != 0:
        raise AssertionError(f"per slot: {fused_affinity.launches} launches, "
                             f"{int(out['n_dropped'])} dropped")
    res = {"tiny_ids_equal": True, "frames": T, "slots": T * N,
           "detections": int(det_mask.sum()), "warm_ms": ms,
           "fps": T / ms * 1e3}
    del net, mod
    torch.cuda.empty_cache()
    stage(f"(e) per-slot branch: tiny ids equal CPU and GPU; full width "
          f"T={T}: {T * N} slots extracted, {ms:.1f} ms warm "
          f"({res['fps']:.1f} FPS), on {smi}")
    return res


def synthetic_cli(tmp: str, smi: str):
    """(f): ``cli/track`` with no tree: 2 synthetic sequences of 16 frames
    at full width on the GPU, files written and scored."""
    from mmmot_tpu_torch.cli.track import main as track_main

    fused_affinity.launches = 0
    stats = track_main(["--config", "full_mmmot", "--data-root",
                        f"{tmp}/no_tree", "--sequences", "2", "--frames",
                        "16", "--result-path", f"{tmp}/synthetic"])
    if stats["n_sequences"] != 2 or fused_affinity.launches != 2:
        raise AssertionError(f"synthetic cli: {stats['n_sequences']} "
                             f"sequences, {fused_affinity.launches} launches")
    out = {"sequences": 2, "frames": 16, "fps": stats["fps"],
           "launches": fused_affinity.launches,
           "mota_random_weights": stats["metrics"].mota,
           "files": [f.rsplit("/", 1)[-1] for f in stats["files"]]}
    stage(f"(f) synthetic cli/track: {out}, on {smi}")
    return out


def parallel_phase(smi: str):
    """(g): the port's data-parallel dry run (``parallel/dryrun.py``) with
    two ranks sharing the card over gloo (NCCL refuses two ranks on one
    device), tiny and at full width, then NCCL at world size 1; each
    raises unless the gathered ids equal one process's, the step is
    within the reference's tolerances and its parameters moved, their
    change as close to one process's as ``dryrun.check`` asks (relative
    norm: 1e-3, or twice one process's with the batch in another order).  The full-width run is
    ``full_mmmot`` in float32 (TF32 off), a B=4 step split 2 + 2, each
    step extracting its own valid rows: in bfloat16 the two orders of
    the BatchNorm sums and cuDNN's kernels for 2 pairs or 4 round
    activations apart, which moved the loss by 7.5e-4 relative (dev run
    of this phase), past 1e-4, with nothing but rounding between them."""
    import dataclasses

    from mmmot_tpu_torch.parallel.dryrun import dryrun

    stage("(g) NCCL refuses two ranks on one device: two ranks share the "
          "card over gloo (broadcast and all-reduce on CUDA tensors; the "
          "all-gather of ids and parameters staged through the host)")
    full = full_mmmot()
    full_f32 = dataclasses.replace(full, model=dataclasses.replace(
        full.model, compute_dtype="float32"))
    out = {}
    for label, n, backend, cfg, cap in (
            ("gloo2_tiny", 2, "gloo", tiny_debug(), 0),
            ("gloo2_full_f32", 2, "gloo", full_f32, -1),
            ("nccl1_tiny", 1, "nccl", tiny_debug(), 0)):
        t0 = time.perf_counter()
        found = dryrun(n, backend, "cuda:0", cfg, B=4 if n == 2 else 2,
                       compact_capacity=cap)
        r = {"seconds": time.perf_counter() - t0,
             "train": found["train"], "norm": found["norm"],
             "tracking_ms": {leg: [v["ms"], v["ms_single"]]
                             for leg, v in found["tracking"].items()},
             "ids_equal": True}
        out[label] = r
        stage(f"(g) {label}: ids equal to one process on every leg, SGD "
              f"step's parameters {r['train']['param_max_diff']:.3g} from "
              f"one process's (largest move "
              f"{r['train']['param_moved']:.3g}; the change "
              f"{r['train']['param_err']:.3g} apart, relative norm, one "
              f"process in another order "
              f"{r['train']['param_floor']:.3g}), loss "
              f"{r['train']['loss']:.6f} vs {r['train']['loss_single']:.6f},"
              f" grad norm {r['train']['grad_norm']:.5f} vs "
              f"{r['train']['grad_norm_single']:.5f}, step "
              f"{r['train']['ms']:.1f} vs {r['train']['ms_single']:.1f} ms, "
              f"tracking ms (sharded, one process) {r['tracking_ms']}, "
              f"{r['seconds']:.1f} s, on {smi}")
    return out


def phase14(dev, smi: str, root: str, tmp: str):
    """Phase 14: (a) the kernel past N=128; (b)-(f) the raw path's
    options; (g) data parallelism.  Returns (the kernel report of (a),
    the ``{"phase14": ...}`` result)."""
    t0 = time.perf_counter()
    kern = check_wide_kernel(dev)
    stage(f"(a) the kernel at N = {WIDE_NS} against its plain version, on "
          f"{smi}")
    res = {"wide_runner": wide_runner(root, dev, tmp, smi),
           "box3d": box3d_runner(root, dev, tmp, smi),
           "packed_cache": packed_runner(root, dev, tmp, smi),
           "per_slot": per_slot_phase(dev, smi),
           "synthetic_cli": synthetic_cli(tmp, smi),
           "parallel": parallel_phase(smi), "gpu": smi}
    res["seconds"] = time.perf_counter() - t0
    stage(f"phase 14: {res['seconds']:.1f} s on {smi}")
    return kern, res


def wide_entry(kern, launches: int):
    """The kernel line's entry of the streaming instance (N > 128): the
    entry band's shape at max_dets 96 (B=10, N=192) in bfloat16, with
    B=2, N=144, 256 and 384, float32, the other pools and modes and the bias
    instance beside, and B=16 N=32 and N=128 B=10 timed again."""
    keys = ("ms", "call_ms", "launch_ms", "plain_ms", "plain_call_ms",
            "library_ms", "library_call_ms", "bound_ms", "bound_by",
            "valid_pairs", "errs", "frame_pairs", "slots")

    def at(*key):
        return {k: kern[key][k] for k in keys}

    r = kern[192, torch.bfloat16, ENTRY_B]
    return {
        "name": "fused_affinity[N>128]", "route": "cuda",
        "source": "mmmot_tpu_torch/csrc/affinity.cu",
        "replaces": "mmmot_tpu/kernels/affinity_kernel.py:206",
        "instance": "N above 128 (affinity_kernel.py:229-235): "
                    "finish_kernel<T, bias, 16> streams its lines from "
                    "the link in device memory",
        "launches": launches,
        "max_abs_err": max(r["errs"][k] for k in ("link", "link_norm",
                                                  "new", "end")),
        **{k: r[k] for k in keys},
        "library_call": "torch.bmm [K, B*N*N, D] x [K, D, H] (the W1 "
                        "product alone, over all pairs)",
        "dtype": "bfloat16",
        "shapes": {f"{str(dt)[6:]}_n{n}_b{B}": at(n, dt, B)
                   for n in WIDE_NS for B in (ENTRY_B, 2)
                   for dt in (torch.bfloat16, torch.float32)},
        "instances_n192_b2": {f"{label}_{str(dt)[6:]}": at(label, dt)
                              for label, *_ in WIDE_INSTANCES
                              for dt in (torch.bfloat16, torch.float32)},
        "again": {f"{label}_{str(dt)[6:]}": at(label, dt)
                  for label in ("B=16 N=32", "N=128")
                  for dt in (torch.bfloat16, torch.float32)}}


# Phase 15: the last modules.  (a) the int8 conv at the space-to-depth
# stem's shape (conv_0 [32, 112, 112, 12] -> 64, the stem instance) and
# the s2d trunk's 13 layers as it runs them, then the s2d int8 runner's
# largest chunk; (b) tiny float32 runners of the VGG variants, CPU
# against GPU; (c) full-width variant runners over the first window;
# (d) the train CLI with DropBlock and --pretrained-vgg; (e) a variant
# served from its artifact.
S2D_CROPS = 32
# The s2d int8 trunk's launches an extraction: conv_0 on the stem
# instance (Cin 12), conv_1 to conv_12 on the main one, the pool fused
# after conv_3, 6, 9 and 12 (the s2d relayout replaces the first pool).
S2D_INT8_BY_KIND = {"launches": 13, "main_launches": 12,
                    "stem_launches": 1, "pool_launches": 4}
# (label, appearance fields, model fields, int8 trunk)
P15_TINY = (("no_bn", {"batch_norm": False}, {}, False),
            ("last_stage", {"skip_pool": False}, {}, False),
            ("s2d", {"s2d_stem": True}, {}, False),
            ("s2d_int8", {"s2d_stem": True}, {}, True),
            ("bf16_params", {}, {"param_dtype": "bfloat16"}, False))
P15_TRAIN_STEPS = 3
P15_SERVE_FRAMES = 20
# torchvision's vgg16_bn ``features``: the conv indices (BatchNorm at
# index + 1), and the VGG16 widths.
VGG16_FEATURES = (0, 3, 7, 10, 14, 17, 20, 24, 27, 30, 34, 37, 40)
VGG16_WIDTHS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512,
                512)


def variant_config(cfg, name=None, model=None, **appearance):
    """``cfg`` with fields of its appearance section (and of its model
    section, ``model``) replaced, named ``name``."""
    import dataclasses

    m = dataclasses.replace(cfg.model, appearance=dataclasses.replace(
        cfg.model.appearance, **appearance), **(model or {}))
    return dataclasses.replace(cfg, name=name or cfg.name, model=m)


def p15_tie_check(tmp: str, tag: str, calls):
    """Where a tiny variant's CPU and GPU files differ: the same rows with
    scores within the float32 tolerance (``results_match``), or else the
    first differing auction call a near tie (``auction_tie_report``)."""
    import os

    a, b = (result_files(os.path.join(tmp, f"{tag}_agree_{d}"))
            for d in ("cpu", "cuda"))
    try:
        return {"score_rows": results_match(a, b, tag)}
    except AssertionError as e:
        stage(f"{tag}: {e}")
        return auction_tie_report(calls["cpu"], calls["cuda"], tag)


def p15_agreement(root: str, dev, tmp: str):
    """(b) ``runner_agreement`` on tiny float32 nets of the variants,
    seeded as ``agreement_net`` (files byte-equal, or where they differ
    ``p15_tie_check``); the s2d int8 trunk calibrated once on the tree on
    the CPU and moved to the GPU, whose run must launch the stem
    instance."""
    import copy
    import dataclasses

    from mmmot_tpu_torch.kernels import int8_conv
    from mmmot_tpu_torch.models.quantize import quantize_for_inference

    out = {}
    for label, app, model, int8 in P15_TINY:
        cfg = variant_config(tiny_debug(), model=model, **app)
        nets = {}
        for device in ("cpu", dev):
            nets[device] = init_random_(TrackingNet(cfg.model,
                                                    device=device), 7)
            with torch.no_grad():
                for head in (nets[device].new_end.new_mlp,
                             nets[device].new_end.end_mlp):
                    head.dense_1.bias.fill_(-3.0)
        if int8:
            quantize_for_inference(nets["cpu"], dataclasses.replace(
                cfg.data, root=root))
            nets[dev].quant_int8 = copy.deepcopy(
                nets["cpu"].quant_int8).to(dev)
        int8_conv.reset_launches()
        tag = f"p15_{label}"
        with auction_inputs() as calls:
            out[label] = runner_agreement(
                root, dev, tmp, nets, tag, tie_check=lambda: p15_tie_check(
                    tmp, tag, calls))
        out[label]["int8_launches"] = int8_conv.launch_counts()
        if int8 and not out[label]["int8_launches"]["stem_launches"]:
            raise AssertionError(f"p15 {label}: no stem instance launch")
    return out


def p15_runner(net, data, tmp: str, label: str):
    """(c) ``net`` through ``track_kitti_sequences`` over the first
    window (S=2, 64 frames) under ``stage_timers``, with every count set
    to 0 just before and read just after: one affinity launch, the int8
    conv's launches by instance (13 an extraction with an s2d int8
    trunk, none without one), no detection dropped, finite scores, ids
    by the rules; the window's kernel output held against its plain
    version.  With an int8 trunk the largest extraction chunk is kept
    for ``int8_chunk_check``."""
    from mmmot_tpu_torch.kernels import int8_conv
    from mmmot_tpu_torch.models import tracking_net

    mod = TrackingModule(net)
    calls, chunk = [0], {}
    extract = TrackingNet.extract
    apply = tracking_net.quantized_appearance_apply

    def counted(self, *args, **kw):
        calls[0] += 1
        return extract(self, *args, **kw)

    def captured(quant, appear_net, crops, mask, dtype):
        x = crops.reshape((-1,) + tuple(crops.shape[-3:]))
        if len(x) > len(chunk.get("crops", ())):
            chunk.update(crops=x.clone(), mask=mask.reshape(-1).clone(),
                         quant=quant)
        return apply(quant, appear_net, crops, mask, dtype)

    fused_affinity.launches = 0
    int8_conv.reset_launches()
    auction_lap.rounds = 0
    with patched(TrackingNet, "extract", counted), \
            patched(tracking_net, "quantized_appearance_apply", captured), \
            stage_timers(mod) as (times, seen):
        stats = track_kitti_sequences(
            mod, data, f"{tmp}/p15_{label}", window=RUNNER_WINDOW,
            batch_sequences=RUNNER_S, max_frames=CUT_FRAMES, evaluate=False)
    counts, launches = int8_conv.launch_counts(), fused_affinity.launches
    rounds = auction_lap.rounds
    int8 = net.quant_int8 is not None
    want = {k: v * calls[0] * int8 for k, v in S2D_INT8_BY_KIND.items()}
    if launches != stats["n_windows"] or stats["n_windows"] != 1 \
            or counts != want or not calls[0]:
        raise AssertionError(f"p15 {label}: {launches} affinity launches "
                             f"for {stats['n_windows']} windows, int8 "
                             f"{counts} for {calls[0]} extractions")
    if stats["n_dropped"] != 0:
        raise AssertionError(f"p15 {label}: n_dropped {stats['n_dropped']}")
    for seq, o in stats["outputs"].items():
        if not np.isfinite(o["det_score"]).all():
            raise AssertionError(f"p15 {label} {seq}: non-finite scores")
        check_ids(torch.as_tensor(o["ids"]), torch.as_tensor(o["det_mask"]))
    a, b, mp, mc, params, _ = seen["args"]
    with torch.inference_mode():
        errs = check_agreement(seen["out"], affinity_plain(
            a, b, mp, mc, params), a, b, mp, mc, params, torch.bfloat16,
            f"p15 {label} window")
    times["load"] = stats["load_s"] * 1e3
    times["window"] = stats["window_s"][0] * 1e3
    result = {"frames": stats["frames_loaded"], "windows": stats["n_windows"],
              "S": RUNNER_S, "fps_window_1": window_fps(stats),
              "window_ms": [1e3 * x for x in stats["window_s"]],
              "split_ms": times, "extractions": calls[0],
              "launches": {"fused_affinity": launches,
                           "int8_conv3x3_requant": counts["launches"]},
              "int8_launches_by_kind": counts, "auction_rounds": rounds,
              "window_kernel_vs_plain_max_err": errs,
              "detections": sum(int(o["det_mask"].sum())
                                for o in stats["outputs"].values())}
    stage(f"p15 runner {label}: {result['frames']} frames, 1 window of "
          f"{RUNNER_WINDOW} x S={RUNNER_S}, {result['fps_window_1']:.1f} FPS "
          f"(window 1, warm-up included, stages timed), split of window 1 "
          f"{times} ms, launches {result['launches']}, int8 by instance "
          f"{counts} over {calls[0]} extractions, {rounds} auction rounds, "
          f"window kernel vs plain {errs}")
    return result, chunk


def p15_serving(net, cfg, root: str, tmp: str, dev):
    """(e) ``export_serve_step`` of ``net`` under ``cfg`` (a name no
    preset has), ``DeployedTracker.load`` from the manifest's own config,
    then 20 frames of sequence 0000 (full scans): one affinity launch a
    frame, finite scores, ids by the rules, latency p50/p90 after 3 warm
    frames."""
    import dataclasses

    from mmmot_tpu_torch.data.kitti_dataset import KittiTrackingDataset
    from mmmot_tpu_torch.deploy import DeployedTracker, export_serve_step

    art = f"{tmp}/p15_{cfg.name}"
    t = time.perf_counter()
    export_serve_step(art, cfg, TrackingModule(net, cfg.assoc),
                      (KITTI_H, KITTI_W), CLOUD_POINTS)
    trk = DeployedTracker.load(art, device=dev)
    load_s = time.perf_counter() - t
    if trk.module.net.cfg != cfg.model or trk.manifest["config"] != cfg.name:
        raise AssertionError(f"p15 serving: the artifact loaded "
                             f"{trk.manifest['config']}, not {cfg.name}")
    data = dataclasses.replace(cfg.data, root=root, cloud_filter="none")
    a = KittiTrackingDataset(data, max_cloud_points=CLOUD_POINTS
                             ).load_sequence("0000",
                                             max_frames=P15_SERVE_FRAMES)
    frames = tree_frames(a)
    ids = np.full(a.det_mask.shape, -1, np.int64)
    ms = []
    fused_affinity.launches = 0
    for t, (image, cloud, boxes, dm, proj) in enumerate(frames):
        t0 = time.perf_counter()
        got, scores = trk.step(image, cloud, boxes[dm], proj)
        ms.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(scores).all():
            raise AssertionError(f"p15 serve frame {t}: non-finite scores")
        ids[t, :len(got)] = got
    if fused_affinity.launches != len(frames):
        raise AssertionError(f"p15 serving: {fused_affinity.launches} "
                             f"launches for {len(frames)} frames")
    check_ids(torch.as_tensor(ids), torch.as_tensor(a.det_mask))
    lat = percentiles(ms[SERVE_WARM:])
    stage(f"p15 serving {cfg.name}: export + load {load_s:.1f} s, "
          f"{len(frames)} frames through DeployedTracker, latency after "
          f"{SERVE_WARM} warm frames {lat} ms, 1 launch a frame")
    return {"config": cfg.name, "export_and_load_s": load_s,
            "frames": len(frames), "latency_ms": lat,
            "latency_first_ms": ms[:SERVE_WARM],
            "launches": fused_affinity.launches}


def p15_serving_agreement(tmp: str, dev):
    """(e) A tiny float32 variant (s2d, no BatchNorm) exported on the
    CPU under a name no preset has, served by ``DeployedTracker`` on the
    CPU and on the GPU over a synthetic scene: the same ids."""
    cfg = variant_config(tiny_debug(), "tiny_s2d_no_bn", s2d_stem=True,
                         batch_norm=False)
    net = init_random_(TrackingNet(cfg.model, device="cpu"), 7)
    with torch.no_grad():
        for head in (net.new_end.new_mlp, net.new_end.end_mlp):
            head.dense_1.bias.fill_(-3.0)
    from mmmot_tpu_torch.deploy import DeployedTracker, export_serve_step

    art = f"{tmp}/p15_tiny_variant"
    export_serve_step(art, cfg, TrackingModule(net), (96, 320), 512)
    gen = torch.Generator().manual_seed(11)
    im, cl, bx, dm, pj = synthetic_frames(gen, "cpu", 6, 96, 320, 512,
                                          cfg.data.max_dets, 2, 9)
    ids = {}
    for device in ("cpu", dev):
        trk = DeployedTracker.load(art, device=device)
        with f32_parity():
            ids[device] = [trk.step(im[t].numpy(), cl[t].numpy(),
                                    bx[t][dm[t]].numpy(), pj.numpy())[0]
                           for t in range(len(im))]
    if ids["cpu"] != ids[dev]:
        raise AssertionError(f"p15 tiny variant artifact: ids {ids['cpu']} "
                             f"on the CPU, {ids[dev]} on the GPU")
    stage(f"p15 serving agreement: tiny {cfg.name} artifact, ids equal on "
          f"CPU and GPU over {len(im)} frames")
    return {"config": cfg.name, "frames": len(im), "ids": ids["cpu"]}


def write_vgg16_bn(path: str, seed: int = 5):
    """A torchvision ``vgg16_bn`` features state dict (its names, shapes
    and dtypes; random values from ``seed``) written with
    ``torch.save``."""
    gen = torch.Generator().manual_seed(seed)
    sd, cin = {}, 3
    for idx, c in zip(VGG16_FEATURES, VGG16_WIDTHS):
        sd[f"features.{idx}.weight"] = torch.randn(
            c, cin, 3, 3, generator=gen) * (2.0 / (9 * cin)) ** 0.5
        sd[f"features.{idx}.bias"] = 0.1 * torch.randn(c, generator=gen)
        bn = f"features.{idx + 1}"
        sd[f"{bn}.weight"] = 0.8 + 0.4 * torch.rand(c, generator=gen)
        sd[f"{bn}.bias"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{bn}.running_mean"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{bn}.running_var"] = 0.5 + torch.rand(c, generator=gen)
        sd[f"{bn}.num_batches_tracked"] = torch.tensor(0)
        cin = c
    torch.save(sd, path)
    return sd


def p15_training(root: str, tmp: str, smi: str):
    """(d) The train CLI at full width (``full_mmmot``, B=4) with
    DropBlock on every stage map and ``--pretrained-vgg`` on a written
    ``vgg16_bn`` features state dict: before the first step every trunk
    tensor equals the one written; each step draws the five DropBlock
    masks (counted) and keeps a finite loss (``train_cli_run``)."""
    from mmmot_tpu_torch.models.layers import DropBlock2D

    pth = f"{tmp}/vgg16_bn.pth"
    sd = write_vgg16_bn(pth)
    checked = []

    def first_step(state):
        own = state.net.state_dict()
        for ci, idx in enumerate(VGG16_FEATURES):
            for mine, theirs in ((f"conv_{ci}", idx), (f"bn_{ci}", idx + 1)):
                for leaf in ("weight", "bias", "running_mean",
                             "running_var"):
                    key = f"features.{theirs}.{leaf}"
                    if key not in sd:
                        continue
                    got = own[f"appear_net.backbone.{mine}.{leaf}"]
                    if not torch.equal(got.cpu(), sd[key]):
                        raise AssertionError(f"p15 pretrained: {key} not "
                                             "loaded as written")
                    checked.append(key)

    draws = [0]
    draw = DropBlock2D.draw

    def counted(self, *a, **kw):
        draws[0] += 1
        return draw(self, *a, **kw)

    cfg = variant_config(full_mmmot(), dropblock=True)
    with patched(DropBlock2D, "draw", counted):
        out = train_cli_run(cfg, "p15_dropblock", root, tmp, 1,
                            P15_TRAIN_STEPS, smi,
                            extra_args=("--pretrained-vgg", pth),
                            first_step=first_step)
    n_steps = 1 + P15_TRAIN_STEPS
    if len(checked) != 6 * len(VGG16_FEATURES) or draws[0] != 5 * n_steps:
        raise AssertionError(f"p15 training: {len(checked)} tensors checked, "
                             f"{draws[0]} DropBlock draws in {n_steps} steps")
    if out["pretrained_vgg"]["unexpected_unused"]:
        raise AssertionError(f"p15 pretrained: {out['pretrained_vgg']}")
    out["pretrained_tensors_checked"] = len(checked)
    out["dropblock_draws"] = draws[0]
    del out["pretrained_vgg"]["converted"]
    return out


def phase15(dev, smi: str, root: str, tmp: str):
    """Phase 15: (a)-(e) above; returns the stem layer's report and the
    ``{"phase15": ...}`` result."""
    import dataclasses

    from mmmot_tpu_torch.models.quantize import quantize_for_inference

    t0 = time.perf_counter()
    out = {"agreement": p15_agreement(root, dev, tmp)}
    s2d = variant_config(full_mmmot(), "full_mmmot_s2d", s2d_stem=True)
    data = dataclasses.replace(s2d.data, root=root)
    net = init_random_(TrackingNet(s2d.model, device=dev), 0)
    quantize_for_inference(net, data)
    quant = net.quant_int8
    crops = real_crops(root, dev, S2D_CROPS, s2d.model.appearance.crop_size)
    kernel = int8_kernel_check(quant, crops)
    del crops
    torch.cuda.empty_cache()
    stem = kernel["layers"][0]
    h, w = s2d.model.appearance.crop_size
    if (stem["layer"], stem["n"], stem["hw"], stem["cin"], stem["cout"],
            stem["plan"]["instance"]) != (
                "conv_0", S2D_CROPS, [h // 2, w // 2], 12,
                quant.layer(0)[0].shape[0], "stem"):
        raise AssertionError(f"p15 (a): conv_0 ran as {stem}")
    net.quant_int8 = None
    runs = {"s2d_bf16": p15_runner(net, data, tmp, "s2d_bf16")[0]}
    out["serving"] = p15_serving(net, s2d, root, tmp, dev)
    net.quant_int8 = quant
    runs["s2d_int8"], chunk = p15_runner(net, data, tmp, "s2d_int8")
    del net
    torch.cuda.empty_cache()
    chunk_report = int8_chunk_check(chunk.pop("quant"), chunk)
    del chunk, quant
    torch.cuda.empty_cache()
    plain = variant_config(full_mmmot(), "full_mmmot_no_bn_last_stage",
                           batch_norm=False, skip_pool=False)
    net = init_random_(TrackingNet(plain.model, device=dev), 0)
    runs["no_bn_last_stage"] = p15_runner(net, data, tmp,
                                          "no_bn_last_stage")[0]
    del net
    torch.cuda.empty_cache()
    out["runs"] = runs
    out["training"] = p15_training(root, tmp, smi)
    torch.cuda.empty_cache()
    out["serving_agreement"] = p15_serving_agreement(tmp, dev)
    out.update(kernel=kernel, runner_chunk=chunk_report, gpu=smi,
               seconds=time.perf_counter() - t0)
    stage(f"phase 15: {out['seconds']:.1f} s on {smi}")
    return stem, out


def stem_entry(stem, p15):
    """The kernel line's entry of the int8 conv's stem instance at the
    s2d stem's conv_0, [32, 112, 112, 12] -> 64, with its launches on
    phase 15 (c)'s s2d int8 runner."""
    chunk0 = p15["runner_chunk"]["layers"][0]
    return {
        "name": "int8_conv3x3_requant[stem Cin=12]", "route": "cuda",
        "source": "mmmot_tpu_torch/csrc/int8_conv.cu",
        "replaces": "mmmot_tpu/models/quantize.py:267 (the XLA int8 conv "
                    "of quantized_trunk_stages after the s2d relayout at "
                    ":258-259; no Pallas kernel)",
        "instance": "stem (im2col in shared memory), Kp 108 -> 128",
        "launches": p15["runs"]["s2d_int8"]["int8_launches_by_kind"][
            "stem_launches"],
        "max_abs_err": max(stem["max_abs_err"], chunk0["max_abs_err"]),
        **{k: stem[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "call_ms", "cudnn_bf16_ms",
                                "ops_ms", "bytes_ms", "gops", "plan")},
        "library_call": "torch._int_mm over the im2col'd input (the int8 "
                        "product alone)",
        "dtype": "int8", "shape": [stem["n"], *stem["hw"], stem["cin"],
                                   stem["cout"]],
        "runner_chunk": {k: chunk0[k] for k in ("n", "ms", "plain_ms",
                                                "bound_ms", "library_ms",
                                                "cudnn_bf16_ms")}}


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
    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc a source
        list(pool.map(kbuild.build, KERNELS))
    stage(f"build {time.time() - t:.1f}s")
    for name in KERNELS:
        print(kbuild.build_logs.get(name, f"({name}: library reused)"),
              file=sys.stderr)

    ptxas, sass = compiled_code()

    net = init_random_(TrackingNet(full_mmmot().model, device=dev), 0)
    kern = check_kernel(net, dev)
    epilogue = check_bn_relu(dev)
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
        torch.cuda.empty_cache()
        training = training_phase(dev, smi, root, tmp, profile)
        torch.cuda.empty_cache()
        serving = serving_phase(dev, smi, root, tmp)
        torch.cuda.empty_cache()
        int8 = int8_phase(dev, smi, root, tmp, runner)
        torch.cuda.empty_cache()
        kern_inst, solvers = solvers_phase(dev, smi, root, tmp)
        torch.cuda.empty_cache()
        kern_var, variants = variants_phase(dev, smi, root, tmp)
        torch.cuda.empty_cache()
        kern_wide, wide = phase14(dev, smi, root, tmp)
        torch.cuda.empty_cache()
        stem, p15 = phase15(dev, smi, root, tmp)

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
                                 "no_bias"],
                             "train_cli": sum(
                                 training[k]["launches"] for k in CLI_RUNS),
                             "train_step": sum(
                                 training[k]["train_step_launches"]
                                 for k in CLI_RUNS),
                             "serve_step": serving["single"]["launches"],
                             "multistream_padded": serving["multistream"][
                                 "padded"]["launches"],
                             "multistream_compact": serving["multistream"][
                                 "compact"]["launches"],
                             "noisy_serve_step": serving["noisy"][
                                 "launches"],
                             "int8_runner": int8["runner"]["launches"][
                                 "fused_affinity"],
                             "int8_serve_step": int8["serving"]["launches"][
                                 "fused_affinity"]},
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
        "ptxas": {k: v for k, v in (ptxas or {}).items()
                  if not k.startswith(("int8", "bn_relu"))},
        "sass_tensor_core": {k: v for k, v in (sass or {}).items()
                             if not k.startswith(("int8", "bn_relu"))},
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
    def serving_entry(instance, r, launches, what):
        return {
            "name": f"fused_affinity[{instance}]", "route": "cuda",
            "source": "mmmot_tpu_torch/csrc/affinity.cu",
            "replaces": "mmmot_tpu/kernels/affinity_kernel.py:206",
            "instance": what, "launches": launches,
            "max_abs_err": worst(r["errs"]),
            **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "call_ms", "plain_call_ms",
                                 "library_call_ms", "launch_ms",
                                 "valid_pairs", "frame_pairs", "slots")},
            "library_call": "torch.bmm [K, B*N*N, D] x [K, D, H] (the W1 "
                            "product alone, over all pairs)",
            "dtype": "bfloat16"}

    multi_kern = serving["multistream"].pop("kernel")
    serving_entries = [
        serving_entry("serve_step", serving["single"]["kernel"],
                      serving["single"]["launches"],
                      "per-frame serving step, B=1 N=32 (phase 10 (b))"),
        serving_entry("multistream S=4", multi_kern,
                      serving["multistream"]["padded"]["launches"],
                      "multi-stream flush, B=4 N=32 (phase 10 (c), "
                      "padded; the compact run launches as many)"),
        serving_entry("serve_step N=64", serving["noisy"]["kernel"],
                      serving["noisy"]["launches"],
                      "full_mmmot_noisy's per-frame step, B=1 N=64 "
                      "(phase 10 (d))")]
    print(json.dumps({"main_path": {
        "frames": T, "detections": run["n_valid"], "warm_ms": run["warm_ms"],
        "auction_rounds": run["auction_rounds"],
        "fps": run["fps"], "stages_ms": run["stages_ms"],
        "profiled": run.get("profiled"), "gpu": smi}}))
    print(json.dumps({"runner": runner}))
    print(json.dumps({"quality": quality}))
    print(json.dumps({"lookalike": lookalike}))
    print(json.dumps({"training": training}))
    k8 = int8["kernel"]
    entry_int8 = {
        "name": "int8_conv3x3_requant", "route": "cuda",
        "source": "mmmot_tpu_torch/csrc/int8_conv.cu",
        "replaces": "mmmot_tpu/models/quantize.py:267 (the XLA int8 conv "
                    "of quantized_trunk_stages, and with pool=True the "
                    "max-pool at :261; no Pallas kernel)",
        "launches": int8["runner"]["launches"]["int8_conv3x3_requant"],
        "launches_by_kind": {
            "int8_runner": int8["runner"]["int8_launches_by_kind"],
            "int8_serve_step": int8["serving"]["int8_launches_by_kind"]},
        "launches_by_path": {
            "int8_runner": int8["runner"]["launches"][
                "int8_conv3x3_requant"],
            "int8_agreement_gpu": int8["agreement"]["gpu_int8_launches"],
            "int8_serve_step": int8["serving"]["launches"][
                "int8_conv3x3_requant"]},
        "max_abs_err": max([r["max_abs_err"] for r in k8["layers"]
                            + k8["fused_pool_layers"]]
                           + [int8["runner_chunk"]["max_abs_err"]]),
        **{k: k8["total"][k] for k in ("ms", "plain_ms", "bound_ms",
                                       "library_ms", "call_ms",
                                       "cudnn_bf16_ms")},
        "bound_by": ("operations" if k8["total"]["ops_ms"]
                     >= k8["total"]["bytes_ms"] else "bytes"),
        "library_call": "torch._int_mm over the im2col'd input (the int8 "
                        "product alone, per layer, summed)",
        "dtype": "int8", "crops": k8["crops"],
        "shapes": "the 13 VGG16 convs at 224², summed; per layer in "
                  "'layers'",
        "layers": k8["layers"],
        "fused_pool_layers": k8["fused_pool_layers"],
        "as_the_trunk_runs": k8["path"],
        "not_below_int_mm": k8["not_below_int_mm"],
        "runner_chunk": int8["runner_chunk"],
        "ptxas": {k: v for k, v in (ptxas or {}).items()
                  if k.startswith("int8")},
        "sass_tensor_core": {k: v for k, v in (sass or {}).items()
                             if k.startswith("int8")}}
    ep = epilogue["bfloat16"]["total"]
    entry_bn_relu = {
        "name": "fused_bn_relu", "route": "cuda",
        "source": "mmmot_tpu_torch/csrc/bn_relu.cu",
        "replaces": "mmmot_tpu/models/appearance.py:110-118 (XLA's fused "
                    "conv bias, BatchNorm and ReLU loop) and :104 (the "
                    "reduce_window of nn.max_pool); no Pallas kernel",
        "launches": run["bn_relu_launches"]["launches"],
        "pool_launches": run["bn_relu_launches"]["pool_launches"],
        "launches_by_path": {"main_path": run["bn_relu_launches"]},
        "main_path_chunks": run["chunks"], "max_abs_err": 0.0,
        "bits_equal": True,
        **{k: ep[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes", "library_ms": None,
        "library_call": "none: no PyTorch call does the four in one pass",
        "dtype": "bfloat16", "crops": EPILOGUE_CROPS,
        "shapes": "VGG16's 13 conv outputs at 224², 5 pooled, summed; per "
                  "layer in 'layers'",
        "layers": epilogue["bfloat16"]["layers"],
        "float32": epilogue["float32"],
        "ptxas": {k: v for k, v in (ptxas or {}).items()
                  if k.startswith("bn_relu")}}
    print(json.dumps({"serving": serving}))
    print(json.dumps({"int8": {k: v for k, v in int8.items()
                               if k not in ("kernel", "runner_chunk")}}))
    print(json.dumps({"solvers": solvers}))
    print(json.dumps({"variants": variants}))
    print(json.dumps({"phase14": wide}))
    print(json.dumps({"phase15": {k: v for k, v in p15.items()
                                  if k != "runner_chunk"}}))
    print(json.dumps({"kernels": [entry, entry_bias] + serving_entries
                      + [entry_int8] + instance_entries(kern_inst, solvers)
                      + variant_entries(kern_var, variants)
                      + [wide_entry(kern_wide, wide["wide_runner"][
                          "wide_launches"]), stem_entry(stem, p15),
                         entry_bn_relu]}))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
