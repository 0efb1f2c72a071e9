"""Training CLI of the port: ``mmmot_tpu/cli/train.py``.

    python -m mmmot_tpu_torch.cli.train --config tiny_debug --cpu \\
        --synthetic --steps-per-epoch 20
    python -m mmmot_tpu_torch.cli.train --config full_mmmot \\
        --data-root data/kitti_tracking

Trains on adjacent-frame pairs of a KITTI tracking tree (the preset's
``data.root`` or ``--data-root``) when it exists, else (or with
``--synthetic``) on the synthetic generator.  On a tree the last quarter
of the sequences (``--val-seqs`` to choose) is held out: every
``--val-every`` epochs (and after the last) they are tracked by
``track_kitti_sequences`` and scored by the devkit, and the best-MOTA
weights are kept in ``<ckpt_dir>/<config>_best``; the synthetic mode
validates on synthetic sequences through ``track_sequence``.  The
latest checkpoints go to ``<ckpt_dir>/<config>/<step>/``, scalars
(loss terms, lr, validation metrics) to ``<log-dir>/scalars.jsonl``.
Weights start from a seed (``train.seed``); ``--pretrained-vgg PATH``
then copies a local torchvision ``vgg<depth>_bn`` state dict into the
appearance trunk (``compat/pretrained.py``; the report is logged);
``--load-path`` restores a checkpoint directory, ``--recover`` resumes
the run's own.  The GPU is
used unless ``--cpu`` is given.  ``run(cfg, args)`` is the loop, for a
caller with its own ``Config``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

PRESETS = ("full_mmmot", "full_mmmot_b8", "full_mmmot_ydet",
           "full_mmmot_noisy", "full_mmmot_lookalike", "batched_val",
           "fusion_C", "img_only", "lidar_only", "tiny_debug", "tiny_kitti",
           "tiny_long", "tiny_long30")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="mmmot_tpu_torch training")
    p.add_argument("--config", required=True, choices=PRESETS,
                   help="config preset")
    p.add_argument("--data-root", default=None,
                   help="KITTI tracking tree (default: the preset's "
                        "data.root)")
    p.add_argument("--load-path", default=None,
                   help="checkpoint dir to load the train state from")
    p.add_argument("--pretrained-vgg", default=None, metavar="PTH",
                   help="local torchvision vgg<depth>_bn state dict to "
                        "start the appearance trunk from (the reference's "
                        "vgg16_bn(pretrained=True)); loaded with "
                        "weights_only")
    p.add_argument("--recover", action="store_true",
                   help="resume training (optimizer state + step)")
    p.add_argument("-e", "--evaluate", action="store_true",
                   help="validate only, no training")
    p.add_argument("--result-path", default="results")
    p.add_argument("--synthetic", action="store_true",
                   help="force synthetic data even if the tree exists")
    p.add_argument("--steps-per-epoch", type=int, default=50)
    p.add_argument("--val-every", type=int, default=5)
    p.add_argument("--val-sequences", type=int, default=2)
    p.add_argument("--val-frames", type=int, default=20)
    p.add_argument("--val-seqs", default=None,
                   help="comma-separated held-out KITTI sequences for "
                        "validation (real-data mode); default: last 25%%")
    p.add_argument("--val-batch-sequences", type=int, default=1,
                   help="val sequences tracked together per window call")
    p.add_argument("--val-window", type=int, default=64,
                   help="streaming window for real-data validation")
    p.add_argument("--log-dir", default=None,
                   help="scalar log dir (default: runs/<config name>)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from mmmot_tpu_torch import config as presets

    cfg = getattr(presets, args.config)()
    if args.data_root:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, root=args.data_root))
    return run(cfg, args)


def _synthetic_validate(module, cfg, args, res_dir):
    """Track ``--val-sequences`` synthetic sequences and score them."""
    import numpy as np

    from mmmot_tpu_torch.data.kitti_io import (tracker_output_to_objects,
                                               write_kitti_result)
    from mmmot_tpu_torch.data.synthetic import make_synthetic_sequence
    from mmmot_tpu_torch.eval import TrackingEvaluation
    from mmmot_tpu_torch.tracker.sequence import track_sequence

    ev = TrackingEvaluation(cls="car")
    for s in range(args.val_sequences):
        world = make_synthetic_sequence(
            np.random.default_rng(1000 + s), num_frames=args.val_frames,
            num_slots=cfg.data.max_dets, crop_size=cfg.data.crop_size,
            points_per_det=cfg.data.point_len, drop_prob=0.05, fp_prob=0.1)
        out = track_sequence(module, world.crops, world.points,
                             world.point_mask, world.det_mask,
                             boxes=world.boxes2d)
        ids = out["ids"].cpu().numpy()
        res = tracker_output_to_objects(ids, world.det_mask, world.boxes2d,
                                        world.scores)
        write_kitti_result(res, os.path.join(res_dir, f"{s:04d}.txt"))
        gt = tracker_output_to_objects(
            world.gt_ids, world.det_mask & (world.gt_ids >= 0),
            world.boxes2d)
        by_frame = ({}, {})
        for objs, d in zip((gt, res), by_frame):
            for o in objs:
                d.setdefault(o.frame, []).append(o)
        ev.add_sequence(*by_frame, num_frames=args.val_frames)
    return ev.compute()


def run(cfg, args):
    """The training loop over ``cfg`` with ``args`` (``parse_args``'s
    namespace; its ``--config`` and ``--data-root`` are not read).
    Returns {"state": the TrainState, "losses": the total loss of every
    step, "val": {tag: TrackingMetrics}} and, with ``--pretrained-vgg``,
    "pretrained_vgg": the load's report."""
    import numpy as np
    import torch

    from mmmot_tpu_torch.data.augment import augment_batch
    from mmmot_tpu_torch.data.synthetic import make_training_batch
    from mmmot_tpu_torch.models.tracking_net import TrackingNet, init_random_
    from mmmot_tpu_torch.tracker.tracker import TrackingModule
    from mmmot_tpu_torch.train.checkpoint import (latest_step,
                                                  restore_checkpoint,
                                                  save_checkpoint)
    from mmmot_tpu_torch.train.trainer import (build_schedule,
                                               create_train_state,
                                               train_step)
    from mmmot_tpu_torch.utils.meters import create_logger
    from mmmot_tpu_torch.utils.scalars import ScalarWriter

    log = create_logger("mmmot_torch.train")
    tcfg, N = cfg.train, cfg.data.max_dets
    net = init_random_(TrackingNet(cfg.model,
                                   device="cpu" if args.cpu else "cuda"),
                       tcfg.seed)
    dev = net.device
    rng = np.random.default_rng(tcfg.seed)
    aug_gen = torch.Generator(device=dev).manual_seed(tcfg.seed)

    use_synthetic = args.synthetic or not os.path.isdir(
        os.path.join(cfg.data.root, "image_02"))
    val_seqs = None
    if use_synthetic:
        def next_batch():
            b = make_training_batch(
                rng, batch_size=tcfg.batch_size, num_slots=N,
                crop_size=cfg.data.crop_size,
                points_per_det=cfg.data.point_len, drop_prob=0.1,
                fp_prob=0.2)
            return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
    else:
        from mmmot_tpu_torch.data.kitti_dataset import KittiTrackingDataset
        from mmmot_tpu_torch.data.kitti_loader import KittiPairLoader

        all_seqs = KittiTrackingDataset(cfg.data).sequences
        if args.val_seqs:
            val_seqs = [s for s in args.val_seqs.split(",") if s]
        else:
            # Held out: the last quarter of the sequences (at least one).
            n_val = max(1, len(all_seqs) // 4)
            val_seqs = all_seqs[-n_val:] if len(all_seqs) > 1 else all_seqs
        train_seqs = [s for s in all_seqs if s not in val_seqs] or all_seqs
        loader = KittiPairLoader(cfg.data, seed=tcfg.seed,
                                 sequences=tuple(train_seqs), device=dev)
        log.info("real KITTI training: %d train seqs, val on %s (%s)",
                 len(train_seqs), val_seqs, cfg.data.root)
        batch_iter = loader.batches(tcfg.batch_size)

        def next_batch():
            return next(batch_iter)

    state = create_train_state(net, tcfg, args.steps_per_epoch)
    result = {"state": state, "losses": [], "val": {}}
    if getattr(args, "pretrained_vgg", None):
        from mmmot_tpu_torch.compat.pretrained import load_pretrained_vgg

        report = load_pretrained_vgg(net, args.pretrained_vgg,
                                     depth=cfg.model.appearance.depth)
        result["pretrained_vgg"] = report
        log.info("pretrained VGG loaded: %d tensors from %s (unexpected "
                 "unused keys: %s)", len(report["converted"]),
                 args.pretrained_vgg, report["unexpected_unused"] or "none")
    ckpt_dir = os.path.join(tcfg.ckpt_dir, cfg.name)
    start_epoch = 0
    if args.recover and latest_step(ckpt_dir) is not None:
        restore_checkpoint(ckpt_dir, state)
        start_epoch = state.step // args.steps_per_epoch
        log.info("recovered from %s at step %d", ckpt_dir, state.step)
    elif args.load_path:
        restore_checkpoint(args.load_path, state)
        log.info("loaded weights from %s", args.load_path)

    def validate(tag):
        net.eval()
        module = TrackingModule(net, cfg.assoc)
        res_dir = os.path.join(args.result_path, cfg.name, tag)
        if val_seqs is None:
            m = _synthetic_validate(module, cfg, args, res_dir)
        else:
            from mmmot_tpu_torch.tracker.kitti_runner import \
                track_kitti_sequences

            m = track_kitti_sequences(
                module, cfg.data, res_dir, sequences=val_seqs,
                window=args.val_window, evaluate=True,
                batch_sequences=args.val_batch_sequences,
                max_frames=args.val_frames if args.val_frames > 0 else None,
                log=log)["metrics"]
        log.info("[val %s] %s", tag, m.summary())
        return m

    if args.evaluate:
        result["val"]["eval"] = validate("eval")
        return result

    log_dir = args.log_dir or os.path.join("runs", cfg.name)
    writer = ScalarWriter(log_dir)
    lr_of = build_schedule(tcfg, args.steps_per_epoch)
    log.info("scalars -> %s (JSONL)", log_dir)
    best_mota = -1e9
    try:
        for epoch in range(start_epoch, tcfg.epochs):
            t0 = time.time()
            losses = []
            for i in range(args.steps_per_epoch):
                batch = next_batch()
                if cfg.data.augmentation:
                    batch = augment_batch(aug_gen, batch)
                _, metrics = train_step(
                    state, batch, loss_weights=tcfg.loss_weights,
                    compact_capacity=tcfg.compact_capacity)
                losses.append(float(metrics["total"]))
                if (i + 1) % tcfg.log_every == 0:
                    log.info("epoch %d step %d/%d loss %.4f", epoch, i + 1,
                             args.steps_per_epoch, losses[-1])
                    writer.write(state.step, lr=lr_of(state.step),
                                 **{f"loss/{k}": float(v)
                                    for k, v in metrics.items()})
            mean_loss = sum(losses) / len(losses)
            result["losses"] += losses
            log.info("epoch %d done in %.1fs mean loss %.4f", epoch,
                     time.time() - t0, mean_loss)
            writer.write(state.step, epoch=epoch, **{
                "loss/epoch_mean": mean_loss})
            save_checkpoint(ckpt_dir, state, state.step, keep=tcfg.ckpt_keep)
            if (epoch + 1) % args.val_every == 0 or epoch == tcfg.epochs - 1:
                m = validate(f"epoch{epoch}")
                result["val"][f"epoch{epoch}"] = m
                writer.write(state.step, **{
                    "val/mota": m.mota, "val/motp": m.motp,
                    "val/ids": m.id_switches, "val/recall": m.recall,
                    "val/precision": m.precision})
                if m.mota > best_mota:
                    best_mota = m.mota
                    save_checkpoint(ckpt_dir + "_best", state, state.step,
                                    keep=1, metrics={"mota": m.mota})
                    log.info("new best MOTA %.4f", m.mota)
    finally:
        writer.close()
    return result


if __name__ == "__main__":
    main()
