"""Standalone KITTI tracking evaluation CLI: port of
``mmmot_tpu/cli/evaluate.py``.  Scores existing result txts without
running the tracker.

Scores ``<results>/<seq>.txt`` files against ``<gt>/<seq>.txt`` KITTI
tracking labels with the port's devkit copy (``eval/``) and prints the
devkit stats block per class; it imports no torch, so it runs wherever
the result txts do.

    python -m mmmot_tpu_torch.cli.evaluate --gt kitti/label_02 \\
        --results results/latest [--classes car,pedestrian] \\
        [--sequences 0000,0001 | --seqmap evaluate_tracking.seqmap.training] \\
        [--per-sequence] [--summary] [--hota]
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Score KITTI tracking result txts with the devkit port")
    p.add_argument("--gt", required=True,
                   help="directory of GT label txts (label_02/)")
    p.add_argument("--results", required=True,
                   help="directory of tracker result txts")
    p.add_argument("--sequences", default=None,
                   help="comma-separated sequence names (default: every "
                        "<seq>.txt present in BOTH directories)")
    p.add_argument("--seqmap", default=None,
                   help="KITTI devkit seqmap file ('<seq> empty <first> "
                        "<n_frames>' per line): supplies the sequence list "
                        "AND the authoritative per-sequence frame counts")
    p.add_argument("--classes", default="car",
                   help="comma-separated benchmark classes "
                        "(reference devkit: car then pedestrian)")
    p.add_argument("--per-sequence", action="store_true",
                   help="also print one metrics line per sequence")
    p.add_argument("--summary", action="store_true",
                   help="write summary_<class>.txt files into --results")
    p.add_argument("--hota", action="store_true",
                   help="also score HOTA/DetA/AssA (the modern KITTI "
                        "benchmark headline metric; TrackEval algorithm)")
    return p.parse_args(argv)


def _discover_sequences(gt_dir: str, result_dir: str):
    def txts(d):
        try:
            return {f[:-4] for f in os.listdir(d) if f.endswith(".txt")
                    and not f.startswith("summary_")}
        except FileNotFoundError:
            raise SystemExit(f"not a directory: {d}")
    return sorted(txts(gt_dir) & txts(result_dir))


def main(argv=None):
    args = parse_args(argv)
    from mmmot_tpu_torch.eval import (evaluate_hota, evaluate_tracking,
                                      read_seqmap)

    num_frames = None
    if args.seqmap:
        try:
            num_frames = read_seqmap(args.seqmap)
        except (OSError, ValueError) as exc:
            raise SystemExit(f"--seqmap: {exc}")
    seqs = (args.sequences.split(",") if args.sequences
            else sorted(num_frames) if num_frames is not None
            else _discover_sequences(args.gt, args.results))
    if not seqs:
        raise SystemExit(
            f"no common <seq>.txt between {args.gt} and {args.results} "
            "(pass --sequences to name them explicitly)")
    for seq in seqs:
        for d in (args.gt, args.results):
            if not os.path.exists(os.path.join(d, f"{seq}.txt")):
                raise SystemExit(f"missing {seq}.txt under {d}")

    for cls in args.classes.split(","):
        cls = cls.strip().lower()
        overall, per_seq = evaluate_tracking(
            args.gt, args.results, seqs, cls=cls, per_sequence=True,
            summary_dir=args.results if args.summary else None,
            num_frames=num_frames)
        print(f"== {cls} ({len(seqs)} sequences) ==")
        print(overall.summary_text())
        if args.hota:
            hm = evaluate_hota(
                args.gt, args.results, seqs, cls=cls,
                summary_dir=args.results if args.summary else None,
                num_frames=num_frames)
            print(hm.summary_text())
        if args.per_sequence:
            for seq in seqs:
                print(f"{seq}: {per_seq[seq].summary()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
