"""Reference-checkpoint conversion and golden-output harness (CLI): port
of ``mmmot_tpu/compat/parity_check.py``.

A reference ``.pth`` / ``.pth.tar`` crosses the name tables
(``compat/mappings.py``) into the port's ``TrackingNet``, with a report
of what was converted, what the checkpoint left uncovered, what it holds
that nothing consumed and what does not fit; golden files record the
net's outputs on a fixed input and check them later.

    python -m mmmot_tpu_torch.compat.parity_check --pth ckpt.pth \\
        --config full_mmmot --dump-goldens goldens.npz
    python -m mmmot_tpu_torch.compat.parity_check --pth ckpt.pth \\
        --config full_mmmot --goldens goldens.npz [--atol 1e-5]
    python -m mmmot_tpu_torch.compat.parity_check --pth ckpt.pth --list-keys

``--config`` names a preset of ``mmmot_tpu_torch.config``; the net runs
on the GPU unless ``--cpu`` is given.
"""

from __future__ import annotations

import json
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch


def convert_reference_checkpoint(state_dict: Mapping, model_cfg,
                                 names: Optional[Mapping[str, str]] = None,
                                 net=None):
    """A reference ``TrackingNet`` state dict in the port's names.

    Returns ``(state_dict, report)``; ``report`` has ``converted`` (the
    port's tensor names filled), ``missing`` (the net's tensors no
    checkpoint key covers), ``unused`` (checkpoint keys not consumed)
    and ``shape_errors``.  With ``net`` the state dict is the net's own
    with the converted tensors in place of its tensors (each in the net's
    dtype), and ``missing`` and ``shape_errors`` are checked against it;
    ``net`` itself is not changed."""
    from mmmot_tpu_torch.compat.mappings import mmmot_trackingnet_mapping
    from mmmot_tpu_torch.compat.torch_convert import torch_to_port

    mapping, kind = mmmot_trackingnet_mapping(model_cfg, names=names)
    tensors, unused = torch_to_port(state_dict, mapping, kind)
    report: Dict[str, List] = {"converted": sorted(tensors), "missing": [],
                               "unused": sorted(unused), "shape_errors": []}
    if net is None:
        return tensors, report
    own = {k: v.detach().clone() for k, v in net.state_dict().items()}
    for name, v in tensors.items():
        if name not in own:
            report["shape_errors"].append(f"{name}: no such tensor in the "
                                          "model")
        elif tuple(own[name].shape) != tuple(v.shape):
            report["shape_errors"].append(
                f"{name}: model {tuple(own[name].shape)} vs checkpoint "
                f"{tuple(v.shape)}")
        else:
            own[name] = v.to(own[name].dtype)
    report["missing"] = sorted(k for k in own if k not in tensors)
    return own, report


def golden_batch(model_cfg, data_cfg, seed: int = 0) -> Dict[str, np.ndarray]:
    """The fixed input of the golden files, numpy from ``seed``: one
    sample of two frames, ``max_dets`` slots, the last slot empty."""
    rng = np.random.default_rng(seed)
    N, P = data_cfg.max_dets, data_cfg.point_len
    h, w = model_cfg.appearance.crop_size
    B, T = 1, 2
    return {
        "crops": rng.normal(0, 1, (B, T, N, h, w, 3)).astype(np.float32),
        "points": rng.normal(0, 1, (B, T, N, P, 4)).astype(np.float32),
        "point_mask": np.ones((B, T, N, P), bool),
        "det_mask": np.broadcast_to(
            np.arange(N)[None, None, :] < max(2, N - 1), (B, T, N)).copy(),
    }


def compute_outputs(net, data_cfg, seed: int = 0) -> Dict[str, np.ndarray]:
    """The eval-mode training forward of ``net`` on ``golden_batch``:
    link, link_norm, new, end and det as float32 numpy arrays."""
    from mmmot_tpu_torch.device import f32_parity

    batch = {k: torch.as_tensor(v, device=net.device)
             for k, v in golden_batch(net.cfg, data_cfg, seed).items()}
    net.eval()
    with torch.no_grad(), f32_parity(net.compute_dtype == torch.float32):
        out = net(batch)
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def dump_goldens(net, data_cfg, path: str, seed: int = 0) -> None:
    np.savez(path, **compute_outputs(net, data_cfg, seed))


def check_goldens(net, data_cfg, path: str, seed: int = 0,
                  atol: float = 0.0, rtol: float = 0.0) -> Dict[str, float]:
    """Max |diff| per output against a golden file; raises
    ``AssertionError`` where an output leaves ``atol + rtol * |golden|``
    (or where the file holds an output the net does not give)."""
    got = compute_outputs(net, data_cfg, seed)
    diffs = {}
    with np.load(path) as ref:
        for k in ref.files:
            if k not in got:
                raise AssertionError(f"golden output {k!r} not computed")
            d = np.abs(got[k] - ref[k])
            diffs[k] = float(d.max()) if d.size else 0.0
            if (d > atol + rtol * np.abs(ref[k])).any():
                raise AssertionError(
                    f"golden mismatch on {k!r}: max|diff|={diffs[k]} "
                    f"(atol={atol}, rtol={rtol})")
    return diffs


def main(argv=None):
    import argparse

    from mmmot_tpu_torch import config as presets
    from mmmot_tpu_torch.cli.track import PRESETS
    from mmmot_tpu_torch.compat.torch_convert import load_torch_checkpoint
    from mmmot_tpu_torch.models.tracking_net import TrackingNet, init_random_

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pth", required=True)
    ap.add_argument("--config", choices=PRESETS)
    ap.add_argument("--dump-goldens")
    ap.add_argument("--goldens")
    ap.add_argument("--atol", type=float, default=0.0)
    ap.add_argument("--rtol", type=float, default=0.0)
    ap.add_argument("--list-keys", action="store_true")
    ap.add_argument("--allow-pickle", action="store_true")
    ap.add_argument("--names-json",
                    help="JSON dict overriding MMMOT_DEFAULT_NAMES")
    ap.add_argument("--cpu", action="store_true",
                    help="build the net on the CPU")
    args = ap.parse_args(argv)

    sd = load_torch_checkpoint(args.pth, allow_pickle=args.allow_pickle)
    if args.list_keys:
        for k in sorted(sd):
            print(k, tuple(getattr(sd[k], "shape", ())))
        return 0
    if args.config is None:
        ap.error("--config is required unless --list-keys")
    cfg = getattr(presets, args.config)()
    net = init_random_(TrackingNet(cfg.model,
                                   device="cpu" if args.cpu else "cuda"), 0)
    names = None
    if args.names_json:
        with open(args.names_json) as f:
            names = json.load(f)
    state, report = convert_reference_checkpoint(sd, cfg.model, names=names,
                                                 net=net)
    print(json.dumps({
        "converted": len(report["converted"]),
        "missing": report["missing"],
        "unused": report["unused"],
        "shape_errors": report["shape_errors"],
    }, indent=2))
    ok = not (report["missing"] or report["unused"]
              or report["shape_errors"])
    if not report["shape_errors"]:
        net.load_state_dict(state)
    if args.dump_goldens:
        dump_goldens(net, cfg.data, args.dump_goldens)
        print(f"goldens -> {args.dump_goldens}")
    if args.goldens:
        diffs = check_goldens(net, cfg.data, args.goldens, atol=args.atol,
                              rtol=args.rtol)
        print(json.dumps({"golden_max_abs_diff": diffs}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
