"""Deployment: the per-frame and multi-stream serving steps, artifacts and
``DeployedTracker``; port of ``mmmot_tpu/deploy.py``.

The per-frame serving step runs on the module's device: the per-slot
crop of the whole frame (``crop_and_resize_batched``, the reference's
``method="mxu"``), normalisation, frustum sampling, feature extraction
and ``TrackingModule.step_from_feats`` (the fused kernel, the auction and
the id bookkeeping).  The multi-stream step advances S streams in one
batched ``step_from_feats``: one kernel launch and one auction a flush.

Artifact layout (one directory; ``manifest.json``'s ``kind`` is
``serve_step``, ``window`` or ``multistream_step``):

    weights.npz    the model's flax-layout variables
                   (``compat.from_jax.to_flax_variables``), one entry
                   per path, the keys joined by ``//``
    state0.npz     the zero tracker state of the step's carry
    manifest.json  kind, shapes, ``config`` (the config's name) and
                   ``config_dict`` (the whole config,
                   ``config.config_to_dict``), ``"platforms": ["cuda"]``,
                   the two trees' structure and dtypes, and ``program``

The JAX package's artifact also holds ``serve_step.stablehlo``, its
compiled program.  The port's holds none: its program is the port's own
step code, which ``manifest["program"]`` names.  ``torch.export`` cannot
capture that step (the auction checks its flags on the host every 64
rounds, and the kernel is a ctypes call), so an exported graph would not
be the program that runs.  A port artifact needs this package to run.
``DeployedTracker.load`` also serves a ``serve_step`` artifact that the
JAX package wrote: it converts the weights with ``load_flax_variables``,
builds its own zero state and ignores the ``.stablehlo`` file.

numpy has no bfloat16: a bfloat16 leaf is stored as its raw 2-byte
records (``|V2``, what numpy writes for an ``ml_dtypes`` bfloat16 array)
and read back through ``int16`` into a ``torch.bfloat16`` tensor, as
the dtype names of the manifest's structure say.

An int8 artifact (``"int8": true``, the export CLI's ``--int8``) adds
the calibrated trunk to the weights as the reference's ``quant_int8``
tree (``in_scale``, a tuple of per-layer ``{"w", "m", "b"}``, a tuple of
stage scales); tuples and lists are tagged in the structure as the
reference tags them, so int8 artifacts of either package load in both.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mmmot_tpu_torch.compat.from_jax import (load_flax_variables,
                                             quant_from_flax,
                                             to_flax_variables)
from mmmot_tpu_torch.config import config_from_dict, config_to_dict
from mmmot_tpu_torch.ops.crop_resize import (crop_and_resize_batched,
                                             normalize_crops)
from mmmot_tpu_torch.ops.frustum import frustum_sample_batched
from mmmot_tpu_torch.tracker.sequence import (compact_extract,
                                              track_sequence_from_frames)
from mmmot_tpu_torch.tracker.tracker import (F32_FEATS, TrackerState,
                                             TrackingModule)

__all__ = ["export_serve_step", "export_window_step",
           "export_multistream_step", "save_artifact", "DeployedTracker",
           "WindowStep", "MultiStreamStep", "load_window_step",
           "load_multistream_step", "ARTIFACT_WEIGHTS",
           "ARTIFACT_STATE0", "ARTIFACT_MANIFEST"]

ARTIFACT_WEIGHTS = "weights.npz"
ARTIFACT_STATE0 = "state0.npz"
ARTIFACT_MANIFEST = "manifest.json"
JAX_PROGRAM = "serve_step.stablehlo"   # the JAX package's compiled step

_SEP = "//"  # path separator inside npz keys (flax uses plain '/')

# The window program's crop band width and extraction chunk (the
# reference exporter's defaults).
WINDOW_CROP = 512
WINDOW_CHUNK = 32

# What ``manifest["program"]`` names for each kind: the step code that
# runs the artifact.
PROGRAMS = {
    "serve_step": "mmmot_tpu_torch.deploy:_build_step",
    "window": "mmmot_tpu_torch.deploy:_build_window_step",
    "multistream_step": "mmmot_tpu_torch.deploy:_build_multistream_step",
}


# -- trees of arrays: npz, structure and dtypes --------------------------

def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def _to_numpy(x) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view("V2")
    return x.numpy()


def _flatten_to_npz(tree, prefix=()) -> Dict[str, np.ndarray]:
    """Nested dicts, tuples and lists of arrays or tensors -> {path:
    numpy array}, the path's parts joined by ``//`` (a sequence entry
    keyed by its index, as the reference keys it)."""
    if isinstance(tree, dict):
        children = tree.items()
    elif isinstance(tree, (tuple, list)):
        children = enumerate(tree)
    else:
        return {_SEP.join(prefix): _to_numpy(tree)}
    flat = {}
    for k, v in children:
        flat.update(_flatten_to_npz(v, prefix + (str(k),)))
    return flat


def _skeleton(tree) -> Any:
    """The JSON structure record of a tree: dicts stay dicts, tuples and
    lists become ``{"__tuple__": [...]}`` and ``{"__list__": [...]}``
    (the reference's tags: JSON has no tuple), leaves become their dtype
    name.  It keeps what npz keys alone lose: empty subtrees, sequence
    nodes and the bfloat16 dtype."""
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return {"__tuple__": [_skeleton(v) for v in tree]}
    if isinstance(tree, list):
        return {"__list__": [_skeleton(v) for v in tree]}
    return _dtype_name(tree)


def _fill_from_npz(skel, npz, prefix=()) -> Any:
    """Rebuild the tree that ``skel`` describes from npz entries: numpy
    arrays, and ``torch.bfloat16`` tensors for bfloat16 leaves."""
    if isinstance(skel, dict):
        for tag, kind in (("__tuple__", tuple), ("__list__", list)):
            if tag in skel:
                return kind(_fill_from_npz(v, npz, prefix + (str(i),))
                            for i, v in enumerate(skel[tag]))
        return {k: _fill_from_npz(v, npz, prefix + (k,))
                for k, v in skel.items()}
    arr = npz[_SEP.join(prefix)]
    if skel == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16)
    dt = np.dtype(skel)
    return arr if arr.dtype == dt else arr.view(dt)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of equal structure."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


# -- tracker state as a dict ----------------------------------------------

def _padded(boxes, N: int):
    """(boxes [N, 4], det_mask [N], n) of a frame's n <= N boxes."""
    boxes = np.asarray(boxes, np.float32)
    n = len(boxes)
    if n > N:
        raise ValueError(f"{n} detections > max_dets {N}")
    boxes_p = np.zeros((N, 4), np.float32)
    boxes_p[:n] = boxes
    det_mask = np.zeros((N,), bool)
    det_mask[:n] = True
    return boxes_p, det_mask, n


def _state_to_dict(state) -> Dict[str, Any]:
    if isinstance(state, dict):
        return state
    d = {"feats": dict(state.feats), "mask": state.mask, "ids": state.ids,
         "ages": state.ages, "next_id": state.next_id}
    if state.missed is not None:
        d["missed"] = state.missed
    return d


def _state_from_dict(d) -> TrackerState:
    return TrackerState(feats=dict(d["feats"]), mask=d["mask"], ids=d["ids"],
                        ages=d["ages"], next_id=d["next_id"],
                        missed=d.get("missed"))


def _fresh_state(module: TrackingModule, N: int) -> TrackerState:
    """The zero state of ``module.init_state(N)`` with its feats in the
    compute dtype, except ``F32_FEATS`` (boxes, velocities, coverage
    scores, class ids), which stay float32 as the window path keeps
    them."""
    ts = module.init_state(N)
    cdt = module.net.compute_dtype
    return dataclasses.replace(ts, feats={
        k: v if k in F32_FEATS else v.to(cdt) for k, v in ts.feats.items()})


def _stacked_state(module: TrackingModule, N: int, S: int) -> Dict:
    """S zero states with a leading [S] axis, as a dict."""
    one = _state_to_dict(_fresh_state(module, N))
    return _tree_map(lambda x: torch.stack([x] * S), one)


# -- the steps ------------------------------------------------------------

def _frames_step(module: TrackingModule, crop: Tuple[int, int],
                 point_len: int, state: TrackerState, images, clouds, boxes,
                 det_mask, projs, capacity: Optional[int] = None):
    """One frame of each of S streams through ``step_from_feats``:
    images [S, H, W, 3] uint8, clouds [S, M, 4], boxes [S, N, 4], det_mask
    [S, N] bool, projs [S, 3, 4] (numpy or tensors), ``state`` with a
    leading [S] axis.  Every slot is cropped and sampled; with
    ``capacity`` only the first ``capacity`` valid (stream, slot) pairs
    are extracted (``compact_extract``), the rest dropped.  Returns
    (state, outputs) of ``step_from_feats``."""
    dev = module.device
    images, clouds, boxes, projs = (torch.as_tensor(x, device=dev)
                                    for x in (images, clouds, boxes, projs))
    det_mask = torch.as_tensor(det_mask, device=dev).bool()
    boxes, clouds, projs = boxes.float(), clouds.float(), projs.float()
    S, N = det_mask.shape
    mcfg = module.net.cfg
    crops = pts = pmask = None
    with torch.inference_mode():
        # A modality the net does not have is not prepared.
        if mcfg.use_image:
            crops = crop_and_resize_batched(images.float(), boxes, crop,
                                            det_mask)
            crops = normalize_crops(crops, scale=1.0 / 255.0)
        if mcfg.use_lidar:
            pts, pmask = frustum_sample_batched(clouds, boxes, projs,
                                                point_len, det_mask=det_mask)
        if capacity is None:
            def flat(x):
                return None if x is None else x.flatten(0, 1)

            feats = module.extract(flat(crops), flat(pts), flat(pmask),
                                   det_mask.flatten())
            feats = {k: v.reshape(S, N, -1) for k, v in feats.items()}
            kept = det_mask
        else:
            feats, kept = compact_extract(module, crops, pts, pmask,
                                          det_mask, capacity)
    if module.carry_boxes:    # gate / coverage / motion affinity read them
        feats["box"] = boxes
    return module.step_from_feats(state, feats, kept)


def _build_step(module: TrackingModule, crop: Tuple[int, int],
                point_len: int) -> Callable:
    """The per-frame serving step (``cli/serve.py``'s):

        step(state, image [H, W, 3] uint8, cloud [M, 4] f32, boxes
             [N, 4] f32, det_mask [N] bool, proj [3, 4] f32)
            -> (state', ids [N] int32, det_score [N] f32)

    on ``module``'s device (numpy arrays or tensors in, tensors out).
    ``state`` is a dict without a stream axis, as the reference's;
    ``step_from_feats`` runs it as S=1.  The module holds the weights,
    which the reference's step takes as its first argument."""

    def step(state_d, image, cloud, boxes, det_mask, proj):
        dev = module.device
        state = _state_from_dict(_tree_map(lambda x: x[None], state_d))
        new, out = _frames_step(
            module, crop, point_len, state,
            *(torch.as_tensor(x, device=dev)[None]
              for x in (image, cloud, boxes, det_mask, proj)))
        return (_tree_map(lambda x: x[0], _state_to_dict(new)),
                out["ids"][0], out["det_score"][0].float())

    return step


def _build_multistream_step(module: TrackingModule, crop: Tuple[int, int],
                            point_len: int,
                            compact_capacity: Optional[int] = None
                            ) -> Callable:
    """The multi-stream serving step: S streams' frames through ONE
    batched ``step_from_feats`` (one fused-kernel launch, one auction):

        multi(states, active [S] bool, images [S, H, W, 3] uint8, clouds
              [S, M, 4], boxes [S, N, 4], det_mask [S, N], projs
              [S, 3, 4]) -> (states', ids [S, N] int32, det_score [S, N])

    ``states`` is a state dict with a leading [S] axis.  An inactive
    stream (``active[s]`` False) has its detections masked out, carries
    its state through bit for bit (``torch.where`` per leaf) and answers
    ids -1 and det_score 0, so a flush of k < S pending frames advances
    exactly those k streams as k per-frame steps would.

    ``compact_capacity`` C extracts features for at most C valid
    (stream, slot) pairs, valid-first in flat order (``compact_extract``),
    instead of all S * N slots; overflow detections are dropped and answer
    -1 like padding.  Crops and frustum samples stay padded: only the
    trunk compacts, as in the reference."""

    def multi(states_d, active, images, clouds, boxes, det_mask, projs):
        dev = module.device
        active = torch.as_tensor(active, device=dev).bool()
        live = torch.as_tensor(det_mask, device=dev).bool() & active[:, None]
        new, out = _frames_step(module, crop, point_len,
                                _state_from_dict(states_d), images, clouds,
                                boxes, live, projs, compact_capacity)
        with torch.inference_mode():
            def sel(n, o):
                a = active.reshape(active.shape + (1,) * (n.dim() - 1))
                return torch.where(a, n, o)

            states = _tree_map(sel, _state_to_dict(new), states_d)
            ids = torch.where(active[:, None], out["ids"], -1)
            scores = out["det_score"].float() * active[:, None].float()
        return states, ids, scores

    return multi


def _build_window_step(module: TrackingModule, crop: Tuple[int, int],
                       point_len: int, capacity: int) -> Callable:
    """The window step: one call tracks W frames of raw inputs through
    ``track_sequence_from_frames`` (compact-first at ``capacity``) and
    returns the carried state; chain calls to stream a sequence.  The
    crop band and extraction chunk are ``WINDOW_CROP`` and
    ``WINDOW_CHUNK``.

        win(state, images [W, H, Wd, 3] uint8, clouds [W, M, 4] f32,
            cloud_valid [W, M] bool, boxes [W, N, 4] f32, det_mask [W, N]
            bool, proj [3, 4] f32) -> (state', ids [W, N], det_score
            [W, N])"""

    def win(state_d, images, clouds, cloud_valid, boxes, det_mask, proj):
        out, final = track_sequence_from_frames(
            module, images, clouds, boxes, det_mask, proj, crop, point_len,
            cloud_valid=cloud_valid, compact_capacity=capacity,
            extract_chunk=WINDOW_CHUNK, crop_window=WINDOW_CROP,
            state0=_state_from_dict(state_d), return_state=True)
        return _state_to_dict(final), out["ids"], out["det_score"]

    return win


# -- exporters ------------------------------------------------------------

def _shapes(cfg):
    return tuple(cfg.data.crop_size), cfg.data.point_len, cfg.data.max_dets


def export_serve_step(out_dir: str, cfg, module: TrackingModule,
                      image_hw: Tuple[int, int], cloud_points: int) -> None:
    """Write ``module``'s per-frame serving step (``_build_step``) at
    ``cfg``'s shapes as a ``serve_step`` artifact."""
    save_artifact(out_dir, to_flax_variables(module.net),
                  _fresh_state(module, cfg.data.max_dets), cfg, image_hw,
                  cloud_points)


def export_window_step(out_dir: str, cfg, module: TrackingModule,
                       image_hw: Tuple[int, int], cloud_points: int,
                       window: int, capacity: Optional[int] = None) -> None:
    """Write the window step (``_build_window_step``; ``capacity``
    defaults to every slot, ``window * max_dets``) as a ``window``
    artifact."""
    N = cfg.data.max_dets
    save_artifact(out_dir, to_flax_variables(module.net),
                  _fresh_state(module, N), cfg, image_hw, cloud_points,
                  kind="window", extra={
                      "window": int(window),
                      "capacity": int(capacity or window * N)})


def export_multistream_step(out_dir: str, cfg, module: TrackingModule,
                            image_hw: Tuple[int, int], cloud_points: int,
                            streams: int,
                            compact_capacity: Optional[int] = None) -> None:
    """Write the multi-stream step (``_build_multistream_step``) with S
    zero states stacked on a leading axis as a ``multistream_step``
    artifact."""
    save_artifact(out_dir, to_flax_variables(module.net),
                  _stacked_state(module, cfg.data.max_dets, int(streams)),
                  cfg, image_hw, cloud_points, kind="multistream_step",
                  extra={"streams": int(streams),
                         "compact_capacity": compact_capacity})


def save_artifact(out_dir: str, variables, state0, cfg,
                  image_hw: Tuple[int, int], cloud_points: int,
                  kind: str = "serve_step",
                  extra: Optional[Dict] = None) -> None:
    """Write the artifact directory (see the module docstring):
    ``variables`` are flax-layout (``to_flax_variables``), ``state0`` the
    zero state of the ``kind`` exporter.  Unlike the reference's, it takes
    no exported program: the manifest names the step code
    (``PROGRAMS``).  ``"int8"`` says whether ``variables`` carry an int8
    trunk (``quant_int8``)."""
    os.makedirs(out_dir, exist_ok=True)
    state0 = _state_to_dict(state0)
    np.savez(os.path.join(out_dir, ARTIFACT_WEIGHTS),
             **_flatten_to_npz(variables))
    np.savez(os.path.join(out_dir, ARTIFACT_STATE0),
             **_flatten_to_npz(state0))
    manifest = {
        "format": 1,
        "kind": kind,
        "program": PROGRAMS[kind],
        "weights": ARTIFACT_WEIGHTS,
        "state0": ARTIFACT_STATE0,
        "weights_structure": _skeleton(variables),
        "state0_structure": _skeleton(state0),
        "platforms": ["cuda"],
        "config": cfg.name,
        "config_dict": config_to_dict(cfg),
        "image_hw": list(image_hw),
        "cloud_points": int(cloud_points),
        "max_dets": int(cfg.data.max_dets),
        "point_len": int(cfg.data.point_len),
        "crop_size": list(cfg.data.crop_size),
        "int8": "quant_int8" in variables,
        "torch_version": torch.__version__,
    }
    if extra:
        manifest.update(extra)
    with open(os.path.join(out_dir, ARTIFACT_MANIFEST), "w") as fh:
        json.dump(manifest, fh, indent=2)


# -- loading --------------------------------------------------------------

def _preset(name: str):
    from mmmot_tpu_torch import config as presets
    from mmmot_tpu_torch.cli.track import PRESETS

    if name not in PRESETS:
        raise ValueError(f"artifact config {name!r} is not a preset of "
                         f"mmmot_tpu_torch.config ({', '.join(PRESETS)})")
    return getattr(presets, name)()


def _artifact_config(manifest: Dict):
    """The artifact's ``Config``: built from ``config_dict`` where the
    manifest holds one (any variant the port builds), else the preset
    that ``config`` names (the JAX package's artifacts, which carry the
    name alone); a name that is no preset raises."""
    if "config_dict" in manifest:
        cfg = config_from_dict(manifest["config_dict"])
        if cfg.name != manifest["config"]:
            raise ValueError(f"manifest config {manifest['config']!r} and "
                             f"config_dict name {cfg.name!r} differ")
        return cfg
    return _preset(manifest["config"])


def _check_state0(manifest, stored, fresh, cdt, what: str) -> None:
    """The artifact's zero state against the one the port builds: the
    same fields and feats, dtypes, shapes and values.  A JAX artifact's
    feats may lack the port's carried det logits, and the JAX package
    stores every feat but ``box`` in the compute dtype ``cdt``.  The
    feats' dtypes and the state's fields and shapes are what an edited
    config that kept its preset's name shows here (compute dtype,
    revival window, what the association carries)."""
    jax_artifact = manifest.get("program") == JAX_PROGRAM
    sk, fk = set(stored["feats"]), set(fresh["feats"])
    if set(stored) != set(fresh) or not (sk <= fk if jax_artifact
                                         else sk == fk):
        raise ValueError(f"{what}: state0 {sorted(stored)} with feats "
                         f"{sorted(sk)} does not fit the port's "
                         f"{sorted(fresh)} with feats {sorted(fk)}")
    want = _skeleton(fresh)
    if jax_artifact:
        want["feats"] = {k: v if k == "box" else cdt
                         for k, v in want["feats"].items()}
    got = manifest["state0_structure"]

    def check_dtype(path, g, w):
        if isinstance(g, dict):
            for k in g:
                check_dtype(path + (k,), g[k], w[k])
        elif g != w:
            raise ValueError(f"{what}: state0 leaf {'/'.join(path)} is "
                             f"{g}, the port's preset builds {w}")

    check_dtype((), got, want)

    def check(s, f):
        s = torch.as_tensor(s).double()
        if tuple(s.shape) != tuple(f.shape) or not torch.equal(
                s, f.detach().cpu().double()):
            raise ValueError(f"{what}: a state0 leaf of shape "
                             f"{tuple(s.shape)} differs from the port's "
                             f"zero state of shape {tuple(f.shape)}")

    _tree_map(check, stored, fresh)


def _read_manifest(path: str) -> Dict:
    with open(os.path.join(path, ARTIFACT_MANIFEST)) as fh:
        return json.load(fh)


def _load_weights(net, weights, int8: bool, what: str) -> None:
    """Load flax-layout ``weights`` into ``net`` and, for an int8
    artifact, attach its ``quant_int8`` trunk; raises where the manifest's
    ``int8`` and the weights disagree."""
    has_quant = "quant_int8" in weights
    if int8 and not has_quant:
        raise ValueError(f"{what}: the manifest says int8 but the weights "
                         "hold no quant_int8 trunk")
    if has_quant and not int8:
        raise ValueError(f"{what}: the weights hold a quant_int8 trunk but "
                         "the manifest does not say int8")
    net.load_state_dict(load_flax_variables(weights, net))
    app = net.cfg.appearance
    net.quant_int8 = (quant_from_flax(weights["quant_int8"], app.depth,
                                      net.device, app.s2d_stem)
                      if int8 else None)


def _load(path: str, device):
    """(manifest, module, flax-layout weights, zero state dict) of the
    artifact at ``path``, the module on ``device``."""
    from mmmot_tpu_torch.device import resolve_device
    from mmmot_tpu_torch.models.tracking_net import TrackingNet

    manifest = _read_manifest(path)
    cfg = _artifact_config(manifest)
    for key, want in (("max_dets", cfg.data.max_dets),
                      ("point_len", cfg.data.point_len),
                      ("crop_size", list(cfg.data.crop_size))):
        if manifest[key] != want:
            raise ValueError(f"{path!r}: {key} {manifest[key]} != config "
                             f"{cfg.name}'s {want}")
    net = TrackingNet(cfg.model, device=resolve_device(device))
    with np.load(os.path.join(path, manifest["weights"])) as z:
        weights = _fill_from_npz(manifest["weights_structure"], z)
    _load_weights(net, weights, bool(manifest.get("int8")), repr(path))
    module = TrackingModule(net, cfg.assoc)
    N = cfg.data.max_dets
    fresh = _state_to_dict(_fresh_state(module, N))
    if manifest["kind"] == "multistream_step":
        fresh = _stacked_state(module, N, manifest["streams"])
    with np.load(os.path.join(path, manifest["state0"])) as z:
        stored = _fill_from_npz(manifest["state0_structure"], z)
    _check_state0(manifest, stored, fresh, _dtype_name(
        torch.empty((), dtype=net.compute_dtype)), path)
    return manifest, module, weights, fresh


class DeployedTracker:
    """Serve a ``serve_step`` artifact, the port's or the JAX package's.

    >>> trk = DeployedTracker.load("artifact_dir/")
    >>> ids, scores = trk.step(image, cloud, boxes, proj)   # per frame
    >>> trk.reset()                                         # drop tracks
    """

    def __init__(self, module: TrackingModule, state0: Dict, manifest: Dict):
        self.module = module
        self.manifest = manifest
        self._state0 = state0
        self._state = state0
        self._step = _build_step(module, tuple(manifest["crop_size"]),
                                 manifest["point_len"])
        self.frame_idx = 0

    @classmethod
    def load(cls, path: str, device="cuda") -> "DeployedTracker":
        kind = _read_manifest(path).get("kind", "serve_step")
        if kind != "serve_step":
            raise ValueError(
                f"DeployedTracker serves per-frame 'serve_step' artifacts; "
                f"{path!r} is kind {kind!r} (drive a window artifact via "
                f"load_window_step, a multi-stream one via "
                f"load_multistream_step, shapes in its manifest)")
        manifest, module, _weights, state0 = _load(path, device)
        return cls(module, state0, manifest)

    def reset(self) -> None:
        self._state = self._state0
        self.frame_idx = 0

    def step(self, image, cloud, boxes, proj):
        """Track one frame; returns (ids[n], det_score[n]) for the n input
        boxes (n <= manifest max_dets; inputs are padded internally)."""
        boxes_p, det_mask, n = _padded(boxes, self.manifest["max_dets"])
        M = self.manifest["cloud_points"]
        cloud = np.asarray(cloud, np.float32)
        if cloud.shape[0] < M:   # pad at z=0 (behind camera: never sampled)
            cloud = np.concatenate(
                [cloud, np.zeros((M - cloud.shape[0],) + cloud.shape[1:],
                                 np.float32)])
        elif cloud.shape[0] > M:
            raise ValueError(f"cloud {cloud.shape[0]} points > manifest {M}")
        self._state, ids, det_score = self._step(
            self._state, np.asarray(image, np.uint8), cloud, boxes_p,
            det_mask, np.asarray(proj, np.float32))
        self.frame_idx += 1
        return (ids[:n].cpu().tolist(), det_score[:n].cpu().tolist())


class _ArtifactProgram:
    """The program of a ``kind`` artifact, the counterpart of the
    reference's ``jax.export.deserialize(...).call``: it is called as
    ``(weights, state, *inputs)``.  ``weights`` (flax layout) and
    ``state0`` are the artifact's; other weights of the same structure
    are loaded into the module first."""

    kind = ""

    def __init__(self, path: str, device="cuda"):
        kind = _read_manifest(path).get("kind")
        if kind != self.kind:
            raise ValueError(f"{path!r} is kind {kind!r}, not a {self.kind} "
                             "artifact")
        self.manifest, module, self.weights, self.state0 = _load(path,
                                                                 device)
        self._bind(module)

    def _build(self, module: TrackingModule) -> Callable:
        raise NotImplementedError

    def _bind(self, module: TrackingModule) -> None:
        self.module = module
        self._program = self._build(module)

    def __call__(self, weights, state, *inputs):
        if weights is not self.weights:
            net = self.module.net
            _load_weights(net, weights, bool(self.manifest.get("int8")),
                          "the weights handed to the call")
            self._bind(TrackingModule(net, self.module.assoc_cfg))
            self.weights = weights
        return self._program(state, *inputs)


class WindowStep(_ArtifactProgram):
    """A ``window`` artifact's program (``_build_window_step``):

        step(weights, state, images [W, H, Wd, 3] uint8, clouds [W, M, 4]
             f32, cloud_valid [W, M] bool, boxes [W, N, 4] f32, det_mask
             [W, N] bool, proj [3, 4] f32) -> (state', ids [W, N] int32,
             det_score [W, N])"""

    kind = "window"

    def _build(self, module: TrackingModule) -> Callable:
        man = self.manifest
        return _build_window_step(module, tuple(man["crop_size"]),
                                  man["point_len"], man["capacity"])


class MultiStreamStep(_ArtifactProgram):
    """A ``multistream_step`` artifact's program
    (``_build_multistream_step`` at the manifest's ``compact_capacity``):

        multi(weights, states, active [S] bool, images [S, H, W, 3] uint8,
              clouds [S, M, 4], boxes [S, N, 4], det_mask [S, N], projs
              [S, 3, 4]) -> (states', ids [S, N] int32, det_score [S, N])

    ``state0`` holds the manifest's ``streams`` zero states."""

    kind = "multistream_step"

    def _build(self, module: TrackingModule) -> Callable:
        man = self.manifest
        return _build_multistream_step(module, tuple(man["crop_size"]),
                                       man["point_len"],
                                       man["compact_capacity"])


def load_window_step(path: str, device="cuda") -> WindowStep:
    """The program of the window artifact at ``path``."""
    return WindowStep(path, device)


def load_multistream_step(path: str, device="cuda") -> MultiStreamStep:
    """The program of the multi-stream artifact at ``path``."""
    return MultiStreamStep(path, device)
