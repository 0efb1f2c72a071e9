"""flax variables <-> ``TrackingNet`` state dict.

Inverse of ``mmmot_tpu/compat/torch_convert.py``: conv kernels HWIO ->
OIHW, Dense kernels [in, out] -> [out, in], MaskedBatchNorm scale / bias /
mean / var -> weight / bias / running_mean / running_var (eps 1e-5 on
both sides).  The input is the JAX package's ``{"params": ...,
"batch_stats": ...}`` as nested dicts of numpy arrays; nothing here reads
JAX.  ``to_flax_variables`` goes the other way (the port's deployment
artifacts store weights in the flax layout).  ``save_npz``/``load_npz``
carry those dicts across as one flat numpy archive (the track CLI's
``--weights``).  The int8 trunk's ``quant_int8`` tree (``in_scale``, a
tuple of per-layer ``{"w", "m", "b"}`` dicts, a tuple of stage scales)
crosses as ``quant_from_flax``; ``to_flax_variables`` adds it back when
the net carries one.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _convert(leaf: str, value) -> torch.Tensor:
    # A bfloat16 leaf arrives as a tensor: numpy has no bfloat16.
    arr = (value.float().numpy() if isinstance(value, torch.Tensor)
           else np.asarray(value, np.float32))
    if leaf == "kernel":
        if arr.ndim == 4:                                # HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:                              # [in,out] -> [out,in]
            arr = arr.T
        else:
            raise ValueError(f"unexpected kernel rank {arr.ndim}")
    return torch.tensor(arr)


def load_flax_variables(variables_np: Mapping, net) -> Dict[str, torch.Tensor]:
    """State dict for ``net`` (a ``TrackingNet``) from flax variables.

    Raises on any leaf that maps to no tensor of ``net``, any tensor of
    ``net`` that no leaf fills, and any shape mismatch.  The structure is
    the net's: no ``bn_i`` without ``batch_norm``, conv_0 on 12 input
    channels with the space-to-depth stem; each tensor comes in the
    dtype of the net's (``param_dtype`` for parameters, rounded to
    nearest even as the reference's ``astype``).
    """
    out: Dict[str, torch.Tensor] = {}
    for coll, names in (("params", _PARAM_LEAVES),
                        ("batch_stats", _STAT_LEAVES)):
        for path, value in _flatten(variables_np.get(coll, {})):
            if path[-1] not in names:
                raise KeyError(f"unknown {coll} leaf {'/'.join(path)}")
            key = ".".join(path[:-1] + (names[path[-1]],))
            out[key] = _convert(path[-1], value)
    want = net.state_dict()
    unused = sorted(set(out) - set(want))
    missing = sorted(set(want) - set(out))
    if unused or missing:
        raise KeyError(f"flax -> torch bridge: unused leaves {unused}, "
                       f"missing tensors {missing}")
    for k, v in out.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: flax shape {tuple(v.shape)} != torch "
                             f"shape {tuple(want[k].shape)}")
        out[k] = v.to(want[k].dtype)    # parameters in ``param_dtype``
    return out


def quant_from_flax(tree: Mapping, depth: int, device="cpu",
                    s2d_stem: bool = False):
    """A ``QuantizedAppearance`` (VGG ``depth``, with or without the
    space-to-depth stem) on ``device`` from the reference's
    ``quant_int8`` tree of arrays; the conv weights are repacked once
    into the kernel's layout."""
    from mmmot_tpu_torch.models.quantize import QuantizedAppearance

    layers = [{k: np.asarray(v[k]) for k in ("w", "m", "b")}
              for v in tree["layers"]]
    return QuantizedAppearance(
        depth, np.asarray(tree["in_scale"], np.float32), layers,
        [np.asarray(s, np.float32) for s in tree["stage_scales"]], s2d_stem
    ).to(device)


def to_flax_variables(net) -> Dict[str, Dict]:
    """The flax variables ``{"params": ..., "batch_stats": ...}`` of
    ``net`` (a ``TrackingNet``) as nested dicts of float32 numpy arrays:
    the exact inverse of :func:`load_flax_variables`.  A 1-D ``weight``
    is a BatchNorm scale, a 2-D or 4-D one a Dense or conv kernel.  A net
    with an int8 trunk adds its ``quant_int8`` tree."""
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, t in net.state_dict().items():
        *path, leaf = key.split(".")
        arr = t.detach().float().cpu().numpy()
        if leaf in _STAT_LEAVES.values():
            coll, name = "batch_stats", leaf[len("running_"):]
        elif leaf == "bias":
            coll, name = "params", "bias"
        elif leaf == "weight" and arr.ndim == 1:
            coll, name = "params", "scale"
        elif leaf == "weight" and arr.ndim in (2, 4):
            coll, name = "params", "kernel"
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        else:
            raise KeyError(f"torch -> flax bridge: no flax leaf for {key} "
                           f"of shape {tuple(arr.shape)}")
        node = out[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(arr)
    if net.quant_int8 is not None:
        out["quant_int8"] = net.quant_int8.to_flax()
    return out


def save_npz(path: str, variables: Mapping) -> None:
    """Write flax variables (nested dicts of arrays) as a flat numpy
    archive: one array per leaf, keyed by its '/'-joined path
    (``params/appear_net/.../kernel``, ``batch_stats/.../mean``)."""
    np.savez(path, **{"/".join(p): np.asarray(v)
                      for p, v in _flatten(variables)})


def load_npz(path: str) -> Dict:
    """Inverse of :func:`save_npz`: the nested ``{"params": ...,
    "batch_stats": ...}`` dicts of numpy arrays that
    :func:`load_flax_variables` takes."""
    out: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            *heads, leaf = key.split("/")
            node = out
            for h in heads:
                node = node.setdefault(h, {})
            node[leaf] = z[key]
    return out
