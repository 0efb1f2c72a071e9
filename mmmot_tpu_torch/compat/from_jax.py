"""flax variables -> ``TrackingNet`` state dict.

Inverse of ``mmmot_tpu/compat/torch_convert.py``: conv kernels HWIO ->
OIHW, Dense kernels [in, out] -> [out, in], MaskedBatchNorm scale / bias /
mean / var -> weight / bias / running_mean / running_var (eps 1e-5 on
both sides).  The input is the JAX package's ``{"params": ...,
"batch_stats": ...}`` as nested dicts of numpy arrays; nothing here reads
JAX.
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
    arr = np.asarray(value, np.float32)
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
    ``net`` that no leaf fills, and any shape mismatch.
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
    return out
