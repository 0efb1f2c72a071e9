"""Original PyTorch mmMOT state dicts -> the port's ``TrackingNet`` state
dict: port of ``mmmot_tpu/compat/torch_convert.py``.

The reference ships ``.pth`` / ``.pth.tar`` checkpoints; the port is
PyTorch too, so no layout changes: a Conv2d weight stays [O, I, kH, kW],
a Linear weight [O, I], and a BatchNorm's weight, bias, running_mean and
running_var keep their names.  Only the 1x1 convolutions that the
reference uses as pointwise linear maps (the skip-pool reducers, the
affinity heads over the correlation volume, the PointNet's conv1d with
kernel 1) lose their trailing unit axes to become the port's Dense
[O, I].  ``torch_to_port`` walks a name-mapping table
(``compat/mappings.py``) from reference module names to the port's and
reports every source key it did not consume.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch

PortPath = Union[str, Tuple[str, ...]]


def _tensor(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().cpu()


def convert_conv_weight(w) -> torch.Tensor:
    """Conv2d [O, I, kH, kW] as it is; Conv1d with kernel 1 [O, I, 1] ->
    Dense [O, I] (the PointNet's shared per-point MLP)."""
    w = _tensor(w)
    if w.dim() == 4:
        return w
    if w.dim() == 3:
        if w.shape[-1] != 1:
            raise ValueError(f"conv1d kernel size {w.shape[-1]} != 1")
        return w[..., 0]
    raise ValueError(f"unexpected conv weight shape {tuple(w.shape)}")


def convert_linear_weight(w) -> torch.Tensor:
    """Linear [O, I] as it is."""
    w = _tensor(w)
    if w.dim() != 2:
        raise ValueError(f"not a linear weight: shape {tuple(w.shape)}")
    return w


def convert_conv1x1_weight(w) -> torch.Tensor:
    """1x1 Conv{1,2}d [O, I, 1(, 1)] -> Dense [O, I]."""
    w = _tensor(w)
    if w.dim() == 4 and tuple(w.shape[2:]) == (1, 1):
        return w[..., 0, 0]
    if w.dim() == 3 and w.shape[-1] == 1:
        return w[..., 0]
    if w.dim() == 2:
        return w
    raise ValueError(f"not a 1x1 conv weight: shape {tuple(w.shape)}")


BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def convert_bn(prefix: str, sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A BatchNorm's four tensors under ``prefix``, by their names."""
    return {k: _tensor(sd[f"{prefix}.{k}"]) for k in BN_KEYS}


def load_torch_checkpoint(path: str,
                          allow_pickle: bool = False) -> Dict[str, Any]:
    """A reference ``.pth`` / ``.pth.tar`` checkpoint as a flat state dict
    (a ``state_dict`` entry unwrapped, a ``module.`` prefix dropped).

    Loads with ``weights_only=True``: a checkpoint is untrusted content,
    and unpickling runs code.  ``allow_pickle=True`` opts in to the full
    unpickler when the restricted load fails."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        if not allow_pickle:
            raise
        import warnings

        warnings.warn(
            "weights_only load failed; falling back to UNSAFE pickle "
            "deserialization because allow_pickle=True was passed")
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k.replace("module.", "", 1) if k.startswith("module.") else k: v
            for k, v in obj.items()}


def _dotted(path: PortPath) -> str:
    return path if isinstance(path, str) else ".".join(path)


def torch_to_port(state_dict: Mapping[str, Any],
                  mapping: Mapping[str, PortPath],
                  kind: Optional[Mapping[str, str]] = None
                  ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Convert by an explicit name map.

    ``mapping``: a reference module prefix ("features.0" for a conv,
    "features.1" for its BatchNorm, "proj" for a linear) -> the port's
    module path (dotted, or a tuple of names).  ``kind`` overrides the
    detection with "conv" | "conv1x1" | "linear" | "bn".  Returns (the
    port's state-dict entries, the reference keys not consumed)."""
    kind = kind or {}
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for tname, ppath in mapping.items():
        dst = _dotted(ppath)
        k = kind.get(tname)
        wkey = f"{tname}.weight"
        if k is None:
            if f"{tname}.running_mean" in state_dict:
                k = "bn"
            elif wkey in state_dict and _tensor(state_dict[wkey]).dim() >= 3:
                k = "conv"
            else:
                k = "linear"
        if k == "bn":
            for name, v in convert_bn(tname, state_dict).items():
                out[f"{dst}.{name}"] = v
            used |= {f"{tname}.{x}" for x in
                     BN_KEYS + ("num_batches_tracked",)}
            continue
        conv = {"conv": convert_conv_weight,
                "conv1x1": convert_conv1x1_weight,
                "linear": convert_linear_weight}[k]
        out[f"{dst}.weight"] = conv(state_dict[wkey])
        used.add(wkey)
        bkey = f"{tname}.bias"
        if bkey in state_dict:
            out[f"{dst}.bias"] = _tensor(state_dict[bkey])
            used.add(bkey)
    unused = [k for k in state_dict if k not in used
              and not k.endswith("num_batches_tracked")]
    return out, unused
