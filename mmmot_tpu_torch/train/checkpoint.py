"""Checkpoints with ``torch.save``: port of
``mmmot_tpu/train/checkpoint.py`` (orbax there).

``<dir>/<step>/state.pt`` holds the model's state dict (parameters and
BatchNorm running statistics), the optimizer's state dict, the step and
optional metrics; the last ``keep`` steps are kept.  The trainer keeps
its best-validation checkpoint in ``<dir>_best`` with ``keep=1``.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import torch

STATE_FILE = "state.pt"


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit() and os.path.isfile(
                      os.path.join(ckpt_dir, d, STATE_FILE)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def save_checkpoint(ckpt_dir: str, state, step: int, keep: int = 3,
                    metrics: Optional[Dict[str, float]] = None) -> None:
    """Write ``state`` (a ``TrainState``) as step ``step``; drop the
    oldest steps beyond ``keep``."""
    d = os.path.join(ckpt_dir, str(int(step)))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, STATE_FILE + ".tmp")
    torch.save({"model": state.net.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": int(state.step),
                "metrics": dict(metrics or {})}, tmp)
    os.replace(tmp, os.path.join(d, STATE_FILE))
    for old in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))


def _load(ckpt_dir: str, step: Optional[int], device) -> Dict:
    step = latest_step(ckpt_dir) if step is None else step
    path = None if step is None else os.path.join(ckpt_dir, str(step),
                                                  STATE_FILE)
    if path is None or not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
    return torch.load(path, map_location=device, weights_only=True)


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None):
    """Load step ``step`` (default: the latest) into ``state``, a
    ``TrainState`` of the same model and optimizer (the template);
    returns it.  Raises ``FileNotFoundError`` without a checkpoint."""
    payload = _load(ckpt_dir, step, state.net.device)
    state.net.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = payload["step"]
    return state


def load_weights(ckpt_dir: str, net, step: Optional[int] = None) -> Dict:
    """Load only the model's weights (parameters and running statistics)
    of step ``step`` (default: the latest) into ``net``; returns the
    checkpoint's metrics."""
    payload = _load(ckpt_dir, step, net.device)
    net.load_state_dict(payload["model"])
    return payload["metrics"]
