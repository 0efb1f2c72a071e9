"""Structured scalar logging: port of ``mmmot_tpu/utils/scalars.py`` as
JSONL only (one ``{"step", "tag", "value", "wall_time"}`` object a line
in ``<log_dir>/scalars.jsonl``)."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class ScalarWriter:
    """Append-only JSONL scalar sink."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def write(self, step: int, **scalars: float) -> None:
        now = time.time()
        for tag, value in scalars.items():
            if value is None:
                continue
            self._jsonl.write(json.dumps(
                {"step": int(step), "tag": tag, "value": float(value),
                 "wall_time": now}) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()


def read_scalars(log_dir: str, tag: Optional[str] = None):
    """The records of ``log_dir`` (those of ``tag`` only, if given)."""
    out = []
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if tag is None or rec["tag"] == tag:
                out.append(rec)
    return out
