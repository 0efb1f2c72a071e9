"""Process layout and data-parallel helpers over ``torch.distributed``:
port of ``mmmot_tpu/parallel/mesh.py`` (``make_mesh``, ``shard_batch``,
``shard_sequences``, ``replicate``), with ``gather_sequences`` to bring
per-rank outputs back in sequence order.

The reference lays its devices out as a (data, model) mesh and lets
``jit`` insert the collectives.  Here each rank is one process on one
device: ``init_distributed`` joins the group (its address, world size
and rank given explicitly), ``make_mesh`` lays the ranks out as
[num_data, num_model] (the model axis is reserved, as in the
reference: ranks of one data row hold the same shard), ``shard_batch``
gives each rank the rows of its data index, ``replicate`` broadcasts
rank 0's weights, and ``gather_sequences`` concatenates every rank's
rows in data order.  Tracking is data-parallel over sequences with no
collective inside; training all-reduces BatchNorm moments and their
backward sums (``models/layers.py::MaskedBatchNorm.group``), the loss
normalisers (``train/losses.py``) and the gradients
(``train/trainer.py::train_step``).

The backend is the caller's choice and is never switched behind its
back: ``nccl`` (the default) takes one rank a GPU and CUDA tensors;
``gloo`` takes CPU tensors, and on CUDA tensors its broadcast and
all-reduce (``gather_sequences`` stages its all-gather through the host
there, since gloo has no CUDA all-gather).  NCCL refuses two ranks on
one device; two ranks sharing a card run ``gloo``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class ParallelConfig:
    """The rank layout (the reference's ``ParallelConfig``): ``num_data``
    ranks along the data axis (-1: the world size over ``num_model``)
    by ``num_model``."""

    data_axis: str = "data"
    model_axis: str = "model"
    num_data: int = -1
    num_model: int = 1


@dataclass(frozen=True)
class Mesh:
    """Ranks [num_data, num_model] of the default process group, seen
    from one rank: its ``data_index`` (row), its ``device`` and the
    group's ``backend``."""

    ranks: np.ndarray
    axis_names: tuple
    rank: int
    device: torch.device
    backend: str

    @property
    def num_data(self) -> int:
        return self.ranks.shape[0]

    @property
    def data_index(self) -> int:
        return int(np.argwhere(self.ranks == self.rank)[0][0])

    @property
    def size(self) -> int:
        return self.ranks.size


def init_distributed(rank: int, world_size: int, address: str,
                     backend: str = "nccl",
                     device: Optional[str] = None) -> torch.device:
    """Join the default process group at ``address``
    (``tcp://host:port``) as ``rank`` of ``world_size`` over ``backend``
    and return this rank's device: with ``nccl`` ``cuda:<rank>`` unless
    ``device`` names a CUDA device by its index (NCCL takes one rank a
    GPU); with ``gloo`` ``device`` (default ``cpu``; several ranks may
    share a GPU).  Raises for ``nccl`` without CUDA or on a CPU device,
    and for an unknown backend."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs CUDA; pass "
                               "backend='gloo' for CPU ranks")
        dev = torch.device(device or "cuda")
        if dev.type != "cuda":
            raise ValueError(f"backend 'nccl' needs a CUDA device, got {dev}")
        if dev.index is None:
            dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device or "cpu")
    dist.init_process_group(backend, init_method=address, rank=rank,
                            world_size=world_size)
    return dev


def make_mesh(cfg: Optional[ParallelConfig] = None,
              world_size: Optional[int] = None, rank: Optional[int] = None,
              device="cpu") -> Mesh:
    """The [num_data, num_model] layout of ``world_size`` ranks (default:
    the process group's), seen from ``rank`` (default: this process's).
    Raises ``ValueError`` when ``num_data * num_model`` is not the world
    size, as the reference's ``make_mesh`` does for devices."""
    cfg = cfg or ParallelConfig()
    if world_size is None:
        world_size = dist.get_world_size()
    if rank is None:
        rank = dist.get_rank()
    backend = dist.get_backend() if dist.is_initialized() else "gloo"
    num_model = max(cfg.num_model, 1)
    num_data = cfg.num_data if cfg.num_data > 0 else world_size // num_model
    if num_data * num_model != world_size:
        raise ValueError(f"mesh {num_data}x{num_model} != {world_size} ranks")
    ranks = np.arange(world_size).reshape(num_data, num_model)
    return Mesh(ranks, (cfg.data_axis, cfg.model_axis), rank,
                torch.device(device), backend)


def _rows(mesh: Mesh, x):
    """This rank's rows of ``x``'s leading axis, on the mesh's device."""
    if x is None:
        return None
    x = torch.as_tensor(x)
    n = x.shape[0]
    if n % mesh.num_data:
        raise ValueError(f"leading axis {n} does not split evenly over "
                         f"{mesh.num_data} data ranks")
    per = n // mesh.num_data
    i = mesh.data_index
    return x[i * per:(i + 1) * per].to(mesh.device)


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """Every array's leading (batch) axis split over the data axis: this
    rank's contiguous share, on its device (numpy arrays or tensors;
    None stays None).  The axis must split evenly."""
    return {k: _rows(mesh, v) for k, v in batch.items()}


def shard_sequences(mesh: Mesh, arrays: Dict[str, Any]) -> Dict[str, Any]:
    """The leading sequence axis [S, T, N, ...] split over the data
    axis."""
    return shard_batch(mesh, arrays)


@torch.no_grad()
def replicate(mesh: Mesh, tree):
    """Rank 0's values on every rank: an ``nn.Module`` (parameters and
    buffers, in place) or a dict of tensors (in place), by broadcast.
    Returns ``tree``."""
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.state_dict().values())
    else:
        tensors = [v for v in tree.values() if isinstance(v, torch.Tensor)]
    for t in tensors:
        dist.broadcast(t, src=0)
    return tree


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` [n, ...] of every data rank concatenated in data order
    [num_data * n, ...] (ranks of one data row hold the same rows; the
    first of each row counts).  gloo has no all-gather of CUDA tensors,
    so there the rows go through the host and come back."""
    staged = mesh.backend == "gloo" and x.device.type == "cuda"
    y = x.detach().cpu() if staged else x.detach()
    parts = [torch.empty_like(y) for _ in range(mesh.size)]
    dist.all_gather(parts, y.contiguous())
    out = torch.cat([parts[int(r)] for r in mesh.ranks[:, 0]])
    return out.to(x.device) if staged else out


def gather_sequences(mesh: Mesh, outputs: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Per-rank tracker outputs with a leading sequence axis (ids,
    det_score, n_dropped, the ghost outputs) -> the whole S axis in
    sequence order on every rank."""
    return {k: all_gather_rows(mesh, v) for k, v in outputs.items()}

