"""The data-parallel mesh: one process a card, the batch split over ranks.

Port of ``yolo_v3_tpu/parallel/mesh.py``.  There a ``jax.sharding.Mesh``
spans the devices of a slice and XLA inserts the collectives; here every
rank is one process that drives one card (``torchrun`` starts them,
:mod:`~yolo_v3_tpu_torch.parallel.distributed` joins them), holds a full
copy of the params, BN state and optimizer state, and runs the same step on
its own shard of every global batch.  The collectives are explicit: BN
statistics over the global batch (``models/darknet.py``), one gradient
all-reduce per net-batch (``train/step.py``).

A :class:`Mesh` is a small frozen record of this rank's place: the shape
``(data, space)``, its rank, the world size, its card and the process group.
The JAX file's ``NamedSharding`` helpers (``batch_sharding``,
``replicated``, ``shard_batch``) have no counterpart: with one process a
card there is nothing to place; a rank's shard is what its host-sharded
``DataHelper`` assembles, and :func:`shard_train_inputs` moves it to the
card.  The ``space`` axis (height sharding) is not ported (ROADMAP, queue
A), nor is the JAX file's Shardy/GSPMD partitioner switch (ROADMAP, "Do not
port").
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPACE_AXIS = "space"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the data-parallel mesh.  ``group`` is None when
    no process group is initialized (one process, no collectives)."""

    shape: Tuple[int, int]
    rank: int
    world_size: int
    device: torch.device
    group: Optional[Any] = None

    @property
    def bn_group(self):
        """The group BN statistics are reduced over: None at world size 1,
        where the single-process BN runs unchanged."""
        return self.group if self.world_size > 1 else None

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def any_rank(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is True on any (one all-reduce)."""
        if self.group is None:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())


def make_mesh(n_devices: Optional[int] = None, space: int = 1, device=None) -> Mesh:
    """The mesh over every rank of the initialized process group (one rank
    when there is none), shape ``(world, space)``.  ``device`` is this
    rank's card, ``cuda:LOCAL_RANK`` (the launcher's variable, else the
    rank) unless the caller names one.  ``n_devices``, where given, must be
    the world size: a rank drives one card."""
    if space > 1:
        raise NotImplementedError(
            "space > 1 (height sharding) is not ported (ROADMAP queue A): one "
            "process a card shards the batch only")
    if dist.is_available() and dist.is_initialized():
        group, rank, world = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, world = None, 0, 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has {world} "
                         "ranks (one card a rank)")
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return Mesh((world, space), rank, world, torch.device(device), group)


def _broadcast_leaf(mesh: Mesh, x):
    if isinstance(x, torch.Tensor):
        t = x.detach().to(mesh.device).clone()
        if mesh.group is not None:
            dist.broadcast(t, src=0, group=mesh.group)
        return t
    if isinstance(x, (int, float)):
        return type(x)(_broadcast_leaf(mesh, torch.tensor(x, dtype=torch.float64)).item())
    raise TypeError(f"cannot replicate a leaf of type {type(x).__name__}")


def replicate(mesh: Mesh, tree):
    """A copy of ``tree`` (nested dicts of tensors and Python numbers) on
    this rank's card, every leaf broadcast from rank 0."""
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    return _broadcast_leaf(mesh, tree)


def shard_train_inputs(mesh: Mesh, imgs, labels):
    """This rank's shard of a net-batch (``[S, B / world, H, W, 3]`` images,
    ``[S, B / world, T, 5]`` labels, as its host-sharded ``DataHelper``
    assembles them) on this rank's card."""
    return (torch.as_tensor(imgs).to(mesh.device),
            torch.as_tensor(labels).to(mesh.device))
