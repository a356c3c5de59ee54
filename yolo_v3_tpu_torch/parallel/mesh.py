"""The mesh ``(data, space)``: one process a card, the batch split over the
``data`` axis and each image's rows over the ``space`` axis.

Port of ``yolo_v3_tpu/parallel/mesh.py``.  There a ``jax.sharding.Mesh``
spans the devices of a slice and XLA inserts the collectives; here every
rank is one process that drives one card (``torchrun`` starts them,
:mod:`~yolo_v3_tpu_torch.parallel.distributed` joins them), holds a full
copy of the params, BN state and optimizer state, and runs the same step on
its own part of every global batch.  The collectives are explicit: BN
statistics over the global batch (``models/darknet.py``), one gradient
all-reduce per net-batch (``train/step.py``), and under ``space`` > 1 the
halo rows around every 3x3 conv and the gather of the heads
(:mod:`~yolo_v3_tpu_torch.parallel.halo`).

Rank ``r`` of a ``(data, space)`` mesh has data index ``r // space`` and
space index ``r % space``: the ranks of one image are adjacent, as in the
JAX file's ``reshape(n // space, space)``.  A rank holds its data shard of
the batch (what its host-sharded ``DataHelper`` assembles) and, with
``space`` > 1, its stripe of those images' rows (:func:`stripe_bounds`).
Stripes are whole multiples of 32 input rows, so every stride-2 conv and
every x2 upsample stays inside a stripe, and only the 3x3 convs need rows
of a neighbour.

A :class:`Mesh` is a small frozen record of this rank's place: the shape,
its rank, the world size, its card and the process groups.  The JAX file's
``NamedSharding`` helpers (``batch_sharding``, ``replicated``,
``shard_batch``) have no counterpart: with one process a card there is
nothing to place, and :func:`shard_train_inputs`, :func:`data_shard` and
:func:`stripe` cut this rank's part out of a batch.  The JAX
file's Shardy/GSPMD partitioner switch has no counterpart either (ROADMAP,
"Do not port").
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPACE_AXIS = "space"
# a stripe is a whole number of these input rows: the net's largest stride
STRIPE_ROWS = 32


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the ``(data, space)`` mesh.  ``group`` is None
    when no process group is initialized (one process, no collectives);
    ``data_group`` (the ranks that hold the same stripe of other images) and
    ``space_group`` (the ranks that hold the same images) are None where
    their axis has one rank."""

    shape: Tuple[int, int]
    rank: int
    world_size: int
    device: torch.device
    group: Optional[Any] = None
    data_group: Optional[Any] = None
    space_group: Optional[Any] = None

    @property
    def data_size(self) -> int:
        return self.shape[0]

    @property
    def space_size(self) -> int:
        return self.shape[1]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[1]

    @property
    def space_index(self) -> int:
        return self.rank % self.shape[1]

    @property
    def bn_group(self):
        """The group BN statistics are reduced over: the world (both axes,
        as ``jnp.var`` over a ``(data, space)``-sharded batch), or None at
        world size 1, where the single-process BN runs unchanged."""
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


def stripe_bounds(height: int, space: int) -> List[Tuple[int, int]]:
    """The ``space`` stripes of ``height`` rows, as (start, stop): with
    R = height / 32, the first R % space stripes get ceil(R / space) * 32
    rows and the rest floor(R / space) * 32 (416 at 2: 224 / 192)."""
    if height % STRIPE_ROWS:
        raise ValueError(f"height {height} is not a multiple of {STRIPE_ROWS}: the space "
                         "axis splits an image into stripes of whole 32-row bands")
    r = height // STRIPE_ROWS
    if r < space:
        raise ValueError(f"height {height} has {r} bands of {STRIPE_ROWS} rows, fewer "
                         f"than space={space} stripes")
    bounds, start = [], 0
    for s in range(space):
        rows = (r // space + (s < r % space)) * STRIPE_ROWS
        bounds.append((start, start + rows))
        start += rows
    return bounds


def _subgroups(group, data: int, space: int, rank: int):
    """(data_group, space_group) of ``rank``: the world where an axis spans
    it, else a subgroup.  Every rank creates every subgroup, in the same
    order, as ``new_group`` requires."""
    if space == 1:
        return group, None
    if data == 1:
        return None, group
    data_group = space_group = None
    for s in range(space):
        g = dist.new_group([d * space + s for d in range(data)])
        if rank % space == s:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * space + s for s in range(space)])
        if rank // space == d:
            space_group = g
    return data_group, space_group


def make_mesh(n_devices: Optional[int] = None, space: int = 1, device=None) -> Mesh:
    """The mesh over every rank of the initialized process group (one rank
    when there is none), shape ``(world / space, space)``.  ``device`` is
    this rank's card, ``cuda:LOCAL_RANK`` (the launcher's variable, else
    the rank) unless the caller names one.  ``n_devices``, where given,
    must be the world size: a rank drives one card."""
    if dist.is_available() and dist.is_initialized():
        group, rank, world = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, world = None, 0, 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has {world} "
                         "ranks (one card a rank)")
    if space < 1 or world % space:
        raise ValueError(f"{world} rank(s) do not split into stripes of space={space}")
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    data_group = space_group = None
    if group is not None and world > 1:
        data_group, space_group = _subgroups(group, world // space, space, rank)
    return Mesh((world // space, space), rank, world, torch.device(device), group,
                data_group, space_group)


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


def stripe(mesh: Mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's stripe of ``x``'s rows along ``dim`` (all of them at
    ``space`` 1)."""
    if mesh.space_size == 1:
        return x
    start, stop = stripe_bounds(x.shape[dim], mesh.space_size)[mesh.space_index]
    return x.narrow(dim, start, stop - start)


def data_slice(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous part of a batch of ``n``."""
    d = mesh.data_size
    if n % d:
        raise ValueError(f"a batch of {n} does not split over data={d} ranks")
    return slice(mesh.data_index * (n // d), (mesh.data_index + 1) * (n // d))


def data_shard(mesh: Mesh, x):
    """This rank's contiguous part of a batch: ``x``'s axis 0 (a tensor,
    an array or a list of images)."""
    return x[data_slice(mesh, len(x))]


def shard_train_inputs(mesh: Mesh, imgs, labels):
    """This rank's part of a net-batch on its card: ``imgs`` [S, B / data,
    H, W, 3] and ``labels`` [S, B / data, T, 5], as its host-sharded
    ``DataHelper`` assembles them; the images are cut to this rank's
    stripe of rows, the labels stay whole."""
    imgs = stripe(mesh, torch.as_tensor(imgs), 2)
    return imgs.contiguous().to(mesh.device), torch.as_tensor(labels).to(mesh.device)

