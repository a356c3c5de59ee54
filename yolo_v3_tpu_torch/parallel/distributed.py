"""Multi-process bootstrap: process group, mesh, host-sharded data.

Port of ``yolo_v3_tpu/parallel/distributed.py``.  Every rank runs the same
program on its own card; :func:`initialize` joins them into one
``torch.distributed`` process group, the mesh spans them, and the
deterministic data schedule hands each rank its contiguous shard of every
global batch (``DataHelper(host_id, n_hosts)``: the shards concatenate to
the single-process batch, so determinism and resume carry over).

Launch with ``torchrun``, which sets the variables :func:`initialize`
reads::

    torchrun --nproc-per-node N -m yolo_v3_tpu_torch.cli train --data-parallel ...

or by hand on each rank::

    from yolo_v3_tpu_torch.parallel import distributed as dist

    ctx = dist.initialize()                 # no-op for one process
    mesh = dist.make_global_mesh()
    data = dist.make_data_helper(dataset, sampler, ctx, ...)
    train(data, params, state, config, tcfg, mesh=mesh)

The backend is NCCL, which needs a card of its own for every rank.  Gloo is
used only when the caller names it (CPU ranks; several ranks sharing one
card, whose CUDA tensors gloo reduces through the host).

Height sharding: ``make_global_mesh(space=s)`` splits the ranks into
data groups of ``s`` adjacent ranks that hold one shard of images, each
rank a stripe of their rows; ``make_data_helper(..., space=s)`` gives the
ranks of a data group the same shard.

Checkpoint contract: ``save_checkpoint(..., mesh_shape=mesh.shape)``
records the mesh ``(data, space)``, so a resume can check that the
data-parallel width matches (:func:`assert_mesh_compatible`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from yolo_v3_tpu_torch.parallel import mesh as M


@dataclasses.dataclass(frozen=True)
class ProcessContext:
    process_id: int
    num_processes: int
    coordinator: Optional[str]
    local_rank: int = 0

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> ProcessContext:
    """Join this process to the run's process group when a multi-process run
    is configured; with one process it does nothing.

    Explicit arguments come first, then the launcher's variables
    (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, as ``torchrun`` sets them).
    ``coordinator_address`` is ``host:port`` of rank 0's store.
    ``backend`` defaults to ``"nccl"``, which needs a card for every rank
    of the host and raises otherwise; ``"gloo"`` only when named.  Safe to
    call unconditionally: entry points call it first."""
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE") or 1
    if process_id is None:
        process_id = _env_int("RANK") or 0
    local_rank = _env_int("LOCAL_RANK")
    local_rank = process_id if local_rank is None else local_rank

    if dist.is_initialized():
        return ProcessContext(dist.get_rank(), dist.get_world_size(),
                              coordinator_address, local_rank)
    if num_processes <= 1:
        return ProcessContext(0, 1, None, 0)
    if coordinator_address is None:
        raise ValueError(
            f"{num_processes} processes but no coordinator address: pass "
            "coordinator_address='host:port' or set MASTER_ADDR / MASTER_PORT")
    backend = backend or "nccl"
    if backend == "nccl":
        local_world = _env_int("LOCAL_WORLD_SIZE") or num_processes
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_world > cards:
            raise ValueError(
                f"nccl needs one card a rank: {local_world} ranks on this host, "
                f"{cards} card(s); run fewer ranks, or name backend='gloo'")
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return ProcessContext(process_id, num_processes, coordinator_address, local_rank)


def make_global_mesh(space: int = 1, n_devices: Optional[int] = None, device=None):
    """The mesh over every rank of the process group, shape
    ``(world / space, space)``: the batch split over the ``data`` axis,
    each image's rows over the ``space`` axis."""
    return M.make_mesh(n_devices=n_devices, space=space, device=device)


def make_data_helper(dataset, sampler, ctx: ProcessContext, space: int = 1, **kw):
    """A DataHelper sharded for this process's data index: with ``space``
    ranks an image, rank ``process_id`` is data index ``process_id //
    space`` of ``num_processes / space``, and assembles that contiguous
    slice of every global batch (the same images on every rank of its data
    group; each cuts its own stripe of rows from them)."""
    from yolo_v3_tpu_torch.data.loader import DataHelper

    n = max(ctx.num_processes, 1)
    if n % space:
        raise ValueError(f"{n} process(es) do not split into space={space}")
    return DataHelper(dataset, sampler, host_id=ctx.process_id // space,
                      n_hosts=n // space, **kw)


# The JAX names: there they assemble global jax.Arrays from each process's
# piece; here a rank's piece is all it holds.
shard_train_inputs_global = M.shard_train_inputs
replicate_global = M.replicate


def assert_mesh_compatible(mesh, ckpt_mesh_shape) -> None:
    """Resume guard: the data-axis size must match the checkpointed run's
    (the global batch layout depends on it); the space axis may differ."""
    if ckpt_mesh_shape is None:
        return
    if tuple(mesh.shape)[0] != tuple(ckpt_mesh_shape)[0]:
        raise ValueError(
            f"checkpoint was written with mesh {tuple(ckpt_mesh_shape)}; "
            f"current mesh {tuple(mesh.shape)} has a different "
            "data-parallel width - resume would change the global batch")
