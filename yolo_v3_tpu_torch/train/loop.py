"""Training orchestration: the host loop around the training step.

Port of ``yolo_v3_tpu/train/loop.py``.  The host groups ``net_subdivisions``
consecutive mini-batches into one [S, B, ...] net-batch, moves it to the
device (uint8 as it is; the step normalizes there) and runs one step
(``train/step.py``: S forwards and backwards, one update).  Multi-scale
training needs nothing more: every net-batch is one dim by construction of
the sampler's schedule, and a dim that changes inside a net-batch raises.

Checkpoints are written every ``checkpoint_interval`` net-batches and once
more at the end; ``checkpoint`` (a ``load_checkpoint`` dict) resumes a run
exactly where it stopped.  SIGTERM or SIGINT lets the net-batch in flight
finish, checkpoints and returns.

Data parallelism (``mesh``, :mod:`yolo_v3_tpu_torch.parallel`): every rank
runs this loop on its card with its host-sharded ``DataHelper`` (the
shard of its data index: the ranks of one data group assemble the same
images, and under a ``space`` axis each cuts its stripe of rows from
them); params, BN state and optimizer state are replicated from rank 0,
the step reduces over the ranks, a resume checks the checkpoint's mesh
(the data width must match, the space width may differ), and checkpoints
record the mesh's shape ``(data, space)`` (rank 0 writes them).  A SIGTERM that reaches one
rank only stops them all at the same net-batch: the flag is all-reduced
once a net-batch.  Rank 0 alone logs and feeds the recorder.
"""

from __future__ import annotations

import signal
import sys
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from yolo_v3_tpu_torch.models.darknet import map_tree
from yolo_v3_tpu_torch.parallel import mesh as M
from yolo_v3_tpu_torch.parallel.distributed import assert_mesh_compatible
from yolo_v3_tpu_torch.train.checkpoint import save_checkpoint
from yolo_v3_tpu_torch.train.optimizer import make_optimizer
from yolo_v3_tpu_torch.train.recorder import Recorder
from yolo_v3_tpu_torch.train.step import COMPUTE_DTYPES, make_train_step
from yolo_v3_tpu_torch.utils.config import TrainConfig, YoloConfig


class _PendingStats:
    """One net-batch's stats packed into one device vector, with the host
    context to log them.  Draining reads the vector back: one transfer, and
    the point where the host waits for the device."""

    def __init__(self, stats: Dict[str, torch.Tensor], net_batch, epoch, dim, n_imgs):
        self.keys = tuple(sorted(stats))
        self.packed = torch.stack([stats[k].float() for k in self.keys])
        self.net_batch, self.epoch, self.dim = net_batch, epoch, dim
        self.n_imgs = n_imgs

    def drain(self, recorder, log_fn):
        host = dict(zip(self.keys, self.packed.cpu().tolist()))
        recorder.on_batch_end(host, self.n_imgs)
        log_fn(f"net_batch {self.net_batch} epoch {self.epoch} "
               f"dim {self.dim} {recorder.stats_row()}")


def _to_device(tree, device):
    return map_tree(lambda t: torch.as_tensor(t).to(device), tree)


def train(
    data,
    params,
    state,
    config: YoloConfig,
    tcfg: TrainConfig,
    recorder: Optional[Recorder] = None,
    model_id: str = "test",
    weight_dir: Optional[str] = None,
    checkpoint: Optional[Dict] = None,
    checkpoint_interval: int = 1,
    mesh=None,
    log_fn: Callable[[str], None] = lambda s: print(s, file=sys.stderr),
    pipeline_stats: bool = False,
    device="cuda",
):
    """Run training until ``data`` (a DataHelper) is exhausted; returns
    (params, state, opt_state, recorder) with tensors on ``device`` (the
    card unless the caller asks for another; with a ``mesh``, the mesh's
    device, and ``data`` this rank's host-sharded DataHelper).

    ``pipeline_stats=True`` reads each net-batch's stats back one net-batch
    late, so the host assembles the next net-batch while the device works;
    by default they are read right after the step.
    """
    device = mesh.device if mesh is not None else torch.device(device)
    recorder = recorder or Recorder()
    if mesh is not None and mesh.rank != 0:
        log_fn = lambda s: None          # noqa: E731 (rank 0 logs for the run)

    preempted = threading.Event()
    prev_handlers = {}
    if threading.current_thread() is threading.main_thread():
        def _on_signal(signum, frame):
            log_fn(f"[preempt] signal {signum}: will checkpoint at the next "
                   "net-batch boundary and exit")
            preempted.set()

        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, _on_signal)
    try:
        return _train(data, params, state, config, tcfg, recorder, model_id, weight_dir,
                      checkpoint, checkpoint_interval, log_fn, pipeline_stats, device,
                      preempted, mesh)
    finally:
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)


def _train(data, params, state, config, tcfg, recorder, model_id, weight_dir, checkpoint,
           checkpoint_interval, log_fn, pipeline_stats, device, preempted, mesh):
    opt = make_optimizer(tcfg)
    step = make_train_step(config, opt, COMPUTE_DTYPES[tcfg.compute_dtype], tcfg.remat,
                           mesh=mesh)
    lead = mesh is None or mesh.rank == 0
    data_ranks = mesh.data_size if mesh is not None else 1

    if checkpoint is not None:
        if checkpoint["opt_state"] is None:
            raise ValueError(
                "this checkpoint has no optimizer state the port can read (a JAX "
                "run's optax state, or a bare {params, state} tree): resuming it is "
                "not supported; start a new run from its params and state instead")
        if mesh is not None:
            assert_mesh_compatible(mesh, checkpoint.get("mesh_shape"))
        data.load_state_dict(checkpoint["data"])
        params, state = checkpoint["params"], checkpoint["state"]
        opt_state = {"count": checkpoint["opt_state"]["count"],
                     "trace": _to_device(checkpoint["opt_state"]["trace"], device)}
        if checkpoint["recorder"] is not None:
            recorder.load_state_dict(checkpoint["recorder"])
    params, state = _to_device(params, device), _to_device(state, device)
    if checkpoint is None:
        opt_state = opt.init(params)
    if mesh is not None:
        params, state, opt_state = (M.replicate(mesh, t) for t in (params, state, opt_state))

    S = data.net_subdivisions
    micro_imgs, micro_labels = [], []
    pending: Optional[_PendingStats] = None
    last_ckpt_batch = batch = -1
    t_start = time.time()
    for sample in data:
        micro_imgs.append(sample["img"])
        micro_labels.append(sample["label"])
        batch = data.get_batch()

        if len(micro_imgs) == S:
            dims = {m.shape for m in micro_imgs}
            if len(dims) != 1:
                raise ValueError(
                    "multi-scale dim changed mid-net-batch "
                    f"({sorted(dims)}); set the sampler's rand_dim_interval "
                    "to a multiple of batch_size * net_subdivisions")
            imgs = np.stack(micro_imgs)
            # uint8 rides to the device as it is (the step normalizes there);
            # anything else is finalized to float32 here
            if imgs.dtype not in (np.float32, np.uint8):
                imgs = imgs.astype(np.float32)
            labels = np.stack(micro_labels).astype(np.float32, copy=False)
            micro_imgs, micro_labels = [], []

            x, y = torch.from_numpy(imgs), torch.from_numpy(labels)
            x, y = (M.shard_train_inputs(mesh, x, y) if mesh is not None
                    else (x.to(device), y.to(device)))
            params, state, opt_state, stats = step(params, state, opt_state, x, y)

            if pending is not None:
                pending.drain(recorder, log_fn)
                pending = None
            if lead:
                pending = _PendingStats(stats, data.get_net_batch(), data.get_epoch(),
                                        imgs.shape[2], imgs.shape[0] * imgs.shape[1] * data_ranks)
                if not pipeline_stats:
                    pending.drain(recorder, log_fn)
                    pending = None
            # every rank stops at the net-batch where any rank was signalled
            stop = (mesh.any_rank(preempted.is_set()) if mesh is not None
                    else preempted.is_set())

            # checkpoint every checkpoint_interval net-batches (batch + 1 is
            # S-aligned here); the recorder must be current, so drain first
            if weight_dir is not None and (
                    stop or (batch + 1) % (S * checkpoint_interval) == 0):
                if pending is not None:
                    pending.drain(recorder, log_fn)
                    pending = None
                save_checkpoint(data, params, state, opt_state, recorder, model_id,
                                weight_dir, mesh=mesh)
                last_ckpt_batch = batch

            if stop:
                if pending is not None:
                    pending.drain(recorder, log_fn)
                    pending = None
                log_fn(f"[preempt] checkpointed at net_batch "
                       f"{recorder.net_batches_seen}; exiting")
                break

        if data.is_end_of_epoch():
            recorder.on_epoch_end()

    if pending is not None:
        pending.drain(recorder, log_fn)

    # Always leave a checkpoint of the final state, also when the run's
    # length is not a multiple of the interval.  The in-loop batch counter is
    # compared: the DataHelper's runs one past the last batch on exhaustion.
    if (weight_dir is not None and last_ckpt_batch != batch
            and micro_imgs == [] and batch >= 0):
        save_checkpoint(data, params, state, opt_state, recorder, model_id, weight_dir,
                        mesh=mesh)
        log_fn(f"[finish] final checkpoint at net_batch {recorder.net_batches_seen}")

    log_fn(f"[finish] net_batch {data.get_net_batch()} batch {data.get_batch()} "
           f"({time.time() - t_start:.1f}s)")
    return params, state, opt_state, recorder
