"""The training step: subdivisions, gradient accumulation, one update.

Port of ``yolo_v3_tpu/train/step.py``.  A net-batch is ``S`` micro-batches
(``imgs`` [S, B, H, W, 3], ``labels`` [S, B, T, 5]) run one after another:
the BatchNorm running statistics thread through them as the reference's
per-forward updates do, the gradients are summed (the loss is a sum, so
accumulation equals one large batch up to BN's per-micro-batch statistics),
the stats are averaged, and the optimizer clips once and applies once.

``compute_dtype=torch.bfloat16`` casts the whole param tree (BN scale and
bias included) and the images to bf16 inside the differentiated function,
so the convs run and round in bf16 while the master params, gradients, BN
statistics and the loss stay fp32.  The casts are written out rather than
left to ``torch.autocast``, whose cast policy differs.  Everything runs with
TF32 off, so an fp32 step is fp32 throughout, backward included.

With a ``mesh`` of a data-parallel run (:mod:`~yolo_v3_tpu_torch.parallel.
mesh`) each rank runs the step on its shard of the global net-batch: BN
takes its statistics over the global batch, and after the S micro-batches
the gradients and the stats are all-reduced once, in one flat buffer,
before the clip sees them.  The loss is a sum over images (the stats divide
by the local batch, the differentiated loss does not), so the global
gradient is the SUM of the ranks' gradients; the loss terms of the stats
are averaged over the ranks and ``nCorrect`` / ``nGT`` summed, and recall
is taken after.  Every rank then applies the same update to the same
params, so the ranks stay bit-equal.  ``DistributedDataParallel`` does not
apply: the step is a function of param trees, not an ``nn.Module``.

Under a ``space`` axis (``mesh.shape`` = (data, space), space > 1) a rank
holds a stripe of its data shard's rows.  The forward exchanges halo rows
around every 3x3 conv, and the loss gathers the three heads over the space
group (``parallel/halo.py::gather_rows``), so every space rank computes the
loss of its data shard's whole images.  The gather's backward sums the
space ranks' gradients of each stripe, so each rank differentiates its loss
divided by ``space``: each image's loss reaches the gradients once.  The
flat all-reduce still sums over the whole world: over the data axis that
sums over images, over the space axis the partial weight gradients of each
stripe's rows.  The stats are the same on every space rank of a data
group, so the counts are divided by ``space`` after the sum (the loss
terms, divided by the world size, are then the data ranks' mean).
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from yolo_v3_tpu_torch.models import darknet as D
from yolo_v3_tpu_torch.models.loss import yolo_loss
from yolo_v3_tpu_torch.parallel.halo import gather_rows
from yolo_v3_tpu_torch.parallel.mesh import STRIPE_ROWS
from yolo_v3_tpu_torch.train.optimizer import _build, _leaves
from yolo_v3_tpu_torch.utils.config import YoloConfig
from yolo_v3_tpu_torch.utils.precision import full_fp32

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# stats that are counts over the batch: summed over the ranks, not averaged
_COUNTS = ("nCorrect", "nGT")


def loss_fn(params, state, imgs, labels, config: YoloConfig,
            compute_dtype: torch.dtype = torch.float32, mesh=None):
    """Forward + loss on one micro-batch; returns (loss, (stats, new BN
    state)).  A uint8 batch is normalized here, on its device, as
    ``float32 / 255``.  ``mesh``: BN over the global batch of its ranks
    (``models/darknet.py::conv_bn_leaky``); with ``space`` > 1, ``imgs`` is
    this rank's stripe of rows and the heads are gathered whole before the
    loss, which is that of the data shard's images."""
    if imgs.dtype == torch.uint8:
        imgs = imgs.to(torch.float32) / 255.0
    if compute_dtype != torch.float32:
        params = D.map_tree(lambda a: a.to(compute_dtype), params)
        imgs = imgs.to(compute_dtype)
    raws, new_state = D.apply_yolonet(params, state, imgs, training=True, mesh=mesh)
    img_dim = imgs.shape[1]
    if mesh is not None and mesh.space_size > 1:
        raws = tuple(gather_rows(r, mesh) for r in raws)
        img_dim = raws[0].shape[1] * STRIPE_ROWS
    loss, stats = yolo_loss(raws, labels, config, img_dim)
    return loss, (stats, new_state)


def _all_reduce_grads_and_stats(grads, stats: Dict[str, torch.Tensor], mesh):
    """Sum the gradient tree and the stats over the ranks of ``mesh`` in one
    flat all-reduce; the stats' loss terms come back as the ranks' mean."""
    items = _leaves(grads)
    keys = sorted(stats)
    buf = torch.cat([g.reshape(-1) for _, g in items]
                    + [torch.stack([stats[k].to(items[0][1].dtype) for k in keys])])
    torch.distributed.all_reduce(buf, group=mesh.group)
    parts = torch.split(buf, [g.numel() for _, g in items] + [len(keys)])
    grads = _build([p for p, _ in items], [t.view_as(g) for t, (_, g) in zip(parts, items)])
    # every space rank of a data group has the same stats: the counts are
    # summed over the data axis, the loss terms averaged over it
    stats = {k: (v / mesh.space_size if k in _COUNTS else v / mesh.world_size)
             .to(stats[k].dtype) for k, v in zip(keys, parts[-1])}
    return grads, stats


def make_train_step(config: YoloConfig, opt, compute_dtype: torch.dtype = torch.float32,
                    remat: bool = False, mesh=None):
    """A net-batch step ``(params, state, opt_state, imgs, labels) -> (params,
    state, opt_state, stats)`` for the optimizer ``opt``
    (:class:`~yolo_v3_tpu_torch.train.optimizer.SGD`).  ``remat`` recomputes
    each micro-batch's forward during its backward
    (``torch.utils.checkpoint``) instead of keeping its activations.
    ``mesh``: a data-parallel step on this rank's shard, and its stripe of
    rows under ``space`` > 1 (module doc); a mesh without a process group
    (one process) changes nothing."""
    base = functools.partial(loss_fn, config=config, compute_dtype=compute_dtype, mesh=mesh)
    reduce = mesh is not None and mesh.group is not None
    # the gather's backward sums the space ranks' gradients of one image
    space = mesh.space_size if mesh is not None else 1

    def micro(leaves, state, im, lb):
        if remat:
            return checkpoint(base, leaves, state, im, lb, use_reentrant=False)
        return base(leaves, state, im, lb)

    def train_step(params, state, opt_state, imgs, labels):
        leaves = D.map_tree(lambda p: p.detach().requires_grad_(True), params)
        per_micro = []
        with full_fp32():
            for s in range(imgs.shape[0]):
                loss, (stats, state) = micro(leaves, state, imgs[s], labels[s])
                (loss / space if space > 1 else loss).backward()
                per_micro.append(stats)
        grads = D.map_tree(lambda p: p.grad, leaves)
        stats: Dict[str, torch.Tensor] = {
            k: torch.stack([st[k].detach() for st in per_micro]).mean(dim=0)
            for k in per_micro[0]}
        if reduce:
            grads, stats = _all_reduce_grads_and_stats(grads, stats, mesh)
        stats["recall"] = torch.where(
            stats["nGT"] > 0, stats["nCorrect"] / torch.clamp(stats["nGT"], min=1e-9), 0.0)
        params, opt_state = opt.update(grads, opt_state,
                                       D.map_tree(lambda p: p.detach(), leaves))
        return params, state, opt_state, stats

    return train_step
