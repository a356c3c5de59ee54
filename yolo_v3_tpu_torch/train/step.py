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
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from yolo_v3_tpu_torch.models import darknet as D
from yolo_v3_tpu_torch.models.loss import yolo_loss
from yolo_v3_tpu_torch.utils.config import YoloConfig
from yolo_v3_tpu_torch.utils.precision import full_fp32

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def loss_fn(params, state, imgs, labels, config: YoloConfig,
            compute_dtype: torch.dtype = torch.float32):
    """Forward + loss on one micro-batch; returns (loss, (stats, new BN
    state)).  A uint8 batch is normalized here, on its device, as
    ``float32 / 255``."""
    if imgs.dtype == torch.uint8:
        imgs = imgs.to(torch.float32) / 255.0
    if compute_dtype != torch.float32:
        params = D.map_tree(lambda a: a.to(compute_dtype), params)
        imgs = imgs.to(compute_dtype)
    raws, new_state = D.apply_yolonet(params, state, imgs, training=True)
    loss, stats = yolo_loss(raws, labels, config, imgs.shape[1])
    return loss, (stats, new_state)


def make_train_step(config: YoloConfig, opt, compute_dtype: torch.dtype = torch.float32,
                    remat: bool = False):
    """A net-batch step ``(params, state, opt_state, imgs, labels) -> (params,
    state, opt_state, stats)`` for the optimizer ``opt``
    (:class:`~yolo_v3_tpu_torch.train.optimizer.SGD`).  ``remat`` recomputes
    each micro-batch's forward during its backward
    (``torch.utils.checkpoint``) instead of keeping its activations."""
    base = functools.partial(loss_fn, config=config, compute_dtype=compute_dtype)

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
                loss.backward()
                per_micro.append(stats)
        grads = D.map_tree(lambda p: p.grad, leaves)
        stats: Dict[str, torch.Tensor] = {
            k: torch.stack([st[k].detach() for st in per_micro]).mean(dim=0)
            for k in per_micro[0]}
        stats["recall"] = torch.where(
            stats["nGT"] > 0, stats["nCorrect"] / torch.clamp(stats["nGT"], min=1e-9), 0.0)
        params, opt_state = opt.update(grads, opt_state,
                                       D.map_tree(lambda p: p.detach(), leaves))
        return params, state, opt_state, stats

    return train_step
