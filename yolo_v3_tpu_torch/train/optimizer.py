"""Two-group SGD with momentum, weight decay, a global-norm clip and the
darknet burn-in/step schedule.

Port of ``yolo_v3_tpu/train/optimizer.py`` (an optax chain there), written
as plain tensor code on the ``{params}`` tree:

1. clip: where the global norm of ALL gradients (the backbone's too, also
   when it is frozen) reaches ``clip_grad_norm``, every gradient is scaled
   by ``clip_grad_norm / norm`` (optax ``clip_by_global_norm``: no epsilon,
   untouched below the limit);
2. per group (``backbone`` subtree: ``backbone_lr``; everything else:
   ``lr``): weight decay ``g + wd * p``, then momentum ``buf = g + m * buf``
   (dampening 0, not Nesterov), then the update ``-lr * mult(count) * buf``;
   a frozen backbone gets zero updates and keeps no momentum;
3. ``count`` (net-batches applied) advances by one.  It is the optimizer
   state's schedule position and is saved and restored with the checkpoint;
   the schedule's shape and the rates follow the current config on resume.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from yolo_v3_tpu_torch.utils.config import TrainConfig

BACKBONE_KEY = "backbone"

OptState = Dict[str, Any]


def schedule_multiplier(cfg: TrainConfig):
    """LR multiplier as a function of the update (net-batch) count, in
    float32: ((n + 1) / burn_in) ** power during burn-in (n 0-based, so the
    first step is not dead), then a cumulative scale at each step
    boundary.  With the default config it is constantly 1."""
    steps = tuple(int(s) for s in cfg.lr_steps)
    scales = tuple(float(s) for s in cfg.lr_step_scales)
    if len(steps) != len(scales):
        raise ValueError(
            f"lr_steps ({len(steps)}) and lr_step_scales ({len(scales)}) "
            "must have the same length")

    def mult(count) -> torch.Tensor:
        count = torch.as_tensor(count, dtype=torch.float32)
        m = torch.ones((), dtype=torch.float32)
        if cfg.burn_in > 0:
            m = torch.where(count < cfg.burn_in,
                            ((count + 1.0) / cfg.burn_in) ** cfg.burn_in_power, 1.0)
        for boundary, scale in zip(steps, scales):
            m = m * torch.where(count >= boundary, scale, 1.0)
        return m

    return mult


def _leaves(tree, prefix=()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, tensor) of every leaf, in sorted key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def _build(paths, values):
    tree: Dict[str, Any] = {}
    for path, v in zip(paths, values):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient leaf, in float32."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for _, g in _leaves(grads)))


class SGD:
    """The two-group SGD.  ``init(params)`` gives the optimizer state
    ``{"count": int, "trace": momentum tree}`` (the frozen backbone has no
    trace); ``update(grads, state, params)`` returns the new params and
    state, out of place, as the JAX ``tx.update`` + ``apply_updates``."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.mult = schedule_multiplier(cfg)

    def _lr(self, path) -> float:
        return self.cfg.backbone_lr if path[0] == BACKBONE_KEY else self.cfg.lr

    def _frozen(self, path) -> bool:
        return self.cfg.freeze_backbone and path[0] == BACKBONE_KEY

    def init(self, params) -> OptState:
        leaves = [(p, t) for p, t in _leaves(params) if not self._frozen(p)]
        return {"count": 0,
                "trace": _build([p for p, _ in leaves],
                                [torch.zeros_like(t) for _, t in leaves])}

    @torch.no_grad()
    def update(self, grads, state: OptState, params):
        cfg = self.cfg
        grad_leaves = _leaves(grads)
        norm = global_norm(grads)
        # optax's select: below the limit the gradients pass untouched
        clip = norm >= cfg.clip_grad_norm
        mult = self.mult(state["count"]).to(norm.device)
        trace = dict(_leaves(state["trace"]))
        new_params, new_trace = [], {}
        for (path, g), (_, p) in zip(grad_leaves, _leaves(params)):
            if self._frozen(path):
                new_params.append(p.clone())
                continue
            g = torch.where(clip, g / norm * cfg.clip_grad_norm, g)
            g = g + cfg.weight_decay * p
            buf = g + cfg.momentum * trace[path]
            new_trace[path] = buf
            new_params.append(p + (-self._lr(path) * mult) * buf)
        paths = [path for path, _ in grad_leaves]
        new_state = {"count": state["count"] + 1,
                     "trace": _build(list(new_trace), list(new_trace.values()))}
        return _build(paths, new_params), new_state


def make_optimizer(cfg: TrainConfig) -> SGD:
    return SGD(cfg)
