"""Typed configuration for the framework (the PyTorch port's copy of
``yolo_v3_tpu/utils/config.py``: same fields, defaults and JSON form).

The reference has no config system — settings live in notebook cells and
constructor defaults (reference darknet.py:168 anchors, utils.py:226
thresholds, yololayer.py:25 ignore_thres).  Here they are collected into one
typed, serializable dataclass so every entry point (CLI, train, eval, bench)
shares a single source of truth.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple

# Default YOLOv3 anchors in input-image pixels, (w, h) pairs
# (reference darknet.py:168).
DEFAULT_ANCHORS: Tuple[Tuple[float, float], ...] = (
    (10, 13), (16, 30), (33, 23),
    (30, 61), (62, 45), (59, 119),
    (116, 90), (156, 198), (373, 326),
)

# Which anchors each detection scale owns, coarse (stride 32) first
# (reference darknet.py:184-194).
DEFAULT_ANCHOR_MASKS: Tuple[Tuple[int, ...], ...] = ((6, 7, 8), (3, 4, 5), (0, 1, 2))


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    """Static model/loss/postprocess configuration.

    Frozen + hashable, with the JAX package's fields and defaults, so a
    config serialized by either package loads in the other.
    """

    num_classes: int = 80
    img_dim: int = 416
    anchors: Tuple[Tuple[float, float], ...] = DEFAULT_ANCHORS
    anchor_masks: Tuple[Tuple[int, ...], ...] = DEFAULT_ANCHOR_MASKS

    # Loss hyper-parameters (reference yololayer.py:17-25).
    lambda_xy: float = 1.0
    lambda_wh: float = 1.0
    lambda_conf: float = 1.0
    lambda_cls: float = 1.0
    obj_scale: float = 1.0
    noobj_scale: float = 1.0
    ignore_thres: float = 0.7

    # Max GT boxes per image; labels are padded to this many rows
    # (reference transforms.py:26 max_labels=90).
    max_labels: int = 90

    # Postprocessing defaults (reference utils.py:226, evaluate.py:203).
    conf_thr: float = 0.5
    nms_thr: float = 0.4
    eval_conf_thr: float = 0.005
    eval_nms_thr: float = 0.45

    # Fixed-shape postprocess capacities (TPU: no data-dependent shapes).
    # pre_nms_topk bounds candidates entering NMS in display mode;
    # max_detections bounds the emitted per-image results (COCOeval only
    # scores maxDets=100 anyway).
    pre_nms_topk: int = 512
    max_detections: int = 128
    # Display/serving fast path: per-scale top-k candidate selection with
    # static-lane score extraction (never materializes the [B, N, 85] flat
    # tensor; measured 8.4 -> ~4 ms/batch64 postprocess on-chip).  Final
    # detections are identical to the global-top-k path whenever each scale
    # holds <= this many candidates above conf_thr (at display conf 0.5
    # real scenes have a handful; tests/test_postprocess_fast.py gates
    # parity).  0 falls back to the global-top-k exact path.
    display_per_scale_topk: int = 128
    # Eval mode keeps every (box, class) pair above 0.005 in the reference
    # (utils.py:236-238) — routinely thousands per image on real weights —
    # so the eval-mode candidate bound is separate and large so mAP-parity
    # runs are truncation-free (tests/test_eval_truncation.py quantifies
    # the 512-vs-4096 delta on dense score distributions).
    eval_pre_nms_topk: int = 4096
    # approx_max_k (recall 0.99) is ~12x faster than exact top-k over the
    # ~850k eval candidates but is an approximation: parity runs default to
    # reference-exact; flip on for serving-style bulk eval.
    eval_approx_topk: bool = False
    # Eval selection fused into the NMS rounds (ops/postprocess.py::
    # nms_pairs_grid): exact greedy over EVERY pair above threshold, no
    # pair-list sort/compaction — replaces the 2-stage top-k + blocked NMS
    # whenever use_nms is on.  Off -> the truncated top-k path (also used
    # when eval_approx_topk relaxes exactness).
    eval_grid_nms: bool = True

    @property
    def num_scales(self) -> int:
        return len(self.anchor_masks)

    @property
    def anchors_per_scale(self) -> int:
        return len(self.anchor_masks[0])

    @property
    def bbox_attrib(self) -> int:
        return 5 + self.num_classes

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "YoloConfig":
        d = json.loads(s)
        d["anchors"] = tuple(tuple(a) for a in d["anchors"])
        d["anchor_masks"] = tuple(tuple(m) for m in d["anchor_masks"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters (reference custom_data_train.ipynb cell 9,
    train.py:67 clip norm, dataset.py:89 multi-scale dims)."""

    batch_size: int = 16
    net_subdivisions: int = 4          # gradient-accumulation factor
    lr: float = 1e-3
    backbone_lr: float = 1e-4
    weight_decay: float = 5e-4
    momentum: float = 0.9
    freeze_backbone: bool = False
    clip_grad_norm: float = 1000.0
    max_net_batches: Optional[int] = None
    checkpoint_interval: int = 1       # in net-batches
    multi_scale: bool = True
    rand_dim_interval: int = 8         # re-roll dim every N samples
    dim_min_mult: int = 10             # dims = randint(10, 20) * 32 => 320..608
    dim_max_mult: int = 20
    seed: int = 0
    # "float32" (reference-exact, TF32 off) or "bfloat16" (mixed
    # precision: bf16 convs, fp32 master params, gradients, BN statistics
    # and loss)
    compute_dtype: str = "float32"
    # recompute the forward during the backward (torch.utils.checkpoint):
    # activation memory drops to about one micro-batch's layer peak for one
    # more forward's work; the same graph is recomputed, so gradients do not
    # move (tests/test_torch_train_step.py)
    remat: bool = False
    # the space-to-depth training entry of the JAX package; not ported
    # (ROADMAP, "Do not port"), so True raises
    s2d_entry: bool = False

    # LR schedule in net-batches: darknet's COCO recipe (which the reference
    # checkpoint format reserves a scheduler slot for, reference
    # train.py:211-216) is burn-in then step decay — yolov3.cfg uses
    # burn_in=1000, power 4, steps (400000, 450000) x scale 0.1.  Defaults
    # keep the reference's constant-LR behavior.  The schedule position
    # (update count) lives in the optimizer state, so it rides through
    # checkpoints and resume keeps the schedule position while the *shape*
    # of the schedule follows the current config — the same "current
    # hyperparams win on resume" contract as the reference's load_optimizer
    # (train.py:104-116).
    burn_in: int = 0                  # net-batches of (n/burn_in)^power warmup
    burn_in_power: float = 4.0
    lr_steps: Tuple[int, ...] = ()     # net-batch boundaries
    lr_step_scales: Tuple[float, ...] = ()  # multiplier applied at each step

    def __post_init__(self):
        if self.s2d_entry:
            raise ValueError(
                "TrainConfig.s2d_entry: the space-to-depth training entry is not "
                "ported (ROADMAP, queue A, 'Do not port')")


def anchors_flat(anchors: Sequence[Tuple[float, float]]) -> Tuple[float, ...]:
    """Flatten [(w, h), ...] into (w0, h0, w1, h1, ...)."""
    out = []
    for w, h in anchors:
        out.extend((float(w), float(h)))
    return tuple(out)
