"""Custom-dataset fine-tuning from a pretrained backbone on the card (the
port of finetune_cvat.py: ~300 x-wing/tie images, CVAT XML labels,
darknet53.conv.74 init, frozen-or-slow backbone).

    python examples/torch_finetune_cvat.py --images custom_data/x_wing \
        --xml custom_data/2_x_wing.xml --backbone darknet53.conv.74
"""

import argparse

import torch

from yolo_v3_tpu_torch.data import transforms as T
from yolo_v3_tpu_torch.data.datasets import CVATDataset
from yolo_v3_tpu_torch.data.loader import DataHelper
from yolo_v3_tpu_torch.data.sampler import CyclicSampler
from yolo_v3_tpu_torch.models import darknet as D
from yolo_v3_tpu_torch.models.weights import load_backbone_darknet_weights
from yolo_v3_tpu_torch.train.loop import train
from yolo_v3_tpu_torch.utils.config import TrainConfig, YoloConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", required=True)
    ap.add_argument("--xml", required=True)
    ap.add_argument("--backbone", default=None, help="darknet53.conv.74 path")
    ap.add_argument("--net-batches", type=int, default=200)
    ap.add_argument("--freeze-backbone", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # notebook hyper-parameters (reference custom_data_train.ipynb cell 9)
    cfg = YoloConfig(num_classes=2)
    tcfg = TrainConfig(
        batch_size=16, net_subdivisions=4,
        lr=1e-3, backbone_lr=1e-4, weight_decay=5e-4, momentum=0.9,
        freeze_backbone=args.freeze_backbone,
    )

    ds = CVATDataset(args.images, args.xml,
                     trans_fn=lambda dim: T.training_transform(dim))
    sampler = CyclicSampler(len(ds), tcfg.batch_size, seed=0, dim=(416, 416))
    data = DataHelper(ds, sampler, max_net_batches=args.net_batches,
                      net_subdivisions=tcfg.net_subdivisions)

    params, state = D.init_yolonet(torch.Generator().manual_seed(0), cfg.num_classes)
    if args.backbone:
        params, state, n, _ = load_backbone_darknet_weights(params, state, args.backbone)
        print(f"backbone init: {n} floats from {args.backbone}")

    train(data, params, state, cfg, tcfg, model_id="xwing", weight_dir="weights",
          device=args.device)


if __name__ == "__main__":
    main()
