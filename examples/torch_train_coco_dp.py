"""Full COCO training with multi-scale 320-608 and data parallelism over
the cards of a host (the port of train_coco_dp.py), one process a card:

    torchrun --nproc-per-node 4 examples/torch_train_coco_dp.py \
        --train-list coco/trainvalno5k.txt --resume --bf16

The global batch (16 x 4 subdivisions) is split over the ranks; run as one
plain process it trains on one card.
"""

import argparse

import torch

from yolo_v3_tpu_torch.data import transforms as T
from yolo_v3_tpu_torch.data.datasets import ListDataset
from yolo_v3_tpu_torch.data.sampler import CyclicSampler
from yolo_v3_tpu_torch.models import darknet as D
from yolo_v3_tpu_torch.parallel import distributed as dist
from yolo_v3_tpu_torch.train.checkpoint import get_latest_checkpoint, load_checkpoint
from yolo_v3_tpu_torch.train.loop import train
from yolo_v3_tpu_torch.utils.config import TrainConfig, YoloConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-list", required=True)
    ap.add_argument("--model-id", default="coco")
    ap.add_argument("--weight-dir", default="weights")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--max-net-batches", type=int, default=500_200)
    args = ap.parse_args()

    ctx = dist.initialize()              # no-op for one process
    mesh = dist.make_global_mesh() if ctx.is_distributed else None

    cfg = YoloConfig(num_classes=80)
    tcfg = TrainConfig(
        batch_size=16, net_subdivisions=4,           # net batch 64
        lr=1e-3, backbone_lr=1e-4, weight_decay=5e-4, momentum=0.9,
        multi_scale=True,
        compute_dtype="bfloat16" if args.bf16 else "float32",
    )

    ds = ListDataset(args.train_list,
                     trans_fn=lambda dim: T.training_transform(dim))
    sampler = CyclicSampler(
        len(ds), tcfg.batch_size, seed=tcfg.seed, dim=None,
        rand_dim_interval=tcfg.batch_size * tcfg.net_subdivisions,
    )
    data = dist.make_data_helper(ds, sampler, ctx, max_net_batches=args.max_net_batches,
                                 net_subdivisions=tcfg.net_subdivisions)

    params, state = D.init_yolonet(torch.Generator().manual_seed(tcfg.seed),
                                   cfg.num_classes)
    checkpoint = None
    if args.resume:
        path, _ = get_latest_checkpoint(args.model_id, args.weight_dir)
        if path:
            print("resuming from", path)
            checkpoint = load_checkpoint(path)

    train(data, params, state, cfg, tcfg, model_id=args.model_id,
          weight_dir=args.weight_dir, checkpoint=checkpoint,
          checkpoint_interval=100, mesh=mesh)


if __name__ == "__main__":
    main()
