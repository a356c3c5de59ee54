"""Command-line API: detect / train / eval / weights tools, on the card.

Port of ``yolo_v3_tpu/cli.py``: the same subcommands, flags and defaults,
plus ``--device`` (the card, ``cuda``, unless the caller names another;
the tests pass ``cpu``).  ``--weights random`` draws the model from
``torch.Generator`` seed 0 where the JAX CLI uses ``PRNGKey(0)``, so the
random numbers differ (``models/darknet.py::init_yolonet``).

    python -m yolo_v3_tpu_torch.cli detect --image img.png --weights yolov3.weights
    python -m yolo_v3_tpu_torch.cli train --train-list 5k.txt --model-id coco ...
    python -m yolo_v3_tpu_torch.cli eval --val-list 5k.txt --weights ckpt.npz ...
    python -m yolo_v3_tpu_torch.cli weights convert|inspect|quantize ...

Data-parallel training runs one process a card under ``torchrun``::

    torchrun --nproc-per-node N -m yolo_v3_tpu_torch.cli train --data-parallel ...

``--batch-size`` is the global batch; each rank assembles its share.  The
ranks join over NCCL, or over gloo when ``--device cpu`` names CPU ranks.
``--s2d-entry`` stays in the parser and raises: the space-to-depth training
entry is on ROADMAP's "Do not port" list.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _load_class_names(path: str):
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def parse_dim_range(spec: str):
    """``--dim-range MIN,MAX`` (inclusive pixels) -> sampler dim_mult_range.

    The sampler's range is half-open (``rng.integers``), so the inclusive
    CLI contract needs ``+1`` on the upper bound."""
    try:
        lo, hi = (int(v) for v in spec.split(","))
    except ValueError:
        raise SystemExit("--dim-range must be MIN,MAX multiples of 32")
    if lo % 32 or hi % 32 or not 32 <= lo <= hi:
        raise SystemExit("--dim-range must be MIN,MAX multiples of 32")
    return (lo // 32, hi // 32 + 1)


def _build_detector(args, num_classes: int):
    import torch

    from yolo_v3_tpu_torch.detector import Detector
    from yolo_v3_tpu_torch.models import darknet as D
    from yolo_v3_tpu_torch.utils.config import YoloConfig

    cfg = YoloConfig(num_classes=num_classes, img_dim=args.dim)
    kw = dict(precision=args.precision, device=args.device)
    if args.weights == "random":
        params, state = D.init_yolonet(torch.Generator().manual_seed(0), num_classes)
        return Detector(params, state, cfg, **kw)
    if args.weights.endswith(".npz"):
        from yolo_v3_tpu_torch.models import quantized as Q

        if Q.is_quantized_file(args.weights):
            # a pre-calibrated int8 serving artifact ('weights quantize')
            return Detector.from_quantized(args.weights, cfg, device=args.device)
        return Detector.from_checkpoint(args.weights, cfg, **kw)
    return Detector.from_darknet_weights(args.weights, cfg, **kw)


def format_detection(row, classes=None) -> str:
    """One printed line of ``detect``: class, prob and xywh in pixels."""
    name = classes[int(row[0])] if classes else str(int(row[0]))
    return (f"{name} prob={row[5]:.3f} xywh=({row[1]:.1f}, {row[2]:.1f}, "
            f"{row[3]:.1f}, {row[4]:.1f})")


def cmd_detect(args):
    import cv2

    from yolo_v3_tpu_torch.viz.draw import save_detections_image

    # fail fast on the image before the model build
    raw = cv2.imread(args.image)
    if raw is None:
        raise FileNotFoundError(f"cannot read image: {args.image}")
    img = cv2.cvtColor(raw, cv2.COLOR_BGR2RGB)

    classes = _load_class_names(args.names) if args.names else None
    num_classes = len(classes) if classes else args.num_classes
    det = _build_detector(args, num_classes)
    results = det.detect([img], conf_thr=args.conf_thr, nms_thr=args.nms_thr,
                         dim=args.dim)[0]
    for row in results:
        print(format_detection(row, classes))
    if args.out:
        save_detections_image(img, results, args.out, classes)
        print(f"saved {args.out}")


def _native_decode_available() -> bool:
    """Whether the native decode pool builds and loads on this host; says
    on stderr why not where it does not."""
    from yolo_v3_tpu_torch.data import native_loader

    try:
        native_loader.load_library()
        return True
    except RuntimeError as e:
        print(f"eval: decoding with OpenCV, the native decode pool is unavailable "
              f"({str(e).splitlines()[0][:200]})", file=sys.stderr)
        return False


def cmd_eval(args):
    from yolo_v3_tpu_torch.eval.pipeline import evaluate_detector

    classes = _load_class_names(args.names)
    det = _build_detector(args, len(classes))
    os.makedirs(args.workdir, exist_ok=True)
    # letterboxed images decode on the native pool where it builds, else
    # with OpenCV (the JAX CLI's choice; the pipeline itself never falls back)
    mAP = evaluate_detector(
        det, args.val_list, classes, args.workdir,
        batch_size=args.batch_size, dim=args.dim, is_letterbox=args.letterbox,
        use_native_loader=args.letterbox and _native_decode_available(),
    )
    print(json.dumps({"mAP@0.5": mAP}))


def cmd_train(args):
    import torch

    from yolo_v3_tpu_torch.data import transforms as T
    from yolo_v3_tpu_torch.data.datasets import CVATDataset, ListDataset
    from yolo_v3_tpu_torch.data.loader import DataHelper
    from yolo_v3_tpu_torch.data.sampler import CyclicSampler
    from yolo_v3_tpu_torch.models import darknet as D
    from yolo_v3_tpu_torch.models.weights import load_backbone_darknet_weights
    from yolo_v3_tpu_torch.train.checkpoint import get_latest_checkpoint, load_checkpoint
    from yolo_v3_tpu_torch.train.loop import train
    from yolo_v3_tpu_torch.utils.config import TrainConfig, YoloConfig

    classes = _load_class_names(args.names)
    cfg = YoloConfig(num_classes=len(classes), img_dim=args.dim,
                     lambda_cls=args.lambda_cls)
    tcfg = TrainConfig(
        batch_size=args.batch_size,
        net_subdivisions=args.subdivisions,
        lr=args.lr,
        backbone_lr=args.backbone_lr,
        weight_decay=args.weight_decay,
        momentum=args.momentum,
        freeze_backbone=args.freeze_backbone,
        max_net_batches=args.max_net_batches,
        seed=args.seed,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        remat=args.remat,
        s2d_entry=args.s2d_entry,
        burn_in=args.burn_in,
        lr_steps=tuple(int(s) for s in args.lr_steps.split(","))
        if args.lr_steps else (),
        lr_step_scales=tuple(0.1 for _ in args.lr_steps.split(","))
        if args.lr_steps else (),
    )

    if args.no_aug:
        # the reference's custom-data run trains without augmentation
        trans = lambda dim: T.eval_transform(dim, max_labels=cfg.max_labels,  # noqa: E731
                                             feed_u8=args.feed_u8)
    else:
        # every aug stage is uint8 in, uint8 out, so the uint8 feed composes
        # with augmentation
        trans = lambda dim: T.training_transform(  # noqa: E731
            dim, hue=args.hue, saturation=args.saturation,
            exposure=args.exposure, jitter=args.jitter,
            max_labels=cfg.max_labels, extra_aug=args.extra_aug,
            feed_u8=args.feed_u8,
        )
    if args.cvat_xml:
        ds = CVATDataset(args.train_images or os.path.dirname(args.train_list),
                         args.cvat_xml, trans_fn=trans)
    else:
        ds = ListDataset(args.train_list, trans_fn=trans, require_labels=True)
    if args.cache:
        if not args.no_aug:
            raise SystemExit("--cache requires --no-aug (the RAM cache is "
                             "only valid for deterministic transforms)")
        from yolo_v3_tpu_torch.data.datasets import CachedDataset

        ds = CachedDataset(ds)

    dim = None if args.multi_scale else (args.dim, args.dim)
    sampler = CyclicSampler(
        len(ds), args.batch_size, seed=args.seed, dim=dim,
        rand_dim_interval=max(8, args.batch_size * args.subdivisions),
        dim_mult_range=parse_dim_range(args.dim_range),
    )
    data_kw = dict(max_net_batches=args.max_net_batches,
                   net_subdivisions=args.subdivisions,
                   num_workers=args.num_workers, native_threads=args.native_threads)
    mesh = None
    if args.data_parallel:
        from yolo_v3_tpu_torch.parallel import distributed as dist

        cpu = torch.device(args.device).type == "cpu"
        ctx = dist.initialize(backend="gloo" if cpu else None)
        mesh = dist.make_global_mesh(device=args.device if args.device != "cuda" else None)
        data = dist.make_data_helper(ds, sampler, ctx, **data_kw)
        if mesh.rank == 0:
            print(f"mesh: {mesh.shape}", file=sys.stderr)
    else:
        data = DataHelper(ds, sampler, **data_kw)

    params, state = D.init_yolonet(torch.Generator().manual_seed(args.seed), cfg.num_classes)
    if args.backbone_weights:
        params, state, consumed, _ = load_backbone_darknet_weights(
            params, state, args.backbone_weights)
        print(f"backbone init from {args.backbone_weights} "
              f"({consumed} floats)", file=sys.stderr)

    checkpoint = None
    if args.resume:
        path, _ = get_latest_checkpoint(args.model_id, args.weight_dir)
        if path:
            print(f"resuming from {path}", file=sys.stderr)
            checkpoint = load_checkpoint(path)

    recorder = None
    if args.metrics_jsonl:
        from yolo_v3_tpu_torch.train.recorder import Recorder

        recorder = Recorder(jsonl_path=args.metrics_jsonl)

    try:
        train(
            data, params, state, cfg, tcfg,
            recorder=recorder,
            model_id=args.model_id, weight_dir=args.weight_dir,
            checkpoint=checkpoint, checkpoint_interval=args.checkpoint_interval,
            mesh=mesh,
            pipeline_stats=args.pipeline_stats,
            device=args.device,
        )
    finally:
        data.close()
        if mesh is not None and mesh.group is not None:
            torch.distributed.destroy_process_group()


def cmd_weights(args):
    import torch

    from yolo_v3_tpu_torch.models import darknet as D
    from yolo_v3_tpu_torch.models import weights as W

    if args.action == "inspect":
        header = np.fromfile(args.path, dtype=np.int32, count=5)
        blob = np.fromfile(args.path, dtype=np.float32)[5:]
        print(json.dumps({
            "version": header[:3].tolist(),
            "seen": int(header[3]),
            "n_floats": int(blob.size),
        }))
    elif args.action == "convert":
        blocks = (tuple(int(b) for b in args.blocks.split(","))
                  if args.blocks else D.DARKNET53_BLOCKS)
        params, state = D.init_yolonet(torch.Generator().manual_seed(0), args.num_classes,
                                       blocks=blocks)
        params, state, n, hdr = W.load_darknet_weights(params, state, args.path)
        W.save_pytree({"params": params, "state": state}, args.out,
                      meta={"seen": int(hdr[3]), "source": args.path})
        print(f"wrote {args.out} ({n} floats)")
    elif args.action == "quantize":
        # one-time calibration -> a deployable int8 serving artifact, which
        # detect / eval load as it is (no float weights or calibration data)
        from yolo_v3_tpu_torch.detector import Detector
        from yolo_v3_tpu_torch.utils.config import YoloConfig

        cfg = YoloConfig(num_classes=args.num_classes, img_dim=args.dim)
        calib = None
        if args.calib_images:
            import cv2

            paths = sorted(os.listdir(args.calib_images))[:args.calib_count]
            calib = []
            for p in paths:
                im = cv2.imread(os.path.join(args.calib_images, p))
                if im is not None:
                    calib.append(cv2.cvtColor(im, cv2.COLOR_BGR2RGB))
            if not calib:
                raise FileNotFoundError(f"no readable images in {args.calib_images}")
            print(f"calibrating on {len(calib)} images", file=sys.stderr)
        kw = dict(precision="int8", calib_images=calib, device=args.device)
        if args.path.endswith(".npz"):
            det = Detector.from_checkpoint(args.path, cfg, **kw)
        else:
            det = Detector.from_darknet_weights(args.path, cfg, **kw)
        det.save_quantized(args.out)
        print(f"wrote {args.out}")


def _add_device(parser):
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="yolo_v3_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("detect", help="single/batch image detection")
    d.add_argument("--image", required=True)
    d.add_argument("--weights", required=True,
                   help=".weights | .npz checkpoint | 'random'")
    d.add_argument("--names", default=None)
    d.add_argument("--num-classes", type=int, default=80)
    d.add_argument("--dim", type=int, default=416)
    d.add_argument("--conf-thr", type=float, default=0.5)
    d.add_argument("--nms-thr", type=float, default=0.4)
    d.add_argument("--precision", default="bf16",
                   choices=["bf16", "fp32", "int8"],
                   help="int8 = post-training-quantized serving path "
                        "(activation scales calibrated on a synthetic "
                        "batch; pass calib_images via the Detector API "
                        "for data-driven scales)")
    d.add_argument("--out", default=None)
    _add_device(d)
    d.set_defaults(fn=cmd_detect)

    e = sub.add_parser("eval", help="COCO mAP@0.5 evaluation")
    e.add_argument("--val-list", required=True)
    e.add_argument("--weights", required=True)
    e.add_argument("--names", required=True)
    e.add_argument("--dim", type=int, default=416)
    e.add_argument("--batch-size", type=int, default=8)
    e.add_argument("--letterbox", action="store_true")
    e.add_argument("--precision", default="bf16",
                   choices=["bf16", "fp32", "int8"])
    e.add_argument("--workdir", default="eval_out")
    _add_device(e)
    e.set_defaults(fn=cmd_eval)

    t = sub.add_parser("train", help="COCO/CVAT training")
    t.add_argument("--train-list", default=None)
    t.add_argument("--cvat-xml", default=None)
    t.add_argument("--train-images", default=None)
    t.add_argument("--names", required=True)
    t.add_argument("--model-id", default="test")
    t.add_argument("--weight-dir", default="weights")
    t.add_argument("--dim", type=int, default=416)
    t.add_argument("--multi-scale", action="store_true")
    t.add_argument("--dim-range", default="320,608",
                   help="multi-scale dim bounds MIN,MAX (multiples of 32; "
                        "darknet default 320,608)")
    t.add_argument("--batch-size", type=int, default=16,
                   help="the global batch (over every rank with --data-parallel)")
    t.add_argument("--subdivisions", type=int, default=4)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--backbone-lr", type=float, default=1e-4)
    t.add_argument("--lambda-cls", type=float, default=1.0,
                   help="class-BCE loss weight (raise for from-scratch "
                        "training of many-way class heads)")
    t.add_argument("--weight-decay", type=float, default=5e-4)
    t.add_argument("--momentum", type=float, default=0.9)
    t.add_argument("--freeze-backbone", action="store_true")
    t.add_argument("--backbone-weights", default=None,
                   help="darknet53.conv.74-style backbone init")
    t.add_argument("--max-net-batches", type=int, default=None)
    t.add_argument("--checkpoint-interval", type=int, default=1)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--data-parallel", action="store_true",
                   help="one process a card, started by torchrun")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--bf16", action="store_true",
                   help="mixed-precision training (bf16 compute, fp32 master)")
    t.add_argument("--remat", action="store_true",
                   help="recompute the forward in the backward (activation "
                        "memory ~ one layer's peak)")
    t.add_argument("--s2d-entry", action="store_true",
                   help="not ported (the space-to-depth training entry): raises")
    t.add_argument("--hue", type=float, default=0.1)
    t.add_argument("--saturation", type=float, default=1.5)
    t.add_argument("--exposure", type=float, default=1.5)
    t.add_argument("--jitter", type=float, default=0.3)
    t.add_argument("--extra-aug", action="store_true",
                   help="extra photometric augmentation bank")
    t.add_argument("--no-aug", action="store_true",
                   help="letterbox-only transform (the reference custom-data "
                        "run's isAug=False)")
    t.add_argument("--cache", action="store_true",
                   help="RAM-cache finalized samples (requires --no-aug)")
    t.add_argument("--feed-u8", action="store_true",
                   help="feed uint8 pixels to the train step (normalized on "
                        "the device; 4x less host-to-device traffic)")
    t.add_argument("--metrics-jsonl", default=None,
                   help="append per-net-batch raw stats to this JSONL file")
    t.add_argument("--burn-in", type=int, default=0,
                   help="net-batches of (n/burn_in)^4 LR warmup")
    t.add_argument("--lr-steps", default=None,
                   help="comma-separated net-batch boundaries for x0.1 LR "
                        "step decay (darknet yolov3.cfg steps semantics)")
    t.add_argument("--pipeline-stats", action="store_true",
                   help="read each net-batch's stats back one net-batch late, "
                        "so host sample assembly overlaps the device's work")
    t.add_argument("--num-workers", type=int, default=0,
                   help="multiprocess Python sample-assembly workers")
    t.add_argument("--native-threads", type=int, default=0,
                   help="C++ decode+augment threads (data/native_aug.py); "
                        "raises where the library or the transform chain "
                        "cannot take the dataset")
    _add_device(t)
    t.set_defaults(fn=cmd_train)

    w = sub.add_parser("weights", help="weight file tools")
    w.add_argument("action", choices=["inspect", "convert", "quantize"])
    w.add_argument("path")
    w.add_argument("--out", default="model.npz")
    w.add_argument("--num-classes", type=int, default=80)
    w.add_argument("--calib-images", default=None,
                   help="directory of calibration images for 'quantize' "
                        "(default: synthetic batch)")
    w.add_argument("--calib-count", type=int, default=32)
    w.add_argument("--dim", type=int, default=416,
                   help="net input dim for 'quantize' calibration")
    w.add_argument("--blocks", default=None,
                   help="comma-separated per-stage residual counts for "
                        "reduced backbones (default: darknet-53's 1,2,8,8,4)")
    _add_device(w)
    w.set_defaults(fn=cmd_weights)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
