"""Evaluation pipeline: batched inference -> COCO results json -> mAP.

The port of ``yolo_v3_tpu/eval/pipeline.py`` (reference evaluate.py:197-219
+ evaluate.ipynb): iterate the validation list in batches, run the
detector's device pipeline in eval mode (conf 0.005 / NMS 0.45, all
(box, class) pairs, evaluate.py:203), map boxes back to original-image
pixels, stream a results json, score with pycocotools or the in-repo
evaluator.  Where the JAX code calls its jitted ``detector._pipeline``, the
port calls :func:`yolo_v3_tpu_torch.detector.detect_fn` on the detector's
model.

Images come from the native C++ decode+letterbox pool when ``is_letterbox``
(uint8 for an int8 detector on the uint8 feed), else from OpenCV and
``Detector.preprocess``.  Unlike the JAX code, asking for the native pool
where it cannot be built raises (pass ``use_native_loader=False`` for the
OpenCV route); an image the pool cannot decode (not a JPEG) takes the OpenCV
path alone, and raises where OpenCV does not import.
"""

from __future__ import annotations

import os.path as osp
import sys
import time
from typing import Dict, Optional, Sequence

import torch

from yolo_v3_tpu_torch.data.datasets import ListDataset
from yolo_v3_tpu_torch.detector import detect_fn
from yolo_v3_tpu_torch.eval.coco_json import (
    JsonPredictionWriter,
    generate_annotations_file,
    get_image_id_from_path,
)
from yolo_v3_tpu_torch.eval.cocoeval import evaluate_map
from yolo_v3_tpu_torch.ops.letterbox import letterbox_host, letterbox_host_u8
from yolo_v3_tpu_torch.ops.postprocess import detections_to_lists

STAGES = ("load", "detect", "readback", "write")


def generate_results_file(
    detector,
    target_txt: str,
    class_names: Sequence[str],
    out: str,
    batch_size: int = 8,
    dim: Optional[int] = None,
    is_letterbox: bool = False,
    conf_thr: Optional[float] = None,
    nms_thr: Optional[float] = None,
    progress: bool = True,
    use_native_loader: Optional[bool] = None,
    timings: Optional[Dict[str, float]] = None,
    plain: bool = False,
) -> str:
    """Run eval-mode detection over an image-list file and write the COCO
    results json (reference generate_results_file, evaluate.py:208-219).

    ``use_native_loader`` (default: ``is_letterbox``) decodes and
    letterboxes on the native pool (data/native_loader.py); it raises with
    the build's error where the pool cannot be built.  Batch k+1 is
    launched before batch k is read back (a one-deep pipeline).
    ``timings``, where given, accumulates the host seconds of each stage
    (``STAGES``: decode + letterbox or preprocess, the detect launch, the
    readback, the rows to JSON) and the number of ``batches``.  ``plain``
    runs the kernels' plain PyTorch versions instead of the kernels.
    """
    ds = ListDataset(target_txt)
    detector.letterbox = is_letterbox
    eff_dim = dim or detector.config.img_dim
    config = detector.config
    conf = conf_thr if conf_thr is not None else config.eval_conf_thr
    nms = nms_thr if nms_thr is not None else config.eval_nms_thr
    if use_native_loader is None:
        use_native_loader = is_letterbox
    # an int8 detector with host preprocessing takes uint8 images as they
    # are (models/quantized.py's uint8 feed): keep the native loader in
    # uint8 too, with the same pixel semantics and 4x less transfer
    u8_feed = bool(getattr(detector, "_u8_feed", False))
    native = None
    if use_native_loader and is_letterbox:
        from yolo_v3_tpu_torch.data.native_loader import NativePrefetcher

        native = NativePrefetcher(n_threads=2, dtype="uint8" if u8_feed else "float32")
    clock = dict.fromkeys(STAGES, 0.0)

    def detect_device(x, org):
        """Launch eval-mode detection; returns the device's [B, M, 8] result
        without reading it back (the caller pipelines the readback)."""
        with torch.inference_mode():
            return detect_fn(detector.model, x, org, config, conf, nms, is_eval=True,
                             is_letterbox=is_letterbox,
                             compute_dtype=detector.compute_dtype, plain=plain)

    def flush(writer, pending):
        t0 = time.perf_counter()
        lists = detections_to_lists(pending[1])
        t1 = time.perf_counter()
        for image_id, rows in zip(pending[0], lists):
            writer.add(image_id, rows[:, [6, 0, 1, 2, 3, 5, 4]])
        clock["readback"] += t1 - t0
        clock["write"] += time.perf_counter() - t1

    n_batches = 0
    try:
        with JsonPredictionWriter(out, class_names, is_letterbox) as writer:
            paths = ds.img_list
            pending = None  # (ids, device result) of the batch launched last
            for start in range(0, len(paths), batch_size):
                chunk = paths[start:start + batch_size]
                ids = [get_image_id_from_path(p) for p in chunk]

                t0 = time.perf_counter()
                if native is not None:
                    imgs_np, orgs_np, ok = native.load_letterboxed(chunk, (eff_dim, eff_dim))
                    for j, good in enumerate(ok):
                        if not good:  # OpenCV, this image alone
                            raw = ds.load_raw(start + j)["img"]
                            lb = letterbox_host_u8 if u8_feed else letterbox_host
                            imgs_np[j] = lb(raw, (eff_dim, eff_dim))
                            orgs_np[j] = (raw.shape[1], raw.shape[0])
                    x = torch.from_numpy(imgs_np).to(detector.device)
                    org = torch.from_numpy(orgs_np).to(detector.device)
                else:
                    imgs = [ds.load_raw(start + j)["img"] for j in range(len(chunk))]
                    x, org = detector.preprocess(imgs, dim)
                t1 = time.perf_counter()
                res = detect_device(x, org)
                clock["load"] += t1 - t0
                clock["detect"] += time.perf_counter() - t1
                n_batches += 1

                if pending is not None:
                    flush(writer, pending)
                pending = (ids, res)
                if progress:
                    print(f"\reval {min(start + batch_size, len(paths))}/"
                          f"{len(paths)}", end="", file=sys.stderr)
            if pending is not None:
                flush(writer, pending)
            if progress:
                print(file=sys.stderr)
    finally:
        if native is not None:
            native.close()
    if timings is not None:
        for k, v in clock.items():
            timings[k] = timings.get(k, 0.0) + v
        timings["batches"] = timings.get("batches", 0) + n_batches
    return out


def evaluate_detector(
    detector,
    target_txt: str,
    class_names: Sequence[str],
    workdir: str,
    batch_size: int = 8,
    dim: Optional[int] = None,
    is_letterbox: bool = False,
    use_native_loader: Optional[bool] = None,
) -> float:
    """Full mAP@0.5 evaluation: GT json + results json + scoring
    (``use_native_loader`` as in :func:`generate_results_file`)."""
    gt_path = osp.join(workdir, "annotations.json")
    res_path = osp.join(workdir, "results.json")
    generate_annotations_file(target_txt, class_names, gt_path)
    generate_results_file(
        detector, target_txt, class_names, res_path,
        batch_size=batch_size, dim=dim, is_letterbox=is_letterbox,
        use_native_loader=use_native_loader,
    )
    return evaluate_map(gt_path, res_path)
