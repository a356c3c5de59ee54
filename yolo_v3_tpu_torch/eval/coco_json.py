"""COCO-format JSON builders: ground-truth annotations + detection results.

Equivalent of the reference's pycocotools-format generators (reference
evaluate.py:42-121, 151-195): ground-truth json {categories, images,
annotations} built from image-list + label txts, and streamed detection
results entries {image_id, category_id, bbox, score} with xywh boxes in
original-image pixels.

The port's own copy of ``yolo_v3_tpu/eval/coco_json.py``.  The ground truth
needs each image's size: OpenCV reads it where it imports, else the port's
native decode pool (``csrc/yolodata.cc``); with neither, it raises.
"""

from __future__ import annotations

import json
import os.path as osp
import re
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from yolo_v3_tpu_torch.data.datasets import image_path_to_label_path


def get_image_id_from_path(image_path: str) -> int:
    """Trailing digits of the stem (reference utils.py:294-297)."""
    stem = osp.splitext(image_path)[0]
    m = re.search(r"\d+$", stem)
    if m is None:
        raise ValueError(f"no trailing image id digits in {image_path!r}")
    return int(m.group())


def create_categories(class_names: Sequence[str]) -> List[Dict]:
    return [{"id": i, "name": c} for i, c in enumerate(class_names)]


def image_sizes_cv2(paths: Sequence[str]) -> List[Tuple[int, int]]:
    """(w, h) of each image, decoded by OpenCV."""
    import cv2

    sizes = []
    for p in paths:
        img = cv2.imread(p)
        if img is None:
            raise IOError(f"failed to read {p}")
        sizes.append((img.shape[1], img.shape[0]))
    return sizes


def image_sizes_native(paths: Sequence[str]) -> List[Tuple[int, int]]:
    """(w, h) of each JPEG, decoded on the port's native pool.  Raises
    RuntimeError with the build's error where the library cannot be built,
    and IOError on a file it cannot decode."""
    from yolo_v3_tpu_torch.data.native_loader import NativePrefetcher

    with NativePrefetcher(n_threads=2) as pf:
        sizes, ok = pf.image_sizes(paths)
    if not all(ok):
        raise IOError(f"failed to read {paths[ok.index(False)]} (the native decode "
                      "reads JPEG only)")
    return [(int(w), int(h)) for w, h in sizes]


def image_sizes(paths: Sequence[str]) -> List[Tuple[int, int]]:
    """(w, h) of each image: OpenCV where it imports, else the native decode."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        try:
            return image_sizes_native(paths)
        except RuntimeError as e:
            raise RuntimeError(
                "reading the image sizes needs OpenCV or the native loader "
                f"(csrc/yolodata.cc); OpenCV does not import and the native build failed: {e}"
            ) from e
    return image_sizes_cv2(paths)


def create_annotations_dict(target_txt: str, class_names: Sequence[str]) -> Dict:
    """Build the GT dict from an image-list file + label txts
    (reference create_annotations_dict, evaluate.py:78-113)."""
    with open(target_txt) as f:
        img_paths = [ln.strip() for ln in f if ln.strip()]

    img_list, ann_list = [], []
    n_label_files = 0
    for img_path, (w, h) in zip(img_paths, image_sizes(img_paths)):
        image_id = get_image_id_from_path(img_path)
        img_list.append(OrderedDict({"id": image_id, "width": w, "height": h}))

        label_path = image_path_to_label_path(img_path)
        if not osp.exists(label_path):
            continue
        n_label_files += 1
        labels = np.loadtxt(label_path).reshape(-1, 5)
        for row in labels:
            cx, cy, bw, bh = row[1] * w, row[2] * h, row[3] * w, row[4] * h
            bbox = [cx - bw / 2, cy - bh / 2, bw, bh]
            ann_list.append(OrderedDict({
                "id": len(ann_list),
                "image_id": image_id,
                "category_id": int(row[0]),
                "iscrowd": 0,
                "area": bbox[2] * bbox[3],
                "bbox": bbox,
            }))

    if img_paths and n_label_files == 0:
        raise FileNotFoundError(
            f"no label file resolved for ANY of the {len(img_paths)} images in "
            f"{target_txt!r} (expected layout: .../images/<stem>.<ext> with "
            f".../labels/<stem>.txt; first miss: "
            f"{image_path_to_label_path(img_paths[0])!r}). Refusing to emit an "
            "empty ground truth — mAP would silently score against nothing."
        )

    return OrderedDict({
        "categories": create_categories(class_names),
        "images": img_list,
        "annotations": ann_list,
    })


def generate_annotations_file(target_txt: str, class_names: Sequence[str],
                              out: str) -> None:
    with open(out, "w") as f:
        json.dump(create_annotations_dict(target_txt, class_names), f,
                  indent=4, separators=(",", ":"))


def create_results_entry(image_id: int, category_id: int, bbox, score) -> Dict:
    return OrderedDict({
        "image_id": image_id,
        "category_id": category_id,
        "bbox": list(map(float, bbox)),
        "score": float(score),
    })


class JsonPredictionWriter:
    """Streaming results writer (reference JsonPredictionWriter,
    evaluate.py:151-195) — entries go to disk as they arrive (constant
    memory at any eval-set size), closed into one valid JSON array;
    context-manager friendly."""

    def __init__(self, out_path: str, class_names: Sequence[str],
                 is_letterbox: bool = False):
        self.out_path = out_path
        self.class_names = class_names
        self.is_letterbox = is_letterbox
        self.count = 0
        self._f = open(out_path, "w")
        self._f.write("[")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def add(self, image_id: int, detections: np.ndarray) -> None:
        """``detections``: [n, 7] rows [cls, x, y, w, h, prob, obj] in
        original-image pixels (Detector.detect output)."""
        for row in detections:
            entry = create_results_entry(image_id, int(row[0]), row[1:5],
                                         row[5])
            self._f.write(",\n" if self.count else "\n")
            json.dump(entry, self._f, indent=4, separators=(",", ":"))
            self.count += 1

    def close(self) -> None:
        if self._f.closed:
            return
        self._f.write("\n]" if self.count else "]")
        self._f.close()
