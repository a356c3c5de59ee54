"""Datasets: COCO-style list files, CVAT XML, raw image folders.

The port's own copy of ``yolo_v3_tpu/data/datasets.py``: host-side sample
sources feeding the deterministic scheduler
(:mod:`yolo_v3_tpu_torch.data.sampler`).  OpenCV (image decode) and lxml
(CVAT XML) are imported only where they are used.  Unlike the reference (dataset.py:159-289)
datasets here are pure index->sample functions; scheduling state (shuffle
order, dims, seeds) lives entirely in the sampler, and every sample carries
its own ``numpy.random.Generator`` derived from the scheduled seed — the
replacement for the reference's global ``ia.seed``/``np.random.seed``
(dataset.py:184-186).
"""

from __future__ import annotations

import os
import os.path as osp
import sys
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Sample = Dict[str, object]
TransFn = Callable[[Tuple[int, int]], Callable[[Sample], Sample]]


def _read_image_rgb(path: str) -> np.ndarray:
    import cv2

    if not osp.exists(path):
        raise FileNotFoundError(path)
    img = cv2.imread(path)
    if img is None:
        raise IOError(f"failed to decode {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def image_path_to_label_path(img_path: str) -> str:
    """COCO list layout contract: the label txt lives at the image path with
    the LAST path component named ``images`` replaced by ``labels`` and the
    extension replaced by ``.txt`` (reference dataset.py:178 — made safe: the
    reference's blind ``str.replace("jpg","txt")/("images","labels")``
    corrupts paths containing those substrings elsewhere and misses .jpeg/.png)."""
    root, _ext = osp.splitext(img_path)
    parts = root.split(os.sep)
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "images":
            parts[i] = "labels"
            break
    return os.sep.join(parts) + ".txt"


class ListDataset:
    """Image-list-file dataset (the reference's COCODataset source format,
    dataset.py:159-205): a txt of image paths; label txt rows
    (cls, cx, cy, w, h) relative."""

    def __init__(self, targ_txt_path: str, trans_fn: Optional[TransFn] = None,
                 subset_idx: Optional[Sequence[int]] = None,
                 require_labels: bool = False):
        with open(targ_txt_path) as f:
            self.img_list = [ln.strip() for ln in f if ln.strip()]
        self.label_list = [image_path_to_label_path(p) for p in self.img_list]
        if subset_idx is not None:
            self.img_list = [self.img_list[i] for i in subset_idx]
            self.label_list = [self.label_list[i] for i in subset_idx]
        self.trans_fn = trans_fn
        # Guard against layouts the path contract doesn't cover (no
        # '/images/' component, labels beside the images, etc.): every
        # sample would silently train/evaluate against zero ground truth.
        # Results-only flows (generate_results_file) legitimately run
        # without labels, so absence is an error only when labels are
        # declared required (the training CLI does) — but always say so.
        if self.img_list and not any(osp.exists(p) for p in self.label_list):
            msg = (
                f"no label file found for ANY of the {len(self.img_list)} "
                f"images in {targ_txt_path} (expected e.g. "
                f"{self.label_list[0]!r}; contract: last 'images' path "
                "component -> 'labels', extension -> .txt)"
            )
            if require_labels:
                raise FileNotFoundError(msg)
            print(f"[ListDataset] WARNING: {msg}", file=sys.stderr)

    def __len__(self) -> int:
        return len(self.img_list)

    def load_raw(self, base_idx: int) -> Sample:
        img = _read_image_rgb(self.img_list[base_idx])
        label = None
        lp = self.label_list[base_idx]
        if osp.exists(lp):
            label = np.loadtxt(lp).reshape(-1, 5).astype(np.float32)
        return {
            "img": img,
            "org_img": img.copy(),
            "label": label,
            "img_path": self.img_list[base_idx],
        }

    def get(self, base_idx: int, dim: Tuple[int, int], seed: int) -> Sample:
        sample = self.load_raw(base_idx)
        sample["rng"] = np.random.default_rng(seed)
        if self.trans_fn is not None:
            sample = self.trans_fn(dim)(sample)
        return sample

    def raw_entry(self, base_idx: int):
        """(img_path, label rows) without decoding the image — the native
        C++ augmentation path decodes and augments off the GIL
        (data/native_aug.py)."""
        label = None
        lp = self.label_list[base_idx]
        if osp.exists(lp):
            label = np.loadtxt(lp).reshape(-1, 5).astype(np.float32)
        return self.img_list[base_idx], label


# Backwards-friendly alias matching the reference class name.
COCODataset = ListDataset


def get_xml_labels(xml_path: str) -> "OrderedDict[str, List[Dict[str, str]]]":
    """Parse CVAT-for-images XML: <image name=...><box label xtl ytl xbr ybr/>
    (reference get_xml_labels, dataset.py:294-316)."""
    from lxml import etree

    labels: "OrderedDict[str, List[Dict[str, str]]]" = OrderedDict()
    root = etree.parse(xml_path).getroot()
    for image in root.xpath("image"):
        name = image.get("name")
        labels[name] = []
        for box in image:
            labels[name].append({
                "cls": box.get("label"),
                "x1": box.get("xtl"),
                "y1": box.get("ytl"),
                "x2": box.get("xbr"),
                "y2": box.get("ybr"),
            })
    return labels


class CVATDataset:
    """CVAT XML dataset for custom-class fine-tuning
    (reference CVATDataset, dataset.py:207-265)."""

    def __init__(self, img_dir: str, label_xml_path: str,
                 class2id: Optional[Dict[str, int]] = None,
                 trans_fn: Optional[TransFn] = None,
                 subset_idx: Optional[Sequence[int]] = None):
        self.img_dir = img_dir
        self.class2id = class2id or {"x_wing": 0, "tie": 1}
        self.id2class = {v: k for k, v in self.class2id.items()}
        self.xml_items = list(get_xml_labels(label_xml_path).items())
        if subset_idx is not None:
            self.xml_items = [self.xml_items[i] for i in subset_idx]
        self.trans_fn = trans_fn

    def __len__(self) -> int:
        return len(self.xml_items)

    def load_raw(self, base_idx: int) -> Sample:
        name, boxes = self.xml_items[base_idx]
        img_path = osp.join(self.img_dir, name)
        img = _read_image_rgb(img_path)
        h, w = img.shape[:2]
        label = None
        if boxes:
            rows = np.array(
                [[self.class2id[b["cls"]], float(b["x1"]), float(b["y1"]),
                  float(b["x2"]), float(b["y2"])] for b in boxes],
                np.float32,
            )
            # abs corners -> relative cxcywh (reference dataset.py:258-261).
            # Copies, not views: the assignments below write into rows[:, 1:]
            # and would otherwise corrupt x1/y1 before w/h are computed.
            x1, y1, x2, y2 = (rows[:, 1].copy(), rows[:, 2].copy(),
                              rows[:, 3].copy(), rows[:, 4].copy())
            rows[:, 1] = (x1 + x2) / 2 / w
            rows[:, 2] = (y1 + y2) / 2 / h
            rows[:, 3] = (x2 - x1) / w
            rows[:, 4] = (y2 - y1) / h
            label = rows
        return {"img": img, "org_img": img.copy(), "label": label,
                "img_path": img_path}

    def get(self, base_idx: int, dim: Tuple[int, int], seed: int) -> Sample:
        sample = self.load_raw(base_idx)
        sample["rng"] = np.random.default_rng(seed)
        if self.trans_fn is not None:
            sample = self.trans_fn(dim)(sample)
        return sample


class ImageFolderDataset:
    """Unlabeled image directory for pure inference
    (reference ImageFolderDataset, dataset.py:267-289)."""

    def __init__(self, img_dir: str, transform=None):
        self.img_dir = img_dir
        self.img_list = sorted(os.listdir(img_dir))
        self.transform = transform

    def __len__(self) -> int:
        return len(self.img_list)

    def __getitem__(self, idx: int) -> Sample:
        img = _read_image_rgb(osp.join(self.img_dir, self.img_list[idx]))
        sample: Sample = {"img": img, "org_img": img, "label": None,
                          "img_path": osp.join(self.img_dir, self.img_list[idx])}
        if self.transform is not None:
            sample["rng"] = np.random.default_rng(0)
            sample = self.transform(sample)
        return sample


class CachedDataset:
    """RAM cache over a dataset whose transform is deterministic.

    For no-augmentation training (the reference's custom-data overfit run
    sets ``isAug=False`` — reference custom_data_train.ipynb cells 6/10: the
    pipeline is letterbox+tensorize only) every ``get`` is a pure function
    of ``(base_idx, dim)``: re-decoding and re-letterboxing the same JPEG
    every epoch is wasted host work, and on a 1-core host it starves the
    chip.  This wrapper caches finalized samples by ``(base_idx, dim)``,
    ignoring the scheduled seed — ONLY valid when the wrapped transform
    draws nothing from ``sample["rng"]`` (e.g. ``transforms.eval_transform``
    / ``training_transform`` is NOT safe).  Cached arrays are frozen
    (``writeable=False``) so any downstream mutation raises instead of
    corrupting later epochs.
    """

    def __init__(self, dataset):
        self.dataset = dataset
        self._cache: Dict[Tuple[int, Tuple[int, int]], Sample] = {}

    def __len__(self) -> int:
        return len(self.dataset)

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def get(self, base_idx: int, dim: Tuple[int, int], seed: int) -> Sample:
        key = (base_idx, tuple(dim))
        hit = self._cache.get(key)
        if hit is None:
            hit = self.dataset.get(base_idx, dim, seed)
            for v in hit.values():
                if isinstance(v, np.ndarray):
                    v.setflags(write=False)
            self._cache[key] = hit
        return dict(hit)


def export_cvat_to_list(img_dir: str, xml_path: str, out_dir: str,
                        class2id: Optional[Dict[str, int]] = None) -> str:
    """Materialize a CVAT XML dataset as the COCO list-file layout that the
    eval pipeline consumes (``eval/pipeline.py``): ``out_dir/images/*.jpg``
    (symlinks), ``out_dir/labels/*.txt`` (rows ``cls cx cy w h`` relative —
    reference dataset.py:178 convention), and ``out_dir/list.txt``.  Returns
    the list-file path.  This is the bridge that lets mAP evaluation run on
    the reference's custom CVAT data (reference custom_data_train.ipynb has
    no eval; this repo's eval harness expects list files)."""
    class2id = class2id or {"x_wing": 0, "tie": 1}
    img_out = osp.join(out_dir, "images")
    lbl_out = osp.join(out_dir, "labels")
    os.makedirs(img_out, exist_ok=True)
    os.makedirs(lbl_out, exist_ok=True)
    list_path = osp.join(out_dir, "list.txt")
    lines = []
    for name, boxes in get_xml_labels(xml_path).items():
        src = osp.abspath(osp.join(img_dir, name))
        dst = osp.join(img_out, name)
        if not osp.exists(dst):
            os.symlink(src, dst)
        h, w = _read_image_rgb(src).shape[:2]
        rows = []
        for b in boxes:
            x1, y1, x2, y2 = (float(b["x1"]), float(b["y1"]),
                              float(b["x2"]), float(b["y2"]))
            rows.append(
                f"{class2id[b['cls']]} {(x1 + x2) / 2 / w:.6f} "
                f"{(y1 + y2) / 2 / h:.6f} {(x2 - x1) / w:.6f} "
                f"{(y2 - y1) / h:.6f}"
            )
        base = name.rsplit(".", 1)[0]
        with open(osp.join(lbl_out, base + ".txt"), "w") as f:
            f.write("\n".join(rows) + ("\n" if rows else ""))
        lines.append(dst)
    with open(list_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return list_path
