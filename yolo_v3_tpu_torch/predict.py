"""Batch prediction + visual comparison harness.

Port of ``yolo_v3_tpu/predict.py`` on the port's
:class:`~yolo_v3_tpu_torch.detector.Detector`: ``predict`` runs a detector
over a data source and returns display-ready images + predictions;
``show_detections`` renders them; ``predict_multiple`` /
``show_detections_comparisons`` run several models on the same data and
render Labels vs model columns side by side (the reference's visual
regression harness, reference test.py:20-108).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from yolo_v3_tpu_torch.viz.draw import show_img_grid


def _iter_images(data) -> List[dict]:
    """Accept an ImageFolderDataset, a list of samples, or a list of HWC
    uint8 arrays."""
    samples = []
    for item in (data[i] for i in range(len(data))) if hasattr(data, "__getitem__") else data:
        if isinstance(item, dict):
            samples.append(item)
        else:
            samples.append({"img": item, "org_img": item, "label": None})
    return samples


def predict(data, detector, conf_thr: Optional[float] = None,
            nms_thr: Optional[float] = None, batch_size: int = 8):
    """Run detection; returns (img_list, preds_list) where preds rows are
    [cls, x, y, w, h, prob, obj] in original-image pixels
    (reference predict, test.py:28-46)."""
    samples = _iter_images(data)
    imgs = [np.asarray(s["org_img"]) for s in samples]
    preds: List[np.ndarray] = []
    for i in range(0, len(imgs), batch_size):
        preds.extend(
            detector.detect(imgs[i:i + batch_size], conf_thr=conf_thr,
                            nms_thr=nms_thr)
        )
    return imgs, preds


def show_detections(data, detector, classes_names: Sequence[str],
                    cols: int = 2, save_path: Optional[str] = None, **kw):
    """Grid-render detections (reference show_detections, test.py:48-51)."""
    imgs, preds = predict(data, detector, **kw)
    return show_img_grid(imgs, cols=cols, classes=classes_names,
                         labels_list=preds, save_path=save_path)


def predict_multiple(data, detectors, conf_thr: Optional[float] = None,
                     nms_thr: Optional[float] = None, batch_size: int = 8):
    """Run N detectors over the same data (reference predict_multiple,
    test.py:54-94).  Returns (img_list, preds_per_model, labels_list);
    labels rows are [cls, x, y, w, h] absolute pixels when GT is present.
    """
    samples = _iter_images(data)
    imgs = [np.asarray(s["org_img"]) for s in samples]
    preds_per_model = []
    for det in detectors:
        _, preds = predict(samples, det, conf_thr=conf_thr, nms_thr=nms_thr,
                           batch_size=batch_size)
        preds_per_model.append(preds)

    labels_list = []
    for s, img in zip(samples, imgs):
        label = s.get("label")
        if label is None or len(np.atleast_2d(label)) == 0:
            labels_list.append(None)
            continue
        label = np.atleast_2d(np.asarray(label, np.float64)).copy()
        label = label[label.sum(axis=1) != 0]
        h, w = img.shape[:2]
        cx, cy = label[:, 1] * w, label[:, 2] * h
        bw, bh = label[:, 3] * w, label[:, 4] * h
        label[:, 1], label[:, 2] = cx - bw / 2, cy - bh / 2
        label[:, 3], label[:, 4] = bw, bh
        labels_list.append(label)
    return imgs, preds_per_model, labels_list


def show_detections_comparisons(
    detectors,
    data,
    classes_names: Sequence[str],
    col_titles: Optional[Sequence[str]] = None,
    save_path: Optional[str] = None,
    **kw,
):
    """Side-by-side Labels | model1 | model2 ... comparison grid
    (reference show_detections_comparisons, test.py:96-108)."""
    imgs, preds_per_model, labels_list = predict_multiple(data, detectors, **kw)
    cols = len(detectors) + 1
    grid_imgs, grid_labels = [], []
    for i, img in enumerate(imgs):
        grid_imgs.extend([img] * cols)
        grid_labels.append(labels_list[i])
        for preds in preds_per_model:
            grid_labels.append(preds[i])
    titles = list(col_titles) if col_titles else (
        ["Labels"] + [f"Model {i + 1}" for i in range(len(detectors))]
    )
    return show_img_grid(
        grid_imgs, cols=cols, classes=classes_names, labels_list=grid_labels,
        col_title_dict={"title": titles, "pad": 20, "fontsize": 18},
        save_path=save_path,
    )
