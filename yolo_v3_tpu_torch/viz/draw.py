"""Visualization: box overlays, image grids, model comparison panels.

Port of ``yolo_v3_tpu/viz/draw.py``: host-side presentation on numpy
arrays, nothing on the device.  The class palette is matplotlib's
``tab20b`` carried as its 20 RGB triples with matplotlib's index rule, so
:func:`draw_detections_cv2` and :func:`save_detections_image` need OpenCV
only (the card's host has OpenCV but not necessarily matplotlib);
:func:`draw_labels` and :func:`show_img_grid` import matplotlib inside.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = [
    "get_color_palette",
    "draw_labels",
    "show_img_grid",
    "draw_detections_cv2",
    "save_detections_image",
]

# matplotlib's tab20b colormap: its 20 colours in 8-bit RGB
TAB20B = (
    (57, 59, 121), (82, 84, 163), (107, 110, 207), (156, 158, 222),
    (99, 121, 57), (140, 162, 82), (181, 207, 107), (206, 219, 156),
    (140, 109, 49), (189, 158, 57), (231, 186, 82), (231, 203, 148),
    (132, 60, 57), (173, 73, 74), (214, 97, 107), (231, 150, 156),
    (123, 65, 115), (165, 81, 148), (206, 109, 189), (222, 158, 214),
)


def get_color_palette(num_classes: int):
    """Distinct per-class RGB colours in [0, 1] from ``tab20b``, sampled at
    ``i / max(num_classes - 1, 1)`` as the JAX package samples matplotlib's
    colormap: entry ``int(x * 20)``, 1.0 taking the last."""
    n = len(TAB20B)
    out = []
    for i in range(num_classes):
        x = i / max(num_classes - 1, 1)
        out.append(tuple(c / 255 for c in TAB20B[min(int(x * n), n - 1)]))
    return out


def draw_labels(ax, labels: np.ndarray, classes: Optional[Sequence[str]] = None,
                palette=None):
    """Draw [n, >=5] rows [cls, x, y, w, h, (prob ...)] (xywh pixels) onto a
    matplotlib axis with outlined text."""
    from matplotlib import patches, patheffects

    if labels is None or len(labels) == 0:
        return
    n_cls = len(classes) if classes else int(max(labels[:, 0].max() + 1, 1))
    palette = palette or get_color_palette(n_cls)
    for row in labels:
        cls = int(row[0])
        x, y, w, h = row[1:5]
        color = palette[cls % len(palette)]
        rect = patches.Rectangle((x, y), w, h, fill=False, edgecolor=color, lw=2)
        rect.set_path_effects([patheffects.Stroke(linewidth=3, foreground="black"),
                               patheffects.Normal()])
        ax.add_patch(rect)
        name = classes[cls] if classes and cls < len(classes) else str(cls)
        if len(row) > 5:
            name = f"{name} {row[5]:.2f}"
        txt = ax.text(x, y, name, color="white", fontsize=9, va="bottom")
        txt.set_path_effects([patheffects.Stroke(linewidth=2, foreground="black"),
                              patheffects.Normal()])


def show_img_grid(
    imgs: Sequence[np.ndarray],
    cols: int = 2,
    classes: Optional[Sequence[str]] = None,
    labels_list: Optional[Sequence[Optional[np.ndarray]]] = None,
    col_title_dict: Optional[Dict] = None,
    save_path: Optional[str] = None,
):
    """Grid of images with optional per-image label overlays and column
    titles; saved to ``save_path`` or shown."""
    import matplotlib
    if save_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(imgs)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(6 * cols, 5 * rows), squeeze=False)
    palette = get_color_palette(len(classes)) if classes else None
    for i, img in enumerate(imgs):
        ax = axes[i // cols][i % cols]
        if img.dtype != np.uint8 and img.max() <= 1.5:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        ax.imshow(img)
        ax.axis("off")
        if labels_list is not None and i < len(labels_list):
            draw_labels(ax, labels_list[i], classes, palette)
        if col_title_dict and i < cols:
            titles = col_title_dict.get("title", [])
            if i < len(titles):
                ax.set_title(titles[i], pad=col_title_dict.get("pad", 10),
                             fontsize=col_title_dict.get("fontsize", 14))
    for j in range(n, rows * cols):
        axes[j // cols][j % cols].axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    else:
        plt.show()
    return fig


def draw_detections_cv2(
    img: np.ndarray,
    detections: np.ndarray,
    classes: Optional[Sequence[str]] = None,
) -> np.ndarray:
    """OpenCV box + text-with-background rendering of rows [cls, x, y, w, h,
    (prob ...)]; returns a copy of the RGB image."""
    import cv2

    out = img.copy()
    if detections is None or len(detections) == 0:
        return out
    n_cls = len(classes) if classes else int(detections[:, 0].max() + 1)
    palette = [(int(r * 255), int(g * 255), int(b * 255))
               for r, g, b in get_color_palette(max(n_cls, 1))]
    for row in detections:
        cls = int(row[0])
        x, y, w, h = [int(v) for v in row[1:5]]
        color = palette[cls % len(palette)]
        cv2.rectangle(out, (x, y), (x + w, y + h), color, 2)
        name = classes[cls] if classes and cls < len(classes) else str(cls)
        if len(row) > 5:
            name = f"{name} {row[5]:.2f}"
        (tw, th), _ = cv2.getTextSize(name, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        cv2.rectangle(out, (x, y - th - 4), (x + tw, y), color, -1)
        cv2.putText(out, name, (x, y - 2), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (255, 255, 255), 1, cv2.LINE_AA)
    return out


def save_detections_image(img, detections, path, classes=None):
    """Write ``img`` (RGB) with its detections drawn to ``path``."""
    import cv2

    out = draw_detections_cv2(img, detections, classes)
    if not cv2.imwrite(path, cv2.cvtColor(out, cv2.COLOR_RGB2BGR)):
        raise OSError(f"cannot write image: {path}")
