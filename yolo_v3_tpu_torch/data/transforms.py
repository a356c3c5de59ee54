"""Host-side image/label transforms: darknet-parity augmentation.

The port's own copy of ``yolo_v3_tpu/data/transforms.py``: every draw from
``sample["rng"]`` comes in the JAX package's order, so the same seed gives
the same sample, and the native path (:mod:`yolo_v3_tpu_torch.data.
native_aug`) mirrors these draws one for one.  OpenCV is imported only in the
transforms that use it.

numpy/OpenCV re-implementation of the reference's imgaug pipeline
(reference transforms.py) with all randomness drawn from an explicit
``numpy.random.Generator`` — the per-sample seed from the scheduler replaces
the reference's global ``ia.seed``/``np.random.seed`` calls
(dataset.py:184-186), which is what makes the pipeline deterministic and
resumable per sample rather than per process.

Samples are dicts: {img (HWC uint8 or float), org_img, label [n,5] rows
(cls, cx, cy, w, h) relative, lb_reverter, img_path}.  Output images are
HWC float32 in [0,1]: the port keeps the JAX package's NHWC layout (the
reference emits CHW torch tensors, transforms.py:34).

Darknet-parity semantics:
* HSV: hue additive ±179*hue on the H channel, saturation/exposure
  multiplicative with ``rand_scale`` (uniform(1, s), 1/2 chance reciprocal)
  (reference transforms.py:77-108, mirroring darknet src),
* jitter crop: per-side crop/pad within ±jitter of width/height, gray-128
  fill (reference transforms.py:110-125),
* letterbox: cubic resize + center gray pad (reference transforms.py:144-209),
* boxes are clipped after geometry; boxes retaining <10% of their area are
  dropped (reference bbs_remove_cut_out, transforms.py:222-259).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from yolo_v3_tpu_torch.ops.boxes import letterbox_params

Sample = Dict[str, object]


class Compose:
    """Sequential transform application (reference transforms.py:15-22)."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample: Sample) -> Sample:
        for t in self.transforms:
            sample = t(sample)
        return sample


def fill_label(label: Optional[np.ndarray], rows: int, cols: int = 5) -> np.ndarray:
    """Pad/truncate labels to fixed [rows, cols]
    (reference fill_label_np_tensor, utils.py:267-272)."""
    out = np.zeros((rows, cols), np.float32)
    if label is not None and len(label):
        n = min(len(label), rows)
        out[:n] = label[:n]
    return out


class ToArray:
    """Finalize sample: HWC float32 [0,1] image + fixed-shape label
    (reference ToTensor, transforms.py:25-43, minus the CHW permute)."""

    def __init__(self, max_labels: int = 90, max_label_cols: int = 5,
                 keep_uint8: bool = False):
        self.max_labels = max_labels
        self.max_label_cols = max_label_cols
        # keep_uint8 leaves the image as uint8 for a device-side /255
        # (train/step.py normalizes in f32 on device — lossless, 4x less
        # host->device traffic).  Only valid when every upstream transform
        # preserved uint8 (letterbox/resize do; float augs don't).
        self.keep_uint8 = keep_uint8

    def __call__(self, sample: Sample) -> Sample:
        img = sample.get("img")
        if img is not None and img.dtype == np.uint8 and not self.keep_uint8:
            img = img.astype(np.float32) / 255.0
        sample["img"] = img
        sample["label"] = fill_label(
            sample.get("label"), self.max_labels, self.max_label_cols
        )
        lb = sample.get("lb_reverter")
        if lb is not None:
            sample["lb_reverter"] = np.asarray(lb, np.float32)
        return sample


# ---------------------------------------------------------------------------
# Label geometry helpers (relative cxcywh <-> absolute corners)
# ---------------------------------------------------------------------------

def _labels_to_corners(label: np.ndarray, w: int, h: int) -> np.ndarray:
    out = label.astype(np.float64).copy()
    cx, cy = out[:, 1] * w, out[:, 2] * h
    bw, bh = out[:, 3] * w, out[:, 4] * h
    out[:, 1], out[:, 2] = cx - bw / 2, cy - bh / 2
    out[:, 3], out[:, 4] = cx + bw / 2, cy + bh / 2
    return out


def _corners_to_labels(corners: np.ndarray, w: int, h: int) -> np.ndarray:
    out = corners.copy()
    # .copy() each column: bare out[:, i] would be VIEWS into out, and the
    # out[:, 1]/out[:, 2] center writes below would corrupt x1/y1 before the
    # w/h computation reads them (the round-3 label-size bug — every
    # letterboxed/cropped label's w/h degenerated to corner/dim).
    x1, y1, x2, y2 = (out[:, 1].copy(), out[:, 2].copy(),
                      out[:, 3].copy(), out[:, 4].copy())
    out[:, 1], out[:, 2] = (x1 + x2) / 2 / w, (y1 + y2) / 2 / h
    out[:, 3], out[:, 4] = (x2 - x1) / w, (y2 - y1) / h
    return out.astype(np.float32)


def clip_and_filter_boxes(
    corners: np.ndarray, w: int, h: int, area_thr: float = 0.1
) -> np.ndarray:
    """Clip corner boxes to the frame; drop boxes keeping <= area_thr of
    their area (reference bbs_clip/bbs_remove_cut_out, transforms.py:230-259,
    applied at area_thr=0.1 via iaa_run_seq, transforms.py:214-220)."""
    if len(corners) == 0:
        return corners
    # float64 bounds regardless of the caller's int flavor: a np.int64 dim
    # minus a float32 eps promotes to float64 while a Python int stays
    # float32 (NEP 50) — a 1-ulp clip-bound skew that broke Python/native
    # bit-parity on boxes clipped at the right/bottom edge.
    w, h = float(w), float(h)
    eps = np.finfo(np.float32).eps
    x1 = np.clip(corners[:, 1], 0, w - eps)
    y1 = np.clip(corners[:, 2], 0, h - eps)
    x2 = np.clip(corners[:, 3], 0, w - eps)
    y2 = np.clip(corners[:, 4], 0, h - eps)
    area = (x2 - x1) * (y2 - y1)
    org_area = (corners[:, 3] - corners[:, 1]) * (corners[:, 4] - corners[:, 2])
    keep = np.divide(area, org_area, out=np.zeros_like(area),
                     where=org_area > 0) > area_thr
    out = corners[keep].copy()
    out[:, 1], out[:, 2], out[:, 3], out[:, 4] = (
        x1[keep], y1[keep], x2[keep], y2[keep]
    )
    return out


# ---------------------------------------------------------------------------
# Augmentations (seeded by an explicit Generator)
# ---------------------------------------------------------------------------

def rand_scale(rng: np.random.Generator, val: float) -> float:
    """darknet's rand_scale: uniform(1, s), reciprocal with prob 1/2
    (reference transforms.py:80-84)."""
    s = rng.uniform(1.0, val)
    if rng.random() < 0.5:
        s = 1.0 / s
    return s


class HSVAug:
    """Hue/saturation/exposure jitter with darknet semantics
    (reference iaa_hsv_aug, transforms.py:87-108)."""

    def __init__(self, hue: float = 0.1, saturation: float = 1.5,
                 exposure: float = 1.5):
        self.hue = hue
        self.saturation = saturation
        self.exposure = exposure

    def __call__(self, sample: Sample) -> Sample:
        import cv2

        rng: np.random.Generator = sample["rng"]
        dhue = rng.uniform(-self.hue, self.hue) * 179
        dsat = rand_scale(rng, self.saturation)
        dexp = rand_scale(rng, self.exposure)

        img = sample["img"]
        hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.float32)
        hsv[..., 0] = np.clip(hsv[..., 0] + dhue, 0, 255)
        hsv[..., 1] = np.clip(hsv[..., 1] * dsat, 0, 255)
        hsv[..., 2] = np.clip(hsv[..., 2] * dexp, 0, 255)
        sample["img"] = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)
        return sample


class RandomJitterCrop:
    """Per-side crop/pad within ±jitter fraction, gray-128 fill
    (reference iaa_random_crop, transforms.py:110-125 / darknet data.c)."""

    def __init__(self, jitter: float = 0.3, pad_value: int = 128,
                 area_thr: float = 0.1):
        self.jitter = jitter
        self.pad_value = pad_value
        self.area_thr = area_thr

    def __call__(self, sample: Sample) -> Sample:
        rng: np.random.Generator = sample["rng"]
        img = sample["img"]
        h, w = img.shape[:2]
        dw, dh = int(w * self.jitter), int(h * self.jitter)
        # crop>0 removes pixels, crop<0 pads, per side
        left = rng.integers(-dw, dw + 1)
        right = rng.integers(-dw, dw + 1)
        top = rng.integers(-dh, dh + 1)
        bottom = rng.integers(-dh, dh + 1)

        new_w = w - left - right
        new_h = h - top - bottom
        if new_w < 1 or new_h < 1:
            return sample  # degenerate draw: skip, like imgaug keep_size=False guards

        canvas = np.full((new_h, new_w, img.shape[2]), self.pad_value, img.dtype)
        # source region in original image, dest region in canvas
        sx1, dx1 = max(left, 0), max(-left, 0)
        sy1, dy1 = max(top, 0), max(-top, 0)
        sx2 = min(w, w - right)
        sy2 = min(h, h - bottom)
        if sx2 > sx1 and sy2 > sy1:
            canvas[dy1:dy1 + (sy2 - sy1), dx1:dx1 + (sx2 - sx1)] = (
                img[sy1:sy2, sx1:sx2]
            )
        sample["img"] = canvas

        label = sample.get("label")
        if label is not None and len(label):
            corners = _labels_to_corners(label, w, h)
            corners[:, [1, 3]] -= left
            corners[:, [2, 4]] -= top
            corners = clip_and_filter_boxes(corners, new_w, new_h, self.area_thr)
            sample["label"] = _corners_to_labels(corners, new_w, new_h)
        return sample


class RandomHorizontalFlip:
    """Mirror image + labels with probability p (the reference training
    notebooks' iaa.Fliplr(0.5))."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, sample: Sample) -> Sample:
        rng: np.random.Generator = sample["rng"]
        if rng.random() < self.p:
            sample["img"] = sample["img"][:, ::-1].copy()
            label = sample.get("label")
            if label is not None and len(label):
                label = label.copy()
                label[:, 1] = 1.0 - label[:, 1]
                sample["label"] = label
        return sample


class Letterbox:
    """Aspect-preserving resize + center gray pad; stashes the reverter
    (org_w, org_h, padded_w, padded_h, x_pad, y_pad) for box un-mapping
    (reference IaaLetterbox + lb_reverter, transforms.py:127-209)."""

    def __init__(self, dim: Tuple[int, int], pad_value: int = 128):
        self.dim = dim
        self.pad_value = pad_value

    def __call__(self, sample: Sample) -> Sample:
        import cv2

        img = sample["img"]
        h, w = img.shape[:2]
        out_w, out_h = self.dim
        rw, rh, xp, yp, _ = letterbox_params(w, h, out_w, out_h)

        canvas = np.full((out_h, out_w, img.shape[2]), self.pad_value, img.dtype)
        canvas[yp:yp + rh, xp:xp + rw] = cv2.resize(
            img, (rw, rh), interpolation=cv2.INTER_CUBIC
        )
        sample["img"] = canvas
        sample["lb_reverter"] = np.array([w, h, rw, rh, xp, yp], np.float32)

        label = sample.get("label")
        if label is not None and len(label):
            corners = _labels_to_corners(label, w, h)
            scale = rw / w
            corners[:, 1:5] *= scale
            corners[:, [1, 3]] += xp
            corners[:, [2, 4]] += yp
            sample["label"] = _corners_to_labels(corners, out_w, out_h)
        return sample


class Resize:
    """Plain (non-letterbox) resize, the reference's iaa.Scale eval variant
    (reference evaluate.py:213)."""

    def __init__(self, dim: Tuple[int, int]):
        self.dim = dim

    def __call__(self, sample: Sample) -> Sample:
        import cv2

        img = sample["img"]
        h, w = img.shape[:2]
        sample["img"] = cv2.resize(img, self.dim, interpolation=cv2.INTER_CUBIC)
        sample["lb_reverter"] = np.array(
            [w, h, self.dim[0], self.dim[1], 0, 0], np.float32
        )
        # relative labels are resize-invariant
        return sample


class ExtraAugmentations:
    """Optional photometric bank: blur/sharpen/noise/brightness/contrast,
    each applied with prob 1/2 in random order (reference ExtraAugmentations,
    transforms.py:292-329)."""

    def __call__(self, sample: Sample) -> Sample:
        import cv2

        rng: np.random.Generator = sample["rng"]
        img = sample["img"].astype(np.float32)

        def blur(im):
            k = int(rng.integers(1, 4)) * 2 + 1
            return cv2.GaussianBlur(im, (k, k), 0)

        def sharpen(im):
            alpha = rng.uniform(0, 0.5)
            blurred = cv2.GaussianBlur(im, (3, 3), 0)
            return im + alpha * (im - blurred)

        def noise(im):
            return im + rng.normal(0, rng.uniform(0, 0.05 * 255), im.shape)

        def brightness(im):
            return im * rng.uniform(0.8, 1.2)

        def contrast(im):
            c = rng.uniform(0.5, 2.0)
            return (im - 128.0) * c + 128.0

        ops = [blur, sharpen, noise, brightness, contrast]
        rng.shuffle(ops)
        for op in ops:
            if rng.random() < 0.5:
                img = op(img)
        sample["img"] = np.clip(img, 0, 255).astype(np.uint8)
        return sample


def training_transform(dim: Tuple[int, int], hue=0.1, saturation=1.5,
                       exposure=1.5, jitter=0.3, max_labels=90,
                       extra_aug: bool = False,
                       feed_u8: bool = False) -> Compose:
    """The reference training pipeline: HSV + jitter crop + flip + letterbox
    + tensorize (reference README.md:49-56, dataset trans_fn usage);
    ``extra_aug`` prepends the optional photometric bank
    (reference ExtraAugmentations, transforms.py:292-329).

    ``feed_u8`` keeps the augmented, letterboxed image uint8 so the train
    step normalizes on device (lossless — every stage of this chain is
    uint8-in/uint8-out, darknet itself augments u8 pixels; cuts the
    host->device feed bytes 4x).
    """
    steps = [
        HSVAug(hue, saturation, exposure),
        RandomJitterCrop(jitter),
        RandomHorizontalFlip(0.5),
        Letterbox(dim),
        ToArray(max_labels=max_labels, keep_uint8=feed_u8),
    ]
    if extra_aug:
        steps.insert(0, ExtraAugmentations())
    return Compose(steps)


def eval_transform(dim: Tuple[int, int], letterbox: bool = True,
                   max_labels: int = 90, feed_u8: bool = False) -> Compose:
    """The reference eval pipeline (reference evaluate.py:210-213).

    ``feed_u8`` keeps the letterboxed image uint8 so the training step
    normalizes on device (lossless; cuts host->device bytes 4x).
    """
    resize = Letterbox(dim) if letterbox else Resize(dim)
    return Compose([resize, ToArray(max_labels=max_labels,
                                    keep_uint8=feed_u8)])
