"""The port's ``Detector`` preprocess options (``letterbox``,
``resize_on_device``) and eval-mode detection against the JAX ``Detector``,
on the small float net of ``tests/test_torch_model_detector.py`` (blocks
(1,1,1,1,1), 2 classes, 128 px, BN spread out, detection convs scaled up).

Tolerances and why:
* preprocessed batches: the host paths (OpenCV) bit-equal; the device
  resize within 1e-6 (its two matmuls sum in another order);
* fp32 rows: the same rows and classes, boxes within 1e-2 px,
  probabilities within 1e-4 (as ``test_detect_matches_jax_detector``: the
  JAX Detector runs the s2d entry, an exact re-expression of the same convs,
  so only summation order differs);
* bf16 rows: the two frameworks' bf16 convs sum in different orders (and
  the CPU's in an order that follows the thread count), so scores near the
  threshold or the ``max_detections`` cut move; at least 80% of the JAX
  rows of every image have a port row of the same class at IoU > 0.5
  (measured: 83.3% to 100% at 1, 2, 4 or 8 threads;
  ``scripts/bf16_jax_agreement.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_v3_tpu.detector import Detector as JDetector
from yolo_v3_tpu.models import darknet as JD
from yolo_v3_tpu.utils.config import YoloConfig as JConfig
from yolo_v3_tpu_torch.detector import Detector
from yolo_v3_tpu_torch.models import weights as TW
from yolo_v3_tpu_torch.utils.config import YoloConfig

CFG = dict(num_classes=2, img_dim=128, max_detections=32)
OPTIONS = [(False, True), (True, False), (False, False)]   # (letterbox, resize_on_device)


@pytest.fixture(scope="module")
def trees():
    """tests/test_torch_model_detector.py's params."""
    jp, js = JD.init_yolonet(jax.random.PRNGKey(0), num_classes=2, blocks=(1, 1, 1, 1, 1))
    p, s = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    rng = np.random.default_rng(0)

    def walk(pp, ss):
        if "bn" in pp:
            c = pp["bn"]["scale"].shape[0]
            pp["bn"]["scale"] = rng.uniform(1.5, 2.5, c).astype(np.float32)
            pp["bn"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
            ss["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            ss["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        elif "b" in pp:
            pp["w"] = pp["w"] * 8.0
        else:
            for k in pp:
                walk(pp[k], ss.get(k, {}))

    walk(p, s)
    return p, s


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 255, (100, 140, 3), dtype=np.uint8),
            rng.integers(0, 255, (120, 90, 3), dtype=np.uint8)]


_CACHE = {}


def _pair(trees, precision, letterbox, resize_on_device):
    """The JAX and the port Detector with the same options (built once)."""
    key = (precision, letterbox, resize_on_device)
    if key not in _CACHE:
        p, s = trees
        kw = dict(precision=precision, letterbox=letterbox, resize_on_device=resize_on_device)
        _CACHE[key] = (
            JDetector(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s),
                      JConfig(**CFG), **kw),
            Detector(TW.params_from_numpy(p), TW.params_from_numpy(s), YoloConfig(**CFG),
                     device="cpu", **kw))
    return _CACHE[key]


def _iou_xywh(a, b):
    ix = np.clip(np.minimum(a[0] + a[2], b[:, 0] + b[:, 2]) - np.maximum(a[0], b[:, 0]), 0, None)
    iy = np.clip(np.minimum(a[1] + a[3], b[:, 1] + b[:, 3]) - np.maximum(a[1], b[:, 1]), 0, None)
    inter = ix * iy
    return inter / (a[2] * a[3] + b[:, 2] * b[:, 3] - inter + 1e-9)


def _agreement(ref, rows):
    """Share of ``ref``'s rows matched one to one by a row of ``rows`` of
    the same class at IoU > 0.5."""
    used, hit = np.zeros(len(rows), bool), 0
    for r in ref:
        ok = (rows[:, 0] == r[0]) & ~used & (_iou_xywh(r[1:5], rows[:, 1:5]) > 0.5)
        if ok.any():
            used[np.argmax(ok)] = True
            hit += 1
    return hit / max(len(ref), 1)


@pytest.mark.parametrize("letterbox,resize_on_device", OPTIONS + [(True, True)])
def test_preprocess_matches_jax(trees, images, letterbox, resize_on_device):
    jdet, det = _pair(trees, "fp32", letterbox, resize_on_device)
    jx, jorg = jdet.preprocess(images)
    x, org = det.preprocess(images)
    assert x.dtype == torch.float32 and tuple(x.shape) == (2, 128, 128, 3)
    np.testing.assert_array_equal(org.numpy(), np.asarray(jorg))
    if resize_on_device:
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))


@pytest.mark.parametrize("is_eval", [False, True])
@pytest.mark.parametrize("letterbox,resize_on_device", OPTIONS)
def test_fp32_detect_options_match_jax(trees, images, letterbox, resize_on_device, is_eval):
    jdet, det = _pair(trees, "fp32", letterbox, resize_on_device)
    thr = dict(conf_thr=0.3) if is_eval else dict(conf_thr=0.7)
    want = jdet.detect(images, is_eval=is_eval, **thr)
    got = det.detect(images, is_eval=is_eval, **thr)
    for g, w in zip(got, want):
        assert g.shape == w.shape and len(w) >= 10
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g[:, 1:5], w[:, 1:5], rtol=0, atol=1e-2)
        np.testing.assert_allclose(g[:, 5:], w[:, 5:], rtol=0, atol=1e-4)


def test_eval_detect_takes_the_eval_thresholds(trees, images):
    """``detect(is_eval=True)`` defaults to ``eval_conf_thr`` (0.005) and
    ``eval_nms_thr`` (0.45), and gives the JAX Detector's rows there, up to
    max_detections a image."""
    jdet, det = _pair(trees, "fp32", True, True)
    got = det.detect(images, is_eval=True)
    explicit = det.detect(images, is_eval=True, conf_thr=0.005, nms_thr=0.45)
    want = jdet.detect(images, is_eval=True)
    for g, e, w in zip(got, explicit, want):
        np.testing.assert_array_equal(g, e)
        assert g.shape == w.shape == (CFG["max_detections"], 7)
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g[:, 1:5], w[:, 1:5], rtol=0, atol=1e-2)
        np.testing.assert_allclose(g[:, 5:], w[:, 5:], rtol=0, atol=1e-4)
    assert not det.detect(images, is_eval=True, conf_thr=0.999999)[0].size


@pytest.mark.parametrize("letterbox,resize_on_device", OPTIONS)
def test_bf16_detect_options_agree_with_jax(trees, images, letterbox, resize_on_device):
    jdet, det = _pair(trees, "bf16", letterbox, resize_on_device)
    want = jdet.detect(images, conf_thr=0.7)
    got = det.detect(images, conf_thr=0.7)
    for g, w in zip(got, want):
        assert len(w) >= 10 and g.ndim == 2 and g.shape[1] == 7
        assert abs(len(g) - len(w)) <= 0.2 * len(w)
        assert _agreement(w, g) >= 0.8
