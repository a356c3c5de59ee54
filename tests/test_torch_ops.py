"""The port's box geometry, letterbox and display postprocess against the
JAX package on the same numpy inputs, including exact score ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_v3_tpu.ops import boxes as JB
from yolo_v3_tpu.ops import letterbox as JL
from yolo_v3_tpu.ops import postprocess as JP
from yolo_v3_tpu.utils.config import YoloConfig as JConfig
from yolo_v3_tpu_torch.ops import boxes as TB
from yolo_v3_tpu_torch.ops import letterbox as TL
from yolo_v3_tpu_torch.ops import postprocess as TP
from yolo_v3_tpu_torch.utils.config import YoloConfig


def _rand_boxes(rng, n, span=60.0):
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(2, 20, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("hw", [(48, 96), (100, 70)])
def test_letterbox_device_matches_jax(hw):
    img = np.random.default_rng(0).integers(0, 255, hw + (3,), dtype=np.uint8)
    want = np.asarray(JL.letterbox_device(jnp.asarray(img), (64, 64)))
    src, desc, _ = TL.stage_batch([img], 64, True, "cpu")
    got = TL.letterbox_batch(src, desc, 64)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_letterbox_host_matches_jax():
    img = np.random.default_rng(6).integers(0, 255, (50, 90, 3), dtype=np.uint8)
    np.testing.assert_array_equal(TL.letterbox_host_u8(img, (64, 64)),
                                  JL.letterbox_host_u8(img, (64, 64)))
    np.testing.assert_array_equal(TL.letterbox_host(img, (64, 64)),
                                  JL.letterbox_host(img, (64, 64)))


@pytest.mark.parametrize("is_letterbox", [True, False])
def test_correct_yolo_boxes_matches_jax(is_letterbox):
    rng = np.random.default_rng(1)
    boxes = _rand_boxes(rng, 16, span=150.0)
    org = np.array([[640.0, 480.0], [300.0, 700.0]], np.float32)
    got = TB.correct_yolo_boxes(
        torch.from_numpy(np.stack([boxes, boxes])), torch.from_numpy(org[:, :1]),
        torch.from_numpy(org[:, 1:]), 160, 160, is_letterbox=is_letterbox)
    for i in range(2):
        want = JB.correct_yolo_boxes(jnp.asarray(boxes), org[i, 0], org[i, 1],
                                     160, 160, is_letterbox=is_letterbox)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-4)


def test_iou_matrix_matches_jax_with_degenerate_nan():
    rng = np.random.default_rng(2)
    b1, b2 = _rand_boxes(rng, 7), _rand_boxes(rng, 5)
    b1[3] = b2[1] = [5.0, 5.0, 5.0, 5.0]      # zero-area pair -> 0/0 = NaN
    want = np.asarray(JB.iou_matrix(jnp.asarray(b1), jnp.asarray(b2)))
    got = TB.iou_matrix(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    assert np.isnan(got[3, 1]) and np.isnan(want[3, 1])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("presorted", [False, True])
def test_nms_fixed_matches_jax_with_ties(presorted):
    rng = np.random.default_rng(3)
    k = 40
    centers = rng.uniform(0, 40, (k, 2))
    boxes = np.concatenate([centers, centers + 12.0], 1).astype(np.float32)
    scores = rng.choice([0.0, 0.55, 0.6, 0.7, 0.9], size=k).astype(np.float32)
    if presorted:
        scores = -np.sort(-scores)
    got_i, got_v = TP.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                                0.3, 16, presorted=presorted)
    want_i, want_v = JP.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), 0.3, 16,
                                  presorted=presorted)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    v = np.asarray(want_v)
    np.testing.assert_array_equal(got_i.numpy()[v], np.asarray(want_i)[v])


def _tied_raws(seed, num_classes=2, dims=(2, 4, 8), batch=2):
    """Random raw heads in which whole groups of candidates share exactly
    the same objectness and class logits (so the same scores) but have
    different boxes."""
    rng = np.random.default_rng(seed)
    attrib = 5 + num_classes
    raws = []
    for d in dims:
        r = rng.normal(0, 2.0, (batch, d, d, 3, attrib)).astype(np.float32)
        flat = r.reshape(batch, -1, attrib)
        src = rng.integers(0, flat.shape[1], 4)
        for s in src:
            dst = rng.integers(0, flat.shape[1], 3)
            flat[:, dst, 4:] = flat[:, s:s + 1, 4:]
        raws.append(flat.reshape(batch, d, d, 3 * attrib))
    return raws


@pytest.mark.parametrize("use_nms", [True, False])
def test_fast_display_matches_jax_with_ties(use_nms):
    kw = dict(num_classes=2, img_dim=64, max_detections=12,
              display_per_scale_topk=6)
    raws = _tied_raws(4)
    want = JP.postprocess_from_raws([jnp.asarray(r) for r in raws], JConfig(**kw),
                                    64, conf_thr=0.3, nms_thr=0.4, use_nms=use_nms)
    got = TP.postprocess_from_raws([torch.from_numpy(r) for r in raws],
                                   YoloConfig(**kw), 64, conf_thr=0.3,
                                   nms_thr=0.4, use_nms=use_nms)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert (want[..., 7] > 0).sum() >= 8
    np.testing.assert_array_equal(got[..., 7].numpy(), want[..., 7])
    np.testing.assert_array_equal(got[..., 6].numpy(), want[..., 6])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_unported_modes_raise():
    """Eval mode and the global-top-k display path are served now
    (tests/test_torch_postprocess_modes.py); what is on ROADMAP's
    do-not-port list raises and says so: approx_max_k at recall 0.99 and the
    truncated top-k eval path (eval_grid_nms=False, or eval without NMS)."""
    raws = [torch.from_numpy(r) for r in _tied_raws(5)]
    cfg = YoloConfig(num_classes=2)
    for kw in (dict(is_eval=True), dict()):
        out = TP.postprocess_from_raws(
            raws, YoloConfig(num_classes=2, display_per_scale_topk=0), 64, 0.3, 0.4, **kw)
        assert out.shape == (2, cfg.max_detections, 8) and bool((out[..., 7] > 0).any())
    for config, kw in ((YoloConfig(num_classes=2, eval_approx_topk=True), {}),
                       (YoloConfig(num_classes=2, eval_grid_nms=False), {}),
                       (cfg, dict(use_nms=False))):
        with pytest.raises(NotImplementedError, match="do-not-port"):
            TP.postprocess_from_raws(raws, config, 64, 0.3, 0.4, is_eval=True, **kw)
