"""The box functions the loss and the data engine need (conversions,
coordinate scaling, IoU, letterboxed labels) against the JAX package's on
the same inputs, atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_v3_tpu.ops import boxes as JB
from yolo_v3_tpu_torch.ops import boxes as TB

ATOL = 1e-6


def _boxes(seed, n=64):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.8, (3, n, 2))
    wh = rng.uniform(0.01, 0.4, (3, n, 2))
    return np.concatenate([xy, wh], -1).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


CONVERTERS = ["x1y1x2y2_to_cxcywh", "x1y1x2y2_to_xywh", "cxcywh_to_x1y1x2y2",
              "cxcywh_to_xywh", "xywh_to_x1y1x2y2", "xywh_to_cxcywh"]


@pytest.mark.parametrize("name", CONVERTERS)
def test_converters_match_jax(name):
    b = _boxes(0)
    _close(getattr(TB, name)(torch.from_numpy(b)), getattr(JB, name)(jnp.asarray(b)))


@pytest.mark.parametrize("src_coord,dst_coord", [(0, 1), (1, 0), (1, 1)])
@pytest.mark.parametrize("src_format,dst_format", [(0, 1), (1, 2), (2, 0), (2, 2)])
def test_convert_matches_jax(src_coord, dst_coord, src_format, dst_format):
    rng = np.random.default_rng(1)
    labels = np.concatenate([rng.integers(0, 5, (7, 1)), _boxes(1, 7)[0] * 300], -1)
    labels = labels.astype(np.float32)
    args = (src_coord, src_format, dst_coord, dst_format, (1, 2, 3, 4), (320, 240))
    got = TB.convert(torch.from_numpy(labels), *args)
    want = JB.convert(jnp.asarray(labels), *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=ATOL)


def test_absolute_relative_round_trip_matches_jax():
    b = _boxes(2) * 500
    rel_t = TB.absolute_to_relative(torch.from_numpy(b), (640, 480))
    _close(rel_t, JB.absolute_to_relative(jnp.asarray(b), (640, 480)))
    _close(TB.relative_to_absolute(rel_t, (640, 480)) / 500,
           JB.relative_to_absolute(jnp.asarray(rel_t.numpy()), (640, 480)) / 500)


@pytest.mark.parametrize("mode", ["x1y1x2y2", "cxcywh"])
def test_iou_pairwise_and_matrix_match_jax(mode):
    a, b = _boxes(3), _boxes(4)
    if mode == "x1y1x2y2":
        a, b = (np.concatenate([x[..., :2], x[..., :2] + x[..., 2:]], -1) for x in (a, b))
    a[0, 0] = 0          # a degenerate box: 0/0 = NaN on both sides
    _close(TB.iou_pairwise(torch.from_numpy(a), torch.from_numpy(b), mode),
           JB.iou_pairwise(jnp.asarray(a), jnp.asarray(b), mode))
    got = TB.iou_matrix(torch.from_numpy(a), torch.from_numpy(b), mode)
    want = np.asarray(JB.iou_matrix(jnp.asarray(a), jnp.asarray(b), mode))
    assert got.shape == want.shape == (3, 64, 64)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_wh_iou_matches_jax():
    wh1 = _boxes(5)[..., 2:] * 13
    wh2 = np.asarray([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45], [59, 119],
                      [116, 90], [156, 198], [373, 326]], np.float32) / 32
    _close(TB.wh_iou(torch.from_numpy(wh1), torch.from_numpy(wh2)),
           JB.wh_iou(jnp.asarray(wh1), jnp.asarray(wh2)))


@pytest.mark.parametrize("org", [(640, 480), (300, 500), (416, 416), (123, 77)])
def test_letterbox_labels_both_ways_match_jax(org):
    rng = np.random.default_rng(6)
    labels = np.concatenate([rng.integers(0, 80, (2, 9, 1)), _boxes(6, 9)[:2]], -1)
    labels = labels.astype(np.float32)
    fwd = TB.letterbox_labels(torch.from_numpy(labels), *org, 416, 416)
    _close(fwd, JB.letterbox_labels(jnp.asarray(labels), *org, 416, 416))
    back = TB.letterbox_labels_reverse(fwd, *org, 416, 416)
    _close(back, JB.letterbox_labels_reverse(jnp.asarray(fwd.numpy()), *org, 416, 416))
    np.testing.assert_allclose(back.numpy(), labels, atol=1e-5)
